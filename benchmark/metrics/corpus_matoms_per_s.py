"""corpus_matoms_per_s: atoms of the corpus files processed a second, in millions."""

from benchmark.readers import file_matoms_per_s as read  # noqa: F401
