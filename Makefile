.PHONY: test test-fast quality bench native clean ci precompile

# CI gate (the reference's rust.yml fmt/clippy/test analog): byte-compile
# lint, fast test tier, native build.  Run `make precompile` afterwards on
# a TPU host to populate the persistent compile cache (the PGO analog).
ci: native
	python -m py_compile $(shell find rustsasa_tpu benches scripts -name '*.py') bench.py __graft_entry__.py
	python -m pytest tests/ -q -m "not slow"

precompile:
	python scripts/precompile_fused.py

test:
	python -m pytest tests/ -q

test-fast:
	python -m pytest tests/ -q -m "not slow"

quality:
	python scripts/quality_report.py

bench:
	python bench.py

native:
	g++ -O3 -march=native -std=c++17 -shared -fPIC \
	    rustsasa_tpu/native/fastparse.cpp \
	    -o rustsasa_tpu/native/libfastparse.so -lz

clean:
	rm -rf rustsasa_tpu/native/libfastparse.so .jax_cache \
	    $(shell find . -name __pycache__ -type d)

# The PyTorch/CUDA port (rustsasa_tpu_torch).  `ci-torch` is the local
# analog of .github/workflows/ci_torch.yml: byte-compile lint and the
# CPU tests (the card-only ones, marker `gpu`, left out); the other
# three run on a card.
.PHONY: ci-torch precompile-torch bench-torch quality-torch

ci-torch:
	python -m py_compile $(shell find rustsasa_tpu_torch -name '*.py') chip_smoke.py
	python -m pytest tests/ -q -m "not slow and not gpu"

precompile-torch:
	python -m rustsasa_tpu_torch.scripts.precompile_fused

bench-torch:
	python -m rustsasa_tpu_torch.bench

quality-torch:
	python -m rustsasa_tpu_torch.scripts.quality_report
