"""Race-free build of a shared library that several processes load at once.

The native host library (`native/fastparse.cpp`) is not committed built:
every fresh checkout builds it on first use, and several processes (test
workers, batch runs) may need it at the same moment.  A loader that
compiled straight into the final path would let a process load the file
while another is still writing it, fail `ctypes.CDLL` and give the
library up for good.  `build_shared_library` closes that window: one
process at a time builds under an exclusive `flock`, into a temporary
file that `os.replace` moves into place, and a load that fails on a file
some other writer may still be producing is retried.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import time
from typing import Callable

# How long a load that fails on an existing file is retried: a writer
# that does not take the lock (a copy made by hand, an in-place build)
# may be between writing the file and finishing it.
LOAD_RETRY_SECONDS = 120.0
_RETRY_PAUSE = 0.25


def _fresh(output: str, source: str) -> bool:
    return (
        os.path.exists(output)
        and os.path.getmtime(output) >= os.path.getmtime(source)
    )


def build_shared_library(
    source: str,
    output: str,
    command: Callable[[str], bool],
    *,
    retry_seconds: float = LOAD_RETRY_SECONDS,
) -> str | None:
    """Make `output` a complete build of `source`; return its path or None.

    `command(path)` compiles `source` into `path` and returns whether it
    succeeded.  Under an exclusive lock on `output + ".lock"`: if
    `output` is missing or older than `source`, `command` builds a
    temporary file beside it, which then replaces `output` atomically.
    The result is loaded with `ctypes.CDLL` before the lock is released;
    a load that fails is retried, rebuilding when the file is stale, for
    `retry_seconds`.  None means no loadable library could be made.
    Raises OSError when the lock file cannot be created (a read-only
    install).
    """
    deadline = time.monotonic() + retry_seconds
    with open(output + ".lock", "a+b") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                if not _fresh(output, source):
                    tmp = f"{output}.{os.getpid()}.tmp"
                    try:
                        if not command(tmp):
                            return None
                        os.replace(tmp, output)
                    finally:
                        if os.path.exists(tmp):
                            os.remove(tmp)
                try:
                    ctypes.CDLL(output)
                    return output
                except OSError:
                    if time.monotonic() > deadline:
                        return None
                    time.sleep(_RETRY_PAUSE)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
