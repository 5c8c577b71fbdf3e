"""Where the port keeps what it builds at first use.

The port's counterpart of the reference's persistent XLA compile cache
(`utils/jax_cache.py` there): the CUDA kernels (`ops/_kernels.py`) and
the native host library (`native/`) are built on first use into one
directory, each file keyed by a hash of its sources and flags, so a
later process finds them built.

That directory is `build/rustsasa_tpu_torch/` beside the package (in a
checkout, at the repository's root) where it can be created and
written, and `~/.cache/rustsasa_tpu_torch/` otherwise: a wheel installed
into a read-only site-packages builds into the user's cache.  Choosing
creates nothing.
"""

from __future__ import annotations

import os

PACKAGE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "rustsasa_tpu_torch",
)
USER_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                        "rustsasa_tpu_torch")


def writable(path: str) -> bool:
    """Whether `path` is a directory this process may write into, or one
    it could create: its nearest existing ancestor is a writable
    directory."""
    path = os.path.abspath(path)
    while not os.path.lexists(path):
        parent = os.path.dirname(path)
        if parent == path:
            return False
        path = parent
    return os.path.isdir(path) and os.access(path, os.W_OK | os.X_OK)


def build_dir() -> str:
    """PACKAGE_DIR where it can be created and written, else USER_DIR."""
    return PACKAGE_DIR if writable(PACKAGE_DIR) else USER_DIR
