"""Host code shared with `rustsasa_tpu`, loaded without its JAX.

The port reuses the reference package's host modules (the native C++
parser/selection/packers/emit, `io`, `levels`, `radii`, `constants`,
`ops.sphere`, `utils.stagestats`, and the `api` and `batch` front ends)
as source, not as copies.  None of those modules imports JAX, but
`import rustsasa_tpu.<anything>` first runs `rustsasa_tpu/__init__.py`,
which imports `ops.engine` and with it `jax`.  The machine with the GPU
has no JAX, so the port cannot import the reference package by name.

Mechanism: this module turns itself into a package (it sets `__path__`)
whose search path is the `rustsasa_tpu/` directory.  `rustsasa_tpu`'s
`__init__` therefore never runs, and `rustsasa_tpu_torch._host.native`,
`._host.io.read`, `._host.levels`, ... are the reference's own files,
loaded under this package's name; their relative imports resolve inside
it.  Before anything can import `_host.api` or `_host.batch`, the port's
`ops/engine.py` is registered as `_host.ops.engine`: those two files then
run unchanged on the torch engine, through exactly the names they import
from it (`calculate_sasa_internal`, `BatchedSasaEngine`, `CountsView`,
`SasaParams`, `CHUNK_SLOT_BUDGET`).

Nothing here imports `_host.ops.fused_kernel`, `_host.ops.pallas_kernel`
or `_host.utils.jax_cache`, the reference modules that do need JAX.  A
lazy `rustsasa_tpu/__init__` would make this alias unnecessary.

The native library's state (its radius table) is process-global: a
process that also imports `rustsasa_tpu` shares one loaded library with
this alias.

The alias's loader builds that library through `_host_build`: under a
lock, into a temporary file that replaces the old one atomically, with
retried loads.  The reference's own loader compiles in place, and a
process that loads the half-written file gives the library up for good.
"""

from __future__ import annotations

import importlib.util
import sys


def _reference_dir() -> str:
    # find_spec on a top-level name locates the package without
    # executing its __init__.
    spec = importlib.util.find_spec("rustsasa_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise ImportError("rustsasa_tpu (the host-code source) not found")
    return list(spec.submodule_search_locations)[0]


__path__ = [_reference_dir()]

from .ops import engine as _engine  # noqa: E402
from ._host import ops as _ops  # noqa: E402
from ._host import native as _native  # noqa: E402
from ._host_build import build_shared_library  # noqa: E402

sys.modules[__name__ + ".ops.engine"] = _engine
_ops.engine = _engine

_reference_locate_or_build = _native._locate_or_build


def _locate_or_build() -> str | None:
    """The alias's library path: built and loaded under the build lock;
    the reference's own search only where no lock file can be made."""
    try:
        return build_shared_library(_native._SRC, _native._LIB, _native._build)
    except OSError:
        return _reference_locate_or_build()


_native._locate_or_build = _locate_or_build
