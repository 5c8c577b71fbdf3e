"""The PyTorch port imports without JAX and loads nothing of the JAX
package: no module, no source file and no shared library."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from conftest import REPO_ROOT

PORT_DIR = REPO_ROOT / "rustsasa_tpu_torch"


def test_batch_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import rustsasa_tpu_torch.batch\n"
        "import rustsasa_tpu_torch\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'rustsasa_tpu' or m.startswith('rustsasa_tpu.')\n"
        "       or m.startswith('jax')]\n"
        "assert sys.modules['jax'] is None and bad == ['jax'], bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _port_sources():
    files = [
        os.path.join(root, f)
        for root, _dirs, names in os.walk(PORT_DIR)
        for f in names if f.endswith(".py")
    ]
    return files + [str(REPO_ROOT / "chip_smoke.py")]


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    files = _port_sources()
    assert len(files) >= 7
    for path in files:
        with open(path, encoding="utf-8") as f:
            assert not pattern.search(f.read()), path


def test_port_sources_never_import_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+rustsasa_tpu\b(?!_torch)",
                         re.MULTILINE)
    files = _port_sources()
    assert len(files) >= 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            assert not pattern.search(f.read()), path


def test_package_surface_is_the_references():
    """The reference's names less its JAX compile cache, plus
    process_directory, and the same version."""
    import rustsasa_tpu
    import rustsasa_tpu_torch

    assert set(rustsasa_tpu_torch.__all__) == (
        set(rustsasa_tpu.__all__) - {"enable_persistent_cache"}
    ) | {"process_directory"}
    assert len(rustsasa_tpu_torch.__all__) == len(
        set(rustsasa_tpu_torch.__all__)) == 29
    for name in rustsasa_tpu_torch.__all__:
        assert getattr(rustsasa_tpu_torch, name) is not None, name
    assert rustsasa_tpu_torch.__version__ == rustsasa_tpu.__version__


# Imports the port's entry points, the scale-out modules, the build
# directory's choice (utils/build_cache.py) and every script and bench
# module (the reference's last tools, precompile_fused, r3_link_floor and
# r3_split, by name too), runs one small CPU directory batch through the native
# host route, the CLI on one file and the multi-device dry run, and lists
# what was loaded from the JAX package's directory: modules and mapped
# files.
ISOLATION = """
import os, pkgutil, sys, tempfile
sys.modules['jax'] = None
import rustsasa_tpu_torch, rustsasa_tpu_torch.api, rustsasa_tpu_torch.batch
import rustsasa_tpu_torch.ops.engine, rustsasa_tpu_torch.scripts as scripts
import rustsasa_tpu_torch.cli, rustsasa_tpu_torch.trajectory
import rustsasa_tpu_torch.bench, rustsasa_tpu_torch.benches as benches
import rustsasa_tpu_torch.parallel, rustsasa_tpu_torch.parallel.mesh
import rustsasa_tpu_torch.parallel.distributed
import rustsasa_tpu_torch.parallel.worker, rustsasa_tpu_torch.graft_entry
import rustsasa_tpu_torch.utils.build_cache
import rustsasa_tpu_torch.scripts.precompile_fused
import rustsasa_tpu_torch.scripts.r3_link_floor
import rustsasa_tpu_torch.scripts.r3_split
import importlib
for info in pkgutil.iter_modules(scripts.__path__):
    importlib.import_module('rustsasa_tpu_torch.scripts.' + info.name)
for info in pkgutil.iter_modules(benches.__path__):
    importlib.import_module('rustsasa_tpu_torch.benches.' + info.name)
from rustsasa_tpu_torch import (BatchedSasaEngine, Level, SASAOptions,
                                SasaParams, process_directory)
from rustsasa_tpu_torch.native import pipe_library
assert pipe_library() is not None, 'no native library'
src, out = sys.argv[1], tempfile.mkdtemp()
rep = process_directory(src, out, SASAOptions(level=Level.RESIDUE), 'json',
                        progress=False, workers=1,
                        engine=BatchedSasaEngine(SasaParams(), device='cpu'))
assert rep.n_ok == rep.n_files == 1 and not rep.errors, rep.errors
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):
    assert rustsasa_tpu_torch.cli.main(
        [os.path.join(src, '2drt.pdb.gz'), os.path.join(out, 'cli.json'),
         '--device', 'cpu']) == 0
    rustsasa_tpu_torch.graft_entry.dryrun_multichip(['cpu', 'cpu'])
ref = os.path.join(sys.argv[2], 'rustsasa_tpu') + os.sep
mods = sorted(name for name, m in list(sys.modules.items())
              if (getattr(m, '__file__', None) or '').startswith(ref))
with open('/proc/self/maps') as f:
    maps = sorted({line.split()[-1] for line in f if ref in line})
print('modules', mods)
print('maps', maps)
print('scripts', len(list(pkgutil.iter_modules(scripts.__path__))))
print('benches', sorted(i.name for i in pkgutil.iter_modules(benches.__path__)))
"""


def test_port_loads_nothing_from_the_jax_package(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    (src / "2drt.pdb.gz").write_bytes(
        (REPO_ROOT / "tests" / "data" / "freesasa_pdbs" / "2drt.pdb.gz")
        .read_bytes())
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", ISOLATION, str(src), str(REPO_ROOT)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "modules []", lines[0]
    assert lines[1] == "maps []", lines[1]
    assert int(lines[2].split()[1]) >= 25
    assert lines[3] == ("benches ['md_trajectory', 'micro_bench', "
                        "'single_protein', 'single_worker_proteome']"), lines[3]


@pytest.mark.parametrize("pattern", ["_host.", 'find_spec("rustsasa_tpu")'])
def test_port_sources_name_no_alias(pattern):
    files = [
        os.path.join(root, f)
        for root, _dirs, names in os.walk(PORT_DIR)
        for f in names if f.endswith((".py", ".cu", ".cuh", ".cpp"))
    ]
    for path in files + [str(REPO_ROOT / "chip_smoke.py")]:
        with open(path, encoding="utf-8") as f:
            assert pattern not in f.read(), path


# The port's copies of the reference's JAX-free host modules that it
# keeps unchanged; api.py, batch.py and native/__init__.py differ in their
# docstrings and the native loader, and are held to the reference by the
# parity tests (tests/test_torch_batch.py, tests/test_torch_native_build.py).
UNCHANGED_COPIES = [
    "constants.py", "radii.py", "levels.py", "data/__init__.py",
    "data/protor.py", "io/__init__.py", "io/structure.py", "io/pdb.py",
    "io/cif.py", "io/hybrid36.py", "io/read.py", "io/serialize.py",
    "io/writeback.py", "native/fastparse.cpp", "ops/sphere.py",
    "utils/__init__.py", "utils/stagestats.py", "trajectory/dcd.py",
]


@pytest.mark.parametrize("rel", UNCHANGED_COPIES)
def test_host_copy_equals_reference(rel):
    port = (PORT_DIR / rel).read_bytes()
    assert port == (REPO_ROOT / "rustsasa_tpu" / rel).read_bytes(), rel
