"""The PyTorch port imports without JAX and loads nothing of the JAX
package: no module, no source file and no shared library."""

import os
import re
import subprocess
import sys

import pytest

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


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    files = [
        os.path.join(root, f)
        for root, _dirs, names in os.walk(PORT_DIR)
        for f in names if f.endswith(".py")
    ]
    assert len(files) >= 7
    for path in files + [str(REPO_ROOT / "chip_smoke.py")]:
        with open(path, encoding="utf-8") as f:
            assert not pattern.search(f.read()), path


# Imports the port's entry points and every script module, runs one small
# CPU directory batch through the native host route, and lists what was
# loaded from the JAX package's directory: modules and mapped files.
ISOLATION = """
import os, pkgutil, sys, tempfile
sys.modules['jax'] = None
import rustsasa_tpu_torch, rustsasa_tpu_torch.api, rustsasa_tpu_torch.batch
import rustsasa_tpu_torch.ops.engine, rustsasa_tpu_torch.scripts as scripts
import importlib
for info in pkgutil.iter_modules(scripts.__path__):
    importlib.import_module('rustsasa_tpu_torch.scripts.' + info.name)
from rustsasa_tpu_torch import (BatchedSasaEngine, Level, SASAOptions,
                                SasaParams, process_directory)
from rustsasa_tpu_torch.native import pipe_library
assert pipe_library() is not None, 'no native library'
src, out = sys.argv[1], tempfile.mkdtemp()
rep = process_directory(src, out, SASAOptions(level=Level.RESIDUE), 'json',
                        progress=False, workers=1,
                        engine=BatchedSasaEngine(SasaParams(), device='cpu'))
assert rep.n_ok == rep.n_files == 1 and not rep.errors, rep.errors
ref = os.path.join(sys.argv[2], 'rustsasa_tpu') + os.sep
mods = sorted(name for name, m in list(sys.modules.items())
              if (getattr(m, '__file__', None) or '').startswith(ref))
with open('/proc/self/maps') as f:
    maps = sorted({line.split()[-1] for line in f if ref in line})
print('modules', mods)
print('maps', maps)
print('scripts', len(list(pkgutil.iter_modules(scripts.__path__))))
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
    assert int(lines[2].split()[1]) >= 7


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
    "utils/__init__.py", "utils/stagestats.py",
]


@pytest.mark.parametrize("rel", UNCHANGED_COPIES)
def test_host_copy_equals_reference(rel):
    port = (PORT_DIR / rel).read_bytes()
    assert port == (REPO_ROOT / "rustsasa_tpu" / rel).read_bytes(), rel
