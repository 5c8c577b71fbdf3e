"""The JAX package's CI test job collects the port's test modules without
torch (`.github/workflows/ci.yml` installs jax, flax, numpy and pytest
only): each `test_torch_*` module skips at import, none is an error."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from conftest import REPO_ROOT


def test_port_tests_skip_without_torch(tmp_path):
    # `import torch` raises ImportError where sys.modules holds None.
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch'] = None\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-rs",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist",
         "tests/"],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=120)
    out = proc.stdout
    # pytest exits 5 when it collects nothing, so the run takes the whole
    # directory, as the CI job does: the reference's tests are collected.
    assert proc.returncode == 0, out[-4000:]
    items = [line for line in out.splitlines() if "::" in line]
    assert items and not [i for i in items if "test_torch_" in i]
    skipped = sorted(
        line.split()[2].split(":")[0].removeprefix("tests/")
        for line in out.splitlines()
        if line.startswith("SKIPPED") and "could not import 'torch'" in line)
    assert skipped == sorted(p.name for p in (REPO_ROOT / "tests").glob(
        "test_torch_*.py"))
