"""The port's CI workflow (`.github/workflows/ci_torch.yml`), its Makefile
targets, its wheel's package data and where it builds at first use.

No workflow runs here; these tests hold what the workflow names to what
the repository holds.  The build-directory tests need no compiler: they
look at where the kernels and the native library would be built when
the package's own directory cannot be written, as in a wheel installed
into a read-only site-packages.
"""

import glob
import os
import re
import shlex
import shutil
import subprocess
import sys
import tomllib

import pytest
pytest.importorskip("torch")
import yaml

from conftest import REPO_ROOT
from rustsasa_tpu_torch.ops import _kernels
from rustsasa_tpu_torch.utils import build_cache

WORKFLOW = REPO_ROOT / ".github" / "workflows" / "ci_torch.yml"
PYPROJECT = tomllib.loads((REPO_ROOT / "pyproject.toml").read_text())


@pytest.fixture(scope="module")
def workflow():
    return yaml.safe_load(WORKFLOW.read_text())


def _runs(job):
    return [step["run"] for step in job["steps"] if "run" in step]


def test_workflow_parses_with_its_three_jobs(workflow):
    # YAML 1.1 reads the key `on` as True.
    triggers = workflow.get("on", workflow.get(True))
    assert set(triggers) == {"push", "pull_request"}
    assert set(workflow["jobs"]) == {"lint", "test", "package"}
    for job in workflow["jobs"].values():
        assert job["runs-on"] == "ubuntu-latest"
        assert job["steps"][0]["uses"] == "actions/checkout@v4"


def test_every_linted_path_exists(workflow):
    (lint,) = [r for r in _runs(workflow["jobs"]["lint"])
               if r.startswith("ruff check")]
    paths = shlex.split(lint)[2:]
    assert paths[:2] == ["rustsasa_tpu_torch", "chip_smoke.py"]
    for path in paths:
        matches = glob.glob(str(REPO_ROOT / path))
        assert matches, path
    assert len(glob.glob(str(REPO_ROOT / "tests" / "test_torch_*.py"))) >= 30


def test_test_job_installs_cpu_torch_and_leaves_out_the_card(workflow):
    runs = _runs(workflow["jobs"]["test"])
    assert any("torch" in r and "download.pytorch.org/whl/cpu" in r
               for r in runs)
    installs = " ".join(r for r in runs if r.startswith("pip install"))
    for package in ("jax", "numpy", "pytest", "pytest-xdist", "pyyaml"):
        assert re.search(rf"(^|\s){package}(\s|$)", installs), package
    assert 'python -m pytest tests/ -q -m "not slow and not gpu"' in runs
    markers = (REPO_ROOT / "pytest.ini").read_text()
    assert "slow:" in markers and "gpu:" in markers


def test_package_job_runs_the_console_script(workflow):
    script = "\n".join(_runs(workflow["jobs"]["package"]))
    assert "rustsasa-tpu-torch" in PYPROJECT["project"]["scripts"]
    assert PYPROJECT["project"]["scripts"]["rustsasa-tpu-torch"] == (
        "rustsasa_tpu_torch.cli:main")
    command = " ".join(script.replace("\\\n", " ").split())
    assert ('/tmp/venv/bin/rustsasa-tpu-torch '
            '"$GITHUB_WORKSPACE/tests/data/pdbs/example.cif" /tmp/out.json '
            '--output-depth residue --device cpu') in command
    assert (REPO_ROOT / "tests" / "data" / "pdbs" / "example.cif").exists()
    assert "d['Residue']" in script
    assert "download.pytorch.org/whl/cpu" in script
    assert "~/.cache/rustsasa_tpu_torch/libfastparse_" in script


def test_wheel_package_data_covers_every_source():
    data = PYPROJECT["tool"]["setuptools"]["package-data"]
    shipped = set()
    for package, patterns in data.items():
        if not package.startswith("rustsasa_tpu_torch"):
            continue
        root = REPO_ROOT.joinpath(*package.split("."))
        for pattern in patterns:
            shipped |= {os.path.relpath(p, REPO_ROOT)
                        for p in glob.glob(str(root / pattern))}
    csrc = REPO_ROOT / "rustsasa_tpu_torch" / "ops" / "csrc"
    want = {os.path.relpath(p, REPO_ROOT) for p in
            [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]}
    want.add(os.path.join("rustsasa_tpu_torch", "native", "fastparse.cpp"))
    assert len(want) >= 16 and shipped == want
    assert {f"{s}.cu" for s in _kernels.SOURCES} <= {
        os.path.basename(p) for p in shipped}
    assert "rustsasa_tpu*" in PYPROJECT["tool"]["setuptools"]["packages"][
        "find"]["include"]


@pytest.mark.parametrize("target, command", [
    ("ci-torch", 'python -m pytest tests/ -q -m "not slow and not gpu"'),
    ("precompile-torch",
     "python -m rustsasa_tpu_torch.scripts.precompile_fused"),
    ("bench-torch", "python -m rustsasa_tpu_torch.bench"),
    ("quality-torch", "python -m rustsasa_tpu_torch.scripts.quality_report"),
])
def test_makefile_targets_name_the_port(target, command):
    text = (REPO_ROOT / "Makefile").read_text()
    body = re.search(rf"^{target}:\n((?:\t.*\n)+)", text, re.MULTILINE)
    assert body and command in body.group(1), target
    module = command.split(" -m ")[-1].split()[0]
    if module.startswith("rustsasa_tpu_torch"):
        path = REPO_ROOT.joinpath(*module.split("."))
        assert path.with_suffix(".py").exists() or path.is_dir()


# --- the build directory -------------------------------------------------

def test_checkout_builds_beside_the_package():
    assert build_cache.PACKAGE_DIR == str(REPO_ROOT / "build"
                                          / "rustsasa_tpu_torch")
    assert build_cache.writable(build_cache.PACKAGE_DIR)
    assert _kernels.BUILD_DIR == build_cache.build_dir() == (
        build_cache.PACKAGE_DIR)
    assert build_cache.USER_DIR == os.path.join(
        os.path.expanduser("~"), ".cache", "rustsasa_tpu_torch")


def _unwritable(tmp_path, kind, monkeypatch):
    """A package build directory that cannot be written: under a file (no
    user, root included, can create it), itself a file, or a directory
    the access check refuses (a read-only mount)."""
    site = tmp_path / "site-packages"
    target = site / "build" / "rustsasa_tpu_torch"
    if kind == "parent is a file":
        site.write_text("")
    elif kind == "a file":
        target.parent.mkdir(parents=True)
        target.write_text("")
    else:
        target.mkdir(parents=True)
        real = os.access
        monkeypatch.setattr(
            os, "access", lambda p, mode: False if os.path.abspath(p) == str(
                target) else real(p, mode))
    return str(target)


@pytest.mark.parametrize("kind", ["parent is a file", "a file", "read-only"])
def test_build_dir_falls_back_to_the_user_cache(tmp_path, kind, monkeypatch):
    target = _unwritable(tmp_path, kind, monkeypatch)
    monkeypatch.setattr(build_cache, "PACKAGE_DIR", target)
    assert not build_cache.writable(target)
    assert build_cache.build_dir() == build_cache.USER_DIR
    # Choosing creates nothing.
    assert not os.path.isdir(target) or kind == "read-only"


def test_build_dir_takes_a_package_dir_it_can_create(tmp_path, monkeypatch):
    target = tmp_path / "site-packages" / "build" / "rustsasa_tpu_torch"
    monkeypatch.setattr(build_cache, "PACKAGE_DIR", str(target))
    assert build_cache.build_dir() == str(target)
    assert not (tmp_path / "site-packages").exists()


# Imported from a copy of the package whose build directory cannot be
# created (its parent, site/build, is a file): prints where the kernels
# and the native library would be built.
IMPORT_ELSEWHERE = """
from rustsasa_tpu_torch.ops import _kernels
import rustsasa_tpu_torch.native as native
print(_kernels.BUILD_DIR)
print(native._LIB)
"""


def installed_copy(tmp_path):
    """A copy of the package in tmp/site, as an install puts it, where
    site/build is a file: the package's build directory cannot be made.
    Returns (site, home), home an empty directory to stand for HOME."""
    site = tmp_path / "site"
    shutil.copytree(REPO_ROOT / "rustsasa_tpu_torch",
                    site / "rustsasa_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (site / "build").write_text("")
    home = tmp_path / "home"
    home.mkdir()
    return site, home


def test_both_loaders_build_in_the_user_cache_from_a_read_only_install(
        tmp_path):
    """Imported from an install whose build directory cannot be written,
    the kernels' BUILD_DIR and the native library both go to
    ~/.cache/rustsasa_tpu_torch, keyed as before; importing builds
    nothing."""
    site, home = installed_copy(tmp_path)
    env = dict(os.environ, HOME=str(home), PYTHONPATH=str(site))
    proc = subprocess.run([sys.executable, "-c", IMPORT_ELSEWHERE],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    build_dir, lib = proc.stdout.split()
    want = str(home / ".cache" / "rustsasa_tpu_torch")
    assert build_dir == want
    import rustsasa_tpu_torch.native as native
    assert lib == os.path.join(want, native._lib_name())
    assert not (home / ".cache").exists()
