"""The port's copies of the NumPy cull-sizing studies against the scripts
`scripts/r4_cull_granularity.py` and `scripts/r5_spherecull.py` (CPU).

Each copy is the script byte for byte apart from its imports (pointed at
the port), its CORPUS line (a parameter: `run(corpus_dir)` sets it) and
the command-line entry, which calls `run`.  On three FreeSASA structures
both print the same lines.
"""

import contextlib
import importlib.util
import io
import re
import shutil

import pytest

import rustsasa_tpu.native as ref_native
pytest.importorskip("torch")
import rustsasa_tpu_torch.native as port_native
from conftest import REFERENCE_DATA, REPO_ROOT
from rustsasa_tpu_torch._host_build import build_shared_library
from rustsasa_tpu_torch.scripts import r4_cull_granularity, r5_spherecull

STUDIES = {"r4_cull_granularity": r4_cull_granularity,
           "r5_spherecull": r5_spherecull}
IMPORT = re.compile(r"^(import |from |sys\.path\.insert)")
MAIN = 'if __name__ == "__main__":'


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", REPO_ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _other_lines(text, *, port):
    """The lines that are no import (multi-line ones included), no CORPUS
    line and not the command-line entry; for the port also none of the
    run() section after main()."""
    if port:
        text = text[:text.index("\n\n# The port's entry:")]
    else:
        text = text[:text.index(MAIN)]
    out, in_import = [], False
    for line in text.rstrip("\n").splitlines():
        if in_import:
            in_import = not line.startswith(")")
            continue
        if IMPORT.match(line):
            in_import = line.rstrip().endswith("(") or line.endswith(
                "(  # noqa: E402")
            continue
        if line.startswith("CORPUS = "):
            continue
        out.append(line)
    return out


@pytest.mark.parametrize("name", list(STUDIES))
def test_copy_pinned_to_script(name):
    want = (REPO_ROOT / "scripts" / f"{name}.py").read_text()
    got = (REPO_ROOT / "rustsasa_tpu_torch" / "scripts" / f"{name}.py"
           ).read_text()
    assert _other_lines(got, port=True) == _other_lines(want, port=False)
    assert len(_other_lines(want, port=False)) > 80
    assert "sys.path" not in got and "rustsasa_tpu." not in got


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    for name in ("2drt.pdb.gz", "2gpi.pdb.gz", "3uc7.pdb.gz"):
        shutil.copy(REFERENCE_DATA / "freesasa_pdbs" / name, d / name)
    return str(d)


@pytest.fixture(scope="module")
def reference_native():
    """The reference's native library, built under the port's lock (its
    own loader builds in place; see tests/test_torch_batch.py), and both
    packages' native radius tables at ProtOr: the tables are
    process-global, and an earlier test in this worker may have loaded a
    custom one."""
    path = build_shared_library(
        ref_native._SRC, ref_native._LIB, ref_native._build)
    assert path is not None, "the native library does not build here"
    with pytest.MonkeyPatch.context() as mp:
        if ref_native._lib is None and ref_native._lib_failed:
            mp.setattr(ref_native, "_lib_failed", False)
        ref_native.set_pipe_radii(None)
        port_native.set_pipe_radii(None)
        yield


@pytest.mark.parametrize("name", list(STUDIES))
def test_prints_the_scripts_lines(name, corpus, reference_native,
                                  monkeypatch):
    script = _script(name)
    monkeypatch.setattr(script, "CORPUS", corpus)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        script.main()
    want = out.getvalue().splitlines()
    got = STUDIES[name].run(corpus)
    assert got["lines"] == want
    assert got["structures"] == 3 and got["atoms"] > 600
    assert len(got["streamed"]) == len(want) - 1
    assert all(v > 0 for v in got["streamed"].values())
