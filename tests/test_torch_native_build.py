"""The port's locked library build (`rustsasa_tpu_torch/_host_build.py`).

Several processes that need one shared library at the same moment must
all load a complete file, and only one of them may compile it.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from conftest import REPO_ROOT

pytest.importorskip("torch")
from rustsasa_tpu_torch._host_build import build_shared_library

HELPER = REPO_ROOT / "rustsasa_tpu_torch" / "_host_build.py"
C_SOURCE = "int answer(void) { return 42; }\n"

# Loads the helper by file path (no package import, so the six processes
# start fast), waits for the start signal, builds and calls the library.
WORKER = """
import ctypes, importlib.util, os, subprocess, sys, time
helper, cc, src, out, counter, start = sys.argv[1:7]
spec = importlib.util.spec_from_file_location("_host_build", helper)
hb = importlib.util.module_from_spec(spec)
spec.loader.exec_module(hb)

def command(path):
    with open(counter, "a") as f:
        f.write("compile\\n")
    time.sleep(0.5)  # hold the lock long enough for every racer to queue
    proc = subprocess.run([cc, "-shared", "-fPIC", "-o", path, src])
    return proc.returncode == 0

deadline = time.monotonic() + 60
while not os.path.exists(start) and time.monotonic() < deadline:
    time.sleep(0.005)
path = hb.build_shared_library(src, out, command)
print(ctypes.CDLL(path).answer())
"""


def _cc():
    cc = shutil.which("cc") or shutil.which("gcc")
    assert cc, "no C compiler on PATH"
    return cc


def _compile(src, counter=None):
    def command(path):
        if counter is not None:
            counter.append(path)
        return subprocess.run(
            [_cc(), "-shared", "-fPIC", "-o", path, str(src)]
        ).returncode == 0
    return command


def test_six_processes_build_once_and_all_load(tmp_path):
    src = tmp_path / "answer.c"
    src.write_text(C_SOURCE)
    out = tmp_path / "libanswer.so"
    counter = tmp_path / "compiles.txt"
    start = tmp_path / "start"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(HELPER), _cc(), str(src),
             str(out), str(counter), str(start)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(6)
    ]
    time.sleep(0.5)
    start.touch()
    results = [p.communicate(timeout=120) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr
        assert stdout.strip() == "42"
    assert counter.read_text().splitlines() == ["compile"]
    assert not list(tmp_path.glob("libanswer.so.*.tmp"))


def test_stale_library_is_rebuilt(tmp_path):
    src = tmp_path / "answer.c"
    src.write_text(C_SOURCE)
    out = tmp_path / "libanswer.so"
    out.write_bytes(b"stale")
    old = time.time() - 100
    os.utime(out, (old, old))
    compiles = []
    path = build_shared_library(str(src), str(out), _compile(src, compiles))
    assert path == str(out) and len(compiles) == 1
    assert ctypes.CDLL(path).answer() == 42
    # Fresh now: a second call loads it without compiling.
    assert build_shared_library(str(src), str(out), _compile(src, compiles))
    assert len(compiles) == 1


def test_load_of_file_being_written_is_retried(tmp_path):
    """A fresh but incomplete file (another writer's in-place build) is
    retried until that writer finishes, not given up at once."""
    src = tmp_path / "answer.c"
    src.write_text(C_SOURCE)
    out = tmp_path / "libanswer.so"
    good = tmp_path / "good.so"
    assert _compile(src)(str(good))
    out.write_bytes(good.read_bytes()[:100])  # truncated, mtime fresh

    def finish_writing():
        time.sleep(1.0)
        shutil.copyfile(good, out)

    writer = threading.Thread(target=finish_writing)
    writer.start()
    try:
        compiles = []
        path = build_shared_library(
            str(src), str(out), _compile(src, compiles), retry_seconds=30
        )
    finally:
        writer.join(timeout=30)
    assert not writer.is_alive()
    assert path == str(out) and compiles == []
    assert ctypes.CDLL(path).answer() == 42


def test_failed_compile_reports_unavailable(tmp_path):
    src = tmp_path / "broken.c"
    src.write_text("this is not C\n")
    out = tmp_path / "libbroken.so"
    assert build_shared_library(
        str(src), str(out), _compile(src), retry_seconds=0
    ) is None
    assert not out.exists()
    assert not list(tmp_path.glob("libbroken.so.*.tmp"))


def test_port_alias_loader_uses_the_locked_build():
    """The port's own native loader builds its own fastparse.cpp under the
    lock into build/rustsasa_tpu_torch/, keyed by source and flags."""
    import rustsasa_tpu_torch.native as port_native

    path = port_native._locate_or_build()
    assert path == port_native._LIB
    assert os.path.dirname(path) == str(REPO_ROOT / "build"
                                        / "rustsasa_tpu_torch")
    assert os.path.basename(path) == port_native._lib_name()
    assert port_native._SRC == str(REPO_ROOT / "rustsasa_tpu_torch" / "native"
                                   / "fastparse.cpp")
    assert os.path.exists(path + ".lock")
    assert port_native.pipe_library() is not None


def test_port_radii_table_leaves_the_jax_package_alone():
    """The two packages load two libraries, so two radius tables: a custom
    table loaded into the port's changes the port's radii and leaves the
    JAX package's native-pipe radii for example.cif as they were."""
    import pytest

    import rustsasa_tpu.native as ref_native
    import rustsasa_tpu_torch.native as port_native

    example = str(REPO_ROOT / "tests" / "data" / "pdbs" / "example.cif")
    kwargs = dict(level="residue", include_hydrogens=False,
                  include_hetatms=False, read_radii_from_occupancy=False,
                  allow_vdw_fallback=False)

    def radii(native):
        ns = native.native_process_file(example, **kwargs)
        try:
            return ns.radii.copy()
        finally:
            ns.close()

    assert build_shared_library(ref_native._SRC, ref_native._LIB,
                                ref_native._build) is not None
    with pytest.MonkeyPatch.context() as mp:
        if ref_native._lib is None and ref_native._lib_failed:
            mp.setattr(ref_native, "_lib_failed", False)
        assert ref_native.pipe_library() is not None
        assert port_native.pipe_library() is not None
        assert ref_native.load_library()._name != port_native.load_library()._name
        ref_native.set_pipe_radii(None)
        port_native.set_pipe_radii(None)
        before = radii(ref_native)
        np.testing.assert_array_equal(radii(port_native), before)
        custom = {res: {atom: 3.25 for atom in ("N", "CA", "C", "O", "CB")}
                  for res in ("ALA", "GLY", "LEU", "SER", "VAL")}
        try:
            port_native.set_pipe_radii(custom)
            changed = radii(port_native)
            assert (changed != before).sum() > 100
            np.testing.assert_array_equal(radii(ref_native), before)
        finally:
            port_native.set_pipe_radii(None)
        np.testing.assert_array_equal(radii(port_native), before)
