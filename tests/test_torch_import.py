"""The PyTorch port imports without JAX and shares the reference's host code."""

import os
import re
import subprocess
import sys

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


def test_host_alias_runs_reference_sources_on_port_engine():
    import rustsasa_tpu_torch._host as host
    import rustsasa_tpu_torch._host.batch as host_batch
    import rustsasa_tpu_torch._host.native as host_native
    import rustsasa_tpu_torch.ops.engine as port_engine

    ref_dir = REPO_ROOT / "rustsasa_tpu"
    assert host.__path__ == [str(ref_dir)]
    assert host_native.__file__ == str(ref_dir / "native" / "__init__.py")
    assert host_batch.__file__ == str(ref_dir / "batch.py")
    assert host_batch.BatchedSasaEngine is port_engine.BatchedSasaEngine
    assert host_batch.CountsView is port_engine.CountsView
    assert sys.modules["rustsasa_tpu_torch._host.ops.engine"] is port_engine
