"""chip_smoke.py: refuses to run without a GPU, and its result line."""

import json
import os
import shutil
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_smoke_exits_nonzero_without_gpu():
    proc = _run(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_smoke_exits_nonzero_without_the_repo(tmp_path):
    """Alone in a directory, the script has nothing to run and fails."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_smoke_result_line_format():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    line = chip_smoke.result_line([dev, dev, dev, dev])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 4}}
