"""Hardware check: chip_smoke.py on an NVIDIA GPU (`make test-gpu`).

The regular suite pins JAX to 8 virtual CPU devices (conftest), so the
smoke test runs in a child process with the platform variables removed.
Whether there is a card is decided inside the fixture, where the test
skips if nvidia-smi finds none.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_env():
    smi = shutil.which("nvidia-smi")
    listed = ""
    if smi:
        listed = subprocess.run([smi, "-L"], capture_output=True,
                                text=True, timeout=60).stdout
    if "GPU" not in listed:
        pytest.skip("no NVIDIA GPU on this machine")
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


def test_chip_smoke_on_gpu(gpu_env):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=1500, env=gpu_env,
        cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
