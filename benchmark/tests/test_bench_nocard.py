"""Without a card the command exits non-zero and prints no result."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result(tmp_path):
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"), "--workload",
                          "chained_diffuser.keystep", "--seed", "2147483659", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
