"""The multi-rank launcher at world 2 on gloo."""
from __future__ import annotations

import subprocess
import sys

from _tiny import ROOT


def test_launcher_world_two_on_gloo():
    out = subprocess.run([sys.executable, "-m", "hmm_bench.launcher", "--probe", "2"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "world 2 sum 3"
