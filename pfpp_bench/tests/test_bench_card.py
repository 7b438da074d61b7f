"""A traced run of the serving cell on the card, through the benchmark's command."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from pfpp_bench import manifest


@pytest.mark.cuda
def test_traced_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "pfpp_bench.run", "--workload", "engine_b8",
                          "--seed", "7", "--seconds", "2", "--trace", "1"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert list(line)[-1] == "checks"
