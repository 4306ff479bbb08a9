"""One run of the benchmark on the card, end to end (``-m gpu``; skips
without a CUDA device): the result line's form and a correct output."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import lookup

pytestmark = pytest.mark.gpu


def test_a_short_run_of_the_main_cell_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "wire300.denoise",
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "0"],
        cwd=lookup.CHECKOUT, capture_output=True, text=True, timeout=1200,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"fit_coords_per_s", "epoch_ms_p95",
                                      "setup_s"}
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check best_gap")
