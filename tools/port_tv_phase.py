#!/usr/bin/env python3
"""chip_smoke.py's fit_tv phase alone on the card, beside the WIRE-300
step-kernel fit (chip_smoke.py's ``fit`` phase at 300 epochs) whose ms per
epoch it is compared with: builds the libraries the phase launches, runs
both and prints the phase's JSON line.
The optional argument overrides chip_smoke.TV_LAMBDA; the floor check is
then off (WIRE_TPU_300_TV_DB holds at TV_LAMBDA alone).

    python3 tools/port_tv_phase.py [LAMBDA]      # ~4 min with the build
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from wire_tpu_torch import bench  # noqa: E402
from wire_tpu_torch.apps import common as TC, ct as TCT  # noqa: E402
from wire_tpu_torch.apps import denoise as TD  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.operators import forward as TF  # noqa: E402
from wire_tpu_torch.operators import radon as TR  # noqa: E402
from wire_tpu_torch.ops import build  # noqa: E402
from wire_tpu_torch.ops import wire_step as WS  # noqa: E402
from wire_tpu_torch.signals import image as TI  # noqa: E402
from wire_tpu_torch.train import metrics as M, presets as TP  # noqa: E402
from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise  # noqa


def main():
    if len(sys.argv) > 1:
        S.TV_LAMBDA = float(sys.argv[1])
        S.WIRE_TPU_300_TV_DB = float("-inf")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    build.build_all(("wire_step", "wire_mlp", "real_mlp", "rotsum",
                     "line_sample"))
    print("build_s", time.time() - t0, flush=True)
    im, im_noisy, grid, model = bench.setup(256, 256)
    params = model.init(torch.Generator().manual_seed(0), dev)
    cfg = FitConfig(learning_rate=5e-3, niters=300, maxpoints=256 * 256,
                    scale_lr_by_batch=True)
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3), cfg,
                        gt=im.reshape(-1, 3), device=dev)
    counters = S.Counts("wire_mlp", "rotsum", "line_sample", "real_mlp",
                        "mscale2_step", "mfn", "wire2d")
    t0 = time.time()
    out = S.fit_tv(torch, np, (TD, TC, TI, TF, TR, TCT, M, WS, get_inr,
                               TP.get_config, TP, FitConfig, fit_pointwise),
                   counters, dev, res.step_ms)
    out.update(wall_s=time.time() - t0, nvidia_smi=smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
