#!/usr/bin/env python3
"""chip_smoke.py's volume_motion phase alone on one GPU, and how far its
probe's first batch lies from float64.

    python3 tools/port_volume_phase.py

Builds wire_step and wire_mlp, fits the occupancy app (its defaults,
chip_smoke.OCC_EPOCHS epochs) for the best parameters the phase probes,
runs chip_smoke.volume_motion and prints its JSON line; then, on the
probe's first batch of chip_smoke.VM_BATCH points, the largest distance /
max |float64| of the kernel's forward and of the fp32 plain apply
(fused="never") from the plain apply run in float64 (every parameter and
point cast), and of the kernel from the fp32 plain apply; last the card's
name and power limit.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402


def main():
    from wire_tpu_torch.apps import multi_sr as TMS, occupancy as TO
    from wire_tpu_torch.ops import build, wire_step as WS
    from wire_tpu_torch.signals import motion as TMo, volume as TV
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.time()
    build.build_all(("wire_step", "wire_mlp"))
    print(json.dumps({"build_s": time.time() - t0}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        app = TO.run(results_dir=tmp, niters=S.OCC_EPOCHS, device=dev)
        print(json.dumps({"occupancy_fit_s": time.time() - t0,
                          "iou": app["iou"], "psnr_db": app["psnr"]}),
              flush=True)
    t0 = time.time()
    out = S.volume_motion(torch, np, (TO, TMS, TV, TMo, WS),
                          S.Counts("wire_mlp"), app, dev)
    print(json.dumps({"phase": "volume_motion", "wall_s": time.time() - t0,
                      **out}, default=str), flush=True)
    params = app["result"].best_params
    model = TO.setup()[3]
    plain = TO.setup(fused="never")[3]
    coords = TV._grid3d_rows(0, S.VM_BATCH, S.VM_CUBE_RES, dev)
    p64 = {k: {kk: v.double() for kk, v in d.items()}
           for k, d in params.items()}
    with torch.no_grad():
        kernel = model.apply(params, coords).double()
        fp32 = plain.apply(params, coords).double()
        f64 = plain.apply(p64, coords.double())
    scale = float(f64.abs().max())
    print(json.dumps({"float64_view": {
        "kernel_vs_f64": float((kernel - f64).abs().max()) / scale,
        "fp32_plain_vs_f64": float((fp32 - f64).abs().max()) / scale,
        "kernel_vs_fp32": float((kernel - fp32).abs().max())
        / float(fp32.abs().max())}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
