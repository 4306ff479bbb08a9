#!/usr/bin/env python3
"""How far mscale2_step's fp32 plain version lies from its float64 run at
the smoke's batched mscale2_step case, and how far from the float64 run
that takes the combiner relu pattern of an fp32 evaluation (the reference
of chip_smoke.py:many_rest_vs_plain's mscale2_step cases, fault C.11).

    python3 tools/port_mscale_many_reference.py [--device cuda] [--seeds ...]

At chip_smoke.py's many_rest_vs_plain full case (the Mscale2 denoise
model's fold at each seed, n = 65,536, ns = 3, inputs from numpy seed 41)
it runs the plain step in float32 and in float64, then the float64 step
on the fp32 run's own combiner relu mask (u32 > 0), and the mask that
chip_smoke.py:combiner_relu_pattern derives from the fp32 trunk outputs.
Prints one JSON line per fold seed: the largest distance over the
outputs (max |a - b| / max |float64| per tensor) of the fp32 run from the
float64 run and from the masked float64 run, with the tensor where each
is largest, the relu units whose sign differs between the fp32 and the
float64 run, and those where combiner_relu_pattern's mask differs from
the fp32 run's.  The default device is the CPU.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import port_mscale_reference as PR  # noqa: E402
import wire_tpu_torch.nn.models as MM  # noqa: E402
from wire_tpu_torch.apps import common as TC  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.ops import real_mlp as RM  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[41, 42, 43])
    a = ap.parse_args()
    dev = torch.device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = S.mscale2_models(get_inr, TC, get_config(S.MSCALE2_CONFIG))[0]
    n = S.MANY_REST_SHAPES["rows"]
    rng = np.random.default_rng(41)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)
    c, tg, gt = (t(rng.uniform(lo, 1, (n, k)))
                 for lo, k in ((-1, 2), (0, 3), (0, 3)))
    f64 = S.float64_tree
    for seed in a.seeds:
        canon, comb, kinds, inv = S.mscale2_fold(torch, MM, model, seed, dev)
        r32, r64, rm = [], [], []
        w32 = PR.plain_step(canon, comb, c, tg, gt, kinds, inv, r32)
        mask = r32[0] > 0
        w64 = PR.plain_step(f64(canon), f64(comb), f64(c), f64(tg), f64(gt),
                            kinds, f64(inv), r64)
        wm = PR.plain_step(f64(canon), f64(comb), f64(c), f64(tg), f64(gt),
                           kinds, f64(inv), rm, mask=mask)
        ys = RM.real_mlp_plain(canon, c.repeat(len(inv), 1), kinds,
                               (tuple(float(g) for g in inv), n))
        pattern = S.combiner_relu_pattern(torch, ys, comb, n)
        print(json.dumps({
            "seed": seed, "device": str(dev),
            "fp32_vs_float64": PR.worst(w32, w64),
            "fp32_vs_masked_float64": PR.worst(w32, wm),
            "relu_flips": int((mask != (r64[0] > 0)).sum()),
            "pattern_vs_fp32_mask": int((pattern != mask).sum())}),
            flush=True)


if __name__ == "__main__":
    main()
