#!/usr/bin/env python3
"""How far mscale2_step's fp32 plain version lies from its own float64 run,
and why, on one GPU.

    python3 tools/port_mscale_reference.py

At chip_smoke.py's full mscale2_step case (the Mscale2 denoise model's
seed-18 fold, n = 65,536, ns = 3, seed-19 inputs) it runs the plain step
(ops/mscale2_step.py:mscale2_step_plain) in float32 and in float64 on the
same inputs, and the kernel, and records the combiner's pre-activation u
(65,536 x 128, the input of its relu) of each plain run.  It prints one
JSON line:

  outputs   for each output whose fp32 plain run or kernel lies more than
            1e-5 x max from the float64 run: those two distances, the
            kernel's from the fp32 plain run, and the distance from the fp32
            plain run of the float64 step whose relu takes the fp32 run's
            mask (u32 > 0) in place of its own (each over max |float64|);
  relu      the units whose sign of u differs from the float64 run's: for
            the fp32 plain run, and for a model of 3xTF32 tensor-core
            products in the trunk's hidden layers (ops/wire_mlp.py:
            matmul_3xtf32_plain on every product with K and N of 64 or
            more, the rest fp32), with the largest |u64| among them and
            max |u64|;
  and the card's name and power limit.

If the masked float64 step lies as close to the fp32 plain run as fp32
rounding allows where the plain float64 step does not, the distance is
the relu's: units within rounding of 0 taken on the other side of the kink.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

import chip_smoke as S  # noqa: E402
import wire_tpu_torch.nn.models as MM  # noqa: E402
from wire_tpu_torch import tree  # noqa: E402
from wire_tpu_torch.apps import common as TC  # noqa: E402
from wire_tpu_torch.nn import activations as act  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.ops import mscale2_step as MS  # noqa: E402
from wire_tpu_torch.ops import real_mlp as RM  # noqa: E402
from wire_tpu_torch.ops import wire_mlp as WM  # noqa: E402
from wire_tpu_torch.train.presets import get_config  # noqa: E402


class ThreeTF32(TorchFunctionMode):
    """a @ b as matmul_3xtf32_plain forms it, for float32 (m, K) @ (K, N)
    with K and N of 64 or more (the trunk's hidden layers); other products
    as they are."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) == "matmul" and not kwargs:
            a, b = args
            if (a.dtype == torch.float32 and a.dim() == 2 and b.dim() == 2
                    and a.shape[1] >= 64 and b.shape[1] >= 64):
                return WM.matmul_3xtf32_plain(a, b)
        return func(*args, **kwargs)


def with_relu(record, mask=None):
    """act.relu that records its input and, with ``mask``, gates by it in
    place of its own sign."""
    def relu(z):
        record.append(z.detach())
        return torch.relu(z) if mask is None else z * mask.to(z.dtype)
    return relu


def plain_step(canon, comb, c, t, gt, kinds, inv, record, mask=None):
    relu = act.relu
    act.relu = with_relu(record, mask)
    try:
        return S.mscale2_tensors(*MS.mscale2_step_plain(
            canon, comb, c, t, kinds, inv, gt=gt, want_metrics=True))
    finally:
        act.relu = relu


def combiner_input(canon, comb, c, kinds, inv):
    """u of the plain forward with the trunk's hidden products modelled as
    3xTF32 (ThreeTF32)."""
    n, ns = c.shape[0], len(inv)
    record = []
    relu = act.relu
    act.relu = with_relu(record)
    try:
        with torch.no_grad(), ThreeTF32():
            ys = RM.real_mlp_plain(canon, c.repeat(ns, 1), kinds,
                                   (tuple(float(g) for g in inv), n))
            MM.mscale2_combine(comb, ys.reshape(ns, n, ys.shape[-1]),
                               "freq_combine")
    finally:
        act.relu = relu
    return record[0]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("port_mscale_reference.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    model = S.mscale2_models(get_inr, TC, get_config(S.MSCALE2_CONFIG))[0]
    canon, comb, kinds, inv = S.mscale2_fold(torch, MM, model, 18, dev)
    c, t, gt, _ = S.real_inputs(torch, 256 * 256, 2, 3, 19, dev)
    c64, t64, gt64 = c.double(), t.double(), gt.double()
    canon64, comb64 = (tree.map(lambda x: x.double(), p)
                       for p in (canon, comb))

    u32, u64, umask = [], [], []
    p32 = plain_step(canon, comb, c, t, gt, kinds, inv, u32)
    p64 = plain_step(canon64, comb64, c64, t64, gt64, kinds, inv, u64)
    mask = u32[0] > 0
    p64m = plain_step(canon64, comb64, c64, t64, gt64, kinds, inv, umask,
                      mask)
    kern = S.mscale2_tensors(*MS.mscale2_step(
        canon, comb, c, t, kinds, inv, gt=gt, want_metrics=True))
    torch.cuda.synchronize()
    ux3 = combiner_input(canon, comb, c, kinds, inv)

    outputs = {}
    for name, w64 in p64.items():
        scale = float(w64.abs().max()) or 1.0

        def dist(a, b):
            return float((a.double() - b.double()).abs().max()) / scale
        row = {"fp32_plain_vs_f64": dist(p32[name], w64),
               "kernel_vs_f64": dist(kern[name], w64),
               "kernel_vs_fp32_plain": dist(kern[name], p32[name]),
               "f64_with_fp32_mask_vs_fp32_plain": dist(p64m[name],
                                                        p32[name])}
        if max(row["fp32_plain_vs_f64"], row["kernel_vs_f64"]) > 1e-5:
            outputs[name] = row

    ref = u64[0]
    relu = {"units": ref.numel(), "max_abs_u64": float(ref.abs().max())}
    for label, u in (("fp32_plain", u32[0]), ("3xtf32_model", ux3)):
        flip = (u > 0) != (ref > 0)
        relu[label] = {
            "sign_differs": int(flip.sum()),
            "largest_abs_u64_where_it_differs":
                float(ref[flip].abs().max()) if flip.any() else 0.0}
    relu["fp32_plain_vs_3xtf32_model_sign_differs"] = int(
        ((u32[0] > 0) != (ux3 > 0)).sum())
    print(json.dumps({"case": "chip_smoke.py mscale2_step full (n 65,536, "
                      "ns 3, seeds 18/19)", "nvidia_smi": smi,
                      "outputs": outputs, "relu": relu}))


if __name__ == "__main__":
    main()
