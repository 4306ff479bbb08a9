#!/usr/bin/env python3
"""Which real family's step fails tests/test_torch_gpu.py::
test_real_family_fits_launch_the_kernels on which inputs, and why: the
trace of that test's one failure on the card, on one GPU.

    python3 tools/port_unseeded_trace.py [--seeds N]    # default 300

The test drew its coordinates and targets from torch's global CUDA
generator (``torch.rand``), whose seed PyTorch draws afresh in every
process (``torch.cuda.initial_seed()`` differs run to run), so each run of
it took new inputs and a failing run cannot be replayed.  This runs the
repaired test's own inputs (``test``: CPU generators seeded 25 and 26,
moved to the card) and N more drawn the same way (``seed k``: 1000 + k
and 2000 + k).  For every family of the test and every input it prints
one JSON line:

  launched        the family's step launched real_step once
  kernel_vs_fp32  max |kernel - fp32 plain| / (1e-4 x max |fp32 plain|)
                  per output, the test's own check (> 1 fails)
  fp32_vs_f64     the fp32 plain run's distance from the plain run in
                  float64 (every parameter and input cast), in the same
                  unit
  kernel_vs_f64   the kernel's distance from the float64 run, likewise
  fails           the outputs where kernel_vs_fp32 > 1
  kink            for relu families, per activation layer the least
                  |v| / max |v| of the float64 run's pre-activations (a
                  unit within fp32 rounding of the kink lies near 1e-7)

then per family a summary line (inputs that fail, its worst case and
output, and there the fp32 plain run's and the kernel's distances from
float64) and last the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from wire_tpu_torch import tree  # noqa: E402
from wire_tpu_torch.nn import models as MM  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr  # noqa: E402
from wire_tpu_torch.train.profiling import launches  # noqa: E402

REL = 1e-4
FAMILIES = ("siren", "gauss", "relu", "posenc", "bspline_form",
            "bspline_cubic", "bspline_srelu", "bspline_knots",
            "bspline_mscale_1", "bspline_mscale_1_new",
            "bspline_mscale_repIN")


def family_kw(nonlin):
    """The test's factory keywords for a family."""
    kw = dict(hidden_features=64, out_features=3, sidelength=64,
              scale=0.5 if nonlin.startswith("bspline") else 2.0)
    if nonlin.startswith("bspline_mscale"):
        kw.update(scale_tensor=(1.0, 2.0), scaled_hidden_features=16)
    if nonlin in ("bspline_mscale_1_new", "bspline_mscale_repIN"):
        kw["in_features"] = 2 * 2 * 16
    return kw


def inputs(seed_c, seed_t, dev):
    """The test's (c, t): CPU generator draws moved to the card."""
    c = torch.rand((600, 2), generator=torch.Generator().manual_seed(
        seed_c)) * 2 - 1
    t = torch.rand((600, 3), generator=torch.Generator().manual_seed(seed_t))
    return c.to(dev), t.to(dev)


def flat(pred, grads, sums):
    out = {"pred": pred, "sse_t": sums[0], "sse_g": sums[1]}
    out.update({".".join(map(str, p)): v for p, v in tree.leaves(grads)})
    return out


def rel(got, want):
    return {k: float((got[k].double() - w.double()).abs().max())
            / (REL * max(float(w.double().abs().max()), 1e-300))
            for k, w in want.items()}


def kink(model, params, c):
    """Per layer, min |v| / max |v| of the float64 pre-activations of a
    relu family's canonical fold."""
    spec = model.spec
    canon = MM._canon_relu(tree.map(lambda v: v.double(), params), spec)
    a = MM._posenc_pre(c.double(), spec)
    out = []
    for lay in canon["layers"]:
        v = lay["alpha"] * (a @ lay["w"]) + lay["beta"]
        out.append(float(v.abs().min() / v.abs().max()))
        a = torch.relu(v)
    return out


def case(nonlin, c, t, dev):
    kw = family_kw(nonlin)
    model = get_inr(nonlin, **kw)
    plain = get_inr(nonlin, fused="never", **kw)
    params = model.init(torch.Generator().manual_seed(0), dev)
    before = launches("real_mlp")["step"]
    got = flat(*model.step_grads(params, c, t, want_metrics=True))
    torch.cuda.synchronize()
    launched = launches("real_mlp")["step"] - before
    want = flat(*plain.step_grads(params, c, t, want_metrics=True))
    want64 = flat(*plain.step_grads(tree.map(lambda v: v.double(), params),
                                    c.double(), t.double(),
                                    want_metrics=True))
    k32 = rel(got, want)
    out = {"family": nonlin, "launched": launched, "kernel_vs_fp32": k32,
           "fp32_vs_f64": rel(want, want64),
           "kernel_vs_f64": rel(got, want64),
           "fails": sorted(k for k, v in k32.items() if v > 1.0)}
    if nonlin in ("relu", "posenc"):
        out["kink"] = kink(model, params, c)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=300)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [("test", inputs(25, 26, dev))]
    cases += [(f"seed {k}", inputs(1000 + k, 2000 + k, dev))
              for k in range(args.seeds)]
    worst, fails = {}, {}
    for name, (c, t) in cases:
        for nonlin in FAMILIES:
            out = case(nonlin, c, t, dev)
            out["inputs"] = name
            print(json.dumps(out), flush=True)
            if out["fails"]:
                fails.setdefault(nonlin, []).append(name)
            leaf, ratio = max(out["kernel_vs_fp32"].items(),
                              key=lambda kv: kv[1])
            if ratio > worst.get(nonlin, ("", "", 0.0))[2]:
                worst[nonlin] = (name, leaf, ratio, out["fp32_vs_f64"][leaf],
                                 out["kernel_vs_f64"][leaf],
                                 out.get("kink"))
    for nonlin, (name, leaf, ratio, f32, k64, kinks) in worst.items():
        print(json.dumps({"summary": nonlin, "inputs": len(cases),
                          "failing": fails.get(nonlin, []),
                          "worst_inputs": name, "output": leaf,
                          "kernel_vs_fp32": ratio, "fp32_vs_f64": f32,
                          "kernel_vs_f64": k64, "kink": kinks}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
