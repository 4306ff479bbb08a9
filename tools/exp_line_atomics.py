#!/usr/bin/env python3
"""The line_sample scatter's atomics at the CT shape, on one GPU: the
source as committed, which adds each tap with Hopper's vector
atomicAdd(float2*, float2), against a variant that adds its re and im
parts with two float atomics.

    python3 tools/exp_line_atomics.py [--iters 50]

The variant is a text substitution of a copy of csrc/line_sample.cu
(``add_tap``'s body), built by nvcc with the package's flags.  Both
libraries run the scatter (its memset and kernel, through the wrapper's
``_run``) on one random cotangent at P 1,024, 100 angles over [0, 180], K
513, in turns (variant, committed, committed, variant): per turn the ms of
a call (CUDA events over ITERS calls after two warm-up calls) and the
scatter kernel's device time (torch.profiler).  One JSON line gives the
mean of each library's two turns, each one's largest distance from the
plain version's gradient over max |plain|, and the card's name and power
limit.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
import port_parent_times as PPT  # noqa: E402
from wire_tpu_torch.operators import radon as TR  # noqa: E402
from wire_tpu_torch.ops import build  # noqa: E402
from wire_tpu_torch.ops import line_sample as LS  # noqa: E402

VECTOR_ADD = "  atomicAdd(p, v);\n"
TWO_FLOAT_ADDS = "  atomicAdd(&p->x, v.x);\n  atomicAdd(&p->y, v.y);\n"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_line_atomics.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    P, A = 1024, 100
    centre, gy, gx, uncentre = TR._fourier_consts(
        P, np.linspace(0, 180, A, dtype=np.float32), dev)
    K = gy.shape[1]
    rng = np.random.default_rng(6)
    cot = torch.view_as_complex(torch.tensor(
        rng.normal(size=(A, K, 2)).astype(np.float32), device=dev))
    F = torch.zeros((P, P), dtype=torch.complex64, device=dev,
                    requires_grad=True)
    (want,) = torch.autograd.grad(
        LS.sample_spectrum_plain(F, centre, gy, gx, uncentre), F, cot)
    want = torch.view_as_real(want)
    f_bar = torch.empty((P, P), dtype=torch.complex64, device=dev)

    def scatter():
        LS._run("spectrum_scatter", "scatter",
                (cot, centre, gy, gx, uncentre, f_bar), A * K, K, P, dev)

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build.BUILD_DIR, prefix="exp_atomics_")
    try:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(build.CSRC_DIR, csrc)
        path = os.path.join(csrc, "line_sample.cu")
        with open(path) as f:
            text = f.read()
        assert text.count(VECTOR_ADD) == 1, VECTOR_ADD
        with open(path, "w") as f:
            f.write(text.replace(VECTOR_ADD, TWO_FLOAT_ADDS))
        trees = {"two_float_atomics": (csrc, os.path.join(tmp, "_build")),
                 "vector_atomic": (build.CSRC_DIR, build.BUILD_DIR)}
        times = {t: [] for t in trees}
        kernel = {t: [] for t in trees}
        dist = {}
        for tree in ("two_float_atomics", "vector_atomic", "vector_atomic",
                     "two_float_atomics"):
            PPT.use(*trees[tree])
            LS._lib.cache_clear()
            scatter()
            torch.cuda.synchronize()
            dist[tree] = float((torch.view_as_real(f_bar) - want).abs().max()
                               / want.abs().max())
            times[tree].append(S.cuda_ms(torch, scatter, args.iters))
            kernel[tree].append(S.kernel_device_ms(
                torch, scatter, args.iters, ("spectrum_scatter_kernel",)))
            print(f"{tree}: {times[tree][-1]:.4f} ms, kernel "
                  f"{kernel[tree][-1]} ms", flush=True)
        print(json.dumps({
            "nvidia_smi": PPT.smi(), "iters": args.iters,
            "call_ms": {t: sum(v) / len(v) for t, v in times.items()},
            "kernel_ms": {t: sum(v) / len(v) for t, v in kernel.items()},
            "max_rel_err_vs_plain": dist}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
