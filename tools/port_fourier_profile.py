#!/usr/bin/env python3
"""Where the time of the fourier Radon operator goes, on one GPU: the
operator's ops in order, and the host time of its line_sample call split
into parts.

    python3 tools/port_fourier_profile.py [--root DIR] [--iters 50]

DIR (default: this tree) is the tree whose wire_tpu_torch and chip_smoke.py
are imported, so an earlier tree (a git archive of it) can be measured by
the same script; its libraries are built into DIR/wire_tpu_torch/_build.
The trees before the spectrum sampler take four (P + 2)^2 planes
(``sample_lines``), the later ones the unshifted spectrum
(``sample_spectrum``); the script reads which from the module.

At the CT shape (a 256^2 image, 100 angles over [0, 180], P 1,024, K 513)
it prints one JSON line with:

- ``ops``: the top-level host ranges of one forward and backward of
  radon(img, angles, method="fourier") in the order they first ran, each
  with its calls, host us (the range's length), and the device launches
  (kernels and memsets) and device us of the range and everything under it
  (torch.profiler, ITERS calls, per call);
- ``row4_host_us``: the line_sample call of the operator (the forward and
  its backward through autograd, on the spectrum the operator gives it)
  timed on the host clock (ITERS calls after a warm-up, one synchronise at
  the end; the device work is far shorter than the host's), and its parts:
  the wrapper's checks and contiguous copies (the whole call less the
  autograd Function applied to inputs made ready), the allocations of the
  outputs, the ctypes launch calls with the scatter's memsets, and the
  autograd Function's own cost (what is left of the Function's call);
- ``smoke_row4_ms``: chip_smoke.py's row-4 call at its measure inputs
  (CUDA events over ITERS calls, its harness included) and its kernels'
  device time;
- the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def host_us(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def op_table(torch, prof, iters):
    """[{name, calls, host_us, launches, device_us}] per call of the
    top-level host ranges, in the order they first ran."""
    from torch.autograd import DeviceType

    def kernels(e):
        return list(e.kernels) + [k for c in e.cpu_children
                                  for k in kernels(c)]
    rows = {}
    tops = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.cpu_parent is None
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda e: e.time_range.start)
    for e in tops:
        r = rows.setdefault(e.name, {"name": e.name, "calls": 0,
                                     "host_us": 0.0, "launches": 0,
                                     "device_us": 0.0})
        ks = kernels(e)
        r["calls"] += 1 / iters
        r["host_us"] += (e.time_range.end - e.time_range.start) / iters
        r["launches"] += len(ks) / iters
        r["device_us"] += sum(k.duration for k in ks) / iters
    return list(rows.values())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as S
    from wire_tpu_torch.apps import ct as TCT
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.operators import radon as TR
    from wire_tpu_torch.ops import line_sample as LS
    from wire_tpu_torch.ops import rotsum as R
    from wire_tpu_torch.ops import wire_mlp as WM
    from wire_tpu_torch.train.presets import get_config

    if not torch.cuda.is_available():
        raise SystemExit("port_fourier_profile.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    it = args.iters
    rng = np.random.default_rng(0)
    angles = np.linspace(0, 180, 100, dtype=np.float32)
    img = torch.tensor(rng.random((256, 256)).astype(np.float32), device=dev,
                       requires_grad=True)
    cot = torch.tensor(rng.normal(size=(100, 256)).astype(np.float32),
                       device=dev)

    def operator():
        y = TR.radon(img, angles, method="fourier")
        torch.autograd.grad(y, img, cot)
    operator()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(it):
            operator()
        torch.cuda.synchronize()
    ops = op_table(torch, prof, it)

    # the line_sample call on what the operator hands it
    P = TR._fft_size(4 * 256)
    pad, _, _ = TR._pad_center(img.detach(), P)
    centre, gy, gx, uncentre = TR._fourier_consts(P, angles, dev)
    spectrum = torch.fft.fftn(pad)
    A, K = gy.shape
    parts = {}
    if hasattr(LS, "sample_spectrum"):
        Fleaf = spectrum.clone().requires_grad_(True)
        c = torch.view_as_complex(torch.tensor(
            rng.normal(size=(A, K, 2)).astype(np.float32), device=dev))

        def call():
            y = LS.sample_spectrum(Fleaf, centre, gy, gx, uncentre)
            torch.autograd.grad(y, Fleaf, c)

        def apply():
            y = LS._SampleSpectrum.apply(Fleaf, centre, gy, gx, uncentre)
            torch.autograd.grad(y, Fleaf, c)
        out = torch.empty((A, K), dtype=torch.complex64, device=dev)
        fbar = torch.empty((P, P), dtype=torch.complex64, device=dev)

        def alloc():
            torch.empty(gy.shape, dtype=torch.complex64, device=dev)
            torch.empty(centre.shape, dtype=torch.complex64, device=dev)

        def launch():
            LS._run("spectrum_gather", "gather",
                    (Fleaf, centre, gy, gx, uncentre, out), A * K, K, P, dev)
            LS._run("spectrum_scatter", "scatter",
                    (c, centre, gy, gx, uncentre, fbar), A * K, K, P, dev)
    else:
        Fs = torch.fft.fftshift(spectrum) * centre
        Fh = torch.cat([Fs, Fs[:2]], 0)
        Fh = torch.cat([Fh, Fh[:, :2]], 1).detach().requires_grad_(True)
        ph = P + 2
        c = tuple(torch.tensor(rng.normal(size=(A, K)).astype(np.float32),
                               device=dev) for _ in range(2))
        planes = [t.detach().contiguous().requires_grad_(True)
                  for t in (Fh.real, Fh.imag)]

        def call():
            y = LS.sample_lines(torch.real(Fh), torch.imag(Fh), gy, gx)
            torch.autograd.grad(y, Fh, c)

        def apply():
            y = LS._SampleLines.apply(*planes, gy, gx)
            torch.autograd.grad(y, planes, c)
        sre, sim = (torch.empty((A, K), device=dev) for _ in range(2))
        fre, fim = (torch.empty((ph, ph), device=dev) for _ in range(2))

        def alloc():
            for shape in ((A, K), (A, K), (ph, ph), (ph, ph)):
                torch.empty(shape, dtype=torch.float32, device=dev)

        def launch():
            LS._run("line_sample_gather", "gather",
                    (*planes, gy, gx, sre, sim), A * K, ph, dev)
            LS._run("line_sample_scatter", "scatter",
                    (*c, gy, gx, fre, fim), A * K, ph, dev)
    for name, fn in (("call", call), ("function", apply),
                     ("allocations", alloc), ("ctypes_and_memsets", launch)):
        parts[name] = host_us(torch, fn, it * 4)
    parts["checks_and_contiguous"] = parts["call"] - parts["function"]
    parts["function_overhead"] = (parts["function"] - parts["allocations"]
                                  - parts["ctypes_and_memsets"])

    model, _ = S.ct_models(get_inr, TCT, get_config(S.CT_CONFIG))
    cases, _, _ = S.ct_kernel_cases(torch, WM, R, LS, model, 256 * 256, 256,
                                    100, P, K, seed=4, device=dev)
    kfn, _, _, xs, kcot = cases["line_sample"]

    def smoke_call():
        return S.vjp(torch, kfn, xs, kcot)
    smoke = {"ms": S.cuda_ms(torch, smoke_call, 20),
             "kernel_ms": S.kernel_device_ms(torch, smoke_call, 20,
                                             S.kernel_names("line_sample"))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "iters": it, "nvidia_smi": smi,
                      "api": ("sample_spectrum"
                              if hasattr(LS, "sample_spectrum")
                              else "sample_lines"),
                      "operator_launches": sum(r["launches"] for r in ops),
                      "operator_device_us": sum(r["device_us"] for r in ops),
                      "ops": ops, "row4_host_us": parts,
                      "smoke_row4_ms": smoke}))


if __name__ == "__main__":
    main()
