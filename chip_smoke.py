#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wire_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # 300-epoch / 300-iteration fits,
                                       # floors from wire_tpu on the CPU
    python3 chip_smoke.py --epochs 2000   # the full denoise bench protocol,
                                          # 25 dB floor

It drives five paths of the port: WIRE-300 denoise through fit_pointwise
(kernel: wire_step), WIRE-300 CT reconstruction through fit_operator
(kernels: wire_mlp, and line_sample for the 'auto' = fourier method or
rotsum for 'rotate'), B-spline denoise through fit_pointwise (preset
Bspline_s9_5_LR8e3_E4000; kernel: real_step), B-spline SISR through
fit_operator (preset Bspline_s9_LR1e3_E2000; kernel: real_mlp's pair) and
mscale_2 denoise through fit_pointwise (preset Mscale2_ST8_3_LR8e3_E4000;
kernel: mscale2_step).
Phases, each printing one JSON line with its wall time:
  device           card name and count, nvidia-smi's name and power limit;
                   TF32 off for matmuls and cuDNN
  build            nvcc builds every kernel library from csrc/, all at once
  kernel_vs_plain  each kernel against its plain PyTorch version at its
                   path's full shape, plus a ragged case; real_mlp's
                   every basis kind, lane segments and row_gamma; real_step
                   at the mscale_hier and mscale_HL folds; wire_mlp
                   on (b, N, 2) coordinates and without a gradient (equal
                   output, peak memory of two ping-pong planes); rotsum on
                   a non-square image
  measure          kernel (as a host call, and its kernels' device time
                   from torch.profiler), plain and library times at those
                   shapes, and the card's least time for the same work
  fit              the denoise bench protocol (65,536 coordinates, full
                   batch) through fit_pointwise, once through the kernel
                   (launch counts reset just before, read just after) and
                   once through the plain path, from one init
  fit_ct           the CT protocol (256 x 256 field, 100 angles) through
                   fit_operator for each Radon method, 'auto' and 'rotate',
                   once through the kernels (counts reset just before, read
                   just after) and once through the plain path, from one
                   init
  fit_real         B-spline denoise (the 256 x 256 image, 65,536
                   coordinates, full batch) for 300 epochs, through the
                   kernel (counts reset just before, read just after), the
                   plain path (fused="never") and the kernel's plain
                   version in the same canonical fold, from one init
  fit_sisr         B-spline SISR (168 x 168 HR, x4 box downsample) for 300
                   iterations, likewise
  fit_mscale2      mscale_2 denoise (scales 1/9, 4, 8 on the 256 x 256
                   image, 65,536 coordinates, full batch) for 300 epochs,
                   through the kernel (counts reset just before, read just
                   after) and the plain path (fused="never"), from one init
Then the nvidia-smi line, a ``kernels`` JSON line, and last, on success only,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit);
without a CUDA device it exits non-zero before any phase.  It imports
nothing of JAX or wire_tpu.
"""
import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Best PSNR of the 300-epoch fit from wire_tpu on the CPU (fused="never",
# float32, the bench protocol, this script's seed-0 init moved across with
# wire_tpu_torch.bridge), as printed by tools/port_smoke_floor.py; the kernel
# fit must reach it less 0.2 dB.  2000 epochs is the bench's own 25 dB floor.
WIRE_TPU_300_EPOCH_PSNR_DB = 26.159610748291016
PSNR_FLOORS_DB = {300: WIRE_TPU_300_EPOCH_PSNR_DB - 0.2, 2000: 25.0}
PSNR_AGREE_DB = 0.05

# Best PSNR of the 300-iteration CT fits from wire_tpu on the CPU
# (fit_operator, fused="never", float32, the CT protocol, this script's
# seed-0 init moved across), as printed by tools/port_ct_floor.py, by Radon
# method ('auto' is 'fourier' on the card); the kernel fits must reach them
# less 0.2 dB, and agree with the plain fits within PSNR_AGREE_DB.
WIRE_TPU_300_ITER_CT_PSNR_DB = {"auto": 28.474111557006836,
                                "rotate": 28.00259780883789}
CT_ITERS = 300
CT_CONFIG = "WIRE_s12_o8_LR5e3_E2000"

# Best PSNR of the 300-epoch B-spline denoise fit and best -10 log10(MSE)
# of the 300-iteration B-spline SISR fit from wire_tpu on the CPU
# (fused="never", float32, this script's seed-0 init moved across), as
# printed by tools/port_real_floor.py; the kernel fits must reach them less
# 0.2 dB, and agree with the plain fits within PSNR_AGREE_DB.
WIRE_TPU_300_REAL_DB = {"denoise": 27.099899291992188,
                        "sisr": 27.504344125842053}
REAL_ITERS = 300
REAL_DENOISE_CONFIG = "Bspline_s9_5_LR8e3_E4000"
REAL_SISR_CONFIG = "Bspline_s9_LR1e3_E2000"

# Best PSNR of the 300-epoch mscale_2 denoise fit from wire_tpu on the CPU
# (fused="never", float32, this script's seed-0 init moved across), as
# printed by tools/port_mscale_floor.py; the kernel fit must reach it less
# 0.2 dB, and agree with the plain fit within PSNR_AGREE_DB.
WIRE_TPU_300_MSCALE2_DB = 26.10752296447754
MSCALE2_CONFIG = "Mscale2_ST8_3_LR8e3_E4000"

# H100 SXM published peaks (NVIDIA data sheet), at the 700 W power limit.
H100_FP32_TFLOPS = 67.0
H100_HBM_TBPS = 3.35

KERNEL_LIBRARIES = ("wire_step", "wire_mlp", "rotsum", "line_sample",
                    "real_mlp", "mscale2_step")
# the kernels line: name -> (library source, the TPU kernel it replaces)
KERNELS = {
    "wire_step": ("wire_step", "wire_tpu/ops/pallas/wire_step.py:356"),
    "wire_mlp": ("wire_mlp", "wire_tpu/ops/pallas/wire_mlp.py:296"),
    "rotsum": ("rotsum", "wire_tpu/ops/pallas/rotsum.py:259"),
    "line_sample": ("line_sample", "wire_tpu/ops/pallas/line_sample.py:144"),
    "real_step": ("real_mlp", "wire_tpu/ops/pallas/real_mlp.py:689"),
    "real_mlp": ("real_mlp", "wire_tpu/ops/pallas/real_mlp.py:304"),
    "mscale2_step": ("mscale2_step",
                     "wire_tpu/ops/pallas/mscale2_step.py:222"),
}

# Kernel vs plain: max abs error <= REL_TOL * max |plain| per output tensor.
# Both sum fp32 products over up to 65,536 rows in different orders (tiles
# and fixed-order chunk partials vs cuBLAS), so they differ by rounding.
REL_TOL = 1e-4


def emit(phase, t0, **fields):
    print(json.dumps({"phase": phase, "wall_s": round(time.time() - t0, 3),
                      **fields}), flush=True)


def tensors_of(pred, grads, sums):
    """{name: tensor} of a step's outputs, gradients named by their tree
    path ("first.w", "combiner.freq_0.b", "layers.0.alpha", ...)."""
    out = {"pred": pred, "sse_target": sums[0], "sse_gt": sums[1]}
    out.update({".".join(map(str, path)): v
                for path, v in tree_leaves(grads)})
    return out


def compare(got, want, what):
    """Max abs error per tensor; raises past REL_TOL * max |want|."""
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        if not err <= REL_TOL * scale + 1e-30 * (scale == 0.0):
            raise AssertionError(
                f"{what}: {name} max abs err {err:.3e} > {REL_TOL} x "
                f"max|plain| {scale:.3e}")
        worst = max(worst, err)
    return worst


def inputs(torch, model, n, seed, device):
    import numpy as np
    rng = np.random.default_rng(seed)
    o = model.spec.out_features
    params = model.init(torch.Generator().manual_seed(seed), device)
    coords, target, gt = (torch.tensor(a, device=device) for a in (
        rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        rng.uniform(0, 1, (n, o)).astype(np.float32),
        rng.uniform(0, 1, (n, o)).astype(np.float32)))
    return params, coords, target, gt


def matmul_vjp(torch, w, coords, spec, cotangent, want_dcoords=False):
    """The WIRE forward and backward as torch.matmul calls on the stacked
    layout with the backward written out, for the output cotangent
    ``cotangent(y)``: the library yardstick (not used by the port).
    Returns (y, gw1, gWh, gfW, dcoords or None)."""
    h = w["w1"].shape[1]
    s2 = spec.scale ** 2
    om, om1 = spec.hidden_omega0, spec.first_omega0

    def gabor(zr, zi, omega):
        m = torch.exp(-omega * zi - s2 * (zr * zr + zi * zi))
        return torch.cat([m * torch.cos(omega * zr),
                          m * torch.sin(omega * zr)], 1)

    def gabor_bwd(da, a, zr, zi, omega):
        dar, dai, ar, ai = da[:, :h], da[:, h:], a[:, :h], a[:, h:]
        t1 = dar * ar + dai * ai
        t2 = dai * ar - dar * ai
        dzr = -2.0 * s2 * zr * t1 + omega * t2
        return dzr, (-omega - 2.0 * s2 * zi) * t1

    z1 = torch.addmm(w["b1"], coords, w["w1"])
    acts, zs = [gabor(z1, torch.zeros_like(z1), om1)], []
    for l in range(spec.hidden_layers):
        z = torch.addmm(w["Bh"][l], acts[-1], w["Wh"][l])
        zs.append(z)
        acts.append(gabor(z[:, :h], z[:, h:], om))
    y = torch.addmm(w["fb"], acts[-1], w["fW"])
    g = cotangent(y)
    gfW = torch.cat([acts[-1].t() @ g, g.sum(0, keepdim=True)])
    da = g @ w["fWT"]
    gWh = [torch.empty((0, 2 * h + 1, 2 * h), device=y.device)]
    for l in reversed(range(spec.hidden_layers)):
        dz = torch.cat(gabor_bwd(da, acts[l + 1], zs[l][:, :h], zs[l][:, h:],
                                 om), 1)
        gWh.insert(0, torch.cat([acts[l].t() @ dz,
                                 dz.sum(0, keepdim=True)])[None])
        da = dz @ w["WhT"][l]
    dz1, _ = gabor_bwd(da, acts[0], z1, torch.zeros_like(z1), om1)
    gw1 = torch.cat([coords.t() @ dz1, dz1.sum(0, keepdim=True)])
    dcoords = dz1 @ w["w1"].t() if want_dcoords else None
    return y, gw1, torch.cat(gWh), gfW, dcoords


def matmul_step(torch, w, coords, target, gt, spec):
    """The masked-MSE train step through ``matmul_vjp``."""
    n, o = target.shape
    y, gw1, gWh, gfW, _ = matmul_vjp(
        torch, w, coords, spec, lambda y: (2.0 / (n * o)) * (y - target))
    et, eg = y - target, y - gt
    return y, gw1, gWh, gfW, ((et * et).sum(), (eg * eg).sum())


def vjp(torch, fn, inputs, cot):
    """{"out": fn(*inputs)} plus "d<i>": the gradient of <fn(...), cot>
    w.r.t. input i (zeros where unused); fn may return a tuple, then cot is
    a tuple too and the outputs are "out0", "out1", ..."""
    xs = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    grads = torch.autograd.grad(outs, xs, cots, allow_unused=True)
    res = {(f"out{i}" if len(outs) > 1 else "out"): o.detach()
           for i, o in enumerate(outs)}
    for i, (x, g) in enumerate(zip(xs, grads)):
        res[f"d{i}"] = torch.zeros_like(x) if g is None else g
    return res


def wire_mlp_fn(WM, spec, paths, plain=False):
    """(coords, *leaves) -> y through the kernel or the plain version;
    ``paths``: the parameter tree's leaf paths."""
    apply = WM.wire_mlp_plain if plain else WM.wire_mlp

    def fn(coords, *leaves):
        return apply(tree_unflatten(paths, leaves), coords, spec)
    return fn


def tree_leaves(params):
    """[(path, tensor)] of a parameter tree (wire_tpu_torch/tree.py)."""
    from wire_tpu_torch import tree
    return tree.leaves(params)


def tree_unflatten(paths, leaves):
    from wire_tpu_torch import tree
    return tree.unflatten(paths, leaves)


def leaf_paths(params):
    return [path for path, _ in tree_leaves(params)]


def num_weights(params):
    return sum(t.numel() for _, t in tree_leaves(params))


def rot_grids(torch, S, angles, device):
    """grid_sample grids (A, S, S, 2) of the rotate() convention for
    align_corners=True (tools/oracle_sweep.py:_make_rot_grids)."""
    t = torch.deg2rad(torch.tensor(angles, device=device))
    cos, sin = torch.cos(t)[:, None, None], torch.sin(t)[:, None, None]
    ys, xs = torch.meshgrid(torch.arange(S, dtype=torch.float32,
                                         device=device),
                            torch.arange(S, dtype=torch.float32,
                                         device=device), indexing="ij")
    c = (S - 1) / 2.0
    x, y = xs - c, ys - c
    sx = cos * x - sin * y + c
    sy = sin * x + cos * y + c
    return torch.stack([2 * sx / (S - 1) - 1, 2 * sy / (S - 1) - 1], -1)


def line_positions(torch, P, A, K, device):
    """The fourier method's slice positions (operators/radon.py) for A
    angles over [0, 180] and K = P // 2 + 1 frequencies (or fewer)."""
    import numpy as np
    th = torch.deg2rad(torch.tensor(
        np.linspace(0, 180, A, dtype=np.float32),
        device=device))
    k = torch.arange(K, dtype=torch.float32, device=device)
    return (k[None, :] * torch.sin(th)[:, None] + P // 2,
            k[None, :] * torch.cos(th)[:, None] + P // 2)


def bound(flops, nbytes):
    """(least ms, what bounds it) at the card's fp32 and HBM peaks."""
    ops_ms = flops / (H100_FP32_TFLOPS * 1e9)
    bytes_ms = nbytes / (H100_HBM_TBPS * 1e9)
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def line_sample_bytes(torch, gy, gx, ph):
    """Bytes the gather + scatter pair must move at positions (gy, gx): the
    distinct plane entries its taps read in both planes (the gather reads
    no other), the positions, the samples out and their cotangents in, and
    both (ph, ph) gradient planes out."""
    y0, x0 = torch.floor(gy).long(), torch.floor(gx).long()
    taps = torch.cat([((y0 + dy) * ph + x0 + dx).ravel()
                      for dy in (0, 1) for dx in (0, 1)])
    ntaps = int(torch.unique(taps).numel())
    return 4 * (2 * ntaps + 2 * ph * ph + 6 * gy.numel())


def kernel_names(name):
    """The __global__ functions of csrc/<name>.cu and of the csrc headers
    it includes, directly or through another header."""
    import re
    csrc = os.path.join(ROOT, "wire_tpu_torch", "csrc")
    todo, seen, src = [f"{name}.cu"], set(), ""
    while todo:
        fname = todo.pop()
        if fname in seen:
            continue
        seen.add(fname)
        with open(os.path.join(csrc, fname)) as f:
            text = f.read()
        src += text
        todo += re.findall(r'#include "(\w+\.cuh)"', text)
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        src))


def kernel_device_ms(torch, fn, iters, names):
    """Device time per call of ``fn`` spent in the kernels called ``names``
    (torch.profiler, device-side events), without the host's launch and
    autograd work around them; None where the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and any(n in e.key for n in names))
    return us / 1e3 / iters if us else None


CT_SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
                  "hidden_layers", "first_omega0", "hidden_omega0", "scale")


def ct_models(get_inr, TCT, cfg):
    """The CT app's model (kernels) and the same spec with fused='never'
    (the plain path)."""
    model = TCT.build_ct_model(cfg, cfg.omega0)
    plain = get_inr("wire", fused="never", **{
        f: getattr(model.spec, f) for f in CT_SPEC_FIELDS})
    return model, plain


def ct_kernel_cases(torch, WM, R, LS, model, n, S, A, P, K, seed, device):
    """For each CT kernel: (kernel fn, plain fn, library fn or None, inputs,
    cotangent) at one shape: wire_mlp at n coordinates, rotsum at an
    (S, S) image x A angles, line_sample on (P + 2)^2 planes at A x K
    positions."""
    import numpy as np
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    spec = model.spec
    params = model.init(torch.Generator().manual_seed(seed), device)
    keys = leaf_paths(params)
    coords = t(rng.uniform(-1, 1, (n, 2)))
    g = t(rng.normal(size=(n, spec.out_features)))
    cases = {"wire_mlp": (
        wire_mlp_fn(WM, spec, keys), wire_mlp_fn(WM, spec, keys, plain=True),
        None, [coords] + [t for _, t in tree_leaves(params)], g)}

    angles = np.linspace(0, 180, A, dtype=np.float32)
    grids = rot_grids(torch, S, angles, device)
    cases["rotsum"] = (
        lambda x: R.rotate_project(x, angles),
        lambda x: R.rotate_project_plain(x, angles),
        lambda x: F.grid_sample(x[None, None].expand(A, 1, S, S), grids,
                                align_corners=True)[:, 0].sum(-2),
        [t(rng.random((S, S)))], t(rng.normal(size=(A, S))))

    ph = P + 2
    gy, gx = line_positions(torch, P, A, K, device)
    grid = torch.stack([2 * gx / (ph - 1) - 1, 2 * gy / (ph - 1) - 1],
                       -1)[None]

    def line_library(a, b):
        out = F.grid_sample(torch.stack([a, b])[None], grid,
                            align_corners=True)
        return out[0, 0], out[0, 1]

    cases["line_sample"] = (
        lambda a, b: LS.sample_lines(a, b, gy, gx),
        lambda a, b: LS.sample_lines_plain(a, b, gy, gx), line_library,
        [t(rng.normal(size=(ph, ph))), t(rng.normal(size=(ph, ph)))],
        (t(rng.normal(size=(A, K))), t(rng.normal(size=(A, K)))))
    return cases, params, keys


def ct_kernel_vs_plain(torch, WM, R, LS, model, device):
    """max abs err per kernel at the CT shape ("full") and a ragged one."""
    shapes = {"full": dict(n=256 * 256, S=256, A=100, P=1024, K=513),
              "ragged": dict(n=700, S=96, A=13, P=384, K=193)}
    errs = {name: {} for name in ("wire_mlp", "rotsum", "line_sample")}
    for which, shape in shapes.items():
        cases, _, _ = ct_kernel_cases(torch, WM, R, LS, model, seed=3,
                                      device=device, **shape)
        for name, (kfn, pfn, _, xs, cot) in cases.items():
            got = vjp(torch, kfn, xs, cot)
            torch.cuda.synchronize()
            want = vjp(torch, pfn, xs, cot)
            torch.cuda.synchronize()
            errs[name][which] = compare(got, want, f"{name} {which}")
    return errs


def ct_measure(torch, WM, R, LS, model, device):
    """Times at the CT shape of each kernel's forward + backward pair (and
    of its forward alone), its plain version's pair and a library call's
    pair, with the card's least time for the pair."""
    n, S, A, P, K = 256 * 256, 256, 100, 1024, 513
    cases, params, keys = ct_kernel_cases(torch, WM, R, LS, model, n, S, A,
                                          P, K, seed=4, device=device)
    spec = model.spec
    L, h = spec.hidden_layers, params["first"]["w"].shape[1]
    d, o = spec.in_features, spec.out_features
    nweights = num_weights(params)
    gy, gx = line_positions(torch, P, A, K, device)
    work = {
        "wire_mlp": (WM.apply_flops(n, d, h, o, L),
                     4 * (2 * (n * d + n * o + nweights))),
        "rotsum": (2 * R.sample_flops(A, S), 4 * 2 * (S * S + A * S)),
        "line_sample": (2 * LS.sample_flops(A, K),
                        line_sample_bytes(torch, gy, gx, P + 2)),
    }
    out = {}
    for name, (kfn, pfn, lfn, xs, cot) in cases.items():
        def fwd(fn=kfn, xs=xs):
            with torch.no_grad():
                fn(*xs)
        res = {
            "ms": cuda_ms(torch, lambda: vjp(torch, kfn, xs, cot), 20),
            "kernel_ms": kernel_device_ms(
                torch, lambda: vjp(torch, kfn, xs, cot), 20,
                kernel_names(name)),
            "fwd_ms": cuda_ms(torch, fwd, 20),
            "plain_ms": cuda_ms(torch, lambda: vjp(torch, pfn, xs, cot), 20),
        }
        if name == "wire_mlp":
            w = WM.stack_params(params, L)
            lib = matmul_vjp(torch, w, xs[0], spec, lambda y: cot,
                             want_dcoords=True)
            dp = WM.unstack_grads(*lib[1:4], params, L)
            got = {"out": lib[0], "d0": lib[4]}
            got.update({f"d{i + 1}": t
                        for i, (_, t) in enumerate(tree_leaves(dp))})
            res["library_ms"] = cuda_ms(torch, lambda: matmul_vjp(
                torch, w, xs[0], spec, lambda y: cot, want_dcoords=True), 20)
            res["library"] = "torch.matmul forward + written-out backward"
        else:
            got = vjp(torch, lfn, xs, cot)
            res["library_ms"] = cuda_ms(torch,
                                        lambda: vjp(torch, lfn, xs, cot), 20)
            res["library"] = "F.grid_sample(align_corners=True) + autograd"
        want = vjp(torch, pfn, xs, cot)
        res["library_vs_plain_max_abs_err"] = max(
            float((got[k] - want[k]).abs().max()) for k in want)
        res["bound_ms"], res["bound_by"] = bound(*work[name])
        res["gflop"], res["mbytes"] = work[name][0] / 1e9, work[name][1] / 1e6
        out[name] = res
    return out


def check_ct_launches(launches, method, radon_kernel, iters):
    """Every CT iteration launched wire_mlp forward and backward and the
    method's Radon kernel pair once, and nothing else."""
    for name, counts in launches.items():
        want = iters if name in ("wire_mlp", radon_kernel) else 0
        if any(v != want for v in counts.values()):
            raise AssertionError(
                f"CT {method}: {name} launched {counts} times in {iters} "
                f"iterations, expected {want} each")


def fit_ct(torch, np, mods, device):
    """The CT protocol through fit_operator for 'auto' (fourier on the
    card) and 'rotate': once through the kernels, launch counts reset just
    before and read just after, and once through the plain path, from one
    init; returns per method the fit numbers and the launch counts."""
    WM, R, LS, TR, TCT, M, get_inr, get_config, FitConfig, fit_operator = \
        mods
    cfg = get_config(CT_CONFIG)
    model, plain_model = ct_models(get_inr, TCT, cfg)
    img = TCT.ct_image(None, 0)
    H, W = img.shape
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    grid = TCT.C.grid2d(H, W)
    params = model.init(torch.Generator().manual_seed(0), device)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=CT_ITERS,
                        maxpoints=cfg.maxpoints)
    angles_t = torch.tensor(thetas, device=device)
    counters = {"wire_mlp": WM.launches, "rotsum": R.launches,
                "line_sample": LS.launches}
    out = {}
    for method in ("auto", "rotate"):
        resolved = TR._resolve_auto(method, len(thetas), "cuda", False)
        radon_kernel = {"fourier": "line_sample", "rotate": "rotsum"}[
            resolved]
        sino = TCT.make_sinogram(img, thetas, radon_method=method,
                                 device=device)
        op = TR.RadonOp(thetas, method=method)
        if resolved == "fourier":
            def plain_op(f):
                return TR._radon_fourier(f, angles_t, sampler="plain")
        else:
            plain_op = TR.RadonOp(thetas, method="rotate_xla")
        t0 = time.time()
        for c in counters.values():
            for k in c:
                c[k] = 0
        res = fit_operator(model, params, grid, sino, op, fit_cfg,
                           gt_field=img, field_shape=(H, W), device=device)
        launches = {k: dict(c) for k, c in counters.items()}
        check_ct_launches(launches, method, radon_kernel, CT_ITERS)
        res_plain = fit_operator(plain_model, params, grid, sino, plain_op,
                                 fit_cfg, gt_field=img, field_shape=(H, W),
                                 device=device)
        if {k: dict(c) for k, c in counters.items()} != launches:
            raise AssertionError(f"CT {method}: the plain fit launched a "
                                 f"kernel")
        for r in (res, res_plain):
            if not (np.isfinite(r.best_rec).all()
                    and np.isfinite(r.mse_gt).all()
                    and np.isfinite(r.mse_noisy).all()
                    and r.best_rec.shape == (H, W)):
                raise AssertionError(f"CT {method}: non-finite values or a "
                                     f"wrong shape")
        psnr = float(M.psnr_ref(img, res.best_rec))
        psnr_plain = float(M.psnr_ref(img, res_plain.best_rec))
        if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
            raise AssertionError(
                f"CT {method}: kernel fit {psnr:.3f} dB vs plain fit "
                f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
        floor = WIRE_TPU_300_ITER_CT_PSNR_DB[method] - 0.2
        if not psnr >= floor:
            raise AssertionError(f"CT {method}: kernel fit best PSNR "
                                 f"{psnr:.3f} dB below the floor {floor} dB")
        out[method] = dict(
            radon=resolved, iters=CT_ITERS, launches=launches, psnr_db=psnr,
            psnr_plain_db=psnr_plain, floor_db=floor,
            ssim=float(M.ssim(img, res.best_rec, data_range=1.0)),
            ssim_plain=float(M.ssim(img, res_plain.best_rec,
                                    data_range=1.0)),
            ms_per_iter=res.step_ms, plain_ms_per_iter=res_plain.step_ms,
            fit_wall_s=res.wall_time_s, plain_fit_wall_s=res_plain.wall_time_s,
            wall_s=time.time() - t0)
    return out


REAL_SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
                    "hidden_layers", "first_omega0", "hidden_omega0", "scale",
                    "sidelength", "pos_encode")


def real_models(get_inr, TC, cfg, omega0, sidelength):
    """A B-spline app's model (kernels) and the same spec with
    fused='never' (the plain path)."""
    model = TC.build_model(cfg, in_features=2, out_features=3, omega0=omega0,
                           sidelength=sidelength)
    plain = get_inr(cfg.nonlin, fused="never", **{
        f: getattr(model.spec, f) for f in REAL_SPEC_FIELDS})
    return model, plain


def path_canon(torch, MM, model, seed, device):
    """The canonical weights (ops/real_mlp.py) of a bspline_form model's
    seeded init, and its kinds."""
    params = model.init(torch.Generator().manual_seed(seed), device)
    canon = MM._canon_form(params, model.spec)
    return canon, ("qspline",) * len(canon["layers"])


def random_canon(torch, widths, seed, device):
    """Canonical weights at ``widths`` (d, w_0 .. w_{L-1}, o) with alpha in
    [0.5, 2] and beta in [-1, 1], so every basis is used on its support."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    layers = [{"w": t(rng.uniform(-1, 1, (a, b)) / np.sqrt(a)),
               "alpha": t(rng.uniform(0.5, 2.0, b)),
               "beta": t(rng.uniform(-1, 1, b))}
              for a, b in zip(widths[:-2], widths[1:-1])]
    h, o = widths[-2], widths[-1]
    return {"layers": layers,
            "final": {"w": t(rng.uniform(-1, 1, (h, o)) / np.sqrt(h)),
                      "b": t(rng.uniform(-1, 1, o))}}


def real_mlp_fn(RM, L, kinds, row_gamma=None, plain=False):
    """(coords, *canonical leaves) -> y through the kernels or the plain
    version."""
    def fn(coords, *leaves):
        canon = RM.canon_from_leaves(leaves, L)
        if plain:
            return RM.real_mlp_plain(canon, coords, kinds, row_gamma)
        return RM.real_mlp(canon, coords, kinds, row_gamma)
    return fn


def real_step_tensors(RM, pred, dcanon, sums):
    out = {"pred": pred, "sse_target": sums[0], "sse_gt": sums[1]}
    out.update({".".join(map(str, path)): t
                for path, t in RM.canon_leaves(dcanon)})
    return out


def real_inputs(torch, n, d, o, seed, device):
    import numpy as np
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(a.astype(np.float32), device=device) for a in (
        rng.uniform(-1, 1, (n, d)), rng.uniform(0, 1, (n, o)),
        rng.uniform(0, 1, (n, o)), rng.normal(size=(n, o))))


def real_kernel_vs_plain(torch, RM, MM, model_a, model_b, device):
    """max abs err of real_step and real_mlp: at the denoise (step) and SISR
    (pair, dcoords included) paths' full shapes and ragged ones, each basis
    kind, lane segments and row_gamma."""
    errs = {"real_step": {}, "real_mlp": {}}
    for which, n, nvalid, denom in (("full", 256 * 256, None, None),
                                    ("ragged", 700, 650, 650 * 3.0 + 1.0)):
        canon, kinds = path_canon(torch, MM, model_a, 5, device)
        c, t, gt, _ = real_inputs(torch, n, 2, 3, 6, device)
        got = RM.real_step(canon, c, t, kinds, nvalid=nvalid, denom=denom,
                           gt=gt, want_metrics=True)
        torch.cuda.synchronize()
        want = RM.real_step_plain(canon, c, t, kinds, nvalid=nvalid,
                                  denom=denom, gt=gt, want_metrics=True)
        errs["real_step"][which] = compare(
            real_step_tensors(RM, *got), real_step_tensors(RM, *want),
            f"real_step {which}")
    pair_cases = {"full": (168 * 168, None, None, None),
                  "ragged": (700, None, None, None)}
    widths = (2, 48, 40, 3)
    for kind in ("qspline", "cspline", "sine", "gauss", "relu", "srelu",
                 "identity"):
        pair_cases[kind] = (700, widths, (kind, kind), None)
    pair_cases["segments"] = (700, widths, ((("qspline", 20),
                                             ("identity", 10),
                                             ("sine", 10)), "srelu"), None)
    pair_cases["row_gamma"] = (1000, widths, ("qspline", "gauss"),
                               ((1.0, 0.5, 0.25, 2.0), 250))
    for which, (n, w, kinds, row_gamma) in pair_cases.items():
        if w is None:
            canon, kinds = path_canon(torch, MM, model_b, 7, device)
        else:
            canon = random_canon(torch, w, 8, device)
        L = len(canon["layers"])
        c, _, _, g = real_inputs(torch, n, 2, 3, 9, device)
        xs = [c] + [t for _, t in RM.canon_leaves(canon)]
        got = vjp(torch, real_mlp_fn(RM, L, kinds, row_gamma), xs, g)
        torch.cuda.synchronize()
        want = vjp(torch, real_mlp_fn(RM, L, kinds, row_gamma, plain=True),
                   xs, g)
        errs["real_mlp"][which] = compare(got, want, f"real_mlp {which}")
    step_cases = {"segments_step": (((("qspline", 20), ("identity", 10),
                                      ("sine", 10)), "relu"))}
    for which, kinds in step_cases.items():
        canon = random_canon(torch, widths, 10, device)
        c, t, gt, _ = real_inputs(torch, 700, 2, 3, 11, device)
        got = RM.real_step(canon, c, t, kinds, gt=gt, want_metrics=True)
        want = RM.real_step_plain(canon, c, t, kinds, gt=gt,
                                  want_metrics=True)
        errs["real_step"][which] = compare(
            real_step_tensors(RM, *got), real_step_tensors(RM, *want),
            f"real_step {which}")
    return errs


def repaired_faults(torch, WM, R, ct_model, device):
    """The port's repaired faults, kernel against plain: wire_mlp on (b, N,
    2) coordinates; wire_mlp without a gradient (the pair's output, and a
    peak of two ping-pong planes); rotsum on a non-square image."""
    import numpy as np
    errs = {}
    spec = ct_model.spec
    params = ct_model.init(torch.Generator().manual_seed(12), device)
    keys = leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    rng = np.random.default_rng(13)
    c = torch.tensor(rng.uniform(-1, 1, (4, 50, 2)).astype(np.float32),
                     device=device)
    g = torch.tensor(rng.normal(size=(4, 50, 1)).astype(np.float32),
                     device=device)
    got = vjp(torch, wire_mlp_fn(WM, spec, keys), [c] + leaves, g)
    want = vjp(torch, wire_mlp_fn(WM, spec, keys, plain=True), [c] + leaves,
               g)
    if got["out"].shape != (4, 50, 1):
        raise AssertionError(f"wire_mlp (4, 50, 2): output shape "
                             f"{tuple(got['out'].shape)}")
    errs["wire_mlp_batched"] = compare(got, want, "wire_mlp (4, 50, 2)")

    n = 256 * 256
    c = torch.tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                     device=device)
    grad_leaves = [t.detach().requires_grad_(True) for t in leaves]
    with_grad = WM.wire_mlp(tree_unflatten(keys, grad_leaves), c,
                            spec).detach()
    del grad_leaves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = WM.wire_mlp(params, c, spec)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    h = params["first"]["w"].shape[1]
    pingpong = 2 * n * 2 * h * 4
    slack = 16 * 2 ** 20
    if not torch.equal(y, with_grad):
        raise AssertionError("wire_mlp without a gradient differs from the "
                             "pair's forward")
    if not peak <= pingpong + slack:
        raise AssertionError(f"wire_mlp without a gradient peaked at {peak} "
                             f"bytes, more than two ping-pong planes "
                             f"({pingpong}) + {slack}")
    errs["wire_mlp_nograd_peak_mb"] = peak / 1e6
    errs["wire_mlp_nograd_pingpong_mb"] = pingpong / 1e6

    angles = np.array([0.0, 7.3, 44.9, 90.0, 121.7, 180.0, -13.4, 315.0],
                      np.float32)
    img = torch.tensor(rng.random((96, 128)).astype(np.float32),
                       device=device)
    cot = torch.tensor(rng.normal(size=(len(angles), 128)).astype(
        np.float32), device=device)
    got = vjp(torch, lambda x: R.rotate_project(x, angles), [img], cot)
    want = vjp(torch, lambda x: R.rotate_project_plain(x, angles), [img],
               cot)
    errs["rotsum_96x128"] = compare(got, want, "rotsum 96 x 128")
    return errs


def real_matmul_vjp(torch, RM, canon, x, kinds, cotangent,
                    want_dcoords=False):
    """The canonical forward and its backward as torch.matmul calls with
    the bases and their derivatives in PyTorch ops, written out, for the
    output cotangent ``cotangent(y)``: the library yardstick (not used by
    the port).  Returns (y, dcanon, dcoords or None)."""
    zs, acts, a = [], [], x
    for lay, kind in zip(canon["layers"], kinds):
        z = a @ lay["w"]
        zs.append(z)
        a = RM._apply_segments(kind, lay["alpha"] * z + lay["beta"], 0)
        acts.append(a)
    y = torch.addmm(canon["final"]["b"], a, canon["final"]["w"])
    g = cotangent(y)
    dfinal = {"w": acts[-1].t() @ g, "b": g.sum(0)}
    da = g @ canon["final"]["w"].t()
    dlayers = [None] * len(zs)
    for l in reversed(range(len(zs))):
        lay = canon["layers"][l]
        dv = RM._apply_segments(kinds[l], lay["alpha"] * zs[l] + lay["beta"],
                                1) * da
        dz = lay["alpha"] * dv
        a_prev = x if l == 0 else acts[l - 1]
        dlayers[l] = {"w": a_prev.t() @ dz, "alpha": (zs[l] * dv).sum(0),
                      "beta": dv.sum(0)}
        if l > 0 or want_dcoords:
            da = dz @ lay["w"].t()
    return y, {"layers": dlayers, "final": dfinal}, (
        da if want_dcoords else None)


def real_matmul_step(torch, RM, canon, x, target, gt, kinds):
    """The masked-MSE train step through ``real_matmul_vjp``."""
    n, o = target.shape
    y, dcanon, _ = real_matmul_vjp(
        torch, RM, canon, x, kinds, lambda y: (2.0 / (n * o)) * (y - target))
    et, eg = y - target, y - gt
    return y, dcanon, ((et * et).sum(), (eg * eg).sum())


def real_measure(torch, RM, MM, model_a, model_b, device):
    """Times of real_step at the denoise shape and of real_mlp's pair
    (dcoords included) at the SISR shape: the kernel (a host call, and its
    kernels' device time), the plain version, the matmul yardstick, and
    the card's least time for the same work."""
    out = {}
    n = 256 * 256
    canon, kinds = path_canon(torch, MM, model_a, 14, device)
    widths = [2] + [lay["w"].shape[1] for lay in canon["layers"]] + [3]
    nweights = sum(t.numel() for _, t in RM.canon_leaves(canon))
    c, t, gt, _ = real_inputs(torch, n, 2, 3, 15, device)
    from wire_tpu_torch.ops.wire_step import StepScratch
    scratch = StepScratch()

    def step():
        return RM.real_step(canon, c, t, kinds, gt=gt, want_metrics=True,
                            scratch=scratch)

    lib_err = compare(
        real_step_tensors(RM, *real_matmul_step(torch, RM, canon, c, t, gt,
                                                kinds)),
        real_step_tensors(RM, *RM.real_step_plain(canon, c, t, kinds, gt=gt,
                                                  want_metrics=True)),
        "real matmul step vs plain")
    flops = RM.step_flops(n, widths)
    nbytes = 4 * (n * (2 + 3 + 3) + nweights + n * 3 + nweights + 2)
    res = {
        "ms": cuda_ms(torch, step, 20),
        "kernel_ms": kernel_device_ms(torch, step, 20,
                                      kernel_names("real_mlp")),
        "plain_ms": cuda_ms(torch, lambda: RM.real_step_plain(
            canon, c, t, kinds, gt=gt, want_metrics=True), 20),
        "library_ms": cuda_ms(torch, lambda: real_matmul_step(
            torch, RM, canon, c, t, gt, kinds), 20),
        "library": "torch.matmul step, bases and written-out backward in "
                   "PyTorch ops",
        "library_vs_plain_max_abs_err": lib_err}
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["real_step"] = res
    del scratch

    n = 168 * 168
    canon, kinds = path_canon(torch, MM, model_b, 16, device)
    L = len(canon["layers"])
    c, _, _, g = real_inputs(torch, n, 2, 3, 17, device)
    xs = [c] + [t for _, t in RM.canon_leaves(canon)]
    kfn = real_mlp_fn(RM, L, kinds)
    pfn = real_mlp_fn(RM, L, kinds, plain=True)

    def pair():
        return vjp(torch, kfn, xs, g)

    def fwd():
        with torch.no_grad():
            kfn(*xs)

    lib = real_matmul_vjp(torch, RM, canon, c, kinds, lambda y: g,
                          want_dcoords=True)
    got = {"out": lib[0], "d0": lib[2]}
    got.update({f"d{i + 1}": tt for i, (_, tt) in
                enumerate(RM.canon_leaves(lib[1]))})
    want = vjp(torch, pfn, xs, g)
    flops = RM.apply_flops(n, widths)
    nbytes = 4 * (2 * (n * 2 + n * 3 + nweights))
    res = {
        "ms": cuda_ms(torch, pair, 20),
        "kernel_ms": kernel_device_ms(torch, pair, 20,
                                      kernel_names("real_mlp")),
        "fwd_ms": cuda_ms(torch, fwd, 20),
        "plain_ms": cuda_ms(torch, lambda: vjp(torch, pfn, xs, g), 20),
        "library_ms": cuda_ms(torch, lambda: real_matmul_vjp(
            torch, RM, canon, c, kinds, lambda y: g, want_dcoords=True), 20),
        "library": "torch.matmul forward, bases and written-out backward in "
                   "PyTorch ops",
        "library_vs_plain_max_abs_err": max(
            float((got[k] - want[k]).abs().max()) for k in want)}
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["real_mlp"] = res
    return out


def reset_counts(counters):
    for c in counters.values():
        for k in c:
            c[k] = 0


def read_counts(counters):
    return {k: dict(c) for k, c in counters.items()}


def check_real_launches(launches, what, want):
    """Every count is zero but the named ones, which are as given."""
    for name, counts in launches.items():
        for k, v in counts.items():
            if v != want.get((name, k), 0):
                raise AssertionError(
                    f"{what}: {name} {k} launched {v} times, expected "
                    f"{want.get((name, k), 0)}")


def fit_real(torch, np, mods, counters, device):
    """B-spline denoise (path A) for REAL_ITERS epochs through fit_pointwise:
    once through the kernel, counts reset just before and read just after,
    once through the plain path (the family's own apply, the relu^2 spline,
    and autograd), and once through the kernel's plain version in the same
    canonical fold (real_step_plain in place of the kernel), from one
    init."""
    TD, TC, M, RM, get_inr, get_config, FitConfig, fit_pointwise = mods
    cfg = get_config(REAL_DENOISE_CONFIG)
    im, im_noisy = TD.denoise_images(cfg)
    H, W, _ = im.shape
    model, plain = real_models(get_inr, TC, cfg, 7.0, H)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = TD.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=REAL_ITERS,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
    reset_counts(counters)
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                        fit_cfg, gt=im.reshape(-1, 3), device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "B-spline denoise",
                        {("real_mlp", "step"): REAL_ITERS})
    res_plain = fit_pointwise(plain, params, grid, im_noisy.reshape(-1, 3),
                              fit_cfg, gt=im.reshape(-1, 3), device=device)
    kernel_step = RM.real_step
    RM.real_step = lambda canon, x, t, kinds, scratch=None, **kw: \
        RM.real_step_plain(canon, x, t, kinds, **kw)
    try:
        res_canon = fit_pointwise(model, params, grid,
                                  im_noisy.reshape(-1, 3), fit_cfg,
                                  gt=im.reshape(-1, 3), device=device)
    finally:
        RM.real_step = kernel_step
    if read_counts(counters) != launches:
        raise AssertionError("B-spline denoise: a plain fit launched a "
                             "kernel")
    for r in (res, res_plain, res_canon):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H * W, 3)):
            raise AssertionError("B-spline denoise: non-finite values or a "
                                 "wrong shape")
    psnr, psnr_plain, psnr_canon = (
        float(M.psnr_ref(im, r.best_rec.reshape(H, W, 3)))
        for r in (res, res_plain, res_canon))
    for what, other in (("plain", psnr_plain),
                        ("canonical plain", psnr_canon)):
        if not abs(psnr - other) <= PSNR_AGREE_DB:
            raise AssertionError(
                f"B-spline denoise: kernel fit {psnr:.3f} dB vs {what} fit "
                f"{other:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_REAL_DB["denoise"] - 0.2
    if not psnr >= floor:
        raise AssertionError(f"B-spline denoise: kernel fit best PSNR "
                             f"{psnr:.3f} dB below the floor {floor} dB")
    return dict(config=REAL_DENOISE_CONFIG, epochs=REAL_ITERS,
                launches=launches["real_mlp"], psnr_db=psnr,
                psnr_plain_db=psnr_plain, psnr_canonical_plain_db=psnr_canon,
                floor_db=floor, ms_per_step=res.step_ms,
                plain_ms_per_step=res_plain.step_ms,
                canonical_plain_ms_per_step=res_canon.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def fit_sisr(torch, np, mods, counters, device):
    """B-spline SISR (path B) for REAL_ITERS iterations through
    fit_operator, through the kernels and the plain path, from one init."""
    TS, TC, TF, M, get_inr, get_config, FitConfig, fit_operator = mods
    cfg = get_config(REAL_SISR_CONFIG)
    scale = cfg.down_scale
    im, im_lr = TS.sisr_images(None, 0, scale)
    H, W, _ = im.shape
    model, plain = real_models(get_inr, TC, cfg, 8.0, H)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = TS.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=REAL_ITERS,
                        maxpoints=cfg.maxpoints, lr_decay=0.2)
    op = TF.DownsampleOp(scale)
    reset_counts(counters)
    res = fit_operator(model, params, grid, im_lr, op, fit_cfg, gt_field=im,
                       field_shape=(H, W, 3), track="gt", device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "B-spline SISR",
                        {("real_mlp", "forward"): REAL_ITERS,
                         ("real_mlp", "backward"): REAL_ITERS})
    res_plain = fit_operator(plain, params, grid, im_lr, op, fit_cfg,
                             gt_field=im, field_shape=(H, W, 3), track="gt",
                             device=device)
    if read_counts(counters) != launches:
        raise AssertionError("B-spline SISR: the plain fit launched a "
                             "kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H, W, 3)):
            raise AssertionError("B-spline SISR: non-finite values or a "
                                 "wrong shape")
    db, db_plain = M.mse_db(res.best_mse), M.mse_db(res_plain.best_mse)
    if not abs(db - db_plain) <= PSNR_AGREE_DB:
        raise AssertionError(f"B-spline SISR: kernel fit {db:.3f} dB vs "
                             f"plain fit {db_plain:.3f} dB differ by more "
                             f"than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_REAL_DB["sisr"] - 0.2
    if not db >= floor:
        raise AssertionError(f"B-spline SISR: kernel fit best -10 log10(MSE) "
                             f"{db:.3f} dB below the floor {floor} dB")
    return dict(config=REAL_SISR_CONFIG, iters=REAL_ITERS,
                launches=launches["real_mlp"], mse_db=db,
                mse_db_plain=db_plain, floor_db=floor,
                ssim=float(M.ssim(im, res.best_rec, data_range=1.0)),
                ms_per_iter=res.step_ms, plain_ms_per_iter=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


MSCALE_SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
                      "hidden_layers", "scaled_hidden_features", "scale",
                      "scale_tensor", "detach_split", "combine_type")


def mscale2_models(get_inr, TC, cfg):
    """The mscale_2 denoise app's model (kernels), the same spec with
    fused='never' (the plain path), and a two-scale twin (the ragged
    kernel case)."""
    model = TC.build_model(cfg, in_features=2, out_features=3, omega0=7.0,
                           sidelength=256)
    kw = {f: getattr(model.spec, f) for f in MSCALE_SPEC_FIELDS}
    plain = get_inr(cfg.nonlin, fused="never", **kw)
    kw["scale_tensor"] = kw["scale_tensor"][:2]
    return model, plain, get_inr(cfg.nonlin, **kw)


def mscale2_fold(torch, MM, model, seed, device):
    """(canon, combiner, kinds, inv_scales) of a mscale_2 model's seeded
    init: the trunk's fold and the freq_combine heads."""
    params = model.init(torch.Generator().manual_seed(seed), device)
    comb = {k: params["combiner"][k] for k in ("freq_0", "freq_1")}
    return (MM._canon_mscale2(params, model.spec), comb,
            MM._mscale2_kinds(model.spec), MM._inv_scales(model.spec))


def mscale2_tensors(pred, dcanon, dcomb, sums):
    return tensors_of(pred, {"trunk": dcanon, "combiner": dcomb}, sums)


def mscale2_kernel_vs_plain(torch, MS, MM, models, device):
    """max abs err of mscale2_step at the path's full shape (n = 65,536,
    ns = 3) and a ragged one (n = 700, nvalid = 650, denom, ns = 2), every
    output tensor."""
    errs = {}
    for which, model, n, nvalid, denom in (
            ("full", models[0], 256 * 256, None, None),
            ("ragged", models[2], 700, 650, 650 * 3.0 + 1.0)):
        canon, comb, kinds, inv = mscale2_fold(torch, MM, model, 18, device)
        c, t, gt, _ = real_inputs(torch, n, 2, 3, 19, device)
        got = MS.mscale2_step(canon, comb, c, t, kinds, inv, nvalid=nvalid,
                              denom=denom, gt=gt, want_metrics=True)
        torch.cuda.synchronize()
        want = MS.mscale2_step_plain(canon, comb, c, t, kinds, inv,
                                     nvalid=nvalid, denom=denom, gt=gt,
                                     want_metrics=True)
        errs[which] = compare(mscale2_tensors(*got), mscale2_tensors(*want),
                              f"mscale2_step {which}")
    return errs


def multiscale_fold_vs_plain(torch, RM, MM, get_inr, get_config, device):
    """real_step's kernel against its plain version at the folds of
    mscale_hier (lane segments 256 qspline + 5 or 261 identity, widths 261
    and 517; preset MscaleHier_ST1o9_LR8e3_E2000) and mscale_HL (a per-lane
    alpha over three bands; preset MscaleHL_s1o9_ST4_3_SHF384_LR8e3_E4000),
    at 4,099 rows with nvalid 4,000."""
    errs = {}
    for which, name, canon_of, kinds_of in (
            ("hier_fold", "MscaleHier_ST1o9_LR8e3_E2000",
             MM._canon_mscale_hier, MM._hier_kinds),
            ("hl_fold", "MscaleHL_s1o9_ST4_3_SHF384_LR8e3_E4000",
             MM._canon_mscale_hl, MM._mscale_hl_kinds)):
        cfg = get_config(name)
        model = get_inr(cfg.nonlin, in_features=2, out_features=3,
                        hidden_features=cfg.hidden_features,
                        scaled_hidden_features=cfg.scaled_hidden_features,
                        scale=cfg.scale, scale_tensor=cfg.scale_tensor)
        params = model.init(torch.Generator().manual_seed(20), device)
        canon, kinds = canon_of(params, model.spec), kinds_of(model.spec)
        c, t, gt, _ = real_inputs(torch, 4099, 2, 3, 21, device)
        got = RM.real_step(canon, c, t, kinds, nvalid=4000, gt=gt,
                           want_metrics=True)
        want = RM.real_step_plain(canon, c, t, kinds, nvalid=4000, gt=gt,
                                  want_metrics=True)
        errs[which] = compare(real_step_tensors(RM, *got),
                              real_step_tensors(RM, *want),
                              f"real_step {which}")
    return errs


def mscale2_matmul_step(torch, RM, canon, comb, x, target, gt, kinds, inv):
    """The mscale_2 step as torch.matmul calls on the stacked scales, the
    bases and their derivatives in PyTorch ops and the backward written
    out: the library yardstick (not used by the port).  Returns (pred,
    dcanon, dcombiner, (sse_target, sse_gt))."""
    n, o = target.shape
    ns = len(inv)
    X = x.repeat(ns, 1)
    gam = torch.tensor(inv, device=x.device).repeat_interleave(n)[:, None]
    zs, acts, a = [], [], X
    for lay, kind in zip(canon["layers"], kinds):
        z = a @ lay["w"]
        zs.append(z)
        a = RM._apply_segments(kind, gam * (lay["alpha"] * z + lay["beta"]),
                               0)
        acts.append(a)
    ys = torch.addmm(canon["final"]["b"], a, canon["final"]["w"])
    cat = ys.reshape(ns, n, o).permute(1, 0, 2).reshape(n, ns * o)
    F0, f0 = comb["freq_0"]["w"], comb["freq_0"]["b"]
    F1, f1 = comb["freq_1"]["w"], comb["freq_1"]["b"]
    u0 = torch.addmm(f0, cat, F0)
    u = torch.relu(u0)
    y = torch.addmm(f1, u, F1)
    e = (2.0 / (n * o)) * (y - target)
    du = (e @ F1.t()) * (u0 > 0)
    dcomb = {"freq_0": {"w": cat.t() @ du, "b": du.sum(0)},
             "freq_1": {"w": u.t() @ e, "b": e.sum(0)}}
    g = (du @ F0.t()).reshape(n, ns, o).permute(1, 0, 2).reshape(ns * n, o)
    dfinal = {"w": acts[-1].t() @ g, "b": g.sum(0)}
    da = g @ canon["final"]["w"].t()
    dlayers = [None] * len(zs)
    for l in reversed(range(len(zs))):
        lay = canon["layers"][l]
        v = gam * (lay["alpha"] * zs[l] + lay["beta"])
        dv = gam * RM._apply_segments(kinds[l], v, 1) * da
        dz = lay["alpha"] * dv
        a_prev = X if l == 0 else acts[l - 1]
        dlayers[l] = {"w": a_prev.t() @ dz, "alpha": (zs[l] * dv).sum(0),
                      "beta": dv.sum(0)}
        if l > 0:
            da = dz @ lay["w"].t()
    et, eg = y - target, y - gt
    return y, {"layers": dlayers, "final": dfinal}, dcomb, (
        (et * et).sum(), (eg * eg).sum())


def mscale2_measure(torch, MS, RM, MM, model, device):
    """Times of mscale2_step at the path's shape: the kernel (a host call,
    and its kernels' device time), the plain version, the matmul
    yardstick, and the card's least time for the same work."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    n = 256 * 256
    canon, comb, kinds, inv = mscale2_fold(torch, MM, model, 22, device)
    c, t, gt, _ = real_inputs(torch, n, 2, 3, 23, device)
    widths = [2] + [lay["w"].shape[1] for lay in canon["layers"]] + [3]
    nweights = num_weights(canon) + num_weights(comb)
    scratch = StepScratch()

    def step():
        return MS.mscale2_step(canon, comb, c, t, kinds, inv, gt=gt,
                               want_metrics=True, scratch=scratch)

    def plain():
        return MS.mscale2_step_plain(canon, comb, c, t, kinds, inv, gt=gt,
                                     want_metrics=True)

    def library():
        return mscale2_matmul_step(torch, RM, canon, comb, c, t, gt, kinds,
                                   inv)

    lib_err = compare(mscale2_tensors(*library()), mscale2_tensors(*plain()),
                      "mscale2 matmul step vs plain")
    flops = MS.step_flops(n, len(inv), widths)
    nbytes = 4 * (n * (2 + 3 + 3) + nweights + n * 3 + nweights + 2)
    res = {
        "ms": cuda_ms(torch, step, 20),
        "kernel_ms": kernel_device_ms(torch, step, 20,
                                      kernel_names("mscale2_step")),
        "plain_ms": cuda_ms(torch, plain, 10),
        "library_ms": cuda_ms(torch, library, 10),
        "library": "torch.matmul step on the stacked scales, bases and "
                   "written-out backward in PyTorch ops",
        "library_vs_plain_max_abs_err": lib_err}
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    return res


def fit_mscale2(torch, np, mods, counters, device):
    """mscale_2 denoise for REAL_ITERS epochs through fit_pointwise: once
    through the kernel, counts reset just before and read just after, and
    once through the plain path (the family's own apply, the relu^2 spline,
    and autograd), from one init."""
    TD, TC, M, get_inr, get_config, FitConfig, fit_pointwise = mods
    cfg = get_config(MSCALE2_CONFIG)
    im, im_noisy = TD.denoise_images(cfg)
    H, W, _ = im.shape
    model, plain, _ = mscale2_models(get_inr, TC, cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = TD.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=REAL_ITERS,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
    reset_counts(counters)
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                        fit_cfg, gt=im.reshape(-1, 3), device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "mscale_2 denoise",
                        {("mscale2_step", "step"): REAL_ITERS})
    res_plain = fit_pointwise(plain, params, grid, im_noisy.reshape(-1, 3),
                              fit_cfg, gt=im.reshape(-1, 3), device=device)
    if read_counts(counters) != launches:
        raise AssertionError("mscale_2 denoise: the plain fit launched a "
                             "kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H * W, 3)):
            raise AssertionError("mscale_2 denoise: non-finite values or a "
                                 "wrong shape")
    psnr, psnr_plain = (float(M.psnr_ref(im, r.best_rec.reshape(H, W, 3)))
                        for r in (res, res_plain))
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(
            f"mscale_2 denoise: kernel fit {psnr:.3f} dB vs plain fit "
            f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_MSCALE2_DB - 0.2
    if not psnr >= floor:
        raise AssertionError(f"mscale_2 denoise: kernel fit best PSNR "
                             f"{psnr:.3f} dB below the floor {floor} dB")
    return dict(config=MSCALE2_CONFIG, epochs=REAL_ITERS,
                launches=launches["mscale2_step"], psnr_db=psnr,
                psnr_plain_db=psnr_plain, floor_db=floor,
                ms_per_step=res.step_ms, plain_ms_per_step=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def cuda_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    faulthandler.dump_traceback_later(900, exit=True)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=300,
                    help="denoise fit epochs (floors at 300 and 2000)")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import build
    from wire_tpu_torch.ops import wire_step as WS
    from wire_tpu_torch.train import metrics as M
    from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise
    from wire_tpu_torch import bench
    import wire_tpu_torch.ops.line_sample as LS
    import wire_tpu_torch.ops.rotsum as R
    import wire_tpu_torch.ops.wire_mlp as WM
    import wire_tpu_torch.operators.radon as TR
    from wire_tpu_torch.apps import ct as TCT
    from wire_tpu_torch.train.presets import get_config
    from wire_tpu_torch.train.trainer import fit_operator
    import wire_tpu_torch.ops.real_mlp as RM
    import wire_tpu_torch.ops.mscale2_step as MS
    import wire_tpu_torch.nn.models as MM
    import wire_tpu_torch.operators.forward as TF
    from wire_tpu_torch.apps import common as TC
    from wire_tpu_torch.apps import denoise as TD
    from wire_tpu_torch.apps import sisr as TS

    # ---- device ----------------------------------------------------------
    t0 = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs the port on an "
                         "NVIDIA GPU and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", t0, kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build -----------------------------------------------------------
    t0 = time.time()
    built = build.build_all(KERNEL_LIBRARIES)
    for name, (so, log) in built.items():
        print(f"== nvcc {name}\n{log}", file=sys.stderr)
    emit("build", t0, libraries=[os.path.relpath(so, ROOT)
                                 for so, _ in built.values()],
         nvcc=build.find_nvcc())

    # ---- kernel_vs_plain -------------------------------------------------
    t0 = time.time()
    kw = dict(in_features=2, out_features=3, hidden_features=300,
              hidden_layers=2, first_omega0=7.0, hidden_omega0=7.0,
              scale=8.0)
    model = get_inr("wire", **kw)
    spec = model.spec
    n_full = 256 * 256
    cases = {}
    for name, n, nvalid, denom in (("full", n_full, None, None),
                                   ("ragged", 700, 650, 650 * 3.0 + 1.0)):
        params, coords, target, gt = inputs(torch, model, n, 1, dev)
        got = WS.wire_step(params, coords, target, spec, nvalid=nvalid,
                           denom=denom, gt=gt, want_metrics=True)
        torch.cuda.synchronize()
        want = WS.wire_step_plain(params, coords, target, spec,
                                  nvalid=nvalid, denom=denom, gt=gt,
                                  want_metrics=True)
        torch.cuda.synchronize()
        cases[name] = compare(tensors_of(*got), tensors_of(*want),
                              f"wire_step {name}")
    cfg_ct = get_config(CT_CONFIG)
    ct_model, _ = ct_models(get_inr, TCT, cfg_ct)
    errs = {"wire_step": cases}
    errs.update(ct_kernel_vs_plain(torch, WM, R, LS, ct_model, dev))
    cfg_a, cfg_b = get_config(REAL_DENOISE_CONFIG), get_config(
        REAL_SISR_CONFIG)
    model_a, _ = real_models(get_inr, TC, cfg_a, 7.0, 256)
    model_b, _ = real_models(get_inr, TC, cfg_b, 8.0, 168)
    errs.update(real_kernel_vs_plain(torch, RM, MM, model_a, model_b, dev))
    errs["real_step"].update(multiscale_fold_vs_plain(
        torch, RM, MM, get_inr, get_config, dev))
    ms_models = mscale2_models(get_inr, TC, get_config(MSCALE2_CONFIG))
    errs["mscale2_step"] = mscale2_kernel_vs_plain(torch, MS, MM, ms_models,
                                                   dev)
    errs["repaired"] = repaired_faults(torch, WM, R, ct_model, dev)
    emit("kernel_vs_plain", t0, max_abs_err=errs, rel_tol=REL_TOL,
         why=("max abs err <= rel_tol x max|plain| per output tensor: fp32 "
              "sums over up to 65,536 rows (wire_*, real_*), 256 rows "
              "(rotsum) taken in another order; line_sample's scatter adds "
              "with atomics in a varying order"))

    # ---- measure (bench shape; these launches are not the main path) ------
    t0 = time.time()
    params, coords, target, gt = inputs(torch, model, n_full, 2, dev)
    h = params["first"]["w"].shape[1]
    L = spec.hidden_layers
    scratch = WS.StepScratch()
    ms = cuda_ms(torch, lambda: WS.wire_step(
        params, coords, target, spec, gt=gt, want_metrics=True,
        scratch=scratch), iters=20)
    plain_ms = cuda_ms(torch, lambda: WS.wire_step_plain(
        params, coords, target, spec, gt=gt, want_metrics=True), iters=20)
    w = WS.stack_params(params, L)
    lib_out = matmul_step(torch, w, coords, target, gt, spec)
    lib_err = compare(
        tensors_of(lib_out[0], WS.unstack_grads(*lib_out[1:4], params, L),
                   lib_out[4]),
        tensors_of(*WS.wire_step_plain(params, coords, target, spec, gt=gt,
                                       want_metrics=True)),
        "matmul step vs plain")
    library_ms = cuda_ms(torch, lambda: matmul_step(
        torch, w, coords, target, gt, spec), iters=20)
    kernel_ms = kernel_device_ms(torch, lambda: WS.wire_step(
        params, coords, target, spec, gt=gt, want_metrics=True,
        scratch=scratch), 20, kernel_names("wire_step"))
    flops = WS.step_flops(n_full, 2, h, 3, L)
    nweights = num_weights(params)
    nbytes = 4 * (n_full * (2 + 3 + 3)          # coords, target, gt
                  + nweights                    # weights in
                  + n_full * 3 + nweights + 2)  # pred, grads, sse out
    bound_ms, bound_by = bound(flops, nbytes)
    del scratch, lib_out
    meas = {"wire_step": dict(
        ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
        library_vs_plain_max_abs_err=lib_err,
        achieved_tflops=flops / (ms * 1e9))}
    meas.update(ct_measure(torch, WM, R, LS, ct_model, dev))
    meas.update(real_measure(torch, RM, MM, model_a, model_b, dev))
    meas["mscale2_step"] = mscale2_measure(torch, MS, RM, MM, ms_models[0],
                                           dev)
    emit("measure", t0, kernels=meas, nvidia_smi=smi,
         pairs=("ms, plain_ms and library_ms of wire_mlp, rotsum, "
                "line_sample and real_mlp time the forward and its "
                "backward/adjoint together through autograd, as a call from "
                "the host; kernel_ms the device time of the kernels alone "
                "in those calls; fwd_ms the forward alone"))

    # ---- fit (the main path) ---------------------------------------------
    t0 = time.time()
    im, im_noisy, grid, model = bench.setup(256, 256)
    params = model.init(torch.Generator().manual_seed(0), dev)
    cfg = FitConfig(learning_rate=5e-3, niters=args.epochs,
                    maxpoints=n_full, scale_lr_by_batch=True)
    WS.wire_step.launches = 0
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3), cfg,
                        gt=im.reshape(-1, 3), device=dev)
    launches = WS.wire_step.launches
    if launches != args.epochs:
        raise AssertionError(f"wire_step launched {launches} times in a "
                             f"{args.epochs}-epoch fit, expected one per "
                             f"epoch")
    plain_model = get_inr("wire", fused="never", **kw)
    res_plain = fit_pointwise(plain_model, params, grid,
                              im_noisy.reshape(-1, 3), cfg,
                              gt=im.reshape(-1, 3), device=dev)
    if WS.wire_step.launches != launches:
        raise AssertionError("the plain fit launched the kernel")
    psnr = M.psnr_ref(im, res.best_rec.reshape(256, 256, 3))
    psnr_plain = M.psnr_ref(im, res_plain.best_rec.reshape(256, 256, 3))
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (n_full, 3)):
            raise AssertionError("fit produced non-finite values or a wrong "
                                 "shape")
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(f"kernel fit {psnr:.3f} dB vs plain fit "
                             f"{psnr_plain:.3f} dB differ by more than "
                             f"{PSNR_AGREE_DB} dB")
    floor = PSNR_FLOORS_DB.get(args.epochs)
    if floor is not None and not psnr >= floor:
        raise AssertionError(f"kernel fit best PSNR {psnr:.3f} dB below the "
                             f"floor {floor} dB")
    emit("fit", t0, epochs=args.epochs, launches=launches,
         psnr_db=psnr, psnr_plain_db=psnr_plain, floor_db=floor,
         ms_per_step=res.step_ms, plain_ms_per_step=res_plain.step_ms,
         coords_per_s=n_full / (res.step_ms * 1e-3),
         fit_wall_s=res.wall_time_s, plain_fit_wall_s=res_plain.wall_time_s)

    # ---- fit_ct (the CT path) ---------------------------------------------
    t0 = time.time()
    ct = fit_ct(torch, np, (WM, R, LS, TR, TCT, M, get_inr, get_config,
                            FitConfig, fit_operator), dev)
    emit("fit_ct", t0, methods=ct)

    # ---- fit_real (B-spline denoise, path A) -------------------------------
    t0 = time.time()
    counters = {"wire_mlp": WM.launches, "rotsum": R.launches,
                "line_sample": LS.launches, "real_mlp": RM.launches,
                "mscale2_step": MS.launches}
    ws_before = WS.wire_step.launches
    real = fit_real(torch, np, (TD, TC, M, RM, get_inr, get_config,
                                FitConfig, fit_pointwise), counters, dev)
    emit("fit_real", t0, **real)

    # ---- fit_sisr (B-spline SISR, path B) ----------------------------------
    t0 = time.time()
    sisr = fit_sisr(torch, np, (TS, TC, TF, M, get_inr, get_config,
                                FitConfig, fit_operator), counters, dev)
    emit("fit_sisr", t0, **sisr)

    # ---- fit_mscale2 (mscale_2 denoise) ------------------------------------
    t0 = time.time()
    mscale = fit_mscale2(torch, np, (TD, TC, M, get_inr, get_config,
                                     FitConfig, fit_pointwise), counters, dev)
    if WS.wire_step.launches != ws_before:
        raise AssertionError("the B-spline fits launched wire_step")
    emit("fit_mscale2", t0, **mscale)

    # launches of each kernel in the path that runs it: wire_step in the
    # WIRE denoise fit, wire_mlp in both CT fits, line_sample in 'auto'
    # (fourier), rotsum in 'rotate', real_step in the B-spline denoise fit,
    # real_mlp in the B-spline SISR fit, mscale2_step in the mscale_2
    # denoise fit; a pair counts both directions
    path_launches = {
        "wire_step": {"step": launches},
        "wire_mlp": {k: ct["auto"]["launches"]["wire_mlp"][k]
                     + ct["rotate"]["launches"]["wire_mlp"][k]
                     for k in WM.launches},
        "line_sample": ct["auto"]["launches"]["line_sample"],
        "rotsum": ct["rotate"]["launches"]["rotsum"],
        "real_step": {"step": real["launches"]["step"]},
        "real_mlp": {k: sisr["launches"][k]
                     for k in ("forward", "backward")},
        "mscale2_step": {"step": mscale["launches"]["step"]}}
    print(smi)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"wire_tpu_torch/csrc/{lib}.cu",
        "replaces": replaces,
        "launches": sum(path_launches[name].values()),
        "launches_by_direction": path_launches[name],
        "max_abs_err": errs[name]["full"], "ms": meas[name]["ms"],
        "kernel_ms": meas[name]["kernel_ms"],
        "plain_ms": meas[name]["plain_ms"],
        "bound_ms": meas[name]["bound_ms"],
        "bound_by": meas[name]["bound_by"],
        "library_ms": meas[name]["library_ms"]}
        for name, (lib, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
