#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wire_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # 300-epoch / 300-iteration fits,
                                       # floors from wire_tpu on the CPU
    python3 chip_smoke.py --epochs 2000   # the full denoise bench protocol,
                                          # 25 dB floor

It drives nine paths of the port: WIRE-300 denoise through fit_pointwise
(kernel: wire_step), WIRE-300 CT reconstruction through fit_operator
(kernels: wire_mlp, and line_sample for the 'auto' = fourier method or
rotsum for 'rotate'), B-spline denoise through fit_pointwise (preset
Bspline_s9_5_LR8e3_E4000; kernel: real_step), B-spline SISR through
fit_operator (preset Bspline_s9_LR1e3_E2000; kernel: real_mlp's pair),
mscale_2 denoise through fit_pointwise (preset Mscale2_ST8_3_LR8e3_E4000;
kernel: mscale2_step), the sweep app's MFN denoise (kernel: mfn_step)
and MFN SISR (kernel: mfn_mlp's pair), and WIRE-2D (300 wide) denoise
through fit_pointwise (kernel: wire2d_step) and CT through fit_operator
(kernels: wire2d_mlp's pair, line_sample); then the sweep app itself
(wire_tpu_torch.apps.sweep), every task for each of its six families.
Phases, each printing one JSON line with its wall time:
  device           card name and count, nvidia-smi's name and power limit;
                   TF32 off for matmuls and cuDNN
  build            nvcc builds every kernel library from csrc/, all at once
  kernel_vs_plain  each kernel against its plain PyTorch version at its
                   path's full shape, plus a ragged case (line_sample
                   also at an odd P, 729); wire_step at
                   h 5, 13, 150, 212, L 1-3, o 1 and 3, n 700 and 65,537
                   with nvalid and denom; mscale2_step at ns 2 and 3 where
                   128-row tiles straddle two scales (n 700, 65,537), held
                   to its plain version run in float64; two
                   calls of each bit-equal; wire_mlp, real_mlp, mfn_mlp and
                   wire2d_mlp on a transposed coordinate view, equal to the
                   contiguous call bit for bit (fault C.7); real_mlp's
                   every basis kind, lane segments and row_gamma; real_step
                   at the mscale_hier and mscale_HL folds; each real case
                   held to the reference tools/port_real_reference.py
                   decided (REAL_FLOAT64_CASES), two calls of the real
                   step and pair bit-equal; wire_mlp
                   on (b, N, 2) coordinates and without a gradient (equal
                   output, peak memory of two ping-pong planes); rotsum on
                   a non-square image; mfn_mlp without dcoords, on (b, N, 2)
                   coordinates, without a gradient and at the extreme phase
                   |x w| ~ 8,000; two calls of each MFN kernel bit-equal;
                   then every kernel the sweep phase launches, for each
                   family and task at the sweep's own shapes (CT: 262,144
                   rows; mfn's CT pair with dcoords too); wire2d_step at
                   the denoise shape and ragged (L 1 and 3), wire2d_mlp at
                   the CT shape, with dcoords at the denoise shape, on
                   (4, 50, 2) coordinates and without a gradient; both
                   at h 5, 13, 150, 152, 256, L 0-3, o 1 and 3, n 700 and
                   65,537 (the step with nvalid and denom, the pair with
                   dcoords), and the pair at h 5, L 3 at the CT frequencies
                   held to its plain version run in float64; two calls of
                   each WIRE-2D kernel bit-equal
  measure          kernel (as a host call, and its kernels' device time
                   from torch.profiler), plain and library times at those
                   shapes, and the card's least time for the same work;
                   for the tensor-core kernels (every one but rotsum
                   and line_sample) the kernel time by product
                   class, the 3xTF32 bound beside the fp32 one, and the
                   HMMA instructions of the library; real_step at the
                   sweep's siren cell, whose sine bases the epilogues call
                   out of line; the whole fourier operator's vjp at the CT
                   shape with its device launches in order (not gated)
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
  fit_mfn          the sweep's MFN denoise (300 wide, 256 x 256, 65,536
                   coordinates, full batch) for 300 epochs, likewise
  fit_mfn_sisr     the sweep's MFN SISR (256 wide, 256 x 256 HR, x4 box
                   downsample) for 300 iterations, likewise
  fit_wire2d       WIRE-2D denoise at the bench protocol (256 x 256, 65,536
                   coordinates, full batch, omega0 7, sigma 8) for 300
                   epochs, likewise
  fit_wire2d_ct    WIRE-2D CT at the CT protocol ('auto' = fourier, omega0
                   3, sigma 12) for 300 iterations, likewise, and a render
                   of the best parameters without a gradient
  sweep            sweep_denoise, sweep_sisr and sweep_ct at the sweep's
                   sizes, one family per call for 20 iterations: each
                   call launches its family's kernels and no other
Then the nvidia-smi line, a ``kernels`` JSON line, and last, on success only,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit);
without a CUDA device it exits non-zero before any phase.  It imports
nothing of JAX or wire_tpu.
"""
import argparse
import faulthandler
import json
import numbers
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

# Best PSNR of the 300-epoch MFN denoise fit and best -10 log10(MSE) of the
# 300-iteration MFN SISR fit from wire_tpu on the CPU (fused="never",
# float32, the sweep app's problems, this script's seed-0 init moved across
# with wire_tpu_torch.bridge), as printed by tools/port_mfn_floor.py; the
# kernel fits must reach them less 0.2 dB, and agree with the plain fits
# within PSNR_AGREE_DB.
WIRE_TPU_300_MFN_DB = {"denoise": 22.19007110595703,
                       "sisr": 18.832611964689864}
MFN_ITERS = 300

# Best PSNR of the 300-epoch WIRE-2D denoise fit and of the 300-iteration
# WIRE-2D CT fit (fourier, the card's 'auto') from wire_tpu on the CPU
# (fused="never", float32, this script's seed-0 init moved across with
# wire_tpu_torch.bridge), as printed by tools/port_wire2d_floor.py; the
# kernel fits must reach them less 0.2 dB, and agree with the plain fits
# within PSNR_AGREE_DB.
WIRE_TPU_300_WIRE2D_DB = {"denoise": 21.629484176635742,
                          "ct": 26.968250274658203}
WIRE2D_ITERS = 300
# WIRE-2D at the width of tools/exp_width256.py's headline configuration
# (300 hidden features: 150 complex units per head, 2 hidden layers) with
# the denoise bench's frequencies; the CT path takes CT_CONFIG's
WIRE2D_DENOISE_KW = dict(in_features=2, out_features=3, hidden_features=300,
                         hidden_layers=2, first_omega0=7.0, hidden_omega0=7.0,
                         scale=8.0)
# iterations of each family's fit in the sweep phase
SWEEP_ITERS = 20

# H100 SXM published peaks (NVIDIA data sheet), at the 700 W power limit.
H100_FP32_TFLOPS = 67.0
H100_TF32_TFLOPS = 495.0   # dense, tensor cores
H100_HBM_TBPS = 3.35

KERNEL_LIBRARIES = ("wire_step", "wire_mlp", "rotsum", "line_sample",
                    "real_mlp", "mscale2_step", "mfn", "wire2d")
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
    "mfn_step": ("mfn", "wire_tpu/ops/pallas/mfn_step.py:421"),
    "mfn_mlp": ("mfn", "wire_tpu/ops/pallas/mfn_step.py:290"),
    "wire2d_step": ("wire2d", "wire_tpu/ops/pallas/wire2d_step.py:305"),
    "wire2d_mlp": ("wire2d", "wire_tpu/ops/pallas/wire2d_step.py:549"),
}

# Kernel vs plain: max abs error <= REL_TOL * max |plain| per output tensor.
# Both sum fp32 products over up to 262,144 rows in different orders (tiles
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


def float64_tree(x):
    """``x`` with every floating tensor and every float in it, through
    dicts, lists and tuples, cast to float64 (the inverse scales too);
    strings, ints and None as they are."""
    if isinstance(x, dict):
        return {k: float64_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(float64_tree(v) for v in x)
    if hasattr(x, "is_floating_point"):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, numbers.Real) and not isinstance(x, numbers.Integral):
        return float(x)
    return x


def compare_float64(got, plain, args, kwargs, what):
    """Holds the kernel's outputs ``got`` ({name: tensor}) to ``plain(*args,
    **kwargs)`` run in float64 (float64_tree of every input), with
    compare(): the reference of mscale2_step and of the wire2d_mlp
    CT-frequency width case, whose fp32 plain versions lie near or past
    REL_TOL x max from their own float64 runs (combiner relu units within
    rounding of 0; differences of near-equal blocks).  Returns (max abs
    err, the float64 outputs)."""
    want = plain(*float64_tree(args), **float64_tree(kwargs))
    for name, w in want.items():
        if str(w.dtype) != "torch.float64":
            raise AssertionError(f"{what}: the float64 reference's {name} "
                                 f"is {w.dtype}")
    return compare(got, want, what), want


def rel_distance(got, want):
    """max over the outputs of max |got - want| / max |want|."""
    return max(float((got[k].double() - want[k].double()).abs().max())
               / max(float(want[k].double().abs().max()), 1e-300)
               for k in want)


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


def wire2d_matmul_vjp(torch, W2, params, coords, spec, cotangent,
                      want_dcoords=False):
    """The WIRE-2D forward and backward as torch.matmul calls on the
    stacked layout (ops/wire2d.py:stack_params) with the Gabor-2D backward
    written out (wire2d_step.py:189-198), for the output cotangent
    ``cotangent(y)``: the library yardstick (not used by the port).
    Returns (y, dparams, dcoords or None)."""
    L = spec.hidden_layers
    w = W2.stack_params(params, L)
    h = w["w1"].shape[1] // 2
    s2 = spec.scale ** 2
    om, om1 = spec.hidden_omega0, spec.first_omega0

    def gabor(lr, li, orr, oi, omega):
        m = torch.exp(-omega * li - s2 * (lr * lr + li * li + orr * orr
                                          + oi * oi))
        return torch.cat([m * torch.cos(omega * lr),
                          m * torch.sin(omega * lr)], 1)

    def t12(da, a):
        dar, dai, ar, ai = da[:, :h], da[:, h:], a[:, :h], a[:, h:]
        return dar * ar + dai * ai, dai * ar - dar * ai

    z1 = torch.addmm(w["b1"], coords, w["w1"])
    lr1, or1 = z1[:, :h], z1[:, h:]
    acts, zs = [gabor(lr1, 0.0, or1, 0.0, om1)], []
    for l in range(L):
        z = torch.addmm(w["B2"][l], acts[-1], w["W2"][l])
        zs.append(z)
        acts.append(gabor(*z.split(h, 1), om))
    y = torch.addmm(w["fb"], acts[-1], w["fW"])
    g = cotangent(y)
    gfW = torch.cat([acts[-1].t() @ g, g.sum(0, keepdim=True)])
    da = g @ w["fWT"]
    gW2 = [None] * L
    for l in reversed(range(L)):
        t1, t2 = t12(da, acts[l + 1])
        lr, li, orr, oi = zs[l].split(h, 1)
        dz = torch.cat([-2.0 * s2 * lr * t1 + om * t2,
                        (-om - 2.0 * s2 * li) * t1, -2.0 * s2 * orr * t1,
                        -2.0 * s2 * oi * t1], 1)
        gW2[l] = torch.cat([acts[l].t() @ dz, dz.sum(0, keepdim=True)])
        da = dz @ w["W2T"][l]
    t1, t2 = t12(da, acts[0])
    dz1 = torch.cat([-2.0 * s2 * lr1 * t1 + om1 * t2, -2.0 * s2 * or1 * t1],
                    1)
    gw1 = torch.cat([coords.t() @ dz1, dz1.sum(0, keepdim=True)])
    gW2 = torch.stack(gW2) if L else y.new_empty((0, 2 * h + 1, 4 * h))
    dparams = W2.unstack_grads(gw1, gW2, gfW, params["final"]["bi"], L)
    return y, dparams, (dz1 @ w["w1"].t() if want_dcoords else None)


def wire2d_matmul_step(torch, W2, params, coords, target, gt, spec):
    """The masked-MSE train step through ``wire2d_matmul_vjp``: (pred,
    dparams, (sse_target, sse_gt))."""
    n, o = target.shape
    y, dparams, _ = wire2d_matmul_vjp(
        torch, W2, params, coords, spec,
        lambda y: (2.0 / (n * o)) * (y - target))
    et, eg = y - target, y - gt
    return y, dparams, ((et * et).sum(), (eg * eg).sum())


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


def pair_fn(apply, spec, paths):
    """(coords, *leaves) -> apply(params, coords, spec), ``params`` the tree
    of ``leaves`` at ``paths``: a pair (the kernels or the plain version)
    as a function of its leaves, for vjp()."""
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


def bound(flops, nbytes):
    """(least ms, what bounds it) at the card's fp32 and HBM peaks."""
    ops_ms = flops / (H100_FP32_TFLOPS * 1e9)
    bytes_ms = nbytes / (H100_HBM_TBPS * 1e9)
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def bound_3xtf32(flops, nbytes):
    """(least ms, what bounds it) for fp32 products formed as three TF32
    tensor-core products each (wire_mlp's hidden layers, csrc/wire_tc.cuh),
    at the card's dense TF32 and HBM peaks."""
    ops_ms = 3 * flops / (H100_TF32_TFLOPS * 1e9)
    bytes_ms = nbytes / (H100_HBM_TBPS * 1e9)
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def sass_hmma(torch, build, name):
    """HMMA instructions in the SASS of csrc/<name>.cu's built library
    (cuobjdump -sass), or "not checked" where the toolkit has no
    cuobjdump."""
    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        return "not checked"
    sass = subprocess.run([cuobjdump, "-sass", build.library_path(name)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return sass.count("HMMA")


def kernel_breakdown(torch, fn, iters):
    """{device kernel name: [ms per call, launches per call]} of every
    device kernel ``fn`` launches (torch.profiler, device-side events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: [e.device_time_total / 1e3 / iters, e.count / iters]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


# the device kernels by product class of the libraries whose hidden-layer
# products run on the tensor cores: name fragments (csrc/wire_tc.cuh,
# wire_gemm.cuh, gemm_common.cuh and the libraries' own kernels)
WIRE_WEIGHT_GRADIENTS = ("tc_wgrad_kernel", "narrow_wgrad_kernel",
                         "narrow_colsum_kernel", "reduce_chunks_kernel")
TENSOR_CORE_CLASSES = {
    "wire_mlp": {
        "forward_gemms": ("tc_paired_kernel<0",),
        "data_gradient_gemms": ("tc_paired_kernel<1", "tc_paired_kernel<2"),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "first_final_dcoords": ("first_forward_kernel",
                                "final_forward_kernel", "dcoords_kernel"),
    },
    "wire_step": {
        "forward_gemms": ("tc_paired_kernel<0",),
        "data_gradient_gemms": ("tc_paired_kernel<1", "tc_paired_kernel<2"),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "first_final_loss": ("first_forward_kernel", "final_loss_kernel"),
    },
    "mscale2_step": {
        "forward_gemms": ("real_tc_kernel<0",),
        "data_gradient_gemms": ("real_tc_kernel<1",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS + ("colsum_partial_kernel",),
        "first_top_final_combiner": ("real_narrow_kernel",
                                     "final_forward_kernel",
                                     "combiner_kernel"),
    },
    "mfn_step": {
        "forward_gemms": ("mfn_tc_kernel<0",),
        "data_gradient_gemms": ("mfn_tc_kernel<1", "mfn_tc_kernel<2",
                                "mfn_narrow_kernel"),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "filter_gradients": ("filter_grad_partial_kernel",
                             "filter_grad_finish_kernel"),
        "first_final_loss": ("filter_forward_kernel", "final_loss_kernel"),
    },
    "mfn_mlp": {
        "forward_gemms": ("mfn_tc_kernel<0",),
        "data_gradient_gemms": ("mfn_tc_kernel<1", "mfn_tc_kernel<2",
                                "mfn_narrow_kernel"),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "filter_gradients_dcoords": ("filter_grad_partial_kernel",
                                     "filter_grad_finish_kernel",
                                     "filter_dcoords_kernel"),
        "first_final": ("filter_forward_kernel", "final_forward_kernel"),
    },
    "wire2d_step": {
        "forward_gemms": ("gabor2d_tc_fwd_kernel",),
        "data_gradient_gemms": ("gabor2d_tc_bwd_kernel",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "first_final_loss": ("gabor2d_first_kernel", "final_loss_kernel"),
    },
    "real_step": {
        "forward_gemms": ("real_tc_kernel<0",),
        "data_gradient_gemms": ("real_tc_kernel<1",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS + ("colsum_partial_kernel",),
        "first_top_final_loss": ("real_narrow_kernel", "final_loss_kernel"),
    },
    "real_mlp": {
        "forward_gemms": ("real_tc_kernel<0",),
        "data_gradient_gemms": ("real_tc_kernel<1",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS + ("colsum_partial_kernel",),
        "first_top_final_dcoords": ("real_narrow_kernel",
                                    "final_forward_kernel", "dcoords_kernel"),
    },
    "wire2d_mlp": {
        "forward_gemms": ("gabor2d_tc_fwd_kernel",),
        "data_gradient_gemms": ("gabor2d_tc_bwd_kernel",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "first_final_dcoords": ("gabor2d_first_kernel",
                                "final_forward_kernel",
                                "gabor2d_dcoords_kernel"),
    },
}


def tensor_core_fields(torch, build, fn, name, flops, nbytes, kernel_ms,
                       lib=None):
    """The measure fields of kernel ``name`` (of library ``lib``, default
    ``name``) whose hidden-layer products are 3xTF32 tensor-core products:
    its device kernels and their time by product class
    (TENSOR_CORE_CLASSES), the 3xTF32 bound as bound_ms with the fp32
    CUDA-core bound beside it, the shares of both in kernel_ms, and the HMMA
    instructions of its library."""
    by = kernel_breakdown(torch, fn, 20)
    res = {"device_kernels": {k[:120]: v for k, v in by.items()},
           "device_kernels_per_call": sum(v[1] for v in by.values()),
           "classes_ms": {
               cls: sum(v[0] for k, v in by.items()
                        if any(f in k for f in frags))
               for cls, frags in TENSOR_CORE_CLASSES[name].items()}}
    res["bound_fp32_ms"] = bound(flops, nbytes)[0]
    res["bound_ms"], res["bound_by"] = bound_3xtf32(flops, nbytes)
    res["bound_3xtf32_ms"] = res["bound_ms"]
    if kernel_ms:
        res["share_of_fp32_bound"] = res["bound_fp32_ms"] / kernel_ms
        res["share_of_3xtf32_bound"] = res["bound_3xtf32_ms"] / kernel_ms
    res["sass_hmma"] = sass_hmma(torch, build, lib or name)
    return res


def line_sample_bytes(torch, gy, gx, p):
    """Bytes the spectrum gather + scatter pair must move at positions
    (gy, gx) on a (p, p) spectrum: the distinct taps of the unshifted
    spectrum and of the centring table its stencils read (the halo wrapped;
    the scatter reads the table's again, counted once), 8 bytes each; the
    positions and the un-centring phase; the slice out and its cotangent
    in, 8 bytes a sample each; and the (p, p) complex gradient out."""
    y0, x0 = torch.floor(gy).long(), torch.floor(gx).long()
    taps = torch.cat([(((y0 + dy) % p) * p + (x0 + dx) % p).ravel()
                      for dy in (0, 1) for dx in (0, 1)])
    ntaps = int(torch.unique(taps).numel())
    A, K = gy.shape
    return 8 * 2 * ntaps + 4 * 2 * A * K + 8 * K + 8 * 2 * A * K + 8 * p * p


def kernel_names(name, csrc=None):
    """The __global__ functions of csrc/<name>.cu and of the csrc headers
    it includes, directly or through another header (``csrc``: another
    tree's source directory)."""
    import re
    csrc = csrc or os.path.join(ROOT, "wire_tpu_torch", "csrc")
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
    (S, S) image x A angles, line_sample on a (P, P) spectrum at A angles
    over [0, 180] and K = P // 2 + 1 frequencies."""
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
        pair_fn(WM.wire_mlp, spec, keys),
        pair_fn(WM.wire_mlp_plain, spec, keys),
        None, [coords] + [t for _, t in tree_leaves(params)], g)}

    angles = np.linspace(0, 180, A, dtype=np.float32)
    grids = rot_grids(torch, S, angles, device)
    # the angle parts on the device, as operators/radon.py:RadonOp keeps them
    parts = R.angle_parts_tensor(angles, True, device)
    cases["rotsum"] = (
        lambda x: R.rotate_project(x, angles, parts=parts),
        lambda x: R.rotate_project_plain(x, angles),
        lambda x: F.grid_sample(x[None, None].expand(A, 1, S, S), grids,
                                align_corners=True)[:, 0].sum(-2),
        [t(rng.random((S, S)))], t(rng.normal(size=(A, S))))

    # the spectrum gather/scatter pair on a random unshifted (P, P)
    # spectrum with operators/radon.py's tables, as a function of its
    # (P, P, 2) real view; the library call is the plain version's
    # composition with F.grid_sample in the place of the sampler
    from wire_tpu_torch.operators import radon as TR
    centre, gy, gx, uncentre = TR._fourier_consts(P, angles, device)
    ph = P + 2
    grid = torch.stack([2 * gx / (ph - 1) - 1, 2 * gy / (ph - 1) - 1],
                       -1)[None]

    def spectrum_fn(sample):
        def fn(x):
            return torch.view_as_real(sample(torch.view_as_complex(x),
                                             centre, gy, gx, uncentre))
        return fn

    def line_library(z):
        Fs = torch.fft.fftshift(z) * centre
        Fh = torch.cat([Fs, Fs[:2]], 0)
        Fh = torch.cat([Fh, Fh[:, :2]], 1)
        out = F.grid_sample(torch.stack([Fh.real, Fh.imag])[None], grid,
                            align_corners=True)
        return torch.complex(out[0, 0], out[0, 1]) * uncentre

    cases["line_sample"] = (
        spectrum_fn(LS.sample_spectrum), spectrum_fn(LS.sample_spectrum_plain),
        spectrum_fn(lambda z, *tables: line_library(z)),
        [t(rng.normal(size=(P, P, 2)))], t(rng.normal(size=(A, K, 2))))
    return cases, params, keys


def ct_kernel_vs_plain(torch, WM, R, LS, model, device):
    """max abs err per kernel at the CT shape ("full") and a ragged one;
    line_sample also at an odd P (729, a 168^2 image)."""
    shapes = {"full": dict(n=256 * 256, S=256, A=100, P=1024, K=513),
              "ragged": dict(n=700, S=96, A=13, P=384, K=193),
              "odd": dict(n=700, S=96, A=100, P=729, K=365)}
    errs = {name: {} for name in ("wire_mlp", "rotsum", "line_sample")}
    for which, shape in shapes.items():
        cases, _, _ = ct_kernel_cases(torch, WM, R, LS, model, seed=3,
                                      device=device, **shape)
        for name, (kfn, pfn, _, xs, cot) in cases.items():
            if which == "odd" and name != "line_sample":
                continue
            got = vjp(torch, kfn, xs, cot)
            torch.cuda.synchronize()
            if name == "wire_mlp":
                same_bits(torch, vjp(torch, kfn, xs, cot), got,
                          f"wire_mlp {which}")
            want = vjp(torch, pfn, xs, cot)
            torch.cuda.synchronize()
            errs[name][which] = compare(got, want, f"{name} {which}")
    return errs


# wire_mlp at widths, depths and outputs besides the CT path's, as
# (hidden_features, complex units h, L, o): h = 5 and 13 give a K (2h) that
# is not a multiple of 4 or of the tile, 150 a unit count that is not a
# multiple of 4; and the extreme-phase case, CT's width with omega0 3,
# sigma 1 and the hidden weights doubled (Gabor phases up to ~30 rad, where
# fp32 itself is ~1e-5 x max from float64)
WIRE_MLP_WIDTHS = ((8, 5, 0, 3), (8, 5, 3, 1), (19, 13, 1, 3),
                   (213, 150, 2, 1), (300, 212, 3, 3))


def wire_mlp_widths(torch, WM, get_inr, device):
    """wire_mlp against its plain version, with dcoords, at n = 700 for
    each of WIRE_MLP_WIDTHS, and at the extreme phase at n = 4,096."""
    import numpy as np
    errs = {}
    cases = [(hf, L, o, 700, 3.0, 12.0, 1.0, f"h{h} L{L} o{o}")
             for hf, h, L, o in WIRE_MLP_WIDTHS]
    cases.append((300, 2, 1, 4096, 3.0, 1.0, 2.0, "extreme_phase"))
    for hf, L, o, n, omega, scale, wscale, what in cases:
        model = get_inr("wire", in_features=2, out_features=o,
                        hidden_features=hf, hidden_layers=L,
                        first_omega0=omega, hidden_omega0=omega,
                        scale=scale)
        params = model.init(torch.Generator().manual_seed(n + L), device)
        for k in params:
            if k.startswith("hidden"):
                for kk in ("wr", "wi"):
                    params[k][kk] = params[k][kk] * wscale
        rng = np.random.default_rng(n + L)
        c = torch.tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                         device=device)
        g = torch.tensor(rng.normal(size=(n, o)).astype(np.float32),
                         device=device)
        keys = leaf_paths(params)
        xs = [c] + [t for _, t in tree_leaves(params)]
        got = vjp(torch, pair_fn(WM.wire_mlp, model.spec, keys), xs, g)
        torch.cuda.synchronize()
        want = vjp(torch, pair_fn(WM.wire_mlp_plain, model.spec, keys), xs,
                   g)
        errs[what] = compare(got, want, f"wire_mlp {what}")
    return errs


# wire_step at widths, depths, outputs and row counts besides the main
# path's, as (hidden_features, complex units h, L, o, n, nvalid, denom):
# K = 2h of 10, 26, 300 and 424, against the 32-deep slices and 32-unit
# tiles; n 700 and 65,537 against the 128-row tiles and the weight
# gradients' 512- and 1,024-row chunks
WIRE_STEP_WIDTHS = ((8, 5, 1, 3, 700, 650, 1951.0),
                    (8, 5, 3, 1, 700, None, None),
                    (19, 13, 2, 3, 700, 600, None),
                    (213, 150, 1, 1, 700, None, 777.0),
                    (213, 150, 3, 3, 700, 650, None),
                    (300, 212, 3, 1, 700, None, None),
                    (300, 212, 2, 3, 65537, 65000, None),
                    (19, 13, 1, 1, 65537, None, 70000.0))


def wire_step_widths(torch, WS, get_inr, device):
    """wire_step against its plain version at each of WIRE_STEP_WIDTHS
    (denoise frequencies, the tail masked by nvalid, denom), two calls
    bit-equal."""
    errs = {}
    for hf, h, L, o, n, nvalid, denom in WIRE_STEP_WIDTHS:
        what = f"h{h} L{L} o{o} n{n}"
        model = get_inr("wire", in_features=2, out_features=o,
                        hidden_features=hf, hidden_layers=L,
                        first_omega0=7.0, hidden_omega0=7.0, scale=8.0)
        params, coords, target, gt = inputs(torch, model, n, n + hf + L,
                                            device)
        got, again = (tensors_of(*WS.wire_step(
            params, coords, target, model.spec, nvalid=nvalid, denom=denom,
            gt=gt, want_metrics=True)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, again, got, f"wire_step {what}")
        want = WS.wire_step_plain(params, coords, target, model.spec,
                                  nvalid=nvalid, denom=denom, gt=gt,
                                  want_metrics=True)
        errs[what] = compare(got, tensors_of(*want), f"wire_step {what}")
    return errs


def strided_coords(torch, WM, RM, MF, W2, get_inr, ct_model, device):
    """Fault C.7, repaired: each CUDA MLP pair on a transposed (n, d) view
    of a (d, n) array gives the contiguous call's output and gradients bit
    for bit, and without a gradient its output; wire_mlp at the CT model,
    real_mlp at the B-spline trunk's widths, mfn_mlp at the MFN SISR width,
    wire2d_mlp at the WIRE-2D width.  Returns the max abs difference per
    pair (0)."""
    import numpy as np
    n = 4096
    rng = np.random.default_rng(40)
    strided = torch.tensor(rng.uniform(-1, 1, (2, n)).astype(np.float32),
                           device=device).t()
    if strided.is_contiguous():
        raise AssertionError("C.7: the coordinate view is contiguous")
    mfn = get_inr("mfn", in_features=2, out_features=3, hidden_features=256,
                  hidden_layers=2)
    w2d = get_inr("wire2d", **WIRE2D_DENOISE_KW)
    kinds = ("qspline",) * 3
    cases = {
        "wire_mlp": (WM.wire_mlp, ct_model),
        "real_mlp": (lambda p, x, spec: RM.real_mlp(p, x, kinds), None),
        "mfn_mlp": (MF.mfn_mlp, mfn),
        "wire2d_mlp": (W2.wire2d_mlp, w2d)}
    errs = {}
    for name, (apply, model) in cases.items():
        if model is None:
            spec, params = None, random_canon(torch, (2, 256, 256, 256, 3),
                                              41, device)
        else:
            spec = model.spec
            params = model.init(torch.Generator().manual_seed(42), device)
        paths = leaf_paths(params)
        leaves = [t for _, t in tree_leaves(params)]
        fn = pair_fn(apply, spec, paths)
        with torch.no_grad():
            o = fn(strided.contiguous(), *leaves).shape[-1]
        g = torch.tensor(rng.normal(size=(n, o)).astype(np.float32),
                         device=device)
        got = vjp(torch, fn, [strided] + leaves, g)
        want = vjp(torch, fn, [strided.contiguous()] + leaves, g)
        same_bits(torch, got, want, f"C.7 {name} on a transposed view")
        with torch.no_grad():
            if not torch.equal(fn(strided, *leaves), want["out"]):
                raise AssertionError(f"C.7 {name} without a gradient: the "
                                     f"transposed view's output differs")
        errs[f"C7_{name}_strided"] = max(
            float((got[k] - want[k]).abs().max()) for k in want)
    return errs


def fourier_operator(torch, device, iters=20):
    """The vjp of radon(img, angles, method="fourier") at the CT shape (a
    256^2 image, 100 angles; P 1,024): ms per call (CUDA events), the
    device kernels and memsets a call launches by name with their ms and
    count (torch.profiler), their sum, and the names in the order one call
    ran them (forward, then backward).  Not gated: the yardstick of what the
    operator around the line_sample pair costs."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from wire_tpu_torch.operators import radon as TR
    rng = np.random.default_rng(5)
    angles = np.linspace(0, 180, 100, dtype=np.float32)
    img, cot = (torch.tensor(a.astype(np.float32), device=device) for a in (
        rng.random((256, 256)), rng.normal(size=(100, 256))))

    def call():
        return vjp(torch, lambda x: TR.radon(x, angles, method="fourier"),
                   [img], cot)
    by = kernel_breakdown(torch, call, iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    order = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda e: e.time_range.start)
    return {"fourier_operator_ms": cuda_ms(torch, call, iters),
            "fourier_operator_launches": sum(v[1] for v in by.values()),
            "fourier_operator_kernels": {k[:120]: v for k, v in by.items()},
            "fourier_operator_order": [e.name[:80] for e in order]}


def ct_measure(torch, WM, R, LS, model, device, build):
    """Times at the CT shape of each kernel's forward + backward pair (and
    of its forward alone), its plain version's pair and a library call's
    pair, with the card's least time for the pair; for wire_mlp its kernel
    time by product class, its fp32 CUDA-core and 3xTF32 tensor-core bounds
    and the HMMA instructions of its library; for rotsum the forward and
    adjoint kernel times and the device kernels a call launches; for
    line_sample the whole fourier operator's vjp (fourier_operator)."""
    import numpy as np
    n, S, A, P, K = 256 * 256, 256, 100, 1024, 513
    cases, params, keys = ct_kernel_cases(torch, WM, R, LS, model, n, S, A,
                                          P, K, seed=4, device=device)
    spec = model.spec
    L, h = spec.hidden_layers, params["first"]["w"].shape[1]
    d, o = spec.in_features, spec.out_features
    nweights = num_weights(params)
    from wire_tpu_torch.operators import radon as TR
    _, gy, gx, _ = TR._fourier_consts(
        P, np.linspace(0, 180, A, dtype=np.float32), device)
    work = {
        "wire_mlp": (WM.apply_flops(n, d, h, o, L),
                     4 * (2 * (n * d + n * o + nweights))),
        "rotsum": (2 * R.sample_flops(A, S), 4 * 2 * (S * S + A * S)),
        "line_sample": (2 * LS.sample_flops(A, K),
                        line_sample_bytes(torch, gy, gx, P)),
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
        if name == "wire_mlp":
            res.update(tensor_core_fields(
                torch, build, lambda: vjp(torch, kfn, xs, cot), name,
                *work[name], res["kernel_ms"]))
        if name == "rotsum":
            by = kernel_breakdown(torch, lambda: vjp(torch, kfn, xs, cot), 20)
            res["device_kernels"] = {k[:120]: v for k, v in by.items()}
            res["device_kernels_per_call"] = sum(v[1] for v in by.values())
            res["forward_kernel_ms"] = sum(
                v[0] for k, v in by.items() if "rotsum_forward_kernel" in k)
            res["adjoint_kernel_ms"] = sum(
                v[0] for k, v in by.items() if "rotsum_adjoint_kernel" in k)
        if name == "line_sample":
            res.update(fourier_operator(torch, device))
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


# the real cases held to their plain version run in float64, as
# tools/port_real_reference.py decides them (PERF.md section 6): where the
# fp32 plain run lies past 2.5e-5 x max of its own float64 run; every
# other real case keeps the fp32 plain version
REAL_FLOAT64_CASES = frozenset({
    "sweep denoise posenc", "sweep sisr relu", "sweep sisr posenc",
    "sweep ct relu", "sweep ct posenc"})
# of those, the relu pairs whose fp32 plain run lies past REL_TOL x max of
# the float64 run itself (1.5e-3 - 3.8e-3 on the card, fault C.9): a few
# of their 50 - 200 million relu inputs lie within fp32 rounding of 0, and
# each one decided the other way moves a parameter gradient, a sum of
# random-signed terms over 65,536 - 262,144 rows, by ~1 / sqrt(rows) of its
# size.  No fp32 evaluation meets REL_TOL there; the kernel is held to the
# float64 run on its own relu pattern (relu_pattern_reference)
REAL_RELU_PATTERN_CASES = frozenset({
    "sweep sisr relu", "sweep sisr posenc", "sweep ct relu",
    "sweep ct posenc"})


def real_step_plain_fn(RM):
    """real_step_plain's outputs by name (real_step_tensors)."""
    def plain(*args, **kwargs):
        return real_step_tensors(RM, *RM.real_step_plain(*args, **kwargs))
    return plain


def real_step_case(torch, RM, canon, c, t, kinds, **kw):
    """(kernel thunk, plain, args, kwargs) of one real_step case (metrics
    on); the kernel's calls share one scratch."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    kw = dict(kw, want_metrics=True)
    scratch = StepScratch()
    return (lambda: real_step_tensors(RM, *RM.real_step(
        canon, c, t, kinds, scratch=scratch, **kw)),
            real_step_plain_fn(RM), (canon, c, t, kinds), kw)


def real_pair_case(torch, RM, canon, c, cot, kinds, row_gamma=None,
                   dcoords=True):
    """(kernel thunk, plain, args, kwargs, pattern) of one real_mlp pair
    case: vjp() over [coords] + the canonical leaves (with dcoords) or
    param_vjp() (without); pattern(what) its relu_pattern_reference."""
    L = len(canon["layers"])
    inputs = [c] + [t for _, t in RM.canon_leaves(canon)]

    def pair(plain):
        fn = real_mlp_fn(RM, L, kinds, row_gamma, plain=plain)

        def run(inputs, cot):
            if dcoords:
                return vjp(torch, fn, inputs, cot)
            return param_vjp(torch, fn, inputs[0], inputs[1:], cot)
        return run
    kernel = pair(False)
    pattern = dict(canon=canon, x=c, kinds=kinds, cot=cot, dcoords=dcoords)
    return (lambda: kernel(inputs, cot), pair(True), (inputs, cot), {},
            lambda what: relu_pattern_reference(torch, RM, pattern, what))


def real_cases(torch, RM, MM, model_a, model_b, device):
    """{name: (kernel thunk, plain, args, kwargs[, pattern])} of
    real_kernel_vs_plain (pattern: real_pair_case's):
    real_step at the denoise path's full shape and a ragged one (nvalid,
    denom), and with lane segments and relu; the real_mlp pair (dcoords
    included) at the SISR path's full shape and a ragged one, each basis
    kind, lane segments and row_gamma."""
    cases = {}
    for which, n, nvalid, denom in (("full", 256 * 256, None, None),
                                    ("ragged", 700, 650, 650 * 3.0 + 1.0)):
        canon, kinds = path_canon(torch, MM, model_a, 5, device)
        c, t, gt, _ = real_inputs(torch, n, 2, 3, 6, device)
        cases[f"real_step {which}"] = real_step_case(
            torch, RM, canon, c, t, kinds, nvalid=nvalid, denom=denom, gt=gt)
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
        c, _, _, g = real_inputs(torch, n, 2, 3, 9, device)
        cases[f"real_mlp {which}"] = real_pair_case(torch, RM, canon, c, g,
                                                    kinds, row_gamma)
    canon = random_canon(torch, widths, 10, device)
    c, t, gt, _ = real_inputs(torch, 700, 2, 3, 11, device)
    cases["real_step segments_step"] = real_step_case(
        torch, RM, canon, c, t, ((("qspline", 20), ("identity", 10),
                                  ("sine", 10)), "relu"), gt=gt)
    return cases


def relu_pattern_reference(torch, RM, pair, what):
    """The outputs param_vjp gives for a relu pair, from the plain canonical
    MLP run in float64 on the kernel's own relu pattern: every input cast,
    each layer's relu B(v) = m v and dB(v) = m with m = [a > 0] of the
    kernel's activations a (its forward's, which keeps them; the backward
    decides from the same v).  Checks the pattern against the float64
    run's: wherever they differ, |v| of the float64 run lies within REL_TOL
    x its layer's max |v| of the kink.  Returns (the outputs, {"flips": per
    layer, "flip_v_rel": the largest such |v| / max |v|})."""
    canon, x, kinds, cot = (pair[k] for k in ("canon", "x", "kinds", "cot"))
    if pair["dcoords"] or any(k != "relu" for k in kinds):
        raise AssertionError(f"{what}: the relu pattern reference takes "
                             f"relu pairs without dcoords")
    _, _, acts = RM._forward(canon, x, kinds, None, keep=True)
    masks = [(a > 0).double() for a in acts]
    leaves = [t.detach().double().requires_grad_(True)
              for _, t in RM.canon_leaves(canon)]
    c64 = RM.canon_from_leaves(leaves, len(kinds))
    a, a_free, flips, worst = x.double(), x.double(), [], 0.0
    for lay, m in zip(c64["layers"], masks):
        a = m * (lay["alpha"] * (a @ lay["w"]) + lay["beta"])
        v = (lay["alpha"] * (a_free @ lay["w"]) + lay["beta"]).detach()
        differ = (v > 0).double() != m
        scale = float(v.abs().max())
        flip_v = float(v[differ].abs().max()) / scale if differ.any() else 0.
        if not flip_v <= REL_TOL:
            raise AssertionError(
                f"{what}: the kernel's relu decision differs from float64's "
                f"at |v| = {flip_v:.3e} x max|v|, past {REL_TOL}")
        flips.append(int(differ.sum()))
        worst = max(worst, flip_v)
        a_free = torch.relu(v)
    y = a @ c64["final"]["w"] + c64["final"]["b"]
    grads = torch.autograd.grad(y, leaves, cot.double())
    want = {"out": y.detach()}
    want.update({f"d{i + 1}": g for i, g in enumerate(grads)})
    return want, {"flips": flips, "flip_v_rel": worst}


def real_check(case, what):
    """The case's kernel outputs against its reference, with compare(): the
    plain version run in float64 for REAL_FLOAT64_CASES (on the kernel's
    relu pattern for REAL_RELU_PATTERN_CASES), else in fp32.  Returns (max
    abs err, the kernel's outputs)."""
    kernel, plain, args, kwargs = case[:4]
    got = kernel()
    if what in REAL_RELU_PATTERN_CASES:
        return compare(got, case[4](what)[0], what), got
    if what in REAL_FLOAT64_CASES:
        return compare_float64(got, plain, args, kwargs, what)[0], got
    return compare(got, plain(*args, **kwargs), what), got


def real_kernel_vs_plain(torch, RM, MM, model_a, model_b, device):
    """max abs err of real_step and real_mlp against their references
    (real_check) at the cases of real_cases; two calls of the full and
    ragged step and of the full and ragged pair giving identical bits."""
    errs = {"real_step": {}, "real_mlp": {}}
    for what, case in real_cases(torch, RM, MM, model_a, model_b,
                                 device).items():
        name, which = what.split(" ")
        errs[name][which], got = real_check(case, what)
        torch.cuda.synchronize()
        if which in ("full", "ragged"):
            same_bits(torch, case[0](), got, what)
    return errs


def check_nograd(torch, forward, with_grad, pingpong, what):
    """Runs ``forward()`` (a pair's forward) without a gradient: its output
    must equal the pair's, ``with_grad``, and its peak memory stay within
    ``pingpong`` bytes (two ping-pong planes) + 16 MiB.  Returns (peak MB,
    ping-pong MB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = forward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    slack = 16 * 2 ** 20
    if not torch.equal(y, with_grad):
        raise AssertionError(f"{what} without a gradient differs from the "
                             f"pair's forward")
    if not peak <= pingpong + slack:
        raise AssertionError(f"{what} without a gradient peaked at {peak} "
                             f"bytes, more than two ping-pong planes "
                             f"({pingpong}) + {slack}")
    return peak / 1e6, pingpong / 1e6


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
    got = vjp(torch, pair_fn(WM.wire_mlp, spec, keys), [c] + leaves, g)
    want = vjp(torch, pair_fn(WM.wire_mlp_plain, spec, keys), [c] + leaves,
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
    h = params["first"]["w"].shape[1]
    errs["wire_mlp_nograd_peak_mb"], errs["wire_mlp_nograd_pingpong_mb"] = \
        check_nograd(torch, lambda: WM.wire_mlp(params, c, spec), with_grad,
                     2 * n * 2 * h * 4, "wire_mlp")

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


def real_measure(torch, SW, RM, MM, model_a, model_b, device, build):
    """Times of real_step at the denoise shape and of real_mlp's pair
    (dcoords included) at the SISR shape: the kernel (a host call, and its
    kernels' device time, by product class), the plain version, the matmul
    yardstick, and the card's least time for the same work
    (tensor_core_fields); and real_step at the sweep's siren cell
    (siren_step_measure)."""
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
    res.update(tensor_core_fields(torch, build, step, "real_step", flops,
                                  nbytes, res["kernel_ms"], lib="real_mlp"))
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
    res.update(tensor_core_fields(torch, build, pair, "real_mlp", flops,
                                  nbytes, res["kernel_ms"]))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["real_mlp"] = res
    out["real_step"]["siren_mixed_codes"] = siren_step_measure(
        torch, SW, RM, MM, device)
    return out


def siren_step_measure(torch, SW, RM, MM, device):
    """real_step at the sweep's siren denoise cell (65,536 rows, its
    seed-0 init through the siren fold): every column's basis is sine,
    which the tensor-core epilogues call out of line (csrc/real_tc.cuh:
    with_basis), the path the B-spline steps never take.  Its host call,
    its kernels' device time by product class and its rate."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    task, side, o, tau = SWEEP_SHAPES[0]
    n = side * side
    model = SW._build("siren", task, side, side, tau, out_features=o)
    params = model.init(torch.Generator().manual_seed(0), device)
    canon = MM._canon_siren(params, model.spec)
    kinds = ("sine",) * len(canon["layers"])
    c = torch.tensor(SW.C.grid2d(side, side), device=device)
    _, t, gt, _ = real_inputs(torch, n, 2, o, 41, device)
    widths = RM._widths(canon, 2)
    scratch = StepScratch()

    def step():
        return RM.real_step(canon, c, t, kinds, gt=gt, want_metrics=True,
                            scratch=scratch)
    by = kernel_breakdown(torch, step, 20)
    names = kernel_names("real_mlp")
    kernel_ms = sum(v[0] for k, v in by.items()
                    if any(name in k for name in names))
    flops = RM.step_flops(n, widths)
    return {"widths": widths, "ms": cuda_ms(torch, step, 20),
            "kernel_ms": kernel_ms,
            "classes_ms": {
                cls: sum(v[0] for k, v in by.items()
                         if any(f in k for f in frags))
                for cls, frags in TENSOR_CORE_CLASSES["real_step"].items()},
            "achieved_tflops": flops / (kernel_ms * 1e9) if kernel_ms
            else None}


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


def mscale2_plain(MS):
    """mscale2_step_plain's outputs by name (mscale2_tensors)."""
    def plain(*args, **kwargs):
        return mscale2_tensors(*MS.mscale2_step_plain(*args, **kwargs))
    return plain


def mscale2_kernel_vs_plain(torch, MS, MM, models, device):
    """max abs err of mscale2_step from its plain version run in float64
    (compare_float64), every output tensor, at the path's full shape (n =
    65,536, ns = 3) and ragged ones where 128-row tiles straddle two scales
    (n = 700 with nvalid = 650 and denom at ns = 2 and 3; n = 65,537 at ns
    = 3); two calls bit-equal.  Also, not gated: the kernel's distance
    from the fp32 plain version and the fp32 plain version's from float64
    (max |a - b| / max |b| over the outputs)."""
    errs = {"kernel_vs_fp32_plain": {}, "fp32_plain_vs_float64": {}}
    plain = mscale2_plain(MS)
    for which, model, n, nvalid, denom in (
            ("full", models[0], 256 * 256, None, None),
            ("ragged", models[2], 700, 650, 650 * 3.0 + 1.0),
            ("ragged_ns3", models[0], 700, 650, 650 * 3.0 + 1.0),
            ("n65537_ns3", models[0], 256 * 256 + 1, 65000, None)):
        canon, comb, kinds, inv = mscale2_fold(torch, MM, model, 18, device)
        c, t, gt, _ = real_inputs(torch, n, 2, 3, 19, device)
        kw = dict(nvalid=nvalid, denom=denom, gt=gt, want_metrics=True)
        got, again = (mscale2_tensors(*MS.mscale2_step(
            canon, comb, c, t, kinds, inv, **kw)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, again, got, f"mscale2_step {which}")
        args = (canon, comb, c, t, kinds, inv)
        errs[which], want64 = compare_float64(got, plain, args, kw,
                                              f"mscale2_step {which}")
        want32 = plain(*args, **kw)
        errs["kernel_vs_fp32_plain"][which] = rel_distance(got, want32)
        errs["fp32_plain_vs_float64"][which] = rel_distance(want32, want64)
        del want32, want64
    return errs


def real_fold_cases(torch, RM, MM, get_inr, get_config, device):
    """{name: (kernel thunk, plain, args, kwargs)} of real_step at the folds
    of mscale_hier (lane segments 256 qspline + 5 or 261 identity, widths
    261 and 517; preset MscaleHier_ST1o9_LR8e3_E2000) and mscale_HL (a
    per-lane alpha over three bands; preset
    MscaleHL_s1o9_ST4_3_SHF384_LR8e3_E4000), at 4,099 rows with nvalid
    4,000."""
    cases = {}
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
        cases[f"real_step {which}"] = real_step_case(
            torch, RM, canon, c, t, kinds, nvalid=4000, gt=gt)
    return cases


def multiscale_fold_vs_plain(torch, RM, MM, get_inr, get_config, device):
    """real_step's kernel against its reference (real_check) at the folds
    of real_fold_cases."""
    return {what.split(" ")[1]: real_check(case, what)[0]
            for what, case in real_fold_cases(torch, RM, MM, get_inr,
                                              get_config, device).items()}


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


def mscale2_measure(torch, MS, RM, MM, model, device, build):
    """Times of mscale2_step at the path's shape: the kernel (a host call,
    and its kernels' device time, by product class), the plain version, the
    matmul yardstick, and the card's least time for the same work
    (tensor_core_fields)."""
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
    res.update(tensor_core_fields(torch, build, step, "mscale2_step", flops,
                                  nbytes, res["kernel_ms"]))
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


MFN_SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
                   "hidden_layers")


def mfn_models(get_inr, SW, task, H, W):
    """The sweep app's MFN model for a task (kernels) and the same spec with
    fused='never' (the plain path)."""
    model = SW._build("mfn", task, H, W, 3e1 if task == "denoise" else 1e2)
    plain = get_inr("mfn", fused="never", **{
        f: getattr(model.spec, f) for f in MFN_SPEC_FIELDS})
    return model, plain


def mfn_case(torch, get_inr, n, d, h, layers, o, seed, device):
    """An MFN of the given shape, its seeded init and numpy-seeded inputs:
    (model, params, coords, target, gt, cotangent)."""
    import numpy as np
    model = get_inr("mfn", in_features=d, out_features=o, hidden_features=h,
                    hidden_layers=layers)
    params = model.init(torch.Generator().manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(-1, 1, (n, d)), rng.uniform(0, 1, (n, o)),
            rng.uniform(0, 1, (n, o)), rng.normal(size=(n, o)))
    return (model, params) + tuple(
        torch.tensor(a.astype(np.float32), device=device) for a in arrs)


def param_vjp(torch, fn, coords, leaves, cot):
    """vjp() with constant coordinates (no dcoords, as in every fit)."""
    xs = [x.detach().requires_grad_(True) for x in leaves]
    out = fn(coords, *xs)
    grads = torch.autograd.grad(out, xs, cot, allow_unused=True)
    res = {"out": out.detach()}
    res.update({f"d{i + 1}": torch.zeros_like(x) if g is None else g
                for i, (x, g) in enumerate(zip(xs, grads))})
    return res


def same_bits(torch, a, b, what):
    for name in b:
        if not torch.equal(a[name], b[name]):
            raise AssertionError(f"{what}: two calls differ in {name}")


def mfn_step_plain(MF):
    """mfn_step_plain's outputs by name (tensors_of)."""
    def plain(*args, **kwargs):
        return tensors_of(*MF.mfn_step_plain(*args, **kwargs))
    return plain


def mfn_pair_plain(torch, MF, spec, keys, dcoords=True):
    """(inputs, cot) -> the plain pair's vjp() (with dcoords) or param_vjp()
    (without), inputs = [coords] + leaves."""
    fn = pair_fn(MF.mfn_mlp_plain, spec, keys)

    def plain(inputs, cot):
        if dcoords:
            return vjp(torch, fn, inputs, cot)
        return param_vjp(torch, fn, inputs[0], inputs[1:], cot)
    return plain


def mfn_step_case(torch, MF, params, c, t, spec, **kw):
    """(kernel thunk, plain, args, kwargs) of one mfn_step case; the
    kernel's calls share one scratch."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    kw = dict(kw, want_metrics=True)
    scratch = StepScratch()
    return (lambda: tensors_of(*MF.mfn_step(params, c, t, spec,
                                            scratch=scratch, **kw)),
            mfn_step_plain(MF), (params, c, t, spec), kw)


def mfn_pair_case(torch, MF, params, c, cot, spec, dcoords=True):
    """(kernel thunk, plain, args, kwargs) of one mfn_mlp pair case."""
    keys = leaf_paths(params)
    inputs = [c] + [t for _, t in tree_leaves(params)]
    fn = pair_fn(MF.mfn_mlp, spec, keys)

    def kernel():
        if dcoords:
            return vjp(torch, fn, inputs, cot)
        return param_vjp(torch, fn, c, inputs[1:], cot)
    return (kernel, mfn_pair_plain(torch, MF, spec, keys, dcoords),
            (inputs, cot), {})


def mfn_extreme_phase(torch, params, c):
    """Every filter's w scaled in place until max |x w| ~ 8,000 (the JAX
    package's extreme-phase case); returns that max."""
    qmax = 0.0
    for k in params:
        if k.startswith("gabor_"):
            w = params[k]["w"]
            params[k]["w"] = (w * (8000.0 / float((c @ w).abs().max()))
                              ).contiguous()
            qmax = max(qmax, float((c @ params[k]["w"]).abs().max()))
    return qmax


def mfn_cases(torch, MF, get_inr, device):
    """{name: (kernel thunk, plain, args, kwargs)} of mfn_kernel_vs_plain:
    the step at the denoise sweep's shape (n = 65,536, h = 300, metrics)
    and a ragged one (n = 700, nvalid 650, denom, d = 3, o = 1,
    hidden_layers 3); the pair at the SISR sweep's shape (n = 65,536,
    h = 256) with and without dcoords, on (4, 50, 2) coordinates and at
    the extreme phase |x w| ~ 8,000 (n = 512, h = 64)."""
    cases = {}
    for which, (n, d, h, layers, o, nvalid, denom) in {
            "full": (256 * 256, 2, 300, 2, 3, None, None),
            "ragged": (700, 3, 300, 3, 1, 650, 650 * 1.0 + 1.0)}.items():
        model, params, c, t, gt, _ = mfn_case(torch, get_inr, n, d, h,
                                              layers, o, 24, device)
        cases[f"mfn_step {which}"] = mfn_step_case(
            torch, MF, params, c, t, model.spec, nvalid=nvalid, denom=denom,
            gt=gt)
    model, params, c, _, _, g = mfn_case(torch, get_inr, 256 * 256, 2, 256,
                                         2, 3, 25, device)
    spec = model.spec
    cases["mfn_mlp full"] = mfn_pair_case(torch, MF, params, c, g, spec)
    cases["mfn_mlp no_dcoords"] = mfn_pair_case(torch, MF, params, c, g,
                                                spec, dcoords=False)
    cases["mfn_mlp batched"] = mfn_pair_case(
        torch, MF, params, c[:200].reshape(4, 50, 2),
        g[:200].reshape(4, 50, 3), spec)
    model, params, c, _, _, g = mfn_case(torch, get_inr, 512, 2, 64, 2, 3,
                                         26, device)
    qmax = mfn_extreme_phase(torch, params, c)
    if not qmax > 7e3:
        raise AssertionError(f"extreme phase: max |x w| {qmax}")
    cases["mfn_mlp extreme_phase"] = mfn_pair_case(torch, MF, params, c, g,
                                                   model.spec)
    return cases


def sweep_mfn_cases(torch, np, SW, MF, device):
    """{name: (kernel thunk, plain, args, kwargs)} of the MFN kernels the
    sweep phase launches, at the sweep's own shapes from the sweep's seed-0
    init (SW._build) on its coordinate grid: the step at denoise (65,536
    rows, o 3, metrics), the pair (parameter gradients) at SISR (65,536,
    o 3) and CT (262,144, o 1), the CT pair with dcoords as well."""
    cases = {}
    for task, side, o, tau in SWEEP_SHAPES:
        n = side * side
        rng = np.random.default_rng(40)
        coords = torch.tensor(SW.C.grid2d(side, side), device=device)
        t, gt, g = (torch.tensor(a.astype(np.float32), device=device)
                    for a in (rng.uniform(0, 1, (n, o)),
                              rng.uniform(0, 1, (n, o)),
                              rng.normal(size=(n, o))))
        model = SW._build("mfn", task, side, side, tau, out_features=o)
        params = model.init(torch.Generator().manual_seed(0), device)
        what = f"sweep {task} mfn"
        if task == "denoise":
            cases[what] = mfn_step_case(torch, MF, params, coords, t,
                                        model.spec, gt=gt)
            continue
        cases[what] = mfn_pair_case(torch, MF, params, coords, g, model.spec,
                                    dcoords=False)
        if task == "ct":
            cases[what + " dcoords"] = mfn_pair_case(torch, MF, params,
                                                     coords, g, model.spec)
    return cases


def mfn_check(case, what):
    """The case's kernel outputs against its plain version in fp32, with
    compare(): every MFN case's fp32 plain run lies within 6e-6 x max of
    its float64 run but the extreme phase's, whose point is q's rounding,
    which the kernels form as the plain version does
    (tools/port_mfn_reference.py, PERF.md section 2).  Returns (max abs
    err, the kernel's outputs)."""
    kernel, plain, args, kwargs = case
    got = kernel()
    return compare(got, plain(*args, **kwargs), what), got


def mfn_kernel_vs_plain(torch, MF, get_inr, device):
    """max abs err of mfn_step and of the mfn_mlp pair against their
    references (mfn_check) at the cases of mfn_cases; two calls of the full
    and ragged step and of the full pair giving identical bits; the pair
    without a gradient (equal output, no kept planes)."""
    errs = {"mfn_step": {}, "mfn_mlp": {}}
    outs = {}
    for what, case in mfn_cases(torch, MF, get_inr, device).items():
        name, which = what.split(" ")
        errs[name][which], outs[what] = mfn_check(case, what)
        torch.cuda.synchronize()
        if which in ("full", "ragged"):
            same_bits(torch, case[0](), outs[what], what)
    if outs["mfn_mlp batched"]["out"].shape != (4, 50, 3):
        raise AssertionError(f"mfn_mlp (4, 50, 2): output shape "
                             f"{tuple(outs['mfn_mlp batched']['out'].shape)}")
    model, params, c, _, _, _ = mfn_case(torch, get_inr, 256 * 256, 2, 256,
                                         2, 3, 25, device)
    errs["mfn_mlp"]["nograd_peak_mb"], errs["mfn_mlp"]["nograd_pingpong_mb"] \
        = check_nograd(torch, lambda: MF.mfn_mlp(params, c, model.spec),
                       outs["mfn_mlp full"]["out"], 2 * c.shape[0] * 256 * 4,
                       "mfn_mlp")
    return errs


# the sweep's tasks as the app sizes them: (task, field side, out features,
# tau of _build)
SWEEP_SHAPES = (("denoise", 256, 3, 3e1), ("sisr", 256, 3, 1e2),
                ("ct", 512, 1, 1e2))
# each real sweep family's fold onto the canonical kernels (nn/models.py):
# the fold and its basis; posenc is relu on encoded coordinates
SWEEP_REAL_FOLDS = {"siren": ("_canon_siren", "sine"),
                    "gauss": ("_canon_gauss", "gauss"),
                    "relu": ("_canon_relu", "relu"),
                    "posenc": ("_canon_relu", "relu")}


def sweep_real_cases(torch, np, SW, RM, MM, device):
    """{name: (kernel thunk, plain, args, kwargs[, pattern])} of the real
    kernels the sweep phase launches, at the sweep's own shapes from the sweep's seed-0
    init (SW._build) on its coordinate grid, each family through its fold
    (posenc on its encoded coordinates): real_step at denoise (65,536
    rows, o 3, metrics), the real_mlp pair (parameter gradients) at SISR
    (65,536, o 3) and CT (262,144, o 1)."""
    cases = {}
    for task, side, o, tau in SWEEP_SHAPES:
        n = side * side
        rng = np.random.default_rng(40)
        coords = torch.tensor(SW.C.grid2d(side, side), device=device)
        t, gt, g = (torch.tensor(a.astype(np.float32), device=device)
                    for a in (rng.uniform(0, 1, (n, o)),
                              rng.uniform(0, 1, (n, o)),
                              rng.normal(size=(n, o))))
        for nonlin, (fold, kind) in SWEEP_REAL_FOLDS.items():
            model = SW._build(nonlin, task, side, side, tau, out_features=o,
                              posenc_sidelength=100 if task == "ct" else None)
            params = model.init(torch.Generator().manual_seed(0), device)
            canon = getattr(MM, fold)(params, model.spec)
            kinds = (kind,) * len(canon["layers"])
            x = MM._posenc_pre(coords, model.spec)
            what = f"sweep {task} {nonlin}"
            if task == "denoise":
                cases[what] = real_step_case(torch, RM, canon, x, t, kinds,
                                             gt=gt)
            else:
                cases[what] = real_pair_case(torch, RM, canon, x, g, kinds,
                                             dcoords=False)
    return cases


def sweep_kernel_vs_plain(torch, np, SW, WS, WM, RM, MM, MF, device):
    """max abs err of every kernel the sweep phase launches against its
    plain version at the sweep's own shapes, each family from the sweep's
    seed-0 init (SW._build) on the sweep's coordinate grid: denoise (256^2
    = 65,536 rows, o 3) through the step kernels, with metrics; SISR (256^2
    HR, o 3) and CT (512^2 = 262,144 rows, o 1) through the pairs as a fit
    calls them (parameter gradients), mfn's CT pair with dcoords as well.
    siren, gauss, relu and posenc go through their fold (posenc on its
    encoded coordinates)."""
    errs = {name: {} for name in ("wire_step", "wire_mlp", "real_step",
                                  "real_mlp", "mfn_step", "mfn_mlp")}
    for task, side, o, tau in SWEEP_SHAPES:
        n = side * side
        rng = np.random.default_rng(40)
        coords = torch.tensor(SW.C.grid2d(side, side), device=device)
        t, gt, g = (torch.tensor(a.astype(np.float32), device=device)
                    for a in (rng.uniform(0, 1, (n, o)),
                              rng.uniform(0, 1, (n, o)),
                              rng.normal(size=(n, o))))
        for nonlin in SW.NONLINS:
            if nonlin == "mfn" or nonlin in SWEEP_REAL_FOLDS:
                continue  # sweep_mfn_cases, sweep_real_cases below
            model = SW._build(nonlin, task, side, side, tau, out_features=o,
                              posenc_sidelength=100 if task == "ct" else None)
            spec = model.spec
            params = model.init(torch.Generator().manual_seed(0), device)
            what = f"sweep {task} {nonlin}"
            if task == "denoise":
                got = tensors_of(*WS.wire_step(params, coords, t, spec, gt=gt,
                                               want_metrics=True))
                torch.cuda.synchronize()
                want = tensors_of(*WS.wire_step_plain(
                    params, coords, t, spec, gt=gt, want_metrics=True))
                errs["wire_step"][what] = compare(got, want, what)
                continue
            keys = leaf_paths(params)
            leaves = [v for _, v in tree_leaves(params)]
            kfn, pfn = (pair_fn(a, spec, keys)
                        for a in (WM.wire_mlp, WM.wire_mlp_plain))
            got = param_vjp(torch, kfn, coords, leaves, g)
            torch.cuda.synchronize()
            errs["wire_mlp"][what] = compare(
                got, param_vjp(torch, pfn, coords, leaves, g), what)
    for what, case in sweep_real_cases(torch, np, SW, RM, MM,
                                       device).items():
        name = "real_step" if what.startswith("sweep denoise") else \
            "real_mlp"
        errs[name][what] = real_check(case, what)[0]
        torch.cuda.synchronize()
    for what, case in sweep_mfn_cases(torch, np, SW, MF, device).items():
        name = "mfn_step" if what == "sweep denoise mfn" else "mfn_mlp"
        errs[name][what] = mfn_check(case, what)[0]
        torch.cuda.synchronize()
    return errs


def mfn_matmul_vjp(torch, params, x, cotangent, want_dcoords=False):
    """The MFN forward as torch.matmul calls with the filters in PyTorch
    ops, and its backward written out (mfn_step.py:115-153), for the output
    cotangent ``cotangent(y)``: the library yardstick (not used by the
    port).  Returns (y, grads, dcoords or None)."""
    k = sum(1 for name in params if name.startswith("gabor_"))

    def filt(p):
        q = torch.addmm(p["b"], x, p["w"])
        nrm = ((x * x).sum(-1, keepdim=True) + (p["mu"] * p["mu"]).sum(-1)
               - 2.0 * (x @ p["mu"].t()))
        return torch.exp(-0.5 * p["gamma"] * nrm), torch.sin(q), \
            torch.cos(q), nrm

    F = [filt(params[f"gabor_{j}"]) for j in range(k)]
    zs, ls = [F[0][0] * F[0][1]], [None]
    for j in range(1, k):
        lin = params[f"linear_{j - 1}"]
        ls.append(torch.addmm(lin["b"], zs[-1], lin["w"]))
        zs.append(ls[-1] * F[j][0] * F[j][1])
    fin = params["final"]
    y = torch.addmm(fin["b"], zs[-1], fin["w"])
    g = cotangent(y)
    grads = {"final": {"w": zs[-1].t() @ g, "b": g.sum(0)}}
    dc = torch.zeros_like(x) if want_dcoords else None

    def filt_grads(j, dg):
        nonlocal dc
        E, S, C, nrm = F[j]
        p = params[f"gabor_{j}"]
        es = dg * E
        dq, ges = es * C, es * S
        dn = (-0.5 * p["gamma"]) * ges
        grads[f"gabor_{j}"] = {
            "w": x.t() @ dq, "b": dq.sum(0),
            "gamma": -0.5 * (ges * nrm).sum(0),
            "mu": 2.0 * dn.sum(0)[:, None] * p["mu"] - 2.0 * (dn.t() @ x)}
        if want_dcoords:
            dc = (dc + dq @ p["w"].t() + 2.0 * dn.sum(1, keepdim=True) * x
                  - 2.0 * (dn @ p["mu"]))

    dz = g @ fin["w"].t()
    for j in range(k - 1, 0, -1):
        dl = dz * (F[j][0] * F[j][1])
        filt_grads(j, dz * ls[j])
        lin = params[f"linear_{j - 1}"]
        grads[f"linear_{j - 1}"] = {"w": zs[j - 1].t() @ dl, "b": dl.sum(0)}
        dz = dl @ lin["w"].t()
    filt_grads(0, dz)
    return y, grads, dc


def mfn_matmul_step(torch, params, x, target, gt):
    """The masked-MSE train step through ``mfn_matmul_vjp``."""
    n, o = target.shape
    y, grads, _ = mfn_matmul_vjp(
        torch, params, x, lambda y: (2.0 / (n * o)) * (y - target))
    et, eg = y - target, y - gt
    return y, grads, ((et * et).sum(), (eg * eg).sum())


def mfn_measure(torch, MF, get_inr, device, build):
    """Times of mfn_step at the denoise sweep's shape (n = 65,536, h = 300)
    and of the mfn_mlp pair (dcoords included) at the SISR sweep's shape
    (n = 65,536, h = 256): the kernel (a host call, and its kernels' device
    time, by product class), the plain version, the matmul yardstick, and
    the card's least time for the same work (tensor_core_fields)."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    out = {}
    n, d, h, layers, o = 256 * 256, 2, 300, 2, 3
    model, params, c, t, gt, _ = mfn_case(torch, get_inr, n, d, h, layers, o,
                                          27, device)
    spec = model.spec
    nweights = num_weights(params)
    scratch = StepScratch()

    def step():
        return MF.mfn_step(params, c, t, spec, gt=gt, want_metrics=True,
                           scratch=scratch)

    lib_err = compare(
        tensors_of(*mfn_matmul_step(torch, params, c, t, gt)),
        tensors_of(*MF.mfn_step_plain(params, c, t, spec, gt=gt,
                                      want_metrics=True)),
        "mfn matmul step vs plain")
    flops = MF.step_flops(n, d, h, o, layers + 1)
    nbytes = 4 * (n * (d + o + o) + nweights + n * o + nweights + 2)
    res = {
        "ms": cuda_ms(torch, step, 20),
        "kernel_ms": kernel_device_ms(torch, step, 20, kernel_names("mfn")),
        "plain_ms": cuda_ms(torch, lambda: MF.mfn_step_plain(
            params, c, t, spec, gt=gt, want_metrics=True), 10),
        "library_ms": cuda_ms(torch, lambda: mfn_matmul_step(
            torch, params, c, t, gt), 10),
        "library": "torch.matmul step, filters and written-out backward in "
                   "PyTorch ops",
        "library_vs_plain_max_abs_err": lib_err}
    res.update(tensor_core_fields(torch, build, step, "mfn_step", flops,
                                  nbytes, res["kernel_ms"], lib="mfn"))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["mfn_step"] = res
    del scratch

    h = 256
    model, params, c, _, _, g = mfn_case(torch, get_inr, n, d, h, layers, o,
                                         28, device)
    spec, keys = model.spec, leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    nweights = num_weights(params)
    kfn, pfn = (pair_fn(a, spec, keys)
                for a in (MF.mfn_mlp, MF.mfn_mlp_plain))

    def pair():
        return vjp(torch, kfn, [c] + leaves, g)

    def fwd():
        with torch.no_grad():
            kfn(c, *leaves)

    lib = mfn_matmul_vjp(torch, params, c, lambda y: g, want_dcoords=True)
    got = {"out": lib[0], "d0": lib[2]}
    got.update({f"d{i + 1}": tt for i, (_, tt) in
                enumerate(tree_leaves(lib[1]))})
    want = vjp(torch, pfn, [c] + leaves, g)
    flops = MF.apply_flops(n, d, h, o, layers + 1)
    nbytes = 4 * (2 * (n * d + n * o + nweights))
    res = {
        "ms": cuda_ms(torch, pair, 20),
        "kernel_ms": kernel_device_ms(torch, pair, 20, kernel_names("mfn")),
        "fwd_ms": cuda_ms(torch, fwd, 20),
        "plain_ms": cuda_ms(torch, lambda: vjp(torch, pfn, [c] + leaves, g),
                            10),
        "library_ms": cuda_ms(torch, lambda: mfn_matmul_vjp(
            torch, params, c, lambda y: g, want_dcoords=True), 10),
        "library": "torch.matmul forward, filters and written-out backward "
                   "in PyTorch ops",
        "library_vs_plain_max_abs_err": max(
            float((got[k] - want[k]).abs().max()) for k in want)}
    res.update(tensor_core_fields(torch, build, pair, "mfn_mlp", flops,
                                  nbytes, res["kernel_ms"], lib="mfn"))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["mfn_mlp"] = res
    return out


def fit_mfn(torch, np, mods, counters, device):
    """MFN denoise at the sweep's problem (the 512^2 stand-in halved to
    256^2, noised with measure_np(snr 2, tau 30), 65,536 coordinates, full
    batch, lr 5e-2 scaled by batch) for MFN_ITERS epochs through
    fit_pointwise: once through the kernel, counts reset just before and
    read just after, and once through the plain path (fused='never'), from
    one init."""
    SW, M, get_inr, FitConfig, fit_pointwise = mods
    im, im_noisy = SW.denoise_images()
    H, W, _ = im.shape
    model, plain = mfn_models(get_inr, SW, "denoise", H, W)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = SW.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=SW._DENOISE_LR["mfn"],
                        niters=MFN_ITERS, maxpoints=256 * 256,
                        scale_lr_by_batch=True)
    reset_counts(counters)
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                        fit_cfg, gt=im.reshape(-1, 3), device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "MFN denoise",
                        {("mfn", "step"): MFN_ITERS})
    res_plain = fit_pointwise(plain, params, grid, im_noisy.reshape(-1, 3),
                              fit_cfg, gt=im.reshape(-1, 3), device=device)
    if read_counts(counters) != launches:
        raise AssertionError("MFN denoise: the plain fit launched a kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H * W, 3)):
            raise AssertionError("MFN denoise: non-finite values or a wrong "
                                 "shape")
    psnr, psnr_plain = (float(M.psnr_ref(im, r.best_rec.reshape(H, W, 3)))
                        for r in (res, res_plain))
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(
            f"MFN denoise: kernel fit {psnr:.3f} dB vs plain fit "
            f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_MFN_DB["denoise"] - 0.2
    if not psnr >= floor:
        raise AssertionError(f"MFN denoise: kernel fit best PSNR "
                             f"{psnr:.3f} dB below the floor {floor} dB")
    return dict(epochs=MFN_ITERS, launches=launches["mfn"], psnr_db=psnr,
                psnr_plain_db=psnr_plain, floor_db=floor,
                ms_per_step=res.step_ms, plain_ms_per_step=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def fit_mfn_sisr(torch, np, mods, counters, device):
    """MFN SISR at the sweep's problem (the 768^2 stand-in shrunk by a third
    to 256^2 HR, x4 box downsample to 64^2, lr 5e-2 decaying to 0.2x) for
    MFN_ITERS iterations through fit_operator, through the kernels and the
    plain path, from one init."""
    SW, TS, TF, M, get_inr, FitConfig, fit_operator = mods
    im, im_lr = TS.sisr_images(None, 0, 4, size=768)
    H, W, _ = im.shape
    model, plain = mfn_models(get_inr, SW, "sisr", H, W)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = SW.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=SW._SISR_LR["mfn"], niters=MFN_ITERS,
                        lr_decay=0.2)
    op = TF.DownsampleOp(4)
    reset_counts(counters)
    res = fit_operator(model, params, grid, im_lr, op, fit_cfg, gt_field=im,
                       field_shape=(H, W, 3), track="gt", device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "MFN SISR",
                        {("mfn", "forward"): MFN_ITERS,
                         ("mfn", "backward"): MFN_ITERS})
    res_plain = fit_operator(plain, params, grid, im_lr, op, fit_cfg,
                             gt_field=im, field_shape=(H, W, 3), track="gt",
                             device=device)
    if read_counts(counters) != launches:
        raise AssertionError("MFN SISR: the plain fit launched a kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H, W, 3)):
            raise AssertionError("MFN SISR: non-finite values or a wrong "
                                 "shape")
    db, db_plain = M.mse_db(res.best_mse), M.mse_db(res_plain.best_mse)
    if not abs(db - db_plain) <= PSNR_AGREE_DB:
        raise AssertionError(f"MFN SISR: kernel fit {db:.3f} dB vs plain fit "
                             f"{db_plain:.3f} dB differ by more than "
                             f"{PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_MFN_DB["sisr"] - 0.2
    if not db >= floor:
        raise AssertionError(f"MFN SISR: kernel fit best -10 log10(MSE) "
                             f"{db:.3f} dB below the floor {floor} dB")
    return dict(iters=MFN_ITERS, launches=launches["mfn"], mse_db=db,
                mse_db_plain=db_plain, floor_db=floor,
                ssim=float(M.ssim(im, res.best_rec, data_range=1.0)),
                ms_per_iter=res.step_ms, plain_ms_per_iter=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def wire2d_case(torch, get_inr, n, layers, o, seed, device, kw=None,
                lead=()):
    """A WIRE-2D at the full width (300 hidden features: 150 units per
    head), its seeded init and numpy-seeded inputs: (model, params, coords,
    target, gt, cotangent); ``kw`` overrides the denoise model's
    frequencies and width."""
    import numpy as np
    spec_kw = dict(WIRE2D_DENOISE_KW, hidden_layers=layers, out_features=o)
    spec_kw.update(kw or {})
    model = get_inr("wire2d", **spec_kw)
    params = model.init(torch.Generator().manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(-1, 1, lead + (n, 2)), rng.uniform(0, 1, (n, o)),
            rng.uniform(0, 1, (n, o)), rng.normal(size=lead + (n, o)))
    return (model, params) + tuple(
        torch.tensor(a.astype(np.float32), device=device) for a in arrs)


def wire2d_ct_kw(get_config):
    """The CT path's WIRE-2D frequencies: preset CT_CONFIG's."""
    cfg = get_config(CT_CONFIG)
    return dict(first_omega0=cfg.omega0, hidden_omega0=cfg.omega0,
                scale=cfg.scale)


# wire2d_step and the wire2d_mlp pair at widths, depths, outputs and row
# counts besides the main path's, as (hidden_features, units per head h,
# L, o, n, nvalid, denom): h 5, 13, 150, 152 and 256 (odd, even, a
# multiple of 4) against the 16-unit quad and 32-unit paired tiles, K = 2h
# and 4h against the 32-deep slices, n 700 and 65,537 against the 128-row
# tiles and the weight gradients' 512- and 1,024-row chunks; both at the
# denoise frequencies, the step with nvalid and denom, the pair with
# dcoords
WIRE2D_WIDTHS = ((10, 5, 0, 3, 700, 650, 1951.0),
                 (10, 5, 3, 1, 700, None, None),
                 (26, 13, 2, 3, 700, 600, None),
                 (300, 150, 1, 1, 700, None, 777.0),
                 (300, 150, 3, 3, 700, 650, None),
                 (304, 152, 2, 1, 700, None, None),
                 (512, 256, 1, 3, 700, 699, None),
                 (300, 150, 2, 3, 65537, 65000, None),
                 (304, 152, 1, 1, 65537, None, 70000.0),
                 (512, 256, 2, 1, 65537, None, None),
                 (26, 13, 3, 3, 65537, None, None))
# and the pair at the CT frequencies, (hidden_features, h, L, o, n): there
# its fp32 plain version lies 8.65e-5 x max from its own float64 run on one
# weight gradient, a difference of near-equal blocks
# (tools/port_wire2d_reference.py --widths), so this case is held to the
# float64 run (compare_float64)
WIRE2D_CT_WIDTH = (10, 5, 3, 1, 700)


def wire2d_widths(torch, W2, get_inr, get_config, device):
    """wire2d_step and the wire2d_mlp pair against their plain versions at
    each of WIRE2D_WIDTHS, and the pair against its plain version run in
    float64 at WIRE2D_CT_WIDTH; two calls of each bit-equal."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    errs = {"wire2d_step": {}, "wire2d_mlp": {}}
    for hf, h, L, o, n, nvalid, denom in WIRE2D_WIDTHS:
        what = f"h{h} L{L} o{o} n{n}"
        seed = n + hf + L
        model, params, c, t, gt, _ = wire2d_case(
            torch, get_inr, n, L, o, seed, device, {"hidden_features": hf})
        scratch = StepScratch()
        got, again = (tensors_of(*W2.wire2d_step(
            params, c, t, model.spec, nvalid=nvalid, denom=denom, gt=gt,
            want_metrics=True, scratch=scratch)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, got, again, f"wire2d_step {what}")
        want = tensors_of(*W2.wire2d_step_plain(
            params, c, t, model.spec, nvalid=nvalid, denom=denom, gt=gt,
            want_metrics=True))
        errs["wire2d_step"][what] = compare(got, want, f"wire2d_step {what}")
        del scratch

        model, params, c, _, _, g = wire2d_case(
            torch, get_inr, n, L, o, seed + 1, device, {"hidden_features": hf})
        keys, leaves = leaf_paths(params), [v for _, v in
                                            tree_leaves(params)]
        kfn = pair_fn(W2.wire2d_mlp, model.spec, keys)
        got, again = (vjp(torch, kfn, [c] + leaves, g) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, got, again, f"wire2d_mlp {what}")
        errs["wire2d_mlp"][what] = compare(
            got, vjp(torch, pair_fn(W2.wire2d_mlp_plain, model.spec, keys),
                     [c] + leaves, g), f"wire2d_mlp {what}")

    hf, h, L, o, n = WIRE2D_CT_WIDTH
    what = f"h{h} L{L} o{o} n{n} ct"
    model, params, c, _, _, g = wire2d_case(
        torch, get_inr, n, L, o, n + hf + L + 1, device,
        dict(wire2d_ct_kw(get_config), hidden_features=hf))
    keys, leaves = leaf_paths(params), [v for _, v in tree_leaves(params)]
    kfn = pair_fn(W2.wire2d_mlp, model.spec, keys)
    got, again = (vjp(torch, kfn, [c] + leaves, g) for _ in range(2))
    torch.cuda.synchronize()
    same_bits(torch, got, again, f"wire2d_mlp {what}")
    pfn = pair_fn(W2.wire2d_mlp_plain, model.spec, keys)
    errs["wire2d_mlp"][what], _ = compare_float64(
        got, lambda xs, cot: vjp(torch, pfn, xs, cot), ([c] + leaves, g), {},
        f"wire2d_mlp {what}")
    return errs


def wire2d_kernel_vs_plain(torch, W2, get_inr, get_config, device):
    """max abs err of wire2d_step and of the wire2d_mlp pair against their
    plain versions: the step at the denoise shape (n = 65,536, o = 3,
    metrics) and ragged ones (n = 700, nvalid 650, denom, o = 1, L = 1 and
    3); the pair at the CT shape (o = 1, parameter gradients, as the fit
    calls it) and at the denoise shape with dcoords, on (4, 50, 2)
    coordinates, and without a gradient (equal output, a peak within its
    two ping-pong planes + 16 MiB); two calls of each kernel giving
    identical bits."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    errs = {"wire2d_step": {}, "wire2d_mlp": {}}
    for which, (n, layers, o, nvalid, denom) in {
            "full": (256 * 256, 2, 3, None, None),
            "ragged_L1": (700, 1, 1, 650, 650 * 1.0 + 1.0),
            "ragged_L3": (700, 3, 1, 650, 650 * 1.0 + 1.0)}.items():
        model, params, c, t, gt, _ = wire2d_case(torch, get_inr, n, layers,
                                                 o, 30, device)
        scratch = StepScratch()
        got, again = (tensors_of(*W2.wire2d_step(
            params, c, t, model.spec, nvalid=nvalid, denom=denom, gt=gt,
            want_metrics=True, scratch=scratch)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, got, again, f"wire2d_step {which}")
        want = tensors_of(*W2.wire2d_step_plain(params, c, t, model.spec,
                                                nvalid=nvalid, denom=denom,
                                                gt=gt, want_metrics=True))
        errs["wire2d_step"][which] = compare(got, want,
                                             f"wire2d_step {which}")

    ct_kw = wire2d_ct_kw(get_config)
    model, params, c, _, _, g = wire2d_case(torch, get_inr, 256 * 256, 2, 1,
                                            31, device, ct_kw)
    spec, keys = model.spec, leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    kfn, pfn = (pair_fn(a, spec, keys)
                for a in (W2.wire2d_mlp, W2.wire2d_mlp_plain))
    got, again = (param_vjp(torch, kfn, c, leaves, g) for _ in range(2))
    torch.cuda.synchronize()
    same_bits(torch, got, again, "wire2d_mlp full")
    errs["wire2d_mlp"]["full"] = compare(
        got, param_vjp(torch, pfn, c, leaves, g), "wire2d_mlp full")
    errs["wire2d_mlp"]["nograd_peak_mb"], \
        errs["wire2d_mlp"]["nograd_pingpong_mb"] = check_nograd(
            torch, lambda: W2.wire2d_mlp(params, c, spec), got["out"],
            2 * c.shape[0] * 300 * 4, "wire2d_mlp")

    model, params, c, _, _, g = wire2d_case(torch, get_inr, 256 * 256, 2, 3,
                                            32, device)
    spec, keys = model.spec, leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    kfn, pfn = (pair_fn(a, spec, keys)
                for a in (W2.wire2d_mlp, W2.wire2d_mlp_plain))
    got, again = (vjp(torch, kfn, [c] + leaves, g) for _ in range(2))
    torch.cuda.synchronize()
    same_bits(torch, got, again, "wire2d_mlp dcoords")
    errs["wire2d_mlp"]["dcoords"] = compare(
        got, vjp(torch, pfn, [c] + leaves, g), "wire2d_mlp with dcoords")

    model, params, c, _, _, g = wire2d_case(torch, get_inr, 50, 2, 1, 33,
                                            device, ct_kw, lead=(4,))
    keys, leaves = leaf_paths(params), [t for _, t in tree_leaves(params)]
    got = vjp(torch, pair_fn(W2.wire2d_mlp, model.spec, keys), [c] + leaves,
              g)
    if got["out"].shape != (4, 50, 1):
        raise AssertionError(f"wire2d_mlp (4, 50, 2): output shape "
                             f"{tuple(got['out'].shape)}")
    errs["wire2d_mlp"]["batched"] = compare(
        got, vjp(torch, pair_fn(W2.wire2d_mlp_plain, model.spec, keys),
                 [c] + leaves, g), "wire2d_mlp (4, 50, 2)")
    for name, cases in wire2d_widths(torch, W2, get_inr, get_config,
                                     device).items():
        errs[name].update(cases)
    return errs


def wire2d_measure(torch, W2, get_inr, get_config, device, build):
    """Times of wire2d_step at the denoise shape (n = 65,536, o = 3) and of
    the wire2d_mlp pair at the CT shape (o = 1, parameter gradients, as the
    CT fit calls it): the kernel (a host call, and its kernels' device
    time, by product class), the plain version, the matmul yardstick, and
    the card's least time for the same work (tensor_core_fields)."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    out = {}
    n, L = 256 * 256, 2
    model, params, c, t, gt, _ = wire2d_case(torch, get_inr, n, L, 3, 34,
                                             device)
    spec = model.spec
    h, o = params["first_lin"]["w"].shape[1], 3
    nweights = num_weights(params)
    scratch = StepScratch()

    def step():
        return W2.wire2d_step(params, c, t, spec, gt=gt, want_metrics=True,
                              scratch=scratch)

    lib_err = compare(
        tensors_of(*wire2d_matmul_step(torch, W2, params, c, t, gt, spec)),
        tensors_of(*W2.wire2d_step_plain(params, c, t, spec, gt=gt,
                                         want_metrics=True)),
        "wire2d matmul step vs plain")
    flops = W2.step_flops(n, 2, h, o, L)
    nbytes = 4 * (n * (2 + o + o) + nweights + n * o + nweights + 2)
    res = {
        "ms": cuda_ms(torch, step, 20),
        "kernel_ms": kernel_device_ms(torch, step, 20,
                                      kernel_names("wire2d")),
        "plain_ms": cuda_ms(torch, lambda: W2.wire2d_step_plain(
            params, c, t, spec, gt=gt, want_metrics=True), 10),
        "library_ms": cuda_ms(torch, lambda: wire2d_matmul_step(
            torch, W2, params, c, t, gt, spec), 10),
        "library": "torch.matmul step on the stacked layout, Gabor-2D and "
                   "written-out backward in PyTorch ops",
        "library_vs_plain_max_abs_err": lib_err}
    res.update(tensor_core_fields(torch, build, step, "wire2d_step", flops,
                                  nbytes, res["kernel_ms"], lib="wire2d"))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["wire2d_step"] = res
    del scratch

    o = 1
    model, params, c, _, _, g = wire2d_case(torch, get_inr, n, L, o, 35,
                                            device, wire2d_ct_kw(get_config))
    spec, keys = model.spec, leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    nweights = num_weights(params)
    kfn, pfn = (pair_fn(a, spec, keys)
                for a in (W2.wire2d_mlp, W2.wire2d_mlp_plain))

    def pair():
        return param_vjp(torch, kfn, c, leaves, g)

    def fwd():
        with torch.no_grad():
            kfn(c, *leaves)

    lib = wire2d_matmul_vjp(torch, W2, params, c, spec, lambda y: g)
    got = {"out": lib[0]}
    got.update({f"d{i + 1}": tt for i, (_, tt) in
                enumerate(tree_leaves(lib[1]))})
    want = param_vjp(torch, pfn, c, leaves, g)
    flops = W2.apply_flops(n, 2, h, o, L, dcoords=False)
    nbytes = 4 * (n * 2 + 2 * (n * o + nweights))
    res = {
        "ms": cuda_ms(torch, pair, 20),
        "kernel_ms": kernel_device_ms(torch, pair, 20,
                                      kernel_names("wire2d")),
        "fwd_ms": cuda_ms(torch, fwd, 20),
        "plain_ms": cuda_ms(torch, lambda: param_vjp(torch, pfn, c, leaves,
                                                     g), 10),
        "library_ms": cuda_ms(torch, lambda: wire2d_matmul_vjp(
            torch, W2, params, c, spec, lambda y: g), 10),
        "library": "torch.matmul forward on the stacked layout, Gabor-2D "
                   "and written-out backward in PyTorch ops",
        "library_vs_plain_max_abs_err": max(
            float((got[k] - want[k]).abs().max()) for k in want)}
    res.update(tensor_core_fields(torch, build, pair, "wire2d_mlp", flops,
                                  nbytes, res["kernel_ms"], lib="wire2d"))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["wire2d_mlp"] = res
    return out


def fit_wire2d(torch, np, mods, counters, device):
    """WIRE-2D denoise (300 wide, omega0 7, sigma 8) at the bench protocol
    (256 x 256, measure_np(snr 2, tau 30), 65,536 coordinates, full batch,
    lr 5e-3 scaled by batch) for WIRE2D_ITERS epochs through fit_pointwise:
    once through the kernel, counts reset just before and read just after,
    and once through the plain path (fused='never'), from one init."""
    WS, M, get_inr, FitConfig, fit_pointwise, bench = mods
    im, im_noisy, grid, _ = bench.setup(256, 256)
    H, W, _ = im.shape
    model = get_inr("wire2d", **WIRE2D_DENOISE_KW)
    plain = get_inr("wire2d", fused="never", **WIRE2D_DENOISE_KW)
    params = model.init(torch.Generator().manual_seed(0), device)
    fit_cfg = FitConfig(learning_rate=5e-3, niters=WIRE2D_ITERS,
                        maxpoints=H * W, scale_lr_by_batch=True)
    reset_counts(counters)
    ws0 = WS.wire_step.launches
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                        fit_cfg, gt=im.reshape(-1, 3), device=device)
    launches = read_counts(counters)
    launches["wire_step"] = {"step": WS.wire_step.launches - ws0}
    check_real_launches(launches, "WIRE-2D denoise",
                        {("wire2d", "step"): WIRE2D_ITERS})
    res_plain = fit_pointwise(plain, params, grid, im_noisy.reshape(-1, 3),
                              fit_cfg, gt=im.reshape(-1, 3), device=device)
    if read_counts(counters) != {k: v for k, v in launches.items()
                                 if k != "wire_step"} \
            or WS.wire_step.launches != ws0:
        raise AssertionError("WIRE-2D denoise: the plain fit launched a "
                             "kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H * W, 3)):
            raise AssertionError("WIRE-2D denoise: non-finite values or a "
                                 "wrong shape")
    psnr, psnr_plain = (float(M.psnr_ref(im, r.best_rec.reshape(H, W, 3)))
                        for r in (res, res_plain))
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(
            f"WIRE-2D denoise: kernel fit {psnr:.3f} dB vs plain fit "
            f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_WIRE2D_DB["denoise"] - 0.2
    if not psnr >= floor:
        raise AssertionError(f"WIRE-2D denoise: kernel fit best PSNR "
                             f"{psnr:.3f} dB below the floor {floor} dB")
    return dict(epochs=WIRE2D_ITERS, launches=launches["wire2d"],
                psnr_db=psnr, psnr_plain_db=psnr_plain, floor_db=floor,
                ms_per_step=res.step_ms, plain_ms_per_step=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def fit_wire2d_ct(torch, np, mods, counters, device):
    """WIRE-2D CT (300 wide, preset CT_CONFIG's omega0 3, sigma 12, lr 5e-3)
    at the CT protocol (256 x 256 field, 100 angles, method 'auto' =
    fourier on the card) for WIRE2D_ITERS iterations through fit_operator:
    once through the kernels, counts reset just before and read just after
    (the pair and line_sample's gather and scatter once per iteration), a
    render of the best parameters with no gradient (one forward), and once
    through the plain path, from one init."""
    WS, TR, TCT, M, get_inr, get_config, FitConfig, fit_operator = mods
    cfg = get_config(CT_CONFIG)
    kw = dict(WIRE2D_DENOISE_KW, out_features=1)
    kw.update(wire2d_ct_kw(get_config))
    model = get_inr("wire2d", **kw)
    plain = get_inr("wire2d", fused="never", **kw)
    img = TCT.ct_image(None, 0)
    H, W = img.shape
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    grid = TCT.C.grid2d(H, W)
    params = model.init(torch.Generator().manual_seed(0), device)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=WIRE2D_ITERS,
                        maxpoints=cfg.maxpoints)
    if TR._resolve_auto("auto", len(thetas), "cuda", False) != "fourier":
        raise AssertionError("WIRE-2D CT: 'auto' is not fourier on the card")
    sino = TCT.make_sinogram(img, thetas, radon_method="auto", device=device)
    angles_t = torch.tensor(thetas, device=device)
    reset_counts(counters)
    ws0 = WS.wire_step.launches
    res = fit_operator(model, params, grid, sino,
                       TR.RadonOp(thetas, method="auto"), fit_cfg,
                       gt_field=img, field_shape=(H, W), device=device)
    launches = read_counts(counters)
    launches["wire_step"] = {"step": WS.wire_step.launches - ws0}
    check_real_launches(launches, "WIRE-2D CT",
                        {("wire2d", "forward"): WIRE2D_ITERS,
                         ("wire2d", "backward"): WIRE2D_ITERS,
                         ("line_sample", "gather"): WIRE2D_ITERS,
                         ("line_sample", "scatter"): WIRE2D_ITERS})
    grid_t = torch.tensor(grid, device=device)
    with torch.no_grad():
        render = model.apply(res.best_params, grid_t).reshape(H, W)
    rendered = read_counts(counters)
    if rendered["wire2d"] != dict(launches["wire2d"],
                                  forward=WIRE2D_ITERS + 1):
        raise AssertionError(f"WIRE-2D CT: the render launched "
                             f"{rendered['wire2d']}, expected one forward")
    res_plain = fit_operator(
        plain, params, grid, sino,
        lambda f: TR._radon_fourier(f, angles_t, sampler="plain"), fit_cfg,
        gt_field=img, field_shape=(H, W), device=device)
    if read_counts(counters) != rendered or WS.wire_step.launches != ws0:
        raise AssertionError("WIRE-2D CT: the plain fit launched a kernel")
    render = render.cpu().numpy()
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and np.isfinite(r.mse_noisy).all()
                and r.best_rec.shape == (H, W)):
            raise AssertionError("WIRE-2D CT: non-finite values or a wrong "
                                 "shape")
    if not (np.isfinite(render).all() and render.shape == (H, W)):
        raise AssertionError("WIRE-2D CT: the render is non-finite or has a "
                             "wrong shape")
    psnr = float(M.psnr_ref(img, res.best_rec))
    psnr_plain = float(M.psnr_ref(img, res_plain.best_rec))
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(
            f"WIRE-2D CT: kernel fit {psnr:.3f} dB vs plain fit "
            f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_WIRE2D_DB["ct"] - 0.2
    if not psnr >= floor:
        raise AssertionError(f"WIRE-2D CT: kernel fit best PSNR {psnr:.3f} "
                             f"dB below the floor {floor} dB")
    return dict(iters=WIRE2D_ITERS, radon="fourier",
                launches=launches["wire2d"],
                line_sample=launches["line_sample"], psnr_db=psnr,
                psnr_plain_db=psnr_plain, floor_db=floor,
                render_psnr_db=float(M.psnr_ref(img, render)),
                ssim=float(M.ssim(img, res.best_rec, data_range=1.0)),
                ms_per_iter=res.step_ms, plain_ms_per_iter=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def sweep_expected(task, nonlin, iters):
    """The launches one family's sweep fit of ``iters`` steps must show: its
    step kernel (denoise) or its pair (SISR, CT; CT adds the fourier
    operator's gather and scatter, and one gather for the sinogram)."""
    lib = {"wire": "wire", "mfn": "mfn"}.get(nonlin, "real_mlp")
    if task == "denoise":
        return {("wire_step" if lib == "wire" else lib, "step"): iters}
    pair = "wire_mlp" if lib == "wire" else lib
    want = {(pair, "forward"): iters, (pair, "backward"): iters}
    if task == "ct":
        want.update({("line_sample", "gather"): iters + 1,
                     ("line_sample", "scatter"): iters})
    return want


def sweep_phase(torch, np, SW, WS, counters, device):
    """The sweep app's three tasks for each of the six families, one family
    per call at SWEEP_ITERS iterations, at the sweep's own sizes: the
    launches of each call (counts reset just before, read just after) must
    be its family's kernels and nothing else, the three artifact files of
    each call written, and every metric finite."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for task, run, metric in (("denoise", SW.sweep_denoise, "Best PSNR"),
                                  ("sisr", SW.sweep_sisr, "Best MSE"),
                                  ("ct", SW.sweep_ct, "Best PSNR")):
            out[task] = {}
            for nonlin in SW.NONLINS:
                t0 = time.time()
                rdir = os.path.join(tmp, task, nonlin)
                reset_counts(counters)
                ws0 = WS.wire_step.launches
                res = run(results_dir=rdir, niters=SWEEP_ITERS,
                          nonlins=[nonlin], device=device)[nonlin]
                launches = read_counts(counters)
                launches["wire_step"] = {
                    "step": WS.wire_step.launches - ws0}
                check_real_launches(launches, f"sweep {task} {nonlin}",
                                    sweep_expected(task, nonlin,
                                                   SWEEP_ITERS))
                for suffix in ("_info.mat", "_metrics.mat", "_table.md"):
                    path = os.path.join(rdir, f"{task}_sweep{suffix}")
                    if not os.path.isfile(path):
                        raise AssertionError(f"sweep {task} {nonlin}: "
                                             f"{path} not written")
                values = {k: v for k, v in res.items() if k != "rec"}
                if not (np.isfinite(res["rec"]).all() and all(
                        np.isfinite(v) for v in values.values())):
                    raise AssertionError(f"sweep {task} {nonlin}: a "
                                         f"non-finite metric or field")
                out[task][nonlin] = dict(
                    metric=res[metric], step_ms=res.get("Step (ms)"),
                    launches={k: v for k, v in launches.items()
                              if any(v.values())},
                    wall_s=time.time() - t0)
    return out


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
    from wire_tpu_torch.apps import sweep as SW
    import wire_tpu_torch.ops.mfn as MF
    import wire_tpu_torch.ops.wire2d as W2

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
        got, again = (tensors_of(*WS.wire_step(
            params, coords, target, spec, nvalid=nvalid, denom=denom, gt=gt,
            want_metrics=True)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, again, got, f"wire_step {name}")
        want = WS.wire_step_plain(params, coords, target, spec,
                                  nvalid=nvalid, denom=denom, gt=gt,
                                  want_metrics=True)
        torch.cuda.synchronize()
        cases[name] = compare(got, tensors_of(*want), f"wire_step {name}")
    cases.update(wire_step_widths(torch, WS, get_inr, dev))
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
    errs["repaired"].update(strided_coords(torch, WM, RM, MF, W2, get_inr,
                                           ct_model, dev))
    errs["wire_mlp"].update(wire_mlp_widths(torch, WM, get_inr, dev))
    errs.update(mfn_kernel_vs_plain(torch, MF, get_inr, dev))
    for name, cases in sweep_kernel_vs_plain(torch, np, SW, WS, WM, RM, MM,
                                             MF, dev).items():
        errs[name].update(cases)
    errs.update(wire2d_kernel_vs_plain(torch, W2, get_inr, get_config, dev))
    emit("kernel_vs_plain", t0, max_abs_err=errs, rel_tol=REL_TOL,
         why=("max abs err <= rel_tol x max|plain| per output tensor: fp32 "
              "sums over up to 262,144 rows (wire_*, real_*, mscale2_*, "
              "mfn_*, wire2d_*), 256 rows "
              "(rotsum) taken in another order; line_sample's scatter adds "
              "with atomics in a varying order"),
         reference=("the plain version in fp32 on the same inputs; for "
                    "mscale2_step, the wire2d_mlp CT-frequency width case "
                    "and the real cases of REAL_FLOAT64_CASES the plain "
                    "version run in float64 (every input cast), max|plain| "
                    "its max"))

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
    meas = {"wire_step": dict(
        ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        gflop=flops / 1e9, mbytes=nbytes / 1e6,
        library_vs_plain_max_abs_err=lib_err,
        achieved_tflops=flops / (kernel_ms * 1e9) if kernel_ms else None,
        **tensor_core_fields(torch, build, lambda: WS.wire_step(
            params, coords, target, spec, gt=gt, want_metrics=True,
            scratch=scratch), "wire_step", flops, nbytes, kernel_ms))}
    del scratch, lib_out
    meas.update(ct_measure(torch, WM, R, LS, ct_model, dev, build))
    meas.update(real_measure(torch, SW, RM, MM, model_a, model_b, dev,
                             build))
    meas["mscale2_step"] = mscale2_measure(torch, MS, RM, MM, ms_models[0],
                                           dev, build)
    meas.update(mfn_measure(torch, MF, get_inr, dev, build))
    meas.update(wire2d_measure(torch, W2, get_inr, get_config, dev, build))
    # each GEMM kernel's least time were its fp32 products formed as
    # 3xTF32 on the tensor cores, as wire_mlp's are
    for name, res in meas.items():
        if name not in ("rotsum", "line_sample"):
            res.setdefault("bound_3xtf32_ms", bound_3xtf32(
                res["gflop"] * 1e9, res["mbytes"] * 1e6)[0])
    emit("measure", t0, kernels=meas, nvidia_smi=smi,
         pairs=("ms, plain_ms and library_ms of wire_mlp, rotsum, "
                "line_sample, real_mlp, mfn_mlp and wire2d_mlp time the "
                "forward and its "
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
                "mscale2_step": MS.launches, "mfn": MF.launches,
                "wire2d": W2.launches}
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
    emit("fit_mscale2", t0, **mscale)

    # ---- fit_mfn (MFN denoise, the sweep's problem) -------------------------
    t0 = time.time()
    mfn = fit_mfn(torch, np, (SW, M, get_inr, FitConfig, fit_pointwise),
                  counters, dev)
    emit("fit_mfn", t0, **mfn)

    # ---- fit_mfn_sisr (MFN SISR, the sweep's problem) -----------------------
    t0 = time.time()
    mfn_sisr = fit_mfn_sisr(torch, np, (SW, TS, TF, M, get_inr, FitConfig,
                                        fit_operator), counters, dev)
    if WS.wire_step.launches != ws_before:
        raise AssertionError("the B-spline or MFN fits launched wire_step")
    emit("fit_mfn_sisr", t0, **mfn_sisr)

    # ---- fit_wire2d (WIRE-2D denoise through fit_pointwise) ----------------
    t0 = time.time()
    w2d = fit_wire2d(torch, np, (WS, M, get_inr, FitConfig, fit_pointwise,
                                 bench), counters, dev)
    emit("fit_wire2d", t0, **w2d)

    # ---- fit_wire2d_ct (WIRE-2D CT through fit_operator) -------------------
    t0 = time.time()
    w2d_ct = fit_wire2d_ct(torch, np, (WS, TR, TCT, M, get_inr, get_config,
                                       FitConfig, fit_operator), counters,
                           dev)
    emit("fit_wire2d_ct", t0, **w2d_ct)

    # ---- sweep (the six-family sweep app, every task) -----------------------
    t0 = time.time()
    sweep = sweep_phase(torch, np, SW, WS, counters, dev)
    emit("sweep", t0, iters=SWEEP_ITERS, tasks=sweep)

    # launches of each kernel in the path that runs it: wire_step in the
    # WIRE denoise fit, wire_mlp in both CT fits, line_sample in 'auto'
    # (fourier), rotsum in 'rotate', real_step in the B-spline denoise fit,
    # real_mlp in the B-spline SISR fit, mscale2_step in the mscale_2
    # denoise fit, mfn_step in the MFN denoise fit, mfn_mlp in the MFN SISR
    # fit, wire2d_step in the WIRE-2D denoise fit, wire2d_mlp in the
    # WIRE-2D CT fit; a pair counts both directions
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
        "mscale2_step": {"step": mscale["launches"]["step"]},
        "mfn_step": {"step": mfn["launches"]["step"]},
        "mfn_mlp": {k: mfn_sisr["launches"][k]
                    for k in ("forward", "backward")},
        "wire2d_step": {"step": w2d["launches"]["step"]},
        "wire2d_mlp": {k: w2d_ct["launches"][k]
                       for k in ("forward", "backward")}}
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
        "library_ms": meas[name]["library_ms"],
        **({"sass_hmma": meas[name]["sass_hmma"],
            "bound_fp32_ms": meas[name]["bound_fp32_ms"]}
           if "sass_hmma" in meas[name] else {})}
        for name, (lib, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
