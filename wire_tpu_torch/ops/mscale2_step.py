"""The one-pass train step of bspline_mscale_2 under 'freq_combine': the
hand-written CUDA kernel (``csrc/mscale2_step.cu``) and its plain PyTorch
version.

Replaces wire_tpu/ops/pallas/mscale2_step.py:mscale2_step_fused.  The ns
scales share one canonical trunk (ops/real_mlp.py's form, kinds one per
layer) and differ by gamma_s = inv_scales[s] on every layer's v; the
combiner ``{freq_0: {w (ns o, 128), b}, freq_1: {w (128, o), b}}`` mixes
them per coordinate,

    pred = relu(cat(y_1 .. y_ns) F0 + f0) F1 + f1,

and the loss is ``sum_{rows < nvalid} (pred - target)^2 / denom``.

``mscale2_step`` runs the plain version for CPU tensors and for CUDA
tensors launches the kernel (counter ``launches.mscale2_step.step``) or
raises; there is no fallback.  The kernel's trunk runs on
csrc/real_tc.cuh's chain, its hidden products on the 3xTF32 tensor-core
loop of csrc/wire_tc.cuh with the real epilogue in registers;
``epilogue_map`` models which output each register of a tile holds and
which scale's gamma it takes.  The kernel is held to
``mscale2_step_plain`` run in float64 (every input cast).

``mscale2_step_many`` steps M models of one shape at once (wire_tpu's
many-fitters ``jax.vmap`` the Pallas step over a leading replica axis):
every canonical and combiner leaf carries a leading M, the coordinates and
targets are shared or per replica, and on the card one call is one launch
sequence for all M, replica r's outputs bit-equal to ``mscale2_step`` on
its own inputs; ``mscale2_step_many_plain`` (the plain step per replica)
is its plain version.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wire_tpu_torch import tree
from wire_tpu_torch.nn.models import autodiff_step, mscale2_combine
from wire_tpu_torch.ops import build
from wire_tpu_torch.ops import real_mlp as RM
from wire_tpu_torch.ops.wire_step import StepScratch, _check, shared_nvalid
from wire_tpu_torch.train import profiling

# kernel launches of this module, one per mscale2_step on the card
profiling.count("launches.mscale2_step.step", 0)


def mscale2_step_plain(canon, combiner, coords, target, kinds, inv_scales,
                       *, nvalid=None, denom=None, gt=None,
                       want_metrics=False):
    """The plain step: the canonical trunk over the ns scale blocks stacked
    along the rows with ``row_gamma = (inv_scales, n)`` (as
    ``real_mlp_scales``), the combiner, and autodiff under the masked MSE
    with TF32 off (nn/models.py:autodiff_step), the bases' derivatives the
    explicit dB.  Returns (pred, dcanon, dcombiner[, (sse_target,
    sse_gt)]); denom defaults to n o."""
    n, ns = coords.shape[0], len(inv_scales)
    row_gamma = (tuple(float(g) for g in inv_scales), n)

    def apply(p, x, _spec):
        ys = RM.real_mlp_plain(p["trunk"], x.repeat(ns, 1), kinds, row_gamma)
        return mscale2_combine(p["combiner"], ys.reshape(ns, n, ys.shape[-1]),
                               "freq_combine")

    out = autodiff_step(apply, {"trunk": canon, "combiner": combiner}, coords,
                        target, None, nvalid=nvalid, denom=denom, gt=gt,
                        want_metrics=want_metrics)
    d = out[1]
    return (out[0], d["trunk"], d["combiner"]) + tuple(out[2:])


def step_flops(n, ns, widths, hidden=128):
    """One step as the kernel computes it: ns real_step trunks (the forward,
    the weight gradients and the data gradients but dcoords) and the
    combiner's forward, weight and data gradients.  156.5 GFLOP at the
    path's shape (n = 65,536, ns = 3, widths 2, 256 x 3, 3)."""
    o = widths[-1]
    return (RM.step_flops(ns * n, widths)
            + 3 * 2 * n * (ns * o * hidden + hidden * o))


# csrc/wire_tc.cuh's block tile: 128 rows x 64 columns, 2 x 2 warps of
# 64 x 32, each 4 m16 x 4 n8 mma tiles
TILE_ROWS, TILE_COLS = 128, 64


def epilogue_map(row0, col0, rows_per_block):
    """(rows, cols, blocks): int64 tensors of shape (128, 4, 4, 4), the
    stacked-layout row and column that accumulator register c of n8 tile nt
    of m16 tile mt of thread tid holds (index [tid, mt, nt, c]) in the
    tensor-core tile at (row0, col0) of csrc/real_tc.cuh:real_tc_kernel
    (the plain column map: warp wn's n8 tile nt is columns wn*32 + nt*8
    ..), and the gamma block its epilogue reads for that row, row //
    rows_per_block.  Rows and columns past the layer's are the caller's to
    mask, as the kernel does."""
    tid = torch.arange(128).view(-1, 1, 1, 1)
    mt = torch.arange(4).view(1, -1, 1, 1)
    nt = torch.arange(4).view(1, 1, -1, 1)
    c = torch.arange(4).view(1, 1, 1, -1)
    warp, lane = tid // 32, tid % 32
    wm, wn = warp // 2, warp % 2
    g, t = lane // 4, lane % 4
    rows = (row0 + wm * 64 + mt * 16 + g + 8 * (c // 2)).expand(128, 4, 4, 4)
    cols = (col0 + wn * 32 + nt * 8 + 2 * t + c % 2).expand(128, 4, 4, 4)
    return rows, cols, rows // int(rows_per_block)


# ---- the kernel -------------------------------------------------------------

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("mscale2_step")
    lib.mscale2_step_run.argtypes = ([_INT, _INT, _INT, _PTR, _PTR, _PTR,
                                      _PTR] + [_PTR] * 5 + [_PTR] * 3
                                     + [_PTR] * 5 + [_PTR] * 2 + [_PTR] * 4
                                     + [_PTR] * 3 + [_PTR] * 5
                                     + [_INT, _FLT, _INT] + [_INT] * 3
                                     + [_PTR])
    lib.mscale2_step_run.restype = _INT
    lib.mscale2_trunk_part_floats.argtypes = [_INT, _INT, _PTR]
    lib.mscale2_trunk_part_floats.restype = ctypes.c_longlong
    lib.mscale2_comb_part_floats.argtypes = [_INT, _INT, _INT]
    lib.mscale2_comb_part_floats.restype = ctypes.c_longlong
    for fn in (lib.mscale2_max_cat, lib.mscale2_max_out, lib.mscale2_hidden):
        fn.argtypes = []
        fn.restype = _INT
    lib.mscale2_error_string.argtypes = [_INT]
    lib.mscale2_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=16)
def _device_gammas(inv_scales, device):
    return torch.tensor(inv_scales, dtype=torch.float32, device=device)


@profiling.spanned("wrappers.mscale2_step.step")
def _launch(canon, combiner, coords, target, kinds, inv_scales, nvalid,
            denom, gt, want_metrics, scratch, reps=None):
    """One launch sequence of the step kernel: one model (``reps`` None,
    no leading axis anywhere) or ``reps`` replicas (a leading axis on every
    canonical and combiner leaf; coords (n, d) or (reps, n, d), target and
    gt (n, o) or (reps, n, o), each shared when it has no leading axis)."""
    lib = _lib()
    who = "mscale2_step" if reps is None else "mscale2_step_many"
    dev = coords.device
    n, d = coords.shape[-2:]
    ns = len(inv_scales)
    M = 1 if reps is None else reps
    lead = () if reps is None else (M,)
    widths, alphas, betas, codes = RM._prepare(canon, coords, kinds, who,
                                               max_out=lib.mscale2_max_out(),
                                               reps=reps)
    L, o, hc = len(kinds), widths[-1], lib.mscale2_hidden()
    if ns < 1 or ns * o > lib.mscale2_max_cat():
        raise ValueError(f"{who} kernel supports ns * out_features <= "
                         f"{lib.mscale2_max_cat()}, got {ns} x {o}")
    nv = n if nvalid is None else int(nvalid)
    if not 0 <= nv <= n:
        raise ValueError(f"{who}: nvalid={nv} outside [0, {n}]")
    t_shared = target.ndim == 2
    tshape = (n, o) if t_shared else lead + (n, o)
    _check("target", target, tshape, dev, who)
    if gt is not None:
        _check("gt", gt, tshape, dev, who)
    F0, F1 = combiner["freq_0"]["w"], combiner["freq_1"]["w"]
    f0 = combiner["freq_0"]["b"].reshape(lead + (-1,))
    f1 = combiner["freq_1"]["b"].reshape(lead + (-1,))
    for name, t, shape in (("freq_0.w", F0, (ns * o, hc)),
                           ("freq_0.b", f0, (hc,)),
                           ("freq_1.w", F1, (hc, o)), ("freq_1.b", f1, (o,))):
        _check(f"combiner.{name}", t, lead + shape, dev, who)
    scratch = StepScratch() if scratch is None else scratch
    rows = ns * n
    x_shared = coords.ndim == 2
    xlead = () if x_shared else lead
    x = scratch.get("ms_x", xlead + (rows, d), dev)
    if x_shared:
        x.view(ns, n, d).copy_(coords)
    else:
        x.view(M, ns, n, d).copy_(coords[:, None])
    zs = [scratch.get(f"ms_z{l}", lead + (rows, w), dev)
          for l, w in enumerate(widths[1:-1])]
    acts = [scratch.get(f"ms_a{l}", lead + (rows, w), dev)
            for l, w in enumerate(widths[1:-1])]
    maxw = max(widths[1:-1])
    ystack = scratch.get("ms_y", lead + (rows, o), dev)
    dystack = scratch.get("ms_dy", lead + (rows, o), dev)
    dv = scratch.get("ms_dv", (2, M * rows * maxw), dev)
    zdv = scratch.get("ms_zdv", (M * rows * maxw,), dev)
    wp = RM._ints(widths)
    part = scratch.get("ms_part", (M * lib.mscale2_trunk_part_floats(
        rows, L, wp),), dev)
    cpart = scratch.get("ms_cpart", (M * lib.mscale2_comb_part_floats(
        n, ns, o),), dev)
    wat, wft = RM._transposes(canon, alphas)
    f32 = dict(dtype=torch.float32, device=dev)
    pred = torch.empty(lead + (n, o), **f32)
    gW = [torch.empty(lead + (widths[l] + 1, widths[l + 1]), **f32)
          for l in range(L)]
    galpha = [torch.empty(lead + (w,), **f32) for w in widths[1:-1]]
    gWf = torch.empty(lead + (widths[-2] + 1, o), **f32)
    e0 = (ns * o + 1) * hc
    gcomb = torch.empty(lead + (e0 + (hc + 1) * o,), **f32)
    sse = torch.zeros(lead + (2,), **f32)
    dn = np.float32(n * o if denom is None else denom)
    two_inv_denom = np.float32(2.0) * (np.float32(1.0) / dn)
    with profiling.span("kernels.mscale2_step.step"):
        rc = lib.mscale2_step_run(
            n, ns, L, wp, x.data_ptr(), target.data_ptr(),
            None if gt is None else gt.data_ptr(),
            RM._ptrs([lay["w"] for lay in canon["layers"]]), RM._ptrs(wat),
            RM._ptrs(alphas), RM._ptrs(betas), RM._ptrs(codes),
            canon["final"]["w"].data_ptr(), wft.data_ptr(),
            canon["final"]["b"].reshape(-1).data_ptr(),
            _device_gammas(tuple(float(g) for g in inv_scales),
                           dev).data_ptr(),
            F0.data_ptr(), f0.data_ptr(), F1.data_ptr(), f1.data_ptr(),
            RM._ptrs(zs), RM._ptrs(acts), ystack.data_ptr(),
            dystack.data_ptr(),
            pred.data_ptr(), sse.data_ptr(), RM._ptrs(gW), RM._ptrs(galpha),
            gWf.data_ptr(), gcomb.data_ptr(), cpart.data_ptr(), dv.data_ptr(),
            zdv.data_ptr(), part.data_ptr(), nv, float(two_inv_denom),
            int(want_metrics), M, int(x_shared), int(t_shared),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {rc} "
                           f"({lib.mscale2_error_string(rc).decode()})")
    profiling.count("launches.mscale2_step.step")
    dcanon = RM._grads_to_canon(canon, widths, gW, galpha, gWf)
    c0 = ns * o * hc
    dcombiner = {
        "freq_0": {"w": gcomb[..., :c0].reshape(lead + (ns * o, hc)),
                   "b": gcomb[..., c0:e0].reshape(
                       combiner["freq_0"]["b"].shape)},
        "freq_1": {"w": gcomb[..., e0:e0 + hc * o].reshape(lead + (hc, o)),
                   "b": gcomb[..., e0 + hc * o:].reshape(
                       combiner["freq_1"]["b"].shape)}}
    if want_metrics:
        return pred, dcanon, dcombiner, (sse[..., 0], sse[..., 1])
    return pred, dcanon, dcombiner


def mscale2_step(canon, combiner, coords, target, kinds, inv_scales, *,
                 nvalid=None, denom=None, gt=None, want_metrics=False,
                 scratch=None):
    """One mscale_2 train step (``mscale2_step_fused``): returns (pred,
    dcanon, dcombiner) for ``loss = sum_{rows < nvalid} (pred - target)^2 /
    denom``, plus ``(sse_target, sse_gt)`` when ``want_metrics`` (gt
    defaults to target).  canon: the shared trunk; combiner: ``{freq_0,
    freq_1}``; kinds: one basis kind per trunk layer; inv_scales: gamma per
    scale.  coords (n, d), target (n, o) float32; nvalid (a Python int)
    defaults to n and denom to n o; invalid rows must be a tail.  CPU
    tensors take ``mscale2_step_plain``; CUDA tensors launch the kernel or
    raise.  ``scratch`` (a StepScratch) keeps the kernel's device buffers
    across steps."""
    kinds = RM.norm_kinds(kinds)
    if coords.device.type == "cpu":
        return mscale2_step_plain(canon, combiner, coords, target, kinds,
                                  inv_scales, nvalid=nvalid, denom=denom,
                                  gt=gt, want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"mscale2_step: unsupported device {coords.device}")
    return _launch(canon, combiner, coords, target, kinds, inv_scales,
                   nvalid, denom, gt, want_metrics, scratch)


# ---- the replica axis (the batched multi-fit) -------------------------------

def mscale2_step_many_plain(canon_stack, combiner_stack, coords, target,
                            kinds, inv_scales, *, nvalid=None, denom=None,
                            gt=None, want_metrics=False):
    """The plain version of ``mscale2_step_many``: ``mscale2_step_plain``
    once per replica, its results stacked."""
    kinds = RM.norm_kinds(kinds)
    M = tree.replicas(canon_stack)
    nvalid = shared_nvalid(nvalid, M)

    def rep(x, r):
        return tree.replica(x, r, M)

    outs = [mscale2_step_plain(
        tree.index(canon_stack, r), tree.index(combiner_stack, r),
        rep(coords, r), rep(target, r), kinds, inv_scales, nvalid=nvalid,
        denom=denom, gt=rep(gt, r), want_metrics=want_metrics)
        for r in range(M)]
    stacked = (torch.stack([out[0] for out in outs]),
               tree.stack([out[1] for out in outs]),
               tree.stack([out[2] for out in outs]))
    if want_metrics:
        return stacked + (tuple(torch.stack([out[3][i] for out in outs])
                                for i in range(2)),)
    return stacked


def mscale2_step_many(canon_stack, combiner_stack, coords, target, kinds,
                      inv_scales, *, nvalid=None, denom=None, gt=None,
                      want_metrics=False, scratch=None):
    """M mscale_2 train steps at once: every leaf of ``canon_stack`` and
    ``combiner_stack`` has a leading M; coords (n, d) shared or (M, n, d);
    target and gt (n, o) shared or (M, n, o).  Returns pred (M, n, o), the
    canonical and combiner gradients stacked as their trees and, with
    ``want_metrics``, the SSE sums as two (M,) tensors.  ``nvalid`` and
    ``denom`` are shared (an int, or M equal ints).  CPU tensors take
    ``mscale2_step_many_plain``; on CUDA one launch sequence serves all M
    (``launches.mscale2_step.step`` advances by one) or an error is
    raised."""
    kinds = RM.norm_kinds(kinds)
    if coords.device.type == "cpu":
        return mscale2_step_many_plain(canon_stack, combiner_stack, coords,
                                       target, kinds, inv_scales,
                                       nvalid=nvalid, denom=denom, gt=gt,
                                       want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"mscale2_step_many: unsupported device "
                         f"{coords.device}")
    M = tree.replicas(canon_stack)
    # a vmapped fold may give expanded or strided leaves
    canon_stack = tree.map(lambda t: t.contiguous(), canon_stack)
    combiner_stack = tree.map(lambda t: t.contiguous(), combiner_stack)
    return _launch(canon_stack, combiner_stack, coords.contiguous(),
                   target.contiguous(), kinds, inv_scales,
                   shared_nvalid(nvalid, M), denom,
                   None if gt is None else gt.contiguous(), want_metrics,
                   scratch, reps=M)
