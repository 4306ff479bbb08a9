"""WIRE-2D: the hand-written CUDA kernels (``csrc/wire2d.cu``) and their
plain PyTorch versions.

Replaces wire_tpu/ops/pallas/wire2d_step.py: ``wire2d_step_fused`` (the
one-pass train step: forward, masked-MSE loss gradient
``g = 2 mask (y - t) / denom`` with ``mask = row < nvalid``, backward
without dcoords, optional masked SSE sums against target and gt) and
``wire2d_mlp_fused`` (apply and its VJP from the caller's cotangent, with
dcoords: the operator-fit and render path).  Each layer applies two
complex linears, ``lin`` and ``orth``, to one input and activates

    a = exp(1j w lin) exp(-s^2 (|lin|^2 + |orth|^2))

The kernels read the stacked layout of ``stack_params`` (the TPU kernel's
``_pad_params_stacked`` without its 128-lane padding): per hidden layer one
real GEMM ``[ar | ai] (n, 2h) @ W2 (2h, 4h) = [lr | li | or | oi]``.  The
hidden layers' products run on the tensor cores at fp32 accuracy (3xTF32,
``csrc/wire_tc.cuh``, as WIRE's); ``quad_tile_columns`` models on the CPU
how the forward stages a unit's four channels into one thread's registers
(``ops/wire_mlp.py:paired_tile_columns`` the data gradient's pairs).  The
tests use it; the main path never does.

``wire2d_step`` and ``wire2d_mlp`` run the plain versions for tensors on
the CPU, and for CUDA tensors launch the kernels or raise; there is no
fallback.  Leading axes of the pair's ``coords`` are flattened and
restored.  The pair keeps its activations for the backward only when an
input needs a gradient; otherwise its forward runs through two ping-pong
planes and keeps nothing.

``wire2d_step_many`` and ``wire2d_mlp_many`` run M models of one shape at
once (wire_tpu's many-fitters ``jax.vmap`` the Pallas calls over a leading
replica axis): every parameter leaf carries a leading M, the coordinates
and targets are shared or per replica, and on the card one call is one
launch sequence for all M with a replica grid axis, replica r's outputs
bit-equal to the unbatched call on its own inputs.  Their plain versions
(``*_many_plain``) run the plain step or apply per replica.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wire_tpu_torch import tree
from wire_tpu_torch.nn.models import autodiff_step, wire2d_apply_plain
from wire_tpu_torch.ops import build
from wire_tpu_torch.ops.wire_step import StepScratch, _check, shared_nvalid
from wire_tpu_torch.train import profiling

# kernel launches of this module: one "step" per wire2d_step on the card,
# one "forward" and one "backward" per wire2d_mlp pair
for _direction in ("step", "forward", "backward"):
    profiling.count(f"launches.wire2d.{_direction}", 0)


# ---- the stacked layout -----------------------------------------------------

def stack_params(params, L):
    """The layout the kernels read (wire2d_step.py:52-88 without the lane
    padding): w1 = [Wl | Wo] (d, 2h), b1 (2h); per hidden layer
    W2 = [[wr_l, wi_l, wr_o, wi_o], [-wi_l, wr_l, -wi_o, wr_o]] (2h, 4h),
    its transpose W2T, B2 = [br_l | bi_l | br_o | bi_o] (4h), stacked over
    the L layers; fW = [fwr; -fwi] (2h, o), its transpose fWT, fb (o).
    Leaves with a leading replica axis M give the replica layout of the
    kernels (csrc/wire2d.cu): w1 (M, d, 2h), ..., W2 and W2T (L, M, ...),
    B2 (L, M, 4h), layer-major."""
    fl, fo = params["first_lin"], params["first_orth"]
    w1 = torch.cat([fl["w"], fo["w"]], -1)
    h = fl["w"].shape[-1]
    lead = tuple(w1.shape[:-2])
    blocks, biases = [], []
    for i in range(L):
        pl, po = params[f"hidden_{i}_lin"], params[f"hidden_{i}_orth"]
        blocks.append(torch.cat([
            torch.cat([pl["wr"], pl["wi"], po["wr"], po["wi"]], -1),
            torch.cat([-pl["wi"], pl["wr"], -po["wi"], po["wr"]], -1)], -2))
        biases.append(torch.cat([pl["br"], pl["bi"], po["br"], po["bi"]],
                                -1))
    if L:
        W2, B2 = torch.stack(blocks), torch.stack(biases)
    else:
        W2 = w1.new_empty((0, *lead, 2 * h, 4 * h))
        B2 = w1.new_empty((0, *lead, 4 * h))
    f = params["final"]
    fW = torch.cat([f["wr"], -f["wi"]], -2)
    return {"w1": w1.contiguous(),
            "b1": torch.cat([fl["b"], fo["b"]], -1).contiguous(),
            "W2": W2.contiguous(),
            "W2T": W2.transpose(-1, -2).contiguous(),
            "B2": B2.contiguous(), "fW": fW.contiguous(),
            "fWT": fW.transpose(-1, -2).contiguous(),
            "fb": f["br"].contiguous()}


def unstack_grads(gw1, gW2, gfW, final_bi, L):
    """The kernels' stacked gradients back to the parameter tree
    (wire2d_step.py:91-113): gw1 = [dw1; db1] (d + 1, 2h), gW2[l] =
    [dW2; dB2] (2h + 1, 4h), gfW = [dfW; dfb] (2h + 1, o).  W2 aliases each
    complex weight twice (+wr twice, +-wi once each): with G_rc its h x h
    blocks, dwr = G00 + G11 and dwi = G01 - G10 for ``lin``, the same on
    block columns 2 and 3 for ``orth``.  The final layer's bi gets zero
    (the model keeps only the real output); ``final_bi`` gives its shape.
    In the replica layout gw1 is (M, d + 1, 2h), gW2 (L, M, 2h + 1, 4h)
    and gfW (M, 2h + 1, o), and every gradient comes back with the leading
    M."""
    d = gw1.shape[-2] - 1
    h = gw1.shape[-1] // 2
    dparams = {"first_lin": {"w": gw1[..., :d, :h], "b": gw1[..., d, :h]},
               "first_orth": {"w": gw1[..., :d, h:], "b": gw1[..., d, h:]}}
    for i in range(L):
        G, B = gW2[i, ..., :2 * h, :], gW2[i, ..., 2 * h, :]

        def s(r, c):
            return G[..., r * h:(r + 1) * h, c * h:(c + 1) * h]
        dparams[f"hidden_{i}_lin"] = {
            "wr": s(0, 0) + s(1, 1), "wi": s(0, 1) - s(1, 0),
            "br": B[..., :h], "bi": B[..., h:2 * h]}
        dparams[f"hidden_{i}_orth"] = {
            "wr": s(0, 2) + s(1, 3), "wi": s(0, 3) - s(1, 2),
            "br": B[..., 2 * h:3 * h], "bi": B[..., 3 * h:]}
    dparams["final"] = {"wr": gfW[..., :h, :], "wi": -gfW[..., h:2 * h, :],
                        "br": gfW[..., 2 * h, :],
                        "bi": torch.zeros_like(final_bi)}
    return dparams


# ---- plain versions ---------------------------------------------------------

wire2d_mlp_plain = wire2d_apply_plain


def wire2d_step_plain(params, coords, target, spec, *, nvalid=None,
                      denom=None, gt=None, want_metrics=False):
    """The plain step: autodiff of ``wire2d_apply_plain`` under
    ``loss = sum_{rows < nvalid} (pred - target)^2 / denom`` with TF32 off
    (nn/models.py:autodiff_step); returns (pred, dparams[, (sse_target,
    sse_gt)])."""
    return autodiff_step(wire2d_apply_plain, params, coords, target, spec,
                         nvalid=nvalid, denom=denom, gt=gt,
                         want_metrics=want_metrics)


# ---- work counts ------------------------------------------------------------

def step_flops(n, d, h, o, L):
    """2 per multiply-add of one step as the kernel computes it, no
    padding: forward n (d 2h + L 2h 4h + 2h o), data gradient
    n (o 2h + L 4h 2h), weight and bias gradients
    n ((d + 1) 2h + L (2h + 1) 4h + (2h + 1) o).  142.3 GFLOP at the
    denoise shape (n = 65,536, d = 2, h = 150, o = 3, L = 2)."""
    h2, h4 = 2 * h, 4 * h
    fwd = n * (d * h2 + L * h2 * h4 + h2 * o)
    data = n * (o * h2 + L * h4 * h2)
    weight = n * ((d + 1) * h2 + L * (h2 + 1) * h4 + (h2 + 1) * o)
    return 2 * (fwd + data + weight)


def apply_flops(n, d, h, o, L, dcoords=True):
    """One forward + backward of the pair: the step's products, and with
    ``dcoords`` dz1 (n, 2h) @ w1^T.  142.0 GFLOP at the CT shape
    (n = 65,536, h = 150, o = 1, L = 2) without dcoords, as a fit calls
    it."""
    return step_flops(n, d, h, o, L) + (2 * n * 2 * h * d if dcoords else 0)


# ---- the forward's column map ----------------------------------------------

# units of one quad tile of the tensor-core loop (csrc/wire_tc.cuh:
# kQuadUnits): channel c of unit u in staged column QUAD_TILE_UNITS c + u
QUAD_TILE_UNITS = 16


def quad_tile_columns(h, units=QUAD_TILE_UNITS):
    """(tiles, 4 units) int64: the stacked-layout column (of 4h) that each
    staged column of each quad tile of the forward holds, -1 where the tile
    runs past h.  Tile q stages channel c (lr, li, or, oi) of units
    q*units .. in columns c*units ..; so staged columns u, units + u,
    2 units + u and 3 units + u hold a unit's (j, h + j, 2h + j, 3h + j)."""
    tiles = -(-h // units)
    unit = torch.arange(tiles)[:, None] * units + torch.arange(units)
    cols = torch.cat([c * h + unit for c in range(4)], dim=1)
    return torch.where(unit.repeat(1, 4) < h, cols, torch.full_like(cols, -1))


# ---- the kernels ------------------------------------------------------------

# in_features the kernels take: the first layer's weight gradient has the
# coordinates as its narrow operand (csrc/wire_tc.cuh:kNarrowMax)
MAX_IN = 8

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float
# (n, d, h, o, L, omega0, sigma0, first_omega0)
_DIMS = [_INT] * 5 + [_FLT] * 3
# (reps, coords_shared)
_REPS = [_INT] * 2


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("wire2d")
    lib.wire2d_step_run.argtypes = ([_PTR] * 23 + _DIMS + [_INT, _FLT, _INT]
                                    + _REPS + [_INT, _PTR])
    lib.wire2d_forward.argtypes = [_PTR] * 11 + _DIMS + _REPS + [_PTR]
    lib.wire2d_forward_nograd.argtypes = [_PTR] * 9 + _DIMS + _REPS + [_PTR]
    lib.wire2d_backward.argtypes = [_PTR] * 15 + _DIMS + _REPS + [_PTR]
    for fn in (lib.wire2d_step_run, lib.wire2d_forward,
               lib.wire2d_forward_nograd, lib.wire2d_backward):
        fn.restype = _INT
    lib.wire2d_part_floats.argtypes = [_INT] * 4
    lib.wire2d_part_floats.restype = ctypes.c_longlong
    lib.wire2d_max_out.argtypes = []
    lib.wire2d_max_out.restype = _INT
    lib.wire2d_error_string.argtypes = [_INT]
    lib.wire2d_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc, what):
    if rc != 0:
        msg = _lib().wire2d_error_string(rc).decode()
        raise RuntimeError(f"wire2d {what} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


class _Net:
    """The checked, stacked weights of one WIRE-2D (``reps`` None) or of
    ``reps`` replicas (a leading axis on every leaf; coords (n, d) shared
    or (reps, n, d)) on the card; ``dims`` the C entry points' shape and
    frequency arguments, ``rep_args`` their replica arguments."""

    def __init__(self, params, coords, spec, who, reps=None):
        lib = _lib()
        dev = coords.device
        lead = () if reps is None else (reps,)
        n, d = coords.shape[-2:]
        h = int(params["first_lin"]["w"].shape[-1])
        o = int(params["final"]["br"].shape[-1])
        L = spec.hidden_layers
        if o > lib.wire2d_max_out():
            raise ValueError(f"{who} kernel supports out_features <= "
                             f"{lib.wire2d_max_out()}, got {o}")
        if d > MAX_IN:
            raise ValueError(f"{who} kernel supports in_features <= "
                             f"{MAX_IN}, got {d}")
        shared = coords.ndim == 2
        _check("coords", coords, (n, d) if shared else lead + (n, d), dev,
               who)
        w = stack_params(params, L)
        for name, shape in (("w1", lead + (d, 2 * h)), ("b1", lead + (2 * h,)),
                            ("W2", (L,) + lead + (2 * h, 4 * h)),
                            ("B2", (L,) + lead + (4 * h,)),
                            ("fW", lead + (2 * h, o)), ("fb", lead + (o,))):
            _check(name, w[name], shape, dev, who)
        self.w = w
        self.n, self.d, self.h, self.o, self.L = n, d, h, o, L
        self.M, self.lead = 1 if reps is None else reps, lead
        self.final_bi = params["final"]["bi"]
        self.dims = _dims(n, d, h, o, L, spec)
        self.rep_args = [self.M, int(shared)]


def _dims(n, d, h, o, L, spec):
    return [n, d, h, o, L, float(spec.hidden_omega0), float(spec.scale),
            float(spec.first_omega0)]


def _grad_buffers(d, h, o, L, dev, lead=()):
    """Empty gradient buffers in the kernels' layout: gw1 (d + 1, 2h),
    gW2 (L, 2h + 1, 4h), gfW (2h + 1, o), each replica's with ``lead``."""
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(lead + (d + 1, 2 * h), **f32),
            torch.empty((L,) + lead + (2 * h + 1, 4 * h), **f32),
            torch.empty(lead + (2 * h + 1, o), **f32))


def _ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


@profiling.spanned("wrappers.wire2d.forward")
def _forward(params, coords, spec, keep, reps=None):
    """Launch the pair's forward; returns (pred, net, saved): the
    activations the backward reads (acts (L + 1, n, 2h), zs (L, n, 4h),
    z1 (n, 2h)) when ``keep``, else None (the chain runs through two
    ping-pong planes (2, n, 2h)).  ``reps``: the replica layout (every
    leaf and activation with a leading reps after its layer axis, pred
    (reps, n, o))."""
    lib = _lib()
    net = _Net(params, coords, spec,
               "wire2d_mlp" if reps is None else "wire2d_mlp_many", reps)
    n, h, L, w, lead = net.n, net.h, net.L, net.w, net.lead
    f32 = dict(dtype=torch.float32, device=coords.device)
    pred = torch.empty(lead + (n, net.o), **f32)
    weights = [coords, w["w1"], w["b1"], w["W2"], w["B2"], w["fW"], w["fb"]]
    if keep:
        saved = (torch.empty((L + 1,) + lead + (n, 2 * h), **f32),
                 torch.empty((L,) + lead + (n, 4 * h), **f32),
                 torch.empty(lead + (n, 2 * h), **f32))
        with profiling.span("kernels.wire2d.forward"):
            rc = lib.wire2d_forward(*_ptrs(weights + [pred, *saved]),
                                    *net.dims, *net.rep_args,
                                    _stream(coords.device))
    else:
        saved = None
        planes = torch.empty((2,) + lead + (n, 2 * h), **f32)
        with profiling.span("kernels.wire2d.forward"):
            rc = lib.wire2d_forward_nograd(*_ptrs(weights + [pred, planes]),
                                           *net.dims, *net.rep_args,
                                           _stream(coords.device))
    _raise_on(rc, "forward")
    profiling.count("launches.wire2d.forward")
    return pred, net, saved


class _Wire2dMLP(torch.autograd.Function):
    """The pair for one model (``reps`` None) or ``reps`` replicas."""

    @staticmethod
    def forward(ctx, coords, spec, paths, reps, *leaves):
        pred, net, (acts, zs, z1) = _forward(tree.unflatten(paths, leaves),
                                             coords, spec, keep=True,
                                             reps=reps)
        w = net.w
        ctx.save_for_backward(coords, w["w1"], w["W2T"], w["fWT"],
                              net.final_bi, acts, zs, z1)
        ctx.spec, ctx.paths, ctx.reps = spec, paths, reps
        return pred

    @staticmethod
    @profiling.spanned("wrappers.wire2d.backward")
    def backward(ctx, g):
        coords, w1, W2T, fWT, final_bi, acts, zs, z1 = ctx.saved_tensors
        spec = ctx.spec
        reps = ctx.reps
        M = 1 if reps is None else reps
        lead = () if reps is None else (M,)
        lib = _lib()
        dev = coords.device
        n, d = coords.shape[-2:]
        h = w1.shape[-1] // 2
        o = fWT.shape[-2]
        L = spec.hidden_layers
        g = g.to(torch.float32).contiguous()
        _check("cotangent", g, lead + (n, o), dev, "wire2d_mlp")
        f32 = dict(dtype=torch.float32, device=dev)
        gw1, gW2, gfW = _grad_buffers(d, h, o, L, dev, lead)
        # the coordinate gradient only where autograd asks for it (never in
        # a fit, whose coordinates are constants; the replica pair refuses
        # such coordinates before its forward)
        dcoords = torch.empty((n, d), **f32) \
            if ctx.needs_input_grad[0] else None
        dz = torch.empty((min(L, 2),) + lead + (n, 4 * h), **f32)
        dz1 = torch.empty(lead + (n, 2 * h), **f32)
        part = torch.empty((M * lib.wire2d_part_floats(n, d, h, o),), **f32)
        with profiling.span("kernels.wire2d.backward"):
            _raise_on(lib.wire2d_backward(
                *_ptrs([coords, g, w1, W2T, fWT, acts, zs, z1, gw1, gW2, gfW,
                        dcoords, dz, dz1, part]),
                *_dims(n, d, h, o, L, spec), M, int(coords.ndim == 2),
                _stream(dev)), "backward")
        profiling.count("launches.wire2d.backward")
        by_path = dict(tree.leaves(unstack_grads(gw1, gW2, gfW, final_bi,
                                                 L)))
        return (dcoords, None, None, None, *[by_path[p] for p in ctx.paths])


def wire2d_mlp(params, coords, spec):
    """The WIRE-2D ``coords (..., d) -> (..., o)``, differentiable in the
    parameters and the coordinates (``wire2d_mlp_fused``).  CPU tensors
    take ``wire2d_mlp_plain``; CUDA tensors the kernels: the forward and
    backward pair when an input needs a gradient, else a forward that keeps
    nothing."""
    lead = coords.shape[:-1]
    c2 = coords.reshape(-1, coords.shape[-1])
    if c2.device.type == "cpu":
        out = wire2d_mlp_plain(params, c2, spec)
    elif c2.device.type != "cuda":
        raise ValueError(f"wire2d_mlp: unsupported device {c2.device}")
    else:
        c2 = c2.contiguous()  # a strided view survives the reshape
        flat = tree.leaves(params)
        paths = tuple(p for p, _ in flat)
        leaves = [t for _, t in flat]
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in [c2] + leaves):
            out = _Wire2dMLP.apply(c2, spec, paths, None, *leaves)
        else:
            out, _, _ = _forward(params, c2, spec, keep=False)
    return out.reshape(*lead, out.shape[-1])


@profiling.spanned("wrappers.wire2d.step")
def _launch_step(params, coords, target, spec, nvalid, denom, gt,
                 want_metrics, scratch, reps=None):
    """One launch sequence of the step kernel: one model (``reps`` None,
    no leading axis anywhere) or ``reps`` replicas (a leading axis on every
    leaf; coords (n, d) or (reps, n, d), target and gt (n, o) or (reps,
    n, o), each shared when it has no leading axis)."""
    lib = _lib()
    who = "wire2d_step" if reps is None else "wire2d_step_many"
    net = _Net(params, coords, spec, who, reps)
    dev = coords.device
    n, d, h, o, L, w = net.n, net.d, net.h, net.o, net.L, net.w
    M, lead = net.M, net.lead
    nv = n if nvalid is None else int(nvalid)
    if not 0 <= nv <= n:
        raise ValueError(f"{who}: nvalid={nv} outside [0, {n}]")
    t_shared = target.ndim == 2
    tshape = (n, o) if t_shared else lead + (n, o)
    _check("target", target, tshape, dev, who)
    if gt is not None:
        _check("gt", gt, tshape, dev, who)
    scratch = StepScratch() if scratch is None else scratch

    def get(name, shape):
        return scratch.get(name, shape, dev)

    acts = get("wire2d_acts", (L + 1,) + lead + (n, 2 * h))
    zs = get("wire2d_zs", (max(L, 1),) + lead + (n, 4 * h))
    z1 = get("wire2d_z1", lead + (n, 2 * h))
    g = get("wire2d_g", lead + (n, o))
    dz = get("wire2d_dz", (max(min(L, 2), 1),) + lead + (n, 4 * h))
    dz1 = get("wire2d_dz1", lead + (n, 2 * h))
    part = get("wire2d_part", (M * lib.wire2d_part_floats(n, d, h, o),))
    f32 = dict(dtype=torch.float32, device=dev)
    pred = torch.empty(lead + (n, o), **f32)
    gw1, gW2, gfW = _grad_buffers(d, h, o, L, dev, lead)
    sse = torch.zeros(lead + (2,), **f32)
    dn = np.float32(n * o if denom is None else denom)
    two_inv_denom = np.float32(2.0) * (np.float32(1.0) / dn)
    with profiling.span("kernels.wire2d.step"):
        _raise_on(lib.wire2d_step_run(
            *_ptrs([coords, target, gt, w["w1"], w["b1"], w["W2"],
                    w["W2T"], w["B2"], w["fW"], w["fWT"], w["fb"], pred, gw1,
                    gW2, gfW, sse, acts, zs, z1, g, dz, dz1, part]),
            *net.dims, nv, float(two_inv_denom), int(want_metrics),
            *net.rep_args, int(t_shared), _stream(dev)), "step")
    profiling.count("launches.wire2d.step")
    dparams = unstack_grads(gw1, gW2, gfW, net.final_bi, L)
    if want_metrics:
        return pred, dparams, (sse[..., 0], sse[..., 1])
    return pred, dparams


def wire2d_step(params, coords, target, spec, *, nvalid=None, denom=None,
                gt=None, want_metrics=False, scratch=None):
    """One WIRE-2D train step (``wire2d_step_fused``): returns (pred,
    dparams) for ``loss = sum_{rows < nvalid} (pred - target)^2 / denom``,
    plus ``(sse_target, sse_gt)`` when ``want_metrics`` (gt defaults to
    target).  coords (n, d), target (n, o) float32; nvalid (a Python int)
    defaults to n and denom to n*o; invalid rows must be a tail.  CPU
    tensors take ``wire2d_step_plain``; CUDA tensors launch the kernel
    (counter ``launches.wire2d.step``) or raise.  ``scratch`` (a
    StepScratch) keeps the kernel's device buffers across steps."""
    if coords.device.type == "cpu":
        return wire2d_step_plain(params, coords, target, spec, nvalid=nvalid,
                                 denom=denom, gt=gt,
                                 want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"wire2d_step: unsupported device {coords.device}")
    return _launch_step(params, coords, target, spec, nvalid, denom, gt,
                        want_metrics, scratch)


# ---- the replica axis (the batched multi-fit) -------------------------------

def wire2d_step_many_plain(params_stack, coords, target, spec, *,
                           nvalid=None, denom=None, gt=None,
                           want_metrics=False):
    """The plain version of ``wire2d_step_many``: ``wire2d_step_plain``
    once per replica, its results stacked."""
    M = tree.replicas(params_stack)
    nvalid = shared_nvalid(nvalid, M)

    def rep(x, r):
        return tree.replica(x, r, M)

    outs = [wire2d_step_plain(tree.index(params_stack, r), rep(coords, r),
                              rep(target, r), spec, nvalid=nvalid,
                              denom=denom, gt=rep(gt, r),
                              want_metrics=want_metrics) for r in range(M)]
    pred = torch.stack([out[0] for out in outs])
    grads = tree.stack([out[1] for out in outs])
    if want_metrics:
        return pred, grads, tuple(torch.stack([out[2][i] for out in outs])
                                  for i in range(2))
    return pred, grads


def wire2d_step_many(params_stack, coords, target, spec, *, nvalid=None,
                     denom=None, gt=None, want_metrics=False, scratch=None):
    """M WIRE-2D train steps at once: every leaf of ``params_stack`` has a
    leading M; coords (n, d) shared or (M, n, d); target and gt (n, o)
    shared or (M, n, o).  Returns pred (M, n, o), the gradients stacked as
    the parameters and, with ``want_metrics``, the SSE sums as two (M,)
    tensors.  ``nvalid`` and ``denom`` are shared (an int, or M equal
    ints).  CPU tensors take ``wire2d_step_many_plain``; on CUDA one launch
    sequence serves all M (``launches.wire2d.step`` advances by one) or
    an error is raised."""
    if coords.device.type == "cpu":
        return wire2d_step_many_plain(params_stack, coords, target, spec,
                                      nvalid=nvalid, denom=denom, gt=gt,
                                      want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"wire2d_step_many: unsupported device "
                         f"{coords.device}")
    M = tree.replicas(params_stack)
    return _launch_step(params_stack, coords.contiguous(),
                        target.contiguous(), spec,
                        shared_nvalid(nvalid, M), denom,
                        None if gt is None else gt.contiguous(),
                        want_metrics, scratch, reps=M)


def wire2d_mlp_many_plain(params_stack, coords, spec):
    """The plain version of ``wire2d_mlp_many``: ``wire2d_mlp_plain`` once
    per replica, its results stacked."""
    M = tree.replicas(params_stack)
    return torch.stack([
        wire2d_mlp_plain(tree.index(params_stack, r),
                         tree.replica(coords, r, M), spec) for r in range(M)])


def wire2d_mlp_many(params_stack, coords, spec):
    """M WIRE-2D forwards at once: every leaf of ``params_stack`` has a
    leading M; coords (rows, d) shared by the replicas or (M, ..., rows, d)
    per replica -> (M, ..., rows, o), differentiable in the parameters.
    On CUDA each direction is one launch sequence for all M replicas (the
    pair when a parameter needs a gradient, else a forward that keeps
    nothing); coordinates that require a gradient raise."""
    if coords.device.type == "cpu":
        return wire2d_mlp_many_plain(params_stack, coords, spec)
    if coords.device.type != "cuda":
        raise ValueError(f"wire2d_mlp_many: unsupported device "
                         f"{coords.device}")
    M = tree.replicas(params_stack)
    if coords.requires_grad:
        raise ValueError("wire2d_mlp_many computes no coordinate gradient "
                         "(the batched fits' coordinates are constants); use "
                         "wire2d_mlp per replica to differentiate in them")
    if coords.ndim == 2:
        c2, out_lead = coords.contiguous(), (M, coords.shape[0])
    else:
        if coords.shape[0] != M:
            raise ValueError(f"wire2d_mlp_many: coords "
                             f"{tuple(coords.shape)} for {M} replicas: "
                             f"expected (rows, d) or ({M}, ..., rows, d)")
        out_lead = tuple(coords.shape[:-1])
        c2 = coords.reshape(M, -1, coords.shape[-1]).contiguous()
    flat = tree.leaves(params_stack)
    paths = tuple(p for p, _ in flat)
    leaves = [t for _, t in flat]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        out = _Wire2dMLP.apply(c2, spec, paths, M, *leaves)
    else:
        out, _, _ = _forward(params_stack, c2, spec, keep=False, reps=M)
    return out.reshape(*out_lead, out.shape[-1])
