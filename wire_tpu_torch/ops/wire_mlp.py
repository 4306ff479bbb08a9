"""WIRE apply and its VJP: the hand-written CUDA kernels
(``csrc/wire_mlp.cu``) and their plain PyTorch version.

Replaces wire_tpu/ops/pallas/wire_mlp.py:wire_mlp_fused, the model path of
every operator fit: a forward kernel and a backward kernel that takes the
caller's output cotangent g (n, o) and returns every parameter gradient and
dcoords (n, d); the final layer's ``bi`` gets zero, since the model keeps
only the real output.  The pair is a ``torch.autograd.Function``.

Unlike the TPU kernel, the backward does not recompute the forward: the
forward's activations (acts (L+1, n, 2h), zs (L, n, 2h), z1 (n, h); 0.61 GB
at the CT shape n = 65,536, h = 212, L = 2) are saved for it, which costs
far less device time than a second forward (see ``csrc/wire_mlp.cu``).
When no input needs a gradient the forward keeps nothing: it runs through
two ping-pong activation planes (0.22 GB at the CT shape).

The hidden layers' products run on the tensor cores at fp32 accuracy
(3xTF32, ``csrc/wire_tc.cuh``).  ``tf32_round``, ``matmul_3xtf32_plain``
and ``paired_tile_columns`` model on the CPU what the kernel does: the
operand split and the order of its products, and the column pairing of
its staged tiles.  The tests use them; the main path never does.

``wire_mlp`` runs the plain version for tensors on the CPU, and for CUDA
tensors launches the kernels or raises; there is no fallback.  Leading
axes of ``coords`` are flattened and restored, as the JAX entry does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from wire_tpu_torch.nn.models import wire_apply_plain
from wire_tpu_torch.ops import build
from wire_tpu_torch.ops.wire_step import _check, stack_params, unstack_grads

# kernel launches of this module, by direction: a run resets and reads them
launches = {"forward": 0, "backward": 0}

wire_mlp_plain = wire_apply_plain


def apply_flops(n, d, h, o, L):
    """Multiply-add FLOPs of one forward + backward as the kernels compute
    them (2 per MAC): forward, data gradient, weight and bias gradients and
    dcoords, no padding."""
    h2 = 2 * h
    fwd = 2 * n * (d * h + L * h2 * h2 + h2 * o)
    data = 2 * n * (o * h2 + L * h2 * h2 + d * h)
    weight = 2 * n * ((d + 1) * h + L * (h2 + 1) * h2 + (h2 + 1) * o)
    return fwd + data + weight


# complex units of one paired tile of the tensor-core loop
# (csrc/wire_tc.cuh:kUnits): its re columns, then their im columns
PAIRED_TILE_UNITS = 32


def tf32_round(x):
    """float32 -> the nearest TF32 value, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: 13 mantissa bits dropped, non-finite
    values kept."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    finite = (bits & 0x7F800000) != 0x7F800000
    out = torch.where(finite, (bits + 0x1000) & 0xFFFFE000, bits)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def matmul_3xtf32_plain(a, b):
    """a (m, K) @ b (K, N) in float32 as the tensor-core loop forms it:
    each operand split into big = tf32(x) and small = tf32(x - big), and,
    per 8-deep slice of K in order, small @ big, big @ small and big @ big
    added to an fp32 sum (each product of two TF32 values is exact in
    fp32).  small @ small is dropped."""
    ab, bb = tf32_round(a), tf32_round(b)
    asm, bsm = tf32_round(a - ab), tf32_round(b - bb)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        out += asm[:, s] @ bb[s]
        out += ab[:, s] @ bsm[s]
        out += ab[:, s] @ bb[s]
    return out


def paired_tile_columns(h, units=PAIRED_TILE_UNITS):
    """(tiles, 2 units) int64: the stacked-layout column (of 2h) that each
    staged column of each paired tile holds, -1 where the tile runs past
    h.  Tile u stages the re columns of units u*units .. and then their
    im columns h + u*units ..; so staged columns c and units + c hold a
    unit's (j, h + j)."""
    tiles = -(-h // units)
    unit = torch.arange(tiles)[:, None] * units + torch.arange(units)
    cols = torch.cat([unit, h + unit], dim=1)
    return torch.where(torch.cat([unit, unit], dim=1) < h, cols,
                       torch.full_like(cols, -1))


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("wire_mlp")
    lib.wire_mlp_forward.argtypes = [_PTR] * 11 + [_INT] * 5 + [_FLT] * 3 \
        + [_PTR]
    lib.wire_mlp_forward.restype = _INT
    lib.wire_mlp_forward_nograd.argtypes = [_PTR] * 9 + [_INT] * 5 \
        + [_FLT] * 3 + [_PTR]
    lib.wire_mlp_forward_nograd.restype = _INT
    lib.wire_mlp_backward.argtypes = [_PTR] * 15 + [_INT] * 5 + [_FLT] * 3 \
        + [_PTR]
    lib.wire_mlp_backward.restype = _INT
    lib.wire_mlp_part_floats.argtypes = [_INT] * 4
    lib.wire_mlp_part_floats.restype = ctypes.c_longlong
    lib.wire_mlp_max_out.argtypes = []
    lib.wire_mlp_max_out.restype = _INT
    lib.wire_mlp_error_string.argtypes = [_INT]
    lib.wire_mlp_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc, what):
    if rc != 0:
        msg = _lib().wire_mlp_error_string(rc).decode()
        raise RuntimeError(f"wire_mlp {what} kernel launch failed: CUDA "
                           f"error {rc} ({msg})")


def _stacked(params, coords, spec):
    """Checks and the stacked weights for a launch: (lib, w, n, d, h, o,
    L)."""
    lib = _lib()
    dev = coords.device
    n, d = coords.shape
    h = params["first"]["w"].shape[1]
    o = params["final"]["br"].shape[0]
    L = spec.hidden_layers
    if o > lib.wire_mlp_max_out():
        raise ValueError(f"wire_mlp kernel supports out_features <= "
                         f"{lib.wire_mlp_max_out()}, got {o}")
    _check("coords", coords, (n, d), dev, "wire_mlp")
    w = stack_params(params, L)
    for name, shape in (("w1", (d, h)), ("b1", (h,)),
                        ("Wh", (L, 2 * h, 2 * h)), ("Bh", (L, 2 * h)),
                        ("fW", (2 * h, o)), ("fb", (o,))):
        _check(name, w[name], shape, dev, "wire_mlp")
    return lib, w, n, d, h, o, L


def _forward_nograd(params, coords, spec):
    """The forward alone, keeping nothing for a backward: two ping-pong
    activation planes (2, n, 2h) instead of acts, zs and z1."""
    lib, w, n, d, h, o, L = _stacked(params, coords, spec)
    f32 = dict(dtype=torch.float32, device=coords.device)
    pred = torch.empty((n, o), **f32)
    planes = torch.empty((2, n, 2 * h), **f32)
    _raise_on(lib.wire_mlp_forward_nograd(
        *[t.data_ptr() for t in (coords, w["w1"], w["b1"], w["Wh"], w["Bh"],
                                 w["fW"], w["fb"], pred, planes)],
        n, d, h, o, L, float(spec.hidden_omega0), float(spec.scale),
        float(spec.first_omega0),
        torch.cuda.current_stream(coords.device).cuda_stream), "forward")
    launches["forward"] += 1
    return pred


class _WireMLP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, coords, spec, keys, *leaves):
        params = {k: {} for k, _ in keys}
        for (k, kk), leaf in zip(keys, leaves):
            params[k][kk] = leaf
        lib, w, n, d, h, o, L = _stacked(params, coords, spec)
        dev = coords.device
        h2 = 2 * h
        f32 = dict(dtype=torch.float32, device=dev)
        pred = torch.empty((n, o), **f32)
        acts = torch.empty((L + 1, n, h2), **f32)
        zs = torch.empty((L, n, h2), **f32)
        z1 = torch.empty((n, h), **f32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib.wire_mlp_forward(
            *[t.data_ptr() for t in (coords, w["w1"], w["b1"], w["Wh"],
                                     w["Bh"], w["fW"], w["fb"], pred, acts,
                                     zs, z1)],
            n, d, h, o, L, float(spec.hidden_omega0), float(spec.scale),
            float(spec.first_omega0), stream), "forward")
        launches["forward"] += 1
        ctx.save_for_backward(coords, w["w1"], w["WhT"], w["fWT"], acts, zs,
                              z1)
        ctx.spec = spec
        ctx.keys = keys
        ctx.final_bi = params["final"]["bi"]
        return pred

    @staticmethod
    def backward(ctx, g):
        coords, w1, WhT, fWT, acts, zs, z1 = ctx.saved_tensors
        spec = ctx.spec
        lib = _lib()
        dev = coords.device
        n, d = coords.shape
        h = w1.shape[1]
        o = fWT.shape[0]
        L = spec.hidden_layers
        h2 = 2 * h
        g = g.to(torch.float32).contiguous()
        f32 = dict(dtype=torch.float32, device=dev)
        gw1 = torch.empty((d + 1, h), **f32)
        gWh = torch.empty((L, h2 + 1, h2), **f32)
        gfW = torch.empty((h2 + 1, o), **f32)
        # the coordinate gradient only where autograd asks for it (never in
        # a fit, whose coordinates are constants)
        dcoords = torch.empty((n, d), **f32) \
            if ctx.needs_input_grad[0] else None
        dz = torch.empty((2, n, h2), **f32)
        dz1 = torch.empty((n, h), **f32)
        part = torch.empty((lib.wire_mlp_part_floats(n, d, h, o),), **f32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib.wire_mlp_backward(
            *[None if t is None else t.data_ptr()
              for t in (coords, g, w1, WhT, fWT, acts, zs, z1, gw1, gWh,
                        gfW, dcoords, dz, dz1, part)],
            n, d, h, o, L, float(spec.hidden_omega0), float(spec.scale),
            float(spec.first_omega0), stream), "backward")
        launches["backward"] += 1
        dparams = unstack_grads(gw1, gWh, gfW,
                                {"final": {"bi": ctx.final_bi}}, L)
        grads = [dparams[k][kk] for k, kk in ctx.keys]
        return (dcoords, None, None, *grads)


def wire_mlp(params, coords, spec):
    """The WIRE forward ``y = Re(final(...))``, coords (..., d) -> (..., o),
    differentiable in the parameters and the coordinates.  On CUDA the
    forward/backward pair runs when an input needs a gradient, else a
    forward that keeps nothing."""
    if coords.device.type == "cpu":
        return wire_mlp_plain(params, coords, spec)
    if coords.device.type != "cuda":
        raise ValueError(f"wire_mlp: unsupported device {coords.device}")
    lead = coords.shape[:-1]
    # a strided view survives the reshape
    c2 = coords.reshape(-1, coords.shape[-1]).contiguous()
    keys = tuple((k, kk) for k in params for kk in params[k])
    leaves = [params[k][kk] for k, kk in keys]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in [c2] + leaves):
        out = _WireMLP.apply(c2, spec, keys, *leaves)
    else:
        out = _forward_nograd(params, c2, spec)
    return out.reshape(*lead, out.shape[-1])
