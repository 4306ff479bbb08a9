"""The canonical real MLP of the real INR families: the hand-written CUDA
kernels (``csrc/real_mlp.cu``) and their plain PyTorch versions.

Replaces wire_tpu/ops/pallas/real_mlp.py: ``real_mlp_fused`` (apply and
its VJP with dcoords and an optional per-row-block gamma),
``real_mlp_fused_scales`` and ``real_step_fused`` (the one-pass train
step).  Every family folds its parameters to the canonical dict
``{"layers": [{"w", "alpha", "beta"}, ...], "final": {"w", "b"}}`` and a
tuple of basis kinds, one per layer; a layer computes

    z = a_prev @ w;  v = gamma * (alpha * z + beta);  a = B(v)

(gamma = 1 unless ``row_gamma`` is given) and a final linear follows.  A
kind is a basis name (``BASIS_CODES``) or a tuple of ``(name, width)`` lane
segments; lanes past the segments' total give 0.  The derivatives are the
JAX kernel's explicit ``dB`` (real_mlp.py:47-105), in the kernels and in
the plain versions alike (autograd of ``torch.relu`` would differ from
them at exactly 0); the splines are evaluated piecewise (``_basis``).

``real_mlp`` and ``real_step`` run the plain versions for tensors on the
CPU, and for CUDA tensors launch the kernels or raise; there is no
fallback.  Leading axes of ``coords`` are flattened and restored.  The
kernels keep z and a of every layer for the backward instead of
recomputing them as the TPU kernels do (173 MB at the SISR shape, 403 MB
for the denoise step); a forward with no gradient to take keeps nothing.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wire_tpu_torch.nn.models import autodiff_step
from wire_tpu_torch.ops import build
from wire_tpu_torch.ops.wire_step import StepScratch, _check

BASIS_CODES = {"zero": 0, "qspline": 1, "cspline": 2, "sine": 3, "gauss": 4,
               "relu": 5, "srelu": 6, "identity": 7}

# kernel launches of this module: one "step" per real_step on the card, one
# "forward" and one "backward" per real_mlp pair; a run resets and reads
# them
launches = {"step": 0, "forward": 0, "backward": 0}


# ---- the bases ------------------------------------------------------------

def _r(x):
    return torch.clamp_min(x, 0.0)


def _basis(kind):
    """(B, dB) of a basis name: the functions and explicit derivatives of
    _basis in wire_tpu's real_mlp.py.  The quadratic and cubic splines take
    their piecewise-polynomial form, equal to _basis's sums of shifted relu
    powers and exactly zero outside the support, where those sums cancel
    terms of ~v^2/2 and leave float32 rounding (see csrc/real_mlp.cu)."""
    if kind == "qspline":
        def B(v):
            a = v.abs()
            return torch.where(a < 0.5, 0.75 - v * v, torch.where(
                a < 1.5, 0.5 * (1.5 - a) ** 2, torch.zeros_like(v)))

        def dB(v):
            a = v.abs()
            return torch.where(a < 0.5, -2.0 * v, torch.where(
                a < 1.5, -torch.sign(v) * (1.5 - a), torch.zeros_like(v)))
        return B, dB
    if kind == "cspline":
        def B(v):
            a = v.abs()
            return torch.where(a < 1.0, 2.0 / 3.0 - v * v + 0.5 * a ** 3,
                               torch.where(a < 2.0, (1 / 6) * (2.0 - a) ** 3,
                                           torch.zeros_like(v)))

        def dB(v):
            a = v.abs()
            return torch.where(a < 1.0, -2.0 * v + 1.5 * v * a, torch.where(
                a < 2.0, -0.5 * torch.sign(v) * (2.0 - a) ** 2,
                torch.zeros_like(v)))
        return B, dB
    if kind == "sine":
        return torch.sin, torch.cos
    if kind == "gauss":
        return (lambda v: torch.exp(-v * v),
                lambda v: -2.0 * v * torch.exp(-v * v))
    if kind == "relu":
        return (lambda v: torch.clamp_min(v, 0.0),
                lambda v: (v > 0).to(v.dtype))
    if kind == "srelu":
        def dB(v):
            g = _r(1.0 - v) * _r(v)
            return 2.0 * g * (_r(1.0 - v) * (v > 0).to(v.dtype)
                              - (v < 1.0).to(v.dtype) * _r(v))
        return (lambda v: (_r(1.0 - v) * _r(v)) ** 2, dB)
    if kind == "identity":
        return (lambda v: v), torch.ones_like
    if kind == "zero":
        return torch.zeros_like, torch.zeros_like
    raise ValueError(f"unknown basis {kind!r}; known: {sorted(BASIS_CODES)}")


def _segments(kind, width):
    """[(name, lo, hi)] lane ranges of a layer kind over ``width`` lanes,
    with a 'zero' range for lanes past the segments."""
    if isinstance(kind, str):
        return [(kind, 0, width)]
    out, lo = [], 0
    for name, w in kind:
        out.append((name, lo, min(lo + int(w), width)))
        lo += int(w)
    if lo < width:
        out.append(("zero", lo, width))
    return [s for s in out if s[2] > s[1]]


def norm_kinds(kinds):
    """Kinds as a hashable tuple: names, or tuples of (name, width)."""
    return tuple(k if isinstance(k, str)
                 else tuple((str(name), int(w)) for name, w in k)
                 for k in kinds)


def kind_codes(kind, width):
    """The per-column basis codes of one layer (uint8, ``width``)."""
    codes = np.zeros((width,), np.uint8)
    for name, lo, hi in _segments(kind, width):
        if name not in BASIS_CODES:
            raise ValueError(f"unknown basis {name!r}; known: "
                             f"{sorted(BASIS_CODES)}")
        codes[lo:hi] = BASIS_CODES[name]
    return codes


def _apply_segments(kind, v, which):
    segs = _segments(kind, v.shape[-1])
    if len(segs) == 1:
        return _basis(segs[0][0])[which](v)
    return torch.cat([_basis(name)[which](v[..., lo:hi])
                      for name, lo, hi in segs], dim=-1)


class _Basis(torch.autograd.Function):
    """B(v) whose backward is the explicit dB(v) * grad."""

    @staticmethod
    def forward(ctx, v, kind):
        ctx.save_for_backward(v)
        ctx.kind = kind
        return _apply_segments(kind, v, 0)

    @staticmethod
    def backward(ctx, grad):
        (v,) = ctx.saved_tensors
        return grad * _apply_segments(ctx.kind, v, 1), None


def basis(v, kind):
    """The layer basis B(v) for a kind (a name or lane segments),
    differentiable with the explicit dB."""
    return _Basis.apply(v, kind)


# ---- plain versions ---------------------------------------------------------

def _row_gammas(row_gamma, n, device):
    gammas, rows_per_block = row_gamma
    g = torch.tensor([float(x) for x in gammas], dtype=torch.float32,
                     device=device)
    return g[torch.arange(n, device=device) // int(rows_per_block)][:, None]


def real_mlp_plain(canon, coords, kinds, row_gamma=None):
    """The canonical forward in plain PyTorch ops (autograd differentiates
    it, with the explicit dB): coords (n, d) -> (n, o).  ``row_gamma`` is
    ``(gammas, rows_per_block)``: rows [k b, (k + 1) b) scale v by
    gammas[k]."""
    gamma = None if row_gamma is None else _row_gammas(
        row_gamma, coords.shape[0], coords.device)
    a = coords
    for lay, kind in zip(canon["layers"], kinds):
        v = lay["alpha"] * (a @ lay["w"]) + lay["beta"]
        if gamma is not None:
            v = gamma * v
        a = basis(v, kind)
    return a @ canon["final"]["w"] + canon["final"]["b"]


def canon_leaves(canon):
    """[(path, tensor)] of a canonical dict, in a fixed order."""
    out = []
    for i, lay in enumerate(canon["layers"]):
        out += [(("layers", i, k), lay[k]) for k in ("w", "alpha", "beta")]
    out += [(("final", k), canon["final"][k]) for k in ("w", "b")]
    return out


def canon_from_leaves(leaves, L):
    it = iter(leaves)
    layers = [{k: next(it) for k in ("w", "alpha", "beta")} for _ in range(L)]
    return {"layers": layers, "final": {k: next(it) for k in ("w", "b")}}


def real_step_plain(canon, coords, target, kinds, *, nvalid=None,
                    denom=None, gt=None, want_metrics=False):
    """The plain step: autodiff of ``real_mlp_plain`` under
    ``loss = sum_{rows < nvalid} (pred - target)^2 / denom`` with TF32 off
    (nn/models.py:autodiff_step); returns (pred, dcanon[, (sse_target,
    sse_gt)])."""
    L = len(canon["layers"])
    named = {f"layer_{i}": lay for i, lay in enumerate(canon["layers"])}
    named["final"] = canon["final"]

    def apply(p, x, _spec):
        return real_mlp_plain({"layers": [p[f"layer_{i}"] for i in range(L)],
                               "final": p["final"]}, x, kinds)

    out = autodiff_step(apply, named, coords, target, None, nvalid=nvalid,
                        denom=denom, gt=gt, want_metrics=want_metrics)
    d = out[1]
    dcanon = {"layers": [d[f"layer_{i}"] for i in range(L)],
              "final": d["final"]}
    return (out[0], dcanon) + tuple(out[2:])


# ---- work counts ------------------------------------------------------------

def _widths(canon, d):
    return [d] + [int(lay["w"].shape[1]) for lay in canon["layers"]] + [
        int(canon["final"]["w"].shape[1])]


def forward_flops(n, widths):
    """2 per multiply-add of the forward's products: widths = (d, w_0 ..
    w_{L-1}, o)."""
    return 2 * n * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def step_flops(n, widths):
    """One step as the kernel computes it: the forward, the weight
    gradients (the same products) and the data gradients of every layer but
    the first (no dcoords); bias sums and elementwise work not counted.
    51.98 GFLOP at the denoise shape (n = 65,536, widths 2, 256 x 3, 3)."""
    return 3 * forward_flops(n, widths) - 2 * n * widths[0] * widths[1]


def apply_flops(n, widths):
    """One forward + backward of the pair: the step's products plus dcoords.
    22.41 GFLOP at the SISR shape (n = 28,224)."""
    return step_flops(n, widths) + 2 * n * widths[0] * widths[1]


# ---- the kernels ------------------------------------------------------------

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("real_mlp")
    lib.real_mlp_forward.argtypes = ([_INT, _INT, _PTR, _PTR] + [_PTR] * 4
                                     + [_PTR, _PTR, _PTR, _INT]
                                     + [_PTR, _PTR, _PTR, _PTR])
    lib.real_mlp_backward.argtypes = ([_INT, _INT, _PTR, _PTR, _PTR]
                                      + [_PTR] * 4 + [_PTR, _PTR, _INT]
                                      + [_PTR] * 10)
    lib.real_step_run.argtypes = ([_INT, _INT, _PTR, _PTR, _PTR, _PTR]
                                  + [_PTR] * 5 + [_PTR] * 3 + [_PTR] * 5
                                  + [_PTR] * 6 + [_INT, _FLT, _INT, _PTR])
    for fn in (lib.real_mlp_forward, lib.real_mlp_backward,
               lib.real_step_run):
        fn.restype = _INT
    lib.real_mlp_part_floats.argtypes = [_INT, _INT, _PTR]
    lib.real_mlp_part_floats.restype = ctypes.c_longlong
    lib.real_mlp_max_out.argtypes = []
    lib.real_mlp_max_out.restype = _INT
    lib.real_mlp_basis_code.argtypes = [ctypes.c_char_p]
    lib.real_mlp_basis_code.restype = _INT
    lib.real_mlp_error_string.argtypes = [_INT]
    lib.real_mlp_error_string.restype = ctypes.c_char_p
    for name, code in BASIS_CODES.items():
        if lib.real_mlp_basis_code(name.encode()) != code:
            raise RuntimeError(f"real_mlp: basis code of {name!r} differs "
                               f"between the kernel and the wrapper")
    return lib


def _raise_on(rc, what):
    if rc != 0:
        msg = _lib().real_mlp_error_string(rc).decode()
        raise RuntimeError(f"real_mlp {what} kernel launch failed: CUDA "
                           f"error {rc} ({msg})")


def _ptrs(tensors):
    return (_PTR * len(tensors))(*[None if t is None else t.data_ptr()
                                   for t in tensors])


def _ints(values):
    return (_INT * len(values))(*values)


@functools.lru_cache(maxsize=64)
def _device_codes(kinds, widths, device):
    return tuple(torch.from_numpy(kind_codes(k, w)).to(device)
                 for k, w in zip(kinds, widths))


def _prepare(canon, coords, kinds, who, max_out=None):
    """Checks of the canonical weights against coords (n, d) on the card;
    returns (widths, flat alpha/beta per layer, codes per layer).
    ``max_out``: the calling kernel's limit on o (default real_mlp's)."""
    max_out = _lib().real_mlp_max_out() if max_out is None else max_out
    dev = coords.device
    L = len(canon["layers"])
    if L < 1 or len(kinds) != L:
        raise ValueError(f"{who}: {L} layers and {len(kinds)} kinds; need "
                         f"one kind per layer and at least one layer")
    widths = _widths(canon, coords.shape[1])
    if widths[-1] > max_out:
        raise ValueError(f"{who} kernel supports out_features <= "
                         f"{max_out}, got {widths[-1]}")
    _check("coords", coords, (coords.shape[0], widths[0]), dev, who)
    alphas, betas = [], []
    for l, lay in enumerate(canon["layers"]):
        _check(f"layers[{l}].w", lay["w"], (widths[l], widths[l + 1]), dev,
               who)
        for k, out in (("alpha", alphas), ("beta", betas)):
            t = lay[k].reshape(-1)
            _check(f"layers[{l}].{k}", t, (widths[l + 1],), dev, who)
            out.append(t)
    _check("final.w", canon["final"]["w"], (widths[-2], widths[-1]), dev,
           who)
    _check("final.b", canon["final"]["b"].reshape(-1), (widths[-1],), dev,
           who)
    codes = _device_codes(tuple(kinds), tuple(widths[1:-1]), dev)
    return widths, alphas, betas, codes


def _gamma_args(row_gamma, n, device):
    if row_gamma is None:
        return None, 1
    gammas, rows_per_block = row_gamma
    rows_per_block = int(rows_per_block)
    if rows_per_block < 1 or len(gammas) * rows_per_block < n:
        raise ValueError(f"real_mlp: row_gamma has {len(gammas)} blocks of "
                         f"{rows_per_block} rows for {n} rows")
    return (torch.tensor([float(g) for g in gammas], dtype=torch.float32,
                         device=device), rows_per_block)


def _transposes(canon, alphas):
    """(W_l diag(alpha_l))^T per layer and Wf^T: the backward's data-gradient
    operands (dz = alpha dv is never stored)."""
    wat = [(lay["w"] * a[None, :]).t().contiguous()
           for lay, a in zip(canon["layers"], alphas)]
    return wat, canon["final"]["w"].t().contiguous()


def _grads_to_canon(canon, widths, gW, galpha, gWf):
    layers = []
    for l, lay in enumerate(canon["layers"]):
        k = widths[l]
        layers.append({"w": gW[l][:k],
                       "alpha": galpha[l].reshape(lay["alpha"].shape),
                       "beta": gW[l][k].reshape(lay["beta"].shape)})
    h = widths[-2]
    return {"layers": layers,
            "final": {"w": gWf[:h],
                      "b": gWf[h].reshape(canon["final"]["b"].shape)}}


def _forward(canon, coords, kinds, row_gamma, keep):
    """Launch the pair's forward; returns (pred, zs, acts) with zs and acts
    the saved activations when ``keep``, else None (two ping-pong planes)."""
    lib = _lib()
    dev = coords.device
    n = coords.shape[0]
    widths, alphas, betas, codes = _prepare(canon, coords, kinds, "real_mlp")
    L = len(kinds)
    gammas, rpb = _gamma_args(row_gamma, n, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if keep:
        zs = [torch.empty((n, w), **f32) for w in widths[1:-1]]
        acts = [torch.empty((n, w), **f32) for w in widths[1:-1]]
        act_ptrs = acts
    else:
        zs = [None] * L
        planes = torch.empty((2, n * max(widths[1:-1])), **f32)
        act_ptrs = [planes[l % 2] for l in range(L)]
    pred = torch.empty((n, widths[-1]), **f32)
    _raise_on(lib.real_mlp_forward(
        n, L, _ints(widths), coords.data_ptr(),
        _ptrs([lay["w"] for lay in canon["layers"]]), _ptrs(alphas),
        _ptrs(betas), _ptrs(codes), canon["final"]["w"].data_ptr(),
        canon["final"]["b"].data_ptr(),
        None if gammas is None else gammas.data_ptr(), rpb, _ptrs(zs),
        _ptrs(act_ptrs), pred.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "forward")
    launches["forward"] += 1
    return pred, (zs if keep else None), (acts if keep else None)


class _RealMLP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, coords, kinds, row_gamma, *leaves):
        L = len(kinds)
        canon = canon_from_leaves(leaves, L)
        pred, zs, acts = _forward(canon, coords, kinds, row_gamma, keep=True)
        ctx.save_for_backward(coords, *leaves, *zs, *acts)
        ctx.kinds, ctx.row_gamma = kinds, row_gamma
        return pred

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        kinds, L = ctx.kinds, len(ctx.kinds)
        coords = saved[0]
        nleaves = 3 * L + 2
        canon = canon_from_leaves(saved[1:1 + nleaves], L)
        zs = saved[1 + nleaves:1 + nleaves + L]
        acts = saved[1 + nleaves + L:]
        lib = _lib()
        dev = coords.device
        n = coords.shape[0]
        widths, alphas, betas, codes = _prepare(canon, coords, kinds,
                                                "real_mlp")
        gammas, rpb = _gamma_args(ctx.row_gamma, n, dev)
        g = g.to(torch.float32).contiguous()
        wat, wft = _transposes(canon, alphas)
        f32 = dict(dtype=torch.float32, device=dev)
        gW = [torch.empty((widths[l] + 1, widths[l + 1]), **f32)
              for l in range(L)]
        galpha = [torch.empty((w,), **f32) for w in widths[1:-1]]
        gWf = torch.empty((widths[-2] + 1, widths[-1]), **f32)
        dcoords = torch.empty((n, widths[0]), **f32) \
            if ctx.needs_input_grad[0] else None
        maxw = max(widths[1:-1])
        dv = torch.empty((2, n * maxw), **f32)
        zdv = torch.empty((n * maxw,), **f32)
        wp = _ints(widths)
        part = torch.empty((lib.real_mlp_part_floats(n, L, wp),), **f32)
        _raise_on(lib.real_mlp_backward(
            n, L, wp, coords.data_ptr(), g.data_ptr(), _ptrs(wat),
            _ptrs(alphas), _ptrs(betas), _ptrs(codes), wft.data_ptr(),
            None if gammas is None else gammas.data_ptr(), rpb, _ptrs(zs),
            _ptrs(acts), _ptrs(gW), _ptrs(galpha), gWf.data_ptr(),
            None if dcoords is None else dcoords.data_ptr(), dv.data_ptr(),
            zdv.data_ptr(), part.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "backward")
        launches["backward"] += 1
        dcanon = _grads_to_canon(canon, widths, gW, galpha, gWf)
        return (dcoords, None, None,
                *[t for _, t in canon_leaves(dcanon)])


def real_mlp(canon, coords, kinds, row_gamma=None):
    """The canonical MLP ``coords (..., d) -> (..., o)``, differentiable in
    the canonical tensors and the coordinates (``real_mlp_fused``).
    ``kinds``: one basis kind per layer; ``row_gamma``: ``(gammas,
    rows_per_block)`` or None.  CPU tensors take ``real_mlp_plain``; CUDA
    tensors the kernels: the forward and backward pair when an input needs
    a gradient, else a forward that keeps nothing."""
    lead = coords.shape[:-1]
    c2 = coords.reshape(-1, coords.shape[-1])
    kinds = norm_kinds(kinds)
    if c2.device.type == "cpu":
        out = real_mlp_plain(canon, c2, kinds, row_gamma)
    elif c2.device.type != "cuda":
        raise ValueError(f"real_mlp: unsupported device {c2.device}")
    else:
        c2 = c2.contiguous()  # a strided view survives the reshape
        leaves = [t for _, t in canon_leaves(canon)]
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in [c2] + leaves):
            out = _RealMLP.apply(c2, kinds, row_gamma, *leaves)
        else:
            out, _, _ = _forward(canon, c2, kinds, row_gamma, keep=False)
    return out.reshape(*lead, out.shape[-1])


def real_mlp_scales(canon, coords, kinds, inv_scales):
    """The same canonical trunk at several activation scales in one call
    (``real_mlp_fused_scales``): coords (n, d) are stacked once per scale
    along the rows and block k's v is multiplied by inv_scales[k].  Returns
    (S, n, o); the coordinate gradient sums over the blocks."""
    n = coords.shape[0]
    S = len(inv_scales)
    X = coords.repeat(S, 1)
    out = real_mlp(canon, X, kinds,
                   row_gamma=(tuple(float(g) for g in inv_scales), n))
    return out.reshape(S, n, out.shape[-1])


def _launch_step(canon, coords, target, kinds, nvalid, denom, gt,
                 want_metrics, scratch):
    lib = _lib()
    dev = coords.device
    n = coords.shape[0]
    widths, alphas, betas, codes = _prepare(canon, coords, kinds,
                                            "real_step")
    L = len(kinds)
    o = widths[-1]
    nv = n if nvalid is None else int(nvalid)
    if not 0 <= nv <= n:
        raise ValueError(f"real_step: nvalid={nv} outside [0, {n}]")
    _check("target", target, (n, o), dev, "real_step")
    if gt is not None:
        _check("gt", gt, (n, o), dev, "real_step")
    scratch = StepScratch() if scratch is None else scratch
    zs = [scratch.get(f"real_z{l}", (n, w), dev)
          for l, w in enumerate(widths[1:-1])]
    acts = [scratch.get(f"real_a{l}", (n, w), dev)
            for l, w in enumerate(widths[1:-1])]
    maxw = max(widths[1:-1])
    g = scratch.get("real_g", (n, o), dev)
    dv = scratch.get("real_dv", (2, n * maxw), dev)
    zdv = scratch.get("real_zdv", (n * maxw,), dev)
    wp = _ints(widths)
    part = scratch.get("real_part", (lib.real_mlp_part_floats(n, L, wp),),
                       dev)
    wat, wft = _transposes(canon, alphas)
    f32 = dict(dtype=torch.float32, device=dev)
    pred = torch.empty((n, o), **f32)
    gW = [torch.empty((widths[l] + 1, widths[l + 1]), **f32)
          for l in range(L)]
    galpha = [torch.empty((w,), **f32) for w in widths[1:-1]]
    gWf = torch.empty((widths[-2] + 1, o), **f32)
    sse = torch.zeros((2,), **f32)
    dn = np.float32(n * o if denom is None else denom)
    two_inv_denom = np.float32(2.0) * (np.float32(1.0) / dn)
    _raise_on(lib.real_step_run(
        n, L, wp, coords.data_ptr(), target.data_ptr(),
        None if gt is None else gt.data_ptr(),
        _ptrs([lay["w"] for lay in canon["layers"]]), _ptrs(wat),
        _ptrs(alphas), _ptrs(betas), _ptrs(codes),
        canon["final"]["w"].data_ptr(), wft.data_ptr(),
        canon["final"]["b"].reshape(-1).data_ptr(), _ptrs(zs), _ptrs(acts),
        pred.data_ptr(), g.data_ptr(), sse.data_ptr(), _ptrs(gW),
        _ptrs(galpha), gWf.data_ptr(), dv.data_ptr(), zdv.data_ptr(),
        part.data_ptr(), nv, float(two_inv_denom), int(want_metrics),
        torch.cuda.current_stream(dev).cuda_stream), "step")
    launches["step"] += 1
    dcanon = _grads_to_canon(canon, widths, gW, galpha, gWf)
    if want_metrics:
        return pred, dcanon, (sse[0], sse[1])
    return pred, dcanon


def real_step(canon, coords, target, kinds, *, nvalid=None, denom=None,
              gt=None, want_metrics=False, scratch=None):
    """One train step over the canonical MLP (``real_step_fused``): returns
    (pred, dcanon) for ``loss = sum_{rows < nvalid} (pred - target)^2 /
    denom``, plus ``(sse_target, sse_gt)`` when ``want_metrics`` (gt
    defaults to target).  coords (n, d), target (n, o) float32; nvalid (a
    Python int) defaults to n and denom to n*o; invalid rows must be a
    tail.  CPU tensors take ``real_step_plain``; CUDA tensors launch the
    kernel (``launches["step"]``) or raise.  ``scratch`` (a StepScratch)
    keeps the kernel's device buffers across steps."""
    kinds = norm_kinds(kinds)
    if coords.device.type == "cpu":
        return real_step_plain(canon, coords, target, kinds, nvalid=nvalid,
                               denom=denom, gt=gt, want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"real_step: unsupported device {coords.device}")
    return _launch_step(canon, coords, target, kinds, nvalid, denom, gt,
                        want_metrics, scratch)
