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

``real_step_many`` and ``real_mlp_many`` run M models of one shape at once
(wire_tpu's batched fits vmap the Pallas calls over a leading replica
axis): every canonical leaf carries a leading M, the coordinates (and
targets) are shared or per replica, and each call is one launch sequence
for all M with a replica grid axis; replica r's outputs are bit-equal to
the unbatched call on its own inputs.  Their plain versions
(``real_step_many_plain``, ``real_mlp_many_plain``) run the plain version
once per replica and stack the results.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wire_tpu_torch import tree
from wire_tpu_torch.nn.models import autodiff_step
from wire_tpu_torch.ops import build
from wire_tpu_torch.ops.wire_step import StepScratch, _check, shared_nvalid
from wire_tpu_torch.train import profiling

BASIS_CODES = {"zero": 0, "qspline": 1, "cspline": 2, "sine": 3, "gauss": 4,
               "relu": 5, "srelu": 6, "identity": 7}

# kernel launches of this module: one "step" per real_step or
# real_step_many on the card, one "forward" and one "backward" per real_mlp
# or real_mlp_many pair
for _direction in ("step", "forward", "backward"):
    profiling.count(f"launches.real_mlp.{_direction}", 0)


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

def _row_gammas(row_gamma, n, device, dtype=torch.float32):
    """(n, 1): each row's gamma, in ``dtype`` (the coordinates', so a float64
    run takes the gammas in float64 too)."""
    gammas, rows_per_block = row_gamma
    g = torch.tensor([float(x) for x in gammas], dtype=dtype, device=device)
    return g[torch.arange(n, device=device) // int(rows_per_block)][:, None]


def real_mlp_plain(canon, coords, kinds, row_gamma=None):
    """The canonical forward in plain PyTorch ops (autograd differentiates
    it, with the explicit dB): coords (n, d) -> (n, o).  ``row_gamma`` is
    ``(gammas, rows_per_block)``: rows [k b, (k + 1) b) scale v by
    gammas[k]."""
    gamma = None if row_gamma is None else _row_gammas(
        row_gamma, coords.shape[0], coords.device, coords.dtype)
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
    return [d] + [int(lay["w"].shape[-1]) for lay in canon["layers"]] + [
        int(canon["final"]["w"].shape[-1])]


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
                                     + [_PTR, _PTR, _PTR, _INT, _INT, _PTR])
    lib.real_mlp_backward.argtypes = ([_INT, _INT, _PTR, _PTR, _PTR]
                                      + [_PTR] * 4 + [_PTR, _PTR, _INT]
                                      + [_PTR] * 9 + [_INT, _INT, _PTR])
    lib.real_step_run.argtypes = ([_INT, _INT, _PTR, _PTR, _PTR, _PTR]
                                  + [_PTR] * 5 + [_PTR] * 3 + [_PTR] * 5
                                  + [_PTR] * 6 + [_INT, _FLT, _INT]
                                  + [_INT] * 3 + [_PTR])
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


def _prepare(canon, coords, kinds, who, max_out=None, reps=None):
    """Checks of the canonical weights against coords (n, d) on the card;
    returns (widths, flat alpha/beta per layer, codes per layer).
    ``max_out``: the calling kernel's limit on o (default real_mlp's).
    With ``reps``, every canonical leaf leads with reps (alpha and beta
    come back (reps, w)) and coords are (n, d) shared or (reps, n, d)."""
    max_out = _lib().real_mlp_max_out() if max_out is None else max_out
    dev = coords.device
    lead = () if reps is None else (reps,)
    L = len(canon["layers"])
    if L < 1 or len(kinds) != L:
        raise ValueError(f"{who}: {L} layers and {len(kinds)} kinds; need "
                         f"one kind per layer and at least one layer")
    widths = _widths(canon, coords.shape[-1])
    if widths[-1] > max_out:
        raise ValueError(f"{who} kernel supports out_features <= "
                         f"{max_out}, got {widths[-1]}")
    n = coords.shape[-2]
    _check("coords", coords,
           ((n, widths[0]) if coords.ndim == 2 else lead + (n, widths[0])),
           dev, who)
    alphas, betas = [], []
    for l, lay in enumerate(canon["layers"]):
        _check(f"layers[{l}].w", lay["w"],
               lead + (widths[l], widths[l + 1]), dev, who)
        for k, out in (("alpha", alphas), ("beta", betas)):
            t = lay[k].reshape(lead + (-1,))
            _check(f"layers[{l}].{k}", t, lead + (widths[l + 1],), dev, who)
            out.append(t)
    _check("final.w", canon["final"]["w"], lead + (widths[-2], widths[-1]),
           dev, who)
    _check("final.b", canon["final"]["b"].reshape(lead + (-1,)),
           lead + (widths[-1],), dev, who)
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
    operands (dz = alpha dv is never stored); on stacked leaves (alpha
    (M, w)) each replica's, in one op per layer."""
    wat = [(lay["w"] * a[..., None, :]).transpose(-1, -2).contiguous()
           for lay, a in zip(canon["layers"], alphas)]
    return wat, canon["final"]["w"].transpose(-1, -2).contiguous()


def _grads_to_canon(canon, widths, gW, galpha, gWf):
    layers = []
    for l, lay in enumerate(canon["layers"]):
        k = widths[l]
        layers.append({"w": gW[l][..., :k, :],
                       "alpha": galpha[l].reshape(lay["alpha"].shape),
                       "beta": gW[l][..., k, :].reshape(lay["beta"].shape)})
    h = widths[-2]
    return {"layers": layers,
            "final": {"w": gWf[..., :h, :],
                      "b": gWf[..., h, :].reshape(
                          canon["final"]["b"].shape)}}


@profiling.spanned("wrappers.real_mlp.forward")
def _forward(canon, coords, kinds, row_gamma, keep, reps=None):
    """Launch the pair's forward; returns (pred, zs, acts) with zs and acts
    the saved activations when ``keep``, else None (two ping-pong planes).
    ``reps``: the replica layout (canonical leaves with a leading reps,
    coords (n, d) shared or (reps, n, d), pred (reps, n, o))."""
    lib = _lib()
    dev = coords.device
    n = coords.shape[-2]
    M = 1 if reps is None else reps
    lead = () if reps is None else (M,)
    widths, alphas, betas, codes = _prepare(canon, coords, kinds, "real_mlp",
                                            reps=reps)
    L = len(kinds)
    gammas, rpb = _gamma_args(row_gamma, n, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if keep:
        zs = [torch.empty(lead + (n, w), **f32) for w in widths[1:-1]]
        acts = [torch.empty(lead + (n, w), **f32) for w in widths[1:-1]]
        act_ptrs = acts
    else:
        zs = [None] * L
        planes = torch.empty((2, M * n * max(widths[1:-1])), **f32)
        act_ptrs = [planes[l % 2] for l in range(L)]
    pred = torch.empty(lead + (n, widths[-1]), **f32)
    with profiling.span("kernels.real_mlp.forward"):
        _raise_on(lib.real_mlp_forward(
            n, L, _ints(widths), coords.data_ptr(),
            _ptrs([lay["w"] for lay in canon["layers"]]), _ptrs(alphas),
            _ptrs(betas), _ptrs(codes), canon["final"]["w"].data_ptr(),
            canon["final"]["b"].data_ptr(),
            None if gammas is None else gammas.data_ptr(), rpb, _ptrs(zs),
            _ptrs(act_ptrs), pred.data_ptr(), M, int(coords.ndim == 2),
            torch.cuda.current_stream(dev).cuda_stream), "forward")
    profiling.count("launches.real_mlp.forward")
    return pred, (zs if keep else None), (acts if keep else None)


class _RealMLP(torch.autograd.Function):
    """The pair for one model (``reps`` None) or ``reps`` replicas."""

    @staticmethod
    def forward(ctx, coords, kinds, row_gamma, reps, *leaves):
        L = len(kinds)
        canon = canon_from_leaves(leaves, L)
        pred, zs, acts = _forward(canon, coords, kinds, row_gamma, keep=True,
                                  reps=reps)
        ctx.save_for_backward(coords, *leaves, *zs, *acts)
        ctx.kinds, ctx.row_gamma, ctx.reps = kinds, row_gamma, reps
        return pred

    @staticmethod
    @profiling.spanned("wrappers.real_mlp.backward")
    def backward(ctx, g):
        saved = ctx.saved_tensors
        kinds, L, reps = ctx.kinds, len(ctx.kinds), ctx.reps
        M = 1 if reps is None else reps
        lead = () if reps is None else (M,)
        coords = saved[0]
        nleaves = 3 * L + 2
        canon = canon_from_leaves(saved[1:1 + nleaves], L)
        zs = saved[1 + nleaves:1 + nleaves + L]
        acts = saved[1 + nleaves + L:]
        lib = _lib()
        dev = coords.device
        n = coords.shape[-2]
        widths, alphas, betas, codes = _prepare(canon, coords, kinds,
                                                "real_mlp", reps=reps)
        gammas, rpb = _gamma_args(ctx.row_gamma, n, dev)
        g = g.to(torch.float32).contiguous()
        wat, wft = _transposes(canon, alphas)
        f32 = dict(dtype=torch.float32, device=dev)
        gW = [torch.empty(lead + (widths[l] + 1, widths[l + 1]), **f32)
              for l in range(L)]
        galpha = [torch.empty(lead + (w,), **f32) for w in widths[1:-1]]
        gWf = torch.empty(lead + (widths[-2] + 1, widths[-1]), **f32)
        # the coordinate gradient only where autograd asks for it (never in
        # a fit, whose coordinates are constants; the replica pair refuses
        # such coordinates before its forward)
        dcoords = torch.empty((n, widths[0]), **f32) \
            if ctx.needs_input_grad[0] else None
        maxw = max(widths[1:-1])
        dv = torch.empty((2, M * n * maxw), **f32)
        zdv = torch.empty((M * n * maxw,), **f32)
        wp = _ints(widths)
        part = torch.empty((M * lib.real_mlp_part_floats(n, L, wp),), **f32)
        with profiling.span("kernels.real_mlp.backward"):
            _raise_on(lib.real_mlp_backward(
                n, L, wp, coords.data_ptr(), g.data_ptr(), _ptrs(wat),
                _ptrs(alphas), _ptrs(betas), _ptrs(codes), wft.data_ptr(),
                None if gammas is None else gammas.data_ptr(), rpb, _ptrs(zs),
                _ptrs(acts), _ptrs(gW), _ptrs(galpha), gWf.data_ptr(),
                None if dcoords is None else dcoords.data_ptr(), dv.data_ptr(),
                zdv.data_ptr(), part.data_ptr(), M, int(coords.ndim == 2),
                torch.cuda.current_stream(dev).cuda_stream), "backward")
        profiling.count("launches.real_mlp.backward")
        dcanon = _grads_to_canon(canon, widths, gW, galpha, gWf)
        return (dcoords, None, None, None,
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
            out = _RealMLP.apply(c2, kinds, row_gamma, None, *leaves)
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


@profiling.spanned("wrappers.real_mlp.step")
def _launch_step(canon, coords, target, kinds, nvalid, denom, gt,
                 want_metrics, scratch, reps=None):
    """One launch sequence of the step kernel: one model (``reps`` None,
    no leading axis anywhere) or ``reps`` replicas (a leading axis on every
    canonical leaf; coords (n, d) or (reps, n, d), target and gt (n, o) or
    (reps, n, o), each shared when it has no leading axis)."""
    lib = _lib()
    who = "real_step" if reps is None else "real_step_many"
    dev = coords.device
    n = coords.shape[-2]
    M = 1 if reps is None else reps
    lead = () if reps is None else (M,)
    widths, alphas, betas, codes = _prepare(canon, coords, kinds, who,
                                            reps=reps)
    L = len(kinds)
    o = widths[-1]
    nv = n if nvalid is None else int(nvalid)
    if not 0 <= nv <= n:
        raise ValueError(f"{who}: nvalid={nv} outside [0, {n}]")
    t_shared = target.ndim == 2
    tshape = (n, o) if t_shared else lead + (n, o)
    _check("target", target, tshape, dev, who)
    if gt is not None:
        _check("gt", gt, tshape, dev, who)
    scratch = StepScratch() if scratch is None else scratch
    zs = [scratch.get(f"real_z{l}", lead + (n, w), dev)
          for l, w in enumerate(widths[1:-1])]
    acts = [scratch.get(f"real_a{l}", lead + (n, w), dev)
            for l, w in enumerate(widths[1:-1])]
    maxw = max(widths[1:-1])
    g = scratch.get("real_g", lead + (n, o), dev)
    dv = scratch.get("real_dv", (2, M * n * maxw), dev)
    zdv = scratch.get("real_zdv", (M * n * maxw,), dev)
    wp = _ints(widths)
    part = scratch.get("real_part",
                       (M * lib.real_mlp_part_floats(n, L, wp),), dev)
    wat, wft = _transposes(canon, alphas)
    f32 = dict(dtype=torch.float32, device=dev)
    pred = torch.empty(lead + (n, o), **f32)
    gW = [torch.empty(lead + (widths[l] + 1, widths[l + 1]), **f32)
          for l in range(L)]
    galpha = [torch.empty(lead + (w,), **f32) for w in widths[1:-1]]
    gWf = torch.empty(lead + (widths[-2] + 1, o), **f32)
    sse = torch.zeros(lead + (2,), **f32)
    dn = np.float32(n * o if denom is None else denom)
    two_inv_denom = np.float32(2.0) * (np.float32(1.0) / dn)
    with profiling.span("kernels.real_mlp.step"):
        _raise_on(lib.real_step_run(
            n, L, wp, coords.data_ptr(), target.data_ptr(),
            None if gt is None else gt.data_ptr(),
            _ptrs([lay["w"] for lay in canon["layers"]]), _ptrs(wat),
            _ptrs(alphas), _ptrs(betas), _ptrs(codes),
            canon["final"]["w"].data_ptr(), wft.data_ptr(),
            canon["final"]["b"].reshape(-1).data_ptr(), _ptrs(zs), _ptrs(acts),
            pred.data_ptr(), g.data_ptr(), sse.data_ptr(), _ptrs(gW),
            _ptrs(galpha), gWf.data_ptr(), dv.data_ptr(), zdv.data_ptr(),
            part.data_ptr(), nv, float(two_inv_denom), int(want_metrics), M,
            int(coords.ndim == 2), int(t_shared),
            torch.cuda.current_stream(dev).cuda_stream), "step")
    profiling.count("launches.real_mlp.step")
    dcanon = _grads_to_canon(canon, widths, gW, galpha, gWf)
    if want_metrics:
        return pred, dcanon, (sse[..., 0], sse[..., 1])
    return pred, dcanon


def real_step(canon, coords, target, kinds, *, nvalid=None, denom=None,
              gt=None, want_metrics=False, scratch=None):
    """One train step over the canonical MLP (``real_step_fused``): returns
    (pred, dcanon) for ``loss = sum_{rows < nvalid} (pred - target)^2 /
    denom``, plus ``(sse_target, sse_gt)`` when ``want_metrics`` (gt
    defaults to target).  coords (n, d), target (n, o) float32; nvalid (a
    Python int) defaults to n and denom to n*o; invalid rows must be a
    tail.  CPU tensors take ``real_step_plain``; CUDA tensors launch the
    kernel (counter ``launches.real_mlp.step``) or raise.  ``scratch`` (a
    StepScratch) keeps the kernel's device buffers across steps."""
    kinds = norm_kinds(kinds)
    if coords.device.type == "cpu":
        return real_step_plain(canon, coords, target, kinds, nvalid=nvalid,
                               denom=denom, gt=gt, want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"real_step: unsupported device {coords.device}")
    return _launch_step(canon, coords, target, kinds, nvalid, denom, gt,
                        want_metrics, scratch)


# ---- the replica axis (the batched multi-fit) -------------------------------

def real_step_many_plain(canon_stack, coords, target, kinds, *, nvalid=None,
                         denom=None, gt=None, want_metrics=False):
    """The plain version of ``real_step_many``: ``real_step_plain`` once per
    replica, its results stacked."""
    kinds = norm_kinds(kinds)
    M = tree.replicas(canon_stack)
    nvalid = shared_nvalid(nvalid, M)

    def rep(x, r):
        return tree.replica(x, r, M)

    outs = [real_step_plain(tree.index(canon_stack, r), rep(coords, r),
                            rep(target, r), kinds, nvalid=nvalid,
                            denom=denom, gt=rep(gt, r),
                            want_metrics=want_metrics) for r in range(M)]
    pred = torch.stack([out[0] for out in outs])
    grads = tree.stack([out[1] for out in outs])
    if want_metrics:
        return pred, grads, tuple(torch.stack([out[2][i] for out in outs])
                                  for i in range(2))
    return pred, grads


def real_step_many(canon_stack, coords, target, kinds, *, nvalid=None,
                   denom=None, gt=None, want_metrics=False, scratch=None):
    """M train steps over the canonical MLP at once: every leaf of
    ``canon_stack`` has a leading M; coords (n, d) shared or (M, n, d);
    target and gt (n, o) shared or (M, n, o).  Returns pred (M, n, o), the
    canonical gradients stacked as ``canon_stack`` and, with
    ``want_metrics``, the SSE sums as two (M,) tensors.  ``nvalid`` and
    ``denom`` are shared (an int, or M equal ints).  CPU tensors take
    ``real_step_many_plain``; on CUDA one launch sequence serves all M
    (``launches.real_mlp.step`` advances by one) or an error is
    raised."""
    kinds = norm_kinds(kinds)
    if coords.device.type == "cpu":
        return real_step_many_plain(canon_stack, coords, target, kinds,
                                    nvalid=nvalid, denom=denom, gt=gt,
                                    want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"real_step_many: unsupported device "
                         f"{coords.device}")
    M = tree.replicas(canon_stack)
    # a vmapped fold may give expanded or strided leaves
    canon_stack = tree.map(lambda t: t.contiguous(), canon_stack)
    return _launch_step(canon_stack, coords.contiguous(),
                        target.contiguous(), kinds, shared_nvalid(nvalid, M),
                        denom, None if gt is None else gt.contiguous(),
                        want_metrics, scratch, reps=M)


def real_mlp_many_plain(canon_stack, coords, kinds, row_gamma=None):
    """The plain version of ``real_mlp_many``: ``real_mlp_plain`` once per
    replica, its results stacked."""
    kinds = norm_kinds(kinds)
    M = tree.replicas(canon_stack)
    outs = []
    for r in range(M):
        c = tree.replica(coords, r, M)
        c2 = c.reshape(-1, c.shape[-1])
        y = real_mlp_plain(tree.index(canon_stack, r), c2, kinds, row_gamma)
        outs.append(y.reshape(*c.shape[:-1], y.shape[-1]))
    return torch.stack(outs)


def real_mlp_many(canon_stack, coords, kinds, row_gamma=None):
    """M canonical MLPs at once: every leaf of ``canon_stack`` has a
    leading M; coords (rows, d) shared by the replicas or (M, ..., rows, d)
    per replica -> (M, ..., rows, o), differentiable in the canonical
    tensors; ``row_gamma`` shared or None.  On CUDA each direction is one
    launch sequence for all M (the pair when a leaf needs a gradient, else
    a forward that keeps nothing); coordinates that require a gradient
    raise."""
    kinds = norm_kinds(kinds)
    if coords.device.type == "cpu":
        return real_mlp_many_plain(canon_stack, coords, kinds, row_gamma)
    if coords.device.type != "cuda":
        raise ValueError(f"real_mlp_many: unsupported device "
                         f"{coords.device}")
    M = tree.replicas(canon_stack)
    if coords.requires_grad:
        raise ValueError("real_mlp_many computes no coordinate gradient (the "
                         "batched fits' coordinates are constants); use "
                         "real_mlp per replica to differentiate in them")
    if coords.ndim == 2:
        c2, out_lead = coords.contiguous(), (M, coords.shape[0])
    else:
        if coords.shape[0] != M:
            raise ValueError(f"real_mlp_many: coords {tuple(coords.shape)} "
                             f"for {M} replicas: expected (rows, d) or "
                             f"({M}, ..., rows, d)")
        out_lead = tuple(coords.shape[:-1])
        c2 = coords.reshape(M, -1, coords.shape[-1]).contiguous()
    leaves = [t.contiguous() for _, t in canon_leaves(canon_stack)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        out = _RealMLP.apply(c2, kinds, row_gamma, M, *leaves)
    else:
        out, _, _ = _forward(canon_from_leaves(leaves,
                                               len(canon_stack["layers"])),
                             c2, kinds, row_gamma, keep=False, reps=M)
    return out.reshape(*out_lead, out.shape[-1])
