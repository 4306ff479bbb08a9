"""The Gabor multiplicative filter network (MFN): the hand-written CUDA
kernels (``csrc/mfn.cu``) and their plain PyTorch versions.

Replaces wire_tpu/ops/pallas/mfn_step.py: ``mfn_mlp_fused`` (apply and
its VJP with dcoords, the operator-fit and render path) and
``mfn_step_fused`` (the one-pass train step: forward, masked-MSE loss
gradient with nvalid and denom, backward without dcoords, the SSE sums
against target and gt).  With k = hidden_layers + 1 filters

    g_j(x) = exp(-gamma_j/2 ||x - mu_j||^2) sin(x w_j + b_j)
    z_0 = g_0(x);  z_j = (z_{j-1} W_{j-1} + c_{j-1}) g_j(x)
    y = z_{k-1} W_f + b_f

over the parameters ``gabor_j{w (d, h), b (h), mu (h, d), gamma (h)}``,
``linear_j{w (h, h), b (h)}`` and ``final{w (h, o), b (o)}``.

``mfn_mlp`` and ``mfn_step`` run the plain versions for tensors on the
CPU, and for CUDA tensors launch the kernels or raise; there is no
fallback.  Leading axes of ``coords`` are flattened and restored.  The
kernels keep z_j and l_j = z_{j-1} W_{j-1} + c_{j-1} for the backward and
recompute the filters there from the coordinates (see csrc/mfn.cu); a
forward with no gradient to take keeps nothing.

``mfn_step_many`` and ``mfn_mlp_many`` run M MFNs of one shape at once
(wire_tpu's batched fits vmap the Pallas calls over a leading replica
axis): every parameter leaf carries a leading M, the coordinates (and
targets) are shared or per replica, and each call is one launch sequence
for all M with a replica grid axis; replica r's outputs are bit-equal to
the unbatched call on its own inputs.  Their plain versions
(``mfn_step_many_plain``, ``mfn_mlp_many_plain``) run the plain version
once per replica and stack the results.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wire_tpu_torch import tree
from wire_tpu_torch.nn.models import autodiff_step, mfn_apply_plain
from wire_tpu_torch.ops import build
from wire_tpu_torch.ops.wire_step import StepScratch, _check, shared_nvalid
from wire_tpu_torch.train import profiling

# kernel launches of this module: one "step" per mfn_step or mfn_step_many
# on the card, one "forward" and one "backward" per mfn_mlp or mfn_mlp_many
# pair
for _direction in ("step", "forward", "backward"):
    profiling.count(f"launches.mfn.{_direction}", 0)

FILTER_KEYS = ("w", "b", "mu", "gamma")


# ---- plain versions ---------------------------------------------------------

def mfn_mlp_plain(params, coords, spec):
    """The MFN forward in plain PyTorch ops, ``coords (..., d) -> (..., o)``;
    autograd gives its VJP, dcoords included."""
    return mfn_apply_plain(params, coords, spec)


def mfn_step_plain(params, coords, target, spec, *, nvalid=None,
                   denom=None, gt=None, want_metrics=False):
    """The plain step: autodiff of ``mfn_apply_plain`` under
    ``loss = sum_{rows < nvalid} (pred - target)^2 / denom`` with TF32 off
    (nn/models.py:autodiff_step); returns (pred, dparams[, (sse_target,
    sse_gt)])."""
    return autodiff_step(mfn_apply_plain, params, coords, target, spec,
                         nvalid=nvalid, denom=denom, gt=gt,
                         want_metrics=want_metrics)


# ---- work counts ------------------------------------------------------------

def step_flops(n, d, h, o, k):
    """2 per multiply-add of one step as the kernel computes it: per link
    the forward, weight-gradient and data-gradient products (3 x 2 n h^2,
    k - 1 links), the final layer's three (3 x 2 n h o), and per filter the
    d-contractions x w and x mu^T of the forward and x^T dq and dn^T x of
    the backward (4 x 2 n h d); bias sums and elementwise work not counted.
    72.07 GFLOP at the denoise shape (n = 65,536, d = 2, h = 300, o = 3,
    k = 3)."""
    return (3 * (k - 1) * 2 * n * h * h + 3 * 2 * n * h * o
            + k * 4 * 2 * n * h * d)


def apply_flops(n, d, h, o, k):
    """One forward + backward of the pair: the step's products plus
    dcoords' two d-contractions per filter (dq w^T and dn mu).  53.05 GFLOP
    at the SISR shape (n = 65,536, d = 2, h = 256, o = 3, k = 3)."""
    return step_flops(n, d, h, o, k) + k * 2 * 2 * n * h * d


# ---- the kernels ------------------------------------------------------------

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float

# (n, d, h, o, k, x, filters, W, WT, c, Wf, WfT, bf, reps, x_shared)
_NET = [_INT] * 5 + [_PTR] * 8 + [_INT] * 2


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("mfn")
    lib.mfn_forward.argtypes = _NET + [_PTR, _PTR, _PTR, _PTR]
    lib.mfn_backward.argtypes = _NET + [_PTR] * 11
    lib.mfn_step_run.argtypes = (_NET + [_PTR] * 13
                                 + [_INT, _FLT, _INT, _INT, _PTR])
    for fn in (lib.mfn_forward, lib.mfn_backward, lib.mfn_step_run):
        fn.restype = _INT
    lib.mfn_part_floats.argtypes = [_INT] * 4
    lib.mfn_part_floats.restype = ctypes.c_longlong
    lib.mfn_max_out.argtypes = []
    lib.mfn_max_out.restype = _INT
    lib.mfn_max_in.argtypes = []
    lib.mfn_max_in.restype = _INT
    lib.mfn_error_string.argtypes = [_INT]
    lib.mfn_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc, what):
    if rc != 0:
        msg = _lib().mfn_error_string(rc).decode()
        raise RuntimeError(f"mfn {what} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


def _ptrs(tensors):
    return (_PTR * len(tensors))(*[None if t is None else t.data_ptr()
                                   for t in tensors])


def _num_filters(params):
    k = 0
    while f"gabor_{k}" in params:
        k += 1
    return k


class _Net:
    """The checked weights of one MFN on the card, in the kernels' order:
    filters [w, b, mu, gamma] per filter, linears W, W^T, c, and the final
    layer's W_f, W_f^T, b_f; ``args(x)`` the C entry points' leading
    arguments.  With ``reps`` every leaf leads with reps and the
    coordinates are (n, d) shared or (reps, n, d)."""

    def __init__(self, params, coords, who, reps=None):
        lib = _lib()
        dev = coords.device
        k = _num_filters(params)
        if k < 1:
            raise ValueError(f"{who}: no gabor_0 in the parameters")
        self.reps = reps
        self.M = 1 if reps is None else reps
        self.lead = lead = () if reps is None else (reps,)
        n, d = coords.shape[-2:]
        h = int(params["gabor_0"]["b"].shape[-1])
        o = int(params["final"]["b"].shape[-1])
        if not 1 <= d <= lib.mfn_max_in():
            raise ValueError(f"{who} kernel supports in_features 1 .. "
                             f"{lib.mfn_max_in()}, got {d}")
        if o > lib.mfn_max_out():
            raise ValueError(f"{who} kernel supports out_features <= "
                             f"{lib.mfn_max_out()}, got {o}")
        self.x_shared = coords.ndim == 2
        _check("coords", coords, (n, d) if self.x_shared else lead + (n, d),
               dev, who)
        shapes = {"w": (d, h), "b": (h,), "mu": (h, d), "gamma": (h,)}
        self.filters = []
        for j in range(k):
            for key in FILTER_KEYS:
                t = params[f"gabor_{j}"][key]
                _check(f"gabor_{j}.{key}", t, lead + shapes[key], dev, who)
                self.filters.append(t)
        self.W, self.WT, self.c = [], [], []
        for j in range(k - 1):
            p = params[f"linear_{j}"]
            _check(f"linear_{j}.w", p["w"], lead + (h, h), dev, who)
            _check(f"linear_{j}.b", p["b"], lead + (h,), dev, who)
            self.W.append(p["w"])
            self.WT.append(p["w"].transpose(-1, -2).contiguous())
            self.c.append(p["b"])
        f = params["final"]
        _check("final.w", f["w"], lead + (h, o), dev, who)
        _check("final.b", f["b"], lead + (o,), dev, who)
        self.Wf, self.bf = f["w"], f["b"]
        self.WfT = f["w"].transpose(-1, -2).contiguous()
        self.n, self.d, self.h, self.o, self.k = n, d, h, o, k
        self.device = dev
        # the pointer arrays live as long as this object
        self._arrays = [_ptrs(self.filters), _ptrs(self.W), _ptrs(self.WT),
                        _ptrs(self.c)]

    def args(self, coords):
        return [self.n, self.d, self.h, self.o, self.k, coords.data_ptr(),
                *self._arrays, self.Wf.data_ptr(), self.WfT.data_ptr(),
                self.bf.data_ptr(), self.M, int(self.x_shared)]

    def part(self, get):
        """The backward's fixed-order partial-sum workspace, from
        ``get(name, shape)``; reps x the floats of one replica."""
        floats = _lib().mfn_part_floats(self.n, self.d, self.h, self.o)
        return get("mfn_part", (self.M * floats,))

    def grads(self):
        """Empty gradient buffers in the kernels' layout: filters [gw, gb,
        gmu, ggamma] per filter, gW[j] = [dW; dc] ((h + 1) x h), gWf =
        [dW_f; db_f] ((h + 1) x o), each with the leading reps."""
        f32 = dict(dtype=torch.float32, device=self.device)
        lead = self.lead
        shapes = {"w": (self.d, self.h), "b": (self.h,),
                  "mu": (self.h, self.d), "gamma": (self.h,)}
        gf = [torch.empty(lead + shapes[key], **f32) for _ in range(self.k)
              for key in FILTER_KEYS]
        gW = [torch.empty(lead + (self.h + 1, self.h), **f32)
              for _ in range(self.k - 1)]
        gWf = torch.empty(lead + (self.h + 1, self.o), **f32)
        return gf, gW, gWf

    def grads_tree(self, gf, gW, gWf):
        h = self.h
        out = {f"gabor_{j}": {key: gf[4 * j + i]
                              for i, key in enumerate(FILTER_KEYS)}
               for j in range(self.k)}
        for j in range(self.k - 1):
            out[f"linear_{j}"] = {"w": gW[j][..., :h, :],
                                  "b": gW[j][..., h, :]}
        out["final"] = {"w": gWf[..., :h, :], "b": gWf[..., h, :]}
        return out


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


@profiling.spanned("wrappers.mfn.forward")
def _forward(params, coords, keep, reps=None):
    """Launch the pair's forward; returns (pred, zs, ls): the k planes z_j
    and the k - 1 planes l_j (j >= 1) when ``keep``, else None (the chain
    runs through two ping-pong planes).  ``reps``: the replica layout."""
    lib = _lib()
    net = _Net(params, coords, "mfn_mlp", reps)
    n, h, k, lead = net.n, net.h, net.k, net.lead
    f32 = dict(dtype=torch.float32, device=coords.device)
    if keep:
        zs = [torch.empty(lead + (n, h), **f32) for _ in range(k)]
        ls = [None] + [torch.empty(lead + (n, h), **f32)
                       for _ in range(k - 1)]
        zp = zs
    else:
        zs = ls = None
        planes = torch.empty((min(k, 2),) + lead + (n, h), **f32)
        zp = [planes[j % 2] for j in range(k)]
    pred = torch.empty(lead + (n, net.o), **f32)
    with profiling.span("kernels.mfn.forward"):
        _raise_on(lib.mfn_forward(
            *net.args(coords), _ptrs(zp), _ptrs(ls if keep else [None] * k),
            pred.data_ptr(), _stream(coords.device)), "forward")
    profiling.count("launches.mfn.forward")
    return pred, zs, ls


class _MfnMLP(torch.autograd.Function):
    """The pair for one model (``reps`` None) or ``reps`` replicas."""

    @staticmethod
    def forward(ctx, coords, paths, reps, *leaves):
        params = tree.unflatten(paths, leaves)
        pred, zs, ls = _forward(params, coords, keep=True, reps=reps)
        ctx.save_for_backward(coords, *leaves, *zs, *ls[1:])
        ctx.paths, ctx.nleaves, ctx.k = paths, len(leaves), len(zs)
        ctx.reps = reps
        return pred

    @staticmethod
    @profiling.spanned("wrappers.mfn.backward")
    def backward(ctx, g):
        saved = ctx.saved_tensors
        coords = saved[0]
        nl, k = ctx.nleaves, ctx.k
        params = tree.unflatten(ctx.paths, saved[1:1 + nl])
        zs = saved[1 + nl:1 + nl + k]
        ls = [None] + list(saved[1 + nl + k:])
        lib = _lib()
        net = _Net(params, coords, "mfn_mlp", ctx.reps)
        n, h, lead = net.n, net.h, net.lead
        g = g.to(torch.float32).contiguous()
        _check("cotangent", g, lead + (n, net.o), coords.device, "mfn_mlp")
        f32 = dict(dtype=torch.float32, device=coords.device)
        gf, gW, gWf = net.grads()
        # the coordinate gradient only where autograd asks for it (never in
        # a fit; the replica pair refuses such coordinates before its
        # forward)
        dcoords = torch.empty((n, net.d), **f32) \
            if ctx.needs_input_grad[0] else None
        dl = torch.empty((2,) + lead + (n, h), **f32)
        dg = torch.empty(lead + (n, h), **f32)
        part = net.part(lambda name, shape: torch.empty(shape, **f32))
        with profiling.span("kernels.mfn.backward"):
            _raise_on(lib.mfn_backward(
                *net.args(coords), g.data_ptr(), _ptrs(zs), _ptrs(ls),
                _ptrs(gf), _ptrs(gW), gWf.data_ptr(),
                None if dcoords is None else dcoords.data_ptr(), dl.data_ptr(),
                dg.data_ptr(), part.data_ptr(), _stream(coords.device)),
                "backward")
        profiling.count("launches.mfn.backward")
        grads = tree.leaves(net.grads_tree(gf, gW, gWf))
        by_path = {path: t for path, t in grads}
        return (dcoords, None, None, *[by_path[p] for p in ctx.paths])


def mfn_mlp(params, coords, spec):
    """The MFN ``coords (..., d) -> (..., o)``, differentiable in the
    parameters and the coordinates (``mfn_mlp_fused``).  CPU tensors take
    ``mfn_mlp_plain``; CUDA tensors the kernels: the forward and backward
    pair when an input needs a gradient, else a forward that keeps
    nothing."""
    lead = coords.shape[:-1]
    c2 = coords.reshape(-1, coords.shape[-1])
    if c2.device.type == "cpu":
        out = mfn_mlp_plain(params, c2, spec)
    elif c2.device.type != "cuda":
        raise ValueError(f"mfn_mlp: unsupported device {c2.device}")
    else:
        c2 = c2.contiguous()  # a strided view survives the reshape
        flat = tree.leaves(params)
        paths = tuple(p for p, _ in flat)
        leaves = [t for _, t in flat]
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in [c2] + leaves):
            out = _MfnMLP.apply(c2, paths, None, *leaves)
        else:
            out, _, _ = _forward(params, c2, keep=False)
    return out.reshape(*lead, out.shape[-1])


@profiling.spanned("wrappers.mfn.step")
def _launch_step(params, coords, target, nvalid, denom, gt, want_metrics,
                 scratch, reps=None):
    """One launch sequence of the step kernel: one model (``reps`` None,
    no leading axis anywhere) or ``reps`` replicas (a leading axis on every
    leaf; coords (n, d) or (reps, n, d), target and gt (n, o) or (reps, n,
    o), each shared when it has no leading axis)."""
    lib = _lib()
    who = "mfn_step" if reps is None else "mfn_step_many"
    net = _Net(params, coords, who, reps)
    dev = coords.device
    n, h, o, k, lead = net.n, net.h, net.o, net.k, net.lead
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

    zs = get("mfn_z", (k,) + lead + (n, h))
    ls = get("mfn_l", (max(k - 1, 1),) + lead + (n, h))
    dl = get("mfn_dl", (2,) + lead + (n, h))
    dg = get("mfn_dg", lead + (n, h))
    g = get("mfn_g", lead + (n, o))
    part = net.part(get)
    f32 = dict(dtype=torch.float32, device=dev)
    pred = torch.empty(lead + (n, o), **f32)
    gf, gW, gWf = net.grads()
    sse = torch.zeros(lead + (2,), **f32)
    dn = np.float32(n * o if denom is None else denom)
    two_inv_denom = np.float32(2.0) * (np.float32(1.0) / dn)
    with profiling.span("kernels.mfn.step"):
        _raise_on(lib.mfn_step_run(
            *net.args(coords), target.data_ptr(),
            None if gt is None else gt.data_ptr(),
            _ptrs([zs[j] for j in range(k)]),
            _ptrs([None] + [ls[j - 1] for j in range(1, k)]), pred.data_ptr(),
            g.data_ptr(), sse.data_ptr(), _ptrs(gf), _ptrs(gW), gWf.data_ptr(),
            dl.data_ptr(), dg.data_ptr(), part.data_ptr(), nv,
            float(two_inv_denom), int(want_metrics), int(t_shared),
            _stream(dev)), "step")
    profiling.count("launches.mfn.step")
    dparams = net.grads_tree(gf, gW, gWf)
    if want_metrics:
        return pred, dparams, (sse[..., 0], sse[..., 1])
    return pred, dparams


def mfn_step(params, coords, target, spec, *, nvalid=None, denom=None,
             gt=None, want_metrics=False, scratch=None):
    """One MFN train step (``mfn_step_fused``): returns (pred, dparams) for
    ``loss = sum_{rows < nvalid} (pred - target)^2 / denom``, plus
    ``(sse_target, sse_gt)`` when ``want_metrics`` (gt defaults to target).
    coords (n, d), target (n, o) float32; nvalid (a Python int) defaults to
    n and denom to n*o; invalid rows must be a tail.  CPU tensors take
    ``mfn_step_plain``; CUDA tensors launch the kernel (counter
    ``launches.mfn.step``) or raise.  ``scratch`` (a StepScratch) keeps the
    kernel's device buffers across steps."""
    if coords.device.type == "cpu":
        return mfn_step_plain(params, coords, target, spec, nvalid=nvalid,
                              denom=denom, gt=gt, want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"mfn_step: unsupported device {coords.device}")
    return _launch_step(params, coords, target, nvalid, denom, gt,
                        want_metrics, scratch)


# ---- the replica axis (the batched multi-fit) -------------------------------

def mfn_step_many_plain(params_stack, coords, target, spec, *, nvalid=None,
                        denom=None, gt=None, want_metrics=False):
    """The plain version of ``mfn_step_many``: ``mfn_step_plain`` once per
    replica, its results stacked."""
    M = tree.replicas(params_stack)
    nvalid = shared_nvalid(nvalid, M)

    def rep(x, r):
        return tree.replica(x, r, M)

    outs = [mfn_step_plain(tree.index(params_stack, r), rep(coords, r),
                           rep(target, r), spec, nvalid=nvalid, denom=denom,
                           gt=rep(gt, r), want_metrics=want_metrics)
            for r in range(M)]
    pred = torch.stack([out[0] for out in outs])
    grads = tree.stack([out[1] for out in outs])
    if want_metrics:
        return pred, grads, tuple(torch.stack([out[2][i] for out in outs])
                                  for i in range(2))
    return pred, grads


def mfn_step_many(params_stack, coords, target, spec, *, nvalid=None,
                  denom=None, gt=None, want_metrics=False, scratch=None):
    """M MFN train steps at once: every leaf of ``params_stack`` has a
    leading M; coords (n, d) shared or (M, n, d); target and gt (n, o)
    shared or (M, n, o).  Returns pred (M, n, o), the gradients stacked as
    the parameters and, with ``want_metrics``, the SSE sums as two (M,)
    tensors.  ``nvalid`` and ``denom`` are shared (an int, or M equal
    ints).  CPU tensors take ``mfn_step_many_plain``; on CUDA one launch
    sequence serves all M (``launches.mfn.step`` advances by one) or an
    error is raised."""
    if coords.device.type == "cpu":
        return mfn_step_many_plain(params_stack, coords, target, spec,
                                   nvalid=nvalid, denom=denom, gt=gt,
                                   want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"mfn_step_many: unsupported device "
                         f"{coords.device}")
    M = tree.replicas(params_stack)
    return _launch_step(params_stack, coords, target,
                        shared_nvalid(nvalid, M), denom, gt, want_metrics,
                        scratch, reps=M)


def mfn_mlp_many_plain(params_stack, coords, spec):
    """The plain version of ``mfn_mlp_many``: ``mfn_mlp_plain`` once per
    replica, its results stacked."""
    M = tree.replicas(params_stack)
    return torch.stack([
        mfn_mlp_plain(tree.index(params_stack, r),
                      tree.replica(coords, r, M), spec) for r in range(M)])


def mfn_mlp_many(params_stack, coords, spec):
    """M MFN forwards at once: every leaf of ``params_stack`` has a leading
    M; coords (rows, d) shared by the replicas or (M, ..., rows, d) per
    replica -> (M, ..., rows, o), differentiable in the parameters.  On
    CUDA each direction is one launch sequence for all M (the pair when a
    parameter needs a gradient, else a forward that keeps nothing);
    coordinates that require a gradient raise."""
    if coords.device.type == "cpu":
        return mfn_mlp_many_plain(params_stack, coords, spec)
    if coords.device.type != "cuda":
        raise ValueError(f"mfn_mlp_many: unsupported device {coords.device}")
    M = tree.replicas(params_stack)
    if coords.requires_grad:
        raise ValueError("mfn_mlp_many computes no coordinate gradient (the "
                         "batched fits' coordinates are constants); use "
                         "mfn_mlp per replica to differentiate in them")
    if coords.ndim == 2:
        c2, out_lead = coords.contiguous(), (M, coords.shape[0])
    else:
        if coords.shape[0] != M:
            raise ValueError(f"mfn_mlp_many: coords {tuple(coords.shape)} "
                             f"for {M} replicas: expected (rows, d) or "
                             f"({M}, ..., rows, d)")
        out_lead = tuple(coords.shape[:-1])
        c2 = coords.reshape(M, -1, coords.shape[-1]).contiguous()
    flat = tree.leaves(params_stack)
    paths = tuple(p for p, _ in flat)
    leaves = [t for _, t in flat]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        out = _MfnMLP.apply(c2, paths, M, *leaves)
    else:
        out, _, _ = _forward(params_stack, c2, keep=False, reps=M)
    return out.reshape(*out_lead, out.shape[-1])
