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
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wire_tpu_torch import tree
from wire_tpu_torch.nn.models import autodiff_step, mfn_apply_plain
from wire_tpu_torch.ops import build
from wire_tpu_torch.ops.wire_step import StepScratch, _check

# kernel launches of this module: one "step" per mfn_step on the card, one
# "forward" and one "backward" per mfn_mlp pair; a run resets and reads
# them
launches = {"step": 0, "forward": 0, "backward": 0}

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

# (n, d, h, o, k, x, filters, W, WT, c, Wf, WfT, bf)
_NET = [_INT] * 5 + [_PTR] * 8


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("mfn")
    lib.mfn_forward.argtypes = _NET + [_PTR, _PTR, _PTR, _PTR]
    lib.mfn_backward.argtypes = _NET + [_PTR] * 11
    lib.mfn_step_run.argtypes = (_NET + [_PTR] * 13
                                 + [_INT, _FLT, _INT, _PTR])
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
    arguments."""

    def __init__(self, params, coords, who):
        lib = _lib()
        dev = coords.device
        k = _num_filters(params)
        if k < 1:
            raise ValueError(f"{who}: no gabor_0 in the parameters")
        n, d = coords.shape
        h = int(params["gabor_0"]["b"].shape[0])
        o = int(params["final"]["b"].shape[0])
        if not 1 <= d <= lib.mfn_max_in():
            raise ValueError(f"{who} kernel supports in_features 1 .. "
                             f"{lib.mfn_max_in()}, got {d}")
        if o > lib.mfn_max_out():
            raise ValueError(f"{who} kernel supports out_features <= "
                             f"{lib.mfn_max_out()}, got {o}")
        _check("coords", coords, (n, d), dev, who)
        shapes = {"w": (d, h), "b": (h,), "mu": (h, d), "gamma": (h,)}
        self.filters = []
        for j in range(k):
            for key in FILTER_KEYS:
                t = params[f"gabor_{j}"][key]
                _check(f"gabor_{j}.{key}", t, shapes[key], dev, who)
                self.filters.append(t)
        self.W, self.WT, self.c = [], [], []
        for j in range(k - 1):
            p = params[f"linear_{j}"]
            _check(f"linear_{j}.w", p["w"], (h, h), dev, who)
            _check(f"linear_{j}.b", p["b"], (h,), dev, who)
            self.W.append(p["w"])
            self.WT.append(p["w"].t().contiguous())
            self.c.append(p["b"])
        f = params["final"]
        _check("final.w", f["w"], (h, o), dev, who)
        _check("final.b", f["b"], (o,), dev, who)
        self.Wf, self.WfT, self.bf = f["w"], f["w"].t().contiguous(), f["b"]
        self.n, self.d, self.h, self.o, self.k = n, d, h, o, k
        self.device = dev
        # the pointer arrays live as long as this object
        self._arrays = [_ptrs(self.filters), _ptrs(self.W), _ptrs(self.WT),
                        _ptrs(self.c)]

    def args(self, coords):
        return [self.n, self.d, self.h, self.o, self.k, coords.data_ptr(),
                *self._arrays, self.Wf.data_ptr(), self.WfT.data_ptr(),
                self.bf.data_ptr()]

    def part(self, get):
        """The backward's fixed-order partial-sum workspace, from
        ``get(name, shape)``."""
        floats = _lib().mfn_part_floats(self.n, self.d, self.h, self.o)
        return get("mfn_part", (floats,))

    def grads(self):
        """Empty gradient buffers in the kernels' layout: filters [gw, gb,
        gmu, ggamma] per filter, gW[j] = [dW; dc] ((h + 1) x h), gWf =
        [dW_f; db_f] ((h + 1) x o)."""
        f32 = dict(dtype=torch.float32, device=self.device)
        shapes = {"w": (self.d, self.h), "b": (self.h,),
                  "mu": (self.h, self.d), "gamma": (self.h,)}
        gf = [torch.empty(shapes[key], **f32) for _ in range(self.k)
              for key in FILTER_KEYS]
        gW = [torch.empty((self.h + 1, self.h), **f32)
              for _ in range(self.k - 1)]
        gWf = torch.empty((self.h + 1, self.o), **f32)
        return gf, gW, gWf

    def grads_tree(self, gf, gW, gWf):
        h = self.h
        out = {f"gabor_{j}": {key: gf[4 * j + i]
                              for i, key in enumerate(FILTER_KEYS)}
               for j in range(self.k)}
        for j in range(self.k - 1):
            out[f"linear_{j}"] = {"w": gW[j][:h], "b": gW[j][h]}
        out["final"] = {"w": gWf[:h], "b": gWf[h]}
        return out


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _forward(params, coords, keep):
    """Launch the pair's forward; returns (pred, zs, ls): the k planes z_j
    and the k - 1 planes l_j (j >= 1) when ``keep``, else None (the chain
    runs through two ping-pong planes)."""
    lib = _lib()
    net = _Net(params, coords, "mfn_mlp")
    n, h, k = net.n, net.h, net.k
    f32 = dict(dtype=torch.float32, device=coords.device)
    if keep:
        zs = [torch.empty((n, h), **f32) for _ in range(k)]
        ls = [None] + [torch.empty((n, h), **f32) for _ in range(k - 1)]
        zp = zs
    else:
        zs = ls = None
        planes = torch.empty((min(k, 2), n, h), **f32)
        zp = [planes[j % 2] for j in range(k)]
    pred = torch.empty((n, net.o), **f32)
    _raise_on(lib.mfn_forward(
        *net.args(coords), _ptrs(zp), _ptrs(ls if keep else [None] * k),
        pred.data_ptr(), _stream(coords.device)), "forward")
    launches["forward"] += 1
    return pred, zs, ls


class _MfnMLP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, coords, paths, *leaves):
        params = tree.unflatten(paths, leaves)
        pred, zs, ls = _forward(params, coords, keep=True)
        ctx.save_for_backward(coords, *leaves, *zs, *ls[1:])
        ctx.paths, ctx.nleaves, ctx.k = paths, len(leaves), len(zs)
        return pred

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        coords = saved[0]
        nl, k = ctx.nleaves, ctx.k
        params = tree.unflatten(ctx.paths, saved[1:1 + nl])
        zs = saved[1 + nl:1 + nl + k]
        ls = [None] + list(saved[1 + nl + k:])
        lib = _lib()
        net = _Net(params, coords, "mfn_mlp")
        n, h = net.n, net.h
        g = g.to(torch.float32).contiguous()
        _check("cotangent", g, (n, net.o), coords.device, "mfn_mlp")
        f32 = dict(dtype=torch.float32, device=coords.device)
        gf, gW, gWf = net.grads()
        dcoords = torch.empty((n, net.d), **f32) \
            if ctx.needs_input_grad[0] else None
        dl = torch.empty((2, n, h), **f32)
        dg = torch.empty((n, h), **f32)
        part = net.part(lambda name, shape: torch.empty(shape, **f32))
        _raise_on(lib.mfn_backward(
            *net.args(coords), g.data_ptr(), _ptrs(zs), _ptrs(ls),
            _ptrs(gf), _ptrs(gW), gWf.data_ptr(),
            None if dcoords is None else dcoords.data_ptr(), dl.data_ptr(),
            dg.data_ptr(), part.data_ptr(), _stream(coords.device)),
            "backward")
        launches["backward"] += 1
        grads = tree.leaves(net.grads_tree(gf, gW, gWf))
        by_path = {path: t for path, t in grads}
        return (dcoords, None, *[by_path[p] for p in ctx.paths])


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
            out = _MfnMLP.apply(c2, paths, *leaves)
        else:
            out, _, _ = _forward(params, c2, keep=False)
    return out.reshape(*lead, out.shape[-1])


def _launch_step(params, coords, target, nvalid, denom, gt, want_metrics,
                 scratch):
    lib = _lib()
    net = _Net(params, coords, "mfn_step")
    dev = coords.device
    n, h, o, k = net.n, net.h, net.o, net.k
    nv = n if nvalid is None else int(nvalid)
    if not 0 <= nv <= n:
        raise ValueError(f"mfn_step: nvalid={nv} outside [0, {n}]")
    _check("target", target, (n, o), dev, "mfn_step")
    if gt is not None:
        _check("gt", gt, (n, o), dev, "mfn_step")
    scratch = StepScratch() if scratch is None else scratch

    def get(name, shape):
        return scratch.get(name, shape, dev)

    zs = get("mfn_z", (k, n, h))
    ls = get("mfn_l", (max(k - 1, 1), n, h))
    dl = get("mfn_dl", (2, n, h))
    dg = get("mfn_dg", (n, h))
    g = get("mfn_g", (n, o))
    part = net.part(get)
    f32 = dict(dtype=torch.float32, device=dev)
    pred = torch.empty((n, o), **f32)
    gf, gW, gWf = net.grads()
    sse = torch.zeros((2,), **f32)
    dn = np.float32(n * o if denom is None else denom)
    two_inv_denom = np.float32(2.0) * (np.float32(1.0) / dn)
    _raise_on(lib.mfn_step_run(
        *net.args(coords), target.data_ptr(),
        None if gt is None else gt.data_ptr(),
        _ptrs([zs[j] for j in range(k)]),
        _ptrs([None] + [ls[j - 1] for j in range(1, k)]), pred.data_ptr(),
        g.data_ptr(), sse.data_ptr(), _ptrs(gf), _ptrs(gW), gWf.data_ptr(),
        dl.data_ptr(), dg.data_ptr(), part.data_ptr(), nv,
        float(two_inv_denom), int(want_metrics), _stream(dev)), "step")
    launches["step"] += 1
    dparams = net.grads_tree(gf, gW, gWf)
    if want_metrics:
        return pred, dparams, (sse[0], sse[1])
    return pred, dparams


def mfn_step(params, coords, target, spec, *, nvalid=None, denom=None,
             gt=None, want_metrics=False, scratch=None):
    """One MFN train step (``mfn_step_fused``): returns (pred, dparams) for
    ``loss = sum_{rows < nvalid} (pred - target)^2 / denom``, plus
    ``(sse_target, sse_gt)`` when ``want_metrics`` (gt defaults to target).
    coords (n, d), target (n, o) float32; nvalid (a Python int) defaults to
    n and denom to n*o; invalid rows must be a tail.  CPU tensors take
    ``mfn_step_plain``; CUDA tensors launch the kernel
    (``launches["step"]``) or raise.  ``scratch`` (a StepScratch) keeps the
    kernel's device buffers across steps."""
    if coords.device.type == "cpu":
        return mfn_step_plain(params, coords, target, spec, nvalid=nvalid,
                              denom=denom, gt=gt, want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"mfn_step: unsupported device {coords.device}")
    return _launch_step(params, coords, target, nvalid, denom, gt,
                        want_metrics, scratch)
