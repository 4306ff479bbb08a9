"""The INR families as (init, apply, step) functions over parameter dicts
(port of wire_tpu/nn/models.py: WIRE, :32-246; the canonical real
families siren, gauss, relu/posenc and the B-splines form, cubic, srelu
and knots, :311-733 and the step hooks at :1160-1203).

Parameters are nested dicts of tensors with the JAX package's names and
layouts (WIRE: ``first{w,b}``, ``hidden_i{wr,wi,br,bi}``,
``final{wr,wi,br,bi}``; the real families: ``{first, hidden_i, final}``
each ``{w, b}``; weights ``(in, out)``), so ``wire_tpu_torch.bridge`` moves
a JAX init across unchanged.  Topology: ``[first nonlinear layer] +
hidden_layers x [nonlinear layer] + [final linear]``, real output.

The real families fold their parameters to the canonical form of
``ops/real_mlp.py`` (per layer ``z = a @ w; v = alpha z + beta; a =
B(v)``) and run its kernels; native-parameter gradients come back from
the canonical ones through autograd of the fold.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from wire_tpu_torch.nn import activations as act
from wire_tpu_torch.nn import init as winit
from wire_tpu_torch.nn.layers import complex_linear, linear


@dataclasses.dataclass(frozen=True)
class INRSpec:
    """The configuration surface of the model factory (the fields of
    wire_tpu's INRSpec that the WIRE and canonical real families read)."""
    nonlin: str
    in_features: int = 2
    hidden_features: int = 256
    hidden_layers: int = 2
    out_features: int = 1
    scaled_hidden_features: int | None = None
    outermost_linear: bool = True
    first_omega0: float = 30.0
    hidden_omega0: float = 30.0
    scale: float = 10.0
    scale_tensor: tuple = ()
    pos_encode: bool = False
    sidelength: int | tuple = 512
    fn_samples: int | None = None
    use_nyquist: bool = True
    # 'auto': the family's kernels (their plain versions on CPU tensors);
    # 'never': the plain ``apply`` and autodiff of it
    fused: str = "auto"


@contextlib.contextmanager
def _fp32_matmuls():
    """Full-fp32 matmuls on the card (TF32 off) for the plain paths."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _leaves(params):
    return [(k, kk) for k in params for kk in params[k]]


def autodiff_step(apply_fn, params, coords, target, spec, *, nvalid=None,
                  denom=None, gt=None, want_metrics=False):
    """(pred, dparams[, (sse_target, sse_gt)]) of
    ``loss = sum_{rows < nvalid} (pred - target)^2 / denom`` by autodiff of
    ``apply_fn`` (wire_tpu/nn/models.py:151-173).  Parameters that the
    output does not use (WIRE's final ``bi``) get zero gradients."""
    n, c = target.shape
    dn = float(n * c) if denom is None else denom
    keys = _leaves(params)
    leaves = [params[k][kk].detach().requires_grad_(True) for k, kk in keys]
    p = {k: {} for k in params}
    for (k, kk), leaf in zip(keys, leaves):
        p[k][kk] = leaf
    mask = None
    if nvalid is not None:
        rows = torch.arange(n, device=coords.device)[:, None]
        mask = (rows < nvalid).to(target.dtype)
    with torch.enable_grad(), _fp32_matmuls():
        pred = apply_fn(p, coords, spec)
        err = pred - target
        if mask is not None:
            err = err * mask
        loss = torch.sum(err * err) / dn
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    dparams = {k: {} for k in params}
    for (k, kk), leaf, gr in zip(keys, leaves, grads):
        dparams[k][kk] = torch.zeros_like(leaf) if gr is None else gr
    pred = pred.detach()
    if not want_metrics:
        return pred, dparams
    err_t = pred - target
    err_g = err_t if gt is None else pred - gt
    if mask is not None:
        err_t = err_t * mask
        err_g = err_g * mask
    return pred, dparams, (torch.sum(err_t * err_t), torch.sum(err_g * err_g))


class INR:
    """A model family instance: ``params = m.init(gen, device)``,
    ``y = m.apply(params, coords)``, ``m.step_grads(...)``."""

    def __init__(self, spec: INRSpec, init_fn, apply_fn, step_fn=None):
        self.spec = spec
        self._init = init_fn
        self._apply = apply_fn
        self._step = step_fn

    def init(self, gen: torch.Generator, device="cpu"):
        return self._init(gen, self.spec, device)

    def apply(self, params, coords):
        return self._apply(params, coords, self.spec)

    def step_grads(self, params, coords, target, *, nvalid=None, denom=None,
                   gt=None, want_metrics=False, scratch=None):
        """(pred, dparams) of ``loss = sum_{rows<nvalid}(pred-t)^2 / denom``,
        plus the masked squared-error sums ``(sse_target, sse_gt)`` when
        ``want_metrics`` (gt defaults to target).  Families with a step
        kernel (WIRE, the canonical real families) run it unless
        ``spec.fused == 'never'``; the rest use autodiff of ``apply``.
        Invalid rows must be a tail; nvalid defaults to n and denom to
        n*c."""
        if self._step is not None and self.spec.fused != "never":
            return self._step(params, coords, target, self.spec,
                              nvalid=nvalid, denom=denom, gt=gt,
                              want_metrics=want_metrics, scratch=scratch)
        return autodiff_step(self._apply, params, coords, target, self.spec,
                             nvalid=nvalid, denom=denom, gt=gt,
                             want_metrics=want_metrics)

    def num_params(self, params):
        return sum(t.numel() for k in params for t in params[k].values())


# ===========================================================================
# WIRE - complex Gabor
# ===========================================================================

def wire_hidden(spec):
    # complex params count double; the width is divided by sqrt(2)
    return int(spec.hidden_features / math.sqrt(2))


def wire_init(gen, spec: INRSpec, device="cpu"):
    h = wire_hidden(spec)
    params = {"first": winit.linear_params(gen, spec.in_features, h,
                                           device=device)}
    for i in range(spec.hidden_layers):
        params[f"hidden_{i}"] = winit.complex_linear_params(gen, h, h,
                                                            device=device)
    params["final"] = winit.complex_linear_params(gen, h, spec.out_features,
                                                  device=device)
    return params


def wire_apply_plain(params, coords, spec: INRSpec):
    """The WIRE forward in plain PyTorch ops (autograd differentiates it)."""
    z = linear(params["first"], coords)
    xr, xi = act.complex_gabor_real_input(z, spec.first_omega0, spec.scale)
    for i in range(spec.hidden_layers):
        zr, zi = complex_linear(params[f"hidden_{i}"], xr, xi)
        xr, xi = act.complex_gabor(zr, zi, spec.hidden_omega0, spec.scale)
    yr, _ = complex_linear(params["final"], xr, xi)
    return yr  # the real part


def wire_apply(params, coords, spec: INRSpec):
    """The WIRE forward: the apply/VJP kernel pair (ops/wire_mlp.py) unless
    ``spec.fused == 'never'``; that module runs the plain body for CPU
    tensors and the kernels for CUDA tensors
    (wire_tpu/nn/models.py:202-216)."""
    if spec.fused == "never":
        return wire_apply_plain(params, coords, spec)
    from wire_tpu_torch.ops.wire_mlp import wire_mlp
    return wire_mlp(params, coords, spec)


def wire_step(params, coords, target, spec, *, nvalid=None, denom=None,
              gt=None, want_metrics=False, scratch=None):
    """WIRE train-step dispatch to the step kernel (ops/wire_step.py)."""
    from wire_tpu_torch.ops.wire_step import wire_step as step
    return step(params, coords, target, spec, nvalid=nvalid, denom=denom,
                gt=gt, want_metrics=want_metrics, scratch=scratch)


# ===========================================================================
# The canonical real families (ops/real_mlp.py)
# ===========================================================================

def _use_fused(spec):
    """The canonical kernels serve a family unless ``fused == 'never'`` or
    its last layer is not a plain linear (wire_tpu/nn/models.py:314-322)."""
    return spec.fused != "never" and spec.outermost_linear


def _layer_names(spec):
    return ["first"] + [f"hidden_{i}" for i in range(spec.hidden_layers)]


def _n_act_layers(spec):
    return spec.hidden_layers + 1


def _canon_uniform(params, spec, alpha_of, beta_of, names=None):
    """Canonical params where every activation layer folds alike: alpha a
    constant ``alpha_of`` on every lane, beta = ``beta_of(b)``."""
    names = _layer_names(spec) if names is None else names
    layers = []
    for nm in names:
        w = params[nm]["w"]
        layers.append({"w": w,
                       "alpha": torch.full((w.shape[1],), float(alpha_of),
                                           dtype=w.dtype, device=w.device),
                       "beta": beta_of(params[nm]["b"])})
    return {"layers": layers,
            "final": {"w": params["final"]["w"], "b": params["final"]["b"]}}


def _canon_siren(params, spec):
    layers = []
    for i, nm in enumerate(_layer_names(spec)):
        w = params[nm]["w"]
        omega = spec.first_omega0 if i == 0 else spec.hidden_omega0
        layers.append({"w": w,
                       "alpha": torch.full((w.shape[1],), float(omega),
                                           dtype=w.dtype, device=w.device),
                       "beta": omega * params[nm]["b"]})
    return {"layers": layers,
            "final": {"w": params["final"]["w"], "b": params["final"]["b"]}}


def _fused_real(coords, kinds, canon):
    from wire_tpu_torch.ops.real_mlp import real_mlp
    return real_mlp(canon, coords, kinds)


def _make_real_step(apply_fn, kinds_of, canon_of, pre=None):
    """A family's step hook over the canonical train step
    (ops/real_mlp.py:real_step): ``canon_of(params, spec)`` folds the
    params, ``pre(coords, spec)`` is an optional parameter-free input
    transform (posenc).  The native gradients are autograd of the fold with
    the canonical gradients as grad_outputs, as jax.vjp gives them in the
    JAX package.  A family whose last layer is not linear takes autodiff of
    ``apply_fn``."""
    def step(params, coords, target, spec, *, nvalid=None, denom=None,
             gt=None, want_metrics=False, scratch=None):
        if not _use_fused(spec):
            return autodiff_step(apply_fn, params, coords, target, spec,
                                 nvalid=nvalid, denom=denom, gt=gt,
                                 want_metrics=want_metrics)
        from wire_tpu_torch.ops.real_mlp import (canon_from_leaves,
                                                 canon_leaves, real_step)
        x = coords if pre is None else pre(coords, spec)
        keys = _leaves(params)
        leaves = [params[k][kk].detach().requires_grad_(True)
                  for k, kk in keys]
        p = {k: {} for k in params}
        for (k, kk), leaf in zip(keys, leaves):
            p[k][kk] = leaf
        with torch.enable_grad():
            canon = canon_of(p, spec)
        ctens = [t for _, t in canon_leaves(canon)]
        L = len(canon["layers"])
        out = real_step(canon_from_leaves([t.detach() for t in ctens], L),
                        x, target, kinds_of(spec), nvalid=nvalid,
                        denom=denom, gt=gt, want_metrics=want_metrics,
                        scratch=scratch)
        dtens = [t for _, t in canon_leaves(out[1])]
        pairs = [(c, d) for c, d in zip(ctens, dtens) if c.requires_grad]
        grads = torch.autograd.grad([c for c, _ in pairs], leaves,
                                    [d for _, d in pairs], allow_unused=True)
        dparams = {k: {} for k in params}
        for (k, kk), leaf, gr in zip(keys, leaves, grads):
            dparams[k][kk] = torch.zeros_like(leaf) if gr is None else gr
        return (out[0], dparams) + tuple(out[2:])
    return step


def _plain_mlp_init(gen, spec: INRSpec, device="cpu", in_features=None):
    nin = spec.in_features if in_features is None else in_features
    hf = spec.hidden_features
    params = {"first": winit.linear_params(gen, nin, hf, device=device)}
    for i in range(spec.hidden_layers):
        params[f"hidden_{i}"] = winit.linear_params(gen, hf, hf,
                                                    device=device)
    params["final"] = winit.linear_params(gen, hf, spec.out_features,
                                          device=device)
    return params


def bspline_plain_init(gen, spec: INRSpec, device="cpu"):
    return _plain_mlp_init(gen, spec, device)


def _chain(params, coords, spec, layer_fn):
    """first + hidden layers through ``layer_fn(p, x)``, then the final
    layer: linear, or ``layer_fn`` too when not ``outermost_linear``."""
    x = layer_fn(params["first"], coords)
    for i in range(spec.hidden_layers):
        x = layer_fn(params[f"hidden_{i}"], x)
    if spec.outermost_linear:
        return linear(params["final"], x)
    return layer_fn(params["final"], x)


# ---- SIREN ------------------------------------------------------------------

def siren_init(gen, spec: INRSpec, device="cpu"):
    hf = spec.hidden_features
    params = {"first": winit.siren_linear_params(
        gen, spec.in_features, hf, is_first=True, omega0=spec.first_omega0,
        device=device)}
    for i in range(spec.hidden_layers):
        params[f"hidden_{i}"] = winit.siren_linear_params(
            gen, hf, hf, is_first=False, omega0=spec.hidden_omega0,
            device=device)
    if spec.outermost_linear:
        params["final"] = winit.siren_final_linear_params(
            gen, hf, spec.out_features, omega0=spec.hidden_omega0,
            device=device)
    else:
        params["final"] = winit.siren_linear_params(
            gen, hf, spec.out_features, is_first=False,
            omega0=spec.hidden_omega0, device=device)
    return params


def siren_apply(params, coords, spec: INRSpec):
    if _use_fused(spec):
        return _fused_real(coords, ("sine",) * _n_act_layers(spec),
                           _canon_siren(params, spec))
    x = act.sine(linear(params["first"], coords), spec.first_omega0)
    for i in range(spec.hidden_layers):
        x = act.sine(linear(params[f"hidden_{i}"], x), spec.hidden_omega0)
    if spec.outermost_linear:
        return linear(params["final"], x)
    return act.sine(linear(params["final"], x), spec.hidden_omega0)


# ---- Gauss ------------------------------------------------------------------

def _canon_gauss(params, spec):
    s = spec.scale
    return _canon_uniform(params, spec, s, lambda b: s * b)


def gauss_apply(params, coords, spec: INRSpec):
    if _use_fused(spec):
        return _fused_real(coords, ("gauss",) * _n_act_layers(spec),
                           _canon_gauss(params, spec))
    return _chain(params, coords, spec,
                  lambda p, x: act.gauss(linear(p, x), spec.scale))


# ---- ReLU (+ positional encoding) -------------------------------------------

def posenc_num_frequencies(spec: INRSpec):
    """The reference relu module's frequency count."""
    nf = spec.in_features
    if nf == 3:
        return 10
    side = spec.sidelength
    if isinstance(side, int):
        side = (side, side)
    if nf == 2:
        samples = min(side[0], side[1])
    elif nf == 1:
        samples = spec.fn_samples if spec.fn_samples is not None else side[0]
    else:
        return 4
    if not spec.use_nyquist:
        return 4
    nyquist_rate = 1 / (2 * (2 * 1 / samples))
    return int(math.floor(math.log(nyquist_rate, 2)))


def posenc_out_dim(spec: INRSpec):
    nf = posenc_num_frequencies(spec)
    return spec.in_features + 2 * spec.in_features * nf


def _posenc_pre(coords, spec):
    if not spec.pos_encode:
        return coords
    return act.posenc(coords, posenc_num_frequencies(spec), spec.in_features)


def relu_init(gen, spec: INRSpec, device="cpu"):
    nin = posenc_out_dim(spec) if spec.pos_encode else spec.in_features
    return _plain_mlp_init(gen, spec, device, in_features=nin)


def _canon_relu(params, spec):
    return _canon_uniform(params, spec, 1.0, lambda b: b)


def relu_apply(params, coords, spec: INRSpec):
    coords = _posenc_pre(coords, spec)
    if _use_fused(spec):
        return _fused_real(coords, ("relu",) * _n_act_layers(spec),
                           _canon_relu(params, spec))
    return _chain(params, coords, spec,
                  lambda p, x: act.relu(linear(p, x)))


# ---- B-splines --------------------------------------------------------------
# Scale conventions: 'divide' B(Wx / s) (bspline_form), 'pre' B(W(s x))
# (bspline_cubic), 'post' B(s Wx).

def _bspline_layer(p, x, sigma, mode, basis=act.bspline_quadratic):
    if mode == "pre":
        return basis(linear(p, sigma * x))
    z = linear(p, x)
    if mode == "divide":
        return basis(z / sigma)
    if mode == "post":
        return basis(sigma * z)
    raise ValueError(mode)


def _canon_form(params, spec):
    s = spec.scale
    return _canon_uniform(params, spec, 1.0 / s, lambda b: b / s)


def bspline_form_apply(params, coords, spec: INRSpec):
    if _use_fused(spec):
        return _fused_real(coords, ("qspline",) * _n_act_layers(spec),
                           _canon_form(params, spec))
    return _chain(params, coords, spec,
                  lambda p, x: _bspline_layer(p, x, spec.scale, "divide"))


def _canon_cubic(params, spec):
    # 'pre' mode: (s a) @ W + b = s (a @ W) + b
    return _canon_uniform(params, spec, spec.scale, lambda b: b)


def bspline_cubic_apply(params, coords, spec: INRSpec):
    if _use_fused(spec):
        return _fused_real(coords, ("cspline",) * _n_act_layers(spec),
                           _canon_cubic(params, spec))
    return _chain(params, coords, spec,
                  lambda p, x: _bspline_layer(p, x, spec.scale, "pre",
                                              act.bspline_cubic))


def _canon_srelu(params, spec):
    s = spec.scale
    return _canon_uniform(params, spec, s, lambda b: s * b)


def bspline_srelu_apply(params, coords, spec: INRSpec):
    if _use_fused(spec):
        return _fused_real(coords, ("srelu",) * _n_act_layers(spec),
                           _canon_srelu(params, spec))
    return _chain(params, coords, spec,
                  lambda p, x: act.bspline_srelu(linear(p, x), spec.scale))


_DEBOOR_KNOTS = (-1.5, -1.5, -1.5, -0.5, 0.5, 1.5, 1.5, 1.5)


def bspline_knots_apply(params, coords, spec: INRSpec):
    """The De Boor recursion on the family's fixed knot vector (no sigma);
    the apply has no kernel path, as in the JAX package."""
    return _chain(params, coords, spec,
                  lambda p, x: act.bspline_deboor(linear(p, x),
                                                  _DEBOOR_KNOTS, degree=2))


def _canon_knots(params, spec):
    return _canon_uniform(params, spec, 1.0, lambda b: b)


# ---- step hooks (INR.step_grads; registry.STEP_REGISTRY) --------------------

def _uniform_kinds(kind):
    return lambda spec: (kind,) * _n_act_layers(spec)


siren_step = _make_real_step(siren_apply, _uniform_kinds("sine"),
                             _canon_siren)
gauss_step = _make_real_step(gauss_apply, _uniform_kinds("gauss"),
                             _canon_gauss)
relu_step = _make_real_step(relu_apply, _uniform_kinds("relu"), _canon_relu,
                            pre=_posenc_pre)
bspline_form_step = _make_real_step(bspline_form_apply,
                                    _uniform_kinds("qspline"), _canon_form)
bspline_cubic_step = _make_real_step(bspline_cubic_apply,
                                     _uniform_kinds("cspline"), _canon_cubic)
bspline_srelu_step = _make_real_step(bspline_srelu_apply,
                                     _uniform_kinds("srelu"), _canon_srelu)
# the De Boor recursion on the knots (-1.5, -1.5, -1.5, -0.5, 0.5, 1.5, 1.5,
# 1.5) at degree 2 is exactly the quadratic B-spline bump, so the family
# trains through the qspline kernel with alpha = 1, beta = b
# (wire_tpu/nn/models.py:1186-1198)
bspline_knots_step = _make_real_step(bspline_knots_apply,
                                     _uniform_kinds("qspline"), _canon_knots)
