"""The INR families as (init, apply, step) functions over parameter trees
(port of wire_tpu/nn/models.py: WIRE, :32-246; WIRE-2D, :253-306; the
canonical real families siren, gauss, relu/posenc and the B-splines form,
cubic, srelu and knots, :311-733; the Gabor MFN, :579-631; the multiscale
B-splines mscale_HL, mscale_2 and mscale_hier, :813-1146; the step hooks
at :1160-1320).

Parameters are nested dicts and lists of tensors with the JAX package's
names and layouts (WIRE: ``first{w,b}``, ``hidden_i{wr,wi,br,bi}``,
``final{wr,wi,br,bi}``; WIRE-2D: ``first_lin``/``first_orth{w,b}``,
``hidden_i_lin``/``hidden_i_orth{wr,wi,br,bi}``, ``final{wr,wi,br,bi}``;
the real families: ``{first, hidden_i, final}`` each ``{w, b}``; mscale_2
adds ``combiner{scale_weights, freq_0, freq_1, refine_0, refine_1}``; MFN:
``gabor_i{w,b,mu,gamma}``, ``linear_i{w,b}``, ``final{w,b}``; mscale_hier
is ``{stages: [[{w, b}, ...], ...], heads: [{w, b}, ...]}``; weights
``(in, out)``), walked by ``wire_tpu_torch.tree``, so
``wire_tpu_torch.bridge`` moves a JAX init across unchanged.  Topology:
``[first nonlinear layer] + hidden_layers x [nonlinear layer] + [final
linear]``, real output.

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

from wire_tpu_torch import tree
from wire_tpu_torch.nn import activations as act
from wire_tpu_torch.nn import init as winit
from wire_tpu_torch.nn.layers import complex_linear, linear


@dataclasses.dataclass(frozen=True)
class INRSpec:
    """The configuration surface of the model factory (the fields of
    wire_tpu's INRSpec that the ported families read)."""
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
    # mscale_HL: the reference's stop-gradient of the sliced first layer
    # (bspline_mscale_HL.py:89-90), on for number parity with it
    detach_split: bool = False
    # mscale_HL: lanes of the first band (bspline_mscale_HL.py:88)
    base_split: int = 256
    # mscale_2's combiner mode: 'freq_combine' (the reference's forward),
    # 'scale_weights' or 'both'
    combine_type: str = "freq_combine"
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


def grad_leaves(params):
    """(paths, leaves, p): detached copies of every leaf that require a
    gradient, and the tree ``p`` of them for the function to differentiate."""
    flat = tree.leaves(params)
    paths = [path for path, _ in flat]
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    return paths, leaves, tree.unflatten(paths, leaves)


def grads_tree(paths, leaves, grads):
    """The gradient tree, zeros where autograd found no use of a leaf."""
    return tree.unflatten(paths, [torch.zeros_like(leaf) if g is None else g
                                  for leaf, g in zip(leaves, grads)])


def autodiff_step(apply_fn, params, coords, target, spec, *, nvalid=None,
                  denom=None, gt=None, want_metrics=False):
    """(pred, dparams[, (sse_target, sse_gt)]) of
    ``loss = sum_{rows < nvalid} (pred - target)^2 / denom`` by autodiff of
    ``apply_fn`` (wire_tpu/nn/models.py:151-173).  Parameters that the
    output does not use (WIRE's final ``bi``) get zero gradients."""
    n, c = target.shape
    dn = float(n * c) if denom is None else denom
    paths, leaves, p = grad_leaves(params)
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
    dparams = grads_tree(paths, leaves, grads)
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
        kernel (WIRE, WIRE-2D, the MFN, the canonical real families) run it
        unless ``spec.fused == 'never'``; the rest use autodiff of
        ``apply``.
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
        return sum(t.numel() for _, t in tree.leaves(params))


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
# WIRE-2D - two-head 2-D Gabor (ops/wire2d.py)
# ===========================================================================

def wire2d_init(gen, spec: INRSpec, device="cpu"):
    """h = hidden_features / 2 complex units per head: real first linears
    ``first_lin``/``first_orth``, per hidden layer the complex linears
    ``hidden_i_lin``/``hidden_i_orth``, the complex final linear
    (wire_tpu/nn/models.py:253-270)."""
    h = int(spec.hidden_features / 2)
    d = spec.in_features
    params = {"first_lin": winit.linear_params(gen, d, h, device=device),
              "first_orth": winit.linear_params(gen, d, h, device=device)}
    for i in range(spec.hidden_layers):
        for head in ("lin", "orth"):
            params[f"hidden_{i}_{head}"] = winit.complex_linear_params(
                gen, h, h, device=device)
    params["final"] = winit.complex_linear_params(gen, h, spec.out_features,
                                                  device=device)
    return params


def wire2d_apply_plain(params, coords, spec: INRSpec):
    """The WIRE-2D forward in plain PyTorch ops (autograd differentiates
    it), in wire_tpu's order of operations (wire_tpu/nn/models.py:
    273-295): the first layer's imaginary channels are zeros."""
    lin = linear(params["first_lin"], coords)
    orth = linear(params["first_orth"], coords)
    zeros = torch.zeros_like(lin)
    xr, xi = act.complex_gabor2d(lin, zeros, orth, zeros, spec.first_omega0,
                                 spec.scale)
    for i in range(spec.hidden_layers):
        lr, li = complex_linear(params[f"hidden_{i}_lin"], xr, xi)
        orr, ori = complex_linear(params[f"hidden_{i}_orth"], xr, xi)
        xr, xi = act.complex_gabor2d(lr, li, orr, ori, spec.hidden_omega0,
                                     spec.scale)
    yr, _ = complex_linear(params["final"], xr, xi)
    return yr  # the real part


def wire2d_apply(params, coords, spec: INRSpec):
    """The WIRE-2D forward: the apply/VJP kernel pair
    (ops/wire2d.py:wire2d_mlp) unless ``spec.fused == 'never'``; that
    module runs the plain body for CPU tensors and the kernels for CUDA
    tensors."""
    if spec.fused == "never":
        return wire2d_apply_plain(params, coords, spec)
    from wire_tpu_torch.ops.wire2d import wire2d_mlp
    return wire2d_mlp(params, coords, spec)


def wire2d_step(params, coords, target, spec, *, nvalid=None, denom=None,
                gt=None, want_metrics=False, scratch=None):
    """WIRE-2D train-step dispatch to the step kernel
    (ops/wire2d.py:wire2d_step)."""
    from wire_tpu_torch.ops.wire2d import wire2d_step as step
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


def fold_grads(canon_of, params, spec):
    """(canon, back): the fold ``canon_of(params, spec)`` on leaves that
    require a gradient, detached, and ``back(dcanon)``, the native gradient
    tree (autograd of the fold with the canonical gradients as
    grad_outputs, as jax.vjp gives it in the JAX package; zeros for leaves
    the fold does not use)."""
    from wire_tpu_torch.ops.real_mlp import canon_from_leaves, canon_leaves
    paths, leaves, p = grad_leaves(params)
    with torch.enable_grad():
        canon = canon_of(p, spec)
    ctens = [t for _, t in canon_leaves(canon)]

    def back(dcanon):
        dtens = [t for _, t in canon_leaves(dcanon)]
        pairs = [(c, d) for c, d in zip(ctens, dtens) if c.requires_grad]
        grads = torch.autograd.grad([c for c, _ in pairs], leaves,
                                    [d for _, d in pairs], allow_unused=True)
        return grads_tree(paths, leaves, grads)

    return canon_from_leaves([t.detach() for t in ctens],
                             len(canon["layers"])), back


def _make_real_step(apply_fn, kinds_of, canon_of, pre=None, use_ok=None):
    """A family's step hook over the canonical train step
    (ops/real_mlp.py:real_step): ``canon_of(params, spec)`` folds the
    params, ``pre(coords, spec)`` is an optional parameter-free input
    transform (posenc), ``use_ok(params, spec)`` an optional gate of the
    family's own.  A family whose last layer is not linear, or that its
    gate refuses, takes autodiff of ``apply_fn``."""
    def step(params, coords, target, spec, *, nvalid=None, denom=None,
             gt=None, want_metrics=False, scratch=None):
        if not _use_fused(spec) or (use_ok is not None
                                    and not use_ok(params, spec)):
            return autodiff_step(apply_fn, params, coords, target, spec,
                                 nvalid=nvalid, denom=denom, gt=gt,
                                 want_metrics=want_metrics)
        from wire_tpu_torch.ops.real_mlp import real_step
        x = coords if pre is None else pre(coords, spec)
        canon, back = fold_grads(canon_of, params, spec)
        out = real_step(canon, x, target, kinds_of(spec), nvalid=nvalid,
                        denom=denom, gt=gt, want_metrics=want_metrics,
                        scratch=scratch)
        return (out[0], back(out[1])) + tuple(out[2:])
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


# ===========================================================================
# The multiscale B-splines (wire_tpu/nn/models.py:813-1146)
# ===========================================================================

def _full(width, value, like):
    return torch.full((width,), float(value), dtype=like.dtype,
                      device=like.device)


# ---- mscale_HL: one wide first layer, its lanes in scale bands -------------

def mscale_hl_init(gen, spec: INRSpec, device="cpu"):
    shf, hf = spec.scaled_hidden_features, spec.hidden_features
    params = {"first": winit.linear_params(gen, spec.in_features, shf,
                                           device=device),
              "trunk_in": winit.linear_params(gen, shf, hf, device=device)}
    for i in range(max(spec.hidden_layers - 1, 0)):
        params[f"hidden_{i}"] = winit.linear_params(gen, hf, hf,
                                                    device=device)
    params["final"] = winit.linear_params(gen, hf, spec.out_features,
                                          device=device)
    return params


def _mscale_hl_names(spec):
    return ["trunk_in"] + [f"hidden_{i}"
                           for i in range(max(spec.hidden_layers - 1, 0))]


def _mscale_hl_bounds(width, spec):
    """Lane bounds of the bands: the first ``base_split`` lanes at
    scale_tensor[0], the rest split evenly over the other scales (a band
    past ``width`` is cut or empty, as a slice is)."""
    base, nrest = spec.base_split, len(spec.scale_tensor) - 1
    bounds = [0, base]
    if nrest > 0:
        split = (width - base) // nrest
        bounds += [base + (i + 1) * split for i in range(nrest)]
    return bounds


def _canon_mscale_hl(params, spec):
    """A per-lane alpha of 1/s over each band folds the bands into one
    first layer (beta = alpha b); the trunk folds as bspline_form's."""
    w, b = params["first"]["w"], params["first"]["b"]
    width = w.shape[1]
    bounds = _mscale_hl_bounds(width, spec)
    alpha0 = torch.ones((width,), dtype=w.dtype, device=w.device)
    for i, s in enumerate(spec.scale_tensor):
        alpha0[bounds[i]:bounds[i + 1]] = 1.0 / s
    s = spec.scale
    canon = _canon_uniform(params, spec, 1.0 / s, lambda bb: bb / s,
                           names=_mscale_hl_names(spec))
    canon["layers"].insert(0, {"w": w, "alpha": alpha0, "beta": alpha0 * b})
    return canon


def _mscale_hl_fusable(params, spec):
    width = params["first"]["w"].shape[1]
    return (not spec.detach_split
            and _mscale_hl_bounds(width, spec)[-1] == width)


def _mscale_hl_kinds(spec):
    return ("qspline",) * (max(spec.hidden_layers - 1, 0) + 2)


def mscale_hl_apply(params, coords, spec: INRSpec):
    if _use_fused(spec) and _mscale_hl_fusable(params, spec):
        return _fused_real(coords, _mscale_hl_kinds(spec),
                           _canon_mscale_hl(params, spec))
    width = params["first"]["w"].shape[1]
    bounds = _mscale_hl_bounds(width, spec)
    lin = linear(params["first"], coords)
    pieces = []
    for i, s in enumerate(spec.scale_tensor):
        seg = lin[..., bounds[i]:bounds[i + 1]]
        if spec.detach_split:
            # the reference's detached slices: the first layer never trains
            seg = seg.detach()
        pieces.append(act.bspline_quadratic(seg / s))
    x = torch.cat(pieces, dim=-1)
    for nm in _mscale_hl_names(spec):
        x = _bspline_layer(params[nm], x, spec.scale, "divide")
    if spec.outermost_linear:
        return linear(params["final"], x)
    return _bspline_layer(params["final"], x, spec.scale, "divide")


# ---- mscale_2: the whole trunk per scale, then a learned combiner ----------

COMBINER_WIDTH = 128   # bspline_mscale_2.py:84


def mscale2_init(gen, spec: INRSpec, device="cpu"):
    params = _plain_mlp_init(gen, spec, device)
    ns, o, cw = len(spec.scale_tensor), spec.out_features, COMBINER_WIDTH
    # the combiner is built as 'both' (bspline_mscale_2.py:124): every head
    # exists, though 'freq_combine' reads only freq_0 and freq_1
    params["combiner"] = {
        "scale_weights": torch.ones((ns,), device=device),
        "freq_0": winit.linear_params(gen, ns * o, cw, device=device),
        "freq_1": winit.linear_params(gen, cw, o, device=device),
        "refine_0": winit.linear_params(gen, o, cw, device=device),
        "refine_1": winit.linear_params(gen, cw, o, device=device),
    }
    return params


def _canon_mscale2(params, spec):
    """The shared trunk with alpha = 1, beta = b; each scale's 1/s is the
    kernels' per-row-block gamma."""
    return _canon_uniform(params, spec, 1.0, lambda b: b)


def _mscale2_kinds(spec):
    return ("qspline",) * _n_act_layers(spec)


def _inv_scales(spec):
    return tuple(1.0 / s for s in spec.scale_tensor)


def _mscale2_trunks(params, coords, spec):
    """(ns, ..., o): the trunk at every scale."""
    if _use_fused(spec):
        from wire_tpu_torch.ops.real_mlp import real_mlp_scales
        lead = coords.shape[:-1]
        c2 = coords.reshape(-1, coords.shape[-1])
        outs = real_mlp_scales(_canon_mscale2(params, spec), c2,
                               _mscale2_kinds(spec), _inv_scales(spec))
        return outs.reshape((outs.shape[0],) + lead + (outs.shape[-1],))
    return torch.stack([
        _chain(params, coords, spec,
               lambda p, x, s=s: _bspline_layer(p, x, s, "divide"))
        for s in spec.scale_tensor])


def mscale2_combine(c, outs, mode):
    """The combiner over the per-scale outputs ``outs`` (ns, ..., o)
    (bspline_mscale_2.py:78-101)."""
    if mode in ("scale_weights", "both"):
        outs = c["scale_weights"].reshape(
            (-1,) + (1,) * (outs.dim() - 1)) * outs
    if mode == "scale_weights":
        return outs.sum(0)
    if mode not in ("freq_combine", "both"):
        raise ValueError(f"unknown combine_type {mode!r}")
    cat = torch.cat(list(outs), dim=-1)
    y = linear(c["freq_1"], act.relu(linear(c["freq_0"], cat)))
    if mode == "both":
        y = linear(c["refine_1"], act.relu(linear(c["refine_0"], y)))
    return y


def mscale2_apply(params, coords, spec: INRSpec):
    """The trunk at every scale (one kernel pair for all scales, stacked
    along the rows, through ``real_mlp_scales``), then the combiner in
    PyTorch ops, as the JAX package leaves it to XLA."""
    return mscale2_combine(params["combiner"],
                           _mscale2_trunks(params, coords, spec),
                           spec.combine_type)


def mscale2_step(params, coords, target, spec, *, nvalid=None, denom=None,
                 gt=None, want_metrics=False, scratch=None):
    """mscale_2's train step (wire_tpu/nn/models.py:1252-1320): under
    'freq_combine' the one-pass step of ops/mscale2_step.py (every scale's
    trunk, the combiner, the loss and the whole backward); the trunk's
    native gradients through autograd of the fold, the combiner's unused
    heads (scale_weights, refine_*) structural zeros.  Other combine modes
    take autodiff of ``mscale2_apply``."""
    if not _use_fused(spec) or spec.combine_type != "freq_combine":
        return autodiff_step(mscale2_apply, params, coords, target, spec,
                             nvalid=nvalid, denom=denom, gt=gt,
                             want_metrics=want_metrics)
    from wire_tpu_torch.ops.mscale2_step import mscale2_step as step
    trunk = {k: v for k, v in params.items() if k != "combiner"}
    canon, back = fold_grads(_canon_mscale2, trunk, spec)
    c = params["combiner"]
    combiner = {k: {kk: v.detach() for kk, v in c[k].items()}
                for k in ("freq_0", "freq_1")}
    out = step(canon, combiner, coords, target, _mscale2_kinds(spec),
               _inv_scales(spec), nvalid=nvalid, denom=denom, gt=gt,
               want_metrics=want_metrics, scratch=scratch)
    grads = back(out[1])
    dcomb = out[2]
    grads["combiner"] = {
        "scale_weights": torch.zeros_like(c["scale_weights"]),
        "freq_0": dcomb["freq_0"], "freq_1": dcomb["freq_1"],
        "refine_0": tree.map(torch.zeros_like, c["refine_0"]),
        "refine_1": tree.map(torch.zeros_like, c["refine_1"])}
    return (out[0], grads) + tuple(out[3:])


# ---- mscale_hier: stages, each fed the raw coordinates and the last -------

def mscale_hier_init(gen, spec: INRSpec, device="cpu"):
    d, h, o = spec.in_features, spec.hidden_features, spec.out_features
    params = {"stages": [], "heads": []}
    for stage in range(len(spec.scale_tensor)):
        layers = [winit.linear_params(gen, d, h, device=device),
                  winit.linear_params(gen, 2 * h if stage else h, h,
                                      device=device)]
        layers += [winit.linear_params(gen, h, h, device=device)
                   for _ in range(spec.hidden_layers - 1)]
        params["stages"].append(layers)
        # the heads are parameters (the reference kept them in a plain
        # list, outside model.parameters(); wire_tpu fixed that)
        params["heads"].append(winit.linear_params(gen, h, o, device=device))
    return params


def _blocks(shape, like, parts):
    """A (rows, cols) matrix of zeros with ``parts``, (row slice, column
    slice, block), set in place: autograd carries the blocks' gradients."""
    W = torch.zeros(shape, dtype=like.dtype, device=like.device)
    for rows, cols, block in parts:
        W[rows, cols] = block
    return W


def _canon_mscale_hier(params, spec: INRSpec):
    """The whole hierarchy as one canonical chain (wire_tpu/nn/models.py:
    _canon_mscale_hier).  The state carries three lane groups, [trunk (h) |
    coords (d) | head-sum (o)], m = h + d + o lanes: identity lanes ferry
    the coordinates to each stage's first layer and add up the heads.
    Stage k > 0 first widens to [x_in | x_prev | coords | acc + head_{k-1}]
    (h + m lanes), then contracts [x_in, x_prev] through its concat layer.
    The final linear reads the last head and the accumulator."""
    d, h, o = spec.in_features, spec.hidden_features, spec.out_features
    stages, heads = params["stages"], params["heads"]
    like = stages[0][0]["w"]
    I_d, I_h, I_o = (torch.eye(k, dtype=like.dtype, device=like.device)
                     for k in (d, h, o))
    m = h + d + o
    sl = slice

    def lane_ab(s, b, carry):
        return (torch.cat([_full(h, 1.0 / s, like), _full(carry, 1.0, like)]),
                torch.cat([b / s, _full(carry, 0.0, like)]))

    def layer(W, alpha_beta):
        return {"w": W, "alpha": alpha_beta[0], "beta": alpha_beta[1]}

    def mid(lay, s):
        W = _blocks((m, m), like, [(sl(0, h), sl(0, h), lay["w"]),
                                   (sl(h, h + d), sl(h, h + d), I_d),
                                   (sl(h + d, m), sl(h + d, m), I_o)])
        return layer(W, lane_ab(s, lay["b"], d + o))

    s0 = spec.scale_tensor[0]
    W = _blocks((d, m), like, [(sl(0, d), sl(0, h), stages[0][0]["w"]),
                               (sl(0, d), sl(h, h + d), I_d)])
    layers = [layer(W, lane_ab(s0, stages[0][0]["b"], d + o))]
    layers += [mid(lay, s0) for lay in stages[0][1:]]
    for k in range(1, len(spec.scale_tensor)):
        sk = spec.scale_tensor[k]
        W = _blocks((m, h + m), like, [
            (sl(0, h), sl(h, 2 * h), I_h),
            (sl(0, h), sl(2 * h + d, h + m), heads[k - 1]["w"]),
            (sl(h, h + d), sl(0, h), stages[k][0]["w"]),
            (sl(h, h + d), sl(2 * h, 2 * h + d), I_d),
            (sl(h + d, m), sl(2 * h + d, h + m), I_o)])
        alpha = torch.cat([_full(h, 1.0 / sk, like), _full(m, 1.0, like)])
        beta = torch.cat([stages[k][0]["b"] / sk, _full(h + d, 0.0, like),
                          heads[k - 1]["b"]])
        layers.append(layer(W, (alpha, beta)))
        W = _blocks((h + m, m), like, [
            (sl(0, 2 * h), sl(0, h), stages[k][1]["w"]),
            (sl(2 * h, 2 * h + d), sl(h, h + d), I_d),
            (sl(2 * h + d, h + m), sl(h + d, m), I_o)])
        layers.append(layer(W, lane_ab(sk, stages[k][1]["b"], d + o)))
        layers += [mid(lay, sk) for lay in stages[k][2:]]
    wf = _blocks((m, o), like, [(sl(0, h), sl(0, o), heads[-1]["w"]),
                                (sl(h + d, m), sl(0, o), I_o)])
    return {"layers": layers, "final": {"w": wf, "b": heads[-1]["b"]}}


def _hier_kinds(spec: INRSpec):
    """Lane segments per layer of the fold: the trunk's qspline lanes, then
    identity lanes for what the state carries."""
    d, h, o = spec.in_features, spec.hidden_features, spec.out_features
    ntrunk = 2 + max(spec.hidden_layers - 1, 0)
    mid = (("qspline", h), ("identity", d + o))
    kinds = [mid] * ntrunk
    for _ in range(1, len(spec.scale_tensor)):
        kinds.append((("qspline", h), ("identity", h + d + o)))
        kinds += [mid] * (ntrunk - 1)
    return tuple(kinds)


def mscale_hier_apply(params, coords, spec: INRSpec):
    if _use_fused(spec):
        return _fused_real(coords, _hier_kinds(spec),
                           _canon_mscale_hier(params, spec))
    out = 0
    x = coords
    for stage, s in enumerate(spec.scale_tensor):
        layers = params["stages"][stage]
        if stage:
            # the stage's first layer reads the coordinates, its second the
            # concat with the last stage's trunk (bspline_mscale_hier.py:
            # 112-122)
            x_in = _bspline_layer(layers[0], coords, s, "divide")
            x = torch.cat([x_in, x], dim=-1)
            layers = layers[1:]
        for lp in layers:
            x = _bspline_layer(lp, x, s, "divide")
        out = out + linear(params["heads"][stage], x)
    return out


mscale_hl_step = _make_real_step(mscale_hl_apply, _mscale_hl_kinds,
                                 _canon_mscale_hl,
                                 use_ok=_mscale_hl_fusable)
mscale_hier_step = _make_real_step(mscale_hier_apply, _hier_kinds,
                                   _canon_mscale_hier)


# ===========================================================================
# MFN - Gabor multiplicative filter network (ops/mfn.py)
# ===========================================================================

def mfn_init(gen, spec: INRSpec, device="cpu"):
    """k = hidden_layers + 1 Gabor filters with gamma ~ Gamma(6 / k), k - 1
    linears with w, b ~ U(+-sqrt(1 / h)), and the final linear
    (wire_tpu/nn/models.py:579-594)."""
    k = spec.hidden_layers + 1
    h = spec.hidden_features
    params = {}
    for i in range(k):
        params[f"gabor_{i}"] = winit.mfn_gabor_params(
            gen, spec.in_features, h, alpha=6.0 / k, device=device)
    for i in range(k - 1):
        params[f"linear_{i}"] = winit.linear_params(gen, h, h, device=device)
    params["final"] = winit.linear_params(gen, h, spec.out_features,
                                          device=device)
    return params


def mfn_gabor(p, x):
    """exp(-gamma/2 ||x - mu||^2) sin(x w + b) (wire_tpu/nn/models.py:597-
    602), the norm in its expanded form |x|^2 + |mu|^2 - 2 x mu^T, in the
    JAX path's order of operations.  The phase q = x w + b reaches the
    hundreds at init, where one rounding step is ~3e-5: x w is a matmul
    here as there (on the CPU both round it as fma(x_1, w_1, x_0 w_0), and
    csrc/mfn.cu forms it so too), so the three agree on q."""
    norm = ((x * x).sum(-1, keepdim=True) + (p["mu"] * p["mu"]).sum(-1)
            - 2.0 * (x @ p["mu"].t()))
    return torch.exp(-0.5 * p["gamma"] * norm) * torch.sin(x @ p["w"]
                                                           + p["b"])


def mfn_apply_plain(params, coords, spec: INRSpec):
    """The MFN forward in plain PyTorch ops (autograd differentiates it):
    z_0 = g_0(x), z_j = (z_{j-1} W_{j-1} + c_{j-1}) g_j(x), y = z_{k-1}
    W_f + b_f."""
    k = spec.hidden_layers + 1
    z = mfn_gabor(params["gabor_0"], coords)
    for i in range(k - 1):
        z = linear(params[f"linear_{i}"], z) * mfn_gabor(
            params[f"gabor_{i + 1}"], coords)
    return linear(params["final"], z)


def mfn_apply(params, coords, spec: INRSpec):
    """The MFN forward: the apply/VJP kernel pair (ops/mfn.py:mfn_mlp)
    unless ``spec.fused == 'never'`` (wire_tpu/nn/models.py:605-620); that
    module runs the plain body for CPU tensors and the kernels for CUDA
    tensors.  An MFN always ends in a plain linear, so
    ``outermost_linear`` does not gate it."""
    if spec.fused == "never":
        return mfn_apply_plain(params, coords, spec)
    from wire_tpu_torch.ops.mfn import mfn_mlp
    return mfn_mlp(params, coords, spec)


def mfn_step(params, coords, target, spec, *, nvalid=None, denom=None,
             gt=None, want_metrics=False, scratch=None):
    """MFN train-step dispatch to the step kernel (ops/mfn.py:mfn_step)."""
    from wire_tpu_torch.ops.mfn import mfn_step as step
    return step(params, coords, target, spec, nvalid=nvalid, denom=denom,
                gt=gt, want_metrics=want_metrics, scratch=scratch)
