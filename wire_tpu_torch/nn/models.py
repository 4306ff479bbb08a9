"""The INR families as (init, apply, step) functions over parameter trees
(port of wire_tpu/nn/models.py: WIRE, :32-246; WIRE-2D, :253-306; the
real Gabor realgabor, :448-490; the canonical real families siren, gauss,
relu/posenc and the B-splines form, cubic, srelu, sig and knots,
:311-733; the Gabor MFN, :579-631; the multiscale B-splines mscale_1,
mscale_1_new/repIN, mscale_HL, mscale_2 and mscale_hier, :735-1146; the
step hooks at :1160-1320).

Parameters are nested dicts and lists of tensors with the JAX package's
names and layouts (WIRE: ``first{w,b}``, ``hidden_i{wr,wi,br,bi}``,
``final{wr,wi,br,bi}``; WIRE-2D: ``first_lin``/``first_orth{w,b}``,
``hidden_i_lin``/``hidden_i_orth{wr,wi,br,bi}``, ``final{wr,wi,br,bi}``;
realgabor: ``{first, hidden_i}`` each ``{freqs, scale}`` of ``{w, b}``,
``final{w,b}``; mscale_1: ``first``, ``trunk_in``, ``hidden_i``, ``final``;
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

The batched multi-fit (``INR.step_grads_many``, ``INR.apply_many``) follows
the serial route.  Where the serial step or apply runs a kernel, a family's
replica hooks (``REPLICA_HOOKS`` of nn/registry.py) run that kernel's
replica axis on the card: WIRE's, WIRE-2D's, the MFN's, the canonical real
families' and mscale_2's (a folding family folds its stacked parameters
with ``torch.func.vmap`` of its fold and maps the canonical gradients back
with ``torch.func.vjp``, so the fold's launches do not grow with M).
Where the serial step is autodiff of the apply, the batched step is
autodiff of the batched apply (``autodiff_step_many``): the family's
replica apply hook, or ``torch.func.vmap`` of its plain apply
(``vmap_apply``), one launch sequence for all M.
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
                  denom=None, gt=None, want_metrics=False, penalty=None):
    """(pred, dparams[, (sse_target, sse_gt)]) of
    ``loss = sum_{rows < nvalid} (pred - target)^2 / denom`` by autodiff of
    ``apply_fn`` (wire_tpu/nn/models.py:151-173), plus ``penalty(p,
    pred)`` where given: a term of the parameter tree being differentiated
    and of this step's prediction (the trainer's total variation).
    Parameters that the output does not use (WIRE's final ``bi``) get zero
    gradients."""
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
        if penalty is not None:
            loss = loss + penalty(p, pred)
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


def autodiff_step_many(apply_many, params_stack, coords, target, spec, *,
                       nvalid=None, denom=None, gt=None, want_metrics=False):
    """``autodiff_step`` of M replicas at once: (pred (M, n, o), dparams
    stacked as the parameters[, (sse_target, sse_gt) as two (M,)
    tensors]).  ``apply_many(params_stack, coords, spec)`` is the batched
    apply (a family's replica hook, or ``vmap_apply`` of its plain apply);
    the loss is the sum of the replicas' losses, each masked to the shared
    ``nvalid`` tail and divided by the same ``denom`` as ``autodiff_step``,
    so one ``torch.autograd.grad`` gives each replica the gradient of its
    own loss.  coords (n, d), target and gt (n, o) shared or each with a
    leading M.  The SSE sums are one reduction a replica, each over its own
    slice as the serial step reduces it."""
    from wire_tpu_torch.ops.wire_step import shared_nvalid
    M = tree.replicas(params_stack)
    nvalid = shared_nvalid(nvalid, M)
    for x in (target, gt):
        tree.replica_axis(x, M)
    n, c = target.shape[-2:]
    dn = float(n * c) if denom is None else denom
    paths, leaves, p = grad_leaves(params_stack)
    mask = None
    if nvalid is not None:
        rows = torch.arange(n, device=coords.device)[:, None]
        mask = (rows < nvalid).to(target.dtype)
    with torch.enable_grad(), _fp32_matmuls():
        pred = apply_many(p, coords, spec)
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
    return pred, dparams, tuple(
        torch.stack([torch.sum(e[r] * e[r]) for r in range(M)])
        for e in (err_t, err_g))


def vmap_apply(apply_fn):
    """The batched apply ``(params_stack, coords, spec) -> (M, ..., o)`` of
    a plain ``apply_fn(params, coords, spec)``: ``torch.func.vmap`` over the
    parameters' leading M and, per replica, the coordinates' (shared
    (rows, d) coordinates are not mapped), so its PyTorch launches do not
    grow with M.  Differentiable in the parameters by autograd."""
    def apply_many(params_stack, coords, spec):
        M = tree.replicas(params_stack)
        return torch.func.vmap(
            lambda p, c: apply_fn(p, c, spec),
            in_dims=(0, tree.replica_axis(coords, M)))(params_stack, coords)
    return apply_many


@dataclasses.dataclass(frozen=True)
class ReplicaHooks:
    """A family's batched multi-fit: ``step(params_stack, coords, target,
    spec, *, nvalid, denom, gt, want_metrics, scratch)`` and
    ``apply(params_stack, coords, spec)`` over replica-stacked parameters
    (one launch sequence for all M on the card, the plain versions on the
    CPU), each None where the family has no kernel for it (the step is
    then ``autodiff_step_many`` of the batched apply, the apply
    ``vmap_apply`` of the family's own), and ``ok(params, spec)``: whether
    the hooks serve this spec and (one replica's) parameters;
    ``step_ok`` the step's own gate where it differs from ``ok``."""
    step: object = None
    apply: object = None
    ok: object = None
    step_ok: object = None


class INR:
    """A model family instance: ``params = m.init(gen, device)``,
    ``y = m.apply(params, coords)``, ``m.step_grads(...)``."""

    def __init__(self, spec: INRSpec, init_fn, apply_fn, step_fn=None,
                 replica_hooks=None):
        self.spec = spec
        self._init = init_fn
        self._apply = apply_fn
        self._step = step_fn
        self._replica = ReplicaHooks() if replica_hooks is None \
            else replica_hooks

    def init(self, gen: torch.Generator, device="cpu"):
        return self._init(gen, self.spec, device)

    def apply(self, params, coords):
        return self._apply(params, coords, self.spec)

    def step_grads(self, params, coords, target, *, nvalid=None, denom=None,
                   gt=None, want_metrics=False, scratch=None, penalty=None):
        """(pred, dparams) of ``loss = sum_{rows<nvalid}(pred-t)^2 / denom``,
        plus the masked squared-error sums ``(sse_target, sse_gt)`` when
        ``want_metrics`` (gt defaults to target).  Families with a step
        kernel (WIRE, WIRE-2D, the MFN, the canonical real families) run it
        unless ``spec.fused == 'never'``; the rest use autodiff of
        ``apply``.  A ``penalty(p, pred)`` (``autodiff_step``) is added to
        the loss by autodiff of ``apply`` for every family: no step kernel
        takes an extra term, so the step is the family's apply/VJP pair on
        the card (wire_tpu/train/trainer.py:995-998).
        Invalid rows must be a tail; nvalid defaults to n and denom to
        n*c."""
        if penalty is not None:
            return autodiff_step(self._apply, params, coords, target,
                                 self.spec, nvalid=nvalid, denom=denom, gt=gt,
                                 want_metrics=want_metrics, penalty=penalty)
        if self._step is not None and self.spec.fused != "never":
            return self._step(params, coords, target, self.spec,
                              nvalid=nvalid, denom=denom, gt=gt,
                              want_metrics=want_metrics, scratch=scratch)
        return autodiff_step(self._apply, params, coords, target, self.spec,
                             nvalid=nvalid, denom=denom, gt=gt,
                             want_metrics=want_metrics)

    def num_params(self, params):
        return sum(t.numel() for _, t in tree.leaves(params))

    def _replica_hook(self, hook, ok, params_stack):
        """The family's replica hook for this call, or None where it has
        none or its gate ``ok`` refuses this spec (the batched route is then
        that of the serial call: autodiff, or the plain apply vmapped)."""
        if hook is not None and (ok is None or ok(
                tree.index(params_stack, 0), self.spec)):
            return hook
        return None

    def apply_many(self, params_stack, coords):
        """M forwards at once: every leaf of ``params_stack`` has a leading
        M; coords (rows, d) shared or (M, ..., rows, d) per replica ->
        (M, ..., rows, o).  Where the serial apply runs a kernel pair
        (WIRE's ``wire_mlp``, WIRE-2D's ``wire2d_mlp``, the MFN's
        ``mfn_mlp``, the real families' and mscale_2's ``real_mlp``), the
        family's replica hook runs it on the card, one launch sequence a
        direction for all M; otherwise ``vmap_apply`` of the plain
        apply."""
        hook = self._replica_hook(self._replica.apply, self._replica.ok,
                                  params_stack)
        if hook is None:
            hook = vmap_apply(self._apply)
        return hook(params_stack, coords, self.spec)

    def step_grads_many(self, params_stack, coords, target, *, nvalid=None,
                        denom=None, gt=None, want_metrics=False,
                        scratch=None):
        """``step_grads`` of M replicas at once: every leaf of
        ``params_stack`` has a leading M; coords (n, d), target and gt
        (n, o) shared, or each with a leading M; nvalid and denom shared.
        Returns pred (M, n, o), the gradients stacked as the parameters and,
        with ``want_metrics``, the SSE sums as two (M,) tensors.  Where the
        serial step runs a kernel (WIRE's ``wire_step``, WIRE-2D's
        ``wire2d_step``, the MFN's ``mfn_step``, the real families'
        ``real_step``, mscale_2's ``mscale2_step``), the family's replica
        hook runs it on the card, one launch sequence for all M; where the
        serial step is autodiff, ``autodiff_step_many`` of
        ``apply_many``."""
        rep = self._replica
        hook = self._replica_hook(
            rep.step, rep.ok if rep.step_ok is None else rep.step_ok,
            params_stack)
        if hook is not None:
            return hook(params_stack, coords, target, self.spec,
                        nvalid=nvalid, denom=denom, gt=gt,
                        want_metrics=want_metrics, scratch=scratch)
        return autodiff_step_many(
            lambda p, c, _spec: self.apply_many(p, c), params_stack, coords,
            target, self.spec, nvalid=nvalid, denom=denom, gt=gt,
            want_metrics=want_metrics)


def _fused_on(params, spec):
    """The replica gate of WIRE and the MFN: their kernels unless
    ``fused == 'never'``."""
    return spec.fused != "never"


def wire_step_many(params_stack, coords, target, spec, **kw):
    """WIRE's replica step hook (ops/wire_step.py:wire_step_many)."""
    from wire_tpu_torch.ops.wire_step import wire_step_many as step
    return step(params_stack, coords, target, spec, **kw)


def wire_apply_many(params_stack, coords, spec):
    """WIRE's replica apply hook (ops/wire_mlp.py:wire_mlp_many)."""
    from wire_tpu_torch.ops.wire_mlp import wire_mlp_many
    return wire_mlp_many(params_stack, coords, spec)


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


def wire2d_step_many(params_stack, coords, target, spec, **kw):
    """WIRE-2D's replica step hook (ops/wire2d.py:wire2d_step_many)."""
    from wire_tpu_torch.ops.wire2d import wire2d_step_many as step
    return step(params_stack, coords, target, spec, **kw)


def wire2d_apply_many(params_stack, coords, spec):
    """WIRE-2D's replica apply hook (ops/wire2d.py:wire2d_mlp_many)."""
    from wire_tpu_torch.ops.wire2d import wire2d_mlp_many
    return wire2d_mlp_many(params_stack, coords, spec)


# ===========================================================================
# realgabor - the real Gabor layer, cos(omega0 freqs(x)) exp(-(sigma0
# scale(x))^2), with two linears per layer and real parameters; no kernel,
# it trains by autodiff of its apply (wire_tpu/nn/models.py:440-490)
# ===========================================================================

def realgabor_init(gen, spec: INRSpec, device="cpu"):
    h = spec.hidden_features

    def pair(nin, nout):
        return {"freqs": winit.linear_params(gen, nin, nout, device=device),
                "scale": winit.linear_params(gen, nin, nout, device=device)}

    params = {"first": pair(spec.in_features, h)}
    for i in range(spec.hidden_layers):
        params[f"hidden_{i}"] = pair(h, h)
    if spec.outermost_linear:
        params["final"] = winit.linear_params(gen, h, spec.out_features,
                                              device=device)
    else:
        params["final"] = pair(h, spec.out_features)
    return params


def _real_gabor_layer(p, x, omega0, sigma0):
    omega = omega0 * linear(p["freqs"], x)
    s = sigma0 * linear(p["scale"], x)
    return torch.cos(omega) * torch.exp(-(s * s))


def realgabor_apply(params, coords, spec: INRSpec):
    x = _real_gabor_layer(params["first"], coords, spec.first_omega0,
                          spec.scale)
    for i in range(spec.hidden_layers):
        x = _real_gabor_layer(params[f"hidden_{i}"], x, spec.hidden_omega0,
                              spec.scale)
    if spec.outermost_linear:
        return linear(params["final"], x)
    return _real_gabor_layer(params["final"], x, spec.hidden_omega0,
                             spec.scale)


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


def fold_grads_many(canon_of, params_stack, spec):
    """``fold_grads`` of M replicas at once: (canon_stack, back), the fold
    ``torch.func.vmap`` of ``canon_of(params, spec)`` over the leading M
    (its PyTorch launches do not grow with M) and ``back(dcanon_stack)``,
    the stacked native gradients through ``torch.func.vjp`` of that fold
    (zeros for leaves the fold does not use).  Each replica's canon and
    gradients equal ``fold_grads``' on that replica bit for bit."""
    from wire_tpu_torch.ops.real_mlp import canon_from_leaves, canon_leaves
    flat = tree.leaves(params_stack)
    paths = [path for path, _ in flat]

    def fold(*leaves):
        canon = torch.func.vmap(lambda p: canon_of(p, spec))(
            tree.unflatten(paths, list(leaves)))
        return tuple(t for _, t in canon_leaves(canon))

    ctens, vjp = torch.func.vjp(fold, *[t.detach() for _, t in flat])
    L = (len(ctens) - 2) // 3

    def back(dcanon):
        return tree.unflatten(paths, list(vjp(tuple(
            t for _, t in canon_leaves(dcanon)))))

    return canon_from_leaves(list(ctens), L), back


def _pre_many(pre, coords, spec):
    """A parameter-free input transform on shared (rows, d) coordinates, or
    on each replica's (M, ..., rows, d) through ``torch.func.vmap``."""
    if pre is None:
        return coords
    if coords.ndim == 2:
        return pre(coords, spec)
    return torch.func.vmap(lambda c: pre(c, spec))(coords)


def _real_replica_hooks(kinds_of, canon_of, pre=None, use_ok=None,
                        apply=True):
    """A canonical real family's ReplicaHooks: the step over
    ops/real_mlp.py:real_step_many (the fold of ``fold_grads_many``), the
    apply over real_mlp_many unless ``apply`` is False (a family whose apply
    runs no kernel, as in the JAX package), and the gate: the family's
    kernels serve it (``_use_fused``) and its own ``use_ok`` (read on one
    replica's parameters: shapes alone) passes."""
    def step(params_stack, coords, target, spec, *, nvalid=None,
             denom=None, gt=None, want_metrics=False, scratch=None):
        from wire_tpu_torch.ops.real_mlp import real_step_many
        canon, back = fold_grads_many(canon_of, params_stack, spec)
        out = real_step_many(canon, _pre_many(pre, coords, spec), target,
                             kinds_of(spec), nvalid=nvalid, denom=denom,
                             gt=gt, want_metrics=want_metrics,
                             scratch=scratch)
        return (out[0], back(out[1])) + tuple(out[2:])

    def apply_many(params_stack, coords, spec):
        from wire_tpu_torch.ops.real_mlp import real_mlp_many
        canon = torch.func.vmap(lambda p: canon_of(p, spec))(params_stack)
        return real_mlp_many(canon, _pre_many(pre, coords, spec),
                             kinds_of(spec))

    def ok(params, spec):
        return _use_fused(spec) and (use_ok is None or use_ok(params, spec))

    return ReplicaHooks(step=step, apply=apply_many if apply else None,
                        ok=ok)


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


def bspline_sig_apply(params, coords, spec: INRSpec):
    """The sigmoid-pair bump on every layer, its branch chosen per row by
    the sign of the row's first coordinate (wire_tpu/nn/models.py:706); no
    kernel, it trains by autodiff of this apply."""
    neg = coords[..., :1] < 0
    return _chain(params, coords, spec,
                  lambda p, x: act.bspline_sigmoid(
                      linear(p, x), neg, spec.first_omega0, spec.scale))


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


# ---- mscale_1: one shared first linear applied at every scale -------------

def mscale1_init(gen, spec: INRSpec, device="cpu"):
    """first d -> shf, trunk_in ns shf -> h, max(L - 2, 0) hidden layers,
    final h -> o (wire_tpu/nn/models.py:735-756)."""
    shf, hf = spec.scaled_hidden_features, spec.hidden_features
    ns = len(spec.scale_tensor)
    params = {"first": winit.linear_params(gen, spec.in_features, shf,
                                           device=device),
              "trunk_in": winit.linear_params(gen, shf * ns, hf,
                                              device=device)}
    for i in range(max(spec.hidden_layers - 2, 0)):
        params[f"hidden_{i}"] = winit.linear_params(gen, hf, hf,
                                                    device=device)
    params["final"] = winit.linear_params(gen, hf, spec.out_features,
                                          device=device)
    return params


def _mscale1_names(spec):
    return ["trunk_in"] + [f"hidden_{i}"
                           for i in range(max(spec.hidden_layers - 2, 0))]


def mscale1_apply(params, coords, spec: INRSpec):
    """The first linear at every scale s (on s x), concatenated raw (no
    basis, as the reference leaves it), then 'pre'-mode quadratic-spline
    layers (wire_tpu/nn/models.py:759-772).  The apply has no kernel path,
    as in the JAX package; the step folds to real_step."""
    x = torch.cat([linear(params["first"], s * coords)
                   for s in spec.scale_tensor], dim=-1)
    for nm in _mscale1_names(spec):
        x = _bspline_layer(params[nm], x, spec.scale, "pre")
    if spec.outermost_linear:
        return linear(params["final"], x)
    return _bspline_layer(params["final"], x, spec.scale, "pre")


def _canon_mscale1(params, spec):
    """mscale_1 as one canonical chain (wire_tpu/nn/models.py:1205): layer
    0 an identity-basis linear [s_1 W | s_2 W | ...] with beta [b | b |
    ...], the trunk 'pre'-mode layers (alpha = sigma, beta = b)."""
    W, b = params["first"]["w"], params["first"]["b"]
    w0 = torch.cat([s * W for s in spec.scale_tensor], dim=1)
    b0 = torch.cat([b] * len(spec.scale_tensor))
    canon = _canon_uniform(params, spec, spec.scale, lambda bb: bb,
                           names=_mscale1_names(spec))
    canon["layers"].insert(0, {"w": w0, "alpha": _full(w0.shape[1], 1.0, W),
                               "beta": b0})
    return canon


def _mscale1_kinds(spec):
    return ("identity",) + ("qspline",) * len(_mscale1_names(spec))


# ---- mscale_1_new / mscale_repIN: the scaled coordinates tiled wide --------

def mscale_repin_init(gen, spec: INRSpec, device="cpu"):
    return _plain_mlp_init(gen, spec, device)


def repin_expand(coords, spec):
    """Coordinates (..., N, d) tiled per scale into in_features = d ns r
    lanes (r = in_features // (d ns)), in the reference's flattening: the
    (B, ns, N, d r) stack of scaled, tiled coordinates is moved scale-major
    and read back as (B, N, ns d r) rows, so a row holds ns consecutive
    (scale, point) entries (wire_tpu/nn/models.py:774-792)."""
    squeeze = coords.dim() == 2
    if squeeze:
        coords = coords[None]
    B, N, d = coords.shape
    ns = len(spec.scale_tensor)
    repeat = spec.in_features // (d * ns)
    scales = torch.tensor(spec.scale_tensor, dtype=coords.dtype,
                          device=coords.device)
    scaled = scales[None, :, None, None] * coords[:, None]
    tiled = scaled.repeat(1, 1, 1, repeat)
    x = tiled.permute(1, 0, 2, 3).reshape(B, -1, ns * d * repeat)
    return x[0] if squeeze else x


def _canon_repin(params, spec):
    # 'post' mode: B(s (x W + b)) = B(s (x W) + s b)
    s = spec.scale
    return _canon_uniform(params, spec, s, lambda b: s * b)


def _repin_apply_wide(params, x, spec):
    """The family's MLP on the already tiled input ``x``: the real_mlp
    pair unless fused is off ('post'-mode quadratic splines)."""
    if _use_fused(spec):
        return _fused_real(x, ("qspline",) * _n_act_layers(spec),
                           _canon_repin(params, spec))
    return _chain(params, x, spec,
                  lambda p, z: _bspline_layer(p, z, spec.scale, "post"))


def mscale_repin_apply(params, coords, spec: INRSpec):
    return _repin_apply_wide(params, repin_expand(coords, spec), spec)


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


def mscale2_apply_many(params_stack, coords, spec):
    """mscale_2's replica apply hook: every replica's trunk at every scale
    through ops/real_mlp.py:real_mlp_many with ``row_gamma`` (the batched
    form of what ``real_mlp_scales`` passes: one real_mlp pair for all M
    and all scales on the card), then the combiner, ``torch.func.vmap``ped
    over the replicas.  coords (rows, d) shared or (M, ..., rows, d)."""
    from wire_tpu_torch.ops.real_mlp import real_mlp_many
    M = tree.replicas(params_stack)
    trunk = {k: v for k, v in params_stack.items() if k != "combiner"}
    canon = torch.func.vmap(lambda p: _canon_mscale2(p, spec))(trunk)
    ns, d = len(spec.scale_tensor), coords.shape[-1]
    if tree.replica_axis(coords, M) is None:
        lead = coords.shape[:-1]
        X = coords.repeat(ns, 1)
    else:
        lead = coords.shape[1:-1]
        X = coords.reshape(M, -1, d).repeat(1, ns, 1)
    n = X.shape[-2] // ns
    ys = real_mlp_many(canon, X, _mscale2_kinds(spec),
                       row_gamma=(_inv_scales(spec), n))
    outs = ys.reshape((M, ns) + tuple(lead) + (ys.shape[-1],))
    return torch.func.vmap(
        lambda c, y: mscale2_combine(c, y, spec.combine_type))(
            params_stack["combiner"], outs)


def mscale2_step_many(params_stack, coords, target, spec, *, nvalid=None,
                      denom=None, gt=None, want_metrics=False, scratch=None):
    """mscale_2's replica step hook under 'freq_combine' (the serial step's
    kernel route): the stacked trunk folded by ``fold_grads_many``, then
    ops/mscale2_step.py:mscale2_step_many, one launch sequence for all M;
    the combiner's unused heads get structural zeros, as in
    ``mscale2_step``."""
    from wire_tpu_torch.ops.mscale2_step import mscale2_step_many as step
    trunk = {k: v for k, v in params_stack.items() if k != "combiner"}
    canon, back = fold_grads_many(_canon_mscale2, trunk, spec)
    c = params_stack["combiner"]
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
    slice, block), scattered in out of place (so ``torch.func.vmap`` of the
    fold takes it): autograd carries the blocks' gradients."""
    W = torch.zeros(shape, dtype=like.dtype, device=like.device)
    for rows, cols, block in parts:
        band = W[rows].slice_scatter(block, dim=1, start=cols.start,
                                     end=cols.stop)
        W = W.slice_scatter(band, dim=0, start=rows.start, end=rows.stop)
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


mscale1_step = _make_real_step(mscale1_apply, _mscale1_kinds,
                               _canon_mscale1)
# the tiling is the step's parameter-free input transform; the autodiff
# fallback takes the apply on the raw coordinates
mscale_repin_step = _make_real_step(mscale_repin_apply,
                                    _uniform_kinds("qspline"), _canon_repin,
                                    pre=repin_expand)
mscale_hl_step = _make_real_step(mscale_hl_apply, _mscale_hl_kinds,
                                 _canon_mscale_hl,
                                 use_ok=_mscale_hl_fusable)
mscale_hier_step = _make_real_step(mscale_hier_apply, _hier_kinds,
                                   _canon_mscale_hier)

# the replica hooks of the families that fold onto real_step; bspline_knots
# and mscale_1 have no apply kernel, as in the JAX package, so their
# batched apply is vmap_apply of their plain apply
siren_replicas = _real_replica_hooks(_uniform_kinds("sine"), _canon_siren)
gauss_replicas = _real_replica_hooks(_uniform_kinds("gauss"), _canon_gauss)
relu_replicas = _real_replica_hooks(_uniform_kinds("relu"), _canon_relu,
                                    pre=_posenc_pre)
bspline_form_replicas = _real_replica_hooks(_uniform_kinds("qspline"),
                                            _canon_form)
bspline_cubic_replicas = _real_replica_hooks(_uniform_kinds("cspline"),
                                             _canon_cubic)
bspline_srelu_replicas = _real_replica_hooks(_uniform_kinds("srelu"),
                                             _canon_srelu)
bspline_knots_replicas = _real_replica_hooks(_uniform_kinds("qspline"),
                                             _canon_knots, apply=False)
mscale1_replicas = _real_replica_hooks(_mscale1_kinds, _canon_mscale1,
                                       apply=False)
mscale_repin_replicas = _real_replica_hooks(_uniform_kinds("qspline"),
                                            _canon_repin, pre=repin_expand)
mscale_hl_replicas = _real_replica_hooks(_mscale_hl_kinds, _canon_mscale_hl,
                                         use_ok=_mscale_hl_fusable)
mscale_hier_replicas = _real_replica_hooks(_hier_kinds, _canon_mscale_hier)


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


def mfn_step_many(params_stack, coords, target, spec, **kw):
    """The MFN's replica step hook (ops/mfn.py:mfn_step_many)."""
    from wire_tpu_torch.ops.mfn import mfn_step_many as step
    return step(params_stack, coords, target, spec, **kw)


def mfn_apply_many(params_stack, coords, spec):
    """The MFN's replica apply hook (ops/mfn.py:mfn_mlp_many)."""
    from wire_tpu_torch.ops.mfn import mfn_mlp_many
    return mfn_mlp_many(params_stack, coords, spec)


wire_replicas = ReplicaHooks(step=wire_step_many, apply=wire_apply_many,
                             ok=_fused_on)
wire2d_replicas = ReplicaHooks(step=wire2d_step_many,
                               apply=wire2d_apply_many, ok=_fused_on)
# the kernels serve mscale_2's apply unless fused is off, its step only
# under 'freq_combine' (nn/models.py:mscale2_step's own condition); the other
# combine modes train by autodiff of the batched apply
mscale2_replicas = ReplicaHooks(
    step=mscale2_step_many, apply=mscale2_apply_many,
    ok=lambda params, spec: _use_fused(spec),
    step_ok=lambda params, spec: (_use_fused(spec)
                                  and spec.combine_type == "freq_combine"))
mfn_replicas = ReplicaHooks(step=mfn_step_many, apply=mfn_apply_many,
                            ok=_fused_on)
