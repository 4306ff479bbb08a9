"""The WIRE INR as (init, apply, step) functions over parameter dicts
(port of wire_tpu/nn/models.py:32-246).

Parameters are nested dicts of tensors with the JAX package's names and
layouts (``first{w,b}``, ``hidden_i{wr,wi,br,bi}``, ``final{wr,wi,br,bi}``,
weights ``(in, out)``), so ``wire_tpu_torch.bridge`` moves a JAX init across
unchanged.  Topology: ``[first Gabor layer] + hidden_layers x [Gabor layer]
+ [final complex linear]``, real output (the real part).
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
    """The configuration surface of the model factory (the WIRE subset of
    wire_tpu's INRSpec)."""
    nonlin: str
    in_features: int = 2
    hidden_features: int = 256
    hidden_layers: int = 2
    out_features: int = 1
    first_omega0: float = 30.0
    hidden_omega0: float = 30.0
    scale: float = 10.0
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
        kernel (WIRE) run it unless ``spec.fused == 'never'``; the rest use
        autodiff of ``apply``.  Invalid rows must be a tail; nvalid
        defaults to n and denom to n*c."""
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
