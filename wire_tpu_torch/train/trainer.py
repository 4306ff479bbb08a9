"""Adam fitting of an INR to one signal (port of wire_tpu/train/trainer.py:
FitConfig, FitResult, track_best, _lr_schedule, make_optimizer, the
full-batch branch of fit_pointwise, and fit_operator with a full-grid
render).

Loop semantics: Adam as optax's ``scale_by_adam(eps_root=0)`` followed by
``scale_by_schedule``, the learning rate decaying by
``lr_decay ** min(floor(step / nchunks) / niters, 1)`` at the pre-increment
step count, optionally scaled by ``min(1, maxpoints / npoints)``; a tuple
learning rate gives one rate per stage, a leaf's stage being the first
list index on its path (mscale_hier's ``stages[k]`` and ``heads[k]``);
per-epoch
MSE vs the target and vs the clean gt from the step's SSE sums; the best
reconstruction and parameters by MSE kept on the device with masked copies
(no host sync per epoch).

Only the full-batch protocol of fit_pointwise is here: one chunk holding
every point (``maxpoints >= npoints``), which is what the WIRE denoise
presets give at 256 x 256.  The chunked/permutation epochs are a later
slice.  fit_operator renders the whole grid every iteration; its chunked
render, checkpoint/resume and mesh variant are later slices too.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

import numpy as np
import torch

from wire_tpu_torch import tree
from wire_tpu_torch.device import resolve
from wire_tpu_torch.nn.models import grad_leaves, grads_tree
from wire_tpu_torch.ops.wire_step import StepScratch


@dataclasses.dataclass(frozen=True)
class FitConfig:
    learning_rate: Any = 5e-3      # float, or a tuple: one per stage
    niters: int = 2000             # epochs
    maxpoints: int = 256 * 256     # chunk size
    lr_decay: float = 0.1          # final LR multiplier
    # the reference denoise scripts scale LR by min(1, maxpoints/npoints)
    scale_lr_by_batch: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass
class FitResult:
    params: Any
    best_params: Any
    best_rec: np.ndarray     # reconstruction with the best tracked metric
    final_rec: np.ndarray
    mse_gt: np.ndarray       # per-epoch MSE vs clean ground truth
    mse_noisy: np.ndarray    # per-epoch MSE vs the (noisy) fitting target
    best_mse: float
    wall_time_s: float
    # device time per epoch from CUDA events (None on the CPU)
    step_ms: Optional[float] = None


def track_best(is_best, current, best):
    """Best-so-far update of nested dicts/tuples of tensors: a masked copy
    (``torch.where`` on a device bool), so no host sync."""
    if isinstance(current, dict):
        return {k: track_best(is_best, current[k], best[k]) for k in current}
    if isinstance(current, (tuple, list)):
        return type(current)(track_best(is_best, c, b)
                             for c, b in zip(current, best))
    return torch.where(is_best, current, best)


def lr_schedule(cfg: FitConfig, nchunks: int):
    """step -> decay factor (a Python float) of the base rate, stepped once
    per epoch; the scalar learning rate folded in (a tuple of rates, one per
    stage, multiplies it instead, as _lr_schedule's base of 1.0)."""
    base = (float(cfg.learning_rate) if np.isscalar(cfg.learning_rate)
            else 1.0)

    def schedule(step):
        return base * cfg.lr_decay ** min((step // nchunks) / cfg.niters, 1.0)

    return schedule


def stage_rates(cfg: FitConfig, paths):
    """Per leaf, the rate the schedule is multiplied by: 1 for a scalar
    learning rate, else ``learning_rate[stage]``, the stage the first list
    index on the leaf's path (0 where there is none)."""
    if np.isscalar(cfg.learning_rate):
        return [1.0] * len(paths)
    lrs = tuple(float(lr) for lr in cfg.learning_rate)
    return [lrs[tree.stage_of(path)] for path in paths]


class Adam:
    """optax ``chain(scale_by_adam(b1, b2, eps, eps_root=0),
    scale_by_schedule(-lr(step) * batch_scale))`` on a parameter tree,
    updated in place:
        mu = b1 mu + (1-b1) g;  nu = b2 nu + (1-b2) g^2;  k += 1
        p += -lr(k-1) * batch_scale * (mu / (1-b1^k)) / (sqrt(nu / (1-b2^k)) + eps)
    A tuple learning rate is make_optimizer's ``multi_transform`` of one such
    chain per stage, each leaf labelled by ``stage_rates``.
    """

    def __init__(self, cfg: FitConfig, params, npoints=None, nchunks=1):
        self.cfg = cfg
        self.batch_scale = 1.0
        if cfg.scale_lr_by_batch and npoints is not None:
            self.batch_scale = min(1.0, cfg.maxpoints / npoints)
        self.schedule = lr_schedule(cfg, nchunks)
        flat = tree.leaves(params)
        self.paths = [path for path, _ in flat]
        rates = stage_rates(cfg, self.paths)
        # leaf indices per distinct rate, one foreach update each
        self.groups = {}
        for i, r in enumerate(rates):
            self.groups.setdefault(r, []).append(i)
        self.mu = [torch.zeros_like(t) for _, t in flat]
        self.nu = [torch.zeros_like(t) for _, t in flat]
        self.count = 0

    def step(self, params, grads):
        cfg = self.cfg
        p = [tree.get(params, path) for path in self.paths]
        g = [tree.get(grads, path) for path in self.paths]
        torch._foreach_mul_(self.mu, cfg.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - cfg.b1)
        torch._foreach_mul_(self.nu, cfg.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - cfg.b2)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - cfg.b1 ** self.count
        bc2 = 1.0 - cfg.b2 ** self.count
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        for rate, idx in self.groups.items():
            torch._foreach_add_([p[i] for i in idx], [upd[i] for i in idx],
                                alpha=-lr * rate * self.batch_scale)


def _as_tensor(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(device, torch.float32).contiguous()


def fit_pointwise(model, params, coords, target, cfg: FitConfig, *,
                  gt=None, device=None):
    """Fit an INR pointwise to ``target`` sampled at ``coords``.

    coords (N, d), target (N, c), gt optional clean (N, c): numpy arrays
    or tensors.  The best epoch is the one with the least MSE vs gt (vs
    the target when gt is None).  ``params`` is not modified.  Runs on ``device``
    (default cuda; raises without a card unless device='cpu')."""
    dev = resolve(device)
    coords = _as_tensor(coords, dev)
    target = _as_tensor(target, dev)
    gt_arr = target if gt is None else _as_tensor(gt, dev)
    npoints, c = target.shape
    mp = min(cfg.maxpoints, npoints)
    nchunks = math.ceil(npoints / mp)
    npad = nchunks * mp - npoints
    if nchunks != 1 or npad != 0:
        raise NotImplementedError(
            f"fit_pointwise: maxpoints={cfg.maxpoints} < npoints={npoints} "
            f"needs the chunked epochs, which are not ported yet")

    params = tree.map(lambda v: v.detach().to(dev, torch.float32).clone(),
                      params)
    opt = Adam(cfg, params, npoints=npoints, nchunks=nchunks)
    best_params = tree.map(torch.clone, params)
    best_rec = torch.zeros_like(target)
    rec = best_rec
    best_mse = torch.tensor(float("inf"), device=dev)
    hist_gt = torch.empty(cfg.niters, device=dev)
    hist_noisy = torch.empty(cfg.niters, device=dev)
    inv_nc = 1.0 / (npoints * c)
    scratch = StepScratch()

    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.synchronize(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.time()
    for epoch in range(cfg.niters):
        pred, grads, (sse_t, sse_g) = model.step_grads(
            params, coords, target, gt=gt_arr, want_metrics=True,
            scratch=scratch)
        opt.step(params, grads)
        rec = pred
        mse_noisy = sse_t * inv_nc
        mse_gt = sse_g * inv_nc
        hist_gt[epoch] = mse_gt
        hist_noisy[epoch] = mse_noisy
        is_best = mse_gt < best_mse
        best_mse = torch.where(is_best, mse_gt, best_mse)
        best_rec, best_params = track_best(is_best, (rec, params),
                                           (best_rec, best_params))
    step_ms = None
    if on_cuda:
        ev1.record()
        torch.cuda.synchronize(dev)
        step_ms = ev0.elapsed_time(ev1) / max(cfg.niters, 1)
    wall = time.time() - t0
    return FitResult(
        params=params, best_params=best_params,
        best_rec=best_rec.cpu().numpy(), final_rec=rec.cpu().numpy(),
        mse_gt=hist_gt.cpu().numpy(), mse_noisy=hist_noisy.cpu().numpy(),
        best_mse=float(best_mse), wall_time_s=wall, step_ms=step_ms)


def fit_operator(model, params, coords, measurement, operator_fn,
                 cfg: FitConfig, *, gt_field=None, field_shape, track="gt",
                 device=None, checkpoint=None, render_chunked=False,
                 mesh=None):
    """Fit through a differentiable forward operator
    (wire_tpu/train/trainer.py:1139-1264): every iteration renders the FULL
    coordinate grid, applies ``operator_fn`` to the field reshaped to
    ``field_shape`` and takes the MSE against ``measurement``, then one Adam
    step with the learning rate decayed per iteration.

    coords (N, d), measurement and gt_field (the clean field, for
    tracking): numpy arrays or tensors.  The best iteration is the one with
    the least MSE of the field vs gt_field (``track="gt"``) or the least
    loss (``track="loss"``, or no gt_field); as in the JAX loop, the best
    field is the one rendered before the step and the best parameters are
    those after it.  ``mse_gt`` holds the tracked history and
    ``mse_noisy`` the loss history.  The optimizer's step count runs on
    over all iterations (the JAX package's scan segments keep it too).
    ``params`` is not modified.  Runs on ``device`` (default cuda; raises
    without a card unless device='cpu')."""
    if render_chunked or checkpoint is not None or mesh is not None:
        raise NotImplementedError(
            "fit_operator: render_chunked, checkpoint/resume and the mesh "
            "variant are not ported yet")
    if track not in ("gt", "loss"):
        raise ValueError(f"fit_operator: track={track!r}, expected 'gt' or "
                         f"'loss'")
    dev = resolve(device)
    coords = _as_tensor(coords, dev)
    measurement = _as_tensor(measurement, dev)
    track_gt = gt_field is not None and track == "gt"
    gt_arr = _as_tensor(gt_field, dev) if track_gt else None
    field_shape = tuple(field_shape)

    params = tree.map(lambda v: v.detach().to(dev, torch.float32).clone(),
                      params)
    opt = Adam(cfg, params, nchunks=1)
    best_params = tree.map(torch.clone, params)
    best_field = torch.zeros(field_shape, dtype=torch.float32, device=dev)
    best_loss = torch.tensor(float("inf"), device=dev)
    hist_loss = torch.empty(cfg.niters, device=dev)
    hist_tracked = torch.empty(cfg.niters, device=dev)

    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.synchronize(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.time()
    for it in range(cfg.niters):
        paths, leaves, p = grad_leaves(params)
        with torch.enable_grad():
            field = model.apply(p, coords).reshape(field_shape)
            est = operator_fn(field)
            loss = torch.mean((est - measurement) ** 2)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        opt.step(params, grads_tree(paths, leaves, flat))
        field = field.detach()
        loss = loss.detach()
        tracked = torch.mean((field - gt_arr) ** 2) if track_gt else loss
        hist_loss[it] = loss
        hist_tracked[it] = tracked
        is_best = tracked < best_loss
        best_loss = torch.where(is_best, tracked, best_loss)
        best_field, best_params = track_best(is_best, (field, params),
                                             (best_field, best_params))
    step_ms = None
    if on_cuda:
        ev1.record()
        torch.cuda.synchronize(dev)
        step_ms = ev0.elapsed_time(ev1) / max(cfg.niters, 1)
    wall = time.time() - t0
    return FitResult(
        params=params, best_params=best_params,
        best_rec=best_field.cpu().numpy(), final_rec=None,
        mse_gt=hist_tracked.cpu().numpy(), mse_noisy=hist_loss.cpu().numpy(),
        best_mse=float(best_loss), wall_time_s=wall, step_ms=step_ms)
