"""Adam fitting of an INR to one signal (port of wire_tpu/train/trainer.py:
FitConfig, FitResult, track_best, _lr_schedule, make_optimizer,
fit_pointwise with its full-batch, chunked per-point and block-permuted
epochs, and fit_operator with a full-grid render).

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

fit_pointwise takes one full batch when ``maxpoints >= npoints`` (the
WIRE denoise presets at 256 x 256); otherwise every epoch draws a fresh
permutation of the points (or of contiguous ``block_perm``-point blocks)
from a torch.Generator seeded with ``cfg.seed`` on the fit's device, pads
it with tail sentinels to ``nchunks x maxpoints`` and takes one step per
chunk, the sentinel rows masked through the step's ``nvalid``.  TV
regularization, checkpoint/resume and the sharded fit are later slices.
fit_operator renders the whole grid every iteration; its chunked render,
checkpoint/resume and mesh variant are later slices too.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from wire_tpu_torch import tree
from wire_tpu_torch.device import resolve
from wire_tpu_torch.nn.models import grad_leaves, grads_tree
from wire_tpu_torch.ops.wire_step import StepScratch
from wire_tpu_torch.signals.coords import GridSpec


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
    # seeds the chunked epochs' permutations
    seed: int = 0
    # sort the indices within each chunk of an epoch's permutation: the
    # chunks hold the same points, only their order (and so the float
    # summation order) changes; the sentinels stay a tail
    sort_chunks: bool = False
    # permute contiguous blocks of this many points instead of single
    # points (0 = off, the per-point permutation); needs npoints divisible
    # by it
    block_perm: int = 0


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
    # device time per epoch from CUDA events, the first epoch left out
    # (None on the CPU)
    step_ms: Optional[float] = None
    # per-epoch values of fit_pointwise's epoch_metric (None without one)
    time_array: Optional[np.ndarray] = None


class _StepClock:
    """Device ms per step from CUDA events over steps 1 .. n-1 (all n when
    n == 1): the first step, which builds or loads a kernel library and
    warms the allocator, stays outside the window.  Nothing on the CPU."""

    def __init__(self, dev, niters):
        self.on = dev.type == "cuda" and niters > 0
        self.first = 1 if niters > 1 else 0
        self.timed = niters - self.first
        if self.on:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)

    def tick(self, step):
        """Call at the start of every step."""
        if self.on and step == self.first:
            self.ev0.record()

    def ms(self):
        if not self.on:
            return None
        self.ev1.record()
        self.ev1.synchronize()
        return self.ev0.elapsed_time(self.ev1) / self.timed


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


def _two_arg_metric(epoch_metric):
    """Whether ``epoch_metric`` takes (rec, target): two positional
    parameters without defaults (wire_tpu/train/trainer.py:940-962); a
    callable whose signature cannot be read takes rec alone."""
    try:
        params = inspect.signature(epoch_metric).parameters.values()
    except (ValueError, TypeError):
        return False
    required = [p for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is inspect.Parameter.empty]
    return len(required) >= 2


def _chunking(cfg: FitConfig, npoints):
    """(U, mp, nchunks, npad): block size (1 per point), rows per chunk,
    chunks per epoch and sentinel rows in the last chunk
    (wire_tpu/train/trainer.py:371-388)."""
    U = int(cfg.block_perm or 0)
    if U > 1:
        if npoints % U:
            raise ValueError(f"block_perm={U} requires npoints ({npoints}) "
                             f"divisible by the block size")
        nunits = npoints // U
        mpu = max(min(cfg.maxpoints // U, nunits), 1)
        nchunks = -(-nunits // mpu)
        return U, mpu * U, nchunks, (nchunks * mpu - nunits) * U
    mp = min(cfg.maxpoints, npoints)
    nchunks = -(-npoints // mp)
    return 1, mp, nchunks, nchunks * mp - npoints


def fit_pointwise(model, params, coords, target, cfg: FitConfig, *,
                  gt=None, track="gt", epoch_metric: Optional[Callable] = None,
                  permutation: Optional[Callable] = None, device=None):
    """Fit an INR pointwise to ``target`` sampled at ``coords``.

    coords (N, d) (numpy array or tensor) or a ``GridSpec``, whose rows
    are computed on the device; target (N, c), gt optional clean (N, c).
    The best epoch is the one with the least MSE vs gt (``track="gt"``;
    vs the target when gt is None) or vs the target (``track="noisy"``).
    ``epoch_metric(rec)``, or ``epoch_metric(rec, target)`` when it takes
    two required positional parameters, is evaluated on the device after
    every epoch; its history comes back in ``time_array``.
    ``permutation(n)`` gives each chunked epoch's permutation of range(n)
    (n = npoints, or npoints / block_perm blocks); by default a fresh
    ``torch.randperm`` from a generator seeded with ``cfg.seed`` on the
    fit's device.  ``params`` is not modified.  Runs on ``device``
    (default cuda; raises without a card unless device='cpu')."""
    if track not in ("gt", "noisy"):
        raise ValueError(f"fit_pointwise: track={track!r}, expected 'gt' or "
                         f"'noisy'")
    dev = resolve(device)
    grid = coords if isinstance(coords, GridSpec) else None
    if grid is None:
        coords = _as_tensor(coords, dev)
    target = _as_tensor(target, dev)
    gt_arr = target if gt is None else _as_tensor(gt, dev)
    npoints, c = target.shape
    U, mp, nchunks, npad = _chunking(cfg, npoints)
    full_batch = nchunks == 1 and npad == 0
    if grid is not None and full_batch:
        coords = grid.rows(torch.arange(npoints, device=dev))
    metric_two = epoch_metric is not None and _two_arg_metric(epoch_metric)
    if permutation is None and not full_batch:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(cfg.seed))

        def permutation(n):
            return torch.randperm(n, generator=gen, device=dev)

    params = tree.map(lambda v: v.detach().to(dev, torch.float32).clone(),
                      params)
    opt = Adam(cfg, params, npoints=npoints, nchunks=nchunks)
    best_params = tree.map(torch.clone, params)
    best_rec = torch.zeros_like(target)
    rec = best_rec if full_batch else torch.zeros_like(target)
    best_mse = torch.tensor(float("inf"), device=dev)
    hist_gt = torch.empty(cfg.niters, device=dev)
    hist_noisy = torch.empty(cfg.niters, device=dev)
    hist_metric = (torch.empty(cfg.niters, device=dev)
                   if epoch_metric is not None else None)
    inv_nc = 1.0 / (npoints * c)
    scratch = StepScratch()

    def chunk_step(idx, nvalid, rows_of):
        """One step on a chunk: ``idx`` the chunk's point (or block)
        indices, sentinels a tail, ``nvalid`` its valid points; the valid
        rows of the prediction are written into rec."""
        safe = idx.clamp(max=npoints // U - 1)
        rows, t, g = rows_of(safe)
        pred, grads, sums = model.step_grads(
            params, rows, t, nvalid=nvalid,
            denom=float(np.float32(nvalid) * np.float32(c)), gt=g,
            want_metrics=True, scratch=scratch)
        opt.step(params, grads)
        nv = nvalid // U
        rec.view(npoints // U, U * c).index_copy_(
            0, idx[:nv], pred.reshape(-1, U * c)[:nv])
        return sums

    if U > 1:
        t_u, g_u = target.view(-1, U * c), gt_arr.view(-1, U * c)
        c_u = None if grid is not None else coords.view(npoints // U, -1)
        lane = torch.arange(U, device=dev)

        def rows_of(safe):
            if grid is not None:
                rows = grid.rows((safe[:, None] * U + lane).reshape(-1))
            else:
                rows = c_u[safe].reshape(mp, -1)
            return rows, t_u[safe].reshape(mp, c), g_u[safe].reshape(mp, c)
    else:
        def rows_of(safe):
            rows = grid.rows(safe) if grid is not None else coords[safe]
            return rows, target[safe], gt_arr[safe]

    clock = _StepClock(dev, cfg.niters)
    t0 = time.time()
    for epoch in range(cfg.niters):
        clock.tick(epoch)
        if full_batch:
            pred, grads, (sse_t, sse_g) = model.step_grads(
                params, coords, target, gt=gt_arr, want_metrics=True,
                scratch=scratch)
            opt.step(params, grads)
            rec = pred
        else:
            # sentinels (npoints / U) pad the tail; sorting keeps them there
            perm = permutation(npoints // U).to(dev)
            if npad:
                perm = torch.cat([perm, perm.new_full((npad // U,),
                                                      npoints // U)])
            perm = perm.view(nchunks, mp // U)
            if cfg.sort_chunks:
                perm = torch.sort(perm, dim=1).values
            sse_t = sse_g = 0.0
            for k in range(nchunks):
                nvalid = mp - (npad if k == nchunks - 1 else 0)
                st, sg = chunk_step(perm[k], nvalid, rows_of)
                sse_t = sse_t + st
                sse_g = sse_g + sg
        mse_noisy = sse_t * inv_nc
        mse_gt = sse_g * inv_nc
        hist_gt[epoch] = mse_gt
        hist_noisy[epoch] = mse_noisy
        tracked = mse_gt if track == "gt" else mse_noisy
        is_best = tracked < best_mse
        best_mse = torch.where(is_best, tracked, best_mse)
        best_rec, best_params = track_best(is_best, (rec, params),
                                           (best_rec, best_params))
        if epoch_metric is not None:
            hist_metric[epoch] = (epoch_metric(rec, target) if metric_two
                                  else epoch_metric(rec))
    step_ms = clock.ms()
    wall = time.time() - t0
    return FitResult(
        params=params, best_params=best_params,
        best_rec=best_rec.cpu().numpy(), final_rec=rec.cpu().numpy(),
        mse_gt=hist_gt.cpu().numpy(), mse_noisy=hist_noisy.cpu().numpy(),
        best_mse=float(best_mse), wall_time_s=wall, step_ms=step_ms,
        time_array=(None if hist_metric is None
                    else hist_metric.cpu().numpy()))


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

    clock = _StepClock(dev, cfg.niters)
    t0 = time.time()
    for it in range(cfg.niters):
        clock.tick(it)
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
    step_ms = clock.ms()
    wall = time.time() - t0
    return FitResult(
        params=params, best_params=best_params,
        best_rec=best_field.cpu().numpy(), final_rec=None,
        mse_gt=hist_tracked.cpu().numpy(), mse_noisy=hist_loss.cpu().numpy(),
        best_mse=float(best_loss), wall_time_s=wall, step_ms=step_ms)
