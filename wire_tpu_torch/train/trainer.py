"""Adam fitting of an INR to one signal (port of wire_tpu/train/trainer.py:
FitConfig, CheckpointSpec, the fit fingerprint and fit-state files,
FitResult, track_best, _lr_schedule, make_optimizer, fit_pointwise with its
full-batch, chunked per-point and block-permuted epochs, fit_frames and
fit_operator with a full-grid or chunked render).

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
chunk, the sentinel rows masked through the step's ``nvalid``.
fit_frames (multi-frame SR) renders a batch of frames' warped HR grids per
step, box-downsamples them and takes the masked MSE against the LR frames.
fit_operator renders the whole grid every iteration, in one piece or
(``render_chunked``) in ``maxpoints``-row chunks recomputed in the
backward.  The three take a ``CheckpointSpec``: the whole state of the
loop is saved every ``every x scan_segment`` epochs or iterations and at
the end, and a resumed fit reproduces the uninterrupted one bit for bit
wherever its kernels are bit-equal on repeat calls.  TV regularization is a
later slice.  The three take a ``mesh`` (``wire_tpu_torch.dist``) and
then run sharded over its ranks through its hooks: the rows a rank owns,
one flat all-reduce of the gradients a step, the all-gathers of a render
or a reconstruction; without one the hooks are ``_Solo``'s, each the
identity.

The batched multi-fit (wire_tpu's fit_pointwise_many, fit_operator_many
and fit_frames_many, which vmap the loop body over a leading replica axis
of the parameters, the optimizer state and the RNG key) fits M models of
one architecture in one loop: every parameter leaf carries a leading M,
the model's ``step_grads_many`` / ``apply_many`` take all M in one call
(on the card the kernels of WIRE, WIRE-2D, the MFN, mscale_2 and the
canonical real families with a replica axis, one launch sequence for all
M; the autodiff families by autograd of the batched apply, whose PyTorch
launches do not grow with M), and Adam and the best tracking act on the
stacked leaves with an (M,) mask.  Replica r draws its permutations from a
generator of its own seeded ``cfg.seed + r`` and reproduces the serial fit
at that seed; its loss is reduced on its own slice, as the serial fit
reduces it.  The batched fits have no checkpoint and no chunked render, as
in wire_tpu.

Spans (``train/profiling.py``): each fitter's body is a ``trainer.fit``
span, its set-up up to the first epoch ``trainer.setup``, and under a
profiler each epoch ``trainer.epoch``, with ``trainer.adam`` around
``Adam.step`` and ``trainer.tracking`` around the epoch's MSE arithmetic,
history writes and best tracking.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import os
import time
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from wire_tpu_torch import tree
from wire_tpu_torch.device import resolve
from wire_tpu_torch.nn.models import grad_leaves, grads_tree
from wire_tpu_torch.operators.forward import multi_sr_op
from wire_tpu_torch.ops.wire_step import StepScratch
from wire_tpu_torch.signals.coords import GridSpec
from wire_tpu_torch.train import profiling
from wire_tpu_torch.train.metrics import total_variation


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
    # epochs (or iterations) per segment: a checkpoint is written every
    # CheckpointSpec.every segments; nothing else reads it, and the fit
    # fingerprint leaves it out (wire_tpu's bound on a TPU program's length)
    scan_segment: int = 250


@dataclasses.dataclass
class CheckpointSpec:
    """Mid-fit checkpoint/resume: the fit writes its whole state (parameters,
    Adam's moments and step count, best-so-far tracking, the reconstruction
    buffers, the permutation generator's state, the history so far) to
    ``path`` every ``every`` segments of ``FitConfig.scan_segment`` epochs
    and at the end, and with ``resume`` starts from the file when it
    exists."""
    path: str
    every: int = 1       # segments between saves
    resume: bool = True  # load an existing checkpoint before fitting


def _fit_fingerprint(cfg, model, *arrays):
    """Digest of (config, architecture, input data) written into fit-state
    files, so that resuming a checkpoint written by another fit (another
    config, model, data or epoch metric at the same path) is refused.
    ``scan_segment`` is left out: it only places the saves."""
    h = hashlib.md5()
    if isinstance(cfg, FitConfig):
        cfg = dataclasses.replace(cfg, scan_segment=0)
    h.update(repr(cfg).encode())
    h.update(repr(getattr(model, "spec", model)).encode())
    for a in arrays:
        _digest_value(h, a)
    return h.hexdigest()


def _host_array(a):
    """A numpy view of a tensor (copied to the host) or of an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _digest_value(h, a):
    """wire_tpu's digest (wire_tpu/train/trainer.py:121-202): None, scalars,
    strings and dataclasses by repr; sequences item by item; partials by
    their function and bound arguments; functions by qualname, code
    constants and names, and closure cells; other callables by type and
    qualname; arrays by shape, dtype, sum and a strided sample of up to
    4,096 values (tensors, wherever they lie, copied to the host for it);
    operator objects by type and their public attributes (private ones are
    caches, such as RadonOp's rotsum tables)."""
    if a is None:
        h.update(b"none")
        return
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        h.update(repr(a).encode())
        return
    if isinstance(a, (str, int, float, bool, bytes)):
        h.update(repr(a).encode())
        return
    if isinstance(a, (tuple, list)):
        for v in a:
            _digest_value(h, v)
        return
    if isinstance(a, partial):
        h.update(b"functools.partial")
        _digest_value(h, a.func)
        _digest_value(h, tuple(a.args))
        for k in sorted(a.keywords):
            h.update(k.encode())
            _digest_value(h, a.keywords[k])
        return
    is_array = isinstance(a, (np.ndarray, torch.Tensor))
    if callable(a) and not is_array and not hasattr(a, "spec") \
            and getattr(a, "__closure__", "no") != "no":
        # functions and lambdas; not co_code, which changes with every
        # CPython minor version
        h.update(getattr(a, "__qualname__", repr(type(a))).encode())
        code = getattr(a, "__code__", None)
        if code is not None:
            h.update(repr((code.co_argcount, code.co_names,
                           code.co_varnames)).encode())
            for const in code.co_consts:
                if isinstance(const, (int, float, str, bool, bytes,
                                      type(None))):
                    h.update(repr(const).encode())
        for cell in (a.__closure__ or ()):
            try:
                _digest_value(h, cell.cell_contents)
            except ValueError:  # empty cell
                h.update(b"emptycell")
        return
    if callable(a) and not is_array and not hasattr(a, "spec") \
            and not hasattr(a, "__dict__"):
        h.update(repr(type(a)).encode())
        h.update(getattr(a, "__qualname__", "").encode())
        return
    if is_array:
        arr = _host_array(a)
        h.update(str(tuple(arr.shape)).encode())
        h.update(str(arr.dtype).encode())
        if arr.size:
            h.update(np.float64(arr.sum(dtype=np.float64)).tobytes())
            flat = arr.reshape(-1)
            stride = max(1, flat.size // 4096)
            h.update(np.ascontiguousarray(
                flat[::stride][:4096].astype(np.float64)).tobytes())
        return
    h.update(str(getattr(a, "shape", ())).encode())
    h.update(type(a).__name__.encode())
    if getattr(a, "__dict__", None) is not None:
        for k in sorted(vars(a)):
            if k.startswith("_"):
                continue
            h.update(k.encode())
            v = vars(a)[k]
            if isinstance(v, (np.ndarray, torch.Tensor)):
                _digest_value(h, v)
            else:
                h.update(repr(v).encode())


def _state_key(path):
    return "state/" + "/".join(str(k) for k in path)


def _save_fit_state(path, state, hists, done, fingerprint=None):
    """Write ``state`` (a tree of tensors, arrays and numbers), the
    histories ``hists`` (a tuple of arrays over the first ``done`` epochs)
    and ``done`` to ``path`` as an .npz: to ``path + '.tmp.npz'`` first,
    then renamed over it, so a kill mid-save leaves the old file."""
    payload = {"done": np.int64(done), "nhist": np.int64(len(hists))}
    if fingerprint is not None:
        payload["fingerprint"] = np.str_(fingerprint)
    for p, leaf in tree.leaves(state):
        payload[_state_key(p)] = _host_array(leaf)
    for k, arr in enumerate(hists):
        payload[f"hist_{k}"] = _host_array(arr)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _load_fit_state(path, template, fingerprint=None):
    """(state, hists, done) from a file of ``_save_fit_state``: the state
    has ``template``'s structure, each tensor on its template's device and
    dtype, each Python number its type.  Raises ValueError when the file's
    fingerprint is not ``fingerprint``."""
    with np.load(path) as z:
        if fingerprint is not None:
            saved = str(z["fingerprint"]) if "fingerprint" in z else None
            if saved != fingerprint:
                raise ValueError(
                    f"checkpoint {path!r} was written by a DIFFERENT fit "
                    "(another config, model, input data or epoch metric); "
                    "resuming it would corrupt this run.  Delete the file "
                    "or point CheckpointSpec.path elsewhere.")
        flat = tree.leaves(template)
        values = []
        for p, leaf in flat:
            arr = z[_state_key(p)]
            if isinstance(leaf, torch.Tensor):
                values.append(torch.from_numpy(np.array(arr)).to(
                    leaf.device, leaf.dtype))
            elif isinstance(leaf, (int, float)):
                values.append(type(leaf)(arr))
            else:
                values.append(np.array(arr))
        hists = tuple(np.array(z[f"hist_{k}"])
                      for k in range(int(z["nhist"])))
        done = int(z["done"])
    return tree.unflatten([p for p, _ in flat], values), hists, done


class _Checkpointer:
    """When to save and what to resume from, for a loop of ``niters``
    epochs or iterations: a segment ends every ``scan_segment`` epochs from
    the start and at the last; every ``every``-th segment of this call and
    the last are saved (wire_tpu/train/trainer.py:416-431)."""

    def __init__(self, spec, cfg, fingerprint, part):
        if spec is not None and part.size > 1:
            # the ranks of a mesh hold rows and permutation streams of
            # their own: a file each
            spec = dataclasses.replace(
                spec, path=f"{spec.path}.rank{part.rank}of{part.size}")
        self.spec = spec
        self.cfg = cfg
        self.fp = fingerprint
        self.seg = min(cfg.niters, max(cfg.scan_segment, 1))
        self.nseg = 0

    def resume(self, template):
        """(state, hists, done), or None without a file to resume."""
        if self.spec is None or not self.spec.resume or \
                not os.path.exists(self.spec.path):
            return None
        return _load_fit_state(self.spec.path, template, self.fp)

    def after(self, done, state_fn, hists_fn):
        """Call after each epoch with the epochs done so far; saves
        ``state_fn()`` and ``hists_fn()`` at the boundaries."""
        if self.spec is None:
            return
        if done % self.seg and done < self.cfg.niters:
            return
        self.nseg += 1
        if self.nseg % max(self.spec.every, 1) == 0 or \
                done >= self.cfg.niters:
            _save_fit_state(self.spec.path, state_fn(), hists_fn(), done,
                            self.fp)


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
    (``torch.where`` on a device bool), so no host sync.  ``is_best`` is a
    0-d bool, or an (M,) one over the leading replica axis of every
    tensor."""
    if isinstance(current, dict):
        return {k: track_best(is_best, current[k], best[k]) for k in current}
    if isinstance(current, (tuple, list)):
        return type(current)(track_best(is_best, c, b)
                             for c, b in zip(current, best))
    if is_best.ndim:
        is_best = is_best.reshape(is_best.shape
                                  + (1,) * (current.ndim - is_best.ndim))
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

    @profiling.spanned("trainer.adam")
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

    def state(self):
        """The moments and the step count, for a fit-state file."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state(self, state):
        self.mu, self.nu, self.count = (list(state["mu"]), list(state["nu"]),
                                        state["count"])


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


class _Solo:
    """The mesh hooks of a single-device fit: rank 0 of 1, owning every
    row, each collective the identity.  ``dist.mesh.Mesh`` has the same
    methods over a process group."""
    rank, size = 0, 1

    def __init__(self, device):
        self.device = device

    def span(self, n):
        return 0, n

    def local(self, x, n):
        return x

    def whole(self, x):
        return x

    def sum_(self, t):
        return t

    def sum_tree(self, grads, mean=False):
        return grads

    def gather(self, local):
        return local

    def splice(self, local):
        return local


def _part(mesh, device, who):
    """A fit's mesh hooks, whose ``device`` it runs on: ``mesh`` (a
    ``device`` given beside it must name the mesh's), or a ``_Solo`` on
    ``device``."""
    if mesh is None:
        return _Solo(resolve(device))
    if device is not None:
        d = torch.device(device)
        if d.type != mesh.device.type or d.index not in (
                None, mesh.device.index):
            raise ValueError(f"{who}: device {d} is not the mesh's "
                             f"{mesh.device}")
    return mesh


@dataclasses.dataclass(frozen=True)
class _GridShard:
    """The rows of ``grid`` from global index ``lo`` on: a rank's shard of
    an implicit grid, computed on the device (no coordinate shard
    stored)."""
    grid: GridSpec
    lo: int

    def rows(self, idx):
        return self.grid.rows(idx + self.lo)


def _sum_rows(x, dev):
    """An ``epoch_sums`` value (a tensor, a number or a tuple of them) as a
    float64 (k,) tensor: counts past 2^24 (a 512^3 volume's union) stay
    exact."""
    x = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    return torch.stack([torch.as_tensor(s, device=dev).to(torch.float64)
                        for s in x])


def _mesh_sums(mesh, sse_t, sse_g, extra):
    """The epoch's SSE sums and this rank's ``epoch_sums`` row (or None)
    summed over the mesh in one float64 all-reduce: (sse_t, sse_g) float32
    and the summed row."""
    parts = [torch.as_tensor(s, device=mesh.device).to(torch.float64)
             for s in (sse_t, sse_g)]
    if extra is not None:
        parts += list(extra)
    sums = mesh.sum_(torch.stack(parts))
    return (sums[0].to(torch.float32), sums[1].to(torch.float32),
            None if extra is None else sums[2:])


def _chunking(cfg: FitConfig, npoints, size=1):
    """(U, mp, nchunks, npad): block size (1 per point), rows per chunk,
    chunks per epoch and sentinel rows in the last chunk
    (wire_tpu/train/trainer.py:371-388); a rank of a mesh of ``size``
    takes ``maxpoints // size`` of its ``npoints`` rows a chunk
    (wire_tpu/dist/fitter.py:78)."""
    U = int(cfg.block_perm or 0)
    if U > 1:
        if npoints % U:
            raise ValueError(f"block_perm={U} requires npoints ({npoints}) "
                             f"divisible by the block size")
        nunits = npoints // U
        mpu = max(min(cfg.maxpoints // U, nunits), 1)
        nchunks = -(-nunits // mpu)
        return U, mpu * U, nchunks, (nchunks * mpu - nunits) * U
    mp = min(max(cfg.maxpoints // size, 1), npoints)
    nchunks = -(-npoints // mp)
    return 1, mp, nchunks, nchunks * mp - npoints


def _on_device(params, dev):
    """A float32 copy of a parameter tree (replica-stacked or not) on
    ``dev``."""
    return tree.map(lambda v: v.detach().to(dev, torch.float32).clone(),
                    params)


def _sentinel_rows(perm, n, npad, nrows):
    """A permutation of range(n) with ``npad`` sentinels n appended as its
    tail (wire_tpu/train/trainer.py:499-509), viewed as ``nrows`` rows:
    the epoch's chunks or frame batches."""
    if npad:
        perm = torch.cat([perm, perm.new_full((npad,), n)])
    return perm.view(nrows, -1)


def _fitter(fn):
    """A fitter's whole body in a ``trainer.fit`` span, the root of the
    fit's spans, and ``trainer.setup`` from its entry to its first epoch
    (``_epochs`` ends it)."""
    @functools.wraps(fn)
    def fit(*args, **kwargs):
        with profiling.span("trainer.fit"), profiling.span("trainer.setup"):
            return fn(*args, **kwargs)
    return fit


def _epochs(start, stop):
    """The epochs (or iterations) of a fitter's loop: ends the fit's
    ``trainer.setup`` at the first and holds each one's body in a
    ``trainer.epoch`` span."""
    profiling.close("trainer.setup")
    for epoch in range(start, stop):
        with profiling.span("trainer.epoch"):
            yield epoch


def _keep_best(tracked, best_metric, current, best):
    """(best metric, best tree) after a step whose metric is ``tracked``
    (0-d, or (M,) over the replicas): ``current`` is kept where it
    improved on ``best_metric``."""
    is_best = tracked < best_metric
    return (torch.where(is_best, tracked, best_metric),
            track_best(is_best, current, best))


def _chunk_rows(grid, coords, target, gt, U, mp, lead=()):
    """rows_of(safe): a chunk's coordinate, target and gt rows at the unit
    (point, or block of U points) indices ``safe`` of shape
    (*lead, mp / U); ``lead`` is (M,) for the replicas' indices into shared
    rows.  ``grid`` (a GridSpec) computes the coordinates instead."""
    if U == 1:
        def rows_of(safe):
            rows = grid.rows(safe) if grid is not None else coords[safe]
            return rows, target[safe], gt[safe]
        return rows_of
    c = target.shape[-1]
    t_u, g_u = target.view(-1, U * c), gt.view(-1, U * c)
    c_u = None if grid is not None else coords.view(t_u.shape[0], -1)
    lane = torch.arange(U, device=target.device)

    def rows_of(safe):
        if grid is not None:
            rows = grid.rows((safe[..., None] * U + lane).reshape(*lead, -1))
        else:
            rows = c_u[safe].reshape(*lead, mp, -1)
        return (rows, t_u[safe].reshape(*lead, mp, c),
                g_u[safe].reshape(*lead, mp, c))
    return rows_of


def _chunked_epoch(step, opt, params, rec, rows_of, perm, *, U, mp, npad,
                   sort, scratch, offsets=None, part=None):
    """One chunked epoch of a pointwise fit: ``perm`` (nchunks, [M,] mp / U)
    unit indices, the sentinels a tail of the last chunk, sorted along the
    last axis with ``sort``.  Per chunk one ``step`` (``step_grads``, or
    ``step_grads_many`` for all replicas), one Adam step, and the valid
    rows of the prediction written into ``rec``: (npoints, c), or
    (M, npoints, c) with replica r's rows from ``offsets[r]`` on in its
    (M * nunits, U * c) view.  With ``part``, a mesh's rank in exact mode
    (points, not blocks), the rank steps on its slice of each chunk,
    normalized by the chunk's valid count, and the ranks' predictions are
    all-gathered into the chunk's.  Returns the epoch's SSE sums against
    the target and against gt (over this rank's slices with ``part``)."""
    if sort:
        perm = torch.sort(perm, dim=-1).values
    c = rec.shape[-1]
    nunits = rec.shape[-2] // U
    nchunks = perm.shape[0]
    if part is not None:
        m = mp // part.size
        a = part.rank * m
    sse_t = sse_g = 0.0
    for k in range(nchunks):
        idx = perm[k]
        nvalid = mp - (npad if k == nchunks - 1 else 0)
        mine, nv_mine = idx, nvalid
        if part is not None:
            # the sentinels stay the tail of each slice (step_grads' mask
            # contract), so the slice's valid count is known here
            mine, nv_mine = idx[a:a + m], min(max(nvalid - a, 0), m)
        rows, t, g = rows_of(mine.clamp(max=nunits - 1))
        pred, grads, (st, sg) = step(
            params, rows, t, nvalid=nv_mine,
            denom=float(np.float32(nvalid) * np.float32(c)), gt=g,
            want_metrics=True, scratch=scratch)
        if part is not None:
            pred = part.gather(pred)
        opt.step(params, grads)
        nv = nvalid // U
        idx = idx[..., :nv]
        if offsets is not None:
            idx = idx + offsets
        rec.view(-1, U * c).index_copy_(
            0, idx.reshape(-1),
            pred.reshape(*idx.shape[:-1], -1, U * c)[..., :nv, :]
            .reshape(-1, U * c))
        sse_t = sse_t + st
        sse_g = sse_g + sg
    return sse_t, sse_g


def _tv_weight(tv_weight, image_shape, cfg, mesh):
    """fit_pointwise's TV weight as a float after its refusals: with
    ``block_perm`` (wire_tpu/train/trainer.py:377), without an
    ``image_shape``, with a ``mesh``, or below 0."""
    tv = float(tv_weight or 0.0)
    if tv == 0.0:
        return 0.0
    if tv < 0.0:
        raise ValueError(f"fit_pointwise: tv_weight {tv} < 0")
    if image_shape is None:
        raise ValueError("fit_pointwise: tv_weight needs image_shape=(H, W, "
                         "C), the shape of the render it regularizes")
    if cfg.block_perm and int(cfg.block_perm) > 1:
        raise ValueError("block_perm is incompatible with tv_weight (TV "
                         "renders the full grid)")
    if mesh is not None:
        raise ValueError("fit_pointwise: tv_weight with a mesh: the sharded "
                         "fit has no TV term (wire_tpu's neither); fit on "
                         "one device")
    return tv


def _tv_penalty(model, weight, image_shape, full_coords):
    """``penalty(p, pred)`` for ``INR.step_grads``: ``weight`` x the total
    variation of the render as an (1, C, H, W) image.  The render is
    ``pred`` itself for a full batch (``full_coords`` None), else
    ``model.apply(p, full_coords)``: the whole grid rendered beside the
    chunk, every step."""
    H, W, C = image_shape

    def penalty(p, pred):
        full = pred if full_coords is None else model.apply(p, full_coords)
        return weight * total_variation(
            full.reshape(1, H, W, C).permute(0, 3, 1, 2))
    return penalty


@_fitter
def fit_pointwise(model, params, coords, target, cfg: FitConfig, *,
                  gt=None, track="gt", tv_weight=0.0, image_shape=None,
                  epoch_metric: Optional[Callable] = None,
                  epoch_sums: Optional[Callable] = None,
                  permutation: Optional[Callable] = None,
                  checkpoint: Optional[CheckpointSpec] = None, device=None,
                  mesh=None, global_perm=False):
    """Fit an INR pointwise to ``target`` sampled at ``coords``.

    coords (N, d) (numpy array or tensor) or a ``GridSpec``, whose rows
    are computed on the device; target (N, c), gt optional clean (N, c).
    The best epoch is the one with the least MSE vs gt (``track="gt"``;
    vs the target when gt is None) or vs the target (``track="noisy"``).
    ``epoch_metric(rec)``, or ``epoch_metric(rec, target)`` when it takes
    two required positional parameters, is evaluated on the device after
    every epoch; its history comes back in ``time_array``.  Or
    ``epoch_sums(rec, target)`` returns a tensor or a tuple of sums over
    the rows ``rec`` holds, summed over the mesh; their histories come
    back as ``time_array`` (float64, one array a sum).
    ``tv_weight`` > 0 adds ``tv_weight`` x the anisotropic total variation
    of the full render, reshaped to ``image_shape`` (H, W, C), to every
    step's loss (wire_tpu/train/trainer.py:341-352, 975-991): the full
    batch's prediction is that render; a chunked step renders the whole
    grid beside its chunk.  Such a step is autodiff of ``model.apply``
    (``INR.step_grads``' ``penalty``), the family's apply/VJP pair on the
    card, not its step kernel.  TV is refused with ``block_perm``, as
    wire_tpu refuses it, without ``image_shape``, and with a ``mesh``
    (wire_tpu's sharded fitter has no TV).
    ``permutation(n)`` gives each chunked epoch's permutation of range(n)
    (n = npoints, or npoints / block_perm blocks); by default a fresh
    ``torch.randperm`` from a generator seeded with ``cfg.seed`` on the
    fit's device.  ``checkpoint`` saves and resumes the fit's state (the
    generator's too; a caller's ``permutation`` keeps its own).  ``params``
    is not modified.  Runs on ``device`` (default cuda; raises without a
    card unless device='cpu').

    With a ``mesh`` (``wire_tpu_torch.dist``, wire_tpu/dist/fitter.py:33)
    the fit is sharded over its ranks, on the mesh's device; the inputs may
    be ``multihost.feed_rows``' ``LocalRows``.  Local mode (default): rank
    r owns rows [r N/size, (r+1) N/size) (N divisible by the size), permutes
    them with a generator seeded ``cfg.seed + r`` (``permutation(n)``:
    its n rows), steps on chunks of ``maxpoints // size`` of them and
    all-reduces each step's gradients to their mean (wire_tpu's
    ``pmean``); ``rec`` and ``epoch_sums`` see its rows.  ``global_perm``
    (exact mode): every rank holds all rows, draws the single-device
    permutation stream and steps on slice r of each chunk (the chunk
    divisible by the size) over the chunk's valid count; the gradients
    are summed and the predictions all-gathered, so the trajectory is the
    single-device one to reduction order.  The epoch's SSE sums and
    ``epoch_sums`` are summed over the mesh in one collective, so every
    rank keeps the same best epoch; ``best_rec`` and ``final_rec`` come
    back whole on every rank; a checkpoint is a file per rank.  A world of
    one is the single-device fit bit for bit.  ``block_perm`` is refused
    with a mesh."""
    if track not in ("gt", "noisy"):
        raise ValueError(f"fit_pointwise: track={track!r}, expected 'gt' or "
                         f"'noisy'")
    if epoch_metric is not None and epoch_sums is not None:
        raise ValueError("fit_pointwise: an epoch_metric or epoch_sums, not "
                         "both")
    if mesh is not None and cfg.block_perm:
        # the block permutation is the single-device trainer's; refusing
        # beats running another composition than the one asked for
        raise NotImplementedError(
            "block_perm is not supported by the sharded fitter yet: use the "
            "single-device trainer, or unset block_perm (the per-rank "
            "permutation already keeps gathers local)")
    tv = _tv_weight(tv_weight, image_shape, cfg, mesh)
    part = _part(mesh, device, "fit_pointwise")
    exact = bool(global_perm) and part.size > 1
    ckpt = _Checkpointer(checkpoint, cfg, None if checkpoint is None else
                         _fit_fingerprint(cfg, model, coords, target, gt,
                                          epoch_sums or epoch_metric,
                                          *(("global_perm",) if exact
                                            else ()),
                                          *(("tv", tv, tuple(image_shape))
                                            if tv else ())), part)
    dev = part.device
    grid = coords if isinstance(coords, GridSpec) else None
    npoints = target.shape[0]
    if exact:
        take = part.whole
        lo = 0
    else:
        def take(x):
            return part.local(x, npoints)
        lo = part.span(npoints)[0]
    if grid is None:
        coords = _as_tensor(take(coords), dev)
    elif lo:
        grid = _GridShard(grid, lo)
    target = _as_tensor(take(target), dev)
    gt_arr = target if gt is None else _as_tensor(take(gt), dev)
    n, c = target.shape  # this rank's rows
    U, mp, nchunks, npad = _chunking(cfg, n, 1 if exact else part.size)
    if exact and mp % part.size:
        raise ValueError(f"chunk size {mp} not divisible by mesh size "
                         f"{part.size}; adjust maxpoints")
    whole = nchunks == 1 and npad == 0
    full_batch = whole and not exact
    if grid is not None and full_batch:
        coords = grid.rows(torch.arange(n, device=dev))
    metric_two = epoch_metric is not None and _two_arg_metric(epoch_metric)
    gen = None
    if permutation is None and not whole:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(cfg.seed) + (0 if exact else part.rank))

        def permutation(n):
            return torch.randperm(n, generator=gen, device=dev)

    if tv:
        kw_tv = {"penalty": _tv_penalty(
            model, tv, image_shape, None if full_batch else (
                coords if grid is None
                else grid.rows(torch.arange(n, device=dev))))}
    else:
        kw_tv = {}

    def step(*args, **kw):
        pred, grads, sums = model.step_grads(*args, **kw, **kw_tv)
        return pred, part.sum_tree(grads, mean=not exact), sums

    params = _on_device(params, dev)
    opt = Adam(cfg, params, npoints=npoints, nchunks=nchunks)
    best_params = tree.map(torch.clone, params)
    best_rec = torch.zeros_like(target)
    rec = best_rec if full_batch else torch.zeros_like(target)
    best_mse = torch.tensor(float("inf"), device=dev)
    hist_gt = torch.empty(cfg.niters, device=dev)
    hist_noisy = torch.empty(cfg.niters, device=dev)
    hist_metric = (torch.empty(cfg.niters, device=dev)
                   if epoch_metric is not None else None)
    hist_sums = None  # (niters, k) float64, made at the first epoch's sums
    inv_nc = 1.0 / (npoints * c)
    scratch = StepScratch()

    def state():
        out = {"params": params, "opt": opt.state(), "rec": rec,
               "best_rec": best_rec, "best_mse": best_mse,
               "best_params": best_params}
        if gen is not None:
            out["gen"] = gen.get_state()
        return out

    def hists(done):
        out = (hist_gt[:done], hist_noisy[:done])
        extra = hist_metric if hist_metric is not None else hist_sums
        return out + ((extra[:done],) if extra is not None else ())

    start = 0
    resumed = ckpt.resume(state())
    if resumed is not None:
        st, hs, start = resumed
        params, rec, best_rec = st["params"], st["rec"], st["best_rec"]
        best_mse, best_params = st["best_mse"], st["best_params"]
        opt.load_state(st["opt"])
        if gen is not None:
            gen.set_state(st["gen"])
        if epoch_sums is not None and len(hs) > 2:
            hist_sums = torch.empty((cfg.niters,) + hs[2].shape[1:],
                                    dtype=torch.float64, device=dev)
        for h, saved in zip((hist_gt, hist_noisy, hist_metric
                             if hist_metric is not None else hist_sums), hs):
            h[:start] = torch.from_numpy(saved).to(dev)

    rows_of = _chunk_rows(grid, coords, target, gt_arr, U, mp)

    clock = _StepClock(dev, cfg.niters - start)
    t0 = time.time()
    for epoch in _epochs(start, cfg.niters):
        clock.tick(epoch - start)
        if full_batch:
            pred, grads, (sse_t, sse_g) = step(
                params, coords, target, gt=gt_arr, want_metrics=True,
                scratch=scratch)
            opt.step(params, grads)
            rec = pred
        else:
            # sentinels (n / U) pad the tail; sorting keeps them there.  A
            # chunk of all rows is no permutation, as the full batch draws
            # none
            perm = (torch.arange(n, device=dev).view(1, -1) if whole else
                    _sentinel_rows(permutation(n // U).to(dev), n // U,
                                   npad // U, nchunks))
            sse_t, sse_g = _chunked_epoch(
                step, opt, params, rec, rows_of, perm, U=U, mp=mp,
                npad=npad, sort=cfg.sort_chunks, scratch=scratch,
                part=part if exact else None)
        with profiling.span("trainer.tracking"):
            sums = None if epoch_sums is None else _sum_rows(
                epoch_sums(rec, target), dev)
            if mesh is not None:
                # in exact mode every rank's rec is whole: its sums are
                # summed already
                sse_t, sse_g, summed = _mesh_sums(part, sse_t, sse_g,
                                                  None if exact else sums)
                sums = sums if exact else summed
            mse_noisy = sse_t * inv_nc
            mse_gt = sse_g * inv_nc
            hist_gt[epoch] = mse_gt
            hist_noisy[epoch] = mse_noisy
            tracked = mse_gt if track == "gt" else mse_noisy
            best_mse, (best_rec, best_params) = _keep_best(
                tracked, best_mse, (rec, params), (best_rec, best_params))
            if epoch_metric is not None:
                hist_metric[epoch] = (epoch_metric(rec, target) if metric_two
                                      else epoch_metric(rec))
            if sums is not None:
                if hist_sums is None:
                    hist_sums = torch.empty((cfg.niters,) + sums.shape,
                                            dtype=torch.float64, device=dev)
                hist_sums[epoch] = sums
        ckpt.after(epoch + 1, state, lambda: hists(epoch + 1))
    step_ms = clock.ms()
    if not exact:
        rec, best_rec = part.gather(rec), part.gather(best_rec)
    wall = time.time() - t0
    time_array = None
    if hist_metric is not None:
        time_array = hist_metric.cpu().numpy()
    elif hist_sums is not None:
        cols = hist_sums.cpu().numpy()
        time_array = tuple(cols[:, j] for j in range(cols.shape[1]))
        if len(time_array) == 1:
            time_array = time_array[0]
    return FitResult(
        params=params, best_params=best_params,
        best_rec=best_rec.cpu().numpy(), final_rec=rec.cpu().numpy(),
        mse_gt=hist_gt.cpu().numpy(), mse_noisy=hist_noisy.cpu().numpy(),
        best_mse=float(best_mse), wall_time_s=wall, step_ms=step_ms,
        time_array=time_array)


@_fitter
def fit_frames(model, params, frame_coords, frame_pixels, frame_masks,
               cfg: FitConfig, *, hr_shape, scale, batch_size=4,
               gt_image=None, permutation: Optional[Callable] = None,
               checkpoint: Optional[CheckpointSpec] = None, device=None,
               mesh=None):
    """Multi-frame SR fitting (wire_tpu/train/trainer.py:605-721): each step
    renders the INR at a batch of frames' warped HR grids, box-downsamples
    the renders by ``scale`` and takes the masked MSE against the LR
    frames, normalized as wire_tpu's
    ``sum(err^2) / (h*w*C * max(valid frames, 1))``, then one Adam step
    (the learning rate stepped per epoch of ``nbatches`` steps).

    frame_coords (n, H*W, 2), frame_pixels and frame_masks (n, h*w, C),
    hr_shape (H, W, C): numpy arrays or tensors.  Every epoch takes a new
    frame order, ``permutation(n)`` (by default a ``torch.randperm`` from a
    generator seeded with ``cfg.seed`` on the fit's device), padded to
    ``nbatches x bs`` with the sentinel n, whose frames are clamped to n - 1
    and masked out.  The best parameters are those after the step whose
    pre-step loss is the least so far; ``mse_gt`` and ``mse_noisy`` both
    hold each epoch's sum of its batches' losses; ``best_rec`` and
    ``final_rec`` are None.  ``gt_image`` only enters the checkpoint's
    fingerprint.  ``params`` is not modified.  Runs on ``device`` (default
    cuda; raises without a card unless device='cpu').

    With a ``mesh`` (``wire_tpu_torch.dist``, wire_tpu/dist/fitter.py:444)
    the frames are replicated and rank r renders frames
    [r bs/size, (r+1) bs/size) of each batch of ``bs = min(batch_size, n)``
    (divisible by the size); its loss keeps the batch's valid count, and
    the losses and gradients are summed in one all-reduce, so the
    trajectory is the single-device one to reduction order; a checkpoint
    is a file per rank."""
    part = _part(mesh, device, "fit_frames")
    ckpt = _Checkpointer(checkpoint, cfg, None if checkpoint is None else
                         _fit_fingerprint(cfg, model, frame_coords,
                                          frame_pixels, frame_masks,
                                          gt_image), part)
    dev = part.device
    fc = _as_tensor(frame_coords, dev)
    fp = _as_tensor(frame_pixels, dev)
    fm = _as_tensor(frame_masks, dev)
    nframes = fc.shape[0]
    H, W, C = hr_shape
    bs = min(batch_size, nframes)
    if bs % part.size:
        raise ValueError(f"batch_size={bs} not divisible by mesh size "
                         f"{part.size}")
    m = bs // part.size  # this rank's frames of a batch, from a on
    a = part.rank * m
    nbatches = -(-nframes // bs)
    npad = nbatches * bs - nframes
    # err.size / bs of the JAX loss: the elements of one LR frame
    per_frame = float(fp.shape[1] * fp.shape[2])
    gen = None
    if permutation is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(cfg.seed))

        def permutation(n):
            return torch.randperm(n, generator=gen, device=dev)

    params = _on_device(params, dev)
    opt = Adam(cfg, params, nchunks=nbatches)
    best_params = tree.map(torch.clone, params)
    best_loss = torch.tensor(float("inf"), device=dev)
    hist = torch.empty(cfg.niters, device=dev)

    def state():
        out = {"params": params, "opt": opt.state(), "best_loss": best_loss,
               "best_params": best_params}
        if gen is not None:
            out["gen"] = gen.get_state()
        return out

    start = 0
    resumed = ckpt.resume(state())
    if resumed is not None:
        st, (saved,), start = resumed
        params, best_loss = st["params"], st["best_loss"]
        best_params = st["best_params"]
        opt.load_state(st["opt"])
        if gen is not None:
            gen.set_state(st["gen"])
        hist[:start] = torch.from_numpy(saved).to(dev)

    clock = _StepClock(dev, cfg.niters - start)
    t0 = time.time()
    for epoch in _epochs(start, cfg.niters):
        clock.tick(epoch - start)
        losses = []
        for fidx in _sentinel_rows(permutation(nframes).to(dev), nframes,
                                   npad, nbatches):
            valid = (fidx < nframes).to(torch.float32)
            safe = fidx[a:a + m].clamp(max=nframes - 1)
            paths, leaves, p = grad_leaves(params)
            with torch.enable_grad():
                rend = model.apply(p, fc[safe])
                lr = multi_sr_op(rend.reshape(m, H, W, C), scale)
                mask = fm[safe] * valid[a:a + m, None, None]
                err = (lr.reshape(m, -1, C) - fp[safe]) * mask
                loss = torch.sum(err ** 2) / (
                    per_frame * torch.clamp(valid.sum(), min=1))
                flat = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads, loss = part.sum_tree(
                [grads_tree(paths, leaves, flat), loss.detach()])
            opt.step(params, grads)
            with profiling.span("trainer.tracking"):
                best_loss, best_params = _keep_best(loss, best_loss, params,
                                                    best_params)
            losses.append(loss)
        with profiling.span("trainer.tracking"):
            hist[epoch] = torch.stack(losses).sum()
        ckpt.after(epoch + 1, state, lambda: (hist[:epoch + 1],))
    step_ms = clock.ms()
    wall = time.time() - t0
    mse_hist = hist.cpu().numpy()
    return FitResult(
        params=params, best_params=best_params, best_rec=None,
        final_rec=None, mse_gt=mse_hist, mse_noisy=mse_hist,
        best_mse=float(best_loss), wall_time_s=wall, step_ms=step_ms)


@_fitter
def fit_operator(model, params, coords, measurement, operator_fn,
                 cfg: FitConfig, *, gt_field=None, field_shape, track="gt",
                 device=None, checkpoint: Optional[CheckpointSpec] = None,
                 render_chunked=False, mesh=None):
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
    over all iterations.  ``render_chunked`` renders the grid in
    ``cfg.maxpoints``-row chunks (the tail padded with zero rows), each
    under ``torch.utils.checkpoint`` so that the backward recomputes it and
    only one chunk's activations are live.  ``checkpoint`` saves and
    resumes the fit's state.  ``params`` is not modified.  Runs on
    ``device`` (default cuda; raises without a card unless
    device='cpu').

    With a ``mesh`` (``wire_tpu_torch.dist``, wire_tpu/dist/fitter.py:337)
    each rank renders its rows [r N/size, (r+1) N/size) of the grid (coords
    may be ``LocalRows``), the field is the ranks' renders all-gathered
    with this rank's the live one, so that autograd reaches its own rows
    only; the operator and the loss run replicated, and the gradients are
    summed in one all-reduce (wire_tpu's ``pmean`` after its all-gather's
    transpose, without the x size / size), so the trajectory is the
    single-device one to reduction order; a checkpoint is a file per
    rank."""
    if track not in ("gt", "loss"):
        raise ValueError(f"fit_operator: track={track!r}, expected 'gt' or "
                         f"'loss'")
    part = _part(mesh, device, "fit_operator")
    ckpt = _Checkpointer(checkpoint, cfg, None if checkpoint is None else
                         _fit_fingerprint(cfg, model, coords, measurement,
                                          gt_field, operator_fn), part)
    dev = part.device
    coords = _as_tensor(part.local(coords, coords.shape[0]), dev)
    measurement = _as_tensor(measurement, dev)
    track_gt = gt_field is not None and track == "gt"
    gt_arr = _as_tensor(gt_field, dev) if track_gt else None
    field_shape = tuple(field_shape)
    n = coords.shape[0]  # this rank's rows
    mp = min(cfg.maxpoints, n)
    n_render = -(-n // mp) if render_chunked else 1
    if n_render > 1:
        chunks = torch.nn.functional.pad(
            coords, (0, 0, 0, n_render * mp - n)).split(mp)

    def render(p):
        if n_render == 1:
            rows = model.apply(p, coords)
        else:
            rows = torch.cat([torch.utils.checkpoint.checkpoint(
                lambda c: model.apply(p, c), c, use_reentrant=False,
                preserve_rng_state=False) for c in chunks])[:n]
        return part.splice(rows).reshape(field_shape)

    params = _on_device(params, dev)
    opt = Adam(cfg, params, nchunks=1)
    best_params = tree.map(torch.clone, params)
    best_field = torch.zeros(field_shape, dtype=torch.float32, device=dev)
    best_loss = torch.tensor(float("inf"), device=dev)
    hist_loss = torch.empty(cfg.niters, device=dev)
    hist_tracked = torch.empty(cfg.niters, device=dev)

    def state():
        return {"params": params, "opt": opt.state(), "best_loss": best_loss,
                "best_field": best_field, "best_params": best_params}

    start = 0
    resumed = ckpt.resume(state())
    if resumed is not None:
        st, (saved_loss, saved_tracked), start = resumed
        params, best_loss = st["params"], st["best_loss"]
        best_field, best_params = st["best_field"], st["best_params"]
        opt.load_state(st["opt"])
        hist_loss[:start] = torch.from_numpy(saved_loss).to(dev)
        hist_tracked[:start] = torch.from_numpy(saved_tracked).to(dev)

    clock = _StepClock(dev, cfg.niters - start)
    t0 = time.time()
    for it in _epochs(start, cfg.niters):
        clock.tick(it - start)
        paths, leaves, p = grad_leaves(params)
        with torch.enable_grad():
            field = render(p)
            est = operator_fn(field)
            loss = torch.mean((est - measurement) ** 2)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        opt.step(params, part.sum_tree(grads_tree(paths, leaves, flat)))
        with profiling.span("trainer.tracking"):
            field = field.detach()
            loss = loss.detach()
            tracked = torch.mean((field - gt_arr) ** 2) if track_gt else loss
            hist_loss[it] = loss
            hist_tracked[it] = tracked
            best_loss, (best_field, best_params) = _keep_best(
                tracked, best_loss, (field, params), (best_field,
                                                      best_params))
        ckpt.after(it + 1, state,
                   lambda: (hist_loss[:it + 1], hist_tracked[:it + 1]))
    step_ms = clock.ms()
    wall = time.time() - t0
    return FitResult(
        params=params, best_params=best_params,
        best_rec=best_field.cpu().numpy(), final_rec=None,
        mse_gt=hist_tracked.cpu().numpy(), mse_noisy=hist_loss.cpu().numpy(),
        best_mse=float(best_loss), wall_time_s=wall, step_ms=step_ms)


# ---------------------------------------------------------------------------
# Batched multi-fit: M replicas of one architecture in one loop
# ---------------------------------------------------------------------------

def _replica_means(x):
    """(M,) means of each replica's slice of x, each reduced as the serial
    fit reduces its own tensor (one reduction per replica: a reduction of
    the whole stack may partition each replica's sum otherwise)."""
    return torch.stack([torch.mean(x[r]) for r in range(x.shape[0])])


def _replica_sums(x):
    """(M,) sums of each replica's slice of x (as ``_replica_means``)."""
    return torch.stack([torch.sum(x[r]) for r in range(x.shape[0])])


def _replica_generators(cfg, M, dev):
    """Replica r's permutation generator, seeded ``cfg.seed + r`` on the
    fit's device, as the serial fit at that seed seeds its own."""
    gens = [torch.Generator(device=dev) for _ in range(M)]
    for r, gen in enumerate(gens):
        gen.manual_seed(int(cfg.seed) + r)

    def permutation(n, r):
        return torch.randperm(n, generator=gens[r], device=dev)

    return permutation


@_fitter
def fit_pointwise_many(model, params_stack, coords, target, cfg: FitConfig,
                       *, gt=None, track="gt",
                       permutation: Optional[Callable] = None, device=None):
    """Fit M replicas of one architecture pointwise to one signal in one loop
    (wire_tpu/train/trainer.py:543).

    params_stack: a parameter tree with a leading replica axis M on every
    leaf (``tree.stack`` of M inits).  coords, target, gt as
    ``fit_pointwise``'s (a ``GridSpec`` too), shared by the replicas.  Full
    batch when ``maxpoints >= npoints``, else chunked epochs with tail
    sentinels, ``block_perm`` and ``sort_chunks`` as ``fit_pointwise``'s.
    Replica r's epochs permute with a generator of its own seeded
    ``cfg.seed + r`` (or ``permutation(n, r)``, replica r's permutation of
    range(n) for the epoch), so replica r reproduces
    ``fit_pointwise(..., seed=cfg.seed + r)`` from its init.  One
    ``step_grads_many`` a step serves all M (on the card one ``wire_step``,
    ``wire2d_step``, ``real_step``, ``mscale2_step`` or ``mfn_step`` launch
    sequence; an autodiff family's forward and backward through its
    batched apply).  Returns a FitResult whose params, best_params and
    recs carry the leading M, histories (niters, M) and best_mse (M,).
    ``params_stack`` is not modified.  Runs on ``device`` (default cuda;
    raises without a card unless device='cpu')."""
    if track not in ("gt", "noisy"):
        raise ValueError(f"fit_pointwise_many: track={track!r}, expected "
                         f"'gt' or 'noisy'")
    dev = resolve(device)
    M = tree.replicas(params_stack)
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
    if permutation is None and not full_batch:
        permutation = _replica_generators(cfg, M, dev)

    params = _on_device(params_stack, dev)
    opt = Adam(cfg, params, npoints=npoints, nchunks=nchunks)
    best_params = tree.map(torch.clone, params)
    best_rec = torch.zeros((M, npoints, c), dtype=torch.float32, device=dev)
    rec = best_rec if full_batch else torch.zeros_like(best_rec)
    best_mse = torch.full((M,), float("inf"), device=dev)
    hist_gt = torch.empty((cfg.niters, M), device=dev)
    hist_noisy = torch.empty((cfg.niters, M), device=dev)
    inv_nc = 1.0 / (npoints * c)
    scratch = StepScratch()
    nunits = npoints // U
    # replica r's rows of the (M * nunits, U * c) view of rec
    offsets = torch.arange(M, device=dev)[:, None] * nunits

    rows_of = _chunk_rows(grid, coords, target, gt_arr, U, mp, (M,))

    clock = _StepClock(dev, cfg.niters)
    t0 = time.time()
    for epoch in _epochs(0, cfg.niters):
        clock.tick(epoch)
        if full_batch:
            pred, grads, (sse_t, sse_g) = model.step_grads_many(
                params, coords, target, gt=gt_arr, want_metrics=True,
                scratch=scratch)
            opt.step(params, grads)
            rec = pred
        else:
            perm = torch.stack([  # (nchunks, M, mp / U)
                _sentinel_rows(permutation(nunits, r).to(dev), nunits,
                               npad // U, nchunks) for r in range(M)], dim=1)
            sse_t, sse_g = _chunked_epoch(
                model.step_grads_many, opt, params, rec, rows_of, perm, U=U,
                mp=mp, npad=npad, sort=cfg.sort_chunks, scratch=scratch,
                offsets=offsets)
        with profiling.span("trainer.tracking"):
            mse_noisy = sse_t * inv_nc
            mse_gt = sse_g * inv_nc
            hist_gt[epoch] = mse_gt
            hist_noisy[epoch] = mse_noisy
            tracked = mse_gt if track == "gt" else mse_noisy
            best_mse, (best_rec, best_params) = _keep_best(
                tracked, best_mse, (rec, params), (best_rec, best_params))
    step_ms = clock.ms()
    wall = time.time() - t0
    return FitResult(
        params=params, best_params=best_params,
        best_rec=best_rec.cpu().numpy(), final_rec=rec.cpu().numpy(),
        mse_gt=hist_gt.cpu().numpy(), mse_noisy=hist_noisy.cpu().numpy(),
        best_mse=best_mse.cpu().numpy(), wall_time_s=wall, step_ms=step_ms)


@_fitter
def fit_frames_many(model, params_stack, frame_coords, frame_pixels,
                    frame_masks, cfg: FitConfig, *, hr_shape, scale,
                    batch_size=4, batched_frames=False,
                    permutation: Optional[Callable] = None, device=None):
    """M multi-frame SR fits in one loop (wire_tpu/train/trainer.py:724):
    ``fit_frames``'s step (render a batch of frames' warped grids, box
    downsample, masked MSE, Adam) for every replica at once, one
    ``apply_many`` a step (on the card one ``wire_mlp``, ``wire2d_mlp``,
    ``real_mlp`` or ``mfn_mlp`` pair for all M; an autodiff family's
    ``torch.func.vmap`` of its plain apply).

    The frames (n, H*W, 2), (n, h*w, C), (n, h*w, C) are shared by the
    replicas, or with ``batched_frames`` carry a leading M: M different
    bursts.  Replica r's frame order comes from a generator of its own
    seeded ``cfg.seed + r`` (or ``permutation(n, r)``), so replica r
    reproduces ``fit_frames(..., seed=cfg.seed + r)`` on its burst.
    Returns a FitResult whose params carry the leading M, histories
    (niters, M) and best_mse (M,); best_rec and final_rec are None.
    ``params_stack`` is not modified.  Runs on ``device`` (default cuda;
    raises without a card unless device='cpu')."""
    dev = resolve(device)
    M = tree.replicas(params_stack)
    fc = _as_tensor(frame_coords, dev)
    fp = _as_tensor(frame_pixels, dev)
    fm = _as_tensor(frame_masks, dev)
    if batched_frames and not fc.shape[0] == fp.shape[0] == fm.shape[0] == M:
        raise ValueError(f"fit_frames_many: batched_frames needs frames with "
                         f"a leading axis of {M} replicas, got "
                         f"{tuple(fc.shape)}, {tuple(fp.shape)}, "
                         f"{tuple(fm.shape)}")
    nframes = fc.shape[1] if batched_frames else fc.shape[0]
    H, W, C = hr_shape
    bs = min(batch_size, nframes)
    nbatches = -(-nframes // bs)
    npad = nbatches * bs - nframes
    per_frame = float(fp.shape[-2] * fp.shape[-1])
    if permutation is None:
        permutation = _replica_generators(cfg, M, dev)

    params = _on_device(params_stack, dev)
    opt = Adam(cfg, params, nchunks=nbatches)
    best_params = tree.map(torch.clone, params)
    best_loss = torch.full((M,), float("inf"), device=dev)
    hist = torch.empty((cfg.niters, M), device=dev)
    replica = torch.arange(M, device=dev)[:, None]

    def frames(x, safe):
        return x[replica, safe] if batched_frames else x[safe]

    clock = _StepClock(dev, cfg.niters)
    t0 = time.time()
    for epoch in _epochs(0, cfg.niters):
        clock.tick(epoch)
        orders = torch.stack([  # (M, nbatches, bs)
            _sentinel_rows(permutation(nframes, r).to(dev), nframes, npad,
                           nbatches) for r in range(M)])
        losses = []
        for b in range(nbatches):
            fidx = orders[:, b]
            valid = (fidx < nframes).to(torch.float32)
            safe = fidx.clamp(max=nframes - 1)
            paths, leaves, p = grad_leaves(params)
            with torch.enable_grad():
                rend = model.apply_many(p, frames(fc, safe))
                lr = multi_sr_op(rend.reshape(M, bs, H, W, C), scale)
                m = frames(fm, safe) * valid[:, :, None, None]
                err = (lr.reshape(M, bs, -1, C) - frames(fp, safe)) * m
                sq = err ** 2
                denom = per_frame * torch.clamp(valid.sum(1), min=1)
                total = torch.sum(sq.reshape(M, -1).sum(1) / denom)
                flat = torch.autograd.grad(total, leaves, allow_unused=True)
            opt.step(params, grads_tree(paths, leaves, flat))
            with profiling.span("trainer.tracking"):
                loss = _replica_sums(sq.detach()) / denom
                best_loss, best_params = _keep_best(loss, best_loss, params,
                                                    best_params)
            losses.append(loss)
        with profiling.span("trainer.tracking"):
            hist[epoch] = torch.stack(losses).sum(0)
    step_ms = clock.ms()
    wall = time.time() - t0
    mse_hist = hist.cpu().numpy()
    return FitResult(
        params=params, best_params=best_params, best_rec=None,
        final_rec=None, mse_gt=mse_hist, mse_noisy=mse_hist,
        best_mse=best_loss.cpu().numpy(), wall_time_s=wall, step_ms=step_ms)


@_fitter
def fit_operator_many(model, params_stack, coords, measurement, operator_fn,
                      cfg: FitConfig, *, gt_field=None, field_shape,
                      track="gt", batched_measurement=False, device=None):
    """M operator fits (the CT / SISR loop) in one loop
    (wire_tpu/train/trainer.py:1267): every iteration renders the full grid
    for all M replicas in one ``apply_many`` (on the card one ``wire_mlp``,
    ``wire2d_mlp``, ``real_mlp`` or ``mfn_mlp`` pair for all M; an autodiff
    family's ``torch.func.vmap`` of its plain apply), calls ``operator_fn``
    ONCE on the (M, *field_shape) stack, takes each replica's MSE against the
    measurement, and steps Adam on the stacked leaves; the learning rate
    decays per iteration, as wire_tpu forces (``schedule_per="iter"``).

    The measurement and gt_field are shared by the replicas (multi-seed
    fits), or with ``batched_measurement`` carry a leading M: M different
    measurements.  ``operator_fn`` must take the stack (the port's
    operators do: ``RadonOp``, ``DownsampleOp``, ``sisr_op``); wire_tpu's
    vmap gave a caller's operator the leading axis for free, here a
    caller's own operator has to take it.  Replica r reproduces
    ``fit_operator`` from its init.  Returns a FitResult whose params and
    best_rec carry the leading M, histories (niters, M) and best_mse (M,).
    ``params_stack`` is not modified.  Runs on ``device`` (default cuda;
    raises without a card unless device='cpu')."""
    if track not in ("gt", "loss"):
        raise ValueError(f"fit_operator_many: track={track!r}, expected "
                         f"'gt' or 'loss'")
    dev = resolve(device)
    M = tree.replicas(params_stack)
    coords = _as_tensor(coords, dev)
    measurement = _as_tensor(measurement, dev)
    track_gt = gt_field is not None and track == "gt"
    gt_arr = _as_tensor(gt_field, dev) if track_gt else None
    field_shape = tuple(field_shape)
    if batched_measurement and (measurement.shape[0] != M or (
            track_gt and gt_arr.shape[0] != M)):
        raise ValueError(f"fit_operator_many: batched_measurement needs a "
                         f"measurement (and gt_field) with a leading axis "
                         f"of {M} replicas")

    params = _on_device(params_stack, dev)
    opt = Adam(cfg, params, nchunks=1)
    best_params = tree.map(torch.clone, params)
    best_field = torch.zeros((M,) + field_shape, dtype=torch.float32,
                             device=dev)
    best_loss = torch.full((M,), float("inf"), device=dev)
    hist_loss = torch.empty((cfg.niters, M), device=dev)
    hist_tracked = torch.empty((cfg.niters, M), device=dev)

    clock = _StepClock(dev, cfg.niters)
    t0 = time.time()
    for it in _epochs(0, cfg.niters):
        clock.tick(it)
        paths, leaves, p = grad_leaves(params)
        with torch.enable_grad():
            field = model.apply_many(p, coords).reshape((M,) + field_shape)
            sq = (operator_fn(field) - measurement) ** 2
            total = torch.sum(torch.mean(sq.reshape(M, -1), dim=1))
            flat = torch.autograd.grad(total, leaves, allow_unused=True)
        opt.step(params, grads_tree(paths, leaves, flat))
        with profiling.span("trainer.tracking"):
            field = field.detach()
            loss = _replica_means(sq.detach())
            tracked = (_replica_means((field - gt_arr) ** 2) if track_gt
                       else loss)
            hist_loss[it] = loss
            hist_tracked[it] = tracked
            best_loss, (best_field, best_params) = _keep_best(
                tracked, best_loss, (field, params), (best_field,
                                                      best_params))
    step_ms = clock.ms()
    wall = time.time() - t0
    return FitResult(
        params=params, best_params=best_params,
        best_rec=best_field.cpu().numpy(), final_rec=None,
        mse_gt=hist_tracked.cpu().numpy(), mse_noisy=hist_loss.cpu().numpy(),
        best_mse=best_loss.cpu().numpy(), wall_time_s=wall, step_ms=step_ms)
