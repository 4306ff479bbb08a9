"""The output check: what the window's fits produced, against the plain
reference.

For each fit and each replica of it, the program's side comes from the fit
itself (its loss history, best MSE and best reconstruction) and from the
probe (the init, the first step's gradient as the optimizer got it, the
parameters after three Adam steps); the reference works out the same fit's
first three steps again from the seed (``tasks/<task>.py:reference``).
Four numbers, each the worst over the fits and replicas:

- ``loss_gap``: the first step's loss, |program - reference| / reference
  (the second and third steps' losses swing from seed to seed with
  Adam's first update, lr x sign(g), on elements whose gradient lies
  within rounding of 0: PERF.md gives their readings; ``change_gap``
  covers those steps);
- ``grad_gap``: the first gradient, per parameter leaf the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf; the worst leaf;
- ``change_gap``: the parameters' change over the three steps, per leaf
  as ``grad_gap``, leaving out the leaves whose reference gradient is under
  a thousandth of the median leaf's (Adam moves those by round-off alone);
  the median leaf's gap, not the worst: Adam's first update moves each
  element by lr x sign(g), so an element whose gradient lies within
  rounding of 0 moves the other way on one side, and one such element of
  a small leaf (a bias; the final layer's) swings the worst leaf's gap
  from seed to seed by up to 1e-2 (PERF.md);
- ``best_gap``: the best reconstruction's MSE against the reference's clean
  signal, and the smallest MSE of the fit's history, each against the best
  MSE the fit reports: |difference| / that smallest MSE.
"""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

NAMES = ("loss_gap", "grad_gap", "change_gap", "best_gap")
ZERO_GRAD = 1e-3


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.detach().to(
        "cpu", torch.float64))) for k, v in tree.items()}


def _replica(tree, r, replicas):
    if replicas == 1:
        return tree
    return {k: v[r] for k, v in tree.items()}


def leaf_gaps(prog, ref, keep=None):
    """{leaf: |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf}; a leaf the
    program has no gradient for (autograd found no use of it: the
    optimizer gets zeros) has norm 0."""
    keys = [k for k in ref if keep is None or k in keep]
    scale = statistics.median(ref[k] for k in keys)
    return {k: _bad(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], scale))
            for k in keys}


def _bad(x):
    return x if math.isfinite(x) else math.inf


def step_numbers(fit, refs, leaves=None):
    """{loss_gap, grad_gap, change_gap} of one fit (or anything in its
    shape: ``replicas``, ``losses`` (3, M), ``g0``, ``p0``, ``p3``)
    against the reference's first steps [one dict a replica]; each
    replica's per-leaf gaps appended to ``leaves`` where given."""
    M = fit["replicas"]
    out = dict.fromkeys(NAMES[:3], 0.0)
    for r, ref in enumerate(refs):
        first = float(np.asarray(fit["losses"], np.float64)[0, r])
        out["loss_gap"] = max(out["loss_gap"], _bad(
            abs(first - ref["losses"][0]) / ref["losses"][0]))
        g_ref = _norms(ref["g0"])
        grad = leaf_gaps(_norms(_replica(fit["g0"], r, M)), g_ref)
        out["grad_gap"] = max(out["grad_gap"], max(grad.values()))
        med = statistics.median(g_ref.values())
        moved = {k for k, v in g_ref.items() if v >= ZERO_GRAD * med}
        d_ref = _norms({k: ref["p3"][k] - ref["p0"][k] for k in ref["p0"]})
        p0, p3 = (_replica(fit[k], r, M) for k in ("p0", "p3"))
        change = leaf_gaps(_norms({k: p3[k] - p0[k] for k in p0}), d_ref,
                           moved)
        out["change_gap"] = max(out["change_gap"],
                                statistics.median(change.values()))
        if leaves is not None:
            leaves.append({"grad": grad, "change": change})
    return out


def best_number(fit, refs):
    """``best_gap`` of one fit against the reference's clean signals."""
    gap = 0.0
    for r, ref in enumerate(refs):
        rec = np.asarray(fit["best_rec"][r], np.float64).reshape(
            ref["gt"].shape)
        mse = float(np.mean((rec - ref["gt"]) ** 2))
        best, low = float(fit["best_mse"][r]), float(fit["hist_min"][r])
        gap = max(gap, _bad(max(abs(mse - best), abs(low - best)) / low))
    return gap


def numbers(fit, refs):
    """{name: value} of one fit against the reference's [one dict a
    replica]."""
    return dict(step_numbers(fit, refs), best_gap=best_number(fit, refs))


def worst(per_fit):
    """The worst of each number over the fits."""
    return {k: max(n[k] for n in per_fit) for k in NAMES}


def judge(values, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit."""
    rows = [(k, values[k], limits[k]["limit"]) for k in NAMES]
    return all(v <= lim for _, v, lim in rows), rows
