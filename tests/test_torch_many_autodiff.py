"""The batched multi-fit of the families that train by autodiff (realgabor,
bspline_sig, mscale_HL under ``detach_split``, mscale_2 outside
'freq_combine', any family at ``fused="never"``) and the batched apply of
bspline_knots and mscale_1: nn/models.py's ``autodiff_step_many``
(autograd of the batched apply) and ``vmap_apply`` (``torch.func.vmap`` of
the plain apply) against the port's serial calls and wire_tpu's
many-fitters on the CPU; every registry family reaching a batched route;
the sweep's seeds task for a family outside the paper's six.

Every input is drawn from a numpy seed; parameters cross with
``bridge.params_from_jax``.

Tolerances.  The batched products of ``torch.func.vmap`` need not round as
the serial ones do, so the batched calls are held to the serial ones
within rtol 1e-5 / atol 1e-6 (outputs, gradients) and the batched fits to
the serial fits within rel 1e-5 (histories) and rtol 1e-5 / atol 1e-6
(parameters).  Measured on the CPU at these sizes: bit-equal for every
family but WIRE-2D's plain apply (gradients 9.1e-13 apart); at the
smoke's 65,536 rows, realgabor's and mscale_2's histories 1.4e-7 - 3.9e-7
relative apart.  The fits against wire_tpu keep tests/test_torch_many.py's
bounds (histories rel 1e-4, fields rel 1e-4 / atol 1e-5, parameters rel
1e-4 / atol 5e-5) at its sizes (16 x 16, 32 wide, M 2-3, 5-6 steps).
"""
import dataclasses

import numpy as np
import pytest

import torch

from wire_tpu.nn import get_inr
from wire_tpu.operators.forward import sisr_op as jsisr_op
from wire_tpu.signals import coords as JC
from wire_tpu.train import trainer as JT

from wire_tpu_torch import tree
from wire_tpu_torch.apps import sweep as TS
from wire_tpu_torch.nn import models as TM
from wire_tpu_torch.nn import registry as TREG
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.operators.forward import DownsampleOp
from wire_tpu_torch.signals.coords import GridSpec
from wire_tpu_torch.train import trainer as T

from .test_torch_many import (H, W, _assert_fit, _denoise_problem, _jstack,
                              _sisr_problem)

CLOSE = dict(rtol=1e-5, atol=1e-6)
HISTORY_REL = 1e-5
MS = dict(scale_tensor=(1.0, 2.0))
# (nonlin, extra spec) of every route that trains by autodiff of the
# batched apply, and of the two families whose apply has no kernel
AUTODIFF = {
    "realgabor": ("realgabor", dict(scale=2.0)),
    "bspline_sig": ("bspline_sig", dict(scale=2.0)),
    "bspline_knots": ("bspline_knots", {}),
    "mscale_1": ("bspline_mscale_1", dict(MS, scaled_hidden_features=12)),
    "mscale_hl_detach": ("bspline_mscale_HL", dict(
        MS, scaled_hidden_features=24, base_split=12, detach_split=True)),
    "mscale_2_both": ("bspline_mscale_2", dict(MS, combine_type="both")),
    "mscale_2_weights": ("bspline_mscale_2", dict(
        MS, combine_type="scale_weights")),
    "mscale_2_never": ("bspline_mscale_2", dict(MS, fused="never")),
    "siren_never": ("siren", dict(fused="never")),
    "wire_never": ("wire", dict(fused="never")),
    "wire2d_never": ("wire2d", dict(fused="never")),
    "mfn_never": ("mfn", dict(fused="never")),
}
# of those, the ones whose step is autodiff (bspline_knots and mscale_1
# step through real_step's replica hook)
AUTODIFF_STEPS = sorted(set(AUTODIFF) - {"bspline_knots", "mscale_1"})


def _model(name, M, seed, hf=16, out=3):
    nonlin, extra = AUTODIFF[name]
    model = tget_inr(nonlin, in_features=2, out_features=out,
                     hidden_features=hf, hidden_layers=2, **extra)
    return model, tree.stack([model.init(torch.Generator().manual_seed(
        seed + r)) for r in range(M)])


def _close(a, b, what, **tol):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               err_msg=what, **(tol or CLOSE))


def _close_tree(got, want, what, **tol):
    g, w = tree.leaves(got), tree.leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (p, a), (_, b) in zip(g, w):
        _close(a, b, f"{what} {p}", **tol)


def _coords(n, M, shared, seed):
    rng = np.random.default_rng(seed)
    lead = () if shared else (M,)
    return tuple(torch.tensor(rng.uniform(lo, 1, lead + (n, k)).astype(
        np.float32)) for lo, k in ((-1, 2), (0, 3), (0, 3)))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("name", sorted(AUTODIFF))
def test_vmap_apply_is_the_serial_apply(name, shared):
    """apply_many of a family whose apply runs no kernel (or whose kernel
    the spec turns off) is vmap_apply of its plain apply (mscale_2's
    batched trunk is real_mlp_many with row_gamma, its combiner vmapped):
    each replica within CLOSE of the serial apply, on shared and
    per-replica coordinates with leading axes."""
    M = 3
    model, stack = _model(name, M, 10)
    c = torch.tensor(np.random.default_rng(11).uniform(
        -1, 1, (40, 2) if shared else (M, 2, 20, 2)).astype(np.float32))
    y = model.apply_many(stack, c)
    assert y.shape == ((M, 40, 3) if shared else (M, 2, 20, 3))
    for r in range(M):
        _close(y[r], model.apply(tree.index(stack, r),
                                 c if shared else c[r]), f"{name} {r}")


@pytest.mark.parametrize("name", AUTODIFF_STEPS)
def test_autodiff_step_many_is_the_serial_step(name):
    """step_grads_many of an autodiff family (autodiff_step_many of its
    batched apply: the replicas' masked losses summed, one
    torch.autograd.grad) against step_grads per replica, with nvalid,
    denom and gt, on shared and per-replica rows: pred, every gradient
    (zeros where a leaf is unused) and the SSE sums within CLOSE."""
    M = 3
    model, stack = _model(name, M, 20)
    for shared in (True, False):
        c, t, gt = _coords(50, M, shared, 21)
        pred, grads, sums = model.step_grads_many(
            stack, c, t, nvalid=44, denom=140.0, gt=gt, want_metrics=True)
        assert pred.shape == (M, 50, 3) and sums[0].shape == (M,)
        for r in range(M):
            def rep(x):
                return x if shared else x[r]
            p1, g1, s1 = model.step_grads(
                tree.index(stack, r), rep(c), rep(t), nvalid=44,
                denom=140.0, gt=rep(gt), want_metrics=True)
            _close(pred[r], p1, f"{name} pred {r}")
            _close_tree(tree.index(grads, r), g1, f"{name} grads {r}")
            for a, b in zip(sums, s1):
                _close(a[r], b, f"{name} sse {r}")


def _registry_model(nonlin):
    # the repIN tiling's width is in_features (2 coordinates x 2 scales x
    # scaled_hidden_features), as tests/test_torch_families.py builds it
    repin = dict(MS, scaled_hidden_features=8, in_features=2 * 2 * 8)
    kw = dict(in_features=2, out_features=3, hidden_features=16,
              hidden_layers=2)
    kw.update({"bspline_mscale_1": dict(MS, scaled_hidden_features=12),
               "bspline_mscale_1_new": repin, "bspline_mscale_repIN": repin,
               "bspline_mscale_2": MS,
               "bspline_mscale_HL": dict(MS, scaled_hidden_features=24,
                                         base_split=12),
               "bspline_mscale_hier": MS}.get(nonlin, {}))
    return tget_inr(nonlin, **kw)


@pytest.mark.parametrize("nonlin", sorted(TREG.MODEL_REGISTRY))
def test_every_family_reaches_a_batched_route(nonlin):
    """Each of the registry's 19 families steps and applies batched on the
    CPU through its replica hooks or the autodiff route, with the stacked
    shapes, and replica 1 within CLOSE of its serial step."""
    M = 2
    model = _registry_model(nonlin)
    stack = tree.stack([model.init(torch.Generator().manual_seed(s))
                        for s in range(M)])
    c, t, _ = _coords(30, M, True, 31)
    pred, grads = model.step_grads_many(stack, c, t)
    assert pred.shape == (M, 30, 3)
    assert [p for p, _ in tree.leaves(grads)] == \
        [p for p, _ in tree.leaves(stack)]
    p1, g1 = model.step_grads(tree.index(stack, 1), c, t)
    _close(pred[1], p1, nonlin)
    _close_tree(tree.index(grads, 1), g1, nonlin)
    assert model.apply_many(stack, c).shape == (M, 30, 3)


@pytest.mark.parametrize("name", ["realgabor", "siren_never",
                                  "bspline_sig", "mfn_never"])
def test_autodiff_step_launches_do_not_grow_with_the_replicas(name):
    """The autodiff step's PyTorch operations (torch.profiler's CPU
    events, the SSE sums left out: they are one reduction a replica) are
    as many at 4 replicas as at 2: vmap batches each operation, the loss
    and the gradient are one each.  (mscale_2 at 'both' runs the real_mlp
    pair's replica kernels on the card; on the CPU that pair's plain
    version runs per replica, so it is counted on the card only.)"""
    from torch.profiler import ProfilerActivity, profile

    def ops(M):
        model, stack = _model(name, M, 40)
        c, t, _ = _coords(30, M, True, 41)
        model.step_grads_many(stack, c, t)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model.step_grads_many(stack, c, t)
        return sum(e.count for e in prof.key_averages()
                   if e.key.startswith("aten::"))

    assert ops(2) == ops(4) > 0


# ---------------------------------------------------------------------------
# the fitters against wire_tpu's many-fitters
# ---------------------------------------------------------------------------

FIT_KW = dict(in_features=2, hidden_features=32, hidden_layers=2)
FIT_FAMILIES = {
    "realgabor": ("realgabor", dict(first_omega0=5.0, hidden_omega0=5.0,
                                    scale=2.0)),
    "bspline_sig": ("bspline_sig", dict(scale=2.0)),
    "siren_never": ("siren", dict(first_omega0=5.0, hidden_omega0=5.0,
                                  fused="never")),
    "mscale_2_both": ("bspline_mscale_2", dict(scale_tensor=(0.5, 4.0),
                                               combine_type="both")),
    "bspline_knots": ("bspline_knots", {}),
}


def _pair(name, out=3):
    nonlin, extra = FIT_FAMILIES[name]
    kw = dict(FIT_KW, out_features=out, **extra)
    jkw = dict(kw, fused="never")
    return get_inr(nonlin, **jkw), tget_inr(nonlin, **kw)


@pytest.mark.parametrize("name", ["realgabor", "bspline_sig", "siren_never",
                                  "mscale_2_both"])
def test_fit_pointwise_many_matches_wire_tpu(name):
    target, noisy = _denoise_problem()
    M, niters = 3 if name != "mscale_2_both" else 2, 5
    jmodel, tmodel = _pair(name)
    pstack, tstack = _jstack(jmodel, M, 42)
    cfg = dict(learning_rate=1e-3, niters=niters)
    want = JT.fit_pointwise_many(jmodel, pstack, JC.grid2d(H, W), noisy,
                                 JT.FitConfig(**cfg), gt=target)
    got = T.fit_pointwise_many(tmodel, tstack, GridSpec(H, W), noisy,
                               T.FitConfig(**cfg), gt=target, device="cpu")
    _assert_fit(got, want, M, niters)


@pytest.mark.parametrize("name", ["bspline_knots", "realgabor"])
def test_fit_operator_many_sisr_matches_wire_tpu(name):
    M, niters = 2, 6
    ims, lrs = _sisr_problem(M)
    jmodel, tmodel = _pair(name)
    pstack, tstack = _jstack(jmodel, M, 7)
    cfg = dict(learning_rate=1e-3, niters=niters)
    want = JT.fit_operator_many(jmodel, pstack, JC.grid2d(H, W), lrs,
                                lambda f: jsisr_op(f, 4), JT.FitConfig(**cfg),
                                gt_field=ims, field_shape=(H, W, 3),
                                batched_measurement=True)
    got = T.fit_operator_many(tmodel, tstack, JC.grid2d(H, W), lrs,
                              DownsampleOp(4), T.FitConfig(**cfg),
                              gt_field=ims, field_shape=(H, W, 3),
                              batched_measurement=True, device="cpu")
    _assert_fit(got, want, M, niters)


# ---------------------------------------------------------------------------
# replica r of the port's autodiff fits against its serial fit at seed + r
# ---------------------------------------------------------------------------

def _near_fit(many, r, one, what):
    for name in ("mse_gt", "mse_noisy"):
        np.testing.assert_allclose(getattr(many, name)[:, r],
                                   getattr(one, name), rtol=HISTORY_REL,
                                   err_msg=f"{what} {name}")
    _close_tree(tree.index(many.params, r), one.params, f"{what} params")
    _close_tree(tree.index(many.best_params, r), one.best_params,
                f"{what} best_params")


@pytest.mark.parametrize("name,cfg_kw", [
    ("realgabor", dict()), ("bspline_sig", dict(maxpoints=100)),
    ("siren_never", dict()), ("mscale_2_both", dict())])
def test_fit_pointwise_many_replicas_are_near_serial_fits(name, cfg_kw):
    target, noisy = _denoise_problem()
    M = 2
    _, tmodel = _pair(name)
    stack = tree.stack([tmodel.init(torch.Generator().manual_seed(20 + r))
                        for r in range(M)])
    cfg = T.FitConfig(learning_rate=5e-3, niters=4, seed=5, **cfg_kw)
    many = T.fit_pointwise_many(tmodel, stack, GridSpec(H, W), noisy, cfg,
                                gt=target, device="cpu")
    for r in range(M):
        one = T.fit_pointwise(tmodel, tree.index(stack, r), GridSpec(H, W),
                              noisy, dataclasses.replace(cfg, seed=5 + r),
                              gt=target, device="cpu")
        _near_fit(many, r, one, f"{name} replica {r}")


def test_fit_operator_many_knots_replicas_are_near_serial_fits():
    """bspline_knots' SISR fit through apply_many (vmap_apply of its plain
    apply: the family's apply has no kernel) against its serial fits."""
    M = 2
    ims, lrs = _sisr_problem(M)
    _, tmodel = _pair("bspline_knots")
    stack = tree.stack([tmodel.init(torch.Generator().manual_seed(30 + r))
                        for r in range(M)])
    cfg = T.FitConfig(learning_rate=5e-3, niters=5)
    many = T.fit_operator_many(tmodel, stack, JC.grid2d(H, W), lrs[0],
                               DownsampleOp(4), cfg, gt_field=ims[0],
                               field_shape=(H, W, 3), device="cpu")
    for r in range(M):
        one = T.fit_operator(tmodel, tree.index(stack, r), JC.grid2d(H, W),
                             lrs[0], DownsampleOp(4), cfg, gt_field=ims[0],
                             field_shape=(H, W, 3), device="cpu")
        _near_fit(many, r, one, f"knots replica {r}")


# ---------------------------------------------------------------------------
# the sweep's seeds task for a family outside the paper's six
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nonlin", ["wire2d", "realgabor"])
def test_seeds_sweep_of_another_family_takes_a_learning_rate(tmp_path,
                                                             nonlin):
    """``sweep denoise --seeds 2 --nonlins F --lr`` runs any family the
    sweep builds (wire2d through its replica hooks, realgabor by autodiff
    of its batched apply); without --lr a family outside the reference
    scripts' rate tables raises, naming them."""
    argv = ["denoise", "--seeds", "2", "--nonlins", nonlin, "--niters", "2",
            "--results_dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(ValueError, match="no learning rate"):
        TS.main(argv)
    res = TS.sweep_denoise_seeds(nonlin, 2, niters=2, size=32, downscale=1,
                                 lr=5e-3, device="cpu")
    assert len(res["psnrs"]) == 2 and np.isfinite(res["psnrs"]).all()
    assert res["recs"].shape == (2, 32 * 32, 3)
    assert TS._seeds_lr(TS._DENOISE_LR, "wire", None) == 5e-3
    assert TS._seeds_lr(TS._DENOISE_LR, "wire", 1e-2) == 1e-2


def test_autodiff_step_many_applies_once_for_all_replicas():
    """autodiff_step_many calls the batched apply once for all replicas
    (spied), with the stacked parameters and the shared coordinates."""
    calls = []
    model, stack = _model("realgabor", 3, 50)
    c, t, _ = _coords(20, 3, True, 51)

    def apply_many(p, coords, spec):
        calls.append((tree.replicas(p), tuple(coords.shape)))
        return TM.vmap_apply(model._apply)(p, coords, spec)

    TM.autodiff_step_many(apply_many, stack, c, t, model.spec)
    assert calls == [(3, (20, 2))]
