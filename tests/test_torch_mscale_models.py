"""The port's mscale_HL and mscale_hier families and the parts that every
multiscale family needs (wire_tpu_torch: nn/models.py, tree.py, bridge.py,
train/trainer.py's per-stage Adam groups, train/presets.py) against
wire_tpu's, from a JAX init moved across with ``wire_tpu_torch.bridge``:
``apply``, autograd of ``apply`` and ``step_grads`` against wire_tpu's
plain path (``fused="never"``) and its kernels in interpret mode
(``fused="always"``); the bridge round trip of nested pytrees; parameter
counts; the 60 multiscale presets; five Adam steps with a tuple learning
rate against optax's ``multi_transform`` from ``make_optimizer``.

Tolerances are tests/test_torch_real_models.py's: outputs rtol 2e-5 / atol
1e-5, gradients rtol 2e-4 / atol 2e-5 x max(1, max |ref|), where every
gamma is at most 2; cases with a trunk at gamma >= 4 (the presets' scales
1/9 and 1/4, and hier's 1/8) are held to 3e-4 x the largest entry, that
file's bound for wire_tpu's relu^2 spline rounding where it cancels to
zero (the port evaluates the spline piecewise)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from wire_tpu.nn import get_inr
from wire_tpu.nn import registry as JREG
from wire_tpu.train import presets as JP
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge, tree
from wire_tpu_torch.nn import registry as TREG
from wire_tpu_torch.train import presets as TP
from wire_tpu_torch.train import trainer as T

FWD = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
SPLINE_CANCELLATION = 3e-4

# case id -> (family, factory keywords, loose)
CASES = {
    "hl": ("bspline_mscale_HL", dict(
        scale=1 / 9, scale_tensor=(1 / 9, 1 / 9, 4.0),
        scaled_hidden_features=384, hidden_features=32), True),
    "hl_mild": ("bspline_mscale_HL", dict(
        scale=1.0, scale_tensor=(1.0, 2.0), scaled_hidden_features=300,
        hidden_features=32), False),
    # shf 130 < base_split 256: the first band takes every lane, the
    # second is empty (MscaleHL_s1_ST2_SHF130)
    "hl_shf130": ("bspline_mscale_HL", dict(
        scale=1.0, scale_tensor=(1.0, 2.0), scaled_hidden_features=130,
        hidden_features=32), False),
    # the reference's detached bands: the first layer never trains
    "hl_detach": ("bspline_mscale_HL", dict(
        scale=1 / 9, scale_tensor=(1 / 9, 4.0), scaled_hidden_features=384,
        hidden_features=32, detach_split=True), True),
    "hier2": ("bspline_mscale_hier", dict(
        scale_tensor=(4.0, 1 / 9), hidden_features=24), True),
    "hier2_mild": ("bspline_mscale_hier", dict(
        scale_tensor=(0.5, 2.0), hidden_features=24), False),
    "hier3": ("bspline_mscale_hier", dict(
        scale_tensor=(0.125, 0.5, 4.0), hidden_features=16), True),
}
FAMILIES = ("bspline_mscale_2", "bspline_mscale_HL", "bspline_mscale_hier")


def _close(got, want, what, grad, loose):
    want = np.asarray(want)
    if loose:
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=SPLINE_CANCELLATION * float(np.abs(want).max()),
            err_msg=what)
    elif grad:
        np.testing.assert_allclose(
            got, want, rtol=GRAD["rtol"],
            atol=GRAD["atol"] * max(1.0, float(np.abs(want).max())),
            err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **FWD)


def _setup(case, n=300, seed=0):
    nonlin, fam_kw, loose = CASES[case]
    kw = dict(in_features=2, out_features=3, hidden_layers=2, **fam_kw)
    jmodels = {"plain": get_inr(nonlin, fused="never", **kw),
               "interpret": get_inr(nonlin, fused="always",
                                    gemm_precision="highest", **kw)}
    params = jmodels["plain"].init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return (TREG.get_inr(nonlin, **kw), jmodels, params, coords, target, gt,
            loose)


@pytest.mark.parametrize("case", CASES)
def test_apply_and_its_gradients_match_wire_tpu(case):
    tmodel, jmodels, params, coords, _, _, loose = _setup(case)
    g = np.random.default_rng(1).normal(size=(coords.shape[0], 3)).astype(
        np.float32)
    paths, leaves = zip(*tree.leaves(bridge.params_from_jax(
        jax.tree.map(np.asarray, params))))
    leaves = [t.requires_grad_(True) for t in leaves]
    x = torch.tensor(coords, requires_grad=True)
    y = tmodel.apply(tree.unflatten(paths, leaves), x)
    grads = torch.autograd.grad(y, leaves + [x], torch.tensor(g),
                                allow_unused=True)
    for ref, jm in jmodels.items():
        jy, vjp = jax.vjp(lambda p, c: jm.apply(p, c), params,
                          jnp.asarray(coords))
        dp, dc = vjp(jnp.asarray(g))
        _close(y.detach().numpy(), jy, f"{ref} y", False, loose)
        for path, gr in zip(paths, grads[:-1]):
            want = np.asarray(tree.get(dp, path))
            gr = np.zeros_like(want) if gr is None else gr.numpy()
            _close(gr, want, f"{ref} {path}", True, loose)
        # the detached bands leave nothing that reads the coordinates
        dx = torch.zeros_like(x) if grads[-1] is None else grads[-1]
        _close(dx.numpy(), dc, f"{ref} dcoords", True, loose)


@pytest.mark.parametrize("case", CASES)
def test_step_grads_match_wire_tpu(case):
    tmodel, jmodels, params, coords, target, gt, loose = _setup(case)
    nvalid, denom = 280, 280 * 3.0 + 5.0
    got = tmodel.step_grads(
        bridge.params_from_jax(jax.tree.map(np.asarray, params)),
        torch.tensor(coords), torch.tensor(target), nvalid=nvalid,
        denom=denom, gt=torch.tensor(gt), want_metrics=True)
    got_grads = tree.leaves(bridge.params_to_numpy(got[1]))
    for ref, jm in jmodels.items():
        pred, grads, sums = jm.step_grads(
            params, jnp.asarray(coords), jnp.asarray(target),
            nvalid=jnp.int32(nvalid), denom=denom, gt=jnp.asarray(gt),
            want_metrics=True)
        _close(got[0].numpy(), pred, f"{ref} pred", False, loose)
        want = tree.leaves(jax.tree.map(np.asarray, grads))
        assert [p for p, _ in got_grads] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got_grads, want):
            _close(a, b, f"{ref} {path}", True, loose)
        np.testing.assert_allclose([float(s) for s in got[2]],
                                   [float(s) for s in sums], rtol=2e-4)
    if CASES[case][1].get("detach_split"):
        assert not got[1]["first"]["w"].any()
        assert not got[1]["first"]["b"].any()


def test_hl_fold_at_shf130_puts_every_lane_in_the_first_band():
    from wire_tpu_torch.nn import models as M
    tmodel = TREG.get_inr("bspline_mscale_HL", scale=1.0,
                          scale_tensor=(1.0, 2.0),
                          scaled_hidden_features=130, hidden_features=16)
    params = tmodel.init(torch.Generator().manual_seed(0))
    assert M._mscale_hl_bounds(130, tmodel.spec) == [0, 256, 130]
    assert M._mscale_hl_fusable(params, tmodel.spec)
    canon = M._canon_mscale_hl(params, tmodel.spec)
    assert torch.equal(canon["layers"][0]["alpha"], torch.ones(130))


def test_hier_fold_has_the_segment_widths():
    """The fold's state is h + d + o lanes wide, h + m at the widening
    layers, with qspline lanes for the trunk and identity lanes for the
    carried coordinates and head sum."""
    from wire_tpu_torch.nn import models as M
    tmodel = TREG.get_inr("bspline_mscale_hier", scale_tensor=(4.0, 1 / 9),
                          hidden_features=256, out_features=3)
    params = tmodel.init(torch.Generator().manual_seed(0))
    canon = M._canon_mscale_hier(params, tmodel.spec)
    assert [lay["w"].shape[1] for lay in canon["layers"]] == [
        261, 261, 261, 517, 261, 261]
    kinds = M._hier_kinds(tmodel.spec)
    assert kinds[3] == (("qspline", 256), ("identity", 261))
    assert kinds[0] == (("qspline", 256), ("identity", 5))


def test_bridge_round_trips_nested_pytrees():
    for nonlin in FAMILIES:
        kw = dict(hidden_features=24, out_features=3, scale_tensor=(0.5, 2.0),
                  scaled_hidden_features=300)
        np_params = jax.tree.map(np.asarray, get_inr(nonlin, **kw).init(
            jax.random.key(3)))
        tp = bridge.params_from_jax(np_params)
        back = bridge.params_to_numpy(tp)
        want = jax.tree_util.tree_flatten_with_path(np_params)[0]
        got = tree.leaves(back)
        assert len(got) == len(want)
        for (path, a), (jpath, b) in zip(got, want):
            assert path == tuple(getattr(k, "key", getattr(k, "idx", None))
                                 for k in jpath)
            np.testing.assert_array_equal(a, b)
        assert tree.unflatten(*zip(*tree.leaves(tp))).keys() == tp.keys()
    hier = bridge.params_from_jax(jax.tree.map(np.asarray, get_inr(
        "bspline_mscale_hier", scale_tensor=(0.5, 2.0, 4.0)).init(
            jax.random.key(0))))
    assert isinstance(hier["stages"], list) and len(hier["stages"]) == 3
    assert hier["stages"][1][1]["w"].shape == (512, 256)


@pytest.mark.parametrize("nonlin", FAMILIES)
def test_num_params_equals_wire_tpu(nonlin):
    for st in ((1 / 9, 4.0), (1 / 9, 4.0, 8.0)):
        kw = dict(in_features=2, out_features=3, scale_tensor=st,
                  scaled_hidden_features=384)
        jm = get_inr(nonlin, **kw)
        tm = TREG.get_inr(nonlin, **kw)
        assert tm.num_params(tm.init(torch.Generator().manual_seed(0))) == \
            jm.num_params(jm.init(jax.random.key(0)))


def test_multiscale_presets_match_wire_tpu():
    names = [n for n in JP.ENTRIES if n.startswith(
        ("Mscale2_", "MscaleHL_", "MscaleHier_"))]
    assert len(names) == 60
    for name in names:
        got, want = TP.get_config(name), JP.get_config(name)
        assert got == TP.ExperimentConfig(**vars(want)), name
        assert got.nonlin in TREG.MODEL_REGISTRY
    assert TP.get_config("MscaleHier_ST1o9_LR8e3_E4000").niters == 4
    assert TP.get_config("MscaleHier_ST4_3_LR2e2_3_E4000").learning_rate == \
        (0.006, 0.009, 0.02)


def test_registry_has_the_multiscale_families():
    for nonlin in FAMILIES:
        assert nonlin in TREG.MODEL_REGISTRY and nonlin in JREG.MODEL_REGISTRY
        assert nonlin in TREG.STEP_REGISTRY and nonlin in JREG.STEP_REGISTRY
        for f in ("combine_type", "detach_split", "base_split"):
            assert getattr(TREG.get_inr(nonlin).spec, f) == getattr(
                get_inr(nonlin).spec, f), (nonlin, f)


@pytest.mark.parametrize("lrs", [(0.006, 0.02), (0.006, 0.009, 0.02)])
def test_adam_with_stage_rates_matches_optax_multi_transform(lrs):
    """Five steps on a hier parameter tree: each leaf's stage is the first
    list index on its path, as make_optimizer's label_tree gives it."""
    kw = dict(learning_rate=lrs, niters=4, maxpoints=50,
              scale_lr_by_batch=True)
    jp = get_inr("bspline_mscale_hier", hidden_features=8,
                 scale_tensor=(0.5,) * len(lrs)).init(jax.random.key(0))
    tx = JT.make_optimizer(JT.FitConfig(**kw), None, npoints=200, nchunks=1)
    state = tx.init(jp)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    opt = T.Adam(T.FitConfig(**kw), tp, npoints=200, nchunks=1)
    rng = np.random.default_rng(0)
    for _ in range(5):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32), jax.tree.map(np.asarray, jp))
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, bridge.params_from_jax(g))
        for (path, a), (_, b) in zip(
                tree.leaves(bridge.params_to_numpy(tp)),
                tree.leaves(jax.tree.map(np.asarray, jp))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))
    assert sorted(opt.groups) == sorted(set(lrs))


def test_stage_of_a_path():
    assert tree.stage_of(("stages", 2, 0, "w")) == 2
    assert tree.stage_of(("heads", 1, "b")) == 1
    assert tree.stage_of(("first", "w")) == 0
