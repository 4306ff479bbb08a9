"""The registry's last five families in the port (wire_tpu_torch/nn:
realgabor, bspline_sig, bspline_mscale_1, bspline_mscale_1_new and
bspline_mscale_repIN) against wire_tpu's, from a JAX init moved across
with ``wire_tpu_torch.bridge``: ``apply`` and autograd of it (parameter and
coordinate gradients) against wire_tpu's plain path (``fused="never"``)
and, where wire_tpu has a kernel path, its Pallas kernels in interpret
mode (``fused="always"``); ``step_grads`` (masked by nvalid, with the SSE
sums) likewise; mscale_1, _1_new and repIN step through the canonical
real step (its plain version on the CPU), realgabor and bspline_sig by
autodiff.  Also ``build_model``'s widening of ``in_features`` for _1_new
and repIN, and the registry's 19 names.

The cases' parameters are tests/test_model_parity.py's: realgabor at a
moderate sigma 2 (the defaults drive the Gaussian factor into denormals),
the B-spline families at scale 2 and scale_tensor (1, 4).  bspline_sig is
run on coordinates of both signs (the port and wire_tpu both select the
branch per row) and on a positive first coordinate, the domain where the
reference's whole-batch branch agrees.

Tolerances are tests/test_torch_real_models.py's: outputs rtol 2e-5 /
atol 1e-5, gradients rtol 2e-4 / atol 2e-5 x max(1, max |ref|).

Also the reference the card test of the relu families' steps is held to
(chip_smoke.relu_pattern_step_reference), checked here on plain runs."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.apps import common as JC
from wire_tpu.nn import get_inr
from wire_tpu.nn import registry as JREG
from wire_tpu.train import presets as JP

from wire_tpu_torch import bridge
from wire_tpu_torch.apps import common as TC
from wire_tpu_torch.nn import registry as TREG
from wire_tpu_torch.train import presets as TP

FWD = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)

MS = dict(scale=2.0, scale_tensor=(1.0, 4.0))
# case id -> (family, factory keywords, first coordinate positive)
CASES = {
    "realgabor": ("realgabor", dict(first_omega0=7.0, hidden_omega0=7.0,
                                    scale=2.0), False),
    "bspline_sig": ("bspline_sig", dict(first_omega0=-0.2,
                                        hidden_omega0=-0.2, scale=2.0),
                    False),
    "bspline_sig_positive": ("bspline_sig", dict(first_omega0=-0.2,
                                                 hidden_omega0=-0.2,
                                                 scale=2.0), True),
    "mscale_1": ("bspline_mscale_1", dict(scaled_hidden_features=48,
                                          hidden_layers=3, **MS), False),
    "mscale_1_new": ("bspline_mscale_1_new", dict(
        scaled_hidden_features=8, in_features=2 * 2 * 8, **MS), False),
    "mscale_repIN": ("bspline_mscale_repIN", dict(
        scaled_hidden_features=8, in_features=2 * 2 * 8, **MS), False),
}
STEP_FAMILIES = ("bspline_mscale_1", "bspline_mscale_1_new",
                 "bspline_mscale_repIN")


def _close(got, want, what, grad):
    if grad:
        np.testing.assert_allclose(
            got, want, rtol=GRAD["rtol"],
            atol=GRAD["atol"] * max(1.0, float(np.abs(want).max())),
            err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **FWD)


def _setup(case, n=300, seed=0):
    nonlin, fam_kw, positive = CASES[case]
    kw = dict(in_features=2, out_features=3, hidden_features=32,
              hidden_layers=2)
    kw.update(fam_kw)
    jmodels = {"plain": get_inr(nonlin, fused="never", **kw),
               "interpret": get_inr(nonlin, fused="always", **kw)}
    params = jmodels["plain"].init(jax.random.key(seed))
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    if positive:
        coords[:, 0] = np.abs(coords[:, 0])
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return TREG.get_inr(nonlin, **kw), jmodels, params, np_params, coords, \
        target, gt


def _flat(tree_np):
    return {"/".join(str(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree_np)[0]
            for path in [[getattr(p, "key", getattr(p, "idx", p))
                          for p in path]]}


@pytest.mark.parametrize("case", CASES)
def test_apply_and_its_gradients_match_wire_tpu(case):
    tmodel, jmodels, params, np_params, coords, _, _ = _setup(case)
    g = np.random.default_rng(1).normal(size=(coords.shape[0], 3)).astype(
        np.float32)
    tp = bridge.params_from_jax(np_params)
    flat = jax.tree_util.tree_flatten_with_path(np_params)[0]
    leaves = []
    for path, _ in flat:
        node = tp
        for p in path:
            node = node[p.key]
        leaves.append(node.requires_grad_(True))
    x = torch.tensor(coords, requires_grad=True)
    y = tmodel.apply(tp, x)
    grads = torch.autograd.grad(y, leaves + [x], torch.tensor(g))
    for ref, jm in jmodels.items():
        jy, vjp = jax.vjp(lambda p, c: jm.apply(p, c), params,
                          jnp.asarray(coords))
        dp, dc = vjp(jnp.asarray(g))
        _close(y.detach().numpy(), np.asarray(jy), f"{ref} y", False)
        jflat = jax.tree_util.tree_flatten_with_path(dp)[0]
        assert len(jflat) == len(grads) - 1
        for (path, want), got in zip(jflat, grads[:-1]):
            _close(got.numpy(), np.asarray(want), f"{ref} {path}", True)
        _close(grads[-1].numpy(), np.asarray(dc), f"{ref} dcoords", True)


@pytest.mark.parametrize("case", CASES)
def test_step_grads_match_wire_tpu(case):
    tmodel, jmodels, params, np_params, coords, target, gt = _setup(case)
    nvalid, denom = 280, 280 * 3.0 + 5.0
    got = tmodel.step_grads(bridge.params_from_jax(np_params),
                            torch.tensor(coords), torch.tensor(target),
                            nvalid=nvalid, denom=denom, gt=torch.tensor(gt),
                            want_metrics=True)
    got_grads = _flat(bridge.params_to_numpy(got[1]))
    for ref, jm in jmodels.items():
        pred, grads, sums = jm.step_grads(
            params, jnp.asarray(coords), jnp.asarray(target),
            nvalid=jnp.int32(nvalid), denom=denom, gt=jnp.asarray(gt),
            want_metrics=True)
        _close(got[0].numpy(), np.asarray(pred), f"{ref} pred", False)
        want = _flat(jax.tree.map(np.asarray, grads))
        assert set(got_grads) == set(want)
        for k in want:
            _close(got_grads[k], want[k], f"{ref} {k}", True)
        for s_got, s_want in zip(got[2], sums):
            np.testing.assert_allclose(float(s_got), float(s_want),
                                       rtol=2e-5, err_msg=f"{ref} sums")


@pytest.mark.parametrize("case", CASES)
def test_step_hooks_are_the_registry_s(case):
    """mscale_1, _1_new and repIN step through the canonical real step
    (their plain version here); realgabor and bspline_sig have no hook."""
    nonlin = CASES[case][0]
    assert (nonlin in TREG.STEP_REGISTRY) == (nonlin in STEP_FAMILIES)
    assert (nonlin in JREG.STEP_REGISTRY) == (nonlin in STEP_FAMILIES)


def test_repin_expand_matches_wire_tpu():
    """The tiling's scale-major flattening, 2-D and batched coordinates."""
    from wire_tpu.nn import models as JM
    from wire_tpu_torch.nn import models as TM
    spec = TREG.get_inr("bspline_mscale_repIN", in_features=2 * 3 * 4,
                        scale_tensor=(1.0, 2.5, 4.0)).spec
    jspec = get_inr("bspline_mscale_repIN", in_features=2 * 3 * 4,
                    scale_tensor=(1.0, 2.5, 4.0)).spec
    c = np.random.default_rng(2).uniform(-1, 1, (2, 9, 2)).astype(np.float32)
    for x in (c[0], c):
        np.testing.assert_array_equal(
            TM.repin_expand(torch.tensor(x), spec).numpy(),
            np.asarray(JM._repin_expand(jnp.asarray(x), jspec)))


@pytest.mark.parametrize("name", ["MscaleHL_s1_ST2_SHF256"])
@pytest.mark.parametrize("nonlin", ["bspline_mscale_1",
                                    "bspline_mscale_1_new",
                                    "bspline_mscale_repIN"])
def test_build_model_widens_like_wire_tpu(name, nonlin):
    import dataclasses
    tcfg = dataclasses.replace(TP.get_config(name), nonlin=nonlin)
    jcfg = dataclasses.replace(JP.get_config(name), nonlin=nonlin)
    tm = TC.build_model(tcfg, in_features=2, out_features=3, omega0=7.0)
    jm = JC.build_model(jcfg, in_features=2, out_features=3, omega0=7.0)
    for f in ("in_features", "hidden_features", "scaled_hidden_features",
              "hidden_layers", "scale", "scale_tensor", "out_features"):
        assert getattr(tm.spec, f) == getattr(jm.spec, f), f
    want = 2 * 2 * 256 if nonlin != "bspline_mscale_1" else 2
    assert tm.spec.in_features == want
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jm.init(jax.random.key(0))
    assert _flat(bridge.params_to_numpy(tp)).keys() == _flat(
        jax.tree.map(np.asarray, jp)).keys()
    for k, v in _flat(jax.tree.map(np.asarray, jp)).items():
        assert _flat(bridge.params_to_numpy(tp))[k].shape == v.shape, k


def test_registry_holds_wire_tpu_s_19_names():
    assert sorted(TREG.MODEL_REGISTRY) == sorted(JREG.MODEL_REGISTRY)
    assert len(TREG.MODEL_REGISTRY) == 19
    assert sorted(TREG.STEP_REGISTRY) == sorted(JREG.STEP_REGISTRY)
    m, jm = TREG.get_inr("realgabor"), get_inr("realgabor")
    for f in ("first_omega0", "hidden_omega0", "scale"):
        assert getattr(m.spec, f) == getattr(jm.spec, f) == 10.0, f
    for nonlin in TREG.MODEL_REGISTRY:
        kw = dict(scale_tensor=(1.0, 2.0), scaled_hidden_features=8,
                  hidden_features=16)
        if nonlin in ("bspline_mscale_1_new", "bspline_mscale_repIN"):
            kw["in_features"] = 2 * 2 * 8
        m = TREG.get_inr(nonlin, **kw)
        p = m.init(torch.Generator().manual_seed(0))
        y = m.apply(p, torch.zeros(5, 2))
        assert y.shape == (5, 1) and torch.isfinite(y).all(), nonlin


@pytest.mark.parametrize("nonlin", ["relu", "posenc"])
def test_relu_pattern_step_reference_holds_the_plain_step(nonlin):
    """The reference the card holds the relu families' steps to
    (chip_smoke.relu_pattern_step_reference): on the float64 run's own relu
    pattern it is the float64 canonical step (within 1e-12 x max); on the
    fp32 run's pattern it holds the fp32 plain step within REL_TOL x max;
    a pattern flipped at a unit far from the kink is refused."""
    import chip_smoke as S
    from wire_tpu_torch.nn import models as TM
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch import tree
    model = TREG.get_inr(nonlin, hidden_features=64, out_features=3,
                         sidelength=64, scale=2.0)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(5)
    c = torch.rand((600, 2), generator=g) * 2 - 1
    t = torch.rand((600, 3), generator=g)
    kw = dict(nvalid=550, denom=1700.0, gt=torch.rand((600, 3), generator=g))

    def pattern(canon, x):
        acts, a = [], x
        for lay in canon["layers"]:
            a = torch.relu(lay["alpha"] * (a @ lay["w"]) + lay["beta"])
            acts.append(a)
        return acts

    kinds = ("relu",) * 3
    for dtype, bound in ((torch.float64, 1e-12), (torch.float32, S.REL_TOL)):
        p = tree.map(lambda v: v.to(dtype), params)
        canon = TM._canon_relu(p, model.spec)
        x = TM._posenc_pre(c.to(dtype), model.spec)
        k = dict(kw, gt=kw["gt"].to(dtype))
        plain = S.real_step_tensors(RM, *RM.real_step_plain(
            canon, x, t.to(dtype), kinds, want_metrics=True, **k))
        want, info = S.relu_pattern_step_reference(
            torch, RM, canon, x, t.to(dtype), kinds, k, pattern(canon, x),
            nonlin)
        assert len(info["flips"]) == 3
        for name, w in want.items():
            err = float((plain[name].double() - w).abs().max())
            assert err <= bound * max(float(w.abs().max()), 1e-300), name
    acts = pattern(canon, x)
    acts[1] = acts[1].clone()
    v = acts[1][:, 5]
    acts[1][:, 5] = torch.where(v > 0, 0.0, 1.0)
    with pytest.raises(AssertionError, match="relu decision"):
        S.relu_pattern_step_reference(torch, RM, canon, x, t, kinds, kw,
                                      acts, nonlin)
