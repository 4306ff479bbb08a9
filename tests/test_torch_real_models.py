"""The port's canonical real families (wire_tpu_torch/nn: siren, gauss,
relu, posenc and the B-splines form, cubic, srelu and knots) against
wire_tpu's, from a JAX init moved across with ``wire_tpu_torch.bridge``:
``apply``, autograd of ``apply`` (parameter and coordinate gradients) and
``step_grads`` (native-parameter gradients, masked by nvalid, and the SSE
sums), each against wire_tpu's plain path (``fused="never"``) and its
Pallas kernels in interpret mode (``fused="always"``); the bridge round
trip, the registry and the presets.

Tolerances are tests/test_pallas_real.py's (outputs rtol 2e-5 / atol 1e-5,
gradients rtol 2e-4 / atol 2e-5), with the gradients' atol scaled by the
tensor's largest entry (2e-5 x max(1, max |ref|), as in
tests/test_torch_wire_mlp.py): gauss's first-layer gradients reach ~50
here, sums that cancel, so an entry near zero keeps their rounding.

siren: the JAX kernel evaluates sine with its polynomial fast_sincos, the
port with accurate sin/cos.  Measured at omega0 = 30 the port differs from
interpret mode by at most 3.5e-7 x max |y| (outputs) and 7e-7 x max |grad|
(gradients), from the plain path by 5.5e-7 and 1.1e-6: both within the
bounds above, so no looser bound is needed.

bspline_form at the preset's scale 1/9.5 (alpha = 9.5): wire_tpu's relu^2
form of the quadratic spline cancels four terms of ~50 to zero wherever
|v| > 1.5, so it carries float32 rounding of ~1e-5 per activation
(the port evaluates the spline piecewise, exactly zero there): wire_tpu's
own plain path and kernel differ by 6.4e-5 x max |y| and 6.0e-5 x
max |grad| here, the port from them by at most 6.6e-5 and 1.1e-4.  That
case is held to 3e-4 x the largest entry (about 3x the largest measured
difference); bspline_form at scale 1/3 is held to the tight bounds."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.nn import registry as JREG
from wire_tpu.train import presets as JP

from wire_tpu_torch import bridge
from wire_tpu_torch.nn import activations as tact
from wire_tpu_torch.nn import registry as TREG
from wire_tpu.nn import activations as jact
from wire_tpu_torch.train import presets as TP

FWD = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)

# case id -> (family, factory keywords)
CASES = {
    "siren": ("siren", dict()),
    "gauss": ("gauss", dict(scale=8.0)),
    "relu": ("relu", dict()),
    "posenc": ("posenc", dict(sidelength=32)),
    "bspline_form": ("bspline_form", dict(scale=1 / 9.5)),
    "bspline_form_s3": ("bspline_form", dict(scale=1 / 3)),
    "bspline_cubic": ("bspline_cubic", dict(scale=2.0)),
    "bspline_srelu": ("bspline_srelu", dict(scale=2.0)),
    "bspline_knots": ("bspline_knots", dict()),
}
FAMILIES = {nonlin: kw for nonlin, kw in CASES.values()}
# relative to the largest entry; see the module docstring
SPLINE_CANCELLATION = 3e-4


def _close(got, want, case, what, grad):
    if case == "bspline_form":
        atol = SPLINE_CANCELLATION * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=what)
    elif grad:
        np.testing.assert_allclose(
            got, want, rtol=GRAD["rtol"],
            atol=GRAD["atol"] * max(1.0, float(np.abs(want).max())),
            err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **FWD)


def _setup(case, n=300, seed=0):
    nonlin, fam_kw = CASES[case]
    kw = dict(in_features=2, out_features=3, hidden_features=32,
              hidden_layers=2, **fam_kw)
    jmodels = {"plain": get_inr(nonlin, fused="never", **kw),
               "interpret": get_inr(nonlin, fused="always", **kw)}
    params = jmodels["plain"].init(jax.random.key(seed))
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return TREG.get_inr(nonlin, **kw), jmodels, params, np_params, coords, \
        target, gt


@pytest.mark.parametrize("case", CASES)
def test_apply_and_its_gradients_match_wire_tpu(case):
    tmodel, jmodels, params, np_params, coords, _, _ = _setup(case)
    g = np.random.default_rng(1).normal(size=(coords.shape[0], 3)).astype(
        np.float32)
    tp = bridge.params_from_jax(np_params)
    keys = [(k, kk) for k in tp for kk in tp[k]]
    leaves = [tp[k][kk].requires_grad_(True) for k, kk in keys]
    x = torch.tensor(coords, requires_grad=True)
    y = tmodel.apply(tp, x)
    grads = torch.autograd.grad(y, leaves + [x], torch.tensor(g))
    for ref, jm in jmodels.items():
        jy, vjp = jax.vjp(lambda p, c: jm.apply(p, c), params,
                          jnp.asarray(coords))
        dp, dc = vjp(jnp.asarray(g))
        _close(y.detach().numpy(), np.asarray(jy), case, f"{ref} y", False)
        for (k, kk), gr in zip(keys, grads[:-1]):
            _close(gr.numpy(), np.asarray(dp[k][kk]), case,
                   f"{ref} {k}.{kk}", True)
        _close(grads[-1].numpy(), np.asarray(dc), case, f"{ref} dcoords",
               True)


@pytest.mark.parametrize("case", CASES)
def test_step_grads_match_wire_tpu(case):
    tmodel, jmodels, params, np_params, coords, target, gt = _setup(case)
    n, nvalid, denom = coords.shape[0], 280, 280 * 3.0 + 5.0
    got = tmodel.step_grads(bridge.params_from_jax(np_params),
                            torch.tensor(coords), torch.tensor(target),
                            nvalid=nvalid, denom=denom, gt=torch.tensor(gt),
                            want_metrics=True)
    got_grads = bridge.params_to_numpy(got[1])
    for ref, jm in jmodels.items():
        pred, grads, sums = jm.step_grads(
            params, jnp.asarray(coords), jnp.asarray(target),
            nvalid=jnp.int32(nvalid), denom=denom, gt=jnp.asarray(gt),
            want_metrics=True)
        _close(got[0].numpy(), np.asarray(pred), case, f"{ref} pred", False)
        want = jax.tree.map(np.asarray, grads)
        assert set(got_grads) == set(want)
        for k in want:
            for kk in want[k]:
                _close(got_grads[k][kk], want[k][kk], case, f"{ref} {k}.{kk}",
                       True)
        np.testing.assert_allclose([float(s) for s in got[2]],
                                   [float(s) for s in sums], rtol=2e-4)


def test_fused_never_is_the_plain_family_path():
    """fused='never' takes the family's own plain apply and autodiff of it;
    'auto' (the canonical path, plain on the CPU) agrees with it."""
    for case, (nonlin, fam_kw) in CASES.items():
        kw = dict(hidden_features=16, out_features=3, **fam_kw)
        auto = TREG.get_inr(nonlin, **kw)
        never = TREG.get_inr(nonlin, fused="never", **kw)
        params = auto.init(torch.Generator().manual_seed(0))
        x = torch.rand((64, 2), generator=torch.Generator().manual_seed(1))
        _close(auto.apply(params, x).numpy(), never.apply(params, x).numpy(),
               case, case, False)


def test_bridge_round_trip_of_every_family():
    for nonlin in FAMILIES:
        kw = dict(hidden_features=24, out_features=3, **FAMILIES[nonlin])
        np_params = jax.tree.map(np.asarray, get_inr(nonlin, **kw).init(
            jax.random.key(3)))
        back = bridge.params_to_numpy(bridge.params_from_jax(np_params))
        assert set(back) == set(np_params) == {"first", "hidden_0",
                                               "hidden_1", "final"}
        for k in np_params:
            assert set(back[k]) == {"w", "b"}
            for kk in np_params[k]:
                np.testing.assert_array_equal(back[k][kk], np_params[k][kk])


def test_siren_init_has_the_scaled_bounds():
    """siren's first layer draws w from U(-1/in, 1/in), the hidden layers
    and the final one from U(-sqrt(6/h)/omega0, ...), every b from
    U(-1/sqrt(in), ...), as wire_tpu's init does."""
    kw = dict(hidden_features=64, out_features=3, first_omega0=30.0,
              hidden_omega0=30.0)
    jp = jax.tree.map(np.asarray, get_inr("siren", **kw).init(
        jax.random.key(0)))
    tp = bridge.params_to_numpy(TREG.get_inr("siren", **kw).init(
        torch.Generator().manual_seed(0)))
    bounds = {"first": (1 / 2, 1 / np.sqrt(2)),
              "hidden_0": (np.sqrt(6 / 64) / 30, 1 / 8),
              "hidden_1": (np.sqrt(6 / 64) / 30, 1 / 8),
              "final": (np.sqrt(6 / 64) / 30, 1 / 8)}
    for k, (wb, bb) in bounds.items():
        for p in (jp, tp):
            assert p[k]["w"].shape == jp[k]["w"].shape
            assert np.abs(p[k]["w"]).max() <= wb
            assert np.abs(p[k]["w"]).max() > 0.8 * wb
            assert np.abs(p[k]["b"]).max() <= bb


def test_posenc_widens_the_input_as_wire_tpu():
    for side in (32, 256, 512):
        kw = dict(hidden_features=16, sidelength=side)
        jspec = get_inr("posenc", **kw).spec
        tspec = TREG.get_inr("posenc", **kw).spec
        from wire_tpu.nn.models import posenc_out_dim as jdim
        from wire_tpu_torch.nn.models import posenc_out_dim as tdim
        assert tspec.pos_encode and tdim(tspec) == jdim(jspec)
    assert tdim(TREG.get_inr("posenc", sidelength=256).spec) == 26
    x = np.random.default_rng(0).uniform(-1, 1, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tact.posenc(torch.tensor(x), 6, 2).numpy(),
        np.asarray(jact.posenc(jnp.asarray(x), 6, 2)), rtol=1e-6, atol=1e-6)


def test_activations_match_wire_tpu():
    z = np.random.default_rng(1).uniform(-3, 3, (200, 7)).astype(np.float32)
    tz, jz = torch.tensor(z), jnp.asarray(z)
    pairs = [(tact.sine(tz, 3.0), jact.sine(jz, 3.0)),
             (tact.gauss(tz, 2.0), jact.gauss(jz, 2.0)),
             (tact.relu(tz), jact.relu(jz)),
             (tact.bspline_quadratic(tz), jact.bspline_quadratic(jz)),
             (tact.bspline_cubic(tz), jact.bspline_cubic(jz)),
             (tact.bspline_srelu(tz, 0.7), jact.bspline_srelu(jz, 0.7)),
             (tact.bspline_deboor(tz, (-1.5, -1.5, -1.5, -0.5, 0.5, 1.5,
                                       1.5, 1.5)),
              jact.bspline_deboor(jz, (-1.5, -1.5, -1.5, -0.5, 0.5, 1.5,
                                       1.5, 1.5)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # De Boor on these knots is the quadratic bump the knots family's step
    # trains through; the relu^2 form rounds to ~3e-6 where it cancels to
    # zero (|z| > 1.5 up to 3 here), De Boor gives exact zeros there
    np.testing.assert_allclose(pairs[-1][0].numpy(), pairs[3][0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_registry_matches_wire_tpu():
    for nonlin in FAMILIES:
        assert nonlin in JREG.MODEL_REGISTRY
        assert nonlin in TREG.STEP_REGISTRY
        assert (nonlin in JREG.STEP_REGISTRY)
        jspec = get_inr(nonlin).spec
        tspec = TREG.get_inr(nonlin).spec
        for f in ("first_omega0", "hidden_omega0", "scale", "pos_encode",
                  "outermost_linear", "hidden_features", "hidden_layers"):
            assert getattr(tspec, f) == getattr(jspec, f), (nonlin, f)
    assert TREG._FAMILY_DEFAULTS == {
        k: v for k, v in JREG._FAMILY_DEFAULTS.items()
        if k in TREG.MODEL_REGISTRY}


def test_bspline_presets_match_wire_tpu():
    names = [n for n in JP.ENTRIES if n.startswith("Bspline_")]
    assert len(names) == 13
    for name in names + [n for n in JP.ENTRIES if n.startswith("WIRE_")]:
        assert TP.get_config(name) == TP.ExperimentConfig(
            **vars(JP.get_config(name))), name
    # 13 B-spline + 12 WIRE entries; the 60 multiscale ones are checked in
    # tests/test_torch_mscale_models.py
    assert len(TP.ENTRIES) == 85
