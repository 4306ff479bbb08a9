"""The port's WIRE model (wire_tpu_torch/nn) against wire_tpu's: forward
parity from the same weights, the bridge round trip, init shapes and
bounds, and the factory surface."""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.nn.models import wire_apply

from wire_tpu_torch import bridge
from wire_tpu_torch.nn import activations as tact
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu.nn import activations as jact

RTOL, ATOL = 2e-5, 5e-6   # tests/test_pallas_step.py's prediction tolerance


def _kw(hidden_features=300, layers=2, out=3):
    return dict(in_features=2, out_features=out,
                hidden_features=hidden_features, hidden_layers=layers,
                first_omega0=7.0, hidden_omega0=7.0, scale=8.0)


@pytest.mark.parametrize("hf,layers,out,n", [(300, 2, 3, 257), (91, 1, 1, 64),
                                             (40, 3, 2, 100)])
def test_forward_matches_jax(hf, layers, out, n):
    kw = _kw(hf, layers, out)
    model = get_inr("wire", fused="never", **kw)
    params = model.init(jax.random.key(1))
    coords = np.random.default_rng(1).uniform(-1, 1, (n, 2)).astype(
        np.float32)
    want = np.asarray(wire_apply(params, jnp.asarray(coords), model.spec))
    tmodel = tget_inr("wire", **kw)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    got = tmodel.apply(tp, torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_activations_match_jax():
    rng = np.random.default_rng(2)
    zr, zi = (rng.normal(0, 0.3, (50, 7)).astype(np.float32)
              for _ in range(2))
    for got, want in zip(
            tact.complex_gabor(torch.from_numpy(zr), torch.from_numpy(zi),
                               7.0, 8.0),
            jact.complex_gabor(jnp.asarray(zr), jnp.asarray(zi), 7.0, 8.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    for got, want in zip(
            tact.complex_gabor_real_input(torch.from_numpy(zr), 7.0, 8.0),
            jact.complex_gabor_real_input(jnp.asarray(zr), 7.0, 8.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_bridge_round_trip():
    params = get_inr("wire", **_kw()).init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    back = bridge.params_to_numpy(bridge.params_from_jax(np_params))
    assert set(back) == set(np_params)
    for k in np_params:
        for kk in np_params[k]:
            assert back[k][kk].dtype == np.float32
            np.testing.assert_array_equal(back[k][kk], np_params[k][kk])


def test_init_shapes_and_bounds_match_jax():
    """Same tree, shapes and uniform bounds as wire_tpu's init (the numbers
    differ: torch.Generator vs jax.random)."""
    kw = _kw()
    jp = jax.tree.map(np.asarray, get_inr("wire", **kw).init(
        jax.random.key(0)))
    tmodel = tget_inr("wire", **kw)
    tp = bridge.params_to_numpy(tmodel.init(torch.Generator().manual_seed(0)))
    h = int(300 / math.sqrt(2))
    assert h == 212 and tp["first"]["w"].shape == (2, h)
    assert set(tp) == set(jp) == {"first", "hidden_0", "hidden_1", "final"}
    for k in jp:
        assert set(tp[k]) == set(jp[k]), k
        fan_in = 2 if k == "first" else h
        for kk in jp[k]:
            assert tp[k][kk].shape == jp[k][kk].shape, (k, kk)
            assert tp[k][kk].dtype == np.float32
            assert np.abs(tp[k][kk]).max() <= 1 / math.sqrt(fan_in)
            # a uniform law fills its interval
            assert np.abs(tp[k][kk]).max() > 0.5 / math.sqrt(fan_in)
    assert tmodel.num_params(tmodel.init(torch.Generator().manual_seed(0))) \
        == sum(v.size for sub in jp.values() for v in sub.values())


def test_init_is_seeded_and_device_independent():
    tmodel = tget_inr("wire", **_kw(64))
    a = tmodel.init(torch.Generator().manual_seed(3))
    b = tmodel.init(torch.Generator().manual_seed(3))
    c = tmodel.init(torch.Generator().manual_seed(4))
    assert all(torch.equal(a[k][kk], b[k][kk]) for k in a for kk in a[k])
    assert not torch.equal(a["first"]["w"], c["first"]["w"])


def test_factory_defaults_aliases_and_unknown():
    m = tget_inr("wire", first_omega_0=5.0)
    jm = get_inr("wire", first_omega_0=5.0)
    for f in ("first_omega0", "hidden_omega0", "scale", "hidden_features",
              "hidden_layers", "in_features", "out_features"):
        assert getattr(m.spec, f) == getattr(jm.spec, f), f
    with pytest.raises(KeyError):
        tget_inr("not_a_family")  # no family of either registry


def test_step_grads_never_is_autodiff_and_auto_is_the_step():
    kw = _kw(40, 1, 3)
    tp = tget_inr("wire", **kw).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.uniform(-1, 1, (90, 2)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0, 1, (90, 3)).astype(np.float32))
    auto = tget_inr("wire", **kw).step_grads(tp, c, t, want_metrics=True)
    never = tget_inr("wire", fused="never", **kw).step_grads(
        tp, c, t, want_metrics=True)
    torch.testing.assert_close(auto[0], never[0], rtol=0, atol=0)
    torch.testing.assert_close(auto[2], never[2], rtol=0, atol=0)
    assert float(never[1]["final"]["bi"].abs().max()) == 0.0
