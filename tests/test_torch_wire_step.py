"""The port's WIRE train step (wire_tpu_torch/ops/wire_step.py) against
wire_tpu's: the plain PyTorch version vs the Pallas kernel in interpret mode
and vs autodiff of the jnp forward, from the same numpy inputs and the same
weights; the stacked layout the CUDA kernel reads; and the wrapper's device
rules on the CPU."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.nn.models import wire_apply
from wire_tpu.ops.pallas.wire_step import wire_step_fused

import chip_smoke
from wire_tpu_torch import bridge
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.ops import wire_step as WS
from wire_tpu_torch.train.profiling import launches

RTOL, ATOL = 2e-4, 1e-6   # tests/test_pallas_step.py's tolerances


def _setup(n, h, layers, out, seed=0):
    kw = dict(in_features=2, out_features=out,
              hidden_features=int(h * np.sqrt(2)) + 1, hidden_layers=layers,
              first_omega0=7.0, hidden_omega0=7.0, scale=8.0)
    model = get_inr("wire", **kw)
    tmodel = tget_inr("wire", **kw)
    params = model.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    target = rng.uniform(0, 1, (n, out)).astype(np.float32)
    gt = rng.uniform(0, 1, (n, out)).astype(np.float32)
    return model, tmodel, params, coords, target, gt


def _port(tmodel, params, coords, target, gt=None, **kw):
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    t = lambda a: None if a is None else torch.from_numpy(a)
    return WS.wire_step_plain(tp, t(coords), t(target), tmodel.spec,
                              gt=t(gt), **kw)


def _autodiff(model, params, coords, target, nvalid=None, denom=None):
    spec = dataclasses.replace(model.spec, fused="never")
    n, c = target.shape
    dn = float(n * c) if denom is None else denom

    def loss_fn(p):
        pred = wire_apply(p, coords, spec)
        err = pred - target
        if nvalid is not None:
            err = err * (jnp.arange(n)[:, None] < nvalid)
        return jnp.sum(err * err) / dn, pred

    (_, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return pred, grads


def _assert_close(got_pred, got_grads, want_pred, want_grads):
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               rtol=RTOL, atol=ATOL)
    want = jax.tree.map(np.asarray, want_grads)
    got = bridge.params_to_numpy(got_grads)
    assert set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k]), k
        for kk in want[k]:
            np.testing.assert_allclose(got[k][kk], want[k][kk], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k}.{kk}")


@pytest.mark.parametrize("n,h,layers,out", [(700, 64, 2, 3), (512, 64, 1, 1),
                                            (100, 212, 2, 3)])
def test_plain_matches_pallas_interpret(n, h, layers, out):
    model, tmodel, params, coords, target, _ = _setup(n, h, layers, out)
    # exact f32 products in the kernel (as tests/test_torch_wire_mlp.py):
    # the reference side is then not subject to the MXU's default precision
    spec_hi = model.spec.replace(gemm_precision="highest")
    pred_k, g_k = wire_step_fused(params, jnp.asarray(coords),
                                  jnp.asarray(target), spec_hi,
                                  interpret=True)
    pred, grads = _port(tmodel, params, coords, target)
    _assert_close(pred, grads, pred_k, g_k)


@pytest.mark.parametrize("n,h,layers,out", [(700, 64, 2, 3), (512, 64, 1, 1),
                                            (100, 212, 2, 3)])
def test_plain_matches_jax_autodiff(n, h, layers, out):
    model, tmodel, params, coords, target, _ = _setup(n, h, layers, out)
    pred_r, g_r = _autodiff(model, params, jnp.asarray(coords),
                            jnp.asarray(target))
    pred, grads = _port(tmodel, params, coords, target)
    _assert_close(pred, grads, pred_r, g_r)


def test_nvalid_denom_and_metrics_match_pallas():
    """Tail rows past nvalid add nothing, an explicit denom is honoured, and
    the masked SSE sums against target and gt match the kernel's."""
    model, tmodel, params, coords, target, gt = _setup(640, 64, 2, 3)
    nvalid, denom = 500, 500 * 3.0 + 7.0
    target[nvalid:] = 1e6
    pred_k, g_k, (st_k, sg_k) = wire_step_fused(
        params, jnp.asarray(coords), jnp.asarray(target), model.spec,
        nvalid=nvalid, denom=denom, gt=jnp.asarray(gt), want_metrics=True,
        interpret=True)
    pred, grads, (st, sg) = _port(tmodel, params, coords, target, gt,
                                  nvalid=nvalid, denom=denom,
                                  want_metrics=True)
    _assert_close(pred, grads, pred_k, g_k)
    np.testing.assert_allclose(float(st), float(st_k), rtol=RTOL)
    np.testing.assert_allclose(float(sg), float(sg_k), rtol=RTOL)


def test_metrics_default_gt_is_target():
    _, tmodel, params, coords, target, _ = _setup(300, 32, 2, 3)
    pred, _, (st, sg) = _port(tmodel, params, coords, target,
                              want_metrics=True)
    want = float(np.sum((pred.numpy() - target) ** 2))
    assert float(st) == float(sg)
    np.testing.assert_allclose(float(st), want, rtol=1e-5)


@pytest.mark.parametrize("n,h,layers,out", [(700, 64, 2, 3), (512, 64, 1, 1),
                                            (300, 20, 0, 2)])
def test_stacked_layout_matches_plain(n, h, layers, out):
    """The stacked weights and the backward that the CUDA kernel computes
    (written out with torch.matmul in chip_smoke.matmul_step), mapped back
    by unstack_grads, equal autodiff of the plain forward."""
    _, tmodel, params, coords, target, gt = _setup(n, h, layers, out)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    c, t, g = (torch.from_numpy(a) for a in (coords, target, gt))
    w = WS.stack_params(tp, layers)
    y, gw1, gWh, gfW, sums = chip_smoke.matmul_step(torch, w, c, t, g,
                                                     tmodel.spec)
    got = chip_smoke.tensors_of(
        y, WS.unstack_grads(gw1, gWh, gfW, tp, layers), sums)
    want = chip_smoke.tensors_of(*WS.wire_step_plain(
        tp, c, t, tmodel.spec, gt=g, want_metrics=True))
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_step_flops_counts_the_three_products():
    # 2 hidden layers of (n x 424 x 424) GEMMs, three times (fwd, data grad,
    # weight grad), dominate the WIRE-300 step
    f = WS.step_flops(65536, 2, 212, 3, 2)
    assert 6 * 2 * 65536 * 424 ** 2 < f < 1.01 * 6 * 2 * 65536 * 424 ** 2


def test_wrapper_uses_plain_only_for_cpu_tensors():
    _, tmodel, params, coords, target, _ = _setup(64, 16, 1, 3)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params))
    before = launches("wire_step")["step"]
    got = WS.wire_step(tp, torch.from_numpy(coords), torch.from_numpy(target),
                       tmodel.spec)
    want = WS.wire_step_plain(tp, torch.from_numpy(coords),
                              torch.from_numpy(target), tmodel.spec)
    assert launches("wire_step")["step"] == before
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    meta = torch.empty((64, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        WS.wire_step(tp, meta, meta, tmodel.spec)
