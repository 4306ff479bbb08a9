"""The port's trainer (wire_tpu_torch/train/trainer.py) against wire_tpu's
fit_pointwise: a 32x32 full-batch WIRE fit of 5 epochs from the same bridged
init gives the same per-epoch MSEs, best tracking and parameters; the LR
schedule and the Adam update match optax."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from wire_tpu.nn import get_inr
from wire_tpu.signals import coords as JC, image as JI, noise as JN
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.train import trainer as T

REL = 1e-4


def _problem(H=32, W=32):
    im = JI.synthetic_image(H, W, 3, seed=0)
    noisy = JN.measure_np(im, 2, 30.0, rng=np.random.RandomState(0)).astype(
        np.float32)
    return JC.grid2d(H, W), noisy.reshape(-1, 3), im.reshape(-1, 3)


@pytest.mark.parametrize("hf,layers,with_gt", [(64, 2, True), (40, 1, False)])
def test_fit_matches_wire_tpu(hf, layers, with_gt):
    coords, target, gt = _problem()
    gt = gt if with_gt else None
    kw = dict(in_features=2, out_features=3, hidden_features=hf,
              hidden_layers=layers, first_omega0=7.0, hidden_omega0=7.0,
              scale=8.0)
    tmodel = tget_inr("wire", **kw)
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    jcfg = JT.FitConfig(learning_rate=5e-3, niters=5, maxpoints=4096,
                        scale_lr_by_batch=True)
    want = JT.fit_pointwise(get_inr("wire", fused="never", **kw), jparams,
                            coords, target, jcfg, gt=gt, donate=False)
    cfg = T.FitConfig(learning_rate=5e-3, niters=5, maxpoints=4096,
                      scale_lr_by_batch=True)
    got = T.fit_pointwise(tmodel, tparams, coords, target, cfg, gt=gt,
                          device="cpu")
    np.testing.assert_allclose(got.mse_gt, want.mse_gt, rtol=REL)
    np.testing.assert_allclose(got.mse_noisy, want.mse_noisy, rtol=REL)
    np.testing.assert_allclose(got.best_mse, want.best_mse, rtol=REL)
    np.testing.assert_allclose(got.best_rec, want.best_rec, rtol=REL,
                               atol=1e-5)
    np.testing.assert_allclose(got.final_rec, want.final_rec, rtol=REL,
                               atol=1e-5)
    # Adam's m / sqrt(v) turns last-digit gradient differences of entries
    # near zero into visible update differences; an entry moves at most lr
    # per step, so parameters are held to 1% of one step
    for name, g, w in (("params", got.params, want.params),
                       ("best_params", got.best_params, want.best_params)):
        gp = bridge.params_to_numpy(g)
        for k in gp:
            for kk in gp[k]:
                np.testing.assert_allclose(gp[k][kk], np.asarray(w[k][kk]),
                                           rtol=REL, atol=0.01 * 5e-3,
                                           err_msg=f"{name} {k}.{kk}")
    assert got.step_ms is None     # no device clock on the CPU
    # the input params are left as they were
    assert torch.equal(tparams["first"]["w"],
                       tmodel.init(torch.Generator().manual_seed(0))
                       ["first"]["w"])


@pytest.mark.parametrize("nchunks", [1, 3, 4])
def test_lr_schedule_matches(nchunks):
    kw = dict(learning_rate=5e-3, niters=7)
    want = JT._lr_schedule(JT.FitConfig(**kw), nchunks)
    got = T.lr_schedule(T.FitConfig(**kw), nchunks)
    for step in range(0, 40, 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_adam_matches_optax():
    cfg = T.FitConfig(learning_rate=1e-2, niters=4, maxpoints=50,
                      scale_lr_by_batch=True)
    jcfg = JT.FitConfig(learning_rate=1e-2, niters=4, maxpoints=50,
                        scale_lr_by_batch=True)
    rng = np.random.default_rng(0)
    p0 = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)}}
    tx = JT.make_optimizer(jcfg, None, npoints=200, nchunks=1)
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = bridge.params_from_jax(p0)
    opt = T.Adam(cfg, tp, npoints=200, nchunks=1)
    for _ in range(6):
        g = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)}}
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, bridge.params_from_jax(g))
        np.testing.assert_allclose(tp["a"]["w"].numpy(),
                                   np.asarray(jp["a"]["w"]), rtol=1e-6,
                                   atol=1e-7)


def test_track_best_is_a_masked_copy():
    cur = {"x": torch.ones(3), "y": (torch.zeros(2),)}
    best = {"x": torch.full((3,), 5.0), "y": (torch.ones(2),)}
    kept = T.track_best(torch.tensor(False), cur, best)
    took = T.track_best(torch.tensor(True), cur, best)
    assert torch.equal(kept["x"], best["x"]) and torch.equal(
        kept["y"][0], best["y"][0])
    assert torch.equal(took["x"], cur["x"]) and torch.equal(
        took["y"][0], cur["y"][0])


def test_chunked_epochs_are_refused():
    """The chunked epochs, once refused, now run: a CPU fit of 256 points
    in chunks of 100 (three chunks an epoch, 44 sentinel rows in the
    last) takes every point exactly once an epoch, each chunk's valid rows
    a prefix of its rows, and writes every point of the reconstruction."""
    coords, target, gt = _problem(16, 16)
    tmodel = tget_inr("wire", out_features=3, hidden_features=16)
    params = tmodel.init(torch.Generator().manual_seed(0))
    seen = []
    step_grads = tmodel.step_grads

    def spy(p, rows, t, **kw):
        seen.append((rows[:kw["nvalid"]].clone(), rows.shape[0]))
        return step_grads(p, rows, t, **kw)

    tmodel.step_grads = spy
    cfg = T.FitConfig(niters=2, maxpoints=100)
    res = T.fit_pointwise(tmodel, params, coords, target, cfg, gt=gt,
                          device="cpu")
    assert len(seen) == 6 and {n for _, n in seen} == {100}
    want = np.sort(coords.view(np.dtype((np.void, 8))).ravel())
    for epoch in range(2):
        rows = torch.cat([r for r, _ in seen[3 * epoch:3 * epoch + 3]])
        got = np.sort(np.ascontiguousarray(rows.numpy()).view(
            np.dtype((np.void, 8))).ravel())
        assert (got == want).all(), epoch
    assert np.isfinite(res.final_rec).all() and np.isfinite(res.mse_gt).all()
    assert res.final_rec.shape == (256, 3)
    assert (res.final_rec != 0).any(axis=1).all()


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot "
                    "show")
    coords, target, _ = _problem(8, 8)
    tmodel = tget_inr("wire", out_features=3, hidden_features=16)
    params = tmodel.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.fit_pointwise(tmodel, params, coords, target,
                        T.FitConfig(niters=1), device=None)


def test_bspline_denoise_fit_matches_wire_tpu():
    """Five full-batch epochs of the B-spline denoise preset
    (Bspline_s9_5_LR8e3_E4000: bspline_form, scale 1/9.5, lr 8e-3) on a
    32x32 image from the same bridged init: the port's step is the
    canonical real step (its plain version on the CPU), wire_tpu's the
    autodiff of its plain apply.  Histories keep rel 1e-4.  The fields and
    parameters take the bounds of tests/test_torch_sisr.py's B-spline fit,
    for its reason (at alpha = 9.5 the spline's relu^2 form rounds where it
    cancels to zero): fields 3e-4 x their largest entry, parameters atol
    niters x lr."""
    from wire_tpu_torch.apps import common as TC
    from wire_tpu_torch.train.presets import get_config
    cfg = get_config("Bspline_s9_5_LR8e3_E4000")
    coords, target, gt = _problem()
    tmodel = TC.build_model(cfg, in_features=2, out_features=3, omega0=7.0,
                            hidden_features=64, sidelength=32)
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    jmodel = get_inr("bspline_form", fused="never", in_features=2,
                     out_features=3, hidden_features=64, hidden_layers=2,
                     scale=cfg.scale)
    kw = dict(learning_rate=cfg.learning_rate, niters=5, maxpoints=4096,
              scale_lr_by_batch=True)
    want = JT.fit_pointwise(jmodel, jparams, coords, target,
                            JT.FitConfig(**kw), gt=gt, donate=False)
    got = T.fit_pointwise(tmodel, tparams, coords, target, T.FitConfig(**kw),
                          gt=gt, device="cpu")
    np.testing.assert_allclose(got.mse_gt, want.mse_gt, rtol=REL)
    np.testing.assert_allclose(got.mse_noisy, want.mse_noisy, rtol=REL)
    for g, w in ((got.best_rec, want.best_rec),
                 (got.final_rec, want.final_rec)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-4 * np.abs(w).max())
    gp = bridge.params_to_numpy(got.params)
    for k in gp:
        for kk in gp[k]:
            np.testing.assert_allclose(
                gp[k][kk], np.asarray(want.params[k][kk]), rtol=REL,
                atol=5 * cfg.learning_rate, err_msg=f"{k}.{kk}")
