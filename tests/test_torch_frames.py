"""The port's multi-frame SR fit (wire_tpu_torch/train/trainer.py:
fit_frames) and app (wire_tpu_torch/apps/multi_sr.py) against wire_tpu's,
on the CPU.

fit_frames: 6 frames of a 16 x 16 x 3 HR grid at x2, batches of 4 (two
steps an epoch, the second with two sentinel frames), 5 epochs, from one
init moved across with wire_tpu_torch.bridge and one frame order: wire_tpu
draws it through ``jax.random.permutation``, replaced here by a function
that returns the fixed order (with wire_tpu's program cache emptied so the
fit is traced with it), the port through ``fit_frames(permutation=...)``.
The frames' grids are the burst's warped grids (make_burst), the masks
zero the frames' empty border.  lr 1e-3 at omega0 5 for the reason
tests/test_torch_chunked.py gives.  Tolerances, as there: loss histories
and the best loss rel 1e-4, parameters rel 1e-4 / atol 5e-5.

The app: ``multi_sr.run`` at size 64, x2 (one frame, so no order to
share), 5 iterations, WIRE 256 wide (181 complex units) from wire_tpu's
seed-0 init moved across, with wire_tpu's motion module on its cv2-free
branches: the PSNR of the best render within 0.01 dB, the interpolation
baseline's within 1e-4 dB, the .mat written with the same keys."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy import io

from wire_tpu.apps import multi_sr as JMS
from wire_tpu.nn import get_inr
from wire_tpu.signals import image as JI
from wire_tpu.signals import motion as JMo
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge
from wire_tpu_torch.apps import multi_sr as TMS
from wire_tpu_torch.dist.mesh import Mesh
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.signals import motion as Mo
from wire_tpu_torch.train import trainer as T

REL = 1e-4
EPOCHS = 5
H = W = 16
SCALE = 2
NFRAMES, BS = 6, 4
ORDER = np.array([4, 0, 5, 2, 1, 3], np.int32)


def _frames():
    im = JI.synthetic_image(H, W, 3, seed=0)
    hr, X, Y, _ = Mo.make_burst(im, shift_max=3, theta_max=0.2,
                                nframes=NFRAMES,
                                rng=np.random.RandomState(1))
    lr = Mo.downsample_burst(hr, SCALE)
    ds = Mo.FrameDataset.build(lr, X, Y, 1.0 - np.float32(lr == 0))
    return ds


def _kw(nonlin):
    kw = dict(in_features=2, out_features=3, hidden_features=32,
              hidden_layers=2, first_omega0=5.0, hidden_omega0=5.0,
              scale=2.0)
    if nonlin == "posenc":
        kw.update(pos_encode=True, sidelength=H)
    return ("relu" if nonlin == "posenc" else nonlin), kw


def _fits(monkeypatch, nonlin, niters=EPOCHS):
    ds = _frames()
    name, kw = _kw(nonlin)
    monkeypatch.setattr(JT, "_PROGRAMS", {})
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n, *a, **k: jnp.asarray(ORDER))
    tmodel = tget_inr(name, **kw)
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    cfg_kw = dict(learning_rate=1e-3, niters=niters, lr_decay=0.2)
    want = JT.fit_frames(get_inr(name, fused="never", **kw), jparams,
                         ds.coords, ds.pixels, ds.masks,
                         JT.FitConfig(**cfg_kw), hr_shape=(H, W, 3),
                         scale=SCALE, batch_size=BS, donate=False)
    got = T.fit_frames(tmodel, tparams, ds.coords, ds.pixels, ds.masks,
                       T.FitConfig(**cfg_kw), hr_shape=(H, W, 3),
                       scale=SCALE, batch_size=BS, device="cpu",
                       permutation=lambda n: torch.as_tensor(
                           ORDER.astype(np.int64)))
    return got, want


def _assert_params(got, want, what):
    gflat = jax.tree_util.tree_flatten_with_path(
        bridge.params_to_numpy(got))[0]
    wflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    assert [p for p, _ in gflat] == [p for p, _ in wflat]
    for (path, g), (_, w) in zip(gflat, wflat):
        np.testing.assert_allclose(g, w, rtol=REL, atol=5e-5,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("nonlin", ["wire", "siren", "gauss", "posenc",
                                    "mfn"])
def test_fit_frames_matches_wire_tpu(monkeypatch, nonlin):
    got, want = _fits(monkeypatch, nonlin)
    assert got.mse_gt.shape == (EPOCHS,)
    np.testing.assert_allclose(got.mse_noisy, want.mse_noisy, rtol=REL)
    np.testing.assert_array_equal(got.mse_gt, got.mse_noisy)
    np.testing.assert_allclose(got.best_mse, want.best_mse, rtol=REL)
    assert got.best_rec is None and got.final_rec is None
    assert got.step_ms is None
    _assert_params(got.params, want.params, "params")
    _assert_params(got.best_params, want.best_params, "best_params")


def test_fit_frames_loss_is_wire_tpus_masked_mean():
    """One epoch at lr 0: the history is the sum of the two batches'
    losses, each sum(err^2) / (h*w*C * valid frames), the sentinel frames
    (the order's tail) adding nothing."""
    ds = _frames()
    name, kw = _kw("wire")
    model = tget_inr(name, **kw)
    params = model.init(torch.Generator().manual_seed(0))
    res = T.fit_frames(model, params, ds.coords, ds.pixels, ds.masks,
                       T.FitConfig(learning_rate=0.0, niters=1),
                       hr_shape=(H, W, 3), scale=SCALE, batch_size=BS,
                       device="cpu", permutation=lambda n: torch.as_tensor(
                           ORDER.astype(np.int64)))
    with torch.no_grad():
        rend = model.apply(params, torch.from_numpy(ds.coords))
    lr = rend.reshape(NFRAMES, H // SCALE, SCALE, W // SCALE, SCALE, 3).mean(
        (2, 4)).reshape(NFRAMES, -1, 3).numpy().astype(np.float64)
    err = ((lr - ds.pixels) * ds.masks) ** 2
    per = err.sum((1, 2)) / ds.pixels[0].size
    want = per[ORDER[:4]].sum() / 4 + per[ORDER[4:]].sum() / 2
    np.testing.assert_allclose(res.mse_noisy[0], want, rtol=1e-5)
    np.testing.assert_allclose(res.best_mse, min(per[ORDER[:4]].sum() / 4,
                                                 per[ORDER[4:]].sum() / 2),
                               rtol=1e-5)


def test_default_frame_orders_are_seeded_and_fresh_each_epoch():
    """Without the hook each epoch draws a new frame order from the fit's
    seed: two fits at one seed agree bit for bit, another seed differs;
    every frame is in every epoch's order once."""
    ds = _frames()
    name, kw = _kw("wire")
    model = tget_inr(name, **kw)
    p0 = model.init(torch.Generator().manual_seed(0))
    seen = []
    apply = model.apply

    def spy(p, c):
        seen.append(c.shape[0])
        return apply(p, c)

    model.apply = spy
    fits = [T.fit_frames(model, p0, ds.coords, ds.pixels, ds.masks,
                         T.FitConfig(niters=3, seed=s), hr_shape=(H, W, 3),
                         scale=SCALE, batch_size=BS, device="cpu")
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(fits[0].mse_gt, fits[1].mse_gt)
    assert not np.array_equal(fits[0].mse_gt, fits[2].mse_gt)
    assert seen == [BS] * (2 * 3 * 3)


def test_multi_sr_app_matches_wire_tpu(monkeypatch, tmp_path):
    monkeypatch.setattr(JMo, "cv2", None)
    kw = dict(size=64, scale_sr=2, niters=5, seed=0)
    want = JMS.run("wire", results_dir=str(tmp_path / "jax"), **kw)
    jmodel = get_inr("wire", in_features=2, out_features=3,
                     hidden_features=256, hidden_layers=2, first_omega0=10.0,
                     hidden_omega0=10.0, scale=5.0)
    params = bridge.params_from_jax(jax.tree.map(
        np.asarray, jmodel.init(jax.random.key(0))))
    got = TMS.run("wire", results_dir=str(tmp_path / "torch"), params=params,
                  device="cpu", **kw)
    assert abs(got["psnr"] - want["psnr"]) <= 0.01
    assert abs(got["psnr_interp"] - want["psnr_interp"]) <= 1e-4
    np.testing.assert_allclose(got["result"].mse_noisy,
                               want["result"].mse_noisy, rtol=1e-3)
    assert got["mat"] == os.path.join(str(tmp_path / "torch"), "multi_SR",
                                      "2x_1images_wire_oracle_reg.mat")
    mat = io.loadmat(got["mat"])
    jmat = io.loadmat(os.path.join(str(tmp_path / "jax"), "multi_SR",
                                   "2x_1images_wire_oracle_reg.mat"))
    assert sorted(k for k in mat if not k.startswith("__")) == sorted(
        k for k in jmat if not k.startswith("__"))
    assert mat["rec"].shape == (64, 64, 3)
    np.testing.assert_allclose(mat["rec_interp"], jmat["rec_interp"],
                               atol=1e-6)


def test_multi_sr_app_estimated_registration_on_the_cpu(tmp_path):
    out = TMS.run("wire", results_dir=str(tmp_path), size=64, scale_sr=4,
                  niters=2, use_gt_registration=False, hidden_features=16,
                  device="cpu")
    assert out["mat"].endswith("4x_4images_wire_estim_reg.mat")
    assert np.isfinite(out["psnr"]) and out["result"].mse_gt.shape == (2,)
    prob = TMS.setup(size=64, scale_sr=4, use_gt_registration=False)
    assert prob["ok"].tolist() == [1.0] * 4
    assert prob["ds"].coords.shape == (4, 64 * 64, 2)
    assert prob["model"].spec.hidden_features == 256


def test_multi_sr_app_refuses_what_is_not_ported(tmp_path):
    mesh = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"),
                backend="gloo")
    with pytest.raises(ValueError, match="batch_size=1 not divisible by "
                                         "mesh size 2"):
        TMS.run(results_dir=str(tmp_path), size=16, scale_sr=2, niters=1,
                mesh=mesh)
    with pytest.raises(RuntimeError, match="--mesh 2"):
        TMS.main(["--mesh", "2", "--results_dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TMS.run(results_dir=str(tmp_path), size=16, niters=1)


def test_multi_sr_main_runs_on_the_cpu(tmp_path):
    TMS.main(["--device", "cpu", "--niters", "1", "--scale_sr", "2",
              "--results_dir", str(tmp_path), "--nonlin", "siren"])
    assert os.path.exists(os.path.join(str(tmp_path), "multi_SR",
                                       "2x_1images_siren_oracle_reg.mat"))
