"""The port's SISR path against wire_tpu on the CPU: cv2's INTER_AREA and
INTER_LINEAR resizes in numpy (signals/image.py) against cv2 itself, the
box-downsample operator against wire_tpu's, a short B-spline fit_operator
SISR fit from the same bridged init against wire_tpu's, the SISR app
writing its artifacts, and MS-SSIM against wire_tpu's.

Tolerances: the resizes apply cv2's weight tables as float64 matrices
where cv2 sums in float32, so they agree to 1.2e-7 on [0, 1] images (held
to 1e-6); the operator is a reshape-mean in both (rtol 1e-6); the fit
keeps the pointwise fit's rel 1e-4 on the loss and tracked histories
(tests/test_torch_trainer.py).  At the preset's scale 1/9 wire_tpu's
relu^2 form of the quadratic spline rounds to ~1e-5 per activation where
it cancels to zero (tests/test_torch_real_models.py measures wire_tpu's
own two paths 6e-5 apart; the port evaluates the spline piecewise), so the
best field is held to 3e-4 x its largest entry, and a weight whose every
unit lies outside the spline's support has, in wire_tpu, a gradient of
pure rounding, which Adam's m / sqrt(v) turns into a step of up to the
learning rate: the parameters are held to rel 1e-4 with atol niters x lr
(measured: the weights into one dead first-layer unit, 3 of 192 with its
bias, and into one dead first-hidden unit, 64 of 4,096, up to 2.2 steps
apart; the rest within 1e-5).  MS-SSIM is float64 here and float32 in
wire_tpu (rtol 1e-5)."""
import os

import cv2
import numpy as np
import pytest
from scipy import io

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.operators import forward as JF
from wire_tpu.signals import image as JI
from wire_tpu.train import metrics as JM
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge
from wire_tpu_torch.apps import common as TC
from wire_tpu_torch.apps import sisr as TS
from wire_tpu_torch.operators import forward as TF
from wire_tpu_torch.ops import resample as RS
from wire_tpu_torch.signals import coords as C, image as I
from wire_tpu_torch.train import metrics as M
from wire_tpu_torch.train import presets
from wire_tpu_torch.train import trainer as T
from wire_tpu_torch.train.presets import get_config

REL = 1e-4


@pytest.mark.parametrize("shape,f,interp", [
    ((512, 512, 3), 1 / 3, "area"), ((168, 168, 3), 1 / 4, "area"),
    ((512, 512, 3), 1 / 2, "area"), ((100, 70), 1 / 3, "area"),
    ((42, 42, 3), 4, "linear"), ((21, 30, 3), 4, "linear")])
def test_resize_matches_cv2(shape, f, interp):
    im = np.random.default_rng(0).random(shape).astype(np.float32)
    flag = cv2.INTER_AREA if interp == "area" else cv2.INTER_LINEAR
    want = cv2.resize(im, None, fx=f, fy=f, interpolation=flag)
    got = (I.resize_area if interp == "area" else I.resize_linear)(im, f)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resize_area_gives_cv2s_size_where_a_box_average_does_not():
    """512 / 3 rounds to 171 in cv2; an integer box average gives 170."""
    im = JI.natural_image(512, 512, 3, seed=0)
    got = I.resize_area(im, 1 / 3)
    assert got.shape == (171, 171, 3) == JI.resize_area(im, 1 / 3).shape
    np.testing.assert_allclose(got, JI.resize_area(im, 1 / 3), atol=1e-6)


def test_sisr_images_match_wire_tpu_preprocessing():
    im, lr = TS.sisr_images(None, 0, 4)
    ref = JI.resize_area(JI.natural_image(512, 512, 3, seed=0), 1 / 3)
    ref = ref[:168, :168]
    assert im.shape == (168, 168, 3) and lr.shape == (42, 42, 3)
    np.testing.assert_allclose(im, ref, atol=1e-6)
    np.testing.assert_allclose(lr, JI.resize_area(ref, 1 / 4), atol=1e-6)


@pytest.mark.parametrize("scale", [2, 4])
def test_downsample_operator_matches_wire_tpu(scale):
    f = np.random.default_rng(scale).random((24, 36, 3)).astype(np.float32)
    want = np.asarray(JF.DownsampleOp(scale)(jnp.asarray(f)))
    got = TF.DownsampleOp(scale)(torch.tensor(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(TF.sisr_op(torch.tensor(f), scale).numpy(),
                               want, rtol=1e-6)
    np.testing.assert_allclose(
        RS.area_downsample_hwc(torch.tensor(f), scale).numpy(), want,
        rtol=1e-6)
    assert TF.DownsampleOp(scale) == TF.DownsampleOp(scale)
    assert TF.identity(f) is f


def test_ms_ssim_matches_wire_tpu():
    rng = np.random.default_rng(0)
    x = rng.random((192, 200, 3)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(M.ms_ssim(x, y), float(JM.ms_ssim(x, y)),
                               rtol=1e-5)
    np.testing.assert_allclose(M.ms_ssim(x[..., 1], y[..., 1]),
                               float(JM.ms_ssim(x[..., 1], y[..., 1])),
                               rtol=1e-5)
    assert M.mse_db(1e-3) == pytest.approx(float(JM.mse_db(1e-3)))


def test_sisr_fit_matches_wire_tpu():
    """Five iterations of the B-spline SISR protocol on a 96^2 input (a 32^2
    HR field, 8^2 LR) from the same bridged init."""
    cfg = get_config("Bspline_s9_LR1e3_E2000")
    src = JI.natural_image(96, 96, 3, seed=1)
    im = I.resize_area(src, 1 / 3)[:32, :32]
    lr = I.resize_area(im, 1 / 4)
    kw = dict(in_features=2, out_features=3, hidden_features=64,
              hidden_layers=2, scale=cfg.scale)
    tmodel = TC.build_model(cfg, in_features=2, out_features=3, omega0=8.0,
                            hidden_features=64, sidelength=32)
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    coords = C.grid2d(32, 32)
    want = JT.fit_operator(
        get_inr("bspline_form", fused="never", **kw), jparams, coords, lr,
        JF.DownsampleOp(4),
        JT.FitConfig(learning_rate=cfg.learning_rate, niters=5,
                     lr_decay=0.2),
        gt_field=im, field_shape=(32, 32, 3), track="gt", donate=False)
    got = T.fit_operator(
        tmodel, tparams, coords, lr, TF.DownsampleOp(4),
        T.FitConfig(learning_rate=cfg.learning_rate, niters=5,
                    lr_decay=0.2),
        gt_field=im, field_shape=(32, 32, 3), track="gt", device="cpu")
    np.testing.assert_allclose(got.mse_gt, want.mse_gt, rtol=REL)
    np.testing.assert_allclose(got.mse_noisy, want.mse_noisy, rtol=REL)
    np.testing.assert_allclose(got.best_rec, want.best_rec, rtol=0,
                               atol=3e-4 * np.abs(want.best_rec).max())
    gp = bridge.params_to_numpy(got.best_params)
    for k in gp:
        for kk in gp[k]:
            np.testing.assert_allclose(
                gp[k][kk], np.asarray(want.best_params[k][kk]), rtol=REL,
                atol=5 * cfg.learning_rate, err_msg=f"{k}.{kk}")


@pytest.fixture(params=["Bspline_s9_LR1e3_E2000", "WIRE_s9_o8_LR5e3_E2000"])
def short_sisr_preset(request):
    """A 4-iteration copy of a SISR preset: the B-spline one, and WIRE's,
    which runs on the WIRE pair (ops/wire_mlp.py)."""
    presets.ENTRIES["testshortsisr"] = dict(presets.ENTRIES[request.param],
                                            niters=4)
    yield "testshortsisr"
    presets.ENTRIES.pop("testshortsisr", None)


def test_sisr_app_writes_artifacts(short_sisr_preset, tmp_path):
    img = str(tmp_path / "img.npy")
    np.save(img, JI.natural_image(96, 96, 3, seed=0))
    out = TS.run(short_sisr_preset, image=img,
                 results_dir=str(tmp_path / "res"), device="cpu")
    res = out["result"]
    assert res.best_rec.shape == (32, 32, 3)
    assert res.mse_gt.shape == (4,) and np.isfinite(out["mse_db"])
    assert out["mse_db"] == pytest.approx(-10 * np.log10(res.best_mse))
    assert out["ms_ssim"] is None          # 32 < 176: not reported
    p = out["path"]
    assert p.startswith(str(tmp_path / "res" / "sisr" / "DS_4"))
    for f in ("info.mat", "metrics.mat", "metrics_table.md"):
        assert os.path.exists(os.path.join(p, f)), f
    info = io.loadmat(os.path.join(p, "info.mat"))[os.path.basename(p)][0, 0]
    assert info["rec_bi"].shape == (32, 32, 3)
    # the bilinear baseline: the LR image upsampled by INTER_LINEAR
    lr = cv2.resize(info["gt"].astype(np.float32), None, fx=0.25, fy=0.25,
                    interpolation=cv2.INTER_AREA)
    want = cv2.resize(lr, None, fx=4, fy=4, interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(info["rec_bi"], want, atol=1e-6)
