"""The port's operator-fit loop and CT app against wire_tpu on the CPU:
a 5-iteration fit_operator on a 16^2 field x 12 angles from the same
bridged init, for the rotate and fourier methods, gives the same loss and
tracked histories, best field and parameters as
wire_tpu.train.trainer.fit_operator; apps.ct.run writes its artifacts.

Tolerances are the pointwise fit's (tests/test_torch_trainer.py): rel 1e-4
on the histories and fields, parameters rel 1e-4 with atol 5e-5 (1% of one
Adam step, since m / sqrt(v) amplifies last-digit gradient differences of
entries near zero)."""
import importlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge
from wire_tpu_torch.apps import common as TC
from wire_tpu_torch.apps import ct as TCT
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.operators import radon as TR
from wire_tpu_torch.signals import coords as C
from wire_tpu_torch.train import presets
from wire_tpu_torch.train import trainer as T
from wire_tpu_torch.train.presets import get_config

JR = importlib.import_module("wire_tpu.operators.radon")

REL = 1e-4
KW = dict(in_features=2, out_features=1, hidden_features=40,
          hidden_layers=2, first_omega0=3.0, hidden_omega0=3.0, scale=12.0)


def _problem():
    img = TCT.ct_image(None, seed=0, size=32)
    thetas = np.linspace(0, 180, 12, dtype=np.float32)
    return img, thetas


def _assert_params(got, want, what):
    gp = bridge.params_to_numpy(got)
    for k in gp:
        for kk in gp[k]:
            np.testing.assert_allclose(gp[k][kk], np.asarray(want[k][kk]),
                                       rtol=REL, atol=0.01 * 5e-3,
                                       err_msg=f"{what} {k}.{kk}")


@pytest.mark.parametrize("method,track", [("rotate", "gt"),
                                          ("fourier", "gt"),
                                          ("fourier", "loss")])
def test_fit_operator_matches_wire_tpu(method, track):
    img, thetas = _problem()
    H, W = img.shape
    coords = C.grid2d(H, W)
    tmodel = tget_inr("wire", **KW)
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    jop = JR.RadonOp(jnp.asarray(thetas), method=method)
    sino = np.array(jop(jnp.asarray(img)))
    want = JT.fit_operator(
        get_inr("wire", fused="never", **KW), jparams, coords, sino, jop,
        JT.FitConfig(learning_rate=5e-3, niters=5, maxpoints=4096),
        gt_field=img, field_shape=(H, W), track=track, donate=False)
    got = T.fit_operator(
        tmodel, tparams, coords, sino, TR.RadonOp(thetas, method=method),
        T.FitConfig(learning_rate=5e-3, niters=5, maxpoints=4096),
        gt_field=img, field_shape=(H, W), track=track, device="cpu")
    np.testing.assert_allclose(got.mse_gt, want.mse_gt, rtol=REL)
    np.testing.assert_allclose(got.mse_noisy, want.mse_noisy, rtol=REL)
    np.testing.assert_allclose(got.best_mse, want.best_mse, rtol=REL)
    np.testing.assert_allclose(got.best_rec, np.asarray(want.best_rec),
                               rtol=REL, atol=1e-5)
    assert got.final_rec is None and got.step_ms is None
    _assert_params(got.params, want.params, "params")
    _assert_params(got.best_params, want.best_params, "best_params")
    if track == "loss":
        np.testing.assert_array_equal(got.mse_gt, got.mse_noisy)
    # the input params are left as they were
    assert torch.equal(tparams["first"]["w"], tmodel.init(
        torch.Generator().manual_seed(0))["first"]["w"])


@pytest.mark.parametrize("kw", [dict(render_chunked=True),
                                dict(checkpoint="ckpt.npz"),
                                dict(mesh=2)])
def test_fit_operator_refuses_what_is_not_ported(kw):
    img, thetas = _problem()
    tmodel = tget_inr("wire", **KW)
    params = tmodel.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="not ported"):
        T.fit_operator(tmodel, params, C.grid2d(*img.shape), np.zeros(
            (12, img.shape[1]), np.float32), TR.RadonOp(thetas),
            T.FitConfig(niters=1), field_shape=img.shape, device="cpu", **kw)


def test_ct_image_and_model_follow_the_jax_app():
    from wire_tpu.apps import common as JC
    from wire_tpu.signals import image as JI
    img = TCT.ct_image(None, seed=3, size=64)
    want = JC.load_image(None, size=64, channels=1, seed=3)
    want = JI.resize_area(JI.normalize(want, True), 0.5)
    assert img.shape == (32, 32) and img.dtype == np.float32
    np.testing.assert_allclose(img, want, atol=1e-6)
    cfg = get_config("WIRE_s12_o8_LR5e3_E2000")
    spec = TCT.build_ct_model(cfg, cfg.omega0).spec
    assert (spec.hidden_features, spec.hidden_layers, spec.out_features,
            spec.first_omega0, spec.hidden_omega0, spec.scale) == \
        (300, 2, 1, 3.0, 3.0, 12.0)
    assert TC.build_model(cfg, in_features=2, out_features=1,
                          omega0=3.0).spec.hidden_features == \
        cfg.hidden_features


def test_load_image_channels(tmp_path):
    rgb = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    path = str(tmp_path / "im.npy")
    np.save(path, rgb)
    np.testing.assert_array_equal(TC.load_image(path, channels=1),
                                  rgb[..., 1])
    assert TC.load_image(path).shape == (8, 8, 3)
    assert TC.load_image(None, size=16, channels=1).shape == (16, 16)
    assert TC.load_image(None, size=16).shape == (16, 16, 3)


@pytest.fixture
def short_ct_preset():
    """The CT app's preset cut to 3 iterations."""
    presets.ENTRIES["testshortct"] = dict(
        presets.ENTRIES["WIRE_s12_o8_LR5e3_E2000"], niters=3)
    yield "testshortct"
    presets.ENTRIES.pop("testshortct", None)


def _tiny_image(tmp_path):
    path = str(tmp_path / "tiny.npy")
    np.save(path, TCT.ct_image(None, seed=1, size=64))
    return path


@pytest.mark.parametrize("method", ["auto", "fourier", "shear"])
def test_ct_run_writes_artifacts(tmp_path, method, short_ct_preset):
    out = TCT.run(short_ct_preset, image=_tiny_image(tmp_path),
                  results_dir=str(tmp_path / "r"), nmeas=10,
                  radon_method=method, device="cpu")
    for name in ("info.mat", "metrics.mat", "metrics_table.md"):
        assert os.path.exists(os.path.join(out["path"], name)), name
    assert np.isfinite(out["psnr"]) and np.isfinite(out["ssim"])
    assert out["result"].best_rec.shape == (16, 16)
    assert len(out["result"].mse_gt) == 3


@pytest.mark.parametrize("ext", ["npy", "mat"])
def test_user_sinogram_routes_auto_to_rotate(tmp_path, monkeypatch, ext,
                                             short_ct_preset):
    from scipy import io as sio
    img = TCT.ct_image(_tiny_image(tmp_path))
    thetas = np.linspace(0, 180, 7, dtype=np.float32)
    sino = TR.radon(torch.tensor(img), thetas, method="rotate").numpy()
    path = str(tmp_path / f"sino.{ext}")
    if ext == "npy":
        np.save(path, sino)
    else:
        sio.savemat(path, {"sinogram": sino})
    seen = []
    real = TR.radon

    def spy(field, angles, **kw):
        seen.append(kw)
        return real(field, angles, **kw)

    monkeypatch.setattr(TR, "radon", spy)
    out = TCT.run(short_ct_preset, image=_tiny_image(tmp_path),
                  results_dir=str(tmp_path / "r"), sinogram_path=path,
                  device="cpu")
    assert seen and all(kw["reference_compat"] for kw in seen)
    assert np.isfinite(out["psnr"])
    with pytest.raises(ValueError, match="unsupported"):
        TCT._load_sinogram(str(tmp_path / "sino.txt"))


def test_ct_main_parses_the_jax_flags(tmp_path, short_ct_preset):
    TCT.main(["--config_name", short_ct_preset, "--image",
              _tiny_image(tmp_path), "--results_dir", str(tmp_path / "r"),
              "--radon_method", "rotate_xla", "--device", "cpu"])
    assert os.path.isdir(str(tmp_path / "r" / "ct"))
