"""Total-variation fits of the port (wire_tpu_torch/train/trainer.py:
fit_pointwise(tv_weight=, image_shape=)) against wire_tpu's on the CPU,
the refusals, the step's route, and the denoise app with a TV preset and
``--task representation``.

Fits: a 12 x 10 image (120 points, 3 channels), 32 features, 2 hidden
layers, 5 epochs from one init moved across with ``bridge``; full batch,
and chunked with maxpoints 50 (three chunks, 30 sentinel rows in the last)
on one permutation (wire_tpu's ``jax.random.permutation`` monkeypatched,
its program cache emptied, as tests/test_torch_chunked.py does; the port
through ``permutation``).  WIRE and B-spline (bspline_form at scale 1/3:
at the preset's 1/9.5 wire_tpu's relu^2 spline carries ~1e-5 of rounding
per activation, tests/test_torch_real_models.py, and the two fits part by
2e-3 of the field in 5 epochs with or without TV); TV weight 1e-3, where the TV term is about the size of the MSE; wire_tpu
at fused="never", and once the Pallas pair in interpret mode
(fused="always") for a tiny WIRE full batch.  lr 1e-3, as the chunked
tests take it: the fits' sensitivity to rounding stays under the
tolerances.

Tolerances, test_torch_trainer.py's: MSE histories and best MSE rel 1e-4;
reconstructions rel 1e-4 / atol 1e-5 (full batch) or atol 1e-4
(chunked, test_torch_chunked.py's); parameters rel 1e-4 / atol 1% of one
Adam step (1e-5).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy import io

from wire_tpu.nn import get_inr
from wire_tpu.train import presets as JP
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge
from wire_tpu_torch.dist.mesh import Mesh
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.signals import coords as TCO
from wire_tpu_torch.signals import image as TI
from wire_tpu_torch.train import metrics as TM
from wire_tpu_torch.train import presets as TP
from wire_tpu_torch.train import trainer as T

REL = 1e-4
LR = 1e-3
EPOCHS = 5
TV = 1e-3
H, W = 12, 10

FAMILIES = {
    "wire": dict(first_omega0=7.0, hidden_omega0=7.0, scale=8.0),
    "bspline_form": dict(scale=1 / 3),
}


def _problem():
    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:H, 0:W] / 6.0
    clean = np.stack([0.5 + 0.3 * np.sin(3 * x + c) * np.cos(2 * y)
                      for c in range(3)], -1).astype(np.float32)
    noisy = (clean + 0.1 * rng.randn(H, W, 3)).astype(np.float32)
    return TCO.grid2d(H, W), noisy.reshape(-1, 3), clean.reshape(-1, 3)


def _fits(monkeypatch, nonlin, maxpoints, fused="never", tv=TV):
    coords, target, gt = _problem()
    kw = dict(in_features=2, out_features=3, hidden_features=32,
              hidden_layers=2, **FAMILIES[nonlin])
    tmodel = tget_inr(nonlin, **kw)
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    perm = np.random.default_rng(7).permutation(H * W).astype(np.int32)
    monkeypatch.setattr(JT, "_PROGRAMS", {})
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n, *a, **k: jnp.asarray(perm))
    cfg_kw = dict(learning_rate=LR, niters=EPOCHS, maxpoints=maxpoints,
                  scale_lr_by_batch=True)
    want = JT.fit_pointwise(get_inr(nonlin, fused=fused, **kw), jparams,
                            coords, target, JT.FitConfig(**cfg_kw), gt=gt,
                            tv_weight=tv, image_shape=(H, W, 3),
                            donate=False)
    got = T.fit_pointwise(tmodel, tparams, coords, target,
                          T.FitConfig(**cfg_kw), gt=gt, tv_weight=tv,
                          image_shape=(H, W, 3), device="cpu",
                          permutation=lambda n: torch.as_tensor(
                              perm.astype(np.int64)))
    return got, want


def _check(got, want, field_atol):
    np.testing.assert_allclose(got.mse_gt, want.mse_gt, rtol=REL)
    np.testing.assert_allclose(got.mse_noisy, want.mse_noisy, rtol=REL)
    np.testing.assert_allclose(got.best_mse, want.best_mse, rtol=REL)
    for g, w in ((got.best_rec, want.best_rec),
                 (got.final_rec, want.final_rec)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=REL,
                                   atol=field_atol)
    for name, g, w in (("params", got.params, want.params),
                       ("best_params", got.best_params, want.best_params)):
        gflat = jax.tree_util.tree_flatten_with_path(
            bridge.params_to_numpy(g))[0]
        wflat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, w))[0]
        assert [p for p, _ in gflat] == [p for p, _ in wflat]
        for (path, gv), (_, wv) in zip(gflat, wflat):
            np.testing.assert_allclose(gv, wv, rtol=REL, atol=0.01 * LR,
                                       err_msg=f"{name} {path}")


@pytest.mark.parametrize("nonlin", sorted(FAMILIES))
@pytest.mark.parametrize("maxpoints", [H * W, 50],
                         ids=["full_batch", "chunked"])
def test_tv_fit_matches_wire_tpu(monkeypatch, nonlin, maxpoints):
    got, want = _fits(monkeypatch, nonlin, maxpoints)
    _check(got, want, 1e-5 if maxpoints == H * W else 1e-4)


def test_tv_fit_matches_the_interpret_mode_pair(monkeypatch):
    """wire_tpu's WIRE apply through its Pallas pair in interpret mode."""
    got, want = _fits(monkeypatch, "wire", H * W, fused="always")
    _check(got, want, 1e-5)


@pytest.mark.parametrize("maxpoints", [H * W, 50],
                         ids=["full_batch", "chunked"])
def test_tv_moves_the_fit(maxpoints):
    """The TV term is in the loss: without it the same fit differs, and a
    heavier weight makes a smoother render."""
    coords, target, gt = _problem()
    model = tget_inr("wire", in_features=2, out_features=3,
                     hidden_features=16, hidden_layers=1)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = T.FitConfig(learning_rate=5e-3, niters=20, maxpoints=maxpoints)
    tvs = []
    for tv in (0.0, TV, 10 * TV):
        res = T.fit_pointwise(model, params, coords, target, cfg, gt=gt,
                              tv_weight=tv, image_shape=(H, W, 3),
                              device="cpu")
        rec = torch.as_tensor(res.final_rec).reshape(1, H, W, 3)
        tvs.append(float(TM.total_variation(rec.permute(0, 3, 1, 2))))
    assert tvs[0] > tvs[1] > tvs[2]


def test_tv_step_is_autodiff_of_apply(monkeypatch):
    """With TV the step never reaches the family's step hook (its kernel
    on the card); without TV it does, every epoch."""
    coords, target, gt = _problem()
    model = tget_inr("wire", in_features=2, out_features=3,
                     hidden_features=16, hidden_layers=1)
    params = model.init(torch.Generator().manual_seed(0))
    calls = []
    step = model._step

    def spy(*a, **k):
        calls.append(1)
        return step(*a, **k)
    monkeypatch.setattr(model, "_step", spy)
    cfg = T.FitConfig(learning_rate=LR, niters=3, maxpoints=50)
    T.fit_pointwise(model, params, coords, target, cfg, gt=gt,
                    tv_weight=TV, image_shape=(H, W, 3), device="cpu")
    assert calls == []
    T.fit_pointwise(model, params, coords, target, cfg, gt=gt,
                    device="cpu")
    assert len(calls) == 3 * 3


@pytest.mark.parametrize("case", ["block_perm", "no_image_shape", "mesh",
                                  "negative"])
def test_tv_refusals(case):
    coords, target, gt = _problem()
    model = tget_inr("wire", in_features=2, out_features=3,
                     hidden_features=16, hidden_layers=1)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = T.FitConfig(learning_rate=LR, niters=1, maxpoints=60,
                      block_perm=4 if case == "block_perm" else 0)
    kw = dict(tv_weight=-TV if case == "negative" else TV,
              image_shape=None if case == "no_image_shape" else (H, W, 3))
    if case == "mesh":
        kw["mesh"] = Mesh(group=None, rank=0, size=2,
                          device=torch.device("cpu"), backend="gloo")
    else:
        kw["device"] = "cpu"
    match = {"block_perm": "block_perm", "no_image_shape": "image_shape",
             "mesh": "mesh", "negative": "< 0"}[case]
    with pytest.raises(ValueError, match=match):
        T.fit_pointwise(model, params, coords, target, cfg, gt=gt, **kw)


@pytest.fixture
def tv_preset():
    entry = dict(nonlin="wire", scale=8.0, scale_tensor=(0.0,),
                 scaled_hidden_features=0, learning_rate=5e-3,
                 hidden_features=32, niters=4, omega0=7.0, tvl=True,
                 lambda_tv=1e-4)
    TP.ENTRIES["testtvwire"] = dict(entry)
    JP.ENTRIES["testtvwire"] = dict(entry)
    yield "testtvwire"
    TP.ENTRIES.pop("testtvwire", None)
    JP.ENTRIES.pop("testtvwire", None)


def _files(root):
    out = []
    for d, _, fs in os.walk(root):
        rel = os.path.relpath(d, root)
        out += [os.path.join(rel, f) for f in fs]
    return sorted(out)


def test_denoise_app_tv_representation(tv_preset, tmp_path):
    """The denoise app at --task representation with a TV preset writes
    wire_tpu's artifact set, Output_img.png included (the folder
    representation/T30.0_SNR2/<preset>_1, the .mat keys); its
    Output_img.png is the picture of its own rec as plt.imsave writes it."""
    plt = pytest.importorskip("matplotlib.pyplot")
    from wire_tpu.apps import denoise as JD
    from wire_tpu_torch.apps import denoise as TD
    png = str(tmp_path / "in.png")
    TI.imsave(png, TI.synthetic_image(32, 32, 3, seed=1))
    TD.main(["--config_name", tv_preset, "--image", png, "--results_dir",
             str(tmp_path / "port"), "--task", "representation",
             "--device", "cpu"])
    JD.run(tv_preset, image=png, results_dir=str(tmp_path / "jax"),
           task="representation")
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    run = os.path.join("representation", "T30.0_SNR2", f"{tv_preset}_1")
    assert sorted(files) == sorted(os.path.join(run, f) for f in (
        "info.mat", "metrics.mat", "metrics_table.md", "Output_img.png"))
    for name in ("info.mat", "metrics.mat"):
        a = io.loadmat(str(tmp_path / "port" / run / name))
        b = io.loadmat(str(tmp_path / "jax" / run / name))
        key = f"{tv_preset}_1"
        assert sorted(a[key].dtype.names) == sorted(b[key].dtype.names)
    rec = io.loadmat(str(tmp_path / "port" / run / "info.mat"))[
        f"{tv_preset}_1"][0, 0]["rec"]
    assert rec.shape == (16, 16, 3)
    want = str(tmp_path / "want.png")
    plt.imsave(want, np.clip(np.abs(rec), 0, 1), vmin=0.0, vmax=1.0)
    np.testing.assert_array_equal(
        plt.imread(str(tmp_path / "port" / run / "Output_img.png")),
        plt.imread(want))


def test_denoise_app_passes_the_tv_weight_and_seed(tv_preset, tmp_path,
                                                   monkeypatch):
    """cfg.tvl hands lambda_tv to fit_pointwise (0 without it), and --seed
    seeds the chunked epochs' permutations, as wire_tpu's app does
    (wire_tpu/apps/denoise.py:51-60)."""
    from wire_tpu_torch.apps import denoise as TD
    seen = {}
    fit = TD.fit_pointwise

    def spy(*a, **k):
        seen.update(tv=k["tv_weight"], shape=k["image_shape"],
                    seed=a[4].seed)
        return fit(*a, **k)
    monkeypatch.setattr(TD, "fit_pointwise", spy)
    png = str(tmp_path / "in.png")
    TI.imsave(png, TI.synthetic_image(16, 16, 3, seed=1))
    TD.run(tv_preset, image=png, results_dir=str(tmp_path / "r"), seed=3,
           device="cpu")
    assert seen == {"tv": 1e-4, "shape": (8, 8, 3), "seed": 3}
    TP.ENTRIES[tv_preset]["tvl"] = False
    TD.run(tv_preset, image=png, results_dir=str(tmp_path / "r"),
           device="cpu")
    assert seen["tv"] == 0.0 and seen["seed"] == 0
