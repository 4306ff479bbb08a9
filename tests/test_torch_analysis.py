"""The port's analysis tools and library leftovers against wire_tpu on the
CPU: analysis/aggregate.py (Agg_results.md and the montage), analysis/
inspect.py (error_map, spectrum, noisy_preview, layer_outputs),
operators/video_cs.py, signals/image.py's inpainting_mask, build_montage
and shepp_logan, signals/noise.py's salt_and_pepper_np and measure,
train/metrics.py's psnr_standard, rsnr, ssim_gaussian, total_variation and
count_parameters, signals/coords.py's jgrid2d, operators/forward.py's
sinogram_op, ops/resample.py's rotate_stack and nn/layers.py's
complex_linear_from_real.

Tolerances: the numpy ports (masks, noise, montage, phantom, spectrum,
error map, previews, the montage PNGs) are bit-equal under one
RandomState; the metrics within rtol 1e-5 (wire_tpu computes them in
float32, the port in float32 or float64); ``measure`` by law over
100,000 draws at each of two intensities: the sample mean within 4 of
its standard errors of the Poisson-plus-Gaussian law's, the sample
variance within 8 of a Gaussian law's variance error (the Poisson part's
excess kurtosis widens it); the torch ports of JAX functions
(``layer_outputs``, ``video_to_coded``, ``complex_linear_from_real``,
``jgrid2d``, ``rotate_stack``) within tests/test_torch_radon.py's rotate
tolerance, rtol 1e-5 / atol 1e-6 (float32 rounding of the same sums in
another order), ``sinogram_op`` within 1e-5 (16-row sums of values up to
1); the layer montages within 1e-4 (min-max normalized atoms carry a
unit's rounding up by its spread).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.analysis import aggregate as JAG
from wire_tpu.analysis import inspect as JIN
from wire_tpu.nn import get_inr
from wire_tpu.nn import layers as JL
from wire_tpu.operators import forward as JF
from wire_tpu.operators import video_cs as JV
from wire_tpu.ops import resample as JRS
from wire_tpu.signals import coords as JCO
from wire_tpu.signals import image as JI
from wire_tpu.signals import noise as JN
from wire_tpu.train import metrics as JM

from wire_tpu_torch import bridge
from wire_tpu_torch.analysis import aggregate as TAG
from wire_tpu_torch.analysis import inspect as TIN
from wire_tpu_torch.apps import common as TC
from wire_tpu_torch.nn import layers as TL
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.operators import forward as TF
from wire_tpu_torch.operators import video_cs as TV
from wire_tpu_torch.ops import resample as TRS
from wire_tpu_torch.signals import coords as TCO
from wire_tpu_torch.signals import image as TI
from wire_tpu_torch.signals import noise as TN
from wire_tpu_torch.train import metrics as TM

TIGHT = dict(rtol=1e-5, atol=1e-6)


def _runs(root):
    """Two run folders as the apps write them: metrics with a scalar, a
    list and an int; reconstructions of two sizes, RGB and 2-D."""
    rng = np.random.RandomState(5)
    for name, rec, lr in (("runA", rng.rand(12, 10, 3), 5e-3),
                          ("runB", rng.rand(9, 11), (1e-3, 2e-3))):
        TC.write_run_artifacts(str(root), "", name,
                               {"rec": rec.astype(np.float32)},
                               {"Scale": 8.0, "Learning Rate":
                                np.asarray(lr), "Number of parameters": 42,
                                "Best PSNR": 20.0 + rng.rand()})
    return root


def _table(path):
    lines = open(path).read().splitlines()
    header = [c.strip() for c in lines[0].strip("|").split("|")]
    rows = {}
    for line in lines[2:]:
        cells = [c.strip() for c in line.strip("|").split("|")]
        rows[cells[0]] = dict(zip(header[1:], cells[1:]))
    return rows


def _value(cell):
    cell = cell.strip("[]")
    return [round(float(x), 3) for x in cell.split(",")]


def test_aggregate_matches_wire_tpu(tmp_path):
    pytest.importorskip("pandas")
    plt = pytest.importorskip("matplotlib.pyplot")
    root = _runs(tmp_path / "runs")
    runs = TAG.collect_runs(str(root))
    assert runs == JAG.collect_runs(str(root))
    assert sorted(runs) == ["runA_1", "runB_1"]
    got = TAG.aggregate(runs, str(tmp_path / "port"))
    want = JAG.aggregate(runs, str(tmp_path / "jax"))
    assert list(got) == list(want)
    for label in got:
        assert list(got[label]) == list(want[label])
        for k in got[label]:
            np.testing.assert_array_equal(got[label][k], want[label][k])
    tg = _table(str(tmp_path / "port" / "Agg_results.md"))
    tw = _table(str(tmp_path / "jax" / "Agg_results.md"))
    assert list(tg) == list(tw)
    for label in tg:
        assert list(tg[label]) == list(tw[label])
        for k in tg[label]:
            assert _value(tg[label][k]) == _value(tw[label][k]), (label, k)
    np.testing.assert_array_equal(
        plt.imread(str(tmp_path / "port" / "Output_img.png")),
        plt.imread(str(tmp_path / "jax" / "Output_img.png")))
    TAG.main(["--root", str(root), "--out", str(tmp_path / "cli")])
    assert sorted(os.listdir(tmp_path / "cli")) == ["Agg_results.md",
                                                    "Output_img.png"]


def test_error_map_spectrum_and_previews_match_wire_tpu(tmp_path):
    plt = pytest.importorskip("matplotlib.pyplot")
    rng = np.random.RandomState(2)
    gt = rng.rand(16, 14, 3).astype(np.float32)
    rec = gt + 0.05 * rng.randn(16, 14, 3).astype(np.float32)
    for side, mod in (("port", TIN), ("jax", JIN)):
        os.makedirs(tmp_path / side)
        mod.error_map(gt[..., 0], rec[..., 0],
                      str(tmp_path / side / "err.png"))
        mod.spectrum(rec, str(tmp_path / side / "spec.png"))
        mod.noisy_preview(gt, [(30, 2), (10, 1)], str(tmp_path / side),
                          rng=np.random.RandomState(9))
    np.testing.assert_array_equal(TIN.error_map(gt, rec),
                                  JIN.error_map(gt, rec))
    np.testing.assert_array_equal(TIN.spectrum(rec), JIN.spectrum(rec))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    for f in os.listdir(tmp_path / "jax"):
        np.testing.assert_array_equal(
            plt.imread(str(tmp_path / "port" / f)),
            plt.imread(str(tmp_path / "jax" / f)), err_msg=f)


WIRE_KW = dict(first_omega0=7.0, hidden_omega0=7.0, scale=8.0)


@pytest.mark.parametrize("nonlin,kw,imag", [
    ("wire", WIRE_KW, False), ("wire", WIRE_KW, True),
    ("siren", dict(first_omega0=30.0, hidden_omega0=30.0), False),
    ("gauss", dict(scale=10.0), False), ("relu", {}, False),
    ("bspline_form", dict(scale=1 / 3), False)])
def test_layer_outputs_match_wire_tpu(nonlin, kw, imag):
    H, W = 8, 6
    spec = dict(in_features=2, out_features=3, hidden_features=24,
                hidden_layers=2, **kw)
    tmodel = tget_inr(nonlin, **spec)
    tparams = tmodel.init(torch.Generator().manual_seed(1))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    coords = TCO.grid2d(H, W)
    got = TIN.layer_outputs(tmodel, tparams, coords, (H, W), get_imag=imag)
    want = JIN.layer_outputs(get_inr(nonlin, fused="never", **spec),
                             jparams, coords, (H, W), get_imag=imag)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        # min-max normalized atoms in [0, 1]: a unit of small spread
        # carries its rounding up by the normalization
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)


def test_layer_outputs_refuse_other_families():
    model = tget_inr("mfn", in_features=2, out_features=3,
                     hidden_features=8, hidden_layers=1)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="mfn"):
        TIN.layer_outputs(model, params, TCO.grid2d(4, 4), (4, 4))


def test_video_cs_matches_wire_tpu():
    masks = TV.coding_masks((6, 5, 7), 3, rng=np.random.RandomState(4))
    want = JV.coding_masks((6, 5, 7), 3, rng=np.random.RandomState(4))
    assert masks.dtype == want.dtype
    np.testing.assert_array_equal(masks, want)
    video = np.random.RandomState(5).rand(7, 6, 5).astype(np.float32)
    m_thw = np.transpose(masks, (2, 0, 1))
    got = TV.video_to_coded(video, m_thw, 3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JV.video_to_coded(video, m_thw, 3)), **TIGHT)
    v = torch.tensor(video, requires_grad=True)
    TV.video_to_coded(v, m_thw, 3).sum().backward()
    jg = jax.grad(lambda x: JV.video_to_coded(x, m_thw, 3).sum())(
        jnp.asarray(video))
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("kind", ["random2d", "random1d", "bayer"])
def test_inpainting_mask_matches_wire_tpu(kind):
    got = TI.inpainting_mask((9, 7), kind, 0.4, rng=np.random.RandomState(3))
    want = JI.inpainting_mask((9, 7), kind, 0.4, rng=np.random.RandomState(3))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        TI.inpainting_mask((9, 7), "square")


def test_montage_phantom_and_salt_and_pepper_match_wire_tpu():
    stack = np.random.RandomState(6).rand(5, 7, 6).astype(np.float32)
    np.testing.assert_array_equal(TI.build_montage(stack),
                                  JI.build_montage(stack))
    np.testing.assert_array_equal(TI.shepp_logan(48), JI.shepp_logan(48))
    img = (np.random.RandomState(7).rand(10, 8, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        TN.salt_and_pepper_np(img, 0.1, 0.2, rng=np.random.RandomState(8)),
        JN.salt_and_pepper_np(img, 0.1, 0.2, rng=np.random.RandomState(8)))


@pytest.mark.parametrize("tau", [30.0, float("inf")])
def test_measure_matches_by_law(tau):
    """On-device noise: for x in {0.5, -0.25}, the mean is x (the signed
    Poisson's mean is |x| tau sign(x) over tau) and the variance |x| / tau
    + (snr / tau)^2 (or snr^2 without photons)."""
    n, snr = 100_000, 2.0
    x = torch.tensor([0.5, -0.25]).repeat_interleave(n)
    y = TN.measure(torch.Generator().manual_seed(0), x, snr, tau)
    assert y.dtype == torch.float32 and y.shape == x.shape
    y = y.double().view(2, n)
    for i, xi in enumerate((0.5, -0.25)):
        var = snr ** 2 if tau == float("inf") else (
            abs(xi) / tau + (snr / tau) ** 2)
        se_mean = (var / n) ** 0.5
        assert abs(float(y[i].mean()) - xi) < 4 * se_mean
        # the sample variance's standard error, ~var sqrt(2 / n) for these
        # near-Gaussian laws
        assert abs(float(y[i].var()) - var) < 4 * var * (2 / n) ** 0.5 * 2
    again = TN.measure(torch.Generator().manual_seed(0), x, snr, tau)
    assert torch.equal(again.double().view(2, n), y)


def test_metrics_match_wire_tpu():
    rng = np.random.RandomState(11)
    x = rng.rand(24, 20, 3).astype(np.float32)
    y = np.clip(x + 0.05 * rng.randn(24, 20, 3), 0, 1).astype(np.float32)
    # wire_tpu's functions jitted: one compile each instead of one per
    # eager op (the same float32 program)
    for tf, jf in ((TM.psnr_standard, jax.jit(JM.psnr_standard)),
                   (TM.rsnr, jax.jit(JM.rsnr)),
                   (TM.ssim_gaussian, jax.jit(JM.ssim_gaussian))):
        for a, b in ((x, y), (x[..., 0], y[..., 0])):
            np.testing.assert_allclose(tf(a, b), float(jf(a, b)), rtol=1e-5)
    np.testing.assert_allclose(TM.psnr_standard(x, y, 2.0),
                               float(JM.psnr_standard(x, y, 2.0)), rtol=1e-5)
    nchw = np.transpose(y, (2, 0, 1))[None]
    want = float(jax.jit(JM.total_variation)(jnp.asarray(nchw)))
    np.testing.assert_allclose(float(TM.total_variation(nchw)), want,
                               rtol=1e-5)
    t = torch.tensor(nchw, requires_grad=True)
    tv = TM.total_variation(t)
    np.testing.assert_allclose(tv.item(), want, rtol=1e-5)
    tv.backward()
    jg = jax.jit(jax.grad(JM.total_variation))(jnp.asarray(nchw))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    model = tget_inr("wire", in_features=2, out_features=3,
                     hidden_features=20, hidden_layers=2)
    params = model.init(torch.Generator().manual_seed(0))
    assert TM.count_parameters(params) == JM.count_parameters(
        bridge.params_to_numpy(params)) == model.num_params(params)


def test_grid_layers_and_operators_match_wire_tpu():
    np.testing.assert_allclose(TCO.jgrid2d(7, 9).numpy(),
                               np.asarray(JCO.jgrid2d(7, 9)), **TIGHT)
    np.testing.assert_allclose(TCO.jgrid2d(7, 9).numpy(), TCO.grid2d(7, 9),
                               **TIGHT)
    rng = np.random.RandomState(12)
    p = {k: rng.randn(*s).astype(np.float32) for k, s in (
        ("wr", (4, 5)), ("wi", (4, 5)), ("br", (5,)), ("bi", (5,)))}
    x = rng.randn(6, 4).astype(np.float32)
    got = TL.complex_linear_from_real(
        {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x))
    want = JL.complex_linear_from_real(p, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TIGHT)
    img = rng.rand(16, 16).astype(np.float32)
    angles = np.array([0.0, 17.5, 90.0, 133.0], np.float32)
    np.testing.assert_allclose(
        TRS.rotate_stack(torch.tensor(img), angles).numpy(),
        np.asarray(jax.jit(JRS.rotate_stack)(jnp.asarray(img), angles)),
        **TIGHT)
    # 16-row sums of values up to 1: 1e-5 is ~10 ulp of the largest
    np.testing.assert_allclose(
        TF.sinogram_op(torch.tensor(img), angles).numpy(),
        np.asarray(jax.jit(JF.sinogram_op)(jnp.asarray(img), angles)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TF.sinogram_op(torch.tensor(img), angles, method="rotate").numpy(),
        TF.sinogram_op(torch.tensor(img), angles).numpy(), rtol=0, atol=0)
