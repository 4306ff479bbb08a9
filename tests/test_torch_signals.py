"""The port's host helpers (wire_tpu_torch/signals, train/metrics,
train/presets) give the same numbers as wire_tpu's."""
import numpy as np
import pytest

from wire_tpu.signals import coords as JC, image as JI, noise as JN
from wire_tpu.train import metrics as JM, presets as JP

from wire_tpu_torch.signals import coords as C, image as I, noise as N
from wire_tpu_torch.train import metrics as M, presets as P


@pytest.mark.parametrize("H,W", [(4, 7), (32, 32), (256, 256)])
def test_grid2d_identical(H, W):
    np.testing.assert_array_equal(C.grid2d(H, W), JC.grid2d(H, W))


@pytest.mark.parametrize("H,W,ch,seed", [(256, 256, 3, 0), (32, 48, 1, 5)])
def test_synthetic_image_identical(H, W, ch, seed):
    np.testing.assert_array_equal(I.synthetic_image(H, W, ch, seed),
                                  JI.synthetic_image(H, W, ch, seed))


def test_natural_image_identical():
    np.testing.assert_array_equal(I.natural_image(64, 64, 3, seed=1),
                                  JI.natural_image(64, 64, 3, seed=1))


@pytest.mark.parametrize("snr,tau", [(2, 30.0), (40, 100), (1, float("inf"))])
def test_measure_np_identical(snr, tau):
    im = JI.synthetic_image(32, 32, 3, seed=0) - 0.1  # some non-positive
    got = N.measure_np(im, snr, tau, rng=np.random.RandomState(0))
    want = JN.measure_np(im, snr, tau, rng=np.random.RandomState(0))
    np.testing.assert_array_equal(got, want)


def test_normalize_and_box_resize_match():
    im = JI.natural_image(64, 64, 3, seed=2)
    np.testing.assert_array_equal(I.normalize(im * 3 + 1, True),
                                  JI.normalize(im * 3 + 1, True))
    np.testing.assert_array_equal(I.resize_area(im, 0.5),
                                  JI._area_resize_np(im, 0.5, 0.5))
    # wire_tpu's resize_area (cv2 INTER_AREA where cv2 is present) is the
    # same box average at integer factors
    np.testing.assert_allclose(I.resize_area(im, 0.5),
                               JI.resize_area(im, 0.5), rtol=0, atol=1e-6)


def test_metrics_match():
    rng = np.random.default_rng(0)
    x = JI.synthetic_image(40, 40, 3, seed=0)
    y = (x + rng.normal(0, 0.05, x.shape)).astype(np.float32)
    np.testing.assert_allclose(M.psnr_ref(x, y), float(JM.psnr_ref(x, y)),
                               rtol=1e-6)
    assert M.ssim(x, y) == JM.ssim(x, y)
    assert M.ssim(x[..., 0], y[..., 0]) == JM.ssim(x[..., 0], y[..., 0])


def test_wire_presets_identical():
    # the ported families' presets: WIRE's, the B-spline (bspline_form) and
    # the multiscale B-spline ones, which are all of the registry's 85
    wire = [k for k in JP.ENTRIES
            if JP.ENTRIES[k]["nonlin"] in (
                "wire", "bspline_form", "bspline_mscale_2",
                "bspline_mscale_HL", "bspline_mscale_hier")]
    assert sorted(wire) == list(P.list_configs()) == sorted(JP.ENTRIES)
    for k in wire:
        assert P.get_config(k).__dict__ == JP.get_config(k).__dict__, k
    with pytest.raises(KeyError):
        P.get_config("MscaleHL_s1_ST2_SHF999")
