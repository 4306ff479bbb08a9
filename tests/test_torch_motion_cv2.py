"""What wire_tpu's motion module computes through cv2, against the port's
cv2-free versions (wire_tpu_torch/signals/motion.py, signals/align.py and
the resizes of signals/image.py), on the CPU.

wire_tpu's cv2 branches are the reference here, so unlike
tests/test_torch_motion.py this file does not set
``wire_tpu.signals.motion.cv2`` to None.  One exception: wire_tpu's
``make_burst`` samples its frames with ``cv2.remap`` where cv2 is present,
and the port with its own bilinear ``_remap``; the burst test wraps
``JMo._remap`` so that wire_tpu takes its numpy branch for the frames
alone (its grids still come from ``cv2.resize``).

Tolerances (values are on [0, 1] unless said otherwise; "relative" is
max |port - reference| / max |reference|):

- resizes (INTER_AREA up and down, INTER_LINEAR, by factors and to a
  size) and the bursts' coordinate grids: within 1.2e-7 relative;
- burst frames (``make_burst`` at scale != 1, ``shifted_downsampled_burst``)
  within 1e-6;
- ``flow2rgb``: every byte equal where cv2 converts HSV on its vector
  path; on the last W mod 32 pixels of a row, which cv2 converts on its
  scalar path (rounding instead of truncating), each byte equal or one
  higher in cv2's picture;
- ``ecc_flow`` on pairs made with a known warp of a smooth scene
  (chip_smoke.motion_scene, not a wrapped roll): the warp's linear part
  (and a homography's perspective row) within 1e-4, its translation within
  1e-3 px, the aligned frame within 1e-4, the flow within 1e-6; the
  building blocks within cv2's: blur and gradients 1e-6, the bilinear
  warps of a blurred image (as ECC warps it) 4e-6 (cv2's warpAffine and
  warpPerspective lie up to 1.8e-6 and 3.6e-6 from a float64 bilinear
  there, beside the image's last column), one ECC iteration 1e-4;
- ``optical_flow``: endpoint error from cv2's flow at most 0.01 px in
  the mean and 0.1 px at any pixel, the returned frame equal within 1e-6
  to frame 2 remapped along the port's own flow (cv2.remap);
- ``prune_stack``: the keep mask and the kept frames and matrices equal,
  imdiff within 1e-6.
"""
import json
import os

import cv2
import numpy as np
import pytest

import chip_smoke as S
from wire_tpu.signals import image as JI
from wire_tpu.signals import motion as JMo

from wire_tpu_torch.signals import align as A
from wire_tpu_torch.signals import image as TI
from wire_tpu_torch.signals import motion as Mo

MODES = {"translation": cv2.MOTION_TRANSLATION,
         "euclidean": cv2.MOTION_EUCLIDEAN, "affine": cv2.MOTION_AFFINE,
         "homography": cv2.MOTION_HOMOGRAPHY}
TH = 0.05
WARPS = {
    "translation": np.array([[1, 0, 1.7], [0, 1, -1.2]]),
    "euclidean": np.array([[np.cos(TH), -np.sin(TH), 1.5],
                           [np.sin(TH), np.cos(TH), -0.8]]),
    "affine": np.array([[1.03, 0.02, 1.1], [-0.015, 0.98, 0.7]]),
    "homography": np.array([[1.02, 0.01, 1.2], [-0.01, 0.99, -0.6],
                            [1e-4, -5e-5, 1.0]]),
}


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _identity(motion):
    return (np.eye(3, dtype=np.float32) if motion == "homography"
            else np.eye(2, 3, dtype=np.float32))


@pytest.mark.parametrize("shape", [(12, 12), (7, 9, 3), (33, 17, 3)])
@pytest.mark.parametrize("f", [2, 3, 4, 1.5, 2.5, 1.3, 3.7])
def test_resize_area_upscales_as_cv2(shape, f):
    im = np.random.default_rng(0).random(shape).astype(np.float32)
    want = cv2.resize(im, None, fx=f, fy=f, interpolation=cv2.INTER_AREA)
    got = TI.resize_area(im, f)
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel(got, want) <= 1.2e-7


def test_resize_area_replicates_pixels_at_integer_factors():
    x = np.zeros((1, 3), np.float32)
    x[0, 1] = 1
    got = TI.resize_area(x, 4, 1)
    np.testing.assert_array_equal(got[0], [0] * 4 + [1] * 4 + [0] * 4)


@pytest.mark.parametrize("shape,dsize", [
    ((96, 96), (48, 48)), ((96, 96), (32, 32)), ((95, 94), (47, 47)),
    ((96, 90, 3), (24, 22)), ((100, 70), (33, 23)), ((24, 24), (96, 96)),
    ((30, 21, 3), (45, 50))])
@pytest.mark.parametrize("interp", ["area", "linear"])
def test_resize_to_a_size_matches_cv2(shape, dsize, interp):
    im = (np.random.default_rng(1).random(shape) * 96).astype(np.float32)
    flag = cv2.INTER_AREA if interp == "area" else cv2.INTER_LINEAR
    want = cv2.resize(im, dsize, interpolation=flag)
    fn = TI.resize_area if interp == "area" else TI.resize_linear
    got = fn(im, dsize=dsize)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1.2e-7


def _numpy_frames(monkeypatch):
    """wire_tpu's _remap on its numpy branch (its grids keep cv2)."""
    orig = JMo._remap

    def remap(*args):
        cv = JMo.cv2
        JMo.cv2 = None
        try:
            return orig(*args)
        finally:
            JMo.cv2 = cv

    monkeypatch.setattr(JMo, "_remap", remap)


@pytest.mark.parametrize("scale,size", [(2, 96), (3, 96), (4, 95)])
def test_make_burst_at_scale_matches_wire_tpu(monkeypatch, scale, size):
    _numpy_frames(monkeypatch)
    im = JI.synthetic_image(size, size, 3, seed=0)
    got = Mo.make_burst(im, 10, np.pi / 10, 3, rng=np.random.RandomState(1),
                        scale=scale)
    want = JMo.make_burst(im, 10, np.pi / 10, 3,
                          rng=np.random.RandomState(1), scale=scale)
    assert got[0].shape == want[0].shape == (3, size // scale,
                                             size // scale, 3)
    np.testing.assert_array_equal(got[3], want[3])
    assert float(np.abs(got[0] - want[0]).max()) <= 1e-6
    for g, w in zip(got[1:3], want[1:3]):
        assert _rel(g, w) <= 1.2e-7


@pytest.mark.parametrize("low_res", [(48, 48), (32, 32), (40, 30)])
def test_mat2coords_at_low_res_matches_wire_tpu(low_res):
    mats = JMo.make_burst(JI.synthetic_image(96, 96, 3, seed=0), 10,
                          np.pi / 10, 3, rng=np.random.RandomState(1))[3]
    regs = JMo.invert_regstack(mats)
    got = Mo.mat2coords(regs, (96, 96), low_res)
    want = JMo.mat2coords(regs, (96, 96), low_res)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3,) + low_res
        assert _rel(g, w) <= 1.2e-7


@pytest.mark.parametrize("scale,shape,perturb", [
    (2, (95, 94), False), (3, (96, 96), True), (4, (96, 90), False)])
def test_shifted_downsampled_burst_matches_wire_tpu(scale, shape, perturb):
    gray = JI.synthetic_image(96, 96, 3, seed=0).mean(-1)[:shape[0],
                                                         :shape[1]]
    got = Mo.shifted_downsampled_burst(gray, scale, nshifts=3,
                                       perturb_coords=perturb,
                                       rng=np.random.RandomState(2))
    want = JMo.shifted_downsampled_burst(gray, scale, nshifts=3,
                                         perturb_coords=perturb,
                                         rng=np.random.RandomState(2))
    assert got[0].shape == want[0].shape
    assert float(np.abs(got[0] - want[0]).max()) <= 1e-6
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g, w) <= 1.2e-7


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("width", [64, 80])
def test_flow2rgb_matches_cv2(seed, width):
    """Every byte equal where cv2 converts HSV to RGB on its vector path;
    on the last ``width`` mod 32 pixels of a row cv2 takes its scalar
    path, which rounds where the vector path truncates: there a byte may
    be one higher, and only there."""
    flow = np.random.default_rng(seed).normal(0, 2, (48, width, 2)).astype(
        np.float32)
    flow[0, 0] = 0                        # a zero vector: angle 0
    got, want = Mo.flow2rgb(flow), JMo.flow2rgb(flow)
    assert got.dtype == np.uint8 and got.shape == want.shape
    vec = width // 32 * 32
    np.testing.assert_array_equal(got[:, :vec], want[:, :vec])
    tail = want[:, vec:].astype(int) - got[:, vec:]
    assert set(np.unique(tail)) <= {0, 1}


def test_hsv_to_rgb_equals_cv2_over_every_hue_and_value():
    h, s, v = np.meshgrid(np.arange(180), [0, 1, 100, 254, 255],
                          np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 64, 3)
    np.testing.assert_array_equal(Mo._hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_ecc_building_blocks_match_cv2():
    im = np.random.default_rng(3).random((40, 52)).astype(np.float32)
    np.testing.assert_allclose(A.gaussian_blur(im, 5),
                               cv2.GaussianBlur(im, (5, 5), 0, 0),
                               rtol=0, atol=1e-6)
    gx, gy = A.gradients(im)
    k = np.array([[-0.5, 0.0, 0.5]], np.float32)
    np.testing.assert_allclose(gx, cv2.filter2D(im, -1, k), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gy, cv2.filter2D(im, -1, k.T), rtol=0,
                               atol=1e-6)
    # the warps, on the blurred image as ECC warps it
    im = cv2.GaussianBlur(im, (5, 5), 0, 0)
    flags = cv2.INTER_LINEAR + cv2.WARP_INVERSE_MAP
    aff = WARPS["affine"].astype(np.float32)
    np.testing.assert_allclose(A.warp(im, aff),
                               cv2.warpAffine(im, aff, (52, 40), flags=flags),
                               rtol=0, atol=4e-6)
    hom = WARPS["homography"].astype(np.float32)
    np.testing.assert_allclose(
        A.warp(im, hom), cv2.warpPerspective(im, hom, (52, 40), flags=flags),
        rtol=0, atol=4e-6)
    # the valid mask: an all-ones mask warped with INTER_NEAREST
    for tx in (0.3, 0.5, -0.5, -0.51, 2.5):
        m = np.array([[1, 0, tx], [0, 1, -tx]], np.float32)
        want = cv2.warpAffine(np.ones((40, 52), np.uint8), m, (52, 40),
                              flags=cv2.INTER_NEAREST + cv2.WARP_INVERSE_MAP)
        got = A._inside_nearest(*A.warp_coords(m, (40, 52)), (40, 52))
        np.testing.assert_array_equal(got, want.astype(bool))
    for n, sigma in ((3, 0), (5, 0), (9, 1.5), (3, 0.5)):
        want = cv2.getGaussianKernel(n, sigma, cv2.CV_32F).ravel()
        np.testing.assert_allclose(A.gaussian_kernel(n, sigma), want,
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("motion", list(WARPS))
def test_one_ecc_iteration_matches_cv2(motion):
    im1, im2 = S.motion_scene(np, 64, WARPS[motion])
    criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 1, -1)
    rho, want = cv2.findTransformECC(im1, im2, _identity(motion),
                                     MODES[motion], criteria, None, 5)
    got_rho, got = A.find_transform_ecc(im1, im2, _identity(motion), motion,
                                        niters=1, eps=-1)
    assert float(np.abs(got - want).max()) <= 1e-4
    assert abs(got_rho - rho) <= 1e-6


@pytest.mark.parametrize("motion", list(WARPS))
def test_ecc_flow_matches_wire_tpu(motion):
    im1, im2 = S.motion_scene(np, 64, WARPS[motion])
    got = Mo.ecc_flow(im1, im2, motion, niters=150)
    want = JMo.ecc_flow(im1, im2, motion, niters=150)
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    lin = np.abs(got[0][:2, :2] - want[0][:2, :2]).max()
    if motion == "homography":
        lin = max(lin, np.abs(got[0][2] - want[0][2]).max())
    assert float(lin) <= 1e-4
    assert float(np.abs(got[0][:2, 2] - want[0][:2, 2]).max()) <= 1e-3
    assert float(np.abs(got[1] - want[1]).max()) <= 1e-4
    assert float(np.abs(got[2] - want[2]).max()) <= 1e-6


def test_ecc_stops_at_eps_and_raises_where_cv2_does():
    im1, im2 = S.motion_scene(np, 48, WARPS["translation"])
    criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 500, 1e-4)
    _, want = cv2.findTransformECC(im1, im2, _identity("translation"),
                                   MODES["translation"], criteria, None, 5)
    _, got = A.find_transform_ecc(im1, im2, _identity("translation"),
                                  "translation", niters=500, eps=1e-4)
    assert float(np.abs(got - want).max()) <= 1e-3
    flat = np.zeros((32, 32), np.float32)
    with pytest.raises(cv2.error):
        JMo.ecc_flow(flat, flat, "translation", niters=5)
    with pytest.raises(RuntimeError):
        Mo.ecc_flow(flat, flat, "translation", niters=5)
    with pytest.raises(ValueError, match="motion"):
        A.find_transform_ecc(flat, flat, _identity("affine"), "rigid")


@pytest.mark.parametrize("side,warp,levels,iters", [
    (64, WARPS["translation"], 3, 3), (96, WARPS["euclidean"], 3, 3),
    (64, WARPS["affine"], 0, 1), (64, WARPS["affine"], 1, 2)])
def test_farneback_matches_cv2(side, warp, levels, iters):
    im1, im2 = S.motion_scene(np, side, warp)
    f1 = np.clip(im1 / im2.max() * 255, 0, 255).astype(np.uint8)
    f2 = np.clip(im2 / im2.max() * 255, 0, 255).astype(np.uint8)
    want = cv2.calcOpticalFlowFarneback(f1, f2, None, 0.5, levels, 15,
                                        iters, 5, 1.2, 0)
    got = A.farneback_flow(f1, f2, 0.5, levels, 15, iters, 5, 1.2)
    epe = np.sqrt(((got - want) ** 2).sum(-1))
    assert float(epe.mean()) <= 0.01 and float(epe.max()) <= 0.1


@pytest.mark.parametrize("side", [64, 96])
def test_optical_flow_matches_wire_tpu(side):
    im1, im2 = S.motion_scene(np, side, S.motion_warps(np)["euclidean"])
    flow, warped = Mo.optical_flow(im1, im2)
    want_flow, _ = JMo.optical_flow(im1, im2)
    epe = np.sqrt(((flow - want_flow) ** 2).sum(-1))
    assert flow.dtype == np.float32 and flow.shape == (side, side, 2)
    assert float(epe.mean()) <= 0.01 and float(epe.max()) <= 0.1
    Y, X = np.mgrid[:side, :side]
    along = cv2.remap(im2, (X + flow[..., 0]).astype(np.float32),
                      (Y + flow[..., 1]).astype(np.float32), cv2.INTER_LINEAR)
    assert float(np.abs(warped - along).max()) <= 1e-6


def test_prune_stack_matches_wire_tpu():
    im = JI.synthetic_image(96, 96, 3, seed=0).mean(-1)
    stack = np.stack([im[::2, ::2]] * 4).astype(np.float32)
    stack[2] += 0.3
    stack[3] = stack[3][:, ::-1]
    mats = np.stack([np.eye(2, 3)] * 4).astype(np.float32)
    mats[1, 0, 2] = 0.5
    mats[3, 1, 2] = -1.25
    imdiff = JMo.prune_stack(stack, mats, (96, 96))[3]
    # between the frames' scores, so that two are kept and two dropped
    thres = float(np.median((imdiff / (stack + 1e-2 * stack.max())).mean(
        (-1, -2))))
    got = Mo.prune_stack(stack, mats, (96, 96), thres=thres, device="cpu")
    want = JMo.prune_stack(stack, mats, (96, 96), thres=thres)
    assert got[2].sum() == 2
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert float(np.abs(got[3] - want[3]).max()) <= 1e-6


def test_smoke_motion_reference_is_cv2s():
    """The cv2 results the smoke's volume_motion phase holds the port to
    where cv2 is absent (tools/port_motion_reference.json) are what cv2
    gives on the smoke's pairs, and the port meets them here."""
    import importlib.util
    path = os.path.join(S.ROOT, "tools", "port_motion_reference.py")
    spec = importlib.util.spec_from_file_location("port_motion_ref", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(S.ROOT, S.MOTION_REFERENCE)) as f:
        committed = json.load(f)
    fresh = tool.reference()
    for motion in ("euclidean", "homography"):
        np.testing.assert_allclose(committed["ecc"][motion],
                                   fresh["ecc"][motion], rtol=0, atol=1e-6)
    np.testing.assert_allclose(committed["farneback_lattice"],
                               fresh["farneback_lattice"], rtol=0, atol=1e-6)
    out = S.motion_checks(np, Mo, committed)
    assert out["optical_flow"]["epe_mean_px"] <= S.FLOW_MEAN_EPE_PX
