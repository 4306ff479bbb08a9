"""The port's multi-frame SR data path (wire_tpu_torch/signals/motion.py,
native/registration.cpp, ops/resample.py:grid_sample,
operators/forward.py:multi_sr_op) against wire_tpu's, on the CPU.

wire_tpu's motion module takes its cv2 branches where cv2 is installed; the
port has no cv2, so every comparison sets ``wire_tpu.signals.motion.cv2``
to None (a test-side monkeypatch) and holds the port to wire_tpu's numpy,
scipy and native branches.  Tolerances: the bursts, the downsample, the
affine toolbox, the registration (both run the same C++ built with the
same g++ flags on the same inputs, and the same scipy resizes) and the
frame datasets are equal bit for bit; grid_sample and interp_lr, float32
lerps in torch against jnp, within 1e-6 absolute (values in [0, 1])."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from wire_tpu.native import rigid_register as j_rigid_register
from wire_tpu.operators import forward as JF
from wire_tpu.ops import resample as JR
from wire_tpu.signals import image as JI
from wire_tpu.signals import motion as JMo

from wire_tpu_torch.native import rigid_register
from wire_tpu_torch.operators import forward as TF
from wire_tpu_torch.ops import resample as TR
from wire_tpu_torch.signals import image as TI
from wire_tpu_torch.signals import motion as Mo


@pytest.fixture(autouse=True)
def no_cv2(monkeypatch):
    monkeypatch.setattr(JMo, "cv2", None)


def _burst(size=96, scale=2, nframes=3, seed=0):
    im = JI.synthetic_image(size, size, 3, seed=seed)
    return im, [m.make_burst(im, shift_max=5 * scale, theta_max=np.pi / 10,
                             nframes=nframes,
                             rng=np.random.RandomState(seed))
                for m in (Mo, JMo)]


def test_synthetic_image_is_wire_tpus():
    np.testing.assert_array_equal(TI.synthetic_image(40, 36, 3, seed=2),
                                  JI.synthetic_image(40, 36, 3, seed=2))


def test_make_burst_and_downsample_equal_wire_tpu():
    _, (got, want) = _burst()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3][0], np.eye(2, 3))
    np.testing.assert_array_equal(Mo.downsample_burst(got[0], 2),
                                  JMo.downsample_burst(want[0], 2))
    np.testing.assert_array_equal(Mo.downsample_burst(got[0][:, :95], 3),
                                  JMo.downsample_burst(want[0][:, :95], 3))


def test_rigid_register_equals_wire_tpus_bit_for_bit():
    rng = np.random.default_rng(1)
    im = JI.synthetic_image(64, 64, 1, seed=3)[..., 0]
    Y, X = np.mgrid[:64, :64].astype(np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    mov = Mo._remap(im[..., None], (c * X - s * Y + 1.5).astype(np.float32),
                    (s * X + c * Y - 0.75).astype(np.float32))[..., 0]
    mov = mov + 0.01 * rng.standard_normal(mov.shape).astype(np.float32)
    init = np.array([[1, 0, 1], [0, 1, -1]], np.float32)
    for kw in (dict(), dict(max_iters=7, eps=1e-3),
               dict(max_iters=200, eps=1e-8, init_warp=init)):
        got = rigid_register(im, mov, **kw)
        # wire_tpu refines a float32 start in place: give it a copy
        want = j_rigid_register(im, mov, **{
            k: v.copy() if isinstance(v, np.ndarray) else v
            for k, v in kw.items()})
        assert got.dtype == np.float32 and got.shape == (2, 3)
        np.testing.assert_array_equal(got, want)
    # the caller's start is left as it was
    np.testing.assert_array_equal(init, [[1, 0, 1], [0, 1, -1]])
    with pytest.raises(RuntimeError, match="singular"):
        rigid_register(np.zeros((16, 16)), np.zeros((16, 16)))
    with pytest.raises(ValueError, match="one shape"):
        rigid_register(np.zeros((16, 16)), np.zeros((16, 17)))


def test_pyramid_register_equals_wire_tpus():
    _, (got, _) = _burst(size=96, nframes=3, seed=4)
    ref, mov = got[0][0].mean(-1), got[0][2].mean(-1)
    w_got, ok_got = Mo.pyramid_register(ref, mov)
    w_want, ok_want = JMo.pyramid_register(ref, mov)
    assert ok_got == ok_want
    np.testing.assert_array_equal(w_got, w_want)
    np.testing.assert_array_equal(Mo._coarse_init(ref[::2, ::2],
                                                  mov[::2, ::2]),
                                  JMo._coarse_init(ref[::2, ::2],
                                                   mov[::2, ::2]))


def test_register_burst_equals_wire_tpus_and_finds_the_motion():
    """The estimated warps of a x2 burst (96^2 HR, three frames) equal
    wire_tpu's, and invert the burst's motions within 1.5 px and 0.02
    rad."""
    _, (got, _) = _burst(size=96, nframes=3, seed=0)
    lr = Mo.downsample_burst(got[0], 2)
    out = Mo.register_burst(lr, (96, 96))
    want = JMo.register_burst(lr, (96, 96))
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w)
    inv = Mo.invert_regstack(got[3])
    assert out[2].tolist() == [1.0, 1.0, 1.0]
    assert np.abs(out[3][:, :, 2] - inv[:, :, 2]).max() < 1.5
    assert np.abs(out[3][:, :2, :2] - inv[:, :2, :2]).max() < 0.02
    gray = lr.mean(-1)
    for g, w in zip(Mo.register_burst(gray, (96, 96)),
                    JMo.register_burst(gray, (96, 96))):
        np.testing.assert_array_equal(g, w)


def test_get_sr_data_equals_wire_tpus():
    im = JI.synthetic_image(96, 96, 3, seed=5)
    for kw in (dict(get_gt=True), dict(get_gt=False)):
        got = Mo.get_sr_data(im, 2, nimg=3, rng=np.random.RandomState(2),
                             **kw)
        want = JMo.get_sr_data(im, 2, nimg=3, rng=np.random.RandomState(2),
                               **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_affine_toolbox_equals_wire_tpus():
    _, (got, _) = _burst(size=24, nframes=4, seed=6)
    mats = got[3]
    np.testing.assert_array_equal(Mo.invert_regstack(mats),
                                  JMo.invert_regstack(mats))
    for g, w in zip(Mo.mat2coords(mats, (24, 20), (24, 20)),
                    JMo.mat2coords(mats, (24, 20), (24, 20))):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(Mo.xy_mgrid(5, 7), JMo.xy_mgrid(5, 7))
    m32 = mats.astype(np.float32)
    theta = Mo.param2theta(m32, 20, 24)
    np.testing.assert_array_equal(theta, JMo.param2theta(m32, 20, 24))
    for g, w in zip(Mo.affine2rigid(mats), JMo.affine2rigid(mats)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(Mo.get_transformed_coords(theta, (6, 5)),
                                  JMo.get_transformed_coords(theta, (6, 5)))
    np.testing.assert_array_equal(Mo.euclidean_matrix(0.3, (2, -1)),
                                  JMo.euclidean_matrix(0.3, (2, -1)))


def test_frame_dataset_equals_wire_tpus():
    _, (got, _) = _burst(size=32, nframes=3, seed=7)
    lr = Mo.downsample_burst(got[0], 2)
    masks = 1.0 - np.float32(lr == 0)
    for m in (None, masks):
        a = Mo.FrameDataset.build(lr, got[1], got[2], m)
        b = JMo.FrameDataset.build(lr, got[1], got[2], m)
        for f in ("coords", "pixels", "masks"):
            assert getattr(a, f).dtype == np.float32
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.coords.shape == (3, 32 * 32, 2)
    assert a.pixels.shape == (3, 16 * 16, 3)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("channels", [0, 3])
def test_grid_sample_matches_wire_tpu(align_corners, channels):
    rng = np.random.default_rng(8)
    shape = (13, 17, channels) if channels else (13, 17)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (5, 9, 2)).astype(np.float32)
    got = TR.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                         align_corners=align_corners).numpy()
    want = np.asarray(JR.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                     align_corners=align_corners))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if channels and not align_corners:
        # torch's own grid_sample is the function wire_tpu writes out
        ref = torch.nn.functional.grid_sample(
            torch.from_numpy(img).permute(2, 0, 1)[None],
            torch.from_numpy(grid)[None], mode="bilinear",
            padding_mode="zeros", align_corners=False)[0].permute(1, 2, 0)
        np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-6)


def test_interp_lr_matches_wire_tpu_and_is_differentiable():
    rng = np.random.default_rng(9)
    imref = rng.uniform(0, 1, (16, 12, 3)).astype(np.float32)
    theta = Mo.param2theta(np.stack([
        Mo.euclidean_matrix(t, s).astype(np.float32)
        for t, s in ((0.0, (0, 0)), (0.1, (1.5, -2)))]), 12, 16)
    coords = Mo.get_transformed_coords(theta, (16, 12))
    got = Mo.interp_lr(imref, coords, 4)
    want = np.asarray(JMo.interp_lr(imref, coords, 4))
    assert tuple(got.shape) == want.shape == (2, 4, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    im_t = torch.from_numpy(imref).requires_grad_(True)
    Mo.interp_lr(im_t, coords, 4).sum().backward()
    assert im_t.grad is not None and torch.isfinite(im_t.grad).all()


def test_multi_sr_op_matches_wire_tpu():
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, (3, 8, 12, 3)).astype(np.float32)
    got = TF.multi_sr_op(torch.from_numpy(x), 4).numpy()
    want = np.asarray(JF.multi_sr_op(jnp.asarray(x), 4))
    assert got.shape == (3, 2, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
