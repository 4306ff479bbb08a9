"""The port's Radon operator and its kernels' plain versions against
wire_tpu on the CPU: rotate, the rotate-project operator (forward and
adjoint, vs the Pallas kernel in interpret mode and vs rotate_xla) with its
host-side angle split, the radial-line sampler (vs sample_lines_xla and JAX
autodiff of it), the fourier and shear methods (forward and image
gradient), the 'auto' routing and the loud error on angles that require
grad.

Tolerances: rotate-project and the sampler use the JAX package's own
(tests/test_pallas_rotsum.py, tests/test_pallas_lines.py); the FFT methods
hold the sinogram and the image gradient to 1e-5 x the largest entry: the
two libraries' float32 FFTs of a 128^2 (fourier) or 64^2 (shear) plane
round differently (measured ~3e-7 x max)."""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.ops import resample as JRS
from wire_tpu.ops.pallas import line_sample as JLS
from wire_tpu.ops.pallas import rotsum as JROT

from wire_tpu_torch.operators import radon as TR
from wire_tpu_torch.ops import line_sample as LS
from wire_tpu_torch.ops import resample as RS
from wire_tpu_torch.ops import rotsum as R

JR = importlib.import_module("wire_tpu.operators.radon")

ANGLES = np.array([0.0, 7.3, 44.9, 45.1, 90.0, 121.7, 180.0, -13.4],
                  np.float32)


def _img(S, seed, W=None):
    return np.random.RandomState(seed).rand(S, W or S).astype(np.float32)


@pytest.mark.parametrize("angle", [0.0, 13.0, -37.5, 90.0, 181.0])
@pytest.mark.parametrize("shape", [(24, 24), (20, 28), (16, 16, 3)])
def test_rotate_matches_wire_tpu(angle, shape):
    img = np.random.RandomState(1).rand(*shape).astype(np.float32)
    want = np.asarray(JRS.rotate(jnp.asarray(img), angle))
    got = RS.rotate(torch.tensor(img), angle).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [32, 64])
def test_rotate_project_forward(S):
    img = _img(S, 0)
    got = R.rotate_project(torch.tensor(img), ANGLES).numpy()
    interp = np.asarray(JROT.rotate_project(jnp.asarray(img), ANGLES,
                                            interpret=True))
    xla = np.asarray(JR.radon(jnp.asarray(img), jnp.asarray(ANGLES),
                              method="rotate_xla"))
    for want in (interp, xla):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * S)


@pytest.mark.parametrize("S", [32, 64])
def test_rotate_project_adjoint(S):
    img = _img(S, 2)
    cot = np.random.RandomState(3).rand(len(ANGLES), S).astype(np.float32)
    x = torch.tensor(img, requires_grad=True)
    (got,) = torch.autograd.grad(R.rotate_project(x, ANGLES), x,
                                 torch.tensor(cot))
    _, vjp_k = jax.vjp(lambda im: JROT.rotate_project(im, ANGLES, True),
                       jnp.asarray(img))
    _, vjp_x = jax.vjp(lambda im: JR.radon(im, jnp.asarray(ANGLES),
                                           method="rotate_xla"),
                       jnp.asarray(img))
    for vjp in (vjp_k, vjp_x):
        want = np.asarray(vjp(jnp.asarray(cot))[0])
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


def test_angle_split_and_planes_match_wire_tpu():
    """The kernels' angle split and their rot90 index map (applied in the
    kernels, never built as planes) against wire_tpu's host-side split,
    planes and fold: gathering through plane_index gives its planes, and
    adding back through the same map gives its fold."""
    angles = np.array([0.0, 44.9, 45.0, 45.1, 90.0, 135.0, 200.0, -13.4,
                       315.0, 359.0], np.float32)
    for got, want in zip(R.angle_parts(angles), JROT._angle_parts(angles)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-7)
    parts = R.angle_parts_tensor(angles, True, "cpu").numpy()
    for got, want in zip(parts, R.angle_parts(angles)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    img = _img(16, 4)
    index = [R.plane_index(16, k) for k in range(4)]
    planes = np.stack([img[r.numpy(), c.numpy()] for r, c in index])
    want = np.asarray(JROT._variant_planes(jnp.asarray(img), 16))
    np.testing.assert_array_equal(planes, want)
    stack = np.random.RandomState(5).rand(4, 16, 16).astype(np.float32)
    fold = torch.zeros(16, 16)
    for (r, c), plane in zip(index, torch.tensor(stack)):
        fold.index_put_((r, c), plane, accumulate=True)
    np.testing.assert_allclose(
        fold.numpy(),
        np.asarray(JROT._fold_variants(jnp.asarray(stack), 16)), rtol=1e-6)


def test_rotate_project_refuses_angles_that_require_grad():
    img = torch.tensor(_img(32, 4))
    angles = torch.tensor([10.0, 40.0], requires_grad=True)
    with pytest.raises(ValueError, match="rotate_xla"):
        R.rotate_project(img, angles)
    # concrete angles work and differentiate in the image ...
    x = img.clone().requires_grad_(True)
    R.rotate_project(x, angles.detach()).sum().backward()
    assert torch.isfinite(x.grad).all()
    # ... and the plain gather path differentiates through the angles
    TR.radon(img, angles, method="rotate_xla").sum().backward()
    assert angles.grad.abs().max() > 0


@pytest.mark.parametrize("H,W", [(16, 12), (12, 20)])
def test_rotate_project_plain_on_a_non_square_image_matches_wire_tpu(H, W):
    """The plain rotate-project (the CUDA kernel's reference on the card)
    on a non-square image against wire_tpu's rotate path: forward and the
    adjoint's image gradient.  'rotate' on the CPU is this same plain
    path, and on the card the kernel takes any H x W image."""
    img = _img(H, 7, W=W)
    cot = np.random.RandomState(8).randn(len(ANGLES), W).astype(np.float32)
    jsino, jvjp = jax.vjp(
        lambda x: JR.radon(x, jnp.asarray(ANGLES), method="rotate_xla"),
        jnp.asarray(img))
    (jgrad,) = jvjp(jnp.asarray(cot))
    x = torch.tensor(img, requires_grad=True)
    sino = R.rotate_project(x, ANGLES)
    (grad,) = torch.autograd.grad(sino, x, torch.tensor(cot))
    assert sino.shape == (len(ANGLES), W)
    np.testing.assert_allclose(sino.detach().numpy(), np.asarray(jsino),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)
    got = TR.radon(torch.tensor(img), ANGLES, method="rotate").numpy()
    np.testing.assert_array_equal(got, sino.detach().numpy())
    # the kernel's host-side angle parts of a non-square image: the whole
    # angle, as rotate computes its cos and sin
    cphi, sphi, k = R.whole_angle_parts(ANGLES)
    t = torch.tensor(ANGLES) * (np.pi / 180.0)
    assert np.array_equal(cphi, torch.cos(t).numpy()) and not k.any()
    assert np.array_equal(sphi, torch.sin(t).numpy())


def _line_positions(P, A, K):
    th = np.deg2rad(np.linspace(0, 180, A, endpoint=False))
    k = np.arange(K, dtype=np.float32)
    gy = (k[None, :] * np.sin(th)[:, None] + P // 2).astype(np.float32)
    gx = (k[None, :] * np.cos(th)[:, None] + P // 2).astype(np.float32)
    return gy, gx


def test_sample_lines_matches_xla_sampler_and_its_adjoint():
    rng = np.random.RandomState(3)
    P, A = 64, 9
    K = P // 2 + 1
    fre, fim = (rng.randn(P + 2, P + 2).astype(np.float32) for _ in range(2))
    gy, gx = _line_positions(P, A, K)
    cot = [rng.randn(A, K).astype(np.float32) for _ in range(2)]
    a = torch.tensor(fre, requires_grad=True)
    b = torch.tensor(fim, requires_grad=True)
    got = LS.sample_lines_plain(a, b, torch.tensor(gy), torch.tensor(gx))
    want, vjp = jax.vjp(
        lambda p, q: JLS.sample_lines_xla(p, q, jnp.asarray(gy),
                                          jnp.asarray(gx)),
        jnp.asarray(fre), jnp.asarray(fim))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5)
    gbar = torch.autograd.grad(got, (a, b), [torch.tensor(c) for c in cot])
    for g, w in zip(gbar, vjp(tuple(jnp.asarray(c) for c in cot))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_sample_lines_reads_the_nyquist_halo():
    """A sample on the Nyquist line (position P) reads the halo lines."""
    P = 8
    f = np.arange((P + 2) ** 2, dtype=np.float32).reshape(P + 2, P + 2)
    gy = np.array([[P, 4.0]], np.float32)
    gx = np.array([[4.5, P]], np.float32)
    got = LS.sample_lines_plain(torch.tensor(f), torch.tensor(f),
                                torch.tensor(gy), torch.tensor(gx))[0].numpy()
    np.testing.assert_allclose(got, [[f[P, 4] * 0.5 + f[P, 5] * 0.5,
                                      f[4, P]]])


def _fft_method_case(method, S=32, W=None):
    img = _img(S, 7, W)
    angles = np.linspace(0, 180, 12, dtype=np.float32)
    cot = np.random.RandomState(8).randn(len(angles), img.shape[1]).astype(
        np.float32)
    if method == "fourier":
        jfn = lambda im: JR._radon_fourier(im, jnp.asarray(angles),  # noqa
                                           sampler="xla")
    else:
        jfn = lambda im: JR._radon_shear(im, jnp.asarray(angles))  # noqa
    want, vjp = jax.vjp(jfn, jnp.asarray(img))
    x = torch.tensor(img, requires_grad=True)
    got = TR.radon(x, angles, method=method)
    (gimg,) = torch.autograd.grad(got, x, torch.tensor(cot))
    return (got.detach().numpy(), np.asarray(want), gimg.numpy(),
            np.asarray(vjp(jnp.asarray(cot))[0]))


@pytest.mark.parametrize("method", ["fourier", "shear"])
@pytest.mark.parametrize("W", [None, 24])
def test_fft_methods_match_wire_tpu(method, W):
    got, want, gimg, gwant = _fft_method_case(method, W=W)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(gimg, gwant, rtol=0,
                               atol=1e-5 * np.abs(gwant).max())


def test_fft_size_matches_wire_tpu():
    for m in list(range(1, 200)) + [1024, 1029, 4 * 96, 1.6 * 256 + 2]:
        assert TR._fft_size(m) == JR._fft_size(m), m


@pytest.mark.parametrize("n_angles,device,compat,want", [
    (100, "cpu", False, "rotate"), (100, "cuda", False, "fourier"),
    (23, "cuda", False, "shear"), (24, "cuda", False, "fourier"),
    (100, "cuda", True, "rotate"), (5, "cpu", True, "rotate")])
def test_resolve_auto(n_angles, device, compat, want):
    assert TR._resolve_auto("auto", n_angles, device, compat) == want
    jax_backend = "tpu" if device == "cuda" else device
    assert JR._resolve_auto("auto", n_angles, jax_backend, compat) == want
    assert TR._resolve_auto("shear", n_angles, device, compat) == "shear"


def test_radon_op_and_batch():
    imgs = np.stack([_img(16, 9), _img(16, 10)])
    angles = np.linspace(0, 180, 5, dtype=np.float32)
    op = TR.RadonOp(angles)
    got = TR.radon_batch(torch.tensor(imgs), angles)
    assert got.shape == (2, 5, 16)
    np.testing.assert_allclose(got[1].numpy(),
                               op(torch.tensor(imgs[1])).numpy())
    want = np.asarray(JR.radon_batch(jnp.asarray(imgs), jnp.asarray(angles),
                                     method="rotate_xla"))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * 16)
