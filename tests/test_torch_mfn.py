"""The port's Gabor MFN (wire_tpu_torch/ops/mfn.py: the plain versions
``mfn_step_plain`` and ``mfn_mlp_plain``, which ``mfn_step`` and ``mfn_mlp``
run for CPU tensors; nn/models.py: the family; nn/init.py: its Gamma
sampler) against wire_tpu's Pallas kernels ``mfn_step_fused`` and
``mfn_mlp_fused`` in interpret mode and against autodiff of wire_tpu's
plain ``mfn_apply``, from the same numpy-seeded or bridged parameters and
inputs; and short fit_pointwise (denoise) and fit_operator (SISR) MFN fits
against wire_tpu's from one bridged init.

Tolerances are tests/test_pallas_mfn.py's: the step's prediction and
gradients rtol 2e-4 / atol 1e-5, the pair's gradients and dcoords rtol
2e-4 / atol 1e-6 (fp32 sums over up to 1,100 rows in another order; the
filter phase q reaches the hundreds at init, where one rounding step is
~3e-5, and the JAX kernel's fast_sincos polynomial and torch's sin agree
to f32 rounding there); the extreme-phase case rtol 2e-4 / atol 2e-4 as
in wire_tpu's own test at |q| ~ 8,000.  The fits hold their histories to
rel 1e-4 and the parameters to rel 1e-4 with atol 1% of one Adam step
(tests/test_torch_trainer.py's bounds; m / sqrt(v) turns last-digit
gradient differences of entries near zero into step differences)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.nn.models import mfn_apply as jmfn_apply
from wire_tpu.operators import forward as JF
from wire_tpu.ops.pallas.mfn_step import mfn_mlp_fused, mfn_step_fused
from wire_tpu.signals import image as JI
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge, tree
from wire_tpu_torch.nn import init as winit
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.operators import forward as TF
from wire_tpu_torch.ops import mfn as MF
from wire_tpu_torch.signals import coords as C, image as I
from wire_tpu_torch.train import trainer as T

STEP = dict(rtol=2e-4, atol=1e-5)
PAIR = dict(rtol=2e-4, atol=1e-6)
REL = 1e-4


def _models(d, hf, layers, o):
    kw = dict(in_features=d, out_features=o, hidden_features=hf,
              hidden_layers=layers)
    jm = get_inr("mfn", **kw)
    return jm, tget_inr("mfn", **kw)


def _jax_params(jm, seed):
    """A wire_tpu init as numpy arrays (jax.random's Gamma, not the
    port's: both sides then read the same numbers)."""
    return jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))


def _inputs(n, d, o, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, d)).astype(np.float32),
            rng.uniform(0, 1, (n, o)).astype(np.float32),
            rng.uniform(0, 1, (n, o)).astype(np.float32),
            rng.normal(size=(n, o)).astype(np.float32))


def _interp_spec(jm):
    return dataclasses.replace(jm.spec, gemm_precision="highest")


def _leaves_np(t):
    return [(p, np.asarray(v.detach().numpy() if torch.is_tensor(v) else v))
            for p, v in tree.leaves(t)]


def _assert_trees(got, want, tol, what):
    g, w = _leaves_np(got), _leaves_np(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, err_msg=f"{what} {p}", **tol)


CASES = [(600, 2, 1, 3), (1100, 3, 3, 1), (600, 3, 1, 1), (1100, 2, 3, 3)]


@pytest.mark.parametrize("n,d,layers,o", CASES)
def test_mfn_step_plain_matches_pallas_interpret(n, d, layers, o):
    jm, tm = _models(d, 64, layers, o)
    p = _jax_params(jm, n + d)
    coords, target, _, _ = _inputs(n, d, o, 1)
    want = mfn_step_fused(jax.tree.map(jnp.asarray, p), jnp.asarray(coords),
                          jnp.asarray(target), _interp_spec(jm),
                          interpret=True)
    got = MF.mfn_step(bridge.params_from_jax(p), torch.tensor(coords),
                      torch.tensor(target), tm.spec)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **STEP)
    _assert_trees(got[1], want[1], STEP, "step")


def _torch_vjp(fn, params, coords, g):
    flat = tree.leaves(bridge.params_from_jax(params))
    paths = [p for p, _ in flat]
    leaves = [t.requires_grad_(True) for _, t in flat]
    x = torch.tensor(coords, requires_grad=True)
    y = fn(tree.unflatten(paths, leaves), x)
    grads = torch.autograd.grad(y, leaves + [x], torch.tensor(g))
    return (y.detach().numpy(), tree.unflatten(paths, grads[:-1]),
            grads[-1].numpy())


def _jax_vjp(fn, params, coords, g):
    y, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params),
                     jnp.asarray(coords))
    dp, dx = vjp(jnp.asarray(g))
    return np.asarray(y), dp, np.asarray(dx)


@pytest.mark.parametrize("n,d,layers,o", CASES)
def test_mfn_mlp_plain_matches_pallas_interpret_and_autodiff(n, d, layers,
                                                             o):
    jm, tm = _models(d, 64, layers, o)
    p = _jax_params(jm, 2 * n + d)
    coords, _, _, g = _inputs(n, d, o, 2)
    got = _torch_vjp(lambda q, x: MF.mfn_mlp(q, x, tm.spec), p, coords, g)
    spec = _interp_spec(jm)
    never = jm.spec.replace(fused="never")
    for what, fn in (
            ("interpret", lambda q, x: mfn_mlp_fused(q, x, spec, True)),
            ("autodiff", lambda q, x: jmfn_apply(q, x, never))):
        want = _jax_vjp(fn, p, coords, g)
        np.testing.assert_allclose(got[0], want[0], err_msg=what, **STEP)
        _assert_trees(got[1], want[1], PAIR, what)
        np.testing.assert_allclose(got[2], want[2], err_msg=f"{what} dx",
                                   **PAIR)


def test_mfn_step_masks_tail_sentinels_and_sums_metrics():
    """Rows past nvalid add nothing (their targets are 1e6), an explicit
    denom is honoured, and the masked SSE sums against target and gt match
    the interpret kernel's and the prediction's."""
    jm, tm = _models(2, 64, 2, 3)
    p = _jax_params(jm, 5)
    n, nvalid, denom = 700, 650, 650 * 3.0 + 7.0
    coords, target, gt, _ = _inputs(n, 2, 3, 6)
    sentinel = target.copy()
    sentinel[nvalid:] = 1e6
    got = MF.mfn_step(bridge.params_from_jax(p), torch.tensor(coords),
                      torch.tensor(sentinel), tm.spec, nvalid=nvalid,
                      denom=denom, gt=torch.tensor(gt), want_metrics=True)
    want = mfn_step_fused(jax.tree.map(jnp.asarray, p), jnp.asarray(coords),
                          jnp.asarray(sentinel), _interp_spec(jm),
                          nvalid=nvalid, denom=denom, gt=jnp.asarray(gt),
                          want_metrics=True, interpret=True)
    clean = MF.mfn_step(bridge.params_from_jax(p), torch.tensor(coords),
                        torch.tensor(target), tm.spec, nvalid=nvalid,
                        denom=denom)
    _assert_trees(got[1], want[1], STEP, "tail")
    _assert_trees(got[1], clean[1], dict(rtol=0, atol=0), "sentinel")
    np.testing.assert_allclose([float(s) for s in got[2]],
                               [float(s) for s in want[2]], rtol=2e-4)
    pred = got[0].numpy()[:nvalid]
    np.testing.assert_allclose(
        float(got[2][0]), np.sum((pred - sentinel[:nvalid]) ** 2), rtol=1e-5)
    np.testing.assert_allclose(
        float(got[2][1]), np.sum((pred - gt[:nvalid]) ** 2), rtol=1e-5)


def test_mfn_at_extreme_phase_matches_wire_tpu():
    """tests/test_pallas_mfn.py::test_fused_accuracy_at_extreme_phase: every
    filter's w scaled until max |x w| ~ 8,000."""
    jm, tm = _models(2, 64, 2, 3)
    p = _jax_params(jm, 7)
    coords = np.random.default_rng(7).uniform(-1, 1, (512, 2)).astype(
        np.float32)
    qmax = 0.0
    for k in p:
        if k.startswith("gabor_"):
            w = p[k]["w"]
            p[k]["w"] = (w * (8000.0 / np.abs(coords @ w).max())).astype(
                np.float32)
            qmax = max(qmax, float(np.abs(coords @ p[k]["w"]).max()))
    assert qmax > 7e3
    got = MF.mfn_mlp(bridge.params_from_jax(p), torch.tensor(coords),
                     tm.spec).numpy()
    jp = jax.tree.map(jnp.asarray, p)
    for want in (jmfn_apply(jp, jnp.asarray(coords),
                            jm.spec.replace(fused="never")),
                 mfn_mlp_fused(jp, jnp.asarray(coords), _interp_spec(jm),
                               True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_mfn_mlp_restores_leading_axes():
    jm, tm = _models(2, 64, 2, 3)
    p = _jax_params(jm, 8)
    coords = np.random.default_rng(8).uniform(-1, 1, (4, 50, 2)).astype(
        np.float32)
    got = MF.mfn_mlp(bridge.params_from_jax(p), torch.tensor(coords),
                     tm.spec)
    assert got.shape == (4, 50, 3)
    want = mfn_mlp_fused(jax.tree.map(jnp.asarray, p), jnp.asarray(coords),
                         _interp_spec(jm), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
    flat = MF.mfn_mlp(bridge.params_from_jax(p),
                      torch.tensor(coords.reshape(200, 2)), tm.spec)
    assert torch.equal(got.reshape(200, 3), flat)


@pytest.mark.parametrize("alpha", [6.0 / 3, 6.0 / 12, 6.0])
def test_gamma_sampler_moments(alpha):
    """10^5 draws: the mean within 5 standard errors of alpha (se =
    sqrt(alpha / N)) and the variance within 5 standard errors of alpha
    (se of a sample variance ~ alpha sqrt((2 + 6 / alpha) / N), the Gamma
    law's excess kurtosis being 6 / alpha); alpha = 1/2 takes the
    alpha < 1 boost.  With beta = 2 the law scales by 1 / beta."""
    N = 100_000
    x = winit.gamma(torch.Generator().manual_seed(0), alpha, (N,)).double()
    assert bool((x > 0).all())
    assert abs(float(x.mean()) - alpha) < 5 * np.sqrt(alpha / N)
    assert abs(float(x.var()) - alpha) < 5 * alpha * np.sqrt(
        (2 + 6 / alpha) / N)
    a = winit.gamma(torch.Generator().manual_seed(1), alpha, (3, 7))
    b = winit.gamma(torch.Generator().manual_seed(1), alpha, (3, 7))
    assert a.shape == (3, 7) and a.dtype == torch.float32
    assert torch.equal(a, b)
    f = winit.mfn_gabor_params(torch.Generator().manual_seed(2), 2, N,
                               alpha, beta=2.0)
    assert abs(float(f["gamma"].double().mean()) - alpha / 2) < 5 * np.sqrt(
        alpha / N) / 2


def test_mfn_init_shapes_bounds_and_num_params():
    d, h, layers, o = 3, 48, 2, 2
    jm, tm = _models(d, h, layers, o)
    p = tm.init(torch.Generator().manual_seed(0))
    jp = jm.init(jax.random.key(0))
    assert [pp for pp, _ in tree.leaves(p)] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    for path, t in tree.leaves(p):
        want = np.asarray(jp[path[0]][path[1]])
        assert tuple(t.shape) == want.shape, path
    assert tm.num_params(p) == jm.num_params(jp)
    for j in range(layers + 1):
        f = p[f"gabor_{j}"]
        assert float(f["mu"].abs().max()) <= 1.0
        assert float(f["b"].abs().max()) <= np.pi
        assert bool((f["gamma"] > 0).all())
        bound = 128.0 * torch.sqrt(f["gamma"])[None, :] / np.sqrt(d)
        assert bool((f["w"].abs() <= bound * (1 + 1e-6)).all())
    for j in range(layers):
        assert float(p[f"linear_{j}"]["w"].abs().max()) <= 1 / np.sqrt(h)
        assert float(p[f"linear_{j}"]["b"].abs().max()) <= 1 / np.sqrt(h)
    assert float(p["final"]["w"].abs().max()) <= 1 / np.sqrt(h)
    q = tm.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree.leaves(p), tree.leaves(q)))


def test_bridge_round_trip_of_mfn_params():
    jm, _ = _models(2, 32, 2, 3)
    p = _jax_params(jm, 9)
    tp = bridge.params_from_jax(p)
    assert sorted(tp) == sorted(p)
    back = bridge.params_to_numpy(tp)
    for (pa, a), (pb, b) in zip(tree.leaves(back), tree.leaves(p)):
        assert pa == pb and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_step_grads_auto_and_never_agree_on_the_cpu():
    jm, tm = _models(2, 40, 1, 3)
    never = tget_inr("mfn", in_features=2, out_features=3,
                     hidden_features=40, hidden_layers=1, fused="never")
    p = tm.init(torch.Generator().manual_seed(3))
    coords, target, gt, _ = _inputs(90, 2, 3, 3)
    a = tm.step_grads(p, torch.tensor(coords), torch.tensor(target),
                      gt=torch.tensor(gt), want_metrics=True)
    b = never.step_grads(p, torch.tensor(coords), torch.tensor(target),
                         gt=torch.tensor(gt), want_metrics=True)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    _assert_trees(a[1], b[1], dict(rtol=0, atol=0), "never")


@pytest.mark.parametrize("outermost_linear", [True, False])
@pytest.mark.parametrize("fused", ["auto", "never"])
def test_mfn_dispatch_takes_the_wrappers_unless_never(monkeypatch, fused,
                                                      outermost_linear):
    """apply and step_grads reach ops/mfn.py's mfn_mlp and mfn_step (the
    kernels on a card) unless fused == 'never'; outermost_linear does not
    gate them, since an MFN always ends in a plain linear."""
    calls = []
    for name in ("mfn_mlp", "mfn_step"):
        real = getattr(MF, name)
        monkeypatch.setattr(MF, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    tm = tget_inr("mfn", in_features=2, out_features=3, hidden_features=16,
                  hidden_layers=1, fused=fused,
                  outermost_linear=outermost_linear)
    p = tm.init(torch.Generator().manual_seed(1))
    coords, target, _, _ = _inputs(40, 2, 3, 1)
    tm.apply(p, torch.tensor(coords))
    tm.step_grads(p, torch.tensor(coords), torch.tensor(target))
    assert calls == ([] if fused == "never" else ["mfn_mlp", "mfn_step"])


def test_mfn_wrappers_refuse_other_devices():
    _, tm = _models(2, 16, 1, 3)
    p = tm.init(torch.Generator().manual_seed(0))
    x = torch.zeros((8, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        MF.mfn_mlp(p, x, tm.spec)
    with pytest.raises(ValueError, match="unsupported device"):
        MF.mfn_step(p, x, torch.zeros((8, 3), device="meta"), tm.spec)


def test_mfn_flop_counts():
    n = 65536
    assert MF.step_flops(n, 2, 300, 3, 3) == (
        2 * 3 * 2 * n * 300 * 300 + 6 * n * 300 * 3 + 3 * 16 * n * 300)
    assert abs(MF.step_flops(n, 2, 300, 3, 3) / 1e9 - 72.07) < 0.01
    assert abs(MF.apply_flops(n, 2, 256, 3, 3) / 1e9 - 53.05) < 0.01


def _problem(H, W, seed):
    rng = np.random.default_rng(seed)
    im = JI.natural_image(H, W, 3, seed=seed)
    noisy = (im + 0.1 * rng.normal(size=im.shape)).astype(np.float32)
    return im, noisy


def _check_fit(got, want, lr):
    np.testing.assert_allclose(got.mse_gt, want.mse_gt, rtol=REL)
    np.testing.assert_allclose(got.mse_noisy, want.mse_noisy, rtol=REL)
    np.testing.assert_allclose(got.best_mse, want.best_mse, rtol=REL)
    np.testing.assert_allclose(got.best_rec, np.asarray(want.best_rec),
                               rtol=REL, atol=1e-5)
    gp = bridge.params_to_numpy(got.best_params)
    for path, a in tree.leaves(gp):
        b = np.asarray(tree.get(want.best_params, path))
        np.testing.assert_allclose(a, b, rtol=REL, atol=0.01 * lr,
                                   err_msg=str(path))


def test_mfn_denoise_fit_matches_wire_tpu():
    """Five full-batch fit_pointwise epochs (the sweep's lr 5e-2, scaled by
    batch) on a 24^2 image from one bridged init."""
    H = W = 24
    im, noisy = _problem(H, W, 0)
    kw = dict(in_features=2, out_features=3, hidden_features=48,
              hidden_layers=2)
    tm = tget_inr("mfn", **kw)
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tp))
    lr = 5e-2
    want = JT.fit_pointwise(
        get_inr("mfn", fused="never", **kw), jp, C.grid2d(H, W),
        noisy.reshape(-1, 3),
        JT.FitConfig(learning_rate=lr, niters=5, maxpoints=H * W,
                     scale_lr_by_batch=True),
        gt=im.reshape(-1, 3), track="gt", donate=False)
    got = T.fit_pointwise(
        tm, tp, C.grid2d(H, W), noisy.reshape(-1, 3),
        T.FitConfig(learning_rate=lr, niters=5, maxpoints=H * W,
                    scale_lr_by_batch=True),
        gt=im.reshape(-1, 3), device="cpu")
    _check_fit(got, want, lr)


def test_mfn_sisr_fit_matches_wire_tpu():
    """Five fit_operator iterations through the x4 box downsample (a 32^2
    HR field, 8^2 LR; lr 5e-2 decaying to 0.2x) from one bridged init."""
    src = JI.natural_image(96, 96, 3, seed=1)
    im = I.resize_area(src, 1 / 3)[:32, :32]
    lr_im = I.resize_area(im, 1 / 4)
    kw = dict(in_features=2, out_features=3, hidden_features=48,
              hidden_layers=2)
    tm = tget_inr("mfn", **kw)
    tp = tm.init(torch.Generator().manual_seed(1))
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tp))
    lr = 5e-2
    want = JT.fit_operator(
        get_inr("mfn", fused="never", **kw), jp, C.grid2d(32, 32), lr_im,
        JF.DownsampleOp(4),
        JT.FitConfig(learning_rate=lr, niters=5, lr_decay=0.2),
        gt_field=im, field_shape=(32, 32, 3), track="gt", donate=False)
    got = T.fit_operator(
        tm, tp, C.grid2d(32, 32), lr_im, TF.DownsampleOp(4),
        T.FitConfig(learning_rate=lr, niters=5, lr_decay=0.2),
        gt_field=im, field_shape=(32, 32, 3), track="gt", device="cpu")
    _check_fit(got, want, lr)
