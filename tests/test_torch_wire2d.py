"""The port's WIRE-2D (wire_tpu_torch/ops/wire2d.py: the plain versions
``wire2d_step_plain`` and ``wire2d_mlp_plain``, which ``wire2d_step`` and
``wire2d_mlp`` run for CPU tensors, and the stacked layout the CUDA kernels
read; nn/models.py and nn/registry.py: the family) against wire_tpu's
Pallas kernels ``wire2d_step_fused`` and ``wire2d_mlp_fused`` in interpret
mode and against autodiff of wire_tpu's plain ``wire2d_apply``, from the
same numpy-seeded or bridged parameters and inputs; and a short
fit_pointwise (denoise) and fit_operator (fourier CT) WIRE-2D fit against
wire_tpu's from one bridged init.

Tolerances are tests/test_pallas_wire2d.py's: predictions rtol 2e-4 /
atol 1e-5, the step's gradients rtol 2e-4 / atol 1e-6, the pair's
gradients and dcoords rtol 3e-4 / atol 2e-6, as that file holds the JAX
pair to autodiff (fp32 sums over up to 1,100 rows in another order; the
interpret kernel runs at
gemm_precision="highest", so its products are exact f32 too, and its
fast_sincos agrees with torch's cos/sin to f32 rounding at these phases).
The fits hold their histories to rel 1e-4 and the parameters to rel 1e-4
with atol 1% of one Adam step (tests/test_torch_trainer.py's bounds)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import activations as JA
from wire_tpu.nn import get_inr
from wire_tpu.nn.models import wire2d_apply as jwire2d_apply
from wire_tpu.ops.pallas.wire2d_step import wire2d_mlp_fused, \
    wire2d_step_fused
from wire_tpu.signals import image as JI
from wire_tpu.train import trainer as JT

import chip_smoke
from wire_tpu_torch import bridge, tree
from wire_tpu_torch.apps import ct as TCT
from wire_tpu_torch.nn import activations as TA
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.operators import radon as TR
from wire_tpu_torch.ops import wire2d as W2
from wire_tpu_torch.signals import coords as C
from wire_tpu_torch.train.profiling import launches
from wire_tpu_torch.train import trainer as T

PRED = dict(rtol=2e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=1e-6)
# the pair's gradients and dcoords: test_pallas_wire2d.py's pair tolerance
PAIR = dict(rtol=3e-4, atol=2e-6)
REL = 1e-4


def _kw(hf, layers, out, **extra):
    kw = dict(in_features=2, out_features=out, hidden_features=hf,
              hidden_layers=layers, first_omega0=7.0, hidden_omega0=7.0,
              scale=8.0)
    kw.update(extra)
    return kw


def _models(hf, layers, out, **extra):
    kw = _kw(hf, layers, out, **extra)
    return get_inr("wire2d", **kw), tget_inr("wire2d", **kw)


def _jax_params(jm, seed):
    return jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))


def _inputs(n, o, seed, lead=()):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(lo, 1, lead + (n, k)).astype(np.float32)
                 for lo, k in ((-1, 2), (0, o), (0, o))) + (
        rng.normal(size=lead + (n, o)).astype(np.float32),)


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


def _port_step(tm, p, coords, target, **kw):
    t = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
         for k, v in kw.items()}
    return W2.wire2d_step(bridge.params_from_jax(p), torch.tensor(coords),
                          torch.tensor(target), tm.spec, **t)


def _jax_autodiff_step(jm, p, coords, target, nvalid=None, denom=None):
    spec = jm.spec.replace(fused="never")
    n, c = target.shape
    dn = float(n * c) if denom is None else denom

    def loss_fn(q):
        pred = jwire2d_apply(q, jnp.asarray(coords), spec)
        err = pred - target
        if nvalid is not None:
            err = err * (jnp.arange(n)[:, None] < nvalid)
        return jnp.sum(err * err) / dn, pred

    (_, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, p))
    return pred, grads


# test_pallas_wire2d.py's step cases, with a tail mask, an explicit denom
# and the metric sums on the first
CASES = [(700, 128, 2, 3, 650, 650 * 3.0 + 7.0), (512, 128, 1, 1, None, None),
         (100, 300, 2, 3, None, None)]


@pytest.mark.parametrize("n,hf,layers,o,nvalid,denom", CASES)
def test_wire2d_step_plain_matches_pallas_interpret(n, hf, layers, o, nvalid,
                                                    denom):
    jm, tm = _models(hf, layers, o)
    p = _jax_params(jm, n + layers)
    coords, target, gt, _ = _inputs(n, o, 1)
    want = wire2d_step_fused(jax.tree.map(jnp.asarray, p),
                             jnp.asarray(coords), jnp.asarray(target),
                             _interp_spec(jm), nvalid=nvalid, denom=denom,
                             gt=jnp.asarray(gt), want_metrics=True,
                             interpret=True)
    got = _port_step(tm, p, coords, target, nvalid=nvalid, denom=denom,
                     gt=gt, want_metrics=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **PRED)
    _assert_trees(got[1], want[1], GRAD, "step")
    np.testing.assert_allclose([float(s) for s in got[2]],
                               [float(s) for s in want[2]], rtol=2e-4)


@pytest.mark.parametrize("n,hf,layers,o,nvalid,denom", CASES)
def test_wire2d_step_plain_matches_jax_autodiff(n, hf, layers, o, nvalid,
                                                denom):
    jm, tm = _models(hf, layers, o)
    p = _jax_params(jm, n + layers)
    coords, target, gt, _ = _inputs(n, o, 2)
    pred, grads = _jax_autodiff_step(jm, p, coords, target, nvalid, denom)
    got = _port_step(tm, p, coords, target, nvalid=nvalid, denom=denom,
                     gt=gt, want_metrics=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pred), **PRED)
    _assert_trees(got[1], grads, GRAD, "autodiff")
    rows = slice(None, nvalid)
    pred = got[0].numpy()[rows]
    np.testing.assert_allclose(float(got[2][0]),
                               np.sum((pred - target[rows]) ** 2), rtol=1e-5)
    np.testing.assert_allclose(float(got[2][1]),
                               np.sum((pred - gt[rows]) ** 2), rtol=1e-5)


def test_wire2d_step_masks_tail_sentinels():
    """Rows past nvalid add nothing: targets of 1e6 there give the same
    gradients as the clean targets."""
    jm, tm = _models(64, 2, 3)
    p = _jax_params(jm, 5)
    coords, target, _, _ = _inputs(600, 3, 6)
    sentinel = target.copy()
    sentinel[450:] = 1e6
    a = _port_step(tm, p, coords, sentinel, nvalid=450, denom=450 * 3.0)
    b = _port_step(tm, p, coords, target, nvalid=450, denom=450 * 3.0)
    _assert_trees(a[1], b[1], dict(rtol=0, atol=0), "sentinel")


def _torch_vjp(fn, params, coords, g):
    flat = tree.leaves(bridge.params_from_jax(params))
    paths = [p for p, _ in flat]
    leaves = [t.requires_grad_(True) for _, t in flat]
    x = torch.tensor(coords, requires_grad=True)
    y = fn(tree.unflatten(paths, leaves), x)
    grads = torch.autograd.grad(y, leaves + [x], torch.tensor(g),
                                allow_unused=True)
    grads = [torch.zeros_like(v) if gr is None else gr
             for v, gr in zip(leaves + [x], grads)]
    return (y.detach().numpy(), tree.unflatten(paths, grads[:-1]),
            grads[-1].numpy())


def _jax_vjp(fn, params, coords, g):
    y, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params),
                     jnp.asarray(coords))
    dp, dx = vjp(jnp.asarray(g))
    return np.asarray(y), dp, np.asarray(dx)


# test_pallas_wire2d.py's pair cases (hf 96, two hidden layers, 3 outputs,
# n straddling its 512-row tiles), one output, one hidden layer, full width
PAIR_CASES = [(512, 96, 2, 3), (700, 96, 2, 3), (1100, 96, 2, 3),
              (700, 96, 2, 1), (1100, 64, 1, 3), (300, 300, 2, 1)]


@pytest.mark.parametrize("n,hf,layers,o", PAIR_CASES)
def test_wire2d_mlp_plain_matches_pallas_interpret_and_autodiff(n, hf,
                                                                layers, o):
    """test_pallas_wire2d.py::test_wire2d_pair_vjp_matches_autodiff's check:
    the gradients of mean((y - target)^2) in the parameters and the
    coordinates, each path against the interpret kernel and against
    autodiff of wire_tpu's plain apply."""
    jm, tm = _models(hf, layers, o)
    p = _jax_params(jm, 2 * n + layers)
    coords, target, _, _ = _inputs(n, o, 3)

    def loss_cot(y):
        return 2.0 * (y - target) / y.size

    y = W2.wire2d_mlp(bridge.params_from_jax(p), torch.tensor(coords),
                      tm.spec).numpy()
    got = _torch_vjp(lambda q, x: W2.wire2d_mlp(q, x, tm.spec), p, coords,
                     loss_cot(y))
    spec = _interp_spec(jm)
    never = jm.spec.replace(fused="never")
    for what, fn in (
            ("interpret", lambda q, x: wire2d_mlp_fused(q, x, spec, True)),
            ("autodiff", lambda q, x: jwire2d_apply(q, x, never))):
        yj = np.asarray(fn(jax.tree.map(jnp.asarray, p), jnp.asarray(coords)))
        want = _jax_vjp(fn, p, coords, loss_cot(yj))
        np.testing.assert_allclose(got[0], want[0], err_msg=what, **PRED)
        _assert_trees(got[1], want[1], PAIR, what)
        np.testing.assert_allclose(got[2], want[2], err_msg=f"{what} dx",
                                   **PAIR)


@pytest.mark.parametrize("n,hf,layers,o", PAIR_CASES)
def test_wire2d_mlp_plain_matches_pallas_interpret_at_a_unit_cotangent(
        n, hf, layers, o):
    """The same pair under a unit-scale random cotangent (gradients near 1,
    so per-element rtol/atol bounds would judge fp32 cancellation in
    near-zero entries): every output within 1e-4 x its max abs, the
    kernel-vs-plain bound of chip_smoke.py (REL_TOL)."""
    jm, tm = _models(hf, layers, o)
    p = _jax_params(jm, 2 * n + layers)
    coords, _, _, g = _inputs(n, o, 4)
    got = _torch_vjp(lambda q, x: W2.wire2d_mlp(q, x, tm.spec), p, coords, g)
    spec = _interp_spec(jm)
    want = _jax_vjp(lambda q, x: wire2d_mlp_fused(q, x, spec, True), p,
                    coords, g)
    pairs = [("y", got[0], want[0]), ("dcoords", got[2], want[2])] + [
        (str(pa), a, b) for (pa, a), (_, b) in zip(_leaves_np(got[1]),
                                                   _leaves_np(want[1]))]
    for name, a, b in pairs:
        b = np.asarray(b)
        err = float(np.abs(a - b).max())
        assert err <= chip_smoke.REL_TOL * float(np.abs(b).max()) + \
            1e-30 * (not np.abs(b).max()), (name, err)


def test_wire2d_mlp_restores_leading_axes():
    jm, tm = _models(64, 2, 3)
    p = _jax_params(jm, 8)
    coords = _inputs(50, 3, 8, lead=(4,))[0]
    got = W2.wire2d_mlp(bridge.params_from_jax(p), torch.tensor(coords),
                        tm.spec)
    assert got.shape == (4, 50, 3)
    want = wire2d_mlp_fused(jax.tree.map(jnp.asarray, p), jnp.asarray(coords),
                            _interp_spec(jm), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRED)
    flat = W2.wire2d_mlp(bridge.params_from_jax(p),
                         torch.tensor(coords.reshape(200, 2)), tm.spec)
    assert torch.equal(got.reshape(200, 3), flat)


@pytest.mark.parametrize("layers", [0, 1, 3])
def test_stack_and_unstack_round_trip(layers):
    """stack_params' blocks mapped back by unstack_grads: the first layers
    and biases come back as they were, each hidden wr and wi twice (W2
    holds them twice), the final wi once and the final bi as zeros."""
    _, tm = _models(24, layers, 2)
    p = tm.init(torch.Generator().manual_seed(layers))
    w = W2.stack_params(p, layers)
    h = 12
    assert w["w1"].shape == (2, 2 * h) and w["W2"].shape == (layers, 2 * h,
                                                              4 * h)
    assert torch.equal(w["W2T"], w["W2"].transpose(1, 2))
    gw1 = torch.cat([w["w1"], w["b1"][None]])
    gW2 = torch.cat([w["W2"], w["B2"][:, None]], 1)
    gfW = torch.cat([w["fW"], w["fb"][None]])
    back = W2.unstack_grads(gw1, gW2, gfW, p["final"]["bi"], layers)
    want = tree.map(torch.clone, p)
    for i in range(layers):
        for head in ("lin", "orth"):
            for k in ("wr", "wi"):
                want[f"hidden_{i}_{head}"][k] = 2 * p[f"hidden_{i}_{head}"][k]
    want["final"]["bi"] = torch.zeros_like(p["final"]["bi"])
    _assert_trees(back, want, dict(rtol=0, atol=0), "round trip")


@pytest.mark.parametrize("n,hf,layers,o", [(300, 64, 2, 3), (200, 40, 1, 1),
                                           (150, 20, 0, 2)])
def test_stacked_layout_matches_plain(n, hf, layers, o):
    """The step the CUDA kernel computes on the stacked layout, written out
    with torch.matmul (chip_smoke.wire2d_matmul_step, the smoke's
    yardstick) and mapped back by unstack_grads, equals autodiff of the
    plain forward."""
    _, tm = _models(hf, layers, o)
    p = tm.init(torch.Generator().manual_seed(n))
    c, t, gt, _ = (torch.tensor(a) for a in _inputs(n, o, 9))
    got = chip_smoke.tensors_of(*chip_smoke.wire2d_matmul_step(
        torch, W2, p, c, t, gt, tm.spec))
    want = chip_smoke.tensors_of(*W2.wire2d_step_plain(
        p, c, t, tm.spec, gt=gt, want_metrics=True))
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=REL,
                                   atol=1e-6, err_msg=name)


def test_gabor2d_magnitude_is_one_exp():
    """Where e^{-w li} alone overflows float32, the one-exp magnitude stays
    finite and equals wire_tpu's."""
    rng = np.random.default_rng(0)
    lr, orr, oi = (rng.uniform(-1, 1, 64).astype(np.float32)
                   for _ in range(3))
    li = np.linspace(-20.0, 20.0, 64).astype(np.float32)
    got = TA.complex_gabor2d(*(torch.tensor(a) for a in (lr, li, orr, oi)),
                             7.0, 8.0)
    want = JA.complex_gabor2d(*(jnp.asarray(a) for a in (lr, li, orr, oi)),
                              7.0, 8.0)
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(np.float32(-7.0) * li)).all()
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=1e-30)


def test_wire2d_init_shapes_bounds_and_num_params():
    hf, layers, o = 48, 2, 3
    jm, tm = _models(hf, layers, o, in_features=3)
    p = tm.init(torch.Generator().manual_seed(0))
    jp = jm.init(jax.random.key(0))
    assert [pp for pp, _ in tree.leaves(p)] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    for path, t in tree.leaves(p):
        assert tuple(t.shape) == np.asarray(jp[path[0]][path[1]]).shape, path
    assert tm.num_params(p) == jm.num_params(jp)
    h = hf // 2
    for path, t in tree.leaves(p):
        fan_in = 3 if path[0].startswith("first") else h
        assert float(t.abs().max()) <= 1 / np.sqrt(fan_in), path
    q = tm.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree.leaves(p), tree.leaves(q)))


def test_factory_defaults_match_wire_tpu():
    jm, tm = get_inr("wire2d"), tget_inr("wire2d")
    for f in ("first_omega0", "hidden_omega0", "scale", "hidden_features",
              "hidden_layers", "in_features", "out_features"):
        assert getattr(tm.spec, f) == getattr(jm.spec, f), f
    assert (tm.spec.first_omega0, tm.spec.scale) == (10.0, 10.0)


def test_bridge_round_trip_of_wire2d_params():
    """bridge's generic tree map carries wire2d's two-head tree unchanged
    both ways."""
    jm, _ = _models(32, 2, 3)
    p = _jax_params(jm, 9)
    tp = bridge.params_from_jax(p)
    assert sorted(tp) == sorted(p) == [
        "final", "first_lin", "first_orth", "hidden_0_lin", "hidden_0_orth",
        "hidden_1_lin", "hidden_1_orth"]
    back = bridge.params_to_numpy(tp)
    for (pa, a), (pb, b) in zip(tree.leaves(back), tree.leaves(p)):
        assert pa == pb and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_step_grads_and_apply_auto_and_never_agree_on_the_cpu():
    _, tm = _models(40, 1, 3)
    never = tget_inr("wire2d", fused="never", **_kw(40, 1, 3))
    p = tm.init(torch.Generator().manual_seed(3))
    coords, target, gt, _ = (torch.tensor(a) for a in _inputs(90, 3, 3))
    a = tm.step_grads(p, coords, target, gt=gt, want_metrics=True)
    b = never.step_grads(p, coords, target, gt=gt, want_metrics=True)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    _assert_trees(a[1], b[1], dict(rtol=0, atol=0), "never")
    assert float(b[1]["final"]["bi"].abs().max()) == 0.0
    assert torch.equal(tm.apply(p, coords), never.apply(p, coords))


@pytest.mark.parametrize("fused", ["auto", "never"])
def test_wire2d_dispatch_takes_the_wrappers_unless_never(monkeypatch, fused):
    """apply and step_grads reach ops/wire2d.py's wire2d_mlp and
    wire2d_step (the kernels on a card) unless fused == 'never'."""
    calls = []
    for name in ("wire2d_mlp", "wire2d_step"):
        real = getattr(W2, name)
        monkeypatch.setattr(W2, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    tm = tget_inr("wire2d", fused=fused, **_kw(16, 1, 3))
    p = tm.init(torch.Generator().manual_seed(1))
    coords, target, _, _ = (torch.tensor(a) for a in _inputs(40, 3, 1))
    tm.apply(p, coords)
    tm.step_grads(p, coords, target)
    assert calls == ([] if fused == "never" else ["wire2d_mlp",
                                                  "wire2d_step"])


def test_wire2d_wrappers_refuse_other_devices():
    _, tm = _models(16, 1, 3)
    p = tm.init(torch.Generator().manual_seed(0))
    x = torch.zeros((8, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        W2.wire2d_mlp(p, x, tm.spec)
    with pytest.raises(ValueError, match="unsupported device"):
        W2.wire2d_step(p, x, torch.zeros((8, 3), device="meta"), tm.spec)
    before = launches("wire2d")
    coords, target, _, _ = (torch.tensor(a) for a in _inputs(8, 3, 0))
    W2.wire2d_step(p, coords, target, tm.spec)
    W2.wire2d_mlp(p, coords, tm.spec)
    assert launches("wire2d") == before


def test_wire2d_flop_counts():
    """The denoise step (n = 65,536, h = 150, L = 2, o = 3) and the CT pair
    (o = 1, no dcoords): three (n x 300 x 600) products per hidden layer
    dominate."""
    n = 65536
    f = W2.step_flops(n, 2, 150, 3, 2)
    assert 6 * 2 * n * 300 * 600 < f < 1.01 * 6 * 2 * n * 300 * 600
    assert abs(f / 1e9 - 142.3) < 0.05
    assert abs(W2.apply_flops(n, 2, 150, 1, 2, dcoords=False) / 1e9
               - 142.0) < 0.05
    assert W2.apply_flops(n, 2, 150, 1, 2) - W2.apply_flops(
        n, 2, 150, 1, 2, dcoords=False) == 2 * n * 300 * 2


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


def test_wire2d_denoise_fit_matches_wire_tpu():
    """Five full-batch fit_pointwise epochs (lr 5e-3 scaled by batch) on a
    noisy 24^2 image from one bridged init."""
    H = W = 24
    rng = np.random.default_rng(0)
    im = JI.natural_image(H, W, 3, seed=0)
    noisy = (im + 0.1 * rng.normal(size=im.shape)).astype(np.float32)
    kw = _kw(48, 2, 3)
    tm = tget_inr("wire2d", **kw)
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tp))
    lr = 5e-3
    want = JT.fit_pointwise(
        get_inr("wire2d", fused="never", **kw), jp, C.grid2d(H, W),
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


def test_wire2d_ct_fit_matches_wire_tpu():
    """Five fit_operator iterations through the fourier Radon operator (a
    16^2 field, 12 angles; omega0 3, sigma 12 as preset
    WIRE_s12_o8_LR5e3_E2000) from one bridged init."""
    import importlib
    JR = importlib.import_module("wire_tpu.operators.radon")
    img = TCT.ct_image(None, seed=0, size=32)
    H, W = img.shape
    thetas = np.linspace(0, 180, 12, dtype=np.float32)
    kw = _kw(40, 2, 1, first_omega0=3.0, hidden_omega0=3.0, scale=12.0)
    tm = tget_inr("wire2d", **kw)
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tp))
    jop = JR.RadonOp(jnp.asarray(thetas), method="fourier")
    sino = np.array(jop(jnp.asarray(img)))
    lr = 5e-3
    want = JT.fit_operator(
        get_inr("wire2d", fused="never", **kw), jp, C.grid2d(H, W), sino,
        jop, JT.FitConfig(learning_rate=lr, niters=5, maxpoints=4096),
        gt_field=img, field_shape=(H, W), track="gt", donate=False)
    got = T.fit_operator(
        tm, tp, C.grid2d(H, W), sino, TR.RadonOp(thetas, method="fourier"),
        T.FitConfig(learning_rate=lr, niters=5, maxpoints=4096),
        gt_field=img, field_shape=(H, W), track="gt", device="cpu")
    _check_fit(got, want, lr)
