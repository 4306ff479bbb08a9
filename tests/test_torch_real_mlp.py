"""The port's canonical real MLP (wire_tpu_torch/ops/real_mlp.py: the plain
versions ``real_mlp_plain`` and ``real_step_plain``, which ``real_mlp`` and
``real_step`` run for CPU tensors) against wire_tpu's Pallas kernels
``real_mlp_fused``, ``real_mlp_fused_scales`` and ``real_step_fused`` in
interpret mode, from the same numpy-seeded canonical weights and inputs:
every basis kind, lane segments, a ragged n with nvalid and denom, the SSE
sums, row_gamma and dcoords.

Tolerances are tests/test_pallas_real.py's: outputs rtol 2e-5 / atol 1e-5,
gradients rtol 2e-4 / atol 2e-5 (fp32 sums over up to 1,024 rows in another
order).  The sine basis is held to the same bounds: the JAX kernel's
polynomial fast_sincos and torch's sin/cos agree to ~1e-6 at these
arguments (measured: the largest gradient difference is 6e-7 x the
largest entry); the siren family at omega0 = 30 is checked in
tests/test_torch_real_models.py with its own stated bound."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.ops.pallas import real_mlp as JR

from wire_tpu_torch.ops import real_mlp as RM

FWD = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)

BASES = ("qspline", "cspline", "sine", "gauss", "relu", "srelu", "identity")
SEGMENTS = (("qspline", 20), ("identity", 10), ("sine", 10))
WIDTHS = (2, 48, 40, 3)


def _canon(widths, seed):
    rng = np.random.default_rng(seed)
    layers = [{"w": (rng.uniform(-1, 1, (a, b)) / np.sqrt(a)).astype(
                   np.float32),
               "alpha": rng.uniform(0.5, 2.0, b).astype(np.float32),
               "beta": rng.uniform(-1, 1, b).astype(np.float32)}
              for a, b in zip(widths[:-2], widths[1:-1])]
    h, o = widths[-2], widths[-1]
    return {"layers": layers,
            "final": {"w": (rng.uniform(-1, 1, (h, o)) / np.sqrt(h)).astype(
                          np.float32),
                      "b": rng.uniform(-1, 1, o).astype(np.float32)}}


def _map(fn, canon):
    return {"layers": [{k: fn(v) for k, v in lay.items()}
                       for lay in canon["layers"]],
            "final": {k: fn(v) for k, v in canon["final"].items()}}


def _jax_vjp(fn, canon, coords, g):
    y, vjp = jax.vjp(fn, _map(jnp.asarray, canon), jnp.asarray(coords))
    dc, dx = vjp(jnp.asarray(g))
    return (np.asarray(y), [np.asarray(t) for _, t in RM.canon_leaves(dc)],
            np.asarray(dx))


def _torch_vjp(fn, canon, coords, g):
    tc = _map(lambda a: torch.tensor(a, requires_grad=True), canon)
    x = torch.tensor(coords, requires_grad=True)
    y = fn(tc, x)
    leaves = [t for _, t in RM.canon_leaves(tc)]
    grads = torch.autograd.grad(y, leaves + [x], torch.tensor(g))
    return (y.detach().numpy(), [t.numpy() for t in grads[:-1]],
            grads[-1].numpy())


def _assert_vjp(got, want, what):
    np.testing.assert_allclose(got[0], want[0], err_msg=f"{what} y", **FWD)
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        np.testing.assert_allclose(a, b, err_msg=f"{what} leaf {i}", **GRAD)
    np.testing.assert_allclose(got[2], want[2], err_msg=f"{what} dcoords",
                               **GRAD)


def _inputs(n, d, o, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, d)).astype(np.float32),
            rng.normal(size=(n, o)).astype(np.float32))


@pytest.mark.parametrize("kind", BASES + ("segments",))
def test_real_mlp_matches_pallas_interpret(kind):
    kinds = (SEGMENTS, "qspline") if kind == "segments" else (kind, kind)
    canon = _canon(WIDTHS, 0)
    coords, g = _inputs(700, 2, 3, 1)
    want = _jax_vjp(lambda c, x: JR.real_mlp_fused(c, x, kinds, True),
                    canon, coords, g)
    got = _torch_vjp(lambda c, x: RM.real_mlp(c, x, kinds), canon, coords,
                     g)
    _assert_vjp(got, want, str(kind))


def test_real_mlp_row_gamma_matches_pallas_interpret():
    """A per-row-block gamma: JAX's (gammas, tiles_per_block) with 512-row
    tiles is the port's (gammas, rows_per_block = 512 x tiles)."""
    kinds = ("qspline", "gauss")
    canon = _canon(WIDTHS, 2)
    coords, g = _inputs(1024, 2, 3, 3)
    gammas = (0.5, 2.0)
    want = _jax_vjp(lambda c, x: JR.real_mlp_fused(c, x, kinds, True,
                                                   (gammas, 1)),
                    canon, coords, g)
    got = _torch_vjp(lambda c, x: RM.real_mlp(c, x, kinds,
                                              row_gamma=(gammas, 512)),
                     canon, coords, g)
    _assert_vjp(got, want, "row_gamma")


def test_real_mlp_scales_matches_pallas_interpret():
    kinds = ("qspline", "qspline")
    canon = _canon(WIDTHS, 4)
    coords, _ = _inputs(300, 2, 3, 5)
    g = np.random.default_rng(6).normal(size=(3, 300, 3)).astype(np.float32)
    inv = (1.0, 0.5, 1 / 9)
    want = _jax_vjp(lambda c, x: JR.real_mlp_fused_scales(c, x, kinds, inv,
                                                          True),
                    canon, coords, g)
    got = _torch_vjp(lambda c, x: RM.real_mlp_scales(c, x, kinds, inv),
                     canon, coords, g)
    assert got[0].shape == (3, 300, 3)
    _assert_vjp(got, want, "scales")


def test_real_mlp_restores_leading_axes():
    canon = _map(torch.tensor, _canon(WIDTHS, 7))
    coords, _ = _inputs(200, 2, 3, 8)
    x = torch.tensor(coords)
    flat = RM.real_mlp(canon, x, ("qspline", "sine"))
    batched = RM.real_mlp(canon, x.reshape(4, 50, 2), ("qspline", "sine"))
    assert batched.shape == (4, 50, 3)
    assert torch.equal(batched.reshape(200, 3), flat)


def _jax_step(canon, coords, target, kinds, **kw):
    out = JR.real_step_fused(_map(jnp.asarray, canon), jnp.asarray(coords),
                             jnp.asarray(target), kinds, interpret=True,
                             **kw)
    pred, dcanon = out[0], out[1]
    res = [np.asarray(pred), [np.asarray(t) for _, t in
                              RM.canon_leaves(dcanon)]]
    if len(out) > 2:
        res.append([float(s) for s in out[2]])
    return res


def _torch_step(canon, coords, target, kinds, gt=None, **kw):
    out = RM.real_step(_map(torch.tensor, canon), torch.tensor(coords),
                       torch.tensor(target), kinds,
                       gt=None if gt is None else torch.tensor(gt), **kw)
    res = [out[0].numpy(), [t.numpy() for _, t in
                            RM.canon_leaves(out[1])]]
    if len(out) > 2:
        res.append([float(s) for s in out[2]])
    return res


@pytest.mark.parametrize("kind", BASES + ("segments",))
def test_real_step_matches_pallas_interpret(kind):
    kinds = (SEGMENTS, "relu") if kind == "segments" else (kind, kind)
    canon = _canon(WIDTHS, 9)
    rng = np.random.default_rng(10)
    coords = rng.uniform(-1, 1, (700, 2)).astype(np.float32)
    target = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    want = _jax_step(canon, coords, target, kinds)
    got = _torch_step(canon, coords, target, kinds)
    np.testing.assert_allclose(got[0], want[0], **FWD)
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        np.testing.assert_allclose(a, b, err_msg=f"{kind} leaf {i}", **GRAD)


def test_real_step_nvalid_denom_and_metrics_match_pallas_interpret():
    """Tail rows past nvalid add nothing (their target is huge), an
    explicit denom is honoured, and the masked SSE sums against target and
    gt match the kernel's."""
    kinds = ("qspline", "cspline")
    canon = _canon(WIDTHS, 11)
    rng = np.random.default_rng(12)
    n, nvalid, denom = 700, 650, 650 * 3.0 + 7.0
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    target[nvalid:] = 1e6
    kw = dict(nvalid=nvalid, denom=denom, want_metrics=True)
    want = _jax_step(canon, coords, target, kinds, gt=jnp.asarray(gt), **kw)
    got = _torch_step(canon, coords, target, kinds, gt=gt, **kw)
    np.testing.assert_allclose(got[0], want[0], **FWD)
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        np.testing.assert_allclose(a, b, err_msg=f"leaf {i}", **GRAD)
    np.testing.assert_allclose(got[2], want[2], rtol=2e-4)


def test_real_step_plain_equals_autodiff_of_real_mlp_plain():
    """The plain step is the gradient of the plain forward's masked loss."""
    kinds = ("srelu", "gauss")
    canon = _map(torch.tensor, _canon(WIDTHS, 13))
    coords, _ = _inputs(300, 2, 3, 14)
    target = torch.rand((300, 3), generator=torch.Generator().manual_seed(0))
    x = torch.tensor(coords)
    pred, dcanon, (st, sg) = RM.real_step_plain(canon, x, target, kinds,
                                                nvalid=280, denom=900.0,
                                                want_metrics=True)
    leaves = [t.clone().requires_grad_(True)
              for _, t in RM.canon_leaves(canon)]
    y = RM.real_mlp_plain(RM.canon_from_leaves(leaves, 2), x, kinds)
    err = (y - target) * (torch.arange(300)[:, None] < 280)
    grads = torch.autograd.grad((err * err).sum() / 900.0, leaves)
    for (_, a), b in zip(RM.canon_leaves(dcanon), grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sse = float((err * err).sum().detach())
    assert float(st) == float(sg) == pytest.approx(sse, rel=1e-6)


def test_kind_codes_and_segments():
    codes = RM.kind_codes(SEGMENTS, 48)
    assert codes.dtype == np.uint8
    assert list(codes[:20]) == [RM.BASIS_CODES["qspline"]] * 20
    assert list(codes[20:30]) == [RM.BASIS_CODES["identity"]] * 10
    assert list(codes[30:40]) == [RM.BASIS_CODES["sine"]] * 10
    assert not codes[40:].any()   # past the segments: the zero basis
    assert list(RM.kind_codes("srelu", 3)) == [RM.BASIS_CODES["srelu"]] * 3
    with pytest.raises(ValueError, match="unknown basis"):
        RM.kind_codes("tanh", 4)


def test_wrappers_refuse_other_devices():
    canon = _map(torch.tensor, _canon(WIDTHS, 15))
    x = torch.zeros((8, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        RM.real_mlp(canon, x, ("relu", "relu"))
    with pytest.raises(ValueError, match="unsupported device"):
        RM.real_step(canon, x, torch.zeros((8, 3), device="meta"),
                     ("relu", "relu"))


def test_flop_counts_of_the_two_paths():
    w = (2, 256, 256, 256, 3)
    fwd = 2 * 65536 * (2 * 256 + 2 * 256 * 256 + 256 * 3)
    assert RM.forward_flops(65536, w) == fwd
    # forward, weight gradients, data gradients without dcoords
    assert RM.step_flops(65536, w) == 3 * fwd - 2 * 65536 * 2 * 256
    assert abs(RM.step_flops(65536, w) / 1e9 - 51.98) < 0.01
    assert abs(RM.apply_flops(28224, w) / 1e9 - 22.41) < 0.01
    assert RM.apply_flops(28224, w) == RM.step_flops(28224, w) + \
        2 * 28224 * 2 * 256
