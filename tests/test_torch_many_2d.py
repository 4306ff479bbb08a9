"""The batched multi-fit of WIRE-2D and mscale_2 (the replica axis of
``ops/wire2d.py:wire2d_step_many`` / ``wire2d_mlp_many`` and
``ops/mscale2_step.py:mscale2_step_many``, the families' replica hooks in
nn/models.py, and the many-fitters on them) against wire_tpu's on the CPU,
and each port replica against the port's own serial call.

Every input is drawn from a numpy seed; parameters cross with
``bridge.params_from_jax`` (a replica-stacked tree crosses as it is).

- The kernels' plain versions against ``jax.vmap`` of wire_tpu's Pallas
  calls in interpret mode, as tests/test_torch_wire2d.py and
  tests/test_torch_mscale2.py run them, at their tolerances:
  ``wire2d_step_fused`` and ``wire2d_mlp_fused`` at
  ``gemm_precision="highest"`` (predictions rtol 2e-4 / atol 1e-5, the
  step's gradients rtol 2e-4 / atol 1e-6, the pair's rtol 3e-4 / atol
  2e-6), ``mscale2_step_fused`` at ``precision="highest"`` (pred rtol
  2e-4 / atol 1e-5, gradients rtol 3e-4 / atol 2e-5 x max(1, max |ref|))
  at scales (0.5, 4), gamma <= 2.
- The stacked layout of a replica stack, and ``step_grads_many`` /
  ``apply_many`` against the serial calls: bit for bit (the plain
  versions run per replica on the CPU).
- Fits against wire_tpu's many-fitters at tests/test_torch_many_real.py's
  sizes (16 x 16, 32 wide, M 2-3, 5-6 steps) from one bridged stack, lr
  1e-3: histories rel 1e-4, fields rel 1e-4 / atol 1e-5, parameters rel
  1e-4 / atol 5e-5.
- Each port replica against the port's serial fit at ``seed + r`` from the
  same init: bit for bit.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.nn import models as JM
from wire_tpu.operators.forward import sisr_op as jsisr_op
from wire_tpu.ops.pallas.mscale2_step import mscale2_step_fused
from wire_tpu.ops.pallas.wire2d_step import wire2d_mlp_fused, \
    wire2d_step_fused
from wire_tpu.signals import coords as JC
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge, tree
from wire_tpu_torch.nn import models as TM
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.operators.forward import DownsampleOp
from wire_tpu_torch.ops import mscale2_step as MS
from wire_tpu_torch.ops import wire2d as W2
from wire_tpu_torch.signals.coords import GridSpec
from wire_tpu_torch.train import trainer as T

from .test_torch_many import (H, W, _assert_fit, _bits, _bits_tree,
                              _denoise_problem, _fixed_permutation, _jstack,
                              _perm, _same_fit, _sisr_problem)

PRED = dict(rtol=2e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=1e-6)
PAIR = dict(rtol=3e-4, atol=2e-6)
MS_GRAD = dict(rtol=3e-4, atol=2e-5)
W2D_KW = dict(in_features=2, hidden_features=32, first_omega0=7.0,
              hidden_omega0=7.0, scale=8.0)
MILD = (0.5, 4.0)


def _np_leaves(t):
    return [(p, np.asarray(v.detach().numpy() if torch.is_tensor(v) else v))
            for p, v in tree.leaves(t)]


def _assert_trees(got, want, tol, what, scale_atol=False):
    g, w = _np_leaves(got), _np_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (p, a), (_, b) in zip(g, w):
        kw = dict(tol)
        if scale_atol:
            kw["atol"] = tol["atol"] * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, err_msg=f"{what} {p}", **kw)


def _jnp(t):
    return jax.tree.map(jnp.asarray, t)


def _inputs(n, o, M, shared, seed):
    rng = np.random.default_rng(seed)
    lead = () if shared else (M,)
    return tuple(rng.uniform(lo, 1, lead + (n, k)).astype(np.float32)
                 for lo, k in ((-1, 2), (0, o), (0, o)))


# ---------------------------------------------------------------------------
# the kernels' plain versions against jax.vmap of wire_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared,layers,o,nvalid,denom", [
    (True, 2, 3, None, None), (False, 1, 1, 90, 333.5),
    (False, 3, 3, 77, None)])
def test_wire2d_step_many_matches_vmapped_pallas(shared, layers, o, nvalid,
                                                 denom):
    M, n = 2, 100
    jm = get_inr("wire2d", out_features=o, hidden_layers=layers, **W2D_KW)
    pstack, tstack = _jstack(jm, M, 3 + layers)
    coords, target, gt = _inputs(n, o, M, shared, 4)
    ax = None if shared else 0
    spec = dataclasses.replace(jm.spec, gemm_precision="highest")
    want = jax.vmap(
        lambda p, c, t, g: wire2d_step_fused(
            p, c, t, spec, nvalid=nvalid, denom=denom, gt=g,
            want_metrics=True, interpret=True),
        in_axes=(0, ax, ax, ax))(_jnp(pstack), jnp.asarray(coords),
                                 jnp.asarray(target), jnp.asarray(gt))
    tm = tget_inr("wire2d", out_features=o, hidden_layers=layers, **W2D_KW)
    got = W2.wire2d_step_many(tstack, torch.tensor(coords),
                              torch.tensor(target), tm.spec, nvalid=nvalid,
                              denom=denom, gt=torch.tensor(gt),
                              want_metrics=True)
    assert got[0].shape == (M, n, o) and got[2][0].shape == (M,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **PRED)
    _assert_trees(got[1], jax.tree.map(np.asarray, want[1]), GRAD, "step")
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4)


@pytest.mark.parametrize("shared", [True, False])
def test_wire2d_mlp_many_matches_vmapped_pallas(shared):
    M, n, o = 3, 90, 1
    jm = get_inr("wire2d", out_features=o, hidden_layers=2,
                 **dict(W2D_KW, first_omega0=3.0, hidden_omega0=3.0,
                        scale=12.0))
    pstack, tstack = _jstack(jm, M, 11)
    coords = _inputs(n, o, M, shared, 12)[0]
    cot = np.random.default_rng(13).normal(size=(M, n, o)).astype(
        np.float32)
    spec = dataclasses.replace(jm.spec, gemm_precision="highest")
    ax = None if shared else 0

    def one(p, c, g):
        y, vjp = jax.vjp(lambda q: wire2d_mlp_fused(q, c, spec, True), p)
        return y, vjp(g)[0]

    yj, gj = jax.vmap(one, in_axes=(0, ax, 0))(
        _jnp(pstack), jnp.asarray(coords), jnp.asarray(cot))
    paths = [p for p, _ in tree.leaves(tstack)]
    leaves = [v.clone().requires_grad_(True) for _, v in tree.leaves(tstack)]
    tm = tget_inr("wire2d", out_features=o, hidden_layers=2,
                  **dict(W2D_KW, first_omega0=3.0, hidden_omega0=3.0,
                         scale=12.0))
    y = W2.wire2d_mlp_many(tree.unflatten(paths, leaves),
                           torch.tensor(coords), tm.spec)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, torch.autograd.grad(
                 y, leaves, torch.tensor(cot), allow_unused=True))]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), **PRED)
    _assert_trees(tree.unflatten(paths, grads),
                  jax.tree.map(np.asarray, gj), PAIR, "pair")


@pytest.mark.parametrize("shared,nvalid,denom", [
    (True, None, None), (False, 270, 811.0)])
def test_mscale2_step_many_matches_vmapped_pallas(shared, nvalid, denom):
    M, n = 2, 300
    jm = get_inr("bspline_mscale_2", fused="never", in_features=2,
                 out_features=3, hidden_features=24, hidden_layers=2,
                 scale_tensor=MILD)
    pstack = jax.vmap(lambda k: jm._init(k, jm.spec))(
        jax.random.split(jax.random.key(5), M))
    canon = jax.vmap(lambda p: JM._canon_uniform(
        p, jm.spec, "qspline", 1.0, lambda b: b))(pstack)
    comb = {k: pstack["combiner"][k] for k in ("freq_0", "freq_1")}
    kinds = ("qspline",) * 3
    inv = tuple(1.0 / s for s in MILD)
    coords, target, gt = _inputs(n, 3, M, shared, 6)
    ax = None if shared else 0
    want = jax.vmap(
        lambda cn, cb, c, t, g: mscale2_step_fused(
            cn, cb, c, t, kinds, inv, nvalid=nvalid, denom=denom, gt=g,
            want_metrics=True, interpret=True, precision="highest"),
        in_axes=(0, 0, ax, ax, ax))(canon, comb, jnp.asarray(coords),
                                    jnp.asarray(target), jnp.asarray(gt))
    got = MS.mscale2_step_many(
        bridge.params_from_jax(jax.tree.map(np.asarray, canon)),
        bridge.params_from_jax(jax.tree.map(np.asarray, comb)),
        torch.tensor(coords), torch.tensor(target), kinds, inv,
        nvalid=nvalid, denom=denom, gt=torch.tensor(gt), want_metrics=True)
    assert got[0].shape == (M, n, 3) and got[3][0].shape == (M,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **PRED)
    for i, what in ((1, "trunk"), (2, "combiner")):
        _assert_trees(got[i], jax.tree.map(np.asarray, want[i]), MS_GRAD,
                      what, scale_atol=True)
    for a, b in zip(got[3], want[3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4)


# ---------------------------------------------------------------------------
# the stacked layout and the replica hooks against the serial calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [0, 2])
def test_wire2d_stack_params_of_a_replica_stack(layers):
    """stack_params of a replica stack is each replica's layout on a
    leading M (after the layer axis of W2, W2T and B2), and
    unstack_grads maps it back to the stacked tree, bit for bit."""
    M = 3
    tm = tget_inr("wire2d", out_features=3, hidden_layers=layers, **W2D_KW)
    stack = tree.stack([tm.init(torch.Generator().manual_seed(s))
                        for s in range(M)])
    many = W2.stack_params(stack, layers)
    for r in range(M):
        one = W2.stack_params(tree.index(stack, r), layers)
        for k, v in one.items():
            got = many[k][:, r] if k in ("W2", "W2T", "B2") else many[k][r]
            _bits(got, v, f"{k} replica {r}")
    h = 16
    rng = np.random.default_rng(7)
    gw1, gW2, gfW = (torch.tensor(rng.normal(size=s).astype(np.float32))
                     for s in ((M, 3, 2 * h), (layers, M, 2 * h + 1, 4 * h),
                               (M, 2 * h + 1, 3)))
    grads = W2.unstack_grads(gw1, gW2, gfW, stack["final"]["bi"], layers)
    for r in range(M):
        one = W2.unstack_grads(gw1[r], gW2[:, r], gfW[r],
                               stack["final"]["bi"][r], layers)
        _bits_tree(tree.index(grads, r), one, f"grads replica {r}")


MANY_FAMILIES = {
    "wire2d": dict(W2D_KW, hidden_layers=2),
    "mscale2": dict(in_features=2, hidden_features=24, hidden_layers=2,
                    scale_tensor=MILD),
    "mscale2_both": dict(in_features=2, hidden_features=24, hidden_layers=2,
                         scale_tensor=MILD, combine_type="both"),
}


def _family(name, M, seed, out=3):
    nonlin = "wire2d" if name == "wire2d" else "bspline_mscale_2"
    model = tget_inr(nonlin, out_features=out, **MANY_FAMILIES[name])
    return model, tree.stack([model.init(torch.Generator().manual_seed(
        seed + r)) for r in range(M)])


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("name", sorted(MANY_FAMILIES))
def test_step_and_apply_many_are_the_serial_calls(name, shared):
    """The replica hooks (wire2d_step_many / wire2d_mlp_many,
    mscale2_step_many under freq_combine, autodiff of mscale_2's batched
    apply at 'both') on shared and per-replica coordinates: each replica's
    pred, gradients, SSE sums and apply bit-equal to the serial call."""
    M, n = 3, 70
    model, stack = _family(name, M, 40)
    coords, target, gt = (torch.tensor(a) for a in _inputs(n, 3, M, shared,
                                                           41))
    pred, grads, sums = model.step_grads_many(
        stack, coords, target, nvalid=60, denom=250.0, gt=gt,
        want_metrics=True)
    y = model.apply_many(stack, coords)
    for r in range(M):
        def rep(x):
            return x if shared else x[r]
        p1, g1, s1 = model.step_grads(tree.index(stack, r), rep(coords),
                                      rep(target), nvalid=60, denom=250.0,
                                      gt=rep(gt), want_metrics=True)
        _bits(pred[r], p1, f"pred {r}")
        _bits_tree(tree.index(grads, r), g1, f"grads {r}")
        for a, b in zip(sums, s1):
            _bits(a[r], b, f"sse {r}")
        _bits(y[r], model.apply(tree.index(stack, r), rep(coords)),
              f"apply {r}")


def test_mscale2_hooks_follow_the_serial_step():
    """mscale_2's step hook is gated on the serial step's own condition:
    'freq_combine' with the kernels on takes mscale2_step_many, the other
    modes autodiff of the batched apply (its trunk through real_mlp_many,
    its combiner vmapped); its apply hook serves every mode with the
    kernels on; fused='never' takes vmap_apply of the plain apply."""
    M = 2
    seen = []
    for name, route in (("mscale2", "kernel"), ("mscale2_both", "autodiff")):
        model, stack = _family(name, M, 3)
        hooks = model._replica
        assert (model._replica_hook(hooks.step, hooks.step_ok, stack)
                is not None) == (route == "kernel")
        assert model._replica_hook(hooks.apply, hooks.ok, stack) \
            is TM.mscale2_apply_many
        seen.append(route)
    never = tget_inr("bspline_mscale_2", fused="never",
                     **MANY_FAMILIES["mscale2"])
    stack = tree.stack([never.init(torch.Generator().manual_seed(s))
                        for s in range(M)])
    assert never._replica_hook(never._replica.apply, never._replica.ok,
                               stack) is None
    assert seen == ["kernel", "autodiff"]


# ---------------------------------------------------------------------------
# the fitters against wire_tpu's
# ---------------------------------------------------------------------------

def _pair(name, out):
    nonlin = "wire2d" if name == "wire2d" else "bspline_mscale_2"
    kw = dict(MANY_FAMILIES[name], out_features=out)
    if name == "wire2d":
        kw.update(first_omega0=5.0, hidden_omega0=5.0, scale=2.0)
    return get_inr(nonlin, fused="never", **kw), tget_inr(nonlin, **kw)


@pytest.mark.parametrize("name,maxpoints", [
    ("wire2d", 65536), ("wire2d", 100), ("mscale2", 65536),
    ("mscale2_both", 65536)])
def test_fit_pointwise_many_matches_wire_tpu(monkeypatch, name, maxpoints):
    target, noisy = _denoise_problem()
    M, niters = 3 if name == "wire2d" else 2, 5
    jmodel, tmodel = _pair(name, 3)
    pstack, tstack = _jstack(jmodel, M, 42)
    kw = {}
    if maxpoints < H * W:
        kw["permutation"] = _fixed_permutation(monkeypatch, _perm(H * W, 3))
    cfg = dict(learning_rate=1e-3, niters=niters, maxpoints=maxpoints)
    want = JT.fit_pointwise_many(jmodel, pstack, JC.grid2d(H, W), noisy,
                                 JT.FitConfig(**cfg), gt=target)
    got = T.fit_pointwise_many(tmodel, tstack, GridSpec(H, W), noisy,
                               T.FitConfig(**cfg), gt=target, device="cpu",
                               **kw)
    _assert_fit(got, want, M, niters,
                field_atol=1e-5 if maxpoints >= H * W else 1e-4)


@pytest.mark.parametrize("name", ["wire2d", "mscale2"])
def test_fit_operator_many_sisr_matches_wire_tpu(name):
    M, niters = 2, 6
    ims, lrs = _sisr_problem(M)
    jmodel, tmodel = _pair(name, 3)
    pstack, tstack = _jstack(jmodel, M, 7)
    cfg = dict(learning_rate=1e-3, niters=niters)
    want = JT.fit_operator_many(jmodel, pstack, JC.grid2d(H, W), lrs,
                                lambda f: jsisr_op(f, 4), JT.FitConfig(**cfg),
                                gt_field=ims, field_shape=(H, W, 3),
                                batched_measurement=True)
    got = T.fit_operator_many(tmodel, tstack, JC.grid2d(H, W), lrs,
                              DownsampleOp(4), T.FitConfig(**cfg),
                              gt_field=ims, field_shape=(H, W, 3),
                              batched_measurement=True, device="cpu")
    _assert_fit(got, want, M, niters)


# ---------------------------------------------------------------------------
# replica r of the port's fits is the port's serial fit at seed + r
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cfg_kw", [
    ("wire2d", dict()), ("wire2d", dict(maxpoints=100)),
    ("mscale2", dict()), ("mscale2", dict(maxpoints=100, block_perm=16))])
def test_fit_pointwise_many_replicas_are_serial_fits(name, cfg_kw):
    target, noisy = _denoise_problem()
    M = 3
    model, stack = _family(name, M, 20)
    cfg = T.FitConfig(learning_rate=5e-3, niters=4, seed=5, **cfg_kw)
    many = T.fit_pointwise_many(model, stack, GridSpec(H, W), noisy, cfg,
                                gt=target, device="cpu")
    for r in range(M):
        one = T.fit_pointwise(model, tree.index(stack, r), GridSpec(H, W),
                              noisy, dataclasses.replace(cfg, seed=5 + r),
                              gt=target, device="cpu")
        _same_fit(many, r, one, f"{name} replica {r}")


@pytest.mark.parametrize("name", ["wire2d", "mscale2"])
def test_fit_operator_many_replicas_are_serial_fits(name):
    M = 2
    ims, lrs = _sisr_problem(M)
    model, stack = _family(name, M, 30)
    cfg = T.FitConfig(learning_rate=5e-3, niters=5)
    many = T.fit_operator_many(model, stack, JC.grid2d(H, W), lrs[0],
                               DownsampleOp(4), cfg, gt_field=ims[0],
                               field_shape=(H, W, 3), device="cpu")
    for r in range(M):
        one = T.fit_operator(model, tree.index(stack, r), JC.grid2d(H, W),
                             lrs[0], DownsampleOp(4), cfg, gt_field=ims[0],
                             field_shape=(H, W, 3), device="cpu")
        _same_fit(many, r, one, f"{name} replica {r}")
