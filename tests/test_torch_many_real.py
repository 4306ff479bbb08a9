"""The batched multi-fit of the real families and the MFN (the replica axis
of ``ops/real_mlp.py:real_step_many`` / ``real_mlp_many`` and
``ops/mfn.py:mfn_step_many`` / ``mfn_mlp_many``, the families' replica
hooks in nn/models.py, the many-fitters and the sweep's seeds tasks on
them) against wire_tpu's on the CPU, and each port replica against the
port's own serial call.

Every input is drawn from a numpy seed; parameters cross with
``bridge.params_from_jax`` (a replica-stacked tree crosses as it is).

- The kernels' plain versions against ``jax.vmap`` of wire_tpu's Pallas
  calls in interpret mode, as tests/test_torch_real_mlp.py and
  tests/test_torch_mfn.py run them: ``real_step_fused`` and
  ``real_mlp_fused`` at their tolerances there (outputs rtol 2e-5 / atol
  1e-5, gradients rtol 2e-4 / atol 2e-5), ``mfn_step_fused`` (rtol 2e-4 /
  atol 1e-5) and ``mfn_mlp_fused`` at ``gemm_precision="highest"`` (the
  gradients rtol 2e-4 / atol 1e-6, the output rtol 2e-4 / atol 1e-5).
- The batched fold (``fold_grads_many``: ``torch.func.vmap`` of the fold,
  ``torch.func.vjp`` back) against the serial ``fold_grads`` of every
  family that folds onto ``real_step``, and ``step_grads_many`` /
  ``apply_many`` against the serial calls: bit for bit.
- Fits against wire_tpu's many-fitters at tests/test_trainer.py:473-600's
  sizes (16 x 16, 32 wide, M 2-3, 5-6 steps) from one bridged stack, the
  chunked fit on one shared permutation (tests/test_torch_many.py's
  hooks), lr 1e-3 at omega0 5: histories rel 1e-4, fields rel 1e-4 / atol
  1e-5 (1e-4 for the chunked field), parameters rel 1e-4 / atol 5e-5.
- Each port replica against the port's serial fit at ``seed + r`` from the
  same init: bit for bit.
- The seeds sweeps of siren, mfn and posenc (and gauss's SISR): wire_tpu's
  ``sweep_*_seeds`` and the port's at a tiny size from wire_tpu's split-key
  stack moved across: per-replica PSNR (SISR: best MSE in dB) within 0.01
  dB.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.apps import sweep as JS
from wire_tpu.nn import get_inr
from wire_tpu.operators.forward import sisr_op as jsisr_op
from wire_tpu.ops.pallas import real_mlp as JR
from wire_tpu.ops.pallas.mfn_step import mfn_mlp_fused, mfn_step_fused
from wire_tpu.signals import coords as JC
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge, tree
from wire_tpu_torch.apps import sweep as TS
from wire_tpu_torch.nn import models as TM
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.operators.forward import DownsampleOp
from wire_tpu_torch.ops import mfn as MF
from wire_tpu_torch.ops import real_mlp as RM
from wire_tpu_torch.signals.coords import GridSpec
from wire_tpu_torch.train import trainer as T

from .test_torch_many import (H, W, _assert_fit, _bits, _bits_tree,
                              _close_tree, _denoise_problem,
                              _fixed_permutation, _jstack, _perm,
                              _same_fit, _sisr_problem, _with_jax_stack)

FWD = dict(rtol=2e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
MFN_STEP = dict(rtol=2e-4, atol=1e-5)
MFN_PAIR = dict(rtol=2e-4, atol=1e-6)
WIDTHS = (2, 24, 20, 3)


# ---------------------------------------------------------------------------
# the kernels' plain versions against jax.vmap of wire_tpu's
# ---------------------------------------------------------------------------

def _canon_stack(widths, M, seed):
    """M numpy canonical trees (tests/test_torch_real_mlp.py's draws),
    stacked on a leading replica axis."""
    rng = np.random.default_rng(seed)

    def one():
        return {"layers": [{"w": (rng.uniform(-1, 1, (a, b)) / np.sqrt(a)
                                  ).astype(np.float32),
                            "alpha": rng.uniform(0.5, 2.0, b).astype(
                                np.float32),
                            "beta": rng.uniform(-1, 1, b).astype(np.float32)}
                           for a, b in zip(widths[:-2], widths[1:-1])],
                "final": {"w": (rng.uniform(-1, 1, widths[-2:])
                                / np.sqrt(widths[-2])).astype(np.float32),
                          "b": rng.uniform(-1, 1, widths[-1]).astype(
                              np.float32)}}
    reps = [one() for _ in range(M)]
    return jax.tree.map(lambda *x: np.stack(x), *reps)


def _leaves(canon):
    return [np.asarray(t) for _, t in RM.canon_leaves(canon)]


@pytest.mark.parametrize("shared,kinds,nvalid,denom", [
    (True, ("qspline", "sine"), None, None),
    (False, ("relu", "gauss"), 250, 777.5)])
def test_real_step_many_matches_vmapped_pallas(shared, kinds, nvalid, denom):
    M, n, o = 3, 300, WIDTHS[-1]
    canon = _canon_stack(WIDTHS, M, 1)
    rng = np.random.default_rng(2)
    lead = () if shared else (M,)
    coords = rng.uniform(-1, 1, lead + (n, 2)).astype(np.float32)
    target = rng.uniform(0, 1, lead + (n, o)).astype(np.float32)
    gt = rng.uniform(0, 1, lead + (n, o)).astype(np.float32)
    ax = None if shared else 0
    pred_k, g_k, (st_k, sg_k) = jax.vmap(
        lambda c, x, t, g: JR.real_step_fused(
            c, x, t, kinds, nvalid=nvalid, denom=denom, gt=g,
            want_metrics=True, interpret=True),
        in_axes=(0, ax, ax, ax))(jax.tree.map(jnp.asarray, canon),
                                 jnp.asarray(coords), jnp.asarray(target),
                                 jnp.asarray(gt))
    pred, grads, (st, sg) = RM.real_step_many(
        jax.tree.map(torch.tensor, canon), torch.tensor(coords),
        torch.tensor(target), kinds, nvalid=nvalid, denom=denom,
        gt=torch.tensor(gt), want_metrics=True)
    assert pred.shape == (M, n, o) and st.shape == (M,)
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_k), **FWD)
    for got, want in ((st, st_k), (sg, sg_k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4)
    for i, (a, b) in enumerate(zip(_leaves(bridge.params_to_numpy(grads)),
                                   _leaves(g_k))):
        np.testing.assert_allclose(a, b, err_msg=f"leaf {i}", **GRAD)


@pytest.mark.parametrize("shared", [True, False])
def test_real_mlp_many_matches_vmapped_pallas(shared):
    M, o = 2, WIDTHS[-1]
    kinds = ("cspline", "srelu")
    canon = _canon_stack(WIDTHS, M, 3)
    rng = np.random.default_rng(4)
    coords = rng.uniform(-1, 1, (300, 2) if shared else (M, 3, 100, 2)
                         ).astype(np.float32)
    out_shape = (M, 300, o) if shared else (M, 3, 100, o)
    g = rng.normal(size=out_shape).astype(np.float32)
    y_k, vjp = jax.vjp(
        lambda c: jax.vmap(lambda cc, x: JR.real_mlp_fused(
            cc, x.reshape(-1, 2), kinds, True).reshape(*x.shape[:-1], o),
            in_axes=(0, None if shared else 0))(c, jnp.asarray(coords)),
        jax.tree.map(jnp.asarray, canon))
    (dc_k,) = vjp(jnp.asarray(g))
    tc = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), canon)
    leaves = [t for _, t in RM.canon_leaves(tc)]
    y = RM.real_mlp_many(tc, torch.tensor(coords), kinds)
    grads = torch.autograd.grad(y, leaves, torch.tensor(g))
    assert y.shape == out_shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_k), **FWD)
    for i, (a, b) in enumerate(zip(grads, _leaves(dc_k))):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"leaf {i}", **GRAD)


def _mfn(d=2, hf=32, layers=2, o=3):
    kw = dict(in_features=d, out_features=o, hidden_features=hf,
              hidden_layers=layers)
    return get_inr("mfn", **kw), tget_inr("mfn", **kw)


def _interp(jm):
    return dataclasses.replace(jm.spec, gemm_precision="highest")


@pytest.mark.parametrize("shared,nvalid,denom", [(True, None, None),
                                                 (False, 250, 901.5)])
def test_mfn_step_many_matches_vmapped_pallas(shared, nvalid, denom):
    M, n, o = 3, 300, 3
    jm, tm = _mfn()
    pstack, tstack = _jstack(jm, M, 5)
    rng = np.random.default_rng(6)
    lead = () if shared else (M,)
    coords = rng.uniform(-1, 1, lead + (n, 2)).astype(np.float32)
    target = rng.uniform(0, 1, lead + (n, o)).astype(np.float32)
    gt = rng.uniform(0, 1, lead + (n, o)).astype(np.float32)
    ax = None if shared else 0
    spec = _interp(jm)
    pred_k, g_k, (st_k, sg_k) = jax.vmap(
        lambda p, c, t, g: mfn_step_fused(
            p, c, t, spec, nvalid=nvalid, denom=denom, gt=g,
            want_metrics=True, interpret=True),
        in_axes=(0, ax, ax, ax))(pstack, jnp.asarray(coords),
                                 jnp.asarray(target), jnp.asarray(gt))
    pred, grads, (st, sg) = MF.mfn_step_many(
        tstack, torch.tensor(coords), torch.tensor(target), tm.spec,
        nvalid=nvalid, denom=denom, gt=torch.tensor(gt), want_metrics=True)
    assert pred.shape == (M, n, o) and st.shape == (M,)
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_k), **MFN_STEP)
    for got, want in ((st, st_k), (sg, sg_k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4)
    _close_tree(grads, g_k, MFN_STEP["rtol"], MFN_STEP["atol"], "grads")


@pytest.mark.parametrize("shared", [True, False])
def test_mfn_mlp_many_matches_vmapped_pallas(shared):
    M, o = 2, 3
    jm, tm = _mfn(layers=1)
    pstack, tstack = _jstack(jm, M, 7)
    rng = np.random.default_rng(8)
    coords = rng.uniform(-1, 1, (300, 2) if shared else (M, 3, 100, 2)
                         ).astype(np.float32)
    out_shape = (M, 300, o) if shared else (M, 3, 100, o)
    g = rng.normal(size=out_shape).astype(np.float32)
    spec = _interp(jm)
    y_k, vjp = jax.vjp(
        lambda p: jax.vmap(lambda pp, c: mfn_mlp_fused(pp, c, spec, True),
                           in_axes=(0, None if shared else 0))(
            p, jnp.asarray(coords)), pstack)
    (dp_k,) = vjp(jnp.asarray(g))
    keys = [p for p, _ in tree.leaves(tstack)]
    leaves = [tree.get(tstack, k).clone().requires_grad_(True) for k in keys]
    y = MF.mfn_mlp_many(tree.unflatten(keys, leaves), torch.tensor(coords),
                        tm.spec)
    grads = torch.autograd.grad(y, leaves, torch.tensor(g))
    assert y.shape == out_shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_k),
                               **MFN_STEP)
    _close_tree(tree.unflatten(keys, list(grads)), dp_k, MFN_PAIR["rtol"],
                MFN_PAIR["atol"], "grads")


# ---------------------------------------------------------------------------
# the families' replica hooks: the batched fold and the serial calls
# ---------------------------------------------------------------------------

MS = dict(scale=2.0, scale_tensor=(1.0, 4.0))
# family -> factory keywords (every family that folds onto real_step)
FOLDS = {
    "siren": dict(first_omega0=5.0, hidden_omega0=5.0),
    "gauss": dict(scale=3.0),
    "relu": dict(),
    "posenc": dict(sidelength=16),
    "bspline_form": dict(scale=2.0),
    "bspline_cubic": dict(scale=2.0),
    "bspline_srelu": dict(scale=2.0),
    "bspline_knots": dict(),
    "bspline_mscale_1": dict(scaled_hidden_features=12, hidden_layers=3,
                             **MS),
    "bspline_mscale_1_new": dict(scaled_hidden_features=8,
                                 in_features=2 * 2 * 4, **MS),
    "bspline_mscale_repIN": dict(scaled_hidden_features=8,
                                 in_features=2 * 2 * 4, **MS),
    "bspline_mscale_HL": dict(scale=1.0, scale_tensor=(1.0, 2.0),
                              scaled_hidden_features=300, base_split=256),
    "bspline_mscale_hier": dict(scale_tensor=(0.5, 2.0)),
}


def _tfamily(nonlin, M, seed, hf=16, **extra):
    kw = dict(in_features=2, out_features=3, hidden_features=hf,
              hidden_layers=1)
    kw.update(FOLDS.get(nonlin, {}))
    kw.update(extra)
    model = tget_inr(nonlin, **kw)
    stack = tree.stack([model.init(torch.Generator().manual_seed(seed + r))
                        for r in range(M)])
    return model, stack


_CANON_OF = {
    "siren": TM._canon_siren, "gauss": TM._canon_gauss,
    "relu": TM._canon_relu, "posenc": TM._canon_relu,
    "bspline_form": TM._canon_form, "bspline_cubic": TM._canon_cubic,
    "bspline_srelu": TM._canon_srelu, "bspline_knots": TM._canon_knots,
    "bspline_mscale_1": TM._canon_mscale1,
    "bspline_mscale_1_new": TM._canon_repin,
    "bspline_mscale_repIN": TM._canon_repin,
    "bspline_mscale_HL": TM._canon_mscale_hl,
    "bspline_mscale_hier": TM._canon_mscale_hier,
}


@pytest.mark.parametrize("nonlin", sorted(FOLDS))
def test_batched_fold_is_the_serial_fold(nonlin):
    M = 3
    model, stack = _tfamily(nonlin, M, 10)
    canon_of = _CANON_OF[nonlin]
    canon, back = TM.fold_grads_many(canon_of, stack, model.spec)
    rng = np.random.default_rng(11)
    dcanon = tree.map(lambda t: torch.tensor(rng.normal(
        size=tuple(t.shape)).astype(np.float32)), canon)
    grads = back(dcanon)
    assert tree.replicas(canon) == M
    for r in range(M):
        c1, back1 = TM.fold_grads(canon_of, tree.index(stack, r), model.spec)
        _bits_tree(tree.index(canon, r), c1, f"{nonlin} canon {r}")
        _bits_tree(tree.index(grads, r), back1(tree.index(dcanon, r)),
                   f"{nonlin} grads {r}")


@pytest.mark.parametrize("nonlin", sorted(FOLDS) + ["mfn"])
def test_step_and_apply_many_are_the_serial_calls(nonlin):
    """The replica hooks on the CPU (the plain versions of the replica
    kernels, the batched fold): replica r equals the serial call bit for
    bit, on shared and on per-replica coordinates (posenc's encoding and
    repIN's tiling through ``torch.func.vmap`` on the latter)."""
    M, n = 3, 40
    model, stack = _tfamily(nonlin, M, 20)
    assert model._replica.step is not None
    rng = np.random.default_rng(21)
    t = torch.tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    for c in (torch.tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32)),
              torch.tensor(rng.uniform(-1, 1, (M, n, 2)).astype(
                  np.float32))):
        pred, grads, (st, sg) = model.step_grads_many(
            stack, c, t, nvalid=35, gt=t, want_metrics=True)
        for r in range(M):
            cr = tree.replica(c, r, M)
            p1, g1, (st1, sg1) = model.step_grads(
                tree.index(stack, r), cr, t, nvalid=35, gt=t,
                want_metrics=True)
            _bits(pred[r], p1, f"{nonlin} pred")
            _bits_tree(tree.index(grads, r), g1, f"{nonlin} grads")
            _bits(st[r], st1, f"{nonlin} sse")
    if model._replica.apply is None:   # no apply kernel (knots, mscale_1)
        return
    frames = torch.tensor(rng.uniform(-1, 1, (M, 2, 20, 2)).astype(
        np.float32))
    for c in (frames[0, 0], frames):
        leaves = tree.map(lambda x: x.clone().requires_grad_(True), stack)
        y = model.apply_many(leaves, c)
        flat = [v for _, v in tree.leaves(leaves)]
        gs = torch.autograd.grad(y.sum(), flat, allow_unused=True)
        for r in range(M):
            one = tree.map(lambda x: x[r].detach().clone().requires_grad_(
                True), stack)
            y1 = model.apply(one, tree.replica(c, r, M))
            _bits(y[r], y1, f"{nonlin} apply")
            ones = [v for _, v in tree.leaves(one)]
            g1 = torch.autograd.grad(y1.sum(), ones, allow_unused=True)
            for a, b in zip(gs, g1):
                if a is None or b is None:
                    assert a is None and b is None
                else:
                    _bits(a[r], b, f"{nonlin} apply grad")


# ---------------------------------------------------------------------------
# the fitters against wire_tpu's
# ---------------------------------------------------------------------------

FIT_KW = dict(in_features=2, hidden_features=32, hidden_layers=2)
FAMILY_FIT = {"siren": dict(first_omega0=5.0, hidden_omega0=5.0),
              "mfn": dict(), "bspline_form": dict(scale=2.0)}


def _pair(nonlin, out):
    kw = dict(FIT_KW, out_features=out, **FAMILY_FIT[nonlin])
    return get_inr(nonlin, fused="never", **kw), tget_inr(nonlin, **kw)


@pytest.mark.parametrize("nonlin,maxpoints", [("siren", 65536),
                                              ("siren", 100),
                                              ("mfn", 65536)])
def test_fit_pointwise_many_matches_wire_tpu(monkeypatch, nonlin,
                                             maxpoints):
    target, noisy = _denoise_problem()
    M, niters = 3, 5
    jmodel, tmodel = _pair(nonlin, 3)
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


@pytest.mark.parametrize("nonlin", ["bspline_form", "mfn"])
def test_fit_operator_many_sisr_matches_wire_tpu(nonlin):
    M, niters = 2, 6
    ims, lrs = _sisr_problem(M)
    jmodel, tmodel = _pair(nonlin, 3)
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

def _tstack(nonlin, out, M, seed0):
    model = tget_inr(nonlin, **dict(FIT_KW, out_features=out,
                                    **FAMILY_FIT.get(nonlin, {})))
    return model, tree.stack([model.init(torch.Generator().manual_seed(
        seed0 + r)) for r in range(M)])


@pytest.mark.parametrize("nonlin,cfg_kw", [
    ("siren", dict()), ("siren", dict(maxpoints=100)),
    ("mfn", dict()), ("bspline_form", dict(maxpoints=100, block_perm=16))])
def test_fit_pointwise_many_replicas_are_serial_fits(nonlin, cfg_kw):
    target, noisy = _denoise_problem()
    M = 3
    model, stack = _tstack(nonlin, 3, M, 20)
    cfg = T.FitConfig(learning_rate=5e-3, niters=4, seed=5, **cfg_kw)
    many = T.fit_pointwise_many(model, stack, GridSpec(H, W), noisy, cfg,
                                gt=target, device="cpu")
    for r in range(M):
        one = T.fit_pointwise(model, tree.index(stack, r), GridSpec(H, W),
                              noisy, dataclasses.replace(cfg, seed=5 + r),
                              gt=target, device="cpu")
        _same_fit(many, r, one, f"{nonlin} replica {r}")


@pytest.mark.parametrize("nonlin", ["bspline_form", "mfn"])
def test_fit_operator_many_replicas_are_serial_fits(nonlin):
    M = 2
    ims, lrs = _sisr_problem(M)
    model, stack = _tstack(nonlin, 3, M, 30)
    cfg = T.FitConfig(learning_rate=5e-3, niters=5)
    many = T.fit_operator_many(model, stack, JC.grid2d(H, W), lrs[0],
                               DownsampleOp(4), cfg, gt_field=ims[0],
                               field_shape=(H, W, 3), device="cpu")
    for r in range(M):
        one = T.fit_operator(model, tree.index(stack, r), JC.grid2d(H, W),
                             lrs[0], DownsampleOp(4), cfg, gt_field=ims[0],
                             field_shape=(H, W, 3), device="cpu")
        _same_fit(many, r, one, f"{nonlin} replica {r}")


def test_fit_frames_many_gauss_replicas_are_serial_fits():
    M, nframes = 2, 4
    rng = np.random.RandomState(3)
    fc = np.stack([JC.grid2d(H, W)] * nframes).astype(np.float32)
    fp = rng.rand(M, nframes, (H // 2) * (W // 2), 3).astype(np.float32)
    fm = np.ones_like(fp[0])
    model = tget_inr("gauss", **dict(FIT_KW, out_features=3, scale=3.0))
    stack = tree.stack([model.init(torch.Generator().manual_seed(50 + r))
                        for r in range(M)])
    cfg = T.FitConfig(learning_rate=5e-3, niters=3, seed=3)
    many = T.fit_frames_many(model, stack, np.stack([fc] * M), fp,
                             np.stack([fm] * M), cfg, hr_shape=(H, W, 3),
                             scale=2, batch_size=4, batched_frames=True,
                             device="cpu")
    for r in range(M):
        one = T.fit_frames(model, tree.index(stack, r), fc, fp[r], fm,
                           dataclasses.replace(cfg, seed=3 + r),
                           hr_shape=(H, W, 3), scale=2, batch_size=4,
                           device="cpu")
        _same_fit(many, r, one, f"gauss frames replica {r}")


# ---------------------------------------------------------------------------
# the slice whole: the seeds sweeps of the other families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nonlin,task", [
    ("siren", "denoise"), ("mfn", "denoise"), ("posenc", "denoise"),
    ("posenc", "ct"), ("mfn", "sisr"), ("gauss", "sisr")])
def test_seeds_sweeps_match_wire_tpu(monkeypatch, nonlin, task):
    n_seeds, niters = 2, 3
    if task == "denoise":
        kw = dict(size=32, downscale=1, niters=niters)
        _with_jax_stack(monkeypatch, ((nonlin, "denoise", 32, 32, 3e1), {}),
                        0, n_seeds)
        want = JS.sweep_denoise_seeds(nonlin, n_seeds, **kw)
        got = TS.sweep_denoise_seeds(nonlin, n_seeds, device="cpu", **kw)
        key = "psnrs"
    elif task == "ct":
        kw = dict(size=32, nmeas=12, niters=niters)
        _with_jax_stack(monkeypatch, ((nonlin, "ct", 32, 32, 1e2),
                                      dict(out_features=1,
                                           posenc_sidelength=12)),
                        0, n_seeds)
        want = JS.sweep_ct_seeds(nonlin, n_seeds, **kw)
        got = TS.sweep_ct_seeds(nonlin, n_seeds, device="cpu", **kw)
        key = "psnrs"
    else:
        kw = dict(size=48, niters=niters)
        _with_jax_stack(monkeypatch, ((nonlin, "sisr", 16, 16, 1e2), {}),
                        0, n_seeds)
        want = JS.sweep_sisr_seeds(nonlin, n_seeds, **kw)
        got = TS.sweep_sisr_seeds(nonlin, n_seeds, device="cpu", **kw)
        key = "mse_db"
    assert len(got[key]) == n_seeds
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=0.01)
