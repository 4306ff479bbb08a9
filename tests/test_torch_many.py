"""The batched multi-fit of the port (M replicas of one architecture at
once: ``ops/wire_step.py:wire_step_many``, ``ops/wire_mlp.py:
wire_mlp_many``, ``rotate_project`` and ``sample_spectrum`` on a stack,
``radon`` on (M, H, W), ``INR.step_grads_many`` / ``apply_many``, the
trainer's ``fit_pointwise_many``, ``fit_operator_many`` and
``fit_frames_many``, and the sweep's seeds tasks) against wire_tpu's on the
CPU, and each port replica against the port's own serial call.

Every input is drawn from a numpy seed; parameters cross with
``bridge.params_from_jax`` (a replica-stacked tree crosses as it is).

- Kernels' plain versions against ``jax.vmap`` of wire_tpu's functions run
  as tests/test_pallas_*.py run them: ``wire_step_fused`` and
  ``wire_mlp_fused`` in interpret mode at ``gemm_precision="highest"``,
  ``rotate_project`` in interpret mode, the spectrum sampler as the JAX
  composition of tests/test_torch_line_spectrum.py around the Pallas
  ``sample_lines`` in interpret mode.  Tolerances: the step rel 2e-4 /
  atol 1e-6 (tests/test_pallas_step.py's), the pair rel 1e-4 (outputs
  atol 5e-6, gradients atol 1e-6 x max, tests/test_torch_wire_mlp.py's),
  rotate-project rel 2e-5 / atol 2e-5 x S (tests/test_torch_radon.py's),
  the sampler and the FFT Radon methods 1e-5 x max (the two libraries'
  FFTs and phases round apart).
- Fits against wire_tpu's many-fitters at tests/test_trainer.py:473-600's
  sizes (WIRE 32 wide, M 2-3, 5-6 epochs) from one bridged stack, the
  chunked and frame fits on one shared permutation (wire_tpu's through a
  monkeypatch of ``jax.random.permutation`` with its program cache
  emptied, as tests/test_torch_chunked.py does; the port's through the
  ``permutation`` hook), lr 1e-3 at omega0 5 for the reason that file
  gives.  Tolerances as there: histories rel 1e-4, fields rel 1e-4 / atol
  1e-5 (1e-4 for the chunked fields, assembled from many steps),
  parameters rel 1e-4 / atol 5e-5.
- Each port replica against the port's serial fit at ``seed + r`` from the
  same init: bit for bit (the plain step and apply per replica are the
  serial calls, Adam and the best tracking act elementwise, each replica's
  loss is reduced on its own slice).
- The seeds sweeps: wire_tpu's ``sweep_*_seeds`` and the port's at a tiny
  size from wire_tpu's split-key stack moved across (the port's
  ``seed_inits`` replaced by it): per-replica PSNR (SISR: best MSE in dB)
  within 0.01 dB.
"""
import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.apps import sweep as JS
from wire_tpu.nn import get_inr
from wire_tpu.operators.forward import sisr_op as jsisr_op
from wire_tpu.ops.pallas import line_sample as JLS
from wire_tpu.ops.pallas import rotsum as JROT
from wire_tpu.ops.pallas.wire_mlp import wire_mlp_fused
from wire_tpu.ops.pallas.wire_step import wire_step_fused
from wire_tpu.signals import coords as JC
from wire_tpu.signals import image as JI
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge, tree
from wire_tpu_torch.apps import sweep as TS
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.operators import radon as TR
from wire_tpu_torch.operators.forward import DownsampleOp
from wire_tpu_torch.ops import line_sample as LS
from wire_tpu_torch.ops import rotsum as R
from wire_tpu_torch.ops import wire_mlp as WM
from wire_tpu_torch.ops import wire_step as WS
from wire_tpu_torch.signals.coords import GridSpec
from wire_tpu_torch.train import trainer as T

JR = importlib.import_module("wire_tpu.operators.radon")

REL = 1e-4
ANGLES = np.array([0.0, 7.3, 44.9, 90.0, 121.7, 180.0], np.float32)


def _jstack(model, M, seed):
    """wire_tpu's replica stack: ``jax.vmap`` of the init over split keys,
    and the same stack as port tensors."""
    keys = jax.random.split(jax.random.key(seed), M)
    pstack = jax.vmap(lambda k: model._init(k, model.spec))(keys)
    return pstack, bridge.params_from_jax(jax.tree.map(np.asarray, pstack))


def _close_tree(got, want, rtol, atol, what):
    gflat = jax.tree_util.tree_flatten_with_path(
        bridge.params_to_numpy(got))[0]
    wflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    assert [p for p, _ in gflat] == [p for p, _ in wflat]
    for (path, g), (_, w) in zip(gflat, wflat):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


def _bits(a, b, what):
    a, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in (a, b))
    assert a.shape == b.shape and np.array_equal(a, b), what


def _bits_tree(got, want, what):
    gl, wl = tree.leaves(got), tree.leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl], what
    for (path, g), (_, w) in zip(gl, wl):
        _bits(g, w, f"{what} {path}")


# ---------------------------------------------------------------------------
# the kernels' plain versions against jax.vmap of wire_tpu's
# ---------------------------------------------------------------------------

def _wire(h, layers, out, omega=7.0, sigma=8.0, **extra):
    kw = dict(in_features=2, out_features=out,
              hidden_features=int(np.ceil(h * np.sqrt(2))),
              hidden_layers=layers, first_omega0=omega, hidden_omega0=omega,
              scale=sigma, **extra)
    return get_inr("wire", **kw), tget_inr("wire", **kw)


@pytest.mark.parametrize("shared,nvalid,denom", [
    (True, None, None), (False, 170, 777.5), (True, 150, None)])
def test_wire_step_many_matches_vmapped_pallas(shared, nvalid, denom):
    M, n, o = 3, 200, 3
    jmodel, tmodel = _wire(20, 2, o)
    pstack, tstack = _jstack(jmodel, M, 1)
    rng = np.random.default_rng(2)
    lead = () if shared else (M,)
    coords = rng.uniform(-1, 1, lead + (n, 2)).astype(np.float32)
    target = rng.uniform(0, 1, lead + (n, o)).astype(np.float32)
    gt = rng.uniform(0, 1, lead + (n, o)).astype(np.float32)
    spec_hi = jmodel.spec.replace(gemm_precision="highest")
    ax = None if shared else 0
    pred_k, g_k, (st_k, sg_k) = jax.vmap(
        lambda p, c, t, g: wire_step_fused(
            p, c, t, spec_hi, nvalid=nvalid, denom=denom, gt=g,
            want_metrics=True, interpret=True),
        in_axes=(0, ax, ax, ax))(pstack, jnp.asarray(coords),
                                 jnp.asarray(target), jnp.asarray(gt))
    pred, grads, (st, sg) = WS.wire_step_many(
        tstack, torch.tensor(coords), torch.tensor(target), tmodel.spec,
        nvalid=nvalid, denom=denom, gt=torch.tensor(gt), want_metrics=True)
    assert pred.shape == (M, n, o) and st.shape == (M,)
    np.testing.assert_allclose(pred.numpy(), np.asarray(pred_k), rtol=2e-4,
                               atol=1e-6)
    for got, want in ((st, st_k), (sg, sg_k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4)
    _close_tree(grads, g_k, 2e-4, 1e-6, "grads")


@pytest.mark.parametrize("shared", [True, False])
def test_wire_mlp_many_matches_vmapped_pallas(shared):
    M, o = 2, 1
    jmodel, tmodel = _wire(16, 2, o, omega=3.0, sigma=12.0, fused="never")
    tmodel = tget_inr("wire", **{k: getattr(tmodel.spec, k) for k in (
        "in_features", "out_features", "hidden_features", "hidden_layers",
        "first_omega0", "hidden_omega0", "scale")})
    pstack, tstack = _jstack(jmodel, M, 3)
    rng = np.random.default_rng(4)
    coords = rng.uniform(-1, 1, (300, 2) if shared else (M, 3, 100, 2)
                         ).astype(np.float32)
    out_shape = (M, 300, o) if shared else (M, 3, 100, o)
    g = rng.normal(size=out_shape).astype(np.float32)
    spec_hi = jmodel.spec.replace(gemm_precision="highest")
    y_k, vjp = jax.vjp(
        lambda p: jax.vmap(lambda pp, c: wire_mlp_fused(
            pp, c, spec_hi, interpret=True),
            in_axes=(0, None if shared else 0))(p, jnp.asarray(coords)),
        pstack)
    (dp_k,) = vjp(jnp.asarray(g))
    keys = [p for p, _ in tree.leaves(tstack)]
    leaves = [tree.get(tstack, k).clone().requires_grad_(True) for k in keys]
    y = WM.wire_mlp_many(tree.unflatten(keys, leaves), torch.tensor(coords),
                         tmodel.spec)
    grads = torch.autograd.grad(y, leaves, torch.tensor(g),
                                allow_unused=True)
    assert y.shape == out_shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_k),
                               rtol=REL, atol=5e-6)
    for k, gr in zip(keys, grads):
        want = np.asarray(dp_k[k[0]][k[1]])
        got = np.zeros_like(want) if gr is None else gr.numpy()
        np.testing.assert_allclose(got, want, rtol=REL,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=str(k))


def test_rotate_project_stack_matches_vmapped_pallas():
    M, S = 3, 32
    rng = np.random.default_rng(5)
    img = rng.random((M, S, S)).astype(np.float32)
    cot = rng.normal(size=(M, len(ANGLES), S)).astype(np.float32)
    y_k, vjp = jax.vjp(lambda x: jax.vmap(lambda im: JROT.rotate_project(
        im, ANGLES, interpret=True))(x), jnp.asarray(img))
    (g_k,) = vjp(jnp.asarray(cot))
    x = torch.tensor(img, requires_grad=True)
    y = R.rotate_project(x, ANGLES)
    (g,) = torch.autograd.grad(y, x, torch.tensor(cot))
    assert y.shape == (M, len(ANGLES), S)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_k),
                               rtol=2e-5, atol=2e-5 * S)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_k), rtol=2e-5,
                               atol=2e-5 * S)
    for r in range(M):   # the stack's plain version is the per-image one
        _bits(y[r], R.rotate_project(torch.tensor(img[r]), ANGLES),
              f"replica {r}")


def _jax_spectrum_slice(P, gy, gx):
    """(re, im) of one unshifted spectrum -> (re, im) of its slice, in JAX:
    wire_tpu/operators/radon.py:_radon_fourier's shift, centring phase and
    wrap halo around the Pallas ``sample_lines`` in interpret mode."""
    c = (P - 1) / 2.0

    def fn(fr, fi):
        F = jnp.fft.fftshift(jax.lax.complex(fr, fi))
        f = ((jnp.arange(P) - P // 2) / P).astype(jnp.float32)
        F = F * jnp.exp(2j * jnp.pi * (f[:, None] + f[None, :]) * c)
        Fh = jnp.pad(F, ((0, 2), (0, 2)), mode="wrap")
        sre, sim = JLS.sample_lines(jnp.real(Fh), jnp.imag(Fh), gy, gx,
                                    True)
        kx = jnp.fft.rfftfreq(P).astype(jnp.float32)
        s = jax.lax.complex(sre, sim) * jnp.exp(-2j * jnp.pi * kx * c)[None]
        return jnp.real(s), jnp.imag(s)
    return fn


def test_sample_spectrum_stack_matches_vmapped_pallas():
    M, P = 2, 32
    rng = np.random.default_rng(6)
    centre, gy, gx, uncentre = TR._fourier_consts(P, ANGLES, "cpu")
    fr, fi, cr, ci = (rng.normal(size=shape).astype(np.float32)
                      for shape in ((M, P, P), (M, P, P),
                                    (M,) + tuple(gy.shape),
                                    (M,) + tuple(gy.shape)))
    a = torch.tensor(fr, requires_grad=True)
    b = torch.tensor(fi, requires_grad=True)
    s = LS.sample_spectrum(torch.complex(a, b), centre, gy, gx, uncentre)
    got = (s.real, s.imag)
    grads = torch.autograd.grad(got, (a, b),
                                (torch.tensor(cr), torch.tensor(ci)))
    fn = _jax_spectrum_slice(P, jnp.asarray(gy.numpy()),
                             jnp.asarray(gx.numpy()))
    want, vjp = jax.vjp(jax.vmap(fn), jnp.asarray(fr), jnp.asarray(fi))
    for g_, w in list(zip(got, want)) + list(zip(
            grads, vjp((jnp.asarray(cr), jnp.asarray(ci))))):
        w = np.asarray(w)
        np.testing.assert_allclose(g_.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("method", ["rotate", "rotate_xla", "fourier",
                                    "shear"])
def test_radon_of_a_stack_matches_radon_batch(method):
    M, S = 3, 32
    rng = np.random.default_rng(7)
    imgs = rng.random((M, S, S)).astype(np.float32)
    cot = rng.normal(size=(M, len(ANGLES), S)).astype(np.float32)
    jm = "rotate_xla" if method == "rotate" else method
    want, vjp = jax.vjp(lambda x: JR.radon_batch(x, jnp.asarray(ANGLES),
                                                 method=jm),
                        jnp.asarray(imgs))
    (gwant,) = vjp(jnp.asarray(cot))
    x = torch.tensor(imgs, requires_grad=True)
    got = TR.radon_batch(x, ANGLES, method=method)
    (g,) = torch.autograd.grad(got, x, torch.tensor(cot))
    assert got.shape == (M, len(ANGLES), S)
    for a, w in ((got.detach(), want), (g, gwant)):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    # one call on the stack is each image's own call
    for r in range(M):
        one = TR.radon(torch.tensor(imgs[r]), ANGLES, method=method)
        np.testing.assert_allclose(got[r].detach().numpy(), one.numpy(),
                                   rtol=0, atol=1e-6 * float(
                                       one.abs().max()))


def test_downsample_operators_take_a_replica_axis():
    rng = np.random.default_rng(8)
    f = torch.tensor(rng.random((3, 16, 12, 3)).astype(np.float32))
    op = DownsampleOp(4)
    got = op(f)
    assert got.shape == (3, 4, 3, 3)
    for r in range(3):
        _bits(got[r], op(f[r]), f"replica {r}")
        np.testing.assert_allclose(
            got[r].numpy(), np.asarray(jsisr_op(jnp.asarray(f[r].numpy()),
                                                4)), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the layers' contracts
# ---------------------------------------------------------------------------

def test_tree_stack_index_and_bridge_of_a_stack():
    _, tmodel = _wire(8, 1, 3)
    reps = [tmodel.init(torch.Generator().manual_seed(s)) for s in range(3)]
    stack = tree.stack(reps)
    assert tree.replicas(stack) == 3
    for r, one in enumerate(tree.unstack(stack)):
        _bits_tree(one, reps[r], f"unstack {r}")
        _bits_tree(tree.index(stack, r), reps[r], f"index {r}")
    crossed = bridge.params_from_jax(bridge.params_to_numpy(stack))
    _bits_tree(crossed, stack, "bridge")
    bad = tree.map(lambda x: x, stack)
    bad["first"]["w"] = bad["first"]["w"][:2]
    with pytest.raises(ValueError, match="one leading axis"):
        tree.replicas(bad)


def test_replicas_share_one_sentinel_tail():
    assert WS.shared_nvalid(None, 3) is None
    assert WS.shared_nvalid(7, 3) == 7
    assert WS.shared_nvalid([5, 5, 5], 3) == 5
    with pytest.raises(ValueError, match="nvalid differ"):
        WS.shared_nvalid(np.array([5, 6, 5]), 3)


def test_step_and_apply_many_are_the_serial_calls_on_the_cpu():
    """Every family on the CPU, WIRE through its plain versions: replica r
    of the batched call equals the serial call bit for bit."""
    rng = np.random.default_rng(9)
    c = torch.tensor(rng.uniform(-1, 1, (3, 40, 2)).astype(np.float32))
    t = torch.tensor(rng.uniform(0, 1, (40, 3)).astype(np.float32))
    for nonlin in ("wire", "siren", "mfn", "wire2d", "bspline_form"):
        model = tget_inr(nonlin, in_features=2, out_features=3,
                         hidden_features=16, hidden_layers=1)
        stack = tree.stack([model.init(torch.Generator().manual_seed(s))
                            for s in range(3)])
        pred, grads, (st, sg) = model.step_grads_many(
            stack, c, t, nvalid=35, gt=t, want_metrics=True)
        y = model.apply_many(stack, c)
        for r in range(3):
            p1, g1, (st1, sg1) = model.step_grads(
                tree.index(stack, r), c[r], t, nvalid=35, gt=t,
                want_metrics=True)
            _bits(pred[r], p1, f"{nonlin} pred")
            _bits_tree(tree.index(grads, r), g1, f"{nonlin} grads")
            _bits(st[r], st1, f"{nonlin} sse")
            _bits(y[r], model.apply(tree.index(stack, r), c[r]),
                  f"{nonlin} apply")


def test_wire_replicas_on_the_cpu_take_the_replica_wrappers(monkeypatch):
    """WIRE's replica calls on CPU tensors go through the ops' replica
    wrappers, whose plain versions are the CPU path (no second loop in
    the model)."""
    _, tmodel = _wire(8, 1, 3)
    stack = tree.stack([tmodel.init(torch.Generator().manual_seed(s))
                        for s in range(2)])
    seen = []
    step_plain, mlp_plain = WS.wire_step_many_plain, WM.wire_mlp_many_plain

    def spy_step(*a, **k):
        seen.append("step")
        return step_plain(*a, **k)

    def spy_mlp(*a, **k):
        seen.append("apply")
        return mlp_plain(*a, **k)

    monkeypatch.setattr(WS, "wire_step_many_plain", spy_step)
    monkeypatch.setattr(WM, "wire_mlp_many_plain", spy_mlp)
    c, t = torch.zeros(10, 2), torch.zeros(10, 3)
    assert tmodel.step_grads_many(stack, c, t)[0].shape == (2, 10, 3)
    assert tmodel.apply_many(stack, c).shape == (2, 10, 3)
    assert seen == ["step", "apply"]


@pytest.mark.parametrize("nonlin", ["wire", "siren"])
def test_a_per_replica_tensor_needs_the_replica_axis(nonlin):
    """Shared rows are 2-D; any other coordinates, targets or gt are per
    replica and must lead with M: a shared batch of 2 frames given to 3
    replicas raises on the CPU (WIRE's plain versions and the other
    families' loop) as the CUDA wrappers do."""
    model = tget_inr(nonlin, in_features=2, out_features=3,
                     hidden_features=16, hidden_layers=1)
    stack = tree.stack([model.init(torch.Generator().manual_seed(s))
                        for s in range(3)])
    frames, t = torch.zeros(2, 10, 2), torch.zeros(10, 3)
    with pytest.raises(ValueError, match="leading axis 3"):
        model.apply_many(stack, frames)
    with pytest.raises(ValueError, match="leading axis 3"):
        model.step_grads_many(stack, frames, t)
    with pytest.raises(ValueError, match="leading axis 3"):
        model.step_grads_many(stack, frames[0], torch.zeros(2, 10, 3))
    assert tree.replica(None, 1, 3) is None
    assert tree.replica(t, 1, 3) is t


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("nonlin,item,extra", [
    ("wire2d", "5c", {}),
    ("bspline_mscale_2", "5c", dict(scale_tensor=(1.0, 2.0))),
    ("realgabor", "5d", {}), ("bspline_sig", "5d", {}),
    ("siren", "5d", dict(fused="never"))])
def test_other_families_refuse_replicas_on_the_card(monkeypatch, nonlin,
                                                    item, extra):
    """Every family reaches a batched route on the card (ROADMAP.md §A
    items 5c and 5d): WIRE-2D's and mscale_2's calls (5c) go
    to their replica kernels' launches with reps M (spied, no kernel runs;
    mscale_2's apply to the real_mlp pair's replica forward), the autodiff
    families' (5d: realgabor, bspline_sig, any family at fused='never') to
    autodiff_step_many of vmap_apply of the family's own apply, and no
    kernel library is loaded."""
    from wire_tpu_torch.nn import models as MM
    from wire_tpu_torch.ops import build
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops import wire2d as W2
    M = 2
    model = tget_inr(nonlin, in_features=2, out_features=3,
                     hidden_features=16, hidden_layers=1, **extra)
    stack = tree.stack([model.init(torch.Generator().manual_seed(s))
                        for s in range(M)])
    c = torch.zeros(10, 2).as_subclass(_OnCuda)
    t = torch.zeros(10, 3).as_subclass(_OnCuda)
    seen = {}

    def no_library(name):
        raise AssertionError(f"the {name} library was loaded")

    monkeypatch.setattr(build, "load", no_library)
    if item == "5d":
        def spy_autodiff(apply_many, ps, coords, target, spec, **kw):
            seen["step"] = (tree.replicas(ps), tuple(coords.shape))
            return "step"

        def spy_vmap(apply_fn):
            seen["vmap"] = apply_fn
            return lambda ps, coords, spec: "apply"

        monkeypatch.setattr(MM, "autodiff_step_many", spy_autodiff)
        monkeypatch.setattr(MM, "vmap_apply", spy_vmap)
        assert model.apply_many(stack, c) == "apply"
        assert seen["vmap"] is model._apply
        assert model.step_grads_many(stack, c, t) == "step"
        assert seen["step"] == (M, (10, 2))
        return

    def spy_step(*args, reps=None):
        # wire2d: (params, coords, ...); mscale_2: (canon, combiner,
        # coords, ...)
        trees = args[:1 if nonlin == "wire2d" else 2]
        coords = args[len(trees)]
        seen["step"] = (reps, tuple(coords.shape),
                        {x.shape[0] for tr in trees
                         for _, x in tree.leaves(tr)})
        return (torch.zeros(reps, coords.shape[-2], 3),
                *[tree.map(torch.zeros_like, tr) for tr in trees])

    def spy_nograd(params, coords, *rest, keep, reps=None):
        seen["apply"] = (reps, tuple(coords.shape), keep)
        out = torch.zeros(reps, coords.shape[-2], 3)
        return (out, None, None)

    if nonlin == "wire2d":
        monkeypatch.setattr(W2, "_launch_step", spy_step)
        monkeypatch.setattr(W2, "_forward", spy_nograd)
        rows = 10
    else:
        monkeypatch.setattr(MS, "_launch", spy_step)
        monkeypatch.setattr(RM, "_forward", spy_nograd)
        rows = 10 * len(extra["scale_tensor"])  # the trunk at every scale
    pred, grads = model.step_grads_many(stack, c, t, nvalid=[8, 8])
    assert seen["step"] == (M, (10, 2), {M}) and pred.shape == (M, 10, 3)
    _bits_tree(grads, tree.map(torch.zeros_like, stack), "grads")
    with torch.no_grad():
        y = model.apply_many(stack, c)
    assert seen["apply"] == (M, (rows, 2), False) and y.shape == (M, 10, 3)


def test_wire_replicas_on_the_card_take_the_kernels(monkeypatch):
    """WIRE's replica calls on a CUDA tensor go to the replica kernels'
    launches (spied, no kernel runs) with the stacked layout's shapes; the
    pair refuses coordinates that require a gradient; fused='never' takes
    vmap_apply of the plain apply (spied), not a kernel and not a loop of
    single calls."""
    _, tmodel = _wire(8, 2, 3)
    stack = tree.stack([tmodel.init(torch.Generator().manual_seed(s))
                        for s in range(3)])
    seen = {}

    def spy_step(params, coords, target, spec, nvalid, denom, gt, wm,
                 scratch, reps=None):
        seen["step"] = (reps, tuple(coords.shape), nvalid)
        return "step"

    def spy_nograd(params, coords, spec, reps=None):
        seen["apply"] = (reps, tuple(coords.shape))
        return torch.zeros(reps, coords.shape[-2], 3)

    def spy_pair(coords, spec, keys, reps, *leaves):
        seen["pair"] = (reps, tuple(coords.shape), len(keys) == len(leaves))
        return torch.zeros(reps, coords.shape[-2], 3)

    monkeypatch.setattr(WS, "_launch", spy_step)
    monkeypatch.setattr(WM, "_forward_nograd", spy_nograd)
    monkeypatch.setattr(WM._WireMLP, "apply", spy_pair)
    c = torch.zeros(3, 2, 10, 2).as_subclass(_OnCuda)
    t = torch.zeros(10, 3).as_subclass(_OnCuda)
    assert tmodel.step_grads_many(stack, c[:, 0], t, nvalid=[8, 8, 8]) \
        == "step"
    assert seen["step"] == (3, (3, 10, 2), 8)
    with torch.no_grad():
        y = tmodel.apply_many(stack, c)
    assert seen["apply"] == (3, (3, 20, 2)) and y.shape == (3, 2, 10, 3)
    # shared coordinates: (rows, d) -> (M, rows, o), the pair with a
    # parameter that needs a gradient
    grad_stack = tree.map(lambda x: x.clone().requires_grad_(True), stack)
    y = tmodel.apply_many(grad_stack, c[0, 0])
    assert seen["pair"] == (3, (10, 2), True) and y.shape == (3, 10, 3)
    with pytest.raises(ValueError, match="no coordinate gradient"):
        WM.wire_mlp_many(stack, c.clone().requires_grad_(True), tmodel.spec)
    never = tget_inr("wire", **dict(
        in_features=2, out_features=3, hidden_features=12, hidden_layers=2,
        fused="never"))
    from wire_tpu_torch.nn import models as MM
    monkeypatch.setattr(MM, "vmap_apply", lambda fn: (
        lambda ps, coords, spec: seen.setdefault("vmap", (fn, spec))))
    never.apply_many(stack, c)
    assert seen["vmap"] == (never._apply, never.spec)


@pytest.mark.parametrize("nonlin", ["siren", "mfn", "relu", "bspline_form"])
def test_real_and_mfn_replicas_on_the_card_take_the_kernels(monkeypatch,
                                                            nonlin):
    """The real families' and the MFN's replica calls on a CUDA tensor go
    to their replica kernels' launches (spied, no kernel runs) with the
    stacked layout's shapes: ``real_step``/``mfn_step`` with reps M, the
    pair with a parameter that needs a gradient, the forward that keeps
    nothing without one; the stacked fold is the canonical leaves with a
    leading M."""
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import real_mlp as RM
    model = tget_inr(nonlin, in_features=2, out_features=3,
                     hidden_features=16, hidden_layers=1)
    M = 3
    stack = tree.stack([model.init(torch.Generator().manual_seed(s))
                        for s in range(M)])
    mod = MF if nonlin == "mfn" else RM
    seen = {}

    def spy_step(params, coords, target, *rest, reps=None):
        leaves = tree.leaves(params)
        seen["step"] = (reps, tuple(coords.shape),
                        {t.shape[0] for _, t in leaves})
        return (torch.zeros(reps, coords.shape[-2], 3),
                tree.map(torch.zeros_like, params))

    def spy_nograd(params, coords, *rest, keep, reps=None):
        seen["apply"] = (reps, tuple(coords.shape), keep)
        return torch.zeros(reps, coords.shape[-2], 3), None, None

    def spy_pair(coords, *rest):
        # _RealMLP.apply(coords, kinds, row_gamma, reps, *leaves),
        # _MfnMLP.apply(coords, paths, reps, *leaves)
        seen["pair"] = (rest[1 if nonlin == "mfn" else 2],
                        tuple(coords.shape))
        return torch.zeros(M, coords.shape[-2], 3)

    monkeypatch.setattr(mod, "_launch_step", spy_step)
    monkeypatch.setattr(mod, "_forward", spy_nograd)
    monkeypatch.setattr(mod._MfnMLP if nonlin == "mfn" else mod._RealMLP,
                        "apply", spy_pair)
    c = torch.zeros(M, 2, 10, 2).as_subclass(_OnCuda)
    t = torch.zeros(10, 3).as_subclass(_OnCuda)
    pred, grads = model.step_grads_many(stack, c[:, 0], t, nvalid=[8, 8, 8])
    assert seen["step"] == (M, (M, 10, 2), {M})
    assert pred.shape == (M, 10, 3)
    _bits_tree(grads, tree.map(torch.zeros_like, stack), "grads")
    with torch.no_grad():
        y = model.apply_many(stack, c)
    assert seen["apply"] == (M, (M, 20, 2), False)
    assert y.shape == (M, 2, 10, 3)
    grad_stack = tree.map(lambda x: x.clone().requires_grad_(True), stack)
    y = model.apply_many(grad_stack, c[0, 0])
    assert seen["pair"] == (M, (10, 2)) and y.shape == (M, 10, 3)
    with pytest.raises(ValueError, match="no coordinate gradient"):
        model.apply_many(stack, c.clone().requires_grad_(True))


# ---------------------------------------------------------------------------
# the fitters against wire_tpu's
# ---------------------------------------------------------------------------

H = W = 16
FIT_KW = dict(in_features=2, hidden_features=32, hidden_layers=2,
              first_omega0=5.0, hidden_omega0=5.0, scale=2.0)


def _denoise_problem():
    im = JI.synthetic_image(H, W, 3, seed=0)
    target = im.reshape(-1, 3)
    noisy = target + 0.05 * np.random.RandomState(1).randn(
        *target.shape).astype(np.float32)
    return target, noisy


def _perm(n, seed):
    return np.random.default_rng(seed).permutation(n).astype(np.int32)


def _fixed_permutation(monkeypatch, perm):
    monkeypatch.setattr(JT, "_PROGRAMS", {})
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n, *a, **k: jnp.asarray(perm))
    return lambda n, r: torch.as_tensor(perm.astype(np.int64))


def _assert_fit(got, want, M, niters, field_atol=1e-5):
    assert got.mse_gt.shape == (niters, M) and got.best_mse.shape == (M,)
    np.testing.assert_allclose(got.mse_gt, want.mse_gt, rtol=REL)
    np.testing.assert_allclose(got.mse_noisy, want.mse_noisy, rtol=REL)
    np.testing.assert_allclose(got.best_mse, np.asarray(want.best_mse),
                               rtol=REL)
    if want.best_rec is not None:
        np.testing.assert_allclose(got.best_rec, np.asarray(want.best_rec),
                                   rtol=REL, atol=field_atol)
    _close_tree(got.params, want.params, REL, 5e-5, "params")
    _close_tree(got.best_params, want.best_params, REL, 5e-5, "best_params")


@pytest.mark.parametrize("maxpoints", [65536, 100])
def test_fit_pointwise_many_matches_wire_tpu(monkeypatch, maxpoints):
    target, noisy = _denoise_problem()
    M, niters = 3, 5
    jmodel = get_inr("wire", out_features=3, fused="never", **FIT_KW)
    tmodel = tget_inr("wire", out_features=3, **FIT_KW)
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
    np.testing.assert_allclose(got.final_rec, np.asarray(want.final_rec),
                               rtol=REL, atol=1e-4)


def _sisr_problem(M):
    ims = np.stack([JI.synthetic_image(H, W, 3, seed=s) for s in range(M)])
    lrs = np.stack([np.asarray(jsisr_op(jnp.asarray(im), 4)) for im in ims])
    return ims, lrs


@pytest.mark.parametrize("batched", [False, True])
def test_fit_operator_many_sisr_matches_wire_tpu(batched):
    M, niters = 2, 6
    ims, lrs = _sisr_problem(M)
    jmodel = get_inr("wire", out_features=3, fused="never", **FIT_KW)
    tmodel = tget_inr("wire", out_features=3, **FIT_KW)
    pstack, tstack = _jstack(jmodel, M, 7)
    meas, gtf = (lrs, ims) if batched else (lrs[0], ims[0])
    cfg = dict(learning_rate=1e-3, niters=niters)
    want = JT.fit_operator_many(jmodel, pstack, JC.grid2d(H, W), meas,
                                lambda f: jsisr_op(f, 4), JT.FitConfig(**cfg),
                                gt_field=gtf, field_shape=(H, W, 3),
                                batched_measurement=batched)
    got = T.fit_operator_many(tmodel, tstack, JC.grid2d(H, W), meas,
                              DownsampleOp(4), T.FitConfig(**cfg),
                              gt_field=gtf, field_shape=(H, W, 3),
                              batched_measurement=batched, device="cpu")
    _assert_fit(got, want, M, niters)


def test_fit_operator_many_ct_rotate_matches_wire_tpu():
    M, niters = 2, 5
    img = JI.synthetic_image(H, W, 1, seed=2)[..., 0]
    kw = dict(FIT_KW, first_omega0=3.0, hidden_omega0=3.0, scale=12.0)
    jmodel = get_inr("wire", out_features=1, fused="never", **kw)
    tmodel = tget_inr("wire", out_features=1, **kw)
    pstack, tstack = _jstack(jmodel, M, 9)
    jop = JR.RadonOp(jnp.asarray(ANGLES), method="rotate_xla")
    sino = np.asarray(jop(jnp.asarray(img)))
    cfg = dict(learning_rate=5e-3, niters=niters)
    want = JT.fit_operator_many(jmodel, pstack, JC.grid2d(H, W), sino, jop,
                                JT.FitConfig(**cfg), gt_field=img,
                                field_shape=(H, W))
    got = T.fit_operator_many(tmodel, tstack, JC.grid2d(H, W), sino,
                              TR.RadonOp(ANGLES, method="rotate_xla"),
                              T.FitConfig(**cfg), gt_field=img,
                              field_shape=(H, W), device="cpu")
    _assert_fit(got, want, M, niters)


def _frames_problem(M):
    rng = np.random.RandomState(3)
    nframes = 6
    fc = np.stack([JC.grid2d(H, W)] * nframes).astype(np.float32)
    fp = rng.rand(M, nframes, (H // 2) * (W // 2), 3).astype(np.float32)
    return fc, fp, np.ones_like(fp[0])


@pytest.mark.parametrize("batched", [False, True])
def test_fit_frames_many_matches_wire_tpu(monkeypatch, batched):
    M, niters = 2, 5
    fc, fp, fm = _frames_problem(M)
    jmodel = get_inr("wire", out_features=3, fused="never", **FIT_KW)
    tmodel = tget_inr("wire", out_features=3, **FIT_KW)
    pstack, tstack = _jstack(jmodel, M, 11)
    order = np.array([4, 0, 5, 2, 1, 3], np.int32)
    permutation = _fixed_permutation(monkeypatch, order)
    frames = ((np.stack([fc] * M), fp, np.stack([fm] * M)) if batched
              else (fc, fp[0], fm))
    cfg = dict(learning_rate=1e-3, niters=niters, lr_decay=0.2)
    want = JT.fit_frames_many(jmodel, pstack, *frames, JT.FitConfig(**cfg),
                              hr_shape=(H, W, 3), scale=2, batch_size=4,
                              batched_frames=batched)
    got = T.fit_frames_many(tmodel, tstack, *frames, T.FitConfig(**cfg),
                            hr_shape=(H, W, 3), scale=2, batch_size=4,
                            batched_frames=batched, device="cpu",
                            permutation=permutation)
    assert got.best_rec is None and got.final_rec is None
    _assert_fit(got, want, M, niters)


# ---------------------------------------------------------------------------
# replica r of the port's fits is the port's serial fit at seed + r
# ---------------------------------------------------------------------------

def _tstack(out, M, seed0):
    model = tget_inr("wire", out_features=out, **FIT_KW)
    return model, tree.stack([model.init(torch.Generator().manual_seed(
        seed0 + r)) for r in range(M)])


def _same_fit(many, r, one, what):
    for name in ("mse_gt", "mse_noisy"):
        _bits(getattr(many, name)[:, r], getattr(one, name),
              f"{what} {name}")
    _bits(many.best_mse[r], np.float32(one.best_mse), f"{what} best_mse")
    for name in ("best_rec", "final_rec"):
        if getattr(one, name) is not None:
            _bits(getattr(many, name)[r], getattr(one, name),
                  f"{what} {name}")
    _bits_tree(tree.index(many.params, r), one.params, f"{what} params")
    _bits_tree(tree.index(many.best_params, r), one.best_params,
               f"{what} best_params")


@pytest.mark.parametrize("cfg_kw", [
    dict(), dict(maxpoints=100), dict(maxpoints=100, sort_chunks=True),
    dict(maxpoints=100, block_perm=16)])
def test_fit_pointwise_many_replicas_are_serial_fits(cfg_kw):
    target, noisy = _denoise_problem()
    M = 3
    model, stack = _tstack(3, M, 20)
    cfg = T.FitConfig(learning_rate=5e-3, niters=4, seed=5, **cfg_kw)
    many = T.fit_pointwise_many(model, stack, GridSpec(H, W), noisy, cfg,
                                gt=target, device="cpu")
    for r in range(M):
        one = T.fit_pointwise(model, tree.index(stack, r), GridSpec(H, W),
                              noisy, dataclasses.replace(cfg, seed=5 + r),
                              gt=target, device="cpu")
        _same_fit(many, r, one, f"replica {r}")


@pytest.mark.parametrize("batched", [False, True])
def test_fit_operator_many_replicas_are_serial_fits(batched):
    M = 3
    ims, lrs = _sisr_problem(M)
    model, stack = _tstack(3, M, 30)
    cfg = T.FitConfig(learning_rate=5e-3, niters=5)
    many = T.fit_operator_many(
        model, stack, JC.grid2d(H, W), lrs if batched else lrs[0],
        DownsampleOp(4), cfg, gt_field=ims if batched else ims[0],
        field_shape=(H, W, 3), batched_measurement=batched, device="cpu")
    for r in range(M):
        pick = r if batched else 0
        one = T.fit_operator(model, tree.index(stack, r), JC.grid2d(H, W),
                             lrs[pick], DownsampleOp(4), cfg,
                             gt_field=ims[pick], field_shape=(H, W, 3),
                             device="cpu")
        _same_fit(many, r, one, f"replica {r}")


@pytest.mark.parametrize("batched", [False, True])
def test_fit_frames_many_replicas_are_serial_fits(batched):
    M = 2
    fc, fp, fm = _frames_problem(M)
    model, stack = _tstack(3, M, 40)
    cfg = T.FitConfig(learning_rate=5e-3, niters=4, seed=3)
    frames = ((np.stack([fc] * M), fp, np.stack([fm] * M)) if batched
              else (fc, fp[0], fm))
    many = T.fit_frames_many(model, stack, *frames, cfg, hr_shape=(H, W, 3),
                             scale=2, batch_size=4, batched_frames=batched,
                             device="cpu")
    for r in range(M):
        one = T.fit_frames(model, tree.index(stack, r), fc,
                           fp[r] if batched else fp[0], fm,
                           dataclasses.replace(cfg, seed=3 + r),
                           hr_shape=(H, W, 3), scale=2, batch_size=4,
                           device="cpu")
        _same_fit(many, r, one, f"replica {r}")


def test_many_fitters_refuse_what_they_do_not_take():
    model, stack = _tstack(3, 2, 0)
    target, noisy = _denoise_problem()
    with pytest.raises(ValueError, match="track"):
        T.fit_pointwise_many(model, stack, GridSpec(H, W), noisy,
                             T.FitConfig(niters=1), track="loss",
                             device="cpu")
    ims, lrs = _sisr_problem(3)
    with pytest.raises(ValueError, match="batched_measurement"):
        T.fit_operator_many(model, stack, JC.grid2d(H, W), lrs,
                            DownsampleOp(4), T.FitConfig(niters=1),
                            gt_field=ims, field_shape=(H, W, 3),
                            batched_measurement=True, device="cpu")


# ---------------------------------------------------------------------------
# the slice whole: the seeds sweeps
# ---------------------------------------------------------------------------

def _with_jax_stack(monkeypatch, jbuild_args, seed0, n_seeds):
    """Replace the port's ``seed_inits`` by wire_tpu's split-key stack of
    the same family, moved across."""
    jmodel = JS._build(*jbuild_args[0], **jbuild_args[1])
    _, tstack = _jstack(jmodel, n_seeds, seed0)
    monkeypatch.setattr(TS, "seed_inits", lambda model, n, s, dev: tstack)


@pytest.mark.parametrize("task", ["denoise", "ct", "sisr"])
def test_seeds_sweeps_match_wire_tpu(monkeypatch, task):
    n_seeds, niters = 2, 3
    if task == "denoise":
        kw = dict(size=32, downscale=1, niters=niters)
        _with_jax_stack(monkeypatch, (("wire", "denoise", 32, 32, 3e1), {}),
                        0, n_seeds)
        want = JS.sweep_denoise_seeds("wire", n_seeds, **kw)
        got = TS.sweep_denoise_seeds("wire", n_seeds, device="cpu", **kw)
        key = "psnrs"
    elif task == "ct":
        kw = dict(size=32, nmeas=12, niters=niters)
        _with_jax_stack(monkeypatch, (("wire", "ct", 32, 32, 1e2),
                                      dict(out_features=1,
                                           posenc_sidelength=12)),
                        0, n_seeds)
        want = JS.sweep_ct_seeds("wire", n_seeds, **kw)
        got = TS.sweep_ct_seeds("wire", n_seeds, device="cpu", **kw)
        key = "psnrs"
    else:
        kw = dict(size=48, niters=niters)
        _with_jax_stack(monkeypatch, (("wire", "sisr", 16, 16, 1e2), {}),
                        0, n_seeds)
        want = JS.sweep_sisr_seeds("wire", n_seeds, **kw)
        got = TS.sweep_sisr_seeds("wire", n_seeds, device="cpu", **kw)
        key = "mse_db"
    assert len(got[key]) == n_seeds and got["step_ms"] is None
    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=0.01)
    assert got["recs"].shape == np.asarray(want["recs"]).shape


def test_seed_inits_are_independent_split_draws():
    model = TS._build("wire", "denoise", 32, 32, 3e1)
    stack = TS.seed_inits(model, 3, 0, "cpu")
    again = TS.seed_inits(model, 3, 0, "cpu")
    _bits_tree(stack, again, "seed_inits repeats")
    w = stack["first"]["w"]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    # split draws: replica 0 is not the single-seed sweep's seed-0 init
    single = model.init(torch.Generator().manual_seed(0), "cpu")
    assert not torch.equal(w[0], single["first"]["w"])
