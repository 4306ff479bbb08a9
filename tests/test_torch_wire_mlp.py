"""The port's WIRE apply (wire_tpu_torch/nn/models.py:wire_apply, the plain
version of ops/wire_mlp.py on CPU tensors) against wire_tpu's
wire_mlp_fused in interpret mode (gemm_precision="highest") and against
wire_tpu's plain wire_apply: forward, parameter gradients and dcoords of a
vector-Jacobian product with a seeded cotangent, from the same bridged
init, at the CT hyperparameters (omega0 = 3, scale 12).

Tolerances are tests/test_pallas_wire.py's, forward rtol 2e-5 / atol
5e-6 and gradients rtol 1e-4 / atol 1e-6, with the gradients' atol scaled
by the tensor's largest entry (1e-6 x max(1, max |ref|)).  That test's
gradients are O(1) at scale 4; at scale 12 (s^2 = 144) they reach ~100,
sums of large terms that cancel, so an entry near zero keeps their
rounding: the two JAX references themselves (interpret mode and the plain
apply) differ by up to 1.3e-6 x max |grad| here."""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.ops.pallas.wire_mlp import wire_mlp_fused

from wire_tpu_torch import bridge
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.ops import wire_mlp as WM


def _hidden_features(h):
    """The smallest hidden_features that gives h complex units."""
    hf = math.ceil(h * math.sqrt(2))
    assert int(hf / math.sqrt(2)) == h
    return hf


def _case(n, h, layers, out, seed):
    kw = dict(in_features=2, out_features=out,
              hidden_features=_hidden_features(h), hidden_layers=layers,
              first_omega0=3.0, hidden_omega0=3.0, scale=12.0)
    jmodel = get_inr("wire", fused="never", **kw)
    params = jmodel.init(jax.random.key(seed))
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    g = rng.normal(size=(n, out)).astype(np.float32)
    return kw, jmodel, params, np_params, coords, g


def _torch_vjp(model, np_params, coords, g):
    params = bridge.params_from_jax(np_params)
    keys = [(k, kk) for k in params for kk in params[k]]
    leaves = [params[k][kk].requires_grad_(True) for k, kk in keys]
    c = torch.tensor(coords, requires_grad=True)
    y = model.apply(params, c)
    grads = torch.autograd.grad(y, leaves + [c], torch.tensor(g),
                                allow_unused=True)
    dparams = {k: {} for k in params}
    for (k, kk), leaf, gr in zip(keys, leaves, grads[:-1]):
        dparams[k][kk] = (torch.zeros_like(leaf) if gr is None else gr)
    return (y.detach().numpy(), bridge.params_to_numpy(dparams),
            grads[-1].numpy())


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _jax_vjp(fn, params, coords, g):
    y, vjp = jax.vjp(fn, params, jnp.asarray(coords))
    dp, dc = vjp(jnp.asarray(g))
    return np.asarray(y), jax.tree.map(np.asarray, dp), np.asarray(dc)


@pytest.mark.parametrize("n,h,layers,out", [
    (300, 16, 1, 1), (517, 40, 2, 1), (333, 16, 2, 3), (600, 40, 1, 3)])
def test_wire_apply_matches_wire_tpu(n, h, layers, out):
    kw, jmodel, params, np_params, coords, g = _case(n, h, layers, out, n)
    tmodel = tget_inr("wire", **kw)
    assert tmodel.spec.fused == "auto"   # the kernel path, plain on the CPU
    got_y, got_dp, got_dc = _torch_vjp(tmodel, np_params, coords, g)

    spec_hi = jmodel.spec.replace(gemm_precision="highest")
    refs = {
        "interpret": _jax_vjp(
            lambda p, c: wire_mlp_fused(p, c, spec_hi, interpret=True),
            params, coords, g),
        "plain": _jax_vjp(lambda p, c: jmodel.apply(p, c), params, coords,
                          g),
    }
    for what, (y, dp, dc) in refs.items():
        np.testing.assert_allclose(got_y, y, rtol=2e-5, atol=5e-6,
                                   err_msg=what)
        _close(got_dc, dc, f"{what} dcoords")
        for k in dp:
            for kk in dp[k]:
                _close(got_dp[k][kk], dp[k][kk], f"{what} {k}.{kk}")
    assert not got_dp["final"]["bi"].any()


def test_fused_never_and_cpu_kernel_path_agree_exactly():
    """On CPU tensors the kernel wrapper IS the plain body."""
    kw, _, _, np_params, coords, _ = _case(200, 16, 2, 1, 3)
    params = bridge.params_from_jax(np_params)
    c = torch.tensor(coords)
    a = tget_inr("wire", **kw).apply(params, c)
    b = tget_inr("wire", fused="never", **kw).apply(params, c)
    d = WM.wire_mlp(params, c, tget_inr("wire", **kw).spec)
    assert torch.equal(a, b) and torch.equal(a, d)


def test_wrapper_refuses_other_devices():
    kw, _, _, np_params, coords, _ = _case(16, 16, 1, 1, 0)
    params = bridge.params_from_jax(np_params)
    with pytest.raises(ValueError, match="unsupported device"):
        WM.wire_mlp(params, torch.tensor(coords, device="meta"),
                    tget_inr("wire", **kw).spec)


def test_apply_flops_counts_the_ct_shape():
    # forward + data gradient + weight gradients + dcoords, 2 per MAC
    n, d, h, o, L = 65536, 2, 212, 1, 2
    flops = WM.apply_flops(n, d, h, o, L)
    assert flops == 2 * n * (3 * L * 424 * 424 + 424 * (1 + 1 + 1) + d * h
                             + (d + 1) * h + d * h + L * 424 + 1)
    assert 139e9 < flops < 143e9


def test_leading_axes_match_wire_tpu():
    """(b, N, d) coordinates give (b, N, o), as wire_tpu's entry flattens
    and restores them (wire_mlp.py:413-419); the CUDA wrapper does the
    same (tests/test_torch_gpu.py)."""
    kw, _, params, np_params, coords, _ = _case(200, 16, 2, 3, 4)
    spec_hi = get_inr("wire", fused="never", **kw).spec.replace(
        gemm_precision="highest")
    want = np.asarray(wire_mlp_fused(params, jnp.asarray(
        coords.reshape(4, 50, 2)), spec_hi, interpret=True))
    got = WM.wire_mlp(bridge.params_from_jax(np_params),
                      torch.tensor(coords).reshape(4, 50, 2),
                      tget_inr("wire", **kw).spec)
    assert got.shape == (4, 50, 3) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=5e-6)
