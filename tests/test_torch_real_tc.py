"""The canonical real MLP on the tensor cores (csrc/real_mlp.cu on
csrc/real_tc.cuh), on the CPU: the plain model of its hidden products
(ops/wire_mlp.py: tf32_round, matmul_3xtf32_plain) in one B-spline layer,
forward and backward, against the float64 layer; a plain model of its
dcoords kernel's fixed column order against real_mlp_plain's coordinate
gradient; and the `part` workspace the library asks for (real_mlp.cu built
for the host by tools/host_rehearse.py) against what the step's SSE sums,
weight gradients and column sums write, with the step run there."""
import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from wire_tpu_torch.nn import models as MM
from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.ops import real_mlp as RM
from wire_tpu_torch.ops import wire_mlp as WM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 4096
REL = 1e-4


def _bspline_layer(direction, matmul, dtype, seed=0):
    """Layer 1 of a B-spline denoise model (2 -> 256 -> 256, qspline, the
    preset's alpha = 9.5, the port's seeded init, folded as the kernels take
    it): the forward z = a_0 W_1, a_1 = B(alpha (z) + beta), or the backward
    from a unit-normal da_1: dv = dB(v) da_1, da_0 = dv (W_1 diag
    alpha)^T, dW_1 = a_0^T (dv diag alpha); the products by ``matmul`` in
    ``dtype``.  a_0, z and da_1 are float32, formed once."""
    model = get_inr("bspline_form", in_features=2, out_features=3,
                    hidden_features=256, hidden_layers=2, scale=1 / 9.5)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    canon = MM._canon_form(params, model.spec)
    l0, l1 = canon["layers"][:2]
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1, 1, (N_ROWS, 2)).astype(np.float32))
    a0 = RM.basis(l0["alpha"] * (x @ l0["w"]) + l0["beta"], "qspline")
    z = a0 @ l1["w"]
    da1 = torch.tensor(rng.normal(size=z.shape).astype(np.float32))

    def t(v):
        return v.to(dtype)
    _, dB = RM._basis("qspline")
    al, be = t(l1["alpha"]), t(l1["beta"])
    if direction == "forward":
        zv = matmul(t(a0), t(l1["w"]))
        return {"z": zv, "a1": RM.basis(al * zv + be, "qspline")}
    dv = dB(al * t(z) + be) * t(da1)
    return {"dv": dv,
            "da0": matmul(dv, t((l1["w"] * l1["alpha"]).t().contiguous())),
            "dW1": matmul(t(a0).t().contiguous(), dv * al)}


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_3xtf32_keeps_fp32_accuracy_in_a_bspline_layer(direction):
    """A B-spline hidden layer at K = 256 (and the weight gradient at K =
    4,096 rows): each output within 2e-6 x its max of the float64 layer, or
    within plain fp32's own distance; plain TF32 past 1e-4 on the layer."""
    want = _bspline_layer(direction, torch.matmul, torch.float64)

    def rel(got):
        return {k: float((got[k].double() - w).abs().max() / w.abs().max())
                for k, w in want.items()}
    x3 = rel(_bspline_layer(direction, WM.matmul_3xtf32_plain,
                            torch.float32))
    fp32 = rel(_bspline_layer(direction, torch.matmul, torch.float32))
    tf32 = rel(_bspline_layer(
        direction, lambda a, b: WM.tf32_round(a) @ WM.tf32_round(b),
        torch.float32))
    for k in want:
        assert x3[k] <= 2e-6 or x3[k] <= fp32[k], (k, x3, fp32)
    assert max(tf32.values()) > 1e-4, tf32


def _canon(widths, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))
    return {"layers": [{"w": t(rng.uniform(-1, 1, (a, b)) / np.sqrt(a)),
                        "alpha": t(rng.uniform(0.5, 2.0, b)),
                        "beta": t(rng.uniform(-1, 1, b))}
                       for a, b in zip(widths[:-2], widths[1:-1])],
            "final": {"w": t(rng.uniform(-1, 1, widths[-2:])),
                      "b": t(rng.uniform(-1, 1, widths[-1]))}}


def _dcoords_in_column_order(dv, wat):
    """csrc/real_tc.cuh:dcoords_kernel's sums: dcoords[r, k] = sum over the
    columns j, in order, of dv[r, j] wat[j, k], each step one fp32 FMA (the
    product exact in float64, the sum rounded once to fp32)."""
    dv, wat = dv.double(), wat.double()
    s = torch.zeros((dv.shape[0], wat.shape[1]), dtype=torch.float32)
    for j in range(dv.shape[1]):
        s = (dv[:, j:j + 1] * wat[j] + s.double()).float()
    return s


@pytest.mark.parametrize("widths,kinds", [
    ((2, 48, 40, 3), ("qspline", "srelu")),
    ((26, 64, 64, 64, 3), ("relu",) * 3)])
def test_dcoords_column_order_matches_the_plain_coordinate_gradient(widths,
                                                                    kinds):
    """The dcoords kernel's fixed column order at d = 2 (the SISR pair's)
    and d = 26 (posenc's), on the first layer's dv and (W_0 diag
    alpha_0)^T, gives real_mlp_plain's coordinate gradient within 1e-4 x
    max, as the kernel is held."""
    n = 700
    canon = _canon(widths, 3)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.uniform(-1, 1, (n, widths[0])).astype(np.float32),
                     requires_grad=True)
    g = torch.tensor(rng.normal(size=(n, widths[-1])).astype(np.float32))
    lay0 = canon["layers"][0]
    v0 = lay0["alpha"] * (x @ lay0["w"]) + lay0["beta"]
    v0.retain_grad()
    a = RM.basis(v0, kinds[0])
    for lay, kind in zip(canon["layers"][1:], kinds[1:]):
        a = RM.basis(lay["alpha"] * (a @ lay["w"]) + lay["beta"], kind)
    y = a @ canon["final"]["w"] + canon["final"]["b"]
    y.backward(g)
    want = x.grad
    plain = torch.autograd.grad(RM.real_mlp_plain(canon, x, kinds), x, g)[0]
    assert torch.allclose(want, plain, rtol=0, atol=1e-6 * float(
        plain.abs().max()))
    wat = (lay0["w"] * lay0["alpha"]).t().contiguous()
    got = _dcoords_in_column_order(v0.grad, wat)
    err = float((got - plain).abs().max())
    assert err <= REL * float(plain.abs().max()), err


def _host_rehearse():
    spec = importlib.util.spec_from_file_location(
        "host_rehearse", os.path.join(ROOT, "tools", "host_rehearse.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _part_need(n, widths):
    """Floats the step writes into `part`: each weight gradient's chunk
    partials, (in + 1) x out over 512-row chunks where a side is at most 8
    wide, else over 1,024-row ones; the alpha column sums' over 2,048-row
    chunks; the SSE sums' two per 64-row block of the final layer."""
    def chunks(r):
        return -(-n // r)
    need = 2 * chunks(64)
    for m, w in list(zip(widths[:-2], widths[1:-1])) + [widths[-2:]]:
        need = max(need, chunks(512 if min(m, w) <= 8 else 1024)
                   * (m + 1) * w)
    for w in widths[1:-1]:
        need = max(need, chunks(2048) * w)
    return need


def test_part_workspace_holds_the_step_sse_partials(tmp_path):
    """real_mlp_part_floats covers every partial the step writes at ragged
    n, the SSE sums' too (they are the most at widths 2 -> 2 -> 1), and the
    step run on the host library at that shape gives the plain step's SSE
    sums and gradients."""
    H = _host_rehearse()
    RM._lib.cache_clear()
    try:
        with H.host_library("real_mlp", str(tmp_path)) as lib:
            lib.real_mlp_part_floats.restype = ctypes.c_longlong
            for n, widths in ((2100, (2, 2, 1)), (700, (2, 48, 40, 3)),
                              (65537, (2, 256, 256, 256, 3)),
                              (4099, (26, 64, 64, 64, 3)),
                              (70000, (2, 4, 1)), (131, (2, 5, 3, 2))):
                got = lib.real_mlp_part_floats(
                    n, len(widths) - 2, (ctypes.c_int * len(widths))(*widths))
                assert got >= _part_need(n, widths), (n, widths, got)
            assert lib.real_mlp_part_floats(
                2100, 1, (ctypes.c_int * 3)(2, 2, 1)) == 2 * (-(-2100 // 64))

            n, widths = 2100, (2, 2, 1)
            canon = _canon(widths, 5)
            rng = np.random.default_rng(6)
            c, t, gt = (torch.tensor(a.astype(np.float32)) for a in (
                rng.uniform(-1, 1, (n, 2)), rng.uniform(0, 1, (n, 1)),
                rng.uniform(0, 1, (n, 1))))
            kw = dict(nvalid=2049, denom=6000.0, gt=gt)
            pred, dcanon, sums = RM._launch_step(
                canon, c, t, ("qspline",), kw["nvalid"], kw["denom"], gt,
                True, None)
            wpred, wcanon, wsums = RM.real_step_plain(
                canon, c, t, ("qspline",), want_metrics=True, **kw)
    finally:
        RM._lib.cache_clear()
    got = [pred, *sums] + [v for _, v in RM.canon_leaves(dcanon)]
    want = [wpred, *wsums] + [v for _, v in RM.canon_leaves(wcanon)]
    for g_, w in zip(got, want):
        assert float((g_ - w).abs().max()) <= REL * float(w.abs().max())
