"""Why the tensor-core wire_mlp (csrc/wire_tc.cuh) holds the port's
kernel-vs-plain bound, on the CPU: the plain model of its products
(ops/wire_mlp.py:tf32_round, matmul_3xtf32_plain) at the CT pair's shapes
against a float64 product, and the column pairing of its staged tiles
(paired_tile_columns).

The operands are what the pair multiplies: the first Gabor layer's
stacked activations a0 (n x 2h) of a wire_tpu init moved across (CT's
omega0 3, scale 12, and the denoise bench's omega0 7, scale 8; h = 212),
the stacked hidden weights W (2h x 2h) and a unit-normal cotangent dz
(n x 2h) for the weight-gradient class a0^T dz.  Bounds: 3xTF32 within
2e-6 x max |product| of the float64 product, as plain fp32 is; plain TF32
(one product of the rounded operands) past 1e-4 x max, the bound every
MLP kernel of the port is held to.

The same for mscale2_step's trunk, were its products put on the tensor
cores: one hidden layer at its K of 256, forward and data gradient with
their basis epilogues, where gamma (up to 9) multiplies a product's
error."""
import numpy as np
import pytest
import torch

import jax

from wire_tpu.nn import get_inr

from wire_tpu_torch import bridge
from wire_tpu_torch.apps import common as TC
from wire_tpu_torch.nn import models as MM
from wire_tpu_torch.ops import real_mlp as RM
from wire_tpu_torch.ops import wire_mlp as WM
from wire_tpu_torch.ops.wire_step import stack_params
from wire_tpu_torch.train.presets import get_config

N_ROWS = 4096


def _operands(omega0, scale, seed=0):
    """a0 (n, 2h), W (2h, 2h) and dz (n, 2h) at the CT width (h = 212)."""
    jmodel = get_inr("wire", fused="never", in_features=2, out_features=1,
                     hidden_features=300, hidden_layers=2,
                     first_omega0=omega0, hidden_omega0=omega0, scale=scale)
    params = bridge.params_from_jax(jax.tree.map(
        np.asarray, jmodel.init(jax.random.key(seed))))
    w = stack_params(params, 2)
    rng = np.random.default_rng(seed)
    c = torch.tensor(rng.uniform(-1, 1, (N_ROWS, 2)).astype(np.float32))
    z1 = c @ w["w1"] + w["b1"]
    m = torch.exp(-(scale ** 2) * z1 * z1)
    a0 = torch.cat([m * torch.cos(omega0 * z1), m * torch.sin(omega0 * z1)],
                   dim=1)
    dz = torch.tensor(rng.normal(size=a0.shape).astype(np.float32))
    return a0, w["Wh"][0].contiguous(), dz


def _rel_errs(a, b):
    want = a.double() @ b.double()
    scale = float(want.abs().max())

    def rel(got):
        return float((got.double() - want).abs().max()) / scale

    tf32 = WM.tf32_round(a) @ WM.tf32_round(b)
    return rel(WM.matmul_3xtf32_plain(a, b)), rel(a @ b), rel(tf32)


@pytest.mark.parametrize("omega0,scale", [(3.0, 12.0), (7.0, 8.0)])
@pytest.mark.parametrize("product", ["forward", "weight_grad"])
def test_3xtf32_keeps_fp32_accuracy_where_tf32_does_not(omega0, scale,
                                                         product):
    a0, W, dz = _operands(omega0, scale)
    a, b = (a0, W) if product == "forward" else (a0.t().contiguous(), dz)
    x3, fp32, tf32 = _rel_errs(a, b)
    assert x3 <= 2e-6, (x3, fp32)
    assert fp32 <= 2e-6, fp32
    assert tf32 > 1e-4, tf32


def test_tf32_round_is_cvt_rna():
    """Nearest TF32 value, ties away from zero, 13 bits dropped; the
    residual of the split is exact and itself rounds to TF32."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, one + 1.5 * ulp, -(one + ulp / 2),
                      one + ulp / 2 - 2.0 ** -23, float("inf"), -0.0],
                     dtype=torch.float32)
    want = [one, one + ulp, one + 2 * ulp, -(one + ulp), one, float("inf"),
            -0.0]
    got = WM.tf32_round(x)
    assert got.tolist() == want
    assert not (got.view(torch.int32) & 0x1FFF).any()
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    big = WM.tf32_round(y)
    small = WM.tf32_round(y - big)
    assert not (small.view(torch.int32) & 0x1FFF).any()
    assert float((big.double() + small.double() - y.double()).abs().max()) \
        <= 2.0 ** -21 * float(y.abs().max())


@pytest.mark.parametrize("h", [5, 13, 32, 150, 212])
def test_paired_tile_columns_restore_the_stacked_layout(h):
    """The staged columns of the paired tiles are a bijection onto the 2h
    stacked columns, and the accumulator registers that the Gabor epilogue
    reads together, n8 tiles nt and nt + 2 of warp wn at lane column 2t + e
    (csrc/wire_tc.cuh:tile_col), hold a unit's (j, h + j)."""
    cols = WM.paired_tile_columns(h)
    units = WM.PAIRED_TILE_UNITS
    live = cols[cols >= 0]
    assert sorted(live.tolist()) == list(range(2 * h))
    for tile in cols.tolist():
        for wn in range(2):
            for nt in range(2):
                for lane_col in range(8):
                    re = tile[wn * 16 + nt * 8 + lane_col]
                    im = tile[units + wn * 16 + nt * 8 + lane_col]
                    assert (re < 0) == (im < 0)
                    if re >= 0:
                        assert re < h and im == h + re


def _trunk_layer(kind, gamma, matmul, dtype, seed=0):
    """Layer 1 of the mscale_2 denoise trunk (2 -> 256 x 3 -> 3, the
    preset's seeded init folded to the canonical form) at one scale's
    gamma, every basis ``kind``: its forward a1 = B(gamma (alpha1 a0 W1 +
    beta1)) and its data gradient with layer 0's epilogue, dv0 = gamma
    B'(v0) (dv1 (W1 diag(alpha1))^T), the products by ``matmul`` in
    ``dtype``.  The inputs a0, v0 and dv1 are float32, formed once."""
    model = TC.build_model(get_config("Mscale2_ST8_3_LR8e3_E4000"),
                           in_features=2, out_features=3, omega0=7.0,
                           sidelength=256)
    canon = MM._canon_mscale2(
        model.init(torch.Generator().manual_seed(seed), "cpu"), model.spec)
    l0, l1 = canon["layers"][:2]
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1, 1, (N_ROWS, 2)).astype(np.float32))
    v0 = gamma * (l0["alpha"] * (x @ l0["w"]) + l0["beta"])
    a0 = RM._apply_segments(kind, v0, 0)
    w, alpha, beta = l1["w"], l1["alpha"], l1["beta"]
    v1 = gamma * (alpha * (a0 @ w) + beta)
    da1 = torch.tensor(rng.normal(size=v1.shape).astype(np.float32))
    dv1 = gamma * RM._apply_segments(kind, v1, 1) * da1
    wat = (w * alpha[None]).t().contiguous()

    def t(a):
        return a.to(dtype)
    z1 = matmul(t(a0), t(w))
    a1 = RM._apply_segments(kind, gamma * (t(alpha) * z1 + t(beta)), 0)
    da0 = matmul(t(dv1), t(wat))
    dv0 = gamma * RM._apply_segments(kind, t(v0), 1) * da0
    return {"z1": z1, "a1": a1, "da0": da0, "dv0": dv0}


@pytest.mark.parametrize("kind,gamma", [("srelu", 9.0), ("qspline", 9.0),
                                        ("qspline", 0.125)])
def test_3xtf32_keeps_fp32_accuracy_in_the_real_trunk(kind, gamma):
    """Each output of the layer within 2e-6 x its max of the float64
    layer, or within plain fp32's own distance; plain TF32 past 1e-4 on
    the layer (on its products z1 and da0 in every case here)."""
    want = _trunk_layer(kind, gamma, torch.matmul, torch.float64)

    def rel(got):
        return {k: float((got[k].double() - w).abs().max() / w.abs().max())
                for k, w in want.items()}
    x3 = rel(_trunk_layer(kind, gamma, WM.matmul_3xtf32_plain,
                          torch.float32))
    fp32 = rel(_trunk_layer(kind, gamma, torch.matmul, torch.float32))
    tf32 = rel(_trunk_layer(
        kind, gamma, lambda a, b: WM.tf32_round(a) @ WM.tf32_round(b),
        torch.float32))
    for k in want:
        assert x3[k] <= 2e-6 or x3[k] <= fp32[k], (k, x3, fp32)
    assert max(tf32.values()) > 1e-4, tf32
