"""The Gabor MFN on the tensor cores (csrc/mfn.cu on csrc/wire_tc.cuh), on
the CPU: the plain model of its link products (ops/wire_mlp.py:
tf32_round, matmul_3xtf32_plain) in one MFN link, forward and backward,
against the float64 link; and a plain model of its filter-gradient pass,
the nine per-column sums over 512-row chunks in the kernel's fixed order,
against mfn_step_plain's filter gradients."""
import numpy as np
import pytest
import torch

from wire_tpu_torch.nn import models as MM
from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.ops import mfn as MF
from wire_tpu_torch.ops import wire_mlp as WM

N_ROWS = 4096


def _link(h, direction, matmul, dtype, seed=0):
    """Link 1 of an MFN (3 filters, h wide, the port's seeded init): the
    forward l = z_0 W_0 + c_0, z_1 = l g_1, or the backward from a
    unit-normal dz_1: dl = dz_1 g_1, dg = dz_1 l, dz_0 = dl W_0^T; the
    products by ``matmul`` in ``dtype``.  The inputs z_0, g_1, l and dz_1
    are float32, formed once."""
    model = get_inr("mfn", in_features=2, out_features=3, hidden_features=h,
                    hidden_layers=2)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1, 1, (N_ROWS, 2)).astype(np.float32))
    z0 = MM.mfn_gabor(params["gabor_0"], x)
    g1 = MM.mfn_gabor(params["gabor_1"], x)
    W, c = params["linear_0"]["w"], params["linear_0"]["b"]
    lin = z0 @ W + c
    dz1 = torch.tensor(rng.normal(size=lin.shape).astype(np.float32))

    def t(v):
        return v.to(dtype)
    if direction == "forward":
        lv = matmul(t(z0), t(W)) + t(c)
        return {"l": lv, "z1": lv * t(g1)}
    dl = t(dz1) * t(g1)
    return {"dl": dl, "dg": t(dz1) * t(lin),
            "dz0": matmul(dl, t(W.t().contiguous()))}


@pytest.mark.parametrize("h", [300, 256])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_3xtf32_keeps_fp32_accuracy_in_an_mfn_link(h, direction):
    """An MFN link at the denoise (h = 300) and SISR (256) widths, K = h:
    each output within 2e-6 x its max of the float64 link, or within plain
    fp32's own distance; plain TF32 past 1e-4 on the link."""
    want = _link(h, direction, torch.matmul, torch.float64)

    def rel(got):
        return {k: float((got[k].double() - w).abs().max() / w.abs().max())
                for k, w in want.items()}
    x3 = rel(_link(h, direction, WM.matmul_3xtf32_plain, torch.float32))
    fp32 = rel(_link(h, direction, torch.matmul, torch.float32))
    tf32 = rel(_link(h, direction,
                     lambda a, b: WM.tf32_round(a) @ WM.tf32_round(b),
                     torch.float32))
    for k in want:
        assert x3[k] <= 2e-6 or x3[k] <= fp32[k], (k, x3, fp32)
    assert max(tf32.values()) > 1e-4, tf32


# csrc/mfn.cu:filter_grad_partial_kernel's launch: 32 columns and 8
# interleaved row groups per block, one block per 512-row chunk
FILTER_COLS, FILTER_GROUPS, FILTER_CHUNK_ROWS = 32, 8, 512


def _filter_grads_chunked(x, dg, p):
    """Filter p's gradients from dg (n x h), the cotangent of its g, in the
    order of csrc/mfn.cu's filter pass: within a 512-row chunk thread
    group q sums rows q, q + 8, ... in order, the 8 group sums meet in
    order, and the chunks' sums are added in chunk order (reduce_chunks);
    then filter_grad_finish_kernel's dw, db, dmu, dgamma.  Rows past n (the
    last chunk's tail) add nothing."""
    n, d = x.shape
    h = dg.shape[1]
    nrm = ((x * x).sum(-1, keepdim=True) + (p["mu"] * p["mu"]).sum(-1)
           - 2.0 * (x @ p["mu"].t()))
    E = torch.exp(-0.5 * p["gamma"] * nrm)
    q = x @ p["w"] + p["b"]
    es = dg * E
    dq, ges = es * torch.cos(q), es * torch.sin(q)
    terms = [dq] + [dq * x[:, k:k + 1] for k in range(d)] + [ges] + [
        ges * x[:, k:k + 1] for k in range(d)] + [ges * nrm]
    chunks = -(-n // FILTER_CHUNK_ROWS)
    pad = chunks * FILTER_CHUNK_ROWS - n
    t = torch.stack([torch.nn.functional.pad(v, (0, 0, 0, pad))
                     for v in terms])  # (sums, rows, h)
    t = t.reshape(len(terms), chunks, FILTER_CHUNK_ROWS // FILTER_GROUPS,
                  FILTER_GROUPS, h)
    group = torch.zeros_like(t[:, :, 0])
    for i in range(t.shape[2]):
        group = group + t[:, :, i]
    part = torch.zeros_like(group[:, :, 0])
    for qq in range(FILTER_GROUPS):
        part = part + group[:, :, qq]
    s = torch.zeros_like(part[:, 0])
    for ch in range(chunks):
        s = s + part[:, ch]
    hg = -0.5 * p["gamma"]
    sdq, sdqx, sges = s[0], s[1:1 + d], s[1 + d]
    sgx, sgn = s[2 + d:2 + 2 * d], s[2 + 2 * d]
    return {"w": sdqx, "b": sdq, "gamma": -0.5 * sgn,
            "mu": 2.0 * (hg * sges)[:, None] * p["mu"]
            - 2.0 * (hg[:, None] * sgx.t())}


@pytest.mark.parametrize("n", [700, 65537])
def test_chunked_filter_sums_match_the_plain_filter_gradients(n):
    """The filter pass's 512-row chunks (2 at n = 700, the last ragged; 129
    at 65,537, the last one row) give the plain step's filter gradients
    (an MFN of one filter, h = 300, so dg = dL/dy W_f^T): within 1e-4 x
    max of mfn_step_plain, as the kernel is held, and within 2e-5 x max of
    the same model in float64.  At the denoise shape the pass launches
    ceil(300 / 32) x 128 = 1,280 blocks."""
    h, o = 300, 3
    model = get_inr("mfn", in_features=2, out_features=o, hidden_features=h,
                    hidden_layers=0)
    params = model.init(torch.Generator().manual_seed(n), "cpu")
    rng = np.random.default_rng(n)
    x, t = (torch.tensor(a.astype(np.float32)) for a in (
        rng.uniform(-1, 1, (n, 2)), rng.uniform(0, 1, (n, o))))
    _, grads = MF.mfn_step_plain(params, x, t, model.spec)
    y = MF.mfn_mlp_plain(params, x, model.spec)
    dg = (2.0 / (n * o)) * (y - t) @ params["final"]["w"].t()
    got = _filter_grads_chunked(x, dg, params["gabor_0"])
    got64 = _filter_grads_chunked(
        x.double(), dg.double(),
        {k: v.double() for k, v in params["gabor_0"].items()})
    for k, want in grads["gabor_0"].items():
        scale = float(want.abs().max())
        assert float((got[k] - want).abs().max()) <= 1e-4 * scale, k
        scale64 = float(got64[k].abs().max())
        assert float((got[k].double() - got64[k]).abs().max()) \
            <= 2e-5 * scale64, k
    blocks = -(-300 // FILTER_COLS) * -(-65536 // FILTER_CHUNK_ROWS)
    assert blocks == 1280 >= 1000
