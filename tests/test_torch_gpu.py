"""The CUDA kernels (wire_step, wire_mlp, rotsum, line_sample, real_mlp's
pair and step, mscale2_step) against their plain PyTorch versions on the
card (marked ``gpu``; skipped where no CUDA device is present):

    python -m pytest tests/test_torch_gpu.py -m gpu -p no:randomly
"""
import numpy as np
import pytest
import torch

from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.ops import wire_step as WS

pytestmark = pytest.mark.gpu

# max abs err <= REL x max |plain| per output: fp32 sums in another order
REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(n, hf, layers, out, device, seed=0):
    model = get_inr("wire", in_features=2, out_features=out,
                    hidden_features=hf, hidden_layers=layers,
                    first_omega0=7.0, hidden_omega0=7.0, scale=8.0)
    params = model.init(torch.Generator().manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(-1, 1, (n, 2)), rng.uniform(0, 1, (n, out)),
            rng.uniform(0, 1, (n, out)))
    return (model, params) + tuple(
        torch.tensor(a.astype(np.float32), device=device) for a in arrs)


def _flat(pred, grads, sums):
    out = {"pred": pred, "sse_t": sums[0], "sse_g": sums[1]}
    out.update({f"{k}.{kk}": v for k in grads for kk, v in grads[k].items()})
    return out


@pytest.mark.parametrize("n,hf,layers,out,nvalid,denom", [
    (700, 91, 2, 3, None, None), (512, 91, 1, 1, 500, 1234.5),
    (100, 300, 2, 3, 77, None), (4099, 300, 2, 3, None, None),
    (300, 29, 0, 2, None, None)])
def test_kernel_matches_plain(cuda, n, hf, layers, out, nvalid, denom):
    model, params, c, t, gt = _case(n, hf, layers, out, cuda)
    before = WS.wire_step.launches
    got = _flat(*WS.wire_step(params, c, t, model.spec, nvalid=nvalid,
                              denom=denom, gt=gt, want_metrics=True))
    torch.cuda.synchronize()
    assert WS.wire_step.launches == before + 1
    want = _flat(*WS.wire_step_plain(params, c, t, model.spec, nvalid=nvalid,
                                     denom=denom, gt=gt, want_metrics=True))
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= REL * float(w.abs().max()), (name, err)


def test_kernel_is_deterministic_and_reuses_scratch(cuda):
    model, params, c, t, gt = _case(5000, 300, 2, 3, cuda)
    scratch = WS.StepScratch()
    a = _flat(*WS.wire_step(params, c, t, model.spec, gt=gt,
                            want_metrics=True, scratch=scratch))
    b = _flat(*WS.wire_step(params, c, t, model.spec, gt=gt,
                            want_metrics=True, scratch=scratch))
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_wrapper_checks_inputs(cuda):
    model, params, c, t, _ = _case(64, 40, 1, 3, cuda)
    with pytest.raises(TypeError, match="dtype"):
        WS.wire_step(params, c.double(), t, model.spec)
    with pytest.raises(ValueError, match="contiguous"):
        WS.wire_step(params, c.t().contiguous().t(), t, model.spec)
    with pytest.raises(ValueError, match="on cpu"):
        WS.wire_step(params, c, t.cpu(), model.spec)
    with pytest.raises(ValueError, match="nvalid"):
        WS.wire_step(params, c, t, model.spec, nvalid=65)


# ---- wire_mlp, rotsum, line_sample: kernel vs plain on the card ----------

def _wire_mlp_case(n, hf, layers, out, device, seed=0):
    model = get_inr("wire", in_features=2, out_features=out,
                    hidden_features=hf, hidden_layers=layers,
                    first_omega0=3.0, hidden_omega0=3.0, scale=12.0)
    params = model.init(torch.Generator().manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    coords = torch.tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                          device=device)
    g = torch.tensor(rng.normal(size=(n, out)).astype(np.float32),
                     device=device)
    return model, params, coords, g


def _vjp(fn, params, coords, g):
    keys = [(k, kk) for k in params for kk in params[k]]
    leaves = [params[k][kk].detach().requires_grad_(True) for k, kk in keys]
    c = coords.detach().requires_grad_(True)
    p = {k: {} for k in params}
    for (k, kk), leaf in zip(keys, leaves):
        p[k][kk] = leaf
    y = fn(p, c)
    grads = torch.autograd.grad(y, leaves + [c], g, allow_unused=True)
    out = {"y": y.detach(), "dcoords": grads[-1]}
    for (k, kk), leaf, gr in zip(keys, leaves, grads[:-1]):
        out[f"{k}.{kk}"] = torch.zeros_like(leaf) if gr is None else gr
    return out


@pytest.mark.parametrize("n,hf,layers,out", [
    (700, 91, 2, 1), (4099, 300, 2, 1), (513, 40, 1, 3), (300, 29, 0, 2)])
def test_wire_mlp_kernel_matches_plain(cuda, n, hf, layers, out):
    from wire_tpu_torch.ops import wire_mlp as WM
    model, params, c, g = _wire_mlp_case(n, hf, layers, out, cuda)
    before = dict(WM.launches)
    got = _vjp(lambda p, x: WM.wire_mlp(p, x, model.spec), params, c, g)
    torch.cuda.synchronize()
    assert WM.launches == {"forward": before["forward"] + 1,
                           "backward": before["backward"] + 1}
    want = _vjp(lambda p, x: WM.wire_mlp_plain(p, x, model.spec), params, c,
                g)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= REL * float(w.abs().max()) + 1e-30, (name, err)


def test_wire_mlp_kernel_is_deterministic(cuda):
    from wire_tpu_torch.ops import wire_mlp as WM
    model, params, c, g = _wire_mlp_case(5000, 300, 2, 1, cuda)
    fn = lambda p, x: WM.wire_mlp(p, x, model.spec)  # noqa: E731
    a, b = _vjp(fn, params, c, g), _vjp(fn, params, c, g)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_wire_mlp_skips_dcoords_for_constant_coords(cuda):
    """Coordinates that need no gradient (every fit) get no dcoords kernel;
    the parameter gradients are those of the full backward, bit for bit."""
    from wire_tpu_torch.ops import wire_mlp as WM
    model, params, c, g = _wire_mlp_case(700, 91, 2, 1, cuda)
    full = _vjp(lambda p, x: WM.wire_mlp(p, x, model.spec), params, c, g)
    keys = [(k, kk) for k in params for kk in params[k]]
    leaves = [params[k][kk].detach().requires_grad_(True) for k, kk in keys]
    p = {k: {} for k in params}
    for (k, kk), leaf in zip(keys, leaves):
        p[k][kk] = leaf
    y = WM.wire_mlp(p, c, model.spec)
    grads = torch.autograd.grad(y, leaves, g, allow_unused=True)
    for (k, kk), leaf, gr in zip(keys, leaves, grads):
        want = full[f"{k}.{kk}"]
        assert torch.equal(torch.zeros_like(leaf) if gr is None else gr,
                           want), (k, kk)


def test_wire_mlp_takes_leading_axes(cuda):
    """(b, N, d) coordinates give (b, N, o), as wire_tpu's entry does."""
    from wire_tpu_torch.ops import wire_mlp as WM
    model, params, c, g = _wire_mlp_case(200, 91, 2, 3, cuda)
    c3, g3 = c.reshape(4, 50, 2), g.reshape(4, 50, 3)
    got = _vjp(lambda p, x: WM.wire_mlp(p, x, model.spec), params, c3, g3)
    want = _vjp(lambda p, x: WM.wire_mlp_plain(p, x, model.spec), params,
                c3, g3)
    assert got["y"].shape == (4, 50, 3)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= REL * float(w.abs().max()) + 1e-30, (name, err)


def test_wire_mlp_without_grad_keeps_nothing(cuda):
    """With no input that needs a gradient the forward runs through two
    ping-pong planes: the same output, and a peak of those planes plus a
    little, not the backward's saved activations (0.61 GB here)."""
    from wire_tpu_torch.ops import wire_mlp as WM
    model, params, c, g = _wire_mlp_case(65536, 300, 2, 1, cuda)
    h = params["first"]["w"].shape[1]
    leaves = {k: {kk: v.detach().requires_grad_(True) for kk, v in
                  sub.items()} for k, sub in params.items()}
    with_grad = WM.wire_mlp(leaves, c, model.spec).detach()
    torch.cuda.synchronize()
    before = dict(WM.launches)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = WM.wire_mlp(leaves, c, model.spec)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert WM.launches == {"forward": before["forward"] + 1,
                           "backward": before["backward"]}
    assert torch.equal(y, with_grad)
    pingpong = 2 * 65536 * 2 * h * 4
    slack = 16 * 2 ** 20   # stacked weights (~3 MB), pred, allocator rounding
    assert peak <= pingpong + slack, (peak, pingpong)


def test_radon_rotate_runs_the_kernel_on_a_non_square_cuda_image(cuda):
    from wire_tpu_torch.operators import radon as TR
    from wire_tpu_torch.ops import rotsum as R
    img = torch.rand((64, 48), device=cuda)
    angles = np.linspace(0, 180, 5, dtype=np.float32)
    before = dict(R.launches)
    got = TR.radon(img, angles, method="rotate")
    assert R.launches["forward"] == before["forward"] + 1
    want = TR.radon(img, angles, method="rotate_xla")
    assert got.shape == (5, 48)
    err = float((got - want).abs().max())
    assert err <= REL * float(want.abs().max()), err


@pytest.mark.parametrize("H,W", [(96, 128), (128, 96), (33, 70)])
def test_rotsum_non_square_kernel_matches_plain(cuda, H, W):
    from wire_tpu_torch.ops import rotsum as R
    rng = np.random.default_rng(H + W)
    angles = np.array([0.0, 7.3, 44.9, 90.0, 121.7, 180.0, -13.4, 315.0],
                      np.float32)
    img = torch.tensor(rng.random((H, W)).astype(np.float32), device=cuda)
    cot = torch.tensor(rng.normal(size=(len(angles), W)).astype(np.float32),
                       device=cuda)
    out = {}
    for name, fn in (("kernel", R.rotate_project),
                     ("plain", R.rotate_project_plain)):
        x = img.clone().requires_grad_(True)
        y = fn(x, angles)
        (gx,) = torch.autograd.grad(y, x, cot)
        out[name] = (y, gx)
    for (a, b), what in zip(zip(out["kernel"], out["plain"]),
                            ("sino", "adjoint")):
        err = float((a - b).abs().max())
        assert err <= REL * float(b.abs().max()), (what, err)


@pytest.mark.parametrize("S", [32, 96, 256])
def test_rotsum_kernel_matches_plain(cuda, S):
    from wire_tpu_torch.ops import rotsum as R
    rng = np.random.default_rng(S)
    angles = np.array([0.0, 7.3, 44.9, 45.1, 90.0, 121.7, 180.0, -13.4,
                       200.0, 315.0], np.float32)
    img = torch.tensor(rng.random((S, S)).astype(np.float32), device=cuda)
    cot = torch.tensor(rng.normal(size=(len(angles), S)).astype(np.float32),
                       device=cuda)
    x = img.clone().requires_grad_(True)
    before = dict(R.launches)
    y = R.rotate_project(x, angles)
    (gx,) = torch.autograd.grad(y, x, cot)
    torch.cuda.synchronize()
    assert R.launches == {"forward": before["forward"] + 1,
                          "adjoint": before["adjoint"] + 1}
    x2 = img.clone().requires_grad_(True)
    y2 = R.rotate_project_plain(x2, angles)
    (gx2,) = torch.autograd.grad(y2, x2, cot)
    for name, a, b in (("sino", y, y2), ("adjoint", gx, gx2)):
        err = float((a - b).abs().max())
        assert err <= REL * float(b.abs().max()), (name, err)
    with pytest.raises(ValueError, match="rotate_xla"):
        R.rotate_project(img, torch.tensor(angles, requires_grad=True))


@pytest.mark.parametrize("P,A,K", [(128, 13, 65), (1024, 100, 513),
                                   (96, 7, 49)])
def test_line_sample_kernel_matches_plain(cuda, P, A, K):
    from wire_tpu_torch.ops import line_sample as LS
    rng = np.random.default_rng(P)
    ph = P + 2
    fre, fim = (torch.tensor(rng.normal(size=(ph, ph)).astype(np.float32),
                             device=cuda) for _ in range(2))
    th = np.deg2rad(np.linspace(0, 180, A, dtype=np.float32))
    k = np.arange(K, dtype=np.float32)
    gy = torch.tensor(k[None] * np.sin(th)[:, None] + P // 2, device=cuda)
    gx = torch.tensor(k[None] * np.cos(th)[:, None] + P // 2, device=cuda)
    cre, cim = (torch.tensor(rng.normal(size=(A, K)).astype(np.float32),
                             device=cuda) for _ in range(2))

    def run(fn):
        a = fre.clone().requires_grad_(True)
        b = fim.clone().requires_grad_(True)
        sre, sim = fn(a, b, gy, gx)
        ga, gb = torch.autograd.grad((sre, sim), (a, b), (cre, cim))
        return {"sre": sre, "sim": sim, "fre_bar": ga, "fim_bar": gb}

    before = dict(LS.launches)
    got = run(LS.sample_lines)
    torch.cuda.synchronize()
    assert LS.launches == {"gather": before["gather"] + 1,
                           "scatter": before["scatter"] + 1}
    want = run(LS.sample_lines_plain)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= REL * float(w.abs().max()), (name, err)


# ---- real_mlp: the canonical real MLP's pair and step ----------------------

BASES = ("qspline", "cspline", "sine", "gauss", "relu", "srelu", "identity")
SEGMENTS = (("qspline", 20), ("identity", 10), ("sine", 10))


def _canon(widths, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    layers = [{"w": t(rng.uniform(-1, 1, (a, b)) / np.sqrt(a)),
               "alpha": t(rng.uniform(0.5, 2.0, b)),
               "beta": t(rng.uniform(-1, 1, b))}
              for a, b in zip(widths[:-2], widths[1:-1])]
    h, o = widths[-2], widths[-1]
    return {"layers": layers,
            "final": {"w": t(rng.uniform(-1, 1, (h, o)) / np.sqrt(h)),
                      "b": t(rng.uniform(-1, 1, o))}}


def _real_vjp(fn, canon, coords, g):
    from wire_tpu_torch.ops import real_mlp as RM
    leaves = [t.detach().requires_grad_(True)
              for _, t in RM.canon_leaves(canon)]
    c = coords.detach().requires_grad_(True)
    y = fn(RM.canon_from_leaves(leaves, len(canon["layers"])), c)
    grads = torch.autograd.grad(y, leaves + [c], g)
    out = {"y": y.detach(), "dcoords": grads[-1]}
    out.update({str(p): gr for (p, _), gr in
                zip(RM.canon_leaves(canon), grads[:-1])})
    return out


def _assert_rel(got, want):
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= REL * float(w.abs().max()) + 1e-30, (name, err)


@pytest.mark.parametrize("kind", BASES + ("segments",))
def test_real_mlp_kernel_matches_plain(cuda, kind):
    from wire_tpu_torch.ops import real_mlp as RM
    widths = (2, 48, 40, 3)
    kinds = (SEGMENTS, "qspline") if kind == "segments" else (kind, kind)
    canon = _canon(widths, cuda)
    rng = np.random.default_rng(1)
    c = torch.tensor(rng.uniform(-1, 1, (700, 2)).astype(np.float32),
                     device=cuda)
    g = torch.tensor(rng.normal(size=(700, 3)).astype(np.float32),
                     device=cuda)
    before = dict(RM.launches)
    got = _real_vjp(lambda p, x: RM.real_mlp(p, x, kinds), canon, c, g)
    torch.cuda.synchronize()
    assert RM.launches["forward"] == before["forward"] + 1
    assert RM.launches["backward"] == before["backward"] + 1
    want = _real_vjp(lambda p, x: RM.real_mlp_plain(p, x, kinds), canon, c,
                     g)
    _assert_rel(got, want)


@pytest.mark.parametrize("n,widths", [(28224, (2, 256, 256, 256, 3)),
                                      (4099, (26, 64, 64, 1))])
def test_real_mlp_kernel_matches_plain_at_path_widths(cuda, n, widths):
    from wire_tpu_torch.ops import real_mlp as RM
    kinds = ("qspline",) * (len(widths) - 2)
    canon = _canon(widths, cuda, seed=2)
    rng = np.random.default_rng(3)
    c = torch.tensor(rng.uniform(-1, 1, (n, widths[0])).astype(np.float32),
                     device=cuda)
    g = torch.tensor(rng.normal(size=(n, widths[-1])).astype(np.float32),
                     device=cuda)
    got = _real_vjp(lambda p, x: RM.real_mlp(p, x, kinds), canon, c, g)
    want = _real_vjp(lambda p, x: RM.real_mlp_plain(p, x, kinds), canon, c,
                     g)
    _assert_rel(got, want)


def test_real_mlp_row_gamma_and_scales_match_plain(cuda):
    from wire_tpu_torch.ops import real_mlp as RM
    widths = (2, 48, 40, 3)
    kinds = ("qspline", "cspline")
    canon = _canon(widths, cuda, seed=4)
    rng = np.random.default_rng(5)
    c = torch.tensor(rng.uniform(-1, 1, (300, 2)).astype(np.float32),
                     device=cuda)
    g = torch.tensor(rng.normal(size=(3, 300, 3)).astype(np.float32),
                     device=cuda)
    inv = (1.0, 0.5, 0.25)
    got = _real_vjp(lambda p, x: RM.real_mlp_scales(p, x, kinds, inv),
                    canon, c, g)
    want = _real_vjp(lambda p, x: RM.real_mlp_plain(
        p, x.repeat(3, 1), kinds, row_gamma=(inv, 300)).reshape(3, 300, 3),
        canon, c, g)
    _assert_rel(got, want)


def test_real_mlp_without_grad_equals_the_pair(cuda):
    from wire_tpu_torch.ops import real_mlp as RM
    widths = (2, 64, 64, 3)
    kinds = ("qspline", "sine")
    canon = _canon(widths, cuda, seed=6)
    c = torch.rand((1000, 2), device=cuda) * 2 - 1
    leaves = [t.detach().requires_grad_(True)
              for _, t in RM.canon_leaves(canon)]
    with_grad = RM.real_mlp(RM.canon_from_leaves(leaves, 2), c, kinds)
    with torch.no_grad():
        without = RM.real_mlp(canon, c.reshape(10, 100, 2), kinds)
    assert without.shape == (10, 100, 3)
    assert torch.equal(without.reshape(1000, 3), with_grad.detach())


def _step_flat(pred, dcanon, sums):
    from wire_tpu_torch.ops import real_mlp as RM
    out = {"pred": pred, "sse_t": sums[0], "sse_g": sums[1]}
    out.update({str(p): t for p, t in RM.canon_leaves(dcanon)})
    return out


@pytest.mark.parametrize("n,widths,kinds,nvalid,denom", [
    (700, (2, 48, 40, 3), ("srelu", "gauss"), 650, 650 * 3.0 + 1.0),
    (700, (2, 48, 40, 3), (SEGMENTS, "relu"), None, None),
    (4099, (26, 64, 64, 64, 3), ("relu",) * 3, 4000, None),
    (65536, (2, 256, 256, 256, 3), ("qspline",) * 3, None, None)])
def test_real_step_kernel_matches_plain(cuda, n, widths, kinds, nvalid,
                                        denom):
    from wire_tpu_torch.ops import real_mlp as RM
    canon = _canon(widths, cuda, seed=7)
    rng = np.random.default_rng(8)
    c, t, gt = (torch.tensor(a.astype(np.float32), device=cuda) for a in (
        rng.uniform(-1, 1, (n, widths[0])), rng.uniform(0, 1, (n, 3)),
        rng.uniform(0, 1, (n, 3))))
    before = RM.launches["step"]
    got = _step_flat(*RM.real_step(canon, c, t, kinds, nvalid=nvalid,
                                   denom=denom, gt=gt, want_metrics=True))
    torch.cuda.synchronize()
    assert RM.launches["step"] == before + 1
    want = _step_flat(*RM.real_step_plain(canon, c, t, kinds, nvalid=nvalid,
                                          denom=denom, gt=gt,
                                          want_metrics=True))
    _assert_rel(got, want)


def test_real_step_is_deterministic_and_reuses_scratch(cuda):
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops.wire_step import StepScratch
    widths = (2, 256, 256, 3)
    canon = _canon(widths, cuda, seed=9)
    c = torch.rand((5000, 2), device=cuda) * 2 - 1
    t = torch.rand((5000, 3), device=cuda)
    scratch = StepScratch()
    a, b = (_step_flat(*RM.real_step(canon, c, t, ("qspline",) * 2,
                                     want_metrics=True, scratch=scratch))
            for _ in range(2))
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_real_family_fits_launch_the_kernels(cuda):
    """Every real family's step and apply go through the kernels on the
    card and agree with the plain path."""
    from wire_tpu_torch.ops import real_mlp as RM
    c = torch.rand((600, 2), device=cuda) * 2 - 1
    t = torch.rand((600, 3), device=cuda)
    for nonlin in ("siren", "gauss", "relu", "posenc", "bspline_form",
                   "bspline_cubic", "bspline_srelu", "bspline_knots"):
        kw = dict(hidden_features=64, out_features=3, sidelength=64,
                  scale=0.5 if nonlin.startswith("bspline") else 2.0)
        model = get_inr(nonlin, **kw)
        plain = get_inr(nonlin, fused="never", **kw)
        params = model.init(torch.Generator().manual_seed(0), cuda)
        before = RM.launches["step"]
        got = model.step_grads(params, c, t, want_metrics=True)
        assert RM.launches["step"] == before + 1, nonlin
        want = plain.step_grads(params, c, t, want_metrics=True)
        _assert_rel(_flat(*got), _flat(*want))


# ---- mscale2_step: every scale's trunk, the combiner, the loss, backward ---

def _comb(ns, o, device, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return {"freq_0": {"w": t(rng.uniform(-1, 1, (ns * o, 128)) / np.sqrt(
                ns * o)), "b": t(rng.uniform(-1, 1, 128) / np.sqrt(ns * o))},
            "freq_1": {"w": t(rng.uniform(-1, 1, (128, o)) / np.sqrt(128)),
                       "b": t(rng.uniform(-1, 1, o) / np.sqrt(128))}}


def _tree_flat(*outs):
    from wire_tpu_torch import tree
    return {str(p): t for p, t in tree.leaves(list(outs))}


@pytest.mark.parametrize("n,ns,widths,nvalid,denom", [
    (700, 2, (2, 48, 40, 3), 650, 650 * 3.0 + 1.0),
    (1100, 3, (2, 64, 64, 64, 1), None, None),
    (65536, 3, (2, 256, 256, 256, 3), None, None)])
def test_mscale2_step_kernel_matches_plain(cuda, n, ns, widths, nvalid,
                                           denom):
    from wire_tpu_torch.ops import mscale2_step as MS
    canon = _canon(widths, cuda, seed=10)
    comb = _comb(ns, widths[-1], cuda, 11)
    inv = (9.0, 0.25, 0.125)[:ns]
    kinds = ("qspline",) * (len(widths) - 2)
    rng = np.random.default_rng(12)
    o = widths[-1]
    c, t, gt = (torch.tensor(a.astype(np.float32), device=cuda) for a in (
        rng.uniform(-1, 1, (n, 2)), rng.uniform(0, 1, (n, o)),
        rng.uniform(0, 1, (n, o))))
    before = MS.launches["step"]
    got = _tree_flat(*MS.mscale2_step(canon, comb, c, t, kinds, inv,
                                      nvalid=nvalid, denom=denom, gt=gt,
                                      want_metrics=True))
    torch.cuda.synchronize()
    assert MS.launches["step"] == before + 1
    want = _tree_flat(*MS.mscale2_step_plain(canon, comb, c, t, kinds, inv,
                                             nvalid=nvalid, denom=denom,
                                             gt=gt, want_metrics=True))
    assert got.keys() == want.keys()
    _assert_rel(got, want)


def test_mscale2_step_is_deterministic_and_reuses_scratch(cuda):
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops.wire_step import StepScratch
    canon = _canon((2, 128, 128, 3), cuda, seed=13)
    comb = _comb(3, 3, cuda, 14)
    c = torch.rand((5000, 2), device=cuda) * 2 - 1
    t = torch.rand((5000, 3), device=cuda)
    scratch = StepScratch()
    a, b = (_tree_flat(*MS.mscale2_step(canon, comb, c, t, ("qspline",) * 2,
                                        (9.0, 0.25, 0.125),
                                        want_metrics=True, scratch=scratch))
            for _ in range(2))
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_multiscale_families_launch_the_kernels(cuda):
    """mscale_2's step runs mscale2_step; mscale_HL's and mscale_hier's
    run real_step; each agrees with its family's plain path (scales with
    gamma <= 2, where the plain path's relu^2 spline rounds little)."""
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops import real_mlp as RM
    c = torch.rand((600, 2), device=cuda) * 2 - 1
    t = torch.rand((600, 3), device=cuda)
    cases = {
        "bspline_mscale_2": (dict(scale_tensor=(0.5, 2.0, 4.0)),
                             MS.launches),
        "bspline_mscale_HL": (dict(scale=1.0, scale_tensor=(1.0, 2.0),
                                   scaled_hidden_features=300), RM.launches),
        "bspline_mscale_hier": (dict(scale_tensor=(0.5, 2.0, 1.0)),
                                RM.launches)}
    for nonlin, (kw, counter) in cases.items():
        kw = dict(hidden_features=64, out_features=3, **kw)
        model = get_inr(nonlin, **kw)
        plain = get_inr(nonlin, fused="never", **kw)
        params = model.init(torch.Generator().manual_seed(0), cuda)
        before = counter["step"]
        got = model.step_grads(params, c, t, want_metrics=True)
        assert counter["step"] == before + 1, nonlin
        want = plain.step_grads(params, c, t, want_metrics=True)
        _assert_rel(_tree_flat(*got), _tree_flat(*want))
