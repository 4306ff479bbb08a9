"""The CUDA kernels (wire_step, wire_mlp, rotsum, line_sample, real_mlp's
pair and step, mscale2_step, mfn's step and pair, wire2d's step and pair)
against their plain PyTorch versions on the card, the sweep app's
families launching their kernels, and the trainers' step timing leaving
the first step out (marked ``gpu``; skipped where no CUDA device is
present):

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


def _wire_mlp_scaled_case(n, hf, layers, out, device, omega0=3.0,
                          scale=12.0, wscale=1.0, seed=0):
    model = get_inr("wire", in_features=2, out_features=out,
                    hidden_features=hf, hidden_layers=layers,
                    first_omega0=omega0, hidden_omega0=omega0, scale=scale)
    params = model.init(torch.Generator().manual_seed(seed), device)
    for k in params:
        if k.startswith("hidden"):
            for kk in ("wr", "wi"):
                params[k][kk] = params[k][kk] * wscale
    rng = np.random.default_rng(seed)
    coords = torch.tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                          device=device)
    g = torch.tensor(rng.normal(size=(n, out)).astype(np.float32),
                     device=device)
    return model, params, coords, g


def _assert_close_to_plain(got, want):
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= REL * float(w.abs().max()) + 1e-30, (name, err)


@pytest.mark.parametrize("n,hf,layers,out", [
    (700, 8, 0, 1), (700, 8, 3, 3), (700, 19, 1, 3), (700, 19, 2, 1),
    (700, 213, 2, 1), (700, 213, 3, 3), (700, 300, 0, 1), (700, 300, 1, 3),
    (65536, 300, 2, 1), (65536, 213, 1, 3), (65536, 19, 2, 1)])
@pytest.mark.parametrize("dcoords", [True, False])
def test_wire_mlp_tensor_cores_match_plain_at_every_width(
        cuda, n, hf, layers, out, dcoords):
    """The 3xTF32 tensor-core pair at h = 5, 13, 150 and 212 complex units
    (hidden_features 8, 19, 213, 300: K = 2h of 10, 26, 300, 424, ragged
    against the 16-deep slices and the 32-unit tiles), L 0-3, o 1 and 3, n
    700 and 65,536, with and without dcoords: within the bound of the plain
    fp32 version (TF32 off), two calls bit-equal, and the no-grad forward
    equal to the pair's."""
    from wire_tpu_torch.ops import wire_mlp as WM
    assert not torch.backends.cuda.matmul.allow_tf32
    model, params, c, g = _wire_mlp_scaled_case(n, hf, layers, out, cuda,
                                                seed=n + layers)

    def run(fn):
        keys = [(k, kk) for k in params for kk in params[k]]
        leaves = [params[k][kk].detach().requires_grad_(True)
                  for k, kk in keys]
        x = c.detach().requires_grad_(dcoords)
        p = {k: {} for k in params}
        for (k, kk), leaf in zip(keys, leaves):
            p[k][kk] = leaf
        y = fn(p, x)
        wrt = leaves + ([x] if dcoords else [])
        grads = torch.autograd.grad(y, wrt, g, allow_unused=True)
        grads = [torch.zeros_like(v) if gr is None else gr
                 for v, gr in zip(wrt, grads)]
        out_ = {"y": y.detach()}
        out_.update({f"{k}.{kk}": gr for (k, kk), gr in zip(keys, grads)})
        if dcoords:
            out_["dcoords"] = grads[-1]
        return out_

    got = run(lambda p, x: WM.wire_mlp(p, x, model.spec))
    again = run(lambda p, x: WM.wire_mlp(p, x, model.spec))
    torch.cuda.synchronize()
    for name in got:
        assert torch.equal(got[name], again[name]), name
    want = run(lambda p, x: WM.wire_mlp_plain(p, x, model.spec))
    _assert_close_to_plain(got, want)
    with torch.no_grad():
        y = WM.wire_mlp(params, c, model.spec)
    assert torch.equal(y, got["y"])


def test_wire_mlp_at_extreme_phase_matches_plain(cuda):
    """CT's width with omega0 3, sigma 1 and the hidden weights doubled:
    Gabor phases up to ~30 rad, where the plain fp32 version itself is
    ~1e-5 x max from float64; the tensor-core pair stays within the bound
    of it."""
    from wire_tpu_torch.ops import wire_mlp as WM
    model, params, c, g = _wire_mlp_scaled_case(4096, 300, 2, 1, cuda,
                                                scale=1.0, wscale=2.0,
                                                seed=5)
    got = _vjp(lambda p, x: WM.wire_mlp(p, x, model.spec), params, c, g)
    want = _vjp(lambda p, x: WM.wire_mlp_plain(p, x, model.spec), params, c,
                g)
    _assert_close_to_plain(got, want)


def _device_kernels(fn, iters=3):
    """{device kernel name: launches per call} of fn (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / iters for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("H,W", [(256, 256), (96, 128)])
def test_rotsum_call_is_one_forward_and_one_adjoint_kernel(cuda, H, W):
    """Through RadonOp (the CT fit's operator, angle parts held on the
    device) a call with its gradient launches the forward kernel once, the
    adjoint kernel once, and no other device kernel."""
    from wire_tpu_torch.operators import radon as TR
    from wire_tpu_torch.ops import rotsum as R
    angles = np.linspace(0, 180, 100, dtype=np.float32)
    op = TR.RadonOp(angles, method="rotate")
    rng = np.random.default_rng(H)
    x = torch.tensor(rng.random((H, W)).astype(np.float32),
                     device=cuda).requires_grad_(True)
    cot = torch.tensor(rng.normal(size=(100, W)).astype(np.float32),
                       device=cuda)

    def call():
        torch.autograd.grad(op(x), x, cot)

    before = dict(R.launches)
    kernels = _device_kernels(call)
    assert R.launches == {"forward": before["forward"] + 4,
                          "adjoint": before["adjoint"] + 4}
    assert len(kernels) == 2, kernels
    assert all(v == 1 for v in kernels.values()), kernels
    assert any("rotsum_forward_kernel" in k for k in kernels), kernels
    assert any("rotsum_adjoint_kernel" in k for k in kernels), kernels


@pytest.mark.parametrize("H,W", [(256, 256), (97, 97), (96, 128),
                                 (128, 70)])
def test_rotsum_adjoint_is_the_transpose(cuda, H, W):
    """<R x, y> = <x, R^T y> within 1e-5 relative (sums in float64), and
    the pair against the plain version, square and non-square."""
    from wire_tpu_torch.ops import rotsum as R
    rng = np.random.default_rng(H * W)
    angles = rng.uniform(-200, 400, 37).astype(np.float32)
    img = torch.tensor(rng.random((H, W)).astype(np.float32), device=cuda)
    cot = torch.tensor(rng.normal(size=(37, W)).astype(np.float32),
                       device=cuda)
    out = {}
    for name, fn in (("kernel", R.rotate_project),
                     ("plain", R.rotate_project_plain)):
        x = img.clone().requires_grad_(True)
        y = fn(x, angles)
        (gx,) = torch.autograd.grad(y, x, cot)
        out[name] = (y.detach(), gx)
    y, gx = out["kernel"]
    lhs = float((y.double() * cot.double()).sum())
    rhs = float((img.double() * gx.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (lhs, rhs)
    for a, b in zip(out["kernel"], out["plain"]):
        err = float((a - b).abs().max())
        assert err <= REL * float(b.abs().max()), err


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
                                   (96, 7, 49), (729, 100, 365)])
def test_line_sample_kernel_matches_plain(cuda, P, A, K):
    """The spectrum gather/scatter pair against sample_spectrum_plain on a
    random unshifted spectrum with operators/radon.py's tables (P 729: odd,
    a 168^2 image), one launch each way."""
    from wire_tpu_torch.operators import radon as TR
    from wire_tpu_torch.ops import line_sample as LS
    rng = np.random.default_rng(P)
    angles = np.linspace(0, 180, A, dtype=np.float32)
    centre, gy, gx, uncentre = TR._fourier_consts(P, angles, cuda)
    assert gy.shape == (A, K)

    def cplx(shape):
        return torch.view_as_complex(torch.tensor(
            rng.normal(size=shape + (2,)).astype(np.float32), device=cuda))
    F, cot = cplx((P, P)), cplx((A, K))

    def run(fn):
        x = F.clone().requires_grad_(True)
        y = fn(x, centre, gy, gx, uncentre)
        (g,) = torch.autograd.grad(y, x, cot)
        return {"slice": torch.view_as_real(y.detach()),
                "F_bar": torch.view_as_real(g)}

    before = dict(LS.launches)
    got = run(LS.sample_spectrum)
    torch.cuda.synchronize()
    assert LS.launches == {"gather": before["gather"] + 1,
                           "scatter": before["scatter"] + 1}
    want = run(LS.sample_spectrum_plain)
    assert LS.launches == {"gather": before["gather"] + 1,
                           "scatter": before["scatter"] + 1}
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= REL * float(w.abs().max()), (name, err)


def test_fourier_operator_refuses_angles_that_require_grad(cuda):
    # draws nothing from torch's generator, so later tests that do see the
    # same inputs as without this test
    from wire_tpu_torch.operators import radon as TR
    img = torch.zeros((32, 32), device=cuda)
    angles = torch.linspace(0, 180, 30, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="constant"):
        TR.radon(img, angles, method="fourier")


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


def _assert_rel_to_float64(got, plain, *args, **kwargs):
    """_assert_rel of ``got`` against ``plain(*args, **kwargs)`` run in
    float64 (every tensor and float input cast, chip_smoke.float64_tree):
    the reference of mscale2_step and of the wire2d_mlp CT-frequency width
    case, whose fp32 plain versions lie near or past REL x max from their
    float64 runs."""
    from chip_smoke import float64_tree
    want = plain(*float64_tree(args), **float64_tree(kwargs))
    for name, w in want.items():
        assert w.dtype == torch.float64, (name, w.dtype)
    _assert_rel(got, want)


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


REAL_STEP_CASES = [
    (700, (2, 48, 40, 3), ("srelu", "gauss"), 650, 650 * 3.0 + 1.0),
    (700, (2, 48, 40, 3), (SEGMENTS, "relu"), None, None),
    (4099, (26, 64, 64, 64, 3), ("relu",) * 3, 4000, None),
    (65536, (2, 256, 256, 256, 3), ("qspline",) * 3, None, None)]


@pytest.mark.parametrize("n,widths,kinds,nvalid,denom", REAL_STEP_CASES)
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


# (n, widths, kinds, nvalid, denom): d = 26 (posenc's first layer on the
# tensor cores, its dcoords) and d = 5; hidden widths that are not
# multiples of 4 (odd, even) against the 64-column tiles, a hidden width
# of 8 (the narrow kernels); n 700, 4,099 and 65,537 against the 128-row
# tiles and the 512-, 1,024- and 2,048-row chunks
REAL_WIDTHS = [
    (700, (26, 37, 33, 3), ("relu", "qspline"), 650, 1951.0),
    (700, (26, 64, 64, 64, 3), ("relu",) * 3, None, None),
    (4099, (2, 254, 250, 3), ("qspline",) * 2, 4000, None),
    (65537, (2, 255, 3), ("srelu",), 65000, None),
    (700, (2, 8, 13, 3), ("cspline", "gauss"), None, 777.0),
    (1000, (5, 20, 2), ("sine",), None, None)]


def _real_width_case(n, widths, device):
    """canon (seeded _canon), coords (n, d), target, gt and a cotangent (n,
    o), numpy-seeded."""
    canon = _canon(widths, device, seed=n + widths[1])
    rng = np.random.default_rng(n)
    o = widths[-1]
    return (canon,) + tuple(
        torch.tensor(a.astype(np.float32), device=device) for a in (
            rng.uniform(-1, 1, (n, widths[0])), rng.uniform(0, 1, (n, o)),
            rng.uniform(0, 1, (n, o)), rng.normal(size=(n, o))))


@pytest.mark.parametrize("n,widths,kinds,nvalid,denom", REAL_WIDTHS)
@pytest.mark.parametrize("which", ["step", "pair"])
def test_real_tensor_cores_match_plain_at_every_width(cuda, which, n, widths,
                                                      kinds, nvalid, denom):
    """real_step (nvalid, denom, metrics) and the real_mlp pair (dcoords
    included) at REAL_WIDTHS against their fp32 plain versions, each
    through its kernel once (every card-test case's fp32 plain run lies
    within 1.1e-6 x max of its float64 run: tools/port_real_reference.py)."""
    from wire_tpu_torch.ops import real_mlp as RM
    canon, c, t, gt, g = _real_width_case(n, widths, cuda)
    before = dict(RM.launches)
    if which == "step":
        kw = dict(nvalid=nvalid, denom=denom, gt=gt, want_metrics=True)
        got = _step_flat(*RM.real_step(canon, c, t, kinds, **kw))
        torch.cuda.synchronize()
        assert RM.launches["step"] == before["step"] + 1
        _assert_rel(got, _step_flat(*RM.real_step_plain(canon, c, t, kinds,
                                                        **kw)))
        return
    got = _real_vjp(lambda p, x: RM.real_mlp(p, x, kinds), canon, c, g)
    torch.cuda.synchronize()
    assert RM.launches["forward"] == before["forward"] + 1
    assert RM.launches["backward"] == before["backward"] + 1
    _assert_rel(got, _real_vjp(lambda p, x: RM.real_mlp_plain(p, x, kinds),
                               canon, c, g))


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
    _assert_rel_to_float64(got, _mscale2_plain, canon, comb, c, t, kinds,
                           inv, nvalid=nvalid, denom=denom, gt=gt,
                           want_metrics=True)


def _mscale2_plain(*args, **kwargs):
    from wire_tpu_torch.ops import mscale2_step as MS
    return _tree_flat(*MS.mscale2_step_plain(*args, **kwargs))


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


# ---- mfn_step and the mfn_mlp pair: the Gabor MFN -------------------------

def _mfn_case(n, d, hf, layers, out, device, seed=0):
    model = get_inr("mfn", in_features=d, out_features=out,
                    hidden_features=hf, hidden_layers=layers)
    params = model.init(torch.Generator().manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    c, t, gt, g = (torch.tensor(a.astype(np.float32), device=device)
                   for a in (rng.uniform(-1, 1, (n, d)),
                             rng.uniform(0, 1, (n, out)),
                             rng.uniform(0, 1, (n, out)),
                             rng.normal(size=(n, out))))
    return model, params, c, t, gt, g


def _mfn_vjp(fn, params, coords, g):
    from wire_tpu_torch import tree
    flat = tree.leaves(params)
    leaves = [v.detach().requires_grad_(True) for _, v in flat]
    c = coords.detach().requires_grad_(True)
    y = fn(tree.unflatten([p for p, _ in flat], leaves), c)
    grads = torch.autograd.grad(y, leaves + [c], g)
    out = {"y": y.detach(), "dcoords": grads[-1]}
    out.update({str(p): gr for (p, _), gr in zip(flat, grads[:-1])})
    return out


@pytest.mark.parametrize("n,d,hf,layers,out,nvalid,denom", [
    (65536, 2, 300, 2, 3, None, None), (700, 3, 91, 3, 1, 650, 1951.0),
    (4099, 2, 256, 1, 3, 4000, None)])
def test_mfn_step_kernel_matches_plain(cuda, n, d, hf, layers, out, nvalid,
                                       denom):
    from wire_tpu_torch.ops import mfn as MF
    model, params, c, t, gt, _ = _mfn_case(n, d, hf, layers, out, cuda)
    before = MF.launches["step"]
    got = _tree_flat(*MF.mfn_step(params, c, t, model.spec, nvalid=nvalid,
                                  denom=denom, gt=gt, want_metrics=True))
    torch.cuda.synchronize()
    assert MF.launches["step"] == before + 1
    want = _tree_flat(*MF.mfn_step_plain(params, c, t, model.spec,
                                         nvalid=nvalid, denom=denom, gt=gt,
                                         want_metrics=True))
    assert got.keys() == want.keys()
    _assert_rel(got, want)


@pytest.mark.parametrize("n,d,hf,layers,out", [
    (65536, 2, 256, 2, 3), (700, 3, 91, 3, 1), (4099, 2, 300, 0, 1)])
def test_mfn_mlp_kernel_matches_plain(cuda, n, d, hf, layers, out):
    from wire_tpu_torch.ops import mfn as MF
    model, params, c, _, _, g = _mfn_case(n, d, hf, layers, out, cuda)
    before = dict(MF.launches)
    got = _mfn_vjp(lambda p, x: MF.mfn_mlp(p, x, model.spec), params, c, g)
    torch.cuda.synchronize()
    assert MF.launches["forward"] == before["forward"] + 1
    assert MF.launches["backward"] == before["backward"] + 1
    want = _mfn_vjp(lambda p, x: MF.mfn_mlp_plain(p, x, model.spec), params,
                    c, g)
    _assert_rel(got, want)


def test_mfn_kernels_are_deterministic(cuda):
    """Two calls of the step and of the pair give identical bits (no float
    atomics), the step reusing its scratch."""
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops.wire_step import StepScratch
    model, params, c, t, gt, g = _mfn_case(5000, 2, 300, 2, 3, cuda)
    scratch = StepScratch()
    a, b = (_tree_flat(*MF.mfn_step(params, c, t, model.spec, gt=gt,
                                    want_metrics=True, scratch=scratch))
            for _ in range(2))
    for name in a:
        assert torch.equal(a[name], b[name]), name
    fn = lambda p, x: MF.mfn_mlp(p, x, model.spec)  # noqa: E731
    a, b = _mfn_vjp(fn, params, c, g), _mfn_vjp(fn, params, c, g)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_mfn_at_extreme_phase_kernel_matches_plain(cuda):
    """Every filter's w scaled until max |x w| ~ 8,000 (the JAX package's
    extreme-phase case): the kernels form the phase as the plain version
    does, so the bound holds there too."""
    from wire_tpu_torch.ops import mfn as MF
    model, params, c, _, _, g = _mfn_case(512, 2, 64, 2, 3, cuda, seed=7)
    for k in params:
        if k.startswith("gabor_"):
            w = params[k]["w"]
            params[k]["w"] = (w * (8000.0 / float((c @ w).abs().max()))
                              ).contiguous()
    got = _mfn_vjp(lambda p, x: MF.mfn_mlp(p, x, model.spec), params, c, g)
    want = _mfn_vjp(lambda p, x: MF.mfn_mlp_plain(p, x, model.spec), params,
                    c, g)
    _assert_rel(got, want)


def test_mfn_mlp_leading_axes_and_no_grad(cuda):
    from wire_tpu_torch.ops import mfn as MF
    model, params, c, _, _, g = _mfn_case(200, 2, 91, 2, 3, cuda)
    got = _mfn_vjp(lambda p, x: MF.mfn_mlp(p, x, model.spec), params,
                   c.reshape(4, 50, 2), g.reshape(4, 50, 3))
    want = _mfn_vjp(lambda p, x: MF.mfn_mlp_plain(p, x, model.spec), params,
                    c.reshape(4, 50, 2), g.reshape(4, 50, 3))
    assert got["y"].shape == (4, 50, 3)
    _assert_rel(got, want)
    before = dict(MF.launches)
    with torch.no_grad():
        y = MF.mfn_mlp(params, c.reshape(4, 50, 2), model.spec)
    assert MF.launches["backward"] == before["backward"]
    assert torch.equal(y, got["y"])


# (n, d, hidden_features, L, o, nvalid, denom): h = 6 (the links and their
# weight gradients on the narrow kernels), 13, 91 (odd), 256, 300 (even, a
# multiple of 4) and 302 against the 64-column tiles, K = h against the
# 32-deep slices, k = 1-4 filters, d 1-3, o 1 and 3, n 700 and 65,537
# against the 128-row tiles and the 512-row filter and 1,024-row weight
# gradient chunks
MFN_WIDTHS = [
    (700, 2, 6, 2, 3, 650, 1951.0), (700, 3, 13, 3, 1, None, None),
    (700, 1, 91, 1, 3, 600, None), (700, 2, 256, 0, 1, None, 777.0),
    (700, 2, 302, 2, 3, 699, None), (65537, 2, 300, 2, 3, 65000, None),
    (65537, 3, 91, 1, 1, None, 196000.0)]


def _mfn_part_need(n, h, o):
    """Floats mfn_step's `part` workspace must hold (csrc/mfn.cu): the
    links' weight-gradient chunk partials ((h + 1) x h over 1,024-row
    chunks, 512-row ones where h <= 8), the final layer's ((h + 1) x o over
    512-row chunks), the nine filter sums per column over 512-row chunks
    and their totals, and two SSE partials per 64-row block."""
    def chunks(r):
        return -(-n // r)
    return max(chunks(512 if h <= 8 else 1024) * (h + 1) * h,
               chunks(512) * (h + 1) * o, (chunks(512) + 1) * 9 * h,
               2 * chunks(64))


@pytest.mark.parametrize("n,d,hf,layers,out,nvalid,denom", MFN_WIDTHS)
def test_mfn_step_tensor_cores_match_plain_at_every_width(
        cuda, n, d, hf, layers, out, nvalid, denom):
    """mfn_step with its links on wire_tc.cuh's 3xTF32 loop (the narrow
    kernel at h = 6): within the bound of the plain version, two calls
    bit-equal, one launch each, and nothing written past any scratch
    buffer (a NaN tail behind each stays as it was)."""
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops.wire_step import StepScratch
    model, params, c, t, gt, _ = _mfn_case(n, d, hf, layers, out, cuda,
                                           seed=n + hf)
    h, k = hf, layers + 1
    need = MF._lib().mfn_part_floats(n, d, h, out)
    assert need >= _mfn_part_need(n, h, out)
    shapes = {"mfn_z": (k, n, h), "mfn_l": (max(k - 1, 1), n, h),
              "mfn_dl": (2, n, h), "mfn_dg": (n, h), "mfn_g": (n, out),
              "mfn_part": (need,)}
    scratch = StepScratch()
    bigs = []
    for name, shape in shapes.items():
        scratch._bufs[name], big = _nan_tailed(shape, cuda)
        bigs.append((name, big, int(np.prod(shape))))
    before = MF.launches["step"]
    runs = [_tree_flat(*MF.mfn_step(params, c, t, model.spec, nvalid=nvalid,
                                    denom=denom, gt=gt, want_metrics=True,
                                    scratch=scratch)) for _ in range(2)]
    torch.cuda.synchronize()
    assert MF.launches["step"] == before + 2
    for name, big, numel in bigs:
        assert scratch._bufs[name].data_ptr() == big.data_ptr(), name
        assert torch.isnan(big[numel:]).all(), name
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name
    want = _tree_flat(*MF.mfn_step_plain(params, c, t, model.spec,
                                         nvalid=nvalid, denom=denom, gt=gt,
                                         want_metrics=True))
    _assert_rel(runs[0], want)


# ---- wire2d_step and the wire2d_mlp pair: WIRE-2D ------------------------

def _wire2d_case(n, hf, layers, out, device, seed=0, lead=(),
                 freq=(7.0, 8.0)):
    model = get_inr("wire2d", in_features=2, out_features=out,
                    hidden_features=hf, hidden_layers=layers,
                    first_omega0=freq[0], hidden_omega0=freq[0],
                    scale=freq[1])
    params = model.init(torch.Generator().manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    c, t, gt, g = (torch.tensor(a.astype(np.float32), device=device)
                   for a in (rng.uniform(-1, 1, lead + (n, 2)),
                             rng.uniform(0, 1, (n, out)),
                             rng.uniform(0, 1, (n, out)),
                             rng.normal(size=lead + (n, out))))
    return model, params, c, t, gt, g


def _wire2d_vjp(fn, params, coords, g, dcoords=True):
    from wire_tpu_torch import tree
    flat = tree.leaves(params)
    leaves = [v.detach().requires_grad_(True) for _, v in flat]
    c = coords.detach().requires_grad_(dcoords)
    y = fn(tree.unflatten([p for p, _ in flat], leaves), c)
    ins = leaves + ([c] if dcoords else [])
    grads = torch.autograd.grad(y, ins, g, allow_unused=True)
    out = {"y": y.detach()}
    out.update({str(i): torch.zeros_like(x) if gr is None else gr
                for i, (x, gr) in enumerate(zip(ins, grads))})
    return out


@pytest.mark.parametrize("n,hf,layers,out,nvalid,denom", [
    (65536, 300, 2, 3, None, None), (700, 300, 1, 1, 650, 651.0),
    (4099, 96, 3, 3, 4000, None)])
def test_wire2d_step_kernel_matches_plain(cuda, n, hf, layers, out, nvalid,
                                          denom):
    from wire_tpu_torch.ops import wire2d as W2
    model, params, c, t, gt, _ = _wire2d_case(n, hf, layers, out, cuda)
    before = W2.launches["step"]
    got = _tree_flat(*W2.wire2d_step(params, c, t, model.spec, nvalid=nvalid,
                                     denom=denom, gt=gt, want_metrics=True))
    torch.cuda.synchronize()
    assert W2.launches["step"] == before + 1
    want = _tree_flat(*W2.wire2d_step_plain(params, c, t, model.spec,
                                            nvalid=nvalid, denom=denom,
                                            gt=gt, want_metrics=True))
    assert got.keys() == want.keys()
    _assert_rel(got, want)


@pytest.mark.parametrize("n,hf,layers,out,dcoords", [
    (65536, 300, 2, 1, False), (65536, 300, 2, 3, True),
    (700, 91, 3, 1, True), (4099, 300, 0, 3, True)])
def test_wire2d_mlp_kernel_matches_plain(cuda, n, hf, layers, out, dcoords):
    from wire_tpu_torch.ops import wire2d as W2
    model, params, c, _, _, g = _wire2d_case(n, hf, layers, out, cuda)
    before = dict(W2.launches)
    got = _wire2d_vjp(lambda p, x: W2.wire2d_mlp(p, x, model.spec), params,
                      c, g, dcoords)
    torch.cuda.synchronize()
    assert W2.launches["forward"] == before["forward"] + 1
    assert W2.launches["backward"] == before["backward"] + 1
    want = _wire2d_vjp(lambda p, x: W2.wire2d_mlp_plain(p, x, model.spec),
                       params, c, g, dcoords)
    _assert_rel(got, want)


def test_wire2d_kernels_are_deterministic(cuda):
    """Two calls of the step and of the pair give identical bits (no float
    atomics), the step reusing its scratch."""
    from wire_tpu_torch.ops import wire2d as W2
    from wire_tpu_torch.ops.wire_step import StepScratch
    model, params, c, t, gt, g = _wire2d_case(5000, 300, 2, 3, cuda)
    scratch = StepScratch()
    a, b = (_tree_flat(*W2.wire2d_step(params, c, t, model.spec, gt=gt,
                                       want_metrics=True, scratch=scratch))
            for _ in range(2))
    for name in a:
        assert torch.equal(a[name], b[name]), name
    fn = lambda p, x: W2.wire2d_mlp(p, x, model.spec)  # noqa: E731
    a, b = _wire2d_vjp(fn, params, c, g), _wire2d_vjp(fn, params, c, g)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_wire2d_mlp_leading_axes_and_no_grad(cuda):
    """(4, 50, 2) coordinates give (4, 50, o) and the plain version's
    gradients; without a gradient the forward alone runs, equals the pair's
    and peaks within its two ping-pong planes + 16 MiB."""
    from wire_tpu_torch.ops import wire2d as W2
    model, params, c, _, _, g = _wire2d_case(50, 300, 2, 3, cuda, lead=(4,))
    got = _wire2d_vjp(lambda p, x: W2.wire2d_mlp(p, x, model.spec), params,
                      c, g)
    want = _wire2d_vjp(lambda p, x: W2.wire2d_mlp_plain(p, x, model.spec),
                       params, c, g)
    assert got["y"].shape == (4, 50, 3)
    _assert_rel(got, want)
    model, params, c, _, _, g = _wire2d_case(65536, 300, 2, 1, cuda)
    with_grad = _wire2d_vjp(lambda p, x: W2.wire2d_mlp(p, x, model.spec),
                            params, c, g, dcoords=False)["y"]
    before = dict(W2.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = W2.wire2d_mlp(params, c, model.spec)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert W2.launches["forward"] == before["forward"] + 1
    assert W2.launches["backward"] == before["backward"]
    assert torch.equal(y, with_grad)
    assert peak <= 2 * 65536 * 300 * 4 + 16 * 2 ** 20, peak


@pytest.mark.parametrize("fit", ["pointwise", "operator"])
def test_wire2d_fits_launch_the_kernels(cuda, fit):
    """get_inr('wire2d') through fit_pointwise takes one wire2d_step per
    epoch, through fit_operator one pair per iteration, and nothing of the
    WIRE kernels."""
    from wire_tpu_torch.ops import wire2d as W2
    from wire_tpu_torch.train.trainer import (FitConfig, fit_operator,
                                              fit_pointwise)
    model, params, c, t, _, _ = _wire2d_case(1024, 64, 2, 1, cuda)
    before, ws = dict(W2.launches), WS.wire_step.launches
    cfg = FitConfig(niters=4, maxpoints=1024)
    if fit == "pointwise":
        res = fit_pointwise(model, params, c, t, cfg, device=cuda)
        want = dict(before, step=before["step"] + 4)
    else:
        res = fit_operator(model, params, c, t.reshape(32, 32),
                           lambda f: f, cfg, field_shape=(32, 32),
                           track="loss", device=cuda)
        want = dict(before, forward=before["forward"] + 4,
                    backward=before["backward"] + 4)
    assert W2.launches == want
    assert WS.wire_step.launches == ws
    assert np.isfinite(res.best_mse)


def test_sweep_denoise_launches_each_familys_kernel(cuda, tmp_path):
    """One short sweep denoise run per family on the card: wire takes
    wire_step, siren, relu, posenc and gauss real_step, mfn mfn_step, one
    launch per epoch."""
    from wire_tpu_torch.apps import sweep
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import real_mlp as RM
    counters = {"wire": lambda: WS.wire_step.launches,
                "mfn": lambda: MF.launches["step"]}
    for nonlin in sweep.NONLINS:
        count = counters.get(nonlin, lambda: RM.launches["step"])
        before = count()
        out = sweep.sweep_denoise(results_dir=str(tmp_path / nonlin),
                                  niters=3, size=64, nonlins=[nonlin])
        assert count() == before + 3, nonlin
        assert np.isfinite(out[nonlin]["Best PSNR"]), nonlin


@pytest.mark.parametrize("fit", ["pointwise", "operator"])
def test_step_ms_leaves_the_first_step_out(cuda, fit):
    """FitResult.step_ms times steps 1 .. n-1 on the card: a 0.3 s host
    stall in the first step (where a kernel library's build would fall)
    stays outside it, one in a later step does not."""
    import time
    from wire_tpu_torch.train.trainer import (FitConfig, fit_operator,
                                              fit_pointwise)
    for stall_at in (0, 2):
        model, params, coords, target, _ = _case(256, 32, 1, 1, cuda)
        name = "step_grads" if fit == "pointwise" else "apply"
        inner, calls = getattr(model, name), []

        def stalled(*a, **k):
            if len(calls) == stall_at:
                time.sleep(0.3)
            calls.append(1)
            return inner(*a, **k)
        setattr(model, name, stalled)
        cfg = FitConfig(niters=5, maxpoints=256)
        if fit == "pointwise":
            res = fit_pointwise(model, params, coords, target, cfg,
                                device=cuda)
        else:
            res = fit_operator(model, params, coords, target.reshape(16, 16),
                               lambda f: f, cfg, field_shape=(16, 16),
                               track="loss", device=cuda)
        if stall_at == 0:
            assert res.step_ms < 30.0, res.step_ms
        else:
            assert res.step_ms > 0.3e3 / 4, res.step_ms


# ---- strided coordinates (fault C.7) ---------------------------------------

def _pair_case(pair, device, n=700):
    """(fn(params, coords), params, out) of one CUDA MLP pair at n rows."""
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops import wire2d as W2
    from wire_tpu_torch.ops import wire_mlp as WM
    if pair == "real_mlp":
        canon = _canon((2, 64, 64, 3), device, seed=30)
        return (lambda p, x: RM.real_mlp(p, x, ("qspline",) * 2), canon, 3)
    nonlin, call = {"wire_mlp": ("wire", WM.wire_mlp),
                    "mfn_mlp": ("mfn", MF.mfn_mlp),
                    "wire2d_mlp": ("wire2d", W2.wire2d_mlp)}[pair]
    model = get_inr(nonlin, in_features=2, out_features=3,
                    hidden_features=64, hidden_layers=2)
    params = model.init(torch.Generator().manual_seed(31), device)
    return (lambda p, x: call(p, x, model.spec), params, 3)


def _tree_vjp(fn, params, coords, g):
    """Output, coordinate gradient and every parameter gradient of fn."""
    from wire_tpu_torch import tree
    flat = tree.leaves(params)
    leaves = [v.detach().requires_grad_(True) for _, v in flat]
    c = coords.detach().requires_grad_(True)
    y = fn(tree.unflatten([p for p, _ in flat], leaves), c)
    grads = torch.autograd.grad(y, leaves + [c], g)
    out = {"y": y.detach(), "dcoords": grads[-1]}
    out.update({str(p): gr for (p, _), gr in zip(flat, grads[:-1])})
    return out


@pytest.mark.parametrize("pair", ["wire_mlp", "real_mlp", "mfn_mlp",
                                  "wire2d_mlp"])
def test_pairs_take_a_transposed_coordinate_view(cuda, pair):
    """A transposed (n, d) view of a (d, n) array gives the contiguous
    call's output, coordinate gradient and parameter gradients bit for bit,
    as the CPU path and wire_tpu take it; without a gradient too."""
    fn, params, out = _pair_case(pair, cuda)
    rng = np.random.default_rng(32)
    base = torch.tensor(rng.uniform(-1, 1, (2, 700)).astype(np.float32),
                        device=cuda)
    strided = base.t()
    assert not strided.is_contiguous()
    g = torch.tensor(rng.normal(size=(700, out)).astype(np.float32),
                     device=cuda)
    got = _tree_vjp(fn, params, strided, g)
    want = _tree_vjp(fn, params, strided.contiguous(), g)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    with torch.no_grad():
        assert torch.equal(fn(params, strided), want["y"])


# ---- wire_step on the tensor cores ------------------------------------------

def _wire_step_part_need(n, d, h, o):
    """Floats the step's `part` workspace must hold: the hidden layers'
    weight-gradient partials over 1,024-row chunks, the first and final
    layers' over 512-row chunks (csrc/wire_tc.cuh), final_loss's two SSE
    partials per 64 rows (csrc/gemm_common.cuh)."""
    def chunks(rows):
        return -(-n // rows)
    return max(chunks(1024) * (2 * h + 1) * 2 * h,
               chunks(512) * (d + 1) * h, chunks(512) * (2 * h + 1) * o,
               2 * chunks(64))


@pytest.mark.parametrize("n,hf,layers,out,nvalid,denom", [
    (700, 8, 1, 3, 650, 1951.0), (700, 8, 3, 1, None, None),
    (700, 19, 2, 3, 600, None), (700, 19, 3, 1, None, 701.5),
    (700, 213, 1, 1, 699, None), (700, 213, 3, 3, None, None),
    (700, 300, 1, 1, None, None), (700, 300, 3, 3, 650, 2000.0),
    (65537, 300, 2, 3, 65000, None), (65537, 19, 1, 1, None, None),
    (65537, 213, 2, 3, None, 196000.0)])
def test_wire_step_tensor_cores_match_plain_at_every_width(
        cuda, n, hf, layers, out, nvalid, denom):
    """wire_step on wire_tc.cuh's 3xTF32 loop at h = 5, 13, 150 and 212
    complex units (hidden_features 8, 19, 213, 300), L 1-3, o 1 and 3,
    ragged n (700, 65,537), nvalid and denom: within the bound of the plain
    version, two calls bit-equal, one launch each, and nothing written past
    the `part` workspace (a NaN tail behind it stays as it was)."""
    model, params, c, t, gt = _case(n, hf, layers, out, cuda, seed=n + hf)
    h = params["first"]["w"].shape[1]
    lib = WS._lib()
    need = lib.wire_step_part_floats(n, 2, h, out)
    assert need >= _wire_step_part_need(n, 2, h, out)
    tail = 1 << 16
    big = torch.full((need + tail,), float("nan"), device=cuda)
    scratch = WS.StepScratch()
    scratch._bufs["part"] = big[:need]
    before = WS.wire_step.launches
    runs = [_flat(*WS.wire_step(params, c, t, model.spec, nvalid=nvalid,
                                denom=denom, gt=gt, want_metrics=True,
                                scratch=scratch)) for _ in range(2)]
    torch.cuda.synchronize()
    assert WS.wire_step.launches == before + 2
    assert scratch._bufs["part"].data_ptr() == big.data_ptr()
    assert torch.isnan(big[need:]).all()
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name
    want = _flat(*WS.wire_step_plain(params, c, t, model.spec, nvalid=nvalid,
                                     denom=denom, gt=gt, want_metrics=True))
    _assert_rel(runs[0], want)


# ---- mscale2_step across scales ---------------------------------------------

@pytest.mark.parametrize("n,ns,widths,kinds,nvalid,denom", [
    (700, 3, (2, 256, 256, 256, 3), ("qspline",) * 3, 650,
     650 * 3.0 + 1.0),
    (65537, 3, (2, 256, 256, 256, 3), ("qspline",) * 3, 65000, None),
    (700, 2, (2, 256, 256, 256, 3), ("qspline",) * 3, None, None),
    (300, 2, (2, 37, 33, 3), ("qspline", "cspline"), 290, None),
    (1000, 3, (2, 64, 48, 96, 1), ("cspline", "qspline", "gauss"), None,
     None)])
def test_mscale2_step_matches_plain_across_scales(
        cuda, n, ns, widths, kinds, nvalid, denom):
    """The trunk where its 128-row tiles straddle two scales (n % 128 !=
    0, so a tile reads two gammas), at ns 2 and 3, at the path's widths and
    at narrow ones: within the bound of the plain version run in float64,
    two calls bit-equal, and nothing written past any scratch buffer (a NaN
    tail behind each stays as it was)."""
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops.wire_step import StepScratch
    canon = _canon(widths, cuda, seed=n)
    comb = _comb(ns, widths[-1], cuda, n + 1)
    inv = (9.0, 0.25, 0.125)[:ns]
    rng = np.random.default_rng(n + 2)
    o, L, rows = widths[-1], len(widths) - 2, ns * n
    c, t, gt = (torch.tensor(a.astype(np.float32), device=cuda) for a in (
        rng.uniform(-1, 1, (n, 2)), rng.uniform(0, 1, (n, o)),
        rng.uniform(0, 1, (n, o))))
    lib = MS._lib()
    need = lib.mscale2_trunk_part_floats(rows, L, RM._ints(list(widths)))
    assert need >= _mscale2_part_need(rows, widths)
    maxw = max(widths[1:-1])
    shapes = {"ms_x": (rows, 2), "ms_y": (rows, o), "ms_dy": (rows, o),
              "ms_dv": (2, rows * maxw), "ms_zdv": (rows * maxw,),
              "ms_part": (need,),
              "ms_cpart": (lib.mscale2_comb_part_floats(n, ns, o),)}
    for l, w in enumerate(widths[1:-1]):
        shapes[f"ms_z{l}"] = shapes[f"ms_a{l}"] = (rows, w)
    scratch = StepScratch()
    bigs = []
    for name, shape in shapes.items():
        scratch._bufs[name], big = _nan_tailed(shape, cuda)
        bigs.append((name, big, int(np.prod(shape))))
    runs = [_tree_flat(*MS.mscale2_step(canon, comb, c, t, kinds, inv,
                                        nvalid=nvalid, denom=denom, gt=gt,
                                        want_metrics=True, scratch=scratch))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, big, numel in bigs:
        assert scratch._bufs[name].data_ptr() == big.data_ptr(), name
        assert torch.isnan(big[numel:]).all(), name
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name
    _assert_rel_to_float64(runs[0], _mscale2_plain, canon, comb, c, t, kinds,
                           inv, nvalid=nvalid, denom=denom, gt=gt,
                           want_metrics=True)


def _mscale2_part_need(rows, widths):
    """Floats mscale2_step's trunk `part` workspace must hold
    (csrc/real_tc.cuh): each weight gradient's chunk partials, (in + 1) x
    out over 512-row chunks where a side is at most 8 wide, else over
    1,024-row ones; the alpha column sums' over 2,048-row chunks."""
    def chunks(r):
        return -(-rows // r)
    need = 0
    dims = list(zip(widths[:-2], widths[1:-1])) + [widths[-2:]]
    for m, w in dims:
        per = 512 if min(m, w) <= 8 else 1024
        need = max(need, chunks(per) * (m + 1) * w)
    for w in widths[1:-1]:
        need = max(need, chunks(2048) * w)
    return need


# ---- wire2d on the tensor cores ---------------------------------------------

# (n, hidden_features, L, o, nvalid, denom): h = 5, 13, 150, 152 and 256
# units per head (odd, even, a multiple of 4) against the 16-unit quad and
# 32-unit paired tiles, K = 2h and 4h against the 32-deep slices, L 0-3,
# n 700 and 65,537 against the 128-row tiles and the weight gradients'
# 512- and 1,024-row chunks
WIRE2D_WIDTHS = [
    (700, 10, 0, 3, 650, 1951.0), (700, 10, 3, 1, None, None),
    (700, 26, 2, 3, 600, None), (700, 300, 1, 1, None, 777.0),
    (700, 300, 3, 3, 650, None), (700, 304, 2, 1, None, None),
    (700, 512, 1, 3, 699, None), (65537, 300, 2, 3, 65000, None),
    (65537, 304, 1, 1, None, 70000.0), (65537, 512, 2, 1, None, None),
    (65537, 26, 3, 3, None, None)]


def _wire2d_part_need(n, d, h, o):
    """Floats wire2d's `part` workspace must hold: the hidden layers'
    weight-gradient partials (2h + 1) x 4h over 1,024-row chunks, the first
    and final layers' over 512-row chunks (csrc/wire_tc.cuh), final_loss's
    two SSE partials per 64 rows (csrc/gemm_common.cuh)."""
    def chunks(rows):
        return -(-n // rows)
    return max(chunks(1024) * (2 * h + 1) * 4 * h,
               chunks(512) * (d + 1) * 2 * h, chunks(512) * (2 * h + 1) * o,
               2 * chunks(64))


def _nan_tailed(shape, device, tail=1 << 12):
    """A float32 tensor of ``shape`` at the head of a NaN-filled buffer
    ``tail`` floats longer: (view, buffer)."""
    numel = int(np.prod(shape))
    big = torch.full((numel + tail,), float("nan"), device=device)
    return big[:numel].view(shape), big


@pytest.mark.parametrize("n,hf,layers,out,nvalid,denom", WIRE2D_WIDTHS)
def test_wire2d_step_tensor_cores_match_plain_at_every_width(
        cuda, n, hf, layers, out, nvalid, denom):
    """wire2d_step on wire_tc.cuh's 3xTF32 loop at every width of
    WIRE2D_WIDTHS: within the bound of the plain version, two calls
    bit-equal, one launch each, and nothing written past any scratch
    buffer (a NaN tail behind each stays as it was)."""
    from wire_tpu_torch.ops import wire2d as W2
    model, params, c, t, gt, _ = _wire2d_case(n, hf, layers, out, cuda,
                                              seed=n + hf + layers)
    h, L = hf // 2, layers
    need = W2._lib().wire2d_part_floats(n, 2, h, out)
    assert need >= _wire2d_part_need(n, 2, h, out)
    scratch = WS.StepScratch()
    bigs = []
    for name, shape in (
            ("wire2d_acts", (L + 1, n, 2 * h)),
            ("wire2d_zs", (max(L, 1), n, 4 * h)),
            ("wire2d_z1", (n, 2 * h)), ("wire2d_g", (n, out)),
            ("wire2d_dz", (max(min(L, 2), 1), n, 4 * h)),
            ("wire2d_dz1", (n, 2 * h)), ("wire2d_part", (need,))):
        scratch._bufs[name], big = _nan_tailed(shape, cuda)
        bigs.append((name, big, int(np.prod(shape))))
    before = W2.launches["step"]
    runs = [_tree_flat(*W2.wire2d_step(params, c, t, model.spec,
                                       nvalid=nvalid, denom=denom, gt=gt,
                                       want_metrics=True, scratch=scratch))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert W2.launches["step"] == before + 2
    for name, big, numel in bigs:
        assert scratch._bufs[name].data_ptr() == big.data_ptr(), name
        assert torch.isnan(big[numel:]).all(), name
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name
    want = _tree_flat(*W2.wire2d_step_plain(params, c, t, model.spec,
                                            nvalid=nvalid, denom=denom,
                                            gt=gt, want_metrics=True))
    _assert_rel(runs[0], want)


# the pair at the CT frequencies (omega0 3, sigma 12), h 5, L 3, o 1: its
# fp32 plain version lies 8.65e-5 x max from its own float64 run, so the
# case is held to the float64 run
WIRE2D_CT_FREQ = (3.0, 12.0)


@pytest.mark.parametrize("n,hf,layers,out,nvalid,denom,freq", [
    w + ((7.0, 8.0),) for w in WIRE2D_WIDTHS] + [
    (700, 10, 3, 1, None, None, WIRE2D_CT_FREQ)])
def test_wire2d_mlp_tensor_cores_match_plain_at_every_width(
        cuda, n, hf, layers, out, nvalid, denom, freq):
    """The wire2d_mlp pair at every width of WIRE2D_WIDTHS (with dcoords) at
    the denoise frequencies, and at h 5, L 3, o 1 at the CT ones: through
    the wrapper within the bound of the plain version (run in float64 at
    the CT frequencies); through the C entry points with NaN-tailed
    scratch and outputs, bit-equal to the wrapper twice over, nothing
    written past any buffer."""
    from wire_tpu_torch import tree
    from wire_tpu_torch.ops import wire2d as W2
    model, params, c, _, _, g = _wire2d_case(n, hf, layers, out, cuda,
                                             seed=n + hf, freq=freq)
    spec, h, L, d = model.spec, hf // 2, layers, 2

    def fn(p, x):
        return W2.wire2d_mlp(p, x, spec)

    def plain(p, x, cot):
        return _wire2d_vjp(lambda pp, xx: W2.wire2d_mlp_plain(pp, xx, spec),
                           p, x, cot)
    got = _wire2d_vjp(fn, params, c, g)
    torch.cuda.synchronize()
    if freq == WIRE2D_CT_FREQ:
        _assert_rel_to_float64(got, plain, params, c, g)
    else:
        _assert_rel(got, plain(params, c, g))

    lib, net = W2._lib(), W2._Net(params, c, spec, "wire2d_mlp")
    w = net.w
    paths = [p for p, _ in tree.leaves(params)]
    for _ in range(2):
        bigs = []

        def buf(shape):
            view, big = _nan_tailed(shape, cuda)
            bigs.append((big, view.numel()))
            return view
        pred, acts, zs, z1 = (buf(s) for s in (
            (n, out), (L + 1, n, 2 * h), (max(L, 1), n, 4 * h), (n, 2 * h)))
        gw1, gW2, gfW, dc, dz, dz1, part = (buf(s) for s in (
            (d + 1, 2 * h), (L, 2 * h + 1, 4 * h), (2 * h + 1, out), (n, d),
            (max(min(L, 2), 1), n, 4 * h), (n, 2 * h),
            (lib.wire2d_part_floats(n, d, h, out),)))
        stream = W2._stream(cuda)
        assert lib.wire2d_forward(*W2._ptrs(
            [c, w["w1"], w["b1"], w["W2"], w["B2"], w["fW"], w["fb"], pred,
             acts, zs, z1]), *net.dims, stream) == 0
        assert lib.wire2d_backward(*W2._ptrs(
            [c, g, w["w1"], w["W2T"], w["fWT"], acts, zs, z1, gw1, gW2, gfW,
             dc, dz, dz1, part]), *net.dims, stream) == 0
        torch.cuda.synchronize()
        for big, numel in bigs:
            assert torch.isnan(big[numel:]).all()
        by_path = dict(tree.leaves(W2.unstack_grads(gw1, gW2, gfW,
                                                    net.final_bi, L)))
        direct = {"y": pred}
        direct.update({str(i): by_path[p] for i, p in enumerate(paths)})
        direct[str(len(paths))] = dc
        for name in got:
            assert torch.equal(direct[name], got[name]), name


def _sass_hmma(name):
    """HMMA instructions in csrc/<name>.cu's built library."""
    import os
    import subprocess
    from wire_tpu_torch.ops import build
    build.load(name)
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        pytest.skip("the CUDA toolkit has no cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build.library_path(name)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return sass.count("HMMA")


def test_tensor_cores_run_where_they_were_put(cuda):
    """wire_step, wire_mlp, mscale2_step, wire2d (wire2d_step and the
    wire2d_mlp pair), mfn (mfn_step and the mfn_mlp pair) and real_mlp
    (real_step and the real_mlp pair) have tensor-core instructions in
    their SASS: every library with a GEMM runs it on the tensor cores."""
    for name in ("wire_step", "wire_mlp", "mscale2_step", "wire2d", "mfn",
                 "real_mlp"):
        assert _sass_hmma(name) > 0, name
