"""The CUDA kernels (wire_step, wire_mlp, rotsum, line_sample, real_mlp's
pair and step, mscale2_step, mfn's step and pair, wire2d's step and pair)
and their replica axes against their plain PyTorch versions on the card,
the batched fits against their serial fits, the sweep app's and the
occupancy app's fits launching their kernels, every family with a step
hook stepping through its kernel and the two without launching none, and
the trainers' step timing leaving the first step out (marked ``gpu``;
skipped where no CUDA device is present; every input drawn from a seeded
generator):

    python -m pytest tests/test_torch_gpu.py -m gpu -p no:randomly
"""
import os

import numpy as np
import pytest
import torch

from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.ops import wire_step as WS
from wire_tpu_torch.train.profiling import launches

pytestmark = pytest.mark.gpu

# max abs err <= REL x max |plain| per output: fp32 sums in another order
REL = 1e-4


def _rand(shape, seed, device):
    """U[0, 1) floats from a seeded CPU generator, moved to ``device``: a
    test's inputs do not depend on what earlier tests drew."""
    return torch.rand(shape, generator=torch.Generator().manual_seed(
        seed)).to(device)


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
    before = launches("wire_step")["step"]
    got = _flat(*WS.wire_step(params, c, t, model.spec, nvalid=nvalid,
                              denom=denom, gt=gt, want_metrics=True))
    torch.cuda.synchronize()
    assert launches("wire_step")["step"] == before + 1
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


def test_wire_step_at_the_occupancy_chunks_matches_plain(cuda):
    """wire_step at d 3 (the occupancy app: h 212, L 3, o 1) on the two
    chunks of one epoch (200,000 rows each, the second with 62,144 valid
    rows over a tail of sentinel rows) and a ragged n: the kernel against
    its reference (chip_smoke.occupancy_check: the plain step in float64 on
    the kernel's own pre-activations, fault C.10); and the sentinel rows
    add nothing: the kernel on the valid rows alone gives the second
    chunk's gradients and sums."""
    import chip_smoke as S
    from wire_tpu_torch.apps import occupancy as O
    cases = S.occupancy_cases(torch, WS, O, cuda)
    for what, case in cases.items():
        before = launches("wire_step")["step"]
        S.occupancy_check(torch, case, what)
        assert launches("wire_step")["step"] == before + 1
    params, c, t, spec = cases["wire_step occ_chunk1"][2]
    kw = cases["wire_step occ_chunk1"][3]
    nv = kw["nvalid"]
    assert nv == 62144 and c.shape == (200000, 3)
    chunk = S.tensors_of(*WS.wire_step(params, c, t, spec, **kw))
    valid = S.tensors_of(*WS.wire_step(
        params, c[:nv].contiguous(), t[:nv].contiguous(), spec,
        denom=kw["denom"], gt=t[:nv].contiguous(), want_metrics=True))
    chunk["pred"] = chunk["pred"][:nv]
    _assert_rel(chunk, valid)


def test_occupancy_app_launches_wire_step_twice_an_epoch(cuda, tmp_path):
    """Two epochs of the occupancy app at its full width (64^3, two
    200,000-row chunks an epoch): wire_step launches 2 x epochs times, no
    other kernel of the port launches, and wire.mat and wire.dae are
    written."""
    import os
    from wire_tpu_torch.apps import occupancy as O
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops import wire2d as W2
    from wire_tpu_torch.ops import wire_mlp as WM
    others = ("wire_mlp", "real_mlp", "mscale2_step", "mfn", "wire2d")
    before = [launches(c) for c in others]
    ws0 = launches("wire_step")["step"]
    out = O.run(results_dir=str(tmp_path), niters=2)
    assert launches("wire_step")["step"] == ws0 + 4
    assert [launches(c) for c in others] == before
    assert sorted(os.listdir(tmp_path / "occupancy")) == ["wire.dae",
                                                           "wire.mat"]
    assert out["result"].time_array.shape == (2,)
    assert np.isfinite(out["result"].best_rec).all()


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
    before = launches("wire_mlp")
    got = _vjp(lambda p, x: WM.wire_mlp(p, x, model.spec), params, c, g)
    torch.cuda.synchronize()
    assert launches("wire_mlp") == {
        "forward": before["forward"] + 1,
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
    before = launches("wire_mlp")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = WM.wire_mlp(leaves, c, model.spec)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert launches("wire_mlp") == {
        "forward": before["forward"] + 1,
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

    before = launches("rotsum")
    kernels = _device_kernels(call)
    assert launches("rotsum") == {
        "forward": before["forward"] + 4,
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
    img = _rand((64, 48), 21, cuda)
    angles = np.linspace(0, 180, 5, dtype=np.float32)
    before = launches("rotsum")
    got = TR.radon(img, angles, method="rotate")
    assert launches("rotsum")["forward"] == before["forward"] + 1
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
    before = launches("rotsum")
    y = R.rotate_project(x, angles)
    (gx,) = torch.autograd.grad(y, x, cot)
    torch.cuda.synchronize()
    assert launches("rotsum") == {
        "forward": before["forward"] + 1,
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

    before = launches("line_sample")
    got = run(LS.sample_spectrum)
    torch.cuda.synchronize()
    assert launches("line_sample") == {
        "gather": before["gather"] + 1,
        "scatter": before["scatter"] + 1}
    want = run(LS.sample_spectrum_plain)
    assert launches("line_sample") == {
        "gather": before["gather"] + 1,
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
    before = launches("real_mlp")
    got = _real_vjp(lambda p, x: RM.real_mlp(p, x, kinds), canon, c, g)
    torch.cuda.synchronize()
    assert launches("real_mlp")["forward"] == before["forward"] + 1
    assert launches("real_mlp")["backward"] == before["backward"] + 1
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
    c = _rand((1000, 2), 22, cuda) * 2 - 1
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
    before = launches("real_mlp")["step"]
    got = _step_flat(*RM.real_step(canon, c, t, kinds, nvalid=nvalid,
                                   denom=denom, gt=gt, want_metrics=True))
    torch.cuda.synchronize()
    assert launches("real_mlp")["step"] == before + 1
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
    before = launches("real_mlp")
    if which == "step":
        kw = dict(nvalid=nvalid, denom=denom, gt=gt, want_metrics=True)
        got = _step_flat(*RM.real_step(canon, c, t, kinds, **kw))
        torch.cuda.synchronize()
        assert launches("real_mlp")["step"] == before["step"] + 1
        _assert_rel(got, _step_flat(*RM.real_step_plain(canon, c, t, kinds,
                                                        **kw)))
        return
    got = _real_vjp(lambda p, x: RM.real_mlp(p, x, kinds), canon, c, g)
    torch.cuda.synchronize()
    assert launches("real_mlp")["forward"] == before["forward"] + 1
    assert launches("real_mlp")["backward"] == before["backward"] + 1
    _assert_rel(got, _real_vjp(lambda p, x: RM.real_mlp_plain(p, x, kinds),
                               canon, c, g))


def test_real_step_is_deterministic_and_reuses_scratch(cuda):
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops.wire_step import StepScratch
    widths = (2, 256, 256, 3)
    canon = _canon(widths, cuda, seed=9)
    c = _rand((5000, 2), 23, cuda) * 2 - 1
    t = _rand((5000, 3), 24, cuda)
    scratch = StepScratch()
    a, b = (_step_flat(*RM.real_step(canon, c, t, ("qspline",) * 2,
                                     want_metrics=True, scratch=scratch))
            for _ in range(2))
    for name in a:
        assert torch.equal(a[name], b[name]), name


REAL_STEP_FAMILIES = ("siren", "gauss", "relu", "posenc", "bspline_form",
                      "bspline_cubic", "bspline_srelu", "bspline_knots",
                      "bspline_mscale_1", "bspline_mscale_1_new",
                      "bspline_mscale_repIN")


def _family_kw(nonlin):
    """The factory keywords of test_real_family_fits_launch_the_kernels (and
    of tools/port_unseeded_trace.py, which traced its inputs): mscale_1
    folds to an identity first layer 2 -> 32 at scales (1, 2); _1_new and
    repIN tile the coordinates to 2 x 2 x 16 = 64 inputs."""
    kw = dict(hidden_features=64, out_features=3, sidelength=64,
              scale=0.5 if nonlin.startswith("bspline") else 2.0)
    if nonlin.startswith("bspline_mscale"):
        kw.update(scale_tensor=(1.0, 2.0), scaled_hidden_features=16)
    if nonlin in ("bspline_mscale_1_new", "bspline_mscale_repIN"):
        kw["in_features"] = 2 * 2 * 16
    return kw


@pytest.mark.parametrize("nonlin", REAL_STEP_FAMILIES)
def test_real_family_fits_launch_the_kernels(cuda, nonlin):
    """Every real family with a step hook steps through the kernel on the
    card and agrees with its reference, on seeded inputs: the family's
    plain path, but for relu and posenc the plain canonical step in float64
    on the kernel's own relu pattern (chip_smoke.
    relu_pattern_step_reference; C.9's reference: at 600 rows a relu unit
    within fp32 rounding of its kink, decided the other way, moves a
    gradient by up to 56 x the bound; tools/port_unseeded_trace.py found
    posenc failing so on 5 of 301 inputs), with the family's native
    gradients equal to the canonical ones it folds to."""
    import chip_smoke as S
    from wire_tpu_torch.nn import models as MM
    from wire_tpu_torch.ops import real_mlp as RM
    c = _rand((600, 2), 25, cuda) * 2 - 1
    t = _rand((600, 3), 26, cuda)
    kw = _family_kw(nonlin)
    model = get_inr(nonlin, **kw)
    plain = get_inr(nonlin, fused="never", **kw)
    params = model.init(torch.Generator().manual_seed(0), cuda)
    before = launches("real_mlp")["step"]
    got = model.step_grads(params, c, t, want_metrics=True)
    assert launches("real_mlp")["step"] == before + 1, nonlin
    if nonlin not in ("relu", "posenc"):
        want = plain.step_grads(params, c, t, want_metrics=True)
        _assert_rel(_tree_flat(*got), _tree_flat(*want))
        return
    spec = model.spec
    canon = MM._canon_relu(params, spec)
    x = MM._posenc_pre(c, spec)
    kinds = ("relu",) * len(canon["layers"])
    scratch = WS.StepScratch()
    got_c = S.real_step_tensors(RM, *RM.real_step(
        canon, x, t, kinds, want_metrics=True, scratch=scratch))
    acts = [scratch._bufs[f"real_a{l}"] for l in range(len(kinds))]
    want_c, _ = S.relu_pattern_step_reference(torch, RM, canon, x, t, kinds,
                                              {}, acts, nonlin)
    _assert_rel(got_c, want_c)
    names = ["first"] + [f"hidden_{i}" for i in range(spec.hidden_layers)]
    assert torch.equal(got[0], got_c["pred"])
    for i, name in enumerate(names):
        assert torch.equal(got[1][name]["w"], got_c[f"layers.{i}.w"])
        assert torch.equal(got[1][name]["b"], got_c[f"layers.{i}.beta"])
    for k in ("w", "b"):
        assert torch.equal(got[1]["final"][k], got_c[f"final.{k}"])


@pytest.mark.parametrize("nonlin", ["realgabor", "bspline_sig"])
def test_autodiff_families_launch_no_kernel(cuda, nonlin):
    """realgabor and bspline_sig have no step hook: their step and apply
    are autodiff of plain PyTorch ops and launch no kernel of the port."""
    from wire_tpu_torch.ops import real_mlp as RM
    c = _rand((600, 2), 31, cuda) * 2 - 1
    t = _rand((600, 3), 32, cuda)
    model = get_inr(nonlin, hidden_features=64, out_features=3, scale=2.0)
    params = model.init(torch.Generator().manual_seed(0), cuda)
    before = (launches("real_mlp"), launches("wire_step")["step"])
    pred, grads, sums = model.step_grads(params, c, t, want_metrics=True)
    model.apply(params, c)
    torch.cuda.synchronize()
    assert (launches("real_mlp"), launches("wire_step")["step"]) == before
    assert torch.isfinite(pred).all() and all(
        torch.isfinite(g).all() for _, g in _leaves(grads))


def _leaves(t):
    from wire_tpu_torch import tree
    return tree.leaves(t)


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
    before = launches("mscale2_step")["step"]
    got = _tree_flat(*MS.mscale2_step(canon, comb, c, t, kinds, inv,
                                      nvalid=nvalid, denom=denom, gt=gt,
                                      want_metrics=True))
    torch.cuda.synchronize()
    assert launches("mscale2_step")["step"] == before + 1
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
    c = _rand((5000, 2), 27, cuda) * 2 - 1
    t = _rand((5000, 3), 28, cuda)
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
    c = _rand((600, 2), 29, cuda) * 2 - 1
    t = _rand((600, 3), 30, cuda)
    cases = {
        "bspline_mscale_2": (dict(scale_tensor=(0.5, 2.0, 4.0)),
                             "mscale2_step"),
        "bspline_mscale_HL": (dict(scale=1.0, scale_tensor=(1.0, 2.0),
                                   scaled_hidden_features=300), "real_mlp"),
        "bspline_mscale_hier": (dict(scale_tensor=(0.5, 2.0, 1.0)),
                                "real_mlp")}
    for nonlin, (kw, counter) in cases.items():
        kw = dict(hidden_features=64, out_features=3, **kw)
        model = get_inr(nonlin, **kw)
        plain = get_inr(nonlin, fused="never", **kw)
        params = model.init(torch.Generator().manual_seed(0), cuda)
        before = launches(counter)["step"]
        got = model.step_grads(params, c, t, want_metrics=True)
        assert launches(counter)["step"] == before + 1, nonlin
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
    before = launches("mfn")["step"]
    got = _tree_flat(*MF.mfn_step(params, c, t, model.spec, nvalid=nvalid,
                                  denom=denom, gt=gt, want_metrics=True))
    torch.cuda.synchronize()
    assert launches("mfn")["step"] == before + 1
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
    before = launches("mfn")
    got = _mfn_vjp(lambda p, x: MF.mfn_mlp(p, x, model.spec), params, c, g)
    torch.cuda.synchronize()
    assert launches("mfn")["forward"] == before["forward"] + 1
    assert launches("mfn")["backward"] == before["backward"] + 1
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
    before = launches("mfn")
    with torch.no_grad():
        y = MF.mfn_mlp(params, c.reshape(4, 50, 2), model.spec)
    assert launches("mfn")["backward"] == before["backward"]
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
    before = launches("mfn")["step"]
    runs = [_tree_flat(*MF.mfn_step(params, c, t, model.spec, nvalid=nvalid,
                                    denom=denom, gt=gt, want_metrics=True,
                                    scratch=scratch)) for _ in range(2)]
    torch.cuda.synchronize()
    assert launches("mfn")["step"] == before + 2
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
    before = launches("wire2d")["step"]
    got = _tree_flat(*W2.wire2d_step(params, c, t, model.spec, nvalid=nvalid,
                                     denom=denom, gt=gt, want_metrics=True))
    torch.cuda.synchronize()
    assert launches("wire2d")["step"] == before + 1
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
    before = launches("wire2d")
    got = _wire2d_vjp(lambda p, x: W2.wire2d_mlp(p, x, model.spec), params,
                      c, g, dcoords)
    torch.cuda.synchronize()
    assert launches("wire2d")["forward"] == before["forward"] + 1
    assert launches("wire2d")["backward"] == before["backward"] + 1
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
    before = launches("wire2d")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = W2.wire2d_mlp(params, c, model.spec)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert launches("wire2d")["forward"] == before["forward"] + 1
    assert launches("wire2d")["backward"] == before["backward"]
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
    before, ws = launches("wire2d"), launches("wire_step")["step"]
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
    assert launches("wire2d") == want
    assert launches("wire_step")["step"] == ws
    assert np.isfinite(res.best_mse)


def test_sweep_denoise_launches_each_familys_kernel(cuda, tmp_path):
    """One short sweep denoise run per family on the card: wire takes
    wire_step, siren, relu, posenc and gauss real_step, mfn mfn_step, one
    launch per epoch."""
    from wire_tpu_torch.apps import sweep
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import real_mlp as RM
    counters = {"wire": lambda: launches("wire_step")["step"],
                "mfn": lambda: launches("mfn")["step"]}
    for nonlin in sweep.NONLINS:
        count = counters.get(nonlin, lambda: launches("real_mlp")["step"])
        before = count()
        out = sweep.sweep_denoise(results_dir=str(tmp_path / nonlin),
                                  niters=3, size=64, nonlins=[nonlin])
        assert count() == before + 3, nonlin
        assert np.isfinite(out[nonlin]["Best PSNR"]), nonlin


def test_hot_spans_carry_device_ms(cuda):
    """A WIRE fit under torch.profiler: every hot span of
    ``train/profiling.py`` carries device ms (a wrapper's at least its
    kernel's, an epoch's at least its parts'), and no device record of the
    profile bears a span's name (the spans are host ranges only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wire_tpu_torch.train import profiling, trainer as T
    model, params, c, t, _ = _case(4096, 91, 2, 3, cuda)
    cfg = T.FitConfig(niters=5, maxpoints=4096)
    T.fit_pointwise(model, params, c, t, cfg, device=cuda)  # builds
    profiling.clear()
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    prof.start()
    T.fit_pointwise(model, params, c, t, cfg, device=cuda)
    torch.cuda.synchronize()
    prof.stop()
    spans = profiling.spans()
    profiling.clear()
    by_id = {s["id"]: s for s in spans}
    hot = [s for s in spans if s["name"].startswith(profiling.HOT)]
    names = sorted(s["name"] for s in hot)
    assert names == sorted(["trainer.epoch", "trainer.adam",
                            "trainer.tracking", "wrappers.wire_step.step",
                            "kernels.wire_step.step"] * 5), names
    for s in hot:
        assert s["device_ms"] is not None and s["device_ms"] >= 0, s
        if s["name"] != "trainer.epoch":
            around = by_id[s["parent"]]
            assert around["device_ms"] >= s["device_ms"], (s, around)
    device = {e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA}
    assert device and not device & {s["name"] for s in spans}, device


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
    before = launches("wire_step")["step"]
    runs = [_flat(*WS.wire_step(params, c, t, model.spec, nvalid=nvalid,
                                denom=denom, gt=gt, want_metrics=True,
                                scratch=scratch)) for _ in range(2)]
    torch.cuda.synchronize()
    assert launches("wire_step")["step"] == before + 2
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
    before = launches("wire2d")["step"]
    runs = [_tree_flat(*W2.wire2d_step(params, c, t, model.spec,
                                       nvalid=nvalid, denom=denom, gt=gt,
                                       want_metrics=True, scratch=scratch))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert launches("wire2d")["step"] == before + 2
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
             acts, zs, z1]), *net.dims, *net.rep_args, stream) == 0
        assert lib.wire2d_backward(*W2._ptrs(
            [c, g, w["w1"], w["W2T"], w["fWT"], acts, zs, z1, gw1, gW2, gfW,
             dc, dz, dz1, part]), *net.dims, *net.rep_args, stream) == 0
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


# ---- the multi-frame SR slice ----------------------------------------------

def _multisr_wire_case(device, seed=60):
    """The multi-SR app's WIRE (256 wide: 181 complex units, L 2, o 3,
    omega0 10, sigma 5) at its seed-0 init, seeded coordinates in [-1, 1]
    shaped as its batch of four 192^2 frame grids (4, 36,864, 2) and a unit
    normal cotangent."""
    model = get_inr("wire", in_features=2, out_features=3,
                    hidden_features=256, hidden_layers=2, first_omega0=10.0,
                    hidden_omega0=10.0, scale=5.0)
    params = model.init(torch.Generator().manual_seed(0), device)
    rng = np.random.default_rng(seed)
    c = torch.tensor(rng.uniform(-1, 1, (4, 36864, 2)).astype(np.float32),
                     device=device)
    g = torch.tensor(rng.normal(size=(4, 36864, 3)).astype(np.float32),
                     device=device)
    return params, model.spec, c, g


def test_wire_mlp_at_the_multi_sr_batch_matches_plain(cuda):
    """wire_mlp at h = 181 (a paired tile of 21 units after five of 32;
    K = 362 columns, 8-byte rows) on (4, 36,864, 2) coordinates without
    dcoords, as fit_frames calls it: one forward and one backward launch,
    every output within REL x max of the plain version (the reference
    tools/port_multisr_reference.py decided), two calls bit-equal."""
    import chip_smoke as S
    from wire_tpu_torch.ops import wire_mlp as WM
    params, spec, c, g = _multisr_wire_case(cuda)
    assert params["first"]["w"].shape == (2, 181)
    kernel, plain, args, kw = S.wire_pair_case(torch, WM, params, spec, c, g,
                                               dcoords=False)
    before = launches("wire_mlp")
    got = kernel()
    torch.cuda.synchronize()
    assert launches("wire_mlp") == {
        "forward": before["forward"] + 1,
        "backward": before["backward"] + 1}
    assert got["out"].shape == (4, 36864, 3)
    S.same_bits(torch, kernel(), got, "wire_mlp multi-SR")
    if "test wire_mlp multisr" in S.MULTISR_FLOAT64_CASES:
        _assert_rel_to_float64(got, plain, *args, **kw)
    else:
        _assert_rel(got, plain(*args, **kw))


def test_resumed_fit_frames_is_bit_equal_on_the_card(cuda, tmp_path):
    """The multi-SR app's WIRE fit (its 181 complex units, 4 frames of a
    64^2 image at x4) through fit_frames for 9 iterations, saved every 3:
    stopped by an exception just after the second save and resumed, its
    history, parameters and best parameters equal the uninterrupted fit's
    bit for bit; a checkpoint of other frames is refused."""
    import dataclasses
    import chip_smoke as S
    from wire_tpu_torch.apps import multi_sr as TMS
    from wire_tpu_torch.train import trainer as T
    prob = TMS.setup(size=64, niters=9)
    ds, model = prob["ds"], prob["model"]
    params = model.init(torch.Generator().manual_seed(0), cuda)
    cfg = dataclasses.replace(prob["cfg"], scan_segment=3)

    def fit(ck, pixels=ds.pixels):
        return T.fit_frames(model, params, ds.coords, pixels, ds.masks, cfg,
                            hr_shape=(64, 64, 3), scale=4, checkpoint=ck,
                            device=cuda)

    info, ref = S.resumed_fit(torch, np, T, fit, "frames", str(tmp_path))
    assert info["stopped_at"] == 6 and info["epochs"] == 9
    assert np.isfinite(ref.mse_gt).all()
    with pytest.raises(ValueError, match="DIFFERENT fit"):
        fit(T.CheckpointSpec(path=str(tmp_path / "frames.npz")),
            pixels=ds.pixels * 0.5)


# ---- the replica axis (the batched multi-fit) ------------------------------

def test_replica_kernels_are_the_unbatched_kernels(cuda, monkeypatch):
    """wire_step, the wire_mlp pair, rotsum and line_sample with a replica
    axis (chip_smoke.py's many_kernel_vs_plain at smaller shapes): one
    launch per call for all replicas, two calls bit-equal, each replica
    bit-equal to the unbatched kernel on its inputs (line_sample's scatter
    within REL of it) and within REL of the plain version."""
    import chip_smoke as S
    from wire_tpu_torch.apps import ct as TCT
    from wire_tpu_torch.apps import multi_sr as TMS
    from wire_tpu_torch.operators import radon as TR
    from wire_tpu_torch.ops import line_sample as LS
    from wire_tpu_torch.ops import rotsum as R
    from wire_tpu_torch.ops import wire_mlp as WM
    from wire_tpu_torch.train.presets import get_config
    monkeypatch.setattr(S, "MANY_SHAPES", dict(
        rows=96 * 96, ragged_step=300, ragged_pair=1100, side=97, P=128,
        frame_rows=48 * 48))
    errs, times = S.many_kernel_vs_plain(
        torch, np, (WS, WM, R, LS, TR, TCT, TMS, get_inr, get_config), cuda)
    assert set(errs) == {"wire_step", "wire_mlp", "rotsum", "line_sample"}
    assert all(t["ms"] > 0 for t in times.values())


def test_batched_fits_are_the_serial_fits(cuda):
    """A 3-replica WIRE denoise (full batch and chunked) and SISR fit on
    the card: replica r bit-equal to the serial fit at seed + r, one
    wire_step launch a step or one wire_mlp pair an iteration for all
    replicas."""
    import dataclasses
    from wire_tpu_torch import tree
    from wire_tpu_torch.operators.forward import DownsampleOp
    from wire_tpu_torch.ops import wire_mlp as WM
    from wire_tpu_torch.signals import coords as C
    from wire_tpu_torch.train import trainer as T
    import chip_smoke as S
    model = get_inr("wire", in_features=2, out_features=3,
                    hidden_features=64, hidden_layers=2, first_omega0=7.0,
                    hidden_omega0=7.0, scale=8.0)
    ps = S.model_stack(torch, model, range(3), cuda)
    rng = np.random.default_rng(0)
    im = rng.random((64 * 64, 3)).astype(np.float32)
    noisy = im + 0.1 * rng.normal(size=im.shape).astype(np.float32)
    for maxpoints, steps in ((64 * 64, 5), (1024, 20)):
        cfg = T.FitConfig(learning_rate=5e-3, niters=5, maxpoints=maxpoints,
                          seed=2)
        before = launches("wire_step")["step"]
        many = T.fit_pointwise_many(model, ps, C.grid2d(64, 64), noisy, cfg,
                                    gt=im, device=cuda)
        assert launches("wire_step")["step"] == before + steps
        S.many_vs_serial(np, many, [T.fit_pointwise(
            model, tree.index(ps, r), C.grid2d(64, 64), noisy,
            dataclasses.replace(cfg, seed=2 + r), gt=im, device=cuda)
            for r in range(3)], f"denoise maxpoints {maxpoints}")
    lr = torch.nn.functional.avg_pool2d(
        torch.tensor(im.reshape(64, 64, 3)).permute(2, 0, 1), 4).permute(
            1, 2, 0).numpy()
    cfg = T.FitConfig(learning_rate=5e-3, niters=5)
    before = launches("wire_mlp")
    many = T.fit_operator_many(model, ps, C.grid2d(64, 64), lr,
                               DownsampleOp(4), cfg,
                               gt_field=im.reshape(64, 64, 3),
                               field_shape=(64, 64, 3), device=cuda)
    assert launches("wire_mlp") == {k: v + 5 for k, v in before.items()}
    S.many_vs_serial(np, many, [T.fit_operator(
        model, tree.index(ps, r), C.grid2d(64, 64), lr, DownsampleOp(4),
        cfg, gt_field=im.reshape(64, 64, 3), field_shape=(64, 64, 3),
        device=cuda) for r in range(3)], "sisr")


def test_seeds_of_a_family_without_replica_kernels_are_refused(cuda,
                                                               tmp_path):
    """Every family runs batched on the card (ROADMAP.md §A items 5c and
    5d): WIRE-2D through one wire2d_step launch an epoch for both replicas, each
    replica bit-equal to its serial fit, and its apply_many through one
    wire2d_mlp forward; realgabor (no kernel) by autograd of its vmapped
    apply, launching no kernel of the port, each replica's history within
    chip_smoke.MANY_AUTODIFF_REL of its serial fit's."""
    import dataclasses
    import chip_smoke as S
    from wire_tpu_torch import tree
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops import wire2d as W2
    from wire_tpu_torch.signals import coords as C
    from wire_tpu_torch.train import trainer as T
    rng = np.random.default_rng(3)
    im = rng.random((64, 3)).astype(np.float32)
    cfg = T.FitConfig(learning_rate=1e-3, niters=3)
    for nonlin in ("wire2d", "realgabor"):
        model = get_inr(nonlin, in_features=2, out_features=3,
                        hidden_features=16, hidden_layers=1)
        ps = tree.stack([model.init(torch.Generator().manual_seed(s), cuda)
                         for s in range(2)])
        before = (launches("wire_step")["step"], launches("real_mlp"),
                  launches("mfn"), launches("wire2d"))
        many = T.fit_pointwise_many(model, ps, C.grid2d(8, 8), im, cfg,
                                    device=cuda)
        after = (launches("wire_step")["step"], launches("real_mlp"),
                 launches("mfn"), launches("wire2d"))
        if nonlin == "wire2d":
            assert after[3]["step"] == before[3]["step"] + 3
            after[3]["step"] = before[3]["step"]
        assert after == before
        serials = [T.fit_pointwise(model, tree.index(ps, r),
                                   C.grid2d(8, 8), im,
                                   dataclasses.replace(cfg, seed=r),
                                   device=cuda) for r in range(2)]
        if nonlin == "wire2d":
            S.many_vs_serial(np, many, serials, nonlin)
        else:
            S.near_serial(np, many, serials, nonlin, S.MANY_AUTODIFF_REL,
                          lambda res, r: 0.0)
    model = get_inr("wire2d", in_features=2, out_features=3,
                    hidden_features=16, hidden_layers=1)
    ps = tree.stack([model.init(torch.Generator().manual_seed(s), cuda)
                     for s in range(2)])
    before = launches("wire2d")["forward"]
    with torch.no_grad():
        y = model.apply_many(ps, torch.zeros(10, 2, device=cuda))
    assert y.shape == (2, 10, 3)
    assert launches("wire2d")["forward"] == before + 1


def test_wire2d_and_mscale2_replica_kernels_are_the_unbatched_kernels(
        cuda, monkeypatch):
    """wire2d_step, the wire2d_mlp pair and mscale2_step with a replica axis
    (chip_smoke.py's many_rest_vs_plain at a smaller row count, 3
    replicas): one launch per call for all replicas, two calls bit-equal,
    each replica bit-equal to the unbatched kernel on its inputs and within
    REL of its reference (mscale2_step's and the CT-width pair's the
    float64 run)."""
    import chip_smoke as S
    from wire_tpu_torch.apps import common as TC
    from wire_tpu_torch.nn import models as MM
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops import wire2d as W2
    from wire_tpu_torch.train.presets import get_config
    monkeypatch.setattr(S, "MANY_REST_SHAPES", dict(
        rows=96 * 96, ragged_step=300, ragged_pair=1100))
    errs, times = S.many_rest_vs_plain(
        torch, np, (W2, MS, MM, TC, get_inr, get_config), cuda)
    assert set(errs) == {"wire2d_step", "wire2d_mlp", "mscale2_step"}
    assert all(t["ms"] > 0 for t in times.values())


@pytest.mark.parametrize("nonlin", ["wire2d", "bspline_mscale_2"])
def test_batched_wire2d_and_mscale2_fits_are_the_serial_fits(cuda, nonlin):
    """A 3-replica WIRE-2D or mscale_2 denoise fit on the card, full batch
    and chunked: replica r bit-equal to the serial fit at seed + r, one
    wire2d_step or mscale2_step launch a step for all replicas."""
    import dataclasses
    import chip_smoke as S
    from wire_tpu_torch import tree
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops import wire2d as W2
    from wire_tpu_torch.signals import coords as C
    from wire_tpu_torch.train import trainer as T
    extra = dict(scale_tensor=(9.0, 0.25)) if nonlin != "wire2d" else {}
    model = get_inr(nonlin, in_features=2, out_features=3,
                    hidden_features=64, hidden_layers=2, first_omega0=7.0,
                    hidden_omega0=7.0, scale=8.0, **extra)
    module = "wire2d" if nonlin == "wire2d" else "mscale2_step"
    ps = S.model_stack(torch, model, range(3), cuda)
    rng = np.random.default_rng(1)
    im = rng.random((64 * 64, 3)).astype(np.float32)
    noisy = im + 0.1 * rng.normal(size=im.shape).astype(np.float32)
    for maxpoints, steps in ((64 * 64, 5), (1024, 20)):
        cfg = T.FitConfig(learning_rate=1e-3, niters=5, maxpoints=maxpoints,
                          seed=2)
        before = launches(module)["step"]
        many = T.fit_pointwise_many(model, ps, C.grid2d(64, 64), noisy, cfg,
                                    gt=im, device=cuda)
        assert launches(module)["step"] == before + steps
        S.many_vs_serial(np, many, [T.fit_pointwise(
            model, tree.index(ps, r), C.grid2d(64, 64), noisy,
            dataclasses.replace(cfg, seed=2 + r), gt=im, device=cuda)
            for r in range(3)], f"{nonlin} maxpoints {maxpoints}")


@pytest.mark.parametrize("nonlin,extra", [
    ("realgabor", {}), ("bspline_sig", {}),
    ("bspline_mscale_2", dict(scale_tensor=(9.0, 0.25),
                              combine_type="both")),
    ("siren", dict(fused="never"))])
def test_autodiff_replicas_match_their_serial_fits(cuda, nonlin, extra):
    """An autodiff family's 2-replica denoise fit on the card (autograd of
    its batched apply): each replica's best PSNR within
    chip_smoke.PSNR_AGREE_DB and its loss histories within
    chip_smoke.MANY_AUTODIFF_REL of its serial fit's (the batched products
    need not round as the serial ones do), no kernel of the port launched
    but mscale_2's real_mlp pair (one forward and one backward an epoch),
    and one step's PyTorch operations as many at 4 replicas as at 2
    (chip_smoke.check_launches_by_replicas)."""
    import dataclasses
    import chip_smoke as S
    from wire_tpu_torch import tree
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import mscale2_step as MS
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops import wire2d as W2
    from wire_tpu_torch.signals import coords as C
    from wire_tpu_torch.train import trainer as T
    model = get_inr(nonlin, in_features=2, out_features=3,
                    hidden_features=64, hidden_layers=2, scale=2.0, **extra)
    ps = S.model_stack(torch, model, range(2), cuda)
    rng = np.random.default_rng(5)
    im = rng.random((64 * 64, 3)).astype(np.float32)
    cfg = T.FitConfig(learning_rate=1e-3, niters=5)
    counts = ("real_mlp", "mscale2_step", "mfn", "wire2d", "wire_step")
    before = [launches(c) for c in counts]
    many = T.fit_pointwise_many(model, ps, C.grid2d(64, 64), im, cfg,
                                device=cuda)
    after = [launches(c) for c in counts]
    if nonlin == "bspline_mscale_2":
        for k in ("forward", "backward"):
            assert after[0][k] == before[0][k] + 5
            after[0][k] = before[0][k]
    assert after == before
    from wire_tpu_torch.train import metrics as TMET

    def psnr(res, r):
        rec = res.best_rec if r is None else res.best_rec[r]
        return float(TMET.psnr_ref(im.reshape(64, 64, 3),
                                   rec.reshape(64, 64, 3)))

    S.near_serial(np, many, [T.fit_pointwise(
        model, tree.index(ps, r), C.grid2d(64, 64), im,
        dataclasses.replace(cfg, seed=r), device=cuda) for r in range(2)],
        nonlin, S.MANY_AUTODIFF_REL, psnr)
    grid = torch.tensor(C.grid2d(64, 64), device=cuda)
    target = torch.tensor(im, device=cuda)
    stacks = {m: S.model_stack(torch, model, range(m), cuda)
              for m in (2, 4)}
    S.check_launches_by_replicas(
        {m: S.launch_counts(torch, lambda: model.step_grads_many(
            stack, grid, target)) for m, stack in stacks.items()}, nonlin)


def test_real_and_mfn_replica_kernels_are_the_unbatched_kernels(
        cuda, monkeypatch):
    """real_step, the real_mlp pair, mfn_step and the mfn_mlp pair with a
    replica axis (chip_smoke.py's many_real_vs_plain at smaller shapes, 3
    replicas): one launch per call for all replicas, two calls bit-equal,
    each replica bit-equal to the unbatched kernel on its inputs and within
    REL of its reference (posenc's step: the float64 run on the kernel's
    relu pattern)."""
    import chip_smoke as S
    from wire_tpu_torch.apps import common as TC
    from wire_tpu_torch.apps import multi_sr as TMS
    from wire_tpu_torch.apps import sweep as SW
    from wire_tpu_torch.nn import models as MM
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.train.presets import get_config
    monkeypatch.setattr(S, "MANY_REAL_SHAPES", dict(
        rows=96 * 96, ragged_step=300, sisr_side=48, sweep_side=64,
        frame_rows=48 * 48))
    errs, times = S.many_real_vs_plain(
        torch, np, (RM, MF, MM, SW, TC, TMS, get_inr, get_config), cuda)
    assert set(errs) == {"real_step", "real_mlp", "mfn_step", "mfn_mlp"}
    assert all(t["ms"] > 0 and t["serial_ms"] > 0 for t in times.values())


@pytest.mark.parametrize("nonlin", ["siren", "mfn"])
def test_batched_real_and_mfn_fits_are_the_serial_fits(cuda, nonlin):
    """A 3-replica siren or MFN denoise fit on the card, full batch and
    chunked: replica r bit-equal to the serial fit at seed + r, one
    real_step or mfn_step launch a step for all replicas."""
    import dataclasses
    import chip_smoke as S
    from wire_tpu_torch import tree
    from wire_tpu_torch.ops import mfn as MF
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.signals import coords as C
    from wire_tpu_torch.train import trainer as T
    model = get_inr(nonlin, in_features=2, out_features=3,
                    hidden_features=64, hidden_layers=2, first_omega0=7.0,
                    hidden_omega0=7.0)
    module = "mfn" if nonlin == "mfn" else "real_mlp"
    ps = S.model_stack(torch, model, range(3), cuda)
    rng = np.random.default_rng(1)
    im = rng.random((64 * 64, 3)).astype(np.float32)
    noisy = im + 0.1 * rng.normal(size=im.shape).astype(np.float32)
    lr = 5e-3 if nonlin == "mfn" else 1e-3
    for maxpoints, steps in ((64 * 64, 5), (1024, 20)):
        cfg = T.FitConfig(learning_rate=lr, niters=5, maxpoints=maxpoints,
                          seed=2)
        before = launches(module)["step"]
        many = T.fit_pointwise_many(model, ps, C.grid2d(64, 64), noisy, cfg,
                                    gt=im, device=cuda)
        assert launches(module)["step"] == before + steps
        S.many_vs_serial(np, many, [T.fit_pointwise(
            model, tree.index(ps, r), C.grid2d(64, 64), noisy,
            dataclasses.replace(cfg, seed=2 + r), gt=im, device=cuda)
            for r in range(3)], f"{nonlin} maxpoints {maxpoints}")


# the digest (tools/port_rows_turn.py) of mscale2_step's outputs at the
# measure phase's mscale_2 denoise shape, as the tree before the replica
# axis went into real_tc.cuh (commit a4efcde) gave them on an NVIDIA H100
# 80GB HBM3 (PyTorch 2.11.0+cu128, CUDA 12.8); another toolkit or card
# may round otherwise
MSCALE2_PARENT_DIGEST = "e4e7cef711d28737"


def test_mscale2_step_keeps_its_bits(cuda):
    """Row 7 (mscale2_step) runs real_tc.cuh's chains, which took the
    replica axis: its single-model instances give the same bits as before
    (the digest of its outputs at the mscale_2 denoise shape)."""
    import importlib.util
    import os
    import chip_smoke as S
    path = os.path.join(os.path.dirname(S.__file__), "tools",
                        "port_rows_turn.py")
    spec = importlib.util.spec_from_file_location("port_rows_turn", path)
    turn = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turn)
    fn = turn.slice_rows(torch, S, cuda)["mscale2_step"]
    assert turn.digest(torch, fn()) == MSCALE2_PARENT_DIGEST


# the digests (tools/port_rows_turn.py) of rows 8 and 9's outputs at the
# measure phase's WIRE-2D shapes, as the tree before the replica axis went
# into csrc/wire2d.cu (commit 51a2ede) gave them on an NVIDIA H100 80GB
# HBM3 (PyTorch 2.11.0+cu128, CUDA 12.8); another toolkit or card may round
# otherwise
WIRE2D_PARENT_DIGESTS = {"wire2d_step": "7110579ec85ac7b4",
                         "wire2d_mlp": "d9fcdb31f2bdc823"}


@pytest.mark.parametrize("row", sorted(WIRE2D_PARENT_DIGESTS))
def test_wire2d_rows_keep_their_bits(cuda, row):
    """Rows 8 and 9 (wire2d_step, the wire2d_mlp pair) took the replica
    axis as a template flag: their single-model instances give the same
    bits as before (the digest of their outputs at the measure shapes)."""
    import importlib.util
    import os
    import chip_smoke as S
    path = os.path.join(os.path.dirname(S.__file__), "tools",
                        "port_rows_turn.py")
    spec = importlib.util.spec_from_file_location("port_rows_turn", path)
    turn = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turn)
    fn = turn.slice_rows(torch, S, cuda)[row]
    assert turn.digest(torch, fn()) == WIRE2D_PARENT_DIGESTS[row]


@pytest.mark.parametrize("fit", ["pointwise", "pointwise_global_perm",
                                 "operator"])
def test_world_of_one_is_the_unsharded_fit(cuda, fit):
    """A process group of this process alone over NCCL
    (wire_tpu_torch.dist): fit_pointwise_sharded (one wire_step an epoch,
    local and exact mode) and fit_operator_sharded (one wire_mlp pair an
    iteration) equal the unsharded fits bit for bit."""
    import torch.distributed as dist
    from wire_tpu_torch import tree
    from wire_tpu_torch.dist import (fit_operator_sharded,
                                     fit_pointwise_sharded, make_mesh,
                                     multihost)
    from wire_tpu_torch.ops import wire_mlp as WM
    from wire_tpu_torch.signals import coords as C
    from wire_tpu_torch.train import trainer as T

    made = multihost.world_of_one(device=cuda)
    try:
        mesh = make_mesh(1, cuda)
        assert mesh.backend == "nccl"
        model, params, _, t, gt = _case(64 * 64, 300, 2, 3, cuda, seed=5)
        coords = C.grid2d(64, 64)
        if fit == "operator":
            cfg = T.FitConfig(learning_rate=5e-3, niters=5)

            def op(f):
                return f[::2, ::2]

            meas = op(t.reshape(64, 64, 3))
            kw = dict(gt_field=gt.reshape(64, 64, 3), field_shape=(64, 64, 3))
            want = T.fit_operator(model, params, coords, meas, op, cfg,
                                  device=cuda, **kw)
            before = launches("wire_mlp")
            got = fit_operator_sharded(model, params, coords, meas, op, cfg,
                                       mesh, **kw)
            after = launches("wire_mlp")
            assert {k: after[k] - before[k] for k in before} == {
                "forward": 5, "backward": 5}
        else:
            cfg = T.FitConfig(learning_rate=5e-3, niters=5, maxpoints=1024)
            want = T.fit_pointwise(model, params, coords, t, cfg, gt=gt,
                                   device=cuda)
            before = launches("wire_step")["step"]
            got = fit_pointwise_sharded(
                model, params, coords, t, cfg, mesh, gt=gt,
                global_perm=fit == "pointwise_global_perm")
            assert launches("wire_step")["step"] - before == 5 * 4
        for k in ("mse_gt", "mse_noisy", "best_rec", "final_rec"):
            if getattr(want, k) is not None:
                assert np.array_equal(getattr(got, k), getattr(want, k)), k
        for (p, a), (_, b) in zip(tree.leaves(got.params),
                                  tree.leaves(want.params)):
            assert torch.equal(a, b), p
    finally:
        if made:
            dist.destroy_process_group()


@pytest.mark.parametrize("nonlin,maxpoints", [
    ("wire", 4096), ("wire", 2048), ("bspline_form", 4096)],
    ids=["wire_full_batch", "wire_two_chunks", "bspline_full_batch"])
def test_tv_fit_launches_the_apply_pair(cuda, nonlin, maxpoints):
    """A TV fit (fit_pointwise(tv_weight=...)) steps by autograd of the
    family's apply/VJP kernel pair and launches no step kernel: per full
    batch epoch one forward and one backward; per chunk the chunk's forward,
    the full render's forward and their two backwards.  Its histories lie
    within 1e-3 relative of the plain fit's (fused="never") from one
    init."""
    from wire_tpu_torch.ops import real_mlp as RM
    from wire_tpu_torch.ops import wire_mlp as WM
    from wire_tpu_torch.signals import coords as C
    from wire_tpu_torch.train import trainer as T
    H = W = 64
    kw = dict(in_features=2, out_features=3, hidden_features=64,
              hidden_layers=2, first_omega0=7.0, hidden_omega0=7.0,
              scale=8.0 if nonlin == "wire" else 1 / 3)
    model = get_inr(nonlin, **kw)
    params = model.init(torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 1, (H * W, 3)).astype(np.float32)
    cfg = T.FitConfig(learning_rate=1e-3, niters=5, maxpoints=maxpoints)
    pair = "wire_mlp" if nonlin == "wire" else "real_mlp"
    before = (launches(pair), launches("wire_step")["step"],
              launches("real_mlp")["step"])
    res = T.fit_pointwise(model, params, C.grid2d(H, W), t, cfg,
                          tv_weight=1e-4, image_shape=(H, W, 3),
                          device=cuda)
    per_epoch = 1 if maxpoints == H * W else 2 * (H * W // maxpoints)
    after = launches(pair)
    assert {k: after[k] - before[0][k] for k in ("forward", "backward")} == {
        "forward": 5 * per_epoch, "backward": 5 * per_epoch}
    assert launches("wire_step")["step"] == before[1]
    assert launches("real_mlp")["step"] == before[2]
    plain = T.fit_pointwise(get_inr(nonlin, fused="never", **kw), params,
                            C.grid2d(H, W), t, cfg, tv_weight=1e-4,
                            image_shape=(H, W, 3), device=cuda)
    assert np.isfinite(res.best_rec).all()
    np.testing.assert_allclose(res.mse_gt, plain.mse_gt, rtol=1e-3)


def test_export_mesh_from_model_probes_through_the_forward_kernel(
        cuda, tmp_path):
    """export_mesh_from_model on the card: one wire_mlp forward a batch (a
    ragged last one included), no backward and no step kernel, the
    occupancies within REL x max of the plain apply (fused="never") on the
    same points, and a mesh written."""
    from wire_tpu_torch.ops import wire_mlp as WM
    from wire_tpu_torch.signals import volume as V
    kw = dict(in_features=3, out_features=1, hidden_features=64,
              hidden_layers=3, first_omega0=20.0, hidden_omega0=20.0,
              scale=10.0)
    model = get_inr("wire", **kw)
    params = model.init(torch.Generator().manual_seed(0), cuda)
    before = launches("wire_mlp"), launches("wire_step")["step"]
    cube = V.export_mesh_from_model(model, params, 40, 6000,
                                    str(tmp_path / "m.dae"), thres=0.0,
                                    sigmoid=False, device=cuda)
    after = launches("wire_mlp")
    assert {k: after[k] - before[0][k] for k in after} == {
        "forward": 11, "backward": 0}
    assert launches("wire_step")["step"] == before[1]
    plain = get_inr("wire", fused="never", **kw)
    with torch.no_grad():
        want = plain.apply(params, V._grid3d_rows(0, 40 ** 3, 40, cuda))
    want = want.cpu().numpy().reshape(cube.shape)
    assert float(np.abs(cube - want).max()) <= REL * float(
        np.abs(want).max())
    assert os.path.getsize(tmp_path / "m.dae") > 0


def test_refill_and_prune_stack_on_the_card(cuda):
    """BlockPointCloud.refill with a CUDA generator: rows of sdf 1
    unchanged, the redrawn rows inside their cells, two calls from one
    state equal; prune_stack on the card equal to the CPU call (mask and
    kept frames; imdiff within 1e-6)."""
    from wire_tpu_torch.signals import image as I
    from wire_tpu_torch.signals import motion as Mo
    from wire_tpu_torch.signals import volume as V
    rs = np.random.RandomState(0)
    bpc = V.BlockPointCloud((rs.randn(3000, 3) * 0.4).astype(np.float32),
                            depth=3)
    xyz, sdf = (torch.as_tensor(a, device=cuda)
                for a in bpc.fill(np.random.RandomState(1)))
    gen = torch.Generator(device=cuda).manual_seed(3)
    state = gen.get_state()
    a = bpc.refill(xyz, sdf, gen)
    gen.set_state(state)
    assert torch.equal(a, bpc.refill(xyz, sdf, gen))
    keep = sdf[..., 0] == 1
    assert torch.equal(a[keep], xyz[keep])
    lo = torch.as_tensor(bpc.minlim, device=cuda)[:, None, :].expand_as(a)
    hi = torch.as_tensor(bpc.maxlim, device=cuda)[:, None, :].expand_as(a)
    assert bool(((a >= lo) & (a <= hi)).all(-1)[~keep].all())
    im = I.synthetic_image(96, 96, 3, seed=0).mean(-1)
    stack = np.stack([im[::2, ::2]] * 4).astype(np.float32)
    stack[2] += 0.3
    mats = np.stack([np.eye(2, 3)] * 4).astype(np.float32)
    mats[1, 0, 2] = 0.5
    got = Mo.prune_stack(stack, mats, (96, 96), thres=0.25, device=cuda)
    want = Mo.prune_stack(stack, mats, (96, 96), thres=0.25, device="cpu")
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert float(np.abs(got[3] - want[3]).max()) <= 1e-6
