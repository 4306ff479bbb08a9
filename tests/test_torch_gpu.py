"""The CUDA kernels (wire_step, wire_mlp, rotsum, line_sample) against their
plain PyTorch versions on the card (marked ``gpu``; skipped where no CUDA
device is present):

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


def test_radon_rotate_refuses_a_non_square_cuda_image(cuda):
    from wire_tpu_torch.operators import radon as TR
    img = torch.rand((64, 48), device=cuda)
    with pytest.raises(ValueError, match="rotate_xla"):
        TR.radon(img, np.linspace(0, 180, 5, dtype=np.float32),
                 method="rotate")


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
