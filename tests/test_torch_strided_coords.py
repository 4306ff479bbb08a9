"""The four CUDA MLP wrappers (wire_mlp, real_mlp, mfn_mlp, wire2d_mlp) hand
their kernels contiguous coordinates when the caller passes a strided view
(a transposed (n, d) array survives the wrappers' reshape), on the CPU.

A tensor subclass that reports a CUDA device takes each wrapper into its
CUDA branch; the launch functions there (the autograd Function's ``apply``
and the forward that keeps nothing) are replaced by spies that record what
they receive, so no kernel runs.  The card tests in ``test_torch_gpu.py``
hold the kernels' outputs and gradients on such a view against the
contiguous call's."""
import numpy as np
import pytest
import torch

from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.ops import mfn as MF
from wire_tpu_torch.ops import real_mlp as RM
from wire_tpu_torch.ops import wire2d as W2
from wire_tpu_torch.ops import wire_mlp as WM

N, O = 37, 3


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _strided_coords(grad):
    rng = np.random.default_rng(0)
    base = torch.tensor(rng.uniform(-1, 1, (2, N)).astype(np.float32))
    c = base.t().as_subclass(_OnCuda)
    assert c.shape == (N, 2) and not c.is_contiguous()
    return c.requires_grad_(grad)


def _random_canon(widths):
    rng = np.random.default_rng(1)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))
    return {"layers": [{"w": t(rng.uniform(-1, 1, (a, b))),
                        "alpha": t(rng.uniform(0.5, 2, b)),
                        "beta": t(rng.uniform(-1, 1, b))}
                       for a, b in zip(widths[:-2], widths[1:-1])],
            "final": {"w": t(rng.uniform(-1, 1, (widths[-2], widths[-1]))),
                      "b": t(rng.uniform(-1, 1, widths[-1]))}}


def _cases():
    """name -> (call(coords), module, name of the Function, name of the
    no-grad forward, what the no-grad forward returns)."""
    wire = get_inr("wire", in_features=2, out_features=O, hidden_features=8,
                   hidden_layers=1)
    wp = wire.init(torch.Generator().manual_seed(0), "cpu")
    mfn = get_inr("mfn", in_features=2, out_features=O, hidden_features=8,
                  hidden_layers=1)
    mp = mfn.init(torch.Generator().manual_seed(0), "cpu")
    w2d = get_inr("wire2d", in_features=2, out_features=O,
                  hidden_features=8, hidden_layers=1)
    w2p = w2d.init(torch.Generator().manual_seed(0), "cpu")
    canon = _random_canon((2, 8, 8, O))
    zero = torch.zeros(N, O)
    return {
        "wire_mlp": (lambda c: WM.wire_mlp(wp, c, wire.spec), WM,
                     "_WireMLP", "_forward_nograd", zero),
        "real_mlp": (lambda c: RM.real_mlp(canon, c, ("qspline",) * 2), RM,
                     "_RealMLP", "_forward", (zero, None, None)),
        "mfn_mlp": (lambda c: MF.mfn_mlp(mp, c, mfn.spec), MF, "_MfnMLP",
                    "_forward", (zero, None, None)),
        "wire2d_mlp": (lambda c: W2.wire2d_mlp(w2p, c, w2d.spec), W2,
                       "_Wire2dMLP", "_forward", (zero, None, None)),
    }


@pytest.mark.parametrize("grad", [True, False],
                         ids=["with_grad", "without_grad"])
@pytest.mark.parametrize("name", ["wire_mlp", "real_mlp", "mfn_mlp",
                                  "wire2d_mlp"])
def test_cuda_branch_gets_contiguous_coords(monkeypatch, name, grad):
    call, module, fn_name, nograd_name, nograd_out = _cases()[name]
    seen = []

    def apply(c2, *rest):
        seen.append(("apply", c2))
        return torch.zeros(N, O)

    def nograd(*args, **kw):
        c2 = next(a for a in args if isinstance(a, _OnCuda))
        seen.append(("nograd", c2))
        return nograd_out

    monkeypatch.setattr(getattr(module, fn_name), "apply", apply)
    monkeypatch.setattr(module, nograd_name, nograd)
    out = call(_strided_coords(grad))
    assert tuple(out.shape) == (N, O)
    assert [k for k, _ in seen] == ["apply" if grad else "nograd"]
    c2 = seen[0][1]
    assert c2.is_contiguous() and tuple(c2.shape) == (N, 2)


def test_contiguous_coords_are_not_copied(monkeypatch):
    """.contiguous() of a contiguous tensor is the tensor itself: the
    common case pays nothing."""
    call, module, fn_name, _, _ = _cases()["wire_mlp"]
    seen = []
    monkeypatch.setattr(getattr(module, fn_name), "apply",
                        lambda c2, *rest: seen.append(c2) or torch.zeros(N, O))
    c = _strided_coords(False).contiguous().requires_grad_(True)
    call(c)
    assert seen[0].data_ptr() == c.data_ptr()
