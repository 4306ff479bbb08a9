"""The frozen yardstick (``benchmark/counts``, ``benchmark/peaks.py``) held
to the port's own functions at a few shapes.  The port's copies may change
in a later PR; these copies may not."""
import numpy as np
import pytest
import torch

import chip_smoke
from wire_tpu_torch.operators import radon as R
from wire_tpu_torch.ops import line_sample as LS
from wire_tpu_torch.ops import real_mlp as RM
from wire_tpu_torch.ops import wire_mlp as WM
from wire_tpu_torch.ops import wire_step as WS

from benchmark import lookup, peaks
from benchmark.counts import bspline_form, classes, radon_fourier, wire

SHAPES = [(65536, 2, 212, 3, 2), (65536, 2, 212, 1, 2), (700, 3, 5, 1, 1),
          (200000, 3, 212, 1, 3)]


@pytest.mark.parametrize("n, d, h, o, L", SHAPES)
def test_wire_flops_are_the_ports(n, d, h, o, L):
    assert wire.step_flops(n, d, h, o, L) == WS.step_flops(n, d, h, o, L)
    assert wire.apply_flops(n, d, h, o, L) == WM.apply_flops(n, d, h, o, L)


def test_wire_step_at_the_denoise_shape():
    cfg = lookup.config("wire300")
    flops, nbytes = wire.step(cfg, 65536, 3)
    assert round(flops / 1e9, 2) == 142.13
    assert wire.model_flops(cfg, 65536, 3) == flops
    w = sum(t.numel() for t in _wire_params(cfg, 3))
    assert nbytes == 4 * (65536 * (2 + 3 + 3) + w + 65536 * 3 + w + 2)
    # four replicas on shared coordinates, target and gt
    f4, b4 = wire.step(cfg, 65536, 3, replicas=4)
    assert f4 == 4 * flops
    assert b4 == 4 * (65536 * 8 + 4 * (65536 * 3 + 2 * w + 2))
    # the pair in a fit: no coordinate gradient
    pf, pb = wire.pair(cfg, 65536, 1)
    assert pf == WM.apply_flops(65536, 2, 212, 1, 2) - 2 * 65536 * 2 * 212
    assert pf == WS.step_flops(65536, 2, 212, 1, 2)
    w1 = sum(t.numel() for t in _wire_params(cfg, 1))
    assert pb == 4 * (65536 * 2 + 2 * 65536 + 2 * w1)


def _wire_params(cfg, out):
    from wire_tpu_torch.nn.registry import get_inr
    m = get_inr("wire", in_features=2, out_features=out,
                hidden_features=cfg["hidden_features"],
                hidden_layers=cfg["hidden_layers"])
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    from wire_tpu_torch import tree
    return [t for _, t in tree.leaves(params)]


@pytest.mark.parametrize("widths", [(2, 256, 256, 256, 3), (2, 8, 8, 1),
                                    (26, 40, 40, 3)])
def test_real_flops_are_the_ports(widths):
    n = 65536
    assert bspline_form.forward_flops(n, widths) == RM.forward_flops(
        n, widths)
    assert bspline_form.step_flops(n, widths) == RM.step_flops(n, widths)
    assert bspline_form.apply_flops(n, widths) == RM.apply_flops(n, widths)


def test_real_step_at_the_denoise_shape():
    cfg = lookup.config("bspline256")
    assert bspline_form.widths(cfg, 3) == [2, 256, 256, 256, 3]
    flops, nbytes = bspline_form.step(cfg, 65536, 3)
    assert round(flops / 1e9, 2) == 51.98
    from wire_tpu_torch.nn.models import _canon_form
    from wire_tpu_torch.nn.registry import get_inr
    m = get_inr("bspline_form", in_features=2, out_features=3,
                hidden_features=256, hidden_layers=2, scale=1 / 9.5)
    canon = _canon_form(m.init(torch.Generator().manual_seed(0)), m.spec)
    w = sum(t.numel() for _, t in RM.canon_leaves(canon))
    assert bspline_form.num_weights([2, 256, 256, 256, 3]) == w
    assert nbytes == 4 * (65536 * (2 + 3 + 3) + w + 65536 * 3 + w + 2)


@pytest.mark.parametrize("angles, side", [(100, 256), (7, 40)])
def test_line_sample_counts_are_the_ports(angles, side):
    traffic = {"angles": angles}
    thetas = np.linspace(0, 180, angles, dtype=np.float32)
    P = R._fft_size(4 * side)
    assert radon_fourier.RF.fft_size(4 * side) == P
    _, gy, gx, _ = R._fourier_consts(P, thetas, "cpu")
    flops, nbytes = radon_fourier.iteration(traffic, (side, side))
    A, K = gy.shape
    assert flops == 2 * LS.sample_flops(A, K)
    assert nbytes == chip_smoke.line_sample_bytes(torch, gy, gx, P)
    assert radon_fourier.sample_bytes(gy, gx, P, 3) == \
        chip_smoke.line_sample_bytes(torch, gy, gx, P, 3)


def test_peaks_and_the_3xtf32_bound_are_the_smokes():
    assert peaks.TF32_DENSE_FLOPS == chip_smoke.H100_TF32_TFLOPS * 1e12
    assert peaks.FP32_FLOPS == chip_smoke.H100_FP32_TFLOPS * 1e12
    assert peaks.HBM_BYTES_PER_S == chip_smoke.H100_HBM_TBPS * 1e12
    for flops, nbytes in ((142.13e9, 60e6), (1e6, 11.3e6)):
        s, by = peaks.least_s(flops, nbytes, "3xtf32")
        ms, by_smoke = chip_smoke.bound_3xtf32(flops, nbytes)
        assert s * 1e3 == pytest.approx(ms) and by == by_smoke
        s, by = peaks.least_s(flops, nbytes, "fp32")
        ms, by_smoke = chip_smoke.bound(flops, nbytes)
        assert s * 1e3 == pytest.approx(ms) and by == by_smoke


def test_kernel_classes_are_the_smokes():
    for name in ("wire_step", "wire_mlp", "real_step"):
        assert classes.CLASSES[name] == chip_smoke.TENSOR_CORE_CLASSES[name]
    got = classes.by_class({"void tc_paired_kernel<0, 2>()": 1.0,
                            "void tc_wgrad_kernel<1>()": 2.0,
                            "at::native::foo": 0.5}, ("wire_step",))
    assert got == {"wire_step.forward_gemms": 1.0,
                   "wire_step.weight_gradients": 2.0, "other": 0.5}
