"""The window rule, the epoch intervals and the p95 on synthetic times, and
the trace sums on synthetic records."""
import statistics
import types

import pytest

from benchmark import lookup, trace, window


def test_fit_seeds_are_fixed_distinct_and_fit_numpy():
    seeds = [window.fit_seed(2 ** 31 + 12345, k) for k in range(-1, 50)]
    assert seeds == [window.fit_seed(2 ** 31 + 12345, k)
                     for k in range(-1, 50)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2 ** 31 for s in seeds)
    assert window.fit_seed(1, 0) != window.fit_seed(2, 0)


@pytest.mark.parametrize("fit_s, seconds, expect", [
    (8.0, 30.0, 3), (8.0, 24.0, 3), (8.0, 23.9, 2), (29.0, 30.0, 1),
    (40.0, 30.0, 1), (0.5, 10.0, 20)])
def test_window_rule(fit_s, seconds, expect):
    elapsed, n = 0.0, 0
    while window.start_another(elapsed, n, seconds):
        elapsed += fit_s
        n += 1
    assert n == expect
    assert n == 1 or elapsed <= seconds


def test_intervals_and_p95():
    marks = [0.0, 4.0, 8.0, 12.5, 16.5, 40.0]
    assert window.intervals(marks) == [4.0, 4.0, 4.5, 4.0, 23.5]
    values = [4.0] * 950 + [10.0] * 50
    assert window.p95(values) == statistics.quantiles(values, n=20)[18]
    values = list(range(1, 101))
    assert window.p95(values) == pytest.approx(95.95)
    with pytest.raises(ValueError):
        window.p95([1.0])


def test_unprofiled_leaves_out_first_epochs_and_the_stretch():
    fits = [{"intervals_ms": [9.0] + [4.0] * 9},
            {"intervals_ms": [8.0] + [5.0] * 4}]
    assert window.unprofiled(fits, None) == [4.0] * 9 + [5.0] * 4
    # stretch of fit 0 from epoch 3 for 4 epochs: epochs 2..7 left out
    assert window.unprofiled(fits, (0, 3, 4)) == [4.0] * 3 + [5.0] * 4


def _recs():
    return [("void wire_tc::tc_paired_kernel<0, 1>(float*)", "kernel",
             0.0, 100.0),
            ("void regular_fft_factor<256>(float2*)", "kernel", 100.0, 130.0),
            ("void at::native::vectorized_elementwise_kernel<4>", "kernel",
             150.0, 160.0),
            ("Memset (Device)", "memset", 160.0, 161.0),
            ("spectrum_gather_kernel", "kernel", 200.0, 210.0),
            ("aten::mul", "cpu", 130.0, 200.0),
            ("cudaLaunchKernel", "cpu", 170.0, 190.0)]


def test_stretch_sums_owners_busy_and_gaps():
    program = trace.program_kernels()
    assert {"tc_paired_kernel", "spectrum_gather_kernel",
            "real_tc_kernel", "final_loss_kernel"} <= program
    s = trace.Stretch(_recs(), 2, 0.5, program)
    assert s.by_owner == {"program": 110.0, "cufft": 30.0, "torch": 11.0}
    assert s.per_epoch_ms("program") == pytest.approx(0.055)
    assert s.launches == 4 and s.program_launches == 2
    assert s.busy_us() == 151.0
    assert s.gaps() == [(130.0, 150.0), (161.0, 200.0)]
    b = s.breakdown()
    assert b["device_ops"][0] == [
        "void wire_tc::tc_paired_kernel<0, 1>(float*)", 100.0 / 1e6]
    assert dict(b["idle_gaps"]) == {"aten::mul": 20.0 / 1e6,
                                    "cudaLaunchKernel": 39.0 / 1e6}


def test_per_layer_readers_on_a_synthetic_run():
    program = trace.program_kernels()
    s = trace.Stretch(_recs(), 2, 0.5, program)
    run = types.SimpleNamespace(
        stretch=s, unprofiled_ms=0.1, model_flops=1e9,
        work=[("wire_mlp", 1e9, 1e6, "3xtf32"), ("op", 1e6, 1e6, "fp32")],
        fits=[{"t0": 0.0, "t_loop0": 0.2, "t_loop1": 5.0, "t1": 5.1,
               "rows": 10, "epochs": 4, "replicas": 2,
               "intervals_ms": [2.0, 1.0, 1.0, 1.0]}],
        window_s=2.0, setup_s=7.0)

    def read(name):
        return lookup.module("metrics", name).read(run)

    assert read("fit_coords_per_s") == 40.0
    assert read("setup_s") == 7.0
    assert read("apps.fit_prep_ms") == pytest.approx(300.0)
    assert read("trainer.torch_kernels_ms") == pytest.approx(0.0055)
    assert read("wrappers.launches_per_epoch") == 2.0
    assert read("operators.fourier_ms") == pytest.approx(0.02)
    least = 3e9 / 495e12 + 1e6 / 3.35e12
    assert read("kernels.roofline_pct") == pytest.approx(
        100 * least * 1e3 / 0.055)
    assert read("step.mfu_pct") == pytest.approx(100 * 3e9 / 495e12 * 1e3
                                                 / 0.1)
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 0.0755 / 0.1))
    run.stretch = None
    for name in ("trainer.torch_kernels_ms", "operators.fourier_ms",
                 "kernels.roofline_pct", "device.idle_pct", "step.mfu_pct"):
        assert read(name) is None
