"""The port's kernels by product class, as name fragments of the device
kernels (a frozen copy of ``chip_smoke.py:TENSOR_CORE_CLASSES`` for the
kernels the cells run, which ``tools/port_step_profile.py`` sums a fit's
device time by), and the Fourier operator's own kernels.  A traced run
prints the program's kernel time by these classes beside its per-layer
metrics; kernels no class names go under "other"."""
from __future__ import annotations

WEIGHT_GRADIENTS = ("tc_wgrad_kernel", "narrow_wgrad_kernel",
                    "narrow_colsum_kernel", "reduce_chunks_kernel")

CLASSES = {
    "wire_mlp": {
        "forward_gemms": ("tc_paired_kernel<0",),
        "data_gradient_gemms": ("tc_paired_kernel<1", "tc_paired_kernel<2"),
        "weight_gradients": WEIGHT_GRADIENTS,
        "first_final_dcoords": ("first_forward_kernel",
                                "final_forward_kernel", "dcoords_kernel"),
    },
    "wire_step": {
        "forward_gemms": ("tc_paired_kernel<0",),
        "data_gradient_gemms": ("tc_paired_kernel<1", "tc_paired_kernel<2"),
        "weight_gradients": WEIGHT_GRADIENTS,
        "first_final_loss": ("first_forward_kernel", "final_loss_kernel"),
    },
    "real_step": {
        "forward_gemms": ("real_tc_kernel<0",),
        "data_gradient_gemms": ("real_tc_kernel<1",),
        "weight_gradients": WEIGHT_GRADIENTS + ("colsum_partial_kernel",),
        "first_top_final_loss": ("real_narrow_kernel", "final_loss_kernel"),
    },
    "line_sample": {
        "gather_scatter": ("spectrum_gather_kernel",
                           "spectrum_scatter_kernel"),
    },
}


def by_class(kernel_ms, kernels):
    """{class: ms} of {kernel name: ms} over the classes of ``kernels``
    (names of ``CLASSES``), the first class that names a kernel taking
    it."""
    out = {}
    for name, ms in kernel_ms.items():
        cls = next((f"{k}.{c}" for k in kernels
                    for c, frags in CLASSES[k].items()
                    if any(f in name for f in frags)), "other")
        out[cls] = out.get(cls, 0.0) + ms
    return out
