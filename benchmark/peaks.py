"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W), and the least time of a piece of work at them.

An fp32 product that the port forms on the tensor cores is three TF32
products (``csrc/wire_tc.cuh``), so its operations count three times at
the TF32 rate: the yardstick ``chip_smoke.py:bound_3xtf32`` uses.  Work
on the CUDA cores counts once at the fp32 rate.
"""
from __future__ import annotations

TF32_DENSE_FLOPS = 495e12      # tensor cores, dense
FP32_FLOPS = 67e12             # CUDA cores
HBM_BYTES_PER_S = 3.35e12

ENGINES = {"3xtf32": 3 / TF32_DENSE_FLOPS, "fp32": 1 / FP32_FLOPS}


def least_s(flops, nbytes, engine):
    """(seconds, what bounds it): the larger of the operations at the
    engine's peak and the bytes at the HBM bandwidth."""
    ops_s = flops * ENGINES[engine]
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")
