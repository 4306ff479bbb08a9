"""The whole step's share of the card's peak: the configuration's model
FLOPs of an epoch (frozen fp32 count, no padding) as three TF32 products
each at the 495 TFLOP/s dense TF32 peak, over the mean unprofiled epoch
time of the same process (epoch boundaries outside the profiled stretch,
each fit's first epoch left out)."""
from benchmark import peaks


def read(run):
    if run.stretch is None or not run.unprofiled_ms:
        return None
    least_ms = 1e3 * peaks.least_s(run.model_flops, 0, "3xtf32")[0]
    return 100.0 * least_ms / run.unprofiled_ms
