"""Differentiable forward operators from an INR's output field to a task's
measurement domain (port of wire_tpu/operators/forward.py:20-59):

- identity     denoise / representation
- sinogram_op  CT: a field -> its Radon sinogram (``operators/radon.py``)
- sisr_op      SISR: HR render -> AvgPool2d(scale)
- multi_sr_op  multi-frame SR: a batch of renders -> AvgPool2d(scale)

The CT apps' operator is ``operators/radon.py:RadonOp``.
"""
from __future__ import annotations

from wire_tpu_torch.operators.radon import radon
from wire_tpu_torch.ops.resample import avg_pool2d


def identity(field, *_args):
    return field


def sinogram_op(field_hw, angles, **radon_kw):
    """field (H, W) -> (nangles, W): ``radon`` (method 'auto' unless
    ``radon_kw`` names one), so on the card the ``line_sample`` pair
    (fourier) or the ``rotsum`` pair (rotate)."""
    return radon(field_hw, angles, **radon_kw)


def sisr_op(field_hwc, scale):
    """(H, W, C) HR field -> (H/s, W/s, C) LR by an exact box average;
    leading axes (the batched multi-fit's replicas) pass through."""
    lead = field_hwc.shape[:-3]
    nchw = field_hwc.reshape(-1, *field_hwc.shape[-3:]).permute(0, 3, 1, 2)
    lr = avg_pool2d(nchw, scale).permute(0, 2, 3, 1)
    return lr.reshape(*lead, *lr.shape[-3:])


class DownsampleOp:
    """The SISR forward operator of one scale, as a callable
    ``op(field_hwc) -> lr_hwc``."""

    def __init__(self, scale):
        self.scale = int(scale)

    def __call__(self, field_hwc):
        return sisr_op(field_hwc, self.scale)

    def __hash__(self):
        return hash(("DownsampleOp", self.scale))

    def __eq__(self, other):
        return isinstance(other, DownsampleOp) and other.scale == self.scale


def multi_sr_op(frames_bhwc, scale):
    """(B, H, W, C) fields rendered at warped coordinates -> (B, H/s, W/s,
    C) by an exact box average; leading axes before B (the batched
    multi-fit's replicas) pass through."""
    return sisr_op(frames_bhwc, scale)
