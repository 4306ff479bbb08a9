"""Differentiable forward operators from an INR's output field to a task's
measurement domain (port of wire_tpu/operators/forward.py:20-52):

- identity     denoise / representation
- sisr_op      SISR: HR render -> AvgPool2d(scale)

The CT sinogram operator is ``operators/radon.py:RadonOp``.
"""
from __future__ import annotations

from wire_tpu_torch.ops.resample import avg_pool2d


def identity(field, *_args):
    return field


def sisr_op(field_hwc, scale):
    """(H, W, C) HR field -> (H/s, W/s, C) LR by an exact box average."""
    nchw = field_hwc.permute(2, 0, 1)[None]
    lr = avg_pool2d(nchw, scale)
    return lr[0].permute(1, 2, 0)


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
