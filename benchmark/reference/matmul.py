"""The reference's matrix products: ``fp32`` (TF32 off), and ``tf32`` for
the control, the nearest precision below the float32 the configurations
state: each operand rounded to TF32 (10 mantissa bits, ties away from
zero, as ``cvt.rna.tf32.f32``) and the product summed in float32, in the
forward and in both products of the backward, as a TF32 tensor-core GEMM
forms them.  The rounding runs the same on the CPU and the card."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """torch's float32 products in full float32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def tf32_round(x):
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    finite = (bits & 0x7F800000) != 0x7F800000
    out = torch.where(finite, (bits + 0x1000) & 0xFFFFE000, bits)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).mT, tf32_round(a).mT @ g


def fp32(a, b):
    return a @ b


def tf32(a, b):
    return _TF32.apply(a, b)


PRECISIONS = {"fp32": fp32, "tf32": tf32}
