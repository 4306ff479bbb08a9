"""One WIRE train step: the hand-written CUDA kernel (``csrc/wire_step.cu``)
and its plain PyTorch version.

Replaces wire_tpu/ops/pallas/wire_step.py:wire_step_fused, the one-pass
Pallas train step: forward, masked-MSE loss gradient
``g = 2 mask (y - t) / denom`` with ``mask = row < nvalid``, backward
without dcoords, and optional masked SSE sums against the target and gt.

Bound on the card: operations.  At the WIRE-300 shape (n = 65,536,
h = 212, two hidden layers) a step is ~142 GFLOP of fp32 multiply-adds
(three n x 424 x 424 products per hidden layer) against ~10 MB of inputs and
outputs.  The hidden layers' products run on the tensor cores at fp32
accuracy (3xTF32, ``csrc/wire_tc.cuh``, the chains of ``ops/wire_mlp.py``'s
pair) with the Gabor forward/backward fused into their epilogues, weight
gradients as fixed-order per-chunk partial sums (no float atomics), live
activations in device scratch (``StepScratch``) reused across steps.  See
the source note in ``csrc/wire_step.cu``.

``wire_step`` runs the plain version for tensors on the CPU, and for CUDA
tensors launches the kernel or raises; there is no fallback between them.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from wire_tpu_torch.nn.models import autodiff_step, wire_apply_plain
from wire_tpu_torch.ops import build


class StepScratch:
    """Device scratch of the step kernel (live activations, pre-activations,
    gradients in flight, partial sums): allocated with ``torch.empty`` on
    first use and reused by every later step of the same shape."""

    def __init__(self):
        self._bufs = {}

    def get(self, name, shape, device):
        buf = self._bufs.get(name)
        if buf is None or tuple(buf.shape) != tuple(shape) or \
                buf.device != device:
            buf = torch.empty(shape, dtype=torch.float32, device=device)
            self._bufs[name] = buf
        return buf


def stack_params(params, L):
    """The stacked layout the kernel reads (wire_step.py:88-119 without the
    lane padding): w1 (d, h), b1 (h), Wh (L, 2h, 2h) with per-layer blocks
    [[wr, wi], [-wi, wr]], its transpose WhT, Bh (L, 2h) = [br | bi],
    fW (2h, o) = [fwr; -fwi], its transpose fWT, and fb (o)."""
    w1, b1 = params["first"]["w"], params["first"]["b"]
    h = w1.shape[1]
    blocks, biases = [], []
    for i in range(L):
        p = params[f"hidden_{i}"]
        blocks.append(torch.cat([torch.cat([p["wr"], p["wi"]], 1),
                                 torch.cat([-p["wi"], p["wr"]], 1)], 0))
        biases.append(torch.cat([p["br"], p["bi"]]))
    if L:
        Wh, Bh = torch.stack(blocks), torch.stack(biases)
    else:
        Wh = w1.new_empty((0, 2 * h, 2 * h))
        Bh = w1.new_empty((0, 2 * h))
    f = params["final"]
    fW = torch.cat([f["wr"], -f["wi"]], 0)
    return {"w1": w1.contiguous(), "b1": b1.contiguous(),
            "Wh": Wh.contiguous(), "WhT": Wh.transpose(1, 2).contiguous(),
            "Bh": Bh.contiguous(), "fW": fW.contiguous(),
            "fWT": fW.t().contiguous(), "fb": f["br"].contiguous()}


def unstack_grads(gw1, gWh, gfW, params, L):
    """Map the kernel's stacked gradients back to the params dict
    (wire_step.py:122-144).  gw1 = [dw1; db1], gWh[l] = [dW; dB],
    gfW = [dfW; dfb].  W's blocks alias wr twice and +-wi, so
    dwr = G[:h,:h] + G[h:,h:] and dwi = G[:h,h:] - G[h:,:h]; the final
    layer's bi gets zero (the model keeps only the real output)."""
    d = gw1.shape[0] - 1
    h = gw1.shape[1]
    dparams = {"first": {"w": gw1[:d], "b": gw1[d]}}
    for i in range(L):
        G, B = gWh[i, :2 * h], gWh[i, 2 * h]
        dparams[f"hidden_{i}"] = {
            "wr": G[:h, :h] + G[h:, h:], "wi": G[:h, h:] - G[h:, :h],
            "br": B[:h], "bi": B[h:]}
    dparams["final"] = {"wr": gfW[:h], "wi": -gfW[h:2 * h],
                        "br": gfW[2 * h],
                        "bi": torch.zeros_like(params["final"]["bi"])}
    return dparams


def wire_step_plain(params, coords, target, spec, *, nvalid=None,
                    denom=None, gt=None, want_metrics=False):
    """The plain PyTorch version: autodiff of the WIRE forward with the mask
    and denom, plus the SSE sums, with TF32 off."""
    return autodiff_step(wire_apply_plain, params, coords, target, spec,
                         nvalid=nvalid, denom=denom, gt=gt,
                         want_metrics=want_metrics)


def step_flops(n, d, h, o, L):
    """Multiply-add FLOPs of one step as the kernel computes it (2 per
    MAC): forward, data gradient and weight+bias gradients, no padding."""
    h2 = 2 * h
    fwd = 2 * n * (d * h + L * h2 * h2 + h2 * o)
    data = 2 * n * (o * h2 + L * h2 * h2)
    weight = 2 * n * ((d + 1) * h + L * (h2 + 1) * h2 + (h2 + 1) * o)
    return fwd + data + weight


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("wire_step")
    lib.wire_step_run.argtypes = ([_PTR] * 23 + [_INT] * 6 + [_FLT] * 4
                                  + [_INT, _PTR])
    lib.wire_step_run.restype = _INT
    lib.wire_step_part_floats.argtypes = [_INT] * 4
    lib.wire_step_part_floats.restype = ctypes.c_longlong
    lib.wire_step_max_out.argtypes = []
    lib.wire_step_max_out.restype = _INT
    lib.wire_step_error_string.argtypes = [_INT]
    lib.wire_step_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, device, who="wire_step"):
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{who}: {name} has dtype {t.dtype}, "
                        f"expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def _launch(params, coords, target, spec, nvalid, denom, gt, want_metrics,
            scratch):
    lib = _lib()
    dev = coords.device
    n, d = coords.shape
    h = params["first"]["w"].shape[1]
    o = params["final"]["br"].shape[0]
    L = spec.hidden_layers
    if o > lib.wire_step_max_out():
        raise ValueError(f"wire_step kernel supports out_features <= "
                         f"{lib.wire_step_max_out()}, got {o}")
    nv = n if nvalid is None else int(nvalid)
    if not 0 <= nv <= n:
        raise ValueError(f"wire_step: nvalid={nv} outside [0, {n}]")
    _check("coords", coords, (n, d), dev)
    _check("target", target, (n, o), dev)
    if gt is not None:
        _check("gt", gt, (n, o), dev)
    w = stack_params(params, L)
    for name, shape in (("w1", (d, h)), ("b1", (h,)), ("Wh", (L, 2 * h, 2 * h)),
                        ("Bh", (L, 2 * h)), ("fW", (2 * h, o)), ("fb", (o,))):
        _check(name, w[name], shape, dev)

    scratch = StepScratch() if scratch is None else scratch
    h2 = 2 * h
    acts = scratch.get("acts", (L + 1, n, h2), dev)
    zs = scratch.get("zs", (L, n, h2), dev)
    z1 = scratch.get("z1", (n, h), dev)
    g = scratch.get("g", (n, o), dev)
    dz = scratch.get("dz", (2, n, h2), dev)
    dz1 = scratch.get("dz1", (n, h), dev)
    part = scratch.get("part", (lib.wire_step_part_floats(n, d, h, o),), dev)

    pred = torch.empty((n, o), dtype=torch.float32, device=dev)
    gw1 = torch.empty((d + 1, h), dtype=torch.float32, device=dev)
    gWh = torch.empty((L, h2 + 1, h2), dtype=torch.float32, device=dev)
    gfW = torch.empty((h2 + 1, o), dtype=torch.float32, device=dev)
    sse = torch.zeros((2,), dtype=torch.float32, device=dev)

    dn = np.float32(n * o if denom is None else denom)
    two_inv_denom = np.float32(2.0) * (np.float32(1.0) / dn)
    ptrs = [coords, target, gt, w["w1"], w["b1"], w["Wh"], w["WhT"], w["Bh"],
            w["fW"], w["fWT"], w["fb"], pred, gw1, gWh, gfW, sse, acts, zs,
            z1, g, dz, dz1, part]
    rc = lib.wire_step_run(
        *[None if t is None else t.data_ptr() for t in ptrs],
        n, d, h, o, L, nv, float(two_inv_denom), float(spec.hidden_omega0),
        float(spec.scale), float(spec.first_omega0), int(want_metrics),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wire_step kernel launch failed: CUDA error {rc} "
                           f"({lib.wire_step_error_string(rc).decode()})")
    wire_step.launches += 1
    dparams = unstack_grads(gw1, gWh, gfW, params, L)
    if want_metrics:
        return pred, dparams, (sse[0], sse[1])
    return pred, dparams


def wire_step(params, coords, target, spec, *, nvalid=None, denom=None,
              gt=None, want_metrics=False, scratch=None):
    """One train step: returns (pred, dparams) for
    ``loss = sum_{rows < nvalid} (pred - target)^2 / denom``, plus
    ``(sse_target, sse_gt)`` when ``want_metrics`` (gt defaults to target).

    coords (n, d), target (n, o), float32.  nvalid (a Python int) defaults
    to n, denom to n*o; invalid rows must be a tail.  For CPU tensors this
    is ``wire_step_plain``; for CUDA tensors the kernel is launched (and
    ``wire_step.launches`` advanced) or an error is raised.  ``scratch``
    (a StepScratch) keeps the kernel's device buffers across steps."""
    if coords.device.type == "cpu":
        return wire_step_plain(params, coords, target, spec, nvalid=nvalid,
                               denom=denom, gt=gt, want_metrics=want_metrics)
    if coords.device.type != "cuda":
        raise ValueError(f"wire_step: unsupported device {coords.device}")
    return _launch(params, coords, target, spec, nvalid, denom, gt,
                   want_metrics, scratch)


wire_step.launches = 0
