"""Video compressive sensing helpers (port of wire_tpu/operators/
video_cs.py): coded exposure as the reference's linear inverse problems
build it.

- ``coding_masks``    per-pixel random frame-selection masks (numpy, the
                      caller's RandomState)
- ``video_to_coded``  each chunk of ``nframes`` mask-weighted frames summed
                      into one coded exposure (torch, differentiable in the
                      video; usable as a forward operator)
"""
from __future__ import annotations

import numpy as np
import torch


def coding_masks(video_size, nframes, rng=None):
    """(H, W, total) float32 masks: each pixel picks one of ``nframes``
    subframes (``rng.randint``), the pattern tiled over the video's
    length."""
    rng = np.random if rng is None else rng
    H, W, total = video_size
    X, Y = np.mgrid[:H, :W]
    indices = rng.randint(0, nframes, (H, W))
    sub = np.zeros((H, W, nframes), np.float32)
    sub[X, Y, indices] = 1
    masks = np.tile(sub, [1, 1, total // nframes + 1])
    return masks[..., :total]


def video_to_coded(video_thw, masks_thw, nframes):
    """(T, H, W) video and masks -> (ceil(T / nframes), H, W): the sum of
    each ``nframes``-chunk of mask-weighted frames.  numpy inputs become
    float32 tensors; a tensor video keeps its device and its graph."""
    video, masks = (x if isinstance(x, torch.Tensor) else
                    torch.from_numpy(np.asarray(x, np.float32))
                    for x in (video_thw, masks_thw))
    masks = masks.to(video.device, video.dtype)
    T = video.shape[0]
    return torch.stack([(video[i:i + nframes] * masks[i:i + nframes]).sum(0)
                        for i in range(0, T, nframes)])
