"""Coordinate-parallel INR fitting over a process group (port of
wire_tpu/dist/fitter.py): wire_tpu's names for the trainer's fitters with
a ``mesh``.

Every rank of a ``Mesh`` runs the same loop on its own shard:
``train.trainer``'s ``fit_pointwise``, ``fit_operator`` and ``fit_frames``
take the mesh through its hooks (the rows a rank owns, one flat
all-reduce of the gradients a step, the all-gathers of a render or a
reconstruction), a single-device fit being the same loop with every hook
the identity.  The parameters and Adam's state are replicated, each rank
applying the same update to the same gradients; the results are
wire_tpu's: parameters, histories and best MSE on every rank, and the
reconstruction buffers whole (where wire_tpu fetches a sharded buffer,
the port all-gathers it).

- ``fit_pointwise_sharded``: local mode (rank r's rows, its own
  permutation stream seeded ``cfg.seed + r``, the gradients' mean), or
  ``global_perm`` (exact mode: ``fit_pointwise``'s permutation stream,
  slice r of each chunk, the gradients' sum);
- ``fit_operator_sharded``: each rank renders its rows of the grid, the
  operator and loss run replicated;
- ``fit_frames_sharded``: rank r renders its share of each frame batch.

They refuse what wire_tpu's refuse: ``block_perm``, and a point count,
chunk or frame batch not divisible by the mesh size.
"""
from __future__ import annotations

from typing import Callable, Optional

from wire_tpu_torch.train.trainer import (CheckpointSpec, FitConfig,
                                          fit_frames, fit_operator,
                                          fit_pointwise)


def fit_pointwise_sharded(model, params, coords, target, cfg: FitConfig,
                          mesh, *, gt=None, track="gt", global_perm=False,
                          epoch_sums: Optional[Callable] = None,
                          permutation: Optional[Callable] = None,
                          checkpoint: Optional[CheckpointSpec] = None):
    """``fit_pointwise`` on ``mesh`` (wire_tpu/dist/fitter.py:33; its
    docstring gives both modes): coords, target and gt global arrays,
    ``multihost.feed_rows``' ``LocalRows`` or (coords) a ``GridSpec``."""
    return fit_pointwise(model, params, coords, target, cfg, gt=gt,
                         track=track, epoch_sums=epoch_sums,
                         permutation=permutation, checkpoint=checkpoint,
                         mesh=mesh, global_perm=global_perm)


def fit_operator_sharded(model, params, coords, measurement, operator_fn,
                         cfg: FitConfig, mesh, *, gt_field=None, field_shape,
                         track="gt", render_chunked=False,
                         checkpoint: Optional[CheckpointSpec] = None):
    """``fit_operator`` on ``mesh`` (wire_tpu/dist/fitter.py:337), the
    CT/SISR loop with the grid's rows rendered in the ranks' shards."""
    return fit_operator(model, params, coords, measurement, operator_fn,
                        cfg, gt_field=gt_field, field_shape=field_shape,
                        track=track, render_chunked=render_chunked,
                        checkpoint=checkpoint, mesh=mesh)


def fit_frames_sharded(model, params, frame_coords, frame_pixels,
                       frame_masks, cfg: FitConfig, mesh, *, hr_shape, scale,
                       batch_size=4, permutation: Optional[Callable] = None,
                       checkpoint: Optional[CheckpointSpec] = None):
    """``fit_frames`` on ``mesh`` (wire_tpu/dist/fitter.py:444), multi-frame
    SR with each batch's frames split over the ranks."""
    return fit_frames(model, params, frame_coords, frame_pixels, frame_masks,
                      cfg, hr_shape=hr_shape, scale=scale,
                      batch_size=batch_size, permutation=permutation,
                      checkpoint=checkpoint, mesh=mesh)
