"""Scaling-efficiency harness (port of wire_tpu/dist/scaling.py): fit
throughput on meshes of 1..N ranks of the launched process group, and the
efficiency against linear scaling.

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m wire_tpu_torch.dist.scaling --size 256 --niters 100

A mesh of nd ranks is the sub-group of the world's first nd
(``make_mesh(nd)``); nd = 1 is the single-device ``fit_pointwise`` on rank
0.  On a card, coordinates per second come from the fit's ``step_ms``
(CUDA events over the epochs after the first), not from wall time; on the
CPU (a check of the harness, not a device figure) from the fit's wall
time.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from wire_tpu_torch.dist.fitter import fit_pointwise_sharded
from wire_tpu_torch.dist.mesh import local_device, make_mesh
from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise


def _coords_per_s(res, cfg, npoints):
    if res.step_ms is not None:
        return npoints / (res.step_ms * 1e-3)
    return cfg.niters * npoints / res.wall_time_s


def measure_scaling(model, params, coords, target, cfg: FitConfig,
                    device_counts=None, repeats=2, device=None):
    """{ndev: coords_per_s} on this rank, for each mesh it is in (the
    best of ``repeats`` fits); every rank of the world must call it, since
    each sub-group is made collectively.  ndev = 1 runs ``fit_pointwise``
    on rank 0 alone."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    dev = local_device(device)
    npoints = target.shape[0]
    results = {}
    for nd in device_counts:
        mesh = make_mesh(nd, dev) if nd > 1 else None
        runs = (nd == 1 and rank == 0) or mesh is not None
        for _ in range(repeats if runs else 0):
            if nd == 1:
                res = fit_pointwise(model, params, coords, target, cfg,
                                    track="noisy", device=dev)
            else:
                res = fit_pointwise_sharded(model, params, coords, target,
                                            cfg, mesh, track="noisy")
            results[nd] = max(results.get(nd, 0.0),
                              _coords_per_s(res, cfg, npoints))
        if world > 1:
            dist.barrier()
    return results


def efficiency_table(results):
    """[(ndev, coords_per_s, efficiency vs ndev x the one-device rate)]."""
    base = results.get(1)
    rows = []
    for nd, cps in sorted(results.items()):
        eff = cps / (base * nd) if base else float("nan")
        rows.append((nd, cps, eff))
    return rows


def main(argv=None):
    import argparse
    from wire_tpu_torch.dist import multihost
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.signals import coords as C, image as I

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--niters", type=int, default=100)
    p.add_argument("--hidden", type=int, default=300)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the rank's card)")
    a = p.parse_args(argv)

    multihost.initialize(device=a.device)
    H = W = a.size
    im = I.synthetic_image(H, W, 3, seed=0)
    model = get_inr("wire", in_features=2, out_features=3,
                    hidden_features=a.hidden, hidden_layers=2,
                    first_omega0=7.0, hidden_omega0=7.0, scale=8.0)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = FitConfig(learning_rate=5e-3, niters=a.niters, maxpoints=H * W)
    res = measure_scaling(model, params, C.grid2d(H, W), im.reshape(-1, 3),
                          cfg, device=a.device)
    if dist.is_initialized() and dist.get_rank():
        return
    dev = local_device(a.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (wall time; not a device figure)")
    print(f"device: {name}")
    print(f"{'devices':>8} {'coords/s':>14} {'efficiency':>11}")
    for nd, cps, eff in efficiency_table(res):
        print(f"{nd:>8} {cps:>14.3e} {eff:>10.1%}")


if __name__ == "__main__":
    main()
