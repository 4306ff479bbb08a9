"""One rank of the 2-rank Gloo group that tests/test_torch_dist.py spawns on
the CPU: it joins through ``wire_tpu_torch.dist.multihost.initialize`` from
the ``torch.distributed.run`` environment the test sets (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE), runs the
cases of ``run_cases`` through the port's sharded fitters, and writes its
results to ``<out>/rank<r>.npz``.

The problems and the injected permutations are defined here and imported
by the test, which runs the same problems through wire_tpu.dist on a
2-device mesh and through the port's single-device fitters.

Usage: python torch_dist_worker.py <out_dir>
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# WIRE 32 wide (22 complex units), 2 hidden, omega0 5, sigma 4: the
# problems of tests/test_dist.py and tests/test_multiprocess.py
MODEL_KW = dict(in_features=2, out_features=3, hidden_features=32,
                hidden_layers=2, first_omega0=5.0, hidden_omega0=5.0,
                scale=4.0)
FULL = dict(H=32, niters=20, lr=5e-3)           # full batch, local mode
CHUNKED = dict(H=32, niters=12, lr=1e-3, maxpoints=256)
GLOBAL = dict(H=32, niters=15, lr=1e-3, maxpoints=256)
REMAINDER = dict(H=24, niters=6, lr=1e-3, maxpoints=512)
CONVERGE = dict(H=64, niters=100, lr=5e-3, maxpoints=512, hidden=48)
OPERATOR = dict(H=32, niters=15, lr=5e-3, scale=2)
FRAMES = dict(H=16, niters=6, lr=5e-3, scale=2, nframes=10, bs=8)
IOU = dict(H=32, niters=6, lr=5e-3)
# a checkpointed chunked fit: saves every 4 epochs, stopped after the 2nd
RESUME = dict(H=32, niters=12, lr=1e-3, maxpoints=256, scan_segment=4)
FEED = (8, 8, 8)


def image(H):
    from wire_tpu_torch.signals import image as I
    return I.synthetic_image(H, H, 3, seed=0)


def perm(n, seed):
    return np.random.default_rng(seed).permutation(n).astype(np.int64)


def frames(H, scale, nframes):
    """The frame stacks of tests/test_dist.py's frames case."""
    from wire_tpu_torch.signals import coords as C
    rng = np.random.RandomState(0)
    base = C.grid2d(H, H)
    fc = np.stack([np.clip(base + rng.uniform(-0.05, 0.05, size=(1, 2)),
                           -1, 1) for _ in range(nframes)]).astype(np.float32)
    fp = rng.rand(nframes, (H // scale) ** 2, 3).astype(np.float32)
    fm = (rng.rand(*fp.shape) > 0.1).astype(np.float32)
    return fc, fp, fm


def model_and_params(**kw):
    import torch
    from wire_tpu_torch.nn.registry import get_inr
    model = get_inr("wire", **dict(MODEL_KW, **kw))
    return model, model.init(torch.Generator().manual_seed(0))


def iou_sums(rec, tgt):
    import torch
    p, g = rec >= 0.5, tgt != 0
    return torch.logical_and(p, g).sum(), torch.logical_or(p, g).sum()


def fixed(p):
    import torch
    return lambda n: torch.as_tensor(p)


class Stop(Exception):
    pass


def stopped_after(nth, fn):
    """Run ``fn()`` with the trainer's nth save raising Stop just after it
    has written its file; True if it stopped."""
    from wire_tpu_torch.train import trainer as T
    orig, calls = T._save_fit_state, [0]

    def save(*a, **k):
        orig(*a, **k)
        calls[0] += 1
        if calls[0] == nth:
            raise Stop

    T._save_fit_state = save
    try:
        fn()
    except Stop:
        return True
    finally:
        T._save_fit_state = orig
    return False


def run_cases(mesh, out, tmp):
    """Every case on ``mesh``; fills ``out`` with arrays; ``tmp`` is a
    directory for fit-state files."""
    import torch
    from wire_tpu_torch import tree
    from wire_tpu_torch.dist import (fit_frames_sharded, fit_operator_sharded,
                                     fit_pointwise_sharded, make_mesh,
                                     multihost as MH, scaling)
    from wire_tpu_torch.operators.forward import DownsampleOp
    from wire_tpu_torch.signals import coords as C
    from wire_tpu_torch.train.trainer import CheckpointSpec, FitConfig

    def keep(name, res):
        for k in ("mse_gt", "mse_noisy", "best_rec", "final_rec"):
            v = getattr(res, k)
            if v is not None:
                out[f"{name}/{k}"] = np.asarray(v)
        out[f"{name}/best_mse"] = np.float64(res.best_mse)
        for path, v in tree.leaves(res.params):
            out[f"{name}/params/" + "/".join(map(str, path))] = \
                v.detach().cpu().numpy()
        if res.time_array is not None:
            for j, col in enumerate(res.time_array):
                out[f"{name}/sums{j}"] = np.asarray(col)

    model, params = model_and_params()
    H = FULL["H"]
    target = image(H).reshape(-1, 3)
    n = H * H
    cfg = FitConfig(learning_rate=FULL["lr"], niters=FULL["niters"],
                    maxpoints=n)
    keep("full", fit_pointwise_sharded(model, params, C.grid2d(H, H), target,
                                       cfg, mesh, track="noisy"))
    # feed_rows: each rank builds only its own rows
    fed_c = MH.feed_rows(mesh, lambda lo, hi: C.grid2d(H, H)[lo:hi], n)
    fed_t = MH.feed_rows(mesh, lambda lo, hi: target[lo:hi], n)
    keep("fed", fit_pointwise_sharded(model, params, fed_c, fed_t, cfg, mesh,
                                      track="noisy"))
    keep("iou", fit_pointwise_sharded(
        model, params, C.grid2d(H, H), target, FitConfig(
            learning_rate=IOU["lr"], niters=IOU["niters"], maxpoints=n),
        mesh, track="noisy", epoch_sums=iou_sums))

    H = CHUNKED["H"]
    target = image(H).reshape(-1, 3)
    cfg = FitConfig(learning_rate=CHUNKED["lr"], niters=CHUNKED["niters"],
                    maxpoints=CHUNKED["maxpoints"])
    local = fixed(perm(H * H // mesh.size, 7))
    keep("chunked", fit_pointwise_sharded(
        model, params, C.grid2d(H, H), target, cfg, mesh, gt=target,
        permutation=local))
    keep("chunked_grid", fit_pointwise_sharded(
        model, params, C.GridSpec(H, H), target, cfg, mesh, gt=target,
        permutation=local))
    keep("chunked_seeded", fit_pointwise_sharded(
        model, params, C.grid2d(H, H), target, cfg, mesh, gt=target))
    keep("chunked_seeded_grid", fit_pointwise_sharded(
        model, params, C.GridSpec(H, H), target, cfg, mesh, gt=target))

    H = GLOBAL["H"]
    target = image(H).reshape(-1, 3)
    cfg = FitConfig(learning_rate=GLOBAL["lr"], niters=GLOBAL["niters"],
                    maxpoints=GLOBAL["maxpoints"])
    keep("global", fit_pointwise_sharded(
        model, params, C.GridSpec(H, H), target, cfg, mesh, gt=target,
        track="noisy", global_perm=True, permutation=fixed(perm(H * H, 11))))
    H = REMAINDER["H"]
    target = image(H).reshape(-1, 3)
    cfg = FitConfig(learning_rate=REMAINDER["lr"],
                    niters=REMAINDER["niters"],
                    maxpoints=REMAINDER["maxpoints"])
    keep("remainder", fit_pointwise_sharded(
        model, params, C.grid2d(H, H), target, cfg, mesh, track="noisy",
        global_perm=True, permutation=fixed(perm(H * H, 13))))

    H = CONVERGE["H"]
    target = image(H).reshape(-1, 3)
    wide, wide_params = model_and_params(hidden_features=CONVERGE["hidden"])
    keep("converge", fit_pointwise_sharded(
        wide, wide_params, C.grid2d(H, H), target, FitConfig(
            learning_rate=CONVERGE["lr"], niters=CONVERGE["niters"],
            maxpoints=CONVERGE["maxpoints"]), mesh, track="noisy"))

    H, s = OPERATOR["H"], OPERATOR["scale"]
    im = image(H)
    op = DownsampleOp(s)
    meas = op(torch.from_numpy(im)).numpy()
    keep("operator", fit_operator_sharded(
        model, params, C.grid2d(H, H), meas, op, FitConfig(
            learning_rate=OPERATOR["lr"], niters=OPERATOR["niters"]),
        mesh, gt_field=im, field_shape=(H, H, 3)))

    keep("operator_chunked", fit_operator_sharded(
        model, params, C.grid2d(H, H), meas, op, FitConfig(
            learning_rate=OPERATOR["lr"], niters=OPERATOR["niters"],
            maxpoints=200), mesh, gt_field=im, field_shape=(H, H, 3),
        render_chunked=True))

    # local mode's state is each rank's own (its rows, its generator): a
    # fit stopped after its second save resumes from its rank's file
    H = RESUME["H"]
    target = image(H).reshape(-1, 3)
    cfg = FitConfig(learning_rate=RESUME["lr"], niters=RESUME["niters"],
                    maxpoints=RESUME["maxpoints"],
                    scan_segment=RESUME["scan_segment"])
    ckpt = CheckpointSpec(path=os.path.join(tmp, "fit.npz"))

    def resumable(checkpoint):
        return fit_pointwise_sharded(
            model, params, C.GridSpec(H, H), target, cfg, mesh, gt=target,
            epoch_sums=iou_sums, checkpoint=checkpoint)

    out["resume/stopped"] = np.int64(stopped_after(
        2, lambda: resumable(ckpt)))
    out["resume/file"] = np.int64(os.path.exists(
        f"{ckpt.path}.rank{mesh.rank}of{mesh.size}"))
    keep("resumed", resumable(ckpt))
    keep("unbroken", resumable(None))

    H, s = FRAMES["H"], FRAMES["scale"]
    fc, fp, fm = frames(H, s, FRAMES["nframes"])
    keep("frames", fit_frames_sharded(
        model, params, fc, fp, fm, FitConfig(
            learning_rate=FRAMES["lr"], niters=FRAMES["niters"],
            lr_decay=1.0), mesh, hr_shape=(H, H, 3), scale=s,
        batch_size=FRAMES["bs"],
        permutation=fixed(perm(FRAMES["nframes"], 17))))

    lo, hi = MH.local_row_range(mesh, int(np.prod(FEED)))
    out["feed/range"] = np.array([lo, hi])
    rows = MH.feed_rows(mesh, lambda a, b: C.grid_rows(*FEED, a, b),
                        int(np.prod(FEED)))
    out["feed/local"] = rows.data.numpy()
    out["feed/gathered"] = mesh.gather(rows.data).numpy()

    # a subset group: rank 0 alone; rank 1 gets None
    sub = make_mesh(1, "cpu")
    out["subset/none"] = np.int64(sub is None)
    if sub is not None:
        H = FULL["H"]
        keep("subset", fit_pointwise_sharded(
            model, params, C.grid2d(H, H), image(H).reshape(-1, 3),
            FitConfig(learning_rate=FULL["lr"], niters=5, maxpoints=H * H),
            sub, track="noisy"))

    H = 16
    rates = scaling.measure_scaling(
        model, params, C.grid2d(H, H), image(H).reshape(-1, 3),
        FitConfig(learning_rate=5e-3, niters=3, maxpoints=H * H),
        device_counts=[1, 2], repeats=1, device="cpu")
    out["scaling/devices"] = np.array(sorted(rates))
    out["scaling/rates"] = np.array([rates[k] for k in sorted(rates)])


def main():
    out_dir = sys.argv[1]
    sys.path.insert(0, ROOT)
    for name in ("jax", "jaxlib", "wire_tpu"):
        sys.modules[name] = None
    import torch
    import torch.distributed as dist
    from wire_tpu_torch.dist import make_mesh, multihost as MH
    torch.set_num_threads(1)
    assert MH.initialize(device="cpu")
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    mesh = make_mesh(None, "cpu")
    out = {}
    run_cases(mesh, out, out_dir)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
