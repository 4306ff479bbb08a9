"""The port's sharded fitters (wire_tpu_torch/dist/) against wire_tpu.dist
and against the port's single-device fitters, on the CPU.

The port runs SPMD: one module-scoped spawn of a 2-rank Gloo group
(tests/torch_dist_worker.py, joined through ``multihost.initialize`` from
a ``torch.distributed.run`` environment), and in-process worlds of one
(``multihost.world_of_one``: Gloo over an in-memory store).  wire_tpu runs
the same problems on ``make_mesh(2)`` of this process's 8 virtual CPU
devices (tests/conftest.py).  Every fit starts from the port's seed-0 init
moved across with ``wire_tpu_torch.bridge``; where wire_tpu draws a
permutation (``jax.random.permutation``, replaced here by a function
returning a fixed one, with the program cache emptied), the port takes the
same one through ``permutation``.  The problems are tests/test_dist.py's
and tests/test_multiprocess.py's at WIRE 32 wide (22 complex units), 2
hidden, omega0 5, sigma 4, 6-20 epochs (the worker's constants); the
chunked and exact-mode fits at lr 1e-3, for the reason
tests/test_torch_chunked.py gives.

Tolerances: histories and best MSE rel 2e-4 (wire_tpu's own bound across
processes, tests/test_multiprocess.py); parameters and reconstructions
within 1e-4 x their max; the per-epoch IoU within one voxel's share of the
union.  The two ranks' replicated results are equal bit for bit, and a
world of one is bit-equal to the single-device fitter.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from wire_tpu.dist import fitter as JF
from wire_tpu.dist import make_mesh as jmake_mesh
from wire_tpu.nn import get_inr as jget_inr
from wire_tpu.signals import coords as JC
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge, tree
from wire_tpu_torch.apps import common as TCm
from wire_tpu_torch.dist import fitter as TF
from wire_tpu_torch.dist import multihost as MH
from wire_tpu_torch.dist import scaling as SC
from wire_tpu_torch.dist.mesh import Mesh, make_mesh
from wire_tpu_torch.operators.forward import DownsampleOp
from wire_tpu_torch.signals import coords as C
from wire_tpu_torch.train import metrics as TM
from wire_tpu_torch.train import trainer as T

from . import torch_dist_worker as W

REL = 2e-4
FIELD_REL = 1e-4
_WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread in this module, restored after it: the suite's
    workers share the cores, and torch's thread pool waits on busy cores
    (a 0.1 s fit of this file took 40 s beside eight busy processes, 1 s
    on one thread)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """Both ranks' results of the 2-rank Gloo group: [rank0, rank1]."""
    out = str(tmp_path_factory.mktemp("torch_dist"))
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    texts = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        texts.append(stdout.decode(errors="replace"))
    for p, text in zip(procs, texts):
        assert p.returncode == 0, f"rank failed:\n{text[-3000:]}"
    res = []
    for r in range(2):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res


@pytest.fixture(scope="module")
def world_of_one():
    """The Mesh of a process group of this process alone (Gloo)."""
    assert MH.world_of_one(device="cpu")
    yield make_mesh(1, "cpu")
    dist.destroy_process_group()


def _jax(params):
    return jax.tree.map(jnp.asarray, bridge.params_to_numpy(params))


def _jmodel():
    return jget_inr("wire", fused="never", **W.MODEL_KW)


def _inject(monkeypatch, perm):
    """wire_tpu draws ``perm`` wherever it draws a permutation."""
    monkeypatch.setattr(JF, "_PROGRAMS", {})
    monkeypatch.setattr(JT, "_PROGRAMS", {})
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n, *a, **k: jnp.asarray(perm))


def _params_np(params):
    """{'first/w': array, ...} of a port or wire_tpu parameter tree."""
    return {"/".join(map(str, p)): np.asarray(v)
            for p, v in tree.leaves(jax.tree.map(np.asarray, params)
                                    if not _is_torch(params)
                                    else bridge.params_to_numpy(params))}


def _is_torch(params):
    return isinstance(tree.leaves(params)[0][1], torch.Tensor)


def _as_dict(res):
    out = {k: np.asarray(getattr(res, k)) for k in
           ("mse_gt", "mse_noisy", "best_rec", "final_rec")
           if getattr(res, k) is not None}
    out["best_mse"] = np.float64(res.best_mse)
    out.update({f"params/{k}": v for k, v in _params_np(res.params).items()})
    return out


def _of(cluster_res, name):
    pre = name + "/"
    return {k[len(pre):]: v for k, v in cluster_res.items()
            if k.startswith(pre)}


def _close(got, want, what, rel=REL):
    """Histories and best MSE rel ``rel``; parameters and reconstructions
    within FIELD_REL x max."""
    assert set(k for k in want if not k.startswith("sums")) <= set(got), what
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if k.startswith("mse") or k == "best_mse":
            np.testing.assert_allclose(g, w, rtol=rel, atol=1e-7,
                                       err_msg=f"{what} {k}")
        elif not k.startswith("sums"):
            bound = FIELD_REL * max(np.abs(w).max(), 1e-3)
            assert np.abs(g - w).max() <= bound, (what, k,
                                                  np.abs(g - w).max(), bound)


def _same(got, want, what):
    for k, w in want.items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(w)), (what, k)


def _fixed(p):
    return lambda n: torch.as_tensor(p)


# -- the 2-rank group against wire_tpu.dist and the single-device fitters --

def test_ranks_hold_the_same_replicated_results(cluster):
    """Parameters, histories, best MSE and the all-gathered
    reconstructions are the same on both ranks, bit for bit."""
    r0, r1 = cluster
    shared = [k for k in r0 if k in r1 and not k.startswith(
        ("feed/", "subset", "scaling/"))]
    assert len(shared) > 100
    for k in shared:
        assert np.array_equal(r0[k], r1[k]), k


def test_full_batch_equals_wire_tpu_and_fit_pointwise(cluster):
    model, params = W.model_and_params()
    H = W.FULL["H"]
    n = H * H
    target = W.image(H).reshape(-1, 3)
    want_j = JF.fit_pointwise_sharded(
        _jmodel(), _jax(params), JC.grid2d(H, H), target,
        JT.FitConfig(learning_rate=W.FULL["lr"], niters=W.FULL["niters"],
                     maxpoints=n), jmake_mesh(2), track="noisy",
        donate=False)
    want_t = T.fit_pointwise(
        model, params, C.grid2d(H, H), target,
        T.FitConfig(learning_rate=W.FULL["lr"], niters=W.FULL["niters"],
                    maxpoints=n), track="noisy", device="cpu")
    got = _of(cluster[0], "full")
    _close(got, _as_dict(want_j), "vs wire_tpu")
    _close(got, _as_dict(want_t), "vs fit_pointwise")


def _chunked(monkeypatch, grid):
    model, params = W.model_and_params()
    H = W.CHUNKED["H"]
    target = W.image(H).reshape(-1, 3)
    _inject(monkeypatch, W.perm(H * H // 2, 7))
    return JF.fit_pointwise_sharded(
        _jmodel(), _jax(params), JC.GridSpec(H, H) if grid
        else JC.grid2d(H, H), target,
        JT.FitConfig(learning_rate=W.CHUNKED["lr"],
                     niters=W.CHUNKED["niters"],
                     maxpoints=W.CHUNKED["maxpoints"]),
        jmake_mesh(2), gt=target, donate=False)


def test_chunked_local_mode_equals_wire_tpu(cluster, monkeypatch):
    """Each rank permutes its own rows (one injected permutation on both
    ranks and both devices), one all-reduce of the local means a chunk."""
    _close(_of(cluster[0], "chunked"), _as_dict(_chunked(monkeypatch, False)),
           "chunked")


def test_gridspec_equals_materialized(cluster):
    """A GridSpec's rows computed from the global row index equal the
    materialized coordinates' fit (float32 rounding of the rows)."""
    for a, b in (("chunked", "chunked_grid"),
                 ("chunked_seeded", "chunked_seeded_grid")):
        _close(_of(cluster[0], b), _of(cluster[0], a), f"{b} vs {a}")


def test_local_minibatch_converges(cluster):
    got = _of(cluster[0], "converge")
    assert got["mse_noisy"][-1] < got["mse_noisy"][0] / 10
    assert np.count_nonzero(got["final_rec"]) == got["final_rec"].size
    # the seeded streams differ by rank: not the injected fit's trajectory
    assert not np.array_equal(_of(cluster[0], "chunked_seeded")["mse_gt"],
                              _of(cluster[0], "chunked")["mse_gt"])


@pytest.mark.parametrize("case", ["global", "remainder"])
def test_global_perm_equals_wire_tpu_and_fit_pointwise(cluster, monkeypatch,
                                                       case):
    """Exact mode: one permutation shared by the ranks, rank r's slice of
    each chunk; ``remainder``'s second chunk holds 64 valid rows, all on
    rank 0 (rank 1 steps on sentinels only)."""
    spec = W.GLOBAL if case == "global" else W.REMAINDER
    seed = 11 if case == "global" else 13
    model, params = W.model_and_params()
    H = spec["H"]
    target = W.image(H).reshape(-1, 3)
    p = W.perm(H * H, seed)
    gt = target if case == "global" else None
    coords_j = JC.GridSpec(H, H) if case == "global" else JC.grid2d(H, H)
    coords_t = C.GridSpec(H, H) if case == "global" else C.grid2d(H, H)
    kw = dict(learning_rate=spec["lr"], niters=spec["niters"],
              maxpoints=spec["maxpoints"])
    _inject(monkeypatch, p)
    want_j = JF.fit_pointwise_sharded(
        _jmodel(), _jax(params), coords_j, target, JT.FitConfig(**kw),
        jmake_mesh(2), gt=gt, track="noisy", donate=False, global_perm=True)
    want_t = T.fit_pointwise(model, params, coords_t, target,
                             T.FitConfig(**kw), gt=gt, track="noisy",
                             device="cpu", permutation=_fixed(p))
    got = _of(cluster[0], case)
    _close(got, _as_dict(want_j), f"{case} vs wire_tpu")
    _close(got, _as_dict(want_t), f"{case} vs fit_pointwise")


def test_subset_group(cluster):
    """make_mesh(1) of a world of 2: rank 0 fits alone, rank 1 gets
    None."""
    assert cluster[0]["subset/none"] == 0 and cluster[1]["subset/none"] == 1
    assert not any(k.startswith("subset/") and k != "subset/none"
                   for k in cluster[1])
    model, params = W.model_and_params()
    H = W.FULL["H"]
    want = T.fit_pointwise(model, params, C.grid2d(H, H),
                           W.image(H).reshape(-1, 3),
                           T.FitConfig(learning_rate=W.FULL["lr"], niters=5,
                                       maxpoints=H * H),
                           track="noisy", device="cpu")
    _close(_of(cluster[0], "subset"), _as_dict(want), "subset")


def _operator_problem():
    H, s = W.OPERATOR["H"], W.OPERATOR["scale"]
    im = W.image(H)
    op = DownsampleOp(s)
    return H, im, op, op(torch.from_numpy(im)).numpy()


def test_operator_sharded_equals_wire_tpu_and_fit_operator(cluster):
    from wire_tpu.operators.forward import DownsampleOp as JDown
    model, params = W.model_and_params()
    H, im, op, meas = _operator_problem()
    kw = dict(learning_rate=W.OPERATOR["lr"], niters=W.OPERATOR["niters"])
    want_j = JF.fit_operator_sharded(
        _jmodel(), _jax(params), JC.grid2d(H, H), meas,
        JDown(W.OPERATOR["scale"]), JT.FitConfig(**kw), jmake_mesh(2),
        gt_field=im, field_shape=(H, H, 3), donate=False)
    want_t = T.fit_operator(model, params, C.grid2d(H, H), meas, op,
                            T.FitConfig(**kw), gt_field=im,
                            field_shape=(H, H, 3), device="cpu")
    got = _of(cluster[0], "operator")
    _close(got, _as_dict(want_j), "operator vs wire_tpu")
    _close(got, _as_dict(want_t), "operator vs fit_operator")


def test_operator_sharded_renders_in_chunks(cluster):
    """render_chunked on a mesh: each rank renders its 512 rows in chunks of
    200 (the tail padded), recomputed in the backward; the trajectory is
    the single-device chunked render's."""
    model, params = W.model_and_params()
    H, im, op, meas = _operator_problem()
    want = T.fit_operator(model, params, C.grid2d(H, H), meas, op,
                          T.FitConfig(learning_rate=W.OPERATOR["lr"],
                                      niters=W.OPERATOR["niters"],
                                      maxpoints=200),
                          gt_field=im, field_shape=(H, H, 3), device="cpu",
                          render_chunked=True)
    _close(_of(cluster[0], "operator_chunked"), _as_dict(want),
           "chunked render vs fit_operator")


def _frames_fit_args():
    H, s = W.FRAMES["H"], W.FRAMES["scale"]
    fc, fp, fm = W.frames(H, s, W.FRAMES["nframes"])
    kw = dict(learning_rate=W.FRAMES["lr"], niters=W.FRAMES["niters"],
              lr_decay=1.0)
    return H, s, (fc, fp, fm), kw


def test_frames_sharded_equals_wire_tpu_and_fit_frames(cluster, monkeypatch):
    """Batches of 8 of 10 frames (6 sentinels in the second), 4 frames a
    rank; the second batch's rank 1 renders sentinels only."""
    model, params = W.model_and_params()
    H, s, stacks, kw = _frames_fit_args()
    order = W.perm(W.FRAMES["nframes"], 17)
    _inject(monkeypatch, order)
    want_j = JF.fit_frames_sharded(
        _jmodel(), _jax(params), *stacks, JT.FitConfig(**kw), jmake_mesh(2),
        hr_shape=(H, H, 3), scale=s, batch_size=W.FRAMES["bs"],
        donate=False)
    want_t = T.fit_frames(model, params, *stacks, T.FitConfig(**kw),
                          hr_shape=(H, H, 3), scale=s,
                          batch_size=W.FRAMES["bs"], device="cpu",
                          permutation=_fixed(order))
    got = _of(cluster[0], "frames")
    _close(got, _as_dict(want_j), "frames vs wire_tpu")
    _close(got, _as_dict(want_t), "frames vs fit_frames")


def test_epoch_sums_keep_iou(cluster):
    """The ranks' intersection and union counts, summed, give
    fit_pointwise's per-epoch IoU."""
    model, params = W.model_and_params()
    H = W.IOU["H"]
    target = W.image(H).reshape(-1, 3)
    want = T.fit_pointwise(
        model, params, C.grid2d(H, H), target,
        T.FitConfig(learning_rate=W.IOU["lr"], niters=W.IOU["niters"],
                    maxpoints=H * H), track="noisy", device="cpu",
        epoch_metric=lambda rec, tgt: TM.iou(rec, tgt, 0.5))
    got = _of(cluster[0], "iou")
    inter, union = got["sums0"], got["sums1"]
    assert inter.shape == union.shape == (W.IOU["niters"],)
    assert np.all(np.abs(inter / union - want.time_array) <= 1.0 / union)
    _close(got, _as_dict(want), "iou fit")


def test_checkpoint_resumes_each_rank_from_its_file(cluster):
    """A local-mode fit (GridSpec rows, chunks, epoch_sums) stopped after
    its second save resumes from its rank's own file
    (``<path>.rank<r>of2``) and ends as the uninterrupted fit, bit for
    bit, on both ranks."""
    for r, res in enumerate(cluster):
        assert res["resume/stopped"] == 1 and res["resume/file"] == 1, r
        _same(_of(res, "resumed"), _of(res, "unbroken"), f"rank {r}")
        assert _of(res, "resumed")["sums0"].shape == (W.RESUME["niters"],)


def test_grid_rows_matches_grid3d():
    H, Wd, Tt = 6, 5, 4
    full = C.grid3d(H, Wd, Tt)
    rows = np.concatenate([C.grid_rows(H, Wd, Tt, lo, min(lo + 23, 120))
                           for lo in range(0, 120, 23)])
    np.testing.assert_array_equal(rows, full)
    np.testing.assert_array_equal(rows, JC.grid_rows(H, Wd, Tt, 0, 120))


def test_feed_rows_and_local_row_range(cluster):
    n = int(np.prod(W.FEED))
    full = C.grid3d(*W.FEED)
    for r, res in enumerate(cluster):
        lo, hi = res["feed/range"]
        assert (lo, hi) == (r * n // 2, (r + 1) * n // 2)
        np.testing.assert_array_equal(res["feed/local"], full[lo:hi])
        np.testing.assert_array_equal(res["feed/gathered"], full)


def test_feed_rows_refuses_a_wrong_row_count():
    mesh = Mesh(group=None, rank=1, size=2, device=CPU, backend="gloo")
    assert MH.local_row_range(mesh, 10) == (5, 10)
    with pytest.raises(ValueError, match=r"returned 4 rows for range"):
        MH.feed_rows(mesh, lambda lo, hi: np.zeros((hi - lo - 1, 3)), 10)


def test_fit_with_fed_rows_matches_numpy_input(cluster):
    _same(_of(cluster[0], "fed"), _of(cluster[0], "full"), "fed rows")


def test_row_ranges_and_the_global_mesh(world_of_one):
    """data_sharding splits rows rank-major, replicated gives every rank
    all of them, and make_global_mesh is the mesh of the whole world."""
    from wire_tpu_torch.dist import mesh as DM
    two = [Mesh(group=None, rank=r, size=2, device=CPU, backend="gloo")
           for r in range(2)]
    assert [DM.data_sharding(m, 10) for m in two] == [(0, 5), (5, 10)]
    assert [DM.replicated(m, 10) for m in two] == [(0, 10), (0, 10)]
    with pytest.raises(ValueError, match="npoints=9 not divisible"):
        DM.data_sharding(two[1], 9)
    assert MH.make_global_mesh("cpu") == world_of_one


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert MH.initialize(device="cpu") is False


def test_scaling_harness(cluster):
    devices, rates = cluster[0]["scaling/devices"], cluster[0]["scaling/rates"]
    assert devices.tolist() == [1, 2]
    assert cluster[1]["scaling/devices"].tolist() == [2]
    rows = SC.efficiency_table(dict(zip(devices.tolist(), rates.tolist())))
    assert [nd for nd, _, _ in rows] == [1, 2]
    assert all(cps > 0 for _, cps, _ in rows)
    assert abs(rows[0][2] - 1.0) < 1e-12


# -- worlds of one: the single-device fitters, bit for bit ------------------

def _pointwise_pair(mesh, case):
    model, params = W.model_and_params()
    H = 24 if case == "remainder" else 32
    target = W.image(H).reshape(-1, 3)
    mp = {"full": H * H, "chunked": 256, "chunked_grid": 256,
          "global": 256, "remainder": 512, "global_full": H * H,
          "global_fed": 256}[case]
    cfg = T.FitConfig(learning_rate=5e-3, niters=6, maxpoints=mp)
    coords = C.GridSpec(H, H) if case == "chunked_grid" else C.grid2d(H, H)
    gp = case in ("global", "remainder", "global_full", "global_fed")
    fed = coords
    if case == "global_fed":     # fed rows, gathered for the exact mode
        fed = MH.feed_rows(mesh, lambda lo, hi: coords[lo:hi], H * H)
    got = TF.fit_pointwise_sharded(model, params, fed, target, cfg, mesh,
                                   gt=target, global_perm=gp)
    want = T.fit_pointwise(model, params, coords, target, cfg, gt=target,
                           device="cpu")
    return got, want


@pytest.mark.parametrize("case", ["full", "chunked", "chunked_grid",
                                  "global", "remainder", "global_full",
                                  "global_fed"])
def test_world_of_one_equals_fit_pointwise(world_of_one, case):
    """One rank: the same chunks from the same generator (seed + 0), the
    all-reduces an identity."""
    got, want = _pointwise_pair(world_of_one, case)
    _same(_as_dict(got), _as_dict(want), case)


def test_world_of_one_iou_equals_the_epoch_metric(world_of_one):
    """Summed counts over one rank: IoU equal to fit_pointwise's
    float32 epoch metric once rounded to float32."""
    model, params = W.model_and_params()
    H = W.IOU["H"]
    target = W.image(H).reshape(-1, 3)
    cfg = T.FitConfig(learning_rate=W.IOU["lr"], niters=W.IOU["niters"],
                      maxpoints=256)
    got = TF.fit_pointwise_sharded(model, params, C.grid2d(H, H), target,
                                   cfg, world_of_one, track="noisy",
                                   epoch_sums=W.iou_sums)
    want = T.fit_pointwise(model, params, C.grid2d(H, H), target, cfg,
                           track="noisy", device="cpu",
                           epoch_metric=lambda r, t: TM.iou(r, t, 0.5))
    inter, union = got.time_array
    assert inter.dtype == np.float64
    np.testing.assert_array_equal(np.float32(inter / union), want.time_array)
    _same(_as_dict(got), _as_dict(want), "iou")


@pytest.mark.parametrize("via", ["sharded", "fit_operator"])
def test_world_of_one_equals_fit_operator(world_of_one, via):
    model, params = W.model_and_params()
    H, im, op, meas = _operator_problem()
    cfg = T.FitConfig(learning_rate=5e-3, niters=6)
    kw = dict(gt_field=im, field_shape=(H, H, 3))
    want = T.fit_operator(model, params, C.grid2d(H, H), meas, op, cfg,
                          device="cpu", **kw)
    if via == "sharded":
        got = TF.fit_operator_sharded(model, params, C.grid2d(H, H), meas, op,
                                      cfg, world_of_one, **kw)
    else:
        got = T.fit_operator(model, params, C.grid2d(H, H), meas, op, cfg,
                             device="cpu", mesh=world_of_one, **kw)
    _same(_as_dict(got), _as_dict(want), via)


def test_world_of_one_equals_fit_frames(world_of_one):
    model, params = W.model_and_params()
    H, s, stacks, kw = _frames_fit_args()
    cfg = T.FitConfig(**kw)
    got = TF.fit_frames_sharded(model, params, *stacks, cfg, world_of_one,
                                hr_shape=(H, H, 3), scale=s,
                                batch_size=W.FRAMES["bs"])
    want = T.fit_frames(model, params, *stacks, cfg, hr_shape=(H, H, 3),
                        scale=s, batch_size=W.FRAMES["bs"], device="cpu")
    _same(_as_dict(got), _as_dict(want), "frames")


# -- refusals -----------------------------------------------------------

def _refusal(case):
    """A call on rank 0 of a 2-rank mesh that must raise before any
    collective."""
    mesh = Mesh(group=None, rank=0, size=2, device=CPU, backend="gloo")
    model, params = W.model_and_params()
    target = W.image(16).reshape(-1, 3)
    coords = C.grid2d(16, 16)
    cfg = T.FitConfig(niters=1, maxpoints=256)
    if case == "block_perm":
        return lambda: TF.fit_pointwise_sharded(
            model, params, coords, target, T.FitConfig(niters=1,
                                                       block_perm=16), mesh)
    if case == "npoints":
        return lambda: TF.fit_pointwise_sharded(
            model, params, coords[:255], target[:255], cfg, mesh)
    if case == "maxpoints":
        return lambda: TF.fit_pointwise_sharded(
            model, params, coords, target, T.FitConfig(niters=1,
                                                       maxpoints=101),
            mesh, global_perm=True)
    if case == "operator_npoints":
        return lambda: TF.fit_operator_sharded(
            model, params, coords[:255], target[:255],
            lambda f: f, cfg, mesh, field_shape=(255, 3))
    if case == "batch_size":
        fc, fp, fm = W.frames(16, 2, 5)
        return lambda: TF.fit_frames_sharded(
            model, params, fc, fp, fm, cfg, mesh, hr_shape=(16, 16, 3),
            scale=2, batch_size=3)
    if case == "fed_range":
        fed = MH.LocalRows(torch.zeros(128, 2), 256, 128, 256)
        return lambda: TF.fit_pointwise_sharded(model, params, fed, target,
                                                cfg, mesh)
    raise AssertionError(case)


@pytest.mark.parametrize("case, exc, match", [
    ("block_perm", NotImplementedError, "block_perm"),
    ("npoints", ValueError, "npoints=255 not divisible by mesh size 2"),
    ("maxpoints", ValueError, "chunk size 101 not divisible by mesh size 2"),
    ("operator_npoints", ValueError, "npoints=255 not divisible"),
    ("batch_size", ValueError, "batch_size=3 not divisible by mesh size 2"),
    ("fed_range", ValueError, r"fed rows \[128, 256\) of 256 on rank 0"),
])
def test_sharded_fitters_refuse(case, exc, match):
    with pytest.raises(exc, match=match):
        _refusal(case)()


def test_mesh_2_without_a_group_raises():
    if dist.is_initialized():
        match = "the process group has 1 ranks"
    else:
        match = "no process group"
    with pytest.raises(RuntimeError, match=match):
        TCm.mesh_from_arg(2, "cpu")
    assert TCm.mesh_from_arg(0, "cpu") is None
