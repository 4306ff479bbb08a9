"""The port's chunked epochs of fit_pointwise (wire_tpu_torch/train/
trainer.py) against wire_tpu's, on the CPU from one bridged init and one
shared permutation: wire_tpu draws it through ``jax.random.permutation``,
replaced here by a function that returns the fixed permutation (a
test-side monkeypatch, with wire_tpu's program cache emptied so the fit is
traced with it), the port through its ``permutation`` hook.  The same
permutation serves every epoch.

The volume is 11 x 9 x 7 = 693 points in chunks of 128 (six chunks, 75
sentinel rows in the last); the block-permuted fit takes 11 x 9 x 16 =
1,584 points in blocks of 16 (99 blocks, eight a chunk, thirteen chunks,
80 sentinel rows).  Cases: WIRE (d = 3, out 1) on ``GridSpec`` and on the
materialized coordinates, with ``block_perm``, with ``sort_chunks``, the
autodiff branch (realgabor, no step hook), and a two-argument IoU
``epoch_metric``; 32 features (22 complex units for WIRE), omega0 5,
sigma 2, lr 1e-3 decaying to 0.2x, five epochs.  That rate keeps the
fit's sensitivity to rounding under the tolerances: five 1e-7 relative
perturbations of the init move the port's own WIRE fit by at most 1.3e-6
of an MSE, 3.7e-7 of a parameter and 3.2e-5 of the field (realgabor 2.4e-7,
1.8e-7 and 1.2e-6), where at lr 5e-3 and omega0 10 the same perturbation
grows to 0.2% of the MSE (Adam's first steps take the sign of gradient
entries near zero) and no two implementations could be compared.

Tolerances: MSE histories rel 1e-4 and parameters rel 1e-4 / atol 5e-5, as
tests/test_torch_trainer.py's 5-epoch fit; the fields (best and final
reconstruction, assembled from 30 steps' predictions) rel 1e-4 / atol
1e-4, three times the largest field move above; the per-epoch IoU within
one voxel's share of the union.  ``GridSpec.rows`` is within 2 ulp(1.0) of
``grid3d``'s rows and within 1 ulp of wire_tpu's GridSpec's."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.signals import coords as JC
from wire_tpu.train import metrics as JM
from wire_tpu.train import trainer as JT

from wire_tpu_torch import bridge
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.signals import coords as TCO
from wire_tpu_torch.train import metrics as TM
from wire_tpu_torch.train import trainer as T

REL = 1e-4
EPOCHS = 5
LR = 1e-3


def _volume(H, W, Tt, seed=0):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[-1:1:H * 1j, -1:1:W * 1j, -1:1:Tt * 1j]
    f = np.exp(-(x ** 2 + y ** 2 + z ** 2) / 0.5) + 0.2 * rng.normal(
        size=(H, W, Tt))
    target = (f > 0.6).astype(np.float32).reshape(-1, 1)
    gt = np.clip(f, 0, 1).astype(np.float32).reshape(-1, 1)
    return target, gt


def _perm(n, seed):
    return np.random.default_rng(seed).permutation(n).astype(np.int32)


def _fits(monkeypatch, nonlin, shape, *, grid=True, block_perm=0,
          sort_chunks=False, metric=False, gt=True, track="gt", hf=32,
          lr=LR):
    H, W, Tt = shape
    npoints = H * W * Tt
    target, gtv = _volume(H, W, Tt)
    gtv = gtv if gt else None
    U = block_perm if block_perm > 1 else 1
    perm = _perm(npoints // U, 7)
    monkeypatch.setattr(JT, "_PROGRAMS", {})
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n, *a, **k: jnp.asarray(perm))
    kw = dict(in_features=3, out_features=1, hidden_features=hf,
              hidden_layers=2)
    kw.update(first_omega0=5.0, hidden_omega0=5.0, scale=2.0)
    tmodel = tget_inr(nonlin, **kw)
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    cfg_kw = dict(learning_rate=lr, niters=EPOCHS, maxpoints=128,
                  lr_decay=0.2, block_perm=block_perm,
                  sort_chunks=sort_chunks)
    jmetric = (lambda rec, tgt: JM.iou(rec, tgt, 0.5)) if metric else None
    tmetric = (lambda rec, tgt: TM.iou(rec, tgt, 0.5)) if metric else None
    jcoords = JC.GridSpec(H, W, Tt) if grid else JC.grid3d(H, W, Tt)
    tcoords = TCO.GridSpec(H, W, Tt) if grid else TCO.grid3d(H, W, Tt)
    want = JT.fit_pointwise(get_inr(nonlin, fused="never", **kw), jparams,
                            jcoords, target, JT.FitConfig(**cfg_kw),
                            gt=gtv, track=track, donate=False,
                            epoch_metric=jmetric)
    got = T.fit_pointwise(tmodel, tparams, tcoords, target,
                          T.FitConfig(**cfg_kw), gt=gtv, track=track,
                          epoch_metric=tmetric, device="cpu",
                          permutation=lambda n: torch.as_tensor(
                              perm.astype(np.int64)))
    return got, want, npoints


def _check(got, want):
    np.testing.assert_allclose(got.mse_gt, want.mse_gt, rtol=REL)
    np.testing.assert_allclose(got.mse_noisy, want.mse_noisy, rtol=REL)
    np.testing.assert_allclose(got.best_mse, want.best_mse, rtol=REL)
    for g, w in ((got.best_rec, want.best_rec),
                 (got.final_rec, want.final_rec)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=REL, atol=1e-4)
    for name, g, w in (("params", got.params, want.params),
                       ("best_params", got.best_params, want.best_params)):
        gflat = jax.tree_util.tree_flatten_with_path(
            bridge.params_to_numpy(g))[0]
        wflat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, w))[0]
        assert [p for p, _ in gflat] == [p for p, _ in wflat]
        for (path, gv), (_, wv) in zip(gflat, wflat):
            np.testing.assert_allclose(gv, wv, rtol=REL, atol=5e-5,
                                       err_msg=f"{name} {path}")


@pytest.mark.parametrize("grid", [True, False], ids=["gridspec", "coords"])
def test_per_point_chunks_match_wire_tpu(monkeypatch, grid):
    got, want, npoints = _fits(monkeypatch, "wire", (11, 9, 7), grid=grid)
    assert npoints == 693
    _check(got, want)


def test_block_permuted_chunks_match_wire_tpu(monkeypatch):
    got, want, npoints = _fits(monkeypatch, "wire", (11, 9, 16),
                               block_perm=16)
    assert T._chunking(T.FitConfig(maxpoints=128, block_perm=16),
                       npoints) == (16, 128, 13, 80)
    _check(got, want)


def test_block_permuted_materialized_coords_match_wire_tpu(monkeypatch):
    got, want, _ = _fits(monkeypatch, "wire", (11, 9, 16), grid=False,
                         block_perm=16, track="noisy", gt=False)
    _check(got, want)


def test_sorted_chunks_match_wire_tpu(monkeypatch):
    got, want, _ = _fits(monkeypatch, "wire", (11, 9, 7), sort_chunks=True)
    _check(got, want)


def test_autodiff_branch_matches_wire_tpu(monkeypatch):
    """realgabor has no step hook: each chunk takes autodiff of its apply
    with the sentinel rows masked."""
    got, want, _ = _fits(monkeypatch, "realgabor", (11, 9, 7))
    _check(got, want)


def test_two_argument_epoch_metric_matches_wire_tpu(monkeypatch):
    got, want, npoints = _fits(monkeypatch, "wire", (11, 9, 7), metric=True,
                               track="noisy")
    _check(got, want)
    assert got.time_array.shape == (EPOCHS,)
    np.testing.assert_allclose(got.time_array, np.asarray(want.time_array),
                               rtol=0, atol=1.0 / npoints + 1e-6)


def test_one_argument_metric_gets_rec_alone():
    seen = []

    def metric(rec, thres=0.5):
        seen.append(thres)
        return rec.mean()

    coords = TCO.grid3d(4, 4, 4)
    target = np.linspace(0, 1, 64, dtype=np.float32)[:, None]
    tmodel = tget_inr("wire", in_features=3, hidden_features=8)
    res = T.fit_pointwise(tmodel, tmodel.init(torch.Generator().manual_seed(
        0)), coords, target, T.FitConfig(niters=2, maxpoints=20),
        epoch_metric=metric, device="cpu")
    assert seen == [0.5, 0.5] and res.time_array.shape == (2,)
    assert np.isfinite(res.time_array).all()


def test_default_permutations_are_seeded_and_fresh_each_epoch():
    """Without the hook each epoch draws a new permutation from the fit's
    seed: two fits at one seed agree bit for bit, another seed differs."""
    coords = TCO.grid3d(5, 4, 3)
    target = np.linspace(0, 1, 60, dtype=np.float32)[:, None]
    tmodel = tget_inr("wire", in_features=3, hidden_features=8)
    p0 = tmodel.init(torch.Generator().manual_seed(0))
    seen = []
    step_grads = tmodel.step_grads

    def spy(p, rows, t, **kw):
        seen.append(rows[:kw["nvalid"]].clone())
        return step_grads(p, rows, t, **kw)

    tmodel.step_grads = spy
    fits = [T.fit_pointwise(tmodel, p0, coords, target,
                            T.FitConfig(niters=2, maxpoints=25, seed=s),
                            device="cpu") for s in (3, 3, 4)]
    np.testing.assert_array_equal(fits[0].mse_gt, fits[1].mse_gt)
    assert not np.array_equal(fits[0].mse_gt, fits[2].mse_gt)
    epoch0, epoch1 = torch.cat(seen[0:3]), torch.cat(seen[3:6])
    assert not torch.equal(epoch0, epoch1)


def test_block_perm_needs_a_divisible_volume():
    tmodel = tget_inr("wire", in_features=3, hidden_features=8)
    with pytest.raises(ValueError, match="divisible"):
        T.fit_pointwise(tmodel, tmodel.init(torch.Generator().manual_seed(
            0)), TCO.GridSpec(3, 3, 3), np.zeros((27, 1), np.float32),
            T.FitConfig(niters=1, maxpoints=8, block_perm=4), device="cpu")


@pytest.mark.parametrize("shape", [(11, 9, 7), (64, 64, 64), (1, 5, 3),
                                   (17, 1), (256, 256)])
def test_gridspec_rows_match_grid3d_and_wire_tpu(shape):
    spec, jspec = TCO.GridSpec(*shape), JC.GridSpec(*shape)
    idx = np.arange(spec.npoints)
    got = spec.rows(torch.as_tensor(idx)).numpy()
    want = TCO.get_coords(*shape)
    np.testing.assert_array_equal(want, JC.get_coords(*shape))
    assert got.shape == want.shape == spec.shape
    assert np.abs(got - want).max() <= 2 * np.spacing(np.float32(1.0))
    np.testing.assert_allclose(got, np.asarray(jspec.rows(jnp.asarray(idx))),
                               rtol=0, atol=np.spacing(np.float32(1.0)))
    if len(shape) == 3:
        lo, hi = spec.npoints // 3, spec.npoints // 2
        np.testing.assert_array_equal(TCO.grid_rows(*shape, lo, hi),
                                      want[lo:hi])
