"""The port's volume leftovers (wire_tpu_torch/signals/volume.py) against
wire_tpu.signals.volume on the CPU.

Tolerances:

- the numpy functions (``block_partition``, ``unfold_blocks``,
  ``downsample_blocks``, ``get_query_coords``,
  ``occupancy_cube_from_coords``, ``jitter_volume`` on the same
  RandomState, ``cuboid_data``, ``plot_cube_at``'s calls on an axis) and
  ``BlockPointCloud`` (uniform, ragged and empty-cell clouds at depths 1-3:
  its counts, limits, ``fill`` on the same RandomState, ``fold`` and its
  refusal, ``unfold``, ``downsample``) and ``block_query_coords``: equal bit
  for bit;
- ``BlockPointCloud.refill`` on wire_tpu's uniforms (``jax.random.uniform``
  of its key): within one float32 ulp of wire_tpu's; on a
  ``torch.Generator`` the rows of sdf 1 unchanged bit for bit, the redrawn
  rows inside their cells, two calls from one state equal;
- ``export_mesh_from_model`` of a small WIRE (d 3, 16 wide, 2 hidden
  layers, the occupancy app's omega0 20 and sigma 10) with wire_tpu's
  parameters carried across by ``bridge.py``, at cube_res 12 in ragged
  batches: the occupancies within the WIRE apply's parity tolerance
  (rtol 2e-5, atol 5e-6, tests/test_torch_models.py) of wire_tpu's, with
  and without the sigmoid, and a mesh file written.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wire_tpu.nn import get_inr as jget_inr
from wire_tpu.signals import volume as JV

from wire_tpu_torch import bridge
from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.signals import coords as TC
from wire_tpu_torch.signals import volume as TV

RTOL, ATOL = 2e-5, 5e-6


def _clouds():
    rs = np.random.RandomState(0)
    g = np.linspace(-1, 1, 8, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g)
    uniform = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    ragged = (rs.randn(700, 3) * 0.4).astype(np.float32)
    # two clusters in opposite corners: most cells stay empty
    empty = np.concatenate([rs.rand(150, 3) * 0.2,
                            0.8 + rs.rand(90, 3) * 0.2]).astype(np.float32)
    return {"uniform": uniform, "ragged": ragged, "empty_cells": empty}


CLOUDS = _clouds()


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,per", [(10, 4), (12, 4), (1, 5), (33, 33)])
def test_block_partition_and_helpers_equal_wire_tpus(n, per):
    pts = np.random.default_rng(n).random((n, 3)).astype(np.float32)
    got, gn = TV.block_partition(pts, per)
    want, wn = JV.block_partition(pts, per)
    _same(got, want)
    assert gn == wn == n
    _same(TV.unfold_blocks(got, gn), JV.unfold_blocks(want, wn))
    _same(TV.unfold_blocks(got, gn), pts)
    _same(TV.downsample_blocks(got, 2), JV.downsample_blocks(want, 2))


@pytest.mark.parametrize("res,per", [(6, 50), (8, 64)])
def test_get_query_coords_equals_wire_tpus(res, per):
    lo, hi = (-1.0, -0.5, 0.0), (1.0, 0.5, 0.8)
    got, gn = TV.get_query_coords(lo, hi, res, per)
    want, wn = JV.get_query_coords(lo, hi, res, per)
    _same(got, want)
    assert gn == wn == res ** 3


@pytest.mark.parametrize("given", [False, True])
def test_occupancy_cube_from_coords_equals_wire_tpus(given):
    rng = np.random.default_rng(4)
    coords = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    preds = rng.random(300).astype(np.float32)
    if given:
        a = np.zeros((10, 10, 10), np.float32)
        b = np.zeros((10, 10, 10), np.float32)
        got = TV.occupancy_cube_from_coords(coords, preds, 10, 10, a)
        want = JV.occupancy_cube_from_coords(coords, preds, 10, 10, b)
        assert got is a and want is b
    else:
        got = TV.occupancy_cube_from_coords(coords, preds, 12, 10)
        want = JV.occupancy_cube_from_coords(coords, preds, 12, 10)
    _same(got, want)


@pytest.mark.parametrize("shape,shift", [((12, 12, 12), 2.0),
                                         ((10, 10, 7), 3.5)])
def test_jitter_volume_equals_wire_tpus(shape, shift):
    vol = (np.random.default_rng(5).random(shape) > 0.6).astype(np.float32)
    got = TV.jitter_volume(vol, shift, rng=np.random.RandomState(3))
    want = JV.jitter_volume(vol, shift, rng=np.random.RandomState(3))
    _same(got, want)


def test_cuboid_data_and_plot_cube_at_equal_wire_tpus():
    for origin, size in (((0, 0, 0), (1, 1, 1)), ((0.5, -1, 2), (2, 3, 0.5))):
        for g, w in zip(TV.cuboid_data(origin, size),
                        JV.cuboid_data(origin, size)):
            _same(g, w)

    class Axis:
        def __init__(self):
            self.calls = []

        def plot_surface(self, *args, **kwargs):
            self.calls.append((args, kwargs))

    got, want = Axis(), Axis()
    TV.plot_cube_at((1, 2, 3), (2, 2, 2), color="r", alpha=0.5, ax=got,
                    zorder=3)
    JV.plot_cube_at((1, 2, 3), (2, 2, 2), color="r", alpha=0.5, ax=want,
                    zorder=3)
    assert len(got.calls) == len(want.calls) == 1
    for g, w in zip(got.calls[0][0], want.calls[0][0]):
        _same(g, w)
    assert got.calls[0][1] == want.calls[0][1]
    assert TV.plot_cube_at(ax=None) is None


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_block_point_cloud_equals_wire_tpus(cloud, depth):
    xyz = CLOUDS[cloud]
    sdf = np.random.default_rng(depth).random((len(xyz), 1)).astype(
        np.float32)
    got = TV.BlockPointCloud(xyz, sdf=sdf, depth=depth)
    want = JV.BlockPointCloud(xyz, sdf=sdf, depth=depth)
    for name in ("minvals", "maxvals", "delta", "counts", "occupied",
                 "minlim", "maxlim", "_order", "_starts"):
        _same(getattr(got, name), getattr(want, name))
    assert got.nblocks == want.nblocks
    assert got.maxpoints() == want.maxpoints()
    for occ in (False, True):
        assert got.minpoints(occ) == want.minpoints(occ)
        assert got.nchunks(occ) == want.nchunks(occ)
        for g, w in zip(got.fill(np.random.RandomState(7), occ),
                        want.fill(np.random.RandomState(7), occ)):
            _same(g, w)
    _same(got.flatten(), want.flatten())
    if cloud == "uniform":
        for g, w in zip(got.fold(), want.fold()):
            _same(g, w)
    else:
        with pytest.raises(ValueError, match="uniform"):
            want.fold()
        with pytest.raises(ValueError, match="uniform"):
            got.fold()
    if depth > 1:
        for kw in ({"ndepths": 1}, {"ndepths": 1, "targetdepth": 2},
                   {"ndepths": 0, "targetdepth": 1}):
            g, w = got.downsample(**kw), want.downsample(**kw)
            assert g.depth == w.depth
            _same(g.xyz, w.xyz)
            _same(g.counts, w.counts)
    assert got.downsample(0) is got


@pytest.mark.parametrize("res,depth", [(8, 1), (8, 2), (12, 2)])
def test_block_query_coords_and_unfold_equal_wire_tpus(res, depth):
    lo, hi = (-1, -1, -1), (1, 1, 1)
    got, gds = TV.block_query_coords(lo, hi, res, depth)
    want, wds = JV.block_query_coords(lo, hi, res, depth)
    _same(got, want)
    vals = np.random.default_rng(res).random(got.shape[:2]).astype(
        np.float32)
    _same(gds.unfold(vals, res), wds.unfold(vals, res))
    # unfold puts each point's value back where grid3d has the point
    cube = np.stack([gds.unfold(got[..., k], res) for k in range(3)], -1)
    np.testing.assert_allclose(cube.reshape(-1, 3), TC.grid3d(res, res, res),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("cloud", ["ragged", "empty_cells"])
def test_refill_on_wire_tpus_uniforms(cloud):
    bpc = TV.BlockPointCloud(CLOUDS[cloud], depth=2)
    jbpc = JV.BlockPointCloud(CLOUDS[cloud], depth=2)
    xyz, sdf = bpc.fill(np.random.RandomState(0))
    key = jax.random.key(3)
    want = np.asarray(jbpc.refill(jnp.asarray(xyz), jnp.asarray(sdf), key))
    u = np.array(jax.random.uniform(key, xyz.shape))
    got = bpc._refill(torch.from_numpy(xyz), torch.from_numpy(sdf),
                      torch.from_numpy(u)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_less(np.abs(got - want),
                                 np.spacing(np.abs(want)) * 1.0001)


def test_refill_on_a_torch_generator():
    bpc = TV.BlockPointCloud(CLOUDS["empty_cells"], depth=3)
    xyz, sdf = (torch.from_numpy(a) for a in bpc.fill(
        np.random.RandomState(1)))
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    a = bpc.refill(xyz, sdf, gen)
    gen.set_state(state)
    b = bpc.refill(xyz, sdf, gen)
    assert torch.equal(a, b)
    keep = sdf[..., 0] == 1
    assert torch.equal(a[keep], xyz[keep])
    assert not torch.equal(a[~keep], xyz[~keep])
    lo = torch.from_numpy(bpc.minlim)[:, None, :].expand_as(a)
    hi = torch.from_numpy(bpc.maxlim)[:, None, :].expand_as(a)
    assert bool(((a >= lo) & (a <= hi)).all(-1)[~keep].all())


def _small_wire(fused="never"):
    kw = dict(in_features=3, out_features=1, hidden_features=16,
              hidden_layers=2, first_omega0=20.0, hidden_omega0=20.0,
              scale=10.0)
    jmodel = jget_inr("wire", fused=fused, **kw)
    jparams = jmodel.init(jax.random.key(2))
    tmodel = get_inr("wire", **kw)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def test_grid3d_rows_are_grid3ds():
    want = TC.grid3d(7, 7, 7)
    for lo, hi in ((0, 343), (5, 100), (300, 343)):
        got = TV._grid3d_rows(lo, hi, 7, "cpu").numpy()
        np.testing.assert_array_equal(got, want[lo:hi])


@pytest.mark.parametrize("sigmoid,batch", [(True, 500), (False, 1728),
                                           (True, 1000)])
def test_export_mesh_from_model_matches_wire_tpu(tmp_path, sigmoid, batch):
    jmodel, jparams, tmodel, tparams = _small_wire()
    thres = 0.5 if sigmoid else 0.0
    got = TV.export_mesh_from_model(tmodel, tparams, 12, batch,
                                    str(tmp_path / "port.dae"), thres=thres,
                                    sigmoid=sigmoid, device="cpu")
    want = JV.export_mesh_from_model(jmodel, jparams, 12, batch,
                                     str(tmp_path / "wire_tpu.dae"),
                                     thres=thres, sigmoid=sigmoid)
    assert got.shape == want.shape == (12, 12, 12)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got.min() < thres < got.max()
    assert os.path.getsize(tmp_path / "port.dae") > 0
    verts, faces = TV.march_and_save(got, thres, str(tmp_path / "x.obj"))
    assert len(faces) > 0


def test_export_mesh_from_model_runs_without_a_gradient(tmp_path):
    _, _, tmodel, tparams = _small_wire()
    tparams = {k: {kk: v.requires_grad_(True) for kk, v in d.items()}
               for k, d in tparams.items()}
    seen = []
    orig = tmodel._apply

    def apply(params, coords, spec):
        seen.append(torch.is_grad_enabled())
        return orig(params, coords, spec)

    tmodel._apply = apply
    TV.export_mesh_from_model(tmodel, tparams, 6, 100,
                              str(tmp_path / "m.obj"), device="cpu")
    assert seen and not any(seen)
    assert len(seen) == 3          # 216 points in batches of 100
