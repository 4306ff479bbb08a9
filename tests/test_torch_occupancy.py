"""The port's occupancy slice against wire_tpu on the CPU: the synthetic
volume, IoU (tensor and numpy) and the chunked IoU, the .mat loader with
its bounding-box crop, the native marching cubes (the port's copy of
marching_cubes.cpp, built by g++ into wire_tpu_torch/_build) and the
smoothened march_and_save, equal to wire_tpu's bit for bit; the .obj and
.dae writers; the occupancy app on the CPU at size 16 for 3 epochs (full
batch, and chunked with and without block_perm) writing wire.mat and
wire.dae; its refusals (block_perm with a mesh, --mesh 2 without a
process group, no card).  And the
reference the card holds wire_step's occupancy cases to
(chip_smoke.wire_state_reference, fault C.10): the plain WIRE step run in
float64 on given pre-activations equals the float64 step on its own,
holds the fp32 plain step on the fp32 run's own pre-activations within
chip_smoke.REL_TOL, and refuses a pre-activation moved past it."""
import os

import numpy as np
import pytest
import scipy.io
import torch

from wire_tpu import native as JN
from wire_tpu.signals import image as JI, volume as JV
from wire_tpu.train import metrics as JM

from wire_tpu_torch import native as TN
from wire_tpu_torch.apps import occupancy as TO
from wire_tpu_torch.dist.mesh import Mesh
from wire_tpu_torch.signals import image as TI, volume as TV
from wire_tpu_torch.train import metrics as TM


@pytest.mark.parametrize("N,seed", [(16, 0), (33, 3)])
def test_synthetic_volume_matches_wire_tpu(N, seed):
    np.testing.assert_array_equal(TI.synthetic_volume(N, seed),
                                  JI.synthetic_volume(N, seed))


def test_iou_matches_wire_tpu():
    rng = np.random.default_rng(0)
    preds = rng.uniform(0, 1, (9, 8, 7)).astype(np.float32)
    gt = (rng.uniform(0, 1, (9, 8, 7)) > 0.4).astype(np.float32)
    keep = preds.copy()
    for thres in (None, 0.5, 0.8):
        want = float(JM.iou(preds, gt, thres))
        assert TM.iou(preds, gt, thres) == want
        got = TM.iou(torch.tensor(preds), torch.tensor(gt), thres)
        assert got.dtype == torch.float32 and float(got) == want
        np.testing.assert_allclose(TV.iou_batched(preds, gt, thres, 100),
                                   JV.iou_batched(preds, gt, thres, 100),
                                   rtol=0, atol=0)
    np.testing.assert_array_equal(preds, keep)


def test_load_volume_mat_and_crop_match_wire_tpu(tmp_path):
    vol = np.zeros((12, 10, 9), np.float32)
    vol[2:9, 3:8, 1:7] = 2.0
    vol[4, 4, 4] = 1.5
    path = str(tmp_path / "v.mat")
    scipy.io.savemat(path, {"hypercube": vol})
    for scale in (1.0, 1.5):
        np.testing.assert_array_equal(TV.load_volume_mat(path, scale=scale),
                                      JV.load_volume_mat(path, scale=scale))
    np.testing.assert_array_equal(TV.bbox_crop(vol / 2), JV.bbox_crop(vol / 2))


def test_marching_cubes_matches_wire_tpu(tmp_path):
    vol = JI.synthetic_volume(24, seed=1)
    for occ, iso in ((vol, 0.5), (vol * 0.7 + 0.1, 0.3)):
        tv, tf = TN.marching_cubes(occ, iso)
        jv, jf = JN.marching_cubes(occ, iso)
        assert len(tv) > 0 and len(tf) > 0
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
    got = TV.march_and_save(vol, 0.5, str(tmp_path / "a.dae"),
                            smoothen=True)
    want = JV.march_and_save(vol, 0.5, str(tmp_path / "b.dae"),
                             smoothen=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with open(tmp_path / "a.dae") as fa, open(tmp_path / "b.dae") as fb:
        assert fa.read() == fb.read()
    TN.export_mesh(*got, str(tmp_path / "a.obj"))
    JN.export_mesh(*want, str(tmp_path / "b.obj"))
    with open(tmp_path / "a.obj") as fa, open(tmp_path / "b.obj") as fb:
        text = fa.read()
        assert text == fb.read()
    assert text.count("\nf ") + text.startswith("f ") == len(got[1])
    with pytest.raises(ValueError, match="unsupported"):
        TN.export_mesh(*got, str(tmp_path / "a.ply"))
    v, f = TN.marching_cubes(np.zeros((4, 4, 4), np.float32), 0.5)
    assert v.shape == (0, 3) and f.shape == (0, 3)


@pytest.mark.parametrize("maxpoints,block_perm", [(int(2e5), 0), (1500, 0),
                                                  (1500, 16)],
                         ids=["full_batch", "chunked", "block_perm"])
def test_app_on_the_cpu_writes_its_artifacts(tmp_path, maxpoints,
                                             block_perm):
    out = TO.run(results_dir=str(tmp_path), size=16, niters=3,
                 hidden_features=32, maxpoints=maxpoints,
                 block_perm=block_perm, device="cpu")
    d = tmp_path / "occupancy"
    assert sorted(os.listdir(d)) == ["wire.dae", "wire.mat"]
    mat = scipy.io.loadmat(str(d / "wire.mat"))
    assert mat["iou_array"].size == 3 and mat["mse_array"].size == 3
    res = out["result"]
    assert np.isfinite(res.time_array).all() and np.isfinite(out["psnr"])
    assert 0.0 <= out["iou"] <= 1.0
    np.testing.assert_allclose(mat["Best IoU"].item(), out["iou"])
    # the best epoch is tracked by the training loss (track="noisy")
    assert res.best_mse == pytest.approx(float(res.mse_noisy.min()))


def test_app_setup_is_the_app_s_configuration():
    im, grid, target, model, cfg = TO.setup()
    assert im.shape == (64, 64, 64) and grid.npoints == 262144
    assert target.shape == (262144, 1)
    s = model.spec
    assert (s.nonlin, s.in_features, s.out_features, s.hidden_features,
            s.hidden_layers, s.first_omega0, s.hidden_omega0, s.scale) == \
        ("wire", 3, 1, 300, 3, 20.0, 20.0, 10.0)
    assert (cfg.learning_rate, cfg.niters, cfg.maxpoints, cfg.lr_decay,
            cfg.block_perm) == (5e-3, 200, 200000, 0.2, 0)
    from wire_tpu_torch.train.trainer import _chunking
    assert _chunking(cfg, grid.npoints) == (1, 200000, 2, 137856)
    cfg_b = TO.setup(block_perm=512)[4]
    assert _chunking(cfg_b, grid.npoints) == (512, 199680, 2, 137216)


def test_app_refuses_what_is_not_ported(tmp_path):
    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                backend="gloo")
    with pytest.raises(NotImplementedError, match="block_perm"):
        TO.run(results_dir=str(tmp_path), size=8, niters=1, mesh=mesh,
               block_perm=8)
    with pytest.raises(RuntimeError, match="--mesh 2"):
        TO.main(["--mesh", "2", "--results_dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TO.run(results_dir=str(tmp_path), size=8, niters=1)


def test_wire_state_reference_holds_the_plain_step():
    """At the occupancy app's WIRE (omega0 20, sigma 10, 3 hidden layers,
    212 complex units, d 3, o 1; 3,000 rows of its grid with a 500-row
    sentinel tail): on the float64 run's own pre-activations the reference
    is the float64 step (within 1e-12 x max); on the fp32 run's it holds
    the fp32 plain step within REL_TOL x max (chip_smoke.compare raises
    past it); a pre-activation moved by 2e-4 x its max is refused."""
    import chip_smoke as S
    from wire_tpu_torch.ops import wire_step as WS
    from wire_tpu_torch import tree
    im, grid, target, model, cfg = TO.setup()
    spec = model.spec
    params = model.init(torch.Generator().manual_seed(0))
    idx = torch.randperm(grid.npoints, generator=torch.Generator(
        ).manual_seed(1))[:3000]
    c = grid.rows(idx)
    t = torch.tensor(target)[idx]
    kw = dict(nvalid=2500, denom=2500.0, gt=t, want_metrics=True)
    p64 = tree.map(lambda v: v.double(), params)
    want64 = S.tensors_of(*WS.wire_step_plain(p64, c.double(), t.double(),
                                              spec, nvalid=2500,
                                              denom=2500.0, gt=t.double(),
                                              want_metrics=True))
    ref64, info = S.wire_state_reference(
        torch, params, c, t, spec, kw,
        *S.wire_plain_state(torch, p64, c.double(), spec), "f64")
    assert len(info["z_rel"]) == 1 + 2 * spec.hidden_layers
    for k, w in want64.items():
        assert float((ref64[k] - w).abs().max()) <= 1e-12 * max(
            float(w.abs().max()), 1e-300), k
    got32 = S.tensors_of(*WS.wire_step_plain(params, c, t, spec, **kw))
    z1, zs = S.wire_plain_state(torch, params, c, spec)
    ref, info = S.wire_state_reference(torch, params, c, t, spec, kw, z1, zs,
                                       "fp32")
    S.compare(got32, ref, "fp32 plain vs its state reference")
    assert max(info["z_rel"]) < 1e-5
    zs = zs.clone()
    zs[1, 7, 3] += 2e-4 * float(zs[1].abs().max())
    with pytest.raises(AssertionError, match="hidden_1 zr"):
        S.wire_state_reference(torch, params, c, t, spec, kw, z1, zs, "moved")
