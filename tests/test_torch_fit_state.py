"""Fit state of the port's trainers (wire_tpu_torch/train/trainer.py:
CheckpointSpec, _fit_fingerprint, _save_fit_state / _load_fit_state, and
fit_operator's render_chunked), the .npz parameter files
(train/artifacts.py), seeding and profiling, on the CPU.

The resume tests mirror tests/test_trainer.py's: a fit is stopped by an
exception raised just after its second save and resumed from the file with
a fresh init; its histories, parameters, best parameters and fields must
equal the uninterrupted fit's bit for bit (the CPU ops are deterministic,
and the file holds every tensor the next epoch reads, the permutation
generator's state too).  render_chunked against the whole-grid render:
loss histories rel 1e-5 and best fields atol 1e-5, as wire_tpu's own test
(the chunked weight gradients are sums of per-chunk sums, so they round
otherwise).  Parameter files: a wire_tpu file loads in the port and the
port's in wire_tpu, equal bit for bit."""
import dataclasses
import json
import os
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.nn import get_inr
from wire_tpu.train import artifacts as JA

from wire_tpu_torch import bridge, tree
from wire_tpu_torch.apps import occupancy as TO
from wire_tpu_torch.nn.registry import get_inr as tget_inr
from wire_tpu_torch.ops.resample import avg_pool2d
from wire_tpu_torch.signals import coords as C, image as I
from wire_tpu_torch.train import artifacts as A
from wire_tpu_torch.train import profiling as P
from wire_tpu_torch.train import seeding as S
from wire_tpu_torch.train import trainer as T

WIRE = dict(in_features=2, hidden_features=32, hidden_layers=2,
            first_omega0=7.0, hidden_omega0=7.0, scale=6.0)


class Stop(Exception):
    pass


def _stop_after(monkeypatch, nth):
    """Make the nth save raise Stop just after it has written the file."""
    orig = T._save_fit_state
    calls = {"n": 0}

    def save(*a, **k):
        orig(*a, **k)
        calls["n"] += 1
        if calls["n"] == nth:
            raise Stop

    monkeypatch.setattr(T, "_save_fit_state", save)
    return lambda: monkeypatch.setattr(T, "_save_fit_state", orig)


def _equal_trees(a, b):
    fa, fb = tree.leaves(a), tree.leaves(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), p


def _resumed(monkeypatch, tmp_path, fit, nth=2):
    """(uninterrupted, resumed) results of ``fit(checkpoint)``."""
    ref = fit(None)
    ckpt = T.CheckpointSpec(path=str(tmp_path / "fit.npz"))
    restore = _stop_after(monkeypatch, nth)
    with pytest.raises(Stop):
        fit(ckpt)
    restore()
    assert os.path.exists(ckpt.path)
    assert not os.path.exists(ckpt.path + ".tmp.npz")
    return ref, fit(ckpt)


def _assert_same(ref, res):
    np.testing.assert_array_equal(res.mse_gt, ref.mse_gt)
    np.testing.assert_array_equal(res.mse_noisy, ref.mse_noisy)
    assert res.best_mse == ref.best_mse
    _equal_trees(res.params, ref.params)
    _equal_trees(res.best_params, ref.best_params)
    for f in ("best_rec", "final_rec", "time_array"):
        a, b = getattr(res, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("maxpoints,block_perm", [(128, 0), (24 * 24, 0),
                                                  (100, 16)],
                         ids=["chunked", "full_batch", "block_perm"])
def test_fit_pointwise_resume_is_bit_equal(monkeypatch, tmp_path, maxpoints,
                                           block_perm):
    im = I.synthetic_image(24, 24, 3, seed=0)
    model = tget_inr("wire", out_features=3, **WIRE)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = T.FitConfig(learning_rate=5e-3, niters=16, maxpoints=maxpoints,
                      scan_segment=4, block_perm=block_perm)
    ref, res = _resumed(monkeypatch, tmp_path, lambda ck: T.fit_pointwise(
        model, params, C.grid2d(24, 24), im.reshape(-1, 3), cfg,
        track="noisy", epoch_metric=lambda rec: rec.mean(), checkpoint=ck,
        device="cpu"))
    _assert_same(ref, res)
    assert res.mse_gt.shape == (16,)


def test_fit_pointwise_resume_on_a_grid_spec(monkeypatch, tmp_path):
    """The occupancy shape in small: GridSpec rows, chunks with a sentinel
    tail, a two-argument metric, saves every second segment."""
    rng = np.random.default_rng(0)
    target = (rng.uniform(size=(5 * 6 * 7, 1)) > 0.5).astype(np.float32)
    model = tget_inr("wire", out_features=1,
                     **dict(WIRE, in_features=3))
    params = model.init(torch.Generator().manual_seed(1))
    cfg = T.FitConfig(niters=12, maxpoints=64, scan_segment=2)

    def fit(ck):
        if ck is not None:
            ck = dataclasses.replace(ck, every=2)
        return T.fit_pointwise(model, params, C.GridSpec(5, 6, 7), target,
                               cfg, track="noisy", checkpoint=ck,
                               epoch_metric=TO.iou_metric(0.5),
                               device="cpu")

    ref, res = _resumed(monkeypatch, tmp_path, fit)
    _assert_same(ref, res)


def test_fit_operator_resume_is_bit_equal(monkeypatch, tmp_path):
    H = W = 16
    im = I.synthetic_image(H, W, 1, seed=2)[..., 0]

    def op(field):
        return avg_pool2d(field[None, None], 4)[0, 0]

    meas = op(torch.from_numpy(im)).numpy()
    model = tget_inr("wire", out_features=1, **WIRE)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = T.FitConfig(learning_rate=5e-3, niters=12, scan_segment=4)
    for chunked in (False, True):
        (tmp_path / str(chunked)).mkdir()
        ref, res = _resumed(monkeypatch, tmp_path / str(chunked),
                            lambda ck: T.fit_operator(
                                model, params, C.grid2d(H, W), meas, op,
                                dataclasses.replace(cfg, maxpoints=100),
                                gt_field=im, field_shape=(H, W),
                                checkpoint=ck, render_chunked=chunked,
                                device="cpu"), nth=1)
        _assert_same(ref, res)


def test_fit_frames_resume_is_bit_equal(monkeypatch, tmp_path):
    H = W = 16
    scale = 2
    nframes, bs = 6, 4
    rng = np.random.RandomState(3)
    fc = np.stack([C.grid2d(H, W)] * nframes).astype(np.float32)
    fp = rng.rand(nframes, (H // scale) * (W // scale), 3).astype(np.float32)
    fm = np.ones_like(fp)
    model = tget_inr("wire", out_features=3, **WIRE)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = T.FitConfig(learning_rate=5e-3, niters=9, lr_decay=1.0,
                      scan_segment=3)
    ref, res = _resumed(monkeypatch, tmp_path, lambda ck: T.fit_frames(
        model, params, fc, fp, fm, cfg, hr_shape=(H, W, 3), scale=scale,
        batch_size=bs, checkpoint=ck, device="cpu"))
    _assert_same(ref, res)


def test_a_finished_checkpoint_returns_its_fit(tmp_path):
    """Resuming a file written at the end takes no step and returns the
    saved state; resume=False starts afresh and overwrites it."""
    H = W = 12
    im = I.synthetic_image(H, W, 3, seed=1)
    model = tget_inr("wire", out_features=3, **WIRE)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = T.FitConfig(niters=3, maxpoints=50, scan_segment=2)
    ckpt = T.CheckpointSpec(path=str(tmp_path / "done.npz"))
    first = T.fit_pointwise(model, params, C.grid2d(H, W), im.reshape(-1, 3),
                            cfg, checkpoint=ckpt, device="cpu")
    calls = []
    step = model.step_grads
    model.step_grads = lambda *a, **k: calls.append(1) or step(*a, **k)
    again = T.fit_pointwise(model, params, C.grid2d(H, W), im.reshape(-1, 3),
                            cfg, checkpoint=ckpt, device="cpu")
    assert calls == []
    _assert_same(first, again)
    fresh = T.fit_pointwise(model, params, C.grid2d(H, W), im.reshape(-1, 3),
                            cfg, checkpoint=dataclasses.replace(
                                ckpt, resume=False), device="cpu")
    assert len(calls) == 3 * 3
    _assert_same(first, fresh)


def test_checkpoint_refuses_foreign_fit_state(tmp_path):
    im = I.synthetic_image(16, 16, 3, seed=0)
    coords = C.grid2d(16, 16)
    model = tget_inr("wire", out_features=3, **WIRE)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = T.FitConfig(learning_rate=5e-3, niters=4, scan_segment=2,
                      maxpoints=256)
    ckpt = T.CheckpointSpec(path=str(tmp_path / "fit.npz"))
    T.fit_pointwise(model, params, coords, im.reshape(-1, 3), cfg,
                    track="noisy", checkpoint=ckpt, device="cpu")
    other = I.synthetic_image(16, 16, 3, seed=1)
    with pytest.raises(ValueError, match="DIFFERENT fit"):
        T.fit_pointwise(model, params, coords, other.reshape(-1, 3), cfg,
                        track="noisy", checkpoint=ckpt, device="cpu")
    with pytest.raises(ValueError, match="DIFFERENT fit"):
        T.fit_pointwise(model, params, coords, im.reshape(-1, 3),
                        dataclasses.replace(cfg, learning_rate=1e-3),
                        track="noisy", checkpoint=ckpt, device="cpu")
    with pytest.raises(ValueError, match="DIFFERENT fit"):
        T.fit_pointwise(tget_inr("wire", out_features=3,
                                 **dict(WIRE, scale=5.0)), params, coords,
                        im.reshape(-1, 3), cfg, track="noisy",
                        checkpoint=ckpt, device="cpu")
    # a file of another trainer is refused too
    with pytest.raises(ValueError, match="DIFFERENT fit"):
        T.fit_frames(model, params, coords[None], im.reshape(1, -1, 3),
                     np.ones((1, 256, 3), np.float32), cfg,
                     hr_shape=(16, 16, 3), scale=1, checkpoint=ckpt,
                     device="cpu")
    # scan_segment only places the saves: the same fit resumes
    res = T.fit_pointwise(model, params, coords, im.reshape(-1, 3),
                          dataclasses.replace(cfg, scan_segment=1),
                          track="noisy", checkpoint=ckpt, device="cpu")
    assert res.mse_noisy.shape == (4,)


def test_fingerprint_distinguishes_partials_and_closures():
    def metric(rec, target, thres=0.5):
        return (rec > thres).mean()

    cfg = T.FitConfig(niters=3)
    base = T._fit_fingerprint(cfg, "modelspec", partial(metric, thres=0.4))
    assert base == T._fit_fingerprint(cfg, "modelspec",
                                      partial(metric, thres=0.4))
    assert base != T._fit_fingerprint(cfg, "modelspec",
                                      partial(metric, thres=0.5))
    assert base != T._fit_fingerprint(cfg, "modelspec", metric)

    def make_closure(t):
        def m(rec, target):
            return (rec > t).mean()
        return m

    c4 = T._fit_fingerprint(cfg, "modelspec", make_closure(0.4))
    assert c4 == T._fit_fingerprint(cfg, "modelspec", make_closure(0.4))
    assert c4 != T._fit_fingerprint(cfg, "modelspec", make_closure(0.5))
    # tensors by content, numpy arrays and tensors alike; scan_segment out
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert T._fit_fingerprint(cfg, "m", a) == T._fit_fingerprint(
        dataclasses.replace(cfg, scan_segment=7), "m", torch.from_numpy(a))
    assert T._fit_fingerprint(cfg, "m", a) != T._fit_fingerprint(
        cfg, "m", a[::-1].copy())
    assert T._fit_fingerprint(cfg, "m", C.GridSpec(4, 4)) != \
        T._fit_fingerprint(cfg, "m", C.GridSpec(4, 5))


def test_fingerprint_of_an_operator_ignores_its_caches():
    from wire_tpu_torch.operators.radon import RadonOp
    from wire_tpu_torch.operators.forward import DownsampleOp
    cfg = T.FitConfig(niters=3)
    op = RadonOp(np.linspace(0, 180, 5), method="rotate")
    before = T._fit_fingerprint(cfg, "m", op)
    op._rotsum_parts[("cached", 1)] = torch.zeros(3)
    assert T._fit_fingerprint(cfg, "m", op) == before
    assert T._fit_fingerprint(cfg, "m", RadonOp(np.linspace(
        0, 180, 6), method="rotate")) != before
    assert T._fit_fingerprint(cfg, "m", DownsampleOp(2)) != \
        T._fit_fingerprint(cfg, "m", DownsampleOp(4))


def test_render_chunked_matches_the_whole_grid_render():
    """wire_tpu's tests/test_trainer.py case: a 20 x 20 field in chunks of
    128 (four, the last padded with 112 zero rows)."""
    H = W = 20
    im = I.synthetic_image(H, W, 1, seed=4)[..., 0]

    def op(field):
        return avg_pool2d(field[None, None], 4)[0, 0]

    meas = op(torch.from_numpy(im)).numpy()
    model = tget_inr("wire", out_features=1, **WIRE)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = T.FitConfig(learning_rate=5e-3, niters=10, maxpoints=128)
    ref = T.fit_operator(model, params, C.grid2d(H, W), meas, op, cfg,
                         gt_field=im, field_shape=(H, W), device="cpu")
    calls = []
    apply = model.apply
    model.apply = lambda p, c: calls.append(c.shape[0]) or apply(p, c)
    res = T.fit_operator(model, params, C.grid2d(H, W), meas, op, cfg,
                         gt_field=im, field_shape=(H, W), device="cpu",
                         render_chunked=True)
    np.testing.assert_allclose(res.mse_noisy, ref.mse_noisy, rtol=1e-5)
    np.testing.assert_allclose(res.mse_gt, ref.mse_gt, rtol=1e-5)
    np.testing.assert_allclose(res.best_rec, ref.best_rec, atol=1e-5)
    # four chunks forward, and each recomputed once in the backward
    assert calls == [128] * 8 * 10
    # maxpoints over the grid: one whole render, no checkpoint
    calls.clear()
    T.fit_operator(model, params, C.grid2d(H, W), meas, op,
                   dataclasses.replace(cfg, niters=1, maxpoints=400),
                   gt_field=im, field_shape=(H, W), device="cpu",
                   render_chunked=True)
    assert calls == [400]


def test_wire_tpu_parameter_files_load_in_the_port(tmp_path):
    for nonlin, kw in (("wire", dict(WIRE, out_features=3)),
                       ("bspline_mscale_hier", dict(
                           in_features=2, hidden_features=16,
                           hidden_layers=2, out_features=1,
                           first_omega0=-0.2, hidden_omega0=-0.2, scale=2.0,
                           scale_tensor=(1.0, 4.0)))):
        jparams = get_inr(nonlin, **kw).init(jax.random.key(0))
        JA.save_params(str(tmp_path / f"{nonlin}_j.npz"), jparams)
        like = tget_inr(nonlin, **kw).init(torch.Generator().manual_seed(1))
        got = A.load_params(str(tmp_path / f"{nonlin}_j.npz"), like)
        _equal_trees(got, bridge.params_from_jax(
            jax.tree.map(np.asarray, jparams)))
        A.save_params(str(tmp_path / f"{nonlin}_t.npz"), got)
        back = JA.load_params(str(tmp_path / f"{nonlin}_t.npz"), jparams)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        with np.load(str(tmp_path / f"{nonlin}_j.npz")) as zj, \
                np.load(str(tmp_path / f"{nonlin}_t.npz")) as zt:
            assert sorted(zj.files) == sorted(zt.files)


def test_seed_everything_seeds_every_stream():
    g = S.seed_everything(5)
    a = (np.random.rand(), torch.rand(2), torch.rand(2, generator=g))
    g = S.seed_everything(5)
    b = (np.random.rand(), torch.rand(2), torch.rand(2, generator=g))
    assert a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2],
                                                                    b[2])
    assert isinstance(g, torch.Generator) and g.initial_seed() == 5
    assert os.environ["PYTHONHASHSEED"] == "5"


def test_profile_fit_traces_and_counts(tmp_path):
    """A fit under ``trace``: the TensorBoard trace and ``spans.json``
    beside it, with the fit's spans (each epoch's hot ones too, as the
    profiler records) and the counters."""
    im = I.synthetic_image(8, 8, 3, seed=0)
    model = tget_inr("wire", out_features=3, **WIRE)
    params = model.init(torch.Generator().manual_seed(0))
    P.clear()
    with P.trace(str(tmp_path / "tr")) as prof:
        res = T.fit_pointwise(model, params, C.grid2d(8, 8),
                              im.reshape(-1, 3), T.FitConfig(niters=2),
                              device="cpu")
    assert res.mse_gt.shape == (2,)
    assert prof.key_averages() is not None
    files = os.listdir(str(tmp_path / "tr"))
    assert any(".pt.trace" in f for f in files) and "spans.json" in files
    with open(tmp_path / "tr" / "spans.json") as f:
        out = json.load(f)
    names = [s["name"] for s in out["spans"]]
    for name in ("trainer.epoch", "trainer.adam", "trainer.tracking"):
        assert names.count(name) == 2, (name, names)
    assert names[-1] == "trainer.fit" and "trainer.setup" in names
    assert out["counters"]["launches.wire_step.step"] >= 0
    P.clear()


def test_occupancy_app_resumes_its_checkpoint(monkeypatch, tmp_path):
    """The app's checkpoint_path and checkpoint_every (saves every second
    segment of 2 epochs): stopped after the second save (epoch 8) and
    resumed, the app's fit equals the uninterrupted one."""
    kw = dict(size=8, niters=10, maxpoints=300, scan_segment=2,
              hidden_features=16, device="cpu")
    ref = TO.run(results_dir=str(tmp_path / "a"), **kw)
    path = str(tmp_path / "occ.npz")
    restore = _stop_after(monkeypatch, 2)
    with pytest.raises(Stop):
        TO.run(results_dir=str(tmp_path / "b"), checkpoint_path=path,
               checkpoint_every=2, **kw)
    restore()
    with np.load(path) as z:
        assert int(z["done"]) == 8
    res = TO.run(results_dir=str(tmp_path / "b"), checkpoint_path=path,
                 checkpoint_every=2, **kw)
    _assert_same(ref["result"], res["result"])
    assert (res["iou"], res["psnr"]) == (ref["iou"], ref["psnr"])
