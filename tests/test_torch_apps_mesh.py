"""``--mesh 1`` in the port's five apps on the CPU: denoise, CT, SISR,
occupancy and multi-SR, each run unsharded and on a world of one
(``wire_tpu_torch.dist``: one Gloo rank in this process), write the same
artifacts with equal metrics.  A world of one runs the same steps on the
same rows as the single-device fit, so the comparison is bit for bit; the
only exceptions are the wall-time entries, and occupancy's IoU history,
which the sharded app forms in float64 from the summed counts (as
wire_tpu's app does) and which equals the unsharded app's float32 IoU once
rounded to float32.  Tiny sizes: WIRE 32 wide where the app lets the
preset set the width, 2-10 iterations."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from scipy import io

from wire_tpu_torch.apps import common as TCm
from wire_tpu_torch.apps import ct as TCT
from wire_tpu_torch.apps import denoise as TD
from wire_tpu_torch.apps import multi_sr as TMS
from wire_tpu_torch.apps import occupancy as TO
from wire_tpu_torch.apps import sisr as TS
from wire_tpu_torch.signals import image as I
from wire_tpu_torch.train import presets

WALL = ("time_array", "Total time")


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


@pytest.fixture(scope="module")
def mesh():
    """``--mesh 1`` as the apps' main builds it: a world of one."""
    made = not dist.is_initialized()
    m = TCm.mesh_from_arg(1, "cpu")
    assert m.size == 1 and m.rank == 0 and m.backend == "gloo"
    yield m
    if made:
        dist.destroy_process_group()


@pytest.fixture
def tiny_presets():
    presets.ENTRIES["testmeshwire"] = dict(
        nonlin="wire", scale=8.0, scale_tensor=(0.0,),
        scaled_hidden_features=0, learning_rate=5e-3, hidden_features=32,
        niters=10, omega0=7.0)
    presets.ENTRIES["testmeshct"] = dict(
        presets.ENTRIES["WIRE_s12_o8_LR5e3_E2000"], niters=3)
    presets.ENTRIES["testmeshsisr"] = dict(
        presets.ENTRIES["Bspline_s9_LR1e3_E2000"], niters=4)
    yield
    for k in ("testmeshwire", "testmeshct", "testmeshsisr"):
        presets.ENTRIES.pop(k, None)


def _mat(path):
    z = io.loadmat(path)
    return {k: v for k, v in z.items() if not k.startswith("__")}


def _same_mat(a, b, skip=WALL):
    za, zb = _mat(a), _mat(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        if k in skip:
            continue
        va, vb = za[k], zb[k]
        if va.dtype.names:          # the run folder's struct
            assert sorted(va.dtype.names) == sorted(vb.dtype.names)
            for f in va.dtype.names:
                if f not in skip:
                    np.testing.assert_array_equal(va[f][0, 0], vb[f][0, 0],
                                                  err_msg=f"{k}.{f}")
        else:
            np.testing.assert_array_equal(va, vb, err_msg=k)


def _same_run_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in ("info.mat", "metrics.mat"):
        _same_mat(os.path.join(a, f), os.path.join(b, f))


def _same_fit(a, b):
    for k in ("mse_gt", "mse_noisy", "best_rec", "final_rec"):
        if getattr(a, k) is not None:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)
    assert a.best_mse == b.best_mse


def _image(tmp_path, size, channels=3):
    path = str(tmp_path / "img.npy")
    np.save(path, I.natural_image(size, size, channels, seed=0))
    return path


@pytest.mark.parametrize("app", ["denoise", "ct", "sisr"])
def test_image_apps_at_mesh_1_write_the_unsharded_artifacts(
        mesh, tiny_presets, tmp_path, app):
    mod, name, size, kw = {
        "denoise": (TD, "testmeshwire", 64, {}),
        "ct": (TCT, "testmeshct", 64, dict(radon_method="fourier")),
        "sisr": (TS, "testmeshsisr", 96, {})}[app]
    img = _image(tmp_path, size)
    one = mod.run(name, image=img, results_dir=str(tmp_path / "one"),
                  device="cpu", **kw)
    sharded = mod.run(name, image=img, results_dir=str(tmp_path / "mesh"),
                      mesh=mesh, **kw)
    _same_fit(sharded["result"], one["result"])
    for k, v in one.items():
        if isinstance(v, float):
            assert sharded[k] == v, k
    _same_run_dirs(sharded["path"], one["path"])


def test_denoise_main_takes_mesh_1(mesh, tiny_presets, tmp_path):
    img = _image(tmp_path, 64)
    TD.main(["--config_name", "testmeshwire", "--image", img,
             "--results_dir", str(tmp_path / "cli"), "--device", "cpu",
             "--mesh", "1"])
    runs = os.listdir(tmp_path / "cli" / "denoise" / "T30.0_SNR2")
    assert len(runs) == 1
    assert os.path.exists(tmp_path / "cli" / "denoise" / "T30.0_SNR2"
                          / runs[0] / "metrics_table.md")


@pytest.mark.parametrize("maxpoints", [int(2e5), 1000])
def test_occupancy_at_mesh_1_writes_the_unsharded_artifacts(
        mesh, tmp_path, maxpoints):
    """Full batch (4,096 points), and five chunks of 1,000 (904 sentinel
    rows in the last): the fed rows, the generator's epochs, IoU from the
    summed counts."""
    kw = dict(size=16, niters=3, maxpoints=maxpoints, hidden_features=32)
    one = TO.run(results_dir=str(tmp_path / "one"), device="cpu", **kw)
    sharded = TO.run(results_dir=str(tmp_path / "mesh"), mesh=mesh, **kw)
    _same_fit(sharded["result"], one["result"])
    assert sharded["iou"] == one["iou"] and sharded["psnr"] == one["psnr"]
    assert sharded["iou_array"].dtype == np.float64
    np.testing.assert_array_equal(np.float32(sharded["iou_array"]),
                                  one["iou_array"])
    a = os.path.join(str(tmp_path / "mesh"), "occupancy")
    b = os.path.join(str(tmp_path / "one"), "occupancy")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == ["wire.dae",
                                                              "wire.mat"]
    _same_mat(os.path.join(a, "wire.mat"), os.path.join(b, "wire.mat"),
              skip=WALL + ("iou_array",))
    with open(os.path.join(a, "wire.dae"), "rb") as fa, \
            open(os.path.join(b, "wire.dae"), "rb") as fb:
        assert fa.read() == fb.read()


def test_multi_sr_at_mesh_1_writes_the_unsharded_artifacts(mesh, tmp_path):
    """4 frames at x4, one batch of 4 a step."""
    kw = dict(size=64, scale_sr=4, niters=2, hidden_features=16)
    one = TMS.run("wire", results_dir=str(tmp_path / "one"), device="cpu",
                  **kw)
    sharded = TMS.run("wire", results_dir=str(tmp_path / "mesh"), mesh=mesh,
                      **kw)
    _same_fit(sharded["result"], one["result"])
    for k in ("psnr", "ssim", "psnr_interp"):
        assert sharded[k] == one[k], k
    assert os.path.basename(sharded["mat"]) == "4x_4images_wire_oracle_reg.mat"
    _same_mat(sharded["mat"], one["mat"])
