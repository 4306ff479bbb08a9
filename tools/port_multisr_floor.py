#!/usr/bin/env python
"""PSNR floors of chip_smoke.py's multi-frame SR fits, from the JAX
reference.

Runs wire_tpu on the CPU (fused="never", float32, ``signals.motion.cv2``
set to None so the burst, the downsample and the registration take the
numpy/scipy/native branches the port ports) through the multi-SR app's
defaults (wire_tpu/apps/multi_sr.py:run): the 192^2 synthetic image, x4,
4 frames shifted by up to 20 px and rotated by up to pi/10 from
np.random.RandomState(0), WIRE 256 wide (181 complex units), 2 hidden
layers, omega0 10, sigma 5, lr 5e-3 without decay, batches of 4 frames;
from the PyTorch port's seed-0 init (``torch.Generator().manual_seed(0)``)
moved across with wire_tpu_torch.bridge.  For each registration, oracle
(the burst's own warps) and estimated (register_burst), it prints one JSON
line: the best PSNR of the full-grid render of the best parameters vs the
HR image, the interpolation baseline's PSNR, and for the estimated warps
their translation (px) and angle (rad) errors against the known motion.
chip_smoke.py holds the port's kernel fits to these PSNRs less 0.2 dB.

    python tools/port_multisr_floor.py [ITERS] [oracle|estim ...]  # 300
"""
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from wire_tpu.apps import multi_sr as JMS  # noqa: E402
from wire_tpu.nn import get_inr  # noqa: E402
from wire_tpu.signals import coords as JC, image as JI  # noqa: E402
from wire_tpu.signals import motion as JMo  # noqa: E402
from wire_tpu.train import metrics as JM  # noqa: E402
from wire_tpu.train.trainer import FitConfig, fit_frames  # noqa: E402
from wire_tpu_torch.apps.multi_sr import registration_errors  # noqa: E402
from wire_tpu_torch.bridge import params_to_numpy  # noqa: E402
from wire_tpu_torch.nn.registry import get_inr as tget_inr  # noqa: E402

SIZE, SCALE, SEED = 192, 4, 0
KW = dict(in_features=2, out_features=3, hidden_features=256,
          hidden_layers=2, first_omega0=10.0, hidden_omega0=10.0, scale=5.0)


def run(iters, tag):
    JMo.cv2 = None
    rng = np.random.RandomState(SEED)
    im = JI.synthetic_image(SIZE, SIZE, 3, seed=SEED)
    H, W, _ = im.shape
    nimg = int(0.25 * SCALE * SCALE)
    imstack_hr, Xgt, Ygt, mats = JMo.make_burst(
        im, shift_max=5 * SCALE, theta_max=np.pi / 10, nframes=nimg, rng=rng)
    imstack = JMo.downsample_burst(imstack_hr, SCALE)
    out = {"registration": tag, "iters": iters}
    t0 = time.time()
    if tag == "oracle":
        Xs, Ys = Xgt, Ygt
    else:
        Xs, Ys, ok, est = JMo.register_burst(imstack, (H, W))
        out.update(registration_errors(est, mats))
        out["registered"] = ok.tolist()
    out["registration_s"] = time.time() - t0
    masks = 1.0 - np.float32(imstack == 0)
    ds = JMo.FrameDataset.build(imstack, Xs, Ys, masks)
    im_interp = JMS.interp_baseline(im, imstack, Xs, Ys, SCALE)
    out["psnr_interp_db"] = float(JM.psnr_ref(im, im_interp))
    model = get_inr("wire", fused="never", **KW)
    init = tget_inr("wire", **KW).init(torch.Generator().manual_seed(SEED))
    params = jax.tree.map(jnp.asarray, params_to_numpy(init))
    cfg = FitConfig(learning_rate=5e-3, niters=iters, lr_decay=1.0,
                    seed=SEED)
    t0 = time.time()
    res = fit_frames(model, params, ds.coords, ds.pixels, ds.masks, cfg,
                     hr_shape=(H, W, 3), scale=SCALE, batch_size=4,
                     donate=False)
    out["fit_s"] = time.time() - t0
    rec = np.asarray(model.apply(res.best_params,
                                 jnp.asarray(JC.grid2d(H, W)))).reshape(
        H, W, 3)
    out["psnr_db"] = float(JM.psnr_ref(im, rec))
    out["best_loss"] = res.best_mse
    out["max_rss_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    return out


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    tags = sys.argv[2:] or ["oracle", "estim"]
    for tag in tags:
        print(json.dumps(run(iters, tag)), flush=True)


if __name__ == "__main__":
    main()
