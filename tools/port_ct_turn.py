#!/usr/bin/env python3
"""One turn of the CT timings of one tree, on one GPU (run by
``tools/port_parent_times.py --ct``; a process per turn, since two trees'
line_sample wrappers differ).

    python3 tools/port_ct_turn.py ROOT

ROOT is the tree whose wire_tpu_torch and chip_smoke.py are imported; its
libraries are built into ROOT/wire_tpu_torch/_build.  Prints one JSON line:

- ``row4_ms``: chip_smoke.py's row-4 call (the line_sample pair's forward
  and backward through autograd at the CT shape, P 1,024, 100 angles, K
  513; CUDA events over 20 calls after 2 warm-up calls) and
  ``row4_kernel_ms``, its kernels' device time (torch.profiler);
- ``fourier_operator_ms``: the vjp of radon(img, angles,
  method="fourier") at a 256^2 image and 100 angles, timed the same way,
  and ``fourier_operator_launches``, its device launches per call
  (kernels and memsets, torch.profiler);
- ``ct_auto_ms_per_iter`` and ``ct_auto_psnr_db``: the CT fit with
  method 'auto' (fourier) through the kernels, as chip_smoke.py's fit_ct
  runs it (WIRE_s12_o8_LR5e3_E2000, the seed-0 init, 300 iterations;
  fit_operator's step_ms, the first step left out);
- ``wire2d_ct_ms_per_iter`` and ``wire2d_ct_psnr_db``: the WIRE-2D CT fit
  as chip_smoke.py's fit_wire2d_ct runs it (300 iterations).
"""
import json
import os
import sys


def main():
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as S
    from wire_tpu_torch.apps import ct as TCT
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.operators import radon as TR
    from wire_tpu_torch.ops import build
    from wire_tpu_torch.ops import line_sample as LS
    from wire_tpu_torch.ops import rotsum as R
    from wire_tpu_torch.ops import wire_mlp as WM
    from wire_tpu_torch.train import metrics as M
    from wire_tpu_torch.train.presets import get_config
    from wire_tpu_torch.train.trainer import FitConfig, fit_operator

    if not torch.cuda.is_available():
        raise SystemExit("port_ct_turn.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all(("wire_mlp", "wire2d", "line_sample"))
    cfg = get_config(S.CT_CONFIG)
    model, _ = S.ct_models(get_inr, TCT, cfg)
    out = {"root": root}

    cases, _, _ = S.ct_kernel_cases(torch, WM, R, LS, model, 256 * 256, 256,
                                    100, 1024, 513, seed=4, device=dev)
    kfn, _, _, xs, cot = cases["line_sample"]

    def row4():
        return S.vjp(torch, kfn, xs, cot)
    out["row4_ms"] = S.cuda_ms(torch, row4, 20)
    out["row4_kernel_ms"] = S.kernel_device_ms(
        torch, row4, 20, S.kernel_names("line_sample"))

    rng = np.random.default_rng(5)
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    img, icot = (torch.tensor(a.astype(np.float32), device=dev) for a in (
        rng.random((256, 256)), rng.normal(size=(100, 256))))

    def operator():
        return S.vjp(torch, lambda x: TR.radon(x, thetas, method="fourier"),
                     [img], icot)
    out["fourier_operator_ms"] = S.cuda_ms(torch, operator, 20)
    by = S.kernel_breakdown(torch, operator, 20)
    out["fourier_operator_launches"] = sum(v[1] for v in by.values())

    ct = TCT.ct_image(None, 0)
    H, W = ct.shape
    grid = TCT.C.grid2d(H, W)
    sino = TCT.make_sinogram(ct, thetas, radon_method="auto", device=dev)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=S.CT_ITERS,
                        maxpoints=cfg.maxpoints)
    kw = dict(S.WIRE2D_DENOISE_KW, out_features=1)
    kw.update(S.wire2d_ct_kw(get_config))
    for name, net in (("ct_auto", model), ("wire2d_ct", get_inr("wire2d",
                                                                 **kw))):
        params = net.init(torch.Generator().manual_seed(0), dev)
        res = fit_operator(net, params, grid, sino,
                           TR.RadonOp(thetas, method="auto"), fit_cfg,
                           gt_field=ct, field_shape=(H, W), device=dev)
        out[f"{name}_ms_per_iter"] = res.step_ms
        out[f"{name}_psnr_db"] = float(M.psnr_ref(ct, res.best_rec))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
