#!/usr/bin/env python3
"""cv2's answers on chip_smoke.py's motion pairs, which the smoke's
volume_motion phase holds the port's cv2-free ECC and Farneback to on a
machine without cv2: writes tools/port_motion_reference.json.

    python3 tools/port_motion_reference.py

Needs cv2, which the port itself does not use.
The pairs are chip_smoke.motion_scene's MOTION_SIDE^2 frames moved by
MOTION_EUCLIDEAN and MOTION_HOMOGRAPHY.  The file holds:

  ecc                 {"euclidean": 2 x 3, "homography": 3 x 3}: the warp
                      cv2.findTransformECC returns from the identity with
                      (EPS | COUNT, MOTION_ECC_ITERS, -1) and a 5-tap
                      Gaussian pre-filter, as wire_tpu's ecc_flow calls it
  farneback_lattice   cv2.calcOpticalFlowFarneback's flow on the euclidean
                      pair (wire_tpu's optical_flow: the frames scaled to
                      bytes by their joint max; 0.5, 3, 15, 3, 5, 1.2, 0)
                      at chip_smoke.flow_lattice's pixels
  cv2                 cv2.__version__
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import cv2  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as S  # noqa: E402


def reference():
    warps = S.motion_warps(np)
    modes = {"euclidean": cv2.MOTION_EUCLIDEAN,
             "homography": cv2.MOTION_HOMOGRAPHY}
    out = {"cv2": cv2.__version__, "ecc": {}}
    for motion, warp in warps.items():
        im1, im2 = S.motion_scene(np, S.MOTION_SIDE, warp)
        init = (np.eye(3, dtype=np.float32) if motion == "homography"
                else np.eye(2, 3, dtype=np.float32))
        criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                    S.MOTION_ECC_ITERS, -1)
        _, w = cv2.findTransformECC(im1, im2, init, modes[motion],
                                    criteria=criteria, inputMask=None,
                                    gaussFiltSize=5)
        out["ecc"][motion] = w.astype(float).tolist()
    im1, im2 = S.motion_scene(np, S.MOTION_SIDE, warps["euclidean"])
    scale = max(im1.max(), im2.max(), 1e-8)
    f1 = np.clip(im1 / scale * 255, 0, 255).astype(np.uint8)
    f2 = np.clip(im2 / scale * 255, 0, 255).astype(np.uint8)
    flow = cv2.calcOpticalFlowFarneback(f1, f2, None, 0.5, 3, 15, 3, 5, 1.2,
                                        0)
    rows, cols = S.flow_lattice(S.MOTION_SIDE)
    out["farneback_lattice"] = flow[rows, cols].astype(float).tolist()
    return out


def main():
    path = os.path.join(ROOT, S.MOTION_REFERENCE)
    with open(path, "w") as f:
        json.dump(reference(), f)
        f.write("\n")
    print(path)


if __name__ == "__main__":
    main()
