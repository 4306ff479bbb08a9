#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wire_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # 300-epoch / 300-iteration fits,
                                       # floors from wire_tpu on the CPU
    python3 chip_smoke.py --epochs 2000   # the full denoise bench protocol,
                                          # 25 dB floor

It drives nine paths of the port: WIRE-300 denoise through fit_pointwise
(kernel: wire_step), WIRE-300 CT reconstruction through fit_operator
(kernels: wire_mlp, and line_sample for the 'auto' = fourier method or
rotsum for 'rotate'), B-spline denoise through fit_pointwise (preset
Bspline_s9_5_LR8e3_E4000; kernel: real_step), B-spline SISR through
fit_operator (preset Bspline_s9_LR1e3_E2000; kernel: real_mlp's pair),
mscale_2 denoise through fit_pointwise (preset Mscale2_ST8_3_LR8e3_E4000;
kernel: mscale2_step), the sweep app's MFN denoise (kernel: mfn_step)
and MFN SISR (kernel: mfn_mlp's pair), and WIRE-2D (300 wide) denoise
through fit_pointwise (kernel: wire2d_step) and CT through fit_operator
(kernels: wire2d_mlp's pair, line_sample); then the sweep app itself
(wire_tpu_torch.apps.sweep), every task for each of its six families;
then the occupancy app (wire_tpu_torch.apps.occupancy: a 64^3 volume,
WIRE 300 wide at d = 3 with 3 hidden layers, two 200,000-row chunks an
epoch through fit_pointwise's permuted epochs; kernel: wire_step) and
the volume probe (export_mesh_from_model through wire_mlp's forward,
blockwise probing, refill) and the motion functions that wire_tpu runs
through cv2 (prune_stack on the card, ECC and Farneback on the host);
denoise fits of the registry's newest families (bspline_mscale_1, _1_new
and _repIN through real_step; realgabor and bspline_sig by autodiff, no
kernel); then the multi-frame SR app (wire_tpu_torch.apps.multi_sr: a
192^2 image, x4, 4 frames, WIRE 256 wide = 181 complex units through
fit_frames on (4, 36,864, 2) frame grids; kernel: wire_mlp's pair; five
more families through their pairs) and the fit state (three fits
stopped after their second checkpoint and resumed, the chunked render);
then the coordinate-parallel fits of wire_tpu_torch.dist (a world of one
over NCCL, and two ranks sharing the card over Gloo); last the
total-variation fits (the denoise app on a PNG input with a TV preset,
B-spline with TV, a chunked TV fit; kernels: wire_mlp's and real_mlp's
pairs) and sinogram_op.
Phases, each printing one JSON line with its wall time:
  device           card name and count, nvidia-smi's name and power limit;
                   TF32 off for matmuls and cuDNN
  build            nvcc builds every kernel library from csrc/, all at once
  kernel_vs_plain  each kernel against its plain PyTorch version at its
                   path's full shape, plus a ragged case (line_sample
                   also at an odd P, 729); wire_step at
                   h 5, 13, 150, 212, L 1-3, o 1 and 3, n 700 and 65,537
                   with nvalid and denom; mscale2_step at ns 2 and 3 where
                   128-row tiles straddle two scales (n 700, 65,537), held
                   to its plain version run in float64; two
                   calls of each bit-equal; wire_mlp, real_mlp, mfn_mlp and
                   wire2d_mlp on a transposed coordinate view, equal to the
                   contiguous call bit for bit (fault C.7); real_mlp's
                   every basis kind, lane segments and row_gamma; real_step
                   at the mscale_hier and mscale_HL folds; each real case
                   held to the reference tools/port_real_reference.py
                   decided (REAL_FLOAT64_CASES), two calls of the real
                   step and pair bit-equal; wire_mlp
                   on (b, N, 2) coordinates and without a gradient (equal
                   output, peak memory of two ping-pong planes); rotsum on
                   a non-square image; mfn_mlp without dcoords, on (b, N, 2)
                   coordinates, without a gradient and at the extreme phase
                   |x w| ~ 8,000; two calls of each MFN kernel bit-equal;
                   then every kernel the sweep phase launches, for each
                   family and task at the sweep's own shapes (CT: 262,144
                   rows; mfn's CT pair with dcoords too); wire2d_step at
                   the denoise shape and ragged (L 1 and 3), wire2d_mlp at
                   the CT shape, with dcoords at the denoise shape, on
                   (4, 50, 2) coordinates and without a gradient; both
                   at h 5, 13, 150, 152, 256, L 0-3, o 1 and 3, n 700 and
                   65,537 (the step with nvalid and denom, the pair with
                   dcoords), and the pair at h 5, L 3 at the CT frequencies
                   held to its plain version run in float64; two calls of
                   each WIRE-2D kernel bit-equal; wire_step at the
                   occupancy chunks (n 200,000, d 3, h 212, L 3, o 1,
                   nvalid 200,000 and 62,144 over a sentinel tail) and a
                   ragged n 70,001; real_step at the mscale_1 fold (an
                   identity first layer 2 -> 512) and the repIN fold (K =
                   1,024), the real_mlp pair at the repIN fold; two calls
                   of each bit-equal; the multi-SR pairs (wire_mlp at h
                   181 on the app's (4, 36,864, 2) frame grids and on a
                   ragged (3, 4,097, 2) with dcoords, real_mlp at the
                   app's gauss and posenc, mfn_mlp at its mfn), two calls
                   of each bit-equal
  measure          kernel (as a host call, and its kernels' device time
                   from torch.profiler), plain and library times at those
                   shapes, and the card's least time for the same work;
                   for the tensor-core kernels (every one but rotsum
                   and line_sample) the kernel time by product
                   class, the 3xTF32 bound beside the fp32 one, and the
                   HMMA instructions of the library; real_step at the
                   sweep's siren cell, whose sine bases the epilogues call
                   out of line; the whole fourier operator's vjp at the CT
                   shape with its device launches in order (not gated)
  measure_slice    the same fields at the occupancy slice's new shapes:
                   wire_step at the occupancy chunk, real_step at the
                   mscale_1 and repIN folds, the real_mlp pair at the
                   repIN fold
  measure_multi_sr row 2 (the wire_mlp pair) at the multi-SR batch: host
                   and kernel ms, plain and library ms, the 3xTF32 and
                   fp32 bounds, time by product class; at 512^2 x 4
                   frames (1,048,576 rows) host and kernel ms
  fit              the denoise bench protocol (65,536 coordinates, full
                   batch) through fit_pointwise, once through the kernel
                   (launch counts reset just before, read just after) and
                   once through the plain path, from one init
  fit_ct           the CT protocol (256 x 256 field, 100 angles) through
                   fit_operator for each Radon method, 'auto' and 'rotate',
                   once through the kernels (counts reset just before, read
                   just after) and once through the plain path, from one
                   init
  fit_real         B-spline denoise (the 256 x 256 image, 65,536
                   coordinates, full batch) for 300 epochs, through the
                   kernel (counts reset just before, read just after), the
                   plain path (fused="never") and the kernel's plain
                   version in the same canonical fold, from one init
  fit_sisr         B-spline SISR (168 x 168 HR, x4 box downsample) for 300
                   iterations, likewise
  fit_mscale2      mscale_2 denoise (scales 1/9, 4, 8 on the 256 x 256
                   image, 65,536 coordinates, full batch) for 300 epochs,
                   through the kernel (counts reset just before, read just
                   after) and the plain path (fused="never"), from one init
  fit_mfn          the sweep's MFN denoise (300 wide, 256 x 256, 65,536
                   coordinates, full batch) for 300 epochs, likewise
  fit_mfn_sisr     the sweep's MFN SISR (256 wide, 256 x 256 HR, x4 box
                   downsample) for 300 iterations, likewise
  fit_wire2d       WIRE-2D denoise at the bench protocol (256 x 256, 65,536
                   coordinates, full batch, omega0 7, sigma 8) for 300
                   epochs, likewise
  fit_wire2d_ct    WIRE-2D CT at the CT protocol ('auto' = fourier, omega0
                   3, sigma 12) for 300 iterations, likewise, and a render
                   of the best parameters without a gradient
  sweep            sweep_denoise, sweep_sisr and sweep_ct at the sweep's
                   sizes, one family per call for 20 iterations: each
                   call launches its family's kernels and no other
  fit_occupancy    the occupancy app, 200 epochs, through the kernel
                   (wire_step twice an epoch and no other kernel; wire.mat
                   and the best reconstruction's wire.dae written; best
                   IoU and PSNR above wire_tpu's CPU fit less a margin)
                   and the plain path, from one init and one permutation
                   seed (training MSE at epoch 100 within 2%); a non-empty
                   mesh of the volume; then 20 epochs with block_perm 512
                   and per point; a profiled 10-epoch fit's device idle
                   share
  volume_motion    (a) export_mesh_from_model of the occupancy app's WIRE
                   at fit_occupancy's best parameters over 256^3 points in
                   batches of 262,144: exactly 64 wire_mlp forwards and
                   nothing else, within REL_TOL of the plain apply, a
                   non-empty .dae; wall time, the kernel's device ms per
                   million points and the idle share (profiled); (b)
                   block_query_coords at 128^3, depth 2, through one
                   forward and BlockPointCloud.unfold, within REL_TOL of
                   the grid3d probe; (c) BlockPointCloud.refill with a CUDA
                   generator; (d) prune_stack of the multi-SR burst on the
                   card equal to the CPU call; (e) ecc_flow (euclidean,
                   homography) and optical_flow on the host, held to cv2's
                   results (tools/port_motion_reference.json), host ms
  fit_families     256^2 denoise for 300 epochs of bspline_mscale_1,
                   _1_new and _repIN at MscaleHL_s1_ST2_SHF256's shape,
                   each through real_step (once an epoch) and the plain
                   path; realgabor and bspline_sig for 20 epochs, no
                   kernel launched
  fit_multi_sr     the multi-SR app at its defaults for 300 iterations
                   with the known motion through the kernels (one wire_mlp
                   forward and backward an iteration, one forward more for
                   the render, nothing else; the .mat written), through
                   the plain path from one init and frame order (within
                   0.05 dB), and with register_burst's motion (its warps'
                   errors); both at or above wire_tpu's CPU fits less 0.2
                   dB; siren, gauss, relu, posenc and mfn for 20
                   iterations, each through its own pair alone; a
                   profiled 20-iteration fit's device idle share
  fit_resume       the multi-SR fit (60 iterations, scan_segment 20), the
                   occupancy app (12 epochs, 4) and WIRE CT rotate (30
                   iterations, 10), each stopped just after its second
                   save and resumed: history, parameters and best
                   parameters bit-equal to the uninterrupted fit's; a
                   foreign checkpoint refused; WIRE CT rotate rendered in
                   4 chunks of 16,384 rows against the whole grid (loss
                   within 1e-5 relative, lower peak memory, each chunk's
                   forward twice and backward once an iteration)
  many_kernel_vs_plain  the replica axis (the batched multi-fit) of
                   wire_step, wire_mlp, rotsum, line_sample, real_step,
                   real_mlp, mfn_step, mfn_mlp, mscale2_step, wire2d_step
                   and wire2d_mlp at 3 replicas of distinct weights
                   (MANY_SHAPES, MANY_REAL_SHAPES, MANY_REST_SHAPES): one
                   launch per call for all replicas, two calls bit-equal,
                   each replica bit-equal to the unbatched kernel and
                   within REL_TOL of its reference (the wire2d_mlp
                   CT-width case's the float64 run, mscale2_step's the
                   float64 run on the kernel's own combiner relu pattern,
                   fault C.11); times against the 3 unbatched calls
  fit_many         WIRE's batched fits (denoise full and chunked, CT rotate
                   and auto, SISR, multi-SR on one burst and a burst each),
                   each replica bit-equal to its serial fit (CT auto within
                   MANY_FOURIER_REL), one launch sequence a step for all;
                   ``sweep --seeds 2`` of WIRE's three tasks
  fit_many_real    the batched fits of the real families and the MFN
                   (B-spline denoise, siren chunked, the repIN fold,
                   B-spline SISR, MFN denoise and SISR, gauss multi-SR),
                   each replica bit-equal to its serial fit; ``sweep
                   --seeds 2`` of siren, gauss, relu, posenc and mfn
  fit_many_rest    the batched fits of WIRE-2D (denoise at 300 wide, one
                   wire2d_step an epoch; CT 'auto', one wire2d_mlp pair an
                   iteration) and mscale_2 denoise (one mscale2_step an
                   epoch), each replica bit-equal to its serial fit (CT
                   'auto' within MANY_FOURIER_REL); the autodiff families'
                   (realgabor, bspline_sig, mscale_2 at 'both', bspline_knots
                   SISR through apply_many) within PSNR_AGREE_DB of theirs
                   (histories' distance reported); ``sweep --seeds 2`` of
                   wire2d and realgabor; one
                   autodiff step's PyTorch operations at 2 and 4 replicas
                   equal, its device kernels reported
  fit_sharded      wire_tpu_torch.dist: (a) a world of one over NCCL in
                   this process: WIRE-300 denoise for 50 epochs through
                   fit_pointwise_sharded, full batch and exact mode
                   (global_perm) in 4 chunks of 16,384, CT 'auto' through
                   fit_operator(mesh=...) and the multi-SR app's fit
                   through fit_frames_sharded for 20 iterations, each bit-
                   equal to the unsharded fit from the same init (CT within
                   MANY_FOURIER_REL), one wire_step a chunk or one wire_mlp
                   pair (CT: and one line_sample pair) an iteration and
                   nothing else; the occupancy app at --mesh 1 (10 epochs,
                   fed rows, IoU from summed counts) equal to the unsharded
                   app; ms per step beside the unsharded fits'; the
                   all-reduce's share of a step (torch.profiler).  (b) two
                   ranks on this card over Gloo (two spawned processes):
                   the four fits (SHARDED_B_ITERS: 20 epochs or iterations,
                   the multi-SR fit 4), histories within SHARDED_REL of the
                   unsharded fits' and best PSNR within PSNR_AGREE_DB, the
                   ranks' histories equal, each rank's launches counted;
                   the flat all-reduce of
                   WIRE-300's gradients timed alone
  fit_tv           total-variation fits through the apply/VJP pairs (no
                   step kernel takes the TV term): (a) the denoise app on
                   a TV preset (WIRE-300, 300 epochs, full batch, lambda_tv
                   TV_LAMBDA) reading the procedural image as a PNG the
                   port wrote, one wire_mlp forward and backward an epoch
                   and no wire_step, best PSNR at or above wire_tpu's CPU
                   fit less 0.2 dB (tools/port_tv_floor.py) and within
                   0.05 dB of the plain fit, its Output_img.png read back
                   equal to the best reconstruction in 8 bits; (b)
                   B-spline denoise with TV for 50 epochs through the
                   real_mlp pair alone; (c) WIRE-300 with TV in two chunks
                   of 32,768 for 20 epochs, per chunk the chunk's forward,
                   the full render's forward and their two backwards; (d)
                   sinogram_op at the CT protocol's shape bit-equal to
                   radon, one line_sample gather ('auto') or rotsum
                   forward ('rotate') a call
Then the nvidia-smi line, a ``kernels`` JSON line, and last, on success only,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit);
without a CUDA device it exits non-zero before any phase.  It imports
nothing of JAX or wire_tpu.
"""
import argparse
import dataclasses
import faulthandler
import json
import numbers
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Best PSNR of the 300-epoch fit from wire_tpu on the CPU (fused="never",
# float32, the bench protocol, this script's seed-0 init moved across with
# wire_tpu_torch.bridge), as printed by tools/port_smoke_floor.py; the kernel
# fit must reach it less 0.2 dB.  2000 epochs is the bench's own 25 dB floor.
WIRE_TPU_300_EPOCH_PSNR_DB = 26.159610748291016
PSNR_FLOORS_DB = {300: WIRE_TPU_300_EPOCH_PSNR_DB - 0.2, 2000: 25.0}
PSNR_AGREE_DB = 0.05

# Best PSNR of the 300-iteration CT fits from wire_tpu on the CPU
# (fit_operator, fused="never", float32, the CT protocol, this script's
# seed-0 init moved across), as printed by tools/port_ct_floor.py, by Radon
# method ('auto' is 'fourier' on the card); the kernel fits must reach them
# less 0.2 dB, and agree with the plain fits within PSNR_AGREE_DB.
WIRE_TPU_300_ITER_CT_PSNR_DB = {"auto": 28.474111557006836,
                                "rotate": 28.00259780883789}
CT_ITERS = 300
CT_CONFIG = "WIRE_s12_o8_LR5e3_E2000"

# Best PSNR of the 300-epoch B-spline denoise fit and best -10 log10(MSE)
# of the 300-iteration B-spline SISR fit from wire_tpu on the CPU
# (fused="never", float32, this script's seed-0 init moved across), as
# printed by tools/port_real_floor.py; the kernel fits must reach them less
# 0.2 dB, and agree with the plain fits within PSNR_AGREE_DB.
WIRE_TPU_300_REAL_DB = {"denoise": 27.099899291992188,
                        "sisr": 27.504344125842053}
REAL_ITERS = 300
REAL_DENOISE_CONFIG = "Bspline_s9_5_LR8e3_E4000"
REAL_SISR_CONFIG = "Bspline_s9_LR1e3_E2000"

# Best PSNR of the 300-epoch mscale_2 denoise fit from wire_tpu on the CPU
# (fused="never", float32, this script's seed-0 init moved across), as
# printed by tools/port_mscale_floor.py; the kernel fit must reach it less
# 0.2 dB, and agree with the plain fit within PSNR_AGREE_DB.
WIRE_TPU_300_MSCALE2_DB = 26.10752296447754
MSCALE2_CONFIG = "Mscale2_ST8_3_LR8e3_E4000"

# Best PSNR of the 300-epoch MFN denoise fit and best -10 log10(MSE) of the
# 300-iteration MFN SISR fit from wire_tpu on the CPU (fused="never",
# float32, the sweep app's problems, this script's seed-0 init moved across
# with wire_tpu_torch.bridge), as printed by tools/port_mfn_floor.py; the
# kernel fits must reach them less 0.2 dB, and agree with the plain fits
# within PSNR_AGREE_DB.
WIRE_TPU_300_MFN_DB = {"denoise": 22.19007110595703,
                       "sisr": 18.832611964689864}
MFN_ITERS = 300

# Best PSNR of the 300-epoch WIRE-2D denoise fit and of the 300-iteration
# WIRE-2D CT fit (fourier, the card's 'auto') from wire_tpu on the CPU
# (fused="never", float32, this script's seed-0 init moved across with
# wire_tpu_torch.bridge), as printed by tools/port_wire2d_floor.py; the
# kernel fits must reach them less 0.2 dB, and agree with the plain fits
# within PSNR_AGREE_DB.
WIRE_TPU_300_WIRE2D_DB = {"denoise": 21.629484176635742,
                          "ct": 26.968250274658203}
WIRE2D_ITERS = 300
# WIRE-2D at the width of tools/exp_width256.py's headline configuration
# (300 hidden features: 150 complex units per head, 2 hidden layers) with
# the denoise bench's frequencies; the CT path takes CT_CONFIG's
WIRE2D_DENOISE_KW = dict(in_features=2, out_features=3, hidden_features=300,
                         hidden_layers=2, first_omega0=7.0, hidden_omega0=7.0,
                         scale=8.0)
# The 200-epoch occupancy fit from wire_tpu on the CPU (fused="never",
# float32, the occupancy app's configuration, this script's seed-0 init
# moved across with wire_tpu_torch.bridge; wire_tpu draws its own
# permutations), as printed by tools/port_occupancy_floor.py: best IoU 0.0
# and PSNR 12.6237 dB.  The fit is chaotic from its first Adam steps and
# bimodal: by epoch 200 its best reconstruction passes 0.5 nowhere (IoU 0)
# in 9 of 12 kernel fits, 5 of 6 plain fits (permutation seeds 0-11 and
# 0-5 from one init, tools/port_occupancy_fits.py, PERF.md section 6) and
# wire_tpu's, and reaches IoU 0.78-0.90 in the rest.  So the kernel fit is
# held to the IoU floor less OCC_IOU_MARGIN (0: no fit can lie below an
# IoU of 0) and to the PSNR floor less OCC_PSNR_MARGIN_DB (the 15 fits
# that stayed at IoU 0 lie at 12.64-14.23 dB); kernel and plain fits from
# one init and one permutation seed are held together by their training
# MSE at epoch OCC_AGREE_EPOCH, within OCC_MSE_AGREE (they are 0.3-1.0%
# apart over seeds 0-5, 2e-3 apart from epoch 2 on), not by their best IoU
# (one fit of a pair may take off while the other does not: seeds 1-3).
# The block-permuted fit of OCC_BLOCK_EPOCHS epochs must reach the
# per-point fit's best PSNR at that depth less OCC_BLOCK_MARGIN_DB
# (-0.022 to +0.010 dB apart over seeds 0-11) and its IoU less 0.
WIRE_TPU_200_OCC_IOU = 0.0
WIRE_TPU_200_OCC_PSNR_DB = 12.623724937438965
OCC_EPOCHS = 200
OCC_IOU_MARGIN = 0.0
OCC_PSNR_MARGIN_DB = 0.3
OCC_AGREE_EPOCH = 100
OCC_MSE_AGREE = 0.02
OCC_BLOCK_EPOCHS = 20
OCC_BLOCK_MARGIN_DB = 0.1
# volume_motion: export_mesh_from_model over a VM_CUBE_RES^3 grid in
# batches of VM_BATCH points (64 forwards), meshed at VM_MESH_LEVEL of the
# best 64^3 reconstruction's max (the app's 0.5 lies above a fit whose best
# IoU is 0; half the max meshes the fit's noise, 6.6 million faces),
# blockwise probing at
# VM_BLOCK_RES^3 in 2^VM_BLOCK_DEPTH cells an axis, refill of a ragged
# cloud at depth VM_REFILL_DEPTH; ECC and Farneback on MOTION_SIDE^2
# frames of motion_scene moved by MOTION_EUCLIDEAN (angle, tx, ty) and
# MOTION_HOMOGRAPHY, held to cv2's results on the same frames
# (tools/port_motion_reference.py wrote MOTION_REFERENCE) within the CPU
# tests' tolerances (tests/test_torch_motion_cv2.py): ECC_LINEAR_TOL on
# the warp's linear part and perspective row, ECC_SHIFT_TOL_PX on its
# translation, Farneback's endpoint error FLOW_MEAN_EPE_PX mean and
# FLOW_MAX_EPE_PX max over the reference's lattice
VM_CUBE_RES = 256
VM_BATCH = 262144
VM_MESH_LEVEL = 0.9
VM_BLOCK_RES = 128
VM_BLOCK_DEPTH = 2
VM_REFILL_DEPTH = 3
VM_REFILL_POINTS = 20000
MOTION_SIDE = 96
MOTION_ECC_ITERS = 200
MOTION_EUCLIDEAN = (0.02, 2.5, -1.5)
MOTION_HOMOGRAPHY = ((1.01, 0.015, 2.0), (-0.012, 0.995, -1.2),
                     (5e-5, -3e-5, 1.0))
MOTION_REFERENCE = os.path.join("tools", "port_motion_reference.json")
ECC_LINEAR_TOL = 1e-4
ECC_SHIFT_TOL_PX = 1e-3
FLOW_MEAN_EPE_PX = 0.01
FLOW_MAX_EPE_PX = 0.1
# Best PSNR of the 300-epoch denoise fits of the multiscale step families
# at FAMILIES_PRESET's shape from wire_tpu on the CPU (fused="never",
# float32, this script's seed-0 init moved across), as printed by
# tools/port_families_floor.py; the kernel fits must reach them less
# 0.2 dB, and agree with the plain fits within PSNR_AGREE_DB.
WIRE_TPU_300_FAMILIES_DB = {"bspline_mscale_1": 22.26449203491211,
                            "bspline_mscale_1_new": 15.658970832824707,
                            "bspline_mscale_repIN": 15.658970832824707}
FAMILIES_ITERS = 300
# epochs of the realgabor and bspline_sig fits (autodiff, no kernel)
AUTODIFF_ITERS = 20
# iterations of each family's fit in the sweep phase
SWEEP_ITERS = 20

# The fit_tv phase: the denoise app on a preset registered for it
# (TV_CONFIG: TV_BASE_CONFIG's WIRE-300 at TV_ITERS epochs with tvl on and
# lambda_tv = TV_LAMBDA), its input the procedural 512^2 natural image
# written as a PNG by the port (write_tv_png).  TV_LAMBDA is the best of
# wire_tpu's CPU fits of tools/port_tv_floor.py at lambda_tv 0, 1e-7,
# 1e-6 and 1e-5 (best PSNR 27.9844, 28.6257, 30.0665 and 24.1036 dB);
# WIRE_TPU_300_TV_DB is that tool's best PSNR at it (fused="never",
# float32, the port's seed-0 init moved across with
# wire_tpu_torch.bridge); the kernel fit must reach it less 0.2 dB and
# agree with the plain fit within PSNR_AGREE_DB.
TV_BASE_CONFIG = "WIRE_s8_o7_LR5e3_E2000"
TV_CONFIG = "WIRE_s8_o7_TV_E300"
TV_LAMBDA = 1e-6
TV_ITERS = 300
WIRE_TPU_300_TV_DB = 30.06650733947754
# (b) the B-spline denoise preset with TV, (c) WIRE-300 in two chunks
TV_REAL_ITERS = 50
TV_CHUNK_POINTS = 32768
TV_CHUNK_ITERS = 20


def write_tv_png(np, path):
    """The fit_tv phase's input: the 512^2 procedural natural image (the
    denoise app's stand-in) as an 8-bit RGBA PNG, written by the port
    (signals/image.py:imsave, as plt.imsave writes it); returns ``path``."""
    from wire_tpu_torch.signals import image as I
    I.imsave(path, I.natural_image(512, 512, 3, seed=0))
    return path


# H100 SXM published peaks (NVIDIA data sheet), at the 700 W power limit.
H100_FP32_TFLOPS = 67.0
H100_TF32_TFLOPS = 495.0   # dense, tensor cores
H100_HBM_TBPS = 3.35

KERNEL_LIBRARIES = ("wire_step", "wire_mlp", "rotsum", "line_sample",
                    "real_mlp", "mscale2_step", "mfn", "wire2d")
# the kernels line: name -> (library source, the TPU kernel it replaces)
KERNELS = {
    "wire_step": ("wire_step", "wire_tpu/ops/pallas/wire_step.py:356"),
    "wire_mlp": ("wire_mlp", "wire_tpu/ops/pallas/wire_mlp.py:296"),
    "rotsum": ("rotsum", "wire_tpu/ops/pallas/rotsum.py:259"),
    "line_sample": ("line_sample", "wire_tpu/ops/pallas/line_sample.py:144"),
    "real_step": ("real_mlp", "wire_tpu/ops/pallas/real_mlp.py:689"),
    "real_mlp": ("real_mlp", "wire_tpu/ops/pallas/real_mlp.py:304"),
    "mscale2_step": ("mscale2_step",
                     "wire_tpu/ops/pallas/mscale2_step.py:222"),
    "mfn_step": ("mfn", "wire_tpu/ops/pallas/mfn_step.py:421"),
    "mfn_mlp": ("mfn", "wire_tpu/ops/pallas/mfn_step.py:290"),
    "wire2d_step": ("wire2d", "wire_tpu/ops/pallas/wire2d_step.py:305"),
    "wire2d_mlp": ("wire2d", "wire_tpu/ops/pallas/wire2d_step.py:549"),
}

# Kernel vs plain: max abs error <= REL_TOL * max |plain| per output tensor.
# Both sum fp32 products over up to 262,144 rows in different orders (tiles
# and fixed-order chunk partials vs cuBLAS), so they differ by rounding.
REL_TOL = 1e-4


def emit(phase, t0, **fields):
    print(json.dumps({"phase": phase, "wall_s": round(time.time() - t0, 3),
                      **fields}), flush=True)


def tensors_of(pred, grads, sums):
    """{name: tensor} of a step's outputs, gradients named by their tree
    path ("first.w", "combiner.freq_0.b", "layers.0.alpha", ...)."""
    out = {"pred": pred, "sse_target": sums[0], "sse_gt": sums[1]}
    out.update({".".join(map(str, path)): v
                for path, v in tree_leaves(grads)})
    return out


def compare(got, want, what):
    """Max abs error per tensor; raises past REL_TOL * max |want|."""
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        if not err <= REL_TOL * scale + 1e-30 * (scale == 0.0):
            raise AssertionError(
                f"{what}: {name} max abs err {err:.3e} > {REL_TOL} x "
                f"max|plain| {scale:.3e}")
        worst = max(worst, err)
    return worst


def float64_tree(x):
    """``x`` with every floating tensor and every float in it, through
    dicts, lists and tuples, cast to float64 (the inverse scales too);
    strings, ints and None as they are."""
    if isinstance(x, dict):
        return {k: float64_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(float64_tree(v) for v in x)
    if hasattr(x, "is_floating_point"):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, numbers.Real) and not isinstance(x, numbers.Integral):
        return float(x)
    return x


def compare_float64(got, plain, args, kwargs, what):
    """Holds the kernel's outputs ``got`` ({name: tensor}) to ``plain(*args,
    **kwargs)`` run in float64 (float64_tree of every input), with
    compare(): the reference of mscale2_step and of the wire2d_mlp
    CT-frequency width case, whose fp32 plain versions lie near or past
    REL_TOL x max from their own float64 runs (combiner relu units within
    rounding of 0; differences of near-equal blocks).  Returns (max abs
    err, the float64 outputs)."""
    want = plain(*float64_tree(args), **float64_tree(kwargs))
    for name, w in want.items():
        if str(w.dtype) != "torch.float64":
            raise AssertionError(f"{what}: the float64 reference's {name} "
                                 f"is {w.dtype}")
    return compare(got, want, what), want


def rel_distance(got, want):
    """max over the outputs of max |got - want| / max |want|."""
    return max(float((got[k].double() - want[k].double()).abs().max())
               / max(float(want[k].double().abs().max()), 1e-300)
               for k in want)


def inputs(torch, model, n, seed, device):
    import numpy as np
    rng = np.random.default_rng(seed)
    o = model.spec.out_features
    params = model.init(torch.Generator().manual_seed(seed), device)
    coords, target, gt = (torch.tensor(a, device=device) for a in (
        rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        rng.uniform(0, 1, (n, o)).astype(np.float32),
        rng.uniform(0, 1, (n, o)).astype(np.float32)))
    return params, coords, target, gt


def matmul_vjp(torch, w, coords, spec, cotangent, want_dcoords=False):
    """The WIRE forward and backward as torch.matmul calls on the stacked
    layout with the backward written out, for the output cotangent
    ``cotangent(y)``: the library yardstick (not used by the port).
    Returns (y, gw1, gWh, gfW, dcoords or None)."""
    h = w["w1"].shape[1]
    s2 = spec.scale ** 2
    om, om1 = spec.hidden_omega0, spec.first_omega0

    def gabor(zr, zi, omega):
        m = torch.exp(-omega * zi - s2 * (zr * zr + zi * zi))
        return torch.cat([m * torch.cos(omega * zr),
                          m * torch.sin(omega * zr)], 1)

    def gabor_bwd(da, a, zr, zi, omega):
        dar, dai, ar, ai = da[:, :h], da[:, h:], a[:, :h], a[:, h:]
        t1 = dar * ar + dai * ai
        t2 = dai * ar - dar * ai
        dzr = -2.0 * s2 * zr * t1 + omega * t2
        return dzr, (-omega - 2.0 * s2 * zi) * t1

    z1 = torch.addmm(w["b1"], coords, w["w1"])
    acts, zs = [gabor(z1, torch.zeros_like(z1), om1)], []
    for l in range(spec.hidden_layers):
        z = torch.addmm(w["Bh"][l], acts[-1], w["Wh"][l])
        zs.append(z)
        acts.append(gabor(z[:, :h], z[:, h:], om))
    y = torch.addmm(w["fb"], acts[-1], w["fW"])
    g = cotangent(y)
    gfW = torch.cat([acts[-1].t() @ g, g.sum(0, keepdim=True)])
    da = g @ w["fWT"]
    gWh = [torch.empty((0, 2 * h + 1, 2 * h), device=y.device)]
    for l in reversed(range(spec.hidden_layers)):
        dz = torch.cat(gabor_bwd(da, acts[l + 1], zs[l][:, :h], zs[l][:, h:],
                                 om), 1)
        gWh.insert(0, torch.cat([acts[l].t() @ dz,
                                 dz.sum(0, keepdim=True)])[None])
        da = dz @ w["WhT"][l]
    dz1, _ = gabor_bwd(da, acts[0], z1, torch.zeros_like(z1), om1)
    gw1 = torch.cat([coords.t() @ dz1, dz1.sum(0, keepdim=True)])
    dcoords = dz1 @ w["w1"].t() if want_dcoords else None
    return y, gw1, torch.cat(gWh), gfW, dcoords


def matmul_step(torch, w, coords, target, gt, spec):
    """The masked-MSE train step through ``matmul_vjp``."""
    n, o = target.shape
    y, gw1, gWh, gfW, _ = matmul_vjp(
        torch, w, coords, spec, lambda y: (2.0 / (n * o)) * (y - target))
    et, eg = y - target, y - gt
    return y, gw1, gWh, gfW, ((et * et).sum(), (eg * eg).sum())


def wire2d_matmul_vjp(torch, W2, params, coords, spec, cotangent,
                      want_dcoords=False):
    """The WIRE-2D forward and backward as torch.matmul calls on the
    stacked layout (ops/wire2d.py:stack_params) with the Gabor-2D backward
    written out (wire2d_step.py:189-198), for the output cotangent
    ``cotangent(y)``: the library yardstick (not used by the port).
    Returns (y, dparams, dcoords or None)."""
    L = spec.hidden_layers
    w = W2.stack_params(params, L)
    h = w["w1"].shape[1] // 2
    s2 = spec.scale ** 2
    om, om1 = spec.hidden_omega0, spec.first_omega0

    def gabor(lr, li, orr, oi, omega):
        m = torch.exp(-omega * li - s2 * (lr * lr + li * li + orr * orr
                                          + oi * oi))
        return torch.cat([m * torch.cos(omega * lr),
                          m * torch.sin(omega * lr)], 1)

    def t12(da, a):
        dar, dai, ar, ai = da[:, :h], da[:, h:], a[:, :h], a[:, h:]
        return dar * ar + dai * ai, dai * ar - dar * ai

    z1 = torch.addmm(w["b1"], coords, w["w1"])
    lr1, or1 = z1[:, :h], z1[:, h:]
    acts, zs = [gabor(lr1, 0.0, or1, 0.0, om1)], []
    for l in range(L):
        z = torch.addmm(w["B2"][l], acts[-1], w["W2"][l])
        zs.append(z)
        acts.append(gabor(*z.split(h, 1), om))
    y = torch.addmm(w["fb"], acts[-1], w["fW"])
    g = cotangent(y)
    gfW = torch.cat([acts[-1].t() @ g, g.sum(0, keepdim=True)])
    da = g @ w["fWT"]
    gW2 = [None] * L
    for l in reversed(range(L)):
        t1, t2 = t12(da, acts[l + 1])
        lr, li, orr, oi = zs[l].split(h, 1)
        dz = torch.cat([-2.0 * s2 * lr * t1 + om * t2,
                        (-om - 2.0 * s2 * li) * t1, -2.0 * s2 * orr * t1,
                        -2.0 * s2 * oi * t1], 1)
        gW2[l] = torch.cat([acts[l].t() @ dz, dz.sum(0, keepdim=True)])
        da = dz @ w["W2T"][l]
    t1, t2 = t12(da, acts[0])
    dz1 = torch.cat([-2.0 * s2 * lr1 * t1 + om1 * t2, -2.0 * s2 * or1 * t1],
                    1)
    gw1 = torch.cat([coords.t() @ dz1, dz1.sum(0, keepdim=True)])
    gW2 = torch.stack(gW2) if L else y.new_empty((0, 2 * h + 1, 4 * h))
    dparams = W2.unstack_grads(gw1, gW2, gfW, params["final"]["bi"], L)
    return y, dparams, (dz1 @ w["w1"].t() if want_dcoords else None)


def wire2d_matmul_step(torch, W2, params, coords, target, gt, spec):
    """The masked-MSE train step through ``wire2d_matmul_vjp``: (pred,
    dparams, (sse_target, sse_gt))."""
    n, o = target.shape
    y, dparams, _ = wire2d_matmul_vjp(
        torch, W2, params, coords, spec,
        lambda y: (2.0 / (n * o)) * (y - target))
    et, eg = y - target, y - gt
    return y, dparams, ((et * et).sum(), (eg * eg).sum())


def vjp(torch, fn, inputs, cot):
    """{"out": fn(*inputs)} plus "d<i>": the gradient of <fn(...), cot>
    w.r.t. input i (zeros where unused); fn may return a tuple, then cot is
    a tuple too and the outputs are "out0", "out1", ..."""
    xs = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    grads = torch.autograd.grad(outs, xs, cots, allow_unused=True)
    res = {(f"out{i}" if len(outs) > 1 else "out"): o.detach()
           for i, o in enumerate(outs)}
    for i, (x, g) in enumerate(zip(xs, grads)):
        res[f"d{i}"] = torch.zeros_like(x) if g is None else g
    return res


def pair_fn(apply, spec, paths):
    """(coords, *leaves) -> apply(params, coords, spec), ``params`` the tree
    of ``leaves`` at ``paths``: a pair (the kernels or the plain version)
    as a function of its leaves, for vjp()."""
    def fn(coords, *leaves):
        return apply(tree_unflatten(paths, leaves), coords, spec)
    return fn


def tree_leaves(params):
    """[(path, tensor)] of a parameter tree (wire_tpu_torch/tree.py)."""
    from wire_tpu_torch import tree
    return tree.leaves(params)


def tree_unflatten(paths, leaves):
    from wire_tpu_torch import tree
    return tree.unflatten(paths, leaves)


def leaf_paths(params):
    return [path for path, _ in tree_leaves(params)]


def num_weights(params):
    return sum(t.numel() for _, t in tree_leaves(params))


def rot_grids(torch, S, angles, device):
    """grid_sample grids (A, S, S, 2) of the rotate() convention for
    align_corners=True (tools/oracle_sweep.py:_make_rot_grids)."""
    t = torch.deg2rad(torch.tensor(angles, device=device))
    cos, sin = torch.cos(t)[:, None, None], torch.sin(t)[:, None, None]
    ys, xs = torch.meshgrid(torch.arange(S, dtype=torch.float32,
                                         device=device),
                            torch.arange(S, dtype=torch.float32,
                                         device=device), indexing="ij")
    c = (S - 1) / 2.0
    x, y = xs - c, ys - c
    sx = cos * x - sin * y + c
    sy = sin * x + cos * y + c
    return torch.stack([2 * sx / (S - 1) - 1, 2 * sy / (S - 1) - 1], -1)


def bound(flops, nbytes):
    """(least ms, what bounds it) at the card's fp32 and HBM peaks."""
    ops_ms = flops / (H100_FP32_TFLOPS * 1e9)
    bytes_ms = nbytes / (H100_HBM_TBPS * 1e9)
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def bound_3xtf32(flops, nbytes):
    """(least ms, what bounds it) for fp32 products formed as three TF32
    tensor-core products each (wire_mlp's hidden layers, csrc/wire_tc.cuh),
    at the card's dense TF32 and HBM peaks."""
    ops_ms = 3 * flops / (H100_TF32_TFLOPS * 1e9)
    bytes_ms = nbytes / (H100_HBM_TBPS * 1e9)
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def sass_hmma(torch, build, name):
    """HMMA instructions in the SASS of csrc/<name>.cu's built library
    (cuobjdump -sass), or "not checked" where the toolkit has no
    cuobjdump."""
    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.access(cuobjdump, os.X_OK):
        return "not checked"
    sass = subprocess.run([cuobjdump, "-sass", build.library_path(name)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return sass.count("HMMA")


def kernel_breakdown(torch, fn, iters):
    """{device kernel name: [ms per call, launches per call]} of every
    device kernel ``fn`` launches (torch.profiler, device-side events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: [e.device_time_total / 1e3 / iters, e.count / iters]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


# the device kernels by product class of the libraries whose hidden-layer
# products run on the tensor cores: name fragments (csrc/wire_tc.cuh,
# wire_gemm.cuh, gemm_common.cuh and the libraries' own kernels)
WIRE_WEIGHT_GRADIENTS = ("tc_wgrad_kernel", "narrow_wgrad_kernel",
                         "narrow_colsum_kernel", "reduce_chunks_kernel")
TENSOR_CORE_CLASSES = {
    "wire_mlp": {
        "forward_gemms": ("tc_paired_kernel<0",),
        "data_gradient_gemms": ("tc_paired_kernel<1", "tc_paired_kernel<2"),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "first_final_dcoords": ("first_forward_kernel",
                                "final_forward_kernel", "dcoords_kernel"),
    },
    "wire_step": {
        "forward_gemms": ("tc_paired_kernel<0",),
        "data_gradient_gemms": ("tc_paired_kernel<1", "tc_paired_kernel<2"),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "first_final_loss": ("first_forward_kernel", "final_loss_kernel"),
    },
    "mscale2_step": {
        "forward_gemms": ("real_tc_kernel<0",),
        "data_gradient_gemms": ("real_tc_kernel<1",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS + ("colsum_partial_kernel",),
        "first_top_final_combiner": ("real_narrow_kernel",
                                     "final_forward_kernel",
                                     "combiner_kernel"),
    },
    "mfn_step": {
        "forward_gemms": ("mfn_tc_kernel<0",),
        "data_gradient_gemms": ("mfn_tc_kernel<1", "mfn_tc_kernel<2",
                                "mfn_narrow_kernel"),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "filter_gradients": ("filter_grad_partial_kernel",
                             "filter_grad_finish_kernel"),
        "first_final_loss": ("filter_forward_kernel", "final_loss_kernel"),
    },
    "mfn_mlp": {
        "forward_gemms": ("mfn_tc_kernel<0",),
        "data_gradient_gemms": ("mfn_tc_kernel<1", "mfn_tc_kernel<2",
                                "mfn_narrow_kernel"),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "filter_gradients_dcoords": ("filter_grad_partial_kernel",
                                     "filter_grad_finish_kernel",
                                     "filter_dcoords_kernel"),
        "first_final": ("filter_forward_kernel", "final_forward_kernel"),
    },
    "wire2d_step": {
        "forward_gemms": ("gabor2d_tc_fwd_kernel",),
        "data_gradient_gemms": ("gabor2d_tc_bwd_kernel",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "first_final_loss": ("gabor2d_first_kernel", "final_loss_kernel"),
    },
    "real_step": {
        "forward_gemms": ("real_tc_kernel<0",),
        "data_gradient_gemms": ("real_tc_kernel<1",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS + ("colsum_partial_kernel",),
        "first_top_final_loss": ("real_narrow_kernel", "final_loss_kernel"),
    },
    "real_mlp": {
        "forward_gemms": ("real_tc_kernel<0",),
        "data_gradient_gemms": ("real_tc_kernel<1",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS + ("colsum_partial_kernel",),
        "first_top_final_dcoords": ("real_narrow_kernel",
                                    "final_forward_kernel", "dcoords_kernel"),
    },
    "wire2d_mlp": {
        "forward_gemms": ("gabor2d_tc_fwd_kernel",),
        "data_gradient_gemms": ("gabor2d_tc_bwd_kernel",),
        "weight_gradients": WIRE_WEIGHT_GRADIENTS,
        "first_final_dcoords": ("gabor2d_first_kernel",
                                "final_forward_kernel",
                                "gabor2d_dcoords_kernel"),
    },
}


def tensor_core_fields(torch, build, fn, name, flops, nbytes, kernel_ms,
                       lib=None):
    """The measure fields of kernel ``name`` (of library ``lib``, default
    ``name``) whose hidden-layer products are 3xTF32 tensor-core products:
    its device kernels and their time by product class
    (TENSOR_CORE_CLASSES), the 3xTF32 bound as bound_ms with the fp32
    CUDA-core bound beside it, the shares of both in kernel_ms, and the HMMA
    instructions of its library."""
    by = kernel_breakdown(torch, fn, 20)
    res = {"device_kernels": {k[:120]: v for k, v in by.items()},
           "device_kernels_per_call": sum(v[1] for v in by.values()),
           "classes_ms": {
               cls: sum(v[0] for k, v in by.items()
                        if any(f in k for f in frags))
               for cls, frags in TENSOR_CORE_CLASSES[name].items()}}
    res["bound_fp32_ms"] = bound(flops, nbytes)[0]
    res["bound_ms"], res["bound_by"] = bound_3xtf32(flops, nbytes)
    res["bound_3xtf32_ms"] = res["bound_ms"]
    if kernel_ms:
        res["share_of_fp32_bound"] = res["bound_fp32_ms"] / kernel_ms
        res["share_of_3xtf32_bound"] = res["bound_3xtf32_ms"] / kernel_ms
    res["sass_hmma"] = sass_hmma(torch, build, lib or name)
    return res


def line_sample_bytes(torch, gy, gx, p, replicas=1):
    """Bytes the spectrum gather + scatter pair must move at positions
    (gy, gx) on ``replicas`` (p, p) spectra.  Each spectrum's own: the
    distinct taps its stencils read (the halo wrapped), 8 bytes each; the
    slice out and its cotangent in, 8 bytes a sample each; and the (p, p)
    complex gradient out.  Once for all spectra: the centring table's taps
    (the scatter reads them again, counted once), the positions and the
    un-centring phase."""
    y0, x0 = torch.floor(gy).long(), torch.floor(gx).long()
    taps = torch.cat([(((y0 + dy) % p) * p + (x0 + dx) % p).ravel()
                      for dy in (0, 1) for dx in (0, 1)])
    ntaps = int(torch.unique(taps).numel())
    A, K = gy.shape
    own = 8 * ntaps + 8 * 2 * A * K + 8 * p * p
    return replicas * own + 8 * ntaps + 4 * 2 * A * K + 8 * K


def kernel_names(name, csrc=None):
    """The __global__ functions of csrc/<name>.cu and of the csrc headers
    it includes, directly or through another header (``csrc``: another
    tree's source directory)."""
    import re
    csrc = csrc or os.path.join(ROOT, "wire_tpu_torch", "csrc")
    todo, seen, src = [f"{name}.cu"], set(), ""
    while todo:
        fname = todo.pop()
        if fname in seen:
            continue
        seen.add(fname)
        with open(os.path.join(csrc, fname)) as f:
            text = f.read()
        src += text
        todo += re.findall(r'#include "(\w+\.cuh)"', text)
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        src))


def kernel_device_ms(torch, fn, iters, names):
    """Device time per call of ``fn`` spent in the kernels called ``names``
    (torch.profiler, device-side events), without the host's launch and
    autograd work around them; None where the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and any(n in e.key for n in names))
    return us / 1e3 / iters if us else None


CT_SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
                  "hidden_layers", "first_omega0", "hidden_omega0", "scale")


def ct_models(get_inr, TCT, cfg):
    """The CT app's model (kernels) and the same spec with fused='never'
    (the plain path)."""
    model = TCT.build_ct_model(cfg, cfg.omega0)
    plain = get_inr("wire", fused="never", **{
        f: getattr(model.spec, f) for f in CT_SPEC_FIELDS})
    return model, plain


def ct_kernel_cases(torch, WM, R, LS, model, n, S, A, P, K, seed, device):
    """For each CT kernel: (kernel fn, plain fn, library fn or None, inputs,
    cotangent) at one shape: wire_mlp at n coordinates, rotsum at an
    (S, S) image x A angles, line_sample on a (P, P) spectrum at A angles
    over [0, 180] and K = P // 2 + 1 frequencies."""
    import numpy as np
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    spec = model.spec
    params = model.init(torch.Generator().manual_seed(seed), device)
    keys = leaf_paths(params)
    coords = t(rng.uniform(-1, 1, (n, 2)))
    g = t(rng.normal(size=(n, spec.out_features)))
    cases = {"wire_mlp": (
        pair_fn(WM.wire_mlp, spec, keys),
        pair_fn(WM.wire_mlp_plain, spec, keys),
        None, [coords] + [t for _, t in tree_leaves(params)], g)}

    angles = np.linspace(0, 180, A, dtype=np.float32)
    grids = rot_grids(torch, S, angles, device)
    # the angle parts on the device, as operators/radon.py:RadonOp keeps them
    parts = R.angle_parts_tensor(angles, True, device)
    cases["rotsum"] = (
        lambda x: R.rotate_project(x, angles, parts=parts),
        lambda x: R.rotate_project_plain(x, angles),
        lambda x: F.grid_sample(x[None, None].expand(A, 1, S, S), grids,
                                align_corners=True)[:, 0].sum(-2),
        [t(rng.random((S, S)))], t(rng.normal(size=(A, S))))

    # the spectrum gather/scatter pair on a random unshifted (P, P)
    # spectrum with operators/radon.py's tables, as a function of its
    # (P, P, 2) real view; the library call is the plain version's
    # composition with F.grid_sample in the place of the sampler
    from wire_tpu_torch.operators import radon as TR
    centre, gy, gx, uncentre = TR._fourier_consts(P, angles, device)
    ph = P + 2
    grid = torch.stack([2 * gx / (ph - 1) - 1, 2 * gy / (ph - 1) - 1],
                       -1)[None]

    def spectrum_fn(sample):
        def fn(x):
            return torch.view_as_real(sample(torch.view_as_complex(x),
                                             centre, gy, gx, uncentre))
        return fn

    def line_library(z):
        Fs = torch.fft.fftshift(z) * centre
        Fh = torch.cat([Fs, Fs[:2]], 0)
        Fh = torch.cat([Fh, Fh[:, :2]], 1)
        out = F.grid_sample(torch.stack([Fh.real, Fh.imag])[None], grid,
                            align_corners=True)
        return torch.complex(out[0, 0], out[0, 1]) * uncentre

    cases["line_sample"] = (
        spectrum_fn(LS.sample_spectrum), spectrum_fn(LS.sample_spectrum_plain),
        spectrum_fn(lambda z, *tables: line_library(z)),
        [t(rng.normal(size=(P, P, 2)))], t(rng.normal(size=(A, K, 2))))
    return cases, params, keys


def ct_kernel_vs_plain(torch, WM, R, LS, model, device):
    """max abs err per kernel at the CT shape ("full") and a ragged one;
    line_sample also at an odd P (729, a 168^2 image)."""
    shapes = {"full": dict(n=256 * 256, S=256, A=100, P=1024, K=513),
              "ragged": dict(n=700, S=96, A=13, P=384, K=193),
              "odd": dict(n=700, S=96, A=100, P=729, K=365)}
    errs = {name: {} for name in ("wire_mlp", "rotsum", "line_sample")}
    for which, shape in shapes.items():
        cases, _, _ = ct_kernel_cases(torch, WM, R, LS, model, seed=3,
                                      device=device, **shape)
        for name, (kfn, pfn, _, xs, cot) in cases.items():
            if which == "odd" and name != "line_sample":
                continue
            got = vjp(torch, kfn, xs, cot)
            torch.cuda.synchronize()
            if name == "wire_mlp":
                same_bits(torch, vjp(torch, kfn, xs, cot), got,
                          f"wire_mlp {which}")
            want = vjp(torch, pfn, xs, cot)
            torch.cuda.synchronize()
            errs[name][which] = compare(got, want, f"{name} {which}")
    return errs


# wire_mlp at widths, depths and outputs besides the CT path's, as
# (hidden_features, complex units h, L, o): h = 5 and 13 give a K (2h) that
# is not a multiple of 4 or of the tile, 150 a unit count that is not a
# multiple of 4; and the extreme-phase case, CT's width with omega0 3,
# sigma 1 and the hidden weights doubled (Gabor phases up to ~30 rad, where
# fp32 itself is ~1e-5 x max from float64)
WIRE_MLP_WIDTHS = ((8, 5, 0, 3), (8, 5, 3, 1), (19, 13, 1, 3),
                   (213, 150, 2, 1), (300, 212, 3, 3))


def wire_mlp_widths(torch, WM, get_inr, device):
    """wire_mlp against its plain version, with dcoords, at n = 700 for
    each of WIRE_MLP_WIDTHS, and at the extreme phase at n = 4,096."""
    import numpy as np
    errs = {}
    cases = [(hf, L, o, 700, 3.0, 12.0, 1.0, f"h{h} L{L} o{o}")
             for hf, h, L, o in WIRE_MLP_WIDTHS]
    cases.append((300, 2, 1, 4096, 3.0, 1.0, 2.0, "extreme_phase"))
    for hf, L, o, n, omega, scale, wscale, what in cases:
        model = get_inr("wire", in_features=2, out_features=o,
                        hidden_features=hf, hidden_layers=L,
                        first_omega0=omega, hidden_omega0=omega,
                        scale=scale)
        params = model.init(torch.Generator().manual_seed(n + L), device)
        for k in params:
            if k.startswith("hidden"):
                for kk in ("wr", "wi"):
                    params[k][kk] = params[k][kk] * wscale
        rng = np.random.default_rng(n + L)
        c = torch.tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                         device=device)
        g = torch.tensor(rng.normal(size=(n, o)).astype(np.float32),
                         device=device)
        keys = leaf_paths(params)
        xs = [c] + [t for _, t in tree_leaves(params)]
        got = vjp(torch, pair_fn(WM.wire_mlp, model.spec, keys), xs, g)
        torch.cuda.synchronize()
        want = vjp(torch, pair_fn(WM.wire_mlp_plain, model.spec, keys), xs,
                   g)
        errs[what] = compare(got, want, f"wire_mlp {what}")
    return errs


# wire_step at widths, depths, outputs and row counts besides the main
# path's, as (hidden_features, complex units h, L, o, n, nvalid, denom):
# K = 2h of 10, 26, 300 and 424, against the 32-deep slices and 32-unit
# tiles; n 700 and 65,537 against the 128-row tiles and the weight
# gradients' 512- and 1,024-row chunks
WIRE_STEP_WIDTHS = ((8, 5, 1, 3, 700, 650, 1951.0),
                    (8, 5, 3, 1, 700, None, None),
                    (19, 13, 2, 3, 700, 600, None),
                    (213, 150, 1, 1, 700, None, 777.0),
                    (213, 150, 3, 3, 700, 650, None),
                    (300, 212, 3, 1, 700, None, None),
                    (300, 212, 2, 3, 65537, 65000, None),
                    (19, 13, 1, 1, 65537, None, 70000.0))


def wire_step_widths(torch, WS, get_inr, device):
    """wire_step against its plain version at each of WIRE_STEP_WIDTHS
    (denoise frequencies, the tail masked by nvalid, denom), two calls
    bit-equal."""
    errs = {}
    for hf, h, L, o, n, nvalid, denom in WIRE_STEP_WIDTHS:
        what = f"h{h} L{L} o{o} n{n}"
        model = get_inr("wire", in_features=2, out_features=o,
                        hidden_features=hf, hidden_layers=L,
                        first_omega0=7.0, hidden_omega0=7.0, scale=8.0)
        params, coords, target, gt = inputs(torch, model, n, n + hf + L,
                                            device)
        got, again = (tensors_of(*WS.wire_step(
            params, coords, target, model.spec, nvalid=nvalid, denom=denom,
            gt=gt, want_metrics=True)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, again, got, f"wire_step {what}")
        want = WS.wire_step_plain(params, coords, target, model.spec,
                                  nvalid=nvalid, denom=denom, gt=gt,
                                  want_metrics=True)
        errs[what] = compare(got, tensors_of(*want), f"wire_step {what}")
    return errs


def strided_coords(torch, WM, RM, MF, W2, get_inr, ct_model, device):
    """Fault C.7, repaired: each CUDA MLP pair on a transposed (n, d) view
    of a (d, n) array gives the contiguous call's output and gradients bit
    for bit, and without a gradient its output; wire_mlp at the CT model,
    real_mlp at the B-spline trunk's widths, mfn_mlp at the MFN SISR width,
    wire2d_mlp at the WIRE-2D width.  Returns the max abs difference per
    pair (0)."""
    import numpy as np
    n = 4096
    rng = np.random.default_rng(40)
    strided = torch.tensor(rng.uniform(-1, 1, (2, n)).astype(np.float32),
                           device=device).t()
    if strided.is_contiguous():
        raise AssertionError("C.7: the coordinate view is contiguous")
    mfn = get_inr("mfn", in_features=2, out_features=3, hidden_features=256,
                  hidden_layers=2)
    w2d = get_inr("wire2d", **WIRE2D_DENOISE_KW)
    kinds = ("qspline",) * 3
    cases = {
        "wire_mlp": (WM.wire_mlp, ct_model),
        "real_mlp": (lambda p, x, spec: RM.real_mlp(p, x, kinds), None),
        "mfn_mlp": (MF.mfn_mlp, mfn),
        "wire2d_mlp": (W2.wire2d_mlp, w2d)}
    errs = {}
    for name, (apply, model) in cases.items():
        if model is None:
            spec, params = None, random_canon(torch, (2, 256, 256, 256, 3),
                                              41, device)
        else:
            spec = model.spec
            params = model.init(torch.Generator().manual_seed(42), device)
        paths = leaf_paths(params)
        leaves = [t for _, t in tree_leaves(params)]
        fn = pair_fn(apply, spec, paths)
        with torch.no_grad():
            o = fn(strided.contiguous(), *leaves).shape[-1]
        g = torch.tensor(rng.normal(size=(n, o)).astype(np.float32),
                         device=device)
        got = vjp(torch, fn, [strided] + leaves, g)
        want = vjp(torch, fn, [strided.contiguous()] + leaves, g)
        same_bits(torch, got, want, f"C.7 {name} on a transposed view")
        with torch.no_grad():
            if not torch.equal(fn(strided, *leaves), want["out"]):
                raise AssertionError(f"C.7 {name} without a gradient: the "
                                     f"transposed view's output differs")
        errs[f"C7_{name}_strided"] = max(
            float((got[k] - want[k]).abs().max()) for k in want)
    return errs


def fourier_operator(torch, device, iters=20):
    """The vjp of radon(img, angles, method="fourier") at the CT shape (a
    256^2 image, 100 angles; P 1,024): ms per call (CUDA events), the
    device kernels and memsets a call launches by name with their ms and
    count (torch.profiler), their sum, and the names in the order one call
    ran them (forward, then backward).  Not gated: the yardstick of what the
    operator around the line_sample pair costs."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from wire_tpu_torch.operators import radon as TR
    rng = np.random.default_rng(5)
    angles = np.linspace(0, 180, 100, dtype=np.float32)
    img, cot = (torch.tensor(a.astype(np.float32), device=device) for a in (
        rng.random((256, 256)), rng.normal(size=(100, 256))))

    def call():
        return vjp(torch, lambda x: TR.radon(x, angles, method="fourier"),
                   [img], cot)
    by = kernel_breakdown(torch, call, iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    order = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda e: e.time_range.start)
    return {"fourier_operator_ms": cuda_ms(torch, call, iters),
            "fourier_operator_launches": sum(v[1] for v in by.values()),
            "fourier_operator_kernels": {k[:120]: v for k, v in by.items()},
            "fourier_operator_order": [e.name[:80] for e in order]}


def ct_measure(torch, WM, R, LS, model, device, build):
    """Times at the CT shape of each kernel's forward + backward pair (and
    of its forward alone), its plain version's pair and a library call's
    pair, with the card's least time for the pair; for wire_mlp its kernel
    time by product class, its fp32 CUDA-core and 3xTF32 tensor-core bounds
    and the HMMA instructions of its library; for rotsum the forward and
    adjoint kernel times and the device kernels a call launches; for
    line_sample the whole fourier operator's vjp (fourier_operator)."""
    import numpy as np
    n, S, A, P, K = 256 * 256, 256, 100, 1024, 513
    cases, params, keys = ct_kernel_cases(torch, WM, R, LS, model, n, S, A,
                                          P, K, seed=4, device=device)
    spec = model.spec
    L, h = spec.hidden_layers, params["first"]["w"].shape[1]
    d, o = spec.in_features, spec.out_features
    nweights = num_weights(params)
    from wire_tpu_torch.operators import radon as TR
    _, gy, gx, _ = TR._fourier_consts(
        P, np.linspace(0, 180, A, dtype=np.float32), device)
    work = {
        "wire_mlp": (WM.apply_flops(n, d, h, o, L),
                     4 * (2 * (n * d + n * o + nweights))),
        "rotsum": (2 * R.sample_flops(A, S), 4 * 2 * (S * S + A * S)),
        "line_sample": (2 * LS.sample_flops(A, K),
                        line_sample_bytes(torch, gy, gx, P)),
    }
    out = {}
    for name, (kfn, pfn, lfn, xs, cot) in cases.items():
        def fwd(fn=kfn, xs=xs):
            with torch.no_grad():
                fn(*xs)
        res = {
            "ms": cuda_ms(torch, lambda: vjp(torch, kfn, xs, cot), 20),
            "kernel_ms": kernel_device_ms(
                torch, lambda: vjp(torch, kfn, xs, cot), 20,
                kernel_names(name)),
            "fwd_ms": cuda_ms(torch, fwd, 20),
            "plain_ms": cuda_ms(torch, lambda: vjp(torch, pfn, xs, cot), 20),
        }
        if name == "wire_mlp":
            w = WM.stack_params(params, L)
            lib = matmul_vjp(torch, w, xs[0], spec, lambda y: cot,
                             want_dcoords=True)
            dp = WM.unstack_grads(*lib[1:4], params, L)
            got = {"out": lib[0], "d0": lib[4]}
            got.update({f"d{i + 1}": t
                        for i, (_, t) in enumerate(tree_leaves(dp))})
            res["library_ms"] = cuda_ms(torch, lambda: matmul_vjp(
                torch, w, xs[0], spec, lambda y: cot, want_dcoords=True), 20)
            res["library"] = "torch.matmul forward + written-out backward"
        else:
            got = vjp(torch, lfn, xs, cot)
            res["library_ms"] = cuda_ms(torch,
                                        lambda: vjp(torch, lfn, xs, cot), 20)
            res["library"] = "F.grid_sample(align_corners=True) + autograd"
        want = vjp(torch, pfn, xs, cot)
        res["library_vs_plain_max_abs_err"] = max(
            float((got[k] - want[k]).abs().max()) for k in want)
        res["bound_ms"], res["bound_by"] = bound(*work[name])
        res["gflop"], res["mbytes"] = work[name][0] / 1e9, work[name][1] / 1e6
        if name == "wire_mlp":
            res.update(tensor_core_fields(
                torch, build, lambda: vjp(torch, kfn, xs, cot), name,
                *work[name], res["kernel_ms"]))
        if name == "rotsum":
            by = kernel_breakdown(torch, lambda: vjp(torch, kfn, xs, cot), 20)
            res["device_kernels"] = {k[:120]: v for k, v in by.items()}
            res["device_kernels_per_call"] = sum(v[1] for v in by.values())
            res["forward_kernel_ms"] = sum(
                v[0] for k, v in by.items() if "rotsum_forward_kernel" in k)
            res["adjoint_kernel_ms"] = sum(
                v[0] for k, v in by.items() if "rotsum_adjoint_kernel" in k)
        if name == "line_sample":
            res.update(fourier_operator(torch, device))
        out[name] = res
    return out


def check_ct_launches(launches, method, radon_kernel, iters):
    """Every CT iteration launched wire_mlp forward and backward and the
    method's Radon kernel pair once, and nothing else."""
    for name, counts in launches.items():
        want = iters if name in ("wire_mlp", radon_kernel) else 0
        if any(v != want for v in counts.values()):
            raise AssertionError(
                f"CT {method}: {name} launched {counts} times in {iters} "
                f"iterations, expected {want} each")


def fit_ct(torch, np, mods, device):
    """The CT protocol through fit_operator for 'auto' (fourier on the
    card) and 'rotate': once through the kernels, launch counts reset just
    before and read just after, and once through the plain path, from one
    init; returns per method the fit numbers and the launch counts."""
    WM, R, LS, TR, TCT, M, get_inr, get_config, FitConfig, fit_operator = \
        mods
    cfg = get_config(CT_CONFIG)
    model, plain_model = ct_models(get_inr, TCT, cfg)
    img = TCT.ct_image(None, 0)
    H, W = img.shape
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    grid = TCT.C.grid2d(H, W)
    params = model.init(torch.Generator().manual_seed(0), device)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=CT_ITERS,
                        maxpoints=cfg.maxpoints)
    angles_t = torch.tensor(thetas, device=device)
    counters = Counts("wire_mlp", "rotsum", "line_sample")
    out = {}
    for method in ("auto", "rotate"):
        resolved = TR._resolve_auto(method, len(thetas), "cuda", False)
        radon_kernel = {"fourier": "line_sample", "rotate": "rotsum"}[
            resolved]
        sino = TCT.make_sinogram(img, thetas, radon_method=method,
                                 device=device)
        op = TR.RadonOp(thetas, method=method)
        if resolved == "fourier":
            def plain_op(f):
                return TR._radon_fourier(f, angles_t, sampler="plain")
        else:
            plain_op = TR.RadonOp(thetas, method="rotate_xla")
        t0 = time.time()
        counters.reset()
        res = fit_operator(model, params, grid, sino, op, fit_cfg,
                           gt_field=img, field_shape=(H, W), device=device)
        launches = counters.read()
        check_ct_launches(launches, method, radon_kernel, CT_ITERS)
        res_plain = fit_operator(plain_model, params, grid, sino, plain_op,
                                 fit_cfg, gt_field=img, field_shape=(H, W),
                                 device=device)
        if counters.read() != launches:
            raise AssertionError(f"CT {method}: the plain fit launched a "
                                 f"kernel")
        for r in (res, res_plain):
            if not (np.isfinite(r.best_rec).all()
                    and np.isfinite(r.mse_gt).all()
                    and np.isfinite(r.mse_noisy).all()
                    and r.best_rec.shape == (H, W)):
                raise AssertionError(f"CT {method}: non-finite values or a "
                                     f"wrong shape")
        psnr = float(M.psnr_ref(img, res.best_rec))
        psnr_plain = float(M.psnr_ref(img, res_plain.best_rec))
        if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
            raise AssertionError(
                f"CT {method}: kernel fit {psnr:.3f} dB vs plain fit "
                f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
        floor = WIRE_TPU_300_ITER_CT_PSNR_DB[method] - 0.2
        if not psnr >= floor:
            raise AssertionError(f"CT {method}: kernel fit best PSNR "
                                 f"{psnr:.3f} dB below the floor {floor} dB")
        out[method] = dict(
            radon=resolved, iters=CT_ITERS, launches=launches, psnr_db=psnr,
            psnr_plain_db=psnr_plain, floor_db=floor,
            ssim=float(M.ssim(img, res.best_rec, data_range=1.0)),
            ssim_plain=float(M.ssim(img, res_plain.best_rec,
                                    data_range=1.0)),
            ms_per_iter=res.step_ms, plain_ms_per_iter=res_plain.step_ms,
            fit_wall_s=res.wall_time_s, plain_fit_wall_s=res_plain.wall_time_s,
            wall_s=time.time() - t0)
    return out


REAL_SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
                    "hidden_layers", "first_omega0", "hidden_omega0", "scale",
                    "sidelength", "pos_encode")


def real_models(get_inr, TC, cfg, omega0, sidelength):
    """A B-spline app's model (kernels) and the same spec with
    fused='never' (the plain path)."""
    model = TC.build_model(cfg, in_features=2, out_features=3, omega0=omega0,
                           sidelength=sidelength)
    plain = get_inr(cfg.nonlin, fused="never", **{
        f: getattr(model.spec, f) for f in REAL_SPEC_FIELDS})
    return model, plain


def path_canon(torch, MM, model, seed, device):
    """The canonical weights (ops/real_mlp.py) of a bspline_form model's
    seeded init, and its kinds."""
    params = model.init(torch.Generator().manual_seed(seed), device)
    canon = MM._canon_form(params, model.spec)
    return canon, ("qspline",) * len(canon["layers"])


def random_canon(torch, widths, seed, device):
    """Canonical weights at ``widths`` (d, w_0 .. w_{L-1}, o) with alpha in
    [0.5, 2] and beta in [-1, 1], so every basis is used on its support."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    layers = [{"w": t(rng.uniform(-1, 1, (a, b)) / np.sqrt(a)),
               "alpha": t(rng.uniform(0.5, 2.0, b)),
               "beta": t(rng.uniform(-1, 1, b))}
              for a, b in zip(widths[:-2], widths[1:-1])]
    h, o = widths[-2], widths[-1]
    return {"layers": layers,
            "final": {"w": t(rng.uniform(-1, 1, (h, o)) / np.sqrt(h)),
                      "b": t(rng.uniform(-1, 1, o))}}


def real_mlp_fn(RM, L, kinds, row_gamma=None, plain=False):
    """(coords, *canonical leaves) -> y through the kernels or the plain
    version."""
    def fn(coords, *leaves):
        canon = RM.canon_from_leaves(leaves, L)
        if plain:
            return RM.real_mlp_plain(canon, coords, kinds, row_gamma)
        return RM.real_mlp(canon, coords, kinds, row_gamma)
    return fn


def real_step_tensors(RM, pred, dcanon, sums):
    out = {"pred": pred, "sse_target": sums[0], "sse_gt": sums[1]}
    out.update({".".join(map(str, path)): t
                for path, t in RM.canon_leaves(dcanon)})
    return out


def real_inputs(torch, n, d, o, seed, device):
    import numpy as np
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(a.astype(np.float32), device=device) for a in (
        rng.uniform(-1, 1, (n, d)), rng.uniform(0, 1, (n, o)),
        rng.uniform(0, 1, (n, o)), rng.normal(size=(n, o))))


# the real cases held to their plain version run in float64, as
# tools/port_real_reference.py decides them (PERF.md section 6): where the
# fp32 plain run lies past 2.5e-5 x max of its own float64 run; every
# other real case keeps the fp32 plain version
REAL_FLOAT64_CASES = frozenset({
    "sweep denoise posenc", "sweep sisr relu", "sweep sisr posenc",
    "sweep ct relu", "sweep ct posenc"})
# of those, the relu pairs whose fp32 plain run lies past REL_TOL x max of
# the float64 run itself (1.5e-3 - 3.8e-3 on the card, fault C.9): a few
# of their 50 - 200 million relu inputs lie within fp32 rounding of 0, and
# each one decided the other way moves a parameter gradient, a sum of
# random-signed terms over 65,536 - 262,144 rows, by ~1 / sqrt(rows) of its
# size.  No fp32 evaluation meets REL_TOL there; the kernel is held to the
# float64 run on its own relu pattern (relu_pattern_reference)
REAL_RELU_PATTERN_CASES = frozenset({
    "sweep sisr relu", "sweep sisr posenc", "sweep ct relu",
    "sweep ct posenc"})


def real_step_plain_fn(RM):
    """real_step_plain's outputs by name (real_step_tensors)."""
    def plain(*args, **kwargs):
        return real_step_tensors(RM, *RM.real_step_plain(*args, **kwargs))
    return plain


def real_step_case(torch, RM, canon, c, t, kinds, **kw):
    """(kernel thunk, plain, args, kwargs) of one real_step case (metrics
    on); the kernel's calls share one scratch."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    kw = dict(kw, want_metrics=True)
    scratch = StepScratch()
    return (lambda: real_step_tensors(RM, *RM.real_step(
        canon, c, t, kinds, scratch=scratch, **kw)),
            real_step_plain_fn(RM), (canon, c, t, kinds), kw)


def real_pair_case(torch, RM, canon, c, cot, kinds, row_gamma=None,
                   dcoords=True):
    """(kernel thunk, plain, args, kwargs, pattern) of one real_mlp pair
    case: vjp() over [coords] + the canonical leaves (with dcoords) or
    param_vjp() (without); pattern(what) its relu_pattern_reference."""
    L = len(canon["layers"])
    inputs = [c] + [t for _, t in RM.canon_leaves(canon)]

    def pair(plain):
        fn = real_mlp_fn(RM, L, kinds, row_gamma, plain=plain)

        def run(inputs, cot):
            if dcoords:
                return vjp(torch, fn, inputs, cot)
            return param_vjp(torch, fn, inputs[0], inputs[1:], cot)
        return run
    kernel = pair(False)
    pattern = dict(canon=canon, x=c, kinds=kinds, cot=cot, dcoords=dcoords)
    return (lambda: kernel(inputs, cot), pair(True), (inputs, cot), {},
            lambda what: relu_pattern_reference(torch, RM, pattern, what))


def real_cases(torch, RM, MM, model_a, model_b, device):
    """{name: (kernel thunk, plain, args, kwargs[, pattern])} of
    real_kernel_vs_plain (pattern: real_pair_case's):
    real_step at the denoise path's full shape and a ragged one (nvalid,
    denom), and with lane segments and relu; the real_mlp pair (dcoords
    included) at the SISR path's full shape and a ragged one, each basis
    kind, lane segments and row_gamma."""
    cases = {}
    for which, n, nvalid, denom in (("full", 256 * 256, None, None),
                                    ("ragged", 700, 650, 650 * 3.0 + 1.0)):
        canon, kinds = path_canon(torch, MM, model_a, 5, device)
        c, t, gt, _ = real_inputs(torch, n, 2, 3, 6, device)
        cases[f"real_step {which}"] = real_step_case(
            torch, RM, canon, c, t, kinds, nvalid=nvalid, denom=denom, gt=gt)
    pair_cases = {"full": (168 * 168, None, None, None),
                  "ragged": (700, None, None, None)}
    widths = (2, 48, 40, 3)
    for kind in ("qspline", "cspline", "sine", "gauss", "relu", "srelu",
                 "identity"):
        pair_cases[kind] = (700, widths, (kind, kind), None)
    pair_cases["segments"] = (700, widths, ((("qspline", 20),
                                             ("identity", 10),
                                             ("sine", 10)), "srelu"), None)
    pair_cases["row_gamma"] = (1000, widths, ("qspline", "gauss"),
                               ((1.0, 0.5, 0.25, 2.0), 250))
    for which, (n, w, kinds, row_gamma) in pair_cases.items():
        if w is None:
            canon, kinds = path_canon(torch, MM, model_b, 7, device)
        else:
            canon = random_canon(torch, w, 8, device)
        c, _, _, g = real_inputs(torch, n, 2, 3, 9, device)
        cases[f"real_mlp {which}"] = real_pair_case(torch, RM, canon, c, g,
                                                    kinds, row_gamma)
    canon = random_canon(torch, widths, 10, device)
    c, t, gt, _ = real_inputs(torch, 700, 2, 3, 11, device)
    cases["real_step segments_step"] = real_step_case(
        torch, RM, canon, c, t, ((("qspline", 20), ("identity", 10),
                                  ("sine", 10)), "relu"), gt=gt)
    return cases


def relu_pattern_reference(torch, RM, pair, what):
    """The outputs param_vjp gives for a relu pair, from the plain canonical
    MLP run in float64 on the kernel's own relu pattern: every input cast,
    each layer's relu B(v) = m v and dB(v) = m with m = [a > 0] of the
    kernel's activations a (its forward's, which keeps them; the backward
    decides from the same v).  Checks the pattern against the float64
    run's: wherever they differ, |v| of the float64 run lies within REL_TOL
    x its layer's max |v| of the kink.  Returns (the outputs, {"flips": per
    layer, "flip_v_rel": the largest such |v| / max |v|})."""
    canon, x, kinds, cot = (pair[k] for k in ("canon", "x", "kinds", "cot"))
    if pair["dcoords"] or any(k != "relu" for k in kinds):
        raise AssertionError(f"{what}: the relu pattern reference takes "
                             f"relu pairs without dcoords")
    _, _, acts = RM._forward(canon, x, kinds, None, keep=True)
    masks = [(a > 0).double() for a in acts]
    leaves = [t.detach().double().requires_grad_(True)
              for _, t in RM.canon_leaves(canon)]
    c64 = RM.canon_from_leaves(leaves, len(kinds))
    a, a_free, flips, worst = x.double(), x.double(), [], 0.0
    for lay, m in zip(c64["layers"], masks):
        a = m * (lay["alpha"] * (a @ lay["w"]) + lay["beta"])
        v = (lay["alpha"] * (a_free @ lay["w"]) + lay["beta"]).detach()
        differ = (v > 0).double() != m
        scale = float(v.abs().max())
        flip_v = float(v[differ].abs().max()) / scale if differ.any() else 0.
        if not flip_v <= REL_TOL:
            raise AssertionError(
                f"{what}: the kernel's relu decision differs from float64's "
                f"at |v| = {flip_v:.3e} x max|v|, past {REL_TOL}")
        flips.append(int(differ.sum()))
        worst = max(worst, flip_v)
        a_free = torch.relu(v)
    y = a @ c64["final"]["w"] + c64["final"]["b"]
    grads = torch.autograd.grad(y, leaves, cot.double())
    want = {"out": y.detach()}
    want.update({f"d{i + 1}": g for i, g in enumerate(grads)})
    return want, {"flips": flips, "flip_v_rel": worst}


def relu_pattern_step_reference(torch, RM, canon, x, target, kinds, kw,
                                acts, what):
    """The outputs real_step gives for an all-relu canonical MLP
    (real_step_tensors), from the plain canonical step run in float64 on
    the kernel's own relu pattern: every input cast, each layer's relu
    B(v) = m v and dB(v) = m with m = [a > 0] of the kernel's activations
    ``acts`` (its step's scratch keeps them), the loss sum_{rows < nvalid}
    (y - t)^2 / denom (``kw``'s nvalid and denom; gt defaults to the
    target).  Checks the pattern against the float64 run's, as
    relu_pattern_reference does.  Returns (the outputs, {"flips": per
    layer, "flip_v_rel": the largest such |v| / max |v|})."""
    if any(k != "relu" for k in kinds):
        raise AssertionError(f"{what}: the relu pattern reference takes "
                             f"all-relu steps")
    masks = [(a > 0).double() for a in acts]
    leaves = [t.detach().double().requires_grad_(True)
              for _, t in RM.canon_leaves(canon)]
    c64 = RM.canon_from_leaves(leaves, len(kinds))
    t64 = target.double()
    g64 = t64 if kw.get("gt") is None else kw["gt"].double()
    n, o = t64.shape
    nvalid = n if kw.get("nvalid") is None else int(kw["nvalid"])
    denom = float(n * o) if kw.get("denom") is None else kw["denom"]
    rows = (torch.arange(n, device=t64.device)[:, None] < nvalid).double()
    a, a_free, flips, worst = x.double(), x.double(), [], 0.0
    with torch.enable_grad():
        for lay, m in zip(c64["layers"], masks):
            a = m * (lay["alpha"] * (a @ lay["w"]) + lay["beta"])
            v = (lay["alpha"] * (a_free @ lay["w"]) + lay["beta"]).detach()
            differ = (v > 0).double() != m
            scale = float(v.abs().max())
            flip_v = (float(v[differ].abs().max()) / scale if differ.any()
                      else 0.0)
            if not flip_v <= REL_TOL:
                raise AssertionError(
                    f"{what}: the kernel's relu decision differs from "
                    f"float64's at |v| = {flip_v:.3e} x max|v|, past "
                    f"{REL_TOL}")
            flips.append(int(differ.sum()))
            worst = max(worst, flip_v)
            a_free = torch.relu(v)
        y = a @ c64["final"]["w"] + c64["final"]["b"]
        err = (y - t64) * rows
        grads = torch.autograd.grad((err * err).sum() / denom, leaves)
    y, err = y.detach(), err.detach()
    eg = (y - g64) * rows
    return real_step_tensors(
        RM, y, RM.canon_from_leaves(list(grads), len(kinds)),
        ((err * err).sum(), (eg * eg).sum())), {"flips": flips,
                                                "flip_v_rel": worst}


def real_check(case, what):
    """The case's kernel outputs against its reference, with compare(): the
    plain version run in float64 for REAL_FLOAT64_CASES (on the kernel's
    relu pattern for REAL_RELU_PATTERN_CASES), else in fp32.  Returns (max
    abs err, the kernel's outputs)."""
    kernel, plain, args, kwargs = case[:4]
    got = kernel()
    if what in REAL_RELU_PATTERN_CASES:
        return compare(got, case[4](what)[0], what), got
    if what in REAL_FLOAT64_CASES:
        return compare_float64(got, plain, args, kwargs, what)[0], got
    return compare(got, plain(*args, **kwargs), what), got


def real_kernel_vs_plain(torch, RM, MM, model_a, model_b, device):
    """max abs err of real_step and real_mlp against their references
    (real_check) at the cases of real_cases; two calls of the full and
    ragged step and of the full and ragged pair giving identical bits."""
    errs = {"real_step": {}, "real_mlp": {}}
    for what, case in real_cases(torch, RM, MM, model_a, model_b,
                                 device).items():
        name, which = what.split(" ")
        errs[name][which], got = real_check(case, what)
        torch.cuda.synchronize()
        if which in ("full", "ragged"):
            same_bits(torch, case[0](), got, what)
    return errs


def check_nograd(torch, forward, with_grad, pingpong, what):
    """Runs ``forward()`` (a pair's forward) without a gradient: its output
    must equal the pair's, ``with_grad``, and its peak memory stay within
    ``pingpong`` bytes (two ping-pong planes) + 16 MiB.  Returns (peak MB,
    ping-pong MB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        y = forward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    slack = 16 * 2 ** 20
    if not torch.equal(y, with_grad):
        raise AssertionError(f"{what} without a gradient differs from the "
                             f"pair's forward")
    if not peak <= pingpong + slack:
        raise AssertionError(f"{what} without a gradient peaked at {peak} "
                             f"bytes, more than two ping-pong planes "
                             f"({pingpong}) + {slack}")
    return peak / 1e6, pingpong / 1e6


def repaired_faults(torch, WM, R, ct_model, device):
    """The port's repaired faults, kernel against plain: wire_mlp on (b, N,
    2) coordinates; wire_mlp without a gradient (the pair's output, and a
    peak of two ping-pong planes); rotsum on a non-square image."""
    import numpy as np
    errs = {}
    spec = ct_model.spec
    params = ct_model.init(torch.Generator().manual_seed(12), device)
    keys = leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    rng = np.random.default_rng(13)
    c = torch.tensor(rng.uniform(-1, 1, (4, 50, 2)).astype(np.float32),
                     device=device)
    g = torch.tensor(rng.normal(size=(4, 50, 1)).astype(np.float32),
                     device=device)
    got = vjp(torch, pair_fn(WM.wire_mlp, spec, keys), [c] + leaves, g)
    want = vjp(torch, pair_fn(WM.wire_mlp_plain, spec, keys), [c] + leaves,
               g)
    if got["out"].shape != (4, 50, 1):
        raise AssertionError(f"wire_mlp (4, 50, 2): output shape "
                             f"{tuple(got['out'].shape)}")
    errs["wire_mlp_batched"] = compare(got, want, "wire_mlp (4, 50, 2)")

    n = 256 * 256
    c = torch.tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                     device=device)
    grad_leaves = [t.detach().requires_grad_(True) for t in leaves]
    with_grad = WM.wire_mlp(tree_unflatten(keys, grad_leaves), c,
                            spec).detach()
    del grad_leaves
    h = params["first"]["w"].shape[1]
    errs["wire_mlp_nograd_peak_mb"], errs["wire_mlp_nograd_pingpong_mb"] = \
        check_nograd(torch, lambda: WM.wire_mlp(params, c, spec), with_grad,
                     2 * n * 2 * h * 4, "wire_mlp")

    angles = np.array([0.0, 7.3, 44.9, 90.0, 121.7, 180.0, -13.4, 315.0],
                      np.float32)
    img = torch.tensor(rng.random((96, 128)).astype(np.float32),
                       device=device)
    cot = torch.tensor(rng.normal(size=(len(angles), 128)).astype(
        np.float32), device=device)
    got = vjp(torch, lambda x: R.rotate_project(x, angles), [img], cot)
    want = vjp(torch, lambda x: R.rotate_project_plain(x, angles), [img],
               cot)
    errs["rotsum_96x128"] = compare(got, want, "rotsum 96 x 128")
    return errs


def real_matmul_vjp(torch, RM, canon, x, kinds, cotangent,
                    want_dcoords=False):
    """The canonical forward and its backward as torch.matmul calls with
    the bases and their derivatives in PyTorch ops, written out, for the
    output cotangent ``cotangent(y)``: the library yardstick (not used by
    the port).  Returns (y, dcanon, dcoords or None)."""
    zs, acts, a = [], [], x
    for lay, kind in zip(canon["layers"], kinds):
        z = a @ lay["w"]
        zs.append(z)
        a = RM._apply_segments(kind, lay["alpha"] * z + lay["beta"], 0)
        acts.append(a)
    y = torch.addmm(canon["final"]["b"], a, canon["final"]["w"])
    g = cotangent(y)
    dfinal = {"w": acts[-1].t() @ g, "b": g.sum(0)}
    da = g @ canon["final"]["w"].t()
    dlayers = [None] * len(zs)
    for l in reversed(range(len(zs))):
        lay = canon["layers"][l]
        dv = RM._apply_segments(kinds[l], lay["alpha"] * zs[l] + lay["beta"],
                                1) * da
        dz = lay["alpha"] * dv
        a_prev = x if l == 0 else acts[l - 1]
        dlayers[l] = {"w": a_prev.t() @ dz, "alpha": (zs[l] * dv).sum(0),
                      "beta": dv.sum(0)}
        if l > 0 or want_dcoords:
            da = dz @ lay["w"].t()
    return y, {"layers": dlayers, "final": dfinal}, (
        da if want_dcoords else None)


def real_matmul_step(torch, RM, canon, x, target, gt, kinds):
    """The masked-MSE train step through ``real_matmul_vjp``."""
    n, o = target.shape
    y, dcanon, _ = real_matmul_vjp(
        torch, RM, canon, x, kinds, lambda y: (2.0 / (n * o)) * (y - target))
    et, eg = y - target, y - gt
    return y, dcanon, ((et * et).sum(), (eg * eg).sum())


def real_measure(torch, SW, RM, MM, model_a, model_b, device, build):
    """Times of real_step at the denoise shape and of real_mlp's pair
    (dcoords included) at the SISR shape: the kernel (a host call, and its
    kernels' device time, by product class), the plain version, the matmul
    yardstick, and the card's least time for the same work
    (tensor_core_fields); and real_step at the sweep's siren cell
    (siren_step_measure)."""
    out = {}
    n = 256 * 256
    canon, kinds = path_canon(torch, MM, model_a, 14, device)
    widths = [2] + [lay["w"].shape[1] for lay in canon["layers"]] + [3]
    nweights = sum(t.numel() for _, t in RM.canon_leaves(canon))
    c, t, gt, _ = real_inputs(torch, n, 2, 3, 15, device)
    from wire_tpu_torch.ops.wire_step import StepScratch
    scratch = StepScratch()

    def step():
        return RM.real_step(canon, c, t, kinds, gt=gt, want_metrics=True,
                            scratch=scratch)

    lib_err = compare(
        real_step_tensors(RM, *real_matmul_step(torch, RM, canon, c, t, gt,
                                                kinds)),
        real_step_tensors(RM, *RM.real_step_plain(canon, c, t, kinds, gt=gt,
                                                  want_metrics=True)),
        "real matmul step vs plain")
    flops = RM.step_flops(n, widths)
    nbytes = 4 * (n * (2 + 3 + 3) + nweights + n * 3 + nweights + 2)
    res = {
        "ms": cuda_ms(torch, step, 20),
        "kernel_ms": kernel_device_ms(torch, step, 20,
                                      kernel_names("real_mlp")),
        "plain_ms": cuda_ms(torch, lambda: RM.real_step_plain(
            canon, c, t, kinds, gt=gt, want_metrics=True), 20),
        "library_ms": cuda_ms(torch, lambda: real_matmul_step(
            torch, RM, canon, c, t, gt, kinds), 20),
        "library": "torch.matmul step, bases and written-out backward in "
                   "PyTorch ops",
        "library_vs_plain_max_abs_err": lib_err}
    res.update(tensor_core_fields(torch, build, step, "real_step", flops,
                                  nbytes, res["kernel_ms"], lib="real_mlp"))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["real_step"] = res
    del scratch

    n = 168 * 168
    canon, kinds = path_canon(torch, MM, model_b, 16, device)
    L = len(canon["layers"])
    c, _, _, g = real_inputs(torch, n, 2, 3, 17, device)
    xs = [c] + [t for _, t in RM.canon_leaves(canon)]
    kfn = real_mlp_fn(RM, L, kinds)
    pfn = real_mlp_fn(RM, L, kinds, plain=True)

    def pair():
        return vjp(torch, kfn, xs, g)

    def fwd():
        with torch.no_grad():
            kfn(*xs)

    lib = real_matmul_vjp(torch, RM, canon, c, kinds, lambda y: g,
                          want_dcoords=True)
    got = {"out": lib[0], "d0": lib[2]}
    got.update({f"d{i + 1}": tt for i, (_, tt) in
                enumerate(RM.canon_leaves(lib[1]))})
    want = vjp(torch, pfn, xs, g)
    flops = RM.apply_flops(n, widths)
    nbytes = 4 * (2 * (n * 2 + n * 3 + nweights))
    res = {
        "ms": cuda_ms(torch, pair, 20),
        "kernel_ms": kernel_device_ms(torch, pair, 20,
                                      kernel_names("real_mlp")),
        "fwd_ms": cuda_ms(torch, fwd, 20),
        "plain_ms": cuda_ms(torch, lambda: vjp(torch, pfn, xs, g), 20),
        "library_ms": cuda_ms(torch, lambda: real_matmul_vjp(
            torch, RM, canon, c, kinds, lambda y: g, want_dcoords=True), 20),
        "library": "torch.matmul forward, bases and written-out backward in "
                   "PyTorch ops",
        "library_vs_plain_max_abs_err": max(
            float((got[k] - want[k]).abs().max()) for k in want)}
    res.update(tensor_core_fields(torch, build, pair, "real_mlp", flops,
                                  nbytes, res["kernel_ms"]))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["real_mlp"] = res
    out["real_step"]["siren_mixed_codes"] = siren_step_measure(
        torch, SW, RM, MM, device)
    return out


def siren_step_measure(torch, SW, RM, MM, device):
    """real_step at the sweep's siren denoise cell (65,536 rows, its
    seed-0 init through the siren fold): every column's basis is sine,
    which the tensor-core epilogues call out of line (csrc/real_tc.cuh:
    with_basis), the path the B-spline steps never take.  Its host call,
    its kernels' device time by product class and its rate."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    task, side, o, tau = SWEEP_SHAPES[0]
    n = side * side
    model = SW._build("siren", task, side, side, tau, out_features=o)
    params = model.init(torch.Generator().manual_seed(0), device)
    canon = MM._canon_siren(params, model.spec)
    kinds = ("sine",) * len(canon["layers"])
    c = torch.tensor(SW.C.grid2d(side, side), device=device)
    _, t, gt, _ = real_inputs(torch, n, 2, o, 41, device)
    widths = RM._widths(canon, 2)
    scratch = StepScratch()

    def step():
        return RM.real_step(canon, c, t, kinds, gt=gt, want_metrics=True,
                            scratch=scratch)
    by = kernel_breakdown(torch, step, 20)
    names = kernel_names("real_mlp")
    kernel_ms = sum(v[0] for k, v in by.items()
                    if any(name in k for name in names))
    flops = RM.step_flops(n, widths)
    return {"widths": widths, "ms": cuda_ms(torch, step, 20),
            "kernel_ms": kernel_ms,
            "classes_ms": {
                cls: sum(v[0] for k, v in by.items()
                         if any(f in k for f in frags))
                for cls, frags in TENSOR_CORE_CLASSES["real_step"].items()},
            "achieved_tflops": flops / (kernel_ms * 1e9) if kernel_ms
            else None}


def ops_launches(module):
    """{direction: launches} of an ``ops`` module's kernels in this process
    (``profiling.launches``); ``module`` the module or its name."""
    from wire_tpu_torch.train import profiling
    if not isinstance(module, str):
        module = module.__name__.rsplit(".", 1)[-1]
    return profiling.launches(module)


def wire_step_launches():
    return ops_launches("wire_step")["step"]


class Counts:
    """The launch counters of some ``ops`` modules and of ``wire_step``,
    read as the launches since the last ``reset``."""

    def __init__(self, *modules):
        self.modules = modules
        self.reset()

    def reset(self):
        self.base = {m: ops_launches(m)
                     for m in self.modules + ("wire_step",)}

    def since(self, module):
        return {k: v - self.base[module][k]
                for k, v in ops_launches(module).items()}

    def read(self):
        """{module: {direction: launches since the reset}}."""
        return {m: self.since(m) for m in self.modules}


def reset_counts(counters):
    counters.reset()


def read_counts(counters):
    return counters.read()


def check_real_launches(launches, what, want):
    """Every count is zero but the named ones, which are as given."""
    for name, counts in launches.items():
        for k, v in counts.items():
            if v != want.get((name, k), 0):
                raise AssertionError(
                    f"{what}: {name} {k} launched {v} times, expected "
                    f"{want.get((name, k), 0)}")


def fit_real(torch, np, mods, counters, device):
    """B-spline denoise (path A) for REAL_ITERS epochs through fit_pointwise:
    once through the kernel, counts reset just before and read just after,
    once through the plain path (the family's own apply, the relu^2 spline,
    and autograd), and once through the kernel's plain version in the same
    canonical fold (real_step_plain in place of the kernel), from one
    init."""
    TD, TC, M, RM, get_inr, get_config, FitConfig, fit_pointwise = mods
    cfg = get_config(REAL_DENOISE_CONFIG)
    im, im_noisy = TD.denoise_images(cfg)
    H, W, _ = im.shape
    model, plain = real_models(get_inr, TC, cfg, 7.0, H)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = TD.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=REAL_ITERS,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
    reset_counts(counters)
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                        fit_cfg, gt=im.reshape(-1, 3), device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "B-spline denoise",
                        {("real_mlp", "step"): REAL_ITERS})
    res_plain = fit_pointwise(plain, params, grid, im_noisy.reshape(-1, 3),
                              fit_cfg, gt=im.reshape(-1, 3), device=device)
    kernel_step = RM.real_step
    RM.real_step = lambda canon, x, t, kinds, scratch=None, **kw: \
        RM.real_step_plain(canon, x, t, kinds, **kw)
    try:
        res_canon = fit_pointwise(model, params, grid,
                                  im_noisy.reshape(-1, 3), fit_cfg,
                                  gt=im.reshape(-1, 3), device=device)
    finally:
        RM.real_step = kernel_step
    if read_counts(counters) != launches:
        raise AssertionError("B-spline denoise: a plain fit launched a "
                             "kernel")
    for r in (res, res_plain, res_canon):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H * W, 3)):
            raise AssertionError("B-spline denoise: non-finite values or a "
                                 "wrong shape")
    psnr, psnr_plain, psnr_canon = (
        float(M.psnr_ref(im, r.best_rec.reshape(H, W, 3)))
        for r in (res, res_plain, res_canon))
    for what, other in (("plain", psnr_plain),
                        ("canonical plain", psnr_canon)):
        if not abs(psnr - other) <= PSNR_AGREE_DB:
            raise AssertionError(
                f"B-spline denoise: kernel fit {psnr:.3f} dB vs {what} fit "
                f"{other:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_REAL_DB["denoise"] - 0.2
    if not psnr >= floor:
        raise AssertionError(f"B-spline denoise: kernel fit best PSNR "
                             f"{psnr:.3f} dB below the floor {floor} dB")
    return dict(config=REAL_DENOISE_CONFIG, epochs=REAL_ITERS,
                launches=launches["real_mlp"], psnr_db=psnr,
                psnr_plain_db=psnr_plain, psnr_canonical_plain_db=psnr_canon,
                floor_db=floor, ms_per_step=res.step_ms,
                plain_ms_per_step=res_plain.step_ms,
                canonical_plain_ms_per_step=res_canon.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def fit_sisr(torch, np, mods, counters, device):
    """B-spline SISR (path B) for REAL_ITERS iterations through
    fit_operator, through the kernels and the plain path, from one init."""
    TS, TC, TF, M, get_inr, get_config, FitConfig, fit_operator = mods
    cfg = get_config(REAL_SISR_CONFIG)
    scale = cfg.down_scale
    im, im_lr = TS.sisr_images(None, 0, scale)
    H, W, _ = im.shape
    model, plain = real_models(get_inr, TC, cfg, 8.0, H)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = TS.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=REAL_ITERS,
                        maxpoints=cfg.maxpoints, lr_decay=0.2)
    op = TF.DownsampleOp(scale)
    reset_counts(counters)
    res = fit_operator(model, params, grid, im_lr, op, fit_cfg, gt_field=im,
                       field_shape=(H, W, 3), track="gt", device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "B-spline SISR",
                        {("real_mlp", "forward"): REAL_ITERS,
                         ("real_mlp", "backward"): REAL_ITERS})
    res_plain = fit_operator(plain, params, grid, im_lr, op, fit_cfg,
                             gt_field=im, field_shape=(H, W, 3), track="gt",
                             device=device)
    if read_counts(counters) != launches:
        raise AssertionError("B-spline SISR: the plain fit launched a "
                             "kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H, W, 3)):
            raise AssertionError("B-spline SISR: non-finite values or a "
                                 "wrong shape")
    db, db_plain = M.mse_db(res.best_mse), M.mse_db(res_plain.best_mse)
    if not abs(db - db_plain) <= PSNR_AGREE_DB:
        raise AssertionError(f"B-spline SISR: kernel fit {db:.3f} dB vs "
                             f"plain fit {db_plain:.3f} dB differ by more "
                             f"than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_REAL_DB["sisr"] - 0.2
    if not db >= floor:
        raise AssertionError(f"B-spline SISR: kernel fit best -10 log10(MSE) "
                             f"{db:.3f} dB below the floor {floor} dB")
    return dict(config=REAL_SISR_CONFIG, iters=REAL_ITERS,
                launches=launches["real_mlp"], mse_db=db,
                mse_db_plain=db_plain, floor_db=floor,
                ssim=float(M.ssim(im, res.best_rec, data_range=1.0)),
                ms_per_iter=res.step_ms, plain_ms_per_iter=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


MSCALE_SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
                      "hidden_layers", "scaled_hidden_features", "scale",
                      "scale_tensor", "detach_split", "combine_type")


def mscale2_models(get_inr, TC, cfg):
    """The mscale_2 denoise app's model (kernels), the same spec with
    fused='never' (the plain path), and a two-scale twin (the ragged
    kernel case)."""
    model = TC.build_model(cfg, in_features=2, out_features=3, omega0=7.0,
                           sidelength=256)
    kw = {f: getattr(model.spec, f) for f in MSCALE_SPEC_FIELDS}
    plain = get_inr(cfg.nonlin, fused="never", **kw)
    kw["scale_tensor"] = kw["scale_tensor"][:2]
    return model, plain, get_inr(cfg.nonlin, **kw)


def mscale2_fold(torch, MM, model, seed, device):
    """(canon, combiner, kinds, inv_scales) of a mscale_2 model's seeded
    init: the trunk's fold and the freq_combine heads."""
    params = model.init(torch.Generator().manual_seed(seed), device)
    comb = {k: params["combiner"][k] for k in ("freq_0", "freq_1")}
    return (MM._canon_mscale2(params, model.spec), comb,
            MM._mscale2_kinds(model.spec), MM._inv_scales(model.spec))


def mscale2_tensors(pred, dcanon, dcomb, sums):
    return tensors_of(pred, {"trunk": dcanon, "combiner": dcomb}, sums)


def mscale2_plain(MS):
    """mscale2_step_plain's outputs by name (mscale2_tensors)."""
    def plain(*args, **kwargs):
        return mscale2_tensors(*MS.mscale2_step_plain(*args, **kwargs))
    return plain


def mscale2_kernel_vs_plain(torch, MS, MM, models, device):
    """max abs err of mscale2_step from its plain version run in float64
    (compare_float64), every output tensor, at the path's full shape (n =
    65,536, ns = 3) and ragged ones where 128-row tiles straddle two scales
    (n = 700 with nvalid = 650 and denom at ns = 2 and 3; n = 65,537 at ns
    = 3); two calls bit-equal.  Also, not gated: the kernel's distance
    from the fp32 plain version and the fp32 plain version's from float64
    (max |a - b| / max |b| over the outputs)."""
    errs = {"kernel_vs_fp32_plain": {}, "fp32_plain_vs_float64": {}}
    plain = mscale2_plain(MS)
    for which, model, n, nvalid, denom in (
            ("full", models[0], 256 * 256, None, None),
            ("ragged", models[2], 700, 650, 650 * 3.0 + 1.0),
            ("ragged_ns3", models[0], 700, 650, 650 * 3.0 + 1.0),
            ("n65537_ns3", models[0], 256 * 256 + 1, 65000, None)):
        canon, comb, kinds, inv = mscale2_fold(torch, MM, model, 18, device)
        c, t, gt, _ = real_inputs(torch, n, 2, 3, 19, device)
        kw = dict(nvalid=nvalid, denom=denom, gt=gt, want_metrics=True)
        got, again = (mscale2_tensors(*MS.mscale2_step(
            canon, comb, c, t, kinds, inv, **kw)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, again, got, f"mscale2_step {which}")
        args = (canon, comb, c, t, kinds, inv)
        errs[which], want64 = compare_float64(got, plain, args, kw,
                                              f"mscale2_step {which}")
        want32 = plain(*args, **kw)
        errs["kernel_vs_fp32_plain"][which] = rel_distance(got, want32)
        errs["fp32_plain_vs_float64"][which] = rel_distance(want32, want64)
        del want32, want64
    return errs


def real_fold_cases(torch, RM, MM, get_inr, get_config, device):
    """{name: (kernel thunk, plain, args, kwargs)} of real_step at the folds
    of mscale_hier (lane segments 256 qspline + 5 or 261 identity, widths
    261 and 517; preset MscaleHier_ST1o9_LR8e3_E2000) and mscale_HL (a
    per-lane alpha over three bands; preset
    MscaleHL_s1o9_ST4_3_SHF384_LR8e3_E4000), at 4,099 rows with nvalid
    4,000."""
    cases = {}
    for which, name, canon_of, kinds_of in (
            ("hier_fold", "MscaleHier_ST1o9_LR8e3_E2000",
             MM._canon_mscale_hier, MM._hier_kinds),
            ("hl_fold", "MscaleHL_s1o9_ST4_3_SHF384_LR8e3_E4000",
             MM._canon_mscale_hl, MM._mscale_hl_kinds)):
        cfg = get_config(name)
        model = get_inr(cfg.nonlin, in_features=2, out_features=3,
                        hidden_features=cfg.hidden_features,
                        scaled_hidden_features=cfg.scaled_hidden_features,
                        scale=cfg.scale, scale_tensor=cfg.scale_tensor)
        params = model.init(torch.Generator().manual_seed(20), device)
        canon, kinds = canon_of(params, model.spec), kinds_of(model.spec)
        c, t, gt, _ = real_inputs(torch, 4099, 2, 3, 21, device)
        cases[f"real_step {which}"] = real_step_case(
            torch, RM, canon, c, t, kinds, nvalid=4000, gt=gt)
    return cases


def multiscale_fold_vs_plain(torch, RM, MM, get_inr, get_config, device):
    """real_step's kernel against its reference (real_check) at the folds
    of real_fold_cases."""
    return {what.split(" ")[1]: real_check(case, what)[0]
            for what, case in real_fold_cases(torch, RM, MM, get_inr,
                                              get_config, device).items()}


def mscale2_matmul_step(torch, RM, canon, comb, x, target, gt, kinds, inv):
    """The mscale_2 step as torch.matmul calls on the stacked scales, the
    bases and their derivatives in PyTorch ops and the backward written
    out: the library yardstick (not used by the port).  Returns (pred,
    dcanon, dcombiner, (sse_target, sse_gt))."""
    n, o = target.shape
    ns = len(inv)
    X = x.repeat(ns, 1)
    gam = torch.tensor(inv, device=x.device).repeat_interleave(n)[:, None]
    zs, acts, a = [], [], X
    for lay, kind in zip(canon["layers"], kinds):
        z = a @ lay["w"]
        zs.append(z)
        a = RM._apply_segments(kind, gam * (lay["alpha"] * z + lay["beta"]),
                               0)
        acts.append(a)
    ys = torch.addmm(canon["final"]["b"], a, canon["final"]["w"])
    cat = ys.reshape(ns, n, o).permute(1, 0, 2).reshape(n, ns * o)
    F0, f0 = comb["freq_0"]["w"], comb["freq_0"]["b"]
    F1, f1 = comb["freq_1"]["w"], comb["freq_1"]["b"]
    u0 = torch.addmm(f0, cat, F0)
    u = torch.relu(u0)
    y = torch.addmm(f1, u, F1)
    e = (2.0 / (n * o)) * (y - target)
    du = (e @ F1.t()) * (u0 > 0)
    dcomb = {"freq_0": {"w": cat.t() @ du, "b": du.sum(0)},
             "freq_1": {"w": u.t() @ e, "b": e.sum(0)}}
    g = (du @ F0.t()).reshape(n, ns, o).permute(1, 0, 2).reshape(ns * n, o)
    dfinal = {"w": acts[-1].t() @ g, "b": g.sum(0)}
    da = g @ canon["final"]["w"].t()
    dlayers = [None] * len(zs)
    for l in reversed(range(len(zs))):
        lay = canon["layers"][l]
        v = gam * (lay["alpha"] * zs[l] + lay["beta"])
        dv = gam * RM._apply_segments(kinds[l], v, 1) * da
        dz = lay["alpha"] * dv
        a_prev = X if l == 0 else acts[l - 1]
        dlayers[l] = {"w": a_prev.t() @ dz, "alpha": (zs[l] * dv).sum(0),
                      "beta": dv.sum(0)}
        if l > 0:
            da = dz @ lay["w"].t()
    et, eg = y - target, y - gt
    return y, {"layers": dlayers, "final": dfinal}, dcomb, (
        (et * et).sum(), (eg * eg).sum())


def mscale2_measure(torch, MS, RM, MM, model, device, build):
    """Times of mscale2_step at the path's shape: the kernel (a host call,
    and its kernels' device time, by product class), the plain version, the
    matmul yardstick, and the card's least time for the same work
    (tensor_core_fields)."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    n = 256 * 256
    canon, comb, kinds, inv = mscale2_fold(torch, MM, model, 22, device)
    c, t, gt, _ = real_inputs(torch, n, 2, 3, 23, device)
    widths = [2] + [lay["w"].shape[1] for lay in canon["layers"]] + [3]
    nweights = num_weights(canon) + num_weights(comb)
    scratch = StepScratch()

    def step():
        return MS.mscale2_step(canon, comb, c, t, kinds, inv, gt=gt,
                               want_metrics=True, scratch=scratch)

    def plain():
        return MS.mscale2_step_plain(canon, comb, c, t, kinds, inv, gt=gt,
                                     want_metrics=True)

    def library():
        return mscale2_matmul_step(torch, RM, canon, comb, c, t, gt, kinds,
                                   inv)

    lib_err = compare(mscale2_tensors(*library()), mscale2_tensors(*plain()),
                      "mscale2 matmul step vs plain")
    flops = MS.step_flops(n, len(inv), widths)
    nbytes = 4 * (n * (2 + 3 + 3) + nweights + n * 3 + nweights + 2)
    res = {
        "ms": cuda_ms(torch, step, 20),
        "kernel_ms": kernel_device_ms(torch, step, 20,
                                      kernel_names("mscale2_step")),
        "plain_ms": cuda_ms(torch, plain, 10),
        "library_ms": cuda_ms(torch, library, 10),
        "library": "torch.matmul step on the stacked scales, bases and "
                   "written-out backward in PyTorch ops",
        "library_vs_plain_max_abs_err": lib_err}
    res.update(tensor_core_fields(torch, build, step, "mscale2_step", flops,
                                  nbytes, res["kernel_ms"]))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    return res


def fit_mscale2(torch, np, mods, counters, device):
    """mscale_2 denoise for REAL_ITERS epochs through fit_pointwise: once
    through the kernel, counts reset just before and read just after, and
    once through the plain path (the family's own apply, the relu^2 spline,
    and autograd), from one init."""
    TD, TC, M, get_inr, get_config, FitConfig, fit_pointwise = mods
    cfg = get_config(MSCALE2_CONFIG)
    im, im_noisy = TD.denoise_images(cfg)
    H, W, _ = im.shape
    model, plain, _ = mscale2_models(get_inr, TC, cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = TD.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=REAL_ITERS,
                        maxpoints=cfg.maxpoints, scale_lr_by_batch=True)
    reset_counts(counters)
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                        fit_cfg, gt=im.reshape(-1, 3), device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "mscale_2 denoise",
                        {("mscale2_step", "step"): REAL_ITERS})
    res_plain = fit_pointwise(plain, params, grid, im_noisy.reshape(-1, 3),
                              fit_cfg, gt=im.reshape(-1, 3), device=device)
    if read_counts(counters) != launches:
        raise AssertionError("mscale_2 denoise: the plain fit launched a "
                             "kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H * W, 3)):
            raise AssertionError("mscale_2 denoise: non-finite values or a "
                                 "wrong shape")
    psnr, psnr_plain = (float(M.psnr_ref(im, r.best_rec.reshape(H, W, 3)))
                        for r in (res, res_plain))
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(
            f"mscale_2 denoise: kernel fit {psnr:.3f} dB vs plain fit "
            f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_MSCALE2_DB - 0.2
    if not psnr >= floor:
        raise AssertionError(f"mscale_2 denoise: kernel fit best PSNR "
                             f"{psnr:.3f} dB below the floor {floor} dB")
    return dict(config=MSCALE2_CONFIG, epochs=REAL_ITERS,
                launches=launches["mscale2_step"], psnr_db=psnr,
                psnr_plain_db=psnr_plain, floor_db=floor,
                ms_per_step=res.step_ms, plain_ms_per_step=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


MFN_SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
                   "hidden_layers")


def mfn_models(get_inr, SW, task, H, W):
    """The sweep app's MFN model for a task (kernels) and the same spec with
    fused='never' (the plain path)."""
    model = SW._build("mfn", task, H, W, 3e1 if task == "denoise" else 1e2)
    plain = get_inr("mfn", fused="never", **{
        f: getattr(model.spec, f) for f in MFN_SPEC_FIELDS})
    return model, plain


def mfn_case(torch, get_inr, n, d, h, layers, o, seed, device):
    """An MFN of the given shape, its seeded init and numpy-seeded inputs:
    (model, params, coords, target, gt, cotangent)."""
    import numpy as np
    model = get_inr("mfn", in_features=d, out_features=o, hidden_features=h,
                    hidden_layers=layers)
    params = model.init(torch.Generator().manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(-1, 1, (n, d)), rng.uniform(0, 1, (n, o)),
            rng.uniform(0, 1, (n, o)), rng.normal(size=(n, o)))
    return (model, params) + tuple(
        torch.tensor(a.astype(np.float32), device=device) for a in arrs)


def param_vjp(torch, fn, coords, leaves, cot):
    """vjp() with constant coordinates (no dcoords, as in every fit)."""
    xs = [x.detach().requires_grad_(True) for x in leaves]
    out = fn(coords, *xs)
    grads = torch.autograd.grad(out, xs, cot, allow_unused=True)
    res = {"out": out.detach()}
    res.update({f"d{i + 1}": torch.zeros_like(x) if g is None else g
                for i, (x, g) in enumerate(zip(xs, grads))})
    return res


def same_bits(torch, a, b, what):
    for name in b:
        if not torch.equal(a[name], b[name]):
            raise AssertionError(f"{what}: two calls differ in {name}")


def mfn_step_plain(MF):
    """mfn_step_plain's outputs by name (tensors_of)."""
    def plain(*args, **kwargs):
        return tensors_of(*MF.mfn_step_plain(*args, **kwargs))
    return plain


def mfn_pair_plain(torch, MF, spec, keys, dcoords=True):
    """(inputs, cot) -> the plain pair's vjp() (with dcoords) or param_vjp()
    (without), inputs = [coords] + leaves."""
    fn = pair_fn(MF.mfn_mlp_plain, spec, keys)

    def plain(inputs, cot):
        if dcoords:
            return vjp(torch, fn, inputs, cot)
        return param_vjp(torch, fn, inputs[0], inputs[1:], cot)
    return plain


def mfn_step_case(torch, MF, params, c, t, spec, **kw):
    """(kernel thunk, plain, args, kwargs) of one mfn_step case; the
    kernel's calls share one scratch."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    kw = dict(kw, want_metrics=True)
    scratch = StepScratch()
    return (lambda: tensors_of(*MF.mfn_step(params, c, t, spec,
                                            scratch=scratch, **kw)),
            mfn_step_plain(MF), (params, c, t, spec), kw)


def mfn_pair_case(torch, MF, params, c, cot, spec, dcoords=True):
    """(kernel thunk, plain, args, kwargs) of one mfn_mlp pair case."""
    keys = leaf_paths(params)
    inputs = [c] + [t for _, t in tree_leaves(params)]
    fn = pair_fn(MF.mfn_mlp, spec, keys)

    def kernel():
        if dcoords:
            return vjp(torch, fn, inputs, cot)
        return param_vjp(torch, fn, c, inputs[1:], cot)
    return (kernel, mfn_pair_plain(torch, MF, spec, keys, dcoords),
            (inputs, cot), {})


def mfn_extreme_phase(torch, params, c):
    """Every filter's w scaled in place until max |x w| ~ 8,000 (the JAX
    package's extreme-phase case); returns that max."""
    qmax = 0.0
    for k in params:
        if k.startswith("gabor_"):
            w = params[k]["w"]
            params[k]["w"] = (w * (8000.0 / float((c @ w).abs().max()))
                              ).contiguous()
            qmax = max(qmax, float((c @ params[k]["w"]).abs().max()))
    return qmax


def mfn_cases(torch, MF, get_inr, device):
    """{name: (kernel thunk, plain, args, kwargs)} of mfn_kernel_vs_plain:
    the step at the denoise sweep's shape (n = 65,536, h = 300, metrics)
    and a ragged one (n = 700, nvalid 650, denom, d = 3, o = 1,
    hidden_layers 3); the pair at the SISR sweep's shape (n = 65,536,
    h = 256) with and without dcoords, on (4, 50, 2) coordinates and at
    the extreme phase |x w| ~ 8,000 (n = 512, h = 64)."""
    cases = {}
    for which, (n, d, h, layers, o, nvalid, denom) in {
            "full": (256 * 256, 2, 300, 2, 3, None, None),
            "ragged": (700, 3, 300, 3, 1, 650, 650 * 1.0 + 1.0)}.items():
        model, params, c, t, gt, _ = mfn_case(torch, get_inr, n, d, h,
                                              layers, o, 24, device)
        cases[f"mfn_step {which}"] = mfn_step_case(
            torch, MF, params, c, t, model.spec, nvalid=nvalid, denom=denom,
            gt=gt)
    model, params, c, _, _, g = mfn_case(torch, get_inr, 256 * 256, 2, 256,
                                         2, 3, 25, device)
    spec = model.spec
    cases["mfn_mlp full"] = mfn_pair_case(torch, MF, params, c, g, spec)
    cases["mfn_mlp no_dcoords"] = mfn_pair_case(torch, MF, params, c, g,
                                                spec, dcoords=False)
    cases["mfn_mlp batched"] = mfn_pair_case(
        torch, MF, params, c[:200].reshape(4, 50, 2),
        g[:200].reshape(4, 50, 3), spec)
    model, params, c, _, _, g = mfn_case(torch, get_inr, 512, 2, 64, 2, 3,
                                         26, device)
    qmax = mfn_extreme_phase(torch, params, c)
    if not qmax > 7e3:
        raise AssertionError(f"extreme phase: max |x w| {qmax}")
    cases["mfn_mlp extreme_phase"] = mfn_pair_case(torch, MF, params, c, g,
                                                   model.spec)
    return cases


def sweep_mfn_cases(torch, np, SW, MF, device):
    """{name: (kernel thunk, plain, args, kwargs)} of the MFN kernels the
    sweep phase launches, at the sweep's own shapes from the sweep's seed-0
    init (SW._build) on its coordinate grid: the step at denoise (65,536
    rows, o 3, metrics), the pair (parameter gradients) at SISR (65,536,
    o 3) and CT (262,144, o 1), the CT pair with dcoords as well."""
    cases = {}
    for task, side, o, tau in SWEEP_SHAPES:
        n = side * side
        rng = np.random.default_rng(40)
        coords = torch.tensor(SW.C.grid2d(side, side), device=device)
        t, gt, g = (torch.tensor(a.astype(np.float32), device=device)
                    for a in (rng.uniform(0, 1, (n, o)),
                              rng.uniform(0, 1, (n, o)),
                              rng.normal(size=(n, o))))
        model = SW._build("mfn", task, side, side, tau, out_features=o)
        params = model.init(torch.Generator().manual_seed(0), device)
        what = f"sweep {task} mfn"
        if task == "denoise":
            cases[what] = mfn_step_case(torch, MF, params, coords, t,
                                        model.spec, gt=gt)
            continue
        cases[what] = mfn_pair_case(torch, MF, params, coords, g, model.spec,
                                    dcoords=False)
        if task == "ct":
            cases[what + " dcoords"] = mfn_pair_case(torch, MF, params,
                                                     coords, g, model.spec)
    return cases


def mfn_check(case, what):
    """The case's kernel outputs against its plain version in fp32, with
    compare(): every MFN case's fp32 plain run lies within 6e-6 x max of
    its float64 run but the extreme phase's, whose point is q's rounding,
    which the kernels form as the plain version does
    (tools/port_mfn_reference.py, PERF.md section 2).  Returns (max abs
    err, the kernel's outputs)."""
    kernel, plain, args, kwargs = case
    got = kernel()
    return compare(got, plain(*args, **kwargs), what), got


def mfn_kernel_vs_plain(torch, MF, get_inr, device):
    """max abs err of mfn_step and of the mfn_mlp pair against their
    references (mfn_check) at the cases of mfn_cases; two calls of the full
    and ragged step and of the full pair giving identical bits; the pair
    without a gradient (equal output, no kept planes)."""
    errs = {"mfn_step": {}, "mfn_mlp": {}}
    outs = {}
    for what, case in mfn_cases(torch, MF, get_inr, device).items():
        name, which = what.split(" ")
        errs[name][which], outs[what] = mfn_check(case, what)
        torch.cuda.synchronize()
        if which in ("full", "ragged"):
            same_bits(torch, case[0](), outs[what], what)
    if outs["mfn_mlp batched"]["out"].shape != (4, 50, 3):
        raise AssertionError(f"mfn_mlp (4, 50, 2): output shape "
                             f"{tuple(outs['mfn_mlp batched']['out'].shape)}")
    model, params, c, _, _, _ = mfn_case(torch, get_inr, 256 * 256, 2, 256,
                                         2, 3, 25, device)
    errs["mfn_mlp"]["nograd_peak_mb"], errs["mfn_mlp"]["nograd_pingpong_mb"] \
        = check_nograd(torch, lambda: MF.mfn_mlp(params, c, model.spec),
                       outs["mfn_mlp full"]["out"], 2 * c.shape[0] * 256 * 4,
                       "mfn_mlp")
    return errs


# the sweep's tasks as the app sizes them: (task, field side, out features,
# tau of _build)
SWEEP_SHAPES = (("denoise", 256, 3, 3e1), ("sisr", 256, 3, 1e2),
                ("ct", 512, 1, 1e2))
# each real sweep family's fold onto the canonical kernels (nn/models.py):
# the fold and its basis; posenc is relu on encoded coordinates
SWEEP_REAL_FOLDS = {"siren": ("_canon_siren", "sine"),
                    "gauss": ("_canon_gauss", "gauss"),
                    "relu": ("_canon_relu", "relu"),
                    "posenc": ("_canon_relu", "relu")}


def sweep_real_cases(torch, np, SW, RM, MM, device):
    """{name: (kernel thunk, plain, args, kwargs[, pattern])} of the real
    kernels the sweep phase launches, at the sweep's own shapes from the sweep's seed-0
    init (SW._build) on its coordinate grid, each family through its fold
    (posenc on its encoded coordinates): real_step at denoise (65,536
    rows, o 3, metrics), the real_mlp pair (parameter gradients) at SISR
    (65,536, o 3) and CT (262,144, o 1)."""
    cases = {}
    for task, side, o, tau in SWEEP_SHAPES:
        n = side * side
        rng = np.random.default_rng(40)
        coords = torch.tensor(SW.C.grid2d(side, side), device=device)
        t, gt, g = (torch.tensor(a.astype(np.float32), device=device)
                    for a in (rng.uniform(0, 1, (n, o)),
                              rng.uniform(0, 1, (n, o)),
                              rng.normal(size=(n, o))))
        for nonlin, (fold, kind) in SWEEP_REAL_FOLDS.items():
            model = SW._build(nonlin, task, side, side, tau, out_features=o,
                              posenc_sidelength=100 if task == "ct" else None)
            params = model.init(torch.Generator().manual_seed(0), device)
            canon = getattr(MM, fold)(params, model.spec)
            kinds = (kind,) * len(canon["layers"])
            x = MM._posenc_pre(coords, model.spec)
            what = f"sweep {task} {nonlin}"
            if task == "denoise":
                cases[what] = real_step_case(torch, RM, canon, x, t, kinds,
                                             gt=gt)
            else:
                cases[what] = real_pair_case(torch, RM, canon, x, g, kinds,
                                             dcoords=False)
    return cases


def sweep_kernel_vs_plain(torch, np, SW, WS, WM, RM, MM, MF, device):
    """max abs err of every kernel the sweep phase launches against its
    plain version at the sweep's own shapes, each family from the sweep's
    seed-0 init (SW._build) on the sweep's coordinate grid: denoise (256^2
    = 65,536 rows, o 3) through the step kernels, with metrics; SISR (256^2
    HR, o 3) and CT (512^2 = 262,144 rows, o 1) through the pairs as a fit
    calls them (parameter gradients), mfn's CT pair with dcoords as well.
    siren, gauss, relu and posenc go through their fold (posenc on its
    encoded coordinates)."""
    errs = {name: {} for name in ("wire_step", "wire_mlp", "real_step",
                                  "real_mlp", "mfn_step", "mfn_mlp")}
    for task, side, o, tau in SWEEP_SHAPES:
        n = side * side
        rng = np.random.default_rng(40)
        coords = torch.tensor(SW.C.grid2d(side, side), device=device)
        t, gt, g = (torch.tensor(a.astype(np.float32), device=device)
                    for a in (rng.uniform(0, 1, (n, o)),
                              rng.uniform(0, 1, (n, o)),
                              rng.normal(size=(n, o))))
        for nonlin in SW.NONLINS:
            if nonlin == "mfn" or nonlin in SWEEP_REAL_FOLDS:
                continue  # sweep_mfn_cases, sweep_real_cases below
            model = SW._build(nonlin, task, side, side, tau, out_features=o,
                              posenc_sidelength=100 if task == "ct" else None)
            spec = model.spec
            params = model.init(torch.Generator().manual_seed(0), device)
            what = f"sweep {task} {nonlin}"
            if task == "denoise":
                got = tensors_of(*WS.wire_step(params, coords, t, spec, gt=gt,
                                               want_metrics=True))
                torch.cuda.synchronize()
                want = tensors_of(*WS.wire_step_plain(
                    params, coords, t, spec, gt=gt, want_metrics=True))
                errs["wire_step"][what] = compare(got, want, what)
                continue
            keys = leaf_paths(params)
            leaves = [v for _, v in tree_leaves(params)]
            kfn, pfn = (pair_fn(a, spec, keys)
                        for a in (WM.wire_mlp, WM.wire_mlp_plain))
            got = param_vjp(torch, kfn, coords, leaves, g)
            torch.cuda.synchronize()
            errs["wire_mlp"][what] = compare(
                got, param_vjp(torch, pfn, coords, leaves, g), what)
    for what, case in sweep_real_cases(torch, np, SW, RM, MM,
                                       device).items():
        name = "real_step" if what.startswith("sweep denoise") else \
            "real_mlp"
        errs[name][what] = real_check(case, what)[0]
        torch.cuda.synchronize()
    for what, case in sweep_mfn_cases(torch, np, SW, MF, device).items():
        name = "mfn_step" if what == "sweep denoise mfn" else "mfn_mlp"
        errs[name][what] = mfn_check(case, what)[0]
        torch.cuda.synchronize()
    return errs


def mfn_matmul_vjp(torch, params, x, cotangent, want_dcoords=False):
    """The MFN forward as torch.matmul calls with the filters in PyTorch
    ops, and its backward written out (mfn_step.py:115-153), for the output
    cotangent ``cotangent(y)``: the library yardstick (not used by the
    port).  Returns (y, grads, dcoords or None)."""
    k = sum(1 for name in params if name.startswith("gabor_"))

    def filt(p):
        q = torch.addmm(p["b"], x, p["w"])
        nrm = ((x * x).sum(-1, keepdim=True) + (p["mu"] * p["mu"]).sum(-1)
               - 2.0 * (x @ p["mu"].t()))
        return torch.exp(-0.5 * p["gamma"] * nrm), torch.sin(q), \
            torch.cos(q), nrm

    F = [filt(params[f"gabor_{j}"]) for j in range(k)]
    zs, ls = [F[0][0] * F[0][1]], [None]
    for j in range(1, k):
        lin = params[f"linear_{j - 1}"]
        ls.append(torch.addmm(lin["b"], zs[-1], lin["w"]))
        zs.append(ls[-1] * F[j][0] * F[j][1])
    fin = params["final"]
    y = torch.addmm(fin["b"], zs[-1], fin["w"])
    g = cotangent(y)
    grads = {"final": {"w": zs[-1].t() @ g, "b": g.sum(0)}}
    dc = torch.zeros_like(x) if want_dcoords else None

    def filt_grads(j, dg):
        nonlocal dc
        E, S, C, nrm = F[j]
        p = params[f"gabor_{j}"]
        es = dg * E
        dq, ges = es * C, es * S
        dn = (-0.5 * p["gamma"]) * ges
        grads[f"gabor_{j}"] = {
            "w": x.t() @ dq, "b": dq.sum(0),
            "gamma": -0.5 * (ges * nrm).sum(0),
            "mu": 2.0 * dn.sum(0)[:, None] * p["mu"] - 2.0 * (dn.t() @ x)}
        if want_dcoords:
            dc = (dc + dq @ p["w"].t() + 2.0 * dn.sum(1, keepdim=True) * x
                  - 2.0 * (dn @ p["mu"]))

    dz = g @ fin["w"].t()
    for j in range(k - 1, 0, -1):
        dl = dz * (F[j][0] * F[j][1])
        filt_grads(j, dz * ls[j])
        lin = params[f"linear_{j - 1}"]
        grads[f"linear_{j - 1}"] = {"w": zs[j - 1].t() @ dl, "b": dl.sum(0)}
        dz = dl @ lin["w"].t()
    filt_grads(0, dz)
    return y, grads, dc


def mfn_matmul_step(torch, params, x, target, gt):
    """The masked-MSE train step through ``mfn_matmul_vjp``."""
    n, o = target.shape
    y, grads, _ = mfn_matmul_vjp(
        torch, params, x, lambda y: (2.0 / (n * o)) * (y - target))
    et, eg = y - target, y - gt
    return y, grads, ((et * et).sum(), (eg * eg).sum())


def mfn_measure(torch, MF, get_inr, device, build):
    """Times of mfn_step at the denoise sweep's shape (n = 65,536, h = 300)
    and of the mfn_mlp pair (dcoords included) at the SISR sweep's shape
    (n = 65,536, h = 256): the kernel (a host call, and its kernels' device
    time, by product class), the plain version, the matmul yardstick, and
    the card's least time for the same work (tensor_core_fields)."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    out = {}
    n, d, h, layers, o = 256 * 256, 2, 300, 2, 3
    model, params, c, t, gt, _ = mfn_case(torch, get_inr, n, d, h, layers, o,
                                          27, device)
    spec = model.spec
    nweights = num_weights(params)
    scratch = StepScratch()

    def step():
        return MF.mfn_step(params, c, t, spec, gt=gt, want_metrics=True,
                           scratch=scratch)

    lib_err = compare(
        tensors_of(*mfn_matmul_step(torch, params, c, t, gt)),
        tensors_of(*MF.mfn_step_plain(params, c, t, spec, gt=gt,
                                      want_metrics=True)),
        "mfn matmul step vs plain")
    flops = MF.step_flops(n, d, h, o, layers + 1)
    nbytes = 4 * (n * (d + o + o) + nweights + n * o + nweights + 2)
    res = {
        "ms": cuda_ms(torch, step, 20),
        "kernel_ms": kernel_device_ms(torch, step, 20, kernel_names("mfn")),
        "plain_ms": cuda_ms(torch, lambda: MF.mfn_step_plain(
            params, c, t, spec, gt=gt, want_metrics=True), 10),
        "library_ms": cuda_ms(torch, lambda: mfn_matmul_step(
            torch, params, c, t, gt), 10),
        "library": "torch.matmul step, filters and written-out backward in "
                   "PyTorch ops",
        "library_vs_plain_max_abs_err": lib_err}
    res.update(tensor_core_fields(torch, build, step, "mfn_step", flops,
                                  nbytes, res["kernel_ms"], lib="mfn"))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["mfn_step"] = res
    del scratch

    h = 256
    model, params, c, _, _, g = mfn_case(torch, get_inr, n, d, h, layers, o,
                                         28, device)
    spec, keys = model.spec, leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    nweights = num_weights(params)
    kfn, pfn = (pair_fn(a, spec, keys)
                for a in (MF.mfn_mlp, MF.mfn_mlp_plain))

    def pair():
        return vjp(torch, kfn, [c] + leaves, g)

    def fwd():
        with torch.no_grad():
            kfn(c, *leaves)

    lib = mfn_matmul_vjp(torch, params, c, lambda y: g, want_dcoords=True)
    got = {"out": lib[0], "d0": lib[2]}
    got.update({f"d{i + 1}": tt for i, (_, tt) in
                enumerate(tree_leaves(lib[1]))})
    want = vjp(torch, pfn, [c] + leaves, g)
    flops = MF.apply_flops(n, d, h, o, layers + 1)
    nbytes = 4 * (2 * (n * d + n * o + nweights))
    res = {
        "ms": cuda_ms(torch, pair, 20),
        "kernel_ms": kernel_device_ms(torch, pair, 20, kernel_names("mfn")),
        "fwd_ms": cuda_ms(torch, fwd, 20),
        "plain_ms": cuda_ms(torch, lambda: vjp(torch, pfn, [c] + leaves, g),
                            10),
        "library_ms": cuda_ms(torch, lambda: mfn_matmul_vjp(
            torch, params, c, lambda y: g, want_dcoords=True), 10),
        "library": "torch.matmul forward, filters and written-out backward "
                   "in PyTorch ops",
        "library_vs_plain_max_abs_err": max(
            float((got[k] - want[k]).abs().max()) for k in want)}
    res.update(tensor_core_fields(torch, build, pair, "mfn_mlp", flops,
                                  nbytes, res["kernel_ms"], lib="mfn"))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["mfn_mlp"] = res
    return out


def fit_mfn(torch, np, mods, counters, device):
    """MFN denoise at the sweep's problem (the 512^2 stand-in halved to
    256^2, noised with measure_np(snr 2, tau 30), 65,536 coordinates, full
    batch, lr 5e-2 scaled by batch) for MFN_ITERS epochs through
    fit_pointwise: once through the kernel, counts reset just before and
    read just after, and once through the plain path (fused='never'), from
    one init."""
    SW, M, get_inr, FitConfig, fit_pointwise = mods
    im, im_noisy = SW.denoise_images()
    H, W, _ = im.shape
    model, plain = mfn_models(get_inr, SW, "denoise", H, W)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = SW.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=SW._DENOISE_LR["mfn"],
                        niters=MFN_ITERS, maxpoints=256 * 256,
                        scale_lr_by_batch=True)
    reset_counts(counters)
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                        fit_cfg, gt=im.reshape(-1, 3), device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "MFN denoise",
                        {("mfn", "step"): MFN_ITERS})
    res_plain = fit_pointwise(plain, params, grid, im_noisy.reshape(-1, 3),
                              fit_cfg, gt=im.reshape(-1, 3), device=device)
    if read_counts(counters) != launches:
        raise AssertionError("MFN denoise: the plain fit launched a kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H * W, 3)):
            raise AssertionError("MFN denoise: non-finite values or a wrong "
                                 "shape")
    psnr, psnr_plain = (float(M.psnr_ref(im, r.best_rec.reshape(H, W, 3)))
                        for r in (res, res_plain))
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(
            f"MFN denoise: kernel fit {psnr:.3f} dB vs plain fit "
            f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_MFN_DB["denoise"] - 0.2
    if not psnr >= floor:
        raise AssertionError(f"MFN denoise: kernel fit best PSNR "
                             f"{psnr:.3f} dB below the floor {floor} dB")
    return dict(epochs=MFN_ITERS, launches=launches["mfn"], psnr_db=psnr,
                psnr_plain_db=psnr_plain, floor_db=floor,
                ms_per_step=res.step_ms, plain_ms_per_step=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def fit_mfn_sisr(torch, np, mods, counters, device):
    """MFN SISR at the sweep's problem (the 768^2 stand-in shrunk by a third
    to 256^2 HR, x4 box downsample to 64^2, lr 5e-2 decaying to 0.2x) for
    MFN_ITERS iterations through fit_operator, through the kernels and the
    plain path, from one init."""
    SW, TS, TF, M, get_inr, FitConfig, fit_operator = mods
    im, im_lr = TS.sisr_images(None, 0, 4, size=768)
    H, W, _ = im.shape
    model, plain = mfn_models(get_inr, SW, "sisr", H, W)
    params = model.init(torch.Generator().manual_seed(0), device)
    grid = SW.C.grid2d(H, W)
    fit_cfg = FitConfig(learning_rate=SW._SISR_LR["mfn"], niters=MFN_ITERS,
                        lr_decay=0.2)
    op = TF.DownsampleOp(4)
    reset_counts(counters)
    res = fit_operator(model, params, grid, im_lr, op, fit_cfg, gt_field=im,
                       field_shape=(H, W, 3), track="gt", device=device)
    launches = read_counts(counters)
    check_real_launches(launches, "MFN SISR",
                        {("mfn", "forward"): MFN_ITERS,
                         ("mfn", "backward"): MFN_ITERS})
    res_plain = fit_operator(plain, params, grid, im_lr, op, fit_cfg,
                             gt_field=im, field_shape=(H, W, 3), track="gt",
                             device=device)
    if read_counts(counters) != launches:
        raise AssertionError("MFN SISR: the plain fit launched a kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H, W, 3)):
            raise AssertionError("MFN SISR: non-finite values or a wrong "
                                 "shape")
    db, db_plain = M.mse_db(res.best_mse), M.mse_db(res_plain.best_mse)
    if not abs(db - db_plain) <= PSNR_AGREE_DB:
        raise AssertionError(f"MFN SISR: kernel fit {db:.3f} dB vs plain fit "
                             f"{db_plain:.3f} dB differ by more than "
                             f"{PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_MFN_DB["sisr"] - 0.2
    if not db >= floor:
        raise AssertionError(f"MFN SISR: kernel fit best -10 log10(MSE) "
                             f"{db:.3f} dB below the floor {floor} dB")
    return dict(iters=MFN_ITERS, launches=launches["mfn"], mse_db=db,
                mse_db_plain=db_plain, floor_db=floor,
                ssim=float(M.ssim(im, res.best_rec, data_range=1.0)),
                ms_per_iter=res.step_ms, plain_ms_per_iter=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def wire2d_case(torch, get_inr, n, layers, o, seed, device, kw=None,
                lead=()):
    """A WIRE-2D at the full width (300 hidden features: 150 units per
    head), its seeded init and numpy-seeded inputs: (model, params, coords,
    target, gt, cotangent); ``kw`` overrides the denoise model's
    frequencies and width."""
    import numpy as np
    spec_kw = dict(WIRE2D_DENOISE_KW, hidden_layers=layers, out_features=o)
    spec_kw.update(kw or {})
    model = get_inr("wire2d", **spec_kw)
    params = model.init(torch.Generator().manual_seed(seed), device)
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(-1, 1, lead + (n, 2)), rng.uniform(0, 1, (n, o)),
            rng.uniform(0, 1, (n, o)), rng.normal(size=lead + (n, o)))
    return (model, params) + tuple(
        torch.tensor(a.astype(np.float32), device=device) for a in arrs)


def wire2d_ct_kw(get_config):
    """The CT path's WIRE-2D frequencies: preset CT_CONFIG's."""
    cfg = get_config(CT_CONFIG)
    return dict(first_omega0=cfg.omega0, hidden_omega0=cfg.omega0,
                scale=cfg.scale)


# wire2d_step and the wire2d_mlp pair at widths, depths, outputs and row
# counts besides the main path's, as (hidden_features, units per head h,
# L, o, n, nvalid, denom): h 5, 13, 150, 152 and 256 (odd, even, a
# multiple of 4) against the 16-unit quad and 32-unit paired tiles, K = 2h
# and 4h against the 32-deep slices, n 700 and 65,537 against the 128-row
# tiles and the weight gradients' 512- and 1,024-row chunks; both at the
# denoise frequencies, the step with nvalid and denom, the pair with
# dcoords
WIRE2D_WIDTHS = ((10, 5, 0, 3, 700, 650, 1951.0),
                 (10, 5, 3, 1, 700, None, None),
                 (26, 13, 2, 3, 700, 600, None),
                 (300, 150, 1, 1, 700, None, 777.0),
                 (300, 150, 3, 3, 700, 650, None),
                 (304, 152, 2, 1, 700, None, None),
                 (512, 256, 1, 3, 700, 699, None),
                 (300, 150, 2, 3, 65537, 65000, None),
                 (304, 152, 1, 1, 65537, None, 70000.0),
                 (512, 256, 2, 1, 65537, None, None),
                 (26, 13, 3, 3, 65537, None, None))
# and the pair at the CT frequencies, (hidden_features, h, L, o, n): there
# its fp32 plain version lies 8.65e-5 x max from its own float64 run on one
# weight gradient, a difference of near-equal blocks
# (tools/port_wire2d_reference.py --widths), so this case is held to the
# float64 run (compare_float64)
WIRE2D_CT_WIDTH = (10, 5, 3, 1, 700)


def wire2d_widths(torch, W2, get_inr, get_config, device):
    """wire2d_step and the wire2d_mlp pair against their plain versions at
    each of WIRE2D_WIDTHS, and the pair against its plain version run in
    float64 at WIRE2D_CT_WIDTH; two calls of each bit-equal."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    errs = {"wire2d_step": {}, "wire2d_mlp": {}}
    for hf, h, L, o, n, nvalid, denom in WIRE2D_WIDTHS:
        what = f"h{h} L{L} o{o} n{n}"
        seed = n + hf + L
        model, params, c, t, gt, _ = wire2d_case(
            torch, get_inr, n, L, o, seed, device, {"hidden_features": hf})
        scratch = StepScratch()
        got, again = (tensors_of(*W2.wire2d_step(
            params, c, t, model.spec, nvalid=nvalid, denom=denom, gt=gt,
            want_metrics=True, scratch=scratch)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, got, again, f"wire2d_step {what}")
        want = tensors_of(*W2.wire2d_step_plain(
            params, c, t, model.spec, nvalid=nvalid, denom=denom, gt=gt,
            want_metrics=True))
        errs["wire2d_step"][what] = compare(got, want, f"wire2d_step {what}")
        del scratch

        model, params, c, _, _, g = wire2d_case(
            torch, get_inr, n, L, o, seed + 1, device, {"hidden_features": hf})
        keys, leaves = leaf_paths(params), [v for _, v in
                                            tree_leaves(params)]
        kfn = pair_fn(W2.wire2d_mlp, model.spec, keys)
        got, again = (vjp(torch, kfn, [c] + leaves, g) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, got, again, f"wire2d_mlp {what}")
        errs["wire2d_mlp"][what] = compare(
            got, vjp(torch, pair_fn(W2.wire2d_mlp_plain, model.spec, keys),
                     [c] + leaves, g), f"wire2d_mlp {what}")

    hf, h, L, o, n = WIRE2D_CT_WIDTH
    what = f"h{h} L{L} o{o} n{n} ct"
    model, params, c, _, _, g = wire2d_case(
        torch, get_inr, n, L, o, n + hf + L + 1, device,
        dict(wire2d_ct_kw(get_config), hidden_features=hf))
    keys, leaves = leaf_paths(params), [v for _, v in tree_leaves(params)]
    kfn = pair_fn(W2.wire2d_mlp, model.spec, keys)
    got, again = (vjp(torch, kfn, [c] + leaves, g) for _ in range(2))
    torch.cuda.synchronize()
    same_bits(torch, got, again, f"wire2d_mlp {what}")
    pfn = pair_fn(W2.wire2d_mlp_plain, model.spec, keys)
    errs["wire2d_mlp"][what], _ = compare_float64(
        got, lambda xs, cot: vjp(torch, pfn, xs, cot), ([c] + leaves, g), {},
        f"wire2d_mlp {what}")
    return errs


def wire2d_kernel_vs_plain(torch, W2, get_inr, get_config, device):
    """max abs err of wire2d_step and of the wire2d_mlp pair against their
    plain versions: the step at the denoise shape (n = 65,536, o = 3,
    metrics) and ragged ones (n = 700, nvalid 650, denom, o = 1, L = 1 and
    3); the pair at the CT shape (o = 1, parameter gradients, as the fit
    calls it) and at the denoise shape with dcoords, on (4, 50, 2)
    coordinates, and without a gradient (equal output, a peak within its
    two ping-pong planes + 16 MiB); two calls of each kernel giving
    identical bits."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    errs = {"wire2d_step": {}, "wire2d_mlp": {}}
    for which, (n, layers, o, nvalid, denom) in {
            "full": (256 * 256, 2, 3, None, None),
            "ragged_L1": (700, 1, 1, 650, 650 * 1.0 + 1.0),
            "ragged_L3": (700, 3, 1, 650, 650 * 1.0 + 1.0)}.items():
        model, params, c, t, gt, _ = wire2d_case(torch, get_inr, n, layers,
                                                 o, 30, device)
        scratch = StepScratch()
        got, again = (tensors_of(*W2.wire2d_step(
            params, c, t, model.spec, nvalid=nvalid, denom=denom, gt=gt,
            want_metrics=True, scratch=scratch)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, got, again, f"wire2d_step {which}")
        want = tensors_of(*W2.wire2d_step_plain(params, c, t, model.spec,
                                                nvalid=nvalid, denom=denom,
                                                gt=gt, want_metrics=True))
        errs["wire2d_step"][which] = compare(got, want,
                                             f"wire2d_step {which}")

    ct_kw = wire2d_ct_kw(get_config)
    model, params, c, _, _, g = wire2d_case(torch, get_inr, 256 * 256, 2, 1,
                                            31, device, ct_kw)
    spec, keys = model.spec, leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    kfn, pfn = (pair_fn(a, spec, keys)
                for a in (W2.wire2d_mlp, W2.wire2d_mlp_plain))
    got, again = (param_vjp(torch, kfn, c, leaves, g) for _ in range(2))
    torch.cuda.synchronize()
    same_bits(torch, got, again, "wire2d_mlp full")
    errs["wire2d_mlp"]["full"] = compare(
        got, param_vjp(torch, pfn, c, leaves, g), "wire2d_mlp full")
    errs["wire2d_mlp"]["nograd_peak_mb"], \
        errs["wire2d_mlp"]["nograd_pingpong_mb"] = check_nograd(
            torch, lambda: W2.wire2d_mlp(params, c, spec), got["out"],
            2 * c.shape[0] * 300 * 4, "wire2d_mlp")

    model, params, c, _, _, g = wire2d_case(torch, get_inr, 256 * 256, 2, 3,
                                            32, device)
    spec, keys = model.spec, leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    kfn, pfn = (pair_fn(a, spec, keys)
                for a in (W2.wire2d_mlp, W2.wire2d_mlp_plain))
    got, again = (vjp(torch, kfn, [c] + leaves, g) for _ in range(2))
    torch.cuda.synchronize()
    same_bits(torch, got, again, "wire2d_mlp dcoords")
    errs["wire2d_mlp"]["dcoords"] = compare(
        got, vjp(torch, pfn, [c] + leaves, g), "wire2d_mlp with dcoords")

    model, params, c, _, _, g = wire2d_case(torch, get_inr, 50, 2, 1, 33,
                                            device, ct_kw, lead=(4,))
    keys, leaves = leaf_paths(params), [t for _, t in tree_leaves(params)]
    got = vjp(torch, pair_fn(W2.wire2d_mlp, model.spec, keys), [c] + leaves,
              g)
    if got["out"].shape != (4, 50, 1):
        raise AssertionError(f"wire2d_mlp (4, 50, 2): output shape "
                             f"{tuple(got['out'].shape)}")
    errs["wire2d_mlp"]["batched"] = compare(
        got, vjp(torch, pair_fn(W2.wire2d_mlp_plain, model.spec, keys),
                 [c] + leaves, g), "wire2d_mlp (4, 50, 2)")
    for name, cases in wire2d_widths(torch, W2, get_inr, get_config,
                                     device).items():
        errs[name].update(cases)
    return errs


def wire2d_measure(torch, W2, get_inr, get_config, device, build):
    """Times of wire2d_step at the denoise shape (n = 65,536, o = 3) and of
    the wire2d_mlp pair at the CT shape (o = 1, parameter gradients, as the
    CT fit calls it): the kernel (a host call, and its kernels' device
    time, by product class), the plain version, the matmul yardstick, and
    the card's least time for the same work (tensor_core_fields)."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    out = {}
    n, L = 256 * 256, 2
    model, params, c, t, gt, _ = wire2d_case(torch, get_inr, n, L, 3, 34,
                                             device)
    spec = model.spec
    h, o = params["first_lin"]["w"].shape[1], 3
    nweights = num_weights(params)
    scratch = StepScratch()

    def step():
        return W2.wire2d_step(params, c, t, spec, gt=gt, want_metrics=True,
                              scratch=scratch)

    lib_err = compare(
        tensors_of(*wire2d_matmul_step(torch, W2, params, c, t, gt, spec)),
        tensors_of(*W2.wire2d_step_plain(params, c, t, spec, gt=gt,
                                         want_metrics=True)),
        "wire2d matmul step vs plain")
    flops = W2.step_flops(n, 2, h, o, L)
    nbytes = 4 * (n * (2 + o + o) + nweights + n * o + nweights + 2)
    res = {
        "ms": cuda_ms(torch, step, 20),
        "kernel_ms": kernel_device_ms(torch, step, 20,
                                      kernel_names("wire2d")),
        "plain_ms": cuda_ms(torch, lambda: W2.wire2d_step_plain(
            params, c, t, spec, gt=gt, want_metrics=True), 10),
        "library_ms": cuda_ms(torch, lambda: wire2d_matmul_step(
            torch, W2, params, c, t, gt, spec), 10),
        "library": "torch.matmul step on the stacked layout, Gabor-2D and "
                   "written-out backward in PyTorch ops",
        "library_vs_plain_max_abs_err": lib_err}
    res.update(tensor_core_fields(torch, build, step, "wire2d_step", flops,
                                  nbytes, res["kernel_ms"], lib="wire2d"))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["wire2d_step"] = res
    del scratch

    o = 1
    model, params, c, _, _, g = wire2d_case(torch, get_inr, n, L, o, 35,
                                            device, wire2d_ct_kw(get_config))
    spec, keys = model.spec, leaf_paths(params)
    leaves = [t for _, t in tree_leaves(params)]
    nweights = num_weights(params)
    kfn, pfn = (pair_fn(a, spec, keys)
                for a in (W2.wire2d_mlp, W2.wire2d_mlp_plain))

    def pair():
        return param_vjp(torch, kfn, c, leaves, g)

    def fwd():
        with torch.no_grad():
            kfn(c, *leaves)

    lib = wire2d_matmul_vjp(torch, W2, params, c, spec, lambda y: g)
    got = {"out": lib[0]}
    got.update({f"d{i + 1}": tt for i, (_, tt) in
                enumerate(tree_leaves(lib[1]))})
    want = param_vjp(torch, pfn, c, leaves, g)
    flops = W2.apply_flops(n, 2, h, o, L, dcoords=False)
    nbytes = 4 * (n * 2 + 2 * (n * o + nweights))
    res = {
        "ms": cuda_ms(torch, pair, 20),
        "kernel_ms": kernel_device_ms(torch, pair, 20,
                                      kernel_names("wire2d")),
        "fwd_ms": cuda_ms(torch, fwd, 20),
        "plain_ms": cuda_ms(torch, lambda: param_vjp(torch, pfn, c, leaves,
                                                     g), 10),
        "library_ms": cuda_ms(torch, lambda: wire2d_matmul_vjp(
            torch, W2, params, c, spec, lambda y: g), 10),
        "library": "torch.matmul forward on the stacked layout, Gabor-2D "
                   "and written-out backward in PyTorch ops",
        "library_vs_plain_max_abs_err": max(
            float((got[k] - want[k]).abs().max()) for k in want)}
    res.update(tensor_core_fields(torch, build, pair, "wire2d_mlp", flops,
                                  nbytes, res["kernel_ms"], lib="wire2d"))
    res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    res["achieved_tflops"] = flops / (res["kernel_ms"] * 1e9) \
        if res["kernel_ms"] else None
    out["wire2d_mlp"] = res
    return out


def fit_wire2d(torch, np, mods, counters, device):
    """WIRE-2D denoise (300 wide, omega0 7, sigma 8) at the bench protocol
    (256 x 256, measure_np(snr 2, tau 30), 65,536 coordinates, full batch,
    lr 5e-3 scaled by batch) for WIRE2D_ITERS epochs through fit_pointwise:
    once through the kernel, counts reset just before and read just after,
    and once through the plain path (fused='never'), from one init."""
    WS, M, get_inr, FitConfig, fit_pointwise, bench = mods
    im, im_noisy, grid, _ = bench.setup(256, 256)
    H, W, _ = im.shape
    model = get_inr("wire2d", **WIRE2D_DENOISE_KW)
    plain = get_inr("wire2d", fused="never", **WIRE2D_DENOISE_KW)
    params = model.init(torch.Generator().manual_seed(0), device)
    fit_cfg = FitConfig(learning_rate=5e-3, niters=WIRE2D_ITERS,
                        maxpoints=H * W, scale_lr_by_batch=True)
    reset_counts(counters)
    ws0 = wire_step_launches()
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                        fit_cfg, gt=im.reshape(-1, 3), device=device)
    launches = read_counts(counters)
    launches["wire_step"] = {"step": wire_step_launches() - ws0}
    check_real_launches(launches, "WIRE-2D denoise",
                        {("wire2d", "step"): WIRE2D_ITERS})
    res_plain = fit_pointwise(plain, params, grid, im_noisy.reshape(-1, 3),
                              fit_cfg, gt=im.reshape(-1, 3), device=device)
    if read_counts(counters) != {k: v for k, v in launches.items()
                                 if k != "wire_step"} \
            or wire_step_launches() != ws0:
        raise AssertionError("WIRE-2D denoise: the plain fit launched a "
                             "kernel")
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (H * W, 3)):
            raise AssertionError("WIRE-2D denoise: non-finite values or a "
                                 "wrong shape")
    psnr, psnr_plain = (float(M.psnr_ref(im, r.best_rec.reshape(H, W, 3)))
                        for r in (res, res_plain))
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(
            f"WIRE-2D denoise: kernel fit {psnr:.3f} dB vs plain fit "
            f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_WIRE2D_DB["denoise"] - 0.2
    if not psnr >= floor:
        raise AssertionError(f"WIRE-2D denoise: kernel fit best PSNR "
                             f"{psnr:.3f} dB below the floor {floor} dB")
    return dict(epochs=WIRE2D_ITERS, launches=launches["wire2d"],
                psnr_db=psnr, psnr_plain_db=psnr_plain, floor_db=floor,
                ms_per_step=res.step_ms, plain_ms_per_step=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


def fit_wire2d_ct(torch, np, mods, counters, device):
    """WIRE-2D CT (300 wide, preset CT_CONFIG's omega0 3, sigma 12, lr 5e-3)
    at the CT protocol (256 x 256 field, 100 angles, method 'auto' =
    fourier on the card) for WIRE2D_ITERS iterations through fit_operator:
    once through the kernels, counts reset just before and read just after
    (the pair and line_sample's gather and scatter once per iteration), a
    render of the best parameters with no gradient (one forward), and once
    through the plain path, from one init."""
    WS, TR, TCT, M, get_inr, get_config, FitConfig, fit_operator = mods
    cfg = get_config(CT_CONFIG)
    kw = dict(WIRE2D_DENOISE_KW, out_features=1)
    kw.update(wire2d_ct_kw(get_config))
    model = get_inr("wire2d", **kw)
    plain = get_inr("wire2d", fused="never", **kw)
    img = TCT.ct_image(None, 0)
    H, W = img.shape
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    grid = TCT.C.grid2d(H, W)
    params = model.init(torch.Generator().manual_seed(0), device)
    fit_cfg = FitConfig(learning_rate=cfg.learning_rate, niters=WIRE2D_ITERS,
                        maxpoints=cfg.maxpoints)
    if TR._resolve_auto("auto", len(thetas), "cuda", False) != "fourier":
        raise AssertionError("WIRE-2D CT: 'auto' is not fourier on the card")
    sino = TCT.make_sinogram(img, thetas, radon_method="auto", device=device)
    angles_t = torch.tensor(thetas, device=device)
    reset_counts(counters)
    ws0 = wire_step_launches()
    res = fit_operator(model, params, grid, sino,
                       TR.RadonOp(thetas, method="auto"), fit_cfg,
                       gt_field=img, field_shape=(H, W), device=device)
    launches = read_counts(counters)
    launches["wire_step"] = {"step": wire_step_launches() - ws0}
    check_real_launches(launches, "WIRE-2D CT",
                        {("wire2d", "forward"): WIRE2D_ITERS,
                         ("wire2d", "backward"): WIRE2D_ITERS,
                         ("line_sample", "gather"): WIRE2D_ITERS,
                         ("line_sample", "scatter"): WIRE2D_ITERS})
    grid_t = torch.tensor(grid, device=device)
    with torch.no_grad():
        render = model.apply(res.best_params, grid_t).reshape(H, W)
    rendered = read_counts(counters)
    if rendered["wire2d"] != dict(launches["wire2d"],
                                  forward=WIRE2D_ITERS + 1):
        raise AssertionError(f"WIRE-2D CT: the render launched "
                             f"{rendered['wire2d']}, expected one forward")
    res_plain = fit_operator(
        plain, params, grid, sino,
        lambda f: TR._radon_fourier(f, angles_t, sampler="plain"), fit_cfg,
        gt_field=img, field_shape=(H, W), device=device)
    if read_counts(counters) != rendered or wire_step_launches() != ws0:
        raise AssertionError("WIRE-2D CT: the plain fit launched a kernel")
    render = render.cpu().numpy()
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and np.isfinite(r.mse_noisy).all()
                and r.best_rec.shape == (H, W)):
            raise AssertionError("WIRE-2D CT: non-finite values or a wrong "
                                 "shape")
    if not (np.isfinite(render).all() and render.shape == (H, W)):
        raise AssertionError("WIRE-2D CT: the render is non-finite or has a "
                             "wrong shape")
    psnr = float(M.psnr_ref(img, res.best_rec))
    psnr_plain = float(M.psnr_ref(img, res_plain.best_rec))
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(
            f"WIRE-2D CT: kernel fit {psnr:.3f} dB vs plain fit "
            f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB} dB")
    floor = WIRE_TPU_300_WIRE2D_DB["ct"] - 0.2
    if not psnr >= floor:
        raise AssertionError(f"WIRE-2D CT: kernel fit best PSNR {psnr:.3f} "
                             f"dB below the floor {floor} dB")
    return dict(iters=WIRE2D_ITERS, radon="fourier",
                launches=launches["wire2d"],
                line_sample=launches["line_sample"], psnr_db=psnr,
                psnr_plain_db=psnr_plain, floor_db=floor,
                render_psnr_db=float(M.psnr_ref(img, render)),
                ssim=float(M.ssim(img, res.best_rec, data_range=1.0)),
                ms_per_iter=res.step_ms, plain_ms_per_iter=res_plain.step_ms,
                fit_wall_s=res.wall_time_s,
                plain_fit_wall_s=res_plain.wall_time_s)


# ---- the occupancy slice: wire_step at d = 3 in chunks, the five families --

OCC_CHUNK_ROWS = 200000


def occupancy_chunks(torch, O, device, seed=0):
    """The occupancy app's model (wire_tpu_torch/apps/occupancy.py:setup:
    the 64^3 synthetic volume, WIRE 212 complex units, 3 hidden layers, d
    3, o 1), its seed-0 init, and the two chunks of one epoch as the
    trainer cuts them from a permutation drawn from ``seed``: (rows,
    target, nvalid) with 200,000 rows each, the second's 137,856 sentinel
    rows a tail that repeats the last point (nvalid 62,144)."""
    import numpy as np
    im, grid, target, model, cfg = O.setup()
    npoints, mp = grid.npoints, cfg.maxpoints
    params = model.init(torch.Generator().manual_seed(0), device)
    perm = torch.randperm(npoints, generator=torch.Generator().manual_seed(
        seed))
    npad = 2 * mp - npoints
    perm = torch.cat([perm, torch.full((npad,), npoints)]).view(2, mp).to(
        device)
    tgt = torch.tensor(np.ascontiguousarray(target), device=device)
    chunks = []
    for k in range(2):
        safe = perm[k].clamp(max=npoints - 1)
        chunks.append((grid.rows(safe), tgt[safe],
                       mp - (npad if k == 1 else 0)))
    return model, params, chunks


# The occupancy wire_step cases are held to the plain WIRE step run in
# float64 on the kernel's own pre-activations (wire_state_reference; fault
# C.10, ROADMAP section C): at omega0 20, sigma 10 and 3 hidden layers the
# Gabor layers amplify fp32 rounding layer by layer (the last layer's
# activations 4.7e-5 x max from float64), so the fp32 plain version lies
# 1.17e-4 - 1.24e-4 x max from its own float64 run and the kernel 1.14e-4
# - 1.38e-4 (tools/port_occupancy_reference.py, PERF.md section 6): no
# fp32 evaluation meets REL_TOL of float64 there
OCC_STATE_CASES = frozenset({"wire_step occ_chunk0", "wire_step occ_chunk1",
                             "wire_step occ_ragged"})


def occupancy_cases(torch, WS, O, device):
    """{name: (kernel thunk, plain, args, kwargs, state)} of wire_step at
    the occupancy app's chunks (n 200,000, d 3, h 212, L 3, o 1): the first
    chunk (nvalid 200,000), the second (nvalid 62,144 over a sentinel
    tail), and a ragged n of 70,001 rows with nvalid 69,000; the gt is the
    target, as the app fits without one.  ``state()`` gives the kernel's
    own pre-activations of its last call, (z1 (n, h), zs (L, n, 2h) as [zr
    | zi]), from its scratch."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    import numpy as np
    model, params, chunks = occupancy_chunks(torch, O, device)
    spec = model.spec
    rows, t, _ = chunks[0]
    chunks.append((rows[:70001].contiguous(), t[:70001].contiguous(),
                   69000))
    cases = {}
    for which, (c, tt, nvalid) in zip(("chunk0", "chunk1", "ragged"),
                                      chunks):
        kw = dict(nvalid=nvalid, denom=float(np.float32(nvalid)), gt=tt,
                  want_metrics=True)
        scratch = StepScratch()

        def kernel(c=c, tt=tt, kw=kw, scratch=scratch):
            return tensors_of(*WS.wire_step(params, c, tt, spec,
                                            scratch=scratch, **kw))

        def plain(p, c, tt, s, **k):
            return tensors_of(*WS.wire_step_plain(p, c, tt, s, **k))

        def state(scratch=scratch):
            return scratch._bufs["z1"], scratch._bufs["zs"]
        cases[f"wire_step occ_{which}"] = (kernel, plain,
                                           (params, c, tt, spec), kw, state)
    return cases


def wire_state_reference(torch, params, coords, target, spec, kw, z1, zs,
                         what):
    """The outputs of a WIRE step (tensors_of) from the plain WIRE step run
    in float64 on given pre-activations: every parameter and input cast,
    each layer's pre-activation taking the value of ``z1`` (n, h) or
    ``zs[l]`` (n, 2h as [zr | zi]) (cast) while its gradient flows as
    through the float64 product, so the activations, the loss gradient and
    the whole backward are float64 functions of those values.  Checks each
    given pre-activation against the float64 product of the reference's
    previous activations: within REL_TOL x its layer's max |z|.  Returns
    (the outputs, {"z_rel": per layer the largest such distance / max
    |z|})."""
    from wire_tpu_torch import tree
    from wire_tpu_torch.nn import activations as act
    leaves = tree.leaves(params)
    xs = [t.detach().double().requires_grad_(True) for _, t in leaves]
    p = tree.unflatten([path for path, _ in leaves], xs)
    x, t = coords.double(), target.double()
    g = kw.get("gt")
    g = t if g is None else g.double()
    n, o = t.shape
    h = z1.shape[1]
    rels = []

    def take(ref, given, name):
        given = given.double()
        scale = float(ref.detach().abs().max())
        rel = float((given - ref.detach()).abs().max()) / scale
        if not rel <= REL_TOL:
            raise AssertionError(f"{what}: the given {name} lies {rel:.3e} x "
                                 f"max|z| from the float64 product, past "
                                 f"{REL_TOL}")
        rels.append(rel)
        return ref + (given - ref).detach()

    with torch.enable_grad():
        z = take(x @ p["first"]["w"] + p["first"]["b"], z1, "z1")
        xr, xi = act.complex_gabor_real_input(z, spec.first_omega0,
                                              spec.scale)
        for i in range(spec.hidden_layers):
            q = p[f"hidden_{i}"]
            zr = take(xr @ q["wr"] - xi @ q["wi"] + q["br"], zs[i][:, :h],
                      f"hidden_{i} zr")
            zi = take(xr @ q["wi"] + xi @ q["wr"] + q["bi"], zs[i][:, h:],
                      f"hidden_{i} zi")
            xr, xi = act.complex_gabor(zr, zi, spec.hidden_omega0,
                                       spec.scale)
        f = p["final"]
        y = xr @ f["wr"] - xi @ f["wi"] + f["br"]
        nvalid = n if kw.get("nvalid") is None else int(kw["nvalid"])
        denom = float(n * o) if kw.get("denom") is None else kw["denom"]
        mask = (torch.arange(n, device=x.device)[:, None] < nvalid).double()
        err = (y - t) * mask
        grads = torch.autograd.grad((err * err).sum() / denom, xs,
                                    allow_unused=True)
    grads = [torch.zeros_like(a) if gr is None else gr
             for a, gr in zip(xs, grads)]
    y = y.detach()
    eg = (y - g) * mask
    err = err.detach()
    out = tensors_of(y, tree.unflatten([path for path, _ in leaves], grads),
                     ((err * err).sum(), (eg * eg).sum()))
    return out, {"z_rel": rels}


def wire_plain_state(torch, params, coords, spec):
    """(z1, zs) of the plain WIRE forward in the coordinates' dtype, as the
    kernel keeps them: z1 (n, h), zs (L, n, 2h) as [zr | zi]."""
    from wire_tpu_torch.nn import activations as act
    p = params
    z1 = coords @ p["first"]["w"] + p["first"]["b"]
    xr, xi = act.complex_gabor_real_input(z1, spec.first_omega0, spec.scale)
    zs = []
    for i in range(spec.hidden_layers):
        q = p[f"hidden_{i}"]
        zr = xr @ q["wr"] - xi @ q["wi"] + q["br"]
        zi = xr @ q["wi"] + xi @ q["wr"] + q["bi"]
        zs.append(torch.cat([zr, zi], 1))
        xr, xi = act.complex_gabor(zr, zi, spec.hidden_omega0, spec.scale)
    return z1, torch.stack(zs)


def occupancy_check(torch, case, what):
    """The case's kernel outputs against its reference: for
    OCC_STATE_CASES the float64 run on the kernel's own pre-activations
    (wire_state_reference), else the fp32 plain version.  Returns (max abs
    err, the kernel's outputs, the reference's z distances or None)."""
    kernel, plain, args, kw, state = case
    got = kernel()
    torch.cuda.synchronize()
    if what in OCC_STATE_CASES:
        want, info = wire_state_reference(torch, *args, kw, *state(), what)
        return compare(got, want, what), got, info["z_rel"]
    return compare(got, plain(*args, **kw), what), got, None


def occupancy_kernel_vs_plain(torch, WS, O, device):
    """max abs err of wire_step against its reference (occupancy_check) at
    occupancy_cases, two calls of each bit-equal; and each case's distance
    from its fp32 plain version (not gated: C.10)."""
    errs, fp32 = {}, {}
    for what, case in occupancy_cases(torch, WS, O, device).items():
        which = what.split(" ")[1]
        errs[which], got, _ = occupancy_check(torch, case, what)
        same_bits(torch, case[0](), got, what)
        fp32[which] = rel_distance(got, case[1](*case[2], **case[3]))
    return errs, fp32


FAMILIES_PRESET = "MscaleHL_s1_ST2_SHF256"
FAMILY_SPEC_FIELDS = ("in_features", "out_features", "hidden_features",
                      "hidden_layers", "scaled_hidden_features",
                      "first_omega0", "hidden_omega0", "scale",
                      "scale_tensor")
STEP_FAMILIES = ("bspline_mscale_1", "bspline_mscale_1_new",
                 "bspline_mscale_repIN")


def family_models(get_inr, TC, get_config, nonlin):
    """A multiscale family at FAMILIES_PRESET's shape (scale 1,
    scale_tensor (1, 2), 256 scaled hidden features, 256 wide) as the
    denoise app builds it (build_model widens _1_new's and repIN's inputs
    to 1,024), and the same spec with fused='never' (the plain path)."""
    import dataclasses
    cfg = dataclasses.replace(get_config(FAMILIES_PRESET), nonlin=nonlin)
    model = TC.build_model(cfg, in_features=2, out_features=3, omega0=7.0,
                           sidelength=256)
    plain = get_inr(nonlin, fused="never", **{
        f: getattr(model.spec, f) for f in FAMILY_SPEC_FIELDS})
    return cfg, model, plain


def family_fold(torch, MM, model, seed, device):
    """(canon, kinds, pre) of a step family's seeded init: mscale_1's fold
    (identity layer 2 -> 512, then 512 -> 256 -> 3) or repIN's ('post'
    splines 1,024 -> 256 -> 256 -> 256 -> 3, the coordinates tiled by
    ``pre``)."""
    params = model.init(torch.Generator().manual_seed(seed), device)
    spec = model.spec
    if spec.nonlin == "bspline_mscale_1":
        return (MM._canon_mscale1(params, spec), MM._mscale1_kinds(spec),
                lambda c: c)
    return (MM._canon_repin(params, spec),
            ("qspline",) * (spec.hidden_layers + 1),
            lambda c: MM.repin_expand(c, spec))


def slice_real_cases(torch, RM, MM, TC, get_inr, get_config, device):
    """{name: case} of real_step at the mscale_1 fold (K = 2 first layer
    with the identity basis, 512 wide) and at the repIN fold (first layer K
    = 1,024 on the tensor cores), at the denoise shape (65,536 rows), and
    of the real_mlp pair (dcoords of the 1,024 tiled inputs included) at
    the repIN fold, at 65,536 rows; real_check's cases."""
    cases = {}
    n = 256 * 256
    for which, nonlin in (("mscale1_fold", "bspline_mscale_1"),
                          ("repin_fold", "bspline_mscale_repIN")):
        _, model, _ = family_models(get_inr, TC, get_config, nonlin)
        canon, kinds, pre = family_fold(torch, MM, model, 42, device)
        c, t, gt, g = real_inputs(torch, n, 2, 3, 43, device)
        x = pre(c).contiguous()
        cases[f"real_step {which}"] = real_step_case(torch, RM, canon, x, t,
                                                     kinds, gt=gt)
        if which == "repin_fold":
            cases[f"real_mlp {which}"] = real_pair_case(torch, RM, canon, x,
                                                        g, kinds)
    return cases


def slice_real_vs_plain(torch, RM, MM, TC, get_inr, get_config, device):
    """real_step's and real_mlp's kernels against their references
    (real_check) at slice_real_cases, two calls of each bit-equal."""
    errs = {"real_step": {}, "real_mlp": {}}
    for what, case in slice_real_cases(torch, RM, MM, TC, get_inr,
                                       get_config, device).items():
        name, which = what.split(" ")
        errs[name][which], got = real_check(case, what)
        torch.cuda.synchronize()
        same_bits(torch, case[0](), got, what)
    return errs


def slice_measure(torch, WS, RM, MM, O, TC, get_inr, get_config, device,
                  build):
    """Times of the slice's new shapes: wire_step at the occupancy chunk (n
    200,000, d 3, h 212, L 3, o 1, nvalid 62,144), real_step at the
    mscale_1 and repIN folds (65,536 rows) and the real_mlp pair at the
    repIN fold (dcoords included): the host call, its kernels' device time
    by product class, the plain version, and the 3xTF32 bound with the
    fp32 one beside it (tensor_core_fields), the FLOPs from the modules'
    step_flops / apply_flops at d 3 and K 1,024."""
    from wire_tpu_torch.ops.wire_step import StepScratch
    import numpy as np
    out = {}
    model, params, chunks = occupancy_chunks(torch, O, device, seed=1)
    spec = model.spec
    c, t, nvalid = chunks[1]
    n, d = c.shape
    h, L = params["first"]["w"].shape[1], spec.hidden_layers
    kw = dict(nvalid=nvalid, denom=float(np.float32(nvalid)), gt=t,
              want_metrics=True)
    scratch = StepScratch()

    def step():
        return WS.wire_step(params, c, t, spec, scratch=scratch, **kw)
    flops = WS.step_flops(n, d, h, 1, L)
    nweights = num_weights(params)
    nbytes = 4 * (n * (d + 1 + 1) + nweights + n + nweights + 2)
    kernel_ms = kernel_device_ms(torch, step, 10, kernel_names("wire_step"))
    res = {"n": n, "d": d, "h": h, "L": L, "o": 1, "nvalid": nvalid,
           "ms": cuda_ms(torch, step, 10), "kernel_ms": kernel_ms,
           "plain_ms": cuda_ms(torch, lambda: WS.wire_step_plain(
               params, c, t, spec, **kw), 5),
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "achieved_tflops": flops / (kernel_ms * 1e9) if kernel_ms
           else None}
    res.update(tensor_core_fields(torch, build, step, "wire_step", flops,
                                  nbytes, kernel_ms))
    out["wire_step occupancy"] = res
    del scratch
    n = 256 * 256
    for which, nonlin in (("mscale1_fold", "bspline_mscale_1"),
                          ("repin_fold", "bspline_mscale_repIN")):
        _, fmodel, _ = family_models(get_inr, TC, get_config, nonlin)
        canon, kinds, pre = family_fold(torch, MM, fmodel, 44, device)
        c, t, gt, g = real_inputs(torch, n, 2, 3, 45, device)
        x = pre(c).contiguous()
        widths = RM._widths(canon, x.shape[1])
        nweights = sum(tt.numel() for _, tt in RM.canon_leaves(canon))
        scratch = StepScratch()

        def rstep():
            return RM.real_step(canon, x, t, kinds, gt=gt,
                                want_metrics=True, scratch=scratch)
        flops = RM.step_flops(n, widths)
        nbytes = 4 * (n * (widths[0] + 3 + 3) + nweights + n * 3
                      + nweights + 2)
        kernel_ms = kernel_device_ms(torch, rstep, 10,
                                     kernel_names("real_mlp"))
        res = {"widths": widths, "ms": cuda_ms(torch, rstep, 10),
               "kernel_ms": kernel_ms,
               "plain_ms": cuda_ms(torch, lambda: RM.real_step_plain(
                   canon, x, t, kinds, gt=gt, want_metrics=True), 5),
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "achieved_tflops": flops / (kernel_ms * 1e9) if kernel_ms
               else None}
        res.update(tensor_core_fields(torch, build, rstep, "real_step",
                                      flops, nbytes, kernel_ms,
                                      lib="real_mlp"))
        out[f"real_step {which}"] = res
        del scratch
        if which != "repin_fold":
            continue
        L = len(canon["layers"])
        xs = [x] + [tt for _, tt in RM.canon_leaves(canon)]
        kfn = real_mlp_fn(RM, L, kinds)
        pfn = real_mlp_fn(RM, L, kinds, plain=True)

        def pair():
            return vjp(torch, kfn, xs, g)
        flops = RM.apply_flops(n, widths)
        nbytes = 4 * (2 * (n * widths[0] + n * 3 + nweights))
        kernel_ms = kernel_device_ms(torch, pair, 10,
                                     kernel_names("real_mlp"))
        res = {"widths": widths, "ms": cuda_ms(torch, pair, 10),
               "kernel_ms": kernel_ms,
               "plain_ms": cuda_ms(torch, lambda: vjp(torch, pfn, xs, g), 5),
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "achieved_tflops": flops / (kernel_ms * 1e9) if kernel_ms
               else None}
        res.update(tensor_core_fields(torch, build, pair, "real_mlp", flops,
                                      nbytes, kernel_ms))
        out[f"real_mlp {which}"] = res
    for res in out.values():
        res.pop("device_kernels", None)
    return out


def profiled_idle(torch, run, epochs):
    """(device busy ms per epoch, wall ms per epoch, idle share) of
    ``run()``, an ``epochs``-epoch fit, under torch.profiler: busy is the
    sum of its device-side events (kernels, copies, memsets), wall the
    host clock around it; "not measured" where the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    if not busy:
        return "not measured", wall_ms / epochs, "not measured"
    return busy / epochs, wall_ms / epochs, 1.0 - busy / wall_ms


def check_fit(np, res, rows, cols, what):
    if not (np.isfinite(res.best_rec).all() and np.isfinite(res.mse_gt).all()
            and res.best_rec.shape == (rows, cols)):
        raise AssertionError(f"{what}: non-finite values or a wrong shape")


def fit_occupancy(torch, np, mods, counters, device):
    """The occupancy app (wire_tpu_torch.apps.occupancy.run, its defaults:
    64^3, WIRE 300 wide, 3 hidden layers, 200 epochs of two 200,000-row
    chunks, per-epoch IoU, seed 0) through the kernel, counts reset just
    before and read just after: wire_step twice an epoch and no other
    kernel; wire.mat and wire.dae written, the .dae the smoothened mesh of
    the best reconstruction; the best IoU and PSNR at or above wire_tpu's
    CPU fit less OCC_IOU_MARGIN and OCC_PSNR_MARGIN_DB.  The same fit
    through the plain path (fused='never'), from one init and one
    permutation seed: above the same floors, and its training MSE at epoch
    OCC_AGREE_EPOCH within OCC_MSE_AGREE of the kernel fit's.  The export
    writes a non-empty mesh of the volume itself.  Then OCC_BLOCK_EPOCHS
    epochs with block_perm 512 and per point, each through the kernel (two
    launches an epoch): the block-permuted fit's best PSNR and IoU at or
    above the per-point one's less OCC_BLOCK_MARGIN_DB and 0.  A profiled
    10-epoch fit gives the device's idle share."""
    import tempfile
    O, WS, fit_pointwise = mods
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(counters)
        ws0 = wire_step_launches()
        app = O.run(results_dir=tmp, niters=OCC_EPOCHS, device=device)
        launches = read_counts(counters)
        launches["wire_step"] = {"step": wire_step_launches() - ws0}
        check_real_launches(launches, "occupancy",
                            {("wire_step", "step"): 2 * OCC_EPOCHS})
        mesh_path = os.path.join(tmp, "occupancy", "wire.dae")
        mat_path = os.path.join(tmp, "occupancy", "wire.mat")
        if not (os.path.isfile(mesh_path) and os.path.isfile(mat_path)):
            raise AssertionError("occupancy: wire.mat / wire.dae not "
                                 "written")
        dae_bytes = os.path.getsize(mesh_path)
        im = O.setup()[0]
        verts, faces = O.V.march_and_save(
            app["result"].best_rec.reshape(im.shape), 0.5,
            os.path.join(tmp, "again.dae"), smoothen=True)
        if (len(verts), len(faces)) != (app["nverts"], app["nfaces"]):
            raise AssertionError("occupancy: wire.dae is not the mesh of "
                                 "the best reconstruction")
        vol_verts, vol_faces = O.V.march_and_save(
            im, 0.5, os.path.join(tmp, "volume.dae"), smoothen=True)
        if not len(vol_faces) > 0:
            raise AssertionError("occupancy: the volume's mesh is empty")
    res = app["result"]
    im, grid, target, plain, cfg = O.setup(niters=OCC_EPOCHS,
                                           fused="never")
    check_fit(np, res, grid.npoints, 1, "occupancy")
    params = plain.init(torch.Generator().manual_seed(0), device)
    ws0 = wire_step_launches()
    res_plain = fit_pointwise(plain, params, grid, target, cfg,
                              track="noisy", epoch_metric=O.iou_metric(0.5),
                              device=device)
    if wire_step_launches() != ws0:
        raise AssertionError("occupancy: the plain fit launched wire_step")
    check_fit(np, res_plain, grid.npoints, 1, "occupancy plain")
    iou_plain, psnr_plain = O.best_metrics(im, res_plain.best_rec.reshape(im.shape))
    floors = {"iou": WIRE_TPU_200_OCC_IOU - OCC_IOU_MARGIN,
              "psnr_db": WIRE_TPU_200_OCC_PSNR_DB - OCC_PSNR_MARGIN_DB}
    for what, iou, psnr in (("kernel", app["iou"], app["psnr"]),
                            ("plain", iou_plain, psnr_plain)):
        if not (iou >= floors["iou"] and psnr >= floors["psnr_db"]):
            raise AssertionError(
                f"occupancy: the {what} fit's best IoU {iou:.5f} / PSNR "
                f"{psnr:.4f} dB below the floors {floors}")
    e = OCC_AGREE_EPOCH - 1
    mse_apart = float(res.mse_noisy[e] / res_plain.mse_noisy[e] - 1.0)
    if not abs(mse_apart) <= OCC_MSE_AGREE:
        raise AssertionError(
            f"occupancy: kernel and plain training MSE at epoch "
            f"{OCC_AGREE_EPOCH} {res.mse_noisy[e]:.6f} vs "
            f"{res_plain.mse_noisy[e]:.6f} differ by more than "
            f"{OCC_MSE_AGREE:.0%}")
    out.update(epochs=OCC_EPOCHS, launches=launches["wire_step"],
               iou=app["iou"], iou_plain=iou_plain, psnr_db=app["psnr"],
               psnr_plain_db=psnr_plain, floors=floors,
               mse_epoch_apart={OCC_AGREE_EPOCH: mse_apart},
               max_epoch_iou=float(res.time_array.max()),
               max_epoch_iou_plain=float(res_plain.time_array.max()),
               mesh_vertices=app["nverts"], mesh_faces=app["nfaces"],
               dae_bytes=dae_bytes, volume_mesh_faces=len(vol_faces),
               ms_per_epoch=res.step_ms,
               plain_ms_per_epoch=res_plain.step_ms,
               wall_ms_per_epoch=res.wall_time_s * 1e3 / OCC_EPOCHS,
               fit_wall_s=res.wall_time_s,
               plain_fit_wall_s=res_plain.wall_time_s)
    _, grid, target, model, _ = O.setup()
    params = model.init(torch.Generator().manual_seed(0), device)
    short = {}
    for name, block in (("block_perm_512", 512), ("per_point", 0)):
        _, _, _, _, bcfg = O.setup(niters=OCC_BLOCK_EPOCHS, block_perm=block)
        ws0 = wire_step_launches()
        reset_counts(counters)
        r = fit_pointwise(model, params, grid, target, bcfg, track="noisy",
                          epoch_metric=O.iou_metric(0.5), device=device)
        launches = read_counts(counters)
        launches["wire_step"] = {"step": wire_step_launches() - ws0}
        check_real_launches(launches, f"occupancy {name}",
                            {("wire_step", "step"): 2 * OCC_BLOCK_EPOCHS})
        check_fit(np, r, grid.npoints, 1, f"occupancy {name}")
        iou, psnr = O.best_metrics(im, r.best_rec.reshape(im.shape))
        short[name] = dict(iou=iou, psnr_db=psnr, ms_per_epoch=r.step_ms,
                           launches=launches["wire_step"]["step"])
    blk, pp = short["block_perm_512"], short["per_point"]
    if not (blk["psnr_db"] >= pp["psnr_db"] - OCC_BLOCK_MARGIN_DB
            and blk["iou"] >= pp["iou"]):
        raise AssertionError(
            f"occupancy: block_perm 512's best PSNR {blk['psnr_db']:.4f} dB "
            f"/ IoU {blk['iou']:.5f} below the per-point fit's "
            f"{pp['psnr_db']:.4f} dB less {OCC_BLOCK_MARGIN_DB} / "
            f"{pp['iou']:.5f}")
    out[f"epochs_{OCC_BLOCK_EPOCHS}"] = short
    _, _, _, _, pcfg = O.setup(niters=10)
    busy, wall, idle = profiled_idle(torch, lambda: fit_pointwise(
        model, params, grid, target, pcfg, track="noisy",
        epoch_metric=O.iou_metric(0.5), device=device), 10)
    out.update(profiled_busy_ms_per_epoch=busy,
               profiled_wall_ms_per_epoch=wall, device_idle_share=idle)
    return out, app


def motion_scene(np, side, warp):
    """(frame1, frame2), float32 side x side: a smooth scene f (two
    sinusoids and a Gaussian blob) on the pixel grid, and f moved by
    ``warp`` (2 x 3 or 3 x 3), frame2(q) = f(warp^-1 q), so that the warp
    that aligns frame2 to frame1 (frame2(W p) = frame1(p)) is ``warp``
    itself and the flow from frame1 to frame2 is W p - p."""
    def f(x, y):
        return (0.5 + 0.2 * np.sin(0.21 * x + 0.1 * y)
                + 0.15 * np.cos(0.13 * y - 0.05 * x)
                + 0.3 * np.exp(-((x - 0.45 * side) ** 2
                                 + (y - 0.55 * side) ** 2)
                               / (2 * (0.12 * side) ** 2)))
    Y, X = np.mgrid[:side, :side].astype(np.float64)
    A = np.asarray(warp, np.float64)
    if A.shape[0] == 2:
        A = np.vstack([A, [0.0, 0.0, 1.0]])
    Ai = np.linalg.inv(A)
    d = Ai[2, 0] * X + Ai[2, 1] * Y + Ai[2, 2]
    xs = (Ai[0, 0] * X + Ai[0, 1] * Y + Ai[0, 2]) / d
    ys = (Ai[1, 0] * X + Ai[1, 1] * Y + Ai[1, 2]) / d
    return f(X, Y).astype(np.float32), f(xs, ys).astype(np.float32)


def motion_warps(np):
    """{"euclidean": (2, 3), "homography": (3, 3)} of the smoke's motion
    pairs."""
    a, tx, ty = MOTION_EUCLIDEAN
    return {"euclidean": np.array([[np.cos(a), -np.sin(a), tx],
                                   [np.sin(a), np.cos(a), ty]]),
            "homography": np.array(MOTION_HOMOGRAPHY)}


def warp_displacement(np, warp, side):
    """Per pixel (side^2, 2) the displacement W p - p of ``warp``."""
    Y, X = np.mgrid[:side, :side]
    P = np.stack([X.ravel(), Y.ravel(), np.ones(side * side)])
    W = np.asarray(warp, np.float64)
    if W.shape[0] == 2:
        W = np.vstack([W, [0.0, 0.0, 1.0]])
    q = W @ P
    return (q[:2] / q[2] - P[:2]).T


def flow_lattice(side, step=8):
    """The pixels (rows, cols) where the Farneback flow is recorded."""
    return slice(step // 2, side, step), slice(step // 2, side, step)


def motion_checks(np, Mo, reference):
    """ecc_flow (euclidean and homography, MOTION_ECC_ITERS iterations) and
    optical_flow on the smoke's motion pairs, on the host: the warps held
    to cv2's in ``reference`` within ECC_LINEAR_TOL (linear part and
    perspective row) and ECC_SHIFT_TOL_PX (translation), each warp's
    largest displacement error from the true motion at most cv2's plus
    ECC_SHIFT_TOL_PX; the flow held to cv2's on the reference's lattice
    (mean endpoint error FLOW_MEAN_EPE_PX, max FLOW_MAX_EPE_PX), the
    remapped frame finite.  Returns the distances and host ms."""
    out = {}
    warps = motion_warps(np)
    for motion, warp in warps.items():
        im1, im2 = motion_scene(np, MOTION_SIDE, warp)
        t0 = time.time()
        got, aligned, flow = Mo.ecc_flow(im1, im2, motion,
                                         niters=MOTION_ECC_ITERS)
        host_ms = (time.time() - t0) * 1e3
        want = np.asarray(reference["ecc"][motion], np.float64)
        lin = [(0, 0), (0, 1), (1, 0), (1, 1)] + (
            [(2, 0), (2, 1)] if motion == "homography" else [])
        lin_err = max(abs(float(got[i]) - want[i]) for i in lin)
        shift_err = max(abs(float(got[r, 2]) - want[r, 2]) for r in (0, 1))
        true = warp_displacement(np, warp, MOTION_SIDE)
        err_true = float(np.abs(warp_displacement(np, got, MOTION_SIDE)
                                - true).max())
        cv2_true = float(np.abs(warp_displacement(np, want, MOTION_SIDE)
                                - true).max())
        if not (lin_err <= ECC_LINEAR_TOL and shift_err <= ECC_SHIFT_TOL_PX
                and err_true <= cv2_true + ECC_SHIFT_TOL_PX
                and np.isfinite(aligned).all() and np.isfinite(flow).all()):
            raise AssertionError(
                f"ecc_flow {motion}: linear {lin_err:.3e} (tol "
                f"{ECC_LINEAR_TOL}), translation {shift_err:.3e} px (tol "
                f"{ECC_SHIFT_TOL_PX}) from cv2's warp; from the true motion "
                f"{err_true:.4f} px against cv2's {cv2_true:.4f}")
        out[f"ecc_{motion}"] = dict(
            linear_err=lin_err, translation_err_px=shift_err,
            true_motion_err_px=err_true, cv2_true_motion_err_px=cv2_true,
            host_ms=host_ms, iters=MOTION_ECC_ITERS)
    im1, im2 = motion_scene(np, MOTION_SIDE, warps["euclidean"])
    t0 = time.time()
    flow, warped = Mo.optical_flow(im1, im2)
    host_ms = (time.time() - t0) * 1e3
    rows, cols = flow_lattice(MOTION_SIDE)
    want = np.asarray(reference["farneback_lattice"], np.float32)
    epe = np.sqrt(((flow[rows, cols] - want) ** 2).sum(-1))
    true = warp_displacement(np, warps["euclidean"], MOTION_SIDE).reshape(
        MOTION_SIDE, MOTION_SIDE, 2)
    if not (float(epe.mean()) <= FLOW_MEAN_EPE_PX
            and float(epe.max()) <= FLOW_MAX_EPE_PX
            and np.isfinite(warped).all()):
        raise AssertionError(
            f"optical_flow: endpoint error from cv2's flow mean "
            f"{float(epe.mean()):.3e} / max {float(epe.max()):.3e} px, past "
            f"{FLOW_MEAN_EPE_PX} / {FLOW_MAX_EPE_PX}")
    out["optical_flow"] = dict(
        epe_mean_px=float(epe.mean()), epe_max_px=float(epe.max()),
        true_motion_epe_mean_px=float(np.sqrt(
            ((flow - true) ** 2).sum(-1)).mean()), host_ms=host_ms)
    return out


def volume_motion(torch, np, mods, counters, occ_app, device):
    """The volume leftovers and the motion functions.  (a)
    ``export_mesh_from_model`` of the occupancy app's WIRE at
    fit_occupancy's best parameters over VM_CUBE_RES^3 points in batches
    of VM_BATCH, without the sigmoid, meshed at VM_MESH_LEVEL of the best
    reconstruction's max (smoothing off): launch counts reset just before
    and read just after, exactly VM_CUBE_RES^3 / VM_BATCH wire_mlp
    forwards and no other launch of the port; the outputs within REL_TOL x
    max of the plain apply (fused='never') on the same points; the .dae
    written and its mesh non-empty; wall time, and from a profiled run of
    the probe alone (no meshing) the kernel's device ms (in all and per
    million points) beside its 3xTF32 and fp32 bounds (the forward's
    operations; the points' and outputs' bytes), and the device idle
    share.  (b)
    ``block_query_coords`` at VM_BLOCK_RES, depth VM_BLOCK_DEPTH, applied
    through the kernel (one forward) and reassembled by
    ``BlockPointCloud.unfold``, within REL_TOL x max of the grid3d probe at
    VM_BLOCK_RES.  (c) ``refill`` on the card with a CUDA generator: the
    sdf-1 rows bit-unchanged, the redrawn rows inside their cells (to a
    float32 ulp of the limits), two calls from one generator state
    bit-equal.  (d) ``prune_stack`` of the multi-SR app's grey burst at its
    inverted known motion on the card, mask and kept frames equal to the
    CPU call's, imdiff within 1e-6.  (e) ``motion_checks`` (host)."""
    import tempfile
    O, MSR, V, Mo, WS = mods
    res = occ_app["result"]
    _, _, _, model, _ = O.setup()
    _, _, _, plain, _ = O.setup(fused="never")
    params = res.best_params
    thres = VM_MESH_LEVEL * float(np.max(res.best_rec))
    out = {"mesh_level": thres}
    n_fwd = VM_CUBE_RES ** 3 // VM_BATCH

    def counted(run, want, what):
        reset_counts(counters)
        ws0 = wire_step_launches()
        got = run()
        torch.cuda.synchronize()
        launches = read_counts(counters)
        launches["wire_step"] = {"step": wire_step_launches() - ws0}
        check_real_launches(launches, what, {("wire_mlp", "forward"): want})
        return got, launches["wire_mlp"]["forward"]

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "probe.dae")
        t0 = time.time()
        cube, fwd = counted(lambda: V.export_mesh_from_model(
            model, params, VM_CUBE_RES, VM_BATCH, path, thres=thres,
            sigmoid=False, device=device), n_fwd, "export_mesh_from_model")
        wall_s = time.time() - t0
        from wire_tpu_torch import native
        verts, faces = native.marching_cubes(cube, thres)
        if not (os.path.isfile(path) and len(faces) > 0):
            raise AssertionError("export_mesh_from_model: no .dae or an "
                                 "empty mesh")
        dae_bytes = os.path.getsize(path)
        flat = cube.reshape(-1)
        err, scale = 0.0, 0.0
        with torch.no_grad():
            for b in range(0, flat.size, VM_BATCH):
                want = plain.apply(params, V._grid3d_rows(
                    b, b + VM_BATCH, VM_CUBE_RES, device)).reshape(-1)
                got = torch.as_tensor(flat[b:b + VM_BATCH], device=device)
                err = max(err, float((got - want).abs().max()))
                scale = max(scale, float(want.abs().max()))
        if not (np.isfinite(cube).all() and err <= REL_TOL * scale):
            raise AssertionError(
                f"export_mesh_from_model: outputs {err:.3e} from the plain "
                f"apply, past {REL_TOL} x {scale:.4f}")
        out.update(probe=dict(
            cube_res=VM_CUBE_RES, batch=VM_BATCH, wire_mlp_forward=fwd,
            max_abs_err=err, plain_max=scale, wall_s=wall_s,
            mesh_vertices=len(verts), mesh_faces=len(faces),
            dae_bytes=dae_bytes))
        # the probe alone (no meshing) under the profiler
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        names = kernel_names("wire_mlp")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            V._probe_cube(model, params, VM_CUBE_RES, VM_BATCH, False,
                          device)
            torch.cuda.synchronize()
            prof_wall_ms = (time.time() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(e.device_time_total for e in events) / 1e3
        kern = sum(e.device_time_total for e in events
                   if any(n in e.key for n in names)) / 1e3
        mpts = VM_CUBE_RES ** 3 / 1e6
        spec = model.spec
        h2 = 2 * params["first"]["w"].shape[-1]
        flops = VM_CUBE_RES ** 3 * 2 * (
            spec.in_features * h2 // 2 + spec.hidden_layers * h2 * h2
            + h2 * spec.out_features)
        nbytes = VM_CUBE_RES ** 3 * 4 * (spec.in_features
                                         + spec.out_features)
        out["probe"].update(
            kernel_ms=kern if kern else "not measured",
            bound_ms=bound_3xtf32(flops, nbytes)[0],
            bound_fp32_ms=bound(flops, nbytes)[0], gflop=flops / 1e9,
            kernel_ms_per_mpoint=kern / mpts if kern else "not measured",
            device_busy_ms=busy if busy else "not measured",
            profiled_probe_wall_ms=prof_wall_ms,
            device_idle_share=(1.0 - busy / prof_wall_ms) if busy
            else "not measured")

        # (b) blockwise probing against the grid3d probe at VM_BLOCK_RES
        grid_cube, fwd_grid = counted(lambda: V.export_mesh_from_model(
            model, params, VM_BLOCK_RES, VM_BATCH,
            os.path.join(tmp, "small.dae"), thres=thres, sigmoid=False,
            device=device), -(-VM_BLOCK_RES ** 3 // VM_BATCH),
            "export_mesh_from_model small")
    chunks, ds = V.block_query_coords((-1, -1, -1), (1, 1, 1), VM_BLOCK_RES,
                                      VM_BLOCK_DEPTH)

    def blockwise():
        with torch.no_grad():
            vals = model.apply(params, torch.as_tensor(chunks, device=device))
        return ds.unfold(vals[..., 0].cpu().numpy(), VM_BLOCK_RES)

    block_cube, fwd_block = counted(blockwise, 1, "blockwise probe")
    berr = float(np.abs(block_cube - grid_cube).max())
    bscale = float(np.abs(grid_cube).max())
    if not berr <= REL_TOL * bscale:
        raise AssertionError(f"blockwise probe: {berr:.3e} from the grid3d "
                             f"probe, past {REL_TOL} x {bscale:.4f}")
    out["blockwise"] = dict(cube_res=VM_BLOCK_RES, depth=VM_BLOCK_DEPTH,
                            cells=int(chunks.shape[0]),
                            points_per_cell=int(chunks.shape[1]),
                            max_abs_err=berr, wire_mlp_forward=fwd_block,
                            grid_wire_mlp_forward=fwd_grid)

    # (c) refill on the card
    rs = np.random.RandomState(0)
    cloud = np.concatenate([rs.randn(VM_REFILL_POINTS // 2, 3) * 0.3,
                            rs.rand(VM_REFILL_POINTS // 2, 3)]).astype(
                                np.float32)
    bpc = V.BlockPointCloud(cloud, depth=VM_REFILL_DEPTH)
    xyz, sdf = bpc.fill(rng=np.random.RandomState(1))
    x = torch.as_tensor(xyz, device=device)
    s = torch.as_tensor(sdf, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = gen.get_state()
    r1 = bpc.refill(x, s, gen)
    gen.set_state(state)
    r2 = bpc.refill(x, s, gen)
    torch.cuda.synchronize()
    same_bits(torch, {"xyz": r1}, {"xyz": r2},
              "refill twice from one generator state")
    keep = s[..., 0] == 1
    if not torch.equal(r1[keep], x[keep]):
        raise AssertionError("refill moved a point of sdf 1")
    lo = torch.as_tensor(bpc.minlim, device=device)[:, None, :]
    hi = torch.as_tensor(bpc.maxlim, device=device)[:, None, :]
    ulp_lo = torch.as_tensor(np.spacing(np.abs(bpc.minlim)),
                             device=device)[:, None, :]
    ulp_hi = torch.as_tensor(np.spacing(np.abs(bpc.maxlim)),
                             device=device)[:, None, :]
    inside = ((r1 >= lo - ulp_lo) & (r1 <= hi + ulp_hi)).all(-1)
    if not bool(inside[~keep].all()):
        raise AssertionError("refill drew a point outside its cell")
    out["refill"] = dict(cells=int(xyz.shape[0]), slots=int(xyz.shape[1]),
                         redrawn=int((~keep).sum()),
                         strictly_inside=bool(((r1 >= lo) & (r1 <= hi))
                                              .all(-1)[~keep].all()))

    # (d) prune_stack on the card against the CPU
    prob = MSR.setup()
    gray = prob["imstack"].mean(-1).astype(np.float32)
    regs = Mo.invert_regstack(prob["mats"]).astype(np.float32)
    H, W = prob["im"].shape[:2]
    on_card = Mo.prune_stack(gray, regs, (H, W), device=device)
    on_cpu = Mo.prune_stack(gray, regs, (H, W), device="cpu")
    perr = float(np.abs(on_card[3] - on_cpu[3]).max())
    if not (all(np.array_equal(a, b) for a, b in zip(on_card[:3],
                                                     on_cpu[:3]))
            and perr <= 1e-6):
        raise AssertionError(f"prune_stack on the card: mask or kept "
                             f"frames differ from the CPU's, or imdiff "
                             f"{perr:.3e} past 1e-6")
    out["prune_stack"] = dict(frames=int(gray.shape[0]),
                              kept=int(on_card[2].sum()),
                              imdiff_err=perr)

    # (e) ECC and Farneback on the host, without cv2
    with open(os.path.join(ROOT, MOTION_REFERENCE)) as f:
        reference = json.load(f)
    out["motion"] = motion_checks(np, Mo, reference)
    out["launches"] = {"forward": fwd + fwd_grid + fwd_block}
    return out


def fit_families(torch, np, mods, counters, device):
    """256^2 denoise through fit_pointwise for FAMILIES_ITERS epochs for each
    step family of the slice (mscale_1, _1_new, repIN at FAMILIES_PRESET's
    shape): through the kernel (real_step once an epoch, counts reset just
    before and read just after, no other kernel) and through the plain
    path (fused='never'), from one init; the kernel fit's best PSNR at or
    above wire_tpu's CPU fit less 0.2 dB and within PSNR_AGREE_DB of the
    plain fit's.  Then realgabor and bspline_sig for AUTODIFF_ITERS epochs
    each, 256 wide: they train by autodiff and launch no kernel."""
    TD, TC, M, WS, get_inr, get_config, FitConfig, fit_pointwise = mods
    out = {}
    for nonlin in STEP_FAMILIES:
        t0 = time.time()
        cfg, model, plain = family_models(get_inr, TC, get_config, nonlin)
        im, im_noisy = TD.denoise_images(cfg)
        H, W, _ = im.shape
        params = model.init(torch.Generator().manual_seed(0), device)
        grid = TD.C.grid2d(H, W)
        fit_cfg = FitConfig(learning_rate=cfg.learning_rate,
                            niters=FAMILIES_ITERS, maxpoints=cfg.maxpoints,
                            scale_lr_by_batch=True)
        ws0 = wire_step_launches()
        reset_counts(counters)
        res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                            fit_cfg, gt=im.reshape(-1, 3), device=device)
        launches = read_counts(counters)
        launches["wire_step"] = {"step": wire_step_launches() - ws0}
        check_real_launches(launches, nonlin,
                            {("real_mlp", "step"): FAMILIES_ITERS})
        res_plain = fit_pointwise(plain, params, grid,
                                  im_noisy.reshape(-1, 3), fit_cfg,
                                  gt=im.reshape(-1, 3), device=device)
        after = read_counts(counters)
        after["wire_step"] = {"step": wire_step_launches() - ws0}
        if after != launches:
            raise AssertionError(f"{nonlin}: the plain fit launched a "
                                 f"kernel")
        for r in (res, res_plain):
            check_fit(np, r, H * W, 3, nonlin)
        psnr, psnr_plain = (float(M.psnr_ref(im, r.best_rec.reshape(H, W,
                                                                    3)))
                            for r in (res, res_plain))
        if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
            raise AssertionError(
                f"{nonlin}: kernel fit {psnr:.3f} dB vs plain fit "
                f"{psnr_plain:.3f} dB differ by more than {PSNR_AGREE_DB}")
        floor = WIRE_TPU_300_FAMILIES_DB[nonlin] - 0.2
        if not psnr >= floor:
            raise AssertionError(f"{nonlin}: kernel fit best PSNR "
                                 f"{psnr:.3f} dB below the floor {floor}")
        out[nonlin] = dict(in_features=model.spec.in_features,
                           launches=launches["real_mlp"]["step"],
                           psnr_db=psnr, psnr_plain_db=psnr_plain,
                           floor_db=floor, ms_per_step=res.step_ms,
                           plain_ms_per_step=res_plain.step_ms,
                           wall_s=time.time() - t0)
    for nonlin in ("realgabor", "bspline_sig"):
        t0 = time.time()
        model = get_inr(nonlin, in_features=2, out_features=3,
                        hidden_features=256, hidden_layers=2, scale=2.0)
        params = model.init(torch.Generator().manual_seed(0), device)
        fit_cfg = FitConfig(learning_rate=5e-3, niters=AUTODIFF_ITERS,
                            maxpoints=H * W, scale_lr_by_batch=True)
        ws0 = wire_step_launches()
        reset_counts(counters)
        res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                            fit_cfg, gt=im.reshape(-1, 3), device=device)
        launches = read_counts(counters)
        launches["wire_step"] = {"step": wire_step_launches() - ws0}
        check_real_launches(launches, nonlin, {})
        check_fit(np, res, H * W, 3, nonlin)
        out[nonlin] = dict(
            epochs=AUTODIFF_ITERS, launches=0,
            psnr_db=float(M.psnr_ref(im, res.best_rec.reshape(H, W, 3))),
            ms_per_step=res.step_ms, wall_s=time.time() - t0)
    return out


def sweep_expected(task, nonlin, iters):
    """The launches one family's sweep fit of ``iters`` steps must show: its
    step kernel (denoise) or its pair (SISR, CT; CT adds the fourier
    operator's gather and scatter, and one gather for the sinogram)."""
    lib = {"wire": "wire", "mfn": "mfn"}.get(nonlin, "real_mlp")
    if task == "denoise":
        return {("wire_step" if lib == "wire" else lib, "step"): iters}
    pair = "wire_mlp" if lib == "wire" else lib
    want = {(pair, "forward"): iters, (pair, "backward"): iters}
    if task == "ct":
        want.update({("line_sample", "gather"): iters + 1,
                     ("line_sample", "scatter"): iters})
    return want


def sweep_phase(torch, np, SW, WS, counters, device):
    """The sweep app's three tasks for each of the six families, one family
    per call at SWEEP_ITERS iterations, at the sweep's own sizes: the
    launches of each call (counts reset just before, read just after) must
    be its family's kernels and nothing else, the three artifact files of
    each call written, and every metric finite."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for task, run, metric in (("denoise", SW.sweep_denoise, "Best PSNR"),
                                  ("sisr", SW.sweep_sisr, "Best MSE"),
                                  ("ct", SW.sweep_ct, "Best PSNR")):
            out[task] = {}
            for nonlin in SW.NONLINS:
                t0 = time.time()
                rdir = os.path.join(tmp, task, nonlin)
                reset_counts(counters)
                ws0 = wire_step_launches()
                res = run(results_dir=rdir, niters=SWEEP_ITERS,
                          nonlins=[nonlin], device=device)[nonlin]
                launches = read_counts(counters)
                launches["wire_step"] = {
                    "step": wire_step_launches() - ws0}
                check_real_launches(launches, f"sweep {task} {nonlin}",
                                    sweep_expected(task, nonlin,
                                                   SWEEP_ITERS))
                for suffix in ("_info.mat", "_metrics.mat", "_table.md"):
                    path = os.path.join(rdir, f"{task}_sweep{suffix}")
                    if not os.path.isfile(path):
                        raise AssertionError(f"sweep {task} {nonlin}: "
                                             f"{path} not written")
                values = {k: v for k, v in res.items() if k != "rec"}
                if not (np.isfinite(res["rec"]).all() and all(
                        np.isfinite(v) for v in values.values())):
                    raise AssertionError(f"sweep {task} {nonlin}: a "
                                         f"non-finite metric or field")
                out[task][nonlin] = dict(
                    metric=res[metric], step_ms=res.get("Step (ms)"),
                    launches={k: v for k, v in launches.items()
                              if any(v.values())},
                    wall_s=time.time() - t0)
    return out


# ---- the multi-frame SR slice -------------------------------------------

# Best PSNR of the 300-iteration multi-SR fits at the app's defaults (192^2,
# x4, 4 frames, WIRE 256 wide = 181 complex units, omega0 10, sigma 5,
# lr 5e-3 without decay) from wire_tpu on the CPU (fused="never", float32,
# its motion module's cv2-free branches, this script's seed-0 init moved
# across with wire_tpu_torch.bridge), with the known motion (oracle) and
# with register_burst's, as printed by tools/port_multisr_floor.py; the
# kernel fits must reach them less 0.2 dB, and the oracle kernel fit agree
# with the plain fit within PSNR_AGREE_DB.
WIRE_TPU_300_MULTISR_DB = {"oracle": 15.790024757385254,
                           "estim": 15.256376266479492}
MULTISR_ITERS = 300
# iterations of each other family's multi-SR fit
MULTISR_OTHER_ITERS = 20
MULTISR_NONLINS = ("siren", "gauss", "relu", "posenc", "mfn")
# the multi-SR cases held to their plain version run in float64, and of
# those the relu pairs held to it on the kernel's own relu pattern (fault
# C.9's check), as tools/port_multisr_reference.py decides them (PERF.md
# section 2): the posenc pair's fp32 plain run lies 8.0e-5 x max from
# float64 and the kernel 9.3e-4, a relu input near its kink decided the
# other way (on an NVIDIA H100 80GB HBM3 at 700 W); every other multi-SR
# case keeps the fp32 plain version (its fp32 plain run within 8.7e-6 x
# max of float64)
MULTISR_FLOAT64_CASES = frozenset({"multisr posenc"})
MULTISR_RELU_PATTERN_CASES = frozenset({"multisr posenc"})
# the resume checks: (epochs or iterations, scan_segment) of each fit
RESUME_SHAPES = {"multi_sr": (60, 20), "occupancy": (12, 4),
                 "ct_rotate": (30, 10)}
# the chunked render: rows per chunk (4 chunks of the CT field), iterations
# and the loss histories' agreement with the whole-grid render
RENDER_CHUNK_ROWS = 16384
RENDER_ITERS = 20
RENDER_REL_TOL = 1e-5
# the reference protocol's frame side (4 frames of 512^2 = 1,048,576 rows a
# step), where measure_multi_sr times row 2 once more
MULTISR_BIG_SIDE = 512


def wire_pair_case(torch, WM, params, spec, c, cot, dcoords=True):
    """(kernel thunk, plain, args, kwargs) of one wire_mlp pair case:
    vjp() over [coords] + the leaves (with dcoords) or param_vjp()
    (without)."""
    keys = leaf_paths(params)
    inputs = [c] + [t for _, t in tree_leaves(params)]

    def pair(apply):
        fn = pair_fn(apply, spec, keys)

        def run(inputs, cot):
            if dcoords:
                return vjp(torch, fn, inputs, cot)
            return param_vjp(torch, fn, inputs[0], inputs[1:], cot)
        return run
    kernel = pair(WM.wire_mlp)
    return (lambda: kernel(inputs, cot), pair(WM.wire_mlp_plain),
            (inputs, cot), {})


def multisr_cases(torch, np, TMS, WM, RM, MM, MF, device):
    """{name: (kernel thunk, plain, args, kwargs[, pattern])} of the pairs
    the multi-SR fits launch, each at the app's seed-0 init: wire_mlp on
    the app's (4, 36,864, 2) frame grids without dcoords, as the fit calls
    it, and on a ragged (3, 4,097, 2) with dcoords; the real_mlp pair at
    the app's gauss and posenc models (through their folds, posenc on its
    encoded coordinates) and the mfn_mlp pair at the app's mfn, on the
    frame grids without dcoords.  Cotangents unit normal."""
    cases = {}
    rng = np.random.default_rng(50)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    prob = TMS.setup()
    coords = t(prob["ds"].coords)
    g = t(rng.normal(size=coords.shape[:-1] + (3,)))
    model = prob["model"]
    params = model.init(torch.Generator().manual_seed(0), device)
    cases["multisr wire"] = wire_pair_case(torch, WM, params, model.spec,
                                           coords, g, dcoords=False)
    cases["multisr wire ragged"] = wire_pair_case(
        torch, WM, params, model.spec, t(rng.uniform(-1, 1, (3, 4097, 2))),
        t(rng.normal(size=(3, 4097, 3))))
    for nonlin, fold, kind in (("gauss", "_canon_gauss", "gauss"),
                               ("posenc", "_canon_relu", "relu")):
        m = TMS.setup(nonlin)["model"]
        p = m.init(torch.Generator().manual_seed(0), device)
        canon = getattr(MM, fold)(p, m.spec)
        kinds = (kind,) * len(canon["layers"])
        x = MM._posenc_pre(coords, m.spec)
        case = real_pair_case(torch, RM, canon, x, g, kinds,
                              dcoords=False)[:4]
        if kind == "relu":
            # the relu pattern reference on the flattened rows
            flat = dict(canon=canon, x=x.reshape(-1, x.shape[-1]),
                        kinds=kinds, cot=g.reshape(-1, 3), dcoords=False)
            case += (lambda what, flat=flat: relu_pattern_reference(
                torch, RM, flat, what),)
        cases[f"multisr {nonlin}"] = case
    m = TMS.setup("mfn")["model"]
    p = m.init(torch.Generator().manual_seed(0), device)
    cases["multisr mfn"] = mfn_pair_case(torch, MF, p, coords, g, m.spec,
                                         dcoords=False)
    return cases


def multisr_check(case, what):
    """The case's kernel outputs against the reference
    tools/port_multisr_reference.py decided: the plain version run in
    float64 for MULTISR_FLOAT64_CASES (on the kernel's relu pattern for
    MULTISR_RELU_PATTERN_CASES), else in fp32.  Returns (max abs err, the
    kernel's outputs)."""
    kernel, plain, args, kwargs = case[:4]
    got = kernel()
    if what in MULTISR_RELU_PATTERN_CASES:
        want = case[4](what)[0]
        flat = dict(got, out=got["out"].reshape(want["out"].shape))
        return compare(flat, want, what), got
    if what in MULTISR_FLOAT64_CASES:
        return compare_float64(got, plain, args, kwargs, what)[0], got
    return compare(got, plain(*args, **kwargs), what), got


def multisr_kernel_vs_plain(torch, np, TMS, WM, RM, MM, MF, device):
    """max abs err of each multisr_cases case against its reference
    (multisr_check), two calls of each giving identical bits."""
    errs = {"wire_mlp": {}, "real_mlp": {}, "mfn_mlp": {}}
    lib = {"wire": "wire_mlp", "gauss": "real_mlp", "posenc": "real_mlp",
           "mfn": "mfn_mlp"}
    for what, case in multisr_cases(torch, np, TMS, WM, RM, MM, MF,
                                    device).items():
        err, got = multisr_check(case, what)
        torch.cuda.synchronize()
        same_bits(torch, case[0](), got, what)
        errs[lib[what.split(" ")[1]]][what] = err
    return errs


def measure_multi_sr(torch, np, TMS, WM, device, build):
    """Row 2 (the wire_mlp pair) at the multi-SR batch, as the fit calls it
    (the app's (4, 36,864, 2) frame grids, parameter gradients, no
    dcoords): host-call ms, its kernels' device ms, the plain version's
    ms, the library yardstick's (torch.matmul forward + written-out
    backward), the 3xTF32 and fp32 bounds from apply_flops less the dcoords
    product, the time by product class; then at the reference protocol's
    512^2 x 4 frames (1,048,576 rows) ms and kernel_ms alone."""
    prob = TMS.setup()
    model = prob["model"]
    spec = model.spec
    params = model.init(torch.Generator().manual_seed(0), device)
    rng = np.random.default_rng(51)
    coords = torch.tensor(prob["ds"].coords, device=device)
    b, n1, d = coords.shape
    n = b * n1
    o, L, h = spec.out_features, spec.hidden_layers, \
        params["first"]["w"].shape[1]
    g = torch.tensor(rng.normal(size=(b, n1, o)).astype(np.float32),
                     device=device)
    keys = leaf_paths(params)
    leaves = [v for _, v in tree_leaves(params)]
    kfn, pfn = (pair_fn(a, spec, keys) for a in (WM.wire_mlp,
                                                 WM.wire_mlp_plain))

    def call(fn=kfn, c=coords, cot=g):
        return param_vjp(torch, fn, c, leaves, cot)
    flops = WM.apply_flops(n, d, h, o, L) - 2 * n * d * h
    nweights = num_weights(params)
    nbytes = 4 * (n * d + 2 * n * o + 2 * nweights)
    res = {"rows": n, "complex_units": h, "gflop": flops / 1e9,
           "mbytes": nbytes / 1e6,
           "ms": cuda_ms(torch, call, 20),
           "kernel_ms": kernel_device_ms(torch, call, 20,
                                         kernel_names("wire_mlp")),
           "plain_ms": cuda_ms(torch, lambda: call(pfn), 10)}
    w = WM.stack_params(params, L)
    c2, g2 = coords.reshape(-1, d), g.reshape(-1, o)
    lib = matmul_vjp(torch, w, c2, spec, lambda y: g2)
    dp = WM.unstack_grads(*lib[1:4], params, L)
    got = {"out": lib[0].reshape(b, n1, o)}
    got.update({f"d{i + 1}": v for i, (_, v) in enumerate(tree_leaves(dp))})
    want = call(pfn)
    res["library_vs_plain_max_abs_err"] = max(
        float((got[k] - want[k]).abs().max()) for k in want)
    res["library_ms"] = cuda_ms(torch, lambda: matmul_vjp(
        torch, w, c2, spec, lambda y: g2), 10)
    res["library"] = "torch.matmul forward + written-out backward"
    del lib, dp, got, want
    res["achieved_tflops"] = (flops / (res["kernel_ms"] * 1e9)
                              if res["kernel_ms"] else None)
    res.update(tensor_core_fields(torch, build, call, "wire_mlp", flops,
                                  nbytes, res["kernel_ms"]))
    nbig = 4 * MULTISR_BIG_SIDE ** 2
    big = torch.tensor(rng.uniform(-1, 1, (4, nbig // 4, 2)).astype(
        np.float32), device=device)
    gbig = torch.tensor(rng.normal(size=(4, nbig // 4, o)).astype(
        np.float32), device=device)
    torch.cuda.reset_peak_memory_stats()
    res["at_512"] = {
        "rows": nbig,
        "gflop": (WM.apply_flops(nbig, d, h, o, L) - 2 * nbig * d * h) / 1e9,
        "ms": cuda_ms(torch, lambda: call(c=big, cot=gbig), 5),
        "kernel_ms": kernel_device_ms(torch, lambda: call(c=big, cot=gbig),
                                      5, kernel_names("wire_mlp")),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30}
    res["at_512"]["bound_3xtf32_ms"] = bound_3xtf32(
        res["at_512"]["gflop"] * 1e9, 0)[0]
    del big, gbig
    torch.cuda.empty_cache()
    return res


MULTISR_PAIR = {"wire": "wire_mlp", "siren": "real_mlp", "gauss": "real_mlp",
                "relu": "real_mlp", "posenc": "real_mlp", "mfn": "mfn"}


def fit_multi_sr(torch, np, mods, counters, device):
    """The multi-SR app (wire_tpu_torch.apps.multi_sr.run at its defaults:
    192^2, x4, 4 frames, WIRE 256 wide = 181 complex units) for
    MULTISR_ITERS iterations with the known motion, through the kernels
    (counts reset just before and read just after: one wire_mlp forward and
    one backward an iteration, one forward more for the no-grad render of
    the best parameters, no other kernel; the .mat written) and through
    the plain path (fused='never'), from one init and one frame order: the
    kernel fit's best PSNR at or above wire_tpu's CPU fit less 0.2 dB and
    within PSNR_AGREE_DB of the plain fit's.  The same with
    register_burst's motion: its warps' errors against the known motion,
    and the floor.  Then siren, gauss, relu, posenc and mfn for
    MULTISR_OTHER_ITERS iterations each, each launching its own pair once
    an iteration (and once more for the render) and nothing else; and a
    profiled 20-iteration WIRE fit's device idle share."""
    import tempfile
    TMS, WS, fit_frames = mods
    out = {}

    def app_run(tmp, nonlin, iters, **kw):
        reset_counts(counters)
        ws0 = wire_step_launches()
        app = TMS.run(nonlin, results_dir=tmp, niters=iters, device=device,
                      **kw)
        launches = read_counts(counters)
        launches["wire_step"] = {"step": wire_step_launches() - ws0}
        res = app["result"]
        if not (np.isfinite(res.mse_gt).all()
                and res.mse_gt.shape == (iters,)
                and np.isfinite(app["psnr"]) and os.path.isfile(app["mat"])):
            raise AssertionError(f"multi-SR {nonlin}: non-finite values, a "
                                 f"wrong shape or no .mat")
        return app, launches

    def pair_launches(nonlin, iters):
        lib = MULTISR_PAIR[nonlin]
        return {(lib, "forward"): iters + 1, (lib, "backward"): iters}

    with tempfile.TemporaryDirectory() as tmp:
        app, launches = app_run(tmp, "wire", MULTISR_ITERS)
        check_real_launches(launches, "multi-SR wire",
                            pair_launches("wire", MULTISR_ITERS))
        plain, after = app_run(os.path.join(tmp, "plain"), "wire",
                               MULTISR_ITERS, fused="never")
        check_real_launches(after, "multi-SR wire plain", {})
        if not abs(app["psnr"] - plain["psnr"]) <= PSNR_AGREE_DB:
            raise AssertionError(
                f"multi-SR: kernel fit {app['psnr']:.3f} dB vs plain fit "
                f"{plain['psnr']:.3f} dB differ by more than "
                f"{PSNR_AGREE_DB} dB")
        est, est_launches = app_run(os.path.join(tmp, "estim"), "wire",
                                    MULTISR_ITERS, use_gt_registration=False)
        check_real_launches(est_launches, "multi-SR wire estim",
                            pair_launches("wire", MULTISR_ITERS))
        floors = {k: v - 0.2 for k, v in WIRE_TPU_300_MULTISR_DB.items()}
        for tag, a in (("oracle", app), ("estim", est)):
            if not a["psnr"] >= floors[tag]:
                raise AssertionError(
                    f"multi-SR {tag}: kernel fit best PSNR {a['psnr']:.4f} "
                    f"dB below the floor {floors[tag]:.4f} dB")
        out.update(
            iters=MULTISR_ITERS,
            launches=launches["wire_mlp"],
            estim_launches=est_launches["wire_mlp"],
            psnr_db=app["psnr"], psnr_plain_db=plain["psnr"],
            psnr_estim_db=est["psnr"], floors_db=floors,
            ssim=app["ssim"], psnr_interp_db=app["psnr_interp"],
            psnr_interp_estim_db=est["psnr_interp"],
            registration=est["registration"],
            ms_per_iter=app["result"].step_ms,
            plain_ms_per_iter=plain["result"].step_ms,
            estim_ms_per_iter=est["result"].step_ms,
            fit_wall_s=app["result"].wall_time_s,
            plain_fit_wall_s=plain["result"].wall_time_s)
        others = {}
        for nonlin in MULTISR_NONLINS:
            a, launches = app_run(os.path.join(tmp, nonlin), nonlin,
                                  MULTISR_OTHER_ITERS)
            check_real_launches(launches, f"multi-SR {nonlin}",
                                pair_launches(nonlin, MULTISR_OTHER_ITERS))
            others[nonlin] = dict(
                launches=launches[MULTISR_PAIR[nonlin]], psnr_db=a["psnr"],
                ms_per_iter=a["result"].step_ms)
        out["others"] = others
    prob = TMS.setup(niters=20)
    ds, model = prob["ds"], prob["model"]
    params = model.init(torch.Generator().manual_seed(0), device)
    busy, wall, idle = profiled_idle(torch, lambda: fit_frames(
        model, params, ds.coords, ds.pixels, ds.masks, prob["cfg"],
        hr_shape=prob["im"].shape, scale=4, device=device), 20)
    out.update(profiled_busy_ms_per_iter=busy,
               profiled_wall_ms_per_iter=wall, device_idle_share=idle)
    return out


class ResumeStop(Exception):
    """Raised just after a fit's second save: the fit is stopped there."""


def same_fit(torch, np, a, b, what):
    """Two FitResults equal bit for bit: histories, best loss, parameters,
    best parameters and fields."""
    for f in ("mse_gt", "mse_noisy", "best_rec", "final_rec", "time_array"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (
                x is not None and not np.array_equal(x, y)):
            raise AssertionError(f"{what}: the resumed fit's {f} differs")
    if a.best_mse != b.best_mse:
        raise AssertionError(f"{what}: the resumed fit's best loss differs")
    for name in ("params", "best_params"):
        pa, pb = tree_leaves(getattr(a, name)), tree_leaves(getattr(b, name))
        for (path, x), (_, y) in zip(pa, pb):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: the resumed fit's {name} "
                                     f"{path} differs")


def resumed_fit(torch, np, T, fit, what, tmp):
    """Runs ``fit(None)`` uninterrupted, then ``fit(spec)`` stopped by
    ResumeStop just after its second save, then ``fit(spec)`` again, which
    resumes from the file: the two results must be equal bit for bit
    (same_fit).  Returns the epochs the file held and the fits' wall
    times."""
    t0 = time.time()
    ref = fit(None)
    t_ref = time.time() - t0
    spec = T.CheckpointSpec(path=os.path.join(tmp, f"{what}.npz"))
    orig, calls = T._save_fit_state, [0]

    def save(*a, **k):
        orig(*a, **k)
        calls[0] += 1
        if calls[0] == 2:
            raise ResumeStop

    T._save_fit_state = save
    try:
        fit(spec)
        raise AssertionError(f"{what}: the fit ran past its second save")
    except ResumeStop:
        pass
    finally:
        T._save_fit_state = orig
    with np.load(spec.path) as z:
        stopped_at = int(z["done"])
    t0 = time.time()
    res = fit(spec)
    t_res = time.time() - t0
    same_fit(torch, np, ref, res, what)
    return dict(stopped_at=stopped_at, epochs=len(ref.mse_gt),
                uninterrupted_wall_s=t_ref, resumed_wall_s=t_res), ref


def fit_resume(torch, np, mods, counters, device):
    """Checkpoint/resume and the chunked render on the card.  Each fit of
    RESUME_SHAPES (the multi-SR app's WIRE fit through fit_frames, the
    occupancy app's chunked fit through fit_pointwise, WIRE CT with the
    rotate method through fit_operator; each with its scan_segment) is
    stopped just after its second save and resumed: history, parameters
    and best parameters equal the uninterrupted fit's bit for bit
    (resumed_fit).  A checkpoint of the CT fit is refused by a fit of
    another measurement.  Then WIRE CT rotate for RENDER_ITERS iterations
    rendered in RENDER_CHUNK_ROWS-row chunks against the whole-grid render,
    counts reset just before each and read just after: loss histories
    within RENDER_REL_TOL relative, less peak memory, and the launches the
    recompute implies (each chunk's forward twice, its backward once;
    rotsum's pair once an iteration)."""
    import tempfile
    T, TMS, O, TCT, TR, get_config, WS = mods
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        iters, seg = RESUME_SHAPES["multi_sr"]
        prob = TMS.setup(niters=iters)
        ds, model = prob["ds"], prob["model"]
        params = model.init(torch.Generator().manual_seed(0), device)
        cfg = dataclasses.replace(prob["cfg"], scan_segment=seg)
        out["multi_sr"], _ = resumed_fit(torch, np, T, lambda ck: T.fit_frames(
            model, params, ds.coords, ds.pixels, ds.masks, cfg,
            hr_shape=prob["im"].shape, scale=4, checkpoint=ck, device=device),
            "multi_sr", tmp)
        iters, seg = RESUME_SHAPES["occupancy"]
        out["occupancy"], _ = resumed_fit(torch, np, T, lambda ck: O.run(
            results_dir=os.path.join(tmp, "occ"), niters=iters,
            scan_segment=seg, checkpoint_path=None if ck is None else ck.path,
            device=device)["result"], "occupancy", tmp)
        iters, seg = RESUME_SHAPES["ct_rotate"]
        ccfg = get_config(CT_CONFIG)
        ct_model = TCT.build_ct_model(ccfg, ccfg.omega0)
        img = TCT.ct_image(None, 0)
        H, W = img.shape
        thetas = np.linspace(0, 180, 100, dtype=np.float32)
        grid = TCT.C.grid2d(H, W)
        sino = TCT.make_sinogram(img, thetas, radon_method="rotate",
                                 device=device)
        op = TR.RadonOp(thetas, method="rotate")
        ct_params = ct_model.init(torch.Generator().manual_seed(0), device)
        T_cfg = T.FitConfig(learning_rate=ccfg.learning_rate, niters=iters,
                            maxpoints=ccfg.maxpoints, scan_segment=seg)

        def ct_fit(ck, meas=sino, cfg=T_cfg, **kw):
            return T.fit_operator(ct_model, ct_params, grid, meas, op, cfg,
                                  gt_field=img, field_shape=(H, W),
                                  checkpoint=ck, device=device, **kw)
        out["ct_rotate"], _ = resumed_fit(torch, np, T, ct_fit, "ct_rotate",
                                          tmp)
        try:
            ct_fit(T.CheckpointSpec(path=os.path.join(tmp, "ct_rotate.npz")),
                   meas=sino * 1.01)
            raise AssertionError("fit_resume: a foreign checkpoint was "
                                 "resumed")
        except ValueError as e:
            if "DIFFERENT fit" not in str(e):
                raise
        out["foreign_checkpoint"] = "refused"

        rcfg = dataclasses.replace(T_cfg, niters=RENDER_ITERS,
                                   maxpoints=RENDER_CHUNK_ROWS)
        render = {}
        for name, chunked in (("whole", False), ("chunked", True)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts(counters)
            ws0 = wire_step_launches()
            r = ct_fit(None, cfg=rcfg, render_chunked=chunked)
            launches = read_counts(counters)
            launches["wire_step"] = {"step": wire_step_launches() - ws0}
            nchunks = -(-H * W // RENDER_CHUNK_ROWS) if chunked else 1
            want = {("wire_mlp", "forward"): RENDER_ITERS * nchunks * (
                        2 if chunked else 1),
                    ("wire_mlp", "backward"): RENDER_ITERS * nchunks,
                    ("rotsum", "forward"): RENDER_ITERS,
                    ("rotsum", "adjoint"): RENDER_ITERS}
            check_real_launches(launches, f"render {name}", want)
            render[name] = dict(
                chunks=nchunks, launches={k: launches[k] for k in (
                    "wire_mlp", "rotsum")},
                peak_allocated_mb=(torch.cuda.max_memory_allocated() - base)
                / 2**20, ms_per_iter=r.step_ms, result=r)
        whole, chunked = render["whole"].pop("result"), \
            render["chunked"].pop("result")
        rel = float(np.max(np.abs(chunked.mse_noisy / whole.mse_noisy - 1)))
        if not rel <= RENDER_REL_TOL:
            raise AssertionError(f"render_chunked: loss history {rel:.3e} "
                                 f"relative from the whole render's")
        if not (render["chunked"]["peak_allocated_mb"]
                < render["whole"]["peak_allocated_mb"]):
            raise AssertionError(f"render_chunked: peak memory not lower: "
                                 f"{render}")
        render["loss_rel_apart"] = rel
        render["best_rec_max_abs_apart"] = float(
            np.abs(chunked.best_rec - whole.best_rec).max())
        out["render_chunked"] = render
    return out


# ---- the batched multi-fit slice ------------------------------------------

# replicas of the batched kernels' checks, and of the CT, SISR and chunked
# denoise fits; the WIRE-300 denoise fit's replicas and epochs; the chunked
# denoise fit's chunk (4 chunks of the 65,536 points) and epochs; the
# iterations of the operator and frame fits; the multi-SR fits' replicas
MANY_M = 3
MANY_DENOISE_M = 4
MANY_DENOISE_EPOCHS = 50
MANY_CHUNK_POINTS = 16384
MANY_CHUNK_EPOCHS = 10
MANY_ITERS = 20
MANY_MULTISR_M = 2
# CT 'auto' (fourier) replicas against their serial fits: loss histories
# within this relative distance (the batched FFTs and the scatter's atomics
# round apart from the serial fit's), best PSNR within PSNR_AGREE_DB
MANY_FOURIER_REL = 1e-4
# timing repeats of the batched kernels and of their M unbatched calls
MANY_TIMING_ITERS = 10
# the batched kernels' shapes: WIRE-300's rows (the denoise and CT grids,
# 256^2), a ragged step's rows per replica, a ragged pair's, the rotsum
# image side (the sweep's CT, 512^2), the fourier spectrum's P at the CT
# grid, and one multi-SR frame's rows (192^2)
MANY_SHAPES = dict(rows=256 * 256, ragged_step=700, ragged_pair=4097,
                   side=512, P=1024, frame_rows=192 * 192)


def model_stack(torch, model, seeds, device):
    """A replica stack of ``model``'s inits, one per seed."""
    from wire_tpu_torch import tree
    return tree.stack([model.init(torch.Generator().manual_seed(s), device)
                       for s in seeds])


def replica_case(torch, many, singles, plains, what, scatter=()):
    """Holds a batched call's outputs ``many`` ({name: (M, ...) tensor})
    replica by replica: bit-equal to the unbatched kernel's ``singles[r]``
    (the names in ``scatter``, added with atomics, within REL_TOL of it
    instead) and within REL_TOL x max|plain| of the plain version's
    ``plains[r]``.  Returns the worst abs error against the plain version."""
    worst = 0.0
    for r, (one, want) in enumerate(zip(singles, plains)):
        mine = {k: v[r] for k, v in many.items()}
        for k in one:
            if k in scatter:
                compare({k: mine[k]}, {k: one[k]},
                        f"{what} replica {r} vs the unbatched kernel")
            elif not torch.equal(mine[k], one[k]):
                raise AssertionError(f"{what}: replica {r}'s {k} differs "
                                     f"from the unbatched kernel's")
        worst = max(worst, compare(mine, want, f"{what} replica {r}"))
    return worst


def once_each(torch, counter, before, what):
    """A batched call advanced each of its kernel's counts by exactly one."""
    now = counter() if callable(counter) else dict(counter)
    want = ({k: v + 1 for k, v in before.items()} if isinstance(before, dict)
            else before + 1)
    if now != want:
        raise AssertionError(f"{what}: launches went {before} -> {now}, "
                             f"expected one launch for all replicas")


def many_case(torch, counter, many_fn, one_fn, ref_fn, M, what):
    """A batched call ``many_fn()`` ({name: (M, ...) tensor}) against the
    unbatched call ``one_fn(r)`` and the reference ``ref_fn(r)`` of each
    replica (replica_case): one launch for all replicas (``counter()``,
    its kernel's counts), two calls bit-equal.  (kernel thunk, serial
    thunk, max abs err)."""
    before = counter()
    got = many_fn()
    once_each(torch, counter, before, what)
    again = many_fn()
    torch.cuda.synchronize()
    same_bits(torch, again, got, what)
    singles = [one_fn(r) for r in range(M)]
    refs = [ref_fn(r) for r in range(M)]
    return (many_fn, lambda: [one_fn(r) for r in range(M)],
            replica_case(torch, got, singles, refs, what))


def many_step_case(torch, WS, spec, ps, coords, target, gt, nvalid, denom,
                   what):
    """wire_step_many against the unbatched kernel and the plain step per
    replica; many_case's (kernel thunk, serial thunk, max abs err)."""
    from wire_tpu_torch import tree
    M = tree.replicas(ps)
    kw = dict(nvalid=nvalid, denom=denom, want_metrics=True)

    def args(r):
        return (tree.index(ps, r), tree.replica(coords, r, M),
                tree.replica(target, r, M), spec)

    return many_case(
        torch, wire_step_launches,
        lambda: tensors_of(*WS.wire_step_many(ps, coords, target, spec,
                                              gt=gt, **kw)),
        lambda r: tensors_of(*WS.wire_step(*args(r), gt=tree.replica(
            gt, r, M), **kw)),
        lambda r: tensors_of(*WS.wire_step_plain(*args(r), gt=tree.replica(
            gt, r, M), **kw)), M, what)


def param_pair(torch, apply, params, spec, coords, cot):
    """{"out", "<leaf path>": ...} of ``apply``'s forward and its gradient
    in the parameters (no coordinate gradient) against ``cot``."""
    keys = leaf_paths(params)
    leaves = [t.detach().clone().requires_grad_(True)
              for _, t in tree_leaves(params)]
    y = apply(tree_unflatten(keys, leaves), coords, spec)
    grads = torch.autograd.grad(y, leaves, cot, allow_unused=True)
    out = {"out": y.detach()}
    for k, leaf, g in zip(keys, leaves, grads):
        out[".".join(map(str, k))] = torch.zeros_like(leaf) if g is None \
            else g
    return out


def many_pair_case(torch, WM, spec, ps, coords, cot, what):
    """wire_mlp_many's pair against the unbatched pair and the plain
    version per replica; many_case's (kernel thunk, serial thunk, max abs
    err)."""
    from wire_tpu_torch import tree
    M = tree.replicas(ps)

    def one(r, apply):
        return param_pair(torch, apply, tree.index(ps, r), spec,
                          tree.replica(coords, r, M), cot[r])

    return many_case(
        torch, lambda: ops_launches("wire_mlp"),
        lambda: param_pair(torch, WM.wire_mlp_many, ps, spec, coords, cot),
        lambda r: one(r, WM.wire_mlp), lambda r: one(r, WM.wire_mlp_plain),
        M, what)


def many_radon_case(torch, mod, fn, plain, x, cot, names, what,
                    scatter=()):
    """A Radon kernel pair (rotsum, line_sample) on an (M, ...) stack
    against the unbatched pair and the plain version per replica; ``fn``
    and ``plain`` map an input with its gradient to the output, ``names``
    names the output and the input's gradient.  (kernel thunk, serial
    thunk, max abs err)."""
    def run(f, xin, c):
        xin = xin.detach().clone().requires_grad_(True)
        y = f(xin)
        (g,) = torch.autograd.grad(y, xin, c)
        if y.is_complex():
            y, g = torch.view_as_real(y), torch.view_as_real(g)
        return {names[0]: y.detach(), names[1]: g}

    def kernel():
        return run(fn, x, cot)

    def serial():
        return [run(fn, x[r], cot[r]) for r in range(x.shape[0])]

    before = ops_launches(mod)
    got = kernel()
    once_each(torch, lambda: ops_launches(mod), before, what)
    again = kernel()
    torch.cuda.synchronize()
    same_bits(torch, again, {k: v for k, v in got.items()
                             if k not in scatter}, what)
    plains = [run(plain, x[r], cot[r]) for r in range(x.shape[0])]
    return kernel, serial, replica_case(torch, got, serial(), plains, what,
                                        scatter=scatter)


def many_kernel_vs_plain(torch, np, mods, device):
    """Each kernel with a replica axis at MANY_M replicas of distinct
    weights: wire_step at WIRE-300's full shape (65,536 rows, h 212, shared
    coordinates and targets) and a ragged one (700 rows per replica, nvalid
    650 over a sentinel tail, denom), the wire_mlp pair at the CT shape
    (shared coordinates), on per-replica coordinates (4,097 rows) and at
    the multi-SR batch ((M, 4, 36,864, 2), h 181), rotsum on a stack of
    512^2 images at 100 angles and line_sample at the CT shape (P 1,024,
    100 angles): one launch per call for all replicas (a pair one a
    direction), two calls bit-equal, each replica bit-equal to the
    unbatched kernel on its inputs (line_sample's scatter within REL_TOL of
    it) and within REL_TOL of the plain version.  Then each batched call's
    time against the M unbatched calls', with the batched call's least
    time (each replica's work and bytes, the shared inputs once).  Shapes from MANY_SHAPES.  Returns ({kernel:
    {case: max abs err}}, {kernel: times})."""
    WS, WM, R, LS, TR, TCT, TMS, get_inr, get_config = mods
    from wire_tpu_torch import tree
    sh = MANY_SHAPES
    rng = np.random.default_rng(19)
    seeds = range(11, 11 + MANY_M)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def rows(lead):
        """coordinates in [-1, 1), targets and gt in [0, 1)"""
        return (t(rng.uniform(-1, 1, lead + (2,))),
                t(rng.uniform(0, 1, lead + (3,))),
                t(rng.uniform(0, 1, lead + (3,))))

    errs = {k: {} for k in ("wire_step", "wire_mlp", "rotsum",
                            "line_sample")}
    thunks = {}
    wire300 = get_inr("wire", in_features=2, out_features=3,
                      hidden_features=300, hidden_layers=2, first_omega0=7.0,
                      hidden_omega0=7.0, scale=8.0)
    ps = model_stack(torch, wire300, seeds, device)
    step_weights = num_weights(tree.index(ps, 0))
    n = sh["rows"]
    side = int(round(n ** 0.5))
    kern, ser, errs["wire_step"]["many_full"] = many_step_case(
        torch, WS, wire300.spec, ps, *rows((n,)), None, None,
        "wire_step_many full")
    thunks["wire_step"] = (kern, ser)
    errs["wire_step"]["many_ragged"] = many_step_case(
        torch, WS, wire300.spec, ps, *rows((MANY_M, sh["ragged_step"])),
        sh["ragged_step"] - 50, (sh["ragged_step"] - 50) * 3.0 + 1.0,
        "wire_step_many ragged")[2]

    ct_model, _ = ct_models(get_inr, TCT, get_config(CT_CONFIG))
    ps = model_stack(torch, ct_model, seeds, device)
    pair_weights = num_weights(tree.index(ps, 0))
    spec = ct_model.spec
    kern, ser, errs["wire_mlp"]["many_ct"] = many_pair_case(
        torch, WM, spec, ps, t(TCT.C.grid2d(side, side)),
        t(rng.normal(size=(MANY_M, n, 1))), "wire_mlp_many CT")
    thunks["wire_mlp"] = (kern, ser)
    errs["wire_mlp"]["many_ragged"] = many_pair_case(
        torch, WM, spec, ps,
        t(rng.uniform(-1, 1, (MANY_M, sh["ragged_pair"], 2))),
        t(rng.normal(size=(MANY_M, sh["ragged_pair"], 1))),
        "wire_mlp_many ragged")[2]
    msr = TMS.setup(niters=1)["model"]
    ps = model_stack(torch, msr, seeds, device)
    frames = (MANY_M, 4, sh["frame_rows"])
    errs["wire_mlp"]["many_multi_sr"] = many_pair_case(
        torch, WM, msr.spec, ps, t(rng.uniform(-1, 1, frames + (2,))),
        t(rng.normal(size=frames + (3,))), "wire_mlp_many multi-SR")[2]

    S, A = sh["side"], 100
    angles = np.linspace(0, 180, A, dtype=np.float32)
    parts = R.angle_parts_tensor(angles, True, device)
    kern, ser, errs["rotsum"]["many_512"] = many_radon_case(
        torch, R, lambda x: R.rotate_project(x, angles, parts=parts),
        lambda x: R.rotate_project_plain(x, angles),
        t(rng.random((MANY_M, S, S))), t(rng.normal(size=(MANY_M, A, S))),
        ("sino", "img_bar"), "rotsum stack 512")
    thunks["rotsum"] = (kern, ser)

    P = sh["P"]
    centre, gy, gx, uncentre = TR._fourier_consts(P, angles, device)

    def cplx(shape):
        return torch.view_as_complex(t(rng.normal(size=shape + (2,))))
    kern, ser, errs["line_sample"]["many_ct"] = many_radon_case(
        torch, LS, lambda x: LS.sample_spectrum(x, centre, gy, gx, uncentre),
        lambda x: LS.sample_spectrum_plain(x, centre, gy, gx, uncentre),
        cplx((MANY_M, P, P)), cplx((MANY_M,) + tuple(gy.shape)),
        ("slice", "F_bar"), "line_sample stack CT", scatter=("F_bar",))
    thunks["line_sample"] = (kern, ser)

    # the least time of the batched call: M x each replica's operations and
    # its own bytes, the inputs the replicas share (wire_step's coordinates,
    # target and gt, wire_mlp's coordinates, line_sample's tables) once
    h, M = 212, MANY_M
    work = {
        "wire_step": bound_3xtf32(
            M * WS.step_flops(n, 2, h, 3, 2),
            4 * (n * 8 + M * (n * 3 + 2 * step_weights + 2))),
        "wire_mlp": bound_3xtf32(
            M * (WM.apply_flops(n, 2, h, 1, 2) - 2 * n * 2 * h),
            4 * (n * 2 + M * (2 * n + 2 * pair_weights))),
        "rotsum": bound(M * 2 * R.sample_flops(A, S),
                        M * 4 * 2 * (S * S + A * S)),
        "line_sample": bound(M * 2 * LS.sample_flops(A, gy.shape[1]),
                             line_sample_bytes(torch, gy, gx, P, M)),
    }
    times = {}
    for name, (kernel, serial) in thunks.items():
        bound_ms, by = work[name]
        times[name] = dict(
            replicas=MANY_M, ms=cuda_ms(torch, kernel, MANY_TIMING_ITERS),
            serial_ms=cuda_ms(torch, serial, MANY_TIMING_ITERS),
            bound_ms=bound_ms, bound_by=by,
            shape={"wire_step": f"WIRE-300 denoise, {n} rows",
                   "wire_mlp": f"CT, {n} rows, no dcoords",
                   "rotsum": f"{S}^2, {A} angles",
                   "line_sample": f"P {P}, {A} angles"}[name])
    return errs, times


def many_vs_serial(np, many, serials, what, exact=True):
    """Replica r of a batched fit against the serial fit ``serials[r]`` (at
    seed + r from replica r's init): with ``exact`` the histories, the best
    MSE, the best and final reconstructions (where there are) and the
    final and best parameters bit for bit, else the loss histories within
    MANY_FOURIER_REL relative."""
    from wire_tpu_torch import tree
    for r, one in enumerate(serials):
        if not exact:
            h, w = many.mse_noisy[:, r], one.mse_noisy
            rel = float(np.max(np.abs(h - w) / np.abs(w)))
            if not rel <= MANY_FOURIER_REL:
                raise AssertionError(f"{what}: replica {r}'s loss history "
                                     f"{rel:.2e} from the serial fit's")
            continue
        pairs = [(many.mse_gt[:, r], one.mse_gt),
                 (many.mse_noisy[:, r], one.mse_noisy),
                 (many.best_mse[r], np.float32(one.best_mse))]
        for name in ("best_rec", "final_rec"):
            if getattr(one, name) is not None:
                pairs.append((getattr(many, name)[r], getattr(one, name)))
        for params in ("params", "best_params"):
            mine = tree.leaves(tree.index(getattr(many, params), r))
            for (_, a), (_, b) in zip(mine, tree.leaves(getattr(one,
                                                                params))):
                pairs.append((a.cpu().numpy(), b.cpu().numpy()))
        for i, (a, b) in enumerate(pairs):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"{what}: replica {r} differs from the "
                                     f"serial fit at seed + {r} (item {i})")


def fit_many(torch, np, mods, counters, device):
    """The batched fits, each against its M serial fits (counts reset just
    before and read just after the batched fit; peak device memory of each
    over the replicas; ms per epoch or iteration of the batched fit and of
    the serial fits added up): WIRE-300 denoise at full batch (bit-equal;
    one wire_step launch an epoch), the chunked WIRE denoise (4 chunks an
    epoch, each replica its own permutations; one launch a chunk), CT
    rotate (bit-equal; one wire_mlp and one rotsum pair an iteration), CT
    'auto' = fourier (loss within MANY_FOURIER_REL, best PSNR within
    PSNR_AGREE_DB; one line_sample pair an iteration), the sweep's WIRE
    SISR (bit-equal), the multi-SR app's WIRE on one burst and on a burst
    per replica (bit-equal); then ``sweep --seeds 2`` of each task through
    ``main`` at SWEEP_ITERS, launching WIRE's kernels and nothing else."""
    import dataclasses
    import tempfile
    (T, WS, TR, TCT, TMS, TS, SW, TF, M, get_inr, get_config, bench,
     tree) = mods
    out = {}

    def run(*args):
        many_fit_run(torch, np, WS, counters, out, *args)

    def exact(name):
        return lambda many, serials: many_vs_serial(np, many, serials, name)

    # WIRE-300 denoise, full batch, and chunked
    im, im_noisy, grid, model = bench.setup(256, 256)
    target, gt = im_noisy.reshape(-1, 3), im.reshape(-1, 3)
    for name, m, cfg in (
            ("denoise", MANY_DENOISE_M, T.FitConfig(
                learning_rate=5e-3, niters=MANY_DENOISE_EPOCHS,
                maxpoints=256 * 256, scale_lr_by_batch=True)),
            ("denoise_chunked", MANY_M, T.FitConfig(
                learning_rate=5e-3, niters=MANY_CHUNK_EPOCHS,
                maxpoints=MANY_CHUNK_POINTS, scale_lr_by_batch=True,
                seed=3))):
        ps = model_stack(torch, model, range(m), device)
        steps = cfg.niters * (256 * 256 // min(cfg.maxpoints, 256 * 256))
        run(name, {("wire_step", "step"): steps},
            lambda: T.fit_pointwise_many(model, ps, grid, target, cfg, gt=gt,
                                         device=device),
            [lambda r=r: T.fit_pointwise(
                model, tree.index(ps, r), grid, target,
                dataclasses.replace(cfg, seed=cfg.seed + r), gt=gt,
                device=device) for r in range(m)], cfg.niters, m,
            exact(name))

    # CT rotate and 'auto' (fourier)
    ct_cfg = get_config(CT_CONFIG)
    ct_model, _ = ct_models(get_inr, TCT, ct_cfg)
    img = TCT.ct_image(None, 0)
    H, W = img.shape
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    ps = model_stack(torch, ct_model, range(MANY_M), device)
    cfg = T.FitConfig(learning_rate=ct_cfg.learning_rate, niters=MANY_ITERS,
                      maxpoints=ct_cfg.maxpoints)
    for method, radon_kernel in (("rotate", ("rotsum", "adjoint")),
                                 ("auto", ("line_sample", "scatter"))):
        sino = TCT.make_sinogram(img, thetas, radon_method=method,
                                 device=device)
        op = TR.RadonOp(thetas, method=method)
        fwd = {"rotsum": "forward", "line_sample": "gather"}[radon_kernel[0]]

        def fourier_check(many, serials):
            many_vs_serial(np, many, serials, "CT auto", exact=False)
            psnrs = [float(M.psnr_ref(img, many.best_rec[r]))
                     for r in range(MANY_M)]
            serial = [float(M.psnr_ref(img, s.best_rec)) for s in serials]
            if not max(abs(a - b) for a, b in zip(psnrs, serial)) \
                    <= PSNR_AGREE_DB:
                raise AssertionError(f"fit_many CT auto: best PSNRs {psnrs} "
                                     f"vs serial {serial}")
            return {"psnr_db": psnrs, "serial_psnr_db": serial}

        run(f"ct_{method}",
            {("wire_mlp", "forward"): MANY_ITERS,
             ("wire_mlp", "backward"): MANY_ITERS,
             (radon_kernel[0], fwd): MANY_ITERS,
             radon_kernel: MANY_ITERS},
            lambda: T.fit_operator_many(ct_model, ps, TCT.C.grid2d(H, W),
                                        sino, op, cfg, gt_field=img,
                                        field_shape=(H, W), device=device),
            [lambda r=r: T.fit_operator(
                ct_model, tree.index(ps, r), TCT.C.grid2d(H, W), sino, op,
                cfg, gt_field=img, field_shape=(H, W), device=device)
             for r in range(MANY_M)], MANY_ITERS, MANY_M,
            exact("ct_rotate") if method == "rotate" else fourier_check)

    # the sweep's WIRE SISR (256 wide, 768^2 stand-in -> 256^2 HR, x4)
    im_hr, im_lr = TS.sisr_images(None, 0, 4, size=768)
    H, W, _ = im_hr.shape
    model = SW._build("wire", "sisr", H, W, tau=1e2)
    ps = SW.seed_inits(model, MANY_M, 0, device)
    cfg = T.FitConfig(learning_rate=SW._SISR_LR["wire"], niters=MANY_ITERS,
                      lr_decay=0.2)
    run("sisr", {("wire_mlp", "forward"): MANY_ITERS,
                 ("wire_mlp", "backward"): MANY_ITERS},
        lambda: T.fit_operator_many(model, ps, TCT.C.grid2d(H, W), im_lr,
                                    TF.DownsampleOp(4), cfg, gt_field=im_hr,
                                    field_shape=(H, W, 3), device=device),
        [lambda r=r: T.fit_operator(
            model, tree.index(ps, r), TCT.C.grid2d(H, W), im_lr,
            TF.DownsampleOp(4), cfg, gt_field=im_hr, field_shape=(H, W, 3),
            device=device) for r in range(MANY_M)], MANY_ITERS, MANY_M,
        exact("sisr"))

    # the multi-SR app's WIRE: one burst for every replica, and one each
    probs = [TMS.setup(seed=s, niters=MANY_ITERS)
             for s in range(MANY_MULTISR_M)]
    model, cfg = probs[0]["model"], probs[0]["cfg"]
    ps = model_stack(torch, model, range(MANY_MULTISR_M), device)
    hr = probs[0]["im"].shape
    fkw = dict(hr_shape=hr, scale=4, batch_size=4, device=device)
    for name, batched in (("multi_sr", False), ("multi_sr_bursts", True)):
        ds = [p["ds"] for p in probs]
        frames = ((np.stack([d.coords for d in ds]),
                   np.stack([d.pixels for d in ds]),
                   np.stack([d.masks for d in ds])) if batched
                  else (ds[0].coords, ds[0].pixels, ds[0].masks))
        run(name, {("wire_mlp", "forward"): MANY_ITERS,
                   ("wire_mlp", "backward"): MANY_ITERS},
            lambda: T.fit_frames_many(model, ps, *frames, cfg,
                                      batched_frames=batched, **fkw),
            [lambda r=r: T.fit_frames(
                model, tree.index(ps, r),
                *(ds[r if batched else 0].coords,
                  ds[r if batched else 0].pixels,
                  ds[r if batched else 0].masks),
                dataclasses.replace(cfg, seed=cfg.seed + r), **fkw)
             for r in range(MANY_MULTISR_M)], MANY_ITERS, MANY_MULTISR_M,
            exact(name))

    # sweep --seeds 2 of each task through main
    out["sweep_seeds"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for task in ("denoise", "sisr", "ct"):
            t0 = time.time()
            reset_counts(counters)
            ws0 = wire_step_launches()
            res = SW.main([task, "--seeds", "2", "--nonlins", "wire",
                           "--niters", str(SWEEP_ITERS), "--results_dir",
                           os.path.join(tmp, task)])
            launches = read_counts(counters)
            launches["wire_step"] = {"step": wire_step_launches() - ws0}
            check_real_launches(launches, f"sweep --seeds {task}",
                                sweep_expected(task, "wire", SWEEP_ITERS))
            key = "mse_db" if task == "sisr" else "psnrs"
            if not (len(res[key]) == 2 and np.isfinite(res[key]).all()
                    and np.isfinite(res["recs"]).all()):
                raise AssertionError(f"sweep --seeds {task}: results "
                                     f"{res[key]}")
            out["sweep_seeds"][task] = dict(
                metric=res[key], step_ms=res["step_ms"],
                launches={k: v for k, v in launches.items()
                          if any(v.values())},
                wall_s=time.time() - t0)
    return out


def many_fit_run(torch, np, WS, counters, out, name, want, many_fn,
                 serial_fns, iters, m, compare_fn):
    """One batched fit ``many_fn()`` against its serial fits (counts reset
    just before and read just after the batched fit, which must launch
    ``want`` and nothing else; peak device memory of each; ms per epoch or
    iteration of the batched fit and of the serial fits added up), recorded
    in ``out[name]``."""
    t0 = time.time()
    reset_counts(counters)
    ws0 = wire_step_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    many = many_fn()
    peak_many = torch.cuda.max_memory_allocated()
    launches = read_counts(counters)
    launches["wire_step"] = {"step": wire_step_launches() - ws0}
    check_real_launches(launches, f"fit_many {name}", want)
    serials, peak_one = [], 0
    for fn in serial_fns:
        torch.cuda.reset_peak_memory_stats()
        serials.append(fn())
        peak_one = max(peak_one, torch.cuda.max_memory_allocated())
    extra = compare_fn(many, serials) or {}
    for r in (many, *serials):
        if not (np.isfinite(r.mse_noisy).all()
                and np.isfinite(r.best_mse).all()):
            raise AssertionError(f"fit_many {name}: non-finite values")
    out[name] = dict(
        replicas=m, iters=iters,
        launches={k: v for k, v in launches.items() if any(v.values())},
        launches_per_iter={f"{k}.{kk}": v / iters
                           for k, c in launches.items()
                           for kk, v in c.items() if v},
        ms_per_iter=many.step_ms,
        serial_ms_per_iter=sum(s.step_ms for s in serials),
        peak_mb_per_replica=peak_many / m / 2 ** 20,
        serial_peak_mb=peak_one / 2 ** 20,
        wall_s=time.time() - t0, **extra)


# ---- the batched multi-fit of the real families and the MFN -------------

# replicas of the real and MFN batched kernels' checks, and of the fits:
# B-spline denoise's replicas and epochs, the chunked siren denoise's
# chunk (4 chunks of the 65,536 points) and epochs, the repIN fold's
# replicas and epochs, the MFN denoise's epochs, the gauss multi-SR fits'
# replicas (their iterations, and the operator fits', are MANY_ITERS)
MANY_REAL_DENOISE_M = 4
MANY_REAL_DENOISE_EPOCHS = 50
MANY_REPIN_M = 2
MANY_REPIN_EPOCHS = 20
MANY_MFN_EPOCHS = 50
MANY_GAUSS_MULTISR_M = 2
# the real and MFN replica kernels' shapes: the B-spline denoise step's rows
# (256^2, 2 -> 256 x 3 -> 3), a ragged step's rows per replica, the
# B-spline SISR pair's HR side (168^2 = 28,224 rows), the sweep's SISR side
# (posenc's step at d 26, the MFN SISR pair), the multi-SR frames' rows
# (192^2), the MFN denoise rows (256^2, h 300)
MANY_REAL_SHAPES = dict(rows=256 * 256, ragged_step=700, sisr_side=168,
                        sweep_side=256, frame_rows=192 * 192)
# the sweep --seeds runs of the other families: denoise each, CT siren and
# posenc, SISR gauss and mfn
MANY_SEEDS_RUNS = (("denoise", "siren"), ("denoise", "gauss"),
                   ("denoise", "relu"), ("denoise", "posenc"),
                   ("denoise", "mfn"), ("ct", "siren"), ("ct", "posenc"),
                   ("sisr", "gauss"), ("sisr", "mfn"))


def many_real_step(torch, RM, canon, coords, target, gt, kinds, what,
                   relu=False, **kw):
    """real_step_many on a canonical stack against the unbatched kernel and
    each replica's reference: the plain step in fp32, or (``relu``) the
    float64 run on the kernel's own relu pattern
    (relu_pattern_step_reference, fault C.9).  many_case's triple."""
    from wire_tpu_torch import tree
    from wire_tpu_torch.ops.wire_step import StepScratch
    M = tree.replicas(canon)
    kw = dict(kw, want_metrics=True)
    scratch, ones = StepScratch(), [StepScratch() for _ in range(M)]

    def rep(x, r):
        return tree.replica(x, r, M)

    def many():
        return real_step_tensors(RM, *RM.real_step_many(
            canon, coords, target, kinds, gt=gt, scratch=scratch, **kw))

    def one(r):
        return real_step_tensors(RM, *RM.real_step(
            tree.index(canon, r), rep(coords, r), rep(target, r), kinds,
            gt=rep(gt, r), scratch=ones[r], **kw))

    def ref(r):
        args = (tree.index(canon, r), rep(coords, r), rep(target, r), kinds)
        kwr = dict(kw, gt=rep(gt, r))
        if relu:
            acts = [ones[r]._bufs[f"real_a{l}"] for l in range(len(kinds))]
            return relu_pattern_step_reference(torch, RM, *args, kwr, acts,
                                               what)[0]
        return real_step_plain_fn(RM)(*args, **kwr)

    return many_case(torch, lambda: ops_launches("real_mlp")["step"], many,
                     one, ref, M, f"real_step_many {what}")


def many_real_pair(torch, RM, canon, coords, cot, kinds, what):
    """The real_mlp_many pair (output and canonical gradients against
    ``cot``) against the unbatched pair and the plain version in fp32 per
    replica.  many_case's triple."""
    from wire_tpu_torch import tree
    M = tree.replicas(canon)
    L = len(kinds)

    def run(fn, cn, c, g):
        leaves = [t.detach().clone().requires_grad_(True)
                  for _, t in RM.canon_leaves(cn)]
        y = fn(RM.canon_from_leaves(leaves, L), c)
        grads = torch.autograd.grad(y, leaves, g)
        out = {"out": y.detach()}
        out.update({f"d{i}": gr for i, gr in enumerate(grads)})
        return out

    def plain(cn, c):
        y = RM.real_mlp_plain(cn, c.reshape(-1, c.shape[-1]), kinds)
        return y.reshape(*c.shape[:-1], y.shape[-1])

    def one(r, fn):
        return run(fn, tree.index(canon, r), tree.replica(coords, r, M),
                   cot[r])

    return many_case(
        torch, lambda: {k: ops_launches("real_mlp")[k]
                        for k in ("forward", "backward")},
        lambda: run(lambda cn, c: RM.real_mlp_many(cn, c, kinds), canon,
                    coords, cot),
        lambda r: one(r, lambda cn, c: RM.real_mlp(cn, c, kinds)),
        lambda r: one(r, plain), M, f"real_mlp_many {what}")


def many_tree_step(torch, mod, name, spec, ps, coords, target, gt, what,
                   **kw):
    """A step over a family's own parameter tree with a replica axis
    (``mod``'s ``<name>_many``: mfn_step, wire2d_step) against the
    unbatched kernel ``<name>`` and the plain step ``<name>_plain`` in
    fp32 per replica.  many_case's triple."""
    from wire_tpu_torch import tree
    from wire_tpu_torch.ops.wire_step import StepScratch
    M = tree.replicas(ps)
    kw = dict(kw, want_metrics=True)
    scratch, one_scratch = StepScratch(), StepScratch()
    many, one, plain = (getattr(mod, name + suffix)
                        for suffix in ("_many", "", "_plain"))

    def rep(x, r):
        return tree.replica(x, r, M)

    def args(r):
        return (tree.index(ps, r), rep(coords, r), rep(target, r), spec)

    return many_case(
        torch, lambda: ops_launches(mod)["step"],
        lambda: tensors_of(*many(ps, coords, target, spec, gt=gt,
                                 scratch=scratch, **kw)),
        lambda r: tensors_of(*one(*args(r), gt=rep(gt, r),
                                  scratch=one_scratch, **kw)),
        lambda r: tensors_of(*plain(*args(r), gt=rep(gt, r), **kw)),
        M, f"{name}_many {what}")


def many_tree_pair(torch, mod, name, spec, ps, coords, cot, what,
                   float64=False):
    """A pair over a family's own parameter tree with a replica axis
    (``mod``'s ``<name>_many``: mfn_mlp, wire2d_mlp) against the
    unbatched pair ``<name>`` and the plain version ``<name>_plain`` per
    replica, in fp32 or (``float64``) run in float64.  many_case's
    triple."""
    from wire_tpu_torch import tree
    M = tree.replicas(ps)
    many, single, plain = (getattr(mod, name + suffix)
                           for suffix in ("_many", "", "_plain"))

    def one(r, apply, cast=lambda x: x):
        return param_pair(torch, apply, cast(tree.index(ps, r)), spec,
                          cast(tree.replica(coords, r, M)), cast(cot[r]))

    return many_case(
        torch, lambda: {k: ops_launches(mod)[k]
                        for k in ("forward", "backward")},
        lambda: param_pair(torch, many, ps, spec, coords, cot),
        lambda r: one(r, single),
        lambda r: one(r, plain, float64_tree if float64 else (lambda x: x)),
        M, f"{name}_many {what}")


def many_real_vs_plain(torch, np, mods, device):
    """The replica axis of rows 5, 6, 10 and 11 at MANY_M replicas of
    distinct weights: real_step at the B-spline denoise path (65,536 rows,
    2 -> 256 x 3 -> 3, shared coordinates and targets) and a ragged one
    (700 rows per replica, nvalid 650, denom), at posenc (the sweep's SISR
    posenc, d 26 on the tensor cores, held to the float64 run on the
    kernel's relu pattern) and at the repIN fold (K 1,024); the real_mlp
    pair at the B-spline SISR path (28,224 rows) on shared and on
    per-replica coordinates and at the multi-SR app's gauss on the frame
    grids ((M, 4, 36,864, 2)); mfn_step at the sweep's MFN denoise (h 300,
    k 3) full and ragged; the mfn_mlp pair at the sweep's MFN SISR (h
    256).  One launch per call for all replicas (a pair one a direction),
    two calls bit-equal, each replica bit-equal to the unbatched kernel on
    its inputs and within REL_TOL of its reference.  Then each batched
    call's time against the M unbatched calls', with the batched call's
    least time.  Returns ({kernel: {case: max abs err}}, {kernel:
    times})."""
    RM, MF, MM, SW, TC, TMS, get_inr, get_config = mods
    from wire_tpu_torch import tree
    sh = MANY_REAL_SHAPES
    rng = np.random.default_rng(23)
    seeds = range(31, 31 + MANY_M)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def targets(lead, o=3):
        return (t(rng.uniform(0, 1, lead + (o,))),
                t(rng.uniform(0, 1, lead + (o,))))

    errs = {k: {} for k in ("real_step", "real_mlp", "mfn_step", "mfn_mlp")}
    thunks = {}
    n = sh["rows"]
    side = int(round(n ** 0.5))
    grid = t(SW.C.grid2d(side, side))

    # row 6: the B-spline denoise path, full and ragged
    model_a, _ = real_models(get_inr, TC, get_config(REAL_DENOISE_CONFIG),
                             7.0, side)
    canon = tree.stack([path_canon(torch, MM, model_a, s, device)[0]
                        for s in seeds])
    kinds = ("qspline",) * len(canon["layers"])
    widths_a = RM._widths(tree.index(canon, 0), 2)
    nw_a = num_weights(tree.index(canon, 0))
    kern, ser, errs["real_step"]["many_full"] = many_real_step(
        torch, RM, canon, grid, *targets((n,)), kinds, "full")
    thunks["real_step"] = (kern, ser)
    nr = sh["ragged_step"]
    errs["real_step"]["many_ragged"] = many_real_step(
        torch, RM, canon, t(rng.uniform(-1, 1, (MANY_M, nr, 2))),
        *targets((MANY_M, nr)), kinds, "ragged", nvalid=nr - 50,
        denom=(nr - 50) * 3.0 + 1.0)[2]
    # posenc at the sweep's SISR shape: d 26 on the tensor cores
    ss = sh["sweep_side"]
    posenc = SW._build("posenc", "sisr", ss, ss, 1e2)
    canon_p = tree.stack([MM._canon_relu(posenc.init(
        torch.Generator().manual_seed(s), device), posenc.spec)
        for s in seeds])
    x = MM._posenc_pre(t(SW.C.grid2d(ss, ss)), posenc.spec).contiguous()
    errs["real_step"]["many_posenc"] = many_real_step(
        torch, RM, canon_p, x, *targets((ss * ss,)),
        ("relu",) * len(canon_p["layers"]), "posenc", relu=True)[2]
    # the repIN fold: the first layer's K 1,024 on the tensor cores
    _, repin, _ = family_models(get_inr, TC, get_config,
                                "bspline_mscale_repIN")
    folds = [family_fold(torch, MM, repin, s, device) for s in seeds]
    x = folds[0][2](grid).contiguous()
    errs["real_step"]["many_repin_fold"] = many_real_step(
        torch, RM, tree.stack([f[0] for f in folds]), x, *targets((n,)),
        folds[0][1], "repin_fold")[2]

    # row 5: the B-spline SISR path, shared and per-replica coordinates
    sides = sh["sisr_side"]
    model_b, _ = real_models(get_inr, TC, get_config(REAL_SISR_CONFIG), 8.0,
                             sides)
    canon_b = tree.stack([path_canon(torch, MM, model_b, s, device)[0]
                          for s in seeds])
    kinds_b = ("qspline",) * len(canon_b["layers"])
    widths_b = RM._widths(tree.index(canon_b, 0), 2)
    nw_b = num_weights(tree.index(canon_b, 0))
    nb = sides * sides
    kern, ser, errs["real_mlp"]["many_sisr"] = many_real_pair(
        torch, RM, canon_b, t(SW.C.grid2d(sides, sides)),
        t(rng.normal(size=(MANY_M, nb, 3))), kinds_b, "SISR")
    thunks["real_mlp"] = (kern, ser)
    errs["real_mlp"]["many_sisr_per_replica"] = many_real_pair(
        torch, RM, canon_b, t(rng.uniform(-1, 1, (MANY_M, nb, 2))),
        t(rng.normal(size=(MANY_M, nb, 3))), kinds_b, "SISR per replica")[2]
    gauss = TMS.setup("gauss", niters=1)["model"]
    canon_g = tree.stack([MM._canon_gauss(gauss.init(
        torch.Generator().manual_seed(s), device), gauss.spec)
        for s in seeds])
    frames = (MANY_M, 4, sh["frame_rows"])
    errs["real_mlp"]["many_multi_sr_gauss"] = many_real_pair(
        torch, RM, canon_g, t(rng.uniform(-1, 1, frames + (2,))),
        t(rng.normal(size=frames + (3,))),
        ("gauss",) * len(canon_g["layers"]), "multi-SR gauss")[2]

    # rows 11 and 10: the sweep's MFN denoise (h 300) and SISR (h 256)
    mfn_d, _ = mfn_models(get_inr, SW, "denoise", side, side)
    ps = model_stack(torch, mfn_d, seeds, device)
    nw_md = num_weights(tree.index(ps, 0))
    kern, ser, errs["mfn_step"]["many_full"] = many_tree_step(
        torch, MF, "mfn_step", mfn_d.spec, ps, grid, *targets((n,)), "full")
    thunks["mfn_step"] = (kern, ser)
    gt_r = targets((MANY_M, nr))
    errs["mfn_step"]["many_ragged"] = many_tree_step(
        torch, MF, "mfn_step", mfn_d.spec, ps,
        t(rng.uniform(-1, 1, (MANY_M, nr, 2))), *gt_r, "ragged",
        nvalid=nr - 50, denom=(nr - 50) * 3.0 + 1.0)[2]
    mfn_s, _ = mfn_models(get_inr, SW, "sisr", ss, ss)
    ps = model_stack(torch, mfn_s, seeds, device)
    nw_ms = num_weights(tree.index(ps, 0))
    kern, ser, errs["mfn_mlp"]["many_sisr"] = many_tree_pair(
        torch, MF, "mfn_mlp", mfn_s.spec, ps, t(SW.C.grid2d(ss, ss)),
        t(rng.normal(size=(MANY_M, ss * ss, 3))), "SISR")
    thunks["mfn_mlp"] = (kern, ser)

    # the least time of the batched call: M x each replica's operations and
    # its own bytes, the inputs the replicas share (coordinates, target and
    # gt) once
    M, ns = MANY_M, ss * ss
    hd, hs = mfn_d.spec.hidden_features, mfn_s.spec.hidden_features
    work = {
        "real_step": bound_3xtf32(
            M * RM.step_flops(n, widths_a),
            4 * (n * 8 + M * (n * 3 + 2 * nw_a + 2))),
        "real_mlp": bound_3xtf32(
            M * (RM.apply_flops(nb, widths_b)
                 - 2 * nb * widths_b[0] * widths_b[1]),
            4 * (nb * 2 + M * (2 * nb * 3 + 2 * nw_b))),
        "mfn_step": bound_3xtf32(
            M * MF.step_flops(n, 2, hd, 3, 3),
            4 * (n * 8 + M * (n * 3 + 2 * nw_md + 2))),
        "mfn_mlp": bound_3xtf32(
            M * (MF.apply_flops(ns, 2, hs, 3, 3) - 3 * 2 * 2 * ns * hs * 2),
            4 * (ns * 2 + M * (2 * ns * 3 + 2 * nw_ms))),
    }
    shapes = {"real_step": f"B-spline denoise, {n} rows, widths {widths_a}",
              "real_mlp": f"B-spline SISR, {nb} rows, no dcoords",
              "mfn_step": f"MFN denoise, {n} rows, h {hd}, k 3",
              "mfn_mlp": f"MFN SISR, {ns} rows, h {hs}, no dcoords"}
    times = {}
    for name, (kernel, serial) in thunks.items():
        bound_ms, by = work[name]
        times[name] = dict(
            replicas=MANY_M, ms=cuda_ms(torch, kernel, MANY_TIMING_ITERS),
            serial_ms=cuda_ms(torch, serial, MANY_TIMING_ITERS),
            bound_ms=bound_ms, bound_by=by, shape=shapes[name])
    return errs, times


def fit_many_real(torch, np, mods, counters, device):
    """The batched fits of the real families and the MFN, each against its
    M serial fits (many_fit_run): B-spline denoise (REAL_DENOISE_CONFIG,
    full batch; one real_step launch an epoch), the sweep's siren denoise
    chunked (4 chunks an epoch, each replica its own permutations; one
    launch a chunk), the repIN fold's denoise (FAMILIES_PRESET), B-spline
    SISR (REAL_SISR_CONFIG; one real_mlp pair an iteration), the sweep's
    MFN denoise (one mfn_step an epoch) and MFN SISR (one mfn_mlp pair an
    iteration), the multi-SR app's gauss on one burst and on a burst per
    replica: every replica bit-equal to its serial fit.  Then ``sweep
    --seeds 2`` through ``main`` for MANY_SEEDS_RUNS at SWEEP_ITERS, each
    launching its family's kernels and nothing else."""
    import dataclasses
    import tempfile
    (T, WS, TCT, TMS, TS, TD, TC, SW, TF, get_inr, get_config, tree) = mods
    out = {}

    def run(*args):
        many_fit_run(torch, np, WS, counters, out, *args)

    def exact(name):
        return lambda many, serials: many_vs_serial(np, many, serials, name)

    def pointwise(name, model, m, cfg, im, noisy, want):
        ps = model_stack(torch, model, range(m), device)
        H, W, _ = im.shape
        grid = TD.C.grid2d(H, W)
        run(name, want,
            lambda: T.fit_pointwise_many(model, ps, grid,
                                         noisy.reshape(-1, 3), cfg,
                                         gt=im.reshape(-1, 3),
                                         device=device),
            [lambda r=r: T.fit_pointwise(
                model, tree.index(ps, r), grid, noisy.reshape(-1, 3),
                dataclasses.replace(cfg, seed=cfg.seed + r),
                gt=im.reshape(-1, 3), device=device) for r in range(m)],
            cfg.niters, m, exact(name))

    def operator(name, model, m, cfg, im, lr, want):
        ps = model_stack(torch, model, range(m), device)
        H, W, _ = im.shape
        grid, op = TS.C.grid2d(H, W), TF.DownsampleOp(im.shape[0]
                                                      // lr.shape[0])
        run(name, want,
            lambda: T.fit_operator_many(model, ps, grid, lr, op, cfg,
                                        gt_field=im, field_shape=im.shape,
                                        device=device),
            [lambda r=r: T.fit_operator(
                model, tree.index(ps, r), grid, lr, op, cfg, gt_field=im,
                field_shape=im.shape, device=device) for r in range(m)],
            cfg.niters, m, exact(name))

    # B-spline denoise, full batch
    cfg = get_config(REAL_DENOISE_CONFIG)
    im, noisy = TD.denoise_images(cfg)
    model, _ = real_models(get_inr, TC, cfg, 7.0, im.shape[0])
    pointwise("bspline_denoise", model, MANY_REAL_DENOISE_M, T.FitConfig(
        learning_rate=cfg.learning_rate, niters=MANY_REAL_DENOISE_EPOCHS,
        maxpoints=cfg.maxpoints, scale_lr_by_batch=True), im, noisy,
        {("real_mlp", "step"): MANY_REAL_DENOISE_EPOCHS})
    # the sweep's siren denoise, chunked
    im, noisy = SW.denoise_images()
    H, W, _ = im.shape
    model = SW._build("siren", "denoise", H, W, 3e1)
    chunks = H * W // MANY_CHUNK_POINTS
    pointwise("siren_denoise_chunked", model, MANY_M, T.FitConfig(
        learning_rate=SW._DENOISE_LR["siren"], niters=MANY_CHUNK_EPOCHS,
        maxpoints=MANY_CHUNK_POINTS, scale_lr_by_batch=True, seed=3), im,
        noisy, {("real_mlp", "step"): MANY_CHUNK_EPOCHS * chunks})
    # the repIN fold's denoise
    fcfg, model, _ = family_models(get_inr, TC, get_config,
                                   "bspline_mscale_repIN")
    im, noisy = TD.denoise_images(fcfg)
    pointwise("repin_denoise", model, MANY_REPIN_M, T.FitConfig(
        learning_rate=fcfg.learning_rate, niters=MANY_REPIN_EPOCHS,
        maxpoints=fcfg.maxpoints, scale_lr_by_batch=True), im, noisy,
        {("real_mlp", "step"): MANY_REPIN_EPOCHS})
    # B-spline SISR
    cfg = get_config(REAL_SISR_CONFIG)
    im, lr = TS.sisr_images(None, 0, cfg.down_scale)
    model, _ = real_models(get_inr, TC, cfg, 8.0, im.shape[0])
    operator("bspline_sisr", model, MANY_M, T.FitConfig(
        learning_rate=cfg.learning_rate, niters=MANY_ITERS,
        maxpoints=cfg.maxpoints, lr_decay=0.2), im, lr,
        {("real_mlp", "forward"): MANY_ITERS,
         ("real_mlp", "backward"): MANY_ITERS})
    # the sweep's MFN denoise and SISR
    im, noisy = SW.denoise_images()
    model, _ = mfn_models(get_inr, SW, "denoise", H, W)
    pointwise("mfn_denoise", model, MANY_M, T.FitConfig(
        learning_rate=SW._DENOISE_LR["mfn"], niters=MANY_MFN_EPOCHS,
        maxpoints=H * W, scale_lr_by_batch=True), im, noisy,
        {("mfn", "step"): MANY_MFN_EPOCHS})
    im, lr = TS.sisr_images(None, 0, 4, size=768)
    model, _ = mfn_models(get_inr, SW, "sisr", *im.shape[:2])
    operator("mfn_sisr", model, MANY_M, T.FitConfig(
        learning_rate=SW._SISR_LR["mfn"], niters=MANY_ITERS, lr_decay=0.2),
        im, lr, {("mfn", "forward"): MANY_ITERS,
                 ("mfn", "backward"): MANY_ITERS})

    # the multi-SR app's gauss: one burst for every replica, and one each
    m = MANY_GAUSS_MULTISR_M
    probs = [TMS.setup("gauss", seed=s, niters=MANY_ITERS) for s in range(m)]
    model, cfg = probs[0]["model"], probs[0]["cfg"]
    ps = model_stack(torch, model, range(m), device)
    fkw = dict(hr_shape=probs[0]["im"].shape, scale=4, batch_size=4,
               device=device)
    ds = [p["ds"] for p in probs]
    for name, batched in (("multi_sr_gauss", False),
                          ("multi_sr_gauss_bursts", True)):
        frames = ((np.stack([d.coords for d in ds]),
                   np.stack([d.pixels for d in ds]),
                   np.stack([d.masks for d in ds])) if batched
                  else (ds[0].coords, ds[0].pixels, ds[0].masks))
        run(name, {("real_mlp", "forward"): MANY_ITERS,
                   ("real_mlp", "backward"): MANY_ITERS},
            lambda: T.fit_frames_many(model, ps, *frames, cfg,
                                      batched_frames=batched, **fkw),
            [lambda r=r: T.fit_frames(
                model, tree.index(ps, r),
                *(ds[r if batched else 0].coords,
                  ds[r if batched else 0].pixels,
                  ds[r if batched else 0].masks),
                dataclasses.replace(cfg, seed=cfg.seed + r), **fkw)
             for r in range(m)], MANY_ITERS, m, exact(name))

    # sweep --seeds 2 of the other families through main
    out["sweep_seeds"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for task, nonlin in MANY_SEEDS_RUNS:
            t0 = time.time()
            reset_counts(counters)
            ws0 = wire_step_launches()
            res = SW.main([task, "--seeds", "2", "--nonlins", nonlin,
                           "--niters", str(SWEEP_ITERS), "--results_dir",
                           os.path.join(tmp, f"{task}_{nonlin}")])
            launches = read_counts(counters)
            launches["wire_step"] = {"step": wire_step_launches() - ws0}
            check_real_launches(launches, f"sweep --seeds {task} {nonlin}",
                                sweep_expected(task, nonlin, SWEEP_ITERS))
            key = "mse_db" if task == "sisr" else "psnrs"
            if not (len(res[key]) == 2 and np.isfinite(res[key]).all()
                    and np.isfinite(res["recs"]).all()):
                raise AssertionError(f"sweep --seeds {task} {nonlin}: "
                                     f"results {res[key]}")
            out["sweep_seeds"][f"{task}_{nonlin}"] = dict(
                metric=res[key], step_ms=res["step_ms"],
                launches={k: v for k, v in launches.items()
                          if any(v.values())},
                wall_s=time.time() - t0)

    return out


# ---- the batched multi-fit of WIRE-2D, mscale_2 and the autodiff families --

# replicas and epochs of the WIRE-2D and mscale_2 denoise fits, replicas of
# the WIRE-2D CT fit (its iterations MANY_ITERS), replicas and epochs of
# the autodiff fits (realgabor, bspline_sig and mscale_2 at combine_type
# 'both' denoise; bspline_knots SISR, MANY_ITERS iterations)
MANY_W2D_M = 3
MANY_W2D_EPOCHS = 50
MANY_MSCALE2_M = 3
MANY_MSCALE2_EPOCHS = 50
MANY_AUTODIFF_M = 2
MANY_AUTODIFF_EPOCHS = 20
# the autodiff replicas against their serial fits: best PSNR within
# PSNR_AGREE_DB, the bound of two fits that differ by fp32 summation order,
# since the batched products of torch.func.vmap (cuBLAS's batched kernels)
# need not round as the serial ones do: realgabor's histories part by
# 6.6e-4 relative in 20 epochs on the card; and the histories within this
# relative distance, a bound on gross errors only (a replica stepped with
# another's or a wrong gradient parts from its serial fit by far more);
# the measured distance is reported
MANY_AUTODIFF_REL = 1e-2
# the replica counts at which one autodiff step's launches are counted
# (check_launches_by_replicas)
MANY_PROFILE_M = (2, 4)
# rows 7-9's batched kernels' shapes: the denoise and CT grids (256^2), a
# ragged step's rows per replica, a ragged pair's
MANY_REST_SHAPES = dict(rows=256 * 256, ragged_step=700, ragged_pair=4097)


def combiner_relu_pattern(torch, ystack, comb, n):
    """The combiner relu's pattern u0 > 0 (n x 128) as csrc/mscale2_step.cu's
    combiner_kernel decides it from the trunk outputs ``ystack`` (ns n x o,
    the step's own scratch): u0 = f0 + sum_c y_c F0[c], one fp32 fma at a
    time in c order, each modelled in float64 (the product of two floats is
    exact there; the sum is rounded to float32 once more)."""
    o = ystack.shape[-1]
    ns = ystack.shape[0] // n
    ycat = ystack.reshape(ns, n, o).permute(1, 0, 2).reshape(n, ns * o)
    F0 = comb["freq_0"]["w"].double()
    u0 = comb["freq_0"]["b"].reshape(1, -1).expand(n, -1).float()
    for c in range(ns * o):
        u0 = (u0.double() + ycat[:, c:c + 1].double() * F0[c]).float()
    return u0 > 0


def mscale2_pattern_reference(torch, MS, args, kw, mask):
    """mscale2_step_plain run in float64 (every input cast) with the
    combiner relu taking ``mask`` (the kernel's own pattern) in place of
    its own sign: the reference where a combiner unit lies within fp32
    rounding of the kink (fault C.11)."""
    from wire_tpu_torch.nn import activations as act
    relu = act.relu
    act.relu = lambda z: z * mask.to(z.dtype)
    try:
        return mscale2_plain(MS)(*float64_tree(args), **float64_tree(kw))
    finally:
        act.relu = relu


def many_mscale2_step(torch, MS, canon, comb, coords, target, gt, kinds,
                      inv, what, **kw):
    """mscale2_step_many against the unbatched kernel and, per replica, the
    plain step run in float64 on the unbatched kernel's own combiner relu
    pattern (mscale2_pattern_reference: at these seeded inputs one or two
    of the combiner's 8.4 million relu inputs lie within fp32 rounding of
    0, fault C.11).  many_case's triple."""
    from wire_tpu_torch import tree
    from wire_tpu_torch.ops.wire_step import StepScratch
    M = tree.replicas(canon)
    kw = dict(kw, want_metrics=True)
    scratch, ones = StepScratch(), [StepScratch() for _ in range(M)]

    def rep(x, r):
        return tree.replica(x, r, M)

    def args(r):
        return (tree.index(canon, r), tree.index(comb, r), rep(coords, r),
                rep(target, r), kinds, inv)

    def ref(r):
        n = rep(coords, r).shape[0]
        mask = combiner_relu_pattern(torch, ones[r]._bufs["ms_y"],
                                     tree.index(comb, r), n)
        return mscale2_pattern_reference(torch, MS, args(r),
                                         dict(kw, gt=rep(gt, r)), mask)

    return many_case(
        torch, lambda: ops_launches("mscale2_step")["step"],
        lambda: mscale2_tensors(*MS.mscale2_step_many(
            canon, comb, coords, target, kinds, inv, gt=gt, scratch=scratch,
            **kw)),
        lambda r: mscale2_tensors(*MS.mscale2_step(
            *args(r), gt=rep(gt, r), scratch=ones[r], **kw)),
        ref, M, f"mscale2_step_many {what}")


def many_rest_vs_plain(torch, np, mods, device):
    """The replica axis of rows 7, 8 and 9 at MANY_M replicas of distinct
    weights: wire2d_step at the WIRE-2D denoise path (65,536 rows, 300
    wide, shared coordinates and targets) and a ragged one (700 rows per
    replica, nvalid 650, denom); the wire2d_mlp pair at the CT path (o 1,
    the CT frequencies, shared coordinates), on per-replica coordinates
    (4,097 rows) and at WIRE2D_CT_WIDTH held to its plain version run in
    float64; mscale2_step at the mscale_2 denoise path (65,536 rows, 3
    scales, shared) and a ragged two-scale one (700 rows per replica,
    nvalid 650, denom), held to the float64 run on the kernel's own
    combiner relu pattern (fault C.11).  One launch per call for
    all replicas (a pair one a direction), two calls bit-equal, each
    replica bit-equal to the unbatched kernel on its inputs and within
    REL_TOL of its reference.  Then each batched call's time against the
    M unbatched calls', with the batched call's least time (each replica's
    work and bytes, the shared inputs once).  Returns ({kernel: {case: max
    abs err}}, {kernel: times})."""
    W2, MS, MM, TC, get_inr, get_config = mods
    from wire_tpu_torch import tree
    sh = MANY_REST_SHAPES
    rng = np.random.default_rng(41)
    seeds = range(41, 41 + MANY_M)
    M = MANY_M

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def rows(lead, o=3):
        """coordinates in [-1, 1), targets and gt in [0, 1)"""
        return (t(rng.uniform(-1, 1, lead + (2,))),
                t(rng.uniform(0, 1, lead + (o,))),
                t(rng.uniform(0, 1, lead + (o,))))

    errs = {k: {} for k in ("wire2d_step", "wire2d_mlp", "mscale2_step")}
    thunks = {}
    n, nr = sh["rows"], sh["ragged_step"]

    # row 8: the WIRE-2D denoise path, full and ragged
    model = get_inr("wire2d", **WIRE2D_DENOISE_KW)
    ps = model_stack(torch, model, seeds, device)
    nw_s = num_weights(tree.index(ps, 0))
    h = int(tree.index(ps, 0)["first_lin"]["w"].shape[1])
    kern, ser, errs["wire2d_step"]["many_full"] = many_tree_step(
        torch, W2, "wire2d_step", model.spec, ps, *rows((n,)), "full")
    thunks["wire2d_step"] = (kern, ser)
    errs["wire2d_step"]["many_ragged"] = many_tree_step(
        torch, W2, "wire2d_step", model.spec, ps, *rows((M, nr)), "ragged",
        nvalid=nr - 50, denom=(nr - 50) * 3.0 + 1.0)[2]

    # row 9: the WIRE-2D CT path, shared and per-replica coordinates, and
    # the CT-frequency width case against float64
    ct_kw = dict(WIRE2D_DENOISE_KW, out_features=1)
    ct_kw.update(wire2d_ct_kw(get_config))
    ct_model = get_inr("wire2d", **ct_kw)
    ps = model_stack(torch, ct_model, seeds, device)
    nw_p = num_weights(tree.index(ps, 0))
    kern, ser, errs["wire2d_mlp"]["many_ct"] = many_tree_pair(
        torch, W2, "wire2d_mlp", ct_model.spec, ps, rows((n,))[0],
        t(rng.normal(size=(M, n, 1))), "CT")
    thunks["wire2d_mlp"] = (kern, ser)
    npr = sh["ragged_pair"]
    errs["wire2d_mlp"]["many_ragged"] = many_tree_pair(
        torch, W2, "wire2d_mlp", ct_model.spec, ps, rows((M, npr))[0],
        t(rng.normal(size=(M, npr, 1))), "ragged")[2]
    hf, _, layers, o, nw = WIRE2D_CT_WIDTH
    narrow = get_inr("wire2d", **dict(ct_kw, hidden_features=hf,
                                      hidden_layers=layers,
                                      out_features=o))
    errs["wire2d_mlp"]["many_ct_width_float64"] = many_tree_pair(
        torch, W2, "wire2d_mlp", narrow.spec,
        model_stack(torch, narrow, seeds, device), rows((M, nw))[0],
        t(rng.normal(size=(M, nw, o))), "CT width", float64=True)[2]

    # row 7: the mscale_2 denoise path (3 scales), full and ragged (2)
    ms_models = mscale2_models(get_inr, TC, get_config(MSCALE2_CONFIG))

    def folds(model):
        fs = [mscale2_fold(torch, MM, model, s, device) for s in seeds]
        return (tree.stack([f[0] for f in fs]), tree.stack([f[1] for f in fs]),
                fs[0][2], fs[0][3])

    canon, comb, kinds, inv = folds(ms_models[0])
    widths = [2] + [lay["w"].shape[-1] for lay in canon["layers"]] + [3]
    nw_m = num_weights(tree.index(canon, 0)) + num_weights(
        tree.index(comb, 0))
    kern, ser, errs["mscale2_step"]["many_full"] = many_mscale2_step(
        torch, MS, canon, comb, *rows((n,)), kinds, inv, "full")
    thunks["mscale2_step"] = (kern, ser)
    canon2, comb2, kinds2, inv2 = folds(ms_models[2])
    errs["mscale2_step"]["many_ragged"] = many_mscale2_step(
        torch, MS, canon2, comb2, *rows((M, nr)), kinds2, inv2, "ragged",
        nvalid=nr - 50, denom=(nr - 50) * 3.0 + 1.0)[2]

    # the least time of the batched call: M x each replica's operations and
    # its own bytes, the inputs the replicas share (coordinates, target and
    # gt) once
    work = {
        "wire2d_step": bound_3xtf32(
            M * W2.step_flops(n, 2, h, 3, 2),
            4 * (n * 8 + M * (n * 3 + 2 * nw_s + 2))),
        "wire2d_mlp": bound_3xtf32(
            M * W2.apply_flops(n, 2, h, 1, 2, dcoords=False),
            4 * (n * 2 + M * (2 * n + 2 * nw_p))),
        "mscale2_step": bound_3xtf32(
            M * MS.step_flops(n, len(inv), widths),
            4 * (n * 8 + M * (n * 3 + 2 * nw_m + 2))),
    }
    shapes = {"wire2d_step": f"WIRE-2D denoise, {n} rows, h {h}",
              "wire2d_mlp": f"WIRE-2D CT, {n} rows, h {h}, no dcoords",
              "mscale2_step": f"mscale_2 denoise, {n} rows, {len(inv)} "
                              f"scales, widths {widths}"}
    times = {}
    for name, (kernel, serial) in thunks.items():
        bound_ms, by = work[name]
        times[name] = dict(
            replicas=M, ms=cuda_ms(torch, kernel, MANY_TIMING_ITERS),
            serial_ms=cuda_ms(torch, serial, MANY_TIMING_ITERS),
            bound_ms=bound_ms, bound_by=by, shape=shapes[name])
    return errs, times


def near_serial(np, many, serials, what, rel, metric):
    """Replica r of a batched fit against its serial fit ``serials[r]``:
    the loss histories within ``rel`` relative and ``metric(fit, r)`` (a
    best PSNR in dB; r None for a serial fit) within PSNR_AGREE_DB.
    Returns the largest distances and whether every replica is bit-equal
    in its histories."""
    worst, worst_db, exact = 0.0, 0.0, True
    for r, one in enumerate(serials):
        for h, w in ((many.mse_noisy[:, r], one.mse_noisy),
                     (many.mse_gt[:, r], one.mse_gt)):
            exact = exact and np.array_equal(h, w)
            worst = max(worst, float(np.max(np.abs(h - w) / np.abs(w))))
        worst_db = max(worst_db, abs(metric(many, r) - metric(one, None)))
    if not (worst <= rel and worst_db <= PSNR_AGREE_DB):
        raise AssertionError(f"{what}: replicas {worst:.2e} (histories) and "
                             f"{worst_db:.4f} dB from their serial fits")
    return {"max_rel_history": worst, "max_db": worst_db,
            "bit_equal_histories": bool(exact)}


def launch_counts(torch, fn, sessions=3):
    """(device kernels, PyTorch operations) one call of ``fn`` launches,
    after a warm-up call: torch.profiler's device-side events (kernels,
    copies, memsets), the most that any of ``sessions`` sessions saw, and
    its host-side ``aten::`` operations.  The device trace is not complete
    in every session on the card (one session saw 0 of a step's 207
    kernels, another 52 of 83), so the operations, which the host records,
    decide check_launches_by_replicas and the device count is reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    kernels, ops = 0, set()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = max(kernels, sum(e.count for e in events
                                   if e.device_type == DeviceType.CUDA))
        ops.add(sum(e.count for e in events if e.key.startswith("aten::")))
    if len(ops) != 1:
        raise AssertionError(f"one call's PyTorch operations differ from "
                             f"session to session: {sorted(ops)}")
    return kernels, ops.pop()


def check_launches_by_replicas(counts, what):
    """``counts`` {M: (device kernels, PyTorch operations)} of one step at
    two replica counts: the operations are as many at each M (vmap batches
    each one; a loop of single calls per replica would multiply them).  The
    device kernels are reported, not held: cuBLAS picks its GEMM
    algorithms, some of them two kernels, by the batch count."""
    (m0, (_, ops0)), (m1, (_, ops1)) = sorted(counts.items())
    if not ops0 == ops1 > 0:
        raise AssertionError(f"{what}: PyTorch operations a step "
                             f"{ops0} at {m0} replicas, {ops1} at {m1}")


def fit_many_rest(torch, np, mods, counters, device):
    """The batched fits of WIRE-2D, mscale_2 and the autodiff families, each
    against its M serial fits (many_fit_run): WIRE-2D denoise at the
    headline width (300 features, 150 complex units a head, 65,536
    coordinates, full batch; one wire2d_step launch an epoch), WIRE-2D CT
    'auto' = fourier at the CT protocol (one wire2d_mlp pair and one
    line_sample pair an iteration; loss within MANY_FOURIER_REL, best PSNR
    within PSNR_AGREE_DB), mscale_2 denoise (MSCALE2_CONFIG; one
    mscale2_step an epoch): every replica bit-equal to its serial fit but
    CT's; realgabor and bspline_sig denoise (256 wide; no kernel),
    mscale_2 at combine_type 'both' (autodiff through one real_mlp pair an
    epoch) and bspline_knots SISR through apply_many (REAL_SISR_CONFIG's
    shape; no kernel): best PSNR within PSNR_AGREE_DB of their serial
    fits, histories within MANY_AUTODIFF_REL (their distance reported).
    Then ``sweep --seeds 2 --lr 5e-3`` of wire2d and realgabor denoise
    through ``main`` (the sweep's rate tables name the six paper families
    only); and each autodiff route's launches for one step (the loss's
    forward and backward, no metrics) at MANY_PROFILE_M replicas
    (check_launches_by_replicas)."""
    import dataclasses
    import tempfile
    (T, WS, TR, TCT, TD, TC, TS, TF, SW, M, get_inr, get_config, bench,
     tree) = mods
    out = {}

    def run(*args):
        many_fit_run(torch, np, WS, counters, out, *args)

    def exact(name):
        return lambda many, serials: many_vs_serial(np, many, serials, name)

    def psnr_of(im):
        shape = im.shape

        def metric(res, r):
            rec = res.best_rec if r is None else res.best_rec[r]
            return float(M.psnr_ref(im, rec.reshape(shape)))
        return metric

    def autodiff(name, metric):
        return lambda many, serials: near_serial(
            np, many, serials, name, MANY_AUTODIFF_REL, metric)

    def pointwise(name, model, m, cfg, im, noisy, want, compare_fn):
        ps = model_stack(torch, model, range(m), device)
        H, W, _ = im.shape
        grid = TD.C.grid2d(H, W)
        run(name, want,
            lambda: T.fit_pointwise_many(model, ps, grid,
                                         noisy.reshape(-1, 3), cfg,
                                         gt=im.reshape(-1, 3),
                                         device=device),
            [lambda r=r: T.fit_pointwise(
                model, tree.index(ps, r), grid, noisy.reshape(-1, 3),
                dataclasses.replace(cfg, seed=cfg.seed + r),
                gt=im.reshape(-1, 3), device=device) for r in range(m)],
            cfg.niters, m, compare_fn)

    # WIRE-2D denoise at the headline width, full batch
    im, noisy, _, _ = bench.setup(256, 256)
    H, W, _ = im.shape
    model = get_inr("wire2d", **WIRE2D_DENOISE_KW)
    pointwise("wire2d_denoise", model, MANY_W2D_M, T.FitConfig(
        learning_rate=5e-3, niters=MANY_W2D_EPOCHS, maxpoints=H * W,
        scale_lr_by_batch=True), im, noisy,
        {("wire2d", "step"): MANY_W2D_EPOCHS}, exact("wire2d_denoise"))

    # WIRE-2D CT 'auto' (fourier) at the CT protocol
    ct_cfg = get_config(CT_CONFIG)
    kw = dict(WIRE2D_DENOISE_KW, out_features=1)
    kw.update(wire2d_ct_kw(get_config))
    ct_model = get_inr("wire2d", **kw)
    img = TCT.ct_image(None, 0)
    Hc, Wc = img.shape
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    sino = TCT.make_sinogram(img, thetas, radon_method="auto", device=device)
    op = TR.RadonOp(thetas, method="auto")
    ps = model_stack(torch, ct_model, range(MANY_W2D_M), device)
    cfg = T.FitConfig(learning_rate=ct_cfg.learning_rate, niters=MANY_ITERS,
                      maxpoints=ct_cfg.maxpoints)
    ct_psnr = psnr_of(img)

    def fourier_check(many, serials):
        many_vs_serial(np, many, serials, "WIRE-2D CT auto", exact=False)
        psnrs = [ct_psnr(many, r) for r in range(MANY_W2D_M)]
        serial = [ct_psnr(s, None) for s in serials]
        if not max(abs(a - b) for a, b in zip(psnrs, serial)) \
                <= PSNR_AGREE_DB:
            raise AssertionError(f"fit_many_rest WIRE-2D CT auto: best "
                                 f"PSNRs {psnrs} vs serial {serial}")
        return {"psnr_db": psnrs, "serial_psnr_db": serial}

    run("wire2d_ct_auto",
        {("wire2d", "forward"): MANY_ITERS, ("wire2d", "backward"):
         MANY_ITERS, ("line_sample", "gather"): MANY_ITERS,
         ("line_sample", "scatter"): MANY_ITERS},
        lambda: T.fit_operator_many(ct_model, ps, TCT.C.grid2d(Hc, Wc), sino,
                                    op, cfg, gt_field=img,
                                    field_shape=(Hc, Wc), device=device),
        [lambda r=r: T.fit_operator(
            ct_model, tree.index(ps, r), TCT.C.grid2d(Hc, Wc), sino, op, cfg,
            gt_field=img, field_shape=(Hc, Wc), device=device)
         for r in range(MANY_W2D_M)], MANY_ITERS, MANY_W2D_M, fourier_check)

    # mscale_2 denoise (freq_combine: mscale2_step), and at 'both' (autodiff)
    ms_cfg = get_config(MSCALE2_CONFIG)
    im, noisy = TD.denoise_images(ms_cfg)
    ms_model = mscale2_models(get_inr, TC, ms_cfg)[0]
    pointwise("mscale2_denoise", ms_model, MANY_MSCALE2_M, T.FitConfig(
        learning_rate=ms_cfg.learning_rate, niters=MANY_MSCALE2_EPOCHS,
        maxpoints=ms_cfg.maxpoints, scale_lr_by_batch=True), im, noisy,
        {("mscale2_step", "step"): MANY_MSCALE2_EPOCHS},
        exact("mscale2_denoise"))
    both = get_inr(ms_cfg.nonlin, **dict(
        {f: getattr(ms_model.spec, f) for f in MSCALE_SPEC_FIELDS},
        combine_type="both"))
    ad_cfg = T.FitConfig(learning_rate=ms_cfg.learning_rate,
                         niters=MANY_AUTODIFF_EPOCHS,
                         maxpoints=ms_cfg.maxpoints, scale_lr_by_batch=True)
    pointwise("mscale2_both_denoise", both, MANY_AUTODIFF_M, ad_cfg, im,
              noisy, {("real_mlp", "forward"): MANY_AUTODIFF_EPOCHS,
                      ("real_mlp", "backward"): MANY_AUTODIFF_EPOCHS},
              autodiff("mscale2_both_denoise", psnr_of(im)))

    # realgabor and bspline_sig denoise, 256 wide (no kernel)
    autodiff_models = {"mscale2_both": both}
    for nonlin in ("realgabor", "bspline_sig"):
        model = get_inr(nonlin, in_features=2, out_features=3,
                        hidden_features=256, hidden_layers=2, scale=2.0)
        autodiff_models[nonlin] = model
        pointwise(f"{nonlin}_denoise", model, MANY_AUTODIFF_M,
                  dataclasses.replace(ad_cfg, learning_rate=5e-3), im, noisy,
                  {}, autodiff(f"{nonlin}_denoise", psnr_of(im)))

    # bspline_knots SISR through apply_many (its apply has no kernel)
    sisr_cfg = get_config(REAL_SISR_CONFIG)
    im_hr, im_lr = TS.sisr_images(None, 0, sisr_cfg.down_scale)
    Hs, Ws, _ = im_hr.shape
    form, _ = real_models(get_inr, TC, sisr_cfg, 8.0, Hs)
    knots = get_inr("bspline_knots", **{f: getattr(form.spec, f)
                                        for f in REAL_SPEC_FIELDS})
    ps = model_stack(torch, knots, range(MANY_AUTODIFF_M), device)
    grid = TS.C.grid2d(Hs, Ws)
    dop = TF.DownsampleOp(Hs // im_lr.shape[0])
    cfg = T.FitConfig(learning_rate=sisr_cfg.learning_rate,
                      niters=MANY_ITERS, maxpoints=sisr_cfg.maxpoints,
                      lr_decay=0.2)

    def mse_db(res, r):
        best = res.best_mse if r is None else res.best_mse[r]
        return float(-10 * np.log10(best))

    run("knots_sisr", {},
        lambda: T.fit_operator_many(knots, ps, grid, im_lr, dop, cfg,
                                    gt_field=im_hr, field_shape=im_hr.shape,
                                    device=device),
        [lambda r=r: T.fit_operator(
            knots, tree.index(ps, r), grid, im_lr, dop, cfg, gt_field=im_hr,
            field_shape=im_hr.shape, device=device)
         for r in range(MANY_AUTODIFF_M)], MANY_ITERS, MANY_AUTODIFF_M,
        autodiff("knots_sisr", mse_db))

    # sweep --seeds 2 of wire2d and realgabor denoise through main
    out["sweep_seeds"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for nonlin, want in (("wire2d", {("wire2d", "step"): SWEEP_ITERS}),
                             ("realgabor", {})):
            t0 = time.time()
            reset_counts(counters)
            ws0 = wire_step_launches()
            res = SW.main(["denoise", "--seeds", "2", "--nonlins", nonlin,
                           "--lr", "5e-3", "--niters", str(SWEEP_ITERS),
                           "--results_dir", os.path.join(tmp, nonlin)])
            launches = read_counts(counters)
            launches["wire_step"] = {"step": wire_step_launches() - ws0}
            check_real_launches(launches, f"sweep --seeds denoise {nonlin}",
                                want)
            if not (len(res["psnrs"]) == 2
                    and np.isfinite(res["psnrs"]).all()
                    and np.isfinite(res["recs"]).all()):
                raise AssertionError(f"sweep --seeds denoise {nonlin}: "
                                     f"results {res['psnrs']}")
            out["sweep_seeds"][f"denoise_{nonlin}"] = dict(
                metric=res["psnrs"], step_ms=res["step_ms"],
                launches={k: v for k, v in launches.items()
                          if any(v.values())},
                wall_s=time.time() - t0)

    # the autodiff routes' launches a step at two replica counts
    gtensor = torch.tensor(TD.C.grid2d(H, W), device=device)
    target = torch.tensor(noisy.reshape(-1, 3), device=device)
    counts = {}
    for name, model in autodiff_models.items():
        counts[name] = {}
        for m in MANY_PROFILE_M:
            ps = model_stack(torch, model, range(m), device)
            counts[name][m] = launch_counts(
                torch, lambda: model.step_grads_many(ps, gtensor, target))
    sgrid = torch.tensor(grid, device=device)
    counts["knots_apply"] = {}
    for m in MANY_PROFILE_M:
        ps = model_stack(torch, knots, range(m), device)
        leaves = [t.clone().requires_grad_(True)
                  for _, t in tree.leaves(ps)]
        paths = [p for p, _ in tree.leaves(ps)]

        def fwd_bwd():
            y = knots.apply_many(tree.unflatten(paths, leaves), sgrid)
            return torch.autograd.grad(y.square().sum(), leaves)
        counts["knots_apply"][m] = launch_counts(torch, fwd_bwd)
    for name, c in counts.items():
        check_launches_by_replicas(c, name)
    out["autodiff_launches"] = {
        name: {m: {"device_kernels": k, "operations": ops}
               for m, (k, ops) in c.items()} for name, c in counts.items()}
    return out


SHARDED_EPOCHS = 50
SHARDED_ITERS = 20
SHARDED_CHUNK_POINTS = 16384
SHARDED_OCC_EPOCHS = 10
SHARDED_PROFILE_EPOCHS = 10
# the histories of two ranks against one device: wire_tpu's own bound
# across processes (tests/test_multiprocess.py)
SHARDED_REL = 2e-4
SHARDED_FITS = ("denoise", "denoise_global_perm", "ct_auto", "multi_sr")
# the two ranks' epochs or iterations: the multi-SR fit amplifies a change
# of reduction order fast (a 1e-7 perturbation of its init moved its
# 20-iteration history by 2-3e-2 on the card), so it is held to
# SHARDED_REL over its first 4 iterations, where the history still tells a
# frame batch split wrongly (a rank rendering another's frames) from
# rounding
SHARDED_B_ITERS = {"denoise": 20, "denoise_global_perm": 20, "ct_auto": 20,
                   "multi_sr": 4}


def sharded_modules():
    """The port's modules the fit_sharded phase and its ranks use."""
    from wire_tpu_torch import bench
    from wire_tpu_torch.apps import ct as TCT, multi_sr as TMS
    from wire_tpu_torch.apps import occupancy as TO
    from wire_tpu_torch.dist import fitter as SF, make_mesh
    from wire_tpu_torch.dist import multihost as MH
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.operators import radon as TR
    from wire_tpu_torch.ops import (line_sample as LS, mfn as MF,
                                    mscale2_step as MS, real_mlp as RM,
                                    rotsum as R, wire2d as W2,
                                    wire_mlp as WM, wire_step as WS)
    from wire_tpu_torch.train import metrics as M, trainer as T
    from wire_tpu_torch.train.presets import get_config
    counters = Counts("wire_mlp", "rotsum", "line_sample", "real_mlp",
                      "mscale2_step", "mfn", "wire2d")
    return dict(bench=bench, TCT=TCT, TMS=TMS, TO=TO, SF=SF, MH=MH, T=T,
                make_mesh=make_mesh, get_inr=get_inr, TR=TR, WS=WS, M=M,
                get_config=get_config, counters=counters)


def seed0_init(torch, model, device):
    return model.init(torch.Generator().manual_seed(0), device)


def sharded_fit(torch, np, m, name, iters, device, mesh=None):
    """(FitResult, best PSNR) of one of SHARDED_FITS for ``iters``
    epochs or iterations from the seed-0 init: the unsharded fit, or with
    ``mesh`` its sharded counterpart.  denoise: the WIRE-300 bench protocol
    (65,536 coordinates, full batch); denoise_global_perm: the same in
    SHARDED_CHUNK_POINTS-row chunks (4 an epoch), exact mode; ct_auto: the
    CT protocol, 'auto' = fourier; multi_sr: the multi-SR app's defaults,
    one batch of 4 frames a step (the PSNR of the best parameters' render
    of the full grid)."""
    T, SF = m["T"], m["SF"]
    if name.startswith("denoise"):
        im, noisy, coords, model = m["bench"].setup(256, 256)
        params = seed0_init(torch, model, device)
        mp = 256 * 256 if name == "denoise" else SHARDED_CHUNK_POINTS
        cfg = T.FitConfig(learning_rate=5e-3, niters=iters, maxpoints=mp,
                          scale_lr_by_batch=True)
        args = (model, params, coords, noisy.reshape(-1, 3), cfg)
        if mesh is None:
            res = T.fit_pointwise(*args, gt=im.reshape(-1, 3), device=device)
        else:
            res = SF.fit_pointwise_sharded(
                *args, mesh, gt=im.reshape(-1, 3),
                global_perm=name == "denoise_global_perm")
        return res, float(m["M"].psnr_ref(im, res.best_rec.reshape(im.shape)))
    if name == "ct_auto":
        TCT = m["TCT"]
        cfg = m["get_config"](CT_CONFIG)
        model, _ = ct_models(m["get_inr"], TCT, cfg)
        img = TCT.ct_image(None, 0)
        H, W = img.shape
        thetas = np.linspace(0, 180, 100, dtype=np.float32)
        sino = TCT.make_sinogram(img, thetas, radon_method="auto",
                                 device=device)
        params = seed0_init(torch, model, device)
        res = T.fit_operator(
            model, params, TCT.C.grid2d(H, W), sino,
            m["TR"].RadonOp(thetas, method="auto"),
            T.FitConfig(learning_rate=cfg.learning_rate, niters=iters,
                        maxpoints=cfg.maxpoints),
            gt_field=img, field_shape=(H, W), device=device, mesh=mesh)
        return res, float(m["M"].psnr_ref(img, res.best_rec))
    if name == "multi_sr":
        prob = m["TMS"].setup(niters=iters)
        ds, model, im = prob["ds"], prob["model"], prob["im"]
        params = seed0_init(torch, model, device)
        args = (model, params, ds.coords, ds.pixels, ds.masks, prob["cfg"])
        kw = dict(hr_shape=im.shape, scale=4, batch_size=4)
        res = (T.fit_frames(*args, device=device, **kw) if mesh is None
               else SF.fit_frames_sharded(*args, mesh, **kw))
        grid = torch.from_numpy(m["TMS"].C.grid2d(*im.shape[:2])).to(device)
        with torch.no_grad():
            rend = model.apply(res.best_params, grid).reshape(
                im.shape).cpu().numpy()
        return res, float(m["M"].psnr_ref(im, rend))
    raise ValueError(name)


def sharded_launches(m, counters, ws0):
    out = read_counts(counters)
    out["wire_step"] = {"step": wire_step_launches() - ws0}
    return out


def sharded_want(name, iters):
    """Each rank's launches in sharded_fit's ``iters`` epochs or iterations
    of a fit of SHARDED_FITS: one wire_step a chunk, one wire_mlp pair (and
    on CT one line_sample pair) an iteration, and nothing else but the
    measurement's projection (CT: one line_sample gather) and the best
    parameters' render (multi-SR: one wire_mlp forward)."""
    if name == "denoise":
        return {("wire_step", "step"): iters}
    if name == "denoise_global_perm":
        return {("wire_step", "step"): iters * (256 * 256
                                                // SHARDED_CHUNK_POINTS)}
    if name == "ct_auto":
        return {("wire_mlp", "forward"): iters,
                ("wire_mlp", "backward"): iters,
                ("line_sample", "gather"): iters + 1,
                ("line_sample", "scatter"): iters}
    return {("wire_mlp", "forward"): iters + 1,
            ("wire_mlp", "backward"): iters}


def history_rel(np, got, want):
    """The largest relative distance of the loss and tracked histories."""
    return max(float(np.max(np.abs(np.asarray(g, np.float64) - w)
                            / np.abs(w)))
               for g, w in ((got.mse_gt, want.mse_gt),
                            (got.mse_noisy, want.mse_noisy)))


def same_result(torch, np, a, b):
    """Whether two FitResults are equal bit for bit: histories, best MSE,
    best and final reconstruction, parameters."""
    from wire_tpu_torch import tree
    for k in ("mse_gt", "mse_noisy", "best_rec", "final_rec"):
        x, y = getattr(a, k), getattr(b, k)
        if (x is None) != (y is None) or (
                x is not None and not np.array_equal(x, y)):
            return False
    return a.best_mse == b.best_mse and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(
            tree.leaves(a.params), tree.leaves(b.params)))


def collective_share(torch, run, steps, device):
    """torch.profiler over ``run()``, a fit of ``steps`` steps returning
    (FitResult, PSNR): the all-reduce entries' host ms a step
    (``c10d::allreduce_`` and the backend's ``nccl:all_reduce`` /
    ``gloo:all_reduce``), the step's wall ms (the fit loop's own host
    time), the largest entry's share of it, and NCCL's device kernels' ms
    a step against the device's busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        res = run()[0]
        if cuda:
            torch.cuda.synchronize()
    wall = res.wall_time_s * 1e3 / steps
    ka = prof.key_averages()
    host = {e.key: e.cpu_time_total / 1e3 / steps for e in ka
            if "allreduce" in e.key.lower().replace("_", "")}
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e3 / steps
    nccl = sum(e.device_time_total for e in dev
               if "nccl" in e.key.lower()) / 1e3 / steps
    top = max(host.values()) if host else None
    return dict(allreduce_host_ms=host, step_wall_ms=wall,
                allreduce_share=None if top is None else top / wall,
                nccl_device_ms=nccl if busy else "not measured",
                device_busy_ms=busy if busy else "not measured")


def allreduce_call_ms(torch, m, mesh, device, calls=20):
    """Host ms of one flat all-reduce of WIRE-300's gradient tree
    (``Mesh.sum_tree``) on ``mesh``, synchronised, over ``calls`` calls
    after two."""
    model = m["bench"].setup(8, 8)[3]
    grads = model.init(torch.Generator().manual_seed(0), device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    for _ in range(2):
        mesh.sum_tree(grads, mean=True)
    sync()
    t0 = time.time()
    for _ in range(calls):
        mesh.sum_tree(grads, mean=True)
    sync()
    return (time.time() - t0) * 1e3 / calls


def sharded_rank(rank, port, queue, device):
    """One of phase fit_sharded's two ranks, both on ``device``, over Gloo
    (multihost.initialize chooses it: two ranks share one card): every fit
    of SHARDED_FITS for SHARDED_B_ITERS epochs or iterations through the
    sharded fitters, each rank's launches counted, and a profiled
    SHARDED_PROFILE_EPOCHS-epoch denoise fit; puts (rank, results) or
    (rank, traceback) on ``queue``."""
    import traceback
    try:
        sys.path.insert(0, ROOT)
        import numpy as np
        import torch
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        m = sharded_modules()
        dev = device
        m["MH"].initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=rank, device=dev)
        mesh = m["make_mesh"](2, dev)
        counters = m["counters"]
        out = {"backend": mesh.backend, "fits": {}}
        for name in SHARDED_FITS:
            reset_counts(counters)
            ws0 = wire_step_launches()
            iters = SHARDED_B_ITERS[name]
            res, psnr = sharded_fit(torch, np, m, name, iters, dev, mesh)
            launches = sharded_launches(m, counters, ws0)
            check_real_launches(launches, f"fit_sharded rank {rank} {name}",
                                sharded_want(name, iters))
            out["fits"][name] = dict(
                mse_gt=res.mse_gt.tolist(), mse_noisy=res.mse_noisy.tolist(),
                best_mse=res.best_mse, psnr_db=psnr, ms_per_step=res.step_ms,
                launches={k: v for k, v in launches.items() if any(
                    v.values())})
        out["profile_denoise"] = collective_share(torch, lambda: sharded_fit(
            torch, np, m, "denoise", SHARDED_PROFILE_EPOCHS, dev, mesh),
            SHARDED_PROFILE_EPOCHS, dev)
        out["allreduce_call_ms"] = allreduce_call_ms(torch, m, mesh, dev)
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise


def two_ranks(device, timeout=300):
    """Run sharded_rank on two spawned processes, both on ``device``; their
    results by rank.  Raises if a rank fails, dies or takes more than
    ``timeout`` seconds; stops both in every case."""
    import multiprocessing
    import queue as Q
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=sharded_rank, args=(r, port, queue, device))
             for r in range(2)]
    deadline = time.time() + timeout
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < len(procs):
            try:
                rank, res = queue.get(timeout=5)
                got[rank] = res
                continue
            except Q.Empty:
                pass
            # a failing rank puts its traceback before it exits non-zero
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead and queue.empty():
                raise AssertionError(f"fit_sharded: rank(s) {dead} exited "
                                     f"without a result")
            if time.time() > deadline:
                raise AssertionError(f"fit_sharded: no result in {timeout} "
                                     f"s")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r in range(2):
        if isinstance(got[r], str):
            raise AssertionError(f"fit_sharded rank {r} failed:\n{got[r]}")
        if procs[r].exitcode != 0:
            raise AssertionError(f"fit_sharded rank {r} exited "
                                 f"{procs[r].exitcode}")
    return [got[0], got[1]]


def world_of_one_fits(torch, np, m, mesh, device):
    """fit_sharded's part (a) on ``mesh``, a world of one."""
    import tempfile
    counters = m["counters"]
    a = {"backend": mesh.backend}
    for name, iters in (("denoise", SHARDED_EPOCHS),
                        ("denoise_global_perm", SHARDED_EPOCHS),
                        ("ct_auto", SHARDED_ITERS),
                        ("multi_sr", SHARDED_ITERS)):
        one, psnr_one = sharded_fit(torch, np, m, name, iters, device)
        reset_counts(counters)
        ws0 = wire_step_launches()
        got, psnr = sharded_fit(torch, np, m, name, iters, device, mesh)
        launches = sharded_launches(m, counters, ws0)
        check_real_launches(launches, f"fit_sharded world of one {name}",
                            sharded_want(name, iters))
        bits = same_result(torch, np, got, one)
        rel = history_rel(np, got, one)
        if not bits and (name != "ct_auto" or rel > MANY_FOURIER_REL
                         or abs(psnr - psnr_one) > PSNR_AGREE_DB):
            raise AssertionError(
                f"fit_sharded world of one {name}: not the unsharded fit "
                f"(history rel {rel:.3g}, {psnr:.4f} vs {psnr_one:.4f} dB)")
        a[name] = dict(iters=iters, bit_equal=bits, history_rel=rel,
                       psnr_db=psnr, psnr_unsharded_db=psnr_one,
                       ms_per_step=got.step_ms,
                       unsharded_ms_per_step=one.step_ms,
                       launches={k: v for k, v in launches.items()
                                 if any(v.values())})
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(niters=SHARDED_OCC_EPOCHS)
        one = m["TO"].run(results_dir=os.path.join(tmp, "one"),
                          device=device, **kw)
        reset_counts(counters)
        ws0 = wire_step_launches()
        got = m["TO"].run(results_dir=os.path.join(tmp, "mesh"), mesh=mesh,
                          **kw)
        launches = sharded_launches(m, counters, ws0)
        check_real_launches(launches, "fit_sharded occupancy --mesh 1",
                            {("wire_step", "step"): 2 * SHARDED_OCC_EPOCHS})
        iou_equal = bool(np.array_equal(np.float32(got["iou_array"]),
                                        one["iou_array"]))
        if not (same_result(torch, np, got["result"], one["result"])
                and iou_equal and got["iou"] == one["iou"]
                and os.path.isfile(os.path.join(tmp, "mesh", "occupancy",
                                                "wire.dae"))):
            raise AssertionError("fit_sharded occupancy --mesh 1: not the "
                                 "unsharded app's fit, IoU or artifacts")
        a["occupancy"] = dict(
            epochs=SHARDED_OCC_EPOCHS, bit_equal=True, iou_equal=iou_equal,
            best_iou=got["iou"], psnr_db=got["psnr"],
            ms_per_epoch=got["result"].step_ms,
            unsharded_ms_per_epoch=one["result"].step_ms,
            launches=launches["wire_step"])
    a["profile_denoise_global_perm"] = collective_share(
        torch, lambda: sharded_fit(torch, np, m, "denoise_global_perm",
                                   SHARDED_PROFILE_EPOCHS, device, mesh),
        SHARDED_PROFILE_EPOCHS * 4, device)
    a["allreduce_call_ms"] = allreduce_call_ms(torch, m, mesh, device)
    return a


def fit_sharded(torch, np, device):
    """Phase fit_sharded: coordinate-parallel fits (wire_tpu_torch.dist).
    (a) A world of one over NCCL in this process: the WIRE-300 denoise fit
    (SHARDED_EPOCHS, full batch and exact mode in 4 chunks), CT 'auto' and
    the multi-SR app's fit (SHARDED_ITERS) against the unsharded fits from
    the same init, bit for bit (CT within MANY_FOURIER_REL: line_sample's
    scatter adds with atomics); the occupancy app at --mesh 1
    (SHARDED_OCC_EPOCHS, fed rows, IoU from summed counts) against the
    unsharded app; each through its kernels alone (counts reset just before
    and read just after), with ms per step beside the unsharded fit's, and
    the all-reduce's share of a step from torch.profiler.  (b) Two ranks on
    this one card over Gloo (two spawned processes): every fit of
    SHARDED_FITS for SHARDED_B_ITERS against the unsharded fit here,
    histories within SHARDED_REL relative and best PSNR within
    PSNR_AGREE_DB; the two ranks'
    histories equal, each rank's launches counted."""
    import torch.distributed as dist
    m = sharded_modules()
    made = m["MH"].world_of_one(device=device)
    try:
        mesh = m["make_mesh"](1, device)
        want = "nccl" if device.type == "cuda" else "gloo"
        if mesh.backend != want:
            raise AssertionError(f"fit_sharded: a world of one on {device} "
                                 f"took {mesh.backend}, expected {want}")
        a = world_of_one_fits(torch, np, m, mesh, device)
    finally:
        if made:
            dist.destroy_process_group()

    # (b): the single-device references here, then the two ranks
    b = {}
    refs = {name: sharded_fit(torch, np, m, name, SHARDED_B_ITERS[name],
                              device) for name in SHARDED_FITS}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    ranks = two_ranks(device)
    b["wall_s"] = time.time() - t0
    b["backend"] = ranks[0]["backend"]
    if b["backend"] != "gloo":
        raise AssertionError(f"fit_sharded: two ranks on one device took "
                             f"{b['backend']}, expected gloo")
    for name in SHARDED_FITS:
        r0, r1 = (r["fits"][name] for r in ranks)
        if r0["mse_gt"] != r1["mse_gt"] or r0["mse_noisy"] != r1[
                "mse_noisy"]:
            raise AssertionError(f"fit_sharded two ranks {name}: the ranks' "
                                 f"histories differ")
        one, psnr_one = refs[name]
        rel = history_rel(np, argparse.Namespace(**r0), one)
        if not (rel <= SHARDED_REL
                and abs(r0["psnr_db"] - psnr_one) <= PSNR_AGREE_DB
                and np.isfinite(r0["mse_gt"]).all()):
            raise AssertionError(
                f"fit_sharded two ranks {name}: history rel {rel:.3g} "
                f"(bound {SHARDED_REL:.3g}), {r0['psnr_db']:.4f} vs "
                f"{psnr_one:.4f} dB (bound {PSNR_AGREE_DB:.3g})")
        b[name] = dict(iters=SHARDED_B_ITERS[name], history_rel=rel,
                       bound_rel=SHARDED_REL, bound_db=PSNR_AGREE_DB,
                       psnr_db=r0["psnr_db"], psnr_unsharded_db=psnr_one,
                       ms_per_step=[r0["ms_per_step"], r1["ms_per_step"]],
                       unsharded_ms_per_step=one.step_ms,
                       launches=[r0["launches"], r1["launches"]])
    b["profile_denoise"] = [r["profile_denoise"] for r in ranks]
    b["allreduce_call_ms"] = [r["allreduce_call_ms"] for r in ranks]
    return {"a_world_of_one": a, "b_two_ranks": b}


def tv_check_fit(np, res, rows, what):
    if not (np.isfinite(res.best_rec).all() and np.isfinite(res.mse_gt).all()
            and res.best_rec.shape == (rows, 3)):
        raise AssertionError(f"{what}: non-finite values or a wrong shape")


def tv_agree(what, psnr, psnr_plain):
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(f"{what}: kernel fit {psnr:.3f} dB vs plain fit "
                             f"{psnr_plain:.3f} dB differ by more than "
                             f"{PSNR_AGREE_DB} dB")


def tv_counts(counters, WS):
    """The kernels' counts with wire_step's beside them."""
    out = read_counts(counters)
    out["wire_step"] = counters.since("wire_step")
    return out


def tv_reset(counters, WS):
    reset_counts(counters)


def fit_tv(torch, np, mods, counters, device, step_fit_ms):
    """Total-variation fits, each by autograd of the family's apply/VJP
    kernel pair (no step kernel takes the TV term):
    (a) the denoise app on TV_CONFIG (WIRE-300, 300 epochs, full batch of
    65,536 coordinates, lambda_tv TV_LAMBDA) with the procedural image
    written as a PNG by the port and read back through --image: one
    wire_mlp forward and backward an epoch and nothing else; best PSNR at
    or above wire_tpu's CPU fit less 0.2 dB and within PSNR_AGREE_DB of
    the plain fit (fused="never") from one init; Output_img.png read back
    by the port equal to the best reconstruction quantized to 8 bits;
    (b) B-spline denoise (REAL_DENOISE_CONFIG's shape) with TV for
    TV_REAL_ITERS epochs: one real_mlp forward and backward an epoch, no
    real_step; (c) WIRE-300 with TV in two chunks of TV_CHUNK_POINTS for
    TV_CHUNK_ITERS epochs: per chunk the chunk's forward, the full
    render's forward and their two backwards (four wire_mlp launches of
    each direction an epoch); (d) sinogram_op at the CT protocol's shape
    (256^2, 100 angles) bit-equal to radon, 'auto' (fourier: one
    line_sample gather) and 'rotate' (one rotsum forward).  Counts are
    reset just before each fit and read just after."""
    (TD, TC, TI, TF, TR, TCT, M, WS, get_inr, get_config, presets,
     FitConfig, fit_pointwise) = mods
    import tempfile
    out = {}
    presets.ENTRIES[TV_CONFIG] = dict(presets.ENTRIES[TV_BASE_CONFIG],
                                      niters=TV_ITERS, tvl=True,
                                      lambda_tv=TV_LAMBDA)
    cfg = get_config(TV_CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        png = write_tv_png(np, os.path.join(tmp, "tv.png"))
        # (a) the denoise app
        tv_reset(counters, WS)
        app = TD.run(TV_CONFIG, image=png, results_dir=os.path.join(
            tmp, "results"), device=device)
        launches = tv_counts(counters, WS)
        check_real_launches(launches, "TV denoise app", {
            ("wire_mlp", "forward"): TV_ITERS,
            ("wire_mlp", "backward"): TV_ITERS})
        res = app["result"]
        im, im_noisy = TD.denoise_images(cfg, png)
        H, W, _ = im.shape
        model = TC.build_model(cfg, in_features=2, out_features=3,
                               omega0=cfg.omega0, sidelength=H)
        plain = get_inr(cfg.nonlin, fused="never", **{
            f: getattr(model.spec, f) for f in REAL_SPEC_FIELDS})
        params = model.init(torch.Generator().manual_seed(0), device)
        fit_cfg = FitConfig(learning_rate=cfg.learning_rate,
                            niters=cfg.niters, maxpoints=cfg.maxpoints,
                            scale_lr_by_batch=True, seed=0)
        grid = TD.C.grid2d(H, W)
        tv = dict(tv_weight=cfg.lambda_tv, image_shape=(H, W, 3))
        res_plain = fit_pointwise(plain, params, grid,
                                  im_noisy.reshape(-1, 3), fit_cfg,
                                  gt=im.reshape(-1, 3), device=device, **tv)
        if tv_counts(counters, WS) != launches:
            raise AssertionError("TV denoise: the plain fit launched a "
                                 "kernel")
        for r in (res, res_plain):
            tv_check_fit(np, r, H * W, "TV denoise")
        psnr = app["psnr"]
        psnr_plain = M.psnr_ref(im, res_plain.best_rec.reshape(H, W, 3))
        tv_agree("TV denoise", psnr, psnr_plain)
        floor = WIRE_TPU_300_TV_DB - 0.2
        if not psnr >= floor:
            raise AssertionError(f"TV denoise: kernel fit best PSNR "
                                 f"{psnr:.3f} dB below the floor {floor} dB")
        rec = res.best_rec.reshape(H, W, 3)
        back = TI.imread(os.path.join(app["path"], "Output_img.png"),
                         normalize_full=False)
        want = (np.clip(np.abs(rec), 0, 1) * 255).astype(np.uint8) / \
            np.float32(255)
        if not np.array_equal(back, want):
            raise AssertionError("TV denoise: Output_img.png read back is "
                                 "not the best reconstruction in 8 bits")
        out["app"] = dict(
            config=TV_CONFIG, base=TV_BASE_CONFIG, lambda_tv=TV_LAMBDA,
            epochs=TV_ITERS, launches=launches, psnr_db=psnr,
            psnr_plain_db=psnr_plain, floor_db=floor,
            ms_per_step=res.step_ms, plain_ms_per_step=res_plain.step_ms,
            step_kernel_fit_ms_per_step=step_fit_ms,
            output_img=sorted(os.listdir(app["path"])))

        # (c) the same problem in two chunks
        chunk_cfg = FitConfig(learning_rate=cfg.learning_rate,
                              niters=TV_CHUNK_ITERS,
                              maxpoints=TV_CHUNK_POINTS,
                              scale_lr_by_batch=True, seed=0)
        nchunks = H * W // TV_CHUNK_POINTS
        tv_reset(counters, WS)
        res_c = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3),
                              chunk_cfg, gt=im.reshape(-1, 3),
                              device=device, **tv)
        launches_c = tv_counts(counters, WS)
        per = 2 * nchunks * TV_CHUNK_ITERS
        check_real_launches(launches_c, "TV chunked", {
            ("wire_mlp", "forward"): per, ("wire_mlp", "backward"): per})
        res_cp = fit_pointwise(plain, params, grid, im_noisy.reshape(-1, 3),
                               chunk_cfg, gt=im.reshape(-1, 3),
                               device=device, **tv)
        for r in (res_c, res_cp):
            tv_check_fit(np, r, H * W, "TV chunked")
        psnr_c, psnr_cp = (M.psnr_ref(im, r.best_rec.reshape(H, W, 3))
                           for r in (res_c, res_cp))
        tv_agree("TV chunked", psnr_c, psnr_cp)
        out["chunked"] = dict(
            epochs=TV_CHUNK_ITERS, chunks=nchunks, chunk_rows=TV_CHUNK_POINTS,
            launches=launches_c,
            launches_stated=("per chunk: the chunk's forward, the full "
                             "render's forward, and the backward of each"),
            psnr_db=psnr_c, psnr_plain_db=psnr_cp,
            history_rel=float(np.max(np.abs(res_c.mse_gt / res_cp.mse_gt
                                            - 1))),
            ms_per_epoch=res_c.step_ms, plain_ms_per_epoch=res_cp.step_ms)

    # (b) B-spline denoise with TV through the real_mlp pair
    cfg_b = get_config(REAL_DENOISE_CONFIG)
    im_b, noisy_b = TD.denoise_images(cfg_b)
    Hb, Wb, _ = im_b.shape
    model_b, plain_b = real_models(get_inr, TC, cfg_b, 7.0, Hb)
    params_b = model_b.init(torch.Generator().manual_seed(0), device)
    cfg_bfit = FitConfig(learning_rate=cfg_b.learning_rate,
                         niters=TV_REAL_ITERS, maxpoints=cfg_b.maxpoints,
                         scale_lr_by_batch=True)
    tv_b = dict(tv_weight=TV_LAMBDA, image_shape=(Hb, Wb, 3))
    tv_reset(counters, WS)
    res_b = fit_pointwise(model_b, params_b, TD.C.grid2d(Hb, Wb),
                          noisy_b.reshape(-1, 3), cfg_bfit,
                          gt=im_b.reshape(-1, 3), device=device, **tv_b)
    launches_b = tv_counts(counters, WS)
    check_real_launches(launches_b, "TV B-spline", {
        ("real_mlp", "forward"): TV_REAL_ITERS,
        ("real_mlp", "backward"): TV_REAL_ITERS})
    res_bp = fit_pointwise(plain_b, params_b, TD.C.grid2d(Hb, Wb),
                           noisy_b.reshape(-1, 3), cfg_bfit,
                           gt=im_b.reshape(-1, 3), device=device, **tv_b)
    for r in (res_b, res_bp):
        tv_check_fit(np, r, Hb * Wb, "TV B-spline")
    psnr_b, psnr_bp = (M.psnr_ref(im_b, r.best_rec.reshape(Hb, Wb, 3))
                       for r in (res_b, res_bp))
    tv_agree("TV B-spline", psnr_b, psnr_bp)
    out["bspline"] = dict(config=REAL_DENOISE_CONFIG, lambda_tv=TV_LAMBDA,
                          epochs=TV_REAL_ITERS, launches=launches_b,
                          psnr_db=psnr_b, psnr_plain_db=psnr_bp,
                          ms_per_step=res_b.step_ms,
                          plain_ms_per_step=res_bp.step_ms)

    # (d) sinogram_op at the CT protocol's shape
    img = torch.tensor(TCT.ct_image(None, 0), device=device)
    thetas = np.linspace(0, 180, 100, dtype=np.float32)
    sino = {}
    for method, (name, key) in (("auto", ("line_sample", "gather")),
                                ("rotate", ("rotsum", "forward"))):
        want = TR.radon(img, thetas, method=method)
        tv_reset(counters, WS)
        got = TF.sinogram_op(img, thetas, method=method)
        torch.cuda.synchronize()
        counts = tv_counts(counters, WS)
        check_real_launches(counts, f"sinogram_op {method}",
                            {(name, key): 1})
        if not torch.equal(got, want):
            raise AssertionError(f"sinogram_op {method} is not radon's")
        sino[method] = dict(shape=list(got.shape), launches=counts,
                            bit_equal_to_radon=True)
    out["sinogram_op"] = sino
    return out


def cuda_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    faulthandler.dump_traceback_later(1100, exit=True)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=300,
                    help="denoise fit epochs (floors at 300 and 2000)")
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from wire_tpu_torch.nn.registry import get_inr
    from wire_tpu_torch.ops import build
    from wire_tpu_torch.ops import wire_step as WS
    from wire_tpu_torch.train import metrics as M
    from wire_tpu_torch.train.trainer import FitConfig, fit_pointwise
    from wire_tpu_torch import bench
    import wire_tpu_torch.ops.line_sample as LS
    import wire_tpu_torch.ops.rotsum as R
    import wire_tpu_torch.ops.wire_mlp as WM
    import wire_tpu_torch.operators.radon as TR
    from wire_tpu_torch.apps import ct as TCT
    from wire_tpu_torch.train.presets import get_config
    from wire_tpu_torch.train.trainer import fit_operator
    import wire_tpu_torch.ops.real_mlp as RM
    import wire_tpu_torch.ops.mscale2_step as MS
    import wire_tpu_torch.nn.models as MM
    import wire_tpu_torch.operators.forward as TF
    from wire_tpu_torch.apps import common as TC
    from wire_tpu_torch.apps import denoise as TD
    from wire_tpu_torch.apps import sisr as TS
    from wire_tpu_torch.apps import sweep as SW
    import wire_tpu_torch.ops.mfn as MF
    import wire_tpu_torch.ops.wire2d as W2
    from wire_tpu_torch.apps import occupancy as TO
    from wire_tpu_torch.apps import multi_sr as TMS
    import wire_tpu_torch.train.trainer as T

    # ---- device ----------------------------------------------------------
    t0 = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs the port on an "
                         "NVIDIA GPU and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", t0, kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build -----------------------------------------------------------
    t0 = time.time()
    built = build.build_all(KERNEL_LIBRARIES)
    for name, (so, log) in built.items():
        print(f"== nvcc {name}\n{log}", file=sys.stderr)
    emit("build", t0, libraries=[os.path.relpath(so, ROOT)
                                 for so, _ in built.values()],
         nvcc=build.find_nvcc())

    # ---- kernel_vs_plain -------------------------------------------------
    t0 = time.time()
    kw = dict(in_features=2, out_features=3, hidden_features=300,
              hidden_layers=2, first_omega0=7.0, hidden_omega0=7.0,
              scale=8.0)
    model = get_inr("wire", **kw)
    spec = model.spec
    n_full = 256 * 256
    cases = {}
    for name, n, nvalid, denom in (("full", n_full, None, None),
                                   ("ragged", 700, 650, 650 * 3.0 + 1.0)):
        params, coords, target, gt = inputs(torch, model, n, 1, dev)
        got, again = (tensors_of(*WS.wire_step(
            params, coords, target, spec, nvalid=nvalid, denom=denom, gt=gt,
            want_metrics=True)) for _ in range(2))
        torch.cuda.synchronize()
        same_bits(torch, again, got, f"wire_step {name}")
        want = WS.wire_step_plain(params, coords, target, spec,
                                  nvalid=nvalid, denom=denom, gt=gt,
                                  want_metrics=True)
        torch.cuda.synchronize()
        cases[name] = compare(got, tensors_of(*want), f"wire_step {name}")
    cases.update(wire_step_widths(torch, WS, get_inr, dev))
    cfg_ct = get_config(CT_CONFIG)
    ct_model, _ = ct_models(get_inr, TCT, cfg_ct)
    errs = {"wire_step": cases}
    errs.update(ct_kernel_vs_plain(torch, WM, R, LS, ct_model, dev))
    cfg_a, cfg_b = get_config(REAL_DENOISE_CONFIG), get_config(
        REAL_SISR_CONFIG)
    model_a, _ = real_models(get_inr, TC, cfg_a, 7.0, 256)
    model_b, _ = real_models(get_inr, TC, cfg_b, 8.0, 168)
    errs.update(real_kernel_vs_plain(torch, RM, MM, model_a, model_b, dev))
    errs["real_step"].update(multiscale_fold_vs_plain(
        torch, RM, MM, get_inr, get_config, dev))
    ms_models = mscale2_models(get_inr, TC, get_config(MSCALE2_CONFIG))
    errs["mscale2_step"] = mscale2_kernel_vs_plain(torch, MS, MM, ms_models,
                                                   dev)
    errs["repaired"] = repaired_faults(torch, WM, R, ct_model, dev)
    errs["repaired"].update(strided_coords(torch, WM, RM, MF, W2, get_inr,
                                           ct_model, dev))
    errs["wire_mlp"].update(wire_mlp_widths(torch, WM, get_inr, dev))
    errs.update(mfn_kernel_vs_plain(torch, MF, get_inr, dev))
    for name, cases in sweep_kernel_vs_plain(torch, np, SW, WS, WM, RM, MM,
                                             MF, dev).items():
        errs[name].update(cases)
    errs.update(wire2d_kernel_vs_plain(torch, W2, get_inr, get_config, dev))
    occ_errs, occ_fp32 = occupancy_kernel_vs_plain(torch, WS, TO, dev)
    errs["wire_step"].update(occ_errs)
    for name, cases in slice_real_vs_plain(torch, RM, MM, TC, get_inr,
                                           get_config, dev).items():
        errs[name].update(cases)
    for name, cases in multisr_kernel_vs_plain(torch, np, TMS, WM, RM, MM, MF,
                                               dev).items():
        errs[name].update(cases)
    emit("kernel_vs_plain", t0, max_abs_err=errs, rel_tol=REL_TOL,
         occupancy_kernel_vs_fp32_plain=occ_fp32,
         why=("max abs err <= rel_tol x max|plain| per output tensor: fp32 "
              "sums over up to 262,144 rows (wire_*, real_*, mscale2_*, "
              "mfn_*, wire2d_*; the multi-SR pairs over 147,456), 256 rows "
              "(rotsum) taken in another order; line_sample's scatter adds "
              "with atomics in a varying order"),
         reference=("the plain version in fp32 on the same inputs; for "
                    "mscale2_step, the wire2d_mlp CT-frequency width case, "
                    "the real cases of REAL_FLOAT64_CASES the plain "
                    "version run in float64 (every input cast), max|plain| "
                    "its max; for OCC_STATE_CASES the float64 run on the "
                    "kernel's own pre-activations; the multi-SR cases as "
                    "MULTISR_FLOAT64_CASES and MULTISR_RELU_PATTERN_CASES "
                    "say"))

    # ---- measure (bench shape; these launches are not the main path) ------
    t0 = time.time()
    params, coords, target, gt = inputs(torch, model, n_full, 2, dev)
    h = params["first"]["w"].shape[1]
    L = spec.hidden_layers
    scratch = WS.StepScratch()
    ms = cuda_ms(torch, lambda: WS.wire_step(
        params, coords, target, spec, gt=gt, want_metrics=True,
        scratch=scratch), iters=20)
    plain_ms = cuda_ms(torch, lambda: WS.wire_step_plain(
        params, coords, target, spec, gt=gt, want_metrics=True), iters=20)
    w = WS.stack_params(params, L)
    lib_out = matmul_step(torch, w, coords, target, gt, spec)
    lib_err = compare(
        tensors_of(lib_out[0], WS.unstack_grads(*lib_out[1:4], params, L),
                   lib_out[4]),
        tensors_of(*WS.wire_step_plain(params, coords, target, spec, gt=gt,
                                       want_metrics=True)),
        "matmul step vs plain")
    library_ms = cuda_ms(torch, lambda: matmul_step(
        torch, w, coords, target, gt, spec), iters=20)
    kernel_ms = kernel_device_ms(torch, lambda: WS.wire_step(
        params, coords, target, spec, gt=gt, want_metrics=True,
        scratch=scratch), 20, kernel_names("wire_step"))
    flops = WS.step_flops(n_full, 2, h, 3, L)
    nweights = num_weights(params)
    nbytes = 4 * (n_full * (2 + 3 + 3)          # coords, target, gt
                  + nweights                    # weights in
                  + n_full * 3 + nweights + 2)  # pred, grads, sse out
    meas = {"wire_step": dict(
        ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        gflop=flops / 1e9, mbytes=nbytes / 1e6,
        library_vs_plain_max_abs_err=lib_err,
        achieved_tflops=flops / (kernel_ms * 1e9) if kernel_ms else None,
        **tensor_core_fields(torch, build, lambda: WS.wire_step(
            params, coords, target, spec, gt=gt, want_metrics=True,
            scratch=scratch), "wire_step", flops, nbytes, kernel_ms))}
    del scratch, lib_out
    meas.update(ct_measure(torch, WM, R, LS, ct_model, dev, build))
    meas.update(real_measure(torch, SW, RM, MM, model_a, model_b, dev,
                             build))
    meas["mscale2_step"] = mscale2_measure(torch, MS, RM, MM, ms_models[0],
                                           dev, build)
    meas.update(mfn_measure(torch, MF, get_inr, dev, build))
    meas.update(wire2d_measure(torch, W2, get_inr, get_config, dev, build))
    # each GEMM kernel's least time were its fp32 products formed as
    # 3xTF32 on the tensor cores, as wire_mlp's are
    for name, res in meas.items():
        if name not in ("rotsum", "line_sample"):
            res.setdefault("bound_3xtf32_ms", bound_3xtf32(
                res["gflop"] * 1e9, res["mbytes"] * 1e6)[0])
    emit("measure", t0, kernels=meas, nvidia_smi=smi,
         pairs=("ms, plain_ms and library_ms of wire_mlp, rotsum, "
                "line_sample, real_mlp, mfn_mlp and wire2d_mlp time the "
                "forward and its "
                "backward/adjoint together through autograd, as a call from "
                "the host; kernel_ms the device time of the kernels alone "
                "in those calls; fwd_ms the forward alone"))

    # ---- measure_slice (the occupancy slice's new shapes) -------------------
    t0 = time.time()
    emit("measure_slice", t0, kernels=slice_measure(
        torch, WS, RM, MM, TO, TC, get_inr, get_config, dev, build),
         nvidia_smi=smi)

    # ---- measure_multi_sr (row 2 at the multi-SR batch) -----------------
    t0 = time.time()
    meas_msr = measure_multi_sr(torch, np, TMS, WM, dev, build)
    emit("measure_multi_sr", t0, wire_mlp=meas_msr, nvidia_smi=smi)

    # ---- fit (the main path) ---------------------------------------------
    t0 = time.time()
    im, im_noisy, grid, model = bench.setup(256, 256)
    params = model.init(torch.Generator().manual_seed(0), dev)
    cfg = FitConfig(learning_rate=5e-3, niters=args.epochs,
                    maxpoints=n_full, scale_lr_by_batch=True)
    ws0 = wire_step_launches()
    res = fit_pointwise(model, params, grid, im_noisy.reshape(-1, 3), cfg,
                        gt=im.reshape(-1, 3), device=dev)
    launches = wire_step_launches() - ws0
    if launches != args.epochs:
        raise AssertionError(f"wire_step launched {launches} times in a "
                             f"{args.epochs}-epoch fit, expected one per "
                             f"epoch")
    plain_model = get_inr("wire", fused="never", **kw)
    res_plain = fit_pointwise(plain_model, params, grid,
                              im_noisy.reshape(-1, 3), cfg,
                              gt=im.reshape(-1, 3), device=dev)
    if wire_step_launches() - ws0 != launches:
        raise AssertionError("the plain fit launched the kernel")
    psnr = M.psnr_ref(im, res.best_rec.reshape(256, 256, 3))
    psnr_plain = M.psnr_ref(im, res_plain.best_rec.reshape(256, 256, 3))
    for r in (res, res_plain):
        if not (np.isfinite(r.best_rec).all() and np.isfinite(r.mse_gt).all()
                and r.best_rec.shape == (n_full, 3)):
            raise AssertionError("fit produced non-finite values or a wrong "
                                 "shape")
    if not abs(psnr - psnr_plain) <= PSNR_AGREE_DB:
        raise AssertionError(f"kernel fit {psnr:.3f} dB vs plain fit "
                             f"{psnr_plain:.3f} dB differ by more than "
                             f"{PSNR_AGREE_DB} dB")
    floor = PSNR_FLOORS_DB.get(args.epochs)
    if floor is not None and not psnr >= floor:
        raise AssertionError(f"kernel fit best PSNR {psnr:.3f} dB below the "
                             f"floor {floor} dB")
    emit("fit", t0, epochs=args.epochs, launches=launches,
         psnr_db=psnr, psnr_plain_db=psnr_plain, floor_db=floor,
         ms_per_step=res.step_ms, plain_ms_per_step=res_plain.step_ms,
         coords_per_s=n_full / (res.step_ms * 1e-3),
         fit_wall_s=res.wall_time_s, plain_fit_wall_s=res_plain.wall_time_s)

    # ---- fit_ct (the CT path) ---------------------------------------------
    t0 = time.time()
    ct = fit_ct(torch, np, (WM, R, LS, TR, TCT, M, get_inr, get_config,
                            FitConfig, fit_operator), dev)
    emit("fit_ct", t0, methods=ct)

    # ---- fit_real (B-spline denoise, path A) -------------------------------
    t0 = time.time()
    counters = Counts("wire_mlp", "rotsum", "line_sample", "real_mlp",
                      "mscale2_step", "mfn", "wire2d")
    ws_before = wire_step_launches()
    real = fit_real(torch, np, (TD, TC, M, RM, get_inr, get_config,
                                FitConfig, fit_pointwise), counters, dev)
    emit("fit_real", t0, **real)

    # ---- fit_sisr (B-spline SISR, path B) ----------------------------------
    t0 = time.time()
    sisr = fit_sisr(torch, np, (TS, TC, TF, M, get_inr, get_config,
                                FitConfig, fit_operator), counters, dev)
    emit("fit_sisr", t0, **sisr)

    # ---- fit_mscale2 (mscale_2 denoise) ------------------------------------
    t0 = time.time()
    mscale = fit_mscale2(torch, np, (TD, TC, M, get_inr, get_config,
                                     FitConfig, fit_pointwise), counters, dev)
    emit("fit_mscale2", t0, **mscale)

    # ---- fit_mfn (MFN denoise, the sweep's problem) -------------------------
    t0 = time.time()
    mfn = fit_mfn(torch, np, (SW, M, get_inr, FitConfig, fit_pointwise),
                  counters, dev)
    emit("fit_mfn", t0, **mfn)

    # ---- fit_mfn_sisr (MFN SISR, the sweep's problem) -----------------------
    t0 = time.time()
    mfn_sisr = fit_mfn_sisr(torch, np, (SW, TS, TF, M, get_inr, FitConfig,
                                        fit_operator), counters, dev)
    if wire_step_launches() != ws_before:
        raise AssertionError("the B-spline or MFN fits launched wire_step")
    emit("fit_mfn_sisr", t0, **mfn_sisr)

    # ---- fit_wire2d (WIRE-2D denoise through fit_pointwise) ----------------
    t0 = time.time()
    w2d = fit_wire2d(torch, np, (WS, M, get_inr, FitConfig, fit_pointwise,
                                 bench), counters, dev)
    emit("fit_wire2d", t0, **w2d)

    # ---- fit_wire2d_ct (WIRE-2D CT through fit_operator) -------------------
    t0 = time.time()
    w2d_ct = fit_wire2d_ct(torch, np, (WS, TR, TCT, M, get_inr, get_config,
                                       FitConfig, fit_operator), counters,
                           dev)
    emit("fit_wire2d_ct", t0, **w2d_ct)

    # ---- sweep (the six-family sweep app, every task) -----------------------
    t0 = time.time()
    sweep = sweep_phase(torch, np, SW, WS, counters, dev)
    emit("sweep", t0, iters=SWEEP_ITERS, tasks=sweep)

    # ---- fit_occupancy (the occupancy app: wire_step at d = 3, chunks) -----
    t0 = time.time()
    occ, occ_app = fit_occupancy(torch, np, (TO, WS, fit_pointwise),
                                 counters, dev)
    emit("fit_occupancy", t0, **occ)

    # ---- volume_motion (the volume probe on the card, the motion slice) ---
    t0 = time.time()
    from wire_tpu_torch.signals import motion as TMo, volume as TV
    vm = volume_motion(torch, np, (TO, TMS, TV, TMo, WS), counters, occ_app,
                       dev)
    emit("volume_motion", t0, **vm)

    # ---- fit_families (the registry's new families) -------------------------
    t0 = time.time()
    fam = fit_families(torch, np, (TD, TC, M, WS, get_inr, get_config,
                                   FitConfig, fit_pointwise), counters, dev)
    emit("fit_families", t0, iters=FAMILIES_ITERS, preset=FAMILIES_PRESET,
         families=fam)

    # ---- fit_multi_sr (the multi-SR app: wire_mlp on warped frame grids) ---
    t0 = time.time()
    msr = fit_multi_sr(torch, np, (TMS, WS, T.fit_frames), counters, dev)
    emit("fit_multi_sr", t0, **msr)

    # ---- fit_resume (checkpoint/resume of the three trainers, the chunked
    # render) ---------------------------------------------------------------
    t0 = time.time()
    resume = fit_resume(torch, np, (T, TMS, TO, TCT, TR, get_config, WS),
                        counters, dev)
    emit("fit_resume", t0, **resume)

    # ---- many_kernel_vs_plain (the replica axis of rows 1-11) ---------------
    t0 = time.time()
    many_errs, many_times = many_kernel_vs_plain(
        torch, np, (WS, WM, R, LS, TR, TCT, TMS, get_inr, get_config), dev)
    for more in (many_real_vs_plain(
            torch, np, (RM, MF, MM, SW, TC, TMS, get_inr, get_config), dev),
                 many_rest_vs_plain(torch, np, (W2, MS, MM, TC, get_inr,
                                                get_config), dev)):
        many_errs.update(more[0])
        many_times.update(more[1])
    emit("many_kernel_vs_plain", t0, replicas=MANY_M, max_abs_err=many_errs,
         rel_tol=REL_TOL, times=many_times, nvidia_smi=smi,
         why=("each replica bit-equal to the unbatched kernel on its inputs "
              "(line_sample's scatter, atomics, within rel_tol of it); "
              "each within rel_tol x max|reference| of its reference: the "
              "plain version in fp32, for real_step many_posenc the "
              "float64 run on the kernel's relu pattern (fault C.9), for "
              "wire2d_mlp many_ct_width_float64 the plain version run in "
              "float64, for mscale2_step the float64 run on the kernel's "
              "own combiner relu pattern (fault C.11)"))

    # ---- fit_many (the batched fits against their serial fits) -------------
    t0 = time.time()
    from wire_tpu_torch import tree as TT
    many = fit_many(torch, np, (T, WS, TR, TCT, TMS, TS, SW, TF, M, get_inr,
                                get_config, bench, TT), counters, dev)
    emit("fit_many", t0, fits=many, nvidia_smi=smi)

    # ---- fit_many_real (the real families' and the MFN's batched fits) ----
    t0 = time.time()
    many_real = fit_many_real(torch, np, (T, WS, TCT, TMS, TS, TD, TC, SW,
                                          TF, get_inr, get_config, TT),
                              counters, dev)
    emit("fit_many_real", t0, fits=many_real, nvidia_smi=smi)

    # ---- fit_many_rest (WIRE-2D's, mscale_2's and the autodiff families'
    # batched fits) ----------------------------------------------------------
    t0 = time.time()
    many_rest = fit_many_rest(torch, np, (T, WS, TR, TCT, TD, TC, TS, TF, SW,
                                          M, get_inr, get_config, bench, TT),
                              counters, dev)
    emit("fit_many_rest", t0, fits=many_rest, nvidia_smi=smi)

    # ---- fit_sharded (coordinate-parallel fits over a process group) -----
    t0 = time.time()
    sharded = fit_sharded(torch, np, dev)
    emit("fit_sharded", t0, **sharded, nvidia_smi=smi)
    world_one = sharded["a_world_of_one"]

    # ---- fit_tv (total-variation fits through the apply/VJP pairs, the
    # denoise app on a PNG, sinogram_op) ------------------------------------
    t0 = time.time()
    from wire_tpu_torch.signals import image as TI
    from wire_tpu_torch.train import presets as TP
    tvf = fit_tv(torch, np, (TD, TC, TI, TF, TR, TCT, M, WS, get_inr,
                             get_config, TP, FitConfig, fit_pointwise),
                 counters, dev, res.step_ms)
    emit("fit_tv", t0, **tvf, nvidia_smi=smi)

    def many_counts(lib, key):
        """{fit_key: launches} of ``lib``'s ``key`` in fit_many_real's and
        fit_many_rest's batched fits and seeds runs, where nonzero."""
        fits = {}
        for res in (many_real, many_rest):
            fits.update({f"many_{k}": v for k, v in res.items()
                         if k not in ("sweep_seeds", "autodiff_launches")})
            fits.update({f"seeds_{k}": v
                         for k, v in res["sweep_seeds"].items()})
        return {f"{k}_{key}": v["launches"][lib][key]
                for k, v in fits.items()
                if v["launches"].get(lib, {}).get(key)}

    # launches of each kernel in the paths that run it: wire_step in the
    # WIRE denoise fit and the occupancy fits, real_step also in the
    # families' fits, wire_mlp in both CT fits, line_sample in 'auto'
    # (fourier), rotsum in 'rotate', real_step in the B-spline denoise fit,
    # real_mlp in the B-spline SISR fit, mscale2_step in the mscale_2
    # denoise fit, mfn_step in the MFN denoise fit, mfn_mlp in the MFN SISR
    # fit, wire2d_step in the WIRE-2D denoise fit, wire2d_mlp in the
    # WIRE-2D CT fit; wire_mlp and real_mlp also in fit_tv's TV fits,
    # line_sample and rotsum in its sinogram_op calls; a pair counts both
    # directions
    path_launches = {
        "wire_step": {"step": launches,
                      "occupancy_step": occ["launches"]["step"],
                      "many_denoise_step": many["denoise"]["launches"][
                          "wire_step"]["step"],
                      "many_denoise_chunked_step": many["denoise_chunked"][
                          "launches"]["wire_step"]["step"],
                      "seeds_denoise_step": many["sweep_seeds"]["denoise"][
                          "launches"]["wire_step"]["step"],
                      **{f"occupancy_{k}_step": v["launches"]
                         for k, v in occ[f"epochs_{OCC_BLOCK_EPOCHS}"]
                         .items()},
                      **{f"sharded_{fit}_step": world_one[fit]["launches"][
                          "wire_step"]["step"] for fit in (
                              "denoise", "denoise_global_perm")},
                      "sharded_occupancy_step": world_one["occupancy"][
                          "launches"]["step"]},
        "wire_mlp": {**{k: ct["auto"]["launches"]["wire_mlp"][k]
                        + ct["rotate"]["launches"]["wire_mlp"][k]
                        for k in ops_launches("wire_mlp")},
                     **{f"multi_sr_{k}": msr["launches"][k]
                        + msr["estim_launches"][k]
                        for k in ops_launches("wire_mlp")},
                     **{f"render_chunked_{k}": v for k, v in resume[
                         "render_chunked"]["chunked"]["launches"][
                             "wire_mlp"].items()},
                     **{f"many_{fit}_{k}": v
                        for fit in ("ct_rotate", "ct_auto", "sisr",
                                    "multi_sr", "multi_sr_bursts")
                        for k, v in many[fit]["launches"][
                            "wire_mlp"].items()},
                     **{f"seeds_{task}_{k}": v for task in ("sisr", "ct")
                        for k, v in many["sweep_seeds"][task]["launches"][
                            "wire_mlp"].items()},
                     **{f"sharded_{fit}_{k}": v
                        for fit in ("ct_auto", "multi_sr")
                        for k, v in world_one[fit]["launches"][
                            "wire_mlp"].items()},
                     **{f"tv_{fit}_{k}": v for fit in ("app", "chunked")
                        for k, v in tvf[fit]["launches"][
                            "wire_mlp"].items()},
                     "volume_motion_forward": vm["launches"]["forward"]},
        "line_sample": {**ct["auto"]["launches"]["line_sample"],
                        **{f"many_ct_auto_{k}": v for k, v in many[
                            "ct_auto"]["launches"]["line_sample"].items()},
                        **{f"many_wire2d_ct_auto_{k}": v for k, v in
                           many_rest["wire2d_ct_auto"]["launches"][
                               "line_sample"].items()},
                        **{f"seeds_ct_{k}": v for k, v in many[
                            "sweep_seeds"]["ct"]["launches"][
                                "line_sample"].items()},
                        **{f"sharded_ct_auto_{k}": v for k, v in world_one[
                            "ct_auto"]["launches"]["line_sample"].items()},
                        **{f"sinogram_op_{k}": v for k, v in tvf[
                            "sinogram_op"]["auto"]["launches"][
                                "line_sample"].items()}},
        "rotsum": {**ct["rotate"]["launches"]["rotsum"],
                   **{f"many_ct_rotate_{k}": v for k, v in many[
                       "ct_rotate"]["launches"]["rotsum"].items()},
                   **{f"render_chunked_{k}": v for k, v in resume[
                       "render_chunked"]["chunked"]["launches"][
                           "rotsum"].items()},
                   **{f"sinogram_op_{k}": v for k, v in tvf["sinogram_op"][
                       "rotate"]["launches"]["rotsum"].items()}},
        "real_step": {"step": real["launches"]["step"],
                      **{f"{k}_step": fam[k]["launches"]
                         for k in STEP_FAMILIES},
                      **many_counts("real_mlp", "step")},
        "real_mlp": {**{k: sisr["launches"][k]
                        for k in ("forward", "backward")},
                     **{f"multi_sr_{k}": sum(
                         msr["others"][nl]["launches"][k]
                         for nl in MULTISR_NONLINS
                         if MULTISR_PAIR[nl] == "real_mlp")
                        for k in ("forward", "backward")},
                     **many_counts("real_mlp", "forward"),
                     **many_counts("real_mlp", "backward"),
                     **{f"tv_bspline_{k}": tvf["bspline"]["launches"][
                         "real_mlp"][k] for k in ("forward", "backward")}},
        "mscale2_step": {"step": mscale["launches"]["step"],
                         **many_counts("mscale2_step", "step")},
        "mfn_step": {"step": mfn["launches"]["step"],
                     **many_counts("mfn", "step")},
        "mfn_mlp": {**{k: mfn_sisr["launches"][k]
                       for k in ("forward", "backward")},
                    **{f"multi_sr_{k}": msr["others"]["mfn"]["launches"][k]
                       for k in ("forward", "backward")},
                    **many_counts("mfn", "forward"),
                    **many_counts("mfn", "backward")},
        "wire2d_step": {"step": w2d["launches"]["step"],
                        **many_counts("wire2d", "step")},
        "wire2d_mlp": {**{k: w2d_ct["launches"][k]
                          for k in ("forward", "backward")},
                       **many_counts("wire2d", "forward"),
                       **many_counts("wire2d", "backward")}}
    print(smi)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"wire_tpu_torch/csrc/{lib}.cu",
        "replaces": replaces,
        "launches": sum(path_launches[name].values()),
        "launches_by_direction": path_launches[name],
        "max_abs_err": errs[name]["full"], "ms": meas[name]["ms"],
        "kernel_ms": meas[name]["kernel_ms"],
        "plain_ms": meas[name]["plain_ms"],
        "bound_ms": meas[name]["bound_ms"],
        "bound_by": meas[name]["bound_by"],
        "library_ms": meas[name]["library_ms"],
        **({"sass_hmma": meas[name]["sass_hmma"],
            "bound_fp32_ms": meas[name]["bound_fp32_ms"]}
           if "sass_hmma" in meas[name] else {}),
        **({"multi_sr": {k: meas_msr[k] for k in (
            "ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_fp32_ms", "at_512")}} if name == "wire_mlp" else {}),
        **({"replica_axis": dict(many_times[name],
                                 max_abs_err=many_errs[name])}
           if name in many_times else {})}
        for name, (lib, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
