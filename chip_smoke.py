#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, its data layer, its
training CLI, its off-path trainers, its mesh path (parallel/), the
reference's .dat checkpoints, its profiling utilities, its examples, its
reduced-precision modes and the pure-teacher comparison once on an NVIDIA
GPU and check them.

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py [--other-csrc DIR]

With --other-csrc, K3, K7, K2, K1, K8, K4a, K4b (both forms) and K5 built from
another csrc directory (e.g. the parent commit's, from `git archive HEAD
tensornetworkforml_torch/csrc`) are timed beside this build's in turns, and
their rows of the kernels line give the other build's time as parent_ms; K7 is
also held bit for bit against the other build's K7 at its four shapes, K8
against the other build's K8 at its three, and the 3xTF32 K4a and K4b at M=512
and K5 at the flagship and M=512 shapes against the other build's.

The model is the flagship: 10-class pooled MNIST, N=196, M=128, D=2, L=10,
linear/MSE, random weights from a seed, synthetic pooled images; the large
phase trains the same model at M=512. Phases:
  1. device  -- the card, as nvidia-smi reports its name and power limit;
  2. build   -- compile every CUDA kernel from csrc/ (one nvcc per source,
                all started together) and print ptxas's report for each;
                the libraries of K4a, K4b and K5 (libpolar_sketch) and of K8
                (libpolar_iterate) must hold tf32 warpgroup products (HGMMA)
                in their SASS: each one-pass GEMM kernel of libpolar_sketch
                one a k step of its chunk a 64-row block, each 3xTF32 one
                three;
  3. kernel  -- each kernel against its plain PyTorch version on the card:
                K3 (chain) at the serving shapes (the form that ran named at
                each: latency or throughput), K3's stack form (the sweep's
                prologue) on the flagship's sites and at M=256 at B=256, each
                slot against its own max, K2 (pre-split step) and K1
                (polar iteration) on the inputs of a mid-chain step of the
                flagship training batch, and each at a ragged shape;
  4. serve   -- the model saved to .npz and served by
                Predictor.from_checkpoint on cuda (K3) at its default batch
                of 256 and as bulk scoring at batch 8192, held against the
                plain Predictor;
  5. train   -- train_model with svd_method="polar" on 4 batches of 256 (two
                right and two left sweeps): K1 must launch 4 x 195 times; the
                first sweep is held against the same sweep with the plain
                versions swapped in;
  6. hybrid  -- fused_epoch with engine="hybrid" on 2 batches: K2 and K1 must
                each launch 2 x 195 times; the first sweep is held against
                the xla-engine polar sweep; at M=256, above the JAX package's
                M*D <= 256 cap, K2 (I = 512) and K1 (I = 512, q = 256)
                against their plain versions on a mid-chain step's inputs,
                then one hybrid sweep (195 launches each) and the xla polar
                sweep, each held against a float64 run of the same sweep,
                and the same sweep through the plain versions with K2 and K1
                held at each of its steps; the float32 sweeps' gaps to each
                other and to the float64 run are printed beside their
                rounding floor;
  7. fused   -- K7 (the whole two-site step) against its plain version on the
                captured step's inputs, with the growth cap and renorm_envs,
                at a ragged shape and at M=256 (K1 at I = 512 inside it);
                fused_epoch with engine="fused" on 2 batches, each sweep's
                195 steps issued from C in one call of the sweep entry: K7
                must launch 2 x 195 times and K1 and K2 not at all; the
                sweep entry's outputs equal, bit for bit, 195 per-step K7
                calls on the same inputs; the first sweep is held against
                the same sweep with K7's plain version and against the
                xla-engine polar sweep;
  8. two-stage -- polar_split_two_stage (K5, then K1) on the flagship step's
                two-site matrix, held against hybrid_polar_split (and, in
                phase 14, once on the M=512 step's two-site matrix);
  9. all-in-one split -- polar_split (K8) against its plain version on the
                flagship step's two-site matrix, at a J that needs padding
                with n_power=2 and on the M=256 step's (I=512, J=5120,
                q=256), bit for bit against polar_split_two_stage at the two
                step shapes (J needs no pad there); one call on each step's
                matrix (1 launch each), held against polar_split_two_stage
                and hybrid_polar_split;
 10. rangefinder -- the flagship with svd_method="rangefinder" (bench.py's
                high_m_rangefinder): K6 against its plain version on the
                captured step's two-site matrix, a ragged shape, I=512 (the
                rangefinder step at M=256) and an edge step;
                train_model on 2 batches from prepare_dataset (K6 2 x 195
                launches); one sweep held by quality against the same
                sweep with the plain version, whose 195 splits are each
                also run through K6 and held against it, with the exact-SVD
                and polar sweeps printed beside it;
                product_init(canonicalize=True) and canonicalize on the card;
                one call of each small-I split (gram, cholsvd, rangefinder,
                svd) against a float64 exact split;
  11. data    -- the native host library (native/data_core.cpp, built with g++
                into the package's _build/ beside the kernels, no NumPy
                fallback) against its NumPy versions: psi_embed, max_pool_2x2,
                gather_rows, and shuffled_indices against a Python copy of its
                Fisher-Yates; MNIST and CIFAR-10 verify_checksums on files the
                phase writes (missing, ok, shape-ok and mismatch);
  12. teacher -- teacher_task at its defaults on the card and on the CPU: seed
                0 refused alike on both (a class short of the exact balance),
                seed 3 built on both, with equal candidate pools, argmax labels
                and rows agreeing on >= 99.5% and exact class balance; then the
                flagship student (M=128, polar, canonical, lr 0.02) trained for
                one epoch of 16 batches of 256 on the card's task: K1 16 x 195
                launches, test accuracy above 0.2 (twice chance);
  13. cli     -- cli/training_mnist.py --synthetic --pool --M 128 --svd_method
                polar --n_epochs 1 --batch_size 128 --restarts 0 on its default
                device: K1 batches x 195 launches, K2 none, the model finite
                and on the card, the saved file reloaded by Network.load giving
                the same scores bit for bit on fresh requests; then
                training_diagonals and test_diagonals on the card, test_diagonals'
                (acc, mae) equal to the trained Network's in memory;
  14. large   -- M=512 (bench.py's stretch_m512_polar): K4a, K4b and K5
                against their plain versions on the two-site matrix of a
                mid-chain step and at a ragged shape (K5's G exactly
                symmetric); polar_split_two_stage once on that matrix (K5's
                M=512 row of the kernels line); train_model on 2
                batches through the factored route (no kernel launches); one
                sweep with factored_update="off", whose gram-free split runs
                K4a and K4b (3xTF32 on the tensor cores) 195 times each, held
                against the same sweep with the plain versions and, by
                quality, against the factored one;
 15. timing  -- each kernel vs its plain version with CUDA events (plain,
                kernel, kernel, plain; K4a, K4b and K5 also vs one cuBLAS
                yardstick call; K5 at the flagship and at M=512; K1 and K2
                at the flagship and on the M=256 step's inputs, K2 also by
                launch from a profile; K8 at both step shapes, also by
                launch from a profile), ms per sweep
                on the three engines, on the rangefinder split (its profile
                splitting K6 into its four launches), on both M=512 routes and on the hybrid and
                xla engines at M=256, the device time of a profiled sweep of
                each (and the host time of the M=512 ones; K4a + K4b's device
                time in the gram-free one), Predictor samples/s with one
                batch at B=256 and one at B=8192 profiled (K3's device time,
                the rest, the idle share), and for
                context torch.linalg.qr on K6's panel, the hybrid step (K2,
                K1 and two products) beside K7 and polar_split_two_stage
                beside K8 at both shapes;
 16. brickwall -- cli/training_mnist.py --synthetic --pool --M 128 --trainer
                brickwall --svd_method cholqr --n_epochs 1 on its default device
                (N=196, M=128, B=128, K=98 pairs a layer): no kernel launches,
                every brick layer finite, the saved model scored by
                Predictor.from_checkpoint bit for bit as the model in memory and
                loaded by load_any_checkpoint as a BoundaryMPS; one flagship
                brick sweep held against its float64 run (BRICK_F64_TOL), its
                time and device profile;
 17. onesite -- the same CLI with --trainer onesite and the same checks; a
                flagship one-site sweep's time and profile; one sweep at N=784
                (--full), M=16 with renorm held against its float64 run;
 18. autodiff -- AutodiffTrainer (Adam, softmax_xent, lr 1e-3) on the flagship
                MPS, its first step held against a float64 run of it; one
                BoundaryAutodiffTrainer step on the brick-wall model and one
                ring_trainer step at the flagship's width;
 19. ensemble -- ensemble_init (N=196, L=10, m=8) trained by Adam on the
                teacher task; its to_direct_sum (M=80) served by Predictor
                through K3, held against ensemble_forward, K3 against its plain
                version and timed at M=80; probe_init's argmax on the same task
                against the probe's.
 20. mesh    -- parallel/ in a world of one on the card (one card; NCCL takes
                no two ranks on one device): cli/training_mnist.py --dp on its
                default device (the CLI's own world of one, K1 195 launches a
                batch); then make_mesh() (NCCL over a HashStore) and, at the
                flagship's recipe (polar, lr 0.05, weight decay 1e-5), two
                ShardedTrainer sweeps (K1 2 x 195) held against sweep_once to
                1e-6 of max, bit for bit or not, with one NCCL all-reduce of
                the gradient and three metric sums a step (profiled); one
                dist_split="polar" sweep (K5 and K1 195 launches each: K5's
                first sweep) held at 2e-2 x max|f| against its float64 run,
                its step-98 split bit for bit against polar_split_two_stage;
                K5 on the two column halves of that matrix summed against K5
                on the whole; fused_epoch(mesh=...) against the unsharded
                epoch; Predictor(mesh=...) through K3 against the
                single-device Predictor bit for bit.
 21. reference -- the flagship that phase 4 served, written as a reference
                .dat pickle (save_reference_pickle) and served by
                Predictor.from_checkpoint on the default device at batch 256
                and 8192: through K3, as many launches as phase 4, the same
                scores bit for bit; a .dat of the flagship after one sweep
                (label at N-1) served on the plain path (no K3 launch, the
                JAX package's rule) against the model in memory;
                Network.load of the .dat against Network.load of the .npz;
                cli/test_diagonals.py on a .dat of phase 13's diagonals model
                against its .npz run;
 22. profiling -- utils/profiling.py, run right after phase 4, before any
                other phase profiles: device_trace of one flagship batch,
                whose trace must hold K3's kernel; the same batch by a Timer
                scope with sync and by CUDA events inside it (the scope must
                not read less); profile_model at its defaults and at the
                flagship (batch 256), Timer.report() printed; at the end of
                the script the traced batch again, its device events printed;
 23. examples -- the six port examples (examples/torch/) in this process with
                TNML_SMOKE=1 on the card (05 on 2048 + 512 images): each
                prints an accuracy and keeps its model on cuda; 02 serves
                through K3.
 24. precision -- the reduced-precision modes ("tensorfloat32": TF32 for
                cuBLAS's float32 products): K4a and K4b's one-pass TF32 form
                (gramfree_sketch_tf32, gramfree_gmul_tf32) on the M=512 step's
                inputs and a ragged shape against the plain product of their
                TF32-rounded operands and float64, gramfree_split(precision=
                "tensorfloat32") at M=512 (one launch each, Q held by its
                isometry), both timed in turns with the 3xTF32 form, cuBLAS
                in TF32 and the plain version (their own rows of the kernels
                line); flagship sweeps under "tensorfloat32" on the xla,
                hybrid and fused engines against the IEEE sweeps (the same
                K1, K2 and K7 launches, other bits, the gap to the float64
                sweep beside the IEEE one's, fresh accuracy within 0.02,
                ms in turns, the switch off after each); an M=512 factored
                sweep under it (its iteration in IEEE) by quality; a brick
                and a one-site sweep under it against their float64 runs.
 25. teacher_pm0 -- scripts/torch_teacher_pm0.py at N=64, M=16, 2048
                samples, 12 epochs, seed 0 on the card: the models on cuda,
                the accuracies finite, the brick wall above the two-site
                sweep on test accuracy.

Launch counts are set to 0 just before each path (serve at each batch size, train, hybrid,
fused, the M=256 hybrid sweep, two-stage, all-in-one split, the rangefinder
train_model, the teacher task's student, the training CLI, the M=512 training,
the M=512 gram-free sweep, the boundary-label CLIs and sweeps and the autodiff
steps, which must launch no kernel, the ensemble's training and its direct
sum's serving, the --dp CLI, the data-parallel and dist-polar sweeps, the mesh
epoch and mesh serving, the .dat serving at each batch size, the swept .dat's
and each example, the reduced-precision split, each reduced sweep and the
teacher script) and read just after it; the comparisons with plain versions happen outside those windows.
K4a's, K4b's and K5's bound is 3xTF32's (three tensor-core products per
float32 one at the TF32 rate), and K8's that of its K5 stage plus K1's float32
iteration; their rows of the kernels line also give the float32 bound and the
share of the 3xTF32 bound the kernel reaches. The one-pass rows' bound is one
tensor-core product per float32 one at the TF32 rate.
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero before printing either, and any failed check exits
non-zero too.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

from tensornetworkforml_torch.cli import test_diagonals as cli_diag_test
from tensornetworkforml_torch.cli import training_diagonals as cli_diag_train
from tensornetworkforml_torch.cli import training_mnist as cli_mnist
from tensornetworkforml_torch.cli.common import evaluate_loader
from tensornetworkforml_torch.data import cifar, native
from tensornetworkforml_torch.data import mnist as mnist_mod
from tensornetworkforml_torch.data import teacher as teacher_mod
from tensornetworkforml_torch.data.diagonals import create_dataset
from tensornetworkforml_torch.data.loader import ArrayLoader, NumpyDataset, prepare_dataset
from tensornetworkforml_torch.data.mnist import max_pool_2x2, synthetic_mnist
from tensornetworkforml_torch.models import ensemble as ensemble_mod
from tensornetworkforml_torch.models.boundary import BoundaryMPS, boundary_forward
from tensornetworkforml_torch.models.canonical import canonicalize
from tensornetworkforml_torch.models.mps import mps_forward, product_init
from tensornetworkforml_torch.models.probe_init import fit_linear_probe, probe_init, probe_scores
from tensornetworkforml_torch.models.ring import ring_product_init, ring_trainer
from tensornetworkforml_torch.models.network import Network
from tensornetworkforml_torch.models.serving import Predictor
from tensornetworkforml_torch.ops import svd as svd_mod
from tensornetworkforml_torch.ops.embedding import psi_embed
from tensornetworkforml_torch.ops.kernels import (
    _build,
    env_scan,
    polar_split,
    presplit_kernel,
    split_kernel,
    step_kernel,
)
from tensornetworkforml_torch.train import brickwall as brick_mod
from tensornetworkforml_torch.train import epoch as epoch_mod
from tensornetworkforml_torch.train import onesite as onesite_mod
from tensornetworkforml_torch.train import sweep as sweep_mod
from tensornetworkforml_torch.train import trainer as trainer_mod
from tensornetworkforml_torch.train.sweep import SweepConfig, one_hot_labels, sweep_once
from tensornetworkforml_torch.train.autodiff import (
    AutodiffConfig,
    AutodiffTrainer,
    BoundaryAutodiffTrainer,
)
from tensornetworkforml_torch.train.trainer import evaluate_accuracy, train_model
from tensornetworkforml_torch.utils import checkpoint as ckpt_mod
from tensornetworkforml_torch.utils.checkpoint import load_any_checkpoint, save_checkpoint
from tensornetworkforml_torch.utils.precision import matmul_precision
from tensornetworkforml_torch.utils.profiling import Timer, device_trace, profile_model

N, M, D, L = 196, 128, 2, 10  # the flagship: cli/training_mnist.py --M 128
STEPS = N - 1  # two-site steps per sweep
BATCH = 256  # Predictor's default batch and the training batch
BIG = 8192
SEED = 0
REQUEST_SIZES = (1, 255, 256, 257, 1000)
LR, WD = 0.05, 1e-5  # bench.py's flagship sweep rate; the training CLI's decay
TRAIN_BATCHES, HYBRID_BATCHES, FUSED_BATCHES = 4, 2, 2
CAPTURE_STEP = N // 2  # a mid-chain step: bonds fully live
# K3 vs plain: max|kernel - plain| <= TOL * max|plain|. Both run in f32
# but sum the 2M = 256 terms of a site in different orders, and the rounding
# compounds over 195 dependent sites: about eps * sqrt(2M * n) = 2.7e-6
# relative is expected; 1e-4 leaves a margin and is the tolerance the JAX
# package holds its Pallas kernel to.
TOL = 1e-4
# K2 vs plain, each output relative to its max: sums of at most a few
# thousand f32 products in another order (measured ~2e-7 at these shapes).
K2_TOL = 1e-5
# K1 vs plain: ~60 dependent f32 products in another order. The projector
# and Q itself move by ~1e-5 on a half-decade spectrum and ~1e-4 on a
# two-decade one (CPU measurement, tests/test_torch_polar_iterate.py); a
# mid-chain two-site spectrum can be wider, so 1e-3. Q R reproduces B's
# dominant part, which rounding barely moves: 1e-4 of max|B|. Live columns
# are orthonormal to the final schedule's 1e-7 target plus f32 rounding: 1e-4.
K1_PROJ_TOL, K1_REC_TOL, K1_ISO_TOL = 1e-3, 1e-4, 1e-4
# One full 195-step sweep, kernel route vs plain route (and hybrid vs xla
# engine), on f_final and on the swept model's scores for fresh requests,
# relative to max|f|: per-step f32 differences of ~1e-6 are amplified along
# the 195-step sweep to an expected ~1e-3; 2e-2 leaves a margin.
SWEEP_TOL = 2e-2
# K4a, K4b and K5 vs plain, each output relative to its max: float32 sums of
# up to 10^4 terms (J = 10240 at M=512) in another order, against the
# float32 plain version and a float64 run of it.
RED_TOL = 1e-4
# The large-bond phase: bench.py's stretch_m512_polar (N=196, M=512, L=10,
# B=256, polar), 2 batches of train_model.
M_LARGE, LARGE_BATCHES = 512, 2
# One M=512 sweep through the gram-free split vs through the factored
# update, by quality. The two routes run different Newton-Schulz schedules
# (the factored one's is shorter at q >= 512), and the factored update
# carries f across a step's truncation instead of recomputing it, so its
# f_final drifts from its own model's output (the JAX package's does the
# same). So the gram-free f_final is held against the factored model's
# output on the same batch, and the two models' scores on fresh requests
# against each other: within 0.25 of max|f|, several times the gap that
# smaller bonds showed on the CPU, which grew with M; and their accuracies
# on fresh requests within 0.05 (13 of 256).
QUALITY_F_TOL, QUALITY_ACC_TOL = 0.25, 0.05
# The rangefinder phase: bench.py's high_m_rangefinder, the flagship with
# svd_method="rangefinder", which runs K6 on every step (I = M*D = 256).
RF_BATCHES = 2
# K6 vs plain: K1's limits (K1_*), for the same reasons: seven Householder
# orthonormalisations and six products with G sum in another order. The raw
# Q is not held: past B's rank its columns come from rounding (or are unit
# vectors e_j where the iterate is exactly dead), so only the projector of
# the live block (the columns whose row of R is above LIVE_TOL of the largest
# in the plain version), Q R and the isometry of Q are. The iteration runs on
# G = bs bs^T, which squares the spectrum: float32 rounding of ~1e-7 of
# sigma_max^2 moves a direction at 1e-2 of sigma_max by ~1e-3, K1_PROJ_TOL,
# and a weaker one by more (the sweep's last step, where B has rank 20,
# holds such directions), so a live column carries at least 1e-2 of the
# largest row's weight.
LIVE_TOL = 1e-2
# The rangefinder sweep amplifies rounding: near the right chain end B's
# rank falls far below M, the kept columns past it are directions formed
# from rounding, and the next steps' gradients put weight along them. So two
# float32 runs of the sweep part by far more than SWEEP_TOL (the script
# prints the kernel sweep against itself on the model rescaled by
# 1 + RF_PERTURB), and the kernel is held step by step instead: each of the
# plain-version sweep's 195 splits is also run through K6 on the same input.
# The two sweeps are held by quality (QUALITY_ACC_TOL), and the K6 sweep must
# train: from product_init about 0.18 of the fresh requests are right, and
# one sweep lifts that above 0.8 (the hybrid epoch's second batch, PR 2), so
# RF_MIN_ACC is a floor far from both. The exact-SVD and polar sweeps are
# printed beside it, not held: they are other algorithms (the polar split
# zeroes dead columns; the rangefinder and the exact SVD keep them), and the
# rangefinder sweep's rounding alone moves its accuracy by a few hundredths.
RF_PERTURB = 3e-7
RF_MIN_ACC = 0.5
# The canonical gauge on the card: isometries (A A^T a projector), the
# calibrated max|f| and the function kept by canonicalize, each to 1e-4
# (float32 QRs and a 196-site forward; ~1e-6 expected).
CANON_TOL = 1e-4
# gram, cholsvd, rangefinder (I < 128) and svd on a (64, 640) float32 matrix
# whose kept spectrum spans a decade and drops 20x at the cut, Q R against a
# float64 exact split, relative to max|B|: ~2e-6 on the CPU; cuSOLVER's
# float32 eigh and SVD round differently, so 1e-4.
SMALL_SPLIT_TOL = 1e-4
DEVICE = "cuda"
# peak rates of one H100 SXM at 700 W: float32 outside the tensor cores, TF32
# on the tensor cores (dense), HBM3
F32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12
# K4a, K4b and K5 (and K8's first stage) run in 3xTF32: three tensor-core
# products for each float32 one
TC_PASSES = 3
# The hybrid engine above the JAX package's M*D <= 256 cap: one sweep at
# M=256 (I = 512, where K1 runs its cluster form), and the xla polar sweep on
# the same batch, each held at SWEEP_TOL against a float64 run of the same
# sweep (the xla engine on a float64 copy of the model and the batch, every
# product and the split in float64, the split at the float32 path's
# dead_tol).
M_WIDE = 256
# This sweep amplifies float32 rounding far more than the flagship's: up to
# step 9 and at its last step B's rank is below M, the kept columns past it
# come from rounding, and the next steps' gradients put weight along them;
# at some mid-chain steps K1's fixed schedule leaves the weakest directions
# unconverged. Two float32 runs of it part by 1.5e-2 to 4.6e-2 of max|f|
# (each sweep against itself on the model with its label core rescaled by
# 1 + RF_PERTURB, and the kernel engines against each other and against the
# plain versions; measured on an H100), so SWEEP_TOL cannot hold between two
# float32 runs: those gaps are printed. The float64 run is the reference: the
# same rescale moves it by ~2e-4 of max|f|. The float32 sweeps scatter around
# it by about SWEEP_TOL (the plain-version sweeps and the sweep with K1's
# plain version run in float64 are printed against it), so this hold catches
# a fault that moves a sweep further than float32 rounding does, not a
# smaller one. The kernels are also held step by step, on each of the
# plain-version sweep's 195 steps: K2 to K2_TOL, and K1 by
# |Q Q^T B - Q64 Q64^T B| / max|B| against a float64 run of the plain
# version (Q64) on the same inputs, whose mean over the sweep must stay
# within WIDE_K1_RATIO of the plain float32 version's. Both are float32 runs
# of one algorithm, so a kernel that computes it as well as the plain
# version sits near 1. K1's own limits hold at the captured step, not along
# the sweep: there the plain version itself exceeds K1_REC_TOL against
# float64 at a few steps.
WIDE_K1_RATIO = 2.0
# polar_split_two_stage once at M=512 (K5 in 3xTF32, then K1's streaming
# form at I = 1024, q = 512), held against hybrid_polar_split (cuBLAS's
# float32 y and G, then K1) by the projector and the isometry at K1's limits.
# Q R is held against a float64 run of the same split's plain version (the
# same Omega; Q64): |Q Q^T B - Q64 Q64^T B| / max|B| of the two-stage split
# within TWO_STAGE_RATIO of the hybrid split's. 3xTF32 carries about ten
# times float32's error into G (K5's G reads 3.6e-5 of its max against
# float64 here, the float32 plain version ~4e-6), and at this bond the two
# splits' Q R then part by ~1e-4 of max|B| (1.02e-4, measured on an H100),
# so K1_REC_TOL between them cannot tell a fault from rounding; against
# float64 each split's distance is its own error, and a K5 as good as float32
# sits near 1.
TWO_STAGE_RATIO = 2.0
# The teacher phase: teacher_task at its defaults (4096 + 1024 samples, N=196,
# L=10) on the card and on the CPU. The labels are an argmax of float32
# scores cut at two data-dependent thresholds (the margin quantile and each
# class's widest-margin cut), so a rounding difference between the two
# devices' forward passes can move a sample across a cut: at least
# TEACHER_AGREE of the candidates' labels and of the task's rows must agree.
# At its defaults the task raises on most seeds in both packages (one class
# falls short of the exact balance after the margin cut: the JAX package's
# draw builds at seeds 0 and 3 of 0-9, the port's at 3, 4, 7 and 8; CPU
# runs), so the phase holds that seed 0 fails alike on both devices and
# builds seed 3, the first seed at which both packages' tasks build. The
# flagship student then trains on the card's task for one epoch of
# TEACHER_BATCHES batches of 256 at the training CLI's M=128 recipe (lr
# 0.02, renorm_envs, growth cap 0.002), and must score above
# TEACHER_MIN_ACC, twice chance, on the task's test set.
TEACHER_SEED, TEACHER_TRAIN, TEACHER_TEST = 3, 4096, 1024
TEACHER_BATCHES = TEACHER_TRAIN // BATCH
TEACHER_AGREE, TEACHER_LR, TEACHER_MIN_ACC = 0.995, 0.02, 0.2
# The CLI phase: cli/training_mnist.py at the flagship, its batch of 128.
CLI_BATCH = 128
# training_diagonals there: 1000 samples give one train batch of 800 and one
# validation batch of 128 (at 500 the 100 validation samples fill none)
DIAG_SAMPLES = 1000
# The boundary-label phases. [brickwall] and [onesite] run
# cli/training_mnist.py --synthetic --pool --M 128 --trainer T --n_epochs 1 at
# its batch of 128 on its default device: N=196, M=128, L=10; each brick layer
# splits K = 98 (even) or 97 (odd) two-site matrices of (256, 256) to rank 128
# by batched CholQR at the CLI's lr min(0.02, 0.5 / N).
BRICK_LR = min(0.02, 0.5 / N)
# One flagship brick sweep on the card against a float64 run of the same sweep
# (same batch, same Omega), on fresh requests' scores relative to max|f|. The
# float64 run takes the float32 path's Cholesky ridge (ops/svd.py::_cholqr_eps:
# 1.2e-4 at q = 128 in float32, 1e-12 in float64): the ridge shrinks each split
# by about that much, which compounds over a sweep's 195 pair splits to ~1e-2
# of max|f| (1.2e-2 against a float64 run with its own ridge, CPU), so that run
# is another algorithm and is printed, not held. With the float32 ridge the
# float64 run sits 9.7e-6 from the float32 one and two float32 runs (one with w
# rescaled by 1 + RF_PERTURB) 4.7e-6 apart, while the sweep moves the function
# by ~1.06 of max|f| (CPU, the flagship shapes). 1e-3 leaves a hundredfold
# margin and still catches a fault in a pair's update (lr K ~ 0.25 of f).
BRICK_F64_TOL = 1e-3
# One one-site sweep (renorm=True, lr 0.05: the CLI's long-chain rate) at
# N=784 (--full) and M=16, B=128, against its float64 run: 1.8e-6 of max|f|
# apart on the CPU, as two float32 runs are (w rescaled by 1 + RF_PERTURB),
# while the sweep moves max|f| ~70-fold. 1e-3.
ONESITE_LONG_N, ONESITE_LONG_M, ONESITE_LONG_LR, ONESITE_F64_TOL = 784, 16, 0.05, 1e-3
# [autodiff]: AutodiffTrainer (softmax_xent, Adam, lr 1e-3) for AD_STEPS steps of
# BATCH on the flagship MPS; the first step held against a float64 run of it:
# the loss to AD_LOSS_TOL relative (9.3e-8 on the CPU), the gradients to
# AD_GRAD_TOL of their max (2.2e-6), the updated tensors to AD_PARAM_TOL of their
# max (1.9e-4: Adam's first step divides each gradient by its own size, so the
# float32 rounding of the gradients near zero moves their updates by up to a
# tenth of lr; the step moves the sites by ~1.1e-3 of their max).
AD_STEPS, AD_LR = 3, 1e-3
AD_LOSS_TOL, AD_GRAD_TOL, AD_PARAM_TOL = 1e-5, 1e-4, 1e-3
# [ensemble]: ensemble_init at N=196, L=10, m=8 (scripts/teacher_ensemble.py's
# per-class bond) on [teacher]'s task, ENS_STEPS Adam steps of ENS_BATCH (softmax
# cross-entropy, as that script) on the card with the head's bias held at 0, so
# that to_direct_sum is exact; its direct sum (M = 80) is served by Predictor at
# BATCH through K3 and held against ensemble_forward at TOL. The script's rate,
# 3e-3 at N=64, diverges at N=196 (loss 2.3 -> 1.9e7 within 9 steps, CPU); 3e-4
# trains (2.30 -> 1.31 in 16 steps, test accuracy 0.76, CPU).
ENS_M, ENS_BATCH, ENS_STEPS, ENS_LR = 8, 1024, 16, 3e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def pooled(n: int, seed: int):
    """``n`` synthetic MNIST images /255, 2x2 max-pooled: ``(n, 196)`` and labels."""
    imgs, labels, _, _ = synthetic_mnist(n_train=n, n_test=0, seed=seed)
    x = max_pool_2x2(imgs / 255.0).reshape(n, -1).astype(np.float32)
    return x, labels.astype(np.int64)


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, TF32 off")
    return kind


KERNELS = {  # source name -> the function that builds and binds it
    "env_scan": env_scan._lib,
    "polar_iterate": polar_split._lib,
    "presplit": presplit_kernel._lib,
    "polar_sketch": polar_split._sketch_lib,
    "rangefinder_split": split_kernel._lib,
    "two_site_step": step_kernel._lib,
}


# --other-csrc: the sources built from another csrc directory, and the
# module function that loads the library each one stands in for
OTHER_SOURCES = {"env_scan": (env_scan, "_lib"), "two_site_step": (step_kernel, "_lib"),
                 "presplit": (presplit_kernel, "_lib"), "polar_iterate": (polar_split, "_lib"),
                 "polar_sketch": (polar_split, "_sketch_lib")}
OTHER = {}  # source name -> the other build's library
# the scratch of the one-pass K4a and K4b in a build from before they had
# scratch functions of their own: the 3xTF32 form's
LEGACY_SCRATCH = {"tnml_gramfree_sketch_tf32": "tnml_gramfree_sketch_scratch_floats",
                  "tnml_gramfree_gmul_tf32": "tnml_gmul_scratch_floats"}


def build_other(name: str, tmp: str) -> str:
    """``name``.cu from the other csrc directory (copied to ``tmp``)."""
    so = os.path.join(tmp, f"lib{name}_other.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                           os.path.join(tmp, "csrc", f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc failed on {name}.cu from {OTHER_CSRC}: {proc.stderr[-2000:]}")
    return so


def bind_other(name: str, so: str):
    """The other build of ``name`` loaded and bound like this build's library:
    every C entry this build's wrapper binds that the other one has."""
    module, attr = OTHER_SOURCES[name]
    lib, ref = ctypes.CDLL(so), getattr(module, attr)()
    for sym in [k for k in vars(ref) if k.startswith("tnml_")]:
        if hasattr(lib, sym):
            getattr(lib, sym).argtypes = getattr(ref, sym).argtypes
            getattr(lib, sym).restype = getattr(ref, sym).restype
    return lib


class using_other:
    """Within the block, the wrapper of ``name``'s module launches the other
    build's library (polar_sketch's scratch sized by that library's own
    functions)."""

    def __init__(self, name: str):
        (self.module, self.attr), self.lib = OTHER_SOURCES[name], OTHER[name]
        self.own = getattr(self.module, self.attr)
        self.scratch = {}
        if name == "polar_sketch":
            self.scratch = {e: f if hasattr(self.lib, f) else LEGACY_SCRATCH[e]
                            for e, f in polar_split._SCRATCH.items()}

    def __enter__(self):
        setattr(self.module, self.attr, lambda: self.lib)
        self.saved = dict(polar_split._SCRATCH)
        polar_split._SCRATCH.update(self.scratch)
        polar_split._scratch_floats.cache_clear()

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.own)
        polar_split._SCRATCH.update(self.saved)
        polar_split._scratch_floats.cache_clear()


def phase_build() -> None:
    import shutil

    def build(name):
        t0 = time.perf_counter()
        KERNELS[name]()
        return name, time.perf_counter() - t0

    def build_native():
        t0 = time.perf_counter()
        native.get_lib()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS) + len(OTHER_SOURCES) + 1) as pool:
        others = []
        if OTHER_CSRC:
            tmp = tempfile.mkdtemp()
            shutil.copytree(OTHER_CSRC, os.path.join(tmp, "csrc"))
            others = [pool.submit(build_other, name, tmp) for name in OTHER_SOURCES]
        host = pool.submit(build_native)  # the host data library, with g++
        done = list(pool.map(build, KERNELS))
        OTHER.update((name, bind_other(name, job.result()))
                     for name, job in zip(OTHER_SOURCES, others))
    print(f"[build] {len(done)} sources in {time.perf_counter() - t0:.2f} s, in parallel"
          + (f", with {', '.join(OTHER)} from {OTHER_CSRC}" if OTHER else "")
          + f"; the native data library (g++) {host.result():.2f} s")
    for name, seconds in done:
        log = open(f"{_build.library_path(name)}.log").read()
        report = [ln.split("ptxas info    : ")[-1].strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"[build] {name}.cu {seconds:.2f} s: " + " | ".join(report))
    tensor_core_check()


def tensor_core_check() -> None:
    """K4a, K4b and K5 (libpolar_sketch) and K8's first stage (libpolar_iterate)
    must run on the tensor cores: each library's SASS holds the tf32
    warpgroup products (HGMMA ... TF32)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name, kernels in (("polar_sketch", "K4a/K4b/K5"), ("polar_iterate", "K8's first stage")):
        so = str(_build.library_path(name))
        sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=120)
        if sass.returncode != 0:
            fail(f"cuobjdump -sass on {os.path.basename(so)} exited {sass.returncode}")
        mma = [ln.split(";")[0].split("*/")[-1].strip() for ln in sass.stdout.splitlines()
               if "HGMMA" in ln and "TF32" in ln]
        if not mma:
            fail(f"{kernels} not on the tensor cores: no HGMMA TF32 instruction in lib{name}")
        print(f"[build] {kernels}: lib{name} SASS holds {len(mma)} tf32 tensor-core "
              f"instructions (3xTF32 wgmma), e.g. {mma[0]}")
        if name == "polar_sketch":
            one_pass_check(sass.stdout)


# HGMMA TF32 instructions a GEMM kernel of libpolar_sketch holds: a one-pass
# kernel one product a k step of 8 of its chunk of 32 for each of its MW
# 64-row blocks (no lo terms; MW is its first template argument, 2 for K4a's
# 256 x 128 tiles, 1 for K4b's 128 x 256), a 3xTF32 one three (lo.hi, hi.lo,
# hi.hi) a k step of its chunk of 16, as before the one-pass form had a
# kernel of its own
ONE_PASS_HGMMA, TC_HGMMA = 4, 6


def one_pass_check(sass: str) -> None:
    """K4a's and K4b's one-pass TF32 form: each one-pass GEMM kernel of
    libpolar_sketch (tf1_gemm_kernel<MW, ...>: K4a and K4b's two halves)
    holds HGMMA ... TF32, MW x ONE_PASS_HGMMA of them; each 3xTF32
    instantiation (tc_gemm_kernel) keeps its TC_HGMMA."""
    count, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[-1].strip()
            count[fn] = 0
        elif fn and "HGMMA" in ln and "TF32" in ln:
            count[fn] += 1
    one = {f: n for f, n in count.items() if "tf1_gemm_kernel" in f}
    three = {f: n for f, n in count.items() if "tc_gemm_kernel" in f}
    want = {f: ONE_PASS_HGMMA * int(f.split("tf1_gemm_kernelILi")[1][0]) for f in one}
    if (len(one) != 3 or one != want or len(three) != 3
            or any(n != TC_HGMMA for n in three.values())):
        fail(f"K4a/K4b's one-pass TF32 form: HGMMA TF32 counts {one} (want {want}), the 3xTF32 "
             f"form's {three} (want {TC_HGMMA} each)")
    print(f"[build] K4a/K4b one-pass TF32: {len(one)} GEMM kernels of libpolar_sketch "
          f"(tf1_gemm_kernel) hold {sorted(one.values())} HGMMA TF32 instructions, one a k step "
          f"of 8 a 64-row block, no lo terms; the 3xTF32 instantiations (tc_gemm_kernel) "
          f"{sorted(three.values())}")


# ---- phase 3: each kernel against its plain version ------------------------

def chain_form(M: int, B: int) -> str:
    """The form K3 runs at (M, B) on this card, as the kernel's plan names it."""
    p = env_scan.kernel_plan(M, B)
    return f"{p['form']} form, C={p['C']} BT={p['BT']}"


def compare_chain(name: str, sites: torch.Tensor, x: torch.Tensor) -> float:
    """K3 vs its plain version in f32 and f64 on the card; returns the f32 error."""
    got = env_scan.right_env_chain(sites, x)
    torch.cuda.synchronize()
    ref32 = env_scan.right_env_chain_reference(sites, x)
    ref64 = env_scan.right_env_chain_reference(sites.double(), x.double())
    if got.shape != ref32.shape or not torch.isfinite(got).all():
        fail(f"{name}: kernel output {tuple(got.shape)} not finite or wrong shape")
    scale = float(ref64.abs().max())
    err32 = float((got - ref32).abs().max())
    err64 = float((got.double() - ref64).abs().max())
    ok = max(err32, err64) <= TOL * scale
    print(f"[kernel] right_env_chain {name} ({chain_form(sites.shape[1], x.shape[0])}): "
          f"max|ref|={scale:.4g} err_vs_f32={err32:.3g} err_vs_f64={err64:.3g} "
          f"tol={TOL * scale:.3g} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: chain kernel disagrees with its plain version")
    return err32


def compare_stack(name: str, sites: torch.Tensor, phi_t: torch.Tensor) -> float:
    """K3's stack form vs its plain version in f32 and f64 on the card, each
    slot against its own max|ref| (the slots' scales differ along the chain);
    returns the f32 error."""
    got = env_scan.right_env_stack_chain(sites, phi_t)
    torch.cuda.synchronize()
    ref32 = env_scan.right_env_stack_reference(sites, phi_t)
    ref64 = env_scan.right_env_stack_reference(sites.double(), phi_t.double())
    if got.shape != ref32.shape or not torch.isfinite(got).all():
        fail(f"{name}: stack output {tuple(got.shape)} not finite or wrong shape")
    scale = ref64.abs().flatten(1).amax(1).clamp_min(1e-30)
    err32 = float(((got - ref32).abs().flatten(1).amax(1).double() / scale).max())
    err64 = float(((got.double() - ref64).abs().flatten(1).amax(1) / scale).max())
    ok = max(err32, err64) <= TOL
    print(f"[kernel] right_env_stack_chain {name} ({chain_form(sites.shape[1], phi_t.shape[1])}):"
          f" worst slot err_vs_f32={err32:.3g} err_vs_f64={err64:.3g} of the slot's max|ref|, "
          f"tol {TOL:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: the stack form disagrees with its plain version")
    return float((got - ref32).abs().max())


def stack_inputs(mps, x: torch.Tensor) -> dict:
    """The sweep prologue's inputs at the flagship (the model's whole site
    stack and the embedded batch) and at M_WIDE (random sites, the same
    batch)."""
    phi = psi_embed(x).transpose(0, 1).contiguous()
    gen = torch.Generator().manual_seed(SEED + 7)
    wide = torch.randn((N, M_WIDE, D, M_WIDE), generator=gen) / np.sqrt(M_WIDE)
    return {M: (mps.sites, phi), M_WIDE: (wide.to(DEVICE), phi)}


class _Captured(Exception):
    pass


def capture_step(mps, x, y, step: int) -> dict:
    """The inputs K2 gets at ``step`` of the hybrid sweep over batch ``(x, y)``
    (the sweep stops there), and the inputs K1 then gets."""
    real = presplit_kernel.two_site_presplit
    seen = {"n": 0}

    def spy(*args, **kwargs):
        if seen["n"] == step:
            seen["args"], seen["kwargs"] = args, kwargs
            raise _Captured
        seen["n"] += 1
        return real(*args, **kwargs)

    cfg = flagship_cfg("hybrid")
    with mock.patch.object(sweep_mod, "two_site_presplit", spy):
        try:
            sweep_once(mps, psi_embed(x), one_hot_labels(y, L, torch.float32), LR, WD, cfg)
        except _Captured:
            pass
    if "args" not in seen:
        fail(f"the hybrid sweep never reached step {step}")
    out = real(*seen["args"], **seen["kwargs"])
    y0, g, stats = out[1], out[2], out[5]
    return {"k2": (seen["args"], seen["kwargs"]), "k2_out": out,
            "k1": (y0, g, stats[0, 2].reshape(1, 1)),
            "bmat": out[0].permute(1, 0, 2).reshape(out[0].shape[1], -1)}


def compare_presplit(name, args, kwargs) -> float:
    got = presplit_kernel.two_site_presplit(*args, **kwargs)
    torch.cuda.synchronize()
    want = presplit_kernel.two_site_presplit_reference(*args, **kwargs)
    rel, abs_err = [], 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{name}: K2 output {tuple(a.shape)} not finite or wrong shape")
        err = float((a - b).abs().max())
        abs_err = max(abs_err, err)
        rel.append(err / max(float(b.abs().max()), 1e-30))
    ok = max(rel) <= K2_TOL
    print(f"[kernel] two_site_presplit {name}: relative errors (B_new, y0, G, f_new, "
          f"left_part, stats) = {', '.join(f'{r:.2g}' for r in rel)}; tol {K2_TOL:g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: K2 disagrees with its plain version")
    return abs_err


def k1_form(I: int, q: int) -> str:
    """Which of K1's two forms an (I, q) launch runs (the library's own plan)."""
    if polar_split._lib().tnml_polar_cluster(I, q):
        return "cluster (16 CTAs, operands through L2 by the TMA)"
    return "streaming (8 CTAs, L2)"


def compare_polar(name, y0, g, n2, bmat) -> float:
    q = polar_split.polar_iterate(y0, g, n2)
    torch.cuda.synchronize()
    q_ref = polar_split.polar_iterate_reference(y0, g, n2)
    if q.shape != q_ref.shape or not torch.isfinite(q).all():
        fail(f"{name}: K1 output {tuple(q.shape)} not finite or wrong shape")
    q64, r64 = q.double(), q_ref.double()
    proj = float((q64 @ q64.T - r64 @ r64.T).abs().max())
    b64 = bmat.double()
    rec = float((q64 @ (q64.T @ b64) - r64 @ (r64.T @ b64)).abs().max() / b64.abs().max())
    live = torch.linalg.vector_norm(q64, dim=0) > 0.5
    iso = float((q64[:, live].T @ q64[:, live] - torch.eye(int(live.sum()), dtype=torch.float64,
                                                          device=q.device)).abs().max())
    err = float((q - q_ref).abs().max())
    ok = proj <= K1_PROJ_TOL and rec <= K1_REC_TOL and iso <= K1_ISO_TOL
    path = k1_form(*y0.shape)
    print(f"[kernel] polar_iterate {name} ({path} path): |QQt-Q'Q't|={proj:.3g} (tol {K1_PROJ_TOL:g}) "
          f"|QR-Q'R'|/max|B|={rec:.3g} (tol {K1_REC_TOL:g}) iso={iso:.3g} (tol "
          f"{K1_ISO_TOL:g}) live={int(live.sum())}/{q.shape[1]} |Q-Q'|={err:.3g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: K1 disagrees with its plain version")
    return err


def phase_kernel(mps, x_big: torch.Tensor, captured: dict) -> dict:
    errs = {}
    sites = mps.sites[1:]  # the chain the serving forward hands K3
    for B in (BATCH, BIG):
        errs[("right_env_chain", B)] = compare_chain(f"N={N} M={M} B={B}", sites, x_big[:B, 1:])
    gen = torch.Generator().manual_seed(SEED + 1)
    m, n, b = 5, 21, 37  # ragged: M not a tile multiple, B not a batch tile
    small = torch.randn((n, m, 2, m), generator=gen) / np.sqrt(m)
    xs = torch.rand((b, n), generator=gen)
    ragged = compare_chain(f"ragged M={m} n={n} B={b}", small.to(DEVICE), xs.to(DEVICE))
    errs[("right_env_chain", BATCH)] = max(errs[("right_env_chain", BATCH)], ragged)
    e = [compare_stack(f"N={N} M={m_} B={BATCH}", *inputs)
         for m_, inputs in stack_inputs(mps, x_big[:BATCH]).items()]
    e.append(compare_stack(f"ragged M={m} n={n} B={b}", small.to(DEVICE),
                           psi_embed(xs).transpose(0, 1).contiguous().to(DEVICE)))
    errs["right_env_stack_chain"] = max(e)

    args, kwargs = captured["k2"]
    e = [compare_presplit(f"flagship step {CAPTURE_STEP}", args, kwargs)]
    rl, rm, rb, rq = 3, 5, 37, 5  # ragged: L, M, B and q off every tile size
    r = lambda *s: torch.randn(s, generator=gen).to(DEVICE)  # noqa: E731
    ragged = (r(rl, rm * D, rm) / np.sqrt(rm), r(rm, D * rm) / np.sqrt(rm),
              torch.rand((rb, D), generator=gen).to(DEVICE),
              torch.rand((rb, D), generator=gen).to(DEVICE), r(rb, rm), r(rb, rm),
              torch.eye(rl)[torch.randint(0, rl, (rb,), generator=gen)].T.contiguous().to(DEVICE),
              0.3 * r(rl, rb), r(rl, D * rm, rq))
    e.append(compare_presplit(f"ragged L={rl} M={rm} B={rb}", ragged + (LR, WD),
                              dict(act_fn="softmax", loss_fn="cross_entropy", T=0.5)))
    errs["two_site_presplit"] = max(e)

    y0, g, n2 = captured["k1"]
    e = [compare_polar(f"flagship step {CAPTURE_STEP} I={y0.shape[0]} q={y0.shape[1]}",
                       y0, g, n2, captured["bmat"])]
    bm = r(40, 200)
    om = r(200, 24)
    e.append(compare_polar("ragged I=40 q=24 (n2 from tr G)", (bm @ om).contiguous(),
                           (bm @ bm.T).contiguous(), None, bm))
    errs["polar_iterate"] = max(e)
    return errs


# ---- phases 4-9: the main paths ---------------------------------------------

WRAPPERS = {
    "right_env_chain": env_scan.right_env_chain,
    "right_env_stack_chain": env_scan.right_env_stack_chain,
    "polar_iterate": polar_split.polar_iterate,
    "two_site_presplit": presplit_kernel.two_site_presplit,
    "gramfree_sketch": polar_split.gramfree_sketch,
    "gramfree_gmul": polar_split.gramfree_gmul,
    "gramfree_sketch_tf32": polar_split.gramfree_sketch_tf32,
    "gramfree_gmul_tf32": polar_split.gramfree_gmul_tf32,
    "polar_sketch_gram": polar_split.polar_sketch_gram,
    "rangefinder_split": split_kernel.rangefinder_split,
    "two_site_step": step_kernel.two_site_step,
    "polar_split": polar_split.polar_split,
}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def phase_serve(mps, requests: np.ndarray) -> dict:
    """Serve the flagship through Predictor.from_checkpoint on the card: the
    default batch of 256 on requests of REQUEST_SIZES, then bulk scoring of
    BIG requests at batch_size=BIG. Returns K3's launches at each batch size
    and the scores served, by number of requests."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.npz")
        save_checkpoint(mps, path)
        reset_counts()
        pred = Predictor.from_checkpoint(path)  # the default device: the card
        pred.warmup()
        served = {n: pred.scores(requests[:n]) for n in REQUEST_SIZES}
        labels = pred.predict(requests[:BATCH])
        launches[BATCH] = counts()["right_env_chain"]
        reset_counts()
        bulk = Predictor.from_checkpoint(path, batch_size=BIG)
        served[BIG] = bulk.scores(requests[:BIG])
        launches[BIG] = counts()["right_env_chain"]
        plain = Predictor.from_checkpoint(path, device=DEVICE, use_kernel=False)
    if pred.device.type != "cuda" or not pred.use_kernel or not bulk.use_kernel or plain.use_kernel:
        fail("the default Predictor did not serve on cuda through the kernel")
    if min(launches.values()) == 0:
        fail(f"the serving path never launched the chain kernel at some batch size: {launches}")
    for n, got in served.items():
        want = plain.scores(requests[:n])
        if got.shape != (n, L) or not np.isfinite(got).all():
            fail(f"scores for {n} requests: shape {got.shape} or non-finite values")
        err = float(np.abs(got - want).max())
        tol = TOL * float(np.abs(want).max())
        if err > tol:
            fail(f"scores for {n} requests differ from the plain Predictor: {err:.3g} > {tol:.3g}")
    if labels.shape != (BATCH,) or labels.min() < 0 or labels.max() >= L:
        fail(f"predict gave labels of shape {labels.shape} outside [0, {L})")
    print(f"[serve] Predictor.from_checkpoint (default device cuda, kernel) on requests "
          f"{REQUEST_SIZES} at batch {BATCH} ({chain_form(M, BATCH)}), and {BIG} requests at "
          f"batch {BIG} ({chain_form(M, BIG)}): shapes ok, scores match the plain Predictor "
          f"within {TOL:g} x max|f|; K3 launches {launches[BATCH]} and {launches[BIG]}")
    return {"launches": launches, "served": served}


def flagship_cfg(engine: str, precision: str = "default") -> SweepConfig:
    return SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                       svd_method="polar", engine=engine, matmul_precision=precision)


def plain_versions():
    """Swap the plain versions in for the kernel wrappers, where the sweep
    and the polar split look them up."""
    return (mock.patch.object(polar_split, "polar_iterate", polar_split.polar_iterate_reference),
            mock.patch.object(sweep_mod, "polar_iterate", polar_split.polar_iterate_reference),
            mock.patch.object(sweep_mod, "two_site_presplit",
                              presplit_kernel.two_site_presplit_reference),
            mock.patch.object(sweep_mod, "two_site_sweep", step_kernel.two_site_sweep_reference),
            mock.patch.object(sweep_mod, "right_env_stack_chain",
                              env_scan.right_env_stack_reference))


def one_sweep(mps, x, y, engine, plain=False, precision="default"):
    cfg = flagship_cfg(engine, precision)
    args = (mps, psi_embed(x), one_hot_labels(y, L, torch.float32), LR, WD, cfg)
    if not plain:
        return sweep_once(*args)
    p1, p2, p3, p4, p5 = plain_versions()
    with p1, p2, p3, p4, p5:
        return sweep_once(*args)


def sweep_gaps(what, a, b, x_fresh) -> tuple[float, float]:
    """Two one-sweep results (new_mps, f_first, f_final, metrics): how far
    apart f_final and the swept models' scores on fresh requests are,
    relative to max|f| of the second (each model scores in its own dtype)."""
    gaps = []
    for label, fa, fb in (("f_final", a[2], b[2]),
                          ("fresh scores",
                           mps_forward(a[0], psi_embed(x_fresh.to(a[0].dtype))),
                           mps_forward(b[0], psi_embed(x_fresh.to(b[0].dtype))))):
        if not (torch.isfinite(fa).all() and torch.isfinite(fb).all()):
            fail(f"{what}: non-finite {label}")
        fa, fb = fa.double(), fb.double()
        gaps.append(float((fa - fb).abs().max() / fb.abs().max()))
    return gaps[0], gaps[1]


def hold_sweeps(what, a, b, x_fresh) -> float:
    """Both gaps of ``sweep_gaps`` held to SWEEP_TOL."""
    gaps = sweep_gaps(what, a, b, x_fresh)
    for label, rel in zip(("f_final", "fresh scores"), gaps):
        print(f"[{what}] {label}: max|diff|/max|f| = {rel:.3g} (tol {SWEEP_TOL:g}) "
              f"{'ok' if rel <= SWEEP_TOL else 'FAIL'}")
        if rel > SWEEP_TOL:
            fail(f"{what}: {label} differs by {rel:.3g} of max|f|")
    return max(gaps)


def phase_train(mps0, x_tr, y_tr, x_val, y_val, x_fresh) -> tuple[int, float]:
    train_loader = ArrayLoader(NumpyDataset(x_tr, y_tr), BATCH, drop_last=True)
    val_loader = ArrayLoader(NumpyDataset(x_val, y_val), BATCH, drop_last=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mps, val_acc, var_hist = train_model(
        mps0, train_loader, val_loader, lr=LR, n_epochs=1, weight_dec=WD, L2_flag=False,
        svd_method="polar", split_mode="canonical", verbose=False, warmup_epochs=0,
        restarts=0,
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    if mps.device.type != "cuda" or not (torch.isfinite(mps.sites).all()
                                         and torch.isfinite(mps.label_site).all()):
        fail("train_model left a non-finite model or one off the card")
    if launched["polar_iterate"] != TRAIN_BATCHES * STEPS or launched["two_site_presplit"]:
        fail(f"train_model launched K1 {launched['polar_iterate']} times (want "
             f"{TRAIN_BATCHES * STEPS}) and K2 {launched['two_site_presplit']} (want 0)")
    if var_hist.shape != (1, 2, TRAIN_BATCHES * STEPS) or len(val_acc) != 1:
        fail(f"train_model returned var_hist {var_hist.shape}, {len(val_acc)} val accuracies")
    print(f"[train] train_model N={N} M={M} L={L} B={BATCH}, polar split, "
          f"{TRAIN_BATCHES} batches (2 right + 2 left sweeps): {seconds:.2f} s "
          f"({seconds / TRAIN_BATCHES * 1e3:.1f} ms/batch, validation included); "
          f"K1 launches {launched['polar_iterate']} = {TRAIN_BATCHES} x {STEPS}; "
          f"val acc {val_acc[0]:.4f}; model finite")
    xb, yb = torch.as_tensor(x_tr[:BATCH], device=DEVICE), torch.as_tensor(y_tr[:BATCH],
                                                                            device=DEVICE)
    kern = one_sweep(mps0, xb, yb, "xla")
    plain = one_sweep(mps0, xb, yb, "xla", plain=True)
    hold_sweeps("train", kern, plain, x_fresh)
    return launched["polar_iterate"], seconds / TRAIN_BATCHES


def phase_hybrid(mps0, x_tr, y_tr, x_fresh) -> dict:
    xe = torch.as_tensor(x_tr[: HYBRID_BATCHES * BATCH], device=DEVICE).reshape(
        HYBRID_BATCHES, BATCH, N)
    ye = torch.as_tensor(y_tr[: HYBRID_BATCHES * BATCH], device=DEVICE).reshape(
        HYBRID_BATCHES, BATCH)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mps, accs, _ = epoch_mod.fused_epoch(mps0, xe, ye, LR, WD, flagship_cfg("hybrid"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    want = HYBRID_BATCHES * STEPS
    if (launched["two_site_presplit"] != want or launched["polar_iterate"] != want
            or launched["right_env_stack_chain"] != HYBRID_BATCHES):
        fail(f"the hybrid epoch launched K2 {launched['two_site_presplit']} and K1 "
             f"{launched['polar_iterate']} times (want {want} each) and K3's stack form "
             f"{launched['right_env_stack_chain']} (want {HYBRID_BATCHES}, one a sweep)")
    if not (torch.isfinite(mps.sites).all() and torch.isfinite(mps.label_site).all()):
        fail("the hybrid epoch left a non-finite model")
    print(f"[hybrid] fused_epoch engine=hybrid, {HYBRID_BATCHES} batches: {seconds:.2f} s; "
          f"K2 launches {launched['two_site_presplit']}, K1 launches "
          f"{launched['polar_iterate']} = {HYBRID_BATCHES} x {STEPS} each, K3's stack form "
          f"{launched['right_env_stack_chain']}; batch accs "
          f"{[round(float(a), 4) for a in accs]}")
    hold_sweeps("hybrid", one_sweep(mps0, xe[0], ye[0], "hybrid"),
                one_sweep(mps0, xe[0], ye[0], "xla"), x_fresh)
    return launched


def wide_model(requests):
    return product_init(torch.Generator().manual_seed(SEED), N=N, M=M_WIDE, D=D, L=L,
                        act_fn="linear", loss_fn="MSE", calibration_x=requests[:512])


def wide_plain_sweep(wide, xb, yb):
    """The M=256 hybrid sweep through the plain versions of K2 and K1; each
    step's inputs also go through K2, K1 and a float64 run of K1's plain
    version. Returns the sweep and, per step, K2's largest relative error,
    K1's and the plain version's distance from the float64 run and their
    live columns."""
    steps = []

    def k2(*args, **kwargs):
        want = presplit_kernel.two_site_presplit_reference(*args, **kwargs)
        got = presplit_kernel.two_site_presplit(*args, **kwargs)
        rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(got, want))
        steps.append({"k2": rel, "bmat": want[0].permute(1, 0, 2).reshape(want[0].shape[1], -1)})
        return want

    def k1(y0, g, n2=None):
        want = polar_split.polar_iterate_reference(y0, g, n2)
        got = polar_split.polar_iterate(y0, g, n2)
        q64 = polar_split.polar_iterate_reference(y0.double(), g.double(),
                                                  None if n2 is None else n2.double())
        b64 = steps[-1].pop("bmat").double()
        bmax = max(float(b64.abs().max()), 1e-30)
        exact = q64 @ (q64.T @ b64)
        for key, q in (("k1", got.double()), ("plain", want.double())):
            steps[-1][key] = float((q @ (q.T @ b64) - exact).abs().max()) / bmax
        steps[-1]["live"] = tuple(int((torch.linalg.vector_norm(q, dim=0) > 0.5).sum())
                                  for q in (got, want))
        return want

    with mock.patch.object(sweep_mod, "two_site_presplit", k2), \
            mock.patch.object(sweep_mod, "polar_iterate", k1):
        plain = one_sweep(wide, xb, yb, "hybrid")
    return plain, steps


def split_float64(bmat, rank):
    """hybrid_polar_split in float64: the sketch, the Gram, K1's plain
    version (at the float32 path's dead_tol) and R."""
    I, J = bmat.shape
    b = bmat.double()
    om = svd_mod.rangefinder_omega(J, min(rank, I), torch.float32, b.device).double()
    q = polar_split.polar_iterate_reference(b @ om, b @ b.T, dead_tol=1e-6)
    return polar_split._canonical_factors(q, rank, b, torch.float64)


def float64_sweep(mps, x, y):
    """One xla polar sweep on a float64 copy of the model and the batch."""
    m = mps.replace(sites=mps.sites.double(), label_site=mps.label_site.double())
    with mock.patch.object(polar_split, "hybrid_polar_split", split_float64):
        out = sweep_once(m, psi_embed(x.double()), one_hot_labels(y, L, torch.float64), LR,
                         WD, flagship_cfg("xla"))
    if out[2].dtype != torch.float64:
        fail(f"the float64 sweep returned {out[2].dtype}")
    return out


def k1_in_float64(y0, g, n2=None, **kwargs):
    """K1's plain version run in float64 on K1's float32 inputs."""
    return polar_split.polar_iterate_reference(
        y0.double(), g.double(), None if n2 is None else n2.double(), **kwargs).float()


def phase_hybrid_wide(requests, xb, yb, x_fresh):
    """The hybrid engine at M=256, above the JAX package's M*D <= 256 cap: K2
    at I = 512 and K1 at I = 512, q = 256 against their plain versions on
    the inputs of step CAPTURE_STEP; one sweep, 195 launches each, and the
    xla polar sweep on the same batch, each held against a float64 run of
    the same sweep; the same sweep through the plain versions, with K2 and
    K1 held at each of its steps (WIDE_K1_RATIO). Printed beside them: the
    hybrid sweep against the xla sweep, the plain-version sweeps, the hybrid
    sweep on a model whose label core is rescaled by 1 + RF_PERTURB, and the
    plain-version sweep with K1's plain version in float64, each against the
    float64 run and the float32 ones against each other, and the float64
    run against itself rescaled."""
    wide = wide_model(requests)
    cap = capture_step(wide, xb, yb, CAPTURE_STEP)
    y0, g, n2 = cap["k1"]
    errs = {"two_site_presplit": compare_presplit(f"M={M_WIDE} step {CAPTURE_STEP}", *cap["k2"]),
            ("polar_iterate", M_WIDE): compare_polar(
                f"M={M_WIDE} step {CAPTURE_STEP} I={y0.shape[0]} q={y0.shape[1]}", y0, g, n2,
                cap["bmat"])}
    torch.cuda.synchronize()
    reset_counts()
    hyb = one_sweep(wide, xb, yb, "hybrid")
    torch.cuda.synchronize()
    launched = counts()
    if (launched["two_site_presplit"] != STEPS or launched["polar_iterate"] != STEPS
            or launched["right_env_stack_chain"] != 1):
        fail(f"the M={M_WIDE} hybrid sweep launched K2 {launched['two_site_presplit']} and K1 "
             f"{launched['polar_iterate']} times (want {STEPS} each) and K3's stack form "
             f"{launched['right_env_stack_chain']} (want 1)")
    print(f"[hybrid M={M_WIDE}] sweep engine=hybrid at M*D = {M_WIDE * D} (the JAX package "
          f"caps it at 256): K2 launches {launched['two_site_presplit']}, K1 launches "
          f"{launched['polar_iterate']} ({k1_form(*y0.shape)}), K3's stack form "
          f"{launched['right_env_stack_chain']}")
    xla = one_sweep(wide, xb, yb, "xla")
    ref = float64_sweep(wide, xb, yb)
    hold_sweeps(f"hybrid M={M_WIDE} vs float64", hyb, ref, x_fresh)
    hold_sweeps(f"xla M={M_WIDE} vs float64", xla, ref, x_fresh)

    plain, steps = wide_plain_sweep(wide, xb, yb)
    k2_worst = max(st["k2"] for st in steps)
    mean = {key: sum(st[key] for st in steps) / max(len(steps), 1) for key in ("k1", "plain")}
    ratio = mean["k1"] / max(mean["plain"], 1e-30)
    ok = len(steps) == STEPS and k2_worst <= K2_TOL and ratio <= WIDE_K1_RATIO
    print(f"[hybrid M={M_WIDE}] the sweep through the plain versions, K2 and K1 on each of its "
          f"{len(steps)} steps: K2 worst relative error {k2_worst:.3g} (tol {K2_TOL:g}); "
          f"|QQtB - Q64Q64tB|/max|B| against a float64 run of K1's plain version: K1 mean "
          f"{mean['k1']:.3g}, worst {max(st['k1'] for st in steps):.3g}, above {K1_REC_TOL:g} at "
          f"{sum(st['k1'] > K1_REC_TOL for st in steps)} steps; plain float32 mean "
          f"{mean['plain']:.3g}, worst {max(st['plain'] for st in steps):.3g}, above at "
          f"{sum(st['plain'] > K1_REC_TOL for st in steps)} steps; mean ratio {ratio:.3g} (tol "
          f"{WIDE_K1_RATIO:g}) {'ok' if ok else 'FAIL'}")
    print(f"[hybrid M={M_WIDE}] steps where K1 and its plain version keep different numbers of "
          f"live columns (step, K1, plain): "
          f"{[(i, *st['live']) for i, st in enumerate(steps) if st['live'][0] != st['live'][1]]}")
    if not ok:
        fail(f"K2 or K1 disagrees with its plain version along the M={M_WIDE} hybrid sweep")

    def rescaled(m):
        return m.replace(label_site=m.label_site * (1 + RF_PERTURB))

    p1, p2, p3, p4, p5 = plain_versions()
    with p1, p2, p3, p4, p5:
        plain_rescaled = one_sweep(rescaled(wide), xb, yb, "hybrid")
        xla_plain = one_sweep(wide, xb, yb, "xla")
        with mock.patch.object(sweep_mod, "polar_iterate", k1_in_float64):
            plain_k1_64 = one_sweep(wide, xb, yb, "hybrid")
    hyb_rescaled = one_sweep(rescaled(wide), xb, yb, "hybrid")
    for what, a, b in (
            ("hybrid vs xla", hyb, xla),
            ("hybrid vs its plain version", hyb, plain),
            (f"rounding floor: hybrid vs itself, label core x (1 + {RF_PERTURB:g})", hyb,
             hyb_rescaled),
            ("rounding floor: plain-version hybrid vs itself, rescaled", plain, plain_rescaled),
            ("xla vs its plain version", xla, xla_plain),
            ("plain-version hybrid vs plain-version xla (no kernel)", plain, xla_plain),
            ("plain-version hybrid vs float64", plain, ref),
            ("plain-version xla vs float64", xla_plain, ref),
            ("hybrid, label core rescaled, vs float64", hyb_rescaled, ref),
            ("plain-version hybrid with K1's plain version in float64 vs float64", plain_k1_64,
             ref),
            ("float64 rounding floor: float64 vs itself, rescaled",
             float64_sweep(rescaled(wide), xb, yb), ref)):
        gaps = sweep_gaps(f"hybrid M={M_WIDE} {what}", a, b, x_fresh)
        print(f"[hybrid M={M_WIDE}] {what}: f_final {gaps[0]:.3g}, fresh scores {gaps[1]:.3g} "
              f"of max|f| (printed, not held)")
    return wide, errs, cap, launched


# ---- phase 7: the fused engine (K7) ---------------------------------------------

def step_args(captured) -> tuple:
    """K7's inputs at the captured flagship step: K2's, with the right site
    as (M, D, M) and no Omega (K7 draws its own, the same one)."""
    (lab, a2m, x1, x2, l_env, r_env, y1h, f, _, lr, wd), _ = captured["k2"]
    return lab, a2m.reshape(M, D, M), x1, x2, l_env, r_env, y1h, f, lr, wd


def random_step_args(Lb, m, b, gen) -> tuple:
    """K7's inputs at another shape: embedded pixels, a label core and a
    site scaled like a product state's, targets one-hot, lr 0.5 so that the
    L1 clip fires and a growth cap bites."""
    r = lambda *s: torch.randn(s, generator=gen).to(DEVICE)  # noqa: E731
    px = torch.rand((b, 2), generator=gen)
    phi = torch.stack([torch.sin(np.pi * px / 2), torch.cos(np.pi * px / 2)], dim=-1).to(DEVICE)
    y1h = torch.eye(Lb)[torch.randint(0, Lb, (b,), generator=gen)].T.contiguous().to(DEVICE)
    return (r(Lb, m * D, m) / np.sqrt(m), r(m, D, m) / np.sqrt(m), phi[:, 0].contiguous(),
            phi[:, 1].contiguous(), r(b, m), r(b, m), y1h, 0.3 * r(Lb, b), 0.5, WD)


def compare_step(name, args, kw) -> float:
    """K7 vs its plain version: f_new and the metrics to K2_TOL of their max,
    Q (a_left over its renormalisation) by K1's projector and isometry
    limits, a_left . lab_new (= Q R per label) to K1_REC_TOL of the plain
    one's max, lenv_new against left @ a_left from the kernel's own a_left
    to K2_TOL. The renormalisation factor gg cancels from all of these, so it
    is held on its own, gauge-free: the largest column norm of a_left (gg;
    1 without renorm_envs) to K2_TOL relative to the plain one's (a scalar
    reduction), and the row norms of lenv_new (gg |Q^T left[b]|) to
    K1_REC_TOL of their max, as Q R (float32 against float64 on the CPU at
    the card test's shapes: <= 5e-7 and <= 5e-6, tests/torch_fused_spread.py).
    Returns the
    largest absolute difference over the outputs."""
    got = step_kernel.two_site_step(*args, **kw)
    torch.cuda.synchronize()
    want = step_kernel.two_site_step_reference(*args, **kw)
    for a, b in zip(got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{name}: K7 output {tuple(a.shape)} not finite or wrong shape")
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))  # noqa: E731
    lab, _, x1, _, lenv = args[:5]
    left = (lenv[:, :, None] * x1[:, None, :]).reshape(x1.shape[0], lab.shape[1])
    e_f, e_m, e_env = rel(got[3], want[3]), rel(got[4], want[4]), rel(got[2], left @ got[0])
    q, qp = got[0].double(), want[0].double()
    # a_left = gg Q with unit live columns
    gg, gg_p = torch.linalg.vector_norm(q, dim=0).max(), torch.linalg.vector_norm(qp, dim=0).max()
    e_gg = float(abs(gg / gg_p - 1))
    e_rows = rel(torch.linalg.vector_norm(got[2].double(), dim=1),
                 torch.linalg.vector_norm(want[2].double(), dim=1))
    q, qp = q / gg, qp / gg_p
    proj = float((q @ q.T - qp @ qp.T).abs().max())
    live = torch.linalg.vector_norm(q, dim=0) > 0.5
    iso = float((q[:, live].T @ q[:, live] - torch.eye(int(live.sum()), dtype=torch.float64,
                                                       device=q.device)).abs().max())
    qr = torch.einsum("im,omj->oij", got[0].double(), got[1].double())
    qr_p = torch.einsum("im,omj->oij", want[0].double(), want[1].double())
    rec = rel(qr, qr_p)
    ok = (max(e_f, e_m, e_env, e_gg) <= K2_TOL and proj <= K1_PROJ_TOL and iso <= K1_ISO_TOL
          and max(rec, e_rows) <= K1_REC_TOL)
    path = k1_form(lab.shape[1], lab.shape[2])
    print(f"[kernel] two_site_step {name} (K1 {path} path inside): f_new {e_f:.2g}, metrics "
          f"{e_m:.2g}, lenv_new vs left a_left {e_env:.2g}, gg {float(gg):.6g} vs "
          f"{float(gg_p):.6g} rel {e_gg:.2g} (tol {K2_TOL:g}); |lenv_new[b]| {e_rows:.2g} (tol "
          f"{K1_REC_TOL:g}); |QQt-Q'Q't|={proj:.3g} "
          f"(tol {K1_PROJ_TOL:g}) iso={iso:.3g} (tol {K1_ISO_TOL:g}) live={int(live.sum())}/"
          f"{q.shape[1]}; |QR-Q'R'|/max|Q'R'|={rec:.3g} (tol {K1_REC_TOL:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: K7 disagrees with its plain version")
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def step_cases(captured) -> list:
    """K7's four shapes: the captured flagship step, with the growth cap and
    renorm_envs, a ragged shape, and M=256 (K1 at I = 512 inside K7)."""
    args = step_args(captured)
    gen = torch.Generator().manual_seed(SEED + 8)
    return [
        (f"flagship step {CAPTURE_STEP}", args, {}),
        (f"flagship step {CAPTURE_STEP}, growth_cap=1e-3, renorm_envs", args,
         dict(growth_cap=1e-3, renorm_envs=True)),
        ("ragged L=10 M=48 B=100", random_step_args(L, 48, 100, gen), {}),
        ("M=256 B=64, growth_cap=1e-3", random_step_args(L, 256, 64, gen),
         dict(growth_cap=1e-3)),
    ]


def phase_step_kernels(captured) -> float:
    """K7 against its plain version at its four shapes; with --other-csrc also
    against the other build's K7, bit for bit."""
    cases = [(name, a, dict(act_fn="linear", loss_fn="MSE", **kw))
             for name, a, kw in step_cases(captured)]
    err = max(compare_step(name, a, kw) for name, a, kw in cases)
    if "two_site_step" in OTHER:
        for name, a, kw in cases:
            got = step_kernel.two_site_step(*a, **kw)
            with using_other("two_site_step"):
                other = step_kernel.two_site_step(*a, **kw)
            differ = [n for n, x, y in zip(("a_left", "lab_new", "lenv_new", "f_new", "metrics"),
                                           got, other) if not same_bits(x, y)]
            if differ:
                fail(f"K7 {name}: {differ} differ from the other build's ({OTHER_CSRC})")
        print(f"[kernel] two_site_step at its {len(cases)} shapes: every output the same bits "
              f"as the other build's K7 ({OTHER_CSRC})")
    return err


def phase_fused(mps0, x_tr, y_tr, x_fresh) -> dict:
    xe = torch.as_tensor(x_tr[: FUSED_BATCHES * BATCH], device=DEVICE).reshape(
        FUSED_BATCHES, BATCH, N)
    ye = torch.as_tensor(y_tr[: FUSED_BATCHES * BATCH], device=DEVICE).reshape(
        FUSED_BATCHES, BATCH)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mps, accs, _ = epoch_mod.fused_epoch(mps0, xe, ye, LR, WD, flagship_cfg("fused"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    want = FUSED_BATCHES * STEPS
    if (launched["two_site_step"] != want or launched["right_env_stack_chain"] != FUSED_BATCHES
            or any(v for k, v in launched.items()
                   if k not in ("two_site_step", "right_env_stack_chain"))):
        fail(f"the fused epoch launched {launched} (want K7 {want} times and K3's stack form "
             f"{FUSED_BATCHES}, one a sweep, nothing else)")
    if not (torch.isfinite(mps.sites).all() and torch.isfinite(mps.label_site).all()):
        fail("the fused epoch left a non-finite model")
    print(f"[fused] fused_epoch engine=fused, {FUSED_BATCHES} batches: {seconds:.2f} s; K7 "
          f"launches {launched['two_site_step']} = {FUSED_BATCHES} x {STEPS}, K3's stack form "
          f"{launched['right_env_stack_chain']}, K1 and K2 "
          f"{launched['polar_iterate']} and {launched['two_site_presplit']}; batch accs "
          f"{[round(float(a), 4) for a in accs]}")
    seen = {}

    def spy(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        return step_kernel.two_site_sweep(*args, **kwargs)

    with mock.patch.object(sweep_mod, "two_site_sweep", spy):
        kern = one_sweep(mps0, xe[0], ye[0], "fused")
    if kern[2].dtype != torch.float32:
        fail(f"the fused sweep's f_final is {kern[2].dtype}, not float32")
    # the sweep entry (every step issued from C) against the loop of per-step K7
    # calls in this build, on the same sweep's inputs
    args, kwargs = seen["args"], seen["kwargs"]
    got = step_kernel.two_site_sweep(*args, **kwargs)
    want = step_kernel.two_site_sweep_reference(*args, step=step_kernel.two_site_step, **kwargs)
    differ = [n for n, a, b in zip(("a_lefts", "lab_final", "f_final", "metrics"), got, want)
              if not same_bits(a, b)]
    gap = float(((got[4] - want[4]).abs() / want[4].abs().clamp(min=1e-30)).max())
    if differ or gap > K2_TOL:
        fail(f"the sweep entry differs from the per-step K7 loop: {differ}, mean|f| {gap:.3g}")
    print(f"[fused] the sweep entry (one call, {STEPS} steps) against {STEPS} per-step K7 calls: "
          f"a_lefts, the label core, f_final and the metrics the same bits; mean|f| (K2's "
          f"stats row against torch's mean) {gap:.3g} relative (tol {K2_TOL:g})")
    hold_sweeps("fused vs its plain version", kern,
                one_sweep(mps0, xe[0], ye[0], "fused", plain=True), x_fresh)
    hold_sweeps("fused vs xla", kern, one_sweep(mps0, xe[0], ye[0], "xla"), x_fresh)
    return launched


# ---- phases 8 and 9: the two-stage and the all-in-one polar splits -------------

def phase_two_stage(bmat, rank, what, against_f64=False) -> dict:
    """polar_split_two_stage, the entry point that runs K5 then K1, on a
    step's two-site matrix, held against hybrid_polar_split with K1's
    tolerances (with ``against_f64``, Q R against a float64 run instead:
    TWO_STAGE_RATIO)."""
    reset_counts()
    q, r = polar_split.polar_split_two_stage(bmat, rank)
    torch.cuda.synchronize()
    launched = counts()
    if launched["polar_sketch_gram"] != 1 or launched["polar_iterate"] != 1:
        fail(f"polar_split_two_stage launched K5 {launched['polar_sketch_gram']} and K1 "
             f"{launched['polar_iterate']} times (want 1 each)")
    qh, rh = polar_split.hybrid_polar_split(bmat, rank)
    if q.shape != qh.shape or r.shape != rh.shape or not (torch.isfinite(q).all()
                                                           and torch.isfinite(r).all()):
        fail(f"polar_split_two_stage gave {tuple(q.shape)}, {tuple(r.shape)} or non-finite values")
    proj, rec, iso = split_agreement(bmat, q, r, qh, rh)
    ok = proj <= K1_PROJ_TOL and iso <= K1_ISO_TOL
    if against_f64:
        b64 = bmat.double()
        om = svd_mod.rangefinder_omega(b64.shape[1], min(rank, b64.shape[0]), torch.float32,
                                       bmat.device).double()
        q64 = polar_split.polar_iterate_reference(
            *polar_split.polar_sketch_gram_reference(b64, om))
        exact = q64 @ (q64.T @ b64)
        bmax = max(float(b64.abs().max()), 1e-30)
        dist = [float((u.double() @ (u.double().T @ b64) - exact).abs().max()) / bmax
                for u in (q, qh)]
        ok = ok and dist[0] <= TWO_STAGE_RATIO * dist[1]
        held = (f"|QR-Q'R'|/max|B|={rec:.3g} (printed); against a float64 run of the plain "
                f"version, |QQtB - Q64Q64tB|/max|B|: two-stage {dist[0]:.3g}, hybrid "
                f"{dist[1]:.3g}, ratio {dist[0] / max(dist[1], 1e-30):.3g} (tol {TWO_STAGE_RATIO:g})")
    else:
        ok = ok and rec <= K1_REC_TOL
        held = f"|QR-Q'R'|/max|B|={rec:.3g} (tol {K1_REC_TOL:g})"
    print(f"[two-stage] polar_split_two_stage I={bmat.shape[0]} J={bmat.shape[1]} q={rank} "
          f"({what}): K5 launches 1, K1 launches 1; vs hybrid_polar_split "
          f"|QQt-Q'Q't|={proj:.3g} (tol {K1_PROJ_TOL:g}) iso={iso:.3g} (tol {K1_ISO_TOL:g}) "
          f"{held} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("polar_split_two_stage disagrees with hybrid_polar_split")
    return launched


def split_agreement(bmat, q, r, qp, rp):
    """Two polar splits of ``bmat``: |QQt - Q'Q't|, |QR - Q'R'| / max|B| and
    the isometry of Q's live columns."""
    q64, p64, b64 = q.double(), qp.double(), bmat.double()
    proj = float((q64 @ q64.T - p64 @ p64.T).abs().max())
    rec = float((q64 @ r.double() - p64 @ rp.double()).abs().max() / b64.abs().max())
    live = torch.linalg.vector_norm(q64, dim=0) > 0.5
    iso = float((q64[:, live].T @ q64[:, live] - torch.eye(int(live.sum()), dtype=torch.float64,
                                                          device=q.device)).abs().max())
    return proj, rec, iso


def compare_polar_split(name, bmat, rank, n_power) -> float:
    q, r = polar_split.polar_split(bmat, rank, n_power=n_power)
    torch.cuda.synchronize()
    qp, rp = polar_split.polar_split_reference(bmat, rank, n_power=n_power)
    if q.shape != qp.shape or r.shape != rp.shape or not (torch.isfinite(q).all()
                                                           and torch.isfinite(r).all()):
        fail(f"{name}: K8 gave {tuple(q.shape)}, {tuple(r.shape)} or non-finite values")
    proj, rec, iso = split_agreement(bmat, q, r, qp, rp)
    ok = proj <= K1_PROJ_TOL and rec <= K1_REC_TOL and iso <= K1_ISO_TOL
    I, J = bmat.shape
    path = k1_form(I, min(rank, I))
    print(f"[kernel] polar_split {name} I={I} J={J} rank={rank} n_power={n_power} (K1 {path} "
          f"path inside, Omega at J + {polar_split._tile_j(I, J)[2]}): |QQt-Q'Q't|={proj:.3g} "
          f"(tol {K1_PROJ_TOL:g}) |QR-Q'R'|/max|B|={rec:.3g} (tol {K1_REC_TOL:g}) iso={iso:.3g} "
          f"(tol {K1_ISO_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: K8 disagrees with its plain version")
    return max(float((q - qp).abs().max()), float((r - rp).abs().max()))


def k8_cases(captured, wide_cap) -> list:
    """K8's checked shapes: (name, bmat, rank, n_power, key in the kernels line)."""
    gen = torch.Generator().manual_seed(SEED + 9)
    return [(f"flagship step {CAPTURE_STEP}", captured["bmat"], M, 1, "polar_split"),
            ("padded", gapped(96, 300, 48, gen).float().to(DEVICE), 48, 2, None),
            (f"M={M_WIDE} step {CAPTURE_STEP}", wide_cap["bmat"], M_WIDE, 1,
             ("polar_split", M_WIDE))]


def phase_polar_split_kernels(captured, wide_cap) -> dict:
    """K8 against its plain version at its three shapes, and bit for bit
    against polar_split_two_stage where J needs no pad for Omega (the same
    Omega, the same sums in the same order) and, with --other-csrc, against
    the other build's K8 at every shape."""
    errs = {}
    for name, bmat, rank, n_power, key in k8_cases(captured, wide_cap):
        err = compare_polar_split(name, bmat, rank, n_power)
        if key is not None:
            errs[key] = err
        q, r = polar_split.polar_split(bmat, rank, n_power=n_power)
        held = []
        if polar_split._tile_j(*bmat.shape)[2] == 0 and n_power == 1:
            held.append(("polar_split_two_stage", polar_split.polar_split_two_stage(bmat, rank)))
        if "polar_iterate" in OTHER:
            with using_other("polar_iterate"):
                held.append((f"the other build's K8 ({OTHER_CSRC})",
                             polar_split.polar_split(bmat, rank, n_power=n_power)))
        for what, (qo, ro) in held:
            if not (same_bits(q, qo) and same_bits(r, ro)):
                fail(f"K8 {name}: Q and R are not {what}'s bit for bit")
        if held:
            print(f"[kernel] polar_split {name}: Q and R bit for bit "
                  + " and ".join(what for what, _ in held) + "'s")
    return errs


def phase_polar_split(captured, wide_cap) -> dict:
    """polar_split (K8), an entry point no sweep reaches, once on the flagship
    step's two-site matrix and once on the M=256 step's, each call its own
    window of launch counts, held against polar_split_two_stage and
    hybrid_polar_split by the projector (the same Omega: J needs no pad)."""
    launches = {}
    for name, bmat, rank, _, key in k8_cases(captured, wide_cap):
        if key is None:
            continue
        reset_counts()
        q, r = polar_split.polar_split(bmat, rank)
        torch.cuda.synchronize()
        launched = counts()
        if launched["polar_split"] != 1 or any(v for k, v in launched.items()
                                               if k != "polar_split"):
            fail(f"polar_split at {name} launched {launched} (want K8 once, nothing else)")
        launches[key] = launched["polar_split"]
        parts = []
        for what, split in (("polar_split_two_stage", polar_split.polar_split_two_stage),
                            ("hybrid_polar_split", polar_split.hybrid_polar_split)):
            qo, ro = split(bmat, rank)
            proj, rec, iso = split_agreement(bmat, q, r, qo, ro)
            if proj > K1_PROJ_TOL:
                fail(f"polar_split and {what} differ at {name}: |QQt-Q'Q't| = {proj:.3g}")
            parts.append(f"vs {what} |QQt-Q'Q't|={proj:.3g} |QR-Q'R'|/max|B|={rec:.3g}")
        print(f"[all-in-one] polar_split I={bmat.shape[0]} J={bmat.shape[1]} q={rank} ({name}): "
              f"K8 launches 1; " + "; ".join(parts) + f" (tol {K1_PROJ_TOL:g} on the "
              f"projector); isometry {iso:.3g} ok")
    return launches


# ---- phase 10: the rangefinder path (K6) -----------------------------------------

def rf_cfg() -> SweepConfig:
    return flagship_cfg("xla")._replace(svd_method="rangefinder")


def gapped(I: int, J: int, rank: int, gen) -> torch.Tensor:
    """A float64 matrix whose spectrum spans a decade over ``rank`` values and
    then drops 20x, the structure of a two-site matrix in canonical training."""
    u = torch.linalg.qr(torch.randn((I, I), generator=gen, dtype=torch.float64))[0]
    v = torch.linalg.qr(torch.randn((J, I), generator=gen, dtype=torch.float64))[0]
    s = torch.cat([torch.logspace(0, -1, rank, dtype=torch.float64),
                   torch.logspace(-2.3, -3.3, I - rank, dtype=torch.float64)])
    return (u * s) @ v.T


def k6_agreement(bmat, q, r, qp, rp):
    """K6's ``(q, r)`` against the plain version's ``(qp, rp)`` on ``bmat``:
    the projector of the live block, |Q R - Q' R'| / max|B|, the isometry of
    Q, and the number of live columns."""
    q64, p64, b64 = q.double(), qp.double(), bmat.double()
    bmax = max(float(b64.abs().max()), 1e-30)
    rows = torch.linalg.vector_norm(rp.double(), dim=1)
    live = rows > LIVE_TOL * rows.max()
    ql, pl = q64[:, live], p64[:, live]
    proj = float((ql @ ql.T - pl @ pl.T).abs().max()) if bool(live.any()) else 0.0
    rec = float((q64 @ r.double() - p64 @ rp.double()).abs().max()) / bmax
    eye = torch.eye(q.shape[1], dtype=torch.float64, device=q.device)
    iso = float((q64.T @ q64 - eye).abs().max())
    return proj, rec, iso, int(live.sum())


def k6_within(proj, rec, iso) -> bool:
    return proj <= K1_PROJ_TOL and rec <= K1_REC_TOL and iso <= K1_ISO_TOL


def compare_rangefinder(name, bmat, rank) -> float:
    """K6 vs its plain version on the card; returns the largest of |Q - Q'|
    and |R - R'|."""
    q, r = split_kernel.rangefinder_split(bmat, rank)
    torch.cuda.synchronize()
    qp, rp = split_kernel.rangefinder_split_plain(bmat, rank)
    if q.shape != qp.shape or r.shape != rp.shape or not (torch.isfinite(q).all()
                                                           and torch.isfinite(r).all()):
        fail(f"{name}: K6 gave {tuple(q.shape)}, {tuple(r.shape)} or non-finite values")
    proj, rec, iso, n_live = k6_agreement(bmat, q, r, qp, rp)
    err = max(float((q - qp).abs().max()), float((r - rp).abs().max()))
    ok = k6_within(proj, rec, iso)
    I = bmat.shape[0]
    path = ("resident" if split_kernel._lib().tnml_rangefinder_resident(I, min(rank + 8, I))
            else "global-memory")
    print(f"[kernel] rangefinder_split {name} rank={rank} ({path} path): live block "
          f"{n_live}/{rank} |QQt-Q'Q't|={proj:.3g} (tol {K1_PROJ_TOL:g}) |QR-Q'R'|/max|B|="
          f"{rec:.3g} (tol {K1_REC_TOL:g}) iso={iso:.3g} (tol {K1_ISO_TOL:g}) |Q-Q'|,|R-R'| "
          f"max={err:.3g} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: K6 disagrees with its plain version")
    return err


def phase_rangefinder_kernels(captured) -> float:
    bmat = captured["bmat"]
    gen = torch.Generator().manual_seed(SEED + 6)
    edge = bmat.clone()
    edge[D:] = 0.0  # the left chain end: only bond slot 0 of the left leg is live
    cases = [
        (f"flagship step {CAPTURE_STEP} I={bmat.shape[0]} J={bmat.shape[1]}", bmat, M),
        ("ragged I=130 J=1000", (torch.randn((130, 1000), generator=gen) / 30).to(DEVICE), 60),
        ("I=512 J=5120", gapped(512, 5120, 256, gen).float().to(DEVICE), 256),
        (f"edge step (rows >= {D} zero) I={bmat.shape[0]}", edge, M),
    ]
    return max(compare_rangefinder(*c) for c in cases)


def rf_loaders(seed: int):
    """train_model's loaders as cli/training_mnist.py builds them (raw
    pixels, validation carved from the train part, an even number of train
    batches): 2 batches of 256, and validation and test batches of 64
    instead of the CLI's 256 so that the 77 validation samples fill one."""
    n_train = 3 * BATCH
    x, y = pooled(n_train + BATCH, seed)
    return prepare_dataset(x, y, n_train / len(x), 0.1, train_batch_size=BATCH,
                           val_batch_size=64, test_batch_size=64, embed=False, seed=SEED,
                           even_train_batches=True)


def phase_rangefinder_train(mps0):
    train_loader, val_loader, _ = rf_loaders(SEED + 6)
    if len(train_loader) != RF_BATCHES:
        fail(f"prepare_dataset gave {len(train_loader)} train batches, want {RF_BATCHES}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mps, val_acc, var_hist = train_model(
        mps0, train_loader, val_loader, lr=LR, n_epochs=1, weight_dec=WD, L2_flag=False,
        svd_method="rangefinder", split_mode="canonical", verbose=False,
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    want = RF_BATCHES * STEPS
    if (launched["rangefinder_split"] != want or launched["right_env_stack_chain"] != RF_BATCHES
            or any(v for k, v in launched.items()
                   if k not in ("rangefinder_split", "right_env_stack_chain"))):
        fail(f"the rangefinder train_model launched {launched} (want K6 {want} times and K3's "
             f"stack form {RF_BATCHES}, one a sweep, nothing else)")
    if mps.device.type != "cuda" or not (torch.isfinite(mps.sites).all()
                                         and torch.isfinite(mps.label_site).all()):
        fail("the rangefinder train_model left a non-finite model or one off the card")
    if var_hist.shape != (1, 2, want) or len(val_acc) != 1 or mps.l_pos != 0:
        fail(f"train_model returned var_hist {var_hist.shape}, {len(val_acc)} val accuracies, "
             f"label at {mps.l_pos}")
    print(f"[rangefinder] train_model N={N} M={M} L={L} B={BATCH}, rangefinder split, loaders "
          f"from prepare_dataset, {RF_BATCHES} batches: {seconds:.2f} s "
          f"({seconds / RF_BATCHES * 1e3:.1f} ms/batch, validation included); K6 launches "
          f"{launched['rangefinder_split']} = {RF_BATCHES} x {STEPS}; val acc {val_acc[0]:.4f}")
    return mps, launched["rangefinder_split"], seconds / RF_BATCHES


def plain_rangefinder_on_host(bmat, rank):
    """K6's plain version on the host CPU: on the card its ~20,000 small
    launches per split take about half a second, which a 195-step sweep
    cannot afford here."""
    q, r = split_kernel.rangefinder_split_plain(bmat.cpu(), rank)
    return q.to(bmat.device), r.to(bmat.device)


def rf_sweep(mps, xb, yb):
    return sweep_once(mps, psi_embed(xb), one_hot_labels(yb, L, torch.float32), LR, WD, rf_cfg())


def phase_rangefinder_sweep(mps0, xb, yb, x_fresh, y_fresh) -> None:
    """One rangefinder sweep through K6, and the same sweep with K6's plain
    version, whose every split is also run through K6 and held against it;
    the two sweeps, and the K6 sweep against the polar sweep, by quality."""
    kern = rf_sweep(mps0, xb, yb)
    kernel = split_kernel.rangefinder_split
    steps = []

    # wraps: the wrapper counts its launches on whatever its module's name
    # for it holds, here this spy
    @functools.wraps(kernel)
    def plain_step(bmat, rank):
        qp, rp = plain_rangefinder_on_host(bmat, rank)
        q, r = kernel(bmat, rank)
        steps.append(k6_agreement(bmat, q, r, qp, rp))
        return qp, rp

    t0 = time.perf_counter()
    with mock.patch.object(split_kernel, "rangefinder_split", plain_step):
        plain = sweep_once(mps0, psi_embed(xb), one_hot_labels(yb, L, torch.float32), LR, WD,
                           rf_cfg())
    plain_s = time.perf_counter() - t0
    worst = [max(st[i] for st in steps) for i in range(3)]
    deficient = sum(st[3] < M for st in steps)
    ok = len(steps) == STEPS and k6_within(*worst)
    print(f"[rangefinder] the sweep with K6's plain version on the host ({plain_s:.1f} s), K6 on "
          f"each of its {len(steps)} splits: worst live-block |QQt-Q'Q't|={worst[0]:.3g} (tol "
          f"{K1_PROJ_TOL:g}) |QR-Q'R'|/max|B|={worst[1]:.3g} (tol {K1_REC_TOL:g}) iso="
          f"{worst[2]:.3g} (tol {K1_ISO_TOL:g}); {deficient} steps with fewer than {M} live "
          f"columns (smallest {min(st[3] for st in steps)}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("K6 disagrees with its plain version along the sweep")

    pert = rf_sweep(mps0.replace(label_site=mps0.label_site * (1 + RF_PERTURB)), xb, yb)
    exact = sweep_once(mps0, psi_embed(xb), one_hot_labels(yb, L, torch.float32), LR, WD,
                       rf_cfg()._replace(svd_method="svd"))
    polar = one_sweep(mps0, xb, yb, "xla")
    phi_fresh = psi_embed(x_fresh)
    scores = {what: mps_forward(m, phi_fresh) for what, m in
              (("init", mps0), ("K6", kern[0]), ("plain", plain[0]), ("rescaled", pert[0]),
               ("svd", exact[0]), ("polar", polar[0]))}
    scores["rescaled"] = scores["rescaled"] / (1 + RF_PERTURB)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    acc = {what: float((sc.argmax(dim=0) == y_fresh).float().mean()) for what, sc in scores.items()}
    if not all(torch.isfinite(sc).all() for sc in scores.values()):
        fail("a sweep left non-finite scores")
    ok = abs(acc["K6"] - acc["plain"]) <= QUALITY_ACC_TOL and acc["K6"] >= RF_MIN_ACC
    print(f"[rangefinder] K6 sweep vs plain-version sweep: f_final {rel(kern[2], plain[2]):.3g}, "
          f"fresh scores {rel(scores['K6'], scores['plain']):.3g} of max|f|; rounding floor, "
          f"the K6 sweep on the model rescaled by 1 + {RF_PERTURB:g}: f_final "
          f"{rel(kern[2], pert[2] / (1 + RF_PERTURB)):.3g}, fresh scores "
          f"{rel(scores['K6'], scores['rescaled']):.3g}")
    print(f"[rangefinder] accuracy on {len(y_fresh)} fresh requests (max|f|): "
          + ", ".join(f"{k} {acc[k]:.4f} ({float(scores[k].abs().max()):.3g})" for k in scores)
          + f"; held: |K6 - plain| <= {QUALITY_ACC_TOL:g}, K6 >= {RF_MIN_ACC:g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the rangefinder sweep does not train, or differs from its plain-version sweep")


def phase_canonical(requests, trained, x_fresh) -> None:
    """product_init(canonicalize=True) at the flagship on the card, and
    canonicalize of the model train_model left (label at site 0)."""
    mps = product_init(torch.Generator().manual_seed(SEED), N=N, M=M, D=D, L=L,
                       act_fn="linear", loss_fn="MSE", calibration_x=requests[:512],
                       canonicalize=True)
    if mps.device.type != "cuda":
        fail(f"product_init(canonicalize=True) placed the model on {mps.device}")
    a = mps.sites[1:].reshape(N - 1, M, D * M).double()
    p = a @ a.transpose(1, 2)
    iso = float((p @ p - p).abs().max())
    f_max = float(mps_forward(mps, psi_embed(torch.as_tensor(requests[:512], device=DEVICE)))
                  .abs().max())
    canon = canonicalize(trained)
    before = mps_forward(trained, psi_embed(x_fresh))
    kept = float((mps_forward(canon, psi_embed(x_fresh)) - before).abs().max()
                 / before.abs().max())
    a = canon.sites[1:].reshape(N - 1, M, D * M).double()
    p = a @ a.transpose(1, 2)
    iso_c = float((p @ p - p).abs().max())
    ok = max(iso, abs(f_max - 1.0), kept, iso_c) <= CANON_TOL
    print(f"[canonical] product_init(canonicalize=True) on {mps.device}: |P P - P| of sites "
          f"1..{N - 1} {iso:.3g}, max|f| on the calibration batch {f_max:.7f} (target 1); canonicalize of the "
          f"trained model: scores on fresh requests kept to {kept:.3g} of max|f|, |P P - P| "
          f"{iso_c:.3g} (tol {CANON_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the canonical gauge is off on the card")


def phase_small_splits() -> None:
    """gram, cholsvd, rangefinder (below K6's 128 rows) and svd, once each on
    the card, held by Q R against a float64 exact split."""
    gen = torch.Generator().manual_seed(SEED + 7)
    b64 = (30.0 * gapped(64, 640, 32, gen)).to(DEVICE)
    u, s, vh = torch.linalg.svd(b64, full_matrices=False)
    exact = (u[:, :32] * s[:32]) @ vh[:32]
    b = b64.float()
    reset_counts()
    errs = {}
    for method in ("gram", "cholsvd", "rangefinder", "svd"):
        q, r = svd_mod.truncated_svd_split(b, 32, method, split_mode="canonical")
        if q.device.type != "cuda" or q.shape != (64, 32) or not torch.isfinite(q @ r).all():
            fail(f"the {method} split gave {tuple(q.shape)} on {q.device} or non-finite values")
        errs[method] = float((q.double() @ r.double() - exact).abs().max() / b64.abs().max())
    ok = max(errs.values()) <= SMALL_SPLIT_TOL and not any(counts().values())
    print(f"[splits] I=64 J=640 rank=32 float32 on the card, |QR - exact|/max|B|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {SMALL_SPLIT_TOL:g}); kernel launches {sum(counts().values())} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("a small-I split is off the exact split, or launched a kernel")


# ---- phases 11-13: the data layer, the teacher task and the CLIs -----------------

M64 = (1 << 64) - 1


def shuffled_reference(n: int, seed: int) -> np.ndarray:
    """``native/data_core.cpp``'s Fisher-Yates shuffle in Python: xoshiro256**
    seeded by splitmix64 from ``seed + 1``, ``j = next() % (i + 1)``."""
    state, s = (seed + 1) & M64, []
    for _ in range(4):
        state = (state + 0x9E3779B97F4A7C15) & M64
        z = ((state ^ (state >> 30)) * 0xBF58476D1CE4E5B9) & M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
        s.append(z ^ (z >> 31))

    def rotl(x, k):
        return ((x << k) | (x >> (64 - k))) & M64

    idx = list(range(n))
    for i in range(n - 1, 0, -1):
        result = (rotl((s[1] * 5) & M64, 7) * 9) & M64
        t = (s[1] << 17) & M64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = rotl(s[3], 45)
        j = result % (i + 1)
        idx[i], idx[j] = idx[j], idx[i]
    return np.array(idx, dtype=np.int64)


def write_idx(path: str, arr: np.ndarray, gz: bool = False) -> None:
    import gzip
    import struct

    header = struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(">" + "I" * arr.ndim,
                                                                 *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(header + arr.astype(np.uint8).tobytes())


def phase_data() -> None:
    """The native host library built into _build/ and loaded (no NumPy
    fallback here), its functions against their NumPy versions, and the
    MNIST and CIFAR-10 checksum verdicts on files this phase writes."""
    import hashlib

    if not native.available():
        fail(f"the native data library did not build or load: {native.build_error()}")
    so = native.library_path()
    if so.parent != _build.BUILD_DIR or not so.exists():
        fail(f"the native library is at {so}, not in {_build.BUILD_DIR}")
    rng = np.random.default_rng(SEED + 11)
    x32 = rng.random((BATCH, N)).astype(np.float32)
    x64 = x32.astype(np.float64)
    half = (np.pi / 2.0) * x64
    ref64 = np.stack([np.sin(half), np.cos(half)], axis=-1)
    # the library computes the float32 map in double and rounds once
    emb32, emb64 = native.psi_embed(x32), native.psi_embed(x64)
    ulp64 = float((np.abs(emb64 - ref64) / np.spacing(np.abs(ref64) + 1e-300)).max())
    imgs = rng.random((64, 28, 28))
    idx = native.shuffled_indices(6000, SEED + 12)
    rows = native.gather_rows(x32, idx[:BATCH] % BATCH)
    checks = {
        "psi_embed float32": np.array_equal(emb32, ref64.astype(np.float32)),
        "psi_embed float64 (<= 1 ulp)": ulp64 <= 1.0,
        "max_pool_2x2": np.array_equal(native.max_pool_2x2(imgs), max_pool_2x2(imgs)),
        "shuffled_indices": np.array_equal(idx, shuffled_reference(6000, SEED + 12)),
        "gather_rows": np.array_equal(rows, x32[idx[:BATCH] % BATCH]),
    }
    with tempfile.TemporaryDirectory() as tmp:
        empty = mnist_mod.verify_checksums(tmp)
        write_idx(os.path.join(tmp, "train-images-idx3-ubyte"),
                  rng.integers(0, 256, (8, 28, 28)))  # wrong geometry
        write_idx(os.path.join(tmp, "train-labels-idx1-ubyte"), rng.integers(0, 10, 60000))
        write_idx(os.path.join(tmp, "t10k-images-idx3-ubyte"),
                  rng.integers(0, 256, (10000, 28, 28)))
        gz = os.path.join(tmp, "t10k-labels-idx1-ubyte.gz")
        write_idx(gz, rng.integers(0, 10, 10000), gz=True)
        verdicts = mnist_mod.verify_checksums(tmp)
        md5 = hashlib.md5(open(gz, "rb").read()).hexdigest()
        with mock.patch.dict(mnist_mod.MNIST_GZ_MD5, {"t10k-labels-idx1-ubyte.gz": md5}):
            gz_ok = mnist_mod.verify_checksums(tmp)["t10k-labels-idx1-ubyte"]
        rec = np.zeros((10000, 3073), dtype=np.uint8)
        rec[:, 0] = rng.integers(0, 10, 10000)
        rec[:, 1:] = rng.integers(0, 256, (10000, 3072))
        rec.tofile(os.path.join(tmp, "data_batch_1.bin"))
        rec[0, 0] = 10  # a label out of range
        rec.tofile(os.path.join(tmp, "test_batch.bin"))
        cifar_verdicts = cifar.verify_checksums(tmp)
    checks["MNIST verdicts"] = (
        set(empty.values()) == {"missing"} and gz_ok == "ok"
        and verdicts == {"train-images-idx3-ubyte": "mismatch",
                         "train-labels-idx1-ubyte": "shape-ok",
                         "t10k-images-idx3-ubyte": "shape-ok",
                         "t10k-labels-idx1-ubyte": "shape-ok"})
    checks["CIFAR-10 verdicts"] = (
        cifar_verdicts["archive"] == "missing" and cifar_verdicts["data_batch_1.bin"] == "shape-ok"
        and cifar_verdicts["test_batch.bin"] == "mismatch"
        and cifar_verdicts["data_batch_2.bin"] == "missing")
    print(f"[data] native library {so.name} (built in _build/, version "
          f"{native.get_lib().tnml_version()}); psi_embed float64 within {ulp64:g} ulp of NumPy; "
          + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"the data layer is off: {bad}")


def teacher_build(device, seed):
    """teacher_task at its defaults on ``device``: ``(task, pools, seconds)``,
    with each chunk of candidate pixels the teachers scored and its scores."""
    pools = []
    real = teacher_mod.teacher_scores

    def keep(teachers, x):
        f = real(teachers, x)
        pools.append((x, f))
        return f

    with mock.patch.object(teacher_mod, "teacher_scores", keep):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        task = teacher_mod.teacher_task(seed=seed, device=device)
        seconds = time.perf_counter() - t0
    return task, pools, seconds


def phase_teacher() -> dict:
    """teacher_task at its defaults (N=196, L=10, teacher_m=4, 4096 + 1024
    samples, proto_mix 0.2) on the card and on the CPU, held against each
    other; then the flagship student (M=128, polar, canonical) trained on the
    card's task for one epoch of TEACHER_BATCHES batches."""
    # the port's teacher draw at seed 0 leaves one class short of the exact
    # balance, as the JAX package's draw does at most seeds: both devices must
    # refuse it alike
    for device in (DEVICE, "cpu"):
        try:
            teacher_mod.teacher_task(seed=0, device=device)
            fail(f"teacher_task(seed=0) built on {device}; the port's draw leaves a class short")
        except ValueError as exc:
            print(f"[teacher] seed 0 on {device}: ValueError ({exc})")
    (card, card_pools, card_s) = teacher_build(DEVICE, TEACHER_SEED)
    (host, host_pools, host_s) = teacher_build("cpu", TEACHER_SEED)
    pools_equal = len(card_pools) == len(host_pools) and all(
        np.array_equal(a[0], b[0]) for a, b in zip(card_pools, host_pools))
    fc = np.concatenate([f for _, f in card_pools])
    fh = np.concatenate([f for _, f in host_pools])
    score_gap = float(np.abs(fc - fh).max() / np.abs(fh).max())

    def z(f):
        return (f - f.mean(0)) / f.std(0)

    pool_agree = float(np.mean(z(fc).argmax(1) == z(fh).argmax(1)))
    xs_c, xs_h = np.concatenate([card[0], card[2]]), np.concatenate([host[0], host[2]])
    ys_c, ys_h = np.concatenate([card[1], card[3]]), np.concatenate([host[1], host[3]])
    row_agree = float(np.mean(np.all(xs_c == xs_h, axis=1) & (ys_c == ys_h)))
    balance = [np.bincount(y, minlength=L) for y in (ys_c, ys_h)]
    balanced = all(b.min() == b.max() == (TEACHER_TRAIN + TEACHER_TEST) // L for b in balance)
    print(f"[teacher] teacher_task(seed={TEACHER_SEED}) at its defaults: built on the card in "
          f"{card_s:.3f} s, on the CPU in {host_s:.3f} s; candidate pools equal: {pools_equal}; "
          f"scores {score_gap:.3g} of max apart; argmax labels agree on {pool_agree:.5f} of "
          f"the pool, the task's rows (same sample, same label) on {row_agree:.5f} (need "
          f">= {TEACHER_AGREE}); classes exactly balanced: {balanced}")
    if not (pools_equal and pool_agree >= TEACHER_AGREE and row_agree >= TEACHER_AGREE
            and balanced):
        fail("the teacher task on the card disagrees with the one on the CPU")

    tr_x, tr_y, te_x, te_y = card
    train_loader = ArrayLoader(NumpyDataset(tr_x, tr_y), BATCH, drop_last=True)
    test_loader = ArrayLoader(NumpyDataset(te_x, te_y), BATCH, drop_last=True)
    if len(train_loader) != TEACHER_BATCHES:
        fail(f"the teacher task gave {len(train_loader)} batches of {BATCH}")
    student = product_init(torch.Generator().manual_seed(SEED), N=N, M=M, D=D, L=L,
                           act_fn="linear", loss_fn="MSE", calibration_x=tr_x[:BATCH])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    student, val_acc, _ = train_model(
        student, train_loader, test_loader, lr=TEACHER_LR, n_epochs=1, weight_dec=WD,
        L2_flag=False, svd_method="polar", split_mode="canonical", renorm_envs=True,
        growth_cap=0.002, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    test_acc = evaluate_accuracy(student, test_loader)
    want = TEACHER_BATCHES * STEPS
    print(f"[teacher] student N={N} M={M} L={L} polar, canonical, lr {TEACHER_LR}, "
          f"{TEACHER_BATCHES} batches of {BATCH} on the card's task: {seconds:.2f} s "
          f"({seconds / TEACHER_BATCHES * 1e3:.1f} ms/batch, validation included); K1 "
          f"launches {launched['polar_iterate']} (want {want}), K3's stack form "
          f"{launched['right_env_stack_chain']} (want {TEACHER_BATCHES}, one a sweep); test "
          f"accuracy {test_acc:.4f} (need > {TEACHER_MIN_ACC}; chance {1 / L:g})")
    if (launched["polar_iterate"] != want or launched["right_env_stack_chain"] != TEACHER_BATCHES
            or sum(launched.values()) != want + TEACHER_BATCHES):
        fail(f"the student's training launched {launched}")
    if student.device.type != "cuda" or not (torch.isfinite(student.sites).all()
                                             and torch.isfinite(student.label_site).all()):
        fail("the student is non-finite or off the card")
    if not test_acc > TEACHER_MIN_ACC:
        fail(f"the student reached {test_acc:.4f} on the teacher task's test set")
    return {"card_s": card_s, "cpu_s": host_s, "test_acc": test_acc, "launches": want, "task": card,
            "ms_per_batch": seconds / TEACHER_BATCHES * 1e3}


@contextlib.contextmanager
def saved_models():
    """Within the block, every model a CLI saves through ``Network.save`` is
    kept, in order."""
    models = []
    real = Network.save

    def keep(net, path):
        models.append(net.mps)
        real(net, path)

    with mock.patch.object(Network, "save", keep):
        yield models


def phase_cli(x_fresh) -> dict:
    """The port's training_mnist CLI at the flagship on the card (its default
    device), through K1; the model it saved reloaded by Network.load; then
    training_diagonals and test_diagonals on the card."""
    timed = {}
    real_train = trainer_mod.train_model

    @functools.wraps(real_train)
    def timed_train(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_train(*args, **kwargs)
        torch.cuda.synchronize()
        timed["seconds"] = time.perf_counter() - t0
        timed["batches"] = len(args[1])
        return out

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mnist10.npz")
        argv = ["--synthetic", "--pool", "--M", str(M), "--svd_method", "polar", "--n_epochs",
                "1", "--batch_size", str(CLI_BATCH), "--restarts", "0", "--out", out]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with saved_models() as saved, mock.patch.object(trainer_mod, "train_model", timed_train):
            val_acc, test_acc = cli_mnist.main(argv)
        main_s = time.perf_counter() - t0
        launched = counts()
        batches = timed["batches"]
        if launched["polar_iterate"] != batches * STEPS or launched["two_site_presplit"]:
            fail(f"training_mnist launched K1 {launched['polar_iterate']} times (want "
                 f"{batches} x {STEPS}) and K2 {launched['two_site_presplit']} (want 0)")
        mps = saved[0]
        if mps.device.type != "cuda" or mps.M != M or not (
                torch.isfinite(mps.sites).all() and torch.isfinite(mps.label_site).all()):
            fail(f"training_mnist's model is on {mps.device}, M={mps.M}, or non-finite")
        net = Network.__new__(Network)
        net.mps = mps
        loaded = Network.load(out)  # the default device: the card
        got, want = loaded.forward(x_fresh).elem, net.forward(x_fresh).elem
        same = torch.equal(got, want)
        ms_batch = timed["seconds"] / batches * 1e3
        print(f"[cli] training_mnist {' '.join(argv[:-2])} on the default device "
              f"({loaded.device}): {batches} batches of {CLI_BATCH}, {ms_batch:.1f} ms/batch "
              f"(validation included; {main_s:.2f} s for the whole command); val acc "
              f"{val_acc[-1]:.4f}, test acc {test_acc:.4f}; K1 launches "
              f"{launched['polar_iterate']} = {batches} x {STEPS}, K2 "
              f"{launched['two_site_presplit']}; Network.load of the saved file (on "
              f"{loaded.device}) gives the same scores bit for bit on {len(x_fresh)} fresh "
              f"requests: {same}")
        if not same or loaded.device.type != "cuda":
            fail("the model training_mnist saved does not reload to the same scores on the card")

        diag = os.path.join(tmp, "diag.npz")
        with saved_models() as diag_saved:
            diag_val = cli_diag_train.main(["--n_samples", str(DIAG_SAMPLES), "--n_epochs", "2",
                                            "--seed", str(SEED), "--out", diag,
                                            "--results_dir", tmp])
        acc, mae = cli_diag_test.main(["--filename", diag, "--seed", str(SEED + 1)])
        trained = Network.__new__(Network)
        trained.mps = diag_saved[0]
        data, label = create_dataset(1000, 8, 0.6, seed=SEED + 1)
        loader = prepare_dataset(data, label, 0, 0, train_batch_size=1, val_batch_size=1,
                                 test_batch_size=128, embed=False)[2]
        mem = evaluate_loader(trained, loader)
        ok = (trained.device.type == "cuda" and (acc, mae) == mem and acc >= 0.9)
        print(f"[cli] training_diagonals ({DIAG_SAMPLES} samples, 2 epochs; val "
              f"{diag_val[-1]:.4f}) then "
              f"test_diagonals on the card: acc {acc:.4f}, mae {mae:.6f}; the trained Network "
              f"in memory gives acc {mem[0]:.4f}, mae {mem[1]:.6f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("test_diagonals on the saved model disagrees with the model in memory")
    return {"launches": launched["polar_iterate"], "ms_per_batch": ms_batch,
            "val_acc": val_acc[-1], "test_acc": test_acc, "diag_model": trained.mps,
            "diag_acc_mae": (acc, mae)}


# ---- phase 14: the large-bond path (M=512) -------------------------------------

def large_cfg(factored: str, precision: str = "default") -> SweepConfig:
    return flagship_cfg("xla", precision)._replace(factored_update=factored)


def capture_large(mps, xb, yb) -> dict:
    """The two-site matrix of step CAPTURE_STEP of a gram-free M=512 sweep,
    and the inputs its split hands K4a and K4b."""
    seen = {"n": 0}
    real = sweep_mod.truncated_svd_split

    def spy(bmat, *args, **kwargs):
        if seen["n"] == CAPTURE_STEP:
            seen["bmat"] = bmat
            raise _Captured
        seen["n"] += 1
        return real(bmat, *args, **kwargs)

    with mock.patch.object(sweep_mod, "truncated_svd_split", spy):
        try:
            sweep_once(mps, psi_embed(xb), one_hot_labels(yb, L, torch.float32), LR, WD,
                       large_cfg("off"))
        except _Captured:
            pass
    if "bmat" not in seen:
        fail(f"the M={M_LARGE} sweep never reached step {CAPTURE_STEP}")
    bmat = seen["bmat"].to(torch.float32).contiguous()
    inputs = {}

    def keep(name, fn):
        # wraps: the wrapper counts its launches on whatever its module's
        # name for it holds, here this spy
        @functools.wraps(fn)
        def run(*args):
            inputs[name] = args
            return fn(*args)
        return run

    with mock.patch.object(polar_split, "gramfree_sketch",
                           keep("k4a", polar_split.gramfree_sketch)), \
            mock.patch.object(polar_split, "gramfree_gmul", keep("k4b", polar_split.gramfree_gmul)):
        polar_split.gramfree_split(bmat, M_LARGE)
    return {"bmat": bmat, "k4a": inputs["k4a"], "k4b": inputs["k4b"]}


def compare_outputs(kernel, name, got, args, reference) -> float:
    """Outputs of one kernel launch vs its plain version in float32 and in
    float64 on the same inputs, each relative to the output's max; returns
    the largest error against the float32 plain version."""
    want32 = reference(*args)
    want64 = reference(*(a.double() for a in args))
    rel, worst = [], 0.0
    for g, w32, w64 in zip(got, want32, want64):
        if g.shape != w32.shape or not torch.isfinite(g).all():
            fail(f"{kernel} {name}: output {tuple(g.shape)} not finite or wrong shape")
        err32 = float((g - w32).abs().max())
        err64 = float((g.double() - w64).abs().max())
        worst = max(worst, err32)
        rel.append(max(err32, err64) / max(float(w64.abs().max()), 1e-30))
    ok = max(rel) <= RED_TOL
    print(f"[kernel] {kernel} {name}: relative errors {', '.join(f'{r:.2g}' for r in rel)} "
          f"(tol {RED_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: {kernel} disagrees with its plain version")
    return worst


def compare_reductions(name, bmat, om, y1) -> dict:
    errs = {}
    got = polar_split.gramfree_sketch(bmat, om)
    torch.cuda.synchronize()
    errs["gramfree_sketch"] = compare_outputs("gramfree_sketch (y0, n2)", name, got, (bmat, om),
                                              polar_split.gramfree_sketch_reference)
    got = (polar_split.gramfree_gmul(bmat, y1),)
    torch.cuda.synchronize()
    errs["gramfree_gmul"] = compare_outputs(
        "gramfree_gmul (z)", name, got, (bmat, y1),
        lambda b, y: (polar_split.gramfree_gmul_reference(b, y),))
    got = polar_split.polar_sketch_gram(bmat, om)
    torch.cuda.synchronize()
    errs["polar_sketch_gram"] = compare_outputs("polar_sketch_gram (y, G, n2)", name, got,
                                                (bmat, om),
                                                polar_split.polar_sketch_gram_reference)
    if not torch.equal(got[1], got[1].T):
        fail(f"{name}: K5's Gram is not exactly symmetric")
    return errs


def flagship_sketch_inputs(captured):
    """What polar_split_two_stage hands K5 on the flagship step: B and Omega."""
    bmat = captured["bmat"]
    return bmat, svd_mod.rangefinder_omega(bmat.shape[1], M, torch.float32, bmat.device)


def phase_large_kernels(large, captured) -> dict:
    bmat, om = large["k4a"]
    _, y1 = large["k4b"]
    I, J = bmat.shape
    errs = [compare_reductions(f"M={M_LARGE} step {CAPTURE_STEP} I={I} J={J} q={M_LARGE}",
                               bmat, om, y1)]
    b128, om128 = flagship_sketch_inputs(captured)
    got = polar_split.polar_sketch_gram(b128, om128)
    torch.cuda.synchronize()
    errs.append({"polar_sketch_gram": compare_outputs(
        "polar_sketch_gram (y, G, n2)", f"flagship step {CAPTURE_STEP} I={M * D} "
        f"J={b128.shape[1]} q={M}", got, (b128, om128), polar_split.polar_sketch_gram_reference)})
    if not torch.equal(got[1], got[1].T):
        fail("flagship step: K5's Gram is not exactly symmetric")
    gen = torch.Generator().manual_seed(SEED + 5)
    ri, rj, rq = 77, 1000, 47  # ragged: I, J and q off every tile size, q odd
    b = torch.randn((ri, rj), generator=gen) / np.sqrt(rj)
    b[:, [0, 3, rj - 1]] = 0.0  # dead columns
    om_r = torch.randn((rj, rq), generator=gen)
    y1_r = torch.linalg.qr(torch.randn((ri, rq), generator=gen))[0].contiguous()
    errs.append(compare_reductions(f"ragged I={ri} J={rj} q={rq}", b.to(DEVICE),
                                   om_r.to(DEVICE), y1_r.to(DEVICE)))
    out = {k: max(e[k] for e in errs if k in e) for k in errs[0]}
    # K5 has a row at the flagship shape (with the ragged one) and one at M=512
    out["polar_sketch_gram"] = max(e["polar_sketch_gram"] for e in errs[1:])
    out[("polar_sketch_gram", M_LARGE)] = errs[0]["polar_sketch_gram"]
    return out


def large_model(requests):
    return product_init(torch.Generator().manual_seed(SEED), N=N, M=M_LARGE, D=D, L=L,
                        act_fn="linear", loss_fn="MSE", calibration_x=requests[:512])


def phase_large_train(mps0, x_tr, y_tr, x_val, y_val) -> float:
    """train_model at M=512: the auto rule sends every step to the factored
    update (M*D > 512) with norm_spread on (M >= 256); no kernel runs."""
    n = LARGE_BATCHES * BATCH
    train_loader = ArrayLoader(NumpyDataset(x_tr[:n], y_tr[:n]), BATCH, drop_last=True)
    val_loader = ArrayLoader(NumpyDataset(x_val, y_val), BATCH, drop_last=True)
    steps = []
    real = sweep_mod.two_site_update_factored

    def spy(*args):
        steps.append(args[-1])  # the step's SweepConfig
        return real(*args)

    torch.cuda.synchronize()
    with mock.patch.object(sweep_mod, "two_site_update_factored", spy):
        reset_counts()
        t0 = time.perf_counter()
        mps, val_acc, var_hist = train_model(
            mps0, train_loader, val_loader, lr=LR, n_epochs=1, weight_dec=WD, L2_flag=False,
            svd_method="polar", split_mode="canonical", verbose=False, warmup_epochs=0,
            restarts=0,
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts()
    if not (torch.isfinite(mps.sites).all() and torch.isfinite(mps.label_site).all()):
        fail(f"train_model at M={M_LARGE} left a non-finite model")
    if len(steps) != LARGE_BATCHES * STEPS or not all(
            c.factored_update == "auto" and c.norm_spread for c in steps):
        fail(f"train_model at M={M_LARGE} took {len(steps)} factored steps (want "
             f"{LARGE_BATCHES * STEPS}, each with factored_update='auto' and norm_spread on)")
    if any(launched[k] for k in ("gramfree_sketch", "gramfree_gmul", "polar_sketch_gram",
                                 "polar_iterate", "two_site_presplit")):
        fail(f"the factored route launched split kernels: {launched}")
    if var_hist.shape != (1, 2, LARGE_BATCHES * STEPS) or len(val_acc) != 1:
        fail(f"train_model returned var_hist {var_hist.shape}, {len(val_acc)} val accuracies")
    print(f"[large] train_model N={N} M={M_LARGE} L={L} B={BATCH}, polar split, "
          f"{LARGE_BATCHES} batches (a right and a left sweep): {seconds:.2f} s "
          f"({seconds / LARGE_BATCHES * 1e3:.1f} ms/batch, validation included); "
          f"{len(steps)} factored steps, {sum(c.norm_spread for c in steps)} with norm_spread "
          f"on; kernel launches {launched} "
          f"(the factored route runs no kernel: K4a and K4b 0); val acc {val_acc[0]:.4f}; "
          f"model finite")
    return seconds / LARGE_BATCHES


def plain_reductions():
    return (mock.patch.object(polar_split, "gramfree_sketch",
                              polar_split.gramfree_sketch_reference),
            mock.patch.object(polar_split, "gramfree_gmul", polar_split.gramfree_gmul_reference))


def large_sweep(mps, xb, yb, factored, plain=False, precision="default"):
    args = (mps, psi_embed(xb), one_hot_labels(yb, L, torch.float32), LR, WD,
            large_cfg(factored, precision))
    if not plain:
        return sweep_once(*args)
    p1, p2 = plain_reductions()
    with p1, p2:
        return sweep_once(*args)


def fresh_accuracy(mps, x, y) -> float:
    scores = mps_forward(mps, psi_embed(x))
    return float((scores.argmax(dim=0) == y).float().mean())


def phase_large_sweep(mps0, xb, yb, x_fresh, y_fresh) -> dict:
    torch.cuda.synchronize()
    reset_counts()
    kern = large_sweep(mps0, xb, yb, "off")
    torch.cuda.synchronize()
    launched = counts()
    if launched["gramfree_sketch"] != STEPS or launched["gramfree_gmul"] != STEPS:
        fail(f"the gram-free M={M_LARGE} sweep launched K4a {launched['gramfree_sketch']} and K4b "
             f"{launched['gramfree_gmul']} times (want {STEPS} each)")
    print(f"[large] sweep with factored_update='off' (gram-free split at I={M_LARGE * D}): "
          f"kernel launches {launched}")
    hold_sweeps("large gram-free", kern, large_sweep(mps0, xb, yb, "off", plain=True), x_fresh)
    fact = large_sweep(mps0, xb, yb, "auto")
    for what, res in (("gram-free", kern), ("factored", fact)):
        if not (torch.isfinite(res[0].sites).all() and torch.isfinite(res[2]).all()):
            fail(f"the {what} M={M_LARGE} sweep left non-finite values")
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    phi = psi_embed(xb)
    fact_out = mps_forward(fact[0], phi)
    batch = rel(kern[2], fact_out)
    fresh = rel(mps_forward(kern[0], psi_embed(x_fresh)), mps_forward(fact[0], psi_embed(x_fresh)))
    acc_g, acc_f = fresh_accuracy(kern[0], x_fresh, y_fresh), fresh_accuracy(fact[0], x_fresh,
                                                                             y_fresh)
    ok = max(batch, fresh) <= QUALITY_F_TOL and abs(acc_g - acc_f) <= QUALITY_ACC_TOL
    print(f"[large] gram-free vs factored sweep: gram-free f_final vs the factored model's "
          f"batch output {batch:.3g}, fresh scores {fresh:.3g} of max|f| (tol "
          f"{QUALITY_F_TOL:g}); accuracy on {len(y_fresh)} fresh requests {acc_g:.4f} vs "
          f"{acc_f:.4f} (tol {QUALITY_ACC_TOL:g}) {'ok' if ok else 'FAIL'}; f_final of the two "
          f"sweeps {rel(kern[2], fact[2]):.3g} apart; carried f_final vs own model's batch output: "
          f"gram-free {rel(kern[2], mps_forward(kern[0], phi)):.3g}, factored "
          f"{rel(fact[2], fact_out):.3g}")
    if not ok:
        fail(f"the gram-free and factored M={M_LARGE} sweeps differ in quality")
    return launched


# ---- phase 15: timing ---------------------------------------------------------

def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 10) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()  # returns numpy: the copy back synchronises
    return (time.perf_counter() - t0) * 1e3 / reps


def turns(name, kern, plain, reps=20, library=None, plain_reps=None):
    """Kernel vs plain in turns (plain, kernel, kernel, plain), with the
    PyTorch-call yardstick, where there is one, in the middle; mean ms of
    each (None for a missing yardstick)."""
    plain_reps = plain_reps or reps
    p1, k1 = cuda_ms(plain, plain_reps), cuda_ms(kern, reps)
    lib = [cuda_ms(library, reps) for _ in range(2)] if library is not None else None
    k2, p2 = cuda_ms(kern, reps), cuda_ms(plain, plain_reps)
    print(f"[timing] {name}: kernel {k1 * 1e3:.1f} / {k2 * 1e3:.1f} us, plain "
          f"{p1 * 1e3:.1f} / {p2 * 1e3:.1f} us"
          + (f", PyTorch call {lib[0] * 1e3:.1f} / {lib[1] * 1e3:.1f} us" if lib else ""))
    return (k1 + k2) / 2, (p1 + p2) / 2, sum(lib) / 2 if lib else None


def bound_ms(flops: float, nbytes: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    """The least time for ``flops`` operations at ``peak`` FLOP/s and
    ``nbytes`` at the HBM rate, in ms, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def tc_bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The bound of a float32 product run in 3xTF32: the tensor part three
    times over at the TF32 rate (the other operations, n2's squares, are a
    rounding of it)."""
    return bound_ms(TC_PASSES * flops, nbytes, TF32_FLOPS)


def k8_bound_ms(I, J, q, pe) -> tuple[float, str]:
    """K8's bound: its K5 stage in 3xTF32 (the tensor part three times over at
    the TF32 rate) and K1's iteration at the float32 rate, one after the
    other, against B and Omega read once and Q written once."""
    t_ops = (TC_PASSES * sketch_work(I, J, q, True)[0] / TF32_FLOPS
             + polar_work(I, q, *pe)[0] / F32_FLOPS)
    t_bytes = polar_split_work(I, J, q, pe)[1] / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def chain_work(n, m, b):
    return 4.0 * n * b * m * m, 4.0 * (n * m * 2 * m + b * n + b * m)


def stack_work(n, m, b):
    """K3's stack form: the chain's FLOPs; the site stack and the embedded
    inputs read once, the env stack (n + 1 slots) written once."""
    return 4.0 * n * b * m * m, 4.0 * (n * m * 2 * m + n * b * 2 + (n + 1) * b * m)


def polar_work(I, q, n_loop, n_final, n_power=1):
    """FLOPs and bytes of K1: per pass W = y^T y and W W (both symmetric, so
    one triangle each) and y P; the prescale Grams (one triangle) and g y; y
    and g read once, Q written once."""
    passes = n_loop * n_power + n_final
    flops = (passes * (gram_flops(q, I) + gram_flops(q, q) + 2.0 * I * q * q)
             + (n_power + 1) * gram_flops(q, I) + n_power * 2.0 * I * I * q)
    return flops, 4.0 * (2 * I * q + I * I)


def step_work(Lb, m, b, pe):
    """FLOPs and bytes of K7 at L=Lb, M=m, B=b: K2's pre-split, K1's
    iteration with the schedules' pass counts ``pe``, Q^T bn and left Q; the
    inputs (Omega and lr, wd included) read once, the outputs written once."""
    I = JC = m * D
    flops = (presplit_work(Lb, I, m, JC, b, m)[0] + polar_work(I, m, *pe)[0]
             + 2.0 * Lb * m * I * JC + 2.0 * b * I * m)
    nbytes = 4.0 * (Lb * I * m + m * JC + 2 * b * D + 2 * b * m + 2 * Lb * b + Lb * JC * m + 2
                    + I * m + Lb * m * JC + b * m + Lb * b + 4)
    return flops, nbytes


def polar_split_work(I, J, q, pe, n_power=1):
    """FLOPs and bytes of K8: K5's y, G and n2, then K1's iteration; B and
    Omega read once, Q written once (R is a product outside the kernel)."""
    flops = sketch_work(I, J, q, True)[0] + polar_work(I, q, *pe, n_power=n_power)[0]
    return flops, 4.0 * (I * J + J * q + I * q)


def presplit_work(Lb, I, Mk, DM, B, q):
    """FLOPs and bytes of K2: the merge, the gradient, f, y and G (one
    triangle) over the Lb label blocks."""
    flops = 2.0 * Lb * I * DM * (Mk + B + q + B) + gram_flops(I, Lb * DM)
    nbytes = 4.0 * (Lb * I * Mk + Mk * DM + 2 * B * D + 2 * B * Mk + 2 * Lb * B
                    + Lb * DM * q + 2  # inputs, lr and wd included
                    + Lb * I * DM + I * q + I * I + Lb * B + B * I + 8)  # outputs
    return flops, nbytes


def device_time_table(fn, timeline: bool = False) -> dict:
    """Device time by kernel name over one call of ``fn`` (torch.profiler).
    A first, empty profile pays the tracer's start-up outside the window.
    With ``timeline`` the device events' intervals come too (from the
    exported trace), since kernels launched with programmatic dependent
    launch overlap: each one's time then counts the wait for its predecessor."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    table = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            table[ev.key] = dev_us / 1e3
    out = {"wall_ms": wall, "by_kernel_ms": table}
    if timeline:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        out["intervals"] = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return out


def union_ms(intervals) -> float:
    """The time covered by (start, end) intervals in us, in ms."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def host_time_line(what, fn) -> None:
    """Host time by PyTorch operator over one call of ``fn`` (torch.profiler,
    CPU only): where the host spends a sweep that leaves the card idle. The
    sweep has run before, so nothing is built or allocated for the first time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda ev: -ev.self_cpu_time_total)
    total = sum(ev.self_cpu_time_total for ev in ops) / 1e3
    print(f"[profile] {what}: host self time {total:.1f} ms in {sum(ev.count for ev in ops)} "
          f"operator calls; top: " + "; ".join(
              f"{ev.key} {ev.self_cpu_time_total / 1e3:.1f} ms / {ev.count}" for ev in ops[:6]))


# the port's kernels -> parts of their CUDA kernels' names in a profile; a
# name counts for the first entry it matches
PROFILE_KERNELS = {
    "K1": ("polar_cluster_kernel", "polar_streaming_kernel"),
    # K2's launches, by namespace: PyTorch's own kernels use some of these
    # names too
    "K2": ("presplit::prep_kernel", "presplit::gradient_kernel", "presplit::update_kernel",
           "presplit::transpose_kernel", "presplit::products_kernel", "presplit::finish_kernel"),
    "K4/K5": ("tc_gemm_kernel", "tc_sketch_gram_kernel", "split_sum_kernel"),
    # K7's own launches (one, two with renorm_envs); its other seven share K2's
    # and K1's names, and K8's launches are K5's and K1's (one source of device
    # code for each)
    "K7": ("step_env_kernel", "step_store_kernel"),
}

# a fused sweep, where no K1 or K2 runs: every launch of these names is K7's
FUSED_PROFILE = {"K7": PROFILE_KERNELS["K2"] + PROFILE_KERNELS["K1"] + PROFILE_KERNELS["K7"]}


# K6's four launches, apart: the tile pass, the scale, the subspace iteration
# on the cluster, R = Q^T B
RF_PROFILE = {"K6 tile pass": ("sketch_tile_kernel",), "K6 scale": ("rf_finish_kernel",),
              "K6 cluster": ("rf_cluster_kernel",), "K6 R": ("rf_r_kernel",)}


# K8's launches in chain order, by the parts of their names; the call's other
# device work (R = Q^T B) comes after them
K8_LAUNCHES = (("tile", "tc_sketch_gram_kernel"), ("sum", "split_sum_kernel"),
               ("K1", "polar_cluster_kernel"), ("K1", "polar_streaming_kernel"))


def k8_by_launch(what, bmat, rank, reps: int = 20) -> None:
    """K8's device time by launch (torch.profiler's timeline over ``reps``
    calls). Its sum and K1's launch are programmatic dependent launches, so
    each one's profiled time counts its wait for its predecessor; the time
    each adds to the device's busy time (the union of the chain's intervals
    up to it, less the union before it) is printed beside it."""
    prof = device_time_table(lambda: [polar_split.polar_split(bmat, rank) for _ in range(reps)],
                             timeline=True)

    def kind(name):
        return next((k for k, p in K8_LAUNCHES if f"::{p}(" in name or f"::{p}<" in name),
                    "other")

    spans = [(kind(n), a, b) for n, a, b in prof["intervals"]]
    order = ("tile", "sum", "K1", "other")
    own, added, before = {}, {}, 0.0
    for i, k in enumerate(order):
        own[k] = sum(b - a for kk, a, b in spans if kk == k) / reps
        upto = union_ms([(a, b) for kk, a, b in spans if kk in order[:i + 1]]) * 1e3 / reps
        added[k], before = upto - before, upto
    print(f"[profile] K8 by launch at {what}, us a call (profiled / added to the busy time): "
          + "; ".join(f"{k} {own[k]:.1f} / {added[k]:.1f}" for k in order)
          + f"; busy {before:.1f} us a call (other: R = Q^T B)")


def k2_by_launch(what, args, kwargs, reps: int = 20) -> None:
    """K2's device time by launch (torch.profiler over ``reps`` calls)."""
    by = device_time_table(lambda: [presplit_kernel.two_site_presplit(*args, **kwargs)
                                    for _ in range(reps)])["by_kernel_ms"]
    mine = {k: v for k, v in by.items() if profile_owner(k, {"K2": PROFILE_KERNELS["K2"]})}
    print(f"[profile] K2 by launch at {what}: " + ", ".join(
        f"{k.split('presplit::')[1].split('(')[0]} {v * 1e3 / reps:.1f} us"
        for k, v in mine.items()) + f"; {sum(mine.values()) * 1e3 / reps:.1f} us a call")


def profile_owner(name: str, groups=PROFILE_KERNELS):
    """The port's kernel that a profiled CUDA kernel belongs to, by its
    demangled name ``(anonymous namespace)::<kernel>(<args>)`` (or
    ``<kernel><template args>(<args>)``), or None."""
    return next((kern for kern, parts in groups.items()
                 if any(f"::{p}(" in name or f"::{p}<" in name for p in parts)), None)


def summarise_profile(engine, prof, wall_ms, groups=PROFILE_KERNELS) -> None:
    """Device time by kernel over one profiled sweep. The idle share is taken
    against the unprofiled sweep's wall time ``wall_ms``: the tracer inflates
    the host side of a sweep of ~30 small launches per step. Where the
    profile holds the timeline, the busy time and each kernel's share are
    the time their intervals cover, since overlapping launches (K7's chain)
    would count twice in a sum."""
    by = prof["by_kernel_ms"]
    top = sorted(by.items(), key=lambda kv: -kv[1])[:5]
    if "intervals" in prof:
        spans = prof["intervals"]
        busy = union_ms([(a, b) for _, a, b in spans])
        ours = {kern: union_ms([(a, b) for n, a, b in spans if profile_owner(n, groups) == kern])
                for kern in groups}
        summed = f"; kernel times sum to {sum(by.values()):.1f} ms"
    else:
        busy = sum(by.values())
        ours = {kern: sum(v for k, v in by.items() if profile_owner(k, groups) == kern)
                for kern in groups}
        summed = ""
    print(f"[profile] {engine} sweep: device busy {busy:.1f} ms of {wall_ms:.1f} ms unprofiled "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}; profiled wall "
          f"{prof['wall_ms']:.1f} ms{summed}); "
          + ", ".join(f"{kern} {v:.1f} ms" for kern, v in ours.items())
          + f", other {busy - sum(ours.values()):.1f} ms; top: "
          + "; ".join(f"{k[:48]} {v:.2f} ms" for k, v in top))
    return ours, busy


def gram_flops(I, J):
    """FLOPs of G = B B^T for B (I, J): one triangle and the diagonal, since G
    is symmetric."""
    return 1.0 * I * (I + 1) * J


def sketch_work(I, J, q, gram):
    """FLOPs and bytes of K4a (gram=False) or K5 (gram=True): B read once,
    Omega read once, y, n2 (and G) written once; the squares of n2 count as
    one FMA per element of B, G as one triangle."""
    flops = 2.0 * I * J * q + 2.0 * I * J + (gram_flops(I, J) if gram else 0.0)
    return flops, 4.0 * (I * J + J * q + I * q + 1 + (I * I if gram else 0))


def gmul_work(I, J, q):
    return 4.0 * I * J * q, 4.0 * (I * J + 2 * I * q)


def rf_work(I, J, q, rank, n_iter=6):
    """FLOPs and bytes of K6: the sketch, the Gram and |B|^2; n_iter products
    with G; n_iter + 1 column normalisations and Householder passes (each
    reflector's dot products and updates, forward and back: 8 (I-j)(q-j)
    at step j); R = Q^T B. G counts as one triangle. B and Omega read once,
    Q and R written once."""
    hqr = sum(8.0 * (I - j) * (q - j) for j in range(q))
    flops = (2.0 * I * J * q + gram_flops(I, J) + 2.0 * I * J + n_iter * 2.0 * I * I * q
             + (n_iter + 1) * (hqr + 3.0 * I * q) + 2.0 * rank * I * J)
    return flops, 4.0 * (I * J + J * q + I * rank + rank * J)


def phase_rangefinder_timing(mps, captured, xb, yb) -> dict:
    """K6 vs its plain version on the card in turns, torch.linalg.qr on K6's
    panel for context, ms per rangefinder sweep, and a profiled sweep."""
    bmat = captured["bmat"]
    I, J = bmat.shape
    q_cols = min(M + 8, I)
    ms = {"rangefinder_split": turns(
        f"rangefinder_split I={I} J={J} q={q_cols} rank={M}",
        lambda: split_kernel.rangefinder_split(bmat, M),
        lambda: split_kernel.rangefinder_split_plain(bmat, M), reps=10, plain_reps=2)}
    panel = torch.randn((I, q_cols), generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    qr_ms = cuda_ms(lambda: torch.linalg.qr(panel), reps=20)
    print(f"[context] torch.linalg.qr of K6's ({I}, {q_cols}) panel on the card: "
          f"{qr_ms * 1e3:.1f} us per call (K6 runs 7 such orthonormalisations and 6 products "
          f"with G one after another; context, not a yardstick)")
    sweep_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rf_sweep(mps, xb, yb)
        torch.cuda.synchronize()
        sweep_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[timing] sweep engine=xla (rangefinder split, K6): {sweep_ms[0]:.1f} / "
          f"{sweep_ms[1]:.1f} ms, {BATCH / (sum(sweep_ms) / 2) * 1e3:.0f} samples/s")
    ms["rf_sweep"] = sum(sweep_ms) / 2
    ours, busy = summarise_profile("rangefinder",
                                   device_time_table(lambda: rf_sweep(mps, xb, yb)),
                                   ms["rf_sweep"], groups=RF_PROFILE)
    k6 = sum(ours.values())
    print(f"[profile] rangefinder sweep: K6's four launches {k6:.1f} ms of {busy:.1f} ms device "
          f"busy ({k6 / busy:.3f}); its cluster launch {ours['K6 cluster']:.1f} ms "
          f"({ours['K6 cluster'] / busy:.3f} of busy, {ours['K6 cluster'] / k6:.3f} of K6), "
          f"its other three {k6 - ours['K6 cluster']:.1f} ms")
    return ms


def phase_large_timing(mps, large, captured, xb, yb) -> dict:
    """K4a, K4b and K5 at M=512 in turns with their plain versions and their
    cuBLAS yardsticks (TF32 off); K5 also at the flagship two-stage shape;
    ms per M=512 sweep on both routes, and a profiled sweep of each."""
    ms = {}
    bmat, om = large["k4a"]
    _, y1 = large["k4b"]
    shape = f"I={bmat.shape[0]} J={bmat.shape[1]} q={M_LARGE}"
    ms["gramfree_sketch"] = turns(
        f"gramfree_sketch {shape}", lambda: polar_split.gramfree_sketch(bmat, om),
        lambda: polar_split.gramfree_sketch_reference(bmat, om), library=lambda: bmat @ om)
    ms["gramfree_gmul"] = turns(
        f"gramfree_gmul {shape}", lambda: polar_split.gramfree_gmul(bmat, y1),
        lambda: polar_split.gramfree_gmul_reference(bmat, y1),
        library=lambda: bmat @ (bmat.T @ y1))
    ms[("polar_sketch_gram", M_LARGE)] = turns(
        f"polar_sketch_gram {shape}", lambda: polar_split.polar_sketch_gram(bmat, om),
        lambda: polar_split.polar_sketch_gram_reference(bmat, om),
        library=lambda: (bmat @ om, bmat @ bmat.T))
    b128, om128 = flagship_sketch_inputs(captured)
    ms["polar_sketch_gram"] = turns(
        f"polar_sketch_gram I={b128.shape[0]} J={b128.shape[1]} q={M} (flagship two-stage)",
        lambda: polar_split.polar_sketch_gram(b128, om128),
        lambda: polar_split.polar_sketch_gram_reference(b128, om128),
        library=lambda: (b128 @ om128, b128 @ b128.T))
    if "polar_sketch" in OTHER:
        ms.update(other_sketch_turns(bmat, om, y1, b128, om128, shape))

    sweep_ms = {}
    for route in ("auto", "off", "off", "auto"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        large_sweep(mps, xb, yb, route)
        torch.cuda.synchronize()
        sweep_ms.setdefault(route, []).append((time.perf_counter() - t0) * 1e3)
    names = {"auto": "factored", "off": "gram-free"}
    for route, v in sweep_ms.items():
        print(f"[timing] M={M_LARGE} sweep, {names[route]} route (factored_update='{route}'): "
              f"{v[0]:.1f} / {v[1]:.1f} ms, {BATCH / (sum(v) / 2) * 1e3:.0f} samples/s")
    ms["large_sweep"] = {names[k]: sum(v) / 2 for k, v in sweep_ms.items()}
    for route in ("auto", "off"):
        ours, busy = summarise_profile(
            f"M={M_LARGE} {names[route]}",
            device_time_table(lambda: large_sweep(mps, xb, yb, route)),
            ms["large_sweep"][names[route]])
        if route == "off":
            print(f"[profile] M={M_LARGE} gram-free sweep: K4a + K4b {ours['K4/K5']:.1f} ms of "
                  f"{busy:.1f} ms device busy on the tensor cores in 3xTF32, against 231.2 ms "
                  f"of 721.8 ms with the float32 FMA tiles (H100 80GB HBM3, 700 W; PERF.md section 5)")
        host_time_line(f"M={M_LARGE} {names[route]} sweep",
                       lambda: large_sweep(mps, xb, yb, route))
    return ms


def other_sketch_turns(bmat, om, y1, b128, om128, shape) -> dict:
    """K4a and K4b (both forms) on the M=512 step's inputs and K5 at the
    flagship and M=512 shapes, with the other build of polar_sketch.cu and
    this one in turns. The 3xTF32 forms and K5, whose code this build shares
    with the other, must give its bits; the one-pass forms are timed only.
    The other build's mean ms by key ("parent", kernel)."""
    flag = f"I={b128.shape[0]} J={b128.shape[1]} q={M} (flagship two-stage)"
    cases = (
        ("gramfree_sketch", f"gramfree_sketch {shape}", True,
         lambda: polar_split.gramfree_sketch(bmat, om)),
        ("gramfree_gmul", f"gramfree_gmul {shape}", True,
         lambda: polar_split.gramfree_gmul(bmat, y1)),
        ("gramfree_sketch_tf32", f"gramfree_sketch_tf32 {shape}", False,
         lambda: polar_split.gramfree_sketch_tf32(bmat, om)),
        ("gramfree_gmul_tf32", f"gramfree_gmul_tf32 {shape}", False,
         lambda: polar_split.gramfree_gmul_tf32(bmat, y1)),
        (("polar_sketch_gram", M_LARGE), f"polar_sketch_gram {shape}", True,
         lambda: polar_split.polar_sketch_gram(bmat, om)),
        ("polar_sketch_gram", f"polar_sketch_gram {flag}", True,
         lambda: polar_split.polar_sketch_gram(b128, om128)))
    out, held = {}, []
    for key, what, same, fn in cases:
        if same:
            ours = fn()
            with using_other("polar_sketch"):
                theirs = fn()
            torch.cuda.synchronize()
            ours = ours if isinstance(ours, tuple) else (ours,)
            theirs = theirs if isinstance(theirs, tuple) else (theirs,)
            if not all(same_bits(a, b) for a, b in zip(ours, theirs)):
                fail(f"{what}: not the other build's ({OTHER_CSRC}) bits")
            held.append(what)
        out[("parent", key)] = other_build_turns(what, "polar_sketch", fn, 20)
    print(f"[kernel] bit for bit the other build's ({OTHER_CSRC}): " + "; ".join(held))
    return out


def phase_wide_timing(wide, xb, yb, cap) -> dict:
    """K2 (I = 512) and K1 (I = 512, q = 256) on the captured M=256 step in
    turns with their plain versions, and K2's device time by launch; ms per
    sweep at M=256 on the hybrid and the xla engine (in turns), and a
    profiled hybrid sweep: its device busy time and idle share."""
    args, kwargs = cap["k2"]
    k2 = turns(f"two_site_presplit L={L} I={M_WIDE * D} DM={D * M_WIDE} B={BATCH} q={M_WIDE} "
               f"(M={M_WIDE} step {CAPTURE_STEP})",
               lambda: presplit_kernel.two_site_presplit(*args, **kwargs),
               lambda: presplit_kernel.two_site_presplit_reference(*args, **kwargs))
    k2_by_launch(f"M={M_WIDE} step {CAPTURE_STEP}", args, kwargs)
    y0, g, n2 = cap["k1"]
    shape = f"I={y0.shape[0]} q={y0.shape[1]}"
    k1 = turns(f"polar_iterate {shape} (M={M_WIDE} step {CAPTURE_STEP})",
               lambda: polar_split.polar_iterate(y0, g, n2),
               lambda: polar_split.polar_iterate_reference(y0, g, n2), reps=10)
    bmat = cap["bmat"]
    k8_what = f"polar_split I={bmat.shape[0]} J={bmat.shape[1]} q={M_WIDE} (M={M_WIDE} step " \
              f"{CAPTURE_STEP})"
    out = {("polar_split", M_WIDE): turns(
        k8_what, lambda: polar_split.polar_split(bmat, M_WIDE),
        lambda: polar_split.polar_split_reference(bmat, M_WIDE), reps=10)}
    k8_by_launch(f"M={M_WIDE} step {CAPTURE_STEP}", bmat, M_WIDE)
    if "polar_iterate" in OTHER:
        out[("parent", ("polar_split", M_WIDE))] = other_build_turns(
            k8_what, "polar_iterate", lambda: polar_split.polar_split(bmat, M_WIDE), 10)
    two = cuda_ms(lambda: polar_split.polar_split_two_stage(bmat, M_WIDE), 10)
    print(f"[context] polar_split_two_stage (K5, K1 and R) at M={M_WIDE} {two * 1e3:.1f} us "
          f"beside K8 (context, not a yardstick)")
    sweep_ms = {}
    for engine in ("xla", "hybrid", "hybrid", "xla"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_sweep(wide, xb, yb, engine)
        torch.cuda.synchronize()
        sweep_ms.setdefault(engine, []).append((time.perf_counter() - t0) * 1e3)
    for engine, v in sweep_ms.items():
        print(f"[timing] M={M_WIDE} sweep engine={engine} (polar split): {v[0]:.1f} / "
              f"{v[1]:.1f} ms, {BATCH / (sum(v) / 2) * 1e3:.0f} samples/s")
    wide_ms = {k: sum(v) / 2 for k, v in sweep_ms.items()}
    summarise_profile(f"M={M_WIDE} hybrid",
                      device_time_table(lambda: one_sweep(wide, xb, yb, "hybrid")),
                      wide_ms["hybrid"])
    return {"wide_sweep": wide_ms, ("polar_iterate", M_WIDE): k1,
            ("two_site_presplit", M_WIDE): k2, **out}


def phase_timing(mps, requests, x_big, captured, x_tr, y_tr) -> dict:
    """Kernel vs plain in turns at the main path's shapes. The site stack
    stays warm in L2 between launches, as it does for a server under steady
    traffic and for consecutive steps of a sweep."""
    ms = {}
    sites = mps.sites[1:]
    other = OTHER.get("env_scan")
    for B in (BATCH, BIG):
        x = x_big[:B, 1:]
        ms[("right_env_chain", B)] = turns(
            f"right_env_chain B={B} ({chain_form(M, B)})",
            lambda: env_scan.right_env_chain(sites, x),
            lambda: env_scan.right_env_chain_reference(sites, x))
        if other is not None:
            ms[("parent", B)] = other_turns(other, sites, x, B)
    for m_, (st, phi) in stack_inputs(mps, x_big[:BATCH]).items():
        ms[("right_env_stack_chain", m_)] = turns(
            f"right_env_stack_chain N={N} M={m_} B={BATCH} ({chain_form(m_, BATCH)})",
            lambda: env_scan.right_env_stack_chain(st, phi),
            lambda: env_scan.right_env_stack_reference(st, phi), plain_reps=5)
    args, kwargs = captured["k2"]
    ms["two_site_presplit"] = turns(
        f"two_site_presplit L={L} I={M * D} DM={D * M} B={BATCH} q={M}",
        lambda: presplit_kernel.two_site_presplit(*args, **kwargs),
        lambda: presplit_kernel.two_site_presplit_reference(*args, **kwargs))
    k2_by_launch(f"flagship step {CAPTURE_STEP}", args, kwargs)
    y0, g, n2 = captured["k1"]
    ms["polar_iterate"] = turns(
        f"polar_iterate I={M * D} q={M}", lambda: polar_split.polar_iterate(y0, g, n2),
        lambda: polar_split.polar_iterate_reference(y0, g, n2), reps=10)
    sargs = step_args(captured)
    ms["two_site_step"] = turns(
        f"two_site_step L={L} M={M} B={BATCH}", lambda: step_kernel.two_site_step(*sargs),
        lambda: step_kernel.two_site_step_reference(*sargs), reps=10)
    bmat = captured["bmat"]
    ms["polar_split"] = turns(
        f"polar_split I={bmat.shape[0]} J={bmat.shape[1]} q={M}",
        lambda: polar_split.polar_split(bmat, M),
        lambda: polar_split.polar_split_reference(bmat, M), reps=10)
    k8_by_launch(f"flagship step {CAPTURE_STEP}", bmat, M)
    wide_name, wide_args, wide_kw = step_cases(captured)[3]
    ms["two_site_step_wide"] = cuda_ms(lambda: step_kernel.two_site_step(*wide_args, **wide_kw),
                                       10)
    print(f"[timing] two_site_step {wide_name}: kernel {ms['two_site_step_wide'] * 1e3:.1f} us")
    if OTHER:  # this build beside the other one, in turns
        for key, source, what, fn, reps in (
                ("two_site_step", "two_site_step", f"two_site_step L={L} M={M} B={BATCH}",
                 lambda: step_kernel.two_site_step(*sargs), 10),
                ("two_site_step_wide", "two_site_step", f"two_site_step {wide_name}",
                 lambda: step_kernel.two_site_step(*wide_args, **wide_kw), 10),
                ("two_site_presplit", "presplit", "two_site_presplit",
                 lambda: presplit_kernel.two_site_presplit(*args, **kwargs), 20),
                ("polar_iterate", "polar_iterate", "polar_iterate",
                 lambda: polar_split.polar_iterate(y0, g, n2), 10),
                ("polar_split", "polar_iterate", "polar_split",
                 lambda: polar_split.polar_split(bmat, M), 10)):
            ms[("parent", key)] = other_build_turns(what, source, fn, reps)

    def hybrid_step():  # what the hybrid engine runs per step: K2, K1, two products
        bnew, y, gr, _, left_part, stats = presplit_kernel.two_site_presplit(*args, **kwargs)
        qf = polar_split.polar_iterate(y, gr, stats[0, 2].reshape(1, 1))
        return qf.T @ bnew, left_part @ qf

    ctx = [cuda_ms(hybrid_step, 10),
           cuda_ms(lambda: polar_split.polar_split_two_stage(bmat, M), 10)]
    print(f"[context] the hybrid engine's step (K2, K1, R and the left environment as two "
          f"products) {ctx[0] * 1e3:.1f} us beside K7; polar_split_two_stage (K5, K1 and R) "
          f"{ctx[1] * 1e3:.1f} us beside K8 (context, not yardsticks)")

    xb = torch.as_tensor(x_tr[:BATCH], device=DEVICE)
    yb = torch.as_tensor(y_tr[:BATCH], device=DEVICE)
    sweep_ms = {}
    for engine in ("xla", "hybrid", "fused", "fused", "hybrid", "xla"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_sweep(mps, xb, yb, engine)
        torch.cuda.synchronize()
        sweep_ms.setdefault(engine, []).append((time.perf_counter() - t0) * 1e3)
    for engine, v in sweep_ms.items():
        print(f"[timing] sweep engine={engine} (polar split): {v[0]:.1f} / {v[1]:.1f} ms, "
              f"{BATCH / (sum(v) / 2) * 1e3:.0f} samples/s")
    ms["sweep"] = {k: sum(v) / 2 for k, v in sweep_ms.items()}
    idle = {}
    for engine in ("xla", "hybrid", "fused"):
        _, busy = summarise_profile(
            engine, device_time_table(lambda: one_sweep(mps, xb, yb, engine), timeline=True),
            ms["sweep"][engine], groups=FUSED_PROFILE if engine == "fused" else PROFILE_KERNELS)
        idle[engine] = max(0.0, 1 - busy / ms["sweep"][engine])
    print("[timing] sweeps at M=128, B=256: " + ", ".join(
        f"{engine} {ms['sweep'][engine]:.1f} ms (idle share {idle[engine]:.3f})"
        for engine in ("fused", "hybrid", "xla")))

    for B in (BATCH, BIG):
        for use_kernel in (True, False):
            pred = Predictor(mps, batch_size=B, use_kernel=use_kernel)
            t = host_ms(lambda: pred.scores(requests[:B]))
            print(f"[timing] Predictor.scores B={B} {'kernel' if use_kernel else 'plain'}: "
                  f"{t:.3f} ms/batch, {B / t * 1e3:.0f} samples/s")
            if use_kernel:
                profile_batch(pred, requests[:B], t)
    return ms


def profile_batch(pred, requests, wall_ms) -> None:
    """Device time of one Predictor.scores batch by kernel: K3's, the rest
    (the label closure, chain_scores, and the copies), and the idle share
    against the unprofiled batch time ``wall_ms``."""
    by = device_time_table(lambda: pred.scores(requests))["by_kernel_ms"]
    k3 = sum(v for k, v in by.items() if "chain_kernel" in k)
    busy = sum(by.values())
    top = sorted(((k, v) for k, v in by.items() if "chain_kernel" not in k), key=lambda kv: -kv[1])
    print(f"[profile] Predictor.scores B={pred.batch_size}: device busy {busy:.3f} ms of "
          f"{wall_ms:.3f} ms unprofiled (idle share {max(0.0, 1 - busy / wall_ms):.3f}); "
          f"K3 {k3:.3f} ms, other {busy - k3:.3f} ms: "
          + "; ".join(f"{k[:40]} {v * 1e3:.1f} us" for k, v in top[:5]))


def other_build_turns(what, source, fn, reps) -> float:
    """``fn`` with the other build's library of ``source`` and with this
    build's, in turns (other, this, this, other); the other's mean ms."""
    def run(other):
        if other:
            with using_other(source):
                return cuda_ms(fn, reps)
        return cuda_ms(fn, reps)

    o1, t1, t2, o2 = run(True), run(False), run(False), run(True)
    print(f"[timing] {what}: this build {t1 * 1e3:.1f} / {t2 * 1e3:.1f} us, the other build's "
          f"{o1 * 1e3:.1f} / {o2 * 1e3:.1f} us (in turns)")
    return (o1 + o2) / 2


def other_turns(lib, sites, x, B) -> float:
    """The other build's K3 and this one in turns (other, this, this, other);
    the other's mean ms, after checking that it gives this K3's function."""
    n, m = sites.shape[0], sites.shape[1]

    def run():
        out = torch.empty((B, m), dtype=torch.float32, device=DEVICE)
        err = lib.tnml_right_env_chain(sites.data_ptr(), x.data_ptr(), x.stride(0),
                                       out.data_ptr(), n, m, B,
                                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"the other build's K3 failed: cudaError {err}")
        return out

    gap = float((run() - env_scan.right_env_chain(sites, x)).abs().max())
    this = lambda: env_scan.right_env_chain(sites, x)  # noqa: E731
    o1, t1, t2, o2 = cuda_ms(run), cuda_ms(this), cuda_ms(this), cuda_ms(run)
    print(f"[timing] right_env_chain B={B}: this K3 {t1 * 1e3:.1f} / {t2 * 1e3:.1f} us, the "
          f"other build's {o1 * 1e3:.1f} / {o2 * 1e3:.1f} us (in turns; outputs "
          f"{gap:.3g} apart)")
    return (o1 + o2) / 2


# ---- phases 16-19: the boundary-label family, autodiff and the ensemble ----------

def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|, in float64."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@contextlib.contextmanager
def saved_boundary_models():
    """Within the block, every model ``save_boundary_checkpoint`` writes is
    kept, in order."""
    models = []
    real = ckpt_mod.save_boundary_checkpoint

    def keep(model, path):
        models.append(model)
        real(model, path)

    with mock.patch.object(ckpt_mod, "save_boundary_checkpoint", keep):
        yield models


@contextlib.contextmanager
def finite_layers(seen: dict):
    """Within the block, every brick layer's sites must come out finite:
    torch.linalg.cholesky_ex checks no pivot, so a failed factorisation would
    turn a layer to NaN silently."""
    real = brick_mod._brick_layer

    @functools.wraps(real)
    def checked(sites, *args, **kwargs):
        out, metrics = real(sites, *args, **kwargs)
        seen["layers"] += 1
        if not bool(torch.isfinite(out).all()):
            fail(f"brick layer {seen['layers']} (parity {args[5]}) came out non-finite")
        return out, metrics

    with mock.patch.object(brick_mod, "_brick_layer", checked):
        yield


def profile_line(what, fn, wall_ms) -> float:
    """Device busy time (the union of kernel intervals) of one call of ``fn``,
    its idle share against ``wall_ms`` and its largest kernels; the idle share."""
    table = device_time_table(fn, timeline=True)
    busy = union_ms([(a, b) for _, a, b in table["intervals"]])
    idle = max(0.0, 1 - busy / wall_ms)
    top = sorted(table["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:4]
    print(f"[profile] {what}: device busy {busy:.2f} ms of {wall_ms:.2f} ms unprofiled (idle "
          f"share {idle:.3f}), {len(table['intervals'])} device events; "
          + "; ".join(f"{k[:40]} {v:.2f} ms" for k, v in top))
    return idle


def phase_boundary_cli(trainer: str, x_fresh) -> dict:
    """cli/training_mnist.py --trainer brickwall|onesite at the flagship on its
    default device (the card): no kernel launches, every brick layer finite,
    the saved model reloaded by Predictor.from_checkpoint scoring bit for bit
    as the model in memory, and load_any_checkpoint giving a BoundaryMPS."""
    module, name = ((brick_mod, "train_brickwall") if trainer == "brickwall"
                    else (onesite_mod, "train_boundary_model"))
    real = getattr(module, name)
    timed = {}

    @functools.wraps(real)
    def timed_train(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        timed["seconds"] = time.perf_counter() - t0
        timed["batches"] = len(args[1])
        return out

    seen = {"layers": 0}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"{trainer}.npz")
        argv = ["--synthetic", "--pool", "--M", str(M), "--trainer", trainer, "--n_epochs", "1"]
        if trainer == "brickwall":
            argv += ["--svd_method", "cholqr"]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with saved_boundary_models() as saved, mock.patch.object(module, name, timed_train), \
                finite_layers(seen):
            val_acc, test_acc = cli_mnist.main(argv + ["--out", out])
        main_s = time.perf_counter() - t0
        launched = counts()
        model = saved[0]
        loaded = load_any_checkpoint(out)  # the default device: the card
        in_memory = Predictor(model)
        from_file = Predictor.from_checkpoint(out)
        got, want = from_file.scores(x_fresh), in_memory.scores(x_fresh)
    batches = timed["batches"]
    ms_batch = timed["seconds"] / batches * 1e3
    same = np.array_equal(got, want)
    layers = f", {seen['layers']} brick layers, each finite" if trainer == "brickwall" else ""
    print(f"[{trainer}] training_mnist {' '.join(argv)} on the default device "
          f"({model.device}): {batches} batches of {CLI_BATCH}, {ms_batch:.1f} ms/batch "
          f"(validation included; {main_s:.2f} s for the whole command){layers}; val acc "
          f"{val_acc[-1]:.4f}, test acc {test_acc:.4f}; kernel launches {sum(launched.values())}; "
          f"Predictor.from_checkpoint ({from_file.device}) scores {len(x_fresh)} fresh requests "
          f"as the model in memory bit for bit: {same}; load_any_checkpoint gives "
          f"{type(loaded).__name__} on {loaded.device}")
    if sum(launched.values()):
        fail(f"the {trainer} CLI launched kernels: {launched}")
    if not isinstance(model, BoundaryMPS) or model.device.type != "cuda" or model.M != M or not (
            torch.isfinite(model.sites).all() and torch.isfinite(model.w).all()):
        fail(f"the {trainer} CLI's model is not a finite M={M} BoundaryMPS on the card")
    if trainer == "brickwall" and seen["layers"] != 2 * batches:
        fail(f"the brick-wall CLI ran {seen['layers']} layers in {batches} batches")
    if not same or from_file.device.type != "cuda" or from_file.use_kernel:
        fail(f"the {trainer} model does not reload to the same scores on the card")
    if not isinstance(loaded, BoundaryMPS) or loaded.device.type != "cuda":
        fail(f"load_any_checkpoint gave {type(loaded).__name__} on {loaded.device}")
    return {"model": model, "ms_per_batch": ms_batch, "val_acc": val_acc[-1],
            "test_acc": test_acc, "batches": batches}


def boundary_init(n_sites, m, x_cal):
    return cli_mnist.initial_boundary(SEED, n_sites, m, "linear", "MSE", x_cal, DEVICE)


def as_f64(model: BoundaryMPS) -> BoundaryMPS:
    return model.replace(sites=model.sites.double(), w=model.w.double())


def hold_f64(phase, what, sweep, model, phi, y1h, x_fresh, tol, f32_ridge=False) -> dict:
    """``sweep(model, phi, y1h)`` in float32 against a float64 run of it, on
    ``x_fresh``'s scores relative to max|f|; beside it the float32 and float64
    runs on the model with ``w`` rescaled by 1 + RF_PERTURB (the rounding
    floors) and how far the sweep moves the function. With ``f32_ridge`` the
    float64 run takes the float32 path's Cholesky ridge."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    a = sweep(model, phi, y1h)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = counts()
    ridge = svd_mod._cholqr_eps
    with (mock.patch.object(svd_mod, "_cholqr_eps", lambda dtype, q: ridge(torch.float32, q))
          if f32_ridge else contextlib.nullcontext()):
        b = sweep(as_f64(model), phi.double(), y1h.double())
        d = sweep(as_f64(model).replace(w=model.w.double() * (1 + RF_PERTURB)), phi.double(),
                  y1h.double())
    c = sweep(model.replace(w=model.w * (1 + RF_PERTURB)), phi, y1h)
    pf = psi_embed(x_fresh)
    fa, fc = boundary_forward(a, pf), boundary_forward(c, pf)
    fb, fd = boundary_forward(b, pf.double()), boundary_forward(d, pf.double())
    gap, moved = rel_gap(fa, fb), rel_gap(boundary_forward(model, pf), fb)
    extra = ""
    if f32_ridge:
        own = sweep(as_f64(model), phi.double(), y1h.double())
        extra = (f"; against a float64 run with its own ridge "
                 f"{rel_gap(fa, boundary_forward(own, pf.double())):.3g} (printed, not held)")
    ok = gap <= tol and bool(torch.isfinite(fa).all()) and a.device.type == phi.device.type
    print(f"[{phase}] {what}: float32 sweep {ms:.1f} ms; against its float64 run {gap:.3g} of max|f| "
          f"(limit {tol:g}) {'ok' if ok else 'FAIL'}; float32 vs float32 on w x (1 + "
          f"{RF_PERTURB:g}) {rel_gap(fc, fa):.3g}, float64 vs float64 {rel_gap(fd, fb):.3g}; the "
          f"sweep moves f by {moved:.3g} of max|f|{extra}; kernel launches "
          f"{sum(launched.values())}")
    if sum(launched.values()):
        fail(f"{what}: the sweep launched kernels: {launched}")
    if not ok:
        fail(f"{what}: the float32 sweep is {gap:.3g} of max|f| from its float64 run")
    return {"ms": ms, "gap": gap, "model": a}


def card_batch(x: np.ndarray, y: np.ndarray):
    xb = torch.as_tensor(x, device=DEVICE)
    return psi_embed(xb), one_hot_labels(torch.as_tensor(y, device=DEVICE), L, torch.float32)


def phase_brickwall(x_tr, y_tr, x_fresh) -> dict:
    """[brickwall]: the CLI, then one flagship brick sweep (cholqr, the CLI's
    rate) held against its float64 run, and its device profile."""
    cli = phase_boundary_cli("brickwall", x_fresh)
    model = boundary_init(N, M, x_tr[:BATCH])
    phi, y1h = card_batch(x_tr[:CLI_BATCH], y_tr[:CLI_BATCH])
    cfg = brick_mod.BrickConfig(split_method="cholqr")

    def sweep(m, p, y):
        return brick_mod.brick_sweep(m, p, y, BRICK_LR, WD, cfg)[0]

    seen = {"layers": 0}
    with finite_layers(seen):
        held = hold_f64("brickwall", f"brick sweep N={N} M={M} B={CLI_BATCH} K={N // 2}", sweep,
                        model, phi, y1h, x_fresh, BRICK_F64_TOL, f32_ridge=True)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep(model, phi, y1h)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    idle = profile_line(f"brick sweep N={N} M={M} B={CLI_BATCH}", lambda: sweep(model, phi, y1h),
                        ms)
    print(f"[brickwall] brick sweep at the flagship: {ms:.1f} ms (median of "
          f"{', '.join(f'{t:.1f}' for t in times)}), {CLI_BATCH / ms * 1e3:.0f} samples/s")
    return {**cli, "sweep_ms": ms, "idle": idle, "gap": held["gap"],
            "held_inputs": (model, phi, y1h, x_fresh)}


def phase_onesite(x_tr, y_tr, x_fresh) -> dict:
    """[onesite]: the CLI, a flagship one-site sweep's time and profile, then
    one sweep at N=784, M=16 with renorm (example 04's long chain) held
    against its float64 run."""
    cli = phase_boundary_cli("onesite", x_fresh)
    model = boundary_init(N, M, x_tr[:BATCH])
    phi, y1h = card_batch(x_tr[:CLI_BATCH], y_tr[:CLI_BATCH])
    cfg = onesite_mod.OneSiteConfig()

    def flagship(left):
        return onesite_mod.onesite_sweep(model, phi, y1h, 0.2, WD, left, cfg)

    times = []
    for left in (False, True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flagship(left)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    idle = profile_line(f"one-site sweep N={N} M={M} B={CLI_BATCH}", lambda: flagship(False), ms)
    print(f"[onesite] one-site sweep at the flagship (right, left, right, left): "
          f"{', '.join(f'{t:.1f}' for t in times)} ms, {CLI_BATCH / ms * 1e3:.0f} samples/s")

    imgs, labels, _, _ = synthetic_mnist(n_train=2 * CLI_BATCH + BATCH, n_test=0, seed=SEED + 5)
    x_full = (imgs / 255.0).reshape(len(imgs), -1).astype(np.float32)
    if x_full.shape[1] != ONESITE_LONG_N:
        fail(f"full-resolution images have {x_full.shape[1]} pixels")
    long_model = boundary_init(ONESITE_LONG_N, ONESITE_LONG_M, x_full[:BATCH])
    phi_l, y1h_l = card_batch(x_full[:CLI_BATCH], labels[:CLI_BATCH].astype(np.int64))
    long_cfg = onesite_mod.OneSiteConfig(renorm=True)

    def sweep(m, p, y):
        return onesite_mod.onesite_sweep(m, p, y, ONESITE_LONG_LR, WD, False, long_cfg)[0]

    x_long_fresh = torch.as_tensor(x_full[CLI_BATCH:CLI_BATCH + BATCH], device=DEVICE)
    held = hold_f64("onesite", f"one-site sweep N={ONESITE_LONG_N} M={ONESITE_LONG_M} "
                    f"B={CLI_BATCH} renorm",
                    sweep, long_model, phi_l, y1h_l, x_long_fresh, ONESITE_F64_TOL)
    return {**cli, "sweep_ms": ms, "idle": idle, "long_ms": held["ms"], "gap": held["gap"],
            "held_inputs": (long_model, phi_l, y1h_l, x_long_fresh)}


def phase_autodiff(mps, brick_model, x_tr, y_tr) -> dict:
    """[autodiff]: AD_STEPS Adam steps of AutodiffTrainer on the flagship MPS,
    the first held against a float64 run of it; one BoundaryAutodiffTrainer
    step on the brick-wall CLI's model; one ring_trainer step at the
    flagship's width. No kernel launches (the chain kernel has no backward)."""
    cfg = AutodiffConfig(loss="softmax_xent", optimizer="adam", learning_rate=AD_LR)
    batches = [(x_tr[i * BATCH:(i + 1) * BATCH], y_tr[i * BATCH:(i + 1) * BATCH])
               for i in range(AD_STEPS)]
    torch.cuda.synchronize()
    reset_counts()
    trainer = AutodiffTrainer(mps, cfg)
    losses, times = [], []
    for i, (x, y) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.step(x, y)[0])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = [p.detach().clone() for p in trainer.params]
            grads = [p.grad.detach().clone() for p in trainer.params]
    t64 = AutodiffTrainer(mps.replace(sites=mps.sites.double(),
                                      label_site=mps.label_site.double()), cfg)
    loss64 = t64.step(*batches[0])[0]
    loss_gap = abs(losses[0] - loss64) / abs(loss64)
    grad_gap = max(rel_gap(g, p.grad) for g, p in zip(grads, t64.params))
    param_gap = max(rel_gap(a, b) for a, b in zip(first, t64.params))
    moved = rel_gap(t64.params[0], mps.sites.double())
    ok = (loss_gap <= AD_LOSS_TOL and grad_gap <= AD_GRAD_TOL and param_gap <= AD_PARAM_TOL
          and np.isfinite(losses).all() and trainer.params[0].device.type == "cuda")
    print(f"[autodiff] AutodiffTrainer (softmax_xent, Adam, lr {AD_LR:g}) N={N} M={M} B={BATCH} on "
          f"{trainer.params[0].device}: {AD_STEPS} steps "
          f"{', '.join(f'{t:.1f}' for t in times)} ms, losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}; the first step against its float64 run: "
          f"loss {loss_gap:.3g} (limit {AD_LOSS_TOL:g}), gradients {grad_gap:.3g} of their max "
          f"(limit {AD_GRAD_TOL:g}), updated tensors {param_gap:.3g} of their max (limit "
          f"{AD_PARAM_TOL:g}; the step moves the sites by {moved:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the autodiff step on the card disagrees with its float64 run")

    bt = BoundaryAutodiffTrainer(brick_model, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b_loss = bt.step(*batches[0])[0]
    torch.cuda.synchronize()
    b_ms = (time.perf_counter() - t0) * 1e3
    ring = ring_product_init(torch.Generator().manual_seed(SEED), N=N, M=M, D=D, L=L,
                             calibration_x=x_tr[:BATCH])  # the default device: the card
    rt = ring_trainer(ring, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_loss = rt.step(*batches[0])[0]
    torch.cuda.synchronize()
    r_ms = (time.perf_counter() - t0) * 1e3
    launched = counts()
    finite = all(bool(torch.isfinite(p).all()) for p in bt.params + rt.params)
    print(f"[autodiff] BoundaryAutodiffTrainer step on the brick-wall model: loss {b_loss:.5f}, "
          f"{b_ms:.1f} ms; ring_trainer step (N={N} M={M}, ring_product_init on "
          f"{ring.device}): loss {r_loss:.5f}, {r_ms:.1f} ms; parameters finite: {finite}; "
          f"kernel launches {sum(launched.values())}")
    if (sum(launched.values()) or not finite or not np.isfinite([b_loss, r_loss]).all()
            or ring.device.type != "cuda" or bt.params[0].device.type != "cuda"):
        fail(f"the boundary or ring autodiff step failed (launches {launched})")
    return {"step_ms": float(np.median(times)), "boundary_ms": b_ms, "ring_ms": r_ms}


def phase_ensemble(task) -> dict:
    """[ensemble]: ensemble_init on the teacher task, ENS_STEPS Adam steps on
    the card; to_direct_sum served by Predictor through K3 at M = L * ENS_M,
    held against ensemble_forward and K3 against its plain version; probe_init
    on the same task, its argmax the probe's exactly."""
    tr_x, tr_y, te_x, te_y = task
    ens = ensemble_mod.ensemble_init(torch.Generator().manual_seed(SEED), N=N, m=ENS_M, L=L,
                                     calibration_x=tr_x[:BATCH])  # the default device
    if ens.device.type != "cuda":
        fail(f"ensemble_init placed the ensemble on {ens.device}")
    leaves = {k: getattr(ens, k).clone().requires_grad_(True)
              for k in ("sites", "label_site", "head_a")}  # head_b stays 0
    opt = torch.optim.Adam(list(leaves.values()), lr=ENS_LR)
    phi_tr = psi_embed(torch.as_tensor(tr_x, device=DEVICE, dtype=torch.float32))
    y_tr = torch.as_tensor(tr_y, device=DEVICE).long()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    losses = []
    for step in range(ENS_STEPS):
        lo = (step * ENS_BATCH) % (len(tr_x) - ENS_BATCH + 1)
        f = ensemble_mod.ensemble_forward(ens.replace(**leaves), phi_tr[lo:lo + ENS_BATCH])
        loss = torch.nn.functional.cross_entropy(f.T, y_tr[lo:lo + ENS_BATCH])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / ENS_STEPS
    train_launched = counts()
    trained = ens.replace(**{k: v.detach() for k, v in leaves.items()})
    phi_te = psi_embed(torch.as_tensor(te_x, device=DEVICE, dtype=torch.float32))
    y_te = torch.as_tensor(te_y, device=DEVICE).long()
    acc = float(ensemble_mod.ensemble_accuracy(trained, phi_te, y_te))
    print(f"[ensemble] ensemble_init N={N} L={L} m={ENS_M} on {ens.device}, {ENS_STEPS} Adam "
          f"steps (lr {ENS_LR:g}, B={ENS_BATCH}) on the teacher task: {step_ms:.1f} ms a step, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, test acc {acc:.4f}; kernel launches "
          f"{sum(train_launched.values())}")
    if sum(train_launched.values()) or not np.isfinite(losses).all():
        fail(f"the ensemble's training launched {train_launched} or went non-finite")

    mono = ensemble_mod.to_direct_sum(trained)
    m_sum = mono.M
    pred = Predictor(mono)  # the default device: the card, through K3
    if mono.device.type != "cuda" or m_sum != L * ENS_M or not pred.use_kernel:
        fail(f"the direct sum (M={m_sum}) is not served on the card through the kernel")
    reset_counts()
    served = pred.scores(te_x)
    launched = counts()
    want = -(-len(te_x) // BATCH)
    f_ens = ensemble_mod.ensemble_forward(trained, phi_te).T.cpu().numpy()
    err = float(np.abs(served - f_ens).max())
    tol = TOL * float(np.abs(f_ens).max())
    ok = (launched["right_env_chain"] == want and sum(launched.values()) == want
          and served.shape == (len(te_x), L) and err <= tol)
    print(f"[ensemble] to_direct_sum: an MPS with M={m_sum} on {mono.device}; Predictor at batch "
          f"{BATCH} ({chain_form(m_sum, BATCH)}) scores the {len(te_x)} test samples through K3: "
          f"launches {launched['right_env_chain']} (want {want}); against ensemble_forward "
          f"{err:.3g} (limit {tol:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the direct sum served through K3 disagrees or launched {launched}")
    sites = mono.sites[1:].contiguous()
    x = torch.as_tensor(te_x[:BATCH], device=DEVICE, dtype=torch.float32)[:, 1:].contiguous()
    k3_err = compare_chain(f"ensemble direct sum n={N - 1} M={m_sum} B={BATCH}", sites, x)
    k_ms, p_ms, _ = turns(f"right_env_chain M={m_sum} B={BATCH} ({chain_form(m_sum, BATCH)})",
                          lambda: env_scan.right_env_chain(sites, x),
                          lambda: env_scan.right_env_chain_reference(sites, x))

    W, probe_acc = fit_linear_probe(tr_x, tr_y, L)
    pmps, _ = probe_init(tr_x, tr_y, M=L + 1, L=L, dtype=torch.float64)  # the default device
    f = mps_forward(pmps, psi_embed(torch.as_tensor(te_x, device=DEVICE, dtype=torch.float64)))
    same = bool(np.array_equal(f.argmax(0).cpu().numpy(), probe_scores(W, te_x).argmax(0)))
    print(f"[ensemble] probe_init M={L + 1} (float64, l_pos={pmps.l_pos}) on {pmps.device}: the "
          f"MPS's argmax equals the probe's on all {len(te_x)} test samples: {same} (probe "
          f"train acc {probe_acc:.4f})")
    if not same or pmps.device.type != "cuda":
        fail("probe_init's argmax differs from the probe's")
    return {"launches": launched["right_env_chain"], "err": k3_err, "ms": (k_ms, p_ms, None),
            "M": m_sum, "step_ms": step_ms, "test_acc": acc}


# ---- phase 20: parallel/ on a mesh (a world of one) --------------------------------

# The mesh phase: a world of one on the card (NCCL over a HashStore: one card,
# and NCCL takes no two ranks on one device), the flagship's recipe. The
# data-parallel sweeps must equal sweep_once on the same inputs to MESH_TOL of
# max (sites, label core and fresh scores): on one rank the all-reduce adds
# nothing to the gradient and the split is the same code, so they are expected
# bit for bit, and only the metric means are summed in another order.
MESH_TOL = 1e-6
MESH_BATCHES = 2  # a right and a left sweep


def phase_mesh_cli() -> dict:
    """cli/training_mnist.py --dp at the flagship on its default device: a
    world of one the CLI opens and closes itself; K1's launches per
    ShardedTrainer.step."""
    import torch.distributed as dist

    from tensornetworkforml_torch.parallel import dp as dp_mod

    seen = {"steps": 0, "seconds": 0.0}
    real_step = dp_mod.ShardedTrainer.step

    def counted(self, x, y):
        seen["steps"] += 1
        seen["device"] = self.mps.device
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = real_step(self, x, y)
        torch.cuda.synchronize()
        seen["seconds"] += time.perf_counter() - t0
        return acc

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--pool", "--M", str(M), "--svd_method", "polar", "--dp",
                "--n_epochs", "1", "--batch_size", str(CLI_BATCH), "--restarts", "0",
                "--out", os.path.join(tmp, "dp.npz")]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with mock.patch.object(dp_mod.ShardedTrainer, "step", counted):
            val_acc, test_acc = cli_mnist.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts()
        saved = os.path.exists(os.path.join(tmp, "dp.npz"))
    ok = (launched["polar_iterate"] == seen["steps"] * STEPS and seen["steps"] > 0
          and launched["right_env_stack_chain"] == seen["steps"]
          and sum(launched.values()) == launched["polar_iterate"] + seen["steps"]
          and seen["device"].type == "cuda" and saved and not dist.is_initialized())
    ms_batch = seen["seconds"] / max(seen["steps"], 1) * 1e3
    print(f"[mesh] training_mnist {' '.join(argv[:-2])} on the default device "
          f"({seen.get('device')}): {seen['steps']} ShardedTrainer steps of {CLI_BATCH}, "
          f"{ms_batch:.1f} ms a batch ({seconds:.2f} s for the whole command, data, validation "
          f"and test included), val acc {val_acc[-1]:.4f}, test acc "
          f"{test_acc:.4f}; K1 launches {launched['polar_iterate']} = {seen['steps']} x {STEPS}, "
          f"K3's stack form {launched['right_env_stack_chain']} (one a step), no other kernel; "
          f"model saved; the CLI's world closed {not dist.is_initialized()} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"training_mnist --dp launched {launched} over {seen['steps']} steps")
    return {"launches": launched["polar_iterate"], "steps": seen["steps"], "ms_per_batch": ms_batch}


def mesh_profile(what, fn) -> dict:
    """One call of ``fn`` under torch.profiler (host and device, shapes
    recorded): its wall time unprofiled, the device busy time (the union of
    kernel intervals), K5's, K1's and NCCL's device ms, and the collectives of
    each step."""
    from torch.profiler import ProfilerActivity, profile

    from tensornetworkforml_torch.utils.collectives import (
        parse_collectives,
        step_collectives,
        trace_events,
    )

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = trace_events(prof)
    kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = union_ms([(e["ts"], e["ts"] + e["dur"]) for e in kernels])

    def dev_ms(parts):
        return sum(e["dur"] for e in kernels if any(p in e["name"] for p in parts)) / 1e3

    colls = parse_collectives(events)
    steps = step_collectives(events)
    out = {"wall_ms": wall, "busy_ms": busy, "idle": max(0.0, 1 - busy / wall),
           "k5_ms": dev_ms(PROFILE_KERNELS["K4/K5"]), "k1_ms": dev_ms(PROFILE_KERNELS["K1"]),
           "nccl_ms": dev_ms(("nccl", "ncclDev")), "colls": colls, "steps": steps,
           "nccl_host_us": sum(c["end"] - c["ts"] for c in colls)}
    n_red = sum(1 for c in colls if c["op"] == "all_reduce")
    print(f"[mesh] profile {what}: {wall:.1f} ms unprofiled, device busy {busy:.2f} ms (idle "
          f"share {out['idle']:.3f}); K5 {out['k5_ms']:.2f} ms, K1 {out['k1_ms']:.2f} ms, NCCL "
          f"{out['nccl_ms']:.3f} ms on the device; {len(colls)} collectives ({n_red} all-reduce, "
          f"{sum(c['bytes'] for c in colls) / 1e6:.3f} MB), {len(steps)} step ranges, "
          f"{out['nccl_host_us'] / max(len(colls), 1):.1f} us of host time a collective")
    return out


def dist_polar_float64(bmat, rank, mesh, axis="model"):
    """The dist-polar split on one rank in float64: K5's and K1's plain
    versions (at the float32 path's dead_tol) on the same Omega."""
    b = bmat.double()
    I, J = b.shape
    om = svd_mod.rangefinder_omega(J, min(rank, I), torch.float32, b.device).double()
    q = polar_split.polar_iterate_reference(*polar_split.polar_sketch_gram_reference(b, om),
                                            dead_tol=1e-6)
    return q, q.T @ b


def fresh_gap(a, b, x_fresh) -> float:
    """max|f_a - f_b| / max|f_b| on fresh requests, each model in its dtype."""
    fa = mps_forward(a, psi_embed(x_fresh.to(a.dtype))).double()
    fb = mps_forward(b, psi_embed(x_fresh.to(b.dtype))).double()
    if not (torch.isfinite(fa).all() and torch.isfinite(fb).all()):
        fail("a mesh-phase model gives non-finite scores")
    return float((fa - fb).abs().max() / fb.abs().max())


def rel_max(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def phase_mesh(mps0, x_tr, y_tr, x_fresh, requests) -> dict:
    """[mesh]: parallel/ at the flagship in a world of one on the card: two
    data-parallel polar sweeps (K1) against sweep_once, with one NCCL
    all-reduce a step; a dist_split="polar" sweep (K5 and K1, 195 launches
    each) against its float64 run, its step-98 split bit for bit against
    polar_split_two_stage; K5 on two column halves summed against K5 on the
    whole; fused_epoch(mesh=...) against the unsharded epoch; mesh serving
    through K3 against the plain Predictor; then the --dp CLI."""
    import torch.distributed as dist

    from tensornetworkforml_torch.parallel import dist_split as dist_mod
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer
    from tensornetworkforml_torch.parallel.mesh import make_mesh

    out = {"cli": phase_mesh_cli()}
    mesh = make_mesh()  # the default device: the card, NCCL over a HashStore
    try:
        if (mesh.device_type != "cuda" or dist.get_backend() != "nccl"
                or dist.get_world_size() != 1):
            fail(f"make_mesh() gave {mesh} over {dist.get_backend()}")
        print(f"[mesh] make_mesh() on the default device: {mesh}, backend "
              f"{dist.get_backend()}, world {dist.get_world_size()}")
        cfg = flagship_cfg("xla")
        xs = [torch.as_tensor(x_tr[b * BATCH:(b + 1) * BATCH], device=DEVICE)
              for b in range(MESH_BATCHES)]
        ys = [torch.as_tensor(y_tr[b * BATCH:(b + 1) * BATCH], device=DEVICE)
              for b in range(MESH_BATCHES)]

        # data-parallel sweeps against sweep_once
        trainer = ShardedTrainer(mesh, mps0, LR, WD, cfg=cfg)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        accs = [trainer.step(x, y) for x, y in zip(xs, ys)]
        torch.cuda.synchronize()
        dp_ms = (time.perf_counter() - t0) * 1e3 / MESH_BATCHES
        launched = counts()
        ref = mps0
        for x, y in zip(xs, ys):
            ref = sweep_once(ref, psi_embed(x), one_hot_labels(y, L, torch.float32), LR, WD,
                             cfg)[0]
        got = trainer.mps
        gaps = (rel_max(got.sites, ref.sites), rel_max(got.label_site, ref.label_site),
                fresh_gap(got, ref, x_fresh))
        bits = torch.equal(got.sites, ref.sites) and torch.equal(got.label_site, ref.label_site)
        ok = (launched["polar_iterate"] == MESH_BATCHES * STEPS
              and launched["right_env_stack_chain"] == MESH_BATCHES
              and sum(launched.values()) == launched["polar_iterate"] + MESH_BATCHES
              and max(gaps) <= MESH_TOL and got.device.type == "cuda")
        print(f"[mesh] ShardedTrainer (polar, {MESH_BATCHES} sweeps of {BATCH}): {dp_ms:.1f} ms a "
              f"sweep, batch acc {accs}; K1 launches {launched['polar_iterate']} = {MESH_BATCHES} "
              f"x {STEPS}, K3's stack form {launched['right_env_stack_chain']} (one a sweep), no "
              f"other kernel; against sweep_once on the same batches: sites "
              f"{gaps[0]:.3g}, label core {gaps[1]:.3g}, fresh scores {gaps[2]:.3g} of max (tol "
              f"{MESH_TOL:g}); bit for bit: {bits} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the data-parallel sweeps launched {launched} or part from sweep_once by {gaps}")
        out["dp_launches"], out["dp_ms"], out["dp_bits"] = launched["polar_iterate"], dp_ms, bits
        grad = M * D * L * D * M
        fresh = iter([ShardedTrainer(mesh, mps0, LR, WD, cfg=cfg) for _ in range(2)])
        prof = mesh_profile(f"data-parallel sweep (B={BATCH})",
                            lambda: next(fresh).step(xs[0], ys[0]))
        per_step = [[(c["op"], c["elements"]) for c in s] for s in prof["steps"]]
        ok = (len(per_step) == STEPS
              and all(s == [("all_reduce", grad + 3)] for s in per_step))
        print(f"[mesh] NCCL collectives of one data-parallel sweep: {len(per_step)} steps, each "
              f"one all_reduce of {grad} + 3 elements ({(grad + 3) * 4 / 1e3:.2f} kB): {ok}; "
              f"NCCL device {prof['nccl_ms'] * 1e3 / STEPS:.1f} us and host "
              f"{prof['nccl_host_us'] / max(len(prof['colls']), 1):.1f} us a collective against "
              f"{prof['wall_ms'] / STEPS * 1e3:.0f} us a step")
        if not ok:
            fail(f"the data-parallel sweep's steps issued {per_step[:3]} ...")
        out["dp_profile"] = prof
        # the data-parallel sweep in turns with sweep_once on the same batch
        # (single, mesh, mesh, single): what the world of one adds
        fresh = iter([ShardedTrainer(mesh, mps0, LR, WD, cfg=cfg) for _ in range(2)])
        phi0, y1h0 = psi_embed(xs[0]), one_hot_labels(ys[0], L, torch.float32)
        timed = {}
        for which in ("single", "mesh", "mesh", "single"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "mesh":
                next(fresh).step(xs[0], ys[0])
            else:
                sweep_once(mps0, phi0, y1h0, LR, WD, cfg)
            torch.cuda.synchronize()
            timed.setdefault(which, []).append((time.perf_counter() - t0) * 1e3)
        out["turns_ms"] = {k: sum(v) / len(v) for k, v in timed.items()}
        print(f"[mesh] in turns (sweep_once, mesh, mesh, sweep_once) on batch 0: sweep_once "
              f"{timed['single'][0]:.1f} / {timed['single'][1]:.1f} ms, the data-parallel sweep "
              f"{timed['mesh'][0]:.1f} / {timed['mesh'][1]:.1f} ms: "
              f"{(out['turns_ms']['mesh'] - out['turns_ms']['single']) / STEPS * 1e3:.1f} us a "
              f"step added")
        host_time_line("data-parallel sweep",
                       lambda: ShardedTrainer(mesh, mps0, LR, WD, cfg=cfg).step(xs[0], ys[0]))

        # the dist-polar sweep: K5 and K1 on every step
        captured = {"calls": 0}
        real_split = dist_mod.distributed_polar_split

        def spy(bmat, rank, mesh_, *a, **k):
            if captured["calls"] == CAPTURE_STEP:
                captured["bmat"] = bmat.clone()
            captured["calls"] += 1
            return real_split(bmat, rank, mesh_, *a, **k)

        dtrainer = ShardedTrainer(mesh, mps0, LR, WD, cfg=cfg, dist_split="polar")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with mock.patch.object(dist_mod, "distributed_polar_split", spy):
            dtrainer.step(xs[0], ys[0])
        torch.cuda.synchronize()
        dist_ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        ok = (launched["polar_sketch_gram"] == STEPS and launched["polar_iterate"] == STEPS
              and launched["right_env_stack_chain"] == 1
              and sum(launched.values()) == 2 * STEPS + 1 and captured["calls"] == STEPS)
        print(f"[mesh] ShardedTrainer(dist_split='polar'), one sweep of {BATCH}: {dist_ms:.1f} ms; "
              f"K5 launches {launched['polar_sketch_gram']}, K1 {launched['polar_iterate']} "
              f"(want {STEPS} each), K3's stack form {launched['right_env_stack_chain']} (want 1), "
              f"no other kernel {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the dist-polar sweep launched {launched}")
        out["dist_launches"], out["dist_ms"] = launched["polar_sketch_gram"], dist_ms
        out["dist_k1_launches"] = launched["polar_iterate"]
        m64 = mps0.replace(sites=mps0.sites.double(), label_site=mps0.label_site.double())
        t64 = ShardedTrainer(mesh, m64, LR, WD, cfg=cfg, dist_split="polar")
        with mock.patch.object(dist_mod, "distributed_polar_split", dist_polar_float64):
            t64.step(xs[0].double(), ys[0])
        gap = fresh_gap(dtrainer.mps, t64.mps, x_fresh)
        print(f"[mesh] dist-polar sweep against its float64 run (K5's and K1's plain versions in "
              f"float64): fresh scores {gap:.3g} of max|f| (tol {SWEEP_TOL:g}) "
              f"{'ok' if gap <= SWEEP_TOL else 'FAIL'}")
        if gap > SWEEP_TOL:
            fail(f"the dist-polar sweep parts from its float64 run by {gap:.3g}")
        bmat = captured["bmat"]
        q, r = real_split(bmat, M, mesh)
        q1, r1 = polar_split.polar_split_two_stage(bmat, M)
        same = torch.equal(q, q1) and torch.equal(r, r1)
        print(f"[mesh] step {CAPTURE_STEP}'s split (I={bmat.shape[0]} J={bmat.shape[1]} q={M}) "
              f"through distributed_polar_split equals polar_split_two_stage bit for bit: {same}")
        if not same:
            fail("the one-rank distributed polar split differs from polar_split_two_stage")
        fresh = iter([ShardedTrainer(mesh, mps0, LR, WD, cfg=cfg, dist_split="polar")
                      for _ in range(2)])
        out["dist_profile"] = mesh_profile(f"dist-polar sweep (B={BATCH})",
                                           lambda: next(fresh).step(xs[0], ys[0]))
        host_time_line("dist-polar sweep", lambda: ShardedTrainer(
            mesh, mps0, LR, WD, cfg=cfg, dist_split="polar").step(xs[0], ys[0]))
        colls = out["dist_profile"]["colls"]
        out["gather_bytes"] = sum(c["bytes"] for c in colls if c["op"] == "all_gather") / STEPS
        out["reduce_bytes"] = sum(c["bytes"] for c in colls if c["op"] == "all_reduce") / STEPS
        print(f"[mesh] dist-polar sweep bytes a step: all_reduce {out['reduce_bytes'] / 1e3:.1f} "
              f"kB (the gradient and metrics, then y, G and n2), all_gather "
              f"{out['gather_bytes'] / 1e3:.1f} kB (the label core's columns)")

        # K5 on two column halves against K5 on the whole matrix
        I, J = bmat.shape
        om = svd_mod.rangefinder_omega(J, M, torch.float32, bmat.device).contiguous()
        whole = polar_split.polar_sketch_gram(bmat, om)
        halves = [polar_split.polar_sketch_gram(bmat[:, s].contiguous(), om[s].contiguous())
                  for s in (slice(0, J // 2), slice(J // 2, J))]
        errs = [rel_max(a + b, w) for a, b, w in zip(*halves, whole)]
        ok = max(errs) <= RED_TOL
        print(f"[mesh] K5 on step {CAPTURE_STEP}'s two column halves (I={I} J={J // 2} q={M} "
              f"each), summed, against K5 on the whole: y {errs[0]:.3g}, G {errs[1]:.3g}, n2 "
              f"{errs[2]:.3g} of max (tol {RED_TOL:g}, 3xTF32 sums in another order) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K5's column halves do not sum to the whole: {errs}")

        # fused_epoch over the mesh against the unsharded epoch
        xe, ye = torch.stack(xs), torch.stack(ys)
        reset_counts()
        m_mesh, acc_mesh, _ = epoch_mod.fused_epoch(mps0, xe, ye, LR, WD, cfg, mesh=mesh)
        torch.cuda.synchronize()
        launched = counts()
        m_one, acc_one, _ = epoch_mod.fused_epoch(mps0, xe, ye, LR, WD, cfg)
        gap = fresh_gap(m_mesh, m_one, x_fresh)
        ok = (launched["polar_iterate"] == MESH_BATCHES * STEPS and gap <= MESH_TOL
              and torch.equal(acc_mesh, acc_one))
        print(f"[mesh] fused_epoch(mesh=...) on {MESH_BATCHES} batches: K1 launches "
              f"{launched['polar_iterate']}; against the unsharded epoch: fresh scores {gap:.3g} "
              f"of max (tol {MESH_TOL:g}), batch accuracies equal, sites bit for bit "
              f"{torch.equal(m_mesh.sites, m_one.sites)} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the mesh epoch differs from the unsharded epoch")

        # mesh serving through K3
        reset_counts()
        pred = Predictor(mps0, mesh=mesh)
        served = pred.scores(requests[:BATCH])
        k3 = counts()["right_env_chain"]
        plain = Predictor(mps0).scores(requests[:BATCH])
        same = bool(np.array_equal(served, plain))
        ok = same and k3 == 1 and pred.use_kernel and pred.device.type == "cuda"
        print(f"[mesh] Predictor(mesh=...) at batch {BATCH} on {pred.device}: K3 launches {k3}; "
              f"the scores equal the single-device Predictor's bit for bit: {same} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("mesh serving differs from the single-device Predictor or missed K3")
        out["serve_launches"] = k3
    finally:
        dist.destroy_process_group()
    return out


# ---- phases 21-23: reference pickles, profiling, the port's examples --------

REF_MAE_TOL = 1e-5  # test_diagonals' MAE: a .dat loads in float64, the .npz in float32
PROFILE_ITERS = 2  # profile_model's timed iterations at the flagship
EXAMPLES = ("01_train_diagonals_functional.py", "02_fused_epoch_and_serving.py",
            "03_data_parallel_mesh.py", "04_onesite_full_resolution.py",
            "05_production_recipe.py", "06_brickwall_parallel_bonds.py")
EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "torch")
# 05 has no smoke size: 4 epochs on synthetic_mnist's 6000 + 1000 images take
# ~54 s of host-bound sweeps on the card; here it runs on a cut of them
EXAMPLE_05_IMAGES = dict(n_train=2048, n_test=512)


def phase_reference(mps, requests, serve, cli, xb, yb, x_fresh) -> dict:
    """The flagship that [serve] served, written as a reference .dat pickle by
    save_reference_pickle and served by Predictor.from_checkpoint on the
    default device at both batch sizes, with [serve]'s calls: through K3, as
    many launches, the same scores bit for bit (float32 round-trips through
    float64 elem at the padded width). A swept model (label at N-1) as a
    .dat takes the plain path, as in the JAX package. Network.load of the .dat
    against Network.load of the .npz; test_diagonals on a .dat of [cli]'s
    diagonals model against its .npz run."""
    t0 = time.perf_counter()
    launches, served = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dat = os.path.join(tmp, "flagship.dat")
        ckpt_mod.save_reference_pickle(mps, dat)
        reset_counts()
        pred = Predictor.from_checkpoint(dat)  # the default device: the card
        pred.warmup()
        served.update((n, pred.scores(requests[:n])) for n in REQUEST_SIZES)
        pred.predict(requests[:BATCH])
        launches[BATCH] = counts()["right_env_chain"]
        reset_counts()
        bulk = Predictor.from_checkpoint(dat, batch_size=BIG)
        served[BIG] = bulk.scores(requests[:BIG])
        launches[BIG] = counts()["right_env_chain"]
        on_kernel = (pred.device.type == "cuda" and pred.use_kernel and bulk.use_kernel
                     and pred.mps.dtype == torch.float32)
        same = all(np.array_equal(got, serve["served"][n]) for n, got in served.items())
        ok = on_kernel and same and launches == serve["launches"]
        print(f"[reference] save_reference_pickle of [serve]'s flagship "
              f"({os.path.getsize(dat) / 1e6:.1f} MB), Predictor.from_checkpoint(.dat) on "
              f"{pred.device} (kernel {pred.use_kernel}, {pred.mps.dtype}) on requests "
              f"{REQUEST_SIZES} at batch {BATCH} and {BIG} at batch {BIG}: K3 launches "
              f"{launches[BATCH]} and {launches[BIG]} ([serve]: {serve['launches'][BATCH]} and "
              f"{serve['launches'][BIG]}); scores bit for bit [serve]'s: {same} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the .dat flagship did not serve as [serve] did through K3")

        swept = one_sweep(mps, xb, yb, "xla")[0]
        dat2 = os.path.join(tmp, "swept.dat")
        ckpt_mod.save_reference_pickle(swept, dat2)
        reset_counts()
        p2 = Predictor.from_checkpoint(dat2)
        got = p2.scores(requests[:BATCH])
        k3 = counts()["right_env_chain"]
        want = Predictor(swept).scores(requests[:BATCH])
        err = float(np.abs(got - want).max())
        tol = TOL * float(np.abs(want).max())
        ok = (k3 == 0 and not p2.use_kernel and p2.device.type == "cuda" and err <= tol
              and np.isfinite(got).all())
        print(f"[reference] a .dat of the flagship after one sweep (l_pos {swept.l_pos}) on "
              f"{p2.device}: the plain path ran (K3 serves a label at site 0 only, the JAX "
              f"package's rule), K3 launches {k3}; against the model in memory "
              f"max|diff| {err:.3g} <= {tol:.3g} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the swept .dat did not serve on the plain path as the model in memory")

        npz = os.path.join(tmp, "flagship.npz")
        save_checkpoint(mps, npz)
        f_npz = Network.load(npz).forward(x_fresh).elem
        n32 = Network.load(dat, dtype=torch.float32)
        n64 = Network.load(dat)
        f32, f64 = n32.forward(x_fresh).elem, n64.forward(x_fresh.double()).elem
        same = torch.equal(f32, f_npz)
        gap = float((f64 - f_npz.double()).abs().max() / f_npz.abs().max())
        ok = (same and gap <= TOL and n64.mps.dtype == torch.float64
              and n32.device.type == n64.device.type == "cuda")
        print(f"[reference] Network.load(.dat) on {n64.device}: float32 (dtype given) scores "
              f"bit for bit Network.load(.npz)'s: {same}; float64 (the default) within "
              f"{gap:.3g} x max|f| (tol {TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("Network.load of the .dat disagrees with Network.load of the .npz")

        diag = os.path.join(tmp, "diag.dat")
        ckpt_mod.save_reference_pickle(cli["diag_model"], diag)
        acc, mae = cli_diag_test.main(["--filename", diag, "--seed", str(SEED + 1)])
        acc0, mae0 = cli["diag_acc_mae"]
        ok = acc == acc0 and abs(mae - mae0) <= REF_MAE_TOL * abs(mae0)
        print(f"[reference] test_diagonals --filename diag.dat on the card: acc {acc:.4f}, mae "
              f"{mae:.6f}; its .npz run in [cli]: acc {acc0:.4f}, mae {mae0:.6f} (the .dat "
              f"loads in float64, the .npz in float32; MAE tol {REF_MAE_TOL:g} relative) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("test_diagonals on the .dat disagrees with its .npz run")
    seconds = time.perf_counter() - t0
    print(f"[reference] {seconds:.1f} s")
    return {"launches": launches, "seconds": seconds}


def timer_report(summary: dict) -> str:
    """``Timer.report()`` of a ``profile_model`` table."""
    timer = Timer()
    for name, s in summary.items():
        timer.totals[name], timer.counts[name] = s["total_s"], s["count"]
    return timer.report()


def traced_batch(pred, x) -> dict:
    """One flagship serving batch inside device_trace: whether the trace was
    written, and the device events it holds (K3's among them)."""
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp) as prof:
            pred._chunk_scores(x)
        written = os.path.exists(prof.trace_path)
        in_file = written and "chain_kernel" in open(prof.trace_path).read()
        size_kb = os.path.getsize(prof.trace_path) / 1e3 if written else 0.0
    on_device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"written": written, "in_file": in_file, "kb": size_kb, "on_device": on_device,
            "k3": [n for n in on_device if "chain_kernel" in n]}


def phase_profiling(mps, requests) -> dict:
    """utils/profiling.py on the card, before any other phase profiles: one
    flagship Predictor batch inside device_trace, whose trace must hold K3;
    the same batch timed by a Timer scope with sync and by CUDA events
    recorded inside it (the scope must not read less); profile_model at its
    defaults and at the flagship."""
    t0 = time.perf_counter()
    pred = Predictor(mps, batch_size=BATCH)
    pred.warmup()
    x = torch.as_tensor(requests[:BATCH], device=DEVICE)
    tr = traced_batch(pred, x)
    ok = tr["written"] and tr["in_file"] and bool(tr["k3"])
    print(f"[profiling] device_trace of one flagship batch: trace written ({tr['kb']:.1f} kB) "
          f"{tr['written']}, {len(tr['on_device'])} device events, K3's among them: "
          f"{tr['k3'][:1]} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("device_trace's trace misses K3's kernel")

    timer = Timer()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with timer.scope("serve", sync=x):
        start.record()
        out = pred._chunk_scores(x)
        end.record()
    event_ms, scope_ms = start.elapsed_time(end), 1e3 * timer.totals["serve"]
    ok = scope_ms >= event_ms and bool(torch.isfinite(out).all())
    print(f"[profiling] one flagship Predictor batch (B={BATCH}, K3): Timer scope with sync "
          f"{scope_ms:.4f} ms, CUDA events inside it {event_ms:.4f} ms "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the Timer scope ended before the card's work did")

    for label, kw in (("its defaults (N=25, M=20, L=2, batch 16, 10 iters)", {}),
                      (f"the flagship (N={N}, M={M}, L={L}, batch {BATCH}, {PROFILE_ITERS} "
                       f"iters)", dict(N=N, M=M, L=L, batch=BATCH, iters=PROFILE_ITERS))):
        table = profile_model(**kw)
        iters = kw.get("iters", 10)
        if set(table) != {"forward", "full_sweep", "env_stack", "svd_split"} or any(
                s["count"] != iters for s in table.values()):
            fail(f"profile_model at {label} gave {table}")
        print(f"[profiling] profile_model() at {label} on the card:\n" + timer_report(table))
    seconds = time.perf_counter() - t0
    print(f"[profiling] {seconds:.1f} s")
    return {"seconds": seconds, "pred": pred, "x": x}


def late_trace(prof: dict) -> None:
    """The same traced batch again after every other phase has profiled. A
    device_trace this late in the script has recorded no device events on
    the card, where it records them early in the process and in a process
    that only repeats the mesh phase's profiling sequence, so it is printed,
    not held (PERF.md section 7)."""
    tr = traced_batch(prof["pred"], prof["x"])
    print(f"[profiling] device_trace of the same batch after the other phases: "
          f"{len(tr['on_device'])} device events, K3's among them: {len(tr['k3'])} (printed, "
          f"not held)")


def phase_examples() -> dict:
    """The port's six examples (examples/torch/) on the card, in this
    process (runpy) with TNML_SMOKE=1 (05 on EXAMPLE_05_IMAGES): each exits
    cleanly, prints an accuracy and keeps its model on cuda; 02 serves
    through K3."""
    import io
    import runpy
    import sys

    t0 = time.perf_counter()
    out = {}
    for name in EXAMPLES:
        script = os.path.join(EXAMPLES_DIR, name)
        buf = io.StringIO()
        t1 = time.perf_counter()
        cut = {}
        if name.startswith("05"):
            cut = EXAMPLE_05_IMAGES
            print(f"[examples] {name} on synthetic_mnist({cut}) in place of its 6000 + 1000 "
                  f"images")
        reset_counts()
        with mock.patch.dict(os.environ, {"TNML_SMOKE": "1"}), \
                mock.patch.object(sys, "argv", [script]), \
                mock.patch.object(mnist_mod, "synthetic_mnist",
                                  functools.partial(mnist_mod.synthetic_mnist, **cut)), \
                contextlib.redirect_stdout(buf):
            glb = runpy.run_path(script, run_name="__main__")
        torch.cuda.synchronize()
        launched = {k: n for k, n in counts().items() if n}
        seconds = time.perf_counter() - t1
        text = buf.getvalue()
        model = glb.get("mps", glb.get("model"))
        ok = "accuracy" in text and model.sites.device.type == "cuda"
        if name.startswith("02"):
            ok = ok and glb["pred"].use_kernel and launched.get("right_env_chain", 0) > 0
            out["k3_launches"] = launched.get("right_env_chain", 0)
        last = text.strip().splitlines()[-1] if text.strip() else ""
        print(f"[examples] {name}: {seconds:.1f} s, model on {model.sites.device}, launches "
              f"{launched}; last line: {last} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"example {name} printed no accuracy, left the card or missed K3")
        out[name] = seconds
    seconds = time.perf_counter() - t0
    print(f"[examples] {seconds:.1f} s")
    out["seconds"] = seconds
    return out


# ---- phase 24: the reduced-precision modes --------------------------------------

# [precision]: the reduced name the phase runs (utils/precision.py: TF32 for
# cuBLAS's float32 products on the card; "high" and "bfloat16" do the same)
PRECISION = "tensorfloat32"
# One-pass K4a and K4b against the plain product of their TF32-rounded operands
# (in float64; K4b's t rounded to float32 and TF32 between its halves, as the
# kernel stores and rereads it): only the order of the float32 sums differs,
# and t can round the other way on a TF32 tie (measured up to 1.4e-5 of the
# output's max at M=512, H100). Against float64: each product rounds its
# operands to TF32's 10-bit mantissa (measured up to 4.7e-4; cuBLAS in TF32
# reads the same), so ONE_PASS_TOL is about two such roundings.
ONE_PASS_PLAIN_TOL, ONE_PASS_TOL = 5e-5, 1e-3
# A flagship sweep in TF32 against the IEEE sweep on the same batch: accuracy
# on BATCH fresh requests within PRECISION_ACC_TOL (5 of 256).
PRECISION_ACC_TOL = 0.02
# The brick and one-site sweeps in TF32 against their float64 runs: 3.7e-3 and
# 4.8e-3 of max|f| measured (H100), where two TF32 runs part by 7.6e-4 and
# 4.6e-3 (w rescaled by 1 + RF_PERTURB) and each sweep moves f by ~1 of
# max|f|; the IEEE sweeps read ~1e-5 against [brickwall]'s and [onesite]'s
# 1e-3. 3e-2 leaves a sixfold margin and still catches a fault in a pair's
# update.
BRICK_TF32_TOL, ONESITE_TF32_TOL = 3e-2, 3e-2


def tf32_rounded(x: torch.Tensor) -> torch.Tensor:
    """float32 -> tf32 as ``cvt.rna.tf32.f32`` (ties away): the low 13 bits of
    the mantissa cleared, on the tensor's device."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def one_pass_plain(bmat, om, y1):
    """K4a's and K4b's one-pass products from TF32-rounded operands in float64."""
    bt = tf32_rounded(bmat).double()
    t = (bt.T @ tf32_rounded(y1).double()).float()
    return bt @ tf32_rounded(om).double(), bt @ tf32_rounded(t).double()


def compare_one_pass(name, bmat, om, y1) -> dict:
    """One-pass K4a and K4b against the TF32-rounded plain product
    (ONE_PASS_PLAIN_TOL) and float64 (ONE_PASS_TOL), n2 against float64
    (RED_TOL), and a second launch of each bit for bit; their error against
    the float32 plain version, the 3xTF32 form's against float64 and cuBLAS
    in TF32 against float64 printed."""
    y0, n2 = polar_split.gramfree_sketch_tf32(bmat, om)
    z = polar_split.gramfree_gmul_tf32(bmat, y1)
    y0_3, z_3 = polar_split.gramfree_sketch(bmat, om)[0], polar_split.gramfree_gmul(bmat, y1)
    with matmul_precision(PRECISION):
        lib_y0, lib_z = bmat @ om, bmat @ (bmat.T @ y1)
    torch.cuda.synchronize()
    tf_y0, tf_z = one_pass_plain(bmat, om, y1)
    b64 = bmat.double()
    f_y0, f_n2 = polar_split.gramfree_sketch_reference(b64, om.double())
    f_z = polar_split.gramfree_gmul_reference(b64, y1.double())
    p_y0 = polar_split.gramfree_sketch_reference(bmat, om)[0]
    p_z = polar_split.gramfree_gmul_reference(bmat, y1)
    out, ok = {}, True
    n2_rel = float((n2.double() - f_n2).abs().max() / f_n2.abs().max())
    for kernel, got, tf, f64, plain, three, lib in (
            ("gramfree_sketch_tf32", y0, tf_y0, f_y0, p_y0, y0_3, lib_y0),
            ("gramfree_gmul_tf32", z, tf_z, f_z, p_z, z_3, lib_z)):
        if got.shape != f64.shape or not torch.isfinite(got).all():
            fail(f"{kernel} {name}: output {tuple(got.shape)} not finite or wrong shape")
        scale = float(f64.abs().max())
        rel = {k: float((v.double() - ref).abs().max()) / scale
               for k, v, ref in (("tf32", got, tf), ("f64", got, f64), ("3x", three, f64),
                                 ("lib", lib, f64))}
        good = rel["tf32"] <= ONE_PASS_PLAIN_TOL and rel["f64"] <= ONE_PASS_TOL
        ok = ok and good
        out[kernel] = float((got - plain).abs().max())
        print(f"[precision] {kernel} {name}: against the TF32-rounded plain product "
              f"{rel['tf32']:.3g} (tol {ONE_PASS_PLAIN_TOL:g}), against float64 {rel['f64']:.3g} "
              f"(tol {ONE_PASS_TOL:g}){', n2 %.3g (tol %g)' % (n2_rel, RED_TOL) if kernel == 'gramfree_sketch_tf32' else ''}"
              f" {'ok' if good else 'FAIL'}; max|kernel - float32 plain| {out[kernel]:.3g}; "
              f"3xTF32 form against float64 {rel['3x']:.3g}, cuBLAS in TF32 {rel['lib']:.3g}")
    again = (*polar_split.gramfree_sketch_tf32(bmat, om), polar_split.gramfree_gmul_tf32(bmat, y1))
    repeat = all(same_bits(a, b) for a, b in zip((y0, n2, z), again))
    print(f"[precision] {name}: a second launch of each gives the first's bits: {repeat}")
    if not ok or n2_rel > RED_TOL or not repeat:
        fail(f"{name}: the one-pass K4a or K4b disagrees with its TF32-rounded plain product, "
             "or with itself")
    return out


def one_pass_turns(name, one, three, plain, library, reps=20):
    """The one-pass kernel in turns with the 3xTF32 form, cuBLAS in TF32 and
    the plain version (IEEE float32): forward, then backward; mean ms of
    (one-pass, plain, cuBLAS TF32, 3xTF32)."""
    fns = {"one": one, "three": three, "lib": library, "plain": plain}
    ms = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            ms[k].append(cuda_ms(fns[k], reps))
    print(f"[timing] {name}: one-pass kernel {ms['one'][0] * 1e3:.1f} / {ms['one'][1] * 1e3:.1f} "
          f"us, 3xTF32 form {ms['three'][0] * 1e3:.1f} / {ms['three'][1] * 1e3:.1f} us, cuBLAS "
          f"in TF32 {ms['lib'][0] * 1e3:.1f} / {ms['lib'][1] * 1e3:.1f} us, plain (IEEE) "
          f"{ms['plain'][0] * 1e3:.1f} / {ms['plain'][1] * 1e3:.1f} us")
    return tuple(sum(ms[k]) / 2 for k in ("one", "plain", "lib", "three"))


def live_isometry(q: torch.Tensor) -> float:
    qd = q.double()
    gq = qd.T @ qd
    live = torch.diagonal(gq) > 0.5
    n = int(live.sum())
    return float((gq[live][:, live] - torch.eye(n, dtype=torch.float64, device=q.device))
                 .abs().max()) if n else 0.0


def precision_sweeps(mps, xb, yb, x_fresh, y_fresh, ref) -> dict:
    """Flagship sweeps under PRECISION on the three engines, each against the
    IEEE sweep on the same batch: the same kernel launches, other bits, the
    gap to the float64 sweep ``ref`` beside the IEEE sweep's, fresh accuracy
    within PRECISION_ACC_TOL, the TF32 switch off after each, ms in turns."""
    want = {"xla": {"polar_iterate": STEPS}, "hybrid": {"polar_iterate": STEPS,
                                                       "two_site_presplit": STEPS},
            "fused": {"two_site_step": STEPS}}
    for kernels in want.values():
        kernels["right_env_stack_chain"] = 1  # the prologue, full float32 in every scope
    out = {}
    for engine, kernels in want.items():
        runs, launched, ms = {}, {}, {"ieee": [], "tf32": []}
        for mode in ("ieee", "tf32", "tf32", "ieee"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = one_sweep(mps, xb, yb, engine,
                            precision=PRECISION if mode == "tf32" else "default")
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) * 1e3)
            launched[mode] = counts()
            runs.setdefault(mode, res)
            if torch.backends.cuda.matmul.allow_tf32:
                fail(f"the TF32 switch is still on after a {mode} {engine} sweep")
        a, b = runs["tf32"], runs["ieee"]
        if launched["tf32"] != launched["ieee"] or any(
                launched["tf32"][k] != n for k, n in kernels.items()):
            fail(f"[precision] {engine} sweep launches: {PRECISION} {launched['tf32']}, IEEE "
                 f"{launched['ieee']} (want {kernels} in both)")
        fresh = [mps_forward(r[0], psi_embed(x_fresh)) for r in (a, b)]
        if torch.equal(a[2], b[2]) or torch.equal(*fresh):
            fail(f"[precision] the {PRECISION} {engine} sweep gives the IEEE sweep's bits: "
                 "TF32 never ran")
        gap_t, gap_i = sweep_gaps(f"precision {engine}", a, ref, x_fresh), sweep_gaps(
            f"precision {engine} ieee", b, ref, x_fresh)
        acc_t, acc_i = fresh_accuracy(a[0], x_fresh, y_fresh), fresh_accuracy(b[0], x_fresh,
                                                                              y_fresh)
        ok = abs(acc_t - acc_i) <= PRECISION_ACC_TOL
        print(f"[precision] flagship sweep engine={engine} under {PRECISION!r}: launches "
              f"{ {k: launched['tf32'][k] for k in kernels} } as the IEEE sweep's; bits differ "
              f"from it; against the float64 sweep f_final {gap_t[0]:.3g}, fresh scores "
              f"{gap_t[1]:.3g} of max|f| (IEEE {gap_i[0]:.3g}, {gap_i[1]:.3g}); fresh accuracy "
              f"{acc_t:.4f} vs IEEE {acc_i:.4f} (tol {PRECISION_ACC_TOL:g}) "
              f"{'ok' if ok else 'FAIL'}; ms per sweep in turns IEEE {ms['ieee'][0]:.1f} / "
              f"{ms['ieee'][1]:.1f}, {PRECISION} {ms['tf32'][0]:.1f} / {ms['tf32'][1]:.1f}; "
              f"TF32 switch off after each")
        if not ok:
            fail(f"[precision] the {PRECISION} {engine} sweep's accuracy moved by "
                 f"{abs(acc_t - acc_i):.3g}")
        out[engine] = {"ms": sum(ms["tf32"]) / 2, "ms_ieee": sum(ms["ieee"]) / 2,
                       "gap": gap_t[1], "gap_ieee": gap_i[1], "launches": launched["tf32"]}
    return out


def precision_factored(big, xb, yb, x_fresh, y_fresh) -> None:
    """One M=512 sweep through the factored route under PRECISION, held by
    quality against the IEEE factored sweep (QUALITY_F_TOL, QUALITY_ACC_TOL);
    its iteration runs in train/factored_step.py's _ITERATE_MODES (IEEE), read
    by a spy inside its Newton-Schulz passes; no kernel launches but the
    prologue's (K3's stack form, once)."""
    from tensornetworkforml_torch.train import factored_step as fs_mod

    seen = []
    real = fs_mod._polar_ns_greedy

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*args)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(fs_mod, "_polar_ns_greedy", spy):
        red = large_sweep(big, xb, yb, "auto", precision=PRECISION)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = counts()
    ieee = large_sweep(big, xb, yb, "auto")
    want_tf32 = [m == "tensorfloat32" for m in fs_mod._ITERATE_MODES]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    if not (torch.isfinite(red[0].sites).all() and torch.isfinite(red[2]).all()):
        fail(f"the {PRECISION} M={M_LARGE} factored sweep left non-finite values")
    batch = rel(red[2], ieee[2])
    fresh = rel(mps_forward(red[0], psi_embed(x_fresh)), mps_forward(ieee[0], psi_embed(x_fresh)))
    acc_r, acc_i = fresh_accuracy(red[0], x_fresh, y_fresh), fresh_accuracy(ieee[0], x_fresh,
                                                                            y_fresh)
    modes = sorted(set(seen))
    ok = (max(batch, fresh) <= QUALITY_F_TOL and abs(acc_r - acc_i) <= QUALITY_ACC_TOL
          and launched["right_env_stack_chain"] == 1 and sum(launched.values()) == 1
          and modes == sorted(set(want_tf32)))
    print(f"[precision] M={M_LARGE} factored sweep under {PRECISION!r} ({ms:.1f} ms): f_final "
          f"{batch:.3g}, fresh scores {fresh:.3g} of max|f| from the IEEE factored sweep (tol "
          f"{QUALITY_F_TOL:g}); fresh accuracy {acc_r:.4f} vs {acc_i:.4f} (tol "
          f"{QUALITY_ACC_TOL:g}); the iteration's {len(seen)} Newton-Schulz calls ran with "
          f"the TF32 switch {modes} (_ITERATE_MODES {fs_mod._ITERATE_MODES}); kernel launches "
          f"{sum(launched.values())}, K3's stack form {launched['right_env_stack_chain']} (want "
          f"1, the prologue) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the {PRECISION} M={M_LARGE} factored sweep failed its hold")


def phase_precision(mps, big, large, xb, yb, x_fresh, y_fresh, brick, onesite) -> dict:
    """[precision]: K4a and K4b's one-pass TF32 form against its TF32-rounded
    plain product and float64 at the M=512 step's inputs and a ragged shape,
    gramfree_split(precision=PRECISION) at M=512 (the main path of the one-pass
    form: one launch each; with --other-csrc also timed in turns with the
    other build), the two timed in turns with the 3xTF32 form and cuBLAS in
    TF32; the one-pass plan printed; flagship sweeps under PRECISION on the three engines; an
    M=512 factored sweep; a brick and a one-site sweep against float64."""
    t_phase = time.perf_counter()
    bmat, om = large["k4a"]
    _, y1 = large["k4b"]
    I, J = bmat.shape
    shape = f"I={I} J={J} q={M_LARGE}"
    errs = compare_one_pass(f"M={M_LARGE} step {CAPTURE_STEP} {shape}", bmat, om, y1)
    gen = torch.Generator().manual_seed(SEED + 5)
    ri, rj, rq = 77, 1000, 47
    b_r = torch.randn((ri, rj), generator=gen) / np.sqrt(rj)
    b_r[:, [0, 3, rj - 1]] = 0.0
    om_r = torch.randn((rj, rq), generator=gen)
    y1_r = torch.linalg.qr(torch.randn((ri, rq), generator=gen))[0].contiguous()
    ragged = compare_one_pass(f"ragged I={ri} J={rj} q={rq}", b_r.to(DEVICE), om_r.to(DEVICE),
                              y1_r.to(DEVICE))
    errs = {k: max(errs[k], ragged[k]) for k in errs}

    torch.cuda.synchronize()
    reset_counts()
    q1, r1 = polar_split.gramfree_split(bmat, M_LARGE, precision=PRECISION)
    torch.cuda.synchronize()
    launched = counts()
    q3, r3 = polar_split.gramfree_split(bmat, M_LARGE)
    if launched["gramfree_sketch_tf32"] != 1 or launched["gramfree_gmul_tf32"] != 1 or (
            launched["gramfree_sketch"] or launched["gramfree_gmul"]):
        fail(f"gramfree_split(precision={PRECISION!r}) launched {launched}")
    iso1, iso3 = live_isometry(q1), live_isometry(q3)
    rec = float((q1 @ r1 - q3 @ r3).abs().max() / bmat.abs().max())
    proj = float((q1.double() @ q1.double().T - q3.double() @ q3.double().T).abs().max())
    ok = bool(torch.isfinite(r1).all()) and iso1 <= max(2 * iso3, K1_ISO_TOL)
    print(f"[precision] gramfree_split(precision={PRECISION!r}) on the M={M_LARGE} step: K4a "
          f"and K4b one-pass 1 launch each (3xTF32 form 0); live-column isometry {iso1:.3g} "
          f"(the 3xTF32 split's {iso3:.3g}; tol max(2 x it, {K1_ISO_TOL:g})) "
          f"{'ok' if ok else 'FAIL'}; against the 3xTF32 split: Q R {rec:.3g} of max|B|, "
          f"projector {proj:.3g}")
    if not ok:
        fail(f"gramfree_split(precision={PRECISION!r}) left Q {iso1:.3g} from an isometry")

    plan = (ctypes.c_int * 6)()
    halves = []
    for what, mnk, mw in (("K4a y0^T", (M_LARGE, I, J), 2), ("K4b t", (J, M_LARGE, I), 1),
                          ("K4b z", (I, M_LARGE, J), 1)):
        polar_split._sketch_lib().tnml_tf32_plan(*mnk, mw, plan)
        halves.append(f"{what} (M, N, K) = {mnk}: {plan[0]} x {plan[1]} tiles of {plan[4]} x "
                      f"{plan[5]}, k split {plan[2]} of {plan[3]} chunks of 32")
    print("[precision] the one-pass plan: " + "; ".join(halves))
    if "polar_sketch" in OTHER:
        other_build_turns(f"gramfree_split(precision={PRECISION!r}) {shape}", "polar_sketch",
                          lambda: polar_split.gramfree_split(bmat, M_LARGE, precision=PRECISION),
                          10)

    ms = {}

    def lib_y0():
        with matmul_precision(PRECISION):
            return bmat @ om

    def lib_z():
        with matmul_precision(PRECISION):
            return bmat @ (bmat.T @ y1)

    ms["gramfree_sketch_tf32"] = one_pass_turns(
        f"gramfree_sketch_tf32 {shape}", lambda: polar_split.gramfree_sketch_tf32(bmat, om),
        lambda: polar_split.gramfree_sketch(bmat, om),
        lambda: polar_split.gramfree_sketch_reference(bmat, om), lib_y0)
    ms["gramfree_gmul_tf32"] = one_pass_turns(
        f"gramfree_gmul_tf32 {shape}", lambda: polar_split.gramfree_gmul_tf32(bmat, y1),
        lambda: polar_split.gramfree_gmul(bmat, y1),
        lambda: polar_split.gramfree_gmul_reference(bmat, y1), lib_z)

    sweeps = precision_sweeps(mps, xb, yb, x_fresh, y_fresh, float64_sweep(mps, xb, yb))
    precision_factored(big, xb, yb, x_fresh, y_fresh)

    def brick_sweep(m, p, y):
        return brick_mod.brick_sweep(m, p, y, BRICK_LR, WD, brick_mod.BrickConfig(
            split_method="cholqr", matmul_precision=PRECISION))[0]

    def onesite_sweep(m, p, y):
        return onesite_mod.onesite_sweep(m, p, y, ONESITE_LONG_LR, WD, False,
                                         onesite_mod.OneSiteConfig(renorm=True,
                                                                   matmul_precision=PRECISION))[0]

    bm, bphi, by1h, bx = brick["held_inputs"]
    b_held = hold_f64("precision", f"brick sweep N={N} M={M} B={CLI_BATCH} under {PRECISION!r} "
                      f"(the IEEE sweep's gap {brick['gap']:.3g})", brick_sweep, bm, bphi, by1h,
                      bx, BRICK_TF32_TOL, f32_ridge=True)
    om_, ophi, oy1h, ox = onesite["held_inputs"]
    o_held = hold_f64("precision", f"one-site sweep N={ONESITE_LONG_N} M={ONESITE_LONG_M} "
                      f"B={CLI_BATCH} renorm under {PRECISION!r} (the IEEE sweep's gap "
                      f"{onesite['gap']:.3g})", onesite_sweep, om_, ophi, oy1h, ox,
                      ONESITE_TF32_TOL)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("the TF32 switch is on after the [precision] phase")
    seconds = time.perf_counter() - t_phase
    print(f"[precision] phase {seconds:.1f} s")
    return {"errs": errs, "ms": ms, "launches": {k: launched[k] for k in (
        "gramfree_sketch_tf32", "gramfree_gmul_tf32")}, "sweeps": sweeps,
        "brick_gap": b_held["gap"], "onesite_gap": o_held["gap"], "seconds": seconds}


# ---- phase 25: the pure-teacher comparison ---------------------------------------

# scripts/torch_teacher_pm0.py at the configuration of results/teacher_pm0.json
TEACHER_PM0_ARGS = ["--N", "64", "--M", "16", "--n_train", "2048", "--n_epochs", "12",
                    "--trainers", "brickwall,twosite", "--seed", "0"]


def phase_teacher_pm0() -> dict:
    """[teacher_pm0]: scripts/torch_teacher_pm0.py once on the card (about 100
    brick sweeps and as many two-site sweeps at N=64, M=16): the models on the
    card, the accuracies finite, the brick wall above the two-site sweep."""
    import importlib.util

    t0 = time.perf_counter()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_teacher_pm0.py")
    spec = importlib.util.spec_from_file_location("torch_teacher_pm0", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    reset_counts()
    out = script.main(TEACHER_PM0_ARGS)
    seconds = time.perf_counter() - t0
    res = out["results"]
    accs = [v for r in res.values() for v in r["val_acc"] + [r["test_acc"]]]
    ok = (all(d.startswith("cuda") for d in out["model_devices"].values())
          and np.isfinite(accs).all()
          and res["brickwall"]["test_acc"] > res["twosite"]["test_acc"])
    print(f"[teacher_pm0] scripts/torch_teacher_pm0.py {' '.join(TEACHER_PM0_ARGS)} on "
          f"{out['device_name']}: {seconds:.1f} s; models on {out['model_devices']}; test "
          f"accuracy brick wall {res['brickwall']['test_acc']:.4f}, two-site sweep "
          f"{res['twosite']['test_acc']:.4f} (the JAX package on the CPU: 0.5244 and 0.1468, "
          f"results/teacher_pm0.json); kernel launches {sum(counts().values())} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("[teacher_pm0]: models off the card, non-finite accuracies or the brick wall "
             "not above the two-site sweep")
    return {"seconds": seconds, "brick": res["brickwall"]["test_acc"],
            "twosite": res["twosite"]["test_acc"]}


T_START = time.perf_counter()
OTHER_CSRC = None  # --other-csrc: a csrc directory whose kernels are timed beside these


def main() -> None:
    global OTHER_CSRC
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one CUDA card and check it.")
    ap.add_argument("--other-csrc", help="time K3, K7, K2, K1, K8, K4a, K4b and K5 built from "
                    "this csrc directory beside this build's, and hold K7, K8, the 3xTF32 K4a and "
                    "K4b and K5 to its bits (e.g. the parent commit's)")
    OTHER_CSRC = ap.parse_args().other_csrc
    kind = phase_device()
    phase_build()
    requests, _ = pooled(BIG, seed=SEED)
    x_big = torch.as_tensor(requests, device=DEVICE)
    x_tr, y_tr = pooled(TRAIN_BATCHES * BATCH, seed=SEED + 2)
    x_val, y_val = pooled(BATCH, seed=SEED + 3)
    x_fresh, y_fresh = (torch.as_tensor(a, device=DEVICE) for a in pooled(BATCH, seed=SEED + 4))
    mps = product_init(torch.Generator().manual_seed(SEED), N=N, M=M, D=D, L=L,
                       act_fn="linear", loss_fn="MSE", calibration_x=requests[:512])
    if mps.device.type != "cuda":
        fail(f"product_init placed the model on {mps.device}, not on the card")
    print(f"[model] product_init N={N} M={M} D={D} L={L} on {mps.device} (the default), "
          f"{mps.sites.numel() * 4 / 1e6:.1f} MB of sites")
    captured = capture_step(mps, torch.as_tensor(x_tr[:BATCH], device=DEVICE),
                            torch.as_tensor(y_tr[:BATCH], device=DEVICE), CAPTURE_STEP)
    errs = phase_kernel(mps, x_big, captured)
    serve = phase_serve(mps, requests)
    launches = {("right_env_chain", B): n for B, n in serve["launches"].items()}
    prof = phase_profiling(mps, requests)
    launches["polar_iterate"], train_batch_s = phase_train(mps, x_tr, y_tr, x_val, y_val,
                                                           x_fresh)
    hybrid = phase_hybrid(mps, x_tr, y_tr, x_fresh)
    launches["two_site_presplit"] = hybrid["two_site_presplit"]
    launches[("right_env_stack_chain", M)] = hybrid["right_env_stack_chain"]
    xb = torch.as_tensor(x_tr[:BATCH], device=DEVICE)
    yb = torch.as_tensor(y_tr[:BATCH], device=DEVICE)
    wide, wide_errs, wide_cap, wide_launched = phase_hybrid_wide(requests, xb, yb, x_fresh)
    for name in ("two_site_presplit", "polar_iterate", "right_env_stack_chain"):
        launches[(name, M_WIDE)] = wide_launched[name]
    errs[("two_site_presplit", M_WIDE)] = wide_errs["two_site_presplit"]
    errs[("polar_iterate", M_WIDE)] = wide_errs[("polar_iterate", M_WIDE)]
    errs["two_site_step"] = phase_step_kernels(captured)
    launches["two_site_step"] = phase_fused(mps, x_tr, y_tr, x_fresh)["two_site_step"]
    launches["polar_sketch_gram"] = phase_two_stage(
        captured["bmat"], M, f"flagship step {CAPTURE_STEP}")["polar_sketch_gram"]
    errs.update(phase_polar_split_kernels(captured, wide_cap))
    launches.update(phase_polar_split(captured, wide_cap))

    errs["rangefinder_split"] = phase_rangefinder_kernels(captured)
    rf_trained, launches["rangefinder_split"], rf_batch_s = phase_rangefinder_train(mps)
    phase_rangefinder_sweep(mps, xb, yb, x_fresh, y_fresh)
    phase_canonical(requests, rf_trained, x_fresh)
    phase_small_splits()
    phase_data()
    teacher = phase_teacher()
    cli = phase_cli(x_fresh)

    big = large_model(requests)
    if big.device.type != "cuda":
        fail(f"product_init placed the M={M_LARGE} model on {big.device}, not on the card")
    print(f"[model] product_init N={N} M={M_LARGE} D={D} L={L} on {big.device}, "
          f"{big.sites.numel() * 4 / 1e6:.1f} MB of sites")
    large = capture_large(big, xb, yb)
    errs.update(phase_large_kernels(large, captured))
    launches[("polar_sketch_gram", M_LARGE)] = phase_two_stage(
        large["bmat"], M_LARGE, f"M={M_LARGE} step {CAPTURE_STEP}",
        against_f64=True)["polar_sketch_gram"]
    large_batch_s = phase_large_train(big, x_tr, y_tr, x_val, y_val)
    launched = phase_large_sweep(big, xb, yb, x_fresh, y_fresh)
    launches["gramfree_sketch"] = launched["gramfree_sketch"]
    launches["gramfree_gmul"] = launched["gramfree_gmul"]

    ms = phase_timing(mps, requests, x_big, captured, x_tr, y_tr)
    ms.update(phase_rangefinder_timing(mps, captured, xb, yb))
    ms.update(phase_large_timing(big, large, captured, xb, yb))
    ms.update(phase_wide_timing(wide, xb, yb, wide_cap))

    brick = phase_brickwall(x_tr, y_tr, x_fresh)
    onesite = phase_onesite(x_tr, y_tr, x_fresh)
    prec = phase_precision(mps, big, large, xb, yb, x_fresh, y_fresh, brick, onesite)
    for name in ("gramfree_sketch_tf32", "gramfree_gmul_tf32"):
        launches[name], errs[name], ms[name] = (prec["launches"][name], prec["errs"][name],
                                                prec["ms"][name])
    teacher_pm0 = phase_teacher_pm0()
    autodiff = phase_autodiff(mps, brick["model"], x_tr, y_tr)
    ensemble = phase_ensemble(teacher["task"])
    ens_key = ("right_env_chain", BATCH, ensemble["M"])
    launches[ens_key], errs[ens_key], ms[ens_key] = (
        ensemble["launches"], ensemble["err"], ensemble["ms"])
    mesh = phase_mesh(mps, x_tr, y_tr, x_fresh, requests)
    ref = phase_reference(mps, requests, serve, cli, xb, yb, x_fresh)
    examples = phase_examples()
    late_trace(prof)

    pe = (len(polar_split._pe_schedule(*polar_split._PE_LOOP)),
          len(polar_split._pe_schedule(*polar_split._PE_FINAL)))
    I_big, J_big = large["bmat"].shape
    work = {
        ("right_env_chain", BATCH): chain_work(N - 1, M, BATCH),
        ("right_env_chain", BIG): chain_work(N - 1, M, BIG),
        ("right_env_stack_chain", M): stack_work(N, M, BATCH),
        ("right_env_stack_chain", M_WIDE): stack_work(N, M_WIDE, BATCH),
        "polar_iterate": polar_work(M * D, M, *pe),
        "two_site_presplit": presplit_work(L, M * D, M, D * M, BATCH, M),
        "gramfree_sketch": sketch_work(I_big, J_big, M_LARGE, False),
        "gramfree_gmul": gmul_work(I_big, J_big, M_LARGE),
        "gramfree_sketch_tf32": sketch_work(I_big, J_big, M_LARGE, False),
        "gramfree_gmul_tf32": gmul_work(I_big, J_big, M_LARGE),
        "polar_sketch_gram": sketch_work(M * D, L * D * M, M, True),
        "rangefinder_split": rf_work(M * D, L * D * M, min(M + 8, M * D), M),
        "two_site_step": step_work(L, M, BATCH, pe),
        "polar_split": polar_split_work(M * D, L * D * M, M, pe),
        ("polar_split", M_WIDE): polar_split_work(M_WIDE * D, L * D * M_WIDE, M_WIDE, pe),
    }
    work[("polar_sketch_gram", M_LARGE)] = sketch_work(I_big, J_big, M_LARGE, True)
    work[ens_key] = chain_work(N - 1, ensemble["M"], BATCH)
    work[("polar_iterate", M_WIDE)] = polar_work(M_WIDE * D, M_WIDE, *pe)
    work[("two_site_presplit", M_WIDE)] = presplit_work(L, M_WIDE * D, M_WIDE, D * M_WIDE, BATCH,
                                                        M_WIDE)
    # K4a, K4b and K5 run in 3xTF32 on the tensor cores: their bound is the
    # tensor part three times over at the TF32 rate; K8's is its K5 stage's so
    # and K1's float32 iteration; the float32 bound is printed beside it
    tensor_core = ("gramfree_sketch", "gramfree_gmul", "polar_sketch_gram",
                   ("polar_sketch_gram", M_LARGE), "polar_split", ("polar_split", M_WIDE))
    k8_shapes = {"polar_split": (M * D, L * D * M, M),
                 ("polar_split", M_WIDE): (M_WIDE * D, L * D * M_WIDE, M_WIDE)}

    # K4a and K4b's one-pass form: the tensor part once at the TF32 rate
    one_pass = ("gramfree_sketch_tf32", "gramfree_gmul_tf32")

    def bound(name):
        if name in k8_shapes:
            return k8_bound_ms(*k8_shapes[name], pe)
        if name in one_pass:
            return bound_ms(*work[name], TF32_FLOPS)
        return (tc_bound_ms if name in tensor_core else bound_ms)(*work[name])

    for name, (flops, nbytes) in work.items():
        b_ms, b_by = bound_ms(flops, nbytes)
        label = (name if isinstance(name, str) else
                 f"{name[0]} B={name[1]}" + (f" M={name[2]}" if len(name) > 2 else "")
                 if name[0] == "right_env_chain" else
                 f"{name[0]} M={name[1]}")
        line = (f"[bound] {label}: {flops:.3g} FLOP, {nbytes:.3g} bytes -> f32 bound "
                f"{b_ms * 1e3:.2f} us ({b_by}) at {F32_FLOPS / 1e12:g} TFLOP/s and "
                f"{HBM_BYTES / 1e12:g} TB/s")
        if name in tensor_core:
            t_ms, t_by = bound(name)
            line += (f"; 3xTF32 bound {t_ms * 1e3:.2f} us ({t_by}) at {TC_PASSES} x the tensor "
                     f"part and {TF32_FLOPS / 1e12:g} TFLOP/s; kernel {ms[name][0] * 1e3:.1f} us, "
                     f"3xTF32 bound / kernel = {t_ms / ms[name][0]:.3f}")
        elif name in one_pass:
            t_ms, t_by = bound(name)
            line += (f"; one-pass TF32 bound {t_ms * 1e3:.2f} us ({t_by}) at "
                     f"{TF32_FLOPS / 1e12:g} TFLOP/s; kernel {ms[name][0] * 1e3:.1f} us, "
                     f"TF32 bound / kernel = {t_ms / ms[name][0]:.3f}")
        elif name in ms:
            line += f"; kernel {ms[name][0] * 1e3:.1f} us, bound / kernel = {b_ms / ms[name][0]:.4f}"
        print(line)
    rows = []
    for name, source, replaces, key in (
        ("right_env_chain", "env_scan.cu", "tensornetworkforml_tpu/ops/kernels/env_scan.py:29",
         ("right_env_chain", BATCH)),
        ("right_env_chain", "env_scan.cu", "tensornetworkforml_tpu/ops/kernels/env_scan.py:29",
         ("right_env_chain", BIG)),
        ("right_env_chain", "env_scan.cu", "tensornetworkforml_tpu/ops/kernels/env_scan.py:29",
         ens_key),
        ("right_env_stack_chain", "env_scan.cu", "none (an XLA scan in the JAX package's sweep)",
         ("right_env_stack_chain", M)),
        ("right_env_stack_chain", "env_scan.cu", "none (an XLA scan in the JAX package's sweep)",
         ("right_env_stack_chain", M_WIDE)),
        ("polar_iterate", "polar_iterate.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:566", "polar_iterate"),
        ("polar_iterate", "polar_iterate.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:566", ("polar_iterate", M_WIDE)),
        ("two_site_presplit", "presplit.cu",
         "tensornetworkforml_tpu/ops/kernels/presplit_kernel.py:69", "two_site_presplit"),
        ("two_site_presplit", "presplit.cu",
         "tensornetworkforml_tpu/ops/kernels/presplit_kernel.py:69",
         ("two_site_presplit", M_WIDE)),
        ("gramfree_sketch", "polar_sketch.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:321", "gramfree_sketch"),
        ("gramfree_gmul", "polar_sketch.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:334", "gramfree_gmul"),
        ("gramfree_sketch_tf32", "polar_sketch.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:321", "gramfree_sketch_tf32"),
        ("gramfree_gmul_tf32", "polar_sketch.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:334", "gramfree_gmul_tf32"),
        ("polar_sketch_gram", "polar_sketch.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:551", "polar_sketch_gram"),
        ("polar_sketch_gram", "polar_sketch.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:551", ("polar_sketch_gram", M_LARGE)),
        ("rangefinder_split", "rangefinder_split.cu",
         "tensornetworkforml_tpu/ops/kernels/split_kernel.py:157", "rangefinder_split"),
        ("two_site_step", "two_site_step.cu",
         "tensornetworkforml_tpu/ops/kernels/step_kernel.py:85", "two_site_step"),
        ("polar_split", "polar_iterate.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:192", "polar_split"),
        ("polar_split", "polar_iterate.cu",
         "tensornetworkforml_tpu/ops/kernels/polar_split.py:192", ("polar_split", M_WIDE)),
    ):
        b_ms, b_by = bound(key if key in work else name)
        row = {
            "name": name,
            "route": "cuda",
            "source": f"tensornetworkforml_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[key if key in launches else name],
            "max_abs_err": errs[key if key in errs else name],
            "ms": ms[key][0],
            "plain_ms": ms[key][1],
            "bound_ms": b_ms,
            "bound_by": b_by,
            # K1, K2, K3, K6, K7 and K8: no single PyTorch call computes what
            # they compute
            "library_ms": ms[key][2],
        }
        if name == "right_env_chain":
            m_chain = key[2] if len(key) > 2 else M  # the ensemble's direct sum at M = 80
            row["shape"] = f"n={N - 1} M={m_chain} B={key[1]}"
            row["form"] = chain_form(m_chain, key[1])
            # this K3 beside the other build's, timed in turns, where --other-csrc
            # named one (at the flagship's M)
            row["parent_ms"] = ms.get(("parent", key[1])) if m_chain == M else None
            if key == ("right_env_chain", BATCH):  # Predictor(mesh=...) in a world of one
                row["launches_mesh"] = mesh["serve_launches"]
            if m_chain == M:  # Predictor.from_checkpoint of the flagship's .dat
                row["launches_dat"] = ref["launches"][key[1]]
        elif name == "right_env_stack_chain":  # the sweep's prologue, one launch a sweep
            row["shape"] = f"n={N} M={key[1]} B={BATCH}"
            row["form"] = chain_form(key[1], BATCH)
        elif ("parent", key) in ms:  # the other build's, timed in turns
            row["parent_ms"] = ms[("parent", key)]
        if name == "two_site_step":  # at M=256 B=64 (K1 at I = 512 inside)
            row["ms_m256_b64"] = ms["two_site_step_wide"]
            row["parent_ms_m256_b64"] = ms.get(("parent", "two_site_step_wide"))
        if name == "polar_sketch_gram":
            row["shape"] = (f"I={I_big} J={J_big} q={M_LARGE}"
                            if key == ("polar_sketch_gram", M_LARGE)
                            else f"I={M * D} J={L * D * M} q={M}")
            if key == "polar_sketch_gram":  # K5's first sweep: dist_split="polar"
                row["launches_dist_sweep"] = mesh["dist_launches"]
        if name == "two_site_presplit":
            m = M_WIDE if key == ("two_site_presplit", M_WIDE) else M
            row["shape"] = f"L={L} I={m * D} DM={D * m} Mk={m} B={BATCH} q={m}"
        if name == "polar_split":
            row["shape"] = "I={} J={} q={}".format(*k8_shapes[key])
        if name == "polar_iterate":
            m = M_WIDE if key == ("polar_iterate", M_WIDE) else M
            row["shape"] = f"I={m * D} q={m}"
            row["form"] = k1_form(m * D, m)
            if m == M:  # K1's launches on the teacher student's, the CLIs' and the mesh paths
                row["launches_teacher"] = teacher["launches"]
                row["launches_cli"] = cli["launches"]
                row["launches_dp"] = mesh["dp_launches"]
                row["launches_dist_sweep"] = mesh["dist_k1_launches"]
                row["launches_cli_dp"] = mesh["cli"]["launches"]
        if key in tensor_core or name in tensor_core:  # the float32 bound beside the 3xTF32 one
            row["bound_fp32_ms"] = bound_ms(*work[key if key in work else name])[0]
            row["bound_share"] = b_ms / ms[key][0]
        if name in one_pass:  # gramfree_split(precision=PRECISION) at M=512
            row["shape"] = f"I={I_big} J={J_big} q={M_LARGE}"
            row["form"] = "one-pass TF32"
            row["ms_3xtf32"] = ms[name][3]
            row["bound_share"] = b_ms / ms[name][0]
        if name in ("polar_iterate", "two_site_presplit", "two_site_step") and key == name:
            # the flagship sweep under PRECISION on the engine that runs it
            engine = {"polar_iterate": "xla", "two_site_presplit": "hybrid",
                      "two_site_step": "fused"}[name]
            row[f"launches_{PRECISION}_sweep"] = prec["sweeps"][engine]["launches"][name]
        rows.append(row)
    print(f"[summary] ms per sweep {ms['sweep']}; train_model {train_batch_s * 1e3:.1f} "
          f"ms/batch; rangefinder sweep {ms['rf_sweep']:.1f} ms, its train_model "
          f"{rf_batch_s * 1e3:.1f} ms/batch; M={M_LARGE} ms per sweep {ms['large_sweep']}; "
          f"M={M_LARGE} train_model {large_batch_s * 1e3:.1f} ms/batch; M={M_WIDE} ms per sweep "
          f"{ms['wide_sweep']}; teacher task built in {teacher['card_s']:.3f} s on the card and "
          f"{teacher['cpu_s']:.3f} s on the CPU, its student {teacher['ms_per_batch']:.1f} "
          f"ms/batch, test acc {teacher['test_acc']:.4f}; training_mnist CLI "
          f"{cli['ms_per_batch']:.1f} ms/batch at B={CLI_BATCH}, val acc {cli['val_acc']:.4f}, "
          f"test acc {cli['test_acc']:.4f}; brick-wall CLI {brick['ms_per_batch']:.1f} ms/batch "
          f"(val {brick['val_acc']:.4f}, test {brick['test_acc']:.4f}), brick sweep "
          f"{brick['sweep_ms']:.1f} ms; one-site CLI {onesite['ms_per_batch']:.1f} ms/batch (val "
          f"{onesite['val_acc']:.4f}, test {onesite['test_acc']:.4f}), one-site sweep "
          f"{onesite['sweep_ms']:.1f} ms, at N={ONESITE_LONG_N} M={ONESITE_LONG_M} "
          f"{onesite['long_ms']:.1f} ms; autodiff step {autodiff['step_ms']:.1f} ms; ensemble "
          f"step {ensemble['step_ms']:.1f} ms, test acc {ensemble['test_acc']:.4f}; "
          f"data-parallel sweep {mesh['dp_ms']:.1f} ms (world of one; in turns "
          f"{mesh['turns_ms']['mesh']:.1f} against sweep_once's {mesh['turns_ms']['single']:.1f}), "
          f"dist-polar sweep {mesh['dist_ms']:.1f} ms, --dp CLI {mesh['cli']['ms_per_batch']:.1f} "
          f"ms/batch; [reference] {ref['seconds']:.1f} s, [profiling] {prof['seconds']:.1f} s, "
          f"[precision] {prec['seconds']:.1f} s (flagship sweeps under {PRECISION!r}: "
          + ", ".join(f"{e} {v['ms']:.1f} ms against IEEE {v['ms_ieee']:.1f}"
                      for e, v in prec["sweeps"].items())
          + f"), [teacher_pm0] {teacher_pm0['seconds']:.1f} s (test accuracy brick wall "
          f"{teacher_pm0['brick']:.4f}, two-site {teacher_pm0['twosite']:.4f}); "
          f"[examples] {examples['seconds']:.1f} s (example 02's K3 launches "
          f"{examples['k3_launches']}); {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
