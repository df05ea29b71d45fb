"""Smoke run of the PyTorch port (fast3r_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``fast3r_torch/csrc`` and
``fast3r_torch/ops`` and runs its phases, synchronising after each and
printing each one's seconds:

  1. device: the card's name and power limit, torch / CUDA versions, the
     kernel build time and what ptxas reports for every kernel; for the
     Hopper kernels (``fused_gemm_kernel<PRO, EPI, WIDE>``, ``ln_mlp_kernel<C>``,
     the attention forward's ``attention_fwd_kernel`` and the bf16 ring
     ``ring_attention_fwd_kernel``, the attention backward's
     ``attention_bwd_dq_kernel`` and ``attention_bwd_dkv_kernel`` and the
     bf16 backward rings ``ring_bwd_dq_kernel<bf16>`` and
     ``ring_bwd_dkv_kernel<bf16>``) their registers, spills and dynamic
     shared memory, and the counts of HGMMA (wgmma) and UTMALDG (TMA load)
     instructions in their SASS (``cuobjdump -sass`` on the built library),
     each of which must be above 0; for the resize (K12,
     ``resize_bilinear_kernel``, bulk and 2-byte-copy roads) and the
     LayerNorm forward (K7, ``ln_fwd_kernel<dtype, chunks, threads a row>``
     and ``ln_fwd_scalar_kernel``) their registers, spills and shared
     memory and the counts of bulk copies (UBLKCP, above 0 on the bulk
     road), barriers (BAR, none on the warp-per-row roads) and 16-byte
     stores in their SASS;
  2. kernels: each kernel against its plain PyTorch version on the card at
     the flagship forward's and training step's shapes, in float32 (tight
     tolerance, where the kernel has an fp32 variant) and bfloat16 (the
     served and trained type), with max
     abs / rel errors, median CUDA-event times of the kernel, of the plain
     version and of the PyTorch library calls that compute the same
     function (named in each line), and the kernel's bound: the larger of
     its FLOPs over the card's 989 TFLOP/s bf16 peak and its bytes (inputs
     read once, outputs written once) over 3.35 TB/s.  The attention
     forward's encoder line (20 views x 768 tokens) is also the plain
     road's batched attention.  Each bf16 attention-forward line (K1 on
     the decoder and encoder shapes, K2 from the packed buffer) also
     carries the kernel's device time (profiler) and TFLOP/s over its two
     products, SDPA's device time, the exp floor (one exponential a
     (query, key) pair over 132 SMs x 16 a clock at the card's maximum SM
     clock) and its time with one CTA per 128-query item in place of the
     persistent walk.  The LayerNorm forward's and the resize's lines
     (the resize on the head's chunk of the 20-view 512x512 request and of
     the mixed request's 448x512 group, and on one view of each) also carry
     the kernel's and the library call's device times (profiler), host
     times a call (host clock over 1000 calls, 100 for the request shapes,
     without a synchronise) and the bound's share of the device time.
     The training kernels: the LayerNorm
     backward, the attention backward on the decoder shape (held against
     the plain version one head at a time: its score matrices would not
     fit at once) and from the encoder's packed buffer, each line with its
     dq and dk/dv kernels' device times (profiler) and their TFLOP/s over
     the products each runs (3 and 4), and the LN -> GEMM replay on the
     qkv, RoPE and fc1 GELU products.  The
     whole-MLP kernel's line also carries its two-kernel road's time, its
     clock64 shares (fc1, fc2 and statistics items, waits) and its time with
     the h ring past the L2 (120 slots instead of 16).  The
     llama decoder's RMS -> GEMM kernels (K13) at its shapes (M = 15360,
     K = 1024): ``rms_qkv3`` (N = 3072, and 1536 with 4 kv heads),
     ``rms_matmul`` with SiLU (w1) and without (w3) at N = 2816, the RMS
     replay (y, u, rstd and z) on the qkv, w1 and w3 products, and
     ``matmul_residual`` at w2's K = 2816;
  3. requests: the flagship model with random weights (seed 0) in bfloat16
     serves ``fast3r_torch.inference`` requests at 512x384 on three paths,
     the launch counts set to 0 just before each path and read just after:
       * fused (the default, fused-GEMM blocks): 2, 8 and 20 views, twice
         each;
       * plain (the plain block road, fused_blocks=False): 20 views, twice;
       * two-kernel MLP (fused blocks with PREFER_FUSED_MLP = False): 8
         views, once;
     outputs must be finite, of the right shapes, with conf >= 1, and no
     kernel input copied for want of a layout its tensor map reads
     (``tma_view.copies`` 0 on every path); each request's line carries
     its forward's FLOPs (``utils/flops.py``) over its wall as TFLOP/s;
  4. end to end: the same weights in float32 on the CPU (the plain
     versions) and in bfloat16 on the card, on the fused and on the plain
     road, answer one 2-view 224x224 request; every output must agree
     within the stated tolerance;
  5. training: the same flagship weights in bfloat16 (and bf16 moments)
     take 4 ``train_step``s of 20 views at 512x384 (remat,
     ``OptimConfig(warmup_steps=2, total_steps=1000)``) on a fixed
     ``make_dummy_batch`` batch on the fused road, then 2 on the plain road
     and 2 on the two-kernel MLP road, the launch counts set to 0 just
     before each road and read just after; every loss and gradient norm
     must be finite and no step skipped;
  6. training end to end: one 2-view 224x224 batch, the loss and each
     top-level group's gradient in bfloat16 on the card (fused and plain
     road) against float32 on the CPU (the plain versions);
  7. llama requests: the ``llama_dec`` model (the flagship with its decoder
     replaced by the 1024 x 24 llama decoder, 653,572,488 parameters),
     random weights (seed 0) in bfloat16, serves 20 views at 512x384 twice
     on the fused road and once on the decoder's plain road
     (``fused_blocks=False`` in the decoder), counts reset and read per
     road;
  8. llama end to end: phase 4 for the llama model;
  9. llama training: 3 ``train_step``s of 20 views on the fused road, each
     step's time and the peak memory;
  10. llama training end to end: phase 6 for the llama model;
  11. a square request: the flagship (random weights, seed 0, bfloat16,
     fused road) serves 20 views at 512x512 twice, the head on its unfused
     road, so the trunk kernel must launch 0 times and the resize kernel
     (K12) once per head call; then once with ``profiling=True`` at
     512x512 and at 384x512 (the trunk kernel's road);
  12. a mixed request: 8 views at 384x512, 6 at 512x384 and 6 at 448x512 in
     one request; the trunk kernel must launch for the first two shape
     groups' heads only and K12 for the third's only;
  13. the head end to end at a K12 shape: ``dpt_head_forward`` on one
     512x512 view from seeded hook tokens, bf16 on the card (unfused road,
     K12) against fp32 on the CPU;
  14. images to poses: ``fast3r_torch.cli.reconstruct --gif`` on 6 seeded
     1152x1008 PNGs (448x512 views) on the card, its poses.json, scene.ply
     and orbit.gif (24 frames of 640x480) checked and each stage timed;
     ``inference_from_raw`` against ``load_images`` + ``inference`` on the
     same frames; pose recovery on the card against fp32 on the CPU for
     the same predictions (a seeded scene of three known cameras at
     224x256) and minimal samples; a 20-view 384x512 seeded scene of
     focals from 0.7 to 2.4 times the width solved with "individual"
     focals (a focal search a view), timed, every view's focal within two
     grid steps of its truth; the focal search on 8 such views (3% of the
     pixels confident; 25,600 hypotheses, the eigh in chunks) on the card
     against fp32 on the CPU on the same samples, within one grid step;
  15. the ring kernel (K14's forward, ``csrc/ring_attention.cu``) at the
     decoder's shape (15,360 tokens, 16 heads, head dim 64, bf16) over n =
     1, 2, 3, 4 and 8 ranks on the card, and the self-ring (n = 1, 4
     epochs), each against the plain ring (held one head at a time): o
     within the attention tolerance, the natural-log lse within 1e-3 (the
     self-ring's shifted by ln 4); the fp32 variant at n = 4 within 2e-5;
     its time, device time, TFLOP/s and exp floor at every n beside K1's
     device time on the gathered sequence, and at n = 4 the plain ring's,
     K1's and SDPA's times over the whole gathered sequence, and the
     bound; then the same at head_dim 80, model_scaling_huge's shape (20
     views at 224x224: 3920 tokens, 16 heads; n = 3 takes 3 x 1306) over
     n = 1, 2, 3, 4 and 8 in bf16 and n = 4 in fp32, each line with the
     ring's time, K1<80>'s and SDPA's on the gathered sequence and the
     bound, at n = 4 the ring's device time and the plain ring's time;
  16. the sequence-sharded request: ``make_seq_sharded_forward`` over 4
     ranks with the ring kernel serves the flagship (random weights, seed
     0, bf16) 20 views at 384x512, once cold and twice warm, counts reset
     just before and read just after (24 ring launches and no decoder
     attention-kernel launch per request); its outputs within 2% (relative
     L2) of the single-device forward on the card with the same weights and
     decoder block road (also timed, warm), and a 2-view 224x224 request
     over 2 ranks within 5% of fp32 on the CPU;
  17. the backward ring kernels (K14's backward: the dq and dk/dv rings,
     ``csrc/ring_attention_bwd.cu``) at the decoder's shape over n = 1, 2,
     3, 4 and 8 ranks in bf16 and at n = 4 in fp32, against
     ``ring_attention_bwd_ref``
     (held one head at a time), each ring's time and TFLOP/s over the
     products it runs (dq 3, dk/dv 4) and the pair's; at n = 4 the plain
     version's time, K9's and the autograd of SDPA on the gathered
     sequence, and the bounds; then the same at head_dim 80 (phase 15's
     model_scaling_huge shape) at every n, each line with K9<80>'s and
     SDPA's autograd times, at n = 4 the plain version's;
  18. the sequence-sharded training step: three
     ``make_seq_sharded_train_step`` steps of 20 views over 4 ranks (ring
     kernels, remat), counts reset just before and read just after (K14
     forward 48, each backward ring 24, decoder K1 / K9 0 per step), each
     step's time and the peak memory; and one 2-view 224x224 step's loss
     and gradients within 5% of fp32 on the CPU (phase 6's reference: the
     same weights, batch and image ids) and of the single-device card step;
  19. training from the command line: a CO3D-format root written with PIL
     and numpy (two orbiting sequences of 100 frames, one of 640x480
     frames, one alternating 640x480 and 480x640; JPEG, 16-bit PNG depth,
     PNG masks, .npz cameras), then ``fast3r_torch.cli.train --experiment
     super_long_training`` (the flagship at full width, 647,551,368
     parameters, 20 views a sample at the five resolutions with aug_crop
     and ColorJitter) with its own Co3d entries retargeted to that root (6
     training samples from 3 ``spawn`` workers, started while the model
     builds; 2 validation samples of 10 views, loaded inline), one epoch,
     on fp32 master weights and moments with a bf16 working copy:
       * run 1 in a subprocess, sent SIGUSR1 once metrics.csv has a row,
         must save checkpoints/last and exit 0;
       * run 2 in this process with ``--resume`` (``train_step`` wrapped to
         print each step's resolution, orientation flag, seconds and loader
         wait; the checkpoint's save and load timed, its size and the peak
         memory printed; counts reset just before and read just after)
         must train fp32 params and moments through a bf16 copy, continue
         run 1's step count,
         finish the epoch at two or more resolutions with a
         mixed-orientation batch among them, and validate with the pose
         suite;
     every logged loss finite, metrics.csv and TensorBoard events written,
     the validation row with the loss and the pose keys, and the
     training-only kernels (K7's backward, K9, K10, K11) launched exactly
     the steps taken times phase 5's launches a step;
  20. evaluation from the command line: a run directory of the flagship
     (random weights, seed 0, bfloat16; model_config.json,
     checkpoints/last.pt, config.yaml) and, under one data root written
     with PIL and numpy, the preset's four validation sets in their own
     layouts at their frame sizes (DTU 1600x1200 JPEG, .npy depth, PNG
     masks, MVSNet cams; 7-Scenes and NRGBD 640x480 PNG with 16-bit depth
     and their pose files; phase 19's CO3D root), cameras on a quarter
     orbit around a textured sphere, EVAL_VIEWS * kf_every frames a recon
     scene (the ones that the preset's kf_every reads written, the others
     links to them):
       * run 1: ``fast3r_torch.cli.eval --eval-config
         ablation_recon_better_inference_hp`` in this process, only
         ``data.data_root`` and the CO3D sample count changed; pose keys on
         CO3D only, recon keys on DTU / 7-Scenes / NRGBD only, every value
         finite; each forward (10 views) launching K1 and K2 24 times, K8
         or K12 as ``head_road`` picks for its view shape, and no backward
         kernel; each set's forward seconds, peak memory and suite seconds
         by stage (alignment, similarity fit, normals, nearest-neighbour
         queries, the pose suite);
       * run 2: ``evaluate_reconstruction`` on a 10-view 512x384 DTU
         sample whose predictions are its ground truth moved by known
         similarities (conf 1): accuracy and completion below 1e-4 of the
         scene's extent, normal consistencies above 0.99, and the CPU's
         dict within 1e-5 (distances: of the extent); each stage's seconds;
       * run 3: ``fast3r_torch.cli.re10k_pose_eval`` on 2 scenes of 10
         640x360 JPEGs with RealEstate10K txt files of known cameras (512x288
         views): finite RRA / RTA / mAA for both, K8 or K12 as
         ``head_road`` picks;
       * run 4: ``fast3r_torch.cli.robustmvd_eval --data-root`` on 2
         scenes of 5 512x384 PNGs with .npy depth: finite absrel and
         inliers_1.03;
  21. master weights and dropout: phase 3's weights as fp32 master weights
     on the card take one ``train_step`` of phase 6's 2-view 224x224 batch
     and image ids through the bf16 working copy at lr 1e-6: the loss and
     each top-level group's gradient (the first moment over 1 - b1) within
     phase 6's 5% of fp32 on the CPU, every LayerNorm scale of the master
     moved, the copy the master rounded to bf16, and each forward and
     training kernel of phase 5's fused road launched as many times as a
     step of it; the same step on the bf16 road, the LayerNorm scales it
     moved printed; the optimizer's update alone on each road, timed
     beside its bytes' bound; two dropout steps (encoder drop and
     drop_path 0.1, decoder drop, attn_drop and drop_path 0.1) finite, on
     the plain road (no fused kernel launched, its road printed); the
     seven legacy losses of ``train/losses.py`` at 384x512 on the card
     against the CPU (1e-4 relative);
  22. the DINOv2 model (the ViT-L/14 encoder of ``DinoEncoderConfig()``, the
     flagship's decoder and heads at patch 14; random weights seed 0,
     bfloat16, 648,820,104 parameters) serves a 20-view 392x518 request
     twice and a mixed request (10 x 392x518, 10 x 518x392: the encoder's
     portrait branch) twice, counts reset before and read after each path;
     each view shape's head road (``head_road``) printed and its kernel
     (K8 or K12) required; a 2-view 224x224 request in bf16 on the card
     (fused and plain roads) within 5% relative L2 of fp32 on the CPU;
  23. one DINOv2-model training step, 8 views at 224x224, on fp32 master
     weights with a bf16 working copy (remat), finite, its launches
     counted;
  24. the model_scaling overlays (``configs/experiment/model_scaling``:
     base 768 x 12 decoder at 12 heads, large 1024 x 24 at 16, huge 1280 x
     32 at 16, head_dim 80), each built through ``config.py`` at full
     width (random weights seed 0): an 8-view 224x224 request in bf16
     twice, three ``train_step``s of batch 8 x 8 views at 224x224 on fp32
     master weights (remat; step seconds, peak memory), a 2-view step's
     loss and gradients against fp32 on the CPU (phase 6's 5%); then
     ``fast3r_torch.cli.train --experiment model_scaling/model_scaling_huge``
     in this process on a CO3D-format root (phase 19's writer), its
     datasets cut to the Co3d entries (24 training samples: 3 steps of
     batch 8; 2 validation samples), one epoch, every loss finite, the
     master-weights road;
  25. the widened kernels against their plain versions under the
     tolerances of their head_dim-64 / width-1024 checks: K1 at head_dim
     80 on the huge decoder's (8, 1568, 16, 80) in fp32 and bf16 and at
     head_dim 64 on the DINO encoder's 1037-token views (a ragged key
     tile); K9 at (8, 1568, 16, 80); K12 on the DINO requests' heads (20 x
     224x296 -> 392x518, 10 x 296x224 -> 518x392) and K8 at 224x224
     (patch 14: 8 x 128x128; patch 16: 64 x 112x112); the fused GEMMs
     (ln_qkv, ln_matmul GELU, the replay on fc1 and qkv, matmul_residual on
     proj and fc2) and the whole-MLP kernel at widths 768 and 1280 (M =
     12544 rows, hidden 4 x width), each with its library call's time and
     its bound; the kernel summary lists each of these shapes as an entry
     of its own, with its launches on the paths that run it;
  26. launch counts: every kernel of a path must have launched on it, the
     RMS kernels on no path but the llama fused road's, K12 on no path of
     384x512 views, the trunk kernel on no path of 512x512 or 448x512
     views, the ring kernels on no path but the sequence-sharded ones, the
     CroCo encoder's kernels on no path of the DINO model's, no backward
     kernel on a serving path of phases 22-24; no layout copy on a serving
     path;
  27. the mesh step: the kernels at a model-2 rank's shapes (M = 6144
     rows, 8 heads: K4 / K3 / K11 at qkv N = 1536, K11 fc1 N = 2048, K5
     proj K = 512 and K6 hidden 2048 as each rank's partial output, the
     bias (b2) on model rank 0 and zero on rank 1, the residual added
     after the ranks' sum, K2 / K10 on (3, 8, 768, 512), K1 / K9 at (1,
     6144, 8, 64)) against their plain versions; super_long_training's model
     (its encoder and decoder cut to 8 blocks at full width) for 3 steps on the one-process Trainer road (fp32 master, bf16
     working copy) on global batches of 2 x 8 views at 512x384, then on a
     data 2 x model 2 grid of four processes sharing the card over gloo
     (ZeRO-2 master and moment shards, tensor-parallel stacks; gloo's
     collectives on the card's tensors), each rank's step seconds, seconds in
     collectives and peak memory printed; each rank's loss within 1% of
     the one-process road's, each top-level group's update within 2%
     relative L2 or twice the distance between the one-process step's
     fused and plain roads (its rounding floor), each rank's launch counts
     equal to the one-process road's, its decoder block's params at the
     model-2 slice shapes; then one step of the mesh Trainer at world size
     1 over NCCL;
  28. the variants tensor-parallel: the kernels at a model-2 rank's
     llama_dec shapes (M = 3072 rows: K13 ``rms_qkv3`` at N 1536,
     ``rms_matmul`` and its replay at N 1408, whose last 128 x 256 tile is
     half full, K5's partial products on wo K 512 and w2 K 1408, K1 / K9
     at (1, 3072, 8, 64)) and DINO's (K1 / K9 at 8 heads
     over 257 tokens, K1 over 1037) against their plain versions; then
     llama_dec, the DINOv2 model and the flagship with the encoder's
     drop_path 0.1 (its blocks on the plain road), each cut to 8 blocks an
     encoder and a decoder at full width, each for 2 steps of 1
     sample of 4 views (512x384; DINO 224x224) on the one-process Trainer
     road (fp32 master, bf16 working copy) and on a road differing in
     rounding only (the plain block roads), then on a data 1 x model 2
     grid of two processes sharing the card over gloo (for DINO first one
     forward of 2 views at 392x518, 1037 tokens at 8 heads): each step's
     loss within 1e-4 relative of the one-process road's, each group's
     update within phase 27's rule, the DINO forward within 2% relative
     L2, each rank's launches equal to the one-process road's, a llama
     rank's layer at the model-2 slice shapes; each rank's step seconds,
     seconds in collectives and peak memory printed;
  29. (run after phase 24, on its model) model_scaling_huge
     sequence-sharded (1280 x 32, 16 heads of 80, the ring kernels at
     head_dim 80; bf16): a 20-view 224x224 request over 4 ranks, once cold
     and once warm (32 ring launches a request, no decoder K1), within 2%
     relative L2 of the single-device forward on the same decoder road;
     2 ``make_seq_sharded_train_step`` steps of 1 x 8 views at 224x224
     over 4 ranks (K14 forward 64, each backward ring 32, decoder K1 / K9
     0 a step); a 2-view 224x224 step over 2 ranks within 5% of fp32 on
     the CPU (phase 24's reference) and of the single-device card step;
  30. (run after phase 4, on phase 3's model) the interactive demo:
     ``fast3r_torch.serve.demo.create_demo`` on the fake gradio and viser of
     ``tests/torch_fake_ui.py`` (neither machine has the real ones); a
     reconstruct click on 20 seeded 512x384 JPEGs (phase 3's fused-road
     kernels, counted; a PLY and the speed report); the session's
     ``run_viser_server`` in this process on the click's output (40 clouds,
     20 frustums with finite poses, its controls driven, its GIF and PLY
     exported); the session manager on real spawned processes of a trivial
     target (started by the click, collected by its GC, stopped); with
     ``ffmpeg`` on PATH the JPEGs as an mp4 through the video input,
     without it the line ``ffmpeg absent: video input not driven``;
  31. (run after phase 30, on phase 3's model) 1000 views in one forward:
     ``fast3r_forward`` at 1000 x 256x192 (S = 192,000 decoder tokens)
     with the heads in chunks of 25 views, the counts set to 0 just
     before and read just after (K1 24, K2 24, K7 2 launches), every output
     finite, of its shape, conf >= 1, its wall and peak memory printed;
     the same views sequence-sharded over 4 ranks on the ring kernels
     within 2% relative L2 of it per output; then K3 / K4, K3 (q | k | v,
     fc1 GELU), K5 (proj, fc2), K6 and K7 at 512x384's M = 768,000 rows and
     K2 on (3, 1000, 768, 1024), each whole launch against its plain
     version on the rows where a 32-bit element offset would wrap (the
     first and last 1024 of each output and packed plane and 2048 seeded
     rows between; ``fast3r_torch/kernels/rows.py``), and K1 at S =
     768,000 and K14's forward over 4 ranks at S_loc = 192,000 on the same
     q, k, v, each on 256 query rows a head against the plain attention of
     those rows over all keys (o and lse), and K8 on one 25-view head chunk
     of 512x384 against its plain version, each with its time, bound and
     library call's time; the kernel summary lists each as an entry.

Any failure raises (exit code 1).  Without a CUDA device the script exits
with code 2 before printing any result.  The last line of standard output
is ``{"ok": true, "device": {...}}``; the line before it holds the card's
name and power limit, and before that one JSON line describes each kernel.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import PIL.Image

import torch
import torch.nn.functional as F

from fast3r_torch import Fast3R, Fast3RConfig, fast3r_forward, inference
from fast3r_torch.cli import reconstruct
from fast3r_torch.data.dummy import make_dummy_batch
from fast3r_torch.eval.pose import estimate_camera_poses, individual_focals
from fast3r_torch.eval.recon import align_local_pts3d_to_global
from fast3r_torch.inference import inference_from_raw
from fast3r_torch.kernels import build
from fast3r_torch.kernels.rows import MANY_VIEW_TOKENS, check_rows, query_rows
from fast3r_torch.models.decoder import sample_random_image_ids
from fast3r_torch.models.dino_encoder import DinoEncoderConfig
from fast3r_torch.models.dpt_head import dpt_head_forward, head_road
from fast3r_torch.models.fast3r import empty_fast3r, init_fast3r
from fast3r_torch.models.llama_decoder import LlamaDecoderConfig
from fast3r_torch.nn import fused_block as fb
from fast3r_torch.ops.batched_attention import (
    packed_qkv_attention,
    packed_qkv_attention_bwd,
)
from fast3r_torch.ops.flash_attention import (
    attention_bwd,
    attention_bwd_ref,
    attention_fwd_lse,
    attention_ref,
    attention_rows_lse_ref,
    flash_attention,
    launch_attention,
    tma_view,
)
from fast3r_torch.ops.fused_layernorm import (
    fused_layernorm,
    layernorm_bwd,
    layernorm_bwd_ref,
    layernorm_ref,
)
from fast3r_torch.ops.pnp import EIGH_BATCH, NUM_FOCALS, draw_samples
from fast3r_torch.ops.resize import resize_matmul
from fast3r_torch.ops.resize_kernel import resize_bilinear_kernel
from fast3r_torch.ops.rope2d import (
    expand_rope_tables,
    rope2d_cos_sin,
    rotate_half_lanes,
)
from fast3r_torch.ops.trunk_kernel import _plain_head, fused_regression_head_t
from fast3r_torch.parallel.ring_rdma import (
    _bwd_rows,
    _rdma_forward,
    _ring_backward,
    ring_attention_bwd_dkv,
    ring_attention_bwd_dq,
    ring_flash_attention_rdma,
)
from fast3r_torch.parallel.sequence import (
    make_seq_sharded_forward,
    make_seq_sharded_train_step,
    ring_attention_bwd_ref,
    ring_flash_attention,
    seq_sharded_config,
)
from fast3r_torch.train import losses as train_losses
from fast3r_torch.train.losses import conf_loss_multiview_v2
from fast3r_torch.train.step import (
    OptimConfig,
    _adamw_update,
    init_train_state,
    refresh_working_copy,
    train_step,
)
from fast3r_torch.utils.flops import fast3r_forward_flops
from fast3r_torch.utils.image import load_images, load_images_raw

DEC_SCALE = 0.125 * math.sqrt(math.log(137) / math.log(20))
PEAK_FLOPS = {torch.bfloat16: 989e12,  # H100 SXM: dense bf16 tensor cores
              torch.float32: 67e12}    # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12                   # H100 SXM HBM3
M_TOK, C, HID = 15360, 1024, 4096  # 20 views x 768 tokens; width; MLP hidden
L_HID = 2816  # the llama FFN hidden: round_up(int(2 * 4 * 1024 / 3), 256)

# Tolerances, elementwise |kernel - plain| <= atol + rtol * |plain|.
#  * float32: both sides compute in fp32 and differ only in summation order
#    (and in fast-math exp2 / rsqrt), so a few 1e-6 relative at most.
#  * bfloat16: attention rounds p to bf16 before p @ v where the plain version
#    rounds the normalised weights (both 2^-8 relative per weight, averaged
#    over the keys) and both round the output once; LayerNorm outputs round
#    once from fp32 values that differ in the last fp32 bits (at most one bf16
#    step, 2^-7 relative); the trunk's plain version rounds to bf16 after
#    conv1, the resize matrices, the resize, conv2 and conv3 while the kernel
#    accumulates everything in fp32, so its bound is taken on max |plain|.
TOL = {
    ("attention", torch.float32): dict(atol=1e-4, rtol=0.0),
    ("attention", torch.bfloat16): dict(atol=4e-3, rtol=2 ** -7),
    ("layernorm", torch.float32): dict(atol=1e-4, rtol=1e-5),
    ("layernorm", torch.bfloat16): dict(atol=1e-2, rtol=2 ** -7),
    ("trunk", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("trunk", torch.bfloat16): dict(atol_of_max=0.03, rtol=0.0),
    # the fused-GEMM kernels (bf16 only): the plain versions round at the
    # same points and differ in summation order, so outputs land at most
    # one bf16 step apart (2^-7 relative), plus a bf16 intermediate (LN
    # output, q / k before RoPE, the MLP's h) on the other side of a step
    # on outputs of magnitude ~1-10
    ("fused_gemm", torch.bfloat16): dict(atol=2e-2, rtol=2 ** -7),
    ("ln_mlp", torch.bfloat16): dict(atol=2e-2, rtol=2 ** -7),
    # training kernels (bf16).  The attention backward's plain version
    # rounds p and ds to bf16 at the kernel's points, from the same o and
    # lse; a p or ds on the other side of a bf16 step moves a gradient,
    # a sum over up to 15360 keys, by a small fraction of its largest value,
    # so the bound is taken on max |plain|.  The LayerNorm backward's dx and
    # the replay's u round once from fp32 values that differ in summation
    # order (one bf16 step); its product and z as the fused-GEMM kernels;
    # the fp32 dweight / dbias sums over 15360 rows in another order.
    ("attention_bwd", torch.bfloat16): dict(atol_of_max=2e-2, rtol=2 ** -7),
    ("layernorm_bwd", torch.bfloat16): dict(atol=1e-2, rtol=2 ** -7),
    ("layernorm_bwd", torch.float32): dict(atol=1e-4, rtol=1e-5),
    ("layernorm_bwd_w", torch.bfloat16): dict(atol_of_max=1e-4, rtol=0.0),
    ("replay_u", torch.bfloat16): dict(atol=1e-2, rtol=2 ** -7),
    ("replay_stats", torch.bfloat16): dict(atol=1e-6, rtol=1e-5),
    # the resize kernel rounds at the plain version's two points (the H
    # pass and the W pass, each a 2-tap fp32 sum); a value within an fp32
    # rounding of a bf16 tie lands one step away: one bf16 step at the
    # output's largest magnitude
    ("resize", torch.bfloat16): dict(bf16_steps_of_max=1, rtol=0.0),
    # the ring kernel's o: the attention kernel's tolerances above (fp32:
    # summation order only, held to 2e-5); its lse: fp32 logsumexp of the
    # same scores (natural log), within 1e-3
    ("ring", torch.float32): dict(atol=2e-5, rtol=0.0),
    ("ring", torch.bfloat16): dict(atol=4e-3, rtol=2 ** -7),
    ("ring_lse", torch.float32): dict(atol=1e-3, rtol=0.0),
    ("ring_lse", torch.bfloat16): dict(atol=1e-3, rtol=0.0),
    # the backward rings in fp32: summation order only (over up to 15360
    # keys or queries), on max |plain|; in bf16 they are held to the
    # attention backward's bound above
    ("ring_bwd", torch.float32): dict(atol_of_max=1e-4, rtol=0.0),
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float, dtype=torch.bfloat16) -> dict:
    """The least time the card could take: FLOPs at the card's peak for
    their type or bytes at the HBM rate, whichever is larger."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "flops": flops, "bytes": nbytes}


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(kind: str, out: torch.Tensor, ref: torch.Tensor, dtype) -> dict:
    a, b = out.float(), ref.float()
    if a.shape != b.shape:
        raise AssertionError(f"{kind}: shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not torch.isfinite(a).all():
        raise AssertionError(f"{kind}: kernel output is not finite")
    tol = TOL[(kind, dtype)]
    err = (a - b).abs()
    top = b.abs().max().item()
    atol = tol.get("atol", 0.0) + tol.get("atol_of_max", 0.0) * top
    if "bf16_steps_of_max" in tol:  # one step = 2^(exponent - 7)
        atol += tol["bf16_steps_of_max"] * 2.0 ** (math.floor(math.log2(top)) - 7)
    bound = atol + tol["rtol"] * b.abs()
    max_abs = err.max().item()
    max_rel = (err / b.abs().clamp(min=1e-6)).max().item()
    ok = bool((err <= bound).all())
    if not ok:
        raise AssertionError(
            f"{kind} {dtype}: max abs err {max_abs:.3e} exceeds tolerance {tol}")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "atol": atol,
            "rtol": tol["rtol"]}


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def _sass_tool() -> str:
    """cuobjdump from the CUDA toolkit, or the copy Triton ships."""
    import shutil

    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump"), shutil.which("cuobjdump")]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("cuobjdump not found")


def _kernel_label(mangled: str):
    """fused_gemm_kernel<1, 3, 0>, ln_mlp_kernel<1024>, attention_fwd_kernel,
    ring_bwd_dkv_kernel<bf16>, ... from a mangled name (matched with its
    length prefix, so attention_fwd_kernel is not ring_attention_fwd_kernel);
    None for a kernel that is not on wgmma and TMA (the fp32 variants, the
    others)."""
    if "17trunk_conv_kernel" in mangled:  # conv1 <1>, conv2 <2>
        return f"trunk_conv_kernel<{1 if 'ILi1E' in mangled else 2}>"
    if "fused_gemm_kernel" in mangled:
        import re

        tail = mangled.split("fused_gemm_kernel", 1)[1].split("EE", 1)[0]
        modes = re.findall(r"L[ib](\d+)E", tail + "E")  # prologue, epilogue, wide
        return f"fused_gemm_kernel<{', '.join(modes)}>"
    if "ln_mlp_kernel" in mangled:  # one instantiation a width
        return "ln_mlp_kernel<" + mangled.split("ln_mlp_kernel", 1)[1].split(
            "ILi", 1)[1].split("E", 1)[0] + ">"
    for label in ATTN_KERNELS:
        name = label.split("<")[0]
        if f"{len(name)}{name}" in mangled and (
                "<" not in label or "bfloat16" in mangled):
            # K1, K9 and K14 at head_dim 80 (the model_scaling_huge decoder)
            if "Li80E" not in mangled:
                return label
            return label[:-1] + ", 80>" if "<" in label else f"{label}<80>"
    return None


# the attention kernels on the wgmma tiles: the forward's
# (attention_fwd_tile.cuh: K1, and K14's forward in bf16) and the
# backward's (attention_bwd_tile.cuh: K9, and K14's backward in bf16)
ATTN_KERNELS = {"attention_fwd_kernel": "fwd", "ring_attention_fwd_kernel": "ring_fwd",
                "attention_bwd_dq_kernel": "bwd", "attention_bwd_dkv_kernel": "bwd",
                "ring_bwd_dq_kernel<bf16>": "bwd", "ring_bwd_dkv_kernel<bf16>": "bwd"}
# the head_dim-80 instantiations of K1's, K9's and K14's kernels
ATTN_KERNELS_80 = {"attention_fwd_kernel<80>": "fwd80",
                   "attention_bwd_dq_kernel<80>": "bwd80",
                   "attention_bwd_dkv_kernel<80>": "bwd80",
                   "ring_attention_fwd_kernel<80>": "ring_fwd80",
                   "ring_bwd_dq_kernel<bf16, 80>": "bwd80",
                   "ring_bwd_dkv_kernel<bf16, 80>": "bwd80"}


# K8's two launches (csrc/trunk.cu): conv1, and conv2 with the resize and
# conv3
TRUNK_KERNELS = {"trunk_conv_kernel<1>": "trunk1", "trunk_conv_kernel<2>": "trunk2"}


def hopper_kernel_report(blog: str, sass: str) -> dict:
    """ptxas's registers and spills of every fused_gemm_kernel and
    ln_mlp_kernel instantiation, of the attention kernels on the wgmma
    tiles (forward: K1, the bf16 ring; backward: K9's two, the bf16 rings)
    and of the trunk's (K8: conv1, conv2),
    their dynamic shared memory, and the counts of HGMMA (wgmma) and UTMALDG
    (TMA load) instructions in their SASS; raises if any of them has none of
    either, or if one of the attention kernels is missing."""
    report, name = {}, None
    for line in blog.splitlines():
        if "Function properties for" in line:
            name = _kernel_label(
                line.split("Function properties for", 1)[1].strip())
            if name:
                report[name] = {"ptxas": []}
        elif name and ("spill" in line or "Used" in line):
            report[name]["ptxas"].append(line.split("info    :")[-1].strip())
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_label(line.split("Function :", 1)[1].strip())
            if name:
                report.setdefault(name, {"ptxas": []}).update(HGMMA=0,
                                                              UTMALDG=0)
        elif name:
            for op in ("HGMMA", "UTMALDG"):
                if op in line:
                    report[name][op] += 1
    missing = [n for n in (*ATTN_KERNELS, *ATTN_KERNELS_80, *TRUNK_KERNELS)
               if n not in report]
    if not report or missing:
        raise AssertionError(f"Hopper kernels missing from the library: "
                             f"{missing or 'all'}")
    lib = build.library()
    smem = {"fwd": lib.fast3r_attention_fwd_smem_bytes(),
            "ring_fwd": lib.fast3r_ring_attention_fwd_smem_bytes(),
            "ring_fwd80": lib.fast3r_ring_attention_fwd_smem_bytes_d80(),
            "bwd": lib.fast3r_attention_bwd_smem_bytes(),
            "fwd80": lib.fast3r_attention_fwd_smem_bytes_d80(),
            "bwd80": lib.fast3r_attention_bwd_smem_bytes_d80(),
            "gemm": lib.fast3r_gemm_smem_bytes(),
            "trunk1": lib.fast3r_trunk_smem_bytes(1),
            "trunk2": lib.fast3r_trunk_smem_bytes(2)}
    for name, r in sorted(report.items()):
        r["smem"] = smem[{**ATTN_KERNELS, **ATTN_KERNELS_80}.get(
            name, TRUNK_KERNELS.get(name, "gemm"))]
        log(f"hopper kernel {name}: {'; '.join(r['ptxas'])}; dynamic shared "
            f"memory {r['smem']} bytes; SASS HGMMA {r.get('HGMMA', 0)}, "
            f"UTMALDG {r.get('UTMALDG', 0)}")
        if not r.get("HGMMA") or not r.get("UTMALDG"):
            raise AssertionError(f"{name}: no HGMMA or no UTMALDG in its SASS")
    return report


def _simple_label(mangled: str):
    """resize_bilinear_kernel<bulk> / <2-byte copies>, ln_fwd_kernel<bf16,
    4, 32> (dtype, chunks a thread, threads a row), ln_fwd_scalar_kernel<f32>,
    ln_bwd_kernel<bf16, 4> (dtype, chunks a lane), ln_bwd_cta_kernel<f32,
    8>, ln_bwd_scalar_kernel<bf16>, ln_bwd_sum_kernel from a mangled name;
    None for the other kernels."""
    if "resize_bilinear_kernel" in mangled:
        bulk = "ILb1E" in mangled
        return f"resize_bilinear_kernel<{'bulk' if bulk else '2-byte copies'}>"
    if "17ln_bwd_sum_kernel" in mangled:
        return "ln_bwd_sum_kernel"
    for name in ("ln_fwd_kernel", "ln_fwd_scalar_kernel", "ln_bwd_kernel",
                 "ln_bwd_cta_kernel", "ln_bwd_scalar_kernel"):
        if f"{len(name)}{name}" in mangled:
            tail = mangled.split(name, 1)[1].split("EEv", 1)[0]
            args = ["bf16" if "bfloat16" in tail else "f32"]
            args += [a.split("E")[0] for a in tail.split("Li")[1:]]
            return f"{name}<{', '.join(args)}>"
    return None


def simple_kernel_report(blog: str, sass: str) -> dict:
    """ptxas's registers, spills and static shared memory of the resize
    (K12) and LayerNorm (K7, forward and backward) kernels, with counts from
    their SASS:
    bulk copies (UBLKCP) and barrier instructions (BAR) and 16-byte global
    stores (STG.E.128); plus the resize's dynamic shared memory at the
    512x512 head's plan.  Raises if a kernel is missing, if the bulk resize
    has no bulk copy, or if a warp-per-row LayerNorm road has a barrier."""
    from fast3r_torch.ops.resize_kernel import band_plan

    report, name = {}, None
    for line in blog.splitlines():
        if "Function properties for" in line:
            name = _simple_label(line.split("Function properties for", 1)[1].strip())
            if name:
                report[name] = {"ptxas": []}
        elif name and ("spill" in line or "Used" in line):
            report[name]["ptxas"].append(line.split("info    :")[-1].strip())
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _simple_label(line.split("Function :", 1)[1].strip())
            if name:
                report.setdefault(name, {"ptxas": []}).update(
                    UBLKCP=0, BAR=0, STG128=0)
        elif name:
            report[name]["UBLKCP"] += "BLKCP" in line
            report[name]["BAR"] += " BAR." in line
            report[name]["STG128"] += "STG.E.128" in line
    want = ["resize_bilinear_kernel<bulk>", "resize_bilinear_kernel<2-byte copies>",
            "ln_fwd_kernel<bf16, 4, 32>", "ln_fwd_kernel<f32, 8, 32>",
            "ln_fwd_kernel<f32, 8, 512>", "ln_fwd_scalar_kernel<bf16>",
            "ln_bwd_kernel<bf16, 4>", "ln_bwd_kernel<f32, 8>",
            "ln_bwd_cta_kernel<f32, 8>", "ln_bwd_scalar_kernel<bf16>",
            "ln_bwd_sum_kernel"]
    missing = [n for n in want if n not in report]
    if missing:
        raise AssertionError(f"kernels missing from the library: {missing}")
    plan = band_plan(256, 256, 512, 512)
    for name, r in sorted(report.items()):
        extra = (f"; dynamic shared memory {plan.smem_bytes} bytes at the "
                 f"512x512 head's plan" if name.startswith("resize") else "")
        log(f"hopper kernel {name}: {'; '.join(r['ptxas'])}{extra}; SASS "
            f"UBLKCP {r.get('UBLKCP', 0)}, BAR {r.get('BAR', 0)}, "
            f"STG.E.128 {r.get('STG128', 0)}")
    if not report["resize_bilinear_kernel<bulk>"].get("UBLKCP"):
        raise AssertionError("resize_bilinear_kernel<bulk>: no bulk copy in "
                             "its SASS")
    barred = [n for n, r in report.items()
              if n.endswith(", 32>") and r.get("BAR")]
    if barred:
        raise AssertionError(f"barriers on the warp-per-row road: {barred}")
    return report


def phase_device() -> dict:
    log("== phase 1: device")
    line = gpu_line()
    log(f"gpu: {line}")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.library()
    t_build = time.perf_counter() - t0
    log(f"cuda kernels built and loaded in {t_build:.2f} s "
        f"({build.library_path().name})")
    blog = build.library_path().with_suffix(".log").read_text()
    for entry in blog.splitlines():  # registers / spills of every kernel
        if "registers" in entry or "spill" in entry or "Compiling" in entry:
            log("ptxas: " + entry.strip())
    sass = subprocess.run([_sass_tool(), "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    hopper_kernel_report(blog, sass)
    simple_kernel_report(blog, sass)
    torch.cuda.synchronize()
    return {"gpu": line, "build_s": t_build}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


EXP_PER_CLOCK = 16  # MUFU ex2 results a clock per SM (CUDA C++ guide, cc 9.0)


def _max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def _all_kernels_ms(fn, reps: int = 5) -> float:
    """Mean device time of one fn() call: every CUDA kernel it runs, summed,
    over reps calls under the profiler (a library call's own kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum((getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


def _batched_ms(fn, calls: int = 10) -> float:
    """CUDA-event time of ``calls`` back-to-back fn() calls over their
    count: the device time, with the wrappers' host time hidden behind the
    earlier launches."""
    return median_ms(lambda: [fn() for _ in range(calls)], 3) / calls


def fwd_rates(pairs: float, D: int, fn, kernel: str, library=None) -> dict:
    """An attention forward's device time, its TFLOP/s over its two products
    (4 D FLOPs a (query, key) pair) and its exp floor: one exponential a
    pair over the SMs' MUFU rate (EXP_PER_CLOCK a clock per SM) at the
    card's maximum SM clock; with ``library``, that call's device time too.
    The device time is the profiler's (the kernel named ``kernel``; the
    library call's kernels, all of them) unless it is below nine tenths of
    the time of back-to-back calls (``batched_ms``), which a profile that
    lost kernel records gives; then it is that time (``device_ms_from``)."""
    batched = _batched_ms(fn)
    dev, source = _device_ms(fn, {"k": kernel})["k"], "profiler"
    if dev < 0.9 * batched:
        dev, source = batched, "events"
    props = torch.cuda.get_device_properties(0)
    r = {"device_ms": dev, "device_ms_from": source, "batched_ms": batched,
         "tflops": 4.0 * D * pairs / (dev * 1e-3) / 1e12,
         "exp_floor_ms": pairs / (props.multi_processor_count * EXP_PER_CLOCK
                                  * _max_sm_clock_hz()) * 1e3}
    if library is not None:
        lib_batched = _batched_ms(library)
        lib = _all_kernels_ms(library)
        r["library_device_ms"] = lib if lib >= 0.9 * lib_batched else lib_batched
        r["library_batched_ms"] = lib_batched
    return r


def check_attention(results: list) -> None:
    shapes = [("encoder", (20, 768, 16, 64), 0.125),
              ("decoder", (1, 15360, 16, 64), DEC_SCALE)]
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, N, H, D), scale in shapes:
            g = _gen(1)
            qkv = torch.randn((B, N, 3, H, D), generator=g, device="cuda",
                              dtype=torch.float32).to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided views
            out = flash_attention(q, k, v, scale)
            ref = attention_ref(q, k, v, scale)
            torch.cuda.synchronize()
            r = compare("attention", out, ref, dtype)
            del ref
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if name == "encoder":  # also the plain road's batched attention
                r["tpu_kernel"] = ("fast3r_tpu/ops/batched_attention.py:443 "
                                   "_packed_bnhd -> _packed_kernel :340; :199 "
                                   "_run_kernel -> _batched_kernel :105")
            r.update(kernel="attention", case=f"{name} {B}x{N}x{H}x{D}",
                     dtype=str(dtype).split(".")[-1],
                     ms=median_ms(lambda: flash_attention(q, k, v, scale), 10),
                     plain_ms=median_ms(lambda: attention_ref(q, k, v, scale), 3),
                     library="F.scaled_dot_product_attention",
                     library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, scale=scale), 10),
                     **bound(4.0 * B * H * N * N * D,
                             4 * B * N * H * D * qkv.element_size(), dtype))
            if dtype == torch.bfloat16:  # the kernel on attention_fwd_tile.cuh
                r.update(fwd_rates(
                    float(B * H) * N * N, D,
                    lambda: flash_attention(q, k, v, scale), "attention_fwd_kernel",
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)))
                # the persistent walk against one CTA per 128-query item
                r["ms_one_cta_per_item"] = median_ms(lambda: launch_attention(
                    q, k, v, scale, ctas=B * H * -(-N // 128)), 10)
            results.append(r)
            log(json.dumps(r))
            del qkv, q, k, v, out, qt, kt, vt
            torch.cuda.empty_cache()


def _host_ms(fn, calls: int) -> float:
    """Host time a call: the host clock over ``calls`` calls made without a
    synchronise, over their count."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e3


def _launch_times(fn, kernel: str, library, calls: int) -> dict:
    """A kernel's device time (the profiler's, of the kernels whose name
    holds ``kernel``; back-to-back CUDA events where the profile has none),
    its host time a call (``_host_ms``), and the same two of the library
    call (all its kernels)."""
    dev, source = _device_ms(fn, {"k": kernel})["k"], "profiler"
    if dev <= 0:
        dev, source = _batched_ms(fn), "events"
    lib = _all_kernels_ms(library)
    return {"device_ms": dev, "device_ms_from": source,
            "batched_ms": _batched_ms(fn), "host_ms": _host_ms(fn, calls),
            "library_device_ms": lib if lib > 0 else _batched_ms(library),
            "library_batched_ms": _batched_ms(library),
            "library_host_ms": _host_ms(library, calls)}


def check_layernorm(results: list) -> None:
    """K7's forward (csrc/layernorm.cu) at the blocks' shape (15360, 1024),
    fp32 and bf16: single-launch, device and host times beside
    ``F.layer_norm``'s, the bound and the device time's share of it."""
    M = M_TOK
    for dtype in (torch.float32, torch.bfloat16):
        for eps in (1e-6, 1e-5):
            g = _gen(2)
            x = (torch.randn((M, C), generator=g, device="cuda") * 3 + 1).to(dtype)
            w = torch.randn((C,), generator=g, device="cuda").to(dtype)
            b = torch.randn((C,), generator=g, device="cuda").to(dtype)
            out = fused_layernorm(x, w, b, eps)
            ref = layernorm_ref(x, w, b, eps)
            torch.cuda.synchronize()
            r = compare("layernorm", out, ref, dtype)
            r.update(kernel="layernorm", case=f"{M}x{C} eps={eps:g}",
                     dtype=str(dtype).split(".")[-1],
                     ms=median_ms(lambda: fused_layernorm(x, w, b, eps), 20),
                     plain_ms=median_ms(lambda: layernorm_ref(x, w, b, eps), 20),
                     library="F.layer_norm",
                     library_ms=median_ms(lambda: F.layer_norm(
                         x, (C,), w, b, eps), 20),
                     **bound(8.0 * M * C, 2 * M * C * x.element_size(),
                             torch.float32),
                     **_launch_times(lambda: fused_layernorm(x, w, b, eps),
                                     "ln_fwd", lambda: F.layer_norm(
                                         x, (C,), w, b, eps), 1000))
            r["bound_share"] = r["bound_ms"] / r["device_ms"]
            results.append(r)
            log(json.dumps(r))


TRUNK_CASES = (  # (n, hh, wc, cin, H, W)
    (4, 192, 256, 256, 384, 512),    # the earlier row's case
    (20, 192, 256, 256, 384, 512),   # the 20-view request's chunk, twice a request
    (6, 256, 192, 256, 512, 384))    # the mixed request's portrait group


def _trunk_inputs(n, hh, wc, cin, dtype):
    g = _gen(3)

    def uni(shape, fan_in):
        bound_ = 1.0 / math.sqrt(fan_in)
        return ((torch.rand(shape, generator=g, device="cuda") * 2 - 1)
                * bound_).to(dtype)

    x = torch.randn((n, hh, wc, cin), generator=g, device="cuda").to(dtype)
    c1 = 128
    return x, (uni((c1, cin, 3, 3), 9 * cin), uni((c1,), 9 * cin),
               uni((c1, c1, 3, 3), 9 * c1), uni((c1,), 9 * c1),
               uni((4, c1, 1, 1), c1), uni((4,), c1))


TRUNK_LIBRARY = ("F.conv2d + F.interpolate(bilinear, align_corners) + "
                 "F.conv2d + F.relu + F.conv2d")


def _trunk_library(xc, w1, b1, w2, b2, w3, b3, H, W):
    """The trunk's function in library calls on NCHW ``xc`` (n, 4, H W)."""
    y = F.conv2d(xc, w1, b1, padding=1)
    y = F.interpolate(y, size=(H, W), mode="bilinear", align_corners=True)
    y = F.relu(F.conv2d(y, w2, b2, padding=1))
    return F.conv2d(y, w3, b3).reshape(xc.shape[0], 4, H * W)


def _trunk_flops(n, hh, wc, cin, H, W, c1=128) -> float:
    """conv1 at the input's size, conv2 and conv3 at the output's."""
    return 2.0 * (n * hh * wc * c1 * cin * 9
                  + n * H * W * (c1 * c1 * 9 + c1 * 4))


def check_trunk(results: list) -> None:
    """K8 (csrc/trunk.cu) against its plain version: fp32 and bf16 at n = 4,
    and in bf16 at the request's shapes, with device, single-launch and host
    times, TFLOP/s, the bound's share, and the port's unfused road at the
    same shape as a yardstick, its parts timed apart (cuDNN conv1, K12,
    cuDNN conv2 + ReLU + conv3; ``F.interpolate`` beside K12)."""
    for (n, hh, wc, cin, H, W), dtype in (
            [(TRUNK_CASES[0], torch.float32)]
            + [(c, torch.bfloat16) for c in TRUNK_CASES]):
        c1 = 128
        x, (w1, b1, w2, b2, w3, b3) = _trunk_inputs(n, hh, wc, cin, dtype)
        args = (w1, b1, w2, b2, w3, b3, H, W)
        xc = x.permute(0, 3, 1, 2)
        xn = xc.contiguous()  # the unfused road's NCHW input

        def plain():
            return _plain_head(xc, *args).reshape(n, 4, H * W)

        def library():
            return _trunk_library(xc, *args)

        out = fused_regression_head_t(x, *args)
        again = fused_regression_head_t(x, *args)
        ref = plain()
        torch.cuda.synchronize()
        r = compare("trunk", out, ref, dtype)
        if not torch.equal(out, again):
            raise AssertionError("trunk: two runs gave different bits")
        del ref, again
        flops = _trunk_flops(n, hh, wc, cin, H, W, c1)
        r.update(kernel="trunk", case=f"{n}x{hh}x{wc}x{cin} -> {H}x{W}",
                 dtype=str(dtype).split(".")[-1],
                 ms=median_ms(lambda: fused_regression_head_t(x, *args), 5),
                 plain_ms=median_ms(plain, 3),
                 library=TRUNK_LIBRARY, library_ms=median_ms(library, 5),
                 **bound(flops, (x.numel() + n * 4 * H * W) * x.element_size(),
                         dtype))
        if dtype == torch.bfloat16:
            r.update(_launch_times(
                lambda: fused_regression_head_t(x, *args), "trunk_conv",
                library, 20))
            r["tflops"] = flops / (r["device_ms"] * 1e-3) / 1e12
            r["bound_share"] = r["bound_ms"] / r["device_ms"]
        if dtype == torch.bfloat16 and n > 4:
            y1 = F.conv2d(xn, w1, b1, padding=1)
            yr = resize_bilinear_kernel(y1, H, W)
            parts = {
                "conv1": lambda: F.conv2d(xn, w1, b1, padding=1),
                "resize": lambda: resize_bilinear_kernel(y1, H, W),
                "conv2_relu_conv3": lambda: F.conv2d(
                    F.relu(F.conv2d(yr, w2, b2, padding=1)), w3, b3),
                "interpolate": lambda: F.interpolate(
                    y1, size=(H, W), mode="bilinear", align_corners=True)}
            for k, fn in parts.items():
                r[f"unfused_{k}_device_ms"] = _all_kernels_ms(fn)
            r["unfused_device_ms"] = sum(r[f"unfused_{k}_device_ms"] for k in
                                         ("conv1", "resize", "conv2_relu_conv3"))
            if r["device_ms"] >= r["unfused_device_ms"]:
                log(f"trunk {r['case']}: the kernel's {r['device_ms']:.3f} ms "
                    f"is not below the unfused road's "
                    f"{r['unfused_device_ms']:.3f} ms")
            del y1, yr
        results.append(r)
        log(json.dumps(r))
        del x, xc, xn, out
        torch.cuda.empty_cache()


def check_resize(results: list) -> None:
    """K12 at the regression trunk's shapes on the unfused road (bf16, 128
    channels): the head's whole chunk of the 20-view 512x512 request and of
    the mixed request's 448x512 group, as the main path launches it, and one
    view of each; single-launch, device and host times beside
    ``F.interpolate``'s, the bound and the device time's share of it."""
    bf = torch.bfloat16
    for shape, (H, W) in (((20, 128, 256, 256), (512, 512)),
                          ((6, 128, 224, 256), (448, 512)),
                          ((1, 128, 256, 256), (512, 512)),
                          ((1, 128, 224, 256), (448, 512))):
        x = torch.randn(shape, generator=_gen(9), device="cuda").to(bf)
        out = resize_bilinear_kernel(x, H, W)
        ref = resize_matmul(x, H, W)
        torch.cuda.synchronize()
        b, c, h, w = shape
        r = compare("resize", out, ref, bf)
        del ref

        def library():
            return F.interpolate(x, size=(H, W), mode="bilinear",
                                 align_corners=True)

        r.update(kernel="resize", case=f"{b}x{c}x{h}x{w} -> {H}x{W}",
                 dtype="bfloat16",
                 ms=median_ms(lambda: resize_bilinear_kernel(x, H, W), 20),
                 plain_ms=median_ms(lambda: resize_matmul(x, H, W), 5),
                 library="F.interpolate(bilinear, align_corners=True)",
                 library_ms=median_ms(library, 20),
                 # a 3-flop lerp per H-pass value (b c H w) and per output,
                 # in fp32 on the CUDA cores
                 **bound(3.0 * b * c * H * (w + W),
                         (x.numel() + out.numel()) * 2, torch.float32),
                 **_launch_times(lambda: resize_bilinear_kernel(x, H, W),
                                 "resize_bilinear", library,
                                 100 if b > 1 else 1000))
        r["bound_share"] = r["bound_ms"] / r["device_ms"]
        results.append(r)
        log(json.dumps(r))
        del x, out
        torch.cuda.empty_cache()


def _linear(n_out, n_in, g):
    bound_ = n_in ** -0.5
    w = ((torch.rand((n_out, n_in), generator=g, device="cuda") * 2 - 1)
         * bound_).to(torch.bfloat16)
    b = (torch.randn((n_out,), generator=g, device="cuda") * 0.02).to(
        torch.bfloat16)
    return w, b


def _record(results, kernel, kind, case, out, ref, fn, plain, library,
            library_name, flops, nbytes, reps=10, **extra):
    torch.cuda.synchronize()
    r = compare(kind, out, ref, torch.bfloat16)
    r.update(kernel=kernel, case=case, dtype="bfloat16",
             ms=median_ms(fn, reps), plain_ms=median_ms(plain, 3),
             library=library_name, library_ms=median_ms(library, reps),
             **bound(flops, nbytes), **extra)
    results.append(r)
    log(json.dumps(r))


def check_fused_blocks(results: list) -> None:
    """The fused-GEMM block kernels at the flagship's 20-view shapes: every
    product has M = 15360 rows (20 x 768 encoder tokens, or the decoder's
    fused sequence of the same length), C = 1024, hidden 4096."""
    g = _gen(4)
    bf = torch.bfloat16
    x = (torch.randn((M_TOK, C), generator=g, device="cuda") * 2 + 0.5).to(bf)
    gamma = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    beta = (0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    wqkv, bqkv = _linear(3 * C, C, g)
    wproj, bproj = _linear(C, C, g)
    w1, b1 = _linear(HID, C, g)
    w2, b2 = _linear(C, HID, g)
    # the encoder's RoPE tables: 20 views of 24 x 32 patches
    yy, xx = torch.meshgrid(torch.arange(24), torch.arange(32), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, -1, 2).repeat(20, 1, 1).cuda()
    cos, sin = rope2d_cos_sin(pos, 64)
    ct, st = expand_rope_tables(cos, sin, C, bf)
    it = 2  # bytes per bf16 element
    qkv_flops = 2.0 * M_TOK * C * 3 * C
    qkv_w_bytes = (3 * C * C + 3 * C + 2 * C) * it

    def ln_linear(w, b, eps):
        return F.linear(F.layer_norm(x, (C,), gamma, beta, eps), w, b)

    def library_rope():
        y = ln_linear(wqkv, bqkv, 1e-6)

        def rope(t):
            t = t.float()
            return (t * ct + rotate_half_lanes(t, 32) * st).to(bf)
        return torch.stack([rope(y[:, :C]), rope(y[:, C:2 * C]), y[:, 2 * C:]])

    args = (x, gamma, beta, wqkv, bqkv, ct, st, 16, 1e-6)
    _record(results, "ln_qkv_rope", "fused_gemm", f"{M_TOK}x{C} -> 3x{C}",
            fb.ln_qkv_rope(*args), fb.ln_qkv_rope_ref(*args),
            lambda: fb.ln_qkv_rope(*args), lambda: fb.ln_qkv_rope_ref(*args),
            library_rope, "F.layer_norm + F.linear + torch elementwise RoPE",
            qkv_flops, qkv_w_bytes + (M_TOK * C * 3 + 3 * M_TOK * C) * it)

    args = (x, gamma, beta, wqkv, bqkv, 1e-5)
    _record(results, "ln_qkv", "fused_gemm", f"{M_TOK}x{C} -> 3x{C}",
            torch.stack(fb.ln_qkv(*args)), torch.stack(fb.ln_qkv_ref(*args)),
            lambda: fb.ln_qkv(*args), lambda: fb.ln_qkv_ref(*args),
            lambda: ln_linear(wqkv, bqkv, 1e-5).split(C, dim=1),
            "F.layer_norm + F.linear", qkv_flops,
            qkv_w_bytes + (M_TOK * C + 3 * M_TOK * C) * it)

    args = (x, gamma, beta, w1, b1, 1e-6)
    _record(results, "ln_matmul", "fused_gemm", f"{M_TOK}x{C} -> {HID} gelu",
            fb.ln_matmul(*args, act="gelu"), fb.ln_matmul_ref(*args, act="gelu"),
            lambda: fb.ln_matmul(*args, act="gelu"),
            lambda: fb.ln_matmul_ref(*args, act="gelu"),
            lambda: F.gelu(ln_linear(w1, b1, 1e-6)),
            "F.layer_norm + F.linear + F.gelu", 2.0 * M_TOK * C * HID,
            (M_TOK * C + HID * C + HID + 2 * C + M_TOK * HID) * it)

    o = (torch.randn((M_TOK, C), generator=g, device="cuda") * 0.5).to(bf)
    args = (o, wproj, bproj, x)
    _record(results, "matmul_residual", "fused_gemm", f"proj {M_TOK}x{C} -> {C}",
            fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
            lambda: fb.matmul_residual(*args),
            lambda: fb.matmul_residual_ref(*args),
            lambda: F.linear(o, wproj, bproj) + x, "F.linear + add",
            2.0 * M_TOK * C * C, (3 * M_TOK * C + C * C + C) * it, reps=20)
    h = fb.ln_matmul(x, gamma, beta, w1, b1, 1e-6, act="gelu")
    args = (h, w2, b2, x)
    _record(results, "matmul_residual", "fused_gemm", f"fc2 {M_TOK}x{HID} -> {C}",
            fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
            lambda: fb.matmul_residual(*args),
            lambda: fb.matmul_residual_ref(*args),
            lambda: F.linear(h, w2, b2) + x, "F.linear + add",
            2.0 * M_TOK * HID * C, (M_TOK * HID + 2 * M_TOK * C + HID * C + C) * it)

    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)

    def two_kernel():
        hh = fb.ln_matmul(x, gamma, beta, w1, b1, 1e-6, act="gelu")
        return fb.matmul_residual(hh, w2, b2, x)

    # the kernel's clock64 tallies: the fc1 / fc2 / statistics items' shares
    # of the consumers' item time, and the waits for a free h slot, the next
    # item (consumers) and an fc1 band (producer) against the same total
    prof = torch.zeros(6, dtype=torch.int64, device="cuda")
    fb._ln_mlp(*args, prof=prof)
    t_fc1, t_fc2, t_slot, t_item, t_dep, t_stats = prof.tolist()
    busy = t_fc1 + t_fc2 + t_stats
    _record(results, "ln_mlp", "ln_mlp", f"{M_TOK}x{C}, hidden {HID}",
            fb.ln_mlp(*args), fb.ln_mlp_ref(*args),
            lambda: fb.ln_mlp(*args), lambda: fb.ln_mlp_ref(*args),
            lambda: x + F.linear(F.gelu(ln_linear(w1, b1, 1e-6)), w2, b2),
            "F.layer_norm + F.linear + F.gelu + F.linear + add",
            4.0 * M_TOK * C * HID,
            (2 * M_TOK * C + 2 * HID * C + HID + 3 * C) * it,
            two_kernel_ms=median_ms(two_kernel, 10),
            fc1_share=t_fc1 / busy, fc2_share=t_fc2 / busy,
            stats_share=t_stats / busy,
            # h through a 120-slot ring (120 MB, past the 50 MB L2) instead
            # of the default 16 (16 MB)
            ring_past_l2_ms=median_ms(lambda: fb._ln_mlp(*args, slots=120), 10),
            slot_wait_share=t_slot / busy, item_wait_share=t_item / busy,
            fc1_band_wait_share=t_dep / busy)
    del h, o

    # the encoder's attention, read in place from the packed qkv buffer
    B, N, H, D = 20, 768, 16, 64
    qkv3 = torch.randn((3, B, N, C), generator=g, device="cuda").to(bf)
    q, k, v = (qkv3[i].view(B, N, H, D) for i in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=0.125)  # noqa: E731
    _record(results, "packed_qkv_attention", "attention",
            f"(3, {B}, {N}, {C}), {H} heads",
            packed_qkv_attention(qkv3, H, 0.125),
            attention_ref(q, k, v, 0.125).reshape(B, N, C),
            lambda: packed_qkv_attention(qkv3, H, 0.125),
            lambda: attention_ref(q, k, v, 0.125), sdpa,
            "F.scaled_dot_product_attention", 4.0 * B * H * N * N * D,
            4 * B * N * C * it,
            **fwd_rates(float(B * H) * N * N, D,
                        lambda: packed_qkv_attention(qkv3, H, 0.125),
                        "attention_fwd_kernel", sdpa),
            ms_one_cta_per_item=median_ms(lambda: launch_attention(
                q, k, v, 0.125, ctas=B * H * -(-N // 128)), 10))


TRAIN_SCALE = 0.125  # head_dim ** -0.5: training has no entropy bias


def _rope_tables_20views(dtype):
    """The encoder's flat RoPE lane tables for 20 views of 24 x 32 patches."""
    yy, xx = torch.meshgrid(torch.arange(24), torch.arange(32), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, -1, 2).repeat(20, 1, 1).cuda()
    cos, sin = rope2d_cos_sin(pos, 64)
    return expand_rope_tables(cos, sin, C, dtype)


def _grad_ms(out, inputs, cot, reps: int) -> float:
    """Median time of one backward through a kept autograd graph."""
    return median_ms(lambda: torch.autograd.grad(out, inputs, cot,
                                                 retain_graph=True), reps)


def check_layernorm_bwd(results: list) -> None:
    """K7's backward (csrc/layernorm.cu) at the block shape (15360, 1024),
    bf16 and fp32: single-launch, device (both launches, partials
    included) and host times beside autograd of ``F.layer_norm``'s, the
    bound and the device time's share of it; two runs must give the same
    bits."""
    for dtype in (torch.bfloat16, torch.float32):
        g = _gen(5)
        eps = 1e-6
        x = (torch.randn((M_TOK, C), generator=g, device="cuda") * 3 + 1).to(dtype)
        w = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(dtype)
        b = (0.1 * torch.randn((C,), generator=g, device="cuda")).to(dtype)
        dy = torch.randn((M_TOK, C), generator=g, device="cuda").to(dtype)
        dx, dw, db = layernorm_bwd(x, w, dy, eps)
        again = layernorm_bwd(x, w, dy, eps)
        rdx, rdw, rdb = layernorm_bwd_ref(x, w, dy, eps)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip((dx, dw, db), again)):
            raise AssertionError("layernorm_bwd: two runs gave different bits")
        r = compare("layernorm_bwd", dx, rdx, dtype)
        rw = [compare("layernorm_bwd_w", u, v, torch.bfloat16)
              for u, v in ((dw, rdw), (db, rdb))]
        xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, b))
        y = F.layer_norm(xl, (C,), wl, bl, eps)

        def library():
            return torch.autograd.grad(y, (xl, wl, bl), dy, retain_graph=True)

        r.update(kernel="layernorm_bwd", case=f"{M_TOK}x{C}",
                 dtype=str(dtype).split(".")[-1],
                 max_abs_err_dweight_dbias=max(q["max_abs_err"] for q in rw),
                 ms=median_ms(lambda: layernorm_bwd(x, w, dy, eps), 20),
                 plain_ms=median_ms(lambda: layernorm_bwd_ref(x, w, dy, eps), 5),
                 library="autograd of F.layer_norm (dx, dweight, dbias)",
                 library_ms=_grad_ms(y, (xl, wl, bl), dy, 20),
                 **bound(16.0 * M_TOK * C,
                         3 * M_TOK * C * x.element_size()
                         + C * w.element_size() + 2 * C * 4, torch.float32),
                 # 200 calls (400 launches) stay inside the launch queue
                 **_launch_times(lambda: layernorm_bwd(x, w, dy, eps), "ln_bwd",
                                 library, 200))
        r["bound_share"] = r["bound_ms"] / r["device_ms"]
        results.append(r)
        log(json.dumps(r))
        del x, dy, dx, again, rdx, xl, y
        torch.cuda.empty_cache()


def _attn_bwd_bound(B, N, H, D):
    """2.5x the forward's 4 B H N^2 D FLOPs (five products); q, k, v, o, do
    read and dq, dk, dv written in bf16, lse and delta in fp32."""
    return bound(10.0 * B * H * N * N * D,
                 8 * B * N * H * D * 2 + 2 * B * H * N * 4)


def _device_ms(fn, names: dict, reps: int = 5, tries: int = 3) -> dict:
    """Mean device time a call of each kernel whose name contains
    names[key], over reps calls of fn under the profiler: {key: ms}.  A
    profile that lost a kernel's records (a 0) is taken again, up to
    ``tries`` profiles."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(names, 0.0)
        for evt in prof.key_averages():
            us = (getattr(evt, "self_device_time_total", 0)
                  or getattr(evt, "self_cuda_time_total", 0))
            for key, sub in names.items():
                if sub in evt.key:
                    out[key] += us / reps / 1e3
        if all(out.values()):
            break
    return out


def _pass_rates(B, N, H, D, ms: dict) -> dict:
    """The dq pass's and the dk/dv pass's device times and TFLOP/s over the
    products each runs: dq 3 (6 B H N^2 D FLOPs), dk/dv 4 (8); a pass whose
    records every profile lost is None (not measured)."""
    flops = {"dq": 6.0 * B * H * N * N * D, "dkv": 8.0 * B * H * N * N * D}
    return {**{f"{k}_ms": v or None for k, v in ms.items()},
            **{f"{k}_tflops": flops[k] / (v * 1e-3) / 1e12 if v else None
               for k, v in ms.items()}}


ATTN_BWD_PASSES = {"dq": "attention_bwd_dq_kernel",
                   "dkv": "attention_bwd_dkv_kernel"}


def _merge(errs: list) -> dict:
    return {"max_abs_err": max(e["max_abs_err"] for e in errs),
            "max_rel_err": max(e["max_rel_err"] for e in errs),
            "atol": max(e["atol"] for e in errs), "rtol": errs[0]["rtol"]}


def check_attention_bwd(results: list) -> None:
    """The attention backward at the training step's shapes (scale
    head_dim ** -0.5), from the forward kernel's o and lse: the decoder's
    (1, 15360, 16, 64) strided views, held against the plain version one
    head at a time, and the encoder's packed (3, 20, 768, 1024) buffer."""
    bf = torch.bfloat16
    B, N, H, D = 1, M_TOK, 16, 64
    g = _gen(6)
    qkv = torch.randn((B, N, 3, H, D), generator=g, device="cuda").to(bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, N, H, D), generator=g, device="cuda").to(bf)
    o, lse = attention_fwd_lse(q, k, v, TRAIN_SCALE)
    got = attention_bwd(q, k, v, o, lse, do, TRAIN_SCALE)
    torch.cuda.synchronize()

    def plain_head(h):
        sl = slice(h, h + 1)
        return attention_bwd_ref(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                 o[:, :, sl], lse[:, sl], do[:, :, sl],
                                 TRAIN_SCALE)

    errs = [compare("attention_bwd", a[:, :, h:h + 1], ref, bf)
            for h in range(H) for a, ref in zip(got, plain_head(h))]
    torch.cuda.empty_cache()
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, scale=TRAIN_SCALE)
    r = dict(_merge(errs), kernel="attention_bwd",
             case=f"decoder {B}x{N}x{H}x{D}", dtype="bfloat16",
             ms=median_ms(lambda: attention_bwd(q, k, v, o, lse, do,
                                                TRAIN_SCALE), 10),
             plain_ms=median_ms(lambda: [plain_head(h) for h in range(H)], 1),
             plain="attention_bwd_ref, one head at a time",
             library="autograd of F.scaled_dot_product_attention",
             library_ms=_grad_ms(ol, (ql, kl, vl), do.transpose(1, 2), 10),
             **_pass_rates(B, N, H, D, _device_ms(
                 lambda: attention_bwd(q, k, v, o, lse, do, TRAIN_SCALE),
                 ATTN_BWD_PASSES)),
             **_attn_bwd_bound(B, N, H, D))
    results.append(r)
    log(json.dumps(r))
    del qkv, q, k, v, do, o, lse, got, ql, kl, vl, ol
    torch.cuda.empty_cache()

    B, N = 20, 768
    qkv3 = torch.randn((3, B, N, C), generator=g, device="cuda").to(bf)
    q, k, v = (qkv3[i].view(B, N, H, D) for i in range(3))
    do = torch.randn((B, N, C), generator=g, device="cuda").to(bf)
    o, lse = attention_fwd_lse(q, k, v, TRAIN_SCALE)
    got = packed_qkv_attention_bwd(qkv3, o, lse, do, H, TRAIN_SCALE)
    ref = attention_bwd_ref(q, k, v, o, lse, do.view(B, N, H, D), TRAIN_SCALE)
    torch.cuda.synchronize()
    errs = [compare("attention_bwd", got[i], ref[i].reshape(B, N, C), bf)
            for i in range(3)]
    del ref
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, scale=TRAIN_SCALE)
    r = dict(_merge(errs), kernel="packed_qkv_attention_bwd",
             case=f"(3, {B}, {N}, {C}), {H} heads", dtype="bfloat16",
             ms=median_ms(lambda: packed_qkv_attention_bwd(
                 qkv3, o, lse, do, H, TRAIN_SCALE), 10),
             plain_ms=median_ms(lambda: attention_bwd_ref(
                 q, k, v, o, lse, do.view(B, N, H, D), TRAIN_SCALE), 2),
             library="autograd of F.scaled_dot_product_attention",
             library_ms=_grad_ms(ol, (ql, kl, vl),
                                 do.view(B, N, H, D).transpose(1, 2), 10),
             **_pass_rates(B, N, H, D, _device_ms(
                 lambda: packed_qkv_attention_bwd(qkv3, o, lse, do, H,
                                                  TRAIN_SCALE),
                 ATTN_BWD_PASSES)),
             **_attn_bwd_bound(B, N, H, D))
    results.append(r)
    log(json.dumps(r))
    torch.cuda.empty_cache()


def check_replay(results: list) -> None:
    """The replay launch of fused_gemm.cu (the forward that also writes u,
    mean, rstd and, with GELU, z) at the training step's products."""
    g = _gen(7)
    bf, it = torch.bfloat16, 2
    x = (torch.randn((M_TOK, C), generator=g, device="cuda") * 2 + 0.5).to(bf)
    gamma = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    beta = (0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    wqkv, bqkv = _linear(3 * C, C, g)
    w1, b1 = _linear(HID, C, g)
    ct, st = _rope_tables_20views(bf)

    def ln(eps):
        return F.layer_norm(x, (C,), gamma, beta, eps)

    def library_rope():
        y = F.linear(ln(1e-6), wqkv, bqkv)

        def rope(t):
            t = t.float()
            return (t * ct + rotate_half_lanes(t, 32) * st).to(bf)
        return torch.stack([rope(y[:, :C]), rope(y[:, C:2 * C]), y[:, 2 * C:]])

    cases = (
        ("qkv", wqkv, bqkv, None, 1e-5, f"qkv {M_TOK}x{C} -> 3x{C}",
         "F.layer_norm + F.linear",
         lambda: F.linear(ln(1e-5), wqkv, bqkv)),
        ("rope", wqkv, bqkv, (ct, st), 1e-6, f"qkv+rope {M_TOK}x{C} -> 3x{C}",
         "F.layer_norm + F.linear + torch elementwise RoPE", library_rope),
        ("gelu", w1, b1, None, 1e-6, f"fc1 {M_TOK}x{C} -> {HID} gelu",
         "F.layer_norm + F.linear + F.gelu",
         lambda: F.gelu(F.linear(ln(1e-6), w1, b1))),
    )
    for mode, w, b, tables, eps, case, lib_name, lib in cases:
        args = (mode, x, gamma, beta, w, b, eps, tables, 16)
        got = fb._replay(*args)
        ref = fb._replay_ref(*args)
        torch.cuda.synchronize()
        n = w.shape[0]
        errs = [compare("fused_gemm", got[0], ref[0], bf),
                compare("replay_u", got[1], ref[1], bf)]
        errs += [compare("replay_stats", a, c, bf) for a, c in
                 zip(got[2:4], ref[2:4])]
        if mode == "gelu":
            errs.append(compare("fused_gemm", got[4], ref[4], bf))
        nbytes = ((M_TOK * C + n * C + M_TOK * n + M_TOK * C) * it
                  + (n + 2 * C + 2 * M_TOK) * 4
                  + (M_TOK * n * it if mode == "gelu" else 0)
                  + (2 * M_TOK * C * it if mode == "rope" else 0))
        r = dict(errs[0], kernel="ln_matmul_replay", case=case,
                 dtype="bfloat16", max_abs_err_residuals=max(
                     e["max_abs_err"] for e in errs[1:]),
                 ms=median_ms(lambda: fb._replay(*args), 10),
                 plain_ms=median_ms(lambda: fb._replay_ref(*args), 3),
                 library=lib_name, library_ms=median_ms(lib, 10),
                 **bound(2.0 * M_TOK * C * n, nbytes))
        results.append(r)
        log(json.dumps(r))
    torch.cuda.empty_cache()


def check_rms(results: list) -> None:
    """The RMS -> GEMM modes of fused_gemm.cu (K13) at the llama slice's
    shapes, M = 15360, K = 1024, bf16 scale and weights as the model's:
    q | k | v (N = 3072, and 1536 with 4 kv heads), w1 with SiLU and w3
    without (N = 2816), the replay on the qkv, w1 and w3 products, and
    matmul_residual at w2's K = 2816."""
    g = _gen(8)
    bf, it, eps = torch.bfloat16, 2, 1e-5
    x = (torch.randn((M_TOK, C), generator=g, device="cuda") * 2 + 0.5).to(bf)
    gamma = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    wq, wk, wv = (_linear(C, C, g)[0] for _ in range(3))
    w1, w3 = (_linear(L_HID, C, g)[0] for _ in range(2))
    w2 = _linear(C, L_HID, g)[0]

    def rms():
        return F.rms_norm(x, (C,), gamma, eps)

    def io_bytes(n, replay=False, z=False):
        """x, w and gamma read, y written; the replay's u, rstd and z."""
        return ((M_TOK * C + n * C + C + M_TOK * n) * it
                + ((M_TOK * C * it + M_TOK * 4) if replay else 0)
                + (M_TOK * n * it if z else 0))

    for case, kv in (("qkv", C), ("qkv gqa 4 kv heads", C // 4)):
        ws = (wq, wk[:kv], wv[:kv])
        wcat, n = torch.cat(ws), C + 2 * kv
        args = (x, gamma, *ws, eps)
        _record(results, "rms_qkv3", "fused_gemm", f"{case} {M_TOK}x{C} -> {n}",
                torch.cat(fb.rms_qkv3(*args), 1),
                torch.cat(fb.rms_qkv3_ref(*args), 1),
                lambda: fb.rms_qkv3(*args), lambda: fb.rms_qkv3_ref(*args),
                lambda: F.linear(rms(), wcat).split([C, kv, kv], 1),
                "F.rms_norm + F.linear", 2.0 * M_TOK * C * n, io_bytes(n))
    for case, w, act in (("w1 silu", w1, "silu"), ("w3", w3, None)):
        args = (x, gamma, w, eps)
        _record(results, "rms_matmul", "fused_gemm",
                f"{case} {M_TOK}x{C} -> {L_HID}",
                fb.rms_matmul(*args, act=act), fb.rms_matmul_ref(*args, act=act),
                lambda: fb.rms_matmul(*args, act=act),
                lambda: fb.rms_matmul_ref(*args, act=act),
                (lambda: F.silu(F.linear(rms(), w))) if act
                else (lambda: F.linear(rms(), w)),
                "F.rms_norm + F.linear" + (" + F.silu" if act else ""),
                2.0 * M_TOK * C * L_HID, io_bytes(L_HID))
    for case, w, act in (("qkv", torch.cat([wq, wk, wv]), None),
                         ("w1 silu", w1, "silu"), ("w3", w3, None)):
        n = w.shape[0]
        args = (x, gamma, w, eps, act)
        got = fb.rms_matmul_replay(*args)
        ref = fb.rms_matmul_replay_ref(*args)
        torch.cuda.synchronize()
        errs = [compare("fused_gemm", got[0], ref[0], bf),
                compare("replay_u", got[1], ref[1], bf),
                compare("replay_stats", got[2], ref[2], bf)]
        if act:
            errs.append(compare("fused_gemm", got[3], ref[3], bf))
        lib = ((lambda: F.silu(F.linear(rms(), w))) if act
               else (lambda: F.linear(rms(), w)))
        r = dict(errs[0], kernel="rms_matmul_replay",
                 case=f"{case} {M_TOK}x{C} -> {n}", dtype="bfloat16",
                 max_abs_err_residuals=max(e["max_abs_err"] for e in errs[1:]),
                 ms=median_ms(lambda: fb.rms_matmul_replay(*args), 10),
                 plain_ms=median_ms(lambda: fb.rms_matmul_replay_ref(*args), 3),
                 library="F.rms_norm + F.linear" + (" + F.silu" if act else ""),
                 library_ms=median_ms(lib, 10),
                 **bound(2.0 * M_TOK * C * n, io_bytes(n, True, bool(act))))
        results.append(r)
        log(json.dumps(r))
    h = fb.rms_matmul(x, gamma, w1, eps, act="silu")
    zero = torch.zeros((C,), device="cuda", dtype=bf)
    args = (h, w2, zero, x)
    _record(results, "matmul_residual", "fused_gemm",
            f"w2 {M_TOK}x{L_HID} -> {C}",
            fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
            lambda: fb.matmul_residual(*args),
            lambda: fb.matmul_residual_ref(*args),
            lambda: F.linear(h, w2) + x, "F.linear + add",
            2.0 * M_TOK * L_HID * C,
            (M_TOK * L_HID + 2 * M_TOK * C + L_HID * C + C) * it)
    torch.cuda.empty_cache()


# the model_scaling decoders' shapes (configs/experiment/model_scaling/*:
# 8 views of 224x224 a sample, 196 tokens a view, batch 8): 1568 tokens a
# sample's decoder sequence, 12544 rows a product; width -> heads
MS_TOK, MS_ROWS = 8 * 196, 8 * 8 * 196
MS_WIDTHS = {768: 12, 1280: 16}
DINO_TOK = 1 + 28 * 37  # a 392x518 view's tokens in the DINO encoder


def _attention_case(results, name, shape, scale, dtype, kernel):
    """K1 (flash_attention, the forward kernel at the shape's head_dim) on
    strided views of a packed (B, N, 3, H, D) buffer against its plain
    version; a bf16 case's line carries the device time and TFLOP/s."""
    B, N, H, D = shape
    qkv = torch.randn((B, N, 3, H, D), generator=_gen(11), device="cuda",
                      dtype=torch.float32).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    r = compare("attention", flash_attention(q, k, v, scale),
                attention_ref(q, k, v, scale), dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)  # noqa: E731
    r.update(kernel="attention", case=f"{name} {B}x{N}x{H}x{D}",
             dtype=str(dtype).split(".")[-1],
             ms=median_ms(lambda: flash_attention(q, k, v, scale), 10),
             plain_ms=median_ms(lambda: attention_ref(q, k, v, scale), 3),
             library="F.scaled_dot_product_attention",
             library_ms=median_ms(sdpa, 10),
             **bound(4.0 * B * H * N * N * D, 4 * B * N * H * D * qkv.element_size(),
                     dtype))
    if dtype == torch.bfloat16:
        r.update(fwd_rates(float(B * H) * N * N, D,
                           lambda: flash_attention(q, k, v, scale), kernel, sdpa))
    results.append(r)
    log(json.dumps(r))


def check_widths(results: list) -> None:
    """Phase 25: the kernels widened for the model_scaling decoders and the
    DINO encoder, each against its plain version under the tolerance of
    its head_dim-64 / K = 1024 check: K1 at head_dim 80 on the huge
    decoder's (8, 1568, 16, 80) in fp32 and bf16, and at head_dim 64 on the
    DINO encoder's 1037 tokens a 392x518 view (a ragged last key tile);
    K9 at (8, 1568, 16, 80); the fused GEMMs (K3 ln_qkv, K5 ln_matmul GELU
    and matmul_residual, K11 the replay) and the whole-MLP kernel (K6) at
    the 768 and 1280 widths, M = 12544 rows (hidden 4 x width)."""
    log("== phase 25: the widened kernels (head_dim 80; widths 768, 1280)")
    bf, it = torch.bfloat16, 2
    huge = (8, MS_TOK, 16, 80)
    for dtype in (torch.float32, bf):
        _attention_case(results, "huge decoder", huge, 80 ** -0.5, dtype,
                        "attention_fwd_kernel<80>")
    _attention_case(results, "dino encoder", (20, DINO_TOK, 16, 64), 0.125, bf,
                    "attention_fwd_kernel<64>")
    torch.cuda.empty_cache()

    B, N, H, D = huge
    g = _gen(12)
    qkv = torch.randn((B, N, 3, H, D), generator=g, device="cuda").to(bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((B, N, H, D), generator=g, device="cuda").to(bf)
    scale = D ** -0.5
    o, lse = attention_fwd_lse(q, k, v, scale)
    got = attention_bwd(q, k, v, o, lse, do, scale)
    ref = attention_bwd_ref(q, k, v, o, lse, do, scale)
    errs = [compare("attention_bwd", a, b, bf) for a, b in zip(got, ref)]
    del ref
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    r = dict(_merge(errs), kernel="attention_bwd",
             case=f"huge decoder {B}x{N}x{H}x{D}", dtype="bfloat16",
             ms=median_ms(lambda: attention_bwd(q, k, v, o, lse, do, scale), 10),
             plain_ms=median_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                          scale), 2),
             library="autograd of F.scaled_dot_product_attention",
             library_ms=_grad_ms(ol, (ql, kl, vl), do.transpose(1, 2), 10),
             **_pass_rates(B, N, H, D, _device_ms(
                 lambda: attention_bwd(q, k, v, o, lse, do, scale),
                 {"dq": "attention_bwd_dq_kernel<80>",
                  "dkv": "attention_bwd_dkv_kernel<80>"})),
             **_attn_bwd_bound(B, N, H, D))
    results.append(r)
    log(json.dumps(r))
    del qkv, q, k, v, do, o, lse, got, ql, kl, vl, ol
    torch.cuda.empty_cache()

    # the heads' kernels at the variants' view shapes, by head_road: K12 on
    # the DINO requests' 392x518 and 518x392 views (path1 at 8x the 28 x 37
    # patch grid, a 1.75x resize), K8 at 224x224 (patch 14: 128 x 128;
    # patch 16: 112 x 112)
    for shape, (Hh, Wh) in (((20, 128, 224, 296), (392, 518)),
                            ((10, 128, 296, 224), (518, 392))):
        xr = torch.randn(shape, generator=g, device="cuda").to(bf)
        out = resize_bilinear_kernel(xr, Hh, Wh)
        r = compare("resize", out, resize_matmul(xr, Hh, Wh), bf)
        b_, c_, h_, w_ = shape
        r.update(kernel="resize", case=f"dino {b_}x{c_}x{h_}x{w_} -> {Hh}x{Wh}",
                 dtype="bfloat16",
                 ms=median_ms(lambda: resize_bilinear_kernel(xr, Hh, Wh), 20),
                 plain_ms=median_ms(lambda: resize_matmul(xr, Hh, Wh), 5),
                 library="F.interpolate(bilinear, align_corners=True)",
                 library_ms=median_ms(lambda: F.interpolate(
                     xr, size=(Hh, Wh), mode="bilinear", align_corners=True), 20),
                 **bound(3.0 * b_ * c_ * Hh * (w_ + Wh),
                         (xr.numel() + out.numel()) * 2, torch.float32))
        results.append(r)
        log(json.dumps(r))
        del xr, out
    for name, (n, hh) in (("dino", (8, 128)), ("model_scaling", (64, 112))):
        x, wts = _trunk_inputs(n, hh, hh, 256, bf)
        targs = (*wts, 224, 224)
        xc = x.permute(0, 3, 1, 2)
        out = fused_regression_head_t(x, *targs)
        r = compare("trunk", out, _plain_head(xc, *targs).reshape(n, 4, -1), bf)
        flops = 2.0 * (n * hh * hh * 128 * 256 * 9
                       + n * 224 * 224 * (128 * 128 * 9 + 128 * 4))
        r.update(kernel="trunk", case=f"{name} {n}x{hh}x{hh}x256 -> 224x224",
                 dtype="bfloat16",
                 ms=median_ms(lambda: fused_regression_head_t(x, *targs), 5),
                 plain_ms=median_ms(lambda: _plain_head(xc, *targs), 3),
                 library="F.conv2d + F.interpolate(bilinear, align_corners) + "
                         "F.conv2d + F.relu + F.conv2d",
                 library_ms=median_ms(lambda: F.conv2d(F.relu(F.conv2d(
                     F.interpolate(F.conv2d(xc, wts[0], wts[1], padding=1),
                                   size=(224, 224), mode="bilinear",
                                   align_corners=True),
                     wts[2], wts[3], padding=1)), wts[4], wts[5]), 5),
                 **bound(flops, (x.numel() + n * 4 * 224 * 224) * 2, bf))
        results.append(r)
        log(json.dumps(r))
        del x, xc, out
    torch.cuda.empty_cache()

    M = MS_ROWS
    for c, heads in MS_WIDTHS.items():
        hid = 4 * c
        x = (torch.randn((M, c), generator=g, device="cuda") * 2 + 0.5).to(bf)
        gamma = (1 + 0.1 * torch.randn((c,), generator=g, device="cuda")).to(bf)
        beta = (0.1 * torch.randn((c,), generator=g, device="cuda")).to(bf)
        wqkv, bqkv = _linear(3 * c, c, g)
        wproj, bproj = _linear(c, c, g)
        w1, b1 = _linear(hid, c, g)
        w2, b2 = _linear(c, hid, g)

        def ln_linear(w, b, eps):
            return F.linear(F.layer_norm(x, (c,), gamma, beta, eps), w, b)

        args = (x, gamma, beta, wqkv, bqkv, 1e-6)
        _record(results, "ln_qkv", "fused_gemm", f"K={c} {M}x{c} -> 3x{c}",
                torch.stack(fb.ln_qkv(*args)), torch.stack(fb.ln_qkv_ref(*args)),
                lambda: fb.ln_qkv(*args), lambda: fb.ln_qkv_ref(*args),
                lambda: ln_linear(wqkv, bqkv, 1e-6).split(c, dim=1),
                "F.layer_norm + F.linear", 2.0 * M * c * 3 * c,
                (3 * c * c + 5 * c + 4 * M * c) * it)
        args = (x, gamma, beta, w1, b1, 1e-6)
        _record(results, "ln_matmul", "fused_gemm", f"K={c} {M}x{c} -> {hid} gelu",
                fb.ln_matmul(*args, act="gelu"), fb.ln_matmul_ref(*args, act="gelu"),
                lambda: fb.ln_matmul(*args, act="gelu"),
                lambda: fb.ln_matmul_ref(*args, act="gelu"),
                lambda: F.gelu(ln_linear(w1, b1, 1e-6)),
                "F.layer_norm + F.linear + F.gelu", 2.0 * M * c * hid,
                (M * c + hid * c + hid + 2 * c + M * hid) * it)
        for mode, w, b, n, lib in (
                ("gelu", w1, b1, hid, lambda: F.gelu(ln_linear(w1, b1, 1e-6))),
                ("qkv", wqkv, bqkv, 3 * c, lambda: ln_linear(wqkv, bqkv, 1e-6))):
            rargs = (mode, x, gamma, beta, w, b, 1e-6, None, heads)
            got = fb._replay(*rargs)
            ref = fb._replay_ref(*rargs)
            errs = [compare("fused_gemm", got[0], ref[0], bf),
                    compare("replay_u", got[1], ref[1], bf)]
            errs += [compare("replay_stats", a, e, bf)
                     for a, e in zip(got[2:4], ref[2:4])]
            if mode == "gelu":
                errs.append(compare("fused_gemm", got[4], ref[4], bf))
            r = dict(errs[0], kernel="ln_matmul_replay",
                     case=f"K={c} {mode} {M}x{c} -> {n}", dtype="bfloat16",
                     max_abs_err_residuals=max(e["max_abs_err"] for e in errs[1:]),
                     ms=median_ms(lambda: fb._replay(*rargs), 10),
                     plain_ms=median_ms(lambda: fb._replay_ref(*rargs), 3),
                     library="F.layer_norm + F.linear"
                     + (" + F.gelu" if mode == "gelu" else ""),
                     library_ms=median_ms(lib, 10),
                     **bound(2.0 * M * c * n,
                             (2 * M * c + n * c + M * n) * it + (n + 2 * c + 2 * M) * 4
                             + (M * n * it if mode == "gelu" else 0)))
            results.append(r)
            log(json.dumps(r))
            del got, ref
        o = (torch.randn((M, c), generator=g, device="cuda") * 0.5).to(bf)
        args = (o, wproj, bproj, x)
        _record(results, "matmul_residual", "fused_gemm", f"K={c} proj {M}x{c} -> {c}",
                fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
                lambda: fb.matmul_residual(*args),
                lambda: fb.matmul_residual_ref(*args),
                lambda: F.linear(o, wproj, bproj) + x, "F.linear + add",
                2.0 * M * c * c, (3 * M * c + c * c + c) * it)
        h = fb.ln_matmul(x, gamma, beta, w1, b1, 1e-6, act="gelu")
        args = (h, w2, b2, x)
        _record(results, "matmul_residual", "fused_gemm", f"K={hid} fc2 {M}x{hid} -> {c}",
                fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
                lambda: fb.matmul_residual(*args),
                lambda: fb.matmul_residual_ref(*args),
                lambda: F.linear(h, w2, b2) + x, "F.linear + add",
                2.0 * M * hid * c, (M * hid + 2 * M * c + hid * c + c) * it)
        args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
        _record(results, "ln_mlp", "ln_mlp", f"C={c} {M}x{c}, hidden {hid}",
                fb.ln_mlp(*args), fb.ln_mlp_ref(*args),
                lambda: fb.ln_mlp(*args), lambda: fb.ln_mlp_ref(*args),
                lambda: x + F.linear(F.gelu(ln_linear(w1, b1, 1e-6)), w2, b2),
                "F.layer_norm + F.linear + F.gelu + F.linear + add",
                4.0 * M * c * hid, (2 * M * c + 2 * hid * c + hid + 3 * c) * it,
                two_kernel_ms=median_ms(lambda: fb.matmul_residual(
                    fb.ln_matmul(x, gamma, beta, w1, b1, 1e-6, act="gelu"),
                    w2, b2, x), 10))
        del x, h, o
        torch.cuda.empty_cache()


def phase_kernels() -> list:
    log("== phase 2: kernels vs plain versions")
    # the plain versions compute fp32 products in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: list = []
    check_layernorm(results)
    check_attention(results)
    check_trunk(results)
    check_resize(results)
    check_fused_blocks(results)
    check_layernorm_bwd(results)
    check_attention_bwd(results)
    check_replay(results)
    check_rms(results)
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phases 3-5
# ---------------------------------------------------------------------------

FUSED_CU = "fast3r_torch/csrc/fused_gemm.cu"
KERNELS = {  # name -> (wrapper, route, source, TPU kernel it replaces)
    "attention": (flash_attention, "cuda", "fast3r_torch/csrc/attention_fwd.cu",
                  "fast3r_tpu/ops/flash_attention.py:745 (_fwd_kernel_packed); "
                  "fast3r_tpu/ops/batched_attention.py:340 (_packed_kernel)"),
    "packed_qkv_attention": (
        packed_qkv_attention, "cuda", "fast3r_torch/csrc/attention_fwd.cu",
        "fast3r_tpu/ops/batched_attention.py:497 (_fusedqkv_kernel)"),
    "layernorm": (fused_layernorm, "cuda", "fast3r_torch/csrc/layernorm.cu",
                  "fast3r_tpu/ops/fused_layernorm.py:46 (_fwd_kernel)"),
    "trunk": (fused_regression_head_t, "cuda", "fast3r_torch/csrc/trunk.cu",
              "fast3r_tpu/ops/trunk_kernel.py:165 (_trunk_kern)"),
    "resize": (resize_bilinear_kernel, "cuda", "fast3r_torch/csrc/resize.cu",
               "fast3r_tpu/ops/resize_kernel.py:141 (_resize_kern)"),
    "ln_qkv_rope": (fb.ln_qkv_rope, "cuda", FUSED_CU,
                    "fast3r_tpu/nn/fused_block.py:595 (_ln_qkv_rope_kernel)"),
    "ln_qkv": (fb.ln_qkv, "cuda", FUSED_CU,
               "fast3r_tpu/nn/fused_block.py:276 (_ln_qkv_kernel)"),
    "ln_matmul": (fb.ln_matmul, "cuda", FUSED_CU,
                  "fast3r_tpu/nn/fused_block.py:264 (_ln_matmul_kernel)"),
    "matmul_residual": (fb.matmul_residual, "cuda", FUSED_CU,
                        "fast3r_tpu/nn/fused_block.py:310 (_matmul_res_kernel)"),
    "ln_mlp": (fb.ln_mlp, "cuda", "fast3r_torch/csrc/ln_mlp.cu",
               "fast3r_tpu/nn/fused_block.py:318 (_ln_mlp_kernel)"),
    "layernorm_bwd": (layernorm_bwd, "cuda", "fast3r_torch/csrc/layernorm.cu",
                      "fast3r_tpu/ops/fused_layernorm.py:56 (_bwd_kernel)"),
    "attention_bwd": (
        attention_bwd, "cuda", "fast3r_torch/csrc/attention_bwd.cu",
        "fast3r_tpu/ops/flash_attention.py:874 (_bwd_dq_kernel_packed), "
        ":914 (_bwd_dkv_kernel_packed); :475 (_bwd_dq_kernel), "
        ":520 (_bwd_dkv_kernel)"),
    "packed_qkv_attention_bwd": (
        packed_qkv_attention_bwd, "cuda", "fast3r_torch/csrc/attention_bwd.cu",
        "fast3r_tpu/ops/batched_attention.py:696 (_fusedqkv_bwd_kernel)"),
    "ln_matmul_replay": (
        fb.ln_matmul_replay, "cuda", FUSED_CU,
        "fast3r_tpu/nn/fused_block.py:340 (_ln_matmul_replay_kernel)"),
    "rms_qkv3": (fb.rms_qkv3, "cuda", FUSED_CU,
                 "fast3r_tpu/nn/fused_block.py:300 (_rms_qkv3_kernel)"),
    "rms_matmul": (fb.rms_matmul, "cuda", FUSED_CU,
                   "fast3r_tpu/nn/fused_block.py:288 (_rms_matmul_kernel)"),
    "rms_matmul_replay": (
        fb.rms_matmul_replay, "cuda", FUSED_CU,
        "fast3r_tpu/nn/fused_block.py:712 (_rms_matmul_replay_kernel)"),
    "ring_attention": (
        ring_flash_attention_rdma, "cuda", "fast3r_torch/csrc/ring_attention.cu",
        "fast3r_tpu/parallel/ring_rdma.py:137 (_ring_fwd_kernel, from "
        "_rdma_forward :358)"),
    "ring_attention_bwd_dq": (
        ring_attention_bwd_dq, "cuda", "fast3r_torch/csrc/ring_attention_bwd.cu",
        "fast3r_tpu/parallel/ring_rdma.py:484 (_ring_bwd_dq_kernel, from "
        "_ring_backward :736)"),
    "ring_attention_bwd_dkv": (
        ring_attention_bwd_dkv, "cuda", "fast3r_torch/csrc/ring_attention_bwd.cu",
        "fast3r_tpu/parallel/ring_rdma.py:586 (_ring_bwd_dkv_kernel, from "
        "_ring_backward :776)"),
}
TRAIN_KERNELS = ("layernorm_bwd", "attention_bwd", "packed_qkv_attention_bwd",
                 "ln_matmul_replay")
# the kernels each path of phase 3 must launch
PATHS = {
    "fused": ("attention", "packed_qkv_attention", "layernorm", "trunk",
              "ln_qkv_rope", "ln_qkv", "matmul_residual", "ln_mlp"),
    "plain": ("attention", "layernorm", "trunk"),
    "two_kernel_mlp": ("attention", "packed_qkv_attention", "layernorm",
                       "trunk", "ln_qkv_rope", "ln_qkv", "ln_matmul",
                       "matmul_residual"),
}
# the training roads of phase 5: the forward kernels of the serving road,
# plus the backward kernels and the replay (the plain road has no fused
# products and no packed attention)
PATHS["train"] = PATHS["fused"] + TRAIN_KERNELS
PATHS["train_plain"] = PATHS["plain"] + ("layernorm_bwd", "attention_bwd")
PATHS["train_two_kernel_mlp"] = PATHS["two_kernel_mlp"] + TRAIN_KERNELS
# the llama model (phases 7 and 9): the encoder's fused road, the heads, and
# on the decoder's fused road the RMS kernels, attention and matmul_residual
K13 = ("rms_qkv3", "rms_matmul", "rms_matmul_replay")
LLAMA_ENCODER = ("packed_qkv_attention", "layernorm", "trunk", "ln_qkv_rope",
                 "matmul_residual", "ln_mlp", "attention")
PATHS["llama"] = LLAMA_ENCODER + K13[:2]
PATHS["llama_plain"] = LLAMA_ENCODER
PATHS["llama_train"] = PATHS["llama"] + TRAIN_KERNELS + K13[2:]
# phases 11, 12 and 14: the flagship's fused road at 512x512 (the head's
# unfused road with K12), mixed 384x512 / 512x384 / 448x512 views (both
# roads) and the CLI's 448x512 views (K12)
PATHS["square"] = tuple(k for k in PATHS["fused"] if k != "trunk") + (
    "resize",)
PATHS["mixed"] = PATHS["fused"] + ("resize",)
PATHS["images_to_poses"] = PATHS["square"]
# phase 16: the encoder's fused road, the heads' trunk kernel, and the
# decoder on the plain block road with the ring kernel as its attention
PATHS["seq_sharded"] = ("ring_attention", "packed_qkv_attention", "layernorm",
                        "trunk", "ln_qkv_rope", "matmul_residual", "ln_mlp")
# phase 18: the same forward kernels, K14's backward rings and the encoder's
# fused road's training kernels
RING_BWD = ("ring_attention_bwd_dq", "ring_attention_bwd_dkv")
PATHS["seq_train"] = PATHS["seq_sharded"] + RING_BWD + (
    "layernorm_bwd", "packed_qkv_attention_bwd", "ln_matmul_replay")
SEQ_PATHS = ("seq_sharded", "seq_train")
# phase 19: the training CLI's run 2 takes the fused road's training kernels
# on the loader's batches; its heads take K8 or K12 by view shape (checked
# in the phase: one of them launched)
PATHS["cli_train"] = tuple(k for k in PATHS["train"] if k != "trunk")
# phase 20: the eval CLI's forwards take the fused road at 384x512 (CO3D:
# K8) and 512x512 (the recon sets: K12); the drivers' heads take K8 or K12
# by view shape (checked in the phase)
PATHS["eval_cli"] = PATHS["mixed"]
PATHS["re10k"] = PATHS["robustmvd"] = tuple(
    k for k in PATHS["fused"] if k != "trunk")
# K13 launches on the llama fused roads only, K12 on no path of 384x512
# views, the trunk kernel on no path of 512x512 or 448x512 views, K14 on
# the sequence-sharded paths only (its backward on the training one), the
# decoder's K1 / K9 on neither
NO_LAUNCH = {
    path: ((() if path in ("llama", "llama_train") else K13)
           + (() if path in ("square", "mixed", "images_to_poses",
                             "cli_train", "eval_cli", "re10k", "robustmvd")
              else ("resize",))
           + (("trunk",) if path in ("square", "images_to_poses") else ())
           + (("attention", "ln_qkv") if path in SEQ_PATHS
              else ("ring_attention",))
           + (("attention_bwd",) if path == "seq_train" else RING_BWD))
    for path in PATHS}
# phases 22-24: the DINO model's roads (its encoder: K7 and K1 on strided
# q, k, v, 1037 tokens a 392x518 view; the flagship's fused decoder; the
# heads by head_road, checked in the phase) and the model_scaling overlays'
# (the flagship's fused roads at their widths, the decoder's attention at
# head_dim 80 in huge); none of them launches the llama, ring or (serving)
# backward kernels, the DINO model's no kernel of the CroCo encoder
DINO_FWD = ("attention", "layernorm", "ln_qkv", "matmul_residual", "ln_mlp")
PATHS["dino"] = PATHS["dino_mixed"] = DINO_FWD
PATHS["dino_train"] = DINO_FWD + ("layernorm_bwd", "attention_bwd",
                                  "ln_matmul_replay")
MS_FWD = tuple(k for k in PATHS["fused"] if k != "trunk")
MS_PATHS = {short: (short, f"{short}_train") for short in
            ("ms_base", "ms_large", "ms_huge")}
MS_PATHS["ms_huge"] += ("ms_huge_cli",)
for _short, _paths in MS_PATHS.items():
    for _p in _paths:
        PATHS[_p] = MS_FWD + (TRAIN_KERNELS if _p != _short else ())
_TRAIN_ONLY = ("layernorm_bwd", "attention_bwd", "packed_qkv_attention_bwd",
               "ln_matmul_replay")
for _p in ("dino", "dino_mixed", "dino_train", *sum(MS_PATHS.values(), ())):
    NO_LAUNCH[_p] = (K13 + ("ring_attention",) + RING_BWD
                     + (("packed_qkv_attention", "packed_qkv_attention_bwd",
                         "ln_qkv_rope") if _p.startswith("dino") else ())
                     + (_TRAIN_ONLY if _p in ("dino", "dino_mixed", *MS_PATHS)
                        else ()))
# phase 29: model_scaling_huge's seq-sharded request and steps, the kernels
# of phases 16 and 18 at head_dim 80 (the heads' kernel by head_road,
# checked in the phase); phase 30: the demo's reconstruct click, phase 3's
# fused road
PATHS["ms_huge_seq"] = tuple(k for k in PATHS["seq_sharded"] if k != "trunk")
PATHS["ms_huge_seq_train"] = tuple(k for k in PATHS["seq_train"]
                                   if k != "trunk")
NO_LAUNCH["ms_huge_seq_train"] = K13 + ("attention", "ln_qkv", "attention_bwd")
NO_LAUNCH["ms_huge_seq"] = NO_LAUNCH["ms_huge_seq_train"] + RING_BWD
PATHS["demo"] = PATHS["fused"]
NO_LAUNCH["demo"] = NO_LAUNCH["fused"]
# phase 31: the 1000-view forward on phase 3's fused road (the heads on K8
# at 256x192), and sequence-sharded on phase 16's road
PATHS["many_view"] = PATHS["fused"]
NO_LAUNCH["many_view"] = NO_LAUNCH["fused"]
PATHS["many_view_seq"] = PATHS["seq_sharded"]
NO_LAUNCH["many_view_seq"] = NO_LAUNCH["seq_sharded"]
# the serving paths, on which every kernel input maps in place (no layout
# copy); the training paths' counts are reported
SERVE_PATHS = ("fused", "plain", "two_kernel_mlp", "llama", "llama_plain",
               "square", "mixed", "images_to_poses", "seq_sharded",
               "eval_cli", "re10k", "robustmvd", "dino", "dino_mixed",
               *MS_PATHS, "ms_huge_seq", "demo", "many_view",
               "many_view_seq")
OUT_KEYS = ("pts3d_in_other_view", "conf", "pts3d_local", "conf_local")
# phase 4: |gpu bf16 - cpu fp32| / |cpu fp32| in the L2 norm, per output.
# bf16 keeps 8 bits of mantissa; through 48 blocks and two heads the
# relative error of activations grows to a few 1e-3 .. 1e-2.
E2E_REL_L2 = 0.05


def request_views(n: int, H: int, W: int, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [{"img": torch.rand((1, H, W, 3), generator=g) * 2 - 1,
             "true_shape": [[H, W]], "idx": i, "instance": str(i)}
            for i in range(n)]


def check_preds(preds: list, shapes: list) -> None:
    """Every output of view i finite, of shape shapes[i], conf >= 1."""
    if len(preds) != len(shapes):
        raise AssertionError(f"{len(preds)} predictions for {len(shapes)} "
                             "views")
    for i, (p, (H, W)) in enumerate(zip(preds, shapes)):
        if set(p) != set(OUT_KEYS):
            raise AssertionError(f"view {i}: outputs {sorted(p)}")
        for k, v in p.items():
            want = (1, H, W, 3) if k.startswith("pts3d") else (1, H, W)
            if tuple(v.shape) != want:
                raise AssertionError(f"view {i} {k}: shape {tuple(v.shape)}")
            if not torch.isfinite(v).all():
                raise AssertionError(f"view {i} {k}: not finite")
        for k in ("conf", "conf_local"):
            if not (p[k] >= 1).all():
                raise AssertionError(f"view {i} {k}: below 1")


def serve_path(path: str, model, sizes, gpu: str) -> dict:
    """Serve the requests of one path with every launch count set to 0
    just before and read just after."""
    _reset_counts()
    for n, serves in sizes:
        # twice per size where asked: the first request of a size also pays
        # its one-off costs (allocator growth, pinned host buffers, conv
        # algorithm picks)
        for serve in range(1, serves + 1):
            _serve(path, model, request_views(n, 384, 512, n + serve), serve,
                   gpu)
    return _read_counts()


def phase_requests(gpu: str):
    log("== phase 3: requests (flagship, random weights seed 0, bfloat16)")
    t0 = time.perf_counter()
    cpu_model = Fast3R.from_random(Fast3RConfig.flagship(), seed=0,
                                   device="cpu")
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    plain = Fast3R(model.cfg.with_fused_blocks(False), model.params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.parameters())
    log(f"model: {n_params} parameters, built and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    for m in (model, plain):  # warm-up
        inference(request_views(2, 384, 512, 99), m, verbose=False)
    counts = {"fused": serve_path("fused", model, ((2, 2), (8, 2), (20, 2)),
                                  gpu),
              "plain": serve_path("plain", plain, ((20, 2),), gpu)}
    fb.PREFER_FUSED_MLP = False
    try:
        counts["two_kernel_mlp"] = serve_path("two_kernel_mlp", model,
                                              ((8, 1),), gpu)
    finally:
        fb.PREFER_FUSED_MLP = True
    copies = {path: c["layout_copies"] for path, c in counts.items()}
    log(json.dumps({"layout_copies": copies}))
    if any(copies.values()):
        raise AssertionError(f"inputs copied for the kernels' tensor maps on "
                             f"the serving paths: {copies}")
    return cpu_model, model, plain, counts


def phase_end_to_end(cpu_model, model, plain, phase: str = "phase 4") -> dict:
    log(f"== {phase}: bf16 kernel paths on the card vs fp32 plain versions "
        "on the CPU (serving)")
    views = request_views(2, 224, 224, 7)
    t = time.perf_counter()
    ref = inference(views, cpu_model, verbose=False)["preds"]
    t_cpu = time.perf_counter() - t
    bad = {}
    errs = {}
    for road, m in (("fused", model), ("plain", plain)):
        out = inference(views, m, verbose=False)["preds"]
        torch.cuda.synchronize()
        check_preds(out, [(224, 224)] * 2)
        errs[road] = {}
        for k in OUT_KEYS:
            a = torch.cat([p[k] for p in out])
            b = torch.cat([p[k] for p in ref])
            e = ((a - b).norm() / b.norm()).item()
            errs[road][k] = e
            if not e <= E2E_REL_L2:
                bad[f"{road} {k}"] = e
    log(json.dumps({"rel_l2_err": errs, "tolerance": E2E_REL_L2,
                    "cpu_fp32_s": t_cpu}))
    if bad:
        raise AssertionError(f"end-to-end error above {E2E_REL_L2}: {bad}")
    return errs


BATCH_KEYS = ("imgs", "true_shapes", "pts3d", "valid_mask", "camera_pose")
TRAIN_OPT = OptimConfig(warmup_steps=2, total_steps=1000)
TRAIN_STEPS = 4  # phase 5's steps on the fused road
FLAGSHIP_PARAMS = 647_551_368


def _reset_counts() -> None:
    torch.cuda.synchronize()
    for fn, *_ in KERNELS.values():
        fn.launches = 0
    tma_view.copies = 0


def _read_counts() -> dict:
    """Each kernel's launches, and the copies made of inputs that the
    kernels' tensor maps could not read in place (``layout_copies``)."""
    torch.cuda.synchronize()
    return {**{name: fn.launches for name, (fn, *_) in KERNELS.items()},
            "layout_copies": tma_view.copies}


def train_road(road: str, net, cfg, batch, steps: int, gpu: str,
               step=None, compute_dtype=None) -> dict:
    """``steps`` train_steps (or ``step(state, batch)``s) from fresh
    optimizer state, the launch counts set to 0 just before and read just
    after; every loss and gradient norm finite, no step skipped.  With
    ``compute_dtype`` (bf16) and fp32 ``net``, the master-weights road."""
    if step is None:
        def step(state, batch):
            return train_step(state, batch, cfg, TRAIN_OPT, remat=True)
    state = init_train_state(net, TRAIN_OPT, compute_dtype=compute_dtype)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    V = batch["imgs"].shape[1]
    for i in range(steps):
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rec = {"path": road, "train_step": i + 1, "views": V,
               "image_hw": list(batch["imgs"].shape[2:4]),
               "step_s": time.perf_counter() - t, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
               "skipped_nonfinite": int(m["skipped_nonfinite"]),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "gpu": gpu}
        log(json.dumps(rec))
        if rec["skipped_nonfinite"] or not (math.isfinite(rec["loss"])
                                            and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"{road} step {i + 1} not finite or skipped")
    return _read_counts()


def phase_training(gpu: str, cpu_model) -> dict:
    log("== phase 5: training steps (flagship, random weights seed 0, "
        "bf16 params and moments, 20 views at 512x384, remat)")
    net = cpu_model.to(device="cuda", dtype=torch.bfloat16).params
    cfg = cpu_model.cfg
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, 20, 384, 512, seed=0).items()
             if k in BATCH_KEYS}
    counts = {"train": train_road("train", net, cfg, batch, TRAIN_STEPS, gpu),
              "train_plain": train_road("train_plain", net,
                                        cfg.with_fused_blocks(False), batch, 2,
                                        gpu)}
    fb.PREFER_FUSED_MLP = False
    try:
        counts["train_two_kernel_mlp"] = train_road(
            "train_two_kernel_mlp", net, cfg, batch, 2, gpu)
    finally:
        fb.PREFER_FUSED_MLP = True
    del net, batch
    torch.cuda.empty_cache()
    return counts


# phase 6: |gpu bf16 - cpu fp32| / |cpu fp32|, of the loss and in the L2
# norm of each top-level group's gradient.  Start from the forward's 0.05
# (phase 4): the backward runs through the same 48 bf16 blocks, rounds
# du, dh and each weight gradient to bf16 once more and sums the weight
# gradients over 392 tokens, which adds error of the forward's order.
E2E_TRAIN_REL = 0.05


def _loss_and_grads(net, cfg, batch, ids):
    """The training forward's loss and each top-level group's gradient,
    flattened, fp32 on the CPU."""
    p0 = next(net.parameters())
    b = {k: v.to(p0.device) for k, v in batch.items()}
    with torch.enable_grad():
        preds = fast3r_forward(net, cfg, b["imgs"].to(p0.dtype),
                               batch["true_shapes"], view_ids=ids,
                               is_training=True, remat=True)
        loss, _ = conf_loss_multiview_v2(b, preds)
        return loss.item(), _grads_by_group(net, loss)


def _grads_by_group(net, loss) -> dict:
    """Each top-level group's gradient of loss, flattened, fp32 on the
    CPU."""
    names, ps = zip(*net.named_parameters())
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    groups: dict = {}
    for n, p, g in zip(names, ps, gs):
        g = torch.zeros_like(p) if g is None else g
        groups.setdefault(n.split(".")[0], []).append(g.float().cpu().reshape(-1))
    return {k: torch.cat(v) for k, v in groups.items()}


def phase_train_end_to_end(cpu_model, plain_cfg,
                           phase: str = "phase 6") -> tuple:
    """Returns the CPU's fp32 loss and gradients (the reference)."""
    log(f"== {phase}: one training step's loss and gradients, bf16 on the "
        "card vs fp32 plain versions on the CPU")
    batch = {k: torch.as_tensor(v) for k, v in
             make_dummy_batch(1, 2, 224, 224, seed=1).items()
             if k in BATCH_KEYS}
    ids = sample_random_image_ids(torch.Generator().manual_seed(0), 1, 2)
    t = time.perf_counter()
    ref_loss, ref = _loss_and_grads(cpu_model.params, cpu_model.cfg, batch, ids)
    t_cpu = time.perf_counter() - t
    gpu_model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    errs, bad = {}, {}
    for road, cfg in (("fused", cpu_model.cfg), ("plain", plain_cfg)):
        loss, grads = _loss_and_grads(gpu_model.params, cfg, batch, ids)
        errs[road] = {"loss": abs(loss - ref_loss) / abs(ref_loss),
                      **{f"grad/{k}": ((grads[k] - ref[k]).norm()
                                       / ref[k].norm()).item() for k in ref}}
        bad.update({f"{road} {k}": e for k, e in errs[road].items()
                    if not e <= E2E_TRAIN_REL})
    log(json.dumps({"train_rel_err": errs, "tolerance": E2E_TRAIN_REL,
                    "loss_cpu_fp32": ref_loss, "cpu_fp32_s": t_cpu}))
    del gpu_model
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"training end-to-end error above "
                             f"{E2E_TRAIN_REL}: {bad}")
    return ref_loss, ref


# the slice of phases 7-10: the flagship with its decoder replaced by the
# reference's llama_dec decoder (configs/experiment/llama_dec.yaml)
LLAMA_DEC = LlamaDecoderConfig(
    enc_embed_dim=1024, embed_dim=1024, n_layers=24, n_heads=16,
    n_kv_heads=None, multiple_of=256, norm_eps=1e-5, rope_theta=10000.0,
    max_seq_len=1000, random_image_idx_embedding=True, attn_impl="pallas",
    fused_blocks=True)
LLAMA_PARAMS = 653_572_488


def llama_cfg(fused_decoder: bool = True) -> Fast3RConfig:
    return dataclasses.replace(
        Fast3RConfig.flagship(),
        decoder=dataclasses.replace(LLAMA_DEC, fused_blocks=fused_decoder))


def phase_llama_requests(gpu: str):
    log("== phase 7: llama requests (llama_dec: flagship encoder and heads, "
        "1024 x 24 llama decoder; random weights seed 0, bfloat16)")
    t0 = time.perf_counter()
    cpu_model = Fast3R.from_random(llama_cfg(), seed=0, device="cpu")
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    plain = Fast3R(llama_cfg(fused_decoder=False), model.params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.parameters())
    log(f"model: {n_params} parameters, built and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    if n_params != LLAMA_PARAMS:
        raise AssertionError(f"llama model has {n_params} parameters, "
                             f"expected {LLAMA_PARAMS}")
    for m in (model, plain):  # warm-up
        inference(request_views(2, 384, 512, 98), m, verbose=False)
    counts = {"llama": serve_path("llama", model, ((20, 2),), gpu),
              "llama_plain": serve_path("llama_plain", plain, ((20, 1),), gpu)}
    return cpu_model, model, plain, counts


def phase_llama_training(gpu: str, cpu_model) -> dict:
    log("== phase 9: llama training steps (random weights seed 0, bf16 "
        "params and moments, 20 views at 512x384, fused road)")
    net = cpu_model.to(device="cuda", dtype=torch.bfloat16).params
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, 20, 384, 512, seed=0).items()
             if k in BATCH_KEYS}
    counts = {"llama_train": train_road("llama_train", net, cpu_model.cfg,
                                        batch, 3, gpu)}
    del net, batch
    torch.cuda.empty_cache()
    return counts


def _serve(path: str, model, views, serve: int, gpu: str) -> dict:
    """One timed request; its outputs checked."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = inference(views, model, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    shapes = [tuple(np.asarray(v["true_shape"]).reshape(-1)) for v in views]
    check_preds(out["preds"], shapes)
    hw = sorted({(int(h), int(w)) for h, w in shapes})
    # the forward's matmul and conv FLOPs (utils/flops.py) over the wall
    tflops = (fast3r_forward_flops(model.cfg, len(views), *hw[0])["total"]
              / dt / 1e12 if len(hw) == 1 else None)
    rec = {"path": path, "request_views": len(views), "serve": serve,
           "image_hw": hw, "latency_s": dt, "images_per_s": len(views) / dt,
           "tflops_per_s": tflops, "gpu": gpu,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps(rec))
    return rec


def _expect(path: str, counts: dict, **want) -> None:
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


def phase_square(gpu: str):
    log("== phase 11: a square request (flagship, random weights seed 0, "
        "bfloat16, fused road, 20 views at 512x512)")
    t0 = time.perf_counter()
    cpu_model = Fast3R.from_random(Fast3RConfig.flagship(), seed=0,
                                   device="cpu")
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"model built and moved in {time.perf_counter() - t0:.1f} s")
    inference(request_views(2, 512, 512, 97), model, verbose=False)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    for serve in (1, 2):
        _serve("square", model, request_views(20, 512, 512, 200 + serve),
               serve, gpu)
    counts = _read_counts()
    # two requests x two head calls (global, local), all on the unfused road
    _expect("square", counts, trunk=0, resize=4)
    # the stage split at 512x512 (unfused head road) and, for the heads'
    # other road, at 384x512 (trunk kernel)
    for H, W in ((512, 512), (384, 512)):
        result, info = inference(request_views(20, H, W, 203), model,
                                 verbose=False, profiling=True)
        check_preds(result["preds"], [(H, W)] * 20)
        log(json.dumps({"path": "square", "request_views": 20,
                        "image_hw": [H, W], "profiling_info": info,
                        "gpu": gpu}))
    return cpu_model, model, {"square": counts}


def phase_mixed(gpu: str, model) -> dict:
    log("== phase 12: a mixed request (8 views at 384x512, 6 at 512x384, 6 "
        "at 448x512)")
    g = torch.Generator().manual_seed(12)
    views = [{"img": torch.rand((1, H, W, 3), generator=g) * 2 - 1,
              "true_shape": [[H, W]]}
             for n, H, W in ((8, 384, 512), (6, 512, 384), (6, 448, 512))
             for _ in range(n)]
    _reset_counts()
    for serve in (1, 2):
        _serve("mixed", model, views, serve, gpu)
    counts = _read_counts()
    # per request: the heads run once per shape group, global and local;
    # the 384x512 and 512x384 groups on the trunk kernel, 448x512 on K12
    _expect("mixed", counts, trunk=8, resize=4)
    return {"mixed": counts}


def phase_head_end_to_end(cpu_model, model) -> dict:
    log("== phase 13: the head at 512x512, bf16 on the card (unfused road, "
        "K12) vs fp32 on the CPU")
    g = torch.Generator().manual_seed(13)
    toks = [torch.randn((1, 1024, 1024), generator=g) for _ in range(4)]
    hw = (512, 512)
    with torch.inference_mode():
        t = time.perf_counter()
        ref = dpt_head_forward(cpu_model.params.head_global,
                               cpu_model.cfg.head, toks, hw)
        t_cpu = time.perf_counter() - t
        _reset_counts()
        out = dpt_head_forward(model.params.head_global, model.cfg.head,
                               [x.cuda().bfloat16() for x in toks], hw)
        counts = _read_counts()
    _expect("head 512x512", counts, trunk=0, resize=1)
    errs = {k: ((out[k].float().cpu() - ref[k]).norm() / ref[k].norm()).item()
            for k in ref}
    log(json.dumps({"head_rel_l2_err": errs, "tolerance": E2E_REL_L2,
                    "cpu_fp32_s": t_cpu}))
    bad = {k: e for k, e in errs.items() if not e <= E2E_REL_L2}
    if bad:
        raise AssertionError(f"head end-to-end error above {E2E_REL_L2}: "
                             f"{bad}")
    return errs


# phase 14: the device resample against PIL's moves inputs by a few uint8
# steps, and outputs by less than this (relative, L2)
RAW_REL_L2 = 0.02
POSE_ATOL = 1e-3  # card vs CPU, fp32, same predictions and minimal samples


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth seeded photo (low-frequency content, as photos have)."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (h // 32, w // 32, 3)).astype(np.uint8)
    return np.asarray(PIL.Image.fromarray(small).resize(
        (w, h), PIL.Image.BICUBIC), np.uint8)


def _read_ply_header(path: str):
    with open(path, "rb") as f:
        lines = []
        while not lines or lines[-1] != b"end_header":
            lines.append(f.readline().strip())
        return [x.decode() for x in lines], f.tell(), os.path.getsize(path)


def phase_images_to_poses(gpu: str, model) -> dict:
    log("== phase 14: images to poses (fast3r_torch.cli.reconstruct on 6 "
        "seeded 1152x1008 PNGs, random flagship weights seed 0, bfloat16)")
    with tempfile.TemporaryDirectory() as tmp:
        images, out_dir = os.path.join(tmp, "images"), os.path.join(tmp, "out")
        os.makedirs(images)
        for i in range(6):
            PIL.Image.fromarray(_photo(1008, 1152, 140 + i)).save(
                os.path.join(images, f"{i:02d}.png"))
        _reset_counts()
        t = time.perf_counter()
        res = reconstruct.main([images, "--out", out_dir, "--gif"])
        total = time.perf_counter() - t
        counts = _read_counts()
        with PIL.Image.open(os.path.join(out_dir, "orbit.gif")) as gif:
            gif_frames, gif_size = gif.n_frames, gif.size
        if (gif_frames, gif_size) != (24, (640, 480)):
            raise AssertionError(f"orbit.gif: {gif_frames} frames of "
                                 f"{gif_size}")
        check_preds([{k: p[k] for k in OUT_KEYS} for p in res["preds"]],
                    [(448, 512)] * 6)
        with open(os.path.join(out_dir, "poses.json")) as f:
            poses = json.load(f)
        c2w, focals = np.asarray(poses["poses_c2w"]), np.asarray(
            poses["focals"])
        if c2w.shape != (6, 4, 4) or focals.shape != (6,) or not (
                np.isfinite(c2w).all() and np.isfinite(focals).all()):
            raise AssertionError(f"poses.json: c2w {c2w.shape}, focals "
                                 f"{focals.tolist()}")
        header, start, size = _read_ply_header(os.path.join(out_dir,
                                                            "scene.ply"))
        n = int(header[2].split()[-1])
        if (header[:2] != ["ply", "format binary_little_endian 1.0"]
                or n != res["points"] or n == 0 or size != start + 15 * n):
            raise AssertionError(f"scene.ply: header {header}, {size} bytes, "
                                 f"{res['points']} points")
        log(json.dumps({"path": "images_to_poses", "views": 6,
                        "image_hw": [448, 512], "stage_s": res["times"],
                        "total_s": total, "points": n, "gpu": gpu}))

        # the device resample against PIL, same model and frames
        t = time.perf_counter()
        raw = inference_from_raw(load_images_raw(images, verbose=False),
                                 model, verbose=False)["preds"]
        t_raw = time.perf_counter() - t
        host = inference(load_images(images, size=512, verbose=False), model,
                         verbose=False)["preds"]
        errs = {k: (torch.cat([p[k] for p in raw])
                    - torch.cat([p[k] for p in host])).norm().item()
                / torch.cat([p[k] for p in host]).norm().item()
                for k in OUT_KEYS}
        log(json.dumps({"raw_vs_host_rel_l2": errs, "tolerance": RAW_REL_L2,
                        "inference_from_raw_s": t_raw}))
        if max(errs.values()) > RAW_REL_L2:
            raise AssertionError(f"inference_from_raw vs load_images: {errs}")

    # the CLI's first calls pay one-off costs (the linear-algebra
    # libraries' set-up): its align and pose stages again, warm
    t = time.perf_counter()
    align_local_pts3d_to_global(res["preds"], min_conf_thr_percentile=85.0)
    torch.cuda.synchronize()
    t_align = time.perf_counter() - t
    t = time.perf_counter()
    estimate_camera_poses(res["preds"])
    log(json.dumps({"path": "images_to_poses", "warm_align_s": t_align,
                    "warm_pose_s": time.perf_counter() - t}))

    # pose recovery: the card against fp32 on the CPU on the same
    # predictions and minimal samples.  The random model's pointmaps give an
    # ill-posed problem (any tie between hypotheses decides), so the
    # predictions are a seeded scene seen by known cameras, with noise and
    # confident outliers, at half the CLI's view shape in each dimension
    # (the CPU's Gauss-Newton polish over every hypothesis and point takes
    # about 25 s at the full shape; the card's pose stage ran it above)
    preds, gt = pose_scene(3, *POSE_HW, seed=14)
    mask = torch.stack([torch.as_tensor(p["conf"][0]).reshape(-1) > 1.0
                        for p in preds]).cuda()
    idx = draw_samples(mask, 32, 8,
                       torch.Generator(device="cuda").manual_seed(0))
    t = time.perf_counter()
    on_gpu, f_gpu = estimate_camera_poses(preds, device="cuda",
                                          sample_idx=[idx])
    t_gpu = time.perf_counter() - t
    t = time.perf_counter()
    on_cpu, f_cpu = estimate_camera_poses(preds, device="cpu",
                                          sample_idx=[idx.cpu()])
    t_cpu = time.perf_counter() - t
    err = float(np.abs(np.stack(on_gpu[0]) - np.stack(on_cpu[0])).max())
    gt_err = float(np.abs(np.stack(on_gpu[0]) - gt).max())
    log(json.dumps({"pose_gpu_vs_cpu_max_abs": err, "tolerance": POSE_ATOL,
                    "pose_gpu_vs_truth_max_abs": gt_err,
                    "focal_gpu": f_gpu[0][0], "focal_cpu": f_cpu[0][0],
                    "focal_truth": POSE_FOCAL, "pose_gpu_s": t_gpu,
                    "pose_cpu_s": t_cpu}))
    if not err <= POSE_ATOL:
        raise AssertionError(f"pose recovery, card vs CPU: {err}")

    # a focal a view: a 20-view request at the served shape on a seeded
    # scene of known cameras whose focals differ (spread over the search's
    # grid), every view's focal within two grid steps of its own truth
    # (tests/test_torch_focal_gif.py's bound)
    truth = np.geomspace(0.7, 2.4, 20) * 512
    preds, gt = pose_scene(20, 384, 512, seed=15, focals=truth)
    torch.cuda.synchronize()
    t = time.perf_counter()
    poses, focals = estimate_camera_poses(
        preds, focal_length_estimation_method="individual", device="cuda")
    t_ind = time.perf_counter() - t
    steps = np.log(np.asarray(focals[0]) / truth) / FOCAL_GRID_STEP
    rot_err = float(np.abs(np.stack(poses[0])[:, :3, :3]
                           - gt[:, :3, :3]).max())
    log(json.dumps({"path": "individual_focals", "views": 20,
                    "image_hw": [384, 512], "pose_s": t_ind,
                    "focal_truth": truth.round(2).tolist(),
                    "focal_grid_steps_from_truth": steps.round(3).tolist(),
                    "rotation_max_abs_err": rot_err,
                    "pose_max_abs_err": float(np.abs(np.stack(poses[0])
                                                     - gt).max()),
                    "gpu": gpu}))
    if not (np.isfinite(np.stack(poses[0])).all()
            and np.abs(steps).max() <= 2.0 + 1e-3):
        raise AssertionError(f"individual focals: {steps.tolist()} grid "
                             f"steps from {truth.tolist()}")

    # the focal search on the card against fp32 on the CPU, on the same
    # predictions and minimal samples: 8 views of different focals at the
    # served shape, 3% of the pixels confident (so that the CPU scores in
    # seconds), 25,600 hypotheses (the card's eigh in chunks of at most
    # EIGH_BATCH).  Inlier counts of the two focals beside a truth can tie
    # within a rounding, so the two choices agree within one grid step
    truth = np.geomspace(0.7, 2.4, 8) * 512
    preds, _ = pose_scene(8, 384, 512, seed=16, focals=truth)
    pts = torch.cat([p["pts3d_in_other_view"] for p in preds])
    conf = torch.cat([p["conf"] for p in preds])
    conf[torch.rand(conf.shape, generator=torch.Generator().manual_seed(16))
         >= 0.03] = 0.5
    idx = draw_samples((conf > 1.0).reshape(8, -1).cuda(), 32, 8,
                       torch.Generator(device="cuda").manual_seed(1))
    assert 8 * NUM_FOCALS * 32 > EIGH_BATCH
    t = time.perf_counter()
    f_gpu = individual_focals(pts.cuda(), conf.cuda(), sample_idx=idx).cpu()
    t_gpu = time.perf_counter() - t
    t = time.perf_counter()
    f_cpu = individual_focals(pts, conf, sample_idx=idx.cpu())
    t_cpu = time.perf_counter() - t
    apart = np.abs(np.log(f_gpu.numpy() / f_cpu.numpy())) / FOCAL_GRID_STEP
    steps = np.log(f_gpu.numpy() / truth) / FOCAL_GRID_STEP
    log(json.dumps({"path": "focal_sweep_gpu_vs_cpu", "views": 8,
                    "image_hw": [384, 512], "focal_truth":
                    truth.round(2).tolist(),
                    "focal_gpu": f_gpu.tolist(), "focal_cpu": f_cpu.tolist(),
                    "equal": int((f_gpu == f_cpu).sum()),
                    "grid_steps_apart": apart.round(3).tolist(),
                    "gpu_grid_steps_from_truth": steps.round(3).tolist(),
                    "sweep_gpu_s": t_gpu, "sweep_cpu_s": t_cpu}))
    if not (apart.max() <= 1.0 + 1e-3 and np.abs(steps).max() <= 2.0 + 1e-3):
        raise AssertionError(f"focal search, card {f_gpu.tolist()} vs CPU "
                             f"{f_cpu.tolist()}, truth {truth.tolist()}")
    return {"images_to_poses": counts}


POSE_FOCAL = 420.0
FOCAL_GRID_STEP = math.log(6.0) / 99  # ops.pnp.focal_grid's ratio
POSE_HW = (224, 256)  # the pose comparison's view shape


def pose_scene(V: int, H: int, W: int, seed: int, focals=None):
    """Predictions of a seeded scene: V cameras (view 0 the identity) with
    focal POSE_FOCAL, or ``focals[v]`` for view v, see depths of 2-4, the
    pointmaps in view 0's frame with 1% depth noise, 5% confident outliers
    and 15% pixels under the conf > 1 mask.  Returns the preds and the true
    c2w (V, 4, 4)."""
    f = np.broadcast_to(POSE_FOCAL if focals is None
                        else np.asarray(focals, np.float64), (V,))
    f = f[:, None, None]
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4), (V, 1, 1))
    for v in range(1, V):
        a = rng.normal(size=3)
        a *= rng.uniform(0.05, 0.25) / np.linalg.norm(a)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        th = np.linalg.norm(a)
        c2w[v, :3, :3] = (np.eye(3) + np.sin(th) / th * K
                          + (1 - np.cos(th)) / th ** 2 * K @ K)
        c2w[v, :3, 3] = rng.normal(size=3) * 0.3
    ys, xs = np.mgrid[:H, :W].astype(np.float64)
    depth = rng.uniform(2.0, 4.0, (V, H, W))
    cam = np.stack([depth * (xs - W / 2) / f,
                    depth * (ys - H / 2) / f, depth], -1)
    cam *= 1 + 0.01 * rng.normal(size=(V, H, W, 1))
    pts = np.einsum("vij,vhwj->vhwi", c2w[:, :3, :3], cam) \
        + c2w[:, None, None, :3, 3]
    conf = rng.uniform(1.2, 3.0, (V, H, W))
    out = rng.random((V, H, W)) < 0.05
    pts[out] += rng.normal(0, 0.5, (int(out.sum()), 3))
    conf[rng.random((V, H, W)) < 0.15] = 0.5
    preds = [{"pts3d_in_other_view": torch.from_numpy(
                  pts[v:v + 1].astype(np.float32)),
              "conf": torch.from_numpy(conf[v:v + 1].astype(np.float32))}
             for v in range(V)]
    return preds, c2w.astype(np.float32)


# ---------------------------------------------------------------------------
# phases 15-16: the ring kernel and the sequence-sharded request
# ---------------------------------------------------------------------------

RING_N = (1, 2, 3, 4, 8)
SELF_EPOCHS = 4
SEQ_RANKS = 4
SEQ_REL_L2 = 0.02  # seq-sharded vs single-device, both bf16 on the card


def _ring_qkv(n: int, dtype, seed: int, tokens: int = M_TOK, D: int = 64):
    """Rank-stacked q, k, v (n, 1, tokens // n, 16, D): strided views of one
    qkv buffer, as the decoder's projection gives them."""
    qkv = torch.randn((n, 1, tokens // n, 3, 16, D), generator=_gen(seed),
                      device="cuda").to(dtype)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


def _ring_plain_by_head(q, k, v, scale, epochs=None):
    """The plain ring one head at a time (at n = 1 the full score matrices
    of all heads would not fit at once); B = 1."""
    outs, lses = zip(*(ring_flash_attention(
        q[:, :, :, h:h + 1], k[:, :, :, h:h + 1], v[:, :, :, h:h + 1], scale,
        epochs) for h in range(q.shape[3])))
    return torch.cat(outs, dim=3), torch.cat(lses, dim=1)


def _ring_bound(n: int, epochs: int, s_loc: int, dtype, D: int = 64) -> dict:
    """FLOPs of n ranks x E epochs of S_loc x S_loc attention at the bf16
    peak (fp32: the CUDA-core peak), or the bytes at 3.35 TB/s: q, k, v
    read and o, lse written once and E - 1 hops of K and V per rank, each
    read and written.  The kernel's own traffic, not the function's, is
    apart in ``scratch_bytes``: the fp32 bootstrap copy (the bf16 ring reads
    epoch 0 in place) and the online-softmax state (acc, m, l in fp32)
    stored and loaded at each of the E - 1 epoch boundaries."""
    H, it = 16, torch.tensor([], dtype=dtype).element_size()
    tok = n * s_loc * H * D * it  # one (n, S_loc, H, D) tensor
    nbytes = 4 * tok + n * H * s_loc * 4 + 4 * (epochs - 1) * tok
    scratch = ((4 * tok if dtype == torch.float32 else 0)
               + 2 * (epochs - 1) * n * s_loc * H * (D + 2) * 4)
    return dict(bound(4.0 * n * epochs * s_loc * s_loc * H * D, nbytes, dtype),
                scratch_bytes=scratch)


def phase_ring(results: list) -> None:
    log("== phase 15: the ring kernel (K14's forward) at the decoder's shape "
        "vs the plain ring")
    bf = torch.bfloat16
    for n, epochs in [(n, n) for n in RING_N] + [(1, SELF_EPOCHS)]:
        self_ring = epochs != n
        q, k, v = _ring_qkv(n, bf, 15 + n + epochs)
        o, lse = _rdma_forward(q, k, v, DEC_SCALE, n,
                               SELF_EPOCHS if self_ring else None)
        # the self-ring's reference is plain attention, its lse + ln E
        ref_o, ref_lse = _ring_plain_by_head(q, k, v, DEC_SCALE)
        torch.cuda.synchronize()
        r = compare("ring", o, ref_o, bf)
        shift = math.log(epochs) if self_ring else 0.0
        r_lse = compare("ring_lse", lse, ref_lse + shift, bf)
        del ref_o, ref_lse
        s_loc = M_TOK // n
        case = (f"n=1 self-ring E={epochs}" if self_ring else f"n={n} ") + \
            f" {n}x1x{s_loc}x16x64 ({M_TOK} tokens)"
        args = (q, k, v, DEC_SCALE, n) + ((SELF_EPOCHS,) if self_ring else ())
        r.update(kernel="ring_attention", case=case, dtype="bfloat16",
                 lse_max_abs_err=r_lse["max_abs_err"],
                 lse_shift=shift,
                 ms=median_ms(lambda: ring_flash_attention_rdma(*args),
                              10 if n == SEQ_RANKS else 5),
                 plain_ms=None, library=None, library_ms=None,
                 **_ring_bound(n, epochs, s_loc, bf),
                 **fwd_rates(float(n * epochs) * s_loc * s_loc * 16, 64,
                             lambda: ring_flash_attention_rdma(*args),
                             "ring_attention_fwd_kernel"))
        # the same function on the gathered sequence: K1 (and, at n = 4,
        # SDPA), the ring's time over K1's
        qf, kf, vf = (t.reshape(1, M_TOK, 16, 64) for t in (q, k, v))
        k1 = fwd_rates(float(M_TOK) * M_TOK * 16, 64,
                       lambda: flash_attention(qf, kf, vf, DEC_SCALE),
                       "attention_fwd_kernel")
        r["k1_device_ms"] = k1["device_ms"] * (epochs if self_ring else 1)
        r["device_over_k1"] = r["device_ms"] / r["k1_device_ms"]
        if n == SEQ_RANKS and not self_ring:
            r["plain_ms"] = median_ms(
                lambda: ring_flash_attention(q, k, v, DEC_SCALE), 3)
            r["k1_ms"] = median_ms(
                lambda: flash_attention(qf, kf, vf, DEC_SCALE), 10)
            r["ms_over_k1"] = r["ms"] / r["k1_ms"]
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qf, kf, vf))
            r["library"] = "F.scaled_dot_product_attention (gathered)"
            r["library_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=DEC_SCALE), 10)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, scale=DEC_SCALE)
            lib_batched = _batched_ms(sdpa)
            lib = _all_kernels_ms(sdpa)
            r["library_device_ms"] = lib if lib >= 0.9 * lib_batched else lib_batched
            del qt, kt, vt
        del qf, kf, vf
        results.append(r)
        log(json.dumps(r))
        del q, k, v, o, lse
        torch.cuda.empty_cache()

    # the fp32 variant at n = SEQ_RANKS, tight
    q, k, v = _ring_qkv(SEQ_RANKS, torch.float32, 16)
    o, lse = _rdma_forward(q, k, v, DEC_SCALE, SEQ_RANKS)
    ref_o, ref_lse = _ring_plain_by_head(q, k, v, DEC_SCALE)
    torch.cuda.synchronize()
    r = compare("ring", o, ref_o, torch.float32)
    r.update(kernel="ring_attention", dtype="float32",
             case=f"n={SEQ_RANKS} fp32",
             lse_max_abs_err=compare("ring_lse", lse, ref_lse,
                                     torch.float32)["max_abs_err"],
             ms=median_ms(lambda: _rdma_forward(q, k, v, DEC_SCALE,
                                                SEQ_RANKS), 3),
             **_ring_bound(SEQ_RANKS, SEQ_RANKS, M_TOK // SEQ_RANKS,
                           torch.float32))
    results.append(r)
    log(json.dumps(r))
    del q, k, v, o, lse, ref_o, ref_lse
    torch.cuda.empty_cache()
    phase_ring_d80(results)


# model_scaling_huge's decoder (1280 x 32, 16 heads of 80) on 20 views at
# 224x224: 3920 tokens; its inference scale (the attention-entropy bias) and
# its training scale
HUGE_VIEWS, HUGE_HW, HUGE_D = 20, (224, 224), 80
HUGE_TOK = HUGE_VIEWS * (HUGE_HW[0] // 16) * (HUGE_HW[1] // 16)
HUGE_DEC_SCALE = HUGE_D ** -0.5 * math.sqrt(math.log(137) / math.log(20))
HUGE_TRAIN_SCALE = HUGE_D ** -0.5
HUGE_STEPS = 2  # phase 29's seq-sharded steps


def phase_ring_d80(results: list) -> None:
    """K14's forward at head_dim 80, model_scaling_huge's shape: 20 views at
    224x224 (3920 tokens; n = 3 takes 3 x 1306), 16 heads, over n = 1, 2,
    3, 4, 8 ranks in bf16 and n = 4 in fp32, against the plain ring under
    the head_dim-64 rules; each line with the ring's time, K1<80>'s and
    SDPA's on the gathered sequence and the bound, at n = 4 also the ring's
    device time and the plain ring's time."""
    log("-- phase 15 at head_dim 80: model_scaling_huge's decoder, "
        f"{HUGE_VIEWS} views at {HUGE_HW[0]}x{HUGE_HW[1]} ({HUGE_TOK} "
        f"tokens, 16 heads of {HUGE_D})")
    scale = HUGE_DEC_SCALE
    gathered = {}  # tokens -> K1<80>'s and SDPA's times on them
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for n in RING_N if dtype == torch.bfloat16 else (SEQ_RANKS,):
            q, k, v = _ring_qkv(n, dtype, 90 + n, HUGE_TOK, HUGE_D)
            s_loc = q.shape[2]
            tokens = n * s_loc
            o, lse = _rdma_forward(q, k, v, scale, n)
            ref_o, ref_lse = _ring_plain_by_head(q, k, v, scale)
            torch.cuda.synchronize()
            r = compare("ring", o, ref_o, dtype)
            lse_err = compare("ring_lse", lse, ref_lse, dtype)["max_abs_err"]
            del ref_o, ref_lse
            ring = lambda: ring_flash_attention_rdma(q, k, v, scale, n)  # noqa: E731
            main = n == SEQ_RANKS
            r.update(kernel="ring_attention", dtype=name,
                     case=f"head_dim 80 n={n} {n}x1x{s_loc}x16x80 "
                          f"({tokens} tokens)",
                     lse_max_abs_err=lse_err, ms=median_ms(ring, 10),
                     plain_ms=median_ms(lambda: ring_flash_attention(
                         q, k, v, scale), 3) if main else None,
                     plain="ring_flash_attention (the plain ring)",
                     library=None, library_ms=None,
                     **_ring_bound(n, n, s_loc, dtype, HUGE_D))
            if dtype == torch.bfloat16:
                if main:
                    r.update(fwd_rates(float(n * n) * s_loc * s_loc * 16,
                                       HUGE_D, ring, "ring_attention_fwd_kernel"))
                if tokens not in gathered:
                    qf, kf, vf = (t.reshape(1, tokens, 16, HUGE_D)
                                  for t in (q, k, v))
                    qt, kt, vt = (t.transpose(1, 2).contiguous()
                                  for t in (qf, kf, vf))
                    gathered[tokens] = {
                        "k1_ms": median_ms(lambda: flash_attention(
                            qf, kf, vf, scale), 10),
                        "library": "F.scaled_dot_product_attention (gathered)",
                        "library_ms": median_ms(
                            lambda: F.scaled_dot_product_attention(
                                qt, kt, vt, scale=scale), 10)}
                    del qf, kf, vf, qt, kt, vt
                r.update(gathered[tokens])
                r["ms_over_k1"] = r["ms"] / r["k1_ms"]
            results.append(r)
            log(json.dumps(r))
            del q, k, v, o, lse
            torch.cuda.empty_cache()


def _seq_imgs(V: int, H: int, W: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((1, V, H, W, 3), generator=g) * 2 - 1


def _rel_l2(out: dict, ref: dict) -> dict:
    return {k: ((out[k].float().cpu() - ref[k].float().cpu()).norm()
                / ref[k].float().cpu().norm()).item() for k in OUT_KEYS}


def phase_seq_sharded(gpu: str) -> dict:
    log(f"== phase 16: the sequence-sharded request (flagship, random "
        f"weights seed 0, bfloat16, {SEQ_RANKS} ranks, ring kernel)")
    t0 = time.perf_counter()
    cfg = Fast3RConfig.flagship()
    cpu_model = Fast3R.from_random(cfg, seed=0, device="cpu")
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"model built and moved in {time.perf_counter() - t0:.1f} s")
    V, H, W = 20, 384, 512
    fwd = make_seq_sharded_forward(cfg, SEQ_RANKS, V, (H, W),
                                   ring_impl="rdma")
    imgs = _seq_imgs(V, H, W, 16)
    ids = sample_random_image_ids(None, 1, V)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    for serve in (1, 2, 3):  # one cold request, two warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fwd(model.params, imgs, ids[0])
        out = {k: v.float().cpu() for k, v in out.items()}
        dt = time.perf_counter() - t
        log(json.dumps({"path": "seq_sharded", "ranks": SEQ_RANKS,
                        "request_views": V, "image_hw": [H, W],
                        "serve": serve, "latency_s": dt,
                        "images_per_s": V / dt, "gpu": gpu,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    counts = _read_counts()
    log(json.dumps({"path": "seq_sharded", "requests": 3,
                    "launches_per_request": {k: c / 3 for k, c in
                                             counts.items()}}))
    _expect("seq_sharded", counts, ring_attention=3 * cfg.decoder.depth,
            attention=0)
    check_preds([{k: v[:, i] for k, v in out.items()} for i in range(V)],
                [(H, W)] * V)

    # the single-device forward on the card: same weights, same decoder
    # block road (plain), same image ids
    plain_dec = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, fused_blocks=False))
    with torch.inference_mode():
        for _ in range(2):  # the second one warm, timed as the requests
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref = fast3r_forward(model.params, plain_dec,
                                 imgs.cuda().bfloat16(), view_ids=ids)
            ref = {k: v.float().cpu() for k, v in ref.items()}
            t_single = time.perf_counter() - t
    errs = _rel_l2(out, ref)
    del ref

    # a 2-view 224x224 request over 2 ranks against fp32 on the CPU
    imgs2, ids2 = _seq_imgs(2, 224, 224, 17), sample_random_image_ids(None, 1, 2)
    out2 = make_seq_sharded_forward(cfg, 2, 2, (224, 224))(model.params,
                                                          imgs2, ids2[0])
    with torch.inference_mode():
        ref2 = fast3r_forward(cpu_model.params, cfg, imgs2, view_ids=ids2)
    errs2 = _rel_l2(out2, ref2)
    log(json.dumps({"single_device_warm_latency_s": t_single,
                    "seq_vs_single_device_rel_l2": errs,
                    "tolerance": SEQ_REL_L2,
                    "seq_2x224_vs_cpu_fp32_rel_l2": errs2,
                    "tolerance_cpu": E2E_REL_L2}))
    bad = {k: e for k, e in errs.items() if not e <= SEQ_REL_L2}
    bad.update({f"2x224 {k}": e for k, e in errs2.items()
                if not e <= E2E_REL_L2})
    if bad:
        raise AssertionError(f"sequence-sharded outputs off: {bad}")
    return {"seq_sharded": counts}


# ---------------------------------------------------------------------------
# phases 17-18: the backward ring kernels and the sequence-sharded training
# step
# ---------------------------------------------------------------------------

def _ring_bwd_bound(n: int, s_loc: int, dtype, kernel: str,
                    D: int = 64) -> dict:
    """The least time of the dq ring, the dk/dv ring or the pair at the
    decoder's shape.  FLOPs: the five products per (query, key) pair, 10 N^2
    H D, 2.5x the forward's (K9's bound); the dq ring alone does three of
    them (6 N^2 H D: it recomputes s and dp), the dk/dv ring four (8).
    Bytes, at 3.35 TB/s: each ring's inputs read and outputs written once
    (q, k, v, do, dq, lse, delta; q, k, v, do, dk, dv, the (lse, delta)
    pairs; the pair: q, k, v, o, do, lse, dq, dk, dv) and its n - 1 hops of
    its payloads, each read and written (K and V; q, do and the pairs).  The
    kernels' own traffic is apart in ``scratch_bytes``: the bootstrap copy
    of the payloads and the fp32 accumulators (dq; dk and dv) stored and
    loaded at the n - 1 epoch boundaries."""
    H, it = 16, torch.tensor([], dtype=dtype).element_size()
    tok = n * s_loc * H * D * it  # one (n, S_loc, H, D) tensor
    rows = n * s_loc * H
    acc = n * H * -(-s_loc // 64) * 64 * D * 4  # one fp32 accumulator per item
    pay_dq, pay_dkv = 2 * tok, 2 * tok + rows * 8  # one copy of the payloads
    hops_dq, hops_dkv = 2 * (n - 1) * pay_dq, 2 * (n - 1) * pay_dkv
    nbytes = {"dq": 5 * tok + 2 * rows * 4 + hops_dq,
              "dkv": 6 * tok + rows * 8 + hops_dkv,
              "pair": 8 * tok + rows * 4 + hops_dq + hops_dkv}[kernel]
    scratch = {"dq": 2 * pay_dq + 2 * (n - 1) * acc,
               "dkv": 2 * pay_dkv + 2 * (n - 1) * 2 * acc}
    scratch["pair"] = scratch["dq"] + scratch["dkv"]
    flops = {"dq": 6, "dkv": 8, "pair": 10}[kernel] * float(n * s_loc) ** 2 * H * D
    return dict(bound(flops, nbytes, dtype), scratch_bytes=scratch[kernel])


def _ring_bwd_plain_by_head(q, k, v, o, lse, do, scale):
    """ring_attention_bwd_ref one head at a time (at n = 1 the full score
    matrices of all heads would not fit at once); B = 1."""
    per_head = [ring_attention_bwd_ref(
        q[:, :, :, h:h + 1], k[:, :, :, h:h + 1], v[:, :, :, h:h + 1],
        o[:, :, :, h:h + 1], lse[:, h:h + 1], do[:, :, :, h:h + 1], scale)
        for h in range(q.shape[3])]
    return tuple(torch.cat([g[i] for g in per_head], dim=3) for i in range(3))


def phase_ring_bwd(results: list) -> None:
    log("== phase 17: the backward ring kernels (K14's backward) at the "
        "decoder's shape vs their plain version")
    for dtype in (torch.bfloat16, torch.float32):
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        # fp32 (summation order only) at the main rank count, as phase 15
        for n in RING_N if dtype == torch.bfloat16 else (SEQ_RANKS,):
            q, k, v = _ring_qkv(n, dtype, 70 + n)
            do = torch.randn(q.shape, generator=_gen(80 + n),
                             device="cuda").to(dtype)
            o, lse = _rdma_forward(q, k, v, TRAIN_SCALE, n)
            got = _ring_backward(q, k, v, o, lse, do, TRAIN_SCALE, n)
            ref = _ring_bwd_plain_by_head(q, k, v, o, lse, do, TRAIN_SCALE)
            torch.cuda.synchronize()
            kind = "attention_bwd" if dtype == torch.bfloat16 else "ring_bwd"
            errs = [compare(kind, a, b, dtype) for a, b in zip(got, ref)]
            del got, ref
            torch.cuda.empty_cache()
            delta, meta = _bwd_rows(o, do, lse)
            main = n == SEQ_RANKS
            reps = (10 if main else 5) if dtype == torch.bfloat16 else 3
            s_loc = M_TOK // n
            extra = {
                "pair_ms": median_ms(lambda: _ring_backward(
                    q, k, v, o, lse, do, TRAIN_SCALE, n), reps),
                "pair_bound_ms": _ring_bwd_bound(n, s_loc, dtype,
                                                 "pair")["bound_ms"],
                "plain_ms": None, "library": None, "library_ms": None}
            times = {
                "ring_attention_bwd_dq": median_ms(lambda: ring_attention_bwd_dq(
                    q, k, v, do, lse, delta, TRAIN_SCALE, n), reps),
                "ring_attention_bwd_dkv": median_ms(
                    lambda: ring_attention_bwd_dkv(q, k, v, do, meta,
                                                   TRAIN_SCALE, n), reps)}
            if main:
                extra["plain_ms"] = median_ms(lambda: _ring_bwd_plain_by_head(
                    q, k, v, o, lse, do, TRAIN_SCALE), 1)
                extra["plain"] = ("ring_attention_bwd_ref, one head at a "
                                  "time (both rings)")
            if main and dtype == torch.bfloat16:
                # the same function on the gathered sequence: K9 and the
                # autograd of SDPA
                qf, kf, vf, dof = (t.reshape(1, M_TOK, 16, 64)
                                   for t in (q, k, v, do))
                of, lsef = attention_fwd_lse(qf, kf, vf, TRAIN_SCALE)
                extra["k9_ms"] = median_ms(lambda: attention_bwd(
                    qf, kf, vf, of, lsef, dof, TRAIN_SCALE), 10)
                ql, kl, vl = (t.detach().transpose(1, 2).contiguous()
                              .requires_grad_() for t in (qf, kf, vf))
                ol = F.scaled_dot_product_attention(ql, kl, vl,
                                                    scale=TRAIN_SCALE)
                extra["library"] = ("autograd of F.scaled_dot_product_attention "
                                    "(gathered)")
                extra["library_ms"] = _grad_ms(ol, (ql, kl, vl),
                                               dof.transpose(1, 2), 10)
                del qf, kf, vf, dof, of, lsef, ql, kl, vl, ol
            flops = {"dq": 6.0, "dkv": 8.0}  # the products each ring runs
            for kname, e, which in (("ring_attention_bwd_dq", errs[:1], "dq"),
                                    ("ring_attention_bwd_dkv", errs[1:], "dkv")):
                r = dict(_merge(e), kernel=kname, dtype=name,
                         case=f"n={n} {n}x1x{s_loc}x16x64 ({M_TOK} tokens)",
                         ms=times[kname],
                         tflops=flops[which] * float(M_TOK) ** 2 * 16 * 64
                         / (times[kname] * 1e-3) / 1e12, **extra,
                         **_ring_bwd_bound(n, s_loc, dtype, which))
                results.append(r)
                log(json.dumps(r))
            del q, k, v, do, o, lse, delta, meta
            torch.cuda.empty_cache()
    phase_ring_bwd_d80(results)


def phase_ring_bwd_d80(results: list) -> None:
    """K14's backward rings at head_dim 80, model_scaling_huge's shape
    (phase_ring_d80's), over n = 1, 2, 3, 4, 8 in bf16 and n = 4 in fp32,
    against ring_attention_bwd_ref under the head_dim-64 rules; each line
    with the ring's time, the pair's, K9<80>'s and SDPA's autograd's on the
    gathered sequence and the bounds, at n = 4 the plain version's time."""
    log("-- phase 17 at head_dim 80: model_scaling_huge's decoder, "
        f"{HUGE_TOK} tokens, 16 heads of {HUGE_D}")
    scale = HUGE_TRAIN_SCALE
    gathered = {}  # tokens -> K9<80>'s and SDPA's autograd times on them
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for n in RING_N if dtype == torch.bfloat16 else (SEQ_RANKS,):
            q, k, v = _ring_qkv(n, dtype, 95 + n, HUGE_TOK, HUGE_D)
            do = torch.randn(q.shape, generator=_gen(85 + n),
                             device="cuda").to(dtype)
            s_loc = q.shape[2]
            tokens = n * s_loc
            o, lse = _rdma_forward(q, k, v, scale, n)
            got = _ring_backward(q, k, v, o, lse, do, scale, n)
            ref = _ring_bwd_plain_by_head(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            kind = "attention_bwd" if dtype == torch.bfloat16 else "ring_bwd"
            errs = [compare(kind, a, b, dtype) for a, b in zip(got, ref)]
            del got, ref
            delta, meta = _bwd_rows(o, do, lse)
            main = n == SEQ_RANKS
            extra = {
                "pair_ms": median_ms(lambda: _ring_backward(
                    q, k, v, o, lse, do, scale, n), 10),
                "pair_bound_ms": _ring_bwd_bound(n, s_loc, dtype, "pair",
                                                 HUGE_D)["bound_ms"],
                "plain_ms": median_ms(lambda: _ring_bwd_plain_by_head(
                    q, k, v, o, lse, do, scale), 1) if main else None,
                "plain": "ring_attention_bwd_ref, one head at a time (both "
                         "rings)",
                "library": None, "library_ms": None}
            if dtype == torch.bfloat16:
                if tokens not in gathered:
                    qf, kf, vf, dof = (t.reshape(1, tokens, 16, HUGE_D)
                                       for t in (q, k, v, do))
                    of, lsef = attention_fwd_lse(qf, kf, vf, scale)
                    ql, kl, vl = (t.detach().transpose(1, 2).contiguous()
                                  .requires_grad_() for t in (qf, kf, vf))
                    ol = F.scaled_dot_product_attention(ql, kl, vl,
                                                        scale=scale)
                    gathered[tokens] = {
                        "k9_ms": median_ms(lambda: attention_bwd(
                            qf, kf, vf, of, lsef, dof, scale), 10),
                        "library": "autograd of "
                                   "F.scaled_dot_product_attention (gathered)",
                        "library_ms": _grad_ms(ol, (ql, kl, vl),
                                               dof.transpose(1, 2), 10)}
                    del qf, kf, vf, dof, of, lsef, ql, kl, vl, ol
                extra.update(gathered[tokens])
            times = {
                "ring_attention_bwd_dq": median_ms(lambda: ring_attention_bwd_dq(
                    q, k, v, do, lse, delta, scale, n), 10),
                "ring_attention_bwd_dkv": median_ms(
                    lambda: ring_attention_bwd_dkv(q, k, v, do, meta, scale, n),
                    10)}
            flops = {"dq": 6.0, "dkv": 8.0}  # the products each ring runs
            for kname, e, which in (("ring_attention_bwd_dq", errs[:1], "dq"),
                                    ("ring_attention_bwd_dkv", errs[1:], "dkv")):
                r = dict(_merge(e), kernel=kname, dtype=name,
                         case=f"head_dim 80 n={n} {n}x1x{s_loc}x16x80 "
                              f"({tokens} tokens)",
                         ms=times[kname],
                         tflops=flops[which] * float(tokens) ** 2 * 16 * HUGE_D
                         / (times[kname] * 1e-3) / 1e12, **extra,
                         **_ring_bwd_bound(n, s_loc, dtype, which, HUGE_D))
                results.append(r)
                log(json.dumps(r))
            del q, k, v, do, o, lse, delta, meta
            torch.cuda.empty_cache()


def phase_seq_train(gpu: str, cpu_model, cpu_ref: tuple) -> dict:
    """``cpu_model``: phase 3's flagship (fp32, CPU); ``cpu_ref``: phase 6's
    fp32 loss and gradients of its 2-view 224x224 step on the CPU."""
    log(f"== phase 18: the sequence-sharded training step (flagship, random "
        f"weights seed 0, bf16 params and moments, 20 views at 512x384 over "
        f"{SEQ_RANKS} ranks, remat, the ring kernels forward and backward)")
    t0 = time.perf_counter()
    cfg = cpu_model.cfg
    net = cpu_model.to(device="cuda", dtype=torch.bfloat16).params
    torch.cuda.synchronize()
    log(f"model moved in {time.perf_counter() - t0:.1f} s")
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, 20, 384, 512, seed=0).items()
             if k in BATCH_KEYS}
    steps = 3
    counts = train_road("seq_train", net, cfg, batch, steps, gpu,
                        step=make_seq_sharded_train_step(cfg, TRAIN_OPT,
                                                         SEQ_RANKS))
    log(json.dumps({"path": "seq_train", "ranks": SEQ_RANKS, "steps": steps,
                    "launches_per_step": {k: c / steps for k, c in
                                          counts.items()}}))
    d = cfg.decoder.depth
    _expect("seq_train", counts, ring_attention=steps * 2 * d,
            ring_attention_bwd_dq=steps * d, ring_attention_bwd_dkv=steps * d,
            attention=0, attention_bwd=0)
    del net, batch
    torch.cuda.empty_cache()
    _seq_step_end_to_end(cpu_model, cpu_ref, "seq_train")
    return {"seq_train": counts}


def _seq_step_end_to_end(cpu_model, cpu_ref: tuple, what: str) -> None:
    """One 2-view 224x224 step over 2 ranks, bf16 on the card, against fp32
    on the CPU (``cpu_ref``: phase 6's step, the same weights, batch and
    image ids on one device) and the single-device card step on the same
    decoder road (plain blocks, K1 / K9): the loss and each group's
    gradient within E2E_TRAIN_REL."""
    cfg = cpu_model.cfg
    batch = {k: torch.as_tensor(v) for k, v in
             make_dummy_batch(1, 2, 224, 224, seed=1).items()
             if k in BATCH_KEYS}
    ids = sample_random_image_ids(torch.Generator().manual_seed(0), 1, 2)
    ref_loss, ref = cpu_ref
    gpu_model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    loss, grads = _loss_and_grads(gpu_model.params, seq_sharded_config(cfg, 2),
                                  batch, ids)
    plain_dec = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, fused_blocks=False))
    one_loss, one = _loss_and_grads(gpu_model.params, plain_dec, batch, ids)
    errs, bad = {}, {}
    for which, (l_ref, g_ref) in (("vs_cpu_fp32", (ref_loss, ref)),
                                  ("vs_single_device_card", (one_loss, one))):
        errs[which] = {"loss": abs(loss - l_ref) / abs(l_ref),
                       **{f"grad/{k}": ((grads[k] - g_ref[k]).norm()
                                        / g_ref[k].norm()).item()
                          for k in g_ref}}
        bad.update({f"{which} {k}": e for k, e in errs[which].items()
                    if not e <= E2E_TRAIN_REL})
    log(json.dumps({"path": what, "seq_train_2x224_rel_err": errs,
                    "tolerance": E2E_TRAIN_REL, "loss_cpu_fp32": ref_loss,
                    "loss_card_seq": loss, "loss_card_single": one_loss}))
    del gpu_model
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"{what}: seq-sharded training error above "
                             f"{E2E_TRAIN_REL}: {bad}")


# phase 19: the training CLI on a CO3D-format root written here with PIL
CO3D_FRAMES = 100   # frames a sequence (CO3D's combinations index 100)
CO3D_F = 500.0      # focal length, pixels
CO3D_RADIUS = 3.0   # camera distance from the object's centre
CO3D_MAX_DEPTH = 10.0
CLI_TRAIN_SAMPLES = 6   # the epoch: 6 samples of 20 views, batch 1
CLI_VAL_SAMPLES = 2     # validation: 2 samples of 10 views


def _sphere_frame(w: int, h: int, seed: int, f: float = CO3D_F):
    """The unit sphere at the origin seen from CO3D_RADIUS away by a pinhole
    of focal ``f`` with its principal point in the middle: an 8-bit RGB
    image (shading and seeded texture), depth in metres (background at
    CO3D_MAX_DEPTH) and the silhouette as a 0 / 255 mask."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w) - w / 2, np.arange(h) - h / 2)
    d = np.stack([u / f, v / f, np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # |c + t d| = 1 with the centre at depth CO3D_RADIUS on the optical axis
    b = d[..., 2] * CO3D_RADIUS
    disc = b * b - (CO3D_RADIUS ** 2 - 1.0)
    hit = disc > 0
    t = np.where(hit, b - np.sqrt(np.maximum(disc, 0.0)), 0.0)
    depth = np.where(hit, t * d[..., 2], CO3D_MAX_DEPTH).astype(np.float32)
    shade = np.where(hit, 0.35 + 0.65 * (CO3D_RADIUS - depth) , 0.15)
    tex = _photo(h, w, seed).astype(np.float32) / 255.0
    img = np.clip(255 * (0.6 * shade[..., None] + 0.4 * tex)
                  + rng.normal(0, 3, (h, w, 3)), 0, 255).astype(np.uint8)
    return img, depth, np.where(hit, 255, 0).astype(np.uint8)


def _orbit_pose(theta: float) -> np.ndarray:
    """cam2world of a camera CO3D_RADIUS from the origin at azimuth theta,
    looking at the origin (OpenCV axes: x right, y down, z forward)."""
    eye = CO3D_RADIUS * np.array([np.sin(theta), 0.0, -np.cos(theta)])
    z = -eye / np.linalg.norm(eye)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    T[:3, 3] = eye
    return T


def make_co3d_root(root: str) -> str:
    """A CO3D-format root (``Co3d_Multiview``'s layout, as
    ``tests/test_real_datasets.py`` builds it) written with PIL and numpy:
    category "teddybear" with two sequences of CO3D_FRAMES frames orbiting
    the object, "landscape" of 640x480 frames and "mixed" alternating 640x480
    and 480x640 frames; JPEG images, 16-bit PNG depth (scaled by
    maximum_depth / 65535), PNG masks and per-frame .npz cameras; listed in
    selected_seqs_{train,test}.json."""
    from concurrent.futures import ThreadPoolExecutor

    frames = list(range(1, CO3D_FRAMES + 1))
    shapes = {"landscape": lambda i: (640, 480),
              "mixed": lambda i: (640, 480) if i % 2 else (480, 640)}
    scenes = {wh: _sphere_frame(*wh, seed=wh[0])
              for wh in ((640, 480), (480, 640))}

    def write(seq: str, i: int) -> None:
        base = os.path.join(root, "teddybear", seq)
        w, h = shapes[seq](i)
        img, depth, mask = scenes[w, h]
        name = f"frame{i:06d}"
        rng = np.random.default_rng(i)
        jitter = rng.integers(-6, 7, img.shape)
        PIL.Image.fromarray(np.clip(img + jitter, 0, 255).astype(
            np.uint8)).save(os.path.join(base, "images", name + ".jpg"),
                            quality=90)
        K = np.array([[CO3D_F, 0, w / 2], [0, CO3D_F, h / 2], [0, 0, 1]],
                     np.float32)
        np.savez(os.path.join(base, "images", name + ".npz"),
                 camera_pose=_orbit_pose(2 * np.pi * i / CO3D_FRAMES),
                 camera_intrinsics=K,
                 maximum_depth=np.float32(CO3D_MAX_DEPTH))
        PIL.Image.fromarray(np.round(
            depth / CO3D_MAX_DEPTH * 65535).astype(np.uint16)).save(
            os.path.join(base, "depths", name + ".jpg.geometric.png"),
            compress_level=1)
        PIL.Image.fromarray(mask).save(
            os.path.join(base, "masks", name + ".png"), compress_level=1)

    for seq in shapes:
        for sub in ("images", "depths", "masks"):
            os.makedirs(os.path.join(root, "teddybear", seq, sub),
                        exist_ok=True)
    # PIL's encoders release the GIL: one thread a core
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda job: write(*job),
                      [(seq, i) for seq in shapes for i in frames]))
    for split in ("train", "test"):
        with open(os.path.join(root, f"selected_seqs_{split}.json"),
                  "w") as f:
            json.dump({"teddybear": {s: frames for s in shapes}}, f)
    return root


def _cli_overrides(root: str, run_dir: str) -> list:
    """super_long_training's own Co3d train and test entries with ROOT and
    the sample counts changed, one epoch, a CSV row per step."""
    from fast3r_torch.config import CONFIG_DIR, load_config

    exp = load_config(os.path.join(CONFIG_DIR, "train.yaml"),
                      "super_long_training")["data"]
    (train,) = [d for d in exp["train_datasets"] if "Co3d_Multiview" in d]
    (val,) = [d for d in exp["validation_datasets"] if "Co3d_Multiview" in d]

    def retarget(spec: str, n: int) -> str:
        count, _, call = spec.partition(" @ ")
        old_root = call.split("ROOT='", 1)[1].split("'", 1)[0]
        return f"{n} @ " + call.replace(f"ROOT='{old_root}'", f"ROOT='{root}'")

    return [f"paths.run_dir={run_dir}",
            f"data.train_datasets={[retarget(train, CLI_TRAIN_SAMPLES)]!r}",
            f"data.validation_datasets={[retarget(val, CLI_VAL_SAMPLES)]!r}",
            "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
            "data.num_workers=3", "data.num_workers_val=0"]


def _csv_rows(path: str) -> list:
    import csv

    if not os.path.exists(path):
        return []
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def phase_cli_train(gpu: str, train_counts: dict, train_steps: int) -> dict:
    """Run 1: ``python -m fast3r_torch.cli.train --experiment
    super_long_training`` in a subprocess, sent SIGUSR1 once metrics.csv has
    its first row; it must save "last" and exit 0.  Run 2:
    ``fast3r_torch.cli.train.main`` in this process with ``--resume``, its
    ``train_step`` wrapped to record each step; it must continue the step
    count, finish the epoch and validate with the pose suite."""
    import signal

    from fast3r_torch.cli import train as cli_train
    from fast3r_torch.train import trainer as trainer_mod
    from fast3r_torch.utils.tb_writer import decode_scalar_event, iter_records

    log("== phase 19: the training CLI (--experiment super_long_training, "
        "flagship at full width, 20 views, 5 resolutions, ColorJitter) on a "
        "CO3D-format root: SIGUSR1 checkpoint, then --resume to the epoch's "
        "end and validation with the pose suite")
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="fast3r_cli_")
    try:
        t = time.perf_counter()
        root = make_co3d_root(os.path.join(tmp, "co3d"))
        log(json.dumps({"path": "cli_train", "co3d_root_s":
                        time.perf_counter() - t, "frames": 2 * CO3D_FRAMES}))
        run_dir = os.path.join(tmp, "run")
        args = ["--experiment", "super_long_training",
                *_cli_overrides(root, run_dir)]
        csv_path = os.path.join(run_dir, "metrics.csv")

        # run 1: a subprocess, stopped by SIGUSR1 after its first CSV row
        torch.cuda.empty_cache()
        t = time.perf_counter()
        # its output goes to a file: the loader's workers and their resource
        # tracker inherit the process's descriptors, and a pipe would stay
        # open as long as the last of them
        run1_log = os.path.join(tmp, "run1.log")
        with open(run1_log, "w") as out_f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "fast3r_torch.cli.train",
                 "--no-resume", *args], cwd=repo, stdout=out_f,
                stderr=subprocess.STDOUT)
        try:
            signalled = None
            while proc.poll() is None and signalled is None:
                if _csv_rows(csv_path):
                    proc.send_signal(signal.SIGUSR1)
                    signalled = time.perf_counter() - t
                time.sleep(0.1)
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        run1_s = time.perf_counter() - t
        with open(run1_log) as f:
            out = f.read()
        for line in out.splitlines():
            if "fast3r_torch" in line and " INFO " in line:
                log("   run 1: " + line.split(" INFO ", 1)[1])
        ckpt = os.path.join(run_dir, "checkpoints", "last.pt")
        rows1 = _csv_rows(csv_path)
        if (proc.returncode != 0 or signalled is None or not rows1
                or not os.path.exists(ckpt)
                or "stopping for requeue" not in out):
            raise AssertionError(f"run 1: exit {proc.returncode}, signalled "
                                 f"{signalled}, {ckpt} "
                                 f"{os.path.exists(ckpt)}; output tail:\n"
                                 + "\n".join(out.splitlines()[-30:]))
        run1_step = int(rows1[-1]["step"])
        log(json.dumps({"path": "cli_train", "run": 1, "exit": 0,
                        "signalled_at_s": signalled, "total_s": run1_s,
                        "steps": run1_step,
                        "checkpoint_gb": os.path.getsize(ckpt) / 1e9}))

        # run 2: in this process, train_step wrapped
        steps, ckpt_s, resumed = [], {"save": [], "load": []}, {}
        last_end = [time.perf_counter()]
        orig_step = trainer_mod.train_step
        orig_save = trainer_mod.Trainer.save_checkpoint
        orig_load = trainer_mod.Trainer.load_checkpoint

        def step_fn(state, batch, *a, **kw):
            t0 = time.perf_counter()
            state, m = orig_step(state, batch, *a, **kw)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec = {"path": "cli_train", "run": 2, "train_step": state.step,
                   "views": int(np.shape(batch["imgs"])[1]),
                   "image_hw": list(np.shape(batch["imgs"])[2:4]),
                   "mixed": kw["mixed_orientation"], "step_s": t1 - t0,
                   "loader_wait_s": t0 - last_end[0], "loss": loss,
                   "skipped_nonfinite": int(m["skipped_nonfinite"]),
                   "gpu": gpu}
            steps.append(rec)
            log(json.dumps(rec))
            last_end[0] = time.perf_counter()
            return state, m

        def save(self, name="last"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = orig_save(self, name)
            ckpt_s["save"].append(time.perf_counter() - t0)
            return path

        def load(self, name="last"):
            t0 = time.perf_counter()
            ok = orig_load(self, name)
            torch.cuda.synchronize()
            ckpt_s["load"].append(time.perf_counter() - t0)
            resumed["step"] = self.state.step
            resumed["params"] = sum(p.numel()
                                    for p in self.state.params.parameters())
            last_end[0] = time.perf_counter()
            return ok

        trainer_mod.train_step = step_fn
        trainer_mod.Trainer.save_checkpoint = save
        trainer_mod.Trainer.load_checkpoint = load
        torch.cuda.reset_peak_memory_stats()
        # the loader's spawn workers import the main module: as main, the
        # CLI module, so that they import what run 1's do (the data
        # pipeline, no torch), not this script
        main_module = sys.modules["__main__"]
        sys.modules["__main__"] = cli_train
        _reset_counts()
        t = time.perf_counter()
        try:
            trainer = cli_train.main(["--resume", *args])
        finally:
            sys.modules["__main__"] = main_module
            trainer_mod.train_step = orig_step
            trainer_mod.Trainer.save_checkpoint = orig_save
            trainer_mod.Trainer.load_checkpoint = orig_load
        counts = _read_counts()
        run2_s = time.perf_counter() - t
        st = trainer.state
        dtypes = {"master": str(next(st.params.parameters()).dtype),
                  "moments": str(next(iter(st.opt_state.mu.values())).dtype),
                  "working_copy": str(None if st.work is None else
                                      next(st.work.parameters()).dtype)}
        log(json.dumps({"path": "cli_train", "run": 2, "total_s": run2_s,
                        "steps": len(steps), "final_step": trainer.state.step,
                        "checkpoint_save_s": ckpt_s["save"],
                        "checkpoint_load_s": ckpt_s["load"],
                        "checkpoint_gb": os.path.getsize(ckpt) / 1e9,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "parameters": resumed.get("params"),
                        "dtypes": dtypes, "gpu": gpu}))

        # the checks
        bad = []
        if dtypes != {"master": "torch.float32", "moments": "torch.float32",
                      "working_copy": "torch.bfloat16"}:
            bad.append(f"not the master-weights road: {dtypes}")
        if resumed.get("step") != run1_step:
            bad.append(f"run 2 resumed at step {resumed.get('step')}, run 1 "
                       f"stopped at {run1_step}")
        if resumed.get("params") != FLAGSHIP_PARAMS:
            bad.append(f"{resumed.get('params')} parameters, not the "
                       f"flagship's {FLAGSHIP_PARAMS}")
        if len(steps) != CLI_TRAIN_SAMPLES or trainer.state.step != (
                run1_step + CLI_TRAIN_SAMPLES):
            bad.append(f"run 2 took {len(steps)} steps to step "
                       f"{trainer.state.step}")
        if any(r["views"] != 20 for r in steps):
            bad.append("a step of other than 20 views")
        if len({tuple(r["image_hw"]) for r in steps}) < 2:
            bad.append("run 2 trained at one resolution only")
        if not any(r["mixed"] for r in steps):
            bad.append("no mixed-orientation batch")
        rows = _csv_rows(csv_path)
        losses = [float(r["loss"]) for r in rows if r.get("loss")]
        if len(losses) < len(steps) + run1_step or not all(
                math.isfinite(x) for x in losses) or any(
                r["skipped_nonfinite"] for r in steps):
            bad.append(f"logged losses {losses}")
        val = [r for r in rows if r.get("val/dataset_0/loss")]
        want = ["val/dataset_0/loss"] + [
            f"val/dataset_0/pose/{k}" for k in (
                "RRA_at_5", "RTA_at_5", "RRA_at_15", "RTA_at_15",
                "RRA_at_30", "RTA_at_30", "mAA_30")]
        if len(val) != 1 or not all(val[0].get(k) for k in want):
            bad.append(f"validation rows {val}")
        tb_dir = os.path.join(run_dir, "tensorboard")
        tags = set()
        for name in (os.listdir(tb_dir) if os.path.isdir(tb_dir) else []):
            with open(os.path.join(tb_dir, name), "rb") as f:
                for rec in list(iter_records(f.read()))[1:]:
                    tags |= set(decode_scalar_event(rec)[1])
        if not {"loss", "val/dataset_0/pose/RRA_at_15"} <= tags:
            bad.append(f"TensorBoard tags {sorted(tags)}")
        n = len(steps)
        for k in TRAIN_KERNELS:
            per_step = train_counts[k] / train_steps
            if counts[k] != n * per_step:
                bad.append(f"{k}: {counts[k]} launches over {n} steps, "
                           f"phase 5 took {per_step} a step")
        if counts["trunk"] + counts["resize"] == 0:
            bad.append("the heads launched neither K8 nor K12")
        by_hw = {}
        for r in steps:
            by_hw.setdefault("x".join(map(str, r["image_hw"])), []).append(
                r["step_s"])
        log(json.dumps({"path": "cli_train", "step_s_by_hw": by_hw,
                        "loader_wait_s": [r["loader_wait_s"] for r in steps],
                        "launches": {k: counts[k] for k in TRAIN_KERNELS},
                        "per_step_phase5": {
                            k: train_counts[k] / train_steps
                            for k in TRAIN_KERNELS}, "gpu": gpu}))
        if bad:
            raise AssertionError(f"phase 19: {bad}")
        del trainer
        torch.cuda.empty_cache()
        return {"cli_train": counts}
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 20: evaluation from the command line
# ---------------------------------------------------------------------------

EVAL_PRESET = "ablation_recon_better_inference_hp"
EVAL_VIEWS = 10         # num_views_val of every preset
EVAL_CO3D_SAMPLES = 2   # the preset's CO3D count, cut from 100
# the preset's recon sets under data.data_root: folder, kf_every, frame size
# (w, h), focal length (pixels); each gets EVAL_VIEWS * kf_every frames
RECON_ROOTS = {"dtu": ("dtu_test_mvsnet_release", 5, (1600, 1200), 1250.0),
               "7scenes": ("7_scenes_processed", 20, (640, 480), 525.0),
               "nrgbd": ("neural_rgbd", 40, (640, 480), 554.2562584220408)}
RECON_KEYS = ("accuracy", "accuracy_median", "completion",
              "completion_median", "nc1", "nc1_median", "nc2", "nc2_median")
POSE_KEYS = ("RRA_at_5", "RTA_at_5", "RRA_at_15", "RTA_at_15", "RRA_at_30",
             "RTA_at_30", "mAA_30")
RE10K_SCENES, RE10K_FRAMES = 2, 10       # 640x360 JPEGs -> 512x288 views
RMVD_SCENES, RMVD_VIEWS = 2, 5           # 512x384 PNGs with .npy depth


RELIEF_AMP, RELIEF_FREQ, RELIEF_HALF = 0.1, 3.0, 1.2  # the recon scene


def _relief_pose(i: int, n: int) -> np.ndarray:
    """cam2world of frame i of n: a quarter orbit at 45 degrees of elevation,
    3 sqrt(2) from the origin, looking at it (OpenCV axes, y down)."""
    theta = 0.5 * np.pi * i / n
    eye = 3.0 * np.array([np.sin(theta), -1.0, -np.cos(theta)])
    z = -eye / np.linalg.norm(eye)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    T[:3, 3] = eye
    return T


def _relief_frame(w: int, h: int, f: float, c2w: np.ndarray, seed: int,
                  device="cuda"):
    """A textured relief, y = RELIEF_AMP sin(RELIEF_FREQ x) cos(RELIEF_FREQ
    z) over |x|, |z| < RELIEF_HALF, seen through a pinhole of focal ``f``
    (principal point in the middle) from ``c2w``: the 8-bit RGB image
    (Lambert shading and a seeded texture), the z-depth (0 off the relief,
    which the recon sets read as invalid) and the 0 / 255 mask.  The rays
    are intersected on ``device`` (Newton steps from the plane y = 0)."""
    dev = torch.device(device)
    R = torch.tensor(c2w[:3, :3], device=dev)
    o = torch.tensor(c2w[:3, 3], device=dev)
    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                          torch.arange(w, device=dev, dtype=torch.float64),
                          indexing="ij")
    dc = torch.stack([(u - w / 2) / f, (v - h / 2) / f, torch.ones_like(u)],
                     -1)
    d = dc @ R.T
    a, k = RELIEF_AMP, RELIEF_FREQ
    t = -o[1] / d[..., 1]
    for _ in range(8):
        p = o + t[..., None] * d
        sx, cx = torch.sin(k * p[..., 0]), torch.cos(k * p[..., 0])
        sz, cz = torch.sin(k * p[..., 2]), torch.cos(k * p[..., 2])
        g = p[..., 1] - a * sx * cz
        dg = d[..., 1] - a * k * (cx * cz * d[..., 0] - sx * sz * d[..., 2])
        t = t - g / dg
    p = o + t[..., None] * d
    sx, cx = torch.sin(k * p[..., 0]), torch.cos(k * p[..., 0])
    sz, cz = torch.sin(k * p[..., 2]), torch.cos(k * p[..., 2])
    hit = ((d[..., 1] > 0.05) & (t > 0) & (p[..., 0].abs() < RELIEF_HALF)
           & (p[..., 2].abs() < RELIEF_HALF)
           & ((p[..., 1] - a * sx * cz).abs() < 1e-5))
    n = torch.stack([-a * k * cx * cz, torch.ones_like(t),
                     a * k * sx * sz], -1)
    shade = (n @ torch.tensor([0.3, 0.8, -0.5], device=dev, dtype=n.dtype)
             ).abs() / n.norm(dim=-1)
    hit, t, shade = (x.cpu().numpy() for x in (hit, t, shade))
    tex = _photo(h, w, seed).astype(np.float32) / 255.0
    img = np.where(hit[..., None], 255 * (0.45 * shade[..., None] + 0.55 * tex),
                   40.0)
    return (np.clip(img, 0, 255).astype(np.uint8),
            np.where(hit, t, 0.0).astype(np.float32),
            np.where(hit, 255, 0).astype(np.uint8))


def make_recon_roots(data_root: str, device="cuda") -> dict:
    """The preset's DTU, 7-Scenes and NRGBD roots under ``data_root``, each
    in its dataset's layout and frame size, written with PIL and numpy:
    one scene of EVAL_VIEWS * kf_every frames of the relief on a quarter
    orbit, of which the frames that ``full_video`` with the preset's
    kf_every reads are written and the others are links to them (the
    loaders list them and read only every kf_every-th).

      * DTU: scan1/{images/%08d.jpg, depths/%08d.npy, binary_masks/%08d.png,
        cams/%08d_cam.txt (MVSNet: w2c and K)};
      * 7-Scenes: chess/TestSplit.txt and chess/seq-01/frame-%06d.
        {color.png, depth.proj.png (16-bit mm), pose.txt (c2w)};
      * NRGBD: kitchen/{images/img%d.png, depth/depth%d.png (16-bit mm),
        poses.txt (4x4 c2w blocks, OpenGL axes)}.
    Returns each set's frame count."""
    out = {}
    for name, (folder, kf, (w, h), f) in RECON_ROOTS.items():
        n = EVAL_VIEWS * kf
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
        root = os.path.join(data_root, folder)
        if name == "dtu":
            base = os.path.join(root, "scan1")
            paths = {sub: os.path.join(base, sub) for sub in
                     ("images", "depths", "binary_masks", "cams")}
            for p in paths.values():
                os.makedirs(p, exist_ok=True)
            for i in range(0, n, kf):
                img, depth, mask = _relief_frame(w, h, f, _relief_pose(i, n), i,
                                               device)
                stem = f"{i:08d}"
                PIL.Image.fromarray(img).save(
                    os.path.join(paths["images"], stem + ".jpg"), quality=90)
                np.save(os.path.join(paths["depths"], stem + ".npy"), depth)
                PIL.Image.fromarray(mask).save(
                    os.path.join(paths["binary_masks"], stem + ".png"))
                w2c = np.linalg.inv(_relief_pose(i, n))
                with open(os.path.join(paths["cams"], stem + "_cam.txt"),
                          "w") as fh:
                    fh.write("extrinsic\n" + "\n".join(
                        " ".join(f"{x:.9f}" for x in r) for r in w2c)
                        + "\n\nintrinsic\n" + "\n".join(
                        " ".join(f"{x:.6f}" for x in r) for r in K)
                        + "\n\n425.0 2.5\n")
            links = [(os.path.join(paths["images"], f"{(i // kf) * kf:08d}.jpg"),
                      os.path.join(paths["images"], f"{i:08d}.jpg"))
                     for i in range(n) if i % kf]
        elif name == "7scenes":
            base = os.path.join(root, "chess", "seq-01")
            os.makedirs(base, exist_ok=True)
            with open(os.path.join(root, "chess", "TestSplit.txt"), "w") as fh:
                fh.write("sequence1\n")
            for i in range(0, n, kf):
                img, depth, _ = _relief_frame(w, h, f, _relief_pose(i, n), i,
                                               device)
                stem = os.path.join(base, f"frame-{i:06d}")
                PIL.Image.fromarray(img).save(stem + ".color.png",
                                              compress_level=1)
                PIL.Image.fromarray(np.round(depth * 1000).astype(np.uint16)
                                    ).save(stem + ".depth.proj.png",
                                           compress_level=1)
                np.savetxt(stem + ".pose.txt", _relief_pose(i, n))
            links = [(os.path.join(base, f"frame-{(i // kf) * kf:06d}.color.png"),
                      os.path.join(base, f"frame-{i:06d}.color.png"))
                     for i in range(n) if i % kf]
        else:
            base = os.path.join(root, "kitchen")
            for sub in ("images", "depth"):
                os.makedirs(os.path.join(base, sub), exist_ok=True)
            for i in range(0, n, kf):
                img, depth, _ = _relief_frame(w, h, f, _relief_pose(i, n), i,
                                               device)
                PIL.Image.fromarray(img).save(
                    os.path.join(base, "images", f"img{i}.png"),
                    compress_level=1)
                PIL.Image.fromarray(np.round(depth * 1000).astype(np.uint16)
                                    ).save(os.path.join(base, "depth",
                                                        f"depth{i}.png"),
                                           compress_level=1)
            with open(os.path.join(base, "poses.txt"), "w") as fh:
                for i in range(n):
                    gl = _relief_pose(i, n).copy()
                    gl[:, 1:3] *= -1.0   # OpenCV -> OpenGL: the loader flips
                    fh.write("\n".join(" ".join(f"{x:.9f}" for x in r)
                                       for r in gl) + "\n")
            links = [(os.path.join(base, "images", f"img{(i // kf) * kf}.png"),
                      os.path.join(base, "images", f"img{i}.png"))
                     for i in range(n) if i % kf]
        for src, dst in links:
            os.symlink(src, dst)
        out[name] = n
    return out


def write_eval_run_dir(run_dir: str) -> None:
    """A run directory of the port with the flagship's random weights (seed
    0, bfloat16): model_config.json, checkpoints/last.pt and the
    super_long_training config.yaml, as ``cli/train.py`` leaves one."""
    from fast3r_torch.config import CONFIG_DIR, load_config, save_config
    from fast3r_torch.utils.checkpoint_utils import RUN_CONFIG, config_to_dict

    model = Fast3R.from_random(Fast3RConfig.flagship(), seed=0,
                               dtype=torch.bfloat16, device="cuda")
    save_config(load_config(os.path.join(CONFIG_DIR, "train.yaml"),
                            "super_long_training"), run_dir)
    with open(os.path.join(run_dir, RUN_CONFIG), "w") as f:
        json.dump(config_to_dict(model.cfg), f)
    os.makedirs(os.path.join(run_dir, "checkpoints"), exist_ok=True)
    torch.save({"params": model.params.state_dict()},
               os.path.join(run_dir, "checkpoints", "last.pt"))
    del model
    torch.cuda.empty_cache()


class _StageClock:
    """Wraps module functions to sum their seconds by stage name (a
    synchronise at each call's end); a call inside ``inside`` (e.g. the fit
    inside the alignment) counts only there."""

    def __init__(self):
        self.seconds, self._active = {}, []

    def wrap(self, module, attr: str, stage: str, inside=()):
        orig = getattr(module, attr)

        def timed(*a, **kw):
            if any(s in self._active for s in inside):
                return orig(*a, **kw)
            self._active.append(stage)
            t0 = time.perf_counter()
            try:
                out = orig(*a, **kw)
                torch.cuda.synchronize()
            finally:
                self._active.pop()
            self.seconds[stage] = (self.seconds.get(stage, 0.0)
                                   + time.perf_counter() - t0)
            return out

        setattr(module, attr, timed)
        return orig

    def take(self) -> dict:
        out = dict(self.seconds)
        self.seconds.clear()
        return out


def _finite(d: dict) -> bool:
    return all(math.isfinite(v) for v in d.values())


def phase_eval(gpu: str) -> dict:
    """Run 1: ``fast3r_torch.cli.eval.main`` with ``--eval-config
    ablation_recon_better_inference_hp`` on a run directory of the
    flagship, its four validation sets on synthetic roots (only ROOT and
    the CO3D sample count changed); run 2: ``evaluate_reconstruction`` on a
    10-view 512x384 DTU sample whose predictions are the ground truth moved
    by known similarities, on the card and on the CPU; runs 3 and 4: the
    RE10K and RobustMVD drivers."""
    import shutil
    import yaml

    from fast3r_torch.cli import eval as cli_eval
    from fast3r_torch.cli import re10k_pose_eval, robustmvd_eval
    from fast3r_torch.config import CONFIG_DIR
    from fast3r_torch.data.dsl import build_dataset
    from fast3r_torch.data.imgproc import rodrigues
    from fast3r_torch.eval import pose as pose_mod
    from fast3r_torch.eval import recon as recon_mod
    from fast3r_torch.models import dpt_head as dpt_mod
    from fast3r_torch.train import trainer as trainer_mod

    log("== phase 20: evaluation from the command line (--eval-config "
        f"{EVAL_PRESET}: CO3D pose, DTU / 7-Scenes / NRGBD recon, "
        f"{EVAL_VIEWS} views a sample, the flagship at full width), the "
        "recon metrics at 10 x 512x384, the RE10K and RobustMVD drivers")
    tmp = tempfile.mkdtemp(prefix="fast3r_eval_")
    clock = _StageClock()
    roads = []
    orig_road = dpt_mod.head_road

    def road(*a, **kw):
        r = orig_road(*a, **kw)
        roads.append(r)
        return r

    wrapped = [(recon_mod, "evaluate_reconstruction", "recon_suite", ()),
               (recon_mod, "align_local_pts3d_to_global", "alignment", ()),
               (recon_mod, "rigid_points_registration", "similarity_fit",
                ("alignment",)),
               (recon_mod, "estimate_normals", "normals", ()),
               (recon_mod, "accuracy", "nn_queries", ()),
               (recon_mod, "completion", "nn_queries", ()),
               (pose_mod, "estimate_camera_poses", "pose_suite", ())]
    origs = []
    try:
        t = time.perf_counter()
        run_dir = os.path.join(tmp, "run")
        write_eval_run_dir(run_dir)
        ckpt_s = time.perf_counter() - t
        t = time.perf_counter()
        data_root = os.path.join(tmp, "data")
        frames = make_recon_roots(data_root)
        make_co3d_root(os.path.join(data_root, "co3d_processed"))
        log(json.dumps({"path": "eval_cli", "checkpoint_write_s": ckpt_s,
                        "roots_s": time.perf_counter() - t,
                        "recon_frames": frames, "gpu": gpu}))

        # run 1: the eval CLI, each forward's launches and seconds recorded
        with open(os.path.join(CONFIG_DIR, "eval",
                               EVAL_PRESET + ".yaml")) as f:
            preset = yaml.safe_load(f)["data"]["validation_datasets"]
        specs = [s.replace("100 @ ", f"{EVAL_CO3D_SAMPLES} @ ", 1)
                 for s in preset]
        names = ["co3d"] * EVAL_CO3D_SAMPLES + list(RECON_ROOTS)
        fwds = []
        orig_fwd = trainer_mod.fast3r_forward

        suites = {}

        def flush_suites():
            """The suites' seconds since the last forward, to its set."""
            if fwds:
                for k, v in clock.take().items():
                    stages = suites.setdefault(fwds[-1]["dataset"], {})
                    stages[k] = stages.get(k, 0.0) + v

        def fwd(net, cfg, imgs, *a, **kw):
            flush_suites()
            before = _read_counts()
            del roads[:]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = orig_fwd(net, cfg, imgs, *a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = _read_counts()
            i = len(fwds)
            fwds.append({
                "path": "eval_cli", "dataset": names[i] if i < len(names)
                else "?", "views": int(imgs.shape[1]),
                "image_hw": list(imgs.shape[2:4]), "forward_s": dt,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "head_roads": sorted(set(roads)),
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}})
            return out

        trainer_mod.fast3r_forward = fwd
        for mod, attr, stage, inside in wrapped:
            origs.append((mod, attr, clock.wrap(mod, attr, stage, inside)))
        dpt_mod.head_road = road
        # the loader's spawn worker (num_workers_val: 1) imports the main
        # module: as main, the CLI module (as phase 19 does)
        main_module = sys.modules["__main__"]
        sys.modules["__main__"] = cli_eval
        _reset_counts()
        t = time.perf_counter()
        try:
            results = cli_eval.main([
                "--run-dir", run_dir, "--eval-config", EVAL_PRESET,
                f"data.data_root={data_root}",
                f"data.validation_datasets={specs!r}"])
        finally:
            sys.modules["__main__"] = main_module
            trainer_mod.fast3r_forward = orig_fwd
        counts = {"eval_cli": _read_counts()}
        run1_s = time.perf_counter() - t
        flush_suites()
        for rec in fwds:
            log(json.dumps({**rec, "gpu": gpu}))
        for name in ["co3d", *RECON_ROOTS]:
            log(json.dumps({"path": "eval_cli", "dataset": name,
                            "suite_s": suites.get(name), "gpu": gpu}))
        log(json.dumps({"path": "eval_cli", "total_s": run1_s,
                        "results": results, "gpu": gpu}))
        bad = []
        idx = {"co3d": 0, "dtu": 1, "7scenes": 2, "nrgbd": 3}
        for name, i in idx.items():
            got = {k.split("/", 2)[2] for k in results
                   if k.startswith(f"val/dataset_{i}/")}
            want = {"loss"} | ({f"pose/{k}" for k in POSE_KEYS}
                               if name == "co3d" else
                               {f"recon/{k}" for k in RECON_KEYS})
            if got != want:
                bad.append(f"{name}: keys {sorted(got)}")
        if not _finite(results):
            bad.append("a result is not finite")
        if len(fwds) != len(names):
            bad.append(f"{len(fwds)} forwards for {len(names)} samples")
        for rec in fwds:
            n = rec["launches"]
            if rec["views"] != EVAL_VIEWS:
                bad.append(f"{rec['dataset']}: {rec['views']} views")
            for k in ("attention", "packed_qkv_attention"):
                if n.get(k, 0) != 24:
                    bad.append(f"{rec['dataset']}: {k} {n.get(k, 0)} "
                               "launches a forward, not 24")
            want_k = {"trunk": "trunk", "resize_kernel": "resize"}
            used = {want_k[r] for r in rec["head_roads"] if r in want_k}
            for k in ("trunk", "resize"):
                if (n.get(k, 0) > 0) != (k in used):
                    bad.append(f"{rec['dataset']}: {k} {n.get(k, 0)} "
                               f"launches, head roads {rec['head_roads']}")
        for k in TRAIN_KERNELS:
            if counts["eval_cli"][k]:
                bad.append(f"eval_cli: backward kernel {k} launched")
        if bad:
            raise AssertionError(f"phase 20, run 1: {bad}")

        # run 2: the recon metrics at 10 x 512x384 on the card and the CPU
        ds = build_dataset(
            f"DTU(split='test', ROOT='{data_root}/{RECON_ROOTS['dtu'][0]}', "
            f"resolution=(512, 384), num_seq=1, full_video=True, "
            f"kf_every={RECON_ROOTS['dtu'][1]})")
        sample = ds[(0, 0)]
        views = [{"pts3d": torch.from_numpy(v["pts3d"][None]),
                  "valid_mask": torch.from_numpy(v["valid_mask"][None])}
                 for v in sample]
        gt = np.concatenate([v["pts3d"][v["valid_mask"]] for v in sample])
        extent = float(np.ptp(gt, axis=0).max())

        def moved(x, seed):
            rng = np.random.default_rng(seed)
            R = torch.from_numpy(rodrigues(rng.normal(size=3)))
            s, tr = 0.5 + rng.random(), torch.from_numpy(rng.normal(size=3))
            return (s * x.double() @ R.T + tr).float()

        def preds_on(device):
            return [{"pts3d_in_other_view": moved(v["pts3d"], 1).to(device),
                     "conf": torch.ones(v["valid_mask"].shape, device=device),
                     "pts3d_local": moved(v["pts3d"], 10 + i).to(device),
                     "conf_local": torch.ones(v["valid_mask"].shape,
                                              device=device)}
                    for i, v in enumerate(views)]

        metrics, stage_s = {}, {}
        for device in ("cuda", "cpu"):
            clock.take()
            t = time.perf_counter()
            (m,) = recon_mod.evaluate_reconstruction(
                views, preds_on(device), device=device)
            stage_s[device] = {**clock.take(),
                               "total": time.perf_counter() - t}
            metrics[device] = m
        log(json.dumps({"path": "recon_metrics", "views": len(views),
                        "image_hw": list(sample[0]["pts3d"].shape[:2]),
                        "points": int(len(gt)), "extent": extent,
                        "metrics": metrics, "stage_s": stage_s, "gpu": gpu}))
        m, c = metrics["cuda"], metrics["cpu"]
        dist = ("accuracy", "accuracy_median", "completion",
                "completion_median")
        if not (all(m[k] < 1e-4 * extent for k in dist)
                and all(m[k] > 0.99 for k in RECON_KEYS if k not in dist)
                and all(abs(m[k] - c[k]) <= 1e-5 * extent for k in dist)
                and all(abs(m[k] - c[k]) <= 1e-5 for k in RECON_KEYS
                        if k not in dist)):
            raise AssertionError(f"phase 20, run 2: card {m}, cpu {c}, "
                                 f"extent {extent}")

        # run 3: the RE10K driver on 2 scenes of known cameras
        vroot, troot = os.path.join(tmp, "re10k", "videos"), os.path.join(
            tmp, "re10k", "txts")
        scenes = [f"{0xabc0 + s:016x}" for s in range(RE10K_SCENES)]
        for s, scene in enumerate(scenes):
            os.makedirs(os.path.join(vroot, scene))
            os.makedirs(troot, exist_ok=True)
            lines = ["https://example.com/watch"]
            for i in range(RE10K_FRAMES):
                fid = str(1000 * i)
                PIL.Image.fromarray(_photo(360, 640, 100 * s + i)).save(
                    os.path.join(vroot, scene, fid + ".jpg"), quality=90)
                w2c = np.linalg.inv(_orbit_pose(0.05 * i + s))
                lines.append(" ".join(
                    [fid, "0.9", "1.6", "0.5", "0.5", "0", "0"]
                    + [f"{x:.9f}" for x in w2c[:3].reshape(-1)]))
            with open(os.path.join(troot, scene + ".txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
        with open(os.path.join(tmp, "re10k", "list.txt"), "w") as f:
            f.write("\n".join(scenes) + "\n")
        del roads[:]
        _reset_counts()
        t = time.perf_counter()
        res = re10k_pose_eval.main([
            "--video-root", vroot, "--txt-root", troot, "--checkpoint",
            run_dir, "--scene-list", os.path.join(tmp, "re10k", "list.txt"),
            "--out", os.path.join(tmp, "re10k", "out.json")])
        counts["re10k"] = _read_counts()
        log(json.dumps({"path": "re10k", "total_s": time.perf_counter() - t,
                        "result": res, "head_roads": sorted(set(roads)),
                        "launches": {k: counts["re10k"][k]
                                     for k in ("trunk", "resize")},
                        "pose_suite_s": clock.take().get("pose_suite"),
                        "gpu": gpu}))
        if (res is None or sorted(res["per_scene"]) != sorted(scenes)
                or not all(set(POSE_KEYS) <= set(m) and _finite(m)
                           for m in res["per_scene"].values())):
            raise AssertionError(f"phase 20, run 3: {res}")
        _check_roads("re10k", roads, counts["re10k"])

        # run 4: the RobustMVD driver on 2 scenes of 5 images
        rroot = os.path.join(tmp, "rmvd")
        for s in range(RMVD_SCENES):
            sdir = os.path.join(rroot, f"scene{s}")
            os.makedirs(os.path.join(sdir, "images"))
            os.makedirs(os.path.join(sdir, "depth"))
            for i in range(RMVD_VIEWS):
                img, depth, _ = _relief_frame(512, 384, 400.0,
                                              _relief_pose(i, 8), s + i)
                PIL.Image.fromarray(img).save(
                    os.path.join(sdir, "images", f"{i:04d}.png"),
                    compress_level=1)
                if i == 0:
                    np.save(os.path.join(sdir, "depth", "0000.npy"), depth)
        del roads[:]
        _reset_counts()
        t = time.perf_counter()
        res = robustmvd_eval.main([
            "--checkpoint", run_dir, "--data-root", rroot, "--views",
            str(RMVD_VIEWS), "--out", os.path.join(rroot, "out.json")])
        counts["robustmvd"] = _read_counts()
        log(json.dumps({"path": "robustmvd",
                        "total_s": time.perf_counter() - t, "result": res,
                        "head_roads": sorted(set(roads)), "gpu": gpu}))
        if (res is None or len(res["per_scene"]) != RMVD_SCENES or not all(
                math.isfinite(m["absrel"]) and math.isfinite(m["inliers_1.03"])
                for m in res["per_scene"].values())):
            raise AssertionError(f"phase 20, run 4: {res}")
        _check_roads("robustmvd", roads, counts["robustmvd"])
        torch.cuda.empty_cache()
        return counts
    finally:
        dpt_mod.head_road = orig_road
        for mod, attr, orig in origs:
            setattr(mod, attr, orig)
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 21: fp32 master weights and the Block's dropout on the card
# ---------------------------------------------------------------------------

# lr 1e-6 from the first step: an update far below bf16's spacing at 1.0
# (2^-7), which only fp32 master weights keep
MASTER_OPT = OptimConfig(lr=1e-6, warmup_steps=0, total_steps=1000,
                         eta_min=1e-6)
# the encoder keeps its attention kernel (no attn_drop), the decoder's
# dropped softmax weights take the materialised-logits road
ENC_DROPOUT = dict(drop=0.1, drop_path=0.1)
DEC_DROPOUT = dict(drop=0.1, attn_drop=0.1, drop_path=0.1)
FUSED_ONLY = ("packed_qkv_attention", "ln_qkv_rope", "ln_qkv",
              "matmul_residual", "ln_mlp", "ln_matmul", "ln_matmul_replay",
              "packed_qkv_attention_bwd")


def _update_ms(state, reps: int = 3) -> dict:
    """Host-clock ms of the optimizer's update alone (AdamW on every
    parameter, then the working copy's refresh), each call synchronised,
    with the compute copy's tensors standing in for the gradients; and its
    bound: each parameter's param and moments read and written, its
    gradient read and its copy written once, at 3.35 TB/s."""
    named = dict(state.params.named_parameters())
    src = dict(state.net.named_parameters())
    grads = {k: src[k].detach() for k in named}
    ms = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _adamw_update(named, grads, state.opt_state, MASTER_OPT,
                      torch.ones((), device="cuda"))
        refresh_working_copy(state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    nbytes = sum(p.numel() * (3 * 2 * p.element_size()
                              + src[k].element_size()
                              * (1 if state.work is None else 2))
                 for k, p in named.items())
    return {"update_ms": ms[1:], "first_update_ms": ms[0],
            "update_bound_ms": nbytes / PEAK_BYTES * 1e3,
            "update_gb": nbytes / 1e9}


# the legacy losses, card against CPU (fp32 both, sums in another order)
LEGACY_RTOL, LEGACY_ATOL = 1e-4, 1e-6
LEGACY_PAIR = ("regr3d_pair", "conf_loss_pair", "regr3d_scale_shift_inv")
LEGACY_MULTIVIEW = ("regr3d_multiview_v1", "regr3d_multiview_v2",
                    "regr3d_multiview_v3", "conf_loss_multiview_v1")


def _legacy_inputs(seed: int, lead: tuple, H: int = 384, W: int = 512):
    """Seeded ground truth (points, masks, random cam2world) and
    predictions (points, conf >= 1, local points) of shape lead + (H, W)."""
    rng = np.random.default_rng(seed)

    def pose():
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = q * np.sign(np.linalg.det(q))
        T[:3, 3] = rng.standard_normal(3)
        return T

    n = int(np.prod(lead))
    gt = {"pts3d": rng.standard_normal(lead + (H, W, 3)).astype(np.float32)
          + 1, "valid_mask": rng.random(lead + (H, W)) < 0.8,
          "camera_pose": np.stack([pose() for _ in range(n)]).reshape(
              lead + (4, 4))}
    pred = {k: rng.standard_normal(lead + (H, W, 3)).astype(np.float32)
            for k in ("pts3d", "pts3d_in_other_view", "pts3d_local")}
    pred["conf"] = (1 + np.exp(rng.standard_normal(lead + (H, W)))).astype(
        np.float32)
    return gt, pred


def _flat(out) -> dict:
    """Every array a loss returns, by name, as float64 numpy."""
    items = {}
    for i, part in enumerate(out if isinstance(out, tuple) else (out,)):
        parts = part.items() if isinstance(part, dict) else [("", part)]
        for k, v in parts:
            items[f"{i}/{k}"] = v.detach().double().cpu().numpy()
    return items


def legacy_losses_on_card(gpu: str) -> None:
    """The seven legacy losses on the card against the CPU at the served
    view shape (a pair of 2 samples; 2 samples of 3 views)."""
    gt1, pred1 = _legacy_inputs(21, (2,))
    gt2, pred2 = _legacy_inputs(22, (2,))
    gts, preds = _legacy_inputs(23, (2, 3))
    errs, secs = {}, {}
    for name in LEGACY_PAIR + LEGACY_MULTIVIEW:
        fn = getattr(train_losses, name)
        args = ((gt1, gt2, pred1, pred2) if name in LEGACY_PAIR
                else (gts, preds))
        outs = []
        for dev in ("cuda", "cpu"):
            targs = [{k: torch.from_numpy(v).to(dev) for k, v in a.items()}
                     for a in args]
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs.append(_flat(fn(*targs)))
            secs[f"{name}/{dev}"] = time.perf_counter() - t
        card, cpu = outs
        errs[name] = max(float(np.max(np.abs(card[k] - cpu[k])
                                      / (LEGACY_ATOL / LEGACY_RTOL
                                         + np.abs(cpu[k]))))
                         for k in cpu)
    log(json.dumps({"path": "legacy_losses", "image_hw": [384, 512],
                    "max_rel_err": errs, "rtol": LEGACY_RTOL,
                    "atol": LEGACY_ATOL, "seconds": secs, "gpu": gpu}))
    bad = {k: e for k, e in errs.items() if not e <= LEGACY_RTOL}
    if bad:
        raise AssertionError(f"legacy losses, card vs CPU: {bad}")


def _ln_scales(net) -> dict:
    return {n: p.detach().clone() for n, p in net.named_parameters()
            if n.rsplit(".", 2)[-2] in ("norm", "norm1", "norm2")
            and n.endswith(".weight")}


def phase_master_weights(gpu: str, cpu_model, cpu_ref: tuple,
                         train_counts: dict, train_steps: int) -> dict:
    """``cpu_model``: phase 3's flagship (fp32, CPU); ``cpu_ref``: phase 6's
    fp32 CPU loss and gradients of the 2-view 224x224 batch."""
    log("== phase 21: fp32 master weights on the card (one 2-view 224x224 "
        "step at lr 1e-6 through the bf16 working copy, against fp32 on the "
        "CPU), the bf16 road at the same step, and a dropout step")
    ref_loss, ref_grads = cpu_ref
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, 2, 224, 224, seed=1).items()
             if k in BATCH_KEYS}
    ids = sample_random_image_ids(torch.Generator().manual_seed(0), 1, 2)
    cfg = cpu_model.cfg
    state = init_train_state(cpu_model.to(device="cuda").params.train(),
                             MASTER_OPT, compute_dtype=torch.bfloat16)
    before = _ln_scales(state.params)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t = time.perf_counter()
    state, m = train_step(state, batch, cfg, MASTER_OPT, remat=True,
                          view_ids=ids)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    counts = _read_counts()
    # mu after one step is (1 - b1) times the fp32 gradient AdamW took
    b1 = MASTER_OPT.betas[0]
    groups: dict = {}
    for name, mu in state.opt_state.mu.items():
        groups.setdefault(name.split(".")[0], []).append(
            (mu / (1 - b1)).float().cpu().reshape(-1))
    errs = {"loss": abs(float(m["loss"]) - ref_loss) / abs(ref_loss),
            **{f"grad/{k}": ((torch.cat(v) - ref_grads[k]).norm()
                             / ref_grads[k].norm()).item()
               for k, v in groups.items()}}
    moved = {n: bool((p != before[n]).all())
             for n, p in _ln_scales(state.params).items()}
    work = dict(state.work.named_parameters())
    copy_exact = all(torch.equal(work[n], p.to(torch.bfloat16))
                     for n, p in state.params.named_parameters())
    per_step = {k: train_counts[k] / train_steps for k in PATHS["train"]
                if k != "trunk"}
    bad = [f"{k} {e}" for k, e in errs.items() if not e <= E2E_TRAIN_REL]
    bad += [f"LayerNorm scale {n} not moved" for n, ok in moved.items()
            if not ok]
    bad += [f"{k}: {counts[k]} launches, the fused road's step {v}"
            for k, v in per_step.items() if counts[k] != v]
    if not copy_exact:
        bad.append("the working copy is not the master rounded to bf16")
    if len(moved) != 2 * 24 + 2 * 24 + 2:
        bad.append(f"{len(moved)} LayerNorm scales")
    log(json.dumps({"path": "master_train", "views": 2,
                    "image_hw": [224, 224], "step_s": step_s,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "rel_err_vs_cpu_fp32": errs, "tolerance": E2E_TRAIN_REL,
                    "ln_scales_moved": sum(moved.values()),
                    "ln_scales": len(moved), "working_copy_exact": copy_exact,
                    "launches": {k: counts[k] for k in per_step},
                    **_update_ms(state), "gpu": gpu}))
    del state

    # today's bf16 road: bf16 params and moments, the same step
    bstate = init_train_state(cpu_model.to(device="cuda",
                                           dtype=torch.bfloat16)
                              .params.train(), MASTER_OPT)
    bstate, _ = train_step(bstate, batch, cfg, MASTER_OPT, remat=True,
                           view_ids=ids)
    bf16_moved = sum(bool((p != 1.0).any())
                     for p in _ln_scales(bstate.params).values())
    log(json.dumps({"path": "bf16_train", "ln_scales_moved": bf16_moved,
                    "ln_scales": len(moved), **_update_ms(bstate),
                    "gpu": gpu}))
    del bstate

    # the Block's dropout: non-zero rates in both stacks send every block
    # down the plain road (no fused product), on the master road
    dcfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, **ENC_DROPOUT),
        decoder=dataclasses.replace(cfg.decoder, **DEC_DROPOUT))
    dstate = init_train_state(cpu_model.to(device="cuda").params.train(),
                              TRAIN_OPT, compute_dtype=torch.bfloat16)
    _reset_counts()
    t = time.perf_counter()
    for _ in range(2):
        dstate, dm = train_step(dstate, batch, dcfg, TRAIN_OPT, remat=True)
        if dm["skipped_nonfinite"] or not math.isfinite(float(dm["loss"])):
            bad.append(f"dropout step: loss {float(dm['loss'])}, skipped "
                       f"{int(dm['skipped_nonfinite'])}")
    torch.cuda.synchronize()
    dcounts = _read_counts()
    fused = {k: dcounts[k] for k in FUSED_ONLY if dcounts[k]}
    road = "fused" if fused else "plain"
    log(json.dumps({"path": "dropout_train", "encoder": ENC_DROPOUT,
                    "decoder": DEC_DROPOUT, "steps": 2,
                    "road": road, "loss": float(dm["loss"]),
                    "steps_s": time.perf_counter() - t,
                    "launches": {k: v for k, v in dcounts.items() if v},
                    "gpu": gpu}))
    if fused or not all(dcounts[k] > 0 for k in (
            "attention", "layernorm", "layernorm_bwd", "attention_bwd")):
        bad.append(f"dropout step launches {dcounts}")
    del dstate
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase 21: {bad}")
    legacy_losses_on_card(gpu)
    return {"master_train": counts, "dropout_train": dcounts}


# ---------------------------------------------------------------------------
# phases 22-24: the model variants (the DINOv2 encoder; the model_scaling
# decoders)
# ---------------------------------------------------------------------------

def dino_cfg() -> Fast3RConfig:
    """The flagship's decoder and heads behind the DINOv2 ViT-L/14 encoder
    (``DinoEncoderConfig()``: 1024 wide, 24 deep, 16 heads, a 37 x 37
    position grid), the heads at patch 14."""
    flag = Fast3RConfig.flagship()
    return dataclasses.replace(flag, encoder=DinoEncoderConfig(),
                               head=dataclasses.replace(flag.head, patch_size=14))


def view_roads(cfg, shapes) -> dict:
    """The trunk road ``head_road`` picks for each bf16 view shape."""
    fd, c1 = cfg.head.feature_dim, cfg.head.feature_dim // 2
    ps = cfg.head.patch_size
    return {f"{h}x{w}": head_road((1, fd, 8 * (h // ps), 8 * (w // ps)), (h, w),
                                  c1, cfg.head.last_dim, cfg.head.num_channels,
                                  torch.bfloat16)
            for h, w in shapes}


def _serve_counted(path, model, requests, gpu, roads) -> dict:
    """Each request of ``requests`` ((views, serve) pairs) served with the
    counts set to 0 before the first and read after the last; the heads'
    kernels those of ``roads``."""
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for views, serve in requests:
        _serve(path, model, views, serve, gpu)
    counts = _read_counts()
    _check_roads(path, roads, counts, "phases 22-24")
    return counts


def phase_dino_requests(gpu: str):
    log("== phase 22: DINOv2 encoder requests (ViT-L/14 encoder, flagship "
        "decoder and heads at patch 14; random weights seed 0, bfloat16)")
    t0 = time.perf_counter()
    cfg = dino_cfg()
    cpu_model = Fast3R.from_random(cfg, seed=0, device="cpu")
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.parameters())
    log(f"model: {n_params} parameters, built and moved in "
        f"{time.perf_counter() - t0:.1f} s")
    roads = view_roads(cfg, [(392, 518), (518, 392), (224, 224)])
    log(json.dumps({"dino_head_roads": roads}))
    inference(request_views(2, 392, 518, 97), model, verbose=False)  # warm-up
    counts = {"dino": _serve_counted(
        "dino", model, [(request_views(20, 392, 518, 20 + i), i) for i in (1, 2)],
        gpu, [roads["392x518"]])}
    mixed = request_views(10, 392, 518, 31) + request_views(10, 518, 392, 32)
    counts["dino_mixed"] = _serve_counted(
        "dino_mixed", model, [(mixed, 1), (mixed, 2)], gpu,
        [roads["392x518"], roads["518x392"]])
    phase_end_to_end(cpu_model, model,
                     Fast3R(cfg.with_fused_blocks(False), model.params),
                     "phase 22 (dino)")
    del model
    torch.cuda.empty_cache()
    return cpu_model, counts


def phase_dino_training(gpu: str, cpu_model) -> dict:
    log("== phase 23: one DINOv2-model training step (8 views at 224x224, fp32 "
        "master weights and moments, bf16 working copy, remat)")
    net = cpu_model.to(device="cuda").params
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, 8, 224, 224, seed=2).items() if k in BATCH_KEYS}
    counts = {"dino_train": train_road("dino_train", net, cpu_model.cfg, batch, 1,
                                       gpu, compute_dtype=torch.bfloat16)}
    _check_roads("dino_train", list(view_roads(cpu_model.cfg,
                                               [(224, 224)]).values()),
                 counts["dino_train"], "phase 23")
    del net, batch
    torch.cuda.empty_cache()
    return counts


MS_EXPERIMENTS = ("model_scaling_base", "model_scaling_large",
                  "model_scaling_huge")
MS_BATCH = 8    # the overlays' batch_size_per_device
MS_STEPS = 3    # train_steps a model
MS_CLI_SAMPLES = 24  # the CLI run's epoch: 3 steps of batch 8


def ms_cfg(name: str) -> Fast3RConfig:
    """An overlay's model through the training CLI's config loader."""
    from fast3r_torch.config import CONFIG_DIR, load_config, model_config_from_dict

    return model_config_from_dict(load_config(
        os.path.join(CONFIG_DIR, "train.yaml"), f"model_scaling/{name}")["model"])


def phase_model_scaling(gpu: str) -> tuple:
    """The launch counts of the overlays' paths, and model_scaling_huge's
    fp32 CPU model and its 2-view step's reference (phase 29's)."""
    log("== phase 24: the model_scaling overlays (base 768 x 12, large 1024 x "
        "24, huge 1280 x 32 at head_dim 80), each at full width: one 8-view "
        "224x224 request (bf16), three train_steps of batch 8 x 8 views on "
        "fp32 master weights (remat), a 2-view step against fp32 on the CPU")
    counts = {}
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(MS_BATCH, 8, 224, 224, seed=3).items()
             if k in BATCH_KEYS}
    for name in MS_EXPERIMENTS:
        short = name.replace("model_scaling_", "ms_")
        cfg = ms_cfg(name)
        t0 = time.perf_counter()
        cpu_model = Fast3R.from_random(cfg, seed=0, device="cpu")
        n_params = sum(p.numel() for p in cpu_model.params.parameters())
        d = cfg.decoder
        log(json.dumps({"path": short, "parameters": n_params,
                        "decoder": [d.embed_dim, d.depth, d.num_heads,
                                    d.head_dim],
                        "attn_impl": [cfg.encoder.attn_impl, d.attn_impl],
                        "built_s": time.perf_counter() - t0}))
        roads = list(view_roads(cfg, [(224, 224)]).values())
        model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
        inference(request_views(2, 224, 224, 96), model, verbose=False)
        views = request_views(8, 224, 224, 40)
        counts[short] = _serve_counted(short, model, [(views, 1), (views, 2)],
                                       gpu, roads)
        del model
        torch.cuda.empty_cache()
        net = cpu_model.to(device="cuda").params  # fp32 master weights
        counts[f"{short}_train"] = train_road(f"{short}_train", net, cfg, batch,
                                              MS_STEPS, gpu,
                                              compute_dtype=torch.bfloat16)
        _check_roads(f"{short}_train", roads, counts[f"{short}_train"],
                     "phase 24")
        del net
        torch.cuda.empty_cache()
        ref = phase_train_end_to_end(cpu_model, cfg.with_fused_blocks(False),
                                     f"phase 24 ({short})")
        if short == "ms_huge":
            huge = (cpu_model, ref)
        del cpu_model
    del batch
    torch.cuda.empty_cache()
    counts.update(phase_cli_model_scaling(gpu))
    return counts, huge


def phase_huge_seq(gpu: str, cpu_model, cpu_ref: tuple) -> dict:
    """``cpu_model``: phase 24's model_scaling_huge (fp32, CPU);
    ``cpu_ref``: its 2-view 224x224 step's fp32 loss and gradients."""
    cfg = cpu_model.cfg
    d = cfg.decoder
    log(f"== phase 29: model_scaling_huge sequence-sharded ({d.embed_dim} x "
        f"{d.depth}, {d.num_heads} heads of {d.head_dim}: the ring kernels at "
        f"head_dim 80; random weights seed 0, bfloat16): a {HUGE_VIEWS}-view "
        f"{HUGE_HW[0]}x{HUGE_HW[1]} request over {SEQ_RANKS} ranks against "
        f"the one-rank forward, {HUGE_STEPS} steps of 1 x 8 views over "
        f"{SEQ_RANKS} ranks, a 2-view step over 2 ranks against fp32 on the "
        "CPU")
    if d.head_dim != HUGE_D:
        raise AssertionError(f"phase 29: head_dim {d.head_dim}")
    roads = list(view_roads(cfg, [HUGE_HW]).values())
    model = cpu_model.to(device="cuda", dtype=torch.bfloat16)
    fwd = make_seq_sharded_forward(cfg, SEQ_RANKS, HUGE_VIEWS, HUGE_HW,
                                   ring_impl="rdma")
    imgs = _seq_imgs(HUGE_VIEWS, *HUGE_HW, 29)
    ids = sample_random_image_ids(None, 1, HUGE_VIEWS)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    for serve in (1, 2):  # one cold request, one warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fwd(model.params, imgs, ids[0])
        out = {k: v.float().cpu() for k, v in out.items()}
        dt = time.perf_counter() - t
        log(json.dumps({"path": "ms_huge_seq", "ranks": SEQ_RANKS,
                        "request_views": HUGE_VIEWS,
                        "image_hw": list(HUGE_HW), "serve": serve,
                        "latency_s": dt, "images_per_s": HUGE_VIEWS / dt,
                        "gpu": gpu,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    counts = {"ms_huge_seq": _read_counts()}
    _expect("ms_huge_seq", counts["ms_huge_seq"],
            ring_attention=2 * d.depth, attention=0)
    _check_roads("ms_huge_seq", roads, counts["ms_huge_seq"], "phase 29")
    check_preds([{k: v[:, i] for k, v in out.items()}
                 for i in range(HUGE_VIEWS)], [HUGE_HW] * HUGE_VIEWS)
    plain_dec = dataclasses.replace(cfg, decoder=dataclasses.replace(
        d, fused_blocks=False))
    with torch.inference_mode():
        ref = fast3r_forward(model.params, plain_dec,
                             imgs.cuda().bfloat16(), view_ids=ids)
        ref = {k: v.float().cpu() for k, v in ref.items()}
    errs = _rel_l2(out, ref)
    log(json.dumps({"path": "ms_huge_seq", "seq_vs_single_device_rel_l2": errs,
                    "tolerance": SEQ_REL_L2}))
    bad = {k: e for k, e in errs.items() if not e <= SEQ_REL_L2}
    if bad:
        raise AssertionError(f"phase 29: seq-sharded outputs off: {bad}")
    del model, out, ref
    torch.cuda.empty_cache()

    net = cpu_model.to(device="cuda", dtype=torch.bfloat16).params
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             make_dummy_batch(1, 8, *HUGE_HW, seed=29).items()
             if k in BATCH_KEYS}
    c = train_road("ms_huge_seq_train", net, cfg, batch, HUGE_STEPS, gpu,
                   step=make_seq_sharded_train_step(cfg, TRAIN_OPT, SEQ_RANKS))
    counts["ms_huge_seq_train"] = c
    log(json.dumps({"path": "ms_huge_seq_train", "ranks": SEQ_RANKS,
                    "steps": HUGE_STEPS,
                    "launches_per_step": {k: v / HUGE_STEPS
                                          for k, v in c.items()}}))
    _expect("ms_huge_seq_train", c, ring_attention=HUGE_STEPS * 2 * d.depth,
            ring_attention_bwd_dq=HUGE_STEPS * d.depth,
            ring_attention_bwd_dkv=HUGE_STEPS * d.depth, attention=0,
            attention_bwd=0)
    _check_roads("ms_huge_seq_train", roads, c, "phase 29")
    del net, batch
    torch.cuda.empty_cache()
    _seq_step_end_to_end(cpu_model, cpu_ref, "ms_huge_seq_train")
    return counts


def phase_cli_model_scaling(gpu: str) -> dict:
    """``fast3r_torch.cli.train --experiment model_scaling/model_scaling_huge``
    in this process on a CO3D-format root (phase 19's writer), the overlay's
    own data recipe with its datasets cut to the Co3d entries (the other
    three sets have no synthetic root) retargeted there with
    MS_CLI_SAMPLES training and 2 validation samples, one epoch."""
    import shutil

    from fast3r_torch.cli import train as cli_train
    from fast3r_torch.config import CONFIG_DIR, load_config
    from fast3r_torch.train import trainer as trainer_mod

    exp = load_config(os.path.join(CONFIG_DIR, "train.yaml"),
                      "model_scaling/model_scaling_huge")["data"]
    tmp = tempfile.mkdtemp(prefix="fast3r_ms_cli_")
    try:
        t = time.perf_counter()
        root = make_co3d_root(os.path.join(tmp, "co3d"))
        root_s = time.perf_counter() - t

        def retarget(spec: str, n: int) -> str:
            call = spec.partition(" @ ")[2]
            old_root = call.split("ROOT='", 1)[1].split("'", 1)[0]
            return f"{n} @ " + call.replace(f"ROOT='{old_root}'", f"ROOT='{root}'")

        (train,) = [d for d in exp["train_datasets"] if "Co3d_Multiview" in d]
        (val,) = [d for d in exp["validation_datasets"] if "Co3d_Multiview" in d]
        run_dir = os.path.join(tmp, "run")
        args = ["--experiment", "model_scaling/model_scaling_huge", "--no-resume",
                f"paths.run_dir={run_dir}",
                f"data.train_datasets={[retarget(train, MS_CLI_SAMPLES)]!r}",
                f"data.validation_datasets={[retarget(val, CLI_VAL_SAMPLES)]!r}",
                "trainer.max_epochs=1", "trainer.log_every_n_steps=1",
                "data.num_workers=3", "data.num_workers_val=0"]
        steps = []
        orig_step = trainer_mod.train_step

        def step_fn(state, batch, *a, **kw):
            t0 = time.perf_counter()
            state, m = orig_step(state, batch, *a, **kw)
            torch.cuda.synchronize()
            steps.append({"step_s": time.perf_counter() - t0,
                          "imgs": list(np.shape(batch["imgs"]))})
            return state, m

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        main_module = sys.modules["__main__"]
        sys.modules["__main__"] = cli_train  # the spawn workers import it
        trainer_mod.train_step = step_fn
        _reset_counts()
        t = time.perf_counter()
        try:
            trainer = cli_train.main(args)
        finally:
            sys.modules["__main__"] = main_module
            trainer_mod.train_step = orig_step
        counts = _read_counts()
        total_s = time.perf_counter() - t
        rows = _csv_rows(os.path.join(run_dir, "metrics.csv"))
        losses = [float(r["loss"]) for r in rows if r.get("loss")]
        val = [r for r in rows if r.get("val/dataset_0/loss")]
        st = trainer.state
        rec = {"path": "ms_huge_cli", "co3d_root_s": root_s, "total_s": total_s,
               "steps": st.step, "losses": losses,
               "steps_taken": steps,
               "val_loss": val[0]["val/dataset_0/loss"] if val else None,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "parameters": sum(p.numel() for p in st.params.parameters()),
               "master": str(next(st.params.parameters()).dtype),
               "working_copy": str(None if st.work is None else
                                   next(st.work.parameters()).dtype),
               "gpu": gpu}
        log(json.dumps(rec))
        want_steps = MS_CLI_SAMPLES // MS_BATCH
        if (st.step != want_steps or len(steps) != want_steps
                or any(x["imgs"][:2] != [MS_BATCH, 8] for x in steps)
                or len(losses) < want_steps
                or not all(math.isfinite(x) for x in losses) or len(val) != 1
                or rec["working_copy"] != "torch.bfloat16"):
            raise AssertionError(f"phase 24, the training CLI on "
                                 f"model_scaling_huge: {rec}")
        del trainer, st
        return {"ms_huge_cli": counts}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def _check_roads(path: str, roads: list, counts: dict,
                 phase: str = "phase 20") -> None:
    """The head kernel of each road taken launched, the other did not."""
    used = {"trunk": "trunk" in roads, "resize": "resize_kernel" in roads}
    bad = [k for k, u in used.items() if (counts[k] > 0) != u]
    if bad or not roads:
        raise AssertionError(f"{phase}, {path}: head roads {set(roads)}, "
                             f"launches trunk {counts['trunk']} resize "
                             f"{counts['resize']}")


# ---------------------------------------------------------------------------
# phase 27: the mesh step on the card (data 2 x model 2 ranks on one card)
# ---------------------------------------------------------------------------

# the grid, and each data rank's batch: 1 sample of 8 views at 512x384, so
# a rank's products have M = 8 x 768 = 6144 rows and, at model 2, 8 heads,
# qkv N = 1536, proj K = 512 and an MLP hidden of 2048
MESH_DATA, MESH_MODEL, MESH_VIEWS, MESH_STEPS = 2, 2, 8, 3
# the grids' models (here and phase 28's) cut to MESH_DEPTH of their 24
# blocks an encoder and a decoder, widths and heads as published: a
# rank's time goes to building the params and to gloo's sums over them,
# both linear in the depth, and every sharded layer kind is in each block
MESH_DEPTH = 8
MESH_M = MESH_VIEWS * 768
MESH_OPT = OptimConfig(lr=1e-4, warmup_steps=1, total_steps=1000)
# the mesh step against the one-process Trainer road on the same global
# batch and image ids, both on bf16 working copies of fp32 masters (the TP
# road sums each sublayer's two bf16 partial outputs, the one-process road
# rounds one output; the data road reduces fp32 gradient shards in another
# order): the loss within MESH_LOSS_RTOL relative, and each top-level
# group's update (master after minus before) within MESH_UPDATE_RTOL
# relative L2 or within MESH_FLOOR_X times the same group's distance
# between two roads of the one-process step that differ in rounding only
# (the fused and the plain block roads), whichever is larger.  AdamW's
# first steps move each element by about lr whatever its gradient's size,
# so an element whose gradient is near bf16 noise moves by a different
# amount on any two roads; the heads' small convolutions have the most such
# elements (measured on an H100: head_global 2.9% against a floor of 1.8%,
# the stacks 1.1-1.3% against 0.4-0.8%).
MESH_LOSS_RTOL = 0.01
MESH_UPDATE_RTOL = 0.02
MESH_FLOOR_X = 2.0


def mesh_cfg() -> Fast3RConfig:
    """super_long_training's model through the training CLI's loader: the
    CroCo encoder 1024 wide and the fusion decoder 1024 wide, both cut to
    MESH_DEPTH blocks, both heads, the fused road."""
    from fast3r_torch.config import CONFIG_DIR, load_config, model_config_from_dict

    cfg = model_config_from_dict(load_config(
        os.path.join(CONFIG_DIR, "train.yaml"), "super_long_training")["model"])
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, depth=MESH_DEPTH),
        decoder=dataclasses.replace(cfg.decoder, depth=MESH_DEPTH))


def _mesh_batches() -> list:
    """The global batches: 2 samples (one a data rank) of 8 views."""
    return [{k: v for k, v in make_dummy_batch(
        MESH_DATA, MESH_VIEWS, 384, 512, seed=40 + i).items()
        if k in BATCH_KEYS} for i in range(MESH_STEPS)]


def _mesh_worker(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of the grid: a mesh Trainer (fp32 master shards, bf16
    working copy, ZeRO-2) takes MESH_STEPS steps on its rows of the global
    batches over gloo; its records, launch counts and (rank 0) the gathered
    whole master land in ``out_dir``."""
    import torch.distributed as dist

    from fast3r_torch.parallel import mesh as mesh_lib
    from fast3r_torch.train.trainer import Trainer, TrainerConfig

    torch.cuda.set_device(0)
    # the four ranks share the machine's cores (the whole model's init on
    # the CPU, gloo's host side)
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    cfg = mesh_cfg()
    t = time.perf_counter()
    trainer = Trainer(cfg, MESH_OPT, trainer_cfg=TrainerConfig(
        run_dir=os.path.join(out_dir, "run"), loggers=(), use_mesh=True,
        model_axis=MESH_MODEL), device="cuda")
    init_s = time.perf_counter() - t
    mesh = trainer.mesh
    blk = dict(trainer.state.net.decoder.blocks[0].named_parameters())
    shapes = {k: list(blk[k].shape) for k in
              ("attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight",
               "mlp.fc2.weight")}
    # the collectives' seconds: each call synchronised and timed
    coll = [0.0]
    run = mesh._run

    def timed(group, size, op, *ts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(group, size, op, *ts)
        torch.cuda.synchronize()
        coll[0] += time.perf_counter() - t0

    mesh._run = timed
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    recs = []
    for i, batch in enumerate(_mesh_batches()):
        rows = mesh_lib.batch_rows(mesh, MESH_DATA)
        coll[0] = 0.0
        t = time.perf_counter()
        trainer.state, m = train_step(
            trainer.state, {k: v[rows] for k, v in batch.items()}, cfg,
            MESH_OPT, remat=True)
        torch.cuda.synchronize()
        recs.append({"rank": rank, "grid": [mesh.data_rank, mesh.model_rank],
                     "train_step": i + 1, "step_s": time.perf_counter() - t,
                     "collective_s": coll[0], "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "skipped_nonfinite": int(m["skipped_nonfinite"]),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    counts = _read_counts()
    master = trainer.params_state_dict()
    if rank == 0:
        torch.save(master, os.path.join(out_dir, "mesh_master.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"steps": recs, "counts": counts, "shapes": shapes,
                   "init_s": init_s,
                   "moment_gb": mesh_lib.moment_bytes(trainer.state.opt_state) / 1e9},
                  f)
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_update_err(before: dict, after: dict, ref: dict) -> dict:
    """Per top-level group: |(after - before) - (ref - before)| /
    |ref - before| in the L2 norm."""
    num, den = {}, {}
    for k, b in before.items():
        g = k.split(".", 1)[0]
        du = ref[k].float() - b
        num[g] = num.get(g, 0.0) + float((after[k].float() - b - du).square().sum())
        den[g] = den.get(g, 0.0) + float(du.square().sum())
    return {g: math.sqrt(num[g] / den[g]) for g in num}


def check_tp_kernels(results: list) -> None:
    """The kernels of the mesh step at a model-2 rank's shapes against
    their plain versions, in the phase-2 manner: M = 6144 rows (8 views x
    768 tokens), 8 heads of 64, qkv N = 1536 (K4 with RoPE, K3, the K11
    replay), proj K = 512's partial product (the bias epilogue: the bias
    on model rank 0, zero on rank 1; the residual is added after the
    ranks' sum), the whole MLP at hidden 2048 without x (b2 on rank 0,
    zero on rank 1), the fc1 replay at
    N = 2048, the encoder's packed attention (3, 8, 768, 512) forward and
    backward (K2, K10) and the decoder's (1, 6144, 8, 64) (K1, K9)."""
    g = _gen(27)
    bf, it = torch.bfloat16, 2
    M, Cc, Cl, Hl, HIDl = MESH_M, C, C // 2, 8, HID // 2
    x = (torch.randn((M, Cc), generator=g, device="cuda") * 2 + 0.5).to(bf)
    gamma = (1 + 0.1 * torch.randn((Cc,), generator=g, device="cuda")).to(bf)
    beta = (0.1 * torch.randn((Cc,), generator=g, device="cuda")).to(bf)
    wqkv, bqkv = _linear(3 * Cl, Cc, g)
    wproj, bproj = _linear(Cc, Cl, g)
    w1, b1 = _linear(HIDl, Cc, g)
    w2, b2 = _linear(Cc, HIDl, g)
    yy, xx = torch.meshgrid(torch.arange(24), torch.arange(32), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, -1, 2).repeat(
        MESH_VIEWS, 1, 1).cuda()
    cos, sin = rope2d_cos_sin(pos, 64)
    ct, st = expand_rope_tables(cos, sin, Cl, bf)
    tp = "model 2 rank"

    def ln_linear(w, b, eps):
        return F.linear(F.layer_norm(x, (Cc,), gamma, beta, eps), w, b)

    def library_rope():
        y = ln_linear(wqkv, bqkv, 1e-6)

        def rope(t):
            t = t.float()
            return (t * ct + rotate_half_lanes(t, 32) * st).to(bf)
        return torch.stack([rope(y[:, :Cl]), rope(y[:, Cl:2 * Cl]),
                            y[:, 2 * Cl:]])

    qkv_flops = 2.0 * M * Cc * 3 * Cl
    args = (x, gamma, beta, wqkv, bqkv, ct, st, Hl, 1e-6)
    _record(results, "ln_qkv_rope", "fused_gemm", f"{tp} N=1536 {M}x{Cc}",
            fb.ln_qkv_rope(*args), fb.ln_qkv_rope_ref(*args),
            lambda: fb.ln_qkv_rope(*args), lambda: fb.ln_qkv_rope_ref(*args),
            library_rope, "F.layer_norm + F.linear + torch elementwise RoPE",
            qkv_flops, (3 * Cl * Cc + 3 * Cl + 2 * Cc + M * Cc + 3 * M * Cl
                        + 2 * M * Cl) * it)
    args = (x, gamma, beta, wqkv, bqkv, 1e-5)
    _record(results, "ln_qkv", "fused_gemm", f"{tp} N=1536 {M}x{Cc}",
            torch.stack(fb.ln_qkv(*args)), torch.stack(fb.ln_qkv_ref(*args)),
            lambda: fb.ln_qkv(*args), lambda: fb.ln_qkv_ref(*args),
            lambda: ln_linear(wqkv, bqkv, 1e-5).split(Cl, dim=1),
            "F.layer_norm + F.linear", qkv_flops,
            (3 * Cl * Cc + 3 * Cl + 2 * Cc + M * Cc + 3 * M * Cl) * it)
    for mode, w, b, n, lib_name, lib in (
            ("qkv", wqkv, bqkv, 3 * Cl, "F.layer_norm + F.linear",
             lambda: ln_linear(wqkv, bqkv, 1e-5)),
            ("gelu", w1, b1, HIDl, "F.layer_norm + F.linear + F.gelu",
             lambda: F.gelu(ln_linear(w1, b1, 1e-6)))):
        rargs = (mode, x, gamma, beta, w, b, 1e-6, None, Hl)
        got = fb._replay(*rargs)
        ref = fb._replay_ref(*rargs)
        errs = [compare("fused_gemm", got[0], ref[0], bf),
                compare("replay_u", got[1], ref[1], bf)]
        errs += [compare("replay_stats", a, e, bf)
                 for a, e in zip(got[2:4], ref[2:4])]
        if mode == "gelu":
            errs.append(compare("fused_gemm", got[4], ref[4], bf))
        r = dict(errs[0], kernel="ln_matmul_replay",
                 case=f"{tp} {mode} N={n} {M}x{Cc}", dtype="bfloat16",
                 max_abs_err_residuals=max(e["max_abs_err"] for e in errs[1:]),
                 ms=median_ms(lambda: fb._replay(*rargs), 10),
                 plain_ms=median_ms(lambda: fb._replay_ref(*rargs), 3),
                 library=lib_name, library_ms=median_ms(lib, 10),
                 **bound(2.0 * M * Cc * n,
                         (2 * M * Cc + n * Cc + M * n) * it
                         + (n + 2 * Cc + 2 * M) * 4
                         + (M * n * it if mode == "gelu" else 0)))
        results.append(r)
        log(json.dumps(r))
        del got, ref
    o = (torch.randn((M, Cl), generator=g, device="cuda") * 0.5).to(bf)
    zero = torch.zeros_like(bproj)
    # each rank's partial products, the residual added after their sum
    # (fb._matmul_residual): the bias (b2) on model rank 0, zero on rank 1
    for case, bias in (("bias (rank 0)", bproj), ("zero bias (rank 1)", zero)):
        args = (o, wproj, bias, None)
        _record(results, "matmul_residual", "fused_gemm",
                f"{tp} proj K={Cl} partial, {case} {M}x{Cl} -> {Cc}",
                fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
                lambda: fb.matmul_residual(*args),
                lambda: fb.matmul_residual_ref(*args),
                lambda: F.linear(o, wproj, bias), "F.linear",
                2.0 * M * Cl * Cc, (M * Cl + Cc * Cl + Cc + M * Cc) * it)
    for case, bb in (("b2 (rank 0)", b2), ("zero b2 (rank 1)", zero)):
        args = (x, gamma, beta, w1, b1, w2, bb, 1e-6)
        _record(results, "ln_mlp", "ln_mlp",
                f"{tp} hidden {HIDl} partial, {case} {M}x{Cc}",
                fb._ln_mlp(*args, residual=False),
                fb.ln_mlp_ref(*args, residual=False),
                lambda: fb._ln_mlp(*args, residual=False),
                lambda: fb.ln_mlp_ref(*args, residual=False),
                lambda: F.linear(F.gelu(ln_linear(w1, b1, 1e-6)), w2, bb),
                "F.layer_norm + F.linear + F.gelu + F.linear",
                4.0 * M * Cc * HIDl,
                (2 * M * Cc + 2 * HIDl * Cc + HIDl + 3 * Cc) * it)
    del o
    torch.cuda.empty_cache()

    # the encoder's attention from a rank's packed (3, 8, 768, 512) buffer
    B, N, D = MESH_VIEWS, 768, 64
    qkv3 = torch.randn((3, B, N, Cl), generator=g, device="cuda").to(bf)
    q, k, v = (qkv3[i].view(B, N, Hl, D) for i in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    _record(results, "packed_qkv_attention", "attention",
            f"{tp} (3, {B}, {N}, {Cl}), {Hl} heads",
            packed_qkv_attention(qkv3, Hl, TRAIN_SCALE),
            attention_ref(q, k, v, TRAIN_SCALE).reshape(B, N, Cl),
            lambda: packed_qkv_attention(qkv3, Hl, TRAIN_SCALE),
            lambda: attention_ref(q, k, v, TRAIN_SCALE),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   scale=TRAIN_SCALE),
            "F.scaled_dot_product_attention", 4.0 * B * Hl * N * N * D,
            4 * B * N * Cl * it)
    do = torch.randn((B, N, Cl), generator=g, device="cuda").to(bf)
    o, lse = attention_fwd_lse(q, k, v, TRAIN_SCALE)
    got = packed_qkv_attention_bwd(qkv3, o, lse, do, Hl, TRAIN_SCALE)
    ref = attention_bwd_ref(q, k, v, o, lse, do.view(B, N, Hl, D), TRAIN_SCALE)
    errs = [compare("attention_bwd", got[i], ref[i].reshape(B, N, Cl), bf)
            for i in range(3)]
    del ref
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, scale=TRAIN_SCALE)
    r = dict(_merge(errs), kernel="packed_qkv_attention_bwd",
             case=f"{tp} (3, {B}, {N}, {Cl}), {Hl} heads", dtype="bfloat16",
             ms=median_ms(lambda: packed_qkv_attention_bwd(
                 qkv3, o, lse, do, Hl, TRAIN_SCALE), 10),
             plain_ms=median_ms(lambda: attention_bwd_ref(
                 q, k, v, o, lse, do.view(B, N, Hl, D), TRAIN_SCALE), 2),
             library="autograd of F.scaled_dot_product_attention",
             library_ms=_grad_ms(ol, (ql, kl, vl),
                                 do.view(B, N, Hl, D).transpose(1, 2), 10),
             **_attn_bwd_bound(B, N, Hl, D))
    results.append(r)
    log(json.dumps(r))
    del qkv3, q, k, v, qt, kt, vt, do, o, lse, got, ql, kl, vl, ol
    torch.cuda.empty_cache()

    # the decoder's attention over a rank's 8 heads of the 6144-token sequence
    B, N = 1, M
    qkv = torch.randn((B, N, 3, Hl, D), generator=g, device="cuda").to(bf)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    _record(results, "attention", "attention", f"{tp} decoder {B}x{N}x{Hl}x{D}",
            flash_attention(q, k, v, TRAIN_SCALE),
            attention_ref(q, k, v, TRAIN_SCALE),
            lambda: flash_attention(q, k, v, TRAIN_SCALE),
            lambda: attention_ref(q, k, v, TRAIN_SCALE),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   scale=TRAIN_SCALE),
            "F.scaled_dot_product_attention", 4.0 * B * Hl * N * N * D,
            4 * B * N * Hl * D * it)
    do = torch.randn((B, N, Hl, D), generator=g, device="cuda").to(bf)
    o, lse = attention_fwd_lse(q, k, v, TRAIN_SCALE)
    got = attention_bwd(q, k, v, o, lse, do, TRAIN_SCALE)
    ref = attention_bwd_ref(q, k, v, o, lse, do, TRAIN_SCALE)
    errs = [compare("attention_bwd", a, e, bf) for a, e in zip(got, ref)]
    del ref
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, scale=TRAIN_SCALE)
    r = dict(_merge(errs), kernel="attention_bwd",
             case=f"{tp} decoder {B}x{N}x{Hl}x{D}", dtype="bfloat16",
             ms=median_ms(lambda: attention_bwd(q, k, v, o, lse, do,
                                                TRAIN_SCALE), 10),
             plain_ms=median_ms(lambda: attention_bwd_ref(
                 q, k, v, o, lse, do, TRAIN_SCALE), 2),
             library="autograd of F.scaled_dot_product_attention",
             library_ms=_grad_ms(ol, (ql, kl, vl), do.transpose(1, 2), 10),
             **_attn_bwd_bound(B, N, Hl, D))
    results.append(r)
    log(json.dumps(r))
    del qkv, q, k, v, qt, kt, vt, do, o, lse, got, ql, kl, vl, ol
    torch.cuda.empty_cache()


def phase_mesh(gpu: str, results: list) -> dict:
    """Phase 27: the kernels at a model-2 rank's shapes against their plain
    versions; the one-process Trainer road's MESH_STEPS steps on the
    global batches; the same steps on a data 2 x model 2 grid of four
    processes sharing the card over gloo (on the card's tensors); the two
    held together; then one step of the mesh Trainer at
    world size 1 over NCCL.  Returns the launch counts of the one-process
    road ("mesh_ref") and of each rank ("mesh_rank{r}")."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from fast3r_torch.train.trainer import Trainer, TrainerConfig

    log(f"== phase 27: the mesh step (super_long_training's model, "
        f"{MESH_DEPTH} blocks a stack, "
        f"data {MESH_DATA} x model {MESH_MODEL} ranks on one card over gloo, "
        f"{MESH_VIEWS} views at 512x384 a data rank, fp32 master shards, bf16 "
        f"working copy, ZeRO-2, {MESH_STEPS} steps)")
    t0 = time.perf_counter()
    check_tp_kernels(results)
    log(f"the model-2 rank shapes' kernels checked in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = mesh_cfg()
    batches = _mesh_batches()
    t0 = time.perf_counter()
    one = Trainer(cfg, MESH_OPT, trainer_cfg=TrainerConfig(
        run_dir=tempfile.mkdtemp(), loggers=()), device="cuda")
    before = {k: v.detach().cpu() for k, v in
              one.state.params.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ref_loss = []
    for i, batch in enumerate(batches):
        t = time.perf_counter()
        one.state, m = train_step(one.state, batch, cfg, MESH_OPT, remat=True)
        torch.cuda.synchronize()
        ref_loss.append(float(m["loss"]))
        log(json.dumps({"path": "mesh_ref", "train_step": i + 1,
                        "views": 2 * MESH_VIEWS, "step_s":
                        time.perf_counter() - t, "loss": ref_loss[-1],
                        "peak_mem_gb":
                        torch.cuda.max_memory_allocated() / 1e9, "gpu": gpu}))
    counts = {"mesh_ref": _read_counts()}
    after_ref = {k: v.detach().cpu() for k, v in
                 one.state.params.named_parameters()}
    del one
    torch.cuda.empty_cache()
    # the rounding floor: the same steps on the plain block road
    net = empty_fast3r(cfg, device="cpu")
    net.load_state_dict(before)
    plain_cfg = cfg.with_fused_blocks(False)
    one = Trainer(plain_cfg, MESH_OPT, trainer_cfg=TrainerConfig(
        run_dir=tempfile.mkdtemp(), loggers=()), params=net.cuda(),
        device="cuda")
    for batch in batches:
        one.state, _ = train_step(one.state, batch, plain_cfg, MESH_OPT,
                                  remat=True)
    floor = _group_update_err(before, {k: v.detach().cpu() for k, v in
                                       one.state.params.named_parameters()},
                              after_ref)
    del one, net
    torch.cuda.empty_cache()
    log(f"the one-process roads in {time.perf_counter() - t0:.1f} s")

    world = MESH_DATA * MESH_MODEL
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        mp.spawn(_mesh_worker, args=(world, _free_port(), out), nprocs=world)
        log(f"the {world} ranks in {time.perf_counter() - t0:.1f} s")
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        after = torch.load(os.path.join(out, "mesh_master.pt"), mmap=True)
        err = _group_update_err(before, after, after_ref)
        del after
    bad = []
    for rk in ranks:
        for rec in rk["steps"]:
            log(json.dumps({"path": "mesh", **rec, "gpu": gpu}))
        r = rk["steps"][0]["rank"]
        log(json.dumps({"path": "mesh", "rank": r, "init_s": rk["init_s"],
                        "moment_gb": rk["moment_gb"],
                        "block_shapes": rk["shapes"]}))
        counts[f"mesh_rank{r}"] = rk["counts"]
        if rk["counts"] != counts["mesh_ref"]:
            bad.append(f"rank {r} launches {rk['counts']} != the one-process "
                       f"road's {counts['mesh_ref']}")
        if rk["shapes"] != {"attn.qkv.weight": [3 * C // 2, C],
                            "attn.proj.weight": [C, C // 2],
                            "mlp.fc1.weight": [HID // 2, C],
                            "mlp.fc2.weight": [C, HID // 2]}:
            bad.append(f"rank {r} block shapes {rk['shapes']}")
        for rec, want in zip(rk["steps"], ref_loss):
            if (rec["skipped_nonfinite"] or not math.isfinite(rec["loss"])
                    or abs(rec["loss"] - want) > MESH_LOSS_RTOL * abs(want)):
                bad.append(f"rank {r} step {rec['train_step']} loss "
                           f"{rec['loss']} vs {want}")
    tol = {g: max(MESH_UPDATE_RTOL, MESH_FLOOR_X * f) for g, f in floor.items()}
    log(json.dumps({"path": "mesh", "update_rel_l2_by_group": err,
                    "plain_vs_fused_road_by_group": floor, "tolerance": tol}))
    bad += [f"{g} update rel L2 {e:.4f} > {tol[g]:.4f}" for g, e in err.items()
            if not e <= tol[g]]

    # NCCL at world size 1: the mesh Trainer's road builds and launches
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        small = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, depth=2), decoder=dataclasses.replace(
            cfg.decoder, depth=2))
        tr = Trainer(small, MESH_OPT, trainer_cfg=TrainerConfig(
            run_dir=tempfile.mkdtemp(), loggers=(), use_mesh=True),
            device="cuda")
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        b = {k: v[:1, :2] for k, v in batches[0].items()}
        tr.state, m = train_step(tr.state, b, small, MESH_OPT)
        torch.cuda.synchronize()
        rec = {"path": "mesh_nccl_world1", "backend": dist.get_backend(),
               "loss": float(m["loss"]), "all_reduce": x.tolist(),
               "seconds": time.perf_counter() - t0}
        log(json.dumps(rec))
        if not math.isfinite(rec["loss"]) or x.tolist() != [1.0] * 4:
            bad.append(f"NCCL world 1: {rec}")
        del tr
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase 27: {bad}")
    return counts


# ---------------------------------------------------------------------------
# phase 28: the model variants tensor-parallel (data 1 x model 2 ranks on one
# card)
# ---------------------------------------------------------------------------

# the grid and the global batch: 1 sample of 4 views at 512x384 (llama_dec,
# the dropout step) or 224x224 (DINO), 2 steps; a llama_dec rank's products
# have M = 4 x 768 = 3072 rows, 8 query heads over 8 kv heads (q | k | v N
# 1536), wo K 512 and a SwiGLU hidden of 1408 (w1 / w3 N, w2 K)
TP_MODEL, TP_VIEWS, TP_STEPS = 2, 4, 2
TP_M = TP_VIEWS * 768
TP_OPT = OptimConfig(lr=1e-4, warmup_steps=1, total_steps=1000)
# DINO: 257 tokens a 224x224 view (16 x 16 patches and the cls token) in
# the steps; a tensor-parallel forward of 2 views at 392x518 (1037 tokens)
TP_DINO_HW, TP_DINO_BIG = (224, 224), (2, 392, 518)
# the loss against the one-process road's within TP_LOSS_RTOL relative (a
# rank sums each row-parallel product's two bf16 halves where the
# one-process road rounds one product; phase 27's flagship step stays
# within a few 1e-5); each group's update as phase 27's (MESH_UPDATE_RTOL, or
# MESH_FLOOR_X times the one-process step's spread between two roads that
# differ in rounding only); the DINO forward within TP_FWD_RTOL relative L2
# of the one-process forward (both bf16), phase 16's bound
TP_LOSS_RTOL = 1e-4
TP_FWD_RTOL = 0.02
TP_LLAMA_SHAPES = {"attn.wq.weight": [C // 2, C], "attn.wk.weight": [C // 2, C],
                   "attn.wv.weight": [C // 2, C], "attn.wo.weight": [C, C // 2],
                   "ffn.w1.weight": [L_HID // 2, C],
                   "ffn.w2.weight": [C, L_HID // 2],
                   "ffn.w3.weight": [L_HID // 2, C]}


def tp_cfg(case: str) -> Fast3RConfig:
    """The model of a phase-28 case at MESH_DEPTH blocks a stack: "llama"
    llama_dec (phases 7-10's), "dino" the DINOv2 model (phases 22-23's),
    "drop" the flagship with the encoder's drop_path 0.1 (its blocks on the
    plain road, the decoder on its fused road)."""
    if case == "llama":
        cfg = llama_cfg()
        dec = dataclasses.replace(cfg.decoder, n_layers=MESH_DEPTH)
    else:
        if case == "dino":
            cfg = dino_cfg()
        else:
            flag = Fast3RConfig.flagship()
            cfg = dataclasses.replace(flag, encoder=dataclasses.replace(
                flag.encoder, drop_path=0.1))
        dec = dataclasses.replace(cfg.decoder, depth=MESH_DEPTH)
    return dataclasses.replace(cfg, decoder=dec, encoder=dataclasses.replace(
        cfg.encoder, depth=MESH_DEPTH))


def _tp_batches(case: str) -> list:
    h, w = TP_DINO_HW if case == "dino" else (384, 512)
    return [{k: v for k, v in make_dummy_batch(
        1, TP_VIEWS, h, w, seed=60 + i).items() if k in BATCH_KEYS}
        for i in range(TP_STEPS)]


def _tp_big_imgs() -> torch.Tensor:
    v, h, w = TP_DINO_BIG
    g = torch.Generator().manual_seed(61)
    return (torch.rand((1, v, h, w, 3), generator=g) * 2 - 1).to(
        device="cuda", dtype=torch.bfloat16)


def _tp_worker(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of the data 1 x model 2 grid: for each case a mesh Trainer
    (fp32 master shards, bf16 working copy) of ``tp_cfg(case)`` takes
    TP_STEPS steps on the global batches over gloo; for DINO first one
    forward of 2 views at 392x518.  Records, launch counts and (rank 0)
    the gathered whole master land in ``out_dir``."""
    import torch.distributed as dist

    from fast3r_torch.train.trainer import Trainer, TrainerConfig

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    out = {}
    for case in ("llama", "dino", "drop"):
        cfg = tp_cfg(case)
        t = time.perf_counter()
        trainer = Trainer(cfg, TP_OPT, trainer_cfg=TrainerConfig(
            run_dir=os.path.join(out_dir, f"run_{case}"), loggers=(),
            use_mesh=True, model_axis=TP_MODEL), device="cuda")
        rec = {"init_s": time.perf_counter() - t}
        mesh, net = trainer.mesh, trainer.state.net
        if case == "llama":
            blk = dict(net.decoder.layers[0].named_parameters())
            rec["shapes"] = {k: list(blk[k].shape) for k in TP_LLAMA_SHAPES}
        if case == "dino":
            _reset_counts()
            with torch.inference_mode():
                preds = fast3r_forward(net, cfg, _tp_big_imgs(), mesh=mesh)
            rec["fwd_counts"] = _read_counts()
            if rank == 0:
                torch.save({k: v.float().cpu() for k, v in preds.items()},
                           os.path.join(out_dir, "dino_fwd.pt"))
            del preds
        coll = [0.0]
        run = mesh._run

        def timed(group, size, op, *ts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(group, size, op, *ts)
            torch.cuda.synchronize()
            coll[0] += time.perf_counter() - t0

        mesh._run = timed
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        rec["steps"] = []
        for i, batch in enumerate(_tp_batches(case)):
            coll[0] = 0.0
            t = time.perf_counter()
            trainer.state, m = train_step(trainer.state, batch, cfg, TP_OPT,
                                          remat=True)
            torch.cuda.synchronize()
            rec["steps"].append({
                "train_step": i + 1, "step_s": time.perf_counter() - t,
                "collective_s": coll[0], "loss": float(m["loss"]),
                "skipped_nonfinite": int(m["skipped_nonfinite"]),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        rec["counts"] = _read_counts()
        mesh._run = run
        master = trainer.params_state_dict()
        if rank == 0:
            torch.save(master, os.path.join(out_dir, f"master_{case}.pt"))
        out[case] = rec
        del trainer, net, master
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def check_tp_variant_kernels(results: list) -> None:
    """The kernels of phase 28's steps at a model-2 rank's shapes against
    their plain versions: llama_dec's (M = 3072 rows, K = 1024, bf16 scale
    and weights): ``rms_qkv3`` at N 1536, ``rms_matmul`` with SiLU (w1) and
    without (w3) at N 1408 (5 x 256 + 128: the last 128 x 256 tile half
    full), the RMS replay on the three, ``matmul_residual``'s partial
    products on wo (K 512) and w2 (K 1408), the decoder's attention
    forward and backward at (1, 3072, 8, 64); the
    DINO encoder's at 8 heads of strided q, k, v over 257 tokens (4 views
    at 224x224, forward and backward) and 1037 (2 views at 392x518)."""
    g = _gen(28)
    bf, it, eps = torch.bfloat16, 2, 1e-5
    M, Cq, Hh = TP_M, C // 2, L_HID // 2
    x = (torch.randn((M, C), generator=g, device="cuda") * 2 + 0.5).to(bf)
    gamma = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    wq, wk, wv = (_linear(Cq, C, g)[0] for _ in range(3))
    w1, w3 = (_linear(Hh, C, g)[0] for _ in range(2))
    wo, w2 = _linear(C, Cq, g)[0], _linear(C, Hh, g)[0]
    tp = "model 2 llama rank"

    def rms():
        return F.rms_norm(x, (C,), gamma, eps)

    def io_bytes(n, replay=False, z=False):
        """x, w and gamma read, y written; the replay's u, rstd and z."""
        return ((M * C + n * C + C + M * n) * it
                + ((M * C * it + M * 4) if replay else 0)
                + (M * n * it if z else 0))

    args = (x, gamma, wq, wk, wv, eps)
    wcat = torch.cat([wq, wk, wv])
    _record(results, "rms_qkv3", "fused_gemm", f"{tp} qkv N=1536 {M}x{C}",
            torch.cat(fb.rms_qkv3(*args), 1), torch.cat(fb.rms_qkv3_ref(*args), 1),
            lambda: fb.rms_qkv3(*args), lambda: fb.rms_qkv3_ref(*args),
            lambda: F.linear(rms(), wcat).split(Cq, 1), "F.rms_norm + F.linear",
            2.0 * M * C * 3 * Cq, io_bytes(3 * Cq))
    for case, w, act in (("w1 silu", w1, "silu"), ("w3", w3, None)):
        args = (x, gamma, w, eps)
        _record(results, "rms_matmul", "fused_gemm",
                f"{tp} {case} N={Hh} {M}x{C}",
                fb.rms_matmul(*args, act=act), fb.rms_matmul_ref(*args, act=act),
                lambda: fb.rms_matmul(*args, act=act),
                lambda: fb.rms_matmul_ref(*args, act=act),
                (lambda: F.silu(F.linear(rms(), w))) if act
                else (lambda: F.linear(rms(), w)),
                "F.rms_norm + F.linear" + (" + F.silu" if act else ""),
                2.0 * M * C * Hh, io_bytes(Hh))
    for case, w, act in (("qkv", wcat, None), ("w1 silu", w1, "silu"),
                         ("w3", w3, None)):
        n = w.shape[0]
        args = (x, gamma, w, eps, act)
        got = fb.rms_matmul_replay(*args)
        ref = fb.rms_matmul_replay_ref(*args)
        torch.cuda.synchronize()
        errs = [compare("fused_gemm", got[0], ref[0], bf),
                compare("replay_u", got[1], ref[1], bf),
                compare("replay_stats", got[2], ref[2], bf)]
        if act:
            errs.append(compare("fused_gemm", got[3], ref[3], bf))
        lib = ((lambda: F.silu(F.linear(rms(), w))) if act
               else (lambda: F.linear(rms(), w)))
        r = dict(errs[0], kernel="rms_matmul_replay",
                 case=f"{tp} {case} N={n} {M}x{C}", dtype="bfloat16",
                 max_abs_err_residuals=max(e["max_abs_err"] for e in errs[1:]),
                 ms=median_ms(lambda: fb.rms_matmul_replay(*args), 10),
                 plain_ms=median_ms(lambda: fb.rms_matmul_replay_ref(*args), 3),
                 library="F.rms_norm + F.linear" + (" + F.silu" if act else ""),
                 library_ms=median_ms(lib, 10),
                 **bound(2.0 * M * C * n, io_bytes(n, True, bool(act))))
        results.append(r)
        log(json.dumps(r))
        del got, ref
    zero = torch.zeros((C,), device="cuda", dtype=bf)
    o = (torch.randn((M, Cq), generator=g, device="cuda") * 0.5).to(bf)
    h = fb.rms_matmul(x, gamma, w1, eps, act="silu") * fb.rms_matmul(
        x, gamma, w3, eps)
    # each rank's partial product (no bias in a llama linear; the residual
    # is added after the ranks' sum)
    for name, a, w, k in (("wo", o, wo, Cq), ("w2", h, w2, Hh)):
        args = (a, w, zero, None)
        _record(results, "matmul_residual", "fused_gemm",
                f"{tp} {name} K={k} partial {M}x{k} -> {C}",
                fb.matmul_residual(*args), fb.matmul_residual_ref(*args),
                lambda: fb.matmul_residual(*args),
                lambda: fb.matmul_residual_ref(*args),
                lambda: F.linear(a, w), "F.linear", 2.0 * M * k * C,
                (M * k + C * k + C + M * C) * it)
    del o, h
    torch.cuda.empty_cache()

    D = 64
    for prefix, (B, N), bwd in ((f"{tp} decoder", (1, M), True),
                                ("model 2 dino rank encoder", (TP_VIEWS, 257),
                                 True),
                                ("model 2 dino rank 392x518 encoder",
                                 (TP_DINO_BIG[0], 1037), False)):
        Hl = 8
        qkv = torch.randn((B, N, 3, Hl, D), generator=g, device="cuda").to(bf)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        case = f"{prefix} {B}x{N}x{Hl}x{D}"
        _record(results, "attention", "attention", case,
                flash_attention(q, k, v, TRAIN_SCALE),
                attention_ref(q, k, v, TRAIN_SCALE),
                lambda: flash_attention(q, k, v, TRAIN_SCALE),
                lambda: attention_ref(q, k, v, TRAIN_SCALE),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       scale=TRAIN_SCALE),
                "F.scaled_dot_product_attention", 4.0 * B * Hl * N * N * D,
                4 * B * N * Hl * D * it)
        if bwd:
            do = torch.randn((B, N, Hl, D), generator=g, device="cuda").to(bf)
            o, lse = attention_fwd_lse(q, k, v, TRAIN_SCALE)
            got = attention_bwd(q, k, v, o, lse, do, TRAIN_SCALE)
            ref = attention_bwd_ref(q, k, v, o, lse, do, TRAIN_SCALE)
            errs = [compare("attention_bwd", a, e, bf) for a, e in zip(got, ref)]
            del ref
            ql, kl, vl = (t.detach().transpose(1, 2).contiguous()
                          .requires_grad_() for t in (q, k, v))
            ol = F.scaled_dot_product_attention(ql, kl, vl, scale=TRAIN_SCALE)
            r = dict(_merge(errs), kernel="attention_bwd", case=case,
                     dtype="bfloat16",
                     ms=median_ms(lambda: attention_bwd(q, k, v, o, lse, do,
                                                        TRAIN_SCALE), 10),
                     plain_ms=median_ms(lambda: attention_bwd_ref(
                         q, k, v, o, lse, do, TRAIN_SCALE), 2),
                     library="autograd of F.scaled_dot_product_attention",
                     library_ms=_grad_ms(ol, (ql, kl, vl), do.transpose(1, 2),
                                         10),
                     **_attn_bwd_bound(B, N, Hl, D))
            results.append(r)
            log(json.dumps(r))
            del do, o, lse, got, ql, kl, vl, ol
        del qkv, q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def _tp_one_process(case: str, cfg, net, gpu: str):
    """The one-process Trainer road of a phase-28 case from the whole fp32
    params ``net`` (CPU): (losses, launch counts, master after, the rounding
    floor's master after: the same steps on a road that differs in rounding
    only), and for DINO the 392x518 forward's outputs and launch counts."""
    from fast3r_torch.train.trainer import Trainer, TrainerConfig

    def trainer(c):
        p = empty_fast3r(c, device="cuda")
        p.load_state_dict(net.state_dict())
        return Trainer(c, TP_OPT, trainer_cfg=TrainerConfig(
            run_dir=tempfile.mkdtemp(), loggers=()), params=p, device="cuda")

    out = {}
    one = trainer(cfg)
    if case == "dino":
        _reset_counts()
        with torch.inference_mode():
            preds = fast3r_forward(one.state.net, cfg, _tp_big_imgs())
        out["fwd_counts"] = _read_counts()
        out["fwd"] = {k: v.float().cpu() for k, v in preds.items()}
        del preds
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses = []
    for i, batch in enumerate(_tp_batches(case)):
        t = time.perf_counter()
        one.state, m = train_step(one.state, batch, cfg, TP_OPT, remat=True)
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
        log(json.dumps({"path": f"tp_{case}_ref", "train_step": i + 1,
                        "step_s": time.perf_counter() - t,
                        "loss": losses[-1], "peak_mem_gb":
                        torch.cuda.max_memory_allocated() / 1e9, "gpu": gpu}))
    out.update(losses=losses, counts=_read_counts(), after={
        k: v.detach().cpu() for k, v in one.state.params.named_parameters()})
    del one
    torch.cuda.empty_cache()
    # the rounding floor: the plain roads.  llama_dec on its plain block
    # roads; DINO on them and its encoder's attention on the plain version
    # (the encoder has one block road, which with_fused_blocks leaves as
    # it is); the dropout step with its decoder on the plain road too (its
    # encoder is there already)
    if case == "drop":
        floor_cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, fused_blocks=False))
    else:
        floor_cfg = cfg.with_fused_blocks(False)
    if case == "dino":
        floor_cfg = dataclasses.replace(floor_cfg, encoder=dataclasses.replace(
            floor_cfg.encoder, attn_impl="naive"))
    one = trainer(floor_cfg)
    out["floor_losses"] = []
    for batch in _tp_batches(case):
        one.state, m = train_step(one.state, batch, floor_cfg, TP_OPT,
                                  remat=True)
        out["floor_losses"].append(float(m["loss"]))
    out["floor_after"] = {k: v.detach().cpu() for k, v in
                          one.state.params.named_parameters()}
    del one
    torch.cuda.empty_cache()
    return out


def phase_tp_variants(gpu: str, results: list) -> dict:
    """Phase 28: the kernels at a model-2 rank's llama_dec and DINO shapes
    against their plain versions; for llama_dec, the DINOv2 model and the
    flagship with the encoder's drop_path 0.1, the one-process Trainer
    road's TP_STEPS steps (and a road differing in rounding only) on the
    global batches, then the same steps on a data 1 x model 2 grid of two
    processes sharing the card over gloo, held together; for DINO also a
    392x518 forward on both.  Returns the launch counts of each rank's
    paths ("tp_{case}_rank{r}", "tp_dino_fwd_rank{r}") and of the
    one-process roads."""
    import torch.multiprocessing as mp

    log(f"== phase 28: the variants tensor-parallel (llama_dec, DINOv2, "
        f"dropout, {MESH_DEPTH} blocks a stack; data 1 x model {TP_MODEL} "
        f"ranks on one card over gloo, "
        f"{TP_VIEWS} views a step, fp32 master shards, bf16 working copy, "
        f"{TP_STEPS} steps)")
    t0 = time.perf_counter()
    check_tp_variant_kernels(results)
    log(f"the model-2 rank shapes' kernels checked in "
        f"{time.perf_counter() - t0:.1f} s")
    from fast3r_torch.train.trainer import TrainerConfig

    counts, refs = {}, {}
    for case in ("llama", "dino", "drop"):
        t0 = time.perf_counter()
        cfg = tp_cfg(case)
        # the mesh Trainer's whole params: its seed's draw on the CPU
        net = init_fast3r(cfg, seed=TrainerConfig().seed, device="cpu")
        refs[case] = _tp_one_process(case, cfg, net, gpu)
        refs[case]["before"] = {k: v.detach() for k, v in
                                net.named_parameters()}
        counts[f"tp_{case}_ref"] = refs[case]["counts"]
        del net
        log(f"the one-process roads of {case} in "
            f"{time.perf_counter() - t0:.1f} s")

    world = TP_MODEL
    bad = []
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        mp.spawn(_tp_worker, args=(world, _free_port(), out), nprocs=world)
        log(f"the {world} ranks in {time.perf_counter() - t0:.1f} s")
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for case, ref in refs.items():
            after = torch.load(os.path.join(out, f"master_{case}.pt"),
                               mmap=True)
            err = _group_update_err(ref["before"], after, ref["after"])
            floor = _group_update_err(ref["before"], ref["floor_after"],
                                      ref["after"])
            tol = {g: max(MESH_UPDATE_RTOL, MESH_FLOOR_X * f)
                   for g, f in floor.items()}
            log(json.dumps({"path": f"tp_{case}", "update_rel_l2_by_group": err,
                            "rounding_floor_by_group": floor,
                            "tolerance": tol, "losses_ref": ref["losses"],
                            "losses_floor_road": ref["floor_losses"]}))
            bad += [f"{case}: {g} update rel L2 {e:.4f} > {tol[g]:.4f}"
                    for g, e in err.items() if not e <= tol[g]]
            del after
            if case == "dino":
                got = torch.load(os.path.join(out, "dino_fwd.pt"))
                rel = _rel_l2(got, ref["fwd"])
                log(json.dumps({"path": "tp_dino_fwd", "views": TP_DINO_BIG,
                                "rel_l2": rel, "tolerance": TP_FWD_RTOL}))
                bad += [f"dino 392x518 forward {k} rel L2 {v:.4f}"
                        for k, v in rel.items() if not v <= TP_FWD_RTOL]
    for r, rk in enumerate(ranks):
        for case, rec in rk.items():
            ref = refs[case]
            log(json.dumps({"path": f"tp_{case}", "rank": r,
                            "init_s": rec["init_s"], "steps": rec["steps"],
                            "gpu": gpu}))
            counts[f"tp_{case}_rank{r}"] = rec["counts"]
            if rec["counts"] != ref["counts"]:
                bad.append(f"{case} rank {r} launches {rec['counts']} != the "
                           f"one-process road's {ref['counts']}")
            for s, want in zip(rec["steps"], ref["losses"]):
                if (s["skipped_nonfinite"] or not math.isfinite(s["loss"])
                        or abs(s["loss"] - want) > TP_LOSS_RTOL * abs(want)):
                    bad.append(f"{case} rank {r} step {s['train_step']} loss "
                               f"{s['loss']} vs {want}")
            if case == "llama" and rec["shapes"] != TP_LLAMA_SHAPES:
                bad.append(f"llama rank {r} layer shapes {rec['shapes']}")
            if case == "dino":
                counts[f"tp_dino_fwd_rank{r}"] = rec["fwd_counts"]
                if rec["fwd_counts"] != ref["fwd_counts"]:
                    bad.append(f"dino forward rank {r} launches "
                               f"{rec['fwd_counts']} != {ref['fwd_counts']}")
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase 28: {bad}")
    return counts


# ---------------------------------------------------------------------------
# phase 30: the interactive demo
# ---------------------------------------------------------------------------

DEMO_VIEWS = 20


def _fake_ui():
    """tests/torch_fake_ui.py: the fake gradio and viser modules (neither
    machine has the real ones) and a trivial server process target."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))  # the caller restores sys.path
    import torch_fake_ui

    return torch_fake_ui


def _drive_viser(server, n: int) -> dict:
    """The Viser server's control panel, as a browser drives it: the
    timestep, next / previous, head and camera toggles, the percentile
    slider, the colour modes and sizes, and the GIF and PLY exports (of the
    first two frames); returns what each step showed."""
    gui, fd = server.gui, server._fast3r["frame_data"]

    def shown(head):
        return sum(f[f"point_node_{head}"].visible for f in fd)

    seen = {"start_local": shown("local")}
    gui.slider("Timestep").set(0)
    seen["timestep_0_local"] = shown("local")
    gui.button("Next Frame").click()
    seen["next_local"] = shown("local")
    gui.button("Prev Frame").click()
    gui.slider("Timestep").set(n - 1)
    gui.checkbox("Global").set(True)
    gui.checkbox("Local").set(False)
    seen["heads_global"] = shown("global")
    gui.checkbox("Show Cameras").set(False)
    seen["cameras"] = sum(f["frustum_node"].visible for f in fd)
    gui.checkbox("Show Cameras").set(True)
    points = sum(len(h.points) for h in server.scene.point_clouds)
    gui.slider("Per-View Conf Percentile").set(80.0)
    seen["points_at_10_80"] = [
        points, sum(len(h.points) for h in server.scene.point_clouds)]
    gui.checkbox("Color by View").set(True)
    gui.checkbox("Color by View").set(False)
    gui.checkbox("Show Confidence").set(True)
    gui.slider("Point Size").set(0.001)
    gui.slider("Camera Size (%)").set(5.0)
    gui.slider("Timestep").set(1)  # the exports of the first two frames
    t = time.perf_counter()
    gif = gui.button("Render a GIF").click()
    seen["gif_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ply = gui.button("Download PLY").click()
    seen["ply_s"] = time.perf_counter() - t
    seen["gif_bytes"] = os.path.getsize(gif)
    seen["ply_points"] = int(_read_ply_header(ply)[0][2].split()[-1])
    want = {"start_local": n, "timestep_0_local": 1, "next_local": 2,
            "heads_global": n, "cameras": 0}
    bad = {k: (seen[k], v) for k, v in want.items() if seen[k] != v}
    if bad or not seen["points_at_10_80"][1] < seen["points_at_10_80"][0] \
            or seen["gif_bytes"] <= 0 or seen["ply_points"] <= 0:
        raise AssertionError(f"phase 30, the Viser server's controls: {seen}")
    return seen


def phase_demo(gpu: str, model) -> dict:
    """``model``: phase 3's flagship in bf16 on the card."""
    import shutil

    from fast3r_torch.serve import demo as demo_mod
    from fast3r_torch.serve.viser_server import run_viser_server

    log(f"== phase 30: the interactive demo (fast3r_torch.serve.demo and "
        f"viser_server on the fake gradio and viser of tests/torch_fake_ui.py; "
        f"phase 3's flagship, bfloat16): a reconstruct click on "
        f"{DEMO_VIEWS} seeded 512x384 JPEGs, the Viser server in this "
        f"process on its output, the session manager on real spawned "
        f"processes, video input through ffmpeg")
    sys_path = list(sys.path)
    ui = _fake_ui()
    saved = {k: sys.modules.get(k) for k in ui.fake_modules()}
    saved["__main__"] = sys.modules["__main__"]
    sys.modules.update(ui.fake_modules())
    # the sessions' spawned processes import the main module: the fake UI's,
    # not this script (and all it imports)
    sys.modules["__main__"] = ui
    tmp = tempfile.mkdtemp(prefix="fast3r_demo_")
    demo = None
    try:
        paths = []
        for i in range(DEMO_VIEWS):
            paths.append(os.path.join(tmp, f"frame_{i:02d}.jpg"))
            PIL.Image.fromarray(_photo(384, 512, 300 + i)).save(paths[-1],
                                                                quality=95)
        demo = demo_mod.create_demo(model)
        manager = demo._fast3r["manager"]
        manager._target = ui.sleepy_server  # each session's server process
        started = []
        start = manager.start_server

        def start_server(session, *args, **kw):
            started.append((session, args, kw))
            return start(session, *args, **kw)

        manager.start_server = start_server
        process, up, down, send, end = (c[0] for c in demo.clicks)
        files = [type("Upload", (), {"name": p})() for p in paths]
        if demo.changes[0][0](files) != paths:
            raise AssertionError("phase 30: the gallery preview")
        _reset_counts()
        t = time.perf_counter()
        ply, status = process(files, None, 10.0, resolution="512")
        click_s = time.perf_counter() - t
        counts = {"demo": _read_counts()}
        header = _read_ply_header(ply)[0]
        n_points = int(header[2].split()[-1])
        rec = {"path": "demo", "click_s": click_s, "views": DEMO_VIEWS,
               "ply_points": n_points, "status": status.splitlines(),
               "gpu": gpu}
        log(json.dumps(rec))
        stages = ("encode_images", "decoder", "head_forward")
        if (f"{DEMO_VIEWS} views" not in status or "512px" not in status
                or not all(f"  {s}: " in status for s in stages)
                or "viser on port" not in status or n_points <= 0
                or len(started) != 1 or started[0][2] != {"device": "cuda"}):
            raise AssertionError(f"phase 30, the reconstruct click: {rec}")

        # the session's Viser server, in this process on the click's output
        output = started[0][1][0]
        t = time.perf_counter()
        server = run_viser_server(output, port=8042, blocking=False,
                                  device="cuda")
        server_s = time.perf_counter() - t
        clouds, frustums = server.scene.point_clouds, server.scene.frustums
        if (len(clouds) != 2 * DEMO_VIEWS or len(frustums) != DEMO_VIEWS
                or not all(np.isfinite(f.wxyz).all()
                           and np.isfinite(f.position).all()
                           for f in frustums)):
            raise AssertionError(f"phase 30: {len(clouds)} clouds, "
                                 f"{len(frustums)} frustums")
        seen = _drive_viser(server, DEMO_VIEWS)
        server._fast3r["stop"].set()
        log(json.dumps({"path": "demo_viser", "server_s": server_s,
                        "clouds": len(clouds), "frustums": len(frustums),
                        **seen}))

        # the session manager: the click's process, one more collected by
        # the GC, the feedback and the session's end
        proc = manager._sessions["default"]["proc"]
        alive = proc.is_alive()
        manager.start_server("second")
        collected = manager.gc(max_age_s=0.0)
        fb_msgs = [send("smoke"), up(), down()]
        released = end()
        rec = {"path": "demo_manager", "click_process_alive": alive,
               "collected": collected, "sessions_left": len(manager),
               "click_process_alive_after": proc.is_alive(),
               "feedback": fb_msgs, "end_session": released}
        log(json.dumps(rec))
        if (not alive or collected != 2 or len(manager) != 0
                or proc.is_alive() or not all("saved" in m for m in fb_msgs)):
            raise AssertionError(f"phase 30, the session manager: {rec}")

        # video input: the frames as an mp4 through ffmpeg, then a click
        if shutil.which("ffmpeg") is None:
            log("ffmpeg absent: video input not driven")
        else:
            video = os.path.join(tmp, "clip.mp4")
            subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-framerate",
                            "2", "-i", os.path.join(tmp, "frame_%02d.jpg"),
                            "-c:v", "mpeg4", "-q:v", "2", video], check=True)
            t = time.perf_counter()
            _, vstatus = process(None, video, 10.0, resolution="512")
            rec = {"path": "demo_video", "click_s": time.perf_counter() - t,
                   "status": vstatus.splitlines()}
            log(json.dumps(rec))
            if " views in " not in vstatus or "viser on port" not in vstatus:
                raise AssertionError(f"phase 30, video input: {rec}")
        manager.shutdown()
        return counts
    finally:
        if demo is not None:
            demo._fast3r["gc_timer"].cancel()
            if demo._fast3r["manager"] is not None:
                demo._fast3r["manager"].shutdown()
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        sys.path[:] = sys_path
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 31: 1000 views in one forward
# ---------------------------------------------------------------------------

MANY_VIEWS = 1000
MANY_HW = (192, 256)    # scripts/bench_1000view.py's default: S = 192,000
MANY_CHUNK = 25         # head_chunk_views (the reference's heads a chunk)
MANY_CASE = f"1000 views M={MANY_VIEW_TOKENS}"


def _many_view_forward(fn, path: str, gpu: str) -> tuple:
    """One 1000-view forward ``fn()`` with the launch counts set to 0 just
    before and read just after: (outputs on the card, counts)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = _read_counts()
    V, (H, W) = MANY_VIEWS, MANY_HW
    for k, v in out.items():
        want = (1, V, H, W, 3) if k.startswith("pts3d") else (1, V, H, W)
        if tuple(v.shape) != want:
            raise AssertionError(f"{path} {k}: shape {tuple(v.shape)}")
        if not torch.isfinite(v).all():
            raise AssertionError(f"{path} {k}: not finite")
    for k in ("conf", "conf_local"):
        if not (out[k] >= 1).all():
            raise AssertionError(f"{path} {k}: below 1")
    log(json.dumps({"path": path, "views": V, "image_hw": [H, W],
                    "tokens": V * (H // 16) * (W // 16),
                    "head_chunk_views": MANY_CHUNK, "wall_s": wall,
                    "images_per_s": V / wall, "gpu": gpu,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": {k: c for k, c in counts.items() if c}}))
    return out, counts


def check_many_view_kernels(results: list) -> None:
    """K3 / K4, K3 (q | k | v, fc1 GELU), K5 (proj, fc2), K6 and K7 at M =
    768,000 rows (1000 views of 512x384), C = 1024, hidden 4096, and K2 on
    the encoder's (3, 1000, 768, 1024) buffer, each whole launch against its
    plain version on the rows of ``kernels.rows.check_rows`` (the first and
    last 1024 of each output and packed plane, past 2^31 elements in the
    packed qkv and fc1's output, and 2048 seeded rows between; K2: 16
    views), the plain version timed on those rows; K8 on one head chunk of
    25 views of 512x384 (the trunk's (25, 192, 256, 256) input) whole; K1
    at S = 768,000 (16 heads of 64) and K14's forward on the same q, k, v
    over 4 ranks (S_loc = 192,000) on 256 query rows a head against the
    plain attention of those rows over all keys, o and lse, one launch of
    each timed."""
    g = _gen(31)
    bf, it = torch.bfloat16, 2
    M = MANY_VIEW_TOKENS
    rows = check_rows(M, seed=31, device="cuda")
    on_rows = dict(reps=3, plain_on="the check rows")

    def big(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=bf).mul_(scale).add_(shift)

    x = big((M, C), 2.0, 0.5)
    gamma = (1 + 0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    beta = (0.1 * torch.randn((C,), generator=g, device="cuda")).to(bf)
    xr = x[rows]

    def ln_linear(w, b, eps):
        return F.linear(F.layer_norm(x, (C,), gamma, beta, eps), w, b)

    wqkv, bqkv = _linear(3 * C, C, g)
    yy, xx = torch.meshgrid(torch.arange(24), torch.arange(32), indexing="ij")
    pos = torch.stack([yy, xx], -1).reshape(1, -1, 2).repeat(
        MANY_VIEWS, 1, 1).cuda()
    ct, st = expand_rope_tables(*rope2d_cos_sin(pos, 64), C, bf)
    qkv_flops = 2.0 * M * C * 3 * C
    qkv_w_bytes = (3 * C * C + 3 * C + 2 * C) * it
    args = (x, gamma, beta, wqkv, bqkv, ct, st, 16, 1e-6)
    rargs = (xr, gamma, beta, wqkv, bqkv, ct[rows], st[rows], 16, 1e-6)
    _record(results, "ln_qkv_rope", "fused_gemm", f"{MANY_CASE} x{C} -> 3x{C}",
            fb.ln_qkv_rope(*args)[:, rows], fb.ln_qkv_rope_ref(*rargs),
            lambda: fb.ln_qkv_rope(*args), lambda: fb.ln_qkv_rope_ref(*rargs),
            lambda: ln_linear(wqkv, bqkv, 1e-6),
            "F.layer_norm + F.linear (without the RoPE)", qkv_flops,
            qkv_w_bytes + (M * C * 3 + 3 * M * C) * it, **on_rows)
    del args, ct, st, pos
    args, rargs = (x, gamma, beta, wqkv, bqkv, 1e-5), (xr, gamma, beta, wqkv,
                                                      bqkv, 1e-5)
    _record(results, "ln_qkv", "fused_gemm", f"{MANY_CASE} x{C} -> 3x{C}",
            torch.stack(fb.ln_qkv(*args))[:, rows],
            torch.stack(fb.ln_qkv_ref(*rargs)), lambda: fb.ln_qkv(*args),
            lambda: fb.ln_qkv_ref(*rargs),
            lambda: ln_linear(wqkv, bqkv, 1e-5), "F.layer_norm + F.linear",
            qkv_flops, qkv_w_bytes + (M * C + 3 * M * C) * it, **on_rows)
    w1, b1 = _linear(HID, C, g)
    args, rargs = (x, gamma, beta, w1, b1, 1e-6), (xr, gamma, beta, w1, b1,
                                                  1e-6)
    _record(results, "ln_matmul", "fused_gemm",
            f"{MANY_CASE} x{C} -> {HID} gelu",
            fb.ln_matmul(*args, act="gelu")[rows],
            fb.ln_matmul_ref(*rargs, act="gelu"),
            lambda: fb.ln_matmul(*args, act="gelu"),
            lambda: fb.ln_matmul_ref(*rargs, act="gelu"),
            lambda: F.gelu(ln_linear(w1, b1, 1e-6)),
            "F.layer_norm + F.linear + F.gelu", 2.0 * M * C * HID,
            (M * C + HID * C + HID + 2 * C + M * HID) * it, **on_rows)
    w2, b2 = _linear(C, HID, g)
    for name, k_in in (("proj", C), ("fc2", HID)):
        w, b = (w2, b2) if name == "fc2" else _linear(C, C, g)
        h = big((M, k_in), 0.5)
        hr = h[rows]
        _record(results, "matmul_residual", "fused_gemm",
                f"{MANY_CASE} {name} x{k_in} -> {C}",
                fb.matmul_residual(h, w, b, x)[rows],
                fb.matmul_residual_ref(hr, w, b, xr),
                lambda: fb.matmul_residual(h, w, b, x),
                lambda: fb.matmul_residual_ref(hr, w, b, xr),
                lambda: F.linear(h, w, b) + x, "F.linear + add",
                2.0 * M * k_in * C, (M * k_in + 2 * M * C + k_in * C + C) * it,
                **on_rows)
        del h
    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
    _record(results, "ln_mlp", "ln_mlp", f"{MANY_CASE} x{C}, hidden {HID}",
            fb.ln_mlp(*args)[rows], fb.ln_mlp_ref(xr, *args[1:]),
            lambda: fb.ln_mlp(*args), lambda: fb.ln_mlp_ref(xr, *args[1:]),
            lambda: x + F.linear(F.gelu(ln_linear(w1, b1, 1e-6)), w2, b2),
            "F.layer_norm + F.linear + F.gelu + F.linear + add",
            4.0 * M * C * HID, (2 * M * C + 2 * HID * C + HID + 3 * C) * it,
            **on_rows)
    _record(results, "layernorm", "layernorm", f"{MANY_CASE} x{C} eps=1e-05",
            fused_layernorm(x, gamma, beta, 1e-5)[rows],
            layernorm_ref(xr, gamma, beta, 1e-5),
            lambda: fused_layernorm(x, gamma, beta, 1e-5),
            lambda: layernorm_ref(xr, gamma, beta, 1e-5),
            lambda: F.layer_norm(x, (C,), gamma, beta, 1e-5), "F.layer_norm",
            8.0 * M * C, (2 * M * C + 2 * C) * it, **on_rows)
    del args, x, xr
    torch.cuda.empty_cache()

    # K2: the encoder's attention on the packed buffer of 1000 views
    B, N, H, D = MANY_VIEWS, 768, 16, 64
    qkv3 = big((3, B, N, C))
    qkv3[0].mul_(2.0)  # scores of std 2: each row rests on tens of keys
    views = check_rows(B, seed=31, edge=4, between=8, device="cuda")
    q, k, v = (qkv3[i][views].view(-1, N, H, D) for i in range(3))
    qt, kt, vt = (t.view(B, N, H, D).transpose(1, 2) for t in qkv3)
    _record(results, "packed_qkv_attention", "attention",
            f"{MANY_CASE} (3, {B}, {N}, {C}), {H} heads",
            packed_qkv_attention(qkv3, H, 0.125)[views],
            attention_ref(q, k, v, 0.125).reshape(-1, N, C),
            lambda: packed_qkv_attention(qkv3, H, 0.125),
            lambda: attention_ref(q, k, v, 0.125),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=0.125),
            "F.scaled_dot_product_attention", 4.0 * B * H * N * N * D,
            4 * B * N * C * it, reps=3, plain_on="16 views")
    del qkv3, q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # K8: the heads' trunk on one 25-view chunk of 512x384
    n, hh, wc, cin, Ht, Wt = MANY_CHUNK, 192, 256, 256, 384, 512
    xt, wts = _trunk_inputs(n, hh, wc, cin, bf)
    targs = (*wts, Ht, Wt)
    xc = xt.permute(0, 3, 1, 2)
    _record(results, "trunk", "trunk",
            f"{MANY_CASE} head chunk {n}x{hh}x{wc}x{cin} -> {Ht}x{Wt}",
            fused_regression_head_t(xt, *targs),
            _plain_head(xc, *targs).reshape(n, 4, Ht * Wt),
            lambda: fused_regression_head_t(xt, *targs),
            lambda: _plain_head(xc, *targs), lambda: _trunk_library(xc, *targs),
            TRUNK_LIBRARY, _trunk_flops(n, hh, wc, cin, Ht, Wt),
            (xt.numel() + n * 4 * Ht * Wt) * it, reps=5,
            plain_on="the whole chunk")
    del xt, xc
    torch.cuda.empty_cache()

    # K1: the decoder's attention over all 768,000 tokens, and K14's forward
    # on the same q, k, v over 4 ranks; one launch of each
    S = MANY_VIEW_TOKENS
    q = big((1, S, H, D), 3.0 / (D ** 0.5 * DEC_SCALE))  # scores of std 3
    k, v = big((1, S, H, D)), big((1, S, H, D))
    qrows = query_rows(S, H, seed=31, device="cuda")
    heads = torch.arange(H, device="cuda")[:, None]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def once(fn) -> tuple:
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    t0 = time.perf_counter()
    ref_o, ref_lse = attention_rows_lse_ref(q, k, v, DEC_SCALE, qrows)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = once(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=DEC_SCALE))[1]
    del qt, kt, vt
    flops = 4.0 * H * S * S * D
    n = SEQ_RANKS
    for kernel, kind, fn, case, extra in (
            ("attention", "attention",
             lambda: attention_fwd_lse(q, k, v, DEC_SCALE),
             f"decoder (1, {S}, {H}, {D})",
             bound(flops, 4 * S * H * D * it + H * S * 4)),
            ("ring_attention", "ring",
             lambda: _rdma_forward(*(t.view(n, 1, S // n, H, D)
                                     for t in (q, k, v)), DEC_SCALE, n),
             f"n={n} {n}x1x{S // n}x{H}x{D}",
             _ring_bound(n, n, S // n, bf))):
        (o, lse), ms = once(fn)
        # o (1, S, H, D) or (n, 1, S_loc, H, D); lse (1, H, S) or
        # (n, H, S_loc): each the gathered sequence's
        o = o.reshape(S, H, D)
        lse = lse.reshape(-1, H, lse.shape[-1]).permute(1, 0, 2).reshape(H, S)
        lse_err = compare("ring_lse", lse[heads, qrows], ref_lse[0], bf)
        r = compare(kind, o[qrows, heads], ref_o[0], bf)
        del o, lse
        r.update(kernel=kernel, case=f"{MANY_CASE} {case}", dtype="bfloat16",
                 ms=ms, plain_ms=plain_ms,
                 plain_on=f"{qrows.shape[1]} query rows a head",
                 library="F.scaled_dot_product_attention",
                 library_ms=library_ms,
                 lse_max_abs_err=lse_err["max_abs_err"],
                 lse_atol=lse_err["atol"], tflops=flops / ms / 1e9, **extra)
        results.append(r)
        log(json.dumps(r))
        torch.cuda.empty_cache()
    del q, k, v, ref_o, ref_lse
    torch.cuda.empty_cache()


def phase_many_view(gpu: str, model, results: list) -> dict:
    """The flagship at 1000 views of 256x192 in one forward, on the main
    road and sequence-sharded over 4 ranks; then the kernels at the
    512x384 shapes."""
    log(f"== phase 31: {MANY_VIEWS} views of {MANY_HW[1]}x{MANY_HW[0]} in "
        f"one forward (flagship, random weights seed 0, bfloat16, heads in "
        f"chunks of {MANY_CHUNK}; then the kernels at 512x384's M = "
        f"{MANY_VIEW_TOKENS})")
    cfg = model.cfg
    V, (H, W) = MANY_VIEWS, MANY_HW
    imgs = _seq_imgs(V, H, W, 31).to(device="cuda", dtype=torch.bfloat16)
    ids = sample_random_image_ids(None, 1, V)
    with torch.inference_mode():
        main, counts = _many_view_forward(lambda: fast3r_forward(
            model.params, cfg, imgs, head_chunk_views=MANY_CHUNK,
            view_ids=ids), "many_view", gpu)
    _expect("many_view", counts, attention=cfg.decoder.depth,
            packed_qkv_attention=cfg.encoder.depth, layernorm=2)
    main = {k: v.float().cpu() for k, v in main.items()}
    fwd = make_seq_sharded_forward(cfg, SEQ_RANKS, V, (H, W),
                                   head_chunk_views=MANY_CHUNK)
    seq, seq_counts = _many_view_forward(
        lambda: fwd(model.params, imgs, ids[0]), "many_view_seq", gpu)
    _expect("many_view_seq", seq_counts, ring_attention=cfg.decoder.depth,
            attention=0)
    errs = _rel_l2(seq, main)
    del seq, main
    log(json.dumps({"many_view_seq_vs_main_rel_l2": errs,
                    "tolerance": SEQ_REL_L2}))
    bad = {k: e for k, e in errs.items() if not e <= SEQ_REL_L2}
    if bad:
        raise AssertionError(f"1000-view sequence-sharded outputs off the "
                             f"main road's: {bad}")
    del imgs
    check_many_view_kernels(results)
    return {"many_view": counts, "many_view_seq": seq_counts}


def phase_counts(counts: dict) -> None:
    log("== phase 26: kernel launches on each path of phases 3, 5, 7, 9, 11, "
        "12, 14, 16, 18, 19, 20, 21, 22, 23, 24, 29, 30 and 31")
    log(json.dumps(counts))
    missing = [f"{path}: {k}" for path, names in PATHS.items()
               for k in names if counts[path][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    stray = [f"{path}: {k}" for path, names in NO_LAUNCH.items()
             for k in names if counts[path][k] != 0]
    if stray:
        raise AssertionError(f"kernels launched off their path: {stray}")
    copied = [path for path in SERVE_PATHS if counts[path]["layout_copies"]]
    if copied:
        raise AssertionError(f"layout copies on the serving paths: {copied}")


# the heaviest main-path shape of each kernel, for the summary line
MAIN_CASE = {"attention": "decoder", "layernorm": "eps=1e-05",
             "trunk": "20x192x256x256",
             "matmul_residual": "proj", "attention_bwd": "decoder",
             "ln_matmul_replay": "fc1", "rms_qkv3": f"qkv {M_TOK}",
             "rms_matmul": "w1", "rms_matmul_replay": "w1",
             "resize": "20x128x256x256", "ring_attention": "n=4 ",
             "ring_attention_bwd_dq": "n=4 ", "ring_attention_bwd_dkv": "n=4 "}


# the widened kernels' shapes (phase 25), each with the paths that run it
WIDE_CASES = (
    ("attention", "huge decoder", MS_PATHS["ms_huge"]),
    ("resize", "dino", ("dino", "dino_mixed")),
    ("trunk", "dino", ("dino_train",)),
    ("trunk", "model_scaling", sum(MS_PATHS.values(), ())),
    ("attention", "dino encoder", ("dino", "dino_mixed", "dino_train")),
    ("attention_bwd", "huge decoder", MS_PATHS["ms_huge"]),
    *((k, case, MS_PATHS["ms_base"]) for k, case in (
        ("ln_qkv", "K=768"), ("ln_matmul", "K=768"),
        ("ln_matmul_replay", "K=768"), ("matmul_residual", "K=768"),
        ("matmul_residual", "K=3072"), ("ln_mlp", "C=768"))),
    *((k, case, MS_PATHS["ms_huge"]) for k, case in (
        ("ln_qkv", "K=1280"), ("ln_matmul", "K=1280"),
        ("ln_matmul_replay", "K=1280"), ("matmul_residual", "K=1280"),
        ("matmul_residual", "K=5120"), ("ln_mlp", "C=1280"))),
    # K14 at head_dim 80 (phases 15 and 17), launched by phase 29
    ("ring_attention", "head_dim 80 n=4 ",
     ("ms_huge_seq", "ms_huge_seq_train")),
    ("ring_attention_bwd_dq", "head_dim 80 n=4 ", ("ms_huge_seq_train",)),
    ("ring_attention_bwd_dkv", "head_dim 80 n=4 ", ("ms_huge_seq_train",)),
)


def kernel_summary(results: list, counts: dict) -> dict:
    """One entry per kernel: launches summed over the paths of phases 3, 5,
    7, 9, 11, 12, 14, 16, 18, 19, 20, 21 and 22-24 (and per path); the largest bfloat16 error,
    and the bfloat16 times and bound at its heaviest main-path shape, from
    phase 2 (the ring kernel: phase 15, n = 4; its backward rings: phase
    17, n = 4)."""
    kernels = []
    for name, (_, route, source, replaces) in KERNELS.items():
        rows = [r for r in results
                if r["kernel"] == name and r["dtype"] == "bfloat16"]
        main = next(r for r in rows if MAIN_CASE.get(name, "") in r["case"])
        entry = {
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in counts.values()),
            "launches_by_path": {p: c[name] for p, c in counts.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "atol": main["atol"], "rtol": main["rtol"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library": main["library"],
            "case": main["case"] + " bfloat16"}
        for key in ("two_kernel_ms", "k1_ms", "k9_ms", "pair_ms",
                    "pair_bound_ms", "device_ms", "tflops", "exp_floor_ms",
                    "library_device_ms", "ms_one_cta_per_item",
                    "host_ms", "library_host_ms", "bound_share",
                    "k1_device_ms", "device_over_k1", "ms_over_k1"):
            if key in main:
                entry[key] = main[key]
        kernels.append(entry)
    for name, prefix, paths in WIDE_CASES:
        _, route, source, replaces = KERNELS[name]
        for r in results:
            if (r["kernel"] != name or r["dtype"] != "bfloat16"
                    or not r["case"].startswith(prefix)):
                continue
            by_path = {p: counts[p][name] for p in paths}
            kernels.append({
                "name": f"{name} [{r['case']}]", "route": route,
                "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": r["max_abs_err"], "atol": r["atol"],
                "rtol": r["rtol"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "library": r["library"],
                "case": r["case"] + " bfloat16",
                **{k: r[k] for k in ("device_ms", "tflops", "dq_ms", "dkv_ms",
                                     "two_kernel_ms", "k1_ms", "k9_ms",
                                     "k1_device_ms", "device_over_k1",
                                     "pair_ms", "pair_bound_ms") if k in r}})
    # the kernels at the 1000-view shapes (phase 31), their launches on the
    # 1000-view forward that runs them (at 256x192: M and S 192,000; the
    # ring's on the sequence-sharded one)
    for r in results:
        if r["dtype"] != "bfloat16" or not r["case"].startswith(MANY_CASE):
            continue
        _, route, source, replaces = KERNELS[r["kernel"]]
        path = ("many_view_seq" if r["kernel"] == "ring_attention"
                else "many_view")
        kernels.append({
            "name": f"{r['kernel']} [{r['case']}]", "route": route,
            "source": source, "replaces": replaces,
            "launches": counts[path][r["kernel"]],
            "launches_by_path": {p: counts[p][r["kernel"]]
                                 for p in ("many_view", "many_view_seq")},
            **{k: r[k] for k in ("max_abs_err", "atol", "rtol", "ms",
                                 "plain_ms", "plain_on", "bound_ms",
                                 "bound_by", "library_ms", "library")},
            "case": r["case"] + " bfloat16",
            **{k: r[k] for k in ("tflops", "lse_max_abs_err") if k in r}})
    # the mesh step's kernels at a model-2 rank's shapes (phase 27), their
    # launches over the phase's steps on the rank that runs the case: model
    # rank 1 (global rank 1) the partial products on a zero bias, model rank
    # 0 (global rank 0) the others
    for r in results:
        if r["dtype"] != "bfloat16" or not r["case"].startswith("model 2 rank"):
            continue
        _, route, source, replaces = KERNELS[r["kernel"]]
        rank = 1 if "(rank 1)" in r["case"] else 0
        kernels.append({
            "name": f"{r['kernel']} [{r['case']}]", "route": route,
            "source": source, "replaces": replaces,
            "launches": counts[f"mesh_rank{rank}"][r["kernel"]],
            "launches_by_path": {p: counts[p][r["kernel"]] for p in counts
                                 if p.startswith("mesh_rank")},
            "max_abs_err": r["max_abs_err"], "atol": r["atol"],
            "rtol": r["rtol"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library": r["library"],
            "case": r["case"] + " bfloat16"})
    # the variants' kernels at a model-2 rank's shapes (phase 28), their
    # launches over the phase's steps (the DINO 392x518 case: its forward)
    # on model rank 0 (rank 1 runs each as often)
    for r in results:
        if r["dtype"] != "bfloat16" or not r["case"].startswith(
                ("model 2 llama rank", "model 2 dino rank")):
            continue
        _, route, source, replaces = KERNELS[r["kernel"]]
        rank = 0
        path = ("tp_llama" if "llama" in r["case"] else
                "tp_dino_fwd" if "392x518" in r["case"] else "tp_dino")
        kernels.append({
            "name": f"{r['kernel']} [{r['case']}]", "route": route,
            "source": source, "replaces": replaces,
            "launches": counts[f"{path}_rank{rank}"][r["kernel"]],
            "launches_by_path": {f"{path}_rank{k}":
                                 counts[f"{path}_rank{k}"][r["kernel"]]
                                 for k in range(TP_MODEL)},
            "max_abs_err": r["max_abs_err"], "atol": r["atol"],
            "rtol": r["rtol"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "library": r["library"],
            "case": r["case"] + " bfloat16"})
    return {"kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        log(f"-- {phase} done at {time.perf_counter() - t0:.1f} s")

    gpu = phase_device()["gpu"]
    done("phase 1")
    results = phase_kernels()
    done("phase 2")
    cpu_model, model, plain, counts = phase_requests(gpu)
    done("phase 3")
    phase_end_to_end(cpu_model, model, plain)
    done("phase 4")
    counts.update(phase_demo(gpu, model))
    done("phase 30")
    counts.update(phase_many_view(gpu, model, results))
    del model, plain
    torch.cuda.empty_cache()
    done("phase 31")
    counts.update(phase_training(gpu, cpu_model))
    done("phase 5")
    flagship_cpu = cpu_model
    flagship_ref = phase_train_end_to_end(cpu_model,
                                          cpu_model.cfg.with_fused_blocks(False))
    done("phase 6")
    cpu_model, model, plain, llama_counts = phase_llama_requests(gpu)
    counts.update(llama_counts)
    done("phase 7")
    phase_end_to_end(cpu_model, model, plain, "phase 8 (llama)")
    del model, plain
    torch.cuda.empty_cache()
    done("phase 8")
    counts.update(phase_llama_training(gpu, cpu_model))
    done("phase 9")
    phase_train_end_to_end(cpu_model, llama_cfg(fused_decoder=False),
                           "phase 10 (llama)")
    del cpu_model
    done("phase 10")
    cpu_model, model, square_counts = phase_square(gpu)
    counts.update(square_counts)
    done("phase 11")
    counts.update(phase_mixed(gpu, model))
    done("phase 12")
    phase_head_end_to_end(cpu_model, model)
    del cpu_model
    done("phase 13")
    counts.update(phase_images_to_poses(gpu, model))
    del model
    torch.cuda.empty_cache()
    done("phase 14")
    phase_ring(results)
    done("phase 15")
    counts.update(phase_seq_sharded(gpu))
    torch.cuda.empty_cache()
    done("phase 16")
    phase_ring_bwd(results)
    done("phase 17")
    counts.update(phase_seq_train(gpu, flagship_cpu, flagship_ref))
    done("phase 18")
    counts.update(phase_cli_train(gpu, counts["train"], TRAIN_STEPS))
    done("phase 19")
    counts.update(phase_eval(gpu))
    done("phase 20")
    counts.update(phase_master_weights(gpu, flagship_cpu, flagship_ref,
                                       counts["train"], TRAIN_STEPS))
    del flagship_cpu, flagship_ref
    done("phase 21")
    dino_cpu, dino_counts = phase_dino_requests(gpu)
    counts.update(dino_counts)
    done("phase 22")
    counts.update(phase_dino_training(gpu, dino_cpu))
    del dino_cpu
    done("phase 23")
    ms_counts, (huge_cpu, huge_ref) = phase_model_scaling(gpu)
    counts.update(ms_counts)
    done("phase 24")
    counts.update(phase_huge_seq(gpu, huge_cpu, huge_ref))
    del huge_cpu, huge_ref
    torch.cuda.empty_cache()
    done("phase 29")
    check_widths(results)
    done("phase 25")
    phase_counts(counts)
    done("phase 26")
    counts.update(phase_mesh(gpu, results))
    done("phase 27")
    counts.update(phase_tp_variants(gpu, results))
    done("phase 28")
    log(json.dumps(kernel_summary(results, counts)))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
