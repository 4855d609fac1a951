"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases, each printing one line of facts; any failure
raises and the script exits non-zero:

  1. device    — a CUDA card is present; its name and power limit
  2. build     — the hand-written kernels compile from i2v_tpu_torch/csrc/,
                 one nvcc for each source, all at once
  3. kernels   — each kernel is bit-identical to its plain PyTorch version at
                 the main paths' shapes, at ragged sizes and misaligned
                 views, with planted ties and NaNs; kernel and plain version
                 timed with CUDA events; the conv epilogue (bias_act) also
                 against torch.relu(F.conv2d(x, w, b) + r) and timed beside
                 torch.relu(t.add_(b)) at three surrogate shapes and four
                 of the video models' at B=16; Swin-B's
                 window attention (window_attn) against its plain path at the
                 four stages' shapes at B=16, unshifted and shifted, float32
                 and bfloat16, timed beside the plain path and
                 F.scaled_dot_product_attention with the bias as its mask;
                 MViTv2-B's pooling attention (pool_attn) against its plain
                 path at its seven block shapes at B=16, timed beside the
                 plain path and F.scaled_dot_product_attention with the
                 relative terms as its mask (and the residual added)
  4. slice     — 20-step full-width ENS-I2V through the port's image CLI over
                 two synthetic clips; artifacts checked, and the launch
                 counters show that every Adam step went through K1 and K2
  5. parity    — a tiny ENS-I2V run on the card and on the CPU from the same
                 seeds: the step-0 cost and its gradient w.r.t. the modifier
                 at a generic modifier; the 3-step cost trajectory is printed
                 beside its old limit, as information
  6. eval      — the six video models at full width (random weights) over
                 the slice's two adversarial clips through the port's
                 evaluation CLI, serially and in one pass, each model built
                 once: identical reports of the reference's schemas; the conv
                 epilogue (bias_act) launched once a conv, 698 a forward of
                 the six, and no other kernel
  7. whitebox  — 10-step BIM over two clips and 10-step MIFGSM over one,
                 on full-width I3D-R50 (32x224^2, 400 classes) through the
                 port's attack CLI; artifacts checked, the CE cost rose, and
                 the counters show that every step went through K3
  8. sf whitebox — 10-step BIM over one clip on full-width SlowFast-R50: every
                 step through K3, the CE rose, and the frames that neither
                 pathway samples are left as they were
  9. wb parity — a tiny I3D BIM run on the card and on the CPU from the same
                 seed and weights: step-0 cost and input gradient, the cost
                 trajectory and the share of pixels that differ
 10. eval parity — tiny SlowFast and TPN logits on the card and on the CPU
                 from the same seed, and the predictions they give
 11. aens      — 10-step full-width AENS-I2V-MF over two clips at B=1 through
                 the image CLI: K1/K2 every step, the cost descended, and the
                 coefficients carried over from clip 1 into clip 2
 12. dr        — 5-step full-width DR (ResNet-101, depth 2) over one clip
 13. fused     — 5-step ENS-I2V with --fused_eval all: the six full-width
                 video models evaluate each clip in the same process, the
                 epilogue launched once a conv of the surrogates and of the
                 video models; its CSV is cli.evaluate's over its artifacts; a float16 write
                 through the artifact writer; a --no_artifacts float16 shard
 14. ilaf      — 10-step cli.fine_tune on full-width I3D-R50 over the BIM
                 run's adv/ori pairs: K1/K2 every step, outputs in the ε-ball
 15. aens/ilaf parity — tiny AENS and ILAF on the card and on the CPU: cost,
                 gradient at a generic modifier, AENS's next coefficients
 16. wb family — 10-step DIFGSM, TIFGSM, TIFGSM3D and TAP over one clip each
                 on full-width I3D-R50 through the attack CLI: every step
                 through K3, the (total) cost rose; the DI/TI/TAP transforms
                 give the same output in every --matmul_precision mode
 17. tt        — 5-step TemporalTranslation (kernlen 15, --tt_chunk 5) over
                 one clip on full-width I3D-R50
 18. remat     — 3-step BIM at B=4 with and without --remat: the same step-0
                 costs and input gradient, a lower peak with it
 19. ucf101    — 2-step BIM through cli.attack_ucf101 on the 101-class I3D-R50
 20. wb family parity — tiny I3D DIFGSM (pinned draws), TIFGSM3D, TAP and TT
                 on the card and on the CPU: step-0 cost and gradient
 21. chunked aens — 3-step full-width AENS-I2V-MF at the reference's B=16
                 through image_main --sharded --frame_chunk auto: K1/K2 once a
                 chunk a step (and K1 once at the end), the artifacts in the
                 ε-ball; its peak memory and steps/s
 22. chunk equality — ENS-I2V at B=2 (which fits whole) with --sharded and
                 --frame_chunk 16 and without: the step-0 cost and gradient at
                 a generic modifier; the later steps printed
 23. multigrid  — 6-step ENS-I2V at B=1 with --sharded --multigrid 3: six
                 costs, K1/K2 at 112² and then at 224², outputs in the ε-ball
 24. runner parity — the tiny chunked AENS runner (momentum 0.5) on the card
                 and on the CPU: step-0 cost and gradient at a generic modifier
 25. converters — the flax-free checkpoint converters at full width, float32,
                 TF32 off: a seeded torchvision-named ResNet-101 (BN statistics
                 randomized) through models.convert.convert_torchvision on the
                 host and back through get_image_models with no warning, its
                 layer2 tap within CONV_TAP_RTOL (relative L2) of the torch
                 model's; a seeded gluoncv-named I3D-R50 with its five non-local
                 blocks saved as a .pth, converted by
                 tools/torch_convert_gluoncv.py --verify in a subprocess, loaded
                 through get_video_model with no module at init, its logits
                 within CONV_LOGIT_RTOL of the torch model's; host seconds and
                 file MB of each conversion; no kernel runs
 26. real data  — real formats at full width: two seeded uint8 Kinetics
                 sidecars (80x256x340) behind a manifest, and checkpoint files
                 of the four whole-network surrogates and I3D-R50 written with
                 to_jax_params + save_params. 20-step ENS-I2V at B=2 through
                 image_main --data kinetics --u8_ingress --prefetch 1 with the
                 surrogates loaded (no random-init warning, K1/K2 21/20, the
                 card's uint8 ingest bit-identical to the float32 path, a
                 3-step float32-ingest twin with the same step-0 cost); 10-step
                 BIM on the loaded I3D-R50 (K3 20, -ori bit-identical to the
                 host transform); cli.evaluate over the ENS clips (I3D-R50's
                 logits those of its seed, bit for bit; five models warn); and,
                 where Pillow writes JPEGs, cli.attack_ucf101 --data ucf101 over
                 frame JPEGs. Host decode ms a clip, bytes and upload time a
                 batch, uint8 against float32
 27. zoo + gradcam — 5-step I2V on DenseNet-161 (depth 3) and DR on ViT-B/16
                 (depth 4) over one clip through image_main, each run twice (the
                 second warm), K1/K2 6/5 a run; cli.gradcam with the five CAM
                 models at full width over the I2V clip (float16 masks in [0,1],
                 a PNG, no kernel launch); tiny DenseNet/ViT step-0 cost and
                 gradient and tiny grad_cam card vs CPU; densenet.msgpack and
                 vit.msgpack written by save_params and loaded through the
                 registry, logits bit for bit; cli.evaluate -> cli.report on the
                 I2V run; cli.run_grid layer_ablation --limit 1 --step 2
 28. bf16      — 3-step ENS-I2V at B=16 x 32 x 224^2 with the four surrogates
                 in bf16 (compute and storage) through the runner's library
                 call: "auto" = the whole batch, K1/K2 = steps+1/steps, the cost
                 falls, steps/s and peak; its step-0 cost at B=2 and a generic
                 modifier within 1e-2 of float32's; the six full-width video
                 models over its 16 artifacts through cli.evaluate --bf16
                 --single_pass and the float32 twin (TF32 off): clips/s, peaks,
                 each model's bf16 logits and stage outputs within 5% (relative
                 L2) of float32's (I3D past its non-local blocks: 50%), top-1
                 agreement printed; ViT-B/16's bf16 logits against
                 float32's with cuBLAS's bf16 reduced-precision reductions off
                 and on; 3-step AENS-I2V-MF at B=16 with a bf16 first moment
                 (mu_dtype): its peak beside a float32 moment's

 29. multi-device — on the real cards when there are four or more, else on
                 one card four times (the JAX suite's fake devices), float32,
                 TF32 off: ENS-I2V at B=2 through the mesh runner over
                 attack_mesh(data=2, frames=2), each position's slice of the
                 step-0 gradient held to the mesh-free runner at frame_chunk 16
                 (one position's frames), two 3-step batches with K1/K2 =
                 steps·4 + 4 / steps·4 each, steps/s and each card's peak (and,
                 on four cards, K1/K2 on the last card against their plain
                 versions); image_main ENS and AENS with --model_parallel N (N the
                 card count, 5 steps); the model-axis runner over
                 ensemble_mesh(model=4) against the sequential ensemble (step-0
                 cost and gradient; AENS's coefficients after 3 steps); the six
                 full-width video models over the mesh runner's four clips, whole
                 and cut over attack_mesh (logits, and the reports of serial,
                 mesh, mesh single-pass and cli.evaluate --data_parallel, the
                 epilogue launched once a conv of each forward); two
                 processes of image_main under the launcher's variables (gloo),
                 each on its half of four clips into one run directory, their
                 launch counts printed and checked, and cli.evaluate over the
                 merged run; white-box data parallelism: 3-step BIM on
                 full-width I3D-R50 at B=4 over attack_mesh(data=4), on one card
                 four times and (with four cards) over four cards: K3 = steps x 4
                 a call, each piece stepping on its own card, the step-0 cost
                 within MD_WB_COST_RTOL of the one-device B=4 attack's, each
                 piece's step-0 gradient within MD_WB_GRAD_ATOL of max|g| of the
                 one-device attack on that piece alone, later steps printed,
                 steps/s beside the one-device attack's; with four cards,
                 ENS --model_parallel 4 at B=16 over them (frame_chunk auto),
                 eager and graphed, as in phase 31
 30. measurement tools — the port's measurement entry points, each in its
                 own process: tools/torch_e2e_400.py over 24 clips at B=8, 10
                 steps, killed (exit 137) after 2 batches, its float16
                 artifacts checked on disk, then --resume: the labels on disk
                 re-scored (predictions = cli.evaluate --bf16's over the same
                 files at B=8), the rest attacked, 24 report rows with no -1;
                 tools/torch_perf_probe.py cost ens16_bf16 (the counted FLOPs
                 of a B=16 step = the conv layers' analytic count; steps/s,
                 mfu) and hbm mi16 for one step (K3 once, peak GiB);
                 tools/torch_baseline_anchor.py at B=1 with TF32 off, 3 steps
                 (the reference's and the port's step-0 costs within 1e-5
                 relative; both steps/s)
 31. compiled loops — each case with graphs=False and then graphs=True
                 (i2v_tpu_torch/utils/graphs.py: every step after the first a
                 CUDA graph replayed), float32 paths with TF32 off: the
                 device-table Adam against torch.optim.Adam and optax's form on
                 one random state (bit for bit); ENS-I2V and AENS-I2V-MF at
                 B=1 (5 steps); the runner at B=16 in bf16 whole and in float32
                 at chunk 256 (3 steps) and multigrid in bf16; ILAF on the
                 truncated I3D-R50 (its res_layer2 the full model's, bit for
                 bit); BIM, MIFGSM and TAP on I3D-R50 at B=1, BIM at B=4 over
                 [cuda:0] x 4; DIFGSM with and without momentum and
                 TemporalTranslation 'adj' and 'random' (kernlen 15, chunk 5)
                 on I3D-R50 at B=1, K3 = steps a call and each twin's draw
                 table equal to the host draws of its call's generator; ENS
                 --model_parallel 4 at B=2 over [cuda:0] x 4 (K1/K2 as on the
                 sharded runner); the Grad-CAM evaluator over the five CAM
                 models at B=2, two batches (maps within CAM_ATOL of the eager
                 ones); the six video models' logits replayed bit for bit,
                 their single pass at B=16 in bf16 and float32 over two batches
                 (predictions equal), a fused ENS + six-model run over two B=2
                 batches. Gates: step-0 costs equal, later steps printed
                 (UNSTEADY's rule), launches equal, each B=16 peak within
                 LOOP_PEAK_SLACK_GIB of its eager twin's; printed: steps/s or
                 clips/s, idle share, peak GiB and the capture's one-off seconds
 32. swin      — full-width Video Swin-B (random weights, TF32 off) over the
                 slice's adversarial clips through cli.evaluate --models
                 swin3d_b at batch 1, serially and with --single_pass: one
                 capture, 24 window_attn launches a forward (eager and
                 replayed), identical one-model reports; its logits of the
                 clips within SWIN_LOGIT_TOL of those with the plain attention
 33. mvit      — the q, k and v pooling (pool_qkv) against its plain path
                 (three attention_pool calls) at B=16 on blocks 0-1's shape,
                 timed beside its byte bound and the plain path; then the
                 same as swin for full-width MViTv2-B (--models mvit_v2_b):
                 24 pool_attn and 24 pool_qkv launches a forward, eager and
                 replayed, no other kernel; logits within MVIT_LOGIT_TOL of
                 those with both plain paths
 34. uniformer — the depthwise 3-D conv (dwconv3d) against its plain path
                 (the grouped conv) at B=16 at each of UniFormer-B's stage
                 shapes, timed beside its bound (FLOPs or bytes), its plain
                 path and aten's conv_depthwise3d alone; the global
                 attention (global_attn) against the plain attention at
                 stage 3's and 4's shapes (B=16), timed in turns with it and
                 with SDPA's memory-efficient backend, beside its 3xTF32
                 bound; then the same as swin for full-width UniFormer-B
                 (--models uniformer_b): 53 dwconv3d and 27 global_attn
                 launches a forward, eager and replayed, no other kernel;
                 logits within UNIFORMER_LOGIT_TOL of those with both plain
                 paths
Phase 3 also holds K1/K2 to their plain versions at the chunked runner's
shapes: a 512-frame call (B=16), a 128-frame chunk that starts 128 frames
into a 512-frame modifier, and a 112² call (multigrid's coarse phase).
Each path (slice, eval, whitebox, sf whitebox, aens, dr, fused, ilaf, wb
family, tt, remat, ucf101, chunked aens, chunk equality, multigrid, real
data's ENS, twin, BIM and UCF-101 runs, zoo + gradcam's DenseNet and ViT
runs, Grad-CAM, evaluation and grid, bf16's ENS, evaluations and
mu_dtype AENS, multi-device's mesh runner, --model_parallel runs,
model-axis AENS, evaluations and white-box mesh BIM, every compiled loops
case, eager and graphed, and swin's, mvit's and uniformer's evaluations; converters, which
launches
none) is driven
with the launch counters set to 0 just before it and read just after; the
two launched processes of multi-device and the measurement tools'
processes count their own and print them, and their counts join the
kernels line.
The line before the last is a JSON object with each kernel's launches over
those paths, its error, times and bound; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

EPS = 16 / 255
MAIN_SHAPE = (32, 3, 224, 224)  # one clip's B·T frames, NCHW
RAGGED_SIZES = (1, 127, 4097, 1_000_003)
SLICE_STEPS = 20
SLICE_CLIPS = 2
CLIP_SHAPE = (1, 3, 32, 224, 224)  # one clip, (B, C, T, H, W): K3's main shape
WB_RUNS = (("BIM", 2), ("MIFGSM", 1))  # (method, clips) at B=1
WB_STEPS = 10
TIMING_ITERS = 50
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's clock: longer than the enqueue
# the least time a kernel could take: the larger of its bytes (each input read
# once, the output written once) over the H100's 3.35 TB/s and its float32
# operations over the 67 TFLOP/s outside the tensor cores (NVIDIA's data
# sheet, SXM part, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the launch counters of i2v_tpu_torch.ops.kernels: K1-K3, the conv epilogue,
# Swin-B's window attention, MViTv2-B's pooling attention and its q, k and v
# pooling, UniFormer-B's depthwise convs and global attention
K1_TO_K3 = ("rebuild_fwd", "rebuild_bwd", "sign_step")
COUNTED = K1_TO_K3 + ("bias_act", "window_attn", "pool_attn", "pool_qkv", "dwconv3d",
                      "global_attn")
# the conv epilogue's launches in one forward of each full-width video model,
# one a conv: I3D's stem, bottlenecks and five non-local blocks of four convs;
# SlowFast's two stems, four laterals and both pathways' bottlenecks; TPN's
# stem, bottlenecks and eleven neck convs. 698 a forward of the six
VIDEO_EPILOGUES = {"i3d_resnet50": 73, "i3d_resnet101": 124, "slowfast_resnet50": 110,
                   "slowfast_resnet101": 212, "tpn_resnet50": 64, "tpn_resnet101": 115}
SIX_EPILOGUES = sum(VIDEO_EPILOGUES.values())
# and in one forward of the ENS-I2V surrogates (ResNet-101 to stage 2, VGG-16
# to features[20], SqueezeNet-1.1 to Fire 6, AlexNet to features[7])
ENS_EPILOGUES = 46
KERNEL_WORK = {            # (bytes, float32 operations) an element
    "rebuild_fwd": (12, 5),   # read clean, m; write out; 2 clamps, 1 add
    "rebuild_bwd": (16, 8),   # read clean, m, g; write dm; 2 clamps, 1 add, 4 compares, 1 select
    "sign_step": (16, 9),     # read adv, g, clean; write out; sign, 1 mul, 3 adds, 2 clamps
}
# the conv epilogue at the surrogates' shapes over 256 frames, the runner's
# chunk, and at the video models' over a batch of 16 clips, planes of T·H·W
# from 25088 floats down to 196: (label, y's shape, with a residual); its
# bound is 8 bytes an element, 12 with the residual (read y (and r), write
# y), over HBM_BYTES_PER_S
BIAS_ACT_SHAPES = (("VGG-16 conv1_2", (256, 64, 224, 224), False),
                   ("ResNet-101 layer1 conv3 + residual", (256, 256, 56, 56), True),
                   ("SqueezeNet-1.1 Fire 2 expand3x3", (256, 64, 55, 55), False),
                   ("I3D-R50 res2 conv3 + residual", (16, 256, 8, 56, 56), True),
                   ("I3D-R50 res3 conv1", (16, 128, 8, 28, 28), False),
                   ("I3D-R50 res5 conv3 + residual", (16, 2048, 8, 7, 7), True),
                   ("SlowFast-R50 slow res5 conv3 + residual", (16, 2048, 4, 7, 7), True))
BIAS_ACT_ITERS = 20
# Swin-B's window attention at B=16 over 32x224^2: (label, heads, the stage's
# (T, H, W) grid of tokens); window (8, 7, 7), shift (4, 3, 3), which
# get_window_size clips to (4, 0, 0) in stage 4, whose 7x7 grid is its window
SWIN_WINDOW, SWIN_SHIFT, SWIN_HEAD_DIM = (8, 7, 7), (4, 3, 3), 32
WINDOW_ATTN_SHAPES = (("stage 1", 4, (16, 56, 56)), ("stage 2", 8, (16, 28, 28)),
                      ("stage 3", 16, (16, 14, 14)), ("stage 4", 32, (16, 7, 7)))
WINDOW_ATTN_BATCH, WINDOW_ATTN_ITERS = 16, 10
# kernel vs plain path, |got - want| <= atol + rtol·|want|: float32 softmax and
# sums in another order (3.2e-6 at most on outputs of scale ~1, PERF.md §6);
# in bfloat16 both round the same float32 result once (2^-8 relative)
WINDOW_ATTN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (8e-3, 1e-5)}
SWIN_BLOCKS = 24          # one window_attn launch a block: depths (2, 2, 18, 2)
# Swin-B's logits with the kernel against the plain attention, max|diff| over
# the logits' std: float32 rounding through 24 blocks (the benchmark's
# logit_gap reads 1.6e-6 on the card; TF32 gives 2.7e-3, PERF.md §6)
SWIN_LOGIT_TOL = 1e-4
# MViTv2-B's pooling attention at B=16 over 32x224^2, its seven block shapes:
# (label, heads, query grid, key grid); head dim 96
POOL_ATTN_SHAPES = (("blocks 0-1", 1, (16, 56, 56), (16, 7, 7)),
                    ("block 2", 2, (16, 28, 28), (16, 14, 14)),
                    ("blocks 3-4", 2, (16, 28, 28), (16, 7, 7)),
                    ("block 5", 4, (16, 14, 14), (16, 14, 14)),
                    ("blocks 6-20", 4, (16, 14, 14), (16, 7, 7)),
                    ("block 21", 8, (16, 7, 7), (16, 14, 14)),
                    ("blocks 22-23", 8, (16, 7, 7), (16, 7, 7)))
POOL_ATTN_BATCH, POOL_ATTN_ITERS = 16, 5
# kernel vs plain path, |got - want| <= atol + rtol·|want|: float32 softmax and
# sums over up to 3137 keys in another order (outputs of scale ~1)
POOL_ATTN_TOL = (1e-5, 1e-5)
MVIT_BLOCKS = 24          # one pool_attn and one pool_qkv launch a block
# the q, k and v pooling at B=16 on MViTv2-B's blocks 0-1: heads, input grid,
# query stride, key/value stride; kernel vs plain path, |got - want| <= atol +
# rtol·|want| (the same taps in the same order, the norms' sums in another,
# outputs of scale ~1)
POOL_QKV_SHAPE = (1, (16, 56, 56), (1, 1, 1), (1, 8, 8))
POOL_QKV_BATCH, POOL_QKV_ITERS = 16, 10
POOL_QKV_TOL = (1e-5, 1e-5)
# MViTv2-B's logits with the kernel against the plain attention, max|diff| over
# the logits' std: float32 rounding through 24 blocks (the benchmark's
# logit_gap against the reference reads ~6e-6 on the card; TF32 gives 3.4e-3)
MVIT_LOGIT_TOL = 1e-4
# UniFormer-B's depthwise convs at B=16 over 32x224^2, each stage's shapes:
# (label, kernel, channels, (T, H, W) grid, launches a forward); 53 in all
DWCONV3D_SHAPES = (("stage 1 DPE", 3, 64, (16, 56, 56), 5),
                   ("stage 1 local", 5, 64, (16, 56, 56), 5),
                   ("stage 2 DPE", 3, 128, (16, 28, 28), 8),
                   ("stage 2 local", 5, 128, (16, 28, 28), 8),
                   ("stage 3 DPE", 3, 320, (16, 14, 14), 20),
                   ("stage 4 DPE", 3, 512, (16, 7, 7), 7))
DWCONV3D_BATCH, DWCONV3D_ITERS = 16, 10
# kernel vs plain path, |got - want| <= atol + rtol·|want|: the same taps in
# the same order, the residual and bias added in another (outputs of scale ~1)
DWCONV3D_TOL = (1e-5, 1e-5)
UNIFORMER_LAUNCHES = 53   # a DPE a block and a 5^3 a conv block
# UniFormer-B's global attention at B=16: (label, heads, tokens, launches a
# forward); head dim 64; 27 launches a forward
GLOBAL_ATTN_SHAPES = (("stage 3", 5, 3136, 20), ("stage 4", 8, 784, 7))
GLOBAL_ATTN_ITERS = 5
UNIFORMER_ATTN_LAUNCHES = 27
# float32-accurate products on the tensor cores take three TF32 products each
# (3xTF32): the global attention's bound is the TF32 peak over 3
TF32_OPS_PER_S = 494.7e12
# the kernel vs the plain attention (cuBLAS float32), max |diff| on outputs of
# scale ~0.1: both float32, products and softmax sums over up to 3136 keys in
# other orders (each ~1e-6 off the float64 attention, PERF.md §6)
GLOBAL_ATTN_TOL = 1e-5
# UniFormer-B's logits with both kernels against both plain paths, max |diff|
# over the logits' std: float32 rounding through 40 blocks
UNIFORMER_LOGIT_TOL = 1e-4
SF_FAST_STRIDE = 2         # SlowFast-R50's fast pathway samples every 2nd frame
AENS_CLIPS, AENS_STEPS = 2, 10
AENS_MOMENTUM = 0.8        # > 0, so that carried-over coefficients show in clip 2
DR_STEPS = 5
FUSED_CLIPS, FUSED_STEPS = 2, 5
ILAF_CLIPS, ILAF_STEPS = WB_RUNS[0][1], 10   # over the BIM run's pairs
WB_FAMILY = ("DIFGSM", "TIFGSM", "TIFGSM3D", "TAP")   # 10 steps (WB_STEPS), one clip each
# attacks that step along a smoothed gradient, not the steepest one: on random
# weights they raise I3D-R50's CE at first but not steadily, so their check is
# that some step after the first is above it. On an H100, TIFGSM went 22.91 →
# 27.63 and back to 24.93; TIFGSM3D 22.91 → 28.50 at step 3, 22.74 at step 10;
# TemporalTranslation 23.48 → 23.95 at step 1, 22.68 at step 3, 23.06 at
# step 4 (PERF.md §6)
UNSTEADY = ("TIFGSM", "TIFGSM3D")
TT_STEPS = 5
REMAT_BATCH, REMAT_STEPS = 4, 3
UCF_STEPS = 2
PREC_MODES = ("float32", "default", "high")
PREC_ATOL = 1e-6          # a transform's output across precision modes, times max|out|
REPORT_CSV, REPORT_JSON = "results_all_models_prediction.csv", "top1_acc_all_models.json"
# the chunked runner's shapes of K1/K2: (label, frames of the call, offset in
# frames into a modifier of how many frames, H = W)
CHUNK_SHAPES = (("B=16, 512 frames", 512, 0, 512, 224),
                ("the auto chunk, 256 frames 256 into 512", 256, 256, 512, 224),
                ("a 128-frame chunk 128 frames into 512", 128, 128, 512, 224),
                ("multigrid's coarse 112^2", 32, 0, 32, 112))
L2_BYTES = 50 * 2**20     # the H100's L2: a timed call at a smaller shape rotates
                          # over input sets that move twice this, so each is cold
CHUNK_CLIPS, CHUNK_STEPS = 16, 3      # AENS at the reference's production batch
EQ_CLIPS, EQ_STEPS, EQ_CHUNK = 2, 3, 16
EQ_COST_RTOL = 1e-5       # chunked vs whole step-0 cost on the card
EQ_GRAD_ATOL = 5e-5       # a chunk's gradient vs the whole runner's over the same
                          # frames, times max|g|: the same batch size, so the same
                          # cuDNN algorithms; the same gradient varies run to run by
                          # up to 1.61e-5 of max|g| (PERF.md §6)
EQ_L2_RTOL = 1e-3         # chunked vs whole over the batch, ||diff|| / ||g||: cuDNN
                          # picks its algorithms by batch size, and the rounding that
                          # differs flips a few ReLU and max-pool switches (PERF.md §6)
MG_STEPS, MG_COARSE = 6, 3


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} visible")
    return name, card


def phase_build(kernels) -> None:
    t0 = time.time()
    libs = kernels.build_all()
    wall = time.time() - t0
    for name, lib in libs.items():
        regs = [ln.strip() for ln in lib.log.splitlines() if "registers" in ln]
        print(f"[build] {os.path.relpath(lib.path)} (nvcc {lib.seconds:.2f} s); "
              f"ptxas: {' | '.join(regs) or 'no report'}")
    print(f"[build] {len(libs)} sources in {wall:.2f} s wall, built in parallel")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a − b|, where a NaN must meet a NaN (else the error is inf)."""
    a, b = a.detach(), b.detach()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    d = (a - b).abs()[~nan_a]
    return float(d.max()) if d.numel() else 0.0


def _view(make, n: int, offset: int) -> torch.Tensor:
    """``make(n + offset)[offset:]``: n elements, a view that starts
    ``offset`` elements into a larger buffer (misaligned) when ``offset``
    is not 0."""
    return make(n + offset)[offset:]


def _inputs(n: int, gen: torch.Generator, offset: int = 0):
    """clean in [0,1], modifier in [−2ε, 2ε], upstream gradient ~ N(0,1),
    as flat float32 tensors of n elements."""
    dev = "cuda"
    clean = _view(lambda k: torch.rand(k, generator=gen, device=dev), n, offset)
    mod = _view(lambda k: (torch.rand(k, generator=gen, device=dev) * 4 - 2) * EPS, n, offset)
    g = _view(lambda k: torch.randn(k, generator=gen, device=dev), n, offset)
    return clean, mod, g


def _plant(clean, mod, eps32: float) -> None:
    """Ties at m = ±ε, u = 0 and u = 1, a −0.0 modifier, and NaNs."""
    n = clean.numel()
    plants = [(eps32, None), (-eps32, None),
              (-eps32, eps32),   # u = ε − ε = 0
              (0.0, 1.0),        # u = 1
              (0.0, 0.0),        # u = 0
              (-0.0, 0.5),
              (eps32, 1.0 - eps32),
              (float("nan"), 0.5),
              (0.01, float("nan"))]
    for k, (m_val, c_val) in enumerate(plants):
        i = (k * 7919) % n
        mod[i] = m_val
        if c_val is not None:
            clean[i] = c_val


def _compare(kernels, pixel, clean, mod, g, eps32: float) -> tuple[float, float]:
    out_k = kernels.launch_rebuild_fwd(clean, mod, eps32)
    m = mod.clone().requires_grad_(True)
    out_p = pixel.rebuild_adv(clean, m, eps32)
    (dm_p,) = torch.autograd.grad(out_p, m, g)
    dm_k = kernels.launch_rebuild_bwd(clean, mod, g, eps32)
    # and through the autograd Function, as the attack calls it
    m2 = mod.clone().requires_grad_(True)
    out_f = kernels.rebuild_adv(clean, m2, EPS)
    out_f.backward(g)
    fwd = max(max_abs_err(out_k, out_p), max_abs_err(out_f, out_p))
    bwd = max(max_abs_err(dm_k, dm_p), max_abs_err(m2.grad, dm_p))
    return fwd, bwd


def _sign_inputs(n: int, gen: torch.Generator, offset: int = 0):
    """clean in [0,1], adv within ±ε of it, gradient ~ N(0,1), as flat
    float32 tensors of n elements (clean and g misaligned views when
    ``offset`` is not 0)."""
    dev = "cuda"
    clean = _view(lambda k: torch.rand(k, generator=gen, device=dev), n, offset)
    adv = (clean + (torch.rand(n, generator=gen, device=dev) * 2 - 1) * EPS).clamp(0, 1)
    g = _view(lambda k: torch.randn(k, generator=gen, device=dev), n, offset)
    return adv, g, clean


def _sign_plants(alpha32: float, eps32: float) -> list:
    """(adv, g, clean) triples: ties where adv + α·s − clean = ±ε exactly and
    where the result is exactly 0 or 1, ±0 and NaN gradients, NaN pixels."""
    a = np.float32(eps32 - alpha32)
    for _ in range(8):  # the f32 adv that steps onto +ε exactly
        if np.float32(a + np.float32(alpha32)) == np.float32(eps32):
            break
        a = np.nextafter(a, np.float32(1) if a + np.float32(alpha32) < eps32 else np.float32(0))
    nan = float("nan")
    return [(eps32, 0.0, 0.0),          # delta = +ε exactly
            (float(a), 1.0, 0.0),       # adv + α = +ε exactly
            (-eps32, 0.0, 0.0),         # delta = −ε exactly, result 0
            (0.0, -1.0, 0.0),           # result clamps to 0
            (1.0, 1.0, 1.0),            # result clamps to 1
            (1.0, 0.0, 1.0),            # result exactly 1
            (0.5, -0.0, 0.5), (0.5, 0.0, 0.5),
            (0.5, nan, 0.5), (nan, 1.0, 0.5), (0.5, 1.0, nan)]


def _compare_sign(kernels, pixel, adv, g, clean, alpha32: float, eps32: float) -> float:
    out_k = kernels.launch_sign_step(adv, g, clean, alpha32, eps32)
    out_w = kernels.sign_step_project(adv, g, clean, alpha32, eps32)
    out_p = pixel.sign_step_project(adv, g, clean, alpha32, eps32)
    return max(max_abs_err(out_k, out_p), max_abs_err(out_w, out_p))


def _time_ms(fn, iters: int) -> float:
    """Device ms per call. A spin kernel holds the stream while the host
    enqueues all ``iters`` calls, so the events time the calls back to back
    on the device and not the host's launch overhead."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _bound(name: str, numel: int) -> tuple[float, str]:
    """The least ms a call over ``numel`` elements could take, and what bounds it."""
    nbytes, ops = (w * numel for w in KERNEL_WORK[name])
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _chunk_shapes(kernels, pixel, gen, eps32: float, err: dict) -> list:
    """K1/K2 against their plain versions, ties planted, and timed, at each of
    CHUNK_SHAPES: the call is a view ``offset`` frames into a buffer of
    ``frames_of`` frames, as the runner's chunk views are."""
    facts = []
    for label, frames, offset, frames_of, hw in CHUNK_SHAPES:
        shape = (frames, 3, hw, hw)
        full = (frames_of, 3, hw, hw)
        clean, mod, g = (t.view(full)[offset:offset + frames]
                         for t in _inputs(int(np.prod(full)), gen))
        for t in (clean, mod, g):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise RuntimeError(f"{label}: the view is not a dense 16-byte aligned one")
        flat_c, flat_m = clean.view(-1), mod.view(-1)
        _plant(flat_c, flat_m, eps32)
        fwd, bwd = _compare(kernels, pixel, clean, mod, g, eps32)
        err["rebuild_fwd"] = max(err["rebuild_fwd"], fwd)
        err["rebuild_bwd"] = max(err["rebuild_bwd"], bwd)
        if fwd != 0.0 or bwd != 0.0:
            raise RuntimeError(f"kernel differs from its plain version ({label} {shape}): "
                               f"forward {fwd}, backward {bwd}")
        n_sets = -(-2 * L2_BYTES // (3 * clean.numel() * 4))
        sets = [(clean, mod, g)] + [tuple(t.view(shape) for t in _inputs(clean.numel(), gen))
                                    for _ in range(n_sets - 1)]
        graphs = []
        for c_, m_, g_ in sets:
            m_leaf = m_.clone().requires_grad_(True)
            graphs.append((pixel.rebuild_adv(c_, m_leaf, eps32), m_leaf, g_))
        turn = iter(range(10**9))

        def pick(items):
            return items[next(turn) % len(items)]

        ms = {"rebuild_fwd": (
                  _time_ms(lambda: kernels.launch_rebuild_fwd(*pick(sets)[:2], eps32), TIMING_ITERS),
                  _time_ms(lambda: pixel.rebuild_adv(*pick(sets)[:2], eps32), TIMING_ITERS)),
              "rebuild_bwd": (
                  _time_ms(lambda: kernels.launch_rebuild_bwd(*pick(sets), eps32), TIMING_ITERS),
                  _time_ms(lambda: torch.autograd.grad(*pick(graphs), retain_graph=True),
                           TIMING_ITERS))}
        facts.append(f"{label} {shape} at byte offset {offset * 3 * hw * hw * 4} "
                     f"(pointer mod 16 = {mod.data_ptr() % 16}; timed over {n_sets} input "
                     f"set(s)): " + ", ".join(
                         f"{k} {k_ms:.4f} ms (plain {p_ms:.4f}, bound "
                         f"{_bound(k, clean.numel())[0]:.4f} by {_bound(k, clean.numel())[1]})"
                         for k, (k_ms, p_ms) in ms.items()))
        del clean, mod, g, sets, graphs
    torch.cuda.synchronize()
    return facts


def _bias_act_planted(shape, dtype, residual: bool, gen: torch.Generator):
    y = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    b = (0.01 * torch.randn(shape[1], device="cuda", generator=gen)).to(dtype)
    r = torch.randn(shape, device="cuda", generator=gen).to(dtype) if residual else None
    flat = y.view(-1)
    for k, v in enumerate((float("nan"), -0.0, 0.0, float("inf"), -float("inf"))):
        flat[(k * 7919) % flat.numel()] = v
    b[0] = -0.0
    return y, b, r


def _bias_act(kernels, pixel, gen: torch.Generator) -> dict:
    """The conv epilogue: bit-identical to its plain version and to
    ``torch.relu(F.conv2d(x, w, b) + r)`` (a conv then the epilogue), in
    float32 at BIAS_ACT_SHAPES and in bfloat16, on ragged planes and on a
    view one element into its buffer (the scalar path), NaN, ±inf and ±0
    planted; then timed in place at BIAS_ACT_SHAPES against its byte bound,
    its plain version and ``torch.relu(t.add_(b) (+ r))``."""
    import torch.nn.functional as F

    err = 0.0
    cases = [(label, shape, res, torch.float32, 0) for label, shape, res in BIAS_ACT_SHAPES]
    cases += [("bf16 " + BIAS_ACT_SHAPES[1][0], BIAS_ACT_SHAPES[1][1], True, torch.bfloat16, 0),
              ("ragged 13^2", (256, 384, 13, 13), False, torch.float32, 0),
              ("ragged 111^2 bf16", (8, 64, 111, 111), True, torch.bfloat16, 0),
              ("a view 1 element in", (4, 64, 56, 56), True, torch.float32, 1)]
    for label, shape, res, dtype, offset in cases:
        y, b, r = _bias_act_planted(shape, dtype, res, gen)
        if offset:
            y = torch.cat([y.view(-1)[:offset], y.view(-1)])[offset:].view(shape)
        want = pixel.bias_act(y.clone(), b, None if r is None else r.clone())
        got = kernels.launch_bias_act(y, b, r)
        same = torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
        if not same:
            raise RuntimeError(f"bias_act differs from its plain version ({label} {shape})")
        del y, r, want, got
    # through a conv: the surrogates' composition, small enough to keep quick
    x = torch.randn(32, 64, 56, 56, device="cuda", generator=gen)
    w = torch.randn(256, 64, 1, 1, device="cuda", generator=gen) / 8
    b = 0.01 * torch.randn(256, device="cuda", generator=gen)
    r = torch.randn(32, 256, 56, 56, device="cuda", generator=gen)
    want = torch.relu(F.conv2d(x, w, b) + r)
    got = kernels.launch_bias_act(F.conv2d(x, w, None), b, r)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise RuntimeError("bias_act after a conv differs from torch.relu(F.conv2d(x, w, b) + r)")
    torch.cuda.synchronize()
    del x, w, b, r, want, got

    facts, first = [], None
    for label, shape, res in BIAS_ACT_SHAPES:
        y = torch.rand(shape, device="cuda", generator=gen)
        b = 0.01 * torch.randn(shape[1], device="cuda", generator=gen)
        r = torch.rand(shape, device="cuda", generator=gen) if res else None
        bound = y.numel() * (12 if res else 8) / HBM_BYTES_PER_S * 1e3
        kern = lambda: kernels.launch_bias_act(y, b, r)  # noqa: E731
        plain = lambda: pixel.bias_act(y, b, r)  # noqa: E731
        bc = b.view((1, -1) + (1,) * (y.dim() - 2))
        lib = ((lambda: torch.relu(y.add_(bc) + r)) if res  # noqa: E731
               else (lambda: torch.relu(y.add_(bc))))
        k1, p1, l1 = (_time_ms(f, BIAS_ACT_ITERS) for f in (kern, plain, lib))
        l2, p2, k2 = (_time_ms(f, BIAS_ACT_ITERS) for f in (lib, plain, kern))
        ms = ((k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2)
        facts.append(f"{label} {shape}: kernel {ms[0]:.4f} ms ({k1:.4f}, {k2:.4f}), bound "
                     f"{bound:.4f} ms by bytes ({bound / ms[0]:.1%} of it), plain {ms[1]:.4f} "
                     f"ms, torch.relu(t.add_(b){' + r' if res else ''}) {ms[2]:.4f} ms")
        if first is None:
            first = (ms, bound)
        del y, r
        torch.cuda.empty_cache()
    print("[kernels] bias_act bit-identical to its plain version at "
          + ", ".join(f"{c[1]}" for c in cases) + " (NaN, ±inf and ±0 planted), and after a "
          "conv to torch.relu(F.conv2d(x, w, b) + r); " + "; ".join(facts), flush=True)
    (k_ms, p_ms, l_ms), bound = first
    return {"err": err, "times": (k_ms, p_ms), "bound": (bound, "bytes"), "library": l_ms}


def _window_attn(kernels, gen: torch.Generator) -> dict:
    """Swin-B's window attention: the kernel against its plain path
    (``swin3d.window_attention_plain``, the kernel's oracle) at
    WINDOW_ATTN_SHAPES at B=16, unshifted and shifted, in float32 and
    bfloat16, within WINDOW_ATTN_TOL; then timed in float32, in turns with
    the plain path and, on unshifted blocks, with
    ``F.scaled_dot_product_attention`` given the bias as its mask."""
    import torch.nn.functional as F

    from i2v_tpu_torch.models import swin3d

    facts, first, err = [], None, 0.0
    for label, heads, grid in WINDOW_ATTN_SHAPES:
        for shift in ((0, 0, 0), SWIN_SHIFT):
            geo = swin3d.window_geometry(grid, SWIN_WINDOW, shift)
            n, windows = geo.tokens, WINDOW_ATTN_BATCH * math.prod(geo.counts)
            table = 0.5 * torch.randn(swin3d.table_rows(SWIN_WINDOW), heads, device="cuda",
                                      generator=gen)
            qkv = torch.randn(windows, n, 3, heads, SWIN_HEAD_DIM, device="cuda", generator=gen)
            kind = "shifted" if geo.shifted else "unshifted"
            for dtype in (torch.float32, torch.bfloat16):
                x = qkv.to(dtype)
                kernels.reset_launches()
                got = swin3d.window_attention(x, table, geo)
                want = swin3d.window_attention_plain(x, table, geo)
                if kernels.launches["window_attn"] != 1 or got.dtype != dtype:
                    raise RuntimeError(f"window_attn {label} {kind}: launches "
                                       f"{kernels.launches['window_attn']}, dtype {got.dtype}")
                diff = (got.float() - want.float()).abs()
                rtol, atol = WINDOW_ATTN_TOL[dtype]
                if not got.isfinite().all() or (diff > atol + rtol * want.float().abs()).any():
                    raise RuntimeError(f"window_attn differs from its plain path ({label} {kind}, "
                                       f"{dtype}): max |diff| {float(diff.max()):.3g}")
                if dtype == torch.float32:
                    err = max(err, float(diff.max()))
                del x, got, want, diff
            flops = 4 * windows * heads * n * n * SWIN_HEAD_DIM
            nbytes = 4 * windows * heads * n * SWIN_HEAD_DIM * 4 + table.numel() * 4
            by_ops, by_bytes = flops / F32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            bound = (max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes")
            kern = lambda: swin3d.window_attention(qkv, table, geo)  # noqa: E731
            plain = lambda: swin3d.window_attention_plain(qkv, table, geo)  # noqa: E731
            fns = [kern, plain]
            if not geo.shifted:  # one dense bias serves every window
                index = swin3d._relative_index(geo.full_window, n, qkv.device)
                bias = table[index].permute(2, 0, 1).contiguous()
                q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
                fns.append(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
                lib = fns[-1]().transpose(1, 2).reshape(windows, n, heads * SWIN_HEAD_DIM)
                lib_diff = float((lib - plain()).abs().max())
                if not lib_diff <= 1e-4:  # the yardstick computes the same attention
                    raise RuntimeError(f"SDPA differs from the plain path ({label}): {lib_diff}")
                del lib
            first_turn = [_time_ms(f, WINDOW_ATTN_ITERS) for f in fns]
            second_turn = [_time_ms(f, WINDOW_ATTN_ITERS) for f in reversed(fns)][::-1]
            ms = [(a + b) / 2 for a, b in zip(first_turn, second_turn)]
            library = ms[2] if len(ms) > 2 else None
            facts.append(f"{label} {kind} ({windows * heads} window-heads of {n} x "
                         f"{SWIN_HEAD_DIM}): kernel {ms[0]:.4f} ms ({first_turn[0]:.4f}, "
                         f"{second_turn[0]:.4f}), bound {bound[0]:.4f} ms by {bound[1]} "
                         f"({bound[0] / ms[0]:.1%} of it), plain {ms[1]:.4f} ms"
                         + (f", SDPA with the bias as its mask {library:.4f} ms" if library
                            else ""))
            if first is None:
                first = (ms[0], ms[1], bound, library)
            del qkv, table, fns, kern, plain
            if not geo.shifted:
                del q, k, v, bias
            torch.cuda.empty_cache()
    kernels.reset_launches()
    print(f"[kernels] window_attn within {WINDOW_ATTN_TOL[torch.float32]} (rtol, atol) of its "
          f"plain path in float32 (max |diff| {err:.3g}) and "
          f"{WINDOW_ATTN_TOL[torch.bfloat16]} in bfloat16 at B={WINDOW_ATTN_BATCH}, unshifted "
          "and shifted; " + "; ".join(facts), flush=True)
    k_ms, p_ms, bound, library = first
    return {"err": err, "times": (k_ms, p_ms), "bound": bound, "library": library}


def _pool_attn(kernels, gen: torch.Generator) -> dict:
    """MViTv2-B's pooling attention: the kernel against its plain path
    (``mvit.pool_attention_plain``, the kernel's oracle) at POOL_ATTN_SHAPES
    at B=16, within POOL_ATTN_TOL; then timed in turns with the plain path
    and ``F.scaled_dot_product_attention`` given the relative terms as its
    mask, the residual added after it."""
    import torch.nn.functional as F

    from i2v_tpu_torch.models import mvit

    facts, first, err = [], None, 0.0
    for label, heads, q_grid, k_grid in POOL_ATTN_SHAPES:
        nq1, nk1 = 1 + math.prod(q_grid), 1 + math.prod(k_grid)
        b = POOL_ATTN_BATCH
        q, k, v = (torch.randn(b, heads, n, 96, device="cuda", generator=gen)
                   for n in (nq1, nk1, nk1))
        tables = [0.1 * torch.randn(2 * max(a, c) - 1, 96, device="cuda", generator=gen)
                  for a, c in zip(q_grid, k_grid)]
        terms = mvit.relative_terms(q, q_grid, k_grid, *tables)
        kernels.reset_launches()
        got = mvit.pool_attention(q, k, v, terms)
        want = mvit.pool_attention_plain(q, k, v, terms)
        if kernels.launches["pool_attn"] != 1:
            raise RuntimeError(f"pool_attn {label}: launches {kernels.launches['pool_attn']}")
        diff = (got - want).abs()
        rtol, atol = POOL_ATTN_TOL
        if not got.isfinite().all() or (diff > atol + rtol * want.abs()).any():
            raise RuntimeError(f"pool_attn differs from its plain path ({label}): max |diff| "
                               f"{float(diff.max()):.3g}")
        err = max(err, float(diff.max()))
        del got, want, diff
        flops = 4 * b * heads * nq1 * nk1 * 96
        nbytes = b * heads * ((2 * nq1 + 2 * nk1) * 96 + (nq1 - 1) * sum(k_grid)) * 4
        by_ops, by_bytes = flops / F32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound = (max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes")
        rt, rh, rw = (t.view(b, heads, nq1 - 1, t.shape[-1]) for t in terms)
        mask = F.pad((rt[..., :, None, None] + rh[..., None, :, None]
                      + rw[..., None, None, :]).reshape(b, heads, nq1 - 1, -1), (1, 0, 1, 0))
        residual = F.pad(q[:, :, 1:], (0, 0, 1, 0))
        fns = [lambda: mvit.pool_attention(q, k, v, terms),
               lambda: mvit.pool_attention_plain(q, k, v, terms),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask) + residual]
        lib = fns[2]().transpose(1, 2).reshape(b, nq1, heads * 96)
        lib_diff = float((lib - fns[1]()).abs().max())
        if not lib_diff <= 1e-4:  # the yardstick computes the same attention
            raise RuntimeError(f"SDPA differs from the plain path ({label}): {lib_diff}")
        del lib
        first_turn = [_time_ms(f, POOL_ATTN_ITERS) for f in fns]
        second_turn = [_time_ms(f, POOL_ATTN_ITERS) for f in reversed(fns)][::-1]
        ms = [(x + y) / 2 for x, y in zip(first_turn, second_turn)]
        facts.append(f"{label} ({b * heads} clip-heads of {nq1} x {nk1} x 96): kernel "
                     f"{ms[0]:.4f} ms ({first_turn[0]:.4f}, {second_turn[0]:.4f}), bound "
                     f"{bound[0]:.4f} ms by {bound[1]} ({bound[0] / ms[0]:.1%} of it), plain "
                     f"{ms[1]:.4f} ms, SDPA with the terms as its mask {ms[2]:.4f} ms")
        if first is None:
            first = (ms[0], ms[1], bound, ms[2])
        del q, k, v, terms, tables, fns, mask, residual, rt, rh, rw
        torch.cuda.empty_cache()
    kernels.reset_launches()
    print(f"[kernels] pool_attn within {POOL_ATTN_TOL} (rtol, atol) of its plain path (max "
          f"|diff| {err:.3g}) at B={POOL_ATTN_BATCH}; " + "; ".join(facts), flush=True)
    k_ms, p_ms, bound, library = first
    return {"err": err, "times": (k_ms, p_ms), "bound": bound, "library": library}


def phase_kernels(kernels, pixel) -> dict:
    eps32 = float(np.float32(EPS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"rebuild_fwd": 0.0, "rebuild_bwd": 0.0}
    cases = [("main", int(np.prod(MAIN_SHAPE)), 0)]
    cases += [(f"n={n}", n, 0) for n in RAGGED_SIZES]
    cases += [("offset view", 1_000_003, 1)]
    for label, n, offset in cases:
        clean, mod, g = _inputs(n, gen, offset)
        _plant(clean, mod, eps32)
        if label == "main":
            clean, mod, g = (t.view(MAIN_SHAPE) for t in (clean, mod, g))
        fwd, bwd = _compare(kernels, pixel, clean, mod, g, eps32)
        err["rebuild_fwd"] = max(err["rebuild_fwd"], fwd)
        err["rebuild_bwd"] = max(err["rebuild_bwd"], bwd)
        if fwd != 0.0 or bwd != 0.0:
            raise RuntimeError(f"kernel differs from its plain version ({label}): "
                               f"forward {fwd}, backward {bwd}")
    torch.cuda.synchronize()
    chunk_facts = _chunk_shapes(kernels, pixel, gen, eps32, err)

    # K3 at the white-box path's α (BIM: ε/10) and ε
    alpha32 = float(np.float32(EPS / WB_STEPS))
    err["sign_step"] = 0.0
    n_clip = int(np.prod(CLIP_SHAPE))
    for label, n, offset in [("main", n_clip, 0)] + [(f"n={k}", k, 0) for k in RAGGED_SIZES] \
            + [("offset view", 1_000_003, 1)]:
        adv, g, clean = _sign_inputs(n, gen, offset)
        for k, (a_val, g_val, c_val) in enumerate(_sign_plants(alpha32, eps32)):
            i = (k * 7919) % n
            adv[i], g[i], clean[i] = a_val, g_val, c_val
        if label == "main":
            adv, g, clean = (t.view(CLIP_SHAPE) for t in (adv, g, clean))
        e = _compare_sign(kernels, pixel, adv, g, clean, alpha32, eps32)
        err["sign_step"] = max(err["sign_step"], e)
        if e != 0.0:
            raise RuntimeError(f"sign_step differs from its plain version ({label}): {e}")
    torch.cuda.synchronize()

    adv_s, g_s, clean_s = (t.view(CLIP_SHAPE) for t in _sign_inputs(n_clip, gen))
    clean, mod, g = (t.view(MAIN_SHAPE) for t in _inputs(int(np.prod(MAIN_SHAPE)), gen))
    m = mod.clone().requires_grad_(True)
    out_p = pixel.rebuild_adv(clean, m, eps32)
    timed = {
        "rebuild_fwd": (lambda: kernels.launch_rebuild_fwd(clean, mod, eps32),
                        lambda: pixel.rebuild_adv(clean, mod, eps32)),
        "rebuild_bwd": (lambda: kernels.launch_rebuild_bwd(clean, mod, g, eps32),
                        lambda: torch.autograd.grad(out_p, m, g, retain_graph=True)),
        "sign_step": (lambda: kernels.launch_sign_step(adv_s, g_s, clean_s, alpha32, eps32),
                      lambda: pixel.sign_step_project(adv_s, g_s, clean_s, alpha32, eps32)),
    }
    numel = {"rebuild_fwd": clean.numel(), "rebuild_bwd": clean.numel(),
             "sign_step": adv_s.numel()}
    times, bounds = {}, {}
    for name, (kern, plain) in timed.items():
        p1 = _time_ms(plain, TIMING_ITERS)
        k1 = _time_ms(kern, TIMING_ITERS)
        k2 = _time_ms(kern, TIMING_ITERS)
        p2 = _time_ms(plain, TIMING_ITERS)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        bounds[name] = _bound(name, numel[name])
    print(f"[kernels] K1/K2 at the chunked runner's shapes: " + "; ".join(chunk_facts))
    print(f"[kernels] bit-identical to the plain version at {MAIN_SHAPE} (K1, K2) and "
          f"{CLIP_SHAPE} (K3), sizes {RAGGED_SIZES} and a misaligned view, ties and NaNs "
          "planted; "
          + "; ".join(f"{k}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, bound "
                      f"{bounds[k][0]:.4f} ms by {bounds[k][1]} "
                      f"({bounds[k][0] / t[0]:.0%} of it)" for k, t in times.items()))
    epilogue = _bias_act(kernels, pixel, gen)
    err["bias_act"] = epilogue["err"]
    times["bias_act"] = epilogue["times"]
    bounds["bias_act"] = epilogue["bound"]
    attention = _window_attn(kernels, gen)
    err["window_attn"] = attention["err"]
    times["window_attn"] = attention["times"]
    bounds["window_attn"] = attention["bound"]
    pooling = _pool_attn(kernels, gen)
    err["pool_attn"] = pooling["err"]
    times["pool_attn"] = pooling["times"]
    bounds["pool_attn"] = pooling["bound"]
    return {"err": err, "times": times, "bounds": bounds,
            "library": {"bias_act": epilogue["library"], "window_attn": attention["library"],
                        "pool_attn": pooling["library"]}}


def _costs(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "loss_info_1.json")) as f:
        info = json.load(f)
    return {v: np.asarray([float(c[str(i)]["cost"]) for i in range(len(c))])
            for v, c in info.items()}


def _check_clip(run_dir: str, label: int, kind: str, ds, pixel_mean_std) -> None:
    """``{label}-{kind}.npy`` is a finite float32 (3,32,224,224) clip in the
    ε-ball around the clean clip and in [0,1] (an ori is the clean clip)."""
    arr = np.load(os.path.join(run_dir, f"{label}-{kind}.npy"))
    if arr.dtype != np.float32 or arr.shape != (3, 32, 224, 224):
        raise RuntimeError(f"{label}-{kind}.npy: {arr.dtype} {arr.shape}")
    if not np.isfinite(arr).all():
        raise RuntimeError(f"{label}-{kind}.npy holds non-finite values")
    mean, std = pixel_mean_std
    x01 = arr * std + mean
    dist = float(np.abs(x01 - ds.clip01(label)).max())
    limit = 1e-5 if kind == "ori" else EPS + 1e-5
    if dist > limit or x01.min() < -1e-5 or x01.max() > 1 + 1e-5:
        raise RuntimeError(f"{label}-{kind}.npy leaves the ε-ball or [0,1]: "
                           f"|x−clean|∞={dist}, range [{x01.min()}, {x01.max()}]")


def phase_slice(kernels, image_main, synthetic, pixel_mean_std) -> tuple[dict, str]:
    """20-step full-width ENS-I2V; returns the launch counts and the run
    directory."""
    argv = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--data", "synthetic",
            "--n_synthetic", str(SLICE_CLIPS), "--batch_size", "1",
            "--step", str(SLICE_STEPS), "--device", "cuda", "--matmul_precision", "float32"]
    args = image_main.arg_parse(argv)
    kernels.reset_launches()
    image_main.run(args)
    counts = dict(kernels.launches)
    want = {"rebuild_fwd": SLICE_CLIPS * (SLICE_STEPS + 1),
            "rebuild_bwd": SLICE_CLIPS * SLICE_STEPS, "sign_step": 0}
    if _of(counts, want) != want:
        raise RuntimeError(f"launch counts {counts}, expected {want}")

    ds = synthetic.SyntheticAttackDataset(n_samples=SLICE_CLIPS)
    for label in range(SLICE_CLIPS):
        _check_clip(args.adv_path, label, "adv", ds, pixel_mean_std)
    costs = _costs(args.adv_path)
    if len(costs) != SLICE_CLIPS:
        raise RuntimeError(f"loss_info_1.json has {len(costs)} clips")
    for v, c in costs.items():
        if len(c) != SLICE_STEPS or not c[-1] < c[0]:
            raise RuntimeError(f"{v}: cost did not descend: {c}")
    tp = args.throughput
    print(f"[slice] ENS-I2V, {SLICE_CLIPS} clips of 32x224^2 at B=1, {SLICE_STEPS} steps, "
          f"matmul_precision=float32 (TF32 off): "
          f"{tp['attack_steps_per_sec_per_chip']:.3f} attack steps/s and "
          f"{tp['adv_clips_per_sec']:.4f} clips/s over {tp['elapsed_s']:.2f} s with the first "
          f"clip's warm-up; last clip alone {SLICE_STEPS / tp['last_call_s']:.3f} steps/s "
          f"({tp['last_call_s']:.3f} s); launches {counts}; costs "
          + "; ".join(f"{v}: {c[0]:.4f} -> {c[-1]:.4f}" for v, c in costs.items()))
    return counts, args.adv_path


# card vs CPU, tiny ENS-I2V: float32 on both (TF32 off), so the two differ
# only in the order of their sums, ~1e-7 relative a sum through the four
# surrogates' ~20 layers forward and back, as for the white-box parity below.
# They are compared where the objective is generic: at a modifier drawn
# uniformly in ±ε, not at the 0.01/255 start, where the cosine objective sits
# at its flat maximum and Adam's first steps amplify those differences.
ENS_COST_RTOL = 1e-5      # step-0 cost
ENS_GRAD_ATOL = 1e-4      # gradient w.r.t. the modifier, times max|g|
ENS_TRAJ_RTOL = 1e-4      # the 3-step trajectory from the flat start: printed only


def phase_parity(image_main) -> None:
    from i2v_tpu_torch.attacks import i2v
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.ops import kernels, pixel

    argv = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--data", "synthetic",
            "--tiny", "--clip_len", "4", "--n_synthetic", "1", "--step", "3",
            "--matmul_precision", "float32"]
    args = image_main.arg_parse(argv + ["--file_prefix", "parity-step0"])
    image_main.common.apply_matmul_precision(args)
    clip01 = synthetic.SyntheticAttackDataset(n_samples=1, clip_len=4, size=32).clip01(0)
    mod = ((np.random.RandomState(0).rand(4, 3, 32, 32) * 2 - 1) * EPS).astype(np.float32)
    step0 = {}
    for device in ("cuda", "cpu"):
        atk = image_main.common.build_image_guided_attack(args, torch.device(device))
        frames = pixel.flatten_clip_to_frames(torch.from_numpy(clip01[None]).to(device))
        with torch.no_grad():
            loss_fn = atk._make_loss(i2v._collect_taps(atk.models, frames))
        m = torch.from_numpy(mod).to(device).requires_grad_(True)
        cost, _ = loss_fn(kernels.rebuild_adv(frames, m, EPS), atk._state0())
        (g,) = torch.autograd.grad(cost, m)
        step0[device] = (float(cost.detach()), g.cpu().numpy())
    (c_k, g_k), (c_c, g_c) = step0["cuda"], step0["cpu"]
    cost_rel = abs(c_k / c_c - 1)
    grad_err = float(np.abs(g_k - g_c).max() / np.abs(g_c).max())

    runs = {}
    for device in ("cuda", "cpu"):
        runs[device] = _costs(image_main.main(
            argv + ["--device", device, "--file_prefix", f"parity-{device}"]))["synthetic_0"]
    traj_rel = float(np.max(np.abs(runs["cuda"] / runs["cpu"] - 1)))
    print(f"[parity] tiny ENS-I2V 4x32^2 at a modifier uniform in ±ε: step-0 cost card "
          f"{c_k:.7f} vs CPU {c_c:.7f} (relative {cost_rel:.3g}, limit {ENS_COST_RTOL}); "
          f"gradient max|diff|/max|g| {grad_err:.3g} (limit {ENS_GRAD_ATOL}); information "
          f"only: 3 Adam steps from the flat start, card {runs['cuda'].tolist()} vs CPU "
          f"{runs['cpu'].tolist()}, max relative {traj_rel:.3g} (the old limit "
          f"{ENS_TRAJ_RTOL})")
    if cost_rel > ENS_COST_RTOL or grad_err > ENS_GRAD_ATOL or not np.abs(g_c).max() > 0:
        raise RuntimeError("card and CPU disagree on the tiny ENS-I2V cost or gradient")


def phase_eval(evaluate_cli, get_bundle, kernels, run_dir: str) -> dict:
    """The six full-width video models over the slice's adversarial clips,
    serially and in one pass, through the evaluation CLI; ``get_bundle``
    builds each model once. Returns the launch counts of the two runs."""
    t0 = time.time()
    reports, throughput = {}, {}
    forwards = 0
    kernels.reset_launches()
    for mode in ("serial", "single pass"):
        argv = ["--adv_path", run_dir, "--device", "cuda", "--matmul_precision", "float32"]
        args = evaluate_cli.arg_parse(argv + (["--single_pass"] if mode == "single pass" else []))
        forwards += math.ceil(SLICE_CLIPS / args.batch_size)
        torch.cuda.reset_peak_memory_stats()
        acc = evaluate_cli.run(args, get_bundle=get_bundle)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(run_dir, "results_all_models_prediction.csv"), "rb") as f:
            csv_bytes = f.read()
        with open(os.path.join(run_dir, "top1_acc_all_models.json")) as f:
            top1 = json.load(f)
        if top1 != acc:
            raise RuntimeError(f"{mode}: the JSON report {top1} is not the run's {acc}")
        reports[mode] = (csv_bytes, top1)
        throughput[mode] = (args.throughput, peak)
    counts = dict(kernels.launches)
    if counts != _evaluations(forwards):
        raise RuntimeError(f"the eval path's launches {counts}, expected "
                           f"{_evaluations(forwards)}")
    if reports["serial"] != reports["single pass"]:
        raise RuntimeError(f"serial and single-pass reports differ: {reports}")
    csv_bytes, top1 = reports["serial"]
    rows = csv_bytes.decode().split("\n")
    names = list(top1)
    if (len(names) != 6 or rows[0] != "gt_label," + ",".join(f"{n}-pre" for n in names)
            or len(rows) != 402 or rows[-1] != "" or list(top1) != names):
        raise RuntimeError(f"reports off the schema: {rows[:3]}…, {len(rows)} lines, {top1}")
    for label, row in enumerate(rows[1:401]):
        cells = row.split(",")
        if cells[0] != str(label) or len(cells) != 7 or \
                (label < SLICE_CLIPS) == (cells[1:] == ["-1"] * 6) or \
                (label < SLICE_CLIPS and not all(0 <= int(c) < 400 for c in cells[1:])):
            raise RuntimeError(f"report row {label} is {row!r}")
    serial, _ = throughput["serial"]
    single, peak = throughput["single pass"]
    print(f"[eval] six video models at full width (32x224^2, 400 classes, random weights, "
          f"TF32 off) over {SLICE_CLIPS} adversarial clips, each model built once; serial "
          "clips/s " + ", ".join(f"{n} {serial[n]['clips_per_sec']:.3f}" for n in names)
          + f"; single pass {single['single_pass']['clips_per_sec']:.3f} clips/s "
          f"({single['single_pass']['elapsed_s']:.3f} s), peak memory {peak:.2f} GiB; "
          f"serial and single-pass reports identical; top-1 {top1}; rows {rows[1]!r}, "
          f"{rows[2]!r}; launches {counts}; phase wall {time.time() - t0:.2f} s")
    return counts


def phase_whitebox(kernels, attack_cli, synthetic, pixel_mean_std) -> int:
    """Full-width I3D-R50 BIM and MIFGSM through the attack CLI; returns the
    K3 launches counted over the runs."""
    k3 = 0
    for method, clips in WB_RUNS:
        argv = ["--model", "i3d_resnet50", "--attack_method", method, "--step", str(WB_STEPS),
                "--data", "synthetic", "--n_synthetic", str(clips), "--batch_size", "1",
                "--device", "cuda", "--matmul_precision", "float32"]
        args = attack_cli.arg_parse(argv)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        attack_cli.run(args)
        counts = dict(kernels.launches)
        want = {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": clips * WB_STEPS}
        if _of(counts, want) != want:
            raise RuntimeError(f"{method}: launch counts {counts}, expected {want}")
        k3 += counts["sign_step"]
        peak = torch.cuda.max_memory_allocated() / 2**30

        ds = synthetic.SyntheticAttackDataset(n_samples=clips)
        for label in range(clips):
            for kind in ("adv", "ori"):
                _check_clip(args.adv_path, label, kind, ds, pixel_mean_std)
        costs = {v: np.asarray([float(c[i]["cost"]) for i in range(len(c))])
                 for v, c in args.loss_info.items()}
        if len(costs) != clips:
            raise RuntimeError(f"{method}: costs recorded for {len(costs)} clips")
        for v, c in costs.items():
            if len(c) != WB_STEPS or not np.isfinite(c).all() or not c[-1] > c[0]:
                raise RuntimeError(f"{method} {v}: the CE cost did not rise: {c}")
        tp = args.throughput
        print(f"[whitebox] {method} on I3D-R50 (random weights), {clips} clip(s) of "
              f"32x224^2 at B=1, {WB_STEPS} steps, TF32 off: "
              f"{tp['attack_steps_per_sec_per_chip']:.3f} attack steps/s and "
              f"{tp['adv_clips_per_sec']:.4f} clips/s over {tp['elapsed_s']:.2f} s; last clip "
              f"alone {WB_STEPS / tp['last_call_s']:.3f} steps/s ({tp['last_call_s']:.3f} s); "
              f"peak memory {peak:.2f} GiB; launches {counts}; CE "
              + "; ".join(f"{v}: {c[0]:.4f} -> {c[-1]:.4f}" for v, c in costs.items()))
    return k3


def phase_whitebox_slowfast(kernels, attack_cli, synthetic, pixel, pixel_mean_std) -> int:
    """10-step BIM over one clip on full-width SlowFast-R50 through the attack
    CLI; returns the K3 launches. The frames that neither pathway samples
    (odd t: fast takes ::2, slow ::8) get exactly zero gradient, so the sign
    step leaves them at the clean clip: the artifact holds there the clean
    clip's round trip through the attack's [0,1] domain and back,
    ``normalize(clamp(unnormalize(ori), 0, 1))``, bit for bit."""
    argv = ["--model", "slowfast_resnet50", "--attack_method", "BIM", "--step", str(WB_STEPS),
            "--data", "synthetic", "--n_synthetic", "1", "--batch_size", "1",
            "--device", "cuda", "--matmul_precision", "float32"]
    args = attack_cli.arg_parse(argv)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    attack_cli.run(args)
    counts = dict(kernels.launches)
    want = {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": WB_STEPS}
    if _of(counts, want) != want:
        raise RuntimeError(f"SlowFast BIM: launch counts {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ds = synthetic.SyntheticAttackDataset(n_samples=1)
    for kind in ("adv", "ori"):
        _check_clip(args.adv_path, 0, kind, ds, pixel_mean_std)
    (c,) = [np.asarray([float(v[i]["cost"]) for i in range(len(v))])
            for v in args.loss_info.values()]
    if len(c) != WB_STEPS or not np.isfinite(c).all() or not c[-1] > c[0]:
        raise RuntimeError(f"SlowFast BIM: the CE cost did not rise: {c}")
    adv = np.load(os.path.join(args.adv_path, "0-adv.npy"))
    ori = np.load(os.path.join(args.adv_path, "0-ori.npy"))
    kept = pixel.normalize(pixel.unnormalize(torch.from_numpy(ori), 0).clamp(0, 1), 0).numpy()
    skipped, sampled = slice(1, None, SF_FAST_STRIDE), slice(0, None, SF_FAST_STRIDE)
    if not np.array_equal(adv[:, skipped], kept[:, skipped]):
        raise RuntimeError("SlowFast BIM moved a frame that neither pathway samples")
    moved = float(np.mean(adv[:, sampled] != kept[:, sampled]))
    if not moved > 0.5:
        raise RuntimeError(f"SlowFast BIM moved only {moved:.3g} of the sampled pixels")
    tp = args.throughput
    print(f"[sf whitebox] BIM on SlowFast-R50 (random weights), 1 clip of 32x224^2, "
          f"{WB_STEPS} steps, TF32 off: {WB_STEPS / tp['last_call_s']:.3f} steps/s "
          f"({tp['last_call_s']:.3f} s, with warm-up); peak memory {peak:.2f} GiB; launches "
          f"{counts}; CE {c[0]:.4f} -> {c[-1]:.4f}; the {adv.shape[1] // SF_FAST_STRIDE} "
          f"unsampled frames bit-identical to the clean clip's round trip (max |adv - ori| "
          f"there {float(np.abs(adv[:, skipped] - ori[:, skipped]).max()):.3g}); "
          f"{moved:.4f} of the sampled pixels moved")
    return counts["sign_step"]


# card vs CPU, tiny I3D BIM: float32 on both (TF32 off), so the two differ
# only in the order of their sums (cuDNN's algorithms against the CPU's);
# relative errors of ~1e-6 a layer, through ~20 layers forward and back
WB_PARITY_STEPS = 5
WB_COST_RTOL = 1e-5       # step-0 CE
WB_GRAD_ATOL = 1e-4       # step-0 input gradient, times max|g|
WB_TRAJ_RTOL = 1e-4       # CE before each step
WB_PIXEL_SHARE = 0.01     # share of output pixels that may differ: a sign
                          # flips where |g| is within the error of 0


def phase_whitebox_parity(attack_cli, synthetic) -> None:
    from i2v_tpu_torch import attacks
    from i2v_tpu_torch.models import get_video_model
    from i2v_tpu_torch.ops import pixel

    ds = synthetic.SyntheticAttackDataset(n_samples=2, clip_len=8, size=32)
    clips = np.stack([ds[i][0] for i in range(2)])
    labels = np.arange(2)
    attack_cli.common.apply_matmul_precision(
        attack_cli.arg_parse(["--matmul_precision", "float32"]))
    out = {}
    for device in ("cuda", "cpu"):
        bundle = get_video_model("i3d_resnet50", device=device, tiny=True, seed=0)
        clean01 = pixel.unnormalize(torch.from_numpy(clips).to(device), channel_axis=1)
        grad_fn = attacks.make_ce_grad_fn(bundle.apply_norm)
        cost0, g0 = grad_fn(clean01, torch.from_numpy(labels).to(device), None)
        atk = attacks.BIM(bundle, steps=WB_PARITY_STEPS)
        adv = atk(clips, labels, ["a"])
        traj = [float(atk.loss_info["a"][i]["cost"]) for i in range(WB_PARITY_STEPS)]
        out[device] = (float(cost0), g0.cpu().numpy(), np.asarray(traj), adv.cpu().numpy())
    (c_k, g_k, t_k, a_k), (c_c, g_c, t_c, a_c) = out["cuda"], out["cpu"]
    cost_rel = abs(c_k / c_c - 1)
    grad_err = float(np.abs(g_k - g_c).max() / np.abs(g_c).max())
    traj_rel = float(np.max(np.abs(t_k / t_c - 1)))
    share = float(np.mean(a_k != a_c))
    print(f"[wb parity] tiny I3D BIM 2x8x32^2, {WB_PARITY_STEPS} steps: step-0 CE card {c_k:.7f} "
          f"vs CPU {c_c:.7f} (relative {cost_rel:.3g}, limit {WB_COST_RTOL}); step-0 gradient "
          f"max|diff|/max|g| {grad_err:.3g} (limit {WB_GRAD_ATOL}); CE trajectory max relative "
          f"{traj_rel:.3g} (limit {WB_TRAJ_RTOL}); output pixels that differ {share:.3g} "
          f"(limit {WB_PIXEL_SHARE})")
    if (cost_rel > WB_COST_RTOL or grad_err > WB_GRAD_ATOL or traj_rel > WB_TRAJ_RTOL
            or share > WB_PIXEL_SHARE):
        raise RuntimeError("card and CPU disagree on the tiny white-box run")


# card vs CPU, tiny SlowFast and TPN forwards in float32 (TF32 off): summation
# order alone, ~1e-7 relative a sum through about 20 layers
EVAL_LOGIT_RTOL = 1e-5    # max|logit diff| over max|logit|


def phase_eval_parity(evaluate_cli, get_video_model, pixel) -> None:
    evaluate_cli.common.apply_matmul_precision(
        evaluate_cli.arg_parse(["--adv_path", ".", "--matmul_precision", "float32"]))
    clips01 = torch.from_numpy(np.random.RandomState(0).rand(16, 3, 8, 32, 32).astype(np.float32))
    clips = pixel.normalize(clips01, channel_axis=1)   # artifacts are normalized clips
    facts = []
    for name in ("slowfast_resnet50", "tpn_resnet50"):
        logits = {}
        for device in ("cuda", "cpu"):
            bundle = get_video_model(name, device=device, tiny=True, seed=0)
            with torch.inference_mode():
                logits[device] = bundle.apply_norm(clips.to(device)).cpu().numpy()
        k, c = logits["cuda"], logits["cpu"]
        limit = EVAL_LOGIT_RTOL * float(np.abs(c).max())
        err = float(np.abs(k - c).max())
        top2 = np.sort(c, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > limit
        same = np.argmax(k, axis=1) == np.argmax(c, axis=1)
        facts.append(f"{name} (tiny) max|diff| {err:.3g} against {limit:.3g} "
                     f"({err / limit:.3g} of the limit), predictions equal on "
                     f"{int(same[clear].sum())} of the {int(clear.sum())} clips whose top-2 gap "
                     f"is above it ({int(same.sum())} of {len(same)} in all)")
        if err > limit or not same[clear].all() or not clear.any():
            raise RuntimeError(f"card and CPU disagree on tiny {name}: {facts[-1]}")
    print(f"[eval parity] 16 clips of 8x32^2, TF32 off, logit limit rtol {EVAL_LOGIT_RTOL} of "
          "max|logit|: " + "; ".join(facts))


def _want(clips: int, steps: int) -> dict:
    """Launch counts of an Adam or ILAF path: K1 in each step and in the final
    rebuild, K2 in each step's backward, no K3."""
    return {"rebuild_fwd": clips * (steps + 1), "rebuild_bwd": clips * steps, "sign_step": 0}


def _evaluations(forwards: int) -> dict:
    """Launch counts of ``forwards`` forwards of the six video models: the
    conv epilogue once a conv, no other kernel."""
    return dict(dict.fromkeys(COUNTED, 0), bias_act=SIX_EPILOGUES * forwards)


def _fused_want(clips: int, steps: int) -> dict:
    """Launch counts of ENS-I2V with the six video models evaluating each
    clip at B=1: K1/K2 as :func:`_want`, the epilogue in the surrogates'
    clean-tap forward and step forwards of each clip and in the video
    models' forward of it, no window or pooling attention."""
    return dict(_want(clips, steps), window_attn=0, pool_attn=0, pool_qkv=0, dwconv3d=0,
                bias_act=clips * (ENS_EPILOGUES * (steps + 1) + SIX_EPILOGUES))


def _of(counts: dict, want: dict) -> dict:
    """The counters of ``counts`` that ``want`` names: a path's K1-K3 counts
    are checked, while the conv epilogue counts wherever a surrogate runs."""
    return {k: counts[k] for k in want}


def _run_counted(kernels, label: str, want: dict, fn):
    """``fn()`` with the counters set to 0 just before it; fails unless the
    counts read just after are ``want``. Returns (fn's result, counts, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = fn()
    counts = dict(kernels.launches)
    if _of(counts, want) != want:
        raise RuntimeError(f"{label}: launch counts {counts}, expected {want}")
    return out, counts, torch.cuda.max_memory_allocated() / 2**30


def _descends(label: str, costs: dict, n: int, steps: int) -> None:
    if len(costs) != n:
        raise RuntimeError(f"{label}: costs recorded for {len(costs)} clips, expected {n}")
    for v, c in costs.items():
        if len(c) != steps or not np.isfinite(c).all() or not c[-1] < c[0]:
            raise RuntimeError(f"{label} {v}: the cost did not descend: {c}")


def phase_aens(kernels, image_main, synthetic, pixel_mean_std) -> dict:
    """Full-width AENS-I2V-MF (the four surrogates with two taps each) over two
    clips at B=1; the coefficients carry over from clip to clip."""
    argv = ["--attack_method", "AENS_I2V_MF", "--data", "synthetic", "--n_synthetic",
            str(AENS_CLIPS), "--batch_size", "1", "--step", str(AENS_STEPS), "--step_size",
            "0.005", "--aens_momentum", str(AENS_MOMENTUM), "--device", "cuda",
            "--matmul_precision", "float32"]
    args = image_main.arg_parse(argv)
    build, seen = image_main.common.build_image_guided_attack, {}

    def capture(*a, **k):  # the attack the CLI builds, to read its coefficients
        atk = seen["attack"] = build(*a, **k)
        run = atk._run

        def recorded(clean01):
            out = run(clean01)
            seen.setdefault("coeffs", []).append(out[2][0].cpu().numpy())
            return out

        atk._run = recorded
        return atk

    image_main.common.build_image_guided_attack = capture
    try:
        _, counts, peak = _run_counted(kernels, "AENS", _want(AENS_CLIPS, AENS_STEPS),
                                       lambda: image_main.run(args))
    finally:
        image_main.common.build_image_guided_attack = build
    ds = synthetic.SyntheticAttackDataset(n_samples=AENS_CLIPS)
    for label in range(AENS_CLIPS):
        _check_clip(args.adv_path, label, "adv", ds, pixel_mean_std)
    costs = _costs(args.adv_path)
    _descends("AENS", costs, AENS_CLIPS, AENS_STEPS)
    atk, after = seen["attack"], seen["coeffs"]
    first_of_clip2 = atk.weights[0]
    # a fresh start's first coefficients are uniform: softmax(softmax(1) + m·1)
    spread = float(first_of_clip2.max() - first_of_clip2.min())
    if len(after) != AENS_CLIPS or any(np.allclose(c, 1.0) for c in after) or not spread > 0:
        raise RuntimeError(f"AENS coefficients did not carry over: after each clip {after}, "
                           f"clip 2's first {first_of_clip2}")
    tp = args.throughput
    print(f"[aens] AENS-I2V-MF, four full-width surrogates with {atk.n_taps} taps, "
          f"{AENS_CLIPS} clips of 32x224^2 at B=1, {AENS_STEPS} steps, momentum "
          f"{AENS_MOMENTUM}, TF32 off: last clip alone {AENS_STEPS / tp['last_call_s']:.3f} "
          f"steps/s ({tp['last_call_s']:.3f} s), {tp['attack_steps_per_sec_per_chip']:.3f} "
          f"steps/s with the first clip's warm-up; peak memory {peak:.2f} GiB; launches "
          f"{counts}; costs " + "; ".join(f"{v}: {c[0]:.4f} -> {c[-1]:.4f}"
                                         for v, c in costs.items())
          + f"; coefficients after clip 1 [{', '.join(f'{x:.5f}' for x in after[0])}], "
          f"clip 2's first step [{', '.join(f'{x:.5f}' for x in first_of_clip2)}] (spread "
          f"{spread:.3g}; uniform on a fresh start)")
    return counts


def phase_dr(kernels, image_main, synthetic, pixel_mean_std) -> dict:
    """Full-width DR (ResNet-101 at depth 2) over one clip."""
    argv = ["--attack_method", "ImageGuidedStd_Adam", "--depth", "2", "--data", "synthetic",
            "--n_synthetic", "1", "--batch_size", "1", "--step", str(DR_STEPS), "--device",
            "cuda", "--matmul_precision", "float32"]
    args = image_main.arg_parse(argv)
    _, counts, peak = _run_counted(kernels, "DR", _want(1, DR_STEPS),
                                   lambda: image_main.run(args))
    _check_clip(args.adv_path, 0, "adv", synthetic.SyntheticAttackDataset(n_samples=1),
                pixel_mean_std)
    costs = _costs(args.adv_path)
    _descends("DR", costs, 1, DR_STEPS)
    tp = args.throughput
    print(f"[dr] DR on ResNet-101 (depth 2), 1 clip of 32x224^2, {DR_STEPS} steps, TF32 off: "
          f"{DR_STEPS / tp['last_call_s']:.3f} steps/s with warm-up; peak memory {peak:.2f} "
          f"GiB; launches {counts}; cost " + "; ".join(
              f"{v}: {np.round(c, 4).tolist()}" for v, c in costs.items()))
    return counts


def phase_fused(kernels, image_main, evaluate_cli, get_bundle, pixel_mean_std) -> dict:
    """ENS-I2V with ``--fused_eval all`` at full width over two clips, float32
    artifacts; then the same artifacts through ``cli.evaluate``; then a shard
    of the run with float16 and no artifacts."""
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.eval.fused import AsyncArtifactWriter

    base = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--data", "synthetic",
            "--n_synthetic", str(FUSED_CLIPS), "--batch_size", "1", "--step", str(FUSED_STEPS),
            "--fused_eval", "all", "--device", "cuda", "--matmul_precision", "float32"]
    args = image_main.arg_parse(base + ["--file_prefix", "fused"])
    _, counts, peak = _run_counted(kernels, "fused", _fused_want(FUSED_CLIPS, FUSED_STEPS),
                                   lambda: image_main.run(args, get_bundle=get_bundle))
    run_dir, tp = args.adv_path, args.throughput
    files = sorted(os.listdir(run_dir))
    want_files = sorted([f"{i}-adv.npy" for i in range(FUSED_CLIPS)]
                        + ["loss_info_1.json", REPORT_CSV, REPORT_JSON])
    if files != want_files:
        raise RuntimeError(f"fused run directory holds {files}, expected {want_files}")
    ds = synthetic.SyntheticAttackDataset(n_samples=FUSED_CLIPS)
    for label in range(FUSED_CLIPS):
        _check_clip(run_dir, label, "adv", ds, pixel_mean_std)
    with open(os.path.join(run_dir, REPORT_CSV), "rb") as f:
        fused_csv = f.read()
    with open(os.path.join(run_dir, REPORT_JSON)) as f:
        fused_top1 = json.load(f)

    # the same artifacts offline, at the fused path's batch of 1
    eargs = evaluate_cli.arg_parse(["--adv_path", run_dir, "--batch_size", "1", "--device",
                                    "cuda", "--matmul_precision", "float32"])
    _, eval_counts, _ = _run_counted(kernels, "evaluate", _evaluations(FUSED_CLIPS),
                                     lambda: evaluate_cli.run(eargs, get_bundle=get_bundle))
    with open(os.path.join(run_dir, REPORT_CSV), "rb") as f:
        eval_csv = f.read()
    with open(os.path.join(run_dir, REPORT_JSON)) as f:
        eval_top1 = json.load(f)
    top1_diff = max(abs(fused_top1[k] - eval_top1[k]) for k in eval_top1)
    if fused_csv != eval_csv or list(fused_top1) != list(eval_top1) or top1_diff > 1e-4:
        raise RuntimeError(f"fused reports differ from cli.evaluate's: top-1 {fused_top1} vs "
                           f"{eval_top1}; CSV equal: {fused_csv == eval_csv}")

    # float16 through the writer on the card: cast on the device, side-stream copy
    clip = torch.from_numpy(np.load(os.path.join(run_dir, "0-adv.npy"))[None]).cuda()
    f16_dir = os.path.join(os.path.dirname(run_dir), "fused-f16-writer")
    writer = AsyncArtifactWriter(f16_dir, dtype=np.float16)
    writer.submit([0], clip.to(torch.float16))
    writer.close()
    f16 = np.load(os.path.join(f16_dir, "0-adv.npy"))
    if f16.dtype != np.float16 or not np.array_equal(f16, clip[0].cpu().numpy().astype(np.float16)):
        raise RuntimeError("the float16 artifact is not the clip's float16 cast")

    sargs = image_main.arg_parse(base + ["--file_prefix", "fused-shard", "--no_artifacts",
                                         "--artifact_dtype", "float16", "--batch_nums", "2",
                                         "--batch_index", "1"])
    _, shard_counts, _ = _run_counted(kernels, "fused shard",
                                      _fused_want(FUSED_CLIPS // 2, FUSED_STEPS),
                                      lambda: image_main.run(sargs, get_bundle=get_bundle))
    shard_files = sorted(os.listdir(sargs.adv_path))
    want_shard = ["loss_info_1.json", "results_all_models_prediction_1.csv",
                  "top1_acc_all_models_1.json"]
    if shard_files != want_shard:
        raise RuntimeError(f"the --no_artifacts shard wrote {shard_files}, expected {want_shard}")
    print(f"[fused] ENS-I2V {FUSED_STEPS} steps + the six full-width video models in one "
          f"process, {FUSED_CLIPS} clips of 32x224^2 at B=1, TF32 off, float32 artifacts from "
          f"the writer thread: {tp['clips_per_sec']:.4f} clips/s ({tp['elapsed_s']:.3f} s); "
          f"peak memory {peak:.2f} GiB; launches {counts} (the attack's and "
          f"{SIX_EPILOGUES} epilogues a clip of the video models); CSV "
          f"identical to cli.evaluate's over its artifacts, top-1 within {top1_diff:.3g} "
          f"(limit 1e-4): {fused_top1}; the float16 writer on the card gives the clip's "
          f"float16 cast; the --no_artifacts float16 shard 1 of 2 wrote {shard_files} with "
          f"launches {shard_counts}")
    return {k: counts[k] + eval_counts[k] + shard_counts[k] for k in counts}


def phase_ilaf(kernels, fine_tune, synthetic, pixel_mean_std) -> dict:
    """``cli.fine_tune`` on full-width I3D-R50 over the white-box phase's BIM
    run directory (adv and ori pairs of two clips)."""
    argv = ["--used_adv", f"i3d_resnet50-BIM-{WB_STEPS}-synthetic", "--model", "i3d_resnet50",
            "--step", str(ILAF_STEPS), "--device", "cuda", "--matmul_precision", "float32"]
    args = fine_tune.arg_parse(argv)
    _, counts, peak = _run_counted(kernels, "ILAF", _want(ILAF_CLIPS, ILAF_STEPS),
                                   lambda: fine_tune.run(args))
    ds = synthetic.SyntheticAttackDataset(n_samples=ILAF_CLIPS)
    for label in range(ILAF_CLIPS):
        _check_clip(args.adv_path, label, "adv", ds, pixel_mean_std)
    costs = _costs(args.adv_path)
    _descends("ILAF", costs, ILAF_CLIPS, ILAF_STEPS)
    tp = args.throughput
    print(f"[ilaf] ILAF on I3D-R50 (random weights, res_layer2 tap) over the BIM run's "
          f"{ILAF_CLIPS} pairs, {ILAF_STEPS} steps, TF32 off: last clip alone "
          f"{ILAF_STEPS / tp['last_call_s']:.3f} steps/s ({tp['last_call_s']:.3f} s); peak "
          f"memory {peak:.2f} GiB; launches {counts}; outputs within ε of the ori and in "
          "[0,1]; cost trajectories " + "; ".join(
              f"{v}: {np.round(c, 4).tolist()}" for v, c in costs.items()))
    return counts


# card vs CPU, tiny AENS and ILAF: float32 on both (TF32 off), at a generic
# modifier, as the ENS parity phase
AENS_COEFF_ATOL = 1e-6    # the next step's coefficients


def phase_aens_ilaf_parity(image_main) -> None:
    from i2v_tpu_torch import attacks
    from i2v_tpu_torch.attacks import i2v
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.models import get_video_model, tap_keys_for
    from i2v_tpu_torch.ops import kernels, pixel

    args = image_main.arg_parse(["--attack_method", "AENS_I2V_MF", "--tiny", "--clip_len", "4",
                                 "--aens_momentum", "0.5", "--coef_CE", "--step", "3",
                                 "--matmul_precision", "float32", "--file_prefix", "parity"])
    image_main.common.apply_matmul_precision(args)
    rng = np.random.RandomState(0)
    clip01 = synthetic.SyntheticAttackDataset(n_samples=1, clip_len=4, size=32).clip01(0)
    mod = ((rng.rand(4, 3, 32, 32) * 2 - 1) * EPS).astype(np.float32)
    ilaf_clean = (0.1 + 0.8 * rng.rand(1, 3, 8, 32, 32)).astype(np.float32)
    ilaf_adv = (ilaf_clean + 0.5 * EPS * np.sign(rng.randn(*ilaf_clean.shape))).astype(np.float32)
    ilaf_mod = ((rng.rand(*ilaf_clean.shape) * 2 - 1) * 0.9 * EPS).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        atk = image_main.common.build_image_guided_attack(args, torch.device(device))
        frames = pixel.flatten_clip_to_frames(torch.from_numpy(clip01[None]).to(device))
        with torch.no_grad():
            loss_fn = atk._make_loss(i2v._collect_taps(atk.models, frames))
        m = torch.from_numpy(mod).to(device).requires_grad_(True)
        cost, (state1, _) = loss_fn(kernels.rebuild_adv(frames, m, EPS), atk._state0())
        (g,) = torch.autograd.grad(cost, m)
        with torch.no_grad():  # the next step's coefficients, from this step's losses
            _, (_, (_, coeffs1)) = loss_fn(kernels.rebuild_adv(frames, m, EPS), state1)

        bundle = get_video_model("i3d_resnet50", device=device, tiny=True, seed=0)
        ilaf = attacks.ILAF(bundle.with_taps(tap_keys_for("i3d_resnet50", "ilaf")), "i3d")
        cost_fn = ilaf.make_cost(torch.from_numpy(ilaf_adv).to(device),
                                 torch.from_numpy(ilaf_clean).to(device))
        mi = torch.from_numpy(ilaf_mod).to(device).requires_grad_(True)
        icost = cost_fn(mi)
        (ig,) = torch.autograd.grad(icost, mi)
        out[device] = (float(cost.detach()), g.cpu().numpy(), coeffs1.cpu().numpy(),
                       float(icost.detach()), ig.cpu().numpy())
    (c_k, g_k, w_k, ic_k, ig_k), (c_c, g_c, w_c, ic_c, ig_c) = out["cuda"], out["cpu"]
    facts = {
        "AENS step-0 cost": (abs(c_k / c_c - 1), ENS_COST_RTOL),
        "AENS gradient": (float(np.abs(g_k - g_c).max() / np.abs(g_c).max()), ENS_GRAD_ATOL),
        "AENS next coefficients": (float(np.abs(w_k - w_c).max()), AENS_COEFF_ATOL),
        "ILAF cost": (abs(ic_k / ic_c - 1), ENS_COST_RTOL),
        "ILAF gradient": (float(np.abs(ig_k - ig_c).max() / np.abs(ig_c).max()), ENS_GRAD_ATOL),
    }
    print(f"[aens/ilaf parity] tiny AENS (4x32^2, momentum 0.5, coef_CE) and tiny I3D ILAF "
          f"(8x32^2) at a generic modifier, TF32 off: AENS cost card {c_k:.7f} vs CPU "
          f"{c_c:.7f}, ILAF cost card {ic_k:.7f} vs CPU {ic_c:.7f}; "
          + "; ".join(f"{k} {v:.3g} (limit {lim})" for k, (v, lim) in facts.items()))
    if any(v > lim for v, lim in facts.values()) or not (np.abs(g_c).max() > 0
                                                        and np.abs(ig_c).max() > 0):
        raise RuntimeError("card and CPU disagree on tiny AENS or ILAF")


def _wb_argv(method: str, clips: int, steps: int, batch: int = 1) -> list:
    return ["--model", "i3d_resnet50", "--attack_method", method, "--step", str(steps),
            "--data", "synthetic", "--n_synthetic", str(clips), "--batch_size", str(batch),
            "--device", "cuda", "--matmul_precision", "float32"]


def _wb_want(clips: int, steps: int, batch: int = 1) -> dict:
    """A white-box path's launches: K3 once a step of each batch."""
    return {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": -(-clips // batch) * steps}


def _loss_costs(args, key: str = "cost") -> dict:
    return {v: np.asarray([float(c[i][key]) for i in range(len(c))])
            for v, c in args.loss_info.items()}


def _rises(label: str, costs: dict, n: int, steps: int, at_end: bool = True) -> None:
    """Each clip's cost rose: by the last step, or (``at_end=False``) at some
    step after the first."""
    if len(costs) != n:
        raise RuntimeError(f"{label}: costs recorded for {len(costs)} clips, expected {n}")
    for v, c in costs.items():
        rose = c[-1] > c[0] if at_end else c[1:].max() > c[0]
        if len(c) != steps or not np.isfinite(c).all() or not rose:
            raise RuntimeError(f"{label} {v}: the cost did not rise: {c}")


def _check_pairs(run_dir: str, clips: int, synthetic, pixel_mean_std) -> None:
    ds = synthetic.SyntheticAttackDataset(n_samples=clips)
    for label in range(clips):
        for kind in ("adv", "ori"):
            _check_clip(run_dir, label, kind, ds, pixel_mean_std)


def _precision_independence(attack_cli) -> dict:
    """Each new attack's transform on one full-width clip gradient in every
    --matmul_precision mode, against the float32 mode: max |diff| / max |out|."""
    from i2v_tpu_torch.ops import diversity, grads, smoothing

    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(CLIP_SHAPE, device="cuda", generator=gen)
    k1d = smoothing.gaussian_1d(15)
    tap_k = smoothing.uniform_kernel_3d(3, 3)

    def tap(x):  # TAP's smoothing and its backward, as the attack differentiates it
        x = x.clone().requires_grad_(True)
        y = smoothing.depthwise_conv3d(x, tap_k)
        (dx,) = torch.autograd.grad(y, x, torch.sign(y))
        return torch.cat([y.detach().flatten(), dx.flatten()])

    transforms = {
        "TIFGSM3D": lambda x: grads.norm_grads(smoothing.depthwise_conv3d_separable(x, k1d), True),
        "TIFGSM": lambda x: smoothing.ti_smooth_2d_separable(x, k1d),
        "TAP": tap,
        "DI": lambda x: diversity.diversity_gather(x, 240, 3, 5, 224, 250),
        "TT": lambda x: smoothing.smooth_variant_grads(
            smoothing.cycle_variants(x, range(-7, 8)), smoothing.temporal_kernel(15)),
    }
    out = {}
    for mode in PREC_MODES:
        attack_cli.common.apply_matmul_precision(
            attack_cli.arg_parse(["--matmul_precision", mode]))
        out[mode] = {k: f(g) for k, f in transforms.items()}
    attack_cli.common.apply_matmul_precision(attack_cli.arg_parse(["--matmul_precision",
                                                                    "float32"]))
    errs = {}
    for k in transforms:
        ref = out["float32"][k]
        errs[k] = max(float((out[m][k] - ref).abs().max() / ref.abs().max()) for m in PREC_MODES)
        if not errs[k] <= PREC_ATOL:
            raise RuntimeError(f"{k}'s transform depends on the precision mode: {errs[k]}")
    return errs


def phase_wb_family(kernels, attack_cli, synthetic, pixel_mean_std) -> int:
    """10-step DIFGSM, TIFGSM, TIFGSM3D and TAP over one clip each on
    full-width I3D-R50 through the attack CLI; returns the K3 launches."""
    k3, facts = 0, []
    for method in WB_FAMILY:
        args = attack_cli.arg_parse(_wb_argv(method, 1, WB_STEPS))
        _, counts, peak = _run_counted(kernels, method, _wb_want(1, WB_STEPS),
                                       lambda: attack_cli.run(args))
        k3 += counts["sign_step"]
        _check_pairs(args.adv_path, 1, synthetic, pixel_mean_std)
        costs = _loss_costs(args)
        _rises(method, costs, 1, WB_STEPS, at_end=method not in UNSTEADY)
        (c,) = costs.values()
        extra = ""
        if method == "TAP":
            parts = {k: _loss_costs(args, k)["synthetic_0"] for k in ("ce loss", "reg_cost",
                                                                      "distance")}
            extra = " (" + ", ".join(f"{k} {v[0]:.4g} -> {v[-1]:.4g}"
                                     for k, v in parts.items()) + ")"
        tp = args.throughput
        facts.append(f"{method} {WB_STEPS / tp['last_call_s']:.3f} steps/s "
                     f"({tp['last_call_s']:.3f} s), peak {peak:.2f} GiB, launches {counts}, "
                     f"cost {c[0]:.4f} -> {c[-1]:.4f} (most {c.max():.4f}){extra}")
    errs = _precision_independence(attack_cli)
    print(f"[wb family] I3D-R50 (random weights), 1 clip of 32x224^2 each, {WB_STEPS} steps, "
          f"TF32 off, through the attack CLI: " + "; ".join(facts)
          + "; each transform on a full-width gradient across --matmul_precision "
          f"{'/'.join(PREC_MODES)}: max|diff|/max|out| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (limit {PREC_ATOL})")
    return k3


def phase_tt(kernels, attack_cli, synthetic, pixel_mean_std) -> int:
    """TemporalTranslation at kernlen 15, --tt_chunk 5, 'adj', over one clip
    on full-width I3D-R50; returns the K3 launches."""
    args = attack_cli.arg_parse(_wb_argv("TemporalTranslation", 1, TT_STEPS)
                                + ["--kernlen", "15", "--tt_chunk", "5", "--move_type", "adj"])
    _, counts, peak = _run_counted(kernels, "TT", _wb_want(1, TT_STEPS),
                                   lambda: attack_cli.run(args))
    _check_pairs(args.adv_path, 1, synthetic, pixel_mean_std)
    costs = _loss_costs(args)
    _rises("TT", costs, 1, TT_STEPS, at_end=False)   # see UNSTEADY
    (c,) = costs.values()
    tp = args.throughput
    print(f"[tt] TemporalTranslation on I3D-R50 (random weights), kernlen 15 (15 variants a "
          f"step), --tt_chunk 5, adj, 1 clip of 32x224^2, {TT_STEPS} steps, TF32 off: "
          f"{TT_STEPS / tp['last_call_s']:.3f} steps/s ({tp['last_call_s']:.3f} s); peak memory "
          f"{peak:.2f} GiB; launches {counts}; mean CE over the variants "
          f"{np.round(c, 4).tolist()}")
    return counts["sign_step"]


def phase_remat(kernels, attack_cli, synthetic) -> int:
    """BIM at B=4 on full-width I3D-R50 with and without --remat through the
    attack CLI (peaks, rates, the step-0 costs), then the step-0 input
    gradient of both bundles on the same clips; returns the K3 launches.
    Later steps are printed only: cuDNN's input-gradient convolutions sum in
    an order that varies from run to run, so a sign flips where |g| is
    within that noise of 0, and the random-weight CE amplifies it; the same
    gradient taken twice without remat shows the noise."""
    from i2v_tpu_torch.attacks import make_ce_grad_fn
    from i2v_tpu_torch.models import get_video_model
    from i2v_tpu_torch.ops import pixel

    k3, runs = 0, {}
    for flags in ([], ["--remat"]):
        args = attack_cli.arg_parse(_wb_argv("BIM", REMAT_BATCH, REMAT_STEPS, REMAT_BATCH)
                                    + flags + ["--file_prefix", "remat" if flags else "plain"])
        _, counts, peak = _run_counted(kernels, f"BIM {flags}",
                                       _wb_want(REMAT_BATCH, REMAT_STEPS, REMAT_BATCH),
                                       lambda: attack_cli.run(args))
        k3 += counts["sign_step"]
        costs = _loss_costs(args)
        runs[bool(flags)] = (np.stack([costs[v] for v in sorted(costs)]), peak,
                             REMAT_STEPS / args.throughput["last_call_s"])
    (c0, p0, r0), (c1, p1, r1) = runs[False], runs[True]
    step0_rel = float(np.max(np.abs(c1[:, 0] / c0[:, 0] - 1)))
    later_rel = float(np.max(np.abs(c1 / c0 - 1)))

    ds = synthetic.SyntheticAttackDataset(n_samples=REMAT_BATCH)
    clean01 = pixel.unnormalize(torch.from_numpy(np.stack([ds[i][0] for i in range(REMAT_BATCH)]))
                                .cuda(), channel_axis=1)
    labels = torch.arange(REMAT_BATCH, device="cuda")
    grads = []
    for remat in (False, False, True):
        bundle = get_video_model("i3d_resnet50", device="cuda", remat=remat)
        grads.append(make_ce_grad_fn(bundle.apply_norm)(clean01, labels, None)[1])
        del bundle
    scale = float(grads[0].abs().max())
    noise = float((grads[1] - grads[0]).abs().max()) / scale
    err = float((grads[2] - grads[0]).abs().max()) / scale
    print(f"[remat] BIM on I3D-R50 at B={REMAT_BATCH}, {REMAT_STEPS} steps, TF32 off: without "
          f"--remat {r0:.3f} steps/s, peak {p0:.2f} GiB; with --remat {r1:.3f} steps/s "
          f"({r0 / r1:.3f}x the step time), peak {p1:.2f} GiB ({p1 / p0:.3f} of it); step-0 "
          f"costs relative difference {step0_rel:.3g} (limit 1e-5); step-0 input gradient "
          f"max|diff|/max|g| with remat {err:.3g} (limit {WB_GRAD_ATOL}), the same gradient "
          f"twice without it {noise:.3g}; information only: all {REMAT_STEPS} steps' costs "
          f"max relative difference {later_rel:.3g}, first clip {c0[0].tolist()} vs "
          f"{c1[0].tolist()}")
    if step0_rel > 1e-5 or err > WB_GRAD_ATOL or not p1 < p0:
        raise RuntimeError("--remat changed the step-0 cost or gradient, or did not lower "
                           "the peak")
    return k3


def phase_ucf101(kernels, attack_cli, attack_ucf101, synthetic, pixel_mean_std) -> int:
    """2-step BIM through cli.attack_ucf101 on the 101-class I3D-R50."""
    argv = _wb_argv("BIM", 1, UCF_STEPS)
    build, seen = attack_cli.get_video_model, {}

    def capture(*a, **k):  # the bundle the CLI builds, to read its head
        seen["bundle"] = build(*a, **k)
        return seen["bundle"]

    attack_cli.get_video_model = capture
    try:
        run_dir, counts, peak = _run_counted(kernels, "ucf101", _wb_want(1, UCF_STEPS),
                                             lambda: attack_ucf101.main(argv))
    finally:
        attack_cli.get_video_model = build
    classes = seen["bundle"].module.fc.out_features
    name = os.path.basename(run_dir)
    if classes != 101 or name != f"UCF101_Video_i3d_resnet50-BIM-{UCF_STEPS}-synthetic":
        raise RuntimeError(f"cli.attack_ucf101: {classes} classes, run directory {name}")
    _check_pairs(run_dir, 1, synthetic, pixel_mean_std)
    print(f"[ucf101] BIM through cli.attack_ucf101 on I3D-R50 with its {classes}-class head "
          f"(random weights), 1 clip, {UCF_STEPS} steps, TF32 off: run directory {name}; "
          f"peak {peak:.2f} GiB; launches {counts}")
    return counts["sign_step"]


def phase_wb_family_parity(attack_cli, synthetic) -> None:
    """Tiny I3D DIFGSM (a draw that applies, the same on both: the draws come
    from a CPU generator), TIFGSM3D (the smoothed step direction), TAP (its
    four components at a generic point) and TT (kernlen 3), card vs CPU."""
    from i2v_tpu_torch import attacks
    from i2v_tpu_torch.models import get_video_model
    from i2v_tpu_torch.ops import diversity, pixel

    ds = synthetic.SyntheticAttackDataset(n_samples=2, clip_len=8, size=32)
    clips = np.stack([ds[i][0] for i in range(2)])
    labels = np.arange(2)
    clean01_np = pixel.unnormalize(torch.from_numpy(clips), channel_axis=1).numpy()
    rng = np.random.RandomState(6)
    adv01_np = np.clip(clean01_np + 0.8 * EPS * np.tanh(rng.randn(*clean01_np.shape)), 0, 1)
    adv01_np = adv01_np.astype(np.float32)
    seed = next(s for s in range(100)
                if diversity.draw(torch.Generator().manual_seed(s), 32, 36)[0])
    draw = diversity.draw(torch.Generator().manual_seed(seed), 32, 36)
    attack_cli.common.apply_matmul_precision(
        attack_cli.arg_parse(["--matmul_precision", "float32"]))
    out = {}
    for device in ("cuda", "cpu"):
        bundle = get_video_model("i3d_resnet50", device=device, tiny=True, seed=0)
        clean01 = torch.from_numpy(clean01_np).to(device)
        lab = torch.from_numpy(labels).to(device)
        di = attacks.DIFGSM(bundle)
        ti3 = attacks.TIFGSM3D(bundle)
        tap = attacks.TAP(bundle, {"kernlen": 3, "temporal_kernlen": 3})
        tt = attacks.TemporalTranslation(bundle, {"kernlen": 3, "chunk": 3, "weight": 0.5})
        c_di, g_di = di._build_grad_fn(bundle)(clean01, lab, torch.Generator().manual_seed(seed))
        c_ti, g_ti = ti3._build_grad_fn(bundle)(clean01, lab, None)
        g_ti = ti3._build_smooth_fn()(g_ti)
        c_tap, g_tap = tap._build_grad_fn(clean01)(torch.from_numpy(adv01_np).to(device), lab,
                                                   None)
        c_tt, g_tt = tt._build_grad_fn()(clean01, lab, None)
        out[device] = {"DIFGSM": (c_di, g_di), "TIFGSM3D": (c_ti, g_ti), "TAP": (c_tap, g_tap),
                       "TT": (c_tt, g_tt)}
    facts, bad = [], []
    for name in out["cpu"]:
        (ck, gk), (cc, gc) = ((c.detach().cpu().numpy(), g.cpu().numpy())
                              for c, g in (out["cuda"][name], out["cpu"][name]))
        cost_rel = float(np.max(np.abs(np.atleast_1d(ck) / np.atleast_1d(cc) - 1)))
        grad_err = float(np.abs(gk - gc).max() / np.abs(gc).max())
        facts.append(f"{name} cost {np.round(np.atleast_1d(ck), 6).tolist()} (relative "
                     f"{cost_rel:.3g}), gradient {grad_err:.3g}")
        if cost_rel > WB_COST_RTOL or grad_err > WB_GRAD_ATOL or not np.abs(gc).max() > 0:
            bad.append(name)
    print(f"[wb family parity] tiny I3D 2x8x32^2, TF32 off, card vs CPU at step 0 (TAP at a "
          f"generic point; DIFGSM at the draw {draw}; limits: cost {WB_COST_RTOL} relative, "
          f"gradient {WB_GRAD_ATOL} of max|g|): " + "; ".join(facts))
    if bad:
        raise RuntimeError(f"card and CPU disagree on tiny {bad}")


def _chunked_want(frames: int, chunk, steps: int) -> dict:
    """Launch counts of one runner call: K1 and K2 once a chunk a step, and
    K1 once more over the whole batch at the end."""
    from i2v_tpu_torch.parallel import sharded

    n_chunks = frames // sharded.snap_frame_chunk(
        sharded.resolve_frame_chunk(chunk, frames, (224, 224)), frames)
    return {"rebuild_fwd": steps * n_chunks + 1, "rebuild_bwd": steps * n_chunks,
            "sign_step": 0}


def phase_chunked_aens(kernels, image_main, synthetic, pixel_mean_std, card: str) -> dict:
    """AENS-I2V-MF at the reference's B=16 x 32 x 224^2, full width, TF32 off,
    through image_main --sharded --frame_chunk auto."""
    from i2v_tpu_torch.parallel import sharded

    argv = ["--attack_method", "AENS_I2V_MF", "--data", "synthetic", "--n_synthetic",
            str(CHUNK_CLIPS), "--batch_size", str(CHUNK_CLIPS), "--step", str(CHUNK_STEPS),
            "--step_size", "0.005", "--aens_momentum", str(AENS_MOMENTUM), "--sharded",
            "--frame_chunk", "auto", "--device", "cuda", "--matmul_precision", "float32",
            "--file_prefix", "chunked"]
    args = image_main.arg_parse(argv)
    frames = CHUNK_CLIPS * 32
    chunk = sharded.resolve_frame_chunk("auto", frames, (224, 224))
    want = _chunked_want(frames, "auto", CHUNK_STEPS)
    _, counts, peak = _run_counted(kernels, "chunked AENS", want, lambda: image_main.run(args))
    ds = synthetic.SyntheticAttackDataset(n_samples=CHUNK_CLIPS)
    for label in range(CHUNK_CLIPS):
        _check_clip(args.adv_path, label, "adv", ds, pixel_mean_std)
    costs = _costs(args.adv_path)
    _descends("chunked AENS", costs, CHUNK_CLIPS, CHUNK_STEPS)
    tp = args.throughput
    (c,) = {tuple(v) for v in costs.values()}   # one batch: every clip records its costs
    print(f"[chunked aens] AENS-I2V-MF, four full-width surrogates with 8 taps, "
          f"B={CHUNK_CLIPS} x 32 x 224^2 in one batch, {CHUNK_STEPS} steps, momentum "
          f"{AENS_MOMENTUM}, TF32 off, --frame_chunk auto = {chunk} frames "
          f"({frames // chunk} chunks a step), on {card}: peak memory {peak:.2f} GiB; "
          f"{CHUNK_STEPS / tp['last_call_s']:.4f} steps/s and "
          f"{CHUNK_CLIPS / tp['last_call_s']:.4f} clips/s ({tp['last_call_s']:.3f} s for the "
          f"call, the clean taps, the final rebuild and the first use of these shapes "
          f"included); launches {counts}; costs {np.round(c, 4).tolist()}; {CHUNK_CLIPS} "
          "artifacts in the ε-ball and [0,1]")
    return counts


def phase_chunk_equality(kernels, image_main, synthetic) -> dict:
    """ENS-I2V at B=2, full width, with --sharded and --frame_chunk 16 and
    without, at a generic modifier: the step-0 costs agree; each chunk's
    gradient is the whole-batch runner's over that chunk's frames alone (the
    same batch size, so the same cuDNN algorithms); and the chunked gradient
    is the whole batch's up to the switches of ReLU and max-pool that flip
    where cuDNN's batch-size-dependent algorithms round a pre-activation to
    the other side of 0 or of its neighbour (each moves one upstream
    gradient value whole, so the max-abs difference is printed, and the L2
    one held). The 3-step costs from the flat start are printed."""
    from i2v_tpu_torch.ops import pixel

    ds = synthetic.SyntheticAttackDataset(n_samples=EQ_CLIPS)
    videos = np.stack([ds[i][0] for i in range(EQ_CLIPS)])
    clean01 = pixel.unnormalize(torch.from_numpy(videos).cuda(), channel_axis=1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    mod = (torch.rand(EQ_CLIPS * 32, 3, 224, 224, device="cuda", generator=gen) * 2 - 1) \
        * 0.9 * EPS
    base = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--data", "synthetic",
            "--n_synthetic", str(EQ_CLIPS), "--batch_size", str(EQ_CLIPS), "--step",
            str(EQ_STEPS), "--sharded", "--device", "cuda", "--matmul_precision", "float32"]
    out, total, per_chunk = {}, {}, []
    for chunk in (None, EQ_CHUNK):
        args = image_main.arg_parse(base + ([] if chunk is None
                                            else ["--frame_chunk", str(chunk)]))
        image_main.common.apply_matmul_precision(args)
        atk = image_main.common.build_image_guided_attack(args, torch.device("cuda"))
        cost, g = atk._runner.value_and_grad(clean01, mod)
        if chunk is None:
            for i in range(0, EQ_CLIPS * 32, EQ_CHUNK):   # chunk i alone, whole
                clip, t = divmod(i, 32)
                per_chunk.append(atk._runner.value_and_grad(
                    clean01[clip:clip + 1, :, t:t + EQ_CHUNK], mod[i:i + EQ_CHUNK])[1])
        _, counts, peak = _run_counted(
            kernels, f"ENS chunk {chunk}", _chunked_want(EQ_CLIPS * 32, chunk, EQ_STEPS),
            lambda: atk(videos, list(range(EQ_CLIPS)), ["a", "b"]))
        out[chunk] = (float(cost), g, [float(atk.loss_info["a"][i]["cost"])
                                       for i in range(EQ_STEPS)], peak, counts)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del atk
    (c_w, g_w, t_w, p_w, n_w), (c_c, g_c, t_c, p_c, n_c) = out[None], out[EQ_CHUNK]
    scale = float(g_w.abs().max())
    cost_rel = abs(c_c / c_w - 1)
    chunk_err = max(float((g_k - g_c[i * EQ_CHUNK:(i + 1) * EQ_CHUNK]).abs().max()) / scale
                    for i, g_k in enumerate(per_chunk))
    diff = (g_c - g_w).abs()
    max_err = float(diff.max()) / scale
    l2_err = float(torch.linalg.vector_norm(g_c - g_w) / torch.linalg.vector_norm(g_w))
    share = float((diff > EQ_GRAD_ATOL * scale).float().mean())
    print(f"[chunk equality] ENS-I2V, four full-width surrogates, B={EQ_CLIPS} x 32 x 224^2, "
          f"TF32 off, at a modifier uniform in ±0.9ε: step-0 cost whole {c_w:.7f} vs "
          f"--frame_chunk {EQ_CHUNK} {c_c:.7f} (relative {cost_rel:.3g}, limit {EQ_COST_RTOL}); "
          f"each chunk's gradient against the whole runner over that chunk alone: max|diff|/"
          f"max|g| {chunk_err:.3g} (limit {EQ_GRAD_ATOL}); chunked against whole: "
          f"||diff||/||g|| {l2_err:.3g} (limit {EQ_L2_RTOL}), max|diff|/max|g| {max_err:.3g}, "
          f"share of elements beyond {EQ_GRAD_ATOL} of max|g| {share:.3g}; peaks {p_w:.2f} and "
          f"{p_c:.2f} GiB; launches {n_w} and {n_c}; information only: {EQ_STEPS} steps from "
          f"the flat start, whole {t_w} vs chunked {t_c}")
    if (cost_rel > EQ_COST_RTOL or chunk_err > EQ_GRAD_ATOL or l2_err > EQ_L2_RTOL
            or not scale > 0):
        raise RuntimeError("the chunked runner disagrees with the whole batch on the card")
    return total


def phase_multigrid(kernels, image_main, synthetic, pixel_mean_std) -> dict:
    """6-step ENS-I2V at B=1 with --sharded --multigrid 3: K1/K2 at 112^2 in
    the coarse phase, then at 224^2, as each phase's launches are issued
    from Python (at step 0 and at the capture of its graph)."""
    argv = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--data", "synthetic",
            "--n_synthetic", "1", "--batch_size", "1", "--step", str(MG_STEPS), "--sharded",
            "--multigrid", str(MG_COARSE), "--device", "cuda", "--matmul_precision", "float32",
            "--file_prefix", "multigrid"]
    args = image_main.arg_parse(argv)
    sides = {"rebuild_fwd": [], "rebuild_bwd": []}
    launch = {"rebuild_fwd": kernels.launch_rebuild_fwd, "rebuild_bwd": kernels.launch_rebuild_bwd}

    def recording(name):
        def wrapper(clean01, modifier, *rest):
            sides[name].append(int(modifier.shape[-1]))
            return launch[name](clean01, modifier, *rest)
        return wrapper

    coarse, fine = MG_COARSE, MG_STEPS - MG_COARSE
    # the wrappers run in Python, which a replayed step does not: each phase's
    # steps are seen at step 0 (eager) and at the capture of step 1, then
    # replayed; the launch counters (below) count every replay
    seen_c, seen_f = min(coarse, 2), min(fine, 2)
    want_sides = {"rebuild_fwd": [112] * (seen_c + 1) + [224] * (seen_f + 1),
                  "rebuild_bwd": [112] * seen_c + [224] * seen_f}
    want_counts = {"rebuild_fwd": MG_STEPS + 2, "rebuild_bwd": MG_STEPS, "sign_step": 0}
    kernels.launch_rebuild_fwd = recording("rebuild_fwd")
    kernels.launch_rebuild_bwd = recording("rebuild_bwd")
    try:
        _, counts, peak = _run_counted(kernels, "multigrid", want_counts,
                                       lambda: image_main.run(args))
    finally:
        kernels.launch_rebuild_fwd = launch["rebuild_fwd"]
        kernels.launch_rebuild_bwd = launch["rebuild_bwd"]
    if sides != want_sides:
        raise RuntimeError(f"multigrid launched K1/K2 at sides {sides}, expected {want_sides}")
    _check_clip(args.adv_path, 0, "adv", synthetic.SyntheticAttackDataset(n_samples=1),
                pixel_mean_std)
    (c,) = _costs(args.adv_path).values()
    if len(c) != MG_STEPS or not np.isfinite(c).all():
        raise RuntimeError(f"multigrid recorded costs {c}")
    print(f"[multigrid] ENS-I2V, 1 clip of 32x224^2, {MG_STEPS} steps with the first "
          f"{MG_COARSE} at 112^2, TF32 off: {MG_STEPS / args.throughput['last_call_s']:.3f} "
          f"steps/s with warm-up; peak {peak:.2f} GiB; launches {counts}, K1 at sides "
          f"{sides['rebuild_fwd']}, K2 at {sides['rebuild_bwd']}; costs "
          f"{np.round(c, 4).tolist()}; output in the ε-ball and [0,1]")
    return counts


def phase_runner_parity(image_main) -> None:
    """The tiny chunked AENS runner on the card and on the CPU from the same
    seeds: step-0 cost and gradient at a generic modifier."""
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.ops import pixel

    args = image_main.arg_parse(["--attack_method", "AENS_I2V_MF", "--tiny", "--clip_len", "4",
                                 "--aens_momentum", "0.5", "--sharded", "--frame_chunk", "2",
                                 "--step", "3", "--matmul_precision", "float32",
                                 "--file_prefix", "runner-parity"])
    image_main.common.apply_matmul_precision(args)
    ds = synthetic.SyntheticAttackDataset(n_samples=2, clip_len=4, size=32)
    clean01 = np.stack([ds.clip01(i) for i in range(2)])
    mod = ((np.random.RandomState(5).rand(8, 3, 32, 32) * 2 - 1) * 0.9 * EPS).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        atk = image_main.common.build_image_guided_attack(args, torch.device(device))
        cost, g = atk._runner.value_and_grad(torch.from_numpy(clean01).to(device),
                                             torch.from_numpy(mod).to(device))
        videos = pixel.normalize(torch.from_numpy(clean01), channel_axis=1).numpy()
        atk(videos, [0, 1], ["a", "b"])
        out[device] = (float(cost), g.cpu().numpy(),
                       [float(atk.loss_info["a"][i]["cost"]) for i in range(3)])
    (c_k, g_k, t_k), (c_c, g_c, t_c) = out["cuda"], out["cpu"]
    cost_rel = abs(c_k / c_c - 1)
    grad_err = float(np.abs(g_k - g_c).max() / np.abs(g_c).max())
    print(f"[runner parity] tiny AENS runner (8 taps, momentum 0.5, --frame_chunk 2 over 2x4 "
          f"frames of 32^2), TF32 off, at a generic modifier: step-0 cost card {c_k:.7f} vs CPU "
          f"{c_c:.7f} (relative {cost_rel:.3g}, limit {ENS_COST_RTOL}); gradient "
          f"max|diff|/max|g| {grad_err:.3g} (limit {ENS_GRAD_ATOL}); information only: 3 steps "
          f"from the flat start, card {t_k} vs CPU {t_c}")
    if cost_rel > ENS_COST_RTOL or grad_err > ENS_GRAD_ATOL or not np.abs(g_c).max() > 0:
        raise RuntimeError("card and CPU disagree on the tiny chunked AENS runner")


REAL_FRAMES = 80          # a decoded Kinetics sidecar: (80, 256, 340, 3) uint8, 20.9 MB
REAL_CLIPS = ((3, -1), (11, 5))   # (label, clip_index): the window at the end, a seeded one
REAL_STEPS = 20           # ENS-I2V at B=2 from the uint8 sidecars
REAL_TWIN_STEPS = 3       # the float32-ingest twin
REAL_FILE_SEED = 7        # the checkpoint files' weights; the CLIs draw their init from 0
REAL_UCF_FRAMES = 33      # a UCF-101 clip of 240x320 frame JPEGs
ENS_NAMES = ("resnet", "vgg", "squeezenet", "alexnet")


def _write_checkpoints(ckpt_dir: str) -> dict:
    """The four whole-network surrogates and I3D-R50, seeded, written through
    ``to_jax_params`` + ``save_params``; returns {name: (file bytes, CPU
    state dict)}."""
    import warnings

    from i2v_tpu_torch.models import get_image_models, get_video_model
    from i2v_tpu_torch.models.convert import save_params, to_jax_params

    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # these builds find no file yet, and say so
        modules = [(b.name, b.module) for b in get_image_models(
            ENS_NAMES, 2, device="cpu", truncate=False, seed=REAL_FILE_SEED)]
        modules.append(("i3d_resnet50", get_video_model("i3d_resnet50", device="cpu",
                                                        seed=REAL_FILE_SEED).module))
    for name, module in modules:
        path = save_params(to_jax_params(module), name, ckpt_dir)
        out[name] = (os.path.getsize(path), module.state_dict())
    return out


def _recorded(fn):
    """``fn()`` and the texts of the warnings it gave."""
    import warnings

    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in record]


def _h2d_ms(host: np.ndarray, iters: int = 10) -> float:
    """A pinned, non-blocking upload of ``host``, timed with CUDA events."""
    pinned = torch.from_numpy(host).pin_memory()
    pinned.to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        pinned.to("cuda", non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


CONV_SEED = 11
CONV_TAP_RTOL = 1e-4      # ResNet-101's layer2 output, the port from the converted file
                          # against the torch model it came from: ||diff|| / ||ref||. The
                          # fold W·γ/√(σ²+ε) and b' change the rounding only
CONV_LOGIT_RTOL = 1e-3    # I3D-R50's logits (five non-local blocks), the same measure


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def _tool(name: str):
    """``tools/{name}.py`` of this checkout, loaded by its path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_converters(kernels, synthetic, pixel, card: str, tmp: str) -> None:
    """The flax-free checkpoint converters at full width, float32, TF32 off:
    a seeded torchvision-named ResNet-101 (BN statistics randomized) through
    models.convert.convert_torchvision on the host, loaded through
    get_image_models(["resnet"], {"resnet": 2}) with no warning, its layer2
    tap held to the torch model's layer2[-1]; a seeded gluoncv-named I3D-R50
    with its five non-local blocks written to a .pth, converted by
    tools/torch_convert_gluoncv.py --verify in a subprocess, loaded through
    get_video_model("i3d_resnet50") with no module left at init, its logits
    held to the torch model's. No kernel runs."""
    import argparse
    import shutil

    from i2v_tpu_torch.cli import common as cli_common
    from i2v_tpu_torch.models import convert, get_image_models, get_video_model

    surrogates, fakes = _tool("torch_surrogates"), _tool("torch_gluoncv_fakes")
    gluoncv = _tool("torch_convert_gluoncv")
    t0 = time.time()
    cli_common.apply_matmul_precision(argparse.Namespace(matmul_precision="float32"))
    ckpts = os.path.join(tmp, "converted")
    saved = os.environ.get("I2V_TPU_CKPTS")
    os.environ["I2V_TPU_CKPTS"] = ckpts
    ds = synthetic.SyntheticAttackDataset(n_samples=1)
    clip01 = torch.from_numpy(ds.clip01(0)[None]).cuda()           # (1, 3, 32, 224, 224)
    facts = []
    kernels.reset_launches()
    try:
        # ResNet-101: torchvision's names, converted in this process
        torch.manual_seed(CONV_SEED)
        tm = fakes.randomize_bn(surrogates.resnet101().eval(), CONV_SEED)
        sd = tm.state_dict()
        ts = time.perf_counter()
        path = convert.convert_torchvision("resnet", sd, ckpts)
        host_s = time.perf_counter() - ts
        bundle, warned = _recorded(lambda: get_image_models(["resnet"], {"resnet": 2},
                                                            device="cuda")[0])
        warned = [w for w in warned if "random init" in w]
        if warned:
            raise RuntimeError(f"ResNet-101 from the converted file warned: {warned}")
        frames = pixel.flatten_clip_to_frames(clip01)                 # (32, 3, 224, 224)
        tm = tm.cuda()
        with torch.no_grad():
            _, taps = bundle.apply01_taps(frames)
            x = tm.maxpool(tm.relu(tm.bn1(tm.conv1(pixel.normalize(frames, channel_axis=1)))))
            want = tm.layer2(tm.layer1(x))
        tap_err = _rel_l2(taps[0], want)
        if not (tap_err <= CONV_TAP_RTOL and torch.isfinite(taps[0]).all()):
            raise RuntimeError(f"ResNet-101 layer2 tap from the converted file: relative L2 "
                               f"{tap_err} from the torch model's (limit {CONV_TAP_RTOL})")
        facts.append(f"ResNet-101 (torchvision names): convert_torchvision {host_s:.3f} s on "
                     f"the host, {os.path.getsize(path) / 2**20:.2f} MiB; loaded through "
                     f"get_image_models with no warning; layer2 tap over 32 frames relative L2 "
                     f"{tap_err:.3g} from the torch model's (limit {CONV_TAP_RTOL})")
        del bundle, tm, sd, taps, want

        # I3D-R50 with non-local blocks: gluoncv's names, through the tool's CLI
        torch.manual_seed(CONV_SEED)
        fake = fakes.randomize_bn(fakes.I3DResNet().eval(), CONV_SEED)
        pth = os.path.join(tmp, "i3d_resnet50_gluoncv.pth")
        torch.save(fake.state_dict(), pth)
        ts = time.perf_counter()
        convert.save_params(gluoncv.convert_i3d(fake.state_dict(), gluoncv.STAGES["resnet50"]),
                            "i3d_resnet50", os.path.join(ckpts, "in_process"))
        host_s = time.perf_counter() - ts
        ts = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join("tools", "torch_convert_gluoncv.py"), "--name",
             "i3d_resnet50", "--weights", pth, "--out", ckpts, "--verify"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - ts
        lines = proc.stdout.splitlines()
        path = os.path.join(ckpts, "i3d_resnet50.msgpack")
        if (proc.returncode != 0 or lines[:1] != [f"wrote {path}"]
                or not any(ln.startswith("torch logits: finite, top-5") for ln in lines)
                or any(ln.startswith("WARNING") for ln in lines)):
            raise RuntimeError(f"torch_convert_gluoncv.py --verify ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        video, warned = _recorded(lambda: get_video_model("i3d_resnet50", device="cuda"))
        warned = [w for w in warned if "random init" in w]
        missing = convert.missing_modules(video.module, convert.load_params("i3d_resnet50"))
        if warned or missing:
            raise RuntimeError(f"I3D-R50 from the converted file: warnings {warned}, "
                               f"modules at init {missing}")
        fake = fake.cuda()
        with torch.no_grad():
            got = video.apply01(clip01)
            want = fake(fakes.normalize(clip01))
        logit_err = _rel_l2(got, want)
        if not (logit_err <= CONV_LOGIT_RTOL and torch.isfinite(got).all()):
            raise RuntimeError(f"I3D-R50 logits from the converted file: relative L2 "
                               f"{logit_err} from the torch model's (limit {CONV_LOGIT_RTOL})")
        verify = next(ln for ln in lines if ln.startswith("torch logits"))
        facts.append(f"I3D-R50 with 5 non-local blocks (gluoncv names): convert_i3d + "
                     f"save_params {host_s:.3f} s on the host, "
                     f"{os.path.getsize(path) / 2**20:.2f} MiB; "
                     f"tools/torch_convert_gluoncv.py --verify {cli_s:.2f} s in its process "
                     f"({verify}); loaded through get_video_model with no module at init; "
                     f"logits relative L2 {logit_err:.3g} from the torch model's (limit "
                     f"{CONV_LOGIT_RTOL}), top-1 {int(got.argmax())} vs {int(want.argmax())}")
        del video, fake
    finally:
        if saved is None:
            os.environ.pop("I2V_TPU_CKPTS", None)
        else:
            os.environ["I2V_TPU_CKPTS"] = saved
        shutil.rmtree(ckpts, ignore_errors=True)
    if any(kernels.launches[k] for k in K1_TO_K3):
        raise RuntimeError(f"the converters launched K1-K3: {kernels.launches}")
    torch.cuda.empty_cache()
    print(f"[converters] on {card}, TF32 off: " + "; ".join(facts)
          + f"; phase wall {time.time() - t0:.2f} s")


def phase_real_data(kernels, image_main, attack_cli, attack_ucf101, evaluate_cli, pixel,
                    card: str, tmp: str) -> dict:
    """Real-format clips and checkpoint files through the CLIs at full width:
    ENS-I2V from uint8 Kinetics sidecars with --u8_ingress --prefetch 1 and
    loaded surrogates, its float32-ingest twin, BIM on the loaded I3D-R50,
    cli.evaluate over the ENS clips, and cli.attack_ucf101 over frame JPEGs
    where Pillow can write them. Returns the launch counts of its paths."""
    import shutil

    from i2v_tpu_torch.data import decode, kinetics, native, pipeline, transforms, ucf101
    from i2v_tpu_torch.models import get_video_model
    from i2v_tpu_torch.utils import artifacts

    t0 = time.time()
    root = os.path.join(tmp, "real")
    data, ckpts, empty = (os.path.join(root, d) for d in ("kinetics", "ckpts", "empty"))
    for d in (data, ckpts, empty):
        os.makedirs(d)
    frames, rows = {}, ["path,gt_label,clip_index"]
    for i, (label, clip_index) in enumerate(REAL_CLIPS):
        frames[label] = np.random.RandomState(100 + i).randint(
            0, 256, (REAL_FRAMES, 256, 340, 3), dtype=np.uint8)
        np.save(os.path.join(data, f"clip{label}.npy"), frames[label])
        rows.append(f"clip{label}.npy,{label},{clip_index}")
    anno = os.path.join(data, "anno.csv")
    with open(anno, "w") as f:
        f.write("\n".join(rows) + "\n")
    env = {"I2V_TPU_KINETICS_ANNO": anno, "I2V_TPU_KINETICS_DATA": data,
           "I2V_TPU_CKPTS": ckpts}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    totals = dict.fromkeys(COUNTED, 0)
    try:
        # -- decode backends and the host half of ingest
        backend = decode.backend()
        print(f"[real data] decode backend for video files: {backend}; the native "
              "FFmpeg/libjpeg library " + (
                  "is built" if native.available() else
                  "is not built on this machine (its g++ log is above), so no AVI is decoded "
                  "here: tests/test_torch_data.py holds native decode of avi_synth AVIs to the "
                  "JAX package's on the CPU"))
        if native.available():
            from PIL import Image

            from i2v_tpu_torch.data.avi_synth import write_mjpeg_avi

            avi = os.path.join(root, "clip.avi")
            write_mjpeg_avi(avi, [Image.fromarray(f) for f in frames[3][:8]])
            via_native = native.decode_video(avi)
            np.save(avi + ".side.npy", via_native)
            if not np.array_equal(decode.decode_video(avi), np.load(avi + ".side.npy")):
                raise RuntimeError("the native decode of an MJPEG AVI is not its own sidecar")
            print(f"[real data] MJPEG AVI of 8 frames decoded natively to {via_native.shape}, "
                  "equal to its sidecar")
        ds = {mode: kinetics.KineticsAttackDataset(anno, data, raw_uint8=mode == "uint8")
              for mode in ("float32", "uint8")}
        host_ms = {}
        for mode, d in ds.items():
            t = time.perf_counter()
            for _ in range(3):
                items = [d[i] for i in range(len(d))]
            host_ms[mode] = (time.perf_counter() - t) * 1e3 / (3 * len(d))
        batch = {mode: next(kinetics.iterate_batches(d, len(REAL_CLIPS)))
                 for mode, d in ds.items()}
        via_f32 = pixel.unnormalize(torch.from_numpy(batch["float32"]["clips"]).cuda(), 1)
        via_u8 = pixel.ingest_u8_clips(batch["uint8"]["clips"], "cuda")
        prefetched = next(pipeline.device_prefetch(iter([batch["uint8"]]), "cuda", 1))
        via_pf = pixel.ingest_u8_clips(prefetched["clips"])
        if not (torch.equal(via_u8, via_f32) and torch.equal(via_pf, via_f32)):
            raise RuntimeError("uint8 ingest on the card is not the float32 path's clean clip: "
                               f"max |diff| {float((via_u8 - via_f32).abs().max())}")
        nbytes = {m: b["clips"].nbytes for m, b in batch.items()}
        upload = {m: _h2d_ms(b["clips"]) for m, b in batch.items()}
        del via_f32, via_u8, via_pf, prefetched, items
        print(f"[real data] {card}: host decode + transform of a (80,256,340,3) sidecar to "
              f"32x224^2: {host_ms['float32']:.2f} ms a clip normalized on the host, "
              f"{host_ms['uint8']:.2f} ms a clip kept uint8; host-to-device bytes a batch of "
              f"{len(REAL_CLIPS)}: uint8 {nbytes['uint8'] / 1e6:.2f} MB, float32 "
              f"{nbytes['float32'] / 1e6:.2f} MB; pinned upload {upload['uint8']:.3f} ms "
              f"against {upload['float32']:.3f} ms; uint8 ingest on the card (direct and "
              "through device_prefetch) bit-identical to the float32 path's clean clip")

        # -- checkpoint files from seed REAL_FILE_SEED
        t = time.time()
        files = _write_checkpoints(ckpts)
        print(f"[real data] checkpoint files written with to_jax_params + save_params in "
              f"{time.time() - t:.2f} s: " + ", ".join(
                  f"{n} {size / 1e6:.1f} MB" for n, (size, _) in files.items()))

        # -- generate: ENS-I2V from uint8 sidecars, the surrogates from their files
        argv = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--data", "kinetics",
                "--batch_size", str(len(REAL_CLIPS)), "--device", "cuda",
                "--matmul_precision", "float32"]
        args = image_main.arg_parse(argv + ["--u8_ingress", "--prefetch", "1", "--step",
                                            str(REAL_STEPS), "--file_prefix", "real"])
        build, seen = image_main.common.build_image_guided_attack, {}

        def capture(*a, **k):  # the attack the CLI builds, to read its surrogates
            seen["attack"] = build(*a, **k)
            return seen["attack"]

        image_main.common.build_image_guided_attack = capture
        try:
            (_, counts, peak), msgs = _recorded(lambda: _run_counted(
                kernels, "real ENS", _want(1, REAL_STEPS), lambda: image_main.run(args)))
        finally:
            image_main.common.build_image_guided_attack = build
        if any("random init" in m for m in msgs):
            raise RuntimeError(f"a surrogate did not load its file: {msgs}")
        for b in seen["attack"].models:
            want = files[b.name][1]
            for k, v in b.module.state_dict().items():
                if not torch.equal(v.cpu(), want[k]):
                    raise RuntimeError(f"{b.name}.{k} is not the file's weight")
        costs = _costs(args.adv_path)
        _descends("real ENS", costs, len(REAL_CLIPS), REAL_STEPS)
        for k in totals:
            totals[k] += counts[k]
        twin = image_main.arg_parse(argv + ["--step", str(REAL_TWIN_STEPS),
                                            "--file_prefix", "real-f32"])
        _, twin_counts, _ = _run_counted(kernels, "real ENS twin", _want(1, REAL_TWIN_STEPS),
                                         lambda: image_main.run(twin))
        twin_costs = _costs(twin.adv_path)
        rel = max(abs(float(twin_costs[v][0]) / float(c[0]) - 1) for v, c in costs.items())
        if rel > ENS_COST_RTOL:
            raise RuntimeError(f"step-0 costs of the uint8 and float32 runs differ by {rel:.3g}")
        for k in totals:
            totals[k] += twin_counts[k]
        for label, _ in REAL_CLIPS:
            adv = np.load(os.path.join(args.adv_path, f"{label}-adv.npy"))
            if adv.shape != (3, 32, 224, 224) or not np.isfinite(adv).all():
                raise RuntimeError(f"{label}-adv.npy: {adv.dtype} {adv.shape}")
        tp = args.throughput
        print(f"[real data] {card}: ENS-I2V from 2 uint8 Kinetics sidecars (--u8_ingress "
              f"--prefetch 1, B=2), the four surrogates loaded from their files, {REAL_STEPS} "
              f"steps, TF32 off: {REAL_STEPS / tp['last_call_s']:.3f} steps/s "
              f"({tp['last_call_s']:.3f} s for the batch, warm-up included); peak "
              f"{peak:.2f} GiB; launches {counts}; no random-init warning; costs "
              + "; ".join(f"{v}: {c[0]:.4f} -> {c[-1]:.4f}" for v, c in costs.items())
              + f"; float32-ingest twin ({REAL_TWIN_STEPS} steps after the warm-up: "
              f"{REAL_TWIN_STEPS / twin.throughput['last_call_s']:.3f} steps/s, launches "
              f"{twin_counts}): step-0 cost relative difference {rel:.3g} "
              f"(limit {ENS_COST_RTOL})")

        # -- attack: BIM on the loaded I3D-R50
        wb = attack_cli.arg_parse(["--model", "i3d_resnet50", "--attack_method", "BIM",
                                   "--step", str(WB_STEPS), "--data", "kinetics",
                                   "--u8_ingress", "--prefetch", "1", "--batch_size", "1",
                                   "--device", "cuda", "--matmul_precision", "float32",
                                   "--file_prefix", "real"])
        (_, wb_counts, wb_peak), msgs = _recorded(lambda: _run_counted(
            kernels, "real BIM", _wb_want(len(REAL_CLIPS), WB_STEPS),
            lambda: attack_cli.run(wb)))
        if any("random init" in m for m in msgs):
            raise RuntimeError(f"I3D-R50 did not load its file: {msgs}")
        ce = _loss_costs(wb)
        _rises("real BIM", ce, len(REAL_CLIPS), WB_STEPS)
        for label, clip_index in REAL_CLIPS:
            idx = transforms.kinetics_clip_indices(REAL_FRAMES, clip_index, 32)
            want = transforms.kinetics_val_transform(frames[label][idx])
            if not np.array_equal(np.load(os.path.join(wb.adv_path, f"{label}-ori.npy")), want):
                raise RuntimeError(f"{label}-ori.npy is not the host transform of its sidecar")
        for k in totals:
            totals[k] += wb_counts[k]
        wtp = wb.throughput
        print(f"[real data] {card}: BIM on the loaded I3D-R50, 2 uint8 Kinetics clips at B=1 "
              f"through --prefetch 1, {WB_STEPS} steps, TF32 off: "
              f"{WB_STEPS / wtp['last_call_s']:.3f} steps/s for the last clip; peak "
              f"{wb_peak:.2f} GiB; launches {wb_counts}; CE "
              + "; ".join(f"{v}: {c[0]:.4f} -> {c[-1]:.4f}" for v, c in ce.items())
              + "; each -ori.npy bit-identical to the host transform of its sidecar")

        # -- evaluate: I3D-R50 from its file, the other five at random init
        ev = evaluate_cli.arg_parse(["--adv_path", args.adv_path, "--device", "cuda",
                                     "--matmul_precision", "float32"])
        acc, msgs = _recorded(lambda: evaluate_cli.run(ev))
        warned = sorted(m.split("'")[1] for m in msgs if m.startswith("no converted checkpoint"))
        others = sorted(set(acc) - {"i3d_resnet50"})
        if warned != others or len(others) != 5:
            raise RuntimeError(f"evaluate: random-init warnings for {warned}, expected {others}")
        files_adv = artifacts.list_adv_files(args.adv_path)
        clips, labels = artifacts.load_adv_batch(args.adv_path, files_adv)
        x = torch.from_numpy(clips).cuda()
        loaded = get_video_model("i3d_resnet50", device="cuda")
        os.environ["I2V_TPU_CKPTS"] = empty
        (direct, _) = _recorded(lambda: get_video_model("i3d_resnet50", device="cuda",
                                                        seed=REAL_FILE_SEED))
        with torch.no_grad():
            logits, want_logits = loaded.apply_norm(x), direct.apply_norm(x)
        if not torch.equal(logits, want_logits):
            raise RuntimeError("the loaded I3D-R50's logits are not those of the seed it was "
                               f"saved from: max |diff| {float((logits - want_logits).abs().max())}")
        with open(os.path.join(args.adv_path, "results_all_models_prediction.csv")) as f:
            table = [r.split(",") for r in f.read().split("\n")]
        col = table[0].index("i3d_resnet50-pre")
        argmax = logits.argmax(-1).cpu().tolist()
        got = [int(table[1 + int(lab)][col]) for lab in labels]
        if got != argmax:
            raise RuntimeError(f"the CSV's I3D-R50 column {got} is not the logits' argmax {argmax}")
        del loaded, direct, x
        print(f"[real data] cli.evaluate over the ENS clips: I3D-R50 loaded its file (its logits "
              f"bit-identical to a seed-{REAL_FILE_SEED} I3D-R50 built on this card, CSV column "
              f"{got} = their argmax); {', '.join(warned)} warned of random init; top-1 {acc}")

        # -- UCF-101 frame JPEGs, where Pillow can write them
        try:
            from PIL import Image
        except ImportError:
            Image = None
            print("[real data] Pillow is not installed here: no frame JPEGs are written and "
                  "cli.attack_ucf101 --data ucf101 does not run (tests/test_torch_attack_cli.py "
                  "covers it on the CPU)")
        if Image is not None:
            clip_dir = os.path.join(root, "ucf", "v_Smoke_g01_c01")
            os.makedirs(clip_dir)
            rng = np.random.RandomState(200)
            for i in range(1, REAL_UCF_FRAMES + 1):
                Image.fromarray(rng.randint(0, 256, (240, 320, 3), dtype=np.uint8)).save(
                    os.path.join(clip_dir, f"image_{i:05d}.jpg"))
            setting = os.path.join(root, "ucf", "setting.txt")
            with open(setting, "w") as f:
                f.write(f"v_Smoke_g01_c01 {REAL_UCF_FRAMES} 42\n")
            os.environ.update({"I2V_TPU_UCF_SETTING": setting,
                               "I2V_TPU_UCF_IMAGE_ROOT": os.path.dirname(clip_dir),
                               "I2V_TPU_UCF_USED_IDXS": os.path.join(root, "absent.pkl")})
            try:
                ucf_argv = _wb_argv("BIM", 1, UCF_STEPS)
                ucf_argv[ucf_argv.index("synthetic")] = "ucf101"
                ucf_dir, ucf_counts, ucf_peak = _run_counted(
                    kernels, "real ucf101", _wb_want(1, UCF_STEPS),
                    lambda: attack_ucf101.main(ucf_argv + ["--u8_ingress", "--file_prefix",
                                                           "real"]))
            finally:
                for k in ("I2V_TPU_UCF_SETTING", "I2V_TPU_UCF_IMAGE_ROOT",
                          "I2V_TPU_UCF_USED_IDXS"):
                    os.environ.pop(k)
            want = ucf101.UCF101AttackDataset(setting, os.path.dirname(clip_dir))[0][0]
            if not np.array_equal(np.load(os.path.join(ucf_dir, "42-ori.npy")), want):
                raise RuntimeError("the UCF-101 -ori.npy is not the host transform of its JPEGs")
            for k in totals:
                totals[k] += ucf_counts[k]
            print(f"[real data] cli.attack_ucf101 --data ucf101 --u8_ingress over "
                  f"{REAL_UCF_FRAMES} Pillow-written 240x320 frame JPEGs (decoded by "
                  f"{'the native library' if native.available() else 'Pillow'}): "
                  f"{UCF_STEPS} BIM steps on the 101-class I3D-R50, peak {ucf_peak:.2f} GiB, "
                  f"launches {ucf_counts}; -ori.npy bit-identical to the host transform")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(ckpts, ignore_errors=True)
    print(f"[real data] launches over the phase's paths {totals}; phase wall "
          f"{time.time() - t0:.2f} s")
    return totals


ZOO_STEPS = 5             # I2V on DenseNet-161 and DR on ViT-B/16, one clip each
ZOO_RUNS = (("I2V on DenseNet-161", "densenet", "ImageGuidedFMDirection_Adam", 3),
            ("DR on ViT-B/16", "vit", "ImageGuidedStd_Adam", 4))
# tiny Grad-CAM card vs CPU, TF32 off: maps are min-max scaled into [0, 1], and
# the card and the CPU differ only in the order of their float32 sums
CAM_ATOL = 1e-4
ZOO_FILE_SEED = 11        # the densenet/vit checkpoint files' weights
GRID_STEPS = 2


def _zoo_parity(image_main) -> list:
    """Tiny DenseNet I2V and ViT DR on the card and on the CPU from the same
    seed: step-0 cost and gradient at a generic modifier; then tiny grad_cam
    (DenseNet and ResNet at 64², untruncated) card vs CPU."""
    from i2v_tpu_torch.attacks import i2v
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.eval import gradcam
    from i2v_tpu_torch.models import get_image_models
    from i2v_tpu_torch.ops import kernels, pixel

    facts = []
    clip01 = synthetic.SyntheticAttackDataset(n_samples=1, clip_len=4, size=32).clip01(0)
    mod = ((np.random.RandomState(9).rand(4, 3, 32, 32) * 2 - 1) * EPS).astype(np.float32)
    for label, name, method, depth in ZOO_RUNS:
        args = image_main.arg_parse(["--attack_method", method, "--direction_image_model", name,
                                     "--depth", str(depth), "--tiny", "--clip_len", "4",
                                     "--matmul_precision", "float32",
                                     "--file_prefix", f"zoo-parity-{name}"])
        image_main.common.apply_matmul_precision(args)
        step0 = {}
        for device in ("cuda", "cpu"):
            atk = image_main.common.build_image_guided_attack(args, torch.device(device))
            frames = pixel.flatten_clip_to_frames(torch.from_numpy(clip01[None]).to(device))
            with torch.no_grad():
                loss_fn = atk._make_loss(i2v._collect_taps(atk.models, frames))
            m = torch.from_numpy(mod).to(device).requires_grad_(True)
            cost, _ = loss_fn(kernels.rebuild_adv(frames, m, EPS), atk._state0())
            (g,) = torch.autograd.grad(cost, m)
            step0[device] = (float(cost.detach()), g.cpu().numpy())
        (c_k, g_k), (c_c, g_c) = step0["cuda"], step0["cpu"]
        cost_rel = abs(c_k / c_c - 1)
        grad_err = float(np.abs(g_k - g_c).max() / np.abs(g_c).max())
        facts.append(f"tiny {label.split(' on ')[0]} {name} step-0 cost card {c_k:.7f} vs CPU "
                     f"{c_c:.7f} (relative {cost_rel:.3g}, limit {ENS_COST_RTOL}), gradient "
                     f"{grad_err:.3g}·max|g| (limit {ENS_GRAD_ATOL})")
        if cost_rel > ENS_COST_RTOL or grad_err > ENS_GRAD_ATOL or not np.abs(g_c).max() > 0:
            raise RuntimeError(f"card and CPU disagree on the tiny {name} cost or gradient: "
                               + facts[-1])
    x = np.random.RandomState(10).rand(4, 3, 64, 64).astype(np.float32)
    for name in ("densenet", "resnet"):
        cams = {}
        for device in ("cuda", "cpu"):
            (b,) = get_image_models([name], 4, device=device, tiny=True, truncate=False,
                                    input_hw=64)
            cams[device] = gradcam.grad_cam(b, torch.from_numpy(x).to(device),
                                            upsample_to=64).cpu().numpy()
        err = float(np.abs(cams["cuda"] - cams["cpu"]).max())
        facts.append(f"tiny {name} grad_cam card vs CPU max|diff| {err:.3g} (limit {CAM_ATOL})")
        if not err <= CAM_ATOL or not cams["cpu"].max() > 0:
            raise RuntimeError(f"card and CPU disagree on the tiny {name} Grad-CAM: {err}")
    return facts


def _zoo_checkpoints(ckpt_dir: str) -> list:
    """densenet.msgpack and vit.msgpack written from seeded full-width weights
    by save_params, reloaded through the registry: logits bit for bit."""
    import warnings

    from i2v_tpu_torch.models import get_image_models
    from i2v_tpu_torch.models.convert import save_params, to_jax_params

    facts, saved = [], os.environ.get("I2V_TPU_CKPTS")
    x = torch.from_numpy(np.random.RandomState(12).rand(2, 3, 224, 224).astype(np.float32))
    try:
        for name in ("densenet", "vit"):
            os.environ["I2V_TPU_CKPTS"] = os.path.join(ckpt_dir, "none")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # no file yet, and it says so
                (direct,) = get_image_models([name], 4, device="cuda", truncate=False,
                                             seed=ZOO_FILE_SEED)
            t0 = time.time()
            path = save_params(to_jax_params(direct.module), name, ckpt_dir)
            write_s = time.time() - t0
            os.environ["I2V_TPU_CKPTS"] = ckpt_dir
            t0 = time.time()
            (loaded, msgs) = _recorded(lambda: get_image_models([name], 4, device="cuda",
                                                                truncate=False))
            load_s = time.time() - t0
            if msgs:
                raise RuntimeError(f"{name}: loading {path} warned {msgs}")
            with torch.no_grad():
                want, got = direct.apply01(x.cuda()), loaded[0].apply01(x.cuda())
            if not torch.equal(got, want):
                raise RuntimeError(f"{name}: the loaded file's logits are not its seed's: max "
                                   f"|diff| {float((got - want).abs().max())}")
            facts.append(f"{name}.msgpack {os.path.getsize(path) / 1e6:.1f} MB written in "
                         f"{write_s:.2f} s, loaded through the registry in {load_s:.2f} s, "
                         "logits bit-identical")
            os.remove(path)
            del direct, loaded
    finally:
        if saved is None:
            os.environ.pop("I2V_TPU_CKPTS", None)
        else:
            os.environ["I2V_TPU_CKPTS"] = saved
    return facts


def phase_zoo_gradcam(kernels, image_main, synthetic, get_bundle, pixel_mean_std,
                      tmp: str) -> dict:
    """DenseNet-161 and ViT-B/16 as surrogates, Grad-CAM, the report and the
    grid, at full width: 5-step I2V on DenseNet-161 (depth 3) and DR on
    ViT-B/16 (depth 4, all 12 blocks) over one clip through image_main, each
    twice (the second warm), K1/K2 6/5 a run; cli.gradcam with the five CAM
    models over the I2V clip; tiny card-vs-CPU parity; checkpoint files of
    the two new surrogates; cli.evaluate → cli.report on the I2V run; and
    cli.run_grid layer_ablation --limit 1. Returns the launch counts of its
    paths."""
    from i2v_tpu_torch.cli import evaluate as evaluate_cli
    from i2v_tpu_torch.cli import gradcam as gradcam_cli
    from i2v_tpu_torch.cli import report as report_cli
    from i2v_tpu_torch.cli import run_grid

    t0 = time.time()
    totals = dict.fromkeys(COUNTED, 0)
    facts = []

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    try:
        ds = synthetic.SyntheticAttackDataset(n_samples=1)
        runs = {}
        for label, name, method, depth in ZOO_RUNS:
            timing = []
            for twin in ("", "-warm"):
                args = image_main.arg_parse([
                    "--attack_method", method, "--direction_image_model", name, "--depth",
                    str(depth), "--data", "synthetic", "--n_synthetic", "1", "--batch_size", "1",
                    "--step", str(ZOO_STEPS), "--device", "cuda", "--matmul_precision", "float32",
                    "--file_prefix", name + twin])
                _, counts, peak = _run_counted(kernels, label, _want(1, ZOO_STEPS),
                                               lambda: image_main.run(args))
                add(counts)
                _check_clip(args.adv_path, 0, "adv", ds, pixel_mean_std)
                costs = _costs(args.adv_path)
                _descends(label, costs, 1, ZOO_STEPS)
                timing.append((ZOO_STEPS / args.throughput["last_call_s"], peak, costs))
                runs.setdefault(name, args.adv_path)
            (cold, _, costs), (warm, peak, _) = timing
            c = costs["synthetic_0"]
            facts.append(f"{label} (depth {depth}), 1 clip of 32x224^2, {ZOO_STEPS} steps, TF32 "
                         f"off: warm {warm:.3f} steps/s (cold {cold:.3f}), peak {peak:.2f} GiB, "
                         f"launches {counts} a run; step-0 cost {c[0]:.6f} -> {c[-1]:.6f}")

        # -- Grad-CAM with the five CAM models at full width over the I2V clip
        cam_dir = runs["densenet"] + "-cam"
        try:
            import PIL  # noqa: F401
            png = ["--save_png", "1"]
        except ImportError:
            png = []
        built = {}
        get_models = gradcam_cli.get_image_models

        def capture(*a, **k):  # the CLI's bundles, for a warm timing after it
            built["bundles"] = get_models(*a, **k)
            return built["bundles"]

        gradcam_cli.get_image_models = capture
        try:
            gargv = ["--used_adv", runs["densenet"], "--device", "cuda",
                     "--matmul_precision", "float32", "--out", cam_dir, *png]
            t1 = time.time()
            _, counts, cam_peak = _run_counted(kernels, "gradcam", {k: 0 for k in K1_TO_K3},
                                               lambda: gradcam_cli.main(gargv))
            cam_wall = time.time() - t1
        finally:
            gradcam_cli.get_image_models = get_models
        mask = np.load(os.path.join(cam_dir, "0-cam.npy"))
        if (mask.shape != (32, 224, 224) or mask.dtype != np.float16
                or not np.isfinite(mask).all() or mask.min() < 0 or mask.max() > 1
                or not mask.max() > 0):
            raise RuntimeError(f"0-cam.npy: {mask.dtype} {mask.shape}, range "
                               f"[{mask.min()}, {mask.max()}]")
        if png and not os.path.exists(os.path.join(cam_dir, "0-f0.png")):
            raise RuntimeError("cli.gradcam --save_png 1 wrote no 0-f0.png")
        clips, _ = gradcam_cli.artifacts.load_adv_batch(runs["densenet"], ["0-adv.npy"])
        fns = gradcam_cli._cam_fns(built["bundles"])
        torch.cuda.synchronize()
        t1 = time.time()
        gradcam_cli.average_cam_for_clips(clips, fns, 224, "cuda")
        torch.cuda.synchronize()
        warm_s = time.time() - t1
        del fns, built["bundles"]
        facts.append(f"cli.gradcam, {len(gradcam_cli.CAM_MODELS)} full-width CAM models at "
                     f"depth 4, batch 1: {cam_wall:.2f} s with the model builds, warm "
                     f"{1 / warm_s:.4f} clips/s ({warm_s:.3f} s a clip), peak {cam_peak:.2f} "
                     f"GiB; mask (32, 224, 224) float16 in [{float(mask.min())}, "
                     f"{float(mask.max())}], mean {float(mask.astype(np.float32).mean()):.4f}; "
                     f"{'0-f0.png written' if png else 'no Pillow: no PNG'}; launches {counts}")

        facts += _zoo_parity(image_main)
        facts += _zoo_checkpoints(os.path.join(tmp, "zoo-ckpts"))

        # -- cli.evaluate -> cli.report on the I2V run
        ev = evaluate_cli.arg_parse(["--adv_path", runs["densenet"], "--device", "cuda",
                                     "--matmul_precision", "float32"])
        acc, counts, _ = _run_counted(kernels, "evaluate", {k: 0 for k in K1_TO_K3},
                                      lambda: evaluate_cli.run(ev, get_bundle=get_bundle))
        table = report_cli.main(["--runs", runs["densenet"], "--format", "markdown"])
        lines = table.split("\n")
        names = sorted(acc)
        row = [os.path.basename(runs["densenet"])] + [str(round(100.0 - acc[n], 2))
                                                     for n in names]
        if lines[0] != "| run | " + " | ".join(names) + " |" or lines[2] != \
                "| " + " | ".join(row) + " |" or len(lines) != 3:
            raise RuntimeError(f"cli.report's table is off: {table!r}")
        facts.append(f"cli.evaluate (six full-width video models) -> cli.report: {lines[2]}")

        # -- cli.run_grid layer_ablation --limit 1, its evaluation on the phase's models
        main_eval = evaluate_cli.main
        evaluate_cli.main = lambda argv: evaluate_cli.run(evaluate_cli.arg_parse(argv),
                                                          get_bundle=get_bundle)
        try:
            _, counts, _ = _run_counted(kernels, "run_grid", _want(1, GRID_STEPS), lambda: (
                run_grid.main(["layer_ablation", "--limit", "1", "--step", str(GRID_STEPS),
                               "--n_synthetic", "1", "--device", "cuda",
                               "--matmul_precision", "float32"])))
        finally:
            evaluate_cli.main = main_eval
        add(counts)
        grid_dir = os.path.join(os.environ["I2V_TPU_OPT_PATH"],
                                f"Image-ImageGuidedFMDirection_Adam-{GRID_STEPS}"
                                "-synthetic-layers_resnet_1")
        for f in ("0-adv.npy", REPORT_CSV, REPORT_JSON):
            if not os.path.exists(os.path.join(grid_dir, f)):
                raise RuntimeError(f"cli.run_grid wrote no {f} in {grid_dir}")
        facts.append(f"cli.run_grid layer_ablation --limit 1 --step {GRID_STEPS}: "
                     f"{os.path.basename(grid_dir)} generated and evaluated, launches {counts}")
    finally:
        print("[zoo+gradcam] " + "; ".join(facts) + f"; launches over the phase's paths "
              f"{totals}; phase wall {time.time() - t0:.2f} s")
    return totals


# The "bf16" phase. Bounds, from the CPU tests (tests/test_torch_bf16.py): a
# tiny video model in bfloat16 is 0.45-0.93% (relative L2) off its float32
# twin's logits through ~20 convs, ~0.2% a conv as the roundings add up in
# quadrature; ResNet-101 depth puts ~100 convs in a model, so ~2% is
# expected at full width, and twice that is held: for the logits and every
# stage of SlowFast and TPN, and for I3D's first stage. I3D's later stages
# follow its five non-local blocks, whose softmax over T·H·W tokens takes
# logits θφᵀ that random weights without BN make large, so bf16's rounding
# of θ and φ moves the attention weights far more than it moves a conv's
# output (the JAX block computes in the same dtypes; the CPU tests hold the
# port's to it bit for bit). On an H100 80GB HBM3 at 700 W, I3D-R50's bf16
# logits are 10.2% off (res_layer1 0.49%, res_layer2 5.4%, res_layer3 17.6%;
# PERF.md §6). Past those blocks the phase holds the output only
# against a broken path: two unrelated outputs are ~√2 apart, a zeroed one 1.
BF16_CLIPS, BF16_STEPS = 16, 3
BF16_LOGITS_L2 = 0.05     # relative L2 of a bf16 output vs float32, as above
BF16_NL_L2 = 0.5          # I3D's logits and stages after a non-local block
I3D_PRE_NL = ("res_layer1",)
BF16_COST_RTOL = 1e-2     # bf16 ENS step-0 cost vs f32 at B=2 and a generic modifier;
                          # the tiny CPU runner's differ by 1.2e-5 at the flat start
# AENS-I2V-MF at B=16, the 256-frame auto chunk, TF32 off, with a float32 first
# moment: the peak `tools/torch_eval_profile.py --attacks --frame_chunk 256`
# measured on an H100 80GB HBM3 at 700 W (PERF.md §5)
F32_MU_PEAK_GIB = 44.87


def _nl_logit_scale(bundle, clip) -> list:
    """(max |θφᵀ|, std) of each non-local block's attention logits in one
    forward of ``bundle`` over ``clip``, recomputed from the block's input."""
    from i2v_tpu_torch.models.video_common import NonLocal3D, max_pool_hw2

    out = []

    def hook(mod, inp, _):
        x = inp[0]
        theta, phi = mod.theta(x), mod.phi(x)
        if mod.sub_sample:
            phi = max_pool_hw2(phi)
        b, c = theta.shape[:2]
        a = torch.matmul(theta.reshape(b, c, -1).transpose(1, 2).float(),
                         phi.reshape(b, c, -1).float())
        out.append((float(a.abs().max()), float(a.std())))

    hooks = [m.register_forward_hook(hook) for m in bundle.module.modules()
             if isinstance(m, NonLocal3D)]
    try:
        with torch.inference_mode():
            bundle.apply_norm(clip)
    finally:
        for h in hooks:
            h.remove()
    return out


def phase_bf16(kernels, evaluate_cli, synthetic, pixel, card: str, tmp: str) -> dict:
    """bfloat16 at full width: 3-step ENS-I2V at B=16 x 32 x 224^2 with the four
    surrogates computing and storing their weights in bf16 (the runner's
    library call; "auto" resolves to the whole batch), its step-0 cost held to
    the float32 runner's at B=2; the six video models in bf16 over its 16
    artifacts through cli.evaluate --bf16 --single_pass, then the float32 twin
    (TF32 off), their logits compared; 3-step AENS-I2V-MF at B=16 with a bf16
    first moment (mu_dtype). Returns the launch counts of the runner calls."""
    import argparse

    from i2v_tpu_torch.cli import common as cli_common
    from i2v_tpu_torch.models import get_image_models, get_video_model
    from i2v_tpu_torch.parallel import sharded
    from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES, artifacts

    t0 = time.time()
    bf16, f32 = torch.bfloat16, torch.float32
    facts, totals = [], dict.fromkeys(COUNTED, 0)
    tf32_off = argparse.Namespace(matmul_precision="float32")
    cli_common.apply_matmul_precision(tf32_off)
    ds = synthetic.SyntheticAttackDataset(n_samples=BF16_CLIPS)
    clean01 = torch.from_numpy(np.stack([ds.clip01(i) for i in range(BF16_CLIPS)])).cuda()
    t, hw = ds.clip_len, ds.size
    ens = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}

    # -- ENS-I2V at B=16 in bf16, and its step-0 cost against float32's at B=2
    tb = time.time()
    surr16 = get_image_models(list(ens), ens, device="cuda", dtype=bf16)
    surr32 = get_image_models(list(ens), ens, device="cuda")
    build_s = time.time() - tb
    dt = sharded.compute_dtype_of(surr16)
    chunk = sharded.resolve_frame_chunk("auto", BF16_CLIPS * t, (hw, hw), dt)
    if dt != bf16 or chunk is not None:
        raise RuntimeError(f"a bf16 ensemble resolves to {dt}, chunk {chunk}: expected whole")
    runner = sharded.make_sharded_i2v_runner(surr16, steps=BF16_STEPS, step_size=0.005,
                                             frame_chunk="auto", param_dtype=bf16)
    runner(clean01)                                  # first use of the shapes
    torch.cuda.synchronize()
    want = {"rebuild_fwd": BF16_STEPS * 1 + 1, "rebuild_bwd": BF16_STEPS * 1, "sign_step": 0}

    def timed_call():
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = runner(clean01)
        torch.cuda.synchronize()
        return out, time.perf_counter() - ts

    ((adv01, costs), wall), counts, peak = _run_counted(kernels, "bf16 ENS", want, timed_call)
    for k in totals:
        totals[k] += counts[k]
    costs = costs.cpu().numpy()
    if not (np.isfinite(costs).all() and costs[-1] < costs[0]):
        raise RuntimeError(f"bf16 ENS: the cost did not fall after step 0: {costs}")
    if float((adv01 - clean01).abs().max()) > EPS + 1e-5 or adv01.min() < 0 or adv01.max() > 1:
        raise RuntimeError("bf16 ENS: an adversarial clip left the ε-ball or [0,1]")
    gen = torch.Generator().manual_seed(21)
    mod = ((torch.rand(2 * t, 3, hw, hw, generator=gen) * 2 - 1) * 0.9 * EPS).cuda()
    c16, _ = sharded.make_sharded_i2v_runner(surr16, steps=1, param_dtype=bf16) \
        .value_and_grad(clean01[:2], mod)
    c32, _ = sharded.make_sharded_i2v_runner(surr32, steps=1).value_and_grad(clean01[:2], mod)
    c16, c32 = float(c16), float(c32)
    if not abs(c16 - c32) <= BF16_COST_RTOL * abs(c32):
        raise RuntimeError(f"bf16 ENS step-0 cost {c16} vs float32's {c32} at B=2: beyond "
                           f"rtol {BF16_COST_RTOL}")
    facts.append(
        f"ENS-I2V bf16 (compute and storage) at B={BF16_CLIPS} x {t} x {hw}^2, {BF16_STEPS} "
        f"steps, frame_chunk auto = whole ({dt}): {BF16_STEPS / wall:.4f} steps/s and "
        f"{BF16_CLIPS / wall:.4f} clips/s ({wall:.3f} s for the warm call, the clean taps and "
        f"the final rebuild included), peak {peak:.2f} GiB, launches {counts} = steps·chunks+1"
        f"/steps·chunks; costs {np.round(costs, 4).tolist()}; step-0 cost at B=2 and a "
        f"generic modifier {c16:.6f} vs float32's {c32:.6f} (rel "
        f"{abs(c16 - c32) / abs(c32):.2e}, bound {BF16_COST_RTOL}); surrogates built in "
        f"{build_s:.2f} s")
    del surr16, surr32, runner
    torch.cuda.empty_cache()
    run_dir = os.path.join(tmp, "bf16_ens")
    adv = pixel.normalize(adv01, channel_axis=1).cpu().numpy()
    for label in range(BF16_CLIPS):
        artifacts.save_adv_clip(run_dir, label, adv[label])
    del adv01, adv

    # -- the six video models, bf16 and float32, through cli.evaluate --single_pass
    tb = time.time()
    models = {d: {n: get_video_model(n, device="cuda", dtype=d)
                  for n in VIDEO_MODEL_NAMES} for d in (bf16, f32)}
    build_s = time.time() - tb
    tp, reports = {}, {}
    for d, flags in ((bf16, ["--bf16"]), (f32, ["--matmul_precision", "float32"])):
        argv = ["--adv_path", run_dir, "--device", "cuda", "--single_pass"] + flags
        evaluate_cli.run(evaluate_cli.arg_parse(argv), get_bundle=models[d].get)  # warm-up
        args = evaluate_cli.arg_parse(argv)
        _, counts, peak = _run_counted(kernels, f"evaluate {d}", {k: 0 for k in K1_TO_K3},
                                       lambda: evaluate_cli.run(args, get_bundle=models[d].get))
        tp[d] = (args.throughput["single_pass"], peak)
        with open(os.path.join(run_dir, REPORT_CSV)) as f:
            reports[d] = [row.split(",") for row in f.read().split("\n")[1:1 + BF16_CLIPS]]
    names = list(VIDEO_MODEL_NAMES)
    agree = {n: sum(r16[i + 1] == r32[i + 1] for r16, r32 in zip(reports[bf16], reports[f32]))
             / BF16_CLIPS for i, n in enumerate(names)}
    clips, _ = artifacts.load_adv_batch(run_dir, artifacts.list_adv_files(run_dir))
    clips = torch.from_numpy(clips).cuda()
    cli_common.apply_matmul_precision(tf32_off)
    rel, rel_taps = {}, {}
    with torch.inference_mode():
        for n in names:
            l16, t16 = models[bf16][n].module(clips, normalize=False)
            l32, t32 = models[f32][n].module(clips, normalize=False)
            rel[n] = float((l16 - l32).norm() / l32.norm())
            rel_taps[n] = {k: float((t16[k].float() - t32[k]).norm() / t32[k].norm())
                           for k in t32}
        del l16, t16, l32, t32
        scale = _nl_logit_scale(models[f32]["i3d_resnet50"], clips[:1])
    print("[bf16] relative L2, bf16 vs float32, of each stage's output: " + "; ".join(
        f"{n}: " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()) for n, r in rel_taps.items())
        + "; I3D-R50's non-local attention logits θφᵀ on one clip, max |·| (std) a block: "
        + ", ".join(f"{m:.3e} ({sd:.3e})" for m, sd in scale))
    for n in names:
        for k, v in [("logits", rel[n])] + list(rel_taps[n].items()):
            bound = BF16_NL_L2 if n.startswith("i3d") and k not in I3D_PRE_NL \
                else BF16_LOGITS_L2
            if not v <= bound:
                raise RuntimeError(f"{n} {k}: bf16 off float32 by {v} (relative L2), beyond "
                                   f"{bound}")
    facts.append(
        f"six video models at full width ({BF16_CLIPS} artifacts, B=16, single pass, built "
        f"in {build_s:.2f} s): bf16 {tp[bf16][0]['clips_per_sec']:.3f} clips/s, peak "
        f"{tp[bf16][1]:.2f} GiB; float32 (TF32 off) {tp[f32][0]['clips_per_sec']:.3f} "
        f"clips/s, peak {tp[f32][1]:.2f} GiB; logits relative L2 bf16 vs float32 "
        + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
        + f" (bound {BF16_LOGITS_L2}, I3D's {BF16_NL_L2}); top-1 agreement (printed, random "
        "weights) "
        + ", ".join(f"{n} {v:.3f}" for n, v in agree.items()))
    del models, clips
    torch.cuda.empty_cache()

    # -- ViT-B/16's bf16 logits with and without cuBLAS's bf16 reduced-precision
    # reductions (the CLIs turn them off), each against float32 (TF32 off)
    vit = {d: get_image_models(["vit"], 4, device="cuda", truncate=False, dtype=d)[0]
           for d in (bf16, f32)}
    frames = clean01[0].transpose(0, 1)                    # the 32 frames of clip 0
    vit_rel = {}
    with torch.inference_mode():
        cli_common.apply_matmul_precision(tf32_off)
        l32 = vit[f32].apply01(frames)
        for reduced in (False, True):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
            vit_rel[reduced] = float((vit[bf16].apply01(frames) - l32).norm() / l32.norm())
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    facts.append(f"ViT-B/16 bf16 logits over {t} frames, relative L2 vs float32: "
                 f"{vit_rel[False]:.4e} with bf16 reduced-precision reductions off (the "
                 f"CLIs' setting), {vit_rel[True]:.4e} with them on (torch's default)")
    del vit, l32

    # -- AENS-I2V-MF at B=16 with a bf16 first moment (mu_dtype), float32 compute
    cli_common.apply_matmul_precision(tf32_off)
    aens = {n: [2, 3] for n in ens}
    surr = get_image_models(list(aens), aens, device="cuda")
    runner = sharded.make_sharded_i2v_runner(surr, steps=BF16_STEPS, step_size=0.005,
                                             adaptive=True, aens_momentum=AENS_MOMENTUM,
                                             frame_chunk="auto", mu_dtype=bf16,
                                             opt_state_io=True)
    n_chunks = BF16_CLIPS * t // sharded.snap_frame_chunk(
        sharded.resolve_frame_chunk("auto", BF16_CLIPS * t, (hw, hw)), BF16_CLIPS * t)
    want = {"rebuild_fwd": BF16_STEPS * n_chunks + 1, "rebuild_bwd": BF16_STEPS * n_chunks,
            "sign_step": 0}
    ts = time.perf_counter()
    (adv01, costs, (count, mu, _)), counts, peak = _run_counted(
        kernels, "mu_dtype AENS", want, lambda: runner(clean01))
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    for k in totals:
        totals[k] += counts[k]
    costs = costs.cpu().numpy()
    if mu.dtype != bf16 or int(count) != BF16_STEPS or not costs[-1] < costs[0]:
        raise RuntimeError(f"mu_dtype AENS: mu {mu.dtype}, count {count}, costs {costs}")
    if float((adv01 - clean01).abs().max()) > EPS + 1e-5:
        raise RuntimeError("mu_dtype AENS: an adversarial clip left the ε-ball")
    facts.append(
        f"AENS-I2V-MF float32 (TF32 off) with mu_dtype bf16 at B={BF16_CLIPS}, "
        f"{BF16_STEPS} steps, {n_chunks} chunks a step: peak {peak:.2f} GiB (with a float32 "
        f"moment: {F32_MU_PEAK_GIB} GiB), {BF16_STEPS / wall:.4f} steps/s ({wall:.3f} s, "
        f"cold, the clean taps included), launches {counts}; costs "
        f"{np.round(costs, 4).tolist()}; the first moment stored in {mu.dtype}")
    del surr, runner, adv01, mu
    torch.cuda.empty_cache()
    print(f"[bf16] on {card}: " + "; ".join(facts) + f"; launches {totals}; phase wall "
          f"{time.time() - t0:.2f} s")
    return totals


MD_CLIPS, MD_STEPS, MD_CHUNK = 2, 3, 16   # a batch of 2 clips: 64 frames, 16 a position
MD_MP_STEPS, MD_AENS_STEPS = 5, 3
MD_COST_RTOL = 1e-6       # mesh (or model axis) against mesh-free step-0 cost
MD_GRAD_ATOL = 5e-5       # a slice's step-0 gradient against the mesh-free runner's over the
                          # same frames, times max|g| (EQ_GRAD_ATOL: cuDNN's input-gradient
                          # sums vary run to run)
MD_COEF_ATOL = 1e-5       # AENS's coefficients after 3 steps, model axis vs mesh-free
MD_LOGIT_RTOL = 1e-4      # a video model's logits cut over the mesh vs whole, times max|logit|
MD_WB_CLIPS, MD_WB_STEPS = 4, 3   # white-box BIM over attack_mesh(data=4): one clip a piece
MD_WB_COST_RTOL = 1e-5    # its step-0 cost vs the one-device attack at B=4 (a piece's convs
                          # run at B=1, the whole batch's at B=4: cuDNN picks by batch size)
MD_WB_GRAD_ATOL = 2e-5    # a piece's step-0 gradient vs the one-device attack on that piece
                          # alone (B=1 on both sides), times max|g|: cuDNN's input-gradient
                          # sums vary run to run (~5e-6 of max|g|, PR 5)
MD_CHILD = """
import json, os, sys
sys.path.insert(0, os.getcwd())
from i2v_tpu_torch.cli import image_main
from i2v_tpu_torch.ops import kernels
from i2v_tpu_torch.parallel import dist
image_main.main(sys.argv[1:])
print(json.dumps({"rank": dist.process_index(), "world": dist.process_count(),
                  "launches": dict(kernels.launches)}))
"""


def _mesh_devices() -> list:
    """The real cards when there are four or more, else one card four times
    (the JAX suite's fake devices, on the card)."""
    n = torch.cuda.device_count()
    if n >= 4:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * 4


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _peaks(devices) -> str:
    return ", ".join(f"{d} {torch.cuda.max_memory_allocated(d) / 2**30:.2f} GiB"
                     for d in dict.fromkeys(devices))


def _whitebox_mesh(kernels, synthetic, pixel) -> tuple[list, dict]:
    """BIM on full-width I3D-R50 at B=4 over attack_mesh(data=4), on one card
    four times and, where the machine has them, over four cards: K3 once a
    piece a step, the step-0 cost against the one-device B=4 attack, each
    piece's step-0 direction against the one-device attack on that piece
    alone (the same B=1 convs), steps/s beside the one-device attack's.
    Float32, TF32 off. Returns (facts, launch counts)."""
    import argparse
    import warnings

    from i2v_tpu_torch import attacks
    from i2v_tpu_torch.cli import common as cli_common
    from i2v_tpu_torch.models import get_video_model
    from i2v_tpu_torch.parallel import attack_mesh, shard_clips

    cli_common.apply_matmul_precision(argparse.Namespace(matmul_precision="float32"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random weights: no checkpoint file, as it says
        bundle = get_video_model("i3d_resnet50", device="cuda")
    ds = synthetic.SyntheticAttackDataset(n_samples=MD_WB_CLIPS)
    videos = pixel.normalize(torch.from_numpy(np.stack(
        [ds.clip01(i) for i in range(MD_WB_CLIPS)])), channel_axis=1).numpy()
    labels = np.arange(MD_WB_CLIPS)
    seen, plain = [], kernels.sign_step_project

    def recording(adv01, grad, clean01, alpha, epsilon):
        if len(seen) < MD_WB_CLIPS:        # the directions of the first step
            seen.append(grad.detach().clone())
        return plain(adv01, grad, clean01, alpha, epsilon)

    def costs(atk) -> np.ndarray:
        return np.asarray([float(v["cost"]) for v in atk.loss_info["wb"].values()])

    def timed(atk, batch):
        ts = time.perf_counter()
        adv = atk(batch, labels, ["wb"])
        _sync_all()
        return adv, time.perf_counter() - ts

    kernels.sign_step_project = recording
    facts, totals = [], dict.fromkeys(COUNTED, 0)
    try:
        one = attacks.BIM(bundle, steps=MD_WB_STEPS)
        timed(one, videos)
        seen.clear()
        _, one_s = timed(one, videos)
        want_costs = costs(one)
        alone = []
        for i in range(MD_WB_CLIPS):
            seen.clear()
            attacks.BIM(bundle, steps=1)(videos[i:i + 1], labels[i:i + 1])
            alone.append(seen[0])
        layouts = [("one card four times", [torch.device("cuda", 0)] * MD_WB_CLIPS)]
        if torch.cuda.device_count() >= MD_WB_CLIPS:
            layouts.append(("four cards", [torch.device("cuda", i)
                                           for i in range(MD_WB_CLIPS)]))
        want = {"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": MD_WB_STEPS * MD_WB_CLIPS}
        for where, devs in layouts:
            mesh = attack_mesh(devs, data=MD_WB_CLIPS)
            atk = attacks.BIM(bundle, steps=MD_WB_STEPS)
            walls = []
            for call in range(2):
                seen.clear()
                kernels.reset_launches()
                adv, wall = timed(atk, shard_clips(videos, mesh))
                if call == 0:
                    # the first call's step 0 is eager; the second replays its
                    # graphs, which no Python wrapper sees
                    first = list(seen)
                counts = dict(kernels.launches)
                if _of(counts, want) != want:
                    raise RuntimeError(f"BIM over the mesh ({where}), call {call}: launch "
                                       f"counts {counts}, expected {want}")
                for k in totals:
                    totals[k] += counts[k]
                walls.append(wall)
            if [g.device for g in first] != devs:
                raise RuntimeError(f"BIM over the mesh ({where}): the pieces stepped on "
                                   f"{[g.device for g in first]}, not {devs}")
            adv01 = pixel.unnormalize(adv, channel_axis=1)
            clean01 = pixel.unnormalize(torch.from_numpy(videos).to(adv.device), channel_axis=1)
            if (adv.device != devs[0] or tuple(adv.shape) != videos.shape
                    or float((adv01 - clean01).abs().max()) > EPS + 1e-5
                    or float(adv01.min()) < -1e-5 or float(adv01.max()) > 1 + 1e-5):
                raise RuntimeError(f"BIM over the mesh ({where}): output on {adv.device}, "
                                   f"shape {tuple(adv.shape)}, off the ε-ball or [0,1]")
            got_costs = costs(atk)
            cost_rel = abs(got_costs[0] / want_costs[0] - 1)
            # a piece's step: ∇ of the batch mean, 1/4 of the piece alone's mean
            grad_err = max(float((MD_WB_CLIPS * g.to(a.device) - a).abs().max())
                           / float(a.abs().max()) for g, a in zip(first, alone))
            if not (cost_rel <= MD_WB_COST_RTOL and grad_err <= MD_WB_GRAD_ATOL
                    and np.isfinite(got_costs).all()):
                raise RuntimeError(f"BIM over the mesh ({where}): step-0 cost {got_costs[0]} "
                                   f"vs one device {want_costs[0]} (relative {cost_rel}), each "
                                   f"piece's step-0 gradient {grad_err} of max|g| from the piece "
                                   "attacked alone")
            later = np.abs(got_costs[1:] / want_costs[1:] - 1)
            facts.append(
                f"(5) BIM on I3D-R50 at B={MD_WB_CLIPS} over attack_mesh(data={MD_WB_CLIPS}) on "
                f"{where}, {MD_WB_STEPS} steps: K3 {want['sign_step']} a call (steps x pieces, "
                f"each on its piece's card); step-0 cost relative {cost_rel:.3g} from the "
                f"one-device B={MD_WB_CLIPS} attack (limit {MD_WB_COST_RTOL}); each piece's "
                f"step-0 gradient {grad_err:.3g} of max|g| from the piece attacked alone (limit "
                f"{MD_WB_GRAD_ATOL}); later steps relative {np.round(later, 7).tolist()} "
                f"(UNSTEADY, printed only); {MD_WB_STEPS / walls[1]:.4f} steps/s warm "
                f"({MD_WB_STEPS / walls[0]:.4f} cold) against {MD_WB_STEPS / one_s:.4f} on one "
                f"device at B={MD_WB_CLIPS}")
    finally:
        kernels.sign_step_project = plain
    return facts, totals


def phase_multi_device(kernels, image_main, evaluate_cli, synthetic, pixel_mean_std,
                       card: str, tmp: str) -> dict:
    """The mesh paths at full width, float32, TF32 off, on the real cards when
    there are four, else on one card four times: (1) ENS-I2V at B=2 through
    the mesh runner over attack_mesh(data=2, frames=2), held slice by slice
    to the mesh-free runner at frame_chunk 16 (one position's frames), twice
    (two batches: its clips are item 3's run); (2) --model_parallel N (N the
    card count) through cli.image_main, ENS and AENS, and the model-axis
    runner over ensemble_mesh(model=4) held to the sequential ensemble (the
    step-0 cost and gradient; AENS's coefficients after 3 steps); (3) the six
    full-width video models over (1)'s clips, serially and over the mesh:
    logits and reports, and cli.evaluate --data_parallel; (4) two processes
    of cli.image_main under the launcher's variables (gloo), each on its
    half of four clips into one run, which cli.evaluate then reads. Returns
    the launch counts of every path it drives, the children's included."""
    import argparse

    from i2v_tpu_torch.cli import common as cli_common
    from i2v_tpu_torch.eval import transfer
    from i2v_tpu_torch.models import get_image_models, get_video_model
    from i2v_tpu_torch.ops import pixel
    from i2v_tpu_torch.parallel import attack_mesh, ensemble, mesh as mesh_mod, sharded
    from i2v_tpu_torch.parallel.replicas import Replicas
    from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES, artifacts

    t0 = time.time()
    cli_common.apply_matmul_precision(argparse.Namespace(matmul_precision="float32"))
    devices = _mesh_devices()
    where = "four cards" if len(set(devices)) >= 4 else "one card four times"
    totals, facts = dict.fromkeys(COUNTED, 0), []

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    ds = synthetic.SyntheticAttackDataset(n_samples=2 * MD_CLIPS)
    clean01 = torch.from_numpy(np.stack([ds.clip01(i) for i in range(2 * MD_CLIPS)])).cuda()
    ens = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
    surr = get_image_models(list(ens), ens, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    mod = (torch.rand(MD_CLIPS * 32, 3, 224, 224, device="cuda", generator=gen) * 2 - 1) \
        * 0.9 * EPS

    # (1) the mesh runner, slice by slice against the mesh-free runner
    mesh = attack_mesh(devices, data=2, frames=2)
    per = MD_CLIPS * 32 // mesh.size
    free = sharded.make_sharded_i2v_runner(surr, steps=MD_STEPS, frame_chunk=MD_CHUNK)
    c_f, g_f = free.value_and_grad(clean01[:MD_CLIPS], mod)
    runner = sharded.make_sharded_i2v_runner(surr, mesh, steps=MD_STEPS)
    c_m, g_m = runner.value_and_grad(clean01[:MD_CLIPS], mod)
    scale = float(g_f.abs().max())
    cost_rel = abs(float(c_m) / float(c_f) - 1)
    slice_err = max(float((g_m[p * per:(p + 1) * per] - g_f[p * per:(p + 1) * per].to(
        g_m.device)).abs().max()) / scale for p in range(mesh.size))
    if not (cost_rel <= MD_COST_RTOL and slice_err <= MD_GRAD_ATOL and scale > 0):
        raise RuntimeError(f"mesh runner vs mesh-free: cost {float(c_m)} vs {float(c_f)} "
                           f"(relative {cost_rel}), slice gradient {slice_err} of max|g|")
    if len(set(devices)) > 1:
        # K1/K2 on a card other than cuda:0: the device guard and its stream
        d = devices[-1]
        frames = pixel.flatten_clip_to_frames(clean01[:1]).to(d)
        m = mod[:32].to(d).requires_grad_(True)
        out = kernels.rebuild_adv(frames, m, EPS)
        (g_k,) = torch.autograd.grad(out, m, out)
        m_p = mod[:32].to(d).requires_grad_(True)
        out_p = pixel.rebuild_adv(frames, m_p, float(np.float32(EPS)))
        (g_p,) = torch.autograd.grad(out_p, m_p, out_p)
        if not (torch.equal(out, out_p) and torch.equal(g_k, g_p)):
            raise RuntimeError(f"K1/K2 on {d} differ from their plain versions")
        facts.append(f"K1/K2 on {d} bit-identical to their plain versions")
    _sync_all()
    for d in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(d)
    walls, advs = [], []
    want = {"rebuild_fwd": 2 * (MD_STEPS * mesh.size + mesh.size),
            "rebuild_bwd": 2 * MD_STEPS * mesh.size, "sign_step": 0}

    def two_batches():
        for k in range(2):
            ts = time.perf_counter()
            adv, costs = runner(clean01[k * MD_CLIPS:(k + 1) * MD_CLIPS])
            _sync_all()
            walls.append(time.perf_counter() - ts)
            advs.append(adv)
            c = costs.cpu().numpy()
            if not (np.isfinite(c).all() and c[-1] < c[0]):
                raise RuntimeError(f"mesh ENS batch {k}: the cost did not fall: {c}")

    kernels.reset_launches()
    two_batches()
    counts = dict(kernels.launches)
    if _of(counts, want) != want:
        raise RuntimeError(f"mesh ENS: launch counts {counts}, expected {want}")
    add(counts)
    adv01 = torch.cat(advs)
    if (float((adv01 - clean01).abs().max()) > EPS + 1e-5 or adv01.min() < 0
            or adv01.max() > 1):
        raise RuntimeError("mesh ENS: an adversarial clip left the ε-ball or [0,1]")
    facts.append(
        f"(1) ENS-I2V over attack_mesh(data=2, frames=2) on {where}, B={MD_CLIPS} x 32 x "
        f"224^2 ({per} frames a position), {MD_STEPS} steps: step-0 cost vs the mesh-free "
        f"runner at frame_chunk {MD_CHUNK} relative {cost_rel:.3g} (limit {MD_COST_RTOL}), "
        f"each slice's gradient {slice_err:.3g} of max|g| (limit {MD_GRAD_ATOL}); "
        f"{MD_STEPS / walls[0]:.4f} steps/s cold, {MD_STEPS / walls[1]:.4f} warm "
        f"({walls[1]:.3f} s a batch); peaks {_peaks(devices)}; launches {counts}")
    del runner, free, g_f, g_m

    # (2) --model_parallel through the CLI, and the model-axis runner
    n = torch.cuda.device_count()
    for method, extra in (("ImageGuidedFML2_Adam_MultiModels", []),
                          ("AENS_I2V_MF", ["--step_size", "0.005", "--aens_momentum",
                                           str(AENS_MOMENTUM)])):
        argv = ["--attack_method", method, "--data", "synthetic", "--n_synthetic", "1",
                "--step", str(MD_MP_STEPS), "--model_parallel", str(n), "--device", "cuda",
                "--matmul_precision", "float32", "--file_prefix", "mp"] + extra
        args = image_main.arg_parse(argv)
        # ensemble_mesh(model=n) over the n cards: n groups, one frame slice
        want = {"rebuild_fwd": MD_MP_STEPS * n + 1, "rebuild_bwd": MD_MP_STEPS * n,
                "sign_step": 0}
        _, counts, _ = _run_counted(kernels, f"--model_parallel {n} {method}", want,
                                    lambda: image_main.run(args))
        add(counts)
        _check_clip(args.adv_path, 0, "adv", synthetic.SyntheticAttackDataset(n_samples=1),
                    pixel_mean_std)
        (c,) = _costs(args.adv_path).values()
        if len(c) != MD_MP_STEPS or not (np.isfinite(c).all() and c[-1] < c[0]):
            raise RuntimeError(f"--model_parallel {method}: costs {c}")
        facts.append(f"(2) image_main {method} --model_parallel {n}: "
                     f"{MD_MP_STEPS / args.throughput['last_call_s']:.3f} steps/s with warm-up, "
                     f"launches {counts}, costs {np.round(c, 4).tolist()}")
    emesh = ensemble.ensemble_mesh(devices, model=4)
    one = clean01[:1]
    c_s, g_s = sharded.make_sharded_i2v_runner(surr, steps=1).value_and_grad(one, mod[:32])
    c_e, g_e = ensemble.make_ensemble_parallel_runner(surr, emesh, steps=1).value_and_grad(
        one, mod[:32])
    scale = float(g_s.abs().max())
    e_cost = abs(float(c_e) / float(c_s) - 1)
    e_grad = float((g_e - g_s).abs().max()) / scale
    aens = {n_: [2, 3] for n_ in ens}
    surr_a = get_image_models(list(aens), aens, device="cuda")
    kw = dict(steps=MD_AENS_STEPS, adaptive=True, aens_momentum=AENS_MOMENTUM)
    seq = sharded.make_sharded_i2v_runner(surr_a, **kw)
    par = ensemble.make_ensemble_parallel_runner(surr_a, emesh, **kw)
    seq(one)
    want = {"rebuild_fwd": MD_AENS_STEPS * emesh.size + emesh.shape["frames"],
            "rebuild_bwd": MD_AENS_STEPS * emesh.size, "sign_step": 0}
    (adv_e, costs_e), counts, _ = _run_counted(kernels, "model-axis AENS", want,
                                               lambda: par(one))
    add(counts)
    coef_err = float((par.coefficients() - seq.coefficients()).abs().max())
    if not (e_cost <= MD_COST_RTOL and e_grad <= MD_GRAD_ATOL and coef_err <= MD_COEF_ATOL
            and scale > 0):
        raise RuntimeError(f"model axis vs sequential: cost relative {e_cost}, gradient "
                           f"{e_grad} of max|g|, AENS coefficients {coef_err}")
    if float((adv_e - one).abs().max()) > EPS + 1e-5 or not torch.isfinite(costs_e).all():
        raise RuntimeError("model-axis AENS: output off the ε-ball or costs not finite")
    facts.append(
        f"(2) model-axis runner over ensemble_mesh(model=4) on {where}, one clip: step-0 cost "
        f"relative {e_cost:.3g} and gradient {e_grad:.3g} of max|g| against the sequential "
        f"ensemble; AENS (8 taps, momentum {AENS_MOMENTUM}) coefficients after "
        f"{MD_AENS_STEPS} steps {coef_err:.3g} from the sequential runner's (limit "
        f"{MD_COEF_ATOL}); launches {counts}")
    del surr_a, seq, par
    if len(set(devices)) >= 4:
        # the model-axis runner's compiled loop on four cards at B=16
        ds16 = synthetic.SyntheticAttackDataset(n_samples=16)
        add(_ensemble_loop_twins(kernels, surr, np.stack([ds16[i][0] for i in range(16)]),
                                 devices, tmp, steps=LOOP_ENS_MP16_STEPS, frame_chunk="auto"))
        facts.append("(2) ENS --model_parallel 4 at B=16 on four cards, eager and graphed "
                     "(printed above)")
    del surr

    # (3) data-parallel evaluation over (1)'s clips
    run_dir = os.path.join(tmp, "md_run")
    artifacts.save_batch(run_dir, list(range(2 * MD_CLIPS)),
                         pixel.normalize(adv01, channel_axis=1).cpu().numpy())
    video = {name: get_video_model(name, device="cuda") for name in VIDEO_MODEL_NAMES}
    dmesh = attack_mesh(devices)
    clips = pixel.normalize(adv01, channel_axis=1)
    pieces = mesh_mod.Sharding(dmesh, dmesh.axis_names).split(clips).pieces
    logit_err = 0.0
    with torch.inference_mode():
        for name, bundle in video.items():
            whole = bundle.apply_norm(clips)
            cut = Replicas(bundle, dmesh).logits(pieces, dmesh.positions)
            logit_err = max(logit_err, float((cut - whole).abs().max() / whole.abs().max()))
    reports = {}
    # a forward a model of the whole batch (serial), of each position's piece
    # (mesh and mesh single pass) and of each piece over the CLI's mesh
    forwards = 1 + 2 * len(pieces) + attack_mesh().size
    kernels.reset_launches()
    for key, kw in (("serial", {}), ("mesh", {"mesh": dmesh}),
                    ("mesh single pass", {"mesh": dmesh, "single_pass": True})):
        transfer.evaluate_run(run_dir, batch_size=2 * MD_CLIPS, device="cuda",
                              get_bundle=video.__getitem__, log=lambda *_: None, **kw)
        with open(os.path.join(run_dir, REPORT_CSV), "rb") as f, \
                open(os.path.join(run_dir, REPORT_JSON), "rb") as g:
            reports[key] = (f.read(), g.read())
    args = evaluate_cli.arg_parse(["--adv_path", run_dir, "--device", "cuda", "--batch_size",
                                   str(2 * MD_CLIPS), "--data_parallel", "--matmul_precision",
                                   "float32"])
    evaluate_cli.run(args, get_bundle=video.__getitem__)
    with open(os.path.join(run_dir, REPORT_CSV), "rb") as f, \
            open(os.path.join(run_dir, REPORT_JSON), "rb") as g:
        reports["cli --data_parallel"] = (f.read(), g.read())
    if kernels.launches != _evaluations(forwards):
        raise RuntimeError(f"evaluation's launches {kernels.launches}, expected "
                           f"{_evaluations(forwards)}")
    add(kernels.launches)
    if logit_err > MD_LOGIT_RTOL or len(set(reports.values())) != 1:
        raise RuntimeError(f"data-parallel evaluation: logits {logit_err} of max|logit|, "
                           f"reports equal: {[r == reports['serial'] for r in reports.values()]}")
    facts.append(
        f"(3) six full-width video models over (1)'s {2 * MD_CLIPS} clips cut over "
        f"attack_mesh ({dmesh.size} positions): logits {logit_err:.3g} of max|logit| from the "
        f"whole batch's (limit {MD_LOGIT_RTOL}); serial, mesh, mesh single-pass and "
        f"cli.evaluate --data_parallel reports identical; cli clips/s "
        + ", ".join(f"{k} {v['clips_per_sec']:.3f}" for k, v in args.throughput.items()))
    del video

    # (4) two processes under the launcher's variables, one run directory
    out_dir = os.path.join(tmp, "md_two")
    argv = ["--attack_method", "ImageGuidedFML2_Adam_MultiModels", "--data", "synthetic",
            "--n_synthetic", "4", "--step", "2", "--device", "cuda", "--matmul_precision",
            "float32", "--file_prefix", "two"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), I2V_TPU_OPT_PATH=out_dir)
        procs.append(subprocess.Popen([sys.executable, "-c", MD_CHILD] + argv, env=env,
                                      cwd=os.path.dirname(os.path.abspath(__file__)),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    children = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"a launched process failed ({p.returncode}):\n{out}\n{err}")
            children.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    want = {"rebuild_fwd": 2 * 3, "rebuild_bwd": 2 * 2, "sign_step": 0}   # 2 clips at B=1
    for rank, child in enumerate(children):
        if child["rank"] != rank or child["world"] != 2 or _of(child["launches"], want) != want:
            raise RuntimeError(f"process {rank} reported {child}, expected launches {want}")
        add(child["launches"])
    run_two = os.path.join(out_dir, "Image-ImageGuidedFML2_Adam_MultiModels-2-synthetic-two")
    files = sorted(os.listdir(run_two))
    if files != ["0-adv.npy", "1-adv.npy", "2-adv.npy", "3-adv.npy", "loss_info_1.json",
                 "loss_info_2.json"]:
        raise RuntimeError(f"the two processes left {files}")
    ds4 = synthetic.SyntheticAttackDataset(n_samples=4)
    for label in range(4):
        _check_clip(run_two, label, "adv", ds4, pixel_mean_std)
    args = evaluate_cli.arg_parse(["--adv_path", run_two, "--device", "cuda",
                                   "--matmul_precision", "float32"])
    acc = evaluate_cli.run(args)
    if sorted(acc) != sorted(VIDEO_MODEL_NAMES):
        raise RuntimeError(f"cli.evaluate over the merged run gave {acc}")
    facts.append(f"(4) two processes (gloo, cuda:{{rank % {n}}}) of image_main ENS-I2V, 2 "
                 f"steps, 2 clips each, one run directory ({', '.join(files)}); each child's "
                 f"launches {want}; cli.evaluate over the merged run: top-1 {acc}")

    # (5) white-box data parallelism: BIM over the data axis
    wb_facts, wb_counts = _whitebox_mesh(kernels, synthetic, pixel)
    facts += wb_facts
    add(wb_counts)
    print(f"[multi-device] on {card}, TF32 off: " + "; ".join(facts)
          + f"; launches {totals}; phase wall {time.time() - t0:.2f} s")
    return totals


E2E_CLIPS, E2E_BATCH, E2E_STEPS, E2E_KILL = 24, 8, 10, 2   # the 400-clip tool, cut down
ANCHOR_STEPS = 3
ANCHOR_COST_RTOL = 1e-5   # the anchor's step-0 gate, reference vs port, TF32 off
TOOL_TIMEOUT = 600


def _run(argv: list, want_rc: int = 0) -> str:
    """``python argv`` from the checkout's root; its stdout, or a raise with
    both streams' ends when it exits with another code than ``want_rc``."""
    proc = subprocess.run([sys.executable, *argv], cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=TOOL_TIMEOUT)
    if proc.returncode != want_rc:
        raise RuntimeError(f"{' '.join(argv[:2])} exited {proc.returncode} (want {want_rc}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def _printed_launches(stdout: str) -> dict:
    """The launch counts a tool's process printed as its last line."""
    last = stdout.strip().splitlines()[-1]
    return json.loads(last.split(" launches ", 1)[1])


def _check_launches(label: str, got: dict, fwd: int, bwd: int, sign: int) -> None:
    want = {"rebuild_fwd": fwd, "rebuild_bwd": bwd, "sign_step": sign}
    if _of(got, want) != want:
        raise RuntimeError(f"{label}: launches {got}, want {want}")


def _csv_predictions(path: str) -> tuple[list, dict]:
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], {int(r[0]): [int(c) for c in r[1:]] for r in rows[1:]}


def phase_measurement_tools(card: str, tmp: str) -> dict:
    """The port's measurement tools, each in its own process, which counts
    its own launches and prints them: tools/torch_e2e_400.py killed after
    E2E_KILL batches and resumed (the artifacts on disk after the kill,
    re-scored predictions against cli.evaluate --bf16 over the same files,
    complete reports); tools/torch_perf_probe.py cost ens16_bf16 (its FLOPs
    against the conv layers' count) and hbm mi16 for one step (K3 once);
    tools/torch_baseline_anchor.py at B=1, TF32 off (the step-0 gate)."""
    import math
    import shutil

    from i2v_tpu_torch.utils import artifacts

    t0 = time.time()
    torch.cuda.empty_cache()
    probe = _tool("torch_perf_probe")
    counts = dict.fromkeys(COUNTED, 0)
    facts = []

    def add(got):
        for k in counts:
            counts[k] += got[k]

    # (1) the 400-clip fused generate→evaluate, cut to E2E_CLIPS, killed and resumed
    run_dir, out_dir = os.path.join(tmp, "e2e400"), os.path.join(tmp, "e2e400_out")
    e2e = [os.path.join("tools", "torch_e2e_400.py"), "--run_dir", run_dir, "--out_dir",
           out_dir, "--clips", str(E2E_CLIPS), "--batch", str(E2E_BATCH), "--steps",
           str(E2E_STEPS)]
    ts = time.time()
    out_a = _run(e2e + ["--kill_after_batches", str(E2E_KILL)], want_rc=137)
    wall_a = time.time() - ts
    got = _printed_launches(out_a)
    # one 256-frame chunk at B=8: K1 steps + 1 and K2 steps a batch
    _check_launches("e2e phase A", got, E2E_KILL * (E2E_STEPS + 1), E2E_KILL * E2E_STEPS, 0)
    add(got)
    if os.path.exists(os.path.join(run_dir, REPORT_CSV)):
        raise RuntimeError("the killed phase A wrote reports")
    on_disk = artifacts.list_adv_files(run_dir)
    if len(on_disk) < E2E_BATCH:
        raise RuntimeError(f"{len(on_disk)} artifacts on disk after the kill, want at least "
                           f"{E2E_BATCH} (the first batch's, drained during the second's attack)")
    rescored = os.path.join(tmp, "e2e400_rescored")
    os.makedirs(rescored)
    for f in on_disk:
        clip = np.load(os.path.join(run_dir, f))
        if clip.dtype != np.float16 or clip.shape != (3, 32, 224, 224):
            raise RuntimeError(f"{f} after the kill: {clip.dtype} {clip.shape}")
        shutil.copy(os.path.join(run_dir, f), rescored)
    ts = time.time()
    out_b = _run(e2e + ["--resume"])
    wall_b = time.time() - ts
    n_batches = math.ceil((E2E_CLIPS - len(on_disk)) / E2E_BATCH)
    got = _printed_launches(out_b)
    _check_launches("e2e phase B", got, n_batches * (E2E_STEPS + 1), n_batches * E2E_STEPS, 0)
    add(got)
    if f"[e2e400:B] re-scored {len(on_disk)} artifacts" not in out_b:
        raise RuntimeError(f"phase B did not re-score the {len(on_disk)} artifacts on disk:\n"
                           f"{out_b[-2000:]}")
    header, final = _csv_predictions(os.path.join(run_dir, REPORT_CSV))
    if sorted(final) != list(range(E2E_CLIPS)) or any(-1 in p for p in final.values()):
        raise RuntimeError(f"the resumed reports do not cover the {E2E_CLIPS} labels once: "
                           f"{final}")
    ts = time.time()
    _run(["-m", "i2v_tpu_torch.cli.evaluate", "--adv_path", rescored, "--bf16", "--batch_size",
          str(E2E_BATCH), "--n_classes", str(E2E_CLIPS)])
    eval_s = time.time() - ts
    off_header, offline = _csv_predictions(os.path.join(rescored, REPORT_CSV))
    differ = [artifacts.label_of(f) for f in on_disk
              if offline[artifacts.label_of(f)] != final[artifacts.label_of(f)]]
    if off_header != header or differ:
        raise RuntimeError(f"re-scored predictions differ from cli.evaluate --bf16's for labels "
                           f"{differ}")
    with open(os.path.join(out_dir, "E2E_400_TORCH.json")) as f:
        summary = json.load(f)
    facts.append(f"e2e {E2E_CLIPS} clips, B={E2E_BATCH}, {E2E_STEPS} steps: phase A killed "
                 f"(137) after {E2E_KILL} batches in {wall_a:.2f} s, {len(on_disk)} float16 "
                 f"artifacts on disk; phase B re-scored them (predictions = cli.evaluate "
                 f"--bf16's, {eval_s:.2f} s) and attacked {n_batches} batches in "
                 f"{wall_b:.2f} s; {E2E_CLIPS} rows, no -1; "
                 f"{summary['clips_per_s_end_to_end']} clips/s end to end")

    # (2) the roofline of one bf16 ENS step at B=16
    probe_out = os.path.join(tmp, "perf_probe.json")
    out = _run([os.path.join("tools", "torch_perf_probe.py"), "cost", "ens16_bf16", "--out",
                probe_out])
    got = _printed_launches(out)
    _check_launches("cost ens16_bf16", got, 2 * (probe.TIMED_STEPS + 1), 2 * probe.TIMED_STEPS,
                    0)
    add(got)
    with open(probe_out) as f:
        row = json.load(f)["cost_ens16_bf16"]
    want = probe.analytic_conv_flops(
        probe.meta_models(probe.ENS_NAMES, probe.ENS_DEPTHS, torch.bfloat16), 16 * 32)
    if row["flops_per_step"] != want:
        raise RuntimeError(f"cost ens16_bf16 counted {row['flops_per_step']} FLOPs a step, the "
                           f"conv layers give {want}")
    facts.append(f"cost ens16_bf16: {row['flops_per_step'] / 1e12:.3f} TFLOP a step (= the conv "
                 f"layers'), {row['bytes_per_step'] / 1e9:.1f} GB; {row['steps_per_s']:.4f} "
                 f"steps/s, mfu {row['mfu']:.4f}, hbm_share {row['hbm_share']:.4f}")

    # (3) the memory audit's MIFGSM on I3D-R101 at B=16, one step
    out = _run([os.path.join("tools", "torch_perf_probe.py"), "hbm", "mi16", "--calls", "1",
                "--out", probe_out])
    got = _printed_launches(out)
    _check_launches("hbm mi16", got, 0, 0, 1)
    add(got)
    with open(probe_out) as f:
        row = json.load(f)["hbm_mi16"]
    if not row["fits"]:
        raise RuntimeError(f"hbm mi16 did not fit: {row['error']}")
    facts.append(f"hbm mi16 (MIFGSM, I3D-R101, B=16, one step): peak {row['peak_gib']:.2f} of "
                 f"{row['total_gib']:.2f} GiB")

    # (4) the reference's own ENS step beside the port's, same weights
    anchor_out = os.path.join(tmp, "anchor.json")
    out = _run([os.path.join("tools", "torch_baseline_anchor.py"), "--batches", "1", "--modes",
                "float32", "--methods", "ens", "--steps", str(ANCHOR_STEPS), "--out",
                anchor_out])
    got = _printed_launches(out)
    # value_and_grad, then a 1-step and a (steps+1)-step call, each three
    # times (the tool warms each runner past its graph's capture)
    _check_launches("anchor", got, 1 + 3 * 2 + 3 * (ANCHOR_STEPS + 2),
                    1 + 3 * 1 + 3 * (ANCHOR_STEPS + 1), 0)
    add(got)
    with open(anchor_out) as f:
        case = json.load(f)["cases"]["ens_b1_float32"]
    if not case["cost0_rel_diff"] <= ANCHOR_COST_RTOL:
        raise RuntimeError(f"anchor: step-0 costs part by {case['cost0_rel_diff']} relative "
                           f"(limit {ANCHOR_COST_RTOL})")
    facts.append(f"anchor ENS B=1 TF32 off: step-0 costs {case['cost0_rel_diff']:.3g} relative "
                 f"apart (limit {ANCHOR_COST_RTOL}); reference "
                 f"{case['reference']['steps_per_s']:.4f} steps/s, port "
                 f"{case['port']['steps_per_s']:.4f}")
    print(f"[measurement tools] on {card}: " + "; ".join(facts)
          + f"; launches {counts}; phase wall {time.time() - t0:.2f} s")
    return counts


LOOP_STEPS = 5            # the B=1 cases' steps a call
LOOP_B16_STEPS = 3        # the B=16 runner cases' steps a call
LOOP_MG_STEPS, LOOP_MG_COARSE = 4, 2
LOOP_PEAK_SLACK_GIB = 1.0  # a graphed B=16 case's peak over its eager twin's, at most
LOOP_EVAL_BATCHES = 2     # batch 1 eager (warm-up), batch 2 captured and replayed
LOOP_FUSED_BATCHES = 2
ADAM_STEPS = 10           # the device-table Adam against torch's, on one random state
LOOP_TT_STEPS = 3         # TemporalTranslation's steps a call (15 variants a step)
LOOP_ENS_MP_STEPS = 5     # --model_parallel 4 at B=2 over [cuda:0] x 4
LOOP_ENS_MP16_STEPS = 3   # --model_parallel 4 at B=16 over four cards, chunk "auto"
LOOP_CAM_BATCH = 2        # the Grad-CAM evaluator's clips a batch (LOOP_EVAL_BATCHES batches)


def _recorded_costs(atk) -> np.ndarray:
    """Every recorded clip's per-step costs of an attack, in the order recorded."""
    return np.concatenate([[np.float32(per[i]["cost"]) for i in range(len(per))]
                           for per in atk.loss_info.values()])


def _ensemble_loop_twins(kernels, surr, clips_norm: np.ndarray, devices: list, tmp: str, *,
                         steps: int, frame_chunk=None) -> dict:
    """ENS-I2V through ``EnsembleParallelAttack`` (``image_main
    --model_parallel 4``) over ``ensemble_mesh(devices, model=4)``, eager
    and graphed (:func:`_loop_twins`): K1 once a chunk of each position a
    step and once a slice at the end, K2 once a chunk of each position a
    step, as on the sharded runner. Returns the launches."""
    from i2v_tpu_torch.parallel import EnsembleParallelAttack, ensemble_mesh
    from i2v_tpu_torch.parallel.sharded import resolve_frame_chunk, snap_frame_chunk

    mesh = ensemble_mesh(devices, model=4)
    b, cols = len(clips_norm), mesh.shape["frames"]
    n_local = b * clips_norm.shape[2] // cols
    chunks = n_local // snap_frame_chunk(resolve_frame_chunk(
        frame_chunk, n_local, clips_norm.shape[3:]), n_local)
    want = {"rebuild_fwd": steps * mesh.size * chunks + cols,
            "rebuild_bwd": steps * mesh.size * chunks, "sign_step": 0}

    def make(graphs):
        atk = EnsembleParallelAttack(surr, mesh, steps=steps, step_size=0.005,
                                     frame_chunk=frame_chunk,
                                     name="ImageGuidedFML2_Adam_MultiModels", graphs=graphs)

        def call():
            atk.loss_info = {}
            atk(clips_norm, None, ["v"])
            return _recorded_costs(atk)
        return call

    where = "four cards" if len(set(devices)) >= 4 else "[cuda:0] x 4"
    return _loop_twins(kernels, f"ENS --model_parallel 4 B={b} over {where} (chunks {chunks})",
                       make, tmp, work=steps, want=want)


def _adam_table_check() -> str:
    """The device-table Adam (utils.graphs.TableAdam) against the eager
    optimizers it stands for, on the card: ADAM_STEPS steps of the same
    random gradients over one random (32,3,224,224) modifier, bit for bit
    after every step, against torch.optim.Adam (foreach=False) and against
    optax's form with a bf16 first moment (parallel.sharded._AdamMu)."""
    from i2v_tpu_torch.parallel.sharded import _AdamMu
    from i2v_tpu_torch.utils.graphs import TableAdam

    gen = torch.Generator(device="cuda").manual_seed(3)
    p0 = (torch.rand(MAIN_SHAPE, generator=gen, device="cuda") * 2 - 1) * EPS
    grads = [torch.randn(MAIN_SHAPE, generator=gen, device="cuda")
             * 10.0 ** float(-4 * torch.rand((), generator=gen, device="cuda"))
             for _ in range(ADAM_STEPS)]
    ref = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([ref], lr=0.005, betas=(0.9, 0.999), eps=1e-8, foreach=False,
                           fused=False)
    mref = p0.clone().requires_grad_(True)
    mu = _AdamMu(mref, 0.005, torch.bfloat16, None)
    table, mtable = p0.clone(), p0.clone()
    adam = TableAdam(table, 0.005, ADAM_STEPS)
    madam = TableAdam(mtable, 0.005, ADAM_STEPS, mu_dtype=torch.bfloat16)
    adam.reset()
    madam.reset()
    for t, g in enumerate(grads):
        ref.grad, mref.grad = g.clone(), g.clone()
        opt.step()
        mu.step()
        adam.step(g)
        madam.step(g)
        for label, want, got in (("torch.optim.Adam", ref, table), ("optax form", mref, mtable)):
            if not torch.equal(want.detach(), got):
                raise RuntimeError(f"device-table Adam vs {label} at step {t}: "
                                   f"{int((want.detach() != got).sum())} elements differ")
    return (f"device-table Adam, {ADAM_STEPS} steps over {tuple(MAIN_SHAPE)}: bit for bit "
            "torch.optim.Adam's and the optax form's (bf16 first moment)")


def _idle_share(call, tmp: str) -> float:
    """The idle share of the span from the first kernel to the last over one
    traced call (tools/torch_eval_profile.py's kernel_summary)."""
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(tmp, "loops_trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    k = _tool("torch_eval_profile").kernel_summary(path)
    os.remove(path)
    return 1 - k["busy_us"] / k["span_us"] if k["span_us"] else float("nan")


def _loop_twins(kernels, label: str, make, tmp: str, *, work: int, unit: str = "steps",
                peak_gate: bool = False, want: Optional[dict] = None,
                atol: Optional[float] = None) -> dict:
    """One compiled-loops case: ``make(graphs)`` builds the path and returns a
    call that runs it once and returns its per-step costs (a 1-D float
    array), predictions or maps. The eager twin runs first, then the graphed
    one, each alone on the card: a first call (the graphed one's step 0
    eager, then the capture), a timed call and a traced call. Gates: the
    first calls' launch counts equal (and equal to ``want`` where given), the
    step-0 costs equal, predictions equal or, with ``atol``, maps within it
    of the eager ones, and with ``peak_gate`` the graphed peak within
    LOOP_PEAK_SLACK_GIB of the eager one's. Returns the twins' launches."""
    import gc

    from i2v_tpu_torch.utils import graphs as graphs_mod

    runs = {}
    for graphs in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call = make(graphs)
        before = dict(graphs_mod.captures)
        kernels.reset_launches()
        first = call()
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        second = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        idle = _idle_share(call, tmp)
        runs[graphs] = {"first": first, "second": second, "counts": counts, "peak": peak,
                        "rate": work / wall,
                        "idle": idle, "captures": graphs_mod.captures["graphs"] - before["graphs"],
                        "capture_s": graphs_mod.captures["seconds"] - before["seconds"]}
        del call
    eager, graphed = runs[False], runs[True]
    if eager["counts"] != graphed["counts"]:
        raise RuntimeError(f"{label}: launches eager {eager['counts']} vs graphed "
                           f"{graphed['counts']}")
    if want is not None and _of(graphed["counts"], want) != want:
        raise RuntimeError(f"{label}: launches {graphed['counts']}, expected {want}")
    if graphed["captures"] == 0:
        raise RuntimeError(f"{label}: the graphed run captured nothing")
    a, b = np.asarray(eager["first"]), np.asarray(graphed["first"])
    if unit == "steps":
        if a[0] != b[0]:
            raise RuntimeError(f"{label}: step-0 cost eager {a[0]!r} vs graphed {b[0]!r}")

        def parts(x, y):
            return float(np.max(np.abs(x[1:] - y[1:]) / np.abs(x[1:]))) if len(x) > 1 else 0.0

        # the eager path's own second call: cuDNN's gradient sums vary from
        # run to run (UNSTEADY), and AENS's coefficients carry over
        tail = (f"step-0 cost {a[0]:.6g} equal; later steps part by {parts(a, b):.3g} "
                f"relative (eager against its own second call: "
                f"{parts(a, np.asarray(eager['second'])):.3g}; printed)")
    elif atol is not None:
        err = float(np.max(np.abs(a - b)))
        if not (a.shape == b.shape and err <= atol and np.isfinite(b).all()):
            raise RuntimeError(f"{label}: graphed {b.shape} vs eager {a.shape}, max|diff| "
                               f"{err} (limit {atol})")
        tail = f"{b.shape} maps, max|diff| graphed vs eager {err:.3g} (limit {atol})"
    else:
        if not np.array_equal(a, b):
            raise RuntimeError(f"{label}: predictions eager vs graphed differ")
        tail = "predictions equal"
    if peak_gate and graphed["peak"] > eager["peak"] + LOOP_PEAK_SLACK_GIB:
        raise RuntimeError(f"{label}: graphed peak {graphed['peak']:.2f} GiB over the eager "
                           f"{eager['peak']:.2f} + {LOOP_PEAK_SLACK_GIB}")
    print(f"[compiled loops] {label}: {unit}/s eager {eager['rate']:.4f}, graphed "
          f"{graphed['rate']:.4f} ({graphed['rate'] / eager['rate']:.3f}x); idle "
          f"{eager['idle']:.4f} -> {graphed['idle']:.4f}; peak {eager['peak']:.2f} -> "
          f"{graphed['peak']:.2f} GiB; {graphed['captures']} capture(s) "
          f"{graphed['capture_s']:.3f} s; launches {graphed['counts']} each; {tail}",
          flush=True)
    return {k: eager["counts"][k] + graphed["counts"][k] for k in eager["counts"]}


def phase_compiled_loops(kernels, synthetic, pixel, card: str, tmp: str) -> dict:
    """Each attack step and evaluation forward as a CUDA graph, against the
    same path with ``graphs=False``, float32 paths with TF32 off: ENS-I2V at
    B=1 (the Adam engine); the runner at B=16 in bf16 whole and in float32 at
    chunk 256; multigrid in bf16 at B=16; AENS-I2V-MF at B=1; ILAF on the
    truncated I3D-R50 (its tap held to the full model's bit for bit); BIM,
    MIFGSM and TAP on I3D-R50 at B=1, BIM at B=4 over [cuda:0] x 4; DIFGSM
    with and without momentum and TT 'adj' and 'random' (kernlen 15, chunk
    5) on I3D-R50 at B=1, their draw tables held to the host draws; ENS
    --model_parallel 4 at B=2 over [cuda:0] x 4; the Grad-CAM evaluator over
    the five CAM models at B=2 (maps within CAM_ATOL of the eager ones); the
    six video models' single pass at B=16 in bf16 and float32 (logits bit
    for bit) and a fused ENS + six-model run at B=2. Returns the launch
    counts."""
    import argparse
    import gc

    from i2v_tpu_torch import attacks
    from i2v_tpu_torch.cli import common as cli_common
    from i2v_tpu_torch.cli import gradcam as gradcam_cli
    from i2v_tpu_torch.eval.fused import FusedGenerateEvaluate
    from i2v_tpu_torch.eval.transfer import single_pass_eval
    from i2v_tpu_torch.models import get_image_models, get_video_model, tap_keys_for
    from i2v_tpu_torch.parallel import attack_mesh, multigrid, sharded
    from i2v_tpu_torch.parallel.replicas import Replicas
    from i2v_tpu_torch.utils import VIDEO_MODEL_NAMES, artifacts

    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    cli_common.apply_matmul_precision(argparse.Namespace(matmul_precision="float32"))
    totals = dict.fromkeys(COUNTED, 0)

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    print(f"[compiled loops] {_adam_table_check()}", flush=True)
    ds = synthetic.SyntheticAttackDataset(n_samples=16)
    norm = np.stack([ds[i][0] for i in range(16)])
    clean01 = torch.from_numpy(np.stack([ds.clip01(i) for i in range(16)])).cuda()
    ens = {"resnet": 2, "vgg": 3, "squeezenet": 2, "alexnet": 3}
    surr = get_image_models(list(ens), ens, device="cuda")

    def attack_call(build, clips, labels=None):
        def make(graphs):
            atk = build(graphs)

            def call():
                atk.loss_info = {}
                atk(clips, np.zeros(len(clips), np.int64) if labels is None else labels, ["v"])
                return _recorded_costs(atk)
            return call
        return make

    # -- the Adam engine and AENS at B=1
    add(_loop_twins(kernels, "ENS-I2V B=1 (Adam engine)", attack_call(
        lambda g: attacks.ImageGuidedFML2_Adam_MultiModels(surr, steps=LOOP_STEPS, graphs=g),
        norm[:1]), tmp, work=LOOP_STEPS))
    aens = get_image_models(list(ens), {n: [2, 3] for n in ens}, device="cuda")
    add(_loop_twins(kernels, "AENS-I2V-MF B=1 (Adam engine)", attack_call(
        lambda g: attacks.AENS_I2V_MF(aens, step_size=0.005, momentum=AENS_MOMENTUM,
                                      steps=LOOP_STEPS, graphs=g), norm[:1]),
        tmp, work=LOOP_STEPS))
    del aens

    # -- the runner at B=16
    def runner_call(models, steps, **kw):
        def make(graphs):
            run = sharded.make_sharded_i2v_runner(models, steps=steps, step_size=0.005,
                                                  graphs=graphs, **kw)
            return lambda: run(clean01)[1].float().cpu().numpy()
        return make

    add(_loop_twins(kernels, "runner B=16 float32 chunk 256", runner_call(
        surr, LOOP_B16_STEPS, frame_chunk=256), tmp, work=LOOP_B16_STEPS, peak_gate=True))
    surr16 = get_image_models(list(ens), ens, device="cuda", dtype=torch.bfloat16)
    add(_loop_twins(kernels, "runner B=16 bf16 whole", runner_call(
        surr16, LOOP_B16_STEPS, frame_chunk="auto", param_dtype=torch.bfloat16),
        tmp, work=LOOP_B16_STEPS, peak_gate=True))

    def mg_make(graphs):
        run = multigrid.make_multigrid_i2v_runner(
            surr16, steps=LOOP_MG_STEPS, coarse_steps=LOOP_MG_COARSE, frame_chunk="auto",
            param_dtype=torch.bfloat16, graphs=graphs)
        return lambda: run(clean01)[1].float().cpu().numpy()

    add(_loop_twins(kernels, f"multigrid bf16 B=16 ({LOOP_MG_COARSE} at 112^2)", mg_make, tmp,
                    work=LOOP_MG_STEPS, peak_gate=True))
    del surr16

    # -- ILAF on the truncated I3D-R50, its tap against the full model's
    taps = tap_keys_for("i3d_resnet50", "ilaf")
    full = get_video_model("i3d_resnet50", device="cuda", taps=taps)
    cut = get_video_model("i3d_resnet50", device="cuda", taps=taps, truncate=True)
    with torch.no_grad():
        if not torch.equal(full.apply01_taps(clean01[:1])[1][0],
                           cut.apply01_taps(clean01[:1])[1][0]):
            raise RuntimeError("the truncated I3D-R50's res_layer2 is not the full model's")
    n_full = sum(p.numel() for p in full.module.parameters())
    n_cut = sum(p.numel() for p in cut.module.parameters())
    del full
    adv_norm = pixel.normalize(torch.clamp(clean01[:1] + 0.8 * EPS * torch.sign(
        torch.randn(clean01[:1].shape, generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")), 0, 1), channel_axis=1).cpu().numpy()

    def ilaf_make(graphs):
        atk = attacks.ILAF(cut, "i3d", steps=LOOP_STEPS, graphs=graphs)

        def call():
            atk.loss_info = {}
            atk(adv_norm, norm[:1], [0], ["v"])
            return _recorded_costs(atk)
        return call

    print(f"[compiled loops] ILAF's I3D-R50 truncated at {taps}: {n_cut} of {n_full} "
          "parameters, res_layer2 bit for bit the full model's", flush=True)
    add(_loop_twins(kernels, "ILAF I3D-R50 B=1 (truncated)", ilaf_make, tmp, work=LOOP_STEPS))
    del cut

    # -- the sign engine on I3D-R50
    i3d = get_video_model("i3d_resnet50", device="cuda")
    for name, build in (("BIM", lambda g: attacks.BIM(i3d, steps=LOOP_STEPS, graphs=g)),
                        ("MIFGSM", lambda g: attacks.MIFGSM(i3d, steps=LOOP_STEPS, graphs=g)),
                        ("TAP", lambda g: attacks.TAP(i3d, steps=LOOP_STEPS, graphs=g))):
        add(_loop_twins(kernels, f"{name} I3D-R50 B=1", attack_call(build, norm[:1]), tmp,
                        work=LOOP_STEPS))
    mesh = attack_mesh([torch.device("cuda", 0)] * 4, data=4)

    def bim_mesh(graphs):
        atk = attacks.BIM(i3d, steps=LOOP_STEPS, graphs=graphs)
        atk.set_mesh(mesh)
        return atk

    add(_loop_twins(kernels, "BIM I3D-R50 B=4 over [cuda:0] x 4", attack_call(
        bim_mesh, norm[:4]), tmp, work=LOOP_STEPS))

    # -- DIFGSM and TT, their draws in device tables
    def drawn(label, build, rows_of, steps):
        """The twins of a drawing attack at B=1: K3 ``steps`` a call, and
        after each twin's first call its draw table equal to
        ``rows_of(attack, generator)``, the host draws of that call's
        generator (None: no table, TT's static moves)."""

        def make(graphs):
            atk, first = build(graphs), [True]

            def call():
                atk.loss_info = {}
                atk(norm[:1], np.zeros(1, np.int64), ["v"])
                if first:
                    first.clear()
                    (loop,) = atk._loops.values()
                    want = rows_of(atk, torch.Generator().manual_seed(atk._calls - 1))
                    got = [t.table.cpu().numpy() for t in loop.tables]
                    if not (got == [] if want is None else
                            len(got) == 1 and np.array_equal(got[0], want)):
                        raise RuntimeError(f"{label} (graphs={graphs}): the draw table "
                                           f"{got} is not the host draws {want}")
                return _recorded_costs(atk)
            return call

        add(_loop_twins(kernels, label, make, tmp, work=steps,
                        want={"rebuild_fwd": 0, "rebuild_bwd": 0, "sign_step": steps}))

    def di_rows(atk, gen):
        from i2v_tpu_torch.ops import diversity

        return np.asarray([[int(a), r, t, c] for a, r, t, c in (
            diversity.draw(gen, *diversity.default_range(224)) for _ in range(LOOP_STEPS))])

    for momentum in (False, True):
        drawn(f"DIFGSM{' momentum' if momentum else ''} I3D-R50 B=1",
              lambda g, m=momentum: attacks.DIFGSM(i3d, steps=LOOP_STEPS, momentum=m, graphs=g),
              di_rows, LOOP_STEPS)
    print("[compiled loops] DIFGSM: each twin's draw table equal to the host draws of its "
          "call's generator", flush=True)
    for move_type in ("adj", "random"):
        drawn(f"TT {move_type} I3D-R50 B=1 kernlen 15 chunk 5",
              lambda g, mt=move_type: attacks.TemporalTranslation(
                  i3d, dict(kernlen=15, chunk=5, move_type=mt), steps=LOOP_TT_STEPS, graphs=g),
              lambda atk, gen, mt=move_type: None if mt != "random" else np.asarray(
                  [atk._shifts(32, gen) for _ in range(LOOP_TT_STEPS)]), LOOP_TT_STEPS)
    print("[compiled loops] TT: 'adj' holds no draw table; 'random''s equal to the host "
          "draws of its call's generator", flush=True)
    del i3d

    # -- the model-axis runner and the Grad-CAM evaluator
    add(_ensemble_loop_twins(kernels, surr, norm[:2], [torch.device("cuda", 0)] * 4, tmp,
                             steps=LOOP_ENS_MP_STEPS))
    cams = get_image_models(list(gradcam_cli.CAM_MODELS), 4, device="cuda", truncate=False,
                            input_hw=224)

    def cam_make(graphs):
        fns = gradcam_cli._cam_fns(cams, graphs)
        return lambda: np.concatenate([gradcam_cli.average_cam_for_clips(
            norm[k * LOOP_CAM_BATCH:(k + 1) * LOOP_CAM_BATCH], fns, 224, "cuda")[0]
            for k in range(LOOP_EVAL_BATCHES)])

    _loop_twins(kernels, f"Grad-CAM evaluator B={LOOP_CAM_BATCH}, "
                f"{len(cams)} CAM models", cam_make, tmp,
                work=LOOP_CAM_BATCH * LOOP_EVAL_BATCHES, unit="clips", atol=CAM_ATOL,
                want=dict.fromkeys(K1_TO_K3, 0))
    del cams

    # -- evaluation: logits bit for bit, then the single pass and a fused run
    tmp_eval = os.path.join(tmp, "loops_eval")
    os.makedirs(tmp_eval, exist_ok=True)
    for label in range(16 * LOOP_EVAL_BATCHES):
        artifacts.save_adv_clip(tmp_eval, label, norm[label % 16])
    batches = artifacts.batch_files(artifacts.list_adv_files(tmp_eval), 16)
    x = torch.from_numpy(norm).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        bundles = {n: get_video_model(n, device="cuda", dtype=dtype)
                   for n in VIDEO_MODEL_NAMES}
        for n, b in bundles.items():
            eager = Replicas(b, graphs=False).logits(x, None).clone()
            graphed = Replicas(b)
            graphed.logits(x, None)              # eager warm-up
            replayed = graphed.logits(x, None)   # captured and replayed
            if not torch.equal(eager, replayed):
                raise RuntimeError(f"{n} {dtype}: replayed logits differ from eager ones")
        print(f"[compiled loops] six models in {dtype}: replayed logits bit for bit the "
              "eager ones", flush=True)

        def sp_make(graphs, bundles=bundles):
            def call():
                preds, _, _ = single_pass_eval(bundles, batches, tmp_eval, log=lambda *_: None,
                                               graphs=graphs)
                return np.asarray([preds[n] for n in bundles])
            return call

        _loop_twins(kernels, f"single pass B=16 {str(dtype).split('.')[-1]}, six models",
                    sp_make, tmp, work=16 * LOOP_EVAL_BATCHES, unit="clips")
        del bundles
    bundles = {n: get_video_model(n, device="cuda") for n in VIDEO_MODEL_NAMES}

    def fused_make(graphs):
        atk = attacks.ImageGuidedFML2_Adam_MultiModels(surr, steps=LOOP_STEPS, graphs=graphs)

        def call():
            f = FusedGenerateEvaluate(atk, bundles, run_dir=None, graphs=graphs)
            atk.loss_info = {}
            for i in range(LOOP_FUSED_BATCHES):
                f.process_batch({"clips": norm[2 * i:2 * i + 2], "labels": np.arange(2) + 2 * i,
                                 "names": [f"batch{i}"]})
            f.finalize()
            return _recorded_costs(atk)
        return call

    add(_loop_twins(kernels, "fused ENS-I2V B=2 + six models", fused_make, tmp,
                    work=LOOP_STEPS * LOOP_FUSED_BATCHES))
    del bundles, surr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[compiled loops] done in {time.time() - t0:.2f} s ({card})", flush=True)
    return totals


def phase_swin(kernels, evaluate_cli, get_video_model, run_dir: str) -> dict:
    """Full-width Video Swin-B over the slice's adversarial clips through
    the evaluation CLI (``--models swin3d_b``) at batch 1, serially and then
    in one pass, the model built once: the serial run's first forward is
    eager, its second captured and replayed, and every later one replayed.
    Each forward launches the window-attention kernel once a block, counted
    from a reset at the phase's start; the two reports are identical and of
    the one model's schema; the card's logits of the clips with the kernel
    lie within SWIN_LOGIT_TOL of those with the plain attention. Returns
    the launch counts."""
    import argparse

    from i2v_tpu_torch.cli import common as cli_common
    from i2v_tpu_torch.models import swin3d
    from i2v_tpu_torch.utils import artifacts, graphs

    t0 = time.time()
    cli_common.apply_matmul_precision(argparse.Namespace(matmul_precision="float32"))
    bundle = get_video_model("swin3d_b", device="cuda")
    files = artifacts.list_adv_files(run_dir)
    captured = graphs.captures["graphs"]
    kernels.reset_launches()
    reports, rates = {}, {}
    for mode in ("serial", "single pass"):
        argv = ["--adv_path", run_dir, "--device", "cuda", "--matmul_precision", "float32",
                "--models", "swin3d_b", "--batch_size", "1"]
        args = evaluate_cli.arg_parse(argv + (["--single_pass"] if mode == "single pass" else []))
        acc = evaluate_cli.run(args, get_bundle=lambda name: bundle)
        with open(os.path.join(run_dir, REPORT_CSV)) as f:
            reports[mode] = (f.read(), acc)
        rates[mode] = next(iter(args.throughput.values()))["clips_per_sec"]
    counts = dict(kernels.launches)
    forwards = 2 * len(files)
    want = {"window_attn": SWIN_BLOCKS * forwards, "rebuild_fwd": 0, "rebuild_bwd": 0,
            "sign_step": 0, "bias_act": 0, "pool_attn": 0, "pool_qkv": 0, "dwconv3d": 0,
            "global_attn": 0}
    if _of(counts, want) != want or graphs.captures["graphs"] != captured + 1:
        raise RuntimeError(f"swin: launch counts {counts}, expected {want}; "
                           f"{graphs.captures['graphs'] - captured} capture(s), expected 1")
    if reports["serial"] != reports["single pass"]:
        raise RuntimeError(f"swin: serial and single-pass reports differ: {reports}")
    rows = reports["serial"][0].split("\n")
    if rows[0] != "gt_label,swin3d_b-pre" or len(rows) != 402 or list(reports["serial"][1]) \
            != ["swin3d_b"]:
        raise RuntimeError(f"swin: reports off the schema: {rows[:3]}…, {len(rows)} lines")

    clips, _ = artifacts.load_adv_batch(run_dir, files)
    x = torch.from_numpy(clips).cuda()
    with torch.inference_mode():
        logits = bundle.apply_norm(x).float()
        kernel_path = swin3d.window_attention
        swin3d.window_attention = swin3d.window_attention_plain
        try:
            plain = bundle.apply_norm(x).float()
        finally:
            swin3d.window_attention = kernel_path
    gap = float((logits - plain).abs().max() / plain.std())
    if not gap <= SWIN_LOGIT_TOL:
        raise RuntimeError(f"swin: logits with the kernel off those with the plain attention "
                           f"by {gap:.3g} of their std (limit {SWIN_LOGIT_TOL})")
    print(f"[swin] Video Swin-B at full width (32x224^2, 400 classes, random weights, TF32 "
          f"off) over {len(files)} adversarial clips at batch 1: serial "
          f"{rates['serial']:.3f} clips/s (the first forward eager, the second captured), "
          f"single pass {rates['single pass']:.3f} clips/s (replayed); one capture; "
          f"launches {counts} ({SWIN_BLOCKS} a forward over {forwards}); reports identical, "
          f"top-1 {reports['serial'][1]}; logits with the kernel vs the plain attention "
          f"{gap:.3g} of their std (limit {SWIN_LOGIT_TOL}); phase wall "
          f"{time.time() - t0:.2f} s", flush=True)
    return counts


def _pool_qkv(kernels) -> dict:
    """MViTv2-B's q, k and v pooling: the kernel (``mvit.pool_qkv``) against
    its plain path (``mvit.pool_qkv_plain``, three ``attention_pool`` calls:
    copy, conv, cat, LayerNorm) at POOL_QKV_SHAPE, B=16, within POOL_QKV_TOL,
    one launch; then timed in turns with the plain path, beside its bound:
    each input row a tap touches read once, each output row written once, at
    HBM_BYTES_PER_S."""
    from i2v_tpu_torch.models import mvit

    heads, grid, stride_q, stride_kv = POOL_QKV_SHAPE
    spec = mvit.BlockSpec(96 * heads, 96 * heads, heads, stride_q, stride_kv, grid)
    attn = mvit.MultiScaleAttention(spec, (3, 3, 3)).cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(27)
    with torch.no_grad():
        for conv in (attn.pool_q, attn.pool_k, attn.pool_v):
            conv.weight.normal_(0, 27 ** -0.5, generator=gen)
        for norm in (attn.norm_q, attn.norm_k, attn.norm_v):
            norm.weight.normal_(1, 0.01, generator=gen)
            norm.bias.normal_(0, 0.01, generator=gen)
    b = POOL_QKV_BATCH
    qkv = torch.randn(b, 1 + math.prod(grid), 3, heads, 96, device="cuda", generator=gen)
    kernels.reset_launches()
    got = mvit.pool_qkv(qkv, attn, grid)
    want = mvit.pool_qkv_plain(qkv, attn, grid)
    if kernels.launches["pool_qkv"] != 1 or got[3:] != want[3:]:
        raise RuntimeError(f"pool_qkv: launches {kernels.launches['pool_qkv']}, grids "
                           f"{got[3:]} and {want[3:]}")
    rtol, atol = POOL_QKV_TOL
    err = 0.0
    for name, g, w in zip("qkv", got[:3], want[:3]):
        diff = (g - w).abs()
        if g.shape != w.shape or not g.isfinite().all() or (diff > atol + rtol * w.abs()).any():
            raise RuntimeError(f"pool_qkv differs from its plain path ({name}): max |diff| "
                               f"{float(diff.max()):.3g}")
        err = max(err, float(diff.max()))
    del got, want

    def touched(n_out, s, n_in):  # input indices an axis's taps hit
        return len({o * s - 1 + d for o in range(n_out) for d in range(3)} & set(range(n_in)))

    nbytes = 0
    for stride in (stride_q, stride_kv, stride_kv):
        out = [(n - 1) // s + 1 for n, s in zip(grid, stride)]
        read = math.prod(touched(o, s, n) for o, s, n in zip(out, stride, grid))
        nbytes += b * heads * 96 * 4 * ((1 + read) + (1 + math.prod(out)))
    bound = (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")
    fns = [lambda: mvit.pool_qkv(qkv, attn, grid), lambda: mvit.pool_qkv_plain(qkv, attn, grid)]
    first_turn = [_time_ms(f, POOL_QKV_ITERS) for f in fns]
    second_turn = [_time_ms(f, POOL_QKV_ITERS) for f in reversed(fns)][::-1]
    ms = [(x + y) / 2 for x, y in zip(first_turn, second_turn)]
    del qkv, fns
    torch.cuda.empty_cache()
    kernels.reset_launches()
    print(f"[mvit] pool_qkv within {POOL_QKV_TOL} (rtol, atol) of its plain path (max |diff| "
          f"{err:.3g}) at B={b} on blocks 0-1 ({heads} head, grid {grid}, q stride {stride_q}, "
          f"k and v {stride_kv}): kernel {ms[0]:.4f} ms ({first_turn[0]:.4f}, "
          f"{second_turn[0]:.4f}), bound {bound[0]:.4f} ms by bytes ({nbytes / 1e6:.1f} MB; "
          f"{bound[0] / ms[0]:.1%} of it), plain path (copy, conv, cat, LayerNorm) "
          f"{ms[1]:.4f} ms", flush=True)
    return {"err": err, "times": (ms[0], ms[1]), "bound": bound, "library": None}


def phase_mvit(kernels, evaluate_cli, get_video_model, run_dir: str) -> tuple:
    """Full-width MViTv2-B over the slice's adversarial clips through the
    evaluation CLI (``--models mvit_v2_b``) at batch 1, serially and then in
    one pass, the model built once, as :func:`phase_swin` runs Swin-B: one
    capture; each forward launches the pooling-attention kernel once a block
    and no other kernel; the two reports are identical and of the one
    model's schema; the card's logits of the clips with the kernels lie
    within MVIT_LOGIT_TOL of those with both plain paths. First the q, k
    and v pooling alone (:func:`_pool_qkv`). Returns the launch counts and
    the pooling's measurements."""
    import argparse

    from i2v_tpu_torch.cli import common as cli_common
    from i2v_tpu_torch.models import mvit
    from i2v_tpu_torch.utils import artifacts, graphs

    t0 = time.time()
    cli_common.apply_matmul_precision(argparse.Namespace(matmul_precision="float32"))
    pooling = _pool_qkv(kernels)
    bundle = get_video_model("mvit_v2_b", device="cuda")
    files = artifacts.list_adv_files(run_dir)
    captured = graphs.captures["graphs"]
    kernels.reset_launches()
    reports, rates = {}, {}
    for mode in ("serial", "single pass"):
        argv = ["--adv_path", run_dir, "--device", "cuda", "--matmul_precision", "float32",
                "--models", "mvit_v2_b", "--batch_size", "1"]
        args = evaluate_cli.arg_parse(argv + (["--single_pass"] if mode == "single pass" else []))
        acc = evaluate_cli.run(args, get_bundle=lambda name: bundle)
        with open(os.path.join(run_dir, REPORT_CSV)) as f:
            reports[mode] = (f.read(), acc)
        rates[mode] = next(iter(args.throughput.values()))["clips_per_sec"]
    counts = dict(kernels.launches)
    forwards = 2 * len(files)
    want = dict(dict.fromkeys(COUNTED, 0), pool_attn=MVIT_BLOCKS * forwards,
                pool_qkv=MVIT_BLOCKS * forwards)
    if counts != want or graphs.captures["graphs"] != captured + 1:
        raise RuntimeError(f"mvit: launch counts {counts}, expected {want}; "
                           f"{graphs.captures['graphs'] - captured} capture(s), expected 1")
    if reports["serial"] != reports["single pass"]:
        raise RuntimeError(f"mvit: serial and single-pass reports differ: {reports}")
    rows = reports["serial"][0].split("\n")
    if rows[0] != "gt_label,mvit_v2_b-pre" or len(rows) != 402 or list(reports["serial"][1]) \
            != ["mvit_v2_b"]:
        raise RuntimeError(f"mvit: reports off the schema: {rows[:3]}…, {len(rows)} lines")

    clips, _ = artifacts.load_adv_batch(run_dir, files)
    x = torch.from_numpy(clips).cuda()
    with torch.inference_mode():
        logits = bundle.apply_norm(x).float()
        kernel_paths = mvit.pool_attention, mvit.pool_qkv
        mvit.pool_attention, mvit.pool_qkv = mvit.pool_attention_plain, mvit.pool_qkv_plain
        try:
            plain = bundle.apply_norm(x).float()
        finally:
            mvit.pool_attention, mvit.pool_qkv = kernel_paths
    gap = float((logits - plain).abs().max() / plain.std())
    if not gap <= MVIT_LOGIT_TOL:
        raise RuntimeError(f"mvit: logits with the kernels off those with the plain paths "
                           f"by {gap:.3g} of their std (limit {MVIT_LOGIT_TOL})")
    print(f"[mvit] MViTv2-B at full width (32x224^2, 400 classes, random weights, TF32 off) "
          f"over {len(files)} adversarial clips at batch 1: serial {rates['serial']:.3f} "
          f"clips/s (the first forward eager, the second captured), single pass "
          f"{rates['single pass']:.3f} clips/s (replayed); one capture; launches {counts} "
          f"({MVIT_BLOCKS} a forward over {forwards}); reports identical, top-1 "
          f"{reports['serial'][1]}; logits with the kernels vs the plain paths {gap:.3g} "
          f"of their std (limit {MVIT_LOGIT_TOL}); phase wall {time.time() - t0:.2f} s",
          flush=True)
    return counts, pooling


def _dwconv3d(kernels) -> dict:
    """UniFormer-B's depthwise 3-D convs: the kernel (``uniformer.dwconv3d``)
    against its plain path (``uniformer.dwconv3d_plain``: the grouped conv on
    an NCDHW view, the residual added) at DWCONV3D_SHAPES, B=16, within
    DWCONV3D_TOL, one launch each; then timed in turns with the plain path and
    aten's conv alone (on an NCDHW tensor: ``conv_depthwise3d``), beside its
    bound: the larger of 2·k³ FLOPs an output over F32_OPS_PER_S and x and
    out moved once over HBM_BYTES_PER_S. Sums over a forward's 53 launches
    a clip."""
    import torch.nn.functional as F

    from i2v_tpu_torch.models import uniformer

    gen = torch.Generator(device="cuda").manual_seed(34)
    b, err, facts = DWCONV3D_BATCH, 0.0, []
    forward = {"kernel": 0.0, "plain": 0.0, "aten": 0.0, "bound": 0.0}
    for label, k, dim, thw, count in DWCONV3D_SHAPES:
        conv = uniformer.depthwise(dim, k).cuda().requires_grad_(False)
        with torch.no_grad():
            conv.weight.normal_(0, k ** -1.5, generator=gen)
            conv.bias.normal_(0, 0.01, generator=gen)
        residual = k == 3
        n = math.prod(thw)
        x = torch.randn(b, n, dim, device="cuda", generator=gen)
        kernels.reset_launches()
        got = uniformer.dwconv3d(x, thw, conv, residual)
        want = uniformer.dwconv3d_plain(x, thw, conv, residual)
        rtol, atol = DWCONV3D_TOL
        diff = (got - want).abs()
        if kernels.launches["dwconv3d"] != 1 or got.shape != want.shape \
                or not got.isfinite().all() or (diff > atol + rtol * want.abs()).any():
            raise RuntimeError(f"dwconv3d differs from its plain path at {label}: launches "
                               f"{kernels.launches['dwconv3d']}, max |diff| "
                               f"{float(diff.max()):.3g}")
        err = max(err, float(diff.max()))
        del got, want, diff
        grid = x.transpose(1, 2).reshape(b, dim, *thw).contiguous()
        fns = [lambda: uniformer.dwconv3d(x, thw, conv, residual),
               lambda: uniformer.dwconv3d_plain(x, thw, conv, residual),
               lambda: F.conv3d(grid, conv.weight, conv.bias, padding=k // 2, groups=dim)]
        first_turn = [_time_ms(f, DWCONV3D_ITERS) for f in fns]
        second_turn = [_time_ms(f, DWCONV3D_ITERS) for f in reversed(fns)][::-1]
        ms = [(p + q) / 2 for p, q in zip(first_turn, second_turn)]
        flops, nbytes = 2 * k ** 3 * dim * n * b, 2 * dim * n * b * 4
        bound = max(flops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        for key, v in zip(("kernel", "plain", "aten", "bound"), (*ms, bound)):
            forward[key] += count * v / b
        facts.append(f"{label} ({k}^3, C {dim}, {thw}): kernel {ms[0]:.4f} ms "
                     f"({first_turn[0]:.4f}, {second_turn[0]:.4f}), bound {bound:.4f} ms by "
                     f"{'FLOPs' if flops / F32_OPS_PER_S > nbytes / HBM_BYTES_PER_S else 'bytes'}"
                     f" ({bound / ms[0]:.1%} of it), plain {ms[1]:.4f}, aten's conv "
                     f"{ms[2]:.4f} ({ms[2] / ms[0]:.2f}x the kernel)")
        del x, grid, fns
    torch.cuda.empty_cache()
    kernels.reset_launches()
    print(f"[uniformer] dwconv3d within {DWCONV3D_TOL} (rtol, atol) of its plain path (max "
          f"|diff| {err:.3g}) at B={b}: " + "; ".join(facts) + f"; a forward's "
          f"{UNIFORMER_LAUNCHES} launches a clip: kernel {forward['kernel']:.4f} ms, bound "
          f"{forward['bound']:.4f} ms ({forward['bound'] / forward['kernel']:.1%}), aten's conv "
          f"{forward['aten']:.4f} ms ({forward['aten'] / forward['kernel']:.2f}x), plain path "
          f"{forward['plain']:.4f} ms", flush=True)
    return {"err": err, "times": (forward["kernel"], forward["plain"]),
            "bound": (forward["bound"], f"a forward's {UNIFORMER_LAUNCHES} launches a clip"),
            "library": forward["aten"]}


def _plain_attention(q, k, v):
    """The plain attention in the projection's layout, as
    ``uniformer.global_attention`` returns it."""
    from i2v_tpu_torch.models import uniformer

    return uniformer.global_attention_plain(q, k, v).transpose(1, 2).flatten(2)


def _global_attn(kernels) -> dict:
    """UniFormer-B's global attention at B=16 at GLOBAL_ATTN_SHAPES, q, k
    and v read from one qkv tensor as the model views them: the kernel
    (``uniformer.global_attention``) against the plain attention within
    GLOBAL_ATTN_TOL, one launch each; then timed in turns with the plain
    attention and SDPA pinned to its memory-efficient backend (``sdpa_kernel``
    raises where that backend cannot run the call), beside its bound: 4·N²·64
    FLOPs a (clip, head) over TF32_OPS_PER_S / 3, or q, k, v and o moved once
    over HBM_BYTES_PER_S. Sums over a forward's 27 launches a clip."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from i2v_tpu_torch.models import uniformer

    def sdpa(q, k, v):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v)

    gen = torch.Generator(device="cuda").manual_seed(35)
    b, err, facts = DWCONV3D_BATCH, 0.0, []
    forward = {"kernel": 0.0, "plain": 0.0, "sdpa": 0.0, "bound": 0.0}
    for label, heads, n, count in GLOBAL_ATTN_SHAPES:
        qkv = torch.randn(b, n, 3, heads, 64, device="cuda", generator=gen)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        kernels.reset_launches()
        got = uniformer.global_attention(q, k, v)
        want = _plain_attention(q, k, v)
        diff = float((got - want).abs().max())
        if kernels.launches["global_attn"] != 1 or got.shape != want.shape \
                or not got.isfinite().all() or not diff <= GLOBAL_ATTN_TOL:
            raise RuntimeError(f"global_attn differs from the plain attention at {label}: "
                               f"launches {kernels.launches['global_attn']}, max |diff| {diff:.3g}")
        err = max(err, diff)
        del got, want
        fns = [lambda: uniformer.global_attention(q, k, v), lambda: _plain_attention(q, k, v),
               lambda: sdpa(q, k, v)]
        first_turn = [_time_ms(f, GLOBAL_ATTN_ITERS) for f in fns]
        second_turn = [_time_ms(f, GLOBAL_ATTN_ITERS) for f in reversed(fns)][::-1]
        ms = [(p + r) / 2 for p, r in zip(first_turn, second_turn)]
        flops, nbytes = 4 * b * heads * n * n * 64, 4 * b * heads * n * 64 * 4
        bound = max(3 * flops / TF32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        for key, value in zip(("kernel", "plain", "sdpa", "bound"), (*ms, bound)):
            forward[key] += count * value / b
        facts.append(f"{label} ({heads} heads x {n}^2 x 64): kernel {ms[0]:.4f} ms "
                     f"({first_turn[0]:.4f}, {second_turn[0]:.4f}; {flops / ms[0] / 1e9:.1f} "
                     f"TFLOP/s, {bound / ms[0]:.1%} of its {bound:.4f} ms 3xTF32 bound), plain "
                     f"{ms[1]:.4f}, SDPA {ms[2]:.4f} ({flops / ms[2] / 1e9:.1f} TFLOP/s, "
                     f"{ms[2] / ms[0]:.2f}x the kernel)")
        del qkv, q, k, v, fns
    torch.cuda.empty_cache()
    kernels.reset_launches()
    print(f"[uniformer] global_attn within {GLOBAL_ATTN_TOL} of the plain attention (max |diff| "
          f"{err:.3g}) at B={b}: " + "; ".join(facts) + f"; a forward's "
          f"{UNIFORMER_ATTN_LAUNCHES} launches a clip: kernel {forward['kernel']:.4f} ms, bound "
          f"{forward['bound']:.4f} ms ({forward['bound'] / forward['kernel']:.1%}), SDPA "
          f"{forward['sdpa']:.4f} ms ({forward['sdpa'] / forward['kernel']:.2f}x), plain "
          f"{forward['plain']:.4f} ms", flush=True)
    return {"err": err, "times": (forward["kernel"], forward["plain"]),
            "bound": (forward["bound"], f"a forward's {UNIFORMER_ATTN_LAUNCHES} launches a clip"),
            "library": forward["sdpa"]}


def phase_uniformer(kernels, evaluate_cli, get_video_model, run_dir: str) -> tuple:
    """Full-width UniFormer-B over the slice's adversarial clips through the
    evaluation CLI (``--models uniformer_b``) at batch 1, serially and then
    in one pass, the model built once, as :func:`phase_mvit` runs MViTv2-B:
    one capture; each forward launches the depthwise conv kernel 53 times,
    the global attention kernel 27 times and no other kernel; the two
    reports are identical and of the one model's schema; the card's logits
    of the clips lie within UNIFORMER_LOGIT_TOL of those with both plain
    paths (the grouped conv and the plain attention). First each kernel alone
    (:func:`_dwconv3d`, :func:`_global_attn`). Returns the launch counts and
    both kernels' measurements."""
    import argparse

    from i2v_tpu_torch.cli import common as cli_common
    from i2v_tpu_torch.models import uniformer
    from i2v_tpu_torch.utils import artifacts, graphs

    t0 = time.time()
    cli_common.apply_matmul_precision(argparse.Namespace(matmul_precision="float32"))
    conv = _dwconv3d(kernels)
    attention = _global_attn(kernels)
    bundle = get_video_model("uniformer_b", device="cuda")
    files = artifacts.list_adv_files(run_dir)
    captured = graphs.captures["graphs"]
    kernels.reset_launches()
    reports, rates = {}, {}
    for mode in ("serial", "single pass"):
        argv = ["--adv_path", run_dir, "--device", "cuda", "--matmul_precision", "float32",
                "--models", "uniformer_b", "--batch_size", "1"]
        args = evaluate_cli.arg_parse(argv + (["--single_pass"] if mode == "single pass" else []))
        acc = evaluate_cli.run(args, get_bundle=lambda name: bundle)
        with open(os.path.join(run_dir, REPORT_CSV)) as f:
            reports[mode] = (f.read(), acc)
        rates[mode] = next(iter(args.throughput.values()))["clips_per_sec"]
    counts = dict(kernels.launches)
    forwards = 2 * len(files)
    want = dict(dict.fromkeys(COUNTED, 0), dwconv3d=UNIFORMER_LAUNCHES * forwards,
                global_attn=UNIFORMER_ATTN_LAUNCHES * forwards)
    if counts != want or graphs.captures["graphs"] != captured + 1:
        raise RuntimeError(f"uniformer: launch counts {counts}, expected {want}; "
                           f"{graphs.captures['graphs'] - captured} capture(s), expected 1")
    if reports["serial"] != reports["single pass"]:
        raise RuntimeError(f"uniformer: serial and single-pass reports differ: {reports}")
    rows = reports["serial"][0].split("\n")
    if rows[0] != "gt_label,uniformer_b-pre" or len(rows) != 402 \
            or list(reports["serial"][1]) != ["uniformer_b"]:
        raise RuntimeError(f"uniformer: reports off the schema: {rows[:3]}…, {len(rows)} lines")

    clips, _ = artifacts.load_adv_batch(run_dir, files)
    x = torch.from_numpy(clips).cuda()
    with torch.inference_mode():
        logits = bundle.apply_norm(x).float()
        fast = uniformer.dwconv3d, uniformer.global_attention
        uniformer.dwconv3d = uniformer.dwconv3d_plain
        uniformer.global_attention = _plain_attention
        try:
            plain = bundle.apply_norm(x).float()
        finally:
            uniformer.dwconv3d, uniformer.global_attention = fast
    gap = float((logits - plain).abs().max() / plain.std())
    if not gap <= UNIFORMER_LOGIT_TOL:
        raise RuntimeError(f"uniformer: logits with the kernels off those with the plain paths "
                           f"by {gap:.3g} of their std (limit {UNIFORMER_LOGIT_TOL})")
    print(f"[uniformer] UniFormer-B at full width (32x224^2, 400 classes, random weights, TF32 "
          f"off) over {len(files)} adversarial clips at batch 1: serial {rates['serial']:.3f} "
          f"clips/s (the first forward eager, the second captured), single pass "
          f"{rates['single pass']:.3f} clips/s (replayed); one capture; launches {counts} "
          f"({UNIFORMER_LAUNCHES} and {UNIFORMER_ATTN_LAUNCHES} a forward over {forwards}); "
          f"reports identical, top-1 {reports['serial'][1]}; logits with the kernels vs the "
          f"plain paths "
          f"{gap:.3g} of their std (limit {UNIFORMER_LOGIT_TOL}); phase wall "
          f"{time.time() - t0:.2f} s", flush=True)
    return counts, {"dwconv3d": conv, "global_attn": attention}


def main() -> None:
    name, card = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from i2v_tpu_torch.cli import attack as attack_cli
    from i2v_tpu_torch.cli import attack_ucf101
    from i2v_tpu_torch.cli import evaluate as evaluate_cli
    from i2v_tpu_torch.cli import fine_tune, image_main
    from i2v_tpu_torch.data import synthetic
    from i2v_tpu_torch.models import get_video_model
    from i2v_tpu_torch.ops import kernels, pixel

    t0 = time.time()
    mean = np.asarray(pixel.IMAGENET_MEAN, np.float32)[:, None, None, None]
    std = np.asarray(pixel.IMAGENET_STD, np.float32)[:, None, None, None]
    video_models: dict = {}

    def get_bundle(name):  # each full-width video model is built once
        if name not in video_models:
            video_models[name] = get_video_model(name, device="cuda")
        return video_models[name]

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["I2V_TPU_OPT_PATH"] = os.path.join(tmp, "outputs")
        phase_build(kernels)
        measured = phase_kernels(kernels, pixel)
        counts, slice_dir = phase_slice(kernels, image_main, synthetic, (mean, std))
        phase_parity(image_main)
        eval_counts = phase_eval(evaluate_cli, get_bundle, kernels, slice_dir)
        fused_counts = phase_fused(kernels, image_main, evaluate_cli, get_bundle, (mean, std))
        video_models.clear()  # the later phases' peaks hold no video model
        counts["sign_step"] = phase_whitebox(kernels, attack_cli, synthetic, (mean, std))
        counts["sign_step"] += phase_whitebox_slowfast(kernels, attack_cli, synthetic, pixel,
                                                       (mean, std))
        phase_whitebox_parity(attack_cli, synthetic)
        phase_eval_parity(evaluate_cli, get_video_model, pixel)
        for path_counts in (eval_counts, fused_counts,
                            phase_aens(kernels, image_main, synthetic, (mean, std)),
                            phase_dr(kernels, image_main, synthetic, (mean, std)),
                            phase_ilaf(kernels, fine_tune, synthetic, (mean, std))):
            for k in counts:
                counts[k] += path_counts[k]
        phase_aens_ilaf_parity(image_main)
        counts["sign_step"] += phase_wb_family(kernels, attack_cli, synthetic, (mean, std))
        counts["sign_step"] += phase_tt(kernels, attack_cli, synthetic, (mean, std))
        counts["sign_step"] += phase_remat(kernels, attack_cli, synthetic)
        counts["sign_step"] += phase_ucf101(kernels, attack_cli, attack_ucf101, synthetic,
                                            (mean, std))
        phase_wb_family_parity(attack_cli, synthetic)
        for path_counts in (phase_chunked_aens(kernels, image_main, synthetic, (mean, std),
                                               card),
                            phase_chunk_equality(kernels, image_main, synthetic),
                            phase_multigrid(kernels, image_main, synthetic, (mean, std))):
            for k in counts:
                counts[k] += path_counts[k]
        phase_runner_parity(image_main)
        phase_converters(kernels, synthetic, pixel, card, tmp)
        real = phase_real_data(kernels, image_main, attack_cli, attack_ucf101, evaluate_cli,
                               pixel, card, tmp)
        zoo = phase_zoo_gradcam(kernels, image_main, synthetic, get_bundle, (mean, std), tmp)
        video_models.clear()
        bf16 = phase_bf16(kernels, evaluate_cli, synthetic, pixel, card, tmp)
        multi = phase_multi_device(kernels, image_main, evaluate_cli, synthetic, (mean, std),
                                   card, tmp)
        measured_tools = phase_measurement_tools(card, tmp)
        loops = phase_compiled_loops(kernels, synthetic, pixel, card, tmp)
        swin = phase_swin(kernels, evaluate_cli, get_video_model, slice_dir)
        multiscale, pooling = phase_mvit(kernels, evaluate_cli, get_video_model, slice_dir)
        hybrid, local = phase_uniformer(kernels, evaluate_cli, get_video_model, slice_dir)
        for kernel, m in {"pool_qkv": pooling, **local}.items():
            for key in ("err", "times", "library"):
                measured[key][kernel] = m[key]
            measured["bounds"][kernel] = m["bound"]
        for k in counts:
            counts[k] += (real[k] + zoo[k] + bf16[k] + multi[k] + measured_tools[k] + loops[k]
                          + swin[k] + multiscale[k] + hybrid[k])
    print(f"[done] every phase passed in {time.time() - t0:.2f} s after the device check")

    where = {"rebuild_fwd": ("i2v_tpu_torch/csrc/rebuild_adv.cu",
                             "i2v_tpu/ops/pallas_kernels.py:142"),
             "rebuild_bwd": ("i2v_tpu_torch/csrc/rebuild_adv.cu",
                             "i2v_tpu/ops/pallas_kernels.py:149"),
             "sign_step": ("i2v_tpu_torch/csrc/sign_step.cu",
                           "i2v_tpu/ops/pallas_kernels.py:94"),
             # XLA fuses the conv epilogue into the conv: no TPU kernel
             "bias_act": ("i2v_tpu_torch/csrc/bias_act.cu", None),
             # the JAX package has no Swin: no TPU kernel
             "window_attn": ("i2v_tpu_torch/csrc/window_attn.cu", None),
             # nor an MViT
             "pool_attn": ("i2v_tpu_torch/csrc/pool_attn.cu", None),
             "pool_qkv": ("i2v_tpu_torch/csrc/pool_qkv.cu", None),
             # nor a UniFormer
             "dwconv3d": ("i2v_tpu_torch/csrc/dwconv3d.cu", None),
             "global_attn": ("i2v_tpu_torch/csrc/global_attn.cu", None)}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": counts[k],
         "max_abs_err": measured["err"][k], "ms": measured["times"][k][0],
         "plain_ms": measured["times"][k][1], "bound_ms": measured["bounds"][k][0],
         "bound_by": measured["bounds"][k][1],
         # no single PyTorch call computes K1-K3; the epilogue's yardstick is
         # torch.relu(t.add_(b)) at VGG-16's conv1_2 over 256 frames, window
         # attention's F.scaled_dot_product_attention with the bias as its
         # mask at Swin-B's unshifted stage-1 blocks, B=16, pooling
         # attention's with the relative terms as its mask and the residual
         # added at MViTv2-B's blocks 0-1, B=16; no single call pools q, k
         # and v; the depthwise convs' yardstick is aten's grouped conv
         # (conv_depthwise3d) over a forward's 53 launches at B=16, a clip,
         # the global attention's SDPA's memory-efficient backend over a
         # forward's 27
         "library_ms": measured["library"].get(k)}
        for k, (src, rep) in where.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
