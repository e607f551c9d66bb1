"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: the six CUDA sources (B1, K1 and K2 csrc/conv_gn_mish.cu, B1's bf16 form
   csrc/conv_gn_mish_bf16.cu (and K1's bf16 form), B2 csrc/conv1d_weight_grad.cu, its bf16
   form csrc/conv1d_weight_grad_bf16.cu, B3, K3 and B4 with their bf16 forms
   csrc/local_attention.cu,
   B5-B7 csrc/humanoid_dynamics.cu), compiled in
   parallel with nvcc,
   one process each, with ptxas's register and spill lines.
3. kernels: each kernel against its plain PyTorch version at every shape
   the dim-128 U-Net gives it on the main paths: B1 at B 16 for serving
   (H 64 and H 48, plus level 0 at H 192) and at B 32 for a training
   micro-step (H 160), B2 at B 32 (H 160). Max error, and per-launch times
   of the kernel, the plain version and the library yardstick, beside the
   card's bound for the same work. The card is warmed first (WARM_S of
   matrix products), B1's shapes are all checked before any is timed, and
   B1's first shape is timed again last (within RETIME_TOL); each B1 row
   carries its launch plan (cluster size, batch rows per cluster, CTAs,
   CTAs per SM the card holds) and its time over the composition's. Each
   B2 row carries its plan (channel tile, rows per chunk, stages, cluster,
   slices), its path (3xTF32) and, beside the f32 bound, the 3xTF32 bound;
   where the plan splits the rows over a cluster, a second launch must give
   the same bits.
4. serve: a dim-128 run directory (config.json + a checkpoint from a seeded
   random init) answered through ``cli.sample.main`` (posterior T=1000,
   B 16, H 64, holding_box; then H 48), with B1's launch count set to 0
   just before and read just after each request; DDIM-50 through
   ``sample_loop``; one U-Net forward with the kernel against the same
   forward with the plain version, at H 64 and H 48; chain throughput; the
   serving profile (device kernel time by name and busy share over 50
   posterior steps, and the host time of one conv block call).
5. train, the slice's main path: ``cli.train.main`` with the user config
   experiments/unet_walk10k/config.json read from disk, on the cartwheel
   clip (H 160, 160 cyclic variants), B 64 taken as 32 x
   gradient_accumulate_every 2, cut to 30 optimizer steps with the EMA,
   periodic saves, logs and the best-model window all firing. Both
   kernels' counts are set to 0 just before and read just after: each must
   be 33 per micro-step. Then one ``cli.sample.main`` request answered from
   the trained run, with its clamped dims exact.
6. grads: one full B 64 step at H 160 with both kernels against the same
   step with both plain versions: the loss and every parameter's gradient.
7. train profile: ms per optimizer step (host clock, 10 steps), device
   kernel time per step by name, the host operators with the most CPU time
   and the device's busy share (torch.profiler over PROFILE_STEPS steps), and peak
   device memory.
8. local-attention kernels: B3 (``fused_qkv_local_attention``) against its
   plain version at every shape the requests below give it (B 16 x H 128,
   B 4 x H 1024, B 4 x H 120), each also with a prefix key mask and with a
   key mask and a dropout keep mask; B4 (``local_attention_heads``) at
   B 16 x H 128 and B 4 x H 1024. Max error, and per-launch times of the
   kernel, the plain version and the composition yardstick (rotary, then
   one ``scaled_dot_product_attention`` with the band mask), beside the
   card's bound for the same work; each row carries its launch plan
   (``attention_plan``) and its time over the composition's (the masked
   rows over the same shape's unmasked composition); and at la_train's
   B 64 x N 96 without masks and with the keep mask alone.
9. local-attention serve: a run directory written from the user config
   experiments/localattn5k_r3/config.json (dim 512, depth 6, 8 heads of 64,
   window 16, 4 residual streams, v4 sampler, T 1000, x0 prediction) with
   seeded random weights, answered by ``cli.sample.main``: B 16 x H 128
   x T 1000 with holding_box, then B 4 x H 1024 and B 4 x H 120 from a
   max_seq_len 1024, T 100 copy. B3's count is set to 0 before each
   request and must be depth x model calls after it. Then a timed v4 chain,
   one LocalTransformer forward with B3 against the same forward through
   the plain version at H 128 and H 1024, B4 driven through its front door
   ``windowed_attention`` on one layer's projections (held against B3),
   and the serving profile over 50 steps.
10. physics kernels: B5 (the whole control step, 17 substeps, with and
   without the fused reward), B6 (the whole rollout, T 3) and B7 (the
   tracking reward) against their plain versions on the walk clip's frames
   staggered over N 4096 envs, each targeting the next frame. Max error,
   per-launch ms of the kernel and the plain version, and the bound from
   the operations counted on one plain substep / reward at N 1 under a
   TorchDispatchMode (each elementwise aten call one operation). Each row
   carries its launch plan (``dynamics_plan``: lanes per env, envs per
   block) and its entry kernel's registers and spill bytes from ptxas.
11. physics, run after the U-Net serve phase: ``PhysicsTrackingEnv.rollout``
   (walk clip, dt 1/30, substeps 17, contacts and limits on, fall height
   0.3) of 20 steps at N 4096 and N 65536, one B6 launch each, env-steps/s
   the best of 3, with 120 envs of each (start, middle, end) held against
   one plain T-20 rollout (its step captured once in a CUDA graph and replayed: the same
   kernels, so the same bits, without the host dispatching each again); 20 ``step`` calls at N 4096
   (20 B5 launches) held against
   one rollout from the same state, and B7 through its front door
   ``tracking_reward_fused`` on the stepped state; ``track_motions`` (horizon
   15) on the 16 motions the H 64 request wrote and on the walk clip, as
   ``cli/play.py --physics`` calls it (B5 launches = horizon x calls), then
   held against the plain B5 over 2 control steps at N 16 (walk-clip
   windows) and N 1 (the walk clip), rewards finite; a profile of 20
   ``step`` calls, and the host microseconds of one B5 wrapper call and of
   one ``step`` call with the card held busy.

12. b_serve, stack B (no kernel; f32 with TF32 off): a run directory written from the user
   config experiments/allclips12k_r5/config.json (D 69, latent 512, 8 heads, 4 adaLN layers,
   FF 2048, 9 classes, v4 T 1000, x0 prediction, CFG 3.0) with seeded random weights,
   answered by ``cli.sample.main`` at B 16 x H 168 with holding_box: with ``--class-id 0``
   (each of the 999 steps one forward at 2B 32) and without a class (999 at B 16), the
   forward calls counted; one forward at 2B 32 x H 168 with a padded key mask (one sample
   all masked) held against the same weights in float64 on the CPU (B_FWD_TOL); the profile
   of 50 CFG steps.
13. b_train: two ``cli.train.main`` runs on the same config and the nine clips (H 160), B 64,
   30 optimizer steps, dropout and label drop on, EMA, saves and logs firing: the config's x0
   loss, then v4 with the loss-aware timestep sampler; one x0-loss gradient at B 16 (injected
   t, noise and label-drop mask, dropout off) against float64 on the CPU (B_GRAD_TOL); ms per
   optimizer step over 10 steps, busy share and peak memory.
14. b_eval: ``cli.evaluate.main`` on the b_serve run's weights against the walk clip (8 samples
   x H 64, 2 replications) and ``cli.cfg_eval.main`` (scale 3, 2 samples a class, H 64; the
   unconditional branch runs in b_serve's plain request): every metric finite. Both run a copy
   of the run whose chains are cut to B_EVAL_T steps (the T 1000 chain is b_serve's; at T 1000
   the 18 host-bound cfg_eval chains alone took 78-128 s on an NVIDIA H100 80GB HBM3 at 700 W).
15. guide, run after the serve phase: ``guided_sample_loop`` with the serve phase's dim-128 U-Net
   run cut to T GUIDE_T (posterior, B 16 x H 64, holding_box) and a seeded ``ValueFunction``
   (dim 32, mults 1, 2, 4, 8, over H 64, parameters frozen): B1's count set to 0 just before
   and read just after, 33 + 20 per step, no B2; the final values sorted, the trajectories
   finite; one
   ``value_gradients`` call and one ``value_diffusion_loss`` step's gradients (B1 and B2)
   against the plain versions; B1's and B2's rows at the ValueFunction's 20 block shapes.
16. la_train: ``cli.train.main`` on the user config experiments/localattn5k_r3/config.json
   (full width, attention and feed-forward dropout 0.3, v4, B 64 x H 96 on dance_a), 30
   optimizer steps with EMA, saves and logs firing: B3's count set to 0 just before and read
   just after, 6 a micro-step, each launch with a keep mask; one B 64 step with B3 against the
   same step through B3's plain version with the same keep masks (loss and every gradient);
   ms per optimizer step and peak memory over 10 steps, the busy share over PROFILE_STEPS; one
   request answered from the trained run (B 4 x H 96, 999 forwards).
17. dec: ``cli.train.main`` on the user config experiments/decoder10k/config.json (dim 256, 4
   heads, 4 layers, angle + velocity loss, walk H 32, B 64) for 30 steps, one ``cli.sample``
   request from the run (v4 T 1000, B 16 x H 32, 999 forwards) and one forward against float64
   on the CPU (B_FWD_TOL). No kernel lies on it. (It logs every 10 steps with the loss terms:
   ``train.scan_chunk=1``; the train, la_train and b_train runs log once per scan_chunk as the
   JAX trainer does, and each run's logged steps are checked.)
18. workflows, run after the train, b_serve and physics phases on their run directories:
   ``cli.workflows.main`` runs the seven workflows (editing, start-with-motion, short- and
   long-projection, inbetween, blend, steer) on a copy of the train phase's dim-128 run cut
   to WF_T (posterior T 100, B 16), each with B1's count set to 0 just before and read just
   after (33 x the
   U-Net forwards counted, B2 0), its motions finite and its conditioned frames and dims
   exact; ``cli.compare.main`` over that run and the b_serve run (walk clip ground truth,
   H 32, CFG on class 0): both architectures, finite SiFID and inter-diversity, a best loss;
   ``cli.sweep.main`` over two learning rates (the user config on the walk clip, 10 steps
   each; B1 and B2 33 a micro-step) and its three summary files; ``softrender.render_motion``
   on a workflow motion (its forward kinematics on the card within FK_TOL of the CPU's on the
   walk clip) into ``VideoSaver``; ``cli.play.main --physics --video`` (B5 once a control
   step) where mujoco imports, else a line that says so; and the port's end-to-end walk at
   20 steps (its play step through the software renderer where mujoco does not import).
19. engines, run after the physics phase (no kernel of their own; f32 with TF32 off): the
   three reference engines ``DynamicsEnv(layout=L).step`` for L = vmap (dense), lanes
   (env-last) and aba (O(n)), one control step (17 substeps, contacts and limits on) from the
   walk clip's frames staggered over N 4096 envs, each held against B5 on the same state
   (ENGINE_QPOS_TOL), with seconds per control step (host clock after a sync, the best of 3),
   env-steps/s and peak device memory; vmap in float64 at N 16 on the card against the same
   call on the CPU (ENGINE_F64_TOL), which ties the card to the engine the CPU tests hold
   against MuJoCo; ``PhysicsTrackingEnv(layout="aba").rollout`` of ENGINE_ROLLOUT_T steps at
   N 4096 against the B6 rollout from the same state (rewards and done, their differences
   printed).

20. parallel, run after the train, physics and workflows phases (``torch.distributed``; the
   card is one device, so the multi-rank parts put two ranks on it over gloo: NCCL refuses two
   ranks on one device, and such timings are not scaling): ``cli.train.main`` with the train
   phase's arguments plus ``--coordinator file://... --num-processes 1 --process-id 0`` (NCCL,
   world size 1): B1 and B2 33 a micro-step, its parameters bit-equal to those of the same
   ``cli.train.main`` run without the flags, made just before it (an all_reduce over one rank
   is the identity; phase 20 runs cuDNN's deterministic algorithms); ms per optimizer step
   of the CLI's trainer with and without the group (PAR_STEPS-step windows in turns), their
   parameters bit-equal after the same steps (an all_reduce over one rank is the identity;
   phase 20 runs cuDNN's deterministic algorithms), one traced step (``utils.profiling.trace``:
   one ``all_reduce_grads`` range a micro-step), and the gradient all_reduce's ms per step (CUDA
   events and host clock); then two gloo ranks
   (``parallel.launch.spawn_ranks``): ``multihost_check`` at dim 128 (loss and checksum
   bit-equal across the ranks, within PAR_CHECK_TOL of one process; B1/B2 launches),
   ``rollout_sharded(state, 20)`` at N 4096 (B6 once a rank at N 2048) against ``rollout``
   from the same state (step tolerances, done flags and frames equal), the tensor-parallel
   forward of experiments/allclips12k_r5/config.json (every attention and feed-forward Linear
   split, B 16 x H 168, a padded key mask) against the one-process forward (B_FWD_TOL);
   ``prefetch_to_device`` of eight training batches onto the card, equal to direct copies;
   ``cli.scaling --widths 1,2 --steps 5`` (width 1 on NCCL, width 2 two ranks on gloo, recorded
   ``measurement_valid`` false); and the local-attention leftovers on
   experiments/localattn5k_r3/config.json with two overrides no experiment sets:
   ``model.causal=true``, LA_DECODE frames at B 4 decoded through the KV cache against the
   causal forward (LA_FORWARD_TOL), and ``model.use_global_attn=true``, one forward at B 16 x
   H 128, finite and of its shape, with its ms.

21. seq, run after phase 20 (sequence-sharded sampling; two gloo ranks share the one card, so
   no timing here is scaling): K1 (``conv_gn_stats``, B1's conv + local statistics) and K2
   (``gn_affine_mish``: two ranks' statistics merged, normalise, Mish, and each addend: none,
   the time term's (B, C) row, the residual's (B, H, C); with an addend equal to its launch
   without one plus the add, to the bit) against their plain versions at every shape of a
   rank's sharded dim-128 U-Net forward (B 4, 512 of H 1024 a rank), K1 + K2 over one rank
   against B1 itself, and K3 (``local_attention_halo``, B3's halo entry) at both ranks' slabs
   of the localattn5k_r3 model, each with ms, the plain version's ms, the composition's
   (``F.conv1d`` + ``var_mean``; K2: the unfused chain it replaces, chan_merge + the
   elementwise chain + the add, its library column; rotary + SDPA with the band mask) and
   the bound, K2 timed with the addend the forward gives it at each shape. Then two ranks (``parallel.launch.spawn_ranks``), the horizon split 512 + 512:
   one forward of the dim-128 U-Net at B 4 x H 1024 against one process with B1 (FORWARD_TOL),
   then a DDIM-10 chain (the output read as x0) with holding_box through
   ``sample_loop(..., x_sharding=seq_sharding(mesh))``, its counts set to 0 just before and read
   just after (K1 and K2 33 a forward a rank, B1 0), against the one-process chain with B1
   (SEQ_CHAIN_RTOL, SEQ_CHAIN_ATOL) and its clamped dims exact, then on each rank the
   kernels (and copies) of one sharded forward, its device ms and a DDIM step's device and
   wall ms (``scripts/seq_split_profile.py profile_rank``), and a DDIM-10 chain from
   t SEQ_EPS_T with the output read as epsilon, as the serve config reads it, held the same way;
   one forward and a v4 chain of
   SEQ_LA_STEPS steps of the localattn5k_r3 copy with max_seq_len 1024 at B 4 x H 1024 (K3
   depth a forward a rank, B3 0: nothing takes the bucketed route) against one process with
   B3; the ms a step of both chains, sharded and one-process.

22. bf16, run after phase 21 (``bf16=True`` serving; training at bf16 is phase 23): B1's
   bf16 form (``conv_gn_mish_bf16``, csrc/conv_gn_mish_bf16.cu) against its plain version at
   every shape of the dim-128 serve forward (B 16 x H 64) and B3's bf16 entry at localattn5k_r3's
   B 16 x H 128, each within one bf16 ulp of the value plus BF16_TOL, with the error in bf16
   ulps (B1: two launches to the bit, and each shape's plan: rows, cluster, split, ring depth,
   the wgmma or mma.sync instance), timed beside the float32 kernel on the same values, the
   plain version and the bf16 composition, with the bound (B1: bf16 operations at BF16_FLOPS,
   or bytes; B3: bytes). Then
   each denoiser served by ``cli.sample.main`` from a float32 run and a copy of it whose
   config.json says ``"bf16": true`` (same checkpoint, same seed), each cut to T BF16_SHORT_T,
   the counts set to 0 just before each request and read just after, the plain versions
   refused during it: the train phase's dim-128 run (posterior, B 16 x H 64: B1's bf16 kernel
   33 a forward, its float32 kernel 0) and the la_serve run (v4, B 16 x H 128: B3's bf16 entry
   6 a forward, its float32 entry 0), each with a DDIM-50 chain of both builds (T 1000) and
   one forward of each timed; the b_serve run (CFG on class 0) and the dec run, no kernel.
   The served motions' float32-vs-bf16 distance is reported for each.

23. bf16_train, run after phase 22 (``bf16=True`` training): B1's bf16 form as phase 22 times it,
   at the 33 forward shapes of a dim-128 micro-step (B 32 x H 160) and the 20 of the dim-32
   ValueFunction (B 16 x H 64); B2's bf16 form
   (``conv1d_weight_grad_bf16``, bf16 x and dy, float32 dW) against its plain version at each
   of the 33 shapes of a dim-128 micro-step (B 32 x H 160) and the 20 of a value step (B 16 x
   H 64) within WGRAD_TOL (reruns of a cluster-split plan equal to the bit), timed beside the
   plain version, cuDNN's bf16 weight gradient and the float32 kernel on the widened values,
   with the bound (operations at BF16_FLOPS, or bytes), its plan, TFLOP/s and whether it beats
   cuDNN; B3's bf16 entry with the keep mask at
   la_train's B 64 x N 96 (within one bf16 ulp plus BF16_TOL), timed beside the float32 entry
   with the same mask, the plain version and the bf16 composition. One micro-step of the bf16
   dim-128 U-Net and of the bf16 localattn5k_r3 model (same t, noise and keep masks), one
   ``value_gradients`` call and one ``value_diffusion_loss`` step of a bf16 ValueFunction (dim
   32, H 64), each with the kernels against the same step through their plain versions
   (BF16_LOSS_TOL, BF16_GRAD_TOL). Then ``cli.train.main`` on the train phase's arguments and
   on la_train's with ``model.bf16=true``, BF16_TRAIN_STEPS optimizer steps each (saves, logs
   and the EMA firing), the counts set to 0 just before and read just after: B1's and B2's
   bf16 forms 33 a micro-step, B3's bf16 entry 6 a micro-step each with a keep mask, every
   float32 form 0; parameters and EMA float32. ms per optimizer step, busy share and peak
   memory of each, beside the float32 figures of phases 7 and 16.

24. seq_bf16, run after phase 23 (phase 21's horizon split with both models built at bf16, B4 at
   bf16, the bf16 KV-cache decode): K1's bf16 form (``conv_gn_stats_bf16``, B1's bf16 kernel
   with a statistics epilogue) and K2's (``gn_affine_mish_bf16``, phase 21's K2 with a bf16
   addend and output: without the addend within one bf16 ulp plus BF16_TOL; with it equal to
   that launch plus the bf16 add, to the bit, and its plain version within one ulp of the Mish
   value and one of the sum) against their plain versions at every shape of a rank's sharded
   dim-128 forward (B 4, 512 of H 1024 a rank; K1's plan
   printed: the row split or the channel split over its cluster), bf16 K1 + K2
   over one rank against B1's bf16 form; K3's bf16 form (``local_attention_halo_bf16``) at both
   ranks' slabs of one bf16 qkv, each rank's rows against B3's bf16 entry on the whole horizon;
   B4's bf16 form through ``windowed_attention`` at B 16 x H 128 and B 4 x H 1024 (dh 64) and at
   dh 32, its launches counted. Each bf16 output within one bf16 ulp plus BF16_TOL with its
   error in ulps, timed beside its float32 form on the same values, its plain version and the
   bf16 composition, with the bound. Then phase 21's two ranks, chains and profile at bf16 (K1
   and K2's bf16 forms 33 a forward a rank, K3's 6, every float32 form and B1 / B3 0) against
   one process
   with B1's and B3's bf16 forms (SEQ_BF16_TOL), the clamped dims exact, and the float32
   chains' distance reported; then SEQ_BF16_DECODE frames of localattn5k_r3 with
   ``model.causal=true`` at bf16 decoded through the KV cache against its causal forward
   (SEQ_BF16_DECODE_TOL).

Each phase's seconds print on a line of their own. Then a line with the card's name and power limit, a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. ``--out`` also writes
every phase's results to one JSON file. Timings use CUDA events with the
50 MB L2 flushed before each timed launch; TF32 is off.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from deepmimic_diffusion_mujoco_tpu_torch import factory
from deepmimic_diffusion_mujoco_tpu_torch.cli import cfg_eval as cfg_eval_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import compare as compare_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import evaluate as evaluate_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import play as play_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import sample as cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import scaling as scaling_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import sweep as sweep_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import train as train_cli
from deepmimic_diffusion_mujoco_tpu_torch.cli import workflows as workflows_cli
from deepmimic_diffusion_mujoco_tpu_torch.data.datasets import MotionDataset, prefetch_to_device
from deepmimic_diffusion_mujoco_tpu_torch.data.mocap import load_clip
from deepmimic_diffusion_mujoco_tpu_torch.diffusion import conditioning, process
from deepmimic_diffusion_mujoco_tpu_torch.diffusion.guidance import (
    guided_sample_loop,
    guided_step,
    value_diffusion_loss,
    value_gradients,
)
from deepmimic_diffusion_mujoco_tpu_torch.diffusion.sampling import sample_loop
from deepmimic_diffusion_mujoco_tpu_torch.diffusion.schedules import make_schedule
from deepmimic_diffusion_mujoco_tpu_torch.examples import end_to_end_walk
from deepmimic_diffusion_mujoco_tpu_torch.models import temporal_unet
from deepmimic_diffusion_mujoco_tpu_torch.models.local_attention import LocalTransformer
from deepmimic_diffusion_mujoco_tpu_torch.models.temporal_unet import TemporalUnet, ValueFunction
from deepmimic_diffusion_mujoco_tpu_torch.models.transformer import TransformerMotionModel
from deepmimic_diffusion_mujoco_tpu_torch.models.transformer_decoder import (
    TransformerDecoderMotionModel,
)
from deepmimic_diffusion_mujoco_tpu_torch.ops import _build
from deepmimic_diffusion_mujoco_tpu_torch.parallel import mesh as meshlib
from deepmimic_diffusion_mujoco_tpu_torch.parallel import multihost_check, tp
from deepmimic_diffusion_mujoco_tpu_torch.parallel.launch import spawn_ranks
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_block_kernel as CB
from deepmimic_diffusion_mujoco_tpu_torch.ops import conv_weight_grad as CW
from deepmimic_diffusion_mujoco_tpu_torch.ops import fused_local_attention as FA
from deepmimic_diffusion_mujoco_tpu_torch.ops import local_attention_kernel as LH
from deepmimic_diffusion_mujoco_tpu_torch.physics import dynamics_kernel as DK
from deepmimic_diffusion_mujoco_tpu_torch.physics.dynamics import DynamicsEnv
from deepmimic_diffusion_mujoco_tpu_torch.physics.dynamics_sweep import log_of
from deepmimic_diffusion_mujoco_tpu_torch.physics.env import PhysicsTrackingEnv, tracking_reward
from deepmimic_diffusion_mujoco_tpu_torch.physics import softrender
from deepmimic_diffusion_mujoco_tpu_torch.physics.plausibility import track_motions
from deepmimic_diffusion_mujoco_tpu_torch.physics.video import VideoSaver
from deepmimic_diffusion_mujoco_tpu_torch.train.checkpoint import Checkpointer
from deepmimic_diffusion_mujoco_tpu_torch.train.config import ExperimentConfig
from deepmimic_diffusion_mujoco_tpu_torch.train.loop import make_loss_fn
from deepmimic_diffusion_mujoco_tpu_torch.utils import profiling
from deepmimic_diffusion_mujoco_tpu_torch.utils import seq as seqlib

ROOT = Path(__file__).resolve().parent


def _script(name):
    """scripts/<name>.py of this checkout, loaded by path."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


profile_rank = _script("seq_split_profile").profile_rank  # phases 21 and 24
USER_CONFIG = ROOT / "experiments" / "unet_walk10k" / "config.json"
CARTWHEEL = ROOT / "data" / "motions" / "humanoid3d_cartwheel.txt"
LA_CONFIG = ROOT / "experiments" / "localattn5k_r3" / "config.json"
LA_DATA = ROOT / "data" / "motions" / "humanoid3d_dance_a.txt"
DEC_CONFIG = ROOT / "experiments" / "decoder10k" / "config.json"
WALK = ROOT / "data" / "motions" / "humanoid3d_walk.txt"
BACKFLIP = ROOT / "data" / "motions" / "humanoid3d_backflip.txt"
B_CONFIG = ROOT / "experiments" / "allclips12k_r5" / "config.json"
MOTIONS = ROOT / "data" / "motions"
SOURCES = ("conv_gn_mish", "conv_gn_mish_bf16", "conv1d_weight_grad", "conv1d_weight_grad_bf16",
           "local_attention", "humanoid_dynamics")

B, H, D, DIM, T, K, GROUPS = 16, 64, 35, 128, 1000, 5, 8
TRAIN_B, TRAIN_H, ACCUM, TRAIN_STEPS = 32, 160, 2, 30
KERNEL_TOL = 1e-4        # B1: |kernel - plain| per element, f32 sums in another order
WGRAD_TOL = 1e-5         # B2: |kernel - plain| / max|plain|, sums over up to 10,240 rows
FORWARD_TOL = 1e-3       # |U-Net(kernel) - U-Net(plain)| after 33 blocks
GRAD_TOL = 1e-3          # per parameter: |grad(kernels) - grad(plain)| / max|grad(plain)|
LOSS_TOL = 1e-5          # |loss(kernels) - loss(plain)| / loss(plain)
BOX_ZERO, BOX_ELBOW = [13, 14, 15, 17, 18, 19], [16, 20]
LA_B, LA_H, LA_SMALL_B, LA_LONG, LA_PAD, LA_T_SHORT = 16, 128, 4, 1024, 120, 100
LA_TRAIN_B, LA_TRAIN_H, LA_TRAIN_STEPS = 64, 96, 30  # la_train: the user config on dance_a
ATTN_TOL = 1e-4          # B3, B4: |kernel - plain| per element, f32 sums in another order
LA_FORWARD_TOL = 1e-3    # |LocalTransformer(B3) - LocalTransformer(plain)| after 6 layers
COMP_TOL = 1e-3          # the composition yardstick against the plain version
WARM_S = 2.0             # seconds of f32 matrix products before the first timed kernel
RETIME_TOL = 0.2         # B1's first shape, timed again after the others: |last - first| / first
KEEP_PROB = 0.7          # 1 - attn_dropout of the user config
# B5-B7: float32 through 17 substeps of stiff contact (30,000 N/m at h = 1/510 s), where
# FMA contraction and another order of sums move the last bits
STEP_QPOS_TOL = 1e-4     # |qpos(kernel) - qpos(plain)| after one control step
STEP_QVEL_REL = 1e-2     # |qvel(kernel) - qvel(plain)| / max |qvel(plain)|
REWARD_TOL = 1e-4        # |reward(kernel) - reward(plain)|, fused or in the rollout
B7_TOL = 5e-5            # B7 against its plain version and env.tracking_reward
SAME_CODE_TOL = 5e-5     # B6 against 20 chained B5 steps: the same device code
PHYS_N, PHYS_BIG_N, PHYS_T, PHYS_KERNEL_T, SUBSTEPS, HORIZON = 4096, 65536, 20, 3, 17, 15
TRACK_CHECK_HORIZON = 2  # track_motions with B5 against the plain B5 (about 7 s a plain step)
MAIN_CHECK_ENVS = 40     # B6's main-path rollouts: 3 x 40 envs each held against plain
NO_LIBRARY = "no single PyTorch call computes the humanoid's dynamics or its tracking reward"
# Stack B (the MDM transformer, f32 with TF32 off, no kernel): serving B x H with CFG (2B
# forwards), training B 64 on the nine clips (H 160), the gradient check on B_GRAD_B rows
B_B, B_H, B_TRAIN_B, B_TRAIN_H, B_TRAIN_STEPS, B_GRAD_B = 16, 168, 64, 160, 30, 16
B_EVAL_T = 100           # b_eval's chain length (a run copy with diffusion.noise_steps cut)
B_FWD_TOL = 1e-4         # |forward or loss on the card - float64 on the CPU| / max |float64|
B_GRAD_TOL = 1e-4        # per parameter: |grad(card) - grad(float64)| / max |grad(float64)|,
B_GRAD_FLOOR = 1e-4      # the divisor at least this share of the largest gradient over all
                         # parameters (the key bias's gradient is zero in exact arithmetic)
DEC_TRAIN_B, DEC_H, DEC_STEPS = 64, 32, 30  # dec: the user config on the walk clip
GUIDE_DIM = 32           # the ValueFunction's base width (mults 1, 2, 4, 8) over H 64
GUIDE_T = 100            # the guided chain: a copy of the serve run cut to T 100 (at T 1000 it
                         # took 28-39 s of a script that phase 22 brings near its 1,200 s limit)
# workflows: --num where the horizon allows; compare at the walk clip's 39 frames cut to a
# multiple of 8 (the U-Net's), on CMP_NUM samples a run; a two-point sweep of SWEEP_STEPS
WF_NUM, CMP_NUM, CMP_FRAMES, SWEEP_STEPS, PLAY_HORIZON, WALK_STEPS = 16, 8, 32, 10, 15, 20
WF_T = 100               # the workflows' chains: a copy of the trained run cut to T 100 (at T 1000
                         # its five full chains took 37 s of a script near its 1,200 s limit)
FK_TOL = 1e-5            # body poses: forward kinematics on the card against the CPU
ENGINE_LAYOUTS = ("vmap", "lanes", "aba")
ENGINE_QPOS_TOL = 5e-4   # f32 engines against B5 after one control step: the f32
                         # cross-layout tolerance of tests/test_dynamics.py:250-343
ENGINE_F64_N, ENGINE_F64_TOL = 16, 1e-10  # vmap in f64, the card against the CPU (qpos)
ENGINE_ROLLOUT_T = 5     # PhysicsTrackingEnv(layout="aba").rollout against B6
# parallel (phase 20): ms per optimizer step in windows of PAR_STEPS, taken in turns
PAR_STEPS = 5
PAR_CHECK_TOL = 1e-5     # multihost_check, two ranks (B 8 each) against one process (B 16):
                         # B1/B2 sums over other rows, then one Adam step; relative
PAR_TIMEOUT = 300.0      # seconds for the two gloo ranks' work
LA_DECODE = 64           # frames decoded through the KV cache, against the causal forward
# seq (phase 21): the horizon split over SEQ_RANKS gloo ranks on the one card
SEQ_B, SEQ_H, SEQ_RANKS, SEQ_DDIM, SEQ_LA_STEPS = 4, 1024, 2, 10, 10
SEQ_CHAIN_RTOL, SEQ_CHAIN_ATOL = 1e-4, 1e-3  # sharded chain against one process:
                         # tests/test_parallel.py:50-53 (eps-chains reach |x| ~ 1e2)
SEQ_EPS_T = 100          # the epsilon chain's first step: alpha_bar there is about 0.97
SEQ_STATS_TOL = 1e-4     # K1's M2 against its plain version, relative (f32 sums of 8 k values)
SEQ_LA_TOL = 1e-3        # the sharded LocalTransformer (K3) against one process (B3) after
                         # 6 layers: LA_FORWARD_TOL's reason
SEQ_TIMEOUT = 300.0      # seconds for the two gloo ranks' work
# bf16 (phase 22): B1's and B3's bf16 forms and the four denoisers served at bf16
BF16_TOL = KERNEL_TOL    # a bf16 kernel against its plain version: |d| <= 2^-7 |ref| + this
                         # (one bf16 ulp of the value, plus the float32 forms' card tolerance
                         # for sums taken in another order)
BF16_FLOPS = 989e12      # dense bf16 on the tensor cores, H100 SXM (B1's bf16 bound)
BF16_SHORT_T = 100       # phase 22's requests run T 100 copies of each run (at T 1000 the
                         # U-Net's and the local transformer's four requests took 45 s; the
                         # T 1000 chains are phases 4 and 9's)
BF16_DDIM = 50           # the DDIM chain beside each T 1000 request (U-Net, local attention)
BF = torch.bfloat16
# seq_bf16 (phase 24): phase 21's horizon split at bf16, B4 at bf16, the bf16 KV-cache decode
SEQ_BF16_TOL = (5e-2, 2e-3)  # the split bf16 forwards and chains against one process (B1's
                         # and B3's bf16 forms): (max, median) of |d| / max |ref|. K1 / K2 and
                         # K3 sum in another order than B1 and B3 and the statistics merge in
                         # float64; a flipped bf16 rounding moves its GroupNorm group and
                         # spreads (on the CPU the dim-16 U-Net's 5-step split chain: 7.6e-3,
                         # 0). The bf16-vs-float32 distance of the same chains is reported
SEQ_BF16_DECODE = 32     # frames of the causal bf16 model decoded through the KV cache, at B 4
SEQ_BF16_DECODE_TOL = (2e-2, 5e-4)  # against its full causal bf16 forward, whose attention is
                         # B3 in float32 where the decode rounds rotary, scores and softmax to
                         # bf16 as JAX's decode does (the CPU at this config: 3.3e-3, 1.0e-4)
# bf16 training (phase 23)
BF16_TRAIN_STEPS = 10    # optimizer steps of each bf16 cli.train run
BF16_LOSS_TOL = 2e-3     # a bf16 step with the kernels against the same step through their
BF16_GRAD_TOL = (2.5e-2, 5e-4)  # plain versions: |loss| relative; (max, median) over every
                         # gradient element of |d| / max |plain|. The bf16 forwards agree within
                         # one bf16 ulp and 99.9 % to the bit (phase 22); a flipped rounding
                         # moves its GroupNorm group's statistics and spreads through the layers.
                         # Measured on an H100 80GB HBM3 at 700 W: loss 4.6e-4 at most (the
                         # value sum), gradients 1.0e-2 and 6.0e-5 at most
PROFILE_STEPS = 3        # optimizer steps traced by torch.profiler in the training profiles
                         # (tracing and reading back 10 steps of the dim-128 U-Net took most of
                         # phase 7's 50 s on an H100; device ms a step vary by about 1 %)
TRAIN_SET = [f"train.gradient_accumulate_every={ACCUM}", "train.log_every=10",
             "train.save_every=15", "train.ema_start=20", "train.ema_every=10"]

# Published dense peaks: float32 outside the tensor cores, HBM bandwidth, and
# TF32 on the tensor cores (B2's second bound: three TF32 products per f32 one).
PEAKS = {  # substring of the device name -> (flop/s, bytes/s, TF32 flop/s)
    "H100 PCIe": (51.2e12, 2.0e12, 378e12),
    "H100 NVL": (60.0e12, 3.9e12, 417.5e12),
    "H100": (67.0e12, 3.35e12, 495e12),  # SXM
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def bound(flops, nbytes, peaks):
    """(bound ms, what bounds it) for work of ``flops`` and ``nbytes``."""
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def log_steps(micro, accum, chunk, log_every=10):
    """The optimizer steps of training_metrics.json's records, as the JAX
    trainer writes them: with scan_chunk > 1 one record per chunk of
    micro-steps and one for a ragged tail, else one every log_every."""
    if chunk > 1:
        ends = list(range(chunk, micro + 1, chunk))
        ends += [micro] if not ends or ends[-1] != micro else []
    else:
        ends = list(range(log_every, micro + 1, log_every))
    return [e // accum for e in ends]


class Timer:
    """Per-call device time: median over calls, each bracketed by CUDA
    events, with L2 flushed before each one. The card is held busy (a
    device-side sleep) while every timed call is queued, so the events time
    the device and not the host's launch gaps."""

    def __init__(self, device):
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        # Load the flush and spin kernels now: a kernel's first launch loads
        # its module, and inside a timed window that would stall the queue.
        self.flush_buf.zero_()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def __call__(self, fn, reps=15, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda._sleep(int((1e-3 + 2 * reps * enqueue_s) * 2e9))  # cycles at ~2 GHz
        events = []
        for _ in range(reps):
            self.flush_buf.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([start.elapsed_time(end) for start, end in events]))


def build_all():
    """Every source compiled at once, one nvcc each; -> {name: ptxas lines,
    or None where the library was already built and its log is gone}."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    out = {}
    for name, so in libs.items():
        log = Path(str(so) + ".log")
        out[name] = ([ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln] if log.exists() else None)
    return out


def wgrad_bf16_sass():
    """B2's bf16 instances as built: per (taps, columns, warpgroups), the
    count of each SASS op that shows the design (HGMMA: wgmma; UTMALDG: TMA
    loads; LDSM: ldmatrix; WARPGROUP.ARRIVE / DEPBAR: the wgmma groups;
    LDL / STL: local memory, i.e. spills) from cuobjdump, and ptxas's
    registers and spill bytes; None where the toolkit has no cuobjdump."""
    so = _build.build("conv1d_weight_grad_bf16")
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, re.compile(r"kernelILi(\d)ELi(\d+)ELi(\d)E")
    for fn in sass.split("Function : ")[1:]:
        m = name.search(fn.split()[0])
        if m:
            body = fn.split("\n", 1)[1]
            out["x".join(m.groups())] = {op: body.count(op) for op in (
                "HGMMA", "UTMALDG", "LDSM", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR", "LDL", "STL")}
    log, cur = Path(str(so) + ".log"), None
    for ln in (log.read_text().splitlines() if log.exists() else []):
        m = name.search(ln)
        if m and "Compiling" in ln:
            cur = out.get("x".join(m.groups()))
        elif cur is not None and "spill stores" in ln:
            cur["spill_bytes"] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", ln))
        elif cur is not None and "Used" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def reset_counts():
    CB.conv_gn_stats_bf16_cuda.launches = 0
    CB.gn_affine_mish_bf16_cuda.launches = 0
    FA.local_attention_halo_bf16_cuda.launches = 0
    LH.local_attention_heads_bf16_cuda.launches = 0
    CB.conv_gn_mish_cuda.launches = 0
    CB.conv_gn_mish_bf16_cuda.launches = 0
    FA.fused_qkv_local_attention_bf16_cuda.launches = 0
    CB.conv_gn_stats_cuda.launches = 0
    CB.gn_affine_mish_cuda.launches = 0
    FA.local_attention_halo_cuda.launches = 0
    CW.conv1d_weight_grad_cuda.launches = 0
    CW.conv1d_weight_grad_bf16_cuda.launches = 0
    FA.fused_qkv_local_attention_cuda.launches = 0
    LH.local_attention_heads_cuda.launches = 0
    DK.control_step_cuda.launches = 0
    DK.rollout_cuda.launches = 0
    DK.tracking_reward_cuda.launches = 0


def counts():
    return CB.conv_gn_mish_cuda.launches, CW.conv1d_weight_grad_cuda.launches


def record_block_shapes(model, x, t):
    """(H, Cin, Cout) of every conv block call in one forward."""
    seen = []
    real = temporal_unet.conv_gn_mish

    def recorder(xx, w, *args):
        seen.append((xx.shape[1], w.shape[1], w.shape[2]))
        return real(xx, w, *args)

    temporal_unet.conv_gn_mish = recorder
    try:
        with torch.inference_mode():
            model(x, t)
    finally:
        temporal_unet.conv_gn_mish = real
    return seen


@contextlib.contextmanager
def swapped(module, **replacements):
    """Inside the block each ``module.<name>`` is its replacement (a kernel's
    plain version); the originals come back after it."""
    real = {name: getattr(module, name) for name in replacements}
    for name, value in replacements.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in real.items():
            setattr(module, name, value)


def plain_kernels():
    """Every conv block through the plain versions: B1's forward and B2's dW."""
    return swapped(CB, conv_gn_mish_cuda=CB.conv_gn_mish_plain,
                   conv1d_weight_grad=CW.conv1d_weight_grad_plain)


def forward_with_plain_blocks(model, x, t):
    with plain_kernels(), torch.inference_mode():
        return model(x, t)


def warm_card(dev, seconds=WARM_S):
    """Keep the card busy with f32 matrix products for ``seconds``, so that
    its clocks are up before the first timed kernel."""
    a = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(4):
            a @ a
        torch.cuda.synchronize()


def b1_plan(x, w, stats=False):
    """The launch plan B1 (or, with ``stats``, K1) takes for x's (B, H) and
    w, with the CTAs per SM the card holds (cudaOccupancyMaxActiveClusters x
    cluster size / SMs)."""
    (batch, h, cin), (_, _, cout) = x.shape, w.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    vec = (cout // GROUPS) % 4 == 0 and w.data_ptr() % 16 == 0
    plan = (CB.stats_plan if stats else CB.conv_plan)(batch, h, cin, cout, K, GROUPS)
    clusters = CB.max_active_clusters(plan, h, cin, cout, K, GROUPS, vec, x.device, stats)
    return {"cluster": plan.cluster, "rows": plan.rows, "ctas": plan.grid,
            "ctas_per_sm": clusters * plan.cluster / sms, "threads": plan.threads,
            "slices": plan.slices, "tile_h": plan.tile_h, "ck": plan.ck, "stages": plan.stages,
            "smem_bytes": plan.smem_bytes}


def b1_rows(dev, timer, counts_by_h, peaks, batch, extra=()):
    """B1 against its plain version at every shape of ``counts_by_h``
    (horizon -> Counter of (H, Cin, Cout) per forward) at ``batch``: every
    shape checked first (an untimed pass), then each timed, then the first
    timed again, which must agree within RETIME_TOL."""
    shapes = list(dict.fromkeys(s for c in counts_by_h.values() for s in c)) + list(extra)
    cases = []
    g = torch.Generator(device=dev).manual_seed(1)
    for (h, cin, cout) in shapes:
        x = torch.randn(batch, h, cin, generator=g, device=dev)
        w = torch.randn(K, cin, cout, generator=g, device=dev) * (K * cin) ** -0.5
        b = 0.1 * torch.randn(cout, generator=g, device=dev)
        gamma = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
        beta = 0.1 * torch.randn(cout, generator=g, device=dev)
        args = (x, w, b, gamma, beta, GROUPS)
        out = CB.conv_gn_mish_cuda(*args)
        ref = CB.conv_gn_mish_plain(*args)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (err <= KERNEL_TOL and torch.isfinite(out).all()):
            raise RuntimeError(f"conv_gn_mish kernel disagrees at B {batch}, H {h}, "
                               f"{cin}->{cout}: max abs err {err}")
        cases.append((args, err, ref.abs().max().item()))
    timer(lambda: CB.conv_gn_mish_cuda(*cases[0][0]))  # the timing path, once untimed
    rows = []
    for (h, cin, cout), (args, err, scale) in zip(shapes, cases):
        x, w, b, gamma, beta, _ = args
        xc, wc = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        ms = timer(lambda: CB.conv_gn_mish_cuda(*args))
        plain_ms = timer(lambda: CB.conv_gn_mish_plain(*args))
        comp_ms = timer(lambda: F.mish(F.group_norm(F.conv1d(xc, wc, b, padding=K // 2),
                                                    GROUPS, gamma, beta)))
        flops = 2.0 * batch * h * cout * K * cin
        bound_ms, bound_by = bound(flops, 4.0 * (batch * h * (cin + cout) + K * cin * cout
                                                 + 3 * cout), peaks)
        rows.append({
            "B": batch, "H": h, "cin": cin, "cout": cout,
            **{f"per_forward_h{hz}": c.get((h, cin, cout), 0) for hz, c in counts_by_h.items()},
            "plan": b1_plan(x, w),
            "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
            "ms": ms, "plain_ms": plain_ms, "composition_ms": comp_ms,
            "ms_over_composition": ms / comp_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "tflops": flops / ms / 1e9,
        })
        emit({"phase": "kernel", "name": "conv_gn_mish", **rows[-1]})
    again = timer(lambda: CB.conv_gn_mish_cuda(*cases[0][0]))
    rows[0]["ms_retimed_last"] = again
    emit({"phase": "kernel_retime", "name": "conv_gn_mish", "B": batch, "H": shapes[0][0],
          "cin": shapes[0][1], "cout": shapes[0][2], "ms_first": rows[0]["ms"], "ms_last": again})
    if abs(again - rows[0]["ms"]) > RETIME_TOL * rows[0]["ms"]:
        raise RuntimeError(f"conv_gn_mish at B {batch} x {shapes[0]} timed {rows[0]['ms']} ms "
                           f"first and {again} ms last: the timing is not steady")
    return rows


def b2_rows(dev, timer, per_step, peaks, batch):
    """B2 against its plain version at every (H, Cin, Cout) of ``per_step``
    (Counter of launches per micro-step) at ``batch``, with the shape's plan
    and path; the library yardstick is cuDNN's weight gradient,
    ``torch.nn.grad.conv1d_weight``, on channel-first copies made outside the
    timed call. Where the plan splits the rows over a cluster, a second
    launch must give the same bits. ``bound_ms`` is the float32 bound (CUDA
    cores), ``bound_3xtf32_ms`` the same work as three TF32 products on the
    tensor cores."""
    rows = []
    g = torch.Generator(device=dev).manual_seed(3)
    for (h, cin, cout), n in per_step.items():
        x = torch.randn(batch, h, cin, generator=g, device=dev)
        dy = torch.randn(batch, h, cout, generator=g, device=dev)
        plan = CW.wgrad_plan(batch, h, cin, cout, K, CW.sm_count(x.device))
        out = CW.conv1d_weight_grad_cuda(x, dy, K)
        ref = CW.conv1d_weight_grad_plain(x, dy, K)
        xc, dyc = x.transpose(1, 2).contiguous(), dy.transpose(1, 2).contiguous()

        def library():
            return torch.nn.grad.conv1d_weight(xc, (cout, cin, K), dyc, padding=K // 2)

        lib = library().permute(2, 1, 0)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        lib_err = (lib - ref).abs().max().item()
        if not (err <= WGRAD_TOL * scale and torch.isfinite(out).all()):
            raise RuntimeError(f"conv1d_weight_grad kernel disagrees at B {batch}, H {h}, "
                               f"{cin}->{cout}: max abs err {err}, max |dW| {scale}")
        if not lib_err <= WGRAD_TOL * scale:
            raise RuntimeError(f"the library yardstick computes another function: {lib_err}")
        identical = None
        if plan.cluster > 1:
            identical = torch.equal(out, CW.conv1d_weight_grad_cuda(x, dy, K))
            if not identical:
                raise RuntimeError(f"conv1d_weight_grad at B {batch}, H {h}, {cin}->{cout} "
                                   f"(cluster {plan.cluster}): two launches differ")
        ms = timer(lambda: CW.conv1d_weight_grad_cuda(x, dy, K))
        plain_ms = timer(lambda: CW.conv1d_weight_grad_plain(x, dy, K))
        lib_ms = timer(library)
        flops = 2.0 * K * cin * cout * batch * h
        nbytes = 4.0 * (batch * h * (cin + cout) + K * cin * cout)
        bound_ms, bound_by = bound(flops, nbytes, peaks)
        rows.append({
            "B": batch, "H": h, "cin": cin, "cout": cout, "per_micro_step": n,
            "plan": {"tci": plan.tci, "tco": plan.tco, "rows": plan.rows,
                     "stages": plan.stages, "cluster": plan.cluster, "slices": plan.slices,
                     "ctas": plan.grid, "threads": plan.threads},
            "path": plan.path, "splits": plan.cluster, "bit_identical": identical,
            "max_abs_err": err, "max_rel_err": err / scale, "library_rel_err": lib_err / scale,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_3xtf32_ms": bound(flops, nbytes, (peaks[2] / 3, peaks[1]))[0],
            "tflops": flops / ms / 1e9,
        })
        emit({"phase": "kernel", "name": "conv1d_weight_grad", **rows[-1]})
    if not any(r["bit_identical"] for r in rows):
        raise RuntimeError("conv1d_weight_grad: no shape's plan splits the rows over a cluster, "
                           "so no launch was checked for determinism")
    return rows


def host_per_call(dev, reps=200, rounds=3):
    """Host microseconds per conv block call at (64, 128->128), the best of
    ``rounds`` loops of ``reps`` calls, with the card held busy so that no
    call waits on it: the autograd entry the model calls, and the wrapper
    alone (argument checks, plan lookup, ctypes launch)."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(B, H, DIM, generator=g, device=dev)
    w = torch.randn(K, DIM, DIM, generator=g, device=dev) * (K * DIM) ** -0.5
    b, gamma, beta = (torch.randn(DIM, generator=g, device=dev) for _ in range(3))
    out = {}
    with torch.inference_mode():  # as in sample_loop
        for name, fn in (("entry_us", CB.conv_gn_mish), ("wrapper_us", CB.conv_gn_mish_cuda)):
            for _ in range(10):
                fn(x, w, b, gamma, beta, GROUPS)
            best = float("inf")
            for _ in range(rounds):
                torch.cuda.synchronize()
                torch.cuda._sleep(int(0.1 * 2e9))  # ~0.1 s at ~2 GHz, longer than the loop
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn(x, w, b, gamma, beta, GROUPS)
                best = min(best, (time.perf_counter() - t0) / reps * 1e6)
            out[name] = best
            torch.cuda.synchronize()
    return out


def write_run(run_dir, seed):
    cfg = ExperimentConfig.from_dict({
        "name": "chip_smoke",
        "model": {"architecture": "temporal", "input_dim": D, "channel_dim": DIM,
                  "dim_mults": [1, 2, 4, 8], "max_seq_len": H},
        "diffusion": {"noise_steps": T, "schedule_type": "cosine", "convention": "diffuser",
                      "predict_x0": False, "mode": "posterior"},
    })
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "config.json"))
    torch.manual_seed(seed)
    sd = TemporalUnet(D, dim=DIM).state_dict()
    Checkpointer(os.path.join(run_dir, "checkpoints")).save_best(0, sd, sd, loss=0.0)


def check_motions(paths, frames, num):
    if len(paths) != num:
        raise RuntimeError(f"expected {num} motions, got {len(paths)}")
    for p in paths:
        m = np.load(p)
        if m.shape != (frames, 35) or not np.isfinite(m).all():
            raise RuntimeError(f"{p}: shape {m.shape}, finite {np.isfinite(m).all()}")
        if not ((m[:, BOX_ZERO] == 0).all() and (m[:, BOX_ELBOW] == np.float32(1.57)).all()):
            raise RuntimeError(f"{p}: holding_box dims not clamped")


def refuse_plain(*args, **kwargs):
    raise RuntimeError("a plain version ran on the card's serving path")


def request(run_dir, out_dir, frames, num=B, kernel=CB.conv_gn_mish_cuda, extra=()):
    """One CLI request, every count set to 0 just before it and the plain
    versions of B1 and B3 refused during it; -> (paths, seconds, launches of
    ``kernel`` in the request)."""
    reset_counts()
    t0 = time.perf_counter()
    with swapped(CB, conv_gn_mish_plain=refuse_plain), \
            swapped(FA, fused_qkv_local_attention_plain=refuse_plain), \
            contextlib.redirect_stdout(io.StringIO()):  # the CLI prints every saved path
        paths = cli.main(["--run", run_dir, "--num", str(num), "--frames", str(frames),
                          "--conditioner", "holding_box", "--out", out_dir, "--device", "cuda",
                          *extra])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel.launches
    check_motions(paths, frames, num)
    return paths, seconds, launches


def timed_chain(model, sched, mode, seed, **kw):
    cond = conditioning.holding_box(D, device=sched.device)
    gen = torch.Generator(device=sched.device).manual_seed(seed)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sample_loop(sched, model, (B, H, D), gen, mode=mode, conditioning_fn=cond, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    x = out.trajectories
    if x.shape != (B, H, D) or not torch.isfinite(x).all():
        raise RuntimeError(f"{mode} chain: shape {tuple(x.shape)}, finite "
                           f"{bool(torch.isfinite(x).all())}")
    return seconds, CB.conv_gn_mish_cuda.launches


def device_time_by_kernel(fn, n):
    """torch.profiler over ``fn()``: (device ms summed over every kernel / n,
    the 8 largest kernels' ms / n, the 12 host operators with the most self
    CPU time / n, profiler overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    by_name = Counter()
    for e in prof.events():
        # user annotations (e.g. "Optimizer.step#AdamW.step") are ranges
        # over kernels that are counted themselves
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    top = [{"kernel": name[:80], "ms_per_step": ms / n} for name, ms in by_name.most_common(8)]
    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    host = [{"op": e.key[:60], "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3 / n,
             "calls_per_step": e.count / n} for e in ops]
    return sum(by_name.values()) / n, top, host


def profile_window(model, sched, seed, steps=50):
    """Device kernel time by name over ``steps`` posterior steps beside the
    same window's wall time without the profiler:
    -> (device ms per step, wall ms per step, top kernels, top host ops)."""
    cond = conditioning.holding_box(D, device=sched.device)

    def window():
        gen = torch.Generator(device=sched.device).manual_seed(seed)
        sample_loop(sched, model, (B, H, D), gen, conditioning_fn=cond, t_start=steps)
        torch.cuda.synchronize()

    window()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, top, host = device_time_by_kernel(window, steps)
    return device_ms, wall_ms / steps, top, host


def serve_phase(dev, timer, args, tmp, counts_by_h, peaks):
    """The serving path: two CLI requests, the kernel-vs-plain forward, the
    chains and the serving profile."""
    run = os.path.join(tmp, "serve_run")
    write_run(run, args.seed)
    per_fwd = sum(counts_by_h[H].values())
    _, s64, launches = request(run, os.path.join(tmp, "h64"), H)
    if launches != per_fwd * T:
        raise RuntimeError(f"conv_gn_mish launched {launches} times in the H {H} request, "
                           f"expected {per_fwd * T}")
    _, s48, launches48 = request(run, os.path.join(tmp, "h48"), 48)
    if launches48 != sum(counts_by_h[48].values()) * T:
        raise RuntimeError(f"conv_gn_mish launched {launches48} times in the H 48 request")
    emit({"phase": "main_path", "path": "serve", "requests": [
        {"frames": H, "num": B, "seconds": s64, "conv_gn_mish_launches": launches},
        {"frames": 48, "num": B, "seconds": s48, "conv_gn_mish_launches": launches48}]})

    _, model, sched, payload, _ = cli.load_run(run, device=dev)
    model.load_state_dict(payload["params"])
    model.eval()
    gx = torch.Generator(device=dev).manual_seed(args.seed + 1)
    t = torch.randint(0, T, (B,), generator=gx, device=dev)
    fwd_errs = {}
    for h in (H, 48):
        xx = torch.randn(B, h, D, generator=gx, device=dev)
        with torch.inference_mode():
            out_k = model(xx, t)
        err = (out_k - forward_with_plain_blocks(model, xx, t)).abs().max().item()
        if not (err <= FORWARD_TOL and torch.isfinite(out_k).all()):
            raise RuntimeError(f"U-Net forward at H {h} with the kernel differs from plain "
                               f"by {err}")
        fwd_errs[f"h{h}"] = err
    x64 = torch.randn(B, H, D, generator=gx, device=dev)
    with torch.inference_mode():
        fwd_ms = timer(lambda: model(x64, t), reps=10)
    fwd_plain_ms = timer(lambda: forward_with_plain_blocks(model, x64, t), reps=10)

    s_post, l_post = timed_chain(model, sched, "posterior", args.seed)
    s_ddim, l_ddim = timed_chain(model, sched, "ddim", args.seed, ddim_steps=50)
    if l_post != per_fwd * T or l_ddim != per_fwd * 50:
        raise RuntimeError(f"chain launches {l_post}, {l_ddim}")
    chains = {
        "forward_max_abs_err_kernel_vs_plain": fwd_errs,
        "forward_ms": fwd_ms, "forward_plain_blocks_ms": fwd_plain_ms,
        "posterior_T1000": {"seconds": s_post, "samples_per_s": B / s_post,
                            "conv_gn_mish_launches": l_post},
        "ddim50": {"seconds": s_ddim, "samples_per_s": B / s_ddim,
                   "conv_gn_mish_launches": l_ddim},
    }
    emit({"phase": "chains", **chains})

    device_ms, wall_ms, top, host_ops = profile_window(model, sched, args.seed)
    host = host_per_call(dev)
    profile = {"device_ms_per_step": device_ms, "wall_ms_per_step": wall_ms,
               # null when the trace holds no device events: not measured
               "device_busy_share": device_ms / wall_ms if device_ms else None,
               "top_kernels": top, "top_host_ops": host_ops, "conv_block_host": host,
               "conv_block_host_share_of_step": per_fwd * host["entry_us"] / 1e3 / wall_ms}
    emit({"phase": "profile", "path": "serve", **profile})
    return {"requests": {"h64_seconds": s64, "h48_seconds": s48}, **chains,
            "profile": profile, "launches": launches}


def train_args(run_dir, seed):
    return ["--config", str(USER_CONFIG), "--data", str(CARTWHEEL),
            "--batch-size", str(TRAIN_B), "--steps", str(TRAIN_STEPS), "--out", run_dir,
            "--device", "cuda", "--set", *TRAIN_SET, f"train.seed={seed}"]


def train_phase(args, tmp, per_step):
    """The slice's main path: ``cli.train.main`` on a user config, then a
    sampling request answered from the trained run."""
    run = os.path.join(tmp, "train_run")
    micro = TRAIN_STEPS * ACCUM
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        trainer = train_cli.main(train_args(run, args.seed))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    b1, b2 = counts()
    if (b1, b2) != (per_step * micro, per_step * micro):
        raise RuntimeError(f"training launched conv_gn_mish {b1} and conv1d_weight_grad {b2} "
                           f"times, expected {per_step} x {micro} micro-steps each")
    ckpts = Path(run) / "checkpoints"
    saved = sorted(p.name for p in ckpts.glob("*.pt"))
    for name in ("best_model.pt", "best_model.json", "state_30.pt", f"state_{micro}.pt"):
        if not (ckpts / name).exists():
            raise RuntimeError(f"training wrote no {name}: {saved}")
    metrics = json.loads((Path(run) / "training_metrics.json").read_text())
    losses = [r["loss"] for r in metrics["metrics"]]
    cfg = ExperimentConfig.load(os.path.join(run, "config.json"))
    # the user config's scan_chunk 50: records at micro-steps 50 and 60
    logged = log_steps(micro, ACCUM, cfg.train.scan_chunk)
    if ([r["step"] for r in metrics["metrics"]] != logged or not np.isfinite(losses).all()
            or not np.isfinite(metrics["best_loss"]) or metrics["best_step"] < 25):
        raise RuntimeError(f"training metrics: {metrics}, expected records at steps {logged}")
    ema_moved = any((trainer.state.ema_params[k] != v).any().item()
                    for k, v in trainer.state.model.state_dict().items())
    result = {"seconds": seconds, "micro_steps": micro, "optimizer_steps": TRAIN_STEPS,
              "micro_batch": cfg.train.batch_size, "accum": cfg.train.gradient_accumulate_every,
              "horizon": trainer.dataset.horizon, "variants": len(trainer.dataset),
              "conv_gn_mish_launches": b1, "conv1d_weight_grad_launches": b2,
              "losses": losses, "best_loss": metrics["best_loss"],
              "best_step": metrics["best_step"], "checkpoints": saved,
              "ema_differs_from_params": ema_moved, "log_lines": len(log.getvalue().splitlines())}
    if trainer.dataset.horizon != TRAIN_H or len(trainer.dataset) != TRAIN_H:
        raise RuntimeError(f"cartwheel gave H {trainer.dataset.horizon}, {len(trainer.dataset)}")

    _, s_req, l_req = request(run, os.path.join(tmp, "trained"), TRAIN_H, num=4)
    if l_req != per_step * T:
        raise RuntimeError(f"sampling the trained run launched conv_gn_mish {l_req} times")
    result["sample_request"] = {"frames": TRAIN_H, "num": 4, "seconds": s_req,
                                "conv_gn_mish_launches": l_req}
    emit({"phase": "main_path", "path": "train", **result})
    return result


def grads_phase(dev, seed):
    """One B 64 step at H 160 (loss and every parameter's gradient) with both
    kernels against the same step with both plain versions."""
    ds = MotionDataset.from_path(str(CARTWHEEL), include_velocity=False, augment="cyclic",
                                 horizon_multiple=8)
    x0 = torch.from_numpy(next(ds.epochs(TRAIN_B * ACCUM, seed=seed)).trajectories).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randint(0, T, (x0.shape[0],), generator=gen, device=dev)
    noise = torch.randn(x0.shape, generator=gen, device=dev)
    torch.manual_seed(seed)
    model = TemporalUnet(D, dim=DIM).to(dev).train()
    loss_fn = make_loss_fn(make_schedule("cosine", T, convention="diffuser", device=dev), model,
                           weights=process.diffuser_loss_weights(ds.horizon, D, device=dev))

    def step():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(x0, t, noise)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    reset_counts()
    loss_k, grads_k = step()
    launched = counts()
    with plain_kernels():
        loss_p, grads_p = step()
    if launched != (33, 33) or counts() != launched:
        raise RuntimeError(f"grads step launched {launched}, then {counts()}")
    rel = {k: ((grads_k[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
           for k, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / loss_p
    if not (loss_rel <= LOSS_TOL and rel[worst] <= GRAD_TOL
            and all(torch.isfinite(g).all() for g in grads_k.values())):
        raise RuntimeError(f"kernel step vs plain step: loss rel err {loss_rel}, "
                           f"{worst} grad rel err {rel[worst]}")
    result = {"batch": x0.shape[0], "H": x0.shape[1], "loss_kernels": loss_k,
              "loss_plain": loss_p, "loss_rel_err": loss_rel, "params": len(rel),
              "max_grad_rel_err": rel[worst], "worst_param": worst,
              "median_grad_rel_err": float(np.median(list(rel.values())))}
    emit({"phase": "grads", **result})
    return result


def step_profile(cfg, dev, steps=10, traced=PROFILE_STEPS):
    """Optimizer steps of the CLI's trainer on ``cfg`` without checkpoints:
    host-clock ms per step (``steps`` after as many to warm), device kernel
    time by name under torch.profiler (``traced`` more) and the busy share
    (device over host ms a step), peak memory. The best-model window is kept
    shut so that no step waits for its loss."""
    trainer = train_cli.build_trainer(cfg, device=dev)
    trainer.config = dataclasses.replace(trainer.config, log_every=10 ** 9,
                                         best_window_frac=-1e6)

    def window(n=steps):
        trainer.train(num_steps=n)
        torch.cuda.synchronize()

    window()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
    device_ms, top, host = device_time_by_kernel(lambda: window(traced), traced)
    del trainer
    return {"ms_per_optimizer_step": wall_ms, "optimizer_steps_per_s": 1e3 / wall_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "top_kernels": top, "top_host_ops": host, "peak_memory_bytes": peak}


def train_profile_phase(dev, seed, steps=10):
    """``step_profile`` of the train phase's configuration."""
    cfg = ExperimentConfig.load(str(USER_CONFIG)).override({
        "data.path": str(CARTWHEEL), "train.batch_size": TRAIN_B,
        "train.gradient_accumulate_every": ACCUM, "train.seed": seed})
    result = step_profile(cfg, dev, steps)
    emit({"phase": "profile", "path": "train", **result})
    return result


# ---------------------------------------------------------------------------
# The local-attention transformer (B3, B4)


def rotary_tables(pos, dh, dev):
    """cos and sin (len(pos), dh) of the absolute-position rotary."""
    ang = torch.from_numpy(pos.astype(np.float32)[:, None] * FA.rotary_freqs(dh)[None, :]).to(dev)
    return torch.cos(ang), torch.sin(ang)


def rotate(x, table):
    cos, sin = table
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def band_mask(n, w, causal, dev):
    """(n, n) bool, True where query i may attend key j (SDPA's convention)."""
    i = np.arange(n)
    bad = FA.window_mask(i[:, None], i[None, :], w, 1, 0 if causal else 1, causal, True, False)
    return torch.from_numpy(~bad).to(dev)


def attention_work(n, n_keys, w, causal, lengths):
    """(attended (query, key) pairs of one head summed over the batch, query
    rows with every key masked) for the real query rows [0, n), keys [0,
    n_keys) and per-sequence key lengths."""
    i, j = np.arange(n)[:, None], np.arange(n_keys)[None, :]
    ok = ~FA.window_mask(i, j, w, 1, 0 if causal else 1, causal, True, False)
    pairs = empty = 0
    for ln in lengths:
        per_row = (ok & (j < ln)).sum(axis=1)
        pairs += int(per_row.sum())
        empty += int((per_row == 0).sum())
    return pairs, empty


def b3_composition(qkv, h, dh, w, tables, mask):
    """The same function from library calls: the plain rotary on the padded
    q and k, then one scaled_dot_product_attention with the band mask."""
    B, N, _ = qkv.shape
    Np = mask.shape[0]
    x = F.pad(qkv, (0, 0, 0, Np - N)).view(B, Np, 3, h, dh).permute(2, 0, 3, 1, 4)
    out = F.scaled_dot_product_attention(rotate(x[0], tables[0]), rotate(x[1], tables[1]), x[2],
                                         attn_mask=mask)
    return out.transpose(1, 2).reshape(B, Np, h * dh)[:, :N]


def attention_plan_row(Np, C, P, w, causal, dh, batch_heads, elem=4, keep=False):
    """B3's / B4's launch plan for a shape (``elem`` 2: the bf16 form's;
    ``keep``: with a dropout keep mask), as a JSON-ready dict."""
    return dataclasses.asdict(FA.attention_plan(Np, C, P, w, causal, dh, batch_heads,
                                                elem=elem, keep=keep))


SERVE_MASKS = ("none", "lengths", "lengths+keep")
TRAIN_MASKS = ("none", "keep")


def b3_rows(dev, timer, peaks, mcfg):
    """B3 against its plain version at the requests' shapes, each without
    masks, with prefix key lengths (down to 3, so some rows have every key
    masked), and with those and a dropout keep mask; and at la_train's
    shape (B 64 x N 96) without masks and with the keep mask alone, as a
    training micro-step launches it."""
    h, dh, w, causal = mcfg.n_heads, mcfg.dim_head, mcfg.window_size, mcfg.causal
    lf = 0 if causal else 1
    rows = []
    g = torch.Generator(device=dev).manual_seed(5)
    for batch, n, cases in ((LA_B, LA_H, SERVE_MASKS), (LA_SMALL_B, LA_LONG, SERVE_MASKS),
                            (LA_SMALL_B, LA_PAD, SERVE_MASKS),
                            (LA_TRAIN_B, LA_TRAIN_H, TRAIN_MASKS)):
        p = FA.plan(n, w, causal)
        Np, K = p["Np"], p["K"]
        qkv = torch.randn(batch, n, 3 * h * dh, generator=g, device=dev)
        lengths = np.linspace(n, 3, batch).round().astype(int).tolist()
        km = (torch.arange(n, device=dev)[None, :]
              < torch.tensor(lengths, device=dev)[:, None]).to(torch.float32)
        keep = FA.dropout_keep_mask(g, KEEP_PROB, batch, n, h, w, causal)
        tables = (rotary_tables(np.arange(Np) + lf * w, dh, dev), rotary_tables(np.arange(Np), dh, dev))
        mask = band_mask(Np, w, causal, dev)
        for masks, kmask, kp_mask in (("none", None, None), ("lengths", km, None),
                                      ("lengths+keep", km, keep), ("keep", None, keep)):
            if masks not in cases:
                continue
            kp = KEEP_PROB if kp_mask is not None else 1.0
            args = (qkv, h, dh, w, causal, True, True, kmask, kp_mask, kp)
            out = FA.fused_qkv_local_attention_cuda(*args)
            ref = FA.fused_qkv_local_attention_plain(*args)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            if not (err <= ATTN_TOL and torch.isfinite(out).all()):
                raise RuntimeError(f"fused_qkv_local_attention kernel disagrees at B {batch}, "
                                   f"N {n}, {masks}: max abs err {err}")
            row = {"B": batch, "N": n, "Np": Np, "K": K, "masks": masks,
                   "lengths": lengths if kmask is not None else None, "max_abs_err": err,
                   "plan": attention_plan_row(Np, p["C"], p["P"], w, causal, dh, batch * h),
                   "ms": timer(lambda: FA.fused_qkv_local_attention_cuda(*args)),
                   "plain_ms": timer(lambda: FA.fused_qkv_local_attention_plain(*args))}
            if masks == "none":
                comp_err = (b3_composition(qkv, h, dh, w, tables, mask) - ref).abs().max().item()
                if not comp_err <= COMP_TOL:
                    raise RuntimeError(f"the composition yardstick computes another function: "
                                       f"{comp_err}")
                comp_ms = timer(lambda: b3_composition(qkv, h, dh, w, tables, mask))
                row["composition_ms"] = comp_ms
                row["composition_max_abs_err"] = comp_err
            # the masked rows over the same shape's (unmasked) composition
            row["composition_ratio"] = row["ms"] / comp_ms
            pairs, empty = attention_work(n, Np, w, causal,
                                          lengths if kmask is not None else [Np] * batch)
            flops = h * (4.0 * dh * pairs + 2.0 * dh * K * empty) + 6.0 * batch * n * h * dh
            nbytes = 4.0 * (4 * batch * n * h * dh + (batch * Np * h * K if kp_mask is not None
                                                      else 0) + (batch if kmask is not None else 0))
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes, peaks)
            row.update(pairs_per_head=pairs, rows_all_masked=empty, gflop=flops / 1e9,
                       mbytes=nbytes / 1e6)
            rows.append(row)
            emit({"phase": "kernel", "name": "fused_qkv_local_attention", **row})
    return rows


def b4_rows(dev, timer, peaks, mcfg):
    """B4 against its plain version at (B·h, N, dh) of the two aligned
    requests, with the composition yardstick."""
    h, dh, w, causal = mcfg.n_heads, mcfg.dim_head, mcfg.window_size, mcfg.causal
    lf = 0 if causal else 1
    rows = []
    g = torch.Generator(device=dev).manual_seed(6)
    for batch, n in ((LA_B, LA_H), (LA_SMALL_B, LA_LONG)):
        q, k, v = (torch.randn(batch, h, n, dh, generator=g, device=dev) for _ in range(3))
        out = LH.local_attention_heads_cuda(q, k, v, w, causal)
        ref = LH.local_attention_heads_plain(q, k, v, w, causal)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not (err <= ATTN_TOL and torch.isfinite(out).all()):
            raise RuntimeError(f"local_attention_heads kernel disagrees at B {batch}, N {n}: "
                               f"max abs err {err}")
        qt, kt = rotary_tables(np.arange(n) + lf * w, dh, dev), rotary_tables(np.arange(n), dh, dev)
        mask = band_mask(n, w, causal, dev)

        def composition():
            return F.scaled_dot_product_attention(rotate(q, qt), rotate(k, kt), v, attn_mask=mask)

        comp_err = (composition() - ref).abs().max().item()
        if not comp_err <= COMP_TOL:
            raise RuntimeError(f"the composition yardstick computes another function: {comp_err}")
        pairs, _ = attention_work(n, n, w, causal, [n] * batch)
        flops = h * 4.0 * dh * pairs + 6.0 * batch * h * n * dh
        bound_ms, bound_by = bound(flops, 16.0 * batch * h * n * dh, peaks)
        rows.append({"B": batch, "heads": h, "N": n, "dh": dh, "max_abs_err": err,
                     "plan": attention_plan_row(n, LH.CHUNK, LH.CHUNK, w, causal, dh, batch * h),
                     "ms": timer(lambda: LH.local_attention_heads_cuda(q, k, v, w, causal)),
                     "plain_ms": timer(lambda: LH.local_attention_heads_plain(q, k, v, w, causal)),
                     "composition_ms": timer(composition), "composition_max_abs_err": comp_err,
                     "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9})
        rows[-1]["composition_ratio"] = rows[-1]["ms"] / rows[-1]["composition_ms"]
        emit({"phase": "kernel", "name": "local_attention_heads", **rows[-1]})
    return rows


def seeded_model(cfg, seed, live):
    """The config's model on the CPU from a seeded init, with the parameters
    ``live(name)`` picks (zero or near zero at init) drawn N(0, 0.02^2) so that
    their paths carry values."""
    torch.manual_seed(seed)
    model = factory.build_model(cfg.model, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if live(name):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model


def write_model_run(run_dir, cfg, seed, live):
    """config.json and a best-model checkpoint of ``seeded_model``."""
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "config.json"))
    sd = seeded_model(cfg, seed, live).state_dict()
    Checkpointer(os.path.join(run_dir, "checkpoints")).save_best(0, sd, sd, loss=0.0)


def hyper_connection_weights(name):
    return name.endswith(("dynamic_alpha_fn", "dynamic_beta_fn"))


def adaln_modulations(name):
    return "adaln_mod" in name or "final_mod" in name


@contextlib.contextmanager
def counted_forwards(cls=LocalTransformer):
    """Record the batch size of every ``cls.forward`` call: -> a list, one
    entry per call."""
    calls, real = [], cls.forward

    def forward(self, x, *a, **k):
        calls.append(x.shape[0])
        return real(self, x, *a, **k)

    cls.forward = forward
    try:
        yield calls
    finally:
        cls.forward = real


def load_model(run_dir, dev):
    _, model, sched, payload, _ = cli.load_run(run_dir, device=dev)
    model.load_state_dict(payload["params"])
    return model.eval(), sched


def heads_path(models, mcfg, dev):
    """B4's own path: one layer's q, k, v at each request's shape through
    the front door ``windowed_attention`` (the per-head kernel where N is a
    multiple of 128, the bucketed local_attention at H 120), held against
    B3 on the same projections. -> (B4 launches, max abs err per H)."""
    h, dh, w, causal = mcfg.n_heads, mcfg.dim_head, mcfg.window_size, mcfg.causal
    g = torch.Generator(device=dev).manual_seed(7)
    cases = []
    with torch.inference_mode():
        for model, batch, n in models:
            mha = model.attn[0]
            x = torch.randn(batch, n, mcfg.latent_dim, generator=g, device=dev)
            qkv = mha.to_qkv(mha.norm(x))
            cases.append((n, qkv, FA.fused_qkv_local_attention(qkv, h, dh, w, causal)))
        torch.cuda.synchronize()
        reset_counts()
        outs = []
        for n, qkv, _ in cases:
            q, k, v = qkv.view(qkv.shape[0], n, 3, h, dh).permute(2, 0, 3, 1, 4)
            outs.append(LH.windowed_attention(q, k, v, w, causal=causal))
        torch.cuda.synchronize()
        launches = LH.local_attention_heads_cuda.launches
    errs = {}
    for (n, qkv, ctx), out in zip(cases, outs):
        err = (out.transpose(1, 2).reshape(ctx.shape) - ctx).abs().max().item()
        if not err <= ATTN_TOL:
            raise RuntimeError(f"windowed_attention at H {n} differs from B3 by {err}")
        errs[f"h{n}"] = err
    return launches, errs


def la_serve_phase(dev, timer, args, tmp, cfg):
    """The local-attention serving path: three CLI requests, the timed
    chain, the kernel-vs-plain forwards, B4's front door and the profile."""
    mcfg = cfg.model
    D_la, depth = mcfg.input_dim, mcfg.depth
    if cfg.diffusion.mode != "v4":
        raise RuntimeError(f"{LA_CONFIG} samples with {cfg.diffusion.mode!r}, expected v4")
    run, run_long = os.path.join(tmp, "la_run"), os.path.join(tmp, "la_run_long")
    long_cfg = cfg.override({"model.max_seq_len": LA_LONG, "diffusion.noise_steps": LA_T_SHORT})
    write_model_run(run, cfg, args.seed, hyper_connection_weights)
    write_model_run(run_long, long_cfg, args.seed, hyper_connection_weights)
    requests = []
    for run_dir, c, num, frames in ((run, cfg, LA_B, LA_H), (run_long, long_cfg, LA_SMALL_B, LA_LONG),
                                    (run_long, long_cfg, LA_SMALL_B, LA_PAD)):
        with counted_forwards() as calls:
            _, seconds, launches = request(run_dir, os.path.join(tmp, f"la_h{frames}"), frames, num,
                                           kernel=FA.fused_qkv_local_attention_cuda)
        # v4 runs the model at t = T-1 .. 1
        steps = c.diffusion.noise_steps - 1
        if len(calls) != steps or launches != depth * steps:
            raise RuntimeError(f"the H {frames} request ran {len(calls)} forwards and launched "
                               f"fused_qkv_local_attention {launches} times, expected {steps} and "
                               f"{depth} x {steps}")
        requests.append({"frames": frames, "num": num, "T": c.diffusion.noise_steps,
                         "forwards": len(calls), "seconds": seconds,
                         "fused_qkv_local_attention_launches": launches})
    emit({"phase": "main_path", "path": "la_serve", "requests": requests})

    model, sched = load_model(run, dev)
    model_long, _ = load_model(run_long, dev)
    cond = conditioning.holding_box(D_la, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sample_loop(sched, model, (LA_B, LA_H, D_la), torch.Generator(device=dev).manual_seed(
        args.seed), mode="v4", predict_epsilon=False, conditioning_fn=cond)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    if out.trajectories.shape != (LA_B, LA_H, D_la) or not torch.isfinite(out.trajectories).all():
        raise RuntimeError("v4 chain output")
    chain = {"seconds": chain_s, "samples_per_s": LA_B / chain_s,
             "fused_qkv_local_attention_launches": FA.fused_qkv_local_attention_cuda.launches}

    gx = torch.Generator(device=dev).manual_seed(args.seed + 2)
    forwards = {}
    for m, batch, n in ((model, LA_B, LA_H), (model_long, LA_SMALL_B, LA_LONG)):
        x = torch.randn(batch, n, D_la, generator=gx, device=dev)
        t = torch.randint(0, sched.num_timesteps, (batch,), generator=gx, device=dev)

        def fwd(m=m, x=x, t=t):
            with torch.inference_mode():
                return m(x, t)

        out_k = fwd()
        with swapped(FA, fused_qkv_local_attention_cuda=FA.fused_qkv_local_attention_plain):
            out_p = fwd()
            plain_ms = timer(fwd, reps=10)
        err = (out_k - out_p).abs().max().item()
        if not (err <= LA_FORWARD_TOL and torch.isfinite(out_k).all()):
            raise RuntimeError(f"LocalTransformer forward at H {n} with B3 differs from plain "
                               f"by {err}")
        forwards[f"h{n}"] = {"B": batch, "max_abs_err_kernel_vs_plain": err,
                             "ms": timer(fwd, reps=10), "plain_attention_ms": plain_ms}
    b4_launches, b4_errs = heads_path([(model, LA_B, LA_H), (model_long, LA_SMALL_B, LA_LONG),
                                       (model_long, LA_SMALL_B, LA_PAD)], mcfg, dev)
    if b4_launches != 2:
        raise RuntimeError(f"windowed_attention launched local_attention_heads {b4_launches} "
                           "times, expected 2 (H 128 and H 1024; H 120 is bucketed)")
    emit({"phase": "chains", "path": "la_serve", "v4_T1000": chain, "forward": forwards,
          "heads_path": {"local_attention_heads_launches": b4_launches,
                         "max_abs_err_vs_b3": b4_errs}})

    steps = 50

    def window():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        sample_loop(sched, model, (LA_B, LA_H, D_la), gen, mode="v4", predict_epsilon=False,
                    conditioning_fn=cond, t_start=steps + 1)
        torch.cuda.synchronize()

    window()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    device_ms, top, host_ops = device_time_by_kernel(window, steps)
    profile = {"device_ms_per_step": device_ms, "wall_ms_per_step": wall_ms,
               "device_busy_share": device_ms / wall_ms if device_ms else None,
               "top_kernels": top, "top_host_ops": host_ops}
    emit({"phase": "profile", "path": "la_serve", **profile})
    return {"requests": requests, "v4_T1000": chain, "forward": forwards,
            "heads_path": {"launches": b4_launches, "max_abs_err_vs_b3": b4_errs},
            "profile": profile}


@contextlib.contextmanager
def keep_mask_launches(entry="fused_qkv_local_attention_cuda"):
    """Record, for every launch of B3's ``entry`` (the float32 one, or
    ``fused_qkv_local_attention_bf16_cuda``) inside the block, whether it
    carried a dropout keep mask: -> a list of bools. The wrapper still counts
    its own launches: it adds to the count of the name it is reached by, the
    recorder's inside the block, which is added to its own after."""
    seen, real = [], getattr(FA, entry)

    def recorder(qkv, *args, **kw):
        keep = args[7] if len(args) > 7 else kw.get("dropout_keep")
        seen.append(keep is not None)
        return real(qkv, *args, **kw)

    recorder.__name__ = real.__name__
    recorder.launches = 0
    try:
        with swapped(FA, **{entry: recorder}):
            yield seen
    finally:
        real.launches += recorder.launches


def la_batch(cfg, seed, dev):
    """The first training batch of the config's dataset (dance_a, H 96) and
    a (t, noise) draw, on the card."""
    ds = MotionDataset.from_path(str(LA_DATA), include_velocity=cfg.data.include_velocity,
                                 augment=cfg.data.augment, replicas=cfg.data.replicas,
                                 horizon_multiple=cfg.data.horizon_multiple
                                 ).truncated(cfg.model.max_seq_len)
    x0 = torch.from_numpy(next(ds.epochs(LA_TRAIN_B, seed=seed)).trajectories).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randint(0, cfg.diffusion.noise_steps, (LA_TRAIN_B,), generator=g, device=dev)
    return x0, t, torch.randn(x0.shape, generator=g, device=dev)


def la_grad_check(dev, cfg, seed):
    """One full B 64 v4 step of the config's model (dropout live) with B3
    against the same step through B3's plain version, both with the same
    keep masks (the generator reseeded before each): the loss and every
    parameter's gradient relative to its largest element."""
    x0, t, noise = la_batch(cfg, seed, dev)
    torch.manual_seed(seed)
    model = factory.build_model(cfg.model, dev).train()
    loss_fn = make_loss_fn(factory.build_schedule(cfg.diffusion, dev), model, kind="v4",
                           predict_epsilon=False, use_mask=True,
                           dropout=train_cli.has_dropout(cfg.model))

    def step():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(x0, t, noise, generator=torch.Generator(device=dev).manual_seed(seed))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    reset_counts()
    with keep_mask_launches() as kept:
        loss_k, grads_k = step()
    launched = FA.fused_qkv_local_attention_cuda.launches
    with swapped(FA, fused_qkv_local_attention_cuda=FA.fused_qkv_local_attention_plain):
        loss_p, grads_p = step()
    if launched != cfg.model.depth or not all(kept) or len(kept) != launched:
        raise RuntimeError(f"the la_train grads step launched B3 {launched} times, keep masks "
                           f"{kept}")
    rel = {k: ((grads_k[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
           for k, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / loss_p
    if not (loss_rel <= LOSS_TOL and rel[worst] <= GRAD_TOL
            and all(torch.isfinite(g).all() for g in grads_k.values())):
        raise RuntimeError(f"la_train step with B3 vs plain: loss rel err {loss_rel}, "
                           f"{worst} grad rel err {rel[worst]}")
    return {"batch": LA_TRAIN_B, "H": x0.shape[1], "loss_b3": loss_k, "loss_plain": loss_p,
            "loss_rel_err": loss_rel, "params": len(rel), "max_grad_rel_err": rel[worst],
            "worst_param": worst, "median_grad_rel_err": float(np.median(list(rel.values()))),
            "b3_launches": launched, "tolerance": GRAD_TOL}


def la_train_phase(dev, args, tmp, cfg, steps=10):
    """The local-attention training path: ``cli.train.main`` on the user
    config (dropout 0.3 live), B3's launches each with a keep mask; the
    gradient check against plain attention with the same masks; ms per
    optimizer step, busy share and peak memory; one request answered from
    the trained run."""
    run = os.path.join(tmp, "la_train")
    depth = cfg.model.depth
    t0 = time.perf_counter()
    reset_counts()
    with keep_mask_launches() as kept, contextlib.redirect_stdout(io.StringIO()):
        trainer = train_cli.main([
            "--config", str(LA_CONFIG), "--data", str(LA_DATA), "--steps", str(LA_TRAIN_STEPS),
            "--out", run, "--device", "cuda", "--set", "train.log_every=10",
            "train.save_every=15", "train.ema_start=20", "train.ema_every=10",
            f"train.seed={args.seed}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = FA.fused_qkv_local_attention_cuda.launches
    micro = LA_TRAIN_STEPS * trainer.config.gradient_accumulate_every
    if launches != depth * micro or len(kept) != launches or not all(kept):
        raise RuntimeError(f"la_train launched B3 {launches} times ({sum(kept)} with a keep "
                           f"mask), expected {depth} x {micro} micro-steps, all with one")
    if (trainer.dataset.horizon, trainer.config.batch_size) != (LA_TRAIN_H, LA_TRAIN_B):
        raise RuntimeError(f"la_train ran H {trainer.dataset.horizon}, "
                           f"B {trainer.config.batch_size}")
    ckpts = Path(run) / "checkpoints"
    saved = sorted(p.name for p in ckpts.glob("*.pt"))
    for name in ("best_model.pt", "state_15.pt", f"state_{LA_TRAIN_STEPS}.pt"):
        if not (ckpts / name).exists():
            raise RuntimeError(f"la_train wrote no {name}: {saved}")
    metrics = json.loads((Path(run) / "training_metrics.json").read_text())
    losses = [r["loss"] for r in metrics["metrics"]]
    ema_moved = any((trainer.state.ema_params[k] != v).any().item()
                    for k, v in trainer.state.model.state_dict().items())
    logged = log_steps(micro, trainer.config.gradient_accumulate_every, cfg.train.scan_chunk)
    if ([r["step"] for r in metrics["metrics"]] != logged or not np.isfinite(losses).all()
            or not np.isfinite(metrics["best_loss"]) or not ema_moved):
        raise RuntimeError(f"la_train metrics {metrics}, expected records at steps {logged}, "
                           f"EMA moved {ema_moved}")
    result = {"seconds": seconds, "optimizer_steps": LA_TRAIN_STEPS, "batch": LA_TRAIN_B,
              "horizon": trainer.dataset.horizon, "fused_qkv_local_attention_launches": launches,
              "launches_with_keep_mask": sum(kept), "launches_per_micro_step": launches / micro,
              "losses": losses, "best_loss": metrics["best_loss"],
              "best_step": metrics["best_step"], "checkpoints": saved,
              "ema_differs_from_params": ema_moved}
    del trainer

    result["grads"] = la_grad_check(dev, cfg, args.seed)

    p = FA.plan(LA_TRAIN_H, cfg.model.window_size, cfg.model.causal)
    result["profile"] = {
        **step_profile(cfg.override({"data.path": str(LA_DATA), "train.seed": args.seed}), dev,
                       steps),
        "keep_mask_bytes_per_layer": 4 * LA_TRAIN_B * p["Np"] * cfg.model.n_heads * p["K"]}

    with counted_forwards() as calls:
        _, s_req, l_req = request(run, os.path.join(tmp, "la_trained"), LA_TRAIN_H, num=4,
                                  kernel=FA.fused_qkv_local_attention_cuda)
    steps_T = cfg.diffusion.noise_steps - 1  # v4: t = T-1 .. 1
    if len(calls) != steps_T or l_req != depth * steps_T:
        raise RuntimeError(f"sampling the la_train run ran {len(calls)} forwards and launched "
                           f"B3 {l_req} times")
    result["sample_request"] = {"frames": LA_TRAIN_H, "num": 4, "seconds": s_req,
                                "fused_qkv_local_attention_launches": l_req}
    emit({"phase": "main_path", "path": "la_train", **result})
    return result


# ---------------------------------------------------------------------------
# Stack B: the MDM transformer (no kernel; plain PyTorch on the card)


def kernel_counts():
    """Every kernel wrapper's launch count."""
    return {f"{mod.__name__.rsplit('.', 1)[-1]}.{fn.__name__}": fn.launches for mod, fn in (
        (CB, CB.conv_gn_mish_cuda), (CB, CB.conv_gn_mish_bf16_cuda),
        (CW, CW.conv1d_weight_grad_cuda), (CW, CW.conv1d_weight_grad_bf16_cuda),
        (FA, FA.fused_qkv_local_attention_cuda),
        (FA, FA.fused_qkv_local_attention_bf16_cuda), (LH, LH.local_attention_heads_cuda),
        (DK, DK.control_step_cuda), (DK, DK.rollout_cuda), (DK, DK.tracking_reward_cuda))}


def b_reference_forward(model, dev, seed):
    """One forward at 2B x H with a padded key mask (one sample all masked)
    and labels, on the card in float32 against the same weights in float64
    on the CPU. -> (max abs err / max |reference|, inputs)."""
    g = torch.Generator().manual_seed(seed)
    n = 2 * B_B
    x = torch.randn(n, B_H, model.final_layer.out_features, generator=g)
    t = torch.randint(0, T, (n,), generator=g)
    y = torch.arange(n) % (model.num_classes + 1)
    lengths = torch.randint(B_H // 4, B_H + 1, (n,), generator=g)
    lengths[0], lengths[-1] = B_H, 0
    mask = (torch.arange(B_H)[None, :] < lengths[:, None]).float()
    with torch.inference_mode():
        out = model(x.to(dev), t.to(dev), y.to(dev), mask.to(dev)).cpu().double()
        ref = copy.deepcopy(model).cpu().double()(x.double(), t, y, mask.double())
    if not torch.isfinite(out).all():
        raise RuntimeError("stack-B forward on the card is not finite")
    return ((out - ref).abs().max() / ref.abs().max()).item(), (x, t, y, mask)


def b_serve_phase(dev, timer, args, tmp, cfg):
    """The stack-B serving path: a class-conditioned CFG request and an
    unconditioned one through ``cli.sample.main``, the card-against-float64
    forward, and the serving profile."""
    run = os.path.join(tmp, "b_run")
    write_model_run(run, cfg, args.seed, adaln_modulations)
    steps = cfg.diffusion.noise_steps - 1  # v4 runs the model at t = T-1 .. 1
    requests = []
    for class_id in (0, None):
        extra = [] if class_id is None else ["--class-id", str(class_id)]
        out_dir = os.path.join(tmp, f"b_serve_{class_id}")
        reset_counts()
        with counted_forwards(TransformerMotionModel) as calls, \
                contextlib.redirect_stdout(io.StringIO()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths = cli.main(["--run", run, "--num", str(B_B), "--frames", str(B_H),
                              "--conditioner", "holding_box", "--out", out_dir,
                              "--device", str(dev), *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = kernel_counts()
        batch = 2 * B_B if class_id is not None else B_B  # CFG: one 2B forward a step
        if len(calls) != steps or set(calls) != {batch}:
            raise RuntimeError(f"the class {class_id} request ran {len(calls)} forwards of "
                               f"batch {sorted(set(calls))}, expected {steps} of {batch}")
        check_motions(paths, B_H, B_B)
        requests.append({"class_id": class_id, "cfg_scale": cfg.diffusion.cfg_scale
                         if class_id is not None else None, "frames": B_H, "num": B_B,
                         "T": cfg.diffusion.noise_steps, "forwards": len(calls),
                         "forward_batch": batch, "seconds": seconds,
                         "samples_per_s": B_B / seconds, "kernel_launches": launches})
    emit({"phase": "main_path", "path": "b_serve", "requests": requests})

    _, model, sched, payload, _ = cli.load_run(run, device=dev)
    model.load_state_dict(payload["params"])
    model.eval()
    err, (x, t, y, mask) = b_reference_forward(model, dev, args.seed + 3)
    if not err <= B_FWD_TOL:
        raise RuntimeError(f"stack-B forward on the card differs from float64 by {err} "
                           f"(relative), tolerance {B_FWD_TOL}")
    x, t, y, mask = (a.to(dev) for a in (x, t, y, mask))
    with torch.inference_mode():
        fwd_ms = timer(lambda: model(x, t, y, mask), reps=10)

    window_steps = min(50, steps)
    y16 = torch.zeros(B_B, dtype=torch.long, device=dev)
    uy = torch.full((B_B,), cfg.model.num_classes, dtype=torch.long, device=dev)
    cond = conditioning.holding_box(cfg.model.input_dim, device=dev)

    def window():
        out = sample_loop(sched, model, (B_B, B_H, cfg.model.input_dim),
                          torch.Generator(device=dev).manual_seed(args.seed), mode="v4",
                          predict_epsilon=False, conditioning_fn=cond,
                          cfg_scale=cfg.diffusion.cfg_scale, y=y16, uncond_y=uy,
                          t_start=window_steps + 1).trajectories
        torch.cuda.synchronize()
        return out

    x = window()  # the chain's own output: all 69 dims, not the 35 the CLI saves
    if x.shape != (B_B, B_H, cfg.model.input_dim) or not torch.isfinite(x).all():
        raise RuntimeError(f"stack-B CFG chain: shape {tuple(x.shape)}, finite "
                           f"{bool(torch.isfinite(x).all())}")
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3 / window_steps
    device_ms, top, host_ops = device_time_by_kernel(window, window_steps)
    result = {"requests": requests, "forward_rel_err_vs_float64": err,
              "forward_tolerance": B_FWD_TOL, "forward_ms": fwd_ms,
              "forward_shape": {"B": 2 * B_B, "H": B_H, "all_masked_samples": 1},
              "profile": {"device_ms_per_step": device_ms, "wall_ms_per_step": wall_ms,
                          "device_busy_share": device_ms / wall_ms if device_ms else None,
                          "top_kernels": top, "top_host_ops": host_ops}}
    emit({"phase": "chains", "path": "b_serve",
          **{k: v for k, v in result.items() if k != "profile"}})
    emit({"phase": "profile", "path": "b_serve", **result["profile"]})
    return result, run


def b_train_args(run_dir, seed, dev, *extra):
    return ["--config", str(B_CONFIG), "--data", str(MOTIONS), "--batch-size", str(B_TRAIN_B),
            "--steps", str(B_TRAIN_STEPS), "--out", run_dir, "--device", str(dev), "--set",
            "train.log_every=10", "train.save_every=15", "train.ema_start=20",
            "train.ema_every=10", f"train.seed={seed}", *extra]


def b_train_run(dev, run, seed, *extra):
    """One ``cli.train.main`` run; -> its record (checks included)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = train_cli.main(b_train_args(run, seed, dev, *extra))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ckpts = Path(run) / "checkpoints"
    saved = sorted(p.name for p in ckpts.glob("*.pt"))
    for name in ("best_model.pt", "state_15.pt", f"state_{B_TRAIN_STEPS}.pt"):
        if not (ckpts / name).exists():
            raise RuntimeError(f"stack-B training wrote no {name}: {saved}")
    metrics = json.loads((Path(run) / "training_metrics.json").read_text())
    losses = [r["loss"] for r in metrics["metrics"]]
    cfg = ExperimentConfig.load(os.path.join(run, "config.json"))
    logged = log_steps(B_TRAIN_STEPS * cfg.train.gradient_accumulate_every,
                       cfg.train.gradient_accumulate_every, cfg.train.scan_chunk)
    if ([r["step"] for r in metrics["metrics"]] != logged or not np.isfinite(losses).all()
            or not np.isfinite(metrics["best_loss"])):
        raise RuntimeError(f"stack-B training metrics: {metrics}, expected records at "
                           f"steps {logged}")
    if trainer.dataset.horizon != B_TRAIN_H or trainer.config.batch_size != B_TRAIN_B:
        raise RuntimeError(f"stack-B training ran H {trainer.dataset.horizon}, "
                           f"B {trainer.config.batch_size}")
    ema_moved = any((trainer.state.ema_params[k] != v).any().item()
                    for k, v in trainer.state.model.state_dict().items())
    record = {"seconds": seconds, "optimizer_steps": B_TRAIN_STEPS, "batch": B_TRAIN_B,
              "horizon": trainer.dataset.horizon, "variants": len(trainer.dataset),
              "losses": losses, "best_loss": metrics["best_loss"],
              "best_step": metrics["best_step"], "checkpoints": saved,
              "ema_differs_from_params": ema_moved, "kernel_launches": kernel_counts()}
    if not ema_moved:
        raise RuntimeError("stack-B training left the EMA equal to the params")
    sampler = trainer.sampler_state
    if sampler is not None:
        recorded = int(sampler.counts.sum())
        if not (0 < recorded <= B_TRAIN_STEPS * B_TRAIN_B
                and torch.isfinite(sampler.losses).all()):
            raise RuntimeError(f"loss-aware sampler recorded {recorded} losses")
        record["loss_aware_recorded"] = recorded
    return record


def b_grad_check(dev, cfg, seed):
    """One x0-loss gradient (B_GRAD_B rows of the dataset at H 160, injected t,
    noise and label-drop mask, dropout off) on the card in float32 against
    the CPU in float64: every parameter's gradient and the loss. A ReLU
    input within float32 rounding of 0 can take the other sign on the card,
    which moves its row of the gradient by a whole token's share (about 1e-2
    of the largest element); so the float64 run takes the card's sign there,
    at a value of +-1e-30, and the phase reports how many it took."""
    ds = MotionDataset.from_path(str(MOTIONS), include_velocity=True, augment="cyclic_rooted",
                                 horizon_multiple=8).truncated(cfg.model.max_seq_len)
    batch = next(ds.epochs(B_GRAD_B, seed=seed))
    g = torch.Generator().manual_seed(seed)
    x0 = torch.from_numpy(batch.trajectories)
    t = torch.randint(0, cfg.diffusion.noise_steps, (B_GRAD_B,), generator=g)
    noise = torch.randn(x0.shape, generator=g)
    drop = torch.arange(B_GRAD_B) % 4 == 0
    y, mask = torch.from_numpy(batch.motion_class).long(), torch.from_numpy(batch.mask)
    model = seeded_model(cfg, seed, adaln_modulations)
    signs, flips = [], []

    def record(mod, inp, out):
        signs.append((out > 0).cpu())

    def follow(mod, inp, out):
        card = signs[len(flips)].to(out.device)
        flip = (out > 0) != card
        flips.append(int(flip.sum()))
        target = torch.where(card, 1e-30, -1e-30).to(out.dtype)
        return torch.where(flip, target + (out - out.detach()), out)  # value target, slope 1

    def grads(m, d, dtype, hook):
        m = m.to(d, dtype).eval()
        for layer in m.layers:
            layer.ff.dense_0.register_forward_hook(hook)
        sched = factory.build_schedule(cfg.diffusion, d)
        loss_fn = make_loss_fn(sched, m, kind="x0", predict_epsilon=False,
                               null_label=cfg.model.num_classes, use_mask=True)
        m.zero_grad(set_to_none=True)
        loss, _ = loss_fn(x0.to(d, dtype), t.to(d), noise.to(d, dtype), y=y.to(d),
                          mask=mask.to(d, dtype), drop=drop.to(d))
        loss.backward()
        return loss.item(), {k: p.grad.double().cpu() for k, p in m.named_parameters()}

    loss_k, g_k = grads(copy.deepcopy(model), dev, torch.float32, record)
    loss_r, g_r = grads(model, torch.device("cpu"), torch.float64, follow)
    floor = B_GRAD_FLOOR * max(v.abs().max().item() for v in g_r.values())
    rel = {k: ((g_k[k] - v).abs().max() / max(v.abs().max().item(), floor)).item()
           for k, v in g_r.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    if not (rel[worst] <= B_GRAD_TOL and loss_rel <= B_FWD_TOL
            and all(torch.isfinite(v).all() for v in g_k.values())):
        raise RuntimeError(f"x0-loss gradient on the card against float64: loss rel err "
                           f"{loss_rel}, {worst} rel err {rel[worst]} (tolerance {B_GRAD_TOL})")
    return {"batch": B_GRAD_B, "H": x0.shape[1], "loss": loss_k, "loss_float64": loss_r,
            "loss_rel_err": loss_rel, "params": len(rel), "max_grad_rel_err": rel[worst],
            "worst_param": worst, "median_grad_rel_err": float(np.median(list(rel.values()))),
            "tolerance": B_GRAD_TOL, "relu_inputs_given_the_card_sign": sum(flips),
            "relu_inputs": sum(int(sg.numel()) for sg in signs)}


def b_train_phase(dev, args, tmp, cfg, steps=10):
    """The stack-B training path: two ``cli.train.main`` runs (the config's
    x0 loss with dropout and label drop; then v4 with the loss-aware
    sampler), the gradient check, and the training profile."""
    runs = {"x0": b_train_run(dev, os.path.join(tmp, "b_train"), args.seed),
            "v4_loss_aware": b_train_run(dev, os.path.join(tmp, "b_train_la"), args.seed,
                                         "diffusion.loss=v4", "train.timestep_sampler=loss_aware")}
    emit({"phase": "main_path", "path": "b_train", "runs": runs})
    grad = b_grad_check(dev, cfg, args.seed)
    emit({"phase": "grads", "path": "b_train", **grad})

    trainer = train_cli.build_trainer(cfg.override({"data.path": str(MOTIONS),
                                                    "train.seed": args.seed}), device=dev)
    trainer.config = dataclasses.replace(trainer.config, log_every=10 ** 9,
                                         best_window_frac=-1e6)

    def window():
        trainer.train(num_steps=steps)
        torch.cuda.synchronize()

    window()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
    device_ms, top, host = device_time_by_kernel(window, steps)
    profile = {"ms_per_optimizer_step": wall_ms, "optimizer_steps_per_s": 1e3 / wall_ms,
               "batch": trainer.config.batch_size, "horizon": trainer.dataset.horizon,
               "device_ms_per_step": device_ms,
               "device_busy_share": device_ms / wall_ms if device_ms else None,
               "top_kernels": top, "top_host_ops": host, "peak_memory_bytes": peak}
    emit({"phase": "profile", "path": "b_train", **profile})
    return {"runs": runs, "grads": grad, "profile": profile}


def run_copy(run, dst, over):
    """A copy of the run directory (the same checkpoint) with ``over`` applied
    to its config.json."""
    shutil.copytree(run, dst)
    config = os.path.join(dst, "config.json")
    ExperimentConfig.load(config).override(over).save(config)
    return dst


def short_run(run, steps):
    """A copy of the run directory whose config cuts its chains to ``steps``."""
    return run_copy(run, run + f"_t{steps}", {"diffusion.noise_steps": steps})


def b_eval_phase(dev, run):
    """``cli.evaluate.main`` and ``cli.cfg_eval.main`` on the served run:
    finite metrics of the expected keys (random weights: the scores
    themselves mean nothing), on a copy of the run with B_EVAL_T-step chains."""
    run = short_run(run, B_EVAL_T)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ev = evaluate_cli.main(["--run", run, "--gt", str(WALK), "--num", "8", "--reps", "2",
                                "--frames", "64", "--device", str(dev)])
    torch.cuda.synchronize()
    ev_s = time.perf_counter() - t0
    bad = [k for k, v in ev.items() if not np.isfinite([v["mean"], v["std"]]).all()]
    if bad or len(ev) != 6:
        raise RuntimeError(f"cli.evaluate: non-finite or missing metrics {bad}: {ev}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        report = cfg_eval_cli.main(["--run", run, "--scales", "3", "--num", "2",
                                    "--frames", "64", "--data-dir", str(MOTIONS),
                                    "--device", str(dev)])
    torch.cuda.synchronize()
    cfg_s = time.perf_counter() - t0
    summary = {}
    for s, r in report["scales"].items():
        rows = r["per_class"].values()
        vals = [r["class_accuracy"], r["mean_sifid_own"], r["mean_rmse_min"]]
        vals += [v for row in rows for v in (row["sifid_own"], row["rmse_min"],
                                             row["intra_div"])]
        if len(r["per_class"]) != 9 or not np.isfinite(vals).all():
            raise RuntimeError(f"cli.cfg_eval at scale {s}: {r}")
        summary[s] = {k: r[k] for k in ("class_accuracy", "mean_sifid_own", "mean_rmse_min")}
    # the SVD of one SiFID call in cfg_eval: (2, 690, 690), by cuSOLVER driver
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(2, 690, 6, device=dev, generator=g)
    b = torch.randn(690, 150, device=dev, generator=g)
    product = (b @ b.T / 149) @ (a @ a.transpose(1, 2) / 5)
    svd_ms = {}
    for driver in ("gesvd", None):
        torch.linalg.svd(product, driver=driver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            torch.linalg.svd(product, driver=driver)
        torch.cuda.synchronize()
        svd_ms[driver or "default"] = (time.perf_counter() - t0) / 5 * 1e3
    result = {"T": B_EVAL_T, "evaluate": {"seconds": ev_s, "metrics": ev},
              "cfg_eval": {"seconds": cfg_s, "scales": summary},
              "sifid_svd_ms": svd_ms, "kernel_launches": kernel_counts()}
    emit({"phase": "main_path", "path": "b_eval", **result})
    return result


def dec_phase(dev, timer, args, tmp):
    """The decoder (no kernel; f32 with TF32 off): ``cli.train.main`` on the
    user config experiments/decoder10k (angle + velocity loss, walk H 32, B
    64) for 30 steps, one ``cli.sample.main`` request answered from the run
    (v4, T 1000, B 16 x H 32), and one forward on the card against the same
    weights in float64 on the CPU."""
    run = os.path.join(tmp, "dec")
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = train_cli.main([
            "--config", str(DEC_CONFIG), "--data", str(WALK), "--steps", str(DEC_STEPS),
            "--out", run, "--device", "cuda", "--set", "train.log_every=10",
            "train.scan_chunk=1", "train.save_every=15", "train.ema_start=20",
            "train.ema_every=10", f"train.seed={args.seed}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if (trainer.dataset.horizon, trainer.config.batch_size) != (DEC_H, DEC_TRAIN_B):
        raise RuntimeError(f"dec ran H {trainer.dataset.horizon}, B {trainer.config.batch_size}")
    ckpts = Path(run) / "checkpoints"
    saved = sorted(p.name for p in ckpts.glob("*.pt"))
    for name in ("best_model.pt", "state_15.pt", f"state_{DEC_STEPS}.pt"):
        if not (ckpts / name).exists():
            raise RuntimeError(f"dec wrote no {name}: {saved}")
    metrics = json.loads((Path(run) / "training_metrics.json").read_text())
    recs = metrics["metrics"]
    ema_moved = any((trainer.state.ema_params[k] != v).any().item()
                    for k, v in trainer.state.model.state_dict().items())
    if ([r["step"] for r in recs] != log_steps(DEC_STEPS, 1, 1) or not ema_moved
            or not all(np.isfinite([r["loss"], r["loss_angle"], r["loss_velocity"]]).all()
                       for r in recs)):
        raise RuntimeError(f"dec metrics {metrics}, EMA moved {ema_moved}")
    result = {"seconds": seconds, "optimizer_steps": DEC_STEPS, "batch": DEC_TRAIN_B,
              "horizon": DEC_H, "losses": [r["loss"] for r in recs],
              "best_loss": metrics["best_loss"], "checkpoints": saved,
              "ema_differs_from_params": ema_moved, "kernel_launches": kernel_counts()}
    del trainer

    with counted_forwards(TransformerDecoderMotionModel) as calls:
        _, s_req, _ = request(run, os.path.join(tmp, "dec_req"), DEC_H, num=B)
    cfg = ExperimentConfig.load(os.path.join(run, "config.json"))
    if len(calls) != cfg.diffusion.noise_steps - 1 or set(calls) != {B}:
        raise RuntimeError(f"the dec request ran {len(calls)} forwards of batch {set(calls)}")
    result["sample_request"] = {"frames": DEC_H, "num": B, "T": cfg.diffusion.noise_steps,
                                "forwards": len(calls), "seconds": s_req,
                                "samples_per_s": B / s_req}

    model, _ = load_model(run, dev)
    g = torch.Generator().manual_seed(args.seed + 4)
    x = torch.randn(B, DEC_H, cfg.model.input_dim, generator=g)
    t = torch.randint(0, cfg.diffusion.noise_steps, (B,), generator=g)
    with torch.inference_mode():
        out = model(x.to(dev), t.to(dev)).cpu().double()
        ref = copy.deepcopy(model).cpu().double()(x.double(), t)
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    if not (err <= B_FWD_TOL and torch.isfinite(out).all()):
        raise RuntimeError(f"decoder forward on the card differs from float64 by {err}")
    xd, td = x.to(dev), t.to(dev)
    with torch.inference_mode():
        fwd_ms = timer(lambda: model(xd, td), reps=10)
    result.update(forward_rel_err_vs_float64=err, forward_tolerance=B_FWD_TOL,
                  forward_ms=fwd_ms)
    emit({"phase": "main_path", "path": "dec", **result})
    return result


def guide_phase(dev, timer, args, tmp, peaks):
    """Value guidance: ``guided_sample_loop`` with the serve phase's dim-128
    U-Net run cut to T GUIDE_T (posterior, B 16 x H 64, holding_box) and a seeded
    ValueFunction (dim 32, mults 1, 2, 4, 8, over H 64, parameters frozen):
    B1's launches (33 U-Net + 20 value blocks a step, no B2), the sorted
    values and finite trajectories; one ``value_gradients`` call and one
    ``value_diffusion_loss`` step's gradients (B1 and B2) against the plain
    versions; the profile of 20 guided steps; B1's and B2's rows at the
    ValueFunction's shapes."""
    unet, sched = load_model(short_run(os.path.join(tmp, "serve_run"), GUIDE_T), dev)
    torch.manual_seed(args.seed)
    value = ValueFunction(D, H, dim=GUIDE_DIM).to(dev).eval().requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(args.seed + 5)
    x = torch.randn(B, H, D, generator=g, device=dev)
    t = torch.randint(0, GUIDE_T, (B,), generator=g, device=dev)
    shapes = Counter(record_block_shapes(value, x, t))
    per_value, per_unet = sum(shapes.values()), 33
    cond = conditioning.holding_box(D, device=dev)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, values = guided_sample_loop(sched, unet, value, (B, H, D),
                                     torch.Generator(device=dev).manual_seed(args.seed),
                                     conditioning_fn=cond)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    b1, b2 = counts()
    traj = out.trajectories
    if (b1, b2) != ((per_unet + per_value) * GUIDE_T, 0):
        raise RuntimeError(f"guided sampling launched conv_gn_mish {b1} and conv1d_weight_grad "
                           f"{b2} times, expected ({per_unet} + {per_value}) x {GUIDE_T} and 0")
    if (traj.shape != (B, H, D) or not torch.isfinite(traj).all()
            or not torch.isfinite(values).all() or not (values[:-1] >= values[1:]).all()):
        raise RuntimeError(f"guided sampling: shape {tuple(traj.shape)}, values {values}")
    result = {"seconds": seconds, "samples_per_s": B / seconds, "T": GUIDE_T, "B": B, "H": H,
              "value_dim": GUIDE_DIM, "conv_gn_mish_launches": b1,
              "conv_gn_mish_launches_per_step": b1 // GUIDE_T, "conv1d_weight_grad_launches": b2,
              "values_sorted": values.tolist()}

    reset_counts()
    y_k, g_k = value_gradients(value, x, t)
    torch.cuda.synchronize()
    launched = counts()
    with plain_kernels():
        y_p, g_p = value_gradients(value, x, t)
    y_err = (y_k - y_p).abs().max().item()
    g_err = ((g_k - g_p).abs().max() / g_p.abs().max()).item()
    if launched != (per_value, 0) or not (y_err <= FORWARD_TOL and g_err <= GRAD_TOL):
        raise RuntimeError(f"value_gradients with B1 vs plain: launches {launched}, value err "
                           f"{y_err}, grad rel err {g_err}")
    result["value_gradients"] = {"conv_gn_mish_launches": launched[0], "value_max_abs_err": y_err,
                                 "grad_rel_err": g_err}

    trainable = copy.deepcopy(value).requires_grad_(True).train()
    x0 = torch.randn(B, H, D, generator=g, device=dev)
    target = torch.randn(B, generator=g, device=dev)
    noise = torch.randn(B, H, D, generator=g, device=dev)

    def step():
        trainable.zero_grad(set_to_none=True)
        loss, _ = value_diffusion_loss(sched, trainable, x0, target, t, noise)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in trainable.named_parameters()}

    reset_counts()
    loss_k, grads_k = step()
    launched = counts()
    with plain_kernels():
        loss_p, grads_p = step()
    rel = {k: ((grads_k[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
           for k, v in grads_p.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / loss_p
    if launched != (per_value, per_value) or not (loss_rel <= LOSS_TOL
                                                  and rel[worst] <= GRAD_TOL):
        raise RuntimeError(f"value_diffusion_loss with B1, B2 vs plain: launches {launched}, "
                           f"loss rel err {loss_rel}, {worst} grad rel err {rel[worst]}")
    result["value_diffusion_loss"] = {
        "launches": {"conv_gn_mish": launched[0], "conv1d_weight_grad": launched[1]},
        "loss_rel_err": loss_rel, "max_grad_rel_err": rel[worst], "worst_param": worst}

    n = min(20, GUIDE_T)

    def window():
        xs = traj
        for i in range(n):
            ts = torch.full((B,), GUIDE_T - 1 - i, dtype=torch.long, device=dev)
            with torch.no_grad():
                xs, _ = guided_step(sched, unet, value, xs, ts, noise, conditioning_fn=cond)
        torch.cuda.synchronize()

    window()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    device_ms, top, host_ops = device_time_by_kernel(window, n)
    result["profile"] = {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
                         "device_busy_share": device_ms / wall_ms if device_ms else None,
                         "top_kernels": top, "top_host_ops": host_ops}
    emit({"phase": "profile", "path": "guide", **result["profile"]})
    b1 = result["b1_rows"] = b1_rows(dev, timer, {H: shapes}, peaks, B)
    b2 = result["b2_rows"] = b2_rows(dev, timer, shapes, peaks, B)
    w = f"per_forward_h{H}"
    result["value_function_kernels"] = {  # sums over one value forward's / step's 20 launches
        "conv_gn_mish": {"max_abs_err": max(r["max_abs_err"] for r in b1),
                         **{k: sum(r[k] * r[w] for r in b1)
                            for k in ("ms", "plain_ms", "bound_ms", "composition_ms")}},
        "conv1d_weight_grad": {"max_rel_err": max(r["max_rel_err"] for r in b2),
                               **{k: sum(r[k] * r["per_micro_step"] for r in b2)
                                  for k in ("ms", "plain_ms", "bound_ms", "bound_3xtf32_ms",
                                            "library_ms")}}}
    emit({"phase": "main_path", "path": "guide",
          **{k: v for k, v in result.items() if k not in ("profile", "b1_rows", "b2_rows")}})
    return result


# ---------------------------------------------------------------------------
# The humanoid physics (B5, B6, B7)


LAYOUT_OPS = {"unbind", "stack", "select", "slice", "view", "unsqueeze", "squeeze", "expand",
              "alias", "detach", "clone", "zeros", "ones_like", "zeros_like", "full_like",
              "empty", "empty_like", "lift_fresh", "copy_", "cat", "t", "transpose"}


def count_ops(fn):
    """Elementwise arithmetic operations of ``fn()`` on size-1 tensors: every
    aten call counts one, except those that only move or make data."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counting(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in LAYOUT_OPS:
                Counting.n += 1
            return func(*args, **(kwargs or {}))

    with torch.inference_mode(), Counting():
        fn()
    return Counting.n


def physics_op_counts():
    """Operations per env: one substep, one reward, and the rollout step's
    bookkeeping (freeze, fall, gate) beyond those two."""
    clip = load_clip(str(WALK))
    q = torch.tensor(clip.qpos[:1], dtype=torch.float32)
    v = torch.tensor(clip.qvel[:1], dtype=torch.float32)
    h = 1.0 / 30.0 / SUBSTEPS
    substep = count_ops(lambda: DK.control_step_plain(q, v, q, h=h, substeps=1))
    reward = count_ops(lambda: DK.tracking_reward_plain(q, v, q, v))
    step = count_ops(lambda: DK.rollout_plain(q, v, q[None], v[None],
                                              torch.zeros(1, dtype=torch.bool), h=h, substeps=1))
    return {"substep": substep, "reward": reward, "rollout_bookkeeping": step - substep - reward}


def time_plain(fn, reps=1):
    """Per-call ms of a host-bound plain version: CUDA events around each of
    ``reps`` calls made after one warm call; the median."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def staggered_walk(dev, n, steps=1):
    """The walk clip's frames staggered over n envs (PhysicsTrackingEnv.reset),
    each targeting the next ``steps`` frames: qpos, qvel (n, 35/34), targets
    and reference velocities (steps, n, 35/34)."""
    clip = load_clip(str(WALK))
    nf = len(clip.qpos)
    mot = torch.tensor(clip.qpos, dtype=torch.float32, device=dev)
    vel = torch.tensor(clip.qvel, dtype=torch.float32, device=dev)
    frame = (torch.arange(n, device=dev) * nf // n) % nf
    frames = (frame[None] + 1 + torch.arange(steps, device=dev)[:, None]) % nf
    return mot[frame], vel[frame], mot[frames], vel[frames]


def step_errors(out, ref):
    qmax = ref[1].abs().max().item()
    errs = {"qpos": (out[0] - ref[0]).abs().max().item(),
            "qvel": (out[1] - ref[1]).abs().max().item(), "max_abs_qvel": qmax}
    ok = (errs["qpos"] <= STEP_QPOS_TOL and errs["qvel"] <= STEP_QVEL_REL * qmax
          and all(torch.isfinite(t).all() for t in out))
    if len(out) > 2:
        errs["reward"] = (out[2] - ref[2]).abs().max().item()
        ok = ok and errs["reward"] <= REWARD_TOL
    return errs, ok


def dynamics_ptxas():
    """Registers, stack and spill bytes of each B5-B7 entry kernel at each
    lane count, from the build's ptxas log: {"control_step_L8": {...}, ...}."""
    out = {}
    for fn, info in log_of(_build.library_path("humanoid_dynamics")).items():
        for kind in ("control_step", "rollout", "reward"):
            for lanes in DK.LANE_COUNTS:
                if f"{kind}_kernelILi{lanes}E" in fn:
                    out[f"{kind}_L{lanes}"] = info
    return out


def plan_row(N, kind, ptxas):
    """The launch plan of a B5-B7 launch at N, with its entry's ptxas line."""
    plan = DK.dynamics_plan(N)
    return {"plan": dataclasses.asdict(plan), "ptxas": ptxas.get(f"{kind}_L{plan.lanes}")}


def physics_kernel_rows(dev, timer, peaks, ops):
    """B5 (with and without the fused reward) and B7 at N 4096, and B6 at
    T 3, against their plain versions on the same inputs."""
    N, T = PHYS_N, PHYS_KERNEL_T
    qpos, qvel, tgts, rqvs = staggered_walk(dev, N, T)
    kw = dict(h=1.0 / 30.0 / SUBSTEPS, substeps=SUBSTEPS)
    ptxas = dynamics_ptxas()
    rows = {}
    for name, rq in (("control_step", None), ("control_step_reward", rqvs[0])):
        args = (qpos, qvel, tgts[0], rq)
        out = DK.control_step_cuda(*args, **kw)
        ref = DK.control_step_plain(*args, **kw)
        torch.cuda.synchronize()
        errs, ok = step_errors(out, ref)
        if not ok:
            raise RuntimeError(f"{name} kernel disagrees with its plain version at N {N}: {errs}")
        n_ops = N * (SUBSTEPS * ops["substep"] + (ops["reward"] if rq is not None else 0))
        nbytes = 4.0 * N * ((35 + 34 + 35 + 35 + 34) + (34 + 1 if rq is not None else 0))
        bound_ms, bound_by = bound(n_ops, nbytes, peaks)
        rows[name] = {"N": N, "substeps": SUBSTEPS, "max_abs_err": errs,
                      "ms": timer(lambda: DK.control_step_cuda(*args, **kw), reps=10),
                      "plain_ms": time_plain(lambda: DK.control_step_plain(*args, **kw)),
                      "bound_ms": bound_ms, "bound_by": bound_by, "operations": n_ops,
                      "bytes": nbytes, "library_ms": None, **plan_row(N, "control_step", ptxas)}
        emit({"phase": "kernel", "name": name, **rows[name]})

    done = torch.zeros(N, dtype=torch.bool, device=dev)
    rargs = (qpos, qvel, tgts, rqvs, done)
    rkw = dict(kw, fall_height=0.3)
    out = DK.rollout_cuda(*rargs, **rkw)
    ref = DK.rollout_plain(*rargs, **rkw)
    torch.cuda.synchronize()
    errs, ok = step_errors((out[0], out[1], out[2]), (ref[0], ref[1], ref[2]))
    if not (ok and torch.equal(out[3], ref[3])):
        raise RuntimeError(f"rollout kernel disagrees with its plain version: {errs}, done "
                           f"{int(out[3].sum())} vs {int(ref[3].sum())}")
    # the kernel skips the substeps of envs done before a step: count what
    # this run's envs ran (done after a step = its reward gated to exactly 0)
    active = [N] + [N - int((r == 0).sum()) for r in ref[2][:-1]]
    n_ops = (sum(active) * SUBSTEPS * ops["substep"]
             + T * N * (ops["reward"] + ops["rollout_bookkeeping"]))
    nbytes = 4.0 * N * (2 * (35 + 34 + 1) + T * (35 + 34 + 1))
    bound_ms, bound_by = bound(n_ops, nbytes, peaks)
    rows["rollout"] = {"N": N, "T": T, "substeps": SUBSTEPS, "max_abs_err": errs,
                       "done_after": int(out[3].sum()), "active_per_step": active,
                       "ms": timer(lambda: DK.rollout_cuda(*rargs, **rkw), reps=10),
                       "plain_ms": time_plain(lambda: DK.rollout_plain(*rargs, **rkw)),
                       "bound_ms": bound_ms, "bound_by": bound_by, "operations": n_ops,
                       "bytes": nbytes, "library_ms": None, **plan_row(N, "rollout", ptxas)}
    emit({"phase": "kernel", "name": "rollout", **rows["rollout"]})

    g = torch.Generator(device=dev).manual_seed(8)
    ref_q = tgts[0] + 0.05 * torch.randn(tgts[0].shape, generator=g, device=dev)
    bargs = (qpos, qvel, ref_q, rqvs[0])
    out = DK.tracking_reward_cuda(*bargs)
    err = (out - DK.tracking_reward_plain(*bargs)).abs().max().item()
    err_env = (out - tracking_reward(*bargs)).abs().max().item()
    if not (err <= B7_TOL and err_env <= B7_TOL and torch.isfinite(out).all()):
        raise RuntimeError(f"tracking_reward kernel: {err} from its plain version, {err_env} "
                           "from env.tracking_reward")
    bound_ms, bound_by = bound(N * ops["reward"], 4.0 * N * (35 + 34 + 35 + 34 + 1), peaks)
    rows["tracking_reward"] = {
        "N": N, "max_abs_err": err, "max_abs_err_vs_env": err_env,
        "ms": timer(lambda: DK.tracking_reward_cuda(*bargs)),
        "plain_ms": time_plain(lambda: DK.tracking_reward_plain(*bargs), reps=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "operations": N * ops["reward"],
        "library_ms": None, **plan_row(N, "reward", ptxas)}
    emit({"phase": "kernel", "name": "tracking_reward", **rows["tracking_reward"]})
    return rows


def sampled_rollout(env, state, final, rewards):
    """Envs at the start, the middle and the end of a main-path rollout: their
    inputs (as ``PhysicsTrackingEnv.rollout`` makes them) and the kernel's
    results."""
    N = state.qpos.shape[0]
    k = MAIN_CHECK_ENVS
    idx = torch.cat([torch.arange(k), N // 2 - k // 2 + torch.arange(k), N - k + torch.arange(k)])
    idx = idx.to(state.qpos.device)
    frames = (state.frame[None, idx] + 1
              + torch.arange(PHYS_T, device=idx.device)[:, None]) % env.num_frames
    inputs = (state.qpos[idx], state.qvel[idx], env.motion[frames], env.vel[frames],
              state.done[idx])
    return inputs, (final.qpos[idx], final.qvel[idx], rewards[:, idx], final.done[idx])


def rollout_plain_replayed(qpos, qvel, targets, ref_qvels, done, **kw):
    """``DK.rollout_plain`` over T steps as T one-step plain rollouts, the
    step captured once in a CUDA graph and replayed: the same kernels in the
    same order, so the same bits, without the host dispatching each of a
    step's several hundred thousand small kernels again (about 7 s a step)."""
    static = [qpos.clone(), qvel.clone(), targets[:1].clone(), ref_qvels[:1].clone(),
              done.clone()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # one eager step first, as graph capture wants
        DK.rollout_plain(*static, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DK.rollout_plain(*static, **kw)
    rewards = []
    for t in range(targets.shape[0]):
        static[2].copy_(targets[t:t + 1])
        static[3].copy_(ref_qvels[t:t + 1])
        graph.replay()
        rewards.append(out[2].clone())
        for i, o in ((0, 0), (1, 1), (4, 3)):
            static[i].copy_(out[o])
    torch.cuda.synchronize()
    return static[0], static[1], torch.cat(rewards), static[4]


def rollouts_vs_plain(held):
    """The sampled envs of every main-path rollout through one plain T-20
    rollout (envs are independent): errors within the step tolerances."""
    inputs = [torch.cat([h[0][i] for h in held], dim=1 if i in (2, 3) else 0) for i in range(5)]
    out = [torch.cat([h[1][i] for h in held], dim=1 if i == 2 else 0) for i in range(4)]
    ref = rollout_plain_replayed(*inputs, h=1.0 / 30.0 / SUBSTEPS, substeps=SUBSTEPS,
                                 fall_height=0.3)
    errs, ok = step_errors(out[:3], ref[:3])
    if not (ok and torch.equal(out[3], ref[3])):
        raise RuntimeError(f"main-path rollouts disagree with the plain version: {errs}, done "
                           f"{int(out[3].sum())} vs {int(ref[3].sum())}")
    return {"envs": int(inputs[0].shape[0]), "T": PHYS_T, "max_abs_err": errs,
            "done": int(out[3].sum())}


def step_host_us(env, state, reps=30, rounds=3):
    """Host microseconds per B5 wrapper call and per ``env.step`` at N 4096,
    the best of ``rounds`` loops, the card held busy so that no call waits
    (few enough calls that the launch queue does not fill)."""
    nxt = (state.frame + 1) % env.num_frames
    args = (state.qpos, state.qvel, env.motion[nxt], env.vel[nxt])
    kw = env.engine.kernel_args()
    out = {}
    for name, fn in (("wrapper_host_us", lambda: DK.control_step_cuda(*args, **kw)),
                     ("step_host_us", lambda: env.step(state))):
        fn()
        best = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize()
            torch.cuda._sleep(int(0.05 * 2e9))  # ~50 ms at ~2 GHz, longer than the loop
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, (time.perf_counter() - t0) / reps * 1e6)
        out[name] = best
        torch.cuda.synchronize()
    return out


def physics_phase(dev, tmp, ops, peaks):
    """The physics path through its entry points: PhysicsTrackingEnv.rollout
    (one B6 launch each) at N 4096 and 65536, with B6's bound for the
    operations those rollouts ran, 20 step calls (20 B5 launches) held
    against one rollout from the same state, track_motions on the served
    motions and the walk clip (B5 without the reward), and a profile of the
    step loop."""
    clip = load_clip(str(WALK))
    env = PhysicsTrackingEnv(clip.qpos, clip.qvel, dt=1.0 / 30.0, substeps=SUBSTEPS,
                             fall_height=0.3, device=dev)
    result = {"rollout": {}}
    ptxas = dynamics_ptxas()
    held = []  # (inputs, kernel outputs) of sampled envs of each main-path rollout
    for N in (PHYS_N, PHYS_BIG_N):
        state = env.reset(N)
        reset_counts()
        final, rewards = env.rollout(state, PHYS_T)
        torch.cuda.synchronize()
        launches = DK.rollout_cuda.launches
        held.append(sampled_rollout(env, state, final, rewards))
        if launches != 1 or rewards.shape != (PHYS_T, N) or not torch.isfinite(rewards).all():
            raise RuntimeError(f"rollout at N {N}: {launches} B6 launches, rewards "
                               f"{tuple(rewards.shape)}, finite {bool(torch.isfinite(rewards).all())}")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            env.rollout(state, PHYS_T)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        # as in physics_kernel_rows: envs done before a step skip its substeps
        active = [N] + [N - int((r == 0).sum()) for r in rewards[:-1]]
        n_ops = (sum(active) * SUBSTEPS * ops["substep"]
                 + PHYS_T * N * (ops["reward"] + ops["rollout_bookkeeping"]))
        bound_ms, bound_by = bound(n_ops, 4.0 * N * (2 + PHYS_T) * (35 + 34 + 1), peaks)
        result["rollout"][f"n{N}"] = {
            "N": N, "T": PHYS_T, "rollout_launches": launches, "best_seconds": best,
            "env_steps_per_s": N * PHYS_T / best, "reward_mean": rewards.mean().item(),
            "done_frac": final.done.float().mean().item(), "operations": n_ops,
            "bound_ms": bound_ms, "bound_by": bound_by, **plan_row(N, "rollout", ptxas)}
    result["rollout"]["vs_plain"] = rollouts_vs_plain(held)
    emit({"phase": "main_path", "path": "physics_rollout", **result["rollout"]})

    state = env.reset(PHYS_N)
    reset_counts()
    s, rs = state, []
    for _ in range(PHYS_T):
        s, r = env.step(s)
        rs.append(r)
    torch.cuda.synchronize()
    b5 = DK.control_step_cuda.launches
    final, rewards = env.rollout(state, PHYS_T)
    torch.cuda.synchronize()
    errs = {"rewards": (rewards - torch.stack(rs)).abs().max().item(),
            "qpos": (final.qpos - s.qpos).abs().max().item()}
    if not (b5 == PHYS_T and errs["rewards"] <= SAME_CODE_TOL and errs["qpos"] <= SAME_CODE_TOL
            and torch.equal(final.done, s.done) and torch.equal(final.frame, s.frame)):
        raise RuntimeError(f"{PHYS_T} steps ({b5} B5 launches) against one rollout: {errs}, done "
                           f"equal {torch.equal(final.done, s.done)}")
    # B7 through its front door on the last step's state, against the reward
    # B5 fused into that step (equal where the env is not done)
    nxt = s.frame
    reset_counts()
    r7 = DK.tracking_reward_fused(s.qpos, s.qvel, env.motion[nxt], env.vel[nxt])
    torch.cuda.synchronize()
    b7 = DK.tracking_reward_cuda.launches
    live = ~s.done
    errs["reward_front_door"] = (r7[live] - rs[-1][live]).abs().max().item()
    if b7 != 1 or not errs["reward_front_door"] <= SAME_CODE_TOL:
        raise RuntimeError(f"tracking_reward_fused: {b7} launches, {errs}")
    result["steps_vs_rollout"] = {"N": PHYS_N, "steps": PHYS_T, "control_step_launches": b5,
                                  "tracking_reward_launches": b7, "max_abs_err": errs,
                                  "done_frac": s.done.float().mean().item()}
    emit({"phase": "main_path", "path": "physics_steps", **result["steps_vs_rollout"]})

    served = sorted(Path(tmp, "h64").glob("*.npy"))
    motions = np.stack([np.load(p) for p in served])
    if motions.shape != (B, H, D):
        raise RuntimeError(f"served motions: {motions.shape}")
    tracks = {}
    reset_counts()
    for name, m in (("served_unet_h64", motions), ("walk_clip", clip.qpos)):
        res = track_motions(m, horizon=HORIZON, device=dev)
        # NaN (a simulation that blew up) is written as null
        tracks[name] = {k: (None if isinstance(v, float) and not np.isfinite(v) else v)
                        for k, v in {"motions": 1 if np.ndim(m) == 2 else len(m),
                                     "max_abs_qpos": float(np.abs(m).max()),
                                     **res["summary"]}.items()}
        tracks[name]["reward_mean"] = [r if np.isfinite(r) else None
                                       for r in res["reward_mean"].tolist()]
    launches = DK.control_step_cuda.launches
    if launches != HORIZON * 2:
        raise RuntimeError(f"track_motions launched B5 {launches} times, expected {HORIZON} x 2 "
                           "calls")
    if None in tracks["walk_clip"].values() or None in tracks["walk_clip"]["reward_mean"]:
        raise RuntimeError(f"track_motions on the walk clip: {tracks['walk_clip']}")
    # The random-weight U-Net's motions are not physical (|qpos| up to ~1e5) and
    # their scores are not finite: that call counts B5's launches only. The
    # kernel is held against its plain version at the path's own N (16
    # motions of H frames, and the one walk clip) on walk-clip windows, each
    # starting at its own frame, over TRACK_CHECK_HORIZON control steps.
    n_clip = clip.qpos.shape[0]
    windows = np.stack([clip.qpos[(i * n_clip // B + np.arange(H)) % n_clip] for i in range(B)])
    checks = {}
    for name, m in (("walk_windows_n16", windows), ("walk_clip_n1", clip.qpos)):
        before = DK.control_step_cuda.launches
        kern = track_motions(m, horizon=TRACK_CHECK_HORIZON, device=dev)
        with swapped(DK, control_step_cuda=DK.control_step_plain):
            plain = track_motions(m, horizon=TRACK_CHECK_HORIZON, device=dev)
        b5 = DK.control_step_cuda.launches - before
        errs_t = {k: float(np.abs(kern[k] - plain[k]).max()) for k in ("reward_mean", "reward_curve")}
        finite = all(np.isfinite(r[k]).all() for r in (kern, plain)
                     for k in ("reward_mean", "reward_curve"))
        if not (b5 == TRACK_CHECK_HORIZON and finite and max(errs_t.values()) <= REWARD_TOL):
            raise RuntimeError(f"track_motions {name}: {b5} B5 launches, kernel "
                               f"{kern['reward_mean']}, plain {plain['reward_mean']}, finite {finite}")
        checks[name] = {"motions": len(kern["reward_mean"]), "max_abs_err": errs_t,
                        "reward_mean": kern["summary"]["physics_reward_mean"]}
    result["track_motions"] = {"horizon": HORIZON, "control_step_launches": launches, **tracks,
                               "kernel_vs_plain": {"horizon": TRACK_CHECK_HORIZON, **checks}}
    emit({"phase": "main_path", "path": "track_motions", **result["track_motions"]})

    def window():
        st = state
        for _ in range(PHYS_T):
            st, _ = env.step(st)
        torch.cuda.synchronize()

    window()
    t0 = time.perf_counter()
    window()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PHYS_T
    device_ms, top, host_ops = device_time_by_kernel(window, PHYS_T)
    result["profile"] = {"N": PHYS_N, "device_ms_per_step": device_ms, "wall_ms_per_step": wall_ms,
                         "device_busy_share": device_ms / wall_ms if device_ms else None,
                         "top_kernels": top, "top_host_ops": host_ops,
                         **step_host_us(env, state), **plan_row(PHYS_N, "control_step", ptxas)}
    emit({"phase": "profile", "path": "physics_step", **result["profile"]})
    return result



def timed_best(fn, reps=3):
    """(seconds of the fastest of ``reps`` calls, host clock after a sync,
    every time, the first call's result)."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out = res if out is None else out
    return min(times), times, out


def engines_phase(dev, smi):
    """Phase 19: the reference engines (vmap, lanes, aba) through
    DynamicsEnv.step at N 4096 against B5 on the same state; vmap in
    float64 on the card against the CPU; the aba rollout against B6."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on in cuBLAS: the engines' mass matrices need true f32")
    result = {"N": PHYS_N, "substeps": SUBSTEPS, "nvidia_smi": smi, "layouts": {}}
    qpos, qvel, tgts, _ = staggered_walk(dev, PHYS_N)
    kw = dict(h=1.0 / 30.0 / SUBSTEPS, substeps=SUBSTEPS)
    b5 = DK.control_step_cuda(qpos, qvel, tgts[0], **kw)
    for layout in ENGINE_LAYOUTS:
        eng = DynamicsEnv(dt=1.0 / 30.0, substeps=SUBSTEPS, layout=layout)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        best, times, out = timed_best(lambda: eng.step(qpos, qvel, tgts[0]))
        errs = {"qpos": (out[0] - b5[0]).abs().max().item(),
                "qvel": (out[1] - b5[1]).abs().max().item(), "max_abs_qvel": b5[1].abs().max().item()}
        finite = all(torch.isfinite(t).all() for t in out)
        if not (finite and errs["qpos"] <= ENGINE_QPOS_TOL):
            raise RuntimeError(f"layout {layout} against B5 at N {PHYS_N}: {errs}, finite {finite}")
        result["layouts"][layout] = {
            "max_abs_err_vs_b5": errs, "seconds_per_control_step": best, "seconds": times,
            "env_steps_per_s": PHYS_N / best,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - base}
        emit({"phase": "engines", "layout": layout, "N": PHYS_N, "nvidia_smi": smi,
              **result["layouts"][layout]})

    n = ENGINE_F64_N
    eng = DynamicsEnv(dt=1.0 / 30.0, substeps=SUBSTEPS, layout="vmap")
    args = [t[:n].double() for t in (qpos, qvel, tgts[0])]
    card = eng.step(*args)
    cpu = eng.step(*[t.cpu() for t in args])
    errs = {"qpos": (card[0].cpu() - cpu[0]).abs().max().item(),
            "qvel": (card[1].cpu() - cpu[1]).abs().max().item()}
    if not (all(torch.isfinite(t).all() for t in cpu) and errs["qpos"] <= ENGINE_F64_TOL):
        raise RuntimeError(f"vmap float64 at N {n}, the card against the CPU: {errs}")
    result["f64_card_vs_cpu"] = {"N": n, "max_abs_err": errs}
    emit({"phase": "engines", "path": "vmap_f64_card_vs_cpu", **result["f64_card_vs_cpu"]})

    clip = load_clip(str(WALK))
    envs = {layout: PhysicsTrackingEnv(clip.qpos, clip.qvel, dt=1.0 / 30.0, substeps=SUBSTEPS,
                                       fall_height=0.3, layout=layout, device=dev)
            for layout in ("aba", "auto")}
    state = envs["aba"].reset(PHYS_N)
    best, _, (final, rewards) = timed_best(lambda: envs["aba"].rollout(state, ENGINE_ROLLOUT_T),
                                           reps=1)
    ref_final, ref_rewards = envs["auto"].rollout(state, ENGINE_ROLLOUT_T)
    if not (rewards.shape == ref_rewards.shape == (ENGINE_ROLLOUT_T, PHYS_N)
            and torch.isfinite(rewards).all() and torch.isfinite(final.qpos).all()
            and torch.equal(final.frame, ref_final.frame)):
        raise RuntimeError(f"aba rollout: rewards {tuple(rewards.shape)}, finite "
                           f"{bool(torch.isfinite(rewards).all())}")
    both = ~(final.done | ref_final.done)
    result["rollout_aba_vs_b6"] = {
        "N": PHYS_N, "T": ENGINE_ROLLOUT_T, "seconds": best,
        "env_steps_per_s": PHYS_N * ENGINE_ROLLOUT_T / best,
        "max_abs_reward_diff": (rewards - ref_rewards).abs().max().item(),
        "mean_abs_reward_diff": (rewards - ref_rewards).abs().mean().item(),
        "reward_mean": rewards.mean().item(), "reward_mean_b6": ref_rewards.mean().item(),
        "done": int(final.done.sum()), "done_b6": int(ref_final.done.sum()),
        "done_differ": int((final.done != ref_final.done).sum()),
        "max_abs_qpos_diff_live": ((final.qpos - ref_final.qpos)[both].abs().max().item()
                                   if both.any() else None)}
    emit({"phase": "engines", "path": "rollout_aba_vs_b6", **result["rollout_aba_vs_b6"]})
    return result


def mujoco_missing():
    """Why mujoco does not import here, or None when it does."""
    try:
        import mujoco  # noqa: F401
    except ImportError as e:
        return str(e)
    return None


def workflow_violations(wf, m, walk, flip):
    """The frames and dims ``wf`` conditions, which must hold their values
    exactly (tests/test_workflows.py's checks, bit for bit): -> a list of
    what does not."""
    H, bad = walk.shape[0], []
    if wf == "editing":
        if not ((m[:, BOX_ZERO] == 0).all() and (m[:, BOX_ELBOW] == np.float32(1.57)).all()):
            bad.append("holding_box dims")
    elif wf == "start-with-motion" and m.shape[0] != H:
        bad.append(f"horizon {m.shape[0]}")
    elif wf == "short-projection" and m.shape[0] != int(H * 0.75) // 8 * 8:
        bad.append(f"horizon {m.shape[0]}")
    elif wf == "long-projection":
        keys = [f for kf in (0, H, 2 * H) for f in range(max(kf - 2, 0), min(kf + 3, 3 * H))]
        if m.shape[0] != 3 * H or not (m[keys, 3:] == np.tile(walk, (3, 1))[keys, 3:]).all():
            bad.append("keyframes")
    elif wf == "inbetween":
        e = H // 4
        if not ((m[:e] == walk[:e]).all() and (m[-e:] == walk[-e:]).all()):
            bad.append("edges")
    elif wf == "blend":
        a = walk[: H - (H + flip.shape[0]) % 8]
        seam = a.shape[0]
        if (m.shape[0] != seam + flip.shape[0] or not (m[:seam - 5] == a[:seam - 5]).all()
                or not (m[seam + 5:, 3:] == flip[5:, 3:]).all()):
            bad.append("outside the seam")
    elif wf == "steer":
        path = np.linspace(0, 2.0, 16).astype(np.float32)
        if not ((m[:16, 0] == path).all() and (m[:16, 1] == 0).all()):
            bad.append("root path")
    return bad


def run_workflows(run, tmp, per_step):
    """The seven workflows of ``cli.workflows.main`` on a trained U-Net run,
    each with B1's count set to 0 just before and read just after."""
    walk, flip = workflows_cli._clip_qpos(str(WALK)), workflows_cli._clip_qpos(str(BACKFLIP))
    T_run = ExperimentConfig.load(os.path.join(run, "config.json")).diffusion.noise_steps
    rows, paths_of = [], {}
    for wf in workflows_cli.WORKFLOWS:
        reset_counts()
        with counted_forwards(TemporalUnet) as calls, contextlib.redirect_stdout(io.StringIO()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths = workflows_cli.main([wf, "--run", run, "--clip", str(WALK), "--clip2",
                                        str(BACKFLIP), "--num", str(WF_NUM), "--out",
                                        os.path.join(tmp, "wf", wf), "--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        b1, b2 = counts()
        steps = 2 if wf in ("start-with-motion", "blend") else T_run
        if len(calls) != steps or set(calls) != {WF_NUM}:
            raise RuntimeError(f"workflow {wf} ran {len(calls)} forwards of batch "
                               f"{sorted(set(calls))}, expected {steps} of {WF_NUM}")
        if (b1, b2) != (per_step * len(calls), 0):
            raise RuntimeError(f"workflow {wf} launched conv_gn_mish {b1} and "
                               f"conv1d_weight_grad {b2} times, expected {per_step} x "
                               f"{len(calls)} forwards and 0")
        motions = [np.load(p) for p in paths]
        bad = [f"{os.path.basename(p)}: not finite" for p, m in zip(paths, motions)
               if not np.isfinite(m).all()]
        bad += [f"{os.path.basename(p)}: {v}" for p, m in zip(paths, motions)
                for v in workflow_violations(wf, m, walk, flip)]
        if len(paths) != WF_NUM or bad:
            raise RuntimeError(f"workflow {wf}: {len(paths)} motions, {bad[:4]}")
        paths_of[wf] = paths
        rows.append({"workflow": wf, "num": WF_NUM, "frames": motions[0].shape[0],
                     "forwards": len(calls), "conv_gn_mish_launches": b1,
                     "conv1d_weight_grad_launches": b2, "seconds": seconds})
    return rows, paths_of


def run_compare(run, b_run, tmp, per_step):
    """``cli.compare.main`` over the U-Net run and the stack-B run, with the
    walk clip as ground truth and CFG on class 0."""
    reset_counts()
    with counted_forwards(TemporalUnet) as ucalls, \
            counted_forwards(TransformerMotionModel) as bcalls, \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        report = compare_cli.main(["--runs", f"{run},{b_run}", "--gt", str(WALK), "--class-id",
                                   "0", "--num", str(CMP_NUM), "--frames", str(CMP_FRAMES),
                                   "--out", os.path.join(tmp, "compare"), "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    b1, b2 = counts()
    archs = sorted(e["architecture"] for e in report.values())
    bad = [name for name, e in report.items()
           if not (np.isfinite([e["sifid"], e["inter_diversity"]]).all()
                   and e["best_loss"] is not None and e["frames"] == CMP_FRAMES)]
    if archs != ["temporal", "transformer"] or bad:
        raise RuntimeError(f"cli.compare: architectures {archs}, entries failing {bad}: {report}")
    b_cfg = ExperimentConfig.load(os.path.join(b_run, "config.json"))
    if ((b1, b2) != (per_step * len(ucalls), 0) or set(bcalls) != {2 * CMP_NUM}
            or len(bcalls) != b_cfg.diffusion.noise_steps - 1):
        raise RuntimeError(f"cli.compare: conv_gn_mish {b1}, conv1d_weight_grad {b2} for "
                           f"{len(ucalls)} U-Net forwards; {len(bcalls)} transformer "
                           f"forwards of batch {sorted(set(bcalls))}")
    return {"seconds": seconds, "unet_forwards": len(ucalls), "conv_gn_mish_launches": b1,
            "transformer_forwards": len(bcalls), "transformer_batch": 2 * CMP_NUM,
            "report": {name: {k: e[k] for k in ("architecture", "frames", "best_loss",
                                                 "checkpoint_step", "sifid",
                                                 "inter_diversity")}
                       for name, e in report.items()}}


def run_sweep(tmp, per_step):
    """``cli.sweep.main``: two learning rates over the user config's dim-128
    U-Net on the walk clip, SWEEP_STEPS optimizer steps each."""
    base = ExperimentConfig.load(str(USER_CONFIG)).override({
        "data.path": str(WALK), "train.num_train_steps": SWEEP_STEPS})
    base = dataclasses.replace(base, name="sweep")
    base.save(os.path.join(tmp, "sweep_base.json"))
    with open(os.path.join(tmp, "sweep_grid.json"), "w") as f:
        json.dump({"train.lr": [1e-3, 1e-4]}, f)
    out = os.path.join(tmp, "sweep")
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        summary = sweep_cli.main(["--config", os.path.join(tmp, "sweep_base.json"), "--grid",
                                  os.path.join(tmp, "sweep_grid.json"), "--out", out,
                                  "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    b1, b2 = counts()
    micro = 2 * SWEEP_STEPS * base.train.gradient_accumulate_every
    files = [f for f in ("interim_summary.json", "final_summary.json", "best_configs.txt")
             if os.path.exists(os.path.join(out, f))]
    losses = [v for r in summary["all"] for v in (r["best_loss"], r["final_loss"])]
    if (b1, b2) != (per_step * micro, per_step * micro):
        raise RuntimeError(f"cli.sweep launched conv_gn_mish {b1} and conv1d_weight_grad {b2} "
                           f"times, expected {per_step} x {micro} micro-steps each")
    if len(files) != 3 or len(summary["all"]) != 2 or not np.isfinite(losses).all():
        raise RuntimeError(f"cli.sweep wrote {files}: {summary}")
    return {"seconds": seconds, "runs": 2, "micro_steps": micro,
            "conv_gn_mish_launches": b1, "conv1d_weight_grad_launches": b2,
            "best": {k: summary["best"][k] for k in ("name", "best_loss", "best_step")}}


def run_playback(dev, tmp, motion_path, no_mujoco):
    """``softrender.render_motion`` on a workflow motion (the forward
    kinematics on the card, held against the CPU's on the walk clip) and
    ``VideoSaver``; ``cli.play.main --physics --video`` where mujoco
    imports."""
    walk = load_clip(str(WALK)).qpos
    pos, quat = softrender.body_poses(walk, device=dev)
    ref_pos, ref_quat = softrender.body_poses(walk, device="cpu")
    fk_err = max(np.abs(pos - ref_pos).max(), np.abs(quat - ref_quat).max())
    if not fk_err <= FK_TOL:
        raise RuntimeError(f"forward kinematics on the card differ from the CPU's by {fk_err}")
    motion = np.load(motion_path)
    t0 = time.perf_counter()
    frames = softrender.render_motion(motion, device=dev)
    render_s = time.perf_counter() - t0
    if frames.shape != (motion.shape[0], 480, 640, 3) or frames.dtype != np.uint8:
        raise RuntimeError(f"render_motion gave {frames.shape} {frames.dtype}")
    video = os.path.join(tmp, "workflow.avi")
    saver = VideoSaver(video)
    for f in frames:
        saver.write(f)
    saver.close()
    artifact = [p for p in (video, video + ".npy") if os.path.exists(p) and os.path.getsize(p)]
    if not artifact:
        raise RuntimeError("VideoSaver wrote nothing")
    result = {"frames": int(frames.shape[0]), "render_seconds": render_s,
              "fk_max_abs_err_card_vs_cpu": float(fk_err),
              "video": os.path.basename(artifact[0]), "video_bytes": os.path.getsize(artifact[0])}
    if no_mujoco:
        emit({"phase": "note", "path": "workflows", "note": "mujoco does not import on this "
              f"machine ({no_mujoco}): cli.play's MuJoCo player is not run; B5 on its "
              "--physics path (track_motions) is driven by the physics phase"})
        result["play"] = None
        return result
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        t0 = time.perf_counter()
        _, res = play_cli.main([motion_path, "--physics", "--physics-horizon",
                                str(PLAY_HORIZON), "--video", os.path.join(tmp, "play.avi"),
                                "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    b5 = DK.control_step_cuda.launches
    if b5 != PLAY_HORIZON or len(out.getvalue().splitlines()) != 2:
        raise RuntimeError(f"cli.play --physics launched control_step {b5} times, expected "
                           f"{PLAY_HORIZON}: {out.getvalue()}")
    result["play"] = {"seconds": seconds, "control_step_launches": b5,
                      "summary": res["summary"], "lines": out.getvalue().splitlines()}
    return result


def run_walk(tmp, no_mujoco):
    """The port's end-to-end walk at WALK_STEPS: train (scan_chunk 10), sample,
    play into a video. Where mujoco does not import, the play step draws the
    first sample with the software renderer on the card instead of the
    MuJoCo player, and the result says so."""
    out = os.path.join(tmp, "walk")
    real_play = play_cli.main
    if no_mujoco:
        def stand_in(argv):
            video = argv[argv.index("--video") + 1]
            motion = np.load(argv[0])
            saver = VideoSaver(video)
            for f in softrender.render_motion(np.concatenate([motion, motion]), device="cuda"):
                saver.write(f)
            saver.close()
        play_cli.main = stand_in
    reset_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            motion, artifacts = end_to_end_walk.main(["--steps", str(WALK_STEPS), "--out", out,
                                                      "--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        play_cli.main = real_play
    metrics = json.loads((Path(out) / "training_metrics.json").read_text())
    logged = [r["step"] for r in metrics["metrics"]]
    m = np.load(motion)
    if logged != log_steps(WALK_STEPS, 1, 10) or not artifacts or not np.isfinite(m).all():
        raise RuntimeError(f"the walk logged steps {logged}, wrote {artifacts}, motion "
                           f"{m.shape} finite {np.isfinite(m).all()}")
    return {"seconds": seconds, "steps": WALK_STEPS, "logged_steps": logged,
            "best_loss": metrics["best_loss"], "motion_shape": list(m.shape),
            "video": [os.path.basename(a) for a in artifacts],
            "player": "software renderer on the card (mujoco does not import)" if no_mujoco
            else "mujoco",
            "kernel_launches": kernel_counts()}


def workflows_phase(dev, tmp, per_step, b_run):
    """Phase 18: the repo's own workflows on the card, on the train phase's
    run and the b_serve run."""
    run = os.path.join(tmp, "train_run")
    result = {}
    for name, fn, a in (("workflows", run_workflows, (short_run(run, WF_T), tmp, per_step)),
                        ("compare", run_compare, (run, b_run, tmp, per_step)),
                        ("sweep", run_sweep, (tmp, per_step))):
        t0 = time.perf_counter()
        out = fn(*a)
        if name == "workflows":
            out, paths_of = out
        result[name] = out
        emit({"phase": "main_path", "path": name, "seconds": time.perf_counter() - t0,
              name: out})
    no_mujoco = mujoco_missing()
    result["playback"] = run_playback(dev, tmp, paths_of["editing"][0], no_mujoco)
    emit({"phase": "main_path", "path": "playback", **result["playback"]})
    result["walk"] = run_walk(tmp, no_mujoco)
    emit({"phase": "main_path", "path": "walk", **result["walk"]})
    return result


# ---------------------------------------------------------------------------
# The parallel layer (phase 20)


def window_ms(trainer, steps=PAR_STEPS):
    """Host-clock ms per optimizer step of ``steps`` steps ended by a sync."""
    t0 = time.perf_counter()
    trainer.train(num_steps=steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def nccl_train(dev, args, tmp, per_step):
    """``cli.train`` on the user config with the process group started by its
    own flags (NCCL, world size 1), bit-equal to the same run without the
    flags at the same seed; then the CLI's trainer with and without the
    group in PAR_STEPS-step windows taken in turns: ms per optimizer step,
    their parameters after the same steps bit-equal (an all_reduce over one
    rank is the identity), one step traced through ``utils.profiling.trace``,
    and the gradient all_reduce's ms per step. Runs with cuDNN's
    deterministic algorithms, which the bit-equality needs."""
    micro = TRAIN_STEPS * ACCUM
    seconds = {}
    trainers = {}
    for name, flags in (("plain", []), ("nccl", [
            "--coordinator", f"file://{tmp}/nccl_store", "--num-processes", "1",
            "--process-id", "0"])):
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            trainers[name] = train_cli.main(
                train_args(os.path.join(tmp, f"train_run_{name}"), args.seed) + flags)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    b1, b2 = counts()
    if dist.is_initialized() or (b1, b2) != (per_step * micro, per_step * micro):
        raise RuntimeError(f"the NCCL run launched conv_gn_mish {b1} and conv1d_weight_grad "
                           f"{b2} times (expected {per_step} x {micro}); group left open: "
                           f"{dist.is_initialized()}")
    ref = trainers["plain"].state.model.state_dict()
    ours = trainers["nccl"].state.model.state_dict()
    diff = max((ours[k] - v).abs().max().item() for k, v in ref.items())
    if diff != 0.0:
        raise RuntimeError(f"cli.train over NCCL at world size 1 differs from the same run "
                           f"without a group by {diff}")
    del trainers, ours, ref
    result = {"seconds": seconds["nccl"], "seconds_plain": seconds["plain"],
              "micro_steps": micro, "conv_gn_mish_launches": b1,
              "conv1d_weight_grad_launches": b2, "max_abs_diff_vs_plain_run": diff}

    meshlib.initialize_multihost(f"file://{tmp}/nccl_store_timing", 1, 0, device=dev)
    try:
        cfg = ExperimentConfig.load(str(USER_CONFIG)).override({
            "data.path": str(CARTWHEEL), "train.batch_size": TRAIN_B,
            "train.gradient_accumulate_every": ACCUM, "train.seed": args.seed})
        trainers = {"single": train_cli.build_trainer(cfg, device=dev),
                    "nccl": train_cli.build_trainer(cfg, device=dev, group=dist.group.WORLD)}
        for tr in trainers.values():
            tr.config = dataclasses.replace(tr.config, log_every=10 ** 9, best_window_frac=-1e6)
            window_ms(tr, 2)
        ms = {"single": [], "nccl": []}
        for name in ("single", "nccl", "nccl", "single"):
            ms[name].append(window_ms(trainers[name]))
        same = max((a - b).abs().max().item() for a, b in zip(
            trainers["single"].state.model.state_dict().values(),
            trainers["nccl"].state.model.state_dict().values()))
        if same != 0.0:
            raise RuntimeError(f"the trainer over NCCL at world size 1 differs from the one "
                               f"without a group by {same} after the same steps")
        # one optimizer step traced: its all_reduce ranges (one a micro-step) and kernels
        with profiling.trace(os.path.join(tmp, "nccl_trace"), dev) as prof:
            trainers["nccl"].train(num_steps=1)
        ranges = [e for e in prof.key_averages() if e.key == "all_reduce_grads"]
        if not ranges or ranges[0].count != ACCUM:
            raise RuntimeError(f"the trace holds {ranges[0].count if ranges else 0} "
                               f"all_reduce_grads ranges, expected {ACCUM}")
        # the gradient all_reduce itself (flatten, all_reduce, average, copy back), on the
        # stream by CUDA events and on the host clock
        grads = [p.grad for p in trainers["nccl"].state.model.parameters()
                 if p.grad is not None]
        reps = 20
        meshlib.all_reduce_mean(grads, dist.group.WORLD)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        for _ in range(reps):
            meshlib.all_reduce_mean(grads, dist.group.WORLD)
        events[1].record()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        result.update(backend=dist.get_backend(), ms_per_optimizer_step=ms,
                      max_abs_diff_nccl_vs_single=same,
                      gradient_floats=sum(g.numel() for g in grads),
                      all_reduce_ms_per_step=events[0].elapsed_time(events[1]) / reps * ACCUM,
                      all_reduce_host_ms_per_step=host_ms * ACCUM,
                      trace_bytes=os.path.getsize(os.path.join(tmp, "nccl_trace", "trace.json")))
    finally:
        dist.destroy_process_group()
    return result


def tp_inputs(cfg, seed, dev):
    g = torch.Generator().manual_seed(seed + 20)
    x = torch.randn(B_B, B_H, cfg.model.input_dim, generator=g)
    t = torch.randint(0, T, (B_B,), generator=g)
    y = torch.arange(B_B) % (cfg.model.num_classes + 1)
    mask = (torch.arange(B_H)[None, :] < torch.randint(B_H // 2, B_H + 1, (B_B, 1),
                                                       generator=g)).float()
    return [a.to(dev) for a in (x, t, y, mask)]


def parallel_worker(rank, world, seed):
    """One of phase 20's two gloo ranks on the one card: multihost_check at
    dim 128, rollout_sharded at N PHYS_N, and the tensor-parallel forward of
    the stack-B user config. -> numpy results."""
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    t0 = time.perf_counter()
    out["check"] = multihost_check.run_check(dim=DIM, device=dev)
    out["check"]["seconds"] = time.perf_counter() - t0

    clip = load_clip(str(WALK))
    env = PhysicsTrackingEnv(clip.qpos, clip.qvel, dt=1.0 / 30.0, substeps=SUBSTEPS,
                             fall_height=0.3, device=dev)
    state = env.reset(PHYS_N)
    launches = DK.rollout_cuda.launches
    t0 = time.perf_counter()
    final, rewards = env.rollout_sharded(meshlib.make_mesh(device_type="cuda"), state, PHYS_T)
    torch.cuda.synchronize()
    out["rollout"] = {"seconds": time.perf_counter() - t0,
                      "rollout_launches": DK.rollout_cuda.launches - launches,
                      "local_envs": PHYS_N // world, "rewards": rewards.cpu().numpy(),
                      **{k: v.cpu().numpy() for k, v in final._asdict().items()}}

    cfg = ExperimentConfig.load(str(B_CONFIG))
    model = seeded_model(cfg, seed, adaln_modulations).to(dev).eval()
    plan = tp.shard_params(model, meshlib.make_mesh(data=1, seq=world, device_type="cuda")["seq"])
    inputs = tp_inputs(cfg, seed, dev)
    with torch.no_grad():
        model(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = model(*inputs)
        torch.cuda.synchronize()
    out["tp"] = {"ms": (time.perf_counter() - t0) * 1e3, "plan": sorted(plan),
                 "out": y.cpu().numpy()}
    return out


def gloo_ranks(dev, args, tmp):
    """Phase 20's two ranks on the one card (gloo: NCCL refuses two ranks on
    one device), each part against this process alone."""
    ranks = spawn_ranks(parallel_worker, 2, os.path.join(tmp, "gloo_store"),
                        device="cuda", args=(args.seed,), timeout=PAR_TIMEOUT)
    result = {}
    one = multihost_check.run_check(dim=DIM, device=dev)
    checks = [r["check"] for r in ranks]
    rel = {k: abs(checks[0][k] - one[k]) / abs(one[k]) for k in ("loss", "param_checksum")}
    if (any(c[k] != checks[0][k] for c in checks for k in ("loss", "param_checksum"))
            or max(rel.values()) > PAR_CHECK_TOL or checks[0]["backend"] != "gloo"
            or checks[0]["conv_gn_mish_launches"] != one["conv_gn_mish_launches"]
            or checks[0]["conv1d_weight_grad_launches"] != one["conv1d_weight_grad_launches"]):
        raise RuntimeError(f"multihost_check: ranks {checks}, one process {one}")
    result["multihost_check"] = {"ranks": checks, "one_process": one, "rel_diff": rel}

    clip = load_clip(str(WALK))
    env = PhysicsTrackingEnv(clip.qpos, clip.qvel, dt=1.0 / 30.0, substeps=SUBSTEPS,
                             fall_height=0.3, device=dev)
    state = env.reset(PHYS_N)
    final, rewards = env.rollout(state, PHYS_T)
    r0, r1 = (r["rollout"] for r in ranks)
    same = all(np.array_equal(r0[k], r1[k]) for k in ("rewards", "qpos", "qvel", "done", "frame"))
    sharded = [torch.from_numpy(r0[k]) for k in ("qpos", "qvel", "rewards")]
    errs, ok = step_errors(sharded, [final.qpos.cpu(), final.qvel.cpu(), rewards.cpu()])
    done_same = np.array_equal(r0["done"], final.done.cpu().numpy())
    frames_same = np.array_equal(r0["frame"], final.frame.cpu().numpy())
    if not (same and ok and done_same and frames_same and r0["rollout_launches"] == 1):
        raise RuntimeError(f"rollout_sharded: ranks equal {same}, against rollout {errs} ok "
                           f"{ok}, done {done_same}, frames {frames_same}, B6 launches a rank "
                           f"{r0['rollout_launches']}")
    result["rollout_sharded"] = {
        "N": PHYS_N, "T": PHYS_T, "envs_per_rank": r0["local_envs"],
        "rollout_launches_per_rank": [r["rollout"]["rollout_launches"] for r in ranks],
        "seconds_per_rank": [r["rollout"]["seconds"] for r in ranks],
        "max_abs_err_vs_rollout": errs, "done": int(r0["done"].sum()),
        "plans": {"rank": dataclasses.asdict(DK.dynamics_plan(r0["local_envs"])),
                  "one_process": dataclasses.asdict(DK.dynamics_plan(PHYS_N))}}

    cfg = ExperimentConfig.load(str(B_CONFIG))
    model = seeded_model(cfg, args.seed, adaln_modulations).to(dev).eval()
    with torch.no_grad():
        ref = model(*tp_inputs(cfg, args.seed, dev)).cpu().numpy()
    outs = [r["tp"]["out"] for r in ranks]
    err = float(np.abs(outs[0] - ref).max() / np.abs(ref).max())
    if (not np.array_equal(outs[0], outs[1]) or not err <= B_FWD_TOL
            or len(ranks[0]["tp"]["plan"]) != 6 * cfg.model.num_layers):
        raise RuntimeError(f"the TP forward differs from one process by {err} (ranks equal "
                           f"{np.array_equal(outs[0], outs[1])}), plan {ranks[0]['tp']['plan']}")
    result["tp_forward"] = {"B": B_B, "H": B_H, "rel_err_vs_one_process": err,
                            "ms_per_rank": [r["tp"]["ms"] for r in ranks],
                            "split_layers": len(ranks[0]["tp"]["plan"])}
    return result


def prefetch_check(dev, batches=8):
    """``data.datasets.prefetch_to_device`` onto the card (pinned copies on
    its side stream, two batches ahead): the training batches of the
    cartwheel clip, each used on the current stream as it arrives, equal to
    the same batches copied directly."""
    ds = MotionDataset.from_path(str(CARTWHEEL), include_velocity=False, augment="cyclic",
                                 horizon_multiple=8)
    direct = ds.epochs(TRAIN_B, seed=0)
    fetched = prefetch_to_device(ds.epochs(TRAIN_B, seed=0), size=2, device=dev)
    t0 = time.perf_counter()
    worst = 0.0
    try:
        for _ in range(batches):
            got, want = next(fetched), next(direct)
            for a, b in ((got.trajectories, want.trajectories), (got.mask, want.mask),
                         (got.motion_class, want.motion_class)):
                if a.device.type != "cuda":
                    raise RuntimeError(f"prefetch gave a tensor on {a.device}")
                worst = max(worst, (a.double() - torch.from_numpy(b).to(a.device).double())
                            .abs().max().item())
    finally:
        fetched.close()
    torch.cuda.synchronize(dev)
    if worst != 0.0:
        raise RuntimeError(f"prefetched batches differ from the direct copies by {worst}")
    return {"batches": batches, "batch": TRAIN_B, "max_abs_diff": worst,
            "ms_per_batch": (time.perf_counter() - t0) * 1e3 / batches}


def scaling_run(tmp):
    """``cli.scaling --widths 1,2``: width 2 puts two ranks on the one card."""
    out = os.path.join(tmp, "scaling.json")
    with contextlib.redirect_stdout(io.StringIO()) as table:
        report = scaling_cli.main(["--widths", "1,2", "--steps", "5", "--json", out])
    if (report["measurement_valid"] or report["gate_evaluated"]
            or [report[w]["backend"] for w in ("1", "2")] != ["nccl", "gloo"]
            or not all(report[w]["steps_per_s"] > 0 for w in ("1", "2"))):
        raise RuntimeError(f"cli.scaling: {report}")
    return {**report, "table": table.getvalue().splitlines()}


def la_leftovers(dev, args):
    """The user config localattn5k_r3 with model.causal=true decoded frame by
    frame through the KV cache against its causal forward, and with
    model.use_global_attn=true one forward."""
    cfg = ExperimentConfig.load(str(LA_CONFIG))
    g = torch.Generator().manual_seed(args.seed + 21)
    result = {}
    causal = seeded_model(cfg.override({"model.causal": True}), args.seed,
                          hyper_connection_weights).to(dev).eval()
    x = torch.randn(LA_SMALL_B, LA_DECODE, cfg.model.input_dim, generator=g).to(dev)
    t = torch.randint(0, T, (LA_SMALL_B,), generator=g).to(dev)
    with torch.inference_mode():
        FA.fused_qkv_local_attention_cuda.launches = 0
        full = causal(x, t)
        b3 = FA.fused_qkv_local_attention_cuda.launches
        cache = causal.init_decode_cache(LA_SMALL_B)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LA_DECODE):
            out, cache = causal(x[:, i:i + 1], t, cache=cache, decode_pos=i)
            steps.append(out)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    err = (torch.cat(steps, dim=1) - full).abs().max().item()
    if not err <= LA_FORWARD_TOL:
        raise RuntimeError(f"the KV-cache decode differs from the causal forward by {err}")
    result["decode"] = {"B": LA_SMALL_B, "frames": LA_DECODE, "max_abs_err_vs_forward": err,
                        "ms_per_frame": seconds * 1e3 / LA_DECODE,
                        "causal_forward_b3_launches": b3}
    glob = seeded_model(cfg.override({"model.use_global_attn": True}), args.seed,
                        hyper_connection_weights).to(dev).eval()
    x = torch.randn(LA_B, LA_H, cfg.model.input_dim, generator=g).to(dev)
    t = torch.randint(0, T, (LA_B,), generator=g).to(dev)
    with torch.inference_mode():
        glob(x, t)
        FA.fused_qkv_local_attention_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = glob(x, t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    if y.shape != x.shape or not torch.isfinite(y).all():
        raise RuntimeError(f"the global-attention forward gave {tuple(y.shape)}, finite "
                           f"{bool(torch.isfinite(y).all())}")
    result["global_attn"] = {"B": LA_B, "H": LA_H, "ms": ms, "inserts": len(glob.global_layers),
                             "b3_launches": FA.fused_qkv_local_attention_cuda.launches}
    return result


def parallel_phase(dev, args, tmp, per_step):
    """Phase 20: the parallel layer on the card, with cuDNN's deterministic
    algorithms (``nccl_train``'s bit-equalities). It makes its own
    references and needs no earlier phase's files."""
    result = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, fn, a in (("nccl_train", nccl_train, (dev, args, tmp, per_step)),
                            ("gloo_ranks", gloo_ranks, (dev, args, tmp)),
                            ("prefetch", prefetch_check, (dev,)),
                            ("scaling", scaling_run, (tmp,)),
                            ("local_attention", la_leftovers, (dev, args))):
            t0 = time.perf_counter()
            result[name] = fn(*a)
            result[name]["part_seconds"] = time.perf_counter() - t0
            emit({"phase": "main_path", "path": f"parallel_{name}", **result[name]})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return result


def seq_unet(seed, dev, bf16=False):
    """The dim-128 serve-config U-Net from a seeded init (built at bf16 with
    ``bf16``: the same parameters), its schedule, and inputs for one forward."""
    torch.manual_seed(seed)
    model = TemporalUnet(D, dim=DIM, dtype=BF if bf16 else torch.float32).to(dev).eval()
    g = torch.Generator().manual_seed(seed + 33)
    x = torch.randn(SEQ_B, SEQ_H, D, generator=g).to(dev)
    t = torch.randint(0, T, (SEQ_B,), generator=g).to(dev)
    return model, make_schedule("cosine", T, convention="diffuser", device=dev), x, t


def seq_unet_chain(model, sched, seed, dev, x_sharding=None, prediction="x0", t_start=None):
    """The DDIM chain, by default from t 999 with the model's output read as
    x0. Read as epsilon there, the random-weight U-Net's first step divides
    it by sqrt(alpha_bar_999) (about 5e-5): float32 rounding of the forward
    (1e-6) then moves x0 by about 0.02 between any two implementations, and
    the chain to |x| ~ 1e5, where one float32 ulp exceeds SEQ_CHAIN_ATOL. So
    the epsilon chain starts at SEQ_EPS_T."""
    return sample_loop(sched, model, (SEQ_B, SEQ_H, D),
                       torch.Generator(device=dev).manual_seed(seed + 30), mode="ddim",
                       ddim_steps=SEQ_DDIM, prediction=prediction, t_start=t_start,
                       conditioning_fn=conditioning.holding_box(D, device=dev),
                       x_sharding=x_sharding).trajectories


def seq_la_model(seed, dev, bf16=False):
    """The localattn5k_r3 copy with max_seq_len SEQ_H (la_serve's long run),
    seeded (built at bf16 with ``bf16``), with its schedule and inputs for one
    forward."""
    cfg = ExperimentConfig.load(str(LA_CONFIG)).override({"model.max_seq_len": SEQ_H,
                                                          "model.bf16": bf16})
    model = seeded_model(cfg, seed, hyper_connection_weights).to(dev).eval()
    g = torch.Generator().manual_seed(seed + 31)
    x = torch.randn(SEQ_B, SEQ_H, cfg.model.input_dim, generator=g).to(dev)
    t = torch.randint(0, cfg.diffusion.noise_steps, (SEQ_B,), generator=g).to(dev)
    return model, factory.build_schedule(cfg.diffusion, dev), x, t


def seq_la_chain(model, sched, seed, dev, x_sharding=None):
    return sample_loop(sched, model, (SEQ_B, SEQ_H, model.input_dim),
                       torch.Generator(device=dev).manual_seed(seed + 32), mode="v4",
                       predict_epsilon=False, t_start=SEQ_LA_STEPS + 1,
                       conditioning_fn=conditioning.holding_box(model.input_dim, device=dev),
                       x_sharding=x_sharding).trajectories


SEQ_WRAPPERS = {"conv_gn_stats": CB.conv_gn_stats_cuda,
                "gn_affine_mish": CB.gn_affine_mish_cuda, "conv_gn_mish": CB.conv_gn_mish_cuda,
                "local_attention_halo": FA.local_attention_halo_cuda,
                "fused_qkv_local_attention": FA.fused_qkv_local_attention_cuda,
                "conv_gn_stats_bf16": CB.conv_gn_stats_bf16_cuda,
                "gn_affine_mish_bf16": CB.gn_affine_mish_bf16_cuda,
                "conv_gn_mish_bf16": CB.conv_gn_mish_bf16_cuda,
                "local_attention_halo_bf16": FA.local_attention_halo_bf16_cuda,
                "fused_qkv_local_attention_bf16": FA.fused_qkv_local_attention_bf16_cuda}


def seq_counts():
    return {name: fn.launches for name, fn in SEQ_WRAPPERS.items()}


def only(**launches):
    """seq_counts() as it must read when just ``launches`` happened."""
    return {name: launches.get(name, 0) for name in SEQ_WRAPPERS}


def counted(fn):
    """fn() with every count set to 0 just before and read just after:
    -> (result, host seconds ended by a sync, counts)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, seq_counts()


def seq_worker(rank, world, seed, device="cuda", bf16=False):
    """One of phase 21's (or, with ``bf16``, phase 24's) two gloo ranks on the
    one card, the horizon split SEQ_H / world frames a rank: the U-Net's
    DDIM chain (K1, K2), then the local transformer's forward and v4 chain
    (K3), each run once before the counted run; the models at bf16 with
    ``bf16``. -> numpy results."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shard = meshlib.seq_sharding(meshlib.make_mesh(data=1, seq=world, device_type=dev.type))
    out = {}
    unet, sched, x, t = seq_unet(seed, dev, bf16)
    xs = shard.shard(x).contiguous()

    def unet_forward():
        with torch.inference_mode(), seqlib.sharded(shard):
            return unet(xs, t)

    out["unet_forward"] = unet_forward().cpu().numpy()
    seq_unet_chain(unet, sched, seed, dev, shard)
    traj, seconds, n = counted(lambda: seq_unet_chain(unet, sched, seed, dev, shard))
    out["unet"] = {"seconds": seconds, "counts": n, "traj": traj.cpu().numpy()}
    if dev.type == "cuda":  # kernels of a sharded forward, device and wall ms of a step
        out["unet"]["profile"] = profile_rank(
            unet_forward, lambda: seq_unet_chain(unet, sched, seed, dev, shard), SEQ_DDIM,
            warm=False)
    if not bf16:
        out["unet_epsilon"] = seq_unet_chain(unet, sched, seed, dev, shard, "epsilon",
                                             SEQ_EPS_T).cpu().numpy()
    del unet
    model, la_sched, x, t = seq_la_model(seed, dev, bf16)
    xs = shard.shard(x).contiguous()

    def forward():
        with torch.inference_mode(), seqlib.sharded(shard):
            return model(xs, t)

    forward()
    y, seconds, n = counted(forward)
    out["la_forward"] = {"seconds": seconds, "counts": n, "out": y.cpu().numpy()}
    traj, seconds, n = counted(lambda: seq_la_chain(model, la_sched, seed, dev, shard))
    out["la_chain"] = {"seconds": seconds, "counts": n, "traj": traj.cpu().numpy()}
    return out


ADD_KINDS = ("none", "row", "full")  # K2's addend: none, the time term's row, the residual


def record_k2_kinds(model, x, t):
    """Counter of ((H, Cin, Cout), addend kind) over the conv blocks of one
    forward: a residual block's blocks[0] takes the time term's (B, C) row,
    its blocks[1] the residual's (B, H, C), every other block none."""
    kinds, seen, hooks = {}, Counter(), []
    for block in model.modules():
        if isinstance(block, temporal_unet.ResidualTemporalBlock):
            kinds[block.blocks[0]], kinds[block.blocks[1]] = "row", "full"
    for block in model.modules():
        if isinstance(block, temporal_unet.Conv1dBlock):
            hooks.append(block.register_forward_pre_hook(
                lambda m, a: seen.update([((a[0].shape[1], *m.weight.shape[1:]),
                                           kinds.get(m, "none"))])))
    try:
        with torch.inference_mode():
            model(x, t)
    finally:
        for h in hooks:
            h.remove()
    return seen


def k2_addend(kind, h, cout, g, dev, dtype=torch.float32):
    if kind == "none":
        return None
    shape = (SEQ_B, cout) if kind == "row" else (SEQ_B, h, cout)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def added(y, add):
    """The residual block's unfused add."""
    return y if add is None else y + (add[:, None, :] if add.dim() == 2 else add)


def k2_unfused(parts, count, pre, gamma, beta, add, dtype=torch.float32):
    """The chain K2 replaces, as one composition: chan_merge's float64 ops,
    the elementwise chain with ``F.mish``, the add."""
    cg = pre.shape[2] // GROUPS

    def run():
        merged = CB.chan_merge(parts, count, 1e-5)
        mean_c, rstd_c = (merged[..., i].repeat_interleave(cg, dim=1)[:, None, :] for i in (0, 1))
        return added(F.mish(torch.addcmul(beta, (pre - mean_c) * rstd_c, gamma)).to(dtype), add)

    return run


def k2_bound(elems, cout, kind, esize, peaks):
    """K2's bound: pre read (float32), the output and the addend (``esize``
    bytes a value), SEQ_RANKS ranks' statistics, gamma and beta; 11
    operations a value (normalise and affine 4; max, abs and add of the
    softplus, exp, log1p, tanh and the product) and one more for the add."""
    add_values = {"none": 0, "row": SEQ_B * cout, "full": elems}[kind]
    nbytes = 4.0 * (elems + 2 * cout + 2 * SEQ_RANKS * SEQ_B * GROUPS) + esize * (
        elems + add_values)
    return bound((11.0 + (kind != "none")) * elems, nbytes, peaks)


def seq_k1_k2_rows(dev, timer, peaks, shapes, kinds):
    """K1 and K2 against their plain versions at every (H, Cin, Cout) of a
    rank's sharded forward (``shapes``: Counter of launches a forward), K1 +
    K2 over one rank (zero halo rows) against B1, with the compositions. K2
    merges SEQ_RANKS ranks' statistics (this rank's and the zero-halo rows')
    and is checked with each addend at every shape, and timed with each
    addend the forward gives it there (``kinds``: record_k2_kinds)."""
    g = torch.Generator(device=dev).manual_seed(7)
    k1, k2 = [], []
    for (h, cin, cout), n in shapes.items():
        xh = torch.randn(SEQ_B, h + K - 1, cin, generator=g, device=dev)
        w = torch.randn(K, cin, cout, generator=g, device=dev) * (K * cin) ** -0.5
        b, gamma, beta = (m + 0.1 * torch.randn(cout, generator=g, device=dev)
                          for m in (0.0, 1.0, 0.0))
        pre, st = CB.conv_gn_stats_cuda(xh, w, b, GROUPS)
        pre_p, st_p = CB.conv_gn_stats_plain(xh, w, b, GROUPS)
        count = h * (cout // GROUPS)
        xz = xh.clone()  # one rank holding the whole horizon: zero halo rows, then B1
        xz[:, :K // 2] = 0
        xz[:, h + K // 2:] = 0
        pz, sz = CB.conv_gn_stats_cuda(xz, w, b, GROUPS)
        via = CB.gn_affine_mish_cuda(pz, sz[None], count, 1e-5, gamma, beta, GROUPS)
        b1 = CB.conv_gn_mish_cuda(xz[:, K // 2:h + K // 2].contiguous(), w, b, gamma, beta,
                                  GROUPS)
        parts = torch.stack([st, sz])
        adds = {kind: k2_addend(kind, h, cout, g, dev) for kind in ADD_KINDS}
        ys = {kind: CB.gn_affine_mish_cuda(pre, parts, count, 1e-5, gamma, beta, GROUPS, add=a)
              for kind, a in adds.items()}
        torch.cuda.synchronize()
        errs = {"pre": (pre - pre_p).abs().max().item(),
                "mean": (st[..., 0] - st_p[..., 0]).abs().max().item(),
                "m2_rel": ((st[..., 1] - st_p[..., 1]).abs()
                           / st_p[..., 1].abs().clamp_min(1e-30)).max().item(),
                **{f"k2_{kind}": (y - CB.gn_merge_mish_plain(pre, parts, count, 1e-5, gamma, beta,
                                                             GROUPS, add=adds[kind])
                                  ).abs().max().item() for kind, y in ys.items()},
                "k1_k2_vs_b1": (via - b1).abs().max().item()}
        epilogue = all(torch.equal(ys[kind], added(ys["none"], adds[kind])) for kind in ADD_KINDS)
        if not (max(v for k, v in errs.items() if k != "m2_rel") <= KERNEL_TOL and epilogue
                and errs["m2_rel"] <= SEQ_STATS_TOL
                and all(torch.isfinite(y).all() for y in ys.values())):
            raise RuntimeError(f"K1/K2 disagree at B {SEQ_B}, H {h}, {cin}->{cout}: {errs}; "
                               f"each addend equal to the bare launch + the add: {epilogue}")
        xc, wc = xh.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()

        def k1_comp():
            o = F.conv1d(xc, wc, b)
            return o, torch.var_mean(o.view(SEQ_B, GROUPS, -1), dim=-1, correction=0)

        flops = 2.0 * SEQ_B * h * cout * K * cin
        nbytes = 4.0 * (SEQ_B * (h + K - 1) * cin + K * cin * cout + cout + SEQ_B * h * cout
                        + 2 * SEQ_B * GROUPS)
        row = {"B": SEQ_B, "H": h, "cin": cin, "cout": cout, "per_forward": n,
               "plan": b1_plan(xh[:, :h], w, stats=True), "max_abs_err": errs["pre"],
               "errors": errs,
               "ms": timer(lambda: CB.conv_gn_stats_cuda(xh, w, b, GROUPS)),
               "plain_ms": timer(lambda: CB.conv_gn_stats_plain(xh, w, b, GROUPS)),
               "composition_ms": timer(k1_comp)}
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, peaks)
        k1.append(row)
        emit({"phase": "kernel", "name": "conv_gn_stats", **row})
        for kind in ADD_KINDS:
            if not kinds[((h, cin, cout), kind)]:
                continue
            a = adds[kind]
            row = {"B": SEQ_B, "H": h, "C": cout, "R": SEQ_RANKS, "add": kind,
                   "per_forward": kinds[((h, cin, cout), kind)], "max_abs_err": errs[f"k2_{kind}"],
                   "ms": timer(lambda: CB.gn_affine_mish_cuda(pre, parts, count, 1e-5, gamma, beta,
                                                              GROUPS, add=a)),
                   "plain_ms": timer(lambda: CB.gn_merge_mish_plain(pre, parts, count, 1e-5, gamma,
                                                                    beta, GROUPS, add=a)),
                   "unfused_ms": timer(k2_unfused(parts, count, pre, gamma, beta, a))}
            row["bound_ms"], row["bound_by"] = k2_bound(SEQ_B * h * cout, cout, kind, 4, peaks)
            k2.append(row)
            emit({"phase": "kernel", "name": "gn_affine_mish", **row})
    return k1, k2


def split_profile(ranks):
    """Each rank's profile_rank numbers, by key: the kernels (and copies) of
    one sharded forward, its device ms, a DDIM step's device and wall ms."""
    keys = ranks[0]["unet"]["profile"]
    return {f"{k}_per_rank": [r["unet"]["profile"][k] for r in ranks] for k in keys}


def seq_k3_rows(dev, timer, peaks, mcfg):
    """K3 against its plain version at both ranks' slabs of the split (rank
    0: no rows before; rank 1: none after), with the composition: rotary at
    the global positions, then one SDPA with the band mask."""
    h, dh, w, causal = mcfg.n_heads, mcfg.dim_head, mcfg.window_size, mcfg.causal
    lf = 0 if causal else 1
    n = SEQ_H // SEQ_RANKS
    g = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for rank in range(SEQ_RANKS):
        q0 = w if rank > 0 else 0
        Nh = q0 + n + (lf * w if rank < SEQ_RANKS - 1 else 0)
        pos0 = rank * n - q0
        qkv = torch.randn(SEQ_B, Nh, 3 * h * dh, generator=g, device=dev)
        args = (qkv, h, dh, w, q0, n, pos0, causal, True, True, None)
        out = FA.local_attention_halo_cuda(*args)
        ref = FA.local_attention_halo_plain(*args)
        ti, tj = np.arange(q0, q0 + n)[:, None], np.arange(Nh)[None, :]
        ok = ~FA.window_mask(ti, tj, w, 1, lf, causal, True, False)
        x = qkv.view(SEQ_B, Nh, 3, h, dh).permute(2, 0, 3, 1, 4)
        q_tab = rotary_tables(pos0 + np.arange(q0, q0 + n) + lf * w, dh, dev)
        k_tab = rotary_tables(pos0 + np.arange(Nh), dh, dev)
        mask = torch.from_numpy(ok).to(dev)

        def comp():
            o = F.scaled_dot_product_attention(rotate(x[0][:, :, q0:q0 + n], q_tab),
                                               rotate(x[1], k_tab), x[2], attn_mask=mask)
            return o.transpose(1, 2).reshape(SEQ_B, n, h * dh)

        torch.cuda.synchronize()
        err, comp_err = (out - ref).abs().max().item(), (comp() - ref).abs().max().item()
        if not (err <= ATTN_TOL and comp_err <= COMP_TOL and torch.isfinite(out).all()):
            raise RuntimeError(f"local_attention_halo disagrees at rank {rank}'s slab: kernel "
                               f"{err}, composition {comp_err}")
        pairs = int(ok.sum()) * SEQ_B
        flops = h * 4.0 * dh * pairs + 6.0 * SEQ_B * (n + Nh) * h * dh
        row = {"rank": rank, "B": SEQ_B, "Nh": Nh, "q0": q0, "Nq": n, "pos0": pos0,
               "plan": dataclasses.asdict(FA.halo_plan(SEQ_B, h, dh, w, q0, n, Nh, causal, True)),
               "max_abs_err": err, "composition_max_abs_err": comp_err,
               "ms": timer(lambda: FA.local_attention_halo_cuda(*args)),
               "plain_ms": timer(lambda: FA.local_attention_halo_plain(*args)),
               "composition_ms": timer(comp), "pairs_per_head": pairs}
        # bytes: Q of the rank's n rows, K and V of the slab's Nh, the n output rows
        row["bound_ms"], row["bound_by"] = bound(flops, 4.0 * SEQ_B * h * dh * (2 * Nh + 2 * n),
                                                 peaks)
        rows.append(row)
        emit({"phase": "kernel", "name": "local_attention_halo", **row})
    return rows


def seq_phase(dev, timer, args, tmp, peaks):
    """Phase 21: the kernels of the horizon split at its shapes, then the
    two gloo ranks' chains and forward against this process alone (B1, B3).
    It makes its own references and needs no earlier phase's files."""
    la_cfg = ExperimentConfig.load(str(LA_CONFIG))
    probe = TemporalUnet(D, dim=DIM).to(dev).eval()
    x = torch.zeros(SEQ_B, SEQ_H // SEQ_RANKS, D, device=dev)
    shapes = Counter(record_block_shapes(probe, x, torch.zeros(SEQ_B, device=dev)))
    kinds = record_k2_kinds(probe, x, torch.zeros(SEQ_B, device=dev))
    del probe
    k1, k2 = seq_k1_k2_rows(dev, timer, peaks, shapes, kinds)
    k3 = seq_k3_rows(dev, timer, peaks, la_cfg.model)

    t0 = time.perf_counter()
    ranks = spawn_ranks(seq_worker, SEQ_RANKS, os.path.join(tmp, "seq_store"), device=dev.type,
                        args=(args.seed, dev.type), timeout=SEQ_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    per_forward = sum(shapes.values())  # 33
    result = {"ranks": SEQ_RANKS, "ranks_seconds": ranks_s,
              "note": "gloo on one card, not scaling"}

    unet, sched, x, t = seq_unet(args.seed, dev)
    with torch.inference_mode():
        unet_fwd = unet(x, t).cpu().numpy()
    fwd_err = float(np.abs(np.concatenate([r["unet_forward"] for r in ranks], axis=1)
                           - unet_fwd).max())
    seq_unet_chain(unet, sched, args.seed, dev)
    one, one_s, one_n = counted(lambda: seq_unet_chain(unet, sched, args.seed, dev))
    eps_ref = seq_unet_chain(unet, sched, args.seed, dev, None, "epsilon", SEQ_EPS_T).cpu().numpy()
    del unet
    eps_got = np.concatenate([r["unet_epsilon"] for r in ranks], axis=1)
    eps_close = np.allclose(eps_got, eps_ref, rtol=SEQ_CHAIN_RTOL, atol=SEQ_CHAIN_ATOL)
    eps_box = (np.abs(eps_got[:, :, BOX_ZERO]).max(),
               np.abs(eps_got[:, :, BOX_ELBOW] - np.float32(1.57)).max())
    got = np.concatenate([r["unet"]["traj"] for r in ranks], axis=1)
    ref = one.cpu().numpy()
    counts = [r["unet"]["counts"] for r in ranks]
    want = only(conv_gn_stats=per_forward * SEQ_DDIM, gn_affine_mish=per_forward * SEQ_DDIM)
    box = np.abs(got[:, :, BOX_ZERO]).max(), np.abs(got[:, :, BOX_ELBOW] - np.float32(1.57)).max()
    close = np.allclose(got, ref, rtol=SEQ_CHAIN_RTOL, atol=SEQ_CHAIN_ATOL)
    if not (fwd_err <= FORWARD_TOL and close and np.isfinite(got).all() and max(box) == 0.0
            and eps_close and np.isfinite(eps_got).all() and max(eps_box) == 0.0
            and all(c == want for c in counts) and one_n["conv_gn_mish"] == per_forward * SEQ_DDIM):
        raise RuntimeError(f"the sharded U-Net: forward off by {fwd_err}; chain allclose {close} "
                           f"(max |diff| {np.abs(got - ref).max()}, max |x| {np.abs(ref).max()}), "
                           f"clamped dims off by {box}; epsilon chain allclose {eps_close} (max "
                           f"|diff| {np.abs(eps_got - eps_ref).max()}), clamped dims off by "
                           f"{eps_box}; counts {counts} (expected {want}), one process {one_n}")
    result["unet_ddim"] = {
        "B": SEQ_B, "H": SEQ_H, "steps": SEQ_DDIM, "counts_per_rank": counts,
        "forward_max_abs_err": fwd_err,
        "one_process_counts": one_n, **split_profile(ranks),
        "max_abs_diff": float(np.abs(got - ref).max()), "max_abs": float(np.abs(ref).max()),
        "epsilon_chain": {"t_start": SEQ_EPS_T, "steps": SEQ_DDIM,
                          "max_abs_diff": float(np.abs(eps_got - eps_ref).max()),
                          "max_abs": float(np.abs(eps_ref).max())},
        "ms_per_step_sharded": [r["unet"]["seconds"] * 1e3 / SEQ_DDIM for r in ranks],
        "ms_per_step_one_process": one_s * 1e3 / SEQ_DDIM}
    emit({"phase": "main_path", "path": "seq_unet", **result["unet_ddim"]})

    model, la_sched, x, t = seq_la_model(args.seed, dev)
    depth = model.depth
    with torch.inference_mode():
        model(x, t)
        y, fwd_s, fwd_n = counted(lambda: model(x, t))
    got = np.concatenate([r["la_forward"]["out"] for r in ranks], axis=1)
    fwd_err = float(np.abs(got - y.cpu().numpy()).max())
    traj, chain_s, chain_n = counted(lambda: seq_la_chain(model, la_sched, args.seed, dev))
    got_chain = np.concatenate([r["la_chain"]["traj"] for r in ranks], axis=1)
    ref = traj.cpu().numpy()
    close = np.allclose(got_chain, ref, rtol=SEQ_CHAIN_RTOL, atol=SEQ_CHAIN_ATOL)
    fwd_counts = [r["la_forward"]["counts"] for r in ranks]
    chain_counts = [r["la_chain"]["counts"] for r in ranks]

    if not (fwd_err <= SEQ_LA_TOL and close and np.isfinite(got_chain).all()
            and all(c == only(local_attention_halo=depth) for c in fwd_counts)
            and all(c == only(local_attention_halo=depth * SEQ_LA_STEPS) for c in chain_counts)
            and fwd_n["fused_qkv_local_attention"] == depth):
        raise RuntimeError(f"the sharded local transformer: forward off by {fwd_err}, chain "
                           f"allclose {close}, counts {fwd_counts} / {chain_counts}")
    result["local_attention"] = {
        "B": SEQ_B, "H": SEQ_H, "depth": depth, "forward_max_abs_err": fwd_err,
        "forward_counts_per_rank": fwd_counts, "chain_counts_per_rank": chain_counts,
        "chain_steps": SEQ_LA_STEPS, "chain_max_abs_diff": float(np.abs(got_chain - ref).max()),
        "forward_ms_sharded": [r["la_forward"]["seconds"] * 1e3 for r in ranks],
        "forward_ms_one_process": fwd_s * 1e3,
        "ms_per_step_sharded": [r["la_chain"]["seconds"] * 1e3 / SEQ_LA_STEPS for r in ranks],
        "ms_per_step_one_process": chain_s * 1e3 / SEQ_LA_STEPS}
    emit({"phase": "main_path", "path": "seq_local_attention", **result["local_attention"]})
    result.update(k1_rows=k1, k2_rows=k2, k3_rows=k3, per_forward=per_forward)
    return result


# ---------------------------------------------------------------------------
# Phase 22: bf16 serving (B1's and B3's bf16 forms; the four denoisers at bf16)


def bf16_ulps(out, ref):
    """Per element, how many bf16 values lie between out and ref (both bf16)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(out) - ordered(ref)).abs()


def bf16_agreement(name, out, ref, where):
    """A bf16 kernel's output against its plain version's: within one bf16
    ulp of the value plus BF16_TOL, else raise. -> the error in absolute
    terms and in bf16 ulps (all values; and the values of at least 2^-7 of
    max |ref|, whose ulp float32 sums in another order cannot reach)."""
    if out.dtype != BF or ref.dtype != BF or not torch.isfinite(out).all():
        raise RuntimeError(f"{name} at {where}: dtypes {out.dtype}, {ref.dtype} or not finite")
    d = (out.float() - ref.float()).abs()
    beyond = int((d > 2.0 ** -7 * ref.float().abs() + BF16_TOL).sum())
    if beyond:
        raise RuntimeError(f"{name} at {where}: {beyond} values beyond one bf16 ulp + "
                           f"{BF16_TOL} of the plain version (max abs err {d.max().item()})")
    ulps = bf16_ulps(out, ref)
    large = ref.float().abs() >= 2.0 ** -7 * ref.float().abs().max()
    return {"max_abs_err": d.max().item(), "max_ulps": int(ulps.max()),
            "max_ulps_large_values": int(ulps[large].max()),
            "bit_equal_share": float((ulps == 0).float().mean())}


def bf16_b1_rows(dev, timer, shape_counts, peaks, batch=B):
    """B1's bf16 kernel against its plain version at every shape of
    ``shape_counts`` (Counter of (H, Cin, Cout) launches a forward) at
    ``batch``: the dim-128 serve forward (B 16 x H 64), a bf16 training
    micro-step's forward (B 32 x H 160), the ValueFunction's (B 16 x H 64).
    Each timed beside B1's float32 kernel on the same values in float32, the
    plain version and the bf16 composition (``F.conv1d`` + ``group_norm`` +
    ``mish``), with the shape's plan; the bound: the bf16 operations at
    BF16_FLOPS or the bytes (bf16 activations and weights, float32 bias,
    scale and shift)."""
    g = torch.Generator(device=dev).manual_seed(22)
    rows = []
    for (h, cin, cout), n in shape_counts.items():
        x = torch.randn(batch, h, cin, generator=g, device=dev).to(BF)
        w = (torch.randn(K, cin, cout, generator=g, device=dev) * (K * cin) ** -0.5).to(BF)
        b = 0.1 * torch.randn(cout, generator=g, device=dev)
        gamma = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
        beta = 0.1 * torch.randn(cout, generator=g, device=dev)
        args = (x, w, b, gamma, beta, GROUPS)
        out = CB.conv_gn_mish_bf16_cuda(*args)
        ref = CB.conv_gn_mish_plain(*args)
        torch.cuda.synchronize()
        err = bf16_agreement("conv_gn_mish_bf16", out, ref, f"B {batch}, H {h}, {cin}->{cout}")
        if not torch.equal(out, CB.conv_gn_mish_bf16_cuda(*args)):
            raise RuntimeError(f"conv_gn_mish_bf16 at B {batch}, H {h}, {cin}->{cout}: two "
                               "launches differ")
        args32 = (x.float(), w.float(), b, gamma, beta, GROUPS)
        xc, wc = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        b16, g16, be16 = b.to(BF), gamma.to(BF), beta.to(BF)
        flops = 2.0 * batch * h * cout * K * cin
        nbytes = 2.0 * (batch * h * (cin + cout) + K * cin * cout) + 4.0 * 3 * cout
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / peaks[1] * 1e3
        plan = CB.bf16_plan(batch, h, cin, cout, K, GROUPS)
        rows.append({
            "B": batch, "H": h, "cin": cin, "cout": cout, "per_forward": n,
            "plan": {**plan.fields(), "ctas": plan.grid, "smem_bytes": plan.smem_bytes},
            **err,
            "ms": timer(lambda: CB.conv_gn_mish_bf16_cuda(*args)),
            "f32_kernel_ms": timer(lambda: CB.conv_gn_mish_cuda(*args32)),
            "plain_ms": timer(lambda: CB.conv_gn_mish_plain(*args)),
            "composition_ms": timer(lambda: F.mish(F.group_norm(
                F.conv1d(xc, wc, b16, padding=K // 2), GROUPS, g16, be16))),
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "tflops": None})
        rows[-1]["tflops"] = flops / rows[-1]["ms"] / 1e9
        emit({"phase": "kernel", "name": "conv_gn_mish_bf16", **rows[-1]})
    return rows


def bf16_b3_row(dev, timer, peaks, mcfg):
    """B3's bf16 entry against its plain version at the served shape (B 16 x
    H 128), timed beside B3's float32 entry on the same values in float32,
    the plain version and the bf16 composition (rotary + one SDPA with the
    band mask); the bound: bytes (bf16 qkv read, bf16 context written)."""
    h, dh, w, causal = mcfg.n_heads, mcfg.dim_head, mcfg.window_size, mcfg.causal
    lf = 0 if causal else 1
    g = torch.Generator(device=dev).manual_seed(23)
    p = FA.plan(LA_H, w, causal)
    Np = p["Np"]
    qkv = torch.randn(LA_B, LA_H, 3 * h * dh, generator=g, device=dev).to(BF)
    args = (qkv, h, dh, w, causal, True, True)
    out = FA.fused_qkv_local_attention_bf16_cuda(*args)
    ref = FA.fused_qkv_local_attention_plain(*args)
    torch.cuda.synchronize()
    err = bf16_agreement("fused_qkv_local_attention (bf16)", out, ref, f"B {LA_B}, N {LA_H}")
    args32 = (qkv.float(),) + args[1:]
    tables = tuple(tuple(t.to(BF) for t in rotary_tables(pos, dh, dev))
                   for pos in (np.arange(Np) + lf * w, np.arange(Np)))
    mask = band_mask(Np, w, causal, dev)
    pairs, empty = attention_work(LA_H, Np, w, causal, [Np] * LA_B)
    flops = h * 4.0 * dh * pairs + 6.0 * LA_B * LA_H * h * dh
    nbytes = 2.0 * 4 * LA_B * LA_H * h * dh
    bound_ms, bound_by = bound(flops, nbytes, peaks)
    row = {"B": LA_B, "N": LA_H, "heads": h, "dim_head": dh, "window": w, **err,
           "plan": attention_plan_row(Np, p["C"], p["P"], w, causal, dh, LA_B * h, elem=2),
           "f32_plan": attention_plan_row(Np, p["C"], p["P"], w, causal, dh, LA_B * h),
           "ms": timer(lambda: FA.fused_qkv_local_attention_bf16_cuda(*args)),
           "f32_kernel_ms": timer(lambda: FA.fused_qkv_local_attention_cuda(*args32)),
           "plain_ms": timer(lambda: FA.fused_qkv_local_attention_plain(*args)),
           "composition_ms": timer(lambda: b3_composition(qkv, h, dh, w, tables, mask)),
           "bound_ms": bound_ms, "bound_by": bound_by, "mbytes": nbytes / 1e6}
    emit({"phase": "kernel", "name": "fused_qkv_local_attention_bf16", **row})
    return row


B1_BF16 = "conv_block_kernel.conv_gn_mish_bf16_cuda"
B1_F32 = "conv_block_kernel.conv_gn_mish_cuda"
B3_BF16 = "fused_local_attention.fused_qkv_local_attention_bf16_cuda"
B3_F32 = "fused_local_attention.fused_qkv_local_attention_cuda"


def bf16_requests(tmp, name, run32, num, frames, forwards, expect, extra=()):
    """The same request through the float32 run and its bf16 copy, same
    seed: the kernels each launches (``expect``: {count name: launches a
    forward} at bf16; the float32 request launches the float32 forms as
    often), seconds, and the served motions' distance."""
    run16 = run_copy(run32, run32 + "_bf16", {"model.bf16": True})
    out = {}
    motions = {}
    for label, run in (("float32", run32), ("bf16", run16)):
        paths, seconds, _ = request(run, os.path.join(tmp, f"bf16_req_{name}_{label}"), frames,
                                    num, extra=extra)
        launched = kernel_counts()
        motions[label] = np.stack([np.load(q) for q in paths])
        want = {k: v * forwards for k, v in expect.items()} if label == "bf16" else {
            {B1_BF16: B1_F32, B3_BF16: B3_F32}[k]: v * forwards for k, v in expect.items()}
        for key in (B1_BF16, B1_F32, B3_BF16, B3_F32):
            if launched[key] != want.get(key, 0):
                raise RuntimeError(f"the {label} {name} request launched {key} "
                                   f"{launched[key]} times, expected {want.get(key, 0)}")
        out[label] = {"seconds": seconds, "samples_per_s": num / seconds,
                      "launches": {k: launched[k] for k in (B1_BF16, B1_F32, B3_BF16, B3_F32)}}
    ref = motions["float32"]
    out.update(num=num, frames=frames, forwards=forwards,
               motions_max_abs_diff=float(np.abs(motions["bf16"] - ref).max()),
               motions_rel_diff=float(np.abs(motions["bf16"] - ref).max() / np.abs(ref).max()))
    emit({"phase": "main_path", "path": f"bf16_{name}", **out})
    return out, run16


def bf16_forwards(runs, dev, make_inputs, n=10):
    """One forward of the float32 model and of its bf16 build on the same
    inputs, their relative distance, and for each: the device ms a forward
    (torch.profiler: every kernel's time, summed over n forwards / n), the
    wall ms a forward (host clock over n, then a sync) and the kernels a
    forward launches. (CUDA events around a queue of hundreds of small
    kernels time the host: the launch queue fills.)"""
    m32, _ = load_model(runs[0], dev)
    m16, sched = load_model(runs[1], dev)
    inputs = make_inputs(sched)
    row = {}
    with torch.inference_mode():
        o32, o16 = m32(*inputs), m16(*inputs)
        if o16.dtype != torch.float32 or not torch.isfinite(o16).all():
            raise RuntimeError(f"bf16 forward: {o16.dtype}, finite "
                               f"{bool(torch.isfinite(o16).all())}")
        row["rel_diff"] = ((o16 - o32).abs().max() / o32.abs().max()).item()
        for label, m in (("f32", m32), ("bf16", m16)):
            def fwds(m=m):
                for _ in range(n):
                    m(*inputs)
                torch.cuda.synchronize()

            fwds()
            t0 = time.perf_counter()
            fwds()
            row[f"{label}_wall_ms"] = (time.perf_counter() - t0) * 1e3 / n
            row[f"{label}_device_ms"], top, _ = device_time_by_kernel(fwds, n)
            row[f"{label}_top_kernels"] = top[:4]
            with counted_launches() as launches:
                m(*inputs)
            row[f"{label}_kernels"] = launches[0]
    return row, m32, m16, sched


@contextlib.contextmanager
def counted_launches():
    """The device kernels launched inside the block (torch.profiler): -> a
    one-element list, filled when the block ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = [0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    out[0] = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def bf16_ddim(models, sched, shape, seed, dev, **kw):
    """A DDIM-50 chain of the float32 and the bf16 model from one seed:
    seconds each and the trajectories' relative distance."""
    cond = conditioning.holding_box(shape[-1], device=dev)
    out = {}
    for label, m in zip(("float32", "bf16"), models):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            x = sample_loop(sched, m, shape, torch.Generator(device=dev).manual_seed(seed),
                            mode="ddim", ddim_steps=BF16_DDIM, conditioning_fn=cond,
                            **kw).trajectories
        torch.cuda.synchronize()
        out[label] = {"seconds": time.perf_counter() - t0, "x": x,
                      "launches": {k: v for k, v in kernel_counts().items() if v}}
    if not torch.isfinite(out["bf16"]["x"]).all():
        raise RuntimeError("bf16 DDIM chain not finite")
    ref = out["float32"].pop("x")
    rel = ((out["bf16"].pop("x") - ref).abs().max() / ref.abs().max()).item()
    return {**out, "steps": BF16_DDIM, "trajectories_rel_diff": rel}


def bf16_source(run):
    """A copy of the run whose chains are cut to BF16_SHORT_T, the float32
    side of phase 22's requests."""
    return run_copy(run, run + "_bf16src", {"diffusion.noise_steps": BF16_SHORT_T})


def bf16_phase(dev, timer, args, tmp, peaks, la_cfg, b_run=None):
    """Phase 22: B1's and B3's bf16 forms against their plain versions at the
    serve shapes, timed beside the float32 kernels; then each denoiser
    served through ``cli.sample.main`` from a float32 run and its bf16 copy
    (same checkpoint, same seed), each cut to T BF16_SHORT_T: the dim-128
    U-Net (the train phase's run, B 16 x H 64) and localattn5k_r3 (v4, B 16 x
    H 128), each with a T 1000 DDIM-50 chain beside it, and the MDM
    transformer (the b_serve run, CFG on class 0) and the decoder (the dec
    run); counts set to 0 just before each request and read just after it.
    It makes the runs it finds missing (seeded random weights)."""
    probe = TemporalUnet(D, dim=DIM).to(dev).eval()
    shape_counts = Counter(record_block_shapes(probe, torch.zeros(B, H, D, device=dev),
                                               torch.zeros(B, device=dev)))
    del probe
    per_fwd = sum(shape_counts.values())
    b1 = bf16_b1_rows(dev, timer, shape_counts, peaks)
    b3 = bf16_b3_row(dev, timer, peaks, la_cfg.model)

    unet_run = os.path.join(tmp, "train_run")
    if not os.path.exists(unet_run):
        unet_run = os.path.join(tmp, "bf16_unet_run")
        write_run(unet_run, args.seed)
    unet_req, _ = bf16_requests(tmp, "unet", bf16_source(unet_run), B, H, BF16_SHORT_T,
                                {B1_BF16: per_fwd})
    unet16 = run_copy(unet_run, unet_run + "_bf16", {"model.bf16": True})
    g = torch.Generator(device=dev).manual_seed(args.seed + 22)
    unet_fwd, m32, m16, sched = bf16_forwards((unet_run, unet16), dev, lambda s: (
        torch.randn(B, H, D, generator=g, device=dev),
        torch.randint(0, s.num_timesteps, (B,), generator=g, device=dev)))
    unet_fwd["ddim"] = bf16_ddim((m32, m16), sched, (B, H, D), args.seed, dev)
    if unet_fwd["ddim"]["bf16"]["launches"] != {B1_BF16: per_fwd * BF16_DDIM}:
        raise RuntimeError(f"bf16 U-Net DDIM chain launched {unet_fwd['ddim']['bf16']['launches']}")
    emit({"phase": "chains", "path": "bf16_unet", **unet_fwd})
    del m32, m16

    la_run = os.path.join(tmp, "la_run")
    if not os.path.exists(la_run):
        write_model_run(la_run, la_cfg, args.seed, hyper_connection_weights)
    depth, d_la = la_cfg.model.depth, la_cfg.model.input_dim
    # v4 runs the model at t = T-1 .. 1
    la_req, _ = bf16_requests(tmp, "la", bf16_source(la_run), LA_B, LA_H, BF16_SHORT_T - 1,
                              {B3_BF16: depth})
    la16 = run_copy(la_run, la_run + "_bf16", {"model.bf16": True})
    la_fwd, m32, m16, sched = bf16_forwards((la_run, la16), dev, lambda s: (
        torch.randn(LA_B, LA_H, d_la, generator=g, device=dev),
        torch.randint(0, s.num_timesteps, (LA_B,), generator=g, device=dev)))
    la_fwd["ddim"] = bf16_ddim((m32, m16), sched, (LA_B, LA_H, d_la), args.seed, dev,
                               predict_epsilon=False)
    if la_fwd["ddim"]["bf16"]["launches"] != {B3_BF16: depth * BF16_DDIM}:
        raise RuntimeError(f"bf16 local DDIM chain launched {la_fwd['ddim']['bf16']['launches']}")
    emit({"phase": "chains", "path": "bf16_la", **la_fwd})
    del m32, m16

    others = {}
    if b_run is None:
        b_run = os.path.join(tmp, "b_run")
        write_model_run(b_run, ExperimentConfig.load(str(B_CONFIG)), args.seed,
                        adaln_modulations)
    dec_run = os.path.join(tmp, "dec")
    if not os.path.exists(dec_run):
        dec_run = os.path.join(tmp, "bf16_dec_run")
        write_model_run(dec_run, ExperimentConfig.load(str(DEC_CONFIG)), args.seed,
                        lambda name: False)
    for name, run, frames, extra, batch in (("mdm", b_run, B_H, ["--class-id", "0"], 2 * B_B),
                                            ("dec", dec_run, DEC_H, [], B)):
        short = bf16_source(run)
        cfg = ExperimentConfig.load(os.path.join(short, "config.json"))
        req, short16 = bf16_requests(tmp, name, short, B_B if name == "mdm" else B, frames,
                                     BF16_SHORT_T - 1, {}, extra)
        c = cfg.model
        req["forward"] = bf16_forwards((short, short16), dev, lambda s, c=c: (
            (torch.randn(batch, frames, c.input_dim, generator=g, device=dev),
             torch.randint(0, s.num_timesteps, (batch,), generator=g, device=dev))
            + ((torch.arange(batch, device=dev) % c.num_classes,) if name == "mdm" else ())))[0]
        others[name] = req
    emit({"phase": "chains", "path": "bf16_mdm_dec",
          **{k: v["forward"] for k, v in others.items()}})
    return {"b1_rows": b1, "b3_row": b3, "per_forward": per_fwd,
            "unet": {"request": unet_req, **unet_fwd}, "la": {"request": la_req, **la_fwd},
            **others}


# ---------------------------------------------------------------------------
# Phase 23: bf16 training (B1's bf16 backward, B2's bf16 form, B3's bf16 entry with the keep
# mask; cli.train on bf16 configs)

B2_BF16 = "conv_weight_grad.conv1d_weight_grad_bf16_cuda"
B2_F32 = "conv_weight_grad.conv1d_weight_grad_cuda"


def bf16_b2_rows(dev, timer, per_step, peaks, batch, where):
    """B2's bf16 form (``csrc/conv1d_weight_grad_bf16.cu``) against its plain
    version at every (H, Cin, Cout) of ``per_step`` (Counter of launches a
    step; ``where`` names the step) at ``batch``, with bf16 x and dy: within
    WGRAD_TOL of max |dW|, and where the plan splits the rows over a cluster
    a second launch gives the same bits. Timed beside the plain version,
    cuDNN's bf16 weight gradient (``torch.nn.grad.conv1d_weight`` on
    channel-first copies made outside the timed call; it rounds dW to bf16)
    and the float32 kernel on the float32 widenings; the bound: the
    operations at BF16_FLOPS or the bytes (bf16 x and dy read, float32 dW
    written), whichever is larger."""
    rows = []
    g = torch.Generator(device=dev).manual_seed(24)
    for (h, cin, cout), n in per_step.items():
        x = torch.randn(batch, h, cin, generator=g, device=dev).to(BF)
        dy = torch.randn(batch, h, cout, generator=g, device=dev).to(BF)
        plan = CW.wgrad_bf16_plan(batch, h, cin, cout, K, CW.sm_count(x.device))
        out = CW.conv1d_weight_grad_bf16_cuda(x, dy, K)
        ref = CW.conv1d_weight_grad_plain(x, dy, K)
        xc, dyc = x.transpose(1, 2).contiguous(), dy.transpose(1, 2).contiguous()
        x32, dy32 = x.float(), dy.float()

        def library():
            return torch.nn.grad.conv1d_weight(xc, (cout, cin, K), dyc, padding=K // 2)

        lib = library().permute(2, 1, 0).float()
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        if not (err <= WGRAD_TOL * scale and torch.isfinite(out).all()):
            raise RuntimeError(f"conv1d_weight_grad_bf16 disagrees at B {batch}, H {h}, "
                               f"{cin}->{cout}: max abs err {err}, max |dW| {scale}")
        identical = None
        if plan.cluster > 1:
            identical = torch.equal(out, CW.conv1d_weight_grad_bf16_cuda(x, dy, K))
            if not identical:
                raise RuntimeError(f"conv1d_weight_grad_bf16 at B {batch}, H {h}, {cin}->{cout}"
                                   f" (cluster {plan.cluster}): two launches differ")
        flops = 2.0 * K * cin * cout * batch * h
        nbytes = 2.0 * batch * h * (cin + cout) + 4.0 * K * cin * cout
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / peaks[1] * 1e3
        rows.append({
            "B": batch, "H": h, "cin": cin, "cout": cout, "step": where, "per_step": n,
            "plan": {**plan.fields(), "ctas": plan.grid, "threads": plan.threads,
                     "smem_bytes": plan.smem_bytes, "x_staging": plan.x_staging,
                     "longest_chain": plan.longest_chain()},
            "bit_identical": identical, "max_abs_err": err, "max_rel_err": err / scale,
            "library_rel_err": (lib - ref).abs().max().item() / scale,
            "ms": timer(lambda: CW.conv1d_weight_grad_bf16_cuda(x, dy, K)),
            "plain_ms": timer(lambda: CW.conv1d_weight_grad_plain(x, dy, K)),
            "library_ms": timer(library),
            "f32_kernel_ms": timer(lambda: CW.conv1d_weight_grad_cuda(x32, dy32, K)),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "mbytes": nbytes / 1e6})
        rows[-1]["tflops"] = flops / rows[-1]["ms"] / 1e9
        rows[-1]["faster_than_library"] = rows[-1]["ms"] < rows[-1]["library_ms"]
        emit({"phase": "kernel", "name": "conv1d_weight_grad_bf16", **rows[-1]})
    return rows


def bf16_b3_keep_row(dev, timer, peaks, mcfg):
    """B3's bf16 entry with the dropout keep mask against its plain version at
    la_train's shape (B 64 x N 96), timed beside the float32 entry with the
    same mask on the float32 widening, the plain version and the bf16
    composition (rotary + one SDPA with the band mask; it applies no keep
    mask); the bound: bytes (bf16 qkv read, the float32 mask read, the bf16
    context written) or the operations at the float32 rate (the kernel
    computes in float32), whichever is larger."""
    h, dh, w, causal = mcfg.n_heads, mcfg.dim_head, mcfg.window_size, mcfg.causal
    lf = 0 if causal else 1
    g = torch.Generator(device=dev).manual_seed(25)
    p = FA.plan(LA_TRAIN_H, w, causal)
    Np, Kk = p["Np"], p["K"]
    qkv = torch.randn(LA_TRAIN_B, LA_TRAIN_H, 3 * h * dh, generator=g, device=dev).to(BF)
    keep = FA.dropout_keep_mask(g, KEEP_PROB, LA_TRAIN_B, LA_TRAIN_H, h, w, causal)
    args = (qkv, h, dh, w, causal, True, True, None, keep, KEEP_PROB)
    out = FA.fused_qkv_local_attention_bf16_cuda(*args)
    ref = FA.fused_qkv_local_attention_plain(*args)
    torch.cuda.synchronize()
    err = bf16_agreement("fused_qkv_local_attention (bf16, keep mask)", out, ref,
                         f"B {LA_TRAIN_B}, N {LA_TRAIN_H}")
    args32 = (qkv.float(),) + args[1:]
    tables = tuple(tuple(t.to(BF) for t in rotary_tables(pos, dh, dev))
                   for pos in (np.arange(Np) + lf * w, np.arange(Np)))
    mask = band_mask(Np, w, causal, dev)
    pairs, _ = attention_work(LA_TRAIN_H, Np, w, causal, [Np] * LA_TRAIN_B)
    flops = h * 4.0 * dh * pairs + 6.0 * LA_TRAIN_B * LA_TRAIN_H * h * dh
    nbytes = 2.0 * 4 * LA_TRAIN_B * LA_TRAIN_H * h * dh + 4.0 * LA_TRAIN_B * Np * h * Kk
    bound_ms, bound_by = bound(flops, nbytes, peaks)
    row = {"B": LA_TRAIN_B, "N": LA_TRAIN_H, "heads": h, "dim_head": dh, "window": w,
           "keep_prob": KEEP_PROB, **err,
           "plan": attention_plan_row(Np, p["C"], p["P"], w, causal, dh, LA_TRAIN_B * h, elem=2,
                                      keep=True),
           "f32_plan": attention_plan_row(Np, p["C"], p["P"], w, causal, dh, LA_TRAIN_B * h),
           "ms": timer(lambda: FA.fused_qkv_local_attention_bf16_cuda(*args)),
           "f32_kernel_ms": timer(lambda: FA.fused_qkv_local_attention_cuda(*args32)),
           "plain_ms": timer(lambda: FA.fused_qkv_local_attention_plain(*args)),
           "composition_ms": timer(lambda: b3_composition(qkv, h, dh, w, tables, mask)),
           "bound_ms": bound_ms, "bound_by": bound_by, "mbytes": nbytes / 1e6}
    emit({"phase": "kernel", "name": "fused_qkv_local_attention_bf16_keep", **row})
    return row


@contextlib.contextmanager
def bf16_plain():
    """Every kernel of a bf16 training step through its plain version: B1's
    bf16 forward, B2 (either form) and B3's bf16 entry."""
    with swapped(CB, conv_gn_mish_bf16_cuda=CB.conv_gn_mish_plain,
                 conv1d_weight_grad=CW.conv1d_weight_grad_plain), \
            swapped(FA, fused_qkv_local_attention_bf16_cuda=FA.fused_qkv_local_attention_plain):
        yield


def bf16_distance(grads_k, grads_p):
    """(max, median) over every element of |kernels - plain| / max |plain|."""
    scale = max(v.abs().max().item() for v in grads_p.values())
    d = torch.cat([(grads_k[k] - v).abs().flatten() for k, v in grads_p.items()]) / scale
    return d.max().item(), d.median().item()


def bf16_held(name, loss_k, loss_p, grads_k, grads_p):
    """The loss and every gradient of a bf16 step with the kernels against
    the same step with the plain versions; raises beyond BF16_LOSS_TOL and
    BF16_GRAD_TOL."""
    dist = bf16_distance(grads_k, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    finite = all(torch.isfinite(g).all() for g in grads_k.values())
    out = {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_err": loss_rel,
           "grad_max_rel_err": dist[0], "grad_median_rel_err": dist[1],
           "grad_dtypes": sorted({str(g.dtype) for g in grads_k.values()}),
           "tolerance": {"loss": BF16_LOSS_TOL, "grad": list(BF16_GRAD_TOL)}}
    emit({"phase": "bf16_grads", "path": name, **out})
    if not (finite and loss_rel <= BF16_LOSS_TOL and dist[0] <= BF16_GRAD_TOL[0]
            and dist[1] <= BF16_GRAD_TOL[1] and out["grad_dtypes"] == ["torch.float32"]):
        raise RuntimeError(f"bf16 {name} step with the kernels vs plain: {out}")
    return out


def bf16_grad_checks(dev, seed, la_cfg):
    """One micro-step of the bf16 dim-128 U-Net (B 32 x H 160, cartwheel) and
    of the bf16 localattn5k_r3 model (B 64 x H 96, dance_a, dropout live)
    with the kernels, against the same micro-step through the plain
    versions (same t, noise and keep masks); then one ``value_gradients``
    call and one ``value_diffusion_loss`` step of a bf16 ValueFunction (dim
    GUIDE_DIM, H 64), held the same way. Launch counts of each."""
    out = {}
    ds = MotionDataset.from_path(str(CARTWHEEL), include_velocity=False, augment="cyclic",
                                 horizon_multiple=8)
    x0 = torch.from_numpy(next(ds.epochs(TRAIN_B, seed=seed)).trajectories).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randint(0, T, (TRAIN_B,), generator=gen, device=dev)
    noise = torch.randn(x0.shape, generator=gen, device=dev)
    torch.manual_seed(seed)
    unet = TemporalUnet(D, dim=DIM, dtype=BF).to(dev).train()
    loss_fn = make_loss_fn(make_schedule("cosine", T, convention="diffuser", device=dev), unet,
                           weights=process.diffuser_loss_weights(ds.horizon, D, device=dev))

    def unet_step():
        unet.zero_grad(set_to_none=True)
        loss, _ = loss_fn(x0, t, noise)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in unet.named_parameters()}

    reset_counts()
    loss_k, grads_k = unet_step()
    launched = kernel_counts()
    with bf16_plain():
        loss_p, grads_p = unet_step()
    want = {B1_BF16: 33, B2_BF16: 33}
    if {k: v for k, v in launched.items() if v} != want or kernel_counts() != launched:
        raise RuntimeError(f"the bf16 U-Net micro-step launched {launched}, expected {want}")
    out["unet"] = {"batch": TRAIN_B, "H": x0.shape[1], "launches": want,
                   **bf16_held("unet", loss_k, loss_p, grads_k, grads_p)}
    del unet, grads_k, grads_p

    mcfg = dataclasses.replace(la_cfg.model, bf16=True)
    lx0, lt, lnoise = la_batch(la_cfg, seed, dev)
    torch.manual_seed(seed)
    la = factory.build_model(mcfg, dev).train()
    la_loss = make_loss_fn(factory.build_schedule(la_cfg.diffusion, dev), la, kind="v4",
                           predict_epsilon=False, use_mask=True,
                           dropout=train_cli.has_dropout(mcfg))

    def la_step():
        la.zero_grad(set_to_none=True)
        loss, _ = la_loss(lx0, lt, lnoise, generator=torch.Generator(device=dev).manual_seed(seed))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in la.named_parameters()}

    reset_counts()
    with keep_mask_launches("fused_qkv_local_attention_bf16_cuda") as kept:
        loss_k, grads_k = la_step()
    launched = kernel_counts()
    with bf16_plain():
        loss_p, grads_p = la_step()
    depth = mcfg.depth
    if ({k: v for k, v in launched.items() if v} != {B3_BF16: depth} or not all(kept)
            or len(kept) != depth):
        raise RuntimeError(f"the bf16 la micro-step launched {launched}, keep masks {kept}")
    out["la"] = {"batch": LA_TRAIN_B, "H": lx0.shape[1], "launches": {B3_BF16: depth},
                 "launches_with_keep_mask": sum(kept),
                 **bf16_held("la", loss_k, loss_p, grads_k, grads_p)}
    del la, grads_k, grads_p

    torch.manual_seed(seed)
    value = ValueFunction(D, H, dim=GUIDE_DIM, dtype=BF).to(dev).eval().requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    x = torch.randn(B, H, D, generator=g, device=dev)
    tv = torch.randint(0, GUIDE_T, (B,), generator=g, device=dev)
    reset_counts()
    y_k, dx_k = value_gradients(value, x, tv)
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernel_counts().items() if v}
    with bf16_plain():
        y_p, dx_p = value_gradients(value, x, tv)
    per_value = launched.get(B1_BF16, 0)
    if set(launched) != {B1_BF16} or per_value != 20:
        raise RuntimeError(f"bf16 value_gradients launched {launched}")
    out["value_gradients"] = {"launches": launched, **bf16_held(
        "value_gradients", y_k.sum().item(), y_p.sum().item(), {"x": dx_k}, {"x": dx_p}),
        "value_max_rel_err": ((y_k - y_p).abs().max() / y_p.abs().max()).item()}
    trainable = copy.deepcopy(value).requires_grad_(True).train()
    vx0 = torch.randn(B, H, D, generator=g, device=dev)
    target = torch.randn(B, generator=g, device=dev)
    vnoise = torch.randn(B, H, D, generator=g, device=dev)
    vsched = make_schedule("cosine", GUIDE_T, convention="diffuser", device=dev)

    def value_step():
        trainable.zero_grad(set_to_none=True)
        loss, _ = value_diffusion_loss(vsched, trainable, vx0, target, tv, vnoise)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in trainable.named_parameters()}

    reset_counts()
    loss_k, grads_k = value_step()
    launched = {k: v for k, v in kernel_counts().items() if v}
    with bf16_plain():
        loss_p, grads_p = value_step()
    if launched != {B1_BF16: 20, B2_BF16: 20}:
        raise RuntimeError(f"the bf16 value_diffusion_loss step launched {launched}")
    out["value_diffusion_loss"] = {"launches": launched, **bf16_held(
        "value_diffusion_loss", loss_k, loss_p, grads_k, grads_p)}
    return out


def bf16_train_run(tmp, name, argv, micro_expect, entry=None):
    """``cli.train.main`` on a bf16 config: every kernel's count set to 0
    just before and read just after (``micro_expect``: {count: launches a
    micro-step}; every other count 0), with ``entry``'s launches recorded for
    their keep masks; checkpoints, logs and the EMA; float32 parameters and
    EMA. -> (result, trainer config)."""
    run = os.path.join(tmp, name)
    reset_counts()
    t0 = time.perf_counter()
    with (keep_mask_launches(entry) if entry else contextlib.nullcontext([])) as kept, \
            contextlib.redirect_stdout(io.StringIO()):
        trainer = train_cli.main(argv + ["--out", run])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = kernel_counts()
    cfg = ExperimentConfig.load(os.path.join(run, "config.json"))
    accum = cfg.train.gradient_accumulate_every
    micro = BF16_TRAIN_STEPS * accum
    want = {k: v * micro for k, v in micro_expect.items()}
    if ({k: v for k, v in launched.items() if v} != want
            or (entry and (len(kept) != want[B3_BF16] or not all(kept)))):
        raise RuntimeError(f"the bf16 {name} run launched {launched}, expected {want}"
                           + (f"; keep masks on {sum(kept)} of {len(kept)}" if entry else ""))
    ckpts = Path(run) / "checkpoints"
    saved = sorted(p.name for p in ckpts.glob("*.pt"))
    half = BF16_TRAIN_STEPS // 2 * accum
    for ck in ("best_model.pt", f"state_{half}.pt", f"state_{micro}.pt"):
        if not (ckpts / ck).exists():
            raise RuntimeError(f"the bf16 {name} run wrote no {ck}: {saved}")
    metrics = json.loads((Path(run) / "training_metrics.json").read_text())
    losses = [r["loss"] for r in metrics["metrics"]]
    logged = log_steps(micro, accum, cfg.train.scan_chunk, cfg.train.log_every)
    state = trainer.state
    ema_moved = any((state.ema_params[k] != v).any().item()
                    for k, v in state.model.state_dict().items())
    f32 = (all(p.dtype == torch.float32 for p in state.model.parameters())
           and all(v.dtype == torch.float32 for v in state.ema_params.values()
                   if v.is_floating_point()))
    if (not cfg.model.bf16 or [r["step"] for r in metrics["metrics"]] != logged
            or not np.isfinite(losses).all() or not ema_moved or not f32):
        raise RuntimeError(f"the bf16 {name} run: metrics {metrics}, expected records at "
                           f"{logged}; EMA moved {ema_moved}; float32 state {f32}")
    result = {"seconds": seconds, "optimizer_steps": BF16_TRAIN_STEPS, "micro_steps": micro,
              "micro_batch": cfg.train.batch_size, "accum": accum,
              "horizon": trainer.dataset.horizon, "launches": want,
              "launches_per_micro_step": micro_expect, "losses": losses,
              "best_loss": metrics["best_loss"], "checkpoints": saved,
              "ema_differs_from_params": ema_moved}
    if entry:
        result["launches_with_keep_mask"] = sum(kept)
    return result, cfg


def bf16_train_phase(dev, timer, args, tmp, peaks, la_cfg):
    """Phase 23: B1's bf16 form at the 33 forward shapes of a dim-128
    micro-step (B 32 x H 160) and the 20 of the ValueFunction (B 16 x H 64),
    B2's bf16 form at the 33 shapes of a dim-128 micro-step and the 20 of a
    value step, each beside cuDNN's bf16 wgrad, and
    B3's bf16 entry with the keep mask at la_train's shape, each against its
    plain version and timed; the bf16 micro-steps' and value guidance's
    gradients against the plain path; then ``cli.train.main`` on the train
    phase's run and on la_train's, each with ``model.bf16=true``, for
    BF16_TRAIN_STEPS optimizer steps (saves, logs and the EMA firing), the
    counts set to 0 just before and read just after; ms per optimizer step,
    busy share and peak memory of each."""
    probe = TemporalUnet(D, dim=DIM).to(dev).eval()
    per_step = Counter(record_block_shapes(probe, torch.zeros(TRAIN_B, TRAIN_H, D, device=dev),
                                           torch.zeros(TRAIN_B, device=dev)))
    del probe
    value = ValueFunction(D, H, dim=GUIDE_DIM).to(dev).eval()
    per_value = Counter(record_block_shapes(value, torch.zeros(B, H, D, device=dev),
                                            torch.zeros(B, device=dev)))
    del value
    n_blocks = sum(per_step.values())
    out = {"per_micro_step": n_blocks, "per_value_forward": sum(per_value.values()),
           "b1_rows": bf16_b1_rows(dev, timer, per_step, peaks, TRAIN_B),
           "b1_value_rows": bf16_b1_rows(dev, timer, per_value, peaks, B),
           "b2_rows": bf16_b2_rows(dev, timer, per_step, peaks, TRAIN_B, "micro_step"),
           "b2_value_rows": bf16_b2_rows(dev, timer, per_value, peaks, B, "value_step"),
           "b3_keep_row": bf16_b3_keep_row(dev, timer, peaks, la_cfg.model)}
    if not any(r["bit_identical"] for r in out["b2_rows"] + out["b2_value_rows"]):
        raise RuntimeError("conv1d_weight_grad_bf16: no shape's plan splits the rows over a "
                           "cluster, so no launch was checked for determinism")
    out["grads"] = bf16_grad_checks(dev, args.seed, la_cfg)

    unet_set = [f"train.gradient_accumulate_every={ACCUM}", "train.log_every=10",
                f"train.save_every={BF16_TRAIN_STEPS // 2}", "train.ema_start=4",
                "train.ema_every=2", f"train.seed={args.seed}", "model.bf16=true"]
    out["unet"], unet_cfg = bf16_train_run(
        tmp, "bf16_train_run",
        ["--config", str(USER_CONFIG), "--data", str(CARTWHEEL), "--batch-size", str(TRAIN_B),
         "--steps", str(BF16_TRAIN_STEPS), "--device", "cuda", "--set", *unet_set],
        {B1_BF16: n_blocks, B2_BF16: n_blocks})
    out["unet"]["profile"] = step_profile(unet_cfg, dev)
    emit({"phase": "main_path", "path": "bf16_train_unet", **out["unet"]})

    la_set = ["train.log_every=10", f"train.save_every={BF16_TRAIN_STEPS // 2}",
              "train.ema_start=4", "train.ema_every=2", f"train.seed={args.seed}",
              "model.bf16=true"]
    out["la"], la_run_cfg = bf16_train_run(
        tmp, "bf16_la_train",
        ["--config", str(LA_CONFIG), "--data", str(LA_DATA), "--steps", str(BF16_TRAIN_STEPS),
         "--device", "cuda", "--set", *la_set],
        {B3_BF16: la_cfg.model.depth}, entry="fused_qkv_local_attention_bf16_cuda")
    if (out["la"]["horizon"], out["la"]["micro_batch"]) != (LA_TRAIN_H, LA_TRAIN_B):
        raise RuntimeError(f"the bf16 la run took H {out['la']['horizon']}, "
                           f"B {out['la']['micro_batch']}")
    out["la"]["profile"] = step_profile(la_run_cfg, dev)
    emit({"phase": "main_path", "path": "bf16_train_la", **out["la"]})
    return out


# ---------------------------------------------------------------------------
# Phase 24: the horizon split at bf16 (K1, K2 and K3 in their bf16 forms), B4 at bf16, and the
# bf16 KV-cache decode


def rel_dist(got, ref):
    """(max, median) of |got - ref| / max |ref|."""
    d = np.abs(got - ref) / np.abs(ref).max()
    return float(d.max()), float(np.median(d))


def within(dist, tol):
    return dist[0] <= tol[0] and dist[1] <= tol[1]


def k2_bf16_agreement(y, bare, add, plain, bare_plain, where):
    """bf16 K2 with an addend: equal to its launch without one followed by
    the bf16 add (its rounding places), and within one bf16 ulp of the
    plain Mish value carried through the add plus one of the sum, BF16_TOL
    beside (the bare launch is held to bf16_agreement); else raise."""
    if not torch.equal(y, added(bare, add)):
        raise RuntimeError(f"gn_affine_mish_bf16 with its addend at {where} is not its bare "
                           "launch followed by the bf16 add")
    d = (y.float() - plain.float()).abs()
    beyond = int((d > 2.0 ** -7 * (bare_plain.float().abs() + plain.float().abs())
                  + BF16_TOL).sum())
    if beyond:
        raise RuntimeError(f"gn_affine_mish_bf16 with its addend at {where}: {beyond} values "
                           f"beyond the bound (max abs err {d.max().item()})")
    ulps = bf16_ulps(y, plain)
    return {"max_abs_err": d.max().item(), "max_ulps": int(ulps.max()),
            "bit_equal_share": float((ulps == 0).float().mean())}


def seq_bf16_k1_k2_rows(dev, timer, peaks, shapes, kinds):
    """K1's and K2's bf16 forms against their plain versions at every (H,
    Cin, Cout) of a rank's sharded dim-128 forward (``shapes``: Counter of
    launches a forward), bf16 K1 + K2 over one rank (zero halo rows) against
    B1's bf16 form, each timed beside its float32 form on the same values
    (widened), its plain version and the bf16 composition (K2: the unfused
    chain it replaces). K2 as phase 21 takes it: SEQ_RANKS ranks' statistics,
    each bf16 addend checked at every shape and timed where the forward
    gives it (``kinds``)."""
    g = torch.Generator(device=dev).manual_seed(24)
    k1, k2 = [], []
    for (h, cin, cout), n in shapes.items():
        where = f"B {SEQ_B}, H {h}, {cin}->{cout}"
        xh = torch.randn(SEQ_B, h + K - 1, cin, generator=g, device=dev).to(BF)
        w = (torch.randn(K, cin, cout, generator=g, device=dev) * (K * cin) ** -0.5).to(BF)
        b, gamma, beta = (m + 0.1 * torch.randn(cout, generator=g, device=dev)
                          for m in (0.0, 1.0, 0.0))
        pre, st = CB.conv_gn_stats_bf16_cuda(xh, w, b, GROUPS)
        pre_p, st_p = CB.conv_gn_stats_plain(xh, w, b, GROUPS)
        count = h * (cout // GROUPS)
        xz = xh.clone()  # one rank holding the whole horizon: zero halo rows, then B1 at bf16
        xz[:, :K // 2] = 0
        xz[:, h + K // 2:] = 0
        pz, sz = CB.conv_gn_stats_bf16_cuda(xz, w, b, GROUPS)
        via = CB.gn_affine_mish_bf16_cuda(pz, sz[None], count, 1e-5, gamma, beta, GROUPS)
        parts = torch.stack([st, sz])
        adds = {kind: k2_addend(kind, h, cout, g, dev, BF) for kind in ADD_KINDS}
        ys = {kind: CB.gn_affine_mish_bf16_cuda(pre, parts, count, 1e-5, gamma, beta, GROUPS,
                                                add=a) for kind, a in adds.items()}
        plains = {kind: CB.gn_merge_mish_plain(pre, parts, count, 1e-5, gamma, beta, GROUPS,
                                               add=a, dtype=BF) for kind, a in adds.items()}
        b1 = CB.conv_gn_mish_bf16_cuda(xz[:, K // 2:h + K // 2].contiguous(), w, b, gamma, beta,
                                       GROUPS)
        torch.cuda.synchronize()
        errs = {"pre": (pre - pre_p).abs().max().item(),
                "mean": (st[..., 0] - st_p[..., 0]).abs().max().item(),
                "m2_rel": ((st[..., 1] - st_p[..., 1]).abs()
                           / st_p[..., 1].abs().clamp_min(1e-30)).max().item()}
        if not (max(errs["pre"], errs["mean"]) <= KERNEL_TOL and errs["m2_rel"] <= SEQ_STATS_TOL
                and pre.dtype == torch.float32 and torch.isfinite(pre).all()):
            raise RuntimeError(f"conv_gn_stats_bf16 disagrees at {where}: {errs}")
        k2_errs = {"none": bf16_agreement("gn_affine_mish_bf16", ys["none"], plains["none"],
                                          where)}
        for kind in ADD_KINDS[1:]:
            k2_errs[kind] = k2_bf16_agreement(ys[kind], ys["none"], adds[kind], plains[kind],
                                              plains["none"], f"{where}, addend {kind}")
        vs_b1 = bf16_agreement("bf16 K1 + K2 over one rank against conv_gn_mish_bf16", via, b1,
                               where)
        x32, w32 = xh.float(), w.float()
        xc, wc, b16 = xh.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous(), b.to(BF)

        def k1_comp():
            o = F.conv1d(xc, wc, b16)
            return o, torch.var_mean(o.view(SEQ_B, GROUPS, -1), dim=-1, correction=0)

        flops = 2.0 * SEQ_B * h * cout * K * cin
        nbytes = (2.0 * (SEQ_B * (h + K - 1) * cin + K * cin * cout)
                  + 4.0 * (cout + SEQ_B * h * cout + 2 * SEQ_B * GROUPS))
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / peaks[1] * 1e3
        plan = CB.bf16_plan(SEQ_B, h, cin, cout, K, GROUPS)
        row = {"B": SEQ_B, "H": h, "cin": cin, "cout": cout, "per_forward": n,
               "plan": {**plan.fields(), "ctas": plan.grid, "smem_bytes": plan.smem_bytes},
               "max_abs_err": errs["pre"], "errors": errs,
               "ms": timer(lambda: CB.conv_gn_stats_bf16_cuda(xh, w, b, GROUPS)),
               "f32_kernel_ms": timer(lambda: CB.conv_gn_stats_cuda(x32, w32, b, GROUPS)),
               "plain_ms": timer(lambda: CB.conv_gn_stats_plain(xh, w, b, GROUPS)),
               "composition_ms": timer(k1_comp), "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        k1.append(row)
        emit({"phase": "kernel", "name": "conv_gn_stats_bf16", **row})
        for kind in ADD_KINDS:
            if not kinds[((h, cin, cout), kind)]:
                continue
            a = adds[kind]
            a32 = None if a is None else a.float()
            row = {"B": SEQ_B, "H": h, "C": cout, "R": SEQ_RANKS, "add": kind,
                   "per_forward": kinds[((h, cin, cout), kind)], **k2_errs[kind],
                   "k1_k2_vs_b1_bf16": vs_b1,
                   "ms": timer(lambda: CB.gn_affine_mish_bf16_cuda(pre, parts, count, 1e-5, gamma,
                                                                   beta, GROUPS, add=a)),
                   "f32_kernel_ms": timer(lambda: CB.gn_affine_mish_cuda(
                       pre, parts, count, 1e-5, gamma, beta, GROUPS, add=a32)),
                   "plain_ms": timer(lambda: CB.gn_merge_mish_plain(
                       pre, parts, count, 1e-5, gamma, beta, GROUPS, add=a, dtype=BF)),
                   "unfused_ms": timer(k2_unfused(parts, count, pre, gamma, beta, a, BF))}
            row["bound_ms"], row["bound_by"] = k2_bound(SEQ_B * h * cout, cout, kind, 2, peaks)
            k2.append(row)
            emit({"phase": "kernel", "name": "gn_affine_mish_bf16", **row})
    return k1, k2


def seq_bf16_k3_rows(dev, timer, peaks, mcfg):
    """K3's bf16 form against its plain version at both ranks' slabs of one
    bf16 qkv over the whole horizon, each rank's rows against B3's bf16
    entry on the whole horizon (K3 is B3's bf16 core from slab row q0), timed
    beside its float32 form on the same values, the plain version and the
    bf16 composition (rotary at the global positions, then one SDPA with the
    band mask)."""
    h, dh, w, causal = mcfg.n_heads, mcfg.dim_head, mcfg.window_size, mcfg.causal
    lf = 0 if causal else 1
    n = SEQ_H // SEQ_RANKS
    g = torch.Generator(device=dev).manual_seed(25)
    whole_qkv = torch.randn(SEQ_B, SEQ_H, 3 * h * dh, generator=g, device=dev).to(BF)
    whole = FA.fused_qkv_local_attention_bf16_cuda(whole_qkv, h, dh, w, causal)
    rows = []
    for rank in range(SEQ_RANKS):
        q0 = w if rank > 0 else 0
        end = (rank + 1) * n + (lf * w if rank < SEQ_RANKS - 1 else 0)
        qkv = whole_qkv[:, rank * n - q0:end].contiguous()
        Nh, pos0 = qkv.shape[1], rank * n - q0
        args = (qkv, h, dh, w, q0, n, pos0, causal, True, True, None)
        out = FA.local_attention_halo_bf16_cuda(*args)
        ref = FA.local_attention_halo_plain(*args)
        torch.cuda.synchronize()
        where = f"rank {rank}'s slab (B {SEQ_B}, Nh {Nh})"
        err = bf16_agreement("local_attention_halo_bf16", out, ref, where)
        vs_b3 = bf16_agreement("local_attention_halo_bf16 against B3's bf16 entry", out,
                               whole[:, rank * n:(rank + 1) * n], where)
        ti, tj = np.arange(q0, q0 + n)[:, None], np.arange(Nh)[None, :]
        ok = ~FA.window_mask(ti, tj, w, 1, lf, causal, True, False)
        x = qkv.view(SEQ_B, Nh, 3, h, dh).permute(2, 0, 3, 1, 4)
        q_tab = tuple(t.to(BF) for t in rotary_tables(pos0 + np.arange(q0, q0 + n) + lf * w, dh,
                                                      dev))
        k_tab = tuple(t.to(BF) for t in rotary_tables(pos0 + np.arange(Nh), dh, dev))
        mask = torch.from_numpy(ok).to(dev)

        def comp():
            o = F.scaled_dot_product_attention(rotate(x[0][:, :, q0:q0 + n], q_tab),
                                               rotate(x[1], k_tab), x[2], attn_mask=mask)
            return o.transpose(1, 2).reshape(SEQ_B, n, h * dh)

        args32 = (qkv.float(),) + args[1:]
        pairs = int(ok.sum()) * SEQ_B
        flops = h * 4.0 * dh * pairs + 6.0 * SEQ_B * (n + Nh) * h * dh
        row = {"rank": rank, "B": SEQ_B, "Nh": Nh, "q0": q0, "Nq": n, "pos0": pos0, **err,
               "vs_b3_bf16": vs_b3,
               "plan": dataclasses.asdict(FA.halo_plan(SEQ_B, h, dh, w, q0, n, Nh, causal, True,
                                                       elem=2)),
               "f32_plan": dataclasses.asdict(FA.halo_plan(SEQ_B, h, dh, w, q0, n, Nh, causal,
                                                           True)),
               "ms": timer(lambda: FA.local_attention_halo_bf16_cuda(*args)),
               "f32_kernel_ms": timer(lambda: FA.local_attention_halo_cuda(*args32)),
               "plain_ms": timer(lambda: FA.local_attention_halo_plain(*args)),
               "composition_ms": timer(comp), "pairs_per_head": pairs}
        # bytes: bf16 Q of the rank's n rows, K and V of the slab's Nh, the n output rows
        row["bound_ms"], row["bound_by"] = bound(flops, 2.0 * SEQ_B * h * dh * (2 * Nh + 2 * n),
                                                 peaks)
        rows.append(row)
        emit({"phase": "kernel", "name": "local_attention_halo_bf16", **row})
    return rows


def bf16_b4_rows(dev, timer, peaks, mcfg):
    """B4's bf16 form through its front door ``windowed_attention`` at
    la_serve's aligned shapes (B 16 x H 128, B 4 x H 1024; dh 64) and once at
    dh 32 (16 heads of the same width), against its plain version, timed
    beside its float32 form on the same values, the plain version and the
    bf16 composition (rotary, then one SDPA with the band mask). -> (rows,
    the front door's launches of the bf16 form)."""
    w, causal = mcfg.window_size, mcfg.causal
    lf = 0 if causal else 1
    width = mcfg.n_heads * mcfg.dim_head
    g = torch.Generator(device=dev).manual_seed(26)
    cases = []
    for batch, n, dh in ((LA_B, LA_H, mcfg.dim_head), (LA_SMALL_B, LA_LONG, mcfg.dim_head),
                         (LA_B, LA_H, 32)):
        h = width // dh
        cases.append((batch, n, dh, h, *(torch.randn(batch, h, n, dh, generator=g,
                                                     device=dev).to(BF) for _ in range(3))))
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        outs = [LH.windowed_attention(q, k, v, w, causal=causal) for *_, q, k, v in cases]
    torch.cuda.synchronize()
    launches = LH.local_attention_heads_bf16_cuda.launches
    if launches != len(cases) or LH.local_attention_heads_cuda.launches:
        raise RuntimeError(f"windowed_attention at bf16 launched B4's bf16 form {launches} "
                           f"times, its float32 form {LH.local_attention_heads_cuda.launches}")
    rows = []
    for (batch, n, dh, h, q, k, v), out in zip(cases, outs):
        ref = LH.local_attention_heads_plain(q, k, v, w, causal)
        err = bf16_agreement("local_attention_heads_bf16", out, ref, f"B {batch}, N {n}, dh {dh}")
        qt, kt = (tuple(t.to(BF) for t in rotary_tables(pos, dh, dev))
                  for pos in (np.arange(n) + lf * w, np.arange(n)))
        mask = band_mask(n, w, causal, dev)

        def composition(q=q, k=k, v=v, qt=qt, kt=kt, mask=mask):
            return F.scaled_dot_product_attention(rotate(q, qt), rotate(k, kt), v, attn_mask=mask)

        q32, k32, v32 = q.float(), k.float(), v.float()
        pairs, _ = attention_work(n, n, w, causal, [n] * batch)
        flops = h * 4.0 * dh * pairs + 6.0 * batch * h * n * dh
        bound_ms, bound_by = bound(flops, 2.0 * 4 * batch * h * n * dh, peaks)
        rows.append({"B": batch, "heads": h, "N": n, "dh": dh, **err,
                     "plan": attention_plan_row(n, LH.CHUNK, LH.CHUNK, w, causal, dh, batch * h,
                                                elem=2),
                     "f32_plan": attention_plan_row(n, LH.CHUNK, LH.CHUNK, w, causal, dh,
                                                    batch * h),
                     "ms": timer(lambda: LH.local_attention_heads_bf16_cuda(q, k, v, w, causal)),
                     "f32_kernel_ms": timer(lambda: LH.local_attention_heads_cuda(q32, k32, v32,
                                                                                  w, causal)),
                     "plain_ms": timer(lambda: LH.local_attention_heads_plain(q, k, v, w, causal)),
                     "composition_ms": timer(composition),
                     "composition_max_abs_err": (composition().float() - ref.float()).abs()
                     .max().item(), "bound_ms": bound_ms, "bound_by": bound_by})
        emit({"phase": "kernel", "name": "local_attention_heads_bf16", **rows[-1]})
    return rows, launches


def bf16_decode(dev, seed):
    """localattn5k_r3 with model.causal=true at bf16: SEQ_BF16_DECODE frames at
    B 4 decoded through the KV cache (bf16 ring buffers) against its full
    causal bf16 forward (SEQ_BF16_DECODE_TOL), and both beside the float32
    build's causal forward of the same weights."""
    cfg = ExperimentConfig.load(str(LA_CONFIG)).override({"model.causal": True})
    g = torch.Generator().manual_seed(seed + 24)
    x = torch.randn(LA_SMALL_B, SEQ_BF16_DECODE, cfg.model.input_dim, generator=g).to(dev)
    t = torch.randint(0, T, (LA_SMALL_B,), generator=g).to(dev)
    model = seeded_model(cfg.override({"model.bf16": True}), seed,
                         hyper_connection_weights).to(dev).eval()
    f32 = seeded_model(cfg, seed, hyper_connection_weights).to(dev).eval()
    with torch.inference_mode():
        full32 = f32(x, t).cpu().numpy()
        reset_counts()
        full = model(x, t)
        b3 = FA.fused_qkv_local_attention_bf16_cuda.launches
        cache = model.init_decode_cache(LA_SMALL_B)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(SEQ_BF16_DECODE):
            out, cache = model(x[:, i:i + 1], t, cache=cache, decode_pos=i)
            steps.append(out)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    dec, full = torch.cat(steps, dim=1).cpu().numpy(), full.cpu().numpy()
    dist = rel_dist(dec, full)
    if not (within(dist, SEQ_BF16_DECODE_TOL) and np.isfinite(dec).all()
            and all(k.dtype == v.dtype == BF for k, v in cache)):
        raise RuntimeError(f"the bf16 KV-cache decode: {dist} from the causal bf16 forward "
                           f"(bound {SEQ_BF16_DECODE_TOL}), cache {cache[0][0].dtype}")
    return {"B": LA_SMALL_B, "frames": SEQ_BF16_DECODE, "rel_dist_vs_forward": dist,
            "rel_dist_vs_float32_forward": rel_dist(dec, full32),
            "forward_rel_dist_vs_float32": rel_dist(full, full32),
            "ms_per_frame": seconds * 1e3 / SEQ_BF16_DECODE, "causal_forward_b3_bf16_launches": b3}


def seq_bf16_phase(dev, timer, args, tmp, peaks):
    """Phase 24: K1, K2 and K3 at bf16 at the shapes of phase 21's split, B4
    at bf16, then two gloo ranks running phase 21's chains with both models
    built at bf16 (seq_worker) against this process alone (B1's and B3's bf16
    forms), and the bf16 KV-cache decode. It makes its own references and
    needs no earlier phase's files."""
    la_cfg = ExperimentConfig.load(str(LA_CONFIG))
    probe = TemporalUnet(D, dim=DIM).to(dev).eval()
    x = torch.zeros(SEQ_B, SEQ_H // SEQ_RANKS, D, device=dev)
    shapes = Counter(record_block_shapes(probe, x, torch.zeros(SEQ_B, device=dev)))
    kinds = record_k2_kinds(probe, x, torch.zeros(SEQ_B, device=dev))
    del probe
    k1, k2 = seq_bf16_k1_k2_rows(dev, timer, peaks, shapes, kinds)
    k3 = seq_bf16_k3_rows(dev, timer, peaks, la_cfg.model)
    b4, b4_launches = bf16_b4_rows(dev, timer, peaks, la_cfg.model)

    t0 = time.perf_counter()
    ranks = spawn_ranks(seq_worker, SEQ_RANKS, os.path.join(tmp, "seq_bf16_store"),
                        device=dev.type, args=(args.seed, dev.type, True), timeout=SEQ_TIMEOUT)
    result = {"ranks": SEQ_RANKS, "ranks_seconds": time.perf_counter() - t0,
              "note": "gloo on one card, not scaling"}
    per_forward = sum(shapes.values())  # 33

    unet, sched, x, t = seq_unet(args.seed, dev, bf16=True)
    with torch.inference_mode():
        fwd = rel_dist(np.concatenate([r["unet_forward"] for r in ranks], axis=1),
                       unet(x, t).cpu().numpy())
    seq_unet_chain(unet, sched, args.seed, dev)
    one, one_s, one_n = counted(lambda: seq_unet_chain(unet, sched, args.seed, dev))
    ref = one.cpu().numpy()
    del unet
    f32_chain = seq_unet_chain(seq_unet(args.seed, dev)[0], sched, args.seed, dev).cpu().numpy()
    got = np.concatenate([r["unet"]["traj"] for r in ranks], axis=1)
    counts = [r["unet"]["counts"] for r in ranks]
    want = only(conv_gn_stats_bf16=per_forward * SEQ_DDIM,
                gn_affine_mish_bf16=per_forward * SEQ_DDIM)
    box = np.abs(got[:, :, BOX_ZERO]).max(), np.abs(got[:, :, BOX_ELBOW] - np.float32(1.57)).max()
    chain = rel_dist(got, ref)
    if not (within(fwd, SEQ_BF16_TOL) and within(chain, SEQ_BF16_TOL) and np.isfinite(got).all()
            and max(box) == 0.0 and all(c == want for c in counts)
            and one_n == only(conv_gn_mish_bf16=per_forward * SEQ_DDIM)):
        raise RuntimeError(f"the bf16 sharded U-Net: forward {fwd}, chain {chain} (bound "
                           f"{SEQ_BF16_TOL}), clamped dims off by {box}; counts {counts} "
                           f"(expected {want}), one process {one_n}")
    result["unet_ddim"] = {
        "B": SEQ_B, "H": SEQ_H, "steps": SEQ_DDIM, "counts_per_rank": counts,
        "one_process_counts": one_n, **split_profile(ranks),
        "forward_rel_dist": fwd, "chain_rel_dist": chain,
        "float32_chain_rel_dist": rel_dist(f32_chain, ref),
        "ms_per_step_sharded": [r["unet"]["seconds"] * 1e3 / SEQ_DDIM for r in ranks],
        "ms_per_step_one_process": one_s * 1e3 / SEQ_DDIM}
    emit({"phase": "main_path", "path": "seq_bf16_unet", **result["unet_ddim"]})

    model, la_sched, x, t = seq_la_model(args.seed, dev, bf16=True)
    depth = model.depth
    with torch.inference_mode():
        model(x, t)
        y, fwd_s, fwd_n = counted(lambda: model(x, t))
    fwd = rel_dist(np.concatenate([r["la_forward"]["out"] for r in ranks], axis=1),
                   y.cpu().numpy())
    traj, chain_s, chain_n = counted(lambda: seq_la_chain(model, la_sched, args.seed, dev))
    del model
    ref = traj.cpu().numpy()
    f32_model = seq_la_model(args.seed, dev)[0]
    f32_chain = seq_la_chain(f32_model, la_sched, args.seed, dev).cpu().numpy()
    del f32_model
    chain = rel_dist(np.concatenate([r["la_chain"]["traj"] for r in ranks], axis=1), ref)
    fwd_counts = [r["la_forward"]["counts"] for r in ranks]
    chain_counts = [r["la_chain"]["counts"] for r in ranks]
    if not (within(fwd, SEQ_BF16_TOL) and within(chain, SEQ_BF16_TOL)
            and all(c == only(local_attention_halo_bf16=depth) for c in fwd_counts)
            and all(c == only(local_attention_halo_bf16=depth * SEQ_LA_STEPS)
                    for c in chain_counts)
            and fwd_n == only(fused_qkv_local_attention_bf16=depth)):
        raise RuntimeError(f"the bf16 sharded local transformer: forward {fwd}, chain {chain} "
                           f"(bound {SEQ_BF16_TOL}), counts {fwd_counts} / {chain_counts}, one "
                           f"process {fwd_n}")
    result["local_attention"] = {
        "B": SEQ_B, "H": SEQ_H, "depth": depth, "forward_rel_dist": fwd,
        "forward_counts_per_rank": fwd_counts, "chain_counts_per_rank": chain_counts,
        "chain_steps": SEQ_LA_STEPS, "chain_rel_dist": chain,
        "float32_chain_rel_dist": rel_dist(f32_chain, ref),
        "forward_ms_sharded": [r["la_forward"]["seconds"] * 1e3 for r in ranks],
        "forward_ms_one_process": fwd_s * 1e3,
        "ms_per_step_sharded": [r["la_chain"]["seconds"] * 1e3 / SEQ_LA_STEPS for r in ranks],
        "ms_per_step_one_process": chain_s * 1e3 / SEQ_LA_STEPS}
    emit({"phase": "main_path", "path": "seq_bf16_local_attention", **result["local_attention"]})
    result["decode"] = bf16_decode(dev, args.seed)
    emit({"phase": "main_path", "path": "bf16_decode", **result["decode"]})
    result.update(k1_rows=k1, k2_rows=k2, k3_rows=k3, b4_rows=b4, b4_launches=b4_launches,
                  per_forward=per_forward)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write all results to this JSON file")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    peak_key, peaks = peaks_for(kind)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks_for": peak_key, "fp32_flops": peaks[0], "hbm_bytes_per_s": peaks[1],
          "tf32_flops": peaks[2]})

    t0 = time.perf_counter()
    ptxas = build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "wgrad_bf16_sass": wgrad_bf16_sass()})

    timer = Timer(dev)
    torch.manual_seed(args.seed)
    probe = TemporalUnet(D, dim=DIM).to(dev).eval()
    gx = torch.Generator(device=dev).manual_seed(args.seed + 1)
    shape_counts = {}
    for batch, h in ((B, H), (B, 48), (TRAIN_B, TRAIN_H)):
        x = torch.randn(batch, h, D, generator=gx, device=dev)
        t = torch.randint(0, T, (batch,), generator=gx, device=dev)
        shape_counts[h] = Counter(record_block_shapes(probe, x, t))
    del probe
    per_step = sum(shape_counts[TRAIN_H].values())  # 33: B1 forward launches = B2 launches
    serve_counts = {h: shape_counts[h] for h in (H, 48)}
    warm_card(dev)
    serve_rows = b1_rows(dev, timer, serve_counts, peaks, B,
                         extra=[(192, cin, DIM) for cin in (D, DIM)])
    train_rows = b1_rows(dev, timer, {TRAIN_H: shape_counts[TRAIN_H]}, peaks, TRAIN_B)
    wgrad_rows = b2_rows(dev, timer, shape_counts[TRAIN_H], peaks, TRAIN_B)

    la_cfg = ExperimentConfig.load(str(LA_CONFIG))
    b3 = b3_rows(dev, timer, peaks, la_cfg.model)
    b4 = b4_rows(dev, timer, peaks, la_cfg.model)
    phys_ops = physics_op_counts()
    emit({"phase": "physics_operations_per_env", **phys_ops})
    phys = physics_kernel_rows(dev, timer, peaks, phys_ops)

    result = {"phase_seconds": {"build": build_s, "kernels": time.perf_counter() - t0 - build_s},
              "kernel_rows": {"conv_gn_mish_serve": serve_rows,
                              "conv_gn_mish_train": train_rows,
                              "conv1d_weight_grad_train": wgrad_rows,
                              "fused_qkv_local_attention": b3, "local_attention_heads": b4,
                              "physics": phys, "physics_operations_per_env": phys_ops}}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds = result.setdefault("phase_seconds", {})[name] = time.perf_counter() - t0
        emit({"phase": "phase_seconds", "name": name, "seconds": seconds})
        return out

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        result["serve"] = phase("serve", serve_phase, dev, timer, args, tmp, shape_counts, peaks)
        result["guide"] = phase("guide", guide_phase, dev, timer, args, tmp, peaks)
        result["physics"] = phase("physics", physics_phase, dev, tmp, phys_ops, peaks)
        result["engines"] = phase("engines", engines_phase, dev, smi)
        result["la_serve"] = phase("la_serve", la_serve_phase, dev, timer, args, tmp, la_cfg)
        result["la_train"] = phase("la_train", la_train_phase, dev, args, tmp, la_cfg)
        result["train"] = phase("train", train_phase, args, tmp, per_step)
        b_cfg = ExperimentConfig.load(str(B_CONFIG))
        result["b_serve"], b_run = phase("b_serve", b_serve_phase, dev, timer, args, tmp, b_cfg)
        result["b_train"] = phase("b_train", b_train_phase, dev, args, tmp, b_cfg)
        result["b_eval"] = phase("b_eval", b_eval_phase, dev, b_run)
        result["dec"] = phase("dec", dec_phase, dev, timer, args, tmp)
        result["workflows"] = phase("workflows", workflows_phase, dev, tmp, per_step, b_run)
        result["parallel"] = phase("parallel", parallel_phase, dev, args, tmp, per_step)
        result["seq"] = phase("seq", seq_phase, dev, timer, args, tmp, peaks)
        result["bf16"] = phase("bf16", bf16_phase, dev, timer, args, tmp, peaks, la_cfg, b_run)
        result["bf16_train"] = phase("bf16_train", bf16_train_phase, dev, timer, args, tmp,
                                     peaks, la_cfg)
        result["seq_bf16"] = phase("seq_bf16", seq_bf16_phase, dev, timer, args, tmp, peaks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["grads"] = phase("grads", grads_phase, dev, args.seed)
    result["train_profile"] = phase("train_profile", train_profile_phase, dev, args.seed)

    def per_launch_sum(rows, key, weight):
        return sum(r[key] * r[weight] for r in rows)

    w_fwd = f"per_forward_h{TRAIN_H}"
    w_serve = f"per_forward_h{H}"
    guide = result["guide"]
    wf = result["workflows"]
    par = result["parallel"]
    play = wf["playback"]["play"]
    kernels = [{
        "name": "conv_gn_mish", "route": "cuda", "status": "ported; matches its plain version",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/conv_gn_mish.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_block_kernel.py:104",
        "launches": result["train"]["conv_gn_mish_launches"],
        "launches_serve_request": result["serve"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in serve_rows + train_rows),
        # times: sums over one training micro-step's 33 forward launches (B 32, H 160)
        "ms": per_launch_sum(train_rows, "ms", w_fwd),
        "plain_ms": per_launch_sum(train_rows, "plain_ms", w_fwd),
        "bound_ms": per_launch_sum(train_rows, "bound_ms", w_fwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in train_rows)
        else "bytes",
        "library_ms": None, "composition_ms": per_launch_sum(train_rows, "composition_ms", w_fwd),
        "train_ms_over_composition": per_launch_sum(train_rows, "ms", w_fwd)
        / per_launch_sum(train_rows, "composition_ms", w_fwd),
        # the serving forward (B 16, H 64), as in the first slice
        "serve_forward": {k: per_launch_sum(serve_rows, k, w_serve)
                          for k in ("ms", "plain_ms", "bound_ms", "composition_ms")},
        "serve_ms_over_composition": per_launch_sum(serve_rows, "ms", w_serve)
        / per_launch_sum(serve_rows, "composition_ms", w_serve),
        "host_wrapper_us": result["serve"]["profile"]["conv_block_host"]["wrapper_us"],
        "launches_per_forward": per_step,
        # value guidance: the U-Net's 33 and the ValueFunction's 20 launches a step
        "launches_guide": guide["conv_gn_mish_launches"],
        "value_function_forward": guide["value_function_kernels"]["conv_gn_mish"],
        # phase 18: the seven workflows (T 1000 chains at B 16, two 2-step ones), compare's
        # U-Net run, and the sweep's 20 micro-steps
        "launches_workflows": {r["workflow"]: r["conv_gn_mish_launches"]
                               for r in wf["workflows"]},
        "launches_compare": wf["compare"]["conv_gn_mish_launches"],
        "launches_sweep": wf["sweep"]["conv_gn_mish_launches"],
        # phase 20: cli.train over NCCL (world size 1), and one multihost_check rank's step
        "launches_parallel_nccl_train": par["nccl_train"]["conv_gn_mish_launches"],
        "launches_parallel_multihost_check_rank":
            par["gloo_ranks"]["multihost_check"]["ranks"][0]["conv_gn_mish_launches"],
    }, {
        "name": "conv1d_weight_grad", "route": "cuda",
        "status": "ported; matches its plain version",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/conv1d_weight_grad.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_weight_grad.py:63",
        "launches": result["train"]["conv1d_weight_grad_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in wgrad_rows),
        "max_rel_err": max(r["max_rel_err"] for r in wgrad_rows),
        # times: sums over one training micro-step's 33 launches (B 32, H 160)
        "ms": per_launch_sum(wgrad_rows, "ms", "per_micro_step"),
        "plain_ms": per_launch_sum(wgrad_rows, "plain_ms", "per_micro_step"),
        "bound_ms": per_launch_sum(wgrad_rows, "bound_ms", "per_micro_step"),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in wgrad_rows)
        else "bytes",
        "library_ms": per_launch_sum(wgrad_rows, "library_ms", "per_micro_step"),
        "bound_3xtf32_ms": per_launch_sum(wgrad_rows, "bound_3xtf32_ms", "per_micro_step"),
        "paths": sorted({r["path"] for r in wgrad_rows + guide["b2_rows"]}),
        "launches_per_micro_step": per_step,
        # value training: one value_diffusion_loss step's 20 launches (B 16, H 64)
        "launches_value_step": guide["value_diffusion_loss"]["launches"]["conv1d_weight_grad"],
        "value_function_step": guide["value_function_kernels"]["conv1d_weight_grad"],
        "launches_sweep": wf["sweep"]["conv1d_weight_grad_launches"],
        "launches_parallel_nccl_train": par["nccl_train"]["conv1d_weight_grad_launches"],
        "launches_parallel_multihost_check_rank":
            par["gloo_ranks"]["multihost_check"]["ranks"][0]["conv1d_weight_grad_launches"],
    }]
    # B3 and B4: per launch at the serving shape (B 16, H 128, no masks)
    b3_main, b4_main = b3[0], b4[0]
    b3_train = next(r for r in b3 if r["masks"] == "keep")
    la_requests = result["la_serve"]["requests"]
    kernels += [{
        "name": "fused_qkv_local_attention", "route": "cuda",
        "status": "ported; matches its plain version",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/local_attention.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/fused_local_attention.py:284",
        "launches": la_requests[0]["fused_qkv_local_attention_launches"],
        "launches_requests": [r["fused_qkv_local_attention_launches"] for r in la_requests],
        "max_abs_err": max(r["max_abs_err"] for r in b3),
        "ms": b3_main["ms"], "plain_ms": b3_main["plain_ms"], "bound_ms": b3_main["bound_ms"],
        "bound_by": b3_main["bound_by"], "library_ms": None,
        "composition_ms": b3_main["composition_ms"],
        "shape": {"B": LA_B, "N": LA_H, "heads": la_cfg.model.n_heads,
                  "dim_head": la_cfg.model.dim_head, "window": la_cfg.model.window_size},
        # training: 6 launches a micro-step, each with the dropout keep mask (B 64, N 96)
        "launches_la_train": result["la_train"]["fused_qkv_local_attention_launches"],
        "train_keep_mask": {k: b3_train[k] for k in ("B", "N", "max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "composition_ratio",
                                                     "plan")},
    }, {
        "name": "local_attention_heads", "route": "cuda",
        "status": "ported; matches its plain version",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/local_attention.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/local_attention_kernel.py:113",
        # its own path: the front door windowed_attention (B4 is not on the serving path)
        "launches": result["la_serve"]["heads_path"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in b4),
        "ms": b4_main["ms"], "plain_ms": b4_main["plain_ms"], "bound_ms": b4_main["bound_ms"],
        "bound_by": b4_main["bound_by"], "library_ms": None,
        "composition_ms": b4_main["composition_ms"],
        "shape": {"B": LA_B, "heads": la_cfg.model.n_heads, "N": LA_H,
                  "dim_head": la_cfg.model.dim_head},
    }]
    # B5-B7: per launch at N 4096 (B6 at T 3 here; its main-path launch is T 20)
    phys_path = result["physics"]
    for name, row, source_line, launches, extra in (
            ("control_step", phys["control_step_reward"], 561,
             phys_path["steps_vs_rollout"]["control_step_launches"],
             {"launches_track_motions": phys_path["track_motions"]["control_step_launches"],
              # cli.play --physics in phase 18; null where mujoco does not import
              "launches_play": play["control_step_launches"] if play else None,
              "without_reward": {k: phys["control_step"][k]
                                 for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
              "host_wrapper_us": phys_path["profile"]["wrapper_host_us"]}),
            ("rollout", phys["rollout"], 830,
             phys_path["rollout"][f"n{PHYS_N}"]["rollout_launches"],
             {"launches_n65536": phys_path["rollout"][f"n{PHYS_BIG_N}"]["rollout_launches"],
              # phase 20: rollout_sharded, one launch at N / 2 on each of two ranks
              "launches_rollout_sharded_per_rank":
                  par["gloo_ranks"]["rollout_sharded"]["rollout_launches_per_rank"],
              "main_path_bound_ms": {f"n{n}": phys_path["rollout"][f"n{n}"]["bound_ms"]
                                     for n in (PHYS_N, PHYS_BIG_N)},
              "main_path_seconds": {f"n{n}": phys_path["rollout"][f"n{n}"]["best_seconds"]
                                    for n in (PHYS_N, PHYS_BIG_N)},
              "main_path_plans": {f"n{n}": phys_path["rollout"][f"n{n}"]["plan"]
                                  for n in (PHYS_N, PHYS_BIG_N)}}),
            ("tracking_reward", phys["tracking_reward"], 937,
             phys_path["steps_vs_rollout"]["tracking_reward_launches"],
             {"launches_note": "not on a path (B5's and B6's fused epilogue): one launch through "
                               "its front door tracking_reward_fused on the stepped state"})):
        err = row["max_abs_err"]
        kernels.append({
            "name": name, "route": "cuda", "status": "ported; matches its plain version",
            "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/humanoid_dynamics.cu",
            "replaces": f"deepmimic_diffusion_mujoco_tpu/physics/dynamics_pallas.py:{source_line}",
            "launches": launches,
            "max_abs_err": max(v for k, v in err.items() if k != "max_abs_qvel")
            if isinstance(err, dict) else err,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
            "shape": {k: row[k] for k in ("N", "T", "substeps") if k in row},
            "plan": row["plan"], "ptxas": row["ptxas"], **extra})
    # phase 21's kernels: K1 and K2 summed over one sharded forward's 33 launches (B 4, 512
    # rows a rank), K3 per launch at rank 0's slab
    seq = result["seq"]
    k3_main = seq["k3_rows"][0]
    # K1's yardstick is its composition; K2's library column is the unfused chain it replaces
    # (chan_merge, the elementwise chain, the add), timed as one composition
    yardstick = {"conv_gn_stats": "composition_ms", "gn_affine_mish": "unfused_ms",
                 "conv_gn_stats_bf16": "composition_ms", "gn_affine_mish_bf16": "unfused_ms"}
    for name, rows, launches in (
            ("conv_gn_stats", seq["k1_rows"], seq["unet_ddim"]["counts_per_rank"][0]),
            ("gn_affine_mish", seq["k2_rows"], seq["unet_ddim"]["counts_per_rank"][0])):
        kernels.append({
            "name": name, "route": "cuda", "status": "ported; matches its plain version",
            "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/conv_gn_mish.cu",
            "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_block_kernel.py:104",
            "form": "B1's horizon-sharded form", "launches": launches[name],
            "launches_per_rank": [c[name] for c in seq["unet_ddim"]["counts_per_rank"]],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: per_launch_sum(rows, k, "per_forward")
               for k in ("ms", "plain_ms", "bound_ms", yardstick[name])},
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows)
            else "bytes",
            "library_ms": (per_launch_sum(rows, "unfused_ms", "per_forward")
                           if yardstick[name] == "unfused_ms" else None),
            "shape": {"B": SEQ_B, "H_per_rank": SEQ_H // SEQ_RANKS, "launches_per_forward":
                      seq["per_forward"]}})
    kernels.append({
        "name": "local_attention_halo", "route": "cuda",
        "status": "ported; matches its plain version",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/local_attention.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/fused_local_attention.py:284",
        "form": "B3's halo entry",
        "launches": seq["local_attention"]["chain_counts_per_rank"][0]["local_attention_halo"],
        "launches_forward_per_rank": [c["local_attention_halo"] for c in
                                      seq["local_attention"]["forward_counts_per_rank"]],
        "max_abs_err": max(r["max_abs_err"] for r in seq["k3_rows"]),
        "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"], "bound_ms": k3_main["bound_ms"],
        "bound_by": k3_main["bound_by"], "library_ms": None,
        "composition_ms": k3_main["composition_ms"],
        "shape": {"B": SEQ_B, "Nh": k3_main["Nh"], "Nq": k3_main["Nq"]},
        "other_rank": {k: seq["k3_rows"][1][k] for k in ("Nh", "q0", "ms", "plain_ms",
                                                         "composition_ms", "bound_ms")}})
    # phase 22: B1's bf16 form summed over the 33 launches of the dim-128 serve forward (B 16 x
    # H 64), B3's bf16 entry per launch at B 16 x H 128; launches from the bf16 T 100 requests
    bf = result["bf16"]
    b1b, b3b = bf["b1_rows"], bf["b3_row"]
    kernels += [{
        "name": "conv_gn_mish_bf16", "route": "cuda", "status": "ported; matches its plain version",
        "form": "B1 at bf16 (bf16 x and w, float32 sums, GroupNorm and Mish; a bf16 output)",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/conv_gn_mish_bf16.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_block_kernel.py:104",
        "launches": bf["unet"]["request"]["bf16"]["launches"][B1_BF16],
        "launches_per_forward": bf["per_forward"],
        "launches_ddim50": bf["unet"]["ddim"]["bf16"]["launches"][B1_BF16],
        "max_abs_err": max(r["max_abs_err"] for r in b1b),
        "max_ulps": max(r["max_ulps"] for r in b1b),
        "max_ulps_large_values": max(r["max_ulps_large_values"] for r in b1b),
        **{k: per_launch_sum(b1b, k, "per_forward")
           for k in ("ms", "plain_ms", "bound_ms", "f32_kernel_ms", "composition_ms")},
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in b1b)
        else "bytes", "library_ms": None,
        "shape": {"B": B, "H": H, "launches_per_forward": bf["per_forward"]},
    }, {
        "name": "fused_qkv_local_attention_bf16", "route": "cuda",
        "status": "ported; matches its plain version",
        "form": "B3 at bf16 (a bf16 qkv, float32 inside, a bf16 context)",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/local_attention.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/fused_local_attention.py:284",
        "launches": bf["la"]["request"]["bf16"]["launches"][B3_BF16],
        "launches_ddim50": bf["la"]["ddim"]["bf16"]["launches"][B3_BF16],
        **{k: b3b[k] for k in ("max_abs_err", "max_ulps", "max_ulps_large_values", "ms",
                               "plain_ms", "bound_ms", "bound_by", "f32_kernel_ms",
                               "composition_ms")},
        "library_ms": None,
        "shape": {"B": LA_B, "N": LA_H, "heads": b3b["heads"], "dim_head": b3b["dim_head"],
                  "window": b3b["window"]},
    }]
    # phase 23: B2's bf16 form summed over one dim-128 micro-step's 33 launches (B 32 x H 160)
    # and a value step's 20 (B 16 x H 64), B3's bf16 entry with the keep mask per launch at
    # B 64 x N 96; launches from the bf16 cli.train runs
    bt = result["bf16_train"]
    b2b, b2v, b3k = bt["b2_rows"], bt["b2_value_rows"], bt["b3_keep_row"]
    kernels[-2]["launches_train"] = bt["unet"]["launches"][B1_BF16]
    kernels[-1]["launches_train"] = bt["la"]["launches"][B3_BF16]
    for key, rows in (("train_micro_step", bt["b1_rows"]), ("value_forward", bt["b1_value_rows"])):
        kernels[-2][key] = {k: per_launch_sum(rows, k, "per_forward")
                            for k in ("ms", "plain_ms", "bound_ms", "f32_kernel_ms",
                                      "composition_ms")}
    kernels += [{
        "name": "conv1d_weight_grad_bf16", "route": "cuda",
        "status": "ported; matches its plain version",
        "form": "B2 at bf16 (bf16 x and dy, float32 sums and dW)",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/conv1d_weight_grad_bf16.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_weight_grad.py:63",
        "launches": bt["unet"]["launches"][B2_BF16],
        "launches_per_micro_step": bt["per_micro_step"],
        "launches_value_step": bt["grads"]["value_diffusion_loss"]["launches"][B2_BF16],
        "max_abs_err": max(r["max_abs_err"] for r in b2b + b2v),
        "max_rel_err": max(r["max_rel_err"] for r in b2b + b2v),
        **{k: per_launch_sum(b2b, k, "per_step")
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "f32_kernel_ms")},
        "value_step": {k: per_launch_sum(b2v, k, "per_step")
                       for k in ("ms", "plain_ms", "bound_ms", "library_ms", "f32_kernel_ms")},
        "shapes_slower_than_library": [[r["B"], r["H"], r["cin"], r["cout"]]
                                       for r in b2b + b2v if not r["faster_than_library"]],
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in b2b)
        else "bytes", "library": "torch.nn.grad.conv1d_weight on the bf16 tensors (cuDNN)",
        "shape": {"B": TRAIN_B, "H": TRAIN_H, "launches_per_micro_step": bt["per_micro_step"]},
    }, {
        "name": "fused_qkv_local_attention_bf16_keep", "route": "cuda",
        "status": "ported; matches its plain version",
        "form": "B3 at bf16 with the dropout keep mask (float32 mask, P keep / keep_prob)",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/local_attention.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/fused_local_attention.py:284",
        "launches": bt["la"]["launches"][B3_BF16],
        "launches_with_keep_mask": bt["la"]["launches_with_keep_mask"],
        **{k: b3k[k] for k in ("max_abs_err", "max_ulps", "max_ulps_large_values", "ms",
                               "plain_ms", "bound_ms", "bound_by", "f32_kernel_ms",
                               "composition_ms")},
        "library_ms": None,
        "shape": {"B": LA_TRAIN_B, "N": LA_TRAIN_H, "heads": b3k["heads"],
                  "dim_head": b3k["dim_head"], "window": b3k["window"]},
    }]
    # phase 24: K1's and K2's bf16 forms summed over one sharded bf16 forward's 33 launches (B 4,
    # 512 rows a rank), K3's per launch at rank 0's slab, B4's per launch at B 16 x H 128
    sb = result["seq_bf16"]
    for name, rows, source in (
            ("conv_gn_stats_bf16", sb["k1_rows"], "conv_gn_mish_bf16.cu"),
            ("gn_affine_mish_bf16", sb["k2_rows"], "conv_gn_mish.cu")):
        kernels.append({
            "name": name, "route": "cuda", "status": "ported; matches its plain version",
            "form": "B1's horizon-sharded form at bf16",
            "source": f"deepmimic_diffusion_mujoco_tpu_torch/csrc/{source}",
            "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_block_kernel.py:104",
            "launches": sb["unet_ddim"]["counts_per_rank"][0][name],
            "launches_per_rank": [c[name] for c in sb["unet_ddim"]["counts_per_rank"]],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: per_launch_sum(rows, k, "per_forward")
               for k in ("ms", "plain_ms", "bound_ms", "f32_kernel_ms", yardstick[name])},
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows)
            else "bytes",
            "library_ms": (per_launch_sum(rows, "unfused_ms", "per_forward")
                           if yardstick[name] == "unfused_ms" else None),
            "shape": {"B": SEQ_B, "H_per_rank": SEQ_H // SEQ_RANKS,
                      "launches_per_forward": sb["per_forward"]}})
    k3b, b4b = sb["k3_rows"][0], sb["b4_rows"][0]
    kernels += [{
        "name": "local_attention_halo_bf16", "route": "cuda",
        "status": "ported; matches its plain version", "form": "B3's halo entry at bf16",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/local_attention.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/fused_local_attention.py:284",
        "launches": sb["local_attention"]["chain_counts_per_rank"][0]["local_attention_halo_bf16"],
        "launches_forward_per_rank": [c["local_attention_halo_bf16"] for c in
                                      sb["local_attention"]["forward_counts_per_rank"]],
        "max_abs_err": max(r["max_abs_err"] for r in sb["k3_rows"]),
        **{k: k3b[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "f32_kernel_ms",
                               "composition_ms", "max_ulps")},
        "library_ms": None, "shape": {"B": SEQ_B, "Nh": k3b["Nh"], "Nq": k3b["Nq"]},
    }, {
        "name": "local_attention_heads_bf16", "route": "cuda",
        "status": "ported; matches its plain version",
        "form": "B4 at bf16 (q * scale rounded to bf16, float32 rotary, scores and sums)",
        "source": "deepmimic_diffusion_mujoco_tpu_torch/csrc/local_attention.cu",
        "replaces": "deepmimic_diffusion_mujoco_tpu/ops/pallas/local_attention_kernel.py:113",
        # its own path: the front door windowed_attention (B4 is not on the serving path)
        "launches": sb["b4_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in sb["b4_rows"]),
        **{k: b4b[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "f32_kernel_ms",
                               "composition_ms", "max_ulps")},
        "library_ms": None,
        "shape": {"B": b4b["B"], "heads": b4b["heads"], "N": b4b["N"], "dim_head": b4b["dh"]},
    }]
    steps = {"unet": {"bf16": bt["unet"]["profile"], "float32": result["train_profile"]},
             "la": {"bf16": bt["la"]["profile"], "float32": result["la_train"]["profile"]}}
    emit({"phase": "bf16_train_vs_float32", **{
        m: {prec: {k: v[k] for k in ("ms_per_optimizer_step", "device_ms_per_step",
                                     "device_busy_share", "peak_memory_bytes")}
            for prec, v in pair.items()} for m, pair in steps.items()}})
    result.update(device={"kind": kind, "nvidia_smi": smi}, kernels=kernels)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)

    print(smi.splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
