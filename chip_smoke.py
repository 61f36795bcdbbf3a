#!/usr/bin/env python3
"""Chip smoke for sheeprl_tpu_torch: the quickest proof that the PyTorch port
starts, builds its kernels and serves a policy on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA device:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card   — the device's name and power limit (nvidia-smi);
2. build  — compile every hand-written kernel from ``sheeprl_tpu_torch/ops/csrc``
            (one nvcc per source, started together);
3. kernel — the LayerNorm-GRU kernel against its plain PyTorch version on the
            card, fp32 and bf16, at the DreamerV3-S shape (K=1024, H=512;
            B = 1, 8, 37, 128 for serving, 16 and 1024 for the training
            path's dynamic and imagination scans) and the XL shape (K=5120,
            H=4096; B = 8, 128 and DreamerV3-JEPA's 16, 1024), XS (K=512,
            H=256; B = 16, 1024), DreamerV2's (K=1000, H=600; B = 16, 800)
            and Plan2Explore-DV2's (K=800, H=400; B = 16, 800), with device
            times of the kernel (warm L2,
            and cold: rotating over copies of the inputs that exceed the
            50 MB L2), the plain version, the projection alone as one
            torch.matmul (a partial yardstick the port never calls) and the
            bound; then a sweep of the shapes the plan cuts differently
            (ragged H of DV1/DV2, M and L, row chunks, a K that needs
            padding), checked but not timed; then a check that the
            ``autograd.Function`` on the card carries a graph and gives all
            six inputs a gradient, at S B=16 and B=1024, fp32 and bf16, and
            XL B=16 and B=1024 in fp32 (in
            bf16 the gradients arrive in bf16, and in fp32 at fp32 masters
            through the cast); S B=64 and B=48 are the chunked scan's rows
            and its burn-in's at ``rssm_chunks=4``;
4. slice  — compose ``exp=dreamer_v3 env=dummy``, build DreamerV3-S on the card
            from a seed, write a run directory in the JAX package's checkpoint
            format, start the port's ``serve`` entry point and send /act
            traffic from concurrent sessions over HTTP; every reply must be
            200 with a valid one-hot action, the kernel's launch count must
            equal the number of policy steps the server ran, and one batch
            recomputed through the plain path must agree;
5. train  — ``run exp=dreamer_v3 env=dummy`` in-process at DreamerV3-S (batch
            16 x 64, horizon 15, fp32) under the default diagnostics with
            ``diagnostics.transfers=log``, through the async executor
            (``env.sync_env=False``), for at least 8 gradient steps: every
            metric finite, the world model, actor and critic all changed, the
            kernel's launches equal to what the run's counters predict, the
            journal's FLOPs, MFU, health gauges and card memory, the
            synchronizing calls a step, the checkpoint verified by its manifest
            and served by ``serve``'s loader; then one gradient step through the
            kernel and through the plain path from the same state, batch and
            noise, which must agree (the numerical check of the gradients
            through the kernel);
6. chunked — ``run`` at DreamerV3-S under ``fabric.precision=bf16-mixed
            algo.rssm_chunks=4 algo.rssm_chunk_burn_in=2 buffer.device=True
            buffer.checkpoint=True``, through ``env.executor=shared_memory``,
            and the default diagnostics for 16
            gradient steps, an async checkpoint mid-run: launches = 33 a
            gradient step (16 chunked steps at 64 rows, 2 burn-in steps at 48,
            15 imagination steps at 1024) + player + test steps, every metric
            finite, the journal as in phase 5, and a kernel-vs-plain bf16
            gradient step from one state within bf16 tolerances;
7. resume — ``run checkpoint.resume_from=<that run's directory>``: the
            counters, Ratio, Moments, Adam state (optax's layout) and the
            device ring restored as saved, and the run trains on;
8. eval   — ``eval checkpoint_path=<that checkpoint>``: the test reward;
8b. offline — the fp32 run of phase 5 exported its replay
            (``buffer.export=True``): the dataset verifies and equals the
            checkpoint's replay bit for bit, and ``python -m sheeprl_tpu_torch
            export <run dir>`` writes the same rows; ``run
            algo.offline.enabled=true`` at DreamerV3-S (batch 16 x 64,
            horizon 15, fp32) trains on it with no env, 8 gradient steps at
            79 kernel launches each (the counter read around the run), its
            checkpoints verified and marked offline; a resume from the first
            continues the offline counters; one offline step through the
            kernel and through the plain path from one state and the
            loader's first batch agree; the chunked ``bf16-mixed`` step (33
            launches a step) trains on phase 6's export from the device
            ring, which carries the ``rssm_*`` keys;
9. drill  — ``run`` under ``diagnostics=full`` with the presets' options at
            DreamerV3-S widths, sequences of 16: a poisoned batch under
            ``skip_update`` leaves params, Adam state, target critic and
            Moments bit-identical; a preemption writes a verified emergency
            checkpoint, journals ``preempted`` and exits 75 (held here as the
            expected end); ``/metrics`` and ``/healthz`` answer during the run;
            ``trace.json`` loads; a resume from the emergency checkpoint trains;
10. ppo   — ``run exp=ppo_atari env=dummy`` at its widths (NatureCNN on
            4x3x84x84, dense 512, 3 epochs of minibatches of 256), cut to 8
            envs x 128 steps and two iterations, through
            ``env.executor=shared_memory`` under the default diagnostics and
            the default logger (TensorBoard, which must import): finite
            losses and ``Time/sps_*``; a ``skip_update`` drill with every
            episode truncated at 4 steps (a poisoned iteration leaves the
            agent and Adam's state bit-identical; the truncations bootstrap);
            then a resume from its first checkpoint, ``eval`` of its last,
            ``serve`` of it to concurrent HTTP clients (requests/s, p50,
            p99); the same two iterations through each of ``sync``,
            ``async`` and ``shared_memory`` alike, the rollout's env steps/s
            by executor read in the second; and one minibatch update's
            stream time, device-busy time, launches, idle share and FLOPs
            (diagnostics off and on).  PPO runs no hand-written kernel;
11. jepa  — ``run exp=dreamer_v3_jepa env=dummy`` at its composed XL widths
            (``JEPA_OVERRIDES``: recurrent 4096, dense 1024, CNN multiplier
            96, 5 layers; batch 16 x 64, horizon 15, fp32, no decoder) under
            the default diagnostics: every metric finite, ``Loss/jepa_loss``
            included; the world model, actor, critic, projector and
            predictor changed; the kernel's launches as the counters predict;
            the checkpoint verified; a kernel-vs-plain gradient step from it,
            whose targets moved by exactly the EMA; a resume from it that
            trains on, ``eval``, and ``serve`` refusing it (as the JAX
            package does); the XL step's stream and busy time, idle share,
            launches, FLOPs and MFU;
12. p2e   — ``run exp=p2e_dv3_exploration env=dummy`` at its composed XL
            widths (``P2E_OVERRIDES``: DreamerV3-XL with the ``[rgb]``
            decoder, an ensemble of 8 MLPs of 1024 x 5, the intrinsic and
            extrinsic exploration critics; batch 16 x 64, horizon 15, fp32)
            under the default diagnostics: every metric finite, the
            per-critic ones included; the world model, ensembles, both
            actors, the task critic and each exploration critic changed; the
            kernel's launches as the counters predict for two imaginations a
            step (184); both checkpoints verified; a kernel-vs-plain XL
            exploration step from the last; a resume from the first that
            restores the seven trees, every optimizer's state and the Moments
            tree and trains on; ``run exp=p2e_dv3_finetuning`` from the last
            checkpoint and its replay (124 launches a step), the player on
            the exploration actor until the first gradient step and on the
            task actor after it, its checkpoint verified; ``eval`` of both
            checkpoints, ``serve`` refusing both (as the JAX package does);
            the XL exploration step's stream and busy time, idle share,
            launches, FLOPs, MFU and peak memory;
13. a2c   — ``run exp=a2c env=dummy`` (an MLP of 64 x 2 on ``state``,
            RMSprop) for 10 iterations: finite losses and ``Time/sps_*``; a
            resume from its mid-run checkpoint, ``eval``, ``serve`` to
            concurrent HTTP clients.  A2C runs no hand-written kernel;
14. sac   — with the continuous dummy env's actions bounded to ``[-1, 1]``
            in this process (``bounded_dummy_actions``; the runs use
            ``env.executor=sync``): ``run exp=sac env=dummy`` at its widths
            (``SAC_OVERRIDES``: hidden 256, 2 critics, batch 256), finite
            metrics and verified checkpoints, a resume from the mid-run one,
            ``eval``, ``serve`` to concurrent HTTP clients (finite greedy
            actions, the actor's own); ``exp=droq`` (``DROQ_OVERRIDES``, 20
            gradient steps a policy step) and ``exp=sac_ae``
            (``SAC_AE_OVERRIDES``: 64x64 ``rgb`` with a 3-frame stack and
            ``state``, actor and critics 1,024 wide, batch 128) trained,
            resumed, evaluated, and refused by ``serve``; one SAC and one
            SAC-AE train call on the card against the CPU from the same
            state, batch and noise; the SAC (health stats off and on), DroQ
            and SAC-AE gradient steps' stream and busy time, idle share,
            launches, FLOPs and MFU (``algos/sac/step_profile.py``); PPO at
            ``exp=ppo_atari``'s widths and A2C under
            ``fabric.precision=bf16-mixed``; SAC and DroQ offline with the
            conservative Q penalty (``cql_alpha=1``) on their runs' exports,
            two offline steps of each on the card against the CPU.  None of
            them runs a hand-written kernel: each path's ln_gru launches are
            counted, 0;
15. dv2   — ``run exp=dreamer_v2`` and ``exp=dreamer_v1`` at their widths
            (``DV2_OVERRIDES``, ``DV1_OVERRIDES``), each training after the
            env step's rows reached the replay, as the JAX loops do; DreamerV2
            through the kernel (65 launches a gradient step; the episode
            buffer; ``bf16-mixed``; a kernel-vs-plain step), resumed (the
            target counter restarting at 0), evaluated and refused by
            ``serve``; DreamerV1 with 0 launches; PPO-recurrent at its widths,
            served over HTTP sessions; their steps' and update's timers;
16. p2e-dv — ``run exp=p2e_dv2_exploration`` at its widths
            (``P2E_DREAMER_OVERRIDES``: 64x64 ``rgb``, CNN multiplier 48,
            dense and recurrent 400, an ensemble of 10 x 400 x 4; batch 16 x
            50, horizon 15, fp32) through the kernel in the dynamic scan and
            both imaginations (80 launches a step: 50 at 16 rows, 2 x 15 at
            800), every metric finite and the intrinsic reward positive, both
            checkpoints verified, a kernel-vs-plain exploration step from the
            last; a resume from the first; ``run exp=p2e_dv2_finetuning`` from
            the last and its replay (65 launches a step, the player switching
            actors at the first gradient step); ``eval`` of both, ``serve``
            refusing both; the same for ``exp=p2e_dv1_exploration`` (batch 50
            x 50, its plain GRU: 0 launches); both exploration steps' stream
            and busy time, idle share, launches, FLOPs and MFU;
17. timers — a gradient step's stream time, device-busy time, idle share
            and launches (``step_profile.time_gradient_steps``) for the fp32
            ``rssm_chunks=1`` step and the chunked bf16 one, each with the
            diagnostics off and then on (health stats, instrumented: its
            FLOPs and MFU; the fp32 one on the offline loader's first batch,
            the offline loop's step); the CPU's FLOP count of the fp32 step, equal to
            the card's; the journals' MFU, the syncs a step, ``ckpt_end``'s
            ``write_ms`` (async and blocking) and every run's kernel launches;
18. the ``kernels`` JSON line, then the result line.

It needs no network, writes only under ``build/`` in the checkout (and
removes the XL runs' checkpoints once their phases are done), and stops
every thread it starts.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (dense): device memory rate and, per input type,
# the arithmetic rate the kernel's work runs at (fp32 on the CUDA cores, bf16
# on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# max |kernel - plain| allowed.  fp32: both sum K products in fp32 in
# different orders, ~1e-6 at these shapes; 1e-4 leaves room at K=5120.
# bf16: the same fp32 arithmetic, rounded once to bf16 at the end; a sum-order
# difference can move that rounding by one bf16 step (2^-8 for |h'| < 1).
TOLERANCE = {"float32": 1e-4, "bfloat16": 8e-3}
S_SHAPE = (512, 512)  # (H, D): K = H + D = 1024
XL_SHAPE = (4096, 1024)  # K = 5120
XS_SHAPE = (256, 256)  # K = 512
DV2_SHAPE = (600, 400)  # exp=dreamer_v2: recurrent 600, dense 400; K = 1000
P2E_DV2_SHAPE = (400, 400)  # exp=p2e_dv2_exploration: recurrent 400, dense 400; K = 800
# S: serving widths, then the training path's (B = per_rank_batch_size 16 in
# the dynamic scan, T*B = 1024 rows in imagination; 64 = K*B rows of the
# chunked scan and 48 = (K-1)*B of its burn-in at rssm_chunks=4).  XL and
# XS: DreamerV3-JEPA's two presets (exp=dreamer_v3_jepa, _xs) at the same
# two training widths; XL also at serving widths
KERNEL_CASES = [(S_SHAPE, b) for b in (1, 8, 37, 128, 16, 1024, 64, 48)] + \
    [(XL_SHAPE, b) for b in (8, 128, 16, 1024)] + [(XS_SHAPE, b) for b in (16, 1024)] + \
    [(DV2_SHAPE, b) for b in (16, 800)] + [(P2E_DV2_SHAPE, b) for b in (16, 800)]
GRAD_CASES = [(S_SHAPE, b, d) for d in ("float32", "bfloat16") for b in (16, 1024)] + \
    [(XL_SHAPE, b, "float32") for b in (16, 1024)]
# the graph check: the Function's backward is autograd through the plain
# version on the saved inputs, so its gradients equal autograd through the
# plain version by construction, up to the order of the card's reductions
# (relative to the largest gradient).  It fails on a missing graph or
# gradient, not on a wrong kernel: the kernel-vs-plain gradient step does that
GRAD_TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-5}
# the training phase: batch 16 x 64, horizon 15 (exp=dreamer_v3); 4 envs, the
# buffer must hold 64 rows of each before the first sample, so learning
# starts at 256 policy steps and each later iteration owes 4 gradient steps
# It runs under the default diagnostics with the sync guard counting
# (``diagnostics.transfers=log``), logging every iteration: the journal's
# last interval is the steady state's MFU
TRAIN_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.sync_env=False", "diagnostics.transfers=log", "metric.log_every=4",
                   "env.capture_video=False", "run_name=chip_smoke", "algo.learning_starts=256",
                   "algo.total_steps=268", "buffer.size=1024", "checkpoint.every=100000", "metric.logger=null",
                   "buffer.checkpoint=True", "buffer.export=True", "seed=5"]
MIN_GRADIENT_STEPS = 8
# kernel vs plain gradient step from one state: the recurrent state agrees to
# ~1e-6 per step, so the losses and the gradients (read from Adam's first
# moments, 0.1 g after one step) agree to ~1e-5 relative.  Adam's first step
# moves a parameter by lr * g / (|g| + eps), lr <= 1e-4: where |g| is within
# a few eps of 0 its direction is the gradient's noise and two runs may
# differ by up to 2 lr; elsewhere they agree to far less than a fifth of a
# step (2e-5), which all but a 1e-4 fraction of the parameters must.  The
# largest difference is printed but not held: it can never exceed 2 lr.
STEP_METRIC_RTOL = 1e-3
STEP_GRAD_RTOL = 1e-3
STEP_PARAM_ATOL = 2e-5
STEP_PARAM_OUTLIERS = 1e-4
TIMED_STEPS = 3
# the chunked phase: the options the DV3 presets train with, at DreamerV3-S.
# A resumed run waits learning_starts (64 iterations of 4 envs) before it
# trains again, as the JAX package's does, and cannot change total_steps; so
# the run checkpoints at iteration 110 (policy step 440, the next would be
# 880 > 876) and runs to 219, at a replay ratio that gives it 16 gradient
# steps (4 before the checkpoint) and the resumed run about 4
CHUNKED_STEP_OPTIONS = ["fabric.precision=bf16-mixed", "algo.rssm_chunks=4", "algo.rssm_chunk_burn_in=2"]
CHUNKED_OPTIONS = CHUNKED_STEP_OPTIONS + ["buffer.device=True", "buffer.checkpoint=True"]
CHUNKED_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.executor=shared_memory", "env.capture_video=False",
                     "run_name=chip_smoke_chunked", "algo.learning_starts=256", "algo.total_steps=876",
                     "algo.replay_ratio=0.026", "buffer.size=1024", "checkpoint.every=440",
                     "checkpoint.save_last=False", "metric.logger=null", "buffer.export=True", "seed=5",
                     *CHUNKED_OPTIONS]
CHUNKED_GRADIENT_STEPS = 16
# the drills, under diagnostics=full with the presets' options at DreamerV3-S
# widths and a cut depth (sequences of 16, learning from policy step 64, one
# gradient step an iteration): a poisoned batch at iteration 20 under
# skip_update, a preemption at iteration 24 (a blocking emergency save, so
# its ckpt_end's write_ms is the blocking one), then a resume that trains
# from iteration 41 to 56
DRILL_NAN_ITER, DRILL_PREEMPT_ITER = 20, 24
DRILL_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "diagnostics=full", "env.capture_video=False",
                   "run_name=chip_smoke_drill", "algo.learning_starts=64", "algo.per_rank_sequence_length=16",
                   "algo.total_steps=224", "algo.replay_ratio=0.25", "buffer.size=1024", "checkpoint.every=100000",
                   "metric.logger=null", "metric.log_every=4", "seed=5", *CHUNKED_OPTIONS,
                   f"diagnostics.sentinel.inject_nan_iter={DRILL_NAN_ITER}",
                   f"diagnostics.resilience.inject_preempt_iter={DRILL_PREEMPT_ITER}",
                   "diagnostics.resilience.async_checkpoint=False"]
# kernel vs plain gradient step in bf16 from one state: both round the
# cell's fp32 result to bf16 once, so they differ by a bf16 step (2^-8) here
# and there, and a straight-through sample may flip where two classes tie in
# bf16.  The losses are held to 3e-2 relative, the gradient norms to 0.2,
# Adam's first moments of each tree as a whole (||kernel - plain|| /
# ||plain||) to 0.1, the critic's to 0.3 (its gradient is a small difference
# of two log-prob terms): the tolerances the CPU tests hold the port's bf16
# step to against the JAX package's (tests/test_torch_dv3_precision.py)
BF16_LOSS_RTOL, BF16_NORM_RTOL = 3e-2, 0.2
BF16_MOMENT_REL = {"world_model": 0.1, "actor": 0.1, "critic": 0.3}
# (H, D, B): DV1 (ragged last CTA), DV2, M, L, row chunks at S and XL, and a K
# whose rows are not 16-byte multiples
SWEEP_CASES = [(200, 400, 5), (600, 400, 37), (1024, 640, 8), (2048, 768, 128), (512, 512, 3000),
               (4096, 1024, 300), (64, 13, 9)]
# rotate over enough copies of (joint, w, h) to exceed the L2 twice over
COLD_BYTES = 100 * 2**20
SESSIONS = 32
REQUESTS_PER_SESSION = 10
# the PPO phases: exp=ppo_atari's widths on the dummy env (the card has no
# Atari): NatureCNN on rgb at 84x84 with 4 stacked frames (12 channels), a
# 512-unit dense layer, 3 epochs of minibatches of 256, clipped value loss,
# normalized advantages, annealed learning rate, max_grad_norm 0.5; cut only
# in depth to 8 envs x 128 steps a rollout and two iterations, a checkpoint
# and a log interval after each.  The discrete dummy's episodes end on their
# own (terminated) at their 5th step.  The main run goes through the
# shared-memory executor with the default logger (TensorBoard) and
# diagnostics
PPO_OVERRIDES = ["exp=ppo_atari", "env=dummy", "env.id=discrete_dummy", "env.num_envs=8", "algo.rollout_steps=128",
                 "algo.per_rank_batch_size=256", "algo.total_steps=2048", "checkpoint.every=1024",
                 "metric.log_every=1024", "run_name=chip_smoke_ppo", "seed=5"]
PPO_EPISODE_STEPS = 5
PPO_TIMED_UPDATES = 10
PPO_SERVE_CLIENTS, PPO_SERVE_REQUESTS = 16, 16
# the JEPA phase: exp=dreamer_v3_jepa at its composed XL widths (recurrent
# 4096, dense 1024, CNN multiplier 96, 5 layers, projector and predictor of
# 1024; batch 16 x 64, horizon 15, fp32, no decoder; 4 envs), under the
# default diagnostics, cut in depth: the buffer must hold 64 rows of each
# env before the first sample, so learning starts at policy step 256; the
# run checkpoints (with the replay) at iterations 66 and 132 and ends at
# 148, at a replay ratio that gives it a few gradient steps.  The run
# resumed from the first checkpoint waits learning_starts again (as the JAX
# package's does) and, its Ratio restored as saved, owes its first gradient
# step some 14 iterations after that
JEPA_OVERRIDES = ["exp=dreamer_v3_jepa", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_jepa",
                  "algo.learning_starts=256", "algo.total_steps=592", "algo.replay_ratio=0.022", "buffer.size=1024",
                  "buffer.checkpoint=True", "checkpoint.every=264", "checkpoint.save_last=False",
                  "metric.logger=null", "metric.log_every=16", "seed=5"]
JEPA_MIN_GRADIENT_STEPS = 4
JEPA_TIMED_STEPS = 3
# the P2E phase: exp=p2e_dv3_exploration at its composed XL widths
# (DreamerV3-XL with the [rgb] decoder, an ensemble of 8 MLPs of 1024 x 5,
# the intrinsic and extrinsic exploration critics; batch 16 x 64, horizon
# 15, fp32, 4 envs) under the default diagnostics, cut in depth as JEPA's
# run: learning from policy step 256, checkpoints (with the replay) at
# iterations 66 and 132, a replay ratio that owes about 6 gradient steps by
# iteration 148 and the run resumed from the first checkpoint one more.
# Finetuning goes on from the last checkpoint and its replay: 4 iterations
# of prefill, then the player acts with the exploration actor until the
# first gradient step (iteration 7 at this replay ratio) and with the task
# actor after it; about 5 gradient steps in 16 iterations
P2E_OVERRIDES = ["exp=p2e_dv3_exploration", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_p2e",
                 "algo.learning_starts=256", "algo.total_steps=592", "algo.replay_ratio=0.02", "buffer.size=1024",
                 "buffer.checkpoint=True", "checkpoint.every=264", "checkpoint.save_last=False", "metric.logger=null",
                 "metric.log_every=16", "seed=5"]
P2E_FINETUNE_OVERRIDES = ["exp=p2e_dv3_finetuning", "env=dummy", "env.capture_video=False",
                          "run_name=chip_smoke_p2e_finetuning", "algo.learning_starts=16", "algo.total_steps=64",
                          "algo.replay_ratio=0.1", "buffer.size=1024", "buffer.load_from_exploration=True",
                          "buffer.checkpoint=False", "checkpoint.every=100000", "checkpoint.save_last=True",
                          "metric.logger=null", "metric.log_every=16", "seed=5"]
P2E_MIN_GRADIENT_STEPS = 4
P2E_TIMED_STEPS = 3
# the A2C phase: exp=a2c (an MLP of 64 x 2 on `state`, RMSprop, the whole
# rollout in one step) on the dummy env, 4 envs x 5 steps, 10 iterations, a
# checkpoint after the 5th and the 10th
A2C_OVERRIDES = ["exp=a2c", "env=dummy", "env.id=discrete_dummy", "env.num_envs=4", "algo.total_steps=200",
                 "checkpoint.every=100", "metric.log_every=100", "metric.logger=null", "run_name=chip_smoke_a2c",
                 "seed=5"]
A2C_SERVE_CLIENTS, A2C_SERVE_REQUESTS = 8, 8
# the SAC family's phases, on the continuous dummy env with its actions
# bounded to [-1, 1] (bounded_dummy_actions) through env.executor=sync, each
# preset at its own widths, cut in depth, with its replay checkpointed:
# SAC (hidden 256, 2 critics, batch 256, replay ratio 1) on 4 envs, learning
# from policy step 256, 1,024 steps (about 770 gradient steps); DroQ
# (dropout 0.01, replay ratio 20) on 2 envs, 256 steps (about 3,900
# gradient steps; 256 rows, a batch for its offline run), a checkpoint at
# step 160 (its resume waits learning_starts again, to iteration 113, then
# trains 16 iterations) and at the end; SAC-AE (64x64 rgb with a 3-frame stack plus
# state, features 64, actor and critics 1,024, batch 128) on 2 envs, 192
# steps (about 130 gradient steps); SAC and SAC-AE checkpoint at half way
# and at the end.  SAC and DroQ export their replay (buffer.export)
SAC_OVERRIDES = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.executor=sync", "env.capture_video=False",
                 "env.num_envs=4", "algo.learning_starts=256", "algo.total_steps=1024", "buffer.size=1024",
                 "buffer.checkpoint=True", "buffer.export=True", "checkpoint.every=512", "metric.logger=null",
                 "metric.log_every=256", "run_name=chip_smoke_sac", "seed=5"]
DROQ_OVERRIDES = ["exp=droq", "env=dummy", "env.id=continuous_dummy", "env.executor=sync", "env.capture_video=False",
                  "env.num_envs=2", "algo.learning_starts=64", "algo.total_steps=256", "buffer.size=256",
                  "buffer.checkpoint=True", "buffer.export=True", "checkpoint.every=160",
                  "algo.mlp_keys.encoder=[state]",
                  "metric.logger=null", "metric.log_every=80", "run_name=chip_smoke_droq", "seed=5"]
SAC_AE_OVERRIDES = ["exp=sac_ae", "env=dummy", "env.id=continuous_dummy", "env.executor=sync",
                    "env.capture_video=False", "env.num_envs=2", "env.frame_stack=3", "algo.cnn_keys.encoder=[rgb]",
                    "algo.mlp_keys.encoder=[state]", "algo.learning_starts=64", "algo.total_steps=192",
                    "buffer.size=256", "buffer.checkpoint=True", "checkpoint.every=96", "metric.logger=null",
                    "metric.log_every=96", "run_name=chip_smoke_sac_ae", "seed=5"]
SAC_SERVE_CLIENTS, SAC_SERVE_REQUESTS = 8, 8
SAC_TIMED_STEPS = 10
# the DreamerV2 phases: exp=dreamer_v2's widths (64x64 rgb, CNN multiplier
# 48, dense 400 x 4 layers, recurrent 600, stochastic 32 x 32, hidden 600;
# batch 16 x 50, horizon 15, fp32) on the dummy env, 4 envs, cut in depth
# as JEPA's run: learning from policy step 256, checkpoints (with the
# replay) at iterations 66 and 132, the run to 148; at replay ratio 0.05
# about 16 gradient steps, and the run resumed from the first checkpoint
# trains again from iteration 131.  The episode-buffer run samples whole
# episodes of the multi-discrete dummy (128 steps, longer than the
# sequences of 50): it learns once every env has closed one (iteration
# 136).  The bf16-mixed run learns from iteration 64 of 76
DV2_OVERRIDES = ["exp=dreamer_v2", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_dv2",
                 "algo.learning_starts=256", "algo.total_steps=592", "algo.replay_ratio=0.05", "buffer.size=1024",
                 "buffer.checkpoint=True", "checkpoint.every=264", "checkpoint.save_last=False", "metric.logger=null",
                 "metric.log_every=16", "seed=5"]
DV2_EPISODE_OVERRIDES = ["exp=dreamer_v2", "env=dummy", "env.id=multidiscrete_dummy", "env.capture_video=False",
                         "run_name=chip_smoke_dv2_episode", "buffer.type=episode", "buffer.prioritize_ends=True",
                         "algo.learning_starts=540", "algo.total_steps=600", "algo.replay_ratio=0.1",
                         "buffer.size=4096", "checkpoint.every=100000", "checkpoint.save_last=True",
                         "metric.logger=null", "metric.log_every=64", "algo.run_test=False", "seed=5"]
DV2_BF16_OVERRIDES = ["exp=dreamer_v2", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_dv2_bf16",
                      "fabric.precision=bf16-mixed", "algo.learning_starts=256", "algo.total_steps=304",
                      "algo.replay_ratio=0.1", "buffer.size=1024", "checkpoint.every=100000",
                      "checkpoint.save_last=False", "metric.logger=null", "metric.log_every=16", "algo.run_test=False",
                      "seed=5"]
DV2_MIN_GRADIENT_STEPS = 4
# the DreamerV1 phase: exp=dreamer_v1's widths (64x64 rgb, CNN multiplier
# 32, dense 400, recurrent 200, stochastic 30, hidden 200; batch 50 x 50,
# horizon 15, fp32), cut in depth as DreamerV2's run
DV1_OVERRIDES = ["exp=dreamer_v1", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_dv1",
                 "algo.learning_starts=256", "algo.total_steps=592", "algo.replay_ratio=0.03", "buffer.size=1024",
                 "buffer.checkpoint=True", "checkpoint.every=264", "checkpoint.save_last=False", "metric.logger=null",
                 "metric.log_every=16", "seed=5"]
DV1_MIN_GRADIENT_STEPS = 4
DREAMER_TIMED_STEPS = 3
# the Plan2Explore-DV2 and DV1 phases: exp=p2e_dv2_exploration's widths
# (64x64 rgb, CNN multiplier 48, dense 400 x 4, recurrent 400, stochastic
# 32 x 32, hidden 400, an ensemble of 10 x 400 x 4; batch 16 x 50, horizon
# 15, fp32) and exp=p2e_dv1_exploration's (CNN multiplier 32, dense 400 x
# 4, recurrent 400, stochastic 60, hidden 400, the ensemble 10 x 400 x 4
# onto the embedding; batch 50 x 50, horizon 15, fp32) on the dummy env, 4
# envs, cut in depth as DreamerV2's run: learning from policy step 256,
# checkpoints (with the replay) at iterations 66 (before the first gradient
# step) and 132, the run to 148; at replay ratio 0.02 about 6 gradient
# steps, and the run resumed from the first checkpoint one more.
# Finetuning goes on from the last checkpoint and its replay: 4 iterations
# of prefill, the exploration actor until the first gradient step and the
# task actor after it; about 5 gradient steps in 16 iterations
P2E_DREAMER_OVERRIDES = {
    version: [f"exp=p2e_dv{version}_exploration", "env=dummy", "env.capture_video=False",
              f"run_name=chip_smoke_p2e_dv{version}", "algo.learning_starts=256", "algo.total_steps=592",
              "algo.replay_ratio=0.02", "buffer.size=1024", "buffer.checkpoint=True", "checkpoint.every=264",
              "checkpoint.save_last=False", "metric.logger=null", "metric.log_every=16", "seed=5"]
    for version in (2, 1)}
P2E_DREAMER_FINETUNE_OVERRIDES = {
    version: [f"exp=p2e_dv{version}_finetuning", "env=dummy", "env.capture_video=False",
              f"run_name=chip_smoke_p2e_dv{version}_finetuning", "algo.learning_starts=16", "algo.total_steps=64",
              "algo.replay_ratio=0.1", "buffer.size=1024", "buffer.load_from_exploration=True",
              "buffer.checkpoint=False", "checkpoint.every=100000", "checkpoint.save_last=True",
              "metric.logger=null", "metric.log_every=16", "seed=5"]
    for version in (2, 1)}
P2E_DREAMER_MIN_GRADIENT_STEPS = 4
# kernel launches a gradient step, (exploration, finetuning): P2E-DV2's 50
# dynamic steps at 16 rows and 15 imagined steps at 800 in each of two
# imaginations (one in the finetuning's DreamerV2 step), one launch a call;
# P2E-DV1's plain GRU none
P2E_DREAMER_LAUNCHES = {2: (80, 65), 1: (0, 0)}
P2E_DREAMER_TIMED_STEPS = 3
# the recurrent PPO phase: exp=ppo_recurrent's widths (16 envs x 512 rollout
# steps, sequences of 16 in 8 minibatches, 8 epochs, LSTM 64, encoder 64,
# adamw with clip 0.5) on the dummy env's `state` (CartPole needs
# gymnasium), two iterations, a checkpoint after each; the discrete dummy's
# episodes end at their 5th step, so every sequence holds resets
PPO_REC_OVERRIDES = ["exp=ppo_recurrent", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False",
                     "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]", "algo.total_steps=16384",
                     "checkpoint.every=8192", "metric.log_every=8192", "metric.logger=null",
                     "run_name=chip_smoke_ppo_recurrent", "seed=5"]
PPO_REC_SESSIONS, PPO_REC_ROUNDS = 2, 6
PPO_REC_TIMED_UPDATES = 5
# card vs CPU, two gradient steps from a trained checkpoint in fp32 (TF32
# off): SAC to 1e-4 relative; SAC-AE's four convolutions hold some 10^7
# ReLU units at batch 128, and a unit at its kink is on in one library and
# off in the other, so its metrics to 1e-3 and its weights to one Adam step
# (lr 1e-3)
CARD_CPU_METRIC_RTOL = {"sac": 1e-4, "sac_ae": 1e-3, "sac_offline": 1e-4, "droq_offline": 1e-4}
CARD_CPU_PARAM_ATOL = {"sac": 1e-4, "sac_ae": 1e-3, "sac_offline": 1e-4, "droq_offline": 1e-4}
# the offline phases: DreamerV3-S (exp=dreamer_v3's widths: batch 16 x 64,
# horizon 15, fp32) trains with no env on the fp32 training run's live
# export, 2 iterations of 4 gradient steps with a checkpoint after each (79
# kernel launches a step: 64 dynamic steps at 16 rows, 15 imagined at 1,024),
# then resumes from the first and continues the offline counters (4 more
# steps).  The dummy env's Discrete(2) actions are stored one-hot; the run
# declares them, so its agent is the online run's.  The chunked bf16 step
# trains 4 steps on the device ring's export (its rssm_* keys); SAC and DroQ
# at their widths (hidden 256, batch 256) with the conservative penalty on
# their phases' exports, 4 and 2 gradient steps
OFFLINE_DV3_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "algo.offline.enabled=true",
                         "algo.offline.actions_dim=[2]", "algo.offline.is_continuous=False", "algo.total_steps=8",
                         "algo.offline.grad_steps_per_iter=4", "checkpoint.every=4", "metric.logger=null",
                         "metric.log_every=4", "run_name=chip_smoke_offline", "seed=5"]
OFFLINE_CHUNKED_OVERRIDES = [*OFFLINE_DV3_OVERRIDES, *CHUNKED_STEP_OPTIONS, "algo.total_steps=4",
                             "algo.offline.grad_steps_per_iter=2", "run_name=chip_smoke_offline_chunked"]
OFFLINE_DV3_STEPS, OFFLINE_CHUNKED_STEPS = 8, 4
OFFLINE_SAC_OPTIONS = ["env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "algo.offline.enabled=true",
                       "algo.offline.cql_alpha=1.0", "algo.offline.action_low=-1", "algo.offline.action_high=1",
                       "algo.total_steps=4", "checkpoint.every=2", "metric.logger=null", "metric.log_every=2",
                       "seed=5"]
# gradient steps an iteration: SAC's 2 x 256 rows of the 1,024 its run
# stored; DroQ's run stored 256, one batch of each of its two streams
OFFLINE_SAC_GRAD_STEPS = {"sac": 2, "droq": 1}
# phase 17 times the fp32 step under the default diagnostics on the offline
# loader's first batch: the offline loop's step
OFFLINE_TIMER_NOTE = " (the offline step, on the offline loader's first batch)"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _ptxas_summary(report: str) -> list:
    """One line per compiled kernel instance: its template arguments,
    registers and spill bytes, from nvcc's ``-Xptxas -v`` output."""
    lines, name = [], None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '.*?kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", line)
        if entry:
            name = f"<{'float' if entry.group(1) == 'f' else 'bf16'},{entry.group(2)},{entry.group(3)}>"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            lines.append([name, None, int(spill.group(1))])
        regs = re.search(r"Used (\d+) registers", line)
        if regs and lines and lines[-1][0] == name and lines[-1][1] is None:
            lines[-1][1] = int(regs.group(1))
    return [f"{n}: {r} registers, {s} bytes spilled" for n, r, s in lines]


def _device_ms(fn, calls: int = 20, reps: int = 11) -> float:
    """Median device time of one call: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events.  Replaying a graph
    keeps host-side launch overhead out of the number.  ``fn`` is one thunk
    (the L2 stays warm, as it does between a policy's steps) or a list of
    thunks called in turn (each on its own copy of the inputs, so that the
    L2 is cold when a copy comes round again)."""
    import torch

    fns = fn if isinstance(fn, list) else [fn]
    calls = max(calls, len(fns))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for f in fns[:3]:
            f()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def measure_ln_gru(batch: int, hidden: int, in_dim: int, dtype_name: str, seed: int = 0, timed: bool = True) -> dict:
    """Kernel vs plain version on the card at one shape: max error (with and
    without a bias) and, if ``timed``, device times.  Launches made here do
    not count."""
    import torch

    from sheeprl_tpu_torch.ops import cuda_build, ln_gru
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference

    dtype = getattr(torch, dtype_name)
    k = hidden + in_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    joint = randn(batch, k).to(dtype)
    w = (randn(3 * hidden, k) / k**0.5).to(dtype)
    g = (1.0 + 0.1 * randn(3 * hidden)).to(dtype)
    beta = (0.1 * randn(3 * hidden)).to(dtype)
    h = torch.tanh(randn(batch, hidden)).to(dtype)
    bias = (0.1 * randn(3 * hidden)).to(dtype)
    errors = []
    for b in (None, bias):
        out = fused_layernorm_gru(joint, w, b, g, beta, h, 1e-3)
        ref = ln_gru_reference(joint, w, b, g, beta, h, 1e-3)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"ln_gru: non-finite output at B={batch} H={hidden} {dtype_name}")
        errors.append((out.float() - ref.float()).abs().max().item())
    err = max(errors)
    if err > TOLERANCE[dtype_name]:
        raise AssertionError(
            f"ln_gru disagrees with its plain version at B={batch} K={k} H={hidden} {dtype_name}: "
            f"max_abs_err {err} > {TOLERANCE[dtype_name]}"
        )
    plan = ln_gru._launch_plan(batch, k, hidden, joint.element_size(),
                               *ln_gru._device_limits(cuda_build.load("ln_gru"), joint.device))
    row = {"B": batch, "K": k, "H": hidden, "dtype": dtype_name, "max_abs_err": err,
           "tolerance": TOLERANCE[dtype_name],
           "plan": f"{len(plan.chunks)} launch(es) x {plan.ctas} CTAs of {plan.units} units, {plan.segs} segments "
                   f"x {plan.stages} stages, {plan.smem_bytes} B shared"}
    if not timed:
        return row
    size = torch.finfo(dtype).bits // 8
    n_bytes = (batch * k + 3 * hidden * k + 2 * 3 * hidden + 2 * batch * hidden) * size
    n_ops = 2 * batch * k * 3 * hidden
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    set_bytes = (joint.numel() + w.numel() + h.numel()) * size
    copies = [(joint.clone(), w.clone(), h.clone()) for _ in range(max(2, -(-COLD_BYTES // set_bytes)))]
    cold = [lambda c=c: fused_layernorm_gru(c[0], c[1], None, g, beta, c[2], 1e-3) for c in copies]
    return {
        **row,
        "ms": _device_ms(lambda: fused_layernorm_gru(joint, w, None, g, beta, h, 1e-3)),
        "ms_cold": _device_ms(cold),
        "plain_ms": _device_ms(lambda: ln_gru_reference(joint, w, None, g, beta, h, 1e-3)),
        "library_ms": _device_ms(lambda: torch.matmul(joint, w.t())),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def check_ln_gru_graph(batch: int, hidden: int, in_dim: int, dtype_name: str = "float32", seed: int = 2) -> float:
    """On the card: the Function's output carries an autograd graph and all
    six inputs get a finite gradient of their own dtype, equal to autograd
    through the plain version (see ``GRAD_TOLERANCE``); in bf16 the inputs
    are bf16 casts of fp32 masters, as a ``bf16-mixed`` loss makes them, and
    the masters get finite fp32 gradients through the cast.  Returns the
    largest error relative to the largest gradient."""
    import torch

    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference

    dtype = getattr(torch, dtype_name)
    k = hidden + in_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, device="cuda", generator=gen)).requires_grad_(True)

    masters = [randn(batch, k), randn(3 * hidden, k, scale=k**-0.5), randn(3 * hidden, scale=0.1),
               randn(3 * hidden, scale=0.1, shift=1.0), randn(3 * hidden, scale=0.1), randn(batch, hidden, scale=0.5)]
    inputs = [m.to(dtype) for m in masters]
    cot = torch.randn(batch, hidden, device="cuda", generator=gen).to(dtype)
    out = fused_layernorm_gru(*inputs, 1e-3)
    if out.grad_fn is None or out.dtype != dtype:
        raise AssertionError(f"ln_gru: the {dtype_name} output on the card carries no autograd graph or is {out.dtype}")
    grads = torch.autograd.grad(out, inputs + masters, cot)
    plain = [t.detach().clone().requires_grad_(True) for t in inputs]
    want = torch.autograd.grad(ln_gru_reference(*plain, 1e-3), plain, cot)
    torch.cuda.synchronize()
    worst = 0.0
    names = ("joint", "w", "b", "g", "beta", "h")
    for name, g, w in zip(names, grads, want):
        if g is None or g.dtype != dtype or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ln_gru: no finite {dtype_name} gradient for {name} at B={batch}")
        err = ((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30)).item()
        if err > GRAD_TOLERANCE[dtype_name]:
            raise AssertionError(f"ln_gru gradient of {name} at B={batch} {dtype_name}: relative error {err} > "
                                 f"{GRAD_TOLERANCE[dtype_name]}")
        worst = max(worst, err)
    for name, g in zip(names, grads[len(inputs):]):
        if g is None or g.dtype != torch.float32 or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ln_gru: no finite fp32 gradient reached the master of {name} at B={batch}")
    return worst


def _post(url: str, payload: dict, timeout: float = 60.0):
    req = urllib.request.Request(url + "/act", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"{}")


def run_slice(build_dir: Path, device_name: str = "cuda") -> dict:
    """Phase 4: DreamerV3-S served through the port's entry point."""
    import numpy as np
    import torch
    import yaml

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, gumbel_like
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.interop.flax_params import to_flax
    from sheeprl_tpu_torch.models import blocks
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference
    from sheeprl_tpu_torch.serving.loader import _actions_dim
    from sheeprl_tpu_torch.serving.server import ServeApp
    from sheeprl_tpu_torch.utils.checkpoint import save_state

    cfg = compose(["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "run_name=chip_smoke", "seed=5"])
    wm_cfg = cfg.algo.world_model
    widths = (wm_cfg.recurrent_model.recurrent_state_size, cfg.algo.dense_units, wm_cfg.representation_model.hidden_size,
              cfg.algo.mlp_layers, wm_cfg.encoder.cnn_channels_multiplier, wm_cfg.stochastic_size, wm_cfg.discrete_size)
    if widths != (512, 512, 512, 2, 32, 32, 32):
        raise AssertionError(f"exp=dreamer_v3 did not compose to DreamerV3-S: {widths}")
    env = make_env(cfg, cfg.seed, 0)()
    obs_space, action_space = env.observation_space, env.action_space
    env.close()
    actions_dim, is_continuous, _ = _actions_dim(action_space)
    agent = build_agent(actions_dim, is_continuous, cfg, obs_space, None, device_name)
    run_dir = build_dir / "run"
    ckpt = run_dir / "checkpoint" / "ckpt_0_0.ckpt"
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "config.yaml", "w") as fp:
        yaml.safe_dump(cfg.as_dict(), fp, sort_keys=False)
    save_state(str(ckpt), to_flax(*agent))
    del agent

    cfg, ckpt_path, device = cli.serve_config(
        [f"checkpoint_path={ckpt}", "serving.port=0", "serving.batch_buckets=[8,16,32,64,128]",
         "serving.sessions.capacity=64", "serving.max_delay_ms=5.0", f"fabric.accelerator={device_name}"]
    )
    if device.type != device_name:
        raise AssertionError(f"serve selected {device}, expected {device_name}")
    fused_layernorm_gru.launches = 0  # the main path starts here
    app = ServeApp(cfg, ckpt_path, device)
    try:
        host, port = app.start()
        url = f"http://{host}:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if resp.status != 200 or health.get("status") != "ok" or health.get("algo") != "dreamer_v3":
            raise AssertionError(f"/healthz: {resp.status} {health}")

        replies, latencies, lock = [], [], threading.Lock()

        def client(i: int) -> None:
            rng = np.random.default_rng(1000 + i)
            for j in range(REQUESTS_PER_SESSION):
                rgb = rng.integers(0, 256, size=(3, 64, 64), dtype=np.uint8)
                payload = {"obs": {"rgb": rgb.tolist()}, "session": f"s{i}",
                           "reset": (j == REQUESTS_PER_SESSION // 2 and i % 2 == 0), "greedy": (i + j) % 4 != 0}
                t0 = time.perf_counter()
                status, body = _post(url, payload)
                with lock:
                    latencies.append((time.perf_counter() - t0) * 1e3)
                    replies.append((status, body))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(SESSIONS)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client thread did not finish within 600 s")
        launches = fused_layernorm_gru.launches  # the main path ends here

        bad = [(s, b) for s, b in replies if s != 200]
        if bad or len(replies) != SESSIONS * REQUESTS_PER_SESSION:
            raise AssertionError(f"{len(bad)} of {len(replies)} replies were not 200; first: {bad[:1]}")
        n_actions = int(sum(actions_dim))
        for _, body in replies:
            a = np.asarray(body["action"], dtype=np.float64)
            if a.shape != (n_actions,) or not np.all(np.isfinite(a)):
                raise AssertionError(f"bad action {body['action']}")
            if np.abs(a - np.round(a)).max() > 1e-5 or round(float(a.sum())) != 1 or a.round().max() != 1:
                raise AssertionError(f"action is not one-hot: {body['action']}")
        stats = app.service.batcher.stats()
        steps = stats["dispatches_total"] + app.service.warmup_steps
        if launches != steps or launches == 0:
            raise AssertionError(
                f"ln_gru launched {launches} times for {stats['dispatches_total']} dispatches "
                f"+ {app.service.warmup_steps} warm-up steps"
            )

        # one batch of live sessions recomputed through the plain path on the
        # card, from the same slab state with the same noise
        service, handle = app.service, app.handle
        slots = sorted(service.sessions._lru.values())[:8]
        idx = torch.tensor(slots, dtype=torch.int64, device=device)
        state = {k: v[idx].clone() for k, v in service.sessions.slab.items()}
        rng = np.random.default_rng(7)
        obs = {"rgb": torch.from_numpy(rng.integers(0, 256, size=(len(slots), 3, 64, 64), dtype=np.uint8)).to(device)}
        is_first = torch.tensor([[float(i % 3 == 0)] for i in range(len(slots))], device=device)
        stoch, disc = wm_cfg.stochastic_size, wm_cfg.discrete_size
        noise = {"representation": gumbel_like(
            torch.empty(len(slots), stoch, disc, device=device), torch.Generator(device=device).manual_seed(3))}
        step = handle.make_state_step(True)
        kernel_out = step(handle.params, state, obs, is_first, None, noise)
        with mock.patch.object(blocks, "fused_layernorm_gru", ln_gru_reference):
            plain_out = step(handle.params, state, obs, is_first, None, noise)
        rec_err = (kernel_out[1]["recurrent"] - plain_out[1]["recurrent"]).abs().max().item()
        if rec_err > TOLERANCE["float32"]:
            raise AssertionError(f"recurrent state: kernel vs plain path max_abs_err {rec_err}")
        if not torch.equal(kernel_out[1]["stochastic"].round(), plain_out[1]["stochastic"].round()):
            raise AssertionError("posterior sample differs between the kernel and the plain path")
        if not torch.equal(kernel_out[0].round(), plain_out[0].round()):
            raise AssertionError("actions differ between the kernel and the plain path")
    finally:
        app.close()

    lat = sorted(latencies)
    widths_hist = stats["width_hist"]
    return {
        "requests": len(replies),
        "sessions": SESSIONS,
        "dispatches": stats["dispatches_total"],
        "warmup_steps": app.service.warmup_steps,
        "ln_gru_launches": launches,
        "width_hist": widths_hist,
        "main_width": int(max(widths_hist, key=widths_hist.get)),
        "requests_per_s": len(replies) / wall_s,
        "latency_p50_ms": lat[len(lat) // 2],
        "latency_p99_ms": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))],
        "plain_recompute_recurrent_max_abs_err": rec_err,
    }


def _timer_metrics(logged: list, where: str) -> dict:
    """The intervals' ``Time/sps_train`` and ``Time/sps_env_interaction``:
    every interval that trained has both, finite and positive."""
    import math

    trained = [m for m in logged if "Time/sps_train" in m]
    values = [m[k] for m in trained for k in ("Time/sps_train", "Time/sps_env_interaction")]
    if not trained or not all(math.isfinite(v) and v > 0 for v in values):
        raise AssertionError(f"{where}: the logged intervals lack finite Time/sps_* metrics: {logged}")
    return {k: [m[k] for m in trained] for k in ("Time/sps_train", "Time/sps_env_interaction")}


def _dv3_s_widths(cfg, precision: str = "32-true", sequence_length: int = 64) -> None:
    wm_cfg = cfg.algo.world_model
    widths = (wm_cfg.recurrent_model.recurrent_state_size, cfg.algo.dense_units, wm_cfg.representation_model.hidden_size,
              cfg.algo.mlp_layers, wm_cfg.encoder.cnn_channels_multiplier, wm_cfg.stochastic_size, wm_cfg.discrete_size,
              cfg.algo.world_model.reward_model.bins, cfg.algo.critic.bins, cfg.algo.per_rank_batch_size,
              cfg.algo.per_rank_sequence_length, cfg.algo.horizon, cfg.fabric.precision, cfg.env.screen_size)
    if widths != (512, 512, 512, 2, 32, 32, 32, 255, 255, 16, sequence_length, 15, precision, 64):
        raise AssertionError(f"the training config is not DreamerV3-S at batch 16 x {sequence_length}, horizon 15, "
                             f"{precision}: {widths}")


def _launch_chunks(rows: int, hidden: int, joint_dim: int, itemsize: int = 4) -> int:
    """Kernel launches of one cell call of ``rows`` rows."""
    import torch

    from sheeprl_tpu_torch.ops import cuda_build, ln_gru

    limits = ln_gru._device_limits(cuda_build.load("ln_gru"), torch.device("cuda"))
    return len(ln_gru._launch_plan(rows, joint_dim, hidden, itemsize, *limits).chunks)


def _launches(cfg, out: dict, imaginations: int = 1) -> tuple:
    """``(predicted launches of a run, launches a gradient step)`` from the
    run's counters: a gradient step's chunked scan (``T/K`` steps at ``K*B``
    rows), burn-in (``burn_in`` steps at ``(K-1)*B``) and ``imaginations``
    imaginations (``H`` steps at ``T*B`` each; P2E's exploration step runs
    two) in the compute dtype, and one fp32 call per player step (at the
    envs' width) and test step (one row)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import rssm_scan_spec
    from sheeprl_tpu_torch.parallel.precision import compute_dtype_of

    T, B, H = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, cfg.algo.horizon
    hidden = cfg.algo.world_model.recurrent_model.recurrent_state_size
    joint_dim = hidden + cfg.algo.world_model.recurrent_model.dense_units
    chunks, burn_in = rssm_scan_spec(cfg)
    item = 2 if "bfloat16" in str(compute_dtype_of(cfg)) else 4
    per_step = (T // chunks) * _launch_chunks(chunks * B, hidden, joint_dim, item) \
        + (burn_in * _launch_chunks((chunks - 1) * B, hidden, joint_dim, item) if chunks > 1 else 0) \
        + imaginations * H * _launch_chunks(T * B, hidden, joint_dim, item)
    predicted = (out["gradient_steps"] * per_step + out["player_steps"] * _launch_chunks(out["player_width"], hidden,
                                                                                        joint_dim)
                 + out["test_steps"] * _launch_chunks(1, hidden, joint_dim))
    return predicted, per_step


def _journal_of(log_dir: str) -> dict:
    """What a run's journal says of the diagnostics: the FLOPs counted per
    step, the last metric interval's MFU and TFLOP/s (and every interval's
    that trained), the synchronizing calls per gradient step under
    ``transfers=log``, the checkpoints' ``ckpt_end`` records and the event
    kinds."""
    from sheeprl_tpu_torch.diagnostics.journal import read_journal

    events = read_journal(str(Path(log_dir) / "journal.jsonl"))
    kinds = [e["event"] for e in events]
    if kinds[:1] != ["run_start"] or kinds[-1:] != ["run_end"]:
        raise AssertionError(f"journal of {log_dir}: starts {kinds[:1]}, ends {kinds[-1:]}")
    intervals = [e["metrics"] for e in events if e["event"] == "metrics" and "Telemetry/tflops_per_sec" in e["metrics"]]
    summary = next((e for e in events if e["event"] == "memory_summary"), {})
    telemetry = next((e for e in events if e["event"] == "telemetry_summary"), {})
    phases = telemetry.get("phase_seconds", {})
    syncs = [e for e in events if e["event"] == "host_transfer" and "syncs_per_dispatch" in e]
    return {
        "kinds": sorted(set(kinds)),
        "status": events[-1].get("status"),
        "flops_per_step": [e["flops_per_call"] for e in events if e["event"] == "telemetry_cost"],
        "mfu": [m.get("Telemetry/mfu") for m in intervals],
        "tflops_per_sec": [m["Telemetry/tflops_per_sec"] for m in intervals],
        "gauges": sorted({k for e in events if e["event"] == "metrics" for k in e["metrics"]}),
        "syncs_per_step": [(e["call"], e["syncs_per_dispatch"], e.get("sites", [])) for e in syncs],
        "host_transfers": summary.get("host_transfers"),
        "train_dispatches": summary.get("train_dispatches"),
        "ckpt_end": [{k: e.get(k) for k in ("blocking", "write_ms", "bytes", "status", "verified")}
                     for e in events if e["event"] == "ckpt_end"],
        "checkpoint_span_s": phases.get("checkpoint"),
        "recompiles": telemetry.get("recompiles"),
        "events": events,
    }


def _check_diagnostics_journal(journal: dict, where: str, health: bool = True) -> None:
    """The default diagnostics' record: metrics with Telemetry/* and (with
    ``health``: P2E's step computes none, as the JAX package's) the health
    gauges, the card's memory, the checkpoints, FLOPs and MFU."""
    need_kinds = {"run_start", "metrics", "ckpt_begin", "ckpt_end", "checkpoint", "telemetry_cost",
                  "memory_breakdown", "run_end"}
    need_gauges = {"Telemetry/mfu", "Telemetry/tflops_per_sec", "Telemetry/hbm_bytes_in_use",
                   "Telemetry/goodput", "Telemetry/phase_pct/train"}
    if health:
        need_gauges |= {"Telemetry/health/grad_norm", "Telemetry/health/update_ratio", "Telemetry/health/dead_frac"}
    missing = (need_kinds - set(journal["kinds"])) | (need_gauges - set(journal["gauges"]))
    if missing or journal["status"] != "completed" or not journal["flops_per_step"] or not journal["mfu"]:
        raise AssertionError(f"{where}: the journal lacks {sorted(missing)}, status {journal['status']}, FLOPs "
                             f"{journal['flops_per_step']}, MFU {journal['mfu']}")
    if not all(e["status"] == "ok" and e["verified"] for e in journal["ckpt_end"]):
        raise AssertionError(f"{where}: a checkpoint write failed: {journal['ckpt_end']}")


def _train_noise(cfg, actions_dim, gen, device: str = "cuda"):
    """Every draw of one gradient step, pre-drawn on the card."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import gumbel_like
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import rssm_scan_spec

    T, B, H = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, cfg.algo.horizon
    S, D = cfg.algo.world_model.stochastic_size, cfg.algo.world_model.discrete_size

    def gumbel(*shape):
        return gumbel_like(torch.empty(*shape, device=device), gen)

    noise = {
        "dynamic": (gumbel(T, B, S, D), gumbel(T, B, S, D)),
        "imagination": gumbel(H, T * B, S, D),
        "actor": [[gumbel(T * B, d) for d in actions_dim] for _ in range(H + 1)],
    }
    chunks, burn_in = rssm_scan_spec(cfg)
    if chunks > 1 and burn_in:
        noise["burn_in"] = (gumbel(burn_in, (chunks - 1) * B, S, D), gumbel(burn_in, (chunks - 1) * B, S, D))
    return noise


def _kernel_vs_plain_step(cfg, agent_state, spaces_, batch, noise, device: str = "cuda", keep=None):
    """One gradient step from one state, batch and noise, through the kernel
    and through the plain path, with the agent and step of ``cfg``'s
    algorithm: ``[(metrics, {optimizer: Adam first moments}, params,
    kept)]`` for each; ``kept`` is the agent and copies of the tensors
    ``keep(agent)`` names, taken before the step (None without ``keep``)."""
    import importlib

    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers
    from sheeprl_tpu_torch.models import blocks
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference
    from sheeprl_tpu_torch.utils.registry import find_algorithm

    family = importlib.import_module(find_algorithm(cfg.algo.name)["module"])
    actions_dim, is_continuous, obs_space = spaces_
    results = []
    for plain in (False, True):
        agent = family.build_agent(actions_dim, is_continuous, cfg, obs_space, agent_state, device)
        optimizers = make_optimizers(cfg, agent)
        step = family.make_train_step(agent, optimizers, cfg, is_continuous)
        kept = None if keep is None else (agent, [t.detach().clone() for t in keep(agent)])
        with mock.patch.object(blocks, "fused_layernorm_gru", ln_gru_reference if plain else fused_layernorm_gru):
            _, metrics = step(agent.initial_moments(device), batch, 0.02, None, noise)
        torch.cuda.synchronize()
        grads = {name: torch.cat([opt.state[p]["exp_avg"].reshape(-1) for p in agent.parameters_of(name)])
                 for name, opt in optimizers.items()}
        params = torch.cat([p.detach().reshape(-1) for name in optimizers for p in agent.parameters_of(name)])
        results.append((metrics.cpu().numpy(), grads, params, kept if not plain else None))
        del step, optimizers
    return results


def run_train(build_dir: Path, device_name: str = "cuda") -> dict:
    """Phase 5: DreamerV3-S trains on the card through ``run``."""
    device = device_name
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.interop.flax_params import to_flax
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.serving.loader import _actions_dim, agent_state_from_checkpoint, load_policy
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = TRAIN_OVERRIDES + [f"root_dir={(build_dir / 'train').resolve()}", f"fabric.accelerator={device}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg)
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here

    rows = out["metric_rows"]
    if out["gradient_steps"] < MIN_GRADIENT_STEPS or rows.shape != (out["gradient_steps"], len(METRIC_ORDER)):
        raise AssertionError(f"{out['gradient_steps']} gradient steps, metric rows {rows.shape}")
    sps = _timer_metrics(out["logged"], "train")
    if not np.isfinite(rows).all():
        raise AssertionError(f"non-finite training metrics: {rows}")
    T, H = cfg.algo.per_rank_sequence_length, cfg.algo.horizon
    predicted, per_step = _launches(cfg, out)
    if launches != predicted:
        raise AssertionError(
            f"ln_gru launched {launches} times; the run predicts {predicted} ({out['player_steps']} player steps, "
            f"{out['gradient_steps']} gradient steps x (T={T} + H={H}), {out['test_steps']} test steps)"
        )

    journal = _journal_of(out["log_dir"])
    _check_diagnostics_journal(journal, "train")
    if journal["train_dispatches"] != out["gradient_steps"] or journal["host_transfers"] is None:
        raise AssertionError(f"train: {journal['train_dispatches']} guarded dispatches for {out['gradient_steps']} "
                             f"gradient steps")

    # every trained tree moved away from its seeded initialization
    ckpt = out["checkpoints"][-1]
    if verify_checkpoint(ckpt) != (True, "verified"):
        raise AssertionError(f"train: checkpoint {ckpt} does not verify by its manifest: {verify_checkpoint(ckpt)}")
    state = load_state(ckpt)
    env = make_env(cfg, cfg.seed, 0)()
    obs_space, action_space = env.observation_space, env.action_space
    env.close()
    actions_dim, is_continuous, _ = _actions_dim(action_space)
    initial = to_flax(*build_agent(actions_dim, is_continuous, cfg, obs_space, None, "cpu"))
    changed = {}
    for tree in ("world_model", "actor", "critic"):
        before = dict(_leaves(initial[tree]))
        after = dict(_leaves(state[tree]))
        changed[tree] = sum(not np.array_equal(before[p], after[p]) for p in before)
        if changed[tree] == 0:
            raise AssertionError(f"training left every parameter of {tree} unchanged")

    # the checkpoint serves through serve's loader on the card
    serve_cfg, ckpt_path, _ = cli.serve_config([f"checkpoint_path={ckpt}"])
    handle = load_policy(serve_cfg, ckpt_path, device)
    n = 3
    gen = torch.Generator(device=device).manual_seed(9)
    obs = {"rgb": torch.randint(0, 256, (n, 3, cfg.env.screen_size, cfg.env.screen_size), device=device, generator=gen,
                                dtype=torch.uint8)}
    st = {k: torch.zeros((n,) + shape, device=device) for k, (shape, _) in handle.state_spec.items()}
    actions, _ = handle.make_state_step(True)(handle.params, st, obs, torch.ones((n, 1), device=device), None)
    torch.cuda.synchronize()
    if actions.shape != (n, sum(actions_dim)) or not torch.equal(actions.sum(-1), torch.ones(n, device=device)):
        raise AssertionError(f"the trained checkpoint served a bad greedy action: {actions}")

    # one gradient step from the same state, batch and noise, through the
    # kernel and through the plain path
    batch = synthetic_batch(cfg, actions_dim, gen, device)
    noise = _train_noise(cfg, actions_dim, gen, device)
    (m_kernel, g_kernel, p_kernel, _), (m_plain, g_plain, p_plain, _) = _kernel_vs_plain_step(
        cfg, agent_state_from_checkpoint(state), (actions_dim, is_continuous, obs_space), batch, noise, device)
    metric_err = float(np.max(np.abs(m_kernel - m_plain) / np.maximum(np.abs(m_plain), 1e-3)))
    grad_err = max(((g_kernel[k] - g_plain[k]).abs().max() / g_plain[k].abs().max()).item() for k in g_plain)
    diff = (p_kernel - p_plain).abs()
    param_err, outliers = diff.max().item(), (diff > STEP_PARAM_ATOL).float().mean().item()
    if (not np.isfinite(m_kernel).all() or metric_err > STEP_METRIC_RTOL or grad_err > STEP_GRAD_RTOL
            or outliers > STEP_PARAM_OUTLIERS):
        raise AssertionError(
            f"kernel vs plain gradient step: metrics relative error {metric_err} (tol {STEP_METRIC_RTOL}), "
            f"gradients relative error {grad_err} (tol {STEP_GRAD_RTOL}), share of params off by more than "
            f"{STEP_PARAM_ATOL}: {outliers} (tol {STEP_PARAM_OUTLIERS}), params max_abs_err {param_err}; "
            f"kernel {m_kernel}, plain {m_plain}"
        )
    return {
        "gradient_steps": out["gradient_steps"],
        "player_steps": out["player_steps"],
        "test_steps": out["test_steps"],
        "policy_steps": out["policy_steps"],
        "ln_gru_launches": launches,
        "launches_per_gradient_step": per_step,
        "changed_leaves": changed,
        "final_metrics": dict(zip(METRIC_ORDER, rows[-1].tolist())),
        "step_metric_rel_err": metric_err,
        "step_grad_rel_err": grad_err,
        "step_param_max_abs_err": param_err,
        "step_param_outliers": outliers,
        "checkpoint": ckpt,
        "journal": journal,
        "sps": sps,
    }


def _moment_rel(kernel: dict, plain: dict) -> dict:
    return {k: ((kernel[k] - plain[k]).norm() / plain[k].norm().clamp_min(1e-30)).item() for k in plain}


def run_chunked(build_dir: Path, device_name: str = "cuda") -> dict:
    """Phase 6: DreamerV3-S trains through ``run`` with the options the DV3
    presets train with (``CHUNKED_OPTIONS``) and checkpoints mid-run."""
    device = device_name
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.serving.loader import _actions_dim, agent_state_from_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = CHUNKED_OVERRIDES + [f"root_dir={(build_dir / 'chunked').resolve()}", f"fabric.accelerator={device}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg, "bf16-mixed")
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here

    rows = out["metric_rows"]
    sps = _timer_metrics(out["logged"], "chunked")
    if out["gradient_steps"] != CHUNKED_GRADIENT_STEPS or not np.isfinite(rows).all():
        raise AssertionError(f"{out['gradient_steps']} gradient steps (expected {CHUNKED_GRADIENT_STEPS}), "
                             f"metrics {rows}")
    predicted, per_step = _launches(cfg, out)
    if launches != predicted or per_step != 64 // 4 + 2 + 15:
        raise AssertionError(f"ln_gru launched {launches} times; the run predicts {predicted} "
                             f"({out['gradient_steps']} gradient steps x {per_step} + {out['player_steps']} player "
                             f"steps + {out['test_steps']} test steps)")
    (ckpt,) = out["checkpoints"]
    journal = _journal_of(out["log_dir"])
    _check_diagnostics_journal(journal, "chunked")
    if [e["blocking"] for e in journal["ckpt_end"]] != [False] or verify_checkpoint(ckpt) != (True, "verified"):
        raise AssertionError(f"chunked: the checkpoint was not one verified async write: {journal['ckpt_end']}")
    state = load_state(ckpt)
    if set(state["rb"]) != {"buffer", "pos", "filled", "added"} or "rssm_recurrent" not in state["rb"]["buffer"]:
        raise AssertionError(f"the checkpoint's replay is not the device ring with stored states: {sorted(state['rb'])}")

    # one bf16 gradient step from the checkpoint's state, through the kernel
    # and through the plain path
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous, _ = _actions_dim(env.action_space)
    spaces_ = (actions_dim, is_continuous, env.observation_space)
    env.close()
    gen = torch.Generator(device=device).manual_seed(11)
    batch = synthetic_batch(cfg, actions_dim, gen, device)
    noise = _train_noise(cfg, actions_dim, gen, device)
    (m_kernel, g_kernel, _, _), (m_plain, g_plain, _, _) = _kernel_vs_plain_step(
        cfg, agent_state_from_checkpoint(state), spaces_, batch, noise, device)
    rel = np.abs(m_kernel - m_plain) / np.maximum(np.abs(m_plain), 1e-3)
    loss_err, norm_err = float(rel[:8].max()), float(rel[8:].max())
    moments = _moment_rel(g_kernel, g_plain)
    if (not np.isfinite(m_kernel).all() or loss_err > BF16_LOSS_RTOL or norm_err > BF16_NORM_RTOL
            or any(moments[k] > BF16_MOMENT_REL[k] for k in moments)):
        raise AssertionError(
            f"bf16 kernel vs plain gradient step: losses relative error {loss_err} (tol {BF16_LOSS_RTOL}), grad "
            f"norms {norm_err} (tol {BF16_NORM_RTOL}), Adam first moments {moments} (tol {BF16_MOMENT_REL}); "
            f"kernel {m_kernel}, plain {m_plain}")
    return {
        "gradient_steps": out["gradient_steps"],
        "player_steps": out["player_steps"],
        "test_steps": out["test_steps"],
        "policy_steps": out["policy_steps"],
        "ln_gru_launches": launches,
        "launches_per_gradient_step": per_step,
        "final_metrics": dict(zip(METRIC_ORDER, rows[-1].tolist())),
        "step_loss_rel_err": loss_err,
        "step_norm_rel_err": norm_err,
        "step_moment_rel_err": moments,
        "checkpoint": ckpt,
        "run_dir": str(Path(ckpt).parent.parent),
        "overrides": overrides,
        "journal": journal,
        "sps": sps,
    }


def run_resume(chunked: dict) -> dict:
    """Phase 7: ``run checkpoint.resume_from=<run dir>`` picks the chunked
    run's checkpoint, restores it as saved, and trains on."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer
    from sheeprl_tpu_torch.interop.flax_params import optax_state, param_spec
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.utils.checkpoint import load_state
    from sheeprl_tpu_torch.utils.utils import Ratio

    saved = load_state(chunked["checkpoint"])
    restored = {}
    load_learner_state = dv3.load_learner_state
    ring_load, ratio_load = DeviceSequentialReplayBuffer.load_state_dict, Ratio.load_state_dict

    def spy_learner(state, agent, optimizers, device):
        moments = load_learner_state(state, agent, optimizers, device)
        spec = param_spec(*agent)
        restored["adam"] = {n: _optax_leaves(optax_state(o, spec[n])) for n, o in optimizers.items()}
        restored["moments"] = {k: float(v) for k, v in moments.items()}
        return moments

    def spy_ring(self, state):
        out = ring_load(self, state)
        restored["rb"] = self.state_dict()
        return out

    def spy_ratio(self, state):
        out = ratio_load(self, state)
        restored["ratio"] = self.state_dict()
        return out

    overrides = chunked["overrides"] + [f"checkpoint.resume_from={chunked['run_dir']}", "checkpoint.save_last=True"]
    cfg = compose(overrides)
    with mock.patch.object(dv3, "load_learner_state", spy_learner), \
            mock.patch.object(DeviceSequentialReplayBuffer, "load_state_dict", spy_ring), \
            mock.patch.object(Ratio, "load_state_dict", spy_ratio):
        fused_layernorm_gru.launches = 0  # the main path starts here
        out = cli.run(overrides)
        torch.cuda.synchronize()
        launches = fused_layernorm_gru.launches  # the main path ends here

    problems = []
    if out["start_iter"] != saved["iter_num"] + 1:
        problems.append(f"start_iter {out['start_iter']} after iteration {saved['iter_num']}")
    if restored.get("ratio") != saved["ratio"]:
        problems.append(f"Ratio {restored.get('ratio')} != {saved['ratio']}")
    if restored.get("moments") != {k: float(v) for k, v in saved["moments"].items()}:
        problems.append(f"Moments {restored.get('moments')} != {saved['moments']}")
    for name, entry in saved["opt_states"].items():
        # optax's (EmptyState, (ScaleByAdamState(count, mu, nu), EmptyState))
        for path, value in _optax_leaves(entry).items():
            if not np.array_equal(restored["adam"][name].get(path), value):
                problems.append(f"Adam {name} {path}")
    for k, v in saved["rb"]["buffer"].items():
        if not np.array_equal(restored["rb"]["buffer"][k], v):
            problems.append(f"replay key {k}")
    for k in ("pos", "filled", "added"):
        if not np.array_equal(restored["rb"][k], saved["rb"][k]):
            problems.append(f"replay {k}")
    predicted, _ = _launches(cfg, out)
    if out["gradient_steps"] < 1 or not np.isfinite(out["metric_rows"]).all() or launches != predicted:
        problems.append(f"{out['gradient_steps']} gradient steps after resuming, {launches} launches (predicted "
                        f"{predicted}), metrics {out['metric_rows']}")
    final = load_state(out["checkpoints"][-1])
    if all(np.array_equal(a, b) for (_, a), (_, b) in zip(_leaves(final["world_model"]),
                                                          _leaves(saved["world_model"]))):
        problems.append("the resumed run left the world model as saved")
    if problems:
        raise AssertionError(f"resume from {chunked['run_dir']}: " + "; ".join(problems[:10]))
    return {"resumed_from": str(cfg.checkpoint.resume_from), "start_iter": out["start_iter"],
            "gradient_steps": out["gradient_steps"], "player_steps": out["player_steps"],
            "test_steps": out["test_steps"], "ln_gru_launches": launches,
            "adam_entries": sum(len(_optax_leaves(e)) for e in saved["opt_states"].values()),
            "replay_rows": int(np.asarray(saved["rb"]["filled"]).sum())}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _state_of(agent, optimizers, moments) -> dict:
    """Copies of everything ``skip_update`` reverts: the four modules'
    parameters, every Adam state tensor, the Moments."""
    out = {f"{name}.{i}": p.detach().clone() for name in ("world_model", "actor", "critic", "target_critic")
           for i, p in enumerate(getattr(agent, name).parameters())}
    for name, opt in optimizers.items():
        for i, st in enumerate(opt.state.values()):
            out.update({f"adam.{name}.{i}.{k}": v.detach().clone() for k, v in st.items()})
    out.update({f"moments.{k}": v.detach().clone() for k, v in moments.items()})
    return out


def run_drill(build_dir: Path, device_name: str = "cuda") -> dict:
    """Phase 7: ``run`` under ``diagnostics=full`` (``DRILL_OVERRIDES``):
    the poisoned batch under ``skip_update`` leaves every state bit-identical
    on the card; the preemption drill saves a verified emergency checkpoint,
    journals ``preempted`` and raises ``PreemptedExit`` (75), held here as
    the expected end; ``/metrics`` and ``/healthz`` answer while it runs;
    its ``trace.json`` loads; then a resume from that checkpoint trains on,
    its launches as counted."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.diagnostics import Diagnostics
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.resilience.preemption import PREEMPTED_EXIT_CODE, PreemptedExit

    port = _free_port()
    overrides = DRILL_OVERRIDES + [f"root_dir={(build_dir / 'drill').resolve()}", f"fabric.accelerator={device_name}",
                                   f"diagnostics.telemetry.http.port={port}"]
    _dv3_s_widths(compose(overrides), "bf16-mixed", 16)

    poisoned, drills = [], []
    make_train_step, maybe_inject_nan = dv3.make_train_step, Diagnostics.maybe_inject_nan

    def spy_inject(self, iter_num, tree):
        out = maybe_inject_nan(self, iter_num, tree)
        if out is not tree:
            poisoned.append(iter_num)  # a host flag: nothing waits for the card
        return out

    def spy_make(agent, optimizers, cfg_, is_continuous):
        step = make_train_step(agent, optimizers, cfg_, is_continuous)

        def checked(moments, batch, tau, generator=None, noise=None):
            if not poisoned:
                return step(moments, batch, tau, generator, noise)
            iter_num = poisoned.pop()
            before = _state_of(agent, optimizers, moments)
            moments, metrics = step(moments, batch, tau, generator, noise)
            after = _state_of(agent, optimizers, moments)
            drills.append({"iter": iter_num, "tensors": len(before),
                           "finite_metrics": bool(torch.isfinite(metrics[:len(dv3.METRIC_ORDER)]).any()),
                           "changed": [k for k in before if not torch.equal(before[k], after[k])]})
            return moments, metrics

        checked.health_names, checked.metric_order = step.health_names, step.metric_order
        return checked

    scraped, stop = {}, threading.Event()

    def scrape() -> None:
        while not stop.is_set() and "metrics" not in scraped:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
                    text = resp.read().decode()
                if "sheeprl_run_state" in text and "sheeprl_train_flops_total" in text:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
                        scraped["healthz"] = json.loads(resp.read())
                    scraped["metrics"] = text
            except (OSError, ValueError):
                pass
            stop.wait(0.5)

    scraper = threading.Thread(target=scrape, name="chip-smoke-scraper", daemon=True)
    scraper.start()
    exit_code = None
    try:
        with mock.patch.object(dv3, "make_train_step", spy_make), \
                mock.patch.object(Diagnostics, "maybe_inject_nan", spy_inject):
            cli.run(overrides)
    except PreemptedExit as exc:
        exit_code = exc.code
    finally:
        stop.set()
        scraper.join(timeout=30)
    if exit_code != PREEMPTED_EXIT_CODE:
        raise AssertionError(f"the preemption drill ended with exit code {exit_code}, not {PREEMPTED_EXIT_CODE}")
    if not drills or any(d["changed"] or d["finite_metrics"] for d in drills):
        raise AssertionError(f"skip_update drill: {drills[:2]}")
    if "metrics" not in scraped or scraped["healthz"].get("status") != "ok":
        raise AssertionError(f"/metrics was not scraped during the run: {sorted(scraped)}")

    (journal_path,) = sorted((build_dir / "drill").resolve().rglob("journal.jsonl"))
    run_dir = journal_path.parent
    journal = _journal_of(str(run_dir))
    events = journal["events"]
    preempted = [e for e in events if e["event"] == "preempted"]
    divergence = [e for e in events if e["event"] == "divergence" and e.get("kind") == "nonfinite_update"]
    if (journal["status"] != "preempted" or len(preempted) != 1 or not preempted[0]["snapshot_durable"]
            or not divergence or not journal["ckpt_end"] or not journal["ckpt_end"][-1]["blocking"]):
        raise AssertionError(f"drill journal: status {journal['status']}, preempted {preempted}, divergence "
                             f"{divergence[:1]}, ckpt_end {journal['ckpt_end']}")
    ckpt = preempted[0]["path"]
    if verify_checkpoint(ckpt) != (True, "verified"):
        raise AssertionError(f"the emergency checkpoint does not verify: {verify_checkpoint(ckpt)}")
    trace = json.loads((run_dir / "trace.json").read_text())
    spans = {e.get("name") for e in trace if e.get("ph") == "X"}
    if not {"rollout", "train", "buffer-sample", "env_wait", "checkpoint"} <= spans:
        raise AssertionError(f"trace.json spans: {sorted(spans)}")

    resume = overrides[:-1] + ["diagnostics.telemetry.http.enabled=False", f"checkpoint.resume_from={run_dir}"]
    resume = [o for o in resume if "inject_" not in o]
    resume_cfg = compose(resume)
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(resume)
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here
    predicted, per_step = _launches(resume_cfg, out)
    if (out["start_iter"] != DRILL_PREEMPT_ITER + 1 or out["gradient_steps"] < 1 or launches != predicted
            or not np.isfinite(out["metric_rows"]).all()):
        raise AssertionError(f"resume after the preemption: start_iter {out['start_iter']}, {out['gradient_steps']} "
                             f"gradient steps, {launches} launches (predicted {predicted})")
    resumed_journal = _journal_of(out["log_dir"])
    return {
        "exit_code": exit_code,
        "skip_update": drills,
        "emergency_checkpoint": ckpt,
        "blocking_write_ms": journal["ckpt_end"][-1]["write_ms"],
        "checkpoint_span_s": journal["checkpoint_span_s"],
        "metrics_lines": sum(1 for line in scraped["metrics"].splitlines() if line.startswith("sheeprl_")),
        "trace_events": len(trace),
        "journal_kinds": journal["kinds"],
        "resume_start_iter": out["start_iter"],
        "resume_gradient_steps": out["gradient_steps"],
        "resume_player_steps": out["player_steps"],
        "resume_test_steps": out["test_steps"],
        "ln_gru_launches": launches,
        "launches_per_gradient_step": per_step,
        "resume_mfu": resumed_journal["mfu"],
    }


def run_eval(chunked: dict) -> dict:
    """Phase 8: ``eval checkpoint_path=<the chunked run's checkpoint>``."""
    import math

    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru

    fused_layernorm_gru.launches = 0  # the main path starts here
    reward = cli.evaluation([f"checkpoint_path={chunked['checkpoint']}"])
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here
    if not math.isfinite(reward) or launches < 1:
        raise AssertionError(f"eval: test reward {reward}, {launches} ln_gru launches")
    return {"test_reward": reward, "ln_gru_launches": launches}


def _ppo_widths(cfg) -> None:
    widths = (cfg.env.screen_size, cfg.env.frame_stack, cfg.algo.encoder.cnn_features_dim, cfg.algo.dense_units,
              cfg.algo.mlp_layers, cfg.algo.update_epochs, cfg.algo.per_rank_batch_size, cfg.algo.clip_vloss,
              cfg.algo.normalize_advantages, cfg.algo.anneal_lr, cfg.algo.max_grad_norm,
              list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder), cfg.fabric.precision)
    if widths != (84, 4, 512, 512, 1, 3, 256, True, True, True, 0.5, ["rgb"], [], "32-true"):
        raise AssertionError(f"the PPO config is not exp=ppo_atari's widths: {widths}")


def run_ppo(build_dir: Path, executor: str, compare: bool = False, tensorboard: bool = False,
            device_name: str = "cuda") -> dict:
    """``run exp=ppo_atari env=dummy`` on the card through one executor
    (``PPO_OVERRIDES``), under the default diagnostics; with
    ``tensorboard`` the default logger writes its event files, else
    ``metric.logger=null``; with ``compare`` no checkpoint and no test
    episode, so that each executor's runs differ in nothing else.  Every
    iteration's losses and the timer's ``Time/sps_*`` must be finite, every
    episode ``PPO_EPISODE_STEPS`` long."""
    import math

    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import compose

    root = (build_dir / (f"ppo_{executor}_compare" if compare else f"ppo_{executor}")).resolve()
    overrides = PPO_OVERRIDES + [f"env.executor={executor}", f"root_dir={root}", f"fabric.accelerator={device_name}"]
    if compare:
        overrides += ["algo.run_test=False", "checkpoint.every=0"]
    if tensorboard:
        # the default logger; it fails loudly where the card cannot import it
        import torch.utils.tensorboard  # noqa: F401

        overrides += [f"metric.logger.root_dir={root / 'tensorboard'}"]
    else:
        overrides += ["metric.logger=null"]
    cfg = compose(overrides)
    _ppo_widths(cfg)
    t0 = time.perf_counter()
    out = cli.run(overrides)
    wall_s = time.perf_counter() - t0
    iterations = int(cfg.algo.total_steps) // int(cfg.env.num_envs * cfg.algo.rollout_steps)
    rows = out["metric_rows"]
    if out["iterations"] != iterations or rows.shape != (iterations, 4) or not np.isfinite(rows).all():
        raise AssertionError(f"ppo {executor}: {out['iterations']} iterations, metric rows {rows}")
    sps = _timer_metrics(out["logged"], f"ppo {executor}")
    for m in out["logged"]:
        losses = [m.get(k) for k in ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")]
        if not all(v is not None and math.isfinite(v) for v in losses) or \
                m.get("Game/ep_len_avg") != float(PPO_EPISODE_STEPS):
            raise AssertionError(f"ppo {executor}: logged interval {m}")
    report = {"iterations": out["iterations"], "policy_steps": out["policy_steps"], "sps": sps, "wall_s": wall_s,
              "final_losses": dict(zip(("policy", "value", "entropy", "grad_norm"), rows[-1].tolist())),
              "checkpoints": out["checkpoints"], "overrides": overrides, "test_reward": out["test_reward"],
              "value_ev": out["health_rows"].get("value_ev", np.zeros(0)).tolist()}
    if tensorboard:
        events = sorted((root / "tensorboard").rglob("events.out.tfevents*"))
        if not events or events[0].stat().st_size == 0:
            raise AssertionError(f"ppo: the TensorBoard logger wrote no event file under {root / 'tensorboard'}")
        report["tensorboard_events"] = str(events[0].relative_to(build_dir.resolve()))
        journal = _journal_of(out["log_dir"])
        _check_diagnostics_journal(journal, f"ppo {executor}")
        report["journal"] = journal
    return report


def run_ppo_drill(build_dir: Path, device_name: str = "cuda") -> dict:
    """PPO's sentinel drill on the card: ``skip_update`` (Adam
    ``capturable``, its step and the annealed learning rate on the device)
    with the second iteration's batch poisoned: every minibatch of it
    counted non-finite and skipped, the agent and Adam's state ending
    bit-identical to the first iteration's checkpoint.  Every episode is
    truncated at its 4th step (``env.max_episode_steps=4``), before the
    dummy ends it, so each rollout bootstraps truncations from
    ``final_obs``."""
    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = PPO_OVERRIDES + ["env.executor=sync", f"root_dir={(build_dir / 'ppo_drill').resolve()}",
                                 f"fabric.accelerator={device_name}", "metric.logger=null", "algo.run_test=False",
                                 "diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=skip_update",
                                 "diagnostics.sentinel.inject_nan_iter=2", "env.max_episode_steps=4"]
    out = cli.run(overrides)
    if not out["logged"] or any(m.get("Game/ep_len_avg") != 4.0 for m in out["logged"]):
        raise AssertionError(f"ppo drill: episodes not truncated at 4 steps: {out['logged']}")
    updates = out["updates_per_iteration"]
    first, last = (load_state(p) for p in out["checkpoints"])
    # optax's (EmptyState, (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)))
    trees = [(first["agent"], last["agent"])] + [(first["opt_state"][1][0][i], last["opt_state"][1][0][i])
                                                 for i in (0, 1, 2)]
    moved = [p for a, b in trees for (p, x), (_, y) in zip(_leaves_any(a), _leaves_any(b))
             if not np.array_equal(x, y)]
    if out["nonfinite_updates"].tolist() != [0.0, float(updates)] or moved:
        raise AssertionError(f"ppo drill: non-finite updates {out['nonfinite_updates']} (expected [0, {updates}]), "
                             f"changed by the skipped iteration: {moved[:5]}")
    return {"skipped": updates, "tensors": sum(len(_leaves_any(a)) for a, _ in trees)}


def _leaves_any(tree, prefix=""):
    """``[(path, array)]`` of a dict or a scalar."""
    import numpy as np

    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _leaves_any(v, f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def run_ppo_resume(ppo: dict) -> dict:
    """``run checkpoint.resume_from=<the first iteration's checkpoint>``:
    the counters and Adam's state restored, the second iteration trained."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    first = ppo["checkpoints"][0]
    saved = load_state(first)
    overrides = [o for o in ppo["overrides"] if not o.startswith("metric.logger")] + [
        "metric.logger=null", f"checkpoint.resume_from={first}", "algo.run_test=False"]
    restored = {}
    adam_load = torch.optim.Adam.load_state_dict

    def spy(self, state_dict):
        restored["steps"] = sorted({float(v["step"]) for v in state_dict["state"].values()})
        return adam_load(self, state_dict)

    with mock.patch.object(torch.optim.Adam, "load_state_dict", spy):
        out = cli.run(overrides)
    count = int(np.asarray(saved["opt_state"][1][0][0]))
    if (out["start_iter"] != saved["iter_num"] + 1 or out["iterations"] != 1 or restored.get("steps") != [count]
            or count != out["updates_per_iteration"] or not np.isfinite(out["metric_rows"]).all()):
        raise AssertionError(f"ppo resume from {first}: start_iter {out['start_iter']}, {out['iterations']} "
                             f"iterations, Adam steps restored {restored.get('steps')} (saved count {count}), "
                             f"metrics {out['metric_rows']}")
    _timer_metrics(out["logged"], "ppo resume")
    return {"resumed_from": first, "start_iter": out["start_iter"], "adam_count": count,
            "final_losses": out["metric_rows"][-1].tolist()}


def run_ppo_eval(ppo: dict) -> float:
    import math

    from sheeprl_tpu_torch import cli

    reward = cli.evaluation([f"checkpoint_path={ppo['checkpoints'][-1]}", "metric.logger=null"])
    if not math.isfinite(reward):
        raise AssertionError(f"ppo eval: test reward {reward}")
    return reward


def run_ppo_serve(ppo: dict, device_name: str = "cuda") -> dict:
    """``serve`` the PPO checkpoint over HTTP: concurrent clients, every
    reply 200 with an action of the env's action space; one row's greedy
    reply equal to the agent's greedy action computed directly."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.serving.server import ServeApp

    cfg, ckpt_path, device = cli.serve_config(
        [f"checkpoint_path={ppo['checkpoints'][-1]}", "serving.port=0", "serving.batch_buckets=[8,16,32,64]",
         "serving.max_delay_ms=5.0", f"fabric.accelerator={device_name}"])
    app = ServeApp(cfg, ckpt_path, device)
    try:
        host, port = app.start()
        url = f"http://{host}:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if health.get("algo") != "ppo" or health["models"]["default"]["stateful"] is not False:
            raise AssertionError(f"ppo /healthz: {health}")
        shape = app.handle.obs_spec["rgb"][0]
        replies, latencies, lock = [], [], threading.Lock()
        probe = np.random.default_rng(99).integers(0, 256, size=shape).astype(np.float32)

        def client(i: int) -> None:
            rng = np.random.default_rng(2000 + i)
            payloads = [json.dumps({"obs": {"rgb": rng.integers(0, 256, size=shape).tolist()},
                                    "greedy": (i + j) % 2 == 0}) for j in range(PPO_SERVE_REQUESTS)]
            for body in payloads:
                req = urllib.request.Request(url + "/act", data=body.encode(), headers={"Content-Type":
                                                                                        "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=120) as resp:
                    status, reply = resp.status, json.loads(resp.read())
                with lock:
                    latencies.append((time.perf_counter() - t0) * 1e3)
                    replies.append((status, reply))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(PPO_SERVE_CLIENTS)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads):
            raise AssertionError("a PPO serve client did not finish within 600 s")
        bad = [r for r in replies if r[0] != 200]
        actions = np.asarray([r[1]["action"] for r in replies], dtype=np.float64)
        if bad or len(replies) != PPO_SERVE_CLIENTS * PPO_SERVE_REQUESTS or actions.shape[1:] != (1,) or \
                not np.isin(actions, (0.0, 1.0)).all():
            raise AssertionError(f"ppo serve: {len(bad)} bad replies of {len(replies)}, actions {actions[:4]}")
        status, reply = _post(url, {"obs": {"rgb": probe.tolist()}, "greedy": True})
        obs = {"rgb": torch.from_numpy(probe[None]).to(device)}
        direct = app.handle.make_step(True)(app.handle.params, obs, None).cpu().numpy()[0]
        if status != 200 or reply["action"] != direct.tolist():
            raise AssertionError(f"ppo serve: greedy reply {status} {reply} != the agent's {direct}")
        stats = app.service.batcher.stats()
    finally:
        app.close()
    lat = sorted(latencies)
    return {"requests": len(replies), "clients": PPO_SERVE_CLIENTS, "requests_per_s": len(replies) / wall_s,
            "latency_p50_ms": lat[len(lat) // 2],
            "latency_p99_ms": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))],
            "dispatches": stats["dispatches_total"], "width_hist": stats["width_hist"]}


def run_ppo_timers(device_name: str = "cuda") -> dict:
    """One PPO minibatch update at exp=ppo_atari's widths (batch 256): its
    stream time, device-busy time, launches and idle share, with the
    diagnostics off and on (the health stats), in turns off, on, on, off;
    and its FLOPs."""
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import time_gradient_steps
    from sheeprl_tpu_torch.algos.ppo.step_profile import profiled_update

    out = {}
    for turn, diagnostics in enumerate((False, True, True, False)):
        step, batch, info = profiled_update([], device_name, diagnostics)
        timing = time_gradient_steps(step, None, batch, None, PPO_TIMED_UPDATES, warmup=3, profile=True)
        out[f"{'diagnostics' if diagnostics else 'off'}_{turn}"] = {
            "step_ms": timing["step_ms"], "busy_ms": timing["busy_ms"], "idle_share": timing["idle_share"],
            "launches": timing["launches"], "flops": info["flops"], "params": info["params"],
            "top": sorted(((v[1] / PPO_TIMED_UPDATES / 1e3, k[:60]) for k, v in timing["kernels"].items()),
                          reverse=True)[:3]}
        del step, batch
    return out


def _jepa_xl_widths(cfg) -> None:
    wm_cfg = cfg.algo.world_model
    widths = (wm_cfg.recurrent_model.recurrent_state_size, cfg.algo.dense_units, wm_cfg.encoder.cnn_channels_multiplier,
              cfg.algo.mlp_layers, wm_cfg.representation_model.hidden_size, wm_cfg.stochastic_size,
              wm_cfg.discrete_size, cfg.algo.jepa_proj_dim, cfg.algo.jepa_hidden, cfg.algo.per_rank_batch_size,
              cfg.algo.per_rank_sequence_length, cfg.algo.horizon, cfg.fabric.precision, cfg.env.screen_size,
              list(cfg.algo.cnn_keys.decoder) + list(cfg.algo.mlp_keys.decoder), cfg.env.num_envs)
    if widths != (4096, 1024, 96, 5, 1024, 32, 32, 1024, 1024, 16, 64, 15, "32-true", 64, [], 4):
        raise AssertionError(f"the JEPA config is not exp=dreamer_v3_jepa's XL widths at batch 16 x 64: {widths}")


def _jepa_ema_pairs(agent):
    """Each EMA target of the JEPA heads beside its online tensor."""
    wm, heads = agent.world_model, agent.jepa
    online = [p for m in (wm.cnn_encoder, wm.mlp_encoder, heads.projector) if m is not None for p in m.parameters()]
    return list(heads.target_encoder.parameters()) + list(heads.target_projector.parameters()), online


def run_jepa(build_dir: Path, device_name: str = "cuda") -> dict:
    """DreamerV3-JEPA trains on the card through ``run`` at its composed XL
    widths (``JEPA_OVERRIDES``): every metric finite, ``Loss/jepa_loss``
    logged; the world model, actor, critic, projector and predictor all
    changed; the kernel's launches as the run's counters predict; the
    journal of the default diagnostics; both checkpoints verified by their
    manifests; then one gradient step from the last through the kernel and
    through the plain path, which must agree, the kernel path's
    targets moved by exactly the EMA of the new online weights."""
    device = device_name
    import math

    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.algos.dreamer_v3_jepa.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.serving.loader import _actions_dim
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = JEPA_OVERRIDES + [f"root_dir={(build_dir / 'jepa').resolve()}", f"fabric.accelerator={device}"]
    cfg = compose(overrides)
    _jepa_xl_widths(cfg)
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here

    rows = out["metric_rows"]
    sps = _timer_metrics(out["logged"], "jepa")
    jepa_logged = [m["Loss/jepa_loss"] for m in out["logged"] if "Loss/jepa_loss" in m]
    if (out["gradient_steps"] < JEPA_MIN_GRADIENT_STEPS or rows.shape[1] != 12 or not np.isfinite(rows).all()
            or not jepa_logged or not all(math.isfinite(v) for v in jepa_logged)):
        raise AssertionError(f"jepa: {out['gradient_steps']} gradient steps, metric rows {rows}, Loss/jepa_loss "
                             f"logged {jepa_logged}")
    predicted, per_step = _launches(cfg, out)
    if launches != predicted:
        raise AssertionError(f"jepa: ln_gru launched {launches} times; the run predicts {predicted} "
                             f"({out['gradient_steps']} gradient steps x {per_step} + {out['player_steps']} player "
                             f"steps + {out['test_steps']} test steps)")
    journal = _journal_of(out["log_dir"])
    _check_diagnostics_journal(journal, "jepa")
    # the mid-run checkpoint, for the resume (a run resumed from it trains
    # again), and the last, trained one
    mid, ckpt = out["checkpoints"][0], out["checkpoints"][-1]
    for path in (mid, ckpt):
        if verify_checkpoint(path) != (True, "verified"):
            raise AssertionError(f"jepa: checkpoint {path} does not verify by its manifest: {verify_checkpoint(path)}")
    state = load_state(ckpt)
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous, _ = _actions_dim(env.action_space)
    spaces_ = (actions_dim, is_continuous, env.observation_space)
    env.close()
    initial = build_agent(actions_dim, is_continuous, cfg, spaces_[2], None, "cpu").trees()
    changed = {}
    for tree, sub in (("world_model", None), ("actor", None), ("critic", None), ("jepa", "projector"),
                      ("jepa", "predictor")):
        before = dict(_leaves(initial[tree] if sub is None else initial[tree][sub]))
        after = dict(_leaves(state[tree] if sub is None else state[tree][sub]))
        changed[sub or tree] = sum(not np.array_equal(before[p], after[p]) for p in before)
        if changed[sub or tree] == 0:
            raise AssertionError(f"jepa: training left every parameter of {sub or tree} unchanged")
    del initial

    gen = torch.Generator(device=device).manual_seed(13)
    batch = synthetic_batch(cfg, actions_dim, gen, device)
    noise = _train_noise(cfg, actions_dim, gen, device)
    (m_kernel, g_kernel, p_kernel, kept), (m_plain, g_plain, p_plain, _) = _kernel_vs_plain_step(
        cfg, state, spaces_, batch, noise, device, keep=lambda agent: _jepa_ema_pairs(agent)[0])
    metric_err = float(np.max(np.abs(m_kernel - m_plain) / np.maximum(np.abs(m_plain), 1e-3)))
    grad_err = max(((g_kernel[k] - g_plain[k]).abs().max() / g_plain[k].abs().max()).item() for k in g_plain)
    diff = (p_kernel - p_plain).abs()
    param_err, outliers = diff.max().item(), (diff > STEP_PARAM_ATOL).float().mean().item()
    if (not np.isfinite(m_kernel).all() or metric_err > STEP_METRIC_RTOL or grad_err > STEP_GRAD_RTOL
            or outliers > STEP_PARAM_OUTLIERS):
        raise AssertionError(
            f"jepa kernel vs plain gradient step: metrics relative error {metric_err} (tol {STEP_METRIC_RTOL}), "
            f"gradients relative error {grad_err} (tol {STEP_GRAD_RTOL}), share of params off by more than "
            f"{STEP_PARAM_ATOL}: {outliers} (tol {STEP_PARAM_OUTLIERS}); kernel {m_kernel}, plain {m_plain}")
    agent, targets_before = kept
    ema = float(cfg.algo.jepa_ema)
    targets, online = _jepa_ema_pairs(agent)
    off = [i for i, (t, b, o) in enumerate(zip(targets, targets_before, online))
           if not torch.equal(t.detach(), b * ema + o.detach() * (1.0 - ema))]
    if off or len(targets) != len(online):
        raise AssertionError(f"jepa: {len(off)} of {len(targets)} targets did not move by exactly the EMA")
    del agent, kept
    return {
        "gradient_steps": out["gradient_steps"], "player_steps": out["player_steps"], "test_steps": out["test_steps"],
        "policy_steps": out["policy_steps"], "ln_gru_launches": launches, "launches_per_gradient_step": per_step,
        "changed_leaves": changed, "final_metrics": dict(zip(out["metric_order"], rows[-1].tolist())),
        "jepa_loss_logged": jepa_logged, "step_metric_rel_err": metric_err, "step_grad_rel_err": grad_err,
        "step_param_max_abs_err": param_err, "step_param_outliers": outliers, "ema_tensors": len(targets),
        "checkpoint": ckpt, "mid_checkpoint": mid, "overrides": overrides, "journal": journal, "sps": sps,
    }


def run_jepa_resume(jepa: dict) -> dict:
    """``run checkpoint.resume_from=<the JEPA run's mid-run checkpoint>``: the heads
    and the world-model optimizer's state over them restored as saved, and
    the run trains on."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_params import optax_state
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    saved = load_state(jepa["mid_checkpoint"])
    restored = {}
    load_learner_state = dv3.load_learner_state

    def spy_learner(state, agent, optimizers, device):
        moments = load_learner_state(state, agent, optimizers, device)
        restored["jepa"] = {path: np.array(v) for path, v in _leaves(agent.trees()["jepa"])}  # copies
        restored["adam"] = {n: _optax_leaves(optax_state(o, agent.optimizer_spec(n))) for n, o in optimizers.items()}
        return moments

    # no checkpoint at its end: nothing reads it, and an XL one takes seconds
    overrides = jepa["overrides"] + [f"checkpoint.resume_from={jepa['mid_checkpoint']}", "checkpoint.every=100000"]
    cfg = compose(overrides)
    with mock.patch.object(dv3, "load_learner_state", spy_learner):
        fused_layernorm_gru.launches = 0  # the main path starts here
        out = cli.run(overrides)
        torch.cuda.synchronize()
        launches = fused_layernorm_gru.launches  # the main path ends here
    problems = []
    for path, value in _leaves(saved["jepa"]):
        if not np.array_equal(restored["jepa"][path], value):
            problems.append(f"jepa{path}")
    for name, entry in saved["opt_states"].items():
        for path, value in _optax_leaves(entry).items():
            if not np.array_equal(restored["adam"][name].get(path), value):
                problems.append(f"Adam {name} {path}")
    predicted, _ = _launches(cfg, out)
    if (out["start_iter"] != saved["iter_num"] + 1 or out["gradient_steps"] < 1 or launches != predicted
            or not np.isfinite(out["metric_rows"]).all()):
        problems.append(f"start_iter {out['start_iter']}, {out['gradient_steps']} gradient steps, {launches} "
                        f"launches (predicted {predicted}), metrics {out['metric_rows']}")
    if problems:
        raise AssertionError(f"jepa resume from {jepa['mid_checkpoint']}: " + "; ".join(problems[:10]))
    return {"start_iter": out["start_iter"], "gradient_steps": out["gradient_steps"],
            "player_steps": out["player_steps"], "test_steps": out["test_steps"], "ln_gru_launches": launches}


def run_jepa_eval(jepa: dict, device_name: str = "cuda") -> dict:
    """``eval`` of the JEPA checkpoint (its policy acts through the kernel),
    then ``serve``, which refuses it as the JAX package's does (no
    adapter for ``dreamer_v3_jepa``)."""
    import math

    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.serving.server import ServeApp

    fused_layernorm_gru.launches = 0  # the main path starts here
    reward = cli.evaluation([f"checkpoint_path={jepa['checkpoint']}"])
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here
    if not math.isfinite(reward) or launches < 1:
        raise AssertionError(f"jepa eval: test reward {reward}, {launches} ln_gru launches")
    cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={jepa['checkpoint']}", "serving.port=0",
                                               f"fabric.accelerator={device_name}"])
    try:
        app = ServeApp(cfg, ckpt_path, device)
    except ValueError as err:
        refusal = str(err)
    else:
        app.close()
        raise AssertionError("serve accepted a dreamer_v3_jepa checkpoint; the JAX package has no adapter for it")
    if "no servable adapter" not in refusal:
        raise AssertionError(f"serve refused the JEPA checkpoint for another reason: {refusal}")
    return {"test_reward": reward, "ln_gru_launches": launches, "serve_refusal": refusal}


def run_jepa_timer(device_name: str = "cuda") -> dict:
    """The XL gradient step as the default diagnostics build it (health
    stats in the step, telemetry's instrumentation counting its FLOPs at
    its first call): stream time, device-busy time, idle share, launches,
    FLOPs and the step's MFU against the card's fp32 peak."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import profiled_step, time_gradient_steps
    from sheeprl_tpu_torch.diagnostics.telemetry import resolve_peak_flops

    torch.cuda.reset_peak_memory_stats()
    step, moments, batch, gen = profiled_step(["exp=dreamer_v3_jepa"], device_name, True)
    timing = time_gradient_steps(step, moments, batch, gen, JEPA_TIMED_STEPS, warmup=2, profile=True)
    gru = [v for k, v in timing["kernels"].items() if "ln_gru" in k]
    peak = resolve_peak_flops(torch.cuda.get_device_name(0), "32-true")
    out = {"step_ms": timing["step_ms"], "stream_ms": timing["stream_ms"], "busy_ms": timing["busy_ms"],
           "idle_share": timing["idle_share"], "launches": timing["launches"],
           "ln_gru_launches": sum(v[0] for v in gru) // JEPA_TIMED_STEPS,
           "ln_gru_ms": sum(v[1] for v in gru) / 1e3 / JEPA_TIMED_STEPS, "flops_per_step": step.flops_per_call,
           "step_mfu": step.flops_per_call / (timing["step_ms"] / 1e3) / peak if peak else None,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "top": sorted(((v[1] / JEPA_TIMED_STEPS / 1e3, k[:60]) for k, v in timing["kernels"].items()),
                         reverse=True)[:5]}
    del step, moments, batch
    return out


def _p2e_xl_widths(cfg) -> None:
    wm_cfg, ens = cfg.algo.world_model, cfg.algo.ensembles
    widths = (wm_cfg.recurrent_model.recurrent_state_size, cfg.algo.dense_units, wm_cfg.encoder.cnn_channels_multiplier,
              cfg.algo.mlp_layers, wm_cfg.representation_model.hidden_size, wm_cfg.stochastic_size,
              wm_cfg.discrete_size, ens.n, ens.dense_units, ens.mlp_layers, cfg.algo.per_rank_batch_size,
              cfg.algo.per_rank_sequence_length, cfg.algo.horizon, cfg.fabric.precision,
              list(cfg.algo.cnn_keys.decoder) + list(cfg.algo.mlp_keys.decoder), cfg.env.screen_size,
              cfg.env.num_envs, sorted(cfg.algo.critics_exploration))
    if widths != (4096, 1024, 96, 5, 1024, 32, 32, 8, 1024, 5, 16, 64, 15, "32-true", ["rgb"], 64, 4,
                  ["extrinsic", "intrinsic"]):
        raise AssertionError(f"the P2E config is not exp=p2e_dv3_exploration's XL widths at batch 16 x 64: {widths}")


def _p2e_noise(cfg, actions_dim, gen, device: str = "cuda") -> dict:
    """Every draw of one P2E exploration step, pre-drawn on the card: the
    world model's, and each imagination's (exploration, task)."""
    explore, task = (_train_noise(cfg, actions_dim, gen, device) for _ in range(2))
    return {"dynamic": explore["dynamic"],
            **{name: {"imagination": n["imagination"], "actor": n["actor"]}
               for name, n in (("exploration", explore), ("task", task))}}


def _tree_leaves(tree, prefix=""):
    """``{path: numpy}`` of a nested dict of arrays or tensors."""
    import numpy as np

    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _tree_leaves(sub, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree.detach().cpu() if hasattr(tree, "detach") else tree)}


def run_p2e(build_dir: Path, device_name: str = "cuda") -> dict:
    """Plan2Explore-DV3 explores on the card through ``run`` at its
    composed XL widths (``P2E_OVERRIDES``): every metric finite, the
    per-critic ones included; the world model, the ensembles, both actors,
    the task critic and each exploration critic changed; the kernel's
    launches as the counters predict for two imaginations a step; the
    journal of the default diagnostics (no health stats: the step has
    none); both checkpoints verified; then one exploration step from the
    last through the kernel and through the plain path, which must agree."""
    device = device_name
    import math

    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.serving.loader import _actions_dim
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = P2E_OVERRIDES + [f"root_dir={(build_dir / 'p2e').resolve()}", f"fabric.accelerator={device}"]
    cfg = compose(overrides)
    _p2e_xl_widths(cfg)
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 2**30  # what earlier phases still hold
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 2**30 - held_gb

    rows, order = out["metric_rows"], out["metric_order"]
    sps = _timer_metrics(out["logged"], "p2e")
    per_critic = [k for k in order if k.endswith(("_intrinsic", "_extrinsic"))]
    logged = {k: [m[k] for m in out["logged"] if k in m] for k in per_critic}
    if (out["gradient_steps"] < P2E_MIN_GRADIENT_STEPS or rows.shape[1] != len(order) or len(order) != 22
            or not np.isfinite(rows).all() or not all(v and all(math.isfinite(x) for x in v) for v in logged.values())
            or [name for _, name in out["player_actors"]] != ["actor_exploration"]):
        raise AssertionError(f"p2e: {out['gradient_steps']} gradient steps, metric rows {rows}, per-critic metrics "
                             f"logged {logged}, player actors {out['player_actors']}")
    predicted, per_step = _launches(cfg, out, imaginations=2)
    if launches != predicted:
        raise AssertionError(f"p2e: ln_gru launched {launches} times; the run predicts {predicted} "
                             f"({out['gradient_steps']} gradient steps x {per_step} + {out['player_steps']} player "
                             f"steps + {out['test_steps']} test steps)")
    journal = _journal_of(out["log_dir"])
    _check_diagnostics_journal(journal, "p2e", health=False)
    mid, ckpt = out["checkpoints"][0], out["checkpoints"][-1]
    for path in (mid, ckpt):
        if verify_checkpoint(path) != (True, "verified"):
            raise AssertionError(f"p2e: checkpoint {path} does not verify by its manifest: {verify_checkpoint(path)}")
    state = load_state(ckpt)
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous, _ = _actions_dim(env.action_space)
    spaces_ = (actions_dim, is_continuous, env.observation_space)
    env.close()
    # the mid-run checkpoint holds the weights before the first gradient step
    initial = load_state(mid)
    if initial["opt_states"]["world_model"][1][0][0] != 0:
        raise AssertionError(f"p2e: the checkpoint {mid} was taken after a gradient step")
    changed = {}
    for path in ("world_model", "ensembles", "actor_exploration", "actor_task", "critic_task",
                 *(f"critics_exploration/{name}/module" for name in sorted(cfg.algo.critics_exploration))):
        before, after = initial, state
        for key in path.split("/"):
            before, after = before[key], after[key]
        before, after = dict(_leaves(before)), dict(_leaves(after))
        changed[path] = sum(not np.array_equal(before[p], after[p]) for p in before)
        if changed[path] == 0:
            raise AssertionError(f"p2e: training left every parameter of {path} unchanged")
    del initial

    gen = torch.Generator(device=device).manual_seed(13)
    batch = synthetic_batch(cfg, actions_dim, gen, device)
    noise = _p2e_noise(cfg, actions_dim, gen, device)
    (m_kernel, g_kernel, p_kernel, _), (m_plain, g_plain, p_plain, _) = _kernel_vs_plain_step(
        cfg, state, spaces_, batch, noise, device)
    del state
    metric_err = float(np.max(np.abs(m_kernel - m_plain) / np.maximum(np.abs(m_plain), 1e-3)))
    grad_err = max(((g_kernel[k] - g_plain[k]).abs().max() / g_plain[k].abs().max().clamp_min(1e-30)).item()
                   for k in g_plain)
    diff = (p_kernel - p_plain).abs()
    param_err, outliers = diff.max().item(), (diff > STEP_PARAM_ATOL).float().mean().item()
    if (not np.isfinite(m_kernel).all() or metric_err > STEP_METRIC_RTOL or grad_err > STEP_GRAD_RTOL
            or outliers > STEP_PARAM_OUTLIERS):
        raise AssertionError(
            f"p2e kernel vs plain gradient step: metrics relative error {metric_err} (tol {STEP_METRIC_RTOL}), "
            f"gradients relative error {grad_err} (tol {STEP_GRAD_RTOL}), share of params off by more than "
            f"{STEP_PARAM_ATOL}: {outliers} (tol {STEP_PARAM_OUTLIERS}); kernel {m_kernel}, plain {m_plain}")
    return {
        "gradient_steps": out["gradient_steps"], "player_steps": out["player_steps"], "test_steps": out["test_steps"],
        "policy_steps": out["policy_steps"], "ln_gru_launches": launches, "launches_per_gradient_step": per_step,
        "changed_leaves": changed, "final_metrics": dict(zip(order, rows[-1].tolist())), "per_critic": logged,
        "step_metric_rel_err": metric_err, "step_grad_rel_err": grad_err, "step_param_max_abs_err": param_err,
        "step_param_outliers": outliers, "peak_memory_gb": peak_gb, "held_gb": held_gb, "checkpoint": ckpt,
        "mid_checkpoint": mid,
        "overrides": overrides, "journal": journal, "sps": sps,
    }


def run_p2e_resume(p2e: dict) -> dict:
    """``run checkpoint.resume_from=<the P2E run's mid-run checkpoint>``: the
    seven trees, all six kinds of optimizer state (one per exploration
    critic) and the Moments tree restored as saved, and the run trains on."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_params import optax_state
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    saved = load_state(p2e["mid_checkpoint"])
    restored = {}
    load_learner_state = dv3.load_learner_state

    def spy_learner(state, agent, optimizers, device):
        moments = load_learner_state(state, agent, optimizers, device)
        restored["trees"] = {p: np.array(v) for p, v in _tree_leaves(agent.trees()).items()}  # copies
        restored["opt"] = _optax_leaves(dv3.nest({n: optax_state(o, agent.optimizer_spec(n))
                                                  for n, o in optimizers.items()}))
        restored["moments"] = _tree_leaves(moments)
        restored["optimizers"] = sorted(optimizers)
        return moments

    # no checkpoint at its end: nothing reads it, and an XL one takes seconds
    overrides = p2e["overrides"] + [f"checkpoint.resume_from={p2e['mid_checkpoint']}", "checkpoint.every=100000"]
    cfg = compose(overrides)
    with mock.patch.object(dv3, "load_learner_state", spy_learner):
        fused_layernorm_gru.launches = 0  # the main path starts here
        out = cli.run(overrides)
        torch.cuda.synchronize()
        launches = fused_layernorm_gru.launches  # the main path ends here
    problems = []
    for path, value in _tree_leaves({k: saved[k] for k in ("world_model", "actor_task", "critic_task",
                                                           "target_critic_task", "actor_exploration",
                                                           "critics_exploration", "ensembles")}).items():
        if not np.array_equal(restored["trees"].get(path), value):
            problems.append(f"tree {path}")
    want_opt = _optax_leaves(saved["opt_states"])
    if sorted(want_opt) != sorted(restored["opt"]):
        problems.append(f"optimizer state paths {sorted(want_opt)[:5]} vs {sorted(restored['opt'])[:5]}")
    problems += [f"Adam {path}" for path, value in want_opt.items()
                 if not np.array_equal(restored["opt"].get(path), value)]
    problems += [f"moments {path}" for path, value in _tree_leaves(saved["moments"]).items()
                 if not np.array_equal(restored["moments"].get(path), value)]
    predicted, _ = _launches(cfg, out, imaginations=2)
    if (out["start_iter"] != saved["iter_num"] + 1 or out["gradient_steps"] < 1 or launches != predicted
            or not np.isfinite(out["metric_rows"]).all() or len(restored["optimizers"]) != 7):
        problems.append(f"start_iter {out['start_iter']}, {out['gradient_steps']} gradient steps, {launches} "
                        f"launches (predicted {predicted}), optimizers {restored['optimizers']}, metrics "
                        f"{out['metric_rows']}")
    if problems:
        raise AssertionError(f"p2e resume from {p2e['mid_checkpoint']}: " + "; ".join(problems[:10]))
    return {"start_iter": out["start_iter"], "gradient_steps": out["gradient_steps"],
            "player_steps": out["player_steps"], "test_steps": out["test_steps"], "ln_gru_launches": launches,
            "optimizers": restored["optimizers"], "moments": len(restored["moments"])}


def run_p2e_finetune(build_dir: Path, p2e: dict, device_name: str = "cuda", overrides=None, widths=None,
                     kernel: bool = True, where: str = "p2e_finetuning") -> dict:
    """``run exp=p2e_dv3_finetuning checkpoint.exploration_ckpt_path=<the
    exploration run's last> buffer.load_from_exploration=True``: DreamerV3's
    step at the exploration's widths (one imagination a step), the player
    on the exploration actor until the first gradient step and on the task
    actor after it, every metric finite, the checkpoint verified.  With
    ``overrides`` and ``widths`` another family's finetuning (P2E-DV2's,
    P2E-DV1's: no kernel launch without ``kernel``), under ``where``."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = (overrides or P2E_FINETUNE_OVERRIDES) + [f"root_dir={(build_dir / where).resolve()}",
                                                         f"fabric.accelerator={device_name}",
                                                         f"checkpoint.exploration_ckpt_path={p2e['checkpoint']}"]
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here
    cfg = compose(overrides)
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import apply_exploration_cfg, load_exploration_cfg

    apply_exploration_cfg(cfg, load_exploration_cfg(cfg))
    (widths or _p2e_xl_widths)(cfg)
    predicted, per_step = _launches(cfg, out) if kernel else (0, 0)
    ckpt = out["checkpoints"][-1]
    switches = out["player_actors"]
    first_train = out["first_train_iter"]
    if (out["gradient_steps"] < 1 or not np.isfinite(out["metric_rows"]).all() or launches != predicted
            or [name for _, name in switches] != ["actor_exploration", "actor"] or first_train is None
            or not switches[0][0] <= first_train < switches[1][0] == first_train + 1
            or verify_checkpoint(ckpt) != (True, "verified")
            or not {"actor_exploration", "actor", "opt_states"} <= set(load_state(ckpt))):
        raise AssertionError(f"{where}: {out['gradient_steps']} gradient steps, {launches} ln_gru launches "
                             f"(predicted {predicted}), player actors {switches}, first gradient step at iteration "
                             f"{first_train}, checkpoint {ckpt} {verify_checkpoint(ckpt)}")
    return {"gradient_steps": out["gradient_steps"], "player_steps": out["player_steps"],
            "test_steps": out["test_steps"], "ln_gru_launches": launches, "launches_per_gradient_step": per_step,
            "player_actors": switches, "first_train_iter": first_train, "checkpoint": ckpt,
            "final_metrics": dict(zip(out["metric_order"], out["metric_rows"][-1].tolist()))}


def run_p2e_eval(checkpoints, device_name: str = "cuda", kernel: bool = True) -> dict:
    """``eval`` of each P2E checkpoint (the task actor acts through the
    kernel; without ``kernel``, P2E-DV1's plain GRU, it launches none), then
    ``serve``, which refuses each as the JAX package does (no P2E
    adapter)."""
    import math

    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.serving.server import ServeApp

    out = {"test_rewards": [], "ln_gru_launches": 0, "serve_refusals": []}
    fused_layernorm_gru.launches = 0  # the main path starts here
    for ckpt in checkpoints:
        out["test_rewards"].append(cli.evaluation([f"checkpoint_path={ckpt}"]))
    torch.cuda.synchronize()
    out["ln_gru_launches"] = fused_layernorm_gru.launches  # the main path ends here
    launched = out["ln_gru_launches"] >= len(checkpoints) if kernel else out["ln_gru_launches"] == 0
    if not all(math.isfinite(r) for r in out["test_rewards"]) or not launched:
        raise AssertionError(f"p2e eval: test rewards {out['test_rewards']}, {out['ln_gru_launches']} ln_gru launches")
    for ckpt in checkpoints:
        cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={ckpt}", "serving.port=0",
                                                   f"fabric.accelerator={device_name}"])
        try:
            app = ServeApp(cfg, ckpt_path, device)
        except ValueError as err:
            refusal = str(err)
        else:
            app.close()
            raise AssertionError(f"serve accepted the P2E checkpoint {ckpt}; the JAX package has no adapter for it")
        if "no servable adapter" not in refusal:
            raise AssertionError(f"serve refused the P2E checkpoint {ckpt} for another reason: {refusal}")
        out["serve_refusals"].append(refusal)
    return out


def run_p2e_timer(device_name: str = "cuda") -> dict:
    """The XL exploration step as the default diagnostics build it
    (telemetry's instrumentation counting its FLOPs at its first call; the
    step has no health stats): stream time, device-busy time, idle share,
    launches, FLOPs, the step's MFU and the peak memory."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import profiled_step, time_gradient_steps
    from sheeprl_tpu_torch.diagnostics.telemetry import resolve_peak_flops

    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 2**30  # what earlier phases still hold
    step, moments, batch, gen = profiled_step(["exp=p2e_dv3_exploration"], device_name, True)
    timing = time_gradient_steps(step, moments, batch, gen, P2E_TIMED_STEPS, warmup=2, profile=True)
    gru = [v for k, v in timing["kernels"].items() if "ln_gru" in k]
    peak = resolve_peak_flops(torch.cuda.get_device_name(0), "32-true")
    out = {"step_ms": timing["step_ms"], "stream_ms": timing["stream_ms"], "busy_ms": timing["busy_ms"],
           "idle_share": timing["idle_share"], "launches": timing["launches"],
           "ln_gru_launches": sum(v[0] for v in gru) // P2E_TIMED_STEPS,
           "ln_gru_ms": sum(v[1] for v in gru) / 1e3 / P2E_TIMED_STEPS, "flops_per_step": step.flops_per_call,
           "step_mfu": step.flops_per_call / (timing["step_ms"] / 1e3) / peak if peak else None,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 2**30 - held_gb, "held_gb": held_gb,
           "top": sorted(((v[1] / P2E_TIMED_STEPS / 1e3, k[:60]) for k, v in timing["kernels"].items()),
                         reverse=True)[:6]}
    del step, moments, batch
    return out


def run_a2c(build_dir: Path, device_name: str = "cuda") -> dict:
    """``run exp=a2c env=dummy`` on the card (``A2C_OVERRIDES``): finite
    losses and ``Time/sps_*``; a resume from its mid-run checkpoint, which
    restores RMSprop's state and trains on; ``eval`` of its last
    checkpoint; ``serve`` of it to concurrent HTTP clients."""
    import math

    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.serving.server import ServeApp
    from sheeprl_tpu_torch.utils.checkpoint import load_state
    from sheeprl_tpu_torch.utils.optim import RMSprop

    overrides = A2C_OVERRIDES + [f"root_dir={(build_dir / 'a2c').resolve()}", f"fabric.accelerator={device_name}"]
    out = cli.run(overrides)
    rows = out["metric_rows"]
    if out["iterations"] != 10 or rows.shape != (10, 3) or not np.isfinite(rows).all() or len(out["checkpoints"]) != 2:
        raise AssertionError(f"a2c: {out['iterations']} iterations, metric rows {rows}, checkpoints "
                             f"{out['checkpoints']}")
    sps = _timer_metrics(out["logged"], "a2c")
    first = out["checkpoints"][0]
    saved = load_state(first)
    restored = {}
    rms_load = RMSprop.load_state_dict

    def spy(self, state_dict):
        restored["nu"] = [v["nu"].clone() for v in state_dict["state"].values()]
        return rms_load(self, state_dict)

    with mock.patch.object(RMSprop, "load_state_dict", spy):
        resumed = cli.run(overrides + [f"checkpoint.resume_from={first}", "algo.run_test=False"])
    saved_nu = [np.asarray(v) for _, v in _leaves(saved["opt_state"][0][0][0])]
    if (resumed["start_iter"] != saved["iter_num"] + 1 or resumed["iterations"] != 5
            or not np.isfinite(resumed["metric_rows"]).all() or len(restored.get("nu", [])) != len(saved_nu)
            or not np.allclose(sorted(float(np.abs(v).astype(np.float64).sum()) for v in saved_nu),
                               sorted(float(v.abs().double().sum()) for v in restored["nu"]), rtol=1e-6, atol=0)):
        raise AssertionError(f"a2c resume from {first}: start_iter {resumed['start_iter']}, {resumed['iterations']} "
                             f"iterations, RMSprop nu restored {len(restored.get('nu', []))} of {len(saved_nu)}")
    reward = cli.evaluation([f"checkpoint_path={out['checkpoints'][-1]}"])
    if not math.isfinite(reward):
        raise AssertionError(f"a2c eval: test reward {reward}")

    cfg, ckpt_path, device = cli.serve_config(
        [f"checkpoint_path={out['checkpoints'][-1]}", "serving.port=0", "serving.batch_buckets=[4,8]",
         "serving.max_delay_ms=5.0", f"fabric.accelerator={device_name}"])
    app = ServeApp(cfg, ckpt_path, device)
    try:
        host, port = app.start()
        url = f"http://{host}:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if health.get("algo") != "a2c" or health["models"]["default"]["stateful"] is not False:
            raise AssertionError(f"a2c /healthz: {health}")
        replies, latencies, lock = [], [], threading.Lock()

        def client(i: int) -> None:
            rng = np.random.default_rng(3000 + i)
            for j in range(A2C_SERVE_REQUESTS):
                t0 = time.perf_counter()
                status, reply = _post(url, {"obs": {"state": rng.normal(size=10).tolist()}, "greedy": (i + j) % 2 == 0})
                with lock:
                    latencies.append((time.perf_counter() - t0) * 1e3)
                    replies.append((status, reply))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(A2C_SERVE_CLIENTS)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads):
            raise AssertionError("an A2C serve client did not finish within 300 s")
        actions = np.asarray([r[1].get("action") for r in replies if r[0] == 200], dtype=np.float64)
        if len(actions) != A2C_SERVE_CLIENTS * A2C_SERVE_REQUESTS or actions.shape[1:] != (1,) or \
                not np.isin(actions, (0.0, 1.0)).all():
            raise AssertionError(f"a2c serve: {len(actions)} good replies of {len(replies)}, actions {actions[:4]}")
        probe = np.random.default_rng(98).normal(size=10).astype(np.float32)
        status, reply = _post(url, {"obs": {"state": probe.tolist()}, "greedy": True})
        direct = app.handle.make_step(True)(app.handle.params, {"state": torch.from_numpy(probe[None]).to(device)},
                                            None).cpu().numpy()[0]
        if status != 200 or reply["action"] != direct.tolist():
            raise AssertionError(f"a2c serve: greedy reply {status} {reply} != the agent's {direct}")
    finally:
        app.close()
    lat = sorted(latencies)
    return {"iterations": out["iterations"], "final_losses": dict(zip(("policy", "value", "grad_norm"),
                                                                      rows[-1].tolist())),
            "value_ev": out["health_rows"].get("value_ev", np.zeros(0)).tolist(), "sps": sps,
            "resume_start_iter": resumed["start_iter"], "test_reward": reward, "requests": len(replies),
            "requests_per_s": len(replies) / wall_s, "latency_p50_ms": lat[len(lat) // 2],
            "latency_p99_ms": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]}


# ---------------------------------------------------------------------------
# the SAC family (SAC, DroQ, SAC-AE), and PPO and A2C in bf16
# ---------------------------------------------------------------------------


class bounded_dummy_actions:
    """The continuous dummy env's action space bounded to ``Box(-1, 1)`` in
    this process for the ``with`` block.  Its ``Box(-inf, inf)`` makes the
    SAC-family actors' rescale ``(high - low) / 2`` infinite and every
    action and loss NaN, in the JAX package too (ROADMAP.md Queue 3); the
    runs inside use ``env.executor=sync``, since a spawned env worker would
    not see the patch."""

    def __enter__(self):
        import numpy as np

        from sheeprl_tpu_torch.envs import dummy, spaces

        self._orig = orig = dummy.ContinuousDummyEnv.__init__

        def bounded(env, *args, **kwargs):
            orig(env, *args, **kwargs)
            env.action_space = spaces.Box(-1.0, 1.0, env.action_space.shape, np.float32)

        dummy.ContinuousDummyEnv.__init__ = bounded
        return self

    def __exit__(self, *exc):
        from sheeprl_tpu_torch.envs import dummy

        dummy.ContinuousDummyEnv.__init__ = self._orig
        return False


def _off_policy_run(overrides, where: str, resume: bool = True) -> dict:
    """``run`` of an off-policy preset, its mid-run resume and ``eval`` of
    its last checkpoint, each path with the LayerNorm-GRU kernel's launch
    counter set to 0 before it and read after; every metric finite and the
    checkpoints verified."""
    import math

    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint

    launches = {}
    t0 = time.monotonic()
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    launches[where] = fused_layernorm_gru.launches  # the main path ends here
    rows = out["metric_rows"]
    if out["gradient_steps"] <= 0 or not np.isfinite(rows).all() or len(out["checkpoints"]) != 2 or \
            any(verify_checkpoint(c) != (True, "verified") for c in out["checkpoints"]):
        raise AssertionError(f"{where}: {out['gradient_steps']} gradient steps, metric rows finite "
                             f"{np.isfinite(rows).all()}, checkpoints {out['checkpoints']}")
    result = {"run": out, "gradient_steps": out["gradient_steps"], "iterations": out["iterations"],
              "final": rows[-1].tolist(), "seconds": time.monotonic() - t0}
    if resume:
        fused_layernorm_gru.launches = 0
        resumed = cli.run(overrides + [f"checkpoint.resume_from={out['checkpoints'][0]}", "algo.run_test=False"])
        launches[f"{where}_resume"] = fused_layernorm_gru.launches
        if resumed["start_iter"] <= 1 or resumed["gradient_steps"] <= 0 or not np.isfinite(resumed["metric_rows"]).all():
            raise AssertionError(f"{where} resume: start_iter {resumed['start_iter']}, "
                                 f"{resumed['gradient_steps']} gradient steps")
        result.update(resume_start_iter=resumed["start_iter"], resume_gradient_steps=resumed["gradient_steps"])
    fused_layernorm_gru.launches = 0
    reward = cli.evaluation([f"checkpoint_path={out['checkpoints'][-1]}"])
    launches[f"{where}_eval"] = fused_layernorm_gru.launches
    if not math.isfinite(reward):
        raise AssertionError(f"{where} eval: test reward {reward}")
    result.update(test_reward=reward, launches=launches)
    return result


def run_sac(build_dir: Path, device_name: str = "cuda") -> dict:
    """``run exp=sac env=dummy`` on the card at its own widths
    (``SAC_OVERRIDES``): finite metrics, verified checkpoints, a resume from
    the mid-run one, ``eval``, and ``serve`` to concurrent HTTP clients,
    whose greedy replies are finite, in the action space and equal to the
    actor's own."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.serving.server import ServeApp

    overrides = SAC_OVERRIDES + [f"root_dir={(build_dir / 'sac').resolve()}", f"fabric.accelerator={device_name}"]
    out = _off_policy_run(overrides, "sac")
    ckpt = out["run"]["checkpoints"][-1]
    cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={ckpt}", "serving.port=0",
                                               "serving.batch_buckets=[4,8]", "serving.max_delay_ms=5.0",
                                               f"fabric.accelerator={device_name}"])
    fused_layernorm_gru.launches = 0
    app = ServeApp(cfg, ckpt_path, device)
    try:
        host, port = app.start()
        url = f"http://{host}:{port}"
        replies, lock = [], threading.Lock()

        def client(i: int) -> None:
            rng = np.random.default_rng(4000 + i)
            for j in range(SAC_SERVE_REQUESTS):
                status, reply = _post(url, {"obs": {"state": rng.normal(size=10).tolist()}, "greedy": (i + j) % 2 == 0})
                with lock:
                    replies.append((status, reply))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(SAC_SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a SAC serve client did not finish within 300 s")
        actions = np.asarray([r[1].get("action") for r in replies if r[0] == 200], dtype=np.float64)
        if len(actions) != SAC_SERVE_CLIENTS * SAC_SERVE_REQUESTS or actions.shape[1:] != (2,) or \
                not np.isfinite(actions).all() or np.abs(actions).max() > 1.0:
            raise AssertionError(f"sac serve: {len(actions)} good replies of {len(replies)}, actions {actions[:4]}")
        probe = np.random.default_rng(99).normal(size=10).astype(np.float32)
        status, reply = _post(url, {"obs": {"state": probe.tolist()}, "greedy": True})
        direct = app.handle.make_step(True)(app.handle.params, {"state": torch.from_numpy(probe[None]).to(device)},
                                            None).cpu().numpy()[0]
        if status != 200 or not np.allclose(reply["action"], direct, rtol=0, atol=1e-6):
            raise AssertionError(f"sac serve: greedy reply {status} {reply} != the actor's {direct}")
    finally:
        app.close()
    out["launches"]["sac_serve"] = fused_layernorm_gru.launches
    out.update(requests=len(replies), greedy_probe=reply["action"])
    return out


def run_droq(build_dir: Path, device_name: str = "cuda") -> dict:
    """``run exp=droq env=dummy`` on the card at its own widths
    (``DROQ_OVERRIDES``: 20 gradient steps a policy step), its resume and
    ``eval``; ``serve`` refuses its checkpoint, as the JAX package has no
    DroQ adapter."""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.serving.server import ServeApp

    overrides = DROQ_OVERRIDES + [f"root_dir={(build_dir / 'droq').resolve()}", f"fabric.accelerator={device_name}"]
    out = _off_policy_run(overrides, "droq")
    cfg, path, device = cli.serve_config([f"checkpoint_path={out['run']['checkpoints'][-1]}",
                                          f"fabric.accelerator={device_name}"])
    try:
        ServeApp(cfg, path, device).close()
    except ValueError as err:
        out["serve_refusal"] = str(err)
    else:
        raise AssertionError("serve accepted a DroQ checkpoint")
    return out


def run_sac_ae(build_dir: Path, device_name: str = "cuda") -> dict:
    """``run exp=sac_ae env=dummy`` on the card at its own widths
    (``SAC_AE_OVERRIDES``: 64x64 ``rgb`` with a 3-frame stack plus
    ``state``, features 64, 32-channel convolutions, actor and critics
    1,024 wide, batch 128), its resume (the cumulative counter restored)
    and ``eval``; ``serve`` refuses its checkpoint."""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.serving.server import ServeApp
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = SAC_AE_OVERRIDES + [f"root_dir={(build_dir / 'sac_ae').resolve()}",
                                    f"fabric.accelerator={device_name}"]
    out = _off_policy_run(overrides, "sac_ae")
    run = out["run"]
    if run["metric_rows"].shape[1] != 4 or not (run["metric_rows"][:, 3] > 0).all():
        raise AssertionError(f"sac_ae: reconstruction losses {run['metric_rows'][:, 3]}")
    saved = load_state(run["checkpoints"][0])
    out["counter_at_checkpoint"] = int(saved["cumulative_counter"])
    cfg, path, device = cli.serve_config([f"checkpoint_path={run['checkpoints'][-1]}",
                                          f"fabric.accelerator={device_name}"])
    try:
        ServeApp(cfg, path, device).close()
    except ValueError as err:
        out["serve_refusal"] = str(err)
    else:
        raise AssertionError("serve accepted a SAC-AE checkpoint")
    return out


def _card_vs_cpu(family_cls, cfg, obs_space, action_space, state, data, noise_fn, counter=None,
                 devices=("cuda", "cpu")) -> dict:
    """One train call of the family's update from ``state`` (a checkpoint's
    agent and optimizer states) on the card and on the CPU with the same
    batch and noise (``noise_fn(device)``: the update's arguments after the
    batch, one or a tuple): ``{metric_rel_err, param_max_abs_err, on_card}``."""
    import numpy as np

    from sheeprl_tpu_torch.interop.flax_params import dump_trees

    out = []
    for device in devices:
        family = family_cls(cfg, obs_space, action_space, state, device).make_update()
        batch = {k: v.to(device) for k, v in data.items()}
        # the update's arguments after the batch: the noise, or a tuple of them
        args = noise_fn(device)
        args = args if isinstance(args, tuple) else (args,)
        if counter is None:
            metrics = family.update(batch, *args)
        else:
            metrics, _ = family.update(batch, *args, counter)
        tensors = list(family.agent.parameters()) + [t for o in family.optimizers.values()
                                                     for s in o.state.values() for t in s.values()]
        out.append((metrics.cpu().numpy(), dump_trees(family.spec()),
                    all(t.device.type == device for t in tensors if t.dim() > 0)))
    (m_card, t_card, on_card), (m_cpu, t_cpu, _) = out
    card_leaves, cpu_leaves = dict(_leaves(t_card)), dict(_leaves(t_cpu))
    n = len(family.metric_order)
    rel = float(np.max(np.abs(m_card[:n] - m_cpu[:n]) / np.maximum(np.abs(m_cpu[:n]), 1e-6)))
    err = max(float(np.abs(card_leaves[k] - cpu_leaves[k]).max()) for k in cpu_leaves)
    return {"metric_rel_err": rel, "param_max_abs_err": err, "on_card": on_card}


def run_sac_card_vs_cpu(sac: dict, sac_ae: dict, devices=("cuda", "cpu")) -> dict:
    """One SAC and one SAC-AE train call of two gradient steps on the card
    against the port's CPU step, from the runs' mid-run checkpoints (their
    trees and optimizer states), one sampled batch and the same noise, fp32
    with TF32 off: every tensor of the step on the card, the metrics within
    ``CARD_CPU_METRIC_RTOL``, the parameters within ``CARD_CPU_PARAM_ATOL``."""
    import torch

    from sheeprl_tpu_torch.algos.sac.sac import SACFamily
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAEFamily
    from sheeprl_tpu_torch.algos.sac.step_profile import _spaces
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    out = {}
    gen = torch.Generator().manual_seed(11)
    for name, run, family_cls in (("sac", sac, SACFamily), ("sac_ae", sac_ae, SACAEFamily)):
        ckpt = run["run"]["checkpoints"][0]
        state = load_state(ckpt)
        cfg = run["run"]["family"].cfg
        obs_space, action_space = _spaces(cfg)
        n = int(cfg.algo.per_rank_batch_size)
        if name == "sac":
            data = {"observations": torch.randn(2, n, 10, generator=gen), "next_observations": torch.randn(2, n, 10, generator=gen),
                    "actions": torch.rand(2, n, 2, generator=gen) * 2 - 1, "rewards": torch.randn(2, n, 1, generator=gen),
                    "terminated": (torch.rand(2, n, 1, generator=gen) < 0.05).float()}
            eps = torch.randn(2, n, 2, generator=gen)
            row = _card_vs_cpu(family_cls, cfg, obs_space, action_space, state, data, lambda d: eps.to(d),
                               devices=devices)
        else:
            data = {"actions": torch.rand(2, n, 2, generator=gen) * 2 - 1, "rewards": torch.randn(2, n, 1, generator=gen),
                    "terminated": (torch.rand(2, n, 1, generator=gen) < 0.05).float()}
            for prefix in ("", "next_"):
                data[f"{prefix}rgb"] = torch.randint(0, 256, (2, n, 9, 64, 64), generator=gen).float()
                data[f"{prefix}state"] = torch.randn(2, n, 10, generator=gen)
            noise = {"eps_next": torch.randn(2, n, 2, generator=gen), "eps_actor": torch.randn(2, n, 2, generator=gen),
                     "pixels": {"rgb": torch.rand(2, n, 9, 64, 64, generator=gen)}}
            row = _card_vs_cpu(family_cls, cfg, obs_space, action_space, state, data,
                               lambda d: {"eps_next": noise["eps_next"].to(d), "eps_actor": noise["eps_actor"].to(d),
                                          "pixels": {"rgb": noise["pixels"]["rgb"].to(d)}}, counter=0,
                               devices=devices)
        if not row["on_card"] or row["metric_rel_err"] > CARD_CPU_METRIC_RTOL[name] or \
                row["param_max_abs_err"] > CARD_CPU_PARAM_ATOL[name]:
            raise AssertionError(f"{name} card vs CPU: {row} (tol {CARD_CPU_METRIC_RTOL[name]}, "
                                 f"{CARD_CPU_PARAM_ATOL[name]})")
        out[name] = row
    return out


def _nested_to(tree, device):
    """Every tensor of a dict/list tree moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _nested_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_nested_to(v, device) for v in tree]
    return tree.to(device)


def _dataset_rows(root: str) -> dict:
    """``{stream: {key: [T, ...]}}``: every verified stream of a dataset,
    whole; raises on a skipped shard or a stream with a hole."""
    from sheeprl_tpu_torch.data.datasets import OfflineDataset

    dataset = OfflineDataset(root)
    if dataset.skipped or len(dataset.segments) != len(dataset.streams):
        raise AssertionError(f"dataset {root}: skipped {dataset.skipped}, {len(dataset.segments)} segments for "
                             f"{len(dataset.streams)} streams")
    return {seg.stream: dataset.gather_window(seg.stream, seg.start, seg.rows) for seg in dataset.segments}


def _same_rows(live: dict, other: dict, where: str) -> int:
    """The live export against rows of the same replay as a checkpoint saved
    them: bit-identical, stream by stream, key by key, but for the
    ``truncated`` flag the save sets on each env's newest row (a resumed run
    does not go on with that episode), which must be the only difference;
    returns the rows compared."""
    import numpy as np

    if sorted(live) != sorted(other):
        raise AssertionError(f"{where}: streams {sorted(live)} against {sorted(other)}")
    rows = 0
    for stream, arrays in live.items():
        theirs = other[stream]
        if sorted(arrays) != sorted(theirs):
            raise AssertionError(f"{where}: stream {stream} keys {sorted(arrays)} against {sorted(theirs)}")
        for key, value in arrays.items():
            want = theirs[key]
            if key == "truncated":
                if want[-1].max() != 1:
                    raise AssertionError(f"{where}: stream {stream}'s newest row is not marked truncated")
                value, want = value[:-1], want[:-1]
            if value.dtype != want.dtype or value.shape != want.shape or not np.array_equal(value, want):
                raise AssertionError(f"{where}: stream {stream} key {key}: {value.dtype}{value.shape} against "
                                     f"{want.dtype}{want.shape}, equal {np.array_equal(value, want)}")
        rows += len(next(iter(arrays.values())))
    return rows


def _checkpoint_rows(ckpt: str) -> dict:
    """``{env: {key: [T, ...]}}`` of a checkpoint's replay, in logical order
    (``offline/export.py``'s own reading of a saved buffer)."""
    from sheeprl_tpu_torch.offline.export import _rb_state_chunks
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    return {stream: arrays for stream, _, arrays in _rb_state_chunks(load_state(ckpt)["rb"])}


def _offline_dv3_batch(dataset_dir: str, cfg, device: str):
    """The offline loop's first batch of ``dataset_dir`` at ``cfg``'s shapes,
    staged on the card, and the dataset's observation space."""
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import stage_batch
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import rssm_scan_spec
    from sheeprl_tpu_torch.data.datasets import OfflineDataset
    from sheeprl_tpu_torch.envs import spaces

    dataset = OfflineDataset(dataset_dir)
    cnn_keys, obs_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    keys = obs_keys + ["actions", "rewards", "terminated", "is_first"]
    if rssm_scan_spec(cfg)[0] > 1:
        keys += ["rssm_recurrent", "rssm_posterior", "rssm_valid"]
    host = next(dataset.batches(cfg.algo.per_rank_batch_size, seed=int(cfg.seed), mode="sequence",
                                sequence_length=cfg.algo.per_rank_sequence_length, keys=keys))
    obs_space = spaces.Dict({k: spaces.Box(0, 255, dataset.key_specs[k][0], "uint8") if k in cnn_keys
                             else spaces.Box(-np.inf, np.inf, dataset.key_specs[k][0], "float32") for k in obs_keys})
    return stage_batch(host, cnn_keys, device), obs_space


def _offline_run(overrides, where: str, steps: int) -> tuple:
    """An offline ``run``, its kernel launches counted from 0 around it:
    ``(out, launches)``; every metric finite, ``steps`` gradient steps, its
    checkpoints verified and marked offline, its journal with the dataset's
    open and gauges and no env."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here
    journal = _journal_of(out["log_dir"])
    gauges = set(journal["gauges"])
    states = [load_state(c) for c in out["checkpoints"]]
    if out["gradient_steps"] != steps or not np.isfinite(out["metric_rows"]).all() or not out["checkpoints"] \
            or any(verify_checkpoint(c) != (True, "verified") for c in out["checkpoints"]) \
            or not all(s.get("offline") is True for s in states):
        raise AssertionError(f"{where}: {out['gradient_steps']} gradient steps (expected {steps}), metrics "
                             f"{out['metric_rows']}, checkpoints {out['checkpoints']}")
    if journal["status"] != "completed" or "dataset_open" not in journal["kinds"] or \
            "Telemetry/dataset_read_sps" not in gauges or "Telemetry/env_steps_per_sec" in gauges:
        raise AssertionError(f"{where}: journal status {journal['status']}, kinds {journal['kinds']}, gauges "
                             f"{sorted(gauges)}")
    return out, launches, journal


def run_offline_dreamer(build_dir: Path, train: dict, chunked: dict, device_name: str = "cuda") -> dict:
    """The offline DreamerV3 phases: the fp32 run's live export against its
    checkpoint's replay and against ``python -m sheeprl_tpu_torch export``
    of the run; offline DreamerV3-S through the kernel on it (79 launches a
    step), a resume that continues the offline counters, one offline step
    through the kernel and through the plain path from one state and
    dataset batch (returned as ``batch``: phase 17 times the fp32 step on
    it); the chunked bf16 step on the device ring's export."""
    import subprocess

    import numpy as np
    import torch

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.data.datasets import OfflineDataset
    from sheeprl_tpu_torch.serving.loader import agent_state_from_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    device = device_name
    run_dir = Path(train["checkpoint"]).parent.parent
    live = str(run_dir / "dataset")
    live_rows = _dataset_rows(live)
    rows_vs_ckpt = _same_rows(live_rows, _checkpoint_rows(train["checkpoint"]), "fp32 live export vs checkpoint")
    converted = build_dir / "offline_export"
    shutil.rmtree(converted, ignore_errors=True)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", "export", str(run_dir), "--out", str(converted)],
                          cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    export_s = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"export of {run_dir} exited {proc.returncode}: {proc.stderr[-2000:]}")
    rows_vs_cli = _same_rows(live_rows, _dataset_rows(str(converted)), "fp32 live export vs the export command")

    overrides = OFFLINE_DV3_OVERRIDES + [f"algo.offline.dataset_dir={live}", f"fabric.accelerator={device}",
                                         f"root_dir={(build_dir / 'offline').resolve()}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg)
    out, launches, journal = _offline_run(overrides, "offline dv3", OFFLINE_DV3_STEPS)
    _check_diagnostics_journal(journal, "offline dv3")
    no_player = {"gradient_steps": out["gradient_steps"], "player_steps": 0, "player_width": 1, "test_steps": 0}
    predicted, per_step = _launches(cfg, no_player)
    if per_step != 64 + 15 or launches != predicted:
        raise AssertionError(f"offline dv3: {launches} ln_gru launches, predicted {predicted} ({per_step} a step)")
    if len(out["checkpoints"]) != 2:
        raise AssertionError(f"offline dv3: checkpoints {out['checkpoints']}")
    resumed, resume_launches, _ = _offline_run(
        overrides + [f"checkpoint.resume_from={out['checkpoints'][0]}", "run_name=chip_smoke_offline_resume"],
        "offline dv3 resume", OFFLINE_DV3_STEPS // 2)
    first = load_state(out["checkpoints"][0])
    if resumed["start_iter"] != first["iter_num"] + 1 or resumed["policy_steps"] != OFFLINE_DV3_STEPS or \
            resume_launches != per_step * resumed["gradient_steps"]:
        raise AssertionError(f"offline dv3 resume: start_iter {resumed['start_iter']}, policy steps "
                             f"{resumed['policy_steps']}, {resume_launches} launches")
    phases = next((e for e in journal["events"] if e["event"] == "telemetry_summary"), {}).get("phase_seconds", {})
    sample_s, train_s = phases.get("buffer-sample", 0.0), phases.get("train", 0.0)
    sps_train = [m["Time/sps_train"] for m in out["logged"] if "Time/sps_train" in m]

    # one offline gradient step from the last checkpoint's state and the
    # loader's first batch, through the kernel and through the plain path
    gen = torch.Generator(device=device).manual_seed(13)
    batch, obs_space = _offline_dv3_batch(live, cfg, device)
    noise = _train_noise(cfg, (2,), gen, device)
    (m_kernel, g_kernel, p_kernel, _), (m_plain, g_plain, p_plain, _) = _kernel_vs_plain_step(
        cfg, agent_state_from_checkpoint(load_state(out["checkpoints"][-1])), ((2,), False, obs_space), batch, noise,
        device)
    # the step's losses and gradient norms (METRIC_ORDER); the health stats
    # after them are not held: a dead-unit fraction moves by whole units
    # where a unit's activation sits at its threshold
    n = len(out["metric_order"])
    metric_err = float(np.max(np.abs(m_kernel[:n] - m_plain[:n]) / np.maximum(np.abs(m_plain[:n]), 1e-3)))
    health_err = float(np.max(np.abs(m_kernel[n:] - m_plain[n:]), initial=0.0))
    grad_err = max(((g_kernel[k] - g_plain[k]).abs().max() / g_plain[k].abs().max()).item() for k in g_plain)
    diff = (p_kernel - p_plain).abs()
    outliers = (diff > STEP_PARAM_ATOL).float().mean().item()
    if (not np.isfinite(m_kernel).all() or metric_err > STEP_METRIC_RTOL or grad_err > STEP_GRAD_RTOL
            or outliers > STEP_PARAM_OUTLIERS):
        raise AssertionError(f"offline kernel vs plain step: metrics {metric_err}, gradients {grad_err}, param "
                             f"outliers {outliers}; kernel {m_kernel}, plain {m_plain}")

    # the chunked bf16 step on the device ring's export
    ring = str(Path(chunked["run_dir"]) / "dataset")
    ring_keys = OfflineDataset(ring).keys
    if not {"rssm_recurrent", "rssm_posterior", "rssm_valid"} <= set(ring_keys):
        raise AssertionError(f"the device ring's export lacks the stored states: {sorted(ring_keys)}")
    c_overrides = OFFLINE_CHUNKED_OVERRIDES + [f"algo.offline.dataset_dir={ring}", f"fabric.accelerator={device}",
                                               f"root_dir={(build_dir / 'offline').resolve()}"]
    c_cfg = compose(c_overrides)
    _dv3_s_widths(c_cfg, "bf16-mixed")
    c_out, c_launches, _ = _offline_run(c_overrides, "offline chunked", OFFLINE_CHUNKED_STEPS)
    c_predicted, c_per_step = _launches(c_cfg, {**no_player, "gradient_steps": c_out["gradient_steps"]})
    if c_per_step != 64 // 4 + 2 + 15 or c_launches != c_predicted:
        raise AssertionError(f"offline chunked: {c_launches} launches, predicted {c_predicted} ({c_per_step} a step)")
    return {
        "live_streams": len(live_rows), "rows_vs_checkpoint": rows_vs_ckpt, "rows_vs_export_command": rows_vs_cli,
        "export_command_s": export_s, "gradient_steps": out["gradient_steps"], "ln_gru_launches": launches,
        "launches_per_gradient_step": per_step, "checkpoints": out["checkpoints"],
        "final_metrics": dict(zip(out["metric_order"], out["metric_rows"][-1].tolist())),
        "resume_start_iter": resumed["start_iter"], "resume_gradient_steps": resumed["gradient_steps"],
        "resume_launches": resume_launches, "sps_train": sps_train,
        "buffer_sample_share": sample_s / (sample_s + train_s) if sample_s + train_s else None,
        "buffer_sample_s": sample_s, "train_s": train_s, "flops_per_step": journal["flops_per_step"],
        "step_metric_rel_err": metric_err, "step_health_abs_err": health_err, "step_grad_rel_err": grad_err,
        "step_param_outliers": outliers,
        "step_param_max_abs_err": diff.max().item(), "batch": batch, "ring_keys": sorted(ring_keys),
        "chunked_gradient_steps": c_out["gradient_steps"], "chunked_launches": c_launches,
        "chunked_launches_per_gradient_step": c_per_step,
        "chunked_final_metrics": dict(zip(c_out["metric_order"], c_out["metric_rows"][-1].tolist())),
        "chunked_sps_train": [m["Time/sps_train"] for m in c_out["logged"] if "Time/sps_train" in m],
    }


def run_offline_sac(build_dir: Path, sac: dict, droq: dict, device_name: str = "cuda", cpu: str = "cpu") -> dict:
    """``exp=sac`` and ``exp=droq`` offline with the conservative penalty
    (``cql_alpha=1``, actions in ±1) on their phases' live exports, at their
    widths; then two offline gradient steps of each from its first offline
    checkpoint on the card against the same two on the CPU (``cpu``), one
    dataset batch and the same draws."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.droq.droq import DroQFamily, draw_noise
    from sheeprl_tpu_torch.algos.sac.sac import SACFamily, draw_cql_noise
    from sheeprl_tpu_torch.data.datasets import OfflineDataset
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    out = {}
    for name, phase, family_cls in (("sac", sac, SACFamily), ("droq", droq, DroQFamily)):
        dataset_dir = str(Path(phase["run"]["log_dir"]) / "dataset")
        grad = OFFLINE_SAC_GRAD_STEPS[name]
        overrides = [f"exp={name}", *OFFLINE_SAC_OPTIONS, f"algo.offline.dataset_dir={dataset_dir}",
                     f"algo.offline.grad_steps_per_iter={grad}", f"run_name=chip_smoke_{name}_offline",
                     f"root_dir={(build_dir / 'offline').resolve()}", f"fabric.accelerator={device_name}"]
        t0 = time.monotonic()
        run, launches, journal = _offline_run(overrides, f"offline {name}", 4)
        seconds = time.monotonic() - t0
        family = run["family"]
        cfg, n, act = family.cfg, int(family.cfg.algo.per_rank_batch_size), family.act_dim
        dataset = OfflineDataset(dataset_dir)
        obs_dim = int(np.prod(dataset.key_specs["observations"][0]))
        obs_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)})
        action_space = spaces.Box(-1.0, 1.0, (act,), np.float32)
        feed = dataset.batches(n, seed=17, mode="flat",
                               keys=["observations", "next_observations", "actions", "rewards", "terminated"])
        draws = [next(feed) for _ in range(2)]
        data = {k: torch.from_numpy(np.stack([d[k] for d in draws]).astype(np.float32)) for k in draws[0]}
        gen = torch.Generator().manual_seed(19)
        if name == "sac":
            eps = torch.randn(2, n, act, generator=gen)
            cql = draw_cql_noise(family.agent.actor, 2, family.cql_samples, n, gen, cpu)
            noise_fn = lambda d: (eps.to(d), _nested_to(cql, d))  # noqa: E731
        else:
            actor_obs = torch.from_numpy(np.stack([next(feed)["observations"] for _ in range(2)]).astype(np.float32))
            noise = draw_noise(family.agent, 2, n, act, gen, cpu, family.cql_samples)
            noise_fn = lambda d: ({"observations": actor_obs.to(d)}, _nested_to(noise, d))  # noqa: E731
        row = _card_vs_cpu(family_cls, cfg, obs_space, action_space, load_state(run["checkpoints"][0]), data,
                           noise_fn, devices=(device_name, cpu))
        key = f"{name}_offline"
        if not row["on_card"] or row["metric_rel_err"] > CARD_CPU_METRIC_RTOL[key] or \
                row["param_max_abs_err"] > CARD_CPU_PARAM_ATOL[key]:
            raise AssertionError(f"{key} card vs CPU: {row} (tol {CARD_CPU_METRIC_RTOL[key]}, "
                                 f"{CARD_CPU_PARAM_ATOL[key]})")
        out[name] = {"gradient_steps": run["gradient_steps"], "final": run["metric_rows"][-1].tolist(),
                     "launches": launches, "seconds": seconds, "dataset": run["dataset"],
                     "cql_samples": family.cql_samples, "card_vs_cpu": row, "grad_steps_per_call": grad,
                     "flops_per_call": journal["flops_per_step"],
                     "sps_train": [m["Time/sps_train"] for m in run["logged"] if "Time/sps_train" in m]}
    return out


def run_sac_profiles() -> dict:
    """The SAC (diagnostics off and on), DroQ and SAC-AE gradient steps
    through ``algos/sac/step_profile.py``, and SAC's and DroQ's with the
    conservative Q penalty (``cql_alpha=1``, the offline runs' step): stream
    and busy time, idle share, launches, FLOPs and step MFU at each preset's
    widths."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import time_gradient_steps
    from sheeprl_tpu_torch.algos.sac.step_profile import profiled_update
    from sheeprl_tpu_torch.diagnostics.telemetry import resolve_peak_flops

    out = {}
    cql = ["algo.offline.cql_alpha=1.0"]
    for name, exp, diagnostics, extra in (("sac", "sac", False, []), ("sac_diagnostics", "sac", True, []),
                                          ("droq", "droq", False, []), ("sac_ae", "sac_ae", False, []),
                                          ("sac_cql", "sac", True, cql), ("droq_cql", "droq", False, cql)):
        step, batch, info = profiled_update([f"exp={exp}", *extra], "cuda", diagnostics)
        timing = time_gradient_steps(step, None, batch, None, SAC_TIMED_STEPS, warmup=3, profile=True)
        peak = resolve_peak_flops(torch.cuda.get_device_name(0), info["precision"])
        top = sorted(timing["kernels"].items(), key=lambda kv: -kv[1][1])[:3]
        out[name] = {"step_ms": timing["step_ms"], "busy_ms": timing["busy_ms"], "idle_share": timing["idle_share"],
                     "launches": timing["launches"], "flops": info["flops"], "batch": info["batch_size"],
                     "params": info["params"],
                     "step_mfu": info["flops"] / (timing["step_ms"] / 1e3) / peak if peak else None,
                     "top": [(round(us / 1e3 / SAC_TIMED_STEPS, 4), k[:60]) for k, (_, us) in top]}
        del step, batch
    return out


def run_bf16_on_policy(build_dir: Path, device_name: str = "cuda") -> dict:
    """PPO at ``exp=ppo_atari``'s widths (one iteration of 8 envs x 128
    steps) and A2C, each under ``fabric.precision=bf16-mixed``: finite
    losses, the fp32 masters."""
    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru

    out = {}
    for name, overrides in (("ppo_bf16", PPO_OVERRIDES + ["algo.total_steps=1024", "checkpoint.every=1024",
                                                          "metric.logger=null", "run_name=chip_smoke_ppo_bf16"]),
                            ("a2c_bf16", A2C_OVERRIDES + ["run_name=chip_smoke_a2c_bf16"])):
        fused_layernorm_gru.launches = 0  # the main path starts here
        run = cli.run(overrides + ["fabric.precision=bf16-mixed", "algo.run_test=False",
                                   f"root_dir={(build_dir / name).resolve()}", f"fabric.accelerator={device_name}"])
        launches = fused_layernorm_gru.launches  # the main path ends here
        if not run["iterations"] or not np.isfinite(run["metric_rows"]).all():
            raise AssertionError(f"{name}: metric rows {run['metric_rows']}")
        out[name] = {"iterations": run["iterations"], "final": run["metric_rows"][-1].tolist(), "launches": launches}
        shutil.rmtree(build_dir / name, ignore_errors=True)
    return out


def run_timers(device_name: str = "cuda", offline_batch=None) -> dict:
    """Phase 10: the one gradient-step timer, profiled, for the fp32
    ``rssm_chunks=1`` step and the chunked bf16 one, each built as
    ``diagnostics=off`` runs it and as the default diagnostics run it (the
    health stats in the step, telemetry's instrumentation around it, which
    counts the step's FLOPs at its first call); launches here do not count.
    The step's MFU is its counted FLOPs over its stream time, against the
    card's peak for its precision.  With ``offline_batch`` (the offline
    loader's first batch, staged) the fp32 step under the default
    diagnostics runs on it: the offline loop's step, at the same shapes."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import profiled_step, time_gradient_steps
    from sheeprl_tpu_torch.diagnostics.telemetry import resolve_peak_flops

    out = {}
    for name, extra in (("fp32", []), ("bf16_chunked", CHUNKED_STEP_OPTIONS)):
        # off, then on: the step is host-bound and its time moves with the
        # host, so the two are compared within this call only
        for turn, diagnostics in enumerate((False, True)):
            step, moments, batch, gen = profiled_step(extra, device_name, diagnostics)
            if diagnostics and not extra and offline_batch is not None:
                batch = offline_batch
            timing = time_gradient_steps(step, moments, batch, gen, TIMED_STEPS, warmup=2, profile=True)
            gru = [v for k, v in timing["kernels"].items() if "ln_gru" in k]
            row = {"step_ms": timing["step_ms"], "steps_per_s": timing["steps_per_s"], "busy_ms": timing["busy_ms"],
                   "idle_share": timing["idle_share"], "launches": timing["launches"],
                   "ln_gru_launches": sum(v[0] for v in gru) // TIMED_STEPS,
                   "ln_gru_ms": sum(v[1] for v in gru) / 1e3 / TIMED_STEPS}
            if diagnostics:
                peak = resolve_peak_flops(torch.cuda.get_device_name(0), "bf16-mixed" if extra else "32-true")
                row["flops_per_step"] = step.flops_per_call
                row["step_mfu"] = step.flops_per_call / (timing["step_ms"] / 1e3) / peak if peak else None
            out[f"{name}_{'diagnostics' if diagnostics else 'off'}_{turn}"] = row
            del step, moments, batch
    return out


def _dv2_widths(cfg, precision: str = "32-true") -> None:
    wm_cfg = cfg.algo.world_model
    widths = (wm_cfg.recurrent_model.recurrent_state_size, cfg.algo.dense_units, cfg.algo.mlp_layers,
              wm_cfg.encoder.cnn_channels_multiplier, wm_cfg.stochastic_size, wm_cfg.discrete_size,
              wm_cfg.representation_model.hidden_size, wm_cfg.transition_model.hidden_size,
              wm_cfg.recurrent_model.layer_norm, cfg.algo.per_rank_batch_size, cfg.algo.per_rank_sequence_length,
              cfg.algo.horizon, cfg.fabric.precision, cfg.env.screen_size, list(cfg.algo.cnn_keys.encoder))
    if widths != (600, 400, 4, 48, 32, 32, 600, 600, True, 16, 50, 15, precision, 64, ["rgb"]):
        raise AssertionError(f"the DreamerV2 config is not exp=dreamer_v2's widths ({precision}): {widths}")


def _dv1_widths(cfg) -> None:
    wm_cfg = cfg.algo.world_model
    widths = (wm_cfg.recurrent_model.recurrent_state_size, cfg.algo.dense_units, wm_cfg.encoder.cnn_channels_multiplier,
              wm_cfg.stochastic_size, wm_cfg.representation_model.hidden_size, cfg.algo.per_rank_batch_size,
              cfg.algo.per_rank_sequence_length, cfg.algo.horizon, cfg.fabric.precision, cfg.env.screen_size)
    if widths != (200, 400, 32, 30, 200, 50, 50, 15, "32-true", 64):
        raise AssertionError(f"the DreamerV1 config is not exp=dreamer_v1's widths: {widths}")


def _dreamer_run(overrides, where: str, min_steps: int, device: str) -> tuple:
    """One ``run`` of the Dreamer family on the card, its kernel launches
    counted from just before to just after: every metric finite, the
    launches as the run's counters predict."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru

    cfg = compose(overrides)
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here
    rows = out["metric_rows"]
    if out["gradient_steps"] < min_steps or rows.shape[1] != 11 or not np.isfinite(rows).all():
        raise AssertionError(f"{where}: {out['gradient_steps']} gradient steps, metric rows {rows}")
    return cfg, out, launches


def _dv1_noise(cfg, actions_dim, gen, device: str = "cuda"):
    """Every draw of one DreamerV1 gradient step, pre-drawn on the card: the
    Gaussian latents' standard normals, the discrete heads' Gumbel noise."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import gumbel_like

    T, B, H, S = (cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, cfg.algo.horizon,
                  cfg.algo.world_model.stochastic_size)

    def normal(*shape):
        return torch.randn(shape, device=device, generator=gen)

    return {"dynamic": (normal(T, B, S), normal(T, B, S)), "imagination": normal(H, T * B, S),
            "actor": [[gumbel_like(torch.empty(T * B, d, device=device), gen) for d in actions_dim]
                      for _ in range(H)]}


def run_dv2(build_dir: Path, device_name: str = "cuda") -> dict:
    """DreamerV2 trains on the card through ``run`` at ``exp=dreamer_v2``'s
    widths (``DV2_OVERRIDES``) under the default diagnostics: every metric
    finite, the world model, actor and critic changed, the kernel's
    launches as the run's counters predict (50 calls of 16 rows and 15 of
    800 a gradient step), both checkpoints verified; then one gradient step
    from the last through the kernel and through the plain path, which must
    agree; then a run through the episode buffer and one in bf16-mixed."""
    device = device_name
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.serving.loader import _actions_dim, agent_state_from_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = DV2_OVERRIDES + [f"root_dir={(build_dir / 'dv2').resolve()}", f"fabric.accelerator={device}"]
    cfg, out, launches = _dreamer_run(overrides, "dv2", DV2_MIN_GRADIENT_STEPS, device)
    _dv2_widths(cfg)
    predicted, per_step = _launches(cfg, out)
    if launches != predicted:
        raise AssertionError(f"dv2: ln_gru launched {launches} times; the run predicts {predicted} "
                             f"({out['gradient_steps']} gradient steps x {per_step} + {out['player_steps']} player "
                             f"steps + {out['test_steps']} test steps)")
    sps = _timer_metrics(out["logged"], "dv2")
    journal = _journal_of(out["log_dir"])
    _check_diagnostics_journal(journal, "dv2", health=False)
    mid, ckpt = out["checkpoints"][0], out["checkpoints"][-1]
    for path in (mid, ckpt):
        if verify_checkpoint(path) != (True, "verified"):
            raise AssertionError(f"dv2: checkpoint {path} does not verify by its manifest: {verify_checkpoint(path)}")
    state = load_state(ckpt)
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous, _ = _actions_dim(env.action_space)
    spaces_ = (actions_dim, is_continuous, env.observation_space)
    env.close()
    initial = build_agent(actions_dim, is_continuous, cfg, spaces_[2], None, "cpu").trees()
    changed = {}
    for tree in ("world_model", "actor", "critic"):
        before, after = dict(_leaves(initial[tree])), dict(_leaves(state[tree]))
        changed[tree] = sum(not np.array_equal(before[p], after[p]) for p in before)
        if changed[tree] == 0:
            raise AssertionError(f"dv2: training left every parameter of {tree} unchanged")

    gen = torch.Generator(device=device).manual_seed(17)
    batch = synthetic_batch(cfg, actions_dim, gen, device)
    noise = _train_noise(cfg, actions_dim, gen, device)
    (m_kernel, g_kernel, p_kernel, _), (m_plain, g_plain, p_plain, _) = _kernel_vs_plain_step(
        cfg, agent_state_from_checkpoint(state), spaces_, batch, noise, device)
    metric_err = float(np.max(np.abs(m_kernel - m_plain) / np.maximum(np.abs(m_plain), 1e-3)))
    grad_err = max(((g_kernel[k] - g_plain[k]).abs().max() / g_plain[k].abs().max()).item() for k in g_plain)
    diff = (p_kernel - p_plain).abs()
    param_err, outliers = diff.max().item(), (diff > STEP_PARAM_ATOL).float().mean().item()
    if (not np.isfinite(m_kernel).all() or metric_err > STEP_METRIC_RTOL or grad_err > STEP_GRAD_RTOL
            or outliers > STEP_PARAM_OUTLIERS):
        raise AssertionError(
            f"dv2 kernel vs plain gradient step: metrics relative error {metric_err} (tol {STEP_METRIC_RTOL}), "
            f"gradients relative error {grad_err} (tol {STEP_GRAD_RTOL}), share of params off by more than "
            f"{STEP_PARAM_ATOL}: {outliers} (tol {STEP_PARAM_OUTLIERS}); kernel {m_kernel}, plain {m_plain}")

    runs = {}
    for name, extra in (("episode", DV2_EPISODE_OVERRIDES), ("bf16", DV2_BF16_OVERRIDES)):
        run_overrides = extra + [f"root_dir={(build_dir / f'dv2_{name}').resolve()}", f"fabric.accelerator={device}"]
        run_cfg, run, run_launches = _dreamer_run(run_overrides, f"dv2 {name}", 1, device)
        if name == "bf16":
            _dv2_widths(run_cfg, "bf16-mixed")
        run_predicted, run_per_step = _launches(run_cfg, run)
        if run_launches != run_predicted:
            raise AssertionError(f"dv2 {name}: ln_gru launched {run_launches} times, predicted {run_predicted}")
        runs[name] = {"gradient_steps": run["gradient_steps"], "player_steps": run["player_steps"],
                      "ln_gru_launches": run_launches, "launches_per_gradient_step": run_per_step,
                      "final_metrics": run["metric_rows"][-1].tolist()}
        shutil.rmtree(build_dir / f"dv2_{name}", ignore_errors=True)
    return {
        "gradient_steps": out["gradient_steps"], "player_steps": out["player_steps"], "test_steps": out["test_steps"],
        "policy_steps": out["policy_steps"], "ln_gru_launches": launches, "launches_per_gradient_step": per_step,
        "changed_leaves": changed, "final_metrics": dict(zip(out["metric_order"], out["metric_rows"][-1].tolist())),
        "step_metric_rel_err": metric_err, "step_grad_rel_err": grad_err, "step_param_max_abs_err": param_err,
        "step_param_outliers": outliers, "checkpoint": ckpt, "mid_checkpoint": mid, "overrides": overrides,
        "journal": journal, "sps": sps, "runs": runs,
    }


def run_dreamer_resume(run: dict, where: str, device_name: str = "cuda", kernel: bool = True,
                       imaginations: int = 1) -> dict:
    """``run checkpoint.resume_from=<the run's mid-run checkpoint>``: the
    trees and optimizer states restored as saved, and the run trains on,
    the kernel's launches as predicted for ``imaginations`` imaginations a
    gradient step (none without ``kernel``: DreamerV1's plain GRU)."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_params import optax_state
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    saved = load_state(run["mid_checkpoint"])
    restored = {}
    load_learner_state = dv3.load_learner_state

    def spy_learner(state, agent, optimizers, device):
        moments = load_learner_state(state, agent, optimizers, device)
        restored["trees"] = {k: {p: np.array(v) for p, v in _leaves(t)} for k, t in agent.trees().items()}
        restored["adam"] = {n: _optax_leaves(optax_state(o, agent.optimizer_spec(n))) for n, o in optimizers.items()}
        return moments

    overrides = run["overrides"] + [f"checkpoint.resume_from={run['mid_checkpoint']}", "checkpoint.every=100000"]
    cfg = compose(overrides)
    with mock.patch.object(dv3, "load_learner_state", spy_learner):
        fused_layernorm_gru.launches = 0  # the main path starts here
        out = cli.run(overrides)
        if device_name != "cpu":
            torch.cuda.synchronize()
        launches = fused_layernorm_gru.launches  # the main path ends here
    problems = [f"{tree}{p}" for tree, leaves in restored["trees"].items() for p, v in leaves.items()
                if not np.array_equal(v, dict(_leaves(saved[tree]))[p])]
    for name, entry in saved["opt_states"].items():
        for path, value in _optax_leaves(entry).items():
            if not np.array_equal(restored["adam"][name].get(path), value):
                problems.append(f"Adam {name} {path}")
    predicted = _launches(cfg, out, imaginations)[0] if kernel else 0
    if (out["start_iter"] != saved["iter_num"] + 1 or out["gradient_steps"] < 1 or launches != predicted
            or not np.isfinite(out["metric_rows"]).all()):
        problems.append(f"start_iter {out['start_iter']}, {out['gradient_steps']} gradient steps, {launches} "
                        f"launches (predicted {predicted}), metrics {out['metric_rows']}")
    if problems:
        raise AssertionError(f"{where} resume from {run['mid_checkpoint']}: " + "; ".join(problems[:10]))
    return {"start_iter": out["start_iter"], "gradient_steps": out["gradient_steps"],
            "player_steps": out["player_steps"], "test_steps": out["test_steps"], "ln_gru_launches": launches,
            "optimizers": sorted(saved["opt_states"])}


def run_dreamer_eval(run: dict, where: str, device_name: str = "cuda") -> dict:
    """``eval`` of the run's last checkpoint, then ``serve``, which refuses
    it as the JAX package does (no adapter for DreamerV1 or V2)."""
    import math

    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.serving.server import ServeApp

    fused_layernorm_gru.launches = 0  # the main path starts here
    reward = cli.evaluation([f"checkpoint_path={run['checkpoint']}", f"fabric.accelerator={device_name}"])
    if device_name != "cpu":
        torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here
    if not math.isfinite(reward):
        raise AssertionError(f"{where} eval: test reward {reward}")
    cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={run['checkpoint']}", "serving.port=0",
                                               f"fabric.accelerator={device_name}"])
    try:
        app = ServeApp(cfg, ckpt_path, device)
    except ValueError as err:
        refusal = str(err)
    else:
        app.close()
        raise AssertionError(f"serve accepted a {where} checkpoint; the JAX package has no adapter for it")
    if "no servable adapter" not in refusal:
        raise AssertionError(f"serve refused the {where} checkpoint for another reason: {refusal}")
    return {"test_reward": reward, "ln_gru_launches": launches, "serve_refusal": refusal}


def run_dv1(build_dir: Path, device_name: str = "cuda") -> dict:
    """DreamerV1 trains on the card through ``run`` at ``exp=dreamer_v1``'s
    widths (``DV1_OVERRIDES``): every metric finite, the three trees
    changed, no kernel launch (its GRU has no LayerNorm), both checkpoints
    verified."""
    device = device_name
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.serving.loader import _actions_dim
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = DV1_OVERRIDES + [f"root_dir={(build_dir / 'dv1').resolve()}", f"fabric.accelerator={device}"]
    cfg, out, launches = _dreamer_run(overrides, "dv1", DV1_MIN_GRADIENT_STEPS, device)
    _dv1_widths(cfg)
    if launches != 0:
        raise AssertionError(f"dv1: ln_gru launched {launches} times; DreamerV1's GRU has no LayerNorm")
    sps = _timer_metrics(out["logged"], "dv1")
    journal = _journal_of(out["log_dir"])
    _check_diagnostics_journal(journal, "dv1", health=False)
    mid, ckpt = out["checkpoints"][0], out["checkpoints"][-1]
    for path in (mid, ckpt):
        if verify_checkpoint(path) != (True, "verified"):
            raise AssertionError(f"dv1: checkpoint {path} does not verify by its manifest: {verify_checkpoint(path)}")
    state = load_state(ckpt)
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous, _ = _actions_dim(env.action_space)
    obs_space = env.observation_space
    env.close()
    initial = build_agent(actions_dim, is_continuous, cfg, obs_space, None, "cpu").trees()
    changed = {}
    for tree in ("world_model", "actor", "critic"):
        before, after = dict(_leaves(initial[tree])), dict(_leaves(state[tree]))
        changed[tree] = sum(not np.array_equal(before[p], after[p]) for p in before)
        if changed[tree] == 0:
            raise AssertionError(f"dv1: training left every parameter of {tree} unchanged")
    return {
        "gradient_steps": out["gradient_steps"], "player_steps": out["player_steps"], "test_steps": out["test_steps"],
        "policy_steps": out["policy_steps"], "ln_gru_launches": launches, "changed_leaves": changed,
        "final_metrics": dict(zip(out["metric_order"], out["metric_rows"][-1].tolist())), "checkpoint": ckpt,
        "mid_checkpoint": mid, "overrides": overrides, "journal": journal, "sps": sps,
    }


def run_dreamer_timers(device_name: str = "cuda") -> dict:
    """The DreamerV2 gradient step in fp32 and in bf16-mixed and the
    DreamerV1 step, each built as the default diagnostics run it (their JAX
    steps compute no health stats; telemetry counts the FLOPs at the first
    call): stream time, device-busy time, idle share, launches, the
    kernel's share, FLOPs and the step's MFU against the card's peak for
    its precision."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import profiled_step, time_gradient_steps
    from sheeprl_tpu_torch.diagnostics.telemetry import resolve_peak_flops

    out = {}
    for name, overrides in (("dv2_fp32", ["exp=dreamer_v2"]),
                            ("dv2_bf16", ["exp=dreamer_v2", "fabric.precision=bf16-mixed"]),
                            ("dv1_fp32", ["exp=dreamer_v1"])):
        torch.cuda.reset_peak_memory_stats()
        step, moments, batch, gen = profiled_step(overrides, device_name, True)
        timing = time_gradient_steps(step, moments, batch, gen, DREAMER_TIMED_STEPS, warmup=2, profile=True)
        gru = [v for k, v in timing["kernels"].items() if "ln_gru" in k]
        peak = resolve_peak_flops(torch.cuda.get_device_name(0), "bf16-mixed" if "bf16" in name else "32-true")
        out[name] = {"step_ms": timing["step_ms"], "stream_ms": timing["stream_ms"], "busy_ms": timing["busy_ms"],
                     "idle_share": timing["idle_share"], "launches": timing["launches"],
                     "ln_gru_launches": sum(v[0] for v in gru) // DREAMER_TIMED_STEPS,
                     "ln_gru_ms": sum(v[1] for v in gru) / 1e3 / DREAMER_TIMED_STEPS,
                     "flops_per_step": step.flops_per_call,
                     "step_mfu": step.flops_per_call / (timing["step_ms"] / 1e3) / peak if peak else None,
                     "max_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                     "top": sorted(((v[1] / DREAMER_TIMED_STEPS / 1e3, k[:60]) for k, v in timing["kernels"].items()),
                                   reverse=True)[:4]}
        del step, moments, batch
    return out


def _p2e_dreamer_widths(version: int):
    """The width check of ``exp=p2e_dv<version>_exploration`` (and of its
    finetuning, which takes the exploration's widths)."""

    def check(cfg) -> None:
        wm_cfg, ens = cfg.algo.world_model, cfg.algo.ensembles
        widths = (wm_cfg.recurrent_model.recurrent_state_size, wm_cfg.recurrent_model.dense_units, cfg.algo.dense_units,
                  cfg.algo.mlp_layers, wm_cfg.encoder.cnn_channels_multiplier, wm_cfg.stochastic_size,
                  wm_cfg.get("discrete_size"), wm_cfg.representation_model.hidden_size,
                  wm_cfg.transition_model.hidden_size, cfg.algo.per_rank_batch_size,
                  cfg.algo.per_rank_sequence_length, cfg.algo.horizon, cfg.fabric.precision, cfg.env.screen_size,
                  list(cfg.algo.cnn_keys.encoder), cfg.env.num_envs)
        want = {2: (400, 400, 400, 4, 48, 32, 32, 400, 400, 16, 50, 15, "32-true", 64, ["rgb"], 4),
                1: (400, 400, 400, 4, 32, 60, None, 400, 400, 50, 50, 15, "32-true", 64, ["rgb"], 4)}[version]
        if widths != want or (cfg.algo.name.endswith("exploration") and (ens.n, ens.dense_units, ens.mlp_layers) != (
                10, 400, 4)):
            raise AssertionError(f"the P2E-DV{version} config is not exp=p2e_dv{version}_exploration's widths: "
                                 f"{widths}, ensembles {ens.n} x {ens.dense_units} x {ens.mlp_layers}")

    return check


def run_p2e_dreamer(build_dir: Path, version: int, device_name: str = "cuda") -> dict:
    """Plan2Explore on DreamerV2 (``version=2``) or V1 explores on the card
    through ``run`` at its preset's widths (``P2E_DREAMER_OVERRIDES``):
    every one of the 20 metrics finite, the intrinsic reward positive; the
    world model, the ensembles, both actors and both critics changed; the
    kernel's launches as the counters predict for two imaginations a step
    (P2E-DV2: 50 calls of 16 rows and 2 x 15 of 800; P2E-DV1's plain GRU
    none); the journal of the default diagnostics (no health stats: the
    JAX step has none); both checkpoints verified; then, for P2E-DV2, one
    exploration step from the last through the kernel and through the plain
    path, which must agree."""
    device = device_name
    import math

    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.serving.loader import _actions_dim
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    where = f"p2e_dv{version}"
    overrides = P2E_DREAMER_OVERRIDES[version] + [f"root_dir={(build_dir / where).resolve()}",
                                                  f"fabric.accelerator={device}"]
    cfg = compose(overrides)
    _p2e_dreamer_widths(version)(cfg)
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here

    rows, order = out["metric_rows"], out["metric_order"]
    sps = _timer_metrics(out["logged"], where)
    intrinsic = rows[:, order.index("Rewards/intrinsic")]
    if (out["gradient_steps"] < P2E_DREAMER_MIN_GRADIENT_STEPS or rows.shape[1] != len(order) or len(order) != 20
            or not np.isfinite(rows).all() or not (intrinsic > 0).all()
            or [name for _, name in out["player_actors"]] != ["actor_exploration"]):
        raise AssertionError(f"{where}: {out['gradient_steps']} gradient steps, metric rows {rows}, player actors "
                             f"{out['player_actors']}")
    predicted, per_step = _launches(cfg, out, imaginations=2) if version == 2 else (0, 0)
    if launches != predicted or per_step != P2E_DREAMER_LAUNCHES[version][0]:
        raise AssertionError(f"{where}: ln_gru launched {launches} times; the run predicts {predicted} "
                             f"({out['gradient_steps']} gradient steps x {per_step} + {out['player_steps']} player "
                             f"steps + {out['test_steps']} test steps)")
    journal = _journal_of(out["log_dir"])
    _check_diagnostics_journal(journal, where, health=False)
    mid, ckpt = out["checkpoints"][0], out["checkpoints"][-1]
    for path in (mid, ckpt):
        if verify_checkpoint(path) != (True, "verified"):
            raise AssertionError(f"{where}: checkpoint {path} does not verify by its manifest: "
                                 f"{verify_checkpoint(path)}")
    state, initial = load_state(ckpt), load_state(mid)
    # the mid-run checkpoint holds the weights before the first gradient step
    if initial["opt_states"]["world_model"][1][0][0] != 0:
        raise AssertionError(f"{where}: the checkpoint {mid} was taken after a gradient step")
    changed = {}
    for tree in ("world_model", "ensembles", "actor_exploration", "critic_exploration", "actor_task", "critic_task"):
        before, after = dict(_leaves(initial[tree])), dict(_leaves(state[tree]))
        changed[tree] = sum(not np.array_equal(before[p], after[p]) for p in before)
        if changed[tree] == 0:
            raise AssertionError(f"{where}: training left every parameter of {tree} unchanged")
    del initial
    report = {
        "gradient_steps": out["gradient_steps"], "player_steps": out["player_steps"], "test_steps": out["test_steps"],
        "policy_steps": out["policy_steps"], "ln_gru_launches": launches, "launches_per_gradient_step": per_step,
        "changed_leaves": changed, "final_metrics": dict(zip(order, rows[-1].tolist())), "checkpoint": ckpt,
        "mid_checkpoint": mid, "overrides": overrides, "journal": journal, "sps": sps,
        "intrinsic": [float(x) for x in intrinsic],
    }
    if version == 2:
        env = make_env(cfg, cfg.seed, 0)()
        actions_dim, is_continuous, _ = _actions_dim(env.action_space)
        spaces_ = (actions_dim, is_continuous, env.observation_space)
        env.close()
        gen = torch.Generator(device=device).manual_seed(13)
        batch = synthetic_batch(cfg, actions_dim, gen, device)
        noise = _p2e_noise(cfg, actions_dim, gen, device)
        (m_kernel, g_kernel, p_kernel, _), (m_plain, g_plain, p_plain, _) = _kernel_vs_plain_step(
            cfg, state, spaces_, batch, noise, device)
        metric_err = float(np.max(np.abs(m_kernel - m_plain) / np.maximum(np.abs(m_plain), 1e-3)))
        grad_err = max(((g_kernel[k] - g_plain[k]).abs().max() / g_plain[k].abs().max().clamp_min(1e-30)).item()
                       for k in g_plain)
        diff = (p_kernel - p_plain).abs()
        param_err, outliers = diff.max().item(), (diff > STEP_PARAM_ATOL).float().mean().item()
        if (not np.isfinite(m_kernel).all() or metric_err > STEP_METRIC_RTOL or grad_err > STEP_GRAD_RTOL
                or outliers > STEP_PARAM_OUTLIERS or not math.isfinite(param_err)):
            raise AssertionError(
                f"{where} kernel vs plain exploration step: metrics relative error {metric_err} (tol "
                f"{STEP_METRIC_RTOL}), gradients relative error {grad_err} (tol {STEP_GRAD_RTOL}), share of params "
                f"off by more than {STEP_PARAM_ATOL}: {outliers} (tol {STEP_PARAM_OUTLIERS}); kernel {m_kernel}, "
                f"plain {m_plain}")
        report.update(step_metric_rel_err=metric_err, step_grad_rel_err=grad_err, step_param_max_abs_err=param_err,
                      step_param_outliers=outliers)
    return report


def run_p2e_dreamer_timers(device_name: str = "cuda") -> dict:
    """The P2E-DV2 and P2E-DV1 exploration steps as the default diagnostics
    build them (telemetry's instrumentation counting the FLOPs at the first
    call; the JAX steps have no health stats): stream time, device-busy
    time, idle share, launches, the kernel's launches and time, FLOPs, the
    step's MFU and the peak memory."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import profiled_step, time_gradient_steps
    from sheeprl_tpu_torch.diagnostics.telemetry import resolve_peak_flops

    out = {}
    peak = resolve_peak_flops(torch.cuda.get_device_name(0), "32-true")
    for version in (2, 1):
        torch.cuda.reset_peak_memory_stats()
        step, moments, batch, gen = profiled_step([f"exp=p2e_dv{version}_exploration"], device_name, True)
        timing = time_gradient_steps(step, moments, batch, gen, P2E_DREAMER_TIMED_STEPS, warmup=2, profile=True)
        gru = [v for k, v in timing["kernels"].items() if "ln_gru" in k]
        out[f"p2e_dv{version}"] = {
            "step_ms": timing["step_ms"], "stream_ms": timing["stream_ms"], "busy_ms": timing["busy_ms"],
            "idle_share": timing["idle_share"], "launches": timing["launches"],
            "ln_gru_launches": sum(v[0] for v in gru) // P2E_DREAMER_TIMED_STEPS,
            "ln_gru_ms": sum(v[1] for v in gru) / 1e3 / P2E_DREAMER_TIMED_STEPS, "flops_per_step": step.flops_per_call,
            "step_mfu": step.flops_per_call / (timing["step_ms"] / 1e3) / peak if peak else None,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
            "top": sorted(((v[1] / P2E_DREAMER_TIMED_STEPS / 1e3, k[:60]) for k, v in timing["kernels"].items()),
                          reverse=True)[:4]}
        del step, moments, batch
    return out


def _ppo_rec_widths(cfg) -> None:
    algo = cfg.algo
    widths = (cfg.env.num_envs, algo.rollout_steps, algo.per_rank_sequence_length, algo.per_rank_num_batches,
              algo.update_epochs, algo.rnn.lstm.hidden_size, algo.encoder.dense_units, algo.max_grad_norm,
              str(algo.optimizer["_target_"]), cfg.fabric.precision)
    if widths != (16, 512, 16, 8, 8, 64, 64, 0.5, "optax.adamw", "32-true"):
        raise AssertionError(f"the recurrent PPO config is not exp=ppo_recurrent's widths: {widths}")


def run_ppo_recurrent(build_dir: Path, device_name: str = "cuda") -> dict:
    """Recurrent PPO on the card through ``run`` at ``exp=ppo_recurrent``'s
    widths (``PPO_REC_OVERRIDES``): finite losses and ``Time/sps_*``, no
    kernel launch; a resume from its first checkpoint with adamw's state
    restored; ``eval``; ``serve`` over HTTP for two sessions with a reset
    each, every greedy action equal to the player's from the same state;
    a ``bf16-mixed`` iteration."""
    import math

    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import prev_actions_of
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.parallel.precision import call_cast
    from sheeprl_tpu_torch.serving.server import ServeApp
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = PPO_REC_OVERRIDES + [f"root_dir={(build_dir / 'ppo_rec').resolve()}", f"fabric.accelerator={device_name}"]
    cfg = compose(overrides)
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    launches = fused_layernorm_gru.launches  # the main path ends here
    _ppo_rec_widths(cfg)
    rows = out["metric_rows"]
    if out["iterations"] != 2 or rows.shape != (2, 3) or not np.isfinite(rows).all() or len(out["checkpoints"]) != 2 \
            or launches != 0:
        raise AssertionError(f"ppo_recurrent: {out['iterations']} iterations, metric rows {rows}, checkpoints "
                             f"{out['checkpoints']}, {launches} ln_gru launches")
    sps = _timer_metrics(out["logged"], "ppo_recurrent")
    first = out["checkpoints"][0]
    saved = load_state(first)
    resumed = cli.run(overrides + [f"checkpoint.resume_from={first}", "algo.run_test=False",
                                   "root_dir=" + str((build_dir / "ppo_rec_resumed").resolve())])
    if resumed["start_iter"] != saved["iter_num"] + 1 or resumed["iterations"] != 1 or \
            not np.isfinite(resumed["metric_rows"]).all():
        raise AssertionError(f"ppo_recurrent resume from {first}: start_iter {resumed['start_iter']}, "
                             f"{resumed['iterations']} iterations")
    reward = cli.evaluation([f"checkpoint_path={out['checkpoints'][-1]}", f"fabric.accelerator={device_name}"])
    if not math.isfinite(reward):
        raise AssertionError(f"ppo_recurrent eval: test reward {reward}")

    serve_cfg, ckpt_path, device = cli.serve_config(
        [f"checkpoint_path={out['checkpoints'][-1]}", "serving.port=0", "serving.batch_buckets=[2,4]",
         "serving.max_delay_ms=2.0", f"fabric.accelerator={device_name}"])
    app = ServeApp(serve_cfg, ckpt_path, device)
    mismatches, replies = [], 0
    try:
        host, port = app.start()
        url = f"http://{host}:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if health.get("algo") != "ppo_recurrent" or health["models"]["default"]["stateful"] is not True:
            raise AssertionError(f"ppo_recurrent /healthz: {health}")
        agent, hidden = app.handle.params, int(serve_cfg.algo.rnn.lstm.hidden_size)
        carry = {s: None for s in range(PPO_REC_SESSIONS)}
        rng = np.random.default_rng(41)
        for rnd in range(PPO_REC_ROUNDS):
            for s in range(PPO_REC_SESSIONS):  # the sessions interleave
                reset = rnd == 0 or rnd == 3 + s  # a new episode in each session mid-way
                obs = rng.normal(size=10).astype(np.float32)
                status, reply = _post(url, {"obs": {"state": obs.tolist()}, "greedy": True, "session": f"s{s}",
                                            "reset": reset})
                if status != 200:
                    raise AssertionError(f"ppo_recurrent serve: {status} {reply}")
                replies += 1
                if reset or carry[s] is None:
                    carry[s] = (torch.zeros(1, hidden, device=device), torch.zeros(1, hidden, device=device),
                                torch.zeros(1, sum(app.handle.meta["actions_dim"]), device=device))
                hx, cx, prev = carry[s]
                with torch.no_grad():
                    acts, _, _, _, (hx, cx) = call_cast((agent,), torch.float32, lambda: agent(
                        {"state": torch.from_numpy(obs).to(device)[None, None]}, prev[None], hx, cx, greedy=True))
                carry[s] = (hx, cx, prev_actions_of(acts[0], app.handle.meta["actions_dim"], False))
                if reply["action"] != acts[0, 0].cpu().tolist():
                    mismatches.append((rnd, s, reply["action"], acts[0, 0].cpu().tolist()))
        stats = app.service.batcher.stats()
    finally:
        app.close()
    if mismatches:
        raise AssertionError(f"ppo_recurrent serve: served actions differ from the player's: {mismatches}")

    fused_layernorm_gru.launches = 0  # the main path starts here
    one_rollout = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
    mixed = cli.run(overrides + ["fabric.precision=bf16-mixed", f"algo.total_steps={one_rollout}", "algo.run_test=False",
                                 "root_dir=" + str((build_dir / "ppo_rec_bf16").resolve())])
    mixed_launches = fused_layernorm_gru.launches  # the main path ends here
    if mixed["iterations"] != 1 or not np.isfinite(mixed["metric_rows"]).all():
        raise AssertionError(f"ppo_recurrent bf16-mixed: metric rows {mixed['metric_rows']}")
    for path in ("ppo_rec_resumed", "ppo_rec_bf16"):
        shutil.rmtree(build_dir / path, ignore_errors=True)
    return {"iterations": out["iterations"], "final_losses": rows[-1].tolist(), "sps": sps,
            "test_reward": out["test_reward"], "resume_start_iter": resumed["start_iter"], "eval_reward": reward,
            "served": replies, "dispatches": stats["dispatches_total"], "ln_gru_launches": launches,
            "bf16_final": mixed["metric_rows"][-1].tolist(), "bf16_launches": mixed_launches,
            "checkpoints": out["checkpoints"]}


def run_ppo_recurrent_timer(device_name: str = "cuda") -> dict:
    """One recurrent PPO minibatch update at ``exp=ppo_recurrent``'s widths
    (64 sequences of 16 steps, the LSTM of 64 run step by step): stream
    time, device-busy time, launches, idle share and FLOPs."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import time_gradient_steps
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import make_train_step, sequence_layout
    from sheeprl_tpu_torch.config import compose, instantiate
    from sheeprl_tpu_torch.diagnostics.telemetry import count_flops
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.serving.loader import _actions_dim

    cfg = compose(PPO_REC_OVERRIDES + [f"fabric.accelerator={device_name}"])
    _, seq_batch, _ = sequence_layout(cfg)
    cfg.algo.update_epochs = 1  # one minibatch update a call
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous, _ = _actions_dim(env.action_space)
    agent = build_agent(actions_dim, is_continuous, cfg, env.observation_space, None, device_name)
    env.close()
    update = make_train_step(agent, instantiate(cfg.algo.optimizer)(agent.parameters()), cfg, 1, seq_batch)
    L, gen = int(cfg.algo.per_rank_sequence_length), torch.Generator(device=device_name).manual_seed(5)
    hidden = int(cfg.algo.rnn.lstm.hidden_size)

    def randn(*shape):
        return torch.randn(shape, device=device_name, generator=gen)

    data = {"obs": {"state": randn(L, seq_batch, 10)},
            "prev_actions": torch.nn.functional.one_hot(torch.randint(0, 2, (L, seq_batch), device=device_name,
                                                                      generator=gen), 2).float(),
            "actions": torch.randint(0, 2, (L, seq_batch, 1), device=device_name, generator=gen).float(),
            "logprobs": randn(L, seq_batch, 1) - 0.7, "values": randn(L, seq_batch, 1),
            "returns": randn(L, seq_batch, 1), "advantages": randn(L, seq_batch, 1),
            "resets": (torch.rand((L, seq_batch, 1), device=device_name, generator=gen) < 0.2).float(),
            "hx0": randn(seq_batch, hidden), "cx0": randn(seq_batch, hidden)}
    perms = [torch.arange(seq_batch, device=device_name)]

    def step(moments, batch, tau, generator):
        return moments, update(batch, perms, (0.2, 0.001, 0.2))

    flops = count_flops(lambda: step(None, data, 0.0, None))[1]
    timing = time_gradient_steps(step, None, data, None, PPO_REC_TIMED_UPDATES, warmup=3, profile=True)
    return {"step_ms": timing["step_ms"], "busy_ms": timing["busy_ms"], "idle_share": timing["idle_share"],
            "launches": timing["launches"], "flops": flops, "seq_batch": seq_batch,
            "params": sum(p.numel() for p in agent.parameters()),
            "top": sorted(((v[1] / PPO_REC_TIMED_UPDATES / 1e3, k[:60]) for k, v in timing["kernels"].items()),
                          reverse=True)[:3]}


def count_cpu_flops() -> float:
    """The FLOPs ``FlopCounterMode`` counts for one fp32 DreamerV3-S
    gradient step on the CPU (the same config and batch shapes as the
    card's): the card's count must equal it."""
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import profiled_step
    from sheeprl_tpu_torch.diagnostics.telemetry import count_flops

    step, moments, batch, gen = profiled_step(["fabric.accelerator=cpu"], "cpu")
    return count_flops(lambda: step(moments, batch, 0.02, gen))[1]


def _optax_leaves(node, path="") -> dict:
    """``{path: array}`` of an optax state as the port writes it
    (``OptaxState``) or reads it back (``ForeignObject``, a tuple)."""
    import numpy as np

    from sheeprl_tpu_torch.utils.checkpoint import OptaxState

    if isinstance(node, OptaxState):
        node = node.fields
    if isinstance(node, dict):
        return {p: v for k, sub in node.items() for p, v in _optax_leaves(sub, f"{path}/{k}").items()}
    if isinstance(node, tuple):
        return {p: v for i, sub in enumerate(node) for p, v in _optax_leaves(sub, f"{path}[{i}]").items()}
    return {path: np.asarray(node)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from sheeprl_tpu_torch.ops import cuda_build

    build_dir = ROOT / "build" / "chip_smoke"
    build_dir.mkdir(parents=True, exist_ok=True)
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; nvidia-smi name,power.limit:", flush=True)
    print(card, flush=True)

    # the wall time of each group of phases, printed before the kernels line
    stamps = [("start", time.monotonic())]

    def mark(done: str) -> None:
        stamps.append((done, time.monotonic()))

    t0 = time.monotonic()
    report = cuda_build.build()
    print(f"[build] {len(report)} kernel(s) in {time.monotonic() - t0:.1f} s", flush=True)
    for name, rep in report.items():
        print(f"[build] {name}: {rep['path']} ({rep['seconds']:.1f} s)", flush=True)
        for line in _ptxas_summary(str(rep["ptxas"])):
            print(f"[build] {name} ptxas {line}", flush=True)

    mark("build")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true fp32
    torch.backends.cudnn.allow_tf32 = False
    cases = []
    for (hidden, in_dim), batch in KERNEL_CASES:
        for dtype_name in ("float32", "bfloat16"):
            row = measure_ln_gru(batch, hidden, in_dim, dtype_name)
            cases.append(row)
            print(
                f"[kernel] ln_gru B={batch:<4d} K={row['K']:<5d} H={hidden:<5d} {dtype_name:<8s} "
                f"max_abs_err={row['max_abs_err']:.3g} (tol {row['tolerance']:g})  ms={row['ms']:.5f} "
                f"ms_cold={row['ms_cold']:.5f} plain_ms={row['plain_ms']:.5f} matmul_ms={row['library_ms']:.5f} "
                f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}); {row['plan']}  [{card}]",
                flush=True,
            )
    for hidden, in_dim, batch in SWEEP_CASES:
        for dtype_name in ("float32", "bfloat16"):
            row = measure_ln_gru(batch, hidden, in_dim, dtype_name, seed=1, timed=False)
            print(f"[kernel] ln_gru sweep B={batch:<4d} K={row['K']:<5d} H={hidden:<5d} {dtype_name:<8s} "
                  f"max_abs_err={row['max_abs_err']:.3g} (tol {row['tolerance']:g})", flush=True)
    for (hidden, in_dim), batch, dtype_name in GRAD_CASES:
        err = check_ln_gru_graph(batch, hidden, in_dim, dtype_name)
        print(f"[kernel] ln_gru autograd graph B={batch:<4d} K={hidden + in_dim} H={hidden} {dtype_name}: the output "
              f"carries a graph; "
              f"joint, w, b, g, beta, h all get a finite {dtype_name} gradient, equal to autograd through the plain "
              f"version (the backward's own recompute) to {err:.3g} relative (tol {GRAD_TOLERANCE[dtype_name]:g}), "
              f"and their fp32 masters a finite fp32 gradient through the cast", flush=True)

    mark('kernel cases')
    slice_report = run_slice(build_dir)
    print(
        f"[slice] DreamerV3-S serve: {slice_report['requests']} /act from {slice_report['sessions']} sessions, "
        f"all 200 and one-hot; {slice_report['dispatches']} dispatches + {slice_report['warmup_steps']} warm-up "
        f"steps = {slice_report['ln_gru_launches']} ln_gru launches; widths {slice_report['width_hist']}; "
        f"{slice_report['requests_per_s']:.1f} requests/s, p50 {slice_report['latency_p50_ms']:.2f} ms, "
        f"p99 {slice_report['latency_p99_ms']:.2f} ms; plain-path recompute recurrent max_abs_err "
        f"{slice_report['plain_recompute_recurrent_max_abs_err']:.3g}  [{card}]",
        flush=True,
    )

    mark('serve')
    train = run_train(build_dir)
    s_cases = {(c["B"], c["dtype"]): c for c in cases if c["H"] == 512}
    print(
        f"[train] DreamerV3-S run (batch 16 x 64, horizon 15, fp32): {train['gradient_steps']} gradient steps, "
        f"{train['player_steps']} player steps, {train['test_steps']} test-episode steps, {train['policy_steps']} "
        f"policy steps; {train['ln_gru_launches']} ln_gru launches = predicted "
        f"({train['launches_per_gradient_step']} per gradient step); every metric finite, final "
        f"{json.dumps(train['final_metrics'])}; leaves changed {train['changed_leaves']}; checkpoint served greedy "
        f"actions through serve's loader; through env.sync_env=False (the async executor): Time/sps_train "
        f"{train['sps']['Time/sps_train']}, Time/sps_env_interaction {train['sps']['Time/sps_env_interaction']}  "
        f"[{card}]",
        flush=True,
    )
    print(
        f"[train] kernel vs plain gradient step from one state, batch and noise: metrics max relative error "
        f"{train['step_metric_rel_err']:.3g} (tol {STEP_METRIC_RTOL:g}), gradients max relative error "
        f"{train['step_grad_rel_err']:.3g} (tol {STEP_GRAD_RTOL:g}), updated params: share off by more than "
        f"{STEP_PARAM_ATOL:g} {train['step_param_outliers']:.3g} (tol {STEP_PARAM_OUTLIERS:g}), max_abs_err "
        f"{train['step_param_max_abs_err']:.3g} (not held: at most 2 lr)  [{card}]",
        flush=True,
    )

    mark('train')
    chunked = run_chunked(build_dir)
    print(
        f"[chunked] DreamerV3-S run ({' '.join(CHUNKED_OPTIONS)}): {chunked['gradient_steps']} gradient steps, "
        f"{chunked['player_steps']} player steps, {chunked['test_steps']} test-episode steps, "
        f"{chunked['policy_steps']} policy steps; {chunked['ln_gru_launches']} ln_gru launches = predicted "
        f"({chunked['launches_per_gradient_step']} per gradient step: 16 x 64 rows + 2 x 48 + 15 x 1024, bf16); "
        f"every metric finite, final {json.dumps(chunked['final_metrics'])}; checkpoint {chunked['checkpoint']}; "
        f"through env.executor=shared_memory: Time/sps_train {chunked['sps']['Time/sps_train']}, "
        f"Time/sps_env_interaction {chunked['sps']['Time/sps_env_interaction']}  [{card}]", flush=True)
    print(
        f"[chunked] bf16 kernel vs plain gradient step from one state, batch and noise: losses max relative error "
        f"{chunked['step_loss_rel_err']:.3g} (tol {BF16_LOSS_RTOL:g}), gradient norms {chunked['step_norm_rel_err']:.3g} "
        f"(tol {BF16_NORM_RTOL:g}), Adam first moments ||kernel - plain|| / ||plain|| "
        f"{json.dumps(chunked['step_moment_rel_err'])} (tol {json.dumps(BF16_MOMENT_REL)})  [{card}]", flush=True)
    resumed = run_resume(chunked)
    print(
        f"[resume] run checkpoint.resume_from={resumed['resumed_from']}: started at iteration "
        f"{resumed['start_iter']}; counters, Ratio, Moments, Adam state ({resumed['adam_entries']} tensors' entries) "
        f"and the device ring ({resumed['replay_rows']} rows) restored as saved; then {resumed['gradient_steps']} "
        f"gradient steps, {resumed['player_steps']} player steps, {resumed['test_steps']} test steps, "
        f"{resumed['ln_gru_launches']} ln_gru launches = predicted; the world model moved  [{card}]", flush=True)
    evaluated = run_eval(chunked)
    print(f"[eval] eval checkpoint_path={chunked['checkpoint']}: Test/cumulative_reward {evaluated['test_reward']}, "
          f"{evaluated['ln_gru_launches']} ln_gru launches  [{card}]", flush=True)

    mark('chunked, resume, eval')
    offline = run_offline_dreamer(build_dir, train, chunked)
    print(f"[export] buffer.export=True: the fp32 run's live export ({offline['live_streams']} streams, "
          f"{offline['rows_vs_checkpoint']} rows) verifies and equals its checkpoint's replay bit for bit (the save's "
          f"truncation mark on each env's newest row aside); `python -m sheeprl_tpu_torch export <run dir>` "
          f"({offline['export_command_s']:.1f} s) wrote the same {offline['rows_vs_export_command']} rows; the "
          f"chunked run's device-ring export carries {offline['ring_keys']}  [{card}]", flush=True)
    print(f"[offline] DreamerV3-S run algo.offline.enabled=true (batch 16 x 64, horizon 15, fp32) on the fp32 run's "
          f"export: {offline['gradient_steps']} gradient steps, {offline['ln_gru_launches']} ln_gru launches = "
          f"predicted ({offline['launches_per_gradient_step']} per gradient step: 64 x 16 rows + 15 x 1024); every "
          f"metric finite, final {json.dumps(offline['final_metrics'])}; checkpoints {offline['checkpoints']} "
          f"verified, offline; Time/sps_train {offline['sps_train']}; buffer-sample span "
          f"{offline['buffer_sample_s']:.3f} s against train {offline['train_s']:.3f} s (share "
          f"{offline['buffer_sample_share']:.4f}); FLOPs counted {offline['flops_per_step']}; resumed from the first "
          f"checkpoint at iteration {offline['resume_start_iter']}, {offline['resume_gradient_steps']} gradient steps, "
          f"{offline['resume_launches']} ln_gru launches  [{card}]", flush=True)
    print(f"[offline] kernel vs plain offline gradient step from the last checkpoint and the loader's first batch: "
          f"losses and gradient norms max relative error {offline['step_metric_rel_err']:.3g} (tol "
          f"{STEP_METRIC_RTOL:g}; the health stats max_abs_err {offline['step_health_abs_err']:.3g}, not held), gradients "
          f"{offline['step_grad_rel_err']:.3g} (tol {STEP_GRAD_RTOL:g}), params off by more than {STEP_PARAM_ATOL:g}: "
          f"{offline['step_param_outliers']:.3g} (tol {STEP_PARAM_OUTLIERS:g}), max_abs_err "
          f"{offline['step_param_max_abs_err']:.3g} (not held)  [{card}]", flush=True)
    print(f"[offline] chunked bf16-mixed rssm_chunks=4 burn-in 2 on the ring's export: "
          f"{offline['chunked_gradient_steps']} gradient steps, {offline['chunked_launches']} ln_gru launches = "
          f"predicted ({offline['chunked_launches_per_gradient_step']} per gradient step); every metric finite, final "
          f"{json.dumps(offline['chunked_final_metrics'])}; Time/sps_train {offline['chunked_sps_train']}  [{card}]",
          flush=True)
    shutil.rmtree(build_dir / "offline", ignore_errors=True)
    shutil.rmtree(build_dir / "offline_export", ignore_errors=True)

    mark('offline dv3')
    drill = run_drill(build_dir)
    print(
        f"[drill] DreamerV3-S run diagnostics=full ({' '.join(CHUNKED_OPTIONS)}, sequences of 16): the poisoned "
        f"batch at iteration {DRILL_NAN_ITER} under skip_update left all {drill['skip_update'][0]['tensors']} "
        f"tensors (params of the four modules, Adam's step, exp_avg, exp_avg_sq, the Moments) bit-identical in "
        f"{len(drill['skip_update'])} step(s); the preemption at iteration {DRILL_PREEMPT_ITER} wrote the verified "
        f"emergency checkpoint {drill['emergency_checkpoint']} (blocking write_ms {drill['blocking_write_ms']}), "
        f"journaled `preempted` and exited {drill['exit_code']} as expected; /metrics served "
        f"{drill['metrics_lines']} sheeprl_* lines and /healthz ok during the run; trace.json loaded "
        f"({drill['trace_events']} events)  [{card}]", flush=True)
    print(
        f"[drill] resume from the emergency checkpoint: started at iteration {drill['resume_start_iter']}, "
        f"{drill['resume_gradient_steps']} gradient steps, {drill['resume_player_steps']} player steps, "
        f"{drill['resume_test_steps']} test steps, {drill['ln_gru_launches']} ln_gru launches = predicted "
        f"({drill['launches_per_gradient_step']} per gradient step)  [{card}]", flush=True)

    mark('drill')
    ppo = run_ppo(build_dir, "shared_memory", tensorboard=True)
    print(f"[ppo] run exp=ppo_atari env=dummy (NatureCNN on 4x3x84x84, dense 512, 3 epochs x 4 minibatches of 256, "
          f"8 envs x 128 steps, 2 iterations) through env.executor=shared_memory under the default diagnostics and "
          f"the default logger (TensorBoard events {ppo['tensorboard_events']}): final losses "
          f"{json.dumps(ppo['final_losses'])}, value_ev {ppo['value_ev']}, Time/sps_env_interaction "
          f"{ppo['sps']['Time/sps_env_interaction']}, Time/sps_train {ppo['sps']['Time/sps_train']}, test reward "
          f"{ppo['test_reward']}, FLOPs counted {ppo['journal']['flops_per_step']}, MFU "
          f"{ppo['journal']['mfu']}  [{card}]", flush=True)
    ppo_drill = run_ppo_drill(build_dir)
    print(f"[ppo] drill (sync executor, diagnostics.sentinel.policy=skip_update, Adam capturable on the card): the "
          f"poisoned second iteration's {ppo_drill['skipped']} minibatch updates were all counted non-finite and "
          f"skipped; the agent and Adam's count, mu and nu ({ppo_drill['tensors']} tensors) ended bit-identical to "
          f"the first iteration's checkpoint  [{card}]", flush=True)
    ppo_resumed = run_ppo_resume(ppo)
    print(f"[ppo] resume from {ppo_resumed['resumed_from']}: started at iteration {ppo_resumed['start_iter']}, Adam "
          f"restored at count {ppo_resumed['adam_count']}, trained on: losses {ppo_resumed['final_losses']}  "
          f"[{card}]", flush=True)
    ppo_reward = run_ppo_eval(ppo)
    print(f"[ppo] eval checkpoint_path={ppo['checkpoints'][-1]}: Test/cumulative_reward {ppo_reward}  [{card}]",
          flush=True)
    ppo_serve = run_ppo_serve(ppo)
    print(f"[ppo] serve: {ppo_serve['requests']} /act from {ppo_serve['clients']} concurrent clients (4x3x84x84 "
          f"observations), all 200 with a valid action, the greedy probe equal to the agent's; "
          f"{ppo_serve['dispatches']} dispatches, widths {ppo_serve['width_hist']}; "
          f"{ppo_serve['requests_per_s']:.2f} requests/s, p50 {ppo_serve['latency_p50_ms']:.2f} ms, p99 "
          f"{ppo_serve['latency_p99_ms']:.2f} ms  [{card}]", flush=True)
    # the executors compared: the same two iterations each, no checkpoint,
    # no test episode; the first interval holds the warm-up, so the second
    # is the reading
    mark('ppo, drill, resume, eval, serve')
    ppo_rollout = {}
    for executor in ("sync", "async", "shared_memory"):
        run = run_ppo(build_dir, executor, compare=True)
        ppo_rollout[executor] = run["sps"]["Time/sps_env_interaction"][-1]
        print(f"[ppo] run through env.executor={executor} (two iterations, no checkpoint, no test): final losses "
              f"{json.dumps(run['final_losses'])}, Time/sps_env_interaction by interval "
              f"{run['sps']['Time/sps_env_interaction']}, Time/sps_train {run['sps']['Time/sps_train']}  [{card}]",
              flush=True)
    print(f"[ppo] rollout env steps/s (the second interval's Time/sps_env_interaction, 8 envs x 128 steps, episodes "
          f"of {PPO_EPISODE_STEPS} steps, policy on the card) by executor: {json.dumps(ppo_rollout)}  [{card}]",
          flush=True)
    mark('ppo executors')
    ppo_timers = run_ppo_timers()
    for name, t in ppo_timers.items():
        print(f"[ppo-timer] minibatch update (batch 256, {t['params']} params, {t['flops']:.6g} FLOPs counted), "
              f"{name}: median stream time {t['step_ms']:.3f} ms (CUDA events) over {PPO_TIMED_UPDATES} updates; "
              f"device busy {t['busy_ms']:.3f} ms (torch.profiler), {t['launches']} launches, idle share "
              f"{t['idle_share']:.4f}; top kernels (ms, name) {t['top']}  [{card}]", flush=True)

    mark('ppo timers')
    jepa = run_jepa(build_dir)
    xl_cases = {(c["B"], c["dtype"]): c for c in cases if c["H"] == XL_SHAPE[0]}
    print(
        f"[jepa] DreamerV3-JEPA run exp=dreamer_v3_jepa at its XL widths (recurrent 4096, dense 1024, CNN "
        f"multiplier 96, 5 layers, projector/predictor 1024; batch 16 x 64, horizon 15, fp32, no decoder): "
        f"{jepa['gradient_steps']} gradient steps, {jepa['player_steps']} player steps, {jepa['test_steps']} "
        f"test-episode steps, {jepa['policy_steps']} policy steps; {jepa['ln_gru_launches']} ln_gru launches = "
        f"predicted ({jepa['launches_per_gradient_step']} per gradient step: 64 x 16 rows + 15 x 1024 at K=5120 "
        f"H=4096); every metric finite, Loss/jepa_loss logged {jepa['jepa_loss_logged']}, final "
        f"{json.dumps(jepa['final_metrics'])}; leaves changed {jepa['changed_leaves']}; checkpoint verified by its "
        f"manifest; Time/sps_train {jepa['sps']['Time/sps_train']}, Time/sps_env_interaction "
        f"{jepa['sps']['Time/sps_env_interaction']}; journal Telemetry/mfu {jepa['journal']['mfu']}, FLOPs counted "
        f"{jepa['journal']['flops_per_step']}  [{card}]", flush=True)
    print(
        f"[jepa] kernel vs plain XL gradient step from the checkpoint's state, one batch and noise: metrics max "
        f"relative error {jepa['step_metric_rel_err']:.3g} (tol {STEP_METRIC_RTOL:g}), gradients "
        f"{jepa['step_grad_rel_err']:.3g} (tol {STEP_GRAD_RTOL:g}), params off by more than {STEP_PARAM_ATOL:g}: "
        f"{jepa['step_param_outliers']:.3g} (tol {STEP_PARAM_OUTLIERS:g}), max_abs_err "
        f"{jepa['step_param_max_abs_err']:.3g} (not held); all {jepa['ema_tensors']} target tensors moved by "
        f"exactly the EMA of the new online weights  [{card}]", flush=True)
    jepa_resumed = run_jepa_resume(jepa)
    print(f"[jepa] resume from {jepa['mid_checkpoint']}: the jepa tree and the world-model optimizer's optax state "
          f"over (world model, heads) restored as saved; started at iteration {jepa_resumed['start_iter']}, "
          f"{jepa_resumed['gradient_steps']} gradient steps, {jepa_resumed['player_steps']} player steps, "
          f"{jepa_resumed['test_steps']} test steps, {jepa_resumed['ln_gru_launches']} ln_gru launches = predicted  "
          f"[{card}]", flush=True)
    jepa_evaluated = run_jepa_eval(jepa)
    print(f"[jepa] eval checkpoint_path={jepa['checkpoint']}: Test/cumulative_reward {jepa_evaluated['test_reward']}, "
          f"{jepa_evaluated['ln_gru_launches']} ln_gru launches; serve refused it: "
          f"{jepa_evaluated['serve_refusal'][:90]}  [{card}]", flush=True)
    jepa_timer = run_jepa_timer()
    fwd = 64 * xl_cases[(16, "float32")]["ms"] + 15 * xl_cases[(1024, "float32")]["ms"]
    print(f"[jepa-timer] DreamerV3-JEPA XL gradient step (fp32, default diagnostics): median stream time "
          f"{jepa_timer['step_ms']:.3f} ms (CUDA events; {[round(x, 3) for x in jepa_timer['stream_ms']]}), device "
          f"busy {jepa_timer['busy_ms']:.3f} ms (torch.profiler), idle share {jepa_timer['idle_share']:.4f}, "
          f"{jepa_timer['launches']} launches a step, ln_gru {jepa_timer['ln_gru_launches']} launches "
          f"{jepa_timer['ln_gru_ms']:.4f} ms a step (the XL kernel cases predict a forward of {fwd:.4f} ms); "
          f"{jepa_timer['flops_per_step']:.6g} FLOPs a step counted, step MFU {jepa_timer['step_mfu']}; peak memory "
          f"{jepa_timer['max_memory_gb']:.2f} GiB; top kernels (ms, name) {jepa_timer['top']}  [{card}]", flush=True)

    # the JEPA run's XL checkpoints are done with; P2E's take their room
    shutil.rmtree(build_dir / "jepa", ignore_errors=True)
    mark('jepa')
    p2e_t0 = time.monotonic()
    p2e = run_p2e(build_dir)
    print(
        f"[p2e] Plan2Explore-DV3 run exp=p2e_dv3_exploration at its XL widths (recurrent 4096, dense 1024, CNN "
        f"multiplier 96, 5 layers, [rgb] decoder, ensembles 8 x 1024 x 5, critics intrinsic 0.1 + extrinsic 1.0; "
        f"batch 16 x 64, horizon 15, fp32): {p2e['gradient_steps']} gradient steps, {p2e['player_steps']} player "
        f"steps (the exploration actor), {p2e['test_steps']} zero-shot test steps (the task actor), "
        f"{p2e['policy_steps']} policy steps; {p2e['ln_gru_launches']} ln_gru launches = predicted "
        f"({p2e['launches_per_gradient_step']} per gradient step: 64 x 16 rows + 2 imaginations x 15 x 1024 at "
        f"K=5120 H=4096); every metric finite, the per-critic ones logged {json.dumps(p2e['per_critic'])}, final "
        f"{json.dumps(p2e['final_metrics'])}; leaves changed {p2e['changed_leaves']}; both checkpoints verified by "
        f"their manifests; Time/sps_train {p2e['sps']['Time/sps_train']}, Time/sps_env_interaction "
        f"{p2e['sps']['Time/sps_env_interaction']}; journal Telemetry/mfu {p2e['journal']['mfu']}, FLOPs counted "
        f"{p2e['journal']['flops_per_step']}; peak memory of the run {p2e['peak_memory_gb']:.2f} GiB over the "
        f"{p2e['held_gb']:.2f} GiB earlier phases held  [{card}]",
        flush=True)
    print(
        f"[p2e] kernel vs plain XL exploration step from the last checkpoint's state, one batch and noise: metrics "
        f"max relative error {p2e['step_metric_rel_err']:.3g} (tol {STEP_METRIC_RTOL:g}), gradients "
        f"{p2e['step_grad_rel_err']:.3g} (tol {STEP_GRAD_RTOL:g}), params off by more than {STEP_PARAM_ATOL:g}: "
        f"{p2e['step_param_outliers']:.3g} (tol {STEP_PARAM_OUTLIERS:g}), max_abs_err "
        f"{p2e['step_param_max_abs_err']:.3g} (not held)  [{card}]", flush=True)
    p2e_resumed = run_p2e_resume(p2e)
    print(f"[p2e] resume from {p2e['mid_checkpoint']}: the seven trees, the optimizers' optax states "
          f"({', '.join(p2e_resumed['optimizers'])}) and the Moments tree ({p2e_resumed['moments']} tensors) "
          f"restored as saved; started at iteration {p2e_resumed['start_iter']}, {p2e_resumed['gradient_steps']} "
          f"gradient steps, {p2e_resumed['player_steps']} player steps, {p2e_resumed['test_steps']} test steps, "
          f"{p2e_resumed['ln_gru_launches']} ln_gru launches = predicted  [{card}]", flush=True)
    p2e_finetuned = run_p2e_finetune(build_dir, p2e)
    print(f"[p2e] finetuning run exp=p2e_dv3_finetuning from {p2e['checkpoint']} with its replay "
          f"(buffer.load_from_exploration=True): {p2e_finetuned['gradient_steps']} gradient steps, "
          f"{p2e_finetuned['player_steps']} player steps, {p2e_finetuned['test_steps']} test steps; "
          f"{p2e_finetuned['ln_gru_launches']} ln_gru launches = predicted "
          f"({p2e_finetuned['launches_per_gradient_step']} per gradient step); the player acted with (iteration, "
          f"actor) {p2e_finetuned['player_actors']}, the first gradient step at iteration "
          f"{p2e_finetuned['first_train_iter']}; every metric finite, final "
          f"{json.dumps(p2e_finetuned['final_metrics'])}; checkpoint verified  [{card}]", flush=True)
    p2e_evaluated = run_p2e_eval([p2e["checkpoint"], p2e_finetuned["checkpoint"]])
    print(f"[p2e] eval of the exploration and finetuning checkpoints (the task actor): Test/cumulative_reward "
          f"{p2e_evaluated['test_rewards']}, {p2e_evaluated['ln_gru_launches']} ln_gru launches; serve refused both: "
          f"{[r[:60] for r in p2e_evaluated['serve_refusals']]}  [{card}]", flush=True)
    p2e_timer = run_p2e_timer()
    fwd = 64 * xl_cases[(16, "float32")]["ms"] + 30 * xl_cases[(1024, "float32")]["ms"]
    print(f"[p2e-timer] Plan2Explore-DV3 XL exploration step (fp32, default diagnostics): median stream time "
          f"{p2e_timer['step_ms']:.3f} ms (CUDA events; {[round(x, 3) for x in p2e_timer['stream_ms']]}), device "
          f"busy {p2e_timer['busy_ms']:.3f} ms (torch.profiler), idle share {p2e_timer['idle_share']:.4f}, "
          f"{p2e_timer['launches']} launches a step, ln_gru {p2e_timer['ln_gru_launches']} launches "
          f"{p2e_timer['ln_gru_ms']:.4f} ms a step (the XL kernel cases predict a forward of {fwd:.4f} ms); "
          f"{p2e_timer['flops_per_step']:.6g} FLOPs a step counted, step MFU {p2e_timer['step_mfu']}; peak memory "
          f"{p2e_timer['max_memory_gb']:.2f} GiB over the {p2e_timer['held_gb']:.2f} GiB earlier phases held; top "
          f"kernels (ms, name) {p2e_timer['top']}; the P2E phases took {time.monotonic() - p2e_t0:.1f} s  [{card}]",
          flush=True)
    shutil.rmtree(build_dir / "p2e", ignore_errors=True)
    shutil.rmtree(build_dir / "p2e_finetuning", ignore_errors=True)

    mark('p2e')
    a2c = run_a2c(build_dir)
    print(f"[a2c] run exp=a2c env=dummy (MLP 64 x 2 on state, RMSprop, 4 envs x 5 steps, 10 iterations): final "
          f"losses {json.dumps(a2c['final_losses'])}, value_ev {a2c['value_ev'][-1]}, Time/sps_env_interaction "
          f"{a2c['sps']['Time/sps_env_interaction']}, Time/sps_train {a2c['sps']['Time/sps_train']}; resumed from its "
          f"mid-run checkpoint at iteration {a2c['resume_start_iter']} with RMSprop's state restored and trained on; "
          f"eval Test/cumulative_reward {a2c['test_reward']}; serve: {a2c['requests']} /act from "
          f"{A2C_SERVE_CLIENTS} concurrent clients, all 200, the greedy probe equal to the agent's, "
          f"{a2c['requests_per_s']:.2f} requests/s, p50 {a2c['latency_p50_ms']:.2f} ms, p99 "
          f"{a2c['latency_p99_ms']:.2f} ms. A2C runs no hand-written kernel  [{card}]", flush=True)

    mark('a2c')
    sac_t0 = time.monotonic()
    with bounded_dummy_actions():
        sac = run_sac(build_dir)
        print(f"[sac] run exp=sac env=dummy (actions bounded to [-1, 1]; hidden 256, 2 critics, batch 256, replay "
              f"ratio 1, 4 envs, {sac['iterations']} iterations): {sac['gradient_steps']} gradient steps in "
              f"{sac['seconds']:.1f} s, final [qf, actor, alpha, grad norm] {sac['final']}; resumed from its mid-run "
              f"checkpoint at iteration {sac['resume_start_iter']} ({sac['resume_gradient_steps']} gradient steps); "
              f"eval Test/cumulative_reward {sac['test_reward']}; serve: {sac['requests']} /act from "
              f"{SAC_SERVE_CLIENTS} clients, all 200, finite and in [-1, 1], the greedy probe "
              f"{sac['greedy_probe']} equal to the actor's; ln_gru launches {sac['launches']}  [{card}]", flush=True)
        droq = run_droq(build_dir)
        print(f"[droq] run exp=droq env=dummy (hidden 256, dropout 0.01, replay ratio 20, 2 envs, "
              f"{droq['iterations']} iterations): {droq['gradient_steps']} gradient steps in {droq['seconds']:.1f} s, "
              f"final [qf, actor, alpha] {droq['final']}; resumed at iteration {droq['resume_start_iter']} "
              f"({droq['resume_gradient_steps']} gradient steps); eval {droq['test_reward']}; serve refused: "
              f"{droq['serve_refusal'][:70]}; ln_gru launches {droq['launches']}  [{card}]", flush=True)
        sac_ae = run_sac_ae(build_dir)
        print(f"[sac_ae] run exp=sac_ae env=dummy (64x64 rgb, 3-frame stack + state, features 64, hidden 1024, batch "
              f"128, 2 envs, {sac_ae['iterations']} iterations): {sac_ae['gradient_steps']} gradient steps in "
              f"{sac_ae['seconds']:.1f} s, final [qf, actor, alpha, reconstruction] {sac_ae['final']}; resumed at "
              f"iteration {sac_ae['resume_start_iter']} with the counter at {sac_ae['counter_at_checkpoint']} "
              f"({sac_ae['resume_gradient_steps']} gradient steps); eval {sac_ae['test_reward']}; serve refused: "
              f"{sac_ae['serve_refusal'][:70]}; ln_gru launches {sac_ae['launches']}  [{card}]", flush=True)
    versus = run_sac_card_vs_cpu(sac, sac_ae)
    for name, row in versus.items():
        print(f"[card-vs-cpu] {name}: two gradient steps from the mid-run checkpoint on the card and on the CPU, one "
              f"batch and noise, fp32 (TF32 off): every parameter and optimizer state on the card; metrics max "
              f"relative error {row['metric_rel_err']:.3g} (tol {CARD_CPU_METRIC_RTOL[name]:g}), parameters max_abs_err "
              f"{row['param_max_abs_err']:.3g} (tol {CARD_CPU_PARAM_ATOL[name]:g})  [{card}]", flush=True)
    offline_sac = run_offline_sac(build_dir, sac, droq)
    for name, row in offline_sac.items():
        print(f"[offline-{name}] run exp={name} algo.offline.enabled=true algo.offline.cql_alpha=1.0 (actions in "
              f"[-1, 1], {row['cql_samples']} uniform + {row['cql_samples']} policy proposals) on its phase's export "
              f"({row['dataset']['rows']} rows in {row['dataset']['shards']} shards): {row['gradient_steps']} gradient "
              f"steps in {row['seconds']:.1f} s, final {row['final']}, Time/sps_train {row['sps_train']}, FLOPs counted "
              f"{row['flops_per_call']} a call of {row['grad_steps_per_call']} steps, ln_gru "
              f"launches {row['launches']}; two offline CQL steps on the card against the CPU: metrics max relative "
              f"error {row['card_vs_cpu']['metric_rel_err']:.3g} (tol {CARD_CPU_METRIC_RTOL[name + '_offline']:g}), "
              f"parameters max_abs_err {row['card_vs_cpu']['param_max_abs_err']:.3g} (tol "
              f"{CARD_CPU_PARAM_ATOL[name + '_offline']:g})  [{card}]", flush=True)
    for path in ("sac", "droq", "sac_ae", "offline"):
        shutil.rmtree(build_dir / path, ignore_errors=True)
    profiles = run_sac_profiles()
    for name, t in profiles.items():
        print(f"[sac-profile] {name} gradient step (batch {t['batch']}, {t['params']} params, {t['flops']:.6g} FLOPs): "
              f"median stream time {t['step_ms']:.3f} ms, device busy {t['busy_ms']:.3f} ms, idle share "
              f"{t['idle_share']:.4f}, {t['launches']} launches, step MFU {t['step_mfu']}; top kernels (ms, name) "
              f"{t['top']}  [{card}]", flush=True)
    print(f"[sac-profile] DroQ's 20 gradient steps a policy step: {20 * profiles['droq']['step_ms']:.3f} ms of stream "
          f"time and {20 * profiles['droq']['launches']} launches a policy step  [{card}]", flush=True)
    bf16 = run_bf16_on_policy(build_dir)
    print(f"[bf16] fabric.precision=bf16-mixed: PPO at exp=ppo_atari widths {bf16['ppo_bf16']['iterations']} "
          f"iteration(s), final [policy, value, entropy, grad norm] {bf16['ppo_bf16']['final']}; A2C "
          f"{bf16['a2c_bf16']['iterations']} iterations, final [policy, value, grad norm] {bf16['a2c_bf16']['final']}; "
          f"the SAC-family and bf16 phases took {time.monotonic() - sac_t0:.1f} s  [{card}]", flush=True)

    mark('sac family, bf16')
    dv_t0 = time.monotonic()
    dv2 = run_dv2(build_dir)
    dv2_cases = {(c["B"], c["dtype"]): c for c in cases if c["H"] == DV2_SHAPE[0]}
    print(
        f"[dv2] DreamerV2 run exp=dreamer_v2 at its widths (64x64 rgb, CNN multiplier 48, dense 400 x 4, recurrent "
        f"600, stochastic 32 x 32, hidden 600; batch 16 x 50, horizon 15, fp32) under the default diagnostics: "
        f"{dv2['gradient_steps']} gradient steps, {dv2['player_steps']} player steps, {dv2['test_steps']} "
        f"test-episode steps, {dv2['policy_steps']} policy steps; {dv2['ln_gru_launches']} ln_gru launches = "
        f"predicted ({dv2['launches_per_gradient_step']} per gradient step: 50 x 16 rows + 15 x 800 at K=1000 "
        f"H=600); every metric finite, final {json.dumps(dv2['final_metrics'])}; leaves changed "
        f"{dv2['changed_leaves']}; both checkpoints verified; Time/sps_train {dv2['sps']['Time/sps_train']}, "
        f"Time/sps_env_interaction {dv2['sps']['Time/sps_env_interaction']}; journal Telemetry/mfu "
        f"{dv2['journal']['mfu']}, FLOPs counted {dv2['journal']['flops_per_step']}  [{card}]", flush=True)
    print(
        f"[dv2] kernel vs plain gradient step from the last checkpoint's state, one batch and noise: metrics max "
        f"relative error {dv2['step_metric_rel_err']:.3g} (tol {STEP_METRIC_RTOL:g}), gradients "
        f"{dv2['step_grad_rel_err']:.3g} (tol {STEP_GRAD_RTOL:g}), params off by more than {STEP_PARAM_ATOL:g}: "
        f"{dv2['step_param_outliers']:.3g} (tol {STEP_PARAM_OUTLIERS:g}), max_abs_err "
        f"{dv2['step_param_max_abs_err']:.3g} (not held)  [{card}]", flush=True)
    for name, r in dv2["runs"].items():
        print(f"[dv2] {name} run ({'buffer.type=episode, prioritize_ends, the multi-discrete dummy' if name == 'episode' else 'fabric.precision=bf16-mixed'}): "
              f"{r['gradient_steps']} gradient steps, {r['player_steps']} player steps, {r['ln_gru_launches']} ln_gru "
              f"launches = predicted ({r['launches_per_gradient_step']} per gradient step); final metrics "
              f"{[round(x, 4) for x in r['final_metrics']]}  [{card}]", flush=True)
    dv2_resumed = run_dreamer_resume(dv2, "dv2")
    print(f"[dv2] resume from {dv2['mid_checkpoint']}: the four trees and three adamw states restored as saved, the "
          f"target counter restarted at 0 (the JAX loop's); started at iteration "
          f"{dv2_resumed['start_iter']}, {dv2_resumed['gradient_steps']} gradient steps, "
          f"{dv2_resumed['ln_gru_launches']} ln_gru launches = predicted  [{card}]", flush=True)
    dv2_evaluated = run_dreamer_eval(dv2, "dreamer_v2")
    print(f"[dv2] eval checkpoint_path={dv2['checkpoint']}: Test/cumulative_reward {dv2_evaluated['test_reward']}, "
          f"{dv2_evaluated['ln_gru_launches']} ln_gru launches; serve refused it: "
          f"{dv2_evaluated['serve_refusal'][:70]}  [{card}]", flush=True)
    shutil.rmtree(build_dir / "dv2", ignore_errors=True)
    dv1 = run_dv1(build_dir)
    print(f"[dv1] DreamerV1 run exp=dreamer_v1 at its widths (64x64 rgb, CNN multiplier 32, dense 400, recurrent 200, "
          f"stochastic 30, hidden 200; batch 50 x 50, horizon 15, fp32): {dv1['gradient_steps']} gradient steps, "
          f"{dv1['player_steps']} player steps, {dv1['test_steps']} test steps; {dv1['ln_gru_launches']} ln_gru "
          f"launches (its GRU has no LayerNorm); every metric finite, final {json.dumps(dv1['final_metrics'])}; "
          f"leaves changed {dv1['changed_leaves']}; Time/sps_train {dv1['sps']['Time/sps_train']}  [{card}]",
          flush=True)
    dv1_resumed = run_dreamer_resume(dv1, "dv1", kernel=False)
    dv1_evaluated = run_dreamer_eval(dv1, "dreamer_v1")
    print(f"[dv1] resumed at iteration {dv1_resumed['start_iter']} with the trees and adam states as saved: "
          f"{dv1_resumed['gradient_steps']} gradient steps, {dv1_resumed['ln_gru_launches']} ln_gru launches; eval "
          f"Test/cumulative_reward {dv1_evaluated['test_reward']}; serve refused it  [{card}]", flush=True)
    shutil.rmtree(build_dir / "dv1", ignore_errors=True)
    ppo_rec = run_ppo_recurrent(build_dir)
    print(f"[ppo_recurrent] run exp=ppo_recurrent env=dummy (state; 16 envs x 512 steps, sequences of 16, 8 "
          f"minibatches, 8 epochs, LSTM 64): final losses {ppo_rec['final_losses']}, Time/sps_env_interaction "
          f"{ppo_rec['sps']['Time/sps_env_interaction']}, Time/sps_train {ppo_rec['sps']['Time/sps_train']}, test "
          f"reward {ppo_rec['test_reward']}; resumed at iteration {ppo_rec['resume_start_iter']}; eval "
          f"{ppo_rec['eval_reward']}; serve: {ppo_rec['served']} /act over HTTP from {PPO_REC_SESSIONS} interleaved "
          f"sessions with a reset each, every greedy action equal to the player's from the same state, "
          f"{ppo_rec['dispatches']} dispatches; bf16-mixed iteration final {ppo_rec['bf16_final']}; ln_gru launches "
          f"{ppo_rec['ln_gru_launches']}  [{card}]", flush=True)
    shutil.rmtree(build_dir / "ppo_rec", ignore_errors=True)
    dreamer_timers = run_dreamer_timers()
    for name, t in dreamer_timers.items():
        widths = (16, 800) if name.startswith("dv2") else None
        fwd = ""
        if widths:
            dtype_name = "bfloat16" if "bf16" in name else "float32"
            ms = 50 * dv2_cases[(16, dtype_name)]["ms"] + 15 * dv2_cases[(800, dtype_name)]["ms"]
            fwd = f" (the DreamerV2 kernel cases predict a forward of {ms:.4f} ms)"
        print(f"[dreamer-timer] {name} gradient step (default diagnostics): median stream time {t['step_ms']:.3f} ms "
              f"(CUDA events; {[round(x, 3) for x in t['stream_ms']]}), device busy {t['busy_ms']:.3f} ms, idle share "
              f"{t['idle_share']:.4f}, {t['launches']} launches a step, ln_gru {t['ln_gru_launches']} launches "
              f"{t['ln_gru_ms']:.4f} ms a step{fwd}; {t['flops_per_step']:.6g} FLOPs a step counted, step MFU "
              f"{t['step_mfu']}; peak memory {t['max_memory_gb']:.2f} GiB; top kernels (ms, name) {t['top']}  "
              f"[{card}]", flush=True)
    rec_timer = run_ppo_recurrent_timer()
    print(f"[ppo_recurrent-timer] minibatch update ({rec_timer['seq_batch']} sequences of 16, {rec_timer['params']} "
          f"params, {rec_timer['flops']:.6g} FLOPs counted): median stream time {rec_timer['step_ms']:.3f} ms, device "
          f"busy {rec_timer['busy_ms']:.3f} ms, {rec_timer['launches']} launches, idle share "
          f"{rec_timer['idle_share']:.4f}; top kernels {rec_timer['top']}; the DreamerV1/V2 and recurrent PPO "
          f"phases took {time.monotonic() - dv_t0:.1f} s  [{card}]", flush=True)

    mark('dv2, dv1, ppo_recurrent')
    p2e_dv_t0 = time.monotonic()
    p2e_dv = {}
    p2e_cases = {(c["B"], c["dtype"]): c for c in cases if c["H"] == P2E_DV2_SHAPE[0]}
    for version in (2, 1):
        where, kernel = f"p2e_dv{version}", version == 2
        run = run_p2e_dreamer(build_dir, version)
        widths = ("64x64 rgb, CNN multiplier 48, dense 400 x 4, recurrent 400, stochastic 32 x 32, hidden 400, "
                  "ensembles 10 x 400 x 4; batch 16 x 50" if kernel else
                  "64x64 rgb, CNN multiplier 32, dense 400 x 4, recurrent 400, stochastic 60, hidden 400, ensembles "
                  "10 x 400 x 4 onto the embedding; batch 50 x 50")
        kernel_text = (f"{run['ln_gru_launches']} ln_gru launches = predicted ({run['launches_per_gradient_step']} "
                       f"per gradient step: 50 x 16 rows + 2 imaginations x 15 x 800 at K=800 H=400)" if kernel else
                       f"{run['ln_gru_launches']} ln_gru launches (its GRU has no LayerNorm)")
        print(f"[{where}] Plan2Explore-DV{version} run exp={where}_exploration at its widths ({widths}, horizon 15, "
              f"fp32) under the default diagnostics: {run['gradient_steps']} gradient steps, {run['player_steps']} "
              f"player steps (the exploration actor), {run['test_steps']} zero-shot test steps (the task actor), "
              f"{run['policy_steps']} policy steps; {kernel_text}; every metric finite, Rewards/intrinsic by step "
              f"{run['intrinsic']}, final {json.dumps(run['final_metrics'])}; leaves changed "
              f"{run['changed_leaves']}; both checkpoints verified; Time/sps_train {run['sps']['Time/sps_train']}, "
              f"Time/sps_env_interaction {run['sps']['Time/sps_env_interaction']}; journal Telemetry/mfu "
              f"{run['journal']['mfu']}, FLOPs counted {run['journal']['flops_per_step']}  [{card}]", flush=True)
        if kernel:
            print(f"[{where}] kernel vs plain exploration step from the last checkpoint's state, one batch and noise: "
                  f"metrics max relative error {run['step_metric_rel_err']:.3g} (tol {STEP_METRIC_RTOL:g}), gradients "
                  f"{run['step_grad_rel_err']:.3g} (tol {STEP_GRAD_RTOL:g}), params off by more than "
                  f"{STEP_PARAM_ATOL:g}: {run['step_param_outliers']:.3g} (tol {STEP_PARAM_OUTLIERS:g}), max_abs_err "
                  f"{run['step_param_max_abs_err']:.3g} (not held)  [{card}]", flush=True)
        resumed_run = run_dreamer_resume(run, where, kernel=kernel, imaginations=2)
        finetuned = run_p2e_finetune(build_dir, run, overrides=P2E_DREAMER_FINETUNE_OVERRIDES[version],
                                     widths=_p2e_dreamer_widths(version), kernel=kernel, where=f"{where}_finetuning")
        if finetuned["launches_per_gradient_step"] != P2E_DREAMER_LAUNCHES[version][1]:
            raise AssertionError(f"{where} finetuning: {finetuned['launches_per_gradient_step']} ln_gru launches a "
                                 f"gradient step, not {P2E_DREAMER_LAUNCHES[version][1]}")
        evaluated_runs = run_p2e_eval([run["checkpoint"], finetuned["checkpoint"]], kernel=kernel)
        print(f"[{where}] resume from {run['mid_checkpoint']}: the trees and optimizer states "
              f"({', '.join(resumed_run['optimizers'])}) restored as saved; started at iteration "
              f"{resumed_run['start_iter']}, {resumed_run['gradient_steps']} gradient steps, "
              f"{resumed_run['ln_gru_launches']} ln_gru launches = predicted; finetuning run exp={where}_finetuning "
              f"from {run['checkpoint']} with its replay: {finetuned['gradient_steps']} gradient steps, "
              f"{finetuned['player_steps']} player steps, {finetuned['ln_gru_launches']} ln_gru launches = predicted "
              f"({finetuned['launches_per_gradient_step']} per gradient step), the player acted with (iteration, "
              f"actor) {finetuned['player_actors']}, the first gradient step at iteration "
              f"{finetuned['first_train_iter']}, final {json.dumps(finetuned['final_metrics'])}; eval of both "
              f"checkpoints Test/cumulative_reward {evaluated_runs['test_rewards']}, "
              f"{evaluated_runs['ln_gru_launches']} ln_gru launches; serve refused both  [{card}]", flush=True)
        p2e_dv[version] = {"run": run, "resume": resumed_run, "finetune": finetuned, "eval": evaluated_runs}
        shutil.rmtree(build_dir / where, ignore_errors=True)
        shutil.rmtree(build_dir / f"{where}_finetuning", ignore_errors=True)
    p2e_dv_timers = run_p2e_dreamer_timers()
    for name, t in p2e_dv_timers.items():
        fwd = ""
        if name == "p2e_dv2":
            ms = 50 * p2e_cases[(16, "float32")]["ms"] + 30 * p2e_cases[(800, "float32")]["ms"]
            fwd = f" (the P2E-DV2 kernel cases predict a forward of {ms:.4f} ms)"
        print(f"[{name}-timer] Plan2Explore-DV{name[-1]} exploration step (fp32, default diagnostics): median stream "
              f"time {t['step_ms']:.3f} ms (CUDA events; {[round(x, 3) for x in t['stream_ms']]}), device busy "
              f"{t['busy_ms']:.3f} ms (torch.profiler), idle share {t['idle_share']:.4f}, {t['launches']} launches a "
              f"step, ln_gru {t['ln_gru_launches']} launches {t['ln_gru_ms']:.4f} ms a step{fwd}; "
              f"{t['flops_per_step']:.6g} FLOPs a step counted, step MFU {t['step_mfu']}; peak memory "
              f"{t['max_memory_gb']:.2f} GiB; top kernels (ms, name) {t['top']}  [{card}]", flush=True)
    print(f"[p2e-dv] the P2E-DV2 and P2E-DV1 phases took {time.monotonic() - p2e_dv_t0:.1f} s  [{card}]", flush=True)

    mark('p2e dv2, dv1')
    timers = run_timers(offline_batch=offline.pop("batch"))
    for name, t in timers.items():
        fp32 = name.startswith("fp32")
        widths = (16, 1024) if fp32 else (64, 1024)
        dtype_name = "float32" if fp32 else "bfloat16"
        steps = (64, 15) if fp32 else (16, 15)
        fwd = steps[0] * s_cases[(widths[0], dtype_name)]["ms"] + steps[1] * s_cases[(widths[1], dtype_name)]["ms"]
        if not fp32:
            fwd += 2 * s_cases[(48, dtype_name)]["ms"]
        extra = ""
        if "flops_per_step" in t:
            extra = (f"; {t['flops_per_step']:.6g} FLOPs a step counted, step MFU "
                     f"{t['step_mfu'] if t['step_mfu'] is None else format(t['step_mfu'], '.6g')}")
        print(
            f"[timer] DreamerV3-S gradient step, {name}"
            f"{OFFLINE_TIMER_NOTE if name == 'fp32_diagnostics_1' else ''}: "
            f"median stream time {t['step_ms']:.3f} ms (CUDA events; "
            f"host-bound, so about its wall time), {t['steps_per_s']:.3f} steps/s over {TIMED_STEPS} steps; "
            f"device busy {t['busy_ms']:.3f} ms a step (torch.profiler), idle share {t['idle_share']:.4f}, "
            f"{t['launches']} kernel launches a step, ln_gru {t['ln_gru_launches']} launches {t['ln_gru_ms']:.4f} ms "
            f"a step (the kernel cases predict a forward of {fwd:.4f} ms){extra}  [{card}]", flush=True)
    for name in ("fp32", "bf16_chunked"):
        on = [timers[f"{name}_diagnostics_{turn}"] for turn in (1,)]
        off = [timers[f"{name}_off_{turn}"] for turn in (0,)]
        print(f"[timer] {name}: diagnostics on vs off (turns off, on): "
              f"{[t['launches'] for t in on]} vs {[t['launches'] for t in off]} launches a step, "
              f"{[round(t['step_ms'], 3) for t in on]} vs {[round(t['step_ms'], 3) for t in off]} ms stream time, "
              f"busy {[round(t['busy_ms'], 3) for t in on]} vs {[round(t['busy_ms'], 3) for t in off]} ms  [{card}]",
              flush=True)

    mark('dv3 timers')
    cpu_flops = count_cpu_flops()
    card_flops = train["journal"]["flops_per_step"][0]
    if card_flops != cpu_flops or timers["fp32_diagnostics_1"]["flops_per_step"] != cpu_flops:
        raise AssertionError(f"FLOPs of the fp32 step: card {card_flops} (timer "
                             f"{timers['fp32_diagnostics_1']['flops_per_step']}), CPU {cpu_flops}")
    print(f"[flops] DreamerV3-S fp32 gradient step: {card_flops:.6g} FLOPs counted on the card (the run's "
          f"telemetry_cost) = {cpu_flops:.6g} on the CPU at the same config; bf16 chunked step "
          f"{chunked['journal']['flops_per_step'][0]:.6g}  [{card}]", flush=True)
    for name, journal in (("fp32", train["journal"]), ("bf16-mixed chunked", chunked["journal"])):
        print(f"[mfu] {name} run, journal: Telemetry/mfu by interval {journal['mfu']}, Telemetry/tflops_per_sec "
              f"{journal['tflops_per_sec']} (intervals that trained; the last is the steady state); new input "
              f"signatures of the step after the first (`recompile`): {journal['recompiles']}  [{card}]", flush=True)
    syncs = train["journal"]
    print(f"[syncs] fp32 run under diagnostics.transfers=log: {syncs['host_transfers']} synchronizing calls in "
          f"{syncs['train_dispatches']} gradient steps; per step (call, count, sites) {syncs['syncs_per_step']}  "
          f"[{card}]", flush=True)
    print(f"[ckpt] ckpt_end write_ms: async (chunked run) {[e['write_ms'] for e in chunked['journal']['ckpt_end']]}, "
          f"blocking (drill's emergency save) {drill['blocking_write_ms']}; fp32 run (async) "
          f"{[e['write_ms'] for e in train['journal']['ckpt_end']]}; the loop's `checkpoint` span, its critical "
          f"path: chunked {chunked['journal']['checkpoint_span_s']} s, drill {drill['checkpoint_span_s']} s, fp32 "
          f"{train['journal']['checkpoint_span_s']} s  [{card}]", flush=True)
    print(f"[launches] ln_gru launches: serve {slice_report['ln_gru_launches']}, train {train['ln_gru_launches']}, "
          f"chunked {chunked['ln_gru_launches']}, resume {resumed['ln_gru_launches']}, eval "
          f"{evaluated['ln_gru_launches']}, drill resume {drill['ln_gru_launches']}, jepa {jepa['ln_gru_launches']}, "
          f"jepa resume {jepa_resumed['ln_gru_launches']}, jepa eval {jepa_evaluated['ln_gru_launches']}, p2e "
          f"{p2e['ln_gru_launches']}, p2e resume {p2e_resumed['ln_gru_launches']}, p2e finetuning "
          f"{p2e_finetuned['ln_gru_launches']}, p2e eval {p2e_evaluated['ln_gru_launches']}, dv2 "
          f"{dv2['ln_gru_launches']}, dv2 episode {dv2['runs']['episode']['ln_gru_launches']}, dv2 bf16 "
          f"{dv2['runs']['bf16']['ln_gru_launches']}, dv2 resume {dv2_resumed['ln_gru_launches']}, dv2 eval "
          f"{dv2_evaluated['ln_gru_launches']}, dv1 {dv1['ln_gru_launches']}, dv1 resume "
          f"{dv1_resumed['ln_gru_launches']}, dv1 eval {dv1_evaluated['ln_gru_launches']}, ppo_recurrent "
          f"{ppo_rec['ln_gru_launches']}, " + ", ".join(
              f"p2e_dv{v} {r['run']['ln_gru_launches']}, p2e_dv{v} resume {r['resume']['ln_gru_launches']}, p2e_dv{v} "
              f"finetuning {r['finetune']['ln_gru_launches']}, p2e_dv{v} eval {r['eval']['ln_gru_launches']}"
              for v, r in p2e_dv.items()) + f"  [{card}]",
          flush=True)

    mark('flops')
    # the kernels line: the kernel at the shape the main paths gave it most
    # (the serving dispatch width or the dynamic scan's B=16), and every case
    # it was held at
    main_b = 16 if train["gradient_steps"] * 64 >= max(slice_report["width_hist"].values()) \
        else slice_report["main_width"]
    main = s_cases.get((main_b, "float32")) or measure_ln_gru(main_b, *S_SHAPE, "float32")
    by_path = {"serve": slice_report["ln_gru_launches"], "train": train["ln_gru_launches"],
               "train_bf16_chunked": chunked["ln_gru_launches"], "resume": resumed["ln_gru_launches"],
               "eval": evaluated["ln_gru_launches"], "drill_resume": drill["ln_gru_launches"],
               "jepa": jepa["ln_gru_launches"], "jepa_resume": jepa_resumed["ln_gru_launches"],
               "jepa_eval": jepa_evaluated["ln_gru_launches"], "p2e": p2e["ln_gru_launches"],
               "p2e_resume": p2e_resumed["ln_gru_launches"], "p2e_finetuning": p2e_finetuned["ln_gru_launches"],
               "p2e_eval": p2e_evaluated["ln_gru_launches"], **sac["launches"], **droq["launches"],
               **sac_ae["launches"], **{k: v["launches"] for k, v in bf16.items()},
               "dv2": dv2["ln_gru_launches"], "dv2_episode": dv2["runs"]["episode"]["ln_gru_launches"],
               "dv2_bf16": dv2["runs"]["bf16"]["ln_gru_launches"], "dv2_resume": dv2_resumed["ln_gru_launches"],
               "dv2_eval": dv2_evaluated["ln_gru_launches"], "dv1": dv1["ln_gru_launches"],
               "dv1_resume": dv1_resumed["ln_gru_launches"], "dv1_eval": dv1_evaluated["ln_gru_launches"],
               "ppo_recurrent": ppo_rec["ln_gru_launches"], "ppo_recurrent_bf16": ppo_rec["bf16_launches"],
               "offline": offline["ln_gru_launches"], "offline_resume": offline["resume_launches"],
               "offline_chunked": offline["chunked_launches"],
               **{f"{name}_offline": row["launches"] for name, row in offline_sac.items()},
               **{f"p2e_dv{v}{suffix}": r[part]["ln_gru_launches"] for v, r in p2e_dv.items()
                  for suffix, part in (("", "run"), ("_resume", "resume"), ("_finetuning", "finetune"),
                                       ("_eval", "eval"))}}
    case_keys = ("B", "K", "H", "dtype", "max_abs_err", "ms", "ms_cold", "plain_ms", "library_ms", "bound_ms", "bound_by")
    kernels = [{
        "name": "ln_gru",
        "route": "cuda",
        "source": "sheeprl_tpu_torch/ops/csrc/ln_gru.cu",
        "replaces": "sheeprl_tpu/ops/pallas_gru.py:64",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "ms_cold": main["ms_cold"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": {"B": main["B"], "K": main["K"], "H": main["H"], "dtype": main["dtype"]},
        "cases": [{k: c[k] for k in case_keys} for c in cases],
        "phase": "kernel+slice+train+chunked+resume+eval+offline+drill+jepa+p2e+sac+droq+sac_ae+offline_sac"
                 "+offline_droq+bf16+dv2+dv1+ppo_recurrent+p2e_dv2+p2e_dv1",
    }]
    mark("kernels line")
    print(f"[timing] wall seconds by group of phases: "
          f"{json.dumps({name: round(t - prev, 1) for (_, prev), (name, t) in zip(stamps, stamps[1:])})}; total "
          f"{stamps[-1][1] - stamps[0][1]:.1f} s  [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
