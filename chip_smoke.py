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
            H=256; B = 16, 1024), DreamerV2's (K=1000, H=600; B = 16, 800,
            and a shard's 8, 400 of two) and Plan2Explore-DV2's (K=800,
            H=400; B = 16, 800, 8, 400), with device
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
3b. resilience — DreamerV3-S (fp32, batch 16 x 64, horizon 15) as
            ``python -m sheeprl_tpu_torch run`` children of the port's
            ``supervise_command`` (``RESILIENCE_OVERRIDES``): the first runs
            the chaos schedule ``slow_write`` then ``preempt`` and must pass
            the drill's checks (``chaos.judge_drill``: exit 75, the two
            chains, status ``preempted``, a final checkpoint that verifies)
            with a ``ckpt_end`` queued at least ``slow_write_s``; the
            supervisor respawns it without backoff and the second resumes
            from that emergency checkpoint and completes; each child's
            LayerNorm-GRU launches equal what its gradient steps and player
            calls predict (``_CHILD_RUNNER`` counts them); ``goodput_report``
            reads the ``restart`` row, ``run_monitor`` the finished run and
            ``health_diff`` two of its journals (in band against itself, out
            of band at zero tolerance); under deadlines
            (``RESILIENCE_DEADLINES_S``, 45 s together); the children run in
            interpreters started with the smoke, which made their imports
            (and warmed the bytecode cache the smoke's subprocesses share)
            while the kernels built;
3d. parallel — coupled data parallelism over two shards of the one card,
            each with its own replica (``parallel/dp.py``), under deadlines
            (``PARALLEL_DEADLINES_S``, 45 s in all): ``python -m
            sheeprl_tpu_torch run exp=dreamer_v3 fabric.devices=2`` at
            DreamerV3-S in a child whose interpreter made its imports with
            the others (``PARALLEL_DV3_OVERRIDES``; its LayerNorm-GRU
            launches 2 x 79 a gradient step plus the player's, its
            ``sharding_audit`` over the two shards) while this process runs
            one DreamerV3-S fp32 gradient step over two shards of 8
            sequences against one device's on the same 16 sequences and
            noise (metrics and Moments within ``PARALLEL_STEP_RTOL``, the
            replicas bitwise equal, shard 0's parameters and Adam state
            against one device's, ``UPDATE_MOMENT_RTOL``), PPO and SAC at ``fabric.devices=2``
            through ``run``, each resumed at ``fabric.devices=1`` from its
            two-shard checkpoint, and the two-shard PPO update on the card
            against the CPU;
3e. parallel_families — the rest of the coupled data axis, under
            deadlines (``PARALLEL_FAMILIES_DEADLINES_S``, 45 s in all):
            ``python -m sheeprl_tpu_torch run exp=p2e_dv2_exploration
            fabric.devices=2`` at its preset's widths in a child whose
            interpreter made its imports with the others
            (``PARALLEL_P2E_DV2_OVERRIDES``; its LayerNorm-GRU launches 2 x
            80 a gradient step plus the player's, its ``sharding_audit``
            over the two shards) while this process runs one DreamerV2 fp32
            gradient step over two shards of 8 sequences against one
            device's on the same 16 (metrics within ``PARALLEL_STEP_RTOL``,
            the replicas bitwise equal, the update against one device's,
            65 + 2 x 65 launches), offline
            DreamerV3-S and offline SAC over two shards through ``run`` on
            datasets written here (2 x 79 launches a DreamerV3-S gradient
            step), the two-shard offline SAC call on the card against the
            CPU, and the env-sharded replay ring on the card against the
            CPU;
3f. decoupled — the decoupled player/trainer under deadlines
            (``DECOUPLED_DEADLINES_S``, 45 s in all): ``python -m
            sheeprl_tpu_torch.tools.chaos_drill --drill trainer_exception``
            with no overrides (its default workload, decoupled PPO at
            ``fabric.devices=2``: one player and one trainer, both on the
            one card), its CLI child handed to an interpreter that made its
            imports with the others, judged by the drill (exit 0,
            ``fault_injection -> rollback -> run_end``, a final checkpoint
            that verifies); while it runs, in this process: ``run
            exp=ppo_decoupled fabric.devices=2`` at the ``ppo`` preset's
            widths with ``nan_grads`` at iteration 2 under the halting
            sentinel (``params_reject`` at staleness 1, ``rollback`` to
            iteration 1, the player at iteration 2 bitwise iteration 1's
            promotion, the final staleness 0), the hand-off's ms a
            promotion; ``run exp=sac_decoupled fabric.devices=2`` at the
            ``sac`` preset's widths, resumed from its checkpoint; one
            decoupled PPO update at ``fabric.devices=3`` (two trainer
            shards on the one card, bitwise equal after it); no path
            launches the LayerNorm-GRU kernel (the JAX loops reach no Pallas
            call);
3g. fsdp — FSDP over two shards of the one card, ``(data, model) = (1,
            2)``, under deadlines (``FSDP_DEADLINES_S``, 45 s in all):
            ``python -m sheeprl_tpu_torch run exp=dreamer_v3
            fabric.devices=2 fabric.fsdp=2`` at DreamerV3-S in a child whose
            interpreter made its imports with the others
            (``FSDP_DV3_OVERRIDES``; its LayerNorm-GRU launches 2 x 79 a
            gradient step on the gathered weight plus the player's, its
            ``fsdp_shard_map`` printed, its two-part checkpoint group each
            file verified) while this process runs one DreamerV3-S fp32
            gradient step at ``fsdp=2`` against one device's on the same 16
            sequences and noise, every update clipped (within
            ``PARALLEL_STEP_RTOL``, shard 0's parameters and the Adam state
            gathered over the model shards against one device's, 79 + 2 x
            79 launches), the same step with its draws from one generator
            (``dp.global_streams``: each draw's blocks joined bitwise the
            one-device draw) and the step at two data shards, each's peak
            of allocated bytes; then the child's group resumed at
            ``fabric.devices=1 fabric.fsdp=1``;
4. slice  — compose ``exp=dreamer_v3 env=dummy``, build DreamerV3-S on the card
            from a seed, write a run directory in the JAX package's checkpoint
            format, start the port's ``serve`` entry point and send /act
            traffic from concurrent sessions over HTTP; every reply must be
            200 with a valid one-hot action, the kernel's launch count must
            equal the number of policy steps the server ran, and one batch
            recomputed through the plain path must agree;
4b. serve-ops — phase 4's run served as ``default`` next to a copy of it as
            ``canary`` (each its own run directory, journal and watch
            directory) with reload (poll 0.2 s), the trace, the SLO with the
            slow-request drill and the request log on: concurrent HTTP
            sessions to both models, every reply 200 with its
            ``X-Request-Id``; new weights (another seed) promoted in
            ``default`` (``ckpt_promote``, ``/healthz``), its greedy reply and
            session state equal to the plain path on the new weights and
            ``canary``'s to the plain path on the old ones; a checkpoint held
            back by an open ``anomaly`` (``ckpt_reject``) and promoted after
            ``anomaly_end``; one at recurrent size 256 rejected for good while
            serving goes on; the kernel's launches equal to both models'
            policy steps (warm-up and the two recomputations included); the
            ``slow_request`` with its phases; ``/metrics``' per-model latency
            histograms; ``trace_serve.json`` with a span for each phase; each
            model's request log verified, one row a reply; the p50 and p99 of
            each phase per model and of the dispatch time per dispatch;
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
            actions, the actor's own); ``exp=droq`` (``DROQ_OVERRIDES``, 5
            gradient steps a policy step, the preset's 20 cut) and ``exp=sac_ae``
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
            default diagnostics (health stats, instrumented: its FLOPs and
            MFU; the fp32 one on the offline loader's first batch, the
            offline loop's step); the CPU's FLOP count of the fp32 step, equal to
            the card's; the journals' MFU, the syncs a step and ``ckpt_end``'s
            ``write_ms`` (async and blocking);
17b. minedojo — ``run exp=dreamer_v3`` at DreamerV3-S with
            ``algo.actor.cls=...MinedojoActor`` on the MineDojo-shaped env
            (``MinedojoShapedEnv``, built in this process: MultiDiscrete
            ``[19, craft, item]`` actions and the ``mask_*`` observations),
            79 launches a gradient step plus the player and test steps, every
            action the player took allowed by its step's masks, a
            kernel-vs-plain train step; then each optimizer written out from
            optax, one update on the card against the CPU; each phase under a
            deadline (``SLICE_DEADLINES_S``, 45 s together) that fails it by
            name;
18. records — ``run`` at DreamerV3-S (fp32, 2 iterations of gradient steps)
            with ``metric.profiler.enabled=True`` and
            ``model_manager.disabled=False``: without mlflow the registry warns
            and is disabled, as the JAX ``check_configs`` does, and the run
            trains; its Chrome trace parses and holds as many
            ``ln_gru_kernel`` events as the launch counter counts; each
            gradient step's stream time, the profiler's overhead beside phase
            17's; the six report tools (``python -m
            sheeprl_tpu_torch.tools.*_report``, no JAX, ``sheeprl_tpu`` or
            torch loaded) on phase 5's run, phase 9's ``trace.json``, phase
            4b's ``trace_serve.json`` and journal and phase 8b's export; the
            search (``tools/search.py``'s ``main``) over JEPA-XS, 2 random
            trials under ASHA through the kernel, both ``COMPLETE``;
            ``registration`` raising ``ModuleNotFoundError`` without mlflow;
19. every path's kernel launches (``[launches]``, from the kernels line's
            ``launches_by_path``), the ``kernels`` JSON line, then the result
            line.

Each phase prints its wall time as it ends (``[phase-time]``), each group of
phases its own and the running total (``[timing]``), and all the groups'
again before the kernels line.

It needs no network, writes only under ``build/`` in the checkout (and
removes the XL runs' checkpoints once their phases are done), and stops
every thread it starts.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import json
import os
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
# chunked scan and 48 = (K-1)*B of its burn-in at rssm_chunks=4; 4 = the
# player's rows at env.num_envs=4; 8 and 512 = a shard's scan and
# imagination in the parallel group's two-shard step at 8 sequences).  XL and
# XS: DreamerV3-JEPA's two presets (exp=dreamer_v3_jepa, _xs) at the same
# two training widths; XL also at serving widths.  DreamerV2 and P2E-DV2 at
# one device's 16 and 16 x 50 = 800 rows, and at a shard's of two at 16
# sequences: 8 in its scan, 8 x 50 = 400 in its imagination
KERNEL_CASES = [(S_SHAPE, b) for b in (1, 8, 37, 128, 16, 1024, 64, 48, 4, 512)] + \
    [(XL_SHAPE, b) for b in (8, 128, 16, 1024)] + [(XS_SHAPE, b) for b in (16, 1024)] + \
    [(DV2_SHAPE, b) for b in (16, 800, 8, 400)] + [(P2E_DV2_SHAPE, b) for b in (16, 800, 8, 400)]
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
                   "algo.total_steps=260", "buffer.size=1024", "checkpoint.every=100000", "metric.logger=null",
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
TIMED_STEPS = 1
# the chunked phase: the options the DV3 presets train with, at DreamerV3-S.
# A resumed run waits learning_starts (64 iterations of 4 envs) before it
# trains again, as the JAX package's does, and cannot change total_steps; so
# the run checkpoints at iteration 110 (policy step 440, the next would be
# 880 > 876) and runs to 219, at a replay ratio that gives it 8 gradient
# steps (2 before the checkpoint) and the resumed run 1
CHUNKED_STEP_OPTIONS = ["fabric.precision=bf16-mixed", "algo.rssm_chunks=4", "algo.rssm_chunk_burn_in=2"]
CHUNKED_OPTIONS = CHUNKED_STEP_OPTIONS + ["buffer.device=True", "buffer.checkpoint=True"]
CHUNKED_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.executor=shared_memory", "env.capture_video=False",
                     "run_name=chip_smoke_chunked", "algo.learning_starts=256", "algo.total_steps=876",
                     "algo.replay_ratio=0.013", "buffer.size=1024", "checkpoint.every=440",
                     "checkpoint.save_last=False", "metric.logger=null", "buffer.export=True", "seed=5",
                     *CHUNKED_OPTIONS]
CHUNKED_GRADIENT_STEPS = 8
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
# phase 4b: sessions per model and requests per session in each of its two
# rounds of traffic; the slow-request drill's dispatch and threshold; the
# request log's rows per shard
SERVE_OPS_SESSIONS = 8
SERVE_OPS_REQUESTS = 10
SERVE_OPS_INJECT_ITER = 3
SERVE_OPS_SLOW_MS = 200.0
SERVE_OPS_ROTATE_ROWS = 64
# what builds the new weights phase 4b promotes (phase 4's composition)
SERVE_OPS_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "run_name=chip_smoke"]
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
# the executors' comparison runs: two iterations of 8 envs x 64 steps (two
# minibatches of 256 an epoch)
PPO_COMPARE_DEPTH = ["algo.rollout_steps=64", "algo.total_steps=1024"]
PPO_TIMED_UPDATES = 3
PPO_SERVE_CLIENTS, PPO_SERVE_REQUESTS = 16, 6
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
                  "algo.learning_starts=256", "algo.total_steps=592", "algo.replay_ratio=0.016", "buffer.size=1024",
                  "buffer.checkpoint=True", "checkpoint.every=264", "checkpoint.save_last=False",
                  "metric.logger=null", "metric.log_every=16", "seed=5"]
JEPA_MIN_GRADIENT_STEPS = 4
JEPA_TIMED_STEPS = 1
# the P2E phase: exp=p2e_dv3_exploration at its composed XL widths
# (DreamerV3-XL with the [rgb] decoder, an ensemble of 8 MLPs of 1024 x 5,
# the intrinsic and extrinsic exploration critics; batch 16 x 64, horizon
# 15, fp32, 4 envs) under the default diagnostics, cut in depth as JEPA's
# run: learning from policy step 256, checkpoints (with the replay) at
# iterations 66 and 132, a replay ratio that owes 5 gradient steps by
# iteration 148 and the run resumed from the first checkpoint one more.
# Finetuning goes on from the last checkpoint and its replay: 4 iterations
# of prefill, then the player acts with the exploration actor until the
# first gradient step (iteration 7 at this replay ratio) and with the task
# actor after it; 2 gradient steps in 16 iterations
P2E_OVERRIDES = ["exp=p2e_dv3_exploration", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_p2e",
                 "algo.learning_starts=256", "algo.total_steps=592", "algo.replay_ratio=0.016", "buffer.size=1024",
                 "buffer.checkpoint=True", "checkpoint.every=264", "checkpoint.save_last=False", "metric.logger=null",
                 "metric.log_every=16", "seed=5"]
P2E_FINETUNE_OVERRIDES = ["exp=p2e_dv3_finetuning", "env=dummy", "env.capture_video=False",
                          "run_name=chip_smoke_p2e_finetuning", "algo.learning_starts=16", "algo.total_steps=64",
                          "algo.replay_ratio=0.05", "buffer.size=1024", "buffer.load_from_exploration=True",
                          "buffer.checkpoint=False", "checkpoint.every=100000", "checkpoint.save_last=True",
                          "metric.logger=null", "metric.log_every=16", "seed=5"]
P2E_MIN_GRADIENT_STEPS = 4
P2E_TIMED_STEPS = 1
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
# from policy step 128, 512 steps (about 380 gradient steps; 512 rows, two
# batches for its offline run); DroQ (dropout 0.01; the preset's replay
# ratio 20 cut to 2, its loop of gradient steps a policy step as long as
# the ratio) on 2 envs, 256 steps (about 390 gradient steps; 256 rows, a
# batch for its offline run), a checkpoint at
# step 160 (its resume waits learning_starts again, to iteration 113, then
# trains 16 iterations) and at the end; SAC-AE (64x64 rgb with a 3-frame stack plus
# state, features 64, actor and critics 1,024, batch 128) on 2 envs, 192
# steps (about 130 gradient steps); SAC and SAC-AE checkpoint at half way
# and at the end.  SAC and DroQ export their replay (buffer.export)
SAC_OVERRIDES = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.executor=sync", "env.capture_video=False",
                 "env.num_envs=4", "algo.learning_starts=128", "algo.total_steps=512", "buffer.size=1024",
                 "buffer.checkpoint=True", "buffer.export=True", "checkpoint.every=256", "metric.logger=null",
                 "metric.log_every=128", "run_name=chip_smoke_sac", "seed=5"]
DROQ_OVERRIDES = ["exp=droq", "env=dummy", "env.id=continuous_dummy", "env.executor=sync", "env.capture_video=False",
                  "env.num_envs=2", "algo.learning_starts=64", "algo.total_steps=256", "algo.replay_ratio=2",
                  "buffer.size=256",
                  "buffer.checkpoint=True", "buffer.export=True", "checkpoint.every=160",
                  "algo.mlp_keys.encoder=[state]",
                  "metric.logger=null", "metric.log_every=80", "run_name=chip_smoke_droq", "seed=5"]
SAC_AE_OVERRIDES = ["exp=sac_ae", "env=dummy", "env.id=continuous_dummy", "env.executor=sync",
                    "env.capture_video=False", "env.num_envs=2", "env.frame_stack=3", "algo.cnn_keys.encoder=[rgb]",
                    "algo.mlp_keys.encoder=[state]", "algo.learning_starts=64", "algo.total_steps=192",
                    "buffer.size=256", "buffer.checkpoint=True", "checkpoint.every=96", "metric.logger=null",
                    "metric.log_every=96", "run_name=chip_smoke_sac_ae", "seed=5"]
SAC_SERVE_CLIENTS, SAC_SERVE_REQUESTS = 8, 8
SAC_TIMED_STEPS = 3
# this slice's group: DreamerV3-S with MinedojoActor on the MineDojo-shaped
# env (minedojo_shaped_env, env.executor=sync) at batch 16 x 64, horizon 15,
# fp32; 2 envs, learning starts at iteration 64 (64 rows of each), replay
# ratio 1/4: 4 gradient steps by iteration 72; and the optimizers written
# out from optax, one update each on the card against the CPU.
MINEDOJO_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.id=minedojo_dummy", "env.executor=sync", "env.num_envs=2",
                      "env.capture_video=False", "run_name=chip_smoke_minedojo",
                      "algo.actor.cls=sheeprl_tpu_torch.algos.dreamer_v3.agent.MinedojoActor",
                      "algo.cnn_keys.encoder=[rgb]", "algo.cnn_keys.decoder=[rgb]",
                      "algo.mlp_keys.encoder=[state,mask_action_type,mask_craft_smelt,mask_equip_place,mask_destroy]",
                      "algo.mlp_keys.decoder=[state]", "algo.learning_starts=128", "algo.total_steps=144",
                      "algo.replay_ratio=0.25", "buffer.size=256", "checkpoint.every=100000", "metric.logger=null",
                      "metric.log_every=16", "seed=5"]
OPTIMIZER_VARIANTS = {
    "sgd_nesterov": ("sgd", {"momentum": 0.9, "nesterov": True}),
    "rmsprop_centered_nesterov": ("rmsprop", {"centered": True, "momentum": 0.9, "nesterov": True,
                                              "eps_in_sqrt": False}),
    "rmsprop_bias_correction": ("rmsprop", {"bias_correction": True, "eps_in_sqrt": False}),
    "adam_eps_root": ("adam", {"eps_root": 1e-8}),
    "adamw_mask_mu_dtype_nesterov": ("adamw", {"mask": [True, False], "mu_dtype": "bfloat16", "nesterov": True,
                                               "weight_decay": 0.1}),
}
OPTIMIZER_CARD_CPU_RTOL = 1e-5
# kernel launches a gradient step: 64 dynamic steps at 16 rows and 15
# imagined at 1,024, one launch a call
MINEDOJO_LAUNCHES_PER_STEP = 79
# each phase of the group and its deadline, 45 s together
SLICE_DEADLINES_S = {"minedojo": 38.0, "optimizers": 7.0}
# the resilience group: DreamerV3-S fp32 at its widths (batch 16 x 64,
# horizon 15) on the dummy env, 4 envs, learning from policy step 256
# (iteration 64), one gradient step an iteration, no test episode and no
# FLOP count (telemetry's cost analysis off: each child would run it once),
# run by the smoke's supervisor as `python -m sheeprl_tpu_torch run`
# children.  The first runs the chaos schedule: slow_write at iteration 64,
# paid by that iteration's checkpoint (checkpoint.every=256) in the writer
# thread, and preempt at 65 (the emergency checkpoint, exit 75).  The
# supervisor respawns it at once; the second child resumes from that
# checkpoint (iteration 66), checkpoints at 129, waits learning_starts
# again (to iteration 130) and trains to iteration 132.  Then run_monitor
# reads the run and health_diff two of its journals.  A child's process
# costs about 13 s before its first env step on the card (imports, CUDA,
# the first iteration's set-up; its interpreter makes the imports, about
# 7 s of them, before the group), so the steps are few
RESILIENCE_SLOW_WRITE_ITER, RESILIENCE_PREEMPT_ITER, RESILIENCE_SLOW_WRITE_S = 64, 65, 0.5
RESILIENCE_SCHEDULE = [{"iter": RESILIENCE_SLOW_WRITE_ITER, "fault": "slow_write"},
                       {"iter": RESILIENCE_PREEMPT_ITER, "fault": "preempt"}]
RESILIENCE_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_chaos",
                        "algo.learning_starts=256", "algo.total_steps=528", "algo.replay_ratio=0.25",
                        "buffer.size=1024", "checkpoint.every=256", "checkpoint.save_last=False",
                        "metric.logger=null", "metric.log_every=16", "algo.run_test=False", "seed=5",
                        "diagnostics.telemetry.mfu.cost_analysis=False",
                        f"diagnostics.resilience.chaos.slow_write_s={RESILIENCE_SLOW_WRITE_S}"]
# this slice's phases and their deadlines, 45 s together
RESILIENCE_DEADLINES_S = {"resilience_children": 43.5, "resilience_reports": 1.5}
# the parallel group (coupled data parallelism, fabric.devices=2: two shards
# on the one card, each with its own replica).  (1) DreamerV3-S (batch 16 x
# 64 a shard, horizon 15, fp32) as `python -m sheeprl_tpu_torch run
# fabric.devices=2` in a child whose interpreter made its imports before the
# group: 4 envs, learning from policy step 256 (64 rows of each env), one
# gradient step an iteration to iteration 68, no checkpoint, no test; each
# gradient step runs the dynamic scan and the imagination once a shard (2 x
# 79 launches) while the smoke runs (2) and (3).  (2) one DreamerV3-S fp32
# gradient step at per_rank_batch_size=8 over two shards against one
# device's step on the same 16-row global batch and noise (noise that
# decides every categorical draw: the two paths' logits differ by rounding,
# and a near tie would otherwise split a sample).  (3) PPO (an MLP on the
# dummy env's state, 4 envs x 32 steps, batch 32 a shard) and SAC (its
# preset's widths, 4 envs, learning from step 32) at fabric.devices=2 through
# `run`, each resumed at fabric.devices=1 from its two-shard mid-run
# checkpoint; and one two-shard PPO update from that checkpoint on the card
# against the same two-shard update on the CPU
PARALLEL_DV3_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_parallel",
                          "fabric.devices=2", "env.num_envs=4", "algo.learning_starts=256", "algo.total_steps=272",
                          "algo.replay_ratio=0.25", "buffer.size=1024", "checkpoint.every=100000",
                          "checkpoint.save_last=False", "metric.logger=null", "metric.log_every=16",
                          "algo.run_test=False", "seed=5", "diagnostics.telemetry.mfu.cost_analysis=False"]
PARALLEL_PPO_OVERRIDES = ["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False",
                          "env.executor=sync", "fabric.devices=2", "env.num_envs=4", "algo.rollout_steps=32",
                          "algo.per_rank_batch_size=32", "algo.total_steps=256", "algo.mlp_keys.encoder=[state]",
                          "algo.cnn_keys.encoder=[]", "checkpoint.every=128", "metric.logger=null",
                          "metric.log_every=128", "algo.run_test=False", "run_name=chip_smoke_parallel_ppo", "seed=5"]
PARALLEL_SAC_OVERRIDES = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.executor=sync",
                          "env.capture_video=False", "fabric.devices=2", "env.num_envs=4", "algo.learning_starts=32",
                          "algo.total_steps=128", "buffer.size=256", "buffer.checkpoint=True", "checkpoint.every=64",
                          "metric.logger=null", "metric.log_every=64", "algo.run_test=False",
                          "run_name=chip_smoke_parallel_sac", "seed=5"]
PARALLEL_STEP_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "seed=5", "diagnostics=off"]
PARALLEL_SHARDS = 2
# the two-shard DreamerV3-S step against one device's on the same global
# batch, its 11 metrics and the Moments' low/high: the same function with
# its fp32 sums in another order (each loss the mean of two half-batch means
# against one mean over the whole batch; each gradient, and so each norm,
# the mean of two half-batch gradients).  A sum of n fp32 terms reordered
# moves by about sqrt(n) * 2^-24 of its magnitude: ~1e-6 over the 1024 rows
# and 15 x 1024 imagined states; the card read 9.73e-07 and 1.2e-06 on
# NVIDIA H100 80GB HBM3 at 700 W.  1e-4 is ~100x that: a shard's block run
# with another block's noise, a missing or doubled shard, or a reduction
# over the wrong set moves a metric by far more
PARALLEL_STEP_RTOL = 1e-4
PARALLEL_CARD_CPU_RTOL, PARALLEL_CARD_CPU_ATOL = 1e-4, 1e-4
# the group's deadlines, 45 s in all: the group, and within it the
# in-process phases (the child runs beside them)
PARALLEL_DEADLINES_S = {"parallel": 45.0, "parallel_step": 15.0, "parallel_ppo_sac": 25.0}
# what a resilience child imports (the registry imports every algorithm;
# torch.optim's first parameter group imports torch._dynamo), imported by
# its interpreter before its run (and so compiled into the bytecode cache
# at the start)
WARM_IMPORTS = (
    "import cv2, torch._dynamo, torch.optim, torch.profiler, sheeprl_tpu_torch.cli, "
    "sheeprl_tpu_torch.diagnostics.facade, sheeprl_tpu_torch.resilience.monitor, sheeprl_tpu_torch.resilience.manifest, "
    "sheeprl_tpu_torch.envs.dummy, sheeprl_tpu_torch.envs.env, sheeprl_tpu_torch.envs.player, "
    "sheeprl_tpu_torch.data.factory, sheeprl_tpu_torch.data.slab, sheeprl_tpu_torch.interop.flax_params, "
    "sheeprl_tpu_torch.offline.train, sheeprl_tpu_torch.utils.logger, sheeprl_tpu_torch.utils.checkpoint, "
    "sheeprl_tpu_torch.utils.metric, sheeprl_tpu_torch.utils.timer\n"
    "from sheeprl_tpu_torch.utils.registry import find_algorithm\n"
    "find_algorithm('dreamer_v3')"
)
# the DreamerV2 phases: exp=dreamer_v2's widths (64x64 rgb, CNN multiplier
# 48, dense 400 x 4 layers, recurrent 600, stochastic 32 x 32, hidden 600;
# batch 16 x 50, horizon 15, fp32) on the dummy env, 4 envs, cut in depth
# as JEPA's run: learning from policy step 256, checkpoints (with the
# replay) at iterations 66 and 132, the run to 148; at replay ratio 0.05
# 8 gradient steps, and the run resumed from the first checkpoint
# trains again from iteration 131.  The episode-buffer run samples whole
# episodes of the multi-discrete dummy (128 steps, longer than the
# sequences of 50): it learns once every env has closed one (iteration
# 136).  The bf16-mixed run learns from iteration 64 of 76
DV2_OVERRIDES = ["exp=dreamer_v2", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_dv2",
                 "algo.learning_starts=256", "algo.total_steps=592", "algo.replay_ratio=0.025", "buffer.size=1024",
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
                 "algo.learning_starts=256", "algo.total_steps=592", "algo.replay_ratio=0.02", "buffer.size=1024",
                 "buffer.checkpoint=True", "checkpoint.every=264", "checkpoint.save_last=False", "metric.logger=null",
                 "metric.log_every=16", "seed=5"]
DV1_MIN_GRADIENT_STEPS = 4
DREAMER_TIMED_STEPS = 1
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
# task actor after it; 2 gradient steps in 16 iterations
P2E_DREAMER_OVERRIDES = {
    version: [f"exp=p2e_dv{version}_exploration", "env=dummy", "env.capture_video=False",
              f"run_name=chip_smoke_p2e_dv{version}", "algo.learning_starts=256", "algo.total_steps=592",
              "algo.replay_ratio=0.02", "buffer.size=1024", "buffer.checkpoint=True", "checkpoint.every=264",
              "checkpoint.save_last=False", "metric.logger=null", "metric.log_every=16", "seed=5"]
    for version in (2, 1)}
P2E_DREAMER_FINETUNE_OVERRIDES = {
    version: [f"exp=p2e_dv{version}_finetuning", "env=dummy", "env.capture_video=False",
              f"run_name=chip_smoke_p2e_dv{version}_finetuning", "algo.learning_starts=16", "algo.total_steps=64",
              "algo.replay_ratio=0.05", "buffer.size=1024", "buffer.load_from_exploration=True",
              "buffer.checkpoint=False", "checkpoint.every=100000", "checkpoint.save_last=True",
              "metric.logger=null", "metric.log_every=16", "seed=5"]
    for version in (2, 1)}
P2E_DREAMER_MIN_GRADIENT_STEPS = 4
# kernel launches a gradient step, (exploration, finetuning): P2E-DV2's 50
# dynamic steps at 16 rows and 15 imagined steps at 800 in each of two
# imaginations (one in the finetuning's DreamerV2 step), one launch a call;
# P2E-DV1's plain GRU none
P2E_DREAMER_LAUNCHES = {2: (80, 65), 1: (0, 0)}
P2E_DREAMER_TIMED_STEPS = 1
# the recurrent PPO phase: exp=ppo_recurrent's widths (16 envs x 512 rollout
# steps, sequences of 16 in 8 minibatches, LSTM 64, encoder 64,
# adamw with clip 0.5) on the dummy env's `state` (CartPole needs
# gymnasium), cut in depth to 2 epochs (the preset's 8) and two iterations,
# a checkpoint after each; the discrete dummy's
# episodes end at their 5th step, so every sequence holds resets
PPO_REC_OVERRIDES = ["exp=ppo_recurrent", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False",
                     "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]", "algo.total_steps=16384",
                     "algo.update_epochs=2",
                     "checkpoint.every=8192", "metric.log_every=8192", "metric.logger=null",
                     "run_name=chip_smoke_ppo_recurrent", "seed=5"]
PPO_REC_SESSIONS, PPO_REC_ROUNDS = 2, 6
PPO_REC_TIMED_UPDATES = 2
# card vs CPU, two gradient steps from a trained checkpoint in fp32 (TF32
# off): SAC to 1e-4 relative; SAC-AE's four convolutions hold some 10^7
# ReLU units at batch 128, and a unit at its kink is on in one library and
# off in the other, so its metrics to 1e-3 and its weights to one Adam step
# (lr 1e-3)
CARD_CPU_METRIC_RTOL = {"sac": 1e-4, "sac_ae": 1e-3, "sac_offline": 1e-4, "droq_offline": 1e-4}
CARD_CPU_PARAM_ATOL = {"sac": 1e-4, "sac_ae": 1e-3, "sac_offline": 1e-4, "droq_offline": 1e-4}
# the offline phases: DreamerV3-S (exp=dreamer_v3's widths: batch 16 x 64,
# horizon 15, fp32) trains with no env on the fp32 training run's live
# export, 2 iterations of 2 gradient steps with a checkpoint after each (79
# kernel launches a step: 64 dynamic steps at 16 rows, 15 imagined at 1,024),
# then resumes from the first and continues the offline counters (2 more
# steps).  The dummy env's Discrete(2) actions are stored one-hot; the run
# declares them, so its agent is the online run's.  The chunked bf16 step
# trains 4 steps on the device ring's export (its rssm_* keys); SAC and DroQ
# at their widths (hidden 256, batch 256) with the conservative penalty on
# their phases' exports, 4 and 2 gradient steps
OFFLINE_DV3_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "algo.offline.enabled=true",
                         "algo.offline.actions_dim=[2]", "algo.offline.is_continuous=False", "algo.total_steps=4",
                         "algo.offline.grad_steps_per_iter=2", "checkpoint.every=2", "metric.logger=null",
                         "metric.log_every=2", "run_name=chip_smoke_offline", "seed=5"]
OFFLINE_CHUNKED_OVERRIDES = [*OFFLINE_DV3_OVERRIDES, *CHUNKED_STEP_OPTIONS, "algo.total_steps=4",
                             "algo.offline.grad_steps_per_iter=2", "checkpoint.every=4", "metric.log_every=4",
                             "run_name=chip_smoke_offline_chunked"]
OFFLINE_DV3_STEPS, OFFLINE_CHUNKED_STEPS = 4, 4
OFFLINE_SAC_OPTIONS = ["env=dummy", "env.id=continuous_dummy", "env.capture_video=False", "algo.offline.enabled=true",
                       "algo.offline.cql_alpha=1.0", "algo.offline.action_low=-1", "algo.offline.action_high=1",
                       "algo.total_steps=4", "checkpoint.every=2", "metric.logger=null", "metric.log_every=2",
                       "seed=5"]
# gradient steps an iteration: SAC's 2 x 256 rows of the 512 its run
# stored; DroQ's run stored 256, one batch of each of its two streams
OFFLINE_SAC_GRAD_STEPS = {"sac": 2, "droq": 1}
# phase 17 times the fp32 step under the default diagnostics on the offline
# loader's first batch: the offline loop's step
OFFLINE_TIMER_NOTE = " (the offline step, on the offline loader's first batch)"

# the parallel_families group (45 s), the rest of the coupled data axis: (1)
# Plan2Explore-DV2 exploration at its preset's widths (recurrent 400, dense
# 400, K=800, an ensemble of 10 x 400 x 4, batch 16 x 50 a shard, horizon 15,
# fp32) as `python -m sheeprl_tpu_torch run fabric.devices=2` in a child
# whose interpreter made its imports before the group, its depth cut as the
# parallel group's DreamerV3-S child's (4 envs, learning from policy step
# 256, one gradient step an iteration to iteration 68): each gradient step
# runs the dynamic scan and both imaginations once a shard (2 x 80
# launches).  While it runs, in this process: (2) one DreamerV2 fp32
# gradient step at exp=dreamer_v2's widths over two shards of 8 sequences
# against one device's on the same 16 x 50 batch and noise (65 launches and
# 2 x 65); (3) offline DreamerV3-S over two shards through `run` on a
# dataset written here (two gradient steps, 2 x 79 launches each); (4)
# offline SAC with the conservative penalty over two shards through `run`
# at its preset's widths, then a two-shard SAC train call from its
# checkpoint on the card against the CPU; (5) the env-sharded replay ring
# over two shards on the card, sampling bitwise what it samples on the CPU
# from the same seed
PARALLEL_P2E_DV2_OVERRIDES = ["exp=p2e_dv2_exploration", "env=dummy", "env.capture_video=False",
                              "run_name=chip_smoke_parallel_p2e_dv2", "fabric.devices=2", "env.num_envs=4",
                              "algo.learning_starts=256", "algo.total_steps=272", "algo.replay_ratio=0.25",
                              "buffer.size=1024", "checkpoint.every=100000", "checkpoint.save_last=False",
                              "metric.logger=null", "metric.log_every=16", "algo.run_test=False", "seed=5",
                              "diagnostics.telemetry.mfu.cost_analysis=False"]
PARALLEL_DV2_STEP_OVERRIDES = ["exp=dreamer_v2", "env=dummy", "env.capture_video=False", "seed=5", "diagnostics=off"]
PARALLEL_OFFLINE_DV3_OVERRIDES = [*OFFLINE_DV3_OVERRIDES, "fabric.devices=2", "algo.total_steps=2",
                                  "algo.offline.grad_steps_per_iter=2", "checkpoint.every=2",
                                  "run_name=chip_smoke_parallel_offline_dv3"]
PARALLEL_OFFLINE_SAC_OVERRIDES = ["exp=sac", *OFFLINE_SAC_OPTIONS, "fabric.devices=2",
                                  "algo.offline.grad_steps_per_iter=2", "run_name=chip_smoke_parallel_offline_sac"]
# the datasets written here: DreamerV3-S's, 4 streams of 96 steps of the
# dummy env's record (64x64 rgb, one-hot actions of 2, episodes of 32);
# SAC's, 2 streams of 1,024 transitions of a 10-dim state and 2-dim actions
PARALLEL_OFFLINE_STREAMS, PARALLEL_OFFLINE_ROWS = 4, 96
PARALLEL_SAC_STREAMS, PARALLEL_SAC_ROWS = 2, 1024
# the ring: 4 envs of DreamerV3-S's record, 96 steps each, 2 draws of 16
# windows of 64
PARALLEL_RING_ENVS, PARALLEL_RING_STEPS = 4, 96
PARALLEL_FAMILIES_DEADLINES_S = {"parallel_families": 45.0, "parallel_dv2_step": 12.0, "parallel_offline": 25.0}

# the decoupled group (45 s), the player/trainer split (device 0 the player,
# devices 1..N-1 the trainer's shards; on the one card all cuda:0): (1) the
# chaos drill of a trainer_exception on its default workload (decoupled PPO,
# one player and one trainer), its CLI child in an interpreter of
# start_child_runners.  While it runs, in this process: (2) decoupled PPO at
# the ppo preset's widths (dense 64 x 2 on the dummy env's state, batch 64)
# cut in depth (4 envs x 64 steps, 2 epochs, 5 iterations), nan_grads at
# iteration 2 under the halting sentinel: the gate rejects, the trainer rolls
# back to iteration 1, the player keeps iteration 1's parameters; (3)
# decoupled SAC at the sac preset's widths (hidden 256, batch 256), 4 envs,
# learning from step 32, resumed from its mid-run checkpoint; (4) one
# decoupled PPO update at fabric.devices=3 (two trainer shards)
DECOUPLED_PPO_OVERRIDES = ["exp=ppo_decoupled", "env=dummy", "env.id=discrete_dummy", "env.capture_video=False",
                           "env.executor=sync", "fabric.devices=2", "env.num_envs=4", "algo.rollout_steps=64",
                           "algo.update_epochs=2", "algo.total_steps=1280", "algo.cnn_keys.encoder=[]",
                           "algo.mlp_keys.encoder=[state]", "checkpoint.every=512", "metric.logger=null",
                           "metric.log_every=256", "algo.run_test=False", "run_name=chip_smoke_decoupled_ppo",
                           "seed=5", "diagnostics.telemetry.mfu.cost_analysis=False"]
DECOUPLED_FAULT = ["diagnostics.resilience.chaos.schedule=[{iter: 2, fault: nan_grads}]",
                   "diagnostics.sentinel.enabled=True", "diagnostics.sentinel.policy=halt"]
DECOUPLED_SAC_OVERRIDES = ["exp=sac_decoupled", "env=dummy", "env.id=continuous_dummy", "env.executor=sync",
                           "env.capture_video=False", "fabric.devices=2", "env.num_envs=4", "algo.learning_starts=32",
                           "algo.total_steps=128", "buffer.size=256", "buffer.checkpoint=True", "checkpoint.every=64",
                           "metric.logger=null", "metric.log_every=64", "algo.run_test=False",
                           "run_name=chip_smoke_decoupled_sac", "seed=5",
                           "diagnostics.telemetry.mfu.cost_analysis=False"]
DECOUPLED_DEADLINES_S = {"decoupled": 45.0, "decoupled_ppo": 15.0, "decoupled_sac": 20.0}

# the fsdp group (45 s), fabric.fsdp=2 over two shards (a (data, model) =
# (1, 2) layout, both shards on the one card): (1) DreamerV3-S through `run`
# at fabric.devices=2 fabric.fsdp=2 in a child of start_child_runners (the
# parallel group's workload, a partial-shard checkpoint group written at
# policy step 264, mid-training), its fsdp_shard_map journaled; while it
# runs, in this process, (2) one DreamerV3-S fp32 step at fsdp=2 against one
# device's on the same global batch and noise (_two_shards_against_one), and
# the same step at two data shards, each's peak of allocated bytes; then (3)
# the child's group resumed at fabric.devices=1 fabric.fsdp=1
FSDP_DV3_OVERRIDES = [*(o for o in PARALLEL_DV3_OVERRIDES if not o.startswith(("run_name=", "checkpoint.every="))),
                      "run_name=chip_smoke_fsdp", "fabric.fsdp=2", "checkpoint.every=264"]
FSDP_AXIS = 2
# a two-shard step's update against one device's (``_update_against_one``):
# each optimizer's Adam moments, gathered over the model shards, held to
# their tree's norm.  They are the gradient's (0.1 g, 0.001 g^2), which the
# shards sum in another order; the actor's gradient is a near cancellation
# (its norm ~2.5e-05 at DreamerV3-S's first step against a loss of terms
# ~100x larger), so its moments moved 2.27e-04-2.38e-04 on NVIDIA H100 80GB HBM3 at
# 700 W, the others at most 5e-06.  3e-3 is ~13x that; a clip by one model
# shard's own norm, or the slices gathered in the wrong order, moved them
# 0.11-0.45 in a copy of the tree run on the CPU
UPDATE_MOMENT_RTOL = 3e-3
# the in-process fsdp=2 step clips every update (a clip below each of its
# gradient norms), so Adam's moments after it show the clip's factor: a
# clip by one model shard's own slices' norm moves them by ~30 %
FSDP_STEP_CLIP = 1e-3
FSDP_DEADLINES_S = {"fsdp": 45.0, "fsdp_step": 20.0, "fsdp_resume": 15.0}
# the multihost group: (1) the parallel group's DreamerV3-S workload as two
# ranks of `python -m sheeprl_tpu_torch run fabric.num_nodes=2` (one shard a
# rank, both on cuda:0, a gloo group from torchrun's variables on a free
# localhost port; NCCL refuses two ranks on one card), each in a child of
# start_child_runners, its coordinated checkpoint groups written at policy
# steps 264 and 272; while they run, (2) two fresh processes take one
# DreamerV3-S fp32 gradient step as two ranks, held to the one-process
# two-shard step on the same blocks and noise in this process
MULTIHOST_DV3_OVERRIDES = [*(o for o in PARALLEL_DV3_OVERRIDES
                             if not o.startswith(("run_name=", "checkpoint.every=", "checkpoint.save_last="))),
                           "run_name=chip_smoke_multihost", "fabric.num_nodes=2", "checkpoint.every=264",
                           "checkpoint.save_last=True"]
MULTIHOST_RANKS = 2
# the two-rank step runs twice on the same blocks and noise: the first in a
# fresh process pays its lazy set-up, the second times the gloo collectives
MULTIHOST_STEPS = 2
MULTIHOST_DEADLINES_S = {"multihost": 45.0, "multihost_step": 40.0}
# a rank of the two-rank step: this checkout's chip_smoke imported from its
# root, ``multihost_step_rank(record, device, overrides)``
_MULTIHOST_STEP = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.multihost_step_rank(sys.argv[2], sys.argv[3], json.loads(sys.argv[4]))
"""

# phase 18 (records): a profiled DreamerV3-S run with the model registry
# asked for (learning from policy step 256 of 4 envs: 1 iteration of 4
# gradient steps), the report tools on the earlier phases' runs, a 2-trial
# search over JEPA-XS through the kernel (each trial 64 iterations, the last
# one training), and ``registration`` refusing without mlflow.  A whole-run
# trace holds every op of the run (431 MiB for 12 DV3-S gradient steps), so
# the run is kept this short
RECORDS_OVERRIDES = ["exp=dreamer_v3", "env=dummy", "env.capture_video=False", "run_name=chip_smoke_records",
                     "model_manager=dreamer_v3",
                     "algo.learning_starts=256", "algo.total_steps=256", "buffer.size=1024",
                     "checkpoint.every=100000", "checkpoint.save_last=False", "metric.logger=null", "seed=5",
                     "metric.profiler.enabled=True", "model_manager.disabled=False"]
RECORDS_REPORTS = ("journal", "health", "goodput", "memory", "trace", "dataset")
RECORDS_SEARCH = ["--exp=dreamer_v3_jepa_xs", "--env=dummy", "--n-trials=2", "--sampler=random", "--scheduler=asha",
                  "--rungs=1", "--fidelity-frac=1.0", "--full-steps=256", "--override=algo.learning_starts=256",
                  "--override=buffer.size=1024", "--override=metric.logger=null", "--override=env.capture_video=False"]
# a report tool's subprocess: the tool run as ``python -m``, then the modules
# it left loaded that a reader must not need
_REPORT_RUNNER = """
import runpy, sys
module = sys.argv.pop(1)
code = 0
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
except SystemExit as exit_:
    code = exit_.code or 0
leaked = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "sheeprl_tpu", "torch"})
print("[leaked] " + " ".join(leaked), file=sys.stderr)
sys.exit(code)
"""


# a resilience child's interpreter, started with the smoke (it also warms
# the bytecode cache): it binds the abstract socket named by its first
# argument, imports what a child imports (WARM_IMPORTS), creates the file
# its second argument names, then takes one request from
# _CHILD_HANDOFF, its argv, environment and directory, and runs
# ``python -m sheeprl_tpu_torch`` with them, its output to
# ``<record>.log``, the DreamerV3 loop's gradient steps (DreamerV3's step or
# P2E-DV2's exploration step) and player calls counted; when the run ends (an exception or SystemExit included, a
# SIGKILL not) it writes them, the exit code, its seconds, its imports'
# seconds and the LayerNorm-GRU kernel's launch counter to the JSON
# record, answers the exit code and exits with it
_CHILD_RUNNER = """
import json, os, socket, sys, time
t0 = time.monotonic()
server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
server.bind("\\0" + sys.argv[1])
server.listen(1)
""" + WARM_IMPORTS + """
import runpy, traceback
from sheeprl_tpu_torch.algos.dreamer_v3 import agent, dreamer_v3
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration
from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
from sheeprl_tpu_torch.parallel.dp import run_one
imports_s = round(time.monotonic() - t0, 1)
open(sys.argv[2], "w").close()  # ready
conn, _ = server.accept()
request = b""
while chunk := conn.recv(1 << 16):
    request += chunk
request = json.loads(request)
t0, started = time.monotonic(), time.time()
os.environ.clear()
os.environ.update(request["env"])
os.chdir(request["cwd"])
sys.argv = ["-c", *request["argv"]]
out_path = request["record"]
log = os.open(out_path + ".log", os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
os.dup2(log, 1)
os.dup2(log, 2)
record = {"gradient_steps": 0, "player_calls": {}, "exit_code": 0, "started": started, "imports_s": imports_s,
          "shards": 0}
get_actions = agent.PlayerDV3.get_actions

def counting(make_train_step):
    def counted_make(*args, **kwargs):
        # one step a shard (the loop builds one a replica): shard 0's counts
        # the gradient steps, each shard's body runs once a gradient step
        step = make_train_step(*args, **kwargs)
        first = record["shards"] == 0
        record["shards"] += 1

        def body(*a, **k):
            if first:
                record["gradient_steps"] += 1
            return (yield from step.body(*a, **k))

        def counted(*a, **k):
            return run_one(body(*a, **k))

        counted.body, counted.health_names, counted.metric_order = body, step.health_names, step.metric_order
        return counted

    return counted_make

def counted_actions(self, *args, **kwargs):
    width = str(self.num_envs)
    record["player_calls"][width] = record["player_calls"].get(width, 0) + 1
    return get_actions(self, *args, **kwargs)

dreamer_v3.make_train_step = counting(dreamer_v3.make_train_step)
p2e_dv2_exploration.make_train_step = counting(p2e_dv2_exploration.make_train_step)
agent.PlayerDV3.get_actions = counted_actions
try:
    runpy.run_module("sheeprl_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as exit_:
    record["exit_code"] = 0 if exit_.code is None else exit_.code if isinstance(exit_.code, int) else 1
except BaseException:
    traceback.print_exc()
    record["exit_code"] = 1
record["launches"] = fused_layernorm_gru.launches
record["seconds"] = round(time.monotonic() - t0, 1)
with open(out_path, "w") as fp:
    json.dump(record, fp)
sys.stdout.flush()
sys.stderr.flush()
conn.sendall(str(record["exit_code"]).encode())
conn.close()
# the run closed its journal, checkpoints and envs: the interpreter's
# teardown (about 2 s on the card) is skipped
os._exit(record["exit_code"])
"""
# the process the smoke's supervisor starts for a resilience child: it
# hands its argv (after the runner's name and the record's path), its
# environment (the supervisor's, with the restart count) and its directory
# to a waiting _CHILD_RUNNER and exits with the code the run exits with,
# or 1 if the runner died without answering
_CHILD_HANDOFF = """
import json, os, socket, sys
client = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
client.connect("\\0" + sys.argv[1])
client.sendall(json.dumps({"record": sys.argv[2], "argv": sys.argv[3:], "env": dict(os.environ),
                           "cwd": os.getcwd()}).encode())
client.shutdown(socket.SHUT_WR)
reply = b""
while chunk := client.recv(64):
    reply += chunk
sys.exit(int(reply) if reply else 1)
"""


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
    app = _serve_app(cfg, ckpt_path, device)
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


@contextlib.contextmanager
def _serve_logs():
    """``serve`` writes its journal, trace and request logs under
    ``logs/serve/`` of the working directory: build it here, under
    ``build/``."""
    root = ROOT / "build" / "chip_smoke" / "serve"
    root.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        yield
    finally:
        os.chdir(cwd)


def _serve_app(cfg, ckpt_path: str, device):
    from sheeprl_tpu_torch.serving.server import ServeApp

    ckpt_path = os.path.abspath(ckpt_path)
    with _serve_logs():
        return ServeApp(cfg, ckpt_path, device)


def _percentiles(values) -> tuple:
    ordered = sorted(values)
    if not ordered:
        return (float("nan"), float("nan"))
    return ordered[len(ordered) // 2], ordered[min(len(ordered) - 1, int(round(0.99 * (len(ordered) - 1))))]


def _wait_until(predicate, what: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"serve-ops: timed out after {timeout_s:g} s waiting for {what}")
        time.sleep(0.05)


def _append_journal(version_dir: Path, events) -> None:
    with open(version_dir / "journal.jsonl", "a", encoding="utf-8") as fp:
        for event in events:
            fp.write(json.dumps({"t": time.time(), **event}) + "\n")


def run_serve_ops(build_dir: Path, device_name: str = "cuda") -> dict:
    """Phase 4b: the serving tier's operations on the card.  Phase 4's
    DreamerV3-S run served as ``default`` next to a copy of it as ``canary``
    (each its own run directory, journal and watch directory) with reload
    (poll 0.2 s), the trace, the SLO with the slow-request drill and the
    request log on: concurrent HTTP sessions to both; a promotion of new
    weights in ``default`` (its greedy reply and session state equal to a
    plain-path recomputation from the new weights, ``canary`` on the old
    ones); the health gate rejecting a checkpoint while its training journal
    has an open anomaly and promoting it after ``anomaly_end``; a permanent
    rejection of another recurrent size; the kernel's launches equal to both
    models' policy steps; the slow request journaled with its phases;
    ``/metrics`` and ``trace_serve.json``; each model's request log verified;
    the p50 and p99 of each phase per model and of the dispatch time per
    dispatch."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.data.datasets import OfflineDataset, read_dataset_meta
    from sheeprl_tpu_torch.diagnostics.journal import read_journal
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.interop.flax_params import to_flax
    from sheeprl_tpu_torch.models import blocks
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference
    from sheeprl_tpu_torch.serving.loader import _actions_dim, agent_state_from_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state, save_state

    root = build_dir / "serve_ops"
    shutil.rmtree(root, ignore_errors=True)
    runs = {}
    for model in ("default", "canary"):
        runs[model] = root / model / "version_0"
        shutil.copytree(build_dir / "run", runs[model])
        _append_journal(runs[model], [{"event": "metrics", "step": 0, "metrics": {}}])
    ckpts = {m: runs[m] / "checkpoint" / "ckpt_0_0.ckpt" for m in runs}
    run_cfg = compose(SERVE_OPS_OVERRIDES + ["seed=5"])
    env = make_env(run_cfg, run_cfg.seed, 0)()
    obs_space, action_space = env.observation_space, env.action_space
    env.close()
    actions_dim, is_continuous, _ = _actions_dim(action_space)

    def weights(seed: int, *extra: str) -> dict:
        cfg = compose(SERVE_OPS_OVERRIDES + [f"seed={seed}", *extra])
        return to_flax(*build_agent(actions_dim, is_continuous, cfg, obs_space, None, device_name))

    newer, wider = weights(6), weights(7, "algo.world_model.recurrent_model.recurrent_state_size=256")

    cfg, ckpt_path, device = cli.serve_config([
        f"checkpoint_path={ckpts['default']}", "serving.port=0", "serving.max_delay_ms=5.0",
        "serving.sessions.capacity=64", "serving.reload.poll_s=0.2", "serving.trace.enabled=True",
        "serving.slo.target_ms=250.0", f"serving.slo.slow_trace_ms={SERVE_OPS_SLOW_MS}",
        f"diagnostics.serving.inject_slow_iter={SERVE_OPS_INJECT_ITER}", "serving.request_log.enabled=True",
        f"serving.request_log.rotate_rows={SERVE_OPS_ROTATE_ROWS}", f"serving.models={{canary: {ckpts['canary']}}}",
        f"fabric.accelerator={device_name}", "run_name=serve_ops",
    ])
    _dv3_s_widths(cfg)  # phase 4's archived config
    fused_layernorm_gru.launches = 0  # the main path starts here
    app = _serve_app(cfg, ckpt_path, device)
    replies, lock, recomputed = [], threading.Lock(), 0
    try:
        host, port = app.start()
        url = f"http://{host}:{port}"
        services = {m: app.registry.get(m).service for m in ("default", "canary")}
        shape = app.handle.obs_spec["rgb"][0]

        def post(model: str, payload: dict, rid=None):
            req = urllib.request.Request(url + "/act", data=json.dumps({**payload, "model": model}).encode(),
                                         headers={"Content-Type": "application/json",
                                                  **({"X-Request-Id": rid} if rid else {})})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, json.loads(resp.read()), resp.headers.get("X-Request-Id")
            except urllib.error.HTTPError as err:
                return err.code, json.loads(err.read() or b"{}"), err.headers.get("X-Request-Id")

        def traffic(tag: str) -> None:
            def client(model: str, i: int) -> None:
                rng = np.random.default_rng(["ab".index(tag), list(services).index(model), i])
                for j in range(SERVE_OPS_REQUESTS):
                    rgb = rng.integers(0, 256, size=shape, dtype=np.uint8)
                    rid = f"{tag}-{model}-{i}-{j}" if j % 2 == 0 else None
                    status, body, echoed = post(model, {"obs": {"rgb": rgb.tolist()}, "session": f"{tag}{model}{i}",
                                                        "greedy": (i + j) % 3 != 0}, rid)
                    with lock:
                        replies.append((model, status, body, rid, echoed))

            threads = [threading.Thread(target=client, args=(m, i)) for m in services
                       for i in range(SERVE_OPS_SESSIONS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            if any(t.is_alive() for t in threads):
                raise AssertionError("serve-ops: a client thread did not finish within 300 s")

        def probe(model: str, seed: int, ckpt: Path) -> dict:
            """One greedy request alone in its dispatch (a new session: 1 row
            + 7 padding rows), held against the plain path on weights loaded
            from ``ckpt``, and its session state against the kernel path."""
            nonlocal recomputed
            service, handle = services[model], app.registry.get(model).handle
            rgb = np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)
            sid = f"probe-{model}-{seed}"
            status, body, _ = post(model, {"obs": {"rgb": rgb.tolist()}, "session": sid, "greedy": True})
            if status != 200 or body["batch_rows"] != 1:
                raise AssertionError(f"serve-ops probe {model}: {status} {body}")
            served = {k: v[service.sessions._lru[sid]].clone() for k, v in service.sessions.slab.items()}
            width = body["batch_width"]
            fresh = handle.load_params(agent_state_from_checkpoint(load_state(str(ckpt))))
            obs = {"rgb": torch.zeros((width, *shape), dtype=torch.uint8, device=device)}
            obs["rgb"][0] = torch.from_numpy(rgb).to(device)
            state = {k: torch.zeros((width, *v.shape[1:]), dtype=v.dtype, device=device)
                     for k, v in service.sessions.slab.items()}
            is_first = torch.ones((width, 1), device=device)
            step = handle.make_state_step(True)
            outs = {}
            for path in ("kernel", "plain"):
                patch = (mock.patch.object(blocks, "fused_layernorm_gru", ln_gru_reference) if path == "plain"
                         else contextlib.nullcontext())
                with patch:
                    outs[path] = step(fresh, state, obs, is_first, torch.Generator(device=device).manual_seed(0))
            recomputed += 1  # the kernel path's one launch
            action = np.asarray(body["action"])
            if not np.array_equal(action.round(), outs["plain"][0][0].cpu().numpy().round()):
                raise AssertionError(f"serve-ops probe {model}: reply {action} != plain path {outs['plain'][0][0]}")
            err = max((served[k] - outs["plain"][1][k][0]).abs().max().item() for k in ("recurrent",))
            kerr = (outs["kernel"][1]["recurrent"] - outs["plain"][1]["recurrent"]).abs().max().item()
            if err > TOLERANCE["float32"] or kerr > TOLERANCE["float32"]:
                raise AssertionError(f"serve-ops probe {model}: session state vs plain {err}, kernel vs plain {kerr}")
            return {"body": body, "recurrent": served["recurrent"], "err": err, "kernel_err": kerr}

        traffic("a")
        # promotion: new weights from another seed into default's watch dir
        t0 = time.monotonic()
        save_state(str(runs["default"] / "checkpoint" / "ckpt_100_0.ckpt"), newer)
        _wait_until(lambda: services["default"].ckpt_step == 100, "the promotion of ckpt_100")
        promote_s = time.monotonic() - t0
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if health["models"]["default"]["ckpt_step"] != 100 or health["models"]["canary"]["ckpt_step"] != 0:
            raise AssertionError(f"serve-ops /healthz after the promotion: {health}")
        new_probe = probe("default", 11, runs["default"] / "checkpoint" / "ckpt_100_0.ckpt")
        old_probe = probe("canary", 11, ckpts["canary"])
        if (new_probe["body"]["params_version"], old_probe["body"]["params_version"]) != (1, 0):
            raise AssertionError(f"serve-ops: params versions {new_probe['body']} {old_probe['body']}")
        moved = (new_probe["recurrent"] - old_probe["recurrent"]).abs().max().item()
        if moved < 1e-3:
            raise AssertionError(f"serve-ops: default and canary served the same state after the promotion ({moved})")
        # the health gate: an open anomaly holds the checkpoint back, anomaly_end lets it through
        anomaly = {"kind": "entropy_collapse", "subject": "Loss/entropy_loss", "step": 150}
        _append_journal(runs["default"], [{"event": "anomaly", **anomaly}])
        save_state(str(runs["default"] / "checkpoint" / "ckpt_200_0.ckpt"), newer)
        _wait_until(lambda: services["default"].rejections_total == 1, "the health-gate rejection of ckpt_200")
        time.sleep(1.0)  # five polls: still held back, journaled once
        if services["default"].ckpt_step != 100 or services["default"].rejections_total != 1:
            raise AssertionError("serve-ops: ckpt_200 went through an open anomaly")
        _append_journal(runs["default"], [{"event": "anomaly_end", "kind": anomaly["kind"],
                                           "subject": anomaly["subject"]}])
        _wait_until(lambda: services["default"].ckpt_step == 200, "the promotion of ckpt_200 after anomaly_end")
        # another recurrent size: rejected for good, serving goes on
        save_state(str(runs["default"] / "checkpoint" / "ckpt_300_0.ckpt"), wider)
        _wait_until(lambda: services["default"].rejections_total == 2, "the shape rejection of ckpt_300")
        time.sleep(1.0)
        if services["default"].ckpt_step != 200 or services["default"].rejections_total != 2:
            raise AssertionError("serve-ops: ckpt_300 was retried or installed")
        traffic("b")
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            metrics = resp.read().decode()
        launches = fused_layernorm_gru.launches  # the main path ends here
        stats = {m: s.batcher.stats() for m, s in services.items()}
        steps = sum(stats[m]["dispatches_total"] + s.warmup_steps for m, s in services.items()) + recomputed
        if launches != steps or launches == 0:
            raise AssertionError(f"serve-ops: ln_gru launched {launches} times for {steps} policy steps "
                                 f"({ {m: (stats[m]['dispatches_total'], s.warmup_steps) for m, s in services.items()} }"
                                 f" + {recomputed} recomputations)")
        phases = {m: s.phase_stats.percentiles() for m, s in services.items()}
        warmup = {m: s.warmup_steps for m, s in services.items()}
    finally:
        app.close()

    bad = [(m, s, b) for m, s, b, _, _ in replies if s != 200]
    if bad or len(replies) != 2 * 2 * SERVE_OPS_SESSIONS * SERVE_OPS_REQUESTS:
        raise AssertionError(f"serve-ops: {len(bad)} of {len(replies)} replies were not 200; first {bad[:1]}")
    for model, _, body, rid, echoed in replies:
        if not echoed or echoed != body["request_id"] or (rid is not None and echoed != rid):
            raise AssertionError(f"serve-ops: X-Request-Id {rid!r} came back as {echoed!r} / {body['request_id']!r}")
        a = np.asarray(body["action"], dtype=np.float64)
        if a.shape != (int(sum(actions_dim)),) or not np.all(np.isfinite(a)) or round(float(a.sum())) != 1:
            raise AssertionError(f"serve-ops: bad action {body['action']}")
    for model in ("default", "canary"):
        if f'sheeprl_serve_latency_ms_bucket{{model="{model}",' not in metrics:
            raise AssertionError(f"serve-ops: /metrics has no latency histogram for {model}")

    events = read_journal(str(Path(app.log_dir) / "journal.jsonl"))
    decisions = [(e["event"], e.get("model"), e.get("step")) for e in events
                 if e["event"] in ("ckpt_promote", "ckpt_reject")]
    if decisions != [("ckpt_promote", "default", 100), ("ckpt_reject", "default", 200),
                     ("ckpt_promote", "default", 200), ("ckpt_reject", "default", 300)]:
        raise AssertionError(f"serve-ops: promotions and rejections {decisions}")
    rejects = [e for e in events if e["event"] == "ckpt_reject"]
    if rejects[0]["anomalies"][0]["kind"] != "entropy_collapse" or "shape" not in rejects[1]["reason"]:
        raise AssertionError(f"serve-ops: rejections {rejects}")
    slow = [e for e in events if e["event"] == "slow_request" and e["model"] == "default"
            and e["dispatch_id"] == SERVE_OPS_INJECT_ITER]
    faults = [e for e in events if e["event"] == "fault_injection"]
    if len(faults) != 1 or not slow or set(slow[0]["phases"]) != {"queue_ms", "batch_form_ms", "dispatch_ms",
                                                                  "scatter_ms"}:
        raise AssertionError(f"serve-ops: the slow-request drill journaled {faults} and {slow}")
    if slow[0]["phases"]["dispatch_ms"] < SERVE_OPS_SLOW_MS:
        raise AssertionError(f"serve-ops: the injected dispatch took {slow[0]['phases']['dispatch_ms']} ms")
    if events[0]["event"] != "serve_start" or events[-1]["event"] != "run_end" or events[-1]["status"] != "completed":
        raise AssertionError(f"serve-ops: journal from {events[0]['event']} to {events[-1]}")

    with open(Path(app.log_dir) / "trace_serve.json") as fp:
        trace = json.load(fp)
    spans = {}
    for e in trace:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e["dur"] / 1000.0)
    missing = {"serve-queue", "serve-batch-form", "serve-dispatch", "serve-scatter", "serve-serialize",
               "serve-session-checkout", "serve-request-log"} - set(spans)
    if missing:
        raise AssertionError(f"serve-ops: trace_serve.json has no {sorted(missing)} span")

    answered = {m: sum(1 for mm, s, *_ in replies if mm == m and s == 200) + 1 for m in ("default", "canary")}
    logged = {}
    for model, rows in answered.items():
        dataset_dir = Path(app.log_dir) / "requests" / model
        ds = OfflineDataset(str(dataset_dir))
        meta = (read_dataset_meta(str(dataset_dir)) or {}).get("meta") or {}
        if ds.skipped or ds.total_rows != rows or meta.get("algo") != "dreamer_v3":
            raise AssertionError(f"serve-ops: {model}'s request log holds {ds.total_rows} rows of {rows} "
                                 f"({len(ds.skipped)} shards skipped, algo {meta.get('algo')})")
        logged[model] = {"rows": ds.total_rows, "shards": ds.n_shards}

    dispatch = [d for d in spans["serve-dispatch"] if d < SERVE_OPS_SLOW_MS]  # the injected sleep left out
    return {
        "requests": len(replies) + 2,
        "launches": launches,
        "warmup_steps": warmup,
        "dispatches": {m: stats[m]["dispatches_total"] for m in stats},
        "width_hist": {m: stats[m]["width_hist"] for m in stats},
        "phases": phases,
        "dispatch_ms_per_dispatch": _percentiles(dispatch),
        "dispatches_traced": len(spans["serve-dispatch"]),
        "promote_s": promote_s,
        "probe_err": {"default": new_probe["err"], "canary": old_probe["err"]},
        "probe_kernel_err": max(new_probe["kernel_err"], old_probe["kernel_err"]),
        "moved": moved,
        "slow_request_ms": slow[0]["total_ms"],
        "slo_events": [e["event"] for e in events if e["event"].startswith("slo_")],
        "logged": logged,
        "log_dir": app.log_dir,
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
    """Every draw of one gradient step, pre-drawn on the card (Gumbel noise
    from ``gen``)."""
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


class held_samples:
    """The plain path of a kernel-vs-plain step held to the kernel path's
    samples.  Inside the ``with`` block the DreamerV3 samplers
    (``compute_stochastic_state``, ``Actor.act``: every Dreamer family's
    and their P2E and JEPA variants') record each call's sampled classes
    while the kernel runs (``blocks.fused_layernorm_gru`` is the kernel's
    wrapper) and, on the plain path, count the rows whose class differs
    from the kernel path's call of the same index (``split`` of
    ``samples``).  With ``force`` each split one-hot becomes the kernel
    path's (``+ one_hot(kernel) - one_hot(plain)``: the straight-through
    gradient is the plain path's own).  A Gumbel draw at a near tie of two
    classes splits when the paths' logits differ by their rounding (on the
    card 6 of 1.7e7 draws in 30 fp32 DV3-S steps, each at a margin of at most
    4.8e-07; unheld, the split row's trajectory diverges and the step's
    metrics moved by up to 3.8e-03, ``chip_gumbel_split.py``, PERF.md §6).
    In ``bf16-mixed`` the paths' logits differ by bf16 rounding and splits
    are many (845 of 579,584 draws in the chunked DV3-S step, at margins up
    to 0.047).  ``margin`` is the largest ``top1 - top2`` of ``logits +
    noise`` among the split state samples."""

    def __init__(self, force: bool = True):
        self.force = force
        self.kernel: list = []
        self.calls = 0
        self.samples = 0
        self.split = {"state": 0, "action": 0}
        self.split_calls: list = []
        self.margin = 0.0

    def tap(self, site: str, out, idx, depth: int, scores=None):
        import torch
        import torch.nn.functional as F

        from sheeprl_tpu_torch.models import blocks
        from sheeprl_tpu_torch.ops.ln_gru import ln_gru_reference

        if blocks.fused_layernorm_gru is not ln_gru_reference:
            self.kernel.append(idx)
            return out
        want = self.kernel[self.calls]
        self.calls += 1
        differ = want != idx
        self.samples += differ.numel()
        n = int(differ.sum())
        if not n:
            return out
        self.split[site] += n
        self.split_calls.append(self.calls - 1)
        if scores is not None:
            top2 = torch.topk(scores[differ], 2, dim=-1).values
            self.margin = max(self.margin, float((top2[:, 0] - top2[:, 1]).max()))
        if self.force:
            out = out + (F.one_hot(want, depth).to(out.dtype) - F.one_hot(idx, depth).to(out.dtype)).reshape(out.shape)
        return out

    def __enter__(self):
        import torch

        from sheeprl_tpu_torch.algos.dreamer_v3 import agent as agent_mod

        css, act, tap = agent_mod.compute_stochastic_state, agent_mod.Actor.act, self.tap

        def compute_stochastic_state(logits, discrete, generator=None, sample=True, noise=None):
            out = css(logits, discrete, generator, sample, noise)
            if not sample:
                return out
            rows = out.detach().reshape(tuple(out.shape[:-1]) + (-1, discrete))
            scores = None if noise is None else (logits.detach().reshape(rows.shape)
                                                 + noise.reshape(rows.shape).to(logits.dtype))
            return tap("state", out, rows.argmax(-1), discrete, scores)

        def actor_act(actor, state, generator=None, greedy=False, noise=None, mask=None):
            out = act(actor, state, generator, greedy, noise, mask)
            if greedy or actor.is_continuous:
                return out
            heads = torch.split(out, list(actor.actions_dim), dim=-1)
            return torch.cat([tap("action", h, h.detach().argmax(-1), h.shape[-1]) for h in heads], dim=-1)

        self._patches = [mock.patch.object(agent_mod, "compute_stochastic_state", compute_stochastic_state),
                         mock.patch.object(agent_mod.Actor, "act", actor_act)]
        for patch in self._patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self._patches:
            patch.stop()
        return False


def _kernel_vs_plain_step(cfg, agent_state, spaces_, batch, noise, device: str = "cuda", keep=None, held=None):
    """One gradient step from one state, batch and noise, through the kernel
    and through the plain path, with the agent and step of ``cfg``'s
    algorithm: ``[(metrics, {optimizer: Adam first moments}, params,
    kept)]`` for each; ``kept`` is the agent and copies of the tensors
    ``keep(agent)`` names, taken before the step (None without ``keep``).
    The plain path is held to the kernel path's samples (``held``, a
    :class:`held_samples`, by default a new one), and the samples it split
    are printed."""
    import importlib

    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers
    from sheeprl_tpu_torch.models import blocks
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference
    from sheeprl_tpu_torch.utils.registry import find_algorithm

    family = importlib.import_module(find_algorithm(cfg.algo.name)["module"])
    actions_dim, is_continuous, obs_space = spaces_
    held = held_samples() if held is None else held
    results = []
    for plain in (False, True):
        agent = family.build_agent(actions_dim, is_continuous, cfg, obs_space, agent_state, device)
        optimizers = make_optimizers(cfg, agent)
        step = family.make_train_step(agent, optimizers, cfg, is_continuous)
        kept = None if keep is None else (agent, [t.detach().clone() for t in keep(agent)])
        with held, mock.patch.object(blocks, "fused_layernorm_gru", ln_gru_reference if plain else fused_layernorm_gru):
            _, metrics = step(agent.initial_moments(device), batch, 0.02, None, noise)
        torch.cuda.synchronize()
        grads = {name: torch.cat([opt.state[p]["exp_avg"].reshape(-1) for p in agent.parameters_of(name)])
                 for name, opt in optimizers.items()}
        params = torch.cat([p.detach().reshape(-1) for name in optimizers for p in agent.parameters_of(name)])
        results.append((metrics.cpu().numpy(), grads, params, kept if not plain else None))
        del step, optimizers
    print(f"[samples] {cfg.algo.name} kernel vs plain step: the plain path split {held.split} of {held.samples} "
          f"sampled one-hots from the kernel path's (largest margin {held.margin:.3g})"
          f"{', held to them' if held.force else ''}", flush=True)
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
    # one metric row a training iteration, as the JAX loop drains them
    if out["gradient_steps"] < MIN_GRADIENT_STEPS or rows.shape != (out["train_iterations"], len(METRIC_ORDER)):
        raise AssertionError(f"{out['gradient_steps']} gradient steps in {out['train_iterations']} training "
                             f"iterations, metric rows {rows.shape}")
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
        "train_iterations": out["train_iterations"],
        "metric_rows": len(rows),
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


def _report(tool: str, *args: str, expect: int = 0) -> str:
    """``python -m sheeprl_tpu_torch.tools.<tool> args`` in a subprocess:
    its stdout; it must exit ``expect`` and leave no JAX, ``sheeprl_tpu`` or
    torch module loaded."""
    proc = subprocess.run([sys.executable, "-c", _REPORT_RUNNER, f"sheeprl_tpu_torch.tools.{tool}", *args],
                          cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    leaked = [line for line in proc.stderr.splitlines() if line.startswith("[leaked]")]
    if proc.returncode != expect or leaked != ["[leaked] "]:
        raise AssertionError(f"{tool} {' '.join(args)} exited {proc.returncode}, loaded {leaked}: "
                             f"{proc.stderr[-2000:]}")
    return proc.stdout


def run_records(build_dir: Path, train: dict, drill: dict, ops: dict, offline_export: Path, timers: dict,
                device_name: str = "cuda") -> dict:
    """Phase 18: a run's records and registries.  (a) ``run`` at
    DreamerV3-S with ``metric.profiler.enabled=True`` and
    ``model_manager.disabled=False``: without mlflow the run warns and
    disables the registry as the JAX ``check_configs`` does, and trains; its
    Chrome trace parses and holds exactly as many LayerNorm-GRU kernel events
    as the launch counter counted; each gradient step's stream time between
    CUDA events (the profiler's overhead beside phase 17's unprofiled step).
    (b) the six report tools, each ``python -m sheeprl_tpu_torch.tools.*``
    with no JAX, ``sheeprl_tpu`` or torch loaded, on phase 5's run dir (the
    journal, health, goodput and memory reports), phase 9's ``trace.json``
    and phase 4b's ``trace_serve.json`` (trace), phase 8b's export
    (dataset) and phase 4b's serving journal (journal): the journal report's
    last step is the run's last logged step and its CSV one row a
    ``metrics`` event.  (c) ``python -m sheeprl_tpu_torch.tools.search`` (as
    its ``main``, in this process, so that the launch counter is read
    around each trial) over JEPA-XS, 2 random trials under ASHA: both
    ``COMPLETE`` with finite returns, no ``error.txt``, the kernel launched
    in each trial as its counters predict, the study's four files written.
    (d) ``registration`` of phase 5's last checkpoint raises
    ``ModuleNotFoundError`` without mlflow."""
    import csv
    import math
    import warnings

    import torch
    import yaml

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.diagnostics.journal import read_journal
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.parallel.dp import run_one
    from sheeprl_tpu_torch.tools import search

    root = (build_dir / "records").resolve()
    shutil.rmtree(root, ignore_errors=True)
    trace_dir = root / "profiler_trace"
    out: dict = {}

    # (a) the profiled run
    t0 = time.monotonic()
    overrides = RECORDS_OVERRIDES + [f"root_dir={root / 'train'}", f"metric.profiler.trace_dir={trace_dir}",
                                     f"fabric.accelerator={device_name}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg)
    stream_ms = []
    make_train_step = dv3.make_train_step

    def timed_make_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def body(*a, **k):
            if device_name == "cpu":
                return (yield from step.body(*a, **k))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            result = yield from step.body(*a, **k)  # one shard: no collective waits
            end.record()
            torch.cuda.synchronize()
            stream_ms.append(start.elapsed_time(end))
            return result

        def timed(*a, **k):
            return run_one(body(*a, **k))

        timed.__dict__.update(step.__dict__)
        timed.body = body
        return timed

    with warnings.catch_warnings(record=True) as caught, mock.patch.object(dv3, "make_train_step",
                                                                           timed_make_train_step):
        warnings.simplefilter("always")
        fused_layernorm_gru.launches = 0  # the main path starts here
        run = cli.run(overrides)
        if device_name != "cpu":
            torch.cuda.synchronize()
        launches = fused_layernorm_gru.launches  # the main path ends here
    gate = [str(w.message) for w in caught if issubclass(w.category, UserWarning)
            and "MLFlow is not installed; setting model_manager.disabled=True" in str(w.message)]
    archived = yaml.safe_load((Path(run["log_dir"]) / "config.yaml").read_text())
    if len(gate) != 1 or archived["model_manager"]["disabled"] is not True:
        raise AssertionError(f"records: the model-manager gate warned {gate}, archived model_manager "
                             f"{archived['model_manager']}")
    predicted, per_step = _launches(cfg, run)
    if run["gradient_steps"] < 4 or launches != predicted or not all(map(math.isfinite, run["metric_rows"].ravel())):
        raise AssertionError(f"records: {run['gradient_steps']} gradient steps, {launches} ln_gru launches "
                             f"(predicted {predicted})")
    (trace_path,) = sorted(trace_dir.glob("*.pt.trace.json"))
    t_parse = time.monotonic()
    with open(trace_path) as fp:
        events = json.load(fp)["traceEvents"]
    parse_s = time.monotonic() - t_parse
    kernels = [e for e in events if e.get("cat") == "kernel"]
    traced = sum(1 for e in kernels if "ln_gru_kernel" in e.get("name", ""))
    if device_name != "cpu" and traced != launches:
        raise AssertionError(f"records: the trace holds {traced} ln_gru_kernel events, the counter {launches}")
    out.update(profiled={
        "gradient_steps": run["gradient_steps"], "player_steps": run["player_steps"],
        "test_steps": run["test_steps"], "ln_gru_launches": launches, "predicted": predicted,
        "launches_per_gradient_step": per_step, "trace_kernel_events": len(kernels), "trace_ln_gru_events": traced,
        "trace_events": len(events), "trace_mb": trace_path.stat().st_size / 2**20, "trace_parse_s": parse_s,
        "step_ms": statistics.median(stream_ms) if stream_ms else None, "stream_ms": stream_ms,
        "unprofiled_step_ms": {k: timers[k]["step_ms"] for k in ("fp32_off_0", "fp32_diagnostics_1") if k in timers},
        "seconds": time.monotonic() - t0,
    })
    del events, kernels

    # (b) the reports, on the earlier phases' runs
    t0 = time.monotonic()
    run_dir = Path(train["checkpoint"]).parent.parent
    summary = json.loads(_report("journal_report", str(run_dir), "--json"))
    history = root / "journal.csv"
    _report("journal_report", str(run_dir), "--csv", str(history))
    journal = read_journal(str(run_dir / "journal.jsonl"))
    metrics_events = [e for e in journal if e.get("event") == "metrics"]
    with open(history, newline="") as fp:
        csv_rows = list(csv.DictReader(fp))
    if summary.get("last_step") != train["policy_steps"] or len(csv_rows) != len(metrics_events):
        raise AssertionError(f"journal_report: last step {summary.get('last_step')} for a run that logged last at "
                             f"{train['policy_steps']}; {len(csv_rows)} CSV rows for {len(metrics_events)} metrics "
                             f"events")
    reports = {
        "journal": _report("journal_report", str(run_dir)),
        "health": _report("health_report", str(run_dir)),
        "goodput": _report("goodput_report", str(run_dir)),
        "memory": _report("memory_report", str(run_dir)),
        "trace": _report("trace_report", str(Path(drill["run_dir"]) / "trace.json")),
        "trace_serve": _report("trace_report", str(Path(ops["log_dir"]) / "trace_serve.json")),
        "dataset": _report("dataset_report", str(offline_export)),
        "serve_journal": _report("journal_report", str(ops["log_dir"])),
    }
    empty = [name for name, text in reports.items() if not text.strip()]
    if empty:
        raise AssertionError(f"records: empty reports {empty}")
    out.update(reports={k: len(v.splitlines()) for k, v in reports.items()}, journal_last_step=summary["last_step"],
               csv_rows=len(csv_rows), reports_s=time.monotonic() - t0)

    # (c) the search: trials in this process, through the kernel
    t0 = time.monotonic()
    trials = []
    run_fn = cli.run

    def counted_run(args):
        trial_cfg = compose(list(args))
        fused_layernorm_gru.launches = 0  # a trial's main path starts here
        result = run_fn(args)
        if device_name != "cpu":
            torch.cuda.synchronize()
        trial_launches = fused_layernorm_gru.launches  # and ends here
        trials.append({"launches": trial_launches, "predicted": _launches(trial_cfg, result)[0],
                       "gradient_steps": result["gradient_steps"], "test_reward": result["test_reward"],
                       "widths": (trial_cfg.algo.world_model.recurrent_model.recurrent_state_size,
                                  trial_cfg.algo.per_rank_batch_size,
                                  trial_cfg.algo.per_rank_batch_size * trial_cfg.algo.per_rank_sequence_length)})
        return result

    study = root / "search"
    with mock.patch.object(cli, "run", counted_run):
        search.main(RECORDS_SEARCH + [f"--output-dir={study}", f"--override=fabric.accelerator={device_name}"])
    with open(study / "results.csv", newline="") as fp:
        results = list(csv.DictReader(fp))
    errors = sorted(str(p) for p in study.rglob("error.txt"))
    missing = [f for f in ("results.csv", "topk.json", "best_config.yaml", "SUMMARY.md") if not (study / f).exists()]
    if (len(results) != 2 or any(r["state"] != "COMPLETE" or not math.isfinite(float(r["eval_return"]))
                                 for r in results) or errors or missing or len(trials) != 2
            or any(t["launches"] == 0 or t["launches"] != t["predicted"] or t["gradient_steps"] == 0
                   for t in trials)):
        raise AssertionError(f"records: search results {results}, errors {errors}, missing {missing}, trials "
                             f"{trials}")
    out.update(search={"trials": trials, "results": [{k: r[k] for k in ("trial_id", "state", "eval_return")}
                                                     for r in results]}, search_s=time.monotonic() - t0)

    # (d) registration refuses without mlflow
    proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", "registration",
                           f"checkpoint_path={train['checkpoint']}"], cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300)
    if proc.returncode == 0 or "ModuleNotFoundError: mlflow is not installed" not in proc.stderr:
        raise AssertionError(f"registration exited {proc.returncode}: {proc.stderr[-2000:]}")
    out["registration"] = proc.stderr.strip().splitlines()[-1]
    shutil.rmtree(root / "train", ignore_errors=True)
    shutil.rmtree(trace_dir, ignore_errors=True)
    return out


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

    overrides = chunked["overrides"] + [f"checkpoint.resume_from={chunked['run_dir']}", "checkpoint.save_last=True",
                                        "diagnostics.telemetry.mfu.cost_analysis=False"]
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
    from sheeprl_tpu_torch.parallel.dp import run_one
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

        def body(moments, batch, tau, generator=None, noise=None):
            if not poisoned:
                return (yield from step.body(moments, batch, tau, generator, noise))
            iter_num = poisoned.pop()
            before = _state_of(agent, optimizers, moments)
            moments, metrics = yield from step.body(moments, batch, tau, generator, noise)
            after = _state_of(agent, optimizers, moments)
            drills.append({"iter": iter_num, "tensors": len(before),
                           "finite_metrics": bool(torch.isfinite(metrics[:len(dv3.METRIC_ORDER)]).any()),
                           "changed": [k for k in before if not torch.equal(before[k], after[k])]})
            return moments, metrics

        def checked(*a, **k):
            return run_one(body(*a, **k))

        checked.body, checked.health_names, checked.metric_order = body, step.health_names, step.metric_order
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
        "run_dir": str(run_dir),
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
        overrides += ["algo.run_test=False", "checkpoint.every=0", *PPO_COMPARE_DEPTH]
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
        "metric.logger=null", f"checkpoint.resume_from={first}", "algo.run_test=False", "diagnostics.telemetry.mfu.cost_analysis=False"]
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

    cfg, ckpt_path, device = cli.serve_config(
        [f"checkpoint_path={ppo['checkpoints'][-1]}", "serving.port=0", "serving.batch_buckets=[8,16,32,64]",
         "serving.max_delay_ms=5.0", f"fabric.accelerator={device_name}"])
    app = _serve_app(cfg, ckpt_path, device)
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
    overrides = jepa["overrides"] + [f"checkpoint.resume_from={jepa['mid_checkpoint']}", "checkpoint.every=100000",
                                     "diagnostics.telemetry.mfu.cost_analysis=False"]
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

    fused_layernorm_gru.launches = 0  # the main path starts here
    reward = cli.evaluation([f"checkpoint_path={jepa['checkpoint']}"])
    torch.cuda.synchronize()
    launches = fused_layernorm_gru.launches  # the main path ends here
    if not math.isfinite(reward) or launches < 1:
        raise AssertionError(f"jepa eval: test reward {reward}, {launches} ln_gru launches")
    cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={jepa['checkpoint']}", "serving.port=0",
                                               f"fabric.accelerator={device_name}"])
    try:
        app = _serve_app(cfg, ckpt_path, device)
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
    overrides = p2e["overrides"] + [f"checkpoint.resume_from={p2e['mid_checkpoint']}", "checkpoint.every=100000",
                                    "diagnostics.telemetry.mfu.cost_analysis=False"]
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
                                                         f"checkpoint.exploration_ckpt_path={p2e['checkpoint']}",
                                                         "diagnostics.telemetry.mfu.cost_analysis=False"]
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
            app = _serve_app(cfg, ckpt_path, device)
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
        resumed = cli.run(overrides + [f"checkpoint.resume_from={first}", "algo.run_test=False", "diagnostics.telemetry.mfu.cost_analysis=False"])
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
    app = _serve_app(cfg, ckpt_path, device)
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


# ---------------------------------------------------------------------------
# MineDojo's actor, and the optimizers written out from optax
# ---------------------------------------------------------------------------


class MinedojoShapedEnv:
    """A MineDojo-shaped env on the port's spaces, built in this process:
    ``MultiDiscrete([19, CRAFT, ITEMS])`` actions (the 19 action types, a
    craft argument, an item argument, at MineDojo's vocabularies:
    ``CRAFT`` is ``len(minedojo.sim.ALL_CRAFT_SMELT_ITEMS)``, the craft
    argument of MineDojo's own action space, ``ITEMS`` ``len(ALL_ITEMS)``;
    MineDojo is not installed, so both are written here), the dummy env's
    ``rgb`` and ``state``
    and the four ``mask_*`` observations of ``envs/minedojo.py``, drawn anew
    each step from a seeded generator with at least one category allowed in
    each, and the craft, equip/place and destroy types allowed often enough
    that the argument heads' masks are exercised.  Episodes are 64 steps."""

    CRAFT, ITEMS, STEPS = 244, 634, 64

    def __init__(self, seed: int = 0):
        import numpy as np

        from sheeprl_tpu_torch.envs import spaces

        self._np = np
        self._rng = np.random.default_rng(seed)
        self.action_space = spaces.MultiDiscrete([19, self.CRAFT, self.ITEMS])
        self.observation_space = spaces.Dict({
            "rgb": spaces.Box(0, 255, (3, 64, 64), np.uint8),
            "state": spaces.Box(-20, 20, (10,), np.float32),
            "mask_action_type": spaces.Box(0, 1, (19,), bool),
            "mask_craft_smelt": spaces.Box(0, 1, (self.CRAFT,), bool),
            "mask_equip_place": spaces.Box(0, 1, (self.ITEMS,), bool),
            "mask_destroy": spaces.Box(0, 1, (self.ITEMS,), bool),
        })
        self.reward_range = (-np.inf, np.inf)
        self._t = 0

    def _mask(self, n: int, p: float):
        mask = self._rng.random(n) < p
        mask[self._rng.integers(0, n)] = True
        return mask

    def _obs(self):
        np = self._np
        types = self._mask(19, 0.5)
        types[15:19] |= self._rng.random(4) < 0.5
        return {"rgb": np.full((3, 64, 64), self._t % 256, np.uint8),
                "state": np.full((10,), self._t % 20, np.float32), "mask_action_type": types,
                "mask_craft_smelt": self._mask(self.CRAFT, 0.3), "mask_equip_place": self._mask(self.ITEMS, 0.3),
                "mask_destroy": self._mask(self.ITEMS, 0.3)}

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._rng = self._np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        return self._obs(), float(self._t % 3 == 0), self._t >= self.STEPS, False, {}

    def render(self):
        return self._np.zeros((64, 64, 3), self._np.uint8)

    def close(self):
        pass


def masks_allow(mask: dict, actions, craft: int) -> "list":
    """Per row of ``actions`` (the player's one-hot ``[19, craft, items]``
    blocks), whether ``mask`` (its ``mask_*`` observations) allows it:
    MinedojoActor's hierarchy, with ``envs/minedojo.py``'s action types
    (15 craft, 16 equip, 17 place, 18 destroy)."""
    import torch

    kind = actions[:, :19].argmax(-1)
    arg1 = actions[:, 19:19 + craft].argmax(-1)
    arg2 = actions[:, 19 + craft:].argmax(-1)
    rows = torch.arange(actions.shape[0], device=actions.device)

    def allowed(key, idx):
        return mask[key][rows, idx].bool()

    ok = allowed("mask_action_type", kind)
    ok &= (kind != 15) | allowed("mask_craft_smelt", arg1)
    ok &= ((kind != 16) & (kind != 17)) | allowed("mask_equip_place", arg2)
    ok &= (kind != 18) | allowed("mask_destroy", arg2)
    return ok.tolist()


class minedojo_shaped_env:
    """``env=dummy env.id=minedojo_dummy`` builds :class:`MinedojoShapedEnv`
    in this process for the ``with`` block (the runs use
    ``env.executor=sync``: a spawned env worker would not see the patch),
    and every ``PlayerDV3.get_actions`` call that gets masks is recorded:
    ``checked`` holds whether each action it returned is allowed."""

    def __enter__(self):
        from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3
        from sheeprl_tpu_torch.envs import env as env_mod

        self.checked: list = []
        self._orig_env, self._orig_get = env_mod.get_dummy_env, PlayerDV3.get_actions
        orig_env, orig_get, checked = self._orig_env, self._orig_get, self.checked

        def get_dummy_env(id: str, sleep_ms: float = 0.0):
            return MinedojoShapedEnv() if id == "minedojo_dummy" else orig_env(id, sleep_ms)

        def get_actions(player, obs, generator=None, greedy=False, noise=None, mask=None):
            actions = orig_get(player, obs, generator, greedy, noise, mask)
            if mask is not None:
                checked.extend(masks_allow(mask, actions, MinedojoShapedEnv.CRAFT))
            return actions

        env_mod.get_dummy_env, PlayerDV3.get_actions = get_dummy_env, get_actions
        return self

    def __exit__(self, *exc):
        from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3
        from sheeprl_tpu_torch.envs import env as env_mod

        env_mod.get_dummy_env, PlayerDV3.get_actions = self._orig_env, self._orig_get
        return False


def _kill_children() -> None:
    """SIGKILL this process's child processes (a phase's CLI children left
    running when its deadline ends the script), found by their parent pid."""
    import signal

    me = os.getpid()
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            if int(fields[1]) == me:
                os.kill(int(stat.parent.name), signal.SIGKILL)
        except (OSError, IndexError, ValueError):
            continue


@contextlib.contextmanager
def deadline(seconds: float, phase: str, context=None):
    """The ``with`` block gets ``seconds``: past them the script prints that
    ``phase`` hung (and what ``context()`` says of it) and exits 1 at once,
    instead of running into the call's time limit (its earlier phases'
    workers are stopped by then)."""
    def expire():
        print(f"chip_smoke: phase {phase} did not finish within its {seconds:.0f} s deadline", file=sys.stderr,
              flush=True)
        if context is not None:
            print(context(), file=sys.stderr, flush=True)
        _kill_children()
        os._exit(1)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def run_minedojo(build_dir: Path, device_name: str = "cuda") -> dict:
    """DreamerV3-S with ``algo.actor.cls=...MinedojoActor`` on the
    MineDojo-shaped env (``minedojo_shaped_env``): ``run`` takes a few
    gradient steps through the kernel; its launches are 79 a gradient step
    plus one a player step plus the test steps; every action the player
    took is allowed by its step's masks; then one train step through the
    kernel and through the plain path from one state, batch and noise,
    within the ``STEP_*`` tolerances."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import MinedojoActor, make_actor
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.serving.loader import _actions_dim, agent_state_from_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = MINEDOJO_OVERRIDES + [f"root_dir={(build_dir / 'minedojo').resolve()}",
                                      f"fabric.accelerator={device_name}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg)
    with minedojo_shaped_env() as recorder:
        env = make_env(cfg, cfg.seed, 0)()
        obs_space, action_space = env.observation_space, env.action_space
        env.close()
        actions_dim, is_continuous, _ = _actions_dim(action_space)
        if not isinstance(make_actor(actions_dim, is_continuous, cfg), MinedojoActor):
            raise AssertionError("algo.actor.cls did not build a MinedojoActor")
        fused_layernorm_gru.launches = 0  # the main path starts here
        out = cli.run(overrides)
        torch.cuda.synchronize()
        launches = fused_layernorm_gru.launches  # the main path ends here
    rows = out["metric_rows"]
    if out["gradient_steps"] < 1 or not np.isfinite(rows).all():
        raise AssertionError(f"minedojo: {out['gradient_steps']} gradient steps, metrics {rows}")
    predicted, per_step = _launches(cfg, out)
    if launches != predicted or per_step != MINEDOJO_LAUNCHES_PER_STEP:
        raise AssertionError(f"minedojo: ln_gru launched {launches} times, the run predicts {predicted} "
                             f"({per_step} a gradient step, {out['player_steps']} player steps, "
                             f"{out['test_steps']} test steps)")
    checked = recorder.checked
    if len(checked) != out["player_steps"] * cfg.env.num_envs + out["test_steps"] or not all(checked):
        raise AssertionError(f"minedojo: {checked.count(False)} of {len(checked)} masked actions disallowed "
                             f"({out['player_steps']} player steps x {cfg.env.num_envs} envs, "
                             f"{out['test_steps']} test steps)")

    gen = torch.Generator(device=device_name).manual_seed(13)
    batch = synthetic_batch(cfg, actions_dim, gen, device_name)
    T, B = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size
    for key in cfg.algo.mlp_keys.encoder:
        shape = obs_space[key].shape
        batch[key] = (torch.rand((T, B, *shape), device=device_name, generator=gen) < 0.5).float() \
            if key.startswith("mask") else torch.randn((T, B, *shape), device=device_name, generator=gen)
    noise = _train_noise(cfg, actions_dim, gen, device_name)
    state = load_state(out["checkpoints"][-1])
    (m_kernel, g_kernel, p_kernel, _), (m_plain, g_plain, p_plain, _) = _kernel_vs_plain_step(
        cfg, agent_state_from_checkpoint(state), (actions_dim, is_continuous, obs_space), batch, noise, device_name)
    metric_err = float(np.max(np.abs(m_kernel - m_plain) / np.maximum(np.abs(m_plain), 1e-3)))
    grad_err = max(((g_kernel[k] - g_plain[k]).abs().max() / g_plain[k].abs().max()).item() for k in g_plain)
    outliers = ((p_kernel - p_plain).abs() > STEP_PARAM_ATOL).float().mean().item()
    if (not np.isfinite(m_kernel).all() or metric_err > STEP_METRIC_RTOL or grad_err > STEP_GRAD_RTOL
            or outliers > STEP_PARAM_OUTLIERS):
        raise AssertionError(f"minedojo kernel vs plain step: metrics {metric_err}, gradients {grad_err}, "
                             f"param outliers {outliers}")
    return {"gradient_steps": out["gradient_steps"], "player_steps": out["player_steps"],
            "test_steps": out["test_steps"], "ln_gru_launches": launches, "launches_per_gradient_step": per_step,
            "masked_actions_checked": len(checked), "step_metric_rel_err": metric_err,
            "step_grad_rel_err": grad_err, "step_param_outliers": outliers}


def run_optimizers_card_vs_cpu(devices=("cuda", "cpu")) -> dict:
    """Each optimizer variant written out from optax
    (``OPTIMIZER_VARIANTS``): one update of a small parameter tree (a
    weight and a bias) from the same values and gradients on the card and
    on the CPU, the parameters and every state tensor within
    ``OPTIMIZER_CARD_CPU_RTOL``."""
    import torch

    from sheeprl_tpu_torch.utils import optim

    card, cpu = devices
    gen = torch.Generator().manual_seed(17)
    values = [torch.randn(64, 32, generator=gen), torch.randn(32, generator=gen)]
    grads = [torch.randn(64, 32, generator=gen), torch.randn(32, generator=gen)]
    errs = {}
    for name, (factory, kwargs) in OPTIMIZER_VARIANTS.items():
        results = []
        for device in (card, cpu):
            params = [torch.nn.Parameter(v.to(device)) for v in values]
            opt = getattr(optim, factory)(0.01, **kwargs)(params)
            for p, g in zip(params, grads):
                p.grad = g.to(device)
            opt.step()
            if any(p.device.type != torch.device(device).type for p in params):
                raise AssertionError(f"{name}: the update on {device} left it")
            results.append([p.detach().cpu() for p in params]
                           + [t.detach().cpu().float() for p in params for t in opt.state[p].values()])
        err = max(((a - b).abs() / b.abs().clamp_min(1e-6)).max().item() for a, b in zip(*results))
        finite = all(bool(torch.isfinite(t).all()) for t in results[0] + results[1])
        if not finite or not err <= OPTIMIZER_CARD_CPU_RTOL or type(opt).__name__ not in ("SGD", "RMSprop",
                                                                                         "OptaxAdam"):
            raise AssertionError(f"optimizer {name} ({type(opt).__name__}): card vs CPU relative error {err} "
                                 f"(tol {OPTIMIZER_CARD_CPU_RTOL})")
        errs[name] = err
    return errs


def _child_launches(cfg, record: dict, imaginations: int = 1) -> int:
    """The LayerNorm-GRU launches a child's counts predict: a fp32 gradient
    step's (79 at DreamerV3-S; 80 at P2E-DV2, whose step imagines twice),
    one call a player step at the envs' width."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import rssm_scan_spec

    if rssm_scan_spec(cfg)[0] != 1:
        raise AssertionError("the children run the fp32 scan of rssm_chunks=1")
    hidden = cfg.algo.world_model.recurrent_model.recurrent_state_size
    joint_dim = hidden + cfg.algo.world_model.recurrent_model.dense_units
    _, per_step = _launches(cfg, {"gradient_steps": 0, "player_steps": 0, "player_width": 1, "test_steps": 0},
                            imaginations)
    return record["gradient_steps"] * per_step + sum(
        calls * _launch_chunks(int(width), hidden, joint_dim) for width, calls in record["player_calls"].items())


def start_child_runners(build_dir: Path, count: int = 2) -> list:
    """The resilience children's interpreters (``_CHILD_RUNNER``), started
    now so that their imports (and the bytecode cache the smoke's other
    Python processes read) are made while the kernels build: for each, the
    name it listens on, its process and the file it creates once ready.
    Each is killed at the smoke's exit if it is still waiting."""
    from sheeprl_tpu_torch.resilience.supervisor import child_env

    runners = []
    for i in range(count):
        name, ready = f"sheeprl-chip-smoke-{os.getpid()}-{i}", build_dir / f"child_runner_{i}.ready"
        ready.unlink(missing_ok=True)
        proc = subprocess.Popen([sys.executable, "-c", _CHILD_RUNNER, name, str(ready)], cwd=str(ROOT),
                                env=child_env(), stdout=subprocess.DEVNULL)
        atexit.register(proc.kill)  # a no-op once it has exited
        runners.append((name, proc, ready))
    return runners


# the lint phase: the port's lint as the card machine's Python runs it, in a
# process of its own started beside the kernel build; it reports its own
# seconds and whether it loaded torch or jax (it is static: it must not)
LINT_DEADLINE_S = 20.0
_LINT_RUNNER = """
import json, sys, time
t0 = time.monotonic()
from sheeprl_tpu_torch.tools import sheeprl_lint
code = sheeprl_lint.main(["--format", "json", "--out", sys.argv[1]])
record = {"exit_code": code, "seconds": round(time.monotonic() - t0, 3),
          "imported": sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib"))}
with open(sys.argv[2], "w") as fp:
    json.dump(record, fp)
"""


def start_lint(build_dir: Path) -> dict:
    """Start ``python -m sheeprl_tpu_torch.tools.sheeprl_lint``'s work in a
    child interpreter now; :func:`run_lint` reads it later."""
    paths = {k: build_dir / f"lint_{k}" for k in ("report.json", "record.json", "log.txt")}
    for path in paths.values():
        path.unlink(missing_ok=True)
    with open(paths["log.txt"], "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", _LINT_RUNNER, str(paths["report.json"]),
                                 str(paths["record.json"])], cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT)
    atexit.register(proc.kill)  # a no-op once it has exited
    return {"proc": proc, "started": time.monotonic(), **paths}


def run_lint(lint: dict) -> dict:
    """The lint phase: the port's lint over the checkout, under its baseline,
    within ``LINT_DEADLINE_S`` of its start, without torch or jax."""
    proc = lint["proc"]
    try:
        proc.wait(timeout=max(0.0, LINT_DEADLINE_S - (time.monotonic() - lint["started"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"lint: no result within {LINT_DEADLINE_S:g} s of its start") from None
    log = lint["log.txt"].read_text()[-2000:]
    if proc.returncode != 0 or not lint["record.json"].is_file():
        raise AssertionError(f"lint: exit code {proc.returncode} (findings outside the baseline?): {log}")
    record = json.loads(lint["record.json"].read_text())
    report = json.loads(lint["report.json"].read_text())
    if record["seconds"] > LINT_DEADLINE_S:
        raise AssertionError(f"lint: {record['seconds']} s, over its {LINT_DEADLINE_S:g} s deadline")
    if record["imported"]:
        raise AssertionError(f"lint: the lint process imported {record['imported']}")
    if report["findings"] or report["stale_baseline_entries"] or set(report["families"]) != {
            "INS", "JIT", "CFG", "JRN", "ASY", "TRC", "LCK"}:
        raise AssertionError(f"lint: {report['findings']}, stale {report['stale_baseline_entries']}, "
                             f"families {report['families']}")
    return {"seconds": record["seconds"], "suppressed": report["suppressed"], "families": report["families"],
            "elapsed_in_lint": report["elapsed_seconds"]}


def _wait_ready(runners: list, timeout_s: float = 300.0) -> None:
    t0 = time.monotonic()
    while not all(ready.exists() for _, _, ready in runners):
        dead = [proc.returncode for _, proc, _ in runners if proc.poll() is not None]
        if dead or time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"the resilience children's interpreters: exit codes {dead}, "
                                 f"{time.monotonic() - t0:.0f} s without their imports")
        time.sleep(0.05)


def run_resilience(build_dir: Path, runners: list, device_name: str = "cuda") -> dict:
    """This slice's group: the chaos schedule, the supervisor and the run
    readers on DreamerV3-S children (``RESILIENCE_OVERRIDES``).  The
    smoke's ``supervise_command`` starts ``_CHILD_HANDOFF`` children, each
    of which hands its run to one of ``runners`` (``start_child_runners``:
    interpreters that made a child's imports before the group); the
    first runs the schedule and must exit 75 with the drill's chains
    (``chaos.judge_drill``: ``fault_injection -> ckpt_end -> run_end`` and
    ``fault_injection -> preempted -> run_end``, status ``preempted``, a
    final checkpoint that verifies) and a ``ckpt_end`` queued at least
    ``slow_write_s``; the second, respawned without backoff, resumes from
    the newest verified checkpoint and completes.  Each child's kernel
    launches equal what its gradient steps and player calls predict.  The
    supervisor's ``restart`` row is read by ``goodput_report``;
    ``run_monitor`` reads the finished run and ``health_diff`` compares its
    journals (in band against itself, out of band against the other child
    at zero tolerance)."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.diagnostics.journal import read_journal
    from sheeprl_tpu_torch.resilience.chaos import judge_drill
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.resilience.preemption import PREEMPTED_EXIT_CODE
    from sheeprl_tpu_torch.resilience.supervisor import SUPERVISOR_JOURNAL, supervise_command

    root = (build_dir / "resilience").resolve()
    shutil.rmtree(root, ignore_errors=True)
    schedule = "[" + ",".join(f"{{iter: {e['iter']}, fault: {e['fault']}}}" for e in RESILIENCE_SCHEDULE) + "]"
    overrides = RESILIENCE_OVERRIDES + [f"root_dir={root}", f"fabric.accelerator={device_name}",
                                        f"diagnostics.resilience.chaos.schedule={schedule}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg)
    run_dir = root / cfg.run_name
    records = []

    def argv_builder(resume):
        records.append(root / f"child_{len(records)}.json")
        return [sys.executable, "-c", _CHILD_HANDOFF, runners[len(records) - 1][0], str(records[-1]), "run", *overrides,
                *([f"checkpoint.resume_from={resume}"] if resume is not None else [])]

    def tails() -> str:
        return "\n".join(f"--- {path.name}: {path.read_text() if path.exists() else 'running'}; its log:\n"
                         + Path(f"{path}.log").read_text()[-3000:] for path in records if Path(f"{path}.log").exists())

    _wait_ready(runners)
    t0 = time.monotonic()
    with deadline(RESILIENCE_DEADLINES_S["resilience_children"], "resilience_children", tails):
        rc = supervise_command(argv_builder, str(run_dir), max_restarts=1, backoff_base_s=5.0)
    children_s = time.monotonic() - t0
    children = [json.loads(path.read_text()) for path in records]
    if rc != 0 or [c["exit_code"] for c in children] != [PREEMPTED_EXIT_CODE, 0]:
        raise AssertionError(f"supervised chaos run: supervisor exit {rc}, children "
                             f"{[c['exit_code'] for c in children]} (want [75, 0])\n{tails()}")
    for i, child in enumerate(children):
        predicted = _child_launches(cfg, child)
        if child["launches"] != predicted or child["gradient_steps"] < 1:
            raise AssertionError(f"resilience child {i}: {child['launches']} ln_gru launches, its "
                                 f"{child['gradient_steps']} gradient steps and player calls {child['player_calls']} "
                                 f"predict {predicted}")
    first, second = sorted(run_dir.glob("version_*"), key=lambda p: int(p.name.split("_")[1]))
    verdict = judge_drill(RESILIENCE_SCHEDULE, children[0]["exit_code"], str(first), cfg.run_name)
    if not verdict["ok"] or children[0]["exit_code"] != PREEMPTED_EXIT_CODE:
        raise AssertionError(f"chaos drill verdict: {json.dumps(verdict)[:2000]}")
    events = read_journal(str(first / "journal.jsonl"))
    injected = [(e["iter_num"], e["kind"]) for e in events if e["event"] == "fault_injection"]
    slow = [e for e in events if e["event"] == "ckpt_end" and (e.get("queued_s") or 0) >= RESILIENCE_SLOW_WRITE_S]
    preempted = [e for e in events if e["event"] == "preempted"]
    if (injected != [(RESILIENCE_SLOW_WRITE_ITER, "slow_write"), (RESILIENCE_PREEMPT_ITER, "preempt")] or not slow
            or len(preempted) != 1 or preempted[0]["reason"] != "chaos"):
        raise AssertionError(f"chaos run: injections {injected}, ckpt_end queued >= {RESILIENCE_SLOW_WRITE_S} s: "
                             f"{slow}, preempted {preempted}")
    # where each child's seconds went: its run_start, first env step and
    # run_end, from the process's start
    timeline = []
    for child, version in zip(children, (first, second)):
        child_events = read_journal(str(version / "journal.jsonl"))
        first_step = next(e["t"] for e in child_events if e["event"] == "state_change" and e.get("state") == "env_wait")
        timeline.append([round(t - child["started"], 1) for t in (child_events[0]["t"], first_step,
                                                                   child_events[-1]["t"])])
    restarts = read_journal(str(run_dir / SUPERVISOR_JOURNAL))
    emergency = preempted[0]["path"]
    if (len(restarts) != 1 or restarts[0]["event"] != "restart" or not restarts[0]["preempted"]
            or restarts[0]["backoff_s"] != 0.0 or restarts[0]["resume_from"] != emergency):
        raise AssertionError(f"supervisor.jsonl: {restarts} (the emergency checkpoint {emergency})")
    resumed = read_journal(str(second / "journal.jsonl"))
    steps = [e["step"] for e in resumed if e["event"] == "metrics"]
    ckpts = [e for e in resumed if e["event"] == "ckpt_end" and e.get("status") == "ok"]
    if (resumed[-1].get("status") != "completed" or not steps or min(steps) <= RESILIENCE_PREEMPT_ITER * cfg.env.num_envs
            or not ckpts or verify_checkpoint(ckpts[-1]["path"]) != (True, "verified")):
        raise AssertionError(f"resumed child: run_end {resumed[-1]}, metric steps {steps[:3]}, checkpoints "
                             f"{[c['path'] for c in ckpts]}")

    # the four readers at once, each its own process
    t1 = time.monotonic()
    with deadline(RESILIENCE_DEADLINES_S["resilience_reports"], "resilience_reports"), \
            concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(_report, "goodput_report", str(run_dir), "--json"),
                   pool.submit(_report, "run_monitor", str(second)),
                   pool.submit(_report, "health_diff", str(first), str(first)),
                   pool.submit(_report, "health_diff", str(first), str(second), "--rel-tol", "0", "--abs-tol", "0",
                               "--json", expect=1)]
        goodput, monitor, in_band, out_of_band = (future.result() for future in futures)
    reports_s = time.monotonic() - t1
    goodput, out_of_band = json.loads(goodput), json.loads(out_of_band)
    supervisor = goodput[str(run_dir)]["supervisor"]
    if supervisor["restarts"] != 1 or supervisor["preempted_restarts"] != 1:
        raise AssertionError(f"goodput_report's restart accounting: {supervisor}")
    if "completed" not in monitor or "RESULT: ok" not in in_band or not out_of_band["regressions"]:
        raise AssertionError(f"run_monitor:\n{monitor}\nhealth_diff in band:\n{in_band}\nout of band: "
                             f"{out_of_band.get('regressions')}")
    return {"children": children, "children_s": children_s, "reports_s": reports_s,
            "launches": [c["launches"] for c in children],
            "predicted": [_child_launches(cfg, c) for c in children],
            "slow_ckpt_end": {k: slow[0].get(k) for k in ("queued_s", "write_ms", "step")},
            "restart": {k: restarts[0].get(k) for k in ("attempt", "rc", "preempted", "backoff_s", "down_s")},
            "supervisor": supervisor, "resumed_from": emergency, "first_resumed_step": min(steps),
            "checks": sorted(verdict["checks"]), "monitor_lines": len(monitor.splitlines()),
            "regressions": len(out_of_band["regressions"]), "timeline": timeline}


def _parallel_noise(noise: dict, T: int, B: int, shards: int) -> list:
    """One gradient step's draws for ``B`` rows (``_train_noise``), cut into
    each shard's: block d of the batch axis of the dynamic scan's ``[T, B,
    ...]`` and of the imagination's and the actor's ``T * B`` rows (laid
    out ``t * B + b``)."""
    b = B // shards

    def rows_of(x, axis: int, d: int):
        """Shard d's ``T * b`` rows of ``x``'s ``T * B`` rows at ``axis``."""
        y = x.reshape(*x.shape[:axis], T, B, *x.shape[axis + 1:]).narrow(axis + 1, d * b, b)
        return y.reshape(*x.shape[:axis], T * b, *x.shape[axis + 1:]).contiguous()

    return [{"dynamic": tuple(n[:, d * b:(d + 1) * b].contiguous() for n in noise["dynamic"]),
             "imagination": rows_of(noise["imagination"], 1, d),
             "actor": [[rows_of(h, 0, d) for h in heads] for heads in noise["actor"]]} for d in range(shards)]


def _decisive(noise: dict, gen) -> dict:
    """``noise`` with every Gumbel draw replaced by noise that decides the
    draw whatever the logits (0 at a class drawn from ``gen``, -1e4
    elsewhere: ``chip_gumbel_split.py``'s ``decisive_like``)."""
    import torch

    def decisive(x):
        idx = torch.randint(0, x.shape[-1], tuple(x.shape[:-1]) + (1,), device=x.device, generator=gen)
        return torch.full(tuple(x.shape), -1e4, device=x.device).scatter_(-1, idx, 0.0)

    return {"dynamic": tuple(decisive(n) for n in noise["dynamic"]), "imagination": decisive(noise["imagination"]),
            "actor": [[decisive(h) for h in heads] for heads in noise["actor"]]}


def _recorded_draws(draws: list):
    """A patch of the DreamerV3 samplers' ``draw`` (``agent.py``) that
    appends each call's ``(generator, batch_dims, result)`` to ``draws``."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import agent as agent_mod

    real = agent_mod.draw

    def draw(fn, shape, generator, *, dtype=None, device=None, batch_dims=1):
        out = real(fn, shape, generator, dtype=dtype, device=device, batch_dims=batch_dims)
        draws.append((generator, batch_dims, out))
        return out

    return mock.patch.object(agent_mod, "draw", draw)


def _joined_draws(draws: list, streams: list) -> list:
    """The shards' blocks of each draw (``_recorded_draws`` of ``streams``'
    steps, in the order the lockstep ran them) put back into the global
    draw: block d of the rows ``(outer, shard, row)`` to shard d."""
    import torch

    per_shard = [[(dims, t) for g, dims, t in draws if g is stream] for stream in streams]
    joined = []
    for blocks in zip(*per_shard):
        dims, first = blocks[0]
        lead, rows = first.shape[:dims].numel(), streams[0].rows
        parts = [t.reshape((lead // rows, 1, rows) + tuple(t.shape[dims:])) for _, t in blocks]
        whole = torch.cat(parts, dim=1)
        joined.append(whole.reshape(first.shape[:dims - 1] + (first.shape[dims - 1] * len(blocks),)
                                    + first.shape[dims:]))
    return joined


def _update_against_one(one_agent, one_optimizers, shard_agent, optimizer_sets) -> dict:
    """The update a shard took against one device's: shard 0's parameters
    against the one-device agent's (within ``STEP_PARAM_ATOL`` but for a
    ``STEP_PARAM_OUTLIERS`` fraction, Adam's first step where a gradient is
    within rounding of 0; the largest difference printed, not held), and
    the optimizers' state gathered over the model shards
    (``fsdp.gathered_optimizers``, the optimizers themselves without FSDP)
    against the one-device optimizers' (each state tensor's tree held at
    ``UPDATE_MOMENT_RTOL`` of its norm, the step counters equal)."""
    import torch

    from sheeprl_tpu_torch.parallel.fsdp import gathered_optimizers

    with torch.no_grad():
        diff = torch.cat([(a.detach().float() - b.detach().float()).abs().flatten()
                          for m, n in zip(shard_agent, one_agent) for a, b in zip(m.parameters(), n.parameters())])
    out = {"param_max_abs": float(diff.max()),
           "param_outliers": float((diff > STEP_PARAM_ATOL).float().mean()), "moments_rel": {}, "counts_equal": True}
    with gathered_optimizers(optimizer_sets) as whole:
        for name, one_opt in one_optimizers.items():
            one_params = [p for g in one_opt.param_groups for p in g["params"]]
            got_params = [p for g in whole[name].param_groups for p in g["params"]]
            sums: dict = {}
            for p, q in zip(one_params, got_params):
                want, got = one_opt.state.get(p, {}), whole[name].state.get(q, {})
                for key, w in want.items():
                    g = got.get(key)
                    if not isinstance(w, torch.Tensor) or w.shape != p.shape:
                        out["counts_equal"] &= g is not None and float(w) == float(g)
                        continue
                    d = (g.to(w.device).float() - w.float()).pow(2).sum()
                    num, den = sums.get(key, (0.0, 0.0))
                    sums[key] = (num + float(d), den + float(w.float().pow(2).sum()))
            for key, (num, den) in sums.items():
                out["moments_rel"][f"{name}/{key}"] = (num / max(den, 1e-30)) ** 0.5
    return out


def _print_update(group: str, label: str, update: dict, card: str) -> None:
    """One line of ``_update_against_one``'s readings."""
    moments = {k: float(f"{v:.3g}") for k, v in update["moments_rel"].items()}
    print(f"[{group}] the {label} step's update against one device's: shard 0's parameters max abs difference "
          f"{update['param_max_abs']:.3g} (printed, not held: Adam's first step), fraction over "
          f"{STEP_PARAM_ATOL:g} {update['param_outliers']:.3g} (tol {STEP_PARAM_OUTLIERS:g}); the gathered "
          f"optimizer state's relative error {json.dumps(moments)} (tol {UPDATE_MOMENT_RTOL:g}), step counters equal"
          + (f"; {update['draws']} draws, each shard's blocks joined bitwise the one-device draw, the generators "
             f"ending alike" if "draws" in update else "") + f"  [{card}]", flush=True)


def _two_shards_against_one(cfg, build_agent, make_train_step, metric_order, tau: float, where: str,
                            device_name: str = "cuda", fsdp: int = 1, from_generator: bool = False) -> dict:
    """One fp32 gradient step of a Dreamer-family step over two shards
    (each with its replica, ``parallel/dp.py``) against one device's step on
    the same global batch and the same noise (noise that decides every
    categorical draw: the two paths' logits differ by rounding, and a near
    tie would otherwise split a sample), from the same weights: the metrics
    (and the Moments' ``low``/``high`` where the family keeps them) within
    ``PARALLEL_STEP_RTOL``, the shards' metrics and replicas bitwise equal,
    the update against one device's (``_update_against_one``), the kernel's
    launches counted from 0 around the three steps as each shard's dynamic
    scan and imagination predict.  With ``fsdp`` = 2 the two shards are a
    model axis placed as the loop places them (``fsdp.shard_replicas``):
    each one's modules hold only its index's slices of the leaves the rule
    cuts between steps, gathered whole for the step (``dp.holding_whole``),
    its optimizers cut for its index (``parallel/fsdp.py``); after the step
    each shard again holds only its slices (the whole leaves whole), its
    parameter bytes summed from its tensors equal to the rule's
    ``tree_bytes_per_device`` (``rest``), the gathered parameters and
    optimizer state equal across them.  ``from_generator`` (FSDP only): no injected noise,
    the one-device step draws from a generator and the shards from
    ``dp.global_streams`` over a generator of the same seed, as the loop
    runs them; each draw's blocks joined must be the one-device draw
    bitwise, and the generators end in the same state.  ``peak_bytes``: the
    most bytes the allocator held during the shards' step above what it
    held before it (the step's optimizer state, created at its first
    update, its activations and gradients)."""
    import copy

    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import learner_replicas_equal, make_optimizers
    from sheeprl_tpu_torch.parallel.fsdp import rest_of, shard_replicas, tree_bytes_per_device, whole_params
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.algos.ppo.agent import actions_dim_of
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.parallel.dp import global_streams, holding_whole, run_shards, split
    from sheeprl_tpu_torch.parallel.mesh import replicate

    device = torch.device(device_name)
    env = make_env(cfg, cfg.seed, 0)()
    obs_space, (actions_dim, is_continuous, _) = env.observation_space, actions_dim_of(env.action_space)
    env.close()
    T, B, H = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, cfg.algo.horizon
    gen = torch.Generator(device=device).manual_seed(13)
    batch = synthetic_batch(cfg, actions_dim, gen, device)
    noise = _decisive(_train_noise(cfg, actions_dim, gen, device_name), gen)
    agent = build_agent(actions_dim, is_continuous, cfg, obs_space, None, device)
    shards = replicate(copy.deepcopy(agent), [device] * PARALLEL_SHARDS)
    optimizers = [make_optimizers(cfg, a) for a in (agent, *shards)]
    floor = cfg.fabric.get("fsdp_min_shard_bytes")
    cut = [[] for _ in shards]
    if fsdp > 1:
        optimizers[1:], cut = shard_replicas(shards, optimizers[1:], fsdp, floor)
    steps = [make_train_step(a, o, cfg, is_continuous) for a, o in zip((agent, *shards), optimizers)]
    blocks = split(batch, PARALLEL_SHARDS, 1)
    draws: list = []
    if from_generator:
        one_gen, shard_gen = (torch.Generator(device=device).manual_seed(29) for _ in range(2))
        streams = global_streams(shard_gen, [B // PARALLEL_SHARDS] * PARALLEL_SHARDS)
        one_args, shard_args = (one_gen, None), [(s, None) for s in streams]
        recording = _recorded_draws(draws)
    else:
        one_args, shard_args = (None, noise), [(None, n) for n in _parallel_noise(noise, T, B, PARALLEL_SHARDS)]
        recording = contextlib.nullcontext()
    t0 = time.monotonic()
    with recording:
        fused_layernorm_gru.launches = 0  # the comparison's launches start here
        one_moments, one_metrics = steps[0](agent.initial_moments(device), batch, tau, *one_args)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        outs = run_shards([holding_whole(step.body(agent.initial_moments(device), block, tau, *args), params)
                           for step, block, args, params in zip(steps[1:], blocks, shard_args, cut)])
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated(device) - before
        launches = fused_layernorm_gru.launches  # and end here
    seconds = time.monotonic() - t0
    (moments, metrics), (_, other) = outs
    n = len(metric_order)
    want, got = one_metrics[:n].cpu().numpy(), metrics[:n].cpu().numpy()
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-3)))
    moments_rel = max((abs(float(moments[k]) - float(one_moments[k])) / max(abs(float(one_moments[k])), 1e-3)
                       for k in one_moments), default=0.0)
    equal = learner_replicas_equal(shards, optimizers[1:])
    rest = None
    if fsdp > 1:
        # between steps a shard holds only its slices: every cut leaf its
        # rest, every other whole; its bytes are the rule's
        at_rest = all(p.shape == rest_of(p).tensor.shape and p.data_ptr() == rest_of(p).tensor.data_ptr()
                      for params in cut for p in params)
        whole_leaves = all(rest_of(p) is None for shard, params in zip(shards, cut) for m in shard
                           for p in m.parameters() if id(p) not in {id(q) for q in params})
        held = [sum(p.numel() * p.element_size() for m in shard for p in m.parameters()) for shard in shards]
        rule = tree_bytes_per_device(agent.trees(), fsdp, floor)
        whole_bytes = sum(p.numel() * p.element_size() for m in agent for p in m.parameters())
        rest = {"at_rest": at_rest and whole_leaves, "held_bytes": held, "rule_bytes": rule,
                "whole_bytes": whole_bytes, "cut_leaves": len(cut[0])}
        equal = equal and rest["at_rest"] and held == [rule] * len(shards) and rule < whole_bytes
    with whole_params(cut[:max(fsdp, 1)]):
        update = _update_against_one(agent, optimizers[0], shards[0], optimizers[1:])
    update_ok = (update["param_outliers"] <= STEP_PARAM_OUTLIERS and update["counts_equal"]
                 and max(update["moments_rel"].values()) <= UPDATE_MOMENT_RTOL)
    draws_ok = True
    if from_generator:
        one_draws = [t for g, _, t in draws if g is one_gen]
        joined = _joined_draws(draws, streams)
        draws_ok = (len(joined) == len(one_draws) > 0 and all(torch.equal(a, b) for a, b in zip(joined, one_draws))
                    and torch.equal(torch.rand(4, generator=one_gen, device=device),
                                    torch.rand(4, generator=shard_gen, device=device)))
        update["draws"] = len(one_draws)
    hidden = cfg.algo.world_model.recurrent_model.recurrent_state_size
    joint = hidden + cfg.algo.world_model.recurrent_model.dense_units
    per_shard = T * _launch_chunks(B // PARALLEL_SHARDS, hidden, joint) + H * _launch_chunks(
        T * B // PARALLEL_SHARDS, hidden, joint)
    one = T * _launch_chunks(B, hidden, joint) + H * _launch_chunks(T * B, hidden, joint)
    predicted = one + PARALLEL_SHARDS * per_shard
    if (not np.isfinite(got).all() or rel > PARALLEL_STEP_RTOL or moments_rel > PARALLEL_STEP_RTOL or not equal
            or not torch.equal(metrics, other) or launches != predicted or not update_ok or not draws_ok):
        raise AssertionError(f"two-shard {where} step against one device: metrics relative error {rel} "
                             f"(tol {PARALLEL_STEP_RTOL}), Moments {moments_rel}, replicas equal {equal} (rest "
                             f"{rest}), shards' "
                             f"metrics equal {torch.equal(metrics, other)}, launches {launches} (predicted "
                             f"{predicted}), update {update}, draws equal {draws_ok}\n"
                             f"{dict(zip(metric_order, want.tolist()))}\n{dict(zip(metric_order, got.tolist()))}")
    return {"metric_rel_err": rel, "moments_rel_err": moments_rel, "launches": launches, "predicted": predicted,
            "one_device": one, "per_shard": per_shard, "seconds": seconds, "batch": B,
            "shard_batch": B // PARALLEL_SHARDS, "moments": {k: float(v) for k, v in moments.items()},
            "peak_bytes": peak_bytes, "update": update, "rest": rest}


def run_parallel_step(device_name: str = "cuda") -> dict:
    """(2) One DreamerV3-S fp32 gradient step over two shards at
    per_rank_batch_size=8 against one device's step on the same 16-row
    global batch (``_two_shards_against_one``): the 11 metrics and the
    Moments, each shard's dynamic scan and imagination through the kernel."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, make_train_step
    from sheeprl_tpu_torch.config import compose

    cfg = compose(PARALLEL_STEP_OVERRIDES + [f"fabric.accelerator={device_name}"])
    _dv3_s_widths(cfg)
    return _two_shards_against_one(cfg, build_agent, make_train_step, METRIC_ORDER, 0.02, "DreamerV3-S", device_name)


def _ppo_two_shards_card_vs_cpu(ckpt: str, overrides, devices) -> dict:
    """(3) One two-shard PPO update (two replicas, ``run_shards``) from a
    checkpoint on ``devices[0]`` and on ``devices[1]``, with the same rows,
    permutations and coefficients: the metrics' largest relative error and
    the parameters' largest absolute error, and whether each side's replicas
    ended bitwise equal."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.ppo.agent import actions_dim_of, build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import _minibatches, linear_schedule, make_train_step
    from sheeprl_tpu_torch.config import compose, instantiate
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.interop.flax_params import optimizer_state_dict, ppo_spec, ppo_to_flax
    from sheeprl_tpu_torch.parallel.dp import replicas_equal, run_shards, stage
    from sheeprl_tpu_torch.parallel.mesh import replicate
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    cfg = compose(overrides)
    state = load_state(ckpt)
    env = make_env(cfg, cfg.seed, 0)()
    obs_space, (actions_dim, is_continuous, _) = env.observation_space, actions_dim_of(env.action_space)
    env.close()
    batch_size, epochs = int(cfg.algo.per_rank_batch_size), int(cfg.algo.update_epochs)
    num_minibatches = _minibatches(cfg, PARALLEL_SHARDS)
    total = int(cfg.algo.rollout_steps) * int(cfg.env.num_envs)
    gen = torch.Generator().manual_seed(17)
    data = {"obs": {k: torch.randn(total, *obs_space[k].shape, generator=gen) for k in cfg.algo.mlp_keys.encoder},
            "actions": torch.randint(0, actions_dim[0], (total, 1), generator=gen).float(),
            **{k: torch.randn(total, 1, generator=gen) for k in ("logprobs", "values", "returns", "advantages")}}
    data["logprobs"] -= 1.0
    perms = [[torch.randperm(num_minibatches * batch_size, generator=gen) for _ in range(epochs)]
             for _ in range(PARALLEL_SHARDS)]
    coefs = (float(cfg.algo.clip_coef), float(cfg.algo.ent_coef), float(cfg.algo.vf_coef))
    schedule = None
    if cfg.algo.anneal_lr:
        schedule = linear_schedule(float(cfg.algo.optimizer.learning_rate), 0.0,
                                   max(1, int(cfg.algo.total_steps) // total * epochs * num_minibatches))
    results = []
    for device_name in devices:
        device = torch.device(device_name)
        shard_devices = [device] * PARALLEL_SHARDS
        replicas = replicate(build_agent(actions_dim, is_continuous, cfg, obs_space, state["agent"], device),
                             shard_devices)
        optimizers = []
        for replica in replicas:
            optimizer = instantiate(cfg.algo.optimizer)(replica.parameters())
            optimizer.load_state_dict(optimizer_state_dict(state["opt_state"], optimizer, ppo_spec(replica)))
            optimizers.append(optimizer)
        steps = [make_train_step(r, o, cfg, num_minibatches, batch_size, schedule)
                 for r, o in zip(replicas, optimizers)]
        metrics = run_shards([s.body(block, [p.to(device) for p in perms[d]], coefs) for d, (s, block) in
                              enumerate(zip(steps, stage(data, shard_devices, batch_axis=0)))])[0]
        on_device = all(t.device.type == device.type for r in replicas for t in r.parameters())
        results.append((metrics.cpu().numpy(), dict(_leaves(ppo_to_flax(replicas[0]))),
                        replicas_equal([[r, o] for r, o in zip(replicas, optimizers)]) and on_device))
    (m_card, p_card, ok_card), (m_cpu, p_cpu, ok_cpu) = results
    n = 4  # the losses and the gradient norm
    rel = float(np.max(np.abs(m_card[:n] - m_cpu[:n]) / np.maximum(np.abs(m_cpu[:n]), 1e-6)))
    err = max(float(np.abs(np.asarray(p_card[k]) - np.asarray(p_cpu[k])).max()) for k in p_cpu)
    return {"metric_rel_err": rel, "param_max_abs_err": err, "replicas_equal": ok_card and ok_cpu,
            "updates": epochs * num_minibatches}


def run_parallel_ppo_sac(root: Path, device_name: str = "cuda") -> dict:
    """(3) PPO and SAC at ``fabric.devices=2`` through ``run``: finite
    metrics, the replicas bitwise equal at the end, verified checkpoints;
    each resumed at ``fabric.devices=1`` from its two-shard mid-run
    checkpoint; and the two-shard PPO update from that checkpoint on the
    card against the CPU.  Neither runs a hand-written kernel (0 launches,
    counted from 0 around each run)."""
    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    out = {"launches": {}}
    for name, base in (("ppo", PARALLEL_PPO_OVERRIDES), ("sac", PARALLEL_SAC_OVERRIDES)):
        overrides = base + [f"root_dir={root / name}", f"fabric.accelerator={device_name}"]
        t0 = time.monotonic()
        fused_layernorm_gru.launches = 0  # the main path starts here
        run = cli.run(overrides)
        out["launches"][f"parallel_{name}"] = fused_layernorm_gru.launches  # the main path ends here
        ckpts = run["checkpoints"]
        if (run["shards"] != PARALLEL_SHARDS or not run["replicas_equal"] or len(ckpts) != 2
                or not np.isfinite(run["metric_rows"]).all() or len(run["metric_rows"]) == 0
                or any(verify_checkpoint(c) != (True, "verified") for c in ckpts)):
            raise AssertionError(f"parallel {name}: {run['shards']} shards, replicas equal {run['replicas_equal']}, "
                                 f"checkpoints {ckpts}, metric rows {run['metric_rows']}")
        saved = load_state(ckpts[0])
        one = [o for o in overrides if not o.startswith("fabric.devices=")] + [
            "fabric.devices=1", f"root_dir={root / (name + '_resumed')}", f"checkpoint.resume_from={ckpts[0]}"]
        fused_layernorm_gru.launches = 0
        resumed = cli.run(one)
        out["launches"][f"parallel_{name}_resume"] = fused_layernorm_gru.launches
        if (resumed["shards"] != 1 or resumed["start_iter"] != saved["iter_num"] + 1 or len(resumed["metric_rows"]) == 0
                or not np.isfinite(resumed["metric_rows"]).all()):
            raise AssertionError(f"parallel {name} resumed at one shard from {ckpts[0]}: start_iter "
                                 f"{resumed['start_iter']} (saved iteration {saved['iter_num']}), shards "
                                 f"{resumed['shards']}, metric rows {resumed['metric_rows']}")
        out[name] = {"iterations": run["iterations"], "rows": len(run["metric_rows"]),
                     "final": run["metric_rows"][-1].tolist(), "checkpoint_batch_size": saved["batch_size"],
                     "resume_start_iter": resumed["start_iter"], "resume_rows": len(resumed["metric_rows"]),
                     "seconds": time.monotonic() - t0,
                     **({"gradient_steps": run["gradient_steps"]} if "gradient_steps" in run else {})}
        if name == "ppo":
            out["ppo_card_vs_cpu"] = _ppo_two_shards_card_vs_cpu(ckpts[0], overrides, (device_name, "cpu"))
            row = out["ppo_card_vs_cpu"]
            if (not row["replicas_equal"] or row["metric_rel_err"] > PARALLEL_CARD_CPU_RTOL
                    or row["param_max_abs_err"] > PARALLEL_CARD_CPU_ATOL):
                raise AssertionError(f"two-shard PPO update, card against CPU: {row} (tol {PARALLEL_CARD_CPU_RTOL}, "
                                     f"{PARALLEL_CARD_CPU_ATOL})")
    return out


def run_parallel(build_dir: Path, runner, device_name: str = "cuda") -> dict:
    """This slice's group, 45 s in all (``PARALLEL_DEADLINES_S``): (1)
    ``python -m sheeprl_tpu_torch run exp=dreamer_v3 fabric.devices=2`` at
    DreamerV3-S in a child handed to ``runner`` (an interpreter of
    ``start_child_runners`` that made its imports before the group), its
    LayerNorm-GRU launches (counted from 0 in the child) equal to 2 x 79 a
    gradient step plus the player's, its journal's ``sharding_audit`` over
    the two shards; while it runs, (2) ``run_parallel_step`` and (3)
    ``run_parallel_ppo_sac`` in this process."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.diagnostics.journal import read_journal
    from sheeprl_tpu_torch.resilience.supervisor import child_env

    root = (build_dir / "parallel").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    overrides = PARALLEL_DV3_OVERRIDES + [f"root_dir={root / 'dv3'}", f"fabric.accelerator={device_name}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg)
    record = root / "dv3_child.json"

    def tail() -> str:
        log = Path(f"{record}.log")
        return log.read_text()[-3000:] if log.exists() else "no child log"

    _wait_ready([runner])
    t0 = time.monotonic()
    with deadline(PARALLEL_DEADLINES_S["parallel"], "parallel", tail):
        proc = subprocess.Popen([sys.executable, "-c", _CHILD_HANDOFF, runner[0], str(record), "run", *overrides],
                                cwd=str(ROOT), env=child_env())
        atexit.register(proc.kill)  # a no-op once it has exited
        with deadline(PARALLEL_DEADLINES_S["parallel_step"], "parallel_step"):
            step = run_parallel_step(device_name)
        with deadline(PARALLEL_DEADLINES_S["parallel_ppo_sac"], "parallel_ppo_sac"), bounded_dummy_actions():
            on_ppo_sac = run_parallel_ppo_sac(root, device_name)
        in_process_s = time.monotonic() - t0
        rc = proc.wait()
    seconds = time.monotonic() - t0
    child = json.loads(record.read_text()) if record.is_file() else {"exit_code": rc}
    if rc != 0 or child.get("exit_code") != 0:
        raise AssertionError(f"parallel DreamerV3-S child: exit {rc} / {child.get('exit_code')}\n{tail()}")
    predicted = _child_launches(cfg, {**child, "gradient_steps": child["gradient_steps"] * PARALLEL_SHARDS})
    (journal_path,) = (root / "dv3").rglob("journal.jsonl")
    events = read_journal(str(journal_path))
    audits = [e for e in events if e["event"] == "sharding_audit"]
    rows = [e for e in events if e["event"] == "metrics"]
    if (child["shards"] != PARALLEL_SHARDS or child["gradient_steps"] < 1 or child["launches"] != predicted
            or len(audits) != 1 or audits[0]["n_shards"] != PARALLEL_SHARDS or events[-1].get("status") != "completed"):
        raise AssertionError(f"parallel DreamerV3-S child: {child['shards']} shards, {child['gradient_steps']} gradient "
                             f"steps, {child['launches']} ln_gru launches (predicted {predicted}), sharding audits "
                             f"{[(a['n_shards'], a['n_leaves']) for a in audits]}, run_end {events[-1]}")
    shutil.rmtree(root, ignore_errors=True)
    return {"child": child, "predicted": predicted, "per_gradient_step": PARALLEL_SHARDS * MINEDOJO_LAUNCHES_PER_STEP,
            "audit": {k: audits[0][k] for k in ("n_shards", "n_leaves", "total_bytes", "total_bytes_per_device",
                                                "flagged_replicated")},
            "metrics_events": len(rows), "step": step, **on_ppo_sac, "seconds": seconds,
            "in_process_s": in_process_s}


def run_parallel_dv2_step(device_name: str = "cuda") -> dict:
    """(2) One DreamerV2 fp32 gradient step at ``exp=dreamer_v2``'s widths
    over two shards of 8 sequences against one device's on the same 16 x 50
    global batch (``_two_shards_against_one``; tau 1, the hard target
    copy): the 11 metrics, each shard's dynamic scan (8 rows) and
    imagination (400 rows) through the kernel."""
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import METRIC_ORDER, make_train_step
    from sheeprl_tpu_torch.config import compose

    cfg = compose(PARALLEL_DV2_STEP_OVERRIDES + [f"fabric.accelerator={device_name}"])
    _dv2_widths(cfg)
    return _two_shards_against_one(cfg, build_agent, make_train_step, METRIC_ORDER, 1.0, "DreamerV2", device_name)


def _write_datasets(root: Path) -> dict:
    """The group's two offline datasets (``PARALLEL_OFFLINE_*``,
    ``PARALLEL_SAC_*``), written with the port's dataset writer from a
    seeded generator: ``{"dv3": dir, "sac": dir}``."""
    import numpy as np

    from sheeprl_tpu_torch.data.datasets import write_dataset_meta, write_shard

    rng = np.random.default_rng(23)
    dv3, sac = root / "dataset_dv3", root / "dataset_sac"
    rows = PARALLEL_OFFLINE_ROWS
    for stream in range(PARALLEL_OFFLINE_STREAMS):
        first = np.zeros((rows, 1), np.float32)
        first[::32] = 1
        terminated = np.roll(first, -1, axis=0)
        terminated[-1] = 0
        write_shard(str(dv3), stream, 0, {
            "rgb": rng.integers(0, 256, (rows, 3, 64, 64), dtype=np.uint8),
            "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)],
            "rewards": rng.normal(size=(rows, 1)).astype(np.float32), "terminated": terminated,
            "truncated": np.zeros((rows, 1), np.float32), "is_first": first})
    write_dataset_meta(str(dv3), {"kind": "dv3"})
    rows = PARALLEL_SAC_ROWS
    for stream in range(PARALLEL_SAC_STREAMS):
        obs = rng.normal(size=(rows + 1, 10)).astype(np.float32)
        write_shard(str(sac), stream, 0, {
            "observations": obs[:-1], "next_observations": obs[1:],
            "actions": rng.uniform(-1, 1, (rows, 2)).astype(np.float32),
            "rewards": rng.normal(size=(rows, 1)).astype(np.float32),
            "terminated": (rng.random((rows, 1)) < 0.05).astype(np.float32),
            "truncated": np.zeros((rows, 1), np.float32)})
    write_dataset_meta(str(sac), {"kind": "sac"})
    return {"dv3": str(dv3), "sac": str(sac)}


def _offline_sac_two_shards_card_vs_cpu(ckpt: str, cfg, devices) -> dict:
    """(4) One two-shard offline SAC train call (two gradient steps, the
    conservative penalty) from a checkpoint on ``devices[0]`` and on
    ``devices[1]``, with the same rows and draws (the JAX SAC step folds no
    key: every shard takes the same draws): the metrics' largest relative
    error, the parameters' largest absolute error, and whether each side's
    replicas ended bitwise equal."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.algos.sac.sac import SACFamily, draw_cql_noise
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop.flax_params import dump_trees
    from sheeprl_tpu_torch.parallel.dp import replicas_equal, run_shards, stage
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    state = load_state(ckpt)
    obs_space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (10,), np.float32)})
    action_space = spaces.Box(-1.0, 1.0, (2,), np.float32)
    rows, grad = int(cfg.algo.per_rank_batch_size), 2
    gen = torch.Generator().manual_seed(29)
    data = {k: torch.randn(grad, PARALLEL_SHARDS * rows, dim, generator=gen)
            for k, dim in (("observations", 10), ("next_observations", 10), ("rewards", 1))}
    data["actions"] = torch.rand(grad, PARALLEL_SHARDS * rows, 2, generator=gen) * 2 - 1
    data["terminated"] = (torch.rand(grad, PARALLEL_SHARDS * rows, 1, generator=gen) < 0.05).float()
    results, draws = [], []
    for device_name in devices:
        device = torch.device(device_name)
        family = SACFamily(cfg, obs_space, action_space, state, device).make_update()
        family.shard_over([device] * PARALLEL_SHARDS, torch.Generator(device=device).manual_seed(0), cfg.seed)
        if not draws:  # on the CPU, once: the same draws on both sides
            draws = [torch.randn(grad, rows, 2, generator=gen),
                     draw_cql_noise(family.agent.actor, grad, family.cql_samples, rows, gen, "cpu")]
        eps, cql = draws
        metrics = run_shards([s.update.body(block, eps.to(device), _nested_to(cql, device)) for s, block in
                              zip(family.shards, stage(data, [device] * PARALLEL_SHARDS, batch_axis=1))])[0]
        on_device = all(t.device.type == device.type for s in family.shards for t in s.agent.parameters())
        results.append((metrics.cpu().numpy(), dict(_leaves(dump_trees(family.spec()))),
                        replicas_equal([[*s.modules(), *s.optimizers.values()] for s in family.shards]) and on_device))
    (m_card, p_card, ok_card), (m_cpu, p_cpu, ok_cpu) = results
    n = len(family.metric_order)
    rel = float(np.max(np.abs(m_card[:n] - m_cpu[:n]) / np.maximum(np.abs(m_cpu[:n]), 1e-6)))
    err = max(float(np.abs(np.asarray(p_card[k]) - np.asarray(p_cpu[k])).max()) for k in p_cpu)
    return {"metric_rel_err": rel, "param_max_abs_err": err, "replicas_equal": ok_card and ok_cpu,
            "gradient_steps": grad, "shard_rows": rows, "cql_samples": family.cql_samples}


def run_parallel_offline(root: Path, device_name: str = "cuda") -> dict:
    """(3) Offline DreamerV3-S and (4) offline SAC over two shards through
    ``run`` on the datasets written here, each with the kernel's launch
    counter set to 0 before it and read after: every metric finite, the
    replicas bitwise equal, verified checkpoints with the global batch
    size; DreamerV3-S's launches 2 x 79 a gradient step; then the two-shard
    SAC call from its checkpoint on the card against the CPU."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    data = _write_datasets(root)
    out = {"launches": {}}
    for name, base, dataset in (("dv3", PARALLEL_OFFLINE_DV3_OVERRIDES, data["dv3"]),
                                ("sac", PARALLEL_OFFLINE_SAC_OVERRIDES, data["sac"])):
        overrides = base + [f"algo.offline.dataset_dir={dataset}", f"root_dir={root / ('offline_' + name)}",
                            f"fabric.accelerator={device_name}"]
        cfg = compose(overrides)
        if name == "dv3":
            _dv3_s_widths(cfg)
        t0 = time.monotonic()
        fused_layernorm_gru.launches = 0  # the main path starts here
        run = cli.run(overrides)
        if device_name != "cpu":
            torch.cuda.synchronize()
        launches = out["launches"][f"parallel_offline_{name}"] = fused_layernorm_gru.launches  # and ends here
        seconds = time.monotonic() - t0
        per_step = _launches(cfg, {"gradient_steps": 0, "player_steps": 0, "player_width": 1, "test_steps": 0})[1] \
            if name == "dv3" else 0
        predicted = run["gradient_steps"] * PARALLEL_SHARDS * per_step
        ckpts = run["checkpoints"]
        global_batch = PARALLEL_SHARDS * int(cfg.algo.per_rank_batch_size)
        if (run["shards"] != PARALLEL_SHARDS or not run["replicas_equal"] or run["gradient_steps"] < 2
                or not np.isfinite(run["metric_rows"]).all() or launches != predicted or not ckpts
                or any(verify_checkpoint(c) != (True, "verified") for c in ckpts)
                or any(load_state(c)["batch_size"] != global_batch for c in ckpts)):
            raise AssertionError(f"parallel offline {name}: {run['shards']} shards, replicas equal "
                                 f"{run['replicas_equal']}, {run['gradient_steps']} gradient steps, launches {launches} "
                                 f"(predicted {predicted}), checkpoints {ckpts}, metric rows {run['metric_rows']}")
        out[name] = {"gradient_steps": run["gradient_steps"], "launches": launches, "predicted": predicted,
                     "per_gradient_step": PARALLEL_SHARDS * per_step, "final": run["metric_rows"][-1].tolist(),
                     "global_batch": global_batch, "seconds": seconds, "dataset": run["dataset"]}
        if name == "sac":
            row = out["sac_card_vs_cpu"] = _offline_sac_two_shards_card_vs_cpu(ckpts[-1], cfg, (device_name, "cpu"))
            if (not row["replicas_equal"] or row["metric_rel_err"] > PARALLEL_CARD_CPU_RTOL
                    or row["param_max_abs_err"] > PARALLEL_CARD_CPU_ATOL):
                raise AssertionError(f"two-shard offline SAC call, card against CPU: {row} (tol "
                                     f"{PARALLEL_CARD_CPU_RTOL}, {PARALLEL_CARD_CPU_ATOL})")
    return out


def run_parallel_ring(device_name: str = "cuda") -> dict:
    """(5) The env-sharded replay ring over two shards on ``device_name``
    and on the CPU, fed the same DreamerV3-S records of 4 envs (episode-end
    rows to some envs, so the write heads part) and seeded alike: each
    sampled batch's shard blocks bitwise equal across the two, each block
    on its shard's device, its windows from its own envs."""
    import numpy as np
    import torch

    from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer

    rings = {d: DeviceSequentialReplayBuffer(256, PARALLEL_RING_ENVS, devices=[d] * PARALLEL_SHARDS)
             for d in (device_name, "cpu")}
    rng = np.random.default_rng(31)
    for ring in rings.values():
        ring.seed(7)
    for i in range(PARALLEL_RING_STEPS):
        n = PARALLEL_RING_ENVS if i % 5 else 1
        step = {"rgb": rng.integers(0, 256, (1, n, 3, 64, 64), dtype=np.uint8),
                "actions": rng.normal(size=(1, n, 2)).astype(np.float32),
                **{k: (rng.random((1, n, 1)) < 0.1).astype(np.float32) for k in ("rewards", "terminated",
                                                                                  "truncated", "is_first")}}
        for ring in rings.values():
            ring.add(step, None if n == PARALLEL_RING_ENVS else [i % PARALLEL_RING_ENVS])
    t0 = time.monotonic()
    draws = {d: ring.sample(16, sequence_length=64, n_samples=2) for d, ring in rings.items()}
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    equal = all(torch.equal(a[k].cpu(), b[k]) for xs, ys in zip(draws[device_name], draws["cpu"])
                for a, b in zip(xs, ys) for k in b)
    on_device = all(t.device.type == torch.device(device_name).type for xs in draws[device_name] for block in xs
                    for t in block.values())
    shapes = {k: tuple(v.shape) for k, v in draws[device_name][0][0].items()}
    if not equal or not on_device or shapes["rgb"] != (64, 16 // PARALLEL_SHARDS, 3, 64, 64):
        raise AssertionError(f"env-sharded ring on {device_name} against the CPU: equal {equal}, blocks on the card "
                             f"{on_device}, block shapes {shapes}")
    return {"equal": equal, "block_shapes": shapes, "seconds": seconds, "envs": PARALLEL_RING_ENVS}


def run_parallel_families(build_dir: Path, runner, device_name: str = "cuda") -> dict:
    """This slice's group, 45 s in all (``PARALLEL_FAMILIES_DEADLINES_S``):
    (1) ``python -m sheeprl_tpu_torch run exp=p2e_dv2_exploration
    fabric.devices=2`` at its preset's widths in a child handed to
    ``runner`` (an interpreter of ``start_child_runners`` that made its
    imports before the group), its LayerNorm-GRU launches (counted from 0 in
    the child) equal to 2 x 80 a gradient step plus the player's, its
    journal's ``sharding_audit`` over the two shards; while it runs, in this
    process, (2) ``run_parallel_dv2_step``, (3, 4) ``run_parallel_offline``
    and (5) ``run_parallel_ring``."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.diagnostics.journal import read_journal
    from sheeprl_tpu_torch.resilience.supervisor import child_env

    root = (build_dir / "parallel_families").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    overrides = PARALLEL_P2E_DV2_OVERRIDES + [f"root_dir={root / 'p2e_dv2'}", f"fabric.accelerator={device_name}"]
    cfg = compose(overrides)
    _p2e_dreamer_widths(2)(cfg)
    record = root / "p2e_dv2_child.json"

    def tail() -> str:
        log = Path(f"{record}.log")
        return log.read_text()[-3000:] if log.exists() else "no child log"

    _wait_ready([runner])
    t0 = time.monotonic()
    with deadline(PARALLEL_FAMILIES_DEADLINES_S["parallel_families"], "parallel_families", tail):
        proc = subprocess.Popen([sys.executable, "-c", _CHILD_HANDOFF, runner[0], str(record), "run", *overrides],
                                cwd=str(ROOT), env=child_env())
        atexit.register(proc.kill)  # a no-op once it has exited
        with deadline(PARALLEL_FAMILIES_DEADLINES_S["parallel_dv2_step"], "parallel_dv2_step"):
            step = run_parallel_dv2_step(device_name)
        with deadline(PARALLEL_FAMILIES_DEADLINES_S["parallel_offline"], "parallel_offline"):
            offline = run_parallel_offline(root, device_name)
            ring = run_parallel_ring(device_name)
        in_process_s = time.monotonic() - t0
        rc = proc.wait()
    seconds = time.monotonic() - t0
    child = json.loads(record.read_text()) if record.is_file() else {"exit_code": rc}
    if rc != 0 or child.get("exit_code") != 0:
        raise AssertionError(f"parallel P2E-DV2 child: exit {rc} / {child.get('exit_code')}\n{tail()}")
    predicted = _child_launches(cfg, {**child, "gradient_steps": child["gradient_steps"] * PARALLEL_SHARDS},
                                imaginations=2)
    (journal_path,) = (root / "p2e_dv2").rglob("journal.jsonl")
    events = read_journal(str(journal_path))
    audits = [e for e in events if e["event"] == "sharding_audit"]
    if (child["shards"] != PARALLEL_SHARDS or child["gradient_steps"] < 1 or child["launches"] != predicted
            or len(audits) != 1 or audits[0]["n_shards"] != PARALLEL_SHARDS or events[-1].get("status") != "completed"):
        raise AssertionError(f"parallel P2E-DV2 child: {child['shards']} shards, {child['gradient_steps']} gradient "
                             f"steps, {child['launches']} ln_gru launches (predicted {predicted}), sharding audits "
                             f"{[(a['n_shards'], a['n_leaves']) for a in audits]}, run_end {events[-1]}")
    shutil.rmtree(root, ignore_errors=True)
    per_step = _launches(cfg, {"gradient_steps": 0, "player_steps": 0, "player_width": 1, "test_steps": 0}, 2)[1]
    return {"child": child, "predicted": predicted, "per_gradient_step": PARALLEL_SHARDS * per_step,
            "audit": {k: audits[0][k] for k in ("n_shards", "n_leaves", "total_bytes", "total_bytes_per_device",
                                                "flagged_replicated")},
            "step": step, "offline": offline, "ring": ring, "seconds": seconds, "in_process_s": in_process_s,
            "launches": {"parallel_p2e_dv2": child["launches"], "parallel_dv2_step": step["launches"],
                         **offline["launches"]}}


def _host_state(module) -> list:
    """Host copies of a module's parameters and buffers, in
    ``parallel/dp.py::state_tensors``' order."""
    from sheeprl_tpu_torch.parallel.dp import state_tensors

    return [t.detach().to("cpu", copy=True) for t in state_tensors(module)]


def _same_bytes(a: list, b: list) -> bool:
    import torch

    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x.reshape(-1).view(torch.uint8),
                                                                       y.reshape(-1).view(torch.uint8))
                                    for x, y in zip(a, b))


def run_decoupled_ppo(root: Path, device_name: str = "cuda") -> dict:
    """(2) ``run exp=ppo_decoupled fabric.devices=2`` with ``nan_grads`` at
    iteration 2 under the halting sentinel: the journal's ``params_reject``
    (``nonfinite_update``, staleness 1, no escalation) then ``rollback`` to
    iteration 1, the final interval's ``Telemetry/param_staleness`` back to
    0 and ``run_end`` completed; the player's parameters at iteration 2's
    rejected gate bitwise the ones promoted at iteration 1 (read through
    the loop's hand-off, ``ppo_decoupled.promote``, and the facade's gate);
    the hand-off's ms a promotion.  (4) one decoupled PPO update at
    ``fabric.devices=3``: two trainer shards, bitwise equal after it."""
    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.ppo import ppo_decoupled
    from sheeprl_tpu_torch.diagnostics import Diagnostics
    from sheeprl_tpu_torch.diagnostics.journal import read_journal
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru

    seen = {"player": None, "iter": None, "promoted": {}, "rejected": {}}
    promote, gate = ppo_decoupled.promote, Diagnostics.gate_promotion

    def promote_spy(player, trainer):
        ms = promote(player, trainer)
        seen["player"] = player
        seen["promoted"][seen["iter"]] = _host_state(player)
        return ms

    def gate_spy(diag, iter_num, *args, **kwargs):
        seen["iter"] = iter_num
        verdict = gate(diag, iter_num, *args, **kwargs)
        if not verdict:
            seen["rejected"][iter_num] = _host_state(seen["player"])
        return verdict

    overrides = DECOUPLED_PPO_OVERRIDES + DECOUPLED_FAULT + [f"root_dir={root / 'ppo'}",
                                                             f"fabric.accelerator={device_name}"]
    out = {"launches": {}}
    t0 = time.monotonic()
    with mock.patch.object(ppo_decoupled, "promote", promote_spy), \
            mock.patch.object(Diagnostics, "gate_promotion", gate_spy):
        fused_layernorm_gru.launches = 0  # the main path starts here
        run = cli.run(overrides)
        out["launches"]["decoupled_ppo"] = fused_layernorm_gru.launches  # the main path ends here
    events = read_journal(str(Path(run["log_dir"]) / "journal.jsonl"))
    rejects = [e for e in events if e["event"] == "params_reject"]
    rollbacks = [e for e in events if e["event"] == "rollback"]
    last = next((e["metrics"] for e in reversed(events) if e["event"] == "metrics"), {})
    if ([(e["iter_num"], e["reason"], e["staleness"], e["escalate"]) for e in rejects]
            != [(2, "nonfinite_update", 1, False)]
            or [(e["iter_num"], e["restored_iter"]) for e in rollbacks] != [(2, 1)]
            or last.get("Telemetry/param_staleness") != 0 or events[-1].get("status") != "completed"
            or run["gate"] != [(1, True), (2, False), (3, True), (4, True), (5, True)] or run["rollbacks"] != [2]
            or not run["replicas_equal"] or out["launches"]["decoupled_ppo"] != 0):
        raise AssertionError(f"decoupled ppo: params_reject {rejects}, rollback {rollbacks}, final staleness "
                             f"{last.get('Telemetry/param_staleness')}, run_end {events[-1]}, gate {run['gate']}, "
                             f"rollbacks {run['rollbacks']}, {out['launches']['decoupled_ppo']} ln_gru launches")
    if sorted(seen["rejected"]) != [2] or not _same_bytes(seen["rejected"][2], seen["promoted"][1]) \
            or _same_bytes(seen["promoted"][3], seen["promoted"][1]) or run["player"] is not seen["player"]:
        raise AssertionError(f"decoupled ppo: the player at iteration 2's rejected gate is not bitwise iteration "
                             f"1's promotion (rejected at {sorted(seen['rejected'])}, promoted at "
                             f"{sorted(seen['promoted'])})")
    out["ppo"] = {"reject": {k: rejects[0][k] for k in ("iter_num", "reason", "staleness", "escalate")},
                  "rollback": {k: rollbacks[0][k] for k in ("iter_num", "restored_iter", "retries_left")},
                  "gate": run["gate"], "final_staleness": last.get("Telemetry/param_staleness"),
                  "handoff_ms": run["handoff_ms"], "rows": len(run["metric_rows"]),
                  "final": run["metric_rows"][-1].tolist(), "seconds": time.monotonic() - t0,
                  "player_tensors": len(seen["promoted"][1]),
                  "player_bytes": sum(t.numel() * t.element_size() for t in seen["promoted"][1])}

    # one decoupled update over two trainer shards of the one card
    t0 = time.monotonic()
    three = [o for o in DECOUPLED_PPO_OVERRIDES if not o.startswith(("fabric.devices=", "algo.total_steps="))] + [
        "fabric.devices=3", "algo.total_steps=256", "checkpoint.save_last=False", f"root_dir={root / 'ppo_3'}",
        f"fabric.accelerator={device_name}", "run_name=chip_smoke_decoupled_ppo_3"]
    fused_layernorm_gru.launches = 0  # the main path starts here
    run = cli.run(three)
    out["launches"]["decoupled_ppo_3"] = fused_layernorm_gru.launches  # the main path ends here
    if (run["trainer_shards"] != 2 or not run["replicas_equal"] or run["gate"] != [(1, True)]
            or run["metric_rows"].shape[0] != 1 or not np.isfinite(run["metric_rows"]).all()
            or out["launches"]["decoupled_ppo_3"] != 0):
        raise AssertionError(f"decoupled ppo at fabric.devices=3: {run['trainer_shards']} trainer shards, replicas "
                             f"equal {run['replicas_equal']}, gate {run['gate']}, metric rows {run['metric_rows']}")
    out["ppo_3"] = {"trainer_shards": run["trainer_shards"], "updates": run["updates_per_iteration"],
                    "final": run["metric_rows"][-1].tolist(), "handoff_ms": run["handoff_ms"],
                    "seconds": time.monotonic() - t0}
    return out


def run_decoupled_sac(root: Path, device_name: str = "cuda") -> dict:
    """(3) ``run exp=sac_decoupled fabric.devices=2`` at the ``sac``
    preset's widths: finite metrics, every promotion handed to the player's
    actor, the trainer replicas bitwise equal, verified checkpoints with the
    Ratio, the replay and the global ``batch_size``; resumed from the
    mid-run one, which restores them and trains on."""
    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    overrides = DECOUPLED_SAC_OVERRIDES + [f"root_dir={root / 'sac'}", f"fabric.accelerator={device_name}"]
    out = {"launches": {}}
    t0 = time.monotonic()
    fused_layernorm_gru.launches = 0  # the main path starts here
    run = cli.run(overrides)
    out["launches"]["decoupled_sac"] = fused_layernorm_gru.launches  # the main path ends here
    ckpts = run["checkpoints"]
    saved = load_state(ckpts[0]) if ckpts else {}
    if (run["gradient_steps"] < 1 or not run["replicas_equal"] or not np.isfinite(run["metric_rows"]).all()
            or not all(promoted for _, promoted in run["gate"]) or len(run["handoff_ms"]) != len(run["gate"])
            or len(ckpts) != 2 or any(verify_checkpoint(c) != (True, "verified") for c in ckpts)
            or saved.get("batch_size") != int(run["family"].cfg.algo.per_rank_batch_size)
            or "ratio" not in saved or saved.get("rb") is None or out["launches"]["decoupled_sac"] != 0):
        raise AssertionError(f"decoupled sac: {run['gradient_steps']} gradient steps, replicas equal "
                             f"{run['replicas_equal']}, gate {run['gate']}, checkpoints {ckpts}, batch_size "
                             f"{saved.get('batch_size')}, {out['launches']['decoupled_sac']} ln_gru launches")
    fused_layernorm_gru.launches = 0  # the main path starts here
    resumed = cli.run(overrides + [f"checkpoint.resume_from={ckpts[0]}", f"root_dir={root / 'sac_resumed'}"])
    out["launches"]["decoupled_sac_resume"] = fused_layernorm_gru.launches  # the main path ends here
    if (resumed["start_iter"] != saved["iter_num"] + 1 or resumed["gradient_steps"] < 1 or not resumed["replicas_equal"]
            or not np.isfinite(resumed["metric_rows"]).all() or out["launches"]["decoupled_sac_resume"] != 0):
        raise AssertionError(f"decoupled sac resumed from {ckpts[0]}: start_iter {resumed['start_iter']} (saved "
                             f"iteration {saved['iter_num']}), {resumed['gradient_steps']} gradient steps")
    out["sac"] = {"iterations": run["iterations"], "gradient_steps": run["gradient_steps"],
                  "promotions": len(run["handoff_ms"]), "handoff_ms": run["handoff_ms"],
                  "final": run["metric_rows"][-1].tolist(), "checkpoint_batch_size": saved["batch_size"],
                  "resume_start_iter": resumed["start_iter"], "resume_gradient_steps": resumed["gradient_steps"],
                  "seconds": time.monotonic() - t0}
    return out


def run_decoupled(build_dir: Path, runner, device_name: str = "cuda") -> dict:
    """This slice's group, 45 s in all (``DECOUPLED_DEADLINES_S``): (1)
    ``python -m sheeprl_tpu_torch.tools.chaos_drill --drill
    trainer_exception`` as its ``main`` with no overrides (on the CPU the
    default list with ``fabric.accelerator=cpu``), in a thread, its CLI
    child (``chaos.drill_argv``'s) handed to ``runner`` (an interpreter of
    ``start_child_runners`` that made its imports before the group) and
    judged by ``chaos.judge_drill``; its LayerNorm-GRU launches counted
    from 0 in the child; while it runs, ``run_decoupled_ppo`` and
    ``run_decoupled_sac`` in this process."""
    from sheeprl_tpu_torch.resilience import chaos
    from sheeprl_tpu_torch.resilience.chaos import main as drill_cli  # the chaos_drill command's main
    from sheeprl_tpu_torch.resilience.supervisor import child_env

    root = (build_dir / "decoupled").resolve()
    shutil.rmtree(root, ignore_errors=True)
    (root / "drill").mkdir(parents=True)
    record = root / "drill_child.json"
    drill = {"printed": []}

    def tail() -> str:
        log = Path(f"{record}.log")
        return log.read_text()[-3000:] if log.exists() else "no child log"

    def drill_through_runner(schedule, overrides, run_dir_root="logs/runs", timeout_s=600.0):
        """``chaos.run_drill`` with its CLI child handed to the warm
        interpreter: the same argv after ``python -m sheeprl_tpu_torch``,
        run from the drill's directory, judged as the drill judges it."""
        argv = chaos.drill_argv(schedule, overrides)
        if argv[1:3] != ["-m", "sheeprl_tpu_torch"]:
            raise AssertionError(f"the drill's child: {argv[:3]}")
        proc = subprocess.run([sys.executable, "-c", _CHILD_HANDOFF, runner[0], str(record), *argv[3:]],
                              cwd=str(root / "drill"), env=child_env(), timeout=timeout_s,
                              stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        drill["verdict"] = chaos.judge_drill(schedule, proc.returncode, str(root / "drill" / run_dir_root))
        return drill["verdict"]

    def drill_main() -> None:
        argv = ["--drill", "trainer_exception"]
        if device_name != "cuda":
            argv += ["--", *chaos.DEFAULT_OVERRIDES, f"fabric.accelerator={device_name}"]
        drill["code"] = drill_cli(argv)

    _wait_ready([runner])
    t0 = time.monotonic()
    patches = [mock.patch.object(chaos, "run_drill", drill_through_runner),
               mock.patch.object(chaos, "print", lambda *a, **k: drill["printed"].append(" ".join(map(str, a))),
                                 create=True)]
    with deadline(DECOUPLED_DEADLINES_S["decoupled"], "decoupled", tail):
        for patch in patches:
            patch.start()
        try:
            thread = threading.Thread(target=drill_main, name="chaos_drill", daemon=True)
            thread.start()
            with deadline(DECOUPLED_DEADLINES_S["decoupled_ppo"], "decoupled_ppo"):
                out = run_decoupled_ppo(root, device_name)
            with deadline(DECOUPLED_DEADLINES_S["decoupled_sac"], "decoupled_sac"), bounded_dummy_actions():
                sac = run_decoupled_sac(root, device_name)
            in_process_s = time.monotonic() - t0
            thread.join()
        finally:
            for patch in patches:
                patch.stop()
    seconds = time.monotonic() - t0
    verdict = drill.get("verdict", {})
    child = json.loads(record.read_text()) if record.is_file() else {}
    if drill.get("code") != 0 or not verdict.get("ok") or child.get("exit_code") != 0 or child.get("launches") != 0:
        raise AssertionError(f"decoupled drill: main returned {drill.get('code')}, verdict {verdict}, child "
                             f"{child}\n" + "\n".join(drill["printed"]) + f"\n{tail()}")
    shutil.rmtree(root, ignore_errors=True)
    return {**out, "sac": sac["sac"], "launches": {**out["launches"], **sac["launches"],
                                                   "decoupled_drill": child["launches"]},
            "drill": {"checks": sorted(verdict["checks"]), "exit_code": verdict["exit_code"],
                      "checkpoint": Path(verdict["checks"]["final_checkpoint_verifies"]["detail"]["checkpoint"]).name,
                      "child_s": child["seconds"], "imports_s": child["imports_s"], "passed": drill["printed"][-1]},
            "seconds": seconds, "in_process_s": in_process_s}


def run_fsdp_step(device_name: str = "cuda") -> dict:
    """(2) One DreamerV3-S fp32 gradient step at ``fabric.fsdp=2`` (two
    shards of 8 sequences, each's optimizers cut for its model index)
    against one device's on the same 16-sequence batch and noise, held at
    ``PARALLEL_STEP_RTOL`` (``_two_shards_against_one``) with the update
    (parameters and gathered Adam state) against one device's, every
    update clipped (``FSDP_STEP_CLIP``), the same
    step with its draws from one generator (``dp.global_streams``, as the
    loop runs it), then the step at two data shards (``fsdp=1``): each's
    peak of allocated bytes above what the allocator held before the
    shards' step."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, make_train_step
    from sheeprl_tpu_torch.config import compose

    cfg = compose(PARALLEL_STEP_OVERRIDES + [f"fabric.accelerator={device_name}", f"fabric.fsdp={FSDP_AXIS}",
                                             f"fabric.devices={PARALLEL_SHARDS}"]
                  + [f"algo.{k}.clip_gradients={FSDP_STEP_CLIP}" for k in ("world_model", "actor", "critic")])
    _dv3_s_widths(cfg)
    fsdp = _two_shards_against_one(cfg, build_agent, make_train_step, METRIC_ORDER, 0.02, "DreamerV3-S FSDP",
                                   device_name, fsdp=FSDP_AXIS)
    drawn = _two_shards_against_one(cfg, build_agent, make_train_step, METRIC_ORDER, 0.02,
                                    "DreamerV3-S FSDP from one generator", device_name, fsdp=FSDP_AXIS,
                                    from_generator=True)
    dp = _two_shards_against_one(cfg, build_agent, make_train_step, METRIC_ORDER, 0.02, "DreamerV3-S", device_name)
    return {**fsdp, "dp_peak_bytes": dp["peak_bytes"], "dp_launches": dp["launches"], "dp_update": dp["update"],
            "from_generator": {k: drawn[k] for k in ("metric_rel_err", "moments_rel_err", "launches", "update")}}


def run_fsdp_resume(ckpt: str, root: Path, device_name: str = "cuda") -> dict:
    """(3) The child's partial-shard group resumed at ``fabric.devices=1
    fabric.fsdp=1`` through ``run``: the group reassembled, the agent and its
    whole optimizers loaded from it, the remaining iterations' player steps
    through the kernel (its launches counted from 0 around the run)."""
    import numpy as np

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.resilience.sharded import load_sharded_checkpoint

    overrides = [o for o in FSDP_DV3_OVERRIDES if not o.startswith(("fabric.devices=", "fabric.fsdp="))] + [
        "fabric.devices=1", "fabric.fsdp=1", f"fabric.accelerator={device_name}", f"root_dir={root / 'resumed'}",
        f"checkpoint.resume_from={ckpt}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg)
    saved = load_sharded_checkpoint(ckpt)
    fused_layernorm_gru.launches = 0  # the main path starts here
    out = cli.run(overrides)
    launches = fused_layernorm_gru.launches  # and ends here
    hidden = cfg.algo.world_model.recurrent_model.recurrent_state_size
    joint = hidden + cfg.algo.world_model.recurrent_model.dense_units
    predicted = out["player_steps"] * _launch_chunks(out["player_width"], hidden, joint)
    if (out["shards"] != 1 or out["start_iter"] != saved["iter_num"] + 1 or out["player_steps"] < 1
            or launches != predicted or not np.isfinite(out["metric_rows"]).all()):
        raise AssertionError(f"fsdp group resumed at one device from {ckpt}: start_iter {out['start_iter']} (saved "
                             f"iteration {saved['iter_num']}), shards {out['shards']}, player steps "
                             f"{out['player_steps']}, ln_gru launches {launches} (predicted {predicted})")
    return {"start_iter": out["start_iter"], "player_steps": out["player_steps"], "launches": launches,
            "predicted": predicted}


def run_fsdp(build_dir: Path, runner, device_name: str = "cuda") -> dict:
    """This slice's group, 45 s in all (``FSDP_DEADLINES_S``): (1) ``python
    -m sheeprl_tpu_torch run exp=dreamer_v3 fabric.devices=2 fabric.fsdp=2``
    at DreamerV3-S in a child handed to ``runner`` (an interpreter of
    ``start_child_runners`` that made its imports before the group), its
    LayerNorm-GRU launches (counted from 0 in the child) equal to 2 x 79 a
    gradient step plus the player's, its journal's ``fsdp_shard_map`` and
    ``sharding_audit``, its two-part checkpoint group verified file by file;
    while it runs, (2) ``run_fsdp_step`` in this process; then (3)
    ``run_fsdp_resume`` from the child's group."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.diagnostics.journal import read_journal
    from sheeprl_tpu_torch.resilience.coordination import group_status, rank_shard_path
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.resilience.sharded import partial_layout
    from sheeprl_tpu_torch.resilience.supervisor import child_env

    root = (build_dir / "fsdp").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    overrides = FSDP_DV3_OVERRIDES + [f"root_dir={root / 'dv3'}", f"fabric.accelerator={device_name}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg)
    record = root / "dv3_child.json"

    def tail() -> str:
        log = Path(f"{record}.log")
        return log.read_text()[-3000:] if log.exists() else "no child log"

    _wait_ready([runner])
    t0 = time.monotonic()
    with deadline(FSDP_DEADLINES_S["fsdp"], "fsdp", tail):
        proc = subprocess.Popen([sys.executable, "-c", _CHILD_HANDOFF, runner[0], str(record), "run", *overrides],
                                cwd=str(ROOT), env=child_env())
        atexit.register(proc.kill)  # a no-op once it has exited
        with deadline(FSDP_DEADLINES_S["fsdp_step"], "fsdp_step"):
            step = run_fsdp_step(device_name)
        in_process_s = time.monotonic() - t0
        rc = proc.wait()
        child_s = time.monotonic() - t0
        child = json.loads(record.read_text()) if record.is_file() else {"exit_code": rc}
        if rc != 0 or child.get("exit_code") != 0:
            raise AssertionError(f"fsdp DreamerV3-S child: exit {rc} / {child.get('exit_code')}\n{tail()}")
        ckpts = sorted((root / "dv3").rglob("ckpt_*_0.ckpt"))
        with deadline(FSDP_DEADLINES_S["fsdp_resume"], "fsdp_resume"):
            resumed = run_fsdp_resume(str(ckpts[0]), root, device_name) if len(ckpts) == 1 else None
    seconds = time.monotonic() - t0
    predicted = _child_launches(cfg, {**child, "gradient_steps": child["gradient_steps"] * PARALLEL_SHARDS})
    # the child's run directory (the resumed run keeps the archived root_dir)
    events = read_journal(str(ckpts[0].parent.parent / "journal.jsonl")) if ckpts else [{}]
    maps = [e for e in events if e["event"] == "fsdp_shard_map"]
    audits = [e for e in events if e["event"] == "sharding_audit"]
    group = [rank_shard_path(str(ckpts[0]), r) for r in range(FSDP_AXIS)] if len(ckpts) == 1 else []
    layout = partial_layout(group[0]) if group else None
    if (child["shards"] != PARALLEL_SHARDS or child["gradient_steps"] < 1 or child["launches"] != predicted
            or len(maps) != 1 or maps[0]["axis_size"] != FSDP_AXIS or len(audits) != 1
            or events[-1].get("status") != "completed" or resumed is None or not layout
            or any(verify_checkpoint(f) != (True, "verified") for f in group)
            or group_status(group[0]) != (True, "group_verified")):
        raise AssertionError(f"fsdp DreamerV3-S child: {child['shards']} shards, {child['gradient_steps']} gradient "
                             f"steps, {child['launches']} ln_gru launches (predicted {predicted}), shard maps {maps}, "
                             f"audits {len(audits)}, checkpoints {ckpts}, run_end {events[-1]}")
    sizes = {Path(f).name: os.path.getsize(f) for f in group}
    shutil.rmtree(root, ignore_errors=True)
    return {"child": child, "predicted": predicted, "per_gradient_step": PARALLEL_SHARDS * MINEDOJO_LAUNCHES_PER_STEP,
            "shard_map": {k: maps[0][k] for k in ("axis_size", "min_shard_bytes", "trees", "held_bytes_per_device")},
            "audit": {k: audits[0].get(k) for k in ("n_shards", "n_leaves", "total_bytes", "total_bytes_per_device",
                                                    "flagged_replicated", "hint")},
            "group": sizes, "sliced_leaves": len(layout), "step": step, "resumed": resumed, "seconds": seconds,
            "in_process_s": in_process_s, "child_s": child_s,
            "launches": {"fsdp_dv3": child["launches"], "fsdp_step": step["launches"],
                         "fsdp_dp_step": step["dp_launches"], "fsdp_generator_step": step["from_generator"]["launches"],
                         "fsdp_resume": resumed["launches"]}}


def _torchrun_env(port: int, rank: int) -> dict:
    """torchrun's variables for rank ``rank`` of ``MULTIHOST_RANKS`` on a
    localhost port: what ``parallel/runtime.py`` joins its gloo group from;
    the ranks share one host, so gloo's interface is the loopback (not the
    one the host's name resolves to)."""
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
            "WORLD_SIZE": str(MULTIHOST_RANKS), "GLOO_SOCKET_IFNAME": "lo"}


def _multihost_step_inputs(cfg, device_name: str) -> dict:
    """The two-rank step's weights, global batch and noise, made alike in
    every process from the seeds ``_two_shards_against_one`` uses: the
    agent from ``cfg.seed``, the batch and the decisive noise from one
    generator, both cut into the ranks' blocks."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.step_profile import synthetic_batch
    from sheeprl_tpu_torch.algos.ppo.agent import actions_dim_of
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.parallel.dp import split

    device = torch.device(device_name)
    env = make_env(cfg, cfg.seed, 0)()
    obs_space, (actions_dim, is_continuous, _) = env.observation_space, actions_dim_of(env.action_space)
    env.close()
    T, B = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size
    gen = torch.Generator(device=device).manual_seed(13)
    batch = synthetic_batch(cfg, actions_dim, gen, device)
    noise = _decisive(_train_noise(cfg, actions_dim, gen, device_name), gen)
    return {"agent": build_agent(actions_dim, is_continuous, cfg, obs_space, None, device),
            "is_continuous": is_continuous, "blocks": split(batch, MULTIHOST_RANKS, 1),
            "noise": _parallel_noise(noise, T, B, MULTIHOST_RANKS), "device": device}


def _state_digests(objs) -> list:
    """The sha256 of every tensor of ``objs``' state (``dp.state_tensors``'
    order: parameters, buffers, optimizer state), read on the host."""
    import hashlib

    from sheeprl_tpu_torch.parallel.dp import state_tensors

    import torch

    return [hashlib.sha256(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()).hexdigest()
            for t in state_tensors(objs)]


def _multihost_step_overrides(device_name: str) -> list:
    """The two-rank step's config: the parallel group's step at DreamerV3-S
    over ``MULTIHOST_RANKS`` shards, one a process."""
    return PARALLEL_STEP_OVERRIDES + [f"fabric.accelerator={device_name}", "fabric.num_nodes=2",
                                      f"fabric.devices={MULTIHOST_RANKS}"]


def multihost_step_rank(record: str, device_name: str, overrides: list) -> None:
    """One rank of the two-rank DreamerV3-S fp32 gradient step, in a process
    ``run_multihost`` starts with torchrun's variables: the ``Runtime``
    joins the gloo group (one shard a rank, both on ``cuda:0``), the rank
    runs its global shard's block of the step's batch and noise through
    ``run_shards`` (its collectives crossing the processes), and writes its
    state's digests, metrics, Moments, LayerNorm-GRU launches and seconds
    to ``record``."""
    t0 = time.monotonic()
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru
    from sheeprl_tpu_torch.parallel.dp import run_shards
    from sheeprl_tpu_torch.parallel.runtime import Runtime

    from sheeprl_tpu_torch.config import compose

    imports_s = time.monotonic() - t0
    cfg = compose(overrides)
    runtime = Runtime(devices=MULTIHOST_RANKS, num_nodes=2, accelerator=device_name)
    inputs = _multihost_step_inputs(cfg, device_name)
    agent, shard = inputs["agent"], runtime.shard_offset
    optimizers = make_optimizers(cfg, agent)
    step = make_train_step(agent, optimizers, cfg, inputs["is_continuous"])
    runtime.barrier()
    fused_layernorm_gru.launches = 0  # the steps' launches start here
    moments, step_s = agent.initial_moments(inputs["device"]), []
    for _ in range(MULTIHOST_STEPS):
        t1 = time.monotonic()
        ((moments, metrics),) = run_shards([step.body(moments, inputs["blocks"][shard], 0.02, None,
                                                      inputs["noise"][shard])])
        if inputs["device"].type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
    launches = fused_layernorm_gru.launches  # and end here
    out = {"rank": runtime.global_rank, "shard": shard, "digests": _state_digests([*agent, *optimizers.values()]),
           "metrics": metrics.cpu().tolist(), "moments": {k: float(v) for k, v in moments.items()},
           "launches": launches, "step_s": step_s, "imports_s": imports_s, "seconds": time.monotonic() - t0}
    with open(record, "w") as fp:
        json.dump(out, fp)
    runtime.barrier()


def multihost_step_reference(cfg, device_name: str = "cuda") -> dict:
    """The one-process two-shard step the two ranks are held to: the same
    weights, blocks and noise over two shards of this process on the one
    card, each shard's digests, metrics and Moments."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
    from sheeprl_tpu_torch.parallel.dp import run_shards
    from sheeprl_tpu_torch.parallel.mesh import replicate

    inputs = _multihost_step_inputs(cfg, device_name)
    device = inputs["device"]
    shards = replicate(inputs["agent"], [device] * MULTIHOST_RANKS)
    optimizers = [make_optimizers(cfg, a) for a in shards]
    steps = [make_train_step(a, o, cfg, inputs["is_continuous"]) for a, o in zip(shards, optimizers)]
    moments, step_s = [a.initial_moments(device) for a in shards], []
    for _ in range(MULTIHOST_STEPS):
        t1 = time.monotonic()
        outs = run_shards([step.body(mo, block, 0.02, None, noise)
                           for step, mo, block, noise in zip(steps, moments, inputs["blocks"], inputs["noise"])])
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        moments = [mo for mo, _ in outs]
    return {"digests": [_state_digests([*a, *o.values()]) for a, o in zip(shards, optimizers)],
            "metrics": [m.cpu().tolist() for _, m in outs], "step_s": step_s}


def _trees_equal(a, b) -> bool:
    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    x, y = np.asarray(a), np.asarray(b)
    return x.shape == y.shape and x.dtype == y.dtype and x.tobytes() == y.tobytes()


def run_multihost(build_dir: Path, runners: list, device_name: str = "cuda") -> dict:
    """This slice's group, 45 s in all (``MULTIHOST_DEADLINES_S``): (1) two
    ranks of ``python -m sheeprl_tpu_torch run exp=dreamer_v3
    fabric.num_nodes=2`` at DreamerV3-S (``MULTIHOST_DV3_OVERRIDES``), one
    shard a rank on the one card, each handed to one of ``runners`` (the
    interpreters of ``start_child_runners``, which made their imports before
    the group) with torchrun's variables on a free port: each rank's
    LayerNorm-GRU launches (counted from 0 in its process) equal to 79 a
    gradient step plus its player's, one ``version_0``, the last
    coordinated group of two files complete (``group_status``) and each
    file verified, the two ranks' parameters, optimizer state and Moments
    in it bitwise equal; while they run, (2) two ranks of one DreamerV3-S
    fp32 gradient step (``multihost_step_rank``, fresh processes) against
    the one-process two-shard step on the same blocks and noise in this
    process (``multihost_step_reference``): every state tensor's digest and
    the metrics bitwise equal, else the metrics within
    ``PARALLEL_STEP_RTOL`` with the tensors that differ named."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.resilience.coordination import group_status, rank_shard_path
    from sheeprl_tpu_torch.resilience.manifest import verify_checkpoint
    from sheeprl_tpu_torch.resilience.supervisor import child_env
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    root = (build_dir / "multihost").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    overrides = MULTIHOST_DV3_OVERRIDES + [f"root_dir={root / 'dv3'}", f"fabric.accelerator={device_name}"]
    cfg = compose(overrides)
    _dv3_s_widths(cfg)
    step_overrides = _multihost_step_overrides(device_name)
    step_cfg = compose(step_overrides)
    _dv3_s_widths(step_cfg)
    records = [root / f"dv3_rank{r}.json" for r in range(MULTIHOST_RANKS)]
    step_records = [root / f"step_rank{r}.json" for r in range(MULTIHOST_RANKS)]

    def tail() -> str:
        logs = [Path(f"{r}.log") for r in records] + [root / f"step_rank{r}.log" for r in range(MULTIHOST_RANKS)]
        return "\n".join(f"--- {log.name}\n{log.read_text()[-2000:]}" for log in logs if log.exists())

    _wait_ready(runners)
    t0 = time.monotonic()
    port, step_port = _free_port(), _free_port()
    with deadline(MULTIHOST_DEADLINES_S["multihost"], "multihost", tail):
        ranks = [subprocess.Popen([sys.executable, "-c", _CHILD_HANDOFF, runner[0], str(record), "run", *overrides],
                                  cwd=str(ROOT), env={**child_env(), **_torchrun_env(port, r)})
                 for r, (runner, record) in enumerate(zip(runners, records))]
        step_logs = [open(root / f"step_rank{r}.log", "w") for r in range(MULTIHOST_RANKS)]
        step_ranks = [subprocess.Popen([sys.executable, "-c", _MULTIHOST_STEP, str(ROOT), str(record), device_name,
                                        json.dumps(step_overrides)],
                                       cwd=str(ROOT), env={**child_env(), **_torchrun_env(step_port, r)},
                                       stdout=log, stderr=subprocess.STDOUT)
                      for r, (record, log) in enumerate(zip(step_records, step_logs))]
        for proc in ranks + step_ranks:
            atexit.register(proc.kill)  # a no-op once it has exited
        with deadline(MULTIHOST_DEADLINES_S["multihost_step"], "multihost_step", tail):
            reference = multihost_step_reference(step_cfg, device_name)
            step_rcs = [p.wait() for p in step_ranks]
        in_process_s = time.monotonic() - t0
        for log in step_logs:
            log.close()
        rcs = [p.wait() for p in ranks]
    seconds = time.monotonic() - t0
    children = [json.loads(r.read_text()) if r.is_file() else {"exit_code": rc} for r, rc in zip(records, rcs)]
    if any(rcs) or any(c.get("exit_code") != 0 for c in children) or any(step_rcs) or \
            not all(r.is_file() for r in step_records):
        raise AssertionError(f"multihost ranks: exit codes {rcs} / {[c.get('exit_code') for c in children]}, step "
                             f"ranks {step_rcs}\n{tail()}")
    predicted = [_child_launches(cfg, c) for c in children]
    base = root / "dv3" / cfg.run_name
    versions = sorted(d.name for d in base.iterdir() if d.name.startswith("version_"))
    last = max(base.glob("version_0/checkpoint/ckpt_*_0.ckpt"), key=lambda p: int(p.name.split("_")[1]))
    group = [rank_shard_path(str(last), r) for r in range(MULTIHOST_RANKS)]
    states = [load_state(f) for f in group]
    keys = ("world_model", "actor", "critic", "target_critic", "opt_states", "moments")
    ranks_equal = all(_trees_equal(states[0][k], s[k]) for s in states[1:] for k in keys)
    if (versions != ["version_0"] or [c["launches"] for c in children] != predicted
            or any(c["shards"] != 1 or c["gradient_steps"] < 1 for c in children)
            or any(verify_checkpoint(f) != (True, "verified") for f in group)
            or group_status(group[0]) != (True, "group_verified") or not ranks_equal):
        raise AssertionError(f"multihost DreamerV3-S ranks: versions {versions}, launches "
                             f"{[c['launches'] for c in children]} (predicted {predicted}), shards "
                             f"{[c['shards'] for c in children]}, gradient steps "
                             f"{[c['gradient_steps'] for c in children]}, group {group} "
                             f"{group_status(group[0])}, ranks equal {ranks_equal}")
    # the two-rank step against the one-process two-shard step
    import numpy as np

    steps = sorted((json.loads(r.read_text()) for r in step_records), key=lambda s: s["shard"])
    bitwise = all(s["digests"] == reference["digests"][s["shard"]] and s["metrics"] == reference["metrics"][s["shard"]]
                  for s in steps)
    want, got = np.asarray(reference["metrics"][0]), np.asarray(steps[0]["metrics"])
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-3)))
    differ = [i for i, (a, b) in enumerate(zip(steps[0]["digests"], reference["digests"][0])) if a != b]
    hidden = step_cfg.algo.world_model.recurrent_model.recurrent_state_size
    joint = hidden + step_cfg.algo.world_model.recurrent_model.dense_units
    T, B, H = step_cfg.algo.per_rank_sequence_length, step_cfg.algo.per_rank_batch_size, step_cfg.algo.horizon
    per_rank = MULTIHOST_STEPS * (T * _launch_chunks(B // MULTIHOST_RANKS, hidden, joint) + H * _launch_chunks(
        T * B // MULTIHOST_RANKS, hidden, joint))
    if (steps[0]["digests"] != steps[1]["digests"] or steps[0]["metrics"] != steps[1]["metrics"]
            or any(s["launches"] != per_rank for s in steps) or not np.isfinite(got).all()
            or (not bitwise and rel > PARALLEL_STEP_RTOL)):
        raise AssertionError(f"two-rank DreamerV3-S step: ranks' states equal "
                             f"{steps[0]['digests'] == steps[1]['digests']}, launches "
                             f"{[s['launches'] for s in steps]} (predicted {per_rank}), bitwise to one process "
                             f"{bitwise}, metrics relative error {rel} (tol {PARALLEL_STEP_RTOL}), differing tensors "
                             f"{differ[:20]}")
    sizes = {Path(f).name: os.path.getsize(f) for f in group}
    shutil.rmtree(root, ignore_errors=True)
    return {"children": children, "predicted": predicted, "versions": versions, "group": sizes,
            "group_step": int(last.name.split("_")[1]), "ranks_equal": ranks_equal,
            "step": {"bitwise": bitwise, "metric_rel_err": rel, "differing_tensors": len(differ),
                     "tensors": len(steps[0]["digests"]), "launches": [s["launches"] for s in steps],
                     "per_rank": per_rank, "step_s": [[round(t, 4) for t in s["step_s"]] for s in steps],
                     "one_process_step_s": [round(t, 4) for t in reference["step_s"]],
                     "imports_s": [round(s["imports_s"], 1) for s in steps],
                     "rank_s": [round(s["seconds"], 1) for s in steps]},
            "seconds": seconds, "in_process_s": in_process_s,
            "launches": {**{f"multihost_rank{r}": c["launches"] for r, c in enumerate(children)},
                         **{f"multihost_step_rank{s['rank']}": s["launches"] for s in steps}}}


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
        resumed = cli.run(overrides + [f"checkpoint.resume_from={out['checkpoints'][0]}", "algo.run_test=False",
                                       "diagnostics.telemetry.mfu.cost_analysis=False"])
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

    overrides = SAC_OVERRIDES + [f"root_dir={(build_dir / 'sac').resolve()}", f"fabric.accelerator={device_name}"]
    out = _off_policy_run(overrides, "sac")
    ckpt = out["run"]["checkpoints"][-1]
    cfg, ckpt_path, device = cli.serve_config([f"checkpoint_path={ckpt}", "serving.port=0",
                                               "serving.batch_buckets=[4,8]", "serving.max_delay_ms=5.0",
                                               f"fabric.accelerator={device_name}"])
    fused_layernorm_gru.launches = 0
    app = _serve_app(cfg, ckpt_path, device)
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

    overrides = DROQ_OVERRIDES + [f"root_dir={(build_dir / 'droq').resolve()}", f"fabric.accelerator={device_name}"]
    out = _off_policy_run(overrides, "droq")
    cfg, path, device = cli.serve_config([f"checkpoint_path={out['run']['checkpoints'][-1]}",
                                          f"fabric.accelerator={device_name}"])
    try:
        _serve_app(cfg, path, device).close()
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
        _serve_app(cfg, path, device).close()
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
        overrides + [f"checkpoint.resume_from={out['checkpoints'][0]}", "run_name=chip_smoke_offline_resume",
                     "diagnostics.telemetry.mfu.cost_analysis=False"],
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
    ``rssm_chunks=1`` step and the chunked bf16 one, each built as the
    default diagnostics run it (the
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
        # each step as the default diagnostics run it (the turns with them
        # off, and the comparison of the two, were cut to fit the call)
        for turn, diagnostics in ((1, True),):
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

    overrides = run["overrides"] + [f"checkpoint.resume_from={run['mid_checkpoint']}", "checkpoint.every=100000",
                                    "diagnostics.telemetry.mfu.cost_analysis=False"]
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
        app = _serve_app(cfg, ckpt_path, device)
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
    """``exp=ppo_recurrent``'s widths (its 8 epochs are depth: the smoke
    cuts them to 2)."""
    algo = cfg.algo
    widths = (cfg.env.num_envs, algo.rollout_steps, algo.per_rank_sequence_length, algo.per_rank_num_batches,
              algo.rnn.lstm.hidden_size, algo.encoder.dense_units, algo.max_grad_norm,
              str(algo.optimizer["_target_"]), cfg.fabric.precision)
    if widths != (16, 512, 16, 8, 64, 64, 0.5, "optax.adamw", "32-true"):
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
    resumed = cli.run(overrides + [f"checkpoint.resume_from={first}", "algo.run_test=False", "diagnostics.telemetry.mfu.cost_analysis=False",
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
    app = _serve_app(serve_cfg, ckpt_path, device)
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


def _time_phases() -> None:
    """Every ``run_*`` phase of this module prints its own wall time as it
    ends (``[phase-time]``), whether it passed or raised."""
    import functools

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                print(f"[phase-time] {name}: {time.monotonic() - t0:.1f} s", flush=True)
        return wrapper

    for name, fn in list(globals().items()):
        if name.startswith("run_") and callable(fn) and not hasattr(fn, "__wrapped__"):
            globals()[name] = timed(name, fn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from sheeprl_tpu_torch.ops import cuda_build

    build_dir = ROOT / "build" / "chip_smoke"
    build_dir.mkdir(parents=True, exist_ok=True)
    # the card machine's interpreter writes no bytecode
    # (PYTHONDONTWRITEBYTECODE) and keeps none beside its packages, so each
    # Python process the smoke starts compiled what it imported anew: a CLI
    # child's imports took 21.7 s there, 10.5 s from a cache.  They share
    # one cache under build/, warmed here by the resilience children's
    # interpreters, which start now
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(build_dir / "pycache")
    # two for the resilience group's children, one each for the parallel,
    # parallel_families, decoupled and fsdp groups, two for the multihost
    # group's ranks
    runners = start_child_runners(build_dir, count=8)
    lint = start_lint(build_dir)
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; nvidia-smi name,power.limit:", flush=True)
    print(card, flush=True)

    # the wall time of each group of phases, printed as the group ends (a
    # call cut short still shows where its time went) and again, all of
    # them, before the kernels line; each phase's own time as it ends
    stamps = [("start", time.monotonic())]

    def mark(done: str) -> None:
        stamps.append((done, time.monotonic()))
        print(f"[timing] {done}: {stamps[-1][1] - stamps[-2][1]:.1f} s; total {stamps[-1][1] - stamps[0][1]:.1f} s",
              flush=True)

    _time_phases()

    t0 = time.monotonic()
    report = cuda_build.build()
    print(f"[build] {len(report)} kernel(s) in {time.monotonic() - t0:.1f} s", flush=True)
    for name, rep in report.items():
        print(f"[build] {name}: {rep['path']} ({rep['seconds']:.1f} s)", flush=True)
        for line in _ptxas_summary(str(rep["ptxas"])):
            print(f"[build] {name} ptxas {line}", flush=True)

    mark("build")
    linted = run_lint(lint)
    print(f"[lint] python -m sheeprl_tpu_torch.tools.sheeprl_lint over the checkout: no finding outside its "
          f"baseline ({linted['suppressed']} baselined, none stale), families {', '.join(linted['families'])}; "
          f"the lint process loaded neither torch nor jax", flush=True)
    print(f"[lint] seconds: {linted['seconds']:.2f} (its passes {linted['elapsed_in_lint']:.2f}; deadline "
          f"{LINT_DEADLINE_S:g} s, started beside the kernel build)  [{card}]", flush=True)
    mark("lint")
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
    # this slice's group runs here, once its children's interpreters made
    # their imports (during the build and the kernel cases)
    resilience = run_resilience(build_dir, runners[:2])
    shutil.rmtree(build_dir / "resilience", ignore_errors=True)
    print(f"[resilience] supervised DreamerV3-S children (batch 16 x 64, horizon 15, fp32), chaos schedule "
          f"{json.dumps(RESILIENCE_SCHEDULE)}, slow_write_s {RESILIENCE_SLOW_WRITE_S}: child exits "
          f"{[c['exit_code'] for c in resilience['children']]}; gradient steps "
          f"{[c['gradient_steps'] for c in resilience['children']]}, player calls "
          f"{[c['player_calls'] for c in resilience['children']]}, ln_gru launches {resilience['launches']} = "
          f"predicted {resilience['predicted']}; drill checks {resilience['checks']} held; the slow ckpt_end "
          f"{json.dumps(resilience['slow_ckpt_end'])}; restart row {json.dumps(resilience['restart'])} resumed from "
          f"{resilience['resumed_from']} (first logged step {resilience['first_resumed_step']}), completed; "
          f"goodput_report: {json.dumps(resilience['supervisor'])}; run_monitor {resilience['monitor_lines']} lines; "
          f"health_diff in band against itself, {resilience['regressions']} regressions at zero tolerance against "
          f"the other child; children {resilience['children_s']:.1f} s (each {[c['seconds'] for c in resilience['children']]}"
          f" s from its request to its exit; run_start, first env step, run_end at {resilience['timeline']} s from "
          f"then; each interpreter's imports, made before the group: "
          f"{[c['imports_s'] for c in resilience['children']]} s), reports "
          f"{resilience['reports_s']:.1f} s  "
          f"[{card}]", flush=True)

    mark('resilience')
    parallel = run_parallel(build_dir, runners[2])
    child, pstep = parallel["child"], parallel["step"]
    print(f"[parallel] python -m sheeprl_tpu_torch run exp=dreamer_v3 fabric.devices=2 (DreamerV3-S, batch 16 x 64 "
          f"a shard, horizon 15, fp32, both shards on the one card, each with its replica): {child['shards']} shard "
          f"steps built, {child['gradient_steps']} gradient steps, player calls {child['player_calls']}, ln_gru "
          f"launches {child['launches']} = predicted {parallel['predicted']} ({parallel['per_gradient_step']} a "
          f"gradient step: the dynamic scan and the imagination once a shard); sharding_audit "
          f"{json.dumps(parallel['audit'])}; the child {child['seconds']} s (imports made before the group, "
          f"{child['imports_s']} s)  [{card}]", flush=True)
    print(f"[parallel] one DreamerV3-S fp32 gradient step over 2 shards of {pstep['shard_batch']} sequences against "
          f"one device's on the same {pstep['batch']}-sequence batch and noise (noise deciding every draw): metrics max "
          f"relative error {pstep['metric_rel_err']:.3g}, Moments low/high {pstep['moments_rel_err']:.3g} (tol "
          f"{PARALLEL_STEP_RTOL:g}: fp32 sums in another order); the shards' metrics and replicas bitwise equal; "
          f"ln_gru launches {pstep['launches']} = predicted {pstep['predicted']} (79 + 2 x {pstep['per_shard']}); "
          f"{pstep['seconds']:.2f} s  [{card}]", flush=True)
    _print_update("parallel", "two-shard DreamerV3-S", pstep["update"], card)
    for name in ("ppo", "sac"):
        row = parallel[name]
        print(f"[parallel] run exp={name} fabric.devices=2 ({' '.join(o for o in (PARALLEL_PPO_OVERRIDES if name == 'ppo' else PARALLEL_SAC_OVERRIDES) if o.startswith(('env.num_envs', 'algo.')))}): "
              f"{row['iterations']} iterations, {row['rows']} metric rows, final {row['final']}, replicas bitwise "
              f"equal, checkpoint batch_size {row['checkpoint_batch_size']} (the global batch); resumed at "
              f"fabric.devices=1 from the two-shard mid-run checkpoint at iteration {row['resume_start_iter']}, "
              f"{row['resume_rows']} metric rows; {row['seconds']:.1f} s  [{card}]", flush=True)
    versus = parallel["ppo_card_vs_cpu"]
    print(f"[parallel] two-shard PPO update ({versus['updates']} minibatch updates a shard) from the mid-run "
          f"checkpoint on the card against the same two-shard update on the CPU: metrics max relative error "
          f"{versus['metric_rel_err']:.3g} (tol {PARALLEL_CARD_CPU_RTOL:g}), parameters max_abs_err "
          f"{versus['param_max_abs_err']:.3g} (tol {PARALLEL_CARD_CPU_ATOL:g}), each side's replicas bitwise equal  "
          f"[{card}]", flush=True)
    print(f"[parallel] group {parallel['seconds']:.1f} s of its {PARALLEL_DEADLINES_S['parallel']:g} s (in this "
          f"process {parallel['in_process_s']:.1f} s beside the child)  [{card}]", flush=True)

    mark('parallel')
    families = run_parallel_families(build_dir, runners[3])
    child, fstep, offline_dp, ring = families["child"], families["step"], families["offline"], families["ring"]
    print(f"[parallel_families] python -m sheeprl_tpu_torch run exp=p2e_dv2_exploration fabric.devices=2 (recurrent "
          f"400, dense 400, K=800, ensembles 10 x 400 x 4, batch 16 x 50 a shard, horizon 15, fp32, both shards on "
          f"the one card): {child['shards']} shard steps built, {child['gradient_steps']} gradient steps, player "
          f"calls {child['player_calls']}, ln_gru launches {child['launches']} = predicted {families['predicted']} "
          f"({families['per_gradient_step']} a gradient step: the dynamic scan and both imaginations once a "
          f"shard); sharding_audit {json.dumps(families['audit'])}; the child {child['seconds']} s (imports made "
          f"before the group, {child['imports_s']} s)  [{card}]", flush=True)
    print(f"[parallel_families] one DreamerV2 fp32 gradient step (exp=dreamer_v2's widths) over 2 shards of "
          f"{fstep['shard_batch']} sequences against one device's on the same {fstep['batch']} x 50 batch and noise "
          f"(noise deciding every draw): metrics max relative error {fstep['metric_rel_err']:.3g} (tol "
          f"{PARALLEL_STEP_RTOL:g}); the shards' metrics and replicas bitwise equal; ln_gru launches "
          f"{fstep['launches']} = predicted {fstep['predicted']} ({fstep['one_device']} + 2 x {fstep['per_shard']}); "
          f"{fstep['seconds']:.2f} s  [{card}]", flush=True)
    _print_update("parallel_families", "two-shard DreamerV2", fstep["update"], card)
    for name in ("dv3", "sac"):
        row = offline_dp[name]
        print(f"[parallel_families] offline {'DreamerV3-S' if name == 'dv3' else 'SAC (cql_alpha=1)'} over 2 "
              f"shards through run on a dataset written here ({row['dataset']['rows']} rows): "
              f"{row['gradient_steps']} gradient steps of a {row['global_batch']}-wide global batch, replicas bitwise "
              f"equal, checkpoints verified with the global batch_size; ln_gru launches {row['launches']} = "
              f"predicted {row['predicted']} ({row['per_gradient_step']} a gradient step); final {row['final']}; "
              f"{row['seconds']:.1f} s  [{card}]", flush=True)
    versus = offline_dp["sac_card_vs_cpu"]
    print(f"[parallel_families] two-shard offline SAC call ({versus['gradient_steps']} gradient steps of "
          f"{versus['shard_rows']} rows a shard, {versus['cql_samples']} penalty proposals) from its checkpoint on "
          f"the card against the CPU: metrics max relative error {versus['metric_rel_err']:.3g} (tol "
          f"{PARALLEL_CARD_CPU_RTOL:g}), parameters max_abs_err {versus['param_max_abs_err']:.3g} (tol "
          f"{PARALLEL_CARD_CPU_ATOL:g}), each side's replicas bitwise equal  [{card}]", flush=True)
    print(f"[parallel_families] env-sharded ring over 2 shards ({ring['envs']} envs of DreamerV3-S's record): two "
          f"draws of 16 windows of 64 on the card bitwise the CPU ring's from the same seed, each shard's block on "
          f"its device {json.dumps(ring['block_shapes'])}; {ring['seconds']:.3f} s  [{card}]", flush=True)
    print(f"[parallel_families] group {families['seconds']:.1f} s of its "
          f"{PARALLEL_FAMILIES_DEADLINES_S['parallel_families']:g} s (in this process {families['in_process_s']:.1f} s "
          f"beside the child)  [{card}]", flush=True)

    mark('parallel_families')
    decoupled = run_decoupled(build_dir, runners[4])
    drill_row, ppo_d, sac_d, ppo_3 = decoupled["drill"], decoupled["ppo"], decoupled["sac"], decoupled["ppo_3"]
    print(f"[decoupled] python -m sheeprl_tpu_torch.tools.chaos_drill --drill trainer_exception with no overrides (the "
          f"default workload: exp=ppo_decoupled fabric.devices=2, the player and the trainer both on the one card): "
          f"{drill_row['passed']}, exit {drill_row['exit_code']}, checks {drill_row['checks']} held (fault_injection "
          f"-> rollback -> run_end), final checkpoint {drill_row['checkpoint']} verified; ln_gru launches "
          f"{decoupled['launches']['decoupled_drill']} = predicted 0; the child {drill_row['child_s']} s (imports made "
          f"before the group, {drill_row['imports_s']} s)  [{card}]", flush=True)
    print(f"[decoupled] run exp=ppo_decoupled fabric.devices=2 (dense 64 x 2 on state, batch 64, 4 envs x 64 steps, 2 "
          f"epochs; nan_grads at iteration 2, sentinel halt): params_reject {json.dumps(ppo_d['reject'])}, rollback "
          f"{json.dumps(ppo_d['rollback'])}; gate {ppo_d['gate']}; the player's {ppo_d['player_tensors']} tensors at "
          f"iteration 2 bitwise iteration 1's promotion; final Telemetry/param_staleness {ppo_d['final_staleness']}; "
          f"run_end completed, {ppo_d['rows']} metric rows, final {ppo_d['final']}; ln_gru launches "
          f"{decoupled['launches']['decoupled_ppo']} = predicted 0; {ppo_d['seconds']:.1f} s  [{card}]", flush=True)
    handoffs = ppo_d["handoff_ms"] + ppo_3["handoff_ms"]
    print(f"[decoupled] player/trainer hand-off a promotion (the trainer's shard-0 replica copied into the player's "
          f"own agent, {ppo_d['player_bytes']} bytes, a copy within cuda:0 on the one card): "
          f"{[round(x, 4) for x in handoffs]} ms, median {statistics.median(handoffs):.4f} ms (host clock around the "
          f"copy and a synchronize); SAC's actor hand-offs {[round(x, 4) for x in sac_d['handoff_ms'][:8]]} ms, median "
          f"{statistics.median(sac_d['handoff_ms']):.4f} ms over {sac_d['promotions']}  [{card}]", flush=True)
    print(f"[decoupled] run exp=sac_decoupled fabric.devices=2 (hidden 256, batch 256, 4 envs, actions bounded to "
          f"[-1, 1]): {sac_d['iterations']} iterations, {sac_d['gradient_steps']} gradient steps, {sac_d['promotions']} "
          f"promotions of the actor, final {sac_d['final']}, trainer replicas bitwise equal, checkpoint batch_size "
          f"{sac_d['checkpoint_batch_size']}; resumed at iteration {sac_d['resume_start_iter']}, "
          f"{sac_d['resume_gradient_steps']} gradient steps; ln_gru launches {decoupled['launches']['decoupled_sac']} "
          f"and {decoupled['launches']['decoupled_sac_resume']} = predicted 0; {sac_d['seconds']:.1f} s  [{card}]",
          flush=True)
    print(f"[decoupled] one decoupled PPO update at fabric.devices=3 (the player and {ppo_3['trainer_shards']} "
          f"trainer shards on the one card, {ppo_3['updates']} minibatch updates a shard): the trainer replicas "
          f"bitwise equal after it, promoted; final {ppo_3['final']}; ln_gru launches "
          f"{decoupled['launches']['decoupled_ppo_3']} = predicted 0  [{card}]", flush=True)
    print(f"[decoupled] group {decoupled['seconds']:.1f} s of its {DECOUPLED_DEADLINES_S['decoupled']:g} s (in this "
          f"process {decoupled['in_process_s']:.1f} s beside the drill's child)  [{card}]", flush=True)

    mark('decoupled')
    fsdp = run_fsdp(build_dir, runners[5])
    child, fstep, fmap = fsdp["child"], fsdp["step"], fsdp["shard_map"]
    print(f"[fsdp] python -m sheeprl_tpu_torch run exp=dreamer_v3 fabric.devices=2 fabric.fsdp=2 (DreamerV3-S, batch "
          f"16 x 64 a shard, horizon 15, fp32, (data, model) = (1, 2), both shards on the one card): {child['shards']} "
          f"shard steps built, {child['gradient_steps']} gradient steps, player calls {child['player_calls']}, ln_gru "
          f"launches {child['launches']} = predicted {fsdp['predicted']} ({fsdp['per_gradient_step']} a gradient "
          f"step: the dynamic scan and the imagination once a shard, on the gathered weight); the child "
          f"{child['seconds']} s (imports made before the group, {child['imports_s']} s)  [{card}]", flush=True)
    print(f"[fsdp] fsdp_shard_map (the rule's layout, a checkpoint group's): axis_size {fmap['axis_size']}, "
          f"min_shard_bytes {fmap['min_shard_bytes']}, {json.dumps(fmap['trees'])}; the bytes a shard holds between "
          f"steps (its slices of the parameters and the optimizer state) {json.dumps(fmap['held_bytes_per_device'])}; "
          f"sharding_audit {json.dumps(fsdp['audit'])}  [{card}]", flush=True)
    print(f"[fsdp] partial-shard checkpoint group {json.dumps(fsdp['group'])} bytes ({fsdp['sliced_leaves']} leaves "
          f"sliced), each file verified, the group complete; resumed at fabric.devices=1 fabric.fsdp=1 from it: "
          f"start_iter {fsdp['resumed']['start_iter']}, {fsdp['resumed']['player_steps']} player steps, ln_gru "
          f"launches {fsdp['resumed']['launches']} = predicted {fsdp['resumed']['predicted']}  [{card}]", flush=True)
    rest = fstep["rest"]
    print(f"[fsdp] at rest after the in-process fsdp=2 step: each shard's modules hold only their slices of the "
          f"{rest['cut_leaves']} leaves the rule cuts, the other leaves whole ({rest['at_rest']}); parameter bytes a "
          f"shard holds, summed from its tensors, {rest['held_bytes']} = tree_bytes_per_device {rest['rule_bytes']} "
          f"(the whole parameters {rest['whole_bytes']} bytes, {rest['rule_bytes'] / rest['whole_bytes']:.4f} of "
          f"them)  [{card}]", flush=True)
    print(f"[fsdp] one DreamerV3-S fp32 gradient step at fabric.fsdp=2 (2 shards of {fstep['shard_batch']} sequences, "
          f"each's parameters and optimizer state sliced at rest) against one device's on the same {fstep['batch']}-sequence batch and noise "
          f"(noise deciding every draw): metrics max relative error {fstep['metric_rel_err']:.3g}, Moments low/high "
          f"{fstep['moments_rel_err']:.3g} (tol {PARALLEL_STEP_RTOL:g}); the shards' metrics bitwise equal, their "
          f"gathered parameters and optimizer state equal; ln_gru launches {fstep['launches']} = predicted "
          f"{fstep['predicted']} (79 + 2 x {fstep['per_shard']}); {fstep['seconds']:.2f} s  [{card}]", flush=True)
    for label, update in (("fsdp=2", fstep["update"]), ("fsdp=2 from one generator", fstep["from_generator"]["update"]),
                          ("two data shards", fstep["dp_update"])):
        _print_update("fsdp", label, update, card)
    gstep = fstep["from_generator"]
    print(f"[fsdp] the fsdp=2 step with its draws from one generator (dp.global_streams, no injected noise) against "
          f"one device's from a generator of the same seed: metrics max relative error {gstep['metric_rel_err']:.3g}, "
          f"Moments {gstep['moments_rel_err']:.3g} (tol {PARALLEL_STEP_RTOL:g}); ln_gru launches {gstep['launches']}"
          f"  [{card}]", flush=True)
    print(f"[fsdp] torch.cuda.max_memory_allocated over the two shards' step above what was allocated before it: "
          f"fsdp=2 {fstep['peak_bytes']} bytes, two data shards {fstep['dp_peak_bytes']} bytes "
          f"({fstep['peak_bytes'] / max(1, fstep['dp_peak_bytes']):.3f} of it; both shards on the one card)  [{card}]",
          flush=True)
    print(f"[fsdp] group {fsdp['seconds']:.1f} s of its {FSDP_DEADLINES_S['fsdp']:g} s (the child's "
          f"{fsdp['child_s']:.1f} s; in this process {fsdp['in_process_s']:.1f} s beside the child)  [{card}]",
          flush=True)

    mark('fsdp')
    multihost = run_multihost(build_dir, runners[6:8])
    mh_step = multihost["step"]
    for r, child in enumerate(multihost["children"]):
        print(f"[multihost] rank {r} of python -m sheeprl_tpu_torch run exp=dreamer_v3 fabric.num_nodes=2 "
              f"fabric.devices=2 (DreamerV3-S, batch 16 x 64 a rank, horizon 15, fp32, one shard a rank on the one "
              f"card, gloo over localhost): {child['gradient_steps']} gradient steps, player calls "
              f"{child['player_calls']}, ln_gru launches {child['launches']} = predicted {multihost['predicted'][r]} "
              f"(79 a gradient step + the player's); {child['seconds']} s (imports made before the group, "
              f"{child['imports_s']} s)  [{card}]", flush=True)
    print(f"[multihost] one run dir {multihost['versions']}; the coordinated group at policy step "
          f"{multihost['group_step']} {json.dumps(multihost['group'])} bytes, each file verified, group_status "
          f"complete; the two ranks' parameters, optimizer state and Moments in it bitwise equal "
          f"({multihost['ranks_equal']})  [{card}]", flush=True)
    print(f"[multihost] one DreamerV3-S fp32 gradient step as two ranks (fresh processes, one shard of 8 sequences "
          f"each, imports {mh_step['imports_s']} s, process {mh_step['rank_s']} s; {MULTIHOST_STEPS} steps on the "
          f"same blocks and noise, each {mh_step['step_s']} s with its gloo collectives, against "
          f"{mh_step['one_process_step_s']} s in this process) against the one-process two-shard steps: bitwise "
          f"{mh_step['bitwise']} ({mh_step['differing_tensors']} of {mh_step['tensors']} state tensors differ), "
          f"metrics max relative error {mh_step['metric_rel_err']:.3g} (tol {PARALLEL_STEP_RTOL:g}); ln_gru launches "
          f"{mh_step['launches']} = predicted {mh_step['per_rank']} a rank  [{card}]", flush=True)
    print(f"[multihost] group {multihost['seconds']:.1f} s of its {MULTIHOST_DEADLINES_S['multihost']:g} s (in this "
          f"process {multihost['in_process_s']:.1f} s beside the ranks)  [{card}]", flush=True)

    mark('multihost')
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
    ops = run_serve_ops(build_dir)
    print(
        f"[serve-ops] DreamerV3-S as default + canary, reload/trace/SLO/request log on: {ops['requests']} /act, all "
        f"200 with their X-Request-Id; ckpt_100 promoted in {ops['promote_s']:.2f} s (default's greedy reply and "
        f"session state equal to the plain path on the new weights, max_abs_err {ops['probe_err']['default']:.3g}; "
        f"canary on the old, {ops['probe_err']['canary']:.3g}; the two states {ops['moved']:.3g} apart); ckpt_200 "
        f"held by an open anomaly, promoted after anomaly_end; ckpt_300 (recurrent 256) rejected for good; "
        f"{ops['dispatches']} dispatches + {ops['warmup_steps']} warm-up steps + 2 recomputations = "
        f"{ops['launches']} ln_gru launches; slow request {ops['slow_request_ms']:.1f} ms journaled with its phases, "
        f"SLO events {ops['slo_events']}; request logs {ops['logged']}; widths {ops['width_hist']}  [{card}]",
        flush=True,
    )
    for model, phases in ops["phases"].items():
        print(f"[serve-ops] {model} per-request phase p50/p99 ms: " + ", ".join(
            f"{phase} {phases[phase][0]:.3f}/{phases[phase][1]:.3f}" for phase in
            ("queue", "batch_form", "dispatch", "scatter", "total") if phase in phases) + f"  [{card}]", flush=True)
    print(f"[serve-ops] dispatch time per dispatch (trace_serve.json, {ops['dispatches_traced']} dispatches, the "
          f"injected one left out): p50 {ops['dispatch_ms_per_dispatch'][0]:.3f} ms, p99 "
          f"{ops['dispatch_ms_per_dispatch'][1]:.3f} ms  [{card}]", flush=True)

    mark('serve-ops')
    train = run_train(build_dir)
    s_cases = {(c["B"], c["dtype"]): c for c in cases if c["H"] == 512}
    print(
        f"[train] DreamerV3-S run (batch 16 x 64, horizon 15, fp32): {train['gradient_steps']} gradient steps in "
        f"{train['train_iterations']} training iterations, {train['metric_rows']} metric rows (one an iteration), "
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
        print(f"[ppo] run through env.executor={executor} (two iterations of 8 envs x 64 steps, no checkpoint, no test): "
              f"final losses "
              f"{json.dumps(run['final_losses'])}, Time/sps_env_interaction by interval "
              f"{run['sps']['Time/sps_env_interaction']}, Time/sps_train {run['sps']['Time/sps_train']}  [{card}]",
              flush=True)
    print(f"[ppo] rollout env steps/s (the second interval's Time/sps_env_interaction, 8 envs x 64 steps, episodes "
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
        print(f"[droq] run exp=droq env=dummy (hidden 256, dropout 0.01, replay ratio 2 (the preset's 20, cut), "
              f"2 envs, "
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
          f"minibatches, 2 epochs (the preset's 8, cut), LSTM 64): final losses {ppo_rec['final_losses']}, Time/sps_env_interaction "
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
    mark('flops')
    with deadline(SLICE_DEADLINES_S["minedojo"], "minedojo"):
        minedojo = run_minedojo(build_dir)
    print(f"[minedojo] DreamerV3-S run algo.actor.cls=...MinedojoActor on the MineDojo-shaped env (MultiDiscrete "
          f"[19, {MinedojoShapedEnv.CRAFT}, {MinedojoShapedEnv.ITEMS}], the four mask_* observations; batch 16 x 64, "
          f"horizon 15, fp32): {minedojo['gradient_steps']} gradient steps, {minedojo['player_steps']} player steps, "
          f"{minedojo['test_steps']} test steps; {minedojo['ln_gru_launches']} ln_gru launches = predicted "
          f"({minedojo['launches_per_gradient_step']} per gradient step + one a player step + the test steps); "
          f"every one of the {minedojo['masked_actions_checked']} actions the player took allowed by its step's "
          f"masks; kernel vs plain train step from its checkpoint: metrics max relative error "
          f"{minedojo['step_metric_rel_err']:.3g} (tol {STEP_METRIC_RTOL:g}), gradients "
          f"{minedojo['step_grad_rel_err']:.3g} (tol {STEP_GRAD_RTOL:g}), params off by more than "
          f"{STEP_PARAM_ATOL:g}: {minedojo['step_param_outliers']:.3g} (tol {STEP_PARAM_OUTLIERS:g})  [{card}]",
          flush=True)
    shutil.rmtree(build_dir / "minedojo", ignore_errors=True)
    with deadline(SLICE_DEADLINES_S["optimizers"], "optimizers"):
        optimizer_errs = run_optimizers_card_vs_cpu()
    print(f"[optim] one update of a 64 x 32 weight and a bias on the card against the CPU, fp32, each optimizer "
          f"written out from optax: parameters and state max relative error "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in optimizer_errs.items()})} (tol "
          f"{OPTIMIZER_CARD_CPU_RTOL:g})  [{card}]", flush=True)

    mark('minedojo, optimizers')
    records = run_records(build_dir, train, drill, ops, build_dir / "offline_export", timers)
    shutil.rmtree(build_dir / "offline_export", ignore_errors=True)
    prof = records["profiled"]
    print(f"[records] DreamerV3-S run metric.profiler.enabled=True model_manager.disabled=False (batch 16 x 64, "
          f"horizon 15, fp32): without mlflow the registry warned and was disabled, as the JAX check_configs does; "
          f"{prof['gradient_steps']} gradient steps, {prof['player_steps']} player steps, {prof['test_steps']} test "
          f"steps, {prof['ln_gru_launches']} ln_gru launches = predicted ({prof['launches_per_gradient_step']} per "
          f"gradient step) = {prof['trace_ln_gru_events']} ln_gru_kernel events in its Chrome trace "
          f"({prof['trace_events']} events, {prof['trace_kernel_events']} kernels, {prof['trace_mb']:.1f} MiB, parsed "
          f"in {prof['trace_parse_s']:.1f} s); the run took {prof['seconds']:.1f} s  [{card}]", flush=True)
    print(f"[records] profiler overhead: gradient step's median stream time {prof['step_ms']:.3f} ms profiled (CUDA "
          f"events around each of its {len(prof['stream_ms'])} steps, synchronized) against phase 17's unprofiled "
          f"{json.dumps({k: round(v, 3) for k, v in prof['unprofiled_step_ms'].items()})} ms; every step "
          f"{[round(v, 3) for v in prof['stream_ms']]}  [{card}]", flush=True)
    print(f"[records] python -m sheeprl_tpu_torch.tools.*_report, each with no jax, sheeprl_tpu or torch loaded: "
          f"lines {json.dumps(records['reports'])}; journal_report's last step {records['journal_last_step']} = the "
          f"run's, its CSV {records['csv_rows']} rows = its metrics events; {records['reports_s']:.1f} s  [{card}]",
          flush=True)
    print(f"[records] python -m sheeprl_tpu_torch.tools.search {' '.join(RECORDS_SEARCH)}: "
          f"{json.dumps(records['search']['results'])}, no error.txt; ln_gru launches by trial "
          f"{[t['launches'] for t in records['search']['trials']]} = predicted, gradient steps "
          f"{[t['gradient_steps'] for t in records['search']['trials']]}, widths (H, B, T*B) "
          f"{records['search']['trials'][0]['widths']}; {records['search_s']:.1f} s  [{card}]", flush=True)
    print(f"[records] registration without mlflow refused: {records['registration']}  [{card}]", flush=True)

    mark('records')
    # the kernels line: the kernel at the shape the main paths gave it most
    # (the serving dispatch width or the dynamic scan's B=16), and every case
    # it was held at
    main_b = 16 if train["gradient_steps"] * 64 >= max(slice_report["width_hist"].values()) \
        else slice_report["main_width"]
    main = s_cases.get((main_b, "float32")) or measure_ln_gru(main_b, *S_SHAPE, "float32")
    by_path = {"serve": slice_report["ln_gru_launches"], "serve-ops": ops["launches"],
               "train": train["ln_gru_launches"],
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
                                       ("_eval", "eval"))},
               "records": records["profiled"]["ln_gru_launches"],
               **{f"records_search_{i}": t["launches"] for i, t in enumerate(records["search"]["trials"])},
               "minedojo": minedojo["ln_gru_launches"],
               **{f"resilience_child_{i}": n for i, n in enumerate(resilience["launches"])},
               "parallel_dv3": parallel["child"]["launches"], "parallel_step": parallel["step"]["launches"],
               **parallel["launches"], **families["launches"], **decoupled["launches"], **fsdp["launches"],
               **multihost["launches"]}
    print(f"[launches] ln_gru launches by path: {', '.join(f'{k} {v}' for k, v in by_path.items())}; "
          f"{sum(by_path.values())} in all  [{card}]", flush=True)
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
        "phase": "kernel+lint+slice+serve-ops+train+chunked+resume+eval+offline+drill+jepa+p2e+sac+droq+sac_ae+offline_sac"
                 "+offline_droq+bf16+dv2+dv1+ppo_recurrent+p2e_dv2+p2e_dv1+minedojo+records"
                 "+resilience+parallel+parallel_families+decoupled+fsdp+multihost",
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
