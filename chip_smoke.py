#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):

1. Print the card (``nvidia-smi``), torch/CUDA versions, and build the
   kernels with ``nvcc``, one process per source, all started together
   (timed, and each source's ``nvcc`` time): B1–B4 from
   ``src/repro_torch/accel/csrc/assess.cu``, B5 from ``csrc/bulk.cu``, B6
   from ``csrc/flash_attention.cu`` (its Hopper body for bf16 at head_dim
   64/128 in ``csrc/flash_attention_sm90.cuh``, its SIMT body for the
   rest), B7 and B8 from ``csrc/flash_attention_bwd.cu`` (their Hopper
   bodies for bf16 at head_dim 64/128, with the GQA group sum, in
   ``csrc/flash_attention_bwd_sm90.cuh``; the primitives the Hopper
   headers share in ``csrc/sm90_primitives.cuh``), B9 from
   ``csrc/decode_attention.cu`` (its split-KV kernel and the combine) and
   B10 from ``csrc/ssd.cu`` (its Hopper body for bf16 at head_dim and
   d_state 64/128 in ``csrc/ssd_sm90.cuh``, its SIMT body for the rest);
   print the registers and stack bytes of each Hopper, B9 and B10 kernel
   (``cuobjdump -res-usage``).
2. Kernel phase: each of B1–B5 on the card against its plain
   torch version on CPU copies of the same inputs, exactly (NaN equal to
   NaN) — first on :func:`adversarial_inputs` (summation-order, tie and
   padding boundary cases), then B3 and B4 on :func:`boundary_inputs`
   (task segments across B4's tile edges and over a whole tile, jobs
   interleaved, a job of two candidates, equal ρ, q of 0 and 100, empty
   job slots, a job above B3's shared-memory candidates, ±0.0) and B1 and
   B2 on :func:`glance_inputs` (buckets of 2 to 8 rows whose sums depend
   on the order, jobs scattered across rows, one job holding every row,
   empty job slots, Eq. 1 ties, all-NaN neighbourhoods, 10,000 nodes,
   and 20,000 and 50,000 nodes, where each group's table moves from
   shared to device memory),
   each launched twice with the same bits and each (B2 aside) as 64
   scenarios in one call equal to 64 single calls; then on a mid-run
   snapshot of the
   main-path scenario, where kernel and plain version are also timed on
   the card: by CUDA events, by device time (``_device_ms``) and by the
   host's time to enqueue a call (``host_us``).
3. Main path: the 1,000-node, 20-job scenario under
   ``policy="bino"`` and ``policy="yarn"``, each once with the default
   backend (torch on the card) and once with ``assess_backend="numpy"``.
   Action traces, attempt launches and job results must be
   byte-identical, and every kernel must have launched during the card
   runs (the job passes of B1, B2 and B3, ``spatial_jobs``,
   ``temporal_jobs`` and ``late_jobs``, once for each of their row
   passes);
   B3 must have been reached through both ``late_victims`` (yarn) and
   ``winning`` (bino).
4. Predictor path: the learned straggler predictor on the card. The
   default training corpus (``CORPUS_RUNS`` x 3 replicas and the fleet
   slice, traced bino runs) generated with the default backend (the
   card) and with numpy must be byte-identical files, with B1-B4
   launched (each glance row pass with its job pass); ``train`` on the
   card and on the CPU from the same initial bits, 20 steps within
   ``PREDICT_TRAIN_TOL_SHORT`` and the reference's 400 within
   ``PREDICT_TRAIN_TOL`` (each leaf's ||card - cpu|| / ||cpu||); the
   card-trained ``PredictorPolicy`` on the main-path scenario, card
   against numpy: byte-identical traces, launches and results, exactly
   one B4 launch per assess tick and none of B1-B3, no plain-version
   call; B4 held against its plain version and timed on that run's
   snapshot; then fig_predictor's held-out scenarios (seed 1) under
   yarn, bino and the card-trained predictor on the card: predictor
   recall (scorecard ``mode="any"``) at least bino's wherever there are
   victims, and wasted backup launches per true straggler at most
   yarn's.
5. Fair path: the same jobs on the ε-fair network with 40
   racks, the kernel shuffle engine and drain-boundary re-pricing, plus a
   rack switch degrade — bino with assessment and the bulk solver on the
   card, then both on numpy. Byte-identical traces, launches and results;
   B5 launched and transfers re-priced. B5 is then held against its plain
   version on every pricing call of the card run and timed.
6. Sweep path: the fair card run's snapshot at 120 s, 64 fault
   scenarios of all five kinds; ``BatchedSweep.run_batched`` on the card
   (one call each of B1, B3 and B4 with a scenario axis) equals
   ``run_serial`` on numpy exactly. The batched kernels are then held
   against their plain versions and against 64 per-scenario launches,
   and timed as in phase 2.
7. Profile: the flat bino card run once more under
   ``torch.profiler`` — device time by kernel and the device's busy share
   of the run's wall time.
8. Attention kernels: B6 (flash-attention forward) and
   B9 (decode attention) against their plain torch versions on the card,
   in bf16 and f32, on boundary inputs (sq < sk, ragged tiles, a window,
   groups 1, 4 and 48, head_dim 64 and 128, valid lengths at 1, at tile
   edges ±1 and at the cache size; for B6's Hopper body sq, sk of 127,
   128 and 129, a q_offset off its 128-row tile, a window crossing a
   tile; for B9's split-KV body valid lengths at its 128-key split edges
   ±1, a ragged last split, groups of 48 and 64, head_dim 16; B6 at
   head_dim 80, causal and not, on its SIMT body; B9 at head_dim 80 at
   split and tile edges), within the
   tolerances of ``tests/test_kernels.py`` (bf16 2e-2, f32 2e-5; lse
   2e-5; B9's bf16 output within one bf16 unit, 2^-7 of itself, plus
   1e-2 of its sequence's RMS, which a combine that drops the last live
   split must fail); every bf16 case at head_dim 64/128 counted once as
   ``flash_fwd_tc``, no other; every B9 call one split launch and one
   combine; every B6 and B9 case launched twice gives byte-identical
   results. The same checks at the shapes the model-family paths (phase
   14) give B6 and B9: B6 over 4 x 2,048 positions at moonshot's 16/16,
   the jamba cut's 64/8 and internvl2's 16/8 heads of 128 (causal,
   bf16) and hubert's 16/16 of 80 (non-causal, bf16 and, as its f32 copy
   runs it, f32); B9 at the three decoders' heads against a 4,096-slot
   cache, valid lengths from the first decode step's to the last's.
   Then at the serving path's shapes, and B6
   also at Qwen1.5-0.5B's layer (the training path's) and at
   hubert-xlarge's (head_dim 80, non-causal), and B9 at head_dim 80
   (hubert's heads against the decode shape's cache), timed beside the
   plain versions and ``F.scaled_dot_product_attention`` (the yardstick
   only: the port never calls it), by CUDA events and, for B6 at the
   training layer and B9, by device time (``_device_ms``).
9. Serving path: Qwen3-8B at full width (36 layers, random
   bf16 weights from a seeded generator) serves 4 prompts of 2,048 token
   ids through ``make_prefill_step`` and 64 greedy steps of
   ``make_serve_step``: exactly 36 B6 launches, all on its Hopper body
   (``flash_fwd_tc``), and 2,304 B9 launches, each with one combine
   (``decode_combine``), no plain-version call. The
   logits of the prefill and of decode steps 1, 16 and 64 are held
   against the port's ``forward`` with ``impl="ref"`` in float32 over the
   same prefix; an fp8 cast of the activations must
   fail the same tolerance. The same bf16 prefill on the oracles shows
   how much of the error is bf16 rounding. Prints prefill ms, decode ms
   per step, tokens/s, peak device memory, and a profile of the device
   time by kernel.
10. Attention backward: B7 (dK, dV) and B8 (dQ) against
   their plain versions on the card in bf16 and f32 on boundary inputs
   (causal or not, windows, sq < sk, ragged tiles, groups 1, 4 and 8,
   head_dim 32, 64 and 128; bf16 2e-2, f32 2e-5), each launched twice
   with byte-identical results and counted on the body its inputs take
   (``flash_dkv_tc``/``flash_dq_tc`` for bf16 at head_dim 64/128, one
   ``flash_dkv_group_sum`` per such B7 launch with a group above 1), the
   f32 gradient of the op against autograd of the oracle (1e-3); then at
   Qwen1.5-0.5B's layer shape (no group sum), Qwen3-8B's head layout
   (one group sum per B7 launch) and hubert-xlarge's training layer (b 2,
   s 4,096, 16/16 heads of 80, non-causal, the SIMT bodies; the boundary
   inputs also hold head_dim 80 causal and not, a group of 2, windows and
   sq < sk), launched twice byte-identical, timed
   beside the plain versions and the backward of
   ``scaled_dot_product_attention`` (dq, dk and dv in one call; the
   yardstick only) by CUDA events and by device time, and the port's
   whole backward (``bwd_delta``, B7, B8) beside that yardstick by device
   time.
11. Training path: Qwen1.5-0.5B at full width and depth (random bf16
   weights from seed 0) trained by ``TrainerRuntime`` under the
   binocular-speculation coordinator, 4 hosts x 4 microbatches of 2,048
   tokens: a warm-up step and 5 timed steps (wall, tokens/s, loss, peak
   memory, the reports' detections, recoveries and executed microbatches);
   B6, B7 and B8 each launched exactly 24 times per ``grad_fn`` call, every
   launch of the three on its Hopper body, no group sum, no plain-version
   call, B1–B4 launched on the bino ticks. Step 0's loss and one
   microbatch's gradients are held against float32 autograd through the
   oracles (a probe that zeroes B8's dq must fail the gradient limit),
   and that microbatch's gradients computed twice must be
   byte-identical. The same steps then run under the
   pinned ``crash`` script with bino (checkpointing every 2 steps) and with
   gang restart, and a fresh runtime resumes from the bino run's last
   checkpoint before the end: each must end byte-identical to the
   fault-free run, and the crash runs must show a recovery. The last
   resumed step is profiled (device time by kernel, busy share, device
   time per ``grad_fn`` call, B6/B7/B8's shares).
12. SSD scan: B10 against its plain version on the card, y and final
   state, in bf16 and f32, on boundary inputs (the shapes of
   ``tests/test_kernels.py``, s < chunk, ragged tails, 1, 2 and 8 groups,
   head_dim 16 to 128 with d_state 128, A near 0 and decays that
   underflow; then the Hopper body's 64-row tiles, chunks of 64 to 256
   and sequences shorter than a tile (``SSD_TC_CASES``), the float32 side
   of the longest also against the plain walk in float64 (printed, not
   gated); y 2e-2 from bf16, 2e-4 in f32, the state 2e-4), each case
   launched twice with byte-identical
   results and counted on the body it takes (``ssd_tc`` and its three
   kernels' keys), the f32 gradient of the op (B10 forward, the oracle's
   autograd backward) against autograd of the oracle (1e-4); then at
   Mamba2-2.7B's layer shape on the Hopper body, launched twice
   byte-identical, timed beside the plain version by CUDA events and by
   device time (no PyTorch call computes the scan); and at the hybrid
   path's layer (the jamba cut: 256 heads of 64, 8 groups, d_state 128,
   chunk 256, 4 x 2,048 tokens, bf16), launched twice byte-identical,
   within the same tolerances of its plain version.
13. SSM serving path: Mamba2-2.7B at full width and depth (64 layers,
   random bf16 weights from a seeded generator, about 2.70 B parameters)
   serves 4 prompts of 2,048 token ids through ``make_prefill_step`` and
   64 greedy steps of ``make_serve_step``: exactly 64 B10 launches in
   the prefill, every one on the Hopper body (``ssd_tc``, ``ssd_prep``,
   ``ssd_state``, ``ssd_out`` 64 each), none in decode, no plain-version
   call. The logits of the
   prefill and decode steps 1, 16, 64 and every layer's final state are
   reported against the port's f32 ``forward(impl="ref")`` (random
   weights over 64 layers amplify bf16 rounding to about the logits'
   RMS). Gated: the same entry points on an f32 copy of the weights, fed
   the same tokens, within ``SSM_SERVE_TOL`` of that reference (an fp8
   probe must fail it); and layer by layer on the reference's residual
   stream, each bf16 layer's output and the head's logits, prefill and
   every decode step, within ``SSM_LAYER_TOL`` (an fp8 probe must fail
   it), each layer's final state within ``SSM_STATE_TOL``. Prints prefill ms, decode ms per
   step, tokens/s, peak device memory, the parameters' and the cache's
   bytes, and a profile of the device time by kernel.
14. Model families (one path each, its weights freed before the next;
   each prints prefill ms, decode ms per step, tokens/s, peak device
   memory, the parameters' and the cache's bytes, and a profile of the
   device time by kernel), random bf16 weights from seed 0, no
   plain-version call, gated layer by layer on the f32 reference's
   residual stream (each bf16 layer beside its f32 copy on the oracles,
   prefill and every decode step, within ``FAMILY_LAYER_TOL``; an fp8
   probe must fail it; tokens whose MoE routing differs between bf16 and
   f32 left out, their share within ``FAMILY_FLIP_TOL``), and what the
   timed run served held bit for bit against those same calls composed
   on the served stream (``family_replay``: every layer's cache after
   the last step, the prefill's and the checked steps' logits; every
   step's logits finite, their argmax the token fed next):
   - moe: moonshot-v1-16b-a3b at full width and depth (28.06 B
     parameters, 56.1 GB) serves 4 prompts of 2,048 tokens and 64 greedy
     steps into a 4,096-slot cache: exactly 48 B6 launches, all
     ``flash_fwd_tc``, and 3,072 B9 launches with their combines;
   - hybrid: jamba-1.5-large cut to one block of 8 layers with 4 experts
     (16.26 B parameters, 32.5 GB), the same traffic: exactly 1 B6
     launch (``flash_fwd_tc``), 7 B10 launches in the prefill on the
     Hopper body, none in decode, 64 B9 launches and combines; each
     Mamba layer's final state within ``SSM_STATE_TOL``;
   - audio: hubert-xlarge at full width and depth (0.95 B parameters),
     ``forward`` over 4 x 2,048 frames: exactly 48 B6 launches,
     non-causal at head_dim 80 on the SIMT body, no decode; the
     ``forward`` of an f32 copy of the weights within
     ``FAMILY_F32_TOL`` of the f32 reference (an fp8 probe must fail
     it);
   - vlm: internvl2-2b at full width and depth (1.89 B parameters), 4
     prompts of 256 patch features ahead of 1,792 token ids, 64 greedy
     steps: exactly 24 B6 launches (``flash_fwd_tc``) and 1,536 B9
     launches with combines; the logits of the prefill and decode steps
     1, 16, 64 within ``SERVE_TOL`` of the f32 reference (an fp8 probe
     must fail it).
15. Family training paths (``family_train_path``; each its own run, its
   state freed before the next), ``make_train_step`` on random bf16
   weights from seed 0, a warm-up step and 3 timed steps of 4 sequences
   of 4,096 positions (step wall, tokens/s, peak memory, the bytes of
   parameters and optimizer state, and a profiled step's busy share and
   device time by kernel):
   - audio: hubert-xlarge at full width and depth, 2 microbatches of 2 x
     4,096 frames, no remat: exactly 48 B6, B7 and B8 launches a
     ``grad_fn`` call, all on the SIMT bodies (head_dim 80);
   - vlm: internvl2-2b at full width and depth, 2 microbatches of 2 x
     (256 patches + 3,840 tokens), remat "dots": 48 B6 (24 and 24 in the
     recompute), 24 B7, 24 group sums and 24 B8 a call, on the Hopper
     bodies; microbatch 0's gradients under "dots" the same bits as under
     "none";
   - moe: moonshot-v1-16b-a3b cut to 4 of its 48 layers at full width
     (2.95 B parameters), 4 microbatches of 1 x 4,096 tokens, remat
     "full": 8 B6 (4 and 4 recomputed), 4 B7 and 4 B8 a call, on the
     Hopper bodies, no group sum.
   Gated for each: no plain-version call; the path's launch counts
   exactly those of its ``grad_fn`` calls; step 0's loss within
   ``TRAIN_LOSS_TOL`` of float32 autograd through the oracles on a
   float32 copy of the weights, microbatch 0's gradients within
   ``FAMILY_GRAD_TOL`` of it (for moe layer by layer on the f32 stream,
   tokens whose routing flips between bf16 and f32 left out, their share
   within ``FAMILY_FLIP_TOL``; a probe zeroing B8's dq must fail it) and
   the same bits twice; every loss finite, the AdamW count the number of
   steps, every leaf changed but those bf16 cannot move
   (``FROZEN_IN_BF16``) and the audio family's unreached embedding.
16. Print one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
   the result line ``{"ok": true, "device": {...}}`` last.

Each path is driven with the launch counts set to 0 just before it and
read just after; the comparisons of phases 2, 4, 5, 6, 8, 10 and 12, and the
training, serving and family checks, launch outside those windows.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.

Four modes time one part against another checkout, so that two versions
compare in one call on one card: ``--decode-wall [SRC]`` (the Qwen3-8B
decode), ``--sim-wall [SRC]`` (the flat main path's ticks/s and the
device's busy share), ``--train-wall [SRC]`` (the training path's
fault-free run, its hosts' heartbeat silences and the collector's
pauses) through the port under SRC, and ``--assess-parent
PATH`` (B1 to B4 of an earlier ``assess.cu`` at PATH against this
checkout's, in turns, at the main path's snapshot; B1 also at N = 64 and
at 10,000 nodes).
``--family-train NAME`` runs one family training path (phase 15) alone;
the full run takes the moe path this way, in a child process whose
allocator maps expandable segments (``family_train_child``).
``--train-context [RUNS]`` runs every phase before the training phase,
then the training phase RUNS times (3 by default) in the same process,
each printing its fault-free run's heartbeat silences and collector
pauses.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Main-path scenario: 1,000 nodes x 8 containers, 20 concurrent terasort
# jobs of 25 GB (200 maps + 32 reduces each, 4 splits per worker),
# submitted 1 s apart; a node crash in job 0 and a lost map output in
# job 1; 240 simulated seconds.
N_WORKERS = 1000
N_CONTAINERS = 8
N_JOBS = 20
JOB_GB = 25.0
SIM_TIME_CAP = 240.0
CAPTURE_AT = 120.0          # kernel-phase and sweep snapshots: mid-run
# Fair path: benchmarks/perf_net.py's rack count at 1,000 nodes,
# max(2, n // 25); rack 3's uplink degrades to 5 % for 90 s from 60 s.
N_RACKS = 40
DEGRADE = dict(rack=3, at=60.0, factor=0.05, duration=90.0)
N_SCENARIOS = 64

# Card peaks for bound_ms (NVIDIA H100 SXM data sheet): HBM3 bandwidth,
# the float64 and float32 rates outside the tensor cores, and the dense
# bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# Serving path: Qwen3-8B at full width, 4 prompts of 2,048 tokens, a
# 4,096-slot cache, 64 greedy decode steps; logits checked after the
# prefill and at these decode steps.
SERVE_ARCH = "qwen3-8b"
SERVE_SEED = 0
SERVE_BATCH = 4
SERVE_PROMPT = 2048
SERVE_MAX_LEN = 4096
SERVE_STEPS = 64
SERVE_CHECKS = (1, 16, 64)
# Serving tolerance: max |port - reference| over the reference logits'
# RMS. The port runs in bf16 (weights, activations, KV cache; f32 sums
# inside every product and norm), the reference in f32 from the same
# bf16 weights; bf16 keeps 8 significant bits, so each rounding moves a
# value by up to 2^-9 of itself, and 36 layers of residual adds, norms
# and products compound that. Measured on an H100 80GB HBM3 at 700 W
# (PERF.md): the prefill and decode steps 1, 16, 64 at 0.099-0.119; the
# probe below at 0.449. The limit sits between, 1.7x above the bf16 run
# and 2.2x below the probe: the same prefill with the activations
# entering every attention and MLP block and the head cast to fp8 (e4m3,
# 4 significant bits) must exceed it, so the check catches a silent drop
# to fp8.
SERVE_TOL = 0.2
# Attention kernels vs their plain versions (tests/test_kernels.py:21-23)
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# B9's bf16 output vs its plain version, tighter: both round a float32
# result to bf16 once, so they differ by at most one unit in the last
# place, 2^-7 of the value; values near 0 get 1e-2 of their sequence's
# RMS. (ATTN_TOL's 2e-2 is about two thirds of a typical output at the
# serving shape, whose RMS over 2,100 keys is about 0.03, and passes a
# combine that drops a live split; this check must fail it.)
DECODE_BF16_TOL = (2.0 ** -7, 1e-2)
LSE_TOL = 2e-5

WARMUP, REPS = 3, 50
ADVERSARIAL_SEEDS = 8


def scenario(policy: str, backend, *, n_workers: int = N_WORKERS,
             n_jobs: int = N_JOBS, gb: float = JOB_GB,
             cap: float = SIM_TIME_CAP, shuffle: str = "batch",
             net: str = "flat", racks: int = 0, net_opts=None,
             degrade=None, ckpt=None):
    """One seeded run of the main-path scenario through the port's
    public entry points; returns (sim, launches, result key, wall s).
    ``net``/``racks``/``net_opts``/``shuffle`` select the network and
    engine, ``degrade`` adds a rack switch degrade, and ``ckpt`` is a
    predictor checkpoint the ``"predictor"`` policy loads before the
    run."""
    from repro_torch.sim import JobSpec, Simulation, faults
    from repro_torch.sim.mapreduce import BINO_PARAMS, SimParams

    base = BINO_PARAMS if policy == "bino" else SimParams()
    sim = Simulation(policy=policy, seed=0, n_workers=n_workers,
                     n_containers=N_CONTAINERS, assess_backend=backend,
                     params=dataclasses.replace(base, sim_time_cap=cap),
                     shuffle=shuffle, net=net, racks=racks,
                     net_opts=net_opts, record_actions=True)
    if ckpt is not None:
        sim.speculator.load_checkpoint(ckpt)
    launches = []
    orig = sim._start_attempt

    def logged(req, node_id):
        launches.append((sim.engine.now, req.task.task_id, node_id,
                         req.reason, req.speculative, req.rollback))
        return orig(req, node_id)

    sim._start_attempt = logged
    jobs = [sim.submit(JobSpec(f"j{i}", "terasort", gb,
                               submit_time=float(i)))
            for i in range(n_jobs)]
    faults.crash_busiest_node_at_map_progress(sim, jobs[0], 0.4)
    faults.lose_mof_at_map_progress(sim, jobs[1], 1.0)
    if degrade is not None:
        faults.rack_switch_degrade_at(sim, **degrade)
    t0 = time.perf_counter()
    results = sim.run()
    wall = time.perf_counter() - t0
    key = [(r.job_id, r.finish_time, r.n_attempts, r.n_spec_attempts,
            r.n_fetch_failures) for r in results]
    return sim, launches, key, wall


def fair_scenario(assess, bulk, *, racks: int = N_RACKS, **kw):
    """The main-path jobs and faults on the ε-fair network: ``racks``
    racks, the kernel shuffle engine, drain-boundary re-pricing of
    in-flight transfers, and a rack switch degrade; bino."""
    return scenario("bino", assess, shuffle="kernel", net="fair",
                    racks=racks, net_opts={"realloc": True,
                                           "bulk_backend": bulk},
                    degrade=DEGRADE, **kw)


def timed_bulk(base, *args, prices=None):
    """An instance of bulk backend class ``base`` that adds the host wall
    time of its water-fill and pricing calls (each returns host arrays,
    so the device work is inside) to ``.wall``, and appends every
    non-empty pricing call's inputs to ``prices`` when given."""

    class Timed(base):
        def waterfill(self, eff, links, valid, eps):
            t0 = time.perf_counter()
            out = super().waterfill(eff, links, valid, eps)
            self.wall["waterfill"] += time.perf_counter() - t0
            return out

        def price(self, share, links, valid):
            if prices is not None and len(links):
                prices.append((share.copy(), links.copy(), valid.copy()))
            t0 = time.perf_counter()
            out = super().price(share, links, valid)
            self.wall["price"] += time.perf_counter() - t0
            return out

    bulk = Timed(*args)
    bulk.wall = {"waterfill": 0.0, "price": 0.0}
    return bulk


def recording_backends(device, at: float = CAPTURE_AT):
    """Torch assessment and bulk backends on ``device`` that record: the
    snapshot at the first spatial pass at or after ``at``, and every
    pricing call's inputs (the bulk backend is :func:`timed_bulk`).
    Returns (assess, bulk, record dict)."""
    from repro_torch.accel.bulk import TorchBulk
    from repro_torch.accel.torch_backend import TorchBackend
    from repro_torch.core.arrays import snapshot_state

    got = {"prices": []}

    class Assess(TorchBackend):
        def spatial_hits(self, arr, now, active, neighborhoods):
            if "state" not in got and now >= at:
                got.update(state=snapshot_state(arr), now=now)
            return super().spatial_hits(arr, now, active, neighborhoods)

    return Assess(device), timed_bulk(TorchBulk, device,
                                      prices=got["prices"]), got


def capture_snapshot(cap: float = CAPTURE_AT, **kw):
    """Run the bino scenario on numpy to mid-run and keep the state and
    arguments of the first Eq. 2 sample taken at or after ``CAPTURE_AT``
    (before its scratch write-back)."""
    from repro_torch.accel.numpy_backend import NumpyBackend
    from repro_torch.core.arrays import snapshot_state

    got = {}

    class Capture(NumpyBackend):
        def spatial_hits(self, arr, now, active, neighborhoods):
            got.setdefault("nh", neighborhoods)
            return super().spatial_hits(arr, now, active, neighborhoods)

        def temporal_zeta(self, arr, now, active, samp_flag, init_flag,
                          prevk):
            if "state" not in got and now >= CAPTURE_AT \
                    and samp_flag.any():
                got.update(state=snapshot_state(arr), now=now,
                           active=list(active), samp=samp_flag.copy(),
                           init=init_flag.copy(), prevk=prevk.copy())
            return super().temporal_zeta(arr, now, active, samp_flag,
                                         init_flag, prevk)

    sim, _l, _k, _w = scenario("bino", Capture(), cap=cap + 10.0, **kw)
    if "state" not in got:
        raise RuntimeError("no Eq. 2 sample after the capture time")
    got["win_factor"] = sim.speculator.collective.cfg.win_factor
    return got


def kernel_inputs(cap_state, device):
    """The four kernels' arguments at the main path's shapes, built by the
    backend itself from the captured snapshot on ``device``."""
    from repro_torch.accel.torch_backend import TorchBackend
    from repro_torch.core.arrays import snapshot_from_state

    arr = snapshot_from_state(cap_state["state"])
    now, active = cap_state["now"], cap_state["active"]
    backend = TorchBackend(device)
    return {
        "spatial": backend.spatial_args(arr, now, active, cap_state["nh"]),
        "temporal": backend.temporal_args(
            arr, now, active, cap_state["samp"], cap_state["init"],
            cap_state["prevk"])[0],
        "late": backend.late_args(arr, now, active, 10.0, 25.0,
                                  cap_state["win_factor"]),
        "reap": backend.reap_args(arr, now),
    }


def adversarial_inputs(seed: int, device, cap: int = 4096, n: int = 256,
                       jcap: int = 8, now: float = 100.0):
    """Kernel arguments built to expose summation order and tie handling:

    - spatial: one running row per (job, phase, node) bucket, so P is the
      row's ρ, drawn per group from two values {a, b}; a node whose own
      P is the smaller value sits exactly on Eq. 1's boundary
      (mean − σ = a in exact arithmetic), where the rounding of the
      k-sums decides; some buckets stay empty (NaN);
    - temporal: many rows per (job, node) bucket with values whose float
      sum depends on the order;
    - late and reap: task segments of one to three attempts, progress
      and start times from small sets (ties between attempts and between
      tasks), random speculative flags and attempt states."""
    rng = np.random.default_rng(seed)
    i32 = np.int32

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    ks = np.arange(4) - 2
    nh = ((np.arange(n)[:, None] + ks[None, :]) % n).astype(i32)
    # spatial
    bucket = rng.permutation(jcap * 2 * n)[:cap]
    s_job, rest = np.divmod(bucket, 2 * n)
    s_kind, s_node = np.divmod(rest, n)
    pair = rng.uniform(0.0, 1.0, (jcap * 2, 2))
    pick = rng.integers(0, 2, cap)
    s_rho = pair[s_job * 2 + s_kind, pick]
    s_run = (rng.random(cap) < 0.9).astype(i32)
    spatial = (t(s_rho), t(s_node.astype(i32)), t(s_kind.astype(i32)),
               t(s_job.astype(i32)), t(s_run), t(nh), jcap)
    # temporal
    vals = np.array([0.1, 0.2, 0.3, 0.7, 1e-3, 0.9999999])
    tm_node = rng.integers(0, n // 8, cap).astype(i32)
    tm_job = rng.integers(0, jcap, cap).astype(i32)
    tm_alive = (rng.random(cap) < 0.8).astype(i32)
    temporal = (t(rng.choice(vals, cap)), t(rng.choice(vals, cap)),
                t(tm_node), t(tm_job), t(tm_alive), jcap, n)
    # late / reap: canonical rows grouped into task segments
    sizes = rng.integers(1, 4, cap)
    tseg = np.repeat(np.arange(cap), sizes)[:cap].astype(i32)
    task_job = rng.integers(0, jcap, cap)
    jls = task_job[tseg].astype(i32)
    prog = rng.choice([0.0, 0.1, 0.25, 0.5, 0.75, 1.0], cap)
    start = rng.choice([0.0, 20.0, 50.0, 85.0, 95.0], cap)
    rate = prog / np.maximum(now - start, 1e-9)
    spec = (rng.random(cap) < 0.25).astype(i32)
    running = (rng.random(cap) < 0.7).astype(i32)
    runatt = np.maximum(running, rng.random(cap) < 0.1).astype(i32)
    order = rng.permutation(cap).astype(i32)
    q = float(rng.choice([10.0, 25.0, 50.0, 90.0]))
    late = (t(prog), t(start), t(rate), t(spec), t(tseg), t(jls),
            t(running), t(runatt), t(order), now, 10.0, q, 1.0, jcap)
    a_state = rng.choice(4, cap, p=[0.5, 0.3, 0.1, 0.1]).astype(i32)
    live = (rng.random(cap) < 0.6).astype(i32)
    reap = (t(a_state), t(tseg), t(live))
    return {"spatial": spatial, "temporal": temporal, "late": late,
            "reap": reap, "price": price_inputs(rng, n, device)}


# B3's and B4's boundary cases (boundary_inputs); each also runs as 64
# scenarios (seeds 0 to 63) through one batched launch.
BOUNDARY_CASES = ("tile_edge", "whole_tile", "interleaved", "m2",
                  "equal_rho", "q0", "q100", "empty_slots", "many_cands",
                  "signed_zero")
BOUNDARY_CAP = 4096


def _runs(rng, cap: int, sizes=(1, 4), forced=()) -> np.ndarray:
    """Task-segment ids of ``cap`` canonical rows: runs of random length
    in ``[sizes)``, except that each (a, b) in ``forced`` is one run."""
    starts = set(np.cumsum(rng.integers(*sizes, cap))[:-1].tolist()) | {0}
    for a, b in forced:
        starts -= set(range(a + 1, b))
        starts |= {a, b}
    starts = np.array(sorted(x for x in starts if x < cap))
    return (np.searchsorted(starts, np.arange(cap), side="right") - 1)


def boundary_inputs(case: str, seed: int, device, now: float = 100.0):
    """B3's and B4's arguments for one of :data:`BOUNDARY_CASES`, random
    parts drawn from ``seed`` as in :func:`adversarial_inputs`:

    - tile_edge: task segments straddling B4's 1,024-row tile edges, the
      completed attempt on one side and running siblings on the other,
      and one with no completed attempt;
    - whole_tile: segments that cover a whole tile, their completed
      attempt in the tile before or after;
    - interleaved: every segment's job differs from its neighbour's;
    - m2: a job with exactly two candidate tasks;
    - equal_rho: every candidate's ρ one of two values (ties throughout);
    - q0, q100: the percentile at its ends;
    - empty_slots: jobs in 3 of 32 slots;
    - many_cands: a job with 3,000 candidate tasks, above the
      candidates B3 keeps in shared memory;
    - signed_zero: progress of -0.0 and +0.0 (ρ of both signs)."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    cap, jcap, q = BOUNDARY_CAP, 8, 25.0
    forced = []
    if case == "tile_edge":
        forced = [(1020, 1030), (2040, 2050), (3070, 3080)]
    elif case == "whole_tile":
        forced = [(1000, 2060), (3000, cap)]
    tseg = _runs(rng, cap, (1, 2) if case == "many_cands" else (1, 4),
                 forced)
    nseg = int(tseg[-1]) + 1
    jcap = {"empty_slots": 32, "many_cands": 4}.get(case, jcap)
    seg_job = rng.integers(0, jcap, nseg)
    prog_set = [0.0, 0.1, 0.25, 0.5, 0.75, 1.0]
    start_set = [0.0, 20.0, 50.0, 85.0, 95.0]
    if case == "interleaved":
        seg_job = np.arange(nseg) % jcap
    elif case == "m2":
        seg_job = np.where(seg_job == 3, 4, seg_job)
        seg_job[rng.choice(nseg, 2, replace=False)] = 3
    elif case == "equal_rho":
        prog_set, start_set, q = [0.25, 0.5], [0.0], 60.0
    elif case in ("q0", "q100"):
        q = 0.0 if case == "q0" else 100.0
    elif case == "empty_slots":
        seg_job = rng.choice([0, 5, 31], nseg)
    elif case == "many_cands":
        seg_job[:3000] = 1
    elif case == "signed_zero":
        prog_set, q = [-0.0, 0.0, 0.25, 0.5, 0.75], 50.0
    jls = seg_job[tseg].astype(i32)
    prog = rng.choice(prog_set, cap)
    start = rng.choice(start_set, cap)
    spec = (rng.random(cap) < 0.25).astype(i32)
    running = (rng.random(cap) < 0.7).astype(i32)
    if case == "m2":                  # both of job 3's tasks are candidates
        rows = jls == 3
        running[rows], spec[rows], start[rows] = 1, 0, 0.0
    if case == "many_cands":
        rows = jls == 1
        running[rows], spec[rows] = 1, 0
        start[rows] = rng.choice([0.0, 20.0, 50.0], int(rows.sum()))
    runatt = np.maximum(running, rng.random(cap) < 0.1).astype(i32)
    rate = prog / np.maximum(now - start, 1e-9)
    order = rng.permutation(cap).astype(i32)
    a_state = rng.choice(4, cap, p=[0.5, 0.3, 0.1, 0.1]).astype(i32)
    live = (rng.random(cap) < 0.6).astype(i32)
    for a, b in forced:               # one completed attempt per segment
        a_state[a:b], live[a:b] = 0, 1
    if case == "tile_edge":
        a_state[1021] = a_state[2049] = 1
    elif case == "whole_tile":
        a_state[2059] = a_state[3000] = 1

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    tseg = tseg.astype(i32)
    return {"late": (t(prog), t(start), t(rate), t(spec), t(tseg), t(jls),
                     t(running), t(runatt), t(order), now, 10.0, q, 1.0,
                     jcap),
            "reap": (t(a_state), t(tseg), t(live))}


# B1's and B2's boundary cases (glance_inputs); each runs twice with the
# same bits, and B1's also as 64 scenarios (seeds 0 to 63) in one call.
GLANCE_CASES = ("order", "scattered", "one_job", "empty_slots", "ties",
                "nan_hood", "n10000", "n20000", "n50000")
# The node counts of the large cases: B1's group table leaves shared
# memory above 18,834 nodes, B2's above 13,053 (at their 8,192 rows), so
# n10000 keeps both tables there, n20000 and n50000 put both in device
# memory.
GLANCE_NODES = {"n10000": 10_000, "n20000": 20_000, "n50000": 50_000}
GLANCE_CAP = 4096
# Values whose float64 sums depend on the order they are added in.
ORDER_VALS = (0.1, 0.2, 0.3, 0.7, 1e-3, 0.9999999, 1.0, 1e16, 3e-17)


def glance_inputs(case: str, seed: int, device):
    """B1's and B2's arguments for one of :data:`GLANCE_CASES`, both from
    one set of rows (job, phase, node, two values, a used flag; B2's
    buckets merge the phases), random parts drawn from ``seed``; unused
    rows carry out-of-range jobs, phases and nodes:

    - order: buckets of 2 to 8 rows, at scattered rows, of values whose
      sum depends on the order;
    - scattered: every row's job drawn anew (jobs interleaved across all
      rows), nodes from an eighth of the range (many rows a bucket);
    - one_job: one job (slot 5) holds every row;
    - empty_slots: jobs in 3 of 32 slots;
    - ties: one row per (job, phase, node); each group's P takes two
      values a, b in the pattern a a b b, so every neighbourhood holds
      two of each and mean - sigma = min(a, b) in exact arithmetic: the
      nodes whose own P is the smaller value sit on Eq. 1's boundary;
    - nan_hood: in even groups only every fifth node has rows, some of
      them negative, and each such node's neighbours are the four nodes
      after it, all empty (an all-NaN neighbourhood; without the count
      test mean - sigma would be 0 and a negative P would fire);
    - n10000, n20000, n50000: that many nodes and 8,192 rows, half of
      them in a band at the top of the node range (the neighbourhoods
      wrap to node 0)."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    cap, n, jcap = GLANCE_CAP, 256, 8
    if case in GLANCE_NODES:
        cap, n = 8192, GLANCE_NODES[case]
    elif case == "empty_slots":
        jcap = 32
    ks = np.arange(4) - 2
    nh = (np.arange(n)[:, None] + ks[None, :]) % n
    vals = np.array(ORDER_VALS)
    job = rng.integers(0, jcap, cap)
    kind = rng.integers(0, 2, cap)
    node = rng.integers(0, n, cap)
    used = rng.random(cap) < 0.8
    a = rng.choice(vals, cap)
    b = rng.choice(vals, cap)
    if case == "order":
        nb = cap // 6
        bucket = rng.choice(jcap * 2 * n, nb, replace=False)
        sizes = rng.integers(2, 9, nb)
        rows = rng.permutation(cap)[:int(sizes.sum())]
        per_row = np.repeat(bucket, sizes)
        used = np.zeros(cap, dtype=bool)
        used[rows] = True
        job[rows], rest = np.divmod(per_row, 2 * n)
        kind[rows], node[rows] = np.divmod(rest, n)
    elif case == "scattered":
        node = rng.integers(0, n // 8, cap)
    elif case == "one_job":
        job[:], used[:] = 5, True
    elif case == "empty_slots":
        job = rng.choice([0, 5, 31], cap)
    elif case == "ties":
        bucket = rng.permutation(jcap * 2 * n)[:cap]
        job, rest = np.divmod(bucket, 2 * n)
        kind, node = np.divmod(rest, n)
        used[:] = True
        pairs = np.concatenate([[[0.25, 0.75], [0.1, 0.3], [0.2, 0.7],
                                 [1e-3, 0.9999999]],
                                rng.uniform(0.0, 1.0, (jcap * 2 - 4, 2))])
        pairs = pairs[rng.permutation(jcap * 2)]
        a = pairs[job * 2 + kind, (node // 2) % 2]
    elif case == "nan_hood":
        nh = (np.arange(n)[:, None] + 1 + np.arange(4)[None, :]) % n
        even = (job * 2 + kind) % 2 == 0
        node = np.where(even, (node // 5) * 5, node)
        a = np.where(even & (rng.random(cap) < 0.5),
                     -rng.choice([0.5, 0.25, 1e-3], cap), a)
    elif case in GLANCE_NODES:
        band = rng.random(cap) < 0.5
        node = np.where(band, rng.integers(n - 300, n, cap), node)
        a = np.where(rng.random(cap) < 0.5, rng.uniform(0.0, 1.0, cap), a)
    # unused rows: out-of-range ids the kernels must not read as used
    bad = ~used & (rng.random(cap) < 0.5)
    job = np.where(bad, rng.choice([-1, jcap]), job)
    kind = np.where(bad & (rng.random(cap) < 0.5), 2, kind)
    node = np.where(bad & (rng.random(cap) < 0.5), n, node)

    def t(x, dtype=None):
        x = np.ascontiguousarray(x if dtype is None else x.astype(dtype))
        return torch.from_numpy(x).to(device)

    flag = t(used, i32)
    return {"spatial": (t(a), t(node, i32), t(kind, i32), t(job, i32), flag,
                        t(nh, i32), jcap),
            "temporal": (t(a), t(b), t(node, i32), t(job, i32), flag, jcap,
                         n)}


def stack_scenarios(name: str, cases) -> tuple:
    """One batched argument tuple from per-scenario tuples of kernel
    ``name`` that share their non-row arguments."""
    k = ROW_ARGS[name]
    return (tuple(torch.stack([c[i] for c in cases]) for i in range(k))
            + tuple(cases[0][k:]))


def price_inputs(rng, n: int, device, racks: int = 8):
    """B5's arguments padded as ``TorchBulk.price`` pads them, with
    ``k`` just above a power of two: shares from a small set with ties
    and values below 1.0 (the max with 1.0 decides), one-link local
    flows, two-link intra-rack and four-link inter-rack flows, valid
    flags off the leading slots, -1 ids under invalid flags, and
    all-invalid pad rows."""
    nL = 2 * n + racks
    k = 2 ** int(rng.integers(6, 12)) + 1
    cap = 16
    while cap < k:
        cap *= 2
    share = rng.choice([0.25, 0.5, 1.0, 1.5, 3.0, 1e9], nL)
    links = rng.integers(0, nL, (cap, 4)).astype(np.int32)
    width = rng.choice([1, 2, 4], cap)
    valid = np.arange(4)[None, :] < width[:, None]
    shuffled = rng.random(cap) < 0.2            # flags off the prefix
    valid[shuffled] = rng.permuted(valid[shuffled], axis=1)
    valid[k:] = False
    links[~valid & (rng.random((cap, 4)) < 0.5)] = -1

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return t(share), t(links), t(valid)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _compare(a, b):
    """(equal, max_abs_err) with NaN equal to NaN, exact otherwise."""
    equal, err = True, 0.0
    for x, y in zip(_as_tuple(a), _as_tuple(b)):
        x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            return False, float("inf")
        if x.is_floating_point():
            nx, ny = torch.isnan(x), torch.isnan(y)
            same_nan = torch.equal(nx, ny)
            x0, y0 = torch.where(nx, 0.0, x), torch.where(ny, 0.0, y)
            equal &= same_nan and torch.equal(x0, y0)
            if not same_nan:
                err = float("inf")
            elif x0.numel():
                # equal entries (infinities included) differ by 0
                d = torch.where(x0 == y0, 0.0, (x0 - y0).abs())
                err = max(err, float(d.max()))
        else:
            equal &= torch.equal(x, y)
            if x.numel():
                err = max(err, float((x.long() - y.long()).abs().max()))
    return equal, err


def _time_ms(fn, args, reps: int = REPS, warmup: int = WARMUP) -> float:
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_ms(fn, args, reps: int = REPS) -> float:
    """Device time per call of ``fn``: CUDA events around ``reps`` calls
    queued behind a sleep kernel that holds the device until the host has
    enqueued them all, so the host's time per call (which events around
    calls shorter than it measure instead) is off the clock; the gaps
    between a call's kernels count. Not the profiler's kernel sum: on an
    H100 it dropped 1 to 7 of 50 launches' records (or every launch of
    one of a call's two kernels) at every shape timed here."""
    return _device_host(fn, args, reps)[0]


def _device_host(fn, args, reps: int = REPS):
    """(:func:`_device_ms`, the host's time in microseconds to enqueue
    one call: the host clock around ``reps`` calls that do not wait for
    the device, before the device time is taken)."""
    for _ in range(WARMUP):
        fn(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # twice the host's time to enqueue them, in cycles of a 2 GHz clock
    torch.cuda._sleep(int(max(2 * host_s, 1e-3) * 2e9))
    t0.record()
    for _ in range(reps):
        fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, host_s / reps * 1e6


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _as_tuple(x)
               if isinstance(t, torch.Tensor))


# Leading row arguments of the kernels that take a scenario axis.
ROW_ARGS = {"spatial": 5, "late": 9, "reap": 3}


def one_scenario(name: str, args: tuple, s: int) -> tuple:
    """Scenario ``s``'s arguments of batched kernel ``name``: its rows of
    the stacked row arguments, the shared arguments as they are."""
    k = ROW_ARGS[name]
    return tuple(a[s] for a in args[:k]) + tuple(args[k:])


def _ops(name, args) -> float:
    """Arithmetic and comparison operations the function needs on these
    inputs (float64, so against the non-tensor-core rate)."""
    if name.endswith("_sweep"):
        base = name[:-len("_sweep")]
        return sum(_ops(base, one_scenario(base, args, s))
                   for s in range(args[0].shape[0]))
    if name == "price":
        # a compare per valid link and the max with 1.0 per row
        return float(args[2].sum()) + args[1].shape[0]
    if name == "spatial":
        running, nh, jcap = args[4], args[5], args[6]
        n, k = nh.shape
        return 2 * float(running.sum()) + jcap * 2 * n * (6 * k + 6)
    if name == "temporal":
        alive, jcap, n = args[4], args[5], args[6]
        return 3 * float(alive.sum()) + jcap * n
    if name == "late":
        # per row: a max and two rate maxima; per job: an exact selection
        # of two order statistics and the victim's maximum, about 10
        # comparisons per candidate task (m, taken from the tasks with
        # running attempts, an upper bound of the candidates)
        tseg, running = args[4], args[6]
        m = torch.unique(tseg.long()[running.bool()]).numel()
        return 4.0 * tseg.shape[0] + 10.0 * m
    return 2.0 * args[0].shape[0]


REPLACES = {
    "spatial": "src/repro/accel/pallas_backend.py:51 _spatial_kernel",
    "temporal": "src/repro/accel/pallas_backend.py:85 _temporal_kernel",
    "late": "src/repro/accel/pallas_backend.py:112 _late_kernel",
    "reap": "src/repro/accel/pallas_backend.py:191 _reap_kernel",
}


def kernel_phase(cap_state):
    from repro_torch.accel import kernels as K
    from repro_torch.accel import torch_backend as TB

    fns = {"spatial": (TB.spatial, TB.spatial_ref),
           "temporal": (TB.temporal, TB.temporal_ref),
           "late": (TB.late, TB.late_ref),
           "reap": (TB.reap, TB.reap_ref)}
    # Boundary cases first: every kernel equal to its plain version on
    # inputs built to expose summation order and tie handling.
    from repro_torch.accel import bulk as B
    adv_fns = dict(fns, price=(B.price, B.price_ref))
    for seed in range(ADVERSARIAL_SEEDS):
        dev_adv = adversarial_inputs(seed, "cuda")
        cpu_adv = adversarial_inputs(seed, "cpu")
        for name, (wrapper, plain) in adv_fns.items():
            equal, err = _compare(wrapper(*dev_adv[name]),
                                  plain(*cpu_adv[name]))
            if not equal:
                raise RuntimeError(f"{name}: kernel != plain version on "
                                   f"adversarial seed {seed} "
                                   f"(max_abs_err {err})")
    torch.cuda.synchronize()
    print(f"adversarial inputs: all kernels equal to their plain versions "
          f"({ADVERSARIAL_SEEDS} seeds)", flush=True)
    boundary_phase()

    dev_in = kernel_inputs(cap_state, "cuda")
    cpu_in = kernel_inputs(cap_state, "cpu")
    rows = {}
    for name, (wrapper, plain) in fns.items():
        args = dev_in[name]
        before = K.launches[name]
        got = wrapper(*args)
        torch.cuda.synchronize()
        if K.launches[name] != before + 1:
            raise RuntimeError(f"{name}: the wrapper did not launch")
        want = plain(*cpu_in[name])
        equal, err = _compare(got, want)
        if not equal:
            raise RuntimeError(f"{name}: kernel != plain version "
                               f"(max_abs_err {err})")
        rows[name] = timed_row(name, wrapper, plain, args, got, err,
                               "src/repro_torch/accel/csrc/assess.cu",
                               REPLACES[name])
    return rows


def boundary_phase():
    """B3 and B4 on each of :data:`BOUNDARY_CASES`, B1 and B2 on each of
    :data:`GLANCE_CASES`: launched twice with the same bits, equal to the
    plain version, and (all but B2, which has no scenario axis) as 64
    scenarios in one call, equal to 64 single calls and to the plain
    version."""
    from repro_torch.accel import torch_backend as TB

    fns = {"late": (TB.late, TB.late_ref), "reap": (TB.reap, TB.reap_ref)}
    for case in BOUNDARY_CASES:
        for name, (wrapper, plain) in fns.items():
            _boundary_case(name, case, wrapper, plain, boundary_inputs)
    glance = {"spatial": (TB.spatial, TB.spatial_ref),
              "temporal": (TB.temporal, TB.temporal_ref)}
    for case in GLANCE_CASES:
        for name, (wrapper, plain) in glance.items():
            _boundary_case(name, case, wrapper, plain, glance_inputs,
                           batched=name in ROW_ARGS)
    # the large cases' device time: the group tables move from shared to
    # device memory between 10,000 and 20,000 nodes
    times = {f"{name} {case}": _device_ms(wrapper, glance_inputs(
        case, 0, "cuda")[name]) for case in GLANCE_NODES
        for name, (wrapper, _plain) in glance.items()}
    print(f"glance device ms at 8,192 rows, by kernel and nodes: "
          f"{json.dumps(times)}", flush=True)
    torch.cuda.synchronize()
    print(f"boundary cases: B3 and B4 ({', '.join(BOUNDARY_CASES)}), B1 "
          f"and B2 ({', '.join(GLANCE_CASES)}) equal to their plain "
          f"versions, twice with the same bits, and B1, B3, B4 as "
          f"{N_SCENARIOS} scenarios in one call", flush=True)


def _boundary_case(name, case, wrapper, plain, inputs, batched=True):
    dev = inputs(case, 0, "cuda")[name]
    got = wrapper(*dev)
    if not _compare(got, wrapper(*dev))[0]:
        raise RuntimeError(f"{name} {case}: two launches differ")
    want = plain(*inputs(case, 0, "cpu")[name])
    equal, err = _compare(got, want)
    if not equal:
        raise RuntimeError(f"{name} {case}: kernel != plain version "
                           f"(max_abs_err {err})")
    if not batched:
        return
    dev64 = stack_scenarios(name, [inputs(case, s, "cuda")[name]
                                   for s in range(N_SCENARIOS)])
    out64 = wrapper(*dev64)
    singles = [wrapper(*one_scenario(name, dev64, s))
               for s in range(N_SCENARIOS)]
    singles = (tuple(torch.stack(x) for x in zip(*singles))
               if isinstance(out64, tuple) else torch.stack(singles))
    if not _compare(out64, singles)[0]:
        raise RuntimeError(f"{name} {case}: batched launch != "
                           f"{N_SCENARIOS} single launches")
    cpu64 = stack_scenarios(name, [inputs(case, s, "cpu")[name]
                                   for s in range(N_SCENARIOS)])
    equal, err = _compare(out64, plain(*cpu64))
    if not equal:
        raise RuntimeError(f"{name} {case}: batched kernel != plain "
                           f"version (max_abs_err {err})")


def timed_row(name, wrapper, plain, args, got, err, source, replaces):
    """The kernel's line of the ``{"kernels": ...}`` record: kernel and
    plain version timed on the card on ``args``, and the bound for
    them (bytes of the inputs read once and the outputs written once
    over the memory rate, or operations over the float64 rate)."""
    ms = _time_ms(wrapper, args)
    device_ms, host_us = _device_host(wrapper, args)
    plain_ms = _time_ms(plain, args)
    bytes_ = sum(_nbytes(a) for a in args) + _nbytes(got)
    ops = _ops(name, args)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    print(f"kernel {name}: equal max_abs_err={err} ms={ms:.6f} "
          f"device_ms={device_ms:.6f} host_us={host_us:.3f} "
          f"plain_ms={plain_ms:.6f} bytes={bytes_}", flush=True)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0,
        "equal": True, "max_abs_err": err, "ms": ms,
        "device_ms": device_ms, "host_us": host_us,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "bytes": bytes_, "ops": ops,
    }


def main_path():
    """Bino then yarn, card and numpy each; returns per-kernel launches
    summed over the two card runs."""
    from repro_torch.accel import kernels as K
    from repro_torch.accel.torch_backend import TorchBackend

    b3_by = {"late_victims": 0, "winning": 0}
    for meth in b3_by:
        orig = getattr(TorchBackend, meth)

        def counted(self, *a, _orig=orig, _meth=meth, **kw):
            before = K.launches["late"]
            out = _orig(self, *a, **kw)
            b3_by[_meth] += K.launches["late"] - before
            return out
        setattr(TorchBackend, meth, counted)

    total = {name: 0 for name in ("spatial", "spatial_jobs", "temporal",
                                  "temporal_jobs", "late", "late_jobs",
                                  "reap")}
    for policy in ("bino", "yarn"):
        K.reset_launches()
        card, c_launch, c_key, c_wall = scenario(policy, None)
        counts = dict(K.launches)
        ref, r_launch, r_key, r_wall = scenario(policy, "numpy")
        if not isinstance(card.speculator.backend, TorchBackend) \
                or card.speculator.backend.device.type != "cuda":
            raise RuntimeError("the default backend is not torch on cuda")
        if card.action_trace != ref.action_trace:
            raise RuntimeError(f"{policy}: action traces differ")
        if c_launch != r_launch:
            raise RuntimeError(f"{policy}: attempt launches differ")
        if c_key != r_key:
            raise RuntimeError(f"{policy}: job results differ")
        if not card.action_trace:
            raise RuntimeError(f"{policy}: no actions, nothing probed")
        for name in total:
            total[name] += counts[name]
        print(f"main path {policy}: identical traces "
              f"({len(card.action_trace)} actions, {len(c_launch)} "
              f"attempt launches, {len(c_key)} jobs finished); "
              f"card: {card.assess_ticks} assess ticks, assess_wall "
              f"{card.assess_wall:.6f} s, wall {c_wall:.6f} s, "
              f"{card.assess_ticks / card.assess_wall:.3f} ticks/s; "
              f"numpy: {ref.assess_ticks} ticks, assess_wall "
              f"{ref.assess_wall:.6f} s, wall {r_wall:.6f} s, "
              f"{ref.assess_ticks / ref.assess_wall:.3f} ticks/s; "
              f"kernel launches {counts}", flush=True)
    missing = [name for name, c in total.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    for name in ("spatial", "temporal", "late"):
        if total[name + "_jobs"] != total[name]:
            raise RuntimeError(f"{name}: {total[name]} row passes, "
                               f"{total[name + '_jobs']} job passes")
    if not (b3_by["late_victims"] > 0 and b3_by["winning"] > 0):
        raise RuntimeError(f"B3 not reached through both callers: {b3_by}")
    print(f"B3 launches by caller: {b3_by}", flush=True)
    return total


# Predictor path: the learned straggler predictor's corpus, its training
# and the trained policy, each on the card. The held-out scenarios of
# fig_predictor (benchmarks/fig_predictor.py, SCENARIOS and SEED), kept
# here so that this script imports nothing of benchmarks/.
PREDICT_SEED = 0
FIG_PREDICTOR_SEED = 1
FIG_PREDICTOR_SCENARIOS = {
    "clean": ([], {}),
    "one_crash": ([("crash", 1, 0.2, 0.0)], {}),
    "two_crashes": ([("crash", 1, 0.2, 0.0), ("crash", 2, 0.3, 0.0)], {}),
    "rack_degrade": ([("degrade", 0, 0.25, 0.1), ("slow", 2, 0.3, 0.4)],
                     {"net": "topo", "racks": 4}),
}
FIG_PREDICTOR_POLICIES = ("yarn", "bino", "predictor")
# Training on the card against the same training on the CPU, both from
# the same initial bits (drawn on the CPU, then moved): each trained
# leaf's ||card - cpu|| / ||cpu||. After PREDICT_TRAIN_STEPS_SHORT steps
# the two differ only by the rounding of their float32 sums: measured
# 4.2e-7 on an H100 80GB HBM3 at 700 W (PERF.md), bound 1e-5; this holds
# the arithmetic. Over the reference's 400 steps AdamW's sign-like steps
# on near-zero gradients carry those roundings into the weights: measured
# 0.043 on the same card, and on a CPU the thread count alone moved a
# 400-step run by up to 0.23 against the reference's from the same bits.
# PREDICT_TRAIN_TOL bounds gross errors only.
PREDICT_TRAIN_STEPS_SHORT = 20
PREDICT_TRAIN_TOL_SHORT = 1e-5
PREDICT_TRAIN_TOL = 0.25
ASSESS_KEYS = ("spatial", "spatial_jobs", "temporal", "temporal_jobs",
               "late", "late_jobs", "reap")


def predictor_path(device="cuda", workdir=None, corpus_runs=None,
                   **sizes):
    """The predictor path on ``device``: the default corpus generated with
    the card's backend and with numpy (byte-identical files), training on
    ``device`` and on the CPU, the card-trained policy at the main path's
    scale (``sizes`` override it) against numpy, and fig_predictor's two
    bars on the card. A CPU run (``device="cpu"``) rehearses it on
    ``TorchBackend("cpu")``, with no launch to count and without the
    bars: a CPU-trained model's bars move with the CPU's thread count
    (its float32 sums round differently, and 400 AdamW steps carry that
    into the weights). ``corpus_runs`` replaces the default corpus's run
    list. Files go to a temporary
    directory under ``workdir`` (default: the repository's git-ignored
    ``build/``), removed at the end. Returns the card runs' launch counts
    and B4's timing on the predictor run's snapshot."""
    import shutil
    import tempfile

    root = Path(workdir or ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="predict_", dir=root))
    try:
        return _predictor_runs(device, tmp, corpus_runs, sizes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _predictor_runs(device, tmp, corpus_runs, sizes):
    from collections import Counter

    from repro_torch.accel import kernels as K
    from repro_torch.accel import torch_backend as TB
    from repro_torch.accel.numpy_backend import NumpyBackend
    from repro_torch.core.arrays import snapshot_from_state, snapshot_state
    from repro_torch.predict.dataset import generate_corpus
    from repro_torch.predict.model import TRAINED_LEAVES, load_params_np
    from repro_torch.predict.train import train

    on_card = device == "cuda"
    assess = None if on_card else TB.TorchBackend("cpu")
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # -- the corpus ------------------------------------------------------
    paths = {k: str(tmp / f"corpus_{k}.npz") for k in ("card", "numpy")}
    walls = {}
    K.reset_launches()
    for key, backend in (("card", assess), ("numpy", "numpy")):
        t0 = time.perf_counter()
        meta = generate_corpus(paths[key], seed=PREDICT_SEED,
                               runs=corpus_runs, assess_backend=backend)
        sync()
        walls[key] = time.perf_counter() - t0
        if key == "card":
            counts = {k: K.launches[k] for k in ASSESS_KEYS}
    same = Path(paths["card"]).read_bytes() == \
        Path(paths["numpy"]).read_bytes()
    print(f"predictor corpus: {len(meta['runs'])} traced bino runs, "
          f"{meta['n_rows']} rows ({meta['n_positive']} positive); files "
          f"{'byte-identical' if same else 'DIFFER'}, card vs numpy; wall "
          f"card {walls['card']:.6f} s, numpy {walls['numpy']:.6f} s; "
          f"kernel launches {counts}", flush=True)
    if not same:
        raise RuntimeError("predictor corpus: card and numpy files differ")
    if on_card:
        missing = [k for k in ASSESS_KEYS if counts[k] == 0]
        if missing:
            raise RuntimeError(f"predictor corpus: kernels never launched: "
                               f"{missing}")
        for name in ("spatial", "temporal", "late"):
            if counts[name + "_jobs"] != counts[name]:
                raise RuntimeError(f"predictor corpus: {name}: "
                                   f"{counts[name]} row passes, "
                                   f"{counts[name + '_jobs']} job passes")
    out["corpus"] = counts
    corpus = paths["card"]

    # -- training on the card and on the CPU, from the same bits ---------
    def trained(steps, tol):
        runs = {}
        for dev in dict.fromkeys((device, "cpu")):
            ckpt = str(tmp / f"ckpt_{steps}_{dev}")
            t0 = time.perf_counter()
            meta = train(corpus, ckpt, seed=PREDICT_SEED, steps=steps,
                         device=dev)
            sync()
            runs[dev] = (ckpt, meta, time.perf_counter() - t0,
                         load_params_np(ckpt))
        ckpt, meta, wall, got = runs[device]
        _c, meta_cpu, _w, want = runs["cpu"]
        errs = {k: float(np.linalg.norm(got[k] - want[k])
                         / np.linalg.norm(want[k])) for k in TRAINED_LEAVES}
        print(f"predictor train {steps} steps on {device}: wall "
              f"{wall:.6f} s, final loss {meta['final_train_loss']}, "
              f"threshold {meta['threshold']}, eval precision "
              f"{meta['eval']['precision']} recall "
              f"{meta['eval']['recall']}; on the cpu: loss "
              f"{meta_cpu['final_train_loss']}, threshold "
              f"{meta_cpu['threshold']}; ||{device} - cpu|| / ||cpu|| by "
              f"leaf {errs} (limit {tol})", flush=True)
        if not max(errs.values()) <= tol:
            raise RuntimeError(f"predictor train {steps} steps: {device} "
                               f"vs cpu {errs}, limit {tol}")
        return ckpt

    trained(PREDICT_TRAIN_STEPS_SHORT, PREDICT_TRAIN_TOL_SHORT)
    ckpt = trained(400, PREDICT_TRAIN_TOL)

    # -- the trained policy at the main path's scale ---------------------
    got = {}

    class Capture(NumpyBackend):
        """numpy, keeping the snapshot of the first reap at or after
        ``CAPTURE_AT`` (B4 is timed on it below)."""

        def reap_rows(self, arr, now):
            if "state" not in got and now >= CAPTURE_AT:
                got.update(state=snapshot_state(arr), now=now)
            return super().reap_rows(arr, now)

    plain = _CountCalls([(TB, "reap_ref")])
    K.reset_launches()
    with plain:
        card, c_launch, c_key, c_wall = scenario("predictor", assess,
                                                 ckpt=ckpt, **sizes)
    counts = {k: K.launches[k] for k in ASSESS_KEYS}
    ref, r_launch, r_key, r_wall = scenario("predictor", Capture(),
                                            ckpt=ckpt, **sizes)
    backend = card.speculator.backend
    if not isinstance(backend, TB.TorchBackend) or \
            backend.device.type != torch.device(device).type:
        raise RuntimeError(f"predictor: backend {backend!r}, not torch on "
                           f"{device}")
    if card.action_trace != ref.action_trace:
        raise RuntimeError("predictor: action traces differ")
    if c_launch != r_launch:
        raise RuntimeError("predictor: attempt launches differ")
    if c_key != r_key:
        raise RuntimeError("predictor: job results differ")
    kinds = Counter(a.split("(", 1)[0] for _t, a in card.action_trace)
    print(f"predictor policy: identical traces ({len(card.action_trace)} "
          f"actions: {dict(kinds)}; {len(c_launch)} attempt launches, "
          f"{len(c_key)} jobs finished); threshold "
          f"{card.speculator.cfg.threshold}; card: {card.assess_ticks} "
          f"assess ticks, assess_wall {card.assess_wall:.6f} s, wall "
          f"{c_wall:.6f} s, {card.assess_ticks / card.assess_wall:.3f} "
          f"ticks/s; numpy: {ref.assess_ticks} ticks, assess_wall "
          f"{ref.assess_wall:.6f} s, wall {r_wall:.6f} s, "
          f"{ref.assess_ticks / ref.assess_wall:.3f} ticks/s; kernel "
          f"launches {counts}; plain-version calls {plain.calls}",
          flush=True)
    if not kinds.get("SpeculateTask"):
        print("predictor policy: the trained model nominated no backup "
              "at this scale", flush=True)
    if on_card:
        want = dict.fromkeys(ASSESS_KEYS, 0)
        want["reap"] = card.assess_ticks
        if counts != want or any(plain.calls.values()):
            raise RuntimeError(f"predictor: launches {counts}, expected "
                               f"{want}; plain calls {plain.calls}")
        if "state" not in got:
            raise RuntimeError("predictor: no reap after the capture time")
        arr = snapshot_from_state(got["state"])
        args = TB.TorchBackend(device).reap_args(arr, got["now"])
        equal, err = _compare(TB.reap(*args), TB.reap_ref(
            *TB.TorchBackend("cpu").reap_args(arr, got["now"])))
        if not equal:
            raise RuntimeError(f"predictor: B4 != plain version on the "
                               f"snapshot (max_abs_err {err})")
        dev_ms, host_us = _device_host(TB.reap, args)
        out["reap_timing"] = {"device_ms": dev_ms, "host_us": host_us,
                              "ms": _time_ms(TB.reap, args),
                              "rows": arr.n, "now": got["now"]}
        print(f"predictor B4 on the snapshot at {got['now']} s ({arr.n} "
              f"rows): equal to its plain version; {out['reap_timing']}",
              flush=True)
        out["fig"] = fig_predictor_bars(ckpt)
    out["policy"] = counts
    return out


def fig_predictor_bars(ckpt, assess=None):
    """fig_predictor's held-out scenarios under yarn, bino and the
    predictor of checkpoint ``ckpt``, assessing on ``assess`` (default:
    the card); raises unless the benchmark's two bars hold. Returns the
    runs' launch counts."""
    from repro_torch.accel import kernels as K

    K.reset_launches()
    per = {name: {p: _fig_predictor_run(p, script, kw, ckpt, assess)
                  for p in FIG_PREDICTOR_POLICIES}
           for name, (script, kw) in FIG_PREDICTOR_SCENARIOS.items()}
    counts = {k: K.launches[k] for k in ASSESS_KEYS}
    fp_rate = {p: sum(per[n][p]["wasted_launches"] for n in per)
               / max(sum(per[n][p]["victims"] for n in per), 1)
               for p in FIG_PREDICTOR_POLICIES}
    for name in per:
        print(f"fig_predictor {name}: {per[name]}", flush=True)
    print(f"fig_predictor: wasted backup launches per true straggler "
          f"{fp_rate}; kernel launches {counts}", flush=True)
    for name in per:
        if not per[name]["bino"]["victims"]:
            continue
        if per[name]["predictor"]["recall"] < per[name]["bino"]["recall"]:
            raise RuntimeError(f"fig_predictor {name}: predictor recall "
                               f"below bino's: {per[name]}")
    if fp_rate["predictor"] > fp_rate["yarn"]:
        raise RuntimeError(f"fig_predictor: the predictor wastes more "
                           f"backups per straggler than yarn: {fp_rate}")
    return counts


def _fig_predictor_run(policy, script, kw, ckpt, assess):
    """One fig_predictor scenario (seed 1, a 2 GB terasort) under
    ``policy``, traced; its scorecard (``mode="any"``) numbers."""
    from repro_torch.obs import TraceRecorder, attempt_outcomes, scorecard
    from repro_torch.obs.trace import END_COMPLETED
    from repro_torch.sim import JobSpec, Simulation, faults

    rec = TraceRecorder()
    sim = Simulation(policy=policy, seed=FIG_PREDICTOR_SEED, obs=rec,
                     assess_backend=assess, **kw)
    if policy == "predictor":
        sim.speculator.load_checkpoint(ckpt)
    job = sim.submit(JobSpec("j0", "terasort", 2.0))
    if script:
        faults.apply_script(sim, job, script)
    sim.run()
    card = scorecard(rec, policy=policy, mode="any")
    return {
        "finish": round(sim.engine.now, 6),
        "recall": card["recall"],
        "victims": len(card["victims"]),
        "n_backups": card["n_backups"],
        "wasted_launches": sum(1 for o in attempt_outcomes(rec)
                               if o["speculative"]
                               and o["end_code"] != END_COMPLETED),
    }


def fair_path():
    """Bino on the ε-fair network, card then numpy; returns the card
    run's launch counts and its records (pricing calls, snapshot)."""
    from repro_torch.accel import kernels as K

    from repro_torch.accel.bulk import NumpyBulk

    assess, bulk, got = recording_backends("cuda")
    K.reset_launches()
    card, c_launch, c_key, c_wall = fair_scenario(assess, bulk)
    counts = dict(K.launches)
    ref_bulk = timed_bulk(NumpyBulk)
    ref, r_launch, r_key, r_wall = fair_scenario("numpy", ref_bulk)
    if card.action_trace != ref.action_trace:
        raise RuntimeError("fair: action traces differ")
    if c_launch != r_launch:
        raise RuntimeError("fair: attempt launches differ")
    if c_key != r_key:
        raise RuntimeError("fair: job results differ")
    if not card.action_trace:
        raise RuntimeError("fair: no actions, nothing probed")
    if counts["price"] == 0 or len(got["prices"]) != counts["price"]:
        raise RuntimeError(f"fair: B5 launched {counts['price']} times for "
                           f"{len(got['prices'])} pricing calls")
    if card.shuffle.n_reallocs == 0:
        raise RuntimeError("fair: no transfer was re-priced")
    if "state" not in got:
        raise RuntimeError("fair: no snapshot at the sweep time")
    net, ref_net = card.cluster.net, ref.cluster.net
    print(f"fair path bino ({N_WORKERS} nodes, {N_RACKS} racks): identical "
          f"traces ({len(card.action_trace)} actions, {len(c_launch)} "
          f"attempt launches, {len(c_key)} jobs finished); re-priced "
          f"transfers {card.shuffle.n_reallocs}; card: water-fill calls "
          f"{bulk.n_calls}, rounds {bulk.n_rounds}, wall "
          f"{bulk.wall['waterfill']:.6f} s, pricing calls {bulk.n_prices}, "
          f"wall {bulk.wall['price']:.6f} s, solver recomputes "
          f"{net.n_recomputes}, {card.assess_ticks} assess ticks, "
          f"assess_wall "
          f"{card.assess_wall:.6f} s, "
          f"{card.assess_ticks / card.assess_wall:.3f} ticks/s, wall "
          f"{c_wall:.6f} s; numpy: solver recomputes "
          f"{ref_net.n_recomputes}, water-fill wall "
          f"{ref_bulk.wall['waterfill']:.6f} s, pricing wall "
          f"{ref_bulk.wall['price']:.6f} s, re-priced "
          f"{ref.shuffle.n_reallocs}, "
          f"{ref.assess_ticks} ticks, assess_wall {ref.assess_wall:.6f} s, "
          f"{ref.assess_ticks / ref.assess_wall:.3f} ticks/s, wall "
          f"{r_wall:.6f} s; kernel launches {counts}", flush=True)
    return counts, got


def price_phase(prices):
    """B5 against its plain version on every pricing call of the fair
    card run, as ``TorchBulk.price`` pads them; timed on the largest."""
    from repro_torch.accel import bulk as B

    err, largest = 0.0, None
    for share, links, valid in prices:
        cpu = tuple(torch.from_numpy(x)
                    for x in (share, *B.pad_flows(links, valid)))
        dev = tuple(x.cuda() for x in cpu)
        equal, e = _compare(B.price(*dev), B.price_ref(*cpu))
        if not equal:
            raise RuntimeError(f"price: kernel != plain version on a "
                               f"recorded call (k {len(links)}, "
                               f"max_abs_err {e})")
        err = max(err, e)
        if largest is None or dev[1].shape[0] > largest[1].shape[0]:
            largest = dev
    got = B.price(*largest)
    print(f"price: kernel equal to its plain version on {len(prices)} "
          f"recorded calls (largest cap {largest[1].shape[0]}, nL "
          f"{largest[0].shape[0]})", flush=True)
    return timed_row("price", B.price, B.price_ref, largest, got, err,
                     "src/repro_torch/accel/csrc/bulk.cu",
                     "src/repro/accel/bulk.py:252 "
                     "PallasBulk._price_core.kernel")


def sweep_path(state, now, device="cuda", n_scen=N_SCENARIOS,
               racks=N_RACKS):
    """The batched sweep on the fair run's snapshot: ``run_batched`` on
    ``device`` against ``run_serial`` on numpy, every scenario and field
    exactly. Returns (the sweep, launch counts of the batched call)."""
    from repro_torch.accel import kernels as K
    from repro_torch.accel.sweep import BatchedSweep, scenario_grid
    from repro_torch.core.arrays import snapshot_from_state

    arr = snapshot_from_state(state)
    grid = scenario_grid(n_scen, len(arr.node_ids), seed=1, n_racks=racks)
    kinds = sorted({sc.kind for sc in grid})
    if len(kinds) != 5:
        raise RuntimeError(f"sweep: scenario kinds {kinds}, expected 5")
    sweep = BatchedSweep(arr, now).prepare(grid)
    K.reset_launches()
    batched = sweep.run_batched(device)
    counts = dict(K.launches)
    serial = sweep.run_serial()
    for i, (b, r) in enumerate(zip(batched, serial)):
        for field in r:
            if not np.array_equal(np.asarray(b[field]),
                                  np.asarray(r[field])):
                raise RuntimeError(f"sweep: scenario {i} ({grid[i].kind}) "
                                   f"field {field} differs from serial")
    if len(batched) != len(serial) or len(serial) != n_scen:
        raise RuntimeError("sweep: scenario count differs")
    if device != "cpu":
        want = {"spatial_sweep": 1, "spatial_sweep_jobs": 1,
                "late_sweep": 1, "late_sweep_jobs": 1, "reap_sweep": 1}
        seen = {k: counts[k] for k in want}
        if seen != want:
            raise RuntimeError(f"sweep: launches {seen}, expected {want}")

    def ms(fn, reps=3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    batched_ms = ms(lambda: sweep.run_batched(device))
    serial_ms = ms(sweep.run_serial)
    summary = {
        "victims": sum(int((r["late_victims"] >= 0).sum()) for r in serial),
        "spatial_hits": sum(int(r["spatial_hits"].sum()) for r in serial),
        "failed": sum(int(r["failed"].sum()) for r in serial),
        "winning": sum(int(r["winning"].sum()) for r in serial),
        "n_reap": sum(r["n_reap"] for r in serial)}
    print(f"sweep path: {n_scen} scenarios ({', '.join(kinds)}) at "
          f"t={now} on {arr.n} rows, {len(sweep.active)} jobs: run_batched "
          f"equal to run_serial in every field; totals {summary}; "
          f"batched {batched_ms:.3f} ms, serial {serial_ms:.3f} ms per "
          f"sweep; kernel launches {counts}", flush=True)
    return sweep, counts


def batched_kernel_phase(sweep):
    """B1, B3 and B4 with the scenario axis on the sweep's own inputs:
    equal to the plain versions on CPU copies and to one N = 1 launch
    per scenario; timed."""
    from repro_torch.accel import torch_backend as TB

    dev_args, _cols = sweep.kernel_args("cuda")
    cpu_args, _cols = sweep.kernel_args("cpu")
    fns = {"spatial": (TB.spatial, TB.spatial_ref),
           "late": (TB.late, TB.late_ref),
           "reap": (TB.reap, TB.reap_ref)}
    rows = {}
    for name, (wrapper, plain) in fns.items():
        args = dev_args[name]
        got = wrapper(*args)
        want = plain(*cpu_args[name])
        equal, err = _compare(got, want)
        if not equal:
            raise RuntimeError(f"{name}_sweep: kernel != plain version "
                               f"(max_abs_err {err})")
        n = args[0].shape[0]
        singles = [wrapper(*one_scenario(name, args, s)) for s in range(n)]
        if isinstance(got, tuple):
            singles = tuple(torch.stack(x) for x in zip(*singles))
        else:
            singles = torch.stack(singles)
        equal, _err = _compare(got, singles)
        if not equal:
            raise RuntimeError(f"{name}_sweep: batched launch != {n} "
                               f"single-scenario launches")
        rows[name + "_sweep"] = timed_row(
            name + "_sweep", wrapper, plain, args, got, err,
            "src/repro_torch/accel/csrc/assess.cu",
            f"{REPLACES[name]} (scenario axis: the vmap of "
            f"src/repro/accel/sweep.py:138)")
    return rows


def profile_bino() -> None:
    """Device time by kernel over one bino card run, and the device's
    busy share of its wall time (the sum of kernel and copy times, which
    do not overlap on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim, _l, _k, wall = scenario("bino", None)
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == cuda)
    print(f"profile bino: wall {wall:.6f} s (profiled), assess_wall "
          f"{sim.assess_wall:.6f} s, {sim.assess_ticks} ticks, device busy "
          f"{dev_us / 1e6:.6f} s = {dev_us / 1e6 / wall:.6f} of wall")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60), flush=True)


def _sub_kernels(what: str, fn, args, names, reps: int = 20) -> None:
    """Prints the profiler's device time per launch of each kernel whose
    name holds one of ``names``, over ``reps`` calls of ``fn`` (averages
    over the records it keeps: it may drop some, so these split a call's
    time between its kernels and do not time the call)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    per = {}
    for e in prof.key_averages():
        hit = [n for n in names if n in e.key]
        if e.device_type == cuda and hit and e.count:
            per[hit[0]] = round(e.self_device_time_total / e.count, 3)
    print(f"{what}: device us per launch by kernel (profiler) "
          f"{json.dumps(per)}", flush=True)


# ---------------------------------------------------------------------------
# Attention kernels B6 and B9
# ---------------------------------------------------------------------------
# Boundary inputs: (b, sq, sk, hq, hkv, d, causal, window) for B6 and
# (b, S, hq, hkv, d, valid lengths) for B9. No row is left without an
# unmasked key (B6's plain version masks with -1e30, the oracle with -inf).
FLASH_CASES = [
    (1, 100, 300, 4, 1, 64, True, 0),      # sq < sk (q_offset 200), ragged
    (2, 130, 130, 8, 2, 128, True, 0),     # sq not a multiple of the tile
    (1, 200, 300, 48, 1, 128, True, 64),   # a group of 48, a window
    (2, 64, 64, 4, 4, 64, False, 0),       # group 1, not causal
    (1, 77, 256, 32, 8, 128, False, 40),   # a window without the band
    # the Hopper body's 128 x 128 tile edges
    (1, 127, 127, 8, 2, 128, True, 0),     # one row and key short
    (1, 128, 128, 8, 2, 128, True, 0),     # exactly one tile
    (1, 129, 129, 8, 2, 128, True, 0),     # one row and key past it
    (1, 127, 129, 16, 16, 64, True, 0),    # the training layout, q_offset 2
    (1, 129, 300, 48, 1, 128, True, 0),    # a group of 48, q_offset 171
    (2, 300, 300, 16, 4, 128, True, 0),    # a group of 4, ragged
    (1, 300, 300, 16, 16, 64, True, 100),  # a window crossing a tile
    # head_dim 80 (hubert-xlarge), on the SIMT body in both types
    (1, 130, 130, 16, 16, 80, False, 0),   # the encoder's layout, ragged
    (2, 64, 64, 4, 4, 80, False, 0),       # exactly one tile
    (1, 100, 200, 8, 2, 80, True, 0),      # causal, GQA-4, q_offset 100
    (1, 129, 129, 4, 4, 80, True, 0),      # causal, one row past a tile
]
DECODE_CASES = [
    (5, 300, 4, 4, 64, (1, 63, 64, 65, 300)),     # group 1, tile edges
    (4, 4096, 32, 8, 128, (1, 127, 129, 4096)),   # group 4, valid at S
    (3, 256, 48, 1, 128, (128, 255, 256)),        # a group of 48
    # the split-KV body's 128-key splits and 32-key tiles
    (6, 800, 32, 8, 128, (127, 128, 129, 255, 256, 257)),   # split edges
    (4, 769, 16, 4, 64, (31, 33, 769, 5000)),     # a ragged last split,
                                                  # valid past S
    (3, 1024, 48, 1, 128, (1, 700, 1024)),        # a group of 48, 4 splits
    (2, 257, 8, 2, 16, (256, 257)),               # head_dim 16
    (2, 600, 64, 1, 32, (300, 600)),              # a group of 64
    # head_dim 80: 10 (bf16) or 20 (f32) 16-byte chunks a row
    (4, 800, 16, 16, 80, (127, 128, 129, 257)),   # split edges, group 1
    (3, 300, 16, 8, 80, (1, 32, 300)),            # tile edges, group 2
]
FLASH_SOURCE = "src/repro_torch/accel/csrc/flash_attention_sm90.cuh"
# Qwen1.5-0.5B's attention layer, the training path's B6 shape: (b, s,
# hq, hkv, d), causal, bf16.
FLASH_TRAIN_SHAPE = (1, 2048, 16, 16, 64)
# hubert-xlarge's attention layer as the audio path runs it: (b, s, hq,
# hkv, d), non-causal, bf16, on the SIMT body.
FLASH_HD80_SHAPE = (4, 2048, 16, 16, 80)
DECODE_SOURCE = "src/repro_torch/accel/csrc/decode_attention.cu"
FLASH_REPLACES = ("src/repro/kernels/flash_attention/flash_attention.py:38 "
                  "_fwd_kernel (pallas_call :141)")
DECODE_REPLACES = ("src/repro/kernels/decode_attention/decode_attention.py"
                   ":28 _decode_kernel (pallas_call :108)")


def _randn(seed: int, dtype, *shapes):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in shapes]


def _within(what: str, got, want, tol: float) -> float:
    """max |got - want|; raises unless |got - want| <= tol + tol |want|
    everywhere (NaN where both are NaN counts as equal)."""
    got, want = got.float(), want.float()
    both_nan = torch.isnan(got) & torch.isnan(want)
    diff = torch.where(both_nan, 0.0, (got - want).abs())
    ok = bool((diff <= tol + tol * want.abs().nan_to_num()).all())
    err = float(diff.max()) if diff.numel() else 0.0
    if not ok or err != err:
        raise RuntimeError(f"{what}: kernel vs plain version max_abs_err "
                           f"{err}, tolerance {tol}")
    return err


def _within_decode(what: str, got, want) -> float:
    """max |got - want| of B9's bf16 output (b, hq, d); raises unless
    |got - want| <= 2^-7 |want| + 1e-2 RMS(want over its sequence)
    everywhere (``DECODE_BF16_TOL``; NaN where both are NaN counts as
    equal)."""
    rel, frac = DECODE_BF16_TOL
    got, want = got.float(), want.float()
    both_nan = torch.isnan(got) & torch.isnan(want)
    diff = torch.where(both_nan, 0.0, (got - want).abs())
    w = want.nan_to_num()
    rms = w.pow(2).mean(dim=tuple(range(1, w.dim())), keepdim=True).sqrt()
    ok = bool((diff <= rel * w.abs() + frac * rms).all())
    err = float(diff.max()) if diff.numel() else 0.0
    if not ok or err != err:
        raise RuntimeError(f"{what}: kernel vs plain version max_abs_err "
                           f"{err}, tolerance {rel} |ref| + {frac} RMS")
    return err


def _causal_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for one (sequence, head)."""
    rows = torch.arange(sq)[:, None] + (sk - sq)
    cols = torch.arange(sk)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep &= cols <= rows
    if window:
        keep &= cols > rows - window
    return int(keep.sum())


def _attn_row(name, ms, plain_ms, library_ms, bytes_, ops, dtype, err,
              source, replaces):
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    lib = "none" if library_ms is None else f"{library_ms:.6f}"
    print(f"kernel {name}: max_abs_err={err} ms={ms:.6f} plain_ms="
          f"{plain_ms:.6f} library_ms={lib} bytes={bytes_} "
          f"ops={ops}", flush=True)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "bytes": bytes_, "ops": ops,
    }


def attention_kernel_phase():
    """B6 and B9 against their plain versions on boundary inputs, then at
    the serving path's shapes, timed beside the plain versions and
    ``scaled_dot_product_attention`` (the yardstick)."""
    import torch.nn.functional as F

    from repro_torch.accel import kernels as K
    from repro_torch.kernels.decode_attention import decode_attention as DA
    from repro_torch.kernels.flash_attention import flash_attention as FA

    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dtype]
        for case in FLASH_CASES:
            b, sq, sk, hq, hkv, d, causal, window = case
            q, k, v = _randn(seed, dtype, (b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d))
            seed += 1
            before = dict(K.launches)
            out, lse = FA.flash_attention_fwd(q, k, v, causal=causal,
                                              window=window)
            tc = K.flash_fwd_tc(dtype, d)
            got = {key: K.launches[key] - before[key]
                   for key in ("flash_fwd", "flash_fwd_tc")}
            if got != {"flash_fwd": 1, "flash_fwd_tc": int(tc)}:
                raise RuntimeError(f"flash_fwd {case} {dtype}: launches "
                                   f"{got}, Hopper body expected: {tc}")
            again = FA.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
            if not (torch.equal(out, again[0]) and torch.equal(lse,
                                                               again[1])):
                raise RuntimeError(f"flash_fwd {case} {dtype}: two launches "
                                   f"on the same inputs differ")
            pout, plse = FA.flash_attention_plain(q, k, v, causal=causal,
                                                  window=window)
            _within(f"flash_fwd {case} {dtype} out", out, pout, tol)
            _within(f"flash_fwd {case} {dtype} lse", lse, plse, LSE_TOL)
        for case in DECODE_CASES:
            b, S, hq, hkv, d, valid = case
            q, k, v = _randn(seed, dtype, (b, hq, d), (b, S, hkv, d),
                             (b, S, hkv, d))
            seed += 1
            vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
            before = dict(K.launches)
            out = DA.decode_attention_fwd(q, k, v, vl)
            got = {key: K.launches[key] - before[key]
                   for key in ("decode", "decode_combine")}
            if got != {"decode": 1, "decode_combine": 1}:
                raise RuntimeError(f"decode {case} {dtype}: launches {got}")
            if not _same_bits(out, DA.decode_attention_fwd(q, k, v, vl)):
                raise RuntimeError(f"decode {case} {dtype}: two launches "
                                   f"on the same inputs differ")
            want = DA.decode_attention_plain(q, k, v, vl)
            if dtype == torch.bfloat16:
                _within_decode(f"decode {case} {dtype}", out, want)
            else:
                _within(f"decode {case} {dtype}", out, want, tol)
    torch.cuda.synchronize()
    print(f"attention boundary inputs: B6 ({len(FLASH_CASES)} cases, each "
          f"launched twice with byte-identical results, bf16 at head_dim "
          f"64/128 on the Hopper body) and B9 ({len(DECODE_CASES)} cases, "
          f"the split kernel and its combine launched once a call, each "
          f"call twice with byte-identical results) within tolerance of "
          f"their plain versions in float32 and bf16", flush=True)
    family_attention_checks()

    cfg_b, cfg_s, hq, hkv, d = (SERVE_BATCH, SERVE_PROMPT, 32, 8, 128)
    bf16 = torch.bfloat16
    rows = {}
    # B6 at the prefill shape
    q, k, v = _randn(100, bf16, (cfg_b, cfg_s, hq, d), (cfg_b, cfg_s, hkv, d),
                     (cfg_b, cfg_s, hkv, d))
    before = K.launches["flash_fwd"]
    out, lse = FA.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    if K.launches["flash_fwd"] != before + 1:
        raise RuntimeError("flash_fwd: the wrapper did not launch")
    pout, plse = FA.flash_attention_plain(q, k, v)
    err = _within("flash_fwd at the prefill shape", out, pout,
                  ATTN_TOL[bf16])
    _within("flash_fwd lse at the prefill shape", lse, plse, LSE_TOL)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa_prefill():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_err = float((sdpa_prefill().transpose(1, 2).float()
                     - out.float()).abs().max())
    pairs = _causal_pairs(cfg_s, cfg_s, True, 0)
    rows["flash_fwd"] = _attn_row(
        "flash_fwd", _time_ms(FA.flash_attention_fwd, (q, k, v)),
        _time_ms(FA.flash_attention_plain, (q, k, v), reps=5),
        _time_ms(sdpa_prefill, ()),
        sum(_nbytes(x) for x in (q, k, v, out, lse)),
        4.0 * cfg_b * hq * d * pairs, bf16, err, FLASH_SOURCE,
        FLASH_REPLACES)
    rows["flash_fwd"].update(
        device_ms=_device_ms(FA.flash_attention_fwd, (q, k, v)),
        library_device_ms=_device_ms(sdpa_prefill, ()))
    print(f"flash_fwd vs scaled_dot_product_attention: max_abs_err "
          f"{lib_err}; device time {rows['flash_fwd']['device_ms']:.6f} ms "
          f"per call, SDPA's {rows['flash_fwd']['library_device_ms']:.6f} "
          f"ms (events behind a sleep kernel)", flush=True)
    del q, k, v, out, lse, pout, plse, qt, kt, vt

    # B6 at the training path's layer, beside SDPA at the same shape
    tb, ts, thq, thkv, td = FLASH_TRAIN_SHAPE
    q, k, v = _randn(102, bf16, (tb, ts, thq, td), (tb, ts, thkv, td),
                     (tb, ts, thkv, td))
    out, lse = FA.flash_attention_fwd(q, k, v)
    pout, plse = FA.flash_attention_plain(q, k, v)
    t_err = _within("flash_fwd at the training shape", out, pout,
                    ATTN_TOL[bf16])
    _within("flash_fwd lse at the training shape", lse, plse, LSE_TOL)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa_train():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    t_bytes = sum(_nbytes(x) for x in (q, k, v, out, lse))
    t_ops = 4.0 * tb * thq * td * _causal_pairs(ts, ts, True, 0)
    train = _attn_row(
        "flash_fwd (training shape)",
        _time_ms(FA.flash_attention_fwd, (q, k, v)),
        _time_ms(FA.flash_attention_plain, (q, k, v), reps=5),
        _time_ms(sdpa_train, ()), t_bytes, t_ops, bf16, t_err, FLASH_SOURCE,
        FLASH_REPLACES)
    # a call at this shape is shorter than the host's time per call: the
    # device time (``_device_ms``) beside the event time
    dev_ms = _device_ms(FA.flash_attention_fwd, (q, k, v))
    lib_dev_ms = _device_ms(sdpa_train, ())
    rows["flash_fwd"].update(
        train_shape=list(FLASH_TRAIN_SHAPE), train_ms=train["ms"],
        train_device_ms=dev_ms, train_plain_ms=train["plain_ms"],
        train_library_ms=train["library_ms"],
        train_library_device_ms=lib_dev_ms,
        train_bound_ms=train["bound_ms"], train_bound_by=train["bound_by"])
    print(f"flash_fwd at the training shape {FLASH_TRAIN_SHAPE}: device "
          f"time {dev_ms:.6f} ms per call, SDPA's {lib_dev_ms:.6f} ms "
          f"(events behind a sleep kernel); event time {train['ms']:.6f} and "
          f"{train['library_ms']:.6f} ms", flush=True)
    del q, k, v, out, lse, pout, plse, qt, kt, vt

    # B6 at hubert-xlarge's layer (head_dim 80, non-causal, SIMT body)
    hb, hs, hhq, hhkv, hd = FLASH_HD80_SHAPE
    q, k, v = _randn(103, bf16, (hb, hs, hhq, hd), (hb, hs, hhkv, hd),
                     (hb, hs, hhkv, hd))
    before = dict(K.launches)
    out, lse = FA.flash_attention_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    got = {key: K.launches[key] - before[key]
           for key in ("flash_fwd", "flash_fwd_tc")}
    if got != {"flash_fwd": 1, "flash_fwd_tc": 0}:
        raise RuntimeError(f"flash_fwd at head_dim 80: launches {got}, the "
                           f"SIMT body expected")
    again = FA.flash_attention_fwd(q, k, v, causal=False)
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise RuntimeError("flash_fwd at head_dim 80: two launches differ")
    pout, plse = FA.flash_attention_plain(q, k, v, causal=False)
    h_err = _within("flash_fwd at head_dim 80", out, pout, ATTN_TOL[bf16])
    _within("flash_fwd lse at head_dim 80", lse, plse, LSE_TOL)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa_hd80():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)

    def b6_hd80(q, k, v):
        return FA.flash_attention_fwd(q, k, v, causal=False)

    def plain_hd80(q, k, v):
        return FA.flash_attention_plain(q, k, v, causal=False)

    h_lib_err = float((sdpa_hd80().transpose(1, 2).float()
                       - out.float()).abs().max())
    hd80 = _attn_row(
        "flash_fwd (head_dim 80)", _time_ms(b6_hd80, (q, k, v)),
        _time_ms(plain_hd80, (q, k, v), reps=3),
        _time_ms(sdpa_hd80, ()), sum(_nbytes(x) for x in (q, k, v, out, lse)),
        4.0 * hb * hhq * hd * hs * hs, bf16, h_err, FLASH_SOURCE,
        FLASH_REPLACES)
    hd80_dev = _device_ms(b6_hd80, (q, k, v))
    hd80_lib_dev = _device_ms(sdpa_hd80, ())
    rows["flash_fwd"].update(
        hd80_shape=list(FLASH_HD80_SHAPE), hd80_ms=hd80["ms"],
        hd80_device_ms=hd80_dev, hd80_plain_ms=hd80["plain_ms"],
        hd80_library_ms=hd80["library_ms"],
        hd80_library_device_ms=hd80_lib_dev,
        hd80_bound_ms=hd80["bound_ms"], hd80_bound_by=hd80["bound_by"],
        hd80_max_abs_err=h_err)
    print(f"flash_fwd at head_dim 80 {FLASH_HD80_SHAPE} (non-causal, SIMT "
          f"body): device time {hd80_dev:.6f} ms per call, SDPA's "
          f"{hd80_lib_dev:.6f} ms (events behind a sleep kernel); event time "
          f"{hd80['ms']:.6f} and {hd80['library_ms']:.6f} ms; bound "
          f"{hd80['bound_ms']:.6f} ms ({hd80['bound_by']}); vs SDPA "
          f"max_abs_err {h_lib_err}", flush=True)
    del q, k, v, out, lse, pout, plse, qt, kt, vt

    # B9 at the decode shape: a 4,096-slot cache filled to 2,100
    n = 2100
    q, k, v = _randn(101, bf16, (cfg_b, hq, d), (cfg_b, SERVE_MAX_LEN, hkv, d),
                     (cfg_b, SERVE_MAX_LEN, hkv, d))
    vl = torch.full((cfg_b,), n, dtype=torch.int32, device="cuda")
    before = K.launches["decode"]
    out = DA.decode_attention_fwd(q, k, v, vl)
    torch.cuda.synchronize()
    if K.launches["decode"] != before + 1:
        raise RuntimeError("decode: the wrapper did not launch")
    want = DA.decode_attention_plain(q, k, v, vl)
    err = _within_decode("decode at the serving shape", out, want)
    # a planted fault: a combine that skips the last live split gives the
    # attention over the keys before that split; it must fail the check
    cut = (vl - 1) // DA.SPLIT * DA.SPLIT
    dropped = DA.decode_attention_plain(q, k, v, cut)
    try:
        _within_decode("decode, last live split dropped", dropped, want)
    except RuntimeError as e:
        print(f"decode probe (the last live split dropped) fails the bf16 "
              f"check, as it must: {e}", flush=True)
    else:
        raise RuntimeError("decode: dropping the last live split passes "
                           "the bf16 check")
    q4 = q[:, :, None].contiguous()
    k4, v4 = (x[:, :n].transpose(1, 2).contiguous() for x in (k, v))

    def sdpa_decode():
        return F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True)

    lib_err = float((sdpa_decode()[:, :, 0].float() - out.float())
                    .abs().max())
    kv_bytes = 2 * cfg_b * n * hkv * d * k.element_size()
    rows["decode"] = _attn_row(
        "decode", _time_ms(DA.decode_attention_fwd, (q, k, v, vl)),
        _time_ms(DA.decode_attention_plain, (q, k, v, vl), reps=10),
        _time_ms(sdpa_decode, ()),
        _nbytes(q) + kv_bytes + _nbytes(vl) + _nbytes(out),
        4.0 * cfg_b * hq * d * n, bf16, err, DECODE_SOURCE, DECODE_REPLACES)
    # a call at this shape is shorter than the host's time per call: the
    # device time of both (``_device_ms``) beside the event times
    rows["decode"].update(
        device_ms=_device_ms(DA.decode_attention_fwd, (q, k, v, vl)),
        library_device_ms=_device_ms(sdpa_decode, ()))
    _sub_kernels("decode at the serving shape", DA.decode_attention_fwd,
                 (q, k, v, vl), ("decode_split_kernel",
                                 "decode_combine_kernel"))
    print(f"decode vs scaled_dot_product_attention: max_abs_err {lib_err}; "
          f"device time {rows['decode']['device_ms']:.6f} ms per call, "
          f"SDPA's {rows['decode']['library_device_ms']:.6f} ms (events "
          f"behind a sleep kernel)", flush=True)
    del q, k, v, q4, k4, v4, out, want, dropped

    # B9 at head_dim 80: hubert-xlarge's head layout in the serving
    # decode's shape (no registry decoder has head_dim 80; the kernel
    # phase alone runs it)
    hb, _s, hhq, hhkv, hd = FLASH_HD80_SHAPE
    q, k, v = _randn(104, bf16, (hb, hhq, hd), (hb, SERVE_MAX_LEN, hhkv, hd),
                     (hb, SERVE_MAX_LEN, hhkv, hd))
    vl = torch.full((hb,), n, dtype=torch.int32, device="cuda")
    out = DA.decode_attention_fwd(q, k, v, vl)
    if not _same_bits(out, DA.decode_attention_fwd(q, k, v, vl)):
        raise RuntimeError("decode at head_dim 80: two launches differ")
    h_err = _within_decode("decode at head_dim 80",
                           out, DA.decode_attention_plain(q, k, v, vl))
    q4 = q[:, :, None].contiguous()
    k4, v4 = (x[:, :n].transpose(1, 2).contiguous() for x in (k, v))

    def sdpa_decode_hd80():
        return F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True)

    hd80 = _attn_row(
        "decode (head_dim 80)",
        _time_ms(DA.decode_attention_fwd, (q, k, v, vl)),
        _time_ms(DA.decode_attention_plain, (q, k, v, vl), reps=10),
        _time_ms(sdpa_decode_hd80, ()),
        _nbytes(q) + 2 * hb * n * hhkv * hd * k.element_size()
        + _nbytes(vl) + _nbytes(out), 4.0 * hb * hhq * hd * n, bf16, h_err,
        DECODE_SOURCE, DECODE_REPLACES)
    hd80_dev = _device_ms(DA.decode_attention_fwd, (q, k, v, vl))
    hd80_lib_dev = _device_ms(sdpa_decode_hd80, ())
    rows["decode"].update(
        hd80_shape=[hb, SERVE_MAX_LEN, hhq, hhkv, hd, n],
        hd80_ms=hd80["ms"], hd80_device_ms=hd80_dev,
        hd80_plain_ms=hd80["plain_ms"], hd80_library_ms=hd80["library_ms"],
        hd80_library_device_ms=hd80_lib_dev, hd80_bound_ms=hd80["bound_ms"],
        hd80_bound_by=hd80["bound_by"], hd80_max_abs_err=h_err,
        hd80_launches=0)
    print(f"decode at head_dim 80 (b {hb}, {SERVE_MAX_LEN} slots filled to "
          f"{n}, {hhq}/{hhkv} heads): device time {hd80_dev:.6f} ms per "
          f"call, SDPA's {hd80_lib_dev:.6f} ms; event time {hd80['ms']:.6f} "
          f"and {hd80['library_ms']:.6f} ms; bound {hd80['bound_ms']:.6f} ms "
          f"({hd80['bound_by']})", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Serving path: Qwen3-8B at full width
# ---------------------------------------------------------------------------
class _CountCalls:
    """Counts calls of ``module.name`` for each (module, name) pair while
    the ``with`` block runs (the counts add up over repeated blocks);
    restores them after."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = {}

    def __enter__(self):
        self._saved = []
        for mod, name in self.targets:
            orig = getattr(mod, name)
            key = f"{mod.__name__}.{name}"
            self.calls.setdefault(key, 0)

            def counted(*a, _orig=orig, _key=key, **kw):
                self.calls[_key] += 1
                return _orig(*a, **kw)
            setattr(mod, name, counted)
            self._saved.append((mod, name, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)
        return False


def _rel_err(got, ref) -> float:
    """max |got - ref| over the RMS of ``ref``."""
    ref = ref.float()
    rms = float(ref.pow(2).mean().sqrt())
    return float((got.float() - ref).abs().max()) / rms


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_path(cfg=None, device="cuda"):
    """Qwen3-8B at full width (or ``cfg``): prefill 4 x 2,048 tokens, then
    64 greedy decode steps, through the port's serving entry points, on
    ``device`` (a CPU run rehearses the path on the plain versions, with
    no launch to count). Returns the launch counts of the run."""
    from repro_torch.accel import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention as DA
    from repro_torch.kernels.decode_attention import ref as DREF
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM
    from repro_torch.train.loop import (TrainConfig, make_prefill_step,
                                        make_serve_step)

    # the f32 reference must be f32: no TF32 in products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or get_config(SERVE_ARCH)
    on_card = torch.device(device).type == "cuda"
    B, P = SERVE_BATCH, SERVE_PROMPT
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SERVE_SEED)
    params = PM.init_params(cfg, gen, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in params.parameters())
    rng = np.random.default_rng(SERVE_SEED)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))
                               .astype(np.int32)).to(device)
    tc = TrainConfig()
    prefill_step = make_prefill_step(cfg, tc, max_len=SERVE_MAX_LEN)
    serve_step = make_serve_step(cfg, tc)
    print(f"serve: {SERVE_ARCH} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"{n_params} parameters ({weight_bytes} bytes, bf16), init "
          f"{init_s:.3f} s", flush=True)

    # warm-up on a short prompt (library handles, allocator), uncounted
    w = min(64, P // 2)
    _l, warm = make_prefill_step(cfg, tc, max_len=w + 1)(
        params, {"tokens": prompts[:, :w]})
    serve_step(params, warm, prompts[:, w], torch.full(
        (B,), w, dtype=torch.int32, device=device))
    del warm
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    plain = _CountCalls([(FA, "flash_attention_plain"),
                         (DA, "decode_attention_plain"),
                         (FREF, "attention_reference"),
                         (DREF, "decode_attention_reference")])
    K.reset_launches()
    with plain:
        t0 = time.perf_counter()
        logits0, cache = prefill_step(params, {"tokens": prompts})
        _sync(device)
        prefill_s = time.perf_counter() - t0
        after_prefill = dict(K.launches)
        tok = logits0.argmax(-1).to(torch.int32)
        inputs, checks = [tok], {}
        pos = torch.full((B,), P, dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        for step in range(1, SERVE_STEPS + 1):
            logits, cache = serve_step(params, cache, tok, pos)
            if step in SERVE_CHECKS:
                checks[step] = logits.float()
            tok = logits.argmax(-1).to(torch.int32)
            inputs.append(tok)
            pos = pos + 1
        _sync(device)
        decode_s = time.perf_counter() - t0
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    L_ = cfg.n_layers if on_card else 0
    # every B6 launch on its Hopper body (bf16, head_dim 128)
    # every B9 call one split-KV launch and one combine
    want_prefill = {"flash_fwd": L_, "flash_fwd_tc": L_, "decode": 0,
                    "decode_combine": 0}
    want = {"flash_fwd": L_, "flash_fwd_tc": L_, "decode": L_ * SERVE_STEPS,
            "decode_combine": L_ * SERVE_STEPS}
    if {k: after_prefill[k] for k in want_prefill} != want_prefill:
        raise RuntimeError(f"serve: prefill launches {after_prefill}, "
                           f"expected {want_prefill}")
    others = {k: c for k, c in counts.items() if k not in want and c}
    if {k: counts[k] for k in want} != want or others:
        raise RuntimeError(f"serve: launches {counts}, expected {want}")
    if on_card and any(plain.calls.values()):
        raise RuntimeError(f"serve: plain versions called on the card's "
                           f"path: {plain.calls}")
    print(f"serve: prefill {B} x {P} tokens {prefill_s * 1e3:.3f} ms "
          f"({B * P / prefill_s:.1f} tokens/s); decode {SERVE_STEPS} steps "
          f"{decode_s * 1e3 / SERVE_STEPS:.3f} ms/step "
          f"({B * SERVE_STEPS / decode_s:.1f} tokens/s); peak device memory "
          f"{peak} bytes; kernel launches {counts}; plain-version calls "
          f"{plain.calls}", flush=True)
    del cache

    # Correctness: logits against the port's forward with impl="ref" in
    # float32 over the same prefix (each layer's weights upcast as it
    # runs; the head for the last position only).
    seq = torch.cat([prompts] + [t[:, None] for t in inputs[:-1]], dim=1)
    got = {"prefill": (P, logits0)}
    got.update((f"decode step {k}", (P + k, checks[k]))
               for k in SERVE_CHECKS)
    errs, refs = {}, {}
    with torch.no_grad():
        for label, (n, port) in got.items():
            ref = PM.forward(cfg, params, {"tokens": seq[:, :n]},
                             impl="ref", compute_dtype=torch.float32,
                             last_only=True)[0][:, 0]
            if port.shape != (B, cfg.vocab_size) or \
                    not bool(torch.isfinite(port).all()):
                raise RuntimeError(f"serve: {label} logits not finite of "
                                   f"shape {(B, cfg.vocab_size)}")
            refs[label] = ref
            errs[label] = _rel_err(port, ref)
        # the probe: fp8 activations into every block and the head
        orig = L.apply_norm

        def fp8_norm(c, p, x):
            y = orig(c, p, x)
            return y.to(torch.float8_e4m3fn).to(y.dtype)

        L.apply_norm = fp8_norm
        try:
            probe, _c = PM.prefill(cfg, params, {"tokens": prompts})
        finally:
            L.apply_norm = orig
        del _c
        fp8_err = _rel_err(probe, refs["prefill"])
        # where the error comes from: the same bf16 prefill on the oracles
        oracle, _c = PM.prefill(cfg, params, {"tokens": prompts},
                                impl="ref")
        del _c
    print(f"serve: logits vs the f32 reference, max|diff|/rms: "
          f"{json.dumps(errs)}; tolerance {SERVE_TOL}; fp8-activation "
          f"probe {fp8_err}; bf16 prefill on the oracles vs the f32 "
          f"reference {_rel_err(oracle, refs['prefill'])}, vs the "
          f"kernels' prefill {_rel_err(logits0, oracle)}", flush=True)
    bad = {k: e for k, e in errs.items() if not e <= SERVE_TOL}
    if bad:
        raise RuntimeError(f"serve: logits outside tolerance {SERVE_TOL}: "
                           f"{bad}")
    if not fp8_err > SERVE_TOL:
        raise RuntimeError(f"serve: the fp8 probe ({fp8_err}) passes the "
                           f"tolerance {SERVE_TOL}: it is too loose")
    agree = float((refs["prefill"].argmax(-1).int() == inputs[0])
                  .float().mean())
    print(f"serve: greedy first token equal to the reference's argmax for "
          f"{agree:.2f} of the batch", flush=True)

    if on_card:
        profile_serve(params, prompts, prefill_step, serve_step)
    return counts


def profile_serve(params, batch, prefill_step, serve_step=None,
                  steps: int = 8, label: str = "serve") -> None:
    """Device time by kernel, and the device's busy share of the wall
    time, for one prefill of ``batch`` (token ids, or a dict of the
    model's inputs) and, apart, ``steps`` decode steps (none without a
    ``serve_step``)."""
    from torch.profiler import ProfilerActivity, profile

    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    B = next(iter(batch.values())).shape[0]
    P = sum(t.shape[1] for t in batch.values())    # positions: all inputs
    cuda = torch.autograd.DeviceType.CUDA
    state = {}

    def prefill():
        state["logits"], state["cache"] = prefill_step(params, batch)

    def decode():
        tok = state["logits"].argmax(-1).to(torch.int32)
        pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
        for _ in range(steps):
            logits, state["cache"] = serve_step(params, state["cache"], tok,
                                                pos)
            tok = logits.argmax(-1).to(torch.int32)
            pos = pos + 1

    phases = [("prefill", prefill)]
    if serve_step is not None:
        phases.append((f"{steps} decode steps", decode))
    for what, fn in phases:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in events
                     if e.device_type == cuda)
        print(f"profile {label} {what}: wall {wall:.6f} s (profiled), "
              f"device busy {dev_us / 1e6:.6f} s = {dev_us / 1e6 / wall:.6f} "
              f"of wall")
        print(events.table(sort_by="self_device_time_total", row_limit=12,
                           max_name_column_width=60), flush=True)
    state.clear()


# ---------------------------------------------------------------------------
# Attention backward kernels B7 and B8
# ---------------------------------------------------------------------------
# Boundary inputs: (b, sq, sk, hq, hkv, d, causal, window); every query row
# keeps at least one key. In bf16 every case at head_dim 64/128 runs the
# Hopper bodies (the GQA group above 1 through the group sum), the case at
# head_dim 32 the SIMT bodies.
BWD_CASES = [
    (1, 100, 300, 4, 1, 64, True, 0),      # sq < sk, ragged, a group of 4
    (2, 130, 130, 8, 8, 128, True, 0),     # group 1, sq = sk off the tile
    (1, 200, 300, 16, 2, 128, True, 64),   # a group of 8, a window
    (2, 64, 64, 4, 4, 64, False, 0),       # not causal
    (1, 77, 256, 32, 8, 128, False, 40),   # a window without the band
    (1, 96, 96, 8, 1, 64, True, 16),       # a group of 8, a narrow window
    (1, 100, 300, 4, 1, 32, True, 0),      # head_dim 32: the SIMT bodies
    # head_dim 80 (hubert-xlarge), the SIMT bodies in both types
    (2, 130, 130, 16, 16, 80, False, 0),   # the encoder's layout, ragged
    (1, 100, 300, 4, 2, 80, True, 0),      # sq < sk, a group of 2
    (1, 200, 200, 8, 4, 80, True, 64),     # a window, a group of 2
    (1, 64, 192, 4, 4, 80, False, 40),     # a window without the band
]
# The f32 kernels against autograd of the oracle (tests/test_kernels.py:
# 83-90): 1e-3.
BWD_ORACLE_TOL = 1e-3
# Training shapes: Qwen1.5-0.5B's layer (the main path), Qwen3-8B's head
# layout, and hubert-xlarge's training layer (its audio training path's
# microbatch, head_dim 80 on the SIMT bodies): (b, s, hq, hkv, d,
# causal), bf16.
BWD_SHAPES = {"qwen1.5-0.5b": (1, 2048, 16, 16, 64, True),
              "qwen3-8b": (1, 4096, 32, 8, 128, True),
              "hubert-xlarge": (2, 4096, 16, 16, 80, False)}
BWD_SOURCE = "src/repro_torch/accel/csrc/flash_attention_bwd_sm90.cuh"
BWD_SIMT_SOURCE = "src/repro_torch/accel/csrc/flash_attention_bwd.cu"
DKV_REPLACES = ("src/repro/kernels/flash_attention/flash_attention.py:169 "
                "_dkv_kernel (pallas_call :322)")
DQ_REPLACES = ("src/repro/kernels/flash_attention/flash_attention.py:235 "
               "_dq_kernel (pallas_call :361)")
BWD_KEYS = ("flash_dkv", "flash_dkv_tc", "flash_dkv_group_sum", "flash_dq",
            "flash_dq_tc")


def _bwd_case(seed, dtype, b, sq, sk, hq, hkv, d, causal, window):
    """q, k, v, dO and the forward's lse and delta (B6 on the card)."""
    from repro_torch.kernels.flash_attention import flash_attention as FA

    q, k, v, do = _randn(seed, dtype, (b, sq, hq, d), (b, sk, hkv, d),
                         (b, sk, hkv, d), (b, sq, hq, d))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    return q, k, v, do, lse, FA.bwd_delta(out, do)


def _bwd_launch_twice(what, args, causal, window):
    """B7 then B8, twice on the same inputs: raises unless the two give the
    same bits and every launch is counted on the body the inputs take
    (the group sum once per B7 launch of the Hopper body with a group
    above 1). Returns (dk, dv, dq)."""
    from repro_torch.accel import kernels as K

    q, k = args[0], args[1]
    tc = K.flash_bwd_tc(q.dtype, q.shape[-1])
    split = tc and q.shape[2] != k.shape[2]
    scale = q.shape[-1] ** -0.5
    before = {key: K.launches[key] for key in BWD_KEYS}
    runs = []
    for _ in range(2):
        dk, dv = K.launch_flash_dkv(*args, causal, window, scale)
        runs.append((dk, dv, K.launch_flash_dq(*args, causal, window,
                                               scale)))
    torch.cuda.synchronize()
    got = {key: K.launches[key] - before[key] for key in BWD_KEYS}
    want = {"flash_dkv": 2, "flash_dkv_tc": 2 * tc,
            "flash_dkv_group_sum": 2 * split, "flash_dq": 2,
            "flash_dq_tc": 2 * tc}
    if got != want:
        raise RuntimeError(f"flash bwd {what}: launches {got}, expected "
                           f"{want}")
    if not all(torch.equal(x, y) for x, y in zip(*runs)):
        raise RuntimeError(f"flash bwd {what}: two launches on the same "
                           f"inputs differ")
    return runs[0]


def attention_bwd_phase():
    """B7 and B8 against their plain versions on boundary inputs in bf16
    and f32 (each launched twice, the same bits), the f32 gradient against
    autograd of the oracle, then at the training shapes, timed beside the
    plain versions and the backward of ``scaled_dot_product_attention``
    (the yardstick: dq, dk and dv in one call) by CUDA events and by
    device time, and the port's whole backward (``bwd_delta``, B7, B8)
    beside that yardstick by device time."""
    import torch.nn.functional as F

    from repro_torch.accel import kernels as K
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FOPS
    from repro_torch.kernels.flash_attention import ref as FREF

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 oracle is f32
    torch.backends.cudnn.allow_tf32 = False
    seed, worst = 200, {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dtype]
        for case in BWD_CASES:
            args = _bwd_case(seed, dtype, *case)
            q, k, v, do = args[:4]
            seed += 1
            causal, window = case[6], case[7]
            dk, dv, dq = _bwd_launch_twice(f"{case} {dtype}", args, causal,
                                           window)
            pdk, pdv = FA.flash_attention_dkv_plain(*args, causal=causal,
                                                    window=window)
            pdq = FA.flash_attention_dq_plain(*args, causal=causal,
                                              window=window)
            for name, got, want in (("dk", dk, pdk), ("dv", dv, pdv),
                                    ("dq", dq, pdq)):
                err = _within(f"flash bwd {case} {dtype} {name}", got, want,
                              tol)
                worst[(dtype, name)] = max(worst.get((dtype, name), 0.0),
                                           err)
            if dtype == torch.float32:
                # the op's gradient against autograd of the oracle
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                got = torch.autograd.grad(FOPS.flash_attention(
                    *leaves, causal=causal, window=window), leaves, do)
                want = torch.autograd.grad(FREF.attention_reference(
                    *leaves, causal=causal, window=window), leaves, do)
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    _within(f"flash bwd {case} {name} vs the oracle", g, w,
                            BWD_ORACLE_TOL)
    torch.cuda.synchronize()
    errs = {f"{dtype} {name}": e for (dtype, name), e in worst.items()}
    print(f"attention backward boundary inputs: B7 and B8 ({len(BWD_CASES)} "
          f"cases; bf16 at head_dim 64/128 on the Hopper bodies, the group "
          f"sum where the group is above 1; each launched twice with "
          f"byte-identical results) within tolerance of their plain "
          f"versions in float32 and bf16 (max_abs_err {errs}), f32 within "
          f"{BWD_ORACLE_TOL} of autograd of the oracle", flush=True)

    rows, bf16 = {}, torch.bfloat16
    for arch, (b, s, hq, hkv, d, causal) in BWD_SHAPES.items():
        args = _bwd_case(300, bf16, b, s, s, hq, hkv, d, causal, 0)
        q, k, v, do = args[:4]
        scale = d ** -0.5
        dk, dv, dq = _bwd_launch_twice(f"at {arch}'s layout", args, causal,
                                       0)
        # B7's device memory above its inputs: dk and dv, and with a group
        # above 1 the float32 partials the group sum reads
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.launch_flash_dkv(*args, causal, 0, scale)
        torch.cuda.synchronize()
        dkv_bytes = torch.cuda.max_memory_allocated() - base

        def dkv_plain(*a):
            return FA.flash_attention_dkv_plain(*a, causal=causal)

        def dq_plain(*a):
            return FA.flash_attention_dq_plain(*a, causal=causal)

        t0 = time.perf_counter()
        pdk, pdv = dkv_plain(*args)
        torch.cuda.synchronize()
        # a plain version slower than a second is timed once, on its own
        # first call's clock
        slow = time.perf_counter() - t0 > 1.0
        plain_reps = dict(reps=1, warmup=0) if slow else dict(reps=3)
        pdq = dq_plain(*args)
        err_kv = max(_within(f"flash_dkv at {arch}'s shape dk", dk, pdk,
                             ATTN_TOL[bf16]),
                     _within(f"flash_dkv at {arch}'s shape dv", dv, pdv,
                             ATTN_TOL[bf16]))
        err_q = _within(f"flash_dq at {arch}'s shape", dq, pdq,
                        ATTN_TOL[bf16])
        del pdk, pdv, pdq
        # the yardstick: SDPA's backward for dq, dk and dv together
        qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                      for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True)
        do_t = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(o_lib, (qt, kt, vt), do_t,
                                       retain_graph=True)

        lib_err = max(float((g.transpose(1, 2).float() - w.float()).abs()
                            .max()) for g, w in zip(sdpa_bwd(),
                                                    (dq, dk, dv)))
        # the port's whole backward on its forward's out: delta, B7, B8
        whole = (q, k, v, FA.flash_attention_fwd(q, k, v, causal=causal)[0],
                 args[4], do)

        def whole_bwd(*a):
            return FA.flash_attention_bwd(*a, causal=causal)

        library_ms = _time_ms(sdpa_bwd, ())
        pairs = _causal_pairs(s, s, causal, 0)
        flops = 2.0 * b * hq * d * pairs    # one product
        in_bytes = sum(_nbytes(x) for x in args)
        kargs = (*args, causal, 0, scale)
        source = BWD_SOURCE if K.flash_bwd_tc(bf16, d) else BWD_SIMT_SOURCE
        dkv = _attn_row(
            "flash_dkv", _time_ms(K.launch_flash_dkv, kargs),
            _time_ms(dkv_plain, args, **plain_reps),
            library_ms, in_bytes + _nbytes((dk, dv)), 4 * flops, bf16,
            err_kv, source, DKV_REPLACES)
        dq_row = _attn_row(
            "flash_dq", _time_ms(K.launch_flash_dq, kargs),
            _time_ms(dq_plain, args, **plain_reps),
            library_ms, in_bytes + _nbytes(dq), 3 * flops, bf16, err_q,
            source, DQ_REPLACES)
        # calls this short are timed by the host's time per call in CUDA
        # events: the device time (``_device_ms``) beside them
        dev = {"flash_dkv": _device_ms(K.launch_flash_dkv, kargs),
               "flash_dq": _device_ms(K.launch_flash_dq, kargs),
               "whole": _device_ms(whole_bwd, whole),
               "library": _device_ms(sdpa_bwd, ())}
        for row in (dkv, dq_row):
            row.update(device_ms=dev[row["name"]],
                       library_device_ms=dev["library"],
                       whole_bwd_device_ms=dev["whole"])
        dkv["peak_bytes"] = dkv_bytes
        mask = "causal" if causal else "non-causal"
        print(f"flash bwd at {arch}'s layout (b {b}, s {s}, {hq}/{hkv} heads, "
              f"d {d}, {mask}, bf16): B7 {dkv['ms']:.6f} ms (device "
              f"{dev['flash_dkv']:.6f}; bound {dkv['bound_ms']:.6f}, "
              f"{dkv['bound_by']}), B8 {dq_row['ms']:.6f} ms (device "
              f"{dev['flash_dq']:.6f}; bound {dq_row['bound_ms']:.6f}); by "
              f"device time the port's whole backward (delta, B7, B8) "
              f"{dev['whole']:.6f} ms against SDPA's backward "
              f"{dev['library']:.6f} ms ({dev['whole'] / dev['library']:.3f}"
              f"x); by events SDPA's {library_ms:.6f} ms (max_abs_err vs "
              f"B7/B8 {lib_err}); B7's peak device memory above its inputs "
              f"{dkv_bytes} bytes", flush=True)
        if not rows:    # the main path's shape names the rows
            rows = {"flash_dkv": dkv, "flash_dq": dq_row}
        for name, row in (("flash_dkv", dkv), ("flash_dq", dq_row)):
            rows[name].setdefault("layouts", {})[arch] = {
                key: row[key] for key in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_device_ms", "whole_bwd_device_ms",
                    "peak_bytes", "max_abs_err", "source") if key in row}
        del q, k, v, do, args, dk, dv, dq, qt, kt, vt, o_lib, whole
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Training path: Qwen1.5-0.5B at full width through the live runtime
# ---------------------------------------------------------------------------
# Qwen1.5-0.5B (configs/qwen1_5_0_5b.py) at full width and depth, random
# bf16 weights from seed 0, TrainConfig() defaults; 4 hosts x 4
# microbatches of 1 x 2,048 tokens (32,768 tokens a step) under bino with
# compute_delay 0 and the columnar/reference differential on; one
# warm-up step, then TRAIN_STEPS timed ones.
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_SEED = 0
TRAIN_SEQ = 2048
TRAIN_HOSTS = 4
TRAIN_MB = 4
TRAIN_STEPS = 5
# The first step's loss and one microbatch's gradients are held against
# float32 autograd through the oracles (impl="ref") on the same batch and
# the same (bf16-valued) weights. The port trains in bf16 (weights,
# activations, gradients), with float32 sums inside every product and
# norm and a float32 loss.
# - TRAIN_LOSS_TOL bounds |loss - reference| / |reference| of step 0;
#   measured on an H100 80GB HBM3 at 700 W (PERF.md): 1.2e-4.
# - TRAIN_GRAD_TOL bounds the largest ||g - ref|| / ||ref|| over the
#   leaves; measured 0.022 (a K bias of a late layer). A probe must
#   exceed it: the same gradients with B8's dq replaced by zeros, which
#   zeroes every layer's wq and bq gradient (measured 1.0). The limit sits
#   2.3x above the measurement and 20x below the probe.
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 0.05
# A host thread ends at its next check after shutdown, at most one
# microbatch's gradient away.
HOST_EXIT_S = 120.0


def _stop_hosts(trainer) -> list:
    """Shut ``trainer`` down and wait for each host's thread and its
    heartbeat thread to end (through the host's handle, ``HostDaemon.hb``:
    never threads found by name); returns the names of those still
    running HOST_EXIT_S after the shutdown."""
    trainer.shutdown()
    alive = []
    for host in trainer.coord.hosts.values():
        for thread in (host, host.hb):
            if thread.ident is None:
                continue
            thread.join(timeout=HOST_EXIT_S)
            if thread.is_alive():
                alive.append(thread.name)
    return alive


@contextlib.contextmanager
def _hosts_joined(trainer):
    """Runs the block, then shuts ``trainer`` down and joins its host and
    heartbeat threads on every exit path. A block that raises re-raises
    after the joins (a wedged step ends the process with its traceback,
    not with threads left inside a kernel at interpreter exit, which
    aborted it); a block that returns raises if a thread outlives the
    shutdown."""
    try:
        yield
    except BaseException:
        alive = _stop_hosts(trainer)
        if alive:
            print(f"train: {alive} still running {HOST_EXIT_S} s after "
                  f"shutdown", flush=True)
        raise
    alive = _stop_hosts(trainer)
    if alive:
        raise RuntimeError(f"train: {alive} still running {HOST_EXIT_S} s "
                           f"after shutdown")


def _host_calls(trainer):
    """Count every host's grad_fn calls, across threads."""
    lock, count = threading.Lock(), [0]
    for host in trainer.coord.hosts.values():
        def counted(params, batch, _orig=host.grad_fn):
            with lock:
                count[0] += 1
            return _orig(params, batch)
        host.grad_fn = counted
    return count


def _param_bytes(params) -> torch.Tensor:
    """Every parameter's bits, in tree order, as one byte tensor."""
    from repro_torch.models import layers as L

    return torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in L.tree_leaves(params).values()])


def _print_reports(label, reports, tokens):
    for r in reports:
        detections = sum("declared" in x or "timed out" in x
                         for x in r.recoveries)
        print(f"train {label}: step {r.step} wall {r.wall_s:.6f} s "
              f"({tokens / r.wall_s:.1f} tokens/s) loss "
              f"{r.metrics.get('loss', float('nan')):.6f} mb_executed "
              f"{r.mb_executed}/{r.mb_needed} restarts {r.restarts} "
              f"wedges {r.wedges} detections {detections} recoveries "
              f"{len(r.recoveries)} {r.recoveries[:4]}", flush=True)


def _leaf_errors(got, want):
    """{path: ||got - want|| / ||want||}."""
    return {k: float((got[k].float() - want[k].float()).norm()
                     / want[k].float().norm()) for k in want}


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def train_checks(cfg, params0, batches, device):
    """On the initial weights and step 0's batches: float32 losses through
    the oracles; microbatch 0's gradients on the kernels twice (byte
    identity), through the oracles in float32 (the reference), and with
    B8's dq replaced by zeros (the probe)."""
    from repro_torch.accel import kernels as K
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM
    from repro_torch.train.loop import (TrainConfig, cross_entropy_loss,
                                        make_grad_fn)

    with torch.no_grad():
        ref_losses = [float(cross_entropy_loss(PM.forward(
            cfg, params0, b, impl="ref", compute_dtype=torch.float32)[0],
            b["labels"])) for b in batches]
    grad = make_grad_fn(cfg, TrainConfig())
    g1, _m = grad(params0, batches[0])
    g2, _m = grad(params0, batches[0])
    differ = [k for k in g1 if not _same_bits(g1[k], g2[k])]
    del g2
    # the probe: B8's dq (or its plain version's, on the CPU) set to zeros
    target = (K, "launch_flash_dq") if device == "cuda" else \
        (FA, "flash_attention_dq_plain")
    orig = getattr(*target)
    setattr(*target, lambda q, *a, **kw: torch.zeros_like(q))
    try:
        gp, _m = grad(params0, batches[0])
    finally:
        setattr(*target, orig)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    p32 = L.tree_from_leaves(params0, {k: v.detach().float() for k, v in
                                       L.tree_leaves(params0).items()},
                             trainable=True)
    gref, _m = make_grad_fn(cfg32, TrainConfig(impl="ref", remat="full"))(
        p32, batches[0])
    del p32
    errs, probe = _leaf_errors(g1, gref), _leaf_errors(gp, gref)
    worst = max(errs, key=errs.get)
    return {"ref_losses": ref_losses, "grad_err": errs[worst],
            "grad_worst_leaf": worst, "probe_err": max(probe.values()),
            "nondeterministic": differ}


def train_path(cfg=None, device="cuda", steps=TRAIN_STEPS, seq=TRAIN_SEQ,
               ckpt_root=None):
    """Qwen1.5-0.5B at full width (or ``cfg``) trained through
    ``TrainerRuntime`` on ``device``; checkpoints go to a temporary
    directory under ``ckpt_root`` (default: the repository's git-ignored
    ``build/``), removed at the end. Returns the fault-free timed steps'
    launch counts."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references
    torch.backends.cudnn.allow_tf32 = False
    root = Path(ckpt_root or ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=root)
    try:
        return _train_runs(cfg or get_config(TRAIN_ARCH), device, steps,
                           seq, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _train_runs(cfg, device, steps, seq, ckpt_dir):
    """The training path on ``device`` (a CPU run rehearses it on the
    plain versions, with no launch to count): fault-free, then under the
    pinned crash script with bino (checkpointing into ``ckpt_dir``) and
    gang restart, then resumed from a checkpoint."""
    import shutil

    from repro_torch.accel import kernels as K
    from repro_torch.accel.torch_backend import TorchBackend
    from repro_torch.data.pipeline import DataState
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.runtime import (PINNED_SCRIPTS, ChaosController,
                                     RuntimeConfig, TrainerRuntime)
    from repro_torch.train.loop import TrainConfig

    on_card = torch.device(device).type == "cuda"
    tokens = TRAIN_HOSTS * TRAIN_MB * seq
    n_steps = 1 + steps
    assess = None if on_card else TorchBackend("cpu")
    assess_keys = ("spatial", "temporal", "late", "reap")

    def runtime(recovery="bino", script=None, horizon=0.0, ckpt_every=None,
                **kw):
        """``ckpt_every``: None for no checkpoints, 0 to restore only."""
        rt = RuntimeConfig(
            n_hosts=TRAIN_HOSTS, microbatches_per_shard=TRAIN_MB,
            recovery=recovery, compute_delay=0.0,
            verify_columnar=recovery == "bino", assess_backend=assess,
            checkpoint_dir=None if ckpt_every is None else ckpt_dir,
            checkpoint_every=ckpt_every or 0, **kw)
        chaos = (ChaosController(PINNED_SCRIPTS[script], horizon=horizon,
                                 seed=7) if script else None)
        return TrainerRuntime(cfg, TrainConfig(), rt, seq_len=seq,
                              per_shard_batch=1, seed=TRAIN_SEED,
                              chaos=chaos, device=device)

    def release():
        """Free a finished runtime's device memory. A runtime is a web of
        cycles (hosts, coordinator, closures) that only the collector
        frees, once :func:`finish` has joined every thread that refers to
        it: three runs' parameters and optimizer states left behind (about
        16 GB) ran the last run out of memory."""
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def finish(calls):
        """After :func:`_hosts_joined` (a losing speculative attempt may
        still be inside its backward until the hosts end), read the
        launch counts and check them against the grad_fn calls."""
        counts = dict(K.launches)
        want = cfg.n_layers * calls[0] if on_card else 0
        # every B6, B7 and B8 launch on its Hopper body (bf16, head_dim
        # 64), and with a group of 1 no group sum
        flash = {k: counts[k] for k in ("flash_fwd", "flash_fwd_tc",
                                        "flash_dkv", "flash_dkv_tc",
                                        "flash_dq", "flash_dq_tc")}
        if flash != dict.fromkeys(flash, want) or \
                counts["flash_dkv_group_sum"]:
            raise RuntimeError(f"train: launches {flash}, expected {want} "
                               f"each ({cfg.n_layers} x {calls[0]} grad_fn "
                               f"calls); group sums "
                               f"{counts['flash_dkv_group_sum']}, expected 0")
        return counts

    # -- fault-free ------------------------------------------------------
    watch = _HeartbeatWatch()      # the hosts' silences and the collector
    t = runtime()
    print(f"train: {cfg.arch_id} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"{sum(p.numel() for p in t.state['params'].parameters())} "
          f"parameters; {TRAIN_HOSTS} hosts x {TRAIN_MB} microbatches of 1 "
          f"x {seq} tokens ({tokens} tokens a step)", flush=True)
    params0 = t.state["params"]
    batches = [t.coord.batch_fn(DataState(TRAIN_SEED, s, TRAIN_HOSTS, m))
               for s in range(TRAIN_HOSTS) for m in range(TRAIN_MB)]
    # The counts cover the whole run, warm-up included, up to the hosts'
    # shutdown: a losing speculative attempt may still be computing when
    # its step ends, so no instant between steps is free of launches.
    calls = _host_calls(t)
    plain = _CountCalls([(FA, "flash_attention_plain"),
                         (FA, "flash_attention_dkv_plain"),
                         (FA, "flash_attention_dq_plain"),
                         (FREF, "attention_reference")])
    K.reset_launches()
    w0 = time.perf_counter()
    with plain, _hosts_joined(t):
        try:
            warm = t.run(1)
            _print_reports("fault-free (warm-up)", warm, tokens)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            timed = t.run(steps)
        finally:
            watch.stop()
            print(f"train fault-free: {watch.summary()}", flush=True)
        # the crash runs' horizon: the steps alone, not the hosts' shutdown
        ff_wall = time.perf_counter() - w0
    counts = finish(calls)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    if on_card and any(plain.calls.values()):
        raise RuntimeError(f"train: plain versions called on the card's "
                           f"path: {plain.calls}")
    _print_reports("fault-free", timed, tokens)
    walls = [r.wall_s for r in timed]
    losses = [r.metrics["loss"] for r in warm + timed]
    print(f"train fault-free: {steps} timed steps after the warm-up, mean "
          f"wall {sum(walls) / len(walls):.6f} s "
          f"({tokens * len(walls) / sum(walls):.1f} tokens/s); losses "
          f"{losses}; peak device memory {peak} bytes; "
          f"{calls[0]} grad_fn calls (warm-up included); kernel launches "
          f"{counts}; "
          f"plain-version calls {plain.calls}; detections "
          f"{t.coord.metrics.counter('detections').n}, recoveries "
          f"{t.coord.metrics.counter('recoveries').n}, mb_executed "
          f"{[r.mb_executed for r in warm + timed]}", flush=True)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"train: losses not finite: {losses}")
    final = _param_bytes(t.state["params"]).clone()
    ff_counts = counts
    assess_counts = {k: counts[k] for k in assess_keys}
    del t
    release()

    # -- loss, gradients, reproducibility (gates c-e) -------------------
    checks = train_checks(cfg, params0, batches, device)
    ref_loss = float(np.mean(checks["ref_losses"]))
    loss_err = abs(losses[0] - ref_loss) / abs(ref_loss)
    print(f"train checks: step 0 loss {losses[0]!r} vs float32 through the "
          f"oracles {ref_loss!r}, relative error {loss_err} (limit "
          f"{TRAIN_LOSS_TOL}); microbatch 0 gradients vs float32 autograd "
          f"through the oracles: max ||g - ref|| / ||ref|| "
          f"{checks['grad_err']} at {checks['grad_worst_leaf']} (limit "
          f"{TRAIN_GRAD_TOL}); the probe (B8's dq zeroed) "
          f"{checks['probe_err']}; leaves differing between two runs "
          f"{checks['nondeterministic']}", flush=True)
    if not loss_err <= TRAIN_LOSS_TOL:
        raise RuntimeError(f"train: step 0 loss off by {loss_err}")
    if not checks["grad_err"] <= TRAIN_GRAD_TOL:
        raise RuntimeError(f"train: gradients off by {checks['grad_err']}")
    if not checks["probe_err"] > TRAIN_GRAD_TOL:
        raise RuntimeError(f"train: the probe ({checks['probe_err']}) "
                           f"passes {TRAIN_GRAD_TOL}: it is too loose")
    if checks["nondeterministic"]:
        raise RuntimeError(f"train: gradients not reproducible: "
                           f"{checks['nondeterministic']}")
    del params0, batches

    # -- faults: bino (checkpointing) and gang restart --------------------
    # the crash fires at 0.2 of the horizon: a fifth into the run
    horizon = ff_wall
    for recovery in ("bino", "restart"):
        K.reset_launches()
        t = runtime(recovery, "crash", horizon,
                    ckpt_every=2 if recovery == "bino" else None)
        calls = _host_calls(t)
        with _hosts_joined(t):
            reports = t.run(n_steps)
        counts = finish(calls)
        for k in assess_keys:
            assess_counts[k] += counts[k]
        _print_reports(f"{recovery} crash", reports, tokens)
        same = torch.equal(_param_bytes(t.state["params"]), final)
        print(f"train {recovery} crash (horizon {horizon:.3f} s): final "
              f"params {'byte-identical to' if same else 'DIFFER from'} "
              f"the fault-free run; {calls[0]} grad_fn calls; step walls "
              f"{[r.wall_s for r in reports]}; mb_executed "
              f"{[r.mb_executed for r in reports]}; kernel launches "
              f"{counts}", flush=True)
        if not same:
            raise RuntimeError(f"train: {recovery} crash run diverged")
        if not any(r.recoveries or r.restarts for r in reports):
            raise RuntimeError(f"train: {recovery} crash run shows no "
                               f"recovery")
        del t
        release()

    # -- resume from the bino run's last checkpoint before the end ------
    kept = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and "." not in d)
    start = max(k for k in kept if k < n_steps)
    for k in kept:
        if k > start:   # as if the run had died before writing them
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{k:09d}"))
    t = runtime(ckpt_every=0)
    with _hosts_joined(t):
        if t._start_step != start:
            raise RuntimeError(f"train: resumed at {t._start_step}, not "
                               f"{start}")
        calls = _host_calls(t)
        K.reset_launches()
        reports = t.run(n_steps - start - 1)
        # the last step profiled, after a step on the fresh host threads
        reports += profile_train(t, calls) if on_card else t.run(1)
    finish(calls)
    same = torch.equal(_param_bytes(t.state["params"]), final)
    print(f"train resume: restored step {start} of the bino crash run "
          f"(checkpoints {kept}), ran steps {[r.step for r in reports]}: "
          f"final params {'byte-identical to' if same else 'DIFFER from'} "
          f"the fault-free run", flush=True)
    if not same:
        raise RuntimeError("train: the resumed run diverged")
    del t
    release()
    if on_card and not all(assess_counts.values()):
        raise RuntimeError(f"train: assessment kernels never launched on "
                           f"the bino ticks: {assess_counts}")
    print(f"train: assessment kernel launches on the bino ticks (fault-free "
          f"timed steps and both crash runs): {assess_counts}", flush=True)
    return ff_counts


# Each attention kernel of the training path: its name in the profile and
# its launch count.
TRAIN_ATTN_KERNELS = {"B6": ("flash_fwd_sm90_kernel", "flash_fwd"),
                      "B7": ("flash_dkv_sm90_kernel", "flash_dkv"),
                      "B8": ("flash_dq_sm90_kernel", "flash_dq")}


def profile_train(trainer, calls):
    """Device time by kernel over one training step, the device's busy
    share of its wall time, its time per ``grad_fn`` call (``calls``
    counts them), B6/B7/B8's shares of it and how many of their launches
    the profiler recorded (it can drop records); returns the step's
    reports. Device activity only: recording every op of four host
    threads on the CPU side stretched a profiled step about fivefold."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.accel import kernels as K

    cuda = torch.autograd.DeviceType.CUDA
    before = dict(K.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n0 = calls[0]
        reports = trainer.run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_calls = calls[0] - n0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == cuda]
    dev_us = sum(e.self_device_time_total for e in kernels)
    shares, recorded = {}, {}
    for b, (name, key) in TRAIN_ATTN_KERNELS.items():
        mine = [e for e in kernels if name in e.key]
        shares[b] = sum(e.self_device_time_total for e in mine) / dev_us
        recorded[b] = (sum(e.count for e in mine),
                       K.launches[key] - before[key])
    print(f"profile train step: wall {wall:.6f} s (profiled), device busy "
          f"{dev_us / 1e6:.6f} s = {dev_us / 1e6 / wall:.6f} of wall; "
          f"{n_calls} grad_fn calls started in it, "
          f"{dev_us / 1e3 / max(n_calls, 1):.3f} ms of device time per call; "
          f"shares of device time {shares}; (records, launches) {recorded}")
    print(events.table(sort_by="self_device_time_total", row_limit=20,
                       max_name_column_width=60), flush=True)
    return reports


# ---------------------------------------------------------------------------
# SSD scan B10
# ---------------------------------------------------------------------------
# Boundary inputs: (b, s, h, p, g, n, chunk, decay) — the three shapes of
# tests/test_kernels.py:141-144, s < chunk, ragged tails, 2 and 8 groups,
# p 64 and 128 with n 128. Decay "mixed" draws A = -exp(N(0, 0.5)); "none"
# puts A at -1e-4 (the state barely decays); "underflow" puts A at -16
# with dt = softplus(N(3, 1)) (a step's decay is about exp(-50): every
# decay past the diagonal underflows to 0).
SSD_CASES = [
    (1, 128, 2, 16, 1, 16, 32, "mixed"),
    (2, 256, 4, 32, 1, 32, 64, "mixed"),
    (1, 64, 1, 64, 1, 16, 64, "mixed"),
    (2, 100, 4, 64, 1, 128, 256, "mixed"),     # s < chunk
    (1, 300, 8, 64, 2, 128, 128, "none"),      # ragged tail, 2 groups
    (1, 200, 16, 32, 8, 64, 64, "mixed"),      # 8 groups, ragged
    (2, 520, 8, 64, 1, 128, 256, "underflow"),
    (1, 77, 4, 128, 1, 128, 32, "mixed"),      # p 128, ragged
]
# The Hopper body's edges (bf16 takes it, float32 the SIMT body): its
# 64-row tiles, chunks of 64 to 256, p and n 64 or 128, and sequences of
# one chunk rounded up to its tile (kernels.ssd_chunk).
SSD_TC_CASES = [
    (2, 2048, 8, 64, 1, 128, 256, "mixed"),    # the serving layout
    (1, 257, 4, 64, 1, 128, 256, "mixed"),     # one row past a chunk
    (1, 255, 4, 64, 2, 64, 64, "none"),        # one row short, 2 groups
    (2, 128, 8, 128, 8, 64, 256, "mixed"),     # s < chunk, 8 groups
    (1, 400, 4, 128, 1, 128, 192, "underflow"),  # a 192-row chunk
    (1, 65, 2, 64, 1, 64, 64, "mixed"),        # a 1-row last chunk
    (2, 40, 4, 64, 1, 128, 256, "mixed"),      # s < one 64-row tile
]
# B10 vs its plain version: y within tests/test_kernels.py:157-160's 2e-4
# in float32 and 2e-2 from bf16 inputs (y is rounded to bf16); the final
# state is float32 from the same arithmetic either way (the Hopper body's
# operands it computes bf16 pairs hi + lo in both): 2e-4.
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SSD_STATE_TOL = 2e-4
# The op's float32 gradient (B10 forward, the oracle's autograd backward)
# against autograd of the oracle.
SSD_GRAD_TOL = 1e-4
SSD_SOURCE = "src/repro_torch/accel/csrc/ssd_sm90.cuh"
SSD_REPLACES = "src/repro/kernels/ssd/ssd.py:29 _ssd_kernel (pallas_call :105)"


def _ssd_inputs(seed, dtype, b, s, h, p, g, n, decay="mixed"):
    """x, dt, A, B, C, D on the card: x, B, C ~ N(0, 1) in ``dtype``, dt =
    softplus(N(0, 1)) float32, A per ``decay``, D ~ N(0, 1)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = draw(b, s, h, p).to(dtype)
    dt = F.softplus(draw(b, s, h) + (3.0 if decay == "underflow" else 0.0))
    if decay == "mixed":
        A = -torch.exp(draw(h) * 0.5)
    else:
        A = torch.full((h,), -1e-4 if decay == "none" else -16.0,
                       device="cuda")
    B = draw(b, s, g, n).to(dtype)
    C = draw(b, s, g, n).to(dtype)
    return x, dt, A, B, C, draw(h)


def _ssd_ops(b, s, h, p, g, n, chunk) -> float:
    """Operations of the SSD scan on these shapes: per chunk of q rows,
    C·Bᵀ over its q(q+1)/2 causal pairs once per (sequence, group) (2n
    each), the pairs' weights against x per head (2p each), and the
    carried-state term and the state update per row and head (2np each)."""
    ops = 0.0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) // 2
        ops += b * g * pairs * 2 * n + b * h * pairs * 2 * p \
            + b * h * q * 4 * n * p
    return ops


def _ssd_f64_witness(case, args, chunk, kernel, plain) -> None:
    """Prints how far B10's float32 output and its plain version's lie
    from the plain walk in float64 (a witness, not a gate): the share of
    SSD_TOL's limit each uses at its worst entry."""
    from repro_torch.kernels.ssd import ssd as SSD

    wide = SSD.ssd_plain(*(t.double() for t in args), chunk=chunk)
    tol = SSD_TOL[torch.float32]
    parts = []
    for name, (y, st) in (("kernel", kernel), ("plain", plain)):
        for what, got, want in (("y", y, wide[0]), ("state", st, wide[1])):
            diff = (got.double() - want).abs()
            share = float((diff / (tol + tol * want.abs())).max())
            parts.append(f"{name} {what} {float(diff.max()):.3e} "
                         f"({share:.3f} of the limit)")
    print(f"ssd {case} float32 against float64: {'; '.join(parts)}",
          flush=True)


def ssd_kernel_phase():
    """B10 against its plain version on boundary inputs, the op's float32
    gradient against autograd of the oracle, then at the serving path's
    shape, timed beside the plain version (no PyTorch call computes the
    scan: no library time)."""
    import functools

    from repro_torch.accel import kernels as K
    from repro_torch.kernels.ssd import ops as SOPS
    from repro_torch.kernels.ssd import ref as SREF
    from repro_torch.kernels.ssd import ssd as SSD

    seed = 200
    n_tc = 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in SSD_CASES + SSD_TC_CASES:
            b, s, h, p, g, n, chunk, decay = case
            args = _ssd_inputs(seed, dtype, b, s, h, p, g, n, decay)
            seed += 1
            before = dict(K.launches)
            y, st = SSD.ssd_fwd(*args, chunk=chunk)
            tc = K.ssd_tc(dtype, p, n, K.ssd_chunk(dtype, p, n, s, chunk))
            n_tc += tc
            got = {key: K.launches[key] - before[key] for key in K.SSD_TC_KEYS}
            want = dict.fromkeys(K.SSD_TC_KEYS, int(tc))
            want["ssd"] = 1
            if got != want:
                raise RuntimeError(f"ssd {case} {dtype}: launches {got}, "
                                   f"expected {want}")
            y2, st2 = SSD.ssd_fwd(*args, chunk=chunk)
            if not (_same_bits(y, y2) and _same_bits(st, st2)):
                raise RuntimeError(f"ssd {case} {dtype}: two launches on "
                                   f"the same inputs differ")
            py, pst = SSD.ssd_plain(*args, chunk=chunk)
            if y.dtype != dtype or st.shape != (b, h, p, n):
                raise RuntimeError(f"ssd {case}: y {y.dtype}, state "
                                   f"{tuple(st.shape)}")
            _within(f"ssd {case} {dtype} y", y, py, SSD_TOL[dtype])
            _within(f"ssd {case} {dtype} state", st, pst, SSD_STATE_TOL)
            if dtype == torch.float32 and s >= 2048:
                _ssd_f64_witness(case, args, chunk, (y, st), (py, pst))

    # the op's gradient: B10's forward, the oracle's autograd backward
    args = [t.clone().requires_grad_(True) for t in
            _ssd_inputs(seed, torch.float32, 2, 100, 4, 32, 2, 64)]
    dy = _randn(seed + 1, torch.float32, (2, 100, 4, 32))[0]
    y = SOPS.ssd(*args, chunk=64)
    got = torch.autograd.grad(y, args, dy)
    ref_args = [t.detach().clone().requires_grad_(True) for t in args]
    y_ref = SREF.ssd_reference(*ref_args, chunk=64)[0]
    want = torch.autograd.grad(y_ref, ref_args, dy)
    _within("ssd op forward vs the oracle", y.detach(), y_ref.detach(),
            SSD_TOL[torch.float32])
    for name, g_, w in zip("x dt A B C D".split(), got, want):
        _within(f"ssd gradient {name}", g_, w, SSD_GRAD_TOL)
    torch.cuda.synchronize()
    print(f"ssd boundary inputs: B10 ({len(SSD_CASES + SSD_TC_CASES)} "
          f"cases in float32 and bf16, {n_tc} on the Hopper body; each "
          f"launched twice with byte-identical results) "
          f"within tolerance of its plain version; the op's float32 "
          f"gradient within {SSD_GRAD_TOL} of the oracle's", flush=True)
    family_ssd_check()

    # B10 at the serving shape: Mamba2-2.7B's layer over 4 x 2,048 tokens
    cfg = _ssm_config()
    b, s = SSM_BATCH, SSM_PROMPT
    h = cfg.ssm.n_heads(cfg.d_model)
    p, g, n, chunk = (cfg.ssm.head_dim, cfg.ssm.n_groups, cfg.ssm.d_state,
                      cfg.ssm.chunk_size)
    bf16 = torch.bfloat16
    x, dt, _A, B, C, D = _ssd_inputs(300, bf16, b, s, h, p, g, n)
    A = -torch.linspace(1.0, 16.0, h, device="cuda")   # the model's init
    D = torch.ones_like(D)
    args = (x, dt, A, B, C, D)
    kernel = functools.partial(SSD.ssd_fwd, chunk=chunk)
    plain = functools.partial(SSD.ssd_plain, chunk=chunk)
    before = dict(K.launches)
    y, st = kernel(*args)
    torch.cuda.synchronize()
    if any(K.launches[k] != before[k] + 1 for k in K.SSD_TC_KEYS):
        raise RuntimeError("ssd: the wrapper did not launch the Hopper "
                           "body's three kernels")
    y2, st2 = kernel(*args)
    if not (_same_bits(y, y2) and _same_bits(st, st2)):
        raise RuntimeError("ssd at the serving shape: two launches differ")
    py, pst = plain(*args)
    err = max(_within("ssd at the serving shape", y, py, SSD_TOL[bf16]),
              _within("ssd state at the serving shape", st, pst,
                      SSD_STATE_TOL))
    bytes_ = _nbytes(args) + _nbytes((y, st))
    ops = _ssd_ops(b, s, h, p, g, n, chunk)
    row = _attn_row("ssd", _time_ms(kernel, args), _time_ms(plain, args,
                                                             reps=5),
                    None, bytes_, ops, bf16, err, SSD_SOURCE, SSD_REPLACES)
    row["device_ms"] = _device_ms(kernel, args)
    _sub_kernels("ssd at Mamba2-2.7B's layer", kernel, args,
                 ("ssd_prep_kernel", "ssd_state_kernel", "ssd_out_kernel"))
    print(f"ssd at Mamba2-2.7B's layer: device time {row['device_ms']:.6f} "
          f"ms per call (events behind a sleep kernel), {row['ms']:.6f} ms "
          f"by events", flush=True)
    return {"ssd": row}


# ---------------------------------------------------------------------------
# SSM serving path: Mamba2-2.7B at full width
# ---------------------------------------------------------------------------
# Mamba2-2.7B (configs/mamba2_2_7b.py: 64 layers, d_model 2,560, 80 heads
# of 64, d_state 128, one group, conv 4, chunk 256, vocab 50,280, tied
# embeddings) at full width and depth, random bf16 weights from seed 0;
# 4 prompts of 2,048 tokens, 64 greedy decode steps; logits checked after
# the prefill and at these decode steps, and every layer's final state
# after the prefill.
SSM_ARCH = "mamba2-2.7b"
SSM_SEED = 0
SSM_BATCH = 4
SSM_PROMPT = 2048
SSM_STEPS = 64
SSM_CHECKS = (1, 16, 64)
# Correctness. With random weights the 64-layer stack amplifies rounding
# from layer to layer: the bf16 served logits and an f32 reference's
# differ by about their RMS, and the bf16 prefill on the oracles as much
# (PERF.md), so the bf16 run's end-to-end comparison is reported, not
# gated. Two gates replace it:
# - SSM_SERVE_TOL bounds max |port - ref| / RMS(ref) of the logits of the
#   same entry points on a float32 copy of the weights, fed the same
#   tokens (the prefill and decode steps 1, 16, 64); the fp8 probe of
#   that run must exceed it.
# - Layer by layer: every layer (and the head) of the bf16 served model
#   runs on the f32 reference's residual stream, through the prefill and
#   each decode step with its own cache, beside the f32 layer on the same
#   stream, so rounding cannot compound across layers.
# - SSM_LAYER_TOL bounds max |port - ref| / RMS(ref) of each layer's
#   output and of the head's logits; a probe that casts the blocks' and
#   the head's normalised inputs to fp8 (e4m3) must exceed it.
# - SSM_STATE_TOL bounds ||port - ref|| / ||ref|| of each layer's final
#   state after the prefill (float32 states from bf16 x, B and C).
# Measured on an H100 80GB HBM3 at 700 W (PERF.md): the f32 logits at
# most 0.0027 (decode step 64), their probe 4.78; the layers at most
# 0.406 in the prefill (layer 15) and 0.175 in decode, their probe 2.63;
# the states at most 0.0059. Each limit sits 2.5-3.7x above its
# measurement and, where there is one, at least 2.6x below its probe.
SSM_SERVE_TOL = 0.01
SSM_LAYER_TOL = 1.0
SSM_STATE_TOL = 0.02


def _ssm_config():
    from repro_torch.configs import get_config
    return get_config(SSM_ARCH)


def _rel_norm(got, ref) -> float:
    """||got - ref|| / ||ref||."""
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm())


def ssm_layer_checks(cfg, params, seq, prompt: int, probe=None):
    """Each layer of the served ssm model, in its own type and through
    the kernels, on the residual stream of the f32 reference (the same
    blocks with impl="ref" and the weights upcast): the prompt
    ``seq[:, :prompt]`` as a prefill into a cache of each kind, then one
    decode step per later position of ``seq``, each layer through its own
    cache. ``probe`` transforms the served blocks' and head's normalised
    inputs. Returns ({"prefill" and "decode step k" for k in SSM_CHECKS:
    (worst max |port - ref| / RMS(ref) over the layers and the head's
    last-position logits, its layer; the head is layer n_layers)}, the
    per-layer ||port - ref|| / ||ref|| of the final states after the
    prefill)."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import model as PM

    f32 = torch.float32
    adt = L.DTYPES[cfg.activation_dtype]
    keep = probe or (lambda x: x)
    b = seq.shape[0]
    port = PM.init_cache(cfg, b, 0, device=seq.device)["mamba"]
    ref = {k: torch.zeros_like(t, dtype=f32) for k, t in port.items()}
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    layers = [(lp, L.cast_tree(lp, f32)) for lp in params["layers"]]

    def step(tokens, decode: bool):
        h = F.embedding(tokens.long(), params["embed"]).float()
        worst = (0.0, -1)
        for i, (lp, lp32) in enumerate(layers):
            x_ref = L.apply_norm(cfg, lp32["ln1"], h)
            x = keep(L.apply_norm(cfg, lp["ln1"], h.to(adt)))
            rc = {k: t[i] for k, t in ref.items()}
            pc = {k: t[i] for k, t in port.items()}
            if decode:
                want, _ = M.mamba_decode(cfg, lp32["mixer"], x_ref, rc)
                got, _ = M.mamba_decode(cfg, lp["mixer"], x, pc)
            else:
                want, _ = M.mamba_block(cfg, lp32["mixer"], x_ref,
                                        impl="ref", return_state=True,
                                        out=rc)
                got, _ = M.mamba_block(cfg, lp["mixer"], x,
                                       return_state=True, out=pc)
            worst = max(worst, (_rel_err(got, want), i))
            h = h + want
        last = h[:, -1]
        want = L.apply_norm(cfg, L.cast_tree(params["final_norm"], f32),
                            last) @ head.float().T
        x = keep(L.apply_norm(cfg, params["final_norm"], last.to(adt)))
        return max(worst, (_rel_err(x @ head.T, want), cfg.n_layers))

    with torch.no_grad():
        out = {"prefill": step(seq[:, :prompt], False)}
        states = [_rel_norm(port["state"][i], ref["state"][i])
                  for i in range(cfg.n_layers)]
        for k in range(1, seq.shape[1] - prompt + 1):
            worst = step(seq[:, prompt + k - 1:prompt + k], True)
            if k in SSM_CHECKS:
                out[f"decode step {k}"] = worst
    return out, states


def _fp8(x):
    """x rounded to fp8 (e4m3) and back: the accuracy probes' cast."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)


def _fp8_norms(fn):
    """``fn()`` with every block's and the head's normalised input cast to
    fp8 (the probe of the serving checks)."""
    from repro_torch.models import layers as L

    orig = L.apply_norm
    L.apply_norm = lambda c, p, x: _fp8(orig(c, p, x))
    try:
        return fn()
    finally:
        L.apply_norm = orig


def ssm_f32_serve(cfg, params, seq, prompt: int):
    """The serving entry points on a float32 copy of the weights (an f32
    config: B10's f32 instantiation in the prefill), fed ``seq``: the
    prefill of ``seq[:, :prompt]``, then one decode step per later token.
    Returns ({"prefill", "decode step k" for k in SSM_CHECKS: logits},
    the prefill's logits under the fp8 probe)."""
    from repro_torch.models import layers as L
    from repro_torch.train.loop import (TrainConfig, make_prefill_step,
                                        make_serve_step)

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    params32 = L.tree_from_leaves(params, {
        k: t.float() for k, t in L.tree_leaves(params).items()})
    tc = TrainConfig()
    prefill_step = make_prefill_step(cfg32, tc)
    serve_step = make_serve_step(cfg32, tc)
    logits, cache = prefill_step(params32, {"tokens": seq[:, :prompt]})
    out = {"prefill": logits}
    pos = torch.full((seq.shape[0],), prompt, dtype=torch.int32,
                     device=seq.device)
    for k in range(1, seq.shape[1] - prompt + 1):
        logits, cache = serve_step(params32, cache, seq[:, prompt + k - 1],
                                   pos)
        pos = pos + 1
        if k in SSM_CHECKS:
            out[f"decode step {k}"] = logits
    del cache
    probe = _fp8_norms(lambda: prefill_step(
        params32, {"tokens": seq[:, :prompt]})[0])
    return out, probe


def ssm_serve_path(cfg=None, device="cuda"):
    """Mamba2-2.7B at full width (or ``cfg``): prefill 4 x 2,048 tokens,
    then 64 greedy decode steps, through the port's serving entry points,
    on ``device`` (a CPU run rehearses the path on the plain versions,
    with no launch to count). Returns the launch counts of the run."""
    from repro_torch.accel import kernels as K
    from repro_torch.kernels.ssd import ref as SREF
    from repro_torch.kernels.ssd import ssd as SSD
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM
    from repro_torch.train.loop import (TrainConfig, make_prefill_step,
                                        make_serve_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or _ssm_config()
    on_card = torch.device(device).type == "cuda"
    B, P = SSM_BATCH, SSM_PROMPT
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(SSM_SEED)
    params = PM.init_params(cfg, gen, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    weight_bytes = _nbytes(tuple(params.parameters()))
    rng = np.random.default_rng(SSM_SEED)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))
                               .astype(np.int32)).to(device)
    tc = TrainConfig()
    prefill_step = make_prefill_step(cfg, tc)
    serve_step = make_serve_step(cfg, tc)
    ssm = cfg.ssm
    print(f"ssm serve: {cfg.arch_id} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {ssm.n_heads(cfg.d_model)} heads of "
          f"{ssm.head_dim}, d_state {ssm.d_state}, chunk {ssm.chunk_size}, "
          f"{n_params} parameters ({weight_bytes} bytes), init "
          f"{init_s:.3f} s", flush=True)

    # warm-up on a short prompt (library handles, allocator), uncounted
    w = min(64, P // 2)
    _l, warm = prefill_step(params, {"tokens": prompts[:, :w]})
    serve_step(params, warm, prompts[:, w], torch.full(
        (B,), w, dtype=torch.int32, device=device))
    del warm
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    plain = _CountCalls([(SSD, "ssd_plain"), (SREF, "ssd_reference")])
    K.reset_launches()
    with plain:
        t0 = time.perf_counter()
        logits0, cache = prefill_step(params, {"tokens": prompts})
        _sync(device)
        prefill_s = time.perf_counter() - t0
        after_prefill = dict(K.launches)
        states = cache["mamba"]["state"].clone()
        tok = logits0.argmax(-1).to(torch.int32)
        inputs, checks = [tok], {}
        pos = torch.full((B,), P, dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        for step in range(1, SSM_STEPS + 1):
            logits, cache = serve_step(params, cache, tok, pos)
            if step in SSM_CHECKS:
                checks[step] = logits.float()
            tok = logits.argmax(-1).to(torch.int32)
            inputs.append(tok)
            pos = pos + 1
        _sync(device)
        decode_s = time.perf_counter() - t0
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    cache_bytes = _nbytes(tuple(cache["mamba"].values()))
    # every layer's scan on the Hopper body (bf16, p 64, n 128, chunk 256)
    want = dict.fromkeys(K.SSD_TC_KEYS, cfg.n_layers if on_card else 0)
    if {k: after_prefill[k] for k in want} != want:
        raise RuntimeError(f"ssm serve: prefill launches {after_prefill}, "
                           f"expected {want}")
    others = {k: c for k, c in counts.items() if k not in want and c}
    if {k: counts[k] for k in want} != want or others:
        raise RuntimeError(f"ssm serve: launches {counts}, expected {want} "
                           f"in the prefill and none in decode")
    if on_card and any(plain.calls.values()):
        raise RuntimeError(f"ssm serve: plain versions called on the card's "
                           f"path: {plain.calls}")
    print(f"ssm serve: prefill {B} x {P} tokens {prefill_s * 1e3:.3f} ms "
          f"({B * P / prefill_s:.1f} tokens/s); decode {SSM_STEPS} steps "
          f"{decode_s * 1e3 / SSM_STEPS:.3f} ms/step "
          f"({B * SSM_STEPS / decode_s:.1f} tokens/s); peak device memory "
          f"{peak} bytes; parameters {weight_bytes} bytes, cache "
          f"{cache_bytes} bytes; kernel launches {counts}; plain-version "
          f"calls {plain.calls}", flush=True)
    del cache

    # End to end: the logits and the prefill's final states against the
    # port's forward with impl="ref" in float32 over the same prefix (each
    # layer's weights upcast as it runs; the head for the last position
    # only). The bf16 run's are reported, beside the bf16 prefill on the
    # oracles and an fp8 probe of it; the same entry points on a float32
    # copy of the weights, fed the same tokens, are gated.
    seq = torch.cat([prompts] + [t[:, None] for t in inputs[:-1]], dim=1)
    got = {"prefill": (P, logits0)}
    got.update((f"decode step {k}", (P + k, checks[k])) for k in SSM_CHECKS)
    errs, refs = {}, {}
    with torch.no_grad():
        for label, (n, port) in got.items():
            if port.shape != (B, cfg.vocab_size) or \
                    not bool(torch.isfinite(port).all()):
                raise RuntimeError(f"ssm serve: {label} logits not finite "
                                   f"of shape {(B, cfg.vocab_size)}")
            ref, _, ref_cache = PM.forward(
                cfg, params, {"tokens": seq[:, :n]}, impl="ref",
                compute_dtype=torch.float32, last_only=True,
                collect_cache=label == "prefill")
            refs[label] = ref[:, 0]
            errs[label] = _rel_err(port, refs[label])
            if ref_cache is not None:
                e2e_states = [_rel_norm(states[i], ref_cache["state"][i])
                              for i in range(cfg.n_layers)]
                del ref_cache
        oracle = PM.prefill(cfg, params, {"tokens": prompts},
                            impl="ref")[0]
        probe = _fp8_norms(lambda: prefill_step(
            params, {"tokens": prompts})[0])
    print(f"ssm serve: end to end, bf16 logits vs the f32 reference, "
          f"max|diff|/rms: {json.dumps(errs)}; bf16 prefill on the oracles "
          f"vs the f32 reference {_rel_err(oracle, refs['prefill'])}, vs the "
          f"kernels' prefill {_rel_err(logits0, oracle)}; fp8-activation "
          f"probe {_rel_err(probe, refs['prefill'])}; final states "
          f"||diff||/||ref|| layer 0 {e2e_states[0]}, layer "
          f"{cfg.n_layers - 1} {e2e_states[-1]} (reported, not gated)",
          flush=True)
    agree = float((refs["prefill"].argmax(-1).int() == inputs[0])
                  .float().mean())
    print(f"ssm serve: greedy first token equal to the reference's argmax "
          f"for {agree:.2f} of the batch", flush=True)
    del states, oracle, probe
    got32, probe32 = ssm_f32_serve(cfg, params, seq, P)
    errs32 = {k: _rel_err(v, refs[k]) for k, v in got32.items()}
    probe32_err = _rel_err(probe32, refs["prefill"])
    print(f"ssm serve: end to end in float32 (the entry points on an f32 "
          f"copy of the weights, the same tokens), logits vs the f32 "
          f"reference, max|diff|/rms: {json.dumps(errs32)}; tolerance "
          f"{SSM_SERVE_TOL}; fp8-activation probe {probe32_err}", flush=True)
    bad = {k: e for k, e in errs32.items() if not e <= SSM_SERVE_TOL}
    if bad:
        raise RuntimeError(f"ssm serve: f32 logits outside tolerance "
                           f"{SSM_SERVE_TOL}: {bad}")
    if not probe32_err > SSM_SERVE_TOL:
        raise RuntimeError(f"ssm serve: the f32 run's fp8 probe "
                           f"({probe32_err}) passes the tolerance "
                           f"{SSM_SERVE_TOL}: it is too loose")

    # The gate, layer by layer on the f32 reference's stream: the
    # prefill and every decode step, then the probe on the prefill.
    layer_errs, state_errs = ssm_layer_checks(cfg, params, seq, P)

    probe_errs, probe_states = ssm_layer_checks(cfg, params, seq[:, :P], P,
                                                probe=_fp8)
    worst = max(range(cfg.n_layers), key=state_errs.__getitem__)
    print(f"ssm serve: layer by layer on the f32 reference's stream, worst "
          f"max|diff|/rms over the layers and the head (error, layer): "
          f"{json.dumps(layer_errs)}; tolerance {SSM_LAYER_TOL}; "
          f"fp8-activation probe {json.dumps(probe_errs)}", flush=True)
    print(f"ssm serve: final states vs the f32 reference, ||diff||/||ref|| "
          f"per layer: max {state_errs[worst]} (layer {worst}), first "
          f"{state_errs[0]}, last {state_errs[-1]}; tolerance "
          f"{SSM_STATE_TOL}; fp8-activation probe max {max(probe_states)}",
          flush=True)
    bad = {k: e for k, e in layer_errs.items() if not e[0] <= SSM_LAYER_TOL}
    if bad:
        raise RuntimeError(f"ssm serve: layers outside tolerance "
                           f"{SSM_LAYER_TOL}: {bad}")
    if not probe_errs["prefill"][0] > SSM_LAYER_TOL:
        raise RuntimeError(f"ssm serve: the fp8 probe ({probe_errs}) passes "
                           f"the tolerance {SSM_LAYER_TOL}: it is too loose")
    if not state_errs[worst] <= SSM_STATE_TOL:
        raise RuntimeError(f"ssm serve: layer {worst}'s final state "
                           f"{state_errs[worst]} outside {SSM_STATE_TOL}")

    if on_card:
        profile_serve(params, prompts, prefill_step, serve_step,
                      label="ssm serve")
    return counts


# ---------------------------------------------------------------------------
# Model families on the card: moe, hybrid, audio, vlm
# ---------------------------------------------------------------------------
# Four serving paths, one per family the dense and ssm paths leave out,
# each at full width with random bf16 weights from seed 0 (generated on
# the card), through the port's entry points:
# - moe: moonshot-v1-16b-a3b at full width and depth (48 layers, d_model
#   2,048, 16/16 heads of 128, 64 experts top-6 of width 1,408, vocab
#   163,840; 28.06 B parameters, 56.1 GB): 4 prompts of 2,048 tokens,
#   then 64 greedy steps into a 4,096-slot cache;
# - hybrid: jamba-1.5-large cut to one card (JAMBA_CUT): full width
#   (d_model 8,192, 64/8 heads, d_ff 24,576, vocab 65,536, d_state 128,
#   head_dim 64, 8 groups, chunk 256), one block of 8 layers (attention at
#   4, seven Mamba-2 layers, MoE at 1, 3, 5, 7) with 4 of its 16 experts,
#   top-2 kept: 16.26 B parameters, 32.5 GB; the same traffic;
# - audio: hubert-xlarge at full width and depth (48 layers, d_model
#   1,280, 16 heads of 80, layernorm, gelu, non-causal; 0.95 B
#   parameters): ``forward`` over 4 x 2,048 frames of 512 features;
# - vlm: internvl2-2b at full width and depth (24 layers, d_model 2,048,
#   16/8 heads of 128; 1.89 B parameters): 4 prompts of 256 patch
#   features (1,024-d) ahead of 1,792 token ids, then 64 greedy steps.
FAMILY_SEED = 0
FAMILY_BATCH = 4
FAMILY_PROMPT = 2048            # positions: patches and text for vlm
FAMILY_MAX_LEN = 4096
FAMILY_STEPS = 64
FAMILY_CHECKS = (1, 16, 64)
MOE_ARCH = "moonshot-v1-16b-a3b"
HYBRID_ARCH = "jamba-1.5-large-398b"
AUDIO_ARCH = "hubert-xlarge"
VLM_ARCH = "internvl2-2b"
# jamba-1.5-large (398.6 B parameters) cut to one card: one of its nine
# blocks, and 4 of 16 experts in each MoE layer (top-2 kept). One block
# at 16 experts is 45.2 B parameters (90.5 GB) and does not fit; at 8
# (51.8 GB) one MoE layer's f32 copy for the layer gate (19.3 GB) leaves
# too little room beside the caches.
JAMBA_CUT = {"n_layers": 8, "n_experts": 4}
# Correctness. Each path's gate runs every layer of the bf16 served model
# (a layer: its mixer and its FFN slot) on the residual stream of the f32
# reference (the same layer with its weights cast to float32 and the
# oracles, impl="ref"), through the prefill and every decode step with
# its own cache, so rounding cannot compound across layers (as the ssm
# path does), and the head on the last position. Where a MoE router's
# bf16 and f32 inputs pick different experts for a token (a near tie; or
# a kept slot on one side and a dropped one on the other), that token's
# layer output is not compared: FAMILY_FLIP_TOL bounds the share of such
# (token, layer) pairs. FAMILY_LAYER_TOL bounds max |port - ref| /
# RMS(ref) over the compared tokens of every layer and the head; a probe
# that casts the blocks' and the head's normalised inputs to fp8 (e4m3)
# must exceed it. The hybrid path's Mamba layers' final states are held
# to SSM_STATE_TOL. hubert (3.8 GB in f32) and internvl2 also run
# whole: hubert's ``forward`` on an f32 copy of the weights (B6's f32 body
# at head_dim 80) within FAMILY_F32_TOL of the f32 reference, internvl2's
# bf16 serving logits within SERVE_TOL of it (as the Qwen3-8B path), each
# with an fp8 probe that must exceed its limit.
# Measured on an H100 80GB HBM3 at 700 W (PERF.md), the worst
# layer over the prefill and decode steps 1, 16, 64 and its fp8 probe:
# moe 0.086 (probe 0.382), hybrid 0.070 (0.442), audio 0.0255 (0.148),
# vlm 0.039 (0.273); the routing differs for 2.39 % (moe) and 0.30 %
# (hybrid) of (token, layer) pairs; hubert's f32 copy 4.6e-6 (probe
# 0.145); the jamba cut's Mamba states at most 0.0052. Each limit sits at
# least 2.1x above its measurement and 1.9x below its probe.
FAMILY_LAYER_TOL = {"moe": 0.2, "hybrid": 0.18, "audio": 0.07, "vlm": 0.1}
FAMILY_FLIP_TOL = 0.05
FAMILY_F32_TOL = 0.01


def family_config(name: str):
    """The full-width configuration of a family path (the hybrid one
    cut to one card)."""
    from repro_torch.configs import get_config

    arch = {"moe": MOE_ARCH, "hybrid": HYBRID_ARCH, "audio": AUDIO_ARCH,
            "vlm": VLM_ARCH}[name]
    cfg = get_config(arch)
    if name == "hybrid":
        cfg = dataclasses.replace(
            cfg, arch_id=cfg.arch_id + "-1block-4experts",
            n_layers=JAMBA_CUT["n_layers"],
            moe=dataclasses.replace(cfg.moe,
                                    n_experts=JAMBA_CUT["n_experts"]))
    return cfg


def family_inputs(cfg, device, positions=None):
    """A seeded batch of FAMILY_BATCH prompts of ``positions`` positions
    (FAMILY_PROMPT by default): token ids; frame features for audio;
    ``n_prefix`` patch features ahead of token ids for vlm (features
    standard normal, as float32)."""
    batch = FAMILY_BATCH
    positions = positions or FAMILY_PROMPT
    rng = np.random.default_rng(FAMILY_SEED)
    out = {}
    if cfg.frontend is not None:
        n = positions if cfg.family == "audio" else cfg.frontend.n_prefix
        out["feats"] = torch.from_numpy(rng.standard_normal(
            (batch, n, cfg.frontend.feature_dim)).astype(np.float32))
        positions -= n
    if cfg.family != "audio":
        out["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, positions)).astype(np.int32))
    return {k: v.to(device) for k, v in out.items()}


def family_attention_checks() -> None:
    """B6 and B9 against their plain versions at the shapes each family
    path gives them (the attention phase runs this, outside any counted
    run): B6 over the prompt (4 x 2,048 positions) at each path's heads,
    in bf16, and hubert's in float32 as its f32 copy runs it; B9 at each
    decoder's heads against a FAMILY_MAX_LEN-slot cache, valid lengths
    from the first decode step's to the last's. Each call twice with the
    same bits; B6 within ATTN_TOL and LSE_TOL, B9 within one bf16 unit
    and 1e-2 of the RMS (``_within_decode``)."""
    from repro_torch.accel import kernels as K
    from repro_torch.kernels.decode_attention import decode_attention as DA
    from repro_torch.kernels.flash_attention import flash_attention as FA

    B, P, S = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS
    seed = 400
    bf16, f32 = torch.bfloat16, torch.float32
    done = []
    for name in ("moe", "hybrid", "audio", "vlm"):
        cfg = family_config(name)
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
        causal = not cfg.is_encoder_only()
        for dtype in (bf16, f32) if name == "audio" else (bf16,):
            what = f"flash_fwd at the {name} path's layer {dtype}"
            q, k, v = _randn(seed, dtype, (B, P, hq, d), (B, P, hkv, d),
                             (B, P, hkv, d))
            seed += 1
            before = dict(K.launches)
            out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
            tc = K.flash_fwd_tc(dtype, d)
            got = {key: K.launches[key] - before[key]
                   for key in ("flash_fwd", "flash_fwd_tc")}
            if got != {"flash_fwd": 1, "flash_fwd_tc": int(tc)}:
                raise RuntimeError(f"{what}: launches {got}, Hopper body "
                                   f"expected: {tc}")
            again = FA.flash_attention_fwd(q, k, v, causal=causal)
            if not (torch.equal(out, again[0])
                    and torch.equal(lse, again[1])):
                raise RuntimeError(f"{what}: two launches differ")
            pout, plse = FA.flash_attention_plain(q, k, v, causal=causal)
            err = _within(what, out, pout, ATTN_TOL[dtype])
            _within(what + " lse", lse, plse, LSE_TOL)
            done.append(f"B6 {name} ({B}, {P}, {hq}/{hkv}, {d}, "
                        f"{'causal' if causal else 'non-causal'}, "
                        f"{str(dtype)[6:]}) {err}")
            del q, k, v, out, lse, again, pout, plse
        if not causal:
            continue
        q, k, v = _randn(seed, bf16, (B, hq, d), (B, FAMILY_MAX_LEN, hkv, d),
                         (B, FAMILY_MAX_LEN, hkv, d))
        seed += 1
        vl = torch.tensor([P + 1, P + S // 4 + 1, P + S // 2 + 1, P + S],
                          dtype=torch.int32, device="cuda")[:B]
        what = f"decode at the {name} path's layer"
        before = dict(K.launches)
        out = DA.decode_attention_fwd(q, k, v, vl)
        got = {key: K.launches[key] - before[key]
               for key in ("decode", "decode_combine")}
        if got != {"decode": 1, "decode_combine": 1}:
            raise RuntimeError(f"{what}: launches {got}")
        if not _same_bits(out, DA.decode_attention_fwd(q, k, v, vl)):
            raise RuntimeError(f"{what}: two launches differ")
        err = _within_decode(what, out, DA.decode_attention_plain(q, k, v,
                                                                   vl))
        done.append(f"B9 {name} ({B}, {FAMILY_MAX_LEN} slots, {hq}/{hkv}, "
                    f"{d}, valid {vl.tolist()}) {err}")
        del q, k, v, out
    torch.cuda.synchronize()
    print(f"attention at the family paths' shapes, each launched twice with "
          f"byte-identical results, within tolerance of the plain versions "
          f"(max_abs_err): {'; '.join(done)}", flush=True)


def family_ssd_check() -> None:
    """B10 against its plain version at the hybrid path's layer (the
    jamba cut's Mamba-2 layer over 4 x 2,048 tokens, bf16, on the Hopper
    body; A and D as the model initialises them), launched twice with the
    same bits, within SSD_TOL and SSD_STATE_TOL."""
    from repro_torch.accel import kernels as K
    from repro_torch.kernels.ssd import ssd as SSD

    cfg = family_config("hybrid")
    b, s = FAMILY_BATCH, FAMILY_PROMPT
    h = cfg.ssm.n_heads(cfg.d_model)
    p, g, n, chunk = (cfg.ssm.head_dim, cfg.ssm.n_groups, cfg.ssm.d_state,
                      cfg.ssm.chunk_size)
    bf16 = torch.bfloat16
    x, dt, _A, B, C, D = _ssd_inputs(500, bf16, b, s, h, p, g, n)
    args = (x, dt, -torch.linspace(1.0, 16.0, h, device="cuda"), B, C,
            torch.ones_like(D))
    what = f"ssd at the hybrid path's layer ({b}, {s}, {h}, {p}, {g}, {n})"
    before = dict(K.launches)
    y, st = SSD.ssd_fwd(*args, chunk=chunk)
    if any(K.launches[k] != before[k] + 1 for k in K.SSD_TC_KEYS):
        raise RuntimeError(f"{what}: the Hopper body's three kernels were "
                           f"not launched once each")
    y2, st2 = SSD.ssd_fwd(*args, chunk=chunk)
    if not (_same_bits(y, y2) and _same_bits(st, st2)):
        raise RuntimeError(f"{what}: two launches differ")
    py, pst = SSD.ssd_plain(*args, chunk=chunk)
    err = _within(what, y, py, SSD_TOL[bf16])
    st_err = _within(what + " state", st, pst, SSD_STATE_TOL)
    torch.cuda.synchronize()
    print(f"{what}, chunk {chunk}: launched twice with byte-identical "
          f"results, within tolerance of the plain version: y max_abs_err "
          f"{err}, state {st_err}", flush=True)


def _sublayers(cfg, params):
    """The stack of an attention family as (label, kind, mixer, ln1, ln2,
    ffn, is_moe, slot) per layer, ``slot`` the layer's index into its
    part of the decode cache (``cache["attn"]`` or ``cache["mamba"]``);
    for a hybrid block, its layers in order."""
    from repro_torch.configs.base import ATTN
    from repro_torch.models import model as PM

    if cfg.hybrid is None:
        return [(f"layer {i}", "attn", lp["mixer"], lp["ln1"], lp["ln2"],
                 lp["ffn"], PM.uses_moe(cfg, 0), i)
                for i, lp in enumerate(params["layers"])]
    out = []
    for i, bp in enumerate(params["blocks"]):
        mi = nm = nl = 0
        for j in range(cfg.hybrid.block_len):
            if cfg.hybrid.layer_kind(j) == ATTN:
                kind, mixer, slot = "attn", bp["attn"], i
            else:
                kind, mixer, slot = "mamba", bp["mamba"][mi], (i, mi)
                mi += 1
            if PM.uses_moe(cfg, j):
                ffn, moe = bp["moe"][nm], True
                nm += 1
            else:
                ffn, moe = bp["mlp"][nl], False
                nl += 1
            out.append((f"block {i} layer {j}", kind, mixer,
                        bp["lns"][j]["ln1"], bp["lns"][j]["ln2"], ffn, moe,
                        slot))
    return out


def _routing_agree(cfg, p_port, p_ref, x_port, x_ref):
    """(t,) bool: tokens whose bf16 and f32 routers pick the same experts
    and keep the same of them (the queue of this call's tokens)."""
    from repro_torch.models import moe as MOE

    t = x_ref.shape[0] * x_ref.shape[1]
    cap = MOE.capacity(t, cfg)
    sets = []
    for p, x in ((p_port, x_port), (p_ref, x_ref)):
        _probs, _gate, eid = MOE.route(cfg, p, x.reshape(t, -1))
        _ef, _pos, keep = MOE.queue(cfg, eid, cap)
        kept = torch.where(keep.reshape(eid.shape), eid, -1)
        sets.append((eid.sort(dim=-1).values, kept.sort(dim=-1).values))
    return ((sets[0][0] == sets[1][0]).all(-1)
            & (sets[0][1] == sets[1][1]).all(-1))


def family_layer_checks(cfg, params, batch, seq_tokens, probe=None):
    """Each layer of the served bf16 model, through the kernels, on the
    residual stream of the f32 reference: the prompt ``batch`` as a
    prefill into a cache of each side, then one decode step per token of
    ``seq_tokens`` (b, steps), each layer through its own cache. Layers
    run one at a time over the prefill and every step (one layer's f32
    weights and caches at a time). ``probe`` transforms the served
    layers' and head's normalised inputs. Returns ({"prefill" and
    "decode step k" for k in FAMILY_CHECKS: (worst max |port - ref| /
    RMS(ref) over the layers and the head's last-position logits, its
    layer)}, {MoE: (tokens compared, tokens with a routing flip)}, the
    Mamba layers' final states ||port - ref|| / ||ref|| after the
    prefill)."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import model as PM

    f32 = torch.float32
    adt = L.DTYPES[cfg.activation_dtype]
    keep = probe or (lambda x: x)
    h = PM.embed_inputs(cfg, params, batch, f32)
    b, P = h.shape[:2]
    steps = seq_tokens.shape[1]
    dec = [PM._embed(params, seq_tokens[:, k:k + 1], f32)
           for k in range(steps)]
    labels = ["prefill"] + [f"decode step {k}" for k in range(1, steps + 1)]
    worst = dict.fromkeys(labels, (0.0, ""))
    flips = [0, 0]
    states = []
    positions = torch.arange(P, device=h.device)
    cache_len = P + steps

    def note(label, got, want, where, agree=None):
        rms = float(want.pow(2).mean().sqrt())
        diff = (got.float() - want).abs()
        if agree is not None:
            diff = diff.reshape(-1, diff.shape[-1])[agree.reshape(-1)]
        err = float(diff.max()) / rms if diff.numel() else 0.0
        worst[label] = max(worst[label], (err, where))

    with torch.no_grad():
        for where, kind, mixer, ln1, ln2, ffn, moe, _slot in _sublayers(
                cfg, params):
            mix32 = L.cast_tree(mixer, f32)
            ln1_32 = L.cast_tree(ln1, f32)
            ln2_32 = L.cast_tree(ln2, f32)
            ffn32 = L.cast_tree(ffn, f32)
            if kind == "attn":
                shape = (b, cache_len, cfg.n_kv_heads,
                         cfg.resolved_head_dim())
                pc = {n: torch.zeros(shape, dtype=adt, device=h.device)
                      for n in ("k", "v")}
                rc = {n: torch.zeros(shape, dtype=f32, device=h.device)
                      for n in ("k", "v")}
            else:
                pc = M.init_mamba_cache(cfg, b, adt, device=h.device)
                rc = {n: torch.zeros_like(t, dtype=f32)
                      for n, t in pc.items()}
            for si, label in enumerate(labels):
                hr = h if si == 0 else dec[si - 1]
                hp = hr.to(adt)
                x = keep(L.apply_norm(cfg, ln1, hp))
                xr = L.apply_norm(cfg, ln1_32, hr)
                if si == 0 and kind == "attn":
                    got, kv = L.attention_block(cfg, mixer, x,
                                                positions=positions)
                    want, kvr = L.attention_block(cfg, mix32, xr,
                                                  positions=positions,
                                                  impl="ref")
                    for n in ("k", "v"):
                        pc[n][:, :P] = kv[n]
                        rc[n][:, :P] = kvr[n]
                elif si == 0:
                    got, _ = M.mamba_block(cfg, mixer, x,
                                           return_state=True, out=pc)
                    want, _ = M.mamba_block(cfg, mix32, xr, impl="ref",
                                            return_state=True, out=rc)
                    states.append(_rel_norm(pc["state"], rc["state"]))
                elif kind == "attn":
                    pos = torch.full((b,), P + si - 1, dtype=torch.int32,
                                     device=h.device)
                    got, _ = L.attention_decode(cfg, mixer, x, pc, pos)
                    want, _ = L.attention_decode(cfg, mix32, xr, rc, pos,
                                                 impl="ref")
                else:
                    got, _ = M.mamba_decode(cfg, mixer, x, pc)
                    want, _ = M.mamba_decode(cfg, mix32, xr, rc)
                # the FFN slot on both sides, on each side's stream
                x2 = keep(L.apply_norm(cfg, ln2, hp + got))
                x2r = L.apply_norm(cfg, ln2_32, hr + want)
                fgot, _ = PM.ffn(cfg, ffn, x2, moe)
                fwant, _ = PM.ffn(cfg, ffn32, x2r, moe)
                agree = None
                if moe:
                    agree = _routing_agree(cfg, ffn, ffn32, x2, x2r)
                    flips[0] += agree.numel()
                    flips[1] += int((~agree).sum())
                note(label, got.float() + fgot.float(), want + fwant, where,
                     agree)
                hr += want + fwant
            del mix32, ffn32, pc, rc
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        final32 = L.cast_tree(params["final_norm"], f32)
        for si, label in enumerate(labels):
            last = (h if si == 0 else dec[si - 1])[:, -1]
            want = L.apply_norm(cfg, final32, last) @ head.float().T
            x = keep(L.apply_norm(cfg, params["final_norm"], last.to(adt)))
            note(label, x @ head.T, want, "head")
    out = {k: v for k, v in worst.items()
           if k == "prefill" or int(k.split()[-1]) in FAMILY_CHECKS}
    return out, flips, states


def _family_gate(tag, tol, cfg, params, batch, seq_tokens) -> None:
    """The layer-by-layer gate of a family path within ``tol`` and its fp8
    probe (on the prefill); raises outside the limits."""
    errs, flips, states = family_layer_checks(cfg, params, batch,
                                              seq_tokens)
    probe, pflips, _ = family_layer_checks(cfg, params, batch,
                                           seq_tokens[:, :0], probe=_fp8)
    share = flips[1] / flips[0] if flips[0] else 0.0
    print(f"{tag}: layer by layer on the f32 reference's stream, worst "
          f"max|diff|/rms over the layers and the head (error, layer): "
          f"{json.dumps(errs)}; tolerance {tol}; fp8-activation "
          f"probe {json.dumps(probe)}", flush=True)
    if flips[0]:
        pshare = pflips[1] / pflips[0] if pflips[0] else 0.0
        print(f"{tag}: MoE routing, bf16 vs f32 router inputs: {flips[1]} of "
              f"{flips[0]} (token, layer) pairs pick or keep other experts "
              f"(share {share}; tolerance {FAMILY_FLIP_TOL}), left out of the "
              f"layer gate; the fp8 probe's share {pshare}", flush=True)
    if states:
        print(f"{tag}: Mamba layers' final states vs the f32 reference, "
              f"||diff||/||ref||: max {max(states)}, per layer {states}; "
              f"tolerance {SSM_STATE_TOL}", flush=True)
    bad = {k: e for k, e in errs.items() if not e[0] <= tol}
    if bad:
        raise RuntimeError(f"{tag}: layers outside tolerance "
                           f"{tol}: {bad}")
    if not probe["prefill"][0] > tol:
        raise RuntimeError(f"{tag}: the fp8 probe ({probe}) passes the "
                           f"tolerance {tol}: it is too loose")
    if not share <= FAMILY_FLIP_TOL:
        raise RuntimeError(f"{tag}: routing flips on {share} of (token, "
                           f"layer) pairs, above {FAMILY_FLIP_TOL}")
    if states and not max(states) <= SSM_STATE_TOL:
        raise RuntimeError(f"{tag}: a Mamba layer's final state "
                           f"{max(states)} outside {SSM_STATE_TOL}")


def family_replay(cfg, params, batch, fed, cache, logits0, checks):
    """What the timed run served, held against the layer gate's harness:
    the calls the gate makes for its bf16 side (norms, mixers with their
    caches, FFN slots, the head), composed here on the bf16 stream the
    served model sees, layer after layer, over the prompt ``batch`` and
    then one decode step per column of ``fed`` (b, steps + 1) but the
    last: the tokens the run fed, then its last argmax (None without a
    decode step). The gate holds those calls against the f32 reference;
    here their composition must give, bit for bit, what the model's own
    stack gave: each layer's part of the served ``cache`` after the last
    step (K/V, Mamba conv tails and states), the prefill's logits
    ``logits0`` and the checked steps' ``checks`` ({step: float32
    logits}). At every step the logits are finite and their argmax is the
    token the run fed next. Returns the number of tensors compared bit
    for bit; raises on the first difference."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import model as PM

    adt = L.DTYPES[cfg.activation_dtype]
    h = PM.embed_inputs(cfg, params, batch, adt)
    b, P = h.shape[:2]
    steps = 0 if fed is None else fed.shape[1] - 1
    dec = [PM._embed(params, fed[:, k:k + 1], adt) for k in range(steps)]
    positions = torch.arange(P, device=h.device)
    compared = 0

    def same(what, got, want):
        if not _same_bits(got, want):
            diff = float((got.float() - want.float()).abs().max())
            raise RuntimeError(f"served state: {what} differs from the "
                               f"layer-by-layer replay, max |diff| {diff}")

    with torch.no_grad():
        for where, kind, mixer, ln1, ln2, ffn, moe, slot in _sublayers(
                cfg, params):
            if kind == "attn":
                own = {n: torch.zeros_like(t[slot])
                       for n, t in cache["attn"].items()} if cache else None
            else:
                own = M.init_mamba_cache(cfg, b, adt, device=h.device)
            for si in range(steps + 1):
                x = L.apply_norm(cfg, ln1, h if si == 0 else dec[si - 1])
                if si == 0 and kind == "attn":
                    out, kv = L.attention_block(cfg, mixer, x,
                                                positions=positions)
                    if own is not None:
                        for n in ("k", "v"):
                            own[n][:, :P] = kv[n]
                elif si == 0:
                    out, _ = M.mamba_block(cfg, mixer, x, return_state=True,
                                           out=own)
                elif kind == "attn":
                    pos = torch.full((b,), P + si - 1, dtype=torch.int32,
                                     device=h.device)
                    out, _ = L.attention_decode(cfg, mixer, x, own, pos)
                else:
                    out, _ = M.mamba_decode(cfg, mixer, x, own)
                hs = (h if si == 0 else dec[si - 1]) + out
                x2 = L.apply_norm(cfg, ln2, hs)
                hs = hs + PM.ffn(cfg, ffn, x2, moe)[0]
                if si == 0:
                    h = hs
                else:
                    dec[si - 1] = hs
            if own is not None:
                served = cache[kind]
                for n, t in own.items():
                    same(f"{where}'s cache {kind}.{n}", t, served[n][slot])
                    compared += 1
        final = params["final_norm"]
        last = h if cfg.is_encoder_only() else h[:, -1:]
        got = PM._lm_head(cfg, params, L.apply_norm(cfg, final, last))[:, -1]
        same("the prefill's logits", got, logits0)
        compared += 1
        for k in range(1, steps + 1):
            got = PM._lm_head(cfg, params, L.apply_norm(cfg, final,
                                                        dec[k - 1]))[:, 0]
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"served state: decode step {k}'s logits "
                                   f"not finite")
            if not torch.equal(got.argmax(-1).to(torch.int32), fed[:, k]):
                raise RuntimeError(f"served state: decode step {k}'s argmax "
                                   f"is not the token the run fed next")
            if k in checks:
                same(f"decode step {k}'s logits", got.float(), checks[k])
                compared += 1
    return compared


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def family_path(name: str, cfg=None, device="cuda"):
    """One family's serving path (``name`` moe, hybrid, audio or vlm) at
    full width (or ``cfg``), on ``device`` (a CPU run rehearses it on the
    plain versions, with no launch to count): the prompt batch through
    ``make_prefill_step`` (audio: ``forward``), then FAMILY_STEPS greedy
    steps of ``make_serve_step`` (none for audio). Returns the launch
    counts of the run."""
    from repro_torch.accel import kernels as K
    from repro_torch.kernels.decode_attention import decode_attention as DA
    from repro_torch.kernels.decode_attention import ref as DREF
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.kernels.ssd import ref as SREF
    from repro_torch.kernels.ssd import ssd as SSD
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM
    from repro_torch.train.loop import (TrainConfig, make_prefill_step,
                                        make_serve_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"{name} serve"
    cfg = cfg or family_config(name)
    on_card = torch.device(device).type == "cuda"
    decoder = not cfg.is_encoder_only()
    B, P, S = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS if decoder else 0
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(FAMILY_SEED)
    params = PM.init_params(cfg, gen, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    weight_bytes = _nbytes(tuple(params.parameters()))
    batch = family_inputs(cfg, device)
    tc = TrainConfig()
    prefill_step = make_prefill_step(cfg, tc, max_len=FAMILY_MAX_LEN)
    serve_step = make_serve_step(cfg, tc) if decoder else None

    def run(b):
        if decoder:
            return prefill_step(params, b)
        with torch.no_grad():
            logits, _aux, _ = PM.forward(cfg, params, b)
        return logits[:, -1], None

    moe = cfg.moe
    print(f"{tag}: {cfg.arch_id} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim()}"
          + (f", {moe.n_experts} experts top-{moe.top_k} of width "
             f"{moe.d_ff_expert}" if moe else "")
          + f", vocab {cfg.vocab_size}, {n_params} parameters "
          f"({weight_bytes} bytes), init {init_s:.3f} s", flush=True)

    # warm-up on a short prompt (library handles, allocator), uncounted
    w = min(64, P // 2)
    warm = family_inputs(cfg, device, positions=w + (
        cfg.frontend.n_prefix if cfg.family == "vlm" else 0))
    _l, wc = run(warm)
    if decoder:
        serve_step(params, wc, warm["tokens"][:, -1],
                   torch.full((B,), sum(t.shape[1] for t in warm.values()),
                              dtype=torch.int32, device=device))
    del wc, warm
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    plain = _CountCalls([(FA, "flash_attention_plain"),
                         (DA, "decode_attention_plain"),
                         (FREF, "attention_reference"),
                         (DREF, "decode_attention_reference"),
                         (SSD, "ssd_plain"), (SREF, "ssd_reference")])
    K.reset_launches()
    with plain:
        t0 = time.perf_counter()
        logits0, cache = run(batch)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        after_prefill = dict(K.launches)
        tok = logits0.argmax(-1).to(torch.int32)
        inputs, checks = [tok], {}
        pos = torch.full((B,), P, dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        for step in range(1, S + 1):
            logits, cache = serve_step(params, cache, tok, pos)
            if step in FAMILY_CHECKS:
                checks[step] = logits.float()
            tok = logits.argmax(-1).to(torch.int32)
            inputs.append(tok)
            pos = pos + 1
        _sync(device)
        decode_s = time.perf_counter() - t0
    counts = dict(K.launches)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    cache_bytes = 0 if cache is None else sum(
        _nbytes(tuple(part.values())) for part in cache.values())
    n_attn = cfg.n_attn_layers() if on_card else 0
    n_ssd = cfg.n_mamba_layers() if on_card and cfg.ssm else 0
    tc_attn = bool(K.flash_fwd_tc(L.DTYPES[cfg.activation_dtype],
                                  cfg.resolved_head_dim()))
    want_prefill = {"flash_fwd": n_attn, "flash_fwd_tc": n_attn * tc_attn,
                    "decode": 0, "decode_combine": 0}
    want_prefill.update(dict.fromkeys(K.SSD_TC_KEYS, n_ssd))
    want = dict(want_prefill, decode=n_attn * S, decode_combine=n_attn * S)
    if {k: after_prefill[k] for k in want_prefill} != want_prefill:
        raise RuntimeError(f"{tag}: prefill launches {after_prefill}, "
                           f"expected {want_prefill}")
    others = {k: c for k, c in counts.items() if k not in want and c}
    if {k: counts[k] for k in want} != want or others:
        raise RuntimeError(f"{tag}: launches {counts}, expected {want}")
    if on_card and any(plain.calls.values()):
        raise RuntimeError(f"{tag}: plain versions called on the card's "
                           f"path: {plain.calls}")
    decode_ms = decode_s * 1e3 / S if S else 0.0
    print(f"{tag}: prefill {B} x {P} positions {prefill_s * 1e3:.3f} ms "
          f"({B * P / prefill_s:.1f} tokens/s); decode {S} steps "
          f"{decode_ms:.3f} ms/step"
          + (f" ({B * S / decode_s:.1f} tokens/s)" if S else "")
          + f"; peak device memory {peak} bytes; parameters {weight_bytes} "
          f"bytes, cache {cache_bytes} bytes; kernel launches "
          f"{ {k: v for k, v in counts.items() if v} }; plain-version "
          f"calls {plain.calls}", flush=True)
    fed = torch.stack(inputs, dim=1) if S else None
    n_same = family_replay(cfg, params, batch, fed, cache, logits0, checks)
    served = (f"the served cache after the last step and the logits of the "
              f"prefill and decode steps {list(checks)}" if S else
              "the logits of the forward")
    print(f"{tag}: {served} equal, bit for bit, the layer-by-layer replay of "
          f"the gate's calls on the served stream ({n_same} tensors)"
          + ("; every step's logits finite, their argmax the token fed next"
             if S else ""), flush=True)
    del cache
    _free()

    # End to end against the f32 reference (forward, impl="ref", each
    # layer's weights upcast as it runs, the head on the last position):
    # the prefill, and for the decoders without MoE the checked steps.
    seq = torch.stack(inputs[:-1], dim=1) if S else None
    got = {"prefill": (batch, logits0)}
    if S and moe is None:
        for k in FAMILY_CHECKS:
            b = dict(batch, tokens=torch.cat([batch["tokens"], seq[:, :k]],
                                             dim=1))
            got[f"decode step {k}"] = (b, checks[k])
    errs, refs = {}, {}
    with torch.no_grad():
        for label, (b, port) in got.items():
            if port.shape != (B, cfg.vocab_size) or \
                    not bool(torch.isfinite(port).all()):
                raise RuntimeError(f"{tag}: {label} logits not finite of "
                                   f"shape {(B, cfg.vocab_size)}")
            refs[label] = PM.forward(cfg, params, b, impl="ref",
                                     compute_dtype=torch.float32,
                                     last_only=True)[0][:, 0]
            errs[label] = _rel_err(port, refs[label])
            _free()
        probe = _fp8_norms(lambda: run(batch)[0])
        probe_err = _rel_err(probe, refs["prefill"])
    print(f"{tag}: end to end, bf16 logits vs the f32 reference, "
          f"max|diff|/rms: {json.dumps(errs)}; fp8-activation probe "
          f"{probe_err}", flush=True)
    agree = float((refs["prefill"].argmax(-1).int() == inputs[0])
                  .float().mean())
    print(f"{tag}: greedy first token equal to the reference's argmax for "
          f"{agree:.2f} of the batch", flush=True)
    if name == "vlm":
        bad = {k: e for k, e in errs.items() if not e <= SERVE_TOL}
        if bad or not probe_err > SERVE_TOL:
            raise RuntimeError(f"{tag}: logits {errs} (tolerance "
                               f"{SERVE_TOL}) or the fp8 probe "
                               f"{probe_err} passes it")
    if name == "audio":
        family_f32_check(tag, cfg, params, batch, refs["prefill"])
    del probe, refs
    _free()

    # The gate, layer by layer on the f32 reference's stream
    if seq is None:                           # no decode step
        seq = torch.zeros((B, 0), dtype=torch.int32, device=device)
    _family_gate(tag, FAMILY_LAYER_TOL[name], cfg, params, batch, seq)
    _free()
    if on_card:
        profile_serve(params, batch, prefill_step, serve_step, label=tag)
    del params
    _free()
    return counts


def family_f32_check(tag, cfg, params, batch, ref) -> None:
    """The encoder's ``forward`` on a float32 copy of the weights (an f32
    config: B6's f32 body) against the f32 reference's last-position
    logits ``ref``, within FAMILY_F32_TOL; an fp8 probe must exceed it."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    params32 = L.tree_from_leaves(params, {
        k: t.float() for k, t in L.tree_leaves(params).items()})
    with torch.no_grad():
        got = PM.forward(cfg32, params32, batch, last_only=True)[0][:, 0]
        probe = _fp8_norms(lambda: PM.forward(cfg32, params32, batch,
                                              last_only=True)[0][:, 0])
    err, perr = _rel_err(got, ref), _rel_err(probe, ref)
    del params32
    print(f"{tag}: end to end in float32 (forward on an f32 copy of the "
          f"weights), logits vs the f32 reference, max|diff|/rms: {err}; "
          f"tolerance {FAMILY_F32_TOL}; fp8-activation probe {perr}",
          flush=True)
    if not err <= FAMILY_F32_TOL:
        raise RuntimeError(f"{tag}: f32 logits {err} outside "
                           f"{FAMILY_F32_TOL}")
    if not perr > FAMILY_F32_TOL:
        raise RuntimeError(f"{tag}: the f32 run's fp8 probe ({perr}) passes "
                           f"the tolerance {FAMILY_F32_TOL}")


# ---------------------------------------------------------------------------
# Training paths of the audio, vlm and moe families
# ---------------------------------------------------------------------------
# Each path trains one family through ``make_train_step`` (random bf16
# weights from seed 0, TrainConfig() defaults but the microbatches and the
# remat policy): one warm-up step, then FAMILY_TRAIN_STEPS timed steps of
# 4 sequences of train_4k's 4,096 positions (configs/base.py:269-285).
# - audio: hubert-xlarge at full width and depth, 2 microbatches of 2 x
#   4,096 frames of 512 features, labels over its 504 entries, no remat;
#   48 B6, B7 and B8 a grad_fn call, all on the SIMT bodies (head_dim 80).
# - vlm: internvl2-2b at full width and depth, 2 microbatches of 2
#   sequences of 256 patch features (1,024-d) then 3,840 tokens, labels
#   over all 4,096 positions, remat "dots": 24 B7 and B8 and 24 group
#   sums a grad_fn call, and B6 twice a layer, 48 (the policy saves the
#   products' outputs, not B6's, which the dispatcher does not see, so
#   each layer's recompute runs B6 again), all on the Hopper bodies.
# - moe: moonshot-v1-16b-a3b cut to its first MOE_TRAIN_LAYERS of 48
#   layers, every width kept (2,953,332,736 parameters), 4 microbatches
#   of 1 x 4,096 tokens, remat "full": B6 8 (4 and 4 recomputed), B7 and
#   B8 4 a grad_fn call, on the Hopper bodies, no group sum. bf16 weights
#   5.9 GB, AdamW moments 23.6, gradients 5.9 and the float32 sums 11.8
#   come to 47.2 GB before activations; at 6 layers (4.09 B) 65 GB.
FAMILY_TRAIN_SEQ = 4096
FAMILY_TRAIN_STEPS = 3
FAMILY_TRAIN_SEED = 0
MOE_TRAIN_LAYERS = 4
# (microbatches, sequences per microbatch, remat) of each path
FAMILY_TRAIN = {"audio": (2, 2, "none"), "vlm": (2, 2, "dots"),
                "moe": (4, 1, "full")}
# The gates. Step 0's loss within TRAIN_LOSS_TOL of float32 autograd
# through the oracles (impl="ref", remat="full", on a float32 copy of the
# weights); microbatch 0's gradients: the largest ||g - ref|| / ||ref||
# over the leaves within FAMILY_GRAD_TOL, which the probe (B8's dq
# replaced by zeros) must exceed; microbatch 0's gradients the same bits
# twice, and for vlm the same bits under "dots" as under "none". For moe
# the whole model's gradients are printed, not gated: a token whose bf16
# and f32 routers pick other experts sends its gradient through other
# expert and router weights (0.33 of a leaf's norm for the moonshot cut,
# PERF.md), so the gate runs layer by layer on the f32 stream with such
# tokens left out (moe_layer_grad_checks), their share within
# FAMILY_FLIP_TOL.
# Measured on an H100 80GB HBM3 at 700 W (PERF.md; two runs, the same
# bits): audio 0.0431 (wq of layer 46), vlm 0.0368 (wq of layer
# 23), moe layer by layer 0.0123 (the final norm's scale; 2.37 % of
# (token, layer) pairs flipped), each probe 1.0; each limit 2.2x or more
# above its reading and 10x or more below the probe.
FAMILY_GRAD_TOL = {"audio": 0.1, "vlm": 0.08, "moe": 0.03}
# Leaves AdamW cannot move in bf16 (no float32 master copy, as in the
# reference): a norm's scale starts at 1.0, where a step of lr 3e-4 is
# below half of bf16's spacing (2^-8 below 1.0); the audio family's
# token embedding gets no gradient (it reads frame features), and its
# decay (lr x 0.1 of each weight) rounds away. The timed steps must change
# every other leaf, and give every leaf but the unreached one a nonzero
# first moment.
FROZEN_IN_BF16 = ("/scale",)
ATTN_KEYS = ("flash_fwd", "flash_fwd_tc", "flash_dkv", "flash_dkv_tc",
             "flash_dkv_group_sum", "flash_dq", "flash_dq_tc")


def family_train_config(name: str):
    """The configuration of a family's training path: the serving path's
    (audio, vlm) or moonshot cut to MOE_TRAIN_LAYERS layers (moe)."""
    from repro_torch.configs import get_config

    if name != "moe":
        return family_config(name)
    cfg = get_config(MOE_ARCH)
    return dataclasses.replace(
        cfg, arch_id=f"{cfg.arch_id}-{MOE_TRAIN_LAYERS}layers",
        n_layers=MOE_TRAIN_LAYERS)


def family_train_batch(cfg, step: int, n_seq: int, seq: int, device):
    """Step ``step``'s batch of ``n_seq`` sequences of ``seq`` positions,
    drawn with numpy: frame features (audio), patch features then token
    ids (vlm) or token ids, and labels over every position."""
    rng = np.random.default_rng((FAMILY_TRAIN_SEED, step))
    out = {}
    if cfg.frontend is not None:
        n = seq if cfg.family == "audio" else cfg.frontend.n_prefix
        out["feats"] = torch.from_numpy(rng.standard_normal(
            (n_seq, n, cfg.frontend.feature_dim)).astype(np.float32))
    if cfg.family != "audio":
        n_text = seq - (out["feats"].shape[1] if "feats" in out else 0)
        out["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (n_seq, n_text)).astype(np.int64))
    out["labels"] = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (n_seq, seq)).astype(np.int64))
    return {k: v.to(device) for k, v in out.items()}


def train_launches(cfg, remat: str, on_card: bool) -> dict:
    """B6-B8's launches in one grad_fn call of ``cfg`` under ``remat``:
    every attention layer once forward and once backward, B6 once more
    in the recompute of every policy but "none"; each on the body its
    dtype and head_dim take; the group sum after each B7 launch of the
    Hopper body with a group above 1. Zeros on the CPU."""
    from repro_torch.accel import kernels as K

    n = cfg.n_attn_layers() if on_card else 0
    bf16, d = torch.bfloat16, cfg.resolved_head_dim()
    fwd = n * (1 if remat == "none" else 2)
    tc_f, tc_b = int(K.flash_fwd_tc(bf16, d)), int(K.flash_bwd_tc(bf16, d))
    group = int(cfg.n_heads != cfg.n_kv_heads)
    return {"flash_fwd": fwd, "flash_fwd_tc": fwd * tc_f, "flash_dkv": n,
            "flash_dkv_tc": n * tc_b, "flash_dkv_group_sum": n * tc_b * group,
            "flash_dq": n, "flash_dq_tc": n * tc_b}


def _grad_errors(got, want):
    """{leaf: ||got - want|| / ||want||}; a leaf whose reference gradient
    is zero (a leaf the loss does not reach) counts 0 if the port's is
    zero too, infinity otherwise."""
    out = {}
    for k, w in want.items():
        w = w.float()
        diff = float((got[k].float() - w).norm())
        ref = float(w.norm())
        out[k] = diff / ref if ref else (0.0 if diff == 0 else float("inf"))
    return out


def family_train_checks(tag, cfg, params, batches, tc, device, plain):
    """On the initial weights and step 0's microbatches (``batches``):
    float32 losses through the oracles, each layer's weights upcast as it
    runs; microbatch 0's gradients through the oracles on a float32 copy
    of the weights (the reference; for moe also layer by layer,
    :func:`moe_layer_grad_checks`; the copy freed before the kernels'
    run); on the kernels under ``tc`` twice (byte identity, and the launches of one
    call), under "none" for a remat policy that saves products (the same
    bits), and with B8's dq replaced by zeros (the probe), the kernels'
    calls under ``plain`` (a :class:`_CountCalls`). Returns the readings
    and the launches the calls made."""
    from repro_torch.accel import kernels as K
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM
    from repro_torch.train.loop import (TrainConfig, cross_entropy_loss,
                                        make_grad_fn)

    on_card = torch.device(device).type == "cuda"
    with torch.no_grad():
        ref_losses = []
        for b in batches:
            logits = PM.forward(cfg, params, b, impl="ref",
                                compute_dtype=torch.float32)[0]
            ref_losses.append(float(cross_entropy_loss(logits,
                                                       b["labels"])))
            del logits
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    p32 = L.tree_from_leaves(params, {k: v.detach().float() for k, v in
                                      L.tree_leaves(params).items()},
                             trainable=True)
    gref, _m = make_grad_fn(cfg32, TrainConfig(impl="ref", remat="full"))(
        p32, batches[0])
    layer_gate = None
    if cfg.moe is not None:
        # whole-model gradients differ where the bf16 and f32 routers pick
        # other experts: the gate runs layer by layer on the f32 stream
        errs, flips = moe_layer_grad_checks(cfg, params, p32, batches[0],
                                            plain)
        probe_errs, _f = moe_layer_grad_checks(cfg, params, p32, batches[0],
                                               plain, probe=True)
        worst = max(errs, key=errs.get)
        layer_gate = {"err": errs[worst], "leaf": worst, "flips": flips,
                      "probe": max(probe_errs.values())}
    del p32
    _free()

    per_call = train_launches(cfg, tc.remat, on_card)
    grad = make_grad_fn(cfg, tc)
    before = dict(K.launches)
    with plain:
        g1, _m = grad(params, batches[0])
        _sync(device)
        one = {k: K.launches[k] - before[k] for k in ATTN_KEYS}
        if one != per_call:
            raise RuntimeError(f"{tag}: one grad_fn call launched {one}, "
                               f"expected {per_call}")
        g2, _m = grad(params, batches[0])
    differ = [k for k in g1 if not _same_bits(g1[k], g2[k])]
    del g2
    made = {k: 2 * v for k, v in per_call.items()}
    remat_differ = None
    if tc.remat not in ("none", "full"):
        with plain:
            gn, _m = make_grad_fn(cfg, dataclasses.replace(
                tc, remat="none"))(params, batches[0])
        remat_differ = {k: e for k, e in _grad_errors(gn, g1).items()
                        if not _same_bits(gn[k], g1[k])}
        del gn
        for k, v in train_launches(cfg, "none", on_card).items():
            made[k] += v
    # the probe: B8's dq (or its plain version's, on the CPU) set to zeros
    target = (K, "launch_flash_dq") if on_card else \
        (FA, "flash_attention_dq_plain")
    orig = getattr(*target)
    setattr(*target, lambda q, *a, **kw: torch.zeros_like(q))
    try:
        with plain:
            gp, _m = grad(params, batches[0])
    finally:
        setattr(*target, orig)
    probe = max(_grad_errors(gp, gref).values())
    del gp
    for k, v in per_call.items():
        made[k] += 0 if k.startswith("flash_dq") else v
    errs = _grad_errors(g1, gref)
    worst = max(errs, key=errs.get)
    out = {"ref_losses": ref_losses, "grad_err": errs[worst],
           "grad_worst_leaf": worst, "probe_err": probe,
           "nondeterministic": differ, "remat_differ": remat_differ,
           "per_call": per_call, "layer_gate": layer_gate}
    if layer_gate is not None:
        # the layer gate and its probe: each layer once forward and once
        # backward a run, B8's launches left out of the probe's
        for k, v in train_launches(cfg, "none", on_card).items():
            made[k] += v if k.startswith("flash_dq") else 2 * v
    del g1, gref
    _free()
    return out, made


def moe_layer_grad_checks(cfg, params, p32, batch, plain, probe=False):
    """The MoE family's gradient gate, layer by layer on the f32 stream:
    the f32 reference (``p32``, the oracles) runs microbatch ``batch``
    whole and gives each layer's input h_i and the loss's gradient at its
    output; then each bf16 layer of ``params`` (through the kernels) and
    its f32 copy run on h_i, and each leaf's gradient of ``<out, dL/dout>
    + aux`` is compared, with the tokens whose bf16 and f32 routers pick
    or keep other experts left out of dL/dout on both sides (a flip makes
    the two sides different functions of such a token); the head (final
    norm, lm_head) on the last layer's f32 output and the embedding under
    dL/dh_0 likewise; the bf16 side's attention under ``plain`` (a
    :class:`_CountCalls`). ``probe``: B8's dq (its plain version's on the
    CPU) replaced by zeros on the bf16 side. Returns ({leaf: ||g - ref|| /
    ||ref||}, (tokens compared, tokens flipped))."""
    from repro_torch.accel import kernels as K
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM
    from repro_torch.train.loop import cross_entropy_loss

    f32, adt = torch.float32, L.DTYPES[cfg.activation_dtype]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    labels = batch["labels"]
    with torch.enable_grad():
        h = PM.embed_inputs(cfg32, p32, batch, f32)
        positions = torch.arange(h.shape[1], device=h.device)
        hs, aux = [h], 0.0
        for i, lp in enumerate(p32["layers"]):
            h, a = PM._layer(cfg32, lp, h, positions, "ref", None, i)
            hs.append(h)
            aux = aux + a
        logits = PM._lm_head(cfg32, p32, L.apply_norm(
            cfg32, p32["final_norm"], h))
        loss = cross_entropy_loss(logits, labels) + aux
        del logits
        gs = torch.autograd.grad(loss, hs)
    hs = [x.detach() for x in hs]

    def layer(mixer, ln1, ln2, ffn, h, impl):
        x = L.apply_norm(cfg, ln1, h)
        out, _ = L.attention_block(cfg, mixer, x, positions=positions,
                                   impl=impl)
        h = h + out
        x2 = L.apply_norm(cfg, ln2, h)
        f, a = PM.ffn(cfg, ffn, x2, True)
        return h + f, a, x2

    def grads(tree, loss):
        """{path: gradient} of ``loss`` over a dict of sub-trees and
        tensors."""
        leaves = {}
        for name, sub in tree.items():
            if isinstance(sub, torch.Tensor):
                leaves[name] = sub
            else:
                leaves.update((f"{name}/{k}", t)
                              for k, t in L.tree_leaves(sub).items())
        return dict(zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))))

    target = (K, "launch_flash_dq") if h.is_cuda else \
        (FA, "flash_attention_dq_plain")
    orig = getattr(*target)
    errs, flips = {}, [0, 0]
    if probe:
        setattr(*target, lambda q, *a, **kw: torch.zeros_like(q))
    try:
        for i, (where, _k, mixer, ln1, ln2, ffn, _m, _s) in enumerate(
                _sublayers(cfg, params)):
            sub = {"mixer": mixer, "ln1": ln1, "ln2": ln2, "ffn": ffn}
            sub32 = {k: p32["layers"][i][k] for k in sub}
            with torch.enable_grad():
                with plain:
                    out, a, x2 = layer(mixer, ln1, ln2, ffn,
                                       hs[i].to(adt), "kernel")
                out32, a32, x2r = layer(sub32["mixer"], sub32["ln1"],
                                        sub32["ln2"], sub32["ffn"], hs[i],
                                        "ref")
                agree = _routing_agree(cfg, ffn, sub32["ffn"], x2.detach(),
                                       x2r.detach())
                flips[0] += agree.numel()
                flips[1] += int((~agree).sum())
                g = gs[i + 1] * agree.reshape(gs[i + 1].shape[:2])[..., None]
                with plain:
                    got = grads(sub, (out.float() * g).sum() + a)
                want = grads(sub32, (out32 * g).sum() + a32)
            errs.update((f"layers/{i}/{k}", _rel_norm(got[k], want[k]))
                        for k in want)
            del out, out32, got, want
    finally:
        setattr(*target, orig)
    # the head on the last layer's f32 output, the embedding under dL/dh_0
    name = "embed" if cfg.tie_embeddings else "lm_head"
    got = []
    with torch.enable_grad():
        for p, c, x in ((params, cfg, hs[-1].to(adt)), (p32, cfg32, hs[-1])):
            logits = PM._lm_head(c, p, L.apply_norm(c, p["final_norm"], x))
            got.append(grads({"final_norm": p["final_norm"], name: p[name]},
                             cross_entropy_loss(logits, labels)))
            del logits
            if not cfg.tie_embeddings:
                got[-1].update(grads({"embed": p["embed"]}, (PM.embed_inputs(
                    c, p, batch, x.dtype).float() * gs[0]).sum()))
    errs.update((k, _rel_norm(got[0][k], w)) for k, w in got[1].items())
    return errs, flips


# The line a child process of family_train_child prints its launch
# counts on.
FAMILY_TRAIN_COUNTS = "family train counts "


def family_train_child(name: str) -> dict:
    """:func:`family_train_path` of ``name`` in a child process
    (``chip_smoke.py --family-train NAME``) whose caching allocator maps
    expandable segments: the moonshot cut's AdamW step holds the old and
    the new moments (2 x 23.6 GB) beside the float32 sums and the
    weights, 75.6 GB at its peak on an H100 80GB (PERF.md), and blocks of
    fixed sizes left gigabytes reserved but unusable there (an
    out-of-memory error at 72.95 GB allocated). The allocator's setting is read
    when a process first touches the card, so only a new process can
    take it; this one keeps the allocator every earlier phase ran
    with. Its output is echoed here; returns its launch counts."""
    _free()
    print(f"{name} train: in a child process; this process holds "
          f"{torch.cuda.memory_allocated()} bytes of device memory "
          f"({torch.cuda.memory_reserved()} reserved)", flush=True)
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--family-train",
         name], env=env, stdout=subprocess.PIPE, text=True)
    counts = None
    for line in proc.stdout:
        print(line, end="", flush=True)
        if line.startswith(FAMILY_TRAIN_COUNTS):
            counts = json.loads(line[len(FAMILY_TRAIN_COUNTS):])
    if proc.wait() or counts is None:
        raise RuntimeError(f"{name} train: the child process exited with "
                           f"{proc.returncode}")
    return counts


def _leaf_marks(params) -> dict:
    """Each leaf's bits summed as int64 with a float64 sum of squares: a
    change of any bit of a leaf changes one or the other (short of a
    coincidence), without a copy of the weights."""
    from repro_torch.models import layers as L

    out = {}
    for k, t in L.tree_leaves(params).items():
        t = t.detach()
        bits = t.view(torch.int16) if t.element_size() == 2 else \
            t.view(torch.int32)
        out[k] = (int(bits.to(torch.int64).sum()),
                  float(t.double().square().sum()))
    return out


def _profile_train_step(tag, step_fn):
    """One training step under the profiler (device activity only): its
    wall, the device's busy share of it and the device time by kernel;
    returns (the step's result, its wall in seconds)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == cuda]
    dev_us = sum(e.self_device_time_total for e in kernels)
    shares = {}
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        mine = [e for e in kernels if name in e.key]
        shares[name] = sum(e.self_device_time_total for e in mine) / dev_us
    print(f"profile {tag} step: wall {wall:.6f} s (profiled), device busy "
          f"{dev_us / 1e6:.6f} s = {dev_us / 1e6 / wall:.6f} of wall; "
          f"shares of device time B6 {shares['flash_fwd']:.4f}, B7 "
          f"{shares['flash_dkv']:.4f}, B8 {shares['flash_dq']:.4f}")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60), flush=True)
    return out, wall


def family_train_path(name: str, cfg=None, device="cuda",
                      steps: int = FAMILY_TRAIN_STEPS,
                      seq: int = FAMILY_TRAIN_SEQ):
    """One family's training path (``name`` audio, vlm or moe) at the
    width of :func:`family_train_config` (or ``cfg``) on ``device`` (a
    CPU run rehearses it on the plain versions, with no launch to count):
    the checks on the initial weights (:func:`family_train_checks`),
    then the optimizer state, a warm-up step and ``steps`` timed steps of
    ``make_train_step``. Returns the launch counts of the path."""
    from repro_torch.accel import kernels as K
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.models import layers as L
    from repro_torch.models import model as PM
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import TrainConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references
    torch.backends.cudnn.allow_tf32 = False
    tag = f"{name} train"
    cfg = cfg or family_train_config(name)
    on_card = torch.device(device).type == "cuda"
    n_mb, per_mb, remat = FAMILY_TRAIN[name]
    n_seq, tol = n_mb * per_mb, FAMILY_GRAD_TOL[name]
    tc = TrainConfig(microbatches=n_mb, remat=remat)
    K.reset_launches()
    gen = torch.Generator(device=device)
    gen.manual_seed(FAMILY_TRAIN_SEED)
    params = PM.init_params(cfg, gen, device=device)
    params = L.tree_from_leaves(params, L.tree_leaves(params),
                                trainable=True)
    n_params = sum(t.numel() for t in params.parameters())
    param_bytes = _nbytes(tuple(params.parameters()))
    batches = [family_train_batch(cfg, s, n_seq, seq, device)
               for s in range(1 + steps)]
    mbs = [{k: v[i * per_mb:(i + 1) * per_mb] for k, v in
            batches[0].items()} for i in range(n_mb)]
    moe = cfg.moe
    print(f"{tag}: {cfg.arch_id} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim()}"
          + (f", {moe.n_experts} experts top-{moe.top_k} of width "
             f"{moe.d_ff_expert}" if moe else "")
          + f", vocab {cfg.vocab_size}, {n_params} parameters "
          f"({param_bytes} bytes); {n_mb} microbatches of {per_mb} x {seq} "
          f"positions a step, remat {remat!r}", flush=True)

    plain = _CountCalls([(FA, "flash_attention_plain"),
                         (FA, "flash_attention_dkv_plain"),
                         (FA, "flash_attention_dq_plain"),
                         (FREF, "attention_reference")])
    # -- the checks on the initial weights (before the optimizer state) --
    checks, made = family_train_checks(tag, cfg, params, mbs, tc, device,
                                       plain)
    ref_loss = float(np.mean(checks["ref_losses"]))

    # -- the optimizer state, a warm-up step and the timed steps ---------
    state = {"params": params, "opt": adamw_init(L.tree_leaves(params)),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    opt_bytes = _nbytes(tuple(state["opt"]["m"].values())) + _nbytes(
        tuple(state["opt"]["v"].values())) + _nbytes(state["opt"]["count"])
    marks = _leaf_marks(params)
    del params
    step_fn = make_train_step(cfg, tc)
    before = dict(K.launches)
    with plain:
        state, metrics = step_fn(state, batches[0])
        losses = [float(metrics["loss"])]
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        walls = []
        for s in range(1, 1 + steps):
            if on_card and s == steps:
                (state, metrics), wall = _profile_train_step(
                    tag, lambda: step_fn(state, batches[s]))
            else:
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batches[s])
                _sync(device)
                wall = time.perf_counter() - t0
            walls.append(wall)
            losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() if on_card else None
    step_counts = {k: K.launches[k] - before[k] for k in ATTN_KEYS}
    want_steps = {k: v * n_mb * (1 + steps)
                  for k, v in checks["per_call"].items()}
    counts = dict(K.launches)
    want = {k: made[k] + want_steps[k] for k in ATTN_KEYS}
    others = {k: c for k, c in counts.items() if k not in want and c}
    tokens = n_seq * seq
    print(f"{tag}: step walls {[round(w, 6) for w in walls]} s (the last "
          f"profiled), mean of the unprofiled "
          f"{np.mean(walls[:-1] if len(walls) > 1 else walls):.6f} s "
          f"({tokens / np.mean(walls[:-1] if len(walls) > 1 else walls):.1f}"
          f" tokens/s); losses {losses}; peak device memory {peak} bytes; "
          f"parameters {param_bytes} bytes, optimizer state {opt_bytes} "
          f"bytes; launches a grad_fn call {checks['per_call']}, in the "
          f"steps {step_counts}, in the path "
          f"{ {k: counts[k] for k in ATTN_KEYS} }; plain-version calls "
          f"{plain.calls}", flush=True)
    if step_counts != want_steps or {k: counts[k] for k in want} != want \
            or others:
        raise RuntimeError(f"{tag}: launches {counts} (steps "
                           f"{step_counts}), expected {want} (steps "
                           f"{want_steps})")
    if on_card and any(plain.calls.values()):
        raise RuntimeError(f"{tag}: plain versions called on the card's "
                           f"path: {plain.calls}")

    # -- the gates --------------------------------------------------------
    loss_err = abs(losses[0] - ref_loss) / abs(ref_loss)
    gate = checks["layer_gate"]
    whole = (f"max ||g - ref|| / ||ref|| {checks['grad_err']} at "
             f"{checks['grad_worst_leaf']}")
    if gate is None:
        grad_err, probe_err = checks["grad_err"], checks["probe_err"]
        whole += f" (limit {tol}); the probe (B8's dq zeroed) {probe_err}"
    else:
        grad_err, probe_err = gate["err"], gate["probe"]
        whole += (f" (not gated: routing flips), the probe (B8's dq "
                  f"zeroed) {checks['probe_err']}; layer by layer on the "
                  f"f32 stream, flipped tokens left out: max ||g - ref|| / "
                  f"||ref|| {grad_err} at {gate['leaf']} (limit {tol}); "
                  f"the probe (B8's dq zeroed) {probe_err}; routing flips "
                  f"{gate['flips'][1]} of {gate['flips'][0]} (token, layer) "
                  f"pairs")
    print(f"{tag} checks: step 0 loss {losses[0]!r} vs float32 through the "
          f"oracles {ref_loss!r} (microbatches {checks['ref_losses']}), "
          f"relative error {loss_err} (limit {TRAIN_LOSS_TOL}); microbatch "
          f"0 gradients vs float32 autograd through the oracles: {whole}; "
          f"leaves differing between two runs {checks['nondeterministic']}"
          + (f"; leaves differing between {remat!r} and 'none' "
             f"{checks['remat_differ']}"
             if checks["remat_differ"] is not None else ""), flush=True)
    if not loss_err <= TRAIN_LOSS_TOL:
        raise RuntimeError(f"{tag}: step 0 loss off by {loss_err}")
    if not grad_err <= tol:
        raise RuntimeError(f"{tag}: gradients off by {grad_err}")
    if not probe_err > tol:
        raise RuntimeError(f"{tag}: the probe ({probe_err}) passes {tol}: "
                           f"it is too loose")
    if gate is not None and not gate["flips"][1] <= \
            FAMILY_FLIP_TOL * gate["flips"][0]:
        raise RuntimeError(f"{tag}: routing flips {gate['flips']}")
    if checks["nondeterministic"]:
        raise RuntimeError(f"{tag}: gradients not reproducible: "
                           f"{checks['nondeterministic']}")
    if checks["remat_differ"]:
        raise RuntimeError(f"{tag}: {remat!r} gradients differ from "
                           f"'none': {checks['remat_differ']}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag}: losses not finite: {losses}")
    count = int(state["opt"]["count"])
    after = _leaf_marks(state["params"])
    same = [k for k in marks if after[k] == marks[k]]
    zero_m = [k for k, m in state["opt"]["m"].items() if not bool(m.any())]
    unreached = ["embed"] if cfg.family == "audio" else []
    stuck = [k for k in same if not k.endswith(FROZEN_IN_BF16)
             and k not in unreached]
    print(f"{tag}: AdamW count {count} after {1 + steps} steps; leaves "
          f"unchanged {same}; leaves with a zero first moment {zero_m}",
          flush=True)
    if count != 1 + steps or stuck or zero_m != unreached:
        raise RuntimeError(f"{tag}: AdamW count {count}, leaves that did "
                           f"not move {stuck}, zero moments {zero_m}")
    del state, metrics, batches, mbs
    _free()
    return counts


# Name parts of the kernels whose resources the build phase prints.
HOPPER_KERNELS = ("sm90", "group_sum", "decode_split", "decode_combine",
                  "ssd_prep", "ssd_state", "ssd_out", "spatial_",
                  "temporal_", "late_", "reap_")


def print_resource_usage(libs) -> None:
    """Registers and stack bytes (spills) of each Hopper kernel and of
    B1's to B4's, as ``cuobjdump -res-usage`` reads them from the built
    libraries."""
    from repro_torch.accel import kernels as K

    tool = Path(K.nvcc()).with_name("cuobjdump")
    for name in ("assess", "flash", "flash_bwd", "decode", "ssd"):
        try:
            out = subprocess.run([str(tool), "-res-usage", str(libs[name])],
                                 check=True, capture_output=True,
                                 text=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"resources {name}: cuobjdump failed: {e}", flush=True)
            continue
        fn = None
        for line in out.splitlines():
            line = line.strip()
            if line.startswith("Function "):
                fn = line[len("Function "):].rstrip(":")
            elif fn and line.startswith("REG:"):
                if any(key in fn for key in HOPPER_KERNELS):
                    print(f"resources {name}: {fn}: {line}", flush=True)
                fn = None


def decode_wall() -> None:
    """The serving path's decode alone, through the entry points every
    slice of the port has: Qwen3-8B at full width, random bf16 weights
    from seed 0, the 4 x 2,048-token prefill, then 64 greedy steps three
    times over (ms a step by the host's clock), and the device time of a
    step by the profiler over 8 more (the sum of its kernel times, as the
    serving profile takes it: a step waits on the host, so ``_device_ms``
    cannot time it), with B9's share. Run as ``chip_smoke.py --decode-wall
    [SRC]`` with SRC the ``src`` directory of the port to time (this
    checkout's by default), so that two checkouts compare in one call."""
    from repro_torch.accel import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import model as PM
    from repro_torch.train.loop import (TrainConfig, make_prefill_step,
                                        make_serve_step)

    K.build()
    cfg = get_config(SERVE_ARCH)
    B, P = SERVE_BATCH, SERVE_PROMPT
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SERVE_SEED)
    params = PM.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(SERVE_SEED)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))
                               .astype(np.int32)).cuda()
    tc = TrainConfig()
    serve_step = make_serve_step(cfg, tc)
    w = 64
    _l, warm = make_prefill_step(cfg, tc, max_len=w + 1)(
        params, {"tokens": prompts[:, :w]})
    serve_step(params, warm, prompts[:, w], torch.full(
        (B,), w, dtype=torch.int32, device="cuda"))
    del warm
    logits, cache = make_prefill_step(cfg, tc, max_len=SERVE_MAX_LEN)(
        params, {"tokens": prompts})
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    K.reset_launches()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_STEPS):
            logits, cache = serve_step(params, cache, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
            pos = pos + 1
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / SERVE_STEPS)
    counts = {k: c for k, c in K.launches.items() if c}
    from torch.profiler import ProfilerActivity, profile

    steps = 8
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, cache = serve_step(params, cache, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
            pos = pos + 1
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.device_type == cuda]
    dev = sum(e.self_device_time_total for e in events) / 1e3 / steps
    b9 = sum(e.self_device_time_total for e in events
             if "decode_" in e.key) / 1e3 / steps
    print(f"decode wall {sys.path[0]}: "
          f"{', '.join(f'{x:.3f}' for x in walls)} ms a step (three runs of "
          f"{SERVE_STEPS} steps); device time {dev:.3f} ms a step, B9 "
          f"{b9:.3f} (profiler, {steps} steps); launches {counts}",
          flush=True)


def _parent_smem(bytes_: int, kernel: str, n: int) -> None:
    """An earlier B1 or B2 held every table in shared memory: raise where
    ``n`` nodes need more than a block's."""
    from repro_torch.accel import kernels as K

    if bytes_ > K.MAX_SMEM:
        raise ValueError(f"{kernel}: {n} nodes need {bytes_} B of shared "
                         f"memory, above the {K.MAX_SMEM} B a block may use")


def parent_assess(source: Path) -> dict:
    """B1 to B4 of another ``assess.cu``, built with ``nvcc`` into
    ``build/parent_kernels/``; returns the four wrappers by kernel name,
    each taking this checkout's wrapper's arguments. A source with this
    checkout's C interface runs through this checkout's wrappers, its
    library swapped in for the call. An earlier source is called as that
    version's wrappers called it: the same checks, allocations and launch
    counts. Before slice 10, B1 and B2 took no work buffer (one launch
    each, shared memory from ``assess_*_smem(n)``); before slice 9, the
    wrapper allocated B3's (N, jcap, cap) candidate scratch and B4's flag
    column on every call, and B4 was a memset and two launches."""
    import ctypes

    from repro_torch.accel import kernels as K

    out = ROOT / "build" / "parent_kernels" / "libassess_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([K.nvcc(), *K.FLAGS["assess"], "-o", str(out),
                    str(source)], check=True)
    lib = ctypes.CDLL(str(out))

    def swapped(fn):
        def run(*args, **kw):
            own = K._libs["assess"]
            K._libs["assess"] = lib
            try:
                return fn(*args, **kw)
            finally:
                K._libs["assess"] = own
        return run

    names = ("spatial", "temporal", "late", "reap")
    if hasattr(lib, "assess_spatial_table_bytes"):
        K._bind("assess", lib)
        return {name: swapped(getattr(K, f"launch_{name}"))
                for name in names}
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    if hasattr(lib, "assess_spatial_work_bytes"):
        # slices 10-11: this checkout's wrappers, but every group table in
        # shared memory and a work buffer without tables, sized and kept
        # here, as that version's ``glance_work`` did
        lib.assess_spatial.argtypes = [P] * 6 + [I] * 5 + [P, P, P]
        lib.assess_temporal.argtypes = [P] * 5 + [I] * 3 + [P] * 4
        lib.assess_spatial_smem.argtypes = [I, I, I]
        lib.assess_temporal_smem.argtypes = [I, I, I]
        lib.assess_spatial_work_bytes.argtypes = [I, I, I]
        lib.assess_temporal_work_bytes.argtypes = [I, I]
        for fn in (lib.assess_spatial_smem, lib.assess_temporal_smem,
                   lib.assess_spatial_work_bytes,
                   lib.assess_temporal_work_bytes):
            fn.restype = ctypes.c_size_t
        K.bind_late(lib)
        bufs = {}

        def work(_lib, kernel, device, stream, N, cap, jcap, n):
            key = (device.index, stream, kernel, N, cap, jcap, n)
            if key not in bufs:
                smem = getattr(lib, f"assess_{kernel}_smem")(n, jcap, cap)
                _parent_smem(smem, f"{kernel} (parent)", n)
                nbytes = (lib.assess_spatial_work_bytes(cap, jcap, N)
                          if kernel == "spatial" else
                          lib.assess_temporal_work_bytes(cap, jcap))
                bufs[key] = torch.empty(nbytes, dtype=torch.uint8,
                                        device=device)
            return bufs[key]

        def glance(fn):
            def run(*args, **kw):
                own = K.glance_work
                K.glance_work = work
                try:
                    return swapped(fn)(*args, **kw)
                finally:
                    K.glance_work = own
            return run

        return {"spatial": glance(K.launch_spatial),
                "temporal": glance(K.launch_temporal),
                "late": swapped(K.launch_late),
                "reap": swapped(K.launch_reap)}
    lib.assess_spatial.argtypes = [P] * 6 + [I] * 5 + [P, P]
    lib.assess_temporal.argtypes = [P] * 5 + [I] * 3 + [P, P, P]
    lib.assess_spatial_smem.argtypes = [I]
    lib.assess_temporal_smem.argtypes = [I]
    lib.assess_spatial.restype = lib.assess_temporal.restype = ctypes.c_int
    lib.assess_spatial_smem.restype = ctypes.c_size_t
    lib.assess_temporal_smem.restype = ctypes.c_size_t

    def spatial(rho, node, kind, jls, running, nh, jcap):
        dev = rho.device
        N, cap, key = K._scenarios(rho, "spatial")
        n, k = nh.shape
        K._cols(dev, tuple(rho.shape), f64=[("rho", rho)],
                i32=[("node", node), ("kind", kind), ("jls", jls),
                     ("running", running)])
        K._check(nh, "nh", torch.int32, (n, k), dev)
        K.library()
        _parent_smem(lib.assess_spatial_smem(n), "spatial (parent)", n)
        fired = torch.empty(tuple(rho.shape[:-1]) + (jcap, 2, n),
                            dtype=torch.bool, device=dev)
        rc = lib.assess_spatial(
            rho.data_ptr(), node.data_ptr(), kind.data_ptr(),
            jls.data_ptr(), running.data_ptr(), nh.data_ptr(), cap, n, k,
            jcap, N, fired.data_ptr(), K._stream(dev))
        K._raise_on(rc, "spatial (parent)")
        K.count_launch(key)
        return fired

    def temporal(prog, tprog, node, jls, alive, jcap, n):
        dev, cap = prog.device, prog.shape[0]
        K._cols(dev, (cap,), f64=[("prog", prog), ("tprog", tprog)],
                i32=[("node", node), ("jls", jls), ("alive", alive)])
        K.library()
        _parent_smem(lib.assess_temporal_smem(n), "temporal (parent)", n)
        zn = torch.empty((jcap, n), dtype=torch.float64, device=dev)
        zp = torch.empty((jcap, n), dtype=torch.float64, device=dev)
        rc = lib.assess_temporal(
            prog.data_ptr(), tprog.data_ptr(), node.data_ptr(),
            jls.data_ptr(), alive.data_ptr(), cap, n, jcap, zn.data_ptr(),
            zp.data_ptr(), K._stream(dev))
        K._raise_on(rc, "temporal (parent)")
        K.count_launch("temporal")
        return zn, zp

    fns = {"spatial": spatial, "temporal": temporal}
    if hasattr(lib, "assess_late_work_bytes"):
        K.bind_late(lib)
        fns.update(late=swapped(K.launch_late), reap=swapped(K.launch_reap))
        return fns
    lib.assess_late.argtypes = [P] * 9 + [I] * 3 + [D] * 4 + [P] * 6
    lib.assess_reap.argtypes = [P] * 3 + [I, I, P, P, P]
    lib.assess_late.restype = lib.assess_reap.restype = ctypes.c_int

    def late(prog, start, rate, spec, tseg, jls, running, runatt, order,
             now, min_runtime, q, win_factor, jcap):
        dev = prog.device
        N, cap, key = K._scenarios(prog, "late")
        K._cols(dev, tuple(prog.shape),
                f64=[("prog", prog), ("start", start), ("rate", rate)],
                i32=[("spec", spec), ("tseg", tseg), ("jls", jls),
                     ("running", running), ("runatt", runatt),
                     ("order", order)])
        K.library()
        c_rho = torch.empty((N, jcap, cap), dtype=torch.float64, device=dev)
        c_est = torch.empty((N, jcap, cap), dtype=torch.float64, device=dev)
        c_pos = torch.empty((N, jcap, cap), dtype=torch.int32, device=dev)
        out_shape = tuple(prog.shape[:-1]) + (jcap,)
        victim = torch.empty(out_shape, dtype=torch.int32, device=dev)
        win = torch.empty(out_shape, dtype=torch.int32, device=dev)
        rc = lib.assess_late(
            prog.data_ptr(), start.data_ptr(), rate.data_ptr(),
            spec.data_ptr(), tseg.data_ptr(), jls.data_ptr(),
            running.data_ptr(), runatt.data_ptr(), order.data_ptr(), cap,
            jcap, N, float(now), float(min_runtime), float(q),
            float(win_factor), c_rho.data_ptr(), c_est.data_ptr(),
            c_pos.data_ptr(), victim.data_ptr(), win.data_ptr(),
            K._stream(dev))
        K._raise_on(rc, "late (parent)")
        K.count_launch(key)
        return victim, win

    def reap(a_state, tseg, live):
        dev = a_state.device
        N, cap, key = K._scenarios(a_state, "reap")
        K._cols(dev, tuple(a_state.shape), i32=[
            ("a_state", a_state), ("tseg", tseg), ("live", live)])
        K.library()
        done = torch.empty(a_state.shape, dtype=torch.int32, device=dev)
        out = torch.empty(a_state.shape, dtype=torch.int32, device=dev)
        rc = lib.assess_reap(a_state.data_ptr(), tseg.data_ptr(),
                             live.data_ptr(), cap, N, done.data_ptr(),
                             out.data_ptr(), K._stream(dev))
        K._raise_on(rc, "reap (parent)")
        K.count_launch(key)
        return out

    fns.update(late=late, reap=reap)
    return fns


def assess_parent(source: str) -> None:
    """B1 to B4 of this checkout against those of an earlier ``assess.cu``
    (:func:`parent_assess`) at the main path's snapshot (the kernel
    phase's inputs), in one process: both equal to the plain version, then
    timed in turns parent, change, change, parent, each by CUDA events, by
    device time and by the host's time per call; then B1 at N = 64 (the
    sweep's shape: the kernel phase's snapshot, 64 copies) the same way,
    and B1 at 10,000 nodes (:data:`GLANCE_CASES` ``n10000``), which the
    change must run and match the plain version on, and the parent may
    refuse. Run as ``chip_smoke.py --assess-parent PATH`` with PATH the
    earlier source, e.g. one taken with ``git show <commit>:src/
    repro_torch/accel/csrc/assess.cu`` into ``build/``."""
    from repro_torch.accel import kernels as K
    from repro_torch.accel import torch_backend as TB

    libs = K.build()
    K.library()
    print_resource_usage(libs)
    parent = parent_assess(Path(source))
    names = ("spatial", "temporal", "late", "reap")
    change = {name: getattr(TB, name) for name in names}
    plain = {name: getattr(TB, name + "_ref") for name in names}
    cap_state = capture_snapshot()
    dev_in = kernel_inputs(cap_state, "cuda")
    cpu_in = kernel_inputs(cap_state, "cpu")
    dev_in["spatial_sweep"] = stack_scenarios(
        "spatial", [dev_in["spatial"]] * N_SCENARIOS)
    cpu_in["spatial_sweep"] = stack_scenarios(
        "spatial", [cpu_in["spatial"]] * N_SCENARIOS)
    for what in names + ("spatial_sweep",):
        name = what.replace("_sweep", "")
        args = dev_in[what]
        want = plain[name](*cpu_in[what])
        for label, fn in (("parent", parent[name]), ("change", change[name])):
            equal, err = _compare(fn(*args), want)
            if not equal:
                raise RuntimeError(f"{what} {label}: kernel != plain version "
                                   f"(max_abs_err {err})")
        times = {"parent": [], "change": []}
        for label in ("parent", "change", "change", "parent"):
            fn = parent[name] if label == "parent" else change[name]
            ms = _time_ms(fn, args)
            device_ms, host_us = _device_host(fn, args)
            times[label].append({"ms": ms, "device_ms": device_ms,
                                 "host_us": host_us})
        print(f"assess parent vs change, {what} at cap "
              f"{args[0].shape[-1]}: {json.dumps(times)}", flush=True)
    # each kernel's two passes apart, by the profiler's kernel times (they
    # split a call's time between its kernels; they do not time the call)
    for what, passes in (("spatial", ("spatial_rows", "spatial_jobs")),
                         ("spatial_sweep", ("spatial_rows", "spatial_jobs")),
                         ("temporal", ("temporal_rows", "temporal_jobs")),
                         ("late", ("late_rows", "late_jobs"))):
        _sub_kernels(f"{what} (change)", change[what.replace("_sweep", "")],
                     dev_in[what], passes)
    big = glance_inputs("n10000", 0, "cuda")["spatial"]
    equal, err = _compare(change["spatial"](*big),
                          plain["spatial"](*glance_inputs(
                              "n10000", 0, "cpu")["spatial"]))
    if not equal:
        raise RuntimeError(f"spatial at 10,000 nodes: kernel != plain "
                           f"version (max_abs_err {err})")
    try:
        parent["spatial"](*big)
        torch.cuda.synchronize()
        verdict = "ran"
    except (ValueError, RuntimeError) as e:
        verdict = f"raised: {e}"
    print(f"spatial at 10,000 nodes: change equal to the plain version; "
          f"parent {verdict}", flush=True)


TRAIN_WALL_RUNS = 3


def train_wall(cfg=None, device="cuda", seq=TRAIN_SEQ, steps=TRAIN_STEPS,
               runs=TRAIN_WALL_RUNS) -> None:
    """The training path's fault-free run alone (a warm-up step and
    ``steps`` steps of Qwen1.5-0.5B, or ``cfg``, on 4 host threads under
    bino), ``runs`` times, through the port whose ``src`` directory comes
    first on ``sys.path``, with the hosts' heartbeats timed as the
    coordinator receives them: each run's outcome (``StepWedged``
    caught), step walls, detections, the longest silence of each host and
    how many silences passed Eq. 4's thresholds (0.4 s at the least, 1 s
    before a host's first outage), and the longest pause of the garbage
    collector. Run as ``chip_smoke.py --train-wall [SRC]``, so that two
    checkouts compare in one call."""
    from repro_torch.accel import kernels as K
    from repro_torch.accel.torch_backend import TorchBackend
    from repro_torch.configs import get_config
    from repro_torch.runtime import RuntimeConfig, StepWedged, TrainerRuntime
    from repro_torch.train.loop import TrainConfig

    on_card = torch.device(device).type == "cuda"
    if on_card:
        K.build()
        for name in K.SOURCES:
            K.library(name)
    cfg = cfg or get_config(TRAIN_ARCH)
    for run in range(runs):
        watch = _HeartbeatWatch()
        t = TrainerRuntime(
            cfg, TrainConfig(), RuntimeConfig(
                n_hosts=TRAIN_HOSTS, microbatches_per_shard=TRAIN_MB,
                recovery="bino", compute_delay=0.0, verify_columnar=True,
                assess_backend=None if on_card else TorchBackend("cpu")),
            seq_len=seq, per_shard_batch=1, seed=TRAIN_SEED, device=device)
        reports, outcome = [], "ok"
        with _hosts_joined(t):
            try:
                reports += t.run(1)
                reports += t.run(steps)
            except StepWedged as e:
                outcome = f"StepWedged: {e}"
            finally:
                watch.stop()
        print(f"train wall {sys.path[0]} run {run}: {outcome}; step walls "
              f"{[round(r.wall_s, 6) for r in reports]}; detections "
              f"{t.coord.metrics.counter('detections').n}, wedges "
              f"{sum(r.wedges for r in reports)}; {watch.summary()}",
              flush=True)
        del t, reports
        _free()


class _HeartbeatWatch:
    """From its creation to :meth:`stop`: the heartbeat silences of every
    host of the runtimes created meanwhile, as their coordinator receives
    them (the gap between one heartbeat's time and the next), and the
    garbage collector's pauses. Eq. 4 declares a host failed after a
    silence above its threshold: 1 s before the host's first outage, 0.4
    s at the least (``RuntimeConfig.glance``)."""

    def __init__(self):
        from repro_torch.runtime import coordinator as C

        self._cls, self._orig = C.Coordinator, C.Coordinator._on_heartbeat
        self.silences, self.pauses = {}, []
        last, lock, orig, t0 = {}, threading.Lock(), self._orig, [0.0]

        def on_heartbeat(coord, host_id, now):
            with lock:
                if host_id in last:
                    self.silences.setdefault(host_id, []).append(
                        now - last[host_id])
                last[host_id] = now
            orig(coord, host_id, now)

        def on_gc(phase, info):
            if phase == "start":
                t0[0] = time.perf_counter()
            else:
                self.pauses.append((time.perf_counter() - t0[0],
                                    info["generation"]))

        self._on_gc = on_gc
        C.Coordinator._on_heartbeat = on_heartbeat
        gc.callbacks.append(on_gc)

    def stop(self) -> None:
        """Stop timing the collector and leave runtimes created from now
        on untouched (hosts spawned meanwhile keep reporting here)."""
        self._cls._on_heartbeat = self._orig
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def summary(self) -> str:
        every = [x for v in self.silences.values() for x in v]
        worst = {h: round(max(v), 6) for h, v in sorted(self.silences.items())}
        gc_worst = max(self.pauses, default=(0.0, None))
        return (f"heartbeats {len(every)}, longest silence by host {worst}, "
                f"silences over 0.4 s {sum(x > 0.4 for x in every)}, over 1 s "
                f"{sum(x > 1.0 for x in every)}; garbage collections "
                f"{len(self.pauses)}, longest {gc_worst[0]:.6f} s (generation "
                f"{gc_worst[1]})")


def sim_wall() -> None:
    """The flat main path alone on the card, through the port whose
    ``src`` directory comes first on ``sys.path``: bino and yarn (assess
    ticks, assess_wall, ticks/s, wall), then bino once more under the
    profiler (device busy share). Run as ``chip_smoke.py --sim-wall
    [SRC]``, so that two checkouts compare in one call. The kernels are
    built and loaded first, so that no run's wall holds their build."""
    from repro_torch.accel import kernels as K

    K.library()
    torch.zeros(1, device="cuda")
    for policy in ("bino", "yarn"):
        sim, _l, _k, wall = scenario(policy, None)
        torch.cuda.synchronize()
        print(f"sim wall {sys.path[0]} {policy}: {sim.assess_ticks} ticks, "
              f"assess_wall {sim.assess_wall:.6f} s, "
              f"{sim.assess_ticks / sim.assess_wall:.3f} ticks/s, wall "
              f"{wall:.6f} s", flush=True)
    profile_bino()


def _phase_clock():
    """``phase(label, fn, *args)``: ``fn(*args)``, then the wall time since
    the clock was made."""
    start = time.perf_counter()

    def phase(label, fn, *args):
        out = fn(*args)
        print(f"phase {label} done at {time.perf_counter() - start:.1f} s",
              flush=True)
        return out

    return phase


def _phases_before_training(phase):
    """Every phase that runs before the training phase, in order: (kernel
    rows, main-path launches, the predictor's counts, the sweep's and the
    serving path's launches)."""
    cap_state = capture_snapshot()
    rows = phase("kernels", kernel_phase, cap_state)
    launches = phase("main path", main_path)
    predict = phase("predictor", predictor_path)
    fair_launches, fair = phase("fair path", fair_path)
    launches["price"] = fair_launches["price"]
    rows["price"] = price_phase(fair["prices"])
    sweep, sweep_launches = phase("sweep", sweep_path, fair["state"],
                                  fair["now"])
    launches.update((k, sweep_launches[k])
                    for k in ("spatial_sweep", "late_sweep", "reap_sweep"))
    rows.update(batched_kernel_phase(sweep))
    phase("profile", profile_bino)
    rows.update(phase("attention", attention_kernel_phase))
    serve_launches = phase("serving", serve_path)
    launches.update((k, serve_launches[k]) for k in ("flash_fwd", "decode"))
    rows.update(phase("attention backward", attention_bwd_phase))
    return rows, launches, predict, sweep_launches, serve_launches


TRAIN_CONTEXT_RUNS = 3


def train_context(runs: int = TRAIN_CONTEXT_RUNS) -> int:
    """The training phase where a fault-free run once lost quorum
    (ROADMAP.md, C3): after every phase before it (their heaps and
    threads), ``runs`` times in one process, each printing its fault-free
    run's heartbeat silences and collector pauses. A run that raises prints its traceback (its hosts
    joined) and the next one starts; returns the number that raised. Run
    as ``chip_smoke.py --train-context [RUNS]``."""
    import traceback

    from repro_torch.accel import kernels as K

    for name in K.build():
        K.library(name)
    phase = _phase_clock()
    _phases_before_training(phase)
    failed = 0
    for run in range(runs):
        try:
            phase(f"training (run {run})", train_path)
        except Exception:
            failed += 1
            print(f"train context run {run} raised:", flush=True)
            traceback.print_exc()
            sys.stdout.flush()
        _free()
    print(f"train context: {runs} runs of the training phase after the "
          f"earlier phases, {failed} raised", flush=True)
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    modes = {"--decode-wall": decode_wall, "--sim-wall": sim_wall,
             "--train-wall": train_wall}
    if sys.argv[1:2] and sys.argv[1] in modes:
        if len(sys.argv) > 2:
            sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        print(f"card: {smi}", flush=True)
        modes[sys.argv[1]]()
        return 0
    if sys.argv[1:2] == ["--family-train"]:
        from repro_torch.accel import kernels as K

        print(f"card: {smi}", flush=True)
        for name in K.build():
            K.library(name)
        counts = family_train_path(sys.argv[2])
        print(FAMILY_TRAIN_COUNTS + json.dumps(counts), flush=True)
        return 0
    if sys.argv[1:2] == ["--train-context"]:
        print(f"card: {smi}", flush=True)
        runs = int(sys.argv[2]) if len(sys.argv) > 2 else TRAIN_CONTEXT_RUNS
        return 1 if train_context(runs) else 0
    if sys.argv[1:2] == ["--assess-parent"]:
        print(f"card: {smi}", flush=True)
        assess_parent(sys.argv[2])
        return 0
    from repro_torch.accel import kernels as K

    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = K.build()
    for name in libs:
        K.library(name)
    secs = K.build_seconds
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.3f} s (nvcc seconds by source: "
          f"{json.dumps({k: round(v, 3) for k, v in secs.items()})})",
          flush=True)
    print_resource_usage(libs)

    phase = _phase_clock()
    rows, launches, predict, sweep_launches, serve_launches = \
        _phases_before_training(phase)
    train_launches = phase("training", train_path)
    launches.update((k, train_launches[k]) for k in ("flash_dkv",
                                                     "flash_dq"))
    gc.collect()    # the earlier models' last references
    torch.cuda.empty_cache()
    rows.update(phase("ssd", ssd_kernel_phase))
    ssm_launches = phase("ssm serving", ssm_serve_path)
    launches["ssd"] = ssm_launches["ssd"]
    _free()         # the ssm model's last references
    family = {name: phase(f"{name} serving", family_path, name)
              for name in ("moe", "hybrid", "audio", "vlm")}
    family_train = {name: phase(f"{name} training", family_train_path, name)
                    for name in ("audio", "vlm")}
    family_train["moe"] = phase("moe training", family_train_child, "moe")
    launches["reap"] += predict["policy"]["reap"]
    for name, row in rows.items():
        row["launches"] = launches[name]
    # the main paths' launches of B1's, B2's and B3's job passes, B9's
    # combine and B10's sub-kernels
    for name in ("spatial", "temporal", "late"):
        rows[name]["jobs_launches"] = launches[name + "_jobs"]
    for name in ("spatial", "late"):
        rows[name + "_sweep"]["jobs_launches"] = \
            sweep_launches[name + "_sweep_jobs"]
    rows["decode"]["combine_launches"] = serve_launches["decode_combine"]
    rows["ssd"].update((f"{k}_launches", ssm_launches[k])
                       for k in K.SSD_TC_KEYS[1:])
    # the model-family paths' launches, each its own run
    for name, counts in family.items():
        rows["flash_fwd"][f"{name}_launches"] = counts["flash_fwd"]
        rows["flash_fwd"][f"{name}_tc_launches"] = counts["flash_fwd_tc"]
        rows["decode"][f"{name}_launches"] = counts["decode"]
        rows["decode"][f"{name}_combine_launches"] = \
            counts["decode_combine"]
    # the family training paths' launches, each its own run
    for name, counts in family_train.items():
        for row, keys in (("flash_fwd", ("flash_fwd", "flash_fwd_tc")),
                          ("flash_dkv", ("flash_dkv", "flash_dkv_tc",
                                         "flash_dkv_group_sum")),
                          ("flash_dq", ("flash_dq", "flash_dq_tc"))):
            for key in keys:
                rows[row][f"{name}_train_{key}_launches"] = counts[key]
    rows["ssd"]["hybrid_launches"] = family["hybrid"]["ssd"]
    rows["ssd"].update((f"hybrid_{k}_launches", family["hybrid"][k])
                       for k in K.SSD_TC_KEYS[1:])
    # the predictor path: B4 once per tick of the trained policy (in
    # ``launches`` above); B1-B4 in its corpus and fig_predictor's runs
    for name in ("spatial", "temporal", "late", "reap"):
        rows[name]["predictor_corpus_launches"] = predict["corpus"][name]
        rows[name]["fig_predictor_launches"] = predict["fig"][name]
    rows["reap"].update(
        predictor_policy_launches=predict["policy"]["reap"],
        **{f"predictor_{k}": v for k, v in predict["reap_timing"].items()})
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
