#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON line each; any failure exits non-zero before the last
line is printed:

1. environment: torch and CUDA versions, the card, its power limit, TF32
   off, ``cudaOccupancyMaxActiveClusters`` of the simplex and PDHG
   cluster variants at each cluster size the main paths use, and the
   resident revised CTAs an SM at the slice-2 shapes;
2. build: the four CUDA sources compiled from the checkout, one ``nvcc``
   each, started together, with each kernel's registers, shared memory,
   spills;
3. each kernel against its plain PyTorch version on the card: the simplex
   and revised kernels must be bit-identical in every output and in the
   terminal state, the hyperbox kernel within rtol 1e-6 (float32) /
   1e-12 (float64) of the sum of |terms|, the PDHG kernel equal in status
   and steps at a short cap with its state within the tolerances of
   ``tests/test_torch_pdhg.py``, in agreement on every LP both decide at
   the full cap, and bit-identical to itself across reruns and resume
   chains (the PDHG cases run at the start of slice 3, so that they and
   the HiGHS workers do not weigh on the earlier rows); kernel and plain
   times.  The simplex and PDHG kernels have two variants each
   (``kernels/cluster.py``): every case names the one it took and checks
   it.  The cluster variant carries the main paths' shapes (k = 1 for
   type 1 and the list buckets, 2 for type 2 and a resumed chain, 10 for
   the crossover tile; 5 for the 500x500 PDHG batch, 2 at 200x200 in
   float64); type 1, type 2 and the crossover tile also run the global
   variant on the same LPs (the same bits, timed beside), the PDHG batch
   at cap 400 also runs the streaming variant and clusters of 8 and 16
   (a sweep), and at the auto cap the streaming variant (timed beside,
   statuses held to the cluster variant's), and the batch's slowest LP
   runs alone on both variants (its time a step).  One small case per
   second variant lies past the largest cluster: 4 LPs of 700x700 simplex
   at cap 300, 4 of 1000x1000 PDHG at cap 50.  The revised kernel's
   resident variant carries the slice-2 shapes; shared types 1 and 2 also
   run the global variant (the same bits, timed beside), 64 LPs of
   300x100 lie past the resident budget and take the global variant, and
   each reach sweep is one launch, timed alone.  The hyperbox cases give
   their GB/s, the reach rows' on one box (row stride 0);
4. the main paths, each read with the launch counts set to 0 just before
   it.  Slice 1, the dense and box path at the paper's sizes through
   ``repro_torch.solve``: type 1 (100x100, 50,000 LPs), type 2 (200x100
   infeasible start, 10,000 LPs), hyperbox 4,000,000 x 5 and
   6,000,000 x 28, and one heterogeneous list.  Slice 2, the shared-A
   path: the two paper classes as ``SharedLPBatch``es through
   ``repro_torch.solve``, and the paper's reachability runs (5-dim and
   helicopter, 200 steps) through ``reach_supports`` on the revised
   kernel's warm sweep (one launch a row).  Launch counts, statuses,
   pivots, memory, and samples held against the float64 oracle or the
   hyperbox path; then, with the counts read, each slice-2 row's call
   timed five more times.
   Slice 3, the first-order path: 256 LPs of 500x500 through
   ``backend="auto"`` (one PDHG launch, no simplex launch), the same
   batch with ``crossover=True``, and a list of 100x100 and 500x500 LPs
   through ``"auto"``; a 32-LP sample held against HiGHS in float64.
   After its counts are read, the same batch on the simplex kernel
   (``backend="cuda"``), for the routing frontier.
   Slice 6, the round scheduler (``core/dispatch.py``): types 1 and 2
   on ``cuda`` with ``compaction="every_k"`` + ``resume="basis"`` and
   ``"chunked"`` + ``"scratch"``, shared type 1 on ``cuda-shared`` and
   64 LPs of the slice-3 batch on ``pdhg`` (cap 400) with ``every_k`` +
   ``basis``, each beside ``compaction="off"`` on the same LPs in the same
   call: bit-equal to it, every round one launch of the main variant,
   with the survivors of each round, the lockstep work, the wall times
   and the peak memory; type 1 with the guardrails on and off
   (bit-equal, timed), a NaN written into one carried row of a
   basis-resume state (it retires NUMERICAL, the other rows stay
   bit-equal, the quarantine resolves it on the oracle); three
   ``SolveSession`` calls at the type-1 shape (``compiles`` stops moving);
   and the two reach models' X0 supports as the dense warm sweep,
   ``sweep_problems`` against the per-step loop (the same supports and
   pivots, both timed).
   Slice 7, the serve loop (``serve/engine.py:LPEngine``): first the
   PDHG and hyperbox kernels against their plain versions at the shapes
   the loop launches them (64 LPs of the slice-3 batch padded to their
   512x512 class, at cap 400; the box requests padded to n = 32); 4,096
   requests of ``lp_request_mix([(28, 28), (100, 100)], seed=11)`` and
   64 boxlike requests of n = 28, answered first by one
   ``repro_torch.solve`` of the list; the continuous mode's throughput
   with the whole trace at t = 0 (the calibration R); then, counted, the
   continuous mode (``max_inflight=1024``, ``step_iters=64``) and the
   flush mode (``flush_every=512``) replayed open-loop on one Poisson
   trace at 0.5 R (``serve/loadgen.py``, seed 17) after a warm-up, and 64
   LPs of the slice-3 batch served on ``"auto"`` at cap 400 (four rounds
   of 100, admitted 16 a round, on the variant and ``k`` of the kernel
   case at its class): every request bit-identical to the one-shot solve, p50/p99 latency, throughput, splices, no compile
   after the warm-up.  After the counts were read: the fault cases
   (``runtime/chaos.py``: a failed round and a shard crash retried from
   the carried state, a poisoned row and a dead-lettered group in the
   serve loop, a shared-A retry; each bit-equal where it must be) and
   type 1 in chunks of 6,250 with ``speculation`` on and off (bit-equal,
   timed).  A dispatch round that raises outside the fault cases fails
   the run: no clean phase leans on recovery.  The slice-3 row
   ``pdhg_auto`` also confirms its flags sequentially, once, beside the
   confirmation on host threads (``confirmation``).

   Slice 8: after the rounds phase, with their counts read, ``a_lo``
   times ``canonicalize`` at types 1 and 2 and its row-local ``A lo``
   product (``row_sum`` in blocks of 4,096 rows) beside a batched
   ``einsum``, with the device memory each adds; then the cost-model
   autotuner (``runtime/autotune.py``), after the serve phase: ``autotune_predict`` (the predicted ranking of each
   main-path class, 5x5 to 500x500 and the shared classes, with each
   candidate's seconds, the choice held to the static table; type 1's
   first 5,000 LPs under the default options and under
   ``autotune="off"``: status, pivots and objective bit-equal, one
   autotuned decision), ``autotune_trial`` (``autotune.warm`` with a cache
   file in a temporary directory over 5x5 and 28x28 at 4,096, type 1's and
   type 2's classes and the 5,000-LP class: each candidate's measured and
   predicted seconds on its trial batch, the winner, ``trials_run``; a warm
   process on the same file runs 0 trials; a ``"trial"`` solve of the
   5,000 LPs takes the cached winner, bit-equal to ``"off"``), and, after
   the batches are freed, ``roofline``: the model's H100 constants beside
   ``nvidia-smi``'s name and power limit and a measured device-to-device
   copy of 4 GB.

   Slice 9, the LM serve path, after ``roofline``: gemma2-2b at full
   width, weights from ``models/convert.py:reference_weights`` (checked
   against the fixture's digest) copied to the card, TF32 off.
   ``lm_reference`` (float32): prefill of the fixture's 2 prompts of 40
   tokens, then 8 decode steps fed its tokens, against the JAX
   reference's logits in ``tests/data/lm_gemma2_2b_reference.npz``
   (``tools/lm_reference_fixture.py``): on its 2,048-id vocabulary
   subset at every step, max abs and relative L2 each within the larger
   of 5e-4 / 1e-3 and 4x the function's own float32 noise (the
   fixture's logits with every weight one ulp away), the logsumexp
   within the same abs bound, the argmax equal wherever its top-2
   margin exceeds 2e-3.  ``lm_window`` (float32): 2 prompts of 4,160 tokens,
   past the 4,096 window, then 32 decode steps, each within 1e-3 of the
   full forward at its position; the forward with every layer global
   equal to it below the window and different from it on.  ``lm_serve``
   (bfloat16, the config's dtype): ``Engine.generate`` with no device
   argument on 8 prompts of 4,096 tokens, 128 greedy steps: prefill ms
   and decode ms a step (CUDA events) beside their bounds, peak memory,
   every logit finite, no kernel of the port launched, and the fixture's
   prompts in bfloat16 within 1.5x the reference's own bfloat16 error of
   the fixture.

   Slice 10, MoE with the LP router and MLA, after the LM phase:
   deepseek-v2-lite-16b at full width.  ``lm_moe_reference``: the
   fixture's depth (3 layers: ``mla_dense``, then two ``mla_moe``),
   weights from ``reference_weights`` checked against the digest of
   ``tests/data/lm_deepseek_v2_lite_reference.npz``, under
   ``router="topk"`` and ``"lp"``: the float32 logits against the
   fixture with ``lm_reference``'s row gates (TF32 must fail them); under
   ``lp`` the fixture's 18 router LPs (72 x 512, one a MoE layer a call)
   through the simplex kernel with the reference's status, pivots and
   basis and x within 1e-6, and each LP the port built from its own
   affinities with the reference's basis (a differing one passes only
   where the reduced costs that decided the first differing pivot lie
   within the affinities' float32 rounding); bfloat16 within 1.5x the
   reference's bfloat16 gap.  ``lm_moe_serve``: full depth (27 layers) in
   bfloat16, ``Model.init`` on the card, ``Engine.generate`` on 8 prompts
   of 4,096 tokens and 128 greedy steps, first under ``topk``, then under
   ``lp``, on one loaded model, with the launch counts set to 0 before and
   read after: prefill and decode ms beside their bounds, peak memory,
   the dropped share and the heaviest expert's load over the mean, 0
   simplex launches under ``topk`` and 26 x 128 under ``lp``, all of the
   cluster variant, and the router LPs of the prefill and the first two
   decode steps re-run through ``simplex_plain``, bit-identical.  Then
   ``lm_router_lp``: the prefill's first router LP on the kernel against
   its plain version (``simplex_case``), its ms, pivots, bound, and its
   share of a decode step.

   Slice 11, the SSM, hybrid, encoder-decoder and M-RoPE families, after
   the MoE phases, with the launch counts set to 0 before and read after
   (no kernel of the port lies on them: the reference computes the SSD
   scan, the causal convolution and every attention outside Pallas).
   Each ``<row>_reference`` (``lm_ssm``: mamba2-130m, 24 layers, 2
   prompts of 100 tokens, two chunks of 64 with padding; ``lm_hybrid``:
   zamba2-7b cut to 7 layers, shared sites before layers 0 and 6, 100
   tokens; ``lm_encdec``: seamless-m4t-large-v2 cut to 1 + 1 layers
   (deeper, the reference's own float32 function is chaotic on these
   weights), 40 frames and 40 tokens; ``lm_vlm``: qwen2-vl-72b cut to 2
   layers, 256 patch embeddings and 64 text tokens at M-RoPE positions
   on a 16 x 16 grid; each 8 decode steps): weights from
   ``reference_weights`` checked against the fixture's digest, the
   float32 logits against ``tests/data/lm_<arch>_reference.npz`` with
   ``lm_reference``'s row gates, each at least twice the reference's own
   largest float32 error against its float64 logits (``case_f64``; TF32
   must fail them), bfloat16 within 1.5x the reference's gap.
   ``lm_ssm_serve``, ``lm_hybrid_serve`` (all 81 layers, 14 shared
   sites) and ``lm_encdec_serve`` (24 + 24 layers, 8 x 4,096 frames and
   tokens; before it, float32 decode against the port's own forward at
   2 x 4,096 on the fixture's depth, ``lm_encdec_decode_vs_forward``),
   ``Model.init`` on the card but mamba2's (the fixture's weights), in bfloat16
   ``Engine.generate`` of 8 prompts of 4,096 tokens and 128 greedy
   steps, prefill and decode ms beside their bounds (bf16 work at the
   bf16 peak, the float32 SSD scans at the float32 peak; a decode step's
   weights and the cache bytes it moves: attended K/V, cross K/V, conv
   windows and SSM states read and written), peak memory and the cache's
   bytes.  ``lm_ssm_long``: one prompt of 524,288 tokens; in float32 a
   prefill of s - 1 tokens and one decode step against a prefill of s
   (relative L2 and max abs within 1e-3), which a state zeroed at the
   handoff must fail; one layer's inter-chunk loop timed alone (8,192
   launches); then bfloat16 ``Engine.generate`` of 32 steps, prefill and
   decode ms beside their bounds, the cache's bytes equal to a
   4,096-token prompt's.  qwen2-vl-72b's 2-layer bfloat16 model goes on
   to slice 16 (143 GB whole in bfloat16).

   Slice 16, the catalog's last five configurations, after slice 11, with
   the launch counts set to 0 before and read after
   (``lm_catalog_phase``): ``Engine.generate`` with no device argument,
   bfloat16, 8 prompts of 4,096 tokens after a 4-step warm-up on 128,
   then 32 greedy steps, on qwen2-vl-72b (slice 11's 2 layers; 256 patch
   embeddings and M-RoPE positions), qwen1.5-4b (all 40 layers: MHA with
   QKV bias), internlm2-20b (all 48), dbrx-132b (4 of 40 layers, under
   ``topk`` and ``lp`` on one loaded model: every router LP, 24 x 128, on
   the simplex kernel, each replayed bit-identical on
   ``simplex_plain``; dropped share and load) and command-r-plus-104b (8
   of 64; its 3.1 G-element embedding's rows past element 2**31 against
   plain slicing), each made by ``Model.init`` on the card and freed
   before the next: prefill and decode ms beside their bounds, peak
   memory, cache bytes, finite logits and in-vocabulary tokens; every
   count 0 but the simplex kernel's under dbrx's ``lp``.  Then dbrx's
   router LP on the kernel against its plain version
   (``lm_dbrx_serve_router_lp``).  The catalog's float32 reference
   fixtures are the ``gpu`` tier's (``tests/test_torch_gpu.py -k
   catalog``).

   Slice 12, training, after slice 16, with the launch counts set to 0
   before and read after.  ``lm_train_reference``: gemma2-2b at full
   width cut to 2 layers, float32, three train steps (``accum=2``, 4 x
   128 tokens of ``SyntheticLM``, lr 1e-3 after 2 warm-up steps) against
   ``tests/data/lm_train_gemma2_2b_reference.npz``
   (``tools/lm_reference_fixture.py --train``): each step's loss and
   ``grad_norm``, and each leaf's parameter change at 8,192 sampled
   elements, against the reference's float32 run and its float64 run,
   each within the largest of a floor, 4x the reference's one-ulp noise
   and 2x its own float32 error against that float64 run, lr equal; the
   same run with TF32 products must fail the gates.
   ``lm_train``: gemma2-2b at full width and depth, bfloat16 with float32
   master weights, remat, 2 microbatches of 2 x 4,096 tokens, through
   ``TrainDriver`` with checkpointing off: one warm-up and four timed
   steps (CUDA events), tokens/s, each step's loss (finite) and
   ``grad_norm``, peak memory, the step's bound.  ``lm_train_ssm``:
   mamba2-130m at full width and depth, bfloat16, 8 x 4,096 tokens a
   step: an uninterrupted run of 5 steps, then one checkpointed every 2
   steps, preempted at step 3 and resumed from step 2 by a new model and
   driver, bit-equal to the uninterrupted run (deterministic algorithms
   on); step ms, the checkpoints' bytes and write ms.  ``lm_eval_lp``:
   deepseek-v2-lite-16b cut to 3 layers, float32, ``make_eval_step``
   under ``router="lp"``: the loss against
   ``tests/data/lm_eval_deepseek_v2_lite_reference.npz``, one simplex
   launch a MoE layer (2), all of the cluster variant, each captured LP
   bit-identical on ``simplex_plain``.  A ``main_path_summary`` for
   ``slice12_train``: every count 0 but the simplex kernel's.

   Slice 13, the LP system over a device mesh, after slice 12
   (``mesh_phase``; ``slice13_mesh`` lines).  (a) NCCL with one rank on
   the card, a (1, 1) mesh: type 1's 50,000 LPs through
   ``solve(problem, mesh=mesh)``, bit-identical to slice 1's result, one
   simplex launch of the cluster variant.  (b) MESH_RANKS gloo ranks
   sharing the card, spawned from here, each with the same inputs on the
   host, on meshes (data=4) and (data=2, model=2): type 1; type 2's
   first 9,999 LPs (padded to the blocks and trimmed); type 1 as an
   ``LPBatch`` with ``every_k`` + ``basis`` (held to slice 6's
   ``compaction="off"``); shared type 1 on the revised kernel; hyperbox
   4,000,000 x 5; ``LPEngine(mesh=...)`` in flush and continuous mode on
   the serve mix (the box requests first, one admission wave; 512 LPs a
   step); ``dp_allreduce_int8`` of a (4, 2^20) float32 gradient against
   the plain computation.  Every gathered result must be bit-identical,
   by a SHA-256 of its bits, to the one-process result of the same rows;
   every rank reports its launches (each kernel of the row on its own
   rows, all of the main variant), wall time and peak memory; a rank's
   type-1 peak must lie below the unsplit run's.  These rows are "4 ranks
   sharing one card": they say nothing about scaling.

   Slice 14, the LM serve path over a device mesh, after slice 13
   (``lm_mesh_phase``; ``lm_mesh`` and ``lm_mesh_reference`` lines).  (a)
   NCCL with one rank on the card, a (1, 1) mesh: deepseek-v2-lite-16b
   (27 layers, ``router="lp"``) and gemma2-2b at full width and depth in
   bfloat16, ``Engine.generate`` of 8 x 1,024 tokens and 40 steps without
   a mesh and then under ``partition.activate(mesh)`` (the mesh code
   path, every group of one rank): tokens and every call's logits
   bit-identical, prefill ms, decode ms (median, p10, p90), peak
   memory, every router LP on the simplex kernel's cluster variant.
   (b) LM_MESH_RANKS gloo ranks sharing the card on a (data, model) =
   (2, 2) mesh
   (``lm_mesh_rank_main``), deepseek cut to 3 layers (``lp``) and
   gemma2-2b cut to 2 (one local, one global layer; 4 before the SSM
   cases joined), 4 prompts of 64 tokens (two token groups that
   drop tokens) and 3 steps, held against this process's run under the
   abstract mesh ``{"data": 2, "model": 2}``: greedy tokens equal, rows
   that two ranks run the same bits, the router LPs the same bits on
   every rank and ``router_lp_checks``-equal to the one-process LPs,
   each rank's stored parameter and cache bytes equal to its
   placements' and its peak below one process's; then each case in
   bfloat16 on the float32 run's tokens, on the ranks and in one
   process, the ranks' logits within ``LM_BF16_FACTOR`` times the
   one-process bfloat16 run's relative L2 from the float32 run's; each
   rank's residual stream in that run (``stream_rows``: its rows and
   block of the prompt's positions at every block boundary of the
   prefill, every position of a decode step) is its block of the
   reference's ``("batch", "seq_tp", None)`` (``lm_stream_block``).  The
   group also serves mamba2-130m (cut to 8 layers) and zamba2-7b (2 mamba
   layers and its shared site) at full width through the head-split
   mixer (``models/mamba2.py:mamba_mixer``), held the same way and
   their float32 logits within ``LM_ABS_TOL`` / ``LM_REL_TOL`` of one
   process's; each rank reports the heads of its scans and decode steps
   (the model axis's share: 12 and 56) and one decode step's model-axis
   all-gather bytes beside the mixer's before the split, reckoned from
   the shapes (``tools/mixer_spy.py:lm_mesh_mixer_step``), and gathers no whole
   ``in_proj``, ``out_proj`` or state cache.  Then
   the float32 3-layer deepseek on the fixture
   ``tests/data/lm_deepseek_v2_lite_mesh_reference.npz`` (the reference
   under an Auto-typed (2, 2) mesh), on the ranks and in one process,
   within ``lm_tolerances``' gates, its router LPs against the
   fixture's.  These rows are "4 ranks sharing one card" too.  The
   deepseek reference weights of slices 10, 12, 14 and 15 are one tree
   (the same depth and seed): a helper process started before slice 9
   draws it once, then slice 15's gemma2-2b tree, and saves them, slice
   9 waits for it before its timed rows (``wait_shared_tree``), and each
   phase memory-maps them (``start_shared_tree``, ``reference_tree``).

   Slice 15, training over a device mesh, after slice 14
   (``lm_train_mesh_phase``; ``lm_train_mesh``,
   ``lm_train_mesh_checkpoint``, ``lm_train_mesh_eval_lp`` lines).  (a)
   NCCL with one rank, a (1, 1) mesh: gemma2-2b at full width and depth
   in bfloat16 with float32 master weights, 2 steps of 4 x 4,096 tokens
   (``accum=2``) without a mesh and then on the mesh, one model on the
   card at a time, deterministic algorithms on: the parameters and the
   optimizer state the same bits after each step (device digests); step
   ms and peak.  (b) 4 gloo ranks sharing the card on (2, 2), float32
   (``lm_train_mesh_rank_main``): gemma2-2b cut to 4 layers on the mesh
   training fixture ``tests/data/lm_train_gemma2_2b_mesh_reference.npz``
   (the reference's sharded step, 3 steps of 4 x 128, ``accum=2``), held
   to the fixture's gates and to this process's run under the abstract
   mesh; mamba2-130m cut to 1 layer (its 24 heads split over the model
   axis, 12 a scan), preempted at step 3 and resumed bit-equal, its
   step-2 checkpoint restored bit-equal onto (4, 1) and onto one process;
   deepseek's eval step under ``lp`` (3 layers): every rank's router LPs
   on its simplex kernel, the same bits on all ranks, each replayed
   bit-identical on ``simplex_plain``.  Each rank's step ms, peak and
   stored bytes beside the placements' share.  deepseek's training on the
   ranks (3 layers, ``topk``, the fixture's steps, held step by step to a
   float64 witness, ``lm_train_mesh_moe_case``) is the ``gpu`` test
   tier's: at ≈ 40 s a step it does not fit the script's time.

The launch counts of each path are also read per variant: every simplex
and PDHG launch of the main paths must take the cluster variant, every
revised launch the resident variant.  The ``kernels`` line counts the
launches of every path (slice 12's eval step among them), and each entry's ``serve_path_launches`` those
of slice 7.

Then a ``{"kernels": [...]}`` line (the simplex, revised and PDHG
entries list their variants with their case names; the simplex entry's
``lm_router`` holds deepseek's router case and ``lm_catalog_router``
dbrx's; ``launches`` counts slice 13's and slices 14 and 15's ranks too, ``mesh_path_launches`` gives slice 13's per
rank and the simplex entry's ``lm_mesh_router`` and ``lm_train_mesh_router``
slices 14 and 15's), the ``nvidia-smi``
name and power limit, and as the last line ``{"ok": true, "device": {...}}``.  The
script imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: Problems per shape class in the heterogeneous list.
HETERO_PER_CLASS = 64

#: H100 SXM data sheet: memory rate, and peak rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

#: The slice-3 batch: LPs of m = n = PDHG_DIM, the routing frontier.
PDHG_LPS = 256
PDHG_DIM = 500
#: LPs of that batch held against HiGHS.
HIGHS_SAMPLE = 32
#: The PDHG kernel against its plain version: the tolerances of
#: tests/test_torch_pdhg.py (x and y absolute; the other state arrays
#: relative to their largest magnitude).
PDHG_XTOL = {torch.float32: 1e-4, torch.float64: 1e-9}
PDHG_STATE_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}
PDHG_FIELDS = ("x", "y", "ax", "x_sum", "y_sum", "ax_sum", "inner", "x_grow", "y_grow")
#: The serve phase's traffic: SERVE_REQUESTS single-LP requests of the
#: request mix, and SERVE_BOXES boxlike requests of n = SERVE_BOX_N.
SERVE_REQUESTS = 4096
SERVE_BOXES = 64
SERVE_BOX_N = 28

# Slice 13, the LP system over a mesh: ranks that share the one card,
# type 2's first MESH_ODD_LPS LPs (an odd batch, padded and trimmed), the
# (4, 2**20) gradient of the int8 all-reduce, the group's time limit.
MESH_RANKS = 4
MESH_SIZES = dict(type1=50_000, type2=10_000, shared=50_000, box=4_000_000)
MESH_ODD_LPS = 9999
MESH_GRAD = (4, 1 << 20)
MESH_TIMEOUT_S = 600
MESH_SOURCES = ("type1_feasible_100x100", "type2_infeasible_start_200x100",
                "hyperbox_4000000x5")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


class Timer:
    """Milliseconds of device work: CUDA events on the card, else the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn, reps: int = 1, setup=None) -> float:
        times = []
        for _ in range(reps):
            args = setup() if setup is not None else ()
            self.sync()
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()]) if t.is_floating_point() else t


def sol_digest(sol, rows=None) -> str:
    """SHA-256 of a solution's bits (objective, x, status, iterations, basis), or
    of rows ``rows`` only: how the mesh phase holds a gathered result to the
    one-process result of the same rows."""
    import hashlib

    h = hashlib.sha256()
    for f in ("objective", "x", "status", "iterations", "basis"):
        t = getattr(sol, f, None)
        if t is not None:
            h.update(bits(t if rows is None else t[rows]).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def requests_digest(sols) -> str:
    """SHA-256 over the per-request solutions of a serve run, in request order."""
    import hashlib

    return hashlib.sha256("".join(sol_digest(s) for s in sols).encode()).hexdigest()


#: One-process digests of the main paths' results, by row: what the mesh
#: phase (slice 13) holds its gathered results to.
MESH_REFS: dict = {}


def launch_counts(counters) -> dict:
    """Each wrapper's launch count, and per variant where it has two
    (``"simplex.cluster"``, ``"simplex.global"``, ...)."""
    out = {}
    for name, mod in counters.items():
        out[name] = mod.launches
        for variant, n in getattr(mod, "variant_launches", {}).items():
            out[f"{name}.{variant}"] = n
    return out


def count_delta(counters, before) -> dict:
    return {k: v - before[k] for k, v in launch_counts(counters).items()}


#: Case names by kernel variant, for the ``{"kernels": [...]}`` line.
CASES: dict = {}


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if not a.is_floating_point() or a.numel() == 0:
        return 0.0
    same = (a == b) | (a.isnan() & b.isnan())
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max())


def cluster_occupancy(dev) -> dict:
    """``cudaOccupancyMaxActiveClusters`` of the cluster variants at each
    cluster size the main paths use (and the PDHG sweep's 8 and 16), and
    the resident revised CTAs an SM at the slice-2 shapes, with the
    kernels' own shared-memory arithmetic held against the planner's."""
    import ctypes

    from repro_torch.core.tableau import TableauSpec
    from repro_torch.kernels import build, cluster, pdhg_cuda, revised_cuda, simplex_cuda

    f32 = torch.float32
    out = dict(simplex_device_max_k=simplex_cuda.device_max_k(f32, dev),
               pdhg_device_max_k=pdhg_cuda.device_max_k(f32, dev), shapes=[])
    plans = [("simplex", row, m, TableauSpec(m, n).q, simplex_cuda.plan(TableauSpec(m, n), f32, dev))
             for row, m, n in [("type1", 100, 100), ("type2", 200, 100),
                               ("crossover_tile", PDHG_DIM, PDHG_DIM)]]
    plans += [("pdhg", f"slice3_k{k or 'least'}", PDHG_DIM, PDHG_DIM,
               pdhg_cuda.plan(PDHG_DIM, PDHG_DIM, f32, dev, k)) for k in (None, 8, 16)]
    for kernel, row, m, w, how in plans:
        lib = build.load(kernel)
        smem_fn = getattr(lib, f"{kernel}_cluster_smem")
        smem_fn.restype = ctypes.c_longlong
        smem_fn.argtypes = [ctypes.c_int] * 4
        check(how.variant == "cluster" and smem_fn(m, w, how.k, 4) == how.smem,
              f"{kernel} {row}: plan {how} against the kernel's {smem_fn(m, w, how.k, 4)} bytes")
        out["shapes"].append(dict(
            kernel=kernel, row=row, m=m, width=w, k=how.k, smem_bytes=how.smem,
            max_active_clusters=cluster.active_clusters(lib, f"{kernel}_cluster_occupancy", 4,
                                                        how.k, how.smem)))
    # The revised kernel's resident variant at the slice-2 shapes: shared
    # types 1 and 2, and the reach rows' canonical polytopes.
    lib = build.load("revised")
    smem_fn, occ_fn = lib.revised_resident_smem, lib.revised_resident_occupancy
    smem_fn.restype, smem_fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
    occ_fn.restype, occ_fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_longlong]
    for row, m, n in [("shared_type1", 100, 100), ("shared_type2", 200, 100),
                      ("reach_five_dim", 10, 10), ("reach_helicopter", 56, 56)]:
        how = cluster.plan_revised(m, n, f32)
        check(how.variant == "resident" and smem_fn(m, n, 4) == how.smem,
              f"revised {row}: plan {how} against the kernel's {smem_fn(m, n, 4)} bytes")
        blocks = occ_fn(4, how.smem)
        check(blocks >= 1, f"revised {row}: occupancy query gave {blocks}")
        out["shapes"].append(dict(kernel="revised", row=row, m=m, width=n, k=1,
                                  smem_bytes=how.smem, ctas_per_sm=blocks))
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def simplex_case(timer, *, name, batch, rule="lpc", seed=0, layout="compact", chain=None,
                 basis0=None, reps=3, cap=None, k=None, want=None, beside_global=False):
    """One simplex case: the kernel against its plain version, then timed.

    ``batch`` is a canonical ``LPBatch`` on the card: the main path's own
    LPs where the case stands for a main-path launch.  ``basis0`` warm
    starts the tableau, as crossover does.  ``k`` forces the variant (as
    the wrapper's ``_k``), ``want`` is the variant the case must take, and
    ``beside_global`` also runs the global variant on the same inputs,
    held to the same bits and timed in the same call (``global_ms``).
    """
    from repro_torch.core import engine
    from repro_torch.core.simplex import phase2_costs, resolve_cap
    from repro_torch.core.tableau import TableauSpec, build_tableau
    from repro_torch.kernels import ops, simplex_cuda

    bsz, m, n = batch.a.shape
    spec = TableauSpec(m, n, layout)
    tab, basis, phase = (t.contiguous() for t in
                         build_tableau(batch.a, batch.b, batch.c, basis0, spec))
    c_ext = phase2_costs(batch.c, spec)
    feas = engine.phase1_feasibility_tol(batch.b).contiguous()
    tol = engine.default_tolerance(tab.dtype)
    if cap is None:
        cap = resolve_cap(0, m, n) if chain is None else sum(chain)

    def fresh():
        return tab.clone(), basis.clone(), phase.clone()

    kw = dict(spec=spec, rule=rule, seed=seed, tol=tol)
    how = simplex_cuda.plan(spec, tab.dtype, tab.device, k)
    k_state = fresh()
    before = dict(simplex_cuda.variant_launches)
    k_out = simplex_cuda.simplex(*k_state, c_ext, feas, cap, _k=k, **kw)
    timer.sync()
    check(simplex_cuda.variant_launches[how.variant] == before[how.variant] + 1,
          f"simplex case {name} did not launch the {how.variant} variant")
    check(want is None or how.variant == want,
          f"simplex case {name} took the {how.variant} variant, not {want}")
    p_state = fresh()
    t0 = time.perf_counter()
    p_out = simplex_cuda.simplex_plain(*p_state, c_ext, feas, cap, **kw)
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pairs = list(zip(k_out + k_state, p_out + p_state))
    if chain is not None:
        # The same LPs as a resumed chain of kernel launches, caps K1 + K2.
        part, state = ops.simplex_solve(batch.a, batch.b, batch.c, rule=rule, seed=seed,
                                        max_iters=chain[0], want_state=True, layout=layout)
        rest, state = ops.simplex_resume(batch.b, batch.c, state, rule=rule, seed=seed,
                                         max_iters=chain[1])
        pairs += [(rest.objective, k_out[0]), (rest.x, k_out[1]), (rest.status, k_out[2]),
                  (part.iterations + rest.iterations, k_out[3]), (state.tab, k_state[0]),
                  (state.basis, k_state[1]), (state.phase, k_state[2])]
    beside = {}
    if beside_global:
        g_state = fresh()
        g_out = simplex_cuda.simplex(*g_state, c_ext, feas, cap, _k=0, **kw)
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(g_out + g_state, k_out + k_state))
        check(same, f"simplex case {name}: the global variant differs from the cluster variant")
        del g_state, g_out
        beside = dict(global_bit_identical=same, global_ms=timer(
            lambda t, b_, p: simplex_cuda.simplex(t, b_, p, c_ext, feas, cap, _k=0, **kw),
            setup=fresh))
        CASES.setdefault("simplex.global", []).append(name)
    identical = all(torch.equal(bits(a), bits(b)) for a, b in pairs)
    err = max(max_abs_diff(a, b) for a, b in pairs)
    ms = timer(lambda t, b_, p: simplex_cuda.simplex(t, b_, p, c_ext, feas, cap, _k=k, **kw),
               reps=reps, setup=fresh)
    CASES.setdefault(f"simplex.{how.variant}", []).append(name)
    iters = k_out[3].to(torch.int64)
    status = k_out[2]
    q = spec.q
    item = tab.element_size()
    # Work this run's data needs: every pivot sweeps the (m+1) x q tableau
    # (a multiply and a subtract per entry) and divides the pivot row and
    # the ratio column; each phase-I LP prices m rows once.
    pivots = int(iters.sum())
    phase1 = int((phase == 1).sum())
    flops = pivots * (2 * (m + 1) * q + q + m) + phase1 * 2 * m * q
    nbytes = (2 * tab.numel() * item + 2 * basis.numel() * 4 + 2 * phase.numel() * 4
              + c_ext.numel() * item + feas.numel() * item
              + bsz * item + bsz * n * item + 2 * bsz * 4)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tab.dtype]
    row = dict(case=name, batch=bsz, m=m, n=n, dtype=str(tab.dtype), rule=rule, layout=layout,
               variant=how.variant, k=how.k, smem_bytes=how.smem, cap=cap,
               chain=chain, warm=basis0 is not None, bit_identical=identical, max_abs_err=err,
               kernel_ms=ms, **beside, plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes",
               pivots=pivots, max_pivots=int(iters.max()),
               status_counts=np.bincount(status.cpu().numpy(), minlength=6).tolist())
    emit("kernel_vs_plain", kernel="simplex", **row)
    check(identical, f"simplex kernel differs from its plain version in case {name}")
    return row


def hyperbox_case(dev, timer, *, name, bsz, n, dtype, data_seed, reps=20, box=False,
                  data=None):
    """The hyperbox kernel against its plain version; ``box`` reads one box
    (row 0 of the data) for every direction, with row stride 0, as the
    reach rows do.  ``data`` gives ``(lo, hi, d)`` on the card instead of
    random boxes (a main path's own inputs)."""
    from repro_torch.kernels import hyperbox_cuda

    if data is None:
        lo, hi, d = chunked_hyperbox(np.random.default_rng(data_seed), bsz, n, dtype, dev)
    else:
        lo, hi, d = data
    if box:
        lo, hi = lo[0].contiguous(), hi[0].contiguous()
    k = hyperbox_cuda.hyperbox(lo, hi, d)
    p = hyperbox_cuda.hyperbox_plain(lo, hi, d)
    timer.sync()
    scale = (d * torch.where(d < 0, lo, hi)).abs().sum(dim=-1)
    rtol = 1e-6 if d.dtype == torch.float32 else 1e-12
    err = (k - p).abs()
    ok = bool((err <= rtol * scale).all())
    ms = timer(lambda: hyperbox_cuda.hyperbox(lo, hi, d), reps=reps)
    plain_ms = timer(lambda: hyperbox_cuda.hyperbox_plain(lo, hi, d), reps=max(1, reps // 4))
    item = d.element_size()
    nbytes = (d.numel() + lo.numel() + hi.numel() + bsz) * item
    flops = 2 * bsz * n
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[d.dtype]
    row = dict(case=name, batch=bsz, n=n, dtype=str(d.dtype), box=box, within_tolerance=ok,
               rtol=rtol, max_abs_err=float(err.max()),
               max_rel_err_of_abs_sum=float((err / scale).max()),
               kernel_ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes",
               gb_per_s=nbytes / (ms * 1e-3) / 1e9)
    emit("kernel_vs_plain", kernel="hyperbox", **row)
    check(ok, f"hyperbox kernel outside tolerance in case {name}")
    return row


def revised_work(m, n, pivots, pricing_steps):
    """Flops the revised simplex needs: every step prices (y, w.A, the
    phase-I value), every pivot adds u, the ratio divides and the rank-1
    update of binv and xb."""
    return pricing_steps * (2 * m * m + 2 * m * n + 2 * m) + pivots * (4 * m * m + 4 * m)


def revised_case(timer, *, name, sb, rule="lpc", seed=0, chain=None, basis0=None, reps=3,
                 variant=None, want=None, beside_global=False):
    """One revised case: the kernel against its plain version, then timed.

    ``sb`` is a ``SharedLPBatch`` on the card, the main path's own LPs
    where the case stands for a main-path launch.  ``variant`` forces the
    variant (as the wrapper's ``_variant``), ``want`` is the variant the
    case must take, and ``beside_global`` also runs the global variant on
    the same inputs, held to the same bits and timed in the same call
    (``global_ms``).
    """
    from repro_torch.core import engine, revised
    from repro_torch.core.simplex import resolve_cap
    from repro_torch.kernels import cluster, ops, revised_cuda

    a, b, c = sb.a, sb.b, sb.c
    bsz, m, n = sb.batch, sb.m, sb.n
    state = revised.init_traced(a, b, basis0)
    feas = engine.phase1_feasibility_tol(b).contiguous()
    tol = engine.default_tolerance(a.dtype)
    cap = resolve_cap(0, m, n) if chain is None else sum(chain)

    def fresh():
        return [t.clone() for t in (state.binv, state.basis, state.xb, state.phase)]

    kw = dict(rule=rule, seed=seed, tol=tol)
    how = cluster.plan_revised(m, n, a.dtype, variant)
    k_state = fresh()
    before = dict(revised_cuda.variant_launches)
    k_out = list(revised_cuda.revised(a, b, c, *k_state, feas, cap, _variant=variant, **kw))
    timer.sync()
    check(revised_cuda.variant_launches[how.variant] == before[how.variant] + 1,
          f"revised case {name} did not launch the {how.variant} variant")
    check(want is None or how.variant == want,
          f"revised case {name} took the {how.variant} variant, not {want}")
    p_state = fresh()
    t0 = time.perf_counter()
    p_out = list(revised_cuda.revised_plain(a, b, c, *p_state, feas, cap, **kw))
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pairs = list(zip(k_out + k_state, p_out + p_state))
    if chain is not None:
        # The same LPs as a resumed chain of kernel launches, caps K1 + K2.
        part, st = ops.revised_solve(a, b, c, rule=rule, seed=seed, max_iters=chain[0],
                                     want_state=True)
        rest, st = ops.revised_resume(a, b, c, st, rule=rule, seed=seed, max_iters=chain[1])
        pairs += [(rest.objective, k_out[0]), (rest.x, k_out[1]), (rest.status, k_out[2]),
                  (part.iterations + rest.iterations, k_out[3]), (st.binv, k_state[0]),
                  (st.basis, k_state[1]), (st.xb, k_state[2]), (st.phase, k_state[3])]
    del p_state, p_out
    beside = {}
    if beside_global:
        g_state = fresh()
        g_out = list(revised_cuda.revised(a, b, c, *g_state, feas, cap, _variant="global", **kw))
        same = all(torch.equal(bits(x), bits(y)) for x, y in zip(g_out + g_state, k_out + k_state))
        check(same, f"revised case {name}: the global variant differs from the resident variant")
        del g_state, g_out
        beside = dict(global_bit_identical=same, global_ms=timer(
            lambda *st: revised_cuda.revised(a, b, c, *st, feas, cap, _variant="global", **kw),
            setup=fresh))
        CASES.setdefault("revised.global", []).append(name)
    identical = all(torch.equal(bits(x), bits(y)) for x, y in pairs)
    err = max(max_abs_diff(x, y) for x, y in pairs)
    ms = timer(lambda *st: revised_cuda.revised(a, b, c, *st, feas, cap, _variant=variant, **kw),
               reps=reps, setup=fresh)
    CASES.setdefault(f"revised.{how.variant}", []).append(name)
    iters = k_out[3].to(torch.int64)
    pivots = int(iters.sum())
    # Each LP prices once more than it pivots, and once more again when it
    # enters phase II.
    flops = revised_work(m, n, pivots, pivots + bsz + int((state.phase == 1).sum()))
    item = a.element_size()
    nbytes = ((m * n + bsz * (m + n + 2 * m * m + 2 * m + 1 + n + 1)) * item
              + bsz * (2 * m + 2 + 2) * 4)
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[a.dtype]
    row = dict(case=name, batch=bsz, m=m, n=n, dtype=str(a.dtype), rule=rule, chain=chain,
               warm=basis0 is not None, variant=how.variant, smem_bytes=how.smem,
               bit_identical=identical, max_abs_err=err, kernel_ms=ms, **beside,
               plain_ms=plain_ms, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes", pivots=pivots,
               max_pivots=int(iters.max()),
               status_counts=np.bincount(k_out[2].cpu().numpy(), minlength=6).tolist())
    emit("kernel_vs_plain", kernel="revised", **row)
    check(identical, f"revised kernel differs from its plain version in case {name}")
    return row


def sweep_case(timer, dev, *, name, model, kind, steps, reps=3):
    """The reach row's warm sweep: ``ops.revised_sweep`` (one kernel launch
    for the whole sweep) against the plain ``sweep_batched``, on the same
    inputs; timed as the kernel's launch alone (CUDA events)."""
    from repro_torch.core import engine, reach, revised, support
    from repro_torch.kernels import cluster, ops, revised_cuda

    dirs = support.template_directions(model.dim, kind)
    stack = reach.direction_stack(model, 0.02, steps, dirs).astype(np.float32)
    sb, c_stack = support.box_to_polytope(model.x0).shared_sweep_inputs(stack, device=dev)
    how = cluster.plan_revised(sb.m, sb.n, sb.a.dtype)
    before = dict(revised_cuda.variant_launches)
    k_out = ops.revised_sweep(sb.a, sb.b, c_stack)
    timer.sync()
    launched = {v: revised_cuda.variant_launches[v] - before[v] for v in before}
    check(sum(launched.values()) == 1 and launched["resident"] == 1,
          f"revised sweep {name} launched {launched}, not one resident launch")
    t0 = time.perf_counter()
    p_out = revised.sweep_batched(sb.a, sb.b, c_stack)
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    identical = all(torch.equal(bits(x), bits(y)) for x, y in zip(k_out, p_out))
    err = max(max_abs_diff(x, y) for x, y in zip(k_out, p_out))
    cap, tol = revised.resolve_cap_tol(sb.a, 0, 0.0)
    feas = engine.phase1_feasibility_tol(sb.b).contiguous()
    ms = timer(lambda: revised_cuda.revised_sweep(sb.a, sb.b, c_stack, feas, cap, tol=tol),
               reps=reps)
    CASES.setdefault("revised.resident", []).append(name)
    m, n, bsz = sb.m, sb.n, sb.batch
    pivots = int(k_out[3].to(torch.int64).sum())
    flops = revised_work(m, n, pivots, pivots + steps * bsz)
    item = sb.a.element_size()
    nbytes = (m * n + bsz * m + c_stack.numel() + bsz + steps * bsz * (1 + n)) * item \
        + steps * bsz * 2 * 4
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[sb.a.dtype]
    row = dict(case=name, steps=steps, batch=bsz, m=m, n=n, dtype=str(sb.a.dtype),
               variant=how.variant, smem_bytes=how.smem, launches_per_run=sum(launched.values()),
               bit_identical=identical, max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
               bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="operations" if ops_s > bytes_s else "bytes", pivots=pivots,
               status_counts=np.bincount(k_out[2].flatten().cpu().numpy(), minlength=6).tolist())
    emit("kernel_vs_plain", kernel="revised_sweep", **row)
    check(row["launches_per_run"] == 1, f"revised sweep {name} took more than one launch")
    check(identical, f"revised sweep differs from its plain version in case {name}")
    return row


def pdhg_work(bsz, m, n, item, dtype, steps):
    """The PDHG bound from this run's step counts.

    Returns ``(bound_s, bound_by, compute_s, stream_s)``: the compute
    floor (4 m n flops a step, A on chip), the streaming floor (A read
    twice a step from HBM), and the bound, the larger of the compute
    floor and the bytes the function must move once (A, b, c, the state
    in and out, status and steps).
    """
    compute_s = steps * 4 * m * n / PEAK_FLOPS[dtype]
    stream_s = steps * 2 * m * n * item / HBM_BYTES_PER_S
    nbytes = item * bsz * (m * n + m + n + 2 * (2 * n + 4 * m + 2) + 5) + 4 * bsz * 4
    once_s = nbytes / HBM_BYTES_PER_S
    return max(compute_s, once_s), ("operations" if compute_s > once_s else "bytes"), \
        compute_s, stream_s


def pdhg_case(timer, *, name, batch, cap, full, reps=1, eager=False, k=None, want=None):
    """The PDHG kernel against its plain version on the same LPs and step sizes.

    ``full=False`` (a short cap): statuses and steps equal per LP and the
    state within PDHG_XTOL / PDHG_STATE_RTOL.  ``full=True`` (the auto
    cap): statuses equal on every LP both decide, at most 1% of the LPs
    decided by one side only, objectives within 1e-3 relative where both
    are OPTIMAL.  Kernel ms is the compared launch's (CUDA events; the
    library is loaded before), or the median of ``reps`` more launches.
    ``eager`` also runs the plain loop without its CUDA graph: the same
    bits, and what the graph saves.  ``k`` forces the variant (as the
    wrapper's ``_k``); ``want`` is the variant the case must take.
    Returns ``(row, status, state, steps)`` of the kernel's launch.
    """
    from repro_torch.core import pdhg
    from repro_torch.kernels import build, pdhg_cuda

    a, b, c = batch.a, batch.b, batch.c
    bsz, m, n = a.shape
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    kw = dict(tol=pdhg.DEFAULT_PDHG_TOL, restart=pdhg.DEFAULT_RESTART)

    def fresh():
        return (pdhg.init_state(bsz, m, n, a.dtype, a.device),)

    def launch(state):
        return pdhg_cuda.pdhg(a, b, c, state, tau, sigma, scales, cap, _k=k, **kw)

    if a.is_cuda:
        build.load("pdhg")
    how = pdhg_cuda.plan(m, n, a.dtype, a.device, k)
    check(want is None or how.variant == want,
          f"pdhg case {name} took the {how.variant} variant, not {want}")
    k_state = fresh()[0]
    k_out = []
    before = dict(pdhg_cuda.variant_launches)
    ms = timer(lambda: k_out.append(launch(k_state)))
    check(pdhg_cuda.variant_launches[how.variant] == before[how.variant] + 1,
          f"pdhg case {name} did not launch the {how.variant} variant")
    CASES.setdefault(f"pdhg.{how.variant}", []).append(name)
    k_status, k_iters = k_out[0]
    p_state = fresh()[0]
    t0 = time.perf_counter()
    p_status, p_iters = pdhg_cuda.pdhg_plain(a, b, c, p_state, tau, sigma, scales, cap, **kw)
    timer.sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    graph_check = {}
    if eager:
        e_state = fresh()[0]
        t0 = time.perf_counter()
        e_status, e_iters, e_out = pdhg.iterate_with(a, b, c, e_state, cap, tau, sigma, scales,
                                                     graph=False, **kw)
        timer.sync()
        same = torch.equal(e_status, p_status) and torch.equal(e_iters, p_iters) and all(
            torch.equal(bits(getattr(e_out, f)), bits(getattr(p_state, f))) for f in PDHG_FIELDS)
        graph_check = dict(plain_eager_ms=(time.perf_counter() - t0) * 1e3,
                           graph_bit_identical_to_eager=same)
        check(same, f"pdhg plain loop: the CUDA graph differs from the eager loop in {name}")
    if reps > 1:
        ms = timer(launch, reps=reps, setup=fresh)
    diffs = {f: max_abs_diff(getattr(k_state, f), getattr(p_state, f)) for f in PDHG_FIELDS
             if f != "inner"}
    row = dict(case=name, batch=bsz, m=m, n=n, dtype=str(a.dtype), cap=cap, full_cap=full,
               variant=how.variant, k=how.k, smem_bytes=how.smem, kernel_ms=ms, plain_ms=plain_ms, **graph_check,
               max_abs_err=max(diffs["x"], diffs["y"]),
               state_max_abs_diff=diffs,
               kernel_steps=int(k_iters.to(torch.int64).sum()),
               plain_steps=int(p_iters.to(torch.int64).sum()),
               max_steps=int(k_iters.max()),
               status_counts=np.bincount(k_status.cpu().numpy(), minlength=6).tolist(),
               plain_status_counts=np.bincount(p_status.cpu().numpy(), minlength=6).tolist())
    bound_s, bound_by, compute_s, stream_s = pdhg_work(bsz, m, n, a.element_size(), a.dtype,
                                                       row["kernel_steps"])
    row.update(bound_ms=bound_s * 1e3, bound_by=bound_by, compute_floor_ms=compute_s * 1e3,
               streaming_floor_ms=stream_s * 1e3)
    if not full:
        same = torch.equal(k_status, p_status) and torch.equal(k_iters, p_iters)
        close = torch.equal(k_state.inner, p_state.inner)
        for f, d in diffs.items():
            ref = getattr(p_state, f)
            tol = PDHG_XTOL[a.dtype] if f in ("x", "y") else \
                PDHG_STATE_RTOL[a.dtype] * max(1.0, float(ref.abs().max()))
            close = close and d <= tol
        row.update(status_and_steps_equal=same, state_within_tolerance=close)
        emit("kernel_vs_plain", kernel="pdhg", **row)
        check(same, f"pdhg kernel: statuses or steps differ from the plain version in {name}")
        check(close, f"pdhg kernel: state outside tolerance of the plain version in {name}")
        return row, k_status, k_state, k_iters
    limit = 4  # ITER_LIMIT
    k_dec, p_dec = k_status != limit, p_status != limit
    both = k_dec & p_dec
    disagree = int((both & (k_status != p_status)).sum())
    one_side = int((k_dec ^ p_dec).sum())
    k_obj = pdhg.objective(c, k_state.x, k_status)
    p_obj = pdhg.objective(c, p_state.x, p_status)
    opt = (k_status == 1) & (p_status == 1)
    rel = ((k_obj - p_obj).abs() / p_obj.abs().clamp(min=1.0))[opt]
    row.update(both_decide=int(both.sum()), decided_disagree=disagree,
               decided_by_one_side_only=one_side,
               max_rel_obj_diff=float(rel.max()) if rel.numel() else 0.0,
               steps_equal_share=float((k_iters == p_iters).double().mean()))
    emit("kernel_vs_plain", kernel="pdhg", **row)
    check(disagree == 0, f"pdhg kernel: {disagree} decided statuses differ in {name}")
    check(one_side <= 0.01 * bsz, f"pdhg kernel: {one_side} LPs decided by one side in {name}")
    check(row["max_rel_obj_diff"] <= 1e-3, f"pdhg kernel: objectives off by "
          f"{row['max_rel_obj_diff']:.3g} in {name}")
    return row, k_status, k_state, k_iters


def pdhg_slowest_lp(timer, *, batch, status, steps, streaming_cap):
    """The per-step time of the batch's slowest LP, alone on the card: the
    cluster variant at the auto cap (the LP's own steps) and the streaming
    variant (forced) at ``streaming_cap`` steps, in the same call."""
    from repro_torch.core import pdhg
    from repro_torch.kernels import pdhg_cuda

    row = int(torch.argmax(steps))
    one = batch.take(slice(row, row + 1))
    a, b, c = one.a, one.b, one.c
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    kw = dict(tol=pdhg.DEFAULT_PDHG_TOL, restart=pdhg.DEFAULT_RESTART)
    out = {}
    for variant, k, cap in [("cluster", None, pdhg.auto_cap_pdhg(one.m, one.n)),
                            ("streaming", 0, streaming_cap)]:
        state = pdhg.init_state(1, one.m, one.n, a.dtype, a.device)
        got = []
        ms = timer(lambda: got.append(pdhg_cuda.pdhg(a, b, c, state, tau, sigma, scales, cap,
                                                     _k=k, **kw)))
        n_steps = int(got[0][1][0])
        out[variant] = dict(k=pdhg_cuda.plan(one.m, one.n, a.dtype, a.device, k).k, cap=cap,
                            steps=n_steps, kernel_ms=ms, us_per_step=1e3 * ms / max(1, n_steps))
    emit("pdhg_slowest_lp", row=row, batch_status=int(status[row]), batch_steps=int(steps[row]),
         **out)
    return out


def pdhg_streaming_beside(timer, *, name, batch, cluster_status):
    """The streaming variant (forced) on the batch at the auto cap, timed in
    the same call as the cluster variant, its statuses held to the cluster
    variant's as the auto-cap case holds the kernel to the plain version."""
    from repro_torch.core import pdhg
    from repro_torch.kernels import pdhg_cuda

    a, b, c = batch.a, batch.b, batch.c
    bsz, m, n = a.shape
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    state = pdhg.init_state(bsz, m, n, a.dtype, a.device)
    out = []
    ms = timer(lambda: out.append(pdhg_cuda.pdhg(
        a, b, c, state, tau, sigma, scales, pdhg.auto_cap_pdhg(m, n), _k=0,
        tol=pdhg.DEFAULT_PDHG_TOL, restart=pdhg.DEFAULT_RESTART)))
    status, steps = out[0]
    dec_s, dec_c = status != 4, cluster_status != 4
    disagree = int((dec_s & dec_c & (status != cluster_status)).sum())
    one_side = int((dec_s ^ dec_c).sum())
    CASES.setdefault("pdhg.streaming", []).append(name)
    emit("pdhg_streaming_beside", case=name, kernel_ms=ms,
         kernel_steps=int(steps.to(torch.int64).sum()), max_steps=int(steps.max()),
         decided_disagree=disagree, decided_by_one_side_only=one_side)
    check(disagree == 0 and one_side <= 0.01 * bsz,
          f"pdhg streaming variant: statuses off the cluster variant in {name}")
    return ms


def pdhg_chain_case(*, name, batch):
    """A 150 + 250 resume chain and a rerun, each bit-identical to one launch at 400."""
    from repro_torch.kernels import ops

    a, b, c = batch.a, batch.b, batch.c
    full, full_state = ops.pdhg_solve(a, b, c, max_iters=400, want_state=True)
    again, again_state = ops.pdhg_solve(a, b, c, max_iters=400, want_state=True)
    part, state = ops.pdhg_solve(a, b, c, max_iters=150, want_state=True)
    rest, rest_state = ops.pdhg_resume(a, b, c, state, max_iters=250)
    torch.cuda.synchronize()
    rerun = all(torch.equal(bits(getattr(again, f)), bits(getattr(full, f)))
                for f in ("objective", "x", "y", "status", "iterations")) and \
        all(torch.equal(bits(getattr(again_state, f)), bits(getattr(full_state, f)))
            for f in PDHG_FIELDS)
    chain = all(torch.equal(bits(getattr(rest, f)), bits(getattr(full, f)))
                for f in ("objective", "x", "y", "status")) and \
        torch.equal(part.iterations + rest.iterations, full.iterations) and \
        all(torch.equal(bits(getattr(rest_state, f)), bits(getattr(full_state, f)))
            for f in PDHG_FIELDS)
    emit("kernel_vs_itself", kernel="pdhg", case=name, batch=batch.batch, m=batch.m, n=batch.n,
         rerun_bit_identical=rerun, chain_150_250_bit_identical_to_400=chain)
    check(rerun, f"pdhg kernel: two launches differ in {name}")
    check(chain, f"pdhg kernel: the 150 + 250 chain differs from one launch at 400 in {name}")


def certificate_batch(dev):
    """4 LPs of 100x100, rows 0 and 1 unbounded by construction (tests/test_pdhg.py)."""
    from repro_torch.core.lp import LPBatch

    rng = np.random.default_rng(3)
    m = n = 100
    a = rng.standard_normal((4, m, n)).astype(np.float32)
    b = (np.abs(rng.standard_normal((4, m))) + 0.5).astype(np.float32)
    c = rng.standard_normal((4, n)).astype(np.float32)
    for i in (0, 1):
        d = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
        a[i] -= np.outer(a[i] @ d + 0.1, d / (d @ d))
        c[i] = np.abs(c[i])
    return LPBatch.from_numpy(a, b, c, device=dev)


def highs_solve(lp):
    """One LP (max c.x, Ax <= b, x >= 0) by HiGHS in float64: (status code, objective)."""
    from scipy.optimize import linprog

    a, b, c = (np.asarray(v, np.float64) for v in lp)
    res = linprog(-c, A_ub=a, b_ub=b, bounds=(0, None), method="highs")
    status = {0: 1, 2: 3, 3: 2}.get(res.status, 4)
    return status, (float(-res.fun) if res.status == 0 else -float("inf"))


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------


def chunked_lp_batch(rng, bsz, m, n, feasible, dtype, dev, chunk):
    """``random_lp_batch`` made chunk by chunk (host memory stays small).

    Returns device tensors ``(a, b, c)`` and the first chunk's host arrays
    (the oracle's sample).
    """
    from repro_torch.core.lp import random_lp_batch

    a = torch.empty((bsz, m, n), dtype=dtype, device=dev)
    b = torch.empty((bsz, m), dtype=dtype, device=dev)
    c = torch.empty((bsz, n), dtype=dtype, device=dev)
    first = None
    for lo in range(0, bsz, chunk):
        hi = min(lo + chunk, bsz)
        part = random_lp_batch(rng, hi - lo, m, n, feasible, dtype=np.dtype(str(dtype)[6:]),
                               device="cpu")
        if first is None:
            first = tuple(t.numpy().copy() for t in (part.a, part.b, part.c))
        a[lo:hi].copy_(part.a)
        b[lo:hi].copy_(part.b)
        c[lo:hi].copy_(part.c)
    return a, b, c, first


def chunked_hyperbox(rng, bsz, n, dtype, dev, chunk=1_000_000):
    from repro_torch.core.lp import random_hyperbox_batch

    out = [torch.empty((bsz, n), dtype=dtype, device=dev) for _ in range(3)]
    for lo in range(0, bsz, chunk):
        hi = min(lo + chunk, bsz)
        parts = random_hyperbox_batch(rng, hi - lo, n, dtype=np.dtype(str(dtype)[6:]),
                                      device="cpu")
        for dst, src in zip(out, parts):
            dst[lo:hi].copy_(src)
    return out


def oracle_check(a, b, c, status, objective, sample):
    """Statuses and objectives of the first ``sample`` LPs against the float64 oracle."""
    from repro_torch.core import oracle

    k = min(sample, a.shape[0])
    o_obj, _, o_status, _ = oracle.solve_batch(a[:k], b[:k], c[:k])
    st = status[:k]
    obj = objective[:k].astype(np.float64)
    agree = float((st == o_status).mean())
    both = (st == 1) & (o_status == 1)
    rel = np.abs(obj[both] - o_obj[both]) / np.maximum(1.0, np.abs(o_obj[both]))
    return dict(sample=int(k), status_agreement=agree,
                max_rel_obj_err=float(rel.max()) if rel.size else 0.0)


def simplex_row(rt, dev, *, name, bsz, m, n, feasible, seed, counters):
    a, b, c, host = chunked_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible,
                                     torch.float32, dev, chunk=5000)
    problem = rt.LPProblem.make(c, a, bu=b)
    del a, b, c
    return run_row(rt, dev, name=name, problem=problem, counters=counters,
                   oracle_data=host, lps=bsz, extra=dict(m=m, n=n))


def hyperbox_row(rt, dev, *, name, bsz, n, seed, counters):
    lo, hi, d = chunked_hyperbox(np.random.default_rng(seed), bsz, n, torch.float32, dev)
    problem = rt.LPProblem.make(d, lo=lo, hi=hi)
    del lo, hi, d
    return run_row(rt, dev, name=name, problem=problem, counters=counters, oracle_data=None,
                   lps=bsz, extra=dict(n=n))


def run_row(rt, dev, *, name, problem, counters, oracle_data, lps, extra):
    before = launch_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(problem)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = sol.status.cpu().numpy()
    iters = sol.iterations.cpu().numpy()
    row = dict(row=name, lps=lps, **extra, dtype="float32", wall_s=wall, lps_per_s=lps / wall,
               launches=delta, status_counts=np.bincount(status, minlength=6).tolist(),
               mean_pivots=float(iters.mean()), max_pivots=int(iters.max()),
               max_memory_allocated=int(torch.cuda.max_memory_allocated()),
               finite_objective_share=float(np.isfinite(sol.objective.cpu().numpy()).mean()))
    check(sum(delta.values()) > 0, f"main-path row {name} launched no kernel")
    check(tuple(sol.x.shape) == (lps, problem.n), f"row {name}: x has shape {tuple(sol.x.shape)}")
    if name in MESH_SOURCES:
        MESH_REFS[name] = sol_digest(sol)
        MESH_REFS[f"{name}[:{MESH_ODD_LPS}]"] = sol_digest(sol, slice(0, MESH_ODD_LPS))
    if oracle_data is not None:
        row["oracle"] = oracle_check(*oracle_data, status, sol.objective.cpu().numpy(), 256)
        check(row["oracle"]["status_agreement"] >= 0.99,
              f"row {name}: statuses agree with the oracle on only "
              f"{row['oracle']['status_agreement']:.3f} of the sample")
        check(row["oracle"]["max_rel_obj_err"] <= 1e-4,
              f"row {name}: objective off the oracle by {row['oracle']['max_rel_obj_err']:.3g}")
    else:
        # Box LPs: every LP optimal, x the maximizing vertex, and the support
        # value against float64 on a sample, relative to the sum of |terms|.
        k = min(4096, lps)
        lo, hi, d = (t[:k].double() for t in (problem.lo, problem.hi, problem.c))
        terms = d * torch.where(d < 0, lo, hi)
        rel = (sol.objective[:k].double() - terms.sum(-1)).abs() / terms.abs().sum(-1)
        row["oracle"] = dict(sample=k, max_rel_err_of_abs_sum=float(rel.max()))
        check(bool((sol.status == rt.OPTIMAL).all()), f"row {name}: a box LP is not OPTIMAL")
        check(float(rel.max()) <= 1e-5, f"row {name}: support values off float64")
        check(torch.equal(sol.x[:k].double(), torch.where(d < 0, lo, hi)),
              f"row {name}: x is not the maximizing vertex")
    emit("main_path", **row)
    return row


def shared_row(rt, dev, *, name, bsz, m, n, feasible, seed, counters, dense_row, reruns):
    """A paper class as one ``SharedLPBatch`` through ``repro_torch.solve``.

    Appends ``(name, lps, fn)`` to ``reruns``: the same call, for
    :func:`repeat_rows` to time once the launch counts have been read.
    """
    from repro_torch.core.lp import random_shared_lp_batch

    sb = random_shared_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible, device=dev)
    before = launch_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(sb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = sol.status.cpu().numpy()
    iters = sol.iterations.cpu().numpy()
    k = 256
    sample = tuple(t[:k].cpu().numpy() for t in (sb.densify().a, sb.b, sb.c))
    row = dict(row=name, lps=bsz, m=m, n=n, dtype="float32", wall_s=wall, lps_per_s=bsz / wall,
               launches=delta, status_counts=np.bincount(status, minlength=6).tolist(),
               mean_pivots=float(iters.mean()), max_pivots=int(iters.max()),
               max_memory_allocated=int(torch.cuda.max_memory_allocated()),
               dense_row=dense_row["row"],
               dense_row_max_memory_allocated=dense_row["max_memory_allocated"],
               oracle=oracle_check(*sample, status, sol.objective.cpu().numpy(), k))
    emit("main_path", **row)
    MESH_REFS[name] = sol_digest(sol)
    reruns.append((name, bsz, lambda: rt.solve(sb)))
    check(delta["revised"] > 0, f"row {name} did not launch the revised kernel")
    check(tuple(sol.x.shape) == (bsz, n), f"row {name}: x has shape {tuple(sol.x.shape)}")
    check(row["oracle"]["status_agreement"] >= 0.99,
          f"row {name}: statuses agree with the oracle on only "
          f"{row['oracle']['status_agreement']:.3f} of the sample")
    check(row["oracle"]["max_rel_obj_err"] <= 1e-4,
          f"row {name}: objective off the oracle by {row['oracle']['max_rel_obj_err']:.3g}")
    return row


def reach_args(rt, model, kind):
    from repro_torch.core import support

    return dict(directions=support.template_directions(model.dim, kind),
                options=rt.SolveOptions(backend="cuda-shared"), use_hyperbox=False,
                warm_start=True)


def reach_row(rt, *, name, model, kind, steps, counters, plain_pivots, hyperbox_ref, reruns):
    """The paper's reachability run on the revised kernel's warm sweep.

    ``hyperbox_ref`` is the ``use_hyperbox=True`` run's supports, computed
    before the launch counts were set to 0.  Appends the same call to
    ``reruns``, as :func:`shared_row` does.
    """
    from repro_torch.core import reach

    kw = reach_args(rt, model, kind)
    stats = rt.SolveStats()
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sup, _ = reach.reach_supports(model, 0.02, steps, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    point = bool(np.array_equal(model.u.lo, model.u.hi))
    n_lps = reach.count_lps(steps, len(kw["directions"]), point)
    rel = float((np.abs(sup - hyperbox_ref) / np.maximum(1.0, np.abs(hyperbox_ref))).max())
    row = dict(row=name, steps=steps, directions=len(kw["directions"]), template=kind,
               lps=n_lps, lps_counted_by_stats=stats.lps, wall_s=wall, lps_per_s=n_lps / wall,
               launches=delta, pivots=stats.simplex_iterations,
               plain_sweep_pivots=plain_pivots, warm_started=stats.warm_started,
               max_rel_diff_from_hyperbox=rel, finite=bool(np.isfinite(sup).all()))
    emit("main_path", **row)
    reruns.append((name, n_lps, lambda: reach.reach_supports(model, 0.02, steps, **kw)))
    check(delta["revised"] == 1 and delta["hyperbox"] > 0,
          f"row {name} did not launch the revised kernel once (the sweep) and the hyperbox "
          f"kernel: {delta}")
    check(stats.simplex_iterations == plain_pivots,
          f"row {name}: {stats.simplex_iterations} pivots, the plain sweep {plain_pivots}")
    check(row["finite"] and rel <= 1e-5, f"row {name}: supports off the hyperbox path by {rel:.3g}")
    return row


def repeat_rows(reruns, reps):
    """Wall time of each row's call, ``reps`` more times, after the counted run."""
    for name, lps, fn in reruns:
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        emit("main_path_repeats", row=name, reps=reps, wall_s=walls, median_wall_s=med,
             min_wall_s=min(walls), max_wall_s=max(walls), median_lps_per_s=lps / med)


def hetero_problems(rt, seed, per_class):
    """Single-LP problems of shape classes 5, 28 and 100, and their host data."""
    from repro_torch.core.lp import random_lp_batch

    rng = np.random.default_rng(seed)
    problems, host = [], []
    for m, n in [(5, 5), (28, 28), (100, 100)]:
        part = random_lp_batch(rng, per_class, m, n, True, dtype=np.float32, device="cpu")
        for i in range(per_class):
            a, b, c = (t[i].numpy() for t in (part.a, part.b, part.c))
            host.append((a, b, c))
            problems.append(rt.LPProblem.make(c, a, bu=b))
    return problems, host


def hetero_row(rt, *, seed, counters, per_class):
    from repro_torch.core import oracle

    problems, host = hetero_problems(rt, seed, per_class)
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = rt.solve(problems)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = np.array([int(s.status[0]) for s in sols])
    obj = np.array([float(s.objective[0]) for s in sols])
    agree, errs = [], []
    for (a, b, c), st, ob in zip(host, status, obj):
        o_obj, _, o_st, _ = oracle.solve_lp(a, b, c)
        agree.append(st == o_st)
        if st == 1 and o_st == 1:
            errs.append(abs(ob - o_obj) / max(1.0, abs(o_obj)))
    row = dict(row="heterogeneous_list", problems=len(problems), shape_classes=[5, 28, 100],
               wall_s=wall, launches=delta,
               status_counts=np.bincount(status, minlength=6).tolist(),
               oracle=dict(status_agreement=float(np.mean(agree)),
                           max_rel_obj_err=float(max(errs) if errs else 0.0)))
    emit("main_path", **row)
    check(delta["simplex"] == 3, f"heterogeneous list launched {delta} (one per bucket expected)")
    check(row["oracle"]["status_agreement"] >= 0.99, "heterogeneous list: statuses off the oracle")
    check(row["oracle"]["max_rel_obj_err"] <= 1e-4, "heterogeneous list: objectives off the oracle")
    return row


def highs_compare(status, objective, highs, rtol):
    """Statuses on the rows a solver decides, and OPTIMAL objectives, against HiGHS."""
    h_status = np.array([h[0] for h in highs])
    h_obj = np.array([h[1] for h in highs])
    st = status[: len(highs)]
    obj = objective[: len(highs)].astype(np.float64)
    decided = st != 4
    both = (st == 1) & (h_status == 1)
    rel = np.abs(obj[both] - h_obj[both]) / np.maximum(1.0, np.abs(h_obj[both]))
    out = dict(sample=len(highs), decided=int(decided.sum()),
               status_agreement_on_decided=float((st[decided] == h_status[decided]).mean())
               if decided.any() else 1.0,
               highs_status_counts=np.bincount(h_status, minlength=6).tolist(),
               max_rel_obj_err=float(rel.max()) if rel.size else 0.0, rtol=rtol)
    return out


class Spans:
    """Host-clock seconds spent in named module functions during a call.

    Wraps each ``(module, name)`` for the duration of a ``with`` block;
    each wrapped call ends in ``torch.cuda.synchronize()``.  ``calls``
    counts the wrapped calls, so that a caller that reaches a function
    another way shows as a span never entered.
    """

    def __init__(self, targets):
        self.targets = targets
        self.seconds = {name: 0.0 for _, name in targets}
        self.calls = {name: 0 for _, name in targets}

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.targets]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def _timed(self, name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out
        return call


def pdhg_row(rt, *, name, batch, options, counters, highs, rtol, base_iters=None):
    """The slice-3 batch through ``repro_torch.solve`` on the first-order path.

    ``spans_s`` splits the wall time: the kernel launch with its step
    sizes (``ops.pdhg_solve``), the oracle's confirmation of the flagged
    rows and the crossover polish.
    """
    from repro_torch.core import pdhg
    from repro_torch.kernels import ops

    before = launch_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Spans([(ops, "pdhg_solve"), (pdhg, "confirm_certificates"), (pdhg, "crossover")]) as sp, \
            ConfirmRecorder() as confirm:
        t0 = time.perf_counter()
        sol = rt.solve(batch, options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = sol.status.cpu().numpy()
    iters = sol.iterations.cpu().numpy().astype(np.int64)
    bsz = batch.batch
    row = dict(row=name, lps=bsz, m=batch.m, n=batch.n, dtype=str(batch.a.dtype),
               backend=options.backend, crossover=options.crossover, wall_s=wall,
               lps_per_s=bsz / wall, launches=delta, total_iterations=int(iters.sum()),
               max_iterations=int(iters.max()),
               status_counts=np.bincount(status, minlength=6).tolist(),
               max_memory_allocated=int(torch.cuda.max_memory_allocated()),
               finite_objective_share=float(np.isfinite(sol.objective.cpu().numpy()).mean()),
               spans_s=sp.seconds, span_calls=sp.calls, cpu_count=os.cpu_count(),
               confirm_flagged=[c["rows"] for c in confirm.calls],
               confirm_workers=[c["workers"] for c in confirm.calls],
               highs=highs_compare(status, sol.objective.cpu().numpy(), highs, rtol))
    if base_iters is not None:
        polish = iters - base_iters
        row.update(polish_pivots=int(polish.sum()), max_polish_pivots=int(polish.max()),
                   polished_with_0_pivots=int(((polish == 0) & (status == 1)).sum()))
    emit("main_path", **row)
    check(tuple(sol.x.shape) == (bsz, batch.n), f"row {name}: x has shape {tuple(sol.x.shape)}")
    want = {"pdhg_solve": 1, "confirm_certificates": 1, "crossover": int(options.crossover)}
    check(sp.calls == want, f"row {name}: spans entered {sp.calls}, expected {want}")
    h = row["highs"]
    check(h["status_agreement_on_decided"] == 1.0, f"row {name}: statuses off HiGHS: {h}")
    check(h["max_rel_obj_err"] <= rtol, f"row {name}: objectives off HiGHS: {h}")
    return row, sol, confirm.calls


class ConfirmRecorder:
    """Records each call of ``core/pdhg.py:oracle_statuses`` (the confirmation's
    oracle solves on host threads): its inputs, workers, seconds and result."""

    def __init__(self):
        from repro_torch.core import pdhg

        self.pdhg = pdhg
        self.calls = []

    def __enter__(self):
        self.real = self.pdhg.oracle_statuses

        def recording(a, b, c, max_iters, workers=1):
            t0 = time.perf_counter()
            out = self.real(a, b, c, max_iters, workers)
            self.calls.append(dict(a=a, b=b, c=c, max_iters=max_iters, workers=workers,
                                   rows=int(a.shape[0]), seconds=time.perf_counter() - t0,
                                   status=out))
            return out

        self.pdhg.oracle_statuses = recording
        return self

    def __exit__(self, *exc):
        self.pdhg.oracle_statuses = self.real


def confirmation_case(calls, row):
    """The slice-3 row's confirmation on host threads beside the same flagged
    rows confirmed sequentially, once, in this run: the same statuses."""
    from repro_torch.core import pdhg

    check(len(calls) == 1, f"{row}: {len(calls)} confirmation calls")
    call = calls[0]
    t0 = time.perf_counter()
    seq = pdhg.oracle_statuses(call["a"], call["b"], call["c"], call["max_iters"], workers=1)
    seq_s = time.perf_counter() - t0
    same = bool(np.array_equal(seq, call["status"]))
    emit("confirmation", row=row, flagged=call["rows"], workers=call["workers"],
         cpu_count=os.cpu_count(), parallel_s=call["seconds"], sequential_s=seq_s,
         statuses=np.bincount(seq, minlength=6).tolist(), statuses_equal=same)
    check(same, f"{row}: the parallel confirmation's statuses differ from the sequential ones")


def auto_list_row(rt, dev, *, seed, counters, per_class):
    """64 LPs of 100x100 and 64 of 500x500 in one list through ``"auto"``."""
    from repro_torch.core import oracle
    from repro_torch.core.lp import random_lp_batch

    rng = np.random.default_rng(seed)
    problems, host = [], []
    for dim in (100, PDHG_DIM):
        part = random_lp_batch(rng, per_class, dim, dim, True, dtype=np.float32, device="cpu")
        for i in range(per_class):
            a, b, c = (t[i] for t in (part.a, part.b, part.c))
            host.append((a.numpy(), b.numpy(), c.numpy()))
            problems.append(rt.LPProblem.make(c, a, bu=b, device=dev))
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = rt.solve(problems, rt.SolveOptions(backend="auto"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(counters, before)
    status = np.array([int(s.status[0]) for s in sols])
    obj = np.array([float(s.objective[0]) for s in sols])
    small = slice(0, per_class)
    agree, errs = [], []
    for (a, b, c), st, ob in zip(host[small], status[small], obj[small]):
        o_obj, _, o_st, _ = oracle.solve_lp(a, b, c)
        agree.append(st == o_st)
        if st == 1 and o_st == 1:
            errs.append(abs(ob - o_obj) / max(1.0, abs(o_obj)))
    large = status[per_class:]
    row = dict(row="auto_list", problems=len(problems), shape_classes=[100, PDHG_DIM],
               wall_s=wall, launches=delta, status_counts=np.bincount(status, minlength=6).tolist(),
               oracle_100=dict(status_agreement=float(np.mean(agree)),
                               max_rel_obj_err=float(max(errs) if errs else 0.0)),
               large_decided_optimal=bool(np.all(large[large != 4] == 1)),
               large_finite_where_optimal=bool(np.isfinite(obj[per_class:][large == 1]).all()))
    emit("main_path", **row)
    check(delta["simplex"] > 0 and delta["pdhg"] > 0, f"auto_list launched {delta}")
    check(row["oracle_100"]["status_agreement"] >= 0.99, "auto_list: statuses off the oracle")
    check(row["oracle_100"]["max_rel_obj_err"] <= 1e-4, "auto_list: objectives off the oracle")
    check(row["large_decided_optimal"] and row["large_finite_where_optimal"],
          "auto_list: a 500x500 LP that PDHG decides is not OPTIMAL")
    return row


def frontier_row(rt, *, batch, pdhg_row_, highs, raw_status):
    """The slice-3 batch on the simplex kernel, beside the PDHG row.

    ``raw_status`` is the PDHG kernel's status before confirmation
    (phase 3): its UNBOUNDED flags are set beside the simplex kernel's
    UNBOUNDED rows.
    """
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(batch, rt.SolveOptions(backend="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    status = sol.status.cpu().numpy()
    iters = sol.iterations.cpu().numpy().astype(np.int64)
    row = dict(row=f"frontier_simplex_{PDHG_DIM}x{PDHG_DIM}", lps=batch.batch, backend="cuda",
               wall_s=wall, lps_per_s=batch.batch / wall, pivots=int(iters.sum()),
               max_pivots=int(iters.max()), status_counts=np.bincount(status, minlength=6).tolist(),
               max_memory_allocated=int(torch.cuda.max_memory_allocated()),
               pdhg_wall_s=pdhg_row_["wall_s"], pdhg_steps=pdhg_row_["total_iterations"],
               pdhg_raw_unbounded=int((raw_status == 2).sum()),
               simplex_unbounded=int((status == 2).sum()),
               both_unbounded=int(((raw_status == 2) & (status == 2)).sum()),
               highs=highs_compare(status, sol.objective.cpu().numpy(), highs, 1e-4))
    emit("frontier", **row)
    return row


def crossover_tiles(*, batch, sol, small):
    """The crossover polish's wall time at the reference's tile (8) and the port's.

    On the whole slice-3 batch and on a batch of its first ``small``
    OPTIMAL rows, where the port's tile polishes replicas.
    """
    import dataclasses

    from repro_torch.core import pdhg

    rows = (sol.status == 1).nonzero().flatten()
    few = rows[:small]
    sub = dataclasses.replace(sol, **{f: getattr(sol, f)[few] for f in
                                      ("objective", "x", "status", "iterations", "y")})
    out = {}
    for label, (bt, st, n_opt) in {"batch": (batch, sol, rows.numel()),
                                   f"first_{small}_optimal": (batch.take(few), sub, small)}.items():
        polished = {}
        for tile in (8, pdhg.CROSSOVER_TILE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pol = pdhg.crossover(bt, st, tile=tile)
            torch.cuda.synchronize()
            polished[tile] = pol
            out[f"{label}_tile_{tile}"] = dict(
                wall_s=time.perf_counter() - t0, launches=-(-n_opt // tile), polished=n_opt,
                pivots=int((pol.iterations - st.iterations).to(torch.int64).sum()))
        lo, hi = polished[8], polished[pdhg.CROSSOVER_TILE]
        both = (lo.status == 1) & (hi.status == 1)
        rel = ((lo.objective - hi.objective).abs() / hi.objective.abs().clamp(min=1.0))[both]
        out[f"{label}_max_rel_obj_diff_8_vs_{pdhg.CROSSOVER_TILE}"] = \
            float(rel.max()) if rel.numel() else 0.0
    emit("crossover_tiles", **out)
    return out


# ---------------------------------------------------------------------------
# the rounds phase: compaction, basis resume, guardrails, sessions, sweeps
# ---------------------------------------------------------------------------


class RoundSizes:
    """Records the batch size of every dispatch round of ``core/dispatch.py``,
    and the set of the rounds' ``(m, n)``."""

    def __init__(self):
        from repro_torch.core import dispatch

        self.dispatch = dispatch
        self.real = dispatch.dispatch_round
        self.sizes = []
        self.shapes = set()

    def __enter__(self):
        def recording(batch, options, stats=None, state=None, want_state=False):
            self.sizes.append(batch.batch)
            self.shapes.add((batch.m, batch.n))
            return self.real(batch, options, stats, state=state, want_state=want_state)

        self.dispatch.dispatch_round = recording
        return self

    def __exit__(self, *exc):
        self.dispatch.dispatch_round = self.real


def timed_solve(rt, problem, options, stats=None):
    """``rt.solve`` with its wall ms and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = rt.solve(problem, options, stats=stats)
    torch.cuda.synchronize()
    return sol, (time.perf_counter() - t0) * 1e3, int(torch.cuda.max_memory_allocated())


def rounds_case(rt, *, name, problem, base, modes, counters, kernel, variant, fields):
    """Compaction ``"off"`` and each ``(mode, resume)`` on the same LPs, in one call.

    Every compacted result must equal ``"off"`` bit for bit in ``fields``,
    and every round must be one launch of ``kernel``'s ``variant``.
    """
    rows = {}
    off = None
    for mode, resume in [("off", "scratch")] + list(modes):
        stats = rt.SolveStats()
        before = launch_counts(counters)
        with RoundSizes() as rec:
            sol, wall_ms, peak = timed_solve(rt, problem, base.replace(compaction=mode,
                                                                       resume=resume), stats)
        delta = count_delta(counters, before)
        key = f"{mode}+{resume}" if mode != "off" else "off"
        row = dict(case=name, mode=mode, resume=resume, compact_every=base.compact_every,
                   rounds=len(rec.sizes), survivors=rec.sizes, wall_ms=wall_ms,
                   max_memory_allocated=peak, launches=delta,
                   simplex_iterations=stats.simplex_iterations,
                   lockstep_iterations=stats.lockstep_iterations, resumed=stats.resumed,
                   status_counts=np.bincount(sol.status.cpu().numpy(), minlength=6).tolist())
        check(delta[kernel] == len(rec.sizes) and delta[f"{kernel}.{variant}"] == delta[kernel],
              f"rounds {name} {key}: {delta} launches for {len(rec.sizes)} rounds "
              f"(each round one {variant} {kernel} launch expected)")
        if off is None:
            off = (sol, row)
        else:
            same = {f: torch.equal(bits(getattr(sol, f)), bits(getattr(off[0], f)))
                    for f in fields}
            row.update(bit_equal_to_off=same, lockstep_vs_off=[row["lockstep_iterations"],
                                                               off[1]["lockstep_iterations"]])
            check(all(same.values()), f"rounds {name} {key} differ from compaction='off': {same}")
            check(len(rec.sizes) > 1, f"rounds {name} {key} ran one round only")
        emit("rounds", **row)
        rows[key] = row
    return off[0], rows


def guardrail_cases(rt, *, name, problem, off, counters, poison_lps, k):
    """Type 1 with the guardrails on and off (bit-equal, timed), then a NaN
    written into one carried row of a basis-resume state on the card."""
    from repro_torch.core import dispatch

    times = {True: [], False: []}
    for flag in (True, False, True, False):
        sol, wall_ms, _ = timed_solve(rt, problem, rt.SolveOptions(guardrails=flag))
        times[flag].append(wall_ms)
        for f in ("status", "iterations", "basis", "objective", "x"):
            check(torch.equal(bits(getattr(sol, f)), bits(getattr(off, f))),
                  f"guardrails={flag} changed {f} on a healthy batch")
        del sol
    emit("guardrails", case=name, on_ms=times[True], off_ms=times[False],
         cost_ms=min(times[True]) - min(times[False]), bit_equal=True)

    sub = problem.take(slice(0, poison_lps))
    survivors = (off.iterations[:poison_lps] > k).nonzero().flatten()
    check(survivors.numel() > 0, f"no LP of {name}'s first {poison_lps} survives round 0")
    row = int(survivors[0])
    real = dispatch.dispatch_round

    def poisoning(batch, options, stats=None, state=None, want_state=False):
        sol, out = real(batch, options, stats, state=state, want_state=want_state)
        if out is not None and state is None:
            out.tab[row, 0, 0] = float("nan")  # round 0's carried tableau
        return sol, out

    opts = rt.SolveOptions(compaction="every_k", compact_every=k, resume="basis")
    dispatch.dispatch_round = poisoning
    try:
        flagged = rt.solve(sub, opts)
        qstats = rt.SolveStats()
        fixed = rt.solve(sub, opts.replace(quarantine=True), stats=qstats)
    finally:
        dispatch.dispatch_round = real
    rest = torch.arange(poison_lps, device=off.status.device) != row
    same = {f: torch.equal(bits(getattr(flagged, f)[rest]),
                           bits(getattr(off, f)[:poison_lps][rest]))
            for f in ("status", "iterations", "objective", "x")}
    ref_obj = float(off.objective[row])
    rel = abs(float(fixed.objective[row]) - ref_obj) / max(1.0, abs(ref_obj))
    out = dict(case=f"{name}_first_{poison_lps}", row=row,
               poisoned_status=int(flagged.status[row]), others_bit_equal=same, quarantined=qstats.quarantined,
               resolved_status=int(fixed.status[row]), off_status=int(off.status[row]),
               resolved_rel_obj_err=rel)
    emit("poisoned_row", **out)
    check(out["poisoned_status"] == rt.NUMERICAL, "the poisoned row did not retire NUMERICAL")
    check(all(same.values()), f"rows beside the poisoned one changed: {same}")
    check(qstats.quarantined == 1 and out["resolved_status"] == out["off_status"]
          and rel <= 1e-4, f"the quarantine did not resolve the poisoned row: {out}")


def session_case(rt, dev, *, problem, calls=3):
    """``SolveSession`` calls at one shape: ``compiles`` must stop moving after the first."""
    sess = rt.SolveSession(rt.SolveOptions(), device=dev)
    seen = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.solve(problem)
        torch.cuda.synchronize()
        seen.append(dict(compiles=sess.stats.compiles, cache_hits=sess.stats.cache_hits,
                         wall_ms=(time.perf_counter() - t0) * 1e3))
    emit("sessions", shape=[problem.m, problem.n], lps=problem.batch, calls=seen)
    check(all(c["compiles"] == seen[0]["compiles"] for c in seen),
          f"session compiles moved after the first call: {seen}")


def dense_sweep_case(rt, dev, *, name, model, kind, steps, counters):
    """The reach model's X0 supports as the dense warm sweep: ``sweep_problems``
    (one simplex launch a step, read back once) against the per-step loop."""
    from repro_torch.core import reach, support

    dirs = support.template_directions(model.dim, kind)
    stack = reach.direction_stack(model, 0.02, steps, dirs).astype(np.float32)
    poly = support.box_to_polytope(model.x0)
    opts = rt.SolveOptions()
    out = {}
    for how, fn in (("sweep_problems", poly.support_sweep), ("per_step_loop", poly.step_sweep)):
        fn(stack, opts, device=dev)  # warm-up: the first call pays the library load
        before = launch_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sup = fn(stack, opts, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        delta = count_delta(counters, before)
        stats = rt.SolveStats()
        fn(stack, opts, stats=stats, device=dev)
        out[how] = dict(support=sup, wall_ms=wall_ms, launches=delta,
                        pivots=stats.simplex_iterations, warm_started=stats.warm_started)
    same = torch.equal(bits(out["sweep_problems"]["support"]),
                       bits(out["per_step_loop"]["support"]))
    row = dict(case=name, steps=steps, directions=len(dirs), supports_bit_equal=same,
               **{f"{h}_{k}": v[k] for h, v in out.items()
                  for k in ("wall_ms", "pivots", "warm_started", "launches")})
    emit("dense_sweep", **row)
    check(same, f"dense sweep {name}: sweep_problems and the per-step loop differ")
    check(row["sweep_problems_pivots"] == row["per_step_loop_pivots"],
          f"dense sweep {name}: pivots differ")
    check(out["sweep_problems"]["launches"]["simplex"] == steps,
          f"dense sweep {name}: {out['sweep_problems']['launches']} for {steps} steps")


# ---------------------------------------------------------------------------
# the serve phase (slice 7): the LP serve loop, faults, speculation
# ---------------------------------------------------------------------------


class FaultWatch:
    """Counts the dispatch rounds that raised, for the whole run.

    Every retry follows a round that raised, so a phase that is not a
    fault case must leave the count where it found it: no clean phase
    leans on recovery.
    """

    def __init__(self):
        from repro_torch.core import dispatch

        self.dispatch = dispatch
        self.real = dispatch.dispatch_round
        self.raised = 0

    def __enter__(self):
        def watched(*args, **kw):
            try:
                return self.real(*args, **kw)
            except Exception:
                self.raised += 1
                raise

        self.dispatch.dispatch_round = watched
        return self

    def __exit__(self, *exc):
        self.dispatch.dispatch_round = self.real


def check_clean(eng, where):
    """A clean serve phase: no retry, no dead letter."""
    st = eng.stats
    check(st.retries == 0 and st.dead_lettered == 0 and eng.dead_letters == [],
          f"{where}: the clean phase leaned on recovery (retries {st.retries}, "
          f"dead-lettered {st.dead_lettered})")


def serve_requests(rt):
    """The serve traffic: SERVE_REQUESTS LPs of ``lp_request_mix([(28, 28),
    (100, 100)], seed=11)`` in float32, and SERVE_BOXES boxlike requests of
    n = SERVE_BOX_N, one after every SERVE_REQUESTS / SERVE_BOXES LPs.  The
    requests arrive on the host; the engine moves each admitted wave."""
    from repro_torch.core.lp import random_hyperbox_batch
    from repro_torch.serve.loadgen import lp_request_mix

    make = lp_request_mix([(28, 28), (100, 100)], seed=11, device="cpu")
    lo, hi, d = random_hyperbox_batch(np.random.default_rng(12), SERVE_BOXES, SERVE_BOX_N,
                                      device="cpu")
    every = SERVE_REQUESTS // SERVE_BOXES
    out = []
    for k in range(SERVE_BOXES):
        out += [make(i) for i in range(k * every, (k + 1) * every)]
        out.append(rt.LPProblem.make(d[k], lo=lo[k], hi=hi[k], device="cpu"))
    return out


def same_solutions(sols, refs) -> dict:
    """Per field, whether every request's solution equals the reference's bit for bit."""
    out = {}
    for f in ("objective", "status", "iterations"):
        out[f] = torch.equal(bits(torch.cat([getattr(s, f) for s in sols])),
                             bits(torch.cat([getattr(r, f) for r in refs])))
    by_width = {}
    for s, r in zip(sols, refs):
        by_width.setdefault(s.x.shape[-1], ([], []))
        by_width[s.x.shape[-1]][0].append(s.x)
        by_width[s.x.shape[-1]][1].append(r.x)
    out["x"] = all(torch.equal(bits(torch.cat(a)), bits(torch.cat(b)))
                   for a, b in by_width.values())
    return out


def drain(eng, problems):
    """Submit ``problems`` at once and step the engine until it is empty."""
    tickets = [eng.submit(p) for p in problems]
    while eng.pending_count or eng.inflight_count:
        eng.step()
    return [eng.result(t) for t in tickets]


def serve_mode_case(rt, dev, *, mode, problems, trace, oneshot, counters, engine_kw, warm):
    """One serve mode replayed open-loop on ``trace`` after a warm-up."""
    from repro_torch.serve.engine import LPEngine
    from repro_torch.serve.loadgen import replay

    eng = LPEngine(rt.SolveOptions(), device=dev, **engine_kw)
    if mode == "continuous":
        drain(eng, warm)
    else:
        tickets = [eng.submit(p) for p in warm]
        eng.flush()
        for t in tickets:
            eng.result(t)
    compiles0, spliced0, resumed0 = eng.stats.compiles, eng.stats.spliced, eng.stats.resumed
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = replay(eng, trace, mode=mode)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    delta = count_delta(counters, before)
    same = same_solutions(res.solutions, oneshot)
    lat_ms = res.latencies * 1e3
    row = dict(requests=len(trace), offered_per_s=len(trace) / trace[-1].t,
               p50_ms=float(np.percentile(lat_ms, 50)), p99_ms=float(np.percentile(lat_ms, 99)),
               throughput_per_s=len(trace) / res.makespan, makespan_s=res.makespan,
               wall_ms=wall_ms, spliced=eng.stats.spliced - spliced0,
               resumed=eng.stats.resumed - resumed0, steady_compiles=eng.stats.compiles - compiles0,
               steps=eng._step_count, launches=delta, bit_equal_to_oneshot=same,
               status_counts=np.bincount(torch.cat([s.status for s in res.solutions]).cpu().numpy(),
                                         minlength=6).tolist(),
               retries=eng.stats.retries, dead_lettered=eng.stats.dead_lettered, **engine_kw)
    emit(f"serve_{mode}", **row)
    check(all(same.values()), f"serve_{mode}: requests differ from the one-shot solve: {same}")
    check(row["steady_compiles"] == 0, f"serve_{mode}: {row['steady_compiles']} compiles after "
          "the warm-up")
    check_clean(eng, f"serve_{mode}")
    return row


def serve_class(problems, dev):
    """The stacked problem of one serve-loop wave on ``dev``: each request
    padded to its shape class (``core/bucketing.py:shape_class``), as
    ``LPEngine._admit`` pads it, and stacked (one class, one dtype and one
    set of flags)."""
    from repro_torch.core.bucketing import shape_class
    from repro_torch.core.problem import stack_problems

    cm, cn = shape_class(problems[0].m, problems[0].n)
    p = stack_problems([p.pad_to(cm, cn) for p in problems])
    return dataclasses.replace(p, **{f.name: getattr(p, f.name).to(dev)
                                     for f in dataclasses.fields(p)
                                     if isinstance(getattr(p, f.name), torch.Tensor)})


def serve_kernel_cases(rt, dev, timer, *, problems, pdhg_batch, lps=64):
    """The kernels of the serve path against their plain versions at the
    shapes the serve loop launches them: the PDHG kernel on the 512x512
    canonical class of ``lps`` of the slice-3 LPs (cap 400, as
    ``serve_pdhg`` solves them), and the hyperbox kernel on the boxlike
    requests padded to their class width.  Returns the PDHG row (its
    ``variant`` and ``k``)."""
    from repro_torch.core.lp import LPBatch
    from repro_torch.core.problem import canonicalize

    reqs = [rt.LPProblem.from_batch(pdhg_batch.take(slice(i, i + 1))) for i in range(lps)]
    cb = canonicalize(serve_class(reqs, dev)).batch
    row, *_ = pdhg_case(timer, name=f"serve_class_{lps}x{cb.m}x{cb.n}_f32_cap400",
                        batch=LPBatch(cb.a, cb.b, cb.c), cap=400, full=False, reps=3,
                        want="cluster")
    boxes = serve_class([p for p in problems if p.boxlike], dev)
    hyperbox_case(dev, timer, name=f"serve_class_{boxes.batch}x{boxes.n}_f32_box",
                  bsz=boxes.batch, n=boxes.n, dtype=torch.float32, data_seed=None,
                  data=(boxes.lo.contiguous(), boxes.hi.contiguous(), boxes.c.contiguous()))
    return row


def serve_pdhg_case(rt, dev, *, batch, counters, plan_row, per_step=16, step_iters=100):
    """LPs of the slice-3 batch as requests on ``"auto"`` (cap 400), admitted
    ``per_step`` a round, so each resume round's batch differs in size.
    ``plan_row`` is the kernel case of the same class: the engine's rounds
    must take its variant and ``k``."""
    from repro_torch.kernels import pdhg_cuda
    from repro_torch.serve.engine import LPEngine

    opts = rt.SolveOptions(backend="auto", max_iters=400)
    problems = [rt.LPProblem.from_batch(batch.take(slice(i, i + 1))) for i in range(batch.batch)]
    oneshot = rt.SolveSession(opts, device=dev).solve(problems)
    eng = LPEngine(opts, device=dev, flush_every=1 << 30, step_iters=step_iters)
    before = launch_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets, done = [], {}
    with RoundSizes() as rec:
        for lo in range(0, len(problems), per_step):
            tickets += [eng.submit(p) for p in problems[lo:lo + per_step]]
            for t in eng.step():
                done[t] = eng.result(t)
        while len(done) < len(problems):
            for t in eng.step():
                done[t] = eng.result(t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    delta = count_delta(counters, before)
    sols = [done[t] for t in tickets]
    same = same_solutions(sols, oneshot)
    (cm, cn), = rec.shapes
    how = pdhg_cuda.plan(cm, cn, batch.a.dtype, batch.a.device)
    row = dict(requests=len(problems), shape=[batch.m, batch.n],
               class_shape=[cm, cn], variant=how.variant, k=how.k,
               max_iters=400, step_iters=step_iters, admitted_per_step=per_step,
               round_batches=rec.sizes,
               wall_ms=wall_ms, spliced=eng.stats.spliced, resumed=eng.stats.resumed,
               launches=delta, bit_equal_to_oneshot=same,
               status_counts=np.bincount(torch.cat([s.status for s in sols]).cpu().numpy(),
                                         minlength=6).tolist())
    emit("serve_pdhg", **row)
    check(all(same.values()), f"serve_pdhg: requests differ from the one-shot solve: {same}")
    check(delta["pdhg"] == len(rec.sizes) and delta["simplex"] == 0,
          f"serve_pdhg: {delta} launches for {len(rec.sizes)} rounds")
    check(delta["pdhg.cluster"] == delta["pdhg"] and how.variant == plan_row["variant"]
          and how.k == plan_row["k"] and [cm, cn] == [plan_row["m"], plan_row["n"]],
          f"serve_pdhg: rounds at class {row['class_shape']} took {how.variant} k={how.k} "
          f"({delta}), the kernel case {plan_row['variant']} k={plan_row['k']} at "
          f"{plan_row['m']}x{plan_row['n']}")
    check(len(set(rec.sizes)) > 1, f"serve_pdhg: every round had {rec.sizes[0]} rows")
    check_clean(eng, "serve_pdhg")
    return row


def faults_case(rt, dev, *, type1, shared1, lps=5000):
    """The recovery paths on the card: a failed round retried, a shard crash
    mid-round, a poisoned carried row in the serve loop, a group dead-lettered
    with ``retry_budget=0`` while the other completes, a shared-A retry."""
    from repro_torch.runtime import chaos
    from repro_torch.serve.engine import LPEngine
    from repro_torch.serve.loadgen import lp_request_mix

    fields = ("status", "iterations", "basis", "objective", "x")

    def equal(a, b, rows=slice(None), fs=fields):
        return all(torch.equal(bits(getattr(a, f)[rows]), bits(getattr(b, f)[rows])) for f in fs)

    out = {}
    sub = type1.take(slice(0, lps))
    clean = rt.solve(sub)
    for case, monkey, opts in [
            ("fail_round_0", chaos.ChaosMonkey(fail_rounds=[0], max_faults=1), rt.SolveOptions()),
            ("shard_crash_chunk_1250", chaos.ChaosMonkey(crash_rounds=[0], max_faults=1),
             rt.SolveOptions(chunk_size=1250))]:
        stats = rt.SolveStats()
        with chaos.inject(monkey):
            sol, wall_ms, _ = timed_solve(rt, sub, opts, stats)
        out[case] = dict(retries=stats.retries, faults_injected=stats.faults_injected,
                         wall_ms=wall_ms, bit_equal=equal(sol, clean))
        check(stats.retries == 1 and stats.faults_injected == 1 and out[case]["bit_equal"],
              f"faults {case}: {out[case]}")

    problems = [rt.LPProblem.from_batch(sub.take(slice(i, i + 1))) for i in range(256)]
    oneshot = rt.SolveSession(device=dev).solve(problems)
    eng = LPEngine(rt.SolveOptions(), device=dev, flush_every=1 << 30, step_iters=64)
    with chaos.inject(chaos.ChaosMonkey(poison_rows={0: [5]})) as mk:
        sols = drain(eng, problems)
    rest = [i for i in range(len(problems)) if i != 5]
    out["serve_poisoned_row"] = dict(
        rows_poisoned=mk.rows_poisoned, poisoned_status=int(sols[5].status[0]),
        others_bit_equal=all(same_solutions([sols[i] for i in rest],
                                            [oneshot[i] for i in rest]).values()),
        retries=eng.stats.retries, dead_lettered=eng.stats.dead_lettered)
    check(out["serve_poisoned_row"]["poisoned_status"] == rt.NUMERICAL and
          out["serve_poisoned_row"]["others_bit_equal"] and mk.rows_poisoned == 1,
          f"faults serve_poisoned_row: {out['serve_poisoned_row']}")

    make = lp_request_mix([(28, 28), (100, 100)], seed=13, device="cpu")
    problems = [make(i) for i in range(64)]
    oneshot = rt.SolveSession(device=dev).solve(problems)
    eng = LPEngine(rt.SolveOptions(retry_budget=0), device=dev, flush_every=1 << 30,
                   step_iters=64)
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=[0], max_faults=1)):
        tickets = [eng.submit(p) for p in problems]
        while eng.pending_count or eng.inflight_count:
            eng.step()
    sols = [eng.result(t) for t in tickets]
    dead = sorted(tickets.index(t) for t in eng.dead_letters)
    alive = [i for i in range(len(problems)) if i not in set(dead)]
    later = eng.result(eng.submit(make(64)))
    out["serve_dead_letter"] = dict(
        dead_lettered=eng.stats.dead_lettered, dead_shape=sorted({problems[i].m for i in dead}),
        dead_all_numerical=all(int(sols[i].status[0]) == rt.NUMERICAL for i in dead),
        others_bit_equal=all(same_solutions([sols[i] for i in alive],
                                            [oneshot[i] for i in alive]).values()),
        later_request_status=int(later.status[0]))
    check(len(dead) == len(problems) // 2 and out["serve_dead_letter"]["dead_all_numerical"]
          and out["serve_dead_letter"]["others_bit_equal"]
          and out["serve_dead_letter"]["later_request_status"] == rt.OPTIMAL,
          f"faults serve_dead_letter: {out['serve_dead_letter']}")

    ssub = shared1.take(slice(0, lps))
    sclean = rt.solve(ssub)
    stats = rt.SolveStats()
    with chaos.inject(chaos.ChaosMonkey(fail_rounds=[0], max_faults=1)):
        sol = rt.solve(ssub, stats=stats)
    out["shared_retry"] = dict(retries=stats.retries, bit_equal=equal(sol, sclean))
    check(stats.retries == 1 and out["shared_retry"]["bit_equal"],
          f"faults shared_retry: {out['shared_retry']}")
    emit("faults", lps=lps, **out)


def speculation_case(rt, *, batch, chunk):
    """``speculation=True`` against ``False`` on one batch in chunks: bit-equal,
    each timed, with the speculative re-dispatches of each run."""
    from repro_torch.runtime import straggler

    real = straggler.run_with_speculation
    reports = []

    def recording(*args, **kw):
        reports.append(real(*args, **kw))
        return reports[-1]

    runs = {False: [], True: []}
    ref = None
    straggler.run_with_speculation = recording
    try:
        for flag in (False, True, True, False):
            n = len(reports)
            sol, wall_ms, peak = timed_solve(rt, batch, rt.SolveOptions(chunk_size=chunk,
                                                                        speculation=flag))
            if ref is None:
                ref = sol
            same = all(torch.equal(bits(getattr(sol, f)), bits(getattr(ref, f)))
                       for f in ("status", "iterations", "basis", "objective", "x"))
            check(same, f"speculation={flag} differs from the serial chunk loop")
            check(len(reports) - n == int(flag), f"speculation={flag}: "
                  f"{len(reports) - n} speculative rounds")
            runs[flag].append(dict(wall_ms=wall_ms, max_memory_allocated=peak,
                                   respawned=reports[-1].respawned if flag else 0))
            del sol
    finally:
        straggler.run_with_speculation = real
    emit("speculation", lps=batch.batch, chunk_size=chunk, chunks=-(-batch.batch // chunk),
         off=runs[False], on=runs[True], bit_equal=True)



def a_lo_case(timer, dev, *, batches):
    """What the row-local ``A lo`` product of ``canonicalize`` costs at the
    paper's sizes: the whole ``canonicalize`` and the product alone, as
    shipped (``row_sum`` in blocks of ``A_LO_ROWS`` rows) and as a batched
    ``einsum``, each with the device memory it adds (CUDA events, median of
    three; the values do not change the work)."""
    from repro_torch.core import problem as tproblem
    from repro_torch.core.lp import row_sum

    def extra_bytes(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated() - base)

    rows = []
    for name, batch in batches:
        prob = tproblem.LPProblem.make(batch.c, batch.a, bu=batch.b, device=dev)
        lo = torch.rand(batch.c.shape, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev, dtype=batch.a.dtype)
        blocks = tproblem.A_LO_ROWS

        def row_local():
            return torch.cat([row_sum(a * v[:, None, :]) for a, v in
                              zip(batch.a.split(blocks), lo.split(blocks))])

        def batched():
            return torch.einsum("bmn,bn->bm", batch.a, lo)

        check(torch.allclose(row_local(), batched(), rtol=1e-4, atol=1e-3),
              f"{name}: the row-local A lo product disagrees with einsum")
        rows.append(dict(
            name=name, lps=batch.batch, m=batch.m, n=batch.n, block_rows=blocks,
            canonicalize_ms=timer(lambda: tproblem.canonicalize(prob), reps=3),
            canonicalize_extra_bytes=extra_bytes(lambda: tproblem.canonicalize(prob)),
            row_sum_ms=timer(row_local, reps=3), row_sum_extra_bytes=extra_bytes(row_local),
            einsum_ms=timer(batched, reps=3), einsum_extra_bytes=extra_bytes(batched)))
        del prob, lo
    emit("a_lo", rows=rows)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the autotune phase (slice 8): predict, trial, the winner cache, the roofline
# ---------------------------------------------------------------------------

#: The main path's shape classes, ``(m, n, shared, batch)``, ranked by the
#: cost model: the slice-1 list buckets, the paper's types, the shared
#: types and the slice-3 batch.
PREDICT_CLASSES = [(5, 5, False, 4096), (28, 28, False, 4096), (100, 100, False, 50_000),
                   (200, 100, False, 10_000), (100, 100, True, 50_000),
                   (200, 100, True, 10_000), (500, 500, False, 256)]
#: The classes ``autotune.warm`` times, ``(m, n, batch)``; the last is the
#: class of the trial solve of type 1's first 5,000 LPs.
WARM_CLASSES = [(5, 5, 4096), (28, 28, 4096), (100, 100, 50_000), (200, 100, 10_000),
                (100, 100, 5_000)]
#: Bytes of the device-to-device copy the roofline line times.
COPY_BYTES = 4 << 30


def same_fields(a, b, fields=("status", "iterations", "objective")) -> dict:
    return {f: torch.equal(bits(getattr(a, f)), bits(getattr(b, f))) for f in fields}


def autotune_predict_case(rt, dev, *, part):
    """The predicted ranking of each main-path class, the choice held to the
    static table, and ``part`` solved under the default options (the tuner
    in ``"predict"`` mode) and under ``autotune="off"``: bit-equal."""
    from repro_torch.core import dispatch
    from repro_torch.runtime import autotune

    classes = []
    for m, n, shared, bsz in PREDICT_CLASSES:
        opts = rt.SolveOptions(backend="auto")
        ranked = autotune.rank_candidates(m, n, bsz, torch.float32, opts, shared=shared,
                                          device=dev)
        kw = dict(dtype=torch.float32, batch=bsz, device=dev)
        tuned = dispatch.resolve_backend(opts, shared, (m, n), **kw)
        static = dispatch.resolve_backend(opts.replace(autotune="off"), shared, (m, n), **kw)
        check((tuned.backend, tuned.effective_layout) == (static.backend,
                                                          static.effective_layout),
              f"autotune predict chose {tuned.backend}/{tuned.layout} at {m}x{n} "
              f"(shared={shared}); the static table says {static.backend}")
        choice = [tuned.backend, tuned.layout]
        classes.append(dict(m=m, n=n, shared=shared, batch=bsz, choice=choice,
                            ranking=[dict(backend=c.backend, layout=c.layout,
                                          predicted_s=c.predicted_s) for c in ranked]))
    stats = rt.SolveStats()
    tuned, tuned_ms, _ = timed_solve(rt, part, rt.SolveOptions(), stats=stats)
    off, off_ms, _ = timed_solve(rt, part, rt.SolveOptions(autotune="off"))
    same = same_fields(tuned, off)
    check(all(same.values()) and stats.autotuned == 1,
          f"the default (predict) solve differs from autotune='off': {same}, "
          f"autotuned={stats.autotuned}")
    emit("autotune_predict", classes=classes, lps=part.batch, bit_equal_to_off=same,
         autotuned=stats.autotuned, autotune_log=stats.autotune_log, wall_ms=tuned_ms,
         off_wall_ms=off_ms)
    return off


def autotune_trial_case(rt, dev, *, part, off):
    """``autotune.warm`` over :data:`WARM_CLASSES` with a cache file in a
    temporary directory (measured and predicted seconds a candidate), a warm
    process on the same file (0 trials), then a ``"trial"`` solve of
    ``part``: the cached winner, bit-equal to ``off``."""
    import tempfile

    from repro_torch.runtime import autotune

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        tuner = autotune.reset(cache_path=path)
        t0 = time.perf_counter()
        winners = autotune.warm(WARM_CLASSES, dtype=torch.float32, device=dev)
        warm_s = time.perf_counter() - t0
        check(tuner.trials_run > 0, "autotune.warm ran no trial on a cold cache")
        classes = [dict(m=m, n=n, batch=bsz, trial_batch=min(tuner.trial_batch, bsz),
                        winner=[w.backend, w.layout], source=w.source,
                        predicted_s=w.predicted_s, measured_s=w.measured_s,
                        candidates=[dict(backend=b, layout=lay, predicted_s=p, measured_s=t)
                                    for b, lay, p, t in w.trials])
                   for (m, n, bsz), w in zip(WARM_CLASSES, winners)]
        fresh = autotune.reset(cache_path=path)
        t0 = time.perf_counter()
        again = autotune.warm(WARM_CLASSES, dtype=torch.float32, device=dev)
        rewarm_s = time.perf_counter() - t0
        check(fresh.trials_run == 0 and all(a.source == "cache" for a in again) and
              [(a.backend, a.layout) for a in again] == [(w.backend, w.layout) for w in winners],
              f"a warm process re-tuned: {fresh.trials_run} trials")
        stats = rt.SolveStats()
        sol, wall_ms, _ = timed_solve(rt, part, rt.SolveOptions(backend="auto",
                                                                autotune="trial"), stats=stats)
        same = same_fields(sol, off)
        row = stats.autotune_log[0]
        check(fresh.trials_run == 0 and row["source"] == "cache",
              f"the trial solve did not take the cached winner: {row}")
        check(all(same.values()), f"the trial solve differs from autotune='off': {same}")
    autotune.reset()
    emit("autotune_trial", classes=classes, trials_run=tuner.trials_run, warm_s=warm_s,
         rewarm_trials_run=fresh.trials_run, rewarm_s=rewarm_s, trial_solve=dict(
             lps=part.batch, winner=[row["backend"], row["layout"]], source=row["source"],
             wall_ms=wall_ms, bit_equal_to_off=same))


def roofline_case(timer, dev):
    """The cost model's constants beside the card's name and power limit and a
    measured device-to-device copy of :data:`COPY_BYTES` (CUDA events; a
    measurement only, nothing is gated on it)."""
    from repro_torch.runtime import autotune, roofline

    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    ms = timer(lambda: dst.copy_(src), reps=5)
    moved = 2 * COPY_BYTES  # each byte read once and written once
    emit("roofline", nvidia_smi=smi_line(), hbm_bw=roofline.HBM_BW,
         peak_flops_fp32=roofline.PEAK_FLOPS, peak_flops_fp64=roofline.PEAK_FLOPS_FP64,
         machine_balance=roofline.MACHINE_BALANCE, launch_overhead_s=autotune.LAUNCH_OVERHEAD_S,
         host_op_s=autotune.HOST_OP_S, copy_bytes=COPY_BYTES, copy_ms=ms,
         copy_bytes_per_s=moved / (ms * 1e-3), copy_share_of_hbm_bw=moved / (ms * 1e-3)
         / roofline.HBM_BW)
    del src, dst
    torch.cuda.empty_cache()



# -- slice 9: the LM serve path (gemma2-2b at full width) ---------------------

#: The LM phase's config, and the committed reference fixture
#: (``tools/lm_reference_fixture.py``).
LM_ARCH = "gemma2-2b"
LM_FIXTURE = ROOT / "tests" / "data" / "lm_gemma2_2b_reference.npz"
#: ``lm_reference`` gates (float32 against the fixture), for every row
#: (prompt, step) on the stored vocabulary subset: max abs and relative L2
#: against the reference's float32 logits, each the larger of its floor
#: here and ``LM_NOISE_FACTOR`` times that row's float32 noise (the
#: reference's logits with every weight one ulp away); against the
#: reference's all-float64 logits, the larger of the floor and
#: ``LM_F64_FACTOR`` times the reference's own float32 error there; the
#: argmax wherever the fixture's top-2 margin exceeds ``LM_MARGIN``.  The
#: same run with TF32 products must fail the first gate.
LM_ABS_TOL = 5e-4
LM_REL_TOL = 1e-3
LM_NOISE_FACTOR = 4.0
LM_F64_FACTOR = 2.0
LM_MARGIN = 2e-3
#: ``lm_window``: prompts past the 4,096 window, decode steps, and the gate
#: of decode against the full forward.
LM_WINDOW_PROMPT = 4160
LM_WINDOW_STEPS = 32
LM_WINDOW_TOL = 1e-3
#: ``lm_serve`` (bfloat16): prompts, their length, greedy steps; the bf16
#: logits' relative L2 against the fixture may be at most this multiple of
#: the reference's own bf16-against-float32 error.
LM_SERVE_BATCH = 8
LM_SERVE_PROMPT = 4096
LM_SERVE_STEPS = 128
LM_BF16_FACTOR = 1.5
#: The serve rows' warm-up before their timed run: a prompt of this many
#: tokens, 4 steps.
LM_WARM_PROMPT = 128
#: H100 SXM data sheet: bfloat16 dense tensor-core peak.
PEAK_FLOPS_BF16 = 989e12


def lm_fixture_inputs(model, fixture) -> dict:
    """The prompt's inputs besides the tokens, for a fixture of a config
    that takes them: ``make_inputs``' frames and patch embeddings, made
    again in the fixture's ``input_dtype`` and held to its
    ``extras_digest``, and its stored M-RoPE ``positions``; empty for a
    fixture of tokens alone."""
    from repro_torch.configs import Shape, make_inputs
    from repro_torch.models.convert import weights_digest

    out = {}
    keys = [str(k) for k in np.asarray(fixture.get("extras_keys", np.zeros(0, str)))]
    if keys:
        b, p = np.asarray(fixture["tokens"]).shape[0], int(fixture["prompt_len"])
        cfg = dataclasses.replace(model.cfg, dtype=str(fixture["input_dtype"]))
        made = make_inputs(cfg, Shape("lm_reference", p, b, "prefill"), int(fixture["seed"]),
                           device=model.device)
        out = {k: made[k].float() for k in keys}
        digest = weights_digest({k: v.cpu().numpy() for k, v in out.items()})
        check(np.array_equal(digest, fixture["extras_digest"]),
              f"the {keys} made here differ from the fixture's")
    if "positions" in fixture:
        out["positions"] = torch.as_tensor(np.asarray(fixture["positions"]), device=model.device)
    return out


def lm_fixture_logits(model, fixture) -> torch.Tensor:
    """The port's logits (B, steps + 1, V) on the fixture's tokens: prefill
    of the prompts (with their frames, patch embeddings and positions, if
    any), then one decode step a reference token."""
    tokens = torch.as_tensor(np.asarray(fixture["tokens"]), device=model.device)
    p, steps = int(fixture["prompt_len"]), int(fixture["steps"])
    extras = lm_fixture_inputs(model, fixture)
    cache = model.init_cache(tokens.shape[0], p + steps,
                             enc_len=extras["frames"].shape[1] if "frames" in extras else 0)
    logits, _ = model.prefill({"tokens": tokens[:, :p], **extras}, cache)
    rows = [logits[:, -1]]
    for i in range(steps):
        logits, _ = model.decode_step({"tokens": tokens[:, p + i:p + i + 1]}, cache, p + i)
        rows.append(logits[:, -1])
    return torch.stack(rows, dim=1)


def lm_tolerances(fixture, case_f64: bool = False) -> dict:
    """``lm_reference``'s per-row gates for this fixture: (max abs, relative
    L2) against the reference's float32 logits and against its float64 ones.

    With ``case_f64`` (the slice-11 rows) every gate is also at least
    ``LM_F64_FACTOR`` times the largest error of the reference's own
    float32 logits against its float64 ones over all the fixture's rows.
    On those fixtures that error exceeds the ulp noise by up to 10x
    (qwen2-vl: 1.43e-3 relative in a row whose noise is 1.5e-4), so a row
    gate below it would reject the exact function itself."""
    tol = {
        "abs": np.maximum(LM_ABS_TOL, LM_NOISE_FACTOR * fixture["f32_noise_max_abs"]),
        "rel": np.maximum(LM_REL_TOL, LM_NOISE_FACTOR * fixture["f32_noise_rel_l2"]),
        "abs_f64": np.maximum(LM_ABS_TOL, LM_F64_FACTOR * fixture["f64_max_abs"]),
        "rel_f64": np.maximum(LM_REL_TOL, LM_F64_FACTOR * fixture["f64_rel_l2"]),
    }
    if case_f64:
        for kind, key in (("abs", "f64_max_abs"), ("rel", "f64_rel_l2")):
            floor = LM_F64_FACTOR * float(np.max(fixture[key]))
            for k in (kind, f"{kind}_f64"):
                tol[k] = np.maximum(tol[k], floor)
    return tol


def lm_f64_error(logits, fixture, tol) -> dict:
    """Logits (..., V) against the reference's all-float64 logits: the worst
    row's errors and the largest error over its row's tolerance."""
    got = logits.detach().double().cpu().numpy()[..., np.asarray(fixture["vocab_ids"])]
    want = np.asarray(fixture["logits_f64"], np.float64)
    abs_rows = np.abs(got - want).max(axis=-1)
    rel_rows = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    ratio = float(np.maximum(abs_rows / tol["abs_f64"], rel_rows / tol["rel_f64"]).max())
    return {"f64_max_abs_err": float(abs_rows.max()), "f64_rel_l2": float(rel_rows.max()),
            "f64_worst_ratio": ratio}


def lm_reference_case(model, fixture, phase="lm_reference", case_f64=False) -> dict:
    """``lm_reference``: the float32 port against the reference's fixture;
    on the card, the same run with TF32 products as a control that the
    gate must reject.  ``phase`` names the line; ``case_f64`` as
    ``lm_tolerances``."""
    from repro_torch.models.convert import compare_to_summary

    tol = lm_tolerances(fixture, case_f64)
    logits = lm_fixture_logits(model, fixture)
    res = compare_to_summary(logits, fixture, abs_tol=tol["abs"], rel_tol=tol["rel"],
                             margin=LM_MARGIN)
    res.update(lm_f64_error(logits, fixture, tol))
    res["ok"] = res["ok"] and res["f64_worst_ratio"] <= 1.0
    control = None
    if model.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = lm_fixture_logits(model, fixture)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        control = compare_to_summary(tf32, fixture, abs_tol=tol["abs"], rel_tol=tol["rel"],
                                     margin=LM_MARGIN)
        control.update(lm_f64_error(tf32, fixture, tol))
    emit(phase, arch=model.cfg.name, dtype=str(model.final_norm.dtype),
         tokens=list(np.asarray(fixture["tokens"]).shape), steps=int(fixture["steps"]),
         subset=int(np.asarray(fixture["vocab_ids"]).size),
         abs_tol=tol["abs"].tolist(), rel_tol=tol["rel"].tolist(),
         abs_tol_f64=tol["abs_f64"].tolist(), rel_tol_f64=tol["rel_f64"].tolist(),
         margin=LM_MARGIN, case_f64=case_f64,
         f32_noise_rel_l2=np.asarray(fixture["f32_noise_rel_l2"]).tolist(),
         reference_f32_vs_f64_rel_l2=np.asarray(fixture["f64_rel_l2"]).tolist(),
         tf32_control=control, **res)
    check(res["ok"], f"{phase}: the port differs from the reference's fixture: {res}")
    check(control is None or not control["ok"],
          f"{phase}: the gate passes the TF32 control too: {control}")
    return res


def lm_window_case(model, *, seed, prompt=LM_WINDOW_PROMPT, steps=LM_WINDOW_STEPS,
                   batch=2) -> dict:
    """``lm_window``: prefill past the sliding window, then decode steps fed
    the same tokens; each step's logits against the full forward's at that
    position, and the forward with every layer global against it (equal
    below the window, different from it on)."""
    from repro_torch.configs import Shape, make_inputs

    cfg = model.cfg
    dev = model.device
    tokens = make_inputs(cfg, Shape("lm_window", prompt + steps, batch, "prefill"), seed,
                         device=dev)["tokens"]
    t0 = time.perf_counter()
    cache = model.init_cache(batch, prompt + steps)
    logits, _ = model.prefill({"tokens": tokens[:, :prompt]}, cache)
    rows = [logits[:, 0]]
    for t in range(prompt, prompt + steps - 1):
        logits, _ = model.decode_step({"tokens": tokens[:, t:t + 1]}, cache, t)
        rows.append(logits[:, 0])
    decoded = torch.stack(rows, dim=1)
    idx = torch.arange(prompt - 1, prompt + steps - 1, device=dev)
    with torch.inference_mode():
        full = model.logits(model.forward({"tokens": tokens})[:, idx])
        windows = [layer.window for layer in model.layers]
        for layer in model.layers:
            layer.window = None
        try:
            glob = model.logits(model.forward({"tokens": tokens})[:, idx])
        finally:
            for layer, w in zip(model.layers, windows):
                layer.window = w
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    err = float((decoded - full).abs().max())
    past = idx >= cfg.sliding_window
    global_diff_past = float((glob[:, past] - full[:, past]).abs().max()) if past.any() else 0.0
    global_diff_before = (float((glob[:, ~past] - full[:, ~past]).abs().max())
                          if (~past).any() else 0.0)
    res = dict(decode_vs_forward_max_abs=err, tol=LM_WINDOW_TOL,
               global_vs_local_past_window_max_abs=global_diff_past,
               global_vs_local_before_window_max_abs=global_diff_before)
    emit("lm_window", arch=cfg.name, window=cfg.sliding_window, prompt=prompt, steps=steps,
         batch=batch, positions=[int(idx[0]), int(idx[-1])], wall_s=wall, **res)
    check(err <= LM_WINDOW_TOL, f"lm_window: decode differs from the full forward by {err}")
    check(global_diff_past > 10 * LM_WINDOW_TOL,
          f"lm_window: the local windows change nothing past the window: {res}")
    return res


def lm_param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


#: Block kinds whose causal self-attention over the cache a decode step runs.
LM_SELF_ATTENTION = ("gqa_dense", "gqa_moe", "dec_cross")


def lm_self_windows(model) -> list:
    """The window (None for none) of each causal self-attention a token
    passes: the attention layers', then zamba2's shared sites'."""
    return ([w for k, w in zip(model.kinds(), model.windows()) if k in LM_SELF_ATTENTION]
            + [None] * model.shared_sites())


def lm_keys(windows, q) -> int:
    """Keys the query at position ``q`` attends, summed over the layers."""
    return sum(min(q + 1, w) if w else q + 1 for w in windows)


def lm_ssd_flops(cfg, batch, s) -> float:
    """Matrix-product FLOPs of one mamba layer's chunked SSD scan over
    ``s`` tokens (float32; the last chunk padded): C B^T, (C B^T * L) x,
    the chunk states and the state-to-output product."""
    q = min(cfg.ssm_chunk, s)
    nc = -(-s // q)
    h, p, n, g = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    return 2.0 * batch * nc * (g * q * q * n + h * q * q * p + 2 * h * p * n * q)


def lm_prefill_flops(model, batch, s, enc_len=0) -> dict:
    """Matrix-product and attention FLOPs a prefill needs, by type:
    ``bf16`` the projections for every token (attention, MLP, the mamba
    in/out projections and conv taps), causal (and windowed) scores and
    PV, the encoder's bidirectional attention over ``enc_len`` frames and
    the decoder's cross attention over them, and the unembedding of the
    last position; ``f32`` the SSD scans, which the reference computes in
    float32."""
    cfg = model.cfg
    kinds = model.kinds()
    d, tokens = cfg.d_model, batch * s
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    mlp = 3 * d * cfg.d_ff
    blocks = sum(k in ("gqa_dense", "dec_cross") for k in kinds) + model.shared_sites()
    keys = sum(lm_keys(lm_self_windows(model), q) for q in range(s))
    score = 4.0 * cfg.num_heads * cfg.head_dim
    bf16 = 2.0 * tokens * (attn + mlp) * blocks + score * batch * keys
    n_mamba = kinds.count("mamba")
    if n_mamba:
        di, gn, h = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_heads
        per_token = d * (2 * di + 2 * gn + h) + di * d + cfg.ssm_conv * (di + 2 * gn)
        bf16 += 2.0 * tokens * per_token * n_mamba
    n_enc, n_dec = kinds.count("enc"), kinds.count("dec_cross")
    if n_enc:
        bf16 += n_enc * (2.0 * batch * enc_len * (attn + mlp) + score * batch * enc_len * enc_len)
    if n_dec:
        bf16 += n_dec * (2.0 * tokens * 2 * d * cfg.q_dim + 2.0 * batch * enc_len * 2 * d * cfg.kv_dim
                         + score * batch * s * enc_len)
    bf16 += 2.0 * batch * d * cfg.padded_vocab
    return {"bf16": bf16, "f32": n_mamba * lm_ssd_flops(cfg, batch, s)}


def lm_prefill_bound_ms(flops) -> float:
    return (flops["bf16"] / PEAK_FLOPS_BF16 + flops["f32"] / PEAK_FLOPS[torch.float32]) * 1e3


def lm_decode_kv_bytes(model, batch, index, item, enc_len=0) -> int:
    """Cache bytes a decode step at ``index`` moves: the K and V slots each
    self-attention attends, each decoder layer's cross K and V over
    ``enc_len`` frames, and each mamba layer's conv window (in ``item``
    bytes) and float32 SSM state, read and written."""
    cfg = model.cfg
    kinds = model.kinds()
    kv = 2 * batch * cfg.num_kv_heads * cfg.head_dim * lm_keys(lm_self_windows(model), index)
    cross = kinds.count("dec_cross") * 2 * batch * cfg.num_heads * cfg.head_dim * enc_len
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    mamba = kinds.count("mamba") * 2 * batch * (
        (cfg.ssm_conv - 1) * conv_ch * item + cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4)
    return (kv + cross) * item + mamba


def timed_generate(engine, model, inputs, steps):
    """``engine.generate`` greedy, with a CUDA event recorded as the prefill
    and each decode step return and the peak memory counter reset first.
    Returns (tokens, wall s, prefill ms, decode ms a step, each call's
    last logits)."""
    events, rows = [], []

    def mark():
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    def timed(call):
        """``call`` with a CUDA event recorded as it returns; its logits kept."""
        def wrapped(*args):
            logits, cache = call(*args)
            mark()
            rows.append(logits[:, -1])
            return logits, cache
        return wrapped

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.prefill, model.decode_step = timed(model.prefill), timed(model.decode_step)
    t0 = time.perf_counter()
    try:
        mark()
        out = engine.generate(inputs, steps=steps)
        torch.cuda.synchronize()
    finally:
        del model.prefill, model.decode_step  # the methods again
    wall = time.perf_counter() - t0
    prefill_ms = events[0].elapsed_time(events[1])
    step_ms = np.array([a.elapsed_time(b) for a, b in zip(events[1:], events[2:])])
    return out, wall, prefill_ms, step_ms, rows


def lm_serve_case(model, fixture, ref_rel, *, seed, counters, batch=LM_SERVE_BATCH,
                  prompt=LM_SERVE_PROMPT, steps=LM_SERVE_STEPS) -> dict:
    """``lm_serve``: ``Engine.generate`` with no ``device`` argument (the
    card) on bfloat16 weights, greedy; prefill and decode times beside their
    bounds, peak memory, the port's kernel launches (none on this path), and
    the fixture's prompts in bfloat16 against the fixture."""
    from repro_torch.configs import Shape, make_inputs
    from repro_torch.models.convert import rel_l2
    from repro_torch.serve.engine import Engine

    cfg = model.cfg
    dev = model.device
    engine = Engine(model, max_len=prompt + steps)
    tokens = make_inputs(cfg, Shape("lm_serve", prompt, batch, "prefill"), seed + 2,
                         device=dev)["tokens"]
    engine.generate({"tokens": tokens[:, :128]}, steps=4)  # warm-up: handles, allocator
    before = launch_counts(counters)
    out, wall, prefill_ms, step_ms, rows = timed_generate(engine, model, {"tokens": tokens}, steps)
    launched = count_delta(counters, before)
    peak = torch.cuda.max_memory_allocated()
    all_finite = bool(torch.isfinite(torch.stack(rows)).all())  # after the last event
    weights = lm_param_bytes(model)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    kv = [lm_decode_kv_bytes(model, batch, prompt + i, item) for i in range(steps - 1)]
    decode_bound = (weights + float(np.median(kv))) / HBM_BYTES_PER_S * 1e3
    prefill_flops = lm_prefill_flops(model, batch, prompt)["bf16"]
    prefill_bound = prefill_flops / PEAK_FLOPS_BF16 * 1e3
    logits16 = lm_fixture_logits(model, fixture).float().cpu().numpy()
    ids = np.asarray(fixture["vocab_ids"])
    got, ref = logits16[..., ids].astype(np.float64), np.asarray(fixture["logits"], np.float64)
    rel_all = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    res = dict(
        prefill_ms=prefill_ms, prefill_tokens_per_s=batch * prompt / (prefill_ms * 1e-3),
        prefill_bound_ms=prefill_bound, prefill_flops=prefill_flops,
        decode_ms_median=float(np.median(step_ms)), decode_ms_p90=float(np.percentile(step_ms, 90)),
        decode_tokens_per_s=batch / (float(np.median(step_ms)) * 1e-3),
        decode_bound_ms=decode_bound, weight_bytes=weights, kv_bytes_median=float(np.median(kv)),
        wall_s=wall, peak_memory_bytes=peak, port_kernel_launches=launched,
        all_logits_finite=all_finite, tokens_in_vocab=bool(((out >= 0) & (out < cfg.vocab_size)).all()),
        bf16_rel_l2=rel_all, bf16_rel_l2_rows_max=float(rel_l2(got, ref).max()),
        reference_bf16_rel_l2=ref_rel, bf16_limit=LM_BF16_FACTOR * ref_rel,
    )
    emit("lm_serve", arch=cfg.name, dtype=cfg.dtype, batch=batch, prompt=prompt, steps=steps,
         nvidia_smi=smi_line(), **res)
    check(all_finite and res["tokens_in_vocab"], f"lm_serve: non-finite logits or bad tokens: {res}")
    check(not any(launched.values()), f"lm_serve: the LM path launched a kernel of the port: {launched}")
    check(rel_all <= LM_BF16_FACTOR * ref_rel,
          f"lm_serve: bf16 logits {rel_all} from the fixture, past {LM_BF16_FACTOR} x {ref_rel}")
    return res


def lm_phase(rt_configs, dev, *, seed, counters) -> dict:
    """Slice 9: gemma2-2b at full width, float32 (``lm_reference``,
    ``lm_window``) then bfloat16 (``lm_serve``), weights from
    ``reference_weights`` copied to the card."""
    from repro_torch.models import Model
    from repro_torch.models.convert import (load_reference_params, reference_weights,
                                            weights_digest)

    check(LM_FIXTURE.exists(), f"the LM fixture {LM_FIXTURE} is missing")
    fixture = dict(np.load(LM_FIXTURE))
    cfg = rt_configs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    tree = reference_weights(cfg, int(fixture["seed"]))
    gen_s = time.perf_counter() - t0
    check(np.array_equal(weights_digest(tree), fixture["weights_digest"]),
          "the weights drawn here differ from the fixture's (another NumPy stream?)")
    before = launch_counts(counters)
    t0 = time.perf_counter()
    model = load_reference_params(Model(dataclasses.replace(cfg, dtype="float32"), device=dev), tree)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    emit("lm_setup", arch=cfg.name, params=sum(p.numel() for p in model.parameters()),
         param_count=cfg.param_count(), weights_s=gen_s, load_s=load_s,
         shared_tree_wait_s=wait_shared_tree(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    ref = lm_reference_case(model, fixture)
    win = lm_window_case(model, seed=seed)
    del model
    torch.cuda.empty_cache()
    model = load_reference_params(Model(cfg, device=dev), tree)
    del tree
    serve = lm_serve_case(model, fixture, float(fixture["bf16_rel_l2_all"]), seed=seed,
                          counters=counters)
    launched = count_delta(counters, before)
    check(not any(launched.values()), f"the LM phase launched a kernel of the port: {launched}")
    emit("main_path_summary", path="slice9_lm", launches=launched)
    del model
    torch.cuda.empty_cache()
    return dict(reference=ref, window=win, serve=serve)


# -- slice 10: MoE with the LP router and MLA (deepseek-v2-lite-16b) ----------

#: The MoE phases' config, and its committed reference fixture
#: (``tools/lm_reference_fixture.py --arch deepseek-v2-lite-16b --layers 3
#: --router topk,lp``): full width, cut to the fixture's depth for
#: ``lm_moe_reference``; full depth for ``lm_moe_serve``.
LM_MOE_ARCH = "deepseek-v2-lite-16b"
LM_MOE_FIXTURE = ROOT / "tests" / "data" / "lm_deepseek_v2_lite_reference.npz"
LM_MOE_ROUTERS = ("topk", "lp")
#: The fixture's router LPs through the kernel: status, iterations and basis
#: exact, x within this.
LM_MOE_X_TOL = 1e-6
#: A port LP whose basis differs from the reference's passes only if the
#: reduced costs that decided the first differing pivot lie within the
#: float32 rounding of the affinities: this multiple of n * 2**-23 (relative),
#: n the tokens a group's affinity averages (the worst-case relative
#: rounding of a float32 sum of n terms).
LM_MOE_GAP_FACTOR = 4.0
#: ``lm_moe_serve``: the calls (the prefill, then decode steps) whose
#: router LPs are captured and re-run through the plain version.
LM_MOE_CAPTURE_CALLS = 3


class SimplexSpy:
    """``simplex_cuda.simplex`` wrapped for the length of a ``with``: it
    counts the calls, and for the first ``limit`` (all if None) keeps
    clones of the call's inputs and of its outputs (the terminal basis
    too, which the kernel writes in place) for replay on the plain
    version.  The clones are queued on the stream behind the launch;
    nothing waits for them."""

    def __init__(self, simplex_cuda, limit=None):
        self.mod = simplex_cuda
        self.limit = limit
        self.calls = 0
        self.records = []

    def __enter__(self):
        self.orig = self.mod.simplex
        self.mod.simplex = self._call
        return self

    def __exit__(self, *exc):
        self.mod.simplex = self.orig

    def _call(self, tab, basis, phase, c_ext, feas, cap, **kw):
        self.calls += 1
        keep = self.limit is None or len(self.records) < self.limit
        inputs = [t.clone() for t in (tab, basis, phase, c_ext, feas)] if keep else None
        out = self.orig(tab, basis, phase, c_ext, feas, cap, **kw)
        if keep:
            self.records.append(dict(inputs=inputs, cap=cap, kw=kw, basis=basis.clone(),
                                     out=[t.clone() for t in out]))
        return out


def replay_plain(rec) -> bool:
    """A captured launch's inputs through ``simplex_plain``: the same
    objective, x, status, iterations and terminal basis, bit for bit."""
    from repro_torch.kernels import simplex_cuda

    tab, basis, phase, c_ext, feas = (t.clone() for t in rec["inputs"])
    out = simplex_cuda.simplex_plain(tab, basis, phase, c_ext, feas, rec["cap"], **rec["kw"])
    return all(torch.equal(bits(a), bits(b))
               for a, b in zip(list(out) + [basis], rec["out"] + [rec["basis"]]))


def with_router(model, router: str):
    """The loaded model with ``cfg.router`` set to ``router`` in every module."""
    cfg = dataclasses.replace(model.cfg, router=router)
    for mod in model.modules():
        if hasattr(mod, "cfg"):
            mod.cfg = cfg
    return model


def moe_layer_count(model) -> int:
    return sum(kind.endswith("_moe") for kind in model.kinds())


def router_lp_divergence(a, b, c_port, c_ref, cap) -> dict:
    """Where the port's LP (``c_port``) and the reference's (``c_ref``) part:
    both run a pivot at a time on the plain version (CPU, float32) until
    their bases differ; the relative gap between the reduced costs of the
    two entering columns, on the port's tableau before that pivot."""
    from repro_torch.core import simplex
    from repro_torch.core.tableau import build_tableau

    a, b = a.cpu()[None], b.cpu()[None]
    c_port, c_ref = c_port.cpu()[None], c_ref.cpu()[None]
    m = a.shape[1]
    tab, basis, _ = build_tableau(a, b, c_port)
    for step in range(1, cap + 1):
        sp, st = simplex.solve_batched(a, b, c_port, max_iters=step, want_state=True)
        sr = simplex.solve_batched(a, b, c_ref, max_iters=step)
        if not torch.equal(sp.basis, sr.basis):
            obj = tab[0, m]
            new_p = sorted(set(sp.basis[0].tolist()) - set(basis[0].tolist()))
            new_r = sorted(set(sr.basis[0].tolist()) - set(basis[0].tolist()))
            rp, rr = float(obj[new_p[0]]), float(obj[new_r[0]])
            return dict(pivot=step, port_column=new_p[0], reference_column=new_r[0],
                        port_reduced_cost=rp, reference_reduced_cost=rr,
                        gap=abs(rp - rr) / max(abs(rp), abs(rr), 1e-30))
        if int(sp.status[0]) != 0 and int(sr.status[0]) != 0:
            break
        tab, basis = st.tab, st.basis
    return dict(pivot=None, gap=None)


def router_lp_checks(view, records, dev, groups: int) -> dict:
    """``lm_moe_reference``'s LP gates: the fixture's own router LPs through
    the kernel (status, iterations and basis exact, x within
    ``LM_MOE_X_TOL``), and each LP the port built from its own affinities
    (``records``, in the fixture's call order) against the reference's
    basis; a differing basis passes only within the affinities' rounding
    (``LM_MOE_GAP_FACTOR``; ``groups`` is the router's G)."""
    from repro_torch.kernels import ops

    a, b, c = (torch.as_tensor(np.asarray(view[f"router_{k}"]), device=dev) for k in "abc")
    nlp, m, n = a.shape
    cap = 8 * (m + n)
    sol = ops.simplex_solve(a, b, c, max_iters=cap)
    ref = {k: np.asarray(view[f"router_{k}"]) for k in ("status", "iterations", "basis", "x")}
    fixture_on_kernel = dict(
        lps=nlp, m=m, n=n,
        status_equal=bool(np.array_equal(sol.status.cpu().numpy(), ref["status"])),
        iterations_equal=bool(np.array_equal(sol.iterations.cpu().numpy(), ref["iterations"])),
        basis_equal=bool(np.array_equal(sol.basis.cpu().numpy(), ref["basis"])),
        x_max_abs_err=float(np.abs(sol.x.cpu().numpy() - ref["x"]).max()),
        iterations=sorted(set(ref["iterations"].tolist())))
    check(len(records) >= nlp, f"the port solved {len(records)} router LPs, the fixture has {nlp}")
    calls, layers = np.asarray(view["router_call"]), np.asarray(view["router_layer"])
    batch, prompt = np.asarray(view["tokens"]).shape[0], int(view["prompt_len"])
    lines, c_gap_max = [], 0.0
    for i, rec in enumerate(records[:nlp]):
        c_port = rec["inputs"][3][0, 1:1 + n].float()
        basis = rec["basis"][0].cpu().numpy()
        c_ref = c[i]
        c_gap = float((c_port - c_ref).abs().max() / c_ref.abs().max().clamp_min(1e-30))
        a_port = rec["inputs"][0][0, :m, 1:1 + n]
        c_gap_max = max(c_gap_max, c_gap)
        if np.array_equal(basis, ref["basis"][i]) and torch.equal(a_port, a[i]):
            continue
        div = router_lp_divergence(a[i], b[i], c_port, c_ref, cap)
        tokens = batch * prompt if calls[i] == 0 else batch
        rounding = LM_MOE_GAP_FACTOR * math.ceil(tokens / groups) * 2.0 ** -23
        ok = div["gap"] is not None and div["gap"] <= rounding
        lines.append(dict(lp=i, call=int(calls[i]), layer=int(layers[i]),
                          a_equal=bool(torch.equal(a_port, a[i])),
                          affinity_rel_gap=c_gap, rounding=rounding, within_rounding=ok,
                          **div))
    res = dict(fixture_on_kernel=fixture_on_kernel, port_lps=nlp,
               port_basis_equal=nlp - len(lines), affinity_rel_gap_max=c_gap_max,
               divergences=lines)
    res["ok"] = (fixture_on_kernel["status_equal"] and fixture_on_kernel["iterations_equal"]
                 and fixture_on_kernel["basis_equal"]
                 and fixture_on_kernel["x_max_abs_err"] <= LM_MOE_X_TOL
                 and all(d["within_rounding"] for d in lines))
    return res


def lm_moe_reference_case(model, model16, fixture, router, *, counters) -> dict:
    """``lm_moe_reference`` for one router: the float32 model against the
    fixture (``lm_reference_case``'s gates, TF32 control included), the
    router LPs under ``lp``, and the bfloat16 model within
    ``LM_BF16_FACTOR`` times the reference's own bfloat16 gap."""
    from repro_torch.kernels import simplex_cuda
    from repro_torch.models.convert import fixture_view

    view = fixture_view(fixture, router)
    with_router(model, router)
    with_router(model16, router)
    before = launch_counts(counters)
    with SimplexSpy(simplex_cuda) as spy:
        res = lm_reference_case(model, view, phase=f"lm_moe_reference_{router}")
    launched = count_delta(counters, before)
    runs = 2 if model.device.type == "cuda" else 1  # the TF32 control runs too
    calls = int(view["steps"]) + 1
    expect = runs * calls * moe_layer_count(model) if router == "lp" else 0
    check(spy.calls == expect, f"lm_moe_reference {router}: {spy.calls} router LPs, not {expect}")
    check(model.device.type != "cuda" or launched["simplex"] == expect,
          f"lm_moe_reference {router}: {launched['simplex']} simplex launches, not {expect}")
    out = dict(router=router, logits=res, router_lps_solved=spy.calls,
               simplex_launches=launched["simplex"])
    if router == "lp":
        out["router_lp"] = router_lp_checks(view, spy.records, model.device,
                                            model.cfg.router_groups)
    logits16 = lm_fixture_logits(model16, view).float().cpu().numpy()[..., view["vocab_ids"]]
    ref = np.asarray(view["logits"], np.float64)
    rel = float(np.linalg.norm(logits16 - ref) / np.linalg.norm(ref))
    out.update(bf16_rel_l2=rel, reference_bf16_rel_l2=float(view["bf16_rel_l2_all"]),
               bf16_limit=LM_BF16_FACTOR * float(view["bf16_rel_l2_all"]))
    emit("lm_moe_reference", **{k: v for k, v in out.items() if k != "logits"},
         logits_worst_ratio=res["worst_ratio"])
    if router == "lp":
        check(out["router_lp"]["ok"], f"lm_moe_reference: router LPs: {out['router_lp']}")
    check(rel <= out["bf16_limit"],
          f"lm_moe_reference {router}: bf16 logits {rel} from the fixture, past {out['bf16_limit']}")
    return out


class RoutingStats:
    """``models.moe.dispatch`` wrapped for the length of a ``with``: keeps
    each call's expert choices and kept mask (references; the counting
    waits until the run is over)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self.mod, self.orig = moe, moe.dispatch

        def spy(experts, cap, num_experts):
            out = self.orig(experts, cap, num_experts)
            self.calls.append((experts, out[2], num_experts))
            return out

        moe.dispatch = spy
        return self

    def __exit__(self, *exc):
        self.mod.dispatch = self.orig

    def summary(self, prefill_tokens: int) -> dict:
        """Dropped share and the heaviest expert's load over the mean (of
        each MoE layer, its loads summed over the part's calls), for the
        prefill and for the decode steps."""
        prefill = [c for c in self.calls if c[0].shape[0] == prefill_tokens]
        decode = [c for c in self.calls if c[0].shape[0] != prefill_tokens]
        n_layers = max(1, len(prefill))  # the prefill calls each MoE layer once
        out = {}
        for name, calls in (("prefill", prefill), ("decode", decode)):
            if not calls:
                continue
            loads = [sum(torch.bincount(c[0].reshape(-1), minlength=c[2]).double()
                         for c in calls[i::n_layers]) for i in range(min(n_layers, len(calls)))]
            ratios = [float(load.max() / load.mean()) for load in loads]
            assigned = sum(c[1].numel() for c in calls)
            dropped = int(sum((~c[1]).sum() for c in calls))
            out[name] = dict(calls=len(calls), assignments=assigned, dropped=dropped,
                             dropped_share=dropped / assigned,
                             max_over_mean_max=max(ratios),
                             max_over_mean_mean=float(np.mean(ratios)))
        return out

    def kept(self, tokens: int) -> int:
        """Kept assignments of the calls over ``tokens`` tokens."""
        return int(sum(c[1].sum() for c in self.calls if c[0].shape[0] == tokens))


def lm_moe_prefill_flops(model, batch, s, kept) -> float:
    """Matrix-product FLOPs a prefill needs: every layer's attention
    projections (MLA's, or GQA's where the config has no latent rank) and
    causal scores, the dense FFN, the router, the ``kept`` expert
    assignments (this run's count) and the shared experts, and the
    unembedding of the last position."""
    cfg = model.cfg
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    tokens = batch * s
    keys = batch * s * (s + 1) // 2
    if r:
        qk, v = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
        attn = (2 * tokens * (d * h * qk + d * (r + cfg.qk_rope_dim)
                              + r * h * (cfg.qk_nope_dim + v) + h * v * d)
                + 2 * keys * h * (qk + v))
    else:
        attn = (2 * tokens * (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim)
                + 4 * keys * h * cfg.head_dim)
    kinds = model.kinds()
    dense = (sum(k.endswith("_dense") for k in kinds) * 6 * tokens * d
             * (cfg.d_ff_dense or cfg.d_ff))
    n_moe = sum(k.endswith("_moe") for k in kinds)
    moe = (n_moe * tokens * (2 * d * cfg.num_experts + 6 * d * cfg.d_ff * cfg.num_shared_experts)
           + kept * 6 * d * cfg.d_ff)
    return float(len(kinds) * attn + dense + moe + 2 * batch * d * cfg.padded_vocab)


def lm_moe_serve_case(model, router, *, seed, counters, batch=LM_SERVE_BATCH,
                      prompt=LM_SERVE_PROMPT, steps=LM_SERVE_STEPS, row="lm_moe_serve",
                      capture_calls=LM_MOE_CAPTURE_CALLS) -> dict:
    """``row`` (``lm_moe_serve``) for one router: ``Engine.generate`` with
    no device argument on the loaded model, greedy; prefill and decode
    times beside their bounds, peak memory, the routing's dropped share and
    expert load, the simplex launches (0 under ``topk``, one a MoE layer a
    call under ``lp``, all of the cluster variant), and the router LPs of
    the first ``capture_calls`` calls (None: of every call) re-run through
    the plain version.  MLA models cache latents, GQA ones (dbrx) K and V."""
    from repro_torch.configs import Shape, make_inputs
    from repro_torch.kernels import simplex_cuda
    from repro_torch.serve.engine import Engine

    with_router(model, router)
    cfg = model.cfg
    n_moe = moe_layer_count(model)
    engine = Engine(model, max_len=prompt + steps)
    tokens = make_inputs(cfg, Shape("lm_moe_serve", prompt, batch, "prefill"), seed + 3,
                         device=model.device)["tokens"]
    engine.generate({"tokens": tokens[:, :LM_WARM_PROMPT]}, steps=4)  # warm-up: handles, build
    engine.cache = None
    before = launch_counts(counters)
    captured = (steps if capture_calls is None else capture_calls) * n_moe
    with SimplexSpy(simplex_cuda, limit=captured) as spy, \
            RoutingStats() as routing:
        out, wall, prefill_ms, step_ms, rows = timed_generate(engine, model, {"tokens": tokens},
                                                              steps)
    launched = count_delta(counters, before)
    peak = torch.cuda.max_memory_allocated()
    all_finite = bool(torch.isfinite(torch.stack(rows)).all())
    expect = steps * n_moe if router == "lp" else 0
    replayed = [replay_plain(rec) for rec in spy.records]
    stats = routing.summary(batch * prompt)
    kept = routing.kept(batch * prompt)
    del routing
    weights = lm_param_bytes(model)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    if cfg.kv_lora_rank:
        cache_bytes = [len(model.kinds()) * batch * (prompt + i + 1)
                       * (cfg.kv_lora_rank + cfg.qk_rope_dim) * item for i in range(steps - 1)]
    else:
        cache_bytes = [lm_decode_kv_bytes(model, batch, prompt + i, item)
                       for i in range(steps - 1)]
    decode_bound = (weights + float(np.median(cache_bytes))) / HBM_BYTES_PER_S * 1e3
    flops = lm_moe_prefill_flops(model, batch, prompt, kept)
    res = dict(
        router=router, prefill_ms=prefill_ms,
        prefill_tokens_per_s=batch * prompt / (prefill_ms * 1e-3),
        prefill_bound_ms=flops / PEAK_FLOPS_BF16 * 1e3, prefill_flops=flops,
        decode_ms_median=float(np.median(step_ms)), decode_ms_p90=float(np.percentile(step_ms, 90)),
        decode_tokens_per_s=batch / (float(np.median(step_ms)) * 1e-3),
        decode_bound_ms=decode_bound, weight_bytes=weights,
        cache_bytes_median=float(np.median(cache_bytes)), wall_s=wall, peak_memory_bytes=peak,
        routing=stats, router_lps=spy.calls, port_kernel_launches=launched,
        captured_lps=len(spy.records), captured_bit_identical=sum(replayed),
        all_logits_finite=all_finite,
        tokens_in_vocab=bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    emit(row, arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers, batch=batch,
         prompt=prompt, steps=steps, nvidia_smi=smi_line(), **res)
    check(all_finite and res["tokens_in_vocab"],
          f"{row} {router}: non-finite logits or bad tokens")
    check(spy.calls == expect and launched["simplex"] == expect
          and launched["simplex.cluster"] == expect,
          f"{row} {router}: {spy.calls} router LPs, launches {launched}, not {expect}")
    check(not any(v for k, v in launched.items() if not k.startswith("simplex")),
          f"{row} {router}: another kernel of the port launched: {launched}")
    check(len(spy.records) == (captured if router == "lp" else 0) and all(replayed),
          f"{row} {router}: {sum(replayed)} of {len(replayed)} captured router LPs "
          "bit-identical to simplex_plain")
    if router == "lp":
        res["_records"] = spy.records
    return res


def lm_moe_reference_rows(rt_configs, dev, arch, path, *, counters,
                          setup="lm_moe_setup") -> dict:
    """``lm_moe_reference`` for each of the fixture's routers: ``arch`` at
    full width cut to the fixture's depth, weights from ``reference_weights``
    (checked against its digest), float32 and bfloat16 on one loaded pair
    of models (``lm_moe_reference_case``); a ``setup`` line first."""
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, weights_digest

    check(path.exists(), f"the MoE fixture {path} is missing")
    fixture = dict(np.load(path))
    cfg = rt_configs.get_config(arch)
    cut = dataclasses.replace(cfg, num_layers=int(fixture["layers"]))
    t0 = time.perf_counter()
    tree = reference_tree(cut, int(fixture["seed"]))
    gen_s = time.perf_counter() - t0
    check(np.array_equal(weights_digest(tree), fixture["weights_digest"]),
          f"the {arch} weights drawn here differ from the fixture's")
    t0 = time.perf_counter()
    model = load_reference_params(Model(dataclasses.replace(cut, dtype="float32"), device=dev),
                                  tree)
    model16 = load_reference_params(Model(cut, device=dev), tree)
    del tree
    load_s = time.perf_counter() - t0
    emit(setup, arch=cfg.name, layers=cut.num_layers, kinds=model.kinds(),
         params=sum(p.numel() for p in model.parameters()), param_count=cut.param_count(),
         full_param_count=cfg.param_count(), weights_s=gen_s, load_s=load_s)
    routers = [str(r) for r in np.asarray(fixture["routers"])]
    out = {r: lm_moe_reference_case(model, model16, fixture, r, counters=counters)
           for r in routers}
    del model, model16
    torch.cuda.empty_cache()
    return out


def lm_router_lp_case(serve, dev, *, n_moe, launches, row="lm_router_lp") -> dict:
    """The router's LP on the simplex kernel against its plain version
    (``simplex_case``) at its prefill shape: the ``lp`` serve row's first
    captured LP (the prefill's first MoE layer); its ms beside the serve
    row's decode step, ``launches`` the path's simplex count."""
    from repro_torch.core.lp import LPBatch

    rec = serve["lp"].pop("_records")[0]
    tab = rec["inputs"][0]
    spec = rec["kw"]["spec"]
    a = tab[:, :spec.m, 1:1 + spec.n].clone()
    b = tab[:, :spec.m, 0].clone()
    c = rec["inputs"][3][:, 1:1 + spec.n].clone()
    kernel = simplex_case(Timer(dev), name=f"lm_router_{spec.m}x{spec.n}_f32_lpc",
                          batch=LPBatch(a, b, c), cap=rec["cap"], reps=20, want="cluster")
    lp_ms = kernel["kernel_ms"]
    router = dict(case=kernel["case"], m=spec.m, n=spec.n, kernel_ms=lp_ms,
                  plain_ms=kernel["plain_ms"], bound_ms=kernel["bound_ms"],
                  bound_by=kernel["bound_by"], max_abs_err=kernel["max_abs_err"],
                  pivots=kernel["pivots"], variant=kernel["variant"], k=kernel["k"],
                  launches=launches,
                  lp_kernel_share_of_decode_step=n_moe * lp_ms / serve["lp"]["decode_ms_median"],
                  lp_decode_step_over_topk=serve["lp"]["decode_ms_median"]
                  / serve["topk"]["decode_ms_median"])
    emit(row, nvidia_smi=smi_line(), **router)
    return router


def lm_moe_phase(rt_configs, dev, *, seed, counters, reset) -> dict:
    """Slice 10: deepseek-v2-lite-16b at full width.  ``lm_moe_reference``
    (the fixture's depth, float32 and bfloat16, weights from
    ``reference_weights``) for each router, then ``lm_moe_serve`` (full
    depth, bfloat16, ``Model.init`` on the card) for each router on one
    loaded model, with the launch counts set to 0 before and read after;
    then the router's LP on the simplex kernel against its plain version
    (``lm_router_lp_case``) at its prefill shape."""
    reference = lm_moe_reference_rows(rt_configs, dev, LM_MOE_ARCH, LM_MOE_FIXTURE,
                                      counters=counters)
    model = lm_init_model(rt_configs, dev, LM_MOE_ARCH, seed, "lm_moe_serve_setup")
    reset()
    serve = {r: lm_moe_serve_case(model, r, seed=seed, counters=counters)
             for r in LM_MOE_ROUTERS}
    launched = launch_counts(counters)
    emit("main_path_summary", path="slice10_lm_moe", launches=launched)
    n_moe = moe_layer_count(model)
    del model
    torch.cuda.empty_cache()
    router = lm_router_lp_case(serve, dev, n_moe=n_moe, launches=launched["simplex"])
    return dict(reference=reference, serve=serve, router=router, launches=launched)


# -- slice 11: the SSM, hybrid, encoder-decoder and M-RoPE families ----------

#: Each ``<row>_reference`` row: its config, and its committed reference
#: fixture (``tools/lm_reference_fixture.py``; the fixture's ``layers``
#: give the depth it was cut to, the widths are the config's).
LM_FAMILY_FIXTURES = {
    "lm_ssm": ("mamba2-130m", ROOT / "tests" / "data" / "lm_mamba2_130m_reference.npz"),
    "lm_hybrid": ("zamba2-7b", ROOT / "tests" / "data" / "lm_zamba2_7b_reference.npz"),
    "lm_encdec": ("seamless-m4t-large-v2",
                  ROOT / "tests" / "data" / "lm_seamless_m4t_large_v2_reference.npz"),
    "lm_vlm": ("qwen2-vl-72b", ROOT / "tests" / "data" / "lm_qwen2_vl_72b_reference.npz"),
}
#: ``lm_ssm_long``: one prompt of the reference's ``long_500k`` length, then
#: decode steps (bfloat16).  Its float32 gate, prefill of s - 1 tokens and
#: one decode step against a prefill of s tokens: relative L2 over the
#: vocabulary and max abs over the largest logit, each at most the
#: fixture rows' float32 floor (``LM_REL_TOL``): both are float32 runs of
#: one function whose only difference is the order of rounding (the
#: chunked scan against one recurrence step), as in ``lm_window``.
LM_LONG_PROMPT = 524_288
LM_LONG_STEPS = 32
#: ``lm_encdec_serve``'s decode against the port's own forward (float32):
#: prompts, decode steps, tolerance (``lm_window``'s).
LM_ENCDEC_CHECK = (2, 8)


def lm_fixture_config(cfg, fixture):
    """``cfg`` cut to the fixture's depth (the encoder's too)."""
    cut = {"num_layers": int(fixture["layers"])}
    if "enc_layers" in fixture:
        cut["enc_layers"] = int(fixture["enc_layers"])
    return dataclasses.replace(cfg, **cut)


def lm_family_reference(rt_configs, dev, row, fixtures=None) -> tuple:
    """``<row>_reference``: the config at full width cut to its fixture's
    depth (``fixtures[row]``: the config and its fixture, by default
    ``LM_FAMILY_FIXTURES``), weights from ``reference_weights`` (checked
    against the fixture's digest), float32 against the fixture with
    ``lm_reference``'s row gates (TF32 must fail them), then bfloat16
    within ``LM_BF16_FACTOR`` times the reference's bfloat16 gap.  Returns
    the float32 and bfloat16 models and the line's fields."""
    from repro_torch.models import Model
    from repro_torch.models.convert import (load_reference_params, reference_weights,
                                            weights_digest)

    arch, path = (LM_FAMILY_FIXTURES if fixtures is None else fixtures)[row]
    check(path.exists(), f"the fixture {path} is missing")
    fixture = dict(np.load(path))
    t_row = time.perf_counter()
    cut = lm_fixture_config(rt_configs.get_config(arch), fixture)
    t0 = time.perf_counter()
    tree = reference_weights(cut, int(fixture["seed"]))
    gen_s = time.perf_counter() - t0
    check(np.array_equal(weights_digest(tree), fixture["weights_digest"]),
          f"{row}: the weights drawn here differ from the fixture's")
    t0 = time.perf_counter()
    model = load_reference_params(Model(dataclasses.replace(cut, dtype="float32"), device=dev),
                                  tree)
    model16 = load_reference_params(Model(cut, device=dev), tree)
    del tree
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    res = lm_reference_case(model, fixture, phase=f"{row}_reference", case_f64=True)
    logits16 = lm_fixture_logits(model16, fixture).float().cpu().numpy()[..., fixture["vocab_ids"]]
    ref = np.asarray(fixture["logits"], np.float64)
    rel = float(np.linalg.norm(logits16 - ref) / np.linalg.norm(ref))
    ref_rel = float(fixture["bf16_rel_l2_all"])
    out = dict(arch=arch, layers=cut.num_layers, enc_layers=cut.enc_layers,
               kinds=sorted(set(model.kinds())), shared_sites=model.shared_sites(),
               params=sum(p.numel() for p in model.parameters()),
               param_count=cut.param_count(), weights_s=gen_s, load_s=load_s,
               logits_ok=res["ok"], bf16_rel_l2=rel, reference_bf16_rel_l2=ref_rel,
               bf16_limit=LM_BF16_FACTOR * ref_rel, wall_s=time.perf_counter() - t_row)
    emit(f"{row}_reference_bf16", **out)
    check(rel <= LM_BF16_FACTOR * ref_rel,
          f"{row}: bf16 logits {rel} from the fixture, past {LM_BF16_FACTOR} x {ref_rel}")
    return model, model16, out


def lm_serve_inputs(cfg, row, batch, prompt, seed, dev) -> dict:
    """``make_inputs``' prompt (tokens, and the frames or patch embeddings
    the config takes), with M-RoPE positions whose coordinates differ."""
    from repro_torch.configs import Shape, make_inputs, mrope_positions

    inputs = make_inputs(cfg, Shape(row, prompt, batch, "prefill"), seed, device=dev)
    if cfg.mrope_sections:
        inputs["positions"] = torch.as_tensor(
            mrope_positions(batch, prompt, cfg.num_patches, seed), device=dev)
    return inputs


def lm_cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for c in cache for t in c.values())


def lm_family_serve_case(model, row, *, seed, counters, batch=LM_SERVE_BATCH,
                         prompt=LM_SERVE_PROMPT, steps=LM_SERVE_STEPS) -> dict:
    """``<row>``: ``Engine.generate`` with no device argument (the card) on
    the loaded bfloat16 model, greedy, after a warm-up: prefill and decode
    ms beside their bounds, peak memory, the cache's bytes, no kernel of
    the port launched.  The encoder-decoder's ``enc_len`` is its frames'
    length (= the prompt's)."""
    from repro_torch.serve.engine import Engine

    cfg = model.cfg
    t_row = time.perf_counter()
    inputs = lm_serve_inputs(cfg, row, batch, prompt, seed, model.device)
    enc_len = inputs["frames"].shape[1] if "frames" in inputs else 0
    engine = Engine(model, max_len=prompt + steps, enc_len=enc_len)
    # The warm-up's prompt: the first LM_WARM_PROMPT tokens, with their
    # positions and patch embeddings (the frames stay whole: ``enc_len``).
    warm = {k: v[:, :LM_WARM_PROMPT] if k in ("tokens", "positions", "patch_embeds") else v
            for k, v in inputs.items()}
    engine.generate(warm, steps=4)  # warm-up: handles, allocator
    engine.cache = None
    before = launch_counts(counters)
    out, wall, prefill_ms, step_ms, rows = timed_generate(engine, model, inputs, steps)
    launched = count_delta(counters, before)
    peak = torch.cuda.max_memory_allocated()
    all_finite = bool(torch.isfinite(torch.stack(rows)).all())
    weights = lm_param_bytes(model)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    moved = [lm_decode_kv_bytes(model, batch, prompt + i, item, enc_len) for i in range(steps - 1)]
    flops = lm_prefill_flops(model, batch, prompt, enc_len)
    res = dict(
        prefill_ms=prefill_ms, prefill_tokens_per_s=batch * prompt / (prefill_ms * 1e-3),
        prefill_bound_ms=lm_prefill_bound_ms(flops), prefill_flops_bf16=flops["bf16"],
        prefill_flops_f32=flops["f32"],
        decode_ms_median=float(np.median(step_ms)), decode_ms_p90=float(np.percentile(step_ms, 90)),
        decode_tokens_per_s=batch / (float(np.median(step_ms)) * 1e-3),
        decode_bound_ms=(weights + float(np.median(moved))) / HBM_BYTES_PER_S * 1e3,
        weight_bytes=weights, cache_bytes=lm_cache_bytes(engine.cache),
        cache_bytes_moved_median=float(np.median(moved)), peak_memory_bytes=peak,
        port_kernel_launches=launched, all_logits_finite=all_finite,
        tokens_in_vocab=bool(((out >= 0) & (out < cfg.vocab_size)).all()))
    engine.cache = None
    res["wall_s"] = time.perf_counter() - t_row
    emit(row, arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers, enc_layers=cfg.enc_layers,
         shared_sites=model.shared_sites(), batch=batch, prompt=prompt, enc_len=enc_len,
         steps=steps, nvidia_smi=smi_line(), **res)
    check(all_finite and res["tokens_in_vocab"], f"{row}: non-finite logits or bad tokens: {res}")
    check(not any(launched.values()), f"{row}: the path launched a kernel of the port: {launched}")
    return res


def lm_decode_vs_forward(model, inputs, prompt, steps) -> float:
    """Prefill of ``prompt`` tokens (with the inputs' frames), then decode
    steps fed the same tokens, each step's logits against the full
    forward's at its position: the largest abs difference."""
    tokens = inputs["tokens"]
    b = tokens.shape[0]
    enc_len = inputs["frames"].shape[1] if "frames" in inputs else 0
    cache = model.init_cache(b, prompt + steps, enc_len=enc_len)
    logits, _ = model.prefill(dict(inputs, tokens=tokens[:, :prompt]), cache)
    rows = [logits[:, 0]]
    for t in range(prompt, prompt + steps - 1):
        logits, _ = model.decode_step({"tokens": tokens[:, t:t + 1]}, cache, t)
        rows.append(logits[:, 0])
    idx = torch.arange(prompt - 1, prompt + steps - 1, device=model.device)
    with torch.inference_mode():
        full = model.logits(model.forward(dict(inputs, tokens=tokens[:, :prompt + steps - 1]))[:, idx])
    return float((torch.stack(rows, dim=1) - full).abs().max())


def ssd_chunk_loop_ms(cfg, dev, batch, s, reps=3) -> float:
    """CUDA-event ms of one mamba layer's inter-chunk loop
    (``models/mamba2.py:_chunk_recurrence``, one launch a chunk) at ``s``
    tokens, on random float32 states; the median of ``reps`` after a
    warm-up."""
    from repro_torch.models.mamba2 import _chunk_recurrence

    nc = -(-s // cfg.ssm_chunk)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    states = torch.randn((nc,) + shape, generator=gen, device=dev)
    decay = torch.rand((nc, batch, cfg.ssm_heads), generator=gen, device=dev)
    init = torch.zeros(shape, device=dev)
    _chunk_recurrence(states, decay, init)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _chunk_recurrence(states, decay, init)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def lm_ssm_long_case(model, model16, *, seed, counters, prompt=LM_LONG_PROMPT,
                     steps=LM_LONG_STEPS) -> dict:
    """``lm_ssm_long``: one prompt of ``prompt`` tokens.  Float32: a prefill
    of s - 1 tokens and one decode step against a prefill of s tokens (the
    reference's ``test_mamba2_state_continuity`` at this length), and the
    same decode step from a state zeroed after the prefill, which the gate
    must reject.  Bfloat16: ``Engine.generate`` of ``steps`` steps, prefill
    and decode ms beside their bounds; the cache's bytes beside a 4,096-token
    prompt's."""
    from repro_torch.configs import Shape, make_inputs
    from repro_torch.serve.engine import Engine

    cfg = model.cfg
    dev = model.device
    t_row = time.perf_counter()
    tokens = make_inputs(cfg, Shape("lm_ssm_long", prompt, 1, "prefill"), seed + 5,
                         device=dev)["tokens"]

    def gap(a, b):  # over the real vocabulary (the padded rows are -1e30)
        a, b = a[..., :cfg.vocab_size].double().flatten(), b[..., :cfg.vocab_size].double().flatten()
        return {"rel_l2": float((a - b).norm() / b.norm()),
                "max_abs": float((a - b).abs().max() / b.abs().max())}

    cache = model.init_cache(1, prompt)
    model.prefill({"tokens": tokens[:, :prompt - 1]}, cache)
    handoff = [{k: v.clone() for k, v in c.items()} for c in cache]
    stepped, _ = model.decode_step({"tokens": tokens[:, prompt - 1:]}, cache, prompt - 1)
    for c, saved in zip(cache, handoff):
        for k, v in saved.items():
            c[k].copy_(v)
        c["state"].zero_()  # the planted fault: the state lost at the handoff
    planted, _ = model.decode_step({"tokens": tokens[:, prompt - 1:]}, cache, prompt - 1)
    del cache, handoff
    whole, _ = model.prefill({"tokens": tokens}, model.init_cache(1, prompt))
    ok_gap, bad_gap = gap(stepped, whole), gap(planted, whole)
    torch.cuda.empty_cache()

    loop_ms = ssd_chunk_loop_ms(cfg, dev, 1, prompt)
    torch.cuda.empty_cache()
    engine = Engine(model16, max_len=prompt + steps)
    engine.generate({"tokens": tokens[:, :4096]}, steps=2)  # warm-up
    short_cache = lm_cache_bytes(engine.cache)
    engine.cache = None
    before = launch_counts(counters)
    out, wall, prefill_ms, step_ms, rows = timed_generate(engine, model16, {"tokens": tokens}, steps)
    launched = count_delta(counters, before)
    peak = torch.cuda.max_memory_allocated()
    long_cache = lm_cache_bytes(engine.cache)
    engine.cache = None
    item = torch.empty((), dtype=getattr(torch, model16.cfg.dtype)).element_size()
    flops = lm_prefill_flops(model16, 1, prompt)
    moved = lm_decode_kv_bytes(model16, 1, prompt, item)
    res = dict(
        continuity_rel_l2=ok_gap["rel_l2"], continuity_max_abs=ok_gap["max_abs"],
        tol=LM_REL_TOL, zeroed_state_rel_l2=bad_gap["rel_l2"],
        zeroed_state_max_abs=bad_gap["max_abs"],
        prefill_ms=prefill_ms, prefill_tokens_per_s=prompt / (prefill_ms * 1e-3),
        prefill_bound_ms=lm_prefill_bound_ms(flops), prefill_flops_bf16=flops["bf16"],
        prefill_flops_f32=flops["f32"], ssd_chunks_a_layer=-(-prompt // cfg.ssm_chunk),
        chunk_loop_ms_a_layer=loop_ms,
        chunk_loop_share_of_prefill=loop_ms * model16.kinds().count("mamba") / prefill_ms,
        decode_ms_median=float(np.median(step_ms)), decode_ms_p90=float(np.percentile(step_ms, 90)),
        decode_bound_ms=(lm_param_bytes(model16) + moved) / HBM_BYTES_PER_S * 1e3,
        cache_bytes=long_cache, cache_bytes_4096_prompt=short_cache, peak_memory_bytes=peak,
        port_kernel_launches=launched,
        all_logits_finite=bool(torch.isfinite(torch.stack(rows)).all()),
        wall_s=time.perf_counter() - t_row)
    emit("lm_ssm_long", arch=cfg.name, prompt=prompt, steps=steps, nvidia_smi=smi_line(), **res)
    check(ok_gap["rel_l2"] <= LM_REL_TOL and ok_gap["max_abs"] <= LM_REL_TOL,
          f"lm_ssm_long: prefill + decode differs from the whole prefill: {ok_gap}")
    check(bad_gap["rel_l2"] > LM_REL_TOL or bad_gap["max_abs"] > LM_REL_TOL,
          f"lm_ssm_long: the gate passes a zeroed state handoff: {bad_gap}")
    check(long_cache == short_cache, f"lm_ssm_long: the cache grew with the prompt: "
          f"{long_cache} against {short_cache}")
    check(res["all_logits_finite"] and not any(launched.values()),
          f"lm_ssm_long: non-finite logits or a kernel of the port launched: {res}")
    return res


def lm_init_model(rt_configs, dev, arch, seed, phase, layers=0):
    """The config at full width and depth (cut to ``layers`` if given) in
    its dtype, ``Model.init`` on the card from a generator seeded ``seed``;
    a ``phase`` line with its size and the seconds it took."""
    from repro_torch.models import Model

    t0 = time.perf_counter()
    cfg = rt_configs.get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    emit(phase, arch=cfg.name, layers=cfg.num_layers, enc_layers=cfg.enc_layers,
         shared_sites=model.shared_sites(), params=sum(p.numel() for p in model.parameters()),
         param_bytes=lm_param_bytes(model), init_s=time.perf_counter() - t0)
    return model


def lm_families_phase(rt_configs, dev, *, seed, counters, reset) -> dict:
    """Slice 11: mamba2-130m (full depth), zamba2-7b (7 layers for the
    fixture, 81 to serve), seamless-m4t-large-v2 (1 + 1 layers for the
    fixture, 24 + 24 to serve) and qwen2-vl-72b (2 layers; 143 GB in
    bfloat16 does not fit one card whole), each ``<row>_reference`` then
    its serve rows, with the launch counts set to 0 before and read after
    (no kernel of the port lies on these paths).  qwen2-vl's bfloat16 model
    comes back as ``vlm_model``: slice 16 serves it."""
    reset()
    t0 = time.perf_counter()
    model, model16, ssm = lm_family_reference(rt_configs, dev, "lm_ssm")
    sizes = dict(seed=seed, counters=counters, batch=LM_SERVE_BATCH, prompt=LM_SERVE_PROMPT,
                 steps=LM_SERVE_STEPS)
    ssm_serve = lm_family_serve_case(model16, "lm_ssm_serve", **sizes)
    long = lm_ssm_long_case(model, model16, seed=seed, counters=counters, prompt=LM_LONG_PROMPT,
                            steps=LM_LONG_STEPS)
    del model, model16
    torch.cuda.empty_cache()

    model, model16, hybrid = lm_family_reference(rt_configs, dev, "lm_hybrid")
    del model, model16
    torch.cuda.empty_cache()
    model16 = lm_init_model(rt_configs, dev, "zamba2-7b", seed, "lm_hybrid_serve_setup")
    hybrid_serve = lm_family_serve_case(model16, "lm_hybrid_serve", **sizes)
    del model16
    torch.cuda.empty_cache()

    # The encoder-decoder's float32 decode against its own forward runs at
    # the fixture's depth: deeper, its float32 function is chaotic on these
    # weights (PERF.md, section 4).
    model, model16, encdec = lm_family_reference(rt_configs, dev, "lm_encdec")
    del model16
    batch, steps = LM_ENCDEC_CHECK
    check_inputs = lm_serve_inputs(model.cfg, "lm_encdec_serve", batch, LM_SERVE_PROMPT + steps,
                                   seed + 1, dev)
    check_inputs["frames"] = check_inputs["frames"][:, :LM_SERVE_PROMPT]
    t1 = time.perf_counter()
    vs_forward = lm_decode_vs_forward(model, check_inputs, LM_SERVE_PROMPT, steps)
    emit("lm_encdec_decode_vs_forward", arch=model.cfg.name, layers=model.cfg.num_layers,
         enc_layers=model.cfg.enc_layers, batch=batch, frames=LM_SERVE_PROMPT,
         prompt=LM_SERVE_PROMPT, steps=steps, max_abs=vs_forward, tol=LM_WINDOW_TOL,
         wall_s=time.perf_counter() - t1)
    check(vs_forward <= LM_WINDOW_TOL,
          f"lm_encdec_serve: decode differs from the port's forward by {vs_forward}")
    del model, check_inputs
    torch.cuda.empty_cache()
    model16 = lm_init_model(rt_configs, dev, "seamless-m4t-large-v2", seed, "lm_encdec_serve_setup")
    encdec_serve = lm_family_serve_case(model16, "lm_encdec_serve", **sizes)
    encdec_serve["decode_vs_forward_max_abs"] = vs_forward
    del model16
    torch.cuda.empty_cache()

    model, vlm_model, vlm = lm_family_reference(rt_configs, dev, "lm_vlm")
    del model
    torch.cuda.empty_cache()
    launched = launch_counts(counters)
    check(not any(launched.values()), f"the slice-11 paths launched a kernel of the port: {launched}")
    emit("main_path_summary", path="slice11_lm_families", launches=launched,
         wall_s=time.perf_counter() - t0)
    return dict(ssm=ssm, ssm_serve=ssm_serve, long=long, hybrid=hybrid,
                hybrid_serve=hybrid_serve, encdec=encdec, encdec_serve=encdec_serve, vlm=vlm,
                vlm_model=vlm_model)


# -- slice 16: the catalog's last five configurations at full width ---------

#: ``lm_catalog_phase``'s rows after ``lm_vlm_serve``: the line, the config,
#: the depth it is cut to (0: whole; the widths are the config's), and the
#: MoE routers it is served under (None: a dense model).
LM_CATALOG_ROWS = (
    ("lm_qwen15_serve", "qwen1.5-4b", 0, None),
    ("lm_internlm2_serve", "internlm2-20b", 0, None),
    ("lm_dbrx_serve", "dbrx-132b", 4, ("topk", "lp")),
    ("lm_command_r_serve", "command-r-plus-104b", 8, None),
)
#: Greedy decode steps of each catalog row, after the 4-step warm-up.
LM_CATALOG_STEPS = 32
#: The catalog's reference fixtures (``tools/lm_reference_fixture.py``):
#: the ``gpu`` tier holds them (``tests/test_torch_gpu.py -k catalog``), not
#: this script, whose time has no room to draw their NumPy weights.
LM_CATALOG_FIXTURES = {
    "lm_qwen15": ("qwen1.5-4b", ROOT / "tests" / "data" / "lm_qwen15_4b_reference.npz"),
    "lm_internlm2": ("internlm2-20b", ROOT / "tests" / "data" / "lm_internlm2_20b_reference.npz"),
    "lm_command_r": ("command-r-plus-104b",
                     ROOT / "tests" / "data" / "lm_command_r_plus_104b_reference.npz"),
}
LM_CATALOG_MOE_FIXTURE = ("dbrx-132b", ROOT / "tests" / "data" / "lm_dbrx_132b_reference.npz")


def lm_table_rows_case(model, row) -> dict:
    """The embedding's rows around element 2**31 of its table (and the
    last row), looked up by ``embed`` as the model does, against the same
    rows read by plain slicing: a 32-bit offset anywhere in the lookup
    would wrap there.  A ``<row>_table`` line."""
    table = model.embed["embedding"]
    v, d = table.shape
    first = (1 << 31) // d + 1  # the first row that starts past element 2**31
    ids = sorted({0, min(first - 1, v - 1), min(first, v - 1), v - 1})
    tokens = torch.as_tensor(ids, device=table.device)[None]
    with torch.inference_mode():
        got = model._embed_inputs({"tokens": tokens})[0]
        scale = math.sqrt(d) if model.cfg.embed_scale else None
        want = torch.stack([table[i] for i in ids])
        if scale is not None:
            want = want * torch.tensor(scale, dtype=want.dtype, device=want.device)
    res = dict(arch=model.cfg.name, table_elements=table.numel(),
               past_2_31=table.numel() > (1 << 31), ids=ids, first_row_past_2_31=first,
               rows_equal=bool(torch.equal(got, want)))
    emit(f"{row}_table", **res)
    check(res["rows_equal"], f"{row}: the embedding's rows past element 2**31 differ: {res}")
    return res


def lm_catalog_phase(rt_configs, dev, *, seed, counters, reset, vlm_model) -> dict:
    """Slice 16: the catalog's last five configurations served at full
    width on the card through ``Engine.generate``, bfloat16, greedy, 8
    prompts of 4,096 tokens then ``LM_CATALOG_STEPS`` steps: qwen2-vl-72b
    on slice 11's 2-layer bfloat16 model (``vlm_model``; 256 patch
    embeddings, M-RoPE), then each of ``LM_CATALOG_ROWS`` made by
    ``Model.init`` on the card and freed before the next: qwen1.5-4b and
    internlm2-20b whole, dbrx-132b cut to 4 layers under ``topk`` and
    ``lp`` (every router LP, 24 x 128, on the simplex kernel, each
    replayed bit-identically on its plain version) and
    command-r-plus-104b cut to 8 (its 3.1 G-element embedding checked by
    ``lm_table_rows_case``).  The launch counts are set to 0 before and
    read after: only dbrx's ``lp`` row launches a kernel of the port.
    Then dbrx's router LP on the kernel against its plain version."""
    reset()
    t0 = time.perf_counter()
    sizes = dict(seed=seed, counters=counters, batch=LM_SERVE_BATCH, prompt=LM_SERVE_PROMPT,
                 steps=LM_CATALOG_STEPS)
    rows = {"lm_vlm_serve": lm_family_serve_case(vlm_model, "lm_vlm_serve", **sizes)}
    del vlm_model
    torch.cuda.empty_cache()
    moe = None
    for row, arch, layers, routers in LM_CATALOG_ROWS:
        model = lm_init_model(rt_configs, dev, arch, seed, f"{row}_setup", layers=layers)
        if model.embed["embedding"].numel() > (1 << 31):
            lm_table_rows_case(model, row)
        if routers is None:
            rows[row] = lm_family_serve_case(model, row, **sizes)
        else:
            rows[row] = {r: lm_moe_serve_case(model, r, row=row, capture_calls=None, **sizes)
                         for r in routers}
            moe = (row, moe_layer_count(model))
        del model
        torch.cuda.empty_cache()
    launched = launch_counts(counters)
    check(launched["simplex"] > 0 and launched["simplex"] == launched["simplex.cluster"]
          and not any(v for k, v in launched.items() if not k.startswith("simplex")),
          f"the slice-16 paths launched other than the simplex kernel's cluster variant: "
          f"{launched}")
    emit("main_path_summary", path="slice16_lm_catalog", launches=launched,
         wall_s=time.perf_counter() - t0)
    row, n_moe = moe
    router = lm_router_lp_case(rows[row], dev, n_moe=n_moe, launches=launched["simplex"],
                               row=f"{row}_router_lp")
    return dict(rows=rows, router=router, launches=launched)


# -- slice 12: training (gemma2-2b, mamba2-130m) and the eval step under lp --

#: ``lm_train_reference``'s fixture (``tools/lm_reference_fixture.py
#: --train``: gemma2-2b at full width cut to 2 layers, three float32
#: steps) and ``lm_eval_lp``'s (``--eval``: deepseek-v2-lite-16b, 3
#: layers, ``router="lp"``).
LM_TRAIN_FIXTURE = ROOT / "tests" / "data" / "lm_train_gemma2_2b_reference.npz"
LM_EVAL_FIXTURE = ROOT / "tests" / "data" / "lm_eval_deepseek_v2_lite_reference.npz"
#: The training gates: each step's loss and ``grad_norm`` (relative error)
#: and each leaf's parameter change at the fixture's samples (relative L2
#: without the fixture's ``flip_share`` of the samples that differ most:
#: Adam steps an element by about ``lr * sign(g)``, and one whose gradient
#: lies within rounding of zero may step either way), against the
#: reference's float32 run and against its float64 run, each within the
#: largest of a floor, ``LM_NOISE_FACTOR`` times the quantity's one-ulp
#: noise and ``LM_F64_FACTOR`` times the reference's own float32 error
#: against its float64 run.  ``lr`` equal.  The same run with TF32
#: products must fail them.  Unlike ``lm_tolerances``, the float64 gate
#: also takes the noise term: a quantity here is one number, and the
#: reference's own error on it is one draw that can lie far below its
#: noise (``grad_norm`` of step 0: 1.8e-5 against a one-ulp noise of
#: 3.0e-4; the port on the card missed float64 by 1.8e-4), where
#: ``lm_tolerances`` takes the largest error over a fixture's rows.
LM_TRAIN_SCALAR_FLOOR = 1e-5
LM_TRAIN_LEAF_FLOOR = 1e-4
#: ``lm_train``: gemma2-2b, all 26 layers, bfloat16 with float32 master
#: weights, remat: microbatches of rows, microbatches a step, tokens a row,
#: timed steps after one warm-up step.
LM_TRAIN_MICRO = 2
LM_TRAIN_ACCUM = 2
LM_TRAIN_SEQ = 4096
LM_TRAIN_TIMED = 4
#: ``lm_train_ssm``: mamba2-130m, rows of ``LM_TRAIN_SEQ`` tokens, steps,
#: the checkpoint interval and the preempted step.
LM_SSM_TRAIN_BATCH = 8
LM_SSM_TRAIN_STEPS = 5
LM_SSM_CKPT_EVERY = 2
LM_SSM_PREEMPT_AT = 3
#: ``lm_eval_lp``: the eval loss against the fixture's, by the training
#: gates' rule with this floor.
LM_EVAL_FLOOR = 1e-5


def lm_sample_slices(fixture):
    """(leaf path, its sampled flat indices) for each leaf of the fixture."""
    out, at = [], 0
    for path, n in zip(fixture["leaf_paths"], fixture["sample_sizes"]):
        out.append((str(path), np.asarray(fixture["sample_idx"][at:at + int(n)])))
        at += int(n)
    return out


def lm_tree_samples(tree, fixture) -> np.ndarray:
    """A reference-layout NumPy tree's values at the fixture's samples."""
    from repro_torch.sharding import leaves

    flat = {"/".join(p): a for p, a in leaves(tree)}
    return np.concatenate([np.asarray(flat[p]).ravel()[idx].astype(np.float64)
                           for p, idx in lm_sample_slices(fixture)])


def lm_model_samples(model, fixture) -> np.ndarray:
    """The model's parameters at the fixture's samples (flat indices into
    each reference leaf, whose stacked layers are the model's in order)."""
    from repro_torch.models.convert import reference_leaf_of

    names = {}
    for name, leaf in reference_leaf_of(model).items():
        names.setdefault(leaf, []).append(name)
    params = dict(model.named_parameters())
    out = []
    for path, idx in lm_sample_slices(fixture):
        flat = torch.cat([params[n].detach().reshape(-1) for n in names[path]])
        out.append(flat[torch.as_tensor(idx, device=model.device)].double().cpu().numpy())
    return np.concatenate(out)


def lm_train_gates(run, fixture, floor_scalar=LM_TRAIN_SCALAR_FLOOR,
                   floor_leaf=LM_TRAIN_LEAF_FLOOR) -> dict:
    """``run`` (``loss``, ``grad_norm``, ``lr`` a step, ``delta`` at the
    samples) against the fixture by the training gates: each quantity's
    error over its gate (``ratios``), the worst, and ``ok``."""
    from repro_torch.models.convert import trimmed_rel

    errors = {}  # quantity -> (error against float32, against float64, gate)

    def gate(name, err, err64, floor, noise, own):
        errors[name] = (err, err64, max(floor, LM_NOISE_FACTOR * noise, LM_F64_FACTOR * own))

    for key in ("loss", "grad_norm"):
        for i, got in enumerate(run[key]):
            ref, f64 = float(fixture[key][i]), float(fixture[f"f64_{key}"][i])
            gate(f"{key}[{i}]", abs(got / ref - 1.0), abs(got / f64 - 1.0), floor_scalar,
                 float(fixture[f"noise_{key}"][i]), abs(ref / f64 - 1.0))
    share = float(fixture["flip_share"])
    at = 0
    for j, (path, idx) in enumerate(lm_sample_slices(fixture)):
        sl = slice(at, at + idx.size)
        at += idx.size
        got, ref, f64 = run["delta"][sl], fixture["delta"][sl], fixture["f64_delta"][sl]
        gate(f"delta/{path}", trimmed_rel(got, ref, share), trimmed_rel(got, f64, share),
             floor_leaf, float(fixture["noise_delta"][j]), trimmed_rel(ref, f64, share))
    ratios = {k: max(e, e64) / tol for k, (e, e64, tol) in errors.items()}
    lr_equal = [float(a) for a in run["lr"]] == [float(b) for b in fixture["lr_steps"]]
    top = max(ratios, key=ratios.get)
    return dict(worst_ratio=ratios[top], worst=top, lr_equal=lr_equal,
                errors={k: [float(f"{x:.4g}") for x in v] for k, v in errors.items()},
                ok=bool(ratios[top] <= 1.0 and lr_equal))


def lm_train_run(model, fixture, batches) -> dict:
    """The fixture's three steps of the port's train step on ``model``:
    each step's loss, ``grad_norm`` and ``lr``, and the parameters at the
    samples afterwards."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    ocfg = opt.OptConfig(lr=float(fixture["lr"]), warmup_steps=int(fixture["warmup_steps"]))
    state = opt.init(dict(model.named_parameters()), ocfg)
    step = make_train_step(model, ocfg, accum=int(fixture["accum"]), remat=True)
    out = {"loss": [], "grad_norm": [], "lr": []}
    for b in batches:
        state, m = step(state, to_device(b, model.device))
        for k in out:
            out[k].append(float(m[k]))
    out["after"] = lm_model_samples(model, fixture)
    return out


def lm_train_reference_case(rt_configs, dev) -> dict:
    """``lm_train_reference``: the fixture's float32 run (gemma2-2b at full
    width, cut to the fixture's depth) through the port's train step on
    the card against the reference's, by the training gates; then the
    same with TF32 products, which must fail them."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights, weights_digest

    check(LM_TRAIN_FIXTURE.exists(), f"the training fixture {LM_TRAIN_FIXTURE} is missing")
    fixture = dict(np.load(LM_TRAIN_FIXTURE))
    cfg = rt_configs.get_config(str(fixture["arch"]))
    cut = dataclasses.replace(cfg, num_layers=int(fixture["layers"]), dtype="float32")
    t0 = time.perf_counter()
    tree = reference_weights(cut, int(fixture["seed"]))
    gen_s = time.perf_counter() - t0
    check(np.array_equal(weights_digest(tree), fixture["weights_digest"]),
          "lm_train_reference: the weights drawn here differ from the fixture's")
    data = SyntheticLM(DataConfig(cut.vocab_size, int(fixture["seq"]), int(fixture["batch"]),
                                  seed=int(fixture["seed"])))
    batches = [data.batch(s) for s in range(int(fixture["steps"]))]
    check(np.array_equal(np.concatenate([b["tokens"].ravel()[:16] for b in batches]),
                         fixture["tokens_digest"]),
          "lm_train_reference: the batches made here differ from the fixture's")
    start = lm_tree_samples(tree, fixture)

    def run(tf32: bool) -> dict:
        model = load_reference_params(Model(cut, device=dev), tree)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            t1 = time.perf_counter()
            out = lm_train_run(model, fixture, batches)
            out["wall_s"] = time.perf_counter() - t1
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out["delta"] = out.pop("after") - start
        del model
        torch.cuda.empty_cache()
        return out

    port = run(False)
    res = lm_train_gates(port, fixture)
    control = lm_train_gates(run(True), fixture) if dev.type == "cuda" else None
    emit("lm_train_reference", arch=cfg.name, layers=cut.num_layers, dtype="float32",
         steps=len(batches), batch=int(fixture["batch"]), seq=int(fixture["seq"]),
         accum=int(fixture["accum"]), weights_s=gen_s, wall_s=port["wall_s"],
         loss=port["loss"], reference_loss=fixture["loss"].tolist(),
         grad_norm=port["grad_norm"], reference_grad_norm=fixture["grad_norm"].tolist(),
         lr=port["lr"], floors=[LM_TRAIN_SCALAR_FLOOR, LM_TRAIN_LEAF_FLOOR],
         samples=int(fixture["sample_idx"].size), flip_share=float(fixture["flip_share"]),
         tf32_control=None if control is None else
         dict(worst_ratio=control["worst_ratio"], worst=control["worst"], ok=control["ok"]),
         **res)
    check(res["ok"], f"lm_train_reference: the port's steps differ from the fixture's: "
                     f"{res['worst']} at {res['worst_ratio']} of its gate")
    check(control is None or not control["ok"],
          "lm_train_reference: the gates pass the TF32 control too")
    return res


def lm_train_bound(model, tokens: int, batch: int, seq: int) -> dict:
    """The least time of a train step on the card, from the code's work:
    the products with the weights (the tied unembedding included) at
    ``8 N tokens`` (forward, recomputed forward, backward) at the bfloat16
    peak; the attention's causal score products (within the window) run
    as forward, recompute and backward: those whose operands are bfloat16
    (q k^T twice, dO v^T once) at the bfloat16 peak, the five with a
    float32 operand (p v twice, and the gradients of v, q and k) at the
    float32 peak; the update's 30 bytes a parameter (float32 gradient,
    m, v and master read, m, v and master written, the bfloat16 parameter
    written) at the memory rate."""
    cfg = model.cfg
    n_mm = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    flops_mm = 8.0 * n_mm * tokens
    windows = lm_self_windows(model)
    pairs = sum(lm_keys(windows, q) for q in range(seq))  # (query, key) pairs, all layers
    unit = 2.0 * (tokens // seq) * cfg.num_heads * cfg.head_dim * pairs
    flops_bf16 = flops_mm + 3 * unit
    flops_f32 = 5 * unit
    params = sum(p.numel() for p in model.parameters())
    update_bytes = 30.0 * params
    ms = dict(matmul_ms=flops_mm / PEAK_FLOPS_BF16 * 1e3,
              attention_ms=(3 * unit / PEAK_FLOPS_BF16 + flops_f32 / PEAK_FLOPS[torch.float32])
              * 1e3, update_ms=update_bytes / HBM_BYTES_PER_S * 1e3)
    return dict(bound_ms=sum(ms.values()), flops_bf16=flops_bf16, flops_f32=flops_f32,
                update_bytes=update_bytes, **ms)


def lm_timed_driver(model, step_fn, data, ckpt_dir, events, every=10 ** 9):
    """A ``TrainDriver`` over ``data`` whose steps are bracketed by CUDA
    events (appended to ``events``), logging every step."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.runtime.fault import DriverConfig, TrainDriver

    def timed(state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(state, batch)
        end.record()
        events.append((start, end))
        return out

    return TrainDriver(DriverConfig(ckpt_dir, ckpt_every=every, log_every=1), model, timed,
                       data.batch, put_fn=lambda b: to_device(b, model.device))


def lm_train_case(rt_configs, dev, *, seed) -> dict:
    """``lm_train``: gemma2-2b at full width and depth in bfloat16 with
    float32 master weights, remat and ``accum`` microbatches, on
    ``SyntheticLM``, through ``TrainDriver`` with checkpointing off: one
    warm-up step, then ``LM_TRAIN_TIMED`` timed ones."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    model = lm_init_model(rt_configs, dev, "gemma2-2b", seed, "lm_train_setup")
    cfg = model.cfg
    batch = LM_TRAIN_MICRO * LM_TRAIN_ACCUM
    ocfg = opt.OptConfig()
    torch.cuda.reset_peak_memory_stats()
    state = opt.init(dict(model.named_parameters()), ocfg)
    step = make_train_step(model, ocfg, accum=LM_TRAIN_ACCUM, remat=True)
    data = SyntheticLM(DataConfig(cfg.vocab_size, LM_TRAIN_SEQ, batch, seed=seed))
    events = []
    t0 = time.perf_counter()
    state, hist = lm_timed_driver(model, step, data, None, events).run(state, 1 + LM_TRAIN_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = [s.elapsed_time(e) for s, e in events]
    timed = ms[1:]
    tokens = batch * LM_TRAIN_SEQ
    bound = lm_train_bound(model, tokens, batch, LM_TRAIN_SEQ)
    losses = [m["loss"] for _, m in hist]
    res = dict(step_ms_median=float(np.median(timed)), step_ms_min=float(min(timed)),
               step_ms_max=float(max(timed)), warmup_step_ms=ms[0],
               tokens_per_s=tokens / (float(np.median(timed)) * 1e-3),
               loss=losses, grad_norm=[m["grad_norm"] for _, m in hist],
               lr=[m["lr"] for _, m in hist], peak_memory_bytes=peak,
               bound_share=bound["bound_ms"] / float(np.median(timed)), wall_s=wall, **bound)
    emit("lm_train", arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         params=sum(p.numel() for p in model.parameters()), micro_batch=LM_TRAIN_MICRO,
         accum=LM_TRAIN_ACCUM, seq=LM_TRAIN_SEQ, tokens_per_step=tokens, remat=True,
         master_weights=ocfg.master_weights, nvidia_smi=smi_line(), **res)
    check(all(np.isfinite(losses)) and all(np.isfinite(res["grad_norm"])),
          f"lm_train: non-finite loss or grad_norm: {losses}, {res['grad_norm']}")
    del model, state, step
    torch.cuda.empty_cache()
    return res


def lm_train_ssm_case(rt_configs, dev, *, seed) -> dict:
    """``lm_train_ssm``: mamba2-130m at full width and depth in bfloat16,
    ``LM_SSM_TRAIN_BATCH`` rows of ``LM_TRAIN_SEQ`` tokens a step.  An
    uninterrupted run, then a run checkpointed every ``LM_SSM_CKPT_EVERY``
    steps and preempted at ``LM_SSM_PREEMPT_AT``, resumed by a new model
    and driver from the newest checkpoint: its parameters and optimizer
    state bit-equal to the uninterrupted run's (deterministic algorithms
    on).  Step ms, the checkpoints' bytes and write ms."""
    import tempfile

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.runtime.fault import Preemption
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = rt_configs.get_config("mamba2-130m")
    data = SyntheticLM(DataConfig(cfg.vocab_size, LM_TRAIN_SEQ, LM_SSM_TRAIN_BATCH, seed=seed))
    torch.cuda.reset_peak_memory_stats()

    def setup(ckpt_dir, events):
        model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
        ocfg = opt.OptConfig(lr=1e-3, warmup_steps=2)
        state = opt.init(dict(model.named_parameters()), ocfg)
        driver = lm_timed_driver(model, make_train_step(model, ocfg, remat=True), data,
                                 ckpt_dir, events, every=LM_SSM_CKPT_EVERY)
        return model, state, driver

    writes = []
    save = ckpt.save

    def timed_save(directory, step, tree):
        t1 = time.perf_counter()
        final = save(directory, step, tree)
        writes.append(dict(step=step, ms=(time.perf_counter() - t1) * 1e3,
                           bytes=os.path.getsize(os.path.join(final, "arrays.npz"))))
        return final

    torch.use_deterministic_algorithms(True, warn_only=True)
    ckpt.save = timed_save
    try:
        events = []
        model_a, state_a, driver = setup(None, events)
        state_a, hist_a = driver.run(state_a, LM_SSM_TRAIN_STEPS)
        with tempfile.TemporaryDirectory() as tmp:
            _, state_b, driver = setup(tmp, [])
            try:
                driver.run(state_b, LM_SSM_TRAIN_STEPS, preempt_at=LM_SSM_PREEMPT_AT)
                preempted = False
            except Preemption:
                preempted = True
            resumed_from = ckpt.latest_step(tmp)
            del driver, state_b
            model_c, state_c, driver = setup(tmp, [])
            with torch.no_grad():  # the restore must overwrite these
                for p in model_c.parameters():
                    p.zero_()
            state_c, hist_c = driver.run(state_c, LM_SSM_TRAIN_STEPS)
    finally:
        ckpt.save = save
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    same = [torch.equal(bits(a), bits(b)) if a.dtype != torch.bfloat16 else
            torch.equal(a.view(torch.int16), b.view(torch.int16))
            for a, b in zip(model_a.parameters(), model_c.parameters())]
    same_state = all(torch.equal(bits(getattr(state_a, f)[k]), bits(getattr(state_c, f)[k]))
                     for f in ("m", "v", "master") for k in state_a.m)
    ms = [s.elapsed_time(e) for s, e in events]
    res = dict(steps=LM_SSM_TRAIN_STEPS, preempted_at=LM_SSM_PREEMPT_AT if preempted else None,
               resumed_from=resumed_from, resumed_steps=[s for s, _ in hist_c],
               params_bit_equal=sum(same), params=len(same), opt_state_bit_equal=same_state,
               loss=[m["loss"] for _, m in hist_a],
               resumed_loss=[m["loss"] for _, m in hist_c],
               step_ms_median=float(np.median(ms[1:])), warmup_step_ms=ms[0],
               tokens_per_s=LM_SSM_TRAIN_BATCH * LM_TRAIN_SEQ / (float(np.median(ms[1:])) * 1e-3),
               checkpoint_writes=writes, peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit("lm_train_ssm", arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         batch=LM_SSM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, ckpt_every=LM_SSM_CKPT_EVERY,
         deterministic_algorithms=True, nvidia_smi=smi_line(), **res)
    check(preempted and resumed_from == LM_SSM_PREEMPT_AT - 1
          and res["resumed_steps"][0] == resumed_from,
          f"lm_train_ssm: preempted {preempted}, resumed from {resumed_from}")
    check(all(same) and same_state,
          f"lm_train_ssm: {sum(same)} of {len(same)} parameters bit-equal after the restart, "
          f"optimizer state equal: {same_state}")
    check(all(np.isfinite(res["loss"])), f"lm_train_ssm: non-finite loss {res['loss']}")
    del model_a, model_c, state_a, state_c, driver
    torch.cuda.empty_cache()
    return res


def lm_eval_lp_case(rt_configs, dev, *, counters) -> dict:
    """``lm_eval_lp``: deepseek-v2-lite-16b at the fixture's depth in
    float32, ``make_eval_step`` under ``router="lp"`` on the fixture's
    batch: the loss against the reference's eval loss (the training
    gates' rule), one simplex launch a MoE layer, all of the cluster
    variant, and every captured LP bit-identical on ``simplex_plain``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import simplex_cuda
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, weights_digest
    from repro_torch.train.train_step import make_eval_step

    check(LM_EVAL_FIXTURE.exists(), f"the eval fixture {LM_EVAL_FIXTURE} is missing")
    fixture = dict(np.load(LM_EVAL_FIXTURE))
    cfg = rt_configs.get_config(str(fixture["arch"]))
    cut = dataclasses.replace(cfg, num_layers=int(fixture["layers"]), router=str(fixture["router"]),
                              dtype="float32")
    t0 = time.perf_counter()
    tree = reference_tree(cut, int(fixture["seed"]))
    gen_s = time.perf_counter() - t0
    check(np.array_equal(weights_digest(tree), fixture["weights_digest"]),
          "lm_eval_lp: the weights drawn here differ from the fixture's")
    model = load_reference_params(Model(cut, device=dev), tree)
    del tree
    batch = SyntheticLM(DataConfig(cut.vocab_size, int(fixture["seq"]), int(fixture["batch"]),
                                   seed=int(fixture["seed"]))).batch(0)
    check(np.array_equal(batch["tokens"].ravel()[:64], fixture["tokens_digest"]),
          "lm_eval_lp: the batch made here differs from the fixture's")
    eval_step = make_eval_step(model)
    before = launch_counts(counters)
    with SimplexSpy(simplex_cuda) as spy:
        t1 = time.perf_counter()
        loss = float(eval_step(to_device(batch, dev)))
        wall = time.perf_counter() - t1
    launched = count_delta(counters, before)
    replayed = [replay_plain(rec) for rec in spy.records]
    ref, f64 = float(fixture["loss"]), float(fixture["f64_loss"])
    own = abs(ref / f64 - 1.0)
    tol = max(LM_EVAL_FLOOR, LM_NOISE_FACTOR * float(fixture["noise_loss"]), LM_F64_FACTOR * own)
    tol64 = max(LM_EVAL_FLOOR, LM_F64_FACTOR * own)
    err, err64 = abs(loss / ref - 1.0), abs(loss / f64 - 1.0)
    n_moe = moe_layer_count(model)
    res = dict(loss=loss, reference_loss=ref, f64_loss=f64, err=err, tol=tol, err_f64=err64,
               tol_f64=tol64, router_lps=spy.calls, reference_router_lps=int(fixture["router_lps"]),
               simplex_launches=launched["simplex"],
               simplex_cluster_launches=launched["simplex.cluster"],
               captured_bit_identical=sum(replayed), wall_s=wall, weights_s=gen_s,
               ok=bool(err <= tol and err64 <= tol64))
    emit("lm_eval_lp", arch=cfg.name, layers=cut.num_layers, moe_layers=n_moe,
         batch=int(fixture["batch"]), seq=int(fixture["seq"]), **res)
    check(res["ok"], f"lm_eval_lp: the eval loss {loss} differs from the reference's {ref}")
    check(spy.calls == n_moe == int(fixture["router_lps"]) and launched["simplex"] == n_moe
          and launched["simplex.cluster"] == n_moe,
          f"lm_eval_lp: {spy.calls} router LPs, launches {launched}, not {n_moe}")
    check(all(replayed), f"lm_eval_lp: {sum(replayed)} of {len(replayed)} captured router LPs "
                         "bit-identical to simplex_plain")
    del model, eval_step
    torch.cuda.empty_cache()
    return res


def lm_train_phase(rt_configs, dev, *, seed, counters, reset) -> dict:
    """Slice 12, training: ``lm_train_reference``, ``lm_train``,
    ``lm_train_ssm`` and ``lm_eval_lp``, with the launch counts set to 0
    before and read after: only the simplex kernel launches, from the
    eval step's router LPs."""
    reset()
    t0 = time.perf_counter()
    reference = lm_train_reference_case(rt_configs, dev)
    train = lm_train_case(rt_configs, dev, seed=seed)
    ssm = lm_train_ssm_case(rt_configs, dev, seed=seed)
    evl = lm_eval_lp_case(rt_configs, dev, counters=counters)
    launched = launch_counts(counters)
    emit("main_path_summary", path="slice12_train", launches=launched,
         wall_s=time.perf_counter() - t0)
    check(not any(v for k, v in launched.items() if not k.startswith("simplex")),
          f"the training paths launched another kernel of the port: {launched}")
    check(launched["simplex"] == launched["simplex.cluster"] == evl["simplex_launches"] > 0,
          f"the eval step's simplex launches are not all of the cluster variant: {launched}")
    return dict(reference=reference, train=train, ssm=ssm, eval=evl, launches=launched)


# ---------------------------------------------------------------------------
# Slice 13: the LP system over a device mesh
# ---------------------------------------------------------------------------


def mesh_inputs(rt, seed: int) -> dict:
    """The mesh phase's inputs, on the host, from the seeds of the rows they
    repeat: every rank is given the same full batches and moves only its
    own rows to the card."""
    from repro_torch.core.lp import LPBatch, random_shared_lp_batch

    cpu = torch.device("cpu")
    size = MESH_SIZES
    a, b, c, _ = chunked_lp_batch(np.random.default_rng(seed), size["type1"], 100, 100, True,
                                  torch.float32, cpu, chunk=5000)
    a2, b2, c2, _ = chunked_lp_batch(np.random.default_rng(seed + 1), size["type2"], 200, 100,
                                     False, torch.float32, cpu, chunk=5000)
    k = MESH_ODD_LPS
    lo, hi, d = chunked_hyperbox(np.random.default_rng(seed + 2), size["box"], 5, torch.float32,
                                 cpu)
    return dict(
        type1=rt.LPProblem.make(c, a, bu=b, device="cpu"),
        type1_batch=LPBatch(a, b, c),
        odd=rt.LPProblem.make(c2[:k].clone(), a2[:k].clone(), bu=b2[:k].clone(), device="cpu"),
        shared=random_shared_lp_batch(np.random.default_rng(seed + 30), size["shared"], 100,
                                      100, True, device="cpu"),
        box=rt.LPProblem.make(d, lo=lo, hi=hi, device="cpu"),
        serve=serve_requests(rt),
        grad=torch.as_tensor(np.random.default_rng(seed + 50).standard_normal(MESH_GRAD)
                             .astype(np.float32)))


def mesh_serve(rt, mesh, problems, mode):
    """The serve mix through ``LPEngine(mesh=...)``, driven by the step count
    (every rank submits the same requests in the same steps), in the
    order of the unsplit serve phase (a box after every 64 LPs): 512
    requests a step in continuous mode, whose box waves the mesh's blocks
    need not divide (the front door pads a boxlike problem to whole
    blocks), or all of them and one flush.  Returns the per-request solutions in request order."""
    from repro_torch.serve.engine import LPEngine

    if mode == "flush":
        eng = LPEngine(rt.SolveOptions(), flush_every=1 << 30, mesh=mesh)
        tickets = [eng.submit(p) for p in problems]
        eng.flush()
    else:
        eng = LPEngine(rt.SolveOptions(), flush_every=1 << 30, max_inflight=1024,
                       step_iters=64, mesh=mesh)
        tickets = []
        for lo in range(0, len(problems), 512):
            tickets += [eng.submit(p) for p in problems[lo:lo + 512]]
            eng.step()
        while eng.pending_count or eng.inflight_count:
            eng.step()
    check(eng.stats.retries == 0 and eng.stats.dead_lettered == 0,
          f"mesh serve {mode}: {eng.stats.retries} retries, {eng.stats.dead_lettered} dead letters")
    return [eng.result(t) for t in tickets], eng.stats


def mesh_int8_row(mesh, grad) -> dict:
    """``dp_allreduce_int8`` of this rank's block of ``grad`` against the plain
    computation: one scale from the global max, every block quantized, the
    int32 sum over the data axis dequantized and divided by its size."""
    import torch.distributed as dist
    from repro_torch.core.spmd import mesh_device
    from repro_torch.train.compression import _quantize_with, dp_allreduce_int8

    dev = mesh_device(mesh)
    group = mesh.get_group("data")
    size, block = dist.get_world_size(group), dist.get_rank(group)
    per = grad.shape[0] // size
    g = grad.to(dev)
    out = dp_allreduce_int8({"g": g[block * per:(block + 1) * per]}, mesh)["g"]
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = _quantize_with(g, scale).to(torch.int32).reshape(size, per, -1).sum(dim=0)
    plain = q.to(torch.float32) * scale / torch.tensor(float(size), device=dev)
    return dict(bit_equal_to_plain=bool(torch.equal(bits(out), bits(plain))),
                max_abs_err=max_abs_diff(out, plain), shape=list(out.shape))


def mesh_rank_rows(rt, mesh, inputs, counters, reset) -> list:
    """Every row of the phase on one mesh, from this rank: per row its
    launches (set to 0 just before), wall time, peak memory and the digest
    of the whole solution it returned."""
    rows = []

    def run(name, fn, ref):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = dict(row=name, wall_s=wall, launches=launch_counts(counters),
                   max_memory_allocated=int(torch.cuda.max_memory_allocated()), ref=ref)
        if isinstance(out, tuple):  # a serve run: (solutions, stats)
            row.update(digest=requests_digest(out[0]), spliced=out[1].spliced,
                       resumed=out[1].resumed)
        elif isinstance(out, dict):
            row.update(out)
        else:
            row.update(digest=sol_digest(out), lps=int(out.status.shape[0]))
        rows.append(row)

    run("type1", lambda: rt.solve(inputs["type1"], mesh=mesh), "type1_feasible_100x100")
    run(f"odd_type2_first_{MESH_ODD_LPS}", lambda: rt.solve(inputs["odd"], mesh=mesh),
        f"type2_infeasible_start_200x100[:{MESH_ODD_LPS}]")
    run("rounds_type1_every_k_basis",
        lambda: rt.solve(inputs["type1_batch"], rt.SolveOptions(
            compaction="every_k", resume="basis", compact_every=128), mesh=mesh),
        "rounds_type1")
    run("shared_type1", lambda: rt.solve(inputs["shared"], mesh=mesh), "shared_type1_100x100")
    run("hyperbox_4000000x5", lambda: rt.solve(inputs["box"], mesh=mesh), "hyperbox_4000000x5")
    run("serve_flush", lambda: mesh_serve(rt, mesh, inputs["serve"], "flush"), "serve")
    run("serve_continuous", lambda: mesh_serve(rt, mesh, inputs["serve"], "continuous"),
        "serve")
    run("dp_allreduce_int8", lambda: mesh_int8_row(mesh, inputs["grad"]), None)
    return rows


def mesh_rank_main(rank: int, world: int, store: str, out_dir: str, seed: int) -> None:
    """One of the gloo ranks that share the card: both meshes, every row."""
    import traceback

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(2)
    out = dict(rank=rank)
    try:
        import repro_torch as rt
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.kernels import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda
        from repro_torch.launch import mesh as mesh_lib

        counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                    "pdhg": pdhg_cuda}

        def reset():
            for mod in counters.values():
                mod.launches = 0
                for variant in getattr(mod, "variant_launches", {}):
                    mod.variant_launches[variant] = 0

        mesh_lib.init_distributed("gloo", timeout_s=MESH_TIMEOUT_S / 2, rank=rank,
                                  world_size=world, store=dist.FileStore(store, world))
        t0 = time.perf_counter()
        inputs = mesh_inputs(rt, seed)
        out["inputs_s"] = time.perf_counter() - t0
        meshes = {"data4": (world, 1), "data2_model2": (world // 2, 2)}
        for name, shape in meshes.items():
            mesh = DeviceMesh("cuda", torch.arange(world).reshape(shape),
                              mesh_dim_names=("data", "model"))
            out[name] = dict(coordinate=list(mesh.get_coordinate()),
                             rows=mesh_rank_rows(rt, mesh, inputs, counters, reset))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent reads it and fails the run
        out["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    if "error" in out:
        os._exit(1)


def mesh_nccl_case(rt, dev, *, seed, counters, reset, type1_row) -> dict:
    """Part (a): NCCL with one rank on the card, a (1, 1) mesh, type 1's
    50,000 LPs through ``solve(..., mesh=mesh)``, bit-identical to slice 1's
    unsplit result."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib

    a, b, c, _ = chunked_lp_batch(np.random.default_rng(seed), 50_000, 100, 100, True,
                                  torch.float32, dev, chunk=5000)
    problem = rt.LPProblem.make(c, a, bu=b)
    del a, b, c
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        mesh_lib.init_distributed("nccl", timeout_s=300.0, rank=0, world_size=1,
                                  store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            mesh = mesh_lib.make_local_mesh()
            reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sol = rt.solve(problem, mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts(counters)
            peak = int(torch.cuda.max_memory_allocated())
            # Once more, after the counts were read: the first call also set
            # up NCCL's communicator.
            t0 = time.perf_counter()
            rt.solve(problem, mesh=mesh)
            torch.cuda.synchronize()
            again = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    same = sol_digest(sol) == MESH_REFS["type1_feasible_100x100"]
    row = dict(part="nccl_1rank", mesh=[1, 1], backend="nccl", row="type1", lps=50_000,
               wall_s=wall, again_wall_s=again, unsplit_wall_s=type1_row["wall_s"],
               launches=launches,
               max_memory_allocated=peak,
               unsplit_max_memory_allocated=type1_row["max_memory_allocated"],
               bit_identical_to_unsplit=same)
    emit("slice13_mesh", **row)
    check(same, "slice13_mesh: the NCCL (1, 1) mesh solve of type 1 differs from slice 1's")
    check(launches["simplex"] == 1 and launches["simplex.cluster"] == 1,
          f"slice13_mesh: the NCCL type-1 solve launched {launches}")
    del problem, sol
    torch.cuda.empty_cache()
    return launches


def mesh_gloo_case(*, seed, type1_row) -> list:
    """Part (b): MESH_RANKS gloo ranks sharing the card, spawned from here, on
    meshes (data=4) and (data=2, model=2).  Every gathered result must be
    bit-identical (by digest) to the one-process result of the same rows.
    Returns each rank's per-mesh launch counts."""
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        procs = [ctx.Process(target=mesh_rank_main,
                             args=(r, MESH_RANKS, os.path.join(tmp, "store"), tmp, seed))
                 for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        check(not alive, f"slice13_mesh: {len(alive)} ranks passed {MESH_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_RANKS):
            path = os.path.join(tmp, f"rank{r}.json")
            check(os.path.exists(path), f"slice13_mesh: rank {r} wrote no result "
                  f"(exit code {procs[r].exitcode})")
            with open(path) as fh:
                ranks.append(json.load(fh))
    errors = [f"rank {r['rank']}:\n{r['error']}" for r in ranks if "error" in r]
    check(not errors, "slice13_mesh: " + "\n".join(errors))
    unsplit_peak = type1_row["max_memory_allocated"]
    for mesh_name in ("data4", "data2_model2"):
        for i, first in enumerate(ranks[0][mesh_name]["rows"]):
            per = [r[mesh_name]["rows"][i] for r in ranks]
            name = first["row"]
            if first["ref"] is not None:
                same = [p["digest"] == MESH_REFS[first["ref"]] for p in per]
            else:
                same = [p["bit_equal_to_plain"] for p in per]
            row = dict(part="gloo_4ranks_sharing_one_card", mesh=mesh_name, row=name,
                       label="4 ranks sharing one card: says nothing about scaling",
                       bit_identical=same,
                       ranks=[dict(coordinate=r[mesh_name]["coordinate"], wall_s=p["wall_s"],
                                   launches={k: v for k, v in p["launches"].items() if v},
                                   max_memory_allocated=p["max_memory_allocated"],
                                   **{k: p[k] for k in ("spliced", "resumed", "max_abs_err")
                                      if k in p})
                              for r, p in zip(ranks, per)])
            if name == "type1":
                row["unsplit_max_memory_allocated"] = unsplit_peak
                row["unsplit_wall_s"] = type1_row["wall_s"]
            emit("slice13_mesh", **row)
            check(all(same), f"slice13_mesh {mesh_name} {name}: a rank's result is not "
                  f"bit-identical to the one-process result: {same}")
            for p in per:
                kernel = {"type1": "simplex", "rounds_type1_every_k_basis": "simplex",
                          f"odd_type2_first_{MESH_ODD_LPS}": "simplex",
                          "shared_type1": "revised", "hyperbox_4000000x5": "hyperbox",
                          "serve_flush": "simplex", "serve_continuous": "simplex"}.get(name)
                if kernel is None:
                    continue
                check(p["launches"][kernel] > 0,
                      f"slice13_mesh {mesh_name} {name}: a rank launched no {kernel} kernel")
                variant = {"simplex": "cluster", "revised": "resident"}.get(kernel)
                if variant:
                    check(p["launches"][f"{kernel}.{variant}"] == p["launches"][kernel],
                          f"slice13_mesh {mesh_name} {name}: a launch left the {variant} "
                          f"variant: {p['launches']}")
                if name == "type1" and mesh_name == "data4":
                    check(p["max_memory_allocated"] < unsplit_peak,
                          f"slice13_mesh: a rank's type-1 peak {p['max_memory_allocated']} "
                          f"is not below the unsplit run's {unsplit_peak}")
    emit("slice13_mesh_group", ranks=MESH_RANKS, wall_s=wall,
         inputs_s=[r["inputs_s"] for r in ranks])
    return [{m: sum_counts(row["launches"] for row in r[m]["rows"])
             for m in ("data4", "data2_model2")} for r in ranks]


def sum_counts(dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def mesh_phase(rt, dev, *, seed, counters, reset, type1_row) -> dict:
    """Slice 13: (a) NCCL with one rank, then (b) gloo ranks sharing the card.

    Returns the launches of (a) in this process and each rank's of (b)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nccl = mesh_nccl_case(rt, dev, seed=seed, counters=counters, reset=reset,
                          type1_row=type1_row)
    per_rank = mesh_gloo_case(seed=seed, type1_row=type1_row)
    emit("main_path_summary", path="slice13_mesh", launches_nccl_1rank=nccl,
         launches_per_rank=per_rank, wall_s=time.perf_counter() - t0)
    return dict(nccl=nccl, per_rank=per_rank)


# ---------------------------------------------------------------------------
# Slice 14: the LM serve path over a device mesh
# ---------------------------------------------------------------------------

#: (a) NCCL with one rank on a (1, 1) mesh: (arch, router) at full width and
#: depth in bfloat16, and ``Engine.generate``'s batch; 40 steps, so that the
#: median of 39 host-bound decode steps (spread ±25%) resolves a 10% change.
LM_MESH_NCCL_CASES = (("deepseek-v2-lite-16b", "lp"), ("gemma2-2b", None))
LM_MESH_NCCL_BATCH, LM_MESH_NCCL_PROMPT, LM_MESH_NCCL_STEPS = 8, 1024, 40
#: (b) gloo ranks sharing the card on a (data, model) = (2, 2) mesh: (arch,
#: router, layers) at full width cut in depth (gemma2-2b to one local and
#: one global layer, for the script's time), in float32 (in bfloat16 the
#: split's row-parallel sums round otherwise than one product, and
#: gemma2's 256,000-way argmax has near ties that this flips).  4 prompts
#: of 64 tokens: 2 token groups of 128, whose capacity of 16 an expert
#: (against a mean load of 12) drops tokens.  mamba2-130m cut to 8 layers
#: (24 before the sequence-parallel stream pushed the script past 1,150 s)
#: and zamba2-7b cut to 2 mamba layers and its shared site run the head-split
#: mixer (``models/mamba2.py:mamba_mixer``: 12 and 56 heads a rank);
#: their float32 logits are also held to the one process's within
#: ``LM_ABS_TOL`` and ``LM_REL_TOL``, and each rank reports the heads of
#: its scans and decode steps and the model-axis all-gather bytes of one
#: decode step beside the mixer's before the split, reckoned from the
#: shapes (``tools/mixer_spy.py``).  The same cases then run in bfloat16
#: on the float32 run's tokens (``lm_mesh_forced``), held to the one
#: process's float32 logits within ``LM_BF16_FACTOR`` times the
#: one-process bfloat16 run's own gap.
LM_MESH_RANKS, LM_MESH_SHAPE = 4, (2, 2)
LM_MESH_GLOO_CASES = (("gemma2-2b", None, 2), ("deepseek-v2-lite-16b", "lp", 3),
                      ("mamba2-130m", None, 8), ("zamba2-7b", None, 2))
LM_MESH_GLOO_DTYPE = "float32"
LM_MESH_GLOO_BATCH, LM_MESH_GLOO_PROMPT, LM_MESH_GLOO_STEPS = 4, 64, 3
#: The reference's float32 run under an Auto-typed (2, 2) mesh of 4 host
#: devices (``tools/lm_reference_fixture.py --mesh 2,2``).
LM_MESH_FIXTURE = ROOT / "tests" / "data" / "lm_deepseek_v2_lite_mesh_reference.npz"
#: The fixture's calls the gloo ranks run (the prefill and the first decode
#: steps; one process runs them all): each call gathers the float32
#: experts over the data axis through the host.
LM_MESH_FIXTURE_CALLS = 2
LM_MESH_TIMEOUT_S = 600


def lm_fixture_head(view, calls: int) -> dict:
    """A fixture view cut to its first ``calls`` calls (the prefill and
    ``calls - 1`` decode steps): every row array, and the router LPs of
    those calls."""
    steps = int(view["steps"])
    n_lp = int(np.sum(np.asarray(view["router_call"]) < calls))
    out = {}
    for k, v in view.items():
        v = np.asarray(v)
        if k.startswith("router_"):
            out[k] = v[:n_lp]
        elif v.ndim >= 2 and v.shape[1] == steps + 1 and k != "tokens":
            out[k] = v[:, :calls]
        else:
            out[k] = v
    out["steps"] = np.int64(calls - 1)
    return out


def lm_mesh_config(rt_configs, arch, router=None, layers=0, dtype=None):
    cfg = rt_configs.get_config(arch)
    cut = {}
    if router:
        cut["router"] = router
    if layers:
        cut["num_layers"] = layers
    if dtype:
        cut["dtype"] = dtype
    return dataclasses.replace(cfg, **cut)


def lm_mesh_tokens(cfg, batch, prompt, seed, dev):
    from repro_torch.configs import Shape, make_inputs

    return make_inputs(cfg, Shape("lm_mesh", prompt, batch, "prefill"), seed + 11,
                       device=dev)["tokens"]


def lm_mesh_run(model, tokens, steps, *, counters, group_tokens) -> dict:
    """``Engine.generate`` greedy (``timed_generate``) under whatever mesh is
    active: tokens, each call's logits, times, peak memory, launches, the
    router LPs (``SimplexSpy`` records, all of them) and the prefill's
    dropped share (its dispatch calls take ``group_tokens`` tokens)."""
    from repro_torch.kernels import simplex_cuda
    from repro_torch.serve.engine import Engine

    engine = Engine(model, max_len=tokens.shape[1] + steps)
    before = launch_counts(counters)
    with SimplexSpy(simplex_cuda) as spy, RoutingStats() as routing:
        out, wall, prefill_ms, step_ms, rows = timed_generate(engine, model, {"tokens": tokens},
                                                              steps)
    launched = count_delta(counters, before)
    peak = int(torch.cuda.max_memory_allocated())
    cache_bytes = sum(t.numel() * t.element_size() for layer in engine.cache
                      for t in layer.values())
    routing = routing.summary(group_tokens)
    return dict(tokens=out, rows=rows, wall_s=wall, prefill_ms=prefill_ms,
                decode_ms_median=float(np.median(step_ms)),
                decode_ms_p10=float(np.percentile(step_ms, 10)),
                decode_ms_p90=float(np.percentile(step_ms, 90)), peak=peak, launches=launched,
                lps=spy.calls, records=spy.records, routing=routing, cache_bytes=cache_bytes,
                param_bytes=lm_param_bytes(model))


def lm_mesh_forced(prompts, generated, steps) -> dict:
    """A fixture view that feeds a run's own tokens back (``lm_fixture_logits``):
    the prompts, then the first ``steps - 1`` generated tokens, so that its
    calls are ``Engine.generate``'s on any model."""
    tokens = torch.cat([prompts.cpu(), generated[:, :steps - 1].cpu().to(prompts.dtype)], 1)
    return dict(tokens=tokens.numpy(), prompt_len=prompts.shape[1], steps=steps - 1)


def lm_mesh_join(blocks):
    """``(whole, agree)``: the batch put together from ``(row range, rows)``
    blocks in row order (a block from the first rank that holds it), and
    whether ranks holding one block hold the same bits."""
    parts, agree = {}, True
    for rows, t in blocks:
        rows = tuple(rows)
        if rows in parts:
            agree &= torch.equal(bits(parts[rows]), bits(t))
        parts.setdefault(rows, t)
    return torch.cat([parts[k] for k in sorted(parts)]), agree


def lm_mesh_spec_bytes(model, batch, max_len) -> int:
    """The bytes of this rank's slices of every parameter and cache leaf, from
    their specs (``partition.local_shape``)."""
    from repro_torch.sharding import partition

    specs = list(model.abstract_params().values())
    specs += [s for layer in model.cache_specs(batch, max_len) for s in layer.values()]
    return sum(math.prod(partition.local_shape(s.shape, s.axes))
               * torch.empty((), dtype=getattr(torch, s.dtype)).element_size() for s in specs)


def mixer_spy():
    """``tools/mixer_spy.py``, which the tests' mesh workers also use: the
    heads of the mixers' scans and their model-axis all-gathers."""
    if str(ROOT / "tools") not in sys.path:
        sys.path.insert(0, str(ROOT / "tools"))
    import mixer_spy as spy

    return spy


def lm_mesh_lp_digests(records) -> list:
    """A SHA-256 of each captured router LP's inputs and outputs."""
    import hashlib

    out = []
    for rec in records:
        h = hashlib.sha256()
        for t in list(rec["inputs"]) + list(rec["out"]) + [rec["basis"]]:
            h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
        out.append(h.hexdigest())
    return out


def lm_mesh_lp_view(records, dev, batch, prompt, n_moe) -> dict:
    """A fixture view (``router_lp_checks``' form) of one run's router LPs:
    each captured LP re-solved on the kernel."""
    from repro_torch.kernels import ops

    spec = records[0]["kw"]["spec"]
    m, n = spec.m, spec.n
    a = torch.cat([r["inputs"][0][:, :m, 1:1 + n] for r in records]).to(dev)
    b = torch.cat([r["inputs"][0][:, :m, 0] for r in records]).to(dev)
    c = torch.cat([r["inputs"][3][:, 1:1 + n] for r in records]).to(dev)
    sol = ops.simplex_solve(a, b, c, max_iters=8 * (m + n))
    return dict(router_a=a.cpu().numpy(), router_b=b.cpu().numpy(), router_c=c.cpu().numpy(),
                router_status=sol.status.cpu().numpy(),
                router_iterations=sol.iterations.cpu().numpy(),
                router_basis=sol.basis.cpu().numpy(), router_x=sol.x.cpu().numpy(),
                router_call=np.arange(len(records)) // n_moe,
                router_layer=np.arange(len(records)) % n_moe,
                tokens=np.zeros((batch, prompt), np.int32), prompt_len=prompt)


def lm_mesh_records_to(records, dev) -> list:
    return [dict(rec, inputs=[t.to(dev) for t in rec["inputs"]], basis=rec["basis"].to(dev),
                 out=[t.to(dev) for t in rec["out"]]) for rec in records]


def lm_mesh_fixture_check(logits, view) -> dict:
    """Logits (B, steps + 1, V) against the mesh fixture: ``lm_tolerances``'
    gates (``compare_to_summary`` and the float64 rows)."""
    from repro_torch.models.convert import compare_to_summary

    tol = lm_tolerances(view)
    res = compare_to_summary(logits, view, abs_tol=tol["abs"], rel_tol=tol["rel"],
                             margin=LM_MARGIN)
    res.update(lm_f64_error(logits, view, tol))
    res["ok"] = bool(res["ok"] and res["f64_worst_ratio"] <= 1.0)
    return res


def lm_mesh_nccl_case(rt_configs, dev, *, seed, counters) -> dict:
    """Part (a): NCCL with one rank on the card, a (1, 1) mesh.  Each config
    at full width and depth in bfloat16: ``Engine.generate`` without a mesh,
    then under ``partition.activate(mesh)`` (the mesh code path, every group
    of one rank), tokens and every call's logits bit-identical.  Returns
    the mesh runs' launches."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding import partition

    launches: dict = {}
    b, p, steps = LM_MESH_NCCL_BATCH, LM_MESH_NCCL_PROMPT, LM_MESH_NCCL_STEPS
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        mesh_lib.init_distributed("nccl", timeout_s=300.0, rank=0, world_size=1,
                                  store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            mesh = mesh_lib.make_local_mesh()
            for arch, router in LM_MESH_NCCL_CASES:
                cfg = lm_mesh_config(rt_configs, arch, router)
                t0 = time.perf_counter()
                model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
                torch.cuda.synchronize()
                init_s = time.perf_counter() - t0
                tokens = lm_mesh_tokens(cfg, b, p, seed, dev)
                n_moe = moe_layer_count(model)
                # warm-up, without and with the mesh: handles, the allocator,
                # and the mesh path's first imports
                Engine(model, max_len=p + steps).generate({"tokens": tokens[:, :128]}, steps=2)
                with partition.activate(mesh):
                    Engine(model, max_len=p + steps).generate({"tokens": tokens[:, :128]},
                                                              steps=2)
                plain = lm_mesh_run(model, tokens, steps, counters=counters, group_tokens=b * p)
                with partition.activate(mesh):
                    meshed = lm_mesh_run(model, tokens, steps, counters=counters,
                                         group_tokens=b * p)
                same_tokens = torch.equal(plain["tokens"], meshed["tokens"])
                same_logits = all(torch.equal(bits(x), bits(y))
                                  for x, y in zip(plain["rows"], meshed["rows"]))
                expect = steps * n_moe
                row = dict(part="nccl_1rank", mesh=[1, 1], backend="nccl", arch=arch,
                           router=cfg.router if n_moe else None, layers=cfg.num_layers,
                           dtype=cfg.dtype, batch=b, prompt=p, steps=steps, init_s=init_s,
                           prefill_ms=meshed["prefill_ms"],
                           decode_ms_median=meshed["decode_ms_median"],
                           decode_ms_p10_p90=[meshed["decode_ms_p10"], meshed["decode_ms_p90"]],
                           max_memory_allocated=meshed["peak"],
                           unsplit_prefill_ms=plain["prefill_ms"],
                           unsplit_decode_ms_median=plain["decode_ms_median"],
                           unsplit_decode_ms_p10_p90=[plain["decode_ms_p10"],
                                                      plain["decode_ms_p90"]],
                           unsplit_max_memory_allocated=plain["peak"],
                           weight_bytes=meshed["param_bytes"],
                           decode_bound_ms=(meshed["param_bytes"] + meshed["cache_bytes"])
                           / HBM_BYTES_PER_S * 1e3,
                           tokens_bit_identical=same_tokens, logits_bit_identical=same_logits,
                           router_lps=meshed["lps"], launches=meshed["launches"],
                           routing=meshed["routing"], nvidia_smi=smi_line())
                emit("lm_mesh", **row)
                check(same_tokens and same_logits,
                      f"lm_mesh {arch}: the NCCL (1, 1) mesh run differs from the meshless run")
                for run in (plain, meshed):
                    got = run["launches"]
                    check(run["lps"] == expect and got["simplex"] == expect
                          and got["simplex.cluster"] == expect,
                          f"lm_mesh {arch}: {run['lps']} router LPs, launches {got}, "
                          f"not {expect} of the cluster variant")
                launches = sum_counts([launches, meshed["launches"]])
                del model, plain, meshed
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return launches


def lm_mesh_save_tree(tree, path) -> None:
    """A reference-layout weight tree as one ``.npy`` a leaf under ``path``."""
    from repro_torch.sharding import leaves

    os.makedirs(path, exist_ok=True)
    for keys, arr in leaves(tree):
        np.save(os.path.join(path, ".".join(keys) + ".npy"), arr)


def lm_mesh_load_tree(path) -> dict:
    """:func:`lm_mesh_save_tree`'s tree again, each leaf memory-mapped."""
    tree: dict = {}
    for name in sorted(os.listdir(path)):
        *keys, last = name[:-len(".npy")].split(".")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = np.load(os.path.join(path, name), mmap_mode="c")
    return tree


#: The reference weights that several phases share, drawn once by a helper
#: process that ``start_shared_tree`` starts before slice 9, saved one
#: ``.npy`` a leaf, and memory-mapped by each phase: the deepseek-v2-lite-16b
#: tree of the slice-10, slice-12, slice-14 and slice-15 fixtures (the same
#: arch, depth and seed), then the gemma2-2b tree of slice 15's mesh
#: training fixture (drawn while slice 9 draws its own gemma2 tree).
SHARED_TREE: dict = {}


def lm_tree_writer(keys, out_dir: str) -> None:
    """The helper process: draw ``reference_weights`` of each ``(arch,
    layers, seed)`` in turn and save its tree, then mark it done."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs as rt_configs
    from repro_torch.models.convert import reference_weights

    for arch, layers, seed in keys:
        cut = dataclasses.replace(rt_configs.get_config(arch), num_layers=layers)
        sub = os.path.join(out_dir, f"{arch}-{layers}-{seed}")
        lm_mesh_save_tree(reference_weights(cut, seed), os.path.join(sub, "tree"))
        open(os.path.join(sub, "done"), "w").close()


def start_shared_tree(root: str) -> None:
    """Start drawing the shared trees in a helper process, into a directory
    under ``root``."""
    moe, train = np.load(LM_MOE_FIXTURE), np.load(LM_TRAIN_MESH_FIXTURE)
    keys = [(LM_MOE_ARCH, int(moe["layers"]), int(moe["seed"])),
            (str(train["arch"]), int(train["layers"]), int(train["seed"]))]
    out_dir = os.path.join(root, "shared_tree")
    os.makedirs(out_dir)
    proc = multiprocessing.get_context("spawn").Process(target=lm_tree_writer,
                                                        args=(keys, out_dir))
    proc.start()
    SHARED_TREE.update(keys=keys, dir=out_dir, proc=proc)


def wait_shared_tree() -> float:
    """Wait for the helper process (the timed rows after share the host
    with no draw); returns the seconds waited."""
    t0 = time.perf_counter()
    proc = SHARED_TREE.get("proc")
    if proc is not None:
        proc.join()
    return time.perf_counter() - t0


def shared_tree_dir(cfg, seed: int):
    """The saved tree of ``reference_weights(cfg, seed)`` if the helper
    process draws that one (waiting for it), else None."""
    key = (cfg.name, cfg.num_layers, seed)
    if key not in SHARED_TREE.get("keys", ()):
        return None
    proc = SHARED_TREE["proc"]
    proc.join()
    sub = os.path.join(SHARED_TREE["dir"], "-".join(str(k) for k in key))
    check(os.path.exists(os.path.join(sub, "done")),
          f"the shared weight tree's process failed (exit code {proc.exitcode})")
    return os.path.join(sub, "tree")


def reference_tree(cfg, seed: int):
    """``reference_weights(cfg, seed)``, memory-mapped from the shared tree
    when the helper process draws it, else drawn here."""
    from repro_torch.models.convert import reference_weights

    path = shared_tree_dir(cfg, seed)
    return reference_weights(cfg, seed) if path is None else lm_mesh_load_tree(path)


def lm_mesh_rank_main(rank: int, world: int, store: str, out_dir: str, seed: int,
                      tree_dir: str) -> None:
    """One of the gloo ranks that share the card, on the (2, 2) mesh: each
    case through ``Engine.generate``, then in bfloat16 on the fed tokens,
    then the float32 fixture."""
    import traceback

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(2)
    out = dict(rank=rank)
    try:
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch import configs as rt_configs
        from repro_torch.kernels import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models import Model
        from repro_torch.models.convert import fixture_view, load_reference_params
        from repro_torch.serve.engine import Engine
        from repro_torch.sharding import partition

        counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                    "pdhg": pdhg_cuda}
        mesh_lib.init_distributed("gloo", timeout_s=LM_MESH_TIMEOUT_S / 2, rank=rank,
                                  world_size=world, store=dist.FileStore(store, world))
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(LM_MESH_SHAPE),
                          mesh_dim_names=("data", "model"))
        out["coordinate"] = list(mesh.get_coordinate())
        b, p, steps = LM_MESH_GLOO_BATCH, LM_MESH_GLOO_PROMPT, LM_MESH_GLOO_STEPS
        with partition.activate(mesh):
            for arch, router, layers in LM_MESH_GLOO_CASES:
                cfg = lm_mesh_config(rt_configs, arch, router, layers, LM_MESH_GLOO_DTYPE)
                model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
                tokens = lm_mesh_tokens(cfg, b, p, seed, dev)
                groups = partition.axis_size("batch")
                if arch == LM_MESH_GLOO_CASES[0][0]:
                    # warm-up: the process's first call pays for its handles,
                    # the allocator and the gloo connections
                    Engine(model, max_len=8 + 1).generate({"tokens": tokens[:, :8]}, steps=1)
                run = lm_mesh_run(model, tokens, steps, counters=counters,
                                  group_tokens=b * p // groups)
                out[arch] = dict(
                    tokens=run["tokens"].cpu(), rows=[r.cpu() for r in run["rows"]],
                    batch_rows=[partition.batch_rows(b).start, partition.batch_rows(b).stop],
                    prefill_ms=run["prefill_ms"], decode_ms_median=run["decode_ms_median"],
                    wall_s=run["wall_s"], peak=run["peak"], launches=run["launches"],
                    lps=run["lps"], lp_digests=lm_mesh_lp_digests(run["records"]),
                    records=lm_mesh_records_to(run["records"], "cpu"), routing=run["routing"],
                    stored_bytes=run["param_bytes"] + run["cache_bytes"],
                    spec_bytes=lm_mesh_spec_bytes(model, b, p + steps))
                if cfg.supports_long_context:
                    out[arch]["mixer"] = mixer_spy().lm_mesh_mixer_step(model, tokens,
                                                                        run["tokens"])
                del model, run
                torch.cuda.empty_cache()
            forced = torch.load(os.path.join(out_dir, "forced.pt"), weights_only=False)
            for arch, router, layers in LM_MESH_GLOO_CASES:
                cfg = lm_mesh_config(rt_configs, arch, router, layers, "bfloat16")
                model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
                rows = partition.batch_rows(b)
                # the residual stream of its prefill and decode steps: the
                # layout is float32's, and no call is added for it
                with mixer_spy().ResidualSpy(sums=False) as spy:
                    logits = lm_fixture_logits(model, forced[arch]).float().cpu()
                out[arch]["bf16"] = dict(logits=logits, batch_rows=[rows.start, rows.stop])
                out[arch]["stream"] = mixer_spy().stream_rows(spy, p)
                del model
                torch.cuda.empty_cache()
            fixture = lm_fixture_head(fixture_view(dict(np.load(LM_MESH_FIXTURE)), "lp"),
                                      LM_MESH_FIXTURE_CALLS)
            cut = lm_mesh_config(rt_configs, LM_MOE_ARCH, "lp", int(fixture["layers"]),
                                 "float32")
            model = load_reference_params(Model(cut, device=dev), lm_mesh_load_tree(tree_dir))
            with SimplexSpy(simplex_cuda) as spy:
                logits = lm_fixture_logits(model, fixture)
            rows = partition.batch_rows(np.asarray(fixture["tokens"]).shape[0])
            out["fixture"] = dict(logits=logits.cpu(), batch_rows=[rows.start, rows.stop],
                                  lp_digests=lm_mesh_lp_digests(spy.records),
                                  records=lm_mesh_records_to(spy.records, "cpu"))
            del model
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent reads it and fails the run
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    if "error" in out:
        os._exit(1)


def lm_stream_block(coordinate, shape, batch: int, seq: int) -> list:
    """``[rows, positions, seq]``: the block of a (batch, seq, width) residual
    stream the rank at ``coordinate`` of the (data, model) ``shape`` holds,
    by the reference's rule (each axis cuts its dimension into equal
    blocks where it divides it, else leaves it whole)."""
    out = []
    for idx, n, size in zip(coordinate, shape, (batch, seq)):
        per = size // n if size % n == 0 else size
        lo = idx * per if per < size else 0
        out.append([lo, lo + per])
    return out + [seq]


def lm_mesh_stream_check(arch, rank, stream, batch: int, prompt: int) -> None:
    """A rank's ``mixer_spy.stream_rows``: the prefill's stream is its block
    of the rows and the prompt's positions at every block boundary, and
    reduce-scatters; each decode step's is whole and does not."""
    want = dict(prefill=[lm_stream_block(rank["coordinate"], LM_MESH_SHAPE, batch, prompt)],
                decode=[lm_stream_block(rank["coordinate"], LM_MESH_SHAPE, batch, 1)])
    check(stream["prefill"] == want["prefill"] and stream["decode"] == want["decode"]
          and stream["shapes_match"] and stream["prefill_reduce_scatters"] > 0
          and stream["decode_reduce_scatters"] == 0,
          f"lm_mesh {arch}: rank {rank['rank']}'s residual stream is not its block: {stream}, "
          f"want {want}")


def lm_mesh_whole(ranks, key):
    """Per call, the batch's rows put together from the ranks' blocks
    (``lm_mesh_join``); ``None`` where two ranks holding one block
    disagree in a bit."""
    calls = []
    for i in range(len(ranks[0][key]["rows"])):
        whole, agree = lm_mesh_join((r[key]["batch_rows"], r[key]["rows"][i]) for r in ranks)
        calls.append(whole if agree else None)
    return calls


def lm_mesh_gloo_case(rt_configs, dev, *, seed) -> list:
    """Part (b): LM_MESH_RANKS gloo ranks sharing the card, spawned from
    here, on a (2, 2) mesh, held against this process's run of the same
    cases under the abstract mesh ``{"data": 2, "model": 2}`` (the same
    two token groups) and against the mesh fixture.  Returns each rank's
    launches."""
    import tempfile

    from repro_torch.kernels import simplex_cuda
    from repro_torch.models import Model
    from repro_torch.models.convert import (fixture_view, load_reference_params,
                                            reference_weights, weights_digest)
    from repro_torch.sharding import partition

    check(LM_MESH_FIXTURE.exists(), f"the mesh fixture {LM_MESH_FIXTURE} is missing")
    abstract = dict(zip(("data", "model"), LM_MESH_SHAPE))
    b, p, steps = LM_MESH_GLOO_BATCH, LM_MESH_GLOO_PROMPT, LM_MESH_GLOO_STEPS
    one = {}
    counters = {"simplex": simplex_cuda}
    with partition.activate(abstract):
        for arch, router, layers in LM_MESH_GLOO_CASES:
            cfg = lm_mesh_config(rt_configs, arch, router, layers, LM_MESH_GLOO_DTYPE)
            model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
            tokens = lm_mesh_tokens(cfg, b, p, seed, dev)
            run = lm_mesh_run(model, tokens, steps, counters=counters,
                              group_tokens=b * p // partition.axis_size("batch"))
            run["n_moe"] = moe_layer_count(model)
            run["forced"] = lm_mesh_forced(tokens, run["tokens"], steps)
            run["f32_forced"] = lm_fixture_logits(model, run["forced"]).double().cpu()
            del model
            cfg16 = lm_mesh_config(rt_configs, arch, router, layers, "bfloat16")
            model = Model(cfg16, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
            run["bf16_forced"] = lm_fixture_logits(model, run["forced"]).double().cpu()
            one[arch] = run
            del model
            torch.cuda.empty_cache()
    fixture = fixture_view(dict(np.load(LM_MESH_FIXTURE)), "lp")
    cut = lm_mesh_config(rt_configs, LM_MOE_ARCH, "lp", int(fixture["layers"]), "float32")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        t0 = time.perf_counter()
        tree_dir = shared_tree_dir(cut, int(fixture["seed"]))
        if tree_dir is None:  # the phase alone: draw the tree for the ranks here
            tree_dir = os.path.join(tmp, "tree")
            lm_mesh_save_tree(reference_weights(cut, int(fixture["seed"])), tree_dir)
        tree = lm_mesh_load_tree(tree_dir)
        weights_s = time.perf_counter() - t0
        check(np.array_equal(weights_digest(tree), fixture["weights_digest"]),
              "the mesh fixture's weights drawn here differ from the fixture's")
        with partition.activate(abstract):
            model = load_reference_params(Model(cut, device=dev), tree)
            del tree
            fx_tokens = np.asarray(fixture["tokens"]).shape[0] * int(fixture["prompt_len"])
            with SimplexSpy(simplex_cuda) as spy, RoutingStats() as routing:
                one_fx = lm_fixture_logits(model, fixture)
            one_fx_records = spy.records
            fx_routing = routing.summary(fx_tokens // partition.axis_size("batch"))
            del routing
            del model
        torch.cuda.empty_cache()
        torch.save({arch: one[arch]["forced"] for arch in one}, os.path.join(tmp, "forced.pt"))
        procs = [ctx.Process(target=lm_mesh_rank_main,
                             args=(r, LM_MESH_RANKS, os.path.join(tmp, "store"), tmp, seed,
                                   tree_dir))
                 for r in range(LM_MESH_RANKS)]
        t0 = time.perf_counter()
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + LM_MESH_TIMEOUT_S
        for proc in procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
        alive = [proc for proc in procs if proc.is_alive()]
        for proc in alive:
            proc.kill()
            proc.join()
        check(not alive, f"lm_mesh: {len(alive)} ranks passed {LM_MESH_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(LM_MESH_RANKS):
            path = os.path.join(tmp, f"rank{r}.pt")
            check(os.path.exists(path), f"lm_mesh: rank {r} wrote no result "
                  f"(exit code {procs[r].exitcode})")
            ranks.append(torch.load(path, weights_only=False))
    errors = [f"rank {r['rank']}:\n{r['error']}" for r in ranks if "error" in r]
    check(not errors, "lm_mesh: " + "\n".join(errors))

    for arch, router, layers in LM_MESH_GLOO_CASES:
        ref = one[arch]
        whole = lm_mesh_whole(ranks, arch)
        agree = all(w is not None for w in whole)
        diff = max(float((w.float() - o.float().cpu()).abs().max()) for w, o in
                   zip(whole, ref["rows"])) if agree else None
        same_tokens = [torch.equal(r[arch]["tokens"], ref["tokens"].cpu()) for r in ranks]
        same_lps = all(r[arch]["lp_digests"] == ranks[0][arch]["lp_digests"] for r in ranks)
        lp_check = None
        if ref["n_moe"]:
            view = lm_mesh_lp_view(ref["records"], dev, b, p, ref["n_moe"])
            lp_check = router_lp_checks(view, lm_mesh_records_to(ranks[0][arch]["records"], dev),
                                        dev, rt_configs.get_config(arch).router_groups)
        expect = steps * ref["n_moe"]
        split16, agree16 = lm_mesh_join((r[arch]["bf16"]["batch_rows"],
                                         r[arch]["bf16"]["logits"]) for r in ranks)
        # the padded vocabulary's logits (-1e30, mamba2's 24) left out
        vocab = rt_configs.get_config(arch).vocab_size
        f32, one16 = ref["f32_forced"][..., :vocab], ref["bf16_forced"][..., :vocab]
        split16 = split16[..., :vocab].double()

        def rel(x, y):
            return float((x - y).norm() / y.norm())

        bf16 = dict(rel_l2_to_float32=rel(split16, f32),
                    one_process_rel_l2_to_float32=rel(one16, f32),
                    limit=LM_BF16_FACTOR * rel(one16, f32),
                    rel_l2_to_one_process=rel(split16, one16),
                    max_abs_to_one_process=float((split16 - one16).abs().max()),
                    rows_agree_across_model_ranks=agree16)
        ssm = rt_configs.get_config(arch).supports_long_context
        f32_gate = None
        if agree:
            got = torch.stack([w[..., :vocab].double() for w in whole])
            want = torch.stack([o[..., :vocab].double().cpu() for o in ref["rows"]])
            f32_gate = dict(max_abs=float((got - want).abs().max()),
                            abs_limit=LM_ABS_TOL * max(1.0, float(want.abs().max())),
                            rel_l2=float((got - want).norm() / want.norm()),
                            rel_limit=LM_REL_TOL)
        mixer = [r[arch]["mixer"] for r in ranks] if ssm else None
        heads = mixer_spy().mesh_heads(rt_configs.get_config(arch), LM_MESH_SHAPE[1]) \
            if ssm else None
        row = dict(part="gloo_4ranks_sharing_one_card", mesh=list(LM_MESH_SHAPE), arch=arch,
                   router=router, layers=layers, dtype=LM_MESH_GLOO_DTYPE,
                   float32_logits_to_one_process=f32_gate, heads_a_rank=heads,
                   mixer_per_rank=mixer,
                   batch=b, prompt=p, steps=steps,
                   label="4 ranks sharing one card: says nothing about scaling",
                   tokens_equal_to_one_process=same_tokens, rows_agree_across_model_ranks=agree,
                   logits_max_abs_diff_to_one_process=diff, lps_bit_identical_across_ranks=same_lps,
                   router_lp_checks=lp_check, bf16_fed_tokens=bf16,
                   one_process=dict(prefill_ms=ref["prefill_ms"],
                                    decode_ms_median=ref["decode_ms_median"],
                                    max_memory_allocated=ref["peak"],
                                    stored_bytes=ref["param_bytes"] + ref["cache_bytes"],
                                    routing=ref["routing"]),
                   ranks=[dict(coordinate=r["coordinate"],
                               **{k: r[arch][k] for k in ("prefill_ms", "decode_ms_median",
                                                          "wall_s", "peak", "stored_bytes",
                                                          "spec_bytes", "lps", "routing")},
                               stream_rows=r[arch]["stream"],
                               launches={k: v for k, v in r[arch]["launches"].items() if v})
                          for r in ranks],
                   nvidia_smi=smi_line())
        emit("lm_mesh", **row)
        check(all(same_tokens) and agree,
              f"lm_mesh {arch}: the ranks' tokens or rows differ from the one-process run's")
        check(same_lps, f"lm_mesh {arch}: the ranks' router LPs are not the same bits")
        for r in ranks:
            lm_mesh_stream_check(arch, r, r[arch]["stream"], b, p)
        if ssm:
            check(f32_gate["max_abs"] <= f32_gate["abs_limit"]
                  and f32_gate["rel_l2"] <= f32_gate["rel_limit"],
                  f"lm_mesh {arch}: the ranks' float32 logits miss the one process's: "
                  f"{f32_gate}")
            for r, m in zip(ranks, mixer):
                check(m["scan_heads"] == [heads] and m["decode_heads"] == [heads]
                      and not m["whole_leaf_gathers"]
                      and m["decode_mixer_model_gather_bytes"]
                      < m["parent_decode_mixer_model_gather_bytes"],
                      f"lm_mesh {arch}: rank {r['rank']}'s mixers ran or gathered otherwise "
                      f"than the head split: {m}")
        check(agree16 and bf16["rel_l2_to_float32"] <= bf16["limit"],
              f"lm_mesh {arch}: the ranks' bfloat16 logits miss the bfloat16 gate: {bf16}")
        check(lp_check is None or lp_check["ok"],
              f"lm_mesh {arch}: a rank's router LPs against the one-process LPs: {lp_check}")
        for r in ranks:
            got = r[arch]
            check(got["stored_bytes"] == got["spec_bytes"],
                  f"lm_mesh {arch}: rank {r['rank']} stores {got['stored_bytes']} bytes, its "
                  f"placements {got['spec_bytes']}")
            check(got["peak"] < ref["peak"],
                  f"lm_mesh {arch}: rank {r['rank']}'s peak {got['peak']} is not below the "
                  f"one-process run's {ref['peak']}")
            check(got["lps"] == expect and got["launches"]["simplex"] == expect
                  and got["launches"]["simplex.cluster"] == expect,
                  f"lm_mesh {arch}: rank {r['rank']} solved {got['lps']} router LPs, launches "
                  f"{got['launches']}, not {expect} of the cluster variant")
        if ref["n_moe"]:
            check(ref["routing"]["prefill"]["dropped"] > 0,
                  f"lm_mesh {arch}: no token group dropped a token: {ref['routing']}")

    # The float32 fixture: the ranks' logits and the one-process run's
    # against the reference under the same mesh, and their router LPs.
    mesh_fx, fx_agree = lm_mesh_join((r["fixture"]["batch_rows"], r["fixture"]["logits"])
                                     for r in ranks)
    head = lm_fixture_head(fixture, LM_MESH_FIXTURE_CALLS)
    res_mesh = lm_mesh_fixture_check(mesh_fx, head)
    res_one = lm_mesh_fixture_check(one_fx, fixture)
    groups = rt_configs.get_config(LM_MOE_ARCH).router_groups
    n_moe = len(set(np.asarray(fixture["router_layer"]).tolist()))
    rank_records = lm_mesh_records_to(ranks[0]["fixture"]["records"], dev)
    lp_mesh = router_lp_checks(head, rank_records, dev, groups)
    lp_one = router_lp_checks(fixture, one_fx_records, dev, groups)
    one_head = one_fx_records[:LM_MESH_FIXTURE_CALLS * n_moe]
    fx_b, fx_p = np.asarray(fixture["tokens"]).shape[0], int(fixture["prompt_len"])
    lp_mesh_one = router_lp_checks(lm_mesh_lp_view(one_head, dev, fx_b, fx_p, n_moe),
                                   rank_records, dev, groups)
    same_fx_lps = all(r["fixture"]["lp_digests"] == ranks[0]["fixture"]["lp_digests"]
                      for r in ranks)
    one_cut = one_fx[:, :LM_MESH_FIXTURE_CALLS].double().cpu()
    rel_to_one = float((mesh_fx.double() - one_cut).norm() / one_cut.norm())
    emit("lm_mesh_reference", arch=LM_MOE_ARCH, layers=cut.num_layers, dtype="float32",
         fixture=str(LM_MESH_FIXTURE.relative_to(ROOT)), mesh=list(LM_MESH_SHAPE),
         tokens=list(np.asarray(fixture["tokens"]).shape), weights_s=weights_s,
         ranks=dict(worst_ratio=res_mesh["worst_ratio"], f64_worst_ratio=res_mesh["f64_worst_ratio"],
                    ok=res_mesh["ok"], router_lps_ok=lp_mesh["ok"],
                    router_lps_basis_equal=lp_mesh["port_basis_equal"],
                    router_lps_ok_against_one_process=lp_mesh_one["ok"],
                    router_lps_basis_equal_to_one_process=lp_mesh_one["port_basis_equal"],
                    calls=LM_MESH_FIXTURE_CALLS,
                    lps_bit_identical_across_ranks=same_fx_lps,
                    rows_agree_across_model_ranks=fx_agree),
         one_process=dict(worst_ratio=res_one["worst_ratio"],
                          f64_worst_ratio=res_one["f64_worst_ratio"], ok=res_one["ok"],
                          router_lps_ok=lp_one["ok"],
                          router_lps_basis_equal=lp_one["port_basis_equal"]),
         ranks_rel_l2_to_one_process=rel_to_one, group_wall_s=wall, routing=fx_routing)
    check(fx_routing["prefill"]["dropped"] > 0,
          f"lm_mesh_reference: no token group of the fixture's prefill dropped a token: "
          f"{fx_routing}")
    check(res_mesh["ok"] and res_one["ok"],
          f"lm_mesh_reference: the logits miss the mesh fixture: ranks {res_mesh}, "
          f"one process {res_one}")
    check(fx_agree, "lm_mesh_reference: ranks that run the same rows hold other logits")
    check(lp_mesh["ok"] and lp_one["ok"] and lp_mesh_one["ok"] and same_fx_lps,
          f"lm_mesh_reference: router LPs: ranks {lp_mesh}, one process {lp_one}, ranks "
          f"against one process {lp_mesh_one}")
    return [{arch: r[arch]["launches"] for arch, _, _ in LM_MESH_GLOO_CASES} for r in ranks]


def lm_mesh_phase(rt_configs, dev, *, seed, counters, reset) -> dict:
    """Slice 14: (a) NCCL with one rank, then (b) gloo ranks sharing the card.

    Returns the launches of (a) in this process and each rank's of (b)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset()
    nccl = lm_mesh_nccl_case(rt_configs, dev, seed=seed, counters=counters)
    per_rank = lm_mesh_gloo_case(rt_configs, dev, seed=seed)
    emit("main_path_summary", path="slice14_lm_mesh", launches_nccl_1rank=nccl,
         launches_per_rank=per_rank, wall_s=time.perf_counter() - t0)
    return dict(nccl=nccl, per_rank=per_rank)


# ---------------------------------------------------------------------------
# Slice 15: training on a device mesh
# ---------------------------------------------------------------------------

#: (a) NCCL with one rank on the card, a (1, 1) mesh: gemma2-2b at full
#: width and depth in bfloat16 with float32 master weights, remat,
#: ``LM_TRAIN_MICRO`` rows of ``LM_TRAIN_SEQ`` tokens a microbatch and
#: ``LM_TRAIN_ACCUM`` microbatches, ``LM_TRAIN_MESH_NCCL_STEPS`` steps,
#: first without a mesh, then on the mesh (one model on the card at a
#: time); after each step the parameters and the optimizer state must be
#: the same bits (held by digest).  Deterministic algorithms on.
LM_TRAIN_MESH_NCCL_BACKEND = "nccl"
LM_TRAIN_MESH_NCCL_STEPS = 2
#: (b) gloo ranks sharing the card on a (data, model) = (2, 2) mesh, in
#: float32: gemma2-2b at the mesh fixture's depth, width, batch and steps
#: (``tools/lm_reference_fixture.py --train --layers 4 --mesh 2,2``: the
#: reference's sharded train step, 3 steps of 4 x 128 tokens, accum 2),
#: held against the fixture and against this process's run under the
#: abstract (2, 2) mesh; mamba2-130m cut to 1 layer (its checkpoint is
#: mostly the embedding), checkpointed every 2 steps, preempted at step 3
#: and resumed, its step-2 checkpoint restored onto (4, 1) and onto one
#: process; and deepseek's eval step under ``lp`` on the eval fixture's
#: 3 layers and batch.
LM_TRAIN_MESH_RANKS, LM_TRAIN_MESH_SHAPE = 4, (2, 2)
LM_TRAIN_MESH_FIXTURE = ROOT / "tests" / "data" / "lm_train_gemma2_2b_mesh_reference.npz"
LM_TRAIN_MESH_SSM, LM_TRAIN_MESH_SSM_LAYERS = "mamba2-130m", 1
LM_TRAIN_MESH_SSM_STEPS, LM_TRAIN_MESH_CKPT_EVERY, LM_TRAIN_MESH_PREEMPT_AT = 4, 2, 3
LM_TRAIN_MESH_SSM_BATCH, LM_TRAIN_MESH_SSM_SEQ = 4, 128
#: The MoE training case (``lm_train_mesh_moe_case``), which the ``gpu``
#: test tier runs and the script does not (each MoE layer's float32
#: experts cross the host through gloo at every pass: ≈ 40 s a step on the
#: ranks on an H100 80GB HBM3): deepseek-v2-lite-16b (``topk``) at the eval
#: fixture's 3 layers on the mesh fixture's steps, held step by step
#: against a float64 witness, the one-process run under the same abstract
#: mesh in float64 (its optimizer in float32, as every run's): the ranks'
#: distance to it within ``LM_F64_FACTOR`` times the largest of the
#: float32 one-process runs' (plain and one-ulp nudged by each seed of
#: ``LM_TRAIN_MESH_NUDGES``), or the floor.  A sign of Adam's first steps
#: (``lr * sign(g)``) flips where a routing choice flips, so the
#: one-process gate of ``lm_train_mesh_gates`` (the ranks within
#: ``LM_NOISE_FACTOR`` times the nudges' largest change) is reported, with
#: the routing flips of each run against the one-process run.  Elements
#: sampled from each leaf of its change (the fixture samples gemma2's).
LM_TRAIN_MESH_SAMPLE = 4096
LM_TRAIN_MESH_NUDGES = (1, 2, 3, 4)
LM_TRAIN_MESH_FLIP_SHARE = 1e-3
LM_TRAIN_MESH_TIMEOUT_S = 600


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def device_digest(tensors) -> str:
    """A digest of the bits of ``tensors`` (in order), computed on their
    device: each chunk of 2^24 elements viewed as integers, weighted by a
    position hash and summed in int64 (wrapping), and the sums hashed."""
    import hashlib

    h = hashlib.sha256()
    chunk = 1 << 24
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    for t in tensors:
        flat = t.detach().reshape(-1).view(ints[t.element_size()])
        weights = None
        for lo in range(0, flat.numel(), chunk):
            part = flat[lo:lo + chunk].to(torch.int64)
            if weights is None or weights.numel() != part.numel():
                weights = torch.arange(part.numel(), device=part.device, dtype=torch.int64)
                weights = weights * 2654435761 + 97
            h.update(int((part * weights).sum()).to_bytes(8, "little", signed=True))
        h.update(str(tuple(t.shape)).encode())
    return h.hexdigest()


def state_digest(model, state) -> str:
    """:func:`device_digest` of the model's parameters and the optimizer's
    ``m``, ``v`` and master (this rank's slices)."""
    tensors = [p for p in model.parameters()]
    for field in (state.m, state.v, state.master):
        tensors += list(field.values()) if field is not None else []
    return device_digest(tensors)


def lm_train_mesh_nccl_case(rt_configs, dev, *, seed, train_row, tmp_root) -> dict:
    """Part (a): gemma2-2b's steps without a mesh and on a one-rank NCCL
    (1, 1) mesh, bit-identical after every step; each run's step ms and
    peak beside slice 12's ``lm_train`` row."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import Model
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = rt_configs.get_config("gemma2-2b")
    batch = LM_TRAIN_MICRO * LM_TRAIN_ACCUM
    data = SyntheticLM(DataConfig(cfg.vocab_size, LM_TRAIN_SEQ, batch, seed=seed))

    def run():
        model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
        ocfg = opt.OptConfig()
        state = opt.init(dict(model.named_parameters()), ocfg)
        step = make_train_step(model, ocfg, accum=LM_TRAIN_ACCUM, remat=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = dict(digests=[], loss=[], grad_norm=[], step_ms=[])
        for s in range(LM_TRAIN_MESH_NCCL_STEPS):
            b = to_device(data.batch(s), dev)
            sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            sync(dev)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            out["digests"].append(state_digest(model, state))
        out["peak"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        del model, state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = run()
        with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
            mesh_lib.init_distributed(LM_TRAIN_MESH_NCCL_BACKEND, device=dev, timeout_s=300.0,
                                      rank=0, world_size=1,
                                      store=dist.FileStore(os.path.join(tmp, "store"), 1))
            try:
                with partition.activate(mesh_lib.make_local_mesh(device=dev)):
                    meshed = run()
            finally:
                dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    same = [a == b for a, b in zip(plain["digests"], meshed["digests"])]
    row = dict(part="nccl_1rank", mesh=[1, 1], backend=LM_TRAIN_MESH_NCCL_BACKEND,
               arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype, master_weights=True,
               micro_batch=LM_TRAIN_MICRO, accum=LM_TRAIN_ACCUM, seq=LM_TRAIN_SEQ,
               steps=LM_TRAIN_MESH_NCCL_STEPS, deterministic_algorithms=True,
               step_ms=meshed["step_ms"], peak_memory_bytes=meshed["peak"],
               unsplit_step_ms=plain["step_ms"], unsplit_peak_memory_bytes=plain["peak"],
               loss=meshed["loss"], grad_norm=meshed["grad_norm"],
               state_bit_identical_after_each_step=same,
               slice12_lm_train=None if train_row is None else dict(
                   step_ms_median=train_row["step_ms_median"],
                   peak_memory_bytes=train_row["peak_memory_bytes"],
                   note=f"{LM_TRAIN_TIMED} timed steps after a warm-up, no mesh, "
                        "deterministic algorithms off"),
               nvidia_smi=smi_line())
    emit("lm_train_mesh", **row)
    check(all(same) and len(same) == LM_TRAIN_MESH_NCCL_STEPS,
          f"lm_train_mesh: the NCCL (1, 1) steps differ from the meshless steps: {same}")
    check(all(np.isfinite(meshed["loss"])), f"lm_train_mesh: non-finite loss {meshed['loss']}")
    return row


def lm_nudge(model, seed: int) -> None:
    """Every parameter one ulp up or down (a seeded coin an element)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            up = torch.rand(p.shape, generator=gen, device=p.device) < 0.5
            inf = torch.tensor(float("inf"), dtype=p.dtype, device=p.device)
            p.copy_(torch.nextafter(p, torch.where(up, inf, -inf)))


def lm_leaf_samples(tree, seed: int, size: int) -> dict:
    """Sampled flat indices of every leaf of a reference-layout tree, in the
    training fixtures' layout (``leaf_paths``, ``sample_sizes``,
    ``sample_idx``; all of a leaf of at most ``size`` elements)."""
    from repro_torch.sharding import leaves

    rng = np.random.default_rng(seed)
    paths, sizes, idx = [], [], []
    for path, arr in leaves(tree):
        n = int(np.prod(arr.shape))
        pick = np.arange(n) if n <= size else np.sort(rng.choice(n, size, replace=False))
        paths.append("/".join(path))
        sizes.append(pick.size)
        idx.append(pick.astype(np.int64))
    return dict(leaf_paths=np.asarray(paths), sample_sizes=np.asarray(sizes),
                sample_idx=np.concatenate(idx))


def lm_samples_of(model, samples) -> np.ndarray:
    """The model's parameters at ``samples`` (a training fixture's layout).
    Under a ``DeviceMesh`` each rank reads the samples its slices hold
    (-inf elsewhere), and an all-reduce max over the mesh puts them
    together on every rank (ranks that hold one slice hold its same
    bits): a vector of samples crosses the mesh, not the model."""
    from repro_torch.models.convert import reference_leaf_of
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding import partition

    if not partition.distributed():
        return lm_model_samples(model, samples)
    names = {}
    for name, leaf in reference_leaf_of(model).items():
        names.setdefault(leaf, []).append(name)
    params = dict(model.named_parameters())
    out = []
    for path, idx in lm_sample_slices(samples):
        members = names[path]
        spec = params[members[0]].spec
        layer, rest = np.divmod(idx, math.prod(spec.shape))
        multi = np.unravel_index(rest, spec.shape)
        ranges = partition.local_slices(spec.shape, spec.axes)
        inside = np.logical_and.reduce([(m >= r.start) & (m < r.stop)
                                        for m, r in zip(multi, ranges)])
        vals = torch.full((idx.size,), -math.inf, dtype=torch.float64, device=model.device)
        for i, name in enumerate(members):
            sel = np.flatnonzero(inside & (layer == i))
            if sel.size:
                local = tuple(torch.as_tensor(m[sel] - r.start, device=model.device)
                              for m, r in zip(multi, ranges))
                vals[torch.as_tensor(sel, device=model.device)] = (
                    params[name].detach()[local].double())
        out.append(vals)
    axes = tuple(partition.mesh_shape(partition.active_mesh()))
    return coll.all_reduce(torch.cat(out), axes, "max").cpu().numpy()


class RouteSpy:
    """Records each ``moe.route`` call's expert choices, its router logits
    (float32; host arrays) and the first token of the rows it routed (0
    where it routed the whole batch): forward and remat's recompute alike,
    in call order.  With ``forced`` (one (T, k) array of experts a call,
    for every token of the batch) each call takes those experts instead of
    its own top k, weighted by the softmax of its own logits at them:
    another run's routing replayed (``router="topk"``, whose logits are
    ``route``'s first line)."""

    def __init__(self, forced=None):
        self.forced = forced

    def __enter__(self):
        from repro_torch.models import moe
        from repro_torch.sharding import collectives as coll

        self.moe, self.real, self.calls = moe, moe.route, []

        def spy(xf, p, cfg, split=None):
            start = 0 if split is None else split[1]
            if self.forced is None:
                weights, experts = self.real(xf, p, cfg, split)
                with torch.no_grad():
                    logits = xf.float() @ coll.weight(p["router"])
            else:
                check(cfg.router == "topk", "RouteSpy replays top-k routing only")
                logits = xf.float() @ coll.weight(p["router"])
                chosen = self.forced[len(self.calls)][start:start + xf.shape[0]]
                experts = torch.as_tensor(chosen, device=xf.device)
                weights = torch.softmax(torch.gather(logits, 1, experts), dim=-1).to(xf.dtype)
            self.calls.append((experts.detach().cpu().numpy(), start,
                               logits.detach().cpu().numpy()))
            return weights, experts

        moe.route = spy
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def lm_train_mesh_run(case, dev, *, nudge=None, forced=None) -> dict:
    """The case's train steps on ``dev`` under the active mesh (a
    ``DeviceMesh``: this rank's slices; an abstract one: every slice):
    each step's loss, ``grad_norm``, ``lr`` and ms, the parameters at the
    case's samples after each step (``afters``; gathered), the peak, the
    bytes stored (parameters and optimizer state) and the placements'
    share of them, the first step's residual stream at the block
    boundaries (``mixer_spy.ResidualSpy``: its blocks, its reduce-scatters)
    and the bytes remat keeps at the layer inputs
    (``mixer_spy.SavedLayerInputs``); with ``case["routes"]`` each step's
    ``moe.route`` calls (``RouteSpy``; ``forced``: a step's routing to
    replay, by step)."""
    import contextlib

    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = case["cfg"]
    model = load_reference_params(Model(cfg, device=dev), lm_mesh_load_tree(case["tree"]))
    out = {}
    if nudge is not None:
        lm_nudge(model, nudge)
        out["start"] = lm_samples_of(model, case["samples"])
    ocfg = opt.OptConfig(lr=case["lr"], warmup_steps=case["warmup"])
    state = opt.init(dict(model.named_parameters()), ocfg)
    step = make_train_step(model, ocfg, accum=case["accum"], remat=True)
    data = SyntheticLM(DataConfig(cfg.vocab_size, case["seq"], case["batch"], seed=case["seed"]))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out.update(loss=[], grad_norm=[], lr=[], step_ms=[], afters=[], routes=[])
    spies = mixer_spy()
    for s in range(case["steps"]):
        b = to_device(data.batch(s), dev)
        spy = RouteSpy(forced[s] if forced else None) if case.get("routes") else None
        # the first step's residual stream and the layer inputs remat keeps
        stream = spies.ResidualSpy(sums=False) if s == 0 else None
        saved = spies.SavedLayerInputs() if s == 0 else None
        with spy or contextlib.nullcontext(), stream or contextlib.nullcontext(), \
                saved or contextlib.nullcontext():
            sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            sync(dev)
        if s == 0:
            out.update(stream_rows=stream.blocks(), stream_shapes_match=stream.shapes_match(),
                       reduce_scatters=len(stream.scatters),
                       saved_layer_input_bytes=saved.bytes)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(m[k]))
        out["routes"].append(spy.calls if spy is not None else None)
        out["afters"].append(lm_samples_of(model, case["samples"]))
    out["after"] = out["afters"][-1]
    out["peak"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    stored = sum(t.numel() * t.element_size() for t in model.parameters())
    stored += sum(t.numel() * t.element_size() for f in (state.m, state.v, state.master)
                  for t in f.values())
    share = 0
    for spec in model.abstract_params().values():
        n = math.prod(partition.local_shape(spec.shape, spec.axes))
        share += n * (torch.empty((), dtype=getattr(torch, spec.dtype)).element_size() + 12)
    out.update(stored_bytes=stored, spec_bytes=share)
    del model, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def lm_train_mesh_ssm(cfg, dev, *, seed, ckpt_root, mesh41) -> dict:
    """mamba2 on this rank's mesh through ``TrainDriver``: uninterrupted,
    then checkpointed every ``LM_TRAIN_MESH_CKPT_EVERY`` steps, preempted
    at ``LM_TRAIN_MESH_PREEMPT_AT`` and resumed by a new model and driver
    (the digest of this rank's slices after each run); then the step-2
    checkpoint restored onto ``mesh41`` (the digest of the gathered
    restored state against the checkpoint's arrays')."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.models import Model
    from repro_torch.runtime.fault import DriverConfig, Preemption, TrainDriver
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    data = SyntheticLM(DataConfig(cfg.vocab_size, LM_TRAIN_MESH_SSM_SEQ, LM_TRAIN_MESH_SSM_BATCH,
                                  seed=seed))

    def setup(ckpt_dir):
        model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
        ocfg = opt.OptConfig(lr=1e-3, warmup_steps=2)
        state = opt.init(dict(model.named_parameters()), ocfg)
        driver = TrainDriver(DriverConfig(ckpt_dir, ckpt_every=LM_TRAIN_MESH_CKPT_EVERY,
                                          log_every=1), model,
                             make_train_step(model, ocfg, remat=True), data.batch,
                             put_fn=lambda b: to_device(b, dev))
        return model, state, driver

    out = {}
    model, state, driver = setup(None)
    state, hist = driver.run(state, LM_TRAIN_MESH_SSM_STEPS)
    out["uninterrupted"] = state_digest(model, state)  # this rank's slices
    out["loss"] = [m["loss"] for _, m in hist]
    ckpt_dir = os.path.join(ckpt_root, "ssm")
    _, state, driver = setup(ckpt_dir)
    try:
        driver.run(state, LM_TRAIN_MESH_SSM_STEPS, preempt_at=LM_TRAIN_MESH_PREEMPT_AT)
        out["preempted"] = False
    except Preemption:
        out["preempted"] = True
    out["resumed_from"] = ckpt.latest_step(ckpt_dir)
    model, state, driver = setup(ckpt_dir)
    with torch.no_grad():  # the restore must overwrite these
        for p in model.parameters():
            p.zero_()
    state, hist = driver.run(state, LM_TRAIN_MESH_SSM_STEPS)
    out["resumed_steps"] = [s for s, _ in hist]
    out["resumed"] = state_digest(model, state)
    step2 = LM_TRAIN_MESH_CKPT_EVERY
    out["checkpoint"] = npz_digest(os.path.join(ckpt_dir, f"step_{step2:08d}"))
    with partition.activate(mesh41):
        model, state, driver = setup(ckpt_dir)
        _, state = driver.resume_or_init(state, step2)
        out["restored_41"] = tree_digest(driver.state(state))
    return out


def tree_digest(tree) -> str:
    """A digest of a checkpoint tree's leaves as ``ckpt.save`` stores them."""
    import hashlib

    from repro_torch.ckpt import checkpoint as ckpt

    h = hashlib.sha256()
    for leaf in ckpt._flatten(tree):
        arr, name = ckpt._to_storable(leaf)
        h.update(name.encode() + str(arr.shape).encode() + np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def npz_digest(step_dir: str) -> str:
    """:func:`tree_digest` of a written checkpoint's arrays."""
    import hashlib

    with open(os.path.join(step_dir, "manifest.json")) as f:
        meta = json.load(f)["leaves"]
    h = hashlib.sha256()
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        for i, m in enumerate(meta):
            arr = data[f"a{i}"]
            h.update(m["dtype"].encode() + str(arr.shape).encode()
                     + np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def lm_eval_mesh(cfg, tree_dir, batch, dev) -> dict:
    """deepseek's eval step under ``lp`` on ``dev`` under the active mesh:
    the loss, each router LP's digest, whether each captured launch
    replays bit-identical on ``simplex_plain``, and the launches."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import simplex_cuda
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params
    from repro_torch.train.train_step import make_eval_step

    model = load_reference_params(Model(cfg, device=dev), lm_mesh_load_tree(tree_dir))
    before = launch_counts({"simplex": simplex_cuda})
    with SimplexSpy(simplex_cuda) as spy:
        loss = float(make_eval_step(model)(to_device(batch, dev)))
    launches = count_delta({"simplex": simplex_cuda}, before)
    out = dict(loss=loss, lps=spy.calls, launches=launches,
               lp_digests=lm_mesh_lp_digests(spy.records),
               replayed_bit_identical=[replay_plain(rec) for rec in spy.records])
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def lm_train_mesh_rank_main(rank: int, world: int, store: str, out_dir: str,
                            device_type: str) -> None:
    """One of the gloo ranks of part (b): the plan's train cases on the
    (2, 2) mesh, then (where the plan has them) mamba2's checkpoints and
    deepseek's eval step under ``lp``."""
    import traceback

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(2)
    out = dict(rank=rank)
    try:
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.kernels import hyperbox_cuda, pdhg_cuda, revised_cuda, simplex_cuda
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.sharding import partition

        mesh_lib.init_distributed("gloo", device="cpu" if device_type == "cpu" else None,
                                  timeout_s=LM_TRAIN_MESH_TIMEOUT_S / 2, rank=rank,
                                  world_size=world, store=dist.FileStore(store, world))
        dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
               else torch.device("cpu"))
        plan = torch.load(os.path.join(out_dir, "plan.pt"), weights_only=False)
        mesh = DeviceMesh(device_type, torch.arange(world).reshape(LM_TRAIN_MESH_SHAPE),
                          mesh_dim_names=("data", "model"))
        mesh41 = DeviceMesh(device_type, torch.arange(world).reshape(world, 1),
                            mesh_dim_names=("data", "model"))
        out["coordinate"] = list(mesh.get_coordinate())
        times, t0 = {}, time.perf_counter()
        with partition.activate(mesh):
            for case in plan["train"]:
                out[case["name"]] = lm_train_mesh_run(case, dev)
                times[case["name"]] = time.perf_counter() - t0
            if plan.get("ssm") is not None:
                with mixer_spy().MixerSpy() as spy:
                    out["ssm"] = lm_train_mesh_ssm(plan["ssm"], dev, seed=plan["seed"],
                                                   ckpt_root=out_dir, mesh41=mesh41)
                out["ssm"]["scan_heads"] = sorted(set(spy.scan_heads))
                times["ssm"] = time.perf_counter() - t0
            if plan.get("eval") is not None:
                ev = plan["eval"]
                out["eval"] = lm_eval_mesh(ev["cfg"], ev["tree"], ev["batch"], dev)
                times["eval"] = time.perf_counter() - t0
        out["seconds_from_start"] = times
        out["launches"] = launch_counts({"simplex": simplex_cuda, "hyperbox": hyperbox_cuda,
                                         "revised": revised_cuda, "pdhg": pdhg_cuda})
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent reads it and fails the run
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    if "error" in out:
        os._exit(1)


def lm_leaf_slices(samples):
    """(index, leaf path, slice of the flat samples) for each leaf of a
    training fixture's sample layout."""
    at = 0
    for j, (path, n) in enumerate(zip(samples["leaf_paths"], samples["sample_sizes"])):
        yield j, str(path), slice(at, at + int(n))
        at += int(n)


def lm_train_mesh_gates(got, one, noise) -> dict:
    """A rank's run against the one-process run: each step's loss and
    ``grad_norm`` by relative error, each leaf's change at the samples by
    ``trimmed_rel``, each within the largest of its floor and
    ``LM_NOISE_FACTOR`` times its one-ulp noise (``noise``: relative, by
    step, and one value a leaf); the worst ratio and ``ok``."""
    from repro_torch.models.convert import trimmed_rel

    ratios = {}
    for key in ("loss", "grad_norm"):
        for i, (a, b) in enumerate(zip(got[key], one[key])):
            tol = max(LM_TRAIN_SCALAR_FLOOR, LM_NOISE_FACTOR * float(noise[key][i]))
            ratios[f"{key}[{i}]"] = abs(a / b - 1.0) / tol
    for j, path, sl in lm_leaf_slices(one["samples"]):
        d_got, d_one = got["after"][sl] - one["start"][sl], one["after"][sl] - one["start"][sl]
        tol = max(LM_TRAIN_LEAF_FLOOR, LM_NOISE_FACTOR * float(noise["delta"][j]))
        ratios[f"delta/{path}"] = trimmed_rel(d_got, d_one, LM_TRAIN_MESH_FLIP_SHARE) / tol
    top = max(ratios, key=ratios.get)
    return dict(worst_ratio=ratios[top], worst=top, ok=bool(ratios[top] <= 1.0),
                lr_equal=got["lr"] == one["lr"])


def lm_train_mesh_tree(cfg, seed: int, out_dir: str, name: str) -> str:
    """The saved reference weights of ``(cfg, seed)``: the helper process's
    (``shared_tree_dir``) when it draws them, else drawn here (the phase or
    case alone) into ``out_dir/name``."""
    from repro_torch.models.convert import reference_weights

    tree_dir = shared_tree_dir(cfg, seed)
    if tree_dir is None:
        tree_dir = os.path.join(out_dir, name)
        lm_mesh_save_tree(reference_weights(cfg, seed), tree_dir)
    return tree_dir


def lm_train_mesh_steps(fixture) -> dict:
    """The mesh training fixture's steps: tokens a row, rows, steps,
    microbatches, ``lr`` and warm-up."""
    return dict(seq=int(fixture["seq"]), batch=int(fixture["batch"]), steps=int(fixture["steps"]),
                accum=int(fixture["accum"]), lr=float(fixture["lr"]),
                warmup=int(fixture["warmup_steps"]))


def lm_train_mesh_group(plan, dev, out_dir: str):
    """``plan`` on ``LM_TRAIN_MESH_RANKS`` gloo ranks spawned from here on
    ``dev``'s type: each rank's result and the group's seconds.  A rank
    that fails, writes nothing or passes ``LM_TRAIN_MESH_TIMEOUT_S`` fails
    the run."""
    torch.save(plan, os.path.join(out_dir, "plan.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=lm_train_mesh_rank_main,
                         args=(r, LM_TRAIN_MESH_RANKS, os.path.join(out_dir, "store"), out_dir,
                               dev.type))
             for r in range(LM_TRAIN_MESH_RANKS)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + LM_TRAIN_MESH_TIMEOUT_S
    for proc in procs:
        proc.join(timeout=max(1.0, deadline - time.monotonic()))
    alive = [proc for proc in procs if proc.is_alive()]
    for proc in alive:
        proc.kill()
        proc.join()
    check(not alive, f"lm_train_mesh: {len(alive)} ranks passed {LM_TRAIN_MESH_TIMEOUT_S} s")
    group_s = time.perf_counter() - t0
    ranks = []
    for r in range(LM_TRAIN_MESH_RANKS):
        path = os.path.join(out_dir, f"rank{r}.pt")
        check(os.path.exists(path), f"lm_train_mesh: rank {r} wrote no result "
                                    f"(exit code {procs[r].exitcode})")
        ranks.append(torch.load(path, weights_only=False))
    errors = [f"rank {r['rank']}:\n{r['error']}" for r in ranks if "error" in r]
    check(not errors, "lm_train_mesh: " + "\n".join(errors))
    for r in range(LM_TRAIN_MESH_RANKS):
        os.remove(os.path.join(out_dir, f"rank{r}.pt"))
    return ranks, group_s


def lm_train_mesh_rank_rows(name: str, ranks, one, dev, case) -> list:
    """Each rank's step ms, peak and stored bytes beside the placements'
    share and the one-process run's, its residual stream's block in the
    first step and the bytes remat kept at its layer inputs beside one
    process's; fails unless every rank holds the same losses and samples
    after every step, stores its placements' bytes, holds its block of the
    ``case``'s microbatch rows and positions (``lm_stream_block``) and
    keeps 1 / ranks of one process's layer-input bytes, and (on the card)
    peaks below the one-process run."""
    agree = all(r[name]["loss"] == ranks[0][name]["loss"]
                and all(np.array_equal(a, b) for a, b in zip(r[name]["afters"],
                                                             ranks[0][name]["afters"]))
                for r in ranks)
    check(agree, f"lm_train_mesh {name}: the ranks' losses or parameters differ")
    rows = []
    for r in ranks:
        got = r[name]
        check(got["stored_bytes"] == got["spec_bytes"],
              f"lm_train_mesh {name}: rank {r['rank']} stores {got['stored_bytes']} bytes, "
              f"its placements {got['spec_bytes']}")
        check(dev.type != "cuda" or got["peak"] < one["peak"],
              f"lm_train_mesh {name}: rank {r['rank']}'s peak {got['peak']} is not below "
              f"the one-process run's {one['peak']}")
        micro = case["batch"] // case["accum"]
        want = [lm_stream_block(r["coordinate"], LM_TRAIN_MESH_SHAPE, micro, case["seq"])]
        check(got["stream_rows"] == want and got["stream_shapes_match"]
              and got["reduce_scatters"] > 0,
              f"lm_train_mesh {name}: rank {r['rank']}'s residual stream is not its block: "
              f"{got['stream_rows']}, want {want}")
        split = math.prod(LM_TRAIN_MESH_SHAPE)
        check(got["saved_layer_input_bytes"] * split == one["saved_layer_input_bytes"],
              f"lm_train_mesh {name}: rank {r['rank']} keeps {got['saved_layer_input_bytes']} "
              f"bytes at the layer inputs, not 1/{split} of one process's "
              f"{one['saved_layer_input_bytes']}")
        rows.append(dict(coordinate=r["coordinate"], step_ms=got["step_ms"], peak=got["peak"],
                         stored_bytes=got["stored_bytes"], spec_bytes=got["spec_bytes"],
                         share_of_one_process=got["stored_bytes"] / one["stored_bytes"],
                         stream_rows=got["stream_rows"],
                         saved_layer_input_bytes=got["saved_layer_input_bytes"],
                         one_process_saved_layer_input_bytes=one["saved_layer_input_bytes"]))
    return rows


def lm_train_mesh_gloo_case(rt_configs, dev, *, seed, out_dir) -> list:
    """Part (b): gemma2's one-process run under the abstract (2, 2) mesh
    here, then ``LM_TRAIN_MESH_RANKS`` gloo ranks spawned from here on the
    card, held against it, the mesh fixture and the checkpoints.  Returns
    each rank's launches."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.models.convert import weights_digest
    from repro_torch.runtime.fault import DriverConfig, TrainDriver
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer as opt

    check(LM_TRAIN_MESH_FIXTURE.exists(), f"the mesh train fixture {LM_TRAIN_MESH_FIXTURE} "
                                          "is missing")
    fixture = dict(np.load(LM_TRAIN_MESH_FIXTURE))
    check(tuple(fixture["mesh"]) == LM_TRAIN_MESH_SHAPE,
          f"lm_train_mesh: the fixture's mesh {fixture['mesh']} is not {LM_TRAIN_MESH_SHAPE}")
    steps = lm_train_mesh_steps(fixture)
    t0 = time.perf_counter()
    gemma = dataclasses.replace(rt_configs.get_config(str(fixture["arch"])),
                                num_layers=int(fixture["layers"]), dtype="float32")
    gemma_dir = lm_train_mesh_tree(gemma, int(fixture["seed"]), out_dir, "gemma_tree")
    check(np.array_equal(weights_digest(lm_mesh_load_tree(gemma_dir)), fixture["weights_digest"]),
          "lm_train_mesh: the weights drawn here differ from the mesh fixture's")
    evl = dict(np.load(LM_EVAL_FIXTURE))
    ev_cfg = dataclasses.replace(rt_configs.get_config(LM_MOE_ARCH), num_layers=int(evl["layers"]),
                                 router=str(evl["router"]), dtype="float32")
    moe_dir = lm_train_mesh_tree(ev_cfg, int(evl["seed"]), out_dir, "moe_tree")
    case = dict(name=gemma.name, cfg=gemma, tree=gemma_dir, seed=int(fixture["seed"]),
                samples={k: fixture[k] for k in ("leaf_paths", "sample_sizes", "sample_idx")},
                **steps)
    weights_s = time.perf_counter() - t0
    data = SyntheticLM(DataConfig(gemma.vocab_size, steps["seq"], steps["batch"],
                                  seed=int(fixture["seed"])))
    check(np.array_equal(np.concatenate([data.batch(s)["tokens"].ravel()[:16]
                                         for s in range(steps["steps"])]),
                         fixture["tokens_digest"]),
          "lm_train_mesh: the batches made here differ from the mesh fixture's")
    ev_batch = SyntheticLM(DataConfig(ev_cfg.vocab_size, int(evl["seq"]), int(evl["batch"]),
                                      seed=int(evl["seed"]))).batch(0)
    ssm_cfg = dataclasses.replace(rt_configs.get_config(LM_TRAIN_MESH_SSM), dtype="float32",
                                  num_layers=LM_TRAIN_MESH_SSM_LAYERS)

    # The one-process runs under the abstract mesh (the same token groups);
    # gemma2's noise is the fixture's: the reference's own, under the mesh.
    with partition.activate(dict(zip(("data", "model"), LM_TRAIN_MESH_SHAPE))):
        one = lm_train_mesh_run(case, dev)
        one_eval = lm_eval_mesh(ev_cfg, moe_dir, ev_batch, dev)
    one["start"] = lm_tree_samples(lm_mesh_load_tree(gemma_dir), case["samples"])
    one["samples"] = case["samples"]
    noise = {k: fixture[f"noise_{k}"].tolist() for k in ("loss", "grad_norm")}
    noise["delta"] = fixture["noise_delta"]
    one_s = time.perf_counter() - t0 - weights_s

    ranks, group_s = lm_train_mesh_group(
        dict(train=[case], ssm=ssm_cfg, seed=seed,
             eval=dict(cfg=ev_cfg, tree=moe_dir, batch=ev_batch)), dev, out_dir)

    name = gemma.name
    per_rank = lm_train_mesh_rank_rows(name, ranks, one, dev, case)
    gates = lm_train_mesh_gates(ranks[0][name], one, noise)
    fx = lm_train_gates(dict(ranks[0][name], delta=ranks[0][name]["after"] - one["start"]),
                        fixture)
    one_fx = lm_train_gates(dict(one, delta=one["after"] - one["start"]), fixture)
    row = dict(part="gloo_4ranks_sharing_one_card", mesh=list(LM_TRAIN_MESH_SHAPE),
               arch=name, layers=gemma.num_layers, dtype="float32", batch=case["batch"],
               seq=case["seq"], steps=case["steps"], accum=case["accum"],
               label="4 ranks sharing one card: says nothing about scaling",
               loss=ranks[0][name]["loss"], one_process_loss=one["loss"],
               grad_norm=ranks[0][name]["grad_norm"], one_process_grad_norm=one["grad_norm"],
               ranks_agree=True, against_one_process=gates,
               against_fixture=dict(
                   ranks=dict(worst_ratio=fx["worst_ratio"], worst=fx["worst"], ok=fx["ok"],
                              lr_equal=fx["lr_equal"]),
                   one_process=dict(worst_ratio=one_fx["worst_ratio"], worst=one_fx["worst"],
                                    ok=one_fx["ok"])),
               one_process=dict(step_ms=one["step_ms"], peak=one["peak"],
                                stored_bytes=one["stored_bytes"]),
               ranks=per_rank, nvidia_smi=smi_line())
    emit("lm_train_mesh", **row)
    check(gates["ok"] and gates["lr_equal"],
          f"lm_train_mesh {name}: the ranks miss the one-process run: {gates}")
    check(fx["ok"] and one_fx["ok"],
          f"lm_train_mesh {name}: the ranks or the one-process run miss the mesh fixture")

    # mamba2: the preempted run resumed bit-equal, the step-2 checkpoint
    # restored onto (4, 1) (in the ranks) and onto one process (here).
    ssm = [r["ssm"] for r in ranks]
    ckpt_dir = os.path.join(out_dir, "ssm")
    step2 = LM_TRAIN_MESH_CKPT_EVERY
    model = Model(ssm_cfg, device=dev)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=2)
    driver = TrainDriver(DriverConfig(ckpt_dir), model, None, None)
    like = driver.state(opt.init(dict(model.named_parameters()), ocfg))
    restored_one = tree_digest(driver.state(driver._load(ckpt.restore(ckpt_dir, like, step2))))
    del model, driver, like
    s0 = ssm[0]
    row = dict(part="gloo_4ranks_sharing_one_card", mesh=list(LM_TRAIN_MESH_SHAPE),
               arch=ssm_cfg.name, layers=ssm_cfg.num_layers, dtype="float32",
               steps=LM_TRAIN_MESH_SSM_STEPS, ckpt_every=LM_TRAIN_MESH_CKPT_EVERY,
               preempted_at=LM_TRAIN_MESH_PREEMPT_AT if s0["preempted"] else None,
               resumed_from=s0["resumed_from"], resumed_steps=s0["resumed_steps"],
               loss=s0["loss"],
               resumed_bit_equal=[s["resumed"] == s["uninterrupted"] for s in ssm],
               restored_onto_4x1_bit_equal=[s["restored_41"] == s["checkpoint"] for s in ssm],
               restored_onto_one_process_bit_equal=restored_one == s0["checkpoint"],
               ssm_heads=ssm_cfg.ssm_heads, scan_heads=[s["scan_heads"] for s in ssm],
               checkpoint_bytes=os.path.getsize(os.path.join(ckpt_dir, f"step_{step2:08d}",
                                                             "arrays.npz")))
    emit("lm_train_mesh_checkpoint", **row)
    check(s0["preempted"] and s0["resumed_from"] == step2
          and s0["resumed_steps"][0] == step2,
          f"lm_train_mesh_checkpoint: preempted {s0['preempted']}, resumed from "
          f"{s0['resumed_from']} at {s0['resumed_steps']}")
    check(all(row["resumed_bit_equal"]),
          f"lm_train_mesh_checkpoint: the resumed run differs: {row['resumed_bit_equal']}")
    check(all(row["restored_onto_4x1_bit_equal"]) and row["restored_onto_one_process_bit_equal"],
          f"lm_train_mesh_checkpoint: a restore differs from the checkpoint: {row}")
    heads = mixer_spy().mesh_heads(ssm_cfg, LM_TRAIN_MESH_SHAPE[1])
    check(all(h == [heads] for h in row["scan_heads"]),
          f"lm_train_mesh_checkpoint: the ranks' scans ran {row['scan_heads']} heads, not "
          f"{heads}")

    # deepseek's eval step under lp: the router LPs on each rank's kernel.
    evs = [r["eval"] for r in ranks]
    n_moe = sum(k.endswith("_moe") for k in Model(ev_cfg, device="meta").kinds())
    ev_row = dict(part="gloo_4ranks_sharing_one_card", mesh=list(LM_TRAIN_MESH_SHAPE),
                  arch=ev_cfg.name, layers=ev_cfg.num_layers, router=ev_cfg.router,
                  batch=int(evl["batch"]), seq=int(evl["seq"]), moe_layers=n_moe,
                  loss=[e["loss"] for e in evs], one_process_loss=one_eval["loss"],
                  loss_rel_err=max(abs(e["loss"] / one_eval["loss"] - 1.0) for e in evs),
                  loss_tol=max(LM_EVAL_FLOOR, LM_NOISE_FACTOR * float(evl["noise_loss"])),
                  lps_bit_identical_across_ranks=all(e["lp_digests"] == evs[0]["lp_digests"]
                                                     for e in evs),
                  lps=[e["lps"] for e in evs],
                  replayed_bit_identical_on_simplex_plain=[sum(e["replayed_bit_identical"])
                                                           for e in evs],
                  launches=[{k: v for k, v in e["launches"].items() if v} for e in evs])
    emit("lm_train_mesh_eval_lp", **ev_row)
    check(ev_row["lps_bit_identical_across_ranks"],
          "lm_train_mesh_eval_lp: the ranks' router LPs are not the same bits")
    check(all(e["lps"] == n_moe and all(e["replayed_bit_identical"]) for e in evs),
          f"lm_train_mesh_eval_lp: router LPs {ev_row['lps']}, replays "
          f"{ev_row['replayed_bit_identical_on_simplex_plain']} of {n_moe}")
    check(ev_row["loss_rel_err"] <= ev_row["loss_tol"],
          f"lm_train_mesh_eval_lp: the ranks' eval loss misses the one-process run's: {ev_row}")
    if dev.type == "cuda":
        check(all(e["launches"]["simplex"] == e["launches"]["simplex.cluster"] == n_moe
                  for e in evs),
              f"lm_train_mesh_eval_lp: launches {ev_row['launches']}, not {n_moe} of the "
              "cluster variant a rank")
    emit("lm_train_mesh_setup", weights_s=weights_s, one_process_s=one_s, group_s=group_s,
         rank0_seconds_from_its_start=ranks[0]["seconds_from_start"])
    return [r["launches"] for r in ranks]


def lm_route_flips(a_calls, b_calls, cfg, tl: int) -> dict:
    """Between two runs' ``RouteSpy`` calls of one step (call by call, every
    token of the batch): the tokens whose top-k experts differ, the tokens
    whose kept experts differ (each run's capacity dispatch of its groups of
    ``tl`` tokens, ``moe.dispatch``), the largest gap between ``a``'s k-th
    and (k+1)-th logit at a token whose experts differ, and the largest
    difference of the two runs' logits."""
    from repro_torch.models import moe

    cap = moe._capacity(tl, cfg)

    def masks(experts):
        t, k = experts.shape
        chosen = np.zeros((t, cfg.num_experts), bool)
        kept = np.zeros_like(chosen)
        rows = np.arange(t)[:, None]
        chosen[rows, experts] = True
        for g0 in range(0, t, tl):
            e = torch.as_tensor(experts[g0:g0 + tl])
            order, _, keep = moe.dispatch(e, cap, cfg.num_experts)
            flat = np.empty(order.numel(), bool)
            flat[order.numpy()] = keep.numpy()
            kept[rows[g0:g0 + tl], experts[g0:g0 + tl]] = flat.reshape(-1, k)
        return chosen, kept

    chosen_flips = kept_flips = 0
    margin = diff = 0.0
    for (ea, _, la), (eb, _, lb) in zip(a_calls, b_calls):
        (ca, ka), (cb, kb) = masks(ea), masks(eb)
        flipped = (ca != cb).any(1)
        chosen_flips += int(flipped.sum())
        kept_flips += int((ka != kb).any(1).sum())
        top = -np.sort(-la, axis=1)
        gaps = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
        margin = max(margin, float(gaps[flipped].max()) if flipped.any() else 0.0)
        diff = max(diff, float(np.abs(la.astype(np.float64) - lb).max()))
    return dict(chosen=chosen_flips, kept=kept_flips, calls=len(a_calls),
                flipped_margin_max=margin, logit_diff_max=diff)


def lm_logit_dist(a_calls, b_calls) -> float:
    """Relative L2 of one step's router logits of run ``a`` against run
    ``b`` (every call, every token)."""
    num = sum(float(np.sum((la.astype(np.float64) - lb) ** 2))
              for (_, _, la), (_, _, lb) in zip(a_calls, b_calls))
    den = sum(float(np.sum(lb.astype(np.float64) ** 2)) for _, _, lb in b_calls)
    return math.sqrt(num / den)


def lm_whole_calls(data_ranks, name: str, s: int) -> list:
    """Step ``s``'s route calls of the ranks with model coordinate 0 (each
    its own tokens, in data order) put together: one call a call, every
    token of the batch."""
    calls = []
    for parts in zip(*(r[name]["routes"][s] for r in data_ranks)):
        calls.append((np.concatenate([e for e, _, _ in parts]), 0,
                      np.concatenate([lg for _, _, lg in parts])))
    return calls


def lm_train_mesh_witness(ranks_run, one, nudges, f64) -> list:
    """Step by step, each quantity of the ranks' run (loss and
    ``grad_norm`` by relative error, each leaf's change from the start at
    the samples by ``trimmed_rel``) against the float64 witness ``f64``,
    within the largest of its floor and ``LM_F64_FACTOR`` times the
    largest distance of a float32 one-process run (``one`` and each of
    ``nudges``) to the witness; beside it the one-process gate (the ranks
    against ``one`` within ``LM_NOISE_FACTOR`` times the nudges' largest
    change).  One dict a step: the worst ratio of each gate, ``ok``, and
    the distances of the router's change."""
    from repro_torch.models.convert import trimmed_rel

    share = LM_TRAIN_MESH_FLIP_SHARE
    out = []
    for s in range(len(one["loss"])):
        witness, one_gate, router = {}, {}, {}
        for key, floor in (("loss", LM_TRAIN_SCALAR_FLOOR), ("grad_norm", LM_TRAIN_SCALAR_FLOOR)):
            def rel(run, ref):
                return abs(run[key][s] / ref[key][s] - 1.0)

            ref = max(rel(r, f64) for r in [one, *nudges])
            witness[f"{key}[{s}]"] = rel(ranks_run, f64) / max(floor, LM_F64_FACTOR * ref)
            noise = max(rel(n, one) for n in nudges)
            one_gate[f"{key}[{s}]"] = rel(ranks_run, one) / max(floor,
                                                                LM_NOISE_FACTOR * noise)
        for _, path, sl in lm_leaf_slices(one["samples"]):
            def delta(run):
                return run["afters"][s][sl] - run.get("start", one["start"])[sl]

            d_ranks, d_one, d_f64 = delta(ranks_run), delta(one), delta(f64)
            dist = {"ranks": trimmed_rel(d_ranks, d_f64, share),
                    "one": trimmed_rel(d_one, d_f64, share),
                    "nudges": max(trimmed_rel(delta(n), d_f64, share) for n in nudges)}
            ref = max(dist["one"], dist["nudges"])
            witness[f"delta/{path}"] = dist["ranks"] / max(LM_TRAIN_LEAF_FLOOR,
                                                           LM_F64_FACTOR * ref)
            noise = max(trimmed_rel(delta(n), d_one, share) for n in nudges)
            vs_one = trimmed_rel(d_ranks, d_one, share)
            one_gate[f"delta/{path}"] = vs_one / max(LM_TRAIN_LEAF_FLOOR, LM_NOISE_FACTOR * noise)
            if path.endswith("router"):
                router[path] = dict(dist, ranks_vs_one=vs_one, nudge_noise=noise)
        w, o = max(witness, key=witness.get), max(one_gate, key=one_gate.get)
        out.append(dict(step=s, witness_worst_ratio=witness[w], witness_worst=w,
                        ok=bool(witness[w] <= 1.0), one_process_worst_ratio=one_gate[o],
                        one_process_worst=o, router=router))
    return out


def lm_train_mesh_moe_case(rt_configs, dev, *, seed, out_dir) -> dict:
    """deepseek-v2-lite-16b (``topk``) at the eval fixture's depth on the
    mesh fixture's steps (the ``gpu`` tier's case; the constants'
    comment).  Under the abstract (2, 2) mesh here the float32 run, its
    one-ulp nudges and the float64 witness, each free and then replaying
    the ranks' routing (``RouteSpy(forced=)``); between them
    ``LM_TRAIN_MESH_RANKS`` gloo ranks on ``dev``'s type.  Each step must
    hold the ranks within the witness gate of the replaying runs
    (``lm_train_mesh_witness``: the routing is the same, so every other
    difference is rounding) and their router logits within
    ``LM_F64_FACTOR`` times the replaying float32 runs' distance to the
    witness's (what decides the routing is rounding too).  The free runs'
    gates and each step's routing flips against the free one-process run
    (``lm_route_flips``) are reported.  Emits the ``lm_train_mesh_moe``
    line and returns it."""
    from repro_torch.sharding import partition

    steps = lm_train_mesh_steps(dict(np.load(LM_TRAIN_MESH_FIXTURE)))
    evl = dict(np.load(LM_EVAL_FIXTURE))
    cfg = dataclasses.replace(rt_configs.get_config(LM_MOE_ARCH), num_layers=int(evl["layers"]),
                              router="topk", dtype="float32")
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    t0 = time.perf_counter()
    tree_dir = lm_train_mesh_tree(dataclasses.replace(cfg, router=str(evl["router"])),
                                  int(evl["seed"]), out_dir, "moe_tree")
    tree = lm_mesh_load_tree(tree_dir)
    case = dict(name=cfg.name, cfg=cfg, tree=tree_dir, seed=int(evl["seed"]), routes=True,
                samples=lm_leaf_samples(tree, seed, LM_TRAIN_MESH_SAMPLE), **steps)
    start = lm_tree_samples(tree, case["samples"])
    del tree
    abstract = dict(zip(("data", "model"), LM_TRAIN_MESH_SHAPE))

    def one_process(forced=None):
        with partition.activate(abstract):
            one = lm_train_mesh_run(case, dev, forced=forced)
            nudges = [lm_train_mesh_run(case, dev, nudge=n, forced=forced)
                      for n in LM_TRAIN_MESH_NUDGES]
            f64 = lm_train_mesh_run(dict(case, cfg=cfg64), dev, forced=forced)
        one.update(start=start, samples=case["samples"])
        f64["start"] = start
        return one, nudges, f64

    weights_s = time.perf_counter() - t0
    one, nudges, f64 = one_process()
    one_s = time.perf_counter() - t0 - weights_s
    ranks, group_s = lm_train_mesh_group(dict(train=[case], seed=seed), dev, out_dir)
    name = cfg.name
    per_rank = lm_train_mesh_rank_rows(name, ranks, one, dev, case)
    got = dict(ranks[0][name], start=start)
    data_ranks = sorted((r for r in ranks if r["coordinate"][1] == 0),
                        key=lambda r: r["coordinate"][0])
    whole = [lm_whole_calls(data_ranks, name, s) for s in range(steps["steps"])]
    t1 = time.perf_counter()
    one_r, nudges_r, f64_r = one_process(forced=[[e for e, _, _ in calls] for calls in whole])
    replay_s = time.perf_counter() - t1

    tl = steps["batch"] // steps["accum"] * steps["seq"] // LM_TRAIN_MESH_SHAPE[0]
    replayed = lm_train_mesh_witness(got, one_r, nudges_r, f64_r)
    free = lm_train_mesh_witness(got, one, nudges, f64)
    out = []
    for s, (rep, fr) in enumerate(zip(replayed, free)):
        dist = dict(ranks=lm_logit_dist(whole[s], f64_r["routes"][s]),
                    one=lm_logit_dist(one_r["routes"][s], f64_r["routes"][s]),
                    nudges=max(lm_logit_dist(n["routes"][s], f64_r["routes"][s])
                               for n in nudges_r))
        logit_ratio = dist["ranks"] / (LM_F64_FACTOR * max(dist["one"], dist["nudges"]))
        flips = dict(ranks=lm_route_flips(one["routes"][s], whole[s], cfg, tl),
                     nudges=[lm_route_flips(one["routes"][s], n["routes"][s], cfg, tl)
                             for n in nudges],
                     f64=lm_route_flips(one["routes"][s], f64["routes"][s], cfg, tl),
                     ranks_vs_f64=lm_route_flips(f64["routes"][s], whole[s], cfg, tl),
                     tokens_routed_a_step=sum(len(e) for e, _, _ in whole[s]))
        out.append(dict(step=s, ok=bool(rep["ok"] and logit_ratio <= 1.0),
                        witness_worst_ratio=rep["witness_worst_ratio"],
                        witness_worst=rep["witness_worst"],
                        one_process_worst_ratio=rep["one_process_worst_ratio"],
                        one_process_worst=rep["one_process_worst"], router=rep["router"],
                        logits=dict(dist, ratio=logit_ratio),
                        free=dict(witness_worst_ratio=fr["witness_worst_ratio"],
                                  witness_worst=fr["witness_worst"],
                                  one_process_worst_ratio=fr["one_process_worst_ratio"],
                                  one_process_worst=fr["one_process_worst"],
                                  router=fr["router"]),
                        flips=flips,
                        loss=dict(ranks=got["loss"][s], one=one["loss"][s], f64=f64["loss"][s],
                                  one_replaying=one_r["loss"][s], f64_replaying=f64_r["loss"][s]),
                        grad_norm=dict(ranks=got["grad_norm"][s], one=one["grad_norm"][s],
                                       f64=f64["grad_norm"][s],
                                       one_replaying=one_r["grad_norm"][s],
                                       f64_replaying=f64_r["grad_norm"][s])))
    row = dict(part="gloo_4ranks_sharing_one_card", mesh=list(LM_TRAIN_MESH_SHAPE),
               arch=name, layers=cfg.num_layers, dtype="float32", router=cfg.router,
               batch=case["batch"], seq=case["seq"], accum=case["accum"], nudges=len(nudges),
               label="4 ranks sharing one card: says nothing about scaling",
               lr_equal=got["lr"] == one["lr"], steps=out,
               one_process=dict(step_ms=one["step_ms"], peak=one["peak"],
                                stored_bytes=one["stored_bytes"], f64_step_ms=f64["step_ms"]),
               ranks=per_rank, weights_s=weights_s, one_process_s=one_s, group_s=group_s,
               replaying_s=replay_s, nvidia_smi=smi_line())
    emit("lm_train_mesh_moe", **row)
    check(row["lr_equal"], f"lm_train_mesh_moe: the ranks' lr differ: {got['lr']}, {one['lr']}")
    check(all(r["ok"] for r in out),
          "lm_train_mesh_moe: the ranks miss the float64 witness of their routing: "
          + json.dumps([{k: r[k] for k in ("step", "witness_worst_ratio", "witness_worst")}
                        | {"logit_ratio": r["logits"]["ratio"]} for r in out]))
    return row


def lm_train_mesh_phase(rt_configs, dev, *, seed, counters, reset, train_row=None,
                        tmp_root=None) -> dict:
    """Slice 15: (a) NCCL with one rank, then (b) gloo ranks sharing the
    card, their files in a temporary directory under ``tmp_root``
    (default ``build/``).  Returns (a)'s launches in this process and each
    rank's of (b)."""
    import gc
    import tempfile

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp_root = str(tmp_root or ROOT / "build")
    os.makedirs(tmp_root, exist_ok=True)
    reset()
    lm_train_mesh_nccl_case(rt_configs, dev, seed=seed, train_row=train_row, tmp_root=tmp_root)
    nccl = launch_counts(counters)
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        per_rank = lm_train_mesh_gloo_case(rt_configs, dev, seed=seed, out_dir=tmp)
    emit("main_path_summary", path="slice15_lm_train_mesh", launches_nccl_1rank=nccl,
         launches_per_rank=per_rank, wall_s=time.perf_counter() - t0)
    check(not any(nccl.values()), f"the NCCL training steps launched a kernel: {nccl}")
    return dict(nccl=nccl, per_rank=per_rank)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of every generated input")
    args = parser.parse_args(argv)

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no GPU")
    # HiGHS, the slice-3 reference, runs in worker processes beside the card.
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("spawn"))
    import shutil
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    shared_root = tempfile.mkdtemp(dir=str(ROOT / "build"))
    try:
        return run(args, pool, shared_root)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        proc = SHARED_TREE.get("proc")
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join()
        shutil.rmtree(shared_root, ignore_errors=True)


def run(args, pool, shared_root) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch as rt
        from repro_torch.core.bucketing import bucket_problems
        from repro_torch.core.lp import LPBatch
        from repro_torch.core.problem import canonicalize
        from repro_torch.core.lp import random_shared_lp_batch
        from repro_torch.core import pdhg
        from repro_torch.core.pdhg import auto_cap_pdhg
        from repro_torch.core.reach import five_dim_model, helicopter_model, reach_supports
        from repro_torch.kernels import (build, hyperbox_cuda, ops, pdhg_cuda, revised_cuda,
                                         simplex_cuda)
        from repro_torch import configs as rt_configs
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: FAILED: the port is not beside this script: {exc}")
    dev = torch.device("cuda")
    timer = Timer(dev)
    # Every dispatch round that raises is counted from here on: only the
    # fault cases may raise (no clean phase leans on a retry).
    watch = FaultWatch().__enter__()

    # -- 1. environment (after the build, which the cluster occupancy needs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    t0 = time.perf_counter()
    builds = build.compile_all()
    build_s = time.perf_counter() - t0
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         cluster_occupancy=cluster_occupancy(dev))

    # -- 2. build
    emit("build", wall_s=build_s,
         sources=[dict(source=b["name"], built=b["built"], nvcc_s=b["seconds"],
                       kernels=build.ptxas_report(b["log"])) for b in builds])

    # -- 3. kernels against their plain versions
    # Every simplex launch of the main path (phase 4) is held against the
    # plain version here on the same LPs: the two paper classes at their
    # full batches, and the three buckets of the heterogeneous list.
    def paper_batch(bsz, m, n, feasible, seed, dtype=torch.float32):
        a, b, c, _ = chunked_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible,
                                      dtype, dev, chunk=5000)
        return LPBatch(a, b, c)

    # Type 1 and type 2 also run the global variant on the same LPs: the
    # same bits, and its time in this call.
    # Both stay on the card for the rounds phase (slice 6).
    type1 = paper_batch(50_000, 100, 100, True, args.seed)
    s_main = simplex_case(timer, name="type1_50000x100x100_f32_lpc", want="cluster",
                          batch=type1, beside_global=True)
    type2 = paper_batch(10_000, 200, 100, False, args.seed + 1)
    s_type2 = simplex_case(timer, name="type2_10000x200x100_f32_lpc", want="cluster",
                           batch=type2, beside_global=True)
    # The tableau's rank-1 update rounds once in float32 (core/engine.py:
    # rank1_update); both variants stay bit-identical to the plain version.
    emit("a1_rank1_update", type1_kernel_ms=s_main["kernel_ms"],
         type1_global_ms=s_main["global_ms"], type2_kernel_ms=s_type2["kernel_ms"],
         type2_global_ms=s_type2["global_ms"],
         bit_identical=s_main["bit_identical"] and s_type2["bit_identical"])
    torch.cuda.empty_cache()
    for bucket in bucket_problems(hetero_problems(rt, args.seed + 4, HETERO_PER_CLASS)[0]):
        m, n = bucket.key[:2]
        simplex_case(timer, name=f"list_bucket_{m}x{n}_f32_lpc", want="cluster",
                     batch=canonicalize(bucket.problem).batch)
    # A resumed chain under a cluster of 2 (type 2's shape), and the global
    # variant past the largest cluster (a 701 x 1401 tableau), small and short.
    simplex_case(timer, name="chain_1000x200x100_f32_lpc", chain=(60, 14_940), want="cluster",
                 batch=paper_batch(1000, 200, 100, False, args.seed + 13))
    s_global = simplex_case(timer, name="global_4x700x700_f32_lpc_cap300", cap=300,
                            want="global", batch=paper_batch(4, 700, 700, True, args.seed + 14))
    simplex_case(timer, name="256x28x28_f64_bland", rule="bland",
                 batch=paper_batch(256, 28, 28, True, args.seed + 10, torch.float64))
    simplex_case(timer, name="256x28x28_f32_rpc_seed7", rule="rpc", seed=7,
                 batch=paper_batch(256, 28, 28, True, args.seed + 11))
    simplex_case(timer, name="dense_chain_256x40x20_f32_lpc", layout="dense", chain=(25, 175),
                 batch=paper_batch(256, 40, 20, False, args.seed + 12))
    h_main = hyperbox_case(dev, timer, name="4000000x5_f32", bsz=4_000_000, n=5,
                           dtype=torch.float32, data_seed=args.seed + 2)
    hyperbox_case(dev, timer, name="6000000x28_f32", bsz=6_000_000, n=28,
                  dtype=torch.float32, data_seed=args.seed + 3)
    hyperbox_case(dev, timer, name="1000000x28_f64", bsz=1_000_000, n=28,
                  dtype=torch.float64, data_seed=args.seed + 20)
    torch.cuda.empty_cache()
    # Every revised launch of the slice-2 path is held against the plain
    # version here on the same inputs: the two shared rows at full batch
    # and the two reach sweeps.
    def shared_batch(bsz, m, n, feasible, seed, dtype=np.float32):
        return random_shared_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible,
                                      dtype=dtype, device=dev)

    # Shared types 1 and 2 also run the global variant on the same LPs: the
    # same bits, and its time in this call.
    shared1 = shared_batch(50_000, 100, 100, True, args.seed + 30)
    r_main = revised_case(timer, name="shared_type1_50000x100x100_f32_lpc", want="resident",
                          sb=shared1, beside_global=True)
    torch.cuda.empty_cache()
    revised_case(timer, name="shared_type2_10000x200x100_f32_lpc", want="resident",
                 sb=shared_batch(10_000, 200, 100, False, args.seed + 31), beside_global=True)
    torch.cuda.empty_cache()
    # The global variant past the resident budget (binv 360 KB an LP).
    r_global = revised_case(timer, name="shared_global_64x300x100_f32_lpc", want="global",
                            sb=shared_batch(64, 300, 100, True, args.seed + 38))
    revised_case(timer, name="shared_256x28x28_f64_bland", rule="bland",
                 sb=shared_batch(256, 28, 28, True, args.seed + 32, np.float64))
    revised_case(timer, name="shared_256x28x28_f32_rpc_seed7", rule="rpc", seed=7,
                 sb=shared_batch(256, 28, 28, True, args.seed + 33))
    revised_case(timer, name="shared_chain_256x40x20_f32_lpc", chain=(25, 175),
                 sb=shared_batch(256, 40, 20, False, args.seed + 34))
    revised_case(timer, name="shared_chain_256x40x20_f32_lpc_global", chain=(25, 175),
                 variant="global", want="global",
                 sb=shared_batch(256, 40, 20, False, args.seed + 34))
    warm = shared_batch(256, 30, 30, True, args.seed + 35)
    basis0 = ops.revised_solve(warm.a, warm.b, warm.c).basis.clone()
    basis0[:4, 1] = basis0[:4, 0]  # four singular bases: those rows start cold
    revised_case(timer, name="shared_warm_256x30x30_f32_lpc_4_singular", sb=warm,
                 basis0=basis0)
    reach_steps = 200
    # The reach rows' input-set supports: 200 steps x 50 (5-dim, oct) and
    # x 56 (helicopter, box) directions against one box (row stride 0).
    hyperbox_case(dev, timer, name="reach_10000x5_f32_box", bsz=10_000, n=5,
                  dtype=torch.float32, data_seed=args.seed + 36, box=True)
    hyperbox_case(dev, timer, name="reach_11200x28_f32_box", bsz=11_200, n=28,
                  dtype=torch.float32, data_seed=args.seed + 37, box=True)
    sweeps = {
        "five_dim": sweep_case(timer, dev, name="reach_sweep_five_dim_oct", kind="oct",
                               model=five_dim_model(), steps=reach_steps),
        "helicopter": sweep_case(timer, dev, name="reach_sweep_helicopter_box", kind="box",
                                 model=helicopter_model(), steps=reach_steps),
    }
    # The reach rows' reference, the hyperbox path for X0, computed here so
    # that its launches stay out of the main path's counts.
    hyperbox_refs = {
        name: reach_supports(model, 0.02, reach_steps,
                             directions=reach_args(rt, model, kind)["directions"])[0]
        for name, model, kind in [("five_dim", five_dim_model(), "oct"),
                                  ("helicopter", helicopter_model(), "box")]
    }
    del warm, basis0
    torch.cuda.empty_cache()

    # -- 4. the main paths; the launch counts are set to 0 just before each
    # path and read just after it
    counters = {"simplex": simplex_cuda, "hyperbox": hyperbox_cuda, "revised": revised_cuda,
                "pdhg": pdhg_cuda}

    def reset_counts():
        for mod in counters.values():
            mod.launches = 0
            for variant in getattr(mod, "variant_launches", {}):
                mod.variant_launches[variant] = 0

    reset_counts()
    rows = [
        simplex_row(rt, dev, name="type1_feasible_100x100", bsz=50_000, m=100, n=100,
                    feasible=True, seed=args.seed, counters=counters),
        simplex_row(rt, dev, name="type2_infeasible_start_200x100", bsz=10_000, m=200, n=100,
                    feasible=False, seed=args.seed + 1, counters=counters),
        hyperbox_row(rt, dev, name="hyperbox_4000000x5", bsz=4_000_000, n=5,
                     seed=args.seed + 2, counters=counters),
        hyperbox_row(rt, dev, name="hyperbox_6000000x28", bsz=6_000_000, n=28,
                     seed=args.seed + 3, counters=counters),
        hetero_row(rt, seed=args.seed + 4, counters=counters, per_class=HETERO_PER_CLASS),
    ]
    slice1 = launch_counts(counters)
    check(slice1["simplex"] > 0 and slice1["hyperbox"] > 0,
          f"a kernel of the slice-1 path was never launched: {slice1}")
    check(slice1["simplex.cluster"] == slice1["simplex"],
          f"a slice-1 simplex launch did not take the cluster variant: {slice1}")
    emit("main_path_summary", path="slice1_dense_and_box", launches=slice1, rows=len(rows))
    torch.cuda.empty_cache()

    reruns = []
    reset_counts()
    rows2 = [
        shared_row(rt, dev, name="shared_type1_100x100", bsz=50_000, m=100, n=100,
                   feasible=True, seed=args.seed + 30, counters=counters, dense_row=rows[0],
                   reruns=reruns),
        shared_row(rt, dev, name="shared_type2_200x100", bsz=10_000, m=200, n=100,
                   feasible=False, seed=args.seed + 31, counters=counters, dense_row=rows[1],
                   reruns=reruns),
        reach_row(rt, name="reach_five_dim", model=five_dim_model(), kind="oct",
                  steps=reach_steps, counters=counters,
                  plain_pivots=sweeps["five_dim"]["pivots"],
                  hyperbox_ref=hyperbox_refs["five_dim"], reruns=reruns),
        reach_row(rt, name="reach_helicopter", model=helicopter_model(), kind="box",
                  steps=reach_steps, counters=counters,
                  plain_pivots=sweeps["helicopter"]["pivots"],
                  hyperbox_ref=hyperbox_refs["helicopter"], reruns=reruns),
    ]
    slice2 = launch_counts(counters)
    check(slice2 == {k: sum(r["launches"][k] for r in rows2) for k in slice2},
          f"slice-2 launches {slice2} are not the sum of its rows'")
    check(slice2["revised"] > 0 and slice2["hyperbox"] > 0,
          f"a kernel of the slice-2 path was never launched: {slice2}")
    check(slice2["revised.resident"] == slice2["revised"],
          f"a slice-2 revised launch did not take the resident variant: {slice2}")
    emit("main_path_summary", path="slice2_shared_and_reach", launches=slice2, rows=len(rows2))
    # Wall times of the slice-2 rows beyond the counted run (one reading
    # of a sub-second row is not a rate), after the counts were read.
    repeat_rows(reruns, reps=5)
    del reruns
    torch.cuda.empty_cache()

    # Slice 3, the first-order path.  First the PDHG kernel against its
    # plain version, here rather than in phase 3 so that neither its
    # buffers nor HiGHS's worker processes (the reference, one LP each,
    # running meanwhile) weigh on the earlier paths' rows.  The main case
    # is the slice-3 batch itself (256 LPs of 500x500, A 256 MB), at a
    # short cap and at the auto cap.
    a, b, c, highs_lps = chunked_lp_batch(np.random.default_rng(args.seed + 40), PDHG_LPS,
                                          PDHG_DIM, PDHG_DIM, True, torch.float32, dev,
                                          chunk=HIGHS_SAMPLE)
    pdhg_batch = LPBatch(a, b, c)
    del a, b, c
    highs_futures = [pool.submit(highs_solve, lp) for lp in zip(*highs_lps)]
    tag = f"{PDHG_LPS}x{PDHG_DIM}x{PDHG_DIM}_f32"
    p400, *_ = pdhg_case(timer, name=f"{tag}_cap400", batch=pdhg_batch, cap=400, full=False,
                           reps=3, eager=True, want="cluster")
    # The same cap on the streaming variant (forced) and, as a finding, at
    # clusters of 8 and 16 beside the least k.
    p_stream, *_ = pdhg_case(timer, name=f"{tag}_cap400_streaming", batch=pdhg_batch, cap=400,
                               full=False, reps=3, k=0, want="streaming")
    k_sweep = {p400["k"]: p400["kernel_ms"]}
    for k in (8, 16):
        row, *_ = pdhg_case(timer, name=f"{tag}_cap400_k{k}", batch=pdhg_batch, cap=400,
                              full=False, reps=3, k=k, want="cluster")
        k_sweep[k] = row["kernel_ms"]
    emit("pdhg_k_sweep", case=f"{tag}_cap400", kernel_ms_by_k=k_sweep,
         streaming_ms=p_stream["kernel_ms"])
    pdhg_chain_case(name=tag, batch=pdhg_batch)
    p_main, p_main_status, _, p_main_iters = pdhg_case(
        timer, name=f"{tag}_auto_cap", batch=pdhg_batch, cap=auto_cap_pdhg(PDHG_DIM, PDHG_DIM),
        full=True, want="cluster")
    stream_auto_ms = pdhg_streaming_beside(timer, name=f"{tag}_auto_cap_streaming",
                                           batch=pdhg_batch, cluster_status=p_main_status)
    pdhg_slowest_lp(timer, batch=pdhg_batch, status=p_main_status, steps=p_main_iters,
                    streaming_cap=4000)
    pdhg_case(timer, name="64x200x200_f64_cap2000", cap=2000, full=False, reps=3,
              want="cluster", batch=paper_batch(64, 200, 200, True, args.seed + 41, torch.float64))
    cert = certificate_batch(dev)
    _, cert_status, *_ = pdhg_case(timer, name="certificates_4x100x100_f32", batch=cert,
                               cap=20_000, full=True, want="cluster")
    # The streaming variant past the largest cluster (A 4 MB an LP), small
    # and short.
    p_big, *_ = pdhg_case(timer, name="streaming_4x1000x1000_f32_cap50", cap=50, full=False,
                            want="streaming",
                            batch=paper_batch(4, 1000, 1000, True, args.seed + 43))
    confirmed = rt.solve(cert, rt.SolveOptions(backend="pdhg", max_iters=20_000)).status
    emit("certificates", case="4x100x100_rows_0_1_unbounded",
         kernel_status=cert_status.tolist(), confirmed_status=confirmed.tolist())
    check(cert_status[:2].tolist() == [2, 2] and confirmed[:2].tolist() == [2, 2],
          "pdhg kernel: the constructed rays are not certified UNBOUNDED")
    del cert
    torch.cuda.empty_cache()

    highs = [f.result() for f in highs_futures]
    reset_counts()
    auto_row, auto_sol, auto_confirm = pdhg_row(rt, name=f"pdhg_auto_{PDHG_DIM}x{PDHG_DIM}",
                                                batch=pdhg_batch,
                                  options=rt.SolveOptions(backend="auto"), counters=counters,
                                  highs=highs, rtol=5e-3)
    check(auto_row["launches"]["pdhg"] == 1 and auto_row["launches"]["simplex"] == 0,
          f"pdhg_auto launched {auto_row['launches']} (one pdhg launch, no simplex expected)")
    cross_row, *_ = pdhg_row(rt, name=f"pdhg_crossover_{PDHG_DIM}x{PDHG_DIM}", batch=pdhg_batch,
                            options=rt.SolveOptions(backend="auto", crossover=True),
                            counters=counters, highs=highs, rtol=1e-4,
                            base_iters=auto_sol.iterations.cpu().numpy().astype(np.int64))
    check(cross_row["launches"]["pdhg"] > 0 and cross_row["launches"]["simplex"] > 0,
          f"pdhg_crossover launched {cross_row['launches']}")
    torch.cuda.empty_cache()
    rows3 = [auto_row, cross_row, auto_list_row(rt, dev, seed=args.seed + 42, counters=counters,
                                                 per_class=HETERO_PER_CLASS)]
    slice3 = launch_counts(counters)
    check(slice3 == {k: sum(r["launches"][k] for r in rows3) for k in slice3},
          f"slice-3 launches {slice3} are not the sum of its rows'")
    check(slice3["pdhg"] > 0 and slice3["simplex"] > 0,
          f"a kernel of the slice-3 path was never launched: {slice3}")
    check(slice3["pdhg.cluster"] == slice3["pdhg"] and
          slice3["simplex.cluster"] == slice3["simplex"],
          f"a slice-3 launch did not take the cluster variant: {slice3}")
    emit("main_path_summary", path="slice3_first_order", launches=slice3, rows=len(rows3))
    # The confirmation of pdhg_auto's flags ran on host threads; the first
    # of the same flags confirmed sequentially, once, beside it.
    confirmation_case(auto_confirm, auto_row["row"])
    del auto_confirm
    # The routing frontier: the same batch on the simplex kernel, after the
    # counts were read.
    frontier_row(rt, batch=pdhg_batch, pdhg_row_=auto_row, highs=highs,
                 raw_status=p_main_status.cpu().numpy())
    # Every crossover launch of the slice-3 path polishes one tile of
    # CROSSOVER_TILE LPs of 500x500 from a warm basis: the first tile of
    # pdhg_crossover, warm from the same PDHG point, against the plain
    # version; then the polish's time by tile size.
    opt = (auto_sol.status == 1).nonzero().flatten()[:pdhg.CROSSOVER_TILE]
    check(opt.numel() == pdhg.CROSSOVER_TILE, f"only {opt.numel()} OPTIMAL rows to polish")
    tile = pdhg_batch.take(opt)
    s_tile = simplex_case(
        timer, name=f"crossover_tile_{opt.numel()}x{PDHG_DIM}x{PDHG_DIM}_f32_warm", batch=tile,
        basis0=pdhg.crossover_basis(tile.a, tile.b, auto_sol.x[opt]), reps=1, want="cluster",
        beside_global=True)
    del tile
    crossover_tiles(batch=pdhg_batch, sol=auto_sol, small=8)
    del auto_sol
    torch.cuda.empty_cache()

    # Slice 6, the round scheduler: compaction "off" and the compacted
    # solves on the same LPs in one call, each bit-equal to "off" and each
    # round one kernel launch; then the guardrails, sessions and the dense
    # warm sweep.
    reset_counts()
    k_rounds = 128
    simplex_fields = ("status", "iterations", "basis", "objective", "x")
    type1_off, _ = rounds_case(
        rt, name="type1_50000x100x100_f32_lpc", problem=type1,
        base=rt.SolveOptions(compact_every=k_rounds), counters=counters, kernel="simplex",
        variant="cluster", fields=simplex_fields,
        modes=[("every_k", "basis"), ("chunked", "scratch")])
    MESH_REFS["rounds_type1"] = sol_digest(type1_off)
    rounds_case(rt, name="type2_10000x200x100_f32_lpc", problem=type2,
                base=rt.SolveOptions(compact_every=k_rounds), counters=counters,
                kernel="simplex", variant="cluster", fields=simplex_fields,
                modes=[("every_k", "basis"), ("chunked", "scratch")])
    rounds_case(rt, name="shared_type1_50000x100x100_f32_lpc", problem=shared1,
                base=rt.SolveOptions(backend="cuda-shared", compact_every=k_rounds),
                counters=counters, kernel="revised", variant="resident", fields=simplex_fields,
                modes=[("every_k", "basis")])
    rounds_case(rt, name=f"pdhg_64x{PDHG_DIM}x{PDHG_DIM}_f32_cap400",
                problem=pdhg_batch.take(slice(0, 64)),
                base=rt.SolveOptions(backend="pdhg", max_iters=400, compact_every=50),
                counters=counters, kernel="pdhg", variant="cluster",
                fields=("status", "iterations", "x", "y"), modes=[("every_k", "basis")])
    guardrail_cases(rt, name="type1_50000x100x100_f32_lpc", problem=type1, off=type1_off,
                    counters=counters, poison_lps=5000, k=k_rounds)
    session_case(rt, dev, problem=type1)
    for name, model, kind in [("five_dim", five_dim_model(), "oct"),
                              ("helicopter", helicopter_model(), "box")]:
        dense_sweep_case(rt, dev, name=f"reach_{name}", model=model, kind=kind,
                         steps=reach_steps, counters=counters)
    slice6 = launch_counts(counters)
    check(slice6["simplex"] > 0 and slice6["revised"] > 0 and slice6["pdhg"] > 0,
          f"a kernel of the rounds phase was never launched: {slice6}")
    check(slice6["simplex.cluster"] == slice6["simplex"] and
          slice6["revised.resident"] == slice6["revised"] and
          slice6["pdhg.cluster"] == slice6["pdhg"],
          f"a rounds-phase launch did not take the main variant: {slice6}")
    emit("main_path_summary", path="slice6_rounds_sessions_sweeps", launches=slice6)
    # The row-local A lo product of canonicalize (slice 8) at types 1 and 2,
    # after the counts were read.
    a_lo_case(timer, dev, batches=[("type1", type1), ("type2", type2)])
    del type2, type1_off
    torch.cuda.empty_cache()

    # Slice 7, the serve loop: the traffic's one-shot answers, a warm-up, the
    # calibration (the whole trace at t = 0), then both modes replayed
    # open-loop at half the calibrated rate and the PDHG requests; then,
    # after the counts were read, the fault cases and speculation.
    from repro_torch.serve.engine import LPEngine
    from repro_torch.serve.loadgen import Arrival, poisson_trace, replay

    serve_problems = serve_requests(rt)
    serve_plan = serve_kernel_cases(rt, dev, timer, problems=serve_problems,
                                    pdhg_batch=pdhg_batch)
    oneshot = rt.SolveSession(device=dev).solve(serve_problems)
    MESH_REFS["serve"] = requests_digest(oneshot)
    warm = serve_problems[:256]
    cont_kw = dict(flush_every=1 << 30, max_inflight=1024, step_iters=64)
    cal = LPEngine(rt.SolveOptions(), device=dev, **cont_kw)
    drain(cal, warm)
    torch.cuda.synchronize()
    res = replay(cal, [Arrival(0.0, p) for p in serve_problems], mode="continuous")
    rate = len(serve_problems) / res.makespan
    same = same_solutions(res.solutions, oneshot)
    emit("serve_calibration", requests=len(serve_problems), throughput_per_s=rate,
         makespan_s=res.makespan, p50_ms=float(np.percentile(res.latencies, 50) * 1e3),
         p99_ms=float(np.percentile(res.latencies, 99) * 1e3), spliced=cal.stats.spliced,
         bit_equal_to_oneshot=same, offered_per_s=0.5 * rate, **cont_kw)
    check(all(same.values()), f"serve calibration differs from the one-shot solve: {same}")
    check_clean(cal, "serve_calibration")
    del cal, res
    trace = poisson_trace(0.5 * rate, len(serve_problems), lambda i: serve_problems[i], seed=17)
    reset_counts()
    serve_mode_case(rt, dev, mode="continuous", problems=serve_problems, trace=trace,
                    oneshot=oneshot, counters=counters, engine_kw=cont_kw, warm=warm)
    serve_mode_case(rt, dev, mode="flush", problems=serve_problems, trace=trace,
                    oneshot=oneshot, counters=counters, engine_kw=dict(flush_every=512),
                    warm=warm)
    serve_pdhg_case(rt, dev, batch=pdhg_batch.take(slice(0, 64)), counters=counters,
                    plan_row=serve_plan)
    slice7 = launch_counts(counters)
    check(slice7["simplex"] > 0 and slice7["hyperbox"] > 0 and slice7["pdhg"] > 0,
          f"a kernel of the serve path was never launched: {slice7}")
    check(slice7["simplex.cluster"] == slice7["simplex"] and
          slice7["pdhg.cluster"] == slice7["pdhg"],
          f"a serve-path launch did not take the cluster variant: {slice7}")
    emit("main_path_summary", path="slice7_serve", launches=slice7)
    del serve_problems, oneshot, warm, trace
    raised = watch.raised
    faults_case(rt, dev, type1=type1, shared1=shared1)
    fault_raised = watch.raised - raised
    speculation_case(rt, batch=type1, chunk=6250)

    # Slice 8, the autotuner: the predicted ranking of every main-path class
    # (equal to the static table) and type 1's first 5,000 LPs under the
    # default options against autotune="off"; then warm trials into a cache
    # file, a warm process on it (no trial), a "trial" solve that takes the
    # cached winner; then the roofline line.  Counted from the first solve to
    # the last trial.
    reset_counts()
    part = type1.take(torch.arange(5000, device=dev))
    off = autotune_predict_case(rt, dev, part=part)
    autotune_trial_case(rt, dev, part=part, off=off)
    slice8 = launch_counts(counters)
    check(slice8["simplex"] > 0 and slice8["simplex.cluster"] == slice8["simplex"],
          f"the autotune phase did not launch the simplex kernel's cluster variant: {slice8}")
    emit("main_path_summary", path="slice8_autotune", launches=slice8)
    del part, off
    watch.__exit__()
    check(watch.raised == fault_raised,
          f"{watch.raised - fault_raised} dispatch rounds raised outside the fault cases")
    del type1, shared1, pdhg_batch
    torch.cuda.empty_cache()
    roofline_case(timer, dev)

    # The deepseek reference weights of slices 10, 12 and 14, drawn in a
    # helper process while slice 9 draws its own; slice 9 waits for it
    # before its timed rows.
    start_shared_tree(shared_root)

    # Slice 9, the LM serve path: gemma2-2b at full width (no kernel of the
    # port on it; the counts must not move).
    reset_counts()
    lm_phase(rt_configs, dev, seed=args.seed, counters=counters)

    # Slice 10, MoE with the LP router and MLA: deepseek-v2-lite-16b at full
    # width; its main path (``lm_moe_serve``) launches the simplex kernel
    # once a MoE layer a call under router="lp".
    reset_counts()
    moe = lm_moe_phase(rt_configs, dev, seed=args.seed, counters=counters, reset=reset_counts)
    slice10 = moe["launches"]
    check(slice10["simplex"] > 0, f"the MoE path never launched the simplex kernel: {slice10}")

    # Slice 11, the SSM, hybrid, encoder-decoder and M-RoPE families (no
    # kernel of the port on them; the counts must not move).
    families = lm_families_phase(rt_configs, dev, seed=args.seed, counters=counters,
                                 reset=reset_counts)

    # Slice 16, the catalog's last five configurations at full width:
    # qwen2-vl-72b on slice 11's model, qwen1.5-4b and internlm2-20b whole,
    # dbrx-132b (its router LPs on the simplex kernel under router="lp") and
    # command-r-plus-104b cut in depth.
    catalog = lm_catalog_phase(rt_configs, dev, seed=args.seed, counters=counters,
                               reset=reset_counts, vlm_model=families.pop("vlm_model"))
    slice16 = catalog["launches"]

    # Slice 12, training: gemma2-2b and mamba2-130m train steps (no kernel of
    # the port), and the eval step under router="lp" on deepseek-v2-lite-16b
    # (one simplex launch a MoE layer).
    slice12_out = lm_train_phase(rt_configs, dev, seed=args.seed, counters=counters,
                                 reset=reset_counts)
    slice12 = slice12_out["launches"]

    # Slice 13, the LP system over a device mesh: NCCL with one rank on the
    # card, then gloo ranks sharing it, each solving its own rows on its own
    # launches (their counts are the ranks' own, set to 0 before each row).
    mesh = mesh_phase(rt, dev, seed=args.seed, counters=counters, reset=reset_counts,
                      type1_row=rows[0])
    slice13 = sum_counts([mesh["nccl"]] + [r[m] for r in mesh["per_rank"] for m in r])

    # Slice 14, the LM serve path over a device mesh: NCCL with one rank on
    # a (1, 1) mesh, then gloo ranks sharing the card on a (2, 2) mesh; the
    # router LPs of every MoE layer on each rank's simplex kernel.
    lm_mesh = lm_mesh_phase(rt_configs, dev, seed=args.seed, counters=counters,
                            reset=reset_counts)
    slice14 = sum_counts([lm_mesh["nccl"]] + [r[a] for r in lm_mesh["per_rank"] for a in r])

    # Slice 15, training on a device mesh: NCCL with one rank on a (1, 1)
    # mesh (bit-identical to no mesh), then gloo ranks sharing the card on
    # (2, 2); the eval step's router LPs on each rank's simplex kernel.
    train_mesh = lm_train_mesh_phase(rt_configs, dev, seed=args.seed, counters=counters,
                                     reset=reset_counts, train_row=slice12_out["train"])
    slice15 = sum_counts([train_mesh["nccl"]] + train_mesh["per_rank"])
    check(slice15["simplex"] > 0 and slice15["simplex"] == slice15["simplex.cluster"],
          f"the mesh training path's eval step did not launch the simplex kernel's cluster "
          f"variant on every rank: {slice15}")

    launches = {k: slice1[k] + slice2[k] + slice3[k] + slice6[k] + slice7[k] + slice8[k]
                + slice10[k] + slice12[k] + slice13.get(k, 0) + slice14.get(k, 0)
                + slice15.get(k, 0) + slice16[k] for k in slice1}

    def entry(name, source, replaces, row, n, **extra):
        key = f"{name}.{extra['variant']}" if "variant" in extra else name
        return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=f"src/repro/kernels/{replaces}", launches=n,
                    max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=None,
                    serve_path_launches=slice7[key],
                    mesh_path_launches=dict(
                        nccl_1rank=mesh["nccl"].get(key, 0),
                        gloo_ranks_sharing_one_card={
                            m: [r[m].get(key, 0) for r in mesh["per_rank"]]
                            for m in ("data4", "data2_model2")}),
                    **extra)

    # The global variant's row: type 1's LPs, timed beside the cluster
    # variant in the same case (the same bits, so the same error and bound).
    s_glob = dict(s_main, kernel_ms=s_main["global_ms"])
    r_glob = dict(r_main, kernel_ms=r_main["global_ms"])
    revised_variants = [
        entry("revised", "revised.cu", "revised_pallas.py:56", r_main,
              launches["revised.resident"], variant="resident", cases=CASES["revised.resident"]),
        entry("revised", "revised.cu", "revised_pallas.py:56", r_glob,
              launches["revised.global"], variant="global", cases=CASES["revised.global"],
              past_the_resident_budget_ms=r_global["kernel_ms"]),
    ]
    simplex_variants = [
        entry("simplex", "simplex.cu", "simplex_pallas.py:53", s_main,
              launches["simplex.cluster"], variant="cluster", cases=CASES["simplex.cluster"]),
        entry("simplex", "simplex.cu", "simplex_pallas.py:53", s_glob,
              launches["simplex.global"], variant="global", cases=CASES["simplex.global"]),
    ]
    pdhg_variants = [
        entry("pdhg", "pdhg.cu", "pdhg_pallas.py:62", p_main, launches["pdhg.cluster"],
              variant="cluster", cases=CASES["pdhg.cluster"]),
        entry("pdhg", "pdhg.cu", "pdhg_pallas.py:62", p_stream, launches["pdhg.streaming"],
              variant="streaming", cases=CASES["pdhg.streaming"],
              auto_cap_ms=stream_auto_ms),
    ]
    print(json.dumps({"kernels": [
        entry("simplex", "simplex.cu", "simplex_pallas.py:53", s_main, launches["simplex"],
              variants=simplex_variants, lm_router=moe["router"],
              lm_catalog_router=catalog["router"],
              lm_mesh_router=dict(
                  nccl_1rank=lm_mesh["nccl"].get("simplex", 0),
                  gloo_ranks_sharing_one_card=[sum(r[a].get("simplex", 0) for a in r)
                                               for r in lm_mesh["per_rank"]]),
              lm_train_mesh_router=dict(
                  nccl_1rank=train_mesh["nccl"].get("simplex", 0),
                  gloo_ranks_sharing_one_card=[r.get("simplex", 0)
                                               for r in train_mesh["per_rank"]])),
        entry("hyperbox", "hyperbox.cu", "hyperbox_pallas.py:20", h_main, launches["hyperbox"],
              gb_per_s=h_main["gb_per_s"]),
        entry("revised", "revised.cu", "revised_pallas.py:56", r_main, launches["revised"],
              variants=revised_variants),
        entry("pdhg", "pdhg.cu", "pdhg_pallas.py:62", p_main, launches["pdhg"],
              variants=pdhg_variants),
    ]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
