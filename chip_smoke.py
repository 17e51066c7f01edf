#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (exit code != 0):

1. device — require CUDA; print the card's name and power limit;
2. build  — compile every kernel of ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a, all sources at once;
3. kernels — hold the fold against its plain PyTorch version on the
   card: each CNN leaf alone, the whole fold as one ``fedagg_leaves``
   launch (bit-equal to one-leaf launches) in f32 and bf16, ragged and
   unaligned leaves, a list longer than one launch takes; time kernel,
   plain version and the one-call PyTorch yardstick (``library_ms``,
   timed here only; the port never calls it) back to back with each
   call's host cost, and kernel and yardstick also as device time with
   the host's cost hidden (``device_ms``), at S=40 (a round's fold of
   the 40 satellites) and at S=8 (a cycle event's fold of one orbit's
   members, ``fold_s8``); then show
   that the fold's wrapper refuses a CUDA input that requires grad (it
   has no backward), and that the ``flash_attention``, ``rwkv6_wkv`` and
   ``selective_scan`` wrappers under grad build their autograd nodes, one
   forward and one backward launch each, with every input's gradient
   equal to the plain backward's, and that flash with MLA's (96, 64)
   head dims under grad raises (no backward variant) and launches
   nothing;
4. card vs CPU — one round of the default config at full width (except
   ``local_steps=2``) through ``FusedExecutor.run_block`` on the card
   and on the CPU from the same init: params must agree;
5. slice — ``RoundEngine(SimConfig(max_rounds=16)).run()`` on the card:
   FedHAP, 40 satellites, the paper CNN, 70k digits, 54 local steps, two
   fused blocks of up to 8 rounds (the 72 h horizon ends it at 15).
   The kernel launch counts are zeroed just before and read just after:
   one ``fedagg`` launch per round (the fold of all 8 leaves);
6. profile — one more full-width round under torch.profiler: device
   time by kernel and the device's busy share of the round;
7. flash — the ``flash_attention`` kernels against their plain version
   on the card (bf16 at D >= 16 runs the tensor-core kernel, f32 and D=8
   the SIMT one; each call's variant is counted): the CPU tests' sweep
   (f32 and bf16, windows, bidirectional) plus ragged lengths around the
   tensor-core tiles (S = 1 .. 300, GQA groups 1-8, windows 1, 63, 200),
   and both prefill shapes (qwen3-0.6b's B=4, H=16, Hkv=8, S=4096,
   D=128 and jamba's H=32 over 8, causal) in f32 and bf16, where three
   planted long-row faults must break the bf16 tolerance; timed at both
   shapes in bf16 beside the f32 SIMT kernel, the plain version, its
   bound and ``scaled_dot_product_attention`` (``library_ms``, timed
   here only); then MLA's head dims (q and k 96, v 64) in f32 and bf16,
   causal, windowed and bidirectional, S = 1 .. 300, each launch counted
   as its own variant, the causal mask off at Sq != Sk (whisper's 4096
   queries against 1500 frames among them), and minicpm3-4b's prefill
   shape (B=4, H=40, S=4096) in bf16 against the plain version, timed
   beside its bound and SDPA;
8. LM card vs CPU — full-width qwen3-0.6b in f32 from one CPU-drawn
   init: ``forward`` over B=1, S=256 on the card (kernel) and on the CPU
   (plain version); the logits must agree;
9. decode vs prefill — full width, f32 then bf16, B=2, S=64: stepped
   ``decode_step`` logits against ``forward`` logits on the card; two
   planted cache faults must break the same tolerance;
10. serve — full-width qwen3-0.6b in bf16: ``prefill`` at B=4, S=4096
    (the counts zeroed just before, read just after: 28 flash launches,
    all 28 of the tensor-core kernel, none of the SIMT one),
    then ``greedy_generate`` at serve's defaults (batch 4, prompt 16,
    gen 32); then one prefill and a few decode steps under
    torch.profiler;
11. wkv — the ``rwkv6_wkv`` kernel against its plain version on the
    card: the CPU tests' sweep (f32, bf16, bf16 with f32 w), w = 0 and
    w = 1 over 300 steps, views the kernel's tile copies cannot address
    (copied by the wrapper, one copy per input), and the rwkv6-3b
    prefill shape (B=4, H=40,
    S=4096, N=64) in f32 and in bf16 with f32 w, at uniform decays in
    [0.7, 0.999] and at the init's 0.99752, where three planted faults
    from step 1024 must break the bf16 tolerance; timed beside the plain
    version and its bound;
12. rwkv card vs CPU — full-width rwkv6-3b (3,099,776,000 params) in
    f32 from one CPU-drawn init: ``forward`` over B=1, S=256 on the card
    (kernel) and on the CPU (plain version); the logits must agree;
13. rwkv decode vs prefill — full width, f32 then bf16, B=2, S=64 (two
    of the kernel's 32-step tiles); two planted faults at step 32 (a
    decay skipped, a stale token shift); the same readings with the
    stacked matrices at their own fan-in, reported only;
14. rwkv serve — full-width rwkv6-3b in bf16: ``prefill`` at B=4,
    S=4096 (the counts zeroed just before, read just after: 32
    ``rwkv6_wkv`` launches, no input copied), ``greedy_generate`` at
    serve's defaults,
    and the profiles of phase 10.
15. scan — the ``selective_scan`` kernel against its plain version on
    the card: the CPU tests' sweep (f32, bf16, abar f32 with bf16 bx/c)
    and the jamba prefill shape (B=4, S=4096, D=8192, N=16) in f32 and
    in the model's mixed dtypes, at abar ~ U[0.8, 0.999] and at the
    model's own-fan-in regime, where three planted faults from step 1024
    must break the bf16 tolerance; timed beside the plain version and its
    bound; no launch stores the backward's checkpoints;
16. jamba card vs CPU — jamba-v0.1-52b at full width, one period of its
    four (``num_layers=8``: 7 Mamba blocks, 1 attention block, 4 MoE
    FFNs; the whole model's 96 GiB does not fit one card), in f32 at own
    fan-in, block by block (b0 Mamba + MoE, b1 Mamba + MLP, b4 attention
    + MoE) at B=1, S=256: card (kernels) against CPU (plain versions),
    outputs agreeing and MoE routes equal;
17. jamba decode vs prefill — the period at full width, B=2, S=64,
    capacity_factor 8.0, weights drawn on the card: f32 at own fan-in
    with two planted faults at step 32 (the conv window not shifted, the
    SSM state not decayed) that must break the tolerance; the reference's
    init reported beside it; then bf16 (checked where no MoE route
    differs between the paths); the share of the model's abar in (0.01,
    0.99) at both inits;
18. jamba serve — the period in bf16 at own fan-in: ``prefill`` at B=4,
    S=4096 (the counts zeroed just before, read just after: 7
    ``selective_scan`` launches, none storing checkpoints, and 1
    ``flash_attention`` launch, of the tensor-core kernel), the share of
    its abar in (0.01, 0.99), ``greedy_generate`` at serve's defaults,
    and the profiles of phase 10;
19. routed — each routed strategy at full width on the card with its
    station scenario (fedisl/gs, fedisl_ideal/meo, fedsink/haps:2,
    fedhap_async/haps:2, fedhap_buffered/haps:2), default local steps,
    batch and plan block, ``max_rounds=16`` (two blocks or more): the
    counts zeroed just before each run and read just after must show
    one ``fedagg`` launch per valid round or cycle event (the S=40 fold
    of a round, the S=8 fold of an orbit's members); accuracies finite
    and above chance; s/round or s/event, peak memory and clocks logged;
20. cycle card vs CPU — one ``cycle_block`` of 4 planned fedhap_buffered
    events (two flushes, two buffered) at full width with
    ``local_steps=2`` on the card and on the CPU from the same init and
    tensors: params, cycle bases and buffer must agree;
21. ticks — the tick baselines at full width on the card with the JAX
    tests' scenarios, default local steps and batch: fedsat/gs_np for 8
    orbit-events and fedspace/gs for 2 flushes; the counts zeroed just
    before each run and read just after must show one ``fedagg`` launch
    per orbit-event (S=8) and one per flush (S = the rows buffered);
    accuracies finite and above chance; s/event, peak memory and the
    card's draw logged; then the fold at the first flush's S, timed as
    phase 3 times S=8 (``fold_flush``);
22. resume — fedhap/one_hap, fedspace/gs and fedhap_buffered/haps:2 at
    full width with ``checkpoint_every=1`` and the executor's own cuDNN
    settings (it must set ``cudnn.deterministic``): a run of 4 events, a
    run cut at 2 and the cut run resumed; the history equal and the final
    params and strategy state bit-equal; then a checkpoint written on the
    card loads into a CPU engine leaf for leaf; and the run-to-run spread
    of fedspace with cuDNN's default algorithms (the flag cleared for
    those two runs), reported only;
23. flash backward — ``flash_attention_bwd`` (three kernels: a
    pre-pass, dK/dV, dQ; bf16 at D >= 16 runs the tensor-core ones,
    f32 and D=8 the SIMT ones, and each call's variant is counted)
    against ``flash_attention_bwd_plain`` and the forward's lse against
    ``flash_attention_lse_plain`` on the card: a sweep in f32 and bf16
    over every head dim, GQA groups 1/2/4, causal and not, windows,
    Sq != Sk and transposed views (autograd through ``FlashAttentionFn``
    bit-equal to the direct call); then the training shape (B=2, H=16,
    Hkv=8, S=1024, D=128) and the serve shape (B=4, S=4096) in bf16, on
    the tensor cores, where three planted faults (the GQA sum dropped, Δ
    not subtracted, the causal mask off by one) in a dense copy must
    break the tolerance that the copy without a fault meets; the backward
    timed (back to back and as device time) beside the plain version, its
    bounds (the function's 2.5x the forward's FLOP, 3.5x with S and dP
    recomputed, the design's 5x) and SDPA's backward, and the forward
    with and without lse (the serving path passes none); ptxas' registers
    and spills of each new backward kernel;
24. train card vs CPU — qwen3-0.6b at full width cut to 4 layers, f32,
    from one CPU-drawn init: each leaf's gradient of one satellite's
    loss (batch 1 x seq 256) on the card and on the CPU, within a
    relative norm that a planted backward fault (Δ not subtracted) must
    break; then one ``single_device_round`` (2 satellites, both
    visible, 1 local step) on both: loss and every leaf after the fold
    agree;
25. train — the slice, ``launch/train.py``'s round at full width, bf16,
    remat on: 4 satellites (2 orbits x 2), seq 1024, batch 2 per
    satellite, 2 local steps, 3 rounds, visibility 0.5, seed 0; the
    counts zeroed just before each round and read just after: one
    ``fedagg`` launch, 56 forward launches (all ``flash_fwd_tc``) and 28
    backward launches (all on the tensor cores) per satellite step;
    finite losses, all rows
    bit-equal after each fold; s/round, peak memory, the card's draw, a
    profile of one round split into GEMMs, ``flash_bwd``, elementwise
    work and the fold; the S=4 bf16 LM fold timed against its bound and
    ``torch.mv`` per leaf; one more round whose fold is held to the plain
    fold at one bf16 ulp on the rows it folds, then on those rows plus
    seeded noise under non-uniform weights, where a planted fault (row 0
    read S times) must break it; a checkpoint of row 0 written to a
    ``tempfile`` directory and loaded back bit for bit;
26. sanitize — ``repro_torch.debug.sanitized_run`` of all 8 strategies
    (the JAX package's tests/test_sanitize.py scenarios) at full width,
    2-3 events each, with the CUDA sync-debug mode "error" and the
    dispatch guard around each fused loop: every history equal to a
    plain run's, the ``fedagg`` counts zeroed just before each run and
    read just after equal to the folds the plan called for, s per fold
    sanitized vs plain logged; then three planted faults in a sanitized
    fedhap run (a ``float()`` of a device scalar, a float64 upload, a
    ``.cpu()`` outside the explicit-transfer scope) must each raise;
27. wkv backward — the forward kernel with the backward's checkpoint
    stores (``rwkv6_wkv_fwd_ckpt``: y bit-equal to the serving forward's,
    the state before every 16 steps and c_t within ``BWD_REL["float32"]``
    of ``rwkv6_wkv_ckpt_plain``'s) and ``rwkv6_wkv_bwd`` on those
    checkpoints (two kernels: the reverse sweep in clusters of column
    blocks, du's sum over b) against ``rwkv6_wkv_bwd_plain`` on the card,
    each gradient within ``BWD_REL`` of its largest value, and bit-equal
    to the backward that makes its own checkpoints: a sweep in f32, bf16
    with f32 w and bf16 over every head size on the model's transposed
    views, w = 0 and w = 1 over 300 steps; the training shape (B=2, H=40,
    S=1024, N=64) in the model's dtypes, two calls bit-equal, three
    planted faults (the adjoint's decay skipped, dw from the state after
    the step, the checkpoints taken one chunk off) that must break the
    tolerance; the backward on the forward's checkpoints timed there and
    at the serve shape (B=4, S=4096) against the operations bound, the
    forward with the stores against the serving forward at both; ptxas'
    registers and spills;
28. scan backward — the checkpointing forward
    (``selective_scan_fwd_ckpt``: y bit-equal to serving's, checkpoints
    against ``selective_scan_ckpt_plain``'s) and ``selective_scan_bwd``
    on those checkpoints likewise: the scan sweep in its three dtype
    cases (bit-equal to the backward making its own checkpoints), abar =
    0 and 1 over 300 steps, jamba's training shape (B=2, S=1024, D=8192,
    N=16; abar f32, bx/c/dy bf16) at two abar regimes with three planted
    faults each (the adjoint's decay skipped, d abar from the state after
    the step, the checkpoints taken one chunk off), bit-equal calls; the
    backward on the forward's checkpoints timed against the byte bound
    there and at the serve shape, the forward with the stores against
    the serving forward at both; ptxas' registers and spills; then one
    full-width jamba Mamba block (bf16, own fan-in, B=2, S=1024): the
    gradients of its leaves and input through the kernels (one
    checkpointing forward and one backward launch; two forwards under
    remat) against the plain scan's on the card, and its forward +
    backward in device time;
29. train card vs CPU, the other families — rwkv6-3b at full width cut
    to 2 layers, f32: each leaf's gradient card vs CPU within
    ``TRAIN_GRAD_RTOL``, a planted backward fault (the WKV backward given
    w = 1) caught, one ``single_device_round`` on both; then the reduced
    jamba-v0.1-52b at own fan-in, one round on both, the card's 14 scan
    forward (all storing checkpoints) and 14 backward launches counted;
30. rwkv train — the slice of phase 25 for rwkv6-3b at full width (bf16,
    remat, ``TRAIN_SLICE``, the CLI's init): per round one ``fedagg``
    launch and per satellite step 64 ``rwkv6_wkv`` forward (32 + 32
    recomputed, all storing checkpoints) and 32 backward launches,
    finite losses, rows bit-equal after each fold, s/round, trained
    tokens/s, peak memory, the card's draw and a profile of one round by
    category, with ``wkv_bwd`` and ``wkv_fwd`` by kernel;
31. zoo — minicpm3-4b (MLA) and whisper-small (encoder-decoder) at full
    width cut to 4 layers, f32 at own fan-in: ``forward`` card vs CPU
    (B=1, S=256, whisper with 1500 frames), then decode against forward
    on the card (B=2, S=64; whisper's cross caches primed from frames),
    where a planted fault must break the tolerance (MLA's latents one
    slot off, whisper's cross caches from other frames) and whisper's
    logits must move when its frames are zeroed;
32. zoo serve — granite-moe-1b-a400m, minicpm3-4b and whisper-small at
    full depth, mistral-nemo-12b, pixtral-12b, deepseek-coder-33b and
    qwen3-moe-30b-a3b cut in depth (``ZOO_SERVE``), full width, bf16:
    each drawn at the reference's init and one prefill read there
    (attention, router and next-token softmaxes' top-1 weight, max
    |logit|), rescaled to own fan-in where ``ZOO_SERVE`` says so (the
    reading must agree: saturated there, and only there); then
    ``prefill`` at B=4, S=4096 (whisper with 1500 frames,
    pixtral with 1024 patches ahead of the text), the counts zeroed just
    before and read just after (one tensor-core flash launch per
    attention layer: 24 for granite, 62 of the (96, 64) variant for
    minicpm3-4b, 12 + 12 + 12 for whisper's encoder, self- and
    cross-attention; none SIMT), one ``greedy_generate`` at serve's
    defaults, and one prefill under torch.profiler;
33. mesh — a 1-rank NCCL process group (from a ``file://`` store in a
    ``tempfile`` directory; the bootstrap on the loopback) and its
    ``("data",)`` mesh (``launch.mesh.make_sim_mesh(1)``): the default
    FedHAP run of phase 5 with ``SimConfig(mesh=...)``, its satellite
    axis sharded over that mesh (``FusedExecutor``'s sharded path: the
    fold through ``core.mesh_round.sharded_fold``, the kernel and then
    one all-reduce in place on its output), the ``fedagg`` count zeroed
    just before and read just after: one launch and one all-reduce per
    round, the history equal to phase 5's and each block's params bit
    for bit equal to phase 5's unsharded ``run_block``; the all-reduce's
    device time at the fold's size; one sharded block of 8 rounds under
    ``sanitized_run`` (sync-debug mode "error"), its history equal to
    the first 8 of phase 5's; then ``launch.train.main`` with ``--full
    --sats 1 --orbits 1 --rounds 2`` on the group (the mesh path,
    ``build_fed_train_step``), for ``fedhap`` and ``fedhap_fused`` (one
    ``fedagg`` launch per round), each against ``--single-device``
    (``single_device_round`` at S=1, run once: it folds the same way
    whatever the round kind): the max |difference| of every leaf and of
    the losses, expected 0.

Each phase prints its seconds (``[time] phase N in ... s``).

Prints a ``{"kernels": [...]}`` JSON line (``fedagg``'s entry with the
phase 19, 21 and 26 launch counts by strategy, ``launches_routed``,
``launches_ticks`` and ``launches_sanitized``, phase 25's
``launches_train``, phase 30's ``launches_train_rwkv``, the LM fold's
times ``fold_lm`` and phase 33's ``launches_mesh`` (the sharded run's
count and the fused LM rounds' under ``train``); ``flash_attention``'s with phase 25's
``launches_train``, phase 32's ``launches_zoo`` by architecture and the
(96, 64) variant's own entry under ``split``, its launches those of
phase 32's minicpm3-4b prefill; ``rwkv6_wkv``'s with phase 30's; the backward's
entry, ``flash_attention_bwd``, with its variant, timed at the training
shape with the serve shape's numbers under ``serve`` and ptxas' report
under ``ptxas``; and the recurrences' backward entries,
``rwkv6_wkv_bwd`` (launches from phase 30, the slice's readings under
``train_slice``) and ``selective_scan_bwd`` (launches from phase 29's
jamba round, the Mamba block's under ``block``), shaped the same way),
the card line, and last ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM data sheet (dense, at the 700 W limit): HBM rate and the f32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12   # dense, tensor cores

# Kernel-vs-plain tolerances: those of the JAX package's own kernel sweep
# (tests/test_kernels.py). f32: the kernel's sequential FMA chain and the
# plain version's separately rounded multiply + tree sum differ by a few
# ulps of an O(5) sum. bf16: one bf16 ulp of the rounded output, at the
# sweep's short rows, whose outputs are O(0.2-1); the flash tensor-core
# kernel's P in bf16 (below) adds at most ~2^-9 of an output there.
TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# Flash at the prefill shape in bf16. A row that attends to n random keys
# has outputs of RMS ~sqrt(e/n): mean |O| is ~0.05 over S=4096 rows, as
# large as the sweep's atol. The plain version keeps P in f32; the
# tensor-core kernel rounds P to bf16 before P·V (2^-9 relative per
# element, which averages out over a long row as ~2^-9/sqrt(n) of an
# output) and, on the tiles that cross a mask edge, where a row may hold
# only a few keys, adds the remainder P - bf16(P) as a second bf16 product
# (P to ~2^-17). Scores and sums are f32 in both. They then differ by at
# most one bf16 ulp of the rounded output (<= 2^-7 relative) plus that
# share; rtol allows two ulps and atol covers outputs near 0
# (tests/test_torch_flash_attention.py emulates the kernel's rounding on
# the CPU and holds it to this). Phase 7 shows that planted faults on
# long rows break this tolerance.
PREFILL_BF16_TOL = dict(atol=1e-3, rtol=1.6e-2)
# Card vs CPU after one round of 2 SGD steps + the fold, both full f32
# (TF32 off): the convolutions and matmuls reduce in other orders, which
# moves O(0.05) params by a few f32 ulps per step.
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
# Full-width LM logits, card (kernel, cuBLAS) vs CPU (plain version, CPU
# BLAS), and decode vs prefill, both full f32 with TF32 off: the sums run
# in other orders (~1e-6 relative per matmul), and the difference
# compounds over 28 (qwen3-0.6b) or 32 (rwkv6-3b) residual layers; the
# JAX package bounds decode vs forward of 2 layers at 1e-4 and 1e-3
# (tests/test_decode.py).
LM_F32_TOL = dict(atol=1e-3, rtol=1e-3)
# Decode vs prefill at full width in bf16 (8 significant bits): the two
# paths round at other places (P cast to bf16 by decode's einsum, as in
# the JAX package, and by the prefill's tensor-core kernel, except on its
# mask-edge tiles; GEMMs of M=128 vs M=2) and the differences compound
# over 28 layers. Logits are ~N(0, 0.65^2) at
# this init; 0.25 is ~16 bf16 ulps at the largest |logit| (~4). Sound
# runs read ~0.16 on an H100; phase 9 plants two cache faults (a skipped
# position, a lost slot), which read ~3 there, and requires each to
# break this tolerance.
DECODE_BF16_ATOL = 0.25
# rwkv6-3b decode vs prefill at full width, at the reference's init (its
# stacked matrices drawn at std 1/sqrt(32); ROADMAP Queue C). The two
# paths' roundings (GEMMs of M=128 vs M=2, the decode's einsum state
# update vs the kernel's FMAs) reach the logits larger than qwen3-0.6b's.
# On an H100 (phase 13): f32 sound 2.3e-3 (1.2e-3 at step 0), the
# planted faults 0.058 (decay skipped) and 2.7 (stale token shift); bf16
# sound 0.99 (0.84 after step 0), the stale token shift 2.5. So f32
# holds 4x above its sound reading and 5x below the smaller fault; bf16
# 1.5x above and 1.7x below. A decay skipped for one step moves the
# state by 1 - w = 0.25% at the init's decays: in bf16 it reads 0.47,
# within the noise, so phase 13 requires it to break only the f32
# tolerance and reports its bf16 reading. With the matrices at their own
# fan-in the sound f32 reading is ~3 (phase 13 reports it): no tolerance
# could separate a fault there, so the checks run at the reference's init.
RWKV_DECODE_TOL = {"float32": dict(atol=1e-2, rtol=1e-3),
                   "bfloat16": dict(atol=1.5, rtol=0)}
# WKV kernel vs plain at the sweep: the CPU tests' tolerances
# (tests/test_torch_rwkv6_wkv.py). f32: both do the same sequential f32
# recurrence, the kernel with FMAs, the plain version with separately
# rounded products and an einsum's n-sum: a few ulps of O(10) outputs.
# bf16: one bf16 ulp of the rounded output (the JAX package's tolerance).
WKV_TOL = {"float32": dict(atol=3e-5, rtol=1e-5),
           "bfloat16": dict(atol=8e-2, rtol=5e-2)}
# WKV at the prefill shape (S=4096). f32: a state that remembers ~400
# steps (w = 0.99752) of O(1) kv terms carries its rounding along over
# outputs up to ~680 (mean |y| ~88); phase 11 reads 4.9e-4 there on an
# H100 (5.3e-5 at the uniform decays). bf16 (r, k, v and y bf16, w f32,
# as the model runs it): both
# paths compute in f32 and round once; they differ by at most one bf16
# ulp (<= 2^-7 relative), where their f32 values straddle a rounding
# boundary: rtol allows two ulps, and atol 1e-2 (1e-3 of mean |y| ~13 at
# the uniform decays, 1e-4 at the init's) covers outputs near 0. Phase 11
# shows that three planted faults from step 1024 break this tolerance.
WKV_PREFILL_TOL = {"float32": dict(atol=2e-3, rtol=1e-4),
                   "bfloat16": dict(atol=1e-2, rtol=1.6e-2)}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def ptxas_report(log_text: str) -> dict:
    """Registers and spill bytes of each flash kernel and of the
    recurrences' backward kernels in nvcc's ``-Xptxas -v`` report:
    {"name<dtype, D=..>" or "name<types, N=..>": (registers, spill
    stores, spill loads)}, the mangled names shortened."""
    out, name, spills = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            short = re.search(r"\d+(flash_\w+?)I(f|13__nv_bfloat16)?Li(\d+)E"
                              r"(?:Li(\d+)E)?", name)
            if short:
                dtype = {"f": "f32, ", "13__nv_bfloat16": "bf16, "}.get(
                    short.group(2), "")
                # The forward's kernels take (D, Dv); name the pair only
                # where the two differ.
                dv = short.group(4)
                dv = f", Dv={dv}" if dv and dv != short.group(3) else ""
                out[f"{short.group(1)}<{dtype}D={short.group(3)}{dv}>"] = (
                    int(m.group(1)), *spills)
            # The recurrences' kernels: <types..., N=n> (the WKV forward's
            # ", ckpt" where it stores the backward's checkpoints), the
            # types in template order ("S1_" repeats the bf16 before it);
            # wkv_bwd_du has no template.
            short = re.search(r"\d+((?:wkv|scan)_(?:bwd_[a-z]+|fwd))I(.*?)"
                              r"(?:Li(\d+)E)?(?:Lb([01])E)?EEv", name)
            if short:
                types = [{"f": "f32"}.get(x, "bf16") for x in re.findall(
                    r"f|13__nv_bfloat16|S\d*_", short.group(2))]
                n = f", N={short.group(3)}" if short.group(3) else ""
                ck = ", ckpt" if short.group(4) == "1" else ""
                out[f"{short.group(1)}<{', '.join(types)}{n}{ck}>"] = (
                    int(m.group(1)), *spills)
            elif re.search(r"\d+wkv_bwd_duE", name):
                out["wkv_bwd_du"] = (int(m.group(1)), *spills)
            name = None
    return out


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
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


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(torch, got, want, dtype_name: str, what: str,
                tol: dict | None = None) -> float:
    err = max_err(torch, got, want)
    tol = tol or TOL[dtype_name]
    ok = torch.allclose(got.float(), want.float(), **tol)
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version, max |err| {err:.3e} ({tol})")
    return err


def device_ms(torch, fn, reps: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, with
    the stream held busy by a sleep kernel while the host enqueues them,
    so that a call's host cost (ctypes, allocation) does not count as
    device time, as it does in :func:`time_ms`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e7))                     # ~25 ms at 1.98 GHz
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ragged_leaves(torch, gen, dtype, dev):
    """A ragged, mixed-alignment leaf list: unaligned views, P = 1, P not a
    multiple of the vector width, aligned vector leaves."""
    xs = []
    for s, p, offset in ((7, 1, 0), (7, 7, 1), (7, 1001, 3), (7, 4096, 0),
                         (7, 4096, 1), (7, 333, 0), (7, 8, 0), (7, 24, 2)):
        base = torch.randn(s * p + offset, generator=gen,
                           device=dev).to(dtype)
        xs.append(base[offset:].view(s, p))
    return xs


def phase_kernels(torch, fedagg_mod, ops, leaf_shapes, n_sats):
    """fedagg on the card against fedagg_plain; returns the kernels-line
    entry (launches filled in later from the main path)."""
    fedagg, fedagg_plain = fedagg_mod.fedagg, fedagg_mod.fedagg_plain
    leaves, leaves_plain = (fedagg_mod.fedagg_leaves,
                            fedagg_mod.fedagg_leaves_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.rand(n_sats, generator=gen, device=dev)

    # Main path: the CNN's 8 leaves, S=40, f32; each leaf alone (a one-leaf
    # launch) and the whole fold (one launch).
    xs = [torch.randn((n_sats, int(np.prod(shape))), generator=gen,
                      device=dev) for shape in leaf_shapes.values()]
    worst = 0.0
    rows = []
    for (name, shape), x in zip(leaf_shapes.items(), xs):
        err = check_close(torch, fedagg(x, w), fedagg_plain(x, w),
                          "float32", f"leaf {name}")
        worst = max(worst, err)
        p = x.shape[1]
        nbytes = (n_sats * p + p) * 4 + n_sats * 4
        rows.append(dict(
            leaf=name, P=p, max_abs_err=err,
            ms=time_ms(torch, lambda x=x: fedagg(x, w)),
            device_ms=device_ms(torch, lambda x=x: fedagg(x, w)),
            plain_ms=time_ms(torch, lambda x=x: fedagg_plain(x, w)),
            library_ms=time_ms(torch, lambda x=x: torch.mv(x.t(), w)),
            bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                               2 * n_sats * p / F32_FLOP_PER_S),
            bytes=nbytes))
    for r in rows:
        log("kernels", "fedagg leaf " + json.dumps(r))

    # The fold as a round runs it: one fedagg_leaves call, one launch,
    # bit-equal to one-leaf launches (the same per-column arithmetic) and
    # within the tolerance of the plain fold, in f32 and bf16.
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        xd = [x.to(dtype) for x in xs]
        before = fedagg.launches
        got = leaves(xd, w)
        if fedagg.launches != before + 1:
            raise AssertionError(f"fedagg_leaves over {len(xd)} leaves "
                                 f"launched {fedagg.launches - before} "
                                 f"times; expected 1")
        for i, (g, x, want) in enumerate(zip(got, xd, leaves_plain(xd, w))):
            if not torch.equal(g, fedagg(x, w)):
                raise AssertionError(f"fedagg_leaves {dname} leaf {i} is "
                                     f"not bit-equal to its one-leaf launch")
            err = check_close(torch, g, want, dname,
                              f"fedagg_leaves {dname} leaf {i}")
            if dtype == torch.float32:
                worst = max(worst, err)
        log("kernels", f"fedagg_leaves {dname}, the CNN's {len(xd)} "
            f"leaves: one launch, bit-equal to one-leaf launches, within "
            f"{TOL[dname]} of the plain fold")
    total_bytes = sum(r["bytes"] for r in rows)
    total_flop = sum(2 * n_sats * r["P"] for r in rows)
    # Timed as earlier PRs timed the fold: back-to-back calls, each
    # call's host cost included (time_ms); beside it the device time with
    # the host's cost hidden (device_ms).
    fold = lambda: leaves(xs, w)                               # noqa: E731
    mv = lambda: [torch.mv(x.t(), w) for x in xs]              # noqa: E731
    fold_ms = time_ms(torch, fold)
    plain_ms = time_ms(torch, lambda: leaves_plain(xs, w))
    lib_ms = time_ms(torch, mv)
    fold_dev, lib_dev = device_ms(torch, fold), device_ms(torch, mv)
    bound_ms = 1e3 * max(total_bytes / HBM_BYTES_PER_S,
                         total_flop / F32_FLOP_PER_S)
    bound_by = ("bytes" if total_bytes / HBM_BYTES_PER_S
                >= total_flop / F32_FLOP_PER_S else "operations")
    log("kernels", f"fedagg fold of {len(xs)} leaves, S={n_sats}, "
        f"{total_bytes} bytes, bound {bound_ms:.4f} ms ({bound_by}); back "
        f"to back with the host's cost: kernel {fold_ms:.4f} ms (one "
        f"launch; {total_bytes / fold_ms / 1e6:.1f} GB/s), plain "
        f"{plain_ms:.4f} ms, torch.mv per leaf {lib_ms:.4f} ms; device "
        f"time: kernel {fold_dev:.4f} ms ({total_bytes / fold_dev / 1e6:.1f}"
        f" GB/s, {bound_ms / fold_dev:.3f} of its bound), torch.mv per leaf "
        f"{lib_dev:.4f} ms")
    fold_s8 = phase_fold_rows(
        torch, leaves, leaves_plain,
        [x[:CYCLE_MEMBERS].contiguous() for x in xs], gen, dev,
        "one orbit's members per cycle event")

    # Ragged shapes and unaligned views, one leaf at a time and as one
    # list; a list longer than MAX_LEAVES; f32 and bf16.
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for s, p, offset in ((1, 7, 0), (40, 7, 0), (3, 1001, 0),
                             (40, 333, 0), (40, 4096, 0), (8, 4096, 1),
                             (5, 1003, 1)):
            gw = torch.rand(s, generator=gen, device=dev)
            base = torch.randn(s * p + offset, generator=gen,
                               device=dev).to(dtype)
            x = base[offset:].view(s, p)
            err = check_close(torch, fedagg(x, gw), fedagg_plain(x, gw),
                              dname, f"{dname} S={s} P={p} off={offset}")
            log("kernels", f"fedagg {dname} S={s} P={p} "
                f"unaligned={bool(offset)}: max |err| {err:.3e}")
        gw = torch.rand(7, generator=gen, device=dev)
        ragged = _ragged_leaves(torch, gen, dtype, dev)
        for label, xl in (("ragged", ragged), ("long", ragged * 9)):
            before = fedagg.launches
            got = leaves(xl, gw)
            n_launch = fedagg.launches - before
            want_launch = -(-len(xl) // fedagg_mod.MAX_LEAVES)
            if n_launch != want_launch:
                raise AssertionError(f"fedagg_leaves over {len(xl)} leaves "
                                     f"launched {n_launch} times; expected "
                                     f"{want_launch}")
            err = 0.0
            for i, (g, x, want) in enumerate(zip(got, xl,
                                                 leaves_plain(xl, gw))):
                if not torch.equal(g, fedagg(x, gw)):
                    raise AssertionError(f"fedagg_leaves {dname} {label} "
                                         f"leaf {i} is not bit-equal to "
                                         f"its one-leaf launch")
                err = max(err, check_close(torch, g, want, dname,
                                           f"fedagg_leaves {dname} {label} "
                                           f"leaf {i}"))
            log("kernels", f"fedagg_leaves {dname} {label}: {len(xl)} "
                f"leaves (P = 1 .. 4096, unaligned views) in {n_launch} "
                f"launch(es), bit-equal to one-leaf launches, max |err| "
                f"{err:.3e}")

    # Zero-weight padding rows add exactly zero.
    tree = {k: x.view(n_sats, *shape)
            for (k, shape), x in zip(leaf_shapes.items(), xs)}
    padded, pw = ops.pad_stacked_rows(tree, w, 16)
    a = ops.fold_stacked_tree(tree, w)
    b = ops.fold_stacked_tree(padded, pw)
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("zero-weight padded rows changed the fold")
    log("kernels", f"zero-weight padding to {pw.numel()} rows: "
        f"fold bit-equal")
    del xs, tree, padded
    return dict(name="fedagg", route="cuda",
                source="src/repro_torch/kernels/csrc/fedagg.cu",
                replaces="src/repro/kernels/fedagg.py:30",
                launches=None, max_abs_err=worst, ms=fold_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, device_ms=fold_dev,
                library_device_ms=lib_dev, fold_s8=fold_s8)


# The routed cycle family folds one orbit's members per event: S = k = 8.
CYCLE_MEMBERS = 8


def phase_fold_rows(torch, leaves, leaves_plain, xs, gen, dev,
                    what: str) -> dict:
    """The fold of the CNN's 8 leaves ``xs`` (each ``(S, P)``, S rows as
    a main path folds them: ``what``): checked against the plain fold,
    then timed back to back with the host's cost and as device time,
    beside its bound, (S+1)·P·4 bytes over the card's memory rate, and
    torch.mv per leaf."""
    s = xs[0].shape[0]
    w = torch.rand(s, generator=gen, device=dev)
    err = 0.0
    for i, (g, want) in enumerate(zip(leaves(xs, w), leaves_plain(xs, w))):
        err = max(err, check_close(torch, g, want, "float32",
                                   f"fedagg_leaves S={s} leaf {i}"))
    nbytes = sum((s * x.shape[1] + x.shape[1]) * 4 + s * 4 for x in xs)
    flop = sum(2 * s * x.shape[1] for x in xs)
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S)
    fold = lambda: leaves(xs, w)                                # noqa: E731
    mv = lambda: [torch.mv(x.t(), w) for x in xs]               # noqa: E731
    out = dict(S=s, bytes=nbytes, max_abs_err=err, ms=time_ms(torch, fold),
               device_ms=device_ms(torch, fold),
               plain_ms=time_ms(torch, lambda: leaves_plain(xs, w)),
               library_ms=time_ms(torch, mv),
               library_device_ms=device_ms(torch, mv), bound_ms=bound_ms,
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flop / F32_FLOP_PER_S else "operations"))
    log("kernels", f"fedagg fold of {len(xs)} leaves, S={s} ({what}), "
        f"{nbytes} bytes, bound "
        f"{bound_ms:.4f} ms; back to back with the host's cost: kernel "
        f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, torch.mv per "
        f"leaf {out['library_ms']:.4f} ms; device time: kernel "
        f"{out['device_ms']:.4f} ms ({bound_ms / out['device_ms']:.3f} of "
        f"its bound), torch.mv per leaf {out['library_device_ms']:.4f} ms; "
        f"max |err| {err:.3e}")
    return out


def phase_guard(torch, kernels: dict, fa_mod, wkv_mod, scan_mod) -> None:
    """With grad enabled and a CUDA input that requires grad: the
    ``fedagg`` wrapper raises (the fold has no backward) and launches
    nothing; the ``flash_attention``, ``rwkv6_wkv`` and ``selective_scan``
    wrappers go through their backward kernels, one forward and one
    backward launch per call, and each input's gradient must agree with
    the plain backward (f32 tolerance); flash with MLA's head dims (96,
    64), which the backward kernels lack, raises NotImplementedError
    naming its ROADMAP item and launches nothing."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(9)

    def t(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    fn = kernels["fedagg"]
    before = fn.launches
    try:
        fn(t(3, 10).requires_grad_(), t(3))
    except RuntimeError as err:
        if "no backward" not in str(err):
            raise
    else:
        raise AssertionError("fedagg took a CUDA input that requires grad "
                             "with grad enabled")
    if fn.launches != before:
        raise AssertionError("fedagg launched despite the guard")
    log("guard", "grad enabled, a CUDA input requiring grad: fedagg raises "
        "RuntimeError (the fold has no backward), no launch")

    qkv = (t(1, 2, 8, 16), t(1, 1, 8, 16), t(1, 1, 8, 16))
    wkv_in = (t(1, 2, 6, 8), t(1, 2, 6, 8), t(1, 2, 6, 8), t(1, 2, 6, 8),
              t(2, 8))
    scan_in = (t(1, 6, 4, 4), t(1, 6, 4, 4), t(1, 6, 4))
    cases = {
        "flash_attention": (qkv, t(1, 2, 8, 16), "FlashAttentionFn",
                            lambda do: fa_mod.flash_attention_bwd_plain(
                                *qkv, fa_mod.flash_attention_plain(*qkv),
                                fa_mod.flash_attention_lse_plain(qkv[0],
                                                                 qkv[1]),
                                do)),
        "rwkv6_wkv": (wkv_in, t(1, 2, 6, 8), "RwkvWkvFn",
                      lambda dy: wkv_mod.rwkv6_wkv_bwd_plain(*wkv_in, dy)),
        "selective_scan": (scan_in, t(1, 6, 4), "SelectiveScanFn",
                           lambda dy: scan_mod.selective_scan_bwd_plain(
                               *scan_in, dy)),
    }
    for name, (args, dout, node, plain_bwd) in cases.items():
        fn = kernels[name]
        want = plain_bwd(dout)
        worst = 0.0
        for which in range(len(args)):
            inputs = [x.clone().requires_grad_() if i == which else x
                      for i, x in enumerate(args)]
            before = (fn.launches, fn.launches_bwd)
            out = fn(*inputs)
            if node not in type(out.grad_fn).__name__:
                raise AssertionError(f"{name} under grad built "
                                     f"{out.grad_fn}, not {node}")
            (got,) = torch.autograd.grad(out, [inputs[which]], dout)
            if (fn.launches, fn.launches_bwd) != (before[0] + 1,
                                                  before[1] + 1):
                raise AssertionError(f"{name} under grad did not run one "
                                     f"forward and one backward launch")
            worst = max(worst, check_close(
                torch, got, want[which], "float32",
                f"{name} gradient of input {which}"))
        log("guard", f"{name} under grad: a {node} node, one forward and "
            f"one backward launch per call, the gradients of all "
            f"{len(args)} inputs within {TOL['float32']} of its plain "
            f"backward (max |err| {worst:.3e})")

    # MLA's (96, 64) pair: the backward kernels have no D != Dv variant,
    # so under grad the wrapper raises before it launches anything.
    fn = kernels["flash_attention"]
    before = (fn.launches, fn.launches_bwd)
    try:
        fn(t(1, 2, 8, 96).requires_grad_(), t(1, 2, 8, 96), t(1, 2, 8, 64))
    except NotImplementedError as err:
        if "ROADMAP" not in str(err):
            raise
        msg = str(err)
    else:
        raise AssertionError("flash_attention with D=96, Dv=64 took a CUDA "
                             "input that requires grad")
    if (fn.launches, fn.launches_bwd) != before:
        raise AssertionError("flash_attention (96, 64) launched under grad")
    log("guard", f"flash_attention (96, 64) under grad on the card raises "
        f"NotImplementedError, no launch: {msg}")


def phase_card_vs_cpu(torch, eng, sim):
    """One full-width round with local_steps=2 on the card and on the
    CPU from the same init, through FusedExecutor.run_block."""
    from repro_torch.models.params import params_to_numpy, params_from_numpy
    from repro_torch.sim.strategies import FedHap

    steps = 2
    plan = FedHap().plan_round(eng, 0.0)
    rng = np.random.default_rng((eng.cfg.seed, 4))
    idx = eng.trainer.sample_client_indices(
        eng.fd, np.arange(eng.n_sats), steps, rng)[None]
    mu = np.asarray(plan.mu, np.float32)[None]
    flags = np.ones(1, bool)
    init = params_to_numpy(eng.trainer.init(eng.cfg.seed))

    outs = {}
    for device, ex in (("cuda", eng.executor),
                       ("cpu", sim.FusedExecutor(
                           sim.LocalTrainer(eng.trainer.model,
                                            eng.cfg.learning_rate,
                                            eng.cfg.batch_size, "cpu"),
                           eng.fd, eng.eval_images, eng.eval_labels))):
        t0 = time.perf_counter()
        params, accs = ex.run_block(params_from_numpy(init, device), idx,
                                    mu, flags, flags)
        if device == "cuda":
            torch.cuda.synchronize()
        outs[device] = (params_to_numpy(params), float(accs[0]))
        log("card-vs-cpu", f"{device}: one round ({eng.n_sats} replicas x "
            f"{steps} steps + fold + eval) in "
            f"{time.perf_counter() - t0:.3f} s, acc {accs[0]:.6f}")
    worst = 0.0
    for k, want in outs["cpu"][0].items():
        got = outs["cuda"][0][k]
        worst = max(worst, float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, **PARAM_TOL,
                                   err_msg=f"param {k}: card vs CPU")
    n_eval = len(eng.eval_labels)
    dacc = abs(outs["cuda"][1] - outs["cpu"][1])
    # Accuracy: at most two flipped predictions of the eval set.
    if dacc > 2.0 / n_eval + 1e-7:
        raise AssertionError(f"card vs CPU accuracy differs by {dacc}")
    log("card-vs-cpu", f"params agree: max |card - cpu| {worst:.3e} "
        f"({PARAM_TOL}); accuracy differs by {dacc:.6f}")


def profile_device(torch, fn):
    """Run ``fn`` once under torch.profiler (CPU and CUDA activities).
    Returns ``(by_name, union_us, window_us, wall_us)``: device time and
    count by kernel name, the union of the kernels' intervals (kernels
    that overlap count once), the window from the first kernel's start
    to the last one's end, and the host wall time; ``by_name`` is empty
    if the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name: dict[str, list] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            row = by_name.setdefault(ev.name, [0.0, 0])
            row[0] += ev.time_range.elapsed_us()
            row[1] += 1
            spans.append((ev.time_range.start, ev.time_range.end))
    if not spans:
        return by_name, 0.0, 0.0, wall_us
    spans.sort()
    union, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    union += cur_e - cur_s
    return by_name, union, spans[-1][1] - spans[0][0], wall_us


def log_profile(phase: str, what: str, prof, needle: str, top: int = 12,
                also: tuple = ()):
    """Print a profile_device result: busy share, the share of kernels
    whose name holds ``needle`` and each of them by name (those holding a
    name in ``also`` too), and the ``top`` kernels by time."""
    by_name, union, window, wall_us = prof
    busy_us = sum(r[0] for r in by_name.values())
    if not busy_us:
        log(phase, f"{what}: device time by kernel: not measured (the "
            f"profiler recorded no device activity)")
        return
    log(phase, f"{what}: host wall {wall_us / 1e3:.3f} ms (profiler "
        f"on), {sum(r[1] for r in by_name.values())} kernels summing to "
        f"{busy_us / 1e3:.3f} ms; device busy (union) {union / 1e3:.3f} ms "
        f"= {100 * union / window:.1f}% of the {window / 1e3:.3f} ms kernel "
        f"window, {100 * union / wall_us:.1f}% of the host wall")
    mine = sum(r[0] for n, r in by_name.items() if needle in n)
    log(phase, f"{needle}: {mine:.1f} us ({100 * mine / busy_us:.3f}% of "
        f"device time)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        if any(x in name for x in (needle, *also)):
            log(phase, f"  by kernel: {us / 1e3:9.3f} ms x{n:<5d} "
                f"({us / max(n, 1):.1f} us each) {name[:110]}")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        log(phase, f"{100 * us / busy_us:6.2f}%  {us / 1e3:9.3f} ms  "
            f"x{n:<5d} {name[:110]}")


def phase_profile(torch, eng):
    """Where one round's device time goes: one planned full-width round
    through ``run_block`` (after a warm-up round) under torch.profiler.
    Prints device time by kernel and the busy share of the round's wall
    time; "not measured" if the profiler records no device activity."""
    from repro_torch.sim.strategies import FedHap

    plan = FedHap().plan_round(eng, 0.0)
    idx = eng.sample_indices(np.arange(eng.n_sats), 0.0)[None]
    mu = np.asarray(plan.mu, np.float32)[None]
    flags = np.ones(1, bool)
    params = eng.trainer.init(eng.cfg.seed)
    eng.executor.run_block(params, idx, mu, flags, flags)
    log_profile("profile", "one round", profile_device(
        torch, lambda: eng.executor.run_block(params, idx, mu, flags,
                                              flags)), "fedagg")


# Phase 7's sweep: the CPU tests' shapes (tests/test_torch_flash_attention
# .py) as (B, H, Hkv, S, D, causal, window), then ragged lengths around
# the tensor-core kernel's 64-row groups and 128-key tiles (S = 1, 63, 65,
# 127, 129, 300 at D = 64 and 128), GQA groups 1, 2, 4 and 8, and windows
# across a tile edge (W = 1, 63, 200).
FLASH_SWEEP = (
    [(1, 2, 2, 32, 16, True, None), (2, 4, 2, 64, 32, True, None),
     (1, 8, 2, 48, 64, True, None), (1, 2, 1, 40, 8, True, None),
     (2, 2, 2, 128, 128, True, None), (2, 8, 2, 80, 32, True, 20),
     (1, 2, 2, 32, 16, False, None)]
    + [(1, 2, 2, 64, 16, True, w) for w in (1, 8, 24, 1000)]
    + [(1, 2, 2, 1, 128, True, None), (1, 4, 4, 1, 64, True, None),
       (1, 4, 2, 63, 64, True, None), (2, 8, 4, 63, 128, True, 63),
       (1, 4, 1, 65, 128, True, None), (1, 8, 8, 65, 64, False, None),
       (2, 8, 1, 127, 64, True, 63), (1, 4, 2, 127, 128, True, 1),
       (1, 8, 2, 129, 128, True, 1), (1, 8, 1, 129, 64, True, 200),
       (1, 8, 8, 300, 64, True, 200), (2, 16, 2, 300, 128, True, 63),
       (1, 4, 1, 300, 128, False, None), (1, 16, 8, 300, 64, True, None)])
PREFILL = dict(b=4, h=16, hkv=8, s=4096, d=128)
# jamba-v0.1-52b's one attention block in its serve prefill (phase 18):
# 32 heads over 8 KV heads (group 4), no RoPE.
JAMBA_FLASH_PREFILL = dict(b=4, h=32, hkv=8, s=4096, d=128)


def _bshd_views(torch, gen, b, h, hkv, s, d, dtype):
    """q, k, v as the model passes them: (B, S, H, D) storage viewed as
    (B, H, S, D)."""
    return [torch.randn((b, s, n, d), generator=gen, device="cuda")
            .to(dtype).transpose(1, 2) for n in (h, hkv, hkv)]


def _dense_attention(torch, q, k, v, ok):
    """f32 attention of (B, H, S, D) q against GQA k/v under the boolean
    (Sq, Sk) mask ``ok``, cast to q's dtype."""
    group = q.shape[1] // k.shape[1]
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                      k.repeat_interleave(group, 1).float())
    sc = sc.mul_(1.0 / math.sqrt(q.shape[-1])).masked_fill_(~ok, -1e30)
    p = torch.softmax(sc, dim=-1)
    del sc
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.repeat_interleave(group, 1).float()).to(q.dtype)


def check_planted_faults(torch, q, k, v, want, row0: int = 1024,
                         tile: int = 64):
    """Faults a kernel could make only on long rows, each computed densely
    from the same inputs, must break PREFILL_BF16_TOL against the sound
    output ``want``: the K/V tile at ``row0`` dropped for the rows past
    it, that tile a repeat of the one before, and the causal bound off by
    one (one future key) on rows from ``row0``."""
    s = q.shape[2]
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    causal = qpos >= kpos
    in_tile = (kpos >= row0) & (kpos < row0 + tile)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, row0:row0 + tile] = k[:, :, row0 - tile:row0]
    v2[:, :, row0:row0 + tile] = v[:, :, row0 - tile:row0]
    faults = {
        f"K tile {row0}..{row0 + tile - 1} dropped for rows past it":
            lambda: _dense_attention(torch, q, k, v, causal & ~(
                in_tile & (qpos >= row0 + tile))),
        f"K tile {row0}.. a repeat of the tile before":
            lambda: _dense_attention(torch, q, k2, v2, causal),
        f"causal bound off by one on rows >= {row0}":
            lambda: _dense_attention(torch, q, k, v, causal | (
                (qpos >= row0) & (kpos == qpos + 1))),
    }
    for name, fn in faults.items():
        bad = fn()
        err = max_err(torch, bad, want)
        if torch.allclose(bad.float(), want.float(), **PREFILL_BF16_TOL):
            raise AssertionError(f"planted fault passes the prefill-shape "
                                 f"tolerance ({name}: max |err| {err:.3e})")
        log("flash", f"planted fault ({name}): max |err| {err:.3e}, "
            f"caught by {PREFILL_BF16_TOL}")
        del bad


def check_ragged_faults(torch, q, k, v, want, tile: int = 128):
    """Faults a kernel could make on the ragged last K/V tile of a
    bidirectional Sq != Sk call, each computed densely from the same
    inputs, must break PREFILL_BF16_TOL against the sound output
    ``want``: the last partial tile (Sk mod ``tile`` keys) dropped, and
    the slots past Sk in that tile read as the stale rows of the tile
    two before (the K/V ring's other use of that stage) instead of being
    masked. Returns each fault's max |err|."""
    sk = k.shape[2]
    last, pad = sk - sk % tile, tile - sk % tile
    if sk % tile == 0:
        raise ValueError(f"Sk={sk} has no ragged tile of {tile}")
    kpos = torch.arange(sk + pad, device=q.device).expand(q.shape[2], -1)
    stale = slice(last - tile - pad, last - tile)
    faults = {
        f"last partial K/V tile ({sk - last} keys) dropped":
            lambda: _dense_attention(torch, q, k, v, kpos[:, :sk] < last),
        f"the {pad} slots past Sk read as stale rows, unmasked":
            lambda: _dense_attention(
                torch, q, torch.cat([k, k[:, :, stale]], 2),
                torch.cat([v, v[:, :, stale]], 2), kpos >= 0),
    }
    out = {}
    for name, fn in faults.items():
        bad = fn()
        out[name] = err = max_err(torch, bad, want)
        if torch.allclose(bad.float(), want.float(), **PREFILL_BF16_TOL):
            raise AssertionError(f"planted fault passes the prefill-shape "
                                 f"tolerance ({name}: max |err| {err:.3e})")
        log("flash", f"planted fault at Sq={q.shape[2]} Sk={sk}, causal "
            f"off ({name}): max |err| {err:.3e}, caught by "
            f"{PREFILL_BF16_TOL}")
        del bad
    return out


def phase_flash(torch, fa_mod):
    """flash_attention on the card against flash_attention_plain; returns
    the kernels-line entry (launches filled in later from the main
    path)."""
    fa, plain = fa_mod.flash_attention, fa_mod.flash_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, h, hkv, s, d, causal, window in FLASH_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = _bshd_views(torch, gen, b, h, hkv, s, d, dtype)
            variant = fa_mod.kernel_variant(dtype, d)
            before = (fa.launches_tc, fa.launches_simt)
            err = check_close(torch, fa(q, k, v, causal, window),
                              plain(q, k, v, causal, window), dname,
                              f"flash {dname} B={b} H={h} Hkv={hkv} S={s} "
                              f"D={d} causal={causal} window={window}")
            ran = (fa.launches_tc - before[0], fa.launches_simt - before[1])
            if ran != ((1, 0) if variant == "tc" else (0, 1)):
                raise AssertionError(f"flash {dname} D={d}: launches "
                                     f"(tc, simt) {ran}; want {variant}")
            log("flash", f"{dname} B={b} H={h} Hkv={hkv} S={s} D={d} "
                f"causal={causal} window={window} ({variant}): max |err| "
                f"{err:.3e}")

    # The prefill shapes: jamba's first, then qwen3-0.6b's, whose numbers
    # go into the kernels line. bf16 runs the tensor-core kernel, f32 the
    # SIMT one (counted).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = 0.0
    for shape in (JAMBA_FLASH_PREFILL, PREFILL):
        b, h, hkv, s, d = (shape[x] for x in ("b", "h", "hkv", "s", "d"))
        what = f"B={b} H={h} Hkv={hkv} S={s} D={d}"
        q, k, v = _bshd_views(torch, gen, b, h, hkv, s, d, torch.float32)
        n_simt = fa.launches_simt
        err32 = check_close(torch, fa(q, k, v), plain(q, k, v), "float32",
                            f"flash f32 at the prefill shape {what}")
        ms32 = time_ms(torch, lambda: fa(q, k, v), reps=3, warmup=1)
        if fa.launches_simt - n_simt != 5:
            raise AssertionError("f32 flash calls did not all run the SIMT "
                                 "kernel")
        log("flash", f"prefill shape {what} f32: max |err| {err32:.3e} "
            f"({TOL['float32']}); SIMT kernel {ms32:.4f} ms")
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        n_tc = fa.launches_tc
        got = fa(q, k, v)
        if fa.launches_tc != n_tc + 1:
            raise AssertionError("bf16 flash did not run the tensor-core "
                                 "kernel")
        if not got.transpose(1, 2).is_contiguous():
            raise AssertionError("flash output is not laid out like q")
        want = plain(q, k, v)
        err = check_close(torch, got, want, "bfloat16",
                          f"flash at the prefill shape {what}",
                          PREFILL_BF16_TOL)
        worst = max(worst, err)
        log("flash", f"prefill shape {what} bf16: max |err| {err:.3e} "
            f"({PREFILL_BF16_TOL}); mean |out| "
            f"{float(want.float().abs().mean()):.4f}")
        del got
        check_planted_faults(torch, q, k, v, want)
        del want
        ms = time_ms(torch, lambda: fa(q, k, v), reps=10)
        plain_ms = time_ms(torch, lambda: plain(q, k, v), reps=5, warmup=1)
        lib_ms = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True,
                                             enable_gqa=True), reps=10)
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
        # The causal pairs this input needs, 2 FLOP per multiply-add in
        # each of Q·Kᵀ and P·V.
        flop = 4 * b * h * d * s * (s + 1) // 2
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log("flash", f"prefill shape {what} bf16 causal: tensor-core kernel "
            f"{ms:.4f} ms at {flop / ms / 1e9:.2f} TFLOP/s, SIMT kernel "
            f"(f32) {ms32:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms at {flop / lib_ms / 1e9:.2f} TFLOP/s; "
            f"{nbytes} bytes, {flop:.4e} FLOP, bound {bound_ms:.4f} ms "
            f"({bound_by}); kernel at {bound_ms / ms:.3f} of its bound, "
            f"{ms / lib_ms:.3f}x sdpa")
    del q, k, v
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:87",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


# Phase 7's sweep of MLA's head dims (q and k 96, v 64: minicpm3-4b) as
# (B, H, Hkv, Sq, Sk, causal, window): ragged lengths around the
# tensor-core kernel's 64-row groups and 128-key tiles, causal, windowed
# and bidirectional, GQA groups 1, 4 and 8, Sq != Sk both ways.
FLASH_SPLIT_SWEEP = (
    [(2, 4, 4, s, s, causal, window) for s in (1, 63, 65, 127, 129, 300)
     for causal, window in ((True, None), (True, 63), (False, None))]
    + [(1, 8, 2, 300, 300, True, None), (1, 8, 1, 200, 200, True, 1),
       (1, 4, 4, 7, 300, False, None), (1, 4, 2, 300, 1, False, None)])
# Cross-attention's and the encoder's shapes, the causal mask off, as (B,
# H, Hkv, Sq, Sk, D): whisper-small's decoder prefill against its 1500
# frames and its encoder (ragged Sk on every tile row), then Sq != Sk at
# other head dims.
FLASH_CROSS_SWEEP = ((1, 12, 12, 4096, 1500, 64), (1, 12, 12, 1500, 1500, 64),
                     (2, 12, 12, 129, 1500, 64), (1, 4, 2, 65, 130, 128),
                     (1, 4, 4, 300, 129, 16), (1, 4, 1, 7, 300, 8))
# whisper-small's cross-attention (Sq, Sk), at which the ragged last K/V
# tile's planted faults are checked.
WHISPER_CROSS = (4096, 1500)
# The sweeps' tolerances: the prefill's in bf16, whose outputs over rows
# of 1500 keys average ~0.03, below the kernel sweep's atol (TOL); the
# tensor-core kernel's rounding on these shapes is emulated on the CPU and
# held to it by tests/test_torch_flash_dims.py.
SPLIT_TOL = {"float32": TOL["float32"], "bfloat16": PREFILL_BF16_TOL}
# minicpm3-4b's prefill: 40 heads, q and k 96 wide, v 64, causal.
MLA_PREFILL = dict(b=4, h=40, s=4096, d=96, dv=64)


def _split_views(torch, gen, b, h, hkv, sq, sk, d, dv, dtype):
    """q, k, v as the model passes them, with v's head dim ``dv``."""
    return [torch.randn((b, s, n, e), generator=gen, device="cuda")
            .to(dtype).transpose(1, 2)
            for s, n, e in ((sq, h, d), (sk, hkv, d), (sk, hkv, dv))]


def phase_flash_split(torch, fa_mod) -> dict:
    """Phase 7, the head-dim pair (96, 64) and the bidirectional Sq != Sk
    shapes: each case in f32 (SIMT) and bf16 (tensor cores) against the
    plain version at ``SPLIT_TOL``, its variant and split launches
    counted, and at whisper's cross-attention shape in bf16 the planted
    faults of the ragged last K/V tile caught; then the pair
    at minicpm3-4b's prefill shape in bf16 against the plain version and
    timed beside its bound and SDPA's time (timed here only). Returns the
    variant's kernels-line entry (launches filled in by phase 32)."""
    fa, plain = fa_mod.flash_attention, fa_mod.flash_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = ([(b, h, hkv, sq, sk, 96, 64, c, w)
              for b, h, hkv, sq, sk, c, w in FLASH_SPLIT_SWEEP]
             + [(b, h, hkv, sq, sk, d, d, False, None)
                for b, h, hkv, sq, sk, d in FLASH_CROSS_SWEEP])
    worst = {}
    for b, h, hkv, sq, sk, d, dv, causal, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            tol = SPLIT_TOL[dname]
            q, k, v = _split_views(torch, gen, b, h, hkv, sq, sk, d, dv,
                                   dtype)
            variant = fa_mod.kernel_variant(dtype, d)
            before = (fa.launches_tc, fa.launches_simt, fa.launches_split)
            what = (f"flash {dname} B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} "
                    f"D={d} Dv={dv} causal={causal} window={window}")
            got = fa(q, k, v, causal, window)
            if got.shape != (b, h, sq, dv) or not got.transpose(
                    1, 2).is_contiguous():
                raise AssertionError(f"{what}: output {tuple(got.shape)} "
                                     f"not laid out like q")
            want = plain(q, k, v, causal, window)
            err = check_close(torch, got, want, dname, what, tol)
            if (dname, sq, sk) == ("bfloat16",) + WHISPER_CROSS:
                check_ragged_faults(torch, q, k, v, want)
            del got, want
            ran = (fa.launches_tc - before[0], fa.launches_simt - before[1],
                   fa.launches_split - before[2])
            want = ((1, 0) if variant == "tc" else (0, 1)) + (int(d != dv),)
            if ran != want:
                raise AssertionError(f"{what}: launches (tc, simt, split) "
                                     f"{ran}; want {want}")
            key = (dname, d != dv)
            worst[key] = max(worst.get(key, 0.0), err)
    for (dname, split), err in sorted(worst.items()):
        what = ("(96, 64) sweep" if split
                else "bidirectional Sq != Sk and encoder")
        n = len(FLASH_SPLIT_SWEEP if split else FLASH_CROSS_SWEEP)
        log("flash", f"{what} {dname}: {n} cases, max |err| {err:.3e} "
            f"({SPLIT_TOL[dname]}), each on its kernel's variant")

    b, h, sq, d, dv = (MLA_PREFILL[x] for x in ("b", "h", "s", "d", "dv"))
    what = f"B={b} H={h} S={sq} D={d} Dv={dv}"
    q, k, v = _split_views(torch, gen, b, h, h, sq, sq, d, dv,
                           torch.bfloat16)
    n_split = fa.launches_split
    got = fa(q, k, v)
    want = plain(q, k, v)
    err = check_close(torch, got, want, "bfloat16",
                      f"flash at minicpm3-4b's prefill shape {what}",
                      PREFILL_BF16_TOL)
    if fa.launches_split != n_split + 1:
        raise AssertionError("the (96, 64) prefill did not run its variant")
    log("flash", f"minicpm3-4b prefill shape {what} bf16: max |err| "
        f"{err:.3e} ({PREFILL_BF16_TOL}); mean |out| "
        f"{float(want.float().abs().mean()):.4f}")
    del got, want
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(torch, lambda: fa(q, k, v), reps=10)
    dev_ms = device_ms(torch, lambda: fa(q, k, v), reps=20)
    plain_ms = time_ms(torch, lambda: plain(q, k, v), reps=2, warmup=1)
    lib_ms = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True), reps=10)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, v))
    flop = b * h * sq * (sq + 1) * (d + dv)      # causal pairs, 2 per MAC
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log("flash", f"minicpm3-4b prefill shape {what} bf16 causal: (96, 64) "
        f"tensor-core kernel {ms:.4f} ms back to back, {dev_ms:.4f} ms "
        f"device, at {flop / dev_ms / 1e9:.2f} TFLOP/s; plain "
        f"{plain_ms:.4f} ms; sdpa {lib_ms:.4f} ms; {nbytes} bytes, "
        f"{flop:.4e} FLOP, bound {bound_ms:.4f} ms ({bound_by}); kernel at "
        f"{bound_ms / dev_ms:.3f} of its bound, {ms / lib_ms:.3f}x sdpa")
    del q, k, v
    return dict(name="flash_attention<D=96, Dv=64>", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:87",
                launches=None, max_abs_err=err, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms)


# Phase 11's sweep: the CPU tests' shapes (tests/test_torch_rwkv6_wkv.py)
# as (B, H, S, N), and a 300-step one at the model's 40 heads of 64.
WKV_SWEEP = [(1, 1, 16, 4), (2, 3, 64, 8), (1, 4, 32, 16), (2, 2, 48, 8),
             (1, 2, 32, 32), (1, 2, 40, 64), (2, 40, 300, 64)]
# The rwkv6-3b serve slice's prefill: 4 x 4096 tokens, 40 heads of 64.
WKV_PREFILL = dict(b=4, h=40, s=4096, n=64)
# decay_base's init (-6) through exp(-exp(.)): the model's decay at init.
WKV_INIT_DECAY = math.exp(-math.exp(-6.0))


def _wkv_views(torch, gen, b, h, s, n, dtype, w_dtype, decay):
    """r, k, v, w as the model passes them, (B, S, H, N) storage viewed as
    (B, H, S, N), and u (H, N) f32. ``decay`` is a constant w or a (lo,
    hi) range to draw w from uniformly."""
    r, k, v = (torch.randn((b, s, h, n), generator=gen, device="cuda")
               .to(dtype).transpose(1, 2) for _ in range(3))
    if isinstance(decay, tuple):
        lo, hi = decay
        w = lo + (hi - lo) * torch.rand((b, s, h, n), generator=gen,
                                        device="cuda")
    else:
        w = torch.full((b, s, h, n), decay, device="cuda")
    u = torch.randn((h, n), generator=gen, device="cuda")
    return r, k, v, w.to(w_dtype).transpose(1, 2), u


def _unaddressable(torch, x, kind: str):
    """``x`` (B, H, S, N) as a view the WKV kernel's tile copies cannot
    address: based one element past its storage's start ("offset"), or
    with rows N + 1 elements apart ("odd stride")."""
    b, h, s, n = x.shape
    if kind == "offset":
        view = torch.empty(x.numel() + 1, dtype=x.dtype,
                           device=x.device)[1:].view(x.shape)
    else:
        view = torch.empty((b, h, s, n + 1), dtype=x.dtype,
                           device=x.device)[..., :n]
    view.copy_(x)
    return view


def _wkv_planted(torch, r, k, v, w, u, fault: str, t0: int = 1024):
    """The plain recurrence (``rwkv6_wkv_plain``) with one fault planted
    from step ``t0``: "state zeroed" at t0 (a carry lost across a tile),
    "u dropped" from t0, or "kv decayed" with the step's own w from t0
    (S = w (S + kv))."""
    b, h, s, n = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    state = torch.zeros(b, h, n, n, device=r.device)
    ys = []
    for t in range(s):
        if fault == "state zeroed" and t == t0:
            state = torch.zeros_like(state)
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        bonus = 0.0 if fault == "u dropped" and t >= t0 else uu * kv
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, :, t], state + bonus))
        if fault == "kv decayed" and t >= t0:
            state = wf[:, :, t, :, None] * (state + kv)
        else:
            state = wf[:, :, t, :, None] * state + kv
    return torch.stack(ys, dim=2).to(r.dtype)


def phase_wkv(torch, wkv_mod):
    """rwkv6_wkv on the card against rwkv6_wkv_plain; returns the
    kernels-line entry (launches filled in later from the main path)."""
    wkv, plain = wkv_mod.rwkv6_wkv, wkv_mod.rwkv6_wkv_plain
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = {"f32": (f32, f32), "bf16": (bf16, bf16),
             "bf16, w f32": (bf16, f32)}
    for b, h, s, n in WKV_SWEEP:
        for case, (dtype, w_dtype) in cases.items():
            args = _wkv_views(torch, gen, b, h, s, n, dtype, w_dtype,
                              (0.7, 0.999))
            dname = str(dtype).split(".")[-1]
            what = f"wkv {case} B={b} H={h} S={s} N={n}"
            err = check_close(torch, wkv(*args), plain(*args), dname, what,
                              WKV_TOL[dname])
            log("wkv", f"{what}: max |err| {err:.3e}")

    # w = 0 forgets (only the step before and the bonus remain) and w = 1
    # sums every kv exactly, over 300 steps (19 tiles, the last ragged).
    # w = 1 keeps 300 steps of O(1) kv terms: outputs of O(100) whose f32
    # rounding is the prefill shape's kind, so it is held to
    # WKV_PREFILL_TOL; w = 0 to the sweep's WKV_TOL.
    for decay in (0.0, 1.0):
        for case, (dtype, w_dtype) in cases.items():
            args = _wkv_views(torch, gen, 2, 40, 300, 64, dtype, w_dtype,
                              decay)
            dname = str(dtype).split(".")[-1]
            tol = (WKV_PREFILL_TOL if decay == 1.0 else WKV_TOL)[dname]
            what = f"wkv {case} B=2 H=40 S=300 N=64, w = {decay:g}"
            err = check_close(torch, wkv(*args), plain(*args), dname, what,
                              tol)
            log("wkv", f"{what}: max |err| {err:.3e} ({tol})")

    # Views the tile copies cannot address (a base 2 or 4 bytes off, rows
    # N + 1 elements apart): the wrapper copies each into a dense tensor,
    # one copy per input, and the result is the plain one.
    for n in (4, 64):
        for case, (dtype, w_dtype) in cases.items():
            for kind in ("offset", "odd stride"):
                *dense, u = _wkv_views(torch, gen, 2, 3, 37, n, dtype,
                                       w_dtype, (0.7, 0.999))
                views = [_unaddressable(torch, t, kind) for t in dense]
                dname = str(dtype).split(".")[-1]
                what = f"wkv {case} B=2 H=3 S=37 N={n}, {kind} views"
                copies = wkv.copies
                err = check_close(torch, wkv(*views, u), plain(*views, u),
                                  dname, what, WKV_TOL[dname])
                if wkv.copies != copies + 4:
                    raise AssertionError(f"{what}: the wrapper copied "
                                         f"{wkv.copies - copies} inputs; "
                                         f"expected 4")
                log("wkv", f"{what}: 4 inputs copied, max |err| {err:.3e}")

    b, h, s, n = (WKV_PREFILL[x] for x in ("b", "h", "s", "n"))
    copies = wkv.copies
    worst = 0.0
    for decay in ((0.7, 0.999), WKV_INIT_DECAY):
        dlabel = (f"w ~ U{list(decay)}" if isinstance(decay, tuple)
                  else f"w = {decay:.5f}")
        args = _wkv_views(torch, gen, b, h, s, n, f32, f32, decay)
        err = check_close(torch, wkv(*args), plain(*args), "float32",
                          f"wkv f32 at the prefill shape, {dlabel}",
                          WKV_PREFILL_TOL["float32"])
        log("wkv", f"prefill shape f32, {dlabel}: max |err| {err:.3e} "
            f"({WKV_PREFILL_TOL['float32']})")
        r, k, v, w, u = args
        args = (r.to(bf16), k.to(bf16), v.to(bf16), w, u)
        del r, k, v
        got = wkv(*args)
        if not got.transpose(1, 2).is_contiguous():
            raise AssertionError("wkv output is not laid out like r")
        want = plain(*args)
        tol = WKV_PREFILL_TOL["bfloat16"]
        err = check_close(torch, got, want, "bfloat16",
                          f"wkv bf16 (w f32) at the prefill shape, {dlabel}",
                          tol)
        worst = max(worst, err)
        log("wkv", f"prefill shape bf16 (w f32), {dlabel}: max |err| "
            f"{err:.3e} ({tol}); mean |y| "
            f"{float(want.float().abs().mean()):.4f}"
            f", max |y| {float(want.float().abs().max()):.2f}")
        del got
        for fault in ("state zeroed", "u dropped", "kv decayed"):
            bad = _wkv_planted(torch, *args, fault)
            ferr = max_err(torch, bad, want)
            if torch.allclose(bad.float(), want.float(), **tol):
                raise AssertionError(f"planted wkv fault passes the prefill-"
                                     f"shape tolerance ({fault} from step "
                                     f"1024, {dlabel}: max |err| {ferr:.3e})")
            log("wkv", f"planted fault ({fault} from step 1024, {dlabel}): "
                f"max |err| {ferr:.3e}, caught by {tol}")
            del bad
        del want

    # The prefill shape's views (the model's) are addressed as they are:
    # at N = 64 the kernel copies its tiles by TMA only (a map the driver
    # refuses raises), and the wrapper copied none of them.
    if wkv.copies != copies:
        raise AssertionError(f"the prefill shape's views took "
                             f"{wkv.copies - copies} copies; expected none")
    log("wkv", "prefill shape: the views went to the kernel uncopied, "
        "tiles by TMA")

    # Timed in the model's dtypes (bf16 r, k, v, y; f32 w) at the init
    # decay; the kernel's work does not depend on the values.
    ms = time_ms(torch, lambda: wkv(*args), reps=10)
    plain_ms = time_ms(torch, lambda: plain(*args), reps=2, warmup=1)
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + args[0].numel() * args[0].element_size()
    # What the function needs per (b, h, step): y = rᵀS + (Σ_n r u k) v
    # is 2N² + 5N (the bonus term is a dot product, O(N)), and the update
    # S = w ⊙ S + k vᵀ is 3N²; the bound counts the function's work.
    flop = b * h * s * (5 * n * n + 5 * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    args32 = tuple(a.float() for a in args[:4]) + (args[4],)
    ms32 = time_ms(torch, lambda: wkv(*args32), reps=10)
    log("wkv", f"prefill shape B={b} H={h} S={s} N={n}, bf16 r/k/v/y, f32 "
        f"w: kernel {ms:.4f} ms (all f32: {ms32:.4f} ms), plain "
        f"{plain_ms:.4f} ms, no one-call PyTorch equivalent; {nbytes} "
        f"bytes, {flop:.4e} FLOP, bound {bound_ms:.4f} ms ({bound_by}); "
        f"kernel at {flop / ms / 1e9:.3f} TFLOP/s")
    del args, args32
    return dict(name="rwkv6_wkv", route="cuda",
                source="src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
                replaces="src/repro/kernels/rwkv6_wkv.py:47",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def own_fan_in_factors(model) -> dict:
    """For each stacked layer leaf that the initializer draws at the
    layer count's fan-in, the factor that takes it to its own fan-in.
    The reference's initializer (src/repro/models/params.py:44, copied by
    the port) takes fan_in = shape[0]; once the layers are stacked,
    shape[0] is the layer count, so a (L, ..., d_in, d_out) matrix with
    the default scale is drawn at std 1/sqrt(L), not 1/sqrt(d_in)
    (ROADMAP Queue C). Its own fan-in is shape[-2]: d_in of a (L, d_in,
    d_out) matrix and of a (L, E, d_in, d_out) expert stack alike; a
    stacked vector (L, d) keeps the rule of its unstacked (d,), fan-in d.
    rwkv6-3b's checks run at the reference's init and phase 13 reports
    own fan-in beside them; jamba's phases 17-18 run at own fan-in, and
    so do phases 31-32 (an encoder-decoder stack's encoder leaves,
    stacked under ``encoder/layers/``, included)."""
    out = {}
    for key, d in model.defs().items():
        if (key.startswith(("layers/", "encoder/layers/"))
                and d.init == "normal" and d.scale is None):
            own = d.shape[-2] if len(d.shape) >= 3 else d.shape[-1]
            out[key] = math.sqrt(d.shape[0] / own)
    return out


def phase_lm_card_vs_cpu(torch, Transformer, get_config, arch: str,
                         phase: str):
    """Full-width ``arch`` in f32 from one CPU-drawn init: forward on the
    card (kernel) against forward on the CPU (plain). Returns the f32
    model and its CPU params for the decode phase."""
    import dataclasses

    cfg = dataclasses.replace(get_config(arch),
                              param_dtype="float32", act_dtype="float32")
    model = Transformer(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    log(phase, f"{cfg.name}: {model.count_params()} params drawn on the "
        f"CPU in {time.perf_counter() - t0:.2f} s")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 256)))
    outs = {}
    with torch.no_grad():
        for device in ("cuda", "cpu"):
            p = (params if device == "cpu"
                 else {k: v.to(device) for k, v in params.items()})
            t0 = time.perf_counter()
            logits, _ = model.forward(p, tokens.to(device))
            outs[device] = logits.cpu()
            log(phase, f"{device}: forward B=1 S=256 f32 in "
                f"{time.perf_counter() - t0:.3f} s")
            del p, logits
    got, want = outs["cuda"], outs["cpu"]
    err = max_err(torch, got, want)
    if not (torch.isfinite(got).all() and torch.allclose(got, want,
                                                         **LM_F32_TOL)):
        raise AssertionError(f"{arch} logits: card vs CPU max |err| "
                             f"{err:.3e} ({LM_F32_TOL})")
    log(phase, f"logits (1, 256, {cfg.vocab_size}) agree: max |card - cpu| "
        f"{err:.3e} ({LM_F32_TOL}); max |logit| "
        f"{float(want.abs().max()):.3f}")
    return model, params


# Planted decode faults, each planted at one step t through the data the
# step reads: called with the params and the cache just before
# ``decode_step``, a fault returns the params for that step and a
# function to apply to the cache just after it (or None).
def fault_position_skip(params, cache, t):
    """Attention: the cache's position advanced by one before step t (RoPE
    positions off by one from there, one slot left empty)."""
    cache["idx"] += 1
    return params, None


def fault_lost_slot(params, cache, t):
    """Attention: the k/v that step t wrote zeroed (a write to the wrong
    slot)."""
    def after(cache):
        for key, leaf in cache.items():
            if key.endswith(("/k", "/v")):
                leaf[:, :, t] = 0
    return params, after


def fault_decay_skipped(params, cache, t):
    """RWKV: the wkv state not decayed at step t: every layer's
    ``decay_base`` at -1e4 for that step, so w = exp(-exp(-1e4 + lora))
    = 1 exactly in f32."""
    return {k: (v.new_full(v.shape, -1e4)
                if k.endswith("/mixer/decay_base") else v)
            for k, v in params.items()}, None


def fault_stale_token_shift(params, cache, t):
    """RWKV: the time-mix shift state ``x_prev_tm`` not updated at step t
    (step t's write undone)."""
    saved = {k: v.clone() for k, v in cache.items()
             if k.endswith("/x_prev_tm")}

    def after(cache):
        for key, leaf in saved.items():
            cache[key].copy_(leaf)
    return params, after


def _stepped_logits(torch, model, params, tokens, fault=None):
    """Logits (B, S, V) of stepping ``tokens`` through ``decode_step`` on
    their device, with ``fault`` (one of the ``fault_*`` functions)
    planted at the middle step."""
    b, s = tokens.shape
    cache = model.init_cache(b, s + 1, device=tokens.device)
    steps = []
    for t in range(s):
        p, after = (fault(params, cache, t) if fault and t == s // 2
                    else (params, None))
        logits, cache = model.decode_step(p, cache, tokens[:, t])
        if after:
            after(cache)
        steps.append(logits)
    return torch.stack(steps, dim=1)


def phase_decode_vs_prefill(torch, model, params, faults: dict,
                            tol: dict | None, phase: str, note: str = "",
                            pin=None):
    """Stepped decode_step logits against forward logits, full width,
    on the card, in the model's dtype, held to ``tol``. ``faults`` maps
    a name to a ``fault_*`` function and whether the fault must break
    the tolerance in bf16 too (every fault must in f32). Every reading is
    logged before any check fails. With ``tol`` None the sound reading
    is only reported. ``pin``, when given, makes a context manager that
    is active around each stepped decode (``pinned_routes``)."""
    b, s = 2, 64
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (b, s))).cuda()
    dname = model.cfg.act_dtype
    failed = []

    def close(got, want):
        return torch.allclose(got.float(), want.float(), **tol)
    with torch.no_grad():
        fwd, _ = model.forward(params, tokens)
        with pin() if pin else contextlib.nullcontext():
            dec = _stepped_logits(torch, model, params, tokens)
        diff = (dec.float() - fwd.float()).abs()
        err, mean = float(diff.max()), float(diff.mean())
        err0, err_rest = float(diff[:, 0].max()), float(diff[:, 1:].max())
        agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
        log(phase, f"{dname} B={b} S={s}{note}: decode vs forward logits "
            f"max |err| {err:.4e} ({tol or 'reported, not checked'}; step "
            f"0 {err0:.4e}, steps 1.. {err_rest:.4e}), mean |err| "
            f"{mean:.4e}, argmax agrees at {100 * agree:.1f}% of "
            f"positions; max |logit| {float(fwd.float().abs().max()):.3f}")
        if tol is None:
            return
        if not torch.isfinite(dec).all() or not close(dec, fwd):
            failed.append(f"sound decode, max |err| {err:.3e}")
        for name, (fault, in_bf16) in faults.items():
            must = dname == "float32" or in_bf16
            with pin() if pin else contextlib.nullcontext():
                bad = _stepped_logits(torch, model, params, tokens, fault)
            bdiff = (bad.float() - fwd.float()).abs()[:, s // 2:]
            berr = float(bdiff.max())
            caught = not close(bad, fwd)
            if must and not caught:
                failed.append(f"planted fault ({name}) passes, max |err| "
                              f"{berr:.3e}")
            log(phase, f"{dname} planted fault ({name} at step {s // 2}): "
                f"max |err| {berr:.4e}, mean |err| "
                f"{float(bdiff.mean()):.4e} over the steps from it; "
                f"{'caught' if caught else 'not caught'}"
                f"{'' if must else ' (not required)'} by {tol}")
    if failed:
        raise AssertionError(f"decode vs prefill ({dname}, {tol}): "
                             + "; ".join(failed))


def launch_counters(kernels: dict) -> dict:
    """Every count of the wrappers in ``kernels``: ``name`` -> (wrapper,
    "launches"), ``name.tc`` / ``name.simt`` -> the per-variant launch
    counts, ``name.split`` -> flash's launches with D != Dv (MLA's),
    ``name.ckpt`` -> the forward launches that stored the
    backward's checkpoints (WKV), ``name.bwd`` -> the backward launches and
    ``name.bwd_tc`` / ``name.bwd_simt`` those of each variant, and
    ``name.copies`` -> the inputs a wrapper copied before its launch,
    where a wrapper has them."""
    out = {}
    for name, fn in kernels.items():
        out[name] = (fn, "launches")
        for attr in ("launches_tc", "launches_simt", "launches_split",
                     "launches_ckpt", "launches_bwd", "launches_bwd_tc",
                     "launches_bwd_simt", "copies"):
            if hasattr(fn, attr):
                out[f"{name}.{attr.removeprefix('launches_')}"] = (fn, attr)
    return out


def phase_serve(torch, model, params, serve, kernels: dict, expected: dict,
                phase: str, aux_in: dict | None = None,
                frames=None, gen_calls: int = 2):
    """The serve slice on the card: prefill B=4, S=4096 (counted), then
    greedy_generate at serve's defaults. ``kernels`` maps each kernel's
    name to its wrapper (with the ``launches`` count, and for flash the
    ``launches_tc`` and ``launches_simt`` counts of its variants, read as
    ``flash_attention.tc`` and ``flash_attention.simt``, and for WKV the
    ``copies`` of views its kernel could not address, ``rwkv6_wkv.copies``);
    the prefill must launch each kernel and variant as often as
    ``expected`` says (one not named there: never) and copy nothing.
    ``aux_in`` goes into each prefill (whisper's frames, pixtral's
    patches), ``frames`` into ``greedy_generate`` (whisper), which is
    timed over ``gen_calls`` calls. Returns the prefill's launch
    counts."""
    from repro_torch.data.tokens import TokenTaskConfig, make_token_dataset

    b, s = PREFILL["b"], PREFILL["s"]
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (b, s))).cuda()
    serve.prefill(model, params, tokens, aux_in)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters(kernels)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    last = serve.prefill(model, params, tokens, aux_in)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: getattr(fn, attr)
              for name, (fn, attr) in counters.items()}
    want = {name: expected.get(name, 0) for name in counters}
    if counts != want:
        raise AssertionError(f"prefill launched {counts}; want {want}")
    if last.shape != (b, model.cfg.vocab_size) or not torch.isfinite(
            last).all():
        raise AssertionError(f"prefill logits {tuple(last.shape)} not "
                             f"finite or misshapen")
    peak = torch.cuda.max_memory_allocated() / 2**30
    walls = [wall]
    for _ in range(2):
        t0 = time.perf_counter()
        serve.prefill(model, params, tokens, aux_in)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    extra = "".join(f", {k} {tuple(v.shape)}" for k, v in
                    (aux_in or {}).items())
    log(phase, f"{model.cfg.name} prefill B={b} S={s}{extra} bf16: "
        f"{wall:.4f} s (then {walls[1]:.4f}, {walls[2]:.4f} s) = "
        f"{b * s / wall:.1f} prefill tokens/s; launches {expected}; peak "
        f"device memory {peak:.2f} GiB; logits finite, max |logit| "
        f"{float(last.float().abs().max()):.3f}")

    batch, plen, gen = 4, 16, 32
    tok_cfg = TokenTaskConfig(vocab_size=model.cfg.vocab_size, seed=3)
    prompts = np.stack([make_token_dataset(plen, tok_cfg, client=i)
                        for i in range(batch)])
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(gen_calls):
        t0 = time.perf_counter()
        out = serve.greedy_generate(model, params, prompts, gen,
                                    frames=frames)
        dt = time.perf_counter() - t0
        rates.append(batch * (plen + gen) / dt)
    if out.shape != (batch, plen + gen) or not (
            (out >= 0) & (out < model.cfg.vocab_size)).all():
        raise AssertionError(f"greedy_generate gave {out.shape}")
    log(phase, f"greedy_generate batch {batch} prompt {plen} gen {gen}: "
        + ", ".join(f"{r:.1f} tok/s ({n} call)" for r, n in
                    zip(rates, ("first", "second")))
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card now "
        f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    for i in range(2):
        log(phase, f"seq{i}: prompt={out[i, :plen].tolist()} "
            f"gen={out[i, plen:].tolist()}")
    return counts, tokens, prompts


def phase_serve_profile(torch, model, params, serve, tokens, needle: str):
    """Where the serve slice's device time goes: one prefill, and eight
    decode steps, under torch.profiler (after the counts were read).
    ``needle`` names the prefill kernel."""
    b, s = tokens.shape
    log_profile("profile", f"one prefill B={b} S={s}", profile_device(
        torch, lambda: serve.prefill(model, params, tokens)), needle)
    cache = model.init_cache(b, 16, device="cuda")
    tok = tokens[:, 0]
    with torch.no_grad():
        model.decode_step(params, cache, tok)               # warm-up

        def steps():
            for _ in range(8):
                model.decode_step(params, cache, tok)
        log_profile("profile", f"eight decode steps B={b}",
                    profile_device(torch, steps), "nvjet", top=8)


def lm_slice(torch, Transformer, get_config, serve, arch: str,
             kernels: dict, kernel: str, needle: str, faults: dict,
             decode_tols: dict, phases: tuple, own_fan_in: bool,
             clock: "Clock", numbers: tuple,
             variant: str | None = None) -> int:
    """One LM slice on the card, full width: ``forward`` card vs CPU in
    f32; decode vs prefill in f32, then bf16 (the same init, cast), with
    the planted ``faults``; then the serve slice in bf16, its counts
    zeroed just before the prefill and read just after (one launch of
    ``kernel`` per layer, all of them of ``variant`` where it is given),
    and its profile.
    With ``own_fan_in``, decode vs prefill with the stacked matrices at
    their own fan-in is reported first (``own_fan_in_factors``).
    Each of the three phases' seconds goes to ``clock`` under its number
    in ``numbers``. Returns the launches of ``kernel`` in that prefill."""
    card_phase, decode_phase, serve_phase = phases
    model32, params_cpu = phase_lm_card_vs_cpu(torch, Transformer,
                                               get_config, arch, card_phase)
    clock.lap(f"{numbers[0]} ({card_phase})")
    model = Transformer(get_config(arch))
    factors = own_fan_in_factors(model) if own_fan_in else {}
    for m in (model32, model) if factors else ():
        dtype = getattr(torch, m.cfg.param_dtype)
        own = {k: (v.to("cuda") * factors.get(k, 1.0)).to(dtype)
               for k, v in params_cpu.items()}
        phase_decode_vs_prefill(torch, m, own, {}, None, decode_phase,
                                " at own fan-in")
        del own
    params = {k: v.to("cuda") for k, v in params_cpu.items()}
    phase_decode_vs_prefill(torch, model32, params, faults,
                            decode_tols["float32"], decode_phase)
    del params
    params = {k: v.to("cuda", torch.bfloat16) for k, v in params_cpu.items()}
    del params_cpu
    phase_decode_vs_prefill(torch, model, params, faults,
                            decode_tols["bfloat16"], decode_phase)
    clock.lap(f"{numbers[1]} ({decode_phase})")
    layers = model.cfg.num_layers
    expected = {kernel: layers}
    if variant:
        expected[f"{kernel}.{variant}"] = layers
    counts, tokens, _ = phase_serve(torch, model, params, serve, kernels,
                                    expected, serve_phase)
    phase_serve_profile(torch, model, params, serve, tokens, needle)
    clock.lap(f"{numbers[2]} ({serve_phase})")
    return counts[kernel]


# Phase 15's sweep: the CPU tests' shapes (tests/test_torch_selective_scan
# .py, the JAX package's sweep plus N=8 and N=16) as (B, S, D, N), and a
# ragged one at the model's 16 states (D not a multiple of a block).
SCAN_SWEEP = [(1, 16, 8, 4), (2, 64, 32, 16), (1, 128, 64, 8), (3, 24, 8, 4),
              (2, 40, 24, 8), (1, 48, 16, 16), (2, 300, 130, 16)]
# The jamba serve slice's prefill: 4 x 4096 tokens, d_inner 8192, 16
# states.
SCAN_PREFILL = dict(b=4, s=4096, d=8192, n=16)
# (abar dtype, bx/c/y dtype) of each case: all f32, all bf16, and the
# model's mix.
SCAN_CASES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
              "mixed": ("float32", "bfloat16")}
# Scan at the prefill shape. f32: the kernel's FMA recurrence and the
# plain version's separately rounded multiply and add differ by an ulp of
# h per step; a state that remembers ~1000 steps (abar up to 0.999)
# carries that along to outputs of |y| up to ~100. bf16 (bx, c, y bf16;
# abar f32, as the model runs it): both compute in f32 and round once;
# they differ by at most one bf16 ulp (<= 2^-7 relative), where their f32
# values straddle a rounding boundary: rtol allows two ulps, and atol
# 1e-2 covers outputs near 0. Phase 15 shows that three planted faults
# from step 1024 break this tolerance.
SCAN_PREFILL_TOL = {"float32": dict(atol=2e-3, rtol=1e-4),
                    "bfloat16": dict(atol=1e-2, rtol=1.6e-2)}
# jamba's one period in f32, card vs CPU, block by block at own fan-in
# (phase 16), and decode vs prefill (phase 17): both sides full f32 with
# TF32 off, the sums in other orders; the same bound as the other LMs'.
JAMBA_F32_TOL = LM_F32_TOL
# jamba decode vs prefill in bf16 (phase 17), decode's experts pinned to
# the forward's: the two paths round at other places (the kernel's f32
# state vs decode's state cast to bf16 before its output einsum, as the
# JAX package does; GEMMs of M=128 vs M=2) over 8 layers. The rule of
# qwen3-0.6b's DECODE_BF16_ATOL, 16 bf16 ulps at the largest |logit|,
# at jamba's logit scale: |logit| < 8 at own fan-in (~7.2), ulp 2^-5.
JAMBA_DECODE_TOL = {"float32": JAMBA_F32_TOL,
                    "bfloat16": dict(atol=16 * 2.0 ** -5, rtol=0)}


def _scan_inputs(torch, gen, b, s, d, n, case, abar_from):
    """abar, bx and c for the scan in ``case``'s dtypes; c as a strided
    view (the model's split of x_proj's output). ``abar_from`` is a (lo,
    hi) range to draw abar from uniformly, or "own fan-in": exp(dt A)
    with A = -(1..N) (the S4D init) and dt = softplus(-4.6 + 0.6 z), the
    dt bias's init plus a projection of RMS 0.6, which is what unit-RMS
    activations give at the matrices' own fan-in (dt's median ~0.01)."""
    ta, tx = (getattr(torch, name) for name in SCAN_CASES[case])
    if abar_from == "own fan-in":
        dt = torch.nn.functional.softplus(
            -4.6 + 0.6 * torch.randn((b, s, d, 1), generator=gen,
                                     device="cuda"))
        a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda")
        abar = (dt * a).exp_()
        del dt
    else:
        lo, hi = abar_from
        abar = lo + (hi - lo) * torch.rand((b, s, d, n), generator=gen,
                                           device="cuda")
    bx = torch.randn((b, s, d, n), generator=gen, device="cuda").to(tx)
    c = torch.randn((b, s, 2 * n + 3), generator=gen,
                    device="cuda").to(tx)[..., 3 + n:]
    return abar.to(ta), bx, c


def _scan_planted(torch, abar, bx, c, fault: str, t0: int = 1024):
    """The plain scan (``selective_scan_plain``) with one fault planted at
    step ``t0``: "state reset" (h zeroed at t0, a carry lost across a
    tile), "decay skipped" (abar taken as 1 at t0), or "c one step late"
    (y_t read with c_{t-1} from t0 on)."""
    b, s, d, n = abar.shape
    h = torch.zeros(b, d, n, device=abar.device)
    y = torch.empty(b, s, d, dtype=bx.dtype, device=abar.device)
    for t in range(s):
        if fault == "state reset" and t == t0:
            h = torch.zeros_like(h)
        a = abar[:, t].float()
        if fault == "decay skipped" and t == t0:
            a = torch.ones_like(a)
        h = a * h + bx[:, t].float()
        ct = c[:, t - 1] if fault == "c one step late" and t >= t0 \
            else c[:, t]
        y[:, t] = torch.einsum("bdn,bn->bd", h, ct.float())
    return y


def phase_scan(torch, scan_mod):
    """selective_scan on the card against selective_scan_plain; returns
    the kernels-line entry (launches filled in later from the main
    path)."""
    scan, plain = scan_mod.selective_scan, scan_mod.selective_scan_plain
    gen = torch.Generator(device="cuda").manual_seed(6)
    ckpt_launches = scan.launches_ckpt
    for b, s, d, n in SCAN_SWEEP:
        for case in SCAN_CASES:
            args = _scan_inputs(torch, gen, b, s, d, n, case, (0.2, 0.99))
            dname = SCAN_CASES[case][1]
            what = f"scan {case} B={b} S={s} D={d} N={n}"
            got = scan(*args)
            if got.dtype != args[1].dtype or not got.is_contiguous():
                raise AssertionError(f"{what}: y is {got.dtype}, not laid "
                                     f"out (B, S, D) in bx's dtype")
            err = check_close(torch, got, plain(*args), dname, what)
            log("scan", f"{what}: max |err| {err:.3e}")

    b, s, d, n = (SCAN_PREFILL[x] for x in ("b", "s", "d", "n"))
    worst = 0.0
    for abar_from in ((0.8, 0.999), "own fan-in"):
        alabel = (f"abar ~ U{list(abar_from)}" if isinstance(abar_from, tuple)
                  else "abar at own fan-in")
        if isinstance(abar_from, tuple):
            args = _scan_inputs(torch, gen, b, s, d, n, "f32", abar_from)
            err = check_close(torch, scan(*args), plain(*args), "float32",
                              f"scan f32 at the prefill shape, {alabel}",
                              SCAN_PREFILL_TOL["float32"])
            ms32 = time_ms(torch, lambda: scan(*args), reps=5, warmup=1)
            log("scan", f"prefill shape f32, {alabel}: max |err| {err:.3e} "
                f"({SCAN_PREFILL_TOL['float32']}); kernel {ms32:.4f} ms")
            abar, bx, c = args
            args = (abar, bx.to(torch.bfloat16), c.to(torch.bfloat16))
            del bx, c
        else:
            args = _scan_inputs(torch, gen, b, s, d, n, "mixed", abar_from)
        inside = float(((args[0] > 0.01) & (args[0] < 0.99)).float().mean())
        got = scan(*args)
        want = plain(*args)
        tol = SCAN_PREFILL_TOL["bfloat16"]
        err = check_close(torch, got, want, "bfloat16",
                          f"scan mixed at the prefill shape, {alabel}", tol)
        worst = max(worst, err)
        log("scan", f"prefill shape mixed (abar f32, bx/c/y bf16), {alabel} "
            f"({100 * inside:.2f}% of abar in (0.01, 0.99)): max |err| "
            f"{err:.3e} ({tol}); mean |y| "
            f"{float(want.float().abs().mean()):.4f}, max |y| "
            f"{float(want.float().abs().max()):.2f}")
        del got
        for fault in ("state reset", "decay skipped", "c one step late"):
            bad = _scan_planted(torch, *args, fault)
            ferr = max_err(torch, bad, want)
            if torch.allclose(bad.float(), want.float(), **tol):
                raise AssertionError(f"planted scan fault passes the "
                                     f"prefill-shape tolerance ({fault} at "
                                     f"step 1024, {alabel}: max |err| "
                                     f"{ferr:.3e})")
            log("scan", f"planted fault ({fault} at step 1024, {alabel}): "
                f"max |err| {ferr:.3e}, caught by {tol}")
            del bad
        del want
        if abar_from != "own fan-in":
            del args

    # Timed in the model's dtypes at the own-fan-in abar; the kernel's
    # work does not depend on the values.
    ms = time_ms(torch, lambda: scan(*args), reps=10)
    plain_ms = time_ms(torch, lambda: plain(*args), reps=2, warmup=1)
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + b * s * d * args[1].element_size()
    flop = 4 * b * s * d * n        # one FMA of the update, one of y
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log("scan", f"prefill shape B={b} S={s} D={d} N={n}, abar f32, bx/c/y "
        f"bf16: kernel {ms:.4f} ms (all f32: {ms32:.4f} ms), plain "
        f"{plain_ms:.4f} ms, no one-call PyTorch equivalent; {nbytes} "
        f"bytes, {flop:.4e} FLOP, bound {bound_ms:.4f} ms ({bound_by}); "
        f"kernel at {nbytes / ms / 1e6:.1f} GB/s")
    del args
    # Serving (no grad) launches the instantiation without the backward's
    # checkpoint stores.
    if scan.launches_ckpt != ckpt_launches:
        raise AssertionError(f"the serving scan stored checkpoints in "
                             f"{scan.launches_ckpt - ckpt_launches} "
                             f"launches")
    log("scan", "no launch stored the backward's checkpoints")
    return dict(name="selective_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/selective_scan.cu",
                replaces="src/repro/kernels/selective_scan.py:42",
                launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


class Recorder:
    """While active, wraps ``module.name`` to hand each call's arguments,
    keyword arguments and result to ``seen``, and returns ``seen``'s
    return value in the result's place when that is not None (the
    function is looked up on the module at each call, so the model's own
    calls go through the wrapper)."""

    def __init__(self, module, name: str, seen):
        self.module, self.name, self.seen = module, name, seen

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            out = self.fn(*args, **kwargs)
            instead = self.seen(args, kwargs, out)
            return out if instead is None else instead
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def abar_share(torch, ops):
    """A Recorder of the share of abar in (0.01, 0.99) in every selective
    scan that runs while it is active: (recorder, shares), with
    ``shares`` the list of each call's share (one per Mamba layer of a
    forward; every call has the same size)."""
    shares = []

    def seen(args, kwargs, out):
        abar = args[0]
        shares.append(float(((abar > 0.01) & (abar < 0.99)).float().mean()))
    return Recorder(ops, "selective_scan_op", seen), shares


def log_shares(shares) -> tuple[float, str]:
    """(The mean share, a per-layer listing) of ``abar_share``'s list."""
    return (sum(shares) / len(shares),
            ", ".join(f"{100 * x:.2f}%" for x in shares))


def fan_in_defs(model, own: bool) -> dict:
    """The model's ParamDefs, with the stacked matrices' scales at their
    own fan-in (``own_fan_in_factors``) when ``own``. Both draw the same
    numbers from one seed: only the scale differs. (jamba's phases and
    phase 31 draw at own fan-in; phase 32 rescales the reference's draws
    to it, by the same factors.)"""
    import dataclasses
    defs = model.defs()
    if not own:
        return defs
    factors = own_fan_in_factors(model)
    return {k: dataclasses.replace(d, scale=factors[k] / math.sqrt(
        d.shape[0])) if k in factors else d for k, d in defs.items()}


def phase_jamba_blocks(torch, Transformer, cfg, phase: str):
    """jamba's one period in f32, card vs CPU, block by block (the whole
    period in f32 is 49.5 GiB of host memory): b0 (Mamba + MoE), b1
    (Mamba + MLP) and b4 (attention + MoE), each at B=1, S=256 on a
    unit-normal input, params drawn on the CPU at own fan-in, run on the
    card (kernels) and on the CPU (plain versions). The outputs must
    agree and the MoE routing must be equal."""
    import dataclasses
    from repro_torch.models import moe as moe_lib, transformer as tr
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              act_dtype="float32")
    model = Transformer(cfg)
    defs = fan_in_defs(model, own=True)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 256, cfg.d_model)).astype(np.float32))
    for j in (0, 1, 4):
        kind, is_moe = cfg.block_pattern[j], cfg.layer_is_moe(j)
        prefix = f"layers/b{j}/"
        t0 = time.perf_counter()
        params = init_params({k: d for k, d in defs.items()
                              if k.startswith(prefix)},
                             torch.Generator().manual_seed(10 + j), "cpu")
        n_params = sum(v.numel() for v in params.values())
        log(phase, f"b{j} ({kind} + {'MoE' if is_moe else 'MLP'}): "
            f"{n_params} params drawn on the CPU in "
            f"{time.perf_counter() - t0:.2f} s")
        outs, routes = {}, {}
        for device in ("cuda", "cpu"):
            p = tr._layer({k: v.to(device) for k, v in params.items()},
                          prefix, 0)
            seen = []
            with Recorder(moe_lib, "route",
                          lambda a, kw, o: seen.append(o)):
                t0 = time.perf_counter()
                with torch.no_grad():
                    y, aux = tr._apply_block(
                        cfg, kind, is_moe, p, x.to(device),
                        torch.arange(256, dtype=torch.int32, device=device))
                y = y.cpu()
                log(phase, f"b{j} {device}: B=1 S=256 f32 in "
                    f"{time.perf_counter() - t0:.3f} s")
            outs[device] = (y, None if aux is None else float(aux))
            if seen:
                probs, _, idx = seen[0]
                routes[device] = (probs.cpu(), idx.cpu())
            del p
        (got, aux_got), (want, aux_want) = outs["cuda"], outs["cpu"]
        err = max_err(torch, got, want)
        if not (torch.isfinite(got).all()
                and torch.allclose(got, want, **JAMBA_F32_TOL)):
            raise AssertionError(f"jamba b{j}: card vs CPU max |err| "
                                 f"{err:.3e} ({JAMBA_F32_TOL})")
        note = ""
        if is_moe:
            (_, idx_got), (probs, idx_want) = routes["cuda"], routes["cpu"]
            top = probs.topk(cfg.moe.top_k + 1, dim=-1).values
            margin = float((top[:, -2] - top[:, -1]).min())
            if not torch.equal(idx_got, idx_want):
                bad = int((idx_got != idx_want).any(-1).sum())
                raise AssertionError(f"jamba b{j}: MoE routing differs card "
                                     f"vs CPU at {bad} tokens (smallest "
                                     f"top-k margin {margin:.3e})")
            note = (f"; routing equal at all {idx_want.shape[0]} tokens "
                    f"(smallest top-{cfg.moe.top_k} margin {margin:.3e}); "
                    f"aux {aux_got:.6f} vs {aux_want:.6f}")
            if abs(aux_got - aux_want) > 1e-6:
                raise AssertionError(f"jamba b{j}: aux loss differs, "
                                     f"{aux_got} vs {aux_want}")
        log(phase, f"b{j} output (1, 256, {cfg.d_model}) agrees: max |card "
            f"- cpu| {err:.3e} ({JAMBA_F32_TOL}); max |y| "
            f"{float(want.abs().max()):.3f}{note}")
        del params


def fault_conv_not_shifted(params, cache, t):
    """Mamba: the conv window not shifted at step t (step t's write to
    every layer's ``conv`` undone)."""
    saved = {k: v.clone() for k, v in cache.items() if k.endswith("/conv")}

    def after(cache):
        for key, leaf in saved.items():
            cache[key].copy_(leaf)
    return params, after


def fault_state_not_decayed(params, cache, t):
    """Mamba: the SSM state not decayed at step t: every layer's ``a_log``
    at -1e4 for that step, so A = -exp(-1e4) = -0 and abar = exp(dt A)
    = 1 exactly."""
    return {k: (v.new_full(v.shape, -1e4) if k.endswith("/mixer/a_log")
                else v)
            for k, v in params.items()}, None


def route_diagnostics(torch, model, params, tokens, ops, moe_lib,
                      router_f32: bool = False) -> dict:
    """One forward and one stepped decode of ``tokens`` (B, S) with their
    MoE routes recorded. Returns ``shares`` (each Mamba layer's share of
    abar in (0.01, 0.99) in the forward), ``fwd`` and ``dec`` (per MoE
    layer, in call order: the router's probs (B, S, E) and experts (B, S,
    k) of each path), ``flips`` (n, B, S: the expert set differs between
    the two paths) and both paths' logits. With ``router_f32`` both paths
    take the router's logits from an f32 product (a diagnostic: the port,
    as the JAX package, forms them in the activations' dtype)."""
    b, s = tokens.shape
    k = model.cfg.moe.top_k

    def f32_router(args, kwargs, out):
        _, p, xt = args
        probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
        vals, idx = torch.topk(probs, k, dim=-1)
        return probs, vals / vals.sum(-1, keepdim=True).clamp(min=1e-9), idx

    def recorder(calls):
        def seen(args, kwargs, out):
            out = f32_router(args, kwargs, out) if router_f32 else out
            calls.append(out)
            return out
        return Recorder(moe_lib, "route", seen)
    rec, shares = abar_share(torch, ops)
    fwd, dec = [], []
    with rec, recorder(fwd), torch.no_grad():
        fwd_logits, _ = model.forward(params, tokens)
    with recorder(dec), torch.no_grad():
        dec_logits = _stepped_logits(torch, model, params, tokens)
    n = len(fwd)
    fwd = [(pr.reshape(b, s, -1), ix.reshape(b, s, -1)) for pr, _, ix in fwd]
    dec = [tuple(torch.stack([dec[t * n + l][i] for t in range(s)], dim=1)
                 for i in (0, 2)) for l in range(n)]
    flips = torch.stack([(fi.sort(-1).values != di.sort(-1).values).any(-1)
                         for (_, fi), (_, di) in zip(fwd, dec)])
    return dict(shares=shares, fwd=fwd, dec=dec, flips=flips,
                fwd_logits=fwd_logits, dec_logits=dec_logits)


def log_routes(torch, phase: str, label: str, diag: dict, k: int,
               moe_layers: list) -> float | None:
    """Logs, per MoE layer, the routes that differ between decode and
    forward, the forward's top-k margin (p_k - p_k+1) at each of them
    beside that layer's median margin, and the largest shift of a router
    probability between the paths there; then the decode-vs-forward
    logits error over the positions before each sequence's first
    differing route (those positions saw the same experts in every layer
    on both paths; a later position does not, since the Mamba state and
    attention carry an earlier difference forward). Returns that error
    (None when no position precedes a difference)."""
    flips = diag["flips"]
    n, b, s = flips.shape
    for l, ((pf, _), (pd, _)) in enumerate(zip(diag["fwd"], diag["dec"])):
        top = pf.topk(k + 1, dim=-1).values
        margin = top[..., k - 1] - top[..., k]
        at = flips[l]
        shift = (pd - pf).abs().amax(-1)
        where = [(int(bi), int(ti)) for bi, ti in at.nonzero()]
        listed = ", ".join(f"(b{bi}, t{ti}) {float(margin[bi, ti]):.2e}"
                           for bi, ti in where[:8])
        log(phase, f"{label}: MoE layer b{moe_layers[l]}: {len(where)} of "
            f"{b * s} routes differ; median top-{k} margin "
            f"{float(margin.median()):.3e}, largest router-prob shift "
            f"{float(shift.max()):.3e}" + (
                f"; at the differing routes margin max "
                f"{float(margin[at].max()):.3e}, shift max "
                f"{float(shift[at].max()):.3e} ({listed}"
                f"{', ...' if len(where) > 8 else ''})" if where else ""))
    any_flip = flips.any(0)                                  # (B, S)
    first = [int(any_flip[i].nonzero()[0]) if any_flip[i].any() else s
             for i in range(b)]
    diff = (diag["dec_logits"].float()
            - diag["fwd_logits"].float()).abs().amax(-1)     # (B, S)
    clean = torch.cat([diff[i, :first[i]] for i in range(b)])
    err = float(clean.max()) if clean.numel() else None
    log(phase, f"{label}: first differing route at step {first} (of {s}); "
        f"decode vs forward over the {clean.numel()} positions before it: "
        + (f"max |err| {err:.4e}" if err is not None else "none"))
    return err


def pinned_routes(torch, moe_lib, fwd: list):
    """A factory of Recorders that, in a stepped decode of the (B, S)
    tokens whose forward gave ``fwd`` (``route_diagnostics``), pin each
    MoE layer's experts at step t to the forward's at t. The gate weights
    stay decode's own router probabilities at those experts,
    renormalized, so only the discrete choice is taken from the
    forward."""
    idx = torch.stack([ix for _, ix in fwd])                # (n, B, S, k)
    n = idx.shape[0]

    def make():
        calls = []

        def seen(args, kwargs, out):
            c = len(calls)
            calls.append(c)
            probs = out[0]
            pin = idx[c % n, :, c // n]
            vals = probs.gather(-1, pin)
            return probs, vals / vals.sum(-1, keepdim=True).clamp(
                min=1e-9), pin
        return Recorder(moe_lib, "route", seen)
    return make


def phase_jamba_decode(torch, Transformer, cfg, ops, phase: str):
    """jamba decode vs prefill at full width on one period, B=2, S=64,
    capacity_factor 8.0 (no prefill drop can diverge), weights drawn on
    the card from one seed: f32 at own fan-in (checked, with two planted
    faults that must break the tolerance), f32 and bf16 at the
    reference's init (reported), then bf16 at own fan-in. In bf16 a
    route may differ between the paths (a near-tie in the router moved
    by the paths' rounding sends a token to another expert, which no
    rounding tolerance covers): there decode is checked with its experts
    pinned to the forward's (``pinned_routes``), the faults too, and,
    unpinned, over the positions before the first differing route. Logs
    the share of the model's abar in (0.01, 0.99), and the differing
    routes with their router margins (also with the router's logits in
    f32), at each init. Returns the bf16 own-fan-in params for the serve
    phase."""
    import dataclasses
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.params import init_params

    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    moe_layers = [j for j in range(cfg.num_layers) if cfg.layer_is_moe(j)]
    k = cfg.moe.top_k
    # With the experts pinned, one step's skipped decay moves bf16 logits
    # by about the rounding noise (~0.3): required in f32 only, as
    # rwkv6-3b's skipped decay.
    faults = {"conv window not shifted": (fault_conv_not_shifted, True),
              "SSM state not decayed": (fault_state_not_decayed, False)}
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64))).cuda()
    params = None
    for dname, own in (("float32", True), ("float32", False),
                       ("bfloat16", False), ("bfloat16", True)):
        model = Transformer(dataclasses.replace(
            cfg8, param_dtype=dname, act_dtype=dname))
        init = "own fan-in" if own else "the reference's init"
        label = f"{dname} at {init}"
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = init_params(fan_in_defs(model, own),
                             torch.Generator(device="cuda").manual_seed(0),
                             "cuda", getattr(torch, dname))
        torch.cuda.synchronize()
        log(phase, f"{label}: {model.count_params()} params drawn on the "
            f"card in {time.perf_counter() - t0:.2f} s")
        diag = route_diagnostics(torch, model, params, tokens, ops, moe_lib)
        inside, per_layer = log_shares(diag["shares"])
        flips = int(diag["flips"].sum())
        log(phase, f"{label}: {100 * inside:.2f}% of the model's abar in "
            f"(0.01, 0.99) (forward B=2 S=64; by Mamba layer {per_layer}); "
            f"MoE routes differing between decode and forward: {flips} of "
            f"{diag['flips'].numel()}")
        clean_err = log_routes(torch, phase, label, diag, k, moe_layers)
        if own and inside <= 0.5:
            raise AssertionError(f"{label}: half or less of the model's "
                                 f"abar lies in (0.01, 0.99)")
        if dname == "bfloat16":
            f32r = route_diagnostics(torch, model, params, tokens, ops,
                                     moe_lib, router_f32=True)
            log(phase, f"{label}, router logits in f32 (diagnostic): "
                f"{int(f32r['flips'].sum())} of {f32r['flips'].numel()} "
                f"routes differ")
            log_routes(torch, phase, f"{label}, router logits in f32",
                       f32r, k, moe_layers)
            del f32r
        if not own:
            phase_decode_vs_prefill(torch, model, params, {}, None, phase,
                                    f" at {init}")
        elif dname == "float32":
            if flips:
                raise AssertionError(f"{label}: {flips} MoE routes differ "
                                     f"between decode and forward")
            phase_decode_vs_prefill(torch, model, params, faults,
                                    JAMBA_DECODE_TOL[dname], phase,
                                    f" at {init}")
        else:
            tol = JAMBA_DECODE_TOL[dname]
            top = float(diag["fwd_logits"].float().abs().max())
            if top >= 8.0:
                raise AssertionError(f"{label}: max |logit| {top:.3f}; the "
                                     f"bf16 tolerance {tol} assumes < 8")
            if clean_err is not None and clean_err > tol["atol"]:
                raise AssertionError(f"{label}: decode vs forward before "
                                     f"the first differing route, max "
                                     f"|err| {clean_err:.3e} ({tol})")
            phase_decode_vs_prefill(
                torch, model, params, faults, tol, phase,
                f" at {init}, experts pinned to the forward's",
                pin=pinned_routes(torch, moe_lib, diag["fwd"]))
        del diag
    return params


def phase_jamba_prefill_reads(torch, model, params, serve, tokens, ops,
                              fa_mod):
    """One more jamba prefill with its selective scans and its attention
    call recorded: the share of abar in (0.01, 0.99) over the 7 Mamba
    layers must exceed one half (own fan-in), and the flash kernel's
    output on the model's own q, k, v (B=4, H=32 over Hkv=8, S=4096,
    D=128, bf16, laid out as the model passes them) must agree with
    ``flash_attention_plain`` on the same tensors to PREFILL_BF16_TOL."""
    rec, shares = abar_share(torch, ops)
    calls = []

    def seen(args, kwargs, out):
        calls.append(([a.clone() for a in args], dict(kwargs), out.clone()))
    with rec, Recorder(ops, "flash_attention_op", seen):
        serve.prefill(model, params, tokens)
    inside, per_layer = log_shares(shares)
    log("jamba-serve", f"{100 * inside:.2f}% of the model's abar in (0.01, "
        f"0.99) over the prefill's 7 Mamba layers ({per_layer})")
    if inside <= 0.5:
        raise AssertionError("at own fan-in, half or less of the prefill's "
                             "abar lies in (0.01, 0.99)")
    if len(calls) != 1:
        raise AssertionError(f"the prefill called flash_attention_op "
                             f"{len(calls)} times; want 1")
    (q, k, v), kwargs, got = calls[0]
    want_shape = tuple(JAMBA_FLASH_PREFILL[x] for x in ("b", "h", "s", "d"))
    if tuple(q.shape) != want_shape or k.shape[1] != \
            JAMBA_FLASH_PREFILL["hkv"] or got.dtype != torch.bfloat16:
        raise AssertionError(f"jamba's attention call: q {tuple(q.shape)}, "
                             f"k {tuple(k.shape)}, out {got.dtype}; want q "
                             f"{want_shape} over {JAMBA_FLASH_PREFILL['hkv']}"
                             f" KV heads in bf16")
    want = fa_mod.flash_attention_plain(q, k, v, **kwargs)
    err = check_close(torch, got, want, "bfloat16",
                      "flash on the jamba prefill's own q, k, v",
                      PREFILL_BF16_TOL)
    log("jamba-serve", f"flash on the prefill's own q {tuple(q.shape)}, k/v "
        f"{tuple(k.shape)} bf16 ({kwargs}): max |kernel - plain| {err:.3e} "
        f"({PREFILL_BF16_TOL}); mean |out| "
        f"{float(want.float().abs().mean()):.4f}")


# Phase 19: the routed strategies with the station scenarios of the JAX
# package's tests (tests/test_sim_fused.py).
ROUTED_SCENARIOS = (("fedisl", "gs"), ("fedisl_ideal", "meo"),
                    ("fedsink", "haps:2"), ("fedhap_async", "haps:2"),
                    ("fedhap_buffered", "haps:2"))
# Rounds (round family) or aggregations (cycle family) per run: at least
# two blocks of 8 each.
ROUTED_MAX_ROUNDS = 16


def count_valid(ex, method: str, valid_arg: int, counter: list) -> None:
    """Wrap ``ex.<method>`` so that each call adds the number of valid
    rounds or events it executes to ``counter[0]`` and one block to
    ``counter[1]``. ``args[valid_arg]`` is the call's valid flags, or
    the event tensor dict that holds them."""
    inner = getattr(ex, method)

    def counted(*args, **kw):
        valid = args[valid_arg]
        if isinstance(valid, dict):
            valid = valid["valid"]
        counter[0] += int(np.sum(valid))
        counter[1] += 1
        return inner(*args, **kw)
    setattr(ex, method, counted)


def phase_routed(torch, sim, fedagg_mod) -> dict:
    """Each routed strategy at full width on the card (default
    local_steps, batch and plan_block; ``max_rounds`` 16): the fedagg
    counts zeroed just before the run and read just after must show one
    launch per valid round (round family) or valid event (cycle family),
    as the executor counts them; accuracies finite and above chance.
    Returns the launch counts and timings by strategy."""
    from repro_torch.sim.strategies import CycleStrategy

    out = {}
    for strategy, stations in ROUTED_SCENARIOS:
        t0 = time.perf_counter()
        eng = sim.RoundEngine(sim.SimConfig(strategy=strategy,
                                            stations=stations,
                                            max_rounds=ROUTED_MAX_ROUNDS))
        cycle = issubclass(sim.get_strategy(strategy), CycleStrategy)
        counter = [0, 0]
        if cycle:
            count_valid(eng.executor, "cycle_block", 3, counter)
        else:
            count_valid(eng.executor, "run_block", 4, counter)
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        fedagg_mod.fedagg.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fedagg_mod.fedagg.launches
        n_valid, blocks = counter
        unit = "event" if cycle else "round"
        accs = [a for _, _, a in res.history]
        log("routed", f"{strategy}/{stations}: engine built in {build_s:.2f}"
            f" s; {res.rounds} evals, {res.history[-1][1] if accs else 0} "
            f"aggregations, {n_valid} valid {unit}s in {blocks} blocks, "
            f"{res.sim_hours:.4f} simulated h, in {wall:.3f} s: "
            f"{wall / max(n_valid, 1):.4f} s/{unit} (plan + train + fold "
            f"+ eval, the first block included); fedagg launches "
            f"{launches}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card now "
            f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
        log("routed", f"{strategy}: accuracies "
            f"{[round(a, 4) for a in accs]}")
        if blocks < 2:
            raise AssertionError(f"{strategy}: {blocks} block(s); expected "
                                 f"at least two")
        if launches != n_valid:
            raise AssertionError(f"{strategy}: fedagg launched {launches} "
                                 f"times for {n_valid} valid {unit}s; "
                                 f"expected one per {unit}")
        if not accs or not all(math.isfinite(a) for a in accs) \
                or accs[-1] <= 0.10:
            raise AssertionError(f"{strategy}: accuracies not finite or "
                                 f"not above chance: {accs}")
        out[strategy] = dict(launches=launches, valid=n_valid, unit=unit,
                             blocks=blocks, s_per_unit=wall / n_valid,
                             evals=res.rounds, sim_hours=res.sim_hours,
                             final_acc=accs[-1])
        del eng
        torch.cuda.empty_cache()
    return out


def phase_cycle_card_vs_cpu(torch, sim) -> None:
    """One ``cycle_block`` of planned fedhap_buffered events at full width
    (``local_steps=2``) on the card and on a CPU ``FusedExecutor``, from
    the same init and the same planned tensors: global params, cycle
    bases and buffer must agree to PARAM_TOL, each evaluated accuracy
    within two flipped predictions; the events hold a flush and a
    buffered, unflushed event."""
    from repro_torch.models.params import params_to_numpy, params_from_numpy
    from repro_torch.sim.strategies import FedHapBuffered

    eng = sim.RoundEngine(sim.SimConfig(strategy="fedhap_buffered",
                                        stations="haps:2", local_steps=2))
    strat = FedHapBuffered()
    K = 4
    events = strat.plan_events(eng, strat.init_plan_state(eng, 0.0), K)
    for e in events:
        e["do_eval"] = bool(e["folds"])
    ev = strat.event_tensors(eng, events, K)
    if not (ev["valid"].all() and ev["flush"].any()
            and (~ev["flush"]).any()):
        raise AssertionError(f"planned events: valid {ev['valid']}, flush "
                             f"{ev['flush']}; want {K} valid events with a "
                             f"flush and an unflushed one")
    L, B = eng.cfg.num_orbits, ev["rhos"].shape[1]
    init = params_to_numpy(eng.trainer.init(eng.cfg.seed))
    outs = {}
    for device, ex in (("cuda", eng.executor),
                       ("cpu", sim.FusedExecutor(
                           sim.LocalTrainer(eng.trainer.model,
                                            eng.cfg.learning_rate,
                                            eng.cfg.batch_size, "cpu"),
                           eng.fd, eng.eval_images, eng.eval_labels))):
        p = params_from_numpy(init, device)
        t0 = time.perf_counter()
        g, bases, buf, accs = ex.cycle_block(
            p, ex.broadcast_rows(p, L), ex.zero_rows(p, B), ev)
        if device == "cuda":
            torch.cuda.synchronize()
        outs[device] = ({"params": params_to_numpy(g),
                         "bases": params_to_numpy(bases),
                         "buffer": params_to_numpy(buf)}, accs)
        log("cycle-card-vs-cpu", f"{device}: {K} events (orbits "
            f"{ev['l'].tolist()}, flush {ev['flush'].tolist()}; "
            f"{eng.cfg.sats_per_orbit} members x {eng.cfg.local_steps} "
            f"steps + fold each) in {time.perf_counter() - t0:.3f} s, "
            f"accs {accs.tolist()}")
    worst = 0.0
    for part, want_tree in outs["cpu"][0].items():
        for k, want in want_tree.items():
            got = outs["cuda"][0][part][k]
            worst = max(worst, float(np.abs(got - want).max()))
            np.testing.assert_allclose(got, want, **PARAM_TOL,
                                       err_msg=f"{part} {k}: card vs CPU")
    n_eval = len(eng.eval_labels)
    card, cpu = outs["cuda"][1], outs["cpu"][1]
    if not np.array_equal(np.isnan(card), np.isnan(cpu)):
        raise AssertionError(f"evaluated events differ: {card} vs {cpu}")
    done = ~np.isnan(cpu)
    dacc = float(np.abs(card[done] - cpu[done]).max())
    if dacc > 2.0 / n_eval + 1e-7:
        raise AssertionError(f"card vs CPU accuracy differs by {dacc}")
    log("cycle-card-vs-cpu", f"params, bases and buffer agree: max |card - "
        f"cpu| {worst:.3e} ({PARAM_TOL}); accuracy differs by at most "
        f"{dacc:.6f}")


# Phase 21: the tick baselines with the station scenarios of the JAX
# package's tests (tests/test_sim_fused.py); max_rounds counts fedsat's
# orbit-events and fedspace's flushes, cut from 16 and 4 to keep the
# script within its time on a slow host (fedspace's flushes take 3-7 s
# each).
TICK_RUNS = (("fedsat", "gs_np", 8), ("fedspace", "gs", 2))


@contextlib.contextmanager
def recorded_folds(ex_mod, rows: list):
    """Within the block, each ``fold_stacked_tree`` call of the executor
    appends the number of rows it folds to ``rows``."""
    real = ex_mod.fold_stacked_tree

    def recorded(stacked, weights):
        rows.append(int(next(iter(stacked.values())).shape[0]))
        return real(stacked, weights)
    ex_mod.fold_stacked_tree = recorded
    try:
        yield
    finally:
        ex_mod.fold_stacked_tree = real


def phase_ticks(torch, sim, fedagg_mod) -> dict:
    """fedsat (gs_np, 8 orbit-events) and fedspace (gs, 2 flushes) at
    full width on the card with default local steps and batch: the
    fedagg counts zeroed just before each run and read just after must
    show one launch per fedsat orbit-event, folding the orbit's 8
    members, and one per fedspace flush, folding the rows buffered;
    accuracies finite and above chance. Returns the launch counts, the
    rows of each fold and the timings by strategy."""
    from repro_torch.sim import executor as ex_mod
    from repro_torch.sim.strategies import FedSpace

    out = {}
    for strategy, stations, max_rounds in TICK_RUNS:
        t0 = time.perf_counter()
        eng = sim.RoundEngine(sim.SimConfig(strategy=strategy,
                                            stations=stations,
                                            max_rounds=max_rounds))
        build_s = time.perf_counter() - t0
        rows = []
        torch.cuda.reset_peak_memory_stats()
        with recorded_folds(ex_mod, rows):
            fedagg_mod.fedagg.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fedagg_mod.fedagg.launches
        accs = [a for _, _, a in res.history]
        events = res.history[-1][1] if accs else 0
        if strategy == "fedsat":
            unit, units = "orbit-event", "orbit-events"
            ok_rows = rows == [eng.cfg.sats_per_orbit] * events
        else:
            unit, units = "flush", "flushes"
            flush = FedSpace()._flush_size(eng)
            ok_rows = len(rows) == events and all(r >= flush for r in rows)
        log("ticks", f"{strategy}/{stations}: engine built in {build_s:.2f} "
            f"s; {res.rounds} evals, {events} {units}, {res.sim_hours:.4f} "
            f"simulated h, in {wall:.3f} s: {wall / max(events, 1):.4f} "
            f"s/{unit} (plan + train + fold + eval, the first tick "
            f"included); fedagg launches {launches}, rows per fold {rows}; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card now "
            f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
        log("ticks", f"{strategy}: accuracies {[round(a, 4) for a in accs]}")
        # A fedsat tick adds one event per visited orbit, so its run may
        # end past max_rounds.
        if events < max_rounds or launches != events or not ok_rows:
            raise AssertionError(f"{strategy}: {launches} fedagg launches "
                                 f"folding {rows} rows for {events} "
                                 f"{units} (max_rounds {max_rounds}); "
                                 f"expected one launch per {unit}")
        if not all(math.isfinite(a) for a in accs) or accs[-1] <= 0.10:
            raise AssertionError(f"{strategy}: accuracies not finite or "
                                 f"not above chance: {accs}")
        out[strategy] = dict(launches=launches, events=events, unit=unit,
                             rows=rows, s_per_event=wall / events,
                             evals=res.rounds, sim_hours=res.sim_hours,
                             final_acc=accs[-1])
        del eng
        torch.cuda.empty_cache()
    return out


def phase_fold_flush(torch, fedagg_mod, leaf_shapes, s: int) -> dict:
    """The fold at a fedspace flush's S (phase 21's first flush): the
    CNN's 8 leaves, f32, timed as phase 3 times S=8."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    xs = [torch.randn((s, int(np.prod(shape))), generator=gen, device=dev)
          for shape in leaf_shapes.values()]
    return phase_fold_rows(torch, fedagg_mod.fedagg_leaves,
                           fedagg_mod.fedagg_leaves_plain, xs, gen, dev,
                           "the rows of a fedspace flush")


# Phase 22: resume at full width; events per uninterrupted run, and the
# event the cut run stops at. The executor restricts cuDNN to its
# deterministic algorithms, so a resumed run must equal the uninterrupted
# one bit for bit; with cuDNN's default algorithms (turned back on
# explicitly for two runs) two uninterrupted fedspace runs on an H100
# differ, and that run-to-run spread over SPREAD_FLUSHES flushes is
# reported beside it.
RESUME_SCENARIOS = (("fedhap", "one_hap"), ("fedspace", "gs"),
                    ("fedhap_buffered", "haps:2"))
RESUME_EVENTS, RESUME_CUT = 4, 2
SPREAD_FLUSHES = 2


def latest_arrays(directory) -> dict:
    """The arrays of the latest checkpoint in ``directory``, by key."""
    step = json.loads((directory / "latest.json").read_text())["step"]
    with np.load(directory / f"ckpt_{step:08d}.npz") as data:
        return {k: data[k] for k in data.files}


def spy_resume(eng, loaded: list) -> None:
    """Wrap ``eng.ckpt_resume`` so that each call appends what it
    returned (None: nothing resumed) to ``loaded``."""
    real = eng.ckpt_resume

    def spy(s, tree):
        out = real(s, tree)
        loaded.append(out)
        return out
    eng.ckpt_resume = spy


def phase_resume(torch, sim) -> dict:
    """For each scenario at full width with ``checkpoint_every=1`` and
    the executor's own cuDNN settings (the flag is cleared before each
    engine is built, and the executor must have set it): an
    uninterrupted run of RESUME_EVENTS events, a run cut at RESUME_CUT,
    and the cut run resumed (on the uninterrupted run's engine: the
    resume restores its rng and plane counters). The resumed history
    must equal the uninterrupted one exactly, and the final checkpoints'
    params and strategy state bit for bit. Then one checkpoint written on
    the card loads into a CPU engine, leaf for leaf, and two
    uninterrupted fedspace runs with cuDNN's default algorithms give the
    card's run-to-run spread (reported only). Returns the readings by
    strategy."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for strategy, stations in RESUME_SCENARIOS:
            full_dir = tmp / f"{strategy}-full"
            cut_dir = tmp / f"{strategy}-cut"
            cfg = dict(strategy=strategy, stations=stations)
            torch.backends.cudnn.deterministic = False
            eng = sim.RoundEngine(sim.SimConfig(max_rounds=RESUME_EVENTS,
                                                **cfg))
            eng.executor
            if not torch.backends.cudnn.deterministic \
                    or torch.backends.cudnn.benchmark:
                raise AssertionError(
                    f"{strategy}: the executor left cudnn.deterministic "
                    f"{torch.backends.cudnn.deterministic}, benchmark "
                    f"{torch.backends.cudnn.benchmark}; want True, False")
            t0 = time.perf_counter()
            full = eng.run(checkpoint_dir=full_dir, checkpoint_every=1)
            torch.cuda.synchronize()
            full_s = time.perf_counter() - t0
            cut_eng = sim.RoundEngine(sim.SimConfig(max_rounds=RESUME_CUT,
                                                    **cfg))
            cut = cut_eng.run(checkpoint_dir=cut_dir, checkpoint_every=1)
            del cut_eng
            loaded = []
            spy_resume(eng, loaded)
            t0 = time.perf_counter()
            res = eng.run(checkpoint_dir=cut_dir, resume=True,
                          checkpoint_every=1)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            n_eval = len(eng.eval_labels)
            if len(loaded) != 1 or loaded[0] is None:
                raise AssertionError(f"{strategy}: the resumed run did not "
                                     f"load the cut run's checkpoint")
            if (cut.history[-1][1] != RESUME_CUT
                    or full.history[-1][1] != RESUME_EVENTS):
                raise AssertionError(f"{strategy}: cut at "
                                     f"{cut.history[-1][1]}, uninterrupted "
                                     f"to {full.history[-1][1]} events")
            got = [(t, e) for t, e, _ in res.history]
            want = [(t, e) for t, e, _ in full.history]
            if got != want or res.sim_hours != full.sim_hours:
                raise AssertionError(f"{strategy}: resumed history {got} "
                                     f"differs from the uninterrupted "
                                     f"{want}")
            dacc = max(abs(a - b) for (_, _, a), (_, _, b)
                       in zip(res.history, full.history))
            a_full, a_res = latest_arrays(full_dir), latest_arrays(cut_dir)
            if sorted(a_full) != sorted(a_res):
                raise AssertionError(f"{strategy}: checkpoint keys differ")
            worst = max(float(np.abs(a_res[k] - want_arr).max())
                        for k, want_arr in a_full.items())
            exact = res.history == full.history and all(
                np.array_equal(a_res[k], a_full[k]) for k in a_full)
            log("resume", f"{strategy}/{stations}: uninterrupted "
                f"{RESUME_EVENTS} events in {full_s:.3f} s, cut at "
                f"{RESUME_CUT}, resumed to {res.history[-1][1]} in "
                f"{resume_s:.3f} s; times and events equal; accuracy "
                f"differs by {dacc:.6f} (of {n_eval} eval samples); final "
                f"state ({len(a_full)} leaves: "
                f"{sorted({k.split('/')[0] for k in a_full})}) max |resumed - "
                f"uninterrupted| {worst:.3e}; bit-identical: {exact}")
            if not exact:
                raise AssertionError(f"{strategy}: the resumed run is not "
                                     f"bit-identical to the uninterrupted "
                                     f"one (history equal: "
                                     f"{res.history == full.history}, max "
                                     f"|diff| of the state {worst:.3e})")
            out[strategy] = dict(max_abs_diff=worst, acc_diff=dacc,
                                 bit_identical=exact, full_s=full_s,
                                 resume_s=resume_s)
            del eng
            torch.cuda.empty_cache()

        # The card's last fedhap checkpoint into a CPU engine.
        strategy, stations = RESUME_SCENARIOS[0]
        ck_dir = tmp / f"{strategy}-cut"
        cpu = sim.RoundEngine(sim.SimConfig(
            strategy=strategy, stations=stations, device="cpu",
            max_rounds=RESUME_EVENTS))
        loaded = []
        spy_resume(cpu, loaded)
        res = cpu.run(checkpoint_dir=ck_dir, resume=True)
        arrays = latest_arrays(ck_dir)
        tree = loaded[0] if loaded else None
        if tree is None:
            raise AssertionError("the CPU engine did not load the card's "
                                 "checkpoint")
        leaves = {f"params/{k}": v for k, v in tree["params"].items()}
        if sorted(leaves) != sorted(arrays):
            raise AssertionError(f"CPU load keys {sorted(leaves)} != "
                                 f"{sorted(arrays)}")
        for k, v in leaves.items():
            if v.device.type != "cpu" or not np.array_equal(v.numpy(),
                                                            arrays[k]):
                raise AssertionError(f"{k}: the CPU engine's leaf differs "
                                     f"from the card's checkpoint")
        if res.history[-1][1] != RESUME_EVENTS:
            raise AssertionError(f"CPU engine resumed at {res.history}")
        log("resume", f"{strategy}: the card's checkpoint (events "
            f"{RESUME_EVENTS}) loads into a CPU engine leaf for leaf "
            f"({len(leaves)} leaves, bit-equal), history restored")
    out["spread_default_cudnn"] = fedspace_spread(torch, sim)
    return out


def fedspace_spread(torch, sim) -> float:
    """Max |diff| of the final params and bases of two uninterrupted
    fedspace/gs runs of SPREAD_FLUSHES flushes with cuDNN's default
    algorithms (the executor's deterministic flag cleared after it is
    built, and set again after), and whether their histories are equal
    (reported only)."""
    import tempfile

    arrays, hists = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(2):
            d = pathlib.Path(tmp) / f"run{i}"
            eng = sim.RoundEngine(sim.SimConfig(
                strategy="fedspace", stations="gs",
                max_rounds=SPREAD_FLUSHES))
            eng.executor
            torch.backends.cudnn.deterministic = False
            try:
                hists.append(eng.run(
                    checkpoint_dir=d,
                    checkpoint_every=SPREAD_FLUSHES).history)
            finally:
                torch.backends.cudnn.deterministic = True
            arrays.append(latest_arrays(d))
            del eng
    worst = max(float(np.abs(arrays[0][k] - arrays[1][k]).max())
                for k in arrays[0])
    log("resume", f"fedspace/gs, cuDNN's default algorithms, two "
        f"uninterrupted runs of {SPREAD_FLUSHES} flushes: max |diff| of "
        f"params and bases {worst:.3e}, histories equal: "
        f"{hists[0] == hists[1]} (reported only)")
    torch.cuda.empty_cache()
    return worst


# Phase 26: the sanitizer at full width, with the scenario table of the
# JAX package's tests/test_sanitize.py on the default SimConfig (paper CNN,
# 5x8 shell); max_rounds counts rounds, aggregations, fedsat's
# orbit-events (one tick visits several orbits) or fedspace's flushes.
SANITIZE_RUNS = (("fedhap", "one_hap", 2), ("fedisl", "gs", 2),
                 ("fedisl_ideal", "meo", 2), ("fedsat", "gs_np", 2),
                 ("fedspace", "gs", 2), ("fedsink", "haps:2", 2),
                 ("fedhap_async", "haps:2", 3),
                 ("fedhap_buffered", "haps:2", 2))


@contextlib.contextmanager
def patched(obj, name: str, wrap):
    """``obj.<name>`` replaced by ``wrap(original)`` within the block (a
    class keeps its own attribute's descriptor, e.g. a staticmethod)."""
    real = vars(obj)[name] if isinstance(obj, type) else getattr(obj, name)
    setattr(obj, name, wrap(getattr(obj, name)))
    try:
        yield
    finally:
        setattr(obj, name, real)


def planned_folds(sim, ex_cls, counter: list):
    """Within the block, every engine's fused loop adds the folds its plan
    calls for to ``counter[0]``: the valid rounds of each ``run_block``,
    the valid events of each ``cycle_block``, the orbits of each fedsat
    tick and one per fedspace flush; and ``sim.RoundEngine.run``'s wall
    time, bracketed by ``torch.cuda.synchronize``, to ``counter[1]``."""
    import torch

    def valid_rows(arg):
        def wrap(real):
            def counted(self, *args, **kw):
                valid = args[arg]
                counter[0] += int(np.sum(valid["valid"] if isinstance(
                    valid, dict) else valid))
                return real(self, *args, **kw)
            return counted
        return wrap

    def per_call(rows):
        def wrap(real):
            def counted(self, *args, **kw):
                counter[0] += rows(args)
                return real(self, *args, **kw)
            return counted
        return wrap

    def timed(real):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(self, *args, **kw)
            torch.cuda.synchronize()
            counter[1] += time.perf_counter() - t0
            return out
        return run

    stack = contextlib.ExitStack()
    stack.enter_context(patched(ex_cls, "run_block", valid_rows(4)))
    stack.enter_context(patched(ex_cls, "cycle_block", valid_rows(3)))
    stack.enter_context(patched(ex_cls, "fedsat_event",
                                per_call(lambda a: len(a[2]))))
    stack.enter_context(patched(ex_cls, "fedspace_flush",
                                per_call(lambda a: 1)))
    stack.enter_context(patched(sim.RoundEngine, "run", timed))
    return stack


def phase_sanitize(torch, sim, fedagg_mod) -> dict:
    """``sanitized_run`` of all 8 strategies at full width on the card
    (CUDA sync-debug mode "error" plus the dispatch guard around each
    fused loop), each against a plain run of the same config: histories
    equal exactly, ``fedagg`` launches equal to the folds the plan called
    for in both, s per fold logged for both (the guard's one-time cost,
    torch's imports at its first entry, is paid and logged before the
    runs; the phase's 17 engines load one dataset, generated once).
    Then three planted faults
    in a sanitized fedhap run must each raise: a ``float()`` of a device
    scalar inside a block, a float64 upload, and a ``.cpu()`` of the
    block's accuracies outside the explicit-transfer scope. Returns the
    readings by strategy."""
    from repro_torch.sim import engine as engine_mod

    # Every engine of this phase loads the same 70k digits (one seed, one
    # size): memoized, they are generated once, not 17 times.
    with patched(engine_mod, "load_dataset", functools.cache):
        return _sanitize_runs(torch, sim, fedagg_mod)


def _sanitize_runs(torch, sim, fedagg_mod) -> dict:
    """The body of :func:`phase_sanitize`."""
    from repro_torch.debug import (DtypePromotionError,
                                   ImplicitTransferError, sanitized,
                                   sanitized_run)

    ex_cls = sim.FusedExecutor
    t0 = time.perf_counter()
    with sanitized(device="cuda"):
        torch.ones(1, device="cuda") + 1
    log("sanitize", f"the guard's first entry (torch's dispatch-mode "
        f"imports, once per process): {time.perf_counter() - t0:.3f} s")
    out = {}
    for strategy, stations, max_rounds in SANITIZE_RUNS:
        cfg = dict(strategy=strategy, stations=stations,
                   max_rounds=max_rounds)
        readings = {}
        for mode in ("sanitized", "plain"):
            counter = [0, 0.0]
            fedagg_mod.fedagg.launches = 0
            with planned_folds(sim, ex_cls, counter):
                if mode == "sanitized":
                    res, counts = sanitized_run(cfg)
                else:
                    res = sim.RoundEngine(sim.SimConfig(**cfg)).run()
            readings[mode] = dict(launches=fedagg_mod.fedagg.launches,
                                  folds=counter[0], wall=counter[1],
                                  history=res.history,
                                  sim_hours=res.sim_hours)
            if torch.cuda.get_sync_debug_mode() != 0:
                raise AssertionError(f"{strategy}: sync-debug mode "
                                     f"{torch.cuda.get_sync_debug_mode()} "
                                     f"left on after the run")
        san, plain = readings["sanitized"], readings["plain"]
        per = {m: r["wall"] / max(r["folds"], 1) for m, r in readings.items()}
        log("sanitize", f"{strategy}/{stations}: {san['folds']} folds "
            f"planned, fedagg launches {san['launches']} sanitized / "
            f"{plain['launches']} plain; {per['sanitized']:.4f} s/fold "
            f"sanitized vs {per['plain']:.4f} plain (x"
            f"{per['sanitized'] / per['plain']:.3f}; the run, the first "
            f"block included); compile counts {counts}; histories equal: "
            f"{san['history'] == plain['history']}")
        if san["history"] != plain["history"] \
                or san["sim_hours"] != plain["sim_hours"] \
                or not san["history"]:
            raise AssertionError(f"{strategy}: the sanitized history "
                                 f"{san['history']} differs from the plain "
                                 f"{plain['history']}")
        for mode, r in readings.items():
            if r["folds"] < 1 or r["launches"] != r["folds"]:
                raise AssertionError(f"{strategy} {mode}: {r['launches']} "
                                     f"fedagg launches for {r['folds']} "
                                     f"planned folds")
        out[strategy] = dict(folds=san["folds"],
                             launches=san["launches"],
                             s_per_fold=per["sanitized"],
                             plain_s_per_fold=per["plain"])

    # Planted faults, each inside the fused loop of a sanitized fedhap run.
    eng = sim.RoundEngine(sim.SimConfig(max_rounds=1))
    eng._fused_cm = lambda: sanitized(device=eng.device)

    def reads_scalar(real):
        def acc(self, params):
            a = real(self, params)
            float(a)
            return a
        return acc

    def widens(real):
        return lambda self, x, dtype: real(
            self, x, np.float64 if dtype == np.float32 else dtype)

    def implicit_download(real):
        return staticmethod(lambda x: x.cpu().numpy())

    # (label, method, fault, the error, words its message must hold): the
    # first two are the dispatch guard's, the third the card's own
    # sync-debug mode (the guard does not see a copy).
    faults = (("float() of a device scalar", "_device_acc", reads_scalar,
               ImplicitTransferError, "device->host"),
              ("float64 upload", "_h2d", widens, DtypePromotionError,
               "float64"),
              (".cpu() outside the explicit scope", "_d2h",
               implicit_download, RuntimeError, "synchronizing"))
    for label, name, wrap, err, words in faults:
        try:
            with patched(ex_cls, name, wrap):
                eng.run()
        except err as e:
            if words not in str(e):
                raise AssertionError(f"planted {label}: raised {e!r}, not "
                                     f"the guard's error") from e
            log("sanitize", f"planted {label}: raised {type(e).__name__}: "
                f"{str(e).splitlines()[0][:160]}")
        else:
            raise AssertionError(f"planted {label}: the sanitized run did "
                                 f"not raise")
        if torch.cuda.get_sync_debug_mode() != 0:
            raise AssertionError(f"planted {label}: sync-debug mode left on")
    return out


# Phase 23's sweep as (B, H, Hkv, Sq, Sk, D, causal, window): every head
# dim, GQA groups 1, 2 and 4, causal and not, windows, Sq != Sk both ways,
# ragged lengths around the backward's 64-row tiles; the model's
# transposed (B, S, H, D) views throughout.
FLASH_BWD_SWEEP = (
    (1, 2, 2, 32, 32, 8, True, None), (2, 4, 2, 64, 64, 16, True, None),
    (1, 8, 2, 48, 48, 32, True, 7), (1, 4, 1, 100, 70, 64, False, None),
    (1, 4, 4, 70, 100, 128, True, None), (2, 8, 2, 130, 130, 128, True, 63),
    (1, 2, 1, 65, 65, 8, False, 5), (1, 8, 4, 129, 129, 64, False, None),
    (1, 16, 8, 300, 300, 128, True, None), (2, 4, 2, 1, 1, 32, True, None))
# The training slice's attention shape (phase 25: batch 2 per satellite,
# seq 1024, qwen3-0.6b's heads).
TRAIN_ATTN = dict(b=2, h=16, hkv=8, s=1024, d=128)
# The forward's log-sum-exp against the plain logsumexp: both in f32 from
# the same inputs, |lse| <= ~16 (log S plus the largest scaled score); a
# few f32 ulps, the tensor-core kernel's exp2.approx sums adding ~2^-22
# relative per term.
LSE_TOL = dict(atol=1e-5, rtol=1e-6)
# Backward kernel vs plain at the training and serve shapes in bf16. The
# plain version computes in f32 from the bf16 inputs, o and lse. The
# tensor-core kernels compute S, dP, P, Δ, dS and every sum in f32 from
# the same inputs too, but their products dV = Pᵀ·dO, dK = dSᵀ·Q and
# dQ = dS·K take P and dS as bf16 operands: each goes in as two bf16
# parts, hi = bf16(x) and lo = bf16(x − hi), which carry it to ~2^-17 of
# itself (rounded once, 2^-9, the large P of rows with few keys moves
# gradients near 0 past atol: tests/test_torch_flash_backward_tc.py
# emulates both). Both round each gradient once, so they differ by at
# most one bf16 ulp where the f32 values straddle a rounding boundary
# (rtol two ulps) plus that ~2^-17 share, atol covering gradients near 0;
# the same tolerance as PREFILL_BF16_TOL. Phase 23 shows that three
# planted faults break it.
BWD_BF16_TOL = PREFILL_BF16_TOL


def _flash_views(torch, gen, b, h, hkv, sq, sk, d, dtype):
    """q, k, v and an output gradient as the model passes them: (B, S, H,
    D) storage viewed as (B, H, S, D)."""
    return [torch.randn((b, s, n, d), generator=gen, device="cuda")
            .to(dtype).transpose(1, 2)
            for n, s in ((h, sq), (hkv, sk), (hkv, sk), (h, sq))]


def dense_bwd(torch, q, k, v, o, lse, do, fault: str | None = None):
    """Causal flash backward in dense f32 with one planted ``fault``:
    ``"gqa"`` dK and dV from only the first query head of each group (the
    group sum dropped), ``"delta"`` dS = P ⊙ dP (Δ not subtracted),
    ``"causal"`` one future key (k = q + 1) let through the mask."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(g, 1).float()
    vq = v.repeat_interleave(g, 1).float()
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = qpos + (1 if fault == "causal" else 0) >= kpos
    p = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq).mul_(scale)
    p = p.sub_(lse[..., None]).exp_().masked_fill_(~ok, 0.0)
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = torch.einsum("bhqd,bhkd->bhqk", dof, vq)
    if fault != "delta":
        ds.sub_((dof * o.float()).sum(-1, keepdim=True))
    ds.mul_(p)
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kq).mul_(scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).mul_(scale)
    del ds
    dk, dv = (x.view(b, hkv, g, sk, d) for x in (dk, dv))
    dk, dv = ((x[:, :, 0] if fault == "gqa" else x.sum(2)) for x in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def phase_flash_bwd(torch, fa_mod, fwd_prefill_ms: float,
                    ptxas: dict) -> dict:
    """Phase 23: the backward kernels against flash_attention_bwd_plain
    on the card (and the forward's lse against flash_attention_lse_plain);
    the sweep in f32 and bf16, each call's variant counted (bf16 at D >=
    16 on the tensor cores, f32 and D = 8 on the SIMT kernels), then the
    training and serve shapes in bf16 with three planted faults; timed
    beside the plain version, its bounds and SDPA's backward; ptxas'
    report of each tensor-core backward kernel (``ptxas``, from phase
    2). Returns the kernels-line entry (launches filled in from phase
    25)."""
    fa = fa_mod.flash_attention
    fwd, bwd = fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd
    bwd_plain = fa_mod.flash_attention_bwd_plain
    lse_plain = fa_mod.flash_attention_lse_plain
    gen = torch.Generator(device="cuda").manual_seed(23)
    for b, h, hkv, sq, sk, d, causal, window in FLASH_BWD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            what = (f"{dname} B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} D={d} "
                    f"causal={causal} window={window}")
            q, k, v, do = _flash_views(torch, gen, b, h, hkv, sq, sk, d,
                                       dtype)
            out, lse = fwd(q, k, v, causal, window, with_lse=True)
            lerr = check_close(torch, lse, lse_plain(q, k, causal, window),
                               "float32", f"flash lse {what}", LSE_TOL)
            counts = ("launches_bwd", "launches_bwd_tc",
                      "launches_bwd_simt")
            before = [getattr(fa, c) for c in counts]
            got = bwd(q, k, v, out, lse, do, causal, window)
            variant = fa_mod.kernel_variant(dtype, d)
            tc = variant == "tc"
            if [getattr(fa, c) for c in counts] != [
                    before[0] + 1, before[1] + tc, before[2] + (not tc)]:
                raise AssertionError(f"flash_attention_bwd {what}: did not "
                                     f"count one {variant} launch")
            if tc != (dtype == torch.bfloat16 and d >= 16):
                raise AssertionError(f"flash bwd {what}: variant {variant}")
            want = bwd_plain(q, k, v, out, lse, do, causal, window)
            errs = []
            for name, g, w, x in zip(("dq", "dk", "dv"), got, want,
                                     (q, k, v)):
                if g.stride() != x.stride() or g.dtype != x.dtype:
                    raise AssertionError(f"flash bwd {what}: {name} is not "
                                         f"laid out like its input")
                errs.append(check_close(torch, g, w, dname,
                                        f"flash bwd {name} {what}"))
            # The autograd path (FlashAttentionFn) runs the same two
            # deterministic kernels: bit-equal gradients.
            args = [x.detach().requires_grad_() for x in (q, k, v)]
            auto = torch.autograd.grad(fa(*args, causal, window), args, do)
            if not all(torch.equal(a, g) for a, g in zip(auto, got)):
                raise AssertionError(f"flash bwd {what}: autograd through "
                                     f"FlashAttentionFn differs from the "
                                     f"kernel called directly")
            log("flash-bwd", f"{what}: variant {variant}; lse max |err| "
                f"{lerr:.3e}; dq, dk, dv max |err| {errs[0]:.3e}, "
                f"{errs[1]:.3e}, {errs[2]:.3e}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = {"train": dict(TRAIN_ATTN), "serve": dict(PREFILL)}
    out_entry = {}
    for label, shape in shapes.items():
        b, h, hkv, s, d = (shape[x] for x in ("b", "h", "hkv", "s", "d"))
        what = f"{label} shape B={b} H={h} Hkv={hkv} S={s} D={d}"
        if label == "train":
            q, k, v, do = _flash_views(torch, gen, b, h, hkv, s, s, d,
                                       torch.float32)
            out, lse = fwd(q, k, v, with_lse=True)
            got, want = (bwd(q, k, v, out, lse, do),
                         bwd_plain(q, k, v, out, lse, do))
            err32 = max(check_close(torch, g, w, "float32",
                                    f"flash bwd f32 {what}")
                        for g, w in zip(got, want))
            ms32 = time_ms(torch, lambda: bwd(q, k, v, out, lse, do),
                           reps=5, warmup=1)
            log("flash-bwd", f"{what} f32: max |err| {err32:.3e} "
                f"({TOL['float32']}); kernel {ms32:.4f} ms")
            del got, want
        q, k, v, do = _flash_views(torch, gen, b, h, hkv, s, s, d,
                                   torch.bfloat16)
        out, lse = fwd(q, k, v, with_lse=True)
        lerr = check_close(torch, lse, lse_plain(q, k), "float32",
                           f"flash lse {what}", LSE_TOL)
        before = fa.launches_bwd_tc
        got = bwd(q, k, v, out, lse, do)
        if fa.launches_bwd_tc != before + 1:
            raise AssertionError(f"flash bwd bf16 {what}: not on the tensor "
                                 f"cores")
        want = bwd_plain(q, k, v, out, lse, do)
        worst = 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = check_close(torch, g, w, "bfloat16",
                              f"flash bwd {name} bf16 {what}", BWD_BF16_TOL)
            worst = max(worst, err)
            log("flash-bwd", f"{what} bf16 {name}: max |err| {err:.3e} "
                f"({BWD_BF16_TOL}); max |{name}| "
                f"{float(w.float().abs().max()):.4f}")
        del got
        # The dense copy without a fault must pass the same tolerance, so
        # that each fault below is caught for the fault alone.
        sound = dense_bwd(torch, q, k, v, out, lse, do)
        serr = max(check_close(torch, x, w, "bfloat16",
                               f"dense_bwd without a fault, {what}",
                               BWD_BF16_TOL) for x, w in zip(sound, want))
        del sound
        log("flash-bwd", f"{what}: dense_bwd without a fault max |err| "
            f"{serr:.3e}, within {BWD_BF16_TOL}")
        for fault in ("gqa", "delta", "causal"):
            bad = dense_bwd(torch, q, k, v, out, lse, do, fault)
            errs = [max_err(torch, x, w) for x, w in zip(bad, want)]
            if all(torch.allclose(x.float(), w.float(), **BWD_BF16_TOL)
                   for x, w in zip(bad, want)):
                raise AssertionError(f"planted backward fault {fault!r} "
                                     f"passes the tolerance at the {what}")
            log("flash-bwd", f"{what}: planted fault {fault!r}: dq, dk, dv "
                f"max |err| {errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e}, "
                f"caught by {BWD_BF16_TOL}")
            del bad
        del want
        big = label == "serve"
        ms = time_ms(torch, lambda: bwd(q, k, v, out, lse, do),
                     reps=3 if big else 20, warmup=1)
        dev_ms = device_ms(torch, lambda: bwd(q, k, v, out, lse, do),
                           reps=3 if big else 20, warmup=1)
        plain_ms = time_ms(torch, lambda: bwd_plain(q, k, v, out, lse, do),
                           reps=2 if big else 5, warmup=1)
        fwd_ms = time_ms(torch, lambda: fwd(q, k, v), reps=10)
        fwd_lse_ms = time_ms(torch, lambda: fwd(q, k, v, with_lse=True),
                             reps=10)
        args = [x.detach().requires_grad_() for x in (q, k, v)]
        ref_out = sdpa(*args, is_causal=True, enable_gqa=True)
        sdpa_bwd = lambda: torch.autograd.grad(                  # noqa: E731
            ref_out, args, do, retain_graph=True)
        # Back to back, autograd's host cost (~0.1-0.4 ms a call) sets
        # SDPA's time at the training shape; the device time hides it
        # (20 calls enqueue well inside device_ms's ~25 ms sleep).
        lib_ms = time_ms(torch, sdpa_bwd, reps=10)
        lib_dev = device_ms(torch, sdpa_bwd, reps=20)
        del ref_out, args
        # The function: 2.5x the forward's causal FLOP (QKᵀ again, dP, dV,
        # dK, dQ). The design: 3.5x with S and dP recomputed for dQ, 5x
        # with dV, dK and dQ each two products (P and dS as hi + lo).
        flop = 2.5 * 4 * b * h * d * s * (s + 1) / 2
        nbytes = (sum(x.numel() * x.element_size()
                      for x in (q, k, v, out, do, q, k, v))
                  + lse.numel() * 4)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        bound_recompute = 1e3 * max(t_bytes, t_ops * 3.5 / 2.5)
        bound_design = 1e3 * max(t_bytes, t_ops * 5.0 / 2.5)
        log("flash-bwd", f"{what} bf16 causal: backward kernels (tc) "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward "
            f"{lib_ms:.4f} ms (back to back with the host's cost); device "
            f"time: kernels {dev_ms:.4f} ms ({flop / dev_ms / 1e9:.2f} "
            f"TFLOP/s of the function's FLOP, {2 * flop / dev_ms / 1e9:.2f} "
            f"of the design's), sdpa backward {lib_dev:.4f} ms, "
            f"{dev_ms / lib_dev:.2f}x; {nbytes} bytes, {flop:.4e} FLOP, "
            f"bound {bound_ms:.4f} ms ({bound_by}; {bound_recompute:.4f} ms "
            f"at 3.5x with S and dP recomputed, {bound_design:.4f} ms at "
            f"the design's 5x); kernels at {bound_ms / dev_ms:.4f} of the "
            f"bound and {bound_design / dev_ms:.4f} of the design's in "
            f"device time; lse max |err| {lerr:.3e}")
        log("flash-bwd", f"{what}: forward (flash_fwd_tc) without lse "
            f"{fwd_ms:.4f} ms, with lse {fwd_lse_ms:.4f} ms"
            + (f"; phase 7's forward at this shape {fwd_prefill_ms:.4f} ms"
               if big else ""))
        out_entry[label] = dict(max_abs_err=worst, ms=ms, device_ms=dev_ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by,
                                bound_ms_recompute=bound_recompute,
                                bound_ms_design=bound_design,
                                library_ms=lib_ms,
                                library_device_ms=lib_dev, fwd_ms=fwd_ms,
                                fwd_lse_ms=fwd_lse_ms)
        del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    train = out_entry["train"]
    report = {k: v for k, v in ptxas.items()
              if k.startswith(("flash_bwd_dkdv_tc", "flash_bwd_dq_tc",
                               "flash_bwd_prep"))}
    for label, (regs, stores, loads) in report.items():
        log("flash-bwd", f"ptxas {label}: {regs} registers, {stores} bytes "
            f"spill stores, {loads} bytes spill loads")
    return dict(name="flash_attention_bwd", route="cuda", variant="tc",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention.py:87",
                launches=None, max_abs_err=max(
                    e["max_abs_err"] for e in out_entry.values()),
                ms=train["ms"], device_ms=train["device_ms"],
                plain_ms=train["plain_ms"], bound_ms=train["bound_ms"],
                bound_by=train["bound_by"],
                bound_ms_recompute=train["bound_ms_recompute"],
                bound_ms_design=train["bound_ms_design"],
                library_ms=train["library_ms"],
                library_device_ms=train["library_device_ms"],
                serve=out_entry["serve"],
                ptxas={k: dict(registers=r, spill_stores=st, spill_loads=ld)
                       for k, (r, st, ld) in report.items()})


# Phase 24: card (kernels) vs CPU (plain), f32, TF32 off. The round's
# update lr·Σ_s μ_s·g_s (lr 0.01) is far below PARAM_TOL on the params,
# and writing p - lr·g rounds it to the params' f32 spacing, so the
# params after a round cannot show a gradient error. The backward is held
# by the gradients themselves: each leaf's gradient of one satellite's
# loss, card against CPU, in relative Frobenius norm. Both sides differ
# only in the order of their f32 sums (cuBLAS and the kernels vs the
# CPU's BLAS and the plain versions; sums of up to 151,936 terms, the
# logits' gradient into the tied embedding) over 4 layers: ~1e-6, and
# TRAIN_GRAD_RTOL sits 100x above that. Phase 24 plants one backward
# fault (Δ not subtracted: the kernel given o = 0) and requires it to
# break this limit.
TRAIN_GRAD_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-5


def _train_parts():
    from repro_torch.core.dissemination import ConstellationMeshMap
    from repro_torch.core.fed_step import FedTrainConfig, stack_params
    from repro_torch.core.mesh_round import FedRoundConfig
    from repro_torch.launch import train

    def fed_cfg(n_orbits, per_orbit, local_steps, lr=0.01):
        return FedTrainConfig(
            round_cfg=FedRoundConfig(
                cmap=ConstellationMeshMap(n_orbits=n_orbits,
                                          sats_per_orbit=per_orbit),
                ship_global_echo=False),
            local_steps=local_steps, learning_rate=lr)
    return train, fed_cfg, stack_params


def _leaf_grads(torch, model, params: dict, batch: dict) -> dict:
    """Each leaf's gradient of one satellite's loss (``satellite_loss``,
    as ``single_device_round`` takes it), returned on the CPU."""
    from repro_torch.core.fed_step import satellite_loss

    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    grads = torch.autograd.grad(satellite_loss(model, p, batch),
                                list(p.values()))
    return {k: g.cpu() for k, g in zip(p, grads)}


def _grad_rel(torch, got: dict, want: dict) -> tuple[float, str]:
    """The largest per-leaf |got - want| / |want| (Frobenius), and its
    leaf."""
    rel = {k: float((got[k] - w).norm()) / max(float(w.norm()), 1e-30)
           for k, w in want.items()}
    key = max(rel, key=rel.get)
    return rel[key], key


def phase_train_card_vs_cpu(torch, Transformer, get_config, arch: str,
                            layers: int, seed: int, fault: tuple,
                            phase: str = "train-cvc") -> dict:
    """Phases 24 and 29: ``arch`` at full width cut to ``layers`` layers,
    f32, from one CPU-drawn init. Each leaf's gradient of satellite 0's
    loss on the card (the kernels forward and backward) against the CPU
    (the plain versions), then with one planted backward fault, which
    must break the limit: ``fault`` is (label, module, name, wrap), the
    kernel launcher ``module.name`` replaced by ``wrap(launcher)`` for
    one gradient. Then one round of ``single_device_round`` (2
    satellites of one orbit, both visible, batch 1 x seq 256, 1 local
    step) on both: losses and every leaf after the fold agree."""
    import dataclasses

    train, fed_cfg, stack_params = _train_parts()
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              param_dtype="float32", act_dtype="float32")
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    batches = {d: train.make_batches(cfg, 2, 1, 256, 0, cfg.vocab_size,
                                     device=d) for d in ("cuda", "cpu")}

    def sat0(device):
        return {k: v[0] for k, v in batches[device].items()}
    params_card = {k: v.to("cuda") for k, v in params.items()}
    want = _leaf_grads(torch, model, params, sat0("cpu"))
    sound, sound_key = _grad_rel(
        torch, _leaf_grads(torch, model, params_card, sat0("cuda")), want)
    if not sound <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"train card vs CPU: the gradient of "
                             f"{sound_key} differs by {sound:.3e} of its "
                             f"norm (want <= {TRAIN_GRAD_RTOL})")
    label, module, name, wrap = fault
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        bad, bad_key = _grad_rel(
            torch, _leaf_grads(torch, model, params_card, sat0("cuda")),
            want)
    finally:
        setattr(module, name, real)
    if bad <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"train card vs CPU: the planted backward "
                             f"fault ({label}) passes the gradient limit "
                             f"({bad:.3e} at {bad_key})")
    log(phase, f"{cfg.name} x {layers} layers, f32, satellite 0's loss: "
        f"each leaf's gradient, card vs CPU, within {sound:.3e} of its "
        f"norm (worst {sound_key}; limit {TRAIN_GRAD_RTOL}); planted fault "
        f"{label}: {bad:.3e} (worst {bad_key}), caught")
    del params_card
    out = _round_card_vs_cpu(torch, model, params, batches, fed_cfg(1, 2, 1),
                             train, stack_params, phase)
    return dict(grad_rel=sound, grad_rel_fault=bad, **out)


def _round_card_vs_cpu(torch, model, params: dict, batches: dict, fed,
                       train, stack_params, phase: str,
                       kernels: dict | None = None) -> dict:
    """One ``single_device_round`` (2 satellites, both visible) on the
    card and on the CPU from ``params`` (CPU tensors): losses within
    TRAIN_LOSS_RTOL and every leaf within PARAM_TOL. With ``kernels``,
    the card round's counts are zeroed just before and returned."""
    visible = np.array([True, True])
    sizes = np.ones(2, np.float32)
    out, counts = {}, None
    for device in ("cuda", "cpu"):
        stacked = stack_params({k: v.to(device) for k, v in params.items()},
                               2)
        counters = launch_counters(kernels) if kernels and \
            device == "cuda" else {}
        if device == "cuda":
            torch.cuda.synchronize()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        stacked, metrics = train.single_device_round(model, fed)(
            stacked, batches[device], sizes, visible)
        loss = float(metrics["local_loss"])
        if counters:
            counts = {n: getattr(fn, attr)
                      for n, (fn, attr) in counters.items()}
        log(phase, f"{device}: one round (2 satellites, forward + "
            f"backward, fold) in {time.perf_counter() - t0:.3f} s, loss "
            f"{loss:.6f}" + (f"; launches {counts}" if counters else ""))
        out[device] = (loss, {k: v[0].cpu() for k, v in stacked.items()})
        del stacked
    (loss, got), (want_loss, want) = out["cuda"], out["cpu"]
    if not (math.isfinite(loss) and abs(loss - want_loss)
            <= TRAIN_LOSS_RTOL * abs(want_loss)):
        raise AssertionError(f"train card vs CPU: loss {loss} vs "
                             f"{want_loss} (rtol {TRAIN_LOSS_RTOL})")
    worst = max(check_close(torch, got[k], w, "float32",
                            f"train card vs CPU leaf {k}", PARAM_TOL)
                for k, w in want.items())
    log(phase, f"one round, both satellites visible: losses agree "
        f"({loss:.6f} vs {want_loss:.6f}, rtol {TRAIN_LOSS_RTOL}); all "
        f"{len(want)} leaves within {PARAM_TOL} (max |err| {worst:.3e})")
    return dict(loss=loss, leaf_err=worst, counts=counts)


def no_delta(real):
    """Planted flash backward fault: Δ = rowsum(dO ⊙ O) taken as 0 (the
    kernel given o = 0, which only Δ reads), i.e. dS = P ⊙ dP."""
    import torch

    def bwd(q, k, v, o, lse, do, causal=True, window=None):
        return real(q, k, v, torch.zeros_like(o), lse, do, causal, window)
    return bwd


def wkv_decay_skipped(real):
    """Planted WKV backward fault: the kernel given w = 1 (and the
    forward's checkpoints), so the reverse sweep neither decays the
    adjoint nor rebuilds the decayed state."""
    def bwd(r, k, v, w, u, dy, *ckpts):
        return real(r, k, v, w.new_ones(w.shape), u, dy, *ckpts)
    return bwd


def phase_jamba_round_card_vs_cpu(torch, Transformer, get_config,
                                  kernels: dict) -> dict:
    """Phase 29: the reduced jamba-v0.1-52b (one period of 8 layers, f32)
    at own fan-in, as ``tests/_torch_jamba.py`` draws it: one
    ``single_device_round`` on the card (the Mamba mixers forward and
    backward through the scan kernels, counted) and on the CPU."""
    train, fed_cfg, stack_params = _train_parts()
    cfg = get_config("jamba-v0.1-52b").reduced()
    model = Transformer(cfg)
    from repro_torch.models.params import init_params
    params = init_params(fan_in_defs(model, own=True),
                         torch.Generator().manual_seed(29), "cpu")
    batches = {d: train.make_batches(cfg, 2, 2, 64, 0, cfg.vocab_size,
                                     device=d) for d in ("cuda", "cpu")}
    out = _round_card_vs_cpu(torch, model, params, batches,
                             fed_cfg(1, 2, 1), train, stack_params,
                             "train-cvc", kernels)
    mamba = sum(k == "mamba" for k in cfg.block_pattern)
    want = {"selective_scan": 2 * mamba, "selective_scan.ckpt": 2 * mamba,
            "selective_scan.bwd": 2 * mamba}
    got = {k: out["counts"][k] for k in want}
    if got != want:
        raise AssertionError(f"reduced jamba round launched {got}; want "
                             f"{want} ({mamba} Mamba layers x 2 "
                             f"satellites)")
    log("train-cvc", f"{cfg.name} at own fan-in: {got['selective_scan']} "
        f"scan forward launches, all {got['selective_scan.ckpt']} storing "
        f"checkpoints, and {got['selective_scan.bwd']} backward launches "
        f"in the card's round ({mamba} Mamba layers x 2 satellites)")
    return out


# Phase 25: the slice, as `python -m repro_torch.launch.train --full`
# runs it with these flags.
TRAIN_SLICE = dict(sats=4, orbits=2, seq=1024, batch_per_sat=2,
                   local_steps=2, rounds=3, visibility=0.5, seed=0)
# The LM fold (bf16 rows, f32 weights) vs fedagg_plain: both accumulate
# Σ_s w_s·x_s in f32 (the kernel by FMAs, the plain version by rounded
# products and a sum) and round once to bf16, so they differ by at most
# one bf16 ulp (<= 2^-7 relative) where their f32 values straddle a
# rounding boundary; atol covers outputs that cancel to near 0, whose f32
# sums differ by ~S·2^-24 of the largest |w·x| (~1e-7 at most here).
FOLD_BF16_TOL = dict(atol=1e-6, rtol=2.0 ** -7)
# Seeded noise added to each row before the fold is held on rows that
# differ everywhere: 0.05, above the weights' ~0.02-0.03 and ~6 bf16
# ulps of the norms' gains of 1.
FOLD_NOISE = 0.05


def _category(name: str) -> str:
    for kernel in ("flash_bwd", "flash_fwd", "wkv_bwd", "wkv_fwd"):
        if kernel in name:
            return kernel
    if "fedagg" in name:
        return "fold (fedagg)"
    if any(w in name for w in ("gemm", "nvjet", "cutlass", "Gemm", "sm90_")):
        return "GEMMs"
    return "elementwise, reductions, copies"


def lm_fold_check(torch, fedagg_mod, tree: dict, mu, got: dict,
                  gen) -> dict:
    """The LM fold held against ``fedagg_plain`` on the rows a round
    folds (``tree``, just before the fold; ``got`` is the round's fold of
    them with its μ), then, with seeded noise added to every row in place
    (the round overwrites the rows with ``got`` next), under non-uniform
    weights; a planted fault (row 0 read S times) must break the
    tolerance there."""
    plain = fedagg_mod.fedagg_leaves_plain
    flat = [x.reshape(x.shape[0], -1) for x in tree.values()]
    n = flat[0].shape[0]
    w = torch.as_tensor(np.asarray(mu, np.float32), device="cuda")
    spread = max(float((x - x[:1]).abs().max()) for x in flat)
    err = max(check_close(torch, got[k].reshape(-1), want, "bfloat16",
                          f"LM fold leaf {k} on the round's rows",
                          FOLD_BF16_TOL)
              for k, want in zip(tree, plain(flat, w)))
    for x in flat:
        x.add_(torch.randn(x.shape, generator=gen, device="cuda",
                           dtype=x.dtype), alpha=FOLD_NOISE)
    w = torch.arange(1, n + 1, dtype=torch.float32, device="cuda")
    w /= w.sum()
    wants = plain(flat, w)
    err_noise = max(check_close(torch, g, want, "bfloat16",
                                f"LM fold leaf {k} on noisy rows",
                                FOLD_BF16_TOL)
                    for k, g, want in zip(tree, fedagg_mod.fedagg_leaves(
                        flat, w), wants))
    faults = plain([x[:1].expand_as(x) for x in flat], w)
    fault = max(max_err(torch, f, want) for f, want in zip(faults, wants))
    if all(torch.allclose(f.float(), want.float(), **FOLD_BF16_TOL)
           for f, want in zip(faults, wants)):
        raise AssertionError("planted fold fault (row 0 read S times) "
                             "passes the LM fold's tolerance")
    log("train", f"LM fold on the round's own rows (rows differ by up to "
        f"{spread:.3e}), μ {[round(float(x), 4) for x in mu]}: max |err| "
        f"vs plain {err:.3e}; on rows with seeded noise {FOLD_NOISE}, μ "
        f"{[round(float(x), 4) for x in w.tolist()]}: "
        f"{err_noise:.3e}; planted fault row 0 read {n} times: "
        f"{fault:.3e}, caught by {FOLD_BF16_TOL}")
    return dict(max_abs_err=max(err, err_noise), fault=fault,
                row_spread=spread)


# Launches per satellite step of each architecture's training slice, for
# n = layers: remat runs each period's forward twice.
TRAIN_LAUNCHES = {
    "qwen3-0.6b": lambda n: {"flash_attention": 2 * n,
                             "flash_attention.tc": 2 * n,
                             "flash_attention.bwd": n,
                             "flash_attention.bwd_tc": n},
    "rwkv6-3b": lambda n: {"rwkv6_wkv": 2 * n, "rwkv6_wkv.ckpt": 2 * n,
                           "rwkv6_wkv.bwd": n},
}


def phase_train(torch, Transformer, get_config, kernels: dict,
                fedagg_mod, ops, arch: str = "qwen3-0.6b",
                phase: str = "train", needle: str = "flash_bwd") -> dict:
    """Phases 25 and 30: full-width ``arch``, bf16, remat on, federated
    training on the card: each round's counts zeroed just before and read
    just after (one ``fedagg`` launch; per satellite step the forward
    kernels twice per layer and the backward kernel once:
    ``TRAIN_LAUNCHES``; qwen3-0.6b's flash launches all on the tensor
    cores), finite losses, all rows bit-equal after each fold; s/round,
    peak memory, the card's draw and a profile of one round. For
    qwen3-0.6b also the LM fold timed and checked, and a checkpoint
    written and loaded back bit for bit."""
    import tempfile

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    train, fed_cfg, stack_params = _train_parts()
    c = TRAIN_SLICE
    cfg = get_config(arch)
    model = Transformer(cfg)
    n_sats, steps = c["sats"], c["local_steps"]
    fed = fed_cfg(c["orbits"], n_sats // c["orbits"], steps)
    params = stack_params(model.init(
        torch.Generator(device="cuda").manual_seed(c["seed"]), "cuda"),
        n_sats)
    n_params = model.count_params()
    log(phase, f"{cfg.name}: {n_params} params x {n_sats} satellites in "
        f"{cfg.param_dtype}, remat={cfg.remat}, seq {c['seq']}, batch "
        f"{c['batch_per_sat']} per satellite, {steps} local steps, lr "
        f"{fed.learning_rate}")
    step = train.single_device_round(model, fed)
    sizes = np.ones(n_sats, np.float32)
    rng = np.random.default_rng(c["seed"])
    counters = launch_counters(kernels)
    sat_steps = n_sats * steps
    layers = cfg.num_layers
    want = {name: 0 for name in counters}
    want["fedagg"] = 1
    want.update(TRAIN_LAUNCHES[arch](layers * sat_steps))
    totals = {name: 0 for name in counters}
    walls, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for rnd in range(c["rounds"]):
        batch = train.make_batches(cfg, n_sats, c["batch_per_sat"], c["seq"],
                                   rnd, cfg.vocab_size, device="cuda")
        visible = train._ensure_coverage(rng, fed.round_cfg.cmap,
                                         c["visibility"])
        torch.cuda.synchronize()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        params, metrics = step(params, batch, sizes, visible)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = {name: getattr(fn, attr)
                  for name, (fn, attr) in counters.items()}
        if counts != want:
            raise AssertionError(f"train round {rnd} launched {counts}; "
                                 f"want {want}")
        for name in totals:
            totals[name] += counts[name]
        loss = float(metrics["local_loss"])
        losses.append(loss)
        if not math.isfinite(loss):
            raise AssertionError(f"{phase} round {rnd}: loss {loss}")
        for key, leaf in params.items():
            if not all(torch.equal(leaf[s], leaf[0])
                       for s in range(1, n_sats)):
                raise AssertionError(f"{phase} round {rnd}: rows of {key} "
                                     f"differ after the fold")
        log(phase, f"round {rnd}: loss {loss:.4f}, {walls[-1]:.3f} s, "
            f"visible {visible.astype(int).tolist()}; rows bit-equal after "
            f"the fold; launches {counts}")
    tokens = n_sats * steps * c["batch_per_sat"] * c["seq"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    draw = nvidia_smi('clocks.sm,power.draw,temperature.gpu')
    log(phase, f"s/round {', '.join(f'{w:.4f}' for w in walls)} "
        f"({tokens / walls[-1]:.1f} trained tokens/s in the last round); "
        f"peak device memory {peak:.2f} GiB; card now {draw}")

    # Where one round's device time goes (after the counts were read).
    prof = profile_device(torch, lambda: step(params, batch, sizes, visible))
    log_profile(phase, "one round", prof, needle, top=10,
                also=("wkv_fwd",) if needle == "wkv_bwd" else ())
    by_cat: dict[str, float] = {}
    for name, (us, _) in prof[0].items():
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + us
    total = sum(by_cat.values())
    if total:
        log(phase, "split of one round's device time: " + ", ".join(
            f"{k} {v / 1e3:.1f} ms ({100 * v / total:.1f}%)"
            for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])))
    if arch != "qwen3-0.6b":
        del params, batch
        torch.cuda.empty_cache()
        return dict(launches=totals, losses=losses, s_per_round=walls,
                    tokens_per_s=tokens / walls[-1], peak_gib=peak,
                    card=draw)

    # The LM fold (S=4, bf16), as phase 3 times the CNN's.
    mu = train._mu_weights(visible, sizes, fed.round_cfg.cmap, "paper",
                           "paper")
    w = torch.as_tensor(mu, device="cuda")
    fold = lambda: ops.fedagg_tree(params, mu)                  # noqa: E731
    flat = [x.view(n_sats, -1) for x in params.values()]
    wb = w.to(torch.bfloat16)
    mv = lambda: [torch.mv(x.t(), wb) for x in flat]            # noqa: E731
    nbytes = sum((n_sats + 1) * x.shape[1] * 2 for x in flat) + n_sats * 4
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    fold_ms, fold_dev = time_ms(torch, fold), device_ms(torch, fold, reps=20)
    lib_ms, lib_dev = time_ms(torch, mv), device_ms(torch, mv, reps=20)
    plain = fedagg_mod.fedagg_leaves_plain
    plain_ms = time_ms(torch, lambda: plain(flat, w), reps=5, warmup=1)
    n_p = sum(x.shape[1] for x in flat)
    log("train", f"LM fold, S={n_sats}, bf16, P={n_p} in {len(flat)} "
        f"leaves: {nbytes} bytes, bound {bound_ms:.4f} ms (bytes); device "
        f"time: kernel {fold_dev:.4f} ms ({bound_ms / fold_dev:.3f} of its "
        f"bound), torch.mv per leaf {lib_dev:.4f} ms; back to back "
        f"with the host's cost: kernel {fold_ms:.4f} ms, torch.mv per leaf "
        f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms")
    del flat

    # One more round, its fold held on the rows it folds (not counted:
    # the check launches the kernel again).
    real_tree = ops.fedagg_tree
    held = []

    def spy(tree, weights):
        got = real_tree(tree, weights)
        held.append(lm_fold_check(torch, fedagg_mod, tree, weights, got,
                                  torch.Generator(device="cuda")
                                  .manual_seed(25)))
        return got
    ops.fedagg_tree = spy
    try:
        params, _ = step(params, batch, sizes, visible)
    finally:
        ops.fedagg_tree = real_tree
    if len(held) != 1:
        raise AssertionError(f"the check round folded {len(held)} times")
    check = held[0]
    for key, leaf in params.items():
        if not all(torch.equal(leaf[s], leaf[0]) for s in range(1, n_sats)):
            raise AssertionError(f"check round: rows of {key} differ after "
                                 f"the fold")

    # The checkpoint of row 0, written and loaded back bit for bit.
    row0 = {k: x[0] for k, x in params.items()}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_checkpoint(tmp, row0, c["rounds"], {"arch": cfg.name})
        t_save = time.perf_counter() - t0
        loaded, manifest = load_checkpoint(tmp, row0)
        if manifest["step"] != c["rounds"] or not all(
                loaded[k].dtype == v.dtype and torch.equal(loaded[k], v)
                for k, v in row0.items()):
            raise AssertionError("train checkpoint did not load back bit "
                                 "for bit")
    log("train", f"checkpoint of row 0 ({len(row0)} leaves, "
        f"{sum(v.numel() * v.element_size() for v in row0.values())} "
        f"bytes) written in {t_save:.2f} s and loaded back bit for bit")
    del params, row0, loaded
    torch.cuda.empty_cache()
    return dict(launches=totals, losses=losses, s_per_round=walls,
                fold=dict(S=n_sats, dtype="bfloat16", device_ms=fold_dev,
                          ms=fold_ms, bound_ms=bound_ms, plain_ms=plain_ms,
                          library_ms=lib_ms, library_device_ms=lib_dev,
                          **check))


# Phases 27-28: the recurrences' backward kernels against their plain
# versions on the card. Each gradient is held to its plain version by
# max |kernel - plain| <= BWD_REL[dtype] * max |plain|, the largest
# difference against the gradient's own scale (sums over up to 4096 steps
# grow with the sequence, so an absolute tolerance would not carry over
# shapes). f32: both compute the same f32 sums in other orders (the
# kernel with FMAs, the checkpointed state rebuilt), a few ulps of the
# largest term; the CPU tests measure ~3e-7 of the largest gradient and
# the card tests hold 1e-5. bf16 outputs: both compute in f32 and round
# once, so they differ by at most one bf16 ulp of an element, <= 2^-7 of
# the largest, where their f32 values straddle a rounding boundary; two
# ulps allowed. The planted faults (below) must break these.
BWD_REL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
# Phase 27's sweep (B, H, S, N): every head size, ragged lengths around
# the kernel's 16-step checkpoints (1, 15, 17 at N = 64), and 300 steps
# at the model's 40 heads of 64; the training slice's shape and the
# serve prefill's.
WKV_BWD_SWEEP = [(1, 1, 16, 4), (2, 3, 37, 8), (1, 4, 32, 16),
                 (2, 2, 48, 32), (1, 2, 40, 64), (2, 40, 300, 64),
                 (1, 2, 1, 64), (2, 2, 15, 64), (2, 2, 17, 64)]
WKV_TRAIN = dict(b=2, h=40, s=1024, n=64)
# Phase 28's sweep is SCAN_SWEEP; jamba's training shape.
SCAN_TRAIN = dict(b=2, s=1024, d=8192, n=16)
# A full-width jamba Mamba block's gradients, kernels vs plain on the
# card, bf16 (phase 28): the two paths differ where the scan's outputs
# and gradients round to bf16 on either side of a boundary (one bf16 ulp,
# 2^-8 relative, at a few elements), and the bf16 GEMMs downstream carry
# that along; relative Frobenius norm per leaf.
MAMBA_GRAD_RTOL = 1e-2


def check_grads(torch, got, want, what: str, names) -> dict:
    """Each gradient within BWD_REL[its dtype] of the plain one's largest
    value; returns {name: max |err| / max |plain|}."""
    out = {}
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} {name}: {tuple(g.shape)} {g.dtype}"
                                 f" vs plain {tuple(w.shape)} {w.dtype}")
        rel = max_err(torch, g, w) / max(float(w.float().abs().max()),
                                         1e-30)
        lim = BWD_REL[str(w.dtype).split(".")[-1]]
        if not (torch.isfinite(g).all() and rel <= lim):
            raise AssertionError(f"{what} {name}: kernel vs plain "
                                 f"{rel:.3e} of the largest gradient "
                                 f"(limit {lim:.3e})")
        out[name] = rel
    return out


def breaks(torch, bad, want, names) -> dict:
    """The relative error of a planted fault per gradient, and whether
    any gradient breaks its limit."""
    rel = {n: max_err(torch, b, w) / max(float(w.float().abs().max()),
                                         1e-30)
           for n, b, w in zip(names, bad, want)}
    caught = any(rel[n] > BWD_REL[str(w.dtype).split(".")[-1]]
                 for n, w in zip(names, want))
    return rel, caught


def _wkv_bwd_planted(torch, r, k, v, w, u, dy, fault: str):
    """``rwkv6_wkv_bwd_plain`` with one fault planted: "adjoint decay
    skipped" (G_{t-1} = G_t + r_t dy_tᵀ) or "dw from S_t" (the state
    after the step instead of before it)."""
    b, h, s, n = r.shape
    rf, kf, vf, wf, dyf = (a.float() for a in (r, k, v, w, dy))
    uu = u.float()[None]
    states = torch.empty(s + 1, b, h, n, n, device=r.device)
    states[0] = 0
    for t in range(s):
        states[t + 1] = (wf[:, :, t, :, None] * states[t]
                         + kf[:, :, t, :, None] * vf[:, :, t, None, :])
    vdy = (vf * dyf).sum(-1, keepdim=True)
    bonus = (rf * uu[:, :, None] * kf).sum(-1, keepdim=True)
    dr, dk, dv, dw = (torch.empty(b, h, s, n, device=r.device)
                      for _ in range(4))
    g = torch.zeros(b, h, n, n, device=r.device)
    for t in reversed(range(s)):
        prev, dyt = states[t], dyf[:, :, t]
        dr[:, :, t] = (torch.einsum("bhnm,bhm->bhn", prev, dyt)
                       + uu * kf[:, :, t] * vdy[:, :, t])
        dk[:, :, t] = (torch.einsum("bhnm,bhm->bhn", g, vf[:, :, t])
                       + uu * rf[:, :, t] * vdy[:, :, t])
        dv[:, :, t] = (torch.einsum("bhnm,bhn->bhm", g, kf[:, :, t])
                       + bonus[:, :, t] * dyt)
        dw[:, :, t] = (g * (states[t + 1] if fault == "dw from S_t"
                            else prev)).sum(-1)
        decay = 1.0 if fault == "adjoint decay skipped" \
            else wf[:, :, t, :, None]
        g = decay * g + rf[:, :, t, :, None] * dyt[:, :, None, :]
    du = (rf * kf * vdy).sum((0, 2))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du)


def _bwd_timing(torch, bwd, args, plain, flop: float, nbytes: int,
                what: str, phase: str, plain_reps: int = 2) -> dict:
    """The backward back to back (``ms``) and as device time, its plain
    version, and the bound."""
    ms = time_ms(torch, lambda: bwd(*args), reps=10)
    dev = device_ms(torch, lambda: bwd(*args), reps=10)
    plain_ms = (time_ms(torch, lambda: plain(*args), reps=plain_reps,
                        warmup=1) if plain else None)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(phase, f"{what}: device {dev:.4f} ms, back to back {ms:.4f} ms"
        + (f", plain {plain_ms:.4f} ms" if plain_ms is not None else "")
        + f"; {nbytes} bytes, {flop:.4e} FLOP, bound {bound_ms:.4f} ms "
        f"({bound_by}): {bound_ms / dev:.3f} of it; no one-call PyTorch "
        f"equivalent")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _fwd_times(torch, serve, stores, what: str, phase: str) -> dict:
    """A recurrence's checkpointing forward (``stores``) against its
    serving forward, device time, in turns (serving, checkpointing,
    checkpointing, serving); the less of each pair."""
    ms = [device_ms(torch, f, reps=20) for f in (serve, stores, stores,
                                                 serve)]
    serve_ms, ckpt_ms = min(ms[0], ms[3]), min(ms[1], ms[2])
    log(phase, f"{what}: forward device time {ms[0]:.4f} / {ms[3]:.4f} ms "
        f"serving, {ms[1]:.4f} / {ms[2]:.4f} ms with the checkpoint stores "
        f"(+{ckpt_ms - serve_ms:.4f})")
    return dict(fwd_device_ms=serve_ms, fwd_ckpt_device_ms=ckpt_ms)


def phase_wkv_bwd(torch, wkv_mod, ptxas: dict) -> dict:
    """Phase 27: the checkpointing forward (``rwkv6_wkv_fwd_ckpt``) and
    ``rwkv6_wkv_bwd`` against their plain versions on the card; returns
    the kernels-line entry (launches filled in from phase 30)."""
    bwd, plain = wkv_mod.rwkv6_wkv_bwd, wkv_mod.rwkv6_wkv_bwd_plain
    fwd, fwd_ckpt = wkv_mod.rwkv6_wkv_fwd, wkv_mod.rwkv6_wkv_fwd_ckpt
    f32, bf16 = torch.float32, torch.bfloat16
    names = ("dr", "dk", "dv", "dw", "du")
    gen = torch.Generator(device="cuda").manual_seed(27)
    cases = {"f32": (f32, f32), "bf16, w f32": (bf16, f32),
             "bf16": (bf16, bf16)}

    def inputs(b, h, s, n, dtype, w_dtype, decay):
        r, k, v, w, u = _wkv_views(torch, gen, b, h, s, n, dtype, w_dtype,
                                   decay)
        dy = torch.randn((b, s, h, n), generator=gen, device="cuda") \
            .to(dtype).transpose(1, 2)
        return r, k, v, w, u, dy

    def check_ckpt_fwd(args, what):
        """y bit-equal to the serving forward's; the checkpoints and c_t
        within BWD_REL["float32"] of the plain ones' largest value."""
        y, ckpt, c = fwd_ckpt(*args[:5])
        if not torch.equal(y, fwd(*args[:5])):
            raise AssertionError(f"{what}: the checkpointing forward's y "
                                 f"differs from the serving forward's")
        _, want_ckpt, want_c = wkv_mod.rwkv6_wkv_ckpt_plain(*args[:5])
        rel = {}
        for name, got, want in (("ckpt", ckpt, want_ckpt), ("c", c,
                                                            want_c)):
            rel[name] = max_err(torch, got, want) / max(
                float(want.abs().max()), 1e-30)
            if not rel[name] <= BWD_REL["float32"]:
                raise AssertionError(f"{what}: forward's {name} vs plain "
                                     f"{rel[name]:.3e} of its largest "
                                     f"value")
        return (ckpt, c), rel

    for b, h, s, n in WKV_BWD_SWEEP:
        for case, (dtype, w_dtype) in cases.items():
            args = inputs(b, h, s, n, dtype, w_dtype, (0.7, 0.999))
            what = f"wkv bwd {case} B={b} H={h} S={s} N={n}"
            ckpts, crel = check_ckpt_fwd(args, what)
            got = bwd(*args, *ckpts)
            for g, a in zip(got[:4], args[:4]):
                if g.stride() != a.stride():
                    raise AssertionError(f"{what}: a gradient is not laid "
                                         f"out like its input")
            rel = check_grads(torch, got, plain(*args), what, names)
            alone = bwd(*args)
            if not all(torch.equal(x, y) for x, y in zip(got, alone)):
                raise AssertionError(f"{what}: the backward on its own "
                                     f"checkpoints differs from the one "
                                     f"on the forward's")
            log("wkv-bwd", f"{what}: y bit-equal to serving; ckpt "
                f"{crel['ckpt']:.2e}, c {crel['c']:.2e}; max |err| / max "
                f"|plain| " + ", ".join(f"{k} {v:.2e}"
                                        for k, v in rel.items()))
    for decay in (0.0, 1.0):
        for case in ("f32", "bf16, w f32"):
            args = inputs(2, 40, 300, 64, *cases[case], decay)
            what = f"wkv bwd {case} B=2 H=40 S=300 N=64, w = {decay:g}"
            ckpts, _ = check_ckpt_fwd(args, what)
            rel = check_grads(torch, bwd(*args, *ckpts), plain(*args), what,
                              names)
            log("wkv-bwd", f"{what}: " + ", ".join(
                f"{k} {v:.2e}" for k, v in rel.items()))

    # The training shape in the model's dtypes, on the forward's
    # checkpoints: within tolerance, bit-equal over two calls, three
    # planted faults caught.
    b, h, s, n = (WKV_TRAIN[x] for x in ("b", "h", "s", "n"))
    args = inputs(b, h, s, n, bf16, f32, (0.7, 0.999))
    ckpts, crel = check_ckpt_fwd(args, "wkv forward at the training shape")
    first, want = bwd(*args, *ckpts), plain(*args)
    rel = check_grads(torch, first, want, "wkv bwd at the training shape",
                      names)
    worst = max(max_err(torch, x, y) for x, y in zip(first, want))
    second = bwd(*args, *ckpts)
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        raise AssertionError("wkv bwd: two calls on the same inputs differ")
    log("wkv-bwd", f"training shape B={b} H={h} S={s} N={n}, bf16 r/k/v/dy, "
        f"f32 w: forward's ckpt {crel['ckpt']:.2e}, c {crel['c']:.2e}; "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + "; two calls bit-equal")
    faults = {}
    shifted = (torch.roll(ckpts[0], -1, dims=2).contiguous(), ckpts[1])
    for fault, bad in (
            ("adjoint decay skipped",
             lambda: _wkv_bwd_planted(torch, *args, "adjoint decay skipped")),
            ("dw from S_t",
             lambda: _wkv_bwd_planted(torch, *args, "dw from S_t")),
            ("checkpoint one chunk off", lambda: bwd(*args, *shifted))):
        frel, caught = breaks(torch, bad(), want, names)
        if not caught:
            raise AssertionError(f"planted wkv bwd fault ({fault}) passes "
                                 f"the tolerance: {frel}")
        faults[fault] = frel
        log("wkv-bwd", f"planted fault ({fault}): " + ", ".join(
            f"{k} {v:.2e}" for k, v in frel.items()) + f"; caught by "
            f"{BWD_REL}")
    del first, second, want, shifted

    def moved(args):
        """Bytes read (every input once) and written (dr, dk, dv, dw like
        r, k, v, w; du f32)."""
        return sum(t.numel() * t.element_size() for t in args) \
            + sum(t.numel() * t.element_size() for t in args[:4]) \
            + 4 * h * n

    flop = b * h * s * (14 * n * n + 16 * n)
    entry = _bwd_timing(torch, lambda *a: bwd(*a, *ckpts), args, plain,
                        flop, moved(args),
                        f"training shape B={b} H={h} S={s} N={n}, given "
                        f"the forward's checkpoints", "wkv-bwd")
    entry.update(_fwd_times(torch, lambda: fwd(*args[:5]),
                            lambda: fwd_ckpt(*args[:5]),
                            f"training shape B={b} S={s}", "wkv-bwd"))
    alone_ms = device_ms(torch, lambda: bwd(*args), reps=10)
    log("wkv-bwd", f"training shape: the backward making its own "
        f"checkpoints {alone_ms:.4f} ms device time")
    del args, ckpts
    b, s = WKV_PREFILL["b"], WKV_PREFILL["s"]
    args = inputs(b, h, s, n, bf16, f32, (0.7, 0.999))
    ckpts = fwd_ckpt(*args[:5])[1:]
    serve = _bwd_timing(torch, lambda *a: bwd(*a, *ckpts), args, None,
                        b * h * s * (14 * n * n + 16 * n), moved(args),
                        f"serve shape B={b} H={h} S={s} N={n}, given the "
                        f"forward's checkpoints", "wkv-bwd")
    serve.update(_fwd_times(torch, lambda: fwd(*args[:5]),
                            lambda: fwd_ckpt(*args[:5]),
                            f"serve shape B={b} S={s}", "wkv-bwd"))
    del args, ckpts
    torch.cuda.empty_cache()
    report = {k: v for k, v in ptxas.items()
              if k.startswith("wkv_bwd") or k.startswith("wkv_fwd<bf16, f32, "
                                                         "N=64")}
    for label, (regs, st, ld) in report.items():
        if "N=64" in label or label == "wkv_bwd_du":
            log("wkv-bwd", f"ptxas {label}: {regs} registers, {st} bytes "
                f"spill stores, {ld} bytes spill loads")
    return dict(name="rwkv6_wkv_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/rwkv6_wkv_bwd.cu",
                replaces="src/repro/kernels/rwkv6_wkv.py:47",
                kernels=["wkv_bwd_rev", "wkv_bwd_du",
                         "wkv_fwd (with the checkpoint stores, "
                         "csrc/rwkv6_wkv.cu)"],
                launches=None, max_abs_err=worst, rel_err=rel,
                faults=faults, ms=entry["ms"],
                device_ms=entry["device_ms"], plain_ms=entry["plain_ms"],
                bound_ms=entry["bound_ms"], bound_by=entry["bound_by"],
                library_ms=None, fwd_device_ms=entry["fwd_device_ms"],
                fwd_ckpt_device_ms=entry["fwd_ckpt_device_ms"],
                standalone_device_ms=alone_ms,
                serve={k: v for k, v in serve.items() if k != "plain_ms"},
                ptxas=report)


def _scan_bwd_planted(torch, abar, bx, c, dy, fault: str):
    """``selective_scan_bwd_plain`` with one fault planted: "adjoint decay
    skipped" (G_t = c_t dy_t + G_{t+1}) or "d abar from h_t" (the state
    after the step instead of before it)."""
    b, s, d, n = abar.shape
    states = torch.zeros(s + 1, b, d, n, device=abar.device)
    for t in range(s):
        states[t + 1] = abar[:, t].float() * states[t] + bx[:, t].float()
    dabar, dbx = torch.empty_like(abar), torch.empty_like(bx)
    dc = torch.empty((b, s, n), dtype=c.dtype, device=abar.device)
    g = torch.zeros(b, d, n, device=abar.device)
    a_next = torch.zeros_like(g)
    for t in reversed(range(s)):
        dyt = dy[:, t].float()
        carry = g if fault == "adjoint decay skipped" else a_next * g
        g = carry + c[:, t].float()[:, None, :] * dyt[:, :, None]
        dbx[:, t] = g
        dabar[:, t] = g * states[t + 1 if fault == "d abar from h_t" else t]
        dc[:, t] = torch.einsum("bdn,bd->bn", states[t + 1], dyt)
        a_next = abar[:, t].float()
    return dabar, dbx, dc


def phase_scan_bwd(torch, scan_mod, ptxas: dict) -> dict:
    """Phase 28: the checkpointing forward (``selective_scan_fwd_ckpt``)
    and ``selective_scan_bwd`` against their plain versions on the card;
    returns the kernels-line entry (launches filled in from phase 29's
    jamba round)."""
    bwd, plain = scan_mod.selective_scan_bwd, scan_mod.selective_scan_bwd_plain
    fwd = scan_mod.selective_scan_fwd
    fwd_ckpt = scan_mod.selective_scan_fwd_ckpt
    names = ("dabar", "dbx", "dc")
    gen = torch.Generator(device="cuda").manual_seed(28)

    def inputs(b, s, d, n, case, abar_from):
        abar, bx, c = _scan_inputs(torch, gen, b, s, d, n, case, abar_from)
        dy = torch.randn((b, s, d), generator=gen, device="cuda").to(bx.dtype)
        return abar, bx, c, dy

    def check_ckpt_fwd(args, what):
        """y bit-equal to the serving forward's; the checkpoints within
        BWD_REL["float32"] of the plain ones' largest value."""
        y, ckpt = fwd_ckpt(*args[:3])
        if not torch.equal(y, fwd(*args[:3])):
            raise AssertionError(f"{what}: the checkpointing forward's y "
                                 f"differs from the serving forward's")
        want = scan_mod.selective_scan_ckpt_plain(*args[:3])[1]
        rel = max_err(torch, ckpt, want) / max(float(want.abs().max()),
                                               1e-30)
        if not rel <= BWD_REL["float32"]:
            raise AssertionError(f"{what}: forward's ckpt vs plain "
                                 f"{rel:.3e} of its largest value")
        return ckpt, rel

    for b, s, d, n in SCAN_SWEEP:
        for case in SCAN_CASES:
            args = inputs(b, s, d, n, case, (0.2, 0.99))
            what = f"scan bwd {case} B={b} S={s} D={d} N={n}"
            ckpt, crel = check_ckpt_fwd(args, what)
            got = bwd(*args, ckpt)
            rel = check_grads(torch, got, plain(*args), what, names)
            alone = bwd(*args)
            if not all(torch.equal(x, y) for x, y in zip(got, alone)):
                raise AssertionError(f"{what}: the backward on its own "
                                     f"checkpoints differs from the one "
                                     f"on the forward's")
            log("scan-bwd", f"{what}: y bit-equal to serving; ckpt "
                f"{crel:.2e}; max |err| / max |plain| "
                + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    for abar in (0.0, 1.0):
        for case in ("f32", "mixed"):
            args = inputs(2, 300, 130, 16, case, (abar, abar))
            what = f"scan bwd {case} B=2 S=300 D=130 N=16, abar = {abar:g}"
            ckpt, _ = check_ckpt_fwd(args, what)
            rel = check_grads(torch, bwd(*args, ckpt), plain(*args), what,
                              names)
            log("scan-bwd", f"{what}: " + ", ".join(
                f"{k} {v:.2e}" for k, v in rel.items()))

    # The training shape in the model's dtypes, on the forward's
    # checkpoints: within tolerance, bit-equal over two calls, three
    # planted faults caught, at two abar regimes.
    b, s, d, n = (SCAN_TRAIN[x] for x in ("b", "s", "d", "n"))
    rels, faults = {}, {}
    for abar_from in ((0.8, 0.999), "own fan-in"):
        label = ("abar ~ U[0.8, 0.999]" if isinstance(abar_from, tuple)
                 else "abar at own fan-in")
        args = inputs(b, s, d, n, "mixed", abar_from)
        ckpt, crel = check_ckpt_fwd(args, f"scan forward at the training "
                                          f"shape, {label}")
        first, want = bwd(*args, ckpt), plain(*args)
        rel = check_grads(torch, first, want,
                          f"scan bwd at the training shape, {label}", names)
        rels[label] = rel
        worst = max(max_err(torch, x, y) for x, y in zip(first, want))
        second = bwd(*args, ckpt)
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError("scan bwd: two calls on the same inputs "
                                 "differ")
        log("scan-bwd", f"training shape B={b} S={s} D={d} N={n}, abar f32, "
            f"bx/c/dy bf16, {label}: forward's ckpt {crel:.2e}; "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + "; two calls bit-equal")
        del first, second
        shifted = torch.roll(ckpt, -1, dims=1).contiguous()
        for fault, bad in (
                ("adjoint decay skipped",
                 lambda: _scan_bwd_planted(torch, *args,
                                           "adjoint decay skipped")),
                ("d abar from h_t",
                 lambda: _scan_bwd_planted(torch, *args, "d abar from h_t")),
                ("checkpoint one chunk off", lambda: bwd(*args, shifted))):
            frel, caught = breaks(torch, bad(), want, names)
            if not caught:
                raise AssertionError(f"planted scan bwd fault ({fault}, "
                                     f"{label}) passes the tolerance: "
                                     f"{frel}")
            faults[f"{fault}, {label}"] = frel
            log("scan-bwd", f"planted fault ({fault}, {label}): "
                + ", ".join(f"{k} {v:.2e}" for k, v in frel.items())
                + f"; caught by {BWD_REL}")
        del want, shifted
        if isinstance(abar_from, tuple):
            del args, ckpt

    def moved(args):
        """Bytes read (every input once) and written (d abar, d bx like
        abar, bx; dc (B, S, N) bf16)."""
        return sum(t.numel() * t.element_size() for t in args) \
            + sum(t.numel() * t.element_size() for t in args[:2]) \
            + args[2].shape[0] * args[2].shape[1] * n * 2

    entry = _bwd_timing(torch, lambda *a: bwd(*a, ckpt), args, plain,
                        8 * b * s * d * n, moved(args),
                        f"training shape B={b} S={s} D={d} N={n}, given "
                        f"the forward's checkpoints", "scan-bwd")
    entry.update(_fwd_times(torch, lambda: fwd(*args[:3]),
                            lambda: fwd_ckpt(*args[:3]),
                            f"training shape B={b} S={s}", "scan-bwd"))
    alone_ms = device_ms(torch, lambda: bwd(*args), reps=10)
    log("scan-bwd", f"training shape: the backward making its own "
        f"checkpoints {alone_ms:.4f} ms device time")
    del args, ckpt
    torch.cuda.empty_cache()
    b, s = SCAN_PREFILL["b"], SCAN_PREFILL["s"]
    args = inputs(b, s, d, n, "mixed", (0.8, 0.999))
    ckpt = fwd_ckpt(*args[:3])[1]
    serve = _bwd_timing(torch, lambda *a: bwd(*a, ckpt), args, None,
                        8 * b * s * d * n, moved(args),
                        f"serve shape B={b} S={s} D={d} N={n}, given the "
                        f"forward's checkpoints", "scan-bwd")
    serve.update(_fwd_times(torch, lambda: fwd(*args[:3]),
                            lambda: fwd_ckpt(*args[:3]),
                            f"serve shape B={b} S={s}", "scan-bwd"))
    del args, ckpt
    torch.cuda.empty_cache()
    report = {k: v for k, v in ptxas.items()
              if k.startswith("scan_bwd")
              or k.startswith("scan_fwd<f32, bf16, N=16")}
    for label in ("scan_bwd_rev<f32, bf16, N=16>", "scan_bwd_dc<bf16>",
                  "scan_fwd<f32, bf16, N=16, ckpt>",
                  "scan_fwd<f32, bf16, N=16>"):
        if label in report:
            regs, st, ld = report[label]
            log("scan-bwd", f"ptxas {label}: {regs} registers, {st} bytes "
                f"spill stores, {ld} bytes spill loads")
    return dict(name="selective_scan_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
                replaces="src/repro/kernels/selective_scan.py:42",
                kernels=["scan_bwd_rev", "scan_bwd_dc",
                         "scan_fwd (with the checkpoint stores, "
                         "csrc/selective_scan.cu)"],
                launches=None, max_abs_err=worst, rel_err=rels,
                faults=faults, ms=entry["ms"], device_ms=entry["device_ms"],
                plain_ms=entry["plain_ms"], bound_ms=entry["bound_ms"],
                bound_by=entry["bound_by"], library_ms=None,
                fwd_device_ms=entry["fwd_device_ms"],
                fwd_ckpt_device_ms=entry["fwd_ckpt_device_ms"],
                standalone_device_ms=alone_ms,
                serve={k: v for k, v in serve.items() if k != "plain_ms"},
                ptxas=report)


def phase_mamba_block_grads(torch, Transformer, get_config, ops,
                            scan_mod) -> dict:
    """Phase 28: one full-width jamba Mamba block (d_model 4096, d_inner
    8192, N=16, bf16, own fan-in) at batch 2 x seq 1024: the gradients of
    every mixer leaf and of the input through the kernels (one forward
    and one backward launch, counted) against the same block with the
    scan's plain version on the card, in relative Frobenius norm."""
    import dataclasses
    from repro_torch.models import ssm as ssm_lib, transformer as tr
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    model = Transformer(cfg)
    prefix = "layers/b1/mixer/"
    defs = {k: v for k, v in fan_in_defs(model, own=True).items()
            if k.startswith(prefix)}
    dt = getattr(torch, cfg.param_dtype)
    params = init_params(defs, torch.Generator(device="cuda").manual_seed(28),
                         "cuda", dt)
    mixer = {k.removeprefix(prefix): v[0] for k, v in params.items()}
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn((2, 1024, cfg.d_model), generator=gen,
                    device="cuda").to(dt)
    weight = torch.randn(x.shape, generator=gen, device="cuda")

    def grads(remat: bool = False):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in mixer.items()}
        xx = x.detach().clone().requires_grad_()
        if remat:   # as the model's remat runs a period
            out = torch.utils.checkpoint.checkpoint(
                ssm_lib.mamba_forward, cfg, leaves, xx, use_reentrant=False,
                preserve_rng_state=False)
        else:
            out = ssm_lib.mamba_forward(cfg, leaves, xx)
        g = torch.autograd.grad((out.float() * weight).sum(),
                                [*leaves.values(), xx])
        return dict(zip([*leaves, "x"], g))
    scan = scan_mod.selective_scan

    def counts():
        return (scan.launches, scan.launches_ckpt, scan.launches_bwd)
    torch.cuda.synchronize()
    scan.launches = scan.launches_ckpt = scan.launches_bwd = 0
    t0 = time.perf_counter()
    got = grads()
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    once = counts()
    if once != (1, 1, 1):
        raise AssertionError(f"the Mamba block launched {once} scan "
                             f"forward / checkpointing forward / backward "
                             f"kernels; want (1, 1, 1)")
    # Under torch.utils.checkpoint the forward runs again in the backward
    # (the in-place exp_ of abar included), storing checkpoints again: one
    # more forward launch, the same gradients bit for bit.
    scan.launches = scan.launches_ckpt = scan.launches_bwd = 0
    again = grads(remat=True)
    torch.cuda.synchronize()
    if counts() != (2, 2, 1) or not all(
            torch.equal(again[k], got[k]) for k in got):
        raise AssertionError(f"the Mamba block under checkpoint: launches "
                             f"{counts()} (want (2, 2, 1)), gradients "
                             f"bit-equal: "
                             f"{all(torch.equal(again[k], got[k]) for k in got)}")
    del again
    # The block's forward + backward in device time (counts read above).
    block_ms = device_ms(torch, grads, reps=5, warmup=1)
    real = ops.selective_scan_op
    ops.selective_scan_op = (lambda abar, bx, c, chunk=64, block_d=256:
                             scan_mod.selective_scan_plain(abar, bx, c))
    try:
        t0 = time.perf_counter()
        want = grads()
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        ops.selective_scan_op = real
    rel = {k: float((got[k].float() - w.float()).norm())
           / max(float(w.float().norm()), 1e-30) for k, w in want.items()}
    worst = max(rel, key=rel.get)
    if not all(torch.isfinite(g).all() for g in got.values()) \
            or rel[worst] > MAMBA_GRAD_RTOL:
        raise AssertionError(f"Mamba block gradients, kernels vs plain: "
                             f"{worst} differs by {rel[worst]:.3e} of its "
                             f"norm (limit {MAMBA_GRAD_RTOL})")
    log("scan-bwd", f"jamba Mamba block at full width ({cfg.d_model} -> "
        f"{cfg.d_inner_mamba} x {cfg.mamba.d_state}, {dt}, own fan-in), B=2 "
        f"S=1024: one scan forward (storing checkpoints) and one backward "
        f"launch; the gradients "
        f"of {len(rel)} tensors (the mixer's leaves and x) within "
        f"{rel[worst]:.3e} of the plain scan's (worst {worst}; limit "
        f"{MAMBA_GRAD_RTOL}); forward + backward {t_kernel:.3f} s with the "
        f"kernels ({block_ms:.3f} ms of device time), {t_plain:.3f} s "
        f"with the plain scan; under "
        f"torch.utils.checkpoint two forward (both storing checkpoints) "
        f"and one backward launch, the gradients bit-equal")
    del params, mixer, got, want
    torch.cuda.empty_cache()
    return dict(launches=once[2], grad_rel=rel[worst],
                device_ms=block_ms)


# Phase 31: MLA (minicpm3-4b) and the encoder-decoder stack
# (whisper-small) at full width cut to this many layers (whisper's encoder
# too), f32 at own fan-in: at the reference's init (every stacked matrix at
# std 1/sqrt(4) here) their softmaxes saturate and the logits are chaotic
# in the order of the sums (tests/_torch_zoo.py).
ZOO_F32_LAYERS = 4
# Phase 32: the seven architectures the port took last, served at full
# width in bf16, as (arch, layers run, own): layers None runs all; own
# serves at the stacked matrices' own fan-in, where the reference's init
# saturates the prefill (``init_reading``; the phase reads it for every
# arch and fails where the reading and ``own`` disagree). deepseek-coder
# -33b (62 GiB in bf16) and qwen3-moe-30b-a3b (57 GiB) fit the card, but
# not beside the f32 draw of their largest stacked leaf (34 and 39 GB):
# cut, as jamba runs one period. mistral-nemo-12b and pixtral-12b run at
# full depth in 16-17 s each, deepseek-coder-33b at 32 layers in 13 s,
# qwen3-moe-30b-a3b at 24 in 25 s (two decode calls each; H100 80GB
# HBM3): those four run at half that depth or less, and decode once, to
# keep the script within its time on a slow host. The reference's init
# draws a stacked matrix at std 1/sqrt(layers), so a cut arch reads it at
# the layers it runs.
ZOO_SERVE = (("granite-moe-1b-a400m", None, True),
             ("minicpm3-4b", None, True),
             ("whisper-small", None, True),
             ("mistral-nemo-12b", 20, True),
             ("pixtral-12b", 20, True),
             ("deepseek-coder-33b", 16, True),
             ("qwen3-moe-30b-a3b", 12, False))
# A prefill is saturated where one of its softmaxes (the attention rows,
# the MoE routers, the next-token distribution) puts on average more than
# this share of its weight on one entry.
SATURATED_TOP1 = 0.5
# The rows each reading takes: the last query rows of every attention
# call, and the last positions' logits.
READ_ROWS = 64


def init_reading(torch, model, params, tokens, aux_in) -> dict:
    """One prefill of ``tokens`` (B=1) and ``aux_in``, read: the mean
    top-1 weight of the last READ_ROWS query rows of each attention call
    (dense, from the call's q and k and its mask), averaged and largest
    over the calls; for MoE the routers' mean top-1 probability and the
    share of top-k assignments past an expert's capacity; the last
    READ_ROWS positions' logits, their max |.| and mean top-1
    probability. ``saturated``: a logit not finite, or a mean top-1 of
    the attention, the routers or the logits above SATURATED_TOP1."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_lib

    attn, router, dropped = [], [], []

    def spy_attention(real):
        def call(q, k, v, causal=True, window=None):
            sq, sk = q.shape[2], k.shape[2]
            rows = min(READ_ROWS, sq)
            group = q.shape[1] // k.shape[1]
            sc = torch.einsum("hqd,hkd->hqk", q[0, :, -rows:].float(),
                              k[0].repeat_interleave(group, 0).float())
            qpos = torch.arange(sq - rows, sq, device=q.device)[:, None]
            kpos = torch.arange(sk, device=q.device)[None, :]
            ok = torch.ones(rows, sk, dtype=torch.bool, device=q.device)
            if causal:
                ok &= qpos >= kpos
            if window is not None:
                ok &= qpos - kpos < window
            sc = sc.mul_(1.0 / math.sqrt(q.shape[-1])).masked_fill_(
                ~ok, -math.inf)
            attn.append(float(torch.softmax(sc, -1).amax(-1).mean()))
            return real(q, k, v, causal=causal, window=window)
        return call

    def spy_route(real):
        def call(cfg, p, xt):
            probs, gate_vals, gate_idx = real(cfg, p, xt)
            router.append(float(probs.amax(-1).mean()))
            counts = torch.bincount(gate_idx.reshape(-1),
                                    minlength=cfg.moe.num_experts)
            cap = moe_lib.capacity(cfg.moe, xt.shape[0])
            dropped.append(float((counts - cap).clamp(min=0).sum())
                           / gate_idx.numel())
            return probs, gate_vals, gate_idx
        return call

    with torch.no_grad(), patched(ops, "flash_attention_op",
                                  spy_attention), \
            patched(moe_lib, "route", spy_route):
        x, _ = model.hidden_states(params, tokens, aux_in)
        logits = model.logits(params, x[:, -READ_ROWS:]).float()
    out = dict(attn_top1=float(np.mean(attn)), attn_top1_max=max(attn),
               logit_max=float(logits.abs().max()),
               finite=bool(torch.isfinite(logits).all()),
               logit_top1=float(torch.softmax(logits, -1).amax(-1).mean()))
    if router:
        out.update(router_top1=float(np.mean(router)),
                   dropped=float(np.mean(dropped)))
    out["saturated"] = not out["finite"] or max(
        out["attn_top1"], out["logit_top1"],
        out.get("router_top1", 0.0)) > SATURATED_TOP1
    return out


def _reading_text(r: dict) -> str:
    return (f"attention top-1 {r['attn_top1']:.4f} (max over layers "
            f"{r['attn_top1_max']:.4f})" + (
                f", router top-1 {r['router_top1']:.4f}, "
                f"{r['dropped']:.4f} of assignments past capacity"
                if "router_top1" in r else "")
            + f", logits max |.| {r['logit_max']:.3f}, finite "
            f"{r['finite']}, top-1 {r['logit_top1']:.4f}: "
            f"{'saturated' if r['saturated'] else 'not saturated'}")


def _zoo_model(Transformer, get_config, arch: str, layers, dtype: str):
    """``arch`` at full width in ``dtype``, cut to ``layers`` (and as many
    encoder layers) where given."""
    import dataclasses
    cfg = get_config(arch)
    cut = {}
    if layers is not None:
        cut["num_layers"] = layers
        if cfg.is_encdec:
            cut["encoder_layers"] = layers
    return Transformer(dataclasses.replace(cfg, param_dtype=dtype,
                                           act_dtype=dtype, **cut))


def _zoo_frames(torch, cfg, b: int, seed: int, device: str):
    """Unit-normal stub frame embeddings (B, encoder_seq, d_model) from a
    numpy seed, in the activation dtype."""
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x).to(device, getattr(torch, cfg.act_dtype))


def _zoo_stepped(torch, model, params, tokens, frames=None, fault=None):
    """Logits (B, S, V) of stepping ``tokens`` through ``decode_step``,
    the cross caches primed from ``frames`` where given; ``fault(cache,
    t)`` is applied after step t."""
    b, s = tokens.shape
    cache = model.init_cache(b, s, device=tokens.device)
    if frames is not None:
        cache = model.prime_encdec(params, cache, frames)
    steps = []
    for t in range(s):
        logits, cache = model.decode_step(params, cache, tokens[:, t])
        if fault:
            fault(cache, t)
        steps.append(logits)
    return torch.stack(steps, dim=1)


def fault_latent_one_slot_off(cache, t):
    """MLA: from step 32 on, each step's latent and rope'd key land one
    slot late (the slot they belong in keeps the step before's)."""
    if 32 <= t < 63:
        for key, leaf in cache.items():
            if key.endswith(("/c_kv", "/k_rope")):
                leaf[:, :, t + 1] = leaf[:, :, t]
                leaf[:, :, t] = leaf[:, :, t - 1]


def phase_zoo_card_vs_cpu(torch, Transformer, get_config) -> None:
    """minicpm3-4b and whisper-small at full width, ``ZOO_F32_LAYERS``
    layers, f32 at own fan-in, drawn on the CPU: ``forward`` over B=1,
    S=256 (whisper with 1500 frames) on the card (kernels) against the
    CPU (plain versions); then decode against forward on the card, B=2,
    S=64, where a planted fault must break the tolerance (MLA's latents
    one slot off; whisper's cross caches primed from other frames), and
    whisper's decoded logits must move when its frames are zeroed."""
    from repro_torch.models.params import init_params

    failed = []
    for arch in ("minicpm3-4b", "whisper-small"):
        model = _zoo_model(Transformer, get_config, arch, ZOO_F32_LAYERS,
                           "float32")
        cfg = model.cfg
        t0 = time.perf_counter()
        params = init_params(fan_in_defs(model, own=True),
                             torch.Generator().manual_seed(0), "cpu")
        enc = (f", {cfg.encoder_layers} encoder layers" if cfg.is_encdec
               else "")
        log("zoo", f"{cfg.name} ({cfg.num_layers} layers{enc}): "
            f"{model.count_params()} params drawn on the CPU at own fan-in "
            f"in {time.perf_counter() - t0:.2f} s")
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (1, 256)))
        frames = _zoo_frames(torch, cfg, 1, 5, "cpu") if cfg.is_encdec \
            else None
        outs = {}
        with torch.no_grad():
            for device in ("cuda", "cpu"):
                p = {k: v.to(device) for k, v in params.items()}
                aux = None if frames is None else {"frames":
                                                   frames.to(device)}
                t0 = time.perf_counter()
                outs[device] = model.forward(p, tokens.to(device),
                                             aux)[0].cpu()
                log("zoo", f"{arch} {device}: forward B=1 S=256 f32 in "
                    f"{time.perf_counter() - t0:.3f} s")
        got, want = outs["cuda"], outs["cpu"]
        err = max_err(torch, got, want)
        if not (torch.isfinite(got).all()
                and torch.allclose(got, want, **LM_F32_TOL)):
            failed.append(f"{arch} card vs CPU, max |err| {err:.3e}")
        log("zoo", f"{arch} logits {tuple(got.shape)}: max |card - cpu| "
            f"{err:.3e} ({LM_F32_TOL}); max |logit| "
            f"{float(want.abs().max()):.3f}")
        del outs, got, want

        p = {k: v.cuda() for k, v in params.items()}
        del params
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 64))).cuda()
        frames = _zoo_frames(torch, cfg, 2, 6, "cuda") if cfg.is_encdec \
            else None
        with torch.no_grad():
            fwd = model.forward(p, toks, None if frames is None
                                else {"frames": frames})[0]
            dec = _zoo_stepped(torch, model, p, toks, frames)
            if cfg.is_encdec:
                bad = _zoo_stepped(torch, model, p, toks,
                                   _zoo_frames(torch, cfg, 2, 7, "cuda"))
                fault = "cross caches primed from other frames"
                zero = _zoo_stepped(torch, model, p, toks,
                                    torch.zeros_like(frames))
                moved = max_err(torch, zero, dec)
                if not moved > 1e-3:
                    failed.append(f"{arch}: zeroed frames moved the "
                                  f"logits by {moved:.3e}")
                log("zoo", f"{arch}: zeroed frames move the decoded logits "
                    f"by {moved:.4e} (> 1e-3 required)")
            else:
                bad = _zoo_stepped(torch, model, p, toks,
                                   fault=fault_latent_one_slot_off)
                fault = "latents one slot off from step 32"
        err, berr = max_err(torch, dec, fwd), max_err(torch, bad, fwd)
        if not torch.allclose(dec, fwd, **LM_F32_TOL):
            failed.append(f"{arch} decode vs forward, max |err| {err:.3e}")
        caught = not torch.allclose(bad, fwd, **LM_F32_TOL)
        if not caught:
            failed.append(f"{arch} planted fault ({fault}) passes, max "
                          f"|err| {berr:.3e}")
        log("zoo", f"{arch} f32 B=2 S=64: decode vs forward logits max "
            f"|err| {err:.4e} ({LM_F32_TOL}); planted fault ({fault}): "
            f"{berr:.4e}, {'caught' if caught else 'NOT caught'}")
        del p, fwd, dec, bad
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 31: " + "; ".join(failed))


def phase_zoo_serve(torch, Transformer, get_config, serve,
                    kernels: dict) -> dict:
    """Each of ``ZOO_SERVE`` at full width in bf16, drawn on the card at
    the reference's init and read there (``init_reading``, B=1, S=4096);
    where the table says ``own``, rescaled to own fan-in in place (the
    same draws, as ``fan_in_defs`` makes them) and read again. Then
    ``phase_serve`` (prefill B=4, S=4096, with 1500 frames for
    whisper and 1024 patches ahead of the text for pixtral, the counts
    zeroed just before and read just after: one tensor-core flash launch
    per attention layer, whisper's encoder, self- and cross-attention
    each, minicpm3-4b's on its (96, 64) variant; then ``greedy_generate``),
    then one prefill under torch.profiler. Fails, after serving all
    seven, where a reading disagrees with ``own``. Returns the flash
    launches of each prefill."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.params import init_params

    out, disagree = {}, []
    b = PREFILL["b"]
    for arch, layers, own in ZOO_SERVE:
        t_arch = time.perf_counter()
        model = _zoo_model(Transformer, get_config, arch, layers, "bfloat16")
        cfg = model.cfg
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = init_params(fan_in_defs(model, own=False), gen, "cuda",
                             torch.bfloat16)
        torch.cuda.synchronize()
        cut = ("full depth" if layers is None else
               f"cut to {layers} of {get_config(arch).num_layers} layers")
        log("zoo-serve", f"{arch}: {model.count_params()} params ({cut}) "
            f"drawn on the card at the reference's init in "
            f"{time.perf_counter() - t0:.2f} s; vocab {cfg.vocab_size}, "
            f"d_model {cfg.d_model} against H·D "
            f"{cfg.num_heads * cfg.head_dim}" + (
                f", MoE {cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
                f" with {moe_lib.capacity(cfg.moe, b * PREFILL['s'])} "
                f"slots each at B={b} S={PREFILL['s']}" if cfg.moe else ""))
        aux_in = frames = None
        if cfg.is_encdec:
            aux_in = {"frames": _zoo_frames(torch, cfg, b, 8, "cuda")}
            frames = _zoo_frames(torch, cfg, 4, 9, "cuda")  # generate's
        if cfg.vision_patches:
            aux_in = {"patches": (0.1 * torch.randn(
                (b, cfg.vision_patches, cfg.d_model), generator=gen,
                device="cuda")).to(torch.bfloat16)}
        one = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (1, PREFILL["s"]))).cuda()
        one_aux = aux_in and {k: x[:1] for k, x in aux_in.items()}
        reading = init_reading(torch, model, params, one, one_aux)
        log("zoo-serve", f"{arch} at the reference's init, one prefill B=1 "
            f"S={PREFILL['s']}: {_reading_text(reading)}")
        if reading["saturated"] != own:
            disagree.append(f"{arch}: saturated {reading['saturated']}, "
                            f"own {own}")
        if own:
            for k, f in own_fan_in_factors(model).items():
                params[k].mul_(f)
            again = init_reading(torch, model, params, one, one_aux)
            log("zoo-serve", f"{arch} rescaled to own fan-in, the same "
                f"prefill: {_reading_text(again)}")
        del one, one_aux
        n = cfg.num_layers + (cfg.encoder_layers + cfg.num_layers
                              if cfg.is_encdec else 0)
        expected = {"flash_attention": n, "flash_attention.tc": n}
        if cfg.attention_kind == "mla":
            expected["flash_attention.split"] = n
        counts, tokens, _ = phase_serve(torch, model, params, serve, kernels,
                                        expected, "zoo-serve", aux_in,
                                        frames, gen_calls=1)
        out[arch] = counts["flash_attention"]
        log_profile("zoo-serve", f"{arch} one prefill B={b} "
                    f"S={PREFILL['s']}", profile_device(
                        torch, lambda: serve.prefill(model, params, tokens,
                                                     aux_in)),
                    "flash_fwd", top=6)
        del params, aux_in, frames, tokens
        torch.cuda.empty_cache()
        log("zoo-serve", f"{arch} ({cut}, "
            f"{'own fan-in' if own else 'the reference init'}) in "
            f"{time.perf_counter() - t_arch:.1f} s")
    if disagree:
        raise AssertionError(f"the reading at the reference's init "
                             f"disagrees with ZOO_SERVE's own: {disagree}")
    return out


MESH_LM = ["--full", "--sats", "1", "--orbits", "1", "--rounds", "2"]


def record_blocks(ex, blocks: list) -> None:
    """Wrap ``ex.run_block`` so that each call appends a copy of the
    params it returns (the unsharded blocks phase 33 is held against)."""
    inner = ex.run_block

    def recorded(*args, **kw):
        params, accs = inner(*args, **kw)
        blocks.append({k: v.clone() for k, v in params.items()})
        return params, accs
    ex.run_block = recorded


def phase_mesh(torch, sim, fedagg_mod, ref_history, ref_blocks,
               load_dataset) -> dict:
    """Phase 33 (see the module docstring): the mesh path on a 1-rank
    NCCL group. ``ref_history`` and ``ref_blocks`` are phase 5's
    unsharded run's; ``load_dataset`` is the memoized loader phase 3's
    engine used, so this phase's engines reuse its digits. Returns the
    readings."""
    import datetime
    import os
    import tempfile

    import torch.distributed as dist
    from repro_torch.core import mesh_round
    from repro_torch.debug import sanitized_run
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.sim import engine as engine_mod

    # One rank needs no network: NCCL's bootstrap listens on the loopback.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    out = {}
    with tempfile.TemporaryDirectory() as d, \
            patched(engine_mod, "load_dataset", lambda _: load_dataset):
        t0 = time.perf_counter()
        try:
            dist.init_process_group(
                "nccl", init_method=f"file://{d}/store", rank=0,
                world_size=1, timeout=datetime.timedelta(seconds=60))
            mesh = mesh_lib.make_sim_mesh(1)
            probe = torch.ones(1, device="cuda")
            mesh_round.psum_(probe, mesh, ("data",))
            torch.cuda.synchronize()
        except Exception as e:
            raise AssertionError(
                f"the 1-rank NCCL group did not start from a file:// store "
                f"(NCCL_SOCKET_IFNAME={os.environ.get('NCCL_SOCKET_IFNAME')}"
                f"): {type(e).__name__}: {e}") from e
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        log("mesh", f"1-rank NCCL group and mesh {shape} up in "
            f"{time.perf_counter() - t0:.2f} s (torch {torch.__version__}, "
            f"NCCL {torch.cuda.nccl.version()}); all-reduce of ones -> "
            f"{float(probe.cpu()[0])}")
        try:
            out = _mesh_runs(torch, sim, fedagg_mod, mesh, ref_history,
                             ref_blocks, mesh_round, sanitized_run, train)
        finally:
            dist.destroy_process_group()
    return out


def _mesh_runs(torch, sim, fedagg_mod, mesh, ref_history, ref_blocks,
               mesh_round, sanitized_run, train) -> dict:
    """The body of :func:`phase_mesh`, inside the group."""
    out = {}
    # The default FedHAP run, sharded over the 1-rank mesh; counts zeroed
    # just before, read just after.
    eng = sim.RoundEngine(sim.SimConfig(max_rounds=16, mesh=mesh))
    blocks, reduces = [], [0]
    record_blocks(eng.executor, blocks)

    def counted(real):
        def psum_(*args, **kw):
            reduces[0] += 1
            return real(*args, **kw)
        return psum_

    with patched(mesh_round, "psum_", counted):
        fedagg_mod.fedagg.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fedagg_mod.fedagg.launches
    log("mesh", f"sharded run: {res.rounds} rounds in {wall:.3f} s "
        f"({wall / max(res.rounds, 1):.4f} s/round, the first block "
        f"included); fedagg launches {launches}, all-reduces {reduces[0]}; "
        f"executor shards {eng.executor.n_shards}")
    if res.history != ref_history:
        raise AssertionError(f"the sharded history {res.history} differs "
                             f"from phase 5's {ref_history}")
    if launches != res.rounds or reduces[0] != res.rounds:
        raise AssertionError(f"{launches} fedagg launches and {reduces[0]} "
                             f"all-reduces in {res.rounds} rounds; expected "
                             f"one each per round")
    if len(blocks) != len(ref_blocks) or len(blocks) < 2:
        raise AssertionError(f"{len(blocks)} sharded blocks against "
                             f"{len(ref_blocks)} unsharded (want >= 2)")
    diff = max(float((a[k] - b[k]).abs().max())
               for a, b in zip(blocks, ref_blocks) for k in a)
    equal = all(torch.equal(a[k], b[k])
                for a, b in zip(blocks, ref_blocks) for k in a)
    log("mesh", f"{len(blocks)} blocks' params against phase 5's "
        f"unsharded run_block: bit-equal {equal} (max |diff| {diff:.3e})")
    if not equal:
        raise AssertionError(f"the 1-rank sharded blocks differ from the "
                             f"unsharded ones (max |diff| {diff:.3e})")
    _, n = fedagg_mod.out_offsets([x.numel() for x in blocks[-1].values()],
                                  4)
    flat = torch.zeros(n, device="cuda")
    ms = device_ms(torch, lambda: mesh_round.psum_(flat, mesh, ("data",)))
    log("mesh", f"all-reduce of the fold's {flat.numel():,} f32 over the "
        f"1-rank NCCL group: {ms:.4f} ms device time per round (one per "
        f"round)")
    out.update(rounds=res.rounds, launches=launches, all_reduces=reduces[0],
               s_per_round=wall / max(res.rounds, 1), all_reduce_ms=ms,
               bitwise=equal)

    # One sharded block under the sanitizer (sync-debug mode "error").
    fedagg_mod.fedagg.launches = 0
    san, _ = sanitized_run(dict(mesh=mesh, max_rounds=8))
    log("mesh", f"sanitized sharded block: {san.rounds} rounds, fedagg "
        f"launches {fedagg_mod.fedagg.launches}, history equal to phase "
        f"5's first {san.rounds}: {san.history == ref_history[:san.rounds]}")
    if san.history != ref_history[:len(san.history)] or san.rounds != 8 \
            or fedagg_mod.fedagg.launches != 8:
        raise AssertionError(f"sanitized sharded block: {san.history} "
                             f"against {ref_history[:8]}, "
                             f"{fedagg_mod.fedagg.launches} launches")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("sync-debug mode left on after the run")
    del eng
    torch.cuda.empty_cache()

    # launch.train on the group: the mesh path, for the faithful and the
    # fused round, against the single-device round at S=1 (which runs
    # the same fold whatever --round-kind says, so once).
    want = train.main(MESH_LM + ["--single-device"])
    torch.cuda.synchronize()
    out["train"] = {}
    for kind in ("fedhap", "fedhap_fused"):
        args = MESH_LM + ["--round-kind", kind]
        fedagg_mod.fedagg.launches = 0
        t0 = time.perf_counter()
        got = train.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fedagg_mod.fedagg.launches
        leaf = max(float((got["params_S"][k].float()
                          - want["params_S"][k].float()).abs().max())
                   for k in want["params_S"])
        loss = max(abs(a - b) for a, b in zip(got["losses"],
                                              want["losses"]))
        log("mesh", f"launch.train {' '.join(args)}: path {got['path']} "
            f"(against {want['path']}), {wall:.2f} s with the model's "
            f"init, losses {got['losses']}, fedagg launches {launches}; "
            f"max |diff| against single_device_round: leaves {leaf:.3e}, "
            f"losses {loss:.3e}")
        expect = 2 if kind == "fedhap_fused" else 0
        if got["path"] != "mesh" or want["path"] != "single_device" \
                or launches != expect \
                or not all(math.isfinite(x) for x in got["losses"]):
            raise AssertionError(f"launch.train {kind}: path {got['path']}"
                                 f", {launches} fedagg launches (want "
                                 f"{expect}), losses {got['losses']}")
        if leaf != 0.0 or loss != 0.0:
            raise AssertionError(f"launch.train {kind}: the mesh path "
                                 f"differs from single_device_round at "
                                 f"S=1 (leaves {leaf:.3e}, losses "
                                 f"{loss:.3e})")
        out["train"][kind] = dict(launches=launches, max_abs_diff=leaf,
                                  seconds=wall)
        del got
        torch.cuda.empty_cache()
    return out


class Clock:
    """Each phase's seconds: ``lap(label)`` logs the time since the last
    lap (or since the clock was made) as that phase's."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, label: str) -> float:
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        log("time", f"phase {label} in {dt:.1f} s")
        return dt


def main() -> int:
    t_start = time.perf_counter()
    clock = Clock()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a machine with an NVIDIA card",
              file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    # 1. device
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    log("device", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")
    clock.lap("1 (device)")

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    ptxas = {}
    for name, info in built.items():
        log("build", f"{name}: {info['seconds']:.2f} s "
            f"(cached={info['cached']})")
        # Each kernel's registers and spills under its (mangled) name, and
        # any wgmma serialisation ptxas reports.
        for line in info["log"].splitlines():
            if any(w in line for w in ("Function properties", "Used ",
                                       "spill", "Performance Loss")):
                log("build", f"  {line.strip()}")
        ptxas.update(ptxas_report(info["log"]))
    for label, (regs, stores, loads) in ptxas.items():
        if "_tc" in label:
            log("build", f"ptxas {label}: {regs} registers, {stores} bytes "
                f"spill stores, {loads} bytes spill loads")
    log("build", f"all kernels built in {time.perf_counter() - t0:.2f} s")
    clock.lap("2 (build)")

    # 3. kernels
    from repro_torch import sim
    from repro_torch.kernels import fedagg as fedagg_mod, ops
    from repro_torch.sim import engine as engine_mod
    eng_t0 = time.perf_counter()
    # The digits are memoized for phase 33's engines.
    load_dataset = functools.cache(engine_mod.load_dataset)
    with patched(engine_mod, "load_dataset", lambda _: load_dataset):
        eng = sim.RoundEngine(sim.SimConfig(max_rounds=16))
    log("slice", f"engine built in {time.perf_counter() - eng_t0:.2f} s: "
        f"{eng.n_sats} satellites, {eng.trainer.model.count_params()} "
        f"params, {len(eng.fd.labels)} train / {len(eng.eval_labels)} eval "
        f"samples, device {eng.device}")
    leaf_shapes = {k: d.shape for k, d in eng.trainer.model.defs().items()}
    entry = phase_kernels(torch, fedagg_mod, ops, leaf_shapes, eng.n_sats)
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import rwkv6_wkv as wkv_mod
    from repro_torch.kernels import selective_scan as scan_mod
    kernels = {"fedagg": fedagg_mod.fedagg,
               "flash_attention": fa_mod.flash_attention,
               "rwkv6_wkv": wkv_mod.rwkv6_wkv,
               "selective_scan": scan_mod.selective_scan}
    phase_guard(torch, kernels, fa_mod, wkv_mod, scan_mod)
    clock.lap("3 (kernels, guard)")

    # 4. card vs CPU
    phase_card_vs_cpu(torch, eng, sim)
    clock.lap("4 (card vs CPU)")

    # 5. the slice, on the card; counts zeroed just before, read after.
    # Each block's params are kept for phase 33.
    ref_blocks = []
    record_blocks(eng.executor, ref_blocks)
    torch.cuda.reset_peak_memory_stats()
    fedagg_mod.fedagg.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fedagg_mod.fedagg.launches
    del eng.executor.run_block
    ref_history = list(res.history)
    entry["launches"] = launches
    for t_h, rnd, acc in res.history:
        log("slice", f"round {rnd:3d}  t={t_h:.4f} h  acc={acc:.4f}")
    log("slice", f"{res.rounds} rounds in {wall:.3f} s: "
        f"{wall / max(res.rounds, 1):.4f} s/round (plan + train + fold + "
        f"eval, the first block included); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"card now {nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")
    n_leaves = len(leaf_shapes)
    # The default 72 h horizon holds 15 FedHAP rounds, so max_rounds=16
    # ends at the horizon: one full block of 8 and one of 7 (its last
    # slot an invalid, carried-through round).
    if res.rounds <= eng.cfg.plan_block:
        raise AssertionError(f"expected more than one block of rounds, "
                             f"ran {res.rounds}")
    # One fold per round, all of the CNN's leaves in one launch.
    if launches != res.rounds:
        raise AssertionError(f"fedagg launched {launches} times in "
                             f"{res.rounds} rounds; expected {res.rounds} "
                             f"(one launch per fold of {n_leaves} leaves)")
    accs = [a for _, _, a in res.history]
    if not all(math.isfinite(a) for a in accs) or accs[-1] <= 0.10:
        raise AssertionError(f"accuracies not finite or not above chance: "
                             f"{accs}")
    log("slice", f"fedagg launches on the main path: {launches} "
        f"(1 per round, each folding all {n_leaves} leaves)")
    clock.lap("5 (slice)")

    # 6. where a round's device time goes (after the counts were read)
    phase_profile(torch, eng)
    del eng
    clock.lap("6 (profile)")

    # 7. the flash kernel against its plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    flash_entry = phase_flash(torch, fa_mod)
    split_entry = phase_flash_split(torch, fa_mod)
    clock.lap("7 (flash)")

    # 8-10. qwen3-0.6b: card vs CPU, decode vs prefill, serve
    flash_entry["launches"] = lm_slice(
        torch, Transformer, get_config, serve, "qwen3-0.6b", kernels,
        "flash_attention", "flash_fwd",
        {"position skip": (fault_position_skip, True),
         "lost slot": (fault_lost_slot, True)},
        {"float32": LM_F32_TOL, "bfloat16": dict(atol=DECODE_BF16_ATOL,
                                                 rtol=0)},
        ("lm", "decode", "serve"), own_fan_in=False, clock=clock,
        numbers=(8, 9, 10), variant="tc")

    # 11. the WKV kernel against its plain version
    wkv_entry = phase_wkv(torch, wkv_mod)
    clock.lap("11 (wkv)")

    # 12-14. rwkv6-3b: card vs CPU, decode vs prefill, serve
    wkv_entry["launches"] = lm_slice(
        torch, Transformer, get_config, serve, "rwkv6-3b", kernels,
        "rwkv6_wkv", "wkv_fwd",
        {"decay skipped": (fault_decay_skipped, False),
         "stale token shift": (fault_stale_token_shift, True)},
        RWKV_DECODE_TOL, ("rwkv", "rwkv-decode", "rwkv-serve"),
        own_fan_in=True, clock=clock, numbers=(12, 13, 14))

    # 15. the selective-scan kernel against its plain version
    scan_entry = phase_scan(torch, scan_mod)
    clock.lap("15 (scan)")

    # 16-18. jamba-v0.1-52b at full width, one period of its four (8 of 32
    # layers: 13,295,235,072 params, 24.76 GiB in bf16; the whole model's
    # 96 GiB does not fit one card): card vs CPU block by block, decode vs
    # prefill, serve. At own fan-in (ROADMAP Queue C: the reference's
    # init saturates dt at one period).
    import dataclasses
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"), num_layers=8)
    phase_jamba_blocks(torch, Transformer, jamba, "jamba")
    clock.lap("16 (jamba)")
    params = phase_jamba_decode(torch, Transformer, jamba, ops,
                                "jamba-decode")
    clock.lap("17 (jamba-decode)")
    model = Transformer(jamba)
    counts, tokens, _ = phase_serve(
        torch, model, params, serve, kernels,
        {"selective_scan": 7, "flash_attention": 1, "flash_attention.tc": 1},
        "jamba-serve")
    scan_entry["launches"] = counts["selective_scan"]
    phase_jamba_prefill_reads(torch, model, params, serve, tokens, ops,
                              fa_mod)
    phase_serve_profile(torch, model, params, serve, tokens, "scan_fwd")
    del params, model
    torch.cuda.empty_cache()
    clock.lap("18 (jamba-serve)")

    # 19. the routed strategies on the card; counts zeroed per run.
    routed = phase_routed(torch, sim, fedagg_mod)
    entry["launches_routed"] = {k: v["launches"] for k, v in routed.items()}
    clock.lap("19 (routed)")

    # 20. one cycle block, card against CPU
    phase_cycle_card_vs_cpu(torch, sim)
    clock.lap("20 (cycle card vs CPU)")

    # 21. the tick baselines on the card; counts zeroed per run. Then the
    # fold at the first flush's S.
    ticks = phase_ticks(torch, sim, fedagg_mod)
    entry["launches_ticks"] = {k: v["launches"] for k, v in ticks.items()}
    entry["fold_flush"] = phase_fold_flush(torch, fedagg_mod, leaf_shapes,
                                           ticks["fedspace"]["rows"][0])
    clock.lap("21 (ticks)")

    # 22. checkpoint and resume on the card; a card checkpoint on the CPU
    phase_resume(torch, sim)
    clock.lap("22 (resume)")

    # 23. the flash backward kernel against its plain version
    bwd_entry = phase_flash_bwd(torch, fa_mod, flash_entry["ms"], ptxas)
    clock.lap("23 (flash-bwd)")

    # 24. one training round, card vs CPU (4 layers, f32)
    phase_train_card_vs_cpu(
        torch, Transformer, get_config, "qwen3-0.6b", 4, 24,
        ("Δ not subtracted", fa_mod, "flash_attention_bwd", no_delta))
    clock.lap("24 (train card vs CPU)")

    # 25. the training slice at full width; counts zeroed per round.
    trained = phase_train(torch, Transformer, get_config, kernels,
                          fedagg_mod, ops)
    bwd_entry["launches"] = trained["launches"]["flash_attention.bwd"]
    flash_entry["launches_train"] = trained["launches"]["flash_attention"]
    entry["launches_train"] = trained["launches"]["fedagg"]
    entry["fold_lm"] = trained["fold"]
    clock.lap("25 (train)")

    # 26. the sanitizer: all 8 strategies' fused loops at full width,
    # each against a plain run; three planted faults. Counts zeroed per
    # run.
    sanitize = phase_sanitize(torch, sim, fedagg_mod)
    entry["launches_sanitized"] = {k: v["launches"]
                                   for k, v in sanitize.items()}
    clock.lap("26 (sanitize)")
    # 27. the WKV backward kernel against its plain version
    wkv_bwd_entry = phase_wkv_bwd(torch, wkv_mod, ptxas)
    clock.lap("27 (wkv-bwd)")

    # 28. the scan backward kernel; a full-width jamba Mamba block's
    # gradients, kernels vs plain
    scan_bwd_entry = phase_scan_bwd(torch, scan_mod, ptxas)
    scan_bwd_entry["block"] = phase_mamba_block_grads(
        torch, Transformer, get_config, ops, scan_mod)
    clock.lap("28 (scan-bwd)")

    # 29. training card vs CPU: rwkv6-3b (2 layers, f32), then one round
    # of the reduced jamba, whose scan launches are the backward's count
    phase_train_card_vs_cpu(
        torch, Transformer, get_config, "rwkv6-3b", 2, 29,
        ("decay skipped in the WKV backward", wkv_mod, "rwkv6_wkv_bwd",
         wkv_decay_skipped), phase="rwkv-train-cvc")
    jamba_round = phase_jamba_round_card_vs_cpu(torch, Transformer,
                                                get_config, kernels)
    scan_bwd_entry["launches"] = jamba_round["counts"]["selective_scan.bwd"]
    clock.lap("29 (train card vs CPU, the other families)")

    # 30. the slice: rwkv6-3b federated training at full width; counts
    # zeroed per round.
    rwkv_train = phase_train(torch, Transformer, get_config, kernels,
                             fedagg_mod, ops, arch="rwkv6-3b",
                             phase="rwkv-train", needle="wkv_bwd")
    wkv_bwd_entry["launches"] = rwkv_train["launches"]["rwkv6_wkv.bwd"]
    wkv_bwd_entry["train_slice"] = {k: v for k, v in rwkv_train.items()
                                    if k != "launches"}
    wkv_entry["launches_train"] = rwkv_train["launches"]["rwkv6_wkv"]
    entry["launches_train_rwkv"] = rwkv_train["launches"]["fedagg"]
    clock.lap("30 (rwkv-train)")
    torch.cuda.empty_cache()

    # 31. MLA and the encoder-decoder stack: card vs CPU, decode vs
    # forward with planted faults
    phase_zoo_card_vs_cpu(torch, Transformer, get_config)
    t31 = clock.lap("31 (zoo)")

    # 32. the seven architectures served at full width; counts zeroed per
    # prefill
    zoo = phase_zoo_serve(torch, Transformer, get_config, serve, kernels)
    split_entry["launches"] = zoo["minicpm3-4b"]
    flash_entry["launches_zoo"] = zoo
    flash_entry["split"] = split_entry
    log("time", f"phases 31-32 in {t31 + clock.lap('32 (zoo-serve)'):.1f} "
        f"s")

    # 33. the mesh path on a 1-rank NCCL group: the sharded FedHAP run
    # held bit for bit against phase 5's, a sanitized sharded block, and
    # launch.train's mesh path against its single-device round
    mesh = phase_mesh(torch, sim, fedagg_mod, ref_history, ref_blocks,
                      load_dataset)
    entry["launches_mesh"] = {"fedhap": mesh["launches"],
                              "train": mesh["train"]["fedhap_fused"][
                                  "launches"]}
    del ref_blocks
    clock.lap("33 (mesh)")
    log("done", f"phases 1-33 in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [entry, flash_entry, wkv_entry,
                                  scan_entry, bwd_entry, wkv_bwd_entry,
                                  scan_bwd_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
