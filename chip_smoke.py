#!/usr/bin/env python3
"""Drive the PyTorch port of BrePartition (src/repro_torch) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py                   # one CUDA card, full size
    python3 chip_smoke.py --cpu-rehearsal   # no card: tiny sizes, plain versions

Phases:

1. The card's name and power limit (nvidia-smi), TF32 off, and the build of
   the ten CUDA kernels (seven sources; fp32 and int8 entry points of the
   search kernels, fp32 and bf16 kernels of #10) from
   src/repro_torch/kernels/csrc with nvcc; the HGMMA (wgmma) instructions
   of each function in the built library and the 128-bit global loads of
   the int8 refine kernel (#8), where cuobjdump is present.
2. Each kernel against its plain PyTorch version on the card at ragged
   shapes (admit masks bit-equal; the prune-only masks #5 and #6 also
   bit-equal to the fused kernels' admit, #5 also over an unaligned row
   span; the block-list entries of #3, #4, #5 and #6 over non-contiguous
   lists with a short last block, #5's also bit-equal to #3's admit and
   #6's to #4's, and #1 and #2 over unaligned row spans;
   #8 on unaligned codes, and a (query, row) pair's bits the same at
   b = 1, at another position and unaligned); the int8 quantizer on the
   card against the CPU's, bit for bit; and the whole search on the card
   against the same search on the CPU for every Bregman family on a small
   index, in both storage tiers.
3. Audio (n=54,387, d=192, exponential) and 4. Deep (n=1,000,000, d=256,
   exponential), from PAPER_DATASETS at full size, each in the fp32 tier
   and then the int8 tier: ``build_index`` with m=None (Theorem 4), PCCP
   and ``quantize``, then ``knn_batch`` on 50 queries with k=10.  Every
   kernel's launch count is set to 0 just before the search and read just
   after; each kernel of the tier must be above 0 and the other tier's at
   0, the filter (#1, #2) and the fused prune (#3, #4) launched once an
   attempt, and no prune-only kernel in the search's profile.  The ids
   are held against ``brute_force_knn`` over the index's point set
   (``rows_view``) on the card.  Each kernel is then held against its
   plain version, and timed with CUDA events beside its bound, at the
   shapes that search gave it; #1-#6 also at the grouped search's shape
   (one attempt's rows in one launch).  The grouped search must equal the
   per-block loop (a group cap below one block) bit for bit, stats
   included, in both tiers; both loops' phase times and search times are
   taken in turns.  The unfused comparator (``fused=False``, kernel #5 or
   #6 in place of #3 or #4) must give the fused search's results bit for
   bit, its prune-only kernel launched once an attempt, and equal its own
   per-block loop bit for bit, gate stats included.  On Deep, the index
   is then wrapped in a ``TieredPointStore`` holding 40% of its cold
   bytes on the card: ``knn_batch`` through it (counts reset just before,
   read just after) must return the resident ids, and a fixed-budget
   search must equal the resident one bit for bit, with #5 or #6
   launched once a Stage B window; Stage B in windows must equal Stage B
   a block at a time (``tiered.WINDOW_BYTES`` below one block; Stage A
   unchanged) bit for bit, stats and the order of the store's block
   fetches included, both timed in turns; #5 or #6 over the first
   window's pooled corner rows, as Stage B launches it, must equal its
   plain version and the fused kernel's admit bit for bit, and is timed.
5. A blob corpus where the envelope gate rejects blocks (the settings of
   benchmarks/bench_tiered.py at n = 2^20): a cold and a warm pass
   through the store, bit-equal to resident search.
6. Kernel #10 (flash attention: fp32 on the fp32 cores, bf16 on the
   tensor cores) against its plain version on the seven cases of
   tests/test_kernels.py::test_flash_attention in fp32 and bf16, then at
   the model's shapes (prefill at S = 2048, the kNN-LM corpus batch, the
   serving prefill of 8 x 512) in fp32 and bf16, also against the plain
   version on fp32 upcasts to about the output's rounding, beside a
   planted fault's reading (a dropped kv tile of the kernel under test:
   32 keys in fp32, 64 in bf16); bf16 timed beside
   SDPA and its bound.  Then at recurrentgemma-2b's heads (10 q heads, 1
   kv head, D = 256: the bf16 kernel's one-warpgroup blocks): its corpus
   batch (8 x 1024), its serving prefill (8 x 512) and 4096 keys at its
   window of 2048, each in fp32 and bf16 against the plain version and
   on fp32 upcasts, with the planted fault, both dtypes timed beside SDPA
   (none at the window) and the bound.  Then at qwen3-moe-30b-a3b's
   corpus batch (8 x 1024, 32 q heads over 4 kv heads, D = 128), the same
   way, timed beside SDPA and the bound.  Then at phase 15's shapes, in
   fp32 and bf16, each against the plain version and on fp32 upcasts with
   the planted fault, both dtypes timed beside SDPA and the bound:
   whisper-tiny's encoder batch (8 x 1500 frames, 6 heads of 64,
   non-causal) and qwen2-vl-72b's corpus batch (8 x 1024, 64 q heads over
   8 kv heads of 128).
7. kNN-LM on starcoder2-3b at full width (30 layers, random weights from a
   seeded generator on the card): ``build_datastore`` over a seeded
   64 x 1024-token corpus (65,472 keys of 3072 fp32, squared Euclidean,
   M*), then the ``Engine`` with ``KNNLMHook`` serves 16 prompts of 512
   tokens in 8 slots, 32 greedy tokens each.  #10 must launch once a layer
   for every forward batch and prefill, each launch its bf16 tensor-core
   kernel, the hook's search through #1, #3 and #7; the hook's ids on
   the last tick must equal brute force, the engine's tokens an offline
   greedy loop, and the fp32 first-token logits through #10 those
   through the plain attention (a dropped kv tile's reading beside the
   limit).
8. Kernel #9 (the PCCP correlation's Gram) on the datastore's keys: the
   PCCP partition from its correlations; the Gram against its plain
   version (beside a planted fault's reading: 128 missing rows), the
   correlations against the plain version and numpy float64,
   ``pccp_order`` equal to numpy's at the build's M and at M = 32; the
   Gram timed beside ``torch.mm``.
9. Single-query search, the mask oracle and recall calibration, on the
   indexes phases 2-5 built: each index's checks run at the end of its
   own drive, before it is freed, so no index stays on the card into a
   later peak.  On Audio and Deep in both tiers, the first 4 queries: ``knn`` against brute force (phase 3's near-tie rule);
   ``knn_search`` and ``knn_search_approx`` (p = 0.9) at the batch's final
   budget against the rows of ``knn_search_batch`` /
   ``knn_search_batch_approx`` (ids, exact, num_candidates equal, dists
   within 1e-5, their bits recorded); one ``knn_search`` launches #1, #5
   and #7 (int8: #2, #6, #8) once each and nothing else; those kernels at
   its q = 1 shapes against their plain versions (masks bit-equal),
   timed; one ``knn_search`` and one ``knn`` timed on the host.  The
   oracle ``knn_search_batch_reference`` (the materialized (n, q) mask)
   bit-equal to the streamed search on the blob corpus (a mixed mask) and
   Audio int8, exact and at p_guarantee = 0.9.  ``ensure_calibration``
   (k = 10, 64 queries, the default grid) on the blob corpus and Audio
   int8, the fit timed: a non-decreasing curve to p = 1, with recall 1.0
   there or misses only at near ties with brute force;
   ``target_recall`` 0.9 and 0.99 bit-equal to ``approx_p`` at the
   resolved p, with recall against the exact ids at least the expected
   recall less 0.15; phase 2's small index fitted on the card equal to
   the CPU's fit, in both tiers (run in phase 2).
10. The mutable index (``core/segments.py``), at the end of each drive
   before its index is freed.  Deep, both tiers, on phase 4's index:
   ``SegmentedForest.from_forest``, the last 100,000 ids deleted and the
   same rows inserted again in 10 batches (new ids n ... n + 99,999):
   ``knn_batch`` equals phase 4's result through the id map (ids, exact,
   num_candidates, dists bit for bit); 50,000 more ids deleted (half
   sealed, half appended, the first 4 queries' top 10 among them): the
   ids equal brute force over the live rows (phase 3's near-tie rule),
   no deleted id surfaces, ``knn`` equals the batch rows, the tier's
   kernels launched once an attempt; fp32: a ``TieredPointStore`` at 40%
   of the mutated index's cold bytes pins the append rows' blocks and is
   bit-equal to the resident search; ``decide()`` recorded;
   ``compact("merge")`` bit-equal at budget live_n (int8: the codes
   too); fp32 ``compact("rebuild")`` the same ids and dists.  Audio, both
   tiers: two mutable copies, 10% deleted and 5% inserted alike, rebuild
   to bit-equal tables.  The blob corpus: its last tenth deleted and
   reinserted, bit-equal to phase 5's resident search through the id map
   before and after a merge, the gate's blocks recorded.  kNN-LM, after
   serving: ``grow`` by the keys of 8 more sequences (one forward
   through #10), ``evict`` 4,096 keys; the hook's ids equal brute force
   over the live keys, a new key finds itself and its token leads the
   mix at lambda 0.5, and a second call is bit-equal.  Inserts,
   deletes, ``view()``, ``decide()``, merge and rebuild are timed.
11. The serving front end (``serve/retrieval.py``) on those indexes:
   a) Deep as a tenant in both tiers, b) seeded faults, c) the blob
   corpus as a tiered tenant, d) a wall-clock run, e) the kNN-LM hook
   through a service, f) the serving launcher at full width, g) the
   autotuner's table and a sweep cell.
12. The distributed search (``dist/knn.py``) at world size 1 over NCCL
   (a group on an in-process store, ``NCCL_SOCKET_IFNAME=lo`` set in
   this process's environment; started and ended around each step, so
   none outlives it into another phase), each step in its drive: a) Deep in both tiers,
   ``shard_index`` (the forest's own tensors) and ``distributed_knn`` on
   phase 4's 50 queries bit-equal to ``knn_search_batch`` at phase 4's
   final budget; from n/16 the ladder ends exact with phase 4's ids,
   #1/#3/#7 (int8 #2/#4/#8) launched once a shard-attempt, host ms
   beside phase 4's; b) at ``approx_p`` 0.9 bit-equal to
   ``knn_search_batch_approx``; c) phase 10's mutated Deep index after
   its deletes, sharded, bit-equal to ``knn_batch`` at budget live_n, no
   deleted id; d) 11a's 48 Deep fp32 requests through a ``mesh=`` tenant,
   equal to 11a's responses; e) ``linear_scan``, ``BBTree`` (both
   bounds) and ``VAFile`` on the host over Audio's first 16,384 rows,
   their ids against brute force on the card (phase 3's near-tie rule),
   build s and ms a query beside a card index over the same rows.
13. The recurrent families at full width, with seeded random weights and
   the hook: recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local attention
   of 10 q heads and 1 kv head at D = 256, window 2048) builds a
   datastore over phase 7's 64 x 1024 corpus (65,472 keys of 2560 fp32)
   and serves phase 7's 16 prompts of 512 tokens in 8 slots, 32 greedy
   tokens each; #10 must launch once an attention layer for every
   forward batch and prefill, each its bf16 kernel, and the hook's
   search #1, #3 and #7; phase 7's checks (tokens against an offline
   greedy loop, the hook's last tick against brute force, the fp32
   first-token logits through #10 against the plain attention beside a
   dropped kv tile); 8 requests of 8 tokens admitted into slots that 8
   others used must start from a fresh engine's recurrent states bit
   for bit and give its tokens, where an engine that keeps the old
   states must not (the engine zeroes an admitted slot's state); phase 8's
   checks of #9 on its keys.  Then rwkv6-1.6b (24 RWKV layers, no
   attention) the same way over 16 x 1024 corpus tokens, with #10 at 0.
   Build s and peak bytes, ms a forward batch, prefill ms, decode and
   hook ms a tick and tokens/s are recorded.
14. The MoE FFN (``models/moe.py``) and the dense configs at full width,
   seeded weights: qwen3-moe-30b-a3b (d_model 2048, 32/4 heads of 128,
   128 experts top-8 of moe_d_ff 768, vocab 151936) with its depth cut
   to 16 of 48 layers (fp32 weights: 42.4 GB) builds a datastore over
   phase 7's 64 x 1024 corpus (65,472 keys of 2048 fp32) and serves
   phase 7's 16 prompts of 512 tokens in 8 slots, 32 greedy tokens each,
   with the hook; #10 must launch once an attention layer for every
   forward batch and prefill, each its bf16 kernel, and the hook's
   search #1, #3 and #7; phase 7's checks (tokens against an offline
   greedy loop of the engine's batches, so every dispatch group holds
   the same tokens; the hook's last tick against brute force; the fp32
   first-token logits through #10 against the plain attention beside a
   dropped kv tile, the experts chosen in both runs compared first); one
   MoE layer in fp32 on the card against the same layer on the CPU over
   a prefill's hidden states (the same experts, the same tokens dropped,
   outputs within 1e-5 of the largest), and on the card the same input
   through EP_RANKS model ranks' expert-parallel shares of that layer
   (``moe.apply_moe_share``, each rank's E / 8 experts), summed in rank
   order against the whole layer (the same experts, within 1e-5 of the
   largest output); phase 8's checks of #9 on its keys.  A route that differs between two runs is excused only at a
   near tie (the token's K-th and (K+1)-th router probabilities within
   ``ROUTE_NEAR_TIE``); the logits are then held against the plain
   attention run with the kernel run's experts.  Then
   llama4-scout-17b-a16e, qwen2.5-32b, qwen3-32b and phi3-medium-14b at
   full width and depth 2: the parameter count, one fp32 prefill through
   #10 against the plain attention under the same 1e-5 rule (#10 at GQA
   ratios 5, 5, 8 and 4), and the card's memory back where it was before
   the next config.  Build s and peak bytes, ms a forward batch, prefill
   ms, decode and hook ms a tick and tokens/s are recorded.
15. The encoder-decoder and M-RoPE at full width, seeded weights, each
   through ``model_drive`` (phase 7's corpus and traffic with the hook,
   phase 7's checks) and then phase 8's checks of #9 on its keys:
   whisper-tiny at full size (4 + 4 layers, d_model 384, 6 heads of 64,
   vocab 51865; 1500 zero frames, the stubbed frontend's output): #10
   launches 8 times a forward batch and a prefill (4 non-causal encoder
   layers over 1500 frames, 4 causal decoder layers), each its bf16
   kernel; cross attention and decode are plain; besides the tokens,
   every sampling step's hooked logits of the offline greedy loop must
   equal the engine's bit for bit (seeded whisper weights decode one
   token over and over, so equal tokens alone prove little).  Then
   qwen2-vl-72b (d_model 8192, 64/8 heads of 128, d_ff 29568, vocab
   152064, QKV bias, M-RoPE sections (16, 24, 24) at three equal position
   components, 256 zero patch embeddings in place of the first tokens of
   every prefill and corpus row) with its depth cut to 12 of 80 layers
   (``QWEN2_VL_LAYERS``; 52.1 GB of fp32 weights): 65,472 keys of 8192
   fp32, #10 once a layer, #1/#3/#7 for the hook.
16. Training the dense decoder family (``train/``, ``launch/train.py``):
   a) starcoder2-3b at full size (30 layers, d_model 3072, bf16 compute,
   seeded weights) through ``launch/train.py``'s ``main``: 4 x 4096
   tokens in 2 microbatches (its train_4k shape with the batch cut from
   256), 4 steps; exit 0, every loss finite, the last below the first,
   #10's counters at 0 (training attends through the reference's
   differentiable dispatch: #10 has no backward pass); each step's ms,
   tokens/s and the peak device bytes recorded.  b) One fp32 step (TF32
   off) at full width and 2 layers, 1 x 512 tokens, from one state on the
   card and on the CPU: loss, grad norm, moments and every updated
   parameter within tolerances set from fp32 sums over d = 3072.  c) At
   full width and 2 layers in bf16, 4 steps of 4 x 4096 tokens with a
   checkpoint at step 2 (``train/checkpoint.py``, under build/), restored
   onto the card and stepped again: the losses and the final state
   bit-equal.
17. Training the MoE, recurrent, encoder-decoder and VLM families (seeded
   fp32 weights, bf16 compute, the token stream with the launcher's
   M-RoPE positions and zero stub inputs), each run held to 16a's checks
   (exit 0 where the launcher runs it, every loss and aux loss finite,
   the last loss below the first, #10 at 0, the card's memory back
   afterwards) with step ms, tokens/s and peak bytes recorded: a)
   rwkv6-1.6b at full size (24 layers) and b) recurrentgemma-2b at full
   size (26 layers, local attention through the chunked plain dispatch)
   through ``launch/train.py``, 4 x 4096 tokens in 2 microbatches, 4
   steps; c) qwen3-moe-30b-a3b at full width, 4 of 48 layers, 4 x 4096
   in 2 microbatches, 3 steps through ``make_train_step``, its aux loss
   positive; d) whisper-tiny at full size, 8 x 448 decoder tokens over
   1500 zero frames, 5 steps through the launcher, then 16c's restart
   at that size; e) qwen2-vl-72b at full width, 1 of 80 layers, 1 x
   2048 tokens with its 256 zero patch embeddings and M-RoPE positions,
   2 steps; f) 16b's card-against-CPU step for each family's reduced
   config and for rwkv6-1.6b and qwen3-moe-30b-a3b at full width and one
   layer on 1 x 256 tokens (an MoE config's experts compared first: a
   flip only at a near tie, the card's step then replayed with the CPU's
   experts).
18. Sharded training and the dist/ substrates at world size 1, over one
   NCCL group (gloo in a CPU rehearsal) started and ended around the
   phase: a) the ring all-gather and reduce-scatter matmuls, int8
   compression with error feedback and the pipeline schedule at p = 1,
   each equal to its oracle bit for bit; b) ``make_train_step(...,
   mesh=)`` on a (1, 1) ("data", "model") mesh against the mesh-less step
   for reduced starcoder2-3b and qwen3-moe-30b-a3b in fp32, two steps,
   metrics and state bit-equal; c) starcoder2-3b at 16a's size through
   the sharded step on a (1,) data mesh, 16a's schedule and batches,
   SHARDED_STEPS steps: 16a's checks but the descent (16a's third loss
   is above its first), its losses against 16a's first
   three (bit-equal, or within TRAIN_LOSS_RTOL), step ms, tokens/s and
   peak bytes beside 16a's (DTensor's dispatch on one card).  No kernel
   is on this path.
19. The dry run (``launch/dryrun.py``, ``launch/lowering.py``,
   ``launch/cost_analysis.py``), its runs subprocesses on the host with
   no card visible, started at phase 13: a) ``python -m
   repro_torch.launch.dryrun --arch starcoder2-3b`` and ``--arch
   qwen3-moe-30b-a3b`` at the (32, 8) production mesh: their three cells
   each counted, each one's peak, FLOPs, bytes and collective bytes
   above 0 and its model FLOPs the formula's (6 or 2 x active parameters
   x tokens), the MoE's ``bmm`` FLOPs within ``moe_bmm_bounds`` (its
   experts split over ``model``: each rank's expert products an eighth
   of the layer's); each cell's per-device peak and whether it fits 80
   GB printed (the dry run's counts on ``meta``).  b)
   The dry run at world size 1 against the card, starcoder2-3b at full
   width: 16a's train cell (4 x 4096 in 2 microbatches) against 16a's
   own peak in this run; prefill at 1 x 32768 with bf16 serving params
   through ``sharded_prefill`` on a (1, 1) mesh over phase 12's kind of
   group (#10 at S = 32768, once a layer), and decode at 8 x 32768
   through ``sharded_decode``, each under the same cost count on real
   tensors: FLOPs, bytes and collective bytes equal to the dry run's, the
   prefill's hidden state and caches bit-equal to the mesh-less
   prefill's, and each cell's dry-run peak within PEAK_RTOL of
   ``max_memory_allocated`` (reset before the cell, less what was live
   beside its arguments), each ratio printed; then #10 at the prefill's
   shape (1 x 24/2 x 32768 x 128, causal) through phase 6's check: its
   last FLASH_CHECK_ROWS queries (end-aligned, against all the keys)
   against the plain version in bf16 and on fp32 upcasts, beside a
   dropped kv tile's reading; timed beside SDPA (``enable_gqa``) and its
   bound by the pairs it attends.

The last line is ``{"ok": true, "device": {...}}``.

The line before the last holds the kernel table as JSON, the line before
that the nvidia-smi name and power limit.  The full record goes to
build/chip_smoke.json (``--out`` to change it).  The script exits with a
code other than 0, and prints no result, when there is no CUDA card
(unless --cpu-rehearsal is given; the flag never applies when a card is
present) or when it does not stand in a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "src" / "repro_torch"
K = 10
NUM_QUERIES = 50
BLOCK_ROWS = 4096
# Published peaks of one H100 SXM at its 700 W limit: HBM3 bandwidth and
# fp32 outside the tensor cores (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Dense bf16 on the tensor cores (NVIDIA's data sheet).
BF16_OPS_PER_S = 989e12
EPS32 = 2.0 ** -23
# Calls queued behind one sleep kernel when timing (time_calls); well under
# the launches CUDA queues before the host blocks.
TIME_GROUP = 32
# The kNN-LM phase: starcoder2-3b at full width over a seeded corpus of
# CORPUS_SEQS x CORPUS_LEN tokens (65,472 keys of 3072 fp32), serving
# NUM_REQUESTS prompts of PROMPT_LEN tokens in SLOTS slots.
SEED = 0
CORPUS_SEQS, CORPUS_LEN = 64, 1024
NUM_REQUESTS, SLOTS, PROMPT_LEN, MAX_SEQ, NEW_TOKENS = 16, 8, 512, 1024, 32
KNN_K = 8
LOGITS_BATCH = 2
# Phase 13's rwkv6-1.6b datastore: sequences of CORPUS_LEN tokens (a
# quarter of phase 7's corpus; its time mix runs about five times longer a
# token than recurrentgemma-2b's forward).
RWKV_CORPUS_SEQS = 16
PROFILE_TOKENS = 8
# Phase 13's reused-slot check: prompts short enough that a recurrent state
# left by the slot's last request would still show after the prefill.
REUSE_PROMPT_LEN, REUSE_NEW_TOKENS = 8, 4
# Phase 14: qwen3-moe-30b-a3b's depth, cut so its fp32 weights (10.6e9
# parameters, 42.4 GB) fit the card with the datastore beside them; the
# configs checked at full width and depth 2.
MOE_LAYERS = 16
DEPTH2_ARCHS = ("llama4-scout-17b-a16e", "qwen2.5-32b", "qwen3-32b",
                "phi3-medium-14b")
# A token whose experts differ between two runs of the same layer is
# excused only where its K-th and (K+1)-th router probabilities lie within
# this of each other: the two runs' fp32 sums in another order move a
# probability by about 1e-7 (PERF.md §2).
ROUTE_NEAR_TIE = 1e-5
# A subspace count at which pccp_order reads the correlations (phase 8).
PCCP_PROBE_M = 32
# Phase 9: the queries of a single-query check, the guarantee of its
# approximate search and of the oracle's, the held-out queries of a
# calibration fit and the recall targets it is inverted at.
SINGLE_QUERIES = 4
SINGLE_P = 0.9
CALIBRATION_QUERIES = 64
RECALL_TARGETS = (0.9, 0.99)
# Phase 10: insert batches of the delete-and-reinsert update, the kNN-LM
# datastore's grow (sequences of CORPUS_LEN tokens) and eviction.
MUTATION_BATCHES = 10
MUTATION_SEQS = 8
EVICT_KEYS = 4096
# Phase 12's baselines: the rows of Audio's seeded data they run on (its
# first rows), so the host's tree builds stay within a minute.
BASELINE_ROWS = 16384
# Phase 15: qwen2-vl-72b's depth, cut so its fp32 weights (13.0e9
# parameters, 52.1 GB) fit the card beside the hook's refine gather of
# 8 x 65,472 keys of 8192 fp32 (17.2 GB).
QWEN2_VL_LAYERS = 12
# #10 at phase 15's shapes (phase 6): whisper-tiny's encoder over a corpus
# batch and qwen2-vl-72b's corpus batch, (b, h, kh, sq, skv, d, causal).
PHASE15_SHAPES = {"whisper_encoder": (8, 6, 6, 1500, 1500, 64, False),
                  "qwen2vl_corpus_batch": (8, 64, 8, 1024, 1024, 128, True)}
# Phase 16: starcoder2-3b's training run through the launcher at full size
# (the config's train_4k shape, its batch cut from 256 to 4 sequences; 4
# steps, cut from 10 to 6 to give phase 17 room in the run's 1200 s, and
# to 4 for phase 18), then the card against the CPU and the restart at
# full width and depth 2.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 4096, 2, 4
# Phase 18c: 16a's run again through the sharded step on a (1,) data mesh,
# its first steps.
SHARDED_STEPS = 3
TRAIN_SMALL_LAYERS = 2
TRAIN_COMPARE_SEQ = 512
TRAIN_RESTART_STEPS, TRAIN_SAVE_AT = 4, 2
# A training run's sequence length in a CPU rehearsal, at most.
TRAIN_REHEARSAL_SEQ = 64
# The card's fp32 step against the CPU's: a gradient may differ by the
# worst-case rounding of two stacked fp32 contractions over d = 3072 terms
# (d x eps32 each) of its leaf's largest gradient; the loss by one.
TRAIN_D = 3072
TRAIN_GRAD_TOL = 2 * TRAIN_D * 2.0 ** -23
TRAIN_LOSS_RTOL = TRAIN_D * 2.0 ** -23
# Phase 17: each family trained on the card, label -> (arch, layers (None:
# the full depth, through launch/train.py; else the depth cut to fit the
# card's 80 GB, through make_train_step), batch, seq, microbatches, steps).
# qwen3-moe-30b-a3b at 4 of 48 layers holds 3.12e9 parameters (49.8 GB of
# AdamW state; all 48 would need 488 GB), qwen2-vl-72b at 1 of 80 3.37e9
# (53.9 GB).  The MoE, recurrent and VLM runs take starcoder2-3b's 4 x
# 4096 (16a's) where the memory allows; whisper-tiny its 448-token decoder
# context.
FAMILY_RUNS = {
    "17a": ("rwkv6-1.6b", None, 4, 4096, 2, 4),
    "17b": ("recurrentgemma-2b", None, 4, 4096, 2, 4),
    "17c": ("qwen3-moe-30b-a3b", 4, 4, 4096, 2, 3),
    "17d": ("whisper-tiny", None, 8, 448, 2, 5),
    "17e": ("qwen2-vl-72b", 1, 1, 2048, 1, 2),
}
# Phase 17f: one fp32 step on the card against the CPU, (arch, layers
# (None: the reduced config), batch, seq, microbatches): each family's
# reduced config, then two at full width and one layer.
CARD_VS_CPU = [(arch, None, 2, 32, 2) for arch in (
    "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "recurrentgemma-2b",
    "rwkv6-1.6b", "whisper-tiny", "qwen2-vl-72b")] + [
    ("rwkv6-1.6b", 1, 1, 256, 1), ("qwen3-moe-30b-a3b", 1, 1, 256, 1)]
# The indexes phase 9 runs the oracle and the calibration on.
ORACLE_LABELS = ("blobs", "audio int8")
# The reference's rule (tests/test_calibration.py): measured recall at a
# target at least the curve's expected recall less this.
RECALL_SLACK = 0.15
# Phase 19: the dry run of starcoder2-3b at the (32, 8) production mesh
# (19a), and at world size 1 held against the card (19b): 16a's train
# cell, prefill_32k and decode_32k cut in batch only.  A dry-run peak
# must lie within PEAK_RTOL of the card's.  The dry runs are subprocesses
# (touching no card; started at phase 13, so their minutes on the host
# pass while the card works), each given DRYRUN_TIMEOUT seconds.
DRYRUN_ARCH = "starcoder2-3b"
# Phase 14's expert-parallel check: the model ranks of the (32, 8) mesh,
# their shares of one MoE layer run in turn on the one card.
EP_RANKS = 8
# 19a also counts this MoE config's three cells at (32, 8): its experts
# split over ``model``, each rank's expert products an eighth of the
# layer's (``moe_bmm_bounds``).
DRYRUN_MOE_ARCH = "qwen3-moe-30b-a3b"
DRYRUN_PREFILL_BATCH, DRYRUN_DECODE_BATCH = 1, 8
DRYRUN_SEQ = 32768
PEAK_RTOL = 0.10
DRYRUN_TIMEOUT = 600
# #10 at 19b's prefill shape: its plain versions check the last this many
# queries against all the keys (the whole (1, 24, 32768, 32768) logits
# would not fit the card; these take 3.2 GB in fp32).
FLASH_CHECK_ROWS = 1024
# Keys in a kv tile of #10's two kernels: fp32 on the fp32 cores
# (csrc/flash_attention.cu), bf16 on the tensor cores
# (csrc/flash_attention_wgmma.cu).
FLASH_KV_TILE = {"float32": 32, "bfloat16": 64}
# Block lists of #3 and #4 against their plain versions (n, M, q, bn,
# listed blocks): non-contiguous, a short last block, one block, M even
# (70) and chunked (300), two query tiles (q = 65).
BLOCK_LIST_CASES = [(5000, 37, 14, 1024, [0, 2, 4]),
                    (3000, 70, 33, 512, [0, 1, 5]),
                    (2000, 300, 50, 256, [0, 7]),
                    (2000, 33, 65, 384, [0, 2, 5]),
                    (5000, 37, 13, 1024, [4])]
# #10 at recurrentgemma-2b's heads (phase 6): its corpus forward batch, its
# serving prefill, and one sequence past its window of 2048 keys:
# (b, h, kh, sq, skv, d, window).
D256_SHAPES = {"rg_corpus_batch": (8, 10, 1, 1024, 1024, 256, None),
               "rg_prefill_512": (8, 10, 1, 512, 512, 256, None),
               "rg_window_4096": (1, 10, 1, 4096, 4096, 256, 2048)}
# tests/test_kernels.py::test_flash_attention's cases:
# (b, h, kh, sq, skv, d, causal, window).
FLASH_CASES = [
    (2, 4, 4, 64, 64, 32, True, None),
    (1, 8, 2, 64, 64, 32, True, None),
    (2, 4, 1, 32, 32, 16, True, None),
    (1, 4, 4, 64, 64, 32, False, None),
    (1, 4, 2, 64, 64, 32, True, 16),
    (2, 4, 2, 1, 96, 32, True, None),
    (1, 2, 2, 48, 48, 32, True, None),
]


class SmokeFailure(Exception):
    """A phase found a wrong or missing result."""


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


class Smoke:
    def __init__(self, args, torch):
        self.args = args
        self.torch = torch
        self.rehearsal = not torch.cuda.is_available()
        self.dev = torch.device("cpu" if self.rehearsal else "cuda")
        self.record: dict = {"rehearsal": self.rehearsal}
        # Cycles of the sleep kernel that holds the card while the host
        # queues a timed group (about 10 ms at the H100's clock); doubled
        # by ``time_calls`` where that is too short.
        self.sleep_cycles = 20_000_000
        from repro_torch.kernels import (bregman_dist, bregman_fused,
                                         bregman_prune, bregman_ub,
                                         flash_attention, pccp_corr, ref)
        self.ref = ref
        # Each kernel's wrapper module and launch counter.
        self.counters = {
            "bregman_ub_matrix": (bregman_ub, "launches"),
            "bregman_filter_prune": (bregman_fused, "launches"),
            "bregman_refine_batch": (bregman_dist, "launches"),
            "bregman_ub_matrix_quant": (bregman_ub, "launches_quant"),
            "bregman_filter_prune_quant": (bregman_fused, "launches_quant"),
            "bregman_refine_batch_quant": (bregman_dist, "launches_quant"),
            "bregman_prune_mask": (bregman_prune, "launches"),
            "bregman_prune_mask_quant": (bregman_prune, "launches_quant"),
            "flash_attention": (flash_attention, "launches"),
            "pccp_correlation": (pccp_corr, "launches"),
        }
        # #10's two kernels, each with its own count beside the total.
        self.flash_kernels = {"fp32_simt": (flash_attention, "launches_simt"),
                              "bf16_wgmma": (flash_attention,
                                             "launches_wgmma")}
        self._store = None     # the kNN-LM datastore, for phase 8
        # Phase 9's record, filled by the drives of phases 2-5.
        self.single: dict = {"oracle": {}, "calibration": {},
                             "seconds": 0.0}
        # Phase 11's seconds, and phase 10's mutable Deep index, kept for
        # phase 11's compaction-during-search check.
        self.phase11_s = 0.0
        self._mutable_sf = None
        # Phase 12's world-size-1 mesh (started and ended around each of
        # its steps), its record and 11a's responses, which 12d repeats.
        self._mesh = None
        self.phase12: dict = {"seconds": 0.0}
        self._service_rows: dict = {}
        # Phase 19's dry runs: label -> (start time, subprocess).
        self._dryruns: dict = {}

    # -- helpers -------------------------------------------------------
    def sync(self) -> None:
        if not self.rehearsal:
            self.torch.cuda.synchronize()

    def reset_launches(self) -> None:
        for mod, attr in (*self.counters.values(),
                          *self.flash_kernels.values()):
            setattr(mod, attr, 0)

    def flash_launches(self) -> dict:
        """#10's launches since the last reset, by kernel."""
        return {name: getattr(mod, attr)
                for name, (mod, attr) in self.flash_kernels.items()}

    def launches(self) -> dict:
        return {name: getattr(mod, attr)
                for name, (mod, attr) in self.counters.items()}

    def time_calls(self, calls, reps: int) -> float | None:
        """Device ms of one call in ``calls`` (zero-argument callables),
        a mean over ``reps`` passes after a warm pass; None on the CPU
        rehearsal.

        The calls run in groups of at most ``TIME_GROUP``.  Before a group
        the card is held in a sleep kernel while the host queues the whole
        group between two CUDA events; the group counts only if the card
        was still asleep when the host had queued it (the start event not
        yet reached), else the sleep doubles and the group runs again.  So
        the events time the calls back to back on the card, without the
        host's launch cost between them."""
        if self.rehearsal:
            return None
        torch = self.torch
        for call in calls:
            call()
        torch.cuda.synchronize()
        seq = [call for _ in range(reps) for call in calls]
        total = 0.0
        for s in range(0, len(seq), TIME_GROUP):
            group = seq[s:s + TIME_GROUP]
            for _ in range(8):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(self.sleep_cycles)
                start.record()
                for call in group:
                    call()
                end.record()
                queued_in_time = not start.query()
                torch.cuda.synchronize()
                if queued_in_time:
                    break
                self.sleep_cycles *= 2
            else:
                raise SmokeFailure(
                    f"the host could not queue {len(group)} calls within a "
                    f"sleep of {self.sleep_cycles} cycles")
            total += start.elapsed_time(end)
        return total / len(seq)

    def kernel(self, name: str):
        """The CUDA wrapper on the card; the plain version in a rehearsal,
        where no kernel can run.  Each is called with its wrapper's
        arguments, the UB kernels with ``qconst`` appended (the plain
        versions take it in place of ``qsum``)."""
        if self.rehearsal:
            from repro_torch.kernels import ops
            return {"bregman_ub_matrix": lambda *a:
                    ops.bregman_ub_matrix(*a[:2], a[-1], a[3]),
                    "bregman_ub_matrix_quant": lambda *a:
                    ops.bregman_ub_matrix_quant(*a[:6], a[-1], a[7]),
                    "bregman_filter_prune": lambda *a:
                    ops.bregman_filter_prune_block(*a[:4], *a[5:]),
                    "bregman_filter_prune_blocks": lambda *a:
                    ops.bregman_filter_prune_blocks(*a[:4], *a[5:]),
                    "bregman_filter_prune_blocks_quant": lambda *a:
                    ops.bregman_filter_prune_blocks_quant(
                        *a[:12], a[13], a[14], *a[16:]),
                    "bregman_filter_prune_quant": lambda *a:
                    ops.bregman_filter_prune_block_quant(*a[:12], a[13],
                                                         a[14], a[16]),
                    "bregman_refine_batch": ops.bregman_refine_batch,
                    "bregman_refine_batch_quant":
                    ops.bregman_refine_batch_quant,
                    "bregman_prune_mask": ops.bregman_prune_block,
                    "bregman_prune_mask_quant":
                    ops.bregman_prune_block_quant,
                    "bregman_prune_mask_blocks": ops.bregman_prune_blocks,
                    "bregman_prune_mask_blocks_quant":
                    ops.bregman_prune_blocks_quant}[name]
        if name.startswith("bregman_filter_prune_blocks"):
            from repro_torch.kernels import bregman_fused
            return getattr(bregman_fused, name)
        if name.startswith("bregman_prune_mask_blocks"):
            from repro_torch.kernels import bregman_prune
            return getattr(bregman_prune, name)
        mod = self.counters[name][0]
        if name.startswith("bregman_ub_matrix"):
            return lambda *a: getattr(mod, name)(*a[:-1])
        return getattr(mod, name)

    # -- phase 1 -------------------------------------------------------
    def phase_card_and_build(self) -> None:
        torch = self.torch
        if self.rehearsal:
            self.record["nvidia_smi"] = "not measured (CPU rehearsal)"
        else:
            out = subprocess.run(
                ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60, check=True)
            self.record["nvidia_smi"] = out.stdout.strip().splitlines()[0]
            self.record["device_name"] = torch.cuda.get_device_name(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        say(f"card: {self.record['nvidia_smi']}")
        say(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
            f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
        say(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        if self.rehearsal:
            return
        from repro_torch.kernels import _build
        _build.library()
        info = dict(_build.build_info)
        self.record["build"] = info
        say(f"build: {info['seconds']:.2f} s (rebuilt={info['rebuilt']}) "
            f"-> {_build.BUILD_DIR / _build.LIB_NAME}")
        for line in info["ptxas"]:
            say(f"  {line}")
        sass = sass_counts(_build.BUILD_DIR / _build.LIB_NAME)
        self.record["sass"] = sass
        if sass is None:
            say("cuobjdump is missing: the HGMMA instructions and 128-bit "
                "loads of the built library are not counted")
        else:
            say(f"HGMMA instructions in the built library, by function: "
                f"{sass['hgmma']}")
            say("128-bit global loads of the int8 refine kernels (#8), by "
                "function: " + json.dumps(
                    {f: c for f, c in sass["ldg128"].items()
                     if "refine_quant_kernel" in f}))
            expect(any("flash_tc_kernel" in f for f in sass["hgmma"]),
                   "the bf16 flash kernel holds no HGMMA instruction")
            # The 16-byte path: the kernels whose VEC argument is true
            # (mangled ``Lb1E``).
            expect(any("refine_quant_kernel" in f
                       and ("Lb1E" in f or "true>" in f)
                       for f in sass["ldg128"]),
                   "the int8 refine kernel's 16-byte path holds no 128-bit "
                   "global load")

    # -- kernel comparisons -------------------------------------------
    def compare_filter(self, blocks, qs, qb, time_it: bool) -> dict:
        """The UB kernel and the fused filter+prune kernel of a tier
        against their plain versions over ``blocks`` (row blocks of
        ``(alpha, sg, amin, gmax)``, or in the int8 tier the codes each
        followed by its scale and zero-point) for one query batch; with
        ``time_it``, per-launch times and bounds too."""
        torch, ref = self.torch, self.ref
        quant = len(blocks[0]) == 12
        nf = 6 if quant else 2
        sfx = "_quant" if quant else ""
        ub_ref = getattr(ref, "bregman_ub_matrix" + sfx)
        fp_ref = getattr(ref, "bregman_filter_prune" + sfx)
        qc, sd = qs["qconst"], qs["sqrt_delta"]
        qsum = torch.sum(qc, dim=-1)
        # The query operands of each wrapper after its point tables.
        if quant:
            sdsum = torch.sum(sd, dim=-1)
            ub_q, fp_q = (qsum, sd, sdsum, qc), (qsum, qc, sd, sdsum, qb)
        else:
            ub_q, fp_q = (qsum, sd, qc), (qsum, qc, sd, qb)
        ub_k, fp_k = (self.kernel("bregman_ub_matrix" + sfx),
                      self.kernel("bregman_filter_prune" + sfx))
        err_ub = err_fp = worst = 0.0
        over_ub = over_fp = 0.0
        admits = 0
        for blk in blocks:
            filt = blk[:nf]
            # fp32 sums in another order: M + 2 terms, each off by at most
            # (M + 2) * eps of the magnitude of the summed terms.
            scale = ub_term_scale(torch, filt, qc, sd)
            tol = (blk[0].shape[1] + 2) * EPS32 * scale
            worst = max(worst, float(scale.max()))
            want = ub_ref(*filt, qc, sd)
            got = ub_k(*filt, *ub_q)
            self.sync()
            diff = (got - want).abs()
            expect(bool((diff <= tol).all()),
                   f"bregman_ub_matrix{sfx} disagrees: max |diff| "
                   f"{float(diff.max())} at shape {tuple(blk[0].shape)}x"
                   f"{qc.shape[0]}")
            err_ub = max(err_ub, float(diff.max()))
            over_ub = max(over_ub, err_over_tol(diff, tol))
            want_ub, want_admit = fp_ref(*blk, qc, sd, qb)
            got_ub, got_admit = fp_k(*blk, *fp_q)
            self.sync()
            diff = (got_ub - want_ub).abs()
            expect(bool((diff <= tol).all()),
                   f"bregman_filter_prune{sfx} ub disagrees: max |diff| "
                   f"{float(diff.max())}")
            expect(got_admit.dtype == torch.int32
                   and bool(torch.equal(got_admit, want_admit)),
                   f"bregman_filter_prune{sfx} admit mask is not bit-equal "
                   f"({int((got_admit != want_admit).sum())} of "
                   f"{got_admit.numel()} differ)")
            err_fp = max(err_fp, float(diff.max()))
            over_fp = max(over_fp, err_over_tol(diff, tol))
            admits += int(want_admit.sum())
        out = {"ub_err": err_ub, "fp_err": err_fp,
               "ub_err_over_tol": over_ub, "fp_err_over_tol": over_fp,
               "term_scale_max": worst,
               "admitted": admits,
               "pairs": sum(b[0].shape[0] for b in blocks) * qc.shape[0]}
        if not time_it:
            return out
        nb = len(blocks)
        bn, m = blocks[0][0].shape
        q = qc.shape[0]
        reps = max(2, min(50, 2000 // nb))

        def each(fn):
            return [lambda blk=blk: fn(*blk) for blk in blocks]

        if quant:
            from repro_torch.core.quantize import dequantize_stats

            def library(*blk):
                return torch.addmm(dequantize_stats(*blk[:3]).sum(
                    -1, keepdim=True) + qsum, dequantize_stats(*blk[3:6]),
                    sd.T)
        else:
            def library(*blk):
                return torch.addmm(blk[0].sum(-1, keepdim=True) + qsum,
                                   blk[1], sd.T)
        out["ub"] = self.time_calls(
            each(lambda *blk: ub_k(*blk[:nf], *ub_q)), reps)
        out["ub_plain"] = self.time_calls(
            each(lambda *blk: ub_ref(*blk[:nf], qc, sd)), reps)
        out["ub_library"] = self.time_calls(each(library), reps)
        out["fp"] = self.time_calls(
            each(lambda *blk: fp_k(*blk, *fp_q)), reps)
        out["fp_plain"] = self.time_calls(
            each(lambda *blk: fp_ref(*blk, qc, sd, qb)), reps)
        # Per launch: each input read once, each output written once.  A
        # table element is 1 byte of code in the int8 tier, each row adds
        # its fp32 decode pair (scale, zp) per table.
        elem = 1 if quant else 4
        per_row = 8 if quant else 0
        ub_bytes = (2 * (elem * bn * m + per_row * bn) + 4 * (q + q * m)
                    + 4 * bn * q)
        ub_ops = bn * q * (2 * m + 2) + bn * m
        fp_bytes = (4 * (elem * bn * m + per_row * bn)
                    + 4 * (q + 3 * q * m) + 8 * bn * q)
        fp_ops = ub_ops + 4 * bn * q * m     # add, mul, sub, compare
        if quant:
            # The per-output decode of the factored sums; the corners'
            # multiply and add per element.
            ub_ops += 6 * bn * q
            fp_ops += 6 * bn * q + 4 * bn * m
        out["ub_bound"] = bound(ub_bytes, ub_ops)
        out["fp_bound"] = bound(fp_bytes, fp_ops)
        out["shape"] = [bn, m, q, nb]
        return out

    def compare_blocks(self, tables: tuple, qs: dict, qb, blocks: list,
                       bn: int, time_it: bool) -> dict:
        """Kernel #3's block-list entry over the ``blocks`` (row blocks of
        ``bn`` rows) of the full fp32 tables ``(alpha, sg, amin, gmax)``,
        or #4's over the int8 tables (the codes, each followed by its scale
        and zero-point), against its plain version: the admit mask
        bit-equal, the UB within (M + 2) eps32 of its terms, a short
        block's rows past n inert.  With ``time_it``, one launch's time
        beside its bound and the plain version's."""
        torch, ref = self.torch, self.ref
        quant = len(tables) == 12
        name = "bregman_filter_prune_blocks" + ("_quant" if quant else "")
        plain = getattr(ref, name)
        qc, sd = qs["qconst"], qs["sqrt_delta"]
        qsum = torch.sum(qc, dim=-1)
        # The wrapper's query operands after the tables.
        wq = ((qsum, qc, sd, torch.sum(sd, dim=-1), qb) if quant
              else (qsum, qc, sd, qb))
        n, m = tables[0].shape
        q = qc.shape[0]
        ids = torch.tensor(blocks, dtype=torch.int32).to(self.dev)
        kern = self.kernel(name)
        got_ub, got_admit = kern(*tables, *wq, ids, bn)
        want_ub, want_admit = plain(*tables, qc, sd, qb, ids, bn)
        self.sync()
        shape = (n, m, q, bn, len(blocks))
        expect(got_admit.dtype == torch.int32
               and bool(torch.equal(got_admit, want_admit)),
               f"{name} admit mask is not bit-equal at "
               f"{shape} ({int((got_admit != want_admit).sum())} differ)")
        rows = ref.block_rows(ids, bn)
        real = rows < n
        expect(bool(torch.isinf(got_ub[~real]).all())
               and not bool(got_admit[~real].any()),
               f"{name}: rows past n not inert at {shape}")
        idx = rows[real]
        filt = tables[:6] if quant else tables[:2]
        tol = (m + 2) * EPS32 * ub_term_scale(torch, [t[idx] for t in filt],
                                              qc, sd)
        diff = (got_ub[real] - want_ub[real]).abs()
        expect(bool((diff <= tol).all()),
               f"{name} ub disagrees at {shape}: max |diff| "
               f"{float(diff.max())}")
        out = {"shape": list(shape), "err": float(diff.max()),
               "err_over_tol": err_over_tol(diff, tol),
               "admitted": int(want_admit.sum()),
               "pairs": int(real.sum()) * q}
        del got_ub, got_admit, want_ub, want_admit, diff, tol
        if not time_it:
            return out
        reps = 3
        out["ms"] = self.time_calls([lambda: kern(*tables, *wq, ids, bn)],
                                    reps)
        out["plain_ms"] = self.time_calls(
            [lambda: plain(*tables, qc, sd, qb, ids, bn)], reps)
        # The four tables' listed rows read once (1-byte codes and eight
        # fp32 decode scalars a row in int8), the query tables (and sdsum)
        # and the block ids, the f32 UB and int32 admit of every listed row
        # written (a short block's inert rows too); the UB's and the
        # compare's operations over the real rows, in int8 also the
        # per-output decode of the factored sums and the corners' decode.
        r, out_rows = int(real.sum()), len(blocks) * bn
        row_bytes = 4 * m + 32 if quant else 16 * m
        nbytes = (row_bytes * r + 4 * ((2 if quant else 1) * q + 3 * q * m)
                  + 4 * len(blocks) + 8 * out_rows * q)
        ops = r * q * (2 * m + 2) + r * m + 4 * r * q * m
        if quant:
            ops += 6 * r * q + 4 * r * m
        out["bound"] = bound(nbytes, ops)
        return out

    def compare_ub_span(self, filt: tuple, qs: dict, time_it: bool) -> dict:
        """Kernel #1 over all rows of the fp32 ``(alpha, sg)``, or #2 over
        the int8 filter codes (each followed by its scale and zero-point),
        in one launch against its plain version (within (M + 2) eps32 of
        its terms); with ``time_it``, its time beside its bound, the plain
        version's and ``addmm``'s (after the decode in int8)."""
        torch, ref = self.torch, self.ref
        quant = len(filt) == 6
        name = "bregman_ub_matrix" + ("_quant" if quant else "")
        plain = getattr(ref, name)
        qc, sd = qs["qconst"], qs["sqrt_delta"]
        qsum = torch.sum(qc, dim=-1)
        # The wrapper's query operands after the tables (qconst last, for
        # the rehearsal's plain version).
        wq = (qsum, sd, torch.sum(sd, dim=-1), qc) if quant else (qsum, sd,
                                                                  qc)
        n, m = filt[0].shape
        q = qc.shape[0]
        kern = self.kernel(name)
        got = kern(*filt, *wq)
        want = plain(*filt, qc, sd)
        self.sync()
        tol = (m + 2) * EPS32 * ub_term_scale(torch, filt, qc, sd)
        diff = (got - want).abs()
        expect(bool((diff <= tol).all()),
               f"{name} over {n} rows disagrees: max |diff| "
               f"{float(diff.max())}")
        out = {"shape": [n, m, q], "err": float(diff.max()),
               "err_over_tol": err_over_tol(diff, tol)}
        del got, want, diff, tol
        if not time_it:
            return out
        reps = 3
        if quant:
            from repro_torch.core.quantize import dequantize_stats

            def library():
                return torch.addmm(dequantize_stats(*filt[:3]).sum(
                    -1, keepdim=True) + qsum, dequantize_stats(*filt[3:]),
                    sd.T)
        else:
            def library():
                return torch.addmm(filt[0].sum(-1, keepdim=True) + qsum,
                                   filt[1], sd.T)
        out["ms"] = self.time_calls([lambda: kern(*filt, *wq)], reps)
        out["plain_ms"] = self.time_calls([lambda: plain(*filt, qc, sd)],
                                          reps)
        out["library_ms"] = self.time_calls([library], reps)
        # The two tables read once (1-byte codes and their four fp32 decode
        # columns in int8), qsum, sd (and sdsum), the (n, q) totals written;
        # the sums' operations, in int8 also the per-output decode of the
        # factored sums.
        if quant:
            nbytes = 2 * n * m + 16 * n + 4 * (2 * q + q * m) + 4 * n * q
        else:
            nbytes = 8 * n * m + 4 * (q + q * m) + 4 * n * q
        ops = n * q * (2 * m + 2) + n * m + (6 * n * q if quant else 0)
        out["bound"] = bound(nbytes, ops)
        return out

    def compare_prune_blocks(self, tables: tuple, qs: dict, qb,
                             blocks: list, bn: int, time_it: bool) -> dict:
        """The prune-only kernel's block-list entry (#5, or #6 for the
        twelve int8 tables) over the ``blocks`` (row blocks of ``bn`` rows)
        of the corner tables (``tables[2:]`` of ``(alpha, sg, amin,
        gmax)``, or ``tables[6:]``, each code table followed by its scale
        and zero-point) against its plain version and against the fused
        kernel's (#3's or #4's) admit over the same list of ``tables``:
        bit-equal, a short block's rows past n inert.  With ``time_it``,
        one launch's time beside its bound and the plain version's."""
        torch, ref = self.torch, self.ref
        quant = len(tables) == 12
        sfx = "_quant" if quant else ""
        name = "bregman_prune_mask_blocks" + sfx
        corners = tables[6:] if quant else tables[2:]
        qc, sd = qs["qconst"], qs["sqrt_delta"]
        n, m = corners[0].shape
        q = qc.shape[0]
        ids = torch.tensor(blocks, dtype=torch.int32).to(self.dev)
        kern = self.kernel(name)
        plain = getattr(ref, name)
        got = kern(*corners, qc, sd, qb, ids, bn)
        want = plain(*corners, qc, sd, qb, ids, bn)
        query = ((torch.sum(qc, dim=-1), qc, sd, torch.sum(sd, dim=-1), qb)
                 if quant else (torch.sum(qc, dim=-1), qc, sd, qb))
        _, fused = self.kernel("bregman_filter_prune_blocks" + sfx)(
            *tables, *query, ids, bn)
        self.sync()
        shape = (n, m, q, bn, len(blocks))
        real = ref.block_rows(ids, bn) < n
        expect(got.dtype == torch.int32 and bool(torch.equal(got, want)),
               f"{name} is not bit-equal to its plain version at {shape} "
               f"({int((got != want).sum())} differ)")
        expect(bool(torch.equal(got, fused)),
               f"{name} differs from the fused kernel's admit at {shape}")
        expect(not bool(got[~real].any()),
               f"{name}: rows past n not inert at {shape}")
        out = {"shape": list(shape), "admitted": int(want.sum()),
               "pairs": int(real.sum()) * q}
        del got, want, fused
        if not time_it:
            return out
        reps = 3
        out["ms"] = self.time_calls(
            [lambda: kern(*corners, qc, sd, qb, ids, bn)], reps)
        out["plain_ms"] = self.time_calls(
            [lambda: plain(*corners, qc, sd, qb, ids, bn)], reps)
        # The listed rows' corner tables read once (fp32; or int8 codes
        # with their four fp32 decode columns), the three (q, M) query
        # tables and the block ids, the int32 mask of every listed row
        # written (a short block's inert rows too); the add, multiply,
        # subtract and compare per (row, query, subspace), and in int8 the
        # decode's multiply and add per corner element.
        r, out_rows = int(real.sum()), len(blocks) * bn
        elem, per_row = (1, 16) if quant else (4, 0)
        nbytes = (2 * elem * m * r + per_row * r + 12 * q * m
                  + 4 * len(blocks) + 4 * out_rows * q)
        ops = 4 * r * q * m + (4 * r * m if quant else 0)
        out["bound"] = bound(nbytes, ops)
        return out

    def compare_prune(self, corners: list, qs: dict, qb,
                      time_it: bool) -> dict:
        """Kernel #5 (fp32 corners) or #6 (int8 corner codes, each followed
        by its scale and zero-point) over ``corners``, a list of per-block
        operand tuples, for one query batch: the mask must be bit-equal to
        the plain version's and to the admit output of the fused kernel #3
        or #4 on the same corners (its filter tables zeros: the admit does
        not read them).  With ``time_it``, per-launch times and bound."""
        torch, ref = self.torch, self.ref
        quant = len(corners[0]) == 6
        sfx = "_quant" if quant else ""
        name = "bregman_prune_mask" + sfx
        plain = getattr(ref, name)
        kern = self.kernel(name)
        fused = self.kernel("bregman_filter_prune" + sfx)
        qc, sd = qs["qconst"], qs["sqrt_delta"]
        q = qc.shape[0]
        qsum = torch.sum(qc, dim=-1)
        admits = rows = 0
        for blk in corners:
            n, m = blk[0].shape
            got = kern(*blk, qc, sd, qb)
            want = plain(*blk, qc, sd, qb)
            if quant:
                zc = torch.zeros((n, m), dtype=torch.int8, device=self.dev)
                zr = torch.zeros(n, device=self.dev)
                _, fused_admit = fused(zc, zr, zr, zc, zr, zr, *blk, qsum, qc,
                                       sd, torch.sum(sd, dim=-1), qb)
            else:
                z = torch.zeros((n, m), device=self.dev)
                _, fused_admit = fused(z, z, *blk, qsum, qc, sd, qb)
            self.sync()
            expect(got.dtype == torch.int32 and bool(torch.equal(got, want)),
                   f"{name} mask is not bit-equal to its plain version "
                   f"({int((got != want).sum())} of {got.numel()} differ at "
                   f"{(n, m, q)})")
            expect(bool(torch.equal(got, fused_admit)),
                   f"{name} mask differs from the fused kernel's admit at "
                   f"{(n, m, q)}")
            admits += int(want.sum())
            rows += n
        out = {"admitted": admits, "pairs": rows * q}
        if not time_it:
            return out
        nb = len(corners)
        m = corners[0][0].shape[1]
        reps = max(2, min(50, 2000 // nb))
        out["ms"] = self.time_calls(
            [lambda blk=blk: kern(*blk, qc, sd, qb) for blk in corners], reps)
        out["plain_ms"] = self.time_calls(
            [lambda blk=blk: plain(*blk, qc, sd, qb) for blk in corners],
            reps)
        # Per launch (rows averaged over the blocks): the two corner tables
        # read once (1-byte codes plus two fp32 decode scalars a row each in
        # int8), the three (q, M) query tables, the int32 mask written; the
        # add, multiply, subtract and compare per (row, query, subspace),
        # and the decode's multiply and add per corner element in int8.
        bn = rows / nb
        elem, per_row = (1, 16) if quant else (4, 0)
        nbytes = 2 * elem * bn * m + per_row * bn + 12 * q * m + 4 * bn * q
        ops = 4 * bn * q * m + (4 * bn * m if quant else 0)
        out["bound"] = bound(nbytes, ops)
        out["shape"] = [bn, m, q, nb]
        return out

    def compare_refine(self, operands: tuple, grad, c_y, family: str,
                       time_it: bool) -> dict:
        """The refine kernel of a tier against its plain version on
        ``operands``: ``(rows,)`` fp32 (q, b, d), or in the int8 tier
        ``(codes, scale, zp)``."""
        torch, ref = self.torch, self.ref
        quant = len(operands) == 3
        name = "bregman_refine_batch" + ("_quant" if quant else "")
        plain = getattr(ref, name)
        got = self.kernel(name)(*operands, grad, c_y, family)
        want = plain(*operands, grad, c_y, family)
        self.sync()
        q, b, d = operands[0].shape
        if quant:
            from repro_torch.core.quantize import dequantize_rows
            rows = (dequantize_rows(c, s, z, family)
                    for c, s, z in zip(*operands, strict=True))
        else:
            rows = operands[0]
        tol = refine_tolerance(torch, rows, grad, c_y, family, d)
        diff = (got - want).abs()
        expect(bool((diff <= tol).all()),
               f"{name}[{family}] disagrees: max |diff| "
               f"{float(diff.max())} at {(q, b, d)}")
        out = {"err": float(diff.max()) if diff.numel() else 0.0,
               "err_over_tol": err_over_tol(diff, tol),
               "term_scale_max": float(tol.max()) / (EPS32 * d)
               if tol.numel() else 0.0}
        if time_it:
            reps = 5 if q * b * d > 1e8 else 20
            out["kernel"] = self.time_calls(
                [lambda: self.kernel(name)(*operands, grad, c_y, family)],
                reps)
            out["plain"] = self.time_calls(
                [lambda: plain(*operands, grad, c_y, family)], reps)
            # phi, its sum, and the multiply-add of x . grad per element;
            # in the int8 tier the decode's multiply and add (and the
            # domain clamp) too.  Rows are 1-byte codes plus a (scale, zp)
            # pair there.
            if quant:
                positive = family in ("itakura_saito", "burg", "shannon")
                nbytes = q * b * d + 4 * (2 * q * b + q * d + q + q * b)
                ops = (6 + positive) * q * b * d
            else:
                nbytes = 4 * (q * b * d + q * d + q + q * b)
                ops = 4 * q * b * d
            out["bound"] = bound(nbytes, ops)
            out["shape"] = [q, b, d]
        return out

    # -- phase 2 -------------------------------------------------------
    def phase_ragged(self) -> None:
        torch = self.torch
        from repro_torch.core.bounds import query_refine_constants
        from repro_torch.core.bregman import family_names, get_family
        shapes = [(4133, 37, 50), (4133, 1, 1), (77, 70, 33), (31, 5, 2)]
        for n, m, q in shapes:
            a, sg, am, gm, qc, sd, qb = [
                t.to(self.dev) for t in filter_inputs(torch, n, m, q, seed=n)]
            r = self.compare_filter([(a, sg, am, gm)],
                                    {"qconst": qc, "sqrt_delta": sd}, qb,
                                    time_it=False)
            expect(0 < r["admitted"] < r["pairs"] or r["pairs"] < 8,
                   f"ragged filter inputs {n, m, q} gave an unmixed mask")
            say(f"ragged filter {n}x{m}x{q}: ub err {r['ub_err']:.3g}, "
                f"admit bit-equal ({r['admitted']}/{r['pairs']} admitted)")
        # The int8 filter: codes reaching -128 and 127, a constant row
        # (scale 0) and an exact tie at qb in row 0.
        for n, m, q in [(4133, 37, 50), (4133, 1, 1), (31, 70, 33),
                        (31, 37, 1)]:
            *tables, qc, sd, qb = [
                t.to(self.dev)
                for t in filter_inputs_quant(torch, n, m, q, seed=n + m)]
            r = self.compare_filter([tuple(tables)],
                                    {"qconst": qc, "sqrt_delta": sd}, qb,
                                    time_it=False)
            expect(0 < r["admitted"] < r["pairs"] or r["pairs"] < 64,
                   f"ragged int8 filter inputs {n, m, q} gave an unmixed mask")
            say(f"ragged int8 filter {n}x{m}x{q}: max_err_over_tol ub "
                f"{r['ub_err_over_tol']:.3g} fused {r['fp_err_over_tol']:.3g}"
                f", admit bit-equal ({r['admitted']}/{r['pairs']} admitted)")
        # #3 and #5 over block lists: non-contiguous, a short last block,
        # one block, M even (70) and chunked (300), two query tiles (q =
        # 65); #1 over a span that starts 3 rows into its table (not
        # 16-byte aligned).
        for n, m, q, bn, blocks in BLOCK_LIST_CASES:
            a, sg, am, gm, qc, sd, qb = [
                t.to(self.dev) for t in filter_inputs(torch, n, m, q,
                                                      seed=n + m)]
            qs = {"qconst": qc, "sqrt_delta": sd}
            r = self.compare_blocks((a, sg, am, gm), qs, qb, blocks, bn,
                                    time_it=False)
            r5 = self.compare_prune_blocks((a, sg, am, gm), qs, qb, blocks,
                                           bn, time_it=False)
            r1 = self.compare_ub_span((a[3:], sg[3:]), qs, time_it=False)
            expect(0 < r["admitted"] < r["pairs"],
                   f"ragged block-list inputs {n, m, q} gave an unmixed mask")
            say(f"ragged block list {n}x{m}x{q}, bn {bn}, blocks {blocks}: "
                f"#3 admit bit-equal ({r['admitted']}/{r['pairs']}), ub "
                f"max_err_over_tol {r['err_over_tol']:.3g}; #5 bit-equal to "
                f"its plain version and #3's admit ({r5['admitted']} "
                f"admitted); #1 over rows 3.. max_err_over_tol "
                f"{r1['err_over_tol']:.3g}")
        # #4 and #6 over the same block lists: codes at -128 and 127, a
        # scale-0 row, the first listed row tying qb; #2 over a span that
        # starts 3 rows into its tables (neither the codes nor the decode
        # columns 16-byte aligned).
        for n, m, q, bn, blocks in BLOCK_LIST_CASES:
            *tables, qc, sd, qb = [
                t.to(self.dev) for t in filter_inputs_quant(
                    torch, n, m, q, seed=n + m + 1, tie_row=blocks[0] * bn)]
            qs = {"qconst": qc, "sqrt_delta": sd}
            r = self.compare_blocks(tuple(tables), qs, qb, blocks, bn,
                                    time_it=False)
            r6 = self.compare_prune_blocks(tuple(tables), qs, qb, blocks, bn,
                                           time_it=False)
            r2 = self.compare_ub_span(tuple(t[3:] for t in tables[:6]), qs,
                                      time_it=False)
            expect(0 < r["admitted"] < r["pairs"],
                   f"ragged int8 block-list inputs {n, m, q} gave an unmixed "
                   "mask")
            say(f"ragged int8 block list {n}x{m}x{q}, bn {bn}, blocks "
                f"{blocks}: #4 admit bit-equal ({r['admitted']}/"
                f"{r['pairs']}), ub max_err_over_tol {r['err_over_tol']:.3g};"
                f" #6 bit-equal to its plain version and #4's admit "
                f"({r6['admitted']} admitted); #2 over rows 3.. "
                f"max_err_over_tol {r2['err_over_tol']:.3g}")
        # The prune-only kernels: Deep's block shape and ragged ones (M odd
        # and even), each with a mixed mask and the tie in row 0; #5 also
        # over a span 3 rows into its tables (not 16-byte aligned).
        for n, m, q in [(4096, 39, 14), (4096, 40, 14), (4133, 1, 1),
                        (77, 70, 33)]:
            _, _, am, gm, qc, sd, qb = [
                t.to(self.dev) for t in filter_inputs(torch, n, m, q, seed=n)]
            *tables, qc8, sd8, qb8 = [
                t.to(self.dev)
                for t in filter_inputs_quant(torch, n, m, q, seed=n + 1)]
            r = self.compare_prune([(am, gm)], {"qconst": qc,
                                                "sqrt_delta": sd}, qb,
                                   time_it=False)
            r8 = self.compare_prune([tuple(tables[6:])],
                                    {"qconst": qc8, "sqrt_delta": sd8}, qb8,
                                    time_it=False)
            self.compare_prune([(am[3:], gm[3:])], {"qconst": qc,
                                                    "sqrt_delta": sd}, qb,
                               time_it=False)
            for rr in (r, r8):
                expect(0 < rr["admitted"] < rr["pairs"] or rr["pairs"] < 8,
                       f"ragged prune inputs {n, m, q} gave an unmixed mask")
            say(f"ragged prune {n}x{m}x{q}: #5 and #6 bit-equal to their "
                f"plain versions and to the fused admit ({r['admitted']} and "
                f"{r8['admitted']} of {r['pairs']} admitted)")
        gen = torch.Generator().manual_seed(0)
        for q, b, d in [(1, 1, 1), (3, 77, 33), (50, 130, 257)]:
            for family in family_names():
                fam = get_family(family)
                rows = positive_or_not(torch, (q, b, d), fam, gen)
                ys = positive_or_not(torch, (q, d), fam, gen)
                c = query_refine_constants(ys, fam)
                r = self.compare_refine((rows.to(self.dev),),
                                        c["grad"].to(self.dev),
                                        c["c_y"].to(self.dev), family,
                                        time_it=False)
            say(f"ragged refine {q}x{b}x{d}: all families agree "
                f"(last err {r['err']:.3g})")
        for q, b, d in [(1, 1, 1), (33, 31, 33), (50, 130, 257)]:
            over = 0.0
            for family in family_names():
                fam = get_family(family)
                codes, scale, zp = quant_table(torch, q * b, d, gen)
                if fam.domain_low == 0.0:
                    zp = zp.abs() * 2.0          # some decoded values clamp
                c = query_refine_constants(
                    positive_or_not(torch, (q, d), fam, gen), fam)
                r = self.compare_refine(
                    (codes.reshape(q, b, d).to(self.dev),
                     scale.reshape(q, b).to(self.dev),
                     zp.reshape(q, b).to(self.dev)),
                    c["grad"].to(self.dev), c["c_y"].to(self.dev), family,
                    time_it=False)
                over = max(over, r["err_over_tol"])
            say(f"ragged int8 refine {q}x{b}x{d}: all families agree "
                f"(max_err_over_tol {over:.3g})")
        self.check_refine_quant_layouts()
        self.phase_quantizer()
        self.phase_cross_device()

    def check_refine_quant_layouts(self) -> None:
        """#8 on codes whose base is one byte past 16-byte alignment (byte
        loads) against its plain version at d = 1, 33, 256 and 257, every
        family, and on the card bit-equal to the aligned codes; one (query,
        row) pair's bits alone (b = 1), at another position of a ragged
        batch, and unaligned, equal to its bits in the full batch."""
        torch = self.torch
        from repro_torch.core.bounds import query_refine_constants
        from repro_torch.core.bregman import family_names, get_family
        from repro_torch.kernels import bregman_dist
        gen = torch.Generator().manual_seed(3)
        q, b = 5, 70
        for d in (1, 33, 256, 257, 600):
            over = 0.0
            for family in family_names():
                fam = get_family(family)
                codes, scale, zp = quant_table(torch, q * b, d, gen)
                if fam.domain_low == 0.0:
                    zp = zp.abs() * 2.0
                codes = codes.reshape(q, b, d).to(self.dev)
                scale = scale.reshape(q, b).to(self.dev)
                zp = zp.reshape(q, b).to(self.dev)
                c = query_refine_constants(
                    positive_or_not(torch, (q, d), fam, gen).to(self.dev),
                    fam)
                moved = unaligned(torch, codes)
                r = self.compare_refine((moved, scale, zp), c["grad"],
                                        c["c_y"], family, time_it=False)
                over = max(over, r["err_over_tol"])
                if self.rehearsal:
                    continue
                args = (scale, zp, c["grad"], c["c_y"], family)
                full = bregman_dist.bregman_refine_batch_quant(codes, *args)
                expect(same_bits(torch, bregman_dist.bregman_refine_batch_quant(
                    moved, *args), full),
                       f"bregman_refine_batch_quant[{family}] at d = {d}: "
                       "unaligned codes change the bits")
                qi, row = 3, 41
                sl = (slice(qi, qi + 1), slice(row, row + 1))
                one = bregman_dist.bregman_refine_batch_quant(
                    codes[sl].contiguous(), scale[sl].contiguous(),
                    zp[sl].contiguous(), c["grad"][qi:qi + 1].contiguous(),
                    c["c_y"][qi:qi + 1].contiguous(), family)
                batch = codes[qi:qi + 1, :33].clone()
                bs = scale[qi:qi + 1, :33].clone()
                bz = zp[qi:qi + 1, :33].clone()
                batch[0, 7], bs[0, 7], bz[0, 7] = (codes[qi, row],
                                                   scale[qi, row],
                                                   zp[qi, row])
                ragged = bregman_dist.bregman_refine_batch_quant(
                    unaligned(torch, batch), bs, bz,
                    c["grad"][qi:qi + 1].contiguous(),
                    c["c_y"][qi:qi + 1].contiguous(), family)
                expect(same_bits(torch, one[0, 0], full[qi, row])
                       and same_bits(torch, ragged[0, 7], full[qi, row]),
                       f"bregman_refine_batch_quant[{family}] at d = {d}: a "
                       "pair's bits depend on b or its position")
            say(f"int8 refine at d = {d} on unaligned codes: all families "
                f"agree (max_err_over_tol {over:.3g}), bit-equal to aligned "
                "codes, a pair's bits the same at b = 1 and at another "
                "position")

    def phase_quantizer(self) -> None:
        """``quantize_rows``, ``dequantize_rows`` and ``encode_stat_tables``
        on the card give the CPU's codes, scales and zero-points bit for
        bit, for every family, constant rows included."""
        torch = self.torch
        from repro_torch.core import quantize as qz
        from repro_torch.core.bregman import family_names, get_family
        gen = torch.Generator().manual_seed(2)
        for family in family_names():
            x = positive_or_not(torch, (2000, 96), get_family(family),
                                gen) * 3.0
            x[7] = x[7, 0]
            stats = [torch.randn((2000, 37), generator=gen)
                     * 10.0 ** torch.randint(-3, 4, (2000, 1), generator=gen)
                     for _ in range(4)]
            stats[0][3] = 1.5
            cpu = qz.quantize_rows(x)
            card = qz.quantize_rows(x.to(self.dev))
            got = dict(zip(("codes", "scale", "zp"), card, strict=True))
            want = dict(zip(("codes", "scale", "zp"), cpu, strict=True))
            got["rows"] = qz.dequantize_rows(*card, family)
            want["rows"] = qz.dequantize_rows(*cpu, family)
            got.update(qz.encode_stat_tables(*(t.to(self.dev)
                                               for t in stats)))
            want.update(qz.encode_stat_tables(*stats))
            for key, w in want.items():
                expect(bool(torch.equal(got[key].cpu(), w)),
                       f"quantizer[{family}] {key} on the card differs from "
                       "the CPU's")
        say("quantizer: codes, scales, zero-points and decoded rows on the "
            "card == on the CPU, bit for bit, for all families")

    def phase_cross_device(self) -> None:
        """The whole search on the card against the same search on the
        CPU (plain versions), every family, one small index per tier."""
        torch = self.torch
        from repro_torch.core import index as tidx
        from repro_torch.core import search as tsearch
        from repro_torch.core.bregman import family_names, get_family
        for quantize in (False, True):
            gen = torch.Generator().manual_seed(1)
            for family in family_names():
                fam = get_family(family)
                data = positive_or_not(torch, (3000, 24), fam, gen).numpy()
                forest = tidx.build_index(data, family, m=6,
                                          quantize=quantize, device="cpu")
                moved = tidx.forest_from_numpy(
                    tidx.forest_to_numpy(forest), family_name=family,
                    partition_idx=forest.partition.idx,
                    partition_mask=forest.partition.mask, d=forest.d,
                    num_clusters=forest.num_clusters,
                    storage=forest.storage, device=self.dev)
                queries = data[:12] * 1.01
                if family == "exponential":
                    self.check_small_calibration(forest, moved)
                want = tsearch.knn_batch(forest, queries, K, budget=64,
                                         block_rows=512, device="cpu")
                got = tsearch.knn_batch(moved, queries, K, budget=64,
                                        block_rows=512, device=self.dev)
                tier = forest.storage
                expect(bool(torch.equal(got.ids.cpu(), want.ids)),
                       f"{family} {tier}: ids on the card differ from the "
                       "CPU's")
                expect(bool(torch.allclose(got.dists.cpu(), want.dists,
                                           rtol=1e-4, atol=1e-4)),
                       f"{family} {tier}: distances on the card differ from "
                       "the CPU's")
            say(f"cross-device {'int8' if quantize else 'fp32'}: knn_batch "
                "on the card == on the CPU for all families")

    # -- phases 3 and 4 ------------------------------------------------
    def drive(self, name: str, quantize: bool) -> dict:
        """Build and search one paper dataset at its full n (the
        rehearsal's n on the CPU) in one storage tier; returns its
        record."""
        torch = self.torch
        from repro_torch.core import index as tidx
        from repro_torch.core import search as tsearch
        from repro_torch.data.pipeline import (PAPER_DATASETS, make_queries,
                                               make_vectors)
        spec = PAPER_DATASETS[name]
        tier = "int8" if quantize else "fp32"
        label = f"{name} {tier}"
        n = self.args.rehearsal_n if self.rehearsal else spec.n
        scale = n / spec.n
        t0 = time.perf_counter()
        data = make_vectors(spec, scale=scale)
        queries = make_queries(spec, num=NUM_QUERIES, scale=scale, data=data)
        rec = {"dataset": name, "tier": tier, "n": int(data.shape[0]),
               "d": spec.d, "family": spec.measure,
               "data_s": time.perf_counter() - t0,
               "left_on_card_bytes": self.left_on_card()}
        say(f"{label}: n={rec['n']} d={spec.d} family={spec.measure}")

        self.sync()
        self.reset_peak()
        t0 = time.perf_counter()
        forest = tidx.build_index(data, spec.measure, m=None, pccp=True,
                                  quantize=quantize, device=self.dev)
        self.sync()
        rec["build_s"] = time.perf_counter() - t0
        rec["build_peak_bytes"] = self.peak()
        rec["m"] = forest.m
        rec["num_clusters"] = forest.num_clusters
        rec["table_bytes"] = table_bytes(forest)
        ys = torch.as_tensor(queries, device=self.dev)

        # Size the query batches so the refine's (q, budget, d) gather
        # fits: a probe at the default budget gives the unions' sizes.  The
        # int8 tier is sized as fp32 is: checking its refine kernel at the
        # path's shape forms the plain version's fp32 decoded rows.
        probe = tsearch.knn_search_batch(forest, ys, K, None,
                                         device=self.dev)
        need = tsearch.fitted_budget(forest, K,
                                     int(probe.num_candidates.max()))
        worst = max(need, tsearch.resolve_budget(None, forest.n, K))
        free = (torch.cuda.mem_get_info()[0] if not self.rehearsal
                else 8 << 30)
        q_batch = int(max(1, min(NUM_QUERIES,
                                 0.4 * free // (worst * spec.d * 4 * 2))))
        rec["query_batch"] = q_batch
        del probe

        def search():
            outs = [tsearch.knn_batch(forest, ys[s:s + q_batch], K,
                                      return_stats=True, device=self.dev)
                    for s in range(0, NUM_QUERIES, q_batch)]
            self.sync()
            return outs

        self.reset_launches()
        self.reset_peak()
        t0 = time.perf_counter()
        outs = search()
        rec["search_first_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["launches"] = self.launches()
        rec["search_peak_bytes"] = self.peak()
        self.expect_launches(label, rec["launches"], RESIDENT_PATH, quantize)
        # One filter and one fused launch an attempt (the cap holds an
        # attempt's rows and its admitted blocks), and the refine's one:
        # equal counts.
        sfx = "_quant" if quantize else ""
        refine_n = rec["launches"]["bregman_refine_batch" + sfx]
        for kname in ("bregman_ub_matrix" + sfx, "bregman_filter_prune" + sfx):
            got_n = rec["launches"][kname]
            expect(self.rehearsal or got_n == refine_n,
                   f"{label}: {kname} launched {got_n} times, not once an "
                   f"attempt ({refine_n} attempts)")
        steady = []
        for _ in range(3):
            t0 = time.perf_counter()
            search()
            steady.append(1e3 * (time.perf_counter() - t0))
        rec["search_ms"] = statistics.median(steady)
        rec["search_ms_runs"] = steady
        ids = torch.cat([o[0].ids for o in outs])
        dists = torch.cat([o[0].dists for o in outs])
        ncand = torch.cat([o[0].num_candidates for o in outs])
        exact = torch.cat([o[0].exact for o in outs])
        stats = [o[1] for o in outs]
        rec["mean_candidates"] = float(ncand.double().mean())
        rec["max_candidates"] = int(ncand.max())
        rec["candidate_fraction"] = rec["mean_candidates"] / forest.n
        rec["escalations"] = [s.escalations for s in stats]
        rec["budget_final"] = max(s.budget_final for s in stats)
        rec["escalated_to_scan"] = any(s.escalated_to_scan for s in stats)
        expect(bool(exact.all()), f"{label}: a result is not exact")
        expect(tuple(ids.shape) == (NUM_QUERIES, K)
               and bool(torch.isfinite(dists).all()),
               f"{label}: results of the wrong shape or not finite")

        # Brute force over the index's own point set, in the data's order
        # (the decoded rows in the int8 tier; the data in fp32).
        points = forest.rows_view()[torch.argsort(forest.point_ids.long())]
        rec.update(self.check_brute_force(points, ys, ids, dists,
                                          spec.measure))
        del points
        say(f"{label}: build {rec['build_s']:.2f} s (M={forest.m}), search "
            f"first {rec['search_first_ms']:.1f} ms, steady "
            f"{rec['search_ms']:.1f} ms per {NUM_QUERIES} queries "
            f"(batches of {q_batch}), mean candidates "
            f"{rec['mean_candidates']:.1f} of {forest.n}, escalations "
            f"{rec['escalations']}, budget {rec['budget_final']}, "
            f"launches {rec['launches']}, ids match brute force over "
            f"rows_view ({rec['bf_position_mismatches']} near-tie swaps; "
            f"its scan took {rec['brute_force_ms']:.1f} ms)")
        say(f"{label}: table bytes {rec['table_bytes']}, peak bytes: build "
            f"{rec['build_peak_bytes']}, search {rec['search_peak_bytes']} "
            f"({rec['left_on_card_bytes']} left on the card by the phases "
            "before)")

        # Phase breakdown of one batch, each phase ended by a sync.
        ys0 = ys[:q_batch]
        (rec["phases_ms"], qs, qb, sel, valid, operands,
         blocks_run) = self.phase_times(forest, ys0, rec["budget_final"])
        bn, nb = tsearch._block_layout(forest.n, BLOCK_ROWS)
        rec["blocks_run"] = blocks_run
        rec["num_blocks"] = nb
        say(f"{label}: phases (ms, batch of {q_batch}) "
            + ", ".join(f"{k}={v:.2f}" for k, v in rec["phases_ms"].items())
            + f"; prune ran {blocks_run} of {nb} blocks")
        rec["profile"] = self.profile(search, rec["search_ms"])
        say(f"{label}: device busy {rec['profile']['busy_share']} of the "
            f"unprofiled search")
        # The fused search launches no prune-only kernel (#5, #6).
        expect(self.rehearsal or rec["profile"]["prune_only_calls"] == 0,
               f"{label}: the resident search ran a prune-only kernel "
               f"{rec['profile'].get('prune_only_calls')} times")

        # The kernels at the shapes this search gave them a row block at a
        # time, then as the grouped search launches them.
        corners = tsearch._row_blocks(
            tuple(getattr(forest, f)
                  for f in tsearch.CORNER_FIELDS[forest.storage]), bn, nb)
        blocks = [f + c for f, c in zip(
            tsearch._filter_blocks(forest, bn, nb), corners, strict=True)]
        rec["filter_kernels"] = self.compare_filter(blocks, qs, qb,
                                                    time_it=True)
        rec["refine_kernel"] = self.compare_refine(
            operands, qs["grad"], qs["c_y"], forest.family_name,
            time_it=True)
        del operands, sel, valid, blocks
        rec["prune_kernels"] = self.compare_prune(corners, qs, qb,
                                                  time_it=True)
        del corners
        say(f"{label}: kernels agree at the path's shapes: filter "
            + json.dumps(rec["filter_kernels"]) + " refine "
            + json.dumps(rec["refine_kernel"]) + " prune "
            + json.dumps(rec["prune_kernels"]))
        rec["grouped_kernels"] = self.compare_grouped(forest, qs, qb, bn,
                                                      blocks_run)
        say(f"{label}: {'#2, #4 and #6' if quantize else '#1, #3 and #5'} at "
            "the grouped shape " + json.dumps(rec["grouped_kernels"]))
        rec["per_block_loop"] = self.check_grouped(
            label, forest, ys0, rec["budget_final"], search)
        rec["unfused"] = self.drive_unfused(label, forest, ys[:q_batch],
                                            rec["budget_final"], quantize,
                                            blocks_run)
        if name == "deep":
            rec["tiered"] = self.drive_tiered(label, forest, ys, q_batch,
                                              ids, quantize)
        self.phase9_of(label, {"forest": forest, "ys": ys, "ids": ids,
                               "budget": rec["budget_final"],
                               "search_ms": rec["search_ms"],
                               "family": spec.measure})
        if name == "deep":
            rec["mutable"] = self.drive_mutable(
                label, forest, data, ys, q_batch,
                {"ids": ids, "dists": dists, "exact": exact,
                 "num_candidates": ncand}, spec.measure, rec["search_ms"])
            rec["phase11"] = self.phase11_deep(label, forest, ys, ids, dists,
                                               quantize, self._mutable_sf)
            self._mutable_sf = None
            rec["phase12"] = self.phase12_deep(label, forest, ys, q_batch,
                                               rec, ids, dists)
        else:
            rec["mutable"] = self.check_audio_rebuilds(label, forest, data)
            if not quantize:
                rec["baselines"] = self.phase12_baselines(
                    label, data, queries, spec.measure, rec)
        del forest
        if not self.rehearsal:
            torch.cuda.empty_cache()
        return rec

    def phase_times(self, forest, ys0, budget: int) -> tuple:
        """Host ms of each search phase over the query batch ``ys0`` at
        ``budget``, each ended by a sync; with the filter's ``qs`` and
        ``qb``, the candidates, the refine's gathered operands and the
        blocks the prune ran."""
        from repro_torch.core import search as tsearch
        qs = tsearch.query_struct(ys0, forest.partition, forest.family)
        self.sync()
        marks = [time.perf_counter()]
        _, idx = tsearch._batch_filter_topk(forest, qs, K, BLOCK_ROWS)
        qb = tsearch.searching_bounds(forest, qs, idx)
        self.sync()
        marks.append(time.perf_counter())
        sel, valid, _, _, blocks_run, _ = \
            tsearch._stream_prune_compact(forest, qs, qb, budget, BLOCK_ROWS)
        self.sync()
        marks.append(time.perf_counter())
        operands = tuple(getattr(forest, f)[sel]
                         for f in tsearch.REFINE_FIELDS[forest.storage])
        self.sync()
        marks.append(time.perf_counter())
        tsearch._refine_batch(forest, qs, sel, valid, K)
        self.sync()
        marks.append(time.perf_counter())
        phases = {key: 1e3 * (marks[i + 1] - marks[i]) for i, key in
                  enumerate(("filter", "prune_compact", "gather",
                             "gather_refine_topk"))}
        return phases, qs, qb, sel, valid, operands, blocks_run

    def compare_grouped(self, forest, qs: dict, qb, bn: int,
                        blocks_run: int) -> dict:
        """The grouped kernels of a tier as the search launches them over
        one attempt (at budget n every block is admitted where the union
        holds every point): #3 (#4 in int8) over every row block in one
        block-list launch, #1 (#2) over all n rows, and the unfused
        search's #5 (#6) over every row block in one block-list launch;
        each against its plain version and timed beside its bound."""
        from repro_torch.core import search as tsearch
        nb = -(-forest.n // bn)
        tables = tuple(getattr(forest, f)
                       for f in tsearch.FUSED_TABLES[forest.storage][1])
        out = {"fp": self.compare_blocks(tables, qs, qb, list(range(nb)), bn,
                                         time_it=True),
               "blocks_admitted_by_the_search": blocks_run}
        quant = forest.storage == "int8"
        out["ub"] = self.compare_ub_span(tables[:6] if quant else tables[:2],
                                         qs, time_it=True)
        out["prune"] = self.compare_prune_blocks(tables, qs, qb,
                                                 list(range(nb)), bn,
                                                 time_it=True)
        return out

    def check_grouped(self, label: str, forest, ys0, budget: int,
                      search) -> dict:
        """The grouped search against the per-block loop (a group cap below
        one block, so #1 and #3, or #2 and #4, launch once a row block):
        ``knn_search_batch_stats`` at ``budget`` and ``knn_batch`` bit for
        bit, stats included.  Then, in turns (per-block, grouped, grouped,
        per-block), each loop's phase times over the batch and one timed
        ``search`` of all queries, with the launches of each."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        cap = tsearch.GROUP_OUTPUT_BYTES

        def run(c: int, check: bool):
            with swapped(tsearch, "GROUP_OUTPUT_BYTES", c):
                out = {}
                if check:
                    self.reset_launches()
                    out["stats"] = tsearch.knn_search_batch_stats(
                        forest, ys0, K, budget, BLOCK_ROWS, device=self.dev)
                    out["batch"] = tsearch.knn_batch(
                        forest, ys0, K, return_stats=True, device=self.dev)
                    self.sync()
                    out["launches"] = self.launches()
                out["phases_ms"] = self.phase_times(forest, ys0, budget)[0]
                t0 = time.perf_counter()
                search()
                out["search_ms"] = 1e3 * (time.perf_counter() - t0)
                return out

        runs = [("per_block", run(0, True)), ("grouped", run(cap, True)),
                ("grouped", run(cap, False)), ("per_block", run(0, False))]
        want, got = runs[0][1], runs[1][1]
        (wres, wstats), (gres, gstats) = want["stats"], got["stats"]
        for f in gres._fields:
            expect(bool(torch.equal(getattr(gres, f), getattr(wres, f))),
                   f"{label}: grouped search {f} differ from the per-block "
                   "loop's")
        for key, val in wstats.items():
            same = (bool(torch.equal(gstats[key], val))
                    if isinstance(val, torch.Tensor) else gstats[key] == val)
            expect(same, f"{label}: grouped stats {key} differ from the "
                   "per-block loop's")
        (wb, wbs), (gb, gbs) = want["batch"], got["batch"]
        expect(gbs == wbs and all(bool(torch.equal(getattr(gb, f),
                                                   getattr(wb, f)))
                                  for f in gb._fields),
               f"{label}: grouped knn_batch differs from the per-block loop's")
        sfx = "_quant" if forest.storage == "int8" else ""
        names = ("bregman_ub_matrix" + sfx, "bregman_filter_prune" + sfx)
        out = {"queries": int(ys0.shape[0]), "budget": budget,
               "launches": {k: {n: r["launches"][n] for n in names}
                            for k, r in runs[:2]},
               "turns": [{"loop": k, "phases_ms": r["phases_ms"],
                          "search_ms": r["search_ms"]} for k, r in runs]}
        say(f"{label}: grouped search == per-block loop bit for bit (stats "
            f"included) at budget {budget}; launches {out['launches']}; in "
            "turns " + json.dumps(out["turns"]))
        return out

    def expect_launches(self, label: str, launches: dict, path: tuple,
                        quantize: bool) -> None:
        """Each kernel of ``path`` (in the tier's variant) launched on the
        path just driven, and no other kernel."""
        if self.rehearsal:
            return
        want = {k + ("_quant" if quantize else "") for k in path}
        for kname, count in launches.items():
            if kname in want:
                expect(count > 0, f"{label}: kernel {kname} never launched "
                       "on the path")
            else:
                expect(count == 0, f"{label}: kernel {kname} launched "
                       f"{count} times off the path")

    def drive_unfused(self, label: str, forest, ys, budget: int,
                      quantize: bool, blocks_run: int) -> dict:
        """The unfused comparator (``fused=False``: windowed gate, kernel #5
        or #6, no UB tile) at the fused search's budget: ids, dists,
        exact and num_candidates bit-equal; the prune-only kernel launched
        once a group of the ``blocks_run`` admitted blocks, one group an
        attempt.  Then, in turns (per-block, grouped, grouped, per-block),
        the unfused search against its per-block loop (a group cap below
        one block): bit-equal, the gate's stats included, each timed."""
        torch = self.torch
        from repro_torch.core import search as tsearch

        def fused():
            return tsearch.knn_search_batch(forest, ys, K, budget,
                                            BLOCK_ROWS, validate=False,
                                            device=self.dev)

        def unfused():
            return tsearch._knn_search_batch_unfused(
                forest, ys, K, budget, BLOCK_ROWS, device=self.dev)

        want = fused()
        self.reset_launches()
        got = unfused()
        self.sync()
        out = {"budget": budget, "queries": int(ys.shape[0]),
               "launches": self.launches()}
        self.expect_launches(label + " fused=False", out["launches"],
                             UNFUSED_PATH, quantize)
        name = "bregman_prune_mask" + ("_quant" if quantize else "")
        gb = tsearch._group_blocks(tsearch._block_layout(
            forest.n, BLOCK_ROWS)[0], int(ys.shape[0]), 4)
        out["prune_groups"] = -(-blocks_run // gb)
        expect(self.rehearsal
               or out["launches"][name] == out["prune_groups"] == 1,
               f"{label} fused=False: {name} launched "
               f"{out['launches'][name]} times for {blocks_run} admitted "
               f"blocks in groups of {gb}, not once an attempt")
        for f in got._fields:
            expect(bool(torch.equal(getattr(got, f), getattr(want, f))),
                   f"{label}: fused=False {f} differ from the fused search's")
        for key, fn in (("fused_ms", fused), ("unfused_ms", unfused)):
            self.sync()
            t0 = time.perf_counter()
            fn()
            self.sync()
            out[key] = 1e3 * (time.perf_counter() - t0)
        say(f"{label}: fused=False == fused bit for bit at budget {budget} "
            f"(q = {out['queries']}); one search {out['unfused_ms']:.2f} ms "
            f"against fused {out['fused_ms']:.2f} ms; {name} launched "
            f"{out['launches'][name]} times")
        out["per_block_loop"] = self.check_unfused_grouped(label, forest, ys,
                                                           budget, name)
        return out

    def check_unfused_grouped(self, label: str, forest, ys, budget: int,
                              name: str) -> dict:
        """``fused=False`` grouped (the default cap) against its per-block
        loop (a cap below one block), in turns: results, gate stats
        (env_admitted, blocks_run) and tau bit for bit; the launches of
        the prune-only kernel ``name`` and the host ms of each."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        cap = tsearch.GROUP_OUTPUT_BYTES

        def run(c: int):
            with swapped(tsearch, "GROUP_OUTPUT_BYTES", c):
                self.reset_launches()
                self.sync()
                t0 = time.perf_counter()
                res = tsearch._knn_search_batch_core(
                    forest, ys, K, budget, BLOCK_ROWS, with_stats=True,
                    fused=False)
                self.sync()
                return {"res": res, "ms": 1e3 * (time.perf_counter() - t0),
                        "launches": self.launches()[name]}

        runs = [("per_block", run(0)), ("grouped", run(cap)),
                ("grouped", run(cap)), ("per_block", run(0))]
        (wres, wenv, wrun, wtau) = runs[0][1]["res"]
        (gres, genv, grun, gtau) = runs[1][1]["res"]
        same = (all(bool(torch.equal(getattr(gres, f), getattr(wres, f)))
                    for f in gres._fields)
                and bool(torch.equal(genv, wenv)) and grun == wrun
                and bool(torch.equal(gtau, wtau)))
        expect(same, f"{label}: grouped fused=False differs from its "
               "per-block loop")
        out = {"blocks_run": int(wrun),
               "launches": {k: r["launches"] for k, r in runs[:2]},
               "turns": [{"loop": k, "ms": r["ms"]} for k, r in runs]}
        say(f"{label}: grouped fused=False == per-block loop bit for bit "
            f"(gate stats included) at budget {budget}; {name} launches "
            f"{out['launches']}; in turns " + json.dumps(out["turns"]))
        return out

    def drive_tiered(self, label: str, forest, ys, q_batch: int, ids,
                     quantize: bool) -> dict:
        """Deep through a TieredPointStore that holds 40% of the cold bytes
        on the card (bench_tiered.py's share), default prefetch depth:
        ``knn_batch`` returns the resident ids; a fixed-budget search is
        bit-equal to the resident one; a cold and a warm pass are timed."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        from repro_torch.core.tiered import TieredPointStore
        cold = cold_bytes(forest)
        out = {"cold_bytes": cold, "resident_bytes": int(0.4 * cold)}
        self.sync()
        t0 = time.perf_counter()
        store = TieredPointStore.from_index(
            forest, resident_bytes=out["resident_bytes"],
            block_rows=BLOCK_ROWS)
        self.sync()
        out["wrap_s"] = time.perf_counter() - t0
        expect(not store.is_resident, f"{label}: the store did not tier")
        out["prefetch_depth"] = store.prefetch_depth
        out["num_blocks"] = store.num_blocks

        def search():
            outs = [tsearch.knn_batch(store, ys[s:s + q_batch], K,
                                      device=self.dev)
                    for s in range(0, NUM_QUERIES, q_batch)]
            self.sync()
            return outs

        for key in ("cold", "warm"):
            store.reset_stats()
            self.reset_launches()
            self.reset_peak()
            t0 = time.perf_counter()
            outs = search()
            ms = 1e3 * (time.perf_counter() - t0)
            launches = self.launches()
            self.expect_launches(f"{label} tiered {key}", launches,
                                 TIERED_PATH, quantize)
            got = torch.cat([o.ids for o in outs])
            expect(bool(torch.equal(got, ids)),
                   f"{label}: tiered knn_batch ({key} pass) ids differ from "
                   "the resident knn_batch's")
            stats = dict(store.stats)
            out[key] = {"ms": ms, "launches": launches, "stats": stats,
                        "cache_info": store.cache_info(),
                        "peak_bytes": self.peak(),
                        "fetch_gb_per_s": stats["host_bytes_fetched"]
                        / (ms * 1e6)}
            say(f"{label} tiered {key} pass: {ms:.1f} ms per {NUM_QUERIES} "
                f"queries, fetched {stats['host_bytes_fetched']} B "
                f"({out[key]['fetch_gb_per_s']:.2f} GB/s over the pass), "
                f"blocks admitted {stats['blocks_admitted']} of "
                f"{stats['blocks_total']}, launches {launches}")
        out["launches"] = out["cold"]["launches"]
        budget = tsearch.resolve_budget(None, forest.n, K)
        ys0 = ys[:q_batch]
        want = tsearch.knn_search_batch(forest, ys0, K, budget,
                                        device=self.dev)
        self.sync()
        t0 = time.perf_counter()
        got = tsearch.knn_search_batch(store, ys0, K, budget,
                                       device=self.dev)
        self.sync()
        out["fixed_budget"] = {"budget": budget, "queries": int(ys0.shape[0]),
                               "ms": 1e3 * (time.perf_counter() - t0)}
        for f in got._fields:
            expect(bool(torch.equal(getattr(got, f), getattr(want, f))),
                   f"{label}: tiered {f} at budget {budget} differ from the "
                   "resident search's")
        out["stage_b"] = self.check_stage_b(label, forest, ys0, budget, want,
                                            quantize)
        # The Stage B window is transient (freed when a search returns)
        # and outside resident_bytes; counted here at its last size.
        info = store.cache_info()
        out["window_bytes"] = info["window_bytes"]
        out["store_device_bytes"] = (forest_device_bytes(store._hot)
                                     + info["bytes_cached"]
                                     + info["pool_bytes"]
                                     + info["window_bytes"])
        out["resident_device_bytes"] = forest_device_bytes(forest)
        out["copies"] = self.copy_overlap(
            lambda: tsearch.knn_search_batch(store, ys0, K, budget,
                                             device=self.dev),
            f"tiered_trace_{'int8' if quantize else 'fp32'}.json")
        # The profiled search's prune-only launches: one a Stage B window.
        expect(self.rehearsal or out["copies"]["prune_launches"]
               == out["stage_b"]["windows"],
               f"{label}: the profiled tiered search ran "
               f"{out['copies'].get('prune_launches')} prune-only kernels "
               f"in {out['stage_b']['windows']} Stage B windows")
        fast = TieredPointStore.from_index(forest, resident_bytes=2 * cold,
                                           block_rows=BLOCK_ROWS)
        got = fast.search(ys0, K, budget, device=self.dev)
        expect(fast.is_resident and bool(torch.equal(got.ids, want.ids)),
               f"{label}: a store with twice the cold bytes did not take the "
               "resident fast path")
        store.close()
        say(f"{label} tiered: bit-equal to resident at budget {budget}; the "
            f"store holds {out['store_device_bytes']} B on its device against "
            f"{out['resident_device_bytes']} B resident; copies "
            + json.dumps(out["copies"]) + "; resident fast path at 2x cold")
        return out

    def check_stage_b(self, label: str, forest, ys0, budget: int, want,
                      quantize: bool) -> dict:
        """Stage B in windows (the default ``tiered.WINDOW_BYTES``) against
        Stage B a block at a time (a window cap below one block; Stage A
        reads the search's own group cap, so it runs the same in both),
        each one search of ``ys0`` at ``budget`` through a fresh store at
        40% of the cold bytes, in turns (windows, a block at a time, a
        block at a time, windows): the results bit-equal (and to the
        resident search's ``want``), the stats equal, the store's
        ``_block`` calls the same blocks in the same order; the prune-only
        kernel launched once a window against once a block.  Host ms of
        each beside.  Then the prune-only kernel at the shape Stage B gives
        it: the store's corner blocks of the first window concatenated as
        Stage B pools them, in one span launch, bit-equal to its plain
        version and to the fused kernel's admit, and timed."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        from repro_torch.core import tiered
        from repro_torch.core.tiered import TieredPointStore
        cap = tiered.WINDOW_BYTES
        name = "bregman_prune_mask" + ("_quant" if quantize else "")
        fields = tsearch.CORNER_FIELDS[forest.storage]
        bn = tsearch._block_layout(forest.n, BLOCK_ROWS)[0]
        q = int(ys0.shape[0])
        row_bytes = sum(getattr(forest, f)[0].numel()
                        * getattr(forest, f).element_size() for f in fields)

        def run(c: int, keep: bool = False) -> dict:
            with swapped(tiered, "WINDOW_BYTES", c):
                store = TieredPointStore.from_index(
                    forest, resident_bytes=int(0.4 * cold_bytes(forest)),
                    block_rows=BLOCK_ROWS)
                calls = []
                fetch = store._block

                def block(bid):
                    calls.append(bid)
                    return fetch(bid)

                store._block = block
                try:
                    self.reset_launches()
                    self.sync()
                    t0 = time.perf_counter()
                    res = store.search(ys0, K, budget, device=self.dev)
                    self.sync()
                    ms = 1e3 * (time.perf_counter() - t0)
                    wb = tiered._window_blocks(row_bytes, bn, q)
                    admitted = store.stats["blocks_admitted"]
                    return {"res": res, "ms": ms, "stats": dict(store.stats),
                            "calls": calls,
                            "launches": self.launches()[name],
                            "window_blocks": wb,
                            "windows": -(-admitted // wb),
                            "window_bytes":
                                store.cache_info()["window_bytes"],
                            "store": store if keep else None}
                finally:
                    store.close()

        runs = [("windows", run(cap, keep=True)), ("per_block", run(0)),
                ("per_block", run(0)), ("windows", run(cap))]
        win, one = runs[0][1], runs[1][1]
        for _, r in runs:
            for f in win["res"]._fields:
                expect(bool(torch.equal(getattr(r["res"], f),
                                        getattr(want, f))),
                       f"{label}: Stage B gives other {f} in windows or a "
                       "block at a time than the resident search")
            expect(r["stats"] == win["stats"] and r["calls"] == win["calls"],
                   f"{label}: Stage B in windows fetched otherwise than a "
                   "block at a time")
        admitted = win["stats"]["blocks_admitted"]
        expect(self.rehearsal or (win["launches"] == win["windows"]
                                  and one["launches"] == admitted),
               f"{label}: Stage B launched {name} {win['launches']} times "
               f"in {win['windows']} windows and {one['launches']} times a "
               f"block at a time for {admitted} admitted blocks")
        expect(win["window_bytes"] == min(win["window_blocks"], admitted)
               * bn * row_bytes,
               f"{label}: the store reports a {win['window_bytes']}-byte "
               f"window for {win['window_blocks']} blocks of {row_bytes} "
               "corner bytes a row")

        # The first window's corner rows as Stage B pools them, from the
        # store's own host blocks (a short last block padded inert).
        store = win.pop("store")
        qs, qb, env = tiered._stage_a(store._hot, ys0, K, BLOCK_ROWS,
                                      tsearch.resolve_env_block_rows(None),
                                      None)
        listed = torch.nonzero(env.any(dim=1)).flatten().tolist()
        expect(listed == win["calls"][:admitted],
               f"{label}: Stage A's admitted blocks are not the ones Stage "
               "B resolved")
        first = listed[:win["window_blocks"]]
        corners = tuple(torch.cat([store._blocks[f][b] for b in first])
                        .to(self.dev) for f in fields)
        del store
        window_kernel = self.compare_prune([corners], qs, qb, time_it=True)
        del corners
        out = {"budget": budget, "queries": q,
               "blocks_admitted": admitted,
               "window_blocks": win["window_blocks"],
               "windows": win["windows"],
               "window_bytes": win["window_bytes"], "stats": win["stats"],
               "launches": {"windows": win["launches"],
                            "per_block": one["launches"]},
               "turns": [{"loop": k, "ms": r["ms"]} for k, r in runs],
               "window_kernel": window_kernel}
        say(f"{label} tiered: Stage B in windows == a block at a time bit "
            f"for bit (stats and fetch order included) at budget {budget}; "
            f"{name} launched {win['launches']} times ({win['windows']} "
            f"windows of up to {win['window_blocks']} blocks, "
            f"{win['window_bytes']} B a window outside resident_bytes) "
            f"against {one['launches']}; in turns "
            + json.dumps(out["turns"]) + f"; {name} at the window's shape "
            + json.dumps(window_kernel))
        return out

    def copy_overlap(self, fn, trace_name: str) -> dict:
        """One more run of ``fn`` under torch.profiler: from its chrome
        trace (kept as build/``trace_name``), the store's host-to-device
        copies (pinned or pageable), the prune kernels' device time, how
        much of the copies' time overlaps the prune kernels and any
        kernel, and the device's busy time (the union of its kernels,
        copies and sets) within the profiled run's wall time."""
        if self.rehearsal:
            return {"overlap": "not measured"}
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            self.sync()
        path = ROOT / "build" / trace_name
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]

        def spans(pred):
            return [(e["ts"], e["ts"] + e["dur"]) for e in events if pred(e)]

        copies = spans(lambda e: e.get("cat") == "gpu_memcpy"
                       and "HtoD" in e.get("name", ""))
        prunes = spans(lambda e: e.get("cat") == "kernel"
                       and PRUNE_ONLY_KERNEL.search(e.get("name", "")))
        kernels = spans(lambda e: e.get("cat") == "kernel")
        device = spans(lambda e: e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset"))
        wall = (max(b for _, b in spans(lambda e: True))
                - min(a for a, _ in spans(lambda e: True)))
        names = [e.get("name", "") for e in events
                 if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
        return {"htod_copies": len(copies),
                "pinned_copies": sum("Pinned" in n for n in names),
                "pageable_copies": sum("Pageable" in n for n in names),
                "htod_ms": sum(b - a for a, b in copies) / 1e3,
                "prune_launches": len(prunes),
                "prune_ms": sum(b - a for a, b in prunes) / 1e3,
                "overlap_prune_ms": overlap(copies, prunes) / 1e3,
                "overlap_any_kernel_ms": overlap(copies, kernels) / 1e3,
                "device_busy_ms": overlap([(min(a for a, _ in device),
                                            max(b for _, b in device))],
                                          device) / 1e3,
                "profiled_wall_ms": wall / 1e3,
                "trace": str(path)}

    def drive_blobs(self) -> dict:
        """The blob corpus of benchmarks/bench_tiered.py at n = 2^20: 16
        contiguous Gaussian blobs 100 apart, squared Euclidean, d = 32,
        m = 4, 64 clusters, 512-row blocks, 32 queries from blob 0 offset
        by 0.01, k = 10, a store holding 40% of the cold bytes.  A cold and
        a warm pass through the store, each bit-equal to resident search
        at the default budget; the resident knn_batch against brute
        force."""
        torch = self.torch
        import numpy as np
        from repro_torch.core import index as tidx
        from repro_torch.core import search as tsearch
        from repro_torch.core.tiered import TieredPointStore
        n = 4096 if self.rehearsal else 1 << 20
        d, m, q, blobs, block_rows = 32, 4, 32, 16, 512
        family = "squared_euclidean"
        rec = {"n": n, "d": d, "m": m, "q": q, "blobs": blobs,
               "block_rows": block_rows, "family": family,
               "num_clusters": 64, "left_on_card_bytes": self.left_on_card()}
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        per = n // blobs
        data = np.concatenate([rng.normal(size=(per, d)) + 100.0 * j
                               for j in range(blobs)]).astype(np.float32)
        ys_np = (data[rng.integers(0, per, size=q)] + 0.01).astype(
            np.float32)
        rec["data_s"] = time.perf_counter() - t0
        self.sync()
        t0 = time.perf_counter()
        forest = tidx.build_index(data, family, m=m, num_clusters=64,
                                  seed=0, device=self.dev)
        self.sync()
        rec["build_s"] = time.perf_counter() - t0
        ys = torch.as_tensor(ys_np, device=self.dev)
        exact = tsearch.knn_batch(forest, ys, K, block_rows=block_rows,
                                  device=self.dev)
        points = forest.rows_view()[torch.argsort(forest.point_ids.long())]
        rec.update(self.check_brute_force(points, ys, exact.ids, exact.dists,
                                          family))
        del points
        budget = tsearch.resolve_budget(None, n, K)
        rec["budget"] = budget
        self.sync()
        t0 = time.perf_counter()
        want = tsearch.knn_search_batch(forest, ys, K, budget, block_rows,
                                        device=self.dev)
        self.sync()
        rec["resident_ms"] = 1e3 * (time.perf_counter() - t0)
        cold = cold_bytes(forest)
        store = TieredPointStore.from_index(forest,
                                            resident_bytes=int(0.4 * cold),
                                            block_rows=block_rows)
        rec["cold_bytes"] = cold
        rec["resident_bytes"] = store.resident_bytes
        expect(not store.is_resident, "blob corpus: the store did not tier")
        for key in ("cold", "warm"):
            store.reset_stats()
            self.reset_launches()
            self.sync()
            t0 = time.perf_counter()
            got = store.search(ys, K, budget, device=self.dev)
            self.sync()
            ms = 1e3 * (time.perf_counter() - t0)
            for f in got._fields:
                expect(bool(torch.equal(getattr(got, f), getattr(want, f))),
                       f"blob corpus {key} pass: tiered {f} differ from the "
                       "resident search's")
            stats = dict(store.stats)
            rec[key] = {"ms": ms, "launches": self.launches(),
                        "stats": stats, "cache_info": store.cache_info()}
            self.expect_launches(f"blob corpus {key} pass",
                                 rec[key]["launches"], TIERED_PATH, False)
            say(f"blob corpus {key} pass (n={n}): {ms:.2f} ms for {q} "
                f"queries (resident {rec['resident_ms']:.2f} ms), blocks "
                f"admitted {stats['blocks_admitted']} of "
                f"{stats['blocks_total']}, fetched "
                f"{stats['host_bytes_fetched']} B of {cold} cold, launches "
                f"{rec[key]['launches']}")
        # The warm path's pooled corners (its last admitted set), or the
        # cached blocks pooled, when the admitted set did not fit the cache.
        if store._pool_cache is None:
            store._pooled(tuple(sorted(store._cache)))
        corners = store._pool_cache[1]
        qs = tsearch.query_struct(ys, forest.partition, forest.family)
        qb = tsearch._filter_bounds(forest, qs, K, block_rows)
        rec["pooled_prune"] = self.compare_prune([corners], qs, qb,
                                                 time_it=True)
        rec["pooled_from_warm_pass"] = rec["warm"]["cache_info"][
            "pool_bytes"] > 0
        say("blob corpus: pooled prune kernel at the warm path's shape "
            + json.dumps(rec["pooled_prune"]))
        store.close()
        rec["mutable"] = self.drive_blobs_mutable(forest, data, ys, want,
                                                  budget, block_rows)
        self.phase9_of("blobs", {"forest": forest, "ys": ys,
                                 "ids": exact.ids, "budget": budget,
                                 "block_rows": block_rows,
                                 "family": family})
        rec["phase11"] = self.phase11_blobs(forest, ys, exact, block_rows)
        return rec

    def reset_peak(self) -> None:
        if not self.rehearsal:
            self.torch.cuda.reset_peak_memory_stats()
            self._peak_base = self.torch.cuda.memory_allocated()

    def peak(self):
        """Peak device bytes since :meth:`reset_peak` (None on the CPU)."""
        if self.rehearsal:
            return None
        return self.torch.cuda.max_memory_allocated()

    def left_on_card(self):
        """Device bytes allocated after a garbage collection: what the
        phases before left on the card (None on the CPU)."""
        if self.rehearsal:
            return None
        gc.collect()
        return self.torch.cuda.memory_allocated()

    def alloc_retries(self):
        """The caching allocator's count of allocations it retried after
        freeing cached blocks (None on the CPU)."""
        if self.rehearsal:
            return None
        return self.torch.cuda.memory_stats().get("num_alloc_retries", 0)

    def peak_above(self):
        """Peak device bytes since :meth:`reset_peak` beyond those
        allocated at the reset: the working memory of what ran between
        (None on the CPU)."""
        if self.rehearsal:
            return None
        return self.torch.cuda.max_memory_allocated() - self._peak_base

    def check_brute_force(self, data, ys, ids, dists, family: str,
                          k: int = K) -> dict:
        """Ids against ``brute_force_knn`` on the card.  A position may
        differ only where brute force's neighbouring distances lie within
        the tolerance (a near tie); returned distances must agree with
        brute force's within it.  The tolerance is d * eps32 times the
        magnitude of the summed terms (sum |phi(x)| + |x . grad| + |c_y|),
        the worst-case error of a d-term fp32 sum."""
        torch = self.torch
        from repro_torch.core.bounds import query_refine_constants
        from repro_torch.core.bregman import get_family
        from repro_torch.core.search import brute_force_knn
        fam = get_family(family)
        x = torch.as_tensor(data, device=self.dev)
        self.sync()
        t0 = time.perf_counter()
        bf_ids, bf_d = brute_force_knn(x, ys, k + 1, family, device=self.dev)
        self.sync()
        bf_ms = 1e3 * (time.perf_counter() - t0)
        c = query_refine_constants(ys.double(), fam)
        d = x.shape[1]
        scales = []
        for j in range(ys.shape[0]):
            rows = x[torch.cat([bf_ids[j], ids[j].to(bf_ids.dtype)])].double()
            scales.append((fam.phi(rows).abs().sum(-1)
                           + (rows * c["grad"][j]).sum(-1).abs()
                           + c["c_y"][j].abs()).max())
        tol = d * EPS32 * torch.stack(scales)[:, None].float()
        expect(bool(((dists - bf_d[:, :k]).abs() <= tol).all()),
               f"distances differ from brute force beyond tolerance: max "
               f"{float((dists - bf_d[:, :k]).abs().max())}")
        gaps = (bf_d[:, 1:] - bf_d[:, :-1]).abs() <= tol     # (q, k)
        near_tie = gaps.clone()
        near_tie[:, 1:] |= gaps[:, :-1]
        mismatch = ids.to(bf_ids.dtype) != bf_ids[:, :k]
        expect(bool((~mismatch | near_tie).all()),
               f"ids differ from brute force away from a near tie at "
               f"{mismatch.nonzero().tolist()[:5]}")
        return {"brute_force_ms": bf_ms,
                "bf_position_mismatches": int(mismatch.sum()),
                "bf_max_abs_diff": float((dists - bf_d[:, :k]).abs().max())}

    def profile(self, fn, wall_ms: float) -> dict:
        """The device time of one more run of ``fn`` (a search), by
        kernel, from torch.profiler's CUPTI trace.  The busy share divides
        it by ``wall_ms``, the search's unprofiled wall time: the profiler
        slows the host, so the profiled run's own wall time would
        understate the share."""
        if self.rehearsal:
            return {"busy_share": "not measured"}
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            profiled_ms = 1e3 * (time.perf_counter() - t0)
        rows = sorted(((e.self_device_time_total, e.key, e.count)
                       for e in device_events(torch, prof)), reverse=True)
        expect(bool(rows), "the profiler recorded no device time")
        busy_ms = sum(r[0] for r in rows) / 1e3
        return {"busy_share": busy_ms / wall_ms, "wall_ms": wall_ms,
                "device_ms": busy_ms, "profiled_wall_ms": profiled_ms,
                "prune_only_calls": sum(c for _, k, c in rows
                                        if PRUNE_ONLY_KERNEL.search(k)),
                "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": c}
                        for us, k, c in rows[:10]]}

    # -- phase 6: kernel #10 ------------------------------------------
    def compare_flash(self, b, h, kh, sq, skv, d, causal, window, dtype,
                      seed: int, model_shape: bool = False,
                      time_it: bool = False, rows: int | None = None
                      ) -> dict:
        """Kernel #10 against its plain version on (B, H, S, D) views of
        contiguous (B, S, H, D) tensors, the model's layout; fp32 within
        2e-5, bf16 within 2e-2 (abs + rel: tests/test_kernels.py's
        tolerances; the plain version rounds bf16 logits and probabilities,
        the kernel does not).

        With ``model_shape`` also against the plain version on fp32 upcasts
        of the same inputs, where the kernel's fp32 arithmetic leaves only
        its output's rounding: bf16 within 2^-8 |want| + 1e-5 (half a bf16
        ulp), fp32 within 2e-5 (abs + rel); and a planted fault read
        against that limit: the same attention with the kv tile of the
        kernel under test (``FLASH_KV_TILE``) in the middle of the sequence
        dropped (``middle_tile``).  With
        ``time_it``: kernel, plain version and SDPA (``library_ms``)
        device ms, and the bound.  With ``rows``, where the plain
        version's (b, h, sq, skv) logits would not fit the card, the plain
        versions and the planted fault see only the last ``rows`` queries
        (end-aligned to all the keys, so they cross the causal edge at its
        longest rows) and are held against those rows of the kernel's
        whole output; the plain version is then not timed (``plain_ms``
        None).  The CPU rehearsal's kernel is the plain version on fp32
        upcasts, cast back: the kernel's arithmetic."""
        torch, ref = self.torch, self.ref
        from repro_torch.kernels import flash_attention as tflash
        gen = torch.Generator().manual_seed(seed)

        def bshd(heads, s):
            x = torch.randn((b, s, heads, d), generator=gen).to(dtype)
            return x.to(self.dev).transpose(1, 2)

        def upcast_ref(q, k, v, **kw):
            return ref.flash_attention(q.float(), k.float(), v.float(),
                                       **kw).to(q.dtype)

        q, k, v = bshd(h, sq), bshd(kh, skv), bshd(kh, skv)
        kernel = upcast_ref if self.rehearsal else tflash.flash_attention
        # the queries the plain versions check: all, or the last ``rows``
        first = 0 if rows is None else sq - rows
        qc = q[:, :, first:]

        def run_kernel():
            return kernel(q, k, v, causal=causal, window=window)

        def run_plain():
            return ref.flash_attention(qc, k, v, causal=causal,
                                       window=window)

        got, want = run_kernel()[:, :, first:], run_plain()
        self.sync()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        diff = (got.float() - want.float()).abs()
        limit = tol + tol * want.float().abs()
        shape = [b, h, kh, sq, skv, d, causal, window, str(dtype)[6:]]
        expect(bool((diff <= limit).all()),
               f"flash_attention disagrees with its plain version at {shape}:"
               f" max |diff| {float(diff.max())}")
        out = {"shape": shape, "max_abs_err": float(diff.max()),
               "max_err_over_tol": float((diff / limit).max()),
               "checked_rows": sq - first}
        del want, diff, limit
        if model_shape:
            want = ref.flash_attention(qc.float(), k.float(), v.float(),
                                       causal=causal, window=window)
            diff = (got.float() - want).abs()
            limit = (2.0 ** -8 * want.abs() + 1e-5
                     if dtype == torch.bfloat16 else 2e-5 + 2e-5 * want.abs())
            expect(bool((diff <= limit).all()),
                   f"flash_attention disagrees with the fp32 plain version "
                   f"at {shape}: max |diff| {float(diff.max())}")
            width = FLASH_KV_TILE[str(dtype)[6:]]
            fault = attention_dropping(torch, qc, k, v, causal,
                                       middle_tile(skv, width), window)
            fault_over = float(((fault - want).abs() / limit).max())
            expect(fault_over > 1,
                   f"a dropped kv tile passes the tolerance at {shape} "
                   f"({fault_over} of it)")
            out.update(plain_max_abs_err=out["max_abs_err"],
                       plain_max_err_over_tol=out["max_err_over_tol"],
                       max_abs_err=float(diff.max()),
                       max_err_over_tol=float((diff / limit).max()),
                       planted_fault_over_tol=fault_over)
            del want, diff, limit, fault
        del got
        if not time_it:
            return out
        reps = 3
        out["ms"] = self.time_calls([run_kernel], reps)
        out["plain_ms"] = (self.time_calls([run_plain], reps)
                           if rows is None else None)
        fn = torch.nn.functional.scaled_dot_product_attention
        if window is None and sq == skv:
            mask = None
        else:       # end-aligned queries and the window, as a bool mask
            qi = torch.arange(sq, device=self.dev)[:, None] + (skv - sq)
            ki = torch.arange(skv, device=self.dev)[None, :]
            mask = (qi >= ki) if causal else torch.ones_like(qi >= ki)
            if window is not None:
                mask &= (qi - ki) < window
        out["library_ms"] = self.time_calls(
            [lambda: fn(q, k, v, attn_mask=mask,
                        is_causal=causal and mask is None,
                        enable_gqa=kh != h)], reps)
        del mask
        pairs, keys = attended(sq, skv, causal, window)
        flops = 4.0 * b * h * pairs * d
        elem = 2 if dtype == torch.bfloat16 else 4
        nbytes = elem * (2 * b * h * sq * d + 2 * b * kh * keys * d)
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        out["bound"] = bound(nbytes, flops, peak)
        out["tflops"] = (flops / (out["ms"] * 1e-3) / 1e12
                         if out["ms"] else None)
        return out

    def phase_flash(self) -> dict:
        """#10 on the seven cases of tests/test_kernels.py::
        test_flash_attention in fp32 and bf16, then at the model's shapes in
        bf16: prefill at S = 2048 (B = 2), the corpus forward batch of
        the kNN-LM phase (B = 8, S = 1024), its serving prefill (SLOTS
        prompts of PROMPT_LEN) and qwen3-moe-30b-a3b's corpus batch (32
        q heads over 4 kv heads), timed; then at recurrentgemma-2b's heads
        (10 q heads, 1 kv head, D = 256) in fp32 and bf16, both timed: its
        corpus batch, its serving prefill and a 4096-key sequence at its
        window of 2048 (phase 13's shapes never reach the window); then
        phase 15's shapes (``PHASE15_SHAPES``) the same way."""
        torch = self.torch
        from repro_torch.serve.knnlm import FORWARD_BATCH
        rec = {"cases": []}
        for i, case in enumerate(FLASH_CASES):
            for dtype in (torch.float32, torch.bfloat16):
                rec["cases"].append(self.compare_flash(*case, dtype,
                                                       seed=i))
        say(f"flash_attention: the {len(FLASH_CASES)} kernel test cases in "
            "fp32 and bf16 agree with the plain version (max |diff| "
            f"{max(c['max_abs_err'] for c in rec['cases']):.3g}, at most "
            f"{max(c['max_err_over_tol'] for c in rec['cases']):.3g} of the "
            "tolerance)")
        if self.rehearsal:
            shapes = {"prefill_2048": (1, 4, 2, 64, 64, 16),
                      "corpus_batch": (2, 4, 2, 32, 32, 16),
                      "prefill_512": (2, 4, 2, 16, 16, 16),
                      "moe_corpus_batch": (2, 8, 1, 32, 32, 16)}
        else:
            shapes = {"prefill_2048": (2, 24, 2, 2048, 2048, 128),
                      "corpus_batch": (FORWARD_BATCH, 24, 2, CORPUS_LEN,
                                       CORPUS_LEN, 128),
                      "prefill_512": (SLOTS, 24, 2, PROMPT_LEN, PROMPT_LEN,
                                      128),
                      "moe_corpus_batch": (FORWARD_BATCH, 32, 4, CORPUS_LEN,
                                           CORPUS_LEN, 128)}
        for name, (b, h, kh, sq, skv, d) in shapes.items():
            r32 = self.compare_flash(b, h, kh, sq, skv, d, True, None,
                                     torch.float32, seed=len(name),
                                     model_shape=True)
            r = self.compare_flash(b, h, kh, sq, skv, d, True, None,
                                   torch.bfloat16, seed=len(name),
                                   model_shape=True, time_it=True)
            rec[name], rec[name + "_fp32"] = r, r32
            say(f"flash_attention {name} {r['shape']}: kernel {r['ms']} ms "
                f"({r['tflops']} TFLOP/s), plain {r['plain_ms']} ms, SDPA "
                f"{r['library_ms']} ms, bound {r['bound']}; against the fp32 "
                f"plain version max |diff| {r['max_abs_err']:.3g} bf16 "
                f"({r['max_err_over_tol']:.3g} of the tolerance; a dropped "
                f"kv tile {r['planted_fault_over_tol']:.3g} of it), "
                f"{r32['max_abs_err']:.3g} fp32 "
                f"({r32['max_err_over_tol']:.3g}; dropped tile "
                f"{r32['planted_fault_over_tol']:.3g}); against the bf16 "
                f"plain version {r['plain_max_abs_err']:.3g}")
        rec["d256"] = {}
        for name, (b, h, kh, sq, skv, d, window) in D256_SHAPES.items():
            if self.rehearsal:
                b, sq, skv = 1, sq // 16, skv // 16
                window = window and window // 16
            for dtype in (torch.float32, torch.bfloat16):
                r = self.compare_flash(b, h, kh, sq, skv, d, True, window,
                                       dtype, seed=len(name),
                                       model_shape=True, time_it=True)
                rec["d256"][f"{name}_{str(dtype)[6:]}"] = r
                say(f"flash_attention D=256 {name} {r['shape']}: kernel "
                    f"{r['ms']} ms ({r['tflops']} TFLOP/s), plain "
                    f"{r['plain_ms']} ms, SDPA {r['library_ms']} ms, bound "
                    f"{r['bound']}; against the fp32 plain version max "
                    f"|diff| {r['max_abs_err']:.3g} "
                    f"({r['max_err_over_tol']:.3g} of the tolerance; a "
                    f"dropped kv tile {r['planted_fault_over_tol']:.3g} of "
                    f"it); against the plain version in its own dtype "
                    f"{r['plain_max_abs_err']:.3g}")
        rec["phase15"] = {}
        for name, (b, h, kh, sq, skv, d, causal) in PHASE15_SHAPES.items():
            if self.rehearsal:
                b, h, kh, sq, skv = 1, 4, 2, sq // 32, skv // 32
            for dtype in (torch.float32, torch.bfloat16):
                r = self.compare_flash(b, h, kh, sq, skv, d, causal, None,
                                       dtype, seed=len(name),
                                       model_shape=True, time_it=True)
                rec["phase15"][f"{name}_{str(dtype)[6:]}"] = r
                say(f"flash_attention {name} {r['shape']}: kernel "
                    f"{r['ms']} ms ({r['tflops']} TFLOP/s), plain "
                    f"{r['plain_ms']} ms, SDPA {r['library_ms']} ms, bound "
                    f"{r['bound']}; against the fp32 plain version max "
                    f"|diff| {r['max_abs_err']:.3g} "
                    f"({r['max_err_over_tol']:.3g} of the tolerance; a "
                    f"dropped kv tile {r['planted_fault_over_tol']:.3g} of "
                    f"it); against the plain version in its own dtype "
                    f"{r['plain_max_abs_err']:.3g}")
        if not self.rehearsal:
            torch.cuda.empty_cache()
        return rec

    # -- phase 7: kNN-LM on starcoder2-3b ------------------------------
    def phase_knnlm(self) -> dict:
        """Full-width starcoder2-3b (30 layers, random weights from a
        seeded generator on the card) serving 16 requests with the kNN-LM
        hook over a datastore built from a seeded 64 x 1024 corpus (the
        reduced config and a small corpus in a CPU rehearsal)."""
        torch = self.torch
        import numpy as np
        from repro_torch import configs
        from repro_torch.models.registry import build_model
        from repro_torch.serve.engine import Engine, EngineConfig, Request
        from repro_torch.serve.knnlm import (FORWARD_BATCH, KNNLMHook,
                                             build_datastore)
        if self.rehearsal:
            cfg = configs.get_reduced("starcoder2-3b")
            num_seqs, seq_len, prompt_len, max_seq, new = 8, 32, 16, 40, 4
        else:
            cfg = configs.get_config("starcoder2-3b")
            num_seqs, seq_len, prompt_len, max_seq, new = (
                CORPUS_SEQS, CORPUS_LEN, PROMPT_LEN, MAX_SEQ, NEW_TOKENS)
        rec = {"layers": cfg.num_layers, "d_model": cfg.d_model,
               "corpus": [num_seqs, seq_len], "requests": NUM_REQUESTS,
               "prompt_len": prompt_len, "slots": SLOTS, "max_seq": max_seq,
               "max_new_tokens": new, "k": KNN_K}
        rng = np.random.default_rng(SEED)
        self.sync()
        t0 = time.perf_counter()
        bundle = build_model(cfg, device=self.dev)
        params = bundle.init(SEED)
        self.sync()
        rec["init_s"] = time.perf_counter() - t0
        rec["params"] = bundle.count_params
        say(f"kNN-LM: {cfg.name} {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, {bundle.count_params} parameters (fp32, cast to "
            f"{str(cfg.compute_dtype)[6:]} at each use) in "
            f"{rec['init_s']:.2f} s")

        # Datastore: teacher-forced forward in batches, then build_index.
        corpus = rng.integers(1, cfg.vocab_size, (num_seqs, seq_len))
        self.reset_launches()
        self.reset_peak()
        # The recall curve is fitted in the build (phase 11's hook at
        # target_recall inverts it); its seconds are taken apart.
        from repro_torch.core import calibrate as tcal
        fit, fit_s = tcal.fit_calibration, []

        def timed_fit(*a, **kw):
            self.sync()
            t = time.perf_counter()
            try:
                return fit(*a, **kw)
            finally:
                self.sync()
                fit_s.append(time.perf_counter() - t)

        tcal.fit_calibration = timed_fit
        t0 = time.perf_counter()
        try:
            store = build_datastore(bundle, params, corpus,
                                    family="squared_euclidean", m=None,
                                    calibrate=True, calibrate_k=KNN_K,
                                    seed=SEED)
        finally:
            tcal.fit_calibration = fit
        self.sync()
        rec["build_s"] = time.perf_counter() - t0
        rec["calibration_fit_s"] = sum(fit_s)
        rec["build_peak_bytes"] = self.peak()
        rec["build_launches"] = self.launches()
        rec["build_flash_kernels"] = self.flash_launches()
        batches = -(-num_seqs // FORWARD_BATCH)
        rec["forward_batches"] = batches
        index = store.index
        rec.update(keys=index.n, m=index.m, num_clusters=index.num_clusters,
                   key_bytes=index.data.numel() * 4)
        # The forward runs #10; the recall curve's fit searches the keys
        # (#1, #3, #7).
        self.expect_launches("datastore build", rec["build_launches"],
                             ("flash_attention",) + RESIDENT_PATH, False)
        if not self.rehearsal:
            expect(rec["build_launches"]["flash_attention"]
                   == cfg.num_layers * batches,
                   f"datastore build: {rec['build_launches']} #10 launches, "
                   f"not {cfg.num_layers} layers x {batches} batches")
            expect(rec["build_flash_kernels"]["bf16_wgmma"]
                   == rec["build_launches"]["flash_attention"],
                   f"datastore build: #10 ran {rec['build_flash_kernels']}, "
                   "not only the bf16 tensor-core kernel")
        toks = torch.as_tensor(corpus[:FORWARD_BATCH], device=self.dev)
        pos = torch.arange(seq_len, device=self.dev)[None].expand(
            toks.shape[0], seq_len)

        def forward():
            return bundle.forward_train(params, {"tokens": toks,
                                                 "positions": pos})

        rec["forward_ms_per_batch"] = self.host_ms(forward, reps=2)
        say(f"kNN-LM datastore: {index.n} keys x {cfg.d_model} fp32 "
            f"({rec['key_bytes']} B), M* = {index.m}, "
            f"{index.num_clusters} clusters; build {rec['build_s']:.2f} s "
            f"(of which the recall curve's fit {rec['calibration_fit_s']:.2f}"
            " s) "
            f"({batches} forward batches of {FORWARD_BATCH} x {seq_len}, "
            f"{rec['forward_ms_per_batch']:.1f} ms each), peak "
            f"{rec['build_peak_bytes']} B")

        # Serving: 16 requests through the engine with the hook.
        prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
                   for _ in range(NUM_REQUESTS)]
        hook = KNNLMHook(store=store, k=KNN_K)
        ecfg = EngineConfig(slots=SLOTS, max_seq=max_seq,
                            prefill_len=prompt_len)
        eng, outputs, calls = self.serve_timed(bundle, params, hook, prompts,
                                               ecfg, new, rec)
        prefill_ms = rec["prefill_ms"]
        generated = rec["generated_tokens"]
        serve_s = rec["serve_s"]
        expect(len(outputs) == NUM_REQUESTS
               and all(len(o) == new for o in outputs.values()),
               "kNN-LM: not every request got its tokens")
        expect(all(0 <= t < cfg.vocab_size for o in outputs.values()
                   for t in o), "kNN-LM: a token outside the vocab")
        self.expect_launches("kNN-LM serving", rec["serve_launches"],
                             ("flash_attention",) + RESIDENT_PATH, False)
        if not self.rehearsal:
            expect(rec["serve_launches"]["flash_attention"]
                   == cfg.num_layers * len(prefill_ms),
                   f"kNN-LM serving: {rec['serve_launches']} #10 launches, "
                   f"not {cfg.num_layers} layers x {len(prefill_ms)} "
                   "prefills")
            expect(rec["serve_flash_kernels"]["bf16_wgmma"]
                   == rec["serve_launches"]["flash_attention"],
                   f"kNN-LM serving: #10 ran {rec['serve_flash_kernels']}, "
                   "not only the bf16 tensor-core kernel")
        say(f"kNN-LM serving: {NUM_REQUESTS} requests x {new} tokens, "
            f"{SLOTS} slots, prompts {prompt_len}: {serve_s:.2f} s, "
            f"{rec['tokens_per_s']:.1f} tokens/s; prefill ms {prefill_ms}; "
            f"decode {rec['decode_ms_per_tick']:.2f} ms and hook "
            f"{rec['hook_ms_per_tick']:.2f} ms per tick (medians of "
            f"{rec['ticks']}); mean candidates per query "
            f"{rec['mean_candidates']:.1f} of {index.n}; hook escalations "
            f"{hook.escalations}, budget {hook.budget_final}; launches "
            f"{rec['serve_launches']} (#10 by kernel: build "
            f"{rec['build_flash_kernels']}, serving "
            f"{rec['serve_flash_kernels']}); peak {rec['serve_peak_bytes']} B")

        # The hook's ids on the last tick against brute force.
        last = calls[-1]
        keys = index.data[torch.argsort(index.point_ids.long())]
        rec["brute_force"] = self.check_brute_force(
            keys, last["hidden"].float(), hook.last_result.ids,
            hook.last_result.dists, "squared_euclidean", k=KNN_K)
        del keys
        say(f"kNN-LM: the hook's ids on the last tick match brute force "
            f"over the datastore ({rec['brute_force']})")
        for call in calls:
            call.pop("hidden")

        # The engine's tokens against an offline greedy loop on the card:
        # the same waves of SLOTS requests, so every matmul has the same
        # shape and bf16 rounds as it did in the engine.
        check_hook = KNNLMHook(store=store, k=KNN_K)
        offline = {}
        for w0 in range(0, NUM_REQUESTS, SLOTS):
            uids = list(range(w0, min(w0 + SLOTS, NUM_REQUESTS)))
            offline.update(self.offline_greedy(
                bundle, params, [prompts[u] for u in uids], uids, new,
                max_seq, check_hook))
        expect(offline == outputs,
               "kNN-LM: the engine's tokens differ from the offline greedy "
               "loop")
        say(f"kNN-LM: the engine's {generated} tokens equal the offline "
            "greedy prefill + decode loop")

        # First-token logits through #10 against the plain attention.
        rec["logits_check"] = self.logits_through_plain(
            cfg, params, prompts[:LOGITS_BATCH])
        say("kNN-LM: first-token logits through #10 against the plain "
            "attention " + json.dumps(rec["logits_check"]))

        # Device-busy share over a shorter serving run.
        def short_run():
            e = Engine(bundle, params, ecfg, logits_hook=hook)
            for uid in range(SLOTS):
                e.submit(Request(uid=uid, prompt=prompts[uid],
                                 max_new_tokens=PROFILE_TOKENS))
            e.run()
            self.sync()

        wall = self.host_ms(short_run, reps=1)
        rec["profile"] = self.profile(short_run, wall)
        rec["profile"]["what"] = (f"{SLOTS} requests x {PROFILE_TOKENS} "
                                  "tokens, one admission")
        say(f"kNN-LM: device busy {rec['profile']['busy_share']} of a "
            f"{SLOTS}-request, {PROFILE_TOKENS}-token serving run")
        rec["hook_calls_ms"] = [c["ms"] for c in calls]
        rec["mutable"] = self.knnlm_mutable(bundle, params, store, cfg,
                                            seq_len, rng)
        rec["phase11"] = self.phase11_knnlm(bundle, params, store, prompts,
                                            outputs, ecfg, new)
        self._store = store
        del eng, bundle, params
        if not self.rehearsal:
            torch.cuda.empty_cache()
        return rec

    def serve_timed(self, bundle, params, hook, prompts, ecfg, new,
                    rec: dict, keep_logits: bool = False) -> tuple:
        """Serve ``prompts`` (uids in order, ``new`` tokens each) through an
        engine with ``hook``, the launch counts and the peak set to 0 just
        before: host ms of each admission that prefilled, and of the decode
        and the hook a tick, each ended by a sync.  Fills ``rec`` and
        returns (engine, {uid: tokens}, the hook's calls, each with its
        hidden rows, and with ``keep_logits`` its hooked logits)."""
        import numpy as np
        from repro_torch.serve.engine import Engine, Request
        calls = []

        def timed_hook(logits, hidden):
            self.sync()
            t = time.perf_counter()
            out = hook(logits, hidden)
            self.sync()
            res = hook.last_result
            calls.append({"ms": 1e3 * (time.perf_counter() - t),
                          "rows": int(hidden.shape[0]),
                          "candidates": res.num_candidates.tolist(),
                          "hidden": hidden.clone()})
            if keep_logits:
                calls[-1]["logits"] = out.clone()
            return out

        eng = Engine(bundle, params, ecfg, logits_hook=timed_hook)
        for uid, prompt in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
        self.reset_launches()
        self.reset_peak()
        prefill_ms, decode_ms, hook_ms = [], [], []
        t_serve = time.perf_counter()
        while True:
            self.sync()
            t0 = time.perf_counter()
            before = len(calls)
            eng._admit()
            self.sync()
            t1 = time.perf_counter()
            if len(calls) > before:
                prefill_ms.append(1e3 * (t1 - t0))
            before = len(calls)
            stepped = eng.step()
            self.sync()
            t2 = time.perf_counter()
            if not stepped and not eng.queue:
                break
            if stepped:
                tick_hook = sum(c["ms"] for c in calls[before:])
                hook_ms.append(tick_hook)
                decode_ms.append(1e3 * (t2 - t1) - tick_hook)
        serve_s = time.perf_counter() - t_serve
        rec["serve_launches"] = self.launches()
        rec["serve_flash_kernels"] = self.flash_launches()
        rec["serve_peak_bytes"] = self.peak()
        outputs = {r.uid: r.output for r in eng.finished}
        generated = sum(len(o) for o in outputs.values())
        rec.update(
            serve_s=serve_s, generated_tokens=generated,
            tokens_per_s=generated / serve_s, ticks=eng.ticks,
            prefills=len(prefill_ms), prefill_ms=prefill_ms,
            decode_ms_per_tick=statistics.median(decode_ms),
            hook_ms_per_tick=statistics.median(hook_ms),
            hook_calls=len(calls),
            mean_candidates=float(np.mean([c for call in calls
                                           for c in call["candidates"]])),
            hook_escalations=hook.escalations,
            hook_scan_fallbacks=hook.scan_fallbacks,
            hook_budget=hook.budget_final)
        return eng, outputs, calls

    def offline_greedy(self, bundle, params, prompts, uids, new, max_seq,
                       hook, hooked: list | None = None) -> dict:
        """Prefill one batch of equal-length prompts into fresh caches, then
        greedy decode with the hook, outside the engine; the model's inputs
        as the engine gives them (``model_inputs``: M-RoPE positions, zero
        extras).  Appends each step's hooked logits to ``hooked`` where
        given."""
        torch = self.torch
        import numpy as np
        from repro_torch.models.registry import model_inputs, model_positions
        b, s = len(prompts), len(prompts[0])
        toks = torch.as_tensor(np.stack(prompts), device=self.dev)
        pos = torch.arange(s, device=self.dev)[None].expand(b, s)
        caches = bundle.init_cache(b, max_seq)
        lengths = torch.zeros((b,), dtype=torch.int32, device=self.dev)
        hidden, caches = bundle.prefill(params,
                                        model_inputs(bundle, toks, pos),
                                        caches, lengths)

        def sample(logits, last):
            out = hook(logits, last)
            if hooked is not None:
                hooked.append(out.clone())
            return torch.argmax(out, -1)

        last = hidden[:, -1]
        tok = sample(bundle.logits(params, last), last)
        out = [tok]
        lengths = lengths + s
        for _ in range(new - 1):
            logits, last, caches = bundle.decode_step(
                params, tok[:, None],
                model_positions(bundle.cfg, lengths[:, None]), caches,
                lengths)
            tok = sample(logits, last)
            out.append(tok)
            lengths = lengths + 1
        seqs = torch.stack(out, 1).cpu().tolist()
        return dict(zip(uids, seqs, strict=True))

    def logits_through_plain(self, cfg, params, prompts) -> dict:
        """Prefill a small batch with #10 and with the plain attention
        (``ops.flash_attention`` swapped for ``ref.flash_attention``), in
        the fp32 compute dtype (held: max |diff| <= 1e-5 of max |logits|,
        about 80 fp32 epsilons, the drift of sums in another order through
        30 layers; and a planted fault read against that limit: the plain
        attention with one 32-key kv tile of the fp32 kernel in the middle
        dropped in every layer) and in bf16 (reported: the plain version
        rounds bf16 logits and probabilities, the kernel does not).

        An MoE model's experts are compared first (``compare_routes``):
        the first layer whose experts differ may differ only at near ties
        (``ROUTE_NEAR_TIE``), and the 1e-5 rule then holds against the
        plain attention run with the kernel run's experts in every layer
        (run, and held, whether or not a route differed)."""
        torch, ref = self.torch, self.ref
        import dataclasses

        import numpy as np
        from repro_torch.kernels import ops
        from repro_torch.models import moe
        from repro_torch.models.registry import build_model, model_inputs
        out = {}
        toks = torch.as_tensor(np.stack(prompts), device=self.dev)
        b, s = toks.shape
        pos = torch.arange(s, device=self.dev)[None].expand(b, s)
        is_moe = getattr(cfg, "ffn_kind", None) == "moe"

        # A window narrower than the tile (the reduced configs') keeps half
        # its keys, so no row loses them all.  An encoder-decoder's
        # encoder loses the same key positions of its frames.
        tile = FLASH_KV_TILE["float32"]
        window = getattr(cfg, "window", None)
        drop = middle_tile(s, min(tile, (window or tile) // 2 or 1))

        def dropping(q, k, v, *, causal=True, window=None, scale=None):
            assert scale is None
            return attention_dropping(torch, q, k, v, causal, drop,
                                      window).to(q.dtype)

        def first_logits(bundle, attention, forced=None):
            with swapped(ops, "flash_attention", attention), \
                    routes_logged(torch, moe, forced) as log:
                hidden, _ = bundle.prefill(
                    params, model_inputs(bundle, toks, pos),
                    bundle.init_cache(b, s),
                    torch.zeros((b,), dtype=torch.int32, device=self.dev))
            return bundle.logits(params, hidden[:, -1]), log

        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            bundle = build_model(dataclasses.replace(cfg, compute_dtype=dt),
                                 device=self.dev)
            (got, got_routes), (want, want_routes) = (
                first_logits(bundle, attention)
                for attention in (ops.flash_attention, ref.flash_attention))
            diff = float((got - want).abs().max())
            scale = float(want.abs().max())
            out[name] = {"max_abs_diff": diff, "max_abs_logit": scale,
                         "argmax_equal": bool(torch.equal(
                             got.argmax(-1), want.argmax(-1)))}
            if is_moe:
                out[name]["routes"] = compare_routes(torch, got_routes,
                                                     want_routes)
            if name != "fp32":
                continue
            limit = 1e-5 * scale
            fault = float((first_logits(bundle, dropping)[0]
                           - want).abs().max())
            out[name].update(diff_over_tol=diff / limit,
                             planted_fault_over_tol=fault / limit)
            expect(fault > limit,
                   f"a dropped kv tile in every layer moves the fp32 "
                   f"logits by only {fault} (max |logit| {scale})")
            if is_moe:
                routes = out[name]["routes"]
                expect(routes["first_flip_near_ties"],
                       f"{cfg.name}: #10 and the plain attention choose other "
                       f"experts away from a near tie: {routes}")
                forced, _ = first_logits(bundle, ref.flash_attention,
                                         [r["ids"] for r in got_routes])
                diff = float((got - forced).abs().max())
                scale = float(forced.abs().max())
                limit = 1e-5 * scale
                out[name].update(forced_max_abs_diff=diff,
                                 forced_diff_over_tol=diff / limit)
                expect(routes["flipped_tokens"] > 0
                       or torch.equal(forced, want),
                       f"{cfg.name}: the plain attention with its own experts "
                       "forced gives other logits than without")
            expect(diff <= limit,
                   f"fp32 first-token logits through #10 differ from the "
                   f"plain attention's by {diff} (max |logit| {scale})")
        return out

    def host_ms(self, fn, reps: int) -> float:
        """Median host ms of ``fn`` ended by a sync, after a warm run."""
        fn()
        self.sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    # -- phase 13: the recurrent families --------------------------------
    def phase_recurrent(self) -> dict:
        """recurrentgemma-2b (RG-LRU and local attention through #10 at
        D = 256) over phase 7's corpus size, then rwkv6-1.6b (no attention
        layer) over RWKV_CORPUS_SEQS sequences, each at full width serving
        phase 7's traffic with the hook; #9 on recurrentgemma's keys (phase
        8's checks)."""
        rec = {"seconds": 0.0}
        t0 = time.perf_counter()
        rec["recurrentgemma"] = self.model_drive("recurrentgemma-2b",
                                                 CORPUS_SEQS)
        rec["pccp"] = self.phase_pccp(rec["recurrentgemma"].pop("store"))
        rec["rwkv6"] = self.model_drive("rwkv6-1.6b", RWKV_CORPUS_SEQS)
        rec["rwkv6"].pop("store")
        rec["seconds"] = time.perf_counter() - t0
        say(f"phase 13: {rec['seconds']:.1f} s")
        return rec

    def model_drive(self, arch: str, num_seqs: int, **overrides) -> dict:
        """One model at full width (its config with ``overrides``; the
        reduced config and a small corpus in a CPU rehearsal) with seeded
        random weights: the datastore build, then NUM_REQUESTS prompts of
        PROMPT_LEN through SLOTS slots with the hook (phase 7's checks: the
        engine's tokens against an offline greedy loop with the hook, the
        hook's last tick against brute force, the fp32 first-token logits
        through #10 against the plain attention where the model has
        attention); a recurrent model's requests admitted into used slots
        against a fresh engine (``check_reused_slots``); an MoE model's
        layer on the card against the CPU (``check_moe_layer``); an
        encoder-decoder's hooked logits of every sampling step against the
        offline loop's, bit for bit (its encoder and decoder layers each
        launch #10 once a forward batch and a prefill).  Keeps the store
        in the record for phase 8's checks."""
        torch = self.torch
        import numpy as np
        from repro_torch import configs
        from repro_torch.models.encdec import EncDecConfig
        from repro_torch.models.registry import build_model, model_inputs
        from repro_torch.serve.engine import Engine, EngineConfig, Request
        from repro_torch.serve.knnlm import (FORWARD_BATCH, KNNLMHook,
                                             build_datastore)
        if self.rehearsal:
            cfg = configs.get_reduced(arch)
            num_seqs, seq_len, prompt_len, max_seq, new = 8, 32, 16, 40, 4
        else:
            cfg = configs.get_config(arch, **overrides)
            seq_len, prompt_len, max_seq, new = (CORPUS_LEN, PROMPT_LEN,
                                                 MAX_SEQ, NEW_TOKENS)
        enc_dec = isinstance(cfg, EncDecConfig)
        if enc_dec:
            kinds = {"encoder": cfg.encoder_layers,
                     "decoder": cfg.decoder_layers}
            attn_layers, recurrent = cfg.num_layers, False
        else:
            layer_kinds = cfg.layer_kinds()
            kinds = {k: layer_kinds.count(k) for k in set(layer_kinds)}
            attn_layers = sum(k in ("attn", "local_attn")
                              for k in layer_kinds)
            recurrent = any(k in ("rglru", "rwkv") for k in layer_kinds)
        ffn_kind = getattr(cfg, "ffn_kind", "plain")
        rec = {"arch": arch, "layers": cfg.num_layers,
               "published_layers": configs.get_config(arch).num_layers,
               "d_model": cfg.d_model, "kinds": kinds,
               "head_dim": cfg.head_dim if attn_layers else None,
               "corpus": [num_seqs, seq_len], "requests": NUM_REQUESTS,
               "prompt_len": prompt_len, "slots": SLOTS, "max_seq": max_seq,
               "max_new_tokens": new, "k": KNN_K}
        t_drive = time.perf_counter()
        rng = np.random.default_rng(SEED)
        self.sync()
        t0 = time.perf_counter()
        bundle = build_model(cfg, device=self.dev)
        params = bundle.init(SEED)
        self.sync()
        rec["init_s"] = time.perf_counter() - t0
        rec["params"] = bundle.count_params
        rec["weight_bytes"] = 4 * bundle.count_params
        label = cfg.name
        say(f"{label}: {cfg.num_layers} of {rec['published_layers']} layers "
            f"{rec['kinds']}, d_model {cfg.d_model}, ffn {ffn_kind}, "
            f"{bundle.count_params} parameters (fp32, cast to "
            f"{str(cfg.compute_dtype)[6:]} at each use) in "
            f"{rec['init_s']:.2f} s")

        corpus = rng.integers(1, cfg.vocab_size, (num_seqs, seq_len))
        self.reset_launches()
        self.reset_peak()
        t0 = time.perf_counter()
        store = build_datastore(bundle, params, corpus,
                                family="squared_euclidean", m=None,
                                seed=SEED)
        self.sync()
        rec["build_s"] = time.perf_counter() - t0
        rec["build_peak_bytes"] = self.peak()
        rec["build_launches"] = self.launches()
        rec["build_flash_kernels"] = self.flash_launches()
        batches = -(-num_seqs // FORWARD_BATCH)
        index = store.index
        rec.update(forward_batches=batches, keys=index.n, m=index.m,
                   num_clusters=index.num_clusters,
                   key_bytes=index.data.numel() * 4)
        self.expect_launches(f"{label} datastore build",
                             rec["build_launches"],
                             ("flash_attention",) if attn_layers else (),
                             False)
        if not self.rehearsal:
            expect(rec["build_launches"]["flash_attention"]
                   == attn_layers * batches
                   == rec["build_flash_kernels"]["bf16_wgmma"],
                   f"{label} datastore build: #10 ran "
                   f"{rec['build_flash_kernels']}, not {attn_layers} layers "
                   f"x {batches} batches on the bf16 kernel")
        toks = torch.as_tensor(corpus[:FORWARD_BATCH], device=self.dev)
        pos = torch.arange(seq_len, device=self.dev)[None].expand(
            toks.shape[0], seq_len)
        batch = model_inputs(bundle, toks, pos)
        self.reset_peak()
        rec["forward_ms_per_batch"] = self.host_ms(
            lambda: bundle.forward_train(params, batch), reps=2)
        del batch
        rec["forward_peak_bytes"] = self.peak()
        say(f"{label} datastore: {index.n} keys x {cfg.d_model} fp32 "
            f"({rec['key_bytes']} B), M* = {index.m}, {index.num_clusters} "
            f"clusters; build {rec['build_s']:.2f} s ({batches} forward "
            f"batches of {FORWARD_BATCH} x {seq_len}, "
            f"{rec['forward_ms_per_batch']:.1f} ms each, peak of a forward "
            f"{rec['forward_peak_bytes']} B), build peak "
            f"{rec['build_peak_bytes']} B; #10 launches by kernel "
            f"{rec['build_flash_kernels']}")

        prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
                   for _ in range(NUM_REQUESTS)]
        hook = KNNLMHook(store=store, k=KNN_K)
        ecfg = EngineConfig(slots=SLOTS, max_seq=max_seq,
                            prefill_len=prompt_len)
        eng, outputs, calls = self.serve_timed(bundle, params, hook, prompts,
                                               ecfg, new, rec,
                                               keep_logits=enc_dec)
        expect(len(outputs) == NUM_REQUESTS
               and all(len(o) == new for o in outputs.values())
               and all(0 <= t < cfg.vocab_size for o in outputs.values()
                       for t in o),
               f"{label}: not every request got its tokens in the vocab")
        rec["distinct_tokens"] = len({t for o in outputs.values()
                                      for t in o})
        self.expect_launches(f"{label} serving", rec["serve_launches"],
                             (("flash_attention",) if attn_layers else ())
                             + RESIDENT_PATH, False)
        if not self.rehearsal:
            expect(rec["serve_launches"]["flash_attention"]
                   == attn_layers * rec["prefills"]
                   == rec["serve_flash_kernels"]["bf16_wgmma"],
                   f"{label} serving: #10 ran {rec['serve_flash_kernels']}, "
                   f"not {attn_layers} layers x {rec['prefills']} prefills "
                   "on the bf16 kernel")
        say(f"{label} serving: {NUM_REQUESTS} requests x {new} tokens, "
            f"{SLOTS} slots, prompts {prompt_len}: {rec['serve_s']:.2f} s, "
            f"{rec['tokens_per_s']:.1f} tokens/s; prefill ms "
            f"{rec['prefill_ms']}; decode {rec['decode_ms_per_tick']:.2f} ms "
            f"and hook {rec['hook_ms_per_tick']:.2f} ms per tick (medians "
            f"of {rec['ticks']}); hook escalations {hook.escalations}; "
            f"launches {rec['serve_launches']} (#10 by kernel "
            f"{rec['serve_flash_kernels']}); peak {rec['serve_peak_bytes']} "
            "B")

        last = calls[-1]
        keys = index.data[torch.argsort(index.point_ids.long())]
        rec["brute_force"] = self.check_brute_force(
            keys, last["hidden"].float(), hook.last_result.ids,
            hook.last_result.dists, "squared_euclidean", k=KNN_K)
        engine_logits = [c.pop("logits") for c in calls] if enc_dec else None
        del keys, calls
        say(f"{label}: the hook's ids on the last tick match brute force "
            f"over the datastore ({rec['brute_force']})")

        check_hook = KNNLMHook(store=store, k=KNN_K)
        offline, offline_logits = {}, [] if enc_dec else None
        for w0 in range(0, NUM_REQUESTS, SLOTS):
            uids = list(range(w0, min(w0 + SLOTS, NUM_REQUESTS)))
            offline.update(self.offline_greedy(
                bundle, params, [prompts[u] for u in uids], uids, new,
                max_seq, check_hook, hooked=offline_logits))
        expect(offline == outputs, f"{label}: the engine's tokens differ "
               "from the offline greedy loop")
        say(f"{label}: the engine's {rec['generated_tokens']} tokens "
            f"({rec['distinct_tokens']} distinct) equal the offline greedy "
            "prefill + decode loop (the second wave in slots the first "
            "used)")
        if enc_dec:
            # Seeded whisper weights decode one token over and over, so the
            # hooked logits of every sampling step are held too: the loop
            # runs the engine's batch shapes, so they are the same bits.
            expect(len(offline_logits) == len(engine_logits)
                   and all(torch.equal(a, b) for a, b in
                           zip(engine_logits, offline_logits, strict=True)),
                   f"{label}: the engine's hooked logits differ from the "
                   "offline greedy loop's")
            rec["hooked_logits_steps_bit_equal"] = len(engine_logits)
            say(f"{label}: the hooked logits of all {len(engine_logits)} "
                "sampling steps equal the offline loop's bit for bit")
            del engine_logits, offline_logits

        if recurrent:
            rec["reused_slots"] = self.check_reused_slots(
                bundle, params, check_hook, prompts, label)
        if ffn_kind == "moe":
            rec["moe_layer"] = self.check_moe_layer(bundle, params, prompts,
                                                    label)

        if attn_layers:
            rec["logits_check"] = self.logits_through_plain(
                cfg, params, prompts[:LOGITS_BATCH])
            say(f"{label}: first-token logits through #10 against the "
                "plain attention " + json.dumps(rec["logits_check"]))

        # Device time by kernel over a shorter serving run (phase 7's).
        def short_run():
            e = Engine(bundle, params, ecfg, logits_hook=hook)
            for uid in range(SLOTS):
                e.submit(Request(uid=uid, prompt=prompts[uid],
                                 max_new_tokens=PROFILE_TOKENS))
            e.run()
            self.sync()

        rec["profile"] = self.profile(short_run,
                                      self.host_ms(short_run, reps=1))
        rec["profile"]["what"] = (f"{SLOTS} requests x {PROFILE_TOKENS} "
                                  "tokens, one admission")
        say(f"{label}: device busy {rec['profile']['busy_share']} of a "
            f"{SLOTS}-request, {PROFILE_TOKENS}-token serving run; top "
            "kernels " + json.dumps(rec["profile"].get("top", [])[:5]))
        rec["seconds"] = time.perf_counter() - t_drive
        rec["store"] = store
        del eng, bundle, params, hook, check_hook
        if not self.rehearsal:
            torch.cuda.empty_cache()
        return rec

    def check_reused_slots(self, bundle, params, hook, prompts,
                           label: str) -> dict:
        """SLOTS requests admitted into slots that SLOTS others used leave
        the recurrent states a fresh engine gives them, bit for bit, and
        decode its tokens.  The prompts are REUSE_PROMPT_LEN tokens long,
        short enough that a leaked state still shows after the prefill (a
        512-token prefill decays RWKV's old state to nothing in fp32); an
        engine whose admission keeps the old states must differ."""
        from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                              _cache_leaves)
        short, new = REUSE_PROMPT_LEN, REUSE_NEW_TOKENS
        ecfg = EngineConfig(slots=SLOTS, max_seq=short + new,
                            prefill_len=short)
        first = [prompts[u][:short] for u in range(SLOTS)]
        second = [prompts[SLOTS + u][:short] for u in range(SLOTS)]
        used, leaky, fresh = (Engine(bundle, params, ecfg, logits_hook=hook)
                              for _ in range(3))
        leaky._zero_states = lambda rows: None        # the reference's way
        for eng in (used, leaky):
            for uid, prompt in enumerate(first):
                eng.submit(Request(uid=uid, prompt=prompt,
                                   max_new_tokens=new))
            eng.run()
        for eng in (used, leaky, fresh):
            for uid, prompt in enumerate(second):
                eng.submit(Request(uid=SLOTS + uid, prompt=prompt,
                                   max_new_tokens=new))
            eng._admit()
        used_s, leaky_s, fresh_s = (_cache_leaves(e.caches,
                                                  recurrent_only=True)
                                    for e in (used, leaky, fresh))
        self.sync()
        equal = all(self.torch.equal(a, b)
                    for a, b in zip(used_s, fresh_s, strict=True))
        leak = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(leaky_s, fresh_s, strict=True))
        tokens = [{r.uid: r.output for r in e.run() if r.uid >= SLOTS}
                  for e in (used, leaky, fresh)]
        expect(equal, f"{label}: requests admitted into used slots start "
               "from other recurrent states than on a fresh engine")
        expect(leak > 0, f"{label}: an admission that keeps the old "
               "recurrent states leaves the fresh engine's states")
        expect(tokens[0] == tokens[2],
               f"{label}: requests re-admitted into used slots give other "
               "tokens than on fresh slots")
        out = {"prompt_len": short, "max_new_tokens": new,
               "state_tensors": len(used_s), "states_bit_equal": equal,
               "leaked_max_abs_diff": leak,
               "leak_changes_tokens": tokens[1] != tokens[2]}
        moved = (" and changes the tokens" if out["leak_changes_tokens"]
                 else "")
        say(f"{label}: {SLOTS} requests re-admitted into used slots start "
            f"from a fresh engine's {len(used_s)} recurrent state tensors bit "
            f"for bit and give its {new} tokens ({short}-token prompts; "
            f"keeping the old states moves them by up to {leak:.3g}{moved})")
        del used, leaky, fresh
        return out

    def check_moe_layer(self, bundle, params, prompts, label: str) -> dict:
        """Layer 0's MoE FFN at full width in fp32 on the card against the
        same layer on the CPU, on its own input in a prefill of SLOTS
        prompts (the engine's admission batch: groups of one prompt each),
        cast to fp32.  Held: the same experts for every token, a flip
        excused only at a near tie (ROUTE_NEAR_TIE; its group then left out
        of what follows); the same assignments dropped; the outputs within
        1e-5 of the largest |output| (sums in another order on the two
        devices)."""
        torch = self.torch
        import numpy as np
        from repro_torch.models import moe
        cfg = bundle.cfg
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.stack(prompts[:SLOTS]), device=self.dev)
        b, s = toks.shape
        pos = torch.arange(s, device=self.dev)[None].expand(b, s)
        inputs, apply_moe = [], moe.apply_moe

        def first_input(p, x, *args, **kwargs):
            if not inputs:
                inputs.append(x.float())
            return apply_moe(p, x, *args, **kwargs)

        with swapped(moe, "apply_moe", first_input):
            bundle.prefill(
                params, {"tokens": toks, "positions": pos},
                bundle.init_cache(b, s),
                torch.zeros((b,), dtype=torch.int32, device=self.dev))
        x = inputs.pop()
        ffn = params["layers"][0]["ffn"]
        runs = {}
        for where, dev in (("card", self.dev), ("cpu", torch.device("cpu"))):
            p = {k: v.to(dev) for k, v in ffn.items() if k != "shared"}
            shared = ({k: v.to(dev) for k, v in ffn["shared"].items()}
                      if "shared" in ffn else None)
            with routes_logged(torch, moe) as log:
                y, aux = moe.apply_moe(p, x.to(dev), cfg.moe, act=cfg.act,
                                       shared_mlp=shared)
            self.sync()
            runs[where] = {"y": y.cpu(), "aux": float(aux),
                           **{k: v.cpu() for k, v in log[0].items()}}
            del p, shared, y
        card, cpu = runs["card"], runs["cpu"]
        routes = compare_routes(torch, [card], [cpu])
        expect(routes["first_flip_near_ties"],
               f"{label}: the card's MoE layer chooses other experts than "
               f"the CPU's away from a near tie: {routes}")
        ids_c, order_c = torch.sort(card["ids"], -1)
        ids_h, order_h = torch.sort(cpu["ids"], -1)
        flipped = (ids_c != ids_h).any(-1)                  # (G, S)
        same = ~flipped.any(-1)                             # groups
        keep_c = card["keep"].gather(-1, order_c)[same]
        keep_h = cpu["keep"].gather(-1, order_h)[same]
        expect(torch.equal(keep_c, keep_h),
               f"{label}: the card's MoE layer drops other assignments than "
               "the CPU's")
        g = same.shape[0]
        y_c = card["y"].reshape(g, -1, x.shape[-1])[same]
        y_h = cpu["y"].reshape(g, -1, x.shape[-1])[same]
        diff = float((y_c - y_h).abs().max())
        scale = float(y_h.abs().max())
        out = {"tokens": b * s, "groups": g,
               "capacity": moe._capacity(cfg.moe, cfg.moe.group_tokens),
               "groups_compared": int(same.sum()),
               "assignments_dropped": int((~cpu["keep"]).sum()),
               "zero_weight": int((cpu["w"] == 0).sum()),
               "assignments": cpu["keep"].numel(), "routes": routes,
               "max_abs_diff": diff, "max_abs_out": scale,
               "diff_over_tol": diff / (1e-5 * scale),
               "aux_card": card["aux"], "aux_cpu": cpu["aux"],
               "seconds": time.perf_counter() - t0}
        expect(diff <= 1e-5 * scale,
               f"{label}: the card's MoE layer differs from the CPU's by "
               f"{diff} (max |out| {scale})")
        out["shares"] = self.check_moe_shares(ffn, x, cfg, card, label)
        say(f"{label}: MoE layer 0 in fp32 on the card equals the CPU's over "
            f"{b * s} tokens in {g} groups (capacity {out['capacity']}): the "
            f"same experts ({routes['flipped_tokens']} tokens flipped at near "
            f"ties, smallest top-{cfg.moe.top_k} gap {routes['min_gap']:.3g})"
            f", the same {out['assignments_dropped']} of "
            f"{out['assignments']} assignments dropped ({out['zero_weight']} "
            "of them at weight 0), max |diff| "
            f"{diff:.3g} ({out['diff_over_tol']:.3g} of 1e-5 x max |out|)")
        return out

    def check_moe_shares(self, ffn, x, cfg, card: dict, label: str) -> dict:
        """Expert parallelism on the one card: EP_RANKS model ranks'
        shares of layer 0 on its fp32 input (``moe.apply_moe_share``:
        routing over all experts, each rank's E / EP_RANKS experts
        dispatched and combined, a shared expert by its columns), summed
        in rank order, against the whole layer on the card (``card``).
        Held: every share chooses the whole layer's experts, and the sum
        lies within 1e-5 of max |output| (partial outputs added in another
        order).  The collective that sums them across cards is not run:
        the card is one rank."""
        torch = self.torch
        from repro_torch.models import moe
        t0 = time.perf_counter()
        p = {k: v.to(self.dev) for k, v in ffn.items() if k != "shared"}
        shared = ({k: v.to(self.dev) for k, v in ffn["shared"].items()}
                  if "shared" in ffn else None)
        xd, total, same = x.to(self.dev), None, True
        for rank in range(EP_RANKS):
            with routes_logged(torch, moe) as log:
                y = moe.apply_moe_share(p, xd, cfg.moe, rank, EP_RANKS,
                                        act=cfg.act, shared_mlp=shared)
            same = same and torch.equal(log[0]["ids"].cpu(), card["ids"])
            total = y if total is None else total + y
        self.sync()
        total = total.cpu()
        del p, shared, xd, y
        diff = float((total - card["y"]).abs().max())
        scale = float(card["y"].abs().max())
        out = {"ranks": EP_RANKS,
               "experts_a_rank": cfg.moe.num_experts // EP_RANKS,
               "same_experts": same, "max_abs_diff": diff,
               "max_abs_out": scale, "diff_over_tol": diff / (1e-5 * scale),
               "seconds": time.perf_counter() - t0}
        expect(same, f"{label}: an expert-parallel share chose other "
               "experts than the whole layer on the card")
        expect(diff <= 1e-5 * scale,
               f"{label}: {EP_RANKS} expert-parallel shares sum to {diff} "
               f"from the whole layer on the card (max |out| {scale})")
        say(f"{label}: {EP_RANKS} model ranks' shares of MoE layer 0 "
            f"({out['experts_a_rank']} experts each) on the card sum to the "
            f"whole layer: the same experts, max |diff| {diff:.3g} "
            f"({out['diff_over_tol']:.3g} of 1e-5 x max |out|), "
            f"{out['seconds']:.1f} s")
        return out

    # -- phase 14: the MoE FFN and the dense configs ----------------------
    def phase_moe(self) -> dict:
        """qwen3-moe-30b-a3b at full width, MOE_LAYERS of its 48 layers,
        over phase 7's corpus and traffic (``model_drive``), #9 on its keys
        (phase 8's checks), then each of DEPTH2_ARCHS at full width and
        depth 2 (``depth2_check``)."""
        rec = {"seconds": 0.0}
        t0 = time.perf_counter()
        rec["qwen3_moe"] = self.model_drive("qwen3-moe-30b-a3b", CORPUS_SEQS,
                                            num_layers=MOE_LAYERS)
        rec["pccp"] = self.phase_pccp(rec["qwen3_moe"].pop("store"))
        rec["depth2"] = {arch: self.depth2_check(arch)
                         for arch in DEPTH2_ARCHS}
        rec["seconds"] = time.perf_counter() - t0
        say(f"phase 14: {rec['seconds']:.1f} s")
        return rec

    # -- phase 15: the encoder-decoder and M-RoPE ------------------------
    def phase_encdec(self) -> dict:
        """whisper-tiny at full size, then qwen2-vl-72b at full width with
        QWEN2_VL_LAYERS of its 80 layers, each over phase 7's corpus and
        traffic (``model_drive``) and then phase 8's checks of #9 on its
        keys."""
        rec = {"seconds": 0.0}
        t0 = time.perf_counter()
        rec["whisper"] = self.model_drive("whisper-tiny", CORPUS_SEQS)
        rec["whisper_pccp"] = self.phase_pccp(rec["whisper"].pop("store"))
        rec["qwen2_vl"] = self.model_drive("qwen2-vl-72b", CORPUS_SEQS,
                                           num_layers=QWEN2_VL_LAYERS)
        rec["qwen2_vl_pccp"] = self.phase_pccp(rec["qwen2_vl"].pop("store"))
        rec["seconds"] = time.perf_counter() - t0
        say(f"phase 15: {rec['seconds']:.1f} s")
        return rec

    # -- phase 16: training the dense decoder family -------------------
    def phase_train(self) -> dict:
        """starcoder2-3b trained at full size through the launcher
        (``train_launch``), one fp32 step at full width and depth 2 on the
        card against the CPU (``train_card_vs_cpu``), and a bit-exact
        restart at full width and depth 2 in bf16 (``train_restart``)."""
        rec = {"seconds": 0.0}
        t0 = time.perf_counter()
        rec["full"] = self.train_launch("phase 16a", "starcoder2-3b",
                                        TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO,
                                        TRAIN_STEPS)
        rec["card_vs_cpu"] = self.train_card_vs_cpu(
            "phase 16b", self.train_config("starcoder2-3b",
                                           TRAIN_SMALL_LAYERS),
            1, TRAIN_COMPARE_SEQ)
        rec["restart"] = self.train_restart(
            "phase 16c", self.train_config("starcoder2-3b",
                                           TRAIN_SMALL_LAYERS),
            TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)
        rec["seconds"] = time.perf_counter() - t0
        say(f"phase 16: {rec['seconds']:.1f} s")
        return rec

    # -- phase 17: training the MoE, recurrent, encoder-decoder and VLM
    # families -------------------------------------------------------------
    def phase_train_families(self) -> dict:
        """Each of ``FAMILY_RUNS`` at full size or full width with its depth
        cut (through the launcher, or through ``make_train_step`` where
        the depth is cut), whisper-tiny's restart from a checkpoint, and
        one fp32 step on the card against the CPU for each family's
        reduced config and two configs at full width and one layer
        (``CARD_VS_CPU``)."""
        rec = {"seconds": 0.0}
        t0 = time.perf_counter()
        for label, (arch, layers, batch, seq, micro, steps) in \
                FAMILY_RUNS.items():
            if layers is None:
                rec[label] = self.train_launch(f"phase {label}", arch, batch,
                                               seq, micro, steps)
            else:
                rec[label] = self.train_direct(f"phase {label}", arch, layers,
                                               batch, seq, micro, steps)
            if arch == "whisper-tiny":
                rec[label]["restart"] = self.train_restart(
                    f"phase {label}", self.train_config(arch), batch, seq,
                    micro)
        rec["17f"] = {}
        for arch, layers, batch, seq, micro in CARD_VS_CPU:
            cfg = self.train_config(arch, layers, reduced=layers is None)
            rec["17f"][f"{arch}/{cfg.num_layers}"] = self.train_card_vs_cpu(
                "phase 17f", cfg, batch, seq, micro)
        rec["seconds"] = time.perf_counter() - t0
        say(f"phase 17: {rec['seconds']:.1f} s")
        return rec

    def train_config(self, arch: str, layers=None, reduced=False,
                     **overrides):
        """``arch``'s config: full width (its depth cut to ``layers`` where
        given), or its reduced config (``reduced``, and always in a CPU
        rehearsal)."""
        import dataclasses
        from repro_torch import configs
        if self.rehearsal or reduced:
            return dataclasses.replace(configs.get_reduced(arch),
                                       **overrides)
        if layers is not None:
            overrides["num_layers"] = layers
        return configs.get_config(arch, **overrides)

    def train_seq(self, seq: int) -> int:
        """A run's sequence length: ``seq``, or TRAIN_REHEARSAL_SEQ at most
        in a CPU rehearsal."""
        return min(seq, TRAIN_REHEARSAL_SEQ) if self.rehearsal else seq

    def expect_no_flash(self, label: str) -> None:
        launched = self.launches()["flash_attention"]
        expect(launched == 0 and not any(self.flash_launches().values()),
               f"{label}: training launched #10 {launched} times "
               f"({self.flash_launches()}); it has no backward pass")

    def expect_training(self, label: str, rec: dict, steps: int,
                        descends: bool = True) -> None:
        """A run's checks: every loss and aux loss finite, the last loss
        below the first (on the card, where ``descends``: in a CPU
        rehearsal the reduced configs' losses over a few batches are
        noise), #10's counters at 0, the card's memory back within 256 MiB
        of where it was (a cuBLAS workspace of the backward thread's
        handle may stay)."""
        import math
        losses = rec["losses"]
        expect(len(losses) == steps and all(
            math.isfinite(x) for x in losses + rec["aux_losses"]),
            f"{label}: losses {losses}, aux losses {rec['aux_losses']}")
        expect(self.rehearsal or not descends or losses[-1] < losses[0],
               f"{label}: the last loss {losses[-1]} is not below the first "
               f"{losses[0]}")
        self.expect_no_flash(label)
        rec["flash_launches"] = self.launches()["flash_attention"]
        gc.collect()
        if not self.rehearsal:
            self.torch.cuda.empty_cache()
        before = rec["left_on_card_bytes"][0]
        rec["left_on_card_bytes"].append(self.left_on_card())
        if not self.rehearsal:
            expect(rec["left_on_card_bytes"][1] - before <= 2 ** 28,
                   f"{label}: {rec['left_on_card_bytes']} B on the card "
                   "before and after the run")

    def say_training(self, rec: dict, how: str) -> None:
        steady = rec["steady_step_ms"]
        aux = ("" if not any(rec["aux_losses"]) else "; aux losses "
               + ", ".join(f"{x:.6f}" for x in rec["aux_losses"]))
        say(f"train {rec['arch']}: {rec['layers']} layers, {rec['batch']} x "
            f"{rec['seq']} tokens in {rec['microbatches']} microbatches, "
            f"{rec['steps']} steps {how}; losses "
            + ", ".join(f"{x:.4f}" for x in rec["losses"]) + aux
            + f"; step ms first {rec['step_ms'][0]:.1f}, median after "
            f"{steady:.1f}; {rec['tokens_per_s']:.1f} tokens/s; peak "
            f"{rec['peak_bytes']} B; #10 launches 0; {rec['seconds']:.1f} s")

    @staticmethod
    def step_rates(rec: dict) -> None:
        """Steady step ms (the median after the first) and tokens/s."""
        step_ms, tokens = rec["step_ms"], rec["batch"] * rec["seq"]
        steady = (statistics.median(step_ms[1:]) if len(step_ms) > 1
                  else step_ms[0])
        rec.update(first_step_ms=step_ms[0], steady_step_ms=steady,
                   tokens_per_s=tokens / (steady / 1e3),
                   tokens_per_s_all_steps=tokens * len(step_ms)
                   / (sum(step_ms) / 1e3))

    def train_launch(self, label: str, arch: str, batch: int, seq: int,
                     micro: int, steps: int) -> dict:
        """``launch/train.py``'s ``main`` at ``arch``'s full size (its
        reduced config at TRAIN_REHEARSAL_SEQ tokens in a CPU rehearsal),
        bf16 compute, ``batch`` x ``seq`` tokens in ``micro`` microbatches,
        ``steps`` steps: exit 0 and ``expect_training``'s checks; each
        step's ms, tokens/s and the peak device bytes recorded."""
        from repro_torch.launch import train as train_launcher
        seq = self.train_seq(seq)
        out = ROOT / "build" / f"train_{arch}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
                "--seq", str(seq), "--microbatches", str(micro),
                "--device", str(self.dev.type), "--record", str(out)]
        if self.rehearsal:
            argv.append("--reduced")
        rec = {"arch": arch, "argv": argv, "batch": batch, "seq": seq,
               "microbatches": micro, "steps": steps,
               "left_on_card_bytes": [self.left_on_card()]}
        self.reset_launches()
        t0 = time.perf_counter()
        rc = train_launcher.main(argv)
        rec.update(exit=rc, seconds=time.perf_counter() - t0)
        expect(rc == 0, f"{label}: launch/train.py exited {rc}")
        run = json.loads(out.read_text())
        rec.update(layers=run["layers"], losses=run["losses"],
                   aux_losses=run["aux_losses"], step_ms=run["step_ms"],
                   peak_bytes=run["peak_bytes"])
        self.step_rates(rec)
        self.expect_training(label, rec, steps)
        self.say_training(rec, f"through launch/train.py (exit {rc})")
        return rec

    def train_direct(self, label: str, arch: str, layers: int, batch: int,
                     seq: int, micro: int, steps: int) -> dict:
        """``make_train_step`` at ``arch``'s full width with its depth cut
        to ``layers`` (the reduced config in a CPU rehearsal), bf16
        compute, the launcher's schedule and batches (``train_batch``:
        M-RoPE positions, zero stub inputs): ``expect_training``'s checks
        and the records of ``train_launch``."""
        from repro_torch.data.pipeline import TokenStreamConfig
        from repro_torch.models.registry import build_model
        from repro_torch.train.optimizer import OptimizerConfig
        from repro_torch.train.train_loop import (TrainConfig,
                                                  init_train_state,
                                                  make_train_step,
                                                  train_batch)
        cfg = self.train_config(arch, layers)
        seq = self.train_seq(seq)
        rec = {"arch": arch, "layers": cfg.num_layers, "batch": batch,
               "seq": seq, "microbatches": micro, "steps": steps,
               "left_on_card_bytes": [self.left_on_card()], "losses": [],
               "aux_losses": [], "step_ms": []}
        t0 = time.perf_counter()
        bundle = build_model(cfg, device=self.dev)
        step = make_train_step(bundle, TrainConfig(
            microbatches=micro, loss_chunk=min(512, seq),
            opt=OptimizerConfig(peak_lr=3e-4, warmup_steps=steps // 10,
                                total_steps=steps)))
        stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch)
        state = init_train_state(bundle, SEED)
        rec["params"] = bundle.count_params
        self.reset_peak()
        self.reset_launches()
        for i in range(steps):
            t1 = time.perf_counter()
            state, metrics = step(state, train_batch(bundle, stream, i))
            rec["losses"].append(float(metrics["loss"]))
            rec["step_ms"].append(1e3 * (time.perf_counter() - t1))
            rec["aux_losses"].append(float(metrics["aux_loss"]))
        rec["peak_bytes"] = self.peak()
        del state, step, bundle, metrics
        rec["seconds"] = time.perf_counter() - t0
        self.step_rates(rec)
        self.expect_training(label, rec, steps)
        if cfg.ffn_kind == "moe":
            expect(all(x > 0 for x in rec["aux_losses"]),
                   f"{label}: aux losses {rec['aux_losses']}")
        self.say_training(rec, "through make_train_step")
        return rec

    def train_card_vs_cpu(self, label: str, cfg, batch: int, seq: int,
                          micro: int = 1) -> dict:
        """One fp32 step (TF32 off) of ``cfg`` on ``batch`` x ``seq`` tokens
        in ``micro`` microbatches, from one state on the card and on the
        CPU: the loss within TRAIN_LOSS_RTOL, the grad norm within
        TRAIN_GRAD_TOL, and the moments and parameters by
        ``repro_torch.train.compare``'s rule at TRAIN_GRAD_TOL.  An MoE
        config's experts are compared first (``compare_routes``): a token
        may take other experts on the card only at a near tie, and the
        card's step is then run again with the CPU's experts
        (``routes_logged``'s replay)."""
        import dataclasses
        torch = self.torch
        from repro_torch.data.pipeline import TokenStreamConfig
        from repro_torch.models import moe
        from repro_torch.models.registry import build_model
        from repro_torch.train.checkpoint import _flatten_with_names
        from repro_torch.train.compare import state_ratios, step_grads
        from repro_torch.train.optimizer import OptimizerConfig
        from repro_torch.train.train_loop import (TrainConfig,
                                                  init_train_state,
                                                  make_train_step,
                                                  train_batch,
                                                  train_state_to)
        expect(self.rehearsal or not torch.backends.cuda.matmul.allow_tf32,
               f"{label} needs TF32 off")
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        seq = min(seq, 32) if self.rehearsal else seq
        cpu = torch.device("cpu")
        tc = TrainConfig(microbatches=micro, loss_chunk=min(512, seq),
                         opt=OptimizerConfig(peak_lr=3e-4, warmup_steps=0,
                                             total_steps=10))
        stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch)
        is_moe = getattr(cfg, "ffn_kind", None) == "moe"
        t0 = time.perf_counter()
        state_cpu = init_train_state(build_model(cfg, device=cpu), SEED)
        state_dev = train_state_to(state_cpu, self.dev)
        spare = train_state_to(state_cpu, self.dev) if is_moe else None
        rec = {"arch": cfg.name, "layers": cfg.num_layers, "batch": batch,
               "seq": seq, "microbatches": micro}
        out, logs = {}, {}

        def run(where, dev, state, forced=None):
            bundle = build_model(cfg, device=dev)
            step = make_train_step(bundle, tc)
            batch_in = train_batch(bundle, stream, 0)
            self.reset_launches()
            t1 = time.perf_counter()
            with routes_logged(torch, moe, forced) as log:
                state, metrics = step(state, batch_in)
            metrics = {k: float(v) for k, v in metrics.items()}
            rec[f"{where}_step_ms"] = 1e3 * (time.perf_counter() - t1)
            self.expect_no_flash(f"{label} ({where})")
            logs[where] = [{k: v.detach().cpu() for k, v in c.items()}
                           for c in log]
            # compared on the card (the CPU's tensors moved there)
            out[where] = ({k: v.detach().to(self.dev) for k, v in
                           _flatten_with_names(state).items()}, metrics)

        run("cpu", cpu, state_cpu)
        run("card", self.dev, state_dev)
        del state_cpu, state_dev
        if is_moe:
            routes = compare_routes(torch, logs["card"], logs["cpu"])
            rec["routes"] = routes
            expect(routes["first_flip_near_ties"],
                   f"{label}: {cfg.name}'s experts on the card differ from "
                   f"the CPU's away from a near tie: {routes}")
            if routes["flipped_tokens"]:
                run("card", self.dev, spare,
                    forced=[c["ids"] for c in logs["cpu"]])
            del spare
        (want, mw), (got, mg) = out["cpu"], out["card"]
        rec["loss"] = [mw["loss"], mg["loss"]]
        rec["aux_loss"] = [mw["aux_loss"], mg["aux_loss"]]
        rec["grad_norm"] = [mw["grad_norm"], mg["grad_norm"]]
        rec["loss_diff_over_tol"] = abs(mg["loss"] - mw["loss"]) / (
            TRAIN_LOSS_RTOL * abs(mw["loss"]))
        rec["grad_norm_diff_over_tol"] = abs(
            mg["grad_norm"] - mw["grad_norm"]) / (TRAIN_GRAD_TOL
                                                  * mw["grad_norm"])
        grads = {n[len(".opt.nu"):]: step_grads(w) for n, w in want.items()
                 if n.startswith(".opt.nu")}
        ratios = state_ratios(want, got, [grads], [mw["lr"]],
                              TRAIN_GRAD_TOL, floor=1e-30)
        rec.update(params_diff_over_tol=ratios["params_diff_over_tol"],
                   moments_diff_over_tol=ratios["moments_diff_over_tol"],
                   dead=len(ratios["dead"]))
        del grads, ratios
        del want, got, out
        rec["seconds"] = time.perf_counter() - t0
        for key in ("loss_diff_over_tol", "grad_norm_diff_over_tol",
                    "params_diff_over_tol", "moments_diff_over_tol"):
            expect(rec[key] <= 1.0, f"{label}: {cfg.name} {key} "
                   f"{rec[key]:.3g}")
        flips = (f", {rec['routes']['flipped_tokens']} tokens' experts "
                 "replayed from the CPU's (near ties)"
                 if rec.get("routes", {}).get("flipped_tokens") else "")
        say(f"train card vs cpu: {cfg.name} at {cfg.num_layers} layers, "
            f"fp32, {batch} x {seq}: loss {mg['loss']:.6f} / "
            f"{mw['loss']:.6f} ({rec['loss_diff_over_tol']:.3g} of the "
            f"limit), grad norm {rec['grad_norm_diff_over_tol']:.3g}, "
            f"moments {rec['moments_diff_over_tol']:.3g}, parameters "
            f"{rec['params_diff_over_tol']:.3g} of theirs ({rec['dead']} "
            f"leaves without a gradient){flips}; step ms card "
            f"{rec['card_step_ms']:.1f}, cpu {rec['cpu_step_ms']:.1f}; "
            f"{rec['seconds']:.1f} s")
        return rec

    def train_restart(self, label: str, cfg, batch: int, seq: int,
                      micro: int) -> dict:
        """TRAIN_RESTART_STEPS bf16 steps of ``cfg`` (``batch`` x ``seq`` in
        ``micro`` microbatches), a checkpoint at step TRAIN_SAVE_AT, its
        restore onto the card and the last steps again: the losses and the
        final state bit-equal."""
        import shutil
        torch = self.torch
        from repro_torch.data.pipeline import TokenStreamConfig
        from repro_torch.models.registry import build_model
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train.optimizer import (OptimizerConfig, tree_leaves,
                                                 tree_map)
        from repro_torch.train.train_loop import (TrainConfig,
                                                  init_train_state,
                                                  make_train_step,
                                                  train_batch)
        seq = self.train_seq(seq)
        t0 = time.perf_counter()
        bundle = build_model(cfg, device=self.dev)
        step = make_train_step(bundle, TrainConfig(
            microbatches=micro, loss_chunk=min(512, seq),
            opt=OptimizerConfig(peak_lr=3e-4, warmup_steps=0,
                                total_steps=10)))
        stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch)
        state = init_train_state(bundle, SEED)
        directory = ROOT / "build" / "train_restart_ckpt"
        shutil.rmtree(directory, ignore_errors=True)
        rec = {"arch": cfg.name, "layers": cfg.num_layers, "seq": seq,
               "step_ms": []}
        self.reset_launches()
        losses = []
        try:
            for i in range(TRAIN_RESTART_STEPS):
                if i == TRAIN_SAVE_AT:
                    t1 = time.perf_counter()
                    path = ckpt.save_checkpoint(str(directory), i, state)
                    rec["save_s"] = time.perf_counter() - t1
                    rec["checkpoint_bytes"] = sum(
                        f.stat().st_size for f in Path(path).iterdir())
                t1 = time.perf_counter()
                state, m = step(state, train_batch(bundle, stream, i))
                losses.append(float(m["loss"]))
                rec["step_ms"].append(1e3 * (time.perf_counter() - t1))
            t1 = time.perf_counter()
            again = ckpt.restore_checkpoint(
                str(directory), TRAIN_SAVE_AT,
                tree_map(lambda t: t.to("meta"), state), device=self.dev)
            self.sync()
            rec["restore_s"] = time.perf_counter() - t1
            replay = []
            for i in range(TRAIN_SAVE_AT, TRAIN_RESTART_STEPS):
                again, m = step(again, train_batch(bundle, stream, i))
                replay.append(float(m["loss"]))
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        self.expect_no_flash(label)
        rec["losses"], rec["replayed_losses"] = losses, replay
        expect(replay == losses[TRAIN_SAVE_AT:],
               f"{label}: losses {losses} replayed as {replay}")
        differ = [i for i, (a, b) in enumerate(zip(
            tree_leaves(state), tree_leaves(again), strict=True))
            if not torch.equal(a, b)]
        expect(not differ, f"{label}: {len(differ)} state tensors differ "
               "after the restart")
        rec["state_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(state))
        del state, again, bundle, step
        gc.collect()
        rec["seconds"] = time.perf_counter() - t0
        say(f"train restart: {cfg.name} at {cfg.num_layers} layers, bf16, "
            f"{batch} x {seq}: a restart from step {TRAIN_SAVE_AT} "
            f"repeats losses {replay} and the final state bit for bit "
            f"({rec['state_bytes']} B of state, checkpoint "
            f"{rec['checkpoint_bytes']} B saved in {rec['save_s']:.1f} s, "
            f"restored in {rec['restore_s']:.1f} s); {rec['seconds']:.1f} s")
        return rec

    # -- phase 18: sharded training and the dist/ substrates at world
    # size 1 over NCCL -----------------------------------------------------
    def phase_sharded(self) -> dict:
        """One world-size-1 group (NCCL on the card, its bootstrap on the
        loopback; gloo in a CPU rehearsal) for the phase, ended after it:
        a) the ring matmuls, int8 compression and the pipeline at p = 1
        against their oracles; b) the sharded step on a (1, 1) mesh
        against the mesh-less step for the dense and MoE reduced configs;
        c) starcoder2-3b at 16a's size through ``make_train_step(...,
        mesh=)`` on a (1,) data mesh, against 16a's losses."""
        import os
        import torch.distributed as dist
        from repro_torch.dist.sharding import make_mesh
        if not self.rehearsal:
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        expect(not dist.is_initialized(),
               "phase 18: a process group is already running")
        rec = {"seconds": 0.0}
        t0 = time.perf_counter()
        mesh2 = make_mesh((1, 1), ("data", "model"), device=self.dev.type)
        rec["backend"] = dist.get_backend()
        expect(rec["backend"] == ("gloo" if self.rehearsal else "nccl"),
               f"phase 18: the group's backend is {rec['backend']}")
        try:
            rec["18a"] = self.sharded_substrates(mesh2)
            rec["18b"] = {arch: self.sharded_vs_meshless(mesh2, arch)
                          for arch in ("starcoder2-3b", "qwen3-moe-30b-a3b")}
            rec["18c"] = self.sharded_full(
                make_mesh((1,), ("data",), device=self.dev.type))
        finally:
            dist.destroy_process_group()
        rec["seconds"] = time.perf_counter() - t0
        say(f"phase 18: {rec['seconds']:.1f} s")
        return rec

    def sharded_substrates(self, mesh) -> dict:
        """18a: at p = 1 over the group, ``ag_matmul`` and
        ``ag_matmul_reference`` equal ``x @ w`` bit for bit (TF32 off),
        ``matmul_rs`` too; ``compressed_psum_mean`` gives the dequantized
        codes, the CPU's codes and scale, and the residual the CPU's fp64
        (FMA-rounded) error; ``pipeline_apply`` with one stage equals the
        stage on every microbatch."""
        torch = self.torch
        from repro_torch.dist.collective_matmul import (ag_matmul,
                                                        ag_matmul_reference,
                                                        matmul_rs)
        from repro_torch.dist.compression import (_quantize_int8,
                                                  compressed_psum_mean)
        from repro_torch.dist.pipeline import pipeline_apply
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        n = 256 if self.rehearsal else 4096
        x = torch.randn((n, 1024), generator=gen, device=self.dev)
        w = torch.randn((1024, 1024), generator=gen, device=self.dev)
        full = x @ w
        out = {"matmul_shape": [n, 1024, 1024]}
        for name, fn in (("ag_matmul", ag_matmul),
                         ("ag_matmul_reference", ag_matmul_reference),
                         ("matmul_rs", matmul_rs)):
            got = fn(x, w, mesh, "data")
            out[name] = bool(torch.equal(got, full))
            expect(out[name], f"phase 18a: {name} at p = 1 differs from "
                   f"x @ w by {float((got - full).abs().max())}")
        g = torch.randn((n, 1024), generator=gen, device=self.dev)
        mean, res = compressed_psum_mean(g, mesh, "data", torch.zeros_like(g))
        code, scale = _quantize_int8(g)
        want_code, want_scale = _quantize_int8(g.cpu())
        want_res = (g.cpu().double() - want_code.double()
                    * want_scale.double()).float()
        out["compression"] = {
            "codes_equal_cpu": bool(torch.equal(code.cpu(), want_code)),
            "scale_equal_cpu": bool(torch.equal(scale.cpu(), want_scale)),
            "mean_is_dequantized": bool(torch.equal(
                mean, code.float() * scale)),
            "residual_equal_cpu": bool(torch.equal(res.cpu(), want_res))}
        expect(all(out["compression"].values()),
               f"phase 18a: compression {out['compression']}")
        ws = torch.randn((1, 1024, 1024), generator=gen,
                         device=self.dev) * 0.03
        xs = torch.randn((8, 64, 1024), generator=gen, device=self.dev)
        got = pipeline_apply(lambda w, x: torch.tanh(x @ w), mesh, "data",
                             ws, xs)
        want = torch.stack([torch.tanh(xi @ ws[0]) for xi in xs])
        out["pipeline"] = bool(torch.equal(got, want))
        expect(out["pipeline"], "phase 18a: pipeline_apply at p = 1 "
               "differs from its stage")
        self.sync()
        out["seconds"] = time.perf_counter() - t0
        say(f"sharded substrates at p = 1 ({mesh.mesh_dim_names}): ring "
            f"and bulk all-gather matmuls and the reduce-scatter matmul "
            f"equal x @ w ({n} x 1024 x 1024) bit for bit; int8 codes, "
            f"scale and residual the CPU's, the mean the dequantized "
            f"codes; the one-stage pipeline its stage; "
            f"{out['seconds']:.1f} s")
        return out

    def sharded_vs_meshless(self, mesh, arch: str) -> dict:
        """18b: two fp32 steps (two microbatches, TF32 off) of ``arch``'s
        reduced config from one seeded state: the sharded step on the
        (1, 1) mesh gives the mesh-less step's metrics and state bit for
        bit."""
        import dataclasses
        torch = self.torch
        from torch.distributed.tensor import DTensor
        from repro_torch import configs
        from repro_torch.configs.common import ShapeSpec
        from repro_torch.data.pipeline import TokenStreamConfig
        from repro_torch.models.registry import build_model
        from repro_torch.train.checkpoint import _flatten_with_names
        from repro_torch.train.optimizer import OptimizerConfig
        from repro_torch.train import train_loop as tl
        t0 = time.perf_counter()
        cfg = dataclasses.replace(configs.get_reduced(arch),
                                  compute_dtype=torch.float32)
        bundle = build_model(cfg, device=self.dev)
        tc = tl.TrainConfig(microbatches=2, loss_chunk=16,
                            opt=OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                                total_steps=10))
        stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4)
        plain = tl.init_train_state(bundle, SEED)
        sharded = tl.init_train_state(bundle, SEED, mesh=mesh)
        step = tl.make_train_step(bundle, tc)
        sharded_step = tl.make_train_step(
            bundle, tc, mesh=mesh, shape=ShapeSpec("t", 32, 4, "train"))
        rec = {"arch": arch, "losses": [], "metrics_equal": True}
        for i in range(2):
            plain, want = step(plain, tl.train_batch(bundle, stream, i))
            sharded, got = sharded_step(
                sharded, tl.train_batch(bundle, stream, i, mesh=mesh))
            rec["losses"].append(float(got["loss"]))
            rec["metrics_equal"] &= all(bool(torch.equal(got[k], want[k]))
                                        for k in want)
        got = _flatten_with_names(sharded)
        differ = [n for n, w in _flatten_with_names(plain).items()
                  if not torch.equal(
                      got[n].full_tensor() if isinstance(got[n], DTensor)
                      else got[n], w)]
        rec.update(leaves=len(got), leaves_differing=len(differ),
                   seconds=time.perf_counter() - t0)
        expect(rec["metrics_equal"] and not differ,
               f"phase 18b: {arch}'s sharded step differs from the mesh-less"
               f" step (metrics equal {rec['metrics_equal']}; leaves "
               f"{differ[:4]})")
        say(f"sharded step {arch} (reduced, fp32) on the (1, 1) mesh: 2 "
            f"steps bit-equal to the mesh-less step ({rec['leaves']} state "
            f"leaves, losses {rec['losses']}); {rec['seconds']:.1f} s")
        return rec

    def sharded_full(self, mesh) -> dict:
        """18c: starcoder2-3b at 16a's size (full size, bf16 compute; the
        reduced config in a CPU rehearsal) through ``make_train_step(...,
        mesh=)`` on a (1,) data mesh, 16a's schedule and batches, 3 steps:
        ``expect_training``'s checks but the descent (16a's third loss is
        above its first), the losses against 16a's first three
        (bit-equal, or within TRAIN_LOSS_RTOL, the op that parts them
        named in PERF.md), step ms, tokens/s and peak bytes beside 16a's."""
        from repro_torch.configs.common import ShapeSpec
        from repro_torch.data.pipeline import TokenStreamConfig
        from repro_torch.models.registry import build_model
        from repro_torch.train.optimizer import OptimizerConfig
        from repro_torch.train import train_loop as tl
        steps = SHARDED_STEPS
        cfg = self.train_config("starcoder2-3b")
        seq = self.train_seq(TRAIN_SEQ)
        rec = {"arch": cfg.name, "layers": cfg.num_layers,
               "batch": TRAIN_BATCH, "seq": seq,
               "microbatches": TRAIN_MICRO, "steps": steps,
               "left_on_card_bytes": [self.left_on_card()], "losses": [],
               "aux_losses": [], "step_ms": []}
        t0 = time.perf_counter()
        bundle = build_model(cfg, device=self.dev)
        step = tl.make_train_step(
            bundle, tl.TrainConfig(
                microbatches=TRAIN_MICRO, loss_chunk=min(512, seq),
                opt=OptimizerConfig(peak_lr=3e-4,
                                    warmup_steps=TRAIN_STEPS // 10,
                                    total_steps=TRAIN_STEPS)),
            mesh=mesh, shape=ShapeSpec("train", seq, TRAIN_BATCH, "train"))
        stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=TRAIN_BATCH)
        state = tl.init_train_state(bundle, SEED, mesh=mesh)
        self.reset_peak()
        self.reset_launches()
        for i in range(steps):
            t1 = time.perf_counter()
            state, metrics = step(state, tl.train_batch(bundle, stream, i,
                                                        mesh=mesh))
            rec["losses"].append(float(metrics["loss"]))
            rec["step_ms"].append(1e3 * (time.perf_counter() - t1))
            rec["aux_losses"].append(float(metrics["aux_loss"]))
        rec["peak_bytes"] = self.peak()
        del state, step, bundle, metrics
        rec["seconds"] = time.perf_counter() - t0
        self.step_rates(rec)
        # 16a's third loss reads above its first: 18c holds its losses to
        # 16a's instead of to a descent over three steps
        self.expect_training("phase 18c", rec, steps, descends=False)
        full = self.record["train"]["full"]
        want = full["losses"][:steps]
        rec["losses_16a"] = want
        rec["bit_equal_16a"] = rec["losses"] == want
        rec["loss_diff_over_tol"] = max(
            abs(a - b) / (TRAIN_LOSS_RTOL * abs(b))
            for a, b in zip(rec["losses"], want))
        expect(rec["bit_equal_16a"] or rec["loss_diff_over_tol"] <= 1.0,
               f"phase 18c: losses {rec['losses']} against 16a's {want}")
        rec["vs_16a"] = {k: [rec[k], full[k]] for k in (
            "steady_step_ms", "tokens_per_s", "peak_bytes")}
        self.say_training(rec, "through make_train_step on a (1,) data "
                          "mesh")
        say(f"phase 18c against 16a: losses "
            + ("bit-equal" if rec["bit_equal_16a"] else
               f"{rec['loss_diff_over_tol']:.3g} of TRAIN_LOSS_RTOL")
            + f"; steady step ms {rec['steady_step_ms']:.1f} / "
            f"{full['steady_step_ms']:.1f}, tokens/s "
            f"{rec['tokens_per_s']:.1f} / {full['tokens_per_s']:.1f}, peak "
            f"{rec['peak_bytes']} / {full['peak_bytes']} B")
        return rec

    def depth2_check(self, arch: str) -> dict:
        """One config at full width, its depth cut to 2 layers (the reduced
        config in a CPU rehearsal), seeded weights on the card: the tree's
        size against ``count_params``, #10 on both kernels at the config's
        heads (one fp32 and one bf16 prefill of LOGITS_BATCH prompts, one
        launch a layer each) under ``logits_through_plain``'s 1e-5 rule,
        and the card's memory back to where it was once the model is
        freed."""
        torch = self.torch
        import numpy as np
        from repro_torch import configs
        from repro_torch.models.registry import build_model
        cfg = (configs.get_reduced(arch) if self.rehearsal
               else configs.get_config(arch, num_layers=2))
        prompt_len = 16 if self.rehearsal else PROMPT_LEN
        t0 = time.perf_counter()
        before = self.left_on_card()
        bundle = build_model(cfg, device=self.dev)
        params = bundle.init(SEED)

        def size(tree):
            if isinstance(tree, dict):
                return sum(size(v) for v in tree.values())
            if isinstance(tree, list):
                return sum(size(v) for v in tree)
            return tree.numel()

        rec = {"layers": cfg.num_layers, "d_model": cfg.d_model,
               "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
               "ffn": cfg.ffn_kind, "params": bundle.count_params,
               "tree_params": size(params)}
        expect(rec["tree_params"] == rec["params"],
               f"{arch}: {rec['tree_params']} parameters drawn, count_params "
               f"says {rec['params']}")
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
                   for _ in range(LOGITS_BATCH)]
        self.reset_launches()
        self.reset_peak()
        rec["logits_check"] = self.logits_through_plain(cfg, params, prompts)
        rec["flash_kernels"] = self.flash_launches()
        rec["peak_bytes"] = self.peak()
        if not self.rehearsal:
            expect(rec["flash_kernels"] == {"fp32_simt": cfg.num_layers,
                                            "bf16_wgmma": cfg.num_layers},
                   f"{arch}: #10 ran {rec['flash_kernels']}, not once a layer "
                   "on each kernel")
        del bundle, params
        gc.collect()
        if not self.rehearsal:
            torch.cuda.empty_cache()
        rec["left_on_card_bytes"] = [before, self.left_on_card()]
        expect(rec["left_on_card_bytes"][1] == before,
               f"{arch}: {rec['left_on_card_bytes']} B on the card before and "
               "after the check")
        rec["seconds"] = time.perf_counter() - t0
        fp = rec["logits_check"]["fp32"]
        say(f"{arch}: {cfg.num_layers} layers at full width (d_model "
            f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, ffn "
            f"{cfg.ffn_kind}), {rec['params']} parameters; first-token "
            "logits through #10 against the plain attention "
            + json.dumps(rec["logits_check"]) + f"; #10 launches "
            f"{rec['flash_kernels']}; peak {rec['peak_bytes']} B; memory "
            f"freed ({rec['left_on_card_bytes']}); {rec['seconds']:.1f} s "
            f"(fp32 {fp['diff_over_tol']:.3g} of the limit)")
        return rec

    # -- phase 8: kernel #9 --------------------------------------------
    # -- phase 19: the dry run -----------------------------------------
    def dryrun_commands(self) -> dict:
        """label -> the dry run's command: 19a at the production mesh
        (starcoder2-3b; "19a moe" DRYRUN_MOE_ARCH), 19b's three cells at
        world size 1 (the reduced config at
        TRAIN_REHEARSAL_SEQ tokens in a CPU rehearsal)."""
        reduced = ["--reduced"] if self.rehearsal else []
        base = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", DRYRUN_ARCH] + reduced

        def cell(shape: str, batch: int, seq: int, *extra) -> list:
            return base + ["--shape", shape, "--mesh", "1x1", "--batch",
                           str(batch), "--seq", str(self.train_seq(seq)),
                           *extra]
        return {"19a": base,
                "19a moe": [sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", DRYRUN_MOE_ARCH] + reduced,
                "19b train": cell("train_4k", TRAIN_BATCH, TRAIN_SEQ,
                                  "--microbatches", str(TRAIN_MICRO)),
                "19b prefill": cell("prefill_32k", DRYRUN_PREFILL_BATCH,
                                    DRYRUN_SEQ),
                "19b decode": cell("decode_32k", DRYRUN_DECODE_BATCH,
                                   DRYRUN_SEQ)}

    def start_dryruns(self) -> None:
        """Start phase 19's dry runs: subprocesses on the host, with no
        card visible, one thread each at the lowest priority."""
        import os
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        for label, cmd in self.dryrun_commands().items():
            self._dryruns[label] = (time.perf_counter(), subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                preexec_fn=lambda: os.nice(19)))

    def stop_dryruns(self) -> None:
        for _t0, proc in self._dryruns.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()

    def dryrun_result(self, label: str) -> tuple:
        """(the cells' records, their seconds on the host): exit 0 and
        every cell counted."""
        _t0, proc = self._dryruns[label]
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
        expect(proc.returncode == 0,
               f"phase {label}: the dry run exited {proc.returncode}: "
               f"{err[-2000:]}")
        cells = [json.loads(line) for line in out.splitlines()
                 if line.startswith("{")]
        expect(bool(cells) and all(c["ok"] for c in cells),
               f"phase {label}: cells not counted: {cells}")
        return cells, sum(c["total_s"] for c in cells)

    def phase_dryrun(self) -> dict:
        """19a: ``python -m repro_torch.launch.dryrun --arch starcoder2-3b``
        and ``--arch qwen3-moe-30b-a3b`` at the (32, 8) production mesh
        (:meth:`dryrun_cells`).  19b: the dry run at world size 1 held
        against the card (:meth:`dryrun_on_the_card`)."""
        t0 = time.perf_counter()
        rec = {"19a": self.dryrun_cells("19a", DRYRUN_ARCH),
               "19a moe": self.dryrun_cells("19a moe", DRYRUN_MOE_ARCH)}
        rec["19b"] = self.dryrun_on_the_card()
        rec["seconds"] = time.perf_counter() - t0
        say(f"phase 19: {rec['seconds']:.1f} s (its dry runs "
            + ", ".join(f"{label} {s:.1f} s" for label, s in
                        rec["19b"]["seconds_on_host"].items())
            + f", 19a {rec['19a']['seconds_on_host']:.1f} s and 19a moe "
            f"{rec['19a moe']['seconds_on_host']:.1f} s on the host, beside "
            "phases 13-18)")
        return rec

    def dryrun_cells(self, label: str, arch: str) -> dict:
        """One arch's three cells at (32, 8): each counted, its peak,
        FLOPs, bytes and collective bytes above 0 and its model FLOPs the
        formula's; an MoE config's ``bmm`` FLOPs within
        ``moe_bmm_bounds`` (its expert products at an eighth); each
        cell's per-device peak, ``fits`` and counts printed."""
        from repro_torch import configs
        from repro_torch.models.registry import build_model
        cells, seconds = self.dryrun_result(label)
        expect([c["shape"] for c in cells]
               == ["train_4k", "prefill_32k", "decode_32k"]
               and all(c["mesh"] == "32x8" for c in cells),
               f"phase {label}: cells "
               f"{[(c['shape'], c['mesh']) for c in cells]}")
        cfg = self.dryrun_config(arch)
        n_active = build_model(cfg, device="meta").active_params
        rec = {"arch": arch, "seconds_on_host": seconds, "cells": []}
        for c in cells:
            hlo, mem = c["hlo"], c["memory"]
            for key in ("flops_per_device", "bytes_per_device",
                        "collective_bytes_per_device"):
                expect(hlo[key] > 0, f"phase {label} {c['shape']}: {key} "
                       f"{hlo[key]}")
            expect(mem["peak_bytes_est"] > 0,
                   f"phase {label} {c['shape']}: peak "
                   f"{mem['peak_bytes_est']}")
            shape = configs.SHAPES[c["shape"]]
            tokens = shape.global_batch * (1 if shape.kind == "decode"
                                           else shape.seq_len)
            want = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
            bounds = None
            if not self.rehearsal:
                expect(c["model_flops"] == want,
                       f"phase {label} {c['shape']}: model FLOPs "
                       f"{c['model_flops']}, the formula {want}")
                if cfg.ffn_kind == "moe":
                    bounds = moe_bmm_bounds(cfg, shape, {"data": 32,
                                                         "model": 8})
                    bmm = hlo["flops_by_op"].get("bmm", 0.0)
                    expect(bounds[0] <= bmm <= bounds[1],
                           f"phase {label} {c['shape']}: bmm FLOPs {bmm} "
                           f"outside {bounds}: the expert products are not "
                           "an eighth of the layer's")
            rec["cells"].append({
                "shape": c["shape"], "mesh": c["mesh"], "torch": c["torch"],
                "memory": mem, "hlo": hlo,
                "model_flops": c.get("model_flops"),
                "moe_bmm_bounds": bounds, "lower_s": c["lower_s"]})
            say(f"phase {label} {arch} {c['shape']} at {c['mesh']}: "
                f"{mem['peak_bytes_est'] / 2**30:.2f} GiB a device "
                f"({'fits' if mem['fits'] else 'does NOT fit'} 80 GB), "
                f"{hlo['flops_per_device']:.4g} FLOPs ("
                + ", ".join(f"{op} {f:.4g}"
                            for op, f in hlo["flops_by_op"].items())
                + (f"; bmm within [{bounds[0]:.4g}, {bounds[1]:.4g}]"
                   if bounds else "")
                + f"), {hlo['bytes_per_device']:.4g} B, "
                f"{hlo['collective_bytes_per_device']:.4g} B of "
                "collectives a device ("
                + ", ".join(f"{k} {v['bytes_in']:.4g}"
                            for k, v in hlo["collectives"].items())
                + f"; the dry run's counts on meta, torch {c['torch']})")
        return rec

    def dryrun_config(self, arch: str = DRYRUN_ARCH):
        from repro_torch import configs
        return (configs.get_reduced(arch) if self.rehearsal
                else configs.get_config(arch))

    def peak_ratio(self, label: str, dry: int, card) -> float | None:
        """The dry run's peak over the card's (None on the CPU), within
        PEAK_RTOL."""
        if card is None:
            return None
        ratio = dry / card
        say(f"phase 19b {label}: dry-run peak {dry} B, the card's {card} B, "
            f"ratio {ratio:.4f}")
        expect(abs(ratio - 1.0) <= PEAK_RTOL,
               f"phase 19b {label}: the dry run's peak {dry} is "
               f"{ratio:.4f} of the card's {card}")
        return ratio

    def counted_on_the_card(self, fn, args) -> tuple:
        """(outputs, the count's record, the card's peak bytes for the
        call: ``max_memory_allocated`` after a reset, less what was live
        beside the arguments; None on the CPU) of ``fn(*args)`` run once
        under the dry run's cost count on real tensors."""
        torch = self.torch
        from repro_torch.launch import lowering
        from repro_torch.launch.cost_analysis import CostCount
        count = CostCount()
        count.add_arguments(args)
        gc.collect()
        self.sync()
        other = None
        if not self.rehearsal:
            other = torch.cuda.memory_allocated() - count.argument_bytes
            torch.cuda.reset_peak_memory_stats()
        with count:
            out = fn(*args)
        self.sync()
        peak = (None if self.rehearsal
                else torch.cuda.max_memory_allocated() - other)
        return out, lowering.record_of(count, out), peak

    def expect_same_counts(self, label: str, got: dict, dry: dict) -> dict:
        keys = ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "transcendentals_per_device")
        for key in keys[:3]:
            expect(got["hlo"][key] == dry["hlo"][key],
                   f"phase 19b {label}: {key} {got['hlo'][key]} on the "
                   f"card, {dry['hlo'][key]} in the dry run")
        return {key: [got["hlo"][key], dry["hlo"][key]] for key in keys}

    def dryrun_on_the_card(self) -> dict:
        """19b: starcoder2-3b at full width, the dry run at world size 1
        against the card.  Train at 16a's batch against 16a's own peak in
        this run.  Prefill at 1 x 32768 with bf16 serving params through
        ``sharded_prefill`` on a (1, 1) mesh over phase 12's group (#10 at
        S = 32768) and decode at 8 x 32768 through ``sharded_decode``,
        each under the same cost count on real tensors: FLOPs, bytes and
        collective bytes equal the dry run's, the prefill's hidden state
        and caches bit-equal to the mesh-less prefill's; each cell's
        dry-run peak within PEAK_RTOL of ``max_memory_allocated`` (reset
        before the cell).  Then #10 at the prefill's shape against its
        plain versions on the last FLASH_CHECK_ROWS queries, with the
        planted fault (``compare_flash``), timed beside SDPA
        (``enable_gqa``) and its bound by the pairs it attends."""
        torch = self.torch
        from torch.distributed.tensor import DTensor
        from repro_torch.configs.common import ShapeSpec
        from repro_torch.dist.sharding import make_mesh
        from repro_torch.launch import lowering
        from repro_torch.models.registry import build_model, model_inputs
        rec: dict = {"seconds_on_host": {}}
        dry = {}
        for cell in ("train", "prefill", "decode"):
            cells, rec["seconds_on_host"][f"19b {cell}"] = \
                self.dryrun_result(f"19b {cell}")
            dry[cell] = cells[0]
        full = self.record["train"]["full"]
        card = (None if self.rehearsal else
                full["peak_bytes"] - full["left_on_card_bytes"][0])
        rec["train"] = {"dry_peak": dry["train"]["memory"]["peak_bytes_est"],
                        "card_peak_16a": card}
        rec["train"]["ratio"] = self.peak_ratio(
            "train (16a)", rec["train"]["dry_peak"], card)

        cfg = self.dryrun_config()
        bundle = build_model(cfg, device=self.dev)
        params = lowering.serve_params(cfg, bundle.init(SEED))
        gen = torch.Generator().manual_seed(SEED)
        seq = self.train_seq(DRYRUN_SEQ)

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t

        with self.phase12_group():
            mesh = make_mesh((1, 1), ("data", "model"), device=self.dev.type)
            # prefill: the mesh-less run, then the sharded one, counted
            b = DRYRUN_PREFILL_BATCH
            tokens = torch.randint(0, cfg.vocab_size, (b, seq),
                                   generator=gen, dtype=torch.int32)
            pos = torch.arange(seq, dtype=torch.int32)[None].expand(b, -1)
            batch = model_inputs(bundle, tokens.to(self.dev),
                                 pos.contiguous().to(self.dev))
            lengths = torch.zeros(b, dtype=torch.int32, device=self.dev)
            hidden0, caches0 = bundle.prefill(params, batch,
                                              bundle.init_cache(b, seq),
                                              lengths)
            sh = lowering.serving_shardings(bundle, mesh, ShapeSpec(
                "19b", seq, b, "prefill"))
            args = (lowering.place_serving(params, sh["params"]),
                    lowering.place_serving(batch, {k: sh["batch"][k]
                                                   for k in batch}),
                    lowering.place_serving(bundle.init_cache(b, seq),
                                           sh["caches"]), lengths)
            self.reset_launches()
            (hidden1, caches1), got, peak = self.counted_on_the_card(
                lambda p, bt, c, n: lowering.sharded_prefill(
                    bundle, mesh, p, bt, c, n), args)
            launches = self.flash_launches()
            rec["prefill"] = {
                "counts": self.expect_same_counts("prefill", got,
                                                  dry["prefill"]),
                "dry_peak": dry["prefill"]["memory"]["peak_bytes_est"],
                "card_peak": peak, "flash_launches": launches,
                "hidden_bit_equal": bool(torch.equal(local(hidden1),
                                                     hidden0)),
                "caches_bit_equal": all(
                    bool(torch.equal(local(x), y))
                    for c1, c0 in zip(caches1, caches0, strict=True)
                    for part in c1 if c1[part] is not None
                    for x, y in zip(c1[part], c0[part], strict=True))}
            expect(rec["prefill"]["hidden_bit_equal"]
                   and rec["prefill"]["caches_bit_equal"],
                   "phase 19b: the (1, 1) prefill's hidden state or caches "
                   "differ from the mesh-less prefill's")
            if not self.rehearsal:
                expect(launches["bf16_wgmma"] == cfg.num_layers
                       and launches["fp32_simt"] == 0,
                       f"phase 19b: #10 launched {launches} in the prefill")
            rec["prefill"]["ratio"] = self.peak_ratio(
                "prefill", rec["prefill"]["dry_peak"], peak)
            del args, hidden0, caches0, hidden1, caches1, batch
            # decode: one token against caches of seq slots
            b = DRYRUN_DECODE_BATCH
            sh = lowering.serving_shardings(bundle, mesh, ShapeSpec(
                "19b", seq, b, "decode"))
            token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                                  dtype=torch.int32).to(self.dev)
            lengths = torch.full((b,), seq - 1, dtype=torch.int32,
                                 device=self.dev)
            args = (lowering.place_serving(params, sh["params"]),
                    lowering.place_serving(token, sh["batch"]["tokens"]),
                    lowering.place_serving(lengths[:, None].clone(),
                                           sh["batch"]["positions"]),
                    lowering.place_serving(bundle.init_cache(b, seq),
                                           sh["caches"]), lengths)
            _out, got, peak = self.counted_on_the_card(
                lambda p, t, q, c, n: lowering.sharded_decode(
                    bundle, mesh, p, t, q, c, n), args)
            rec["decode"] = {
                "counts": self.expect_same_counts("decode", got,
                                                  dry["decode"]),
                "dry_peak": dry["decode"]["memory"]["peak_bytes_est"],
                "card_peak": peak}
            rec["decode"]["ratio"] = self.peak_ratio(
                "decode", rec["decode"]["dry_peak"], peak)
            del args, _out
        del params, bundle
        gc.collect()
        # #10 at the prefill's shape, where its plain version checks the
        # last FLASH_CHECK_ROWS queries against every key
        r = self.compare_flash(
            DRYRUN_PREFILL_BATCH, cfg.num_heads, cfg.num_kv_heads, seq, seq,
            cfg.head_dim, True, None, torch.bfloat16, seed=SEED,
            model_shape=True, time_it=True,
            rows=min(FLASH_CHECK_ROWS, seq))
        r["launches"] = rec["prefill"]["flash_launches"]
        rec["flash_32k"] = r
        say(f"phase 19b: #10 at {r['shape'][:6]}: {r['ms']} ms (SDPA "
            f"{r['library_ms']} ms, bound {r['bound']}, {r['tflops']} "
            f"TFLOP/s); its last {r['checked_rows']} queries against the "
            f"fp32 plain version max |diff| {r['max_abs_err']:.3g} "
            f"({r['max_err_over_tol']:.3g} of the tolerance; a dropped kv "
            f"tile {r['planted_fault_over_tol']:.3g} of it), against the "
            f"bf16 plain version {r['plain_max_abs_err']:.3g}")
        return rec

    def phase_pccp(self, store=None) -> dict:
        """#9 on the datastore's keys: the path that runs it (the PCCP
        partition of the keys from the kernel's correlations,
        ``build_pccp_partition(..., corr=ops.pccp_correlation(keys))`` at
        the build's M), the kernel against its plain version and against
        numpy float64 ``correlation_matrix``, and whether ``pccp_order``
        over the kernel's matrix equals it over numpy's (or parts from it
        first at a near tie, ``pccp_first_divergence``)."""
        torch, ref = self.torch, self.ref
        import numpy as np
        from repro_torch.core.partition import (build_pccp_partition,
                                                correlation_matrix,
                                                pccp_order)
        from repro_torch.kernels import ops
        from repro_torch.kernels import pccp_corr as tpccp
        store = store if store is not None else self._store
        keys = store.index.data[torch.argsort(store.index.point_ids.long())]
        n, d = keys.shape
        m = store.index.m
        keys_np = keys.cpu().numpy()
        self.reset_launches()
        self.sync()
        t0 = time.perf_counter()
        corr = ops.pccp_correlation(keys)
        part = build_pccp_partition(keys_np, m, seed=SEED,
                                    corr=corr.cpu().numpy())
        rec = {"n": n, "d": d, "m": m,
               "partition_s": time.perf_counter() - t0,
               "launches": self.launches()}
        self.expect_launches("PCCP partition", rec["launches"],
                             ("pccp_correlation",), False)
        t0 = time.perf_counter()
        corr_np = correlation_matrix(keys_np)
        rec["numpy_float64_s"] = time.perf_counter() - t0
        # The kernel (the Gram) against its plain version, the product
        # ref.pccp_correlation writes as xc.T @ xc.  Rounding in a sum of n
        # products grows about as sqrt(n) * eps32 times the sum of the
        # products' magnitudes, but not as independent steps: on the
        # diagonal, where every product is positive, the kernel's sum
        # drifts about ten random-walk deviations from cuBLAS's.  The limit
        # is 8 * sqrt(n) * eps32 times that sum (the worst case, 2 * n *
        # eps32, is 64 times looser here).
        xc = (keys - keys.mean(0, keepdim=True)).contiguous()
        gram_fn = ((lambda t: t.T @ t) if self.rehearsal
                   else tpccp.pccp_gram)
        gram = gram_fn(xc)
        plain_gram = xc.T @ xc
        a = xc.abs()
        gram_tol = 8 * n ** 0.5 * EPS32 * (a.T @ a)
        del a
        gdiff = (gram - plain_gram).abs()
        expect(bool((gdiff <= gram_tol).all()),
               f"pccp_gram disagrees with its plain version: max |diff| "
               f"{float(gdiff.max())}")
        expect(self.rehearsal or bool(torch.equal(gram, gram.T)),
               "pccp_gram's mirrored triangle is not symmetric")
        # A planted fault: a Gram that missed one 128-row step of n in the
        # middle differs from the right one by that step's own Gram.
        r0 = n // 2 // 128 * 128
        step = xc[r0:r0 + 128]
        fault_over_tol = float(((step.T @ step).abs() / gram_tol).max())
        expect(fault_over_tol > 1,
               f"a Gram missing 128 rows passes the tolerance "
               f"({fault_over_tol} of it)")
        rec.update(max_abs_err=float(gdiff.max()),
                   max_err_over_tol=float((gdiff / gram_tol).max()),
                   planted_fault_over_tol=fault_over_tol)
        del gram, plain_gram, gdiff, step
        # The whole function: the same ops around the Gram on both sides.
        plain = ref.pccp_correlation(keys)
        std = torch.sqrt(torch.mean(xc * xc, 0))
        std = torch.where(std < 1e-12, 1.0, std)
        tol = gram_tol / (n * std[:, None] * std[None, :])
        del gram_tol
        diff = (corr - plain).abs()
        expect(bool((diff <= tol).all()),
               f"pccp_correlation disagrees with its plain version: max "
               f"|diff| {float(diff.max())}")
        c64 = torch.as_tensor(corr_np, device=self.dev)
        rec.update(
            corr_max_abs_err=float(diff.max()),
            corr_max_err_over_tol=float((diff / tol).max()),
            kernel_vs_numpy_f64=float((corr.double() - c64).abs().max()),
            plain_vs_numpy_f64=float((plain.double() - c64).abs().max()))
        # At the build's M, and at PCCP_PROBE_M subspaces, where groups of
        # PCCP_PROBE_M dims grow by the correlations (at M = 1 every group
        # is one dim and the order does not read them).
        # The greedy's choice is an argmax, so fp32 correlations part from
        # float64's where two candidates' float64 scores lie closer than
        # the fp32 rounding of the entries (at d = 8192 the plain version
        # parts at the same step): the orders must be equal, or part first
        # where numpy's two candidates lie within the correlation
        # tolerance of each other.
        corr_k, corr_p = corr.cpu().numpy(), plain.cpu().numpy()
        rec["pccp_order"] = {}
        for probe in sorted({m, PCCP_PROBE_M}):
            order_k = pccp_order(corr_k, probe, SEED)
            order_np = pccp_order(corr_np, probe, SEED)
            r = rec["pccp_order"][probe] = {
                "equal": bool(np.array_equal(order_k, order_np)),
                "positions_equal": float(np.mean(order_k == order_np))}
            if r["equal"]:
                continue
            group, a, b = pccp_first_divergence(np, corr_k, corr_np, probe,
                                                SEED)
            s_a, s_b = (float(corr_np[group, x].max()) for x in (a, b))
            allowed = float(tol[group, a].max() + tol[group, b].max())
            plain_div = pccp_first_divergence(np, corr_p, corr_np, probe,
                                              SEED)
            r.update(first_divergence={
                "group_size": len(group), "kernel_choice": a,
                "numpy_choice": b, "float64_gap": s_b - s_a,
                "allowed": allowed,
                "plain_parts_there": plain_div is not None
                and plain_div[0] == group})
            expect(s_b - s_a <= allowed,
                   f"pccp_order at M = {probe} over the kernel's "
                   f"correlations parts from numpy float64's away from a "
                   f"near tie: {r['first_divergence']}")
        rec["pccp_order_equal"] = rec["pccp_order"][m]["equal"]
        del corr_k, corr_p
        rec["partition_equal_to_build"] = bool(np.array_equal(
            part.idx, store.index.partition.idx))
        del corr, plain, diff, c64, tol
        # ms is the kernel alone; plain_ms the plain version's product (the
        # plain version of a Gram is a matmul, so it is the library's call
        # as written there); the whole functions are timed beside them.
        rec["ms"] = self.time_calls([lambda: gram_fn(xc)], 3)
        rec["plain_ms"] = self.time_calls([lambda: xc.T @ xc], 3)
        rec["library_ms"] = self.time_calls([lambda: torch.mm(xc.T, xc)], 3)
        rec["wrapper_ms"] = self.time_calls(
            [lambda: ops.pccp_correlation(keys)], 3)
        rec["plain_wrapper_ms"] = self.time_calls(
            [lambda: ref.pccp_correlation(keys)], 3)
        # The upper triangle with its diagonal: n * d * (d + 1) FLOPs.
        rec["bound"] = bound(4.0 * (n * d + d * d), float(n) * d * (d + 1))
        rec["tflops"] = (n * d * (d + 1) / (rec["ms"] * 1e-3) / 1e12
                         if rec["ms"] else None)
        say(f"pccp_correlation on the datastore's keys ({n} x {d}): Gram "
            f"kernel {rec['ms']} ms ({rec['tflops']} TFLOP/s), plain "
            f"{rec['plain_ms']} ms, torch.mm {rec['library_ms']} ms, bound "
            f"{rec['bound']}; whole function {rec['wrapper_ms']} ms, plain "
            f"{rec['plain_wrapper_ms']} ms; Gram max |diff| "
            f"{rec['max_abs_err']:.3g} ({rec['max_err_over_tol']:.3g} of "
            f"the tolerance; 128 missing rows would be "
            f"{fault_over_tol:.3g} of it); correlations max |diff| "
            f"{rec['corr_max_abs_err']:.3g} (plain), "
            f"{rec['kernel_vs_numpy_f64']:.3g} (numpy float64; plain "
            f"{rec['plain_vs_numpy_f64']:.3g}); pccp_order against numpy's "
            f"(by M): {rec['pccp_order']}; partition s "
            f"{rec['partition_s']:.2f}, numpy float64 correlations "
            f"{rec['numpy_float64_s']:.2f} s")
        del xc, keys
        self._store = None
        return rec

    # -- phase 9: single-query search, the oracle, calibration ----------
    def phase9_of(self, label: str, kept: dict) -> None:
        """Phase 9's checks on one index of phases 3-5, run by its drive
        before the index is freed: single-query search on Audio and Deep,
        the oracle and the calibration on the blob corpus and Audio int8.
        ``kept`` holds the index, its queries, their exact ids, the
        batch's final budget and the family."""
        t0 = time.perf_counter()
        if label != "blobs":
            self.single[label] = self.drive_single(label, kept)
        if label in ORACLE_LABELS:
            self.single["oracle"][label] = self.check_oracle(label, kept)
            self.single["calibration"][label] = self.check_calibration(
                label, kept)
        self.single["seconds"] += time.perf_counter() - t0

    def drive_single(self, label: str, kept: dict) -> dict:
        """``knn`` on the first queries against brute force;
        ``knn_search`` and ``knn_search_approx`` at the batch's final
        budget against the rows of the batched search; the launches of
        one ``knn_search``; #1/#2, #5/#6 and #7/#8 at its q = 1 shapes
        against their plain versions, timed; one ``knn_search`` and one
        ``knn`` timed on the host."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        forest, b = kept["forest"], kept["budget"]
        ys = kept["ys"][:SINGLE_QUERIES]
        sfx = "_quant" if forest.storage == "int8" else ""
        out = {"n": forest.n, "budget": b, "queries": ys.shape[0]}

        got = [tsearch.knn(forest, y, K, device=self.dev) for y in ys]
        expect(all(bool(g.exact) for g in got),
               f"{label}: a knn result is not exact")
        points = forest.rows_view()[torch.argsort(forest.point_ids.long())]
        out["knn_vs_brute_force"] = self.check_brute_force(
            points, ys, torch.stack([g.ids for g in got]),
            torch.stack([g.dists for g in got]), kept["family"])
        del points, got

        batch = tsearch.knn_search_batch(forest, ys, K, b, device=self.dev)
        approx = tsearch.knn_search_batch_approx(forest, ys, K, b, SINGLE_P,
                                                 device=self.dev)
        bits, worst = True, 0.0
        for j, y in enumerate(ys):
            for mode, want, one in (
                    ("knn_search", batch, tsearch.knn_search(
                        forest, y, K, b, device=self.dev)),
                    ("knn_search_approx", approx, tsearch.knn_search_approx(
                        forest, y, K, b, SINGLE_P, device=self.dev))):
                diff = (one.dists - want.dists[j]).abs()
                tol = 1e-5 + 1e-5 * want.dists[j].abs()
                if self.rehearsal:
                    # The plain refine's einsum rounds by the batch's
                    # shape: hold it to its own fp32 error bound as well.
                    tol = torch.maximum(tol, self.refine_error_bound(
                        forest, one.ids, y))
                expect(bool(torch.equal(one.ids, want.ids[j]))
                       and bool(one.exact) == bool(want.exact[j])
                       and int(one.num_candidates)
                       == int(want.num_candidates[j])
                       and bool((diff <= tol).all()),
                       f"{label}: {mode} of query {j} differs from row {j} "
                       f"of the batched search (dists max |diff| "
                       f"{float(diff.max())})")
                bits &= bool(torch.equal(one.dists, want.dists[j]))
                worst = max(worst, float(diff.max()))
        out["dists_bit_equal_to_batch_row"] = bits
        out["dists_max_abs_diff_to_batch_row"] = worst
        del batch, approx

        self.sync()
        self.reset_launches()
        tsearch.knn_search(forest, ys[0], K, b, device=self.dev)
        self.sync()
        out["launches"] = self.launches()
        path = {name + sfx: 1 for name in ("bregman_ub_matrix",
                                           "bregman_prune_mask",
                                           "bregman_refine_batch")}
        expect(self.rehearsal or out["launches"] == {
            name: path.get(name, 0) for name in out["launches"]},
               f"{label}: one knn_search launched {out['launches']}, not "
               f"each of {sorted(path)} once and nothing else")

        # The kernels at the q = 1 shapes of the first query's search.
        q1 = tsearch.query_struct(ys[0], forest.partition, forest.family)
        totals, _, qb = tsearch._single_filter(forest, q1, K)
        qs1 = {"qconst": q1["qconst"][None],
               "sqrt_delta": q1["sqrt_delta"][None]}
        filt = tsearch._filter_blocks(forest, forest.n, 1)[0]
        out["ub"] = self.compare_ub_span(filt, qs1, time_it=True)
        corners = tuple(getattr(forest, f)
                        for f in tsearch.CORNER_FIELDS[forest.storage])
        out["prune"] = self.compare_prune([corners], qs1, qb[None],
                                          time_it=True)
        mask = tsearch._candidate_mask(forest, q1, qb)
        priority = torch.where(mask, tsearch.POS_BIG - totals,
                               tsearch.NEG_BIG - totals)
        sel = torch.sort(priority, descending=True,
                         stable=True).indices[:b]
        operands = tuple(getattr(forest, f)[sel[None]]
                         for f in tsearch.REFINE_FIELDS[forest.storage])
        out["refine"] = self.compare_refine(
            operands, q1["grad"][None], q1["c_y"][None], forest.family_name,
            time_it=True)
        del operands, sel, priority, mask, totals

        out["default_budget"] = tsearch.default_budget(forest, K)
        out["knn_search_ms"] = self.host_ms(
            lambda: tsearch.knn_search(forest, ys[0], K, None,
                                       device=self.dev), 5)
        out["knn_ms"] = self.host_ms(
            lambda: tsearch.knn(forest, ys[0], K, device=self.dev), 3)
        out["batch_ms_per_query"] = kept["search_ms"] / NUM_QUERIES
        say(f"single-query {label}: knn == brute force on {ys.shape[0]} "
            f"queries ({out['knn_vs_brute_force']['bf_position_mismatches']}"
            f" near-tie swaps); knn_search / knn_search_approx at budget {b} "
            f"== the batch rows (dists bit-equal: {bits}); one knn_search "
            f"launched {path}; knn_search {out['knn_search_ms']:.3f} ms at "
            f"budget {out['default_budget']}, knn {out['knn_ms']:.3f} ms, "
            f"batch {out['batch_ms_per_query']:.3f} ms a query; kernels at "
            "q = 1: ub " + json.dumps(out["ub"]) + " prune "
            + json.dumps(out["prune"]) + " refine "
            + json.dumps(out["refine"]))
        return out

    def refine_error_bound(self, forest, ids, y):
        """:func:`refine_tolerance` of the rows ``ids`` (original ids) of
        ``forest`` for the one query ``y``."""
        from repro_torch.core.bounds import query_refine_constants
        order = self.torch.argsort(forest.point_ids.long())
        rows = forest.rows_view()[order[ids.long()]]
        c = query_refine_constants(y, forest.family)
        return refine_tolerance(self.torch, rows[None], c["grad"][None],
                                c["c_y"].reshape(1), forest.family_name,
                                rows.shape[1])[0]

    def check_oracle(self, label: str, kept: dict) -> dict:
        """``knn_search_batch_reference`` (the materialized mask) against
        the streamed ``knn_search_batch`` at the phase's budget, exact and
        at ``p_guarantee = SINGLE_P``: every field bit-equal; both timed,
        with the peak device bytes each adds to the resident index."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        forest, ys, b = kept["forest"], kept["ys"], kept["budget"]
        br = kept.get("block_rows", BLOCK_ROWS)
        out = {"n": forest.n, "q": ys.shape[0], "budget": b,
               "block_rows": br}
        for p in (None, SINGLE_P):
            def streamed(p=p):
                if p is None:
                    return tsearch.knn_search_batch(forest, ys, K, b, br,
                                                    device=self.dev)
                return tsearch.knn_search_batch_approx(
                    forest, ys, K, b, p, br, device=self.dev)

            def oracle(p=p):
                return tsearch.knn_search_batch_reference(
                    forest, ys, K, b, p_guarantee=p, block_rows=br,
                    device=self.dev)

            self.sync()
            self.reset_peak()
            want = streamed()
            self.sync()
            streamed_peak = self.peak_above()
            self.reset_peak()
            got = oracle()
            self.sync()
            peak = self.peak_above()
            for f in got._fields:
                expect(bool(torch.equal(getattr(got, f), getattr(want, f))),
                       f"{label}: the oracle's {f} differ from the streamed "
                       f"search's (p_guarantee={p})")
            admitted = int(got.num_candidates.sum())
            out["exact" if p is None else f"p={p}"] = {
                "admitted_pairs": admitted,
                "pairs": forest.n * ys.shape[0],
                "oracle_working_bytes": peak,
                "streamed_working_bytes": streamed_peak,
                "oracle_ms": self.host_ms(oracle, 3),
                "streamed_ms": self.host_ms(streamed, 3)}
        if label == "blobs":
            e = out["exact"]
            expect(0 < e["admitted_pairs"] < e["pairs"],
                   f"blob corpus: the oracle's mask admits "
                   f"{e['admitted_pairs']} of {e['pairs']} pairs, not a "
                   "mixed mask")
        say(f"oracle {label}: knn_search_batch_reference == knn_search_batch"
            " bit for bit, exact and at p_guarantee="
            f"{SINGLE_P}: " + json.dumps(out))
        return out

    def check_p1_near_ties(self, forest, kept: dict) -> dict:
        """The fit's held-out queries searched at p = 1 against brute force
        under phase 3's near-tie rule."""
        torch = self.torch
        from repro_torch.core import calibrate as tcal
        from repro_torch.core import search as tsearch
        qs = torch.as_tensor(tcal.held_out_queries(
            forest, CALIBRATION_QUERIES, seed=0), device=self.dev)
        res = tsearch.knn_batch(forest, qs, K, approx_p=1.0,
                                block_rows=kept.get("block_rows"),
                                device=self.dev)
        points = forest.rows_view()[torch.argsort(forest.point_ids.long())]
        return self.check_brute_force(points, qs, res.ids, res.dists,
                                      kept["family"])

    def check_calibration(self, label: str, kept: dict) -> dict:
        """``ensure_calibration`` on one index: a non-decreasing curve to
        p = 1, whose recall there is 1.0 or misses only at near ties with
        brute force, the fit timed; ``target_recall`` bit-equal to
        ``approx_p`` at the resolved p, its recall against the exact ids
        at least the expected recall less RECALL_SLACK."""
        torch = self.torch
        import numpy as np
        from repro_torch.core import calibrate as tcal
        from repro_torch.core import search as tsearch
        br = kept.get("block_rows")
        self.sync()
        t0 = time.perf_counter()
        forest = tcal.ensure_calibration(kept["forest"], k=K,
                                         num_queries=CALIBRATION_QUERIES)
        self.sync()
        cal = forest.calibration
        r = cal.recall_grid
        entry = {"fit_s": time.perf_counter() - t0,
                 "p_grid": cal.p_grid.tolist(), "recall_grid": r.tolist()}
        expect(bool(np.all(np.diff(r) >= 0)) and cal.p_grid[-1] == 1.0,
               f"{label}: the fitted curve {r.tolist()} is not "
               "non-decreasing to p = 1")
        if r[-1] != 1.0:
            # Recall is counted by ids: at p = 1 a miss must be a near tie
            # with brute force (the refine form and the oracle's round
            # apart on data of large magnitude).
            entry["p1_near_ties"] = self.check_p1_near_ties(forest, kept)
        exact_ids = kept["ids"].cpu().numpy()
        for t in RECALL_TARGETS:
            p, expected = tcal.resolve_p_guarantee(forest, t)
            got = tsearch.knn_batch(forest, kept["ys"], K, target_recall=t,
                                    block_rows=br, device=self.dev)
            want = tsearch.knn_batch(forest, kept["ys"], K, approx_p=p,
                                     block_rows=br, device=self.dev)
            for f in got._fields:
                expect(bool(torch.equal(getattr(got, f), getattr(want, f))),
                       f"{label}: target_recall={t} {f} differ from "
                       f"approx_p={p}")
            ids = got.ids.cpu().numpy()
            recall = float(np.mean([
                len(set(a.tolist()) & set(e.tolist())) / K
                for a, e in zip(ids, exact_ids, strict=True)]))
            expect(recall >= expected - RECALL_SLACK,
                   f"{label}: recall {recall} at target_recall={t} is "
                   f"below the expected {expected} less {RECALL_SLACK}")
            entry[f"target={t}"] = {"p": p, "expected_recall": expected,
                                    "measured_recall": recall}
        say(f"calibration {label}: " + json.dumps(entry))
        return entry

    def check_small_calibration(self, on_cpu, on_card) -> None:
        """Phase 9's check on phase 2's small index: the curve fitted on
        the card equal to the CPU's, element for element."""
        import numpy as np
        from repro_torch.core import calibrate as tcal
        tier = on_cpu.storage
        t0 = time.perf_counter()
        a = tcal.fit_calibration(on_cpu, k=K, num_queries=CALIBRATION_QUERIES)
        b = tcal.fit_calibration(on_card, k=K,
                                 num_queries=CALIBRATION_QUERIES)
        expect(np.array_equal(a.p_grid, b.p_grid)
               and np.array_equal(a.recall_grid, b.recall_grid),
               f"small {tier} index: the curve fitted on the card "
               f"{b.recall_grid.tolist()} differs from the CPU's "
               f"{a.recall_grid.tolist()}")
        self.single["calibration"][f"small {tier}"] = {
            "recall_grid": b.recall_grid.tolist()}
        self.single["seconds"] += time.perf_counter() - t0
        say(f"calibration: phase 2's small index ({tier}), the curve fitted "
            "on the card == on the CPU: " + json.dumps(b.recall_grid.tolist()))

    # -- phase 10: the mutable index ---------------------------------------
    def reinsert_tail(self, label: str, forest, data) -> tuple:
        """The update phase 10 makes with no build: ``forest`` as a
        mutable index, its last tenth of original ids deleted, the same
        rows (``data`` in original order) inserted again in
        ``MUTATION_BATCHES`` batches, so id i >= n - cut comes back as
        i + cut.  Returns (index, cut, timings)."""
        import numpy as np
        from repro_torch.core.segments import SegmentedForest
        n = forest.n
        cut = n // 10
        out = {"n": n, "cut": cut}
        self.sync()
        t0 = time.perf_counter()
        sf = SegmentedForest.from_forest(forest)
        removed = sf.delete(np.arange(n - cut, n), auto_compact=False)
        self.sync()
        out["delete_tail_ms"] = 1e3 * (time.perf_counter() - t0)
        expect(removed == cut, f"{label}: deleted {removed} of {cut} ids")
        out["insert_ms"], out["insert_rows"] = [], []
        for part in np.array_split(np.arange(n - cut, n), MUTATION_BATCHES):
            self.sync()
            t0 = time.perf_counter()
            ids = sf.insert(data[part], auto_compact=False)
            self.sync()
            out["insert_ms"].append(1e3 * (time.perf_counter() - t0))
            out["insert_rows"].append(int(part.size))
            expect(np.array_equal(ids, part + cut),
                   f"{label}: an insert returned ids {ids[:3]}..., not "
                   f"{(part + cut)[:3]}...")
        self.sync()
        t0 = time.perf_counter()
        sf.view()
        self.sync()
        out["view_ms"] = 1e3 * (time.perf_counter() - t0)
        expect(sf.live_n == n and sf.n == n + cut,
               f"{label}: {sf.live_n} live of {sf.n} rows after the update")
        return sf, cut, out

    def counted_search(self, label: str, index, ys, q_batch: int,
                       quantize: bool, **kw) -> tuple:
        """``knn_batch`` of ``ys`` in batches of ``q_batch`` through the
        resident path, counts set to 0 just before and read just after:
        each kernel of the tier's path launched, the filter and the fused
        prune once an attempt.  Returns (result fields, launches)."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        sfx = "_quant" if quantize else ""
        self.sync()
        self.reset_launches()
        outs = [tsearch.knn_batch(index, ys[s:s + q_batch], K,
                                  device=self.dev, **kw)
                for s in range(0, ys.shape[0], q_batch)]
        self.sync()
        launches = self.launches()
        self.expect_launches(label, launches, RESIDENT_PATH, quantize)
        attempts = launches["bregman_refine_batch" + sfx]
        for kname in ("bregman_ub_matrix" + sfx,
                      "bregman_filter_prune" + sfx):
            expect(self.rehearsal or launches[kname] == attempts,
                   f"{label}: {kname} launched {launches[kname]} times, "
                   f"not once an attempt ({attempts} attempts)")
        res = {f: torch.cat([getattr(o, f) for o in outs])
               for f in ("ids", "dists", "exact", "num_candidates")}
        return res, launches

    def expect_same_result(self, label: str, got: dict,
                           want: dict) -> None:
        """ids, exact and num_candidates equal, dists bit-equal (within
        1e-5 in a rehearsal, where the plain refine rounds by the batch's
        shape)."""
        torch = self.torch
        for f in ("ids", "exact", "num_candidates"):
            expect(bool(torch.equal(got[f], want[f])),
                   f"{label}: {f} differ")
        diff = (got["dists"] - want["dists"]).abs()
        if not self.rehearsal:
            expect(bool(torch.equal(got["dists"], want["dists"])),
                   f"{label}: dists differ (max |diff| {float(diff.max())})")
        else:
            expect(bool((diff <= 1e-5 + 1e-5 * want["dists"].abs()).all()),
                   f"{label}: dists differ (max |diff| {float(diff.max())})")

    def drive_mutable(self, label: str, forest, data, ys, q_batch: int,
                      want: dict, family: str, search_ms: float) -> dict:
        """Phase 10 on Deep: phase 4's index as a mutable index through
        the delete-and-reinsert update, then 50,000 more deletes, the
        tiered store (fp32), a merge and (fp32) a rebuild, each held to
        phase 4's result, brute force or the search before it."""
        torch = self.torch
        import numpy as np
        from repro_torch.core import search as tsearch
        quantize = forest.storage == "int8"
        t_phase = time.perf_counter()
        self.sync()
        self.reset_peak()
        sf, cut, out = self.reinsert_tail(label, forest, data)
        n = forest.n

        # 4. The live set is phase 4's: its result through the id map.
        got, out["reinsert_launches"] = self.counted_search(
            f"{label} mutated", sf, ys, q_batch, quantize)
        got["ids"] = torch.where(got["ids"] >= n, got["ids"] - cut,
                                 got["ids"])
        self.expect_same_result(f"{label} mutated (delete and reinsert) "
                                "against phase 4 through the id map", got,
                                want)
        out["search_ms"] = self.host_ms(
            lambda: [tsearch.knn_batch(sf, ys[s:s + q_batch], K,
                                       device=self.dev)
                     for s in range(0, NUM_QUERIES, q_batch)], 3)
        out["phase4_search_ms"] = search_ms

        # 5. 50,000 more deletes, half of the main segment's, half of the
        # appended rows, the first queries' top-k among them.
        rng = np.random.default_rng(SEED)
        top = want["ids"][:SINGLE_QUERIES].reshape(-1).cpu().numpy()
        top = np.unique(np.where(top >= n - cut, top + cut, top))
        half = n // 40
        doomed = []
        for pool, mine in ((np.arange(n - cut), top[top < n]),
                           (np.arange(n, n + cut), top[top >= n])):
            rest = np.setdiff1d(pool, mine)
            doomed += [mine, rng.choice(rest, max(half - mine.size, 0),
                                        replace=False)]
        doomed = np.concatenate(doomed)
        self.sync()
        t0 = time.perf_counter()
        removed = sf.delete(doomed, auto_compact=False)
        self.sync()
        out["delete_ms"] = 1e3 * (time.perf_counter() - t0)
        out["deleted"] = removed
        expect(removed == doomed.size,
               f"{label}: deleted {removed} of {doomed.size} ids")
        t0 = time.perf_counter()
        view = sf.view()
        self.sync()
        out["view_after_delete_ms"] = 1e3 * (time.perf_counter() - t0)
        got, out["delete_launches"] = self.counted_search(
            f"{label} after deletes", sf, ys, q_batch, quantize)
        ids = got["ids"]
        expect(bool(got["exact"].all()),
               f"{label} after deletes: a result is not exact")
        expect(not bool(torch.isin(ids, torch.as_tensor(
            doomed, device=ids.device)).any()) and bool((ids >= 0).all()),
               f"{label} after deletes: a deleted id or -1 surfaced")
        live = view.point_ids >= 0
        live_ids = view.point_ids[live].long()
        pos = torch.full((sf.next_id,), -1, dtype=torch.long,
                         device=live_ids.device)
        pos[live_ids] = torch.arange(live_ids.numel(), device=pos.device)
        out["brute_force"] = self.check_brute_force(
            view.rows_view()[live], ys, pos[ids.long()], got["dists"],
            family)
        del pos, live, live_ids
        bits = True
        for j in range(SINGLE_QUERIES):
            one = tsearch.knn(sf, ys[j], K, device=self.dev)
            expect(bool(torch.equal(one.ids, ids[j])) and bool(one.exact),
                   f"{label} after deletes: knn of query {j} differs from "
                   "the batch row")
            diff = (one.dists - got["dists"][j]).abs()
            expect(self.rehearsal or bool(
                (diff <= 1e-5 + 1e-5 * got["dists"][j].abs()).all()),
                f"{label} after deletes: knn dists of query {j} differ")
            bits &= bool(torch.equal(one.dists, got["dists"][j]))
        out["knn_dists_bit_equal"] = bits
        out["distributed"] = self.phase12_mutable(label, sf, ys, q_batch,
                                                  doomed)
        say(f"mutable {label}: delete {out['delete_tail_ms']:.1f} ms for "
            f"{cut} ids, {len(out['insert_ms'])} inserts of "
            f"{out['insert_rows'][0]} rows "
            f"({statistics.median(out['insert_ms']):.1f} ms median), view "
            f"{out['view_ms']:.1f} ms; knn_batch == phase 4 through the id "
            f"map; search {out['search_ms']:.1f} ms per {NUM_QUERIES} "
            f"queries (phase 4 {search_ms:.1f}); {removed} more deleted in "
            f"{out['delete_ms']:.1f} ms (view {out['view_after_delete_ms']:.1f}"
            f" ms): ids match brute force over the live rows "
            f"({out['brute_force']['bf_position_mismatches']} near-tie "
            f"swaps), knn == the batch rows (dists bit-equal: {bits}); "
            f"launches {out['delete_launches']}")

        ys0 = ys[:q_batch]
        if not quantize:
            out["tiered"] = self.mutable_tiered(label, sf, ys0)
        self.sync()
        t0 = time.perf_counter()
        out["decide"] = sf.decide()
        out["decide_s"] = time.perf_counter() - t0
        out["stale_fraction"] = sf.stale_fraction

        # 6. The merge: n == live_n, the search at budget live_n unchanged.
        budget = sf.live_n
        before = tsearch.knn_search_batch(sf, ys0, K, budget,
                                          device=self.dev)
        before = before._asdict()
        codes = None
        if quantize:
            codes = self.codes_by_id(sf.view())
        del view
        self.sync()
        t0 = time.perf_counter()
        sf.compact("merge")
        self.sync()
        out["merge_s"] = time.perf_counter() - t0
        expect(sf.n == sf.live_n == budget and not sf.segments,
               f"{label}: the merge left {sf.n} rows, {sf.live_n} live")
        after = tsearch.knn_search_batch(sf, ys0, K, budget, device=self.dev)
        self.expect_same_result(f"{label} merge at budget {budget}",
                                after._asdict(), before)
        if quantize:
            merged = self.codes_by_id(sf.view())
            expect(all(bool(torch.equal(a, b)) for a, b in
                       zip(codes, merged, strict=True)),
                   f"{label}: the merge moved a point's codes")
            del codes, merged
        # 7. fp32: a rebuild gives the same ids and bit-equal dists.
        if not quantize:
            self.sync()
            t0 = time.perf_counter()
            sf.compact("rebuild", seed=SEED)
            self.sync()
            out["rebuild_s"] = time.perf_counter() - t0
            after = tsearch.knn_search_batch(sf, ys0, K, budget,
                                             device=self.dev)._asdict()
            for f in ("ids", "exact"):
                expect(bool(torch.equal(after[f], before[f])),
                       f"{label} rebuild: {f} differ from before it")
            expect(self.rehearsal or bool(torch.equal(after["dists"],
                                                      before["dists"])),
                   f"{label} rebuild: dists differ from before it")
            out["rebuild_num_candidates_equal"] = bool(torch.equal(
                after["num_candidates"], before["num_candidates"]))
        out["peak_bytes"] = self.peak()
        out["seconds"] = time.perf_counter() - t_phase
        say(f"mutable {label}: decide() would choose {out['decide']} "
            f"({out['decide_s']:.2f} s, stale fraction "
            f"{out['stale_fraction']:.4f}); merge {out['merge_s']:.2f} s, "
            f"bit-equal at budget {budget}"
            + (", codes bit-equal" if quantize else
               f"; rebuild {out['rebuild_s']:.2f} s, same ids, dists "
               "bit-equal") + f"; peak {out['peak_bytes']} B; phase "
            f"{out['seconds']:.1f} s")
        self._mutable_sf = sf           # phase 11's compaction check
        del sf, before, after
        return out

    def codes_by_id(self, view) -> tuple:
        """The int8 point codes and their decode of the live rows, in
        original-id order."""
        live = view.point_ids >= 0
        order = self.torch.argsort(view.point_ids[live])
        return tuple(getattr(view, f)[live][order]
                     for f in ("data", "data_scale", "data_zp"))

    def mutable_tiered(self, label: str, sf, ys0) -> dict:
        """The mutated index in a TieredPointStore at 40% of its cold
        bytes: the append rows' blocks pinned and kept, a fixed-budget
        search bit-equal to the resident search over ``view()``."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        from repro_torch.core.tiered import TieredPointStore
        view = sf.view()
        cold = cold_bytes(view)
        store = TieredPointStore.from_index(sf, resident_bytes=int(0.4 * cold),
                                            block_rows=BLOCK_ROWS)
        lo, hi = sf.append_row_range()
        pinned = frozenset(range(lo // store._bn, -(-hi // store._bn)))
        expect(not store.is_resident and store._pinned == pinned,
               f"{label}: the store pinned {sorted(store._pinned)[:3]}..., "
               f"not the append rows' blocks")
        budget = tsearch.resolve_budget(None, view.n, K)
        want = tsearch.knn_search_batch(sf, ys0, K, budget, device=self.dev)
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        got = tsearch.knn_search_batch(store, ys0, K, budget,
                                       device=self.dev)
        self.sync()
        out = {"ms": 1e3 * (time.perf_counter() - t0), "budget": budget,
               "launches": self.launches(), "stats": dict(store.stats),
               "pinned_blocks": len(pinned), "num_blocks": store.num_blocks}
        self.expect_launches(f"{label} mutated tiered", out["launches"],
                             TIERED_PATH, False)
        for f in got._fields:
            expect(bool(torch.equal(getattr(got, f), getattr(want, f))),
                   f"{label} mutated tiered: {f} at budget {budget} differ "
                   "from the resident search over view()")
        expect(pinned <= set(store._cache),
               f"{label} mutated tiered: a pinned block left the cache")
        store.close()
        say(f"mutable {label} tiered: {len(pinned)} append blocks pinned of "
            f"{store.num_blocks}, bit-equal to resident at budget {budget} "
            f"({out['ms']:.1f} ms, blocks admitted "
            f"{out['stats']['blocks_admitted']} of "
            f"{out['stats']['blocks_total']})")
        return out

    def check_audio_rebuilds(self, label: str, forest, data) -> dict:
        """Phase 10 on Audio: two mutable copies of the index, 10% of the
        ids deleted and 5% new rows inserted into each the same way, each
        compacted by a rebuild: every table bit-equal across the two; the
        rebuilt index's ids against brute force over its live rows."""
        torch = self.torch
        import numpy as np
        from repro_torch.core import search as tsearch
        from repro_torch.core.index import REPLICATED_FIELDS, point_fields
        from repro_torch.core.segments import SegmentedForest
        rng = np.random.default_rng(SEED)
        n = forest.n
        dead = rng.choice(n, n // 10, replace=False)
        extra = data[rng.choice(n, n // 20, replace=False)] * np.float32(1.001)
        t_phase = time.perf_counter()
        out = {"deleted": int(dead.size), "inserted": int(extra.shape[0]),
               "rebuild_s": []}
        mains = []
        for _ in range(2):
            sf = SegmentedForest.from_forest(forest)
            sf.delete(dead, auto_compact=False)
            sf.insert(extra, auto_compact=False)
            self.sync()
            t0 = time.perf_counter()
            sf.compact("rebuild", seed=SEED)
            self.sync()
            out["rebuild_s"].append(time.perf_counter() - t0)
            mains.append(sf.main)
        a, b = mains
        out["differing_tables"] = [
            f for f in point_fields(a) + REPLICATED_FIELDS
            if not torch.equal(getattr(a, f), getattr(b, f))]
        expect(not out["differing_tables"],
               f"{label}: two rebuilds of one mutated index differ in "
               f"{out['differing_tables']}")
        expect(a.n == n - dead.size + extra.shape[0],
               f"{label}: the rebuild holds {a.n} rows")
        ys = torch.as_tensor(extra[:SINGLE_QUERIES] * np.float32(0.999),
                             device=self.dev)
        res = tsearch.knn_batch(a, ys, K, device=self.dev)
        points = a.rows_view()[torch.argsort(a.point_ids.long())]
        # Original ids of the rebuild run 0 ... n + inserted - 1 with the
        # deleted ones missing: brute force over the rows in id order.
        live_ids = torch.sort(a.point_ids.long()).values
        pos = torch.full((n + extra.shape[0],), -1, dtype=torch.long,
                         device=live_ids.device)
        pos[live_ids] = torch.arange(live_ids.numel(), device=pos.device)
        out["brute_force"] = self.check_brute_force(
            points, ys, pos[res.ids.long()], res.dists, forest.family_name)
        out["seconds"] = time.perf_counter() - t_phase
        say(f"mutable {label}: two rebuilds after deleting {dead.size} and "
            f"inserting {extra.shape[0]} rows are bit-equal in every table "
            f"({out['rebuild_s'][0]:.2f} s, {out['rebuild_s'][1]:.2f} s); "
            "knn_batch on the rebuild matches brute force")
        return out

    def drive_blobs_mutable(self, forest, data, ys, want, budget: int,
                            block_rows: int) -> dict:
        """Phase 10 on the blob corpus: the delete-and-reinsert of its last
        tenth, bit-equal to phase 5's resident search through the id map
        before and after a merge, with the blocks the gate admits before
        mutating, after, and after the merge."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        label = "mutable blob corpus"
        t_phase = time.perf_counter()

        def gate(index) -> dict:
            res, st = tsearch.knn_search_batch_stats(
                index, ys, K, budget, block_rows, device=self.dev)
            return res._asdict(), {
                "blocks_run": st["num_blocks_run"],
                "num_blocks": st["num_blocks"],
                "env_admitted_tiles": st["env_admitted_tiles"],
                "tiles": st["num_blocks"] * ys.shape[0]}

        _, before = gate(forest)
        sf, cut, out = self.reinsert_tail(label, forest, data)
        n = forest.n
        want = want._asdict()
        out["gate"] = {"before": before}
        for key in ("mutated", "merged"):
            if key == "merged":
                self.sync()
                t0 = time.perf_counter()
                sf.compact("merge")
                self.sync()
                out["merge_s"] = time.perf_counter() - t0
            self.sync()
            self.reset_launches()
            got, out["gate"][key] = gate(sf)
            self.sync()
            out[key + "_launches"] = self.launches()
            self.expect_launches(f"{label} {key}", out[key + "_launches"],
                                 RESIDENT_PATH, False)
            got["ids"] = torch.where(got["ids"] >= n, got["ids"] - cut,
                                     got["ids"])
            self.expect_same_result(f"{label} {key} against phase 5 "
                                    "through the id map", got, want)
        out["seconds"] = time.perf_counter() - t_phase
        g = out["gate"]
        say(f"{label}: delete and reinsert of {cut} rows bit-equal to phase "
            f"5 through the id map, before and after a merge "
            f"({out['merge_s']:.2f} s); blocks run / total: before "
            f"{g['before']['blocks_run']}/{g['before']['num_blocks']}, "
            f"mutated {g['mutated']['blocks_run']}/"
            f"{g['mutated']['num_blocks']}, merged "
            f"{g['merged']['blocks_run']}/{g['merged']['num_blocks']}; "
            f"(block, query) tiles admitted: before "
            f"{g['before']['env_admitted_tiles']}, mutated "
            f"{g['mutated']['env_admitted_tiles']}, merged "
            f"{g['merged']['env_admitted_tiles']}")
        del sf
        return out

    def knnlm_mutable(self, bundle, params, store, cfg, seq_len: int,
                      rng) -> dict:
        """Phase 10 on the kNN-LM datastore, after serving: ``grow`` by the
        keys of ``MUTATION_SEQS`` more seeded sequences (one forward
        batch through #10), ``evict`` ``EVICT_KEYS`` keys, then one hook
        call: its ids equal brute force over the live keys, a new key
        finds itself and its token leads the mix at lambda = 0.5, and a
        second call gives the same bits.  The store served in phase 7 is
        left as it was (the grow wraps its forest in a new datastore)."""
        torch = self.torch
        import numpy as np
        from repro_torch.serve import knnlm as tknnlm
        label = "mutable kNN-LM"
        t_phase = time.perf_counter()
        corpus = rng.integers(1, cfg.vocab_size, (MUTATION_SEQS, seq_len))
        mstore = tknnlm.Datastore(index=store.index,
                                  next_tokens=store.next_tokens.copy(),
                                  hidden_dim=store.hidden_dim,
                                  block_rows=store.block_rows)
        n0 = store.index.n
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        keys = tknnlm._forward_keys(bundle, params, corpus)
        self.sync()
        out = {"forward_ms": 1e3 * (time.perf_counter() - t0),
               "forward_launches": self.launches(),
               "forward_flash_kernels": self.flash_launches()}
        self.expect_launches(f"{label} forward", out["forward_launches"],
                             ("flash_attention",), False)
        vals = corpus[:, 1:].reshape(-1).astype(np.int32)
        t0 = time.perf_counter()
        new_ids = mstore.grow(keys, vals)
        self.sync()
        out["grow_ms"] = 1e3 * (time.perf_counter() - t0)
        out["grown"] = int(new_ids.size)
        expect(np.array_equal(new_ids, np.arange(n0, n0 + keys.shape[0])),
               f"{label}: grow returned ids {new_ids[:3]}...")
        evict = min(EVICT_KEYS, n0 // 8)
        gone = np.random.default_rng(SEED).choice(n0, evict, replace=False)
        t0 = time.perf_counter()
        removed = mstore.evict(gone)
        self.sync()
        out["evict_ms"] = 1e3 * (time.perf_counter() - t0)
        out["evicted"] = removed
        expect(removed == evict and mstore.version == 2,
               f"{label}: evicted {removed} of {evict} keys")

        # Four new keys queried exactly, four near new keys.
        hidden = torch.cat([keys[:4], keys[4:8] * 1.01]).contiguous()
        logits = torch.zeros((hidden.shape[0], cfg.vocab_size),
                             dtype=torch.float32, device=self.dev)
        hook = tknnlm.KNNLMHook(store=mstore, k=KNN_K, lam=0.5)
        self.sync()
        self.reset_launches()
        t0 = time.perf_counter()
        mixed = hook(logits, hidden)
        self.sync()
        out["hook_ms"] = 1e3 * (time.perf_counter() - t0)
        out["hook_launches"] = self.launches()
        self.expect_launches(f"{label} hook", out["hook_launches"],
                             RESIDENT_PATH, False)
        res = hook.last_result
        ids = res.ids
        expect(not bool(torch.isin(ids, torch.as_tensor(
            gone, device=ids.device)).any()),
               f"{label}: an evicted key surfaced")
        view = mstore.index.view()
        live = view.point_ids >= 0
        live_ids = view.point_ids[live].long()
        pos = torch.full((mstore.index.next_id,), -1, dtype=torch.long,
                         device=live_ids.device)
        pos[live_ids] = torch.arange(live_ids.numel(), device=pos.device)
        out["brute_force"] = self.check_brute_force(
            view.data[live], hidden, pos[ids.long()], res.dists,
            "squared_euclidean", k=KNN_K)
        del pos, live, live_ids, view
        first = torch.as_tensor(new_ids[:4], device=ids.device)
        expect(bool(torch.equal(ids[:4, 0].to(first.dtype), first)),
               f"{label}: a new key queried exactly did not find itself")
        lead = torch.argmax(mixed[:4], dim=-1).cpu().numpy()
        expect(np.array_equal(lead, vals[:4]),
               f"{label}: the mix led with {lead}, not the new keys' "
               f"tokens {vals[:4]}")
        again = hook(logits, hidden)
        out["repeat_bit_equal"] = bool(torch.equal(again, mixed))
        expect(out["repeat_bit_equal"],
               f"{label}: two hook calls on the same inputs differ")
        out["seconds"] = time.perf_counter() - t_phase
        say(f"{label}: grow by {out['grown']} keys ({MUTATION_SEQS} "
            f"sequences, forward {out['forward_ms']:.1f} ms, insert "
            f"{out['grow_ms']:.1f} ms), evict {removed} keys "
            f"({out['evict_ms']:.1f} ms); the next hook call "
            f"({out['hook_ms']:.1f} ms) matches brute force over the live "
            f"keys, new keys find themselves and lead the mix at "
            f"lambda 0.5, a second call is bit-equal; launches "
            f"{out['hook_launches']}")
        del mstore, hook, keys
        return out

    # -- phase 11: the serving front end -------------------------------
    @contextlib.contextmanager
    def tuned(self):
        """Phase 11 runs with the port's autotuner table; phases 1-10 run
        without it (``run`` points ``TABLE_ENV`` at a missing file), so
        their ``block_rows=None`` resolves to 4096 as in the runs before
        the table existed."""
        import os
        from repro_torch.launch import autotune
        saved = os.environ.pop(autotune.TABLE_ENV, None)
        autotune._load_table_cached.cache_clear()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase11_s += time.perf_counter() - t0
            if saved is not None:
                os.environ[autotune.TABLE_ENV] = saved
            autotune._load_table_cached.cache_clear()

    def expect_rows(self, label: str, resp, rows, want_ids, want_dists,
                    quality: str = "exact") -> bool:
        """A response's rows against the rows ``rows`` of a reference
        result: every row labelled ``quality``, ids equal, dists bit-equal
        on the card (within 1e-5 on the CPU, whose plain refine rounds by
        the batch's shape).  Returns whether the dists' bits are equal."""
        import numpy as np
        expect(resp.quality == quality
               and all(q == quality for q in resp.row_quality),
               f"{label}: quality {resp.quality} {resp.row_quality} "
               f"({resp.shed_reason}, {resp.error}), not {quality}")
        ids = want_ids[rows].cpu().numpy()
        dists = want_dists[rows].cpu().numpy()
        expect(np.array_equal(resp.ids, ids),
               f"{label}: ids differ from the reference rows")
        bits = np.array_equal(resp.dists.view(np.uint32),
                              dists.view(np.uint32))
        expect(bits or (self.rehearsal and np.allclose(
            resp.dists, dists, rtol=1e-5, atol=1e-5)),
            f"{label}: dists differ from the reference rows")
        return bits

    def expect_events(self, label: str, plan, want: list) -> None:
        import dataclasses
        got = [dataclasses.astuple(e) for e in plan.events]
        expect(got == want, f"{label}: fired {got}, the plan expects {want}")

    def phase11_service(self, label: str, forest, ys, ids, dists,
                        quantize: bool, mesh=None) -> dict:
        """11a: Deep as a tenant of a deterministic service (VirtualClock,
        ``ServiceConfig()`` defaults); 48 requests of 1, 2 and 4 queries
        in turn from the 50, k = 10, deadline 60 s, drained by
        ``run_until_drained``: every response exact and bit-equal to phase
        4's rows, no launch failure, no breaker shed, the tier's #1/#3/#7
        (int8 #2/#4/#8) launched at least once a microbatch launch.  With
        ``mesh`` (12d) the tenant is registered sharded over it and its
        responses must also equal 11a's."""
        from repro_torch.serve import RetrievalService, ServiceConfig
        from repro_torch.serve.faults import VirtualClock
        svc = RetrievalService(ServiceConfig(), clock=VirtualClock())
        self.sync()
        t0 = time.perf_counter()
        tenant = svc.register_tenant("deep", forest, mesh=mesh)
        expect((mesh is None) == (tenant.sharded is None),
               f"{label}: the tenant's sharding does not follow mesh=")
        self.sync()
        out = {"register_s": time.perf_counter() - t0,
               "block_rows": tenant.block_rows}
        expect(not tenant.degraded, f"{label}: the tenant was quarantined")
        tickets, rows, cur = [], [], 0
        for i in range(48):
            size = (1, 2, 4)[i % 3]
            sel = [(cur + j) % NUM_QUERIES for j in range(size)]
            cur += size
            rows.append(sel)
            tickets.append(svc.submit("deep", ys[sel], K, deadline_s=60.0))
        self.reset_launches()
        self.reset_peak()
        retries = self.alloc_retries()
        self.sync()
        t0 = time.perf_counter()
        svc.run_until_drained()
        self.sync()
        out["drain_ms"] = 1e3 * (time.perf_counter() - t0)
        out["peak_bytes"] = self.peak()
        if retries is not None:
            # Allocations the caching allocator retried after freeing its
            # cache: its slow path, which a first large gather can take.
            out["alloc_retries"] = self.alloc_retries() - retries
        got, sfx = self.launches(), "_quant" if quantize else ""
        out["kernel_launches"] = {k + sfx: got[k + sfx] for k in RESIDENT_PATH}
        c = svc.counters
        bits = all([self.expect_rows(f"{label} service request {i}",
                                     t.response, sel, ids, dists)
                    for i, (t, sel) in enumerate(zip(tickets, rows,
                                                     strict=True))])
        expect(c["launch_failures"] == 0 and c["breaker_sheds"] == 0
               and c["exact"] == 48,
               f"{label}: service counters {c}")
        microbatches = c["launches"] - c["escalations"]
        expect(self.rehearsal or all(
            v >= c["launches"] for v in out["kernel_launches"].values()),
            f"{label}: kernels {out['kernel_launches']} for "
            f"{c['launches']} service launches")
        out.update(counters=dict(c), launches=c["launches"],
                   escalations=c["escalations"], microbatches=microbatches,
                   rows=sum(len(r) for r in rows),
                   mean_rows_per_microbatch=sum(len(r) for r in rows)
                   / microbatches, dists_bit_equal=bits,
                   buckets=sorted({t.response.meta["bucket"]
                                   for t in tickets}))
        responses = [(t.response.ids, t.response.dists) for t in tickets]
        if mesh is None:
            self._service_rows[label] = responses
        else:
            import numpy as np
            want = self._service_rows[label]
            out["equals_11a"] = all(
                np.array_equal(a[0], b[0]) and np.array_equal(
                    a[1].view(np.uint32), b[1].view(np.uint32))
                for a, b in zip(responses, want, strict=True))
            expect(out["equals_11a"], f"{label}: the sharded tenant's "
                   "responses differ from 11a's")
        say(f"{'distributed service' if mesh is not None else 'service'} "
            f"{label}: 48 requests exact, ids and dists "
            f"{'bit-equal' if bits else 'within 1e-5'} to phase 4's rows; "
            f"{microbatches} microbatches ({out['mean_rows_per_microbatch']:.1f}"
            f" rows each, buckets {out['buckets']}), {c['launches']} launches "
            f"({c['escalations']} escalations) in {out['drain_ms']:.1f} ms; "
            f"kernels {out['kernel_launches']}; peak {out['peak_bytes']} B; "
            "registration "
            f"{out['register_s']:.3f} s (validation on the device), "
            f"block_rows pinned {tenant.block_rows}")
        return out

    def phase11_faults(self, label: str, forest, ys, ids, dists, sf) -> dict:
        """11b: seeded faults on the Deep fp32 tenant: a launch error
        retried, a poisoned row shed alone (a poisoned request shed as
        ``poisoned``), a latency spike that prices out the exact tier
        (approx responses bit-equal to ``knn_search_batch_approx`` at p =
        0.9), a larger one (partial, then an explicit shed), and on phase
        10's mutable index a compaction between snapshot and launch
        (bit-equal to searching the recorded snapshot)."""
        import numpy as np
        from repro_torch.core import search as tsearch
        from repro_torch.serve import RetrievalService, ServiceConfig
        from repro_torch.serve import faults as tf
        out = {}
        four = [0, 1, 2, 3]

        def service(plan, index=forest, name="deep", **cfg):
            svc = RetrievalService(ServiceConfig(**cfg),
                                   clock=tf.VirtualClock(), faults=plan)
            svc.register_tenant(name, index)
            return svc

        # A launch error on the first launch: backoff, retry, exact.
        plan = tf.FaultPlan([tf.LaunchError(at_launches=0)], seed=4)
        svc = service(plan)
        r = svc.search_sync("deep", ys[four], K, deadline_s=60.0)
        self.expect_rows(f"{label} launch error retried", r, four, ids,
                         dists)
        expect(svc.counters["launch_failures"] == 1
               and svc.tenants["deep"].breaker.state == "closed",
               f"{label} launch error: counters {svc.counters}")
        self.expect_events(f"{label} launch error", plan, [
            ("error", "launch", 0, "deep", "injected launch failure")])
        out["launch_error"] = {"attempts": r.meta["attempts"],
                               "tier_path": r.meta["tier_path"],
                               "latency_s": r.latency_s}

        # Poison: one row of a 4-row request, then a 1-row request.
        plan = tf.FaultPlan([tf.PoisonQuery(at_submits=0, row=1),
                             tf.PoisonQuery(at_submits=1, row=0)], seed=5)
        svc = service(plan)
        r = svc.search_sync("deep", ys[four], K, deadline_s=60.0)
        expect(r.flagged_rows == [1] and r.row_quality[1] == "shed"
               and (r.ids[1] == -1).all() and np.isinf(r.dists[1]).all()
               and r.quality == "exact",
               f"{label} poison: {r.quality} {r.row_quality} "
               f"{r.flagged_rows}")
        for i in (0, 2, 3):
            expect(r.row_quality[i] == "exact"
                   and np.array_equal(r.ids[i], ids[i].cpu().numpy()),
                   f"{label} poison: batchmate {i} is not exact or differs")
        r2 = svc.search_sync("deep", ys[[5]], K, deadline_s=60.0)
        expect(r2.quality == "shed" and r2.shed_reason == "poisoned",
               f"{label} poison: a poisoned request answered {r2.quality} "
               f"({r2.shed_reason})")
        self.expect_events(f"{label} poison", plan, [
            ("poison", "submit", 0, "deep", "row=1 value=nan"),
            ("poison", "submit", 1, "deep", "row=0 value=nan")])
        out["poison"] = {"poisoned_rows": svc.counters["poisoned_rows"],
                         "launches": svc.counters["launches"]}

        # A latency spike teaches the cost model; a deadline between one
        # and two estimates then enters at the approx tier.
        plan = tf.FaultPlan([tf.LatencySpike(1.0, at_launches=0)], seed=1)
        svc = service(plan)
        svc.search_sync("deep", ys[four], K, deadline_s=60.0)
        est = svc.tenants["deep"].cost.estimate()
        sel = [4, 5, 6, 7]
        r = svc.search_sync("deep", ys[sel], K, deadline_s=1.5 * est)
        expect(r.meta["tier_path"][0] == "approx",
               f"{label} spike: tiers {r.meta['tier_path']}")
        want = tsearch.knn_search_batch_approx(
            forest, ys[sel], K, r.meta["budget"], np.float32(0.9),
            block_rows=svc.tenants["deep"].block_rows, device=self.dev)
        approx_bits = self.expect_rows(f"{label} approx tier", r, list(
            range(4)), want.ids, want.dists, quality="approx")
        self.expect_events(f"{label} spike", plan, [
            ("latency", "launch", 0, "deep", "+1.000s tier=exact")])
        out["approx"] = {"estimate_s": est, "deadline_s": 1.5 * est,
                         "tier_path": r.meta["tier_path"],
                         "budget": r.meta["budget"],
                         "dists_bit_equal": approx_bits}

        # A larger spike: partial, then a shed without a launch.
        plan = tf.FaultPlan([tf.LatencySpike(4.0, at_launches=0)], seed=2)
        svc = service(plan)
        svc.search_sync("deep", ys[four], K, deadline_s=60.0)
        est = svc.tenants["deep"].cost.estimate()
        r = svc.search_sync("deep", ys[sel], K, deadline_s=0.8 * est)
        expect(r.meta["tier_path"] == ["partial"] and r.quality == "partial",
               f"{label} larger spike: {r.quality} {r.meta['tier_path']}")
        before = svc.counters["launches"]
        est2 = svc.tenants["deep"].cost.estimate()
        r2 = svc.search_sync("deep", ys[sel], K, deadline_s=0.3 * est2)
        expect(r2.quality == "shed" and r2.shed_reason == "deadline"
               and (r2.ids == -1).all()
               and svc.counters["launches"] == before,
               f"{label} larger spike: {r2.quality} {r2.shed_reason}")
        self.expect_events(f"{label} larger spike", plan, [
            ("latency", "launch", 0, "deep", "+4.000s tier=exact")])
        out["partial_then_shed"] = {
            "estimate_s": est, "partial_deadline_s": 0.8 * est,
            "partial_rows": r.row_quality, "shed_deadline_s": 0.3 * est2}

        # A compaction between the snapshot and the launch.
        n0 = sf.live_n
        plan = tf.FaultPlan([tf.CompactDuringSearch(at_launches=0,
                                                    insert_rows=8)], seed=6)
        svc = service(plan, index=sf, name="deep_mutable",
                      record_snapshots=True)
        self.sync()
        t0 = time.perf_counter()
        r = svc.search_sync("deep_mutable", ys[four], K, deadline_s=60.0)
        self.sync()
        ms = 1e3 * (time.perf_counter() - t0)
        snap = r.meta["snapshot"]
        expect(sf.live_n == n0 + 8 and snap.n == n0 and not sf.segments,
               f"{label} compaction: live {sf.live_n}, snapshot {snap.n}")
        want = tsearch.knn_search_batch(snap, ys[four], K, r.meta["budget"],
                                        block_rows=svc.tenants[
                                            "deep_mutable"].block_rows,
                                        device=self.dev)
        compact_bits = self.expect_rows(f"{label} compaction during search",
                                        r, four, want.ids, want.dists)
        self.expect_events(f"{label} compaction", plan, [
            ("compact", "launch", 0, "deep_mutable",
             "mode=merge insert_rows=8")])
        out["compaction"] = {"ms": ms, "live_before": n0,
                             "dists_bit_equal": compact_bits}
        say(f"service {label} faults: a launch error retried (exact, "
            f"bit-equal); a poisoned row shed alone, a poisoned request "
            f"shed 'poisoned'; spike 1.0 s -> approx at deadline "
            f"{out['approx']['deadline_s']:.3f} s (== knn_search_batch_approx "
            f"p=0.9, bits {approx_bits}); spike 4.0 s -> partial, then shed; "
            f"a merge between snapshot and launch ({ms:.1f} ms): == the "
            f"snapshot's search (bits {compact_bits}); every plan fired "
            "its expected events")
        return out

    def phase11_wall_clock(self, label: str, forest, ys, ids, dists) -> dict:
        """11d: a SystemClock service, no faults: 128 requests of 1-8
        queries (seeded), 16 submitted a step, deadline 2 s.  No launch
        fails; every response labelled exact is bit-equal to phase 4's
        rows; latency percentiles and the tier mix are recorded (the
        ladder may degrade under real time)."""
        import numpy as np
        from repro_torch.serve import RetrievalService, ServiceConfig
        svc = RetrievalService(ServiceConfig())
        svc.register_tenant("deep", forest)
        svc.warm("deep", shapes=[(32, K)])
        rng = np.random.default_rng(SEED)
        sizes = rng.integers(1, 9, size=128)
        tickets, rows, cur = [], [], 0
        t0 = time.perf_counter()
        for i, size in enumerate(sizes):
            sel = [(cur + j) % NUM_QUERIES for j in range(int(size))]
            cur += int(size)
            rows.append(sel)
            tickets.append(svc.submit("deep", ys[sel], K, deadline_s=2.0))
            if i % 16 == 15:
                svc.step()
        svc.run_until_drained()
        wall = time.perf_counter() - t0
        c = svc.counters
        expect(c["launch_failures"] == 0,
               f"{label} wall clock: {c['launch_failures']} launch failures")
        bits = True
        for i, (t, sel) in enumerate(zip(tickets, rows, strict=True)):
            if t.response.quality == "exact":
                bits &= self.expect_rows(f"{label} wall-clock request {i}",
                                         t.response, sel, ids, dists)
        lat = np.array([1e3 * t.response.latency_s for t in tickets])
        mix = {q: c[q] for q in ("exact", "approx", "partial", "shed")}
        shed_by = {r: c[k] for r, k in (("queue_full", "rejected_queue_full"),
                                        ("deadline", "deadline_sheds"),
                                        ("breaker", "breaker_sheds"))}
        out = {"requests": len(tickets), "rows": int(sizes.sum()),
               "shed_by": shed_by,
               "wall_s": wall, "p50_ms": float(np.percentile(lat, 50)),
               "p99_ms": float(np.percentile(lat, 99)),
               "max_ms": float(lat.max()), "quality": mix,
               "microbatches": c["launches"] - c["escalations"],
               "launches": c["launches"], "escalations": c["escalations"],
               "deadline_sheds": c["deadline_sheds"],
               "estimate_s": svc.tenants["deep"].cost.estimate(),
               "exact_dists_bit_equal": bits}
        say(f"service {label} wall clock: {len(tickets)} requests "
            f"({out['rows']} rows, 16 a step, deadline 2 s) in {wall:.2f} s: "
            f"p50 {out['p50_ms']:.1f} ms, p99 {out['p99_ms']:.1f} ms; "
            f"quality {mix} (shed by {shed_by}); {out['microbatches']} "
            "microbatches (one a step()), "
            f"{c['launches']} launches; cost estimate "
            f"{1e3 * out['estimate_s']:.1f} ms; no launch failed, exact "
            "responses equal phase 4's rows")
        return out

    def phase11_deep(self, label: str, forest, ys, ids, dists, quantize,
                     sf) -> dict:
        """Phase 11 on a Deep drive's index (before it is freed)."""
        with self.tuned():
            out = {"service": self.phase11_service(label, forest, ys, ids,
                                                   dists, quantize)}
            if not quantize:
                out["faults"] = self.phase11_faults(label, forest, ys, ids,
                                                    dists, sf)
                out["wall_clock"] = self.phase11_wall_clock(label, forest,
                                                            ys, ids, dists)
        return out

    def phase11_blobs(self, forest, ys, exact, block_rows: int) -> dict:
        """11c and 11g on the blob corpus: the corpus as a tiered tenant at
        40% of its cold bytes, warmed; 16 requests of 4 queries exact and
        bit-equal to phase 5's resident search; a FetchStall within the
        launch timeout rides as latency.  Then the resident search at the
        tuned block size against 4096, both timed."""
        import numpy as np
        from repro_torch.core import search as tsearch
        from repro_torch.launch import autotune
        from repro_torch.serve import RetrievalService, ServiceConfig
        from repro_torch.serve import faults as tf
        out = {}
        with self.tuned():
            cold = cold_bytes(forest)
            plan = tf.FaultPlan([tf.FetchStall(0.5, at_launches=0,
                                               tenant="blobs")], seed=11)
            svc = RetrievalService(ServiceConfig(), clock=tf.VirtualClock(),
                                   faults=plan)
            self.sync()
            t0 = time.perf_counter()
            tenant = svc.register_tenant("blobs", forest,
                                         resident_bytes=int(0.4 * cold))
            self.sync()
            out["register_s"] = time.perf_counter() - t0
            store = tenant.tiered
            expect(store is not None and not store.is_resident,
                   "service blobs: the tenant did not tier")
            t0 = time.perf_counter()
            warm = svc.warm("blobs", shapes=[(32, K)])
            self.sync()
            out["warm_s"] = time.perf_counter() - t0
            out["warm"] = warm["tiered"]
            store.reset_stats()
            q = ys.shape[0]
            tickets, rows = [], []
            for i in range(16):
                sel = [(4 * i + j) % q for j in range(4)]
                rows.append(sel)
                tickets.append(svc.submit("blobs", ys[sel], K,
                                          deadline_s=60.0))
            self.reset_launches()
            self.sync()
            t0 = time.perf_counter()
            svc.run_until_drained()
            self.sync()
            out["drain_ms"] = 1e3 * (time.perf_counter() - t0)
            out["kernel_launches"] = self.launches()
            bits = all([self.expect_rows(f"service blobs request {i}",
                                         t.response, sel, exact.ids,
                                         exact.dists)
                        for i, (t, sel) in enumerate(zip(tickets, rows,
                                                         strict=True))])
            stalled = [t.response.latency_s for t in tickets
                       if t.response.latency_s >= 0.5]
            expect(len(stalled) >= 1 and svc.counters["launch_failures"] == 0,
                   "service blobs: the fetch stall did not ride as latency")
            self.expect_events("service blobs fetch stall", plan, [
                ("fetch_stall", "launch", 0, "blobs", "+0.500s tier=exact")])
            expect(self.rehearsal or (
                out["kernel_launches"]["bregman_prune_mask"] >= 1
                and out["kernel_launches"]["bregman_refine_batch"]
                >= svc.counters["launches"]),
                f"service blobs: kernels {out['kernel_launches']}")
            stats = dict(store.stats)
            out.update(counters=dict(svc.counters), stats=stats,
                       store_block_rows=store.block_rows,
                       dists_bit_equal=bits, stalled=len(stalled))
            store.close()
            say(f"service blobs (tiered, {store.block_rows}-row blocks, 40% "
                f"of {cold} cold bytes): 16 requests of 4 exact and "
                f"{'bit-equal' if bits else 'within 1e-5'} to phase 5's "
                f"resident search in {out['drain_ms']:.1f} ms (warm "
                f"{out['warm_s']:.2f} s); blocks admitted "
                f"{stats['blocks_admitted']} of {stats['blocks_total']}; a "
                f"0.5 s fetch stall rode as latency on {len(stalled)} "
                f"responses; kernels {out['kernel_launches']}")

            # 11g: the tuned block size against 4096 where the gate prunes.
            # The card's entry for the corpus's (n, q), and the same n's
            # q = 8 entry beside it (the q = 32 entry may be 4096 itself).
            n = forest.n
            tuned = autotune.lookup_block_rows(1 << 20, q, storage="f32",
                                               backend="cuda")
            other = autotune.lookup_block_rows(1 << 20, 8, storage="f32",
                                               backend="cuda")
            expect(tuned is not None and other is not None,
                   "autotune: no table entry for the blob corpus's shape")
            sizes = sorted({tuned, other, BLOCK_ROWS})
            budget = tsearch.resolve_budget(None, n, K)
            res, times = {}, {}
            for br in sizes + sizes[::-1]:
                self.sync()
                t0 = time.perf_counter()
                res[br] = tsearch.knn_search_batch(forest, ys, K, budget, br,
                                                   device=self.dev)
                self.sync()
                times.setdefault(br, []).append(
                    1e3 * (time.perf_counter() - t0))
            gate = {}
            for br in sizes:
                for f in res[BLOCK_ROWS]._fields:
                    expect(bool(self.torch.equal(getattr(res[br], f),
                                                 getattr(res[BLOCK_ROWS], f))),
                           f"autotune: {f} at block_rows={br} differ from "
                           f"{BLOCK_ROWS}")
                _, st = tsearch.knn_search_batch_stats(forest, ys, K, budget,
                                                       br, device=self.dev)
                gate[str(br)] = {"blocks_run": st["num_blocks_run"],
                                 "num_blocks": st["num_blocks"]}
            out["tuned"] = {"block_rows": tuned, "q8_block_rows": other,
                            "ms": {str(br): times[br] for br in sizes},
                            "gate": gate}
            say(f"autotune: blob corpus (q={q}) at the tuned block_rows="
                f"{tuned} and the q=8 entry's {other}, against "
                f"{BLOCK_ROWS}: bit-equal; ms in turns "
                f"{out['tuned']['ms']}; gate {gate}")
        return out

    def phase11_knnlm(self, bundle, params, store, prompts, outputs, ecfg,
                      new: int) -> dict:
        """11e: the engine with the hook routed through a RetrievalService
        gives phase 7's tokens; the hook at target_recall and approx_p
        equals knn_batch at the same knob, dists bit-equal."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        from repro_torch.serve import RetrievalService, ServiceConfig
        from repro_torch.serve.engine import Engine, Request
        from repro_torch.serve.knnlm import KNNLMHook
        out = {}
        with self.tuned():
            svc = RetrievalService(ServiceConfig())
            hook = KNNLMHook(store=store, k=KNN_K, service=svc,
                             deadline_s=60.0)
            eng = Engine(bundle, params, ecfg, logits_hook=hook)
            for uid, prompt in enumerate(prompts):
                eng.submit(Request(uid=uid, prompt=prompt,
                                   max_new_tokens=new))
            self.reset_launches()
            self.sync()
            t0 = time.perf_counter()
            eng.run()
            self.sync()
            serve_s = time.perf_counter() - t0
            got = {r.uid: r.output for r in eng.finished}
            expect(got == outputs, "kNN-LM service route: the engine's "
                   "tokens differ from phase 7's direct hook")
            c = svc.counters
            expect(c["launch_failures"] == 0 and c["shed"] == 0
                   and c["exact"] == c["completed"],
                   f"kNN-LM service route: counters {c}")
            generated = sum(len(o) for o in got.values())
            out["service_route"] = {
                "serve_s": serve_s, "tokens_per_s": generated / serve_s,
                "counters": dict(c), "launches": self.launches(),
                "block_rows": svc.tenants[hook.service_tenant].block_rows,
                "estimate_s": svc.tenants[hook.service_tenant]
                .cost.estimate()}
            say(f"kNN-LM service route: the engine's {generated} tokens "
                f"equal phase 7's ({serve_s:.2f} s, "
                f"{out['service_route']['tokens_per_s']:.1f} tokens/s); "
                f"{c['completed']} hook lookups exact, {c['launches']} "
                f"service launches ({c['escalations']} escalations)")
            del eng
            gen = torch.Generator(device=self.dev).manual_seed(SEED)
            keys = store.index.data
            pick = torch.randint(0, keys.shape[0], (SLOTS,), generator=gen,
                                 device=self.dev)
            h = keys[pick] + 0.01 * torch.randn(
                (SLOTS, keys.shape[1]), generator=gen, device=self.dev)
            logits = torch.zeros((SLOTS, bundle.cfg.vocab_size),
                                 device=self.dev)
            for knob in ({"target_recall": 0.9}, {"approx_p": 0.9}):
                hk = KNNLMHook(store=store, k=KNN_K, **knob)
                name = next(iter(knob))
                want = tsearch.knn_batch(store.index, h, KNN_K,
                                         device=self.dev, **knob)
                calls = []
                for _ in range(2):
                    self.sync()
                    t0 = time.perf_counter()
                    hk(logits, h)
                    self.sync()
                    calls.append(1e3 * (time.perf_counter() - t0))
                    res = hk.last_result
                    expect(bool(torch.equal(res.ids, want.ids)),
                           f"kNN-LM hook {knob}: ids differ from knn_batch")
                    expect(bool(torch.equal(res.dists, want.dists))
                           or (self.rehearsal and bool(torch.allclose(
                               res.dists, want.dists, rtol=1e-5,
                               atol=1e-5))),
                           f"kNN-LM hook {knob}: dists differ from "
                           "knn_batch")
                out[name] = {"ms": calls, "budget": hk.budget_final,
                             "escalations": hk.escalations,
                             "exact_rows": int(res.exact.sum())}
            cal = store.index.calibration
            out["curve"] = [float(x) for x in cal.recall_grid]
            out["p_at_0.9"] = cal.resolve(0.9)[0]
            say(f"kNN-LM hook at target_recall=0.9 (p={out['p_at_0.9']}) and "
                f"approx_p=0.9: two calls each equal knn_batch (ids, dists "
                f"bit for bit); ms {out['target_recall']['ms']} / "
                f"{out['approx_p']['ms']}; curve {out['curve']}")
        return out

    def phase11_launcher(self) -> dict:
        """11f: ``repro_torch.launch.serve.main`` at full width (the
        reduced config on the CPU): it exits 0 and the hook serves."""
        import contextlib as _cl
        import io
        from repro_torch.launch import serve as tserve
        args = ["--arch", "starcoder2-3b", "--requests", "8", "--slots",
                "4", "--prompt-len", "16", "--new-tokens", "16", "--knnlm"]
        if self.rehearsal:
            args += ["--reduced", "--device", "cpu"]
        with self.tuned():
            buf = io.StringIO()
            t0 = time.perf_counter()
            with _cl.redirect_stdout(buf):
                rc = tserve.main(args)
            seconds = time.perf_counter() - t0
            text = buf.getvalue()
            served = re.search(r"kNN queries served: (\d+)", text)
            rate = re.search(r"\(([0-9.]+) tok/s", text)
            expect(rc == 0 and served and int(served.group(1)) > 0 and rate,
                   f"serve launcher: rc {rc}, output {text!r}")
            out = {"argv": args, "seconds": seconds,
                   "tokens_per_s": float(rate.group(1)),
                   "queries_served": int(served.group(1)),
                   "output": text.strip().splitlines()}
        if not self.rehearsal:
            self.torch.cuda.empty_cache()
        say(f"serve launcher ({' '.join(args)}): exit 0, "
            f"{out['tokens_per_s']} tokens/s, {out['queries_served']} kNN "
            f"queries served, {seconds:.1f} s")
        return out

    def phase11_autotune(self) -> dict:
        """11g: the checked-in table loads, every entry ``cuda`` and
        well-formed; Deep's and the hook's shapes hit it; one sweep cell
        runs on the card with a positive memory probe."""
        import json as _json
        from repro_torch.launch import autotune
        out = {}
        with self.tuned():
            payload = _json.loads(autotune.DEFAULT_TABLE_PATH.read_text())
            entries = autotune.load_table()
            expect(len(entries) > 0 and len(entries)
                   == len(payload["entries"]), "autotune: the table is empty "
                   "or holds malformed entries")
            for e in entries:
                expect(e.get("backend") == "cuda"
                       and e.get("storage") in ("f32", "int8")
                       and int(e["block_rows"]) >= 8
                       and int(e["env_block_rows"]) % 256 == 0,
                       f"autotune: entry {e} is not a well-formed cuda entry")
            hits = {}
            for name, (n, q) in {"deep": (1_000_000, NUM_QUERIES),
                                 "hook": (65_472, KNN_K)}.items():
                hits[name] = autotune.lookup_block_rows(
                    n, q, storage="f32", backend="cuda")
                expect(hits[name] is not None,
                       f"autotune: no entry for {name}'s shape")
            out.update(entries=len(entries), note=payload["note"], hits=hits)
            n, d, m = (2048, 32, 4) if self.rehearsal else (1 << 16, 256, 39)
            cfg = autotune.SweepConfig(
                ns=(n,), qs=(8,), d=d, m=m, storages=("f32",),
                block_rows_candidates=(2048, 4096), env_candidates=(1024,),
                device=str(self.dev))
            lines = []
            t0 = time.perf_counter()
            cell = autotune.sweep(cfg, log=lines.append)
            out["sweep_s"] = time.perf_counter() - t0
            expect(len(cell) == 1, f"autotune: the sweep cell gave {cell}")
            temp = cell[0]["temp_bytes"]
            expect((temp is None) if self.rehearsal else
                   (isinstance(temp, int) and temp > 0),
                   f"autotune: measure_memory gave {temp}")
            out["sweep"] = {"entry": cell[0], "log": lines}
        if not self.rehearsal:
            self.torch.cuda.empty_cache()
        say(f"autotune: the table's {len(entries)} entries are cuda and "
            f"well-formed (note: {payload['note']}); Deep hits block_rows="
            f"{hits['deep']}, the hook {hits['hook']}; a sweep cell "
            f"(n={n}, q=8, f32, block_rows 2048/4096, env 1024) in "
            f"{out['sweep_s']:.1f} s: {cell[0]['block_rows']} wins, "
            f"{cell[0]['us_per_call']} us, peak {temp} B above the index")
        return out

    # -- phase 12: the distributed search and the baselines --------------
    @contextlib.contextmanager
    def phase12_group(self):
        """A world-size-1 ("data",) mesh for one step of phase 12, its group
        ended after the step, so nothing of it stays into the phases
        after: NCCL on the card, its bootstrap on the loopback interface
        (``NCCL_SOCKET_IFNAME=lo``, set in this process's environment),
        gloo in the CPU rehearsal.  If NCCL cannot start the run fails;
        nothing falls back to gloo."""
        import os
        import torch.distributed as dist
        from repro_torch.dist.sharding import make_mesh
        if not self.rehearsal:
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        expect(not dist.is_initialized(),
               "phase 12: a process group is already running")
        t0 = time.perf_counter()
        self._mesh = make_mesh((1,), ("data",), device=self.dev.type)
        backend = dist.get_backend()
        expect(backend == ("gloo" if self.rehearsal else "nccl"),
               f"phase 12: the group's backend is {backend}")
        self.phase12.setdefault("group_s", []).append(
            time.perf_counter() - t0)
        self.phase12.update(backend=backend, nccl_socket_ifname=os.environ.get(
            "NCCL_SOCKET_IFNAME"))
        try:
            yield self._mesh
        finally:
            self.phase12_end()

    def phase12_end(self) -> None:
        import torch.distributed as dist
        if self._mesh is not None and dist.is_initialized():
            dist.destroy_process_group()
        self._mesh = None

    def expect_bits(self, label: str, got, want) -> None:
        for f in want._fields:
            expect(bool(self.torch.equal(getattr(got, f), getattr(want, f))),
                   f"{label}: {f} differs")

    def phase12_deep(self, label: str, forest, ys, q_batch: int, rec: dict,
                     ids, dists) -> dict:
        """12a and 12b on a Deep drive's index, 12d on fp32's: the index
        sharded at world size 1 (its own tensors, no copy); at phase 4's
        final budget ``distributed_knn`` bit-equal to ``knn_search_batch``
        on each of phase 4's batches, exact and at ``approx_p`` 0.9
        (``knn_search_batch_approx``); from n/16 the ladder ends exact
        with phase 4's ids, the tier's filter, fused prune and refine
        launched once a shard-attempt (counts set to 0 just before, read
        just after) and timed; fp32: 11a's requests through a ``mesh=``
        tenant.  The step's group is started and ended around it."""
        t_phase = time.perf_counter()
        with self.phase12_group() as mesh:
            out = self.phase12_search(label, forest, ys, q_batch, rec, ids,
                                      dists, mesh)
        out["seconds"] = time.perf_counter() - t_phase
        self.phase12["seconds"] += out["seconds"]
        return out

    def phase12_search(self, label: str, forest, ys, q_batch: int,
                       rec: dict, ids, dists, mesh) -> dict:
        torch = self.torch
        from repro_torch.core import search as tsearch
        from repro_torch.dist import knn as dk
        quantize = forest.storage == "int8"
        sfx = "_quant" if quantize else ""
        self.sync()
        self.reset_peak()
        t0 = time.perf_counter()
        sharded = dk.shard_index(forest, mesh, device=self.dev.type)
        self.sync()
        out = {"shard_s": time.perf_counter() - t0,
               "shard_is_the_forest": all(
                   getattr(sharded.forest, f).data_ptr()
                   == getattr(forest, f).data_ptr()
                   for f in ("data", "alpha", "alpha_min_pt"))}
        expect(out["shard_is_the_forest"],
               f"{label}: the world-size-1 shard copied the tables")
        fam = forest.family_name
        budget = rec["budget_final"]
        batches = range(0, NUM_QUERIES, q_batch)
        for p in (None, SINGLE_P):
            for s in batches:
                yb = ys[s:s + q_batch]
                got = dk.distributed_knn(sharded, yb, family=fam, k=K,
                                         budget=budget, approx_p=p,
                                         max_doublings=0,
                                         device=self.dev.type)
                want = (tsearch.knn_search_batch(forest, yb, K, budget,
                                                 device=self.dev)
                        if p is None else tsearch.knn_search_batch_approx(
                            forest, yb, K, budget, p, device=self.dev))
                self.expect_bits(f"{label} distributed (p={p}) at budget "
                                 f"{budget}, queries {s}..", got, want)
        out["fixed_budget"] = budget
        out["fixed_peak_bytes"] = self.peak()
        say(f"distributed {label}: world 1 over {self.phase12['backend']}, "
            f"at budget {budget} bit-equal to knn_search_batch on phase 4's "
            f"{NUM_QUERIES} queries (batches of {q_batch}); peak "
            f"{out['fixed_peak_bytes']} B")
        say(f"distributed {label} approx: at p = {SINGLE_P} bit-equal to "
            "knn_search_batch_approx")

        attempts: list = []

        def ladder(hook=None):
            outs = [dk.distributed_knn(sharded, ys[s:s + q_batch],
                                       family=fam, k=K, budget=None,
                                       launch_hook=hook,
                                       device=self.dev.type)
                    for s in batches]
            self.sync()
            return outs

        self.reset_launches()
        self.reset_peak()
        outs = ladder(attempts.append)
        out["launches"] = self.launches()
        out["attempts"] = len(attempts)
        out["ladder_peak_bytes"] = self.peak()
        out["ladder_peak_above_bytes"] = self.peak_above()
        self.expect_launches(f"{label} distributed", out["launches"],
                             RESIDENT_PATH, quantize)
        for kname in RESIDENT_PATH:
            got_n = out["launches"][kname + sfx]
            expect(self.rehearsal or got_n == len(attempts),
                   f"{label} distributed: {kname + sfx} launched {got_n} "
                   f"times in {len(attempts)} shard-attempts")
        got_ids = torch.cat([o.ids for o in outs])
        got_d = torch.cat([o.dists for o in outs])
        expect(all(bool(o.exact.all()) for o in outs),
               f"{label} distributed: the ladder ended inexact")
        expect(bool(torch.equal(got_ids, ids)),
               f"{label} distributed: the ladder's ids differ from phase 4's")
        out["ladder_dists_bit_equal"] = bool(torch.equal(got_d, dists))
        del outs, got_ids, got_d
        # Phase 4's search over the same batches, for its working memory
        # now: the shard holds the index's own tables, so the ladder's
        # must not exceed it beyond its (q, k) exchanges.
        def single():
            outs = [tsearch.knn_batch(forest, ys[s:s + q_batch], K,
                                      device=self.dev) for s in batches]
            self.sync()
            return outs

        self.reset_peak()
        single()
        out["phase4_peak_above_bytes"] = self.peak_above()
        expect(self.rehearsal or out["ladder_peak_above_bytes"]
               <= out["phase4_peak_above_bytes"] + (64 << 20),
               f"{label} distributed: working memory "
               f"{out['ladder_peak_above_bytes']} B against the single "
               f"host's {out['phase4_peak_above_bytes']} B")
        # Host ms in turns with phase 4's search, both ended by a sync.
        out["search_ms"] = self.host_ms(ladder, 3)
        out["single_search_ms"] = self.host_ms(single, 3)
        out["search_ms_again"] = self.host_ms(ladder, 3)
        out["phase4_search_ms"] = rec["search_ms"]
        say(f"distributed {label}: from n/16 the ladder ends exact with "
            f"phase 4's ids (dists bit-equal: "
            f"{out['ladder_dists_bit_equal']}) in {len(attempts)} "
            f"shard-attempts, launches "
            f"{ {k: v for k, v in out['launches'].items() if v} }; "
            f"{out['search_ms']:.1f} and {out['search_ms_again']:.1f} ms "
            f"per {NUM_QUERIES} queries, phase 4's search "
            f"{out['single_search_ms']:.1f} between them ("
            f"{rec['search_ms']:.1f} in phase 4); peak "
            f"{out['ladder_peak_bytes']} B, "
            f"{out['ladder_peak_above_bytes']} B above the index against "
            f"{out['phase4_peak_above_bytes']} B for phase 4's search")
        del sharded
        if not quantize:
            out["service"] = self.phase11_service(label, forest, ys, ids,
                                                  dists, quantize, mesh=mesh)
        return out

    def phase12_mutable(self, label: str, sf, ys, q_batch: int,
                        doomed) -> dict:
        """12c on phase 10's mutated Deep index after its deletes:
        ``shard_index`` of the SegmentedForest (its live count carried)
        bit-equal to ``knn_batch`` at budget live_n, no deleted id."""
        torch = self.torch
        from repro_torch.core import search as tsearch
        from repro_torch.dist import knn as dk
        t_phase = time.perf_counter()
        budget = sf.live_n
        gone = torch.as_tensor(doomed, device=self.dev)
        self.reset_peak()
        with self.phase12_group() as mesh:
            sharded = dk.shard_index(sf, mesh, device=self.dev.type)
            expect(sharded.global_live_n == sf.live_n,
                   f"{label}: the shard's live count is not the index's")
            for s in range(0, NUM_QUERIES, q_batch):
                yb = ys[s:s + q_batch]
                got = dk.distributed_knn(sharded, yb, family=sf.family_name,
                                         k=K, budget=budget,
                                         device=self.dev.type)
                self.expect_bits(
                    f"{label} mutable distributed, queries {s}..", got,
                    tsearch.knn_batch(sf, yb, K, budget=budget,
                                      device=self.dev))
                expect(not bool(torch.isin(got.ids, gone).any()),
                       f"{label} mutable distributed: a deleted id surfaced")
            del sharded, got
        out = {"budget": budget, "peak_bytes": self.peak(),
               "seconds": time.perf_counter() - t_phase}
        self.phase12["seconds"] += out["seconds"]
        say(f"distributed mutable {label}: shard_index(SegmentedForest) "
            f"(live {sf.live_n} of {sf.n} rows) bit-equal to knn_batch at "
            f"budget {budget}, no deleted id; {out['seconds']:.1f} s, peak "
            f"{out['peak_bytes']} B")
        return out

    def phase12_baselines(self, label: str, data, queries, family: str,
                          rec: dict) -> dict:
        """12e: the paper's baselines on the host (numpy, by design) over
        a seeded prefix of Audio's rows, the first SINGLE_QUERIES queries:
        ``linear_scan``, ``BBTree`` with both bounds, ``VAFile``; their
        ids against brute force on the card (phase 3's near-tie rule),
        build s and ms a query, beside a card index over the same rows."""
        torch = self.torch
        import numpy as np
        from repro_torch.core import baselines as bl
        from repro_torch.core import index as tidx
        from repro_torch.core import search as tsearch
        t_phase = time.perf_counter()
        rows = np.ascontiguousarray(data[:BASELINE_ROWS])
        yq = np.ascontiguousarray(queries[:SINGLE_QUERIES])
        ys = torch.as_tensor(yq, device=self.dev)
        x = torch.as_tensor(rows, device=self.dev)
        out = {"rows": int(rows.shape[0]), "of_rows": int(data.shape[0]),
               "queries": int(yq.shape[0]), "methods": {}}
        self.sync()
        t0 = time.perf_counter()
        forest = tidx.build_index(rows, family, m=None, pccp=True,
                                  device=self.dev)
        self.sync()
        card = {"build_s": time.perf_counter() - t0}
        res = tsearch.knn_batch(forest, ys, K, device=self.dev)
        card["ms_per_query"] = self.host_ms(
            lambda: tsearch.knn_batch(forest, ys, K, device=self.dev),
            3) / yq.shape[0]
        card.update(self.check_brute_force(x, ys, res.ids, res.dists,
                                           family))
        card["brute_force_ms_per_query"] = (card.pop("brute_force_ms")
                                            / yq.shape[0])
        out["card_index"] = card
        del forest
        makers = {
            "linear_scan": None,
            "bbtree_geodesic": lambda: bl.BBTree(rows, family, leaf_size=32),
            "bbtree_tuple": lambda: bl.BBTree(rows, family, leaf_size=32,
                                              bound="tuple"),
            "vafile": lambda: bl.VAFile(rows, family, bits=4),
        }
        for name, make in makers.items():
            t0 = time.perf_counter()
            obj = make() if make is not None else None
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            found = [bl.linear_scan(rows, y, K, family) if obj is None
                     else obj.knn(y, K) for y in yq]
            ms = 1e3 * (time.perf_counter() - t0) / yq.shape[0]
            ids = torch.as_tensor(np.stack([f[0] for f in found]),
                                  device=self.dev)
            dists = torch.as_tensor(np.stack([f[1] for f in found]).astype(
                np.float32), device=self.dev)
            m = {"build_s": build_s, "ms_per_query": ms,
                 "distance_evals": [int(f[2]["distance_evals"])
                                    for f in found],
                 "bytes_moved": [float(f[2]["bytes_moved"]) for f in found]}
            if obj is not None and hasattr(obj, "nodes_built"):
                m["nodes_built"] = obj.nodes_built
            m.update(self.check_brute_force(x, ys, ids, dists, family))
            m.pop("brute_force_ms")
            out["methods"][name] = m
        out["seconds"] = time.perf_counter() - t_phase
        self.phase12["seconds"] += out["seconds"]
        say(f"baselines {label}: {out['rows']} of {out['of_rows']} rows (the "
            f"dataset's first rows), {out['queries']} queries, k = {K}: ids "
            "match brute force on the card; card index build "
            f"{card['build_s']:.2f} s, {card['ms_per_query']:.3f} ms a query "
            f"(brute force {card['brute_force_ms_per_query']:.3f}); "
            + "; ".join(f"{k} build {v['build_s']:.2f} s, "
                        f"{v['ms_per_query']:.1f} ms a query, "
                        f"{v['bf_position_mismatches']} near-tie swaps"
                        for k, v in out["methods"].items())
            + f"; {out['seconds']:.1f} s")
        return out

    def run(self) -> dict:
        import os
        from repro_torch.launch import autotune
        t_start = time.perf_counter()
        # Phases 1-10 run without the autotuner table (block_rows=None is
        # 4096 there, as before the table existed); phase 11 turns it on.
        os.environ[autotune.TABLE_ENV] = str(ROOT / "build"
                                             / "no_autotune_table.json")
        self.phase_card_and_build()
        self.phase_ragged()
        for name in ("audio", "deep"):
            self.record[name] = self.drive(name, quantize=False)
            self.record[name + "_int8"] = self.drive(name, quantize=True)
        self.record["blobs"] = self.drive_blobs()
        self.record["single"] = self.single
        say(f"phase 9: {self.single['seconds']:.1f} s")
        self.record["flash"] = self.phase_flash()
        self.record["knnlm"] = self.phase_knnlm()
        self.record["serve_launcher"] = self.phase11_launcher()
        self.record["pccp"] = self.phase_pccp()
        self.record["mutable_seconds"] = sum(
            self.record[key]["mutable"]["seconds"]
            for key in ("audio", "audio_int8", "deep", "deep_int8", "blobs",
                        "knnlm"))
        say(f"phase 10: {self.record['mutable_seconds']:.1f} s")
        self.record["autotune"] = self.phase11_autotune()
        self.record["phase11_seconds"] = self.phase11_s
        say(f"phase 11: {self.phase11_s:.1f} s")
        self.start_dryruns()
        self.record["recurrent"] = self.phase_recurrent()
        self.record["moe"] = self.phase_moe()
        self.record["encdec"] = self.phase_encdec()
        self.record["train"] = self.phase_train()
        self.record["train_families"] = self.phase_train_families()
        self.record["sharded"] = self.phase_sharded()
        self.record["phase12"] = self.phase12
        say(f"phase 12: {self.phase12['seconds']:.1f} s; each step's "
            f"world-size-1 {self.phase12.get('backend')} group started in "
            + ", ".join(f"{t:.3f}" for t in self.phase12.get("group_s", []))
            + " s"
            + ("" if self.rehearsal else " (NCCL_SOCKET_IFNAME="
               f"{self.phase12.get('nccl_socket_ifname')} in this process's "
               "environment)"))
        self.record["dryrun"] = self.phase_dryrun()
        self.record["kernels"] = (self.kernel_table(self.record["deep"])
                                  + self.kernel_table(self.record["deep_int8"])
                                  + self.lm_kernel_table())
        self.record["seconds"] = time.perf_counter() - t_start
        return self.record

    def kernel_table(self, rec: dict) -> list:
        """The kernel JSON rows of one tier's Deep record."""
        fk, rk, pk = (rec["filter_kernels"], rec["refine_kernel"],
                      rec["prune_kernels"])
        src = "src/repro_torch/kernels/csrc/"
        sfx = "_quant" if rec["tier"] == "int8" else ""
        lines = {"bregman_ub_matrix": ("bregman_ub.py:62", "bregman_ub.py:141"),
                 "bregman_filter_prune": ("bregman_fused.py:144",
                                          "bregman_fused.py:235"),
                 "bregman_refine_batch": ("bregman_dist.py:106",
                                          "bregman_dist.py:184"),
                 "bregman_prune_mask": ("bregman_prune.py:110",
                                        "bregman_prune.py:174")}

        def entry(name, source, err, over, ms, plain, bnd, library,
                  launches=None, **extra):
            launches = launches or rec["launches"]
            return {"name": name + sfx, "route": "cuda",
                    "source": src + source,
                    "replaces": "src/repro/kernels/"
                                + lines[name][1 if sfx else 0],
                    "launches": launches[name + sfx],
                    "max_abs_err": err, "max_err_over_tol": over,
                    "ms": ms, "plain_ms": plain,
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "library_ms": library, **extra}

        # #3 and #4 at the grouped search's shape (one attempt's admitted
        # blocks in one launch), #1 and #2 over an attempt's rows, and #5
        # and #6 over an attempt's blocks as the unfused search launches
        # them, each with the 4096-row block beside (and #5/#6 also at the
        # shape of a tiered Stage B window).
        gk = rec["grouped_kernels"]
        f = gk["fp"]
        fp_row = entry(
            "bregman_filter_prune", "bregman_fused.cu",
            max(fk["fp_err"], f["err"]),
            max(fk["fp_err_over_tol"], f["err_over_tol"]), f["ms"],
            f["plain_ms"], f["bound"], None,
            tile_source=src + "filter_span.cuh", shape=f["shape"],
            block_shape=fk["shape"], block_ms=fk["fp"],
            block_plain_ms=fk["fp_plain"], block_bound_ms=fk["fp_bound"][0])
        u = gk["ub"]
        ub_row = entry(
            "bregman_ub_matrix", "bregman_ub.cu", max(fk["ub_err"], u["err"]),
            max(fk["ub_err_over_tol"], u["err_over_tol"]), u["ms"],
            u["plain_ms"], u["bound"], u["library_ms"],
            tile_source=src + "filter_span.cuh", shape=u["shape"],
            block_shape=fk["shape"], block_ms=fk["ub"],
            block_plain_ms=fk["ub_plain"], block_bound_ms=fk["ub_bound"][0],
            block_library_ms=fk["ub_library"])
        # The masks are bit-equal (compare_prune, compare_prune_blocks), so
        # the error is 0.  #5's and #6's launches are those of the unfused
        # search (a group a launch), the tiered cold pass's beside (Stage
        # B, a window a launch), with one window's launch timed.
        tiered = rec["tiered"]["launches"]
        stage_b = rec["tiered"]["stage_b"]
        w = stage_b["window_kernel"]
        p = gk["prune"]
        prune_row = entry(
            "bregman_prune_mask", "bregman_prune.cu", 0.0, 0.0, p["ms"],
            p["plain_ms"], p["bound"], None,
            launches=rec["unfused"]["launches"],
            tile_source=src + "filter_span.cuh", shape=p["shape"],
            launches_tiered=tiered["bregman_prune_mask" + sfx],
            stage_b_windows=stage_b["windows"],
            stage_b_window_shape=w["shape"], stage_b_window_ms=w["ms"],
            stage_b_window_plain_ms=w["plain_ms"],
            stage_b_window_bound_ms=w["bound"][0],
            block_shape=pk["shape"], block_ms=pk["ms"],
            block_plain_ms=pk["plain_ms"], block_bound_ms=pk["bound"][0])
        refine_extra = {"shape": rk["shape"]}
        sass = self.record.get("sass")
        if sfx and sass is not None:
            # 128-bit global loads in the SASS of the int8 refine kernels.
            refine_extra["ldg128_sass"] = sum(
                c for fn, c in sass["ldg128"].items()
                if "refine_quant_kernel" in fn)
        refine_row = entry("bregman_refine_batch", "bregman_dist.cu",
                           rk["err"], rk["err_over_tol"], rk["kernel"],
                           rk["plain"], rk["bound"], None, **refine_extra)
        # Beside them, each kernel of the single-query search (phase 9) at
        # the q = 1 shape one knn_search gives it, and its launches there.
        single = self.record["single"][f"deep {rec['tier']}"]
        for row, name, key in ((ub_row, "bregman_ub_matrix", "ub"),
                               (prune_row, "bregman_prune_mask", "prune"),
                               (refine_row, "bregman_refine_batch",
                                "refine")):
            k1 = single[key]
            row.update(q1_shape=k1["shape"],
                       q1_ms=k1["kernel" if key == "refine" else "ms"],
                       q1_plain_ms=k1["plain" if key == "refine"
                                      else "plain_ms"],
                       q1_bound_ms=k1["bound"][0],
                       q1_bound_by=k1["bound"][1],
                       q1_max_abs_err=k1.get("err", 0.0),
                       q1_max_err_over_tol=k1.get("err_over_tol", 0.0),
                       q1_launches=single["launches"][name + sfx])
            if "library_ms" in k1:
                row["q1_library_ms"] = k1["library_ms"]
        # Their launches on the distributed search's ladder (phase 12a).
        for row in (ub_row, fp_row, refine_row):
            row["launches_distributed"] = rec["phase12"]["launches"][
                row["name"]]
        return [ub_row, fp_row, refine_row, prune_row]


    def lm_kernel_table(self) -> list:
        """The kernel JSON rows of #10 (its bf16 tensor-core kernel at the
        kNN-LM corpus batch's shape and at recurrentgemma-2b's D = 256, its
        launches those of the builds and the serving runs of phases 7, 13
        and 14, also by path and by kernel, with the HGMMA count of the
        built library; beside it, at qwen3-moe-30b-a3b's corpus batch and
        at phase 15's shapes, in bf16 and fp32) and #9 (on the datastore's
        keys, and on recurrentgemma's, qwen3-moe-30b-a3b's, whisper-tiny's
        and qwen2-vl-72b's, its launches the PCCP partitions')."""
        src = "src/repro_torch/kernels/csrc/"
        fl, kn, pc = (self.record["flash"]["corpus_batch"],
                      self.record["knnlm"], self.record["pccp"])
        rc, mo = self.record["recurrent"], self.record["moe"]
        en = self.record["encdec"]
        # Each path's launches, its counts set to 0 just before it: phase
        # 7's build and serving (D = 128), phase 13's (D = 256 on
        # recurrentgemma-2b; rwkv6-1.6b has no attention layer), phase
        # 14's (D = 128, 32 q heads over 4 kv heads), phase 15's (D = 64,
        # whisper-tiny's encoder and decoder; D = 128, 64 q heads over 8
        # kv heads).
        paths = {"knnlm": kn, "recurrentgemma": rc["recurrentgemma"],
                 "rwkv6": rc["rwkv6"], "qwen3_moe": mo["qwen3_moe"],
                 "whisper": en["whisper"], "qwen2_vl": en["qwen2_vl"]}
        by_path = {name: r["build_launches"]["flash_attention"]
                   + r["serve_launches"]["flash_attention"]
                   for name, r in paths.items()}
        by_kernel = {name: sum(r["build_flash_kernels"][name]
                               + r["serve_flash_kernels"][name]
                               for r in paths.values())
                     for name in kn["build_flash_kernels"]}
        # #10 at D = 256, at recurrentgemma-2b's corpus batch (phase 6).
        d256 = {}
        for dt in ("bfloat16", "float32"):
            r = self.record["flash"]["d256"][f"rg_corpus_batch_{dt}"]
            tag = "d256" if dt == "bfloat16" else "d256_fp32"
            d256.update({f"{tag}_shape": r["shape"], f"{tag}_ms": r["ms"],
                         f"{tag}_plain_ms": r["plain_ms"],
                         f"{tag}_bound_ms": r["bound"][0],
                         f"{tag}_bound_by": r["bound"][1],
                         f"{tag}_library_ms": r["library_ms"],
                         f"{tag}_max_abs_err": r["max_abs_err"],
                         f"{tag}_max_err_over_tol": r["max_err_over_tol"]})
        # #10 at qwen3-moe-30b-a3b's corpus batch (phase 6), GQA ratio 8.
        r = self.record["flash"]["moe_corpus_batch"]
        d256.update(gqa8_shape=r["shape"], gqa8_ms=r["ms"],
                    gqa8_plain_ms=r["plain_ms"], gqa8_bound_ms=r["bound"][0],
                    gqa8_bound_by=r["bound"][1],
                    gqa8_library_ms=r["library_ms"],
                    gqa8_max_abs_err=r["max_abs_err"],
                    gqa8_max_err_over_tol=r["max_err_over_tol"],
                    launches_gqa8=by_path["qwen3_moe"])
        # #10 at phase 15's shapes (phase 6), in bf16 and fp32.
        for key, r in self.record["flash"]["phase15"].items():
            d256.update({f"{key}_shape": r["shape"], f"{key}_ms": r["ms"],
                         f"{key}_plain_ms": r["plain_ms"],
                         f"{key}_bound_ms": r["bound"][0],
                         f"{key}_bound_by": r["bound"][1],
                         f"{key}_library_ms": r["library_ms"],
                         f"{key}_max_abs_err": r["max_abs_err"],
                         f"{key}_max_err_over_tol": r["max_err_over_tol"]})
        d256.update(launches_whisper=by_path["whisper"],
                    launches_qwen2_vl=by_path["qwen2_vl"])
        rp, mp = rc["pccp"], mo["pccp"]
        # #9 on phase 15's keys (d = 384 and d = 8192).
        pccp15 = {}
        for tag, r in (("d384", en["whisper_pccp"]),
                       ("d8192", en["qwen2_vl_pccp"])):
            pccp15.update({f"launches_{tag}": r["launches"][
                "pccp_correlation"], f"{tag}_shape": [r["n"], r["d"]],
                f"{tag}_ms": r["ms"], f"{tag}_plain_ms": r["plain_ms"],
                f"{tag}_bound_ms": r["bound"][0],
                f"{tag}_bound_by": r["bound"][1],
                f"{tag}_library_ms": r["library_ms"],
                f"{tag}_max_err_over_tol": r["max_err_over_tol"]})
        sass = self.record.get("sass")
        hgmma = None if sass is None else sass["hgmma"]
        return [
            {"name": "flash_attention", "route": "cuda",
             "source": src + "flash_attention_wgmma.cu",
             "replaces": "src/repro/kernels/flash_attention.py:102",
             "launches": sum(by_path.values()),
             "launches_by_path": by_path,
             "launches_by_kernel": by_kernel,
             "launches_d256": by_path["recurrentgemma"], **d256,
             "hgmma_sass": (None if hgmma is None else
                            sum(c for f, c in hgmma.items()
                                if "flash_tc_kernel" in f)),
             "max_abs_err": fl["max_abs_err"],
             "max_err_over_tol": fl["max_err_over_tol"],
             "ms": fl["ms"], "plain_ms": fl["plain_ms"],
             "bound_ms": fl["bound"][0], "bound_by": fl["bound"][1],
             "library_ms": fl["library_ms"]},
            {"name": "pccp_correlation", "route": "cuda",
             "source": src + "pccp_corr.cu",
             "replaces": "src/repro/kernels/pccp_corr.py:52",
             "launches": pc["launches"]["pccp_correlation"],
             "max_abs_err": pc["max_abs_err"],
             "max_err_over_tol": pc["max_err_over_tol"],
             "ms": pc["ms"], "plain_ms": pc["plain_ms"],
             "bound_ms": pc["bound"][0], "bound_by": pc["bound"][1],
             "library_ms": pc["library_ms"],
             # On recurrentgemma-2b's keys (phase 13).
             "launches_recurrent": rp["launches"]["pccp_correlation"],
             "d2560_shape": [rp["n"], rp["d"]], "d2560_ms": rp["ms"],
             "d2560_plain_ms": rp["plain_ms"],
             "d2560_bound_ms": rp["bound"][0],
             "d2560_library_ms": rp["library_ms"],
             "d2560_max_err_over_tol": rp["max_err_over_tol"],
             # On qwen3-moe-30b-a3b's keys (phase 14).
             "launches_moe": mp["launches"]["pccp_correlation"],
             "d2048_shape": [mp["n"], mp["d"]], "d2048_ms": mp["ms"],
             "d2048_plain_ms": mp["plain_ms"],
             "d2048_bound_ms": mp["bound"][0],
             "d2048_library_ms": mp["library_ms"],
             "d2048_max_err_over_tol": mp["max_err_over_tol"],
             **pccp15},
        ]


@contextlib.contextmanager
def swapped(module, name: str, value):
    """The module attribute ``name`` (a byte cap, a function) set to
    ``value`` within the block, restored after it."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def moe_bmm_bounds(cfg, shape, sizes: dict) -> tuple:
    """(least, most) ``bmm`` FLOPs a device in a dry-run cell of the MoE
    config ``cfg`` on a ("data", "model") mesh of ``sizes``, its experts
    split over ``model``: every layer's expert products on its E / model
    experts' slots and its combine, four times in training (the forward,
    its recompute in the backward, two products back); at most that plus
    every attention einsum taken dense (a prefill's attention is #10,
    counted apart).  Experts gathered whole count ``model`` times the
    products, above the most."""
    from repro_torch.models import moe
    m, model = cfg.moe, sizes["model"]
    s = 1 if shape.kind == "decode" else shape.seq_len
    rows = shape.global_batch // sizes["data"]
    sp = moe._group_size(shape.global_batch * s, m.group_tokens)
    # a group that would span two data ranks' rows: every rank runs all
    tokens = rows * s if (rows * s) % sp == 0 else shape.global_batch * s
    slots = (tokens // sp) * moe._capacity(m, sp) * (m.num_experts // model)
    layer = (3 * 2 * slots * cfg.d_model * cfg.moe_d_ff
             + 2 * tokens * m.top_k * cfg.d_model)
    times = (4 if shape.kind == "train" else 1) * cfg.num_layers
    heads = (cfg.num_heads // model if cfg.num_heads % model == 0
             else cfg.num_heads)
    attn = (0 if shape.kind == "prefill" else
            2 * 2 * rows * heads * s * shape.seq_len * cfg.head_dim)
    return times * layer, times * (layer + attn)


@contextlib.contextmanager
def routes_logged(torch, moe, forced=None):
    """Every ``moe.route`` call within the block, logged in order: the
    experts chosen (G, S, K) and their weights, each token's gap between
    its K-th and (K+1)-th router probability, and ``moe.assign_slots``'
    kept mask.  With
    ``forced`` (one id tensor a call, in order) each call takes those
    experts in place of its own top-k, weighted by its own probabilities
    (renormalized as ``route`` does) and ordered by them as ``route``
    orders its own: a replay of another run's routes, bit-equal to the
    call's own where the sets agree.
    The block yields the log; a model without MoE leaves it empty."""
    log, calls = [], None if forced is None else iter(forced)
    route, assign = moe.route, moe.assign_slots

    def logged_route(logits, cfg):
        w, ids, aux = route(logits, cfg)
        probs = torch.softmax(logits.float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        k = cfg.top_k
        gap = (top[..., k - 1] - top[..., k] if top.shape[-1] > k
               else top[..., k - 1])
        if calls is not None:
            ids = torch.sort(next(calls).to(logits.device), -1).values
            w, order = torch.sort(probs.gather(-1, ids), dim=-1,
                                  descending=True, stable=True)
            ids = ids.gather(-1, order)
            if cfg.router_softmax_order == "topk_then_softmax":
                w = w / torch.sum(w, dim=-1, keepdim=True)
        log.append({"ids": ids, "w": w, "gap": gap})
        return w, ids, aux

    def logged_assign(top_w, top_i, cfg):
        slot, keep = assign(top_w, top_i, cfg)
        log[-1]["keep"] = keep
        return slot, keep

    moe.route, moe.assign_slots = logged_route, logged_assign
    try:
        yield log
    finally:
        moe.route, moe.assign_slots = route, assign


def compare_routes(torch, got: list, want: list) -> dict:
    """Two runs' route logs, call by call (a layer a call): the tokens whose
    expert sets differ, the first call with such a token, and whether every
    such token of that call sits at a near tie in ``want`` (its K-th and
    (K+1)-th probabilities within ROUTE_NEAR_TIE).  Later calls' flips
    follow from the first's (the flipped token's output, its group's
    drops), so only the first call's gaps decide."""
    flipped, first, gaps, near = 0, None, [], True
    for call, (g, w) in enumerate(zip(got, want, strict=True)):
        differs = (torch.sort(g["ids"], -1).values
                   != torch.sort(w["ids"], -1).values).any(-1)
        count = int(differs.sum())
        flipped += count
        if count and first is None:
            first = call
            gaps = w["gap"][differs].tolist()
            near = max(gaps) <= ROUTE_NEAR_TIE
    return {"calls": len(got), "flipped_tokens": flipped,
            "first_flip_call": first, "first_flip_gaps": gaps[:16],
            "first_flip_near_ties": near,
            "min_gap": min((float(w["gap"].min()) for w in want),
                           default=None)}


def pccp_first_divergence(np, corr_a, corr_b, m: int, seed: int):
    """The first choice at which ``pccp_order``'s greedy over ``corr_a``
    and over ``corr_b`` part, run in lockstep (its random first dims
    agree while the unassigned sets do): None where the orders are equal,
    else (the group, the dim ``corr_a`` adds, the dim ``corr_b`` adds)."""
    rng = np.random.default_rng(seed)
    unassigned = set(range(corr_a.shape[0]))
    while unassigned:
        first = int(rng.choice(sorted(unassigned)))
        group = [first]
        unassigned.discard(first)
        while len(group) < m and unassigned:
            cand = np.fromiter(unassigned, dtype=np.int64)
            a, b = (int(cand[int(np.argmax(c[np.ix_(group, cand)]
                                           .max(axis=0)))])
                    for c in (corr_a, corr_b))
            if a != b:
                return group, a, b
            group.append(a)
            unassigned.discard(a)
    return None


def middle_tile(skv: int, tile: int) -> range:
    """The kv positions of #10's ``tile``-key kv tile (``FLASH_KV_TILE`` of
    the kernel under test) at the middle of ``skv`` keys (half the keys
    from the middle on when there are fewer than twice ``tile``)."""
    width = min(tile, skv // 2)
    start = skv // 2 // width * width
    return range(start, start + width)


def attention_dropping(torch, q, k, v, causal: bool, drop: range,
                       window: int | None = None):
    """fp32 GQA attention, queries end-aligned, within an optional sliding
    ``window``, with the keys at positions ``drop`` masked out: what a
    kernel that skipped that kv tile would give.  q (B, H, Sq, D); k/v (B,
    KH, Skv, D)."""
    sq, d = q.shape[2], q.shape[3]
    skv, rep = k.shape[2], q.shape[1] // k.shape[1]
    k = k.float().repeat_interleave(rep, 1)
    v = v.float().repeat_interleave(rep, 1)
    s = (q.float() @ k.transpose(-1, -2)) * d ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    keep = ((kpos < drop.start) | (kpos >= drop.stop)) & (
        kpos <= qpos if causal else True)
    if window is not None:
        keep &= qpos - kpos < window
    s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, -1) @ v


def sass_counts(lib) -> dict | None:
    """Instructions of two kinds in the SASS of each function of the built
    library, from ``cuobjdump -sass``: ``hgmma`` (wgmma) and ``ldg128``
    (128-bit global loads), each by function for the functions that hold
    any; None where cuobjdump is missing."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {"hgmma": {}, "ldg128": {}}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            continue
        op = line.split("*/", 1)[-1].split()
        op = next((w for w in op if w[:1].isupper()), "")
        for kind, hit in (("hgmma", op.startswith("HGMMA")),
                          ("ldg128", op.startswith("LDG")
                           and ".128" in op)):
            if fn and hit:
                counts[kind][fn] = counts[kind].get(fn, 0) + 1
    return counts


def device_events(torch, prof) -> list:
    """The profiler's averaged device-side events: kernels, copies and
    sets (not the host operators that launched them, whose device time
    would count the same kernels twice)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("Command Buffer Full")]


# The prune-only kernels' names in a profiler trace: filter_span.cuh's
# instances with PRUNE true and UB false, fp32 (#5) and int8 (#6).
PRUNE_ONLY_KERNEL = re.compile(
    r"filter_span_kernel<(?:float|signed char), true, false,")

# The kernels each path launches (the tier's variant of each).
RESIDENT_PATH = ("bregman_ub_matrix", "bregman_filter_prune",
                 "bregman_refine_batch")
UNFUSED_PATH = ("bregman_ub_matrix", "bregman_prune_mask",
                "bregman_refine_batch")
TIERED_PATH = UNFUSED_PATH


def cold_bytes(forest) -> int:
    """Bytes of the forest's cold tier (the tables a TieredPointStore
    keeps in host memory)."""
    from repro_torch.core.index import cold_point_fields
    return sum(getattr(forest, f).numel() * getattr(forest, f).element_size()
               for f in cold_point_fields(forest))


def forest_device_bytes(forest) -> int:
    """Bytes of every tensor of a forest that holds memory (the meta
    tensors standing in for a store's cold tables hold none)."""
    return sum(v.numel() * v.element_size() for v in vars(forest).values()
               if hasattr(v, "numel") and v.device.type != "meta")


def overlap(spans: list, others: list) -> float:
    """The total length of ``spans`` (intervals) covered by the union of
    ``others``."""
    merged = []
    for a, b in sorted(others):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = 0.0
    for a, b in spans:
        for c, e in merged:
            total += max(0.0, min(b, e) - max(a, c))
    return total


def table_bytes(forest) -> dict:
    """Bytes on the device of the forest's (n, d) point table and of its
    four (n, M) stat tables, each with its per-row decode in the int8
    tier."""
    def size(*names):
        return sum(getattr(forest, f).numel() * getattr(forest, f)
                   .element_size() for f in names
                   if getattr(forest, f) is not None)
    return {"points": size("data", "data_scale", "data_zp"),
            "stats": size("alpha", "sqrt_gamma", "alpha_min_pt",
                          "sqrt_gamma_max_pt", "alpha_scale", "alpha_zp",
                          "sg_scale", "sg_zp", "amin_scale", "amin_zp",
                          "gmax_scale", "gmax_zp")}


def err_over_tol(diff, tol) -> float:
    """The largest |kernel - plain| as a share of its element's tolerance
    (<= 1 where the kernel agrees)."""
    if not diff.numel():
        return 0.0
    return float((diff / tol).masked_fill(diff == 0, 0.0).max())


def attended(sq: int, skv: int, causal: bool, window) -> tuple:
    """(query-key pairs a head attends, keys any query attends) for
    ``sq`` queries end-aligned to ``skv`` keys: the work #10 must do,
    whatever tiles it skips (``kernels.flash_attention.attended``, the
    closed form the dry run's cost count uses too)."""
    from repro_torch.kernels.flash_attention import attended as pairs_of
    return pairs_of(sq, skv, causal, window)


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S
          ) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take,
    its operations at ``ops_per_s`` (fp32 outside the tensor cores unless
    given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def refine_tolerance(torch, rows, grad, c_y, family: str, d: int):
    """The refine form ``sum phi(x) - x.grad + c_y`` cancels badly (the
    exponential family most), so its error scales with the size of the
    terms, not of the result: d * eps32 times
    ``sum |phi(x)| + |x . grad| + |c_y|`` per (query, row).  ``rows``
    yields each query's (b, d) fp32 rows (the decoded rows in the int8
    tier), one query at a time, so the temporaries stay (b, d)."""
    from repro_torch.kernels.ref import PHIS
    scale = torch.stack([
        PHIS[family](x).abs().sum(-1) + (x @ g).abs() + cy.abs()
        for x, g, cy in zip(rows, grad, c_y, strict=True)])
    return d * EPS32 * scale


def ub_term_scale(torch, filt, qc, sd):
    """The magnitudes of the UB's summed terms, (n, q): fp32 ``(alpha,
    sg)`` gives sum |alpha| + sum |qconst| + sg . sd; int8 ``(codes, scale,
    zp)`` pairs give |a_s * sum(codes)| + |M * a_z| + |qsum| + |g_s| *
    (|codes| . sd) + |g_z * sum(sd)|, the dot's terms by magnitude, since
    signed codes may cancel."""
    if len(filt) == 2:
        a, sg = filt
        return (a.abs().sum(-1)[:, None] + qc.abs().sum(-1)[None, :]
                + sg @ sd.T)
    a_q, a_s, a_z, g_q, g_s, g_z = filt
    m = a_q.shape[1]
    return (((a_s * a_q.float().sum(-1)).abs() + (m * a_z).abs())[:, None]
            + qc.sum(-1).abs()[None, :]
            + g_s.abs()[:, None] * (g_q.float().abs() @ sd.T)
            + (g_z[:, None] * sd.sum(-1)[None, :]).abs())


def positive_or_not(torch, shape, fam, gen):
    """Valid fp32 data for a family: |N(0,1)| + 0.05 where the domain is
    positive, N(0,1) clipped to [-4, 4] otherwise."""
    raw = torch.randn(shape, generator=gen)
    if fam.domain_low == 0.0:
        return raw.abs() + 0.05
    return raw.clamp(-4.0, 4.0)


def quant_table(torch, n, m, gen, nonneg=False):
    """Int8 codes (n, m) reaching -128 and 127 with a per-row (scale, zp);
    row 1 is a constant row (scale 0, codes 0).  ``nonneg`` keeps the
    decoded values at or above 0 (a sqrt_gamma table)."""
    codes = torch.randint(-128, 128, (n, m), generator=gen,
                          dtype=torch.int32).to(torch.int8)
    codes[0, 0], codes[-1, -1] = -128, 127
    scale = torch.rand(n, generator=gen) * 0.1 + 1e-3
    zp = torch.randn(n, generator=gen)
    if n > 1:
        codes[1], scale[1] = 0, 0.0
    if nonneg:
        zp = zp.abs() + 128.0 * scale
    return codes, scale, zp


def filter_inputs_quant(torch, n, m, q, seed, tie_row=0):
    """The int8 kernels' operands: four code tables with their decode, then
    qc, sd, qb; the admit mask is mixed, and row ``tie_row``'s decoded
    lower bound ties its bound exactly in subspace 0."""
    from repro_torch.core.quantize import dequantize_stats
    gen = torch.Generator().manual_seed(seed)
    tables = [t for i in range(4)
              for t in quant_table(torch, n, m, gen, nonneg=i in (1, 3))]
    qc = torch.randn((q, m), generator=gen)
    sd = torch.randn((q, m), generator=gen).abs()
    amin = dequantize_stats(*tables[6:9])
    gmax = dequantize_stats(*tables[9:12])
    lb = (amin[:, :, None] + qc.T[None]) - gmax[:, :, None] * sd.T[None]
    qb = torch.quantile(lb, 1.0 - 0.5 ** (1.0 / m), dim=0).T.contiguous()
    qb[:, 0] = lb[tie_row, 0, :]
    return (*tables, qc, sd, qb)


def unaligned(torch, t):
    """A contiguous copy of ``t`` whose data starts one byte past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def same_bits(torch, a, b) -> bool:
    """fp32 tensors equal as int32 words."""
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def filter_inputs(torch, n, m, q, seed):
    """Filter and corner tables whose admit mask is mixed, with row 0
    tying its bound exactly in subspace 0 (so ``<=`` decides it)."""
    gen = torch.Generator().manual_seed(seed)
    alpha = torch.randn((n, m), generator=gen)
    sg = torch.randn((n, m), generator=gen).abs()
    amin = torch.randn((n, m), generator=gen)
    gmax = torch.randn((n, m), generator=gen).abs()
    qc = torch.randn((q, m), generator=gen)
    sd = torch.randn((q, m), generator=gen).abs()
    lb = (amin[:, :, None] + qc.T[None]) - gmax[:, :, None] * sd.T[None]
    qb = torch.quantile(lb, 1.0 - 0.5 ** (1.0 / m), dim=0).T.contiguous()
    qb[:, 0] = lb[0, 0, :]
    return alpha, sg, amin, gmax, qc, sd, qb


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="with no CUDA card: run every phase at a tiny "
                             "size on the CPU with the plain versions")
    parser.add_argument("--rehearsal-n", type=int, default=900,
                        help="points per dataset in a CPU rehearsal")
    parser.add_argument("--out", default=str(ROOT / "build"
                                             / "chip_smoke.json"),
                        help="where to write the full record as JSON")
    args = parser.parse_args(argv)
    if not PACKAGE.is_dir():
        print(f"chip_smoke.py: {PACKAGE} is missing: run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() and not args.cpu_rehearsal:
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smoke = Smoke(args, torch)
    try:
        record = smoke.run()
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        smoke.phase12_end()
        smoke.stop_dryruns()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1, default=str))
    say(f"record: {out} ({record['seconds']:.1f} s)")
    if smoke.rehearsal:
        say(json.dumps({"kernels": record["kernels"]}))
        say(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0
    say(record["nvidia_smi"])
    say(json.dumps({"kernels": record["kernels"]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
