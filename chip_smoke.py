"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs
sixteen phases, printing one JSON line each; any failed check raises, so
the script exits non-zero:

1. ``device``     the card's name and power limit (``nvidia-smi``).
2. ``kernels``    each hand-written kernel against its plain PyTorch version
                  on the card, at the shapes the main path gives it, timed
                  with CUDA events (cold L2) beside its bound: A, B (words,
                  and apart its margins mode; also on one 50-query chunk,
                  and its words for 64 rows equal whether hashed in one
                  launch, one row per launch, in launches of 50 or through
                  either path), C and D on one grid cell's shapes (C also
                  at k = 40, at 50 x 16,384 x 30 and, with its workspace
                  spilled to device memory, at 50 x 49,152 x 30 for k = 10
                  and 40, and its distances equal to D's bits on the same
                  compacted rows), and E (the payload tail, f16 and i8) on the first
                  50-query chunk of a single shard over every point, at the
                  path's c_comp and with a forced overflow (c_comp=64). A
                  and D also
                  at every shape the DSLSH paths give them (D's hash
                  form at the ``routes`` phase's two wide shapes too)
                  (``path_shapes``, with the profiler's device time, its
                  kernels per call and the host's time per call), and
                  D's one-order check: each query
                  of a 50-query chunk, alone and in launches of 7, gets
                  the chunk's bits.
3. ``main_path``  the paper's scale: 1,370,000 synthetic ABP windows (d=30)
                  on the 40-cell ``grid(nu=10, p=4)`` with the ``"cuda"``
                  backend, 2000 out-of-sample queries, DSLSH against the
                  exhaustive PKNN baseline (MCC, comparisons, speedup).
   ``query_profile`` a profiled 200-query grid query: wall time, summed
                  kernel time on the card and the device's idle share.
4. ``multiprobe`` a single-shard index with ``multiprobe=2``, so the
                  words+margins kernel runs on the query path.
   ``routes``     four configurations the ``"cuda"`` backend once refused,
                  on the same 131,072-point single shard and 500 queries:
                  k = 40 (D sorts the block's keys; i8 with c_rerank=64), a
                  merge width of 32,768 (at k = 10 and 40) and D's shared
                  memory over budget (these three in D's hash form: E's
                  hash-set dedup, then D's L1 and top-k, in one launch).
                  Each as f32 against the ``"torch"`` backend and as i8
                  against the payload tail's plain version chunk by chunk;
                  every chunk one launch of D (or E), in the form the shape
                  calls for, and no plain version.
5. ``backends_agree`` the ``"torch"`` backend on the card answers the first
                  256 queries as the ``"cuda"`` backend does.
6. ``payload``    the compressed-payload path: ``single()`` over all
                  1,370,000 windows with ``c_rerank=32``, built and queried
                  (the same 2000 queries) as f32, f16 and i8 in turn; one
                  payload-tail launch per 50-query chunk, every query with
                  no rerank miss equal to the f32 shard's answer, and each
                  compressed MCC within 0.01 of the f32 shard's.
   ``payload_profile`` per format, a profiled 200-query single-shard query,
                  as ``query_profile``.
7. ``quickstart`` ``examples/torch_quickstart.main`` at the example's size (8
                  records x 60,000 beats from ``repro_torch.data.abp``,
                  ``grid(nu=2, p=8)``): MCC within 0.1 of PKNN's.
8. ``routed``     the main path's grid through ``with_routing()`` (its
                  2,000 answers equal the broadcast ones in ``knn_idx``,
                  comparisons and overflow), then a ``replication=2``
                  build queried with ``max_cells=8`` against the
                  ``"torch"`` backend on the same plan (256 queries).
   ``icu_serve``  the ICU service under failure and load on that grid:
                  ``with_routing(replication=2)`` in an ``ElasticIndex``
                  and an ``ElasticController``, behind a ``ServeFrontend``
                  (ladder 8/32/128/512, two degradation levels, tenants
                  ``bedside``, ``ward`` and a quota-limited ``burst``);
                  after ``warmup()`` about 1,100 query rows in four stages
                  on a simulated clock: healthy, one replica down
                  (failover), a whole node down (lost cells, flagged), and
                  ticks until the controller restores the node's cells and
                  migrates (save → load → replan → swap), then healthy.
                  Every undegraded response equals a direct query of its
                  rows bit for bit, the loaded index answers as the
                  healthy one, the request ledger balances, no kernel
                  library is built after warmup, and D launches once per
                  cell and 50-query chunk of every micro-batch.
   ``icu_serve_profile`` one 96-row micro-batch profiled.
   ``mesh``       the paper's 40 processors as 40 SPMD ranks over
                  ``torch.distributed`` (gloo; one process and CUDA context
                  a rank on this card, started by ``launch.mesh.spawn`` after
                  the kernels are built): ``make_local_mesh(10, 4)`` on the
                  main path's data (a memory-mapped ``.npy``), family and
                  config, each rank building and querying its own cell with
                  A, B and D; the 2,000 queries with the all-gather Reducer
                  and the tree, ``save`` from the mesh, ``load(device_mesh=)``
                  and the queries again. Checks: every rank the same family
                  and answer; counters equal to ``main_path``'s grid, top-k
                  tie-aware; the tree and the reload equal the all-gather bit
                  for bit; the ranks' launches of the build and of each query
                  pass sum to ``main_path``'s. Then ``mesh_replicated``: an
                  8-rank ``make_replicated_mesh(2, 2, 2)``, routed, tree
                  Reducer, on the ``routes`` shard: routed, with node 1
                  dropped and with ``max_cells=2``, each equal to the
                  in-process routed ``grid(2, 2)`` bit for bit.
9. ``stream``     the paper-scale streaming deployment: ``streaming(nu=10,
                  p=4, node_capacity=139,048, delta_cap=256)`` warmed on the
                  1,370,000 windows, then a ``StreamingMonitor`` streams
                  4,096 more in batches of 16. Checks: after the 8th event
                  and after the last, 256 queries agree between the
                  ``"cuda"`` and ``"torch"`` backends and with an unrouted
                  clone; after ``compact`` node 0's cells equal a scratch
                  build; A, B and D launch; every node compacts; the
                  rolling MCC within 0.1 of PKNN's on the live windows.
   ``stream_profile`` the last 8 events profiled: the device idle share.
10. ``knn_lm``    the kNN-LM serving path of examples/serve_knn_lm.py
                  steps 2-3 at granite-8b's full width and depth (36 layers,
                  d_model 4,096, weights from a seeded generator): kernel F
                  (flash attention) first against its plain version at the
                  path's five shapes, two at nemotron-4-340b's heads and
                  one at hymba-1.5b's sliding-window prefill with its 128
                  meta tokens as attention sinks (``sink``);
                  then a datastore of 65,536 hidden
                  states (64 sequences in chunks of 8), DSLSH over it on
                  ``grid(nu=2, p=4)`` with the ``"cuda"`` backend, and 4
                  requests (128-token prompts, 8 new tokens) served with
                  lmbda 0 and 0.3 through the kNN-LM hook. Checks: at least
                  36 flash launches per forward pass, the model with F
                  against the same model with the plain attention (logits
                  and greedy tokens), the logit gate against faults planted
                  in F, the hook on every call against
                  ``knn_interpolate`` on the index's and on the ``"torch"``
                  backend's neighbours, and kernels A and B
                  at d = 4,096 (the datastore's keys; B also on the hook's
                  one row, with its one-order check over both of its
                  paths) and d = 18,432 against their plain versions;
                  A and D at the path's shapes on one cell of the
                  datastore (the hook's row and query, a build chunk, a
                  50-query chunk, D's one-order check at d = 4,096).
                  Kernels A's, B's and D's calls on the main and kNN-LM
                  paths are counted by shape.
   ``knn_lm_profile`` one request served with the hook, profiled.
11. ``serve``     ``repro_torch.launch.serve.main --arch granite-8b`` with
                  its defaults: 4 requests through ``ServeEngine`` on the
                  card.
12. ``serve_twin`` ``examples/torch_serve_knn_lm.main`` with its ``"cuda"``
                  backend: trains the serve-demo LM (120 steps), builds
                  the DSLSH datastore over its hidden states on
                  ``grid(nu=2, p=4)`` and serves 6 requests with lmbda 0
                  and 0.3. Checks: the loss falls, A, B, D and F launch,
                  the hook's output equals ``knn_interpolate`` on the
                  index's and the ``"torch"`` backend's answers.
13. ``families``  the moe, ssm and hybrid families served whole: olmoe-1b-7b
                  (64 experts, top-8), mamba2-780m and hymba-1.5b at their
                  FULL widths and depths (hymba at 16 of 32 layers, the
                  script's time) with seeded weights, B = 2 prompts
                  of 512, 1,000 and 1,920 tokens, 8 greedy decode steps;
                  then qwen3-32b whole (32.8 B parameters, 65.5 GB in
                  bf16, drawn on the card leaf by leaf), 2 x 512.
                  Checks: kernel F launched per prefill and decode step as
                  each family's attention calls it (16 a pass for olmoe, 32
                  a prefill and 3 a decode step for hymba, none for
                  mamba2, 64 a pass for qwen3) and no other kernel; the
                  logit gate on olmoe, hymba and qwen3 with its planted
                  faults (``fault_sink`` on hymba, the qk-norm skipped on k
                  and F reading the neighbouring KV group on qwen3);
                  decode after ``prefill(s)`` against ``prefill(s + 1)`` on
                  mamba2 and hymba; ``ssd_chunked`` against ``ssd_reference``
                  at mamba2's dims; then ``launch.serve`` for each family.
14. ``train``     LM training at hubert-xlarge's FULL size (48 layers,
                  d_model 1280, 0.95 B parameters, no cut) through
                  ``launch.train``'s step and audio batches (8 x 1,024
                  frames, 30 % masked): step 0's loss and every leaf's
                  gradient against a plain path (no remat, one attention
                  block, whole logits, ``F.cross_entropy``) on 2 rows;
                  3 timed steps of float32 AdamW with remat "dots" (loss,
                  grad_norm, lr, ms each; median ms, frames per second,
                  peak memory; every leaf moves after the first update);
                  ``train_profile``: the step split into loss-and-gradients
                  and update (each timed alone, median of 3), then 2 steps
                  profiled (the device's idle share). Then kernel F
                  refusing a q that requires gradients, two AdamW updates of ``layers/wq`` on the
                  card against the CPU (32- and 8-bit moments), and
                  ``ft.simulate_training_failure_and_restart`` at
                  granite's smoke config under deterministic algorithms,
                  bit for bit against an uninterrupted run.
15. ``families_train`` the moe, ssm and hybrid families trained at FULL
                  width: olmoe-1b-7b (bf16 masters and 8-bit moments, the
                  stated cut: float32 state would be about 110 GB),
                  mamba2-780m at 24 of 48 layers and hymba-1.5b at 8 of 32
                  (the script's time; float32 AdamW, remat "full",
                  hymba's two microbatches), 4 x 512, 4 x 1,024 and 2 x 512
                  tokens. Checks: step 0's loss and every gradient finite
                  and within tolerance of a plain path (one attention
                  block, whole logits; ``ssd_reference`` for mamba2 and
                  hymba on a 256-token prefix), olmoe's gradients equal on
                  two calls; 2 timed steps, mamba2's and hymba's 1, the
                  last profiled (``families_train_profile``; every leaf
                  moves but bf16 norm weights under half an ulp, the loss
                  finite; median ms, tokens per second, peak memory); the
                  trained masters served
                  through ``serving``: prefill and 4 decode steps, F's
                  launches as ``flash_per_pass`` says, the logit gate;
                  then the restart at olmoe's smoke config under
                  deterministic algorithms, bit for bit.
16. ``lm_mesh``   the LM families under a mesh: 4 gloo ranks on this card
                  (``launch.mesh.spawn`` running ``launch.lm_mesh_job``).
                  phi3.5-moe-42b-a6.6b at full width cut to 8 of 32
                  layers, served on ``make_local_mesh(1, 4)`` (its experts
                  over 4 ranks, the cache's positions in 4 blocks) with
                  both combines, ``gather`` at capacity 1.25 and ``a2a`` at
                  8.0: prefill of 2 x 512 and 8 decode steps against the
                  same model in this process, route by route (moe's routes
                  recorded on both sides: a row whose read token routes
                  alike within logit_gate's tolerance, a flip owed to a
                  near tie, greedy tokens where the top-2 gap exceeds the
                  tolerance, every rank alike, F once a layer in each
                  rank's prefill), and five planted faults the check must
                  catch. Every rank holds its rows and block of positions
                  of the stream between blocks and its block of the
                  vocabulary (the lookup, the logits and the loss).
                  granite-8b whole, tensor-parallel on 1 x 4, 4 decode
                  steps, each handing gloo under 10 MB a rank. In the same
                  world olmoe-1b-7b at full width cut
                  to 4 of 16 layers (bf16 masters, 8-bit moments, capacity
                  8.0, ``gather``) trained on ``make_local_mesh(2, 2)``
                  through ``launch.train.train``: the step-0 loss and every
                  rank's reduced gradients against this process's (the
                  ``families_train`` rule), one step, the replicas bit for
                  bit, the expert blocks' moments against this process's;
                  granite-8b cut to 2 layers trained on 2 x 2.
                  mamba2-780m and hymba-1.5b whole on 1 x 4 (2 prompts of
                  1,000 and 1,024 tokens, 8 decode steps), pass by pass
                  within logit_gate's tolerance of this process's, with
                  two planted faults each (a rank's SSM state or conv tail
                  block reset at each decode step, hymba's first block of
                  positions, the meta tokens', shifted by one); trained on
                  2 x 2 (mamba2 whole, hymba cut to 8 layers) with float32
                  masters: the step-0 rule, the replicas, held bytes, and
                  ``keep_block``'s backward as a plain slice read. A
                  planted fault counts as caught only on a row-pass that
                  is not excused as a near-tied route flip. The
                  ``lm_mesh_cases`` line gives each case's gloo bytes a
                  rank a prefill, a decode step and a train step, the
                  stream's bytes a rank, peak memory and the slowest
                  rank's times.

The ``kernels`` line comes last but two, then the ``nvidia-smi`` line, and
the last line is ``{"ok": true, "device": {...}}``. A kernel's ``launches``
counts the path it belongs to: the main path for A, B and D (C, the
staged form's distance stage, is on no path of the ``"cuda"`` backend and
counts 0 there), the payload phase's two compressed
queries for E, the ``knn_lm`` phase for F; every row also gives its
launches on the ``routes``, ``quickstart``, ``routed``, ``icu_serve``, ``stream``,
``knn_lm``, ``serve``, ``serve_twin``, ``families``, ``train`` and ``families_train``
paths (no kernel runs on a training step, as none does on the JAX
package's; ``families_train`` counts F in the trained masters' serving), A, B and D their launches summed over the
``mesh`` phase's ranks (``mesh_launches``), and every kernel its launches
summed over the ``lm_mesh`` phase's ranks (``lm_mesh_launches``: F's, 0
for A-E). Without a CUDA
device, or without the repository's ``src/`` beside it, the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
RTOL = ATOL = 1e-5  # distances: the kernels sum over d in another order
# the port's kernels by their CUDA function names (csrc/*.cu), whose share of
# a profiled window's device time the profiles report
PORT_KERNELS = ("bitsample_pack_kernel", "proj_sign_batch_kernel", "proj_sign_few_kernel", "l1_topk_kernel",
                "query_tail_kernel", "query_tail_hash_kernel", "query_tail_payload_kernel",
                "flash_attention_kernel")

# the paper-scale configuration of benchmarks/scale_bench.py and
# benchmarks/common.py (slsh_cfg)
CFG = dict(
    m_out=32, L_out=16, m_in=12, L_in=4, alpha=0.005, k=10,
    val_lo=20.0, val_hi=180.0, c_max=256, c_in=16, h_max=16, p_max=512,
    build_chunk=4096, query_chunk=50,
)
N, NQ, NU, P, SEED = 1_370_000, 2_000, 10, 4, 0
C_RERANK = 32  # the payload shortlist of benchmarks/scale_bench.py:48
# the routes phase: configurations SLSHConfig accepts that the "cuda" backend
# once refused, each with the form of kernel D its chunks must take (the
# fused form's k > 32 sort, or the hash form: a merge width of 32,768, and
# the fused form's shared memory over budget at 16,384 compacted columns),
# and the i8 query's extra settings
ROUTE_CASES = {
    "k40": dict(k=40),
    "merge_width_32768": dict(L_out=16, c_max=512, multiprobe=2),
    "merge_width_32768_k40": dict(L_out=16, c_max=512, multiprobe=2, k=40),
    "d_over_shared_memory": dict(multiprobe=1, c_max=512, c_comp=0),
}
ROUTE_EXPECTED = {"k40": "fused", "merge_width_32768": "hash", "merge_width_32768_k40": "hash",
                  "d_over_shared_memory": "hash"}
ROUTE_I8 = {"k40": dict(c_rerank=64), "merge_width_32768_k40": dict(c_rerank=64)}
# kernel C's widest block: every compacted column of a 49,152-column row
# (c_comp=0), past what its workspace holds in shared memory
C_SPILL_CASE = dict(L_out=16, c_max=1024, multiprobe=2, c_comp=0)

# the kNN-LM slice
LM_ARCH = "granite-8b"  # d_model 4,096, 32/8 heads, head_dim 128, 36 layers
DS_SEQS, DS_LEN, DS_CHUNK = 64, 1025, 8  # examples/serve_knn_lm.py step 2, at full width
PROMPT_LEN, MAX_NEW, N_REQ = 128, 8, 4  # step 3's serving, with 128-token prompts
KNN_FAMILY = dict(m_out=24, L_out=8, m_in=12, L_in=4, alpha=0.02)  # step 2's FamilyConfig
KNN_BUDGET = dict(k=8, c_max=64, c_in=16, h_max=4, p_max=128)  # step 2's BudgetConfig
WIDE_ARCH = "nemotron-4-340b"  # the widest d_model (18,432) and head_dim (192) of the repo's configs
WIDE_D = 18_432  # its d_model
# Kernel F against its plain version: both accumulate in float32 and round
# once to bf16, so an element may land one bf16 ulp apart (at most 2^-7 of
# its size) where the float32 sums, taken in another order, straddle a
# rounding boundary.
FA_RTOL, FA_ATOL = 2.0**-7, 1e-3
# The model with kernel F against the same model with the plain attention:
# each layer's attention output may differ by such one-ulp flips, which
# every later bf16 matmul and residual add carries on over 36 layers. The
# logits (bf16 products, up to about 6 in size here) are held to twice the
# gap between two plain models that differ only in float32 rounding, plus
# one bf16 ulp at 4-8. The tight gate on F is flash_row's, per element at
# each shape; this one must still catch the GATED_FAULTS the phase plants.
LOGIT_ATOL = 2.0**-5

# the training slice: hubert-xlarge's FULL config, no cut (48 layers,
# d_model 1280, 16 heads of 80, d_ff 5120, gelu, vocabulary 504, non-causal,
# 512-wide frames), on the JAX launcher's audio batches at 8 x 1,024 frames
TRAIN_ARCH = "hubert-xlarge"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PROFILED = 8, 1024, 3, 2  # 3 timed steps: the script's time
# The step-0 check holds the training path (remat "dots", chunked attention
# and loss, each chunk under a checkpoint) to a plain path (no remat, one
# attention block, whole logits, F.cross_entropy) on the batch's first 2
# rows: the plain path keeps every layer's activations, past 80 GB at 8. The
# two run the same bf16 matmuls, but attention and loss in other shapes and
# orders, so an element may land a bf16 ulp apart, which later layers carry
# on; as tests/test_torch_train.py holds the port to JAX: the loss within
# rtol 1e-3, each leaf's gradient within 2^-5 of its largest element and at
# a cosine of at least 0.999.
TRAIN_CHECK_ROWS = 2
TRAIN_LOSS_RTOL, TRAIN_GRAD_FRAC, TRAIN_GRAD_COS = 1e-3, 2.0**-5, 0.999
# AdamW on the card against the CPU on one stacked leaf: parameters within
# rtol 1e-6 (the schedule's pow and the divisions may round an ulp apart),
# float32 moments and block scales within 4 ulps (rtol 2^-21; the clip
# scale comes from a norm summed in another order)
UPDATE_LEAF = "wq"
UPDATE_P_RTOL, UPDATE_M_RTOL = 1e-6, 2.0**-21

# the moe, ssm and hybrid families' serving path: each FULL config whole,
# B = 2 prompts of these lengths (mamba2's not a multiple of its 128 chunk;
# hymba's 1,920 + 128 meta tokens = 2,048 positions, past its window 1,024 +
# 128 meta tokens), then 8 greedy decode steps; and qwen3-32b, the largest
# dense config one card holds whole (64 layers, d 5,120, 64/8 heads of 128
# with qk-norm, d_ff 25,600, a 151,936-word vocabulary and an untied head:
# 32.8 B parameters, 65.5 GB in bf16), its weights drawn on the card leaf by
# leaf (models.params.DRAW_WHOLE_MAX)
FAMILY_PROMPTS = {"olmoe-1b-7b": 512, "mamba2-780m": 1000, "hymba-1.5b": 1920, "qwen3-32b": 512}
# hymba-1.5b cut in depth for the script's time, its global layers a first,
# a middle and a last: lm_mesh serves it whole, one process and 1 x 4.
# Served here at 16 of its 32 layers (at 8 the logit gate read
# fault_causal_edge at 0.178 against its 0.180 on an H100 80GB HBM3 at
# 700 W); trained at 8 (families_train, lm_mesh), since at 16 the step-0
# rule fails on segments/seg2/conv_b from the SSD's summation order
# (scripts/hymba_step0_depth.py)
HYMBA_CUT = dict(n_layers=8, global_layers=(0, 3, 7))
FAMILY_CUT = {"hymba-1.5b": dict(n_layers=16, global_layers=(0, 7, 15))}
FAMILY_BATCH, FAMILY_STEPS = 2, 8
SINK_ARCH = "hymba-1.5b"  # its sliding-window prefill is kernel F's sink case
# Decode after prefill(s) against prefill(s + 1): the two paths round
# differently (the chunked SSD returns bf16 chunk outputs, the recurrent
# step keeps float32; F against the ring's torch attention), which each
# layer carries on. Held to 2^-3 of the largest logit (16 bf16 ulps there,
# about 0.5 for logits of about 4): a state or conv tail not carried over,
# or a wrong ring, moves the logits by their own size.
CONT_FRAC = 2.0**-3
# the moe, ssm and hybrid families' training (families_train): each FULL
# config, masters from a seeded generator, (batch, tokens) a step; hymba's
# tokens run behind its 128 meta tokens
FT_BATCH = {"olmoe-1b-7b": (4, 512), "mamba2-780m": (4, 1024), "hymba-1.5b": (2, 512)}
FT_CUT = {"olmoe-1b-7b": dict(param_dtype="bfloat16", opt_state_bits=8)}
# mamba2 at 12 of its 48 layers and hymba at HYMBA_CUT, FULL configs only:
# the script's time (lm_mesh trains mamba2 whole on 2 x 2)
FT_DEPTH = {"mamba2-780m": dict(n_layers=12), "hymba-1.5b": HYMBA_CUT}
FT_CUT_WHY = {"olmoe-1b-7b": (
    "param_dtype bfloat16 and opt_state_bits 8, the JAX config's fields for this case: 6.92 B parameters in"
    " float32 masters, gradients and two moments come to about 110 GB, past the card's 80 GB; all 16 layers kept"),
              "mamba2-780m": ("12 of 48 layers: the script's time (whole it took about 40 s; lm_mesh trains it whole on"
                              " 2 x 2)"),
              "hymba-1.5b": "8 of 32 layers, global layers 0, 3 and 7: the script's time (whole it took about 100 s)"}
# timed steps a family, the last under the profiler (the card's kernels
# only: CUPTI's records add about a microsecond a launch, 0.13 s to hymba's
# 132,588): mamba2's and hymba's host-bound steps (4-6 s and 16-27 s on an
# H100 80GB HBM3 at 700 W) take one, which keeps the whole script inside
# its 1,200 s limit on a slow host
FT_STEPS = {"olmoe-1b-7b": 2, "mamba2-780m": 1, "hymba-1.5b": 1}
# the step-0 check's (rows, tokens): the first rows of step 0's batch; mamba2
# and hymba on a prefix, since ssd_reference runs a per-token loop (two and
# three of their 128-token chunks, hymba's meta tokens included)
FT_CHECK = {"olmoe-1b-7b": (2, 512), "mamba2-780m": (1, 256), "hymba-1.5b": (1, 256)}
# The step-0 check holds the training path to the plain one as the train
# phase holds hubert's (loss rtol 1e-3, each gradient within 2^-5 of its
# largest element at a cosine of 0.999), widened by twice the training
# path's own gap to the same arithmetic in other float32 orders, as
# tests/test_torch_families_train.py widens it by JAX's gap between its two
# compilations: the SSD and hymba's two heads sum bf16-rounded terms with
# cancellation, so a small leaf (dt_bias, A_log) moves by a larger share
# of itself than a dense leaf does.
FT_LOSS_RTOL = 1e-3
# serving the trained masters: B = FAMILY_BATCH prompts of these lengths
# (hymba's 1,024 + 128 meta tokens past its 1,024 window, so F's sink bites),
# then FT_SERVE_STEPS greedy decode steps
FT_SERVE_PROMPT = {"olmoe-1b-7b": 512, "mamba2-780m": 1000, "hymba-1.5b": 1024}
FT_SERVE_STEPS = 4
# ssd_chunked against ssd_reference in float32 at FULL's dims: the same sums
# grouped by chunk, within 1e-4 of the largest output (the JAX package's own
# test holds them to 1e-4)
SSD_RTOL = 1e-4
# the LM families under a mesh (lm_mesh), 4 gloo ranks on this one card.
# Serving: phi3.5-moe-42b-a6.6b at full width, cut to 8 of its 32 layers
# (whole it is 84 GB in bf16, past one card; at 8 layers a rank holds its 4
# experts x 8 layers, 5.0 GB, and 1.2 GB replicated, the one-process
# reference 21 GB), on make_local_mesh(1, 4): the experts over 4 ranks and
# the cache's positions in 4 blocks; 2 prompts of 512 tokens, 8 decode
# steps fed with the reference's greedy tokens (max_len 520, a multiple of
# 4, so decode attention runs context-parallel). Both combines: gather at
# the config's capacity factor, a2a at n_experts / top_k (a2a caps per
# destination rank, so at 1.25 its drops would legitimately differ from
# the local path's; tests/test_moe_ep.py raises its capacity for the same
# reason).
LMM_SERVE_ARCH, LMM_SERVE_LAYERS, LMM_SERVE_MESH = "phi3.5-moe-42b-a6.6b", 8, (1, 4)
LMM_SERVE_BATCH, LMM_SERVE_PROMPT, LMM_SERVE_STEPS = 2, 512, 8
# Training: olmoe-1b-7b at full width, cut to 4 of its 16 layers (the
# gradients cross gloo through the host, about 2.2 GB of bf16 a rank a
# step; at 2 layers the step-0 rule read 1.15 of its tolerance on embed's
# gradient on an H100 80GB HBM3 at 700 W, where 4 layers read 0.68: the
# rule does not go route by route, and moe's routes are discontinuous) and
# one step for the phase's time, bf16 masters and 8-bit moments as
# families_train has them, capacity factor n_experts / top_k (a data
# shard's capacity comes from its own tokens), on make_local_mesh(2, 2):
# data parallel 2 x expert parallel 2; 4 x 512 tokens through
# launch.train.train. The step-0 check takes the first 2 rows of step 0's batch (one per data rank). The
# gather combine: olmoe's config names a2a, whose capacity is applied twice
# (per destination rank, then per expert, c_in = ep * cap * cf / e_loc), so
# at capacity factor 8 each of a rank's 32 experts gets 8,192 slots for
# about 128 copies, and the padded activations ran a rank out of memory
# (an H100 80GB HBM3 at 700 W); serving runs both combines.
LMM_TRAIN_ARCH, LMM_TRAIN_LAYERS, LMM_TRAIN_MESH = "olmoe-1b-7b", 4, (2, 2)
LMM_TRAIN_BATCH, LMM_TRAIN_SEQ, LMM_TRAIN_STEPS, LMM_TRAIN_ROWS = 4, 512, 1, 2
# The served logits are held route by route. Every rank and the one-process
# reference record moe's routes (moe.ROUTES); in each pass, a row whose read
# token (the last position) took the same experts at every layer as in the
# reference is held within logit_gate's tolerance, twice the gap between the
# reference's plain attention and attention_ref on the rows where those two
# route alike, plus LOGIT_ATOL, and its greedy token must be the reference's
# where the reference's top-2 gap exceeds it. A row whose read token took
# other experts is a route flip: at the first layer where they differ, each
# differing decision must be a near tie of the reference's, its k-th and
# (k+1)-th router probabilities (or, where the same experts were chosen and
# a capacity slot went elsewhere, the token's weight and the capacity's
# edge) within LMM_ROUTE_TIE of each other, relative (the later layers route
# a token whose state that swap has changed: run 7 read first-layer margins
# of 0.002-0.017 and later ones up to 0.44); and at least half the
# row-passes must route alike. One expert swapped at the read token moves
# phi3.5's logits by up to 1.7, as in one process between F and the plain
# attention (my chip run 6: 0.80 at a first decode, where plain against
# attention_ref read 0.055).
LMM_ROUTE_TIE = 2.0**-4
# planted faults the serving check must catch, each run for the prefill and
# the decode steps named with the combine named: the experts of the model
# axis's rank 1 adding nothing; context-parallel decode shifting each
# block's softmax by the block's own max instead of the global one; the
# model axis's rank 1 reading its block of the vocabulary one row off in
# the lookup; every reduce-scatter keeping the next rank's block of the
# sum. A fault counts as caught only on a row-pass that is not excused
# (fault_caught): fault_cp_max acts in decode alone, and in one decode step
# both rows' read tokens took other experts at a near tie (excused) on the
# card (an H100 80GB HBM3 at 700 W), with too few row-passes alike, so it
# runs every decode step of the served run, over which its error grows.
LMM_FAULTS = (("fault_expert_share", "gather", 1), ("fault_expert_share", "a2a", 1), ("fault_cp_max", "gather", 8),
              ("fault_vocab_block", "gather", 1), ("fault_seq_scatter", "gather", 1))
# a granite-8b decode step's bytes a rank hands to gloo: the layers'
# tensor-parallel sums, decode attention's gathers and the logits, with
# nothing of the vocabulary gathered (about 0.105 GB a step before)
LMM_DECODE_SENT_BYTES = 10e6
# the expert blocks' moments after one step against the matching blocks of
# the one-process moments, both dequantized: m and sqrt(v) are the step-0
# gradient scaled ((1 - b1) g and sqrt(1 - b2) |g|, times the clip scale),
# so they are held as the gradients are, within twice 2^-5 of the block's
# largest (no other-order gap exists for them); a block quantized along
# another axis than the whole leaf's would be off by its own size
LMM_MOMENT_FRAC = 2 * TRAIN_GRAD_FRAC
# granite-8b FULL under the mesh, the dense family tensor-parallel. Served
# at full width and depth (36 layers, d 4,096, 32/8 heads of 128, d_ff
# 14,336, vocabulary 49,152, tied) on make_local_mesh(1, 4): each rank
# projects its 8 query and 2 KV heads and its 3,584 FFN columns, kernel F
# runs on its heads, wo and w_down are row-parallel, the stream between
# blocks in blocks of 128 positions, the embedding and the head in blocks
# of 12,288 words; 2 prompts of 512, 4 greedy decode steps (the script's
# time) fed with the reference's tokens (max_len 516, a multiple of 4:
# context-parallel decode over every head), held pass by pass against the same seeded model in
# this process with logit_gate's tolerance. Trained at full width cut to
# 2 of its 36 layers, for the phase's time, on make_local_mesh(2, 2) with
# float32 masters and 32-bit moments on 4 x 512 tokens (held whole, its
# state at 8 layers would be about 31 GB a rank, four of which one card
# cannot hold; under the spec about 7.8 GB a rank). The step-0 check
# takes the first 2 rows of step 0's batch (families_train's rule), then
# one timed step.
LMM_DENSE_ARCH, LMM_DENSE_SERVE_MESH, LMM_DENSE_TRAIN_MESH = "granite-8b", (1, 4), (2, 2)
LMM_DENSE_BATCH, LMM_DENSE_PROMPT, LMM_DENSE_STEPS = 2, 512, 4
LMM_DENSE_TRAIN_LAYERS, LMM_DENSE_TRAIN_BATCH, LMM_DENSE_TRAIN_SEQ = 2, 4, 512
# a rank's bytes on the card once its weights (or its masters, and its
# masters and moments after the first step) are drawn, against its blocks'
# bytes under the JAX spec: the allocator rounds each tensor up to 512 bytes
LMM_HELD_RTOL = 0.01
# mamba2-780m (48 layers, d 1,536, 48 SSM heads of 64) and hymba-1.5b (32
# layers, global layers 0, 15 and 31, 128 meta tokens, window 1,024) at
# full width and depth on make_local_mesh(1, 4): each rank gathers the
# weights and runs the SSM branch (and hymba's 25 heads, which 4 does not
# divide) whole on the gathered stream, keeps its block of positions
# between layers and holds its blocks of the SSM state and conv tail; B = 2
# prompts of 1,000 and 1,024 tokens (hymba's 1,152 positions with the meta
# tokens run past its window, so F's sink case bites), 8 decode steps fed
# with the reference's tokens (max_len rounded up to a multiple of 4, so
# the global layers' decode attention is context-parallel), held pass by
# pass against the seeded model in this process (ssm_serve_reference).
# The planted faults, each with the decode steps it runs after the prefill:
# the model axis's rank 1 zeroing its block of the SSM state or of the conv
# tail as each decode step gathers them (mamba2's logits move by 3-5 in
# the first step; hymba's attention carries its first step, within the
# tolerance, and the second moves by 1.1, on an H100 80GB HBM3 at 700 W),
# and the rank
# holding the first block of hymba's positions (the meta tokens) shifting
# it by one position, which the prefill shows.
LMM_SSM_SERVE_MESH, LMM_SSM_BATCH, LMM_SSM_STEPS = (1, 4), 2, 8
LMM_SSM_PROMPT = {"mamba2-780m": 1000, "hymba-1.5b": 1024}
LMM_SSM_FAULTS = {"mamba2-780m": (("fault_ssm_state", 1), ("fault_conv_tail", 1)),
                  "hymba-1.5b": (("fault_ssm_state", 2), ("fault_meta_shift", 0))}
# trained on make_local_mesh(2, 2) with float32 masters and 32-bit moments
# (the configs' own), one step of 4 x 512 tokens after the step-0 check on
# its first 2 rows (hymba's behind its 128 meta tokens; on their first 256
# tokens hymba's read 0.995 of the tolerance, against 0.27 on 512, on an
# H100 80GB HBM3 at 700 W); mamba2 whole,
# hymba cut in depth (LMM_SSM_TRAIN_CUT_WHY). The planted training fault,
# on hymba: ctx.keep_block's backward keeping this rank's share of the
# gradient (a plain slice) instead of gathering and averaging the ranks'
# shares, read by the step-0 rule (on mamba2 it read 0.046 of the
# tolerance against its clean run's 0.078 on an H100 80GB HBM3 at 700 W,
# so it runs on one of the two).
LMM_SSM_TRAIN_MESH, LMM_SSM_TRAIN_BATCH, LMM_SSM_TRAIN_SEQ = (2, 2), 4, 512
LMM_SSM_TRAIN = {"mamba2-780m": {}, "hymba-1.5b": dict(HYMBA_CUT, microbatches=1)}
LMM_SSM_TRAIN_CUT_WHY = {"hymba-1.5b": (
    "8 of 32 layers, global layers 0, 3 and 7 (a first, a middle and a last), and one microbatch of the config's"
    " two (each gathers every weight again: 22.0 s a step against 14.6 s for the step-0 gradients on an H100"
    " 80GB HBM3 at 700 W): a 32-layer step under the mesh does not fit the script's time budget; families_train"
    " runs hymba at the same depth")}
LMM_TRAIN_FAULT, LMM_TRAIN_FAULT_ARCH = "fault_keep_slice", "hymba-1.5b"


_STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of readings, ``at_s`` the seconds since the script
    started (where a phase's time goes)."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - _STARTED}), flush=True)


def need(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def timed_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, each started with a
    cold L2 (``flush`` overwrites a buffer larger than the cache first)."""
    import torch

    fn()  # warm-up
    total = 0.0
    for _ in range(iters):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def device_profile(fn, iters: int = 10) -> dict:
    """The profiler's view of one ``fn()``: ``device_ms``, the summed time
    of the kernels it launches on the card, and ``kernels_per_call``, how
    many it launches, over ``iters`` warm calls recorded after ``iters``
    calls of the profiler's warm-up step. The profiler can lose a kernel's
    record, so the window runs three times and the fullest record is kept.
    Unlike ``timed_ms`` it leaves out the host's dispatch, which sets the
    event time of a short launch. Both None on the CPU."""
    import torch

    if not torch.cuda.is_available():
        return dict(device_ms=None, kernels_per_call=None)
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up step, then the recorded one
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        got = dict(device_ms=sum(e.self_device_time_total for e in events) / iters / 1e3,
                   kernels_per_call=sum(e.count for e in events) / iters)
        if best is None or got["kernels_per_call"] > best["kernels_per_call"]:
            best = got
    return best


def host_ms(fn, iters: int = 50) -> float | None:
    """Median host time of one ``fn()`` call, from the call to its return,
    over ``iters`` calls made back to back: the wrapper's checks, launch
    shape and dispatch, which a host-bound path pays on every call. None on
    the CPU."""
    import torch

    if not torch.cuda.is_available():
        return None
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def profile_query(dev, fn, queries: int = 200) -> dict:
    """Wall time of ``fn()`` under the profiler, the summed time of its
    kernels on the card (device busy), the device's idle share, the eight
    longest kernels and the port's own, each with its share of the busy
    time. On the card only its kernels are traced: per-op host records
    slow a path of many ops and took the profiler 45 s to process for the
    stream's 32 profiled events (an H100 80GB HBM3 host at 700 W)."""
    import torch

    kind = torch.profiler.ProfilerActivity
    acts = [kind.CUDA] if dev.type == "cuda" else [kind.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    # device-side events only (a CPU op's device time repeats that of the
    # kernels it launched), summed by name from the raw trace: building
    # key_averages() over a streaming window's half a million events took
    # minutes on the card's host
    kernels: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            acc = kernels.setdefault(e.name(), [0, 0])
            acc[0] += e.duration_ns()
            acc[1] += 1
    busy = sum(ns for ns, _ in kernels.values()) / 1e9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    port = [kv for kv in kernels.items() if (kv[0].split("(")[0].split("<")[0].split() or [""])[-1] in PORT_KERNELS]
    return dict(
        queries=queries, wall_s=wall,
        device_busy_s=busy if kernels else None,
        device_idle_share=1.0 - busy / wall if kernels else None,
        top_kernels=[dict(name=name[:90], ms=ns / 1e6, calls=c) for name, (ns, c) in top],
        port_kernels=[dict(name=name[:60], ms=ns / 1e6, calls=c, share_of_busy=ns / 1e9 / busy)
                      for name, (ns, c) in port],
    )


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b_words_bound(t: int, d: int, cols, m: int, m_pad: int) -> tuple[float, str]:
    """Kernel B's bound in words mode on rows x (t, d): x read once, the P
    and bias entries of the real columns (only they can set a bit; padded
    columns pack 0 whatever s is), one word per 32 columns written, and
    2*d flops for each (row, real column)."""
    n_cols = cols.shape[1]
    real = (n_cols // m_pad) * m
    return bound(t * d * 4 + real * d * 4 + real * 4 + t * n_cols // 8, 2 * t * d * real)


def need_topk(kd, ki, kd_ref, ki_ref, dist_of, what: str) -> None:
    """``(kd, ki)`` answers as ``(kd_ref, ki_ref)`` does: distances within
    tolerance, and an index differs only at a real distance tie, where it
    must be a point at its distance (``repro_torch.core.topk.topk_mismatch``)."""
    from repro_torch.core import topk

    why = topk.topk_mismatch(kd, ki, kd_ref, ki_ref, dist_of, rtol=RTOL, atol=ATOL)
    need(why is None, f"{what}: {why}")


def point_dist_of(data, queries):
    """L1 distance of query ``rows`` to data points ``idx``."""
    return lambda rows, idx: (data[idx.long()] - queries[rows]).abs().sum(-1)


def synth(n: int, nq: int):
    from repro_torch.data import windows

    pts = np.empty((n, windows.D_SUBWINDOWS), np.float32)
    labs = np.empty((n,), np.int8)
    lo = 0
    for p, y in windows.synth_window_chunks(windows.SyntheticWindowSpec(n=n, seed=SEED), 16_384):
        pts[lo : lo + p.shape[0]], labs[lo : lo + p.shape[0]] = p, y
        lo += p.shape[0]
    qx, qy = windows.synth_window_slice(windows.SyntheticWindowSpec(n=n + nq, seed=SEED), n, n + nq)
    return pts, labs, qx, qy


def kernels_phase(data, queries, cfg, flush) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import hashing, pipeline
    from repro_torch.kernels.hash_pack import ops as hp, ref as hp_ref

    shapes = dslsh_path_cases(data, queries, cfg, flush)
    n_loc = data.shape[0] // NU
    cell = data[:n_loc].contiguous()  # node 0's slice: one cell's points
    outer, inner = pipeline.make_family(torch.Generator().manual_seed(SEED), data.shape[1], cfg, data.device)
    l_loc = cfg.L_out // P
    outer0 = hashing.BitSampleParams(outer.dims[:l_loc], outer.thrs[:l_loc], outer.salts[:l_loc])
    rows = []

    # A: bitsample_pack, words + margins, on every point of one cell
    dims, thrs = hp.bitsample_columns(outer0)
    t, d, m_cols = cell.shape[0], cell.shape[1], dims.shape[0]
    wk, mk = hp.bitsample_pack(cell, dims, thrs, margins=True)
    wr, mr = hp_ref.bitsample_pack_ref(cell, dims, thrs, margins=True)
    need(torch.equal(wk, wr) and torch.equal(mk, mr), "bitsample_pack differs from its plain version")
    b_ms, b_by = bound(t * d * 4 + m_cols * 8 + t * (m_cols // 32) * 8 + t * m_cols * 4, 2 * t * m_cols)
    rows.append(dict(
        name="bitsample_pack", route="cuda", source="src/repro_torch/csrc/hash_pack.cu",
        replaces="src/repro/kernels/hash_pack/hash_pack.py:112",
        also_replaces="src/repro/kernels/hash_pack/hash_pack.py:139",
        shape=f"x ({t}, {d}), {m_cols} columns, margins", exact=True,
        max_abs_err=float((mk - mr)[torch.isfinite(mr)].abs().max()),  # padded columns hold inf
        ms=timed_ms(lambda: hp.bitsample_pack(cell, dims, thrs, margins=True), 50, flush),
        device_ms=device_profile(lambda: hp.bitsample_pack(cell, dims, thrs, margins=True))["device_ms"],
        plain_ms=timed_ms(lambda: hp_ref.bitsample_pack_ref(cell, dims, thrs, margins=True), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, path_shapes=shapes["a"],
    ))

    # B: proj_sign_pack on the inner family, every point of one cell; the
    # plain version is a full-float32 matmul (TF32 off)
    n_tab = inner.proj.shape[0]
    cols, bias, m_in, m_pad = inner_columns(inner)
    wk, mk = hp.proj_sign_pack(cell, cols, bias, m_in, m_pad, margins=True)
    wr, mr = hp_ref.proj_sign_pack_ref(cell, cols, bias, m_in, m_pad, margins=True)
    need(torch.equal(hp.proj_sign_pack(cell, cols, bias, m_in, m_pad), wk), "proj_sign_pack words depend on the margins mode")
    real = (torch.arange(cols.shape[1], device=data.device) % m_pad) < m_in
    margin_err = float((mk - mr)[:, real].abs().max())
    s = cell @ cols
    bits_k = (wk[:, :, None] >> torch.arange(32, device=data.device)) & 1
    bits_r = (wr[:, :, None] >> torch.arange(32, device=data.device)) & 1
    diff = (bits_k != bits_r).reshape(t, -1)
    scale = 1e-5 * cell.norm(dim=1, keepdim=True) * cols.norm(dim=0, keepdim=True)
    need(not bool((diff & (s.abs() > scale)).any()), "proj_sign_pack flips a bit far from zero")
    # margins mode on a one-hot projection must reproduce kernel A
    ow, om = hp.onehot_pack_margins(cell, outer0.dims, outer0.thrs)
    aw, am = hp.probe_words(outer0, cell)
    ties = am == 0  # x[dim] == thr: A's bit is 0 (>), B's is 1 (>=)
    tie_words = ties.reshape(t, l_loc, -1, 32).any(dim=-1)
    need(torch.equal(om, am), "one-hot proj_sign_pack margins differ from bitsample_pack")
    need(torch.equal(ow[~tie_words], aw[~tie_words]), "one-hot proj_sign_pack words differ from bitsample_pack")
    b_ms, b_by = b_words_bound(t, d, cols, m_in, m_pad)
    # the margins launch (#4) also writes t * cols f32 margins
    bm_ms, bm_by = bound(
        t * d * 4 + cols.numel() * 4 + bias.numel() * 4 + t * cols.shape[1] // 8 + t * cols.shape[1] * 4,
        2 * t * d * n_tab * m_in,
    )
    rows.append(dict(
        name="proj_sign_pack", route="cuda", source="src/repro_torch/csrc/hash_pack.cu",
        replaces="src/repro/kernels/hash_pack/hash_pack.py:210",
        also_replaces="src/repro/kernels/hash_pack/hash_pack.py:175",
        shape=f"x ({t}, {d}), proj ({d}, {cols.shape[1]}), {n_tab * m_in} real columns",
        exact=bool(not diff.any()), disagreeing_bits=int(diff.sum()),
        max_abs_err=margin_err, max_abs_err_of="margins |s| against the float32 matmul",
        onehot_vs_bitsample=dict(margins_equal=True, words_equal_off_ties=True, tie_columns=int(ties.sum())),
        ms=timed_ms(lambda: hp.proj_sign_pack(cell, cols, bias, m_in, m_pad), 50, flush),
        device_ms=device_profile(lambda: hp.proj_sign_pack(cell, cols, bias, m_in, m_pad))["device_ms"],
        plain_ms=timed_ms(lambda: hp_ref.proj_sign_pack_ref(cell, cols, bias, m_in, m_pad), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        margins_replaces="src/repro/kernels/hash_pack/hash_pack.py:175",
        margins_ms=timed_ms(lambda: hp.proj_sign_pack(cell, cols, bias, m_in, m_pad, margins=True), 50, flush),
        margins_plain_ms=timed_ms(
            lambda: hp_ref.proj_sign_pack_ref(cell, cols, bias, m_in, m_pad, margins=True), 10, flush),
        margins_bound_ms=bm_ms, margins_bound_by=bm_by, margins_library_ms=None,
        query_chunk=b_query_chunk(queries[: cfg.query_chunk].contiguous(), cols, bias, m_in, m_pad, flush),
        one_order=[b_order_check(cell, inner)],
    ))

    # the main path's candidates for one 50-query chunk of cell (0, 0),
    # from a plain-backend build of that cell
    qs = queries[: cfg.query_chunk].contiguous()
    cand = shapes["cell_cand"]
    c_w = cand.shape[1]
    cc = pipeline._compact_width(cfg, c_w, n_loc)
    comp, valid = compacted(cand, cc)
    k = cfg.k

    # C: l1_topk on the compacted (Q, c_comp, d) block of the grid chunk (k
    # 10 and 40), on a 16,384-wide block and on a 49,152-wide one that
    # spills its workspace (k 10 and 40); its distances against D's bits on
    # the grid chunk's compacted rows
    grid_pts = cell[comp.long().clamp(0, n_loc - 1)].contiguous()
    c_row = c_case("grid_chunk", qs, grid_pts, valid.contiguous(), k, flush)
    wide = wide_block(data, queries, cfg, ROUTE_CASES["d_over_shared_memory"])
    spill = wide_block(data, queries, cfg, C_SPILL_CASE)
    rows.append(dict(
        name="l1_topk", route="cuda", source="src/repro_torch/csrc/l1_topk.cu",
        replaces="src/repro/kernels/l1_topk/l1_topk.py:100",
        **{key: c_row[key] for key in ("shape", "exact", "max_abs_err", "ms", "device_ms", "kernels_per_call",
                                       "host_ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None,
        cases=[c_row, c_case("grid_chunk_k40", qs, grid_pts, valid.contiguous(), 40, flush),
               c_case("wide_16384", *wide, k, flush), c_case("spill_49152", *spill, k, flush),
               c_case("spill_49152_k40", *spill, 40, flush)],
        one_order=[c_d_order_check(cell, qs, shapes["cell_cand"], cfg)],
    ))
    del wide, spill

    # D: the fused tail on the chunk's raw (Q, C) candidate rows (the grid
    # chunk of the path shapes)
    grid = shapes["d"][0]
    rows.append(dict(
        name="query_tail", route="cuda", source="src/repro_torch/csrc/query_fused.cu",
        replaces="src/repro/kernels/query_fused/query_fused.py:496",
        also_replaces="src/repro/kernels/query_fused/query_fused.py:467",
        **{key: grid[key] for key in ("shape", "exact", "max_abs_err", "ms", "device_ms", "kernels_per_call",
                                      "plain_ms", "bound_ms", "bound_by")},
        library_ms=None, path_shapes=shapes["d"], one_order=shapes["order"],
    ))
    rows += payload_kernel_rows(data, queries, cfg, shapes["full_cand"], flush)
    return rows


def b_query_chunk(qs, cols, bias, m: int, m_pad: int, flush) -> dict:
    """Kernel B on one query chunk (the inner layer hashes a query chunk at
    every grid query): no bit far from zero may differ from the plain
    version, and the bits that differ at all are counted."""
    import torch

    from repro_torch.kernels.hash_pack import ops as hp, ref as hp_ref

    t, d = qs.shape
    wk = hp.proj_sign_pack(qs, cols, bias, m, m_pad)
    wr = hp_ref.proj_sign_pack_ref(qs, cols, bias, m, m_pad)
    bits = torch.arange(32, device=qs.device)
    diff = (((wk[:, :, None] >> bits) & 1) != ((wr[:, :, None] >> bits) & 1)).reshape(t, -1)
    scale = 1e-5 * qs.norm(dim=1, keepdim=True) * cols.norm(dim=0, keepdim=True)
    need(not bool((diff & ((qs @ cols).abs() > scale)).any()), "proj_sign_pack flips a bit far from zero on a query chunk")
    b_ms, b_by = b_words_bound(t, d, cols, m, m_pad)
    return dict(shape=f"x ({t}, {d}), proj ({d}, {cols.shape[1]}), {cols.shape[1] // m_pad * m} real columns",
                exact=bool(not diff.any()), disagreeing_bits=int(diff.sum()),
                ms=timed_ms(lambda: hp.proj_sign_pack(qs, cols, bias, m, m_pad), 50, flush),
                device_ms=device_profile(lambda: hp.proj_sign_pack(qs, cols, bias, m, m_pad))["device_ms"],
                plain_ms=timed_ms(lambda: hp_ref.proj_sign_pack_ref(qs, cols, bias, m, m_pad), 10, flush),
                bound_ms=b_ms, bound_by=b_by)


def merge_exchanges(c_pad: int, run: int) -> int:
    """Compare-exchanges of one row's merge network from the run width up
    (a full bitonic sort when ``run`` is 1): log2(size) steps of
    ``c_pad / 2`` for each merge level."""
    sizes = [run << e for e in range(1, (c_pad // run).bit_length())]
    return (c_pad // 2) * sum(s_.bit_length() - 1 for s_ in sizes)


def merge_width(c: int, run: int) -> tuple[int, int]:
    """The least merge network for a row of ``c`` candidates in runs of
    ``run``: its power-of-two width and the run width it starts from (1, a
    full sort, when the run is not a power of two). The same rule as the
    package's ``query_fused.ops.merge_shape``, kept here so that a bound
    does not rest on the code it measures and the script also measures a
    tree whose package lacks that helper (a parent commit)."""
    cp = 1 << max(0, c - 1).bit_length()
    return cp, (min(run, cp) if run & (run - 1) == 0 else 1)


# ------------------------------------------------------ kernel C


def compacted(cand, cc: int):
    """Stages 3-4 of the staged form on a chunk's (Q, C) candidate rows: the
    first ``cc`` unique indices ascending (-1 pad) and their mask."""
    from repro_torch.core import pipeline

    cs, uniq, comparisons = pipeline._stage_dedup(cand)
    comp, valid, _ = pipeline._stage_compact(cs, uniq, comparisons, cc)
    return comp, valid


def c_case(case: str, qs, pts, valid, k: int, flush) -> dict:
    """Kernel C on a compacted (Q, cc, d) block against its plain version
    (top-k tie-aware within RTOL/ATOL), timed by events, by the profiler
    and on the host, with its bound: the valid rows, the mask, the queries
    and the outputs read or written once, 3 operations per valid
    coordinate."""
    import torch

    from repro_torch.kernels.l1_topk import ops as l1, ref as l1_ref

    (q_n, cc, d) = pts.shape

    def fn():
        return l1.l1_topk(qs, pts, valid, k)

    (dk, pk), (dr, pr) = fn(), l1_ref.l1_topk_ref(qs, pts, valid, k)
    need_topk(dk, pk, dr, pr, lambda rows, pos: (pts[rows, pos.long()] - qs[rows]).abs().sum(-1),
              f"l1_topk ({case}) differs from its plain version")
    n_valid = int(valid.sum())
    b_ms, b_by = bound(n_valid * d * 4 + valid.numel() + q_n * d * 4 + q_n * k * 8, 3 * n_valid * d)
    return dict(case=case, shape=f"cands ({q_n}, {cc}, {d}), {n_valid} valid, k {k}", exact=bool(torch.equal(pk, pr)),
                max_abs_err=float((dk - dr).abs().nan_to_num(0.0).max()),
                ms=timed_ms(fn, 30, flush), **device_profile(fn), host_ms=host_ms(fn),
                plain_ms=timed_ms(lambda: l1_ref.l1_topk_ref(qs, pts, valid, k), 5, flush),
                bound_ms=b_ms, bound_by=b_by)


def wide_block(data, queries, cfg, kw: dict):
    """The staged form's compacted block for kernel C on the first 50-query
    chunk of a 131,072-point single shard with settings ``kw`` and
    ``c_comp=0``, every column kept: (queries, points, mask)."""
    import torch

    from repro_torch.core import pipeline

    n_r = min(131_072, data.shape[0])
    cfg_w = cfg.replace(**kw)
    part = data[:n_r].contiguous()
    outer, inner = pipeline.make_family(torch.Generator().manual_seed(SEED), data.shape[1], cfg_w, data.device)
    qs = queries[: cfg.query_chunk].contiguous()
    cand = tail_candidates(part, outer, inner, cfg_w, qs)
    comp, valid = compacted(cand, pipeline._compact_width(cfg_w, cand.shape[1], n_r))
    return qs, part[comp.long().clamp(0, n_r - 1)].contiguous(), valid.contiguous()


def c_d_order_check(data, qs, cand, cfg) -> dict:
    """One L1 order across the routes: on a chunk's compacted rows kernel
    C's top-k equals kernel D's on the raw rows bit for bit (distances, and
    the indices C's positions point at)."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.kernels.l1_topk import ops as l1
    from repro_torch.kernels.query_fused import ops as qf

    cc = pipeline._compact_width(cfg, cand.shape[1], data.shape[0])
    comp, valid = compacted(cand, cc)
    pts = data[comp.long().clamp(0, data.shape[0] - 1)].contiguous()
    dc, pc = l1.l1_topk(qs, pts, valid.contiguous(), cfg.k)
    ic = torch.where(pc >= 0, torch.gather(comp, 1, pc.long().clamp(min=0)), -1)
    dd, id_, _, _ = qf.query_tail(data, qs, cand, run=pipeline._fused_run(cfg), c_comp=cc, k=cfg.k)
    same = dict(distances_equal=bool(torch.equal(dc, dd)), indices_equal=bool(torch.equal(ic, id_)))
    need(all(same.values()), f"l1_topk and query_tail disagree on the same compacted rows: {same}")
    return dict(d=data.shape[1], queries=qs.shape[0], **same)


# ------------------------------------------- kernels A and D at the paths' shapes


def a_case(case: str, x, dims, thrs, flush, margins: bool = False) -> dict:
    """Kernel A on rows ``x`` against flat columns ``dims``/``thrs``,
    bit-exact against its plain version (words and margins), timed by
    events, by the profiler and on the host. The bound reads each row's
    distinct sampled coordinates (not the whole row), the columns, and
    writes the int64 words (and the margins)."""
    import torch

    from repro_torch.kernels.hash_pack import ops as hp, ref as hp_ref

    t, d = x.shape
    m_cols = dims.shape[0]

    def fn():
        return hp.bitsample_pack(x, dims, thrs, margins=margins)

    got, want = fn(), hp_ref.bitsample_pack_ref(x, dims, thrs, margins=margins)
    got, want = (got, want) if margins else ((got,), (want,))
    need(all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)),
         f"bitsample_pack ({case}) differs from its plain version")
    sampled = int(torch.unique(dims[torch.isfinite(thrs)]).numel())
    nbytes = t * sampled * 4 + m_cols * 8 + t * (m_cols // 32) * 8 + (t * m_cols * 4 if margins else 0)
    b_ms, b_by = bound(nbytes, t * m_cols * (2 if margins else 1))
    return dict(case=case, shape=f"x ({t}, {d}), {m_cols} columns" + (", margins" if margins else ""),
                exact=True, ms=timed_ms(fn, 30, flush), **device_profile(fn), host_ms=host_ms(fn),
                plain_ms=timed_ms(lambda: hp_ref.bitsample_pack_ref(x, dims, thrs, margins=margins), 5, flush),
                bound_ms=b_ms, bound_by=b_by)


def tail_candidates(data, outer_l, inner, cfg, qs):
    """The gather's (Q, C) candidate rows for queries ``qs`` on an index of
    ``data`` with outer tables ``outer_l``, built on the plain backend."""
    from repro_torch.core import pipeline

    cfg_t = cfg.replace(backend="torch")
    index = pipeline.build_from_params(data, outer_l, inner, cfg_t)
    pk, ik = pipeline._stage_hash(index, qs, cfg_t, pipeline.get_backend("torch"))
    cand, _ = pipeline._stage_gather_fast(index, cfg_t, pk, ik)
    return cand.contiguous()


def d_case(case: str, data, qs, cand, cfg, flush) -> dict:
    """Kernel D on a chunk's raw (Q, C) candidate rows against its plain
    version (counters equal, top-k tie-aware within RTOL/ATOL), timed by
    events, by the profiler and on the host, with its bound: the candidate
    rows, the queries, the gathered data rows and the outputs, and 3
    operations per gathered coordinate plus the dedup's: the merge
    network's compare-exchanges in the fused form, one per candidate column
    in the hash form."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.kernels.query_fused import ops as qf, ref as qf_ref

    run, k = pipeline._fused_run(cfg), cfg.k
    (q_n, c_w), d = cand.shape, data.shape[1]
    cc = pipeline._compact_width(cfg, c_w, data.shape[0])

    def fn():
        return qf.query_tail(data, qs, cand, run=run, c_comp=cc, k=k)

    out_k, out_r = fn(), qf_ref.query_tail_ref(data, qs, cand, c_comp=cc, k=k)
    need(torch.equal(out_k[2], out_r[2]) and torch.equal(out_k[3], out_r[3]), f"query_tail ({case}) counters differ")
    need_topk(out_k[0], out_k[1], out_r[0], out_r[1], point_dist_of(data, qs), f"query_tail ({case}) top-k differs")
    gathered = int(out_r[2].clamp(max=cc).sum())
    form = qf.launch_shape(q_n, c_w, d, run, cc, k=k, aligned16=data.data_ptr() % 16 == 0, sms=132)["route"]
    cp, start = merge_width(c_w, run)
    dedup_ops = q_n * merge_exchanges(cp, start) if form == "fused" else cand.numel()
    b_ms, b_by = bound(cand.numel() * 4 + q_n * d * 4 + gathered * d * 4 + q_n * (k * 8 + 8),
                       3 * gathered * d + dedup_ops)
    return dict(case=case, form=form,
                shape=f"cand ({q_n}, {c_w}), d {d}, run {run}, c_comp {cc}, k {k}, {gathered} rows gathered",
                exact=bool(torch.equal(out_k[1], out_r[1])),
                max_abs_err=float((out_k[0] - out_r[0]).abs().nan_to_num(0.0).max()),
                ms=timed_ms(fn, 30, flush), **device_profile(fn), host_ms=host_ms(fn),
                plain_ms=timed_ms(lambda: qf_ref.query_tail_ref(data, qs, cand, c_comp=cc, k=k), 5, flush),
                bound_ms=b_ms, bound_by=b_by)


def d_order_check(data, qs, cand, cfg) -> dict:
    """Kernel D's one summation order: each query of a chunk, run alone and
    in launches of 7, gives the chunk's ``kd``/``ki`` bit for bit."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.kernels.query_fused import ops as qf

    run, k = pipeline._fused_run(cfg), cfg.k
    cc = pipeline._compact_width(cfg, cand.shape[1], data.shape[0])
    q_n = qs.shape[0]

    def tail(lo: int, hi: int):
        return qf.query_tail(data, qs[lo:hi].contiguous(), cand[lo:hi].contiguous(), run=run, c_comp=cc, k=k)[:2]

    kd, ki = tail(0, q_n)
    same = {}
    for name, step in (("one_query_per_launch", 1), ("launches_of_7", 7)):
        parts = [tail(i, min(i + step, q_n)) for i in range(0, q_n, step)]
        same[name] = bool(torch.equal(kd, torch.cat([p[0] for p in parts]))
                          and torch.equal(ki, torch.cat([p[1] for p in parts])))
    need(all(same.values()), f"query_tail answers depend on the launch at d={data.shape[1]}: {same}")
    return dict(d=data.shape[1], queries=q_n, **same)


def dslsh_path_cases(data, queries, cfg, flush) -> dict:
    """Kernels A and D at the DSLSH paths' shapes: A on a build chunk
    (4,096 rows of one grid cell, its 4 tables' 128 columns), a 50-query
    chunk (words) and the multiprobe query's chunk (words and margins over a
    single shard's 16 tables); D on a grid cell's 50-query chunk and the
    f32 single shard's (every point), with D's one-order check on the
    grid chunk, and in its hash form on the ``routes`` phase's three wide
    chunks. Returns the cases (``a``, ``d``, ``order``) and the two
    chunks' candidate rows (``cell_cand``, ``full_cand``)."""
    import torch

    from repro_torch.core import hashing, pipeline
    from repro_torch.kernels.hash_pack import ops as hp

    n_loc = data.shape[0] // NU
    cell = data[:n_loc].contiguous()
    outer, inner = pipeline.make_family(torch.Generator().manual_seed(SEED), data.shape[1], cfg, data.device)
    l_loc = cfg.L_out // P
    outer0 = hashing.BitSampleParams(outer.dims[:l_loc], outer.thrs[:l_loc], outer.salts[:l_loc])
    qs = queries[: cfg.query_chunk].contiguous()
    dims0, thrs0 = hp.bitsample_columns(outer0)
    dims_all, thrs_all = hp.bitsample_columns(outer)
    a = [a_case("build_chunk", cell[: cfg.build_chunk].contiguous(), dims0, thrs0, flush),
         a_case("query_chunk", qs, dims0, thrs0, flush),
         a_case("multiprobe_query_chunk", qs, dims_all, thrs_all, flush, margins=True)]
    cell_cand = tail_candidates(cell, outer0, inner, cfg, qs)
    d = [d_case("grid_chunk", cell, qs, cell_cand, cfg, flush)]
    order = [d_order_check(cell, qs, cell_cand, cfg)]
    full_cand = tail_candidates(data, outer, inner, cfg, qs)
    d.append(d_case("f32_payload_chunk", data, qs, full_cand, cfg, flush))
    # D's hash form at the routes phase's wide shapes (131,072-point shard)
    part = data[: min(131_072, data.shape[0])].contiguous()
    for case in ("merge_width_32768", "merge_width_32768_k40", "d_over_shared_memory"):
        cfg_h = cfg.replace(**ROUTE_CASES[case])
        outer_h, inner_h = pipeline.make_family(torch.Generator().manual_seed(SEED), data.shape[1], cfg_h, data.device)
        d.append(d_case(f"hash_{case}", part, qs, tail_candidates(part, outer_h, inner_h, cfg_h, qs), cfg_h, flush))
    return dict(a=a, d=d, order=order, cell_cand=cell_cand, full_cand=full_cand)


def knn_path_cases(keys, hq, scfg, p: int, flush) -> tuple[list, list, list]:
    """Kernels A and D at the kNN-LM path's shapes, on ``keys``, one grid
    cell's datastore keys (d = 4,096), and query rows ``hq`` (at least 50):
    A on the hook's one row and a build chunk of 4,096 keys (the cell's 2
    tables' 64 columns); D on the hook's one query (the first of ``hq``)
    and on a 50-query chunk (also at k = 40, past the warp top-k), with D's
    one-order check on that chunk.
    Returns (A cases, D cases, D order checks)."""
    import torch

    from repro_torch.core import hashing, pipeline
    from repro_torch.kernels.hash_pack import ops as hp

    outer, inner = pipeline.make_family(torch.Generator().manual_seed(SEED), keys.shape[1], scfg, keys.device)
    l_loc = scfg.L_out // p
    outer0 = hashing.BitSampleParams(outer.dims[:l_loc], outer.thrs[:l_loc], outer.salts[:l_loc])
    dims, thrs = hp.bitsample_columns(outer0)
    a = [a_case("hook_row", hq[:1].contiguous(), dims, thrs, flush),
         a_case("knn_build_chunk", keys[: scfg.build_chunk].contiguous(), dims, thrs, flush)]
    qs = hq[:50].contiguous()
    cand = tail_candidates(keys, outer0, inner, scfg, qs)
    d = [d_case("hook_query", keys, qs[:1], cand[:1].contiguous(), scfg, flush),
         d_case("knn_chunk", keys, qs, cand, scfg, flush),
         d_case("knn_chunk_k40", keys, qs, cand, scfg.replace(k=40), flush)]  # D's k > 32 sort at d = 4,096
    return a, d, [d_order_check(keys, qs, cand, scfg)]


def payload_kernel_rows(data, queries, cfg, cand, flush) -> list[dict]:
    """Kernel E, per payload format, against its plain version on the first
    50-query chunk of a plain-backend single shard over every point (its
    candidate rows ``cand``), at the path's ``c_comp`` and with a forced
    overflow (``c_comp=64``)."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.runtime import payload as payload_mod

    qs = queries[: cfg.query_chunk].contiguous()
    cc = pipeline._compact_width(cfg, cand.shape[1], data.shape[0])
    rows = []
    for fmt in ("f16", "i8"):
        pl = payload_mod.make_payload(data, fmt)
        row = e_case(fmt, data, pl, qs, cand, cfg, cc, flush)
        rows.append(dict(
            name=f"query_tail_payload.{fmt}", kernel="query_tail_payload", route="cuda",
            source="src/repro_torch/csrc/query_payload.cu",
            replaces="src/repro/kernels/query_fused/query_fused.py:592",
            also_replaces="src/repro/kernels/query_fused/query_fused.py:564",
            **{key: v for key, v in row.items() if key != "case"},
            library_ms=None, overflow_case=e_case(fmt, data, pl, qs, cand, cfg, 64, flush),
        ))
        del pl
    return rows


def e_case(fmt: str, data, pl, qs, cand, cfg, cc: int, flush) -> dict:
    """Kernel E on a chunk's (Q, C) rows with payload ``pl`` and compact
    width ``cc``: ``comparisons``, ``overflow`` and ``rerank_misses`` equal
    to the plain version's, the top-k tie-aware, every row with no miss
    equal to kernel D's bits on the same rows; timed by events, by the
    profiler and on the host. The bound: the candidate rows, the queries,
    each compacted row's quantized coordinates and meta, each shortlisted
    row's f32 coordinates and the outputs, moved once; one operation per
    candidate column for the dedup and 3 per coordinate of the two L1
    passes."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.kernels.query_fused import ops as qf, ref as qf_ref
    from repro_torch.runtime import payload as payload_mod

    (q_n, c_w), d, k = cand.shape, data.shape[1], cfg.k
    run = pipeline._fused_run(cfg)
    args = (data, pl.qdata, pl.meta, qs, cand)
    kw = dict(c_comp=cc, c_rerank=C_RERANK, k=k)

    def fn():
        return qf.query_tail_payload(*args, run=run, **kw)

    out_k, out_r = fn(), qf_ref.query_tail_payload_ref(*args, **kw)
    for i, what in ((2, "comparisons"), (3, "overflow"), (4, "rerank_misses")):
        need(torch.equal(out_k[i], out_r[i]), f"query_tail_payload ({fmt}, c_comp {cc}) {what} differ from its plain version")
    exact = bool(torch.equal(out_k[0], out_r[0]) and torch.equal(out_k[1], out_r[1]))
    if not exact:
        need_topk(out_k[0], out_k[1], out_r[0], out_r[1], point_dist_of(data, qs),
                  f"query_tail_payload ({fmt}, c_comp {cc}) top-k differs")
    # the certificate at kernel level: a row with no miss equals kernel D's bit for bit
    out_d = qf.query_tail(data, qs, cand, run=run, c_comp=cc, k=k)
    ok = out_k[4] == 0
    need(torch.equal(out_k[0][ok], out_d[0][ok]) and torch.equal(out_k[1][ok], out_d[1][ok]),
         f"query_tail_payload ({fmt}, c_comp {cc}) rows with no miss differ from query_tail")
    gathered = int(out_r[2].clamp(max=cc).sum())
    shortlisted = int(out_r[2].clamp(max=min(C_RERANK, cc)).sum())
    itemsize = payload_mod.payload_itemsize(fmt)
    b_ms, b_by = bound(
        cand.numel() * 4 + q_n * d * 4 + gathered * (d * itemsize + 8) + shortlisted * d * 4 + q_n * (k * 8 + 12),
        cand.numel() + 3 * d * (gathered + shortlisted),
    )
    return dict(case=f"c_comp {cc}",
                shape=(f"cand ({q_n}, {c_w}), run {run}, c_comp {cc}, c_rerank {C_RERANK}, k {k}, {fmt} rows,"
                       f" {gathered} rows gathered, {shortlisted} reranked"),
                exact=exact, rerank_misses=int(out_k[4].sum()), overflow=int(out_k[3].sum()),
                zero_miss_rows_equal_to_query_tail=int(ok.sum()),
                max_abs_err=float((out_k[0] - out_r[0]).abs().nan_to_num(0.0).max()),
                ms=timed_ms(fn, 50, flush), **device_profile(fn), host_ms=host_ms(fn),
                plain_ms=timed_ms(lambda: qf_ref.query_tail_payload_ref(*args, **kw), 10, flush),
                bound_ms=b_ms, bound_by=b_by)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    run(torch.device("cuda"), N, NQ)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev, n: int, nq: int, lm_smoke: bool = False, ds_seqs: int = DS_SEQS) -> None:
    """Every phase after the device check, on ``dev`` at ``n`` points and
    ``nq`` queries, the kNN-LM phases on granite-8b (its smoke config with
    ``lm_smoke``) over ``ds_seqs`` datastore sequences; prints the kernels
    line last."""
    import torch

    from repro_torch import dslsh
    from repro_torch.core import distributed as D
    from repro_torch.core import pipeline, predict
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0, libraries=[p.name for p in libs.values()])

    t0 = time.perf_counter()
    pts, labs, qx, qy = synth(n, nq)
    data = torch.as_tensor(pts, device=dev)
    queries = torch.as_tensor(qx, device=dev)
    emit("data", n=n, queries=nq, seconds=time.perf_counter() - t0)

    cfg = dslsh.make_config(**CFG, backend="cuda")
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    rows = kernels_phase(data, queries, cfg, lambda: scratch.zero_())
    del scratch
    emit("kernels_checked", kernels=[r["name"] for r in rows])

    # main path: build + query through the user's entry points
    deploy = dslsh.grid(nu=NU, p=P)
    sync(dev)
    main_shapes: dict = {}
    with launch_shapes(main_shapes):
        _build.reset_launches()
        t0 = time.perf_counter()
        index = dslsh.build(SEED, pts, cfg, deploy, dev)
        sync(dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = index.query(qx)
        sync(dev)
        query_s = time.perf_counter() - t0
        main_launches = dict(_build.LAUNCHES)
    for name in ("bitsample_pack", "proj_sign_pack", "query_tail"):
        need(main_launches.get(name, 0) > 0, f"main path never launched {name}")
    need(res.knn_idx.shape == (nq, cfg.k) and res.knn_dist.shape == (nq, cfg.k), "result shape")
    found = res.knn_idx >= 0
    need(bool(torch.isfinite(res.knn_dist[found]).all()) and bool((res.knn_idx < n).all()), "result values")
    labels = torch.as_tensor(labs, device=dev)
    truth = torch.as_tensor(qy, device=dev)
    mcc = float(predict.mcc(predict.predict_batch(labels, res.knn_idx, res.knn_dist), truth))
    t0 = time.perf_counter()
    pkd, pki, pcomps = dslsh.pknn_query(data, queries, cfg.k, deploy.grid)
    sync(dev)
    pknn_s = time.perf_counter() - t0
    mcc_p = float(predict.mcc(predict.predict_batch(labels, pki, pkd), truth))
    med = float(res.max_comparisons_per_cell.to(torch.float32).median())
    per_proc = int(pcomps[0, 0, 0])
    emit(
        "main_path", n=n, queries=nq, grid=[NU, P], backend="cuda",
        build_s=build_s, query_s=query_s, us_per_query=query_s / nq * 1e6,
        median_max_comparisons_per_cell=med, pknn_comparisons_per_processor=per_proc,
        speedup=per_proc / max(med, 1.0), mcc_dslsh=mcc, mcc_pknn=mcc_p,
        pknn_s=pknn_s, overflow_cells=res.overflow_cells, launches=main_launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None,
    )
    need(mcc >= mcc_p - 0.1, f"DSLSH MCC {mcc} below PKNN's {mcc_p} by more than 0.1")

    # where the query time goes: a profiled grid query of 200 queries
    # (40 cells x 4 chunks)
    emit("query_profile", **profile_query(dev, lambda: index.query(qx[:200])))

    # multiprobe: the words+margins launch on the query path
    n_mp = min(131_072, n)
    cfg_mp = cfg.replace(multiprobe=2)
    nq_mp = 500
    single = dslsh.build(SEED, pts[:n_mp], cfg_mp, dslsh.single(), dev)
    sync(dev)
    _build.reset_launches()  # count the query's launches only
    res_mp = single.query(qx[:nq_mp])
    sync(dev)
    mp_launches = dict(_build.LAUNCHES)
    ref_mp = pipeline.query_batch(
        single.pipeline_index, single._state["data"], queries[:nq_mp], cfg_mp.replace(backend="torch")
    )
    chunks = -(-nq_mp // cfg_mp.query_chunk)
    need(mp_launches.get("bitsample_pack.margins", 0) == chunks,
         f"multiprobe query made {mp_launches.get('bitsample_pack.margins', 0)} words+margins launches, not one per chunk ({chunks})")
    need(torch.equal(res_mp.comparisons[0, 0], ref_mp.comparisons), "multiprobe comparisons differ")
    need_topk(res_mp.knn_dist, res_mp.knn_idx, ref_mp.knn_dist, ref_mp.knn_idx,
              point_dist_of(single._state["data"], queries), "multiprobe top-k differs")
    emit("multiprobe", n=n_mp, queries=nq_mp, query_launches=mp_launches,
         mean_comparisons=float(res_mp.comparisons.to(torch.float32).mean()))
    del single, res_mp, ref_mp
    route_launches = routes_phase(dev, pts[:n_mp], qx[:nq_mp], queries[:nq_mp], cfg)

    # backends agree on the card: the plain path on the same grid index
    nq_b = 256
    ref = D.grid_query(
        index.pipeline_index, index._state["data"], queries[:nq_b],
        cfg.replace(backend="torch"), deploy.grid,
    )
    need(torch.equal(ref.comparisons, res.comparisons[:, :, :nq_b]), "torch/cuda comparisons differ")
    need(torch.equal(ref.compaction_overflow, res.compaction_overflow[:, :, :nq_b]), "torch/cuda overflow differs")
    need_topk(res.knn_dist[:nq_b], res.knn_idx[:nq_b], ref.knn_dist, ref.knn_idx,
              point_dist_of(index._state["data"], queries), "torch/cuda top-k differs")
    emit("backends_agree", queries=nq_b, knn_idx_identical=bool(torch.equal(ref.knn_idx, res.knn_idx[:nq_b])),
         max_abs_dist_err=float((ref.knn_dist - res.knn_dist[:nq_b]).abs().nan_to_num(0.0).max()))

    del ref
    payload_launches = payload_phase(dev, pts, qx, labels, truth, cfg, mcc_p)
    quickstart_launches = quickstart_phase(dev)
    routed_launches = routed_phase(dev, index, res, pts, qx, queries, cfg)
    icu_launches = icu_serve_phase(dev, index, qx, cfg)
    del index
    mesh_launches = mesh_phase(dev, pts, qx, res, cfg, main_launches)
    del res
    stream_launches = stream_phase(dev, pts, labs, qx, cfg, n)
    del data, queries, labels, truth

    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    f_row, knn, lm_launches = knn_lm_phase(dev, lm_smoke, ds_seqs, lambda: scratch.zero_())
    del scratch
    serve_launches = serve_phase(["--arch", LM_ARCH] + (["--smoke", "--device", dev.type] if lm_smoke else []))
    twin_launches = serve_twin_phase(dev)
    families_launches = families_phase(dev, lm_smoke)
    train_launches = train_phase(dev, lm_smoke)
    families_train_launches = families_train_phase(dev, lm_smoke)
    lm_mesh_launches = lm_mesh_phase(dev, lm_smoke)
    for r in rows:
        extra = knn.get(r["name"])
        if extra is None:
            continue
        for key in ("path_shapes", "one_order"):  # DSLSH shapes first, then the datastore's width
            if key in extra:
                extra[key] = r.get(key, []) + extra[key]
        extra["main_launch_shapes"] = main_shapes.get(r["name"], {})
        r.update(extra)
    rows.append(f_row)

    for r in rows:
        if r.get("kernel") == "query_tail_payload":  # runs on the payload path only
            r["launches"] = payload_launches.get(r["name"], 0)
        elif r["name"] == "flash_attention":  # runs on the kNN-LM path only
            r["launches"] = lm_launches.get(r["name"], 0)
        else:
            r["launches"] = main_launches.get(r["name"], 0)
            r["multiprobe_query_launches"] = mp_launches.get(r["name"], 0)
        r["payload_query_launches"] = payload_launches.get(r["name"], 0)
        r["routes_launches"] = route_launches.get(r["name"], 0)
        r["quickstart_launches"] = quickstart_launches.get(r["name"], 0)
        r["routed_launches"] = routed_launches.get(r["name"], 0)
        r["icu_serve_launches"] = icu_launches.get(r["name"], 0)
        r["mesh_launches"] = mesh_launches.get(r["name"], 0)
        r["stream_launches"] = stream_launches.get(r["name"], 0)
        r["knn_lm_launches"] = lm_launches.get(r["name"], 0)
        r["serve_launches"] = serve_launches.get(r["name"], 0)
        r["serve_twin_launches"] = twin_launches.get(r["name"], 0)
        r["families_launches"] = families_launches.get(r["name"], 0)
        r["train_launches"] = train_launches.get(r["name"], 0)
        r["families_train_launches"] = families_train_launches.get(r["name"], 0)
        r["lm_mesh_launches"] = lm_mesh_launches.get(r["name"], 0)
    print(json.dumps({"kernels": rows}), flush=True)


def routes_phase(dev, pts, qx, queries, cfg) -> dict:
    """Each of ``ROUTE_CASES`` on a single shard over ``pts`` (131,072 points)
    through the handle's entry points on the ``"cuda"`` backend, queried
    with ``qx`` (500 queries) as f32 and as i8. Every chunk must launch
    kernel D once, in the form the case calls for (``query_tail.hash``
    counts the hash form), and no plain version may run: kernel C, the
    staged form's, never launches. f32 is held against the
    ``"torch"`` backend on the card (counters exact, top-k tie-aware); i8
    against the payload tail's plain version chunk by chunk, and its rows
    with no rerank miss equal the f32 answer bit for bit. Returns the
    kernels' launches over all cases."""
    import torch

    from repro_torch import dslsh
    from repro_torch.core import pipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels.query_fused import ref as qf_ref

    n, nq = pts.shape[0], qx.shape[0]
    chunks = -(-nq // cfg.query_chunk)
    launches: dict[str, int] = {}
    for case, kw in ROUTE_CASES.items():
        cfg_r = cfg.replace(**kw)
        index = dslsh.build(SEED, pts, cfg_r, dslsh.single(), dev)
        data = index._state["data"]
        sync(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        res = index.query(qx)
        sync(dev)
        f32_s = time.perf_counter() - t0
        got = dict(_build.LAUNCHES)
        hashed = got.get("query_tail.hash", 0)
        routes = {"fused": got.get("query_tail", 0) - hashed, "hash": hashed}
        want = ROUTE_EXPECTED[case]
        need(routes[want] == chunks and got.get("query_tail", 0) == chunks,
             f"routes {case}: chunks by form of kernel D {routes}, not all {chunks} {want}")
        need(got.get("l1_topk", 0) == 0, f"routes {case}: the staged form ran: {got}")
        ref = pipeline.query_batch(index.pipeline_index, data, queries, cfg_r.replace(backend="torch"))
        for what in ("comparisons", "compaction_overflow"):
            need(torch.equal(getattr(res, what)[0, 0], getattr(ref, what)), f"routes {case}: {what} differ from the torch backend")
        need_topk(res.knn_dist, res.knn_idx, ref.knn_dist, ref.knn_idx, point_dist_of(data, queries),
                  f"routes {case}: top-k differs from the torch backend")

        cfg_8 = cfg_r.replace(payload="i8", **ROUTE_I8.get(case, {}))
        index8 = dslsh.build(SEED, pts, cfg_8, dslsh.single(), dev)
        pl = index8._payload()
        sync(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        res8 = index8.query(qx)
        sync(dev)
        i8_s = time.perf_counter() - t0
        got8 = dict(_build.LAUNCHES)
        need(got8.get("query_tail_payload.i8", 0) == chunks, f"routes {case}: i8 ran {got8}, not one payload tail a chunk")
        cfg_t = cfg_r.replace(backend="torch")
        for lo in range(0, nq, cfg.query_chunk):
            qc = queries[lo : lo + cfg.query_chunk]
            pk, ik = pipeline._stage_hash(index8.pipeline_index, qc, cfg_t, pipeline.get_backend("torch"))
            cand, _ = pipeline._stage_gather_fast(index8.pipeline_index, cfg_t, pk, ik)
            cc = pipeline._compact_width(cfg_8, cand.shape[1], n)
            out = qf_ref.query_tail_payload_ref(data, pl.qdata, pl.meta, qc, cand, c_comp=cc,
                                                c_rerank=cfg_8.c_rerank, k=cfg_8.k)
            sl = slice(lo, lo + qc.shape[0])
            for i, what in ((2, "comparisons"), (3, "compaction_overflow"), (4, "rerank_misses")):
                need(torch.equal(getattr(res8, what)[0, 0, sl], out[i]),
                     f"routes {case}: i8 {what} differ from the plain version in chunk {lo}")
            need_topk(res8.knn_dist[sl], res8.knn_idx[sl], out[0], out[1], point_dist_of(data, qc),
                      f"routes {case}: i8 top-k differs from the plain version in chunk {lo}")
        ok = res8.rerank_misses[0, 0] == 0
        need(torch.equal(res8.knn_idx[ok], res.knn_idx[ok]) and torch.equal(res8.knn_dist[ok], res.knn_dist[ok]),
             f"routes {case}: an i8 query with no rerank miss differs from the f32 answer")
        emit("routes", case=case, config=dict(kw, **ROUTE_I8.get(case, {})), n=n, queries=nq,
             columns=cfg_r.L_out * cfg_r.slot, c_comp=pipeline._compact_width(cfg_r, cfg_r.L_out * cfg_r.slot, n),
             chunks_by_route=routes, f32_launches=got, i8_launches=got8, f32_query_s=f32_s, i8_query_s=i8_s,
             mean_comparisons=float(res.comparisons.to(torch.float32).mean()),
             overflow_queries=int((res.compaction_overflow > 0).sum()),
             i8_rerank_miss_total=res8.rerank_miss_total, i8_certified_queries=int(ok.sum()))
        for name, c in list(got.items()) + list(got8.items()):
            launches[name] = launches.get(name, 0) + c
        del index, index8, res, res8, ref, pl
    return launches


def payload_phase(dev, pts, qx, labels, truth, cfg, mcc_pknn: float) -> dict:
    """The compressed-payload path on the user's entry points: one shard over
    every point, built and queried as f32, f16 and i8 in turn (each index
    freed before the next). A query with no rerank miss must equal the f32
    handle's answer bit for bit, and each compressed MCC may fall at most
    0.01 below the f32 shard's. Returns the payload tail's launches over
    both compressed queries."""
    import torch

    from repro_torch import dslsh
    from repro_torch.core import pipeline, predict
    from repro_torch.kernels import _build
    from repro_torch.runtime import payload as payload_mod

    n, nq = pts.shape[0], qx.shape[0]
    chunks = -(-nq // cfg.query_chunk)
    launches: dict[str, int] = {}
    f32 = None
    for fmt in ("f32", "f16", "i8"):
        cfg_p = cfg.replace(payload=fmt, c_rerank=C_RERANK)
        sync(dev)
        t0 = time.perf_counter()
        index = dslsh.build(SEED, pts, cfg_p, dslsh.single(), dev)
        index._payload()  # quantize once, as part of the build
        sync(dev)
        build_s = time.perf_counter() - t0
        _build.reset_launches()
        t0 = time.perf_counter()
        res = index.query(qx)
        sync(dev)
        query_s = time.perf_counter() - t0
        got = dict(_build.LAUNCHES)
        fused = "query_tail" if fmt == "f32" else f"query_tail_payload.{fmt}"
        need(got.get(fused, 0) == chunks, f"payload {fmt}: {got.get(fused, 0)} launches of {fused}, not one per chunk ({chunks})")
        need(res.knn_idx.shape == (nq, cfg.k) and bool((res.knn_idx < n).all()), f"payload {fmt}: result shape or values")
        found = res.knn_idx >= 0
        need(bool(torch.isfinite(res.knn_dist[found]).all()), f"payload {fmt}: non-finite distances")
        mcc = float(predict.mcc(predict.predict_batch(labels, res.knn_idx, res.knn_dist), truth))
        cc = pipeline._compact_width(cfg_p, cfg_p.L_out * cfg_p.slot, n)
        fields = dict(
            format=fmt, n=n, queries=nq, c_rerank=C_RERANK, c_comp=cc, build_s=build_s, query_s=query_s,
            us_per_query=query_s / nq * 1e6,
            median_comparisons=float(res.comparisons.to(torch.float32).median()),
            overflow_queries=int((res.compaction_overflow > 0).sum()),
            rerank_miss_total=res.rerank_miss_total,
            tail_gather_bytes_per_query=payload_mod.tail_gather_bytes(cc, C_RERANK, pts.shape[1], fmt),
            payload_bytes=index.memory_report().components["payload"],
            mcc=mcc, mcc_pknn=mcc_pknn, launches=got,
        )
        if fmt == "f32":
            need(res.rerank_misses is None, "the f32 shard reports rerank misses")
            f32 = (res.knn_idx, res.knn_dist, mcc)
        else:
            for name, c in got.items():
                if name.startswith("query_tail_payload"):
                    launches[name] = launches.get(name, 0) + c
            ok = res.rerank_misses[0, 0] == 0
            same = bool(torch.equal(res.knn_idx[ok], f32[0][ok]) and torch.equal(res.knn_dist[ok], f32[1][ok]))
            need(same, f"payload {fmt}: a query with no rerank miss differs from the f32 shard")
            need(mcc >= f32[2] - 0.01, f"payload {fmt}: MCC {mcc} more than 0.01 below the f32 shard's {f32[2]}")
            fields.update(
                certified_queries=int(ok.sum()), mcc_f32=f32[2],
                knn_idx_identical_to_f32=bool(torch.equal(res.knn_idx, f32[0])),
            )
        emit("payload", **fields)
        # where this query's time goes: a profiled 200-query window
        emit("payload_profile", format=fmt, **profile_query(dev, lambda: index.query(qx[:200])))
        del index, res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------- the ICU deployment slice


def _load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quickstart_phase(dev) -> dict:
    """``examples/torch_quickstart.main`` at the example's full size: 8
    records x 60,000 beats from the port's ABP generator, ``grid(nu=2,
    p=8)`` on the ``"cuda"`` backend. DSLSH's MCC may fall at most 0.1
    below PKNN's. Returns the kernels' launches."""
    import torch

    from repro_torch.data import abp
    from repro_torch.kernels import _build

    mapv, valid = abp.synth_dataset_beats(0, 8, abp.ABPConfig(n_beats=60_000, episode_rate=1.0 / 2500.0))
    _build.reset_launches()
    out = _load_example("torch_quickstart").main(mapv, valid, device=dev)
    launches = dict(_build.LAUNCHES)
    for name in ("bitsample_pack", "proj_sign_pack", "query_tail"):
        need(launches.get(name, 0) > 0, f"quickstart never launched {name}")
    need(bool(torch.isfinite(torch.tensor([out["mcc"], out["mcc_pknn"]])).all()), "quickstart MCC not finite")
    need(out["mcc"] >= out["mcc_pknn"] - 0.1, f"quickstart MCC {out['mcc']} below PKNN's {out['mcc_pknn']} by more than 0.1")
    emit("quickstart", records=8, beats=60_000, n=out["n"], queries=out["queries"], grid=[2, 8],
         mcc_dslsh=out["mcc"], mcc_pknn=out["mcc_pknn"],
         median_max_comparisons_per_processor=out["median_max_comparisons"],
         pknn_comparisons_per_processor=out["pknn_comparisons_per_processor"], speedup=out["speedup"],
         build_s=out["build_s"], query_s=out["query_s"], us_per_query=out["query_s"] / out["queries"] * 1e6,
         overflow_cells=out["overflow_cells"], launches=launches)
    return launches


def routed_phase(dev, index, res, pts, qx, queries, cfg) -> dict:
    """Routing on the main path's 1.37 M-point ``grid(nu=10, p=4)``:
    ``index.with_routing()`` answers the 2,000 queries with ``knn_idx``,
    ``comparisons`` and ``compaction_overflow`` equal to the broadcast
    answer ``res``; then a build with ``replication=2`` and a
    ``max_cells=8`` query over 256 queries are held against the
    ``"torch"`` backend on the same plan (counters exact, top-k tie-aware).
    Returns the kernels' launches of the two routed queries."""
    import torch

    from repro_torch import dslsh
    from repro_torch.core import distributed as D
    from repro_torch.kernels import _build

    nq = qx.shape[0]
    routed = index.with_routing()
    sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    rres, stats = routed.query_with_stats(qx)
    sync(dev)
    query_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for what in ("knn_idx", "comparisons", "compaction_overflow"):
        need(torch.equal(getattr(rres, what), getattr(res, what)), f"routed: {what} differs from the broadcast answer")
    need(bool((~rres.routed & (res.comparisons > 0)).sum() == 0), "routed: a skipped cell had candidates")
    per_query = rres.routed.to(torch.float32).mean(dim=(0, 1))

    t0 = time.perf_counter()
    rep = dslsh.build(SEED, pts, cfg, dslsh.grid(nu=NU, p=P, replication=2), dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    nq_b = 256
    before = dict(_build.LAUNCHES)
    capped = rep.query(qx[:nq_b], max_cells=8)
    sync(dev)
    for name, c in _build.LAUNCHES.items():
        launches[name] = launches.get(name, 0) + c - before.get(name, 0)
    ref = D.grid_query(rep.pipeline_index, rep._state["data"], queries[:nq_b], cfg.replace(backend="torch"),
                       rep.grid, plan=rep.plan, max_cells=8)
    for what in ("comparisons", "compaction_overflow", "routed"):
        need(torch.equal(getattr(capped, what), getattr(ref, what)), f"routed max_cells=8: {what} differ from the torch backend")
    need_topk(capped.knn_dist, capped.knn_idx, ref.knn_dist, ref.knn_idx, point_dist_of(rep._state["data"], queries),
              "routed max_cells=8: top-k differs from the torch backend")
    need(bool((capped.routed.sum(dim=(0, 1)) <= 8).all()), "routed: max_cells=8 probed more than 8 cells")
    emit("routed", n=pts.shape[0], queries=nq, grid=[NU, P], query_s=query_s, us_per_query=query_s / nq * 1e6,
         routed_frac=rres.routed_frac, median_routed_frac=float(per_query.median()),
         occupied_slot_share=float(routed.plan.occupancy.to(torch.float32).mean()),
         device_load=stats.device_load.tolist(), tree_routed_bytes=stats.payload["tree_routed_bytes"],
         flat_allgather_bytes=stats.payload["flat_allgather_bytes"],
         replication2_build_s=build_s, replicas=rep.plan.replicas.tolist(), n_devices=rep.plan.n_devices,
         max_cells8_queries=nq_b, max_cells8_routed_frac=capped.routed_frac,
         max_cells8_recall_at_k=float((capped.knn_idx[:, :, None] == res.knn_idx[:nq_b, None, :]).any(-1)
                                      .to(torch.float32).mean()),
         launches=launches)
    del routed, rep, capped, ref
    return launches


# the mesh phase: the replicated world's shard, batch and downed node
MESH_REP_N, MESH_REP_Q, MESH_REP_DOWN = 131_072, 500, [False, True]


def _add(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in sorted(set(a) | set(b))}


def _rank_sum(reports, pick) -> dict:
    """A launch dict summed over the ranks' reports."""
    out: dict = {}
    for r in reports:
        out = _add(out, pick(r))
    return out


def _mesh_checks(reports, what: str) -> list[dict]:
    """Every rank holds the same root family and the same answer to each
    query; returns rank 0's query steps."""
    need(len({r["family_digest"] for r in reports}) == 1, f"{what}: the ranks hash with different families")
    steps = reports[0]["steps"]
    for i, st in enumerate(steps):
        if st["op"] == "query":
            need(len({r["steps"][i]["digest"] for r in reports}) == 1, f"{what}: the ranks' answers to step {i} differ")
    return steps


def _answers_equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[f], b[f]) for f in a)


def mesh_phase(dev, pts, qx, res, cfg, main_launches: dict) -> dict:
    """The paper's 40 processors as 40 SPMD ranks over ``torch.distributed``
    (gloo on this one card), through ``launch.mesh.spawn`` running
    ``launch.mesh_job.run``: ``make_local_mesh(10, 4)`` on the main path's
    data (a memory-mapped ``.npy``), family (``SEED``) and config, queried
    with the all-gather Reducer and the tree, saved from the mesh, loaded
    back with ``load(device_mesh=)`` and queried again. Held against the
    main path's grid answer ``res`` (counters exact, top-k tie-aware, the
    reducers and the reload bit for bit), and the ranks' launches summed
    over a build and a query pass against ``main_launches``. Then
    ``make_replicated_mesh(2, 2, 2)``, routed, tree Reducer, on the
    ``routes`` shard (131,072 points, 500 queries) against the in-process
    routed ``grid(2, 2)``, bit for bit: plain, with node 1 dropped and with
    ``max_cells=2``. Returns the ranks' launches over both worlds."""
    import tempfile

    import torch

    from repro_torch import dslsh
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import mesh_job

    t_phase = time.perf_counter()
    ranks, nq = NU * P, qx.shape[0]
    grid_ans = {f: getattr(res, f).cpu().numpy() for f in ("knn_dist", "knn_idx", "comparisons",
                                                            "compaction_overflow", "routed")}
    cfg_kw = {**CFG, "backend": "cuda"}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        np.save(os.path.join(tmp, "points.npy"), pts)
        np.save(os.path.join(tmp, "queries.npy"), qx)
        ck = os.path.join(tmp, "mesh_index")
        job = mesh_job.MeshJob(
            mesh=(NU, P), data=os.path.join(tmp, "points.npy"), queries=os.path.join(tmp, "queries.npy"),
            cfg=cfg_kw, seed=SEED, device=dev.type,
            steps=(("query", {}), ("query", {"reducer": "tree"}), ("save", ck), ("load", ck), ("query", {})),
        )
        t0 = time.perf_counter()
        reports = launch_mesh.spawn(mesh_job.run, ranks, store_dir=os.path.join(tmp, "world40"), args=(job,),
                                    timeout_s=600)
        world_s = time.perf_counter() - t0
        bytes_on_disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ck) for f in fs)

        steps = _mesh_checks(reports, "mesh")
        ag, tree, loaded = (st["answer"] for st in steps if st["op"] == "query")
        need(_answers_equal(tree, ag), "mesh: the tree Reducer's answer differs from the all-gather's")
        need(_answers_equal(loaded, ag), "mesh: the loaded index answers otherwise than the one saved")
        for f in ("comparisons", "compaction_overflow", "routed"):
            need(np.array_equal(ag[f], grid_ans[f]), f"mesh: {f} differ from the main path grid's")
        pts_t, q_t = torch.from_numpy(pts), torch.from_numpy(qx)
        need_topk(torch.from_numpy(ag["knn_dist"]), torch.from_numpy(ag["knn_idx"]),
                  torch.from_numpy(grid_ans["knn_dist"]), torch.from_numpy(grid_ans["knn_idx"]),
                  point_dist_of(pts_t, q_t), "mesh: top-k differs from the main path grid's")
        build_sum = _rank_sum(reports, lambda r: r["build_launches"])
        pass_sums = [_rank_sum(reports, lambda r, i=i: r["steps"][i]["launches"])
                     for i, st in enumerate(steps) if st["op"] == "query"]
        for name in ("bitsample_pack", "proj_sign_pack", "query_tail"):
            need(build_sum.get(name, 0) + pass_sums[0].get(name, 0) > 0, f"mesh: no rank launched {name}")
        for i, ps in enumerate(pass_sums):
            need(_add(build_sum, ps) == _add(main_launches, {}),
                 f"mesh: build + query pass {i} launched {_add(build_sum, ps)}, the main path {main_launches}")

        def per_step(key, i, scale=1.0):
            return [r["steps"][i][key] * scale for r in reports]

        q_idx = [i for i, st in enumerate(steps) if st["op"] == "query"]
        red = [[r["steps"][i]["reducer"] for r in reports] for i in q_idx]
        emit(
            "mesh", ranks=ranks, mesh=[NU, P], backend="gloo", n=pts.shape[0], queries=nq,
            cpu_count=os.cpu_count(), world_s=world_s,
            build_s_max=max(r["build_s"] for r in reports), build_s_min=min(r["build_s"] for r in reports),
            us_per_query={name: max(per_step("seconds", i)) / nq * 1e6
                          for name, i in zip(("allgather", "tree", "allgather_loaded"), q_idx)},
            reducer_ms_per_batch_max={name: max(x["seconds"] for x in rs) * 1e3
                                      for name, rs in zip(("allgather", "tree", "allgather_loaded"), red)},
            reducer_ms_per_batch_min={name: min(x["seconds"] for x in rs) * 1e3
                                      for name, rs in zip(("allgather", "tree", "allgather_loaded"), red)},
            reducer_host_copy_bytes={name: sum(x["host_copy_bytes"] for x in rs)
                                     for name, rs in zip(("allgather", "tree", "allgather_loaded"), red)},
            reducer_sent_bytes={name: sum(x["sent_bytes"] for x in rs)
                                for name, rs in zip(("allgather", "tree", "allgather_loaded"), red)},
            save_s=max(per_step("seconds", 2)), load_s=max(per_step("seconds", 3)), bytes_on_disk=bytes_on_disk,
            peak_mem_bytes=[r.get("peak_mem_bytes") for r in reports],
            knn_idx_identical_to_grid=bool(np.array_equal(ag["knn_idx"], grid_ans["knn_idx"])),
            max_abs_dist_err_vs_grid=float(np.nan_to_num(np.abs(ag["knn_dist"] - grid_ans["knn_dist"])).max()),
            build_launches=build_sum, query_pass_launches=pass_sums[0], main_path_launches=main_launches,
            seconds=time.perf_counter() - t_phase,
        )
        t_phase = time.perf_counter()

        # replicated, routed and degraded: rep = 2 over a 2 x 2 grid
        pts_r, q_r = pts[:MESH_REP_N], qx[:MESH_REP_Q]
        np.save(os.path.join(tmp, "points_r.npy"), pts_r)
        np.save(os.path.join(tmp, "queries_r.npy"), q_r)
        job_r = mesh_job.MeshJob(
            mesh=(2, 2, 2), data=os.path.join(tmp, "points_r.npy"), queries=os.path.join(tmp, "queries_r.npy"),
            cfg=cfg_kw, seed=SEED, routed=True, device=dev.type,
            steps=(("query", {"reducer": "tree"}), ("query", {"reducer": "tree", "drop_mask": MESH_REP_DOWN}),
                   ("query", {"reducer": "tree", "max_cells": 2})),
        )
        t0 = time.perf_counter()
        reports_r = launch_mesh.spawn(mesh_job.run, 8, store_dir=os.path.join(tmp, "world8"), args=(job_r,),
                                      timeout_s=600)
        world_r_s = time.perf_counter() - t0
    steps_r = _mesh_checks(reports_r, "mesh_replicated")
    grid = dslsh.build(SEED, pts_r, cfg, dslsh.grid(nu=2, p=2, routed=True), dev)
    refs = (grid.query(q_r), grid.query(q_r, drop_mask=np.asarray(MESH_REP_DOWN)), grid.query(q_r, max_cells=2))
    fields = ("knn_dist", "knn_idx", "comparisons", "compaction_overflow", "routed")
    for case, st, ref in zip(("routed", "node_1_dropped", "max_cells_2"), steps_r, refs):
        for f in fields:
            need(np.array_equal(st["answer"][f], getattr(ref, f).cpu().numpy()),
                 f"mesh_replicated {case}: {f} differs from the in-process routed grid's")
    dropped = steps_r[1]["answer"]["knn_idx"]
    need(bool((dropped < pts_r.shape[0] // 2).all()), "mesh_replicated: node 1's points answered while it was dropped")
    need(bool((steps_r[2]["answer"]["routed"].sum(axis=(0, 1)) <= 2).all()), "mesh_replicated: max_cells=2 exceeded")
    rep_launches = _rank_sum(reports_r, lambda r: _add(r["build_launches"],
                                                       _rank_sum(r["steps"], lambda st: st.get("launches", {}))))
    emit(
        "mesh_replicated", ranks=8, mesh=[2, 2, 2], n=pts_r.shape[0], queries=q_r.shape[0], world_s=world_r_s,
        build_s_max=max(r["build_s"] for r in reports_r),
        us_per_query={c: max(r["steps"][i]["seconds"] for r in reports_r) / MESH_REP_Q * 1e6
                      for i, c in enumerate(("routed", "node_1_dropped", "max_cells_2"))},
        reducer_ms_per_batch_max=[max(r["steps"][i]["reducer"]["seconds"] for r in reports_r) * 1e3 for i in range(3)],
        routed_frac=[float(st["answer"]["routed"].mean()) for st in steps_r],
        peak_mem_bytes=[r.get("peak_mem_bytes") for r in reports_r],
        launches=rep_launches, seconds=time.perf_counter() - t_phase,
    )
    del grid, refs
    return _add(_add(build_sum, _rank_sum(pass_sums, lambda ps: ps)), rep_launches)


# the icu_serve phase: the front end's ladder and degradation levels, four
# stages of traffic (wave sizes in query rows: one wave a micro-batch, so the
# waves reach every rung), and the burst tenant's tight quota
ICU_LADDER = (8, 32, 128, 512)
ICU_DEGRADE = ((0.25, None), (0.0, 8))
ICU_WAVES = (1, 16, 96, 140)  # with the burst tenant's 16 rows in waves 2 and 4
ICU_STAGES = ("healthy", "failover", "lost_node", "repaired")
ICU_BURST = dict(rate_qps=20.0, burst=16.0, degrade_overdraft=8.0)
ICU_DT = 0.05  # simulated seconds between waves


def icu_serve_phase(dev, index, qx, cfg) -> dict:
    """The paper's latency-first ICU service under failures and load, at the
    main path's scale: ``index.with_routing(replication=2)`` (the 1.37 M-point
    ``grid(nu=10, p=4, replication=2)``) in an ``ElasticIndex`` and an
    ``ElasticController`` (migration checkpoints in a temp dir the phase
    deletes), behind a ``ServeFrontend`` with three tenants: ``bedside`` (1
    window a request), ``ward`` (4-16) and ``burst`` (8, a tight quota: some
    requests shed, some admitted degraded). After ``warmup()``, four stages
    on a simulated clock: healthy; one device of a replicated cell down
    (failover); every device of another node down (its cells lost, flagged);
    controller ticks until it repairs (restores the node's 4 cells, save →
    load → replan → swap), then healthy again. Checks: every undegraded
    response equals a direct ``Index.query`` of its micro-batch's rows on the
    healthy index bit for bit (``knn_idx``, ``knn_dist``, ``comparisons``),
    failover batches included, and every undegraded response equals a
    direct query of its own rows; every batch with a lost cell is flagged
    and has the cell's rows off in ``routed``; the swapped-in (loaded)
    index answers as the restored index it was saved from, and that one as
    the healthy index; the ledger balances; no kernel library is built
    after warmup; A, B and D launch, D once per cell and 50-query chunk of
    every micro-batch (no plain version). Returns the kernels' launches of
    the serving and the rebalance."""
    import shutil
    import tempfile

    import torch

    from repro_torch import obs
    from repro_torch.kernels import _build
    from repro_torch.runtime import elastic
    from repro_torch.serve import admission
    from repro_torch.serve import frontend as frontend_mod

    t_phase = time.perf_counter()
    ob = obs.Obs(trace=False)
    idx = index.with_routing(replication=2).with_obs(ob)
    plan = idx.plan
    cells = NU * P
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)  # git-ignored, beside the kernels
    workdir = tempfile.mkdtemp(prefix="icu-serve-", dir=os.path.join(ROOT, "build"))
    el = elastic.ElasticIndex(idx, deadline_s=1.0, now=0.0)
    ctl = elastic.ElasticController(el, elastic.ElasticConfig(
        deadline_s=1.0, repair_ticks=2, scale_ticks=1 << 30, workdir=workdir))
    fe = frontend_mod.ServeFrontend(el, frontend_mod.FrontendConfig(
        ladder=ICU_LADDER, degrade=ICU_DEGRADE, quotas=(("burst", admission.TenantQuota(**ICU_BURST)),)), obs=ob)
    t0 = time.perf_counter()
    warm = fe.warmup()
    sync(dev)
    warm_s = time.perf_counter() - t0
    retraces0 = obs.query_retraces()

    # every micro-batch's elastic answer, beside the rows it was asked
    batches: list = []
    query = el.query

    def recorded(queries, **kw):
        er = query(queries, **kw)
        batches.append((queries, er, kw.get("max_cells")))
        return er

    el.query = recorded
    rng = np.random.default_rng(SEED)
    pool = torch.as_tensor(qx, device=dev)
    launches: dict[str, int] = {}
    dead: set[int] = set()
    pump_ms: dict[int, list] = {r: [] for r in ICU_LADDER}
    stage_rows = {}
    tickets: list = []
    clock = [0.0]
    expected_d = [0]

    def count(fn):
        _build.reset_launches()
        out = fn()
        sync(dev)
        for name, c in _build.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + c
        return out

    def beat(t: float) -> None:
        for d in range(el.n_devices):
            if d not in dead:
                el.beat(d, t=t)

    def wave(rows: int, stage: str, burst: bool) -> None:
        t = clock[0] = clock[0] + ICU_DT
        beat(t)
        if burst:
            for _ in range(2):
                tickets.append((stage, fe.submit(qx[rng.integers(0, len(qx), 8)], tenant="burst",
                                                 deadline_s=10.0, now=t)))
        left = rows
        while left > 0:
            n = 1 if left < 4 or rng.random() < 0.3 else int(min(rng.integers(4, 17), left))
            tenant, deadline = ("bedside", 0.5) if n == 1 else ("ward", 2.0)
            tickets.append((stage, fe.submit(qx[rng.integers(0, len(qx), n)], tenant=tenant,
                                             deadline_s=deadline, now=t)))
            left -= n
        while fe.queue_depth:
            n_before = len(batches)
            t1 = time.perf_counter()
            fe.pump(now=t)
            sync(dev)
            dt = time.perf_counter() - t1
            if len(batches) > n_before:
                bucket = batches[-1][0].shape[0]
                pump_ms[bucket].append(dt * 1e3)
                expected_d[0] += cells * -(-bucket // cfg.query_chunk)

    def serve(stage: str) -> None:
        for i, rows in enumerate(ICU_WAVES):
            count(lambda: wave(rows, stage, burst=i % 2 == 1))
        stage_rows[stage] = sum(r.n_queries for st, r in tickets if st == stage and r.status != "shed")
        fe.assert_conserved()

    # 1. healthy
    first = len(batches)
    serve("healthy")
    # 2. one replica of a replicated cell down: failover, bit-exact
    j2, c2 = next((j, c) for j in range(NU) for c in range(P) if plan.replicas[j, c] >= 2)
    dead.add(int(plan.cell_device[j2, c2, 0]))
    clock[0] += 1.5  # past the heartbeat deadline
    mark2 = len(batches)
    serve("failover")
    need(any((j2, c2) in er.failover_cells for _, er, _ in batches[mark2:]), "icu_serve: no failover was served")
    # 3. every device of another node down: its cells lost, flagged
    j3 = (j2 + 1) % NU
    dead.update(int(d) for c in range(P) for d in plan.cell_device[j3, c] if d >= 0)
    clock[0] += 1.5
    mark3 = len(batches)
    serve("lost_node")
    lost3 = {(j3, c) for c in range(P)}
    for _, er, _ in batches[mark3:]:
        need(lost3 <= set(er.lost_cells) and er.degraded, "icu_serve: a lost cell was not flagged")
        need(not bool(er.result.routed[j3].any()), "icu_serve: a lost cell's rows were routed")
    for stage, r in tickets:
        if stage == "lost_node" and r.status == "done":
            need(r.degraded, "icu_serve: a response with a lost cell was not flagged degraded")
    # 4. ticks until the controller repairs and rebalances, then healthy
    phases: dict[str, float] = {}
    rebalance = ctl.rebalance

    def timed_rebalance(*a, **kw):
        sync(dev)
        phases["start"] = time.perf_counter()
        return rebalance(*a, **kw)

    def on_phase(name: str) -> None:
        sync(dev)
        phases[name] = time.perf_counter()

    ctl.rebalance, ctl.on_phase = timed_rebalance, on_phase
    restore_cells, saved = elastic.ft.elastic_restore_cells, []

    def restored(index, nodes):  # the index the rebalance saves
        saved.append(restore_cells(index, nodes))
        return saved[-1]

    elastic.ft.elastic_restore_cells = restored
    reports = []
    while not reports or not reports[-1].rebalanced:
        need(len(reports) < 5, "icu_serve: the controller never rebalanced")
        clock[0] += 0.5
        beat(clock[0])
        reports.append(count(lambda: ctl.tick(now=clock[0])))
    elastic.ft.elastic_restore_cells = restore_cells
    rep = reports[-1]
    dead.clear()  # the cells landed on fresh hosts
    disk = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(workdir) for f in fs)
    need(rep.repaired_nodes == (j3,) and el.epoch.n == 1, f"icu_serve: repair {rep}")
    new = el.index
    need(new.device.type == dev.type and new is not idx, "icu_serve: the swapped-in index is not the loaded copy")
    mark4 = len(batches)
    serve("repaired")
    need(all(er.epoch == 1 and not er.degraded and not er.failover_cells for _, er, _ in batches[mark4:]),
         "icu_serve: the repaired epoch did not serve every cell")
    served_launches, expected = dict(launches), expected_d[0]
    prof = profile_query(dev, lambda: wave(ICU_WAVES[2], "profile", burst=False), queries=ICU_WAVES[2])
    el.query = query

    # every undegraded batch (failover included) against a direct query of
    # its rows on the healthy index; the loaded index against the healthy
    exact_batches = exact_rows = 0
    for queries, er, cap in batches[first:]:
        if cap is not None or er.degraded:
            continue
        ref = idx.query(queries)
        res = er.result
        for what in ("knn_idx", "knn_dist", "comparisons"):
            need(torch.equal(getattr(res, what), getattr(ref, what)), f"icu_serve: {what} of an exact batch differs")
        exact_batches += 1
        exact_rows += queries.shape[0]
    exact_tickets = 0
    for stage, r in tickets:
        if r.status == "done" and not r.degraded:
            ref = idx.query(r.queries)
            need(np.array_equal(r.knn_idx, ref.knn_idx.cpu().numpy())
                 and np.array_equal(r.knn_dist, ref.knn_dist.cpu().numpy()),
                 f"icu_serve: the {stage} response {r.rid} differs from a direct query of its rows")
            exact_tickets += 1
    rows = pool[:256]
    a, b, c = new.query(rows), saved[0].query(rows), idx.query(rows)
    for what in ("knn_idx", "knn_dist", "comparisons", "compaction_overflow", "routed"):
        need(torch.equal(getattr(a, what), getattr(b, what)), f"icu_serve: the loaded index's {what} differs from the saved one's")
        need(torch.equal(getattr(b, what), getattr(c, what)), f"icu_serve: the restored index's {what} differs from the healthy one's")

    s = fe.assert_conserved()
    need(obs.query_retraces() == retraces0, "icu_serve: a kernel library was built after warmup")
    for name in ("bitsample_pack", "proj_sign_pack", "query_tail"):
        need(served_launches.get(name, 0) > 0, f"icu_serve never launched {name}")
    need(served_launches.get("query_tail", 0) == expected,
         f"icu_serve: {served_launches.get('query_tail', 0)} launches of D, not one per cell and chunk ({expected})")
    verdicts = {}
    for _, r in tickets:
        verdicts[r.verdict] = verdicts.get(r.verdict, 0) + 1
    need(verdicts.get("shed", 0) > 0 and verdicts.get("degrade", 0) > 0, f"icu_serve: verdicts {verdicts}")
    shutil.rmtree(workdir)
    rungs = {r: len(v) for r, v in pump_ms.items()}
    need(all(rungs.values()), f"icu_serve: a rung was never used ({rungs})")
    emit("icu_serve", n=int(idx.n_index()), grid=[NU, P], replication=2, replicas=int(plan.replicas.sum()),
         warmup_shapes=warm, warmup_s=warm_s, stage_rows=stage_rows,
         ledger=dict(submitted=s.submitted, admitted=s.admitted, completed=s.completed, shed=s.shed,
                     timed_out=s.timed_out, degraded_responses=s.degraded_responses, in_queue=s.in_queue),
         verdicts=verdicts, tenants=sorted({r.tenant for _, r in tickets}),
         microbatches_per_rung=rungs,
         pump_ms_median={r: float(np.median(v)) for r, v in pump_ms.items()},
         pump_ms_p99={r: float(np.percentile(v, 99)) for r, v in pump_ms.items()},
         failover_cell=[j2, c2], lost_node=j3, exact_batches=exact_batches, exact_batch_rows=exact_rows,
         exact_tickets_checked=exact_tickets, ticks_to_repair=len(reports),
         restore_ms=(phases["restore"] - phases["start"]) * 1e3, save_ms=(phases["save"] - phases["restore"]) * 1e3,
         load_ms=(phases["load"] - phases["save"]) * 1e3, rebalance_ms=(phases["swap"] - phases["start"]) * 1e3,
         bytes_on_disk=disk, migrated_cells=rep.migrated_cells,
         counters={k: ob.snapshot().get(k, {}).get("values") for k in (
             "dslsh_failovers_total", "dslsh_degraded_queries_total", "dslsh_rebalances_total",
             "dslsh_cells_migrated_total", "dslsh_serve_shed_total")},
         launches=served_launches, expected_query_tail=expected, seconds=time.perf_counter() - t_phase)
    emit("icu_serve_profile", microbatch_rows=ICU_WAVES[2], **prof)
    del el, ctl, fe, idx, new
    return served_launches


STREAM_CAP, STREAM_DELTA, STREAM_LIVE, STREAM_BATCH = 139_048, 256, 4_096, 16
STREAM_CHECK_EVENT, STREAM_PROFILE_EVENTS = 8, 8


def stream_phase(dev, pts, labs, qx, cfg, n: int) -> dict:
    """The paper-scale streaming deployment: ``streaming(nu=10, p=4,
    node_capacity=139,048, delta_cap=256)`` (routed) warmed on the main
    path's windows at ``t0=0``, then a ``StreamingMonitor`` streams 4,096
    further windows in batches of 16, one timestamp step each, labels at
    once. After the 8th event (deltas partly full, no compaction yet) and
    after the last, 256 queries go through the ``"cuda"`` and the
    ``"torch"`` backends on the same state and through an unrouted clone;
    after ``compact``, node 0's cells equal a from-scratch build over its
    stored rows; kernels A, B and D must launch, and the rolling MCC may
    fall at most 0.1 below PKNN's on the same live windows. Returns the
    kernels' launches of the replay."""
    import torch

    from repro_torch import dslsh, obs
    from repro_torch import stream as stream_mod
    from repro_torch.core import pipeline, predict
    from repro_torch.data import windows
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    deploy = dslsh.streaming(nu=NU, p=P, node_capacity=STREAM_CAP, delta_cap=STREAM_DELTA)
    lx, ly = windows.synth_window_slice(
        windows.SyntheticWindowSpec(n=n + NQ + STREAM_LIVE, seed=SEED), n + NQ, n + NQ + STREAM_LIVE
    )
    ts = 1.0 + np.arange(STREAM_LIVE) // STREAM_BATCH
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    ob = obs.Obs()
    mon = stream_mod.StreamingMonitor(
        SEED, pts, labs, cfg, deploy.grid, node_capacity=deploy.node_capacity, delta_cap=deploy.delta_cap,
        retention_s=deploy.retention_s, route=deploy.routed, route_bits=deploy.route_bits, obs=ob, device=dev,
    )
    sync(dev)
    warm_s = time.perf_counter() - t0
    index = dslsh.Index(deploy, cfg, {"core": mon.core})
    core = mon.core
    compact_s: list[float] = []
    maintain = core.maintain

    def timed_maintain(i, t):
        sync(dev)
        t1 = time.perf_counter()
        out = maintain(i, t)
        sync(dev)
        compact_s.append(time.perf_counter() - t1)
        return out

    core.maintain = timed_maintain
    queries = torch.as_tensor(qx[:256], device=dev)
    step_s: list[float] = []
    launches: dict[str, int] = {}

    def replay(lo: int, hi: int) -> None:
        _build.reset_launches()
        for s in range(lo * STREAM_BATCH, hi * STREAM_BATCH, STREAM_BATCH):
            e = s + STREAM_BATCH
            t1 = time.perf_counter()
            mon.step(lx[s:e], ly[s:e], float(ts[e - 1]))
            sync(dev)
            step_s.append(time.perf_counter() - t1)
        for name, c in _build.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + c

    def check(when: str) -> dict:
        state = list(core.state)
        res = core.query(queries)
        ref = core.clone(cfg=cfg.replace(backend="torch")).query(queries)
        plain = core.clone(route=False).query(queries)
        for what in ("comparisons", "compaction_overflow", "routed"):
            need(torch.equal(getattr(res, what), getattr(ref, what)), f"stream {when}: {what} differ from the torch backend")
        for what in ("knn_idx", "comparisons"):
            need(torch.equal(getattr(res, what), getattr(plain, what)), f"stream {when}: {what} differ from the unrouted answer")
        rows = torch.cat([nd.store for nd in state])
        need_topk(res.knn_dist, res.knn_idx, ref.knn_dist, ref.knn_idx, point_dist_of(rows, queries),
                  f"stream {when}: top-k differs from the torch backend")
        return dict(routed_frac=res.routed_frac, delta_fill=[nd.count for nd in state],
                    knn_idx_identical_to_torch=bool(torch.equal(res.knn_idx, ref.knn_idx)))

    n_events = STREAM_LIVE // STREAM_BATCH
    replay(0, STREAM_CHECK_EVENT)
    need(not any(e.compacted for e in mon.events), "stream: a node compacted before the first check")
    first = check(f"after event {STREAM_CHECK_EVENT}")
    spans = {}
    for e in ob.tracer.events:
        spans[e["name"]] = spans.get(e["name"], 0) + 1
    mon.obs = None  # the rest unobserved: per-stage spans synchronize the device
    replay(STREAM_CHECK_EVENT, n_events - STREAM_PROFILE_EVENTS)
    t_prof = time.perf_counter()
    prof = profile_query(dev, lambda: replay(n_events - STREAM_PROFILE_EVENTS, n_events),
                         queries=STREAM_PROFILE_EVENTS * STREAM_BATCH)
    prof["seconds_with_trace_processing"] = time.perf_counter() - t_prof
    core.maintain = maintain
    last = check("after the last event")
    for name in ("bitsample_pack", "proj_sign_pack", "query_tail"):
        need(launches.get(name, 0) > 0, f"stream: the replay never launched {name}")
    events = mon.events
    compacted_nodes = sorted({e.node for e in events if e.compacted})
    need(compacted_nodes == list(range(NU)), f"stream: only nodes {compacted_nodes} compacted")
    need(sum(e.dropped for e in events) == 0, "stream: windows were dropped")

    # compaction is exact: node 0's cells against a from-scratch build
    index.compact(float(ts[-1]))
    node = core.state[0]
    m = node.n
    for c, cell in enumerate(node.cells):
        scratch = pipeline.build_from_params(node.store[:m], cell.base.outer_params, cell.base.inner_params, cfg)
        need(torch.equal(cell.base.outer.sorted_keys[:, :m], scratch.outer.sorted_keys)
             and torch.equal(cell.base.outer.sorted_idx[:, :m], scratch.outer.sorted_idx),
             f"stream: node 0 cell {c} tables differ from a scratch build after compaction")
        need(all(torch.equal(a, b) for a, b in zip(cell.base.heavy, scratch.heavy)),
             f"stream: node 0 cell {c} heavy registry differs from a scratch build")
        need(torch.equal(cell.base.inner_keys, scratch.inner_keys) and torch.equal(cell.base.inner_idx, scratch.inner_idx),
             f"stream: node 0 cell {c} inner tables differ from a scratch build")

    data = torch.as_tensor(pts, device=dev)
    pkd, pki, _ = dslsh.pknn_query(data, torch.as_tensor(lx, device=dev), cfg.k, deploy.grid)
    mcc_p = float(predict.mcc(predict.predict_batch(torch.as_tensor(labs, device=dev), pki, pkd),
                              torch.as_tensor(ly, device=dev)))
    mcc = mon.mcc()
    need(mcc >= mcc_p - 0.1, f"stream: rolling MCC {mcc} below PKNN's {mcc_p} by more than 0.1")
    lat = np.asarray([e.latency_s for e in events]) * 1e3
    step = np.asarray(step_s) * 1e3
    ingest = step - lat  # a step is the prediction, then the ingest
    emit("stream", warm_n=n, nodes=NU, cores=P, node_capacity=STREAM_CAP, delta_cap=STREAM_DELTA,
         live_windows=STREAM_LIVE, batch=STREAM_BATCH, events=len(events), warm_s=warm_s,
         ingest_ms_median=float(np.median(ingest)), ingest_ms_p95=float(np.percentile(ingest, 95)),
         predict_ms_median=float(np.median(lat)), predict_ms_p95=float(np.percentile(lat, 95)),
         step_ms_median=float(np.median(step)), compactions=sum(e.compacted for e in events),
         compaction_s=compact_s, n_index=mon.n_index(),
         median_routed_frac=float(np.median([e.routed_frac for e in events])),
         median_comparisons=float(np.median([e.comparisons for e in events])),
         overflow_events=sum(e.overflow > 0 for e in events), rolling_mcc=mcc, mcc_pknn=mcc_p,
         check_event_8=first, check_last=last, spans_first_8_events=spans,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None,
         seconds=time.perf_counter() - t_phase, launches=launches)
    emit("stream_profile", events=STREAM_PROFILE_EVENTS, **prof)
    del mon, index, core, data
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- the kNN-LM slice


def flash_row(dev, cfg, wide_cfg, sink_cfg, max_len: int, flush) -> dict:
    """Kernel F against its plain version (float32, cast once to bf16) at the
    slice's shapes, in the model's layouts: q, k, v are transposed views of
    (B, S, H, dh) activations or of the (B, S_max, Hkv, dh) cache. The
    row's own numbers are the datastore pass's shape; ``cases`` holds all
    nine: five at ``cfg``'s heads, two at ``wide_cfg``'s (head_dim 192,
    a GQA group of 12: the widest ring and a packed decode tile), one at
    ``sink_cfg``'s sliding-window prefill (hymba: its window and its meta
    tokens as attention sinks, over the 2,048 positions of the families
    phase's prompt) and one at a tensor-parallel rank's share of ``cfg``'s
    heads in the lm_mesh phase's granite prefill (2 prompts, 8/2 heads of
    128 a rank of 4).
    ``library_ms`` is one ``scaled_dot_product_attention`` call
    (``enable_gqa``), timed here only; ``library_ratio`` is ms over it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref

    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    wide = (wide_cfg.n_heads, wide_cfg.n_kv_heads, wide_cfg.head_dim)
    tp = LMM_DENSE_SERVE_MESH[1]  # the lm_mesh phase's tensor-parallel ranks
    s_sink = FAMILY_PROMPTS[SINK_ARCH] + sink_cfg.meta_tokens
    ragged = torch.tensor([max_len - 15, max_len - 7, max_len - 3, max_len], dtype=torch.int32, device=dev)
    cases = [
        dict(case="datastore", b=DS_CHUNK, sq=DS_LEN - 1, skv=DS_LEN - 1, causal=True),
        dict(case="prefill", b=1, sq=PROMPT_LEN, skv=PROMPT_LEN, causal=True),
        dict(case="decode", b=N_REQ, sq=1, skv=max_len, causal=False, q_offset=ragged - 1, kv_len=ragged),
        dict(case="window", b=1, sq=DS_LEN - 1, skv=DS_LEN - 1, causal=True, window=256),
        dict(case="q_offset", b=1, sq=64, skv=max_len, causal=True, q_offset=max_len - 64),
        dict(case="dh192_prefill", b=1, sq=256, skv=256, causal=True, heads=wide),
        dict(case="dh192_decode", b=1, sq=1, skv=256, causal=False, q_offset=255, kv_len=256, heads=wide),
        dict(case="sink", b=1, sq=s_sink, skv=s_sink, causal=True, window=sink_cfg.window,
             sink=sink_cfg.meta_tokens, heads=(sink_cfg.n_heads, sink_cfg.n_kv_heads, sink_cfg.head_dim)),
        dict(case="tensor_parallel_prefill", b=LMM_DENSE_BATCH, sq=LMM_DENSE_PROMPT, skv=LMM_DENSE_PROMPT, causal=True,
             heads=(max(cfg.n_heads // tp, 1), max(cfg.n_kv_heads // tp, 1), cfg.head_dim)),
    ]
    g = torch.Generator(dev).manual_seed(SEED)
    out = []
    for c in cases:
        b, sq, skv = c["b"], c["sq"], c["skv"]
        hq, hkv, dh = c.get("heads", heads)
        kw = dict(causal=c["causal"], window=c.get("window"), q_offset=c.get("q_offset", 0), kv_len=c.get("kv_len"),
                  sink=c.get("sink", 0))
        q = torch.randn((b, sq, hq, dh), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn((b, skv, hkv, dh), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        o = fa.flash_attention(q, k, v, **kw)
        r = fa_ref.attention_ref(q, k, v, **kw)
        err = (o.float() - r.float()).abs()
        need(bool((err <= FA_RTOL * r.float().abs() + FA_ATOL).all()),
             f"flash_attention ({c['case']}) differs from its plain version by {float(err.max())}")
        ok = fa_ref.visible(b, sq, skv, device=dev, **kw)
        pairs = int(ok.sum())
        keys_read = int(ok.any(dim=1).sum())  # per batch row, the keys any query row sees
        nbytes = 2 * (2 * b * hq * sq * dh + 2 * keys_read * hkv * dh) + 8 * b
        b_ms, b_by = bound(nbytes, 4 * pairs * hq * dh, BF16_OPS_PER_S)
        plain_causal = kw["causal"] and sq == skv and c.get("q_offset") is None and kw["window"] is None
        mask = None if plain_causal else ok[:, None]

        def lib(q=q, k=k, v=v, mask=mask, plain_causal=plain_causal):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=plain_causal, enable_gqa=True)

        lib_err = float((lib().float() - r.float()).abs().nan_to_num(0.0).max())
        fault = {}
        if c["case"] == "decode":  # a dropped newest key, which the model-level gate misses
            ferr = (fa.flash_attention(q, k, v, **{**kw, "kv_len": kw["kv_len"] - 1}).float() - r.float()).abs()
            need(bool((ferr > FA_RTOL * r.float().abs() + FA_ATOL).any()),
                 "flash_attention (decode): the tolerance misses a dropped newest key")
            fault = dict(planted_last_key_max_abs_err=float(ferr.max()))
        out.append(dict(
            case=c["case"],
            shape=(f"q ({b}, {hq}, {sq}, {dh}), k/v ({b}, {hkv}, {skv}, {dh}) bf16, causal={kw['causal']},"
                   f" window={kw['window']}, q_offset={_show(kw['q_offset'])}, kv_len={_show(kw['kv_len'])}"
                   + (f", sink={kw['sink']}" if kw["sink"] else "")),
            visible_pairs=pairs, max_abs_err=float(err.max()), library_max_abs_err=lib_err,
            ms=timed_ms(lambda: fa.flash_attention(q, k, v, **kw), 20, flush),
            plain_ms=timed_ms(lambda: fa_ref.attention_ref(q, k, v, **kw), 5, flush),
            bound_ms=b_ms, bound_by=b_by, library_ms=timed_ms(lib, 20, flush), **fault,
            device_ms=device_profile(lambda: fa.flash_attention(q, k, v, **kw))["device_ms"],
            library_device_ms=device_profile(lib)["device_ms"],
        ))
        out[-1]["library_ratio"] = out[-1]["ms"] / out[-1]["library_ms"]
        del q, k, v, o, r, ok, mask
    head = out[0]
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:125",
        shape=head["shape"], max_abs_err=head["max_abs_err"], tolerance=f"{FA_RTOL}*|plain| + {FA_ATOL}",
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["library_ms"], library="torch.nn.functional.scaled_dot_product_attention",
        cases=out,
    )


def _show(v):
    return v.tolist() if hasattr(v, "tolist") else v


def wide_a_check(x, outer, cfg, p: int, flush) -> dict:
    """Kernel A (words, and its margins mode) on rows ``x`` (T, d) of a wide
    row width with one cell's outer tables, bit-exact against its plain
    version."""
    import torch

    from repro_torch.core import hashing
    from repro_torch.kernels.hash_pack import ops as hp, ref as hp_ref

    t, d = x.shape
    l_loc = cfg.L_out // p
    outer0 = hashing.BitSampleParams(outer.dims[:l_loc], outer.thrs[:l_loc], outer.salts[:l_loc])
    dims, thrs = hp.bitsample_columns(outer0)
    m_cols = dims.shape[0]
    wk, mk = hp.bitsample_pack(x, dims, thrs, margins=True)
    wr, mr = hp_ref.bitsample_pack_ref(x, dims, thrs, margins=True)
    need(torch.equal(hp.bitsample_pack(x, dims, thrs), wr) and torch.equal(wk, wr) and torch.equal(mk, mr),
         f"bitsample_pack differs from its plain version at d={d}")
    # the function reads only the sampled coordinates of each row
    b_ms, b_by = bound(t * min(d, m_cols) * 4 + m_cols * 8 + t * m_cols // 8, t * m_cols)
    return dict(d=d, shape=f"x ({t}, {d}), {m_cols} columns", exact=True,
                ms=timed_ms(lambda: hp.bitsample_pack(x, dims, thrs), 20, flush),
                plain_ms=timed_ms(lambda: hp_ref.bitsample_pack_ref(x, dims, thrs), 5, flush),
                bound_ms=b_ms, bound_by=b_by)


def wide_b_check(x, inner, flush) -> dict:
    """Kernel B on rows ``x`` (T, d) of a wide row width with the inner
    family, against its plain version (a full-float32 matmul): no bit may
    differ where |s| is beyond float32 rounding of 0, and the bits that
    differ at all are counted."""
    import torch

    from repro_torch.kernels.hash_pack import ops as hp, ref as hp_ref

    t, d = x.shape
    n_tab = inner.proj.shape[0]
    cols, bias, m_in, m_pad = inner_columns(inner)
    bk = hp.proj_sign_pack(x, cols, bias, m_in, m_pad)
    br = hp_ref.proj_sign_pack_ref(x, cols, bias, m_in, m_pad)
    bits = torch.arange(32, device=x.device)
    diff = (((bk[:, :, None] >> bits) & 1) != ((br[:, :, None] >> bits) & 1)).reshape(t, -1)
    scale = 1e-5 * x.norm(dim=1, keepdim=True) * cols.norm(dim=0, keepdim=True)
    need(not bool((diff & ((x @ cols).abs() > scale)).any()), f"proj_sign_pack flips a bit far from zero at d={d}")
    b_ms, b_by = b_words_bound(t, d, cols, m_in, m_pad)
    return dict(d=d, shape=f"x ({t}, {d}), proj ({d}, {cols.shape[1]}), {n_tab * m_in} real columns",
                exact=bool(not diff.any()), disagreeing_bits=int(diff.sum()),
                ms=timed_ms(lambda: hp.proj_sign_pack(x, cols, bias, m_in, m_pad), 20, flush),
                device_ms=device_profile(lambda: hp.proj_sign_pack(x, cols, bias, m_in, m_pad))["device_ms"],
                plain_ms=timed_ms(lambda: hp_ref.proj_sign_pack_ref(x, cols, bias, m_in, m_pad), 5, flush),
                bound_ms=b_ms, bound_by=b_by)


def inner_columns(inner):
    """The inner family as kernel B's flat columns: proj (d, L*m_pad), a
    zero bias, m and m_pad."""
    import torch

    n_tab, d, m_in = inner.proj.shape
    m_pad = 32 * -(-m_in // 32)
    proj = torch.nn.functional.pad(inner.proj, (0, m_pad - m_in)).permute(1, 0, 2)
    cols = proj.reshape(d, n_tab * m_pad).contiguous()
    return cols, torch.zeros(n_tab * m_pad, device=cols.device), m_in, m_pad


def b_order_check(x, inner) -> dict:
    """Kernel B's one summation order: the words of up to 512 rows hashed in
    one launch (where d spans several slices, the batch path from 512 rows
    on) equal those of the same rows hashed 64 in one launch, one row per
    launch and in launches of 50 (the few-row path)."""
    import torch

    from repro_torch.kernels.hash_pack import ops as hp

    cols, bias, m, m_pad = inner_columns(inner)
    n = min(512, x.shape[0])
    rows = x[:n].contiguous()

    def words(lo: int, hi: int):
        return hp.proj_sign_pack(rows[lo:hi].contiguous(), cols, bias, m, m_pad)

    whole = words(0, n)
    same = dict(
        rows_64_in_one_launch=bool(torch.equal(whole[:64], words(0, 64))),
        one_row_per_launch=bool(torch.equal(whole, torch.cat([words(i, i + 1) for i in range(n)]))),
        launches_of_50=bool(torch.equal(whole, torch.cat([words(i, min(i + 50, n)) for i in range(0, n, 50)]))),
    )
    need(all(same.values()), f"proj_sign_pack words depend on the batch at d={x.shape[1]}: {same}")
    return dict(d=x.shape[1], rows=n, **same)


@contextlib.contextmanager
def launch_shapes(logs: dict):
    """Count kernel A's, B's and D's calls by shape while the block runs:
    ``logs[name][shape]``, A's shape "rows x d, columns" (", margins" in
    its margins mode), B's "rows x d", D's "Q x C x d"."""
    from repro_torch.kernels.hash_pack import ops as hp
    from repro_torch.kernels.query_fused import ops as qf

    keys = {
        (hp, "bitsample_pack"): lambda x, dims, *a, margins=False, **kw:
            f"{x.shape[0]}x{x.shape[1]}, {dims.shape[0]} columns" + (", margins" if margins else ""),
        (hp, "proj_sign_pack"): lambda x, *a, **kw: f"{x.shape[0]}x{x.shape[1]}",
        (qf, "query_tail"): lambda data, queries, cand, **kw: f"{cand.shape[0]}x{cand.shape[1]}x{data.shape[1]}",
    }
    saved = {}
    for (mod, name), key in keys.items():
        wrapped = saved[(mod, name)] = getattr(mod, name)
        log = logs.setdefault(name, {})

        def counted(*args, _wrapped=wrapped, _key=key, _log=log, **kw):
            shape = _key(*args, **kw)
            _log[shape] = _log.get(shape, 0) + 1
            return _wrapped(*args, **kw)

        setattr(mod, name, counted)
    try:
        yield logs
    finally:
        for (mod, name), wrapped in saved.items():
            setattr(mod, name, wrapped)


# The model's attention for the logit gate: "plain" is the port's plain
# version run on the card; "attention_ref" a second plain version, which
# scales the scores after the dot as the Pallas kernel does and differs from
# the first only in float32 rounding; each "fault_*" is kernel F with one
# planted fault: the causal edge moved by one (a row no longer sees its own
# key), scores scaled by 1/dh instead of 1/sqrt(dh), and decode dropping the
# newest key (kv_len - 1). The gate must catch the first two. The third
# moves the logits by about twice the rounding gap, too little for this
# gate: flash_row's decode case is the check that catches it, per element.
ATTENTION_FAULTS = ("fault_causal_edge", "fault_scale", "fault_last_key")
GATED_FAULTS = ATTENTION_FAULTS[:2]
# kernel F with the attention-sink mask ignored (hymba's meta tokens drop
# out of its sliding-window layers' prefill): the families phase's gate on
# hymba must catch it too
SINK_FAULT = "fault_sink"
# qwen3-32b's gate must catch two more: the qk-norm skipped on k (the
# dense model's _qkv normalizing q alone) and F reading each query head's
# neighbouring KV group (the KV heads rolled by one at its 64:8 ratio)
QK_FAULTS = ("fault_qk_norm_k", "fault_kv_group")


@contextlib.contextmanager
def model_attention(kind: str):
    """Swap the model's attention (``common.chunked_attention`` and
    ``common.decode_attention_cp``) for ``kind`` while the block runs."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import common

    saved = common.chunked_attention, common.decode_attention_cp
    attend = fa_ref.attention_ref if kind == "attention_ref" else fa_ops.flash_attention

    def chunked(q, k, v, *, causal=True, window=None, sink=0, q_offset=0, kv_len=None, q_chunk=512):
        if kind == "plain":
            return common._chunked_attention_plain(q, k, v, causal, window, q_offset, kv_len, q_chunk, sink=sink)
        if kind == "fault_causal_edge" and causal:
            q_offset = q_offset - 1
        if kind == "fault_scale":
            q = q * q.shape[-1] ** -0.5
        if kind == SINK_FAULT:
            sink = 0
        if kind == "fault_kv_group":
            k, v = k.roll(1, 2), v.roll(1, 2)
        return attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                      window=window, q_offset=q_offset, kv_len=kv_len, sink=sink).transpose(1, 2)

    def decode(q, k_cache, v_cache, cur_len, seq_blocks=1):
        if seq_blocks != 1:
            raise ValueError("model_attention swaps the one-process attention, not the mesh's")
        cl = fa_ref.per_row(cur_len, q.shape[0], q.device)
        if kind == "plain":
            return common._decode_attention_plain(q, k_cache, v_cache, cl)
        kl = cl - 1 if kind == "fault_last_key" else cl
        return chunked(q, k_cache, v_cache, causal=False, q_offset=cl - 1, kv_len=kl)

    common.chunked_attention, common.decode_attention_cp = chunked, decode
    try:
        yield
    finally:
        common.chunked_attention, common.decode_attention_cp = saved


@contextlib.contextmanager
def planted_fault(kind: str):
    """A planted fault of the logit gate while the block runs:
    ``"fault_qk_norm_k"`` in the dense model's projections, any other in
    its attention (``model_attention``)."""
    if kind != "fault_qk_norm_k":
        with model_attention(kind):
            yield
        return
    import dataclasses

    from repro_torch.models import common
    from repro_torch.models import dense

    saved = dense._qkv

    def planted(cfg, p, h, seq=()):
        q, k, v = saved(dataclasses.replace(cfg, qk_norm=False), p, h, seq)
        return common.rms_norm(q, p["q_norm"]), k, v

    dense._qkv = planted
    try:
        yield
    finally:
        dense._qkv = saved


def continuation_accuracy(stream, prompts, gens) -> float:
    """examples/serve_knn_lm.py's accuracy: the share of generated tokens
    equal to the noise-free motif's continuation, its phase read from the
    prompt's last four tokens."""
    acc = []
    per = stream.period
    for p, g in zip(prompts, gens):
        ctx = list(p)
        phase = int(np.argmax([np.array_equal(stream.motif[(np.arange(len(ctx)) + ph) % per][-4:], ctx[-4:])
                               for ph in range(per)]))
        want = [stream.motif[(phase + len(ctx) + t) % per] for t in range(len(g))]
        acc.append(np.mean(np.asarray(g) == np.asarray(want)))
    return float(np.mean(acc))


def hook_checks(what: str, index, scfg, grid, labels, vocab: int, calls, checks: list) -> dict:
    """The kNN-LM hook on every call it made (``calls``: logits in, logits
    out, query hidden state, lmbda 0.3), against ``knn_interpolate`` on the
    cuda index's own answer for its query (every row), and on the
    ``"torch"`` backend's answer where both backends return the same
    neighbours (``need_topk`` holds the two answers together on every row,
    ties included). There the distances still differ by float32 rounding
    (the backends sum over d in another order), which the softmax weights
    carry on: with z = -dist / T (T = 1, the hook's default),
    ||dw||_1 <= 2 max|dz| and so each probability moves by at most
    lmbda * 2 max|d dist|. The mixed probabilities are held to that, plus
    1e-6 for their own rounding. Appends the checks to ``checks``; returns
    the fields for the phase's line."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.serve import engine

    logits_in, mixed, hq = (torch.cat(t) for t in zip(*calls))
    res_c = [index.query(h[None]) for h in hq]
    idx_c, dist_c = torch.cat([r.knn_idx for r in res_c]), torch.cat([r.knn_dist for r in res_c])
    want_c = engine.knn_interpolate(logits_in, idx_c, dist_c, labels, vocab, 0.3)
    checks.append((bool(torch.allclose(mixed, want_c, rtol=1e-5, atol=1e-5)),
                   f"{what}: the hook's output differs from knn_interpolate on the index's answer"))
    res_t = D.grid_query(index.pipeline_index, index._state["data"], hq.float(), scfg.replace(backend="torch"), grid)
    need_topk(dist_c, idx_c, res_t.knn_dist, res_t.knn_idx,
              point_dist_of(index._state["data"], hq.float()), f"{what}: cuda and torch retrieval differ")
    want_t = engine.knn_interpolate(logits_in, res_t.knn_idx, res_t.knn_dist, labels, vocab, 0.3)
    same = (idx_c == res_t.knn_idx).all(dim=1)
    real = same[:, None] & (idx_c >= 0)
    dist_gap = float((dist_c - res_t.knn_dist).abs()[real].max()) if real.any() else 0.0
    p_err = float((mixed[same].exp() - want_t[same].exp()).abs().max()) if same.any() else 0.0
    p_tol = 0.3 * 2 * dist_gap + 1e-6
    checks.append((p_err <= p_tol, f"{what}: the hook's probabilities differ from knn_interpolate on the torch"
                                   f" backend's neighbours by {p_err} > {p_tol}"))
    return dict(hook_calls=int(same.numel()), hook_rows_identical_to_torch_backend=int(same.sum()),
                hook_torch_backend_dist_gap=dist_gap, hook_torch_backend_p_err=p_err,
                hook_torch_backend_p_tol=p_tol)


def knn_lm_phase(dev, smoke: bool, ds_seqs: int, flush) -> tuple[dict, dict, dict, dict]:
    """The kNN-LM serving path of examples/serve_knn_lm.py steps 2-3 at
    granite-8b's full width and depth, weights from a seeded generator:
    a datastore of hidden states (``_run_layers`` over ``ds_seqs``
    sequences in chunks of 8), DSLSH over it on ``grid(nu=2, p=4)`` with
    the ``"cuda"`` backend, then 4 requests served with lmbda 0 and 0.3
    through the hook. The model with kernel F is then held against the same
    model with the plain attention (teacher-forced on the tokens served),
    and the hook's output against ``knn_interpolate`` on the ``"torch"``
    backend's answer. Returns F's row, the fields this phase adds to A's,
    B's and D's rows (wide-row checks, path shapes, one-order checks and
    launches by shape), and the path's launch counts."""
    import torch

    from repro_torch import configs, dslsh
    from repro_torch.core import pipeline
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.models import api as mapi
    from repro_torch.models import dense
    from repro_torch.serve import engine

    cfg = configs.get(LM_ARCH, smoke=smoke)
    max_len = PROMPT_LEN + MAX_NEW + 8  # as the serving launcher sizes its cache
    f_row = flash_row(dev, cfg, configs.get(WIDE_ARCH, smoke=smoke), configs.get(SINK_ARCH, smoke=smoke), max_len,
                      flush)

    model = mapi.build_model(cfg)
    sync(dev)
    t0 = time.perf_counter()
    lm = model.init(SEED, dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    stream = TokenStream(cfg.vocab, seed=3)
    ds_tokens = torch.as_tensor(stream.batch(ds_seqs, DS_LEN), device=dev)
    prompts = [stream.batch(1, PROMPT_LEN)[0] for _ in range(N_REQ)]
    passes = 0  # forward passes of the model on the path

    def hidden_states(tokens):
        nonlocal passes
        passes += 1
        x, _ = dense._embed_inputs(cfg, lm, {"tokens": tokens})
        return dense._run_layers(cfg, lm, x, torch.arange(tokens.shape[1], device=dev))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(dev)
    lm_shapes: dict = {}
    shapes = contextlib.ExitStack()
    shapes.enter_context(launch_shapes(lm_shapes))
    _build.reset_launches()
    # 1. the datastore: keys are the hidden states at positions t, labels
    # the tokens at t + 1; with causal attention the first 1,024 hidden
    # states do not depend on the 1,025th token, which only labels, so each
    # chunk runs 1,024 tokens
    t0 = time.perf_counter()
    n_keys = ds_seqs * (DS_LEN - 1)
    keys = torch.empty((n_keys, cfg.d_model), dtype=torch.float32, device=dev)
    for c0 in range(0, ds_seqs, DS_CHUNK):
        h = hidden_states(ds_tokens[c0 : c0 + DS_CHUNK, : DS_LEN - 1])
        keys[c0 * (DS_LEN - 1) : c0 * (DS_LEN - 1) + h.shape[0] * h.shape[1]] = h.reshape(-1, cfg.d_model)
    labels = ds_tokens[:, 1:].reshape(-1)
    sync(dev)
    hidden_s = time.perf_counter() - t0
    # 2. DSLSH over the hidden states
    deploy = dslsh.grid(nu=2, p=4)
    scfg = dslsh.make_config(
        dslsh.FamilyConfig(**KNN_FAMILY, val_lo=float(keys.min()), val_hi=float(keys.max())),
        dslsh.BudgetConfig(**KNN_BUDGET), backend="cuda",
    )
    t0 = time.perf_counter()
    index = dslsh.build(SEED, keys, scfg, deploy, dev)
    sync(dev)
    build_s = time.perf_counter() - t0

    # 3. serving, as step 3 does: per request a prefill, then greedy decode
    # steps; with lmbda > 0 the hook re-runs the model over the running
    # tokens for the query hidden state and retrieves from the datastore
    first = {}
    hook_log = dict(hq=[], calls=[])  # calls: (logits in, logits out, query hidden state)

    def hidden_fn(cur):
        hq = hidden_states(cur)[:, -1]
        hook_log["hq"].append(hq)
        return hq

    def serve(lmbda: float, reqs=prompts):
        nonlocal passes
        hook = engine.make_knn_lm_hook(index, labels, hidden_fn=hidden_fn, vocab=cfg.vocab, lmbda=lmbda)
        gens, prefill_ms, decode_ms, hook_ms = [], [], [], []
        for p in reqs:
            toks = torch.as_tensor(p[None, :], device=dev)
            sync(dev)
            t0 = time.perf_counter()
            logits, cache = model.prefill(lm, {"tokens": toks}, max_len)
            sync(dev)
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            passes += 1
            first.setdefault(("prefill", lmbda), logits)
            cur, gen = toks, []
            for _ in range(MAX_NEW):
                if lmbda > 0:
                    t0 = time.perf_counter()
                    mixed = hook(logits, cur)
                    sync(dev)
                    hook_ms.append((time.perf_counter() - t0) * 1e3)
                    hook_log["calls"].append((logits, mixed, hook_log["hq"][-1]))
                    logits = mixed
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                gen.append(int(nxt[0, 0]))
                t0 = time.perf_counter()
                logits, cache = model.decode_step(lm, cache, nxt)
                sync(dev)
                decode_ms.append((time.perf_counter() - t0) * 1e3)
                passes += 1
                first.setdefault(("decode", lmbda), logits)
                cur = torch.cat([cur, nxt], dim=1)
            gens.append(gen)
        return gens, prefill_ms, decode_ms, hook_ms

    served = {lmbda: serve(lmbda) for lmbda in (0.0, 0.3)}
    sync(dev)
    launches = dict(_build.LAUNCHES)
    shapes.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    f_launches, path_passes = launches.get("flash_attention", 0), passes
    checks = [(f_launches >= cfg.n_layers * path_passes,
               f"knn_lm: {f_launches} flash_attention launches, fewer than {cfg.n_layers} per forward pass"
               f" ({path_passes})")]
    checks += [(launches.get(name, 0) > 0, f"knn_lm never launched {name}")
               for name in ("bitsample_pack", "proj_sign_pack", "query_tail")]

    # the datastore query time and its overflow, on every query the hook made
    hq_all = torch.cat(hook_log["hq"])
    index.query(hq_all[:1])  # warm
    sync(dev)
    t0 = time.perf_counter()
    res_all = index.query(hq_all)
    sync(dev)
    query_ms = (time.perf_counter() - t0) * 1e3
    overflow_cells = int(res_all.overflow_cells)
    del res_all
    # where a request's time goes: one request served with the hook, profiled
    emit("knn_lm_profile", request_tokens=PROMPT_LEN + MAX_NEW,
         **profile_query(dev, lambda: serve(0.3, prompts[:1]), queries=MAX_NEW))

    # the model with kernel F against the plain attention. The tolerance on
    # the first prefill's and first decode step's logits is twice the gap
    # between two plain models that differ only in float32 rounding (the
    # chunked attention, which scales q before the dot, against
    # attention_ref, which scales the scores after it, as the Pallas kernel
    # does), plus LOGIT_ATOL; greedy tokens (teacher-forced on the tokens
    # served) must agree wherever the plain top-2 margin exceeds twice it
    gens0 = served[0.0][0]
    p0 = torch.as_tensor(prompts[0][None, :], device=dev)
    tok0 = torch.tensor([[gens0[0][0]]], dtype=torch.int32, device=dev)

    def first_logits():
        lg, cache = model.prefill(lm, {"tokens": p0}, max_len)
        return lg, model.decode_step(lm, cache, tok0)[0]

    with model_attention("plain"):
        plain = first_logits()
    with model_attention("attention_ref"):
        alt = first_logits()
    kern = (first[("prefill", 0.0)], first[("decode", 0.0)])

    def logit_errs(got):
        return [float((a - b).abs().max()) for a, b in zip(got, plain)]

    logit_err, logit_floor = logit_errs(kern), logit_errs(alt)
    logit_tol = 2 * max(logit_floor) + LOGIT_ATOL
    checks.append((max(logit_err) <= logit_tol,
                   f"knn_lm: logits differ from the plain model's by {max(logit_err)} > {logit_tol}"))
    # the gate against faults planted in kernel F
    fault_err = {}
    for kind in ATTENTION_FAULTS:
        with model_attention(kind):
            fault_err[kind] = logit_errs(first_logits())
    checks += [(max(fault_err[kind]) > logit_tol,
                f"knn_lm: the logit gate {logit_tol} misses {kind} (errors {fault_err[kind]})")
               for kind in GATED_FAULTS]
    checked, skipped, token_diffs, tokens_equal = 0, 0, [], 0
    with model_attention("plain"):
        for r, (p, gen) in enumerate(zip(prompts, gens0)):
            logits, cache = model.prefill(lm, {"tokens": torch.as_tensor(p[None, :], device=dev)}, max_len)
            for t, tok in enumerate(gen):
                tokens_equal += int(logits[0].argmax()) == tok
                top2 = torch.topk(logits[0], 2).values
                if float(top2[0] - top2[1]) > 2 * logit_tol:
                    checked += 1
                    if int(logits[0].argmax()) != tok:
                        token_diffs.append([r, t])
                else:
                    skipped += 1
                logits, cache = model.decode_step(lm, cache, torch.tensor([[tok]], dtype=torch.int32, device=dev))
    checks.append((not token_diffs, f"knn_lm: greedy tokens {token_diffs} (request, step) differ from the plain model's"))

    # the hook on every call it made, against knn_interpolate
    hook_fields = hook_checks("knn_lm", index, scfg, deploy.grid, labels, cfg.vocab, hook_log["calls"], checks)

    # A and B at the datastore's width (one cell's keys for A, the first
    # 1,024 for B, whose inner layer hashes only heavy-bucket points, and
    # the index's own family) and at the widest d_model of the repo's
    # configs; A and D at the path's shapes on that cell, with the hook's
    # queries (and perturbed keys to fill a 50-query chunk)
    outer, inner = pipeline.make_family(torch.Generator().manual_seed(SEED), cfg.d_model, scfg, dev)
    cell = keys[: n_keys // deploy.nu]
    wide_a = [wide_a_check(cell, outer, scfg, deploy.p, flush)]
    wide_b = [wide_b_check(cell[:1024].contiguous(), inner, flush),
              wide_b_check(cell[:1].contiguous(), inner, flush)]  # the hook's one row
    b_order = [b_order_check(cell, inner)]
    g = torch.Generator(dev).manual_seed(SEED)
    fill = cell[:: max(1, cell.shape[0] // 50)][:50]
    hq50 = torch.cat([hq_all.float(), fill + 0.01 * fill.std() * torch.randn(fill.shape, generator=g, device=dev)])[:50]
    knn_a, knn_d, knn_order = knn_path_cases(cell, hq50, scfg, deploy.p, flush)
    del index, keys, lm, cell
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wide = 2 * cfg.d_model if smoke else WIDE_D
    xw = torch.rand((256 if smoke else 8192, wide), generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    outer_w, inner_w = pipeline.make_family(torch.Generator().manual_seed(SEED), wide, scfg, dev)
    wide_a.append(wide_a_check(xw, outer_w, scfg, deploy.p, flush))
    wide_b.append(wide_b_check(xw[:1024].contiguous(), inner_w, flush))
    del xw
    gens3 = served[0.3][0]
    emit(
        "knn_lm", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab, n_params=model.n_params, init_s=init_s,
        datastore=dict(sequences=ds_seqs, tokens_per_sequence=DS_LEN, keys=n_keys, key_width=cfg.d_model,
                       cut=None if ds_seqs == DS_SEQS else f"{ds_seqs} of {DS_SEQS} sequences"),
        hidden_pass_s=hidden_s, dslsh_build_s=build_s, grid=[deploy.nu, deploy.p],
        datastore_query_ms=query_ms, datastore_queries=int(hq_all.shape[0]),
        overflow_cells=overflow_cells,
        prefill_ms=float(np.mean(served[0.0][1])), decode_step_ms=float(np.mean(served[0.0][2])),
        decode_step_ms_with_hook=float(np.mean(np.add(served[0.3][2], served[0.3][3]))),
        hook_ms=float(np.mean(served[0.3][3])),
        peak_mem_gb=peak_gb, forward_passes=path_passes, flash_attention_launches=f_launches,
        flash_attention_launches_per_pass=f_launches / path_passes, launches=launches,
        logits_max_abs=[float(x.abs().max()) for x in plain],
        logits_max_abs_err_vs_plain=logit_err, logits_plain_vs_attention_ref=logit_floor,
        logit_tolerance=logit_tol, logits_planted_fault_err=fault_err, greedy_tokens_checked=checked,
        greedy_tokens_within_tolerance_margin=skipped, greedy_tokens_equal_to_plain=tokens_equal,
        **hook_fields,
        accuracy_lm_only=continuation_accuracy(stream, prompts, gens0),
        accuracy_with_knn=continuation_accuracy(stream, prompts, gens3),
        tokens_lmbda_0=gens0, tokens_lmbda_03=gens3,
    )
    for ok, msg in checks:
        need(ok, msg)
    knn = {"bitsample_pack": dict(wide=wide_a, path_shapes=knn_a),
           "proj_sign_pack": dict(wide=wide_b, one_order=b_order),
           "query_tail": dict(path_shapes=knn_d, one_order=knn_order)}
    for name, extra in knn.items():
        extra["knn_lm_launch_shapes"] = lm_shapes.get(name, {})
    return f_row, knn, launches


def plain_loss(cfg, params, batch):
    """The plain path of the masked-prediction loss: every block without
    remat and with its attention in one block of all queries, the whole
    (B, S, V) logits, ``F.cross_entropy`` over the masked frames
    (``common.softmax_xent_plain``)."""
    import torch

    from repro_torch.models import common as C
    from repro_torch.models import dense

    x, mask = dense._embed_inputs(cfg, params, batch)
    s = x.shape[1]
    pos = torch.arange(s, device=x.device)

    def whole(q, k, v, *, causal, window, q_chunk):
        return C._chunked_attention_plain(q, k, v, causal, window, 0, None, s)

    for p in dense._layers(params):
        x = dense._block(cfg, p, x, pos, whole)[0]
    x = C.rms_norm(x, params["final_norm"])
    return C.softmax_xent_plain(x, dense.head_block(cfg, params), batch["targets"], mask)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict) else {f"{prefix}{k}": tree[k]})
    return out


def update_check(p, g, bits: int) -> dict:
    """Two ``adamw.update`` calls on one stacked leaf and its gradient, on
    the card and on a CPU copy: parameters and moments compared."""
    import torch

    from repro_torch.optim import adamw

    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS, state_bits=bits)
    card, host = {"w": p.detach().clone()}, {"w": p.detach().cpu()}
    s_card, s_host = adamw.init(card, opt), adamw.init(host, opt)
    out = dict(state_bits=bits, shape=list(p.shape), updates=2)
    for _ in range(2):
        _, s_card, m_card = adamw.update(opt, {"w": g}, s_card, card)
        _, s_host, m_host = adamw.update(opt, {"w": g.cpu()}, s_host, host)
    want, got = host["w"], card["w"].cpu()
    out["param_max_abs"] = float(want.abs().max())
    out["param_max_abs_err"] = float((got - want).abs().max())
    out["params_differing"] = int((got != want).sum())
    need(bool(torch.allclose(got, want, rtol=UPDATE_P_RTOL, atol=UPDATE_P_RTOL * out["param_max_abs"])),
         f"train: the card's update of {UPDATE_LEAF} ({bits}-bit) differs from the CPU's by {out['param_max_abs_err']}")
    out["grad_norm"] = [float(m_card["grad_norm"]), float(m_host["grad_norm"])]
    flips, elems = 0, 0
    for name, a in _flat({"m": s_card.m, "v": s_card.v}).items():
        b = _flat({"m": s_host.m, "v": s_host.v})[name]
        a = a.cpu()
        if name.endswith("/q"):
            d = (a.int() - b.int()).abs()
            need(int(d.max()) <= 1, f"train: {name} of the {bits}-bit update differs by {int(d.max())} counts")
            flips += int((d > 0).sum())
            elems += d.numel()
        else:
            need(bool(torch.allclose(a, b, rtol=UPDATE_M_RTOL, atol=UPDATE_M_RTOL * float(b.abs().max()))),
                 f"train: {name} of the {bits}-bit update differs from the CPU's")
    if bits == 8:
        out.update(q_counts_off_by_one=flips, q_counts=elems, q_off_by_one_why=(
            "the clip scale comes from a global norm summed in another order on the card, and v's fourth root is"
            " the card's powf, each possibly an ulp apart; a count flips where a scaled moment sits on a"
            " rounding boundary"))
    return out


def train_phase(dev, smoke: bool = False) -> dict:
    """LM training at hubert-xlarge's full size through ``launch.train``'s
    step and batches: the step-0 check against the plain path, 3 timed
    steps of float32 AdamW with remat "dots", 2 profiled steps, then kernel
    F's refusal of gradient-carrying inputs, the card-vs-CPU update of one
    stacked leaf, and the restart check at granite's smoke config under
    deterministic algorithms (``warn_only``: cuBLAS's alert about its
    workspace setting, which only this phase would need, is recorded, not
    raised). ``smoke`` takes hubert's smoke config at 4 x 64 frames.
    Returns the training path's launches."""
    import tempfile
    import warnings

    import torch

    from repro_torch import configs
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import api as mapi
    from repro_torch.optim import adamw
    from repro_torch.runtime import ft
    from repro_torch.train import loop as tl

    cfg = configs.get(TRAIN_ARCH, smoke=smoke)
    batch_n, seq = (4, 64) if smoke else (TRAIN_BATCH, TRAIN_SEQ)
    model = mapi.build_model(cfg)
    sync(dev)
    t0 = time.perf_counter()
    params = model.init_masters(SEED, dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    stream = TokenStream(cfg.vocab, seed=0)
    batches = [launch_train.make_batch(cfg, stream.batch(batch_n, seq), i, dev)
               for i in range(TRAIN_STEPS + TRAIN_PROFILED)]

    # 1. step 0: the training path against the plain path, on the first rows
    rows = {k: v[:TRAIN_CHECK_ROWS] for k, v in batches[0].items()}
    leaves = tl._leaves(params)
    names = list(_flat(params))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    loss_t, grads_t = tl._value_and_grad(model, params, rows)
    loss_p = plain_loss(cfg, params, rows)
    grads_p = torch.autograd.grad(loss_p, leaves, allow_unused=True)
    loss_p = loss_p.detach()
    check_peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    need(bool(torch.isclose(loss_t, loss_p, rtol=TRAIN_LOSS_RTOL)),
         f"train: step-0 loss {float(loss_t)} differs from the plain path's {float(loss_p)}")
    worst_frac, worst_cos = 0.0, 1.0
    for name, gt, gp in zip(names, grads_t, grads_p):
        need(bool(torch.isfinite(gt).all()), f"train: the gradient of {name} is not finite")
        gp = torch.zeros_like(gt) if gp is None else gp
        scale = float(gp.abs().max())
        if scale == 0.0:  # a leaf the loss never reads (embed)
            need(not bool(gt.any()), f"train: {name} has a gradient the plain path has not")
            continue
        frac = float((gt - gp).abs().max()) / scale
        cos = float((gt.double() * gp.double()).sum() / (gt.double().norm() * gp.double().norm()))
        worst_frac, worst_cos = max(worst_frac, frac), min(worst_cos, cos)
        need(frac <= TRAIN_GRAD_FRAC and cos >= TRAIN_GRAD_COS,
             f"train: the gradient of {name} differs from the plain path's ({frac} of its max, cosine {cos})")
    update_rows = [update_check(params["layers"][UPDATE_LEAF], grads_t[names.index(f"layers/{UPDATE_LEAF}")], bits)
                   for bits in (32, 8)]
    del grads_t, grads_p

    # 2. the timed steps, through launch.train's step function
    opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=max(TRAIN_STEPS // 10, 1), total_steps=TRAIN_STEPS,
                                state_bits=cfg.opt_state_bits)
    state = adamw.init(params, opt_cfg)
    step_fn = tl.make_train_step(model, opt_cfg)
    before = {n: t.detach().clone() for n, t in _flat(params).items()}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    steps = []
    for i in range(TRAIN_STEPS):
        sync(dev)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batches[i])
        sync(dev)
        steps.append(dict(step=i, ms=(time.perf_counter() - t0) * 1e3, **{k: float(v) for k, v in m.items()}))
        if i == 0:
            moved = [n for n, t in _flat(params).items() if not torch.equal(t.detach(), before[n])]
            need(moved == list(before), f"train: leaves that did not move after one update:"
                                        f" {sorted(set(before) - set(moved))}")
            del before
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    need(all(np.isfinite([s_["loss"], s_["grad_norm"]]).all() for s_ in steps), f"train: a non-finite step {steps}")
    med_ms = float(np.median([s_["ms"] for s_ in steps]))

    # the step split: the loss and gradients, then the update, each timed
    # alone, three times (medians)
    split = dict(loss_and_grads_ms=[], adamw_update_ms=[])
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        _, grads = tl._value_and_grad(model, params, batches[0])
        sync(dev)
        t1 = time.perf_counter()
        adamw.update(opt_cfg, tl._unflatten(params, iter(grads)), state, params)
        sync(dev)
        split["loss_and_grads_ms"].append((t1 - t0) * 1e3)
        split["adamw_update_ms"].append((time.perf_counter() - t1) * 1e3)
        del grads
    split = {k: float(np.median(v)) for k, v in split.items()}

    def profiled():
        nonlocal params, state
        for b in batches[TRAIN_STEPS:]:
            params, state, _ = step_fn(params, state, b)

    prof = profile_query(dev, profiled, queries=TRAIN_PROFILED)
    prof["steps"] = prof.pop("queries")
    emit("train_profile", arch=cfg.name, **split, **prof)
    del params, state, batches

    # 3. kernel F refuses inputs that carry gradients while grad mode is on
    g = torch.Generator(dev).manual_seed(SEED)
    q = torch.randn((1, cfg.n_heads, 128, cfg.head_dim), generator=g, device=dev, dtype=torch.bfloat16)
    refused = None
    if dev.type == "cuda":
        try:
            fa_ops.flash_attention(q.requires_grad_(), q.detach(), q.detach(), causal=False)
        except RuntimeError as e:
            refused = str(e)
        need(refused is not None and "no backward pass" in refused, "train: flash_attention took a q that requires"
                                                                  " gradients under grad mode")
        with torch.no_grad():  # the serving paths' way: accepted
            need(bool(torch.isfinite(fa_ops.flash_attention(q, q.detach(), q.detach(), causal=False).float()).all()),
                 "train: flash_attention under no_grad")

    # 4. restart continuity at granite's smoke config, bit for bit
    rcfg = configs.get("granite-8b", smoke=True)
    rmodel = mapi.build_model(rcfg)
    ropt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)

    def batch_fn(i):
        return launch_train.make_batch(rcfg, TokenStream(rcfg.vocab, seed=100 + i).batch(4, 64), i, dev)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
            warnings.simplefilter("always")
            first, resumed = ft.simulate_training_failure_and_restart(rmodel, ropt, tmp, 3, batch_fn, dev)
            rp = rmodel.init_masters(0, dev)
            rs = adamw.init(rp, ropt)
            rstep = tl.make_train_step(rmodel, ropt)
            straight = []
            for i in range(6):
                rp, rs, m = rstep(rp, rs, batch_fn(i))
                straight.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(False)
    need(first == straight[:3] and resumed == straight[3:],
         f"train: the restart's losses {first} + {resumed} are not the uninterrupted run's {straight}")

    emit(
        "train", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab, frontend_dim=cfg.frontend_dim,
        n_params=model.n_params, cut=None, batch=[batch_n, seq], frame_mask=0.3, remat=cfg.remat,
        state_bits=opt_cfg.state_bits, init_s=init_s, steps=steps, median_step_ms=med_ms,
        frames_per_s=batch_n * seq / (med_ms / 1e3), peak_mem_gb=peak_gb,
        device_idle_share=prof["device_idle_share"], launches=launches,
        step0_check=dict(rows=TRAIN_CHECK_ROWS, loss=float(loss_t), plain_loss=float(loss_p),
                         grad_max_frac_err=worst_frac, grad_min_cosine=worst_cos, leaves=len(names),
                         peak_mem_gb=check_peak_gb),
        every_leaf_moved=True, update_check=update_rows,
        flash_attention_refuses_grad_inputs=refused,
        restart=dict(arch=rcfg.name, losses_before=first, losses_after=resumed, uninterrupted=straight,
                     deterministic=True, warnings=sorted({str(w.message)[:160] for w in caught})),
    )
    return launches


def serve_twin_phase(dev) -> dict:
    """``examples/torch_serve_knn_lm.main`` on the card with its own
    ``"cuda"`` backend: train the serve-demo LM, build the datastore over
    its hidden states, serve 6 requests with lmbda 0 and 0.3. The loss must
    fall, kernels A, B, D and F launch, and the hook's output must equal
    ``knn_interpolate`` on the index's and the ``"torch"`` backend's
    answers."""
    from repro_torch.kernels import _build

    twin = _load_example("torch_serve_knn_lm")
    _build.reset_launches()
    t0 = time.perf_counter()
    out = twin.main(device=dev)
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    losses = out["losses"]
    checks = [(losses[-1] < losses[0], f"serve_twin: the loss did not fall ({losses[0]} -> {losses[-1]})")]
    if dev.type == "cuda":
        checks += [(launches.get(name, 0) > 0, f"serve_twin never launched {name}")
                   for name in ("bitsample_pack", "proj_sign_pack", "query_tail", "flash_attention")]
    index = out["index"]
    hook_fields = hook_checks("serve_twin", index, out["config"], index.deploy.grid, out["labels"], twin.CFG.vocab,
                              out["hook_calls"], checks)
    emit("serve_twin", arch=twin.CFG.name, train_steps=len(losses), loss_first=losses[0], loss_last=losses[-1],
         seconds=seconds, accuracy_lm_only=out["accuracy"][0.0], accuracy_with_knn=out["accuracy"][0.3],
         tokens_lmbda_0=out["tokens"][0.0], tokens_lmbda_03=out["tokens"][0.3], launches=launches, **hook_fields)
    for ok, msg in checks:
        need(ok, msg)
    return launches


def serve_phase(argv: list[str]) -> dict:
    """``repro_torch.launch.serve.main`` as a user runs it: the arch's
    weights from a seeded generator, 4 requests through ``ServeEngine``."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as launch_serve

    _build.reset_launches()
    t0 = time.perf_counter()
    done = launch_serve.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    cfg = configs.get(argv[argv.index("--arch") + 1], smoke="--smoke" in argv)
    max_new = max(len(r.result) for r in done)
    need(all(r.done and not r.timed_out and len(r.result) == max_new for r in done), "serve: a request did not finish")
    need(all(0 <= t < cfg.vocab for r in done for t in r.result), "serve: a token outside the vocabulary")
    passes = len(done) + max_new  # one prefill per request, one batched decode per step
    per_prefill, per_decode = flash_per_pass(cfg)
    want = len(done) * per_prefill + max_new * per_decode
    if torch.cuda.is_available():
        need(launches.get("flash_attention", 0) == want,
             f"serve: {launches.get('flash_attention', 0)} flash_attention launches for {passes} forward passes,"
             f" not {want}")
    emit("serve", argv=argv, arch=cfg.name, requests=len(done), new_tokens=max_new, seconds=seconds,
         latency_ms=[r.latency_s * 1e3 for r in done], tokens=[r.result for r in done],
         forward_passes=passes, launches=launches, flash_attention_launches_expected=want)
    return launches


def flash_per_pass(cfg) -> tuple[int, int]:
    """Kernel F's launches in one prefill and in one decode step of
    ``cfg``'s model: one per layer's attention, none in mamba2 (no
    attention), and in hymba's decode step only the global layers' (its
    sliding-window layers attend over their ring in torch ops, as the JAX
    package's do in XLA)."""
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        return cfg.n_layers, len(cfg.global_layers)
    return cfg.n_layers, cfg.n_layers


def logit_gate(arch: str, cfg, model, params, prompt, max_len: int, first,
               gate_faults: bool = True, read_faults: bool = True) -> tuple[list, dict]:
    """The model with F against the same model with the plain attention on
    the first prefill and decode step: ``first`` holds the path's logits
    of both; the tolerance is twice the gap to the model with F's plain
    version plus ``LOGIT_ATOL``, and with ``gate_faults`` it must catch the
    planted faults (``fault_sink`` where the model has meta tokens,
    ``QK_FAULTS`` where it normalizes q and k), which
    are otherwise only read (and with ``read_faults`` False not run).
    Returns the checks and the readings."""
    import torch

    tok0 = torch.argmax(first[0], dim=-1).to(torch.int32)[:, None]

    def first_logits():
        lg, c = model.prefill(params, prompt, max_len)
        return lg, model.decode_step(params, c, tok0)[0]

    with model_attention("plain"):
        plain = first_logits()
    with model_attention("attention_ref"):
        alt = first_logits()

    def logit_errs(got):
        return [float((a - b).abs().max()) for a, b in zip(got, plain)]

    logit_err, logit_floor = logit_errs(first[:2]), logit_errs(alt)
    logit_tol = 2 * max(logit_floor) + LOGIT_ATOL
    checks = [(max(logit_err) <= logit_tol, f"{arch}: logits differ from the plain model's by {logit_err} > {logit_tol}")]
    faults = GATED_FAULTS + ((SINK_FAULT,) if cfg.meta_tokens else ()) + (QK_FAULTS if cfg.qk_norm else ())
    fault_err = {}
    for kind in faults if gate_faults or read_faults else ():
        with planted_fault(kind):
            fault_err[kind] = logit_errs(first_logits())
    checks += [(max(fault_err[kind]) > logit_tol,
                f"{arch}: the logit gate {logit_tol} misses {kind} (errors {fault_err[kind]})")
               for kind in faults if gate_faults]
    return checks, dict(logits_max_abs=[float(x.abs().max()) for x in plain], logits_max_abs_err_vs_plain=logit_err,
                        logits_plain_vs_attention_ref=logit_floor, logit_tolerance=logit_tol,
                        logits_planted_fault_err=fault_err)


def families_phase(dev, smoke: bool = False) -> dict:
    """The moe, ssm and hybrid families and qwen3-32b served whole:
    olmoe-1b-7b, mamba2-780m, hymba-1.5b and qwen3-32b at their FULL widths
    and depths (their smoke configs with ``smoke``), weights from a seeded
    generator on the card, B = 2 prompts
    of FAMILY_PROMPTS tokens (mamba2's not a multiple of its 128 chunk;
    hymba's 1,920 behind 128 meta tokens, past window + meta tokens, so the
    window, the sink and the ring's wrap all bite), then FAMILY_STEPS greedy
    decode steps. Per family: the draw's peak, prefill ms, ms per decode
    step, the serving peak,
    F's launches against ``flash_per_pass`` (checked on the card); on olmoe,
    hymba and qwen3 the logit gate (first prefill and decode logits with F
    against the plain attention, planted faults caught, ``fault_sink`` on
    hymba, ``QK_FAULTS`` on qwen3); on mamba2 and hymba decode after
    ``prefill(s)`` against ``prefill(s + 1)``; on mamba2 ``ssd_chunked`` against ``ssd_reference``
    at FULL's dims; ``families_profile``: the path once more, profiled (the
    card's kernels only); then ``launch.serve`` for the family. Returns the
    launches of all of it but the profiled pass."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.models import api as mapi
    from repro_torch.models import mamba2

    total: dict = {}
    for arch, plen in FAMILY_PROMPTS.items():
        cfg = dataclasses.replace(configs.get(arch, smoke=smoke), **({} if smoke else FAMILY_CUT.get(arch, {})))
        if smoke:  # the same cases at the smoke configs' chunk (16) and window (16)
            plen = {"olmoe-1b-7b": 40, "mamba2-780m": 37, "hymba-1.5b": 24, "qwen3-32b": 40}[arch]
        model = mapi.build_model(cfg)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        sync(dev)
        t0 = time.perf_counter()
        params = model.init(SEED, dev)
        sync(dev)
        init_s = time.perf_counter() - t0
        init_peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
        toks = torch.as_tensor(TokenStream(cfg.vocab, seed=5).batch(FAMILY_BATCH, plen + 1), device=dev)
        prompt = {"tokens": toks[:, :plen]}
        max_len = plen + cfg.meta_tokens + FAMILY_STEPS + 1
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        checks: list = []

        # the path: prefill, then greedy decode steps
        sync(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, max_len)
        sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        first = [logits]
        decode_ms, gen = [], []
        for _ in range(FAMILY_STEPS):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            gen.append(nxt[:, 0].tolist())
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, nxt)
            sync(dev)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            if len(first) == 1:
                first.append(logits)
        launches = dict(_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
        per_prefill, per_decode = flash_per_pass(cfg)
        want_f = per_prefill + FAMILY_STEPS * per_decode
        if dev.type == "cuda":
            checks.append((launches == ({"flash_attention": want_f} if want_f else {}),
                           f"{arch}: launches {launches}, not {want_f} of flash_attention alone"))
        checks.append((tuple(logits.shape) == (FAMILY_BATCH, cfg.vocab) and bool(torch.isfinite(logits).all())
                       and all(bool(torch.isfinite(t).all()) for t in first),
                       f"{arch}: logits of shape {tuple(logits.shape)}, or not finite"))
        checks.append((cache["len"].tolist() == [plen + cfg.meta_tokens + FAMILY_STEPS] * FAMILY_BATCH,
                       f"{arch}: cache len {cache['len'].tolist()}"))
        del cache
        fields = dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
                      cut=None if smoke or arch not in FAMILY_CUT else "16 of 32 layers: the script's time",
                      n_params=model.n_params, init_s=init_s, init_peak_mem_gb=init_peak_gb, batch=FAMILY_BATCH,
                      prompt_len=plen,
                      positions=plen + cfg.meta_tokens, decode_steps=FAMILY_STEPS, prefill_ms=prefill_ms,
                      decode_step_ms=float(np.median(decode_ms)), decode_step_ms_each=decode_ms, peak_mem_gb=peak_gb,
                      flash_attention_launches=launches.get("flash_attention", 0),
                      flash_attention_launches_expected=want_f, launches=launches, tokens=gen)

        # the logit gate: the model with F against the same model with the
        # plain attention on the first prefill and decode step (as knn_lm's)
        if per_prefill:
            gate_checks, gate_fields = logit_gate(arch, cfg, model, params, prompt, max_len, first)
            checks += gate_checks
            fields.update(gate_fields)

        # decode after prefill(s) continues prefill(s + 1) (not for moe: its
        # capacity drops other tokens at T = s and T = 1)
        if cfg.family in ("ssm", "hybrid"):
            _, c = model.prefill(params, prompt, max_len)
            stepped = model.decode_step(params, c, toks[:, plen:])[0]
            whole = model.prefill(params, {"tokens": toks}, max_len)[0]
            gap, scale = float((stepped - whole).abs().max()), float(whole.abs().max())
            checks.append((gap <= CONT_FRAC * scale,
                           f"{arch}: decode after prefill({plen}) differs from prefill({plen + 1}) by {gap} >"
                           f" {CONT_FRAC} * {scale}"))
            fields.update(continuation_max_abs_err=gap, continuation_tolerance=CONT_FRAC * scale)
            del c
        if cfg.family == "ssm":  # the chunked SSD against the exact recurrence at FULL's dims
            _, n_heads, _, _ = mamba2.dims(cfg)
            g = torch.Generator(dev).manual_seed(SEED)

            def rnd(*shape):
                return torch.randn(shape, generator=g, device=dev)

            xh, bm, cm = rnd(FAMILY_BATCH, plen, n_heads, cfg.ssm_headdim), rnd(FAMILY_BATCH, plen, cfg.ssm_state), \
                rnd(FAMILY_BATCH, plen, cfg.ssm_state)
            dt, a = torch.nn.functional.softplus(rnd(FAMILY_BATCH, plen, n_heads)), -torch.exp(0.5 * rnd(n_heads))
            yc, hc = mamba2.ssd_chunked(xh, dt, a, bm, cm, cfg.ssm_chunk)
            yr, hr = mamba2.ssd_reference(xh, dt, a, bm, cm)
            y_err = float((yc - yr).abs().max()) / float(yr.abs().max())
            h_err = float((hc - hr).abs().max()) / float(hr.abs().max())
            checks.append((max(y_err, h_err) <= SSD_RTOL,
                           f"{arch}: ssd_chunked differs from ssd_reference by {y_err}, {h_err} of the largest"))
            fields.update(ssd_shape=[FAMILY_BATCH, plen, n_heads, cfg.ssm_headdim, cfg.ssm_state],
                          ssd_chunked_vs_reference=dict(y=y_err, state=h_err, tolerance=SSD_RTOL))
            del xh, bm, cm, dt, yc, yr, hc, hr
        emit("families", **fields)
        for ok, msg in checks:
            need(ok, msg)

        def served():  # the path once more: prefill and the greedy steps
            lg, c = model.prefill(params, prompt, max_len)
            for _ in range(FAMILY_STEPS):
                lg, c = model.decode_step(params, c, torch.argmax(lg, dim=-1).to(torch.int32)[:, None])

        # where its time goes: the card's kernels only (hymba's prefill is
        # some 10^5 small ops, whose host records would slow it)
        emit("families_profile", arch=cfg.name, **profile_query(dev, served, queries=FAMILY_STEPS))
        del params, first, logits
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        serve = serve_phase(["--arch", arch] + (["--smoke", "--device", dev.type] if smoke else []))
        for part in (launches, serve):
            for name, n in part.items():
                total[name] = total.get(name, 0) + n
    return total



@contextlib.contextmanager
def plain_ssd():
    """``ssd_reference``, the exact per-token recurrence, in place of
    ``ssd_chunked`` in the mixer (its output in x's dtype, as the chunked
    form returns it)."""
    from repro_torch.models import mamba2

    saved = mamba2.ssd_chunked

    def reference(xh, dt, a, bm, cm, chunk):
        y, h = mamba2.ssd_reference(xh.float(), dt, a, bm, cm)
        return y.to(xh.dtype), h

    mamba2.ssd_chunked = reference
    try:
        yield
    finally:
        mamba2.ssd_chunked = saved


def family_loss_variant(cfg, params, rows, kind: str):
    """The loss and the gradient of every master leaf on ``rows`` by one of
    three paths: ``"train"`` the model's own (``loss_fn`` with the config's
    remat); ``"other_order"`` the same arithmetic in other float32 orders
    (attention in query blocks of half the size, the SSD in chunks of half
    the size), whose gap to ``"train"`` is the rounding floor; ``"plain"``
    attention in one block of all queries, whole logits in one chunk, for
    moe no remat, for mamba2 and hymba ``ssd_reference`` in place of
    ``ssd_chunked`` with every layer under a full checkpoint (the
    recurrence would keep each token's state for the backward pass)."""
    import dataclasses

    from repro_torch.models import api as mapi
    from repro_torch.train import loop as tl

    s_tot = rows["tokens"].shape[1] + cfg.meta_tokens
    if kind == "other_order":
        cfg = dataclasses.replace(cfg, q_chunk=max(cfg.q_chunk // 2, 1), ssm_chunk=max(cfg.ssm_chunk // 2, 1))
    elif kind == "plain":
        cfg = dataclasses.replace(cfg, q_chunk=s_tot, loss_chunk=rows["tokens"].shape[1],
                                  remat="none" if cfg.family == "moe" else "full")
    model = mapi.build_model(cfg)
    with plain_ssd() if kind == "plain" and cfg.family in ("ssm", "hybrid") else contextlib.nullcontext():
        loss, grads = tl._value_and_grad(model, params, rows)
    del model
    return loss, grads


def grad_stats(a, b) -> tuple[float, float, float]:
    """(max |a - b|, max |b|, cosine of a and b) of two gradients of a leaf,
    in float64 one layer slice at a time (olmoe's expert stacks hold 2.1 B
    elements)."""
    import torch

    err = scale = dot = na = nb = 0.0
    for x, y in zip(*((t.unbind(0) if t.dim() >= 3 else (t,)) for t in (a, b))):
        x, y = x.double(), y.double()
        err, scale = max(err, float((x - y).abs().max())), max(scale, float(y.abs().max()))
        dot, na, nb = dot + float((x * y).sum()), na + float((x * x).sum()), nb + float((y * y).sum())
    return err, scale, dot / max((na * nb) ** 0.5, torch.finfo(torch.float64).tiny)


def families_train_phase(dev, smoke: bool = False) -> dict:
    """The moe, ssm and hybrid families trained at FULL width, then served
    from their trained masters: olmoe-1b-7b (with bf16 masters and 8-bit
    moments, the stated cut), mamba2-780m and hymba-1.5b (cut in depth,
    ``FT_DEPTH``; float32 AdamW, their configs' remat "full", hymba's two
    microbatches), masters from a
    seeded generator. Per family: the step-0 check on the first rows (the
    training path's loss and every gradient, which must be finite, against
    the plain path of ``family_loss_variant``, the tolerance widened by the
    training path's own gap to ``"other_order"``; on olmoe the gradients of
    two identical calls compared bit for bit), ``FT_STEPS`` timed steps through
    ``train.loop.make_train_step`` (every leaf moves after the first, the
    loss stays finite; the last of them profiled, ``families_train_profile``),
    then ``serving(masters)``: prefill and FT_SERVE_STEPS greedy
    decode steps with F's launches counted against ``flash_per_pass`` and
    the logit gate of the ``families`` phase. Last, the restart check at
    olmoe's smoke config under deterministic algorithms. ``smoke`` takes
    the smoke configs at small batches. Returns the launches of the
    training steps and the serving passes."""
    import dataclasses
    import tempfile
    import warnings

    import torch

    from repro_torch import configs
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.models import api as mapi
    from repro_torch.optim import adamw
    from repro_torch.runtime import ft
    from repro_torch.train import loop as tl

    total: dict = {}
    for arch, (batch_n, seq) in FT_BATCH.items():
        cut = dict(FT_CUT.get(arch, {}), **({} if smoke else FT_DEPTH.get(arch, {})))
        cfg = dataclasses.replace(configs.get(arch, smoke=smoke), **cut)
        rows_n, prefix = FT_CHECK[arch]
        serve_len = FT_SERVE_PROMPT[arch]
        if smoke:
            batch_n, seq, rows_n, prefix, serve_len = 4, 32, 2, 32, 24
        model = mapi.build_model(cfg)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        sync(dev)
        t0 = time.perf_counter()
        params = model.init_masters(SEED, dev)
        sync(dev)
        init_s = time.perf_counter() - t0
        stream = TokenStream(cfg.vocab, seed=3)
        batches = [launch_train.make_batch(cfg, stream.batch(batch_n, seq), i, dev)
                   for i in range(FT_STEPS[arch])]
        names = list(_flat(params))
        checks: list = []

        # 1. step 0 on the first rows: the training path against the plain one
        rows = {"tokens": batches[0]["tokens"][:rows_n, :prefix]}
        loss_t, grads_t = family_loss_variant(cfg, params, rows, "train")
        nonfinite = [n for n, g in zip(names, grads_t) if not bool(torch.isfinite(g).all())]
        need(not nonfinite, f"families_train {arch}: step-0 gradients not finite: {nonfinite[:8]}")
        # each other path's gradients are reduced to per-leaf readings at once
        # (olmoe's are 13.8 GB a set)
        loss_o, grads = family_loss_variant(cfg, params, rows, "other_order")
        gaps = [grad_stats(gt, go) for gt, go in zip(grads_t, grads)]
        del grads
        loss_p, grads = family_loss_variant(cfg, params, rows, "plain")
        errs = [grad_stats(gt, gp) for gt, gp in zip(grads_t, grads)]
        del grads
        check_peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
        loss_tol = FT_LOSS_RTOL * abs(float(loss_p)) + 2 * abs(float(loss_t - loss_o))
        checks.append((abs(float(loss_t - loss_p)) <= loss_tol,
                       f"{arch}: step-0 loss {float(loss_t)} differs from the plain path's {float(loss_p)} by more"
                       f" than {loss_tol}"))
        worst_frac, worst_cos, worst_excess = 0.0, 1.0, 0.0
        for name, (gap, _, cos_gap), (err, scale, cos) in zip(names, gaps, errs):
            frac_tol = TRAIN_GRAD_FRAC * scale + 2 * gap
            cos_floor = TRAIN_GRAD_COS - 2 * (1.0 - cos_gap)
            worst_frac, worst_cos = max(worst_frac, err / max(scale, 1e-30)), min(worst_cos, cos)
            worst_excess = max(worst_excess, err / max(frac_tol, 1e-30))
            checks.append((scale > 0.0 and err <= frac_tol and cos >= cos_floor,
                           f"{arch}: the step-0 gradient of {name} differs from the plain path's ({err} > {frac_tol}"
                           f" or cosine {cos} < {cos_floor})"))
        step0 = dict(rows=rows_n, tokens=prefix, loss=float(loss_t), plain_loss=float(loss_p),
                     other_order_loss=float(loss_o), loss_tolerance=loss_tol, grad_max_frac_err=worst_frac,
                     grad_min_cosine=worst_cos, grad_err_over_tolerance=worst_excess, leaves=len(names),
                     peak_mem_gb=check_peak_gb)
        if cfg.family == "moe":  # the index backward passes accumulate into rows: the same bits twice?
            _, again = family_loss_variant(cfg, params, rows, "train")
            differ = [n for n, a, b in zip(names, grads_t, again) if not torch.equal(a, b)]
            step0["grads_repeat_bitwise_equal"] = not differ
            step0["grads_repeat_differing_leaves"] = differ
            checks.append((not differ, f"{arch}: two identical step-0 calls give other gradient bits in {differ}"))
            del again
        del grads_t

        # 2. the timed steps
        opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=FT_STEPS[arch],
                                    state_bits=cfg.opt_state_bits)
        state = adamw.init(params, opt_cfg)
        step_fn = tl.make_train_step(model, opt_cfg)
        before = {n: t.detach().to("cpu", copy=True) for n, t in _flat(params).items()}  # host copies (13.8 GB on olmoe)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        steps = []
        for i in range(FT_STEPS[arch]):
            out = {}

            def one(i=i, out=out):
                nonlocal params, state
                params, state, out["m"] = step_fn(params, state, batches[i])

            sync(dev)
            t0 = time.perf_counter()
            if i == FT_STEPS[arch] - 1:
                prof = profile_query(dev, one, queries=1)
                ms = prof["wall_s"] * 1e3
            else:
                one()
                sync(dev)
                ms = (time.perf_counter() - t0) * 1e3
            steps.append(dict(step=i, ms=ms, **{k: float(v) for k, v in out["m"].items()}))
            if i == 0:
                still = sorted(n for n, t in _flat(params).items() if torch.equal(t.detach().cpu(), before[n]))
                # bf16 masters keep no update below half a bf16 ulp: a norm
                # weight at its init of 1.0 moves by lr * (1 + weight decay),
                # 0.0011, under half the 0.0039 bf16 step below 1.0
                kept = [n for n in still if cfg.param_dtype == "bfloat16" and bool((before[n] == 1.0).all())]
                need(still == kept, f"families_train {arch}: leaves that did not move after one update: {still}")
                del before
        launches = dict(_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
        need(all(np.isfinite([s_["loss"], s_["grad_norm"]]).all() for s_ in steps),
             f"families_train {arch}: a non-finite step {steps}")
        if dev.type == "cuda":
            checks.append((not launches, f"{arch}: the training steps launched {launches}"))
        med_ms = float(np.median([s_["ms"] for s_ in steps]))
        prof["steps"] = prof.pop("queries")
        emit("families_train_profile", arch=cfg.name, **prof)
        del state, batches

        # 3. serving the trained masters
        served = model.serving(params)
        toks = torch.as_tensor(TokenStream(cfg.vocab, seed=5).batch(FAMILY_BATCH, serve_len), device=dev)
        prompt = {"tokens": toks}
        max_len = serve_len + cfg.meta_tokens + FT_SERVE_STEPS + 1
        sync(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(served, prompt, max_len)
        first = [logits]
        for _ in range(FT_SERVE_STEPS):
            logits, cache = model.decode_step(served, cache, torch.argmax(logits, dim=-1).to(torch.int32)[:, None])
            if len(first) == 1:
                first.append(logits)
        sync(dev)
        serve_s = time.perf_counter() - t0
        serve_launches = dict(_build.LAUNCHES)
        per_prefill, per_decode = flash_per_pass(cfg)
        want_f = per_prefill + FT_SERVE_STEPS * per_decode
        if dev.type == "cuda":
            checks.append((serve_launches == ({"flash_attention": want_f} if want_f else {}),
                           f"{arch}: serving the trained masters launched {serve_launches}, not {want_f} of"
                           f" flash_attention alone"))
        checks.append((tuple(logits.shape) == (FAMILY_BATCH, cfg.vocab)
                       and all(bool(torch.isfinite(t).all()) for t in first + [logits]),
                       f"{arch}: served logits of shape {tuple(logits.shape)}, or not finite"))
        del cache
        gate = {}
        if per_prefill:
            # the planted faults are read, not gated: four steps on the
            # synthetic stream leave logits of about 16, where a bf16 ulp is
            # 0.125, and a model that barely reads attention yet, so shifting
            # every query's causal edge moved olmoe's logits by one ulp (my
            # chip run 2); the families phase gates them on the same code
            gate_checks, gate = logit_gate(arch, cfg, model, served, prompt, max_len, first, gate_faults=False)
            checks += gate_checks
        for part in (launches, serve_launches):
            for name, n in part.items():
                total[name] = total.get(name, 0) + n
        tokens_per_step = batch_n * seq
        emit("families_train", arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers, d_model=cfg.d_model,
             n_params=model.n_params, cut=FT_CUT_WHY.get(arch) if cut else None, param_dtype=cfg.param_dtype,
             state_bits=opt_cfg.state_bits, remat=cfg.remat, microbatches=cfg.microbatches,
             batch=[batch_n, seq], positions=seq + cfg.meta_tokens, init_s=init_s, step0_check=step0,
             unmoved_after_one_update=kept,
             steps=steps, median_step_ms=med_ms, tokens_per_s=tokens_per_step / (med_ms / 1e3), peak_mem_gb=peak_gb,
             device_idle_share=prof["device_idle_share"], launches=launches,
             serve=dict(prompt_len=serve_len, decode_steps=FT_SERVE_STEPS, seconds=serve_s,
                        flash_attention_launches=serve_launches.get("flash_attention", 0),
                        flash_attention_launches_expected=want_f, launches=serve_launches, **gate))
        for ok, msg in checks:
            need(ok, f"families_train {msg}")
        del params, served, first, logits, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # 4. restart continuity at olmoe's smoke config, bit for bit
    rcfg = configs.get("olmoe-1b-7b", smoke=True)
    rmodel = mapi.build_model(rcfg)
    ropt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)

    def batch_fn(i):
        return launch_train.make_batch(rcfg, TokenStream(rcfg.vocab, seed=100 + i).batch(4, 64), i, dev)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
            warnings.simplefilter("always")
            first_run, resumed = ft.simulate_training_failure_and_restart(rmodel, ropt, tmp, 3, batch_fn, dev)
            rp = rmodel.init_masters(0, dev)
            rs = adamw.init(rp, ropt)
            rstep = tl.make_train_step(rmodel, ropt)
            straight = []
            for i in range(6):
                rp, rs, m = rstep(rp, rs, batch_fn(i))
                straight.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(False)
    emit("families_train_restart", arch=rcfg.name, losses_before=first_run, losses_after=resumed,
         uninterrupted=straight, deterministic=True, warnings=sorted({str(w.message)[:160] for w in caught}))
    need(first_run == straight[:3] and resumed == straight[3:],
         f"families_train: the restart's losses {first_run} + {resumed} are not the uninterrupted run's {straight}")
    return total

@contextlib.contextmanager
def mesh_fault(kind: str):
    """Plant one of ``LMM_FAULTS`` in this process's model code while the
    block runs."""
    import torch

    from repro_torch.models import moe as tmoe
    from repro_torch.sharding import ctx

    if kind == "fault_expert_share":
        module, name = tmoe, "_expert_compute"
        saved = tmoe._expert_compute

        def planted(*args):
            out = saved(*args)
            mesh = ctx.get_mesh()
            return out * 0 if mesh is not None and ctx.axis_index(mesh, "model") == 1 else out
    elif kind == "fault_cp_max":
        module, name = ctx, "pmax"
        saved = ctx.pmax

        def planted(mesh, axes, x):
            return x.detach()
    elif kind == "fault_vocab_block":
        from repro_torch.models import common as C

        module, name = C, "embed_tokens"
        saved = C.embed_tokens

        def planted(embed, tokens, vocab_axes=(), seq=()):
            mesh = ctx.get_mesh()
            if vocab_axes and ctx.axis_index(mesh, "model") == 1:
                embed = torch.roll(embed, -1, 0)
            return saved(embed, tokens, vocab_axes, seq)
    elif kind == "fault_seq_scatter":
        module, name = ctx, "psum_scatter"
        saved = ctx.psum_scatter

        def planted(mesh, axes, x, dim):
            axes = ctx._live(mesh, axes)
            if not axes:
                return x
            whole = ctx.psum(mesh, axes, x)
            n = ctx.axis_size(mesh, axes)
            b = x.shape[dim] // n
            return whole.narrow(dim, (ctx.block_index(mesh, axes) + 1) % n * b, b)
    elif kind in ("fault_ssm_state", "fault_conv_tail"):
        from repro_torch.models import mamba2

        module, name = mamba2, "whole_cache"
        saved = mamba2.whole_cache

        def planted(cfg, state, conv):
            mesh = ctx.get_mesh()
            if mesh is not None and ctx.axis_index(mesh, "model") == 1:
                state, conv = (torch.zeros_like(state), conv) if kind == "fault_ssm_state" else \
                    (state, torch.zeros_like(conv))
            return saved(cfg, state, conv)
    elif kind == "fault_meta_shift":
        from repro_torch.models import hymba

        module, name = hymba, "_embed_with_meta"
        saved = hymba._embed_with_meta

        def planted(cfg, model, tokens, emb=None):
            x = saved(cfg, model, tokens, emb)
            mesh = ctx.get_mesh()
            seq = ctx.seq_split(tokens.shape[1] + cfg.meta_tokens)
            return torch.roll(x, 1, 1) if mesh is not None and seq and ctx.block_index(mesh, seq) == 0 else x
    elif kind == "fault_keep_slice":
        module, name = ctx, "keep_block"
        saved = ctx.keep_block

        def planted(mesh, axes, x, dim):
            return ctx.block_along(mesh, axes, x, dim)
    else:
        raise ValueError(f"unknown planted fault {kind!r}")
    setattr(module, name, planted)
    try:
        yield
    finally:
        setattr(module, name, saved)


def lm_mesh_rank(cases) -> list:
    """A rank of the lm_mesh phase: for each ``(job, faults)`` of ``cases``,
    the serving weights freed and the peak reset, then
    ``launch.lm_mesh_job.run(job)`` and each ``(kind, job)`` of ``faults``
    with that fault planted (the job's serving weights kept for them) ->
    per case the reports, the job's first."""
    import torch

    from repro_torch.launch import lm_mesh_job

    out = []
    for job, faults in cases:
        lm_mesh_job._SERVED.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reports = [lm_mesh_job.run(job)]
        for kind, fjob in faults:
            with mesh_fault(kind):
                reports.append(lm_mesh_job.run(fjob))
        out.append(reports)
    return out


def held_checks(tag: str, held, spec) -> list:
    """Each rank's bytes on the card (``held``, None off the card) within
    ``LMM_HELD_RTOL`` of its blocks' bytes under the JAX spec."""
    return [(abs(h - s_) <= LMM_HELD_RTOL * s_, f"{tag}: rank {r} holds {h} bytes, its spec blocks {s_}")
            for r, (h, s_) in enumerate(zip(held, spec)) if h is not None]


def replicas_differ(model, mesh_shape, coords, digests) -> list:
    """The leaves of which two ranks holding the same block under the JAX
    spec (its replicas) hold other bits (``digests``: each rank's
    ``params_digest``)."""
    from repro_torch.launch import lm_mesh_job
    from repro_torch.models import params as PM
    from repro_torch.sharding import ctx

    bad = []
    for n, d in lm_mesh_job._flat(model.defs).items():
        blocks: dict = {}
        for c, dg in zip(coords, digests):
            sh = PM.sharding_of(d, ctx.dry_mesh(("data", "model"), mesh_shape, tuple(c)))
            blocks.setdefault(tuple(sh._cuts(d.shape, sh.spec)), set()).add(dg[n])
        if any(len(v) > 1 for v in blocks.values()):
            bad.append(n)
    return bad


def step0_checks(tag: str, grad_reps, loss_t, loss_o) -> tuple[list, dict]:
    """The ranks' step-0 loss and reduced gradients against this process's
    by the families_train rule -> (checks, readings)."""
    checks = []
    loss_tol = FT_LOSS_RTOL * abs(float(loss_t)) + 2 * abs(float(loss_t - loss_o))
    mesh_loss = grad_reps[0]["loss"]
    checks.append((len({g["loss"] for g in grad_reps}) == 1, f"{tag}: the ranks' step-0 losses differ"))
    checks.append((abs(mesh_loss - float(loss_t)) <= loss_tol,
                   f"{tag}: step-0 loss {mesh_loss} differs from one process's {float(loss_t)} by more than"
                   f" {loss_tol}"))
    worst_frac, worst_excess, worst_cos = 0.0, 0.0, 1.0
    for rank, g in enumerate(grad_reps):
        for name, (err, scale, cos, (gap, cos_gap)) in g["check"].items():
            frac_tol = TRAIN_GRAD_FRAC * scale + 2 * gap
            cos_floor = TRAIN_GRAD_COS - 2 * (1.0 - cos_gap)
            worst_frac = max(worst_frac, err / max(scale, 1e-30))
            worst_excess, worst_cos = max(worst_excess, err / max(frac_tol, 1e-30)), min(worst_cos, cos)
            checks.append((err <= frac_tol and cos >= cos_floor,
                           f"{tag}: rank {rank}'s step-0 gradient of {name} differs from"
                           f" one process's ({err} > {frac_tol} or cosine {cos} < {cos_floor})"))
    return checks, dict(loss=mesh_loss, one_process_loss=float(loss_t), other_order_loss=float(loss_o),
                        loss_tolerance=loss_tol, grad_max_frac_err=worst_frac, grad_err_over_tolerance=worst_excess,
                        grad_min_cosine=worst_cos, grad_seconds_per_rank=[g["seconds"] for g in grad_reps],
                        gloo_sent_bytes_per_rank=[g["traffic"]["sent_bytes"] for g in grad_reps])


def one_process_grads(tcfg, dev, rows_np, path: str):
    """The step-0 loss and gradients of ``tcfg``'s seeded masters on
    ``rows_np`` in this process (the training path and ``other_order``),
    saved at ``path`` for the ranks' ``grads`` step -> (the masters, the
    training path's loss, the other order's)."""
    import torch

    from repro_torch.models import api as mapi

    masters = mapi.build_model(tcfg).init_masters(0, dev)
    rows = {"tokens": torch.as_tensor(rows_np, device=dev)}
    loss_t, grads_t = family_loss_variant(tcfg, masters, rows, "train")
    names = list(_flat(masters))
    loss_o, grads = family_loss_variant(tcfg, masters, rows, "other_order")
    gaps = {n: (g_, c_) for n, (g_, _, c_) in zip(names, (grad_stats(a, b) for a, b in zip(grads_t, grads)))}
    del grads
    torch.save({"grads": {n: g.detach().cpu() for n, g in zip(names, grads_t)}, "gaps": gaps,
                "loss": float(loss_t)}, path)
    return masters, loss_t, loss_o


def served_with_routes(model, params, prompt, max_len: int, steps: int, feed=None):
    """Prefill, then ``steps`` decode steps in this process, greedy or fed
    with ``feed`` (B, steps), moe's routes recorded -> (each pass's logits
    as float32 numpy, each pass's routes as ``moe.routes_table`` puts them,
    the tokens decoded)."""
    import torch

    from repro_torch.models import moe as tmoe

    logits_out, routes = [], []

    def noted(fn):
        tmoe.ROUTES = []
        try:
            lg, c = fn()
        finally:
            rec, tmoe.ROUTES = tmoe.ROUTES, None
        logits_out.append(lg.float().cpu().numpy())
        routes.append(tmoe.routes_table([rec]))
        return lg, c

    toks = []
    with torch.no_grad():
        lg, cache = noted(lambda: model.prefill(params, prompt, max_len))
        for i in range(steps):
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)[:, None] if feed is None else \
                torch.as_tensor(feed[:, i : i + 1], dtype=torch.int32, device=lg.device)
            toks.append(nxt.cpu().numpy())
            lg, cache = noted(lambda: model.decode_step(params, cache, nxt))
    return logits_out, routes, (np.concatenate(toks, 1) if toks else None)


def route_flips(ref: list, got: list, row: int, cfg) -> list:
    """The decisions of one pass's read token (the last position) of
    ``row`` that differ between two runs' routes (``moe.routes_table``
    entries, one a layer) -> [(layer, kind, margin)]: ``top_k`` where the
    chosen experts differ, margin the reference's k-th and (k+1)-th router
    probabilities' gap over the k-th; ``capacity`` where the same experts
    were chosen and a slot went elsewhere, margin the gap between the
    token's weight and the capacity's edge (the last kept weight if the
    reference dropped it, the first dropped if it kept it) over the larger;
    inf where no near tie can explain the flip."""
    from repro_torch.models import moe as tmoe

    k = cfg.top_k
    out = []
    for layer, (r, g) in enumerate(zip(ref, got)):
        if np.array_equal(r["used"][row, -1], g["used"][row, -1]):
            continue
        p, e = r["top_p"][row, -1], r["top_e"][row, -1]
        if set(e[:k]) != set(g["top_e"][row, -1, :k]):
            out.append((layer, "top_k", float((p[k - 1] - p[k]) / p[k - 1])))
            continue
        w_all = r["top_p"][..., :k] / r["top_p"][..., :k].sum(-1, keepdims=True)
        cap = tmoe._capacity(r["used"].shape[0] * r["used"].shape[1], cfg)
        for x in np.flatnonzero(r["used"][row, -1] != g["used"][row, -1]):
            scores = np.sort(w_all[r["top_e"][..., :k] == x])[::-1]
            w = float(w_all[row, -1][list(e[:k]).index(x)])
            if len(scores) <= cap:
                out.append((layer, "capacity", float("inf")))
                continue
            edge = float(scores[cap] if r["used"][row, -1, x] else scores[cap - 1])
            out.append((layer, "capacity", abs(w - edge) / max(w, edge)))
    return out


def served_checks(tag: str, ref_logits, ref_routes, got_logits, got_routes, tol: float, cfg) -> tuple[list, dict]:
    """One served run's passes (``got``, the global batch's logits and
    routes of each pass) against the reference's, route by route (see
    ``LMM_ROUTE_TIE``; ``route_flips`` lists a row's differing decisions by
    layer; ``None`` routes, a family without experts, route alike) ->
    (checks, readings). ``catches`` in the readings lists the failed checks
    a planted fault may count as caught by: a row-pass's own check where it
    routes alike (its logits or its greedy token) or where its routes first
    differ past a near tie. A row-pass whose flip is a near tie is excused,
    and the checks of the run as a whole (routes alike on too few
    row-passes, a2a's drops) fail where a near tie puts them, so neither
    counts (``fault_caught``)."""
    checks, errs, flips, clean, catches = [], [], [], [], []

    def check(ok: bool, msg: str, catch: bool) -> None:
        checks.append((ok, msg))
        if catch and not ok:
            catches.append(msg)

    for j, (rl, rr, gl, gr) in enumerate(zip(ref_logits, ref_routes or [None] * len(ref_logits), got_logits,
                                             got_routes or [None] * len(got_logits))):
        errs.append([float(np.abs(gl[r] - rl[r]).max()) for r in range(rl.shape[0])])
        for r in range(rl.shape[0]):
            fl = route_flips(rr, gr, r, cfg) if rr is not None else []
            clean.append(not fl)
            if fl:
                first = [m for layer, _, m in fl if layer == fl[0][0]]
                flips.append(dict(pass_=j, row=r, logit_err=errs[-1][r], decisions=fl))
                check(max(first) <= LMM_ROUTE_TIE,
                      f"{tag}: pass {j} row {r}'s routes first differ from one process's at layer {fl[0][0]} past a"
                      f" near tie {fl}", True)
                continue
            check(errs[-1][r] <= tol, f"{tag}: pass {j} row {r}'s logits differ from one process's by"
                                      f" {errs[-1][r]} > {tol}, its routes alike", True)
            top2 = np.sort(rl[r])[-2:]
            if top2[1] - top2[0] > tol:
                check(int(np.argmax(gl[r])) == int(np.argmax(rl[r])),
                      f"{tag}: pass {j} row {r}'s greedy token differs from one process's past the tolerance", True)
        if gr is not None:
            dropped = sum(x["dropped"] for x in gr)
            check(dropped == 0, f"{tag}: pass {j}: a2a's receivers dropped {dropped} copies", False)
    check(2 * sum(clean) >= len(clean), f"{tag}: only {sum(clean)} of {len(clean)} row-passes route as one process"
                                        f" does", False)
    first = [m for f in flips for layer, _, m in f["decisions"] if layer == f["decisions"][0][0]]
    return checks, dict(logits_max_abs_err=errs, routes_alike=sum(clean), row_passes=len(clean), flips=flips,
                        first_flip_margin_max=max(first, default=None), catches=catches)


def fault_caught(reading: dict) -> bool:
    """A planted fault's served run (``served_checks``' readings) is caught
    when a check of a row-pass that is not excused failed."""
    return bool(reading["catches"])


def global_passes(outs, n: int, batch: int):
    """The global batch's logits of the first ``n`` passes of one served
    run (``outs``: each rank's report; every rank holds every row on a
    ``(1, 4)`` mesh) and, where the ranks recorded them, each pass's moe
    routes put together over the ranks (else None)."""
    from repro_torch.models.moe import routes_table

    need(all(o["rows"] == list(range(batch)) for o in outs), "lm_mesh: a rank lacks a row")
    return ([outs[0]["passes"][j]["logits"] for j in range(n)],
            [routes_table([o["passes"][j]["routes"] for o in outs]) for j in range(n)] if "routes" in
            outs[0]["passes"][0] else None)


def pass_readings(outs, n_passes: int) -> dict:
    """A served run's times (the slowest rank's), gloo and stream bytes,
    held and spec bytes, per rank or per pass."""
    decode_ms = [max(o["passes"][j]["seconds"] for o in outs) * 1e3 for j in range(1, n_passes)]
    sent = [max(o["passes"][j]["traffic"]["sent_bytes"] for o in outs) for j in range(n_passes)]
    stream = [max(o["passes"][j]["stream_bytes"] for o in outs) for j in range(n_passes)]
    return dict(prefill_ms=max(o["passes"][0]["seconds"] for o in outs) * 1e3, decode_ms_per_step=decode_ms,
                median_decode_ms=float(np.median(decode_ms)),
                gloo_sent_bytes_prefill=sent[0], gloo_sent_bytes_per_decode_step=sent[1:],
                stream_bytes_prefill=stream[0], stream_bytes_decode=max(stream[1:]),
                traffic_per_rank=[_rank_sum(o["passes"], lambda p: p["traffic"]) for o in outs],
                held_bytes_per_rank=[o["held_bytes"] for o in outs],
                spec_bytes_per_rank=[o["spec_bytes"] for o in outs])


def launch_checks(tag: str, outs, per_pass: int, on_card: bool) -> tuple[list, list]:
    """A served run's launches (on the card: F ``per_pass`` times a rank
    over the run, one a layer in prefill, since decode attention is
    context-parallel torch, and no other kernel) and held bytes ->
    (checks, F's launches a rank)."""
    checks = []
    f_per_rank = [sum(p["launches"].get("flash_attention", 0) for p in o["passes"]) for o in outs]
    if on_card:
        checks.append((f_per_rank == [per_pass] * len(outs),
                       f"{tag}: F launched {f_per_rank} times per rank, not {per_pass} (one a layer in"
                       f" prefill; decode attention is context-parallel torch)"))
        other = [set(p["launches"]) - {"flash_attention"} for o in outs for p in o["passes"]]
        checks.append((not any(other), f"{tag}: other kernels launched {other}"))
    checks.extend(held_checks(tag, [o["held_bytes"] for o in outs], [o["spec_bytes"] for o in outs]))
    return checks, f_per_rank


def train_checks(tag: str, reports, model, mesh_shape) -> tuple[list, list, dict]:
    """A trained case's reports (each rank's ``grads`` then ``train``
    step): equal and finite losses on every rank, every block bit for bit
    across its replicas, held bytes of the masters and of the state within
    ``LMM_HELD_RTOL`` of the spec's -> (checks, the ranks' losses,
    readings)."""
    checks = []
    train_reps = [r["steps"][1] for r in reports]
    losses = [[h["loss"] for h in t["history"]] for t in train_reps]
    checks.append((all(x == losses[0] for x in losses), f"{tag}: the ranks' losses differ {losses}"))
    checks.append((all(np.isfinite(losses[0])), f"{tag}: a loss is not finite {losses[0]}"))
    differ = replicas_differ(model, tuple(mesh_shape), [r["coords"] for r in reports],
                             [t["params_digest"] for t in train_reps])
    checks.append((not differ, f"{tag}: blocks differ across their replicas: {differ}"))
    for what in ("masters", "state"):
        checks.extend(held_checks(f"{tag} {what}", [t["held_bytes"][what] for t in train_reps],
                                  [t["spec_bytes"][what] for t in train_reps]))
    step_ms = [list(t["step_ms"]) for t in train_reps]
    return checks, losses, dict(
        step_ms_per_rank=step_ms, median_step_ms=float(np.median([max(x) for x in zip(*step_ms)])),
        gloo_sent_bytes_per_rank=[t["traffic"]["sent_bytes"] for t in train_reps],
        gloo_sent_bytes_per_step=max(t["traffic"]["sent_bytes"] for t in train_reps) / len(step_ms[0]),
        stream_bytes=max(t["stream_bytes"] for t in train_reps),
        host_copy_bytes_per_rank=[t["traffic"]["host_copy_bytes"] for t in train_reps],
        held_bytes_per_rank=[t["held_bytes"] for t in train_reps],
        spec_bytes_per_rank=[t["spec_bytes"] for t in train_reps],
        peak_mem_gb_per_rank=[(t.get("peak_mem_bytes") or 0) / 1e9 for t in train_reps])


def ssm_serve_reference(dev, arch: str, smoke: bool, tmp: str) -> dict:
    """mamba2-780m's or hymba-1.5b's one-process reference for the mesh's
    serving check (their smoke configs with ``smoke``, 16-token prompts):
    B = LMM_SSM_BATCH prompts of ``LMM_SSM_PROMPT`` tokens (saved under
    ``tmp`` for the ranks), prefill and LMM_SSM_STEPS greedy decode steps
    of the seeded model, and the tolerance: ``logit_gate``'s, twice the
    larger floor plus ``LOGIT_ATOL``, the floors being F's (the plain
    attention against ``attention_ref``, where the model attends) and the
    SSD's (the model with its chunk halved, another float32 order of the
    same sums) on the first prefill and decode step. The model is freed."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.models import api as mapi

    cfg = configs.get(arch, smoke=smoke)
    plen = 16 if smoke else LMM_SSM_PROMPT[arch]
    s_tot = plen + cfg.meta_tokens
    max_len = -(-(s_tot + LMM_SSM_STEPS) // LMM_SSM_SERVE_MESH[1]) * LMM_SSM_SERVE_MESH[1]
    prompts = TokenStream(cfg.vocab, seed=9).batch(LMM_SSM_BATCH, plen)
    path = os.path.join(tmp, f"{arch}_prompts.npy")
    np.save(path, prompts)
    prompt = {"tokens": torch.as_tensor(prompts, device=dev)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mapi.build_model(cfg)
    params = model.init(SEED, dev)
    logits, _, toks = served_with_routes(model, params, prompt, max_len, LMM_SSM_STEPS)
    checks, floors, gate = [], {}, {}
    if flash_per_pass(cfg)[0]:
        checks, gate = logit_gate(cfg.name, cfg, model, params, prompt, max_len,
                                  [torch.as_tensor(x, device=dev) for x in logits[:2]], gate_faults=False,
                                  read_faults=False)
        floors["attention"] = max(gate["logits_plain_vs_attention_ref"])
    other = mapi.build_model(dataclasses.replace(cfg, ssm_chunk=cfg.ssm_chunk // 2))
    o_logits = served_with_routes(other, params, prompt, max_len, 1, toks)[0]
    floors["ssd_order"] = max(float(np.abs(a - b).max()) for a, b in zip(o_logits, logits[:2]))
    out = dict(arch=arch, cfg=cfg, prompt_len=plen, positions=s_tot, max_len=max_len, prompts=path, logits=logits,
               tokens=toks, tol=2 * max(floors.values()) + LOGIT_ATOL, floors=floors, checks=checks,
               gate={k: v for k, v in gate.items() if k != "logits_planted_fault_err"},
               logits_max_abs=[float(np.abs(x).max()) for x in logits], seconds=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None)
    del params, model, other
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ssm_serve_case(ref: dict, device: str, smoke: bool) -> tuple:
    """The ``(job, faults)`` of ``lm_mesh_rank`` for one reference of
    ``ssm_serve_reference``: the seeded model served on
    ``make_local_mesh(1, 4)``, decode fed with the reference's tokens, then
    each of ``LMM_SSM_FAULTS`` over its decode steps."""
    from repro_torch.launch import lm_mesh_job

    def job(decode):
        return lm_mesh_job.LMMeshJob(mesh=LMM_SSM_SERVE_MESH, device=device, steps=(
            ("serve", dict(arch=ref["arch"], smoke=smoke, seed=SEED, prompts=ref["prompts"], max_len=ref["max_len"],
                           decode=decode, feed=ref["tokens"][:, :decode])),))

    return job(LMM_SSM_STEPS), tuple((kind, job(decode)) for kind, decode in LMM_SSM_FAULTS[ref["arch"]])


def ssm_serve_results(ref: dict, reports, on_card: bool) -> tuple[list, dict]:
    """The ranks' reports of ``ssm_serve_case`` (each rank's: the served
    run, then the faults') against ``ref`` -> (checks, readings): every
    pass within the tolerance and the greedy token the reference's past it
    (``served_checks``), every rank's tokens equal, F's launches a rank,
    held bytes, and each planted fault caught (``fault_caught``)."""
    cfg, n = ref["cfg"], len(ref["logits"])
    tag = f"lm_mesh {cfg.name}"
    outs = [r[0]["steps"][0] for r in reports]
    got, _ = global_passes(outs, n, LMM_SSM_BATCH)
    checks, reading = served_checks(tag, ref["logits"], None, got, None, ref["tol"], cfg)
    reading.pop("catches")
    argmaxes = [[np.argmax(p["logits"], -1) for p in o["passes"]] for o in outs]
    checks.append((all(all(np.array_equal(a, b) for a, b in zip(am, argmaxes[0])) for am in argmaxes),
                   f"{tag}: the ranks' greedy tokens differ"))
    held, f_per_rank = launch_checks(tag, outs, flash_per_pass(cfg)[0], on_card)
    checks += held
    faults = {}
    for fi, (kind, decode) in enumerate(LMM_SSM_FAULTS[ref["arch"]]):
        fouts = [r[1 + fi]["steps"][0] for r in reports]
        fgot, _ = global_passes(fouts, decode + 1, LMM_SSM_BATCH)
        _, fread = served_checks(f"{kind} {cfg.name}", ref["logits"][: decode + 1], None, fgot, None, ref["tol"], cfg)
        faults[kind] = dict(caught=fault_caught(fread), caught_by=fread["catches"][:3],
                            logits_max_abs_err=fread["logits_max_abs_err"])
        checks.append((fault_caught(fread), f"lm_mesh: the serving check misses {kind} on {cfg.name} ({fread})"))
    launches: dict = {}
    for o in outs:
        for p in o["passes"]:
            launches = _add(launches, p["launches"])
    return checks + ref["checks"], dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, mesh=list(LMM_SSM_SERVE_MESH), batch=LMM_SSM_BATCH,
        prompt_len=ref["prompt_len"], positions=ref["positions"], decode_steps=LMM_SSM_STEPS,
        max_len=ref["max_len"], logit_tolerance=ref["tol"], floors=ref["floors"], **reading,
        flash_attention_launches_per_rank=f_per_rank, seq_blocks=outs[0]["seq_blocks"],
        **pass_readings(outs, n), peak_mem_gb_per_rank=[(r[0].get("peak_mem_bytes") or 0) / 1e9 for r in reports],
        planted_faults=faults, launches=launches,
        reference=dict(seconds=ref["seconds"], peak_gb=ref["peak_gb"], logits_max_abs=ref["logits_max_abs"],
                       gate=ref["gate"]))


def ssm_train_reference(dev, arch: str, smoke: bool, tmp: str) -> dict:
    """mamba2-780m's or hymba-1.5b's one-process step-0 reference for the
    mesh's training check: the masters (float32, ``LMM_SSM_TRAIN``'s cut),
    the first LMM_TRAIN_ROWS rows of step 0's batch, the training path's
    loss and gradients and their gap to another float32 order
    (``one_process_grads``, saved under ``tmp``)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.data.lm_data import TokenStream

    over = {} if smoke else dict(LMM_SSM_TRAIN[arch])
    cfg = dataclasses.replace(configs.get(arch, smoke=smoke), **over)
    seq = 32 if smoke else LMM_SSM_TRAIN_SEQ
    rows_np = next(TokenStream(cfg.vocab, seed=0).batches(1, LMM_SSM_TRAIN_BATCH, seq))["tokens"][:LMM_TRAIN_ROWS]
    path = os.path.join(tmp, f"{arch}_grads.pt")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    masters, loss_t, loss_o = one_process_grads(cfg, dev, rows_np, path)
    del masters
    out = dict(arch=arch, cfg=cfg, overrides=over, seq=seq, rows=rows_np, grads=path, loss_t=loss_t, loss_o=loss_o,
               seconds=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ssm_train_case(ref: dict, device: str, smoke: bool) -> tuple:
    """The ``(job, faults)`` of ``lm_mesh_rank`` for one reference of
    ``ssm_train_reference``: the step-0 gradients and one step through
    ``launch.train.train`` on ``make_local_mesh(2, 2)``, then the step-0
    gradients again with ``LMM_TRAIN_FAULT`` planted (on
    ``LMM_TRAIN_FAULT_ARCH``)."""
    from repro_torch.launch import lm_mesh_job

    grads = ("grads", dict(arch=ref["arch"], smoke=smoke, overrides=ref["overrides"], rows=ref["rows"],
                           compare=ref["grads"]))
    train = ("train", dict(arch=ref["arch"], smoke=smoke, overrides=ref["overrides"], steps=1,
                           batch=LMM_SSM_TRAIN_BATCH, seq=ref["seq"]))

    def job(*steps):
        return lm_mesh_job.LMMeshJob(mesh=LMM_SSM_TRAIN_MESH, device=device, steps=steps)

    return job(grads, train), ((LMM_TRAIN_FAULT, job(grads)),) if ref["arch"] == LMM_TRAIN_FAULT_ARCH else ()


def ssm_train_results(ref: dict, reports) -> tuple[list, dict]:
    """The ranks' reports of ``ssm_train_case`` against ``ref`` -> (checks,
    readings): the step-0 rule, the replicas and held bytes; the planted
    fault is read (caught where a step-0 check fails), not gated."""
    from repro_torch.models import api as mapi

    cfg = ref["cfg"]
    tag = f"lm_mesh {cfg.name} train"
    checks, step0 = step0_checks(tag, [r[0]["steps"][0] for r in reports], ref["loss_t"], ref["loss_o"])
    held, losses, read = train_checks(tag, [r[0] for r in reports], mapi.build_model(cfg), LMM_SSM_TRAIN_MESH)
    fault = {}
    if len(reports[0]) > 1:
        fchecks, fstep0 = step0_checks(f"{LMM_TRAIN_FAULT} {cfg.name}", [r[1]["steps"][0] for r in reports],
                                       ref["loss_t"], ref["loss_o"])
        fault[LMM_TRAIN_FAULT] = dict(
            caught=not all(ok for ok, _ in fchecks), caught_by=[m for ok, m in fchecks if not ok][:3],
            grad_max_frac_err=fstep0["grad_max_frac_err"], grad_err_over_tolerance=fstep0["grad_err_over_tolerance"],
            grad_min_cosine=fstep0["grad_min_cosine"], loss=fstep0["loss"])
    return checks + held, dict(
        arch=cfg.name, n_layers=cfg.n_layers, global_layers=list(cfg.global_layers) or None,
        cut=None if not ref["overrides"] else LMM_SSM_TRAIN_CUT_WHY.get(ref["arch"]), mesh=list(LMM_SSM_TRAIN_MESH),
        param_dtype=cfg.param_dtype, state_bits=cfg.opt_state_bits, microbatches=cfg.microbatches, remat=cfg.remat,
        batch=[LMM_SSM_TRAIN_BATCH, ref["seq"]], check_rows=list(ref["rows"].shape), step0=step0, losses=losses[0],
        planted_fault=fault, **read,
        reference=dict(seconds=ref["seconds"], peak_gb=ref["peak_gb"]))


def lm_mesh_phase(dev, smoke: bool = False) -> dict:
    """The LM families under a mesh: 4 gloo ranks on this one card, started
    by ``launch.mesh.spawn`` (every rank's device ``cuda:0``), each holding
    its blocks of every leaf under the JAX spec. (a) phi3.5-moe-42b-a6.6b
    served by ``make_local_mesh(1, 4)`` with both combines
    (``lm_mesh_rank``: ``launch.lm_mesh_job.run``), held against the same
    8-layer model in this process (drawn, run and freed before the spawn)
    pass by pass and row by row, moe's routes recorded on both sides
    (``served_checks``): where a row's read token took the same experts,
    its logits within ``logit_gate``'s tolerance and its greedy token the
    reference's wherever the reference's top-2 gap exceeds it; where it
    did not, every differing decision a near tie of the reference's; decode
    fed with the reference's tokens; every rank's tokens equal; F launched
    once a layer in each rank's prefill (the decode attention is
    context-parallel torch); the same world then runs ``LMM_FAULTS``, each
    of which the check must catch. (c) granite-8b FULL served by
    ``make_local_mesh(1, 4)``, tensor-parallel, pass by pass within
    ``logit_gate``'s tolerance of this process's, the greedy token the
    reference's past it. (b) olmoe-1b-7b and (d) granite-8b cut to 8
    layers trained on ``make_local_mesh(2, 2)``: the step-0 loss and every
    rank's reduced gradients against this process's on the same 2 rows
    (the ``families_train`` rule: 2^-5 of a leaf's largest element plus
    twice the training path's gap to another float32 order), then steps
    through ``launch.train.train``: every block bit for bit across its
    replicas, olmoe's losses against this process's and each expert
    block's moments after one step against the matching block of this
    process's. Every case's bytes a rank within ``LMM_HELD_RTOL`` of its
    spec blocks'. ``smoke`` takes the smoke configs at 16- and 32-token
    rows. Returns F's launches summed over the ranks."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.launch import lm_mesh_job
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import api as mapi

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    checks: list = []

    # (a) serving: the one-process reference of each combine, its routes
    # recorded; the tolerance from its plain attention against
    # attention_ref on the rows where those two route alike
    base = configs.get(LMM_SERVE_ARCH, smoke=smoke)
    s_over = {} if smoke else {"n_layers": LMM_SERVE_LAYERS}
    plen = 16 if smoke else LMM_SERVE_PROMPT
    steps = LMM_SERVE_STEPS
    max_len = plen + steps
    need(max_len % LMM_SERVE_MESH[1] == 0, f"lm_mesh: max_len {max_len} does not split over the seq axis")
    cfg0 = dataclasses.replace(base, **s_over)
    combines = {"gather": cfg0.capacity_factor, "a2a": cfg0.n_experts / cfg0.top_k}
    prompts = TokenStream(cfg0.vocab, seed=7).batch(LMM_SERVE_BATCH, plen)
    prompt = {"tokens": torch.as_tensor(prompts, device=dev)}
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mapi.build_model(cfg0).init(SEED, dev)
    ref: dict = {}
    for impl, cf in combines.items():
        cfg = dataclasses.replace(cfg0, moe_impl=impl, capacity_factor=cf)
        model = mapi.build_model(cfg)
        logits, routes, toks = served_with_routes(model, params, prompt, max_len, steps)
        with model_attention("plain"):
            plain = served_with_routes(model, params, prompt, max_len, 1, toks)
        with model_attention("attention_ref"):
            alt = served_with_routes(model, params, prompt, max_len, 1, toks)
        floor = [float(np.abs(plain[0][j][r] - alt[0][j][r]).max()) for j in range(2) for r in range(LMM_SERVE_BATCH)
                 if not route_flips(plain[1][j], alt[1][j], r, cfg)]
        checks.append((bool(floor), f"lm_mesh {impl}: no row routes alike under the plain attention and attention_ref"))
        tol = 2 * max(floor, default=0.0) + LOGIT_ATOL
        # F at phi3.5's shape against the plain attention, route by route
        f_checks, f_read = served_checks(f"lm_mesh {impl}: one process with F against the plain attention",
                                         plain[0], plain[1], logits[:2], routes[:2], tol, cfg)
        checks += f_checks
        ref[impl] = dict(logits=logits, routes=routes, tokens=toks, tol=tol, floor=floor, f_vs_plain=f_read,
                         logits_max_abs=[float(np.abs(x).max()) for x in logits])
        del plain, alt
    ref_peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    ref_s = time.perf_counter() - t0
    del params
    if on_card:
        torch.cuda.empty_cache()

    # (c) granite-8b whole: the one-process reference and logit_gate's
    # tolerance (F against the plain attention, floored by attention_ref)
    dcfg = configs.get(LMM_DENSE_ARCH, smoke=smoke)
    dplen = 16 if smoke else LMM_DENSE_PROMPT
    d_max = dplen + LMM_DENSE_STEPS
    need(d_max % LMM_DENSE_SERVE_MESH[1] == 0, f"lm_mesh: granite's max_len {d_max} does not split over the seq axis")
    dprompts = TokenStream(dcfg.vocab, seed=8).batch(LMM_DENSE_BATCH, dplen)
    dprompt = {"tokens": torch.as_tensor(dprompts, device=dev)}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dmodel = mapi.build_model(dcfg)
    dparams = dmodel.init(SEED, dev)
    d_logits, _, d_toks = served_with_routes(dmodel, dparams, dprompt, d_max, LMM_DENSE_STEPS)
    gate_checks, d_gate = logit_gate(dcfg.name, dcfg, dmodel, dparams, dprompt, d_max,
                                     [torch.as_tensor(x, device=dev) for x in d_logits[:2]], gate_faults=False,
                                     read_faults=False)
    checks += gate_checks
    d_tol = d_gate["logit_tolerance"]
    dense_ref = dict(seconds=time.perf_counter() - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card
                     else None, logits_max_abs=[float(np.abs(x).max()) for x in d_logits], gate=d_gate)
    del dparams, dmodel
    if on_card:
        torch.cuda.empty_cache()

    # (b) training: the one-process step-0 gradients, their gap to another
    # float32 order, and the moments after one step of the same run
    tbase = configs.get(LMM_TRAIN_ARCH, smoke=smoke)
    t_over = dict(capacity_factor=tbase.n_experts / tbase.top_k, moe_impl="gather")
    if not smoke:
        t_over.update(n_layers=LMM_TRAIN_LAYERS, param_dtype="bfloat16", opt_state_bits=8)
    tcfg = dataclasses.replace(tbase, **t_over)
    tseq = 32 if smoke else LMM_TRAIN_SEQ
    batch0 = next(TokenStream(tcfg.vocab, seed=0).batches(1, LMM_TRAIN_BATCH, tseq))["tokens"]
    rows_np = batch0[:LMM_TRAIN_ROWS]
    # (d) granite-8b cut to LMM_DENSE_TRAIN_LAYERS, float32 masters, 32-bit moments
    g_over = {} if smoke else {"n_layers": LMM_DENSE_TRAIN_LAYERS}
    gcfg = dataclasses.replace(configs.get(LMM_DENSE_ARCH, smoke=smoke), **g_over)
    gseq = 32 if smoke else LMM_DENSE_TRAIN_SEQ
    grows_np = next(TokenStream(gcfg.vocab, seed=0).batches(1, LMM_DENSE_TRAIN_BATCH, gseq))["tokens"][:LMM_TRAIN_ROWS]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else os.path.join(ROOT, "build")
    with tempfile.TemporaryDirectory(dir=shm) as tmp, \
            tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as store_tmp:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grads_path = os.path.join(tmp, "grads.pt")
        masters, loss_t, loss_o = one_process_grads(tcfg, dev, rows_np, grads_path)
        expert = [n for n in _flat(masters) if n.split("/")[-1] in ("e_gate", "e_up", "e_down")]
        moments: dict = {}

        def grab(i, p_, st):
            if i == 0:
                for which, tree in (("m", st.m), ("v", st.v)):
                    for n, t in _flat(tree).items():
                        leaf = n.rsplit("/", 1)[0] if n.endswith(("/q", "/s")) else n
                        if leaf in expert:
                            key = f"{which}/{leaf}"
                            if leaf == n:
                                moments[key] = t.detach().cpu()
                            else:
                                moments.setdefault(key, {})[n[-1]] = t.detach().cpu()

        one_hist = launch_train.train(tcfg, steps=LMM_TRAIN_STEPS, batch=LMM_TRAIN_BATCH, seq=tseq,
                                      device=dev, params=masters, log=lambda *_: None, on_step=grab)[0]
        moments_path = os.path.join(tmp, "moments.pt")
        torch.save(moments, moments_path)
        train_ref_s = time.perf_counter() - t0
        train_ref_peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        del masters, moments
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g_path = os.path.join(tmp, "granite_grads.pt")
        gmasters, gloss_t, gloss_o = one_process_grads(gcfg, dev, grows_np, g_path)
        dense_train_ref = dict(seconds=time.perf_counter() - t0,
                               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None)
        del gmasters
        if on_card:
            torch.cuda.empty_cache()
        np.save(os.path.join(tmp, "prompts.npy"), prompts)
        np.save(os.path.join(tmp, "dense_prompts.npy"), dprompts)
        # (e) mamba2-780m and hymba-1.5b served whole on 1 x 4 and (f)
        # trained on 2 x 2: their one-process references
        ssm_serve = {arch: ssm_serve_reference(dev, arch, smoke, tmp) for arch in LMM_SSM_PROMPT}
        ssm_train = {arch: ssm_train_reference(dev, arch, smoke, tmp) for arch in LMM_SSM_TRAIN}
        parent_reserved_gb = torch.cuda.memory_reserved() / 1e9 if on_card else None

        # one world: serving, the planted faults, granite's serving, then training
        def serve_step(impl, decode):
            return ("serve", dict(arch=LMM_SERVE_ARCH, smoke=smoke,
                                  overrides=dict(s_over, moe_impl=impl, capacity_factor=combines[impl]), seed=SEED,
                                  prompts=os.path.join(tmp, "prompts.npy"), max_len=max_len, decode=decode,
                                  feed=ref[impl]["tokens"][:, :decode], routes=True))

        def serve_job(*steps_):
            return lm_mesh_job.LMMeshJob(mesh=LMM_SERVE_MESH, steps=steps_, device=dev.type)

        # the masters are drawn on every rank at once: olmoe's largest leaf
        # at 4 layers is 2.1 GB in float32 (phi3.5's, drawn in turn, 13 GB)
        train_steps = (
            ("grads", dict(arch=LMM_TRAIN_ARCH, smoke=smoke, overrides=t_over, rows=rows_np, compare=grads_path)),
            ("train", dict(arch=LMM_TRAIN_ARCH, smoke=smoke, overrides=t_over, steps=LMM_TRAIN_STEPS,
                           batch=LMM_TRAIN_BATCH, seq=tseq, compare_moments=moments_path)),
        )
        dense_serve = lm_mesh_job.LMMeshJob(mesh=LMM_DENSE_SERVE_MESH, device=dev.type, steps=(
            ("serve", dict(arch=LMM_DENSE_ARCH, smoke=smoke, seed=SEED, prompts=os.path.join(tmp, "dense_prompts.npy"),
                           max_len=d_max, decode=LMM_DENSE_STEPS, feed=d_toks)),))
        dense_train = lm_mesh_job.LMMeshJob(mesh=LMM_DENSE_TRAIN_MESH, device=dev.type, steps=(
            ("grads", dict(arch=LMM_DENSE_ARCH, smoke=smoke, overrides=g_over, rows=grows_np, compare=g_path)),
            ("train", dict(arch=LMM_DENSE_ARCH, smoke=smoke, overrides=g_over, steps=1,
                           batch=LMM_DENSE_TRAIN_BATCH, seq=gseq)),
        ))
        import chip_smoke  # the ranks' function, importable by name

        cases = ((serve_job(*(serve_step(impl, steps) for impl in combines)),
                  tuple((kind, serve_job(serve_step(impl, decode))) for kind, impl, decode in LMM_FAULTS)),
                 (dense_serve, ()),
                 *(ssm_serve_case(ref, dev.type, smoke) for ref in ssm_serve.values()),
                 (lm_mesh_job.LMMeshJob(mesh=LMM_TRAIN_MESH, steps=train_steps, device=dev.type), ()),
                 (dense_train, ()),
                 *(ssm_train_case(ref, dev.type, smoke) for ref in ssm_train.values()))
        t0 = time.perf_counter()
        world = launch_mesh.spawn(chip_smoke.lm_mesh_rank, 4, store_dir=os.path.join(store_tmp, "world"),
                                  timeout_s=900, args=(cases,))
        world_s = time.perf_counter() - t0
        served = [r[0] for r in world]
        dense_reports = [r[1][0] for r in world]
        n_ssm = len(ssm_serve)
        ssm_serve_reports = [[r[2 + i] for r in world] for i in range(n_ssm)]
        train_reports, dtrain_reports = ([r[2 + n_ssm + i][0] for r in world] for i in range(2))
        ssm_train_reports = [[r[4 + n_ssm + i] for r in world] for i in range(len(ssm_train))]
        serve_reports = [r[0] for r in served]

    # (a) the served logits and routes, route by route, and the planted faults
    launches: dict = {}
    serve_out = {}
    n_attn = flash_per_pass(cfg0)[0]

    for si, impl in enumerate(combines):
        r_ref = ref[impl]
        cfg = dataclasses.replace(cfg0, moe_impl=impl, capacity_factor=combines[impl])
        outs = [r["steps"][si] for r in serve_reports]
        got_logits, got_routes = global_passes(outs, len(r_ref["logits"]), LMM_SERVE_BATCH)
        held, reading = served_checks(f"lm_mesh {impl}", r_ref["logits"], r_ref["routes"], got_logits, got_routes,
                                      r_ref["tol"], cfg)
        checks += held
        argmaxes = [[np.argmax(p["logits"], -1) for p in o["passes"]] for o in outs]
        checks.append((all(all(np.array_equal(a, b) for a, b in zip(am, argmaxes[0])) for am in argmaxes),
                       f"lm_mesh {impl}: the ranks' greedy tokens differ"))
        held, f_per_rank = launch_checks(f"lm_mesh {impl}", outs, n_attn, on_card)
        checks += held
        for o in outs:
            for p in o["passes"]:
                launches = _add(launches, p["launches"])
        serve_out[impl] = dict(
            capacity_factor=combines[impl], **pass_readings(outs, len(r_ref["logits"])),
            logit_tolerance=r_ref["tol"], **reading,
            flash_attention_launches_per_rank=f_per_rank, seq_blocks=outs[0]["seq_blocks"],
            reference=dict(logits_max_abs=r_ref["logits_max_abs"], plain_vs_attention_ref_alike=r_ref["floor"],
                           f_vs_plain=r_ref["f_vs_plain"]))
    faults_out = {}
    for fi, (kind, impl, decode) in enumerate(LMM_FAULTS):
        cfg = dataclasses.replace(cfg0, moe_impl=impl, capacity_factor=combines[impl])
        outs = [r[fi + 1]["steps"][0] for r in served]
        got_logits, got_routes = global_passes(outs, decode + 1, LMM_SERVE_BATCH)
        _, reading = served_checks(f"{kind} {impl}", ref[impl]["logits"][: decode + 1],
                                   ref[impl]["routes"][: decode + 1], got_logits, got_routes, ref[impl]["tol"], cfg)
        faults_out[f"{kind}/{impl}"] = dict(caught=fault_caught(reading), caught_by=reading["catches"][:3], **reading)
        checks.append((fault_caught(reading), f"lm_mesh: the serving check misses {kind} under {impl} ({reading})"))

    # (c) granite-8b served tensor-parallel, pass by pass
    outs = [r["steps"][0] for r in dense_reports]
    got_logits, _ = global_passes(outs, len(d_logits), LMM_DENSE_BATCH)
    d_errs = []
    for j, (rl, gl) in enumerate(zip(d_logits, got_logits)):
        d_errs.append([float(np.abs(gl[r] - rl[r]).max()) for r in range(rl.shape[0])])
        for r in range(rl.shape[0]):
            checks.append((d_errs[-1][r] <= d_tol, f"lm_mesh granite: pass {j} row {r}'s logits differ from one"
                                                   f" process's by {d_errs[-1][r]} > {d_tol}"))
            top2 = np.sort(rl[r])[-2:]
            if top2[1] - top2[0] > d_tol:
                checks.append((int(np.argmax(gl[r])) == int(np.argmax(rl[r])),
                               f"lm_mesh granite: pass {j} row {r}'s greedy token differs from one process's"))
    argmaxes = [[np.argmax(p["logits"], -1) for p in o["passes"]] for o in outs]
    checks.append((all(all(np.array_equal(a, b) for a, b in zip(am, argmaxes[0])) for am in argmaxes),
                   "lm_mesh granite: the ranks' greedy tokens differ"))
    d_sent = max(max(o["passes"][j]["traffic"]["sent_bytes"] for o in outs) for j in range(1, len(d_logits)))
    checks.append((d_sent < LMM_DECODE_SENT_BYTES,
                   f"lm_mesh granite: a decode step hands {d_sent} bytes a rank to gloo, not below"
                   f" {LMM_DECODE_SENT_BYTES:.0f}"))
    held, f_dense = launch_checks("lm_mesh granite", outs, flash_per_pass(dcfg)[0], on_card)
    checks += held
    for o in outs:
        for p in o["passes"]:
            launches = _add(launches, p["launches"])
    dense_serve_out = dict(arch=dcfg.name, n_layers=dcfg.n_layers, mesh=list(LMM_DENSE_SERVE_MESH),
                           batch=LMM_DENSE_BATCH, prompt_len=dplen, decode_steps=LMM_DENSE_STEPS, max_len=d_max,
                           logits_max_abs_err=d_errs, logit_tolerance=d_tol, seq_blocks=outs[0]["seq_blocks"],
                           flash_attention_launches_per_rank=f_dense, **pass_readings(outs, len(d_logits)),
                           peak_mem_gb_per_rank=[(r.get("peak_mem_bytes") or 0) / 1e9 for r in dense_reports],
                           reference=dense_ref)

    # (b) olmoe: the step-0 gradients, the steps, the replicas and the moments
    held, step0 = step0_checks("lm_mesh train", [r["steps"][0] for r in train_reports], loss_t, loss_o)
    checks += held
    held, losses, t_read = train_checks("lm_mesh train", train_reports, mapi.build_model(tcfg), LMM_TRAIN_MESH)
    checks += held
    train_reps = [r["steps"][1] for r in train_reports]
    one_losses = [h["loss"] for h in one_hist]
    checks.append((abs(losses[0][0] - one_losses[0]) <= FT_LOSS_RTOL * abs(one_losses[0]),
                   f"lm_mesh train: step 0's loss {losses[0][0]} against one process's {one_losses[0]}"))
    moment_worst = 0.0
    for t in train_reps:
        for name, (err, scale) in t["check"].items():
            moment_worst = max(moment_worst, err / max(scale, 1e-30))
            if on_card:  # the smoke configs' few tokens flip routes at a bf16 ulp (a reading there)
                checks.append((err <= LMM_MOMENT_FRAC * scale,
                               f"lm_mesh train: {name} of an expert block differs from one process's by {err}"
                               f" > {LMM_MOMENT_FRAC} x {scale}"))

    # (d) granite-8b trained under ZeRO x tensor parallelism
    held, g_step0 = step0_checks("lm_mesh granite train", [r["steps"][0] for r in dtrain_reports], gloss_t, gloss_o)
    checks += held
    held, g_losses, g_read = train_checks("lm_mesh granite train", dtrain_reports, mapi.build_model(gcfg),
                                          LMM_DENSE_TRAIN_MESH)
    checks += held

    # (e) mamba2 and hymba served on 1 x 4 with their planted faults, (f)
    # trained on 2 x 2 with the training fault read
    ssm_serve_out, ssm_train_out = {}, {}
    for ref, reports in zip(ssm_serve.values(), ssm_serve_reports):
        held, ssm_serve_out[ref["arch"]] = ssm_serve_results(ref, reports, on_card)
        checks += held
        launches = _add(launches, ssm_serve_out[ref["arch"]]["launches"])
    for ref, reports in zip(ssm_train.values(), ssm_train_reports):
        held, ssm_train_out[ref["arch"]] = ssm_train_results(ref, reports)
        checks += held

    emit("lm_mesh", ranks=4, backend="gloo", device_per_rank=dev.type, parent_reserved_gb=parent_reserved_gb,
         world_s=world_s,
         serve=dict(arch=cfg0.name, n_layers=cfg0.n_layers, cut=None if smoke else (
             f"{LMM_SERVE_LAYERS} of 32 layers: the whole model is 84 GB in bf16, past one card"),
             mesh=list(LMM_SERVE_MESH), batch=LMM_SERVE_BATCH, prompt_len=plen, decode_steps=steps, max_len=max_len,
             reference_s=ref_s, reference_peak_gb=ref_peak,
             peak_mem_gb_per_rank=[(r.get("peak_mem_bytes") or 0) / 1e9 for r in serve_reports], **serve_out),
         granite_serve=dense_serve_out,
         train=dict(arch=tcfg.name, n_layers=tcfg.n_layers, cut=None if smoke else (
             f"{LMM_TRAIN_LAYERS} of 16 layers and {LMM_TRAIN_STEPS} step: the gradients cross gloo through the host"),
             mesh=list(LMM_TRAIN_MESH), moe_impl=tcfg.moe_impl, capacity_factor=tcfg.capacity_factor,
             param_dtype=tcfg.param_dtype, state_bits=tcfg.opt_state_bits, batch=[LMM_TRAIN_BATCH, tseq],
             check_rows=LMM_TRAIN_ROWS, reference_s=train_ref_s, reference_peak_gb=train_ref_peak, step0=step0,
             losses=losses[0], one_process_losses=one_losses, moments_max_frac_err=moment_worst, **t_read),
         granite_train=dict(arch=gcfg.name, n_layers=gcfg.n_layers, cut=None if smoke else (
             f"{LMM_DENSE_TRAIN_LAYERS} of 36 layers: four ranks' float32 state and gradients share one card, and the"
             f" phase's time"),
             mesh=list(LMM_DENSE_TRAIN_MESH), param_dtype=gcfg.param_dtype, state_bits=gcfg.opt_state_bits,
             microbatches=gcfg.microbatches, remat=gcfg.remat, batch=[LMM_DENSE_TRAIN_BATCH, gseq],
             check_rows=LMM_TRAIN_ROWS, reference=dense_train_ref, step0=g_step0, losses=g_losses[0], **g_read),
         ssm_serve=ssm_serve_out, ssm_train=ssm_train_out,
         planted_faults=faults_out, launches=launches, seconds=time.perf_counter() - t_phase)

    def serve_case(r, peak):
        return dict(gloo_sent_bytes_prefill=r["gloo_sent_bytes_prefill"],
                    gloo_sent_bytes_decode_step=float(np.median(r["gloo_sent_bytes_per_decode_step"])),
                    stream_bytes_prefill=r["stream_bytes_prefill"], stream_bytes_decode=r["stream_bytes_decode"],
                    peak_mem_gb=max(peak), prefill_ms=r["prefill_ms"], median_decode_ms=r["median_decode_ms"])

    def train_case(r):
        return dict(gloo_sent_bytes_step=r["gloo_sent_bytes_per_step"], stream_bytes=r["stream_bytes"],
                    peak_mem_gb=max(r["peak_mem_gb_per_rank"]), median_step_ms=r["median_step_ms"])

    serve_peak = [(r.get("peak_mem_bytes") or 0) / 1e9 for r in serve_reports]
    emit("lm_mesh_cases", cases={**{f"phi3.5 {impl} serve 1x4": serve_case(serve_out[impl], serve_peak)
                                    for impl in combines},
                                 "granite-8b serve 1x4": serve_case(dense_serve_out,
                                                                    dense_serve_out["peak_mem_gb_per_rank"]),
                                 **{f"{a} serve 1x4": serve_case(r, r["peak_mem_gb_per_rank"])
                                    for a, r in ssm_serve_out.items()},
                                 "olmoe train 2x2": train_case(t_read), "granite-8b train 2x2": train_case(g_read),
                                 **{f"{a} train 2x2": train_case(r) for a, r in ssm_train_out.items()}})
    for ok, msg in checks:
        need(ok, msg)
    return launches


if __name__ == "__main__":
    sys.exit(main())
