"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs
fifteen phases, printing one JSON line each; any failed check raises, so
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
   ``stream_profile`` the last 32 events profiled: the device idle share.
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
                  FULL widths and depths with seeded weights, B = 2 prompts
                  of 512, 1,000 and 1,920 tokens, 8 greedy decode steps.
                  Checks: kernel F launched per prefill and decode step as
                  each family's attention calls it (16 a pass for olmoe, 32
                  a prefill and 3 a decode step for hymba, none for
                  mamba2) and no other kernel; the logit gate on olmoe and
                  hymba with its planted faults (``fault_sink`` on hymba);
                  decode after ``prefill(s)`` against ``prefill(s + 1)`` on
                  mamba2 and hymba; ``ssd_chunked`` against ``ssd_reference``
                  at mamba2's dims; then ``launch.serve`` for each family.
14. ``train``     LM training at hubert-xlarge's FULL size (48 layers,
                  d_model 1280, 0.95 B parameters, no cut) through
                  ``launch.train``'s step and audio batches (8 x 1,024
                  frames, 30 % masked): step 0's loss and every leaf's
                  gradient against a plain path (no remat, one attention
                  block, whole logits, ``F.cross_entropy``) on 2 rows;
                  6 timed steps of float32 AdamW with remat "dots" (loss,
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
                  size: olmoe-1b-7b (bf16 masters and 8-bit moments, the
                  stated cut: float32 state would be about 110 GB),
                  mamba2-780m and hymba-1.5b (float32 AdamW, remat "full",
                  hymba's two microbatches), 4 x 512, 4 x 1,024 and 2 x 512
                  tokens. Checks: step 0's loss and every gradient finite
                  and within tolerance of a plain path (one attention
                  block, whole logits; ``ssd_reference`` for mamba2 and
                  hymba on a 256-token prefix), olmoe's gradients equal on
                  two calls; 3 timed steps (every leaf moves but bf16
                  norm weights under half an ulp, the loss finite; median
                  ms, tokens per second, peak memory) and
                  ``families_train_profile``; the trained masters served
                  through ``serving``: prefill and 4 decode steps, F's
                  launches as ``flash_per_pass`` says, the logit gate;
                  then the restart at olmoe's smoke config under
                  deterministic algorithms, bit for bit.

The ``kernels`` line comes last but two, then the ``nvidia-smi`` line, and
the last line is ``{"ok": true, "device": {...}}``. A kernel's ``launches``
counts the path it belongs to: the main path for A, B and D (C, the
staged form's distance stage, is on no path of the ``"cuda"`` backend and
counts 0 there), the payload phase's two compressed
queries for E, the ``knn_lm`` phase for F; every row also gives its
launches on the ``routes``, ``quickstart``, ``routed``, ``icu_serve``, ``stream``,
``knn_lm``, ``serve``, ``serve_twin``, ``families``, ``train`` and ``families_train``
paths (no kernel runs on a training step, as none does on the JAX
package's; ``families_train`` counts F in the trained masters' serving), and A, B and D their launches summed over the
``mesh`` phase's ranks (``mesh_launches``). Without a CUDA
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
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PROFILED = 8, 1024, 6, 2
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
# 128 meta tokens), then 8 greedy decode steps
FAMILY_PROMPTS = {"olmoe-1b-7b": 512, "mamba2-780m": 1000, "hymba-1.5b": 1920}
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
FT_CUT_WHY = {"olmoe-1b-7b": (
    "param_dtype bfloat16 and opt_state_bits 8, the JAX config's fields for this case: 6.92 B parameters in"
    " float32 masters, gradients and two moments come to about 110 GB, past the card's 80 GB; all 16 layers kept")}
FT_STEPS, FT_PROFILED = 3, 1
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def profile_activities(dev) -> list:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def profile_query(dev, fn, queries: int = 200, host_ops: bool = True) -> dict:
    """Wall time of ``fn()`` under the profiler, the summed time of its
    kernels on the card (device busy), the device's idle share, the eight
    longest kernels and the port's own, each with its share of the busy
    time. ``host_ops=False`` traces the card's kernels only, which spares
    the host the per-op records that slow a path of many ops."""
    import torch

    acts = profile_activities(dev)
    if not host_ops and dev.type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CUDA]
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
STREAM_CHECK_EVENT, STREAM_PROFILE_EVENTS = 8, 32


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
    eight: five at ``cfg``'s heads, two at ``wide_cfg``'s (head_dim 192,
    a GQA group of 12: the widest ring and a packed decode tile) and one at
    ``sink_cfg``'s sliding-window prefill (hymba: its window and its meta
    tokens as attention sinks, over the 2,048 positions of the families
    phase's prompt).
    ``library_ms`` is one ``scaled_dot_product_attention`` call
    (``enable_gqa``), timed here only; ``library_ratio`` is ms over it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa, ref as fa_ref

    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    wide = (wide_cfg.n_heads, wide_cfg.n_kv_heads, wide_cfg.head_dim)
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
        return attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                      window=window, q_offset=q_offset, kv_len=kv_len, sink=sink).transpose(1, 2)

    def decode(q, k_cache, v_cache, cur_len):
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
    (B, S, V) logits, ``F.cross_entropy`` over the masked frames."""
    import torch
    import torch.nn.functional as F

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
    logits = (x.to(torch.bfloat16) @ dense._lm_head(cfg, params).to(torch.bfloat16)).float()
    return F.cross_entropy(logits[mask], batch["targets"][mask].long())


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
    step and batches: the step-0 check against the plain path, 6 timed
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

    prof = profile_query(dev, profiled, queries=TRAIN_PROFILED, host_ops=False)
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
               gate_faults: bool = True) -> tuple[list, dict]:
    """The model with F against the same model with the plain attention on
    the first prefill and decode step: ``first`` holds the path's logits
    of both; the tolerance is twice the gap to the model with F's plain
    version plus ``LOGIT_ATOL``, and with ``gate_faults`` it must catch the
    planted faults (``fault_sink`` where the model has meta tokens), which
    are otherwise only read. Returns the checks and the readings."""
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
    faults = GATED_FAULTS + ((SINK_FAULT,) if cfg.meta_tokens else ())
    fault_err = {}
    for kind in faults:
        with model_attention(kind):
            fault_err[kind] = logit_errs(first_logits())
    checks += [(max(fault_err[kind]) > logit_tol,
                f"{arch}: the logit gate {logit_tol} misses {kind} (errors {fault_err[kind]})")
               for kind in faults if gate_faults]
    return checks, dict(logits_max_abs=[float(x.abs().max()) for x in plain], logits_max_abs_err_vs_plain=logit_err,
                        logits_plain_vs_attention_ref=logit_floor, logit_tolerance=logit_tol,
                        logits_planted_fault_err=fault_err)


def families_phase(dev, smoke: bool = False) -> dict:
    """The moe, ssm and hybrid families served whole: olmoe-1b-7b,
    mamba2-780m and hymba-1.5b at their FULL widths and depths (their smoke
    configs with ``smoke``), weights from a seeded generator, B = 2 prompts
    of FAMILY_PROMPTS tokens (mamba2's not a multiple of its 128 chunk;
    hymba's 1,920 behind 128 meta tokens, past window + meta tokens, so the
    window, the sink and the ring's wrap all bite), then FAMILY_STEPS greedy
    decode steps. Per family: prefill ms, ms per decode step, peak memory,
    F's launches against ``flash_per_pass`` (checked on the card); on olmoe
    and hymba the logit gate (first prefill and decode logits with F
    against the plain attention, planted faults caught, ``fault_sink`` on
    hymba); on mamba2 and hymba decode after ``prefill(s)`` against
    ``prefill(s + 1)``; on mamba2 ``ssd_chunked`` against ``ssd_reference``
    at FULL's dims; ``families_profile``: the path once more, profiled (the
    card's kernels only); then ``launch.serve`` for the family. Returns the
    launches of all of it but the profiled pass."""
    import torch

    from repro_torch import configs
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.models import api as mapi
    from repro_torch.models import mamba2

    total: dict = {}
    for arch, plen in FAMILY_PROMPTS.items():
        cfg = configs.get(arch, smoke=smoke)
        if smoke:  # the same cases at the smoke configs' chunk (16) and window (16)
            plen = {"olmoe-1b-7b": 40, "mamba2-780m": 37, "hymba-1.5b": 24}[arch]
        model = mapi.build_model(cfg)
        sync(dev)
        t0 = time.perf_counter()
        params = model.init(SEED, dev)
        sync(dev)
        init_s = time.perf_counter() - t0
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
                      n_params=model.n_params, init_s=init_s, batch=FAMILY_BATCH, prompt_len=plen,
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
        emit("families_profile", arch=cfg.name, **profile_query(dev, served, queries=FAMILY_STEPS, host_ops=False))
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
    """The moe, ssm and hybrid families trained at FULL size, then served
    from their trained masters: olmoe-1b-7b (with bf16 masters and 8-bit
    moments, the stated cut), mamba2-780m and hymba-1.5b (float32 AdamW,
    their configs' remat "full", hymba's two microbatches), masters from a
    seeded generator. Per family: the step-0 check on the first rows (the
    training path's loss and every gradient, which must be finite, against
    the plain path of ``family_loss_variant``, the tolerance widened by the
    training path's own gap to ``"other_order"``; on olmoe the gradients of
    two identical calls compared bit for bit), FT_STEPS timed steps through
    ``train.loop.make_train_step`` (every leaf moves after the first, the
    loss stays finite), ``families_train_profile`` (one more step,
    profiled), then ``serving(masters)``: prefill and FT_SERVE_STEPS greedy
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
        cut = FT_CUT.get(arch, {})
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
                   for i in range(FT_STEPS + FT_PROFILED)]
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
        opt_cfg = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=FT_STEPS + FT_PROFILED,
                                    state_bits=cfg.opt_state_bits)
        state = adamw.init(params, opt_cfg)
        step_fn = tl.make_train_step(model, opt_cfg)
        before = {n: t.detach().to("cpu", copy=True) for n, t in _flat(params).items()}  # host copies (13.8 GB on olmoe)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        steps = []
        for i in range(FT_STEPS):
            sync(dev)
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batches[i])
            sync(dev)
            steps.append(dict(step=i, ms=(time.perf_counter() - t0) * 1e3, **{k: float(v) for k, v in m.items()}))
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

        def profiled():
            nonlocal params, state
            for b in batches[FT_STEPS:]:
                params, state, _ = step_fn(params, state, b)

        prof = profile_query(dev, profiled, queries=FT_PROFILED, host_ops=False)
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

if __name__ == "__main__":
    sys.exit(main())
