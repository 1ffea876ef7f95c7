"""Staged SLSH execution pipeline with pluggable compute backends.

Counterpart of ``repro.core.pipeline``. Every index build and query of the
port runs through this module. The per-query path works on a query chunk
in explicit batched stages (DESIGN.md §3):

  1. hash    — signatures -> outer probe keys (with multiprobe bit flips)
               and inner-layer keys
  2. gather  — probe buckets into a dense (Q, C) candidate tensor through
               the query-major fast gather
  3. dedup   — sort-based dedup; yields the paper's #comparisons
  4. compact — the first ``c_comp`` unique survivors; the rest are counted
               in ``QueryResult.compaction_overflow``, never dropped silently
  5. top-k   — masked L1 top-k over the compacted candidates

``SLSHConfig.backend`` picks the compute: ``"torch"`` runs every stage as
plain PyTorch (the port's oracle, as ``"reference"`` is the JAX package's);
``"cuda"`` runs the signatures through the hand-written ``hash_pack``
kernels and stages 3-5 as the fused ``query_fused`` kernel, one launch a
chunk at every k and width the reference answers, with ``l1_topk``
registered for the staged form. With a compressed
``RuntimeConfig.payload`` (``"f16"``/``"i8"``) the ``"cuda"`` backend runs
stages 3-5 as the payload tail instead: approximate distances over
quantized rows, an exact f32 rerank of a ``c_rerank`` shortlist, and
``QueryResult.rerank_misses`` (DESIGN.md §13). A kernel wrapper given CPU
tensors runs its plain version, so the ``"cuda"`` backend's control flow
also runs (and is tested) on the CPU.

A ``DeltaView`` fans the gather out over a streaming index's base tables
and its append-only delta segment (``_stage_gather_delta``, DESIGN.md §9):
plain torch ops, as the JAX package leaves that gather to XLA, feeding the
same fused tail with the same run layout.

Under an ambient :class:`repro_torch.obs.Obs` with tracing on, each stage
of a query chunk runs in a ``query.*`` span and each phase of a build in a
``build.*`` span; these spans synchronize the device before they close, so
they time device work, and observe ``dslsh_stage_latency_seconds``. The
untraced path checks one ContextVar and records nothing.

Left out against the JAX package: the per-stage jit schedule and the
traced (in-jit) paths.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
import warnings
from typing import Callable, NamedTuple

import torch

from repro_torch import device as device_mod
from repro_torch import obs as obs_mod
from repro_torch.core import hashing, merge, tables, topk
from repro_torch.runtime.payload import PAYLOAD_FORMATS, Payload, make_payload

# ------------------------------------------------------------ configuration


class ConfigError(ValueError):
    """A rejected SLSH configuration (every message says how to fix it)."""


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ConfigError(msg)


@dataclasses.dataclass(frozen=True)
class FamilyConfig:
    """The hash-family half of an SLSH configuration (paper §2).

    ``m_out``/``L_out`` parameterize the outer l1 bit-sampling layer,
    ``m_in``/``L_in`` the inner cosine layer over heavy buckets,
    ``alpha`` the heavy-bucket threshold, and ``val_lo``/``val_hi`` the
    value range the bit-sampling thresholds are drawn from (mmHg for MAP
    data). Defaults are the paper's Table 1 settings.
    """

    m_out: int = 125
    L_out: int = 120
    m_in: int = 65
    L_in: int = 20
    alpha: float = 0.005
    use_inner: bool = True
    multiprobe: int = 0  # extra low-margin bit-flip probes per outer table
    val_lo: float = 0.0
    val_hi: float = 200.0

    def __post_init__(self):
        _require(
            self.m_out >= 1 and self.L_out >= 1,
            f"m_out={self.m_out}, L_out={self.L_out}: the outer family needs"
            " at least one bit and one table (m_out >= 1, L_out >= 1)",
        )
        _require(
            not self.use_inner or (self.m_in >= 1 and self.L_in >= 1),
            f"m_in={self.m_in}, L_in={self.L_in} with use_inner=True: the"
            " stratified inner layer needs m_in >= 1 and L_in >= 1 — raise"
            " them or set use_inner=False",
        )
        _require(
            0.0 < self.alpha <= 1.0,
            f"alpha={self.alpha}: the heavy-bucket threshold is a population"
            " fraction and must lie in (0, 1]",
        )
        _require(
            0 <= self.multiprobe < self.m_out,
            f"multiprobe={self.multiprobe} with m_out={self.m_out}: each"
            " extra probe flips one distinct signature bit, so 0 <="
            " multiprobe < m_out must hold",
        )
        _require(
            self.val_lo < self.val_hi,
            f"val_lo={self.val_lo} >= val_hi={self.val_hi}: bit-sampling"
            " thresholds are drawn uniformly from [val_lo, val_hi), which"
            " must be a non-empty range",
        )


@dataclasses.dataclass(frozen=True)
class BudgetConfig:
    """The static-shape budget half of an SLSH configuration (DESIGN.md §8.4).

    ``k`` neighbours per query; ``c_max``/``c_in`` candidates gathered per
    outer/inner bucket probe; ``h_max`` heavy buckets indexed per table;
    ``p_max`` inner-layer population cap; ``c_comp`` the compacted distance
    buffer (<= 0 disables the cap); ``c_rerank`` the exact-rerank shortlist
    of the compressed-payload tail (read only when ``payload != "f32"``).
    """

    k: int = 10
    c_max: int = 128
    c_in: int = 32
    h_max: int = 8
    p_max: int = 512
    c_comp: int = 1024
    c_rerank: int = 128

    def __post_init__(self):
        _require(self.k >= 1, f"k={self.k}: need at least one neighbour")
        _require(
            self.c_max >= 1,
            f"c_max={self.c_max}: each outer probe must be able to gather"
            " at least one candidate",
        )
        _require(
            self.c_in >= 1 and self.p_max >= 1,
            f"c_in={self.c_in}, p_max={self.p_max}: inner-layer budgets must"
            " be >= 1 (set use_inner=False to disable the inner layer"
            " instead of zeroing its budgets)",
        )
        _require(
            self.h_max >= 0,
            f"h_max={self.h_max}: the heavy-bucket registry size cannot be"
            " negative",
        )
        _require(
            self.c_comp <= 0 or self.c_comp >= self.k,
            f"c_comp={self.c_comp} < k={self.k}: the compacted distance"
            " buffer cannot hold k candidates, so every query would"
            " silently return fewer than k neighbours — raise c_comp to at"
            " least k, or set c_comp <= 0 to disable compaction",
        )
        _require(
            self.c_rerank >= 1,
            f"c_rerank={self.c_rerank}: the payload rerank shortlist must"
            " hold at least one candidate",
        )


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The execution half of an SLSH configuration.

    ``backend`` selects the compute (``"cuda"`` the hand-written kernels,
    the default; ``"torch"`` plain PyTorch, the oracle). ``interpret``
    keeps the JAX configuration's fields; the port has no interpret mode, so
    any value but ``None`` is refused. ``build_chunk``/``query_chunk`` bound
    per-step memory; ``build_mode`` picks the index-construction schedule
    (``"monolithic"`` full sort, ``"chunked"`` sorted runs merged by the
    ladder, ``"auto"`` chunked once ``n > build_chunk``). ``payload`` picks
    the candidate rows the fused tail reads: ``"f32"`` the exact rows,
    ``"f16"``/``"i8"`` a quantized copy with an exact f32 rerank
    (``runtime/payload.py``, DESIGN.md §13).
    """

    build_chunk: int = 4096
    query_chunk: int = 64
    backend: str = "cuda"
    interpret: bool | None = None
    build_mode: str = "auto"
    payload: str = "f32"

    def __post_init__(self):
        _require(
            self.build_chunk >= 1 and self.query_chunk >= 1,
            f"build_chunk={self.build_chunk}, query_chunk={self.query_chunk}:"
            " chunk sizes must be >= 1",
        )
        _require(
            self.backend in _BACKENDS,
            f"unknown SLSH backend {self.backend!r}; registered:"
            f" {sorted(_BACKENDS)}",
        )
        _require(
            self.interpret is None,
            f"interpret={self.interpret!r}: the PyTorch port has no interpret"
            " mode; a CPU tensor takes each kernel's plain version, so leave"
            " interpret=None and pass device='cpu' (or backend='torch')",
        )
        _require(
            self.build_mode in ("auto", "monolithic", "chunked"),
            f"build_mode={self.build_mode!r}: expected 'auto' (chunked once"
            " n > build_chunk), 'monolithic', or 'chunked'",
        )
        _require(
            self.payload in PAYLOAD_FORMATS,
            f"payload={self.payload!r}: expected 'f32' (uncompressed),"
            " 'f16', or 'i8' (compressed candidate rows + exact f32"
            " rerank, DESIGN.md §13)",
        )


_FAMILY_FIELDS = tuple(f.name for f in dataclasses.fields(FamilyConfig))
_BUDGET_FIELDS = tuple(f.name for f in dataclasses.fields(BudgetConfig))
_RUNTIME_FIELDS = tuple(f.name for f in dataclasses.fields(RuntimeConfig))

# compose/replace flip this so only *direct* flat ``SLSHConfig(...)`` calls
# fire the deprecation warning.
_COMPOSED_CTOR: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "slsh_composed_ctor", default=False
)


@dataclasses.dataclass(frozen=True)
class SLSHConfig:
    """Static configuration shared by every SLSH execution path.

    Built from :class:`FamilyConfig`, :class:`BudgetConfig` and
    :class:`RuntimeConfig` with :meth:`compose`; constructing it from flat
    keywords directly is deprecated, as in the JAX package.

    >>> cfg = SLSHConfig.compose(FamilyConfig(m_out=16, L_out=8, multiprobe=1),
    ...                          BudgetConfig(c_max=64))
    >>> cfg.slot  # per-table candidate slot width: max(2*64, L_in*c_in)
    640
    >>> cfg.replace(backend="torch").backend
    'torch'
    """

    # hash-family parameters (FamilyConfig)
    m_out: int = 125
    L_out: int = 120
    m_in: int = 65
    L_in: int = 20
    alpha: float = 0.005
    k: int = 10
    use_inner: bool = True
    multiprobe: int = 0
    val_lo: float = 0.0
    val_hi: float = 200.0
    # static-shape budgets (BudgetConfig)
    c_max: int = 128
    c_in: int = 32
    h_max: int = 8
    p_max: int = 512
    c_comp: int = 1024
    c_rerank: int = 128
    # execution knobs (RuntimeConfig)
    build_chunk: int = 4096
    query_chunk: int = 64
    backend: str = "cuda"
    interpret: bool | None = None
    build_mode: str = "auto"
    payload: str = "f32"

    def __post_init__(self):
        if not _COMPOSED_CTOR.get():
            warnings.warn(
                "constructing SLSHConfig(...) from flat keywords is"
                " deprecated; build it from parts with"
                " SLSHConfig.compose(FamilyConfig(...), BudgetConfig(...),"
                " RuntimeConfig(...)) (repro_torch.dslsh.make_config), and derive"
                " variants with cfg.replace(...)",
                DeprecationWarning,
                stacklevel=3,
            )
        self.family, self.budget, self.runtime  # noqa: B018  (validates)
        _require(
            not self.use_inner or self.h_max >= 1,
            f"h_max={self.h_max} with use_inner=True: stratification is on"
            " but the heavy-bucket registry holds zero buckets, so the"
            " inner layer would silently never fire — set h_max >= 1 or"
            " use_inner=False",
        )
        _require(
            self.payload == "f32" or self.backend == "cuda",
            f"payload={self.payload!r} with backend={self.backend!r}: the"
            " compressed candidate payload is a fused-tail feature — set"
            " backend='cuda' or payload='f32'",
        )
        _require(
            self.payload == "f32" or self.c_rerank >= self.k,
            f"c_rerank={self.c_rerank} < k={self.k} with"
            f" payload={self.payload!r}: the exact-rerank shortlist cannot"
            " hold k candidates, so every query would return approximate"
            " neighbours — raise c_rerank to at least k",
        )

    @classmethod
    def compose(
        cls,
        family: FamilyConfig | None = None,
        budget: BudgetConfig | None = None,
        runtime: RuntimeConfig | None = None,
        **overrides,
    ) -> "SLSHConfig":
        """The canonical constructor: compose the three sub-configs; flat
        field names in ``overrides`` route to their sub-config."""
        parts = {
            "family": dataclasses.asdict(family or FamilyConfig()),
            "budget": dataclasses.asdict(budget or BudgetConfig()),
            "runtime": dataclasses.asdict(runtime or RuntimeConfig()),
        }
        for name, val in overrides.items():
            parts[_field_group(name)][name] = val
        fam = FamilyConfig(**parts["family"])
        bud = BudgetConfig(**parts["budget"])
        run = RuntimeConfig(**parts["runtime"])
        tok = _COMPOSED_CTOR.set(True)
        try:
            return cls(
                **dataclasses.asdict(fam),
                **dataclasses.asdict(bud),
                **dataclasses.asdict(run),
            )
        finally:
            _COMPOSED_CTOR.reset(tok)

    def replace(self, **overrides) -> "SLSHConfig":
        """Derive a validated variant; flat field names route to sub-configs."""
        return SLSHConfig.compose(self.family, self.budget, self.runtime, **overrides)

    @property
    def family(self) -> FamilyConfig:
        """This config's hash-family half."""
        return FamilyConfig(**{name: getattr(self, name) for name in _FAMILY_FIELDS})

    @property
    def budget(self) -> BudgetConfig:
        """This config's budget half."""
        return BudgetConfig(**{name: getattr(self, name) for name in _BUDGET_FIELDS})

    @property
    def runtime(self) -> RuntimeConfig:
        """This config's execution half."""
        return RuntimeConfig(**{name: getattr(self, name) for name in _RUNTIME_FIELDS})

    @property
    def slot(self) -> int:
        """Per-outer-table candidate slot width."""
        outer = (1 + self.multiprobe) * self.c_max
        return max(outer, self.L_in * self.c_in) if self.use_inner else outer


def _field_group(name: str) -> str:
    """Which sub-config a flat SLSH field name belongs to."""
    if name in _FAMILY_FIELDS:
        return "family"
    if name in _BUDGET_FIELDS:
        return "budget"
    if name in _RUNTIME_FIELDS:
        return "runtime"
    raise ConfigError(
        f"unknown SLSH config field {name!r}; family fields:"
        f" {_FAMILY_FIELDS}, budget fields: {_BUDGET_FIELDS}, runtime"
        f" fields: {_RUNTIME_FIELDS}"
    )


class SLSHIndex(NamedTuple):
    outer_params: hashing.BitSampleParams
    inner_params: hashing.SignRPParams
    outer: tables.TableSet  # (L, n)
    heavy: tables.HeavyBuckets  # (L, H)
    inner_keys: torch.Tensor  # (L, H, L_in, P) int64 sorted
    inner_idx: torch.Tensor  # (L, H, L_in, P) int32 global idx, -1 pad
    n: int  # points in this shard


class QueryResult(NamedTuple):
    knn_idx: torch.Tensor  # (Q, K) int32, -1 pad
    knn_dist: torch.Tensor  # (Q, K) float32, inf pad
    comparisons: torch.Tensor  # (Q,) int32 — unique candidates scanned
    bucket_total: torch.Tensor  # (Q,) int32 — sum of probed bucket populations
    # unique survivors beyond the c_comp budget, excluded from the distance
    # stage (0 everywhere means the compacted result is exact)
    compaction_overflow: torch.Tensor  # (Q,) int32
    # compressed-payload tail only (None on the f32 path): candidates whose
    # approximate distance came within the quantization error bound of the
    # k-th exact distance but missed the c_rerank shortlist — counted,
    # never silent; 0 everywhere certifies knn_idx identical to f32
    rerank_misses: torch.Tensor | None = None  # (Q,) int32


class DeltaView(NamedTuple):
    """Streamed-in points exposed to the gather stage (DESIGN.md §9).

    Slot ``s`` (when ``valid[s]``) holds the point with global index
    ``gidx[s]``; slots fill in ascending global-index order, and every
    ``gidx`` exceeds every base index — the two facts the exact merge in
    :func:`_merge_capped` rests on.
    """

    outer_keys: torch.Tensor  # (cap, L) int64 bucket key per outer table
    inner_keys: torch.Tensor  # (cap, L_in) int64 inner-layer keys
    gidx: torch.Tensor  # (cap,) int32 global dataset index of each slot
    valid: torch.Tensor  # (cap,) bool — slot occupied


_IDX_SENTINEL = 2**31 - 1  # sorts after any index


# -------------------------------------------------------- backend dispatch


class BackendOps(NamedTuple):
    """The contract a compute backend implements (DESIGN.md §6).

    signature_words
        ``(params, x (n, d)) -> (n, L, W)`` packed signature words, equal
        to ``hashing.pack_bits(hashing.signature_bits(params, x))``.
    l1_topk
        ``(q (Q, d), cands (Q, C, d), mask (Q, C), k) -> (dist, pos)``,
        ascending, ties to the lowest position, inf/-1 padded.
    probe_words (optional)
        ``(params, x) -> (words (n, L, W), margins (n, L, m))`` from one
        launch; ``None`` recomputes margins from ``x``.
    query_tail (optional)
        ``(data, queries, cand (Q, C), run=, c_comp=, k=) -> (kd, ki,
        comparisons, overflow)``: stages 3-5 fused; ``None`` keeps the
        staged stages.
    query_tail_payload (optional)
        ``(data, qdata, meta, queries, cand, run=, c_comp=, c_rerank=, k=)
        -> (kd, ki, comparisons, overflow, rerank_misses)``: the fused tail
        over quantized candidate rows with an exact f32 rerank of the
        ``c_rerank`` shortlist; used only when ``cfg.payload != "f32"``.
    """

    signature_words: Callable[..., torch.Tensor]
    l1_topk: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    probe_words: Callable[..., tuple[torch.Tensor, torch.Tensor]] | None = None
    query_tail: Callable[..., tuple[torch.Tensor, ...]] | None = None
    query_tail_payload: Callable[..., tuple[torch.Tensor, ...]] | None = None


def _torch_signature_words(params: hashing.HashParams, x: torch.Tensor) -> torch.Tensor:
    return hashing.pack_bits(hashing.signature_bits(params, x))


def _cuda_ops() -> BackendOps:
    from repro_torch.kernels.hash_pack import ops as hp_ops
    from repro_torch.kernels.l1_topk import ops as l1_ops
    from repro_torch.kernels.query_fused import ops as qf_ops

    return BackendOps(
        hp_ops.signature_words,
        l1_ops.l1_topk,
        probe_words=hp_ops.probe_words,
        query_tail=qf_ops.query_tail,
        query_tail_payload=qf_ops.query_tail_payload,
    )


_BACKENDS: dict[str, BackendOps | Callable[[], BackendOps]] = {
    "torch": BackendOps(_torch_signature_words, topk.masked_l1_topk_batch),
    "cuda": _cuda_ops,
}


def get_backend(name: str) -> BackendOps:
    """Resolve a registered backend name to its ``BackendOps``."""
    try:
        entry = _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown SLSH backend {name!r}; registered: {sorted(_BACKENDS)}"
        ) from None
    return entry if isinstance(entry, BackendOps) else entry()


# ----------------------------------------------------------------- tracing


def _tracing_obs():
    """The ambient obs bundle when it records spans, else None (one
    ContextVar read on the untraced path)."""
    ob = obs_mod.get_active()
    return ob if ob is not None and ob.tracing else None


def _stage(ob, name: str, device: torch.device, fn, *args):
    """``fn(*args)``; when ``ob`` records spans, inside a ``name`` span that
    synchronizes ``device`` before it closes (so it covers device time, not
    the enqueue), its duration observed into the per-stage histogram."""
    if ob is None:
        return fn(*args)
    with ob.span(name) as sp:
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if ob.metrics is not None:
        ob.metrics.histogram(
            "dslsh_stage_latency_seconds",
            "device time per eager query-pipeline stage dispatch"
            " (recorded only under tracing — the sync-point policy)",
        ).labels(stage=name).observe(sp.dur_s)
    return out


# ------------------------------------------------------------------- build


def make_family(
    gen: torch.Generator, d: int, cfg: SLSHConfig,
    device: torch.device | str | None = None,
) -> tuple[hashing.BitSampleParams, hashing.SignRPParams]:
    """The full (outer, inner) hash family for dimensionality ``d``, drawn
    from ``gen``, on ``device`` (the card unless told otherwise). Inner
    instances are shared across heavy buckets."""
    outer = hashing.make_bitsample(
        gen, cfg.L_out, cfg.m_out, d, cfg.val_lo, cfg.val_hi, device
    )
    inner = hashing.make_signrp(gen, cfg.L_in, cfg.m_in, d, device)
    return outer, inner


def family_from_key(
    key, d: int, cfg: SLSHConfig, device: torch.device | str | None = None
) -> tuple[hashing.BitSampleParams, hashing.SignRPParams]:
    """The root hash family named by ``key``: an int seed or a
    ``torch.Generator`` to draw it from, or an ``(outer, inner)`` pair of
    the port's parameter types, moved to ``device`` (the card unless told
    otherwise)."""
    device = device_mod.resolve(device)
    if isinstance(key, tuple):
        outer, inner = key
        return (
            hashing.BitSampleParams(*(t.to(device) for t in outer)),
            hashing.SignRPParams(*(t.to(device) for t in inner)),
        )
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    return make_family(gen, d, cfg, device)


def hash_keys(
    params: hashing.HashParams, x: torch.Tensor, backend: BackendOps
) -> torch.Tensor:
    """Bucket keys for all tables: x (n, d) -> (n, L) int64."""
    words = backend.signature_words(params, x)  # (n, L, W)
    return hashing.mix32(words, params.salts[None, :])


def hash_keys_chunked(
    params: hashing.HashParams, x: torch.Tensor, chunk: int, backend: BackendOps
) -> torch.Tensor:
    """Memory-bounded build hashing: x (n, d) -> (L, n)."""
    return torch.cat(
        [hash_keys(params, x[lo : lo + chunk], backend).T
         for lo in range(0, x.shape[0], chunk)],
        dim=1,
    )


def build_inner(
    inner_params: hashing.SignRPParams,
    data: torch.Tensor,
    outer: tables.TableSet,
    heavy: tables.HeavyBuckets,
    cfg: SLSHConfig,
    backend: BackendOps,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inner (stratified) tables for every heavy bucket of every table.

    Each bucket's first ``p_max`` points (in table order) are hashed into
    ``L_in`` sign-projection tables, sorted stably by key; pad slots carry
    ``PAD_KEY`` / -1. All buckets hash in one backend call (the kernel on
    the card — see the note in ``core/tables.py``).
    -> (L, H, L_in, P) keys and indices.
    """
    l_out, n = outer.sorted_idx.shape
    h_max = heavy.start.shape[1]
    ar = torch.arange(cfg.p_max, device=data.device)
    offs = heavy.start.long()[..., None] + ar  # (L, H, P)
    in_pop = (ar < heavy.size.long()[..., None]) & heavy.valid[..., None]
    rows = torch.gather(
        outer.sorted_idx.long(), 1, offs.clamp(0, n - 1).reshape(l_out, -1)
    ).reshape(offs.shape)
    gidx = torch.where(in_pop, rows, -1)  # (L, H, P)
    pts = data[gidx.clamp(0, data.shape[0] - 1).reshape(-1)]  # garbage where pad
    keys = hash_keys(inner_params, pts, backend)  # (L*H*P, L_in)
    keys = keys.reshape(l_out, h_max, cfg.p_max, -1).permute(0, 1, 3, 2)
    keys = torch.where(in_pop[:, :, None, :], keys, tables.PAD_KEY)
    gidx_b = gidx[:, :, None, :].expand(keys.shape).to(torch.int32)
    return tables.sort_rows(keys, gidx_b)


def empty_inner(
    l_out: int, cfg: SLSHConfig, device: torch.device | str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inert inner tables for ``use_inner=False`` indices."""
    shape = (l_out, cfg.h_max, cfg.L_in, cfg.p_max)
    return (
        torch.full(shape, tables.PAD_KEY, dtype=torch.int64, device=device),
        torch.full(shape, -1, dtype=torch.int32, device=device),
    )


def _build_tables_chunked(
    outer_params: hashing.BitSampleParams,
    data: torch.Tensor,
    cfg: SLSHConfig,
    backend: BackendOps,
    ob=None,
) -> tables.TableSet:
    """Chunked sorted-run construction (DESIGN.md §13), eager.

    Each ``build_chunk`` of rows is hashed against every table, sorted into
    a run, and folded through the binary-counter ladder (``core.merge``);
    the result equals the monolithic stable sort. Peak transient memory is
    O(L * chunk) + O(output). Under tracing (``ob``) the three phases run
    one after another over all chunks, each in its ``build.*`` span.
    """
    n = data.shape[0]
    chunk = min(cfg.build_chunk, n)
    bounds = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]

    def hash_one(lo: int, hi: int) -> torch.Tensor:
        return hash_keys(outer_params, data[lo:hi], backend).T.contiguous()  # (L, c)

    def sort_one(lo: int, hi: int, kg: torch.Tensor) -> merge.Run:
        ig = torch.arange(lo, hi, dtype=torch.int32, device=data.device).expand(kg.shape)
        return tables.sort_rows(kg, ig)

    def merge_all(runs) -> tables.TableSet:
        stack: list[merge.Run] = []
        for run in runs:
            merge.ladder_push(stack, run)
        return tables.TableSet(*merge.ladder_collapse(stack))

    if ob is None:
        return merge_all(sort_one(lo, hi, hash_one(lo, hi)) for lo, hi in bounds)
    dev = data.device
    keys = _stage(ob, "build.hash", dev, lambda: [hash_one(lo, hi) for lo, hi in bounds])
    runs = _stage(
        ob, "build.sort_runs", dev, lambda: [sort_one(lo, hi, k) for (lo, hi), k in zip(bounds, keys)]
    )
    return _stage(ob, "build.merge", dev, merge_all, runs)


def _pick_build_mode(cfg: SLSHConfig, n: int) -> str:
    """``"auto"`` goes chunked only past one ``build_chunk`` of points."""
    mode = cfg.build_mode
    if mode == "auto":
        mode = "chunked" if n > cfg.build_chunk else "monolithic"
    return mode


def build_from_params(
    data: torch.Tensor,
    outer_params: hashing.BitSampleParams,
    inner_params: hashing.SignRPParams,
    cfg: SLSHConfig,
) -> SLSHIndex:
    """Shared index builder for the single-shard and grid paths.

    ``outer_params`` may be a row slice of a larger family (each grid cell
    keeps its own tables); the table count comes from the params. Needs
    ``n >= 1`` and ``n >= h_max`` points, like the JAX package.
    """
    n = data.shape[0]
    if n < 1 or n < cfg.h_max:
        raise ValueError(
            f"an SLSH index needs n >= 1 and n >= h_max points; got n={n},"
            f" h_max={cfg.h_max}"
        )
    backend = get_backend(cfg.backend)
    l_out = outer_params.salts.shape[0]
    ob = _tracing_obs()
    dev = data.device
    if _pick_build_mode(cfg, n) == "chunked":
        outer = _build_tables_chunked(outer_params, data, cfg, backend, ob)
        find_heavy = tables.find_heavy_streamed
    else:
        keys = _stage(ob, "build.hash", dev, hash_keys_chunked, outer_params, data, cfg.build_chunk, backend)
        outer = _stage(ob, "build.sort_runs", dev, tables.build_tables, keys)
        find_heavy = tables.find_heavy

    def heavy_inner():
        heavy = find_heavy(outer, max(int(cfg.alpha * n), 1), cfg.h_max)
        if cfg.use_inner:
            ik, ii = build_inner(inner_params, data, outer, heavy, cfg, backend)
        else:
            ik, ii = empty_inner(l_out, cfg, data.device)
        return heavy, ik, ii

    heavy, ik, ii = _stage(ob, "build.heavy_inner", dev, heavy_inner)
    return SLSHIndex(outer_params, inner_params, outer, heavy, ik, ii, n)


# ------------------------------------------------------------ query stages


def _stage_hash(
    index: SLSHIndex, queries: torch.Tensor, cfg: SLSHConfig, backend: BackendOps
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 — outer probe keys (Q, L, 1 + multiprobe) and inner keys
    (Q, L_in) (zeros when the inner layer is off). Backends with
    ``probe_words`` take the margins from the words' launch."""
    if cfg.multiprobe and backend.probe_words is not None:
        words, margins = backend.probe_words(index.outer_params, queries)
        probe_keys = hashing.probe_keys_from_margins(
            index.outer_params, words, margins, cfg.multiprobe
        )
    else:
        words = backend.signature_words(index.outer_params, queries)
        probe_keys = hashing.probe_keys_from_words(
            index.outer_params, queries, words, cfg.multiprobe
        )
    if cfg.use_inner:
        inner_keys = hash_keys(index.inner_params, queries, backend)
    else:
        inner_keys = torch.zeros(
            (queries.shape[0], cfg.L_in), dtype=torch.int64, device=queries.device
        )
    return probe_keys, inner_keys


def _segmented_searchsorted(
    pool: torch.Tensor,  # (S,) flat concatenation of sorted segments
    base: torch.Tensor,  # (...,) segment start offsets into pool
    key: torch.Tensor,  # (...,) search keys, same shape as base
    width: int,  # segment length
    side_right: bool,
) -> torch.Tensor:
    """First offset in ``[0, width)`` of ``pool[base:base+width]`` whose value
    is ``>= key`` (left) / ``> key`` (right): one vectorized binary search
    over the whole batch."""
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, width)
    for _ in range(max(1, width.bit_length())):
        mid = (lo + hi) >> 1
        v = pool[base + mid.clamp(max=width - 1)]
        go = (v <= key) if side_right else (v < key)
        go = go & (mid < width)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    return lo


def _gather_fast_parts(
    index: SLSHIndex,
    cfg: SLSHConfig,
    probe_keys: torch.Tensor,  # (Q, L, 1 + multiprobe)
    inner_keys: torch.Tensor,  # (Q, L_in)
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None, torch.Tensor]:
    """Stage 2's work: ``(outer_cand (Q, L, slot), inner_cand | None,
    found (Q, L) | None, bucket_total (Q,))``.

    Every probe window is an ascending slice of ``c_max`` (outer) or
    ``c_in`` (inner) indices, -1 padded — the run structure the fused tail
    merges.
    """
    l_out, n = index.outer.sorted_keys.shape
    q_n, _, p_n = probe_keys.shape
    slot, c_max, c_in, l_in = cfg.slot, cfg.c_max, cfg.c_in, cfg.L_in
    dev = probe_keys.device
    pk = probe_keys.permute(1, 0, 2).reshape(l_out, -1).contiguous()  # (L, Q*P)
    sk = index.outer.sorted_keys
    lo = torch.searchsorted(sk, pk, side="left").reshape(l_out, q_n, p_n)
    hi = torch.searchsorted(sk, pk, side="right").reshape(l_out, q_n, p_n)
    bucket_sz = (hi[:, :, 0] - lo[:, :, 0]).sum(dim=0).to(torch.int32)  # (Q,)
    loq = lo.permute(1, 0, 2)  # (Q, L, P)
    hiq = hi.permute(1, 0, 2)
    offs = loq[..., None] + torch.arange(c_max, device=dev)  # (Q, L, P, c_max)
    ok = offs < hiq[..., None]
    flat = torch.arange(l_out, device=dev)[None, :, None, None] * n + offs.clamp(0, n - 1)
    outer_cand = torch.where(
        ok, index.outer.sorted_idx.reshape(-1)[flat], -1
    ).reshape(q_n, l_out, p_n * c_max)
    outer_cand = torch.nn.functional.pad(outer_cand, (0, slot - p_n * c_max), value=-1)

    if not cfg.use_inner:
        return outer_cand, None, None, bucket_sz

    h_max = index.heavy.keys.shape[1]
    base_keys = probe_keys[:, :, 0]  # (Q, L)
    match = (index.heavy.keys[None] == base_keys[:, :, None]) & index.heavy.valid[None]
    found = match.any(dim=-1)  # (Q, L)
    h = match.to(torch.int32).argmax(dim=-1)  # first match, 0 if none

    p_in = index.inner_keys.shape[-1]
    ik_pool = index.inner_keys.reshape(-1)
    seg = (
        (torch.arange(l_out, device=dev)[None, :, None] * h_max + h[:, :, None]) * l_in
        + torch.arange(l_in, device=dev)[None, None, :]
    ) * p_in  # (Q, L, L_in) segment bases into the pooled inner tables
    keyq = inner_keys[:, None, :].expand(q_n, l_out, l_in)
    lo2 = _segmented_searchsorted(ik_pool, seg, keyq, p_in, False)
    hi2 = _segmented_searchsorted(ik_pool, seg, keyq, p_in, True)
    offs2 = lo2[..., None] + torch.arange(c_in, device=dev)  # (Q, L, L_in, c_in)
    ok2 = offs2 < hi2[..., None]
    flat2 = seg[..., None] + offs2.clamp(0, p_in - 1)
    inner_cand = torch.where(
        ok2, index.inner_idx.reshape(-1)[flat2], -1
    ).reshape(q_n, l_out, l_in * c_in)
    inner_cand = torch.nn.functional.pad(inner_cand, (0, slot - l_in * c_in), value=-1)
    return outer_cand, inner_cand, found, bucket_sz


def _gather_fast_select(
    cfg: SLSHConfig,
    outer_cand: torch.Tensor,  # (Q, L, slot)
    inner_cand: torch.Tensor | None,
    found: torch.Tensor | None,  # (Q, L)
) -> torch.Tensor:
    """Blend the fast-gather branches into the (Q, L*slot) candidate rows:
    a table whose base bucket is heavy takes its inner candidates."""
    q_n = outer_cand.shape[0]
    if inner_cand is None:
        return outer_cand.reshape(q_n, -1)
    return torch.where(
        found.repeat_interleave(cfg.slot, dim=1),
        inner_cand.reshape(q_n, -1),
        outer_cand.reshape(q_n, -1),
    )


def _stage_gather_fast(
    index: SLSHIndex,
    cfg: SLSHConfig,
    probe_keys: torch.Tensor,
    inner_keys: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 — dense candidate tensor (Q, L*slot) int32 + probed bucket
    sizes (Q,)."""
    outer_cand, inner_cand, found, bucket_sz = _gather_fast_parts(
        index, cfg, probe_keys, inner_keys
    )
    return _gather_fast_select(cfg, outer_cand, inner_cand, found), bucket_sz


def _merge_capped(
    base_cand: torch.Tensor,  # (..., budget) ascending, -1 pad at the end
    delta_match: torch.Tensor,  # (..., cap) delta slots in the same bucket
    delta_gidx: torch.Tensor,  # (cap,) ascending global indices
    budget: int,
) -> torch.Tensor:
    """Merge base bucket windows with their delta-segment matches, exactly.

    A from-scratch build over base ∪ delta gathers the ``budget`` smallest
    global indices of the union bucket (CSR rows are stably sorted, so
    equal keys order by index): the ``budget`` smallest of the base window
    and the matching delta slots, ascending, -1 padded. Two sorts, no
    ``topk`` (whose tie order is unspecified).
    """
    base = torch.where(base_cand < 0, _IDX_SENTINEL, base_cand)
    vals = torch.where(delta_match, delta_gidx, _IDX_SENTINEL)
    k = min(budget, vals.shape[-1])
    delta = torch.sort(vals, dim=-1).values[..., :k]
    merged = torch.sort(torch.cat([base, delta], dim=-1), dim=-1).values[..., :budget]
    return torch.where(merged == _IDX_SENTINEL, -1, merged)


def _stage_gather_delta(
    index: SLSHIndex,
    cfg: SLSHConfig,
    probe_keys: torch.Tensor,  # (Q, L, 1 + multiprobe)
    inner_keys: torch.Tensor,  # (Q, L_in)
    delta: DeltaView,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 over base + delta -> (cand (Q, L*slot), bucket_total (Q,)).

    The base windows come from the fast gather; each probe's window then
    merges with the delta slots holding its key (:func:`_merge_capped`), so
    every window stays an ascending ``c_max`` (outer) or ``c_in`` (inner)
    slice padded to ``slot``: the run layout of the base path, which the
    fused tail's ``run`` assumes. The inner layer keeps the *base* heavy
    registry (stratification is frozen between compactions); a delta
    member joins a heavy bucket's inner population only while
    ``heavy.size + rank < p_max``, as the first ``p_max`` rows of a union
    build would. All tables, queries and probes in one batch of ops.
    """
    q_n, l_out, p_n = probe_keys.shape
    c_max, c_in, l_in, slot = cfg.c_max, cfg.c_in, cfg.L_in, cfg.slot
    outer_cand, inner_cand, found, bucket_sz = _gather_fast_parts(
        index, cfg, probe_keys, inner_keys
    )
    dkeys = delta.outer_keys.T  # (L, cap)
    match = delta.valid & (dkeys[None, :, None, :] == probe_keys[..., None])  # (Q, L, P, cap)
    d_base = match[:, :, 0]  # (Q, L, cap) matches of each table's base key
    bucket_sz = bucket_sz + d_base.sum(dim=(1, 2), dtype=torch.int32)
    win = outer_cand[..., : p_n * c_max].reshape(q_n, l_out, p_n, c_max)
    outer = _merge_capped(win, match, delta.gidx, c_max).reshape(q_n, l_out, p_n * c_max)
    outer = torch.nn.functional.pad(outer, (0, slot - p_n * c_max), value=-1)
    if not cfg.use_inner:
        return outer.reshape(q_n, -1), bucket_sz

    base_keys = probe_keys[:, :, 0]
    hit = (index.heavy.keys[None] == base_keys[:, :, None]) & index.heavy.valid[None]
    h = hit.to(torch.int32).argmax(dim=-1)  # (Q, L) first match, 0 if none
    size = torch.gather(index.heavy.size[None].expand(q_n, -1, -1), 2, h[..., None].long())
    rank = torch.cumsum(d_base.to(torch.int32), dim=-1) - 1
    in_pop = d_base & (size + rank < cfg.p_max)  # (Q, L, cap)
    d_in = delta.inner_keys.T  # (L_in, cap)
    dm = in_pop[:, :, None, :] & (d_in[None, None] == inner_keys[:, None, :, None])  # (Q, L, L_in, cap)
    win2 = inner_cand[..., : l_in * c_in].reshape(q_n, l_out, l_in, c_in)
    inner = _merge_capped(win2, dm, delta.gidx, c_in).reshape(q_n, l_out, l_in * c_in)
    inner = torch.nn.functional.pad(inner, (0, slot - l_in * c_in), value=-1)
    return _gather_fast_select(cfg, outer, inner, found), bucket_sz


def _stage_dedup(cand: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 3 — sort each row; the first occurrence of an index survives."""
    cand_sorted = torch.sort(cand, dim=-1).values
    uniq = torch.ones_like(cand_sorted, dtype=torch.bool)
    uniq[:, 1:] = cand_sorted[:, 1:] != cand_sorted[:, :-1]
    uniq &= cand_sorted >= 0
    return cand_sorted, uniq, uniq.sum(dim=-1, dtype=torch.int32)


def _compact_width(cfg: SLSHConfig, c_total: int, n: int) -> int:
    """Compacted-buffer width for a query chunk: ``c_comp`` clamped to the
    gather width and to ``n`` rounded up to 128 — the JAX package's formula,
    kept because it sets ``compaction_overflow``."""
    cc = c_total if cfg.c_comp <= 0 else min(cfg.c_comp, c_total)
    return max(1, min(cc, -(-n // 128) * 128))


def _stage_compact(
    cand_sorted: torch.Tensor,  # (Q, C)
    uniq: torch.Tensor,  # (Q, C)
    comparisons: torch.Tensor,  # (Q,)
    c_comp: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 4 — unique survivors to the row front, cut to ``c_comp``;
    survivors past the cut are counted in the returned overflow."""
    comp = torch.sort(torch.where(uniq, cand_sorted, _IDX_SENTINEL), dim=-1).values
    comp = comp[:, :c_comp]
    valid = comp != _IDX_SENTINEL
    overflow = (comparisons - c_comp).clamp(min=0)
    return torch.where(valid, comp, -1), valid, overflow


def _stage_topk(
    data: torch.Tensor,
    queries: torch.Tensor,
    cand: torch.Tensor,  # (Q, c_comp) compacted, ascending, -1 pad
    valid: torch.Tensor,  # (Q, c_comp)
    cfg: SLSHConfig,
    backend: BackendOps,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 5 — masked L1 top-k over the compacted (Q, c_comp, d) block."""
    pts = data[cand.long().clamp(0, data.shape[0] - 1)].contiguous()  # (Q, c_comp, d)
    kd, pos = backend.l1_topk(queries.contiguous(), pts, valid.contiguous(), cfg.k)
    ki = torch.where(pos >= 0, torch.gather(cand, -1, pos.long().clamp(min=0)), -1)
    return kd, ki.to(torch.int32)


def _fused_run(cfg: SLSHConfig) -> int:
    """The fused tail's merge-run length: every ``gcd(c_max, c_in, slot)``
    aligned slice of a gathered row ascends."""
    run = math.gcd(cfg.c_max, cfg.slot)
    if cfg.use_inner:
        run = math.gcd(run, cfg.c_in)
    return run


def _use_payload(cfg: SLSHConfig, backend: BackendOps) -> bool:
    """Whether this config runs the compressed-payload fused tail."""
    return cfg.payload != "f32" and backend.query_tail_payload is not None


def query_chunk(
    index: SLSHIndex,
    data: torch.Tensor,
    queries: torch.Tensor,
    cfg: SLSHConfig,
    payload: Payload | None = None,
    delta: DeltaView | None = None,
) -> QueryResult:
    """Run the pipeline for one (Q, d) chunk of queries.

    ``delta`` fans the gather out over base + delta segments (the
    streaming path, DESIGN.md §9); the merged candidates flow through the
    same tail. Backends with ``query_tail`` (``"cuda"``) run stages 3-5 as
    one fused launch; the staged form below is the oracle. With a
    compressed ``cfg.payload`` the tail reads the quantized rows of
    ``payload`` (made here from ``data`` when the caller holds none) and
    reranks exactly in f32. Under tracing each stage of a fused chunk runs
    in its ``query.*`` span.
    """
    backend = get_backend(cfg.backend)
    fused = backend.query_tail is not None
    ob = _tracing_obs() if fused else None
    dev = queries.device
    probe_keys, inner_keys = _stage(ob, "query.hash", dev, _stage_hash, index, queries, cfg, backend)
    if delta is not None:
        cand, bucket_total = _stage(
            ob, "query.gather_delta", dev, _stage_gather_delta, index, cfg, probe_keys, inner_keys, delta
        )
    else:
        outer_cand, inner_cand, found, bucket_total = _stage(
            ob, "query.gather_work", dev, _gather_fast_parts, index, cfg, probe_keys, inner_keys
        )
        cand = _stage(ob, "query.gather_select", dev, _gather_fast_select, cfg, outer_cand, inner_cand, found)
    cc = _compact_width(cfg, cand.shape[1], data.shape[0])
    if _use_payload(cfg, backend):
        if payload is None:
            payload = make_payload(data, cfg.payload)
        kd, ki, comparisons, overflow, misses = _stage(
            ob, "query.tail", dev, lambda: backend.query_tail_payload(
                data, payload.qdata, payload.meta, queries, cand.contiguous(),
                run=_fused_run(cfg), c_comp=cc, c_rerank=cfg.c_rerank, k=cfg.k,
            ),
        )
        return QueryResult(ki, kd, comparisons, bucket_total, overflow, misses)
    if fused:
        kd, ki, comparisons, overflow = _stage(
            ob, "query.tail", dev, lambda: backend.query_tail(
                data, queries, cand.contiguous(), run=_fused_run(cfg), c_comp=cc, k=cfg.k
            ),
        )
        return QueryResult(ki, kd, comparisons, bucket_total, overflow)
    cand_sorted, uniq, comparisons = _stage_dedup(cand)
    comp_cand, comp_valid, overflow = _stage_compact(cand_sorted, uniq, comparisons, cc)
    kd, ki = _stage_topk(data, queries, comp_cand, comp_valid, cfg, backend)
    return QueryResult(ki, kd, comparisons, bucket_total, overflow)


def query_batch(
    index: SLSHIndex,
    data: torch.Tensor,
    queries: torch.Tensor,
    cfg: SLSHConfig,
    payload: Payload | None = None,
    delta: DeltaView | None = None,
) -> QueryResult:
    """Chunked pipeline over queries -> stacked QueryResult (Q, ...).

    A compressed ``cfg.payload`` reads ``payload``, made once for the whole
    batch when the caller holds none (handles cache theirs). ``delta``
    queries a streaming index's base + delta segment. Under tracing the
    staged (``"torch"``) backend records one ``query.batch`` span, as the
    JAX package's one-program staged path does.
    """
    queries = queries.to(torch.float32)
    backend = get_backend(cfg.backend)
    if payload is None and _use_payload(cfg, backend):
        payload = make_payload(data, cfg.payload)

    def run() -> QueryResult:
        outs = [
            query_chunk(index, data, queries[lo : lo + cfg.query_chunk], cfg, payload, delta)
            for lo in range(0, queries.shape[0], cfg.query_chunk)
        ]
        if len(outs) == 1:
            return outs[0]
        return QueryResult(*(
            None if parts[0] is None else torch.cat(parts, dim=0) for parts in zip(*outs)
        ))

    ob = _tracing_obs() if backend.query_tail is None else None
    return _stage(ob, "query.batch", queries.device, run)
