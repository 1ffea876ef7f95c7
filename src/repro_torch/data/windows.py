"""beatDB-style rolling-window dataset construction (paper §4, Table 1).

A copy of ``repro.data.windows`` (numpy only), kept in the port so that it
imports nothing of the JAX package; ``tests/test_torch_grid.py`` holds the
two to the same points and labels.

A *point* is the d=30 vector of per-subwindow mean MAP over valid beats in a
lag window of length ``l``. The label is positive iff the following condition
window of length ``c`` is an AHE: >= 90% of its (valid) per-beat MAP values
are below 60 mmHg. The rolling step is 10% of (l+c) after a negative window
and the full (l+c) after a positive one [15].

This layer is host-side numpy (it is the offline dataset builder); prefix
sums make each rolling step O(1).
"""
from __future__ import annotations

import dataclasses

import numpy as np

AHE_THRESHOLD_MMHG = 60.0
AHE_FRACTION = 0.90
D_SUBWINDOWS = 30


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    name: str
    lag_beats: int  # l, in beats (1 beat ~ 1 second)
    cond_beats: int  # c
    d: int = D_SUBWINDOWS
    stride_frac: float = 0.10


# The paper's two datasets (Table 1). 1 beat/second.
AHE_301_30C = WindowConfig("AHE-301-30c", lag_beats=30 * 60, cond_beats=30 * 60)
AHE_51_5C = WindowConfig("AHE-51-5c", lag_beats=5 * 60, cond_beats=5 * 60)


def _prefix(x: np.ndarray) -> np.ndarray:
    out = np.zeros(x.shape[0] + 1, np.float64)
    np.cumsum(x, out=out[1:])
    return out


def _rolling_windows(
    mapv: np.ndarray, valid: np.ndarray, cfg: WindowConfig
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One record -> (points (N, d) f32, labels (N,) i8, starts (N,) i64).

    The single implementation of the rolling scan + feature extraction; the
    batch and streaming entry points below are views over it.
    """
    n = mapv.shape[0]
    l, c = cfg.lag_beats, cfg.cond_beats
    total = l + c
    stride = max(int(cfg.stride_frac * total), 1)

    cs_val = _prefix(valid.astype(np.float64))
    cs_map = _prefix(np.where(valid, mapv, 0.0).astype(np.float64))
    cs_below = _prefix((valid & (mapv < AHE_THRESHOLD_MMHG)).astype(np.float64))

    def frac_below(a: int, b: int) -> float:
        nv = cs_val[b] - cs_val[a]
        return (cs_below[b] - cs_below[a]) / nv if nv > 0 else 0.0

    starts, labels = [], []
    i = 0
    while i + total <= n:
        pos = frac_below(i + l, i + total) >= AHE_FRACTION
        starts.append(i)
        labels.append(pos)
        i += total if pos else stride

    if not starts:
        return (
            np.zeros((0, cfg.d), np.float32),
            np.zeros((0,), np.int8),
            np.zeros((0,), np.int64),
        )

    starts_a = np.asarray(starts, np.int64)
    # subwindow edges: d+1 boundaries across the lag window
    edges = np.linspace(0, l, cfg.d + 1).astype(np.int64)
    a = starts_a[:, None] + edges[None, :-1]
    b = starts_a[:, None] + edges[None, 1:]
    nv = cs_val[b] - cs_val[a]
    sm = cs_map[b] - cs_map[a]
    feats = np.divide(sm, nv, out=np.zeros_like(sm), where=nv > 0)
    # empty subwindows fall back to the window mean (beatDB gap handling)
    row_nv = nv.sum(axis=1)
    row_mean = np.divide(
        sm.sum(axis=1), row_nv, out=np.full_like(row_nv, 80.0), where=row_nv > 0
    )
    feats = np.where(nv > 0, feats, row_mean[:, None])
    return feats.astype(np.float32), np.asarray(labels, np.int8), starts_a


def windows_from_record(
    mapv: np.ndarray, valid: np.ndarray, cfg: WindowConfig
) -> tuple[np.ndarray, np.ndarray]:
    """One record -> (points (N, d) f32, labels (N,) i8)."""
    points, labels, _ = _rolling_windows(mapv, valid, cfg)
    return points, labels


def stream_windows_from_record(
    mapv: np.ndarray, valid: np.ndarray, cfg: WindowConfig
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Timestamped rolling windows for the streaming path (DESIGN.md §9.5).

    Same points and labels as ``windows_from_record``, plus the beat index
    at which each window becomes available to a live monitor: the end of
    its lag window (``start + l`` — the condition window, and hence the
    label, lies in the *future* at that moment; 1 beat ~ 1 second).
    Returns (points (N, d), labels (N,), t_beats (N,) float64 ascending).
    """
    points, labels, starts = _rolling_windows(mapv, valid, cfg)
    return points, labels, (starts + cfg.lag_beats).astype(np.float64)


def build_dataset(
    records_map: np.ndarray, records_valid: np.ndarray, cfg: WindowConfig
) -> dict:
    """Stack windows from all records. Returns dict(points, labels, meta)."""
    pts, labs = [], []
    for r in range(records_map.shape[0]):
        p, y = windows_from_record(records_map[r], records_valid[r], cfg)
        if p.shape[0]:
            pts.append(p)
            labs.append(y)
    points = np.concatenate(pts, axis=0) if pts else np.zeros((0, cfg.d), np.float32)
    labels = np.concatenate(labs, axis=0) if labs else np.zeros((0,), np.int8)
    frac_neg = float((labels == 0).mean()) if labels.size else 1.0
    return {
        "name": cfg.name,
        "points": points,
        "labels": labels,
        "pct_no_ahe": 100.0 * frac_neg,
    }


def train_test_split(
    dataset: dict, n_test: int, seed: int = 0
) -> tuple[dict, np.ndarray, np.ndarray]:
    """Out-of-sample query split (paper uses 2000 test queries)."""
    rng = np.random.default_rng(seed)
    n = dataset["points"].shape[0]
    perm = rng.permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    train_ds = dict(
        dataset,
        points=dataset["points"][train],
        labels=dataset["labels"][train],
    )
    return train_ds, dataset["points"][test], dataset["labels"][test]


# ------------------------------------------------- chunked window synthesis
#
# The paper-scale harness (benchmarks/scale_bench.py, DESIGN.md §13) feeds
# 1.37M windows through the out-of-core build. Materializing the underlying
# beat waveforms for that many rolling windows (~hours of MAP per window)
# defeats the point of a bounded-memory build, so the scale path synthesizes
# *window vectors* directly with the statistical shape the rolling pipeline
# emits: a per-window patient baseline plus subwindow noise, and a
# ``dip_frac`` minority whose MAP ramps down through the lag window toward a
# hypotensive (< 60 mmHg) tail — the trajectory an imminent AHE presents to
# a live monitor (§4). Generation is block-seeded: block ``j`` always draws
# from ``SeedSequence([seed, j])`` over the full fixed block, and chunks
# slice across blocks — so the stream is a pure function of ``(spec, row)``
# and chunk size provably cannot change it.

GEN_BLOCK = 4096  # fixed generation block; chunks slice across blocks


@dataclasses.dataclass(frozen=True)
class SyntheticWindowSpec:
    """Shape of a directly-synthesized window stream (scale harness).

    ``n`` rows of ``d`` per-subwindow MAP means: baseline uniform in
    ``[baseline_lo, baseline_hi]`` mmHg + N(0, noise_mmhg) per subwindow;
    a ``dip_frac`` minority ramps down by ``depth ~ U[dip_lo, dip_hi]``
    mmHg scaled by a quadratic ramp toward the window tail. The label is
    physical, not stored metadata: positive iff the final subwindow mean
    sits below the AHE threshold (60 mmHg).
    """

    n: int
    d: int = D_SUBWINDOWS
    seed: int = 0
    baseline_lo: float = 68.0
    baseline_hi: float = 95.0
    noise_mmhg: float = 2.0
    dip_frac: float = 0.08
    dip_lo: float = 15.0
    dip_hi: float = 40.0


def synth_window_block(spec: SyntheticWindowSpec, j: int) -> tuple[np.ndarray, np.ndarray]:
    """Generate full block ``j`` -> (points (GEN_BLOCK, d) f32, labels i8).

    Always the full fixed block, seeded ``SeedSequence([seed, j])`` —
    callers slice; nothing about chunking reaches the RNG.
    """
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, j]))
    b, d = GEN_BLOCK, spec.d
    baseline = rng.uniform(spec.baseline_lo, spec.baseline_hi, size=(b, 1))
    noise = rng.normal(0.0, spec.noise_mmhg, size=(b, d))
    dip = rng.random(b) < spec.dip_frac
    depth = rng.uniform(spec.dip_lo, spec.dip_hi, size=b)
    ramp = np.linspace(0.0, 1.0, d) ** 2  # accelerating decline to the tail
    pts = baseline + noise - (dip * depth)[:, None] * ramp[None, :]
    pts = np.clip(pts, 20.0, 180.0).astype(np.float32)
    labels = (pts[:, -1] < AHE_THRESHOLD_MMHG).astype(np.int8)
    return pts, labels


def synth_window_slice(
    spec: SyntheticWindowSpec, lo: int, hi: int
) -> tuple[np.ndarray, np.ndarray]:
    """Rows ``[lo, hi)`` of the stream (assembled from full blocks)."""
    if not 0 <= lo <= hi <= spec.n:
        raise ValueError(f"slice [{lo}, {hi}) outside stream of n={spec.n}")
    pts, labs = [], []
    for j in range(lo // GEN_BLOCK, (max(hi, lo + 1) - 1) // GEN_BLOCK + 1):
        p, y = synth_window_block(spec, j)
        a = max(lo - j * GEN_BLOCK, 0)
        b = min(hi - j * GEN_BLOCK, GEN_BLOCK)
        pts.append(p[a:b])
        labs.append(y[a:b])
    return (
        np.concatenate(pts, axis=0)
        if pts else np.zeros((0, spec.d), np.float32),
        np.concatenate(labs, axis=0) if labs else np.zeros((0,), np.int8),
    )


def synth_window_chunks(spec: SyntheticWindowSpec, chunk: int):
    """Stream the ``n`` rows as ``(points, labels)`` chunks of ``chunk``
    rows (final chunk ragged). Peak memory is O(chunk + GEN_BLOCK) — the
    full array never exists; the stream is identical for every ``chunk``.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for lo in range(0, spec.n, chunk):
        yield synth_window_slice(spec, lo, min(lo + chunk, spec.n))
