"""Synthetic arterial-blood-pressure (MAP) waveform generation.

The port's counterpart of ``repro.data.abp``: the same generator, drawn
from numpy's ``default_rng`` made from a seed instead of JAX's threefry
streams (which no other library reproduces), so a seed gives other beats
than the JAX package's. The parity tests therefore take the beats from the
JAX package and feed them to the port.

Per-beat Mean Arterial Pressure series with the statistical shape the
paper's pipeline expects (DESIGN.md §7):

* a slowly drifting patient baseline (healthy MAP ~70-95 mmHg),
* beat-to-beat noise + respiratory oscillation,
* sparse hypotensive episodes: smooth excursions below 60 mmHg lasting
  minutes-to-hours (these generate the positive AHE labels),
* occasional invalid beats (artifacts) which the windowing layer drops.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ABPConfig:
    n_beats: int = 200_000  # beats per record (~1 beat/second)
    beats_per_min: int = 60
    baseline_lo: float = 68.0
    baseline_hi: float = 95.0
    drift_scale: float = 4.0  # mmHg, slow random-walk amplitude
    noise_scale: float = 2.0  # mmHg, per-beat noise
    resp_amp: float = 1.5  # respiratory oscillation amplitude
    resp_period: float = 17.0  # beats
    episode_rate: float = 1.0 / 40_000.0  # episode onsets per beat
    episode_depth_lo: float = 12.0  # mmHg below 60 at trough
    episode_depth_hi: float = 30.0
    episode_len_lo: int = 1_200  # beats (~20 min)
    episode_len_hi: int = 5_400  # beats (~90 min)
    artifact_rate: float = 0.01


def _drift_scan(x: np.ndarray, decay: float) -> np.ndarray:
    """The reference's drift: ``jax.lax.associative_scan`` of
    ``(a, b) -> a * decay + b`` over ``x``, replayed step for step.

    That combine is not associative, so the parallel scan's result depends
    on its pairing order; this is the same recursive odd/even schedule in
    float32, so the drift has the reference's statistics (close to a
    random walk, far wider than a sequential moving average's).
    """
    n = x.shape[0]
    if n < 2:
        return x
    combine = lambda a, b: (a * np.float32(decay) + b).astype(np.float32)  # noqa: E731
    odd = _drift_scan(combine(x[0:-1:2], x[1::2]), decay)
    even = combine(odd[:-1] if n % 2 == 0 else odd, x[2::2])
    out = np.empty_like(x)
    out[0] = x[0]
    out[2::2] = even
    out[1::2] = odd
    return out


def _episode_dip(onset: np.ndarray, depth: np.ndarray, length: np.ndarray) -> np.ndarray:
    """The raised-cosine episode envelope: an onset starts an episode only
    when none is running; beat ``j`` of an episode of length ``L`` dips
    ``depth * sin(pi * j / L)**2``."""
    n = onset.shape[0]
    dip = np.zeros(n, np.float64)
    starts = np.flatnonzero(onset)
    free = 0  # first beat at which a new episode may start
    for i in starts.tolist():
        if i < free:
            continue
        ln = int(length[i])
        j = np.arange(min(ln, n - i))
        dip[i : i + j.shape[0]] = depth[i] * np.sin(np.pi * j / ln) ** 2
        free = i + ln
    return dip


def synth_record(rng: np.random.Generator, cfg: ABPConfig) -> tuple[np.ndarray, np.ndarray]:
    """One patient record -> (map_mmHg (n_beats,) f32, valid (n_beats,) bool)."""
    n = cfg.n_beats
    t = np.arange(n, dtype=np.float64)
    base = rng.uniform(cfg.baseline_lo, cfg.baseline_hi)
    drift = _drift_scan((rng.standard_normal(n) * cfg.drift_scale * 0.045).astype(np.float32), 0.999)
    resp = cfg.resp_amp * np.sin(2 * np.pi * t / cfg.resp_period + rng.uniform(0, 2 * np.pi))
    noise = cfg.noise_scale * rng.standard_normal(n)
    onset = rng.random(n) < cfg.episode_rate
    depth = rng.uniform(cfg.episode_depth_lo, cfg.episode_depth_hi, n)
    length = rng.integers(cfg.episode_len_lo, cfg.episode_len_hi, n)
    dip = _episode_dip(onset, depth, length)
    # target trough = 60 - (depth - 12) => dips reach well below the AHE line
    mapv = base + drift + resp + noise - dip * (base - 45.0) / max(base, 1.0)
    mapv = np.clip(mapv, 20.0, 180.0).astype(np.float32)
    valid = ~(rng.random(n) < cfg.artifact_rate)
    return mapv, valid


def synth_dataset_beats(seed: int, n_records: int, cfg: ABPConfig) -> tuple[np.ndarray, np.ndarray]:
    """(n_records, n_beats) MAP values + validity masks, one independent
    stream per record spawned from ``seed``."""
    streams = np.random.default_rng(seed).spawn(n_records)
    recs = [synth_record(r, cfg) for r in streams]
    return np.stack([m for m, _ in recs]), np.stack([v for _, v in recs])
