"""Streaming quickstart on the PyTorch/CUDA port: live ICU monitoring over
an ABP stream — the twin of ``examples/stream_quickstart.py``, printing the
same lines.

A StreamingMonitor warms up on the historical patient records (all but the
last), then replays the last record as a live timestamped stream: each
arriving batch of lag windows is first classified (rolling AHE prediction
with per-event latency), then ingested into the sharded streaming index —
queryable immediately, no rebuild. Nodes compact when their delta segments
fill.

Run:  PYTHONPATH=src python examples/torch_stream_quickstart.py [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given. The beats come
from ``repro_torch.data.abp`` (8 records x 60,000 beats); :func:`main`
takes them as arguments, so the JAX package's beats can be fed instead.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import dslsh, stream
from repro_torch.data import abp, windows

GRID = dslsh.Grid(nu=2, p=2)
FAMILY = dslsh.FamilyConfig(m_out=24, L_out=8, m_in=12, L_in=4, alpha=0.01, val_lo=20.0, val_hi=180.0)
BUDGET = dslsh.BudgetConfig(k=10, c_max=128, c_in=32, h_max=8, p_max=256)


def main(mapv: np.ndarray, valid: np.ndarray, *, params=None, device=None, backend: str = "cuda") -> dict:
    """The streaming quickstart on ``(records, beats)`` MAP values and
    validity masks: the last record streams live, the others warm the
    index. ``params`` supplies the root hash family as an ``(outer,
    inner)`` pair (the port's types); without it the family is drawn from
    seed 1. Returns the monitor and the printed numbers."""
    mapv, valid = np.asarray(mapv), np.asarray(valid)
    hist = windows.build_dataset(mapv[:-1], valid[:-1], windows.AHE_51_5C)
    live_pts, live_lab, live_ts = windows.stream_windows_from_record(mapv[-1], valid[-1], windows.AHE_51_5C)
    print(f"history={hist['points'].shape[0]} windows "
          f"(pct_no_ahe={hist['pct_no_ahe']:.1f}%)  "
          f"live={live_pts.shape[0]} windows ({int(live_lab.sum())} AHE)")

    # warm the sharded streaming index on the historical windows
    cfg = dslsh.make_config(FAMILY, BUDGET, dslsh.RuntimeConfig(query_chunk=16, backend=backend))
    n_warm = hist["points"].shape[0] // GRID.nu * GRID.nu
    monitor = stream.StreamingMonitor(
        1 if params is None else params, hist["points"][:n_warm], hist["labels"][:n_warm], cfg, GRID,
        node_capacity=n_warm // GRID.nu + 1024, delta_cap=64, t0=0.0,
        # a live window's label is only observable once its condition window
        # closes — no look-ahead leaks into the rolling MCC
        label_delay_s=float(windows.AHE_51_5C.cond_beats), device=device,
    )
    print(f"warm: nu={GRID.nu} x p={GRID.p} cells, n_index={monitor.n_index()}")

    # live phase: predict-then-ingest, timestamped in beats (~seconds)
    events = monitor.replay(live_pts, live_lab, live_ts, batch_size=16)

    lat = np.asarray([e.latency_s for e in events if e.preds])
    compactions = sum(e.compacted for e in events)
    comps = float(np.median([e.comparisons for e in events if e.preds]))
    routed = float(np.median([e.routed_frac for e in events if e.preds]))
    print(f"streamed {live_pts.shape[0]} windows over "
          f"{live_ts[-1] - live_ts[0]:.0f} beats in {len(events)} events; "
          f"n_index={monitor.n_index()}  compactions={compactions}")
    print(f"prediction latency: median={np.median(lat)*1e3:.1f} ms  "
          f"p95={np.percentile(lat, 95)*1e3:.1f} ms")
    print(f"rolling MCC={monitor.mcc():.3f}  (median per-cell comparisons={comps:.0f})")
    print(f"routing: median fraction of cells visited per batch={routed:.2f} "
          f"(DESIGN.md §10 — 1.00 would mean the Forwarder broadcast)")
    return dict(monitor=monitor, events=events, compactions=compactions, median_comparisons=comps,
                rolling_mcc=monitor.mcc(), median_routed_frac=routed, latency_s=lat)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' to run without the card")
    args = ap.parse_args()
    cfg_abp = abp.ABPConfig(n_beats=60_000, episode_rate=1.0 / 2500.0)
    main(*abp.synth_dataset_beats(0, 8, cfg_abp), device=args.device)
