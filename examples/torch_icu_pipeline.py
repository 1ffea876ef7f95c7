"""ICU end-to-end scenario on the PyTorch/CUDA port: streaming AHE prediction
with fault tolerance — the twin of ``examples/icu_pipeline.py``, printing
the same lines.

A DSLSH cluster answers latency-critical AHE queries; one node goes down
mid-stream (heartbeat missed); the Reducer first proceeds without it
(straggler deadline), then the cluster restores the lost node's cells in
place — surviving cells reused untouched — and keeps serving. Every phase
answers through the same typed ``repro_torch.dslsh`` handle.

Run:  PYTHONPATH=src python examples/torch_icu_pipeline.py [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given. The beats come
from the port's own generator (``repro_torch.data.abp``, 8 records x 60,000
beats), which draws other numbers than the JAX package's from the same
seed; :func:`main` takes the beats as arguments, so the JAX package's beats
can be fed to it instead.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import dslsh
from repro_torch.core import predict
from repro_torch.data import abp, windows
from repro_torch.runtime import ft

FAMILY = dslsh.FamilyConfig(m_out=24, L_out=16, m_in=12, L_in=4, alpha=0.01, val_lo=20.0, val_hi=180.0)
BUDGET = dslsh.BudgetConfig(k=10, c_max=128, c_in=32, h_max=8, p_max=256)


def main(mapv: np.ndarray, valid: np.ndarray, *, params=None, device=None, backend: str = "cuda") -> dict:
    """The ICU scenario on ``(records, beats)`` MAP values and validity
    masks: healthy, node 2 dropped by the deadline Reducer, node 2's cells
    restored in place. ``params`` supplies the root hash family (for
    instance the JAX package's ``make_family(PRNGKey(1), ...)`` in the
    port's types); without it the family is drawn from seed 1. Returns the
    three MCCs, the restored phase's median comparisons per processor and
    the restore's seconds (the device synchronized)."""
    dev = device_mod.resolve(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # dataset
    ds = windows.build_dataset(np.asarray(mapv), np.asarray(valid), windows.AHE_51_5C)
    train, qx, qy = windows.train_test_split(ds, n_test=300)

    deploy = dslsh.grid(nu=4, p=4)
    cfg = dslsh.make_config(FAMILY, BUDGET, backend=backend)
    pts, labs, _ = dslsh.pad_to_multiple(train["points"], train["labels"], deploy.cells)
    index = dslsh.build(1, pts, cfg, deploy, dev, params=params)
    labs = torch.as_tensor(labs, device=dev)
    print(f"cluster up: nu={deploy.nu} nodes x p={deploy.p} cores, n={pts.shape[0]}")

    monitor = ft.HeartbeatMonitor(n_nodes=deploy.nu, deadline_s=0.5)
    now = time.time()
    for n in range(deploy.nu):
        monitor.beat(n, t=now)

    def mcc_of(res, labs_, qy_):
        pred = predict.predict_batch(labs_, res.knn_idx, res.knn_dist)
        return float(predict.mcc(pred, torch.as_tensor(qy_, device=dev)))

    # phase 1: healthy cluster
    res = index.query(qx[:100])
    mcc1 = mcc_of(res, labs, qy[:100])
    print(f"phase 1 (healthy):     MCC={mcc1:.3f}")

    # phase 2: node 2 misses its heartbeat -> Reducer proceeds without it
    monitor.beat(2, t=now - 10.0)
    drop = torch.as_tensor(monitor.drop_mask(now=now), device=dev)
    res = index.query(qx[100:200], drop_mask=drop)
    mcc2 = mcc_of(res, labs, qy[100:200])
    print(f"phase 2 (node 2 down, deadline reducer): MCC={mcc2:.3f}"
          f"  (answers stay available, recall degrades gracefully)")

    # phase 3: permanent failure -> restore node 2's cells in place on the
    # same grid (pass the live handle: surviving cells' tables are reused
    # untouched, and answers come back bit-identical to the healthy index)
    sync()
    t0 = time.perf_counter()
    index2, labs2, _ = ft.elastic_reshard_index(1, train["points"], train["labels"], cfg, index, [2])
    sync()
    restore_s = time.perf_counter() - t0
    res = index2.query(qx[200:])
    comps = res.max_comparisons_per_cell.cpu().numpy()
    mcc3 = mcc_of(res, labs2, qy[200:])
    print(f"phase 3 (node 2 restored on nu={index2.deploy.nu}): MCC="
          f"{mcc3:.3f}  "
          f"median comps/proc={float(np.median(comps)):.0f}")
    print("pipeline complete: detection -> degraded service -> elastic recovery")
    return dict(n=int(pts.shape[0]), mcc=(mcc1, mcc2, mcc3), median_comparisons=float(np.median(comps)),
                restore_s=restore_s, comparisons=res.comparisons)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' to run without the card")
    args = ap.parse_args()
    cfg_abp = abp.ABPConfig(n_beats=60_000, episode_rate=1.0 / 2500.0)
    main(*abp.synth_dataset_beats(0, 8, cfg_abp), device=args.device)
