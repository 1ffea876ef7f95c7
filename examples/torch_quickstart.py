"""Quickstart on the PyTorch/CUDA port: build a distributed SLSH index over
synthetic ABP windows and predict Acute Hypotensive Episodes — the twin of
``examples/quickstart.py``, printing the same lines.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given. The beats come
from the port's own generator (``repro_torch.data.abp``), which draws other
numbers than the JAX package's from the same seed; :func:`main` takes the
beats as arguments, so the JAX package's beats can be fed to it instead.
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

FAMILY = dslsh.FamilyConfig(m_out=24, L_out=16, m_in=12, L_in=4, alpha=0.01, val_lo=20.0, val_hi=180.0)
BUDGET = dslsh.BudgetConfig(k=10, c_max=128, c_in=32, h_max=8, p_max=256)


def main(mapv: np.ndarray, valid: np.ndarray, *, params=None, device=None, backend: str = "cuda") -> dict:
    """The quickstart on ``(records, beats)`` MAP values and validity masks.

    ``params`` supplies the root hash family (for instance the JAX
    package's ``make_family(PRNGKey(1), ...)`` as numpy arrays); without it
    the family is drawn from seed 1. Returns the printed numbers, plus the
    build and query seconds (the device synchronized).
    """
    dev = device_mod.resolve(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # 1. The rolling-window dataset.
    ds = windows.build_dataset(np.asarray(mapv), np.asarray(valid), windows.AHE_51_5C)
    train, qx, qy = windows.train_test_split(ds, n_test=200)
    print(f"dataset: {ds['name']}  n={train['points'].shape[0]}  "
          f"%no-AHE={ds['pct_no_ahe']:.1f}")

    # 2. DSLSH on nu=2 nodes x p=8 cores, stratified (l1 outer + cosine inner).
    deploy = dslsh.grid(nu=2, p=8)
    cfg = dslsh.make_config(FAMILY, BUDGET, backend=backend)
    pts, labs, _ = dslsh.pad_to_multiple(train["points"], train["labels"], deploy.cells)

    # 3. Build (the Root broadcasts one hash family; each cell owns L/p tables).
    sync()
    t0 = time.perf_counter()
    index = dslsh.build(1, pts, cfg, deploy, dev, params=params)
    sync()
    build_s = time.perf_counter() - t0

    # 4. Query -> one typed DistributedQueryResult, then the weighted K-NN vote.
    t0 = time.perf_counter()
    res = index.query(qx)
    sync()
    query_s = time.perf_counter() - t0
    labs_t = torch.as_tensor(labs, device=dev)
    qy_t = torch.as_tensor(qy, device=dev)
    pred = predict.predict_batch(labs_t, res.knn_idx, res.knn_dist)
    mcc = float(predict.mcc(pred, qy_t))

    # 5. Against the exhaustive PKNN baseline.
    data = torch.as_tensor(pts, device=dev)
    pkd, pki, pcomps = dslsh.pknn_query(data, torch.as_tensor(qx, device=dev), 10, deploy.grid)
    mcc_p = float(predict.mcc(predict.predict_batch(labs_t, pki, pkd), qy_t))

    max_comps = float(np.median(res.max_comparisons_per_cell.cpu().numpy()))
    per_proc = int(pcomps[0, 0, 0])
    print(f"DSLSH:  MCC={mcc:.3f}  median max-comparisons/processor={max_comps:.0f}")
    print(f"PKNN:   MCC={mcc_p:.3f}  comparisons/processor={per_proc}")
    print(f"speedup in comparisons: {per_proc / max(max_comps, 1):.1f}x  "
          f"MCC loss: {mcc_p - mcc:+.3f}")
    return dict(
        n=int(train["points"].shape[0]), queries=int(qx.shape[0]), mcc=mcc, mcc_pknn=mcc_p,
        median_max_comparisons=max_comps, pknn_comparisons_per_processor=per_proc,
        speedup=per_proc / max(max_comps, 1), build_s=build_s, query_s=query_s,
        comparisons=res.comparisons, max_comparisons_per_cell=res.max_comparisons_per_cell,
        overflow_cells=res.overflow_cells,
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu' to run without the card")
    args = ap.parse_args()
    cfg_abp = abp.ABPConfig(n_beats=60_000, episode_rate=1.0 / 2500.0)
    main(*abp.synth_dataset_beats(0, 8, cfg_abp), device=args.device)
