"""The LM families' activation layouts under a mesh, parent against change,
on the CPU: the same seeded smoke model served and differentiated by a
2 x 2 gloo world of each checkout, the logits, the loss and every gradient
block compared bit for bit.

Usage (both trees unpacked, for instance with ``git archive``)::

    python3 scripts/lm_mesh_layout_pairs.py build/parent . [--arch granite-8b]

Each tree runs in its own process (its ``src/`` first on the path), which
spawns 4 gloo ranks on the CPU through that tree's
``repro_torch.launch.mesh.spawn``: each rank serves its rows of 4 prompts
of 16 tokens (prefill, then 3 decode steps fed with fixed tokens) and
takes the step-0 loss and gradients of the masters
(``launch.lm_mesh_job.serve`` and ``step0_grads``, which both trees have).
Prints one line a compared quantity (bit-for-bit or the largest
difference) and a last JSON line with the counts.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

MESH = (2, 2)
PROMPT, DECODE = 16, 3


def rank(arch: str, prompts, feed, max_len: int) -> dict:
    """One rank: serving passes' logits, the loss and the gradient blocks."""
    from repro_torch.launch import lm_mesh_job as job
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import ctx

    mesh = mesh_mod.make_local_mesh(*MESH, device="cpu")
    with ctx.use_mesh(mesh):
        served = job.serve(mesh, arch, smoke=True, prompts=prompts, max_len=max_len, decode=DECODE, feed=feed)
        _, names, grads, rep = job.step0_grads(mesh, arch, smoke=True, rows=prompts)
    out = {f"logits/{j}": p["logits"] for j, p in enumerate(served["passes"])}
    out["loss"] = np.asarray(rep["loss"])
    out.update({f"grad/{n}": job._np(g) for n, g in zip(names, grads)})
    return {"coords": mesh.coords, "arrays": out}


def run_tree(arch: str, out: str) -> None:
    """This process's tree: the world's reports saved to ``out`` (npz)."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod

    import lm_mesh_layout_pairs as me  # the ranks' function, importable by name

    vocab = configs.get(arch, smoke=True).vocab
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab, (4, PROMPT)).astype(np.int32)
    feed = rng.integers(0, vocab, (4, DECODE)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        reports = mesh_mod.spawn(me.rank, 4, store_dir=os.path.join(tmp, "store"),
                                 args=(arch, prompts, feed, PROMPT + DECODE + 1), timeout_s=300)
    np.savez(out, **{f"{'_'.join(map(str, r['coords']))}/{k}": v for r in reports for k, v in r["arrays"].items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--tree-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree_out:
        run_tree(args.arch, args.tree_out)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for which in ("parent", "change"):
            tree = os.path.abspath(getattr(args, which))
            path = os.path.join(tmp, f"{which}.npz")
            env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(tree, "src"), here]))
            subprocess.run([sys.executable, os.path.abspath(__file__), args.parent, args.change, "--arch", args.arch,
                            "--tree-out", path], env=env, check=True, cwd=tree)
            with np.load(path) as f:
                got[which] = dict(f)
    equal = differ = 0
    for k in sorted(got["parent"]):
        a, b = got["parent"][k], got["change"][k]
        same = a.shape == b.shape and np.array_equal(a, b)
        equal += same
        differ += not same
        err = "shape" if a.shape != b.shape else float(np.abs(a.astype(np.float64) - b).max())
        print(f"{k}: {'bit for bit' if same else f'differs, largest {err}'}")
    print(json.dumps({"arch": args.arch, "mesh": list(MESH), "equal": equal, "differ": differ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
