"""Time the LM mesh's collectives (``repro_torch.sharding.ctx``) among 4
gloo ranks on one device.

    python3 scripts/gloo_collectives.py [--device cpu|cuda]

Each rank (``launch.mesh.spawn``, a ``make_local_mesh(1, 4)``) times, in
milliseconds a call after one warm call:

* ``psum_16MB/gather`` and ``psum_16MB/scatter``: ``ctx.psum`` of a
  (2, 512, 4096) float32 tensor (granite-8b's row-parallel output in a
  prefill of 2 x 512 tokens) as one all-gather of the whole and as a
  reduce-scatter of blocks and an all-gather of the sums
  (``ctx.SCATTER_SUM_BYTES`` forces each form; the two give the same bits,
  checked here);
* ``gather_100MB/flat`` and ``gather_100MB/list``: the all-gather of a
  (12288, 4096) bf16 block (a rank's quarter of granite-8b's embedding)
  into one buffer (``ctx.all_gather_tiled``) and as ``dist.all_gather``
  into a list of parts joined after;
* ``small_gather``: ``ctx.all_gather_tiled`` of a (2, 1, 8, 128) tensor (a
  decode step's heads), the collective's fixed cost;
* on a card, each again with the device tensor copied to pageable host
  memory (``/pageable``), where ``ctx._wire`` copies it to pinned memory.

Prints the device (and on a card its name and power limit) and one line
per reading: the slowest rank's milliseconds.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def _pageable_wire(t):
    """``ctx._wire`` with the host copy in pageable memory."""
    from repro_torch.sharding import ctx

    t = t.contiguous()
    if t.device.type != "cpu":
        ctx.TRAFFIC["host_copy_bytes"] += t.nbytes
        t = t.cpu()
    return t


def rank(device: str) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import ctx

    mesh = mesh_mod.make_local_mesh(1, 4, device=device)
    dev = mesh.device
    gen = torch.Generator(dev).manual_seed(mesh.rank)
    part = torch.randn((2, 512, 4096), generator=gen, device=dev)
    block = torch.randn((12288, 4096), generator=gen, device=dev).to(torch.bfloat16)
    heads = torch.randn((2, 1, 8, 128), generator=gen, device=dev)

    def psum(limit):
        def run():
            saved = ctx.SCATTER_SUM_BYTES
            ctx.SCATTER_SUM_BYTES = limit
            try:
                return ctx.psum(mesh, "model", part)
            finally:
                ctx.SCATTER_SUM_BYTES = saved
        return run

    def gather_list():
        src = block.contiguous().view(torch.uint8).cpu()
        parts = [torch.empty_like(src) for _ in range(4)]
        dist.all_gather(parts, src, group=mesh.groups["model"])
        return torch.cat(parts).to(dev)

    cases = {
        "psum_16MB/gather": (psum(1 << 62), 10),
        "psum_16MB/scatter": (psum(0), 10),
        "gather_100MB/flat": (lambda: ctx.all_gather_tiled(mesh, "model", block, 0), 3),
        "gather_100MB/list": (gather_list, 3),
        "small_gather": (lambda: ctx.all_gather_tiled(mesh, "model", heads, 2), 100),
    }
    out = {"same_bits": bool(torch.equal(psum(1 << 62)(), psum(0)()))}
    wires = {"": ctx._wire} if dev.type == "cpu" else {"": ctx._wire, "/pageable": _pageable_wire}
    saved_wire = ctx._wire
    try:
        for suffix, wire in wires.items():
            ctx._wire = wire
            for name, (fn, reps) in cases.items():
                fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                out[name + suffix] = (time.perf_counter() - t0) / reps * 1e3
    finally:
        ctx._wire = saved_wire
    return out


def main() -> None:
    import tempfile

    import gloo_collectives
    from repro_torch.launch import mesh as mesh_mod

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    args = ap.parse_args()
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as store:
        reports = mesh_mod.spawn(gloo_collectives.rank, 4, store_dir=store, args=(args.device,), timeout_s=600)
    print("device", args.device, "same_bits", all(r["same_bits"] for r in reports), flush=True)
    for name in reports[0]:
        if name != "same_bits":
            print(f"{name} {max(r[name] for r in reports):.2f} ms", flush=True)


if __name__ == "__main__":
    main()
