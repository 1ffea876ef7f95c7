"""The profiler reader: device busy time, idle gaps and top device operations
from ``torch.profiler``'s raw kineto events.

A frozen copy of ``chip_smoke.py``'s ``profile_query`` reading: only device
activity is traced for the numbers, and the raw event list is summed
directly (building ``key_averages()`` over half a million events took
minutes on the card's host). A second, shorter slice traced with the host's
activity names what the host was doing in each idle gap.
"""
from __future__ import annotations

import time
from collections.abc import Callable

import torch

def kernel_name(name: str) -> str:
    """A kernel's function name without its template arguments or signature."""
    return (name.split("(")[0].split("<")[0].split() or [""])[-1]


def _events(prof) -> list:
    return list(prof.profiler.kineto_results.events())


def _device_intervals(events) -> list[tuple[int, int, str]]:
    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in events if e.device_type() == cuda and e.duration_ns() > 0]
    return sorted(out)


def _merged(intervals: list[tuple[int, int, str]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b, _ in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def device_slice(fn: Callable[[], object]) -> dict:
    """Run ``fn()`` under the profiler with device activity only: the traced
    window's length, the time some device operation ran, the operations by
    name and the count of operations."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    iv = _device_intervals(_events(prof))
    busy = sum(b - a for a, b in _merged(iv)) / 1e9
    by_name: dict[str, list] = {}
    for a, b, name in iv:
        acc = by_name.setdefault(name, [0, 0])
        acc[0] += b - a
        acc[1] += 1
    return {
        "window_s": window,
        "busy_s": busy,
        "n_ops": len(iv),
        "ops": {name: (ns / 1e9, calls) for name, (ns, calls) in by_name.items()},
    }


def kernel_seconds(summary: dict, kernel: str) -> tuple[float, int]:
    """Seconds and launches of one of the port's kernels in a device slice."""
    s, c = 0.0, 0
    for name, (sec, calls) in summary["ops"].items():
        if kernel_name(name) == kernel:
            s += sec
            c += calls
    return s, c


def short_name(name: str) -> str:
    """A device operation's name without the namespaces that every PyTorch
    kernel's name repeats, cut to 120 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::", "std::"):
        name = name.replace(noise, "")
    return name[:120]


def top_ops(summary: dict, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time, ``[name, seconds]``."""
    items = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:n]
    return [[short_name(name), sec] for name, (sec, _) in items]


def idle_gaps(fn: Callable[[], object], n: int = 10) -> list[list]:
    """Run ``fn()`` traced with host and device activity; every gap between
    device operations is put down to the innermost host operation running at
    its middle (``(no host operation)`` where none is), and the ``n`` host
    operations with the most gap time come back as ``[name, seconds]``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = _events(prof)
    cpu = torch.autograd.DeviceType.CPU
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events if e.device_type() == cpu and e.duration_ns() > 0)
    busy = _merged(_device_intervals(events))
    totals: dict[str, int] = {}
    j = 0
    active: list[tuple[int, int, str]] = []
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] > mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active else "(no host operation)"
        totals[name] = totals.get(name, 0) + (b - a)
    items = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in items]


def idle_percent(summary: dict | None) -> float | None:
    """The share of a device slice's window in which no device operation ran."""
    if summary is None or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
