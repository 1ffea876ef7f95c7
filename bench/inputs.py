"""Inputs made from ``--seed``: synthetic AHE windows and the DSLSH hash family.

The window generator is a frozen copy of the statistical shape of
``repro_torch.data.windows.SyntheticWindowSpec`` (the port's block-seeded
numpy generator), drawn on the device with a ``torch.Generator`` in a few
large calls so that set-up stays short: a per-window patient baseline
uniform in ``[baseline_lo, baseline_hi]`` mmHg plus N(0, noise_mmhg) per
subwindow, and a ``dip_frac`` minority whose mean arterial pressure ramps
down by ``U[dip_lo, dip_hi]`` mmHg along a quadratic ramp toward the
window's tail, clipped to ``[clip_lo, clip_hi]``. A window is labelled AHE
when its last subwindow sits below 60 mmHg.

The hash family is the paper's two layers (§2): ``L_out`` tables of
``m_out`` sampled coordinates with thresholds uniform in ``[val_lo,
val_hi)`` (the outer l1 bit sampling) and ``L_in`` tables of ``m_in``
gaussian projections (the inner cosine layer), each table with a salt in
``[0, 2**31 - 1)``. Both the program and the reference are handed these
same tensors.

Every draw takes its own generator, seeded from ``(seed, purpose)``, so the
same seed gives the same inputs and one purpose never shifts another's.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

AHE_THRESHOLD_MMHG = 60.0


def generator(seed: int, purpose: str, device: torch.device | str) -> torch.Generator:
    """A generator on ``device`` seeded from the run's seed and a purpose."""
    words = np.random.SeedSequence([int(seed) % 2**64, zlib.crc32(purpose.encode())]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


def windows(spec: dict, n: int, gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` synthetic windows ``(n, d)`` float32 and their labels ``(n,)`` int8,
    on the generator's device."""
    dev = gen.device
    d = int(spec["d"])

    def uniform(lo: float, hi: float, shape) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    baseline = uniform(spec["baseline_lo"], spec["baseline_hi"], (n, 1))
    noise = torch.randn((n, d), generator=gen, device=dev) * spec["noise_mmhg"]
    dip = torch.rand((n,), generator=gen, device=dev) < spec["dip_frac"]
    depth = uniform(spec["dip_lo"], spec["dip_hi"], (n,))
    ramp = torch.linspace(0.0, 1.0, d, device=dev) ** 2
    pts = baseline + noise - (dip * depth)[:, None] * ramp[None, :]
    pts = pts.clamp(spec["clip_lo"], spec["clip_hi"]).to(torch.float32).contiguous()
    labels = (pts[:, -1] < AHE_THRESHOLD_MMHG).to(torch.int8)
    return pts, labels


def family(slsh: dict, d: int, gen: torch.Generator) -> tuple[dict, dict]:
    """The root hash family ``({dims, thrs, salts}, {proj, salts})``."""
    dev = gen.device
    l_out, m_out, l_in, m_in = slsh["L_out"], slsh["m_out"], slsh["L_in"], slsh["m_in"]
    lo, hi = float(slsh["val_lo"]), float(slsh["val_hi"])
    outer = {
        "dims": torch.randint(0, d, (l_out, m_out), generator=gen, device=dev, dtype=torch.int32),
        "thrs": lo + (hi - lo) * torch.rand((l_out, m_out), generator=gen, device=dev),
        "salts": torch.randint(0, 2**31 - 1, (l_out,), generator=gen, device=dev, dtype=torch.int64),
    }
    inner = {
        "proj": torch.randn((l_in, d, m_in), generator=gen, device=dev),
        "salts": torch.randint(0, 2**31 - 1, (l_in,), generator=gen, device=dev, dtype=torch.int64),
    }
    return outer, inner


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A host generator seeded from the run's seed and a purpose."""
    return np.random.default_rng([int(seed) % 2**64, zlib.crc32(purpose.encode())])


def shuffled(values: np.ndarray, seed: int, purpose: str) -> np.ndarray:
    """``values`` in an order drawn from the seed (a fixed multiset, so a
    seed changes the order of the work and never its amount)."""
    return rng(seed, purpose).permutation(values)


class LiveWindows:
    """Windows drawn from the seed as they are asked for, ``block`` at a
    time, block ``b`` from its own generator: a stream with no end, the same
    for the same seed however far it is read."""

    def __init__(self, spec: dict, seed: int, block: int, device: torch.device | str, purpose: str = "live"):
        self.spec, self.seed, self.block, self.device, self.purpose = spec, int(seed), int(block), device, purpose
        self.blocks: list[tuple] = []  # (windows, labels, labels on the host) of each block drawn

    def __call__(self, lo: int, hi: int) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """Windows ``lo:hi`` (within one block), their labels, and the labels on the host."""
        b = lo // self.block
        if (hi - 1) // self.block != b:
            raise ValueError(f"windows {lo}:{hi} span two blocks of {self.block}")
        while len(self.blocks) <= b:
            gen = generator(self.seed, f"{self.purpose}.{len(self.blocks)}", self.device)
            xs, ys = windows(self.spec, self.block, gen)
            self.blocks.append((xs, ys, ys.cpu().numpy()))
        lo, hi = lo - b * self.block, hi - b * self.block
        return tuple(t[lo:hi] for t in self.blocks[b])
