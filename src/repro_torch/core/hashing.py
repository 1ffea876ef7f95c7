"""LSH hash families (paper §2), in PyTorch.

Counterpart of ``repro.core.hashing``. Two (r, cr, p1, p2)-sensitive families:

* Bit-sampling for the l1 norm: bit ``j`` of table ``t`` is the predicate
  ``x[dims[t, j]] > thrs[t, j]``.
* Sign random projection for cosine similarity: ``bit_j = (x . r_j) >= 0``.

A table's m-bit signature packs into ``ceil(m/32)`` 32-bit words, mixed into
one 32-bit bucket key (FNV-1a over the words' bytes, salted by table).

Words and keys are carried as **int64 holding values in [0, 2**32)**: CPU
torch has no shift or ``searchsorted`` on ``uint32``. Every FNV multiply is
masked back to 32 bits, so the keys equal the JAX package's ``uint32`` keys
value for value, and ``tables.PAD_KEY = 0xFFFFFFFF`` still sorts last.

Two deliberate divergences from the JAX package's Pallas backend, neither of
which changes a result on the test or smoke data:

* The sign-projection bit is ``s >= 0`` everywhere in the port, as the
  family defines it (``repro.core.hashing.signature_bits``), in the plain
  version and in the CUDA kernel alike. The Pallas kernel computes
  ``s > 0``. The two differ only where ``s`` is exactly 0, which gaussian
  projections of real-valued windows do not produce; the tests assert
  ``min |s|`` well above float32 rounding on their data.
* The port's ``pipeline.build_inner`` hashes heavy-bucket points through
  the backend (the ``proj_sign_pack`` kernel on the card), where the JAX
  package always uses :func:`hash_points`; see ``core/tables.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as device_mod

FNV_PRIME = 16777619
FNV_BASIS = 2166136261
MASK32 = 0xFFFFFFFF


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack boolean bits (..., m) into (..., ceil(m/32)) int64 words."""
    m = bits.shape[-1]
    n_words = (m + 31) // 32
    pad = n_words * 32 - m
    if pad:
        bits = torch.cat(
            [bits, bits.new_zeros(bits.shape[:-1] + (pad,))], dim=-1
        )
    b = bits.reshape(bits.shape[:-1] + (n_words, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (b << shifts).sum(dim=-1)


def mix32(words: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """FNV-1a mix of 32-bit words (..., W) + per-table salt -> (...,) keys."""
    h = torch.bitwise_xor(salt.to(torch.int64), FNV_BASIS)
    for w in range(words.shape[-1]):
        word = words[..., w]
        for shift in (0, 8, 16, 24):
            byte = (word >> shift) & 0xFF
            h = ((h ^ byte) * FNV_PRIME) & MASK32
    return h


class BitSampleParams(NamedTuple):
    """l1 bit-sampling family: L tables x m bits, bit = x[dim] > thr."""

    dims: torch.Tensor  # (L, m) int32 in [0, d)
    thrs: torch.Tensor  # (L, m) float32
    salts: torch.Tensor  # (L,) int64 in [0, 2**31)


class SignRPParams(NamedTuple):
    """Cosine sign-random-projection family: L tables x m projections."""

    proj: torch.Tensor  # (L, d, m) float32
    salts: torch.Tensor  # (L,) int64 in [0, 2**31)


HashParams = BitSampleParams | SignRPParams


def make_bitsample(
    gen: torch.Generator, L: int, m: int, d: int, lo: float, hi: float,
    device: torch.device | str | None = None,
) -> BitSampleParams:
    """Sample an l1 bit-sampling family from ``gen`` (drawn on the CPU, then
    moved, so a seed gives the same family on every device) onto ``device``
    (the card unless told otherwise, see :func:`repro_torch.device.resolve`)."""
    device = device_mod.resolve(device)
    dims = torch.randint(0, d, (L, m), generator=gen, dtype=torch.int32)
    thrs = lo + (hi - lo) * torch.rand((L, m), generator=gen, dtype=torch.float32)
    salts = torch.randint(0, 2**31 - 1, (L,), generator=gen, dtype=torch.int64)
    return BitSampleParams(dims.to(device), thrs.to(device), salts.to(device))


def make_signrp(
    gen: torch.Generator, L: int, m: int, d: int,
    device: torch.device | str | None = None,
) -> SignRPParams:
    """Sample a cosine sign-random-projection family: L tables, m gaussian
    projections each (``bit_j = (x . proj[:, j]) >= 0``), on ``device``."""
    device = device_mod.resolve(device)
    proj = torch.randn((L, d, m), generator=gen, dtype=torch.float32)
    salts = torch.randint(0, 2**31 - 1, (L,), generator=gen, dtype=torch.int64)
    return SignRPParams(proj.to(device), salts.to(device))


def signature_bits(params: HashParams, x: torch.Tensor) -> torch.Tensor:
    """x: (n, d) -> bits (n, L, m) bool."""
    if isinstance(params, BitSampleParams):
        gathered = x[:, params.dims.long()]  # (n, L, m)
        return gathered > params.thrs[None]
    proj = torch.einsum("nd,ldm->nlm", x, params.proj)
    return proj >= 0.0


def hash_points(params: HashParams, x: torch.Tensor) -> torch.Tensor:
    """x: (n, d) -> bucket keys (L, n) int64."""
    words = pack_bits(signature_bits(params, x))  # (n, L, W)
    return mix32(words, params.salts[None, :]).T


def hash_points_chunked(
    params: HashParams, x: torch.Tensor, chunk: int = 4096
) -> torch.Tensor:
    """Memory-bounded hashing over point chunks. x (n, d) -> (L, n)."""
    return torch.cat(
        [hash_points(params, x[lo : lo + chunk]) for lo in range(0, x.shape[0], chunk)],
        dim=1,
    )


def _smallest_positions(margins: torch.Tensor, n_probes: int) -> torch.Tensor:
    """Positions of the ``n_probes`` smallest margins along the last axis,
    ties to the lowest position (``lax.top_k(-margins)``'s rule)."""
    return torch.sort(margins, dim=-1, stable=True).indices[..., :n_probes]


def probe_keys_from_margins(
    params: BitSampleParams,
    words: torch.Tensor,
    margins: torch.Tensor,
    n_probes: int,
) -> torch.Tensor:
    """Batched multiprobe keys from signature words + quantizer margins.

    ``words`` (n, L, W) and ``margins`` (n, L, m) -> (n, L, 1 + n_probes)
    keys: the base bucket key first, then the keys obtained by flipping the
    ``n_probes`` lowest-margin bits (margin = |x[dim] - thr|).
    """
    base = mix32(words, params.salts[None, :])  # (n, L)
    if n_probes == 0:
        return base[..., None]
    flip_idx = _smallest_positions(margins, n_probes)  # (n, L, n_probes)
    w_idx = flip_idx // 32
    b_idx = flip_idx % 32
    n_words = words.shape[-1]
    onehot = torch.nn.functional.one_hot(w_idx, n_words) * (
        torch.ones_like(b_idx) << b_idx
    )[..., None]  # (n, L, n_probes, W)
    probed = words[:, :, None, :] ^ onehot
    keys = mix32(probed, params.salts[None, :, None])  # (n, L, n_probes)
    return torch.cat([base[..., None], keys], dim=-1)


def probe_keys_from_words(
    params: BitSampleParams, x: torch.Tensor, words: torch.Tensor, n_probes: int
) -> torch.Tensor:
    """Multiprobe keys from precomputed words, recomputing the margins from
    ``x`` (n, d) — the plain formulation."""
    if n_probes == 0:
        return probe_keys_from_margins(params, words, words[..., :0], 0)
    margins = (x[:, params.dims.long()] - params.thrs[None]).abs()  # (n, L, m)
    return probe_keys_from_margins(params, words, margins, n_probes)


def probe_keys_bitsample(params: BitSampleParams, x: torch.Tensor, n_probes: int) -> torch.Tensor:
    """Multiprobe keys for one query x (d,) -> (L, 1 + n_probes) keys."""
    words = pack_bits(signature_bits(params, x[None, :]))  # (1, L, W)
    return probe_keys_from_words(params, x[None, :], words, n_probes)[0]
