"""Compressed candidate payloads for the fused query tail (DESIGN.md §13).

Counterpart of ``repro.runtime.payload``. The fused tail's dominant
device-memory traffic is the candidate-row gather: ``c_comp`` rows of ``d``
f32 per query. An opt-in payload (``RuntimeConfig.payload``) quantizes the
dataset once at build time — ``"f16"`` halves the gathered bytes, ``"i8"``
quarters them with one f32 scale per row — and the tail runs its L1 pass on
the compressed rows to select a ``c_rerank`` shortlist, then reranks the
shortlist exactly in f32. Beside each row's dequantization scale sits its
L1 quantization error ``qerr = sum_j |x_j - deq_j|``, which bounds the
approximation: ``|L1(q, x) - L1(q, deq(x))| <= qerr``. A candidate left out
of the shortlist whose approximate distance comes within ``qerr`` of the
k-th exact distance is a rerank-margin miss, counted in
``QueryResult.rerank_misses``; a zero count certifies the answer identical
to the f32 tail's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PAYLOAD_FORMATS = ("f32", "f16", "i8")

# f32 columns per meta row: [dequant scale, L1 quantization error bound]
_META_COLS = 2


class Payload(NamedTuple):
    """A quantized copy of the dataset read by the payload query tail.

    ``qdata`` holds the compressed rows (float16 or int8); ``meta`` carries
    two f32 columns per row — the dequantization scale (1.0 for f16) and the
    L1 error bound of the row's reconstruction. One formula dequantizes
    every format: ``deq = qdata.float() * scale``.
    """

    qdata: torch.Tensor  # (n, d) float16 | int8 quantized rows
    meta: torch.Tensor  # (n, 2) float32 — [:, 0] scale, [:, 1] L1 error bound

    @property
    def nbytes(self) -> int:
        """Bytes this payload holds resident."""
        return sum(t.numel() * t.element_size() for t in self)


def make_payload(data: torch.Tensor, fmt: str) -> Payload:
    """Quantize ``data`` (n, d) into a :class:`Payload` on its device.

    ``"f16"`` rounds each element to float16 (scale 1.0); ``"i8"`` uses a
    symmetric per-row scale ``amax · (1/127)``, rounds half to even and
    clips to ±127. Both record the per-row L1 reconstruction error in ``meta[:, 1]``.

    >>> p = make_payload(torch.ones((4, 8)), "i8")
    >>> p.qdata.dtype, tuple(p.meta.shape)
    (torch.int8, (4, 2))
    """
    data = data.to(torch.float32)
    if fmt == "f16":
        q = data.to(torch.float16)
        scale = torch.ones(data.shape[0], dtype=torch.float32, device=data.device)
        deq = q.to(torch.float32)
    elif fmt == "i8":
        amax = data.abs().amax(dim=1)
        # amax times the float32 reciprocal of 127: the JAX package's
        # ``amax / 127`` as XLA compiles it, so the scales agree bit for bit
        scale = amax.clamp(min=1e-30) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
        q = torch.round(data / scale[:, None]).clamp(-127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale[:, None]
    else:
        raise ValueError(
            f"unknown payload format {fmt!r}; expected one of"
            f" {PAYLOAD_FORMATS[1:]} (f32 runs the uncompressed tail)"
        )
    qerr = (data - deq).abs().sum(dim=1)
    return Payload(q.contiguous(), torch.stack([scale, qerr], dim=1).contiguous())


def payload_itemsize(fmt: str) -> int:
    """Bytes per element of a payload format's quantized rows."""
    return {"f32": 4, "f16": 2, "i8": 1}[fmt]


def tail_gather_bytes(c_comp: int, c_rerank: int, d: int, fmt: str) -> int:
    """Per-query candidate bytes the fused tail gathers from device memory.

    The f32 tail reads ``c_comp`` full rows; a payload tail reads ``c_comp``
    quantized rows plus their meta columns, then only the ``c_rerank``
    shortlisted rows in f32 for the exact rerank.

    >>> tail_gather_bytes(1024, 128, 30, "f32")
    122880
    >>> tail_gather_bytes(1024, 128, 30, "i8")
    54272
    """
    if fmt == "f32":
        return c_comp * d * 4
    approx = c_comp * (d * payload_itemsize(fmt) + _META_COLS * 4)
    return approx + min(c_rerank, c_comp) * d * 4
