"""Wrappers of the signature-packing kernels (``csrc/hash_pack.cu``).

``bitsample_pack`` (kernel A) replaces the JAX package's
``bitsample_gather_pallas`` / ``bitsample_gather_margins_pallas``;
``proj_sign_pack`` (kernel B) replaces ``hash_pack_pallas`` /
``hash_pack_margins_pallas`` (``repro/kernels/hash_pack/hash_pack.py``).
Each takes its plain version (``ref.py``) for a CPU tensor and launches its
kernel for a CUDA tensor. The family-level functions below lay a whole
family's tables out as one column axis, so one launch hashes a batch against
every table.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import _build
from repro_torch.kernels.blocking import pad_axis, round_up
from repro_torch.kernels.hash_pack import ref

_SIGNATURES = {
    "bitsample_pack_launch": [_build.PTR] * 3 + [_build.INT] * 3 + [_build.PTR] * 3,
    "proj_sign_pack_launch": [_build.PTR] * 3 + [_build.INT] * 5 + [_build.PTR] * 3,
}


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _check_common(x: torch.Tensor, cols: int, *others: torch.Tensor) -> None:
    _require(x.dim() == 2 and x.dtype == torch.float32 and x.is_contiguous(),
             "x must be a contiguous (T, d) float32 tensor")
    _require(all(t.device == x.device and t.is_contiguous() for t in others),
             "all inputs must be contiguous and on x's device")
    _require(cols % 32 == 0, f"column count {cols} must be a multiple of 32")


def _finish(words: torch.Tensor, mg: torch.Tensor | None):
    """Kernel B's int32 words widened to the callers' int64 (32 bits,
    zero-extended)."""
    words = words.to(torch.int64) & hashing.MASK32
    return (words, mg) if mg is not None else words


def bitsample_pack(
    x: torch.Tensor, dims: torch.Tensor, thrs: torch.Tensor, margins: bool = False
):
    """Kernel A: x (T, d) f32, dims (M,) int32 in [0, d), thrs (M,) f32 ->
    words (T, M/32) int64 [, margins (T, M) f32], in one launch (the kernel
    writes the int64 words itself)."""
    if x.device.type == "cpu":
        return ref.bitsample_pack_ref(x, dims, thrs, margins)
    cols = dims.shape[0]
    _check_common(x, cols, dims, thrs)
    _require(dims.dtype == torch.int32 and thrs.dtype == torch.float32
             and thrs.shape == dims.shape, "dims int32 and thrs float32, both (M,)")
    words = torch.empty((x.shape[0], cols // 32), dtype=torch.int64, device=x.device)
    mg = torch.empty((x.shape[0], cols), dtype=torch.float32, device=x.device) if margins else None
    lib = _build.library("hash_pack", _SIGNATURES)
    err = lib.bitsample_pack_launch(
        x.data_ptr(), dims.data_ptr(), thrs.data_ptr(), x.shape[0], x.shape[1],
        cols, words.data_ptr(), None if mg is None else mg.data_ptr(),
        _build.stream_ptr(x),
    )
    _build.check(lib, err, "bitsample_pack")
    if mg is None:
        return words
    _build.count_launch("bitsample_pack.margins")  # the multiprobe mode's launches, counted apart too
    return words, mg


def proj_sign_pack(
    x: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor, m: int, m_pad: int,
    margins: bool = False,
):
    """Kernel B: x (T, d) f32, proj (d, M) f32, bias (M,) f32 -> words
    (T, M/32) int64 with bit ``s >= 0 & col % m_pad < m`` [, |s| (T, M)]."""
    if x.device.type == "cpu":
        return ref.proj_sign_pack_ref(x, proj, bias, m, m_pad, margins)
    cols = proj.shape[1]
    _check_common(x, cols, proj, bias)
    _require(proj.dtype == torch.float32 and bias.dtype == torch.float32
             and proj.shape[0] == x.shape[1] and bias.shape == (cols,),
             "proj (d, M) and bias (M,) must be float32")
    _require(m_pad % 32 == 0 and cols % m_pad == 0 and 0 < m <= m_pad,
             f"bad column layout m={m}, m_pad={m_pad}, M={cols}")
    words = torch.empty((x.shape[0], cols // 32), dtype=torch.int32, device=x.device)
    mg = torch.empty((x.shape[0], cols), dtype=torch.float32, device=x.device) if margins else None
    lib = _build.library("hash_pack", _SIGNATURES)
    err = lib.proj_sign_pack_launch(
        x.data_ptr(), proj.data_ptr(), bias.data_ptr(), x.shape[0], x.shape[1],
        cols, m, m_pad, words.data_ptr(), None if mg is None else mg.data_ptr(),
        _build.stream_ptr(x),
    )
    _build.check(lib, err, "proj_sign_pack")
    return _finish(words, mg)


# ------------------------------------------------------ family-level layout


def bitsample_columns(params: hashing.BitSampleParams) -> tuple[torch.Tensor, torch.Tensor]:
    """A bit-sampling family as flat columns: dims (L*m_pad,) int32 (0 on
    padded columns) and thrs (L*m_pad,) f32 (+inf on padded columns)."""
    m_pad = round_up(params.dims.shape[1], 32)
    dims = pad_axis(params.dims.to(torch.int32), 1, m_pad)
    thrs = pad_axis(params.thrs.to(torch.float32), 1, m_pad, value=float("inf"))
    return dims.reshape(-1).contiguous(), thrs.reshape(-1).contiguous()


def _words3(words: torch.Tensor, n_tables: int) -> torch.Tensor:
    return words.reshape(words.shape[0], n_tables, -1)


def signature_words(params: hashing.HashParams, x: torch.Tensor) -> torch.Tensor:
    """Packed words for every table of a family: x (n, d) -> (n, L, W) int64,
    equal to ``hashing.pack_bits(hashing.signature_bits(params, x))``."""
    x = x.to(torch.float32).contiguous()
    if isinstance(params, hashing.BitSampleParams):
        dims, thrs = bitsample_columns(params)
        return _words3(bitsample_pack(x, dims, thrs), params.dims.shape[0])
    n_tab, d, m = params.proj.shape
    m_pad = round_up(m, 32)
    proj = pad_axis(params.proj.to(torch.float32), 2, m_pad)  # (L, d, m_pad)
    cols = proj.permute(1, 0, 2).reshape(d, n_tab * m_pad).contiguous()
    bias = torch.zeros(n_tab * m_pad, dtype=torch.float32, device=x.device)
    return _words3(proj_sign_pack(x, cols, bias, m, m_pad), n_tab)


def probe_words(
    params: hashing.BitSampleParams, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Words (n, L, W) and multiprobe margins (n, L, m) from one launch of
    kernel A; margins equal ``|x[:, dims] - thrs|`` exactly."""
    if not isinstance(params, hashing.BitSampleParams):
        raise TypeError(
            "probe_words needs BitSampleParams (the outer multiprobe family);"
            f" got {type(params).__name__}"
        )
    x = x.to(torch.float32).contiguous()
    n_tab, m = params.dims.shape
    dims, thrs = bitsample_columns(params)
    words, mg = bitsample_pack(x, dims, thrs, margins=True)
    return _words3(words, n_tab), mg.reshape(x.shape[0], n_tab, -1)[:, :, :m]


def onehot_pack_margins(
    x: torch.Tensor, dims: torch.Tensor, thrs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-sampling words + margins through kernel B: a one-hot projection
    with bias ``-thrs`` (``-inf`` on padded columns) gives ``s = x[dim] -
    thr`` exactly. x (T, d), dims/thrs (L, m) -> ((T, L, W), (T, L, m))."""
    x = x.to(torch.float32).contiguous()
    d = x.shape[1]
    n_tab, m = dims.shape
    m_pad = round_up(m, 32)
    onehot = torch.nn.functional.one_hot(dims.long(), d).to(torch.float32)  # (L, m, d)
    proj = pad_axis(onehot.permute(0, 2, 1), 2, m_pad)  # (L, d, m_pad)
    cols = proj.permute(1, 0, 2).reshape(d, n_tab * m_pad).contiguous()
    bias = pad_axis(-thrs.to(torch.float32), 1, m_pad, value=float("-inf"))
    words, mg = proj_sign_pack(x, cols, bias.reshape(-1).contiguous(), m, m_pad, margins=True)
    return _words3(words, n_tab), mg.reshape(x.shape[0], n_tab, -1)[:, :, :m]
