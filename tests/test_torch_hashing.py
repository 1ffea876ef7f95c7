"""Hashing, CSR tables, heavy buckets, the merge ladder and top-k of the
PyTorch port equal the JAX package's exactly on the same inputs.

Inputs come from numpy with fixed seeds and hash parameters from the JAX
``make_bitsample``/``make_signrp`` as numpy arrays; uint32 values compare
as int64.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.core import merge as jm
from repro.core import tables as jt
from repro.core import topk as jk
from repro_torch import params as tparams
from repro_torch.core import hashing as th
from repro_torch.core import merge as tm
from repro_torch.core import tables as tt
from repro_torch.core import topk as tk

D = 30


def _np(a) -> np.ndarray:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(_np(torch_out), _np(jax_out))


def _data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    return (20.0 + 160.0 * rng.random((n, D))).astype(np.float32)


def _family(L=6, m=20, L_in=4, m_in=12, key=1):
    ko, ki = jax.random.split(jax.random.PRNGKey(key))
    outer = jh.make_bitsample(ko, L, m, D, 20.0, 180.0)
    inner = jh.make_signrp(ki, L_in, m_in, D)
    return (outer, inner), tparams.from_jax_params(outer, inner, "cpu")


@pytest.mark.parametrize("m", [12, 32, 45])
def test_pack_bits(m):
    bits = np.random.default_rng(m).random((7, 3, m)) < 0.5
    _eq(jh.pack_bits(jnp.asarray(bits)), th.pack_bits(torch.as_tensor(bits)))


def test_mix32():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (50, 6, 2), dtype=np.uint64).astype(np.uint32)
    salts = rng.integers(0, 2**31 - 1, (6,)).astype(np.uint32)
    _eq(
        jh.mix32(jnp.asarray(words), jnp.asarray(salts)[None, :]),
        th.mix32(torch.as_tensor(words.astype(np.int64)), torch.as_tensor(salts.astype(np.int64))[None, :]),
    )


@pytest.mark.parametrize("family", ["bitsample", "signrp"])
def test_hash_points(family):
    x = _data()
    (jo, ji), (to, ti) = _family()
    jp_, tp_ = (jo, to) if family == "bitsample" else (ji, ti)
    if family == "signrp":
        # exact equality needs every projection far from the sign boundary
        s = np.einsum("nd,ldm->nlm", x.astype(np.float64), np.asarray(ji.proj, np.float64))
        assert np.abs(s).min() > 1e-3
    _eq(jh.hash_points(jp_, jnp.asarray(x)), th.hash_points(tp_, torch.as_tensor(x)))
    _eq(
        jh.hash_points_chunked(jp_, jnp.asarray(x), chunk=100),
        th.hash_points_chunked(tp_, torch.as_tensor(x), chunk=100),
    )


@pytest.mark.parametrize("n_probes", [0, 2])
def test_probe_keys(n_probes):
    x = _data(64, seed=3)
    (jo, _), (to, _) = _family()
    jw = jh.pack_bits(jh.signature_bits(jo, jnp.asarray(x)))
    tw = th.pack_bits(th.signature_bits(to, torch.as_tensor(x)))
    _eq(jw, tw)
    _eq(
        jh.probe_keys_from_words(jo, jnp.asarray(x), jw, n_probes),
        th.probe_keys_from_words(to, torch.as_tensor(x), tw, n_probes),
    )


def test_probe_keys_from_margins_ties_go_to_lowest_bit():
    (jo, _), (to, _) = _family(L=2, m=8)
    words = np.random.default_rng(4).integers(0, 256, (5, 2, 1)).astype(np.uint32)
    margins = np.tile(np.array([3, 1, 1, 2, 1, 5, 1, 4], np.float32), (5, 2, 1))
    _eq(
        jh.probe_keys_from_margins(jo, jnp.asarray(words), jnp.asarray(margins), 3),
        th.probe_keys_from_margins(
            to, torch.as_tensor(words.astype(np.int64)), torch.as_tensor(margins), 3
        ),
    )


def _skewed_keys(L=4, n=600, seed=5):
    """Keys with heavy buckets, ties and a PAD tail segment."""
    rng = np.random.default_rng(seed)
    keys = rng.choice([7, 9, 11, 2**32 - 2, 13, 400, 401], size=(L, n), p=[0.3, 0.2, 0.15, 0.1, 0.1, 0.1, 0.05])
    keys = np.concatenate([keys, rng.integers(0, 2**32 - 1, (L, 200))], axis=1)
    keys[:, -50:] = 0xFFFFFFFF  # capacity padding must never be heavy
    return keys.astype(np.uint32)


def test_build_tables_stable_on_ties():
    keys = _skewed_keys()
    jts = jt.build_tables(jnp.asarray(keys))
    tts = tt.build_tables(torch.as_tensor(keys.astype(np.int64)))
    _eq(jts.sorted_keys, tts.sorted_keys)
    _eq(jts.sorted_idx, tts.sorted_idx)
    assert tts.sorted_idx.dtype == torch.int32


@pytest.mark.parametrize("h_max", [2, 8])
@pytest.mark.parametrize("streamed", [False, True])
def test_find_heavy(h_max, streamed):
    keys = _skewed_keys()
    jts = jt.build_tables(jnp.asarray(keys))
    tts = tt.build_tables(torch.as_tensor(keys.astype(np.int64)))
    jfn = jt.find_heavy_streamed if streamed else jt.find_heavy
    tfn = tt.find_heavy_streamed if streamed else tt.find_heavy
    jhv = jfn(jts, jnp.int32(40), h_max)
    thv = tfn(tts, 40, h_max)
    for name in jhv._fields:
        _eq(getattr(jhv, name), getattr(thv, name))
    assert bool(thv.valid.any())
    if h_max == 2:
        assert int(thv.overflowed.max()) > 0  # more heavy buckets than slots


def test_find_heavy_keeps_the_reference_preconditions():
    ts = tt.build_tables(torch.arange(3, dtype=torch.int64)[None])
    with pytest.raises(ValueError, match="h_max"):
        tt.find_heavy(ts, 1, 4)


def test_bucket_range_and_gather():
    keys = _skewed_keys(L=1)[0]
    jts = jt.build_tables(jnp.asarray(keys[None]))
    tts = tt.build_tables(torch.as_tensor(keys[None].astype(np.int64)))
    for key in (7, 9, 13, 12345):
        jlo, jhi = jt.bucket_range(jts.sorted_keys[0], jnp.uint32(key))
        tlo, thi = tt.bucket_range(tts.sorted_keys[0], torch.tensor(key))
        _eq(jlo, tlo)
        _eq(jhi, thi)
        _eq(
            jt.gather_bucket(jts.sorted_idx[0], jlo, jhi, 64),
            tt.gather_bucket(tts.sorted_idx[0], tlo, thi, 64),
        )


def test_merge_ladder_equals_one_stable_sort():
    keys = _skewed_keys(L=3, seed=8)
    n = keys.shape[1]
    chunk = 96
    jstack, tstack = [], []
    for lo in range(0, n, chunk):
        kc = keys[:, lo : lo + chunk]
        ic = np.broadcast_to(np.arange(lo, lo + kc.shape[1], dtype=np.int32), kc.shape)
        jrun = tuple(jax.vmap(lambda k, i: jax.lax.sort((k, i), num_keys=1))(jnp.asarray(kc), jnp.asarray(ic)))
        trun = tt.sort_rows(torch.as_tensor(kc.astype(np.int64)), torch.as_tensor(ic.copy()))
        jm.ladder_push(jstack, jrun)
        tm.ladder_push(tstack, trun)
    assert [s[0].shape[-1] for s in jstack] == [s[0].shape[-1] for s in tstack]
    jk_, ji_ = jm.ladder_collapse(jstack)
    tk_, ti_ = tm.ladder_collapse(tstack)
    _eq(jk_, tk_)
    _eq(ji_, ti_)
    full = tt.build_tables(torch.as_tensor(keys.astype(np.int64)))
    _eq(full.sorted_keys, tk_)
    _eq(full.sorted_idx, ti_)


def test_merge_sorted_rows_left_wins_ties():
    ak, ai = np.array([1, 3, 3, 8], np.uint32), np.array([0, 1, 2, 3], np.int32)
    bk, bi = np.array([3, 3, 4, 8, 9], np.uint32), np.array([4, 5, 6, 7, 8], np.int32)
    jout = jm.merge_sorted_rows(*map(jnp.asarray, (ak, ai, bk, bi)))
    tout = tm.merge_sorted_rows(
        torch.as_tensor(ak.astype(np.int64)), torch.as_tensor(ai),
        torch.as_tensor(bk.astype(np.int64)), torch.as_tensor(bi),
    )
    _eq(jout[0], tout[0])
    _eq(jout[1], tout[1])


def _tie_dists(c=40, seed=9):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 6, c).astype(np.float32)  # many exact ties
    d[rng.random(c) < 0.3] = np.inf
    idx = np.where(np.isfinite(d), rng.integers(0, 20, c), -1).astype(np.int32)
    return d, idx


@pytest.mark.parametrize("k", [3, 10, 50])
def test_topk_smallest_tie_rule(k):
    d, idx = _tie_dists()
    for jfn, tfn in (
        (jk.masked_topk_smallest, tk.masked_topk_smallest),
        (jk.masked_unique_topk_smallest, tk.masked_unique_topk_smallest),
    ):
        jd, ji = jfn(jnp.asarray(d), jnp.asarray(idx), k)
        td, ti = tfn(torch.as_tensor(d), torch.as_tensor(idx), k)
        _eq(jd, td)
        _eq(ji, ti)
    jd, ji = jk.merge_topk(*map(jnp.asarray, (d[:20], idx[:20], d[20:], idx[20:])), k)
    td, ti = tk.merge_topk(*map(torch.as_tensor, (d[:20], idx[:20], d[20:], idx[20:])), k)
    _eq(jd, td)
    _eq(ji, ti)


def test_masked_l1_topk_batch_and_l1_distances():
    rng = np.random.default_rng(10)
    q = rng.integers(0, 4, (6, 5)).astype(np.float32)
    cands = rng.integers(0, 4, (6, 30, 5)).astype(np.float32)  # tied distances
    mask = rng.random((6, 30)) < 0.7
    jd, jp = jk.masked_l1_topk_batch(*map(jnp.asarray, (q, cands, mask)), 8)
    td, tp = tk.masked_l1_topk_batch(*map(torch.as_tensor, (q, cands, mask)), 8)
    _eq(jd, td)
    _eq(jp, tp)
    _eq(jk.l1_distances(jnp.asarray(q[0]), jnp.asarray(cands[0])),
        tk.l1_distances(torch.as_tensor(q[0]), torch.as_tensor(cands[0])))
