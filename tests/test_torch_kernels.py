"""Each kernel's plain version against the JAX function on the same inputs.

On the CPU every kernel wrapper takes its plain PyTorch version (the card
is needed to launch the CUDA kernels, and ``chip_smoke.py`` holds them to
these same plain versions there). The JAX side runs its Pallas kernels in
interpret mode, as the JAX package's own tests do on the CPU.

Integer outputs must be exact. Distances agree within rtol = atol = 1e-5,
since sums over d may run in another order. Indices are compared
tie-aware (``core.topk.topk_mismatch``): one may differ only at a real tie
of the reference's distances, and must then be a point at that distance.
Integer-valued data makes every distance exact, so there the tie rule
(lowest position wins) is held exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.kernels.hash_pack import ops as jhp
from repro.kernels.l1_topk import ops as jl1
from repro.kernels.l1_topk import ref as jl1_ref
from repro.kernels.query_fused import ops as jqf
from repro.kernels.query_fused import ref as jqf_ref
from repro_torch import params as tparams
from repro_torch.core import topk as ttopk
from repro_torch.kernels import _build
from repro_torch.kernels.hash_pack import ops as thp
from repro_torch.kernels.hash_pack import ref as thp_ref
from repro_torch.kernels.l1_topk import ops as tl1
from repro_torch.kernels.query_fused import ops as tqf

RTOL = ATOL = 1e-5
D = 30


def _np(a) -> np.ndarray:
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(_np(torch_out), _np(jax_out))


def _topk_close(jd, ji, td, ti, dist_of):
    """Distances within tolerance; indices equal except at real ties, where
    ``dist_of(rows, idx)`` must place the port's index at its distance."""
    jd, ji, td, ti = (torch.tensor(_np(a)) for a in (jd, ji, td, ti))
    why = ttopk.topk_mismatch(td, ti, jd, ji, dist_of, rtol=RTOL, atol=ATOL)
    assert why is None, why


def _l1_dist_of(q, cands):
    q, cands = torch.as_tensor(q), torch.as_tensor(cands)
    return lambda rows, pos: (cands[rows, pos.long()] - q[rows]).abs().sum(-1)


def _point_dist_of(data, queries):
    data, queries = torch.as_tensor(data), torch.as_tensor(queries)
    return lambda rows, idx: (data[idx.long()] - queries[rows]).abs().sum(-1)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    _build.reset_launches()
    yield
    assert _build.LAUNCHES == {}, "a kernel launched on the CPU"


def _x(n=200, seed=0):
    return (20.0 + 160.0 * np.random.default_rng(seed).random((n, D))).astype(np.float32)


def _families(L=5, m=20, m_in=12):
    ko, ki = jax.random.split(jax.random.PRNGKey(3))
    outer = jh.make_bitsample(ko, L, m, D, 20.0, 180.0)
    inner = jh.make_signrp(ki, 4, m_in, D)
    return (outer, inner), tparams.from_jax_params(outer, inner, "cpu")


@pytest.mark.parametrize("m", [20, 32, 40])
def test_bitsample_words_and_margins(m):
    x = _x()
    (jo, _), (to, _) = _families(m=m)
    _eq(jhp._bitsample_gather_pack(jnp.asarray(x), jo.dims, jo.thrs),
        thp.signature_words(to, torch.as_tensor(x)))
    jw, jm = jhp._bitsample_gather_margins(jnp.asarray(x), jo.dims, jo.thrs)
    tw, tm = thp.probe_words(to, torch.as_tensor(x))
    _eq(jw, tw)
    _eq(jm, tm)  # |x[dim] - thr| is one subtraction: bit-exact


@pytest.mark.parametrize("rows", [1, 50, 200])
def test_bitsample_pack_words_are_int64_in_the_uint32_range(rows):
    # the words the callers take are int64 holding 32 bits, zero-extended:
    # high bits set in a word must not turn into negative values
    x = _x(rows, seed=rows)
    (jo, _), (to, _) = _families(m=32)
    dims, thrs = thp.bitsample_columns(to)
    words = thp.bitsample_pack(torch.as_tensor(x), dims, thrs)
    assert words.dtype == torch.int64 and words.shape == (rows, 5)
    assert int(words.min()) >= 0 and int(words.max()) < 2**32 and int(words.max()) >= 2**31
    _eq(jhp._bitsample_gather_pack(jnp.asarray(x), jo.dims, jo.thrs), words.reshape(rows, 5, 1))


def test_bitsample_padded_columns_pack_zero_and_inf_margins():
    x = torch.as_tensor(_x(16))
    dims = torch.tensor([3, 0, 7] + [0] * 29, dtype=torch.int32)
    thrs = torch.tensor([50.0, 100.0, 150.0] + [float("inf")] * 29)
    words, margins = thp.bitsample_pack(x, dims, thrs, margins=True)
    assert int((words >> 3).max()) == 0
    assert torch.isinf(margins[:, 3:]).all()


@pytest.mark.parametrize("m_in", [12, 32, 45])
def test_proj_sign_words(m_in):
    x = _x(seed=1)
    (_, ji), (_, ti) = _families(m_in=m_in)
    s = np.einsum("nd,ldm->nlm", x.astype(np.float64), np.asarray(ji.proj, np.float64))
    assert np.abs(s).min() > 1e-3  # the >= vs > sign rules cannot differ here
    bias = jnp.zeros(ji.proj.shape[::2], jnp.float32)
    _eq(jhp._family_pack(jnp.asarray(x), ji.proj, bias, interpret=True),
        thp.signature_words(ti, torch.as_tensor(x)))


def test_proj_sign_margins_mode_reproduces_the_one_hot_form():
    x = _x(seed=2)
    (jo, _), (to, _) = _families()
    jw, jm = jhp._onehot_pack_margins(jnp.asarray(x), jo.dims, jo.thrs, interpret=True)
    tw, tm = thp.onehot_pack_margins(torch.as_tensor(x), to.dims, to.thrs)
    _eq(jw, tw)
    _eq(jm, tm)
    # and the one-hot form equals kernel A's words + margins
    aw, am = thp.probe_words(to, torch.as_tensor(x))
    _eq(aw, tw)
    _eq(am, tm)


def test_proj_sign_pack_sign_rule_at_zero_is_ge():
    x = torch.zeros((2, 4))
    proj = torch.ones((4, 32))
    words = thp_ref.proj_sign_pack_ref(x, proj, torch.zeros(32), 5, 32)
    assert words.tolist() == [[0b11111], [0b11111]]  # s == 0 sets the bit


def _l1_inputs(b=9, c=70, d=6, integer=True, seed=4):
    rng = np.random.default_rng(seed)
    if integer:  # exact sums: distance ties everywhere
        q = rng.integers(0, 4, (b, d)).astype(np.float32)
        cands = rng.integers(0, 4, (b, c, d)).astype(np.float32)
    else:
        q = rng.random((b, d), dtype=np.float32)
        cands = rng.random((b, c, d), dtype=np.float32)
    mask = rng.random((b, c)) < 0.6
    mask[0] = False  # a row with no valid candidate
    mask[1, 3:] = False  # fewer valid candidates than k
    return q, cands, mask


@pytest.mark.parametrize("integer", [True, False], ids=["ties", "float"])
@pytest.mark.parametrize("k", [1, 10, 40, 70])  # 40 past the warp form's 32; 70 = C
def test_l1_topk(integer, k):
    q, cands, mask = _l1_inputs(integer=integer)
    td, tp = tl1.l1_topk(*map(torch.as_tensor, (q, cands, mask)), k)
    assert td.dtype == torch.float32 and tp.dtype == torch.int32
    for jd, jp in (
        jl1.l1_topk(*map(jnp.asarray, (q, cands, mask)), k=k, interpret=True),
        jl1_ref.l1_topk_ref(*map(jnp.asarray, (q, cands, mask)), k),
    ):
        if integer:
            _eq(jd, td)
            _eq(jp, tp)
        else:
            _topk_close(jd, jp, td, tp, _l1_dist_of(q, cands))


def _run_rows(q_n, runs, run, n, seed):
    """Run-structured candidate rows: each run ascends with -1 trailing pads,
    some runs repeat earlier ones (duplicates across runs)."""
    rng = np.random.default_rng(seed)
    rows = np.full((q_n, runs, run), -1, np.int32)
    for i in range(q_n):
        for r in range(runs):
            if r and rng.random() < 0.3:
                rows[i, r] = rows[i, rng.integers(0, r)]
                continue
            fill = rng.integers(0, run + 1)
            rows[i, r, :fill] = np.sort(rng.choice(n, fill, replace=False))
    rows[0] = -1  # a query with no candidate
    return rows.reshape(q_n, runs * run)


@pytest.mark.parametrize(
    "run,runs,c_comp",
    [(16, 8, 128), (16, 8, 20), (16, 6, 64), (12, 4, 48)],
    ids=["pow2", "overflow", "pad_runs", "odd_run"],
)
@pytest.mark.parametrize("integer", [True, False], ids=["ties", "float"])
def test_query_tail(run, runs, c_comp, integer):
    n, k = 300, 10
    rng = np.random.default_rng(run + runs)
    data = (rng.integers(0, 3, (n, 5)) if integer else rng.random((n, 5))).astype(np.float32)
    queries = data[:12] + (0 if integer else 0.01)
    cand = _run_rows(12, runs, run, n, seed=run * runs)
    tout = tqf.query_tail(*map(torch.as_tensor, (data, queries, cand)), run=run, c_comp=c_comp, k=k)
    assert [t.dtype for t in tout] == [torch.float32] + [torch.int32] * 3
    jouts = [jqf_ref.query_tail_ref(*map(jnp.asarray, (data, queries, cand)), c_comp=c_comp, k=k)]
    if run & (run - 1) == 0:
        # the Pallas tail's bitonic run merge needs a power-of-two run: with
        # run=12 it leaves rows unsorted and over-counts comparisons (a
        # fault of the JAX kernel, ROADMAP Queue 3), so odd runs are held
        # to the JAX oracle only
        jouts.append(jqf.query_tail(
            *map(jnp.asarray, (data, queries, cand)), run=run, c_comp=c_comp, k=k, interpret=True
        ))
    for jkd, jki, jcmp, jovf in jouts:
        _eq(jcmp, tout[2])
        _eq(jovf, tout[3])
        if integer:
            _eq(jkd, tout[0])
            _eq(jki, tout[1])
        else:
            _topk_close(jkd, jki, tout[0], tout[1], _point_dist_of(data, queries))
    if c_comp == 20:
        assert int(tout[3].max()) > 0
    assert int(tout[2][0]) == 0 and (tout[1][0] == -1).all()


def test_query_tail_pads_to_a_power_of_two_run_count():
    # the merge width holds a power-of-two number of whole runs (the columns
    # past C count as -1), and the merge starts from the run only when the
    # run is a power of two
    assert tqf.merge_shape(96, 16) == (128, 16)
    assert tqf.merge_shape(48, 12) == (64, 1)
    assert tqf.merge_shape(1024, 16) == (1024, 16)
    assert tqf.merge_shape(130, 16) == (256, 16)
    assert tqf.merge_shape(7, 16) == (8, 8)


@pytest.mark.parametrize("integer", [True, False], ids=["ties", "float"])
def test_query_tail_k_past_the_warp_form(integer):
    # k = 40 > 32: kernel D sorts the block's keys instead of merging warp lists
    n, k, run = 300, 40, 16
    rng = np.random.default_rng(5)
    data = (rng.integers(0, 3, (n, 5)) if integer else rng.random((n, 5))).astype(np.float32)
    queries = data[:12] + (0 if integer else 0.01)
    cand = _run_rows(12, 8, run, n, seed=40)
    tout = tqf.query_tail(*map(torch.as_tensor, (data, queries, cand)), run=run, c_comp=64, k=k)
    for jkd, jki, jcmp, jovf in (
        jqf_ref.query_tail_ref(*map(jnp.asarray, (data, queries, cand)), c_comp=64, k=k),
        jqf.query_tail(*map(jnp.asarray, (data, queries, cand)), run=run, c_comp=64, k=k, interpret=True),
    ):
        _eq(jcmp, tout[2])
        _eq(jovf, tout[3])
        if integer:
            _eq(jkd, tout[0])
            _eq(jki, tout[1])
        else:
            _topk_close(jkd, jki, tout[0], tout[1], _point_dist_of(data, queries))
    assert tout[0].shape == (12, k) and int((tout[1][0] == -1).sum()) == k


_SHAPES = dict(
    grid_chunk=((50, 1024, 30, 1024, 10, True), dict(cp=1024, start=16, cluster=1, stage=False, smem=16504)),
    payload_chunk=((50, 4096, 30, 1024, 10, True), dict(cp=4096, start=16, cluster=1, stage=False, smem=41080)),
    hook=((1, 128, 4096, 128, 8, True), dict(cp=128, start=16, cluster=8, stage=True, smem=150528)),
    knn_chunk=((50, 128, 4096, 128, 8, True), dict(cp=128, start=16, cluster=4, stage=True, smem=150528)),
    unaligned=((7, 128, 4096, 128, 8, False), dict(cp=128, start=16, cluster=8, stage=False, smem=19456)),
    many_queries=((300, 128, 4096, 128, 8, True), dict(cp=128, start=16, cluster=1, stage=True, smem=150528)),
    widest=((1, 128, 18432, 128, 8, True), dict(cp=128, start=16, cluster=8, stage=False, smem=76800)),
    multiprobe=((50, 12288, 30, 1024, 10, True), dict(cp=16384, start=16, cluster=1, stage=False, smem=139384)),
    hook_k40=((1, 128, 4096, 128, 40, True), dict(cp=128, start=16, cluster=1, stage=True, smem=150528)),
    odd_d=((50, 1024, 31, 1024, 10, True), dict(cp=1024, start=16, cluster=1, stage=False, smem=16512)),
)


@pytest.mark.parametrize("case", list(_SHAPES)[:8] + ["hook_k40", "odd_d"])
def test_query_tail_launch_shape(case):
    (q_n, c, d, c_comp, k, aligned), want = _SHAPES[case]
    got = tqf.launch_shape(q_n, c, d, 16, c_comp, k=k, aligned16=aligned, sms=132)
    assert got == dict(route="fused", **want)
    assert want["smem"] == tqf.tail_smem_bytes(want["cp"], c_comp, d, want["stage"])


def test_query_tail_launch_shape_refuses_what_a_block_cannot_hold():
    # what kernel D's merge cannot hold in one block (a merge width past
    # CP_MAX, shared memory past the budget) takes D's hash form, in one
    # launch, instead of being refused; its workspace spills to a device
    # scratch when it passes the budget
    wide = tqf.launch_shape(1, 16385, 30, 16, 1024, k=10, aligned16=True, sms=132)
    assert merge_cp(16385) == 32768 > tqf.CP_MAX
    assert wide == dict(route="hash", h_cap=65536, ws=(65536 + 2 * 1024 + 32) * 4, spill=True)
    deep = tqf.launch_shape(1, 1024, 60_000, 16, 1024, k=10, aligned16=True, sms=132)
    assert tqf.tail_smem_bytes(1024, 1024, 60_000, False) > 200 * 1024
    assert deep == dict(route="hash", h_cap=2048, ws=(2048 + 2 * 1024 + 60_000) * 4, spill=True)
    small = tqf.launch_shape(50, 4096, 30, 16, 9000, k=10, aligned16=True, sms=132)
    assert small["route"] == "fused"  # a c_comp past C still fits D's merge


def merge_cp(c: int) -> int:
    return tqf.merge_shape(c, 16)[0]


@pytest.mark.parametrize(
    "c,d,run,c_comp,route",
    [
        (1024, 30, 16, 1024, "fused"),  # the grid chunk
        (16384, 30, 16, 1024, "fused"),  # merge width at CP_MAX
        (16385, 30, 16, 1024, "hash"),  # one column past it
        (24576, 30, 16, 1024, "hash"),  # L_out=16, c_max=512, multiprobe=2
        (16384, 30, 16, 16384, "hash"),  # c_comp=0 at 16,384 columns: 262 KB
        (16384, 30, 16, 9201, "fused"),  # the widest c_comp that fits beside it
        (16384, 30, 16, 9202, "hash"),
        (128, 4096, 16, 128, "fused"),  # the kNN-LM hook (row slots dropped when tight)
        (128, 60_000, 16, 128, "hash"),  # the query alone over the budget
        (48, 30, 12, 48, "fused"),  # an odd run: a full in-block sort
    ],
)
def test_tail_route_follows_the_shape(c, d, run, c_comp, route):
    for k in (1, 10, 40, 1000):  # k never decides the route
        shape = tqf.launch_shape(50, c, d, run, c_comp, k=k, aligned16=True, sms=132)
        assert shape["route"] == route
    if route == "hash":  # the set holds twice the row, and the k > 32 sort's keys after it
        assert shape["h_cap"] == max(tqf.E_THREADS, 2 * tqf.merge_shape(c, 1)[0])
        assert shape["ws"] == tqf.hash_ws_bytes(c, c_comp, d)
        assert shape["spill"] == (shape["ws"] > 200 * 1024)


def _tie_case():
    """Points with an exact tie at the top of query 0 (point 7 copies point
    3) and one past the k-th neighbour of query 2 (the last point copies
    that neighbour), and the exact top-k of every query."""
    rng = np.random.default_rng(9)
    data = rng.random((60, 5), dtype=np.float32)
    data[7] = data[3]
    queries = data[[3, 20, 40]] + np.float32(0.01)
    k = 6
    kd, ki = ttopk.masked_l1_topk_batch(
        torch.as_tensor(queries), torch.as_tensor(data).expand(3, -1, -1),
        torch.ones((3, 60), dtype=torch.bool), k,
    )
    data = np.concatenate([data, data[int(ki[2, k - 1])][None]])
    return data, queries, kd, ki


def _edit_slots(ki, edits):
    ki = ki.clone()
    for (row, slot), value in edits.items():
        ki[row, slot] = value
    return ki


_TOPK_EDITS = {
    "equal": (lambda kd, ki: (kd, ki), None),
    "swap_at_tie": (lambda kd, ki: (kd, _edit_slots(ki, {(0, 0): ki[0, 1], (0, 1): ki[0, 0]})), None),
    "tie_past_k": (lambda kd, ki: (kd, _edit_slots(ki, {(2, 5): 60})), None),
    "swap_without_tie": (lambda kd, ki: (kd, _edit_slots(ki, {(1, 2): ki[1, 3], (1, 3): ki[1, 2]})),
                         "without a distance tie"),
    "positions_for_indices": (lambda kd, ki: (kd, torch.arange(6, dtype=ki.dtype).expand(3, -1).clone()),
                              "without a distance tie"),
    "wrong_point_at_last_slot": (lambda kd, ki: (kd, _edit_slots(ki, {(1, 5): ki[1, 0]})),
                                 "not a point at its reported distance"),
    "index_twice": (lambda kd, ki: (kd, _edit_slots(ki, {(0, 1): ki[0, 0]})), "repeats an index"),
    "distance_off": (lambda kd, ki: (kd + 1e-3, ki), "distances differ"),
}


@pytest.mark.parametrize("case", list(_TOPK_EDITS))
def test_topk_mismatch_allows_only_real_ties(case):
    data, queries, kd, ki = _tie_case()
    assert {int(ki[0, 0]), int(ki[0, 1])} == {3, 7}
    edit, expected = _TOPK_EDITS[case]
    td, ti = edit(kd, ki)
    why = ttopk.topk_mismatch(td, ti, kd, ki, _point_dist_of(data, queries), rtol=RTOL, atol=ATOL)
    if expected is None:
        assert why is None, why
    else:
        assert why is not None and expected in why, why
