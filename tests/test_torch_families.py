"""The port's moe, ssm and hybrid LM families (the serving path) against the
JAX package on the same inputs.

Weights come from the JAX package's own init and cross with
``repro_torch.params.model_params_from_numpy`` (hymba's nested
``segments`` and ``meta`` included); inputs are made with numpy.

The JAX side runs under ``jax.jit`` with ``xla_allow_excess_precision``
off (``EXACT``): every bf16 result is then rounded where the program says,
as the port (and eager JAX) rounds it. XLA:CPU's default keeps float32
across fused bf16 ops, which moves about one element in four of
olmoe-smoke's block outputs by a bf16 ulp; its routing has near-ties at
the capacity boundary (scores 0.50592 and 0.50590 of expert 0), so that
ulp flips a token's expert and moves the logits by up to 1.3. Under
``EXACT`` olmoe-smoke's logits equal the port's bit for bit.

Tolerances, each with its reason:

* Logits: 2^-5 of the JAX logits' largest magnitude, four bf16 ulps there
  (as ``test_torch_models.py`` holds the vision model's). The smoke
  models' logits reach about 3, where LOGIT_ATOL (0.03) is under two ulps;
  the SSD and its float32 sums (``exp``, ``log1p``, einsums in another
  order than XLA's) flip a bf16 rounding here and there, which each
  layer carries on: measured 0.039 (mamba2) and 0.047 (hymba), 0.0 and
  0.016 for the two moe models. The greedy token must agree wherever the
  JAX top-2 margin exceeds twice the tolerance.
* Cache leaves: 2^-4 of each leaf's largest magnitude (eight bf16 ulps
  there), every leaf of the tree; integers (``len``, hymba's ring
  ``pos``) exactly. The SSM state sums the layer's inputs over the
  sequence, each input carrying those flips (measured up to 0.044 of the
  largest state of hymba's last layer).
* MoE routing: the integers (experts, each expert's token slots, their
  validity) exactly; the weights within 1e-6 (float32 softmax in another
  order).
* ``causal_conv``: bit for bit; a form that sums in float32 and rounds
  once (as ``conv1d`` would) differs from the JAX package's in hundreds
  of elements.
* ``ssd_chunked``, ``ssm_step`` (float32): rtol 1e-4, atol 1e-5 against
  the JAX package's and against ``ssd_reference`` (the JAX package's own
  test holds its chunked form to 1e-4).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import mamba2 as jmamba2
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import params as tparams
from repro_torch.kernels import _build
from repro_torch.models import api as tapi
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import moe as tmoe
from repro_torch.serve import engine as tengine

FAMILIES = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "mamba2-780m", "hymba-1.5b"]
EXACT = dict(compiler_options={"xla_allow_excess_precision": False})
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    _build.reset_launches()
    yield
    assert _build.LAUNCHES == {}, "a kernel launched on the CPU"


class Pair:
    """One smoke config in both packages, on the JAX package's weights."""

    def __init__(self, arch: str):
        self.jcfg, self.tcfg = jconfigs.get(arch, smoke=True), tconfigs.get(arch, smoke=True)
        self.jm, self.tm = japi.build_model(self.jcfg), tapi.build_model(self.tcfg)
        self.jp = self.jm.init(jax.random.PRNGKey(0))
        self.lm = tparams.model_params_from_numpy(self.tcfg, jax.tree.map(np.asarray, self.jp), "cpu")
        self.prefill = jax.jit(self.jm.prefill, static_argnums=2, **EXACT)
        self.decode = jax.jit(self.jm.decode_step, **EXACT)

    def both_prefill(self, toks, max_len):
        jl, jc = self.prefill(self.jp, {"tokens": jnp.asarray(toks)}, max_len)
        tl, tc = self.tm.prefill(self.lm, {"tokens": torch.tensor(toks)}, max_len)
        return (jl, jc), (tl, tc)


_PAIRS: dict = {}


def pair(arch: str) -> Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


@pytest.fixture(scope="module", autouse=True)
def _drop_pairs():
    yield
    _PAIRS.clear()


def _logit_atol(want) -> float:
    return 2.0**-5 * float(np.abs(_np(want)).max())


def _assert_logits(got, want):
    got, want = _np(got), _np(want)
    atol = _logit_atol(want)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=atol)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * atol
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def _assert_cache(got: dict, want, path: str = "cache"):
    """Every leaf of the JAX cache tree against the port's: the same keys
    and shapes, integers exactly, floats within 2^-4 of the leaf's largest
    magnitude."""
    assert set(got) == set(want), f"{path}: keys {sorted(got)} != {sorted(want)}"
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):
            _assert_cache(g, w, f"{path}/{name}")
            continue
        assert tuple(g.shape) == tuple(w.shape), f"{path}/{name}: {tuple(g.shape)} != {w.shape}"
        if jnp.issubdtype(w.dtype, jnp.integer):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{path}/{name}")
        else:
            wn = _np(w)
            atol = 2.0**-4 * max(float(np.abs(wn).max()), 1e-6)
            np.testing.assert_allclose(_np(g), wn, rtol=0.0, atol=atol, err_msg=f"{path}/{name}")


# ------------------------------------------------------------ whole families
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_serving_matches_jax(arch):
    """Prefill and three greedy decode steps on a batch of two 21-token
    prompts: logits, greedy tokens and every cache leaf."""
    pr = pair(arch)
    assert pr.tcfg.n_layers <= 3
    toks = np.random.default_rng(7).integers(0, pr.tcfg.vocab, (2, 21)).astype(np.int32)
    max_len = 48
    (jl, jcache), (tl, tcache) = pr.both_prefill(toks, max_len)
    _assert_logits(tl, jl)
    _assert_cache(tcache, jcache)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jcache = pr.decode(pr.jp, jcache, jnp.asarray(nxt))
        tl, tcache = pr.tm.decode_step(pr.lm, tcache, torch.tensor(nxt))
        _assert_logits(tl, jl)
    _assert_cache(tcache, jcache)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_serving_weights_follow_the_jax_tree(arch):
    """``init`` and the carried tree: the JAX package's leaves and shapes,
    matmul weights and embeddings in bf16, the router, conv, SSM scalars
    and norms in ``param_dtype``; parameter counts equal."""
    pr = pair(arch)
    assert pr.tm.n_params == pr.jm.n_params
    want = {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_flatten_with_path(pr.jp)[0]}
    for model in (pr.lm, pr.tm.init(0, "cpu")):
        got = {"".join(f"['{n}']" for n in name.split(".")): p for name, p in model.named_parameters()}
        assert {k: tuple(p.shape) for k, p in got.items()} == {k: tuple(s) for k, s in want.items()}
        for name, p in got.items():
            leaf = name.rsplit("['", 1)[1][:-2]
            bf16 = leaf in {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "e_gate", "e_up", "e_down",
                            "in_proj", "out_proj", "embed", "lm_head", "meta"}
            assert p.dtype == (torch.bfloat16 if bf16 else torch.float32), name
            assert not p.requires_grad


# ------------------------------------------------------------ MoE routing
def _jax_dispatch(top_w, top_e, cfg, t):
    """``_moe_local``'s dispatch lines (repro/models/moe.py:79-85)."""
    cap = jmoe._capacity(t, cfg)
    eids = jnp.arange(cfg.n_experts)
    assign = top_e[None] == eids[:, None, None]
    w_e = jnp.where(assign, top_w[None], 0.0).sum(-1)
    score = jnp.where(w_e > 0.0, w_e, -jnp.inf)
    top_scores, top_pos = jax.lax.top_k(score, min(cap, t))
    return top_scores, top_pos, jnp.isfinite(top_scores)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["capacity_1.25", "capacity_0.5"])
def test_moe_routing_matches_jax(capacity_factor):
    """Experts, slots and validity exactly, on 40 tokens of which rows
    20-29 repeat rows 0-9: their scores tie, and ``lax.top_k`` keeps the
    lowest token index; at capacity 0.5 slots go unfilled (-inf) and
    tokens are dropped. Then ``moe_apply`` on the same rows."""
    pr = pair("olmoe-1b-7b")
    jcfg = dataclasses.replace(pr.jcfg, capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(pr.tcfg, capacity_factor=capacity_factor)
    rng = np.random.default_rng(11)
    x = _rand(rng, 40, tcfg.d_model)
    x[20:30] = x[0:10]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    lp = jax.tree.map(lambda t: t[0], pr.jp["layers"])
    p = {k: v[0] for k, v in pr.lm["layers"].named_parameters()}
    jw, je, jprobs = jmoe._route(lp["router"], xb.astype(jnp.float32), jcfg)
    tw, te, tprobs = tmoe._route(p["router"], torch.tensor(_np(xb)), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(_np(tprobs), _np(jprobs), rtol=0.0, atol=1e-6)
    js, jpos, jvalid = _jax_dispatch(jw, je, jcfg, 40)
    ts, tpos, tvalid = tmoe._dispatch(torch.tensor(_np(jw)), torch.tensor(np.asarray(je)), tcfg, 0, tcfg.n_experts)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(_np(ts), _np(js))
    # tied pairs (a row and its repeat) in one expert's slots: the lower
    # token index first
    slots = [list(row[ok]) for row, ok in zip(np.asarray(jpos), np.asarray(jvalid))]
    tied = [(row.index(i), row.index(i + 20)) for row in slots for i in range(10) if i in row and i + 20 in row]
    assert tied and all(a < b for a, b in tied)
    if capacity_factor < 1:
        assert not np.asarray(jvalid).all()
    jout, jaux = jax.jit(lambda pp, xx: jmoe.moe_apply(pp, xx, jcfg), **EXACT)(lp, xb[None])
    tout, taux = tmoe.moe_apply(p, torch.tensor(_np(xb)).to(torch.bfloat16)[None], tcfg)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=2.0**-8, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


# ------------------------------------------------------------ SSD and conv
def test_causal_conv_matches_jax_bit_for_bit(monkeypatch):
    """The conv alone, then as ``ssm_mix`` calls it (bf16 stream and
    weights): the recorded output of the port's call equals the JAX
    package's ``causal_conv`` on the same projection, bit for bit."""
    rng = np.random.default_rng(3)
    x, w, b = _rand(rng, 2, 37, 48), _rand(rng, 48, 4, scale=0.5), _rand(rng, 48, scale=0.1)
    jx, jw, jb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b))
    tx, tw, tb = (torch.tensor(a).to(torch.bfloat16) for a in (x, w, b))
    got = _np(tmamba2.causal_conv(tx, tw, tb))
    want = _np(jmamba2.causal_conv(jx, jw, jb))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _np(jax.jit(jmamba2.causal_conv)(jx, jw, jb)))
    # a float32 sum rounded once is another function
    xp = torch.nn.functional.pad(tx, (0, 0, 3, 0)).float()
    once = (sum(xp[:, i : i + 37] * tw[:, i].float() for i in range(4)) + tb.float()).to(torch.bfloat16)
    assert int((_np(once) != want).sum()) > 100

    pr = pair("mamba2-780m")
    lp = jax.tree.map(lambda t: t[0], pr.jp["layers"])
    p = {k: v[0] for k, v in pr.lm["layers"].named_parameters()}
    x = _rand(rng, 2, 19, pr.tcfg.d_model)
    seen = []
    real = tmamba2.causal_conv
    monkeypatch.setattr(tmamba2, "causal_conv", lambda *a: seen.append(real(*a)) or seen[-1])
    tmamba2.ssm_mix(pr.tcfg, p, torch.tensor(x).to(torch.bfloat16))
    d_inner, _, conv_dim, _ = jmamba2.dims(pr.jcfg)
    proj = jnp.asarray(x).astype(jnp.bfloat16) @ lp["in_proj"].astype(jnp.bfloat16)
    xbc = proj[..., d_inner : d_inner + conv_dim]  # x, B and C: the columns after z
    want = jmamba2.causal_conv(xbc, lp["conv_w"].astype(jnp.bfloat16), lp["conv_b"].astype(jnp.bfloat16))
    assert len(seen) == 1 and seen[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(seen[0]), _np(want))


def _ssd_inputs(rng, b=2, s=37, h=24, p=8, n=8):
    xh = _rand(rng, b, s, h, p)
    dt = np.log1p(np.exp(_rand(rng, b, s, h))).astype(np.float32)
    a = -np.exp(_rand(rng, h, scale=0.5)).astype(np.float32)
    return xh, dt, a, _rand(rng, b, s, n), _rand(rng, b, s, n)


@pytest.mark.parametrize("chunk", [16, 64], ids=["chunk16_padded", "chunk64_one_chunk"])
def test_ssd_chunked_matches_jax_and_the_recurrence(chunk):
    """S = 37 (not a multiple of 16: dt = 0 padding), 24 heads (head groups
    of 8); float32 and the model's bf16 x."""
    ins = _ssd_inputs(np.random.default_rng(chunk))
    ty, th = tmamba2.ssd_chunked(*map(torch.tensor, ins), chunk)
    jy, jh = jmamba2.ssd_chunked(*map(jnp.asarray, ins), chunk)
    ry, rh = tmamba2.ssd_reference(*map(torch.tensor, ins))
    np.testing.assert_allclose(_np(ty), _np(jy), **F32_TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **F32_TOL)
    np.testing.assert_allclose(_np(ty), _np(ry), **F32_TOL)
    np.testing.assert_allclose(_np(th), _np(rh), **F32_TOL)
    jry, jrh = jmamba2.ssd_reference(*map(jnp.asarray, ins))
    np.testing.assert_allclose(_np(ry), _np(jry), **F32_TOL)
    np.testing.assert_allclose(_np(rh), _np(jrh), **F32_TOL)
    # the model's dtypes: bf16 x gives bf16 y and a float32 state
    xb = torch.tensor(ins[0]).to(torch.bfloat16)
    by, bh = tmamba2.ssd_chunked(xb, *map(torch.tensor, ins[1:]), chunk)
    jby, _ = jmamba2.ssd_chunked(jnp.asarray(ins[0]).astype(jnp.bfloat16), *map(jnp.asarray, ins[1:]), chunk)
    assert by.dtype == torch.bfloat16 and bh.dtype == torch.float32
    np.testing.assert_allclose(_np(by), _np(jby), rtol=2.0**-7, atol=1e-3)


def test_ssm_step_matches_jax():
    """One recurrent step on the same bf16 token and float32 state and
    conv window; the new window is the old one shifted, exactly."""
    pr = pair("mamba2-780m")
    cfg = pr.tcfg
    _, n_heads, conv_dim, _ = tmamba2.dims(cfg)
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 1, cfg.d_model)
    hs = _rand(rng, 2, n_heads, cfg.ssm_state, cfg.ssm_headdim)
    cs = _rand(rng, 2, cfg.conv_kernel - 1, conv_dim)
    lp = jax.tree.map(lambda t: t[1], pr.jp["layers"])
    p = {k: v[1] for k, v in pr.lm["layers"].named_parameters()}
    jout, jh, jc = jmamba2.ssm_step(pr.jcfg, lp, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(hs), jnp.asarray(cs))
    tout, th, tc = tmamba2.ssm_step(cfg, p, torch.tensor(x).to(torch.bfloat16), torch.tensor(hs), torch.tensor(cs))
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=2.0**-7, atol=1e-3)
    np.testing.assert_allclose(_np(th), _np(jh), **F32_TOL)
    np.testing.assert_allclose(_np(tc), _np(jc), **F32_TOL)
    np.testing.assert_array_equal(_np(tc)[:, :-1], cs[:, 1:])


# ------------------------------------------------------------ hymba decode
@pytest.mark.parametrize("s", [6, 12, 20], ids=["s_tot14_ring_part_full", "s_tot20_ring_wrapped", "s_tot28_past_w_plus_mt"])
def test_hymba_decode_matches_jax_below_and_above_window_plus_meta(s):
    """Decode after ``prefill(s)`` at ``s_tot = s + 8`` (window 16, 8 meta
    tokens): below 16 the ring is part full, from 16 it wraps, and from
    ``window + meta_tokens = 24`` no meta position is left in it. The port
    equals the JAX package at every point, and so reproduces its double
    count of the meta keys (ROADMAP.md, Queue 3): below 24 the decode
    step's logits differ from ``prefill(s + 1)``'s by well over the
    tolerance, past it by less."""
    pr = pair("hymba-1.5b")
    w, mt = pr.tcfg.window, pr.tcfg.meta_tokens
    seq = np.random.default_rng(9).integers(0, pr.tcfg.vocab, (1, s + 1)).astype(np.int32)
    (jl, jcache), (tl, tcache) = pr.both_prefill(seq[:, :s], 40)
    np.testing.assert_array_equal(
        _np(tcache["segments"]["seg1"]["pos"][0, 0]),
        np.asarray(jcache["segments"]["seg1"]["pos"][0, 0]),
    )
    jd, _ = pr.decode(pr.jp, jcache, jnp.asarray(seq[:, s:]))
    td, _ = pr.tm.decode_step(pr.lm, tcache, torch.tensor(seq[:, s:]))
    _assert_logits(td, jd)
    whole, _ = pr.tm.prefill(pr.lm, {"tokens": torch.tensor(seq)}, 40)
    gap = float((td - whole).abs().max())
    if s + mt < w + mt:  # meta positions are still in the ring
        assert gap > 2 * _logit_atol(jd), f"the double-counted meta keys must show: {gap}"
    else:
        assert gap < _logit_atol(jd), f"past window + meta_tokens decode continues prefill: {gap}"


# ------------------------------------------------------------ caches, refusals
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m", "hymba-1.5b"])
def test_a_cache_decodes_twice_alike(arch):
    """A cache given to ``decode_step`` gives the same logits on a second
    call with the same tokens, as the JAX package's immutable one does: the
    SSM state and conv come back as new tensors (the given ones unchanged),
    K/V and the ring are written in place at positions the next step
    rewrites."""
    pr = pair(arch)
    toks = torch.tensor(np.random.default_rng(2).integers(0, pr.tcfg.vocab, (2, 19)).astype(np.int32))
    _, cache = pr.tm.prefill(pr.lm, {"tokens": toks}, 40)
    states = {k: t.clone() for k, t in _leaves(cache) if k.endswith(("state", "conv"))}
    nxt = torch.tensor([[3], [5]], dtype=torch.int32)
    first, new = pr.tm.decode_step(pr.lm, cache, nxt)
    second, _ = pr.tm.decode_step(pr.lm, cache, nxt)
    assert torch.equal(first, second)
    got = dict(_leaves(cache))
    for k, t in states.items():
        assert torch.equal(got[k], t), f"{k} was changed in place"
    assert all(not torch.equal(dict(_leaves(new))[k], t) for k, t in states.items() if k.endswith("state"))
    assert int(cache["len"][0]) == 19 + pr.tcfg.meta_tokens and int(new["len"][0]) == 20 + pr.tcfg.meta_tokens


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m", "hymba-1.5b"])
def test_training_of_the_new_families_is_refused(arch):
    """The training entry points of the three families (which refused them
    until they were ported; ``tests/test_torch_families_train.py`` holds
    their losses, gradients and steps to the JAX package).
    ``init_masters`` gives the JAX tree's leaf names and shapes in
    ``param_dtype``, requiring gradients; ``serving(masters)`` gives the
    logits of ``init``'s frozen model (the same draws) and of the JAX
    weights carried for serving, and is a copy that a later update of the
    masters leaves as it was; ``train_state_from_numpy`` carries JAX's
    masters and AdamW state (8-bit moments in their layout)."""
    pr = pair(arch)
    want = {name: tuple(np.shape(v)) for name, v in _leaves(jax.tree.map(np.asarray, pr.jp))}
    for dtype in ("float32", "bfloat16"):
        model = tapi.build_model(dataclasses.replace(pr.tcfg, param_dtype=dtype))
        masters = dict(_leaves(model.init_masters(0, "cpu")))
        assert {k: tuple(t.shape) for k, t in masters.items()} == want
        assert all(t.dtype == getattr(torch, dtype) and t.requires_grad for t in masters.values())
    toks = {"tokens": torch.tensor(np.random.default_rng(5).integers(0, pr.tcfg.vocab, (2, 12)).astype(np.int32))}
    served = pr.tm.serving(pr.tm.init_masters(0, "cpu"))
    assert torch.equal(pr.tm.prefill(served, toks, 32)[0], pr.tm.prefill(pr.tm.init(0, "cpu"), toks, 32)[0])
    jopt = jadamw.AdamWConfig(state_bits=8)
    jstate = jadamw.init(pr.jp, jopt)
    masters, state = tparams.train_state_from_numpy(pr.tcfg, jax.tree.map(np.asarray, pr.jp), jstate, "cpu")
    for name, w in _leaves(jax.tree.map(np.asarray, pr.jp)):
        np.testing.assert_array_equal(_np(dict(_leaves(masters))[name]), w, err_msg=name)
    got_state = dict(_leaves({"m": state.m, "v": state.v}))
    assert {k: (str(t.dtype), tuple(t.shape)) for k, t in got_state.items()} == {
        k: ("torch." + str(np.asarray(a).dtype), np.shape(a)) for k, a in _leaves({"m": jstate.m, "v": jstate.v})}
    served = pr.tm.serving(masters)
    logits = pr.tm.prefill(served, toks, 32)[0]
    assert torch.equal(logits, pr.tm.prefill(pr.lm, toks, 32)[0])
    with torch.no_grad():
        for t in dict(_leaves(masters)).values():
            t.add_(1.0)
    assert torch.equal(pr.tm.prefill(served, toks, 32)[0], logits)


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_engine_gives_the_jax_engines_tokens(arch):
    """Three requests (prompts of 9, 9 and 14 tokens) decoded greedily as
    one batch of stacked B=1 caches (hymba's nested tree included) by both
    engines. Every token equals the JAX engine's until a step whose JAX
    top-2 margin is under twice the logit tolerance (the logits there are
    the engines' own, read through a pass-through hook)."""
    pr = pair(arch)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, pr.tcfg.vocab, n).astype(np.int32) for n in (9, 9, 14)]
    jlog, tlog = [], []

    def record(log):
        def hook(logits, cache):
            log.append(_np(logits))
            return logits

        return hook

    # the JAX engine on the EXACT-compiled prefill and decode step
    jeng = jengine.ServeEngine(SimpleNamespace(**{**vars(pr.jm), "prefill": pr.prefill}), pr.jp, max_batch=3,
                               max_len=32, logits_hook=record(jlog))
    jeng._decode = pr.decode
    teng = tengine.ServeEngine(pr.tm, pr.lm, max_batch=3, max_len=32, logits_hook=record(tlog))
    jreqs = jeng.serve([jengine.Request(rid=i, tokens=p, max_new=5) for i, p in enumerate(prompts)])
    treqs = teng.serve([tengine.Request(rid=i, tokens=p, max_new=5) for i, p in enumerate(prompts)])
    assert all(r.done and len(r.result) == 5 for r in treqs)
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        for t, (jt, tt) in enumerate(zip(jr.result, tr.result)):
            top2 = np.sort(jlog[t][i])[-2:]
            if top2[1] - top2[0] <= 2 * _logit_atol(jlog[t]):
                break  # a near-tie: the rest may follow either token
            assert tt == jt, f"request {i}, step {t}: {tr.result} != {jr.result}"
            np.testing.assert_allclose(tlog[t][i], jlog[t][i], rtol=0.0, atol=_logit_atol(jlog[t]))
