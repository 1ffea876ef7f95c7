"""The port's dense LM against the JAX package on the same inputs.

Inputs and weights are made with numpy (or by the JAX package's own init)
and handed to both packages; the JAX parameter tree crosses with
``repro_torch.params.model_params_from_numpy``. The JAX flash kernel runs
in interpret mode, as the JAX package's own tests run it on the CPU.

Tolerances, each with its reason:

* float32 building blocks (``rms_norm``, ``apply_rope``, attention):
  rtol = atol = 1e-5. Both sides compute the same float32 formula; XLA and
  PyTorch may order a reduction differently (the mean of squares, the
  softmax sum, the dot over dh) and round ``cos``/``sin``/``pow`` apart by
  an ulp, which stays far below 1e-5 at these magnitudes. The same bound
  covers where the scale is applied: ``chunked_attention`` and the port's
  kernel scale q before the dot, ``attention_ref`` and the Pallas kernel
  scale the scores after it, a one-ulp difference in each score.
* bf16 paths (``mlp_apply``, the whole model): every matmul rounds its
  output to bf16 (8 significant bits), and XLA:CPU and PyTorch accumulate
  a bf16 product in float32 in different orders, so an element may land
  one bf16 ulp apart (2^-8 relative); each layer carries such flips on.
  ``mlp_apply`` is held to 2 bf16 ulps (rtol 2^-7) plus atol 1e-3, the
  logits and the KV cache to atol 0.03 (logits are about 0.3 and
  cached keys up to about 3 in size here; a flip in layer 1 moves layer 2's
  keys by about two ulps, 0.03 at 2) and the greedy token must agree
  wherever the JAX top-2 margin exceeds twice that.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import lm_data as jlm
from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_attention import ref as jfa_ref
from repro.models import api as japi
from repro.models import common as jC
from repro.models import dense as jdense
from repro_torch import configs as tconfigs
from repro_torch import params as tparams
from repro_torch.data import lm_data as tlm
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.models import api as tapi
from repro_torch.models import common as tC
from repro_torch.models import dense as tdense

F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_ATOL = 0.03


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


# ------------------------------------------------------------ registry, data
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_jax_registry(arch, smoke):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    j, t = jconfigs.get(arch, smoke), tconfigs.get(arch, smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.supports_decode == j.supports_decode


def test_token_stream_gives_the_jax_tokens():
    js, ts = jlm.TokenStream(49152, seed=3), tlm.TokenStream(49152, seed=3)
    np.testing.assert_array_equal(ts.motif, js.motif)
    for shape in ((4, 33), (1, 128), (2, 7)):
        np.testing.assert_array_equal(ts.batch(*shape), js.batch(*shape))
    jb, tb = next(js.batches(1, 2, 9)), next(ts.batches(1, 2, 9))
    np.testing.assert_array_equal(tb["tokens"], jb["tokens"])


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-32b", "nemotron-4-340b", "phi-3-vision-4.2b", "olmoe-1b-7b",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-780m", "hymba-1.5b"])
def test_param_count_equals_jax(arch):
    for smoke in (True, False):
        cfg = tconfigs.get(arch, smoke)
        assert tapi.build_model(cfg).n_params == japi.build_model(jconfigs.get(arch, smoke)).n_params


def test_unported_families_raise():
    # the moe, ssm and hybrid families serve and train (their training
    # entry points refused them until they were ported;
    # tests/test_torch_families.py and test_torch_families_train.py hold
    # them to the JAX package): their masters hold n_params values
    for arch in ("olmoe-1b-7b", "mamba2-780m", "hymba-1.5b"):
        model = tapi.build_model(tconfigs.get(arch, smoke=True))
        assert model.n_params == japi.build_model(jconfigs.get(arch, smoke=True)).n_params
        def count(node):
            return sum(count(t) for t in node.values()) if isinstance(node, dict) else node.numel()

        assert count(model.init_masters(0, "cpu")) == model.n_params
    # the vision front end is ported: patch embeddings replace the first
    # frontend_len positions, and prefill gives the JAX package's logits
    jcfg, jparams, tcfg, lm = _models("phi-3-vision-4.2b")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32),
             "patch_embeds": _rand(rng, 2, tcfg.frontend_len, tcfg.frontend_dim)}
    jl, _ = jdense.prefill(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()}, 16)
    tl, _ = tdense.prefill(tcfg, lm, {k: torch.tensor(v) for k, v in batch.items()}, 16)
    # the projected patches are about 1 in size, fifty times the token
    # embeddings, so the logits reach about 1.5: held to 2^-5 of their
    # largest magnitude (four bf16 ulps there) in place of LOGIT_ATOL
    atol = 2.0**-5 * float(np.abs(_np(jl)).max())
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0.0, atol=atol)
    top2 = np.sort(_np(jl), axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * atol
    np.testing.assert_array_equal(_np(tl).argmax(-1)[sure], _np(jl).argmax(-1)[sure])
    jx, jmask = jdense._embed_inputs(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tx, tmask = tdense._embed_inputs(tcfg, lm, batch)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(_np(tx), _np(jx), rtol=2.0**-7, atol=1e-3)


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card behaviour cannot show")
    model = tapi.build_model(tconfigs.get("granite-8b", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tparams.model_params_from_numpy(model.cfg, {})
    assert model.init(0, "cpu").device == torch.device("cpu")


def test_init_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card behaviour cannot show")
    model = tapi.build_model(tconfigs.get("granite-8b", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(2, 16)
    cache = model.init_cache(2, 16, device="cpu")
    assert {t.device for t in cache.values()} == {torch.device("cpu")}


def test_init_follows_the_jax_init_rules():
    cfg = tconfigs.get("granite-8b", smoke=True)
    lm = tapi.build_model(cfg).init(0, "cpu")
    p = lm.layers[0]
    assert p["wq"].dtype == torch.bfloat16 and p["ln1"].dtype == torch.float32
    assert torch.equal(p["ln1"], torch.ones(cfg.d_model))
    # normal with a fan-in scale, embed x0.02
    assert abs(float(p["w_down"].float().std()) - cfg.d_ff**-0.5) < 0.1 * cfg.d_ff**-0.5
    assert abs(float(lm["embed"].float().std()) - 0.02) < 0.002
    # one stacked draw per leaf: layers hold views of it
    assert p["wq"].untyped_storage().data_ptr() == lm.layers[1]["wq"].untyped_storage().data_ptr()


def test_a_leaf_past_draw_whole_max_is_drawn_one_row_at_a_time(monkeypatch):
    """A leaf of more than ``DRAW_WHOLE_MAX`` elements is drawn one leading
    row at a time, each cast to its storage dtype as it is drawn, in the
    order a loop over the rows would draw them; the next leaf's draw
    follows; a leaf within the bound is one draw, as it always was."""
    from repro_torch.models import params as tPM

    defs = {"w": tPM.PDef((3, 4, 5), dtype=torch.bfloat16), "e": tPM.PDef((4, 4), "embed")}
    whole = tPM.init_params(defs, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    assert torch.equal(whole["w"], (torch.randn((3, 4, 5), generator=g) * 4**-0.5).to(torch.bfloat16))
    monkeypatch.setattr(tPM, "DRAW_WHOLE_MAX", 20)
    rows = tPM.init_params(defs, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    want = torch.stack([(torch.randn((4, 5), generator=g) * 4**-0.5).to(torch.bfloat16) for _ in range(3)])
    assert rows["w"].dtype == torch.bfloat16 and torch.equal(rows["w"], want)
    assert torch.equal(rows["e"], torch.randn((4, 4), generator=g) * 0.02)


# ------------------------------------------------------------ building blocks
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 5, 64, scale=3.0), _rand(rng, 64)
    np.testing.assert_allclose(_np(tC.rms_norm(torch.tensor(x), torch.tensor(w))),
                               _np(jC.rms_norm(jnp.asarray(x), jnp.asarray(w))), **F32_TOL)


@pytest.mark.parametrize("per_row", [False, True], ids=["positions", "per_row_positions"])
def test_apply_rope_matches_jax(per_row):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 300, (2, 7)) if per_row else np.arange(7)
    got = tC.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4)
    want = jC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp_apply_matches_jax(kind):
    rng = np.random.default_rng(2)
    d, f = 64, 96
    p = {"w_gate": _rand(rng, d, f, scale=d**-0.5), "w_up": _rand(rng, d, f, scale=d**-0.5),
         "w_down": _rand(rng, f, d, scale=f**-0.5)}
    x = _rand(rng, 2, 5, d)
    got = tC.mlp_apply({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x), kind)
    want = jC.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2.0**-7, atol=1e-3)


_ATTN_CASES = [
    # b, hq, hkv, sq, skv, causal, window, q_offset[, sink]
    (1, 2, 2, 64, 64, True, None, 0),
    (2, 4, 2, 40, 40, True, 16, 0),  # window, GQA 2:1
    (1, 8, 1, 24, 56, True, None, 32),  # q_offset, GQA 8:1
    (2, 4, 4, 33, 47, False, None, 0),  # non-causal, ragged
    (2, 4, 2, 40, 40, True, 16, 0, 8),  # hymba's SWA prefill: window and meta-token sink
    (1, 8, 1, 24, 56, True, 8, 32, 12),  # sink past the window's reach, q_offset
    (2, 4, 4, 33, 47, False, 6, 0, 20),  # non-causal window, sink wider than it
    (1, 2, 2, 30, 30, True, None, 0, 8),  # no window: the sink changes nothing
]


def _attn_id(c) -> str:
    return "b{}_h{}x{}_s{}x{}_c{}_w{}_o{}".format(*c) + (f"_sink{c[8]}" if len(c) > 8 else "")


@pytest.mark.parametrize("case", _ATTN_CASES, ids=_attn_id)
def test_attention_matches_jax(case):
    b, hq, hkv, sq, skv, causal, window, qo = case[:8]
    sink = case[8] if len(case) > 8 else 0
    rng = np.random.default_rng(sq + skv)
    dh = 32
    q, k, v = _rand(rng, b, sq, hq, dh), _rand(rng, b, skv, hkv, dh), _rand(rng, b, skv, hkv, dh)
    kw = dict(causal=causal, window=window, q_offset=qo)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    # the model layout (B, S, H, dh): the port's plain version against
    # chunked_attention, with a q chunk that leaves a ragged tail
    got = tC.chunked_attention(tq, tk, tv, q_chunk=16, sink=sink, **kw)
    want = jC.chunked_attention(jq, jk, jv, q_chunk=16, sink=sink, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # the kernel layout (B, H, S, dh): the port's wrapper (its plain version
    # on the CPU) against attention_ref and the Pallas kernel in interpret
    # mode (which always takes kv_len = Skv). Neither takes a sink: the JAX
    # package applies it in chunked_attention only, which holds the sink
    # cases here
    hb = [a.transpose(0, 2, 1, 3) for a in (q, k, v)]
    got = tfa.flash_attention(*(torch.tensor(a) for a in hb), sink=sink, **kw)
    if not sink:
        np.testing.assert_allclose(_np(got), _np(jfa_ref.attention_ref(*map(jnp.asarray, hb), **kw)), **F32_TOL)
        np.testing.assert_allclose(_np(got), _np(jfa.flash_attention(*map(jnp.asarray, hb), interpret=True, **kw)),
                                   **F32_TOL)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), _np(want), **F32_TOL)
    if sink and window is not None:  # the sink's keys are seen where the window alone would hide them
        assert not np.allclose(_np(got.transpose(1, 2)), _np(jC.chunked_attention(jq, jk, jv, q_chunk=16, **kw)))


def test_attention_per_row_offsets_and_lengths():
    """The kernel's per-row calling convention: each batch row equals a
    one-row call with its own ``q_offset`` and ``kv_len`` (attention_ref);
    a row that sees no key gives zeros."""
    rng = np.random.default_rng(5)
    b, hq, hkv, sq, skv, dh = 3, 4, 2, 6, 20, 16
    q, k, v = (torch.tensor(_rand(rng, *s)) for s in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)))
    qo, kl = torch.tensor([0, 9, 14]), torch.tensor([6, 15, 0])
    got = tfa.flash_attention(q, k, v, causal=True, q_offset=qo, kv_len=kl)
    for i in range(b):
        want = jfa_ref.attention_ref(*(jnp.asarray(t[i : i + 1].numpy()) for t in (q, k, v)),
                                     causal=True, q_offset=int(qo[i]), kv_len=int(kl[i]))
        np.testing.assert_allclose(_np(got[i : i + 1]), _np(want), **F32_TOL)
    assert not got[2].any()
    plain = tC.chunked_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=True, q_offset=qo, kv_len=kl)
    np.testing.assert_allclose(_np(plain.transpose(1, 2)), _np(got), **F32_TOL)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(6)
    b, hq, hkv, s_max, dh = 3, 8, 2, 24, 16
    q, kc, vc = _rand(rng, b, 1, hq, dh), _rand(rng, b, s_max, hkv, dh), _rand(rng, b, s_max, hkv, dh)
    cur = np.array([1, 13, 24], np.int32)
    got = tC.decode_attention_cp(torch.tensor(q), torch.tensor(kc), torch.tensor(vc), torch.tensor(cur))
    want = jC.decode_attention_cp(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cur))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # the kernel's decode convention gives the same rows
    via = tfa.flash_attention(torch.tensor(q).transpose(1, 2), torch.tensor(kc).transpose(1, 2),
                              torch.tensor(vc).transpose(1, 2), causal=False,
                              q_offset=torch.tensor(cur) - 1, kv_len=torch.tensor(cur))
    np.testing.assert_allclose(_np(via.transpose(1, 2)), _np(want), **F32_TOL)


# ------------------------------------------------------------ the model
def _models(arch: str):
    jcfg = jconfigs.get(arch, smoke=True)
    tcfg = tconfigs.get(arch, smoke=True)
    jparams = japi.build_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tparams.model_params_from_numpy(tcfg, tree, "cpu")


def _assert_logits(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=LOGIT_ATOL)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-32b"])
def test_prefill_and_decode_match_jax(arch):
    jcfg, jparams, tcfg, lm = _models(arch)
    assert tcfg.n_layers == 2
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (2, 21)).astype(np.int32)
    max_len = 32
    jl, jcache = jdense.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tcache = tdense.prefill(tcfg, lm, {"tokens": torch.tensor(toks)}, max_len)
    _assert_logits(tl, jl)
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    for name in ("k", "v"):
        assert tcache[name].shape == jcache[name].shape and tcache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]), rtol=2.0**-7, atol=LOGIT_ATOL)
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jcache = jdense.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt))
        tl, tcache = tdense.decode_step(tcfg, lm, tcache, torch.tensor(nxt))
        _assert_logits(tl, jl)
        np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]), rtol=2.0**-7, atol=LOGIT_ATOL)


def test_hidden_states_match_jax():
    """``_run_layers`` (the datastore pass and the hook's hidden-state
    pass) on a batch of sequences."""
    jcfg, jparams, tcfg, lm = _models("granite-8b")
    toks = np.random.default_rng(8).integers(0, tcfg.vocab, (3, 17)).astype(np.int32)
    jx, _ = jdense._embed_inputs(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    jh = jdense._run_layers(jcfg, jparams, jx, jnp.arange(17), "none")
    tx, _ = tdense._embed_inputs(tcfg, lm, {"tokens": toks})
    th = tdense._run_layers(tcfg, lm, tx, torch.arange(17))
    assert th.dtype == torch.bfloat16 and th.shape == (3, 17, tcfg.d_model)
    # final-normed hidden states are about 1 in size: 4 bf16 ulps of it
    np.testing.assert_allclose(_np(th), _np(jh), rtol=0.0, atol=4 * 2.0**-8 * 4)


def test_decode_cache_is_written_in_place_and_full_cache_raises():
    cfg = tconfigs.get("granite-8b", smoke=True)
    model = tapi.build_model(cfg)
    lm = model.init(1, "cpu")
    toks = torch.tensor([[3, 5, 7]], dtype=torch.int32)
    _, cache = model.prefill(lm, {"tokens": toks}, 4)
    k_before = cache["k"]
    _, cache2 = model.decode_step(lm, cache, torch.tensor([[9]], dtype=torch.int32))
    assert cache2["k"] is k_before and int(cache2["len"][0]) == 4 and int(cache["len"][0]) == 3
    assert cache2["k"][:, 0, 3].abs().sum() > 0
    with pytest.raises(ValueError, match="full"):
        model.decode_step(lm, cache2, torch.tensor([[1]], dtype=torch.int32))


def test_model_looks_up_its_attention_at_each_call(monkeypatch):
    """Prefill, the hidden-state pass and decode reach attention through
    ``common.chunked_attention`` and ``common.decode_attention_cp`` as
    they stand at the call, so a caller can swap them (the card's smoke run
    plants faults in kernel F that way); the loss path keeps its own
    differentiable attention."""
    cfg = tconfigs.get("granite-8b", smoke=True)
    model = tapi.build_model(cfg)
    lm = model.init(0, "cpu")
    toks = torch.tensor([[3, 5, 7, 9]], dtype=torch.int32)
    calls = []
    real_chunked, real_decode = tC.chunked_attention, tC.decode_attention_cp

    def chunked(*a, **kw):
        calls.append("chunked")
        return real_chunked(*a, **kw)

    def decode(*a, **kw):
        calls.append("decode")
        return real_decode(*a, **kw)

    monkeypatch.setattr(tC, "chunked_attention", chunked)
    monkeypatch.setattr(tC, "decode_attention_cp", decode)
    _, cache = model.prefill(lm, {"tokens": toks}, 8)
    model.decode_step(lm, cache, torch.tensor([[1]], dtype=torch.int32))
    tdense._run_layers(cfg, lm, tdense._embed_inputs(cfg, lm, {"tokens": toks})[0], torch.arange(4))
    assert calls == ["chunked"] * cfg.n_layers + ["decode"] * cfg.n_layers + ["chunked"] * cfg.n_layers
    calls.clear()
    model.loss_fn(model.init_masters(0, "cpu"), {"tokens": toks.numpy()})
    assert calls == []
