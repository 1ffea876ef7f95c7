"""The port's training path of the moe, ssm and hybrid LM families against
the JAX package on the same inputs.

Weights are the JAX package's own init, carried across with
``repro_torch.params.train_state_from_numpy`` (hymba's nested segments and
the moe expert stacks included); batches are made with numpy. The JAX
side is jitted with ``xla_allow_excess_precision`` off (``EXACT``), as
``test_torch_families.py`` runs it, so every bf16 result is rounded where
the program says.

Tolerances, each with its reason:

* The loss: rtol ``LOSS_RTOL`` (1e-3), as ``test_torch_train.py`` holds the
  dense family's.
* Gradients: XLA:CPU and PyTorch accumulate a bf16 product in float32 in
  different orders, so an element may land a bf16 ulp apart, which every
  later bf16 product carries on. The SSD and hymba's two heads sum many
  such elements with cancellation, so a small leaf (hymba's ``dt_bias``,
  eight elements of up to 0.003) moves by a larger share of itself than
  the dense family's leaves do. JAX's own gradient moves as far when it
  is compiled with excess precision allowed (its default): readings up to
  0.104 of a leaf's largest element (hymba-smoke) against the port's
  0.126. Each leaf is therefore held to ``GRAD_FRAC`` (2^-5) of its largest
  element plus twice the gap between JAX's two compilations of that leaf,
  and its cosine to ``GRAD_COS`` (0.999) less twice that gap's
  shortfall from 1. Readings: olmoe 0.0065, phi3.5-moe 0.0042, mamba2
  0.018 of a leaf's largest element (inside 2^-5 alone); hymba up to 0.126
  against a bound of at least 0.18 there.
* Train steps: JAX takes the first step from its init, and the state
  crosses into the port; then three steps, each from the same state on
  both sides (the port's state carried back into JAX before each). Adam's
  first update is about ``lr`` times the sign of each gradient element, so
  an element whose gradient is rounding noise moves either way: from a
  common init, JAX's two compilations sit 0.11-0.18 apart after it
  (mamba2, hymba, olmoe with bf16 masters), and moe routing then diverges
  by whole tokens (a capacity slot decided by scores of 0.4997 and
  0.4996). Each later step is held: the loss to ``LOSS_RTOL``, the
  learning rate to 1e-7, the gradient norm to 0.02 and how far the
  parameters moved apart to ``STEP_MOVE_LIMIT`` (0.1) of how far JAX's
  moved. Readings: at most 0.045 (hymba), 0.031 (mamba2), 0.030 (olmoe
  bf16/8-bit), 0.010 (olmoe), 0.007 (phi3.5-moe).
* ``chunked_attention_train`` with a sink, float32 in and out: values and
  gradients within rtol 1e-5 / atol 1e-6 of JAX's (the same sums in
  another order).
* The SSD repair: the port's gradients within 1e-4 of the largest element
  of the float64 gradient of ``ssd_reference``, the exact recurrence
  (readings about 2e-6).
* The port against itself (remat policies): bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import common as jC
from repro.models import mamba2 as jmamba2
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch import params as tparams
from repro_torch.kernels import _build
from repro_torch.models import api as tapi
from repro_torch.models import common as tC
from repro_torch.models import mamba2 as tmamba2
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop as tloop

EXACT = dict(compiler_options={"xla_allow_excess_precision": False})
LOSS_RTOL = 1e-3
GRAD_FRAC, GRAD_COS = 2.0**-5, 0.999
STEP_MOVE_LIMIT = 0.1
SEQ = 32
# loss-and-gradient cases: (arch, config overrides)
LOSS_CASES = {
    "olmoe": ("olmoe-1b-7b", {}),
    "olmoe_aux0": ("olmoe-1b-7b", dict(aux_loss_coef=0.0)),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {}),
    "mamba2": ("mamba2-780m", {}),
    "hymba": ("hymba-1.5b", {}),
}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


def _batch(vocab: int, seed: int, b: int = 4, s: int = SEQ) -> dict:
    return {"tokens": np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)}


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _cfgs(arch: str, **overrides):
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), **overrides)
    return jcfg, tapi.ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    _build.reset_launches()
    yield
    assert _build.LAUNCHES == {}, "a kernel launched on the CPU"


# ------------------------------------------------------------ loss and gradients
@pytest.fixture(scope="module")
def jax_loss_grads():
    """``case -> (jax params as numpy, batch, loss, grads, grads with excess
    precision)``; the JAX loss jitted both ways."""
    out = {}
    for case, (arch, kw) in LOSS_CASES.items():
        jcfg, _ = _cfgs(arch, **kw)
        jm = japi.build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        batch = _batch(jcfg.vocab, 1)
        vg = jax.value_and_grad(jm.loss_fn)
        loss, grads = jax.jit(vg, **EXACT)(jp, _jax_batch(batch))
        _, gap = jax.jit(vg)(jp, _jax_batch(batch))
        out[case] = (jax.tree.map(np.asarray, jp), batch, float(loss), _flat(jax.tree.map(_np, grads)),
                     _flat(jax.tree.map(_np, gap)))
    return out


def _port_loss_grads(case: str, jp, batch, remat=None):
    arch, kw = LOSS_CASES[case]
    _, tcfg = _cfgs(arch, **kw)
    if remat is not None:
        tcfg = dataclasses.replace(tcfg, remat=remat)
    masters, _ = tparams.train_state_from_numpy(tcfg, jp, device="cpu")
    loss, grads = tloop._value_and_grad(tapi.build_model(tcfg), masters, batch)
    return loss, _flat(tloop._unflatten(masters, iter(grads)))


def _cos(a, b) -> float:
    return float((a.astype(np.float64) * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _assert_grads(got: dict, want: dict, gap: dict):
    """Each leaf within ``GRAD_FRAC`` of its largest element plus twice JAX's
    own gap there, and its cosine within twice that gap's shortfall of
    ``GRAD_COS`` (the module docstring)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = _np(got[name])
        scale = float(np.abs(w).max())
        assert scale > 0.0, name  # every leaf of these families is read by the loss
        atol = GRAD_FRAC * scale + 2 * float(np.abs(gap[name] - w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
        floor = GRAD_COS - 2 * (1.0 - _cos(gap[name], w))
        assert _cos(g, w) >= floor, (name, _cos(g, w), floor)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_jax(case, jax_loss_grads):
    """The loss, moe's aux term included (at aux_loss_coef 0.01 and 0), and
    the gradient of every master leaf: hymba's meta tokens and nested
    segments, the 4-D expert stacks and the router."""
    jp, batch, jl, jg, gap = jax_loss_grads[case]
    loss, grads = _port_loss_grads(case, jp, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), jl, rtol=LOSS_RTOL)
    _assert_grads(grads, jg, gap)


def test_moe_aux_term_is_in_the_loss(jax_loss_grads):
    """The aux term moves the loss by ``aux_loss_coef`` times the layers'
    mean aux loss (each about 1 at init), on both sides alike."""
    with_aux = float(_port_loss_grads("olmoe", *jax_loss_grads["olmoe"][:2])[0])
    without = float(_port_loss_grads("olmoe_aux0", *jax_loss_grads["olmoe_aux0"][:2])[0])
    want = jax_loss_grads["olmoe"][2] - jax_loss_grads["olmoe_aux0"][2]
    assert 0.005 < with_aux - without < 0.02
    np.testing.assert_allclose(with_aux - without, want, rtol=1e-3)


@pytest.mark.parametrize("case", ["olmoe", "mamba2", "hymba"])
def test_remat_policies_give_identical_gradients(case, jax_loss_grads):
    """``none``, ``dots`` and ``full`` recompute the same routing, SSD and
    attention: the loss and every gradient bit for bit."""
    jp, batch = jax_loss_grads[case][:2]
    ref_loss, ref = _port_loss_grads(case, jp, batch, "none")
    for remat in ("dots", "full"):
        loss, grads = _port_loss_grads(case, jp, batch, remat)
        assert torch.equal(loss, ref_loss), remat
        for name, g in grads.items():
            assert torch.equal(g, ref[name]), (remat, name)


# ------------------------------------------------------------ the train step
STEP_CASES = {
    "olmoe": ("olmoe-1b-7b", {}),
    "olmoe_bf16_8bit": ("olmoe-1b-7b", dict(param_dtype="bfloat16", opt_state_bits=8)),
    "phi3.5-moe_microbatches": ("phi3.5-moe-42b-a6.6b", dict(microbatches=2)),
    "mamba2": ("mamba2-780m", {}),
    "hymba_microbatches": ("hymba-1.5b", dict(microbatches=2)),
}


def _moved_apart(tp: dict, jp, p0: dict) -> float:
    """||(p_t - p0) - (p_j - p0)|| / ||p_j - p0|| over all leaves: how far the
    port's parameters moved from JAX's, as a share of how far JAX's moved."""
    num = den = 0.0
    flat_t = _flat(tp)
    for name, want in _flat(jax.tree.map(_np, jp)).items():
        got, want, start = (np.asarray(a, np.float64) for a in (_np(flat_t[name]), want, p0[name]))
        num += float(np.sum((got - want) ** 2))
        den += float(np.sum((want - start) ** 2))
    return (num / den) ** 0.5


def _into_jax(tp, ts, jp, js):
    """The port's masters and AdamW state as JAX's tree, in JAX's dtypes."""
    hp, hs = tparams.train_state_to_numpy(tp, ts)

    def cast(a, like):
        return jnp.asarray(np.asarray(a), like.dtype)

    return jax.tree.map(cast, hp, jp), jadamw.AdamWState(jax.tree.map(cast, hs.m, js.m),
                                                         jax.tree.map(cast, hs.v, js.v), jnp.int32(hs.step))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    """JAX's first step from its init, then three steps of
    ``make_train_step`` against JAX's jitted step from the same state
    (module docstring): losses, learning rate, gradient norm and the
    parameters' moves; the port's masters keep ``param_dtype`` and the
    8-bit moments of the 4-D expert stacks JAX's layout throughout. A
    step that never writes the parameters reads 1.0."""
    arch, kw = STEP_CASES[case]
    jcfg, tcfg = _cfgs(arch, **kw)
    okw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, state_bits=jcfg.opt_state_bits)
    jopt, topt = jadamw.AdamWConfig(**okw), tadamw.AdamWConfig(**okw)
    jm = japi.build_model(jcfg)
    jstep = jax.jit(jloop.make_train_step(jm, jopt), **EXACT)
    tstep = tloop.make_train_step(tapi.build_model(tcfg), topt)
    jp = jm.init(jax.random.PRNGKey(0))
    jp, js, _ = jstep(jp, jadamw.init(jp, jopt), _jax_batch(_batch(jcfg.vocab, 10)))
    tp, ts = tparams.train_state_from_numpy(tcfg, jax.tree.map(np.asarray, jp), js, "cpu")
    moment_layout = {k: (t.dtype, tuple(t.shape)) for k, t in _flat({"m": ts.m, "v": ts.v}).items()}
    assert moment_layout == {k: (getattr(torch, str(np.asarray(a).dtype)), np.shape(a))
                             for k, a in _flat({"m": js.m, "v": js.v}).items()}
    moves = []
    for i in range(1, 4):
        jp, js = _into_jax(tp, ts, jp, js)
        p0 = {k: np.asarray(v, np.float64) for k, v in _flat(jax.tree.map(_np, jp)).items()}
        batch = _batch(jcfg.vocab, 10 + i)
        jp, js, jmet = jstep(jp, js, _jax_batch(batch))
        tp, ts, tmet = tstep(tp, ts, batch)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=0.02)
        moves.append(_moved_apart(tp, jp, p0))
    assert int(ts.step) == 4
    assert {t.dtype for t in _flat(tp).values()} == {getattr(torch, jcfg.param_dtype)}
    assert {k: (t.dtype, tuple(t.shape)) for k, t in _flat({"m": ts.m, "v": ts.v}).items()} == moment_layout
    assert max(moves) < STEP_MOVE_LIMIT, moves


# ------------------------------------------------------------ hymba's sink in training
def test_chunked_attention_train_with_a_sink_matches_jax():
    """hymba's sliding-window training attention: window 16, the first 8 keys
    (the meta tokens) always visible, 40 positions, under grad (float32, so
    both sides run the same arithmetic up to the order of sums)."""
    rng = np.random.default_rng(3)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32)
                    for shape in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16), (2, 40, 4, 16)))
    kw = dict(causal=True, window=16, q_chunk=8)

    def jax_f(q, k, v, sink):
        return jnp.sum(jC.chunked_attention(q, k, v, sink=sink, **kw) * cot)

    def port(sink):
        qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = tC.chunked_attention_train(qt, kt, vt, sink=sink, **kw)
        grads = torch.autograd.grad(torch.sum(out * torch.tensor(cot)), (qt, kt, vt))
        return out.detach(), grads

    want = jC.chunked_attention(*map(jnp.asarray, (q, k, v)), sink=8, **kw)
    want_g = jax.grad(jax_f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)), 8)
    out, grads = port(8)
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-5, atol=1e-6)
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)
    # the sink bites at these shapes: without it the keys below 8 drop out
    # of every query past position 23
    no_sink = port(0)[0]
    assert float((no_sink - out).abs().max()) > 0.1


# ------------------------------------------------------------ the SSD repair
def _overflow_inputs():
    """Chunk 128, dt 0.8 and A = -1: above the diagonal of a chunk the
    decay's exponent sums up to 127 * 0.8 = 101.6, past float32's exp range
    (88.7)."""
    rng = np.random.default_rng(7)
    b, s, h, p, n = 1, 256, 4, 8, 8
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 0.8, np.float32)
    a = np.full((h,), -1.0, np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    cot = rng.standard_normal((b, s, h, p)).astype(np.float32)
    return (xh, dt, a, bm, cm), cot


def test_ssd_chunked_gradient_is_finite_where_the_reference_overflows():
    """The JAX package's ``ssd_chunked`` computes ``where(causal, exp(li),
    0)``: its forward pass drops the overflowed ``inf`` but its backward
    pass multiplies it by 0, so ``dt``'s and ``A``'s gradients are not
    finite (a fault of the reference, ROADMAP.md Queue 3). The port masks
    before the exp: the same forward output (``where(causal, li, -inf)``
    gives exp's +0 where the reference writes 0) and finite gradients,
    within 1e-4 of the largest element of ``ssd_reference``'s in
    float64."""
    ins, cot = _overflow_inputs()

    def jax_loss(*args):
        return jnp.sum(jmamba2.ssd_chunked(*args, 128)[0] * cot)

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrads[1:3])  # the reference's fault, pinned

    def port_grads(fn, dtype):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in ins]
        y = fn(*ts)[0]
        return y, torch.autograd.grad(torch.sum(y * torch.tensor(cot, dtype=dtype)), ts)

    y, grads = port_grads(lambda *t: tmamba2.ssd_chunked(*t, 128), torch.float32)
    ry, rgrads = port_grads(tmamba2.ssd_reference, torch.float64)
    jy = jmamba2.ssd_chunked(*map(jnp.asarray, ins), 128)[0]
    jy = _np(jy)  # the forward is the reference's
    np.testing.assert_allclose(_np(y), jy, rtol=0, atol=1e-4 * float(np.abs(jy).max()))
    for name, g, r in zip(("xh", "dt", "A", "B", "C"), grads, rgrads):
        assert bool(torch.isfinite(g).all()), name
        r = r.numpy()
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=1e-4 * float(np.abs(r).max()), err_msg=name)


def test_masked_decay_equals_the_unmasked_form_bit_for_bit():
    """``exp(where(causal, li, -inf))`` and ``where(causal, exp(li), 0)`` are
    equal element for element, overflowing exponents above the diagonal
    included, so the repair leaves every serving reading as it was."""
    li = torch.tensor(np.random.default_rng(2).uniform(-200.0, 200.0, (64, 64)).astype(np.float32))
    causal = torch.tril(torch.ones((64, 64), dtype=torch.bool))
    masked = torch.exp(torch.where(causal, li, float("-inf")))
    plain = torch.where(causal, torch.exp(li), 0.0)
    assert bool(torch.isinf(torch.exp(li[~causal])).any())
    assert torch.equal(masked, plain) and not bool(torch.signbit(masked).any())
