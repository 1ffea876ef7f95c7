"""The port's LM training path against the JAX package on the same inputs.

Weights are the JAX package's own init, carried across with
``repro_torch.params.train_state_from_numpy``; batches are made with
numpy. The JAX side runs jitted, as its train step always does: XLA
compiles a division by a constant as a multiply by the float32 reciprocal
and ``u**4`` as ``(u*u)*(u*u)``, and the port writes those forms.

Tolerances, each with its reason:

* Quantized moments and compressed gradients: the integer ``q`` must be
  equal, and so must their float32 scales on the first update (both sides
  compute the same float32 formula in the same form).
* AdamW on the same gradients: the int8/uint8 ``q`` of the moments
  equal, the float32 moments and block scales within two ulps (rtol
  2^-22; XLA:CPU contracts ``b1 * m + (1 - b1) * g`` into a fused
  multiply-add, which the port writes too, but where it fuses a moment
  into its block's max reduction it may contract it otherwise), the
  parameters within rtol = atol = 1e-6, an ulp or two at their size of
  about 1 (the schedule's ``pow`` and the update's divisions are not in
  XLA's exact form).
* The loss and gradients of the bf16 model: every matmul rounds its
  output to bf16, and XLA:CPU and PyTorch accumulate a bf16 product in
  float32 in different orders, so an element may land one bf16 ulp apart;
  the backward pass's bf16 products carry such flips into the gradients.
  The loss is held to rtol 1e-3, each leaf's gradient to 2^-5 of its
  largest element (four bf16 ulps at that size) and its direction to a
  cosine of at least 0.999.
* Three train steps of a model: AdamW's first update moves each element
  by about ``lr`` whatever its gradient's size, so an element whose
  gradient is near zero may move the other way on the two sides. The
  losses are held to rtol 1e-3, and how far the parameters moved to
  within ``STEP_MOVE_LIMIT`` of how far JAX's moved (readings in the
  test). The same train step on a loss whose gradients are exact on both
  sides holds the error feedback bit for bit and the parameters as
  AdamW's own test does.
* The port against itself (remat policies, restart continuity): bit for
  bit, on the CPU's deterministic kernels.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.runtime import compress as jcompress
from repro.train import loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import params as tparams
from repro_torch.checkpoint import store as tstore
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import dense as tdense
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import compress as tcompress
from repro_torch.runtime import ft as tft
from repro_torch.train import loop as tloop

UPD_TOL = dict(rtol=1e-6, atol=1e-6)
# XLA:CPU with excess precision off rounds every bf16 result where the
# program says (tests/test_torch_families.py): one bf16 ulp otherwise
# flips a moe token's capacity slot and moves the loss by 0.6 %
EXACT = dict(compiler_options={"xla_allow_excess_precision": False})
S_RTOL = 2.0**-22  # two float32 ulps
LOSS_RTOL = 1e-3
GRAD_FRAC, GRAD_COS = 2.0**-5, 0.999
SEQ = 32


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    _build.reset_launches()
    yield
    assert _build.LAUNCHES == {}, "a kernel launched on the CPU"


def _batch(cfg, seed: int, b: int = 4, s: int = SEQ) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32),
                "frame_mask": rng.random((b, s)) < 0.3,
                "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal((b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------ AdamW, compression
@pytest.mark.parametrize("step", [0, 5, 10, 50, 100])
def test_schedule_matches_jax(step):
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=100)
    want = jax.jit(lambda s: jadamw.schedule(jadamw.AdamWConfig(**kw), s))(jnp.int32(step))
    got = tadamw.schedule(tadamw.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-7, atol=0)


def test_adamw_config_equals_jax():
    assert dataclasses.asdict(tadamw.AdamWConfig()) == dataclasses.asdict(jadamw.AdamWConfig())


_QUANT = {
    "moment": (jadamw.quantize_moment, tadamw.quantize_moment, jadamw.dequantize_moment, tadamw.dequantize_moment),
    "moment_pos": (jadamw.quantize_moment_pos, tadamw.quantize_moment_pos, jadamw.dequantize_moment_pos,
                   tadamw.dequantize_moment_pos),
}


@pytest.mark.parametrize("kind", ["moment", "moment_pos"])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantized_moments_equal_jax(kind, axis):
    """Over ten orders of magnitude in a block: equal ``q``, scales and
    dequantized values."""
    jq_fn, tq_fn, jd_fn, td_fn = _QUANT[kind]
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((256, 384)) * 10.0 ** rng.uniform(-9, 0, (256, 384))).astype(np.float32)
    if kind == "moment_pos":
        x = x * x
    jq, js = jax.jit(jq_fn, static_argnums=(1, 2))(jnp.asarray(x), 128, axis)
    tq, ts = tq_fn(torch.tensor(x), 128, axis)
    assert tq.dtype == (torch.int8 if kind == "moment" else torch.uint8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jax.jit(jd_fn, static_argnums=(2, 3))(jq, js, 128, axis)
    np.testing.assert_array_equal(td_fn(tq, ts, 128, axis).numpy(), np.asarray(jd))


def _opt_tree(rng):
    """A stacked (L, d, f) leaf, a matrix, a vector, and ``embed``, which
    gets no gradient (the audio front end never reads it)."""
    return {"layers": {"w": rng.standard_normal((2, 256, 384)).astype(np.float32),
                       "ln": np.ones((2, 384), np.float32)},
            "b": rng.standard_normal((384,)).astype(np.float32),
            "embed": (rng.standard_normal((256, 64)) * 0.02).astype(np.float32)}


@pytest.mark.parametrize("bits", [32, 8])
def test_update_matches_jax(bits):
    """Three updates on the same gradients: the moments (and with 8 bits
    their ``q`` and scales) equal JAX's bit for bit, the parameters within
    ``UPD_TOL``. The gradients' global norm stays under ``clip_norm``, so
    the clip scale is exactly 1 on both sides; above it the scale comes
    from a norm summed in another order, may differ by an ulp, and then
    an int8 count flips wherever a moment sits on a rounding boundary."""
    kw = dict(state_bits=bits, warmup_steps=2, total_steps=10, peak_lr=1e-2)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    rng = np.random.default_rng(bits)
    params = _opt_tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init(jp, jcfg)
    tp = jax.tree.map(torch.tensor, params)
    ts = tadamw.init(tp, tcfg)
    upd = jax.jit(lambda g, s, p: jadamw.update(jcfg, g, s, p))
    quantized = 0
    for step in range(3):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32), params)
        grads["embed"] = np.zeros_like(params["embed"])
        jp, js, jm = upd(jax.tree.map(jnp.asarray, grads), js, jp)
        tg = jax.tree.map(torch.tensor, grads)
        tg["embed"] = None
        tp, ts, tm = tadamw.update(tcfg, tg, ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        assert float(jm["grad_norm"]) < tcfg.clip_norm
        np.testing.assert_allclose(_np(tm["lr"]), np.asarray(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(_np(tm["grad_norm"]), np.asarray(jm["grad_norm"]), rtol=1e-6)
        for name, want in _flat(jp).items():
            np.testing.assert_allclose(_np(_flat(tp)[name]), np.asarray(want), **UPD_TOL, err_msg=name)
        for tree_j, tree_t in ((js.m, ts.m), (js.v, ts.v)):
            for name, want in _flat(tree_j).items():
                got, want = _flat(tree_t)[name], np.asarray(want)
                assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
                if name.endswith("/q"):
                    quantized += 1
                    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
                else:
                    np.testing.assert_allclose(got.numpy(), want, rtol=S_RTOL, atol=0, err_msg=name)
    # the unread embed was decayed, as jax.grad's zeros decay it
    assert not np.array_equal(_np(tp["embed"]), params["embed"])
    assert quantized == (3 * 2 * 4 if bits == 8 else 0)  # w, ln, b and embed each split into blocks of 128


@pytest.mark.parametrize("bits", [32, 8])
def test_moment_layout_equals_jax(bits):
    params = _opt_tree(np.random.default_rng(0))
    js = jadamw.init(jax.tree.map(jnp.asarray, params), jadamw.AdamWConfig(state_bits=bits))
    ts = tadamw.init(jax.tree.map(torch.tensor, params), tadamw.AdamWConfig(state_bits=bits))
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat(js._asdict()).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in _flat(ts._asdict()).items()}
    assert got == want


def test_compress_grads_matches_jax():
    rng = np.random.default_rng(5)
    params = _opt_tree(rng)
    jef = jcompress.init_error_feedback(jax.tree.map(jnp.asarray, params))
    tef = tcompress.init_error_feedback(jax.tree.map(torch.tensor, params))
    comp = jax.jit(jcompress.compress_grads)
    for _ in range(3):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-6, 0)).astype(np.float32),
                             params)
        jg, jef = comp(jax.tree.map(jnp.asarray, grads), jef)
        tg, tef = tcompress.compress_grads(jax.tree.map(torch.tensor, grads), tef)
        for name, g in _flat(grads).items():
            jq, js = jcompress.quantize_int8(jnp.asarray(g) + 0.0)
            tq, ts = tcompress.quantize_int8(torch.tensor(g))
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(_np(_flat(tg)[name]), np.asarray(_flat(jg)[name]), err_msg=name)
            np.testing.assert_array_equal(_np(_flat(tef)[name]), np.asarray(_flat(jef)[name]), err_msg=name)


# ------------------------------------------------------------ loss and gradients
_ARCHS = ["granite-8b", "hubert-xlarge", "phi-3-vision-4.2b"]


@pytest.fixture(scope="module")
def jax_loss_grads():
    """``arch -> (jax params as numpy, batch, loss, grads)``, JAX jitted."""
    out = {}
    for arch in _ARCHS:
        jcfg = jconfigs.get(arch, smoke=True)
        jm = japi.build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        batch = _batch(jcfg, 1)
        loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, _jax_batch(batch))
        out[arch] = (jax.tree.map(np.asarray, jp), batch, float(loss), jax.tree.map(np.asarray, grads))
    return out


def _port_loss_grads(arch, jp, batch, remat=None):
    cfg = tconfigs.get(arch, smoke=True)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    model = tapi.build_model(cfg)
    masters, _ = tparams.train_state_from_numpy(cfg, jp, device="cpu")
    loss, grads = tloop._value_and_grad(model, masters, batch)
    return loss, tloop._unflatten(masters, iter(grads))


def _assert_grads(got: dict, want: dict):
    flat_t, flat_j = _flat(got), _flat(want)
    assert sorted(flat_t) == sorted(flat_j)
    for name, w in flat_j.items():
        g = _np(flat_t[name])
        scale = float(np.abs(w).max())
        if scale == 0.0:  # a leaf the loss never reads: zeros on both sides
            assert not g.any(), name
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_FRAC * scale, err_msg=name)
        cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert cos >= GRAD_COS, (name, cos)


@pytest.mark.parametrize("arch", _ARCHS)
def test_loss_and_grads_match_jax(arch, jax_loss_grads):
    jp, batch, jl, jg = jax_loss_grads[arch]
    loss, grads = _port_loss_grads(arch, jp, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), jl, rtol=LOSS_RTOL)
    _assert_grads(grads, jg)
    if arch == "hubert-xlarge":  # the audio front end never reads embed
        assert not _flat(jg)["embed"].any() and not grads["embed"].any()


@pytest.mark.parametrize("arch", ["granite-8b", "hubert-xlarge"])
def test_remat_policies_give_identical_gradients(arch, jax_loss_grads):
    jp, batch, _, _ = jax_loss_grads[arch]
    ref_loss, ref = _port_loss_grads(arch, jp, batch, "none")
    for remat in ("dots", "full"):
        loss, grads = _port_loss_grads(arch, jp, batch, remat)
        assert torch.equal(loss, ref_loss), remat
        for name, g in _flat(grads).items():
            assert torch.equal(g, _flat(ref)[name]), (remat, name)


class _CountMatmuls(TorchDispatchMode):
    """Counts the matmuls that run (a checkpoint that hands back a kept
    output runs none)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_remat_policies_hold_less_for_the_backward_pass(jax_loss_grads):
    """What autograd keeps for the backward pass shrinks from ``none`` to
    the checkpointed policies, and the backward pass of ``full`` recomputes
    the weight matmuls while ``dots`` keeps their outputs (its backward
    runs as many matmuls as that of ``none``)."""
    jp, batch, _, _ = jax_loss_grads["granite-8b"]
    cfg = tconfigs.get("granite-8b", smoke=True)
    masters, _ = tparams.train_state_from_numpy(cfg, jp, device="cpu")
    leaves = tloop._leaves(masters)
    held, matmuls = {}, {}
    for remat in ("none", "dots", "full"):
        seen: dict[int, int] = {}

        def pack(t):
            seen[id(t)] = t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = tdense.loss_fn(cfg, masters, batch, remat)
        held[remat] = sum(seen.values())
        with _CountMatmuls() as count:
            torch.autograd.grad(loss, leaves, allow_unused=True)
        matmuls[remat] = count.n
    assert held["none"] > max(held["dots"], held["full"]), held
    assert matmuls["none"] == matmuls["dots"] < matmuls["full"], matmuls


def test_chunked_softmax_xent_matches_jax():
    rng = np.random.default_rng(9)
    b, s, d, v = 2, 48, 32, 80
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (rng.standard_normal((d, v)) * d**-0.5).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.7
    from repro.models import common as jC
    from repro_torch.models import common as tC

    want = jC.chunked_softmax_xent(*map(jnp.asarray, (x, head, labels, mask)), seq_chunk=16)
    got = tC.chunked_softmax_xent(*map(torch.tensor, (x, head, labels, mask)), seq_chunk=16)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of the loss chunk"):
        tC.chunked_softmax_xent(*map(torch.tensor, (x, head, labels, mask)), seq_chunk=20)


def test_microbatches_match_the_full_batch(jax_loss_grads):
    """Two microbatches of 2 rows accumulate to the gradient of the 4-row
    batch (each microbatch has as many next-token positions, so the mean
    of their losses is the batch's)."""
    jp, batch, _, _ = jax_loss_grads["granite-8b"]
    full_loss, full = _port_loss_grads("granite-8b", jp, batch)
    cfg = dataclasses.replace(tconfigs.get("granite-8b", smoke=True), microbatches=2)
    model = tapi.build_model(cfg)
    masters, state = tparams.train_state_from_numpy(cfg, jp, device="cpu")
    step = tloop.make_train_step(model, tadamw.AdamWConfig())
    grads_seen = {}
    real_update = tadamw.update

    def spy(cfg_, grads, state_, params_):
        grads_seen.update(_flat(grads))
        return real_update(cfg_, grads, state_, params_)

    tloop.adamw.update = spy
    try:
        _, _, m = step(masters, tadamw.init(masters), batch)
    finally:
        tloop.adamw.update = real_update
    np.testing.assert_allclose(float(m["loss"]), float(full_loss), rtol=LOSS_RTOL)
    _assert_grads({k: v for k, v in grads_seen.items()}, {k: _np(v) for k, v in _flat(full).items()})


# ------------------------------------------------------------ the train step
def _step_cases():
    base = jconfigs.get("granite-8b", smoke=True)
    return {
        "f32": (base, False),
        "f32_compress": (base, True),
        # bf16 masters, 8-bit moments and two microbatches at once
        "bf16_8bit_microbatches": (dataclasses.replace(base, param_dtype="bfloat16", opt_state_bits=8,
                                                       microbatches=2), False),
    }


def _moved_apart(tp: dict, jp, p0: dict) -> float:
    """How far the port's parameters moved from JAX's, as a share of how far
    JAX's moved: ||(p_t - p0) - (p_j - p0)|| / ||p_j - p0||, over all leaves."""
    num = den = 0.0
    for name, want in _flat(jax.tree.map(np.asarray, jp)).items():
        got, want, start = (np.asarray(a, np.float64) for a in (_np(_flat(tp)[name]), _np(want), p0[name]))
        num += float(np.sum((got - want) ** 2))
        den += float(np.sum((want - start) ** 2))
    return (num / den) ** 0.5


STEP_MOVE_LIMIT = 0.1
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
MOMENT_FLIPS = 4


@pytest.mark.parametrize("case", list(_step_cases()))
def test_train_step_matches_jax(case):
    """Three steps of the model's train step, from JAX's init on the same
    batches. The losses are held to ``LOSS_RTOL``; the parameters by how far
    they moved (:func:`_moved_apart`) below ``STEP_MOVE_LIMIT``. The bf16
    gradients differ by ulps between the two sides, and Adam's first steps
    move an element by about ``lr`` whatever its gradient's size, so the
    moves agree only in the large. Readings on the CPU (numpy seeds 10-12):
    0.064 (f32), 0.060 (f32_compress), 0.082 (bf16_8bit_microbatches); a
    port step that skips the compression reads 0.12 against JAX's
    compressed step and one that never writes the parameters 1.0 (a
    step that never writes them, or moves them the wrong way, fails on the
    losses first). The same gradient differences
    change the error-feedback residuals completely (they are each element's
    rounding error), so those are held to JAX's in
    :func:`test_train_step_composition_matches_jax`, on gradients that are
    equal on both sides."""
    jcfg, compress = _step_cases()[case]
    tcfg = tapi.ModelConfig(**dataclasses.asdict(jcfg))
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, state_bits=jcfg.opt_state_bits)
    jopt, topt = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    js = jadamw.init(jp, jopt)
    tp, ts = tparams.train_state_from_numpy(tcfg, jax.tree.map(np.asarray, jp), js, "cpu")
    p0 = {k: np.asarray(v, np.float64) for k, v in _flat(jax.tree.map(np.asarray, jp)).items()}
    assert {t.dtype for t in _flat(tp).values()} == {getattr(torch, jcfg.param_dtype)}
    jstep = jax.jit(jloop.make_train_step(jm, jopt, compress=compress))
    tstep = tloop.make_train_step(tm, topt, compress=compress)
    if compress:
        jef = jcompress.init_error_feedback(jp)
        tef = tcompress.init_error_feedback(tp)
    for i in range(3):
        batch = _batch(tcfg, 10 + i)
        if compress:
            jp, js, jef, jmet = jstep(jp, js, jef, _jax_batch(batch))
            tp, ts, tef, tmet = tstep(tp, ts, tef, batch)
        else:
            jp, js, jmet = jstep(jp, js, _jax_batch(batch))
            tp, ts, tmet = tstep(tp, ts, batch)
        assert set(tmet) == set(jmet) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=0.02)
    assert int(ts.step) == 3
    assert _moved_apart(tp, jp, p0) < STEP_MOVE_LIMIT


def _exact_grad_models(microbatches: int):
    """One loss on both sides whose gradients are exact in float32 and
    bf16, so that the two train steps see equal gradients: the linear
    ``sum(p * mean_b(x))`` over ``layers/w``, ``layers/ln`` and ``b``, with
    ``x`` in small multiples of 2^-12 (a gradient that depended on the
    parameters would differ by their ulps). ``embed`` is never read. The
    gradients' norm stays under ``clip_norm``, so neither side clips."""
    import types

    def jloss(params, batch):
        leaves = {"w": params["layers"]["w"], "ln": params["layers"]["ln"], "b": params["b"]}
        return sum(jnp.sum(p.astype(jnp.float32) * jnp.mean(batch[k], axis=0)) for k, p in leaves.items())

    def tloss(params, batch):
        leaves = {"w": params["layers"]["w"], "ln": params["layers"]["ln"], "b": params["b"]}
        return sum(torch.sum(p.float() * batch[k].mean(0)) for k, p in leaves.items())

    cfg = types.SimpleNamespace(microbatches=microbatches, grad_accum_dtype="float32")
    return types.SimpleNamespace(cfg=cfg, loss_fn=jloss), types.SimpleNamespace(cfg=cfg, loss_fn=tloss)


@pytest.mark.parametrize("dtype,bits,microbatches", [("float32", 32, 1), ("float32", 8, 2), ("bfloat16", 8, 2)])
def test_train_step_composition_matches_jax(dtype, bits, microbatches):
    """The compressed train step (accumulation over microbatches, int8
    compression with error feedback, AdamW) on gradients that are equal on
    both sides: the error-feedback residuals, the quantized moments' ``q``
    and the compressed gradients' effect are JAX's. Residuals are equal bit
    for bit (``compress_grads`` is, on equal inputs), the moments' float32
    values and scales within ``S_RTOL``, and each of their ``q`` equal or
    one count apart, at most ``MOMENT_FLIPS`` counts over the three steps
    (a scale an ulp apart moves a moment that sits on a rounding boundary;
    one count of 589,824 was read in each 8-bit case), the loss and
    the gradients' norm within ``SUM_RTOL`` and ``SUM_ATOL`` (float32 sums
    of 2 x 10^5 terms, taken in other orders; 1.9e-6 relative was read,
    and 2.1e-7 absolute on a loss near zero) and the
    parameters within ``UPD_TOL`` (float32) or one bf16 ulp, 2^-8
    (bf16 masters: an update an ulp apart in float32 may round to the
    other bf16 neighbour)."""
    rng = np.random.default_rng(20 + bits + microbatches)
    params = _opt_tree(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = jax.tree.map(lambda a: torch.tensor(a).to(tdt).requires_grad_(True), params)
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, state_bits=bits)
    jopt, topt = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    js, ts = jadamw.init(jp, jopt), tadamw.init(tp, topt)
    jef, tef = jcompress.init_error_feedback(jp), tcompress.init_error_feedback(tp)
    jmodel, tmodel = _exact_grad_models(microbatches)
    jstep = jax.jit(jloop.make_train_step(jmodel, jopt, compress=True))
    tstep = tloop.make_train_step(tmodel, topt, compress=True)
    ptol = UPD_TOL if dtype == "float32" else dict(rtol=2.0**-8, atol=2.0**-8)
    flips = 0
    for _ in range(3):
        shapes = {"w": params["layers"]["w"].shape, "ln": params["layers"]["ln"].shape, "b": params["b"].shape}
        batch = {k: (rng.integers(-4, 5, (4,) + shape) * 2.0**-12).astype(np.float32) for k, shape in shapes.items()}
        jp, js, jef, jmet = jstep(jp, js, jef, jax.tree.map(jnp.asarray, batch))
        tp, ts, tef, tmet = tstep(tp, ts, tef, {k: torch.tensor(v) for k, v in batch.items()})
        assert float(jmet["grad_norm"]) < topt.clip_norm
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=SUM_RTOL, atol=SUM_ATOL)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=SUM_RTOL)
        for name, want in _flat(jef).items():
            np.testing.assert_array_equal(_np(_flat(tef)[name]), np.asarray(want), err_msg=name)
        for tree_j, tree_t in ((js.m, ts.m), (js.v, ts.v)):
            for name, want in _flat(tree_j).items():
                got, want = _np(_flat(tree_t)[name]), np.asarray(want)
                if name.endswith("/q"):
                    off = np.abs(got.astype(np.int32) - want.astype(np.int32))
                    assert off.max() <= 1, name
                    flips += int(off.sum())
                else:
                    np.testing.assert_allclose(got, want, rtol=S_RTOL, atol=0, err_msg=name)
        for name, want in _flat(jp).items():
            np.testing.assert_allclose(_np(_flat(tp)[name]), _np(want), **ptol, err_msg=name)
    assert flips <= MOMENT_FLIPS
    if dtype == "float32":  # the unread embed was decayed (in bf16 the decay is below an ulp)
        assert not np.array_equal(_np(tp["embed"]), params["embed"])


def test_masters_keep_updates_below_a_bf16_ulp():
    """A float32 master takes an update that bf16 storage would round away
    (the serving model's storage, were it trained)."""
    cfg = tconfigs.get("granite-8b", smoke=True)
    masters = tapi.build_model(cfg).init_masters(0, "cpu")
    w = masters["layers"]["wq"]
    before = w.detach().clone()
    opt = tadamw.AdamWConfig(peak_lr=1e-6, warmup_steps=1, weight_decay=0.0)
    grads = tloop._unflatten(masters, (torch.ones_like(t) for t in tloop._leaves(masters)))
    tadamw.update(opt, grads, tadamw.init(masters, opt), masters)
    assert w.dtype == torch.float32 and bool((w.detach() < before).all())  # every element moved by lr
    rounded = before.to(torch.bfloat16)
    stored = (rounded.float() - 1e-6).to(torch.bfloat16)  # the same step on a bf16 weight
    assert float((stored != rounded).float().mean()) < 0.01


# ------------------------------------------------------------ restart, checkpoints
def test_simulate_training_failure_and_restart_continues_bit_for_bit(tmp_path):
    cfg = tconfigs.get("granite-8b", smoke=True)
    model = tapi.build_model(cfg)
    opt = tadamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)

    def batch_fn(i):
        return _batch(cfg, 100 + i, b=2, s=16)

    before, after = tft.simulate_training_failure_and_restart(model, opt, str(tmp_path), 3, batch_fn, "cpu")
    params = model.init_masters(0, "cpu")
    state = tadamw.init(params, opt)
    step = tloop.make_train_step(model, opt)
    straight = []
    for i in range(6):
        params, state, m = step(params, state, batch_fn(i))
        straight.append(float(m["loss"]))
    assert before == straight[:3] and after == straight[3:]
    assert all(np.isfinite(straight))


_JAX_STEPS: dict = {}
# a dense, a moe and a hybrid tree (hymba's nested segments, olmoe's 4-D
# expert stacks)
CKPT_CASES = [pytest.param(bits, arch, id=str(bits) if arch == "granite-8b" else f"{arch}-{bits}")
              for arch in ("granite-8b", "olmoe-1b-7b", "hymba-1.5b") for bits in (32, 8)]


def _jax_state(jcfg, bits, steps):
    """The JAX package's state after ``steps`` steps; its jitted step is
    compiled once per config and ``bits`` for the checkpoint tests."""
    if (jcfg.name, bits) not in _JAX_STEPS:
        jopt = jadamw.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10, state_bits=bits)
        jm = japi.build_model(jcfg)
        _JAX_STEPS[jcfg.name, bits] = (jopt, jm, jax.jit(jloop.make_train_step(jm, jopt), **EXACT))
    jopt, jm, jstep = _JAX_STEPS[jcfg.name, bits]
    jp = jm.init(jax.random.PRNGKey(0))
    js = jadamw.init(jp, jopt)
    losses = []
    for i in range(steps):
        jp, js, m = jstep(jp, js, _jax_batch(_batch(jcfg, 20 + i)))
        losses.append(float(m["loss"]))
    return jopt, jm, jp, js, jstep, losses


def _from_jax_state(tcfg, jp, js):
    """JAX's state carried into the port. A moe model's second continued
    step starts from it: one step apart, the two sides' parameters differ
    by rounding, and one bf16 ulp can hand a token's capacity slot to
    another token (tests/test_torch_families_train.py), which moves the
    loss past LOSS_RTOL whatever the checkpoint held."""
    return tparams.train_state_from_numpy(tcfg, jax.tree.map(np.asarray, jp), js, "cpu")


@pytest.mark.parametrize("bits,arch", CKPT_CASES)
def test_jax_checkpoint_continues_in_the_port(bits, arch, tmp_path):
    jcfg = jconfigs.get(arch, smoke=True)
    jopt, jm, jp, js, jstep, _ = _jax_state(jcfg, bits, 2)
    jstore.save({"params": jp, "opt": js}, 2, str(tmp_path))
    tcfg = tconfigs.get(arch, smoke=True)
    tm = tapi.build_model(tcfg)
    topt = tadamw.AdamWConfig(**dataclasses.asdict(jopt))
    like_p = tm.init_masters(7, "cpu")
    restored, at = tstore.restore_latest({"params": like_p, "opt": tadamw.init(like_p, topt)}, str(tmp_path), "cpu")
    assert at == 2
    tp, ts = tdense.master_tree(restored["params"]), restored["opt"]
    for name, want in _flat({"params": jax.tree.map(np.asarray, jp), "m": js.m, "v": js.v}).items():
        got = _flat({"params": tp, "m": ts.m, "v": ts.v})[name]
        assert str(got.dtype).replace("torch.", "") == str(np.asarray(want).dtype), name
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=name)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 2
    tstep = tloop.make_train_step(tm, topt)
    for i in range(2, 4):
        batch = _batch(jcfg, 20 + i)
        if i > 2 and tcfg.family == "moe":  # see _from_jax_state
            tp, ts = _from_jax_state(tcfg, jp, js)
        jp, js, jmet = jstep(jp, js, _jax_batch(batch))
        tp, ts, tmet = tstep(tp, ts, batch)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
    assert int(ts.step) == 4


@pytest.mark.parametrize("bits,arch", CKPT_CASES)
def test_port_checkpoint_continues_in_jax(bits, arch, tmp_path):
    jcfg = jconfigs.get(arch, smoke=True)
    jopt, jm, jp0, js0, jstep, _ = _jax_state(jcfg, bits, 0)
    tcfg = tconfigs.get(arch, smoke=True)
    tm = tapi.build_model(tcfg)
    topt = tadamw.AdamWConfig(**dataclasses.asdict(jopt))
    tp, ts = tparams.train_state_from_numpy(tcfg, jax.tree.map(np.asarray, jp0), js0, "cpu")
    tstep = tloop.make_train_step(tm, topt)
    for i in range(2):
        tp, ts, _ = tstep(tp, ts, _batch(jcfg, 20 + i))
    tstore.save({"params": tp, "opt": ts}, 2, str(tmp_path))
    restored, at = jstore.restore_latest({"params": jp0, "opt": js0}, str(tmp_path))
    assert at == 2
    jp, js = restored["params"], restored["opt"]
    hp, hs = tparams.train_state_to_numpy(tp, ts)
    for name, want in _flat({"params": hp, "m": hs.m, "v": hs.v}).items():
        got = np.asarray(_flat({"params": jp, "m": js.m, "v": js.v})[name])
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert np.asarray(js.step).dtype == np.int32 and int(js.step) == 2
    for i in range(2, 4):
        batch = _batch(jcfg, 20 + i)
        if i > 2 and tcfg.family == "moe":  # see _from_jax_state
            tp, ts = _from_jax_state(tcfg, jp, js)
        jp, js, jmet = jstep(jp, js, _jax_batch(batch))
        tp, ts, tmet = tstep(tp, ts, batch)
        np.testing.assert_allclose(float(jmet["loss"]), float(tmet["loss"]), rtol=LOSS_RTOL)
    assert int(js.step) == 4


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("arch", ["hubert-xlarge", "granite-8b", "phi-3-vision-4.2b", "olmoe-1b-7b",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-780m", "hymba-1.5b"])
def test_launch_train_smoke_on_the_cpu(arch, tmp_path, capsys):
    history = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert len(history) == 3 and all(np.isfinite(h["loss"]) for h in history)
    out = capsys.readouterr().out
    assert "final loss:" in out and f"arch={tconfigs.get(arch, True).name}" in out
    assert tstore.latest_step(str(tmp_path)) == 2
    # a second run resumes from the checkpoint and takes the last step
    again = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
                          "--ckpt-dir", str(tmp_path)])
    assert "resumed at step 2" in capsys.readouterr().out and len(again) == 1


def test_launch_train_refusals():
    with pytest.raises(SystemExit, match="FULL configs need real accelerators"):
        tlaunch.main(["--arch", "hubert-xlarge", "--device", "cpu"])
    with pytest.raises(SystemExit, match="ROADMAP"):
        tlaunch.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--mesh", "single-pod"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlaunch.main(["--arch", "granite-8b", "--smoke"])


def test_launch_train_audio_batches_follow_the_step_seed():
    cfg = tconfigs.get("hubert-xlarge", smoke=True)
    toks = np.zeros((3, 20), np.int32)
    a, b = (tlaunch.make_batch(cfg, toks, 4, torch.device("cpu")) for _ in range(2))
    c = tlaunch.make_batch(cfg, toks, 5, torch.device("cpu"))
    assert set(a) == {"frames", "frame_mask", "targets"}
    assert a["frames"].shape == (3, 20, cfg.frontend_dim) and a["targets"].dtype == torch.int32
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["frames"], c["frames"])
    assert 0.1 < float(a["frame_mask"].float().mean()) < 0.5


def test_flash_attention_refuses_inputs_that_require_gradients():
    """Kernel F has no backward pass: off the CPU, q, k or v requiring
    gradients under grad mode is refused before any launch (a meta tensor
    stands for the card's here)."""
    q = torch.empty((1, 2, 8, 16), dtype=torch.bfloat16, device="meta", requires_grad=True)
    k = torch.empty((1, 2, 8, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="no backward pass"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward pass"):
        tfa.flash_attention(k, k, q)


def test_serving_model_from_masters_equals_the_carried_weights(jax_loss_grads):
    """Trained masters served through ``DenseLM``: the same logits as the
    JAX tree carried across for serving, frozen, and a copy."""
    jp, _, _, _ = jax_loss_grads["granite-8b"]
    cfg = tconfigs.get("granite-8b", smoke=True)
    model = tapi.build_model(cfg)
    masters, _ = tparams.train_state_from_numpy(cfg, jp, device="cpu")
    lm = model.serving(masters)
    ref = tparams.model_params_from_numpy(cfg, jp, "cpu")
    assert all(not p.requires_grad for p in lm.parameters())
    toks = torch.tensor(_batch(cfg, 3, b=2, s=12)["tokens"])
    got, _ = model.prefill(lm, {"tokens": toks}, 16)
    want, _ = model.prefill(ref, {"tokens": toks}, 16)
    assert torch.equal(got, want)
    with torch.no_grad():
        masters["layers"]["wq"].add_(1.0)
    assert torch.equal(model.prefill(lm, {"tokens": toks}, 16)[0], want)


def test_input_defs_and_cells_match_jax():
    for arch in ("hubert-xlarge", "phi-3-vision-4.2b", "granite-8b"):
        jm, tm = japi.build_model(jconfigs.get(arch)), tapi.build_model(tconfigs.get(arch))
        assert tapi.SHAPE_CELLS == japi.SHAPE_CELLS
        for cell in tapi.SHAPE_CELLS:
            assert tapi.cell_skip_reason(tm.cfg, cell) == japi.cell_skip_reason(jm.cfg, cell)
            want = {k: (shape, np.dtype(dtype).name) for k, (shape, dtype, _) in jm.input_defs(cell).items()}
            got = {k: (shape, str(dtype).replace("torch.", "")) for k, (shape, dtype) in tm.input_defs(cell).items()}
            assert got == want, (arch, cell)
    # build_model casts float32 defs to param_dtype, as the JAX handle does
    cfg = dataclasses.replace(tconfigs.get("granite-8b", True), param_dtype="bfloat16")
    assert {p.dtype for p in _flat(tapi.build_model(cfg).defs).values()} == {torch.bfloat16}
    masters = tapi.build_model(cfg).init_masters(0, "cpu")
    assert all(t.dtype == torch.bfloat16 and t.requires_grad for t in _flat(masters).values())
