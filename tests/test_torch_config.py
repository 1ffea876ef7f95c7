"""The port's configs have the JAX package's fields, defaults and messages.

The one deliberate difference is the backend: the JAX package registers
``"reference"``/``"pallas"`` and defaults to ``"reference"``; the port
registers ``"torch"``/``"cuda"`` and defaults to ``"cuda"``, so a message
naming a backend reads ``'torch'``/``'cuda'`` where the JAX package's reads
``'reference'``/``'pallas'``. ``payload`` takes ``"f32"``, ``"f16"`` and
``"i8"`` in both, with the compressed formats on the fused backend only.
``interpret`` takes only ``None``: the port keeps the field but has no
interpret mode.
"""
from __future__ import annotations

import dataclasses
import warnings

import pytest

from repro.core import pipeline as jp
from repro_torch.core import pipeline as tp

_PAIRS = [
    (jp.FamilyConfig, tp.FamilyConfig),
    (jp.BudgetConfig, tp.BudgetConfig),
    (jp.RuntimeConfig, tp.RuntimeConfig),
    (jp.SLSHConfig, tp.SLSHConfig),
]


@pytest.mark.parametrize("jcls,tcls", _PAIRS, ids=lambda c: c.__name__)
def test_same_fields_and_defaults(jcls, tcls):
    jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (name, jd), (_, td) in zip(jf, tf):
        if name == "backend":
            assert (jd, td) == ("reference", "cuda")
        else:
            assert jd == td, name


_INVALID = [
    ("FamilyConfig", dict(m_out=0)),
    ("FamilyConfig", dict(m_in=0, use_inner=True)),
    ("FamilyConfig", dict(alpha=0.0)),
    ("FamilyConfig", dict(m_out=5, multiprobe=5)),
    ("FamilyConfig", dict(val_lo=3.0, val_hi=3.0)),
    ("BudgetConfig", dict(k=0)),
    ("BudgetConfig", dict(c_max=0)),
    ("BudgetConfig", dict(c_in=0)),
    ("BudgetConfig", dict(h_max=-1)),
    ("BudgetConfig", dict(k=5, c_comp=3)),
    ("BudgetConfig", dict(c_rerank=0)),
    ("RuntimeConfig", dict(query_chunk=0)),
    ("RuntimeConfig", dict(build_mode="eager")),
    ("RuntimeConfig", dict(payload="f64")),
    ("RuntimeConfig", dict(payload="bf16")),
]


@pytest.mark.parametrize("cls,kw", _INVALID, ids=lambda v: str(v))
def test_same_config_error_text(cls, kw):
    with pytest.raises(jp.ConfigError) as je:
        getattr(jp, cls)(**kw)
    with pytest.raises(tp.ConfigError) as te:
        getattr(tp, cls)(**kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize(
    "kw", [dict(h_max=0), dict(bogus_field=1)], ids=["h_max0", "unknown"]
)
def test_same_compose_error_text(kw):
    with pytest.raises(jp.ConfigError) as je:
        jp.SLSHConfig.compose(**kw)
    with pytest.raises(tp.ConfigError) as te:
        tp.SLSHConfig.compose(**kw)
    assert str(te.value) == str(je.value)


_BACKEND_NAMES = {"reference": "torch", "pallas": "cuda"}


def _port_text(jax_text: str) -> str:
    """A JAX message with its backend names turned into the port's."""
    for jname, tname in _BACKEND_NAMES.items():
        jax_text = jax_text.replace(f"'{jname}'", f"'{tname}'")
    return jax_text


@pytest.mark.parametrize(
    "kw",
    [
        dict(payload="f16", backend="reference"),
        dict(payload="i8", backend="reference"),
        dict(payload="f16", backend="pallas", c_rerank=3, k=5),
        dict(payload="i8", backend="pallas", c_rerank=9),
    ],
    ids=["f16_staged", "i8_staged", "f16_short_rerank", "i8_short_rerank"],
)
def test_same_payload_rule_text(kw):
    tkw = {**kw, "backend": _BACKEND_NAMES[kw["backend"]]}
    with pytest.raises(jp.ConfigError) as je:
        jp.SLSHConfig.compose(**kw)
    with pytest.raises(tp.ConfigError) as te:
        tp.SLSHConfig.compose(**tkw)
    assert str(te.value) == _port_text(str(je.value))


def test_backends_and_payload_of_the_port():
    assert tp.SLSHConfig.compose(backend="torch").backend == "torch"
    with pytest.raises(tp.ConfigError, match=r"\['cuda', 'torch'\]"):
        tp.RuntimeConfig(backend="pallas")
    for fmt in ("f32", "f16", "i8"):
        assert tp.RuntimeConfig(payload=fmt).payload == fmt
        assert tp.SLSHConfig.compose(payload=fmt).payload == fmt  # "cuda" by default
    with pytest.raises(tp.ConfigError, match="set backend='cuda' or payload='f32'"):
        tp.SLSHConfig.compose(payload="f16", backend="torch")
    with pytest.raises(tp.ConfigError, match="raise c_rerank to at least k"):
        tp.SLSHConfig.compose(payload="i8", c_rerank=4, k=5)
    # the f32 tail reads no shortlist, so a short c_rerank is no fault there
    assert tp.SLSHConfig.compose(payload="f32", backend="torch", c_rerank=4, k=5).c_rerank == 4


@pytest.mark.parametrize("value", [True, False])
def test_interpret_is_refused_by_the_port(value):
    assert tp.RuntimeConfig().interpret is None
    with pytest.raises(tp.ConfigError, match="no interpret mode"):
        tp.RuntimeConfig(interpret=value)
    with pytest.raises(tp.ConfigError, match="no interpret mode"):
        tp.SLSHConfig.compose(interpret=value)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(multiprobe=2, c_max=64), dict(use_inner=False), dict(L_in=8, c_in=64)],
    ids=["default", "multiprobe", "no_inner", "wide_inner"],
)
def test_same_slot_and_groups(kw):
    jc, tc = jp.SLSHConfig.compose(**kw), tp.SLSHConfig.compose(**kw)
    assert tc.slot == jc.slot
    assert dataclasses.asdict(tc.family) == dataclasses.asdict(jc.family)
    assert dataclasses.asdict(tc.budget) == dataclasses.asdict(jc.budget)
    assert tc.replace(k=3).k == 3


def test_flat_construction_is_deprecated():
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tp.SLSHConfig(m_out=8)
        tp.SLSHConfig.compose(m_out=8)
    assert [w.category for w in rec] == [DeprecationWarning]
