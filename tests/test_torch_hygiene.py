"""Hygiene of the PyTorch port: it imports neither jax nor the JAX package,
and its entry points never fall back to the CPU silently."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 77  # every module of the slices: checkpoint/, runtime/, models/, serve/, configs/, obs/, stream/, sharding/ and launch/mesh* included


_BANNED = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)|from\s+repro[.\s])", re.M)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py", "examples/torch_quickstart.py", "examples/torch_stream_quickstart.py",
       "examples/torch_icu_pipeline.py"],
)
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    assert not _BANNED.findall(text), f"{path} imports jax or the JAX package"


def test_kernel_sources_exist_for_every_built_library():
    from repro_torch.kernels import _build

    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    # the build directory is ignored by git, never committed
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card behaviour cannot show")
    from repro_torch import api
    from repro_torch.device import resolve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve(None)
    assert resolve("cpu") == torch.device("cpu")
    cfg = api.make_config(m_out=8, L_out=4, m_in=4, L_in=2, k=3, h_max=2, p_max=32)
    data = np.random.default_rng(0).random((64, 8), dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.build(0, data, cfg, api.single())
    index = api.build(0, data, cfg, api.single(), device="cpu")
    assert index.device == torch.device("cpu")


def _family_calls():
    from repro_torch import params
    from repro_torch.core import hashing, pipeline

    gen = torch.Generator().manual_seed(0)
    cfg = pipeline.SLSHConfig.compose(m_out=8, L_out=4, m_in=4, L_in=2, h_max=2)
    outer = dict(dims=np.zeros((4, 8), np.int32), thrs=np.zeros((4, 8), np.float32),
                 salts=np.zeros((4,), np.uint32))
    inner = dict(proj=np.zeros((2, 8, 4), np.float32), salts=np.zeros((2,), np.uint32))
    return {
        "make_family": lambda dev: pipeline.make_family(gen, 8, cfg, dev),
        "make_bitsample": lambda dev: hashing.make_bitsample(gen, 4, 8, 8, 0.0, 1.0, dev),
        "make_signrp": lambda dev: hashing.make_signrp(gen, 2, 4, 8, dev),
        "from_jax_params": lambda dev: params.from_jax_params(outer, inner, dev),
    }


@pytest.mark.parametrize("name", ["make_family", "make_bitsample", "make_signrp", "from_jax_params"])
def test_family_constructors_refuse_to_fall_back_to_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card behaviour cannot show")
    call = _family_calls()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(None)
    leaves = call("cpu")
    leaves = [t for part in (leaves if name in ("make_family", "from_jax_params") else [leaves]) for t in part]
    assert all(t.device == torch.device("cpu") for t in leaves)


def test_unported_deployments_raise_not_implemented(tmp_path):
    """The mesh deployment is ported: where it once raised
    ``NotImplementedError``, the port now refuses what the JAX package
    refuses, with a ``ConfigError``: a mesh deployment without a device
    mesh, and an index saved from a mesh loaded without one."""
    import json

    from repro_torch import api

    # an index saved from a mesh deployment (only its descriptor is read)
    (tmp_path / "dslsh.json").write_text(json.dumps({"format": 1, "cfg": {}, "extra": {}, "deploy": {
        "kind": "mesh", "nu": 2, "p": 2, "replication": 1, "routed": False, "route_bits": 12,
        "reducer": "allgather", "degrade": None, "node_capacity": None, "delta_cap": 64, "retention_s": None}}))
    with pytest.raises(api.ConfigError, match="need the device mesh"):
        api.Deployment(kind="mesh", nu=2, p=2)
    with pytest.raises(api.ConfigError, match="saved from a mesh deployment.*device_mesh="):
        api.load(str(tmp_path), device="cpu")
