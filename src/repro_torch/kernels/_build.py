"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
with a plain C interface under ``build/repro_torch_kernels/`` at the root of
the checkout (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources, so an edited kernel is
rebuilt and a stale one is never loaded. :func:`build` starts one nvcc per
missing library, all at once, and waits for them together; ptxas's register
and spill report lands in ``<name>-<hash>.log`` beside the library.

Every wrapper counts its launches in :data:`LAUNCHES` (one per launch of its
kernel, nowhere else), so a run can show which kernels its path went
through. A launch in a mode of its own (``bitsample_pack`` with margins,
``query_tail_payload`` per payload format) also counts under
``"<kernel>.<mode>"``.

Each library compiled here also bumps the public retrace counter
(:func:`repro_torch.obs.metrics.count_retrace`, stage = the library's
name): a build is the port's only compile step, what a jit trace is to the
JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.obs import metrics as obs_metrics

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("hash_pack", "l1_topk", "query_fused", "query_payload", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: dict[str, int] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def count_launch(kernel: str) -> None:
    """Record one launch of ``kernel``."""
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def reset_launches() -> None:
    """Set every launch count to 0."""
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA"
            " kernels build from csrc/ at first use on a machine with the"
            " CUDA toolkit"
        )
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, with one
    nvcc process per source running together; raise if any fails."""
    paths = {name: _lib_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        todo[name].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, todo[name])
        obs_metrics.count_retrace(name)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built at first use), with
    ``argtypes`` set from ``signatures`` and an ``int`` CUDA error result."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error; count it otherwise."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
    count_launch(kernel)


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


PTR = ctypes.c_void_p  # every pointer and the stream (ctypes would cut an int)
INT = ctypes.c_int
