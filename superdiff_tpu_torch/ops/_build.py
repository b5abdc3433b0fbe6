"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The build
happens at first use, into ``build/kernels/`` at the repository root (listed
in ``.gitignore``; ``SUPERDIFF_TORCH_BUILD_DIR`` overrides it), keyed by a
hash of the source, the shared headers and the compiler flags, so an edited
source rebuilds and an unchanged one loads in milliseconds.

Conventions every kernel library follows:

* pointers and the CUDA stream are passed as ``c_void_p``, ints as
  ``c_int``/``c_longlong``, scalars as ``c_float``;
* every exported launch function returns ``cudaGetLastError()`` and the
  Python wrapper raises :class:`KernelLaunchError` when it is not 0 (a launch
  refused for its configuration never runs, and a later synchronize would
  not report it);
* a missing ``nvcc`` raises — the build never skips silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("sd_fused_step", "flash_attention", "flash_attention_bhld", "geglu_ffn",
           "fused_step")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def build_dir() -> Path:
    env = os.environ.get("SUPERDIFF_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelCompileError(
        f"nvcc not found (PATH or {cuda_home}/bin): the CUDA kernels of "
        "superdiff_tpu_torch are built from source at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one kernel library; returns (process, tmp, target)
    or None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, target


def _finish_build(name: str, started) -> str:
    """Wait for a started build; returns nvcc's output ('' if none ran)."""
    if started is None:
        return ""
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelCompileError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)
    return out


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every kernel library not yet built, one ``nvcc`` per source,
    all started together. Returns each build's compiler output (registers,
    shared memory and spills from ``-Xptxas=-v``)."""
    with _lock:
        started = [(n, _start_build(n)) for n in names]
        return {n: _finish_build(n, s) for n, s in started}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.

    ``signatures`` maps each exported function to ``(restype, argtypes)``;
    they are declared once, when the library is first loaded.
    """
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(
                f"{name}: expected tensors on one CUDA device, got {t.device} "
                f"beside {dev}")
