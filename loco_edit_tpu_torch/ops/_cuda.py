"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The kernels have plain C entry points and are bound with ctypes: no PyTorch
headers are compiled, so a build takes seconds. Each source is compiled to an
object file by its own `nvcc` process, all started together, and the objects
are linked into one `.so` in the build directory (core/cache.py::build_dir,
by default `loco_edit_tpu_torch/_build/` in a checkout), named by a hash of
the sources so that an edited source is rebuilt. Nothing is built when the
package is imported: the first launch builds, or a caller does so up front
with `load_library()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from loco_edit_tpu_torch.core.cache import build_dir

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""          # nvcc's output (ptxas register/spill report)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "loco_group_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                        _I, _P],
    "loco_group_norm_sums": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "loco_group_norm_apply": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I,
                              _I, _I, _P],
    "loco_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 12
                            + [_F, _I, _P],
    "loco_conv_split": [_P, _P, _P, _L, _L, _L, _P],
}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _run_all(cmds: list[list[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(logs)


def _build(so_path: str) -> None:
    global build_log
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.endswith(".cu")]
    tag = os.path.basename(so_path)[:-3]
    objs = [os.path.join(os.path.dirname(so_path), f"{tag}-{os.getpid()}-{os.path.basename(s)[:-3]}.o")
            for s in cu]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                    for s, o in zip(cu, objs)])
    tmp = f"{so_path}.{os.getpid()}.tmp"
    log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                      "-shared", *objs, "-o", tmp]])
    os.replace(tmp, so_path)   # atomic: a concurrent process never loads half a file
    for o in objs:
        os.remove(o)
    build_log = log


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha1()
        for s in _sources():
            with open(s, "rb") as f:
                h.update(os.path.basename(s).encode() + f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        so_path = os.path.join(build_dir(), f"libloco_kernels-{h.hexdigest()[:12]}.so")
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def stream_of(t: torch.Tensor) -> int:
    """The raw cudaStream_t of the current stream on t's device."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
