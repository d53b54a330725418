"""Builds and loads the hand-written CUDA kernels of ``zkmpc_tpu_torch/csrc``.

The kernels have a plain C interface and are compiled by ``nvcc`` into one
shared library, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The build happens at first use, into
``<repo>/build/zkmpc_tpu_torch/<hash>/``, keyed by a hash of the ``csrc``
sources and the compiler flags: a changed source rebuilds.  A failed build
raises.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build", "zkmpc_tpu_torch")
LIB_NAME = "libzkmpc_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None


def reset_launches():
    LAUNCHES.clear()


def _sources():
    names = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC_DIR, f) for f in names]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library path.  The compiler's register/spill report is kept in
    ``ptxas.log`` beside it."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    cu = [p for p in _sources() if p.endswith(".cu")]
    cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC_DIR, "-o", tmp] + cu
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.zk_mont_mul.argtypes = [i, p, p, i, p, p, i64, p]
            lib.zk_mont_mul.restype = i
            lib.zk_point_add.argtypes = [i, i, p, p, p, p, p, p, p, i64, p]
            lib.zk_point_add.restype = i
            _lib = lib
    return _lib


def check(rc: int, what: str):
    """Raise on a nonzero ``cudaGetLastError`` code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
