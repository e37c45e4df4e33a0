"""Build and bind the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` file exports a plain C function per kernel. At first use
the sources are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc`` process
per source, all started together), linked into one shared library and
loaded with ``ctypes``. The library lands in ``transfusion_torch/_build/``
(listed in ``.gitignore``) under a name that carries the hash of the sources
and flags, so a later call with unchanged sources reuses it.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
The wrappers in ``ops/`` count their launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel launches per wrapper since the last ``LAUNCHES.clear()`` (a plain integer each).
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
# Dropout arguments of the attention entries: seed (uint32), keep threshold
# (uint32), 1 / (1 - rate), dropout on (int).
_DROP = [_U, _U, _F, _I]
_SIGNATURES = {
    # x, residual (or NULL), weight, bias, out, rows, d, rows per batch of x,
    # batch stride of x (elements), eps, is_bf16, stream
    "tf_layer_norm": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _F, _I, _P],
    # q, k, v, key bias [B, N] f32, out, stats [B, H, N, 2] f32, B, N, H, D,
    # scale, is_bf16, dropout..., stream
    "tf_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, *_DROP, _P],
    # q, k, v, key bias [B, N] f32, out, B, N, H, D, element strides of
    # batch / position / head, scale, is_bf16, stream
    "tf_self_attention": [_P] * 5 + [_I] * 4 + [_L] * 3 + [_F, _I, _P],
    # q, k, v, o, dout, key bias, stats, D rows [B, H, N] f32 (written), dq,
    # B, N, H, D, scale, is_bf16, dropout..., stream
    "tf_attention_bwd_dq": [_P] * 9 + [_I, _I, _I, _I, _F, _I, *_DROP, _P],
    # q, k, v, o, dout, key bias, stats, D rows (read), dk, dv, B, N, H, D,
    # scale, is_bf16, dropout..., stream
    "tf_attention_bwd_dkv": [_P] * 10 + [_I, _I, _I, _I, _F, _I, *_DROP, _P],
    # packed pyramid, per-RoI floats [B, R, 8], per-RoI ints [B, R, 4], out,
    # B, R, H_tot, W_max, C, P, is_bf16, stream
    "tf_roi_align_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # grad_out [B, R, P, P, C], per-RoI floats, per-RoI ints, grad
    # [B, H_tot, W_max, C] in the pyramid's dtype (every cell written),
    # B, R (0 allowed), H_tot, W_max, C, P, is_bf16, stream
    "tf_roi_align_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
BUILD_LOG: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no kernel sources under {CSRC}")
    return srcs


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernel library if its sources changed; return its path."""
    srcs = _sources()
    tag = _digest(srcs)
    lib_path = os.path.join(BUILD_DIR, f"libtransfusion_kernels_{tag}.so")
    if os.path.exists(lib_path):
        BUILD_LOG.update(path=lib_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in srcs:
        # Per process: ranks that build at once do not write one object.
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.{os.getpid()}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = {}, []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs[os.path.basename(src)] = out
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"kernel library link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    BUILD_LOG.update(path=lib_path, seconds=time.perf_counter() - t0, cached=False, ptxas=logs)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
