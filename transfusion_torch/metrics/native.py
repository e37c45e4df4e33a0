"""ctypes binding of the native STA matcher (port of
``transfusion_tpu/metrics/native.py``).

The source is the repository's ``native/sta_match.cpp``. At first use it is
compiled with the host C++ compiler (``$CXX``, else ``g++`` or ``c++``) into
``transfusion_torch/_build/`` under a name that carries the hash of the
source and flags, and loaded with ``ctypes``. Without a compiler or the
source, :func:`sta_match_native` returns None and the metric keeps its numpy
matcher. This is a host helper, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "sta_match.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# No FMA contraction: the IoU is then the numpy matcher's to the last bit.
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared"]

_lock = threading.Lock()
_state: dict = {}


def _compiler() -> str | None:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def _build() -> str | None:
    """The shared library's path, compiling it once; None where it cannot be
    built."""
    cxx = _compiler()
    if cxx is None or not os.path.isfile(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libsta_match_{key}.so")
    if os.path.isfile(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, so_path)  # atomic: concurrent builders each publish a whole library
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def _load():
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        lib = None
        so_path = _build()
        if so_path is not None:
            try:
                lib = ctypes.CDLL(so_path)
            except OSError:
                lib = None
        if lib is not None:
            d = ctypes.POINTER(ctypes.c_double)
            lib.sta_match.argtypes = [d, d, d, d, d, ctypes.c_int,
                                      d, d, d, d, ctypes.c_int,
                                      ctypes.c_double, ctypes.c_double, d]
            lib.sta_match.restype = None
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def sta_match_native(pred_boxes, scores, nouns, verbs, ttcs,
                     gt_boxes, gt_nouns, gt_verbs, gt_ttcs,
                     iou_threshold: float, ttc_threshold: float) -> np.ndarray | None:
    """Returns tp [N, 8] or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None

    def arr(x, shape=None):
        a = np.ascontiguousarray(np.asarray(x, np.float64))
        return a.reshape(shape) if shape is not None else a

    pb = arr(pred_boxes, (-1, 4))
    n = len(pb)
    gb = arr(gt_boxes, (-1, 4))
    g = len(gb)
    sc, pn, pv, pt = arr(scores), arr(nouns), arr(verbs), arr(ttcs)
    gn, gv, gt = arr(gt_nouns), arr(gt_verbs), arr(gt_ttcs)
    for name, a, want in (("scores", sc, n), ("nouns", pn, n), ("verbs", pv, n), ("ttcs", pt, n),
                          ("gt nouns", gn, g), ("gt verbs", gv, g), ("gt ttcs", gt, g)):
        if a.shape != (want,):
            raise ValueError(f"{name}: shape {a.shape}, expected ({want},)")
    tp = np.zeros((n, 8), np.float64)

    def p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    lib.sta_match(p(pb), p(sc), p(pn), p(pv), p(pt), n,
                  p(gb), p(gn), p(gv), p(gt), g,
                  iou_threshold, ttc_threshold, p(tp))
    return tp
