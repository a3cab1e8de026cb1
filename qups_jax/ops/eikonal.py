"""Eikonal travel-time solver (fast marching).

Equivalent of QUPS's multistencil fast-marching solver
(``/root/reference/src/FMM/functions/msfm2d.c:26``, ``msfm3d.c``, wrapped by
``kern/msfm.m:1-30``): one-way travel-time maps ``T`` with ``|grad T| = 1/F``
through heterogeneous sound-speed maps, feeding the eikonal beamformer's
delay tables (``UltrasoundSystem.bfEikonal``).

The frontier algorithm is inherently sequential, so it runs on the host:

* native C++ (``qups_jax/native/msfm.cpp``, built on demand via make) with a
  binary-heap frontier and 2nd-order upwind differences — the fast path;
* a pure-Python ``heapq`` fallback with identical semantics.

Maps for many sources (one per transducer element) are computed in a thread
pool — the C++ kernel releases the GIL via ctypes.
"""
from __future__ import annotations

import ctypes
import heapq
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB = None
_LIB_TRIED = False


def _load_native():
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = os.path.join(_NATIVE_DIR, "libmsfm.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
        lib.msfm2d.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        lib.msfm3d.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        for name in ("msfm2d_t0", "msfm3d_t0"):
            if not hasattr(lib, name):
                continue  # stale .so without the wavefront-source entry
            fn = getattr(lib, name)
            base = getattr(lib, name[:-3]).argtypes
            fn.argtypes = base[:-3] + [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def _msfm_py(F: np.ndarray, h: float, src: np.ndarray, order2: bool,
             src_t0=None) -> np.ndarray:
    """Pure-Python fast marching (any dimension), heapq frontier."""
    shape = F.shape
    nd = F.ndim
    T = np.full(shape, np.inf)
    state = np.zeros(shape, np.int8)  # 0 far, 1 band, 2 frozen
    heap = []
    R = 3  # analytic init radius (matches the native solver)
    for si, s in enumerate(src):
        s = tuple(int(v) for v in s)
        f0 = float(F[s]) if F[s] > 0 else 1.0
        ts = float(src_t0[si]) if src_t0 is not None else 0.0
        rng = [np.arange(max(0, s[d] - R), min(shape[d], s[d] + R + 1))
               for d in range(nd)]
        for j in np.stack(np.meshgrid(*rng, indexing="ij"), -1).reshape(-1, nd):
            r = h * np.linalg.norm(j - np.asarray(s))
            if r > R * h:
                continue
            jt = tuple(int(v) for v in j)
            t = ts + r / f0
            if t < T[jt]:
                T[jt] = t
                heapq.heappush(heap, (t, jt))
                state[jt] = 1
    invh2 = 1.0 / (h * h)

    def update(j):
        f = F[j]
        if not f > 0:
            return np.inf
        rhs = 1.0 / (f * f)
        A = B = 0.0
        C = -rhs
        one_d = []
        for d in range(nd):
            t1 = np.inf
            t2 = np.inf
            o2 = False
            for sgn in (-1, 1):
                jj = list(j)
                jj[d] += sgn
                if 0 <= jj[d] < shape[d] and state[tuple(jj)] == 2:
                    tv = T[tuple(jj)]
                    if tv < t1:
                        t1 = tv
                        o2 = False
                        jj2 = list(j)
                        jj2[d] += 2 * sgn
                        if order2 and 0 <= jj2[d] < shape[d] \
                                and state[tuple(jj2)] == 2 \
                                and T[tuple(jj2)] <= tv:
                            t2 = T[tuple(jj2)]
                            o2 = True
            if np.isfinite(t1):
                if o2:
                    a, w = (4 * t1 - t2) / 3.0, 2.25 * invh2
                else:
                    a, w = t1, invh2
                A += w
                B -= 2 * w * a
                C += w * a * a
                one_d.append(a + np.sqrt(rhs / w))
        if A == 0:
            return np.inf
        disc = B * B - 4 * A * C
        if disc < 0:
            return min(one_d)
        return (-B + np.sqrt(disc)) / (2 * A)

    while heap:
        tv, j = heapq.heappop(heap)
        if state[j] == 2:
            continue
        state[j] = 2
        for d in range(nd):
            for sgn in (-1, 1):
                jj = list(j)
                jj[d] += sgn
                jt = tuple(jj)
                if not (0 <= jj[d] < shape[d]) or state[jt] == 2:
                    continue
                tn = update(jt)
                if tn < T[jt]:
                    T[jt] = tn
                    heapq.heappush(heap, (tn, jt))
                    state[jt] = 1
    return T


def msfm(F: np.ndarray, h: float, src, order2: bool = True,
         use_native: Optional[bool] = None, src_t0=None) -> np.ndarray:
    """Travel-time map from source cell(s).

    Args:
      F: speed map [m/s], 2-D ``(n0, n1)`` or 3-D ``(n0, n1, n2)``.
      h: isotropic grid spacing [m] (the reference requires isotropic grids
        too, ``UltrasoundSystem.m:4269-4273``).
      src: (ns, ndim) integer source cell indices.
      order2: use second-order upwind differences.
      src_t0: optional per-source initial times (ns,) — WAVEFRONT sources:
        each source cell starts at its own time (virtual-source /
        boundary-seeded transmits; default all zero).

    Returns: T [s] with T = src_t0 at the sources.

    Example:
        import numpy as np
        from qups_jax.ops.eikonal import msfm
        F = np.full((41, 41), 1500.0)              # homogeneous speed map
        T = msfm(F, 1e-3, np.array([[20, 20]]))    # source at the center
        # travel time to a corner ~ euclidean distance / c
        d = np.hypot(20, 20) * 1e-3
        assert abs(T[0, 0] - d / 1500.0) / (d / 1500.0) < 0.05
    """
    F = np.ascontiguousarray(F, np.float64)
    src = np.atleast_2d(np.asarray(src, np.int64))
    assert src.shape[1] == F.ndim, (src.shape, F.shape)
    if src_t0 is not None:
        src_t0 = np.ascontiguousarray(
            np.broadcast_to(np.asarray(src_t0, np.float64), (src.shape[0],)))
    lib = _load_native() if use_native in (None, True) else None
    if lib is not None and src_t0 is not None \
            and not hasattr(lib, "msfm2d_t0"):
        lib = None  # stale .so: fall back to python for wavefront sources
    if lib is None:
        if use_native is True:
            raise RuntimeError("native msfm library unavailable")
        return _msfm_py(F, h, src, order2, src_t0)
    T = np.empty(F.shape, np.float64)
    c_d = ctypes.POINTER(ctypes.c_double)
    c_i = ctypes.POINTER(ctypes.c_int64)
    srcc = np.ascontiguousarray(src)
    t0p = src_t0.ctypes.data_as(c_d) if src_t0 is not None else None
    if F.ndim == 2:
        if src_t0 is not None:
            lib.msfm2d_t0(F.ctypes.data_as(c_d), F.shape[0], F.shape[1],
                          ctypes.c_double(h), srcc.ctypes.data_as(c_i),
                          t0p, src.shape[0], int(order2),
                          T.ctypes.data_as(c_d))
        else:
            lib.msfm2d(F.ctypes.data_as(c_d), F.shape[0], F.shape[1],
                       ctypes.c_double(h), srcc.ctypes.data_as(c_i),
                       src.shape[0], int(order2), T.ctypes.data_as(c_d))
    elif F.ndim == 3:
        if src_t0 is not None:
            lib.msfm3d_t0(F.ctypes.data_as(c_d), F.shape[0], F.shape[1],
                          F.shape[2], ctypes.c_double(h),
                          srcc.ctypes.data_as(c_i), t0p, src.shape[0],
                          int(order2), T.ctypes.data_as(c_d))
        else:
            lib.msfm3d(F.ctypes.data_as(c_d), F.shape[0], F.shape[1],
                       F.shape[2], ctypes.c_double(h),
                       srcc.ctypes.data_as(c_i), src.shape[0], int(order2),
                       T.ctypes.data_as(c_d))
    else:
        raise ValueError("F must be 2-D or 3-D")
    return T


def msfm_multi(F: np.ndarray, h: float, srcs: Sequence, order2: bool = True,
               workers: Optional[int] = None) -> np.ndarray:
    """One travel-time map per source (e.g. per transducer element), run in
    a thread pool (the reference uses a process pool per element,
    ``UltrasoundSystem.m:4295-4299``). Returns (len(srcs), *F.shape)."""
    workers = workers or min(len(srcs), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        maps = list(ex.map(lambda s: msfm(F, h, [s], order2=order2), srcs))
    return np.stack(maps)
