"""Delay-and-sum as one fused GPU kernel (Pallas, Triton route).

The design of the reference's ``bf.cu`` ``DAS_temp`` (``src/bf.cu:50-142``):
each program owns a block of pixels and loops over transmits and receivers
with its accumulators in registers. Per (pixel, transmit m, receiver n):

    tau = cinv * (dv(m) + dr(n)) - t0[m]           geometry mode
    tau = tau_tx[m] + tau_rx[n] - t0[m]            table (LUT) mode
    y  += w_rx(n) w_tx(m) * exp(2j pi fmod tau) * x(tau fs; n, m)

The delays and the fused apodization weights (:mod:`.apod`) are computed
in registers; the taps are gathered with masked loads from the traces
left in device memory. Nothing of size I x N is ever stored, so the
kernel reads the traces and writes the image, and the tables in LUT mode.
All programs walk the transmits in the same order, so one transmit's
traces are shared through L2.

The loop over the axis that is kept (or, when none is, over transmits)
is the outer one and runs in chunks of ``C``: one inner step (a receiver's
distance, or a table row) serves ``C`` outer rows held in registers.

IQ and complex data ride as separate real and imaginary planes. The
samplers follow :func:`qups_jax.ops.interp.interp1`: valid domain
``0 <= tau fs <= T - 1`` and clamp-replicated edge taps. Results match
:func:`qups_jax.ops.das.das` / :func:`~qups_jax.ops.das.das_lut` up to
f32 summation order.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils.backend import on_gpu
from .apod import Fused, rx_weight, split_fused, tx_weight
from .interp import METHODS

_I32_MAX = 2**31 - 1
# launch configuration: pixels per program, warps per program, outer-axis
# chunk (largest of these dividing the outer axis). Measured on an H100 the
# choice barely matters (PERF.md), so it is fixed.
BLOCK = 128
NUM_WARPS = 4
CHUNKS = (4, 2, 1)


def _lanczos(u):
    """3-lobe Lanczos window (``interpd.cu:116-130``); see
    :func:`qups_jax.ops.interp._lanczos_w`."""
    safe = jnp.where(u == 0, 1.0, u)
    pu = np.pi * safe
    w = 2.0 * jnp.sin(pu) * jnp.sin(0.5 * pu) / (pu * pu)
    return jnp.where(u == 0, 1.0, w)


def _taps(ntau, method: str):
    """(base index, weights) of a sampler at fractional indices ``ntau``:
    taps are ``base + k`` for ``k < len(weights)``."""
    if method == "nearest":
        return jnp.floor(ntau + 0.5).astype(jnp.int32), (None,)
    i0 = jnp.floor(ntau)
    u = ntau - i0
    i0 = i0.astype(jnp.int32)
    if method == "linear":
        return i0, (1.0 - u, u)
    if method == "cubic":
        # Catmull-Rom (``interpd.cu:89-113``)
        return i0 - 1, (0.5 * (u * (-1.0 + u * (2.0 - u))),
                        0.5 * (2.0 + u * u * (-5.0 + 3.0 * u)),
                        0.5 * (u * (1.0 + u * (4.0 - 3.0 * u))),
                        0.5 * (u * u * (u - 1.0)))
    return i0 - 1, (_lanczos(u + 1.0), _lanczos(u), _lanczos(u - 1.0),
                    _lanczos(u - 2.0))


def _kernel(*refs, lut: bool, tx_model: str, planar: bool, method: str,
            T: int, N: int, M: int, K: int, Ip: int, BP: int, C: int,
            nch: int, fs: float, fmod: float, keep_rx: bool, keep_tx: bool,
            rx_apods: tuple, tx_apods: tuple, has_lat: bool):
    """One program: pixel block ``program_id(0)`` of frame
    ``program_id(1)``. Refs (all flat, in global memory):

    geometry mode: px, py, pz, cinv (Ip,), [lat (Ip,)], pr (5 N,) rows
    [x, y, z, sin az, cos az], pv (8 M,) rows [x, y, z, nx, ny, nz, t0,
    lateral]; LUT mode: tau_rx (N Ip,), tau_tx (M Ip,), t0 (M,). Then
    ``nch`` trace planes (F M N T,) and one or two outputs (F K Ip,) —
    two for complex data or ``fmod`` — with K = 1, N, M or M N
    (keep-both, (m, n) order).
    """
    k = 0
    if lut:
        taur_ref, taut_ref, t0_ref = refs[:3]
        k = 3
    else:
        px_ref, py_ref, pz_ref, cinv_ref = refs[:4]
        k = 4
        lat_ref = None
        if has_lat:
            lat_ref = refs[k]
            k += 1
        pr_ref, pv_ref = refs[k:k + 2]
        k += 2
    x_refs = refs[k:k + nch]
    o_refs = refs[k + nch:]

    blk = pl.program_id(0)
    f = pl.program_id(1)
    i0 = blk * BP
    pix = pl.ds(i0, BP)
    if not lut:
        px = px_ref[pix]
        py = py_ref[pix]
        pz = pz_ref[pix]
        cinv = cinv_ref[pix]
        lat = lat_ref[pix] if has_lat else px

    def tx_row(m):
        """(delay part, weight, t0) of transmit m for the pixel block."""
        if lut:
            return taut_ref[pl.ds(m * Ip + i0, BP)], None, t0_ref[m]
        pvx = pv_ref[0 * M + m]
        pvy = pv_ref[1 * M + m]
        pvz = pv_ref[2 * M + m]
        nvx = pv_ref[3 * M + m]
        nvy = pv_ref[4 * M + m]
        nvz = pv_ref[5 * M + m]
        rvx = px - pvx
        rvz = pz - pvz
        rdn = rvx * nvx + rvz * nvz
        r2 = rvx * rvx + rvz * rvz
        if not planar:
            rvy = py - pvy
            rdn = rdn + rvy * nvy
            r2 = r2 + rvy * rvy
        if tx_model == "plane":
            dv = rdn
        elif tx_model == "diverging":
            dv = jnp.sqrt(r2)
        else:  # virtual source: signed distance
            r = jnp.sqrt(r2)
            dv = jnp.where(rdn >= 0, r, -r)
        w = None
        for kind, prm in tx_apods:
            wk = tx_weight(kind, dict(prm), lat, px, pz, pv_ref[7 * M + m],
                           nvx, nvz)
            w = wk if w is None else w * wk
        return dv, w, pv_ref[6 * M + m]

    def rx_row(n):
        """(delay part, weight) of receiver n for the pixel block."""
        if lut:
            return taur_ref[pl.ds(n * Ip + i0, BP)], None
        dx = px - pr_ref[0 * N + n]
        dz = pz - pr_ref[2 * N + n]
        r2 = dx * dx + dz * dz
        dy = None
        if not planar:
            dy = py - pr_ref[1 * N + n]
            r2 = r2 + dy * dy
        dr = jnp.sqrt(r2)
        w = None
        if rx_apods:
            sa = pr_ref[3 * N + n]
            ca = pr_ref[4 * N + n]
            for kind, prm in rx_apods:
                wk = rx_weight(kind, dict(prm), dx, dy, dz, dr, sa, ca,
                               planar)
                w = wk if w is None else w * wk
        return dr, w

    def sample(m, n, trow, rrow):
        """Weighted, remodulated sample planes of (m, n) at the block."""
        dv, wt, t0m = trow
        dr, wr = rrow
        tau = (dv + dr) - t0m if lut else cinv * (dv + dr) - t0m
        ntau = tau * fs
        valid = (ntau >= 0.0) & (ntau <= T - 1.0)
        base = ((f * M + m) * N + n) * T
        b, ws = _taps(ntau, method)
        vals = [None] * nch
        for j, w in enumerate(ws):
            idx = base + jnp.clip(b + j, 0, T - 1)
            for c in range(nch):
                v = plgpu.load(x_refs[c].at[idx], mask=valid, other=0.0)
                v = v if w is None else v * w
                vals[c] = v if vals[c] is None else vals[c] + v
        if fmod != 0.0:
            ph = (2.0 * np.pi * fmod) * tau
            cs, sn = jnp.cos(ph), jnp.sin(ph)
            if nch == 1:  # real traces, complex output
                vals = [vals[0] * cs, vals[0] * sn]
            else:
                vals = [vals[0] * cs - vals[1] * sn,
                        vals[0] * sn + vals[1] * cs]
        w = wt if wr is None else (wr if wt is None else wt * wr)
        if w is not None:
            vals = [v * w for v in vals]
        return vals

    nout = len(o_refs)
    zero = jnp.zeros((BP,), jnp.float32)

    def store(kidx, vals):
        off = (f * K + kidx) * Ip + i0
        for c in range(nout):
            plgpu.store(o_refs[c].at[pl.ds(off, BP)], vals[c])

    if keep_rx and not keep_tx:
        # outer: receivers (kept), inner: transmits
        def outer(ci, carry):
            n0 = ci * C
            rrows = [rx_row(n0 + c) for c in range(C)]

            def inner(m, accs):
                trow = tx_row(m)
                accs = list(accs)
                for c in range(C):
                    vals = sample(m, n0 + c, trow, rrows[c])
                    accs[c] = tuple(a + v for a, v in zip(accs[c], vals))
                return tuple(accs)

            accs = jax.lax.fori_loop(
                0, M, inner, tuple((zero,) * nout for _ in range(C)))
            for c in range(C):
                store(n0 + c, accs[c])
            return carry  # a loop value: Triton cannot yield a literal

        jax.lax.fori_loop(0, N // C, outer, zero)
        return

    # outer: transmits, inner: receivers
    def outer(ci, acc):
        m0 = ci * C
        trows = [tx_row(m0 + c) for c in range(C)]

        def inner(n, accs):
            rrow = rx_row(n)
            accs = list(accs)
            for c in range(C):
                vals = sample(m0 + c, n, trows[c], rrow)
                if keep_rx:  # keep both: one output row per (m, n)
                    store((m0 + c) * N + n, vals)
                elif keep_tx:
                    accs[c] = tuple(a + v for a, v in zip(accs[c], vals))
                else:
                    accs[0] = tuple(a + v for a, v in zip(accs[0], vals))
            return tuple(accs)

        if keep_rx:
            jax.lax.fori_loop(0, N, inner, ((zero,) * nout,))
            return acc
        if keep_tx:
            accs = jax.lax.fori_loop(
                0, N, inner, tuple((zero,) * nout for _ in range(C)))
            for c in range(C):
                store(m0 + c, accs[c])
            return acc
        return jax.lax.fori_loop(0, N, inner, (acc,))[0]

    acc = jax.lax.fori_loop(0, M // C, outer, (zero,) * nout)
    if not (keep_rx or keep_tx):
        store(0, acc)


def _launch_config(N: int, M: int, keep_rx: bool, keep_tx: bool) -> dict:
    """Pixels per program and the chunk of the outer loop's axis."""
    n = N if keep_rx and not keep_tx else M
    return dict(BP=BLOCK, C=next(c for c in CHUNKS if n % c == 0))


def _launch(geo, xs, *, lut, fmod, keep_rx, keep_tx, BP, C, interpret,
            **statics):
    """Launch the kernel on flat ``geo`` refs and 1 or 2 trace planes
    ``xs`` (T, N, M, F). Returns the output planes (F, K, Ip)."""
    T, N, M, F = xs[0].shape
    Ip = geo[0].shape[0] // (N if lut else 1)
    planes = tuple(jnp.transpose(x, (3, 2, 1, 0)).reshape(-1) for x in xs)
    nout = 2 if (len(xs) == 2 or fmod != 0.0) else 1
    K = (M * N if keep_tx else N) if keep_rx else (M if keep_tx else 1)
    kern = partial(_kernel, lut=lut, T=T, N=N, M=M, K=K, Ip=Ip, BP=BP, C=C,
                   nch=len(xs), fmod=fmod, keep_rx=keep_rx, keep_tx=keep_tx,
                   has_lat=not lut and len(geo) == 7, **statics)
    outs = pl.pallas_call(
        kern, grid=(Ip // BP, F),
        out_shape=tuple(jax.ShapeDtypeStruct((F * K * Ip,), jnp.float32)
                        for _ in range(nout)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret, name="das_kernel",
    )(*geo, *planes)
    return tuple(o.reshape(F, K, Ip) for o in outs)


def _fold(x):
    """(T, N, M, *F) -> real planes (T, N, M, F) and the frame dims."""
    fdims = tuple(x.shape[3:])
    x = x.reshape(x.shape[:3] + (int(np.prod(fdims)),))
    if jnp.iscomplexobj(x):
        return (jnp.real(x).astype(jnp.float32),
                jnp.imag(x).astype(jnp.float32)), fdims
    return (x.astype(jnp.float32),), fdims


def _unfold(outs, I, N, M, keep_rx, keep_tx, fdims):
    """(F, K, Ip) planes -> (I, N', M', *F), complex when two planes."""
    res = []
    for o in outs:
        F = o.shape[0]
        o = o[:, :, :I]
        if keep_rx and keep_tx:
            o = o.reshape(F, M, N, I).transpose(3, 2, 1, 0)
        elif keep_tx:
            o = o.transpose(2, 1, 0)[:, None]
        else:
            o = o.transpose(2, 1, 0)[:, :, None]
        res.append(o.reshape(o.shape[:3] + fdims))
    if len(res) == 2:
        return jax.lax.complex(res[0], res[1])
    return res[0]


def covers(x_shape, apod=(), method: str = "cubic", cinv=None,
           keep_rx: bool = False, keep_tx: bool = False,
           I: int = 1) -> bool:
    """Whether :func:`das_kernel` / :func:`das_lut_kernel` serve an input:
    fused (or no) apodization, one of the four samplers, a scalar or
    per-pixel sound speed, and operands within 32-bit indexing."""
    if method not in METHODS or len(x_shape) < 3:
        return False
    if not all(isinstance(a, Fused) for a in apod):
        return False
    if cinv is not None and np.ndim(cinv) > 1:
        return False
    T, N, M = x_shape[:3]
    F = int(np.prod(x_shape[3:], dtype=np.int64))
    K = (M * N if keep_tx else N) if keep_rx else (M if keep_tx else 1)
    Ip = -(-I // BLOCK) * BLOCK
    return max(F * M * N * T, F * K * Ip, max(N, M) * Ip) <= _I32_MAX


def _check(x, method, I, keep_rx, keep_tx, apod=()):
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if not all(isinstance(a, Fused) for a in apod):
        raise ValueError("das_kernel apodization must be Fused descriptors")
    if not covers(x.shape, apod, method, None, keep_rx, keep_tx, I):
        raise ValueError("das kernel: operands exceed 32-bit indexing")


def use_kernel(x_shape, apod=(), method: str = "cubic", cinv=None,
               keep_rx: bool = False, keep_tx: bool = False, I: int = 1,
               interpret: bool = False) -> bool:
    """The DAS-family dispatch, shared by every caller: the kernel for
    the inputs it :func:`covers`, compiled on a GPU (or run in the
    interpreter when a test passes ``interpret=True``); the XLA scan
    otherwise."""
    return (interpret or on_gpu()) and covers(x_shape, apod, method, cinv,
                                              keep_rx, keep_tx, I)


def _pad(v, Ip):
    """Edge-pad the trailing (pixel) axis to Ip."""
    pad = [(0, 0)] * (v.ndim - 1) + [(0, Ip - v.shape[-1])]
    return jnp.pad(v, pad, mode="edge")


_STATIC = ("tx_model", "planar", "method", "fs", "fmod", "keep_rx",
           "keep_tx", "rx_apods", "tx_apods", "BP", "C", "interpret")


@partial(jax.jit, static_argnames=_STATIC)
def _das_geo(x, pi, pr, pv, nv, t0, cinv, lat, lat_tx, sa, ca, **st):
    xs, fdims = _fold(x)
    T, N, M, _ = xs[0].shape
    I = pi.shape[0]
    Ip = -(-I // st["BP"]) * st["BP"]
    prk = jnp.concatenate([pr.T, sa[None], ca[None]]).reshape(-1)
    t0 = jnp.broadcast_to(t0.reshape(-1), (M,))
    lat_tx = jnp.zeros((M,), jnp.float32) if lat_tx is None else lat_tx
    pvk = jnp.concatenate([pv.T, nv.T, t0[None], lat_tx[None]]).reshape(-1)
    cinv = jnp.broadcast_to(cinv.reshape(-1), (I,))
    geo = [_pad(pi[:, 0], Ip), _pad(pi[:, 1], Ip), _pad(pi[:, 2], Ip),
           _pad(cinv, Ip)]
    if st["tx_apods"]:
        geo.append(_pad(pi[:, 0] if lat is None else lat.reshape(-1), Ip))
    outs = _launch(tuple(geo) + (prk, pvk), xs, lut=False, **st)
    return _unfold(outs, I, N, M, st["keep_rx"], st["keep_tx"], fdims)


@partial(jax.jit, static_argnames=_STATIC)
def _das_lut(x, tau_rx, tau_tx, t0, **st):
    xs, fdims = _fold(x)
    T, N, M, _ = xs[0].shape
    I = tau_rx.shape[0]
    Ip = -(-I // st["BP"]) * st["BP"]
    geo = (_pad(tau_rx.T, Ip).reshape(-1), _pad(tau_tx.T, Ip).reshape(-1),
           jnp.broadcast_to(t0.reshape(-1), (M,)))
    outs = _launch(geo, xs, lut=True, **st)
    return _unfold(outs, I, N, M, st["keep_rx"], st["keep_tx"], fdims)


def _planar(*ps) -> bool:
    """True when every position has y == 0 (2-D geometry)."""
    return not any(np.any(np.asarray(p, np.float32)[..., 1]) for p in ps)


def das_kernel(x, pi, pr, pv, nv, t0, cinv, *, fs: float, apod=(),
               fmod: float = 0.0, tx_model: str = "virtual",
               keep_rx: bool = False, keep_tx: bool = False,
               method: str = "cubic", lat=None, lat_tx=None,
               orientations=None, planar: Optional[bool] = None,
               interpret: bool = False):
    """Fused delay-and-sum; the contract of :func:`qups_jax.ops.das.das`.

    ``x (T, N, M, *F)`` real or complex; ``pi (I, 3)`` pixels in any
    order; ``pr (N, 3)``; ``pv``/``nv (M, 3)``; ``t0`` scalar or (M,);
    ``cinv`` scalar or per-pixel (I,). ``apod``: :class:`~.apod.Fused`
    descriptors, evaluated in registers; ``lat (I,)`` is the pixel
    lateral coordinate for transmit apodizations (default: pixel x) and
    ``lat_tx (M,)`` the transmits' (default: from the descriptors);
    ``orientations (2, N)`` the receive elements' azimuth [sin, cos]
    (default: facing +z). ``planar``: whether every y is 0 (default:
    read from the positions, which must then be concrete). Returns
    ``(I, N', M', *F)``, complex64 for complex data or ``fmod != 0``.

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    the CPU); otherwise it compiles for the GPU through Triton.

    Example:
        import numpy as np
        from qups_jax.ops.das import das
        from qups_jax.ops.das_fused import das_kernel
        rng = np.random.default_rng(0)
        T, N, M = 128, 8, 4
        x = rng.standard_normal((T, N, M)).astype(np.float32)
        z = np.linspace(5e-3, 20e-3, 64)
        pi = np.stack([0 * z, 0 * z, z], -1).astype(np.float32)
        pr = np.stack([np.linspace(-2e-3, 2e-3, N), np.zeros(N),
                       np.zeros(N)], -1).astype(np.float32)
        pv = np.zeros((M, 3), np.float32)
        nv = np.tile([0.0, 0.0, 1.0], (M, 1)).astype(np.float32)
        kw = dict(fs=4e6, tx_model="plane", method="cubic")
        img = das_kernel(x, pi, pr, pv, nv, 0.0, 1 / 1540.0,
                         interpret=True, **kw)
        ref = das(x, pi, pr, pv, nv, 0.0, 1 / 1540.0, **kw)
        assert np.allclose(np.asarray(img), np.asarray(ref), atol=1e-4)
    """
    apod = tuple(apod if isinstance(apod, (tuple, list)) else (apod,))
    x = jnp.asarray(x)
    N, M = x.shape[1:3]
    _check(x, method, np.shape(pi)[0], keep_rx, keep_tx, apod)
    rx_apods, tx_apods, lat_f = split_fused(apod)
    if planar is None:
        planar = _planar(pi, pr, pv)
    if orientations is None:
        orientations = (np.zeros(N, np.float32), np.ones(N, np.float32))
    f32 = partial(jnp.asarray, dtype=jnp.float32)
    lat_tx = lat_f if lat_tx is None else lat_tx
    return _das_geo(
        x, f32(pi), f32(pr).reshape(N, 3), f32(pv).reshape(M, 3),
        f32(nv).reshape(M, 3), f32(t0), f32(cinv),
        None if lat is None else f32(lat),
        None if lat_tx is None else f32(lat_tx).reshape(M),
        f32(orientations[0]).reshape(N), f32(orientations[1]).reshape(N),
        tx_model=tx_model, planar=bool(planar), method=method,
        fs=float(fs), fmod=float(fmod), keep_rx=keep_rx, keep_tx=keep_tx,
        rx_apods=rx_apods, tx_apods=tx_apods, interpret=interpret,
        **_launch_config(N, M, keep_rx, keep_tx))


def das_lut_kernel(x, tau_rx, tau_tx, t0, *, fs: float, fmod: float = 0.0,
                   keep_rx: bool = False, keep_tx: bool = False,
                   method: str = "cubic", interpret: bool = False):
    """Fused delay-and-sum from delay tables; the contract of
    :func:`qups_jax.ops.das.das_lut` without apodization: ``tau_rx (I, N)``
    and ``tau_tx (I, M)`` in seconds, ``t0`` scalar or (M,). The tables
    are read one (block, row) slice at a time."""
    x = jnp.asarray(x)
    N, M = x.shape[1:3]
    _check(x, method, np.shape(tau_rx)[0], keep_rx, keep_tx)
    f32 = partial(jnp.asarray, dtype=jnp.float32)
    return _das_lut(
        x, f32(tau_rx), f32(tau_tx), f32(t0), tx_model="", planar=True,
        method=method, fs=float(fs), fmod=float(fmod), keep_rx=keep_rx,
        keep_tx=keep_tx, rx_apods=(), tx_apods=(), interpret=interpret,
        **_launch_config(N, M, keep_rx, keep_tx))
