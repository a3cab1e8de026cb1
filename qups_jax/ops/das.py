"""Delay-and-sum beamforming.

Equivalent of QUPS's DAS engine (``kern/das_spec.m:1-677`` driving
``src/bf.cu:50-142``). Per pixel i, transmit m, receiver n:

    rv  = pi - pv[m]                     (tx geometry vector)
    dv  = { dot(rv, nv[m])                      plane waves
          { |rv|                                diverging waves
          { copysign(|rv|, dot(rv, nv[m]))      virtual source
    dr  = |pi - pr[n]|
    tau = cinv * (dv + dr) - t0[m]
    y  += apod(i,n,m) * exp(2j pi fmod tau) * x((tau) * fs; n, m)

with summation over n (rx) and/or m (tx) selected by flags
(``bf.cu:100-140``), multiple separable broadcast apodization tensors
(``kern/das_spec.m:256-260``), an optional per-pixel sound-speed map ``cinv``
(``bf.cu:113``), and IQ remodulation at ``fmod`` (``bf.cu:117``).

Implementation: a ``lax.scan`` over transmits — the tx/rx delay tensors stay
separable so nothing of size I x N x M materializes (the ``wsinterpd2``
trick, SURVEY.md §5). Peak live memory is O(I*N) per scan step. All math is
f32 geometry with f32/c64 data; everything is jit-compatible and the scan
carries shard-friendly batch (frame) dims on the right.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .interp import expand_trailing, interp1
from ..utils.cpx import cexp, czeros, to_device

TX_MODELS = ("plane", "virtual", "diverging")


def _lift5(a):
    """Lift an apodization array to 5 dims ``(I1', I2', I3', N', M')`` by
    appending trailing singletons (MATLAB-style implicit expansion)."""
    a = jnp.asarray(a)
    if a.ndim > 5:
        raise ValueError(f"apodization must be at most 5-D, got {a.shape}")
    return a.reshape(a.shape + (1,) * (5 - a.ndim))


def _norm3(v, axis=-1):
    return jnp.sqrt(jnp.sum(v * v, axis=axis))


def tx_distance(pi, pv, nv, tx_model: str):
    """Transmit path length dv (I, ...) for pixel positions ``pi (I, 3)`` and
    a single virtual source ``pv (3,)`` / normal ``nv (3,)``
    (``bf.cu:103-110``)."""
    rv = pi - pv  # (I, 3)
    if tx_model == "plane":
        return jnp.sum(rv * nv, axis=-1)
    r = _norm3(rv)
    if tx_model == "diverging":
        return r
    if tx_model == "virtual":
        return jnp.copysign(r, jnp.sum(rv * nv, axis=-1))
    raise ValueError(f"unknown tx model {tx_model!r}; expected {TX_MODELS}")


def delay_tables(pi, pr, pv, nv, c0: float, tx_model: str = "virtual"):
    """Separable geometric delay LUTs (``bf.cu`` ``delays`` kernel,
    ``bf.cu:209-298``): returns ``tau_rx (I, N)`` and ``tau_tx (I, M)`` in
    seconds (no t0 applied)."""
    pi = jnp.asarray(pi, jnp.float32)
    pr = jnp.asarray(pr, jnp.float32)
    pv = jnp.asarray(pv, jnp.float32)
    nv = jnp.asarray(nv, jnp.float32)
    dr = _norm3(pi[:, None, :] - pr[None, :, :])  # (I, N)
    dv = jax.vmap(lambda p, n: tx_distance(pi, p, n, tx_model), in_axes=0,
                  out_axes=1)(pv, nv)  # (I, M)
    return dr / c0, dv / c0


@partial(jax.jit, static_argnames=("tx_model", "keep_rx", "keep_tx", "method",
                                   "fs", "fmod", "im_shape"))
def das(x, pi, pr, pv, nv, t0, cinv, *, fs: float, apod=(), fmod: float = 0.0,
        tx_model: str = "virtual", keep_rx: bool = False, keep_tx: bool = False,
        method: str = "cubic", im_shape: Optional[Tuple[int, int, int]] = None):
    """Delay-and-sum beamform.

    Args:
      x: channel data ``(T, N, M, *F)`` (real or complex; complex stays
        inside the jit boundary).
      pi: pixel positions ``(I, 3)`` (flattened image grid).
      pr: receiver positions ``(N, 3)``.
      pv: virtual transmit source positions ``(M, 3)``.
      nv: virtual transmit normals / plane-wave directions ``(M, 3)``.
      t0: data start time per transmit — scalar or ``(M,)``.
      cinv: inverse beamforming sound speed — scalar, ``(I,)`` per-pixel, or
        ``(I, N)``-broadcastable array (heterogeneous-c support,
        ``kern/das_spec.m:169``).
      fs: sampling frequency of ``x``.
      apod: tuple of apodization arrays, each left-aligned broadcastable to
        ``(I1, I2, I3, N, M)`` (the reference's separable-apodization
        contract, ``kern/das_spec.m:256-260``) — applied per transmit with
        broadcasting, so factored masks are never materialized at full size.
        ``im_shape`` gives (I1, I2, I3); default ``(I, 1, 1)``.
      fmod: remodulation frequency for IQ (downmixed) data.
      tx_model: 'plane' | 'virtual' | 'diverging' (``bf.cu:103-110``).
      keep_rx / keep_tx: preserve instead of summing the rx/tx axis.
      method: interpolation method.

    Returns:
      image ``(I, N', M', *F)`` with ``N' = N if keep_rx else 1`` and
      ``M' = M if keep_tx else 1``.
    """
    x = to_device(x)
    pi = jnp.asarray(pi, jnp.float32)
    pr = jnp.asarray(pr, jnp.float32)
    pv = jnp.asarray(pv, jnp.float32)
    nv = jnp.asarray(nv, jnp.float32)
    T, N, M = x.shape[:3]
    F = x.shape[3:]
    I = pi.shape[0]
    t0 = jnp.broadcast_to(jnp.asarray(t0, jnp.float32).reshape(-1), (M,))
    cinv = jnp.asarray(cinv, jnp.float32)
    if cinv.ndim == 1:  # per-pixel map (I,) -> broadcast over rx
        cinv = cinv[:, None]
    # rx path lengths are tx-independent: compute once (I, N)
    dr = _norm3(pi[:, None, :] - pr[None, :, :])

    im_shape = im_shape or (I, 1, 1)
    assert int(np.prod(im_shape)) == I, (im_shape, I)
    apod = tuple(_lift5(a) for a in (apod if isinstance(apod, (tuple, list)) else (apod,)))
    # split apodization into per-tx (scanned) and tx-invariant (closure)
    apod_m = tuple(a for a in apod if a.shape[4] == M)
    apod_c = tuple(a[..., 0] for a in apod if a.shape[4] != M)

    cplx = jnp.iscomplexobj(x) or fmod != 0.0
    out_dtype = jnp.complex64 if cplx else x.dtype

    xT = jnp.moveaxis(x, 2, 0)  # (M, T, N, *F)
    apod_mT = tuple(jnp.moveaxis(a, 4, 0) for a in apod_m)  # (M, I1', I2', I3', N')

    def _apply_apod(v, apods_m):
        # v: (I, N, *F) -> view as (I1, I2, I3, N, *F) for broadcast multiply
        if not (apods_m or apod_c):
            return v
        v5 = v.reshape(im_shape + v.shape[1:])
        for a in tuple(apods_m) + apod_c:  # (I1', I2', I3', N')
            v5 = v5 * expand_trailing(a, v5.ndim)
        return v5.reshape(v.shape)

    def step(pv_m, nv_m, t0_m, x_m, apods_m):
        dv = tx_distance(pi, pv_m, nv_m, tx_model)  # (I,)
        tau = cinv * (dv[:, None] + dr) - t0_m      # (I, N) [* cinv may bcast]
        ntau = tau * fs
        v = interp1(x_m, ntau, method=method)       # (I, N, *F)
        if cplx:
            v = v.astype(out_dtype)
        if fmod != 0.0:
            v = v * expand_trailing(cexp((2 * np.pi * fmod) * tau), v.ndim)
        v = _apply_apod(v, apods_m)
        if not keep_rx:
            v = jnp.sum(v, axis=1, keepdims=True)   # (I, 1, *F)
        return v

    if keep_tx:
        def body(_, xs):
            return None, step(*xs[:4], xs[4])
        _, ys = jax.lax.scan(body, None, (pv, nv, t0, xT, apod_mT))
        img = jnp.moveaxis(ys, 0, 2)  # (I, N', M, *F)
    else:
        n_out = N if keep_rx else 1
        init = czeros((I, n_out) + F) if cplx \
            else jnp.zeros((I, n_out) + F, out_dtype)

        def body(acc, xs):
            return acc + step(*xs[:4], xs[4]), None
        img, _ = jax.lax.scan(body, init, (pv, nv, t0, xT, apod_mT))
        img = img[:, :, None]  # (I, N', 1, *F)
    return img


def das_lut(x, tau_rx, tau_tx, t0, *, fs: float, apod=(), fmod: float = 0.0,
            keep_rx: bool = False, keep_tx: bool = False, method: str = "cubic",
            im_shape: Optional[Tuple[int, int, int]] = None):
    """LUT ("bring your own delays") delay-and-sum — the engine behind
    ``bfDAS``/``bfDASLUT``/``bfEikonal`` (``UltrasoundSystem.bfDASLUT``,
    ``src/UltrasoundSystem.m:4476-4673``): beamform with arbitrary separable
    delay tables ``tau = tau_rx (I, N) + tau_tx (I, M)`` (seconds).
    """
    x = to_device(x)
    tau_rx = jnp.asarray(tau_rx, jnp.float32)
    tau_tx = jnp.asarray(tau_tx, jnp.float32)
    T, N, M = x.shape[:3]
    F = x.shape[3:]
    I = tau_rx.shape[0]
    t0 = jnp.broadcast_to(jnp.asarray(t0, jnp.float32).reshape(-1), (M,))

    im_shape = im_shape or (I, 1, 1)
    apod = tuple(_lift5(a) for a in (apod if isinstance(apod, (tuple, list)) else (apod,)))
    apod_m = tuple(a for a in apod if a.shape[4] == M)
    apod_c = tuple(a[..., 0] for a in apod if a.shape[4] != M)

    cplx = jnp.iscomplexobj(x) or fmod != 0.0
    out_dtype = jnp.complex64 if cplx else x.dtype
    xT = jnp.moveaxis(x, 2, 0)
    apod_mT = tuple(jnp.moveaxis(a, 4, 0) for a in apod_m)
    tau_txT = jnp.moveaxis(tau_tx, 1, 0)  # (M, I)

    def _apply_apod(v, apods_m):
        if not (apods_m or apod_c):
            return v
        v5 = v.reshape(tuple(im_shape) + v.shape[1:])
        for a in tuple(apods_m) + apod_c:
            v5 = v5 * expand_trailing(a, v5.ndim)
        return v5.reshape(v.shape)

    def step(tt_m, t0_m, x_m, apods_m):
        tau = tt_m[:, None] + tau_rx - t0_m  # (I, N)
        v = interp1(x_m, tau * fs, method=method)
        if cplx:
            v = v.astype(out_dtype)
        if fmod != 0.0:
            v = v * expand_trailing(cexp((2 * np.pi * fmod) * tau), v.ndim)
        v = _apply_apod(v, apods_m)
        if not keep_rx:
            v = jnp.sum(v, axis=1, keepdims=True)
        return v

    if keep_tx:
        def body(_, xs):
            return None, step(xs[0], xs[1], xs[2], xs[3])
        _, ys = jax.lax.scan(body, None, (tau_txT, t0, xT, apod_mT))
        img = jnp.moveaxis(ys, 0, 2)
    else:
        n_out = N if keep_rx else 1
        init = czeros((I, n_out) + F) if cplx \
            else jnp.zeros((I, n_out) + F, out_dtype)

        def body(acc, xs):
            return acc + step(xs[0], xs[1], xs[2], xs[3]), None
        img, _ = jax.lax.scan(body, init, (tau_txT, t0, xT, apod_mT))
        img = img[:, :, None]
    return img
