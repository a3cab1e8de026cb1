"""Aperture-domain coherence imaging.

Equivalents of QUPS's coherence kernels, which post-process
beamformed-but-unsummed (``keep_rx=True``) images across the receive
aperture dimension:

* :func:`cohfac` — coherence factor (``kern/cohfac.m:64``)
* :func:`slsc` — short-lag spatial coherence (``kern/slsc.m:142-223``)
* :func:`dmas` — delay-multiply-and-sum (``kern/dmas.m:71-79``)
* :func:`pcf` — phase coherence factor (``kern/pcf.m:78-106``)
* :func:`pwznxcorr` — pairwise windowed zero-normalized cross-correlation
  (``kern/pwznxcorr.m:1-301``) for displacement / shear-wave tracking.

All reductions run across a chosen axis, so they ride the same sharded rx
layout as the beamformers (BASELINE config #5): under ``shard_map`` the
aperture sums become ``psum`` collectives.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.cpx import cexp, czeros

from .conv import convd


def cohfac(b, axis: int = -1):
    """Coherence factor ``|sum b|^2 / (N * sum |b|^2)`` (``kern/cohfac.m``).

    Example:
        import numpy as np
        from qups_jax.ops import cohfac
        b = np.ones((10, 32), np.complex64)      # perfectly coherent aperture
        assert np.allclose(np.asarray(cohfac(b, axis=1)), 1.0, atol=1e-6)
    """
    b = jnp.asarray(b)
    n = b.shape[axis]
    num = jnp.abs(jnp.sum(b, axis=axis)) ** 2
    den = jnp.sum(jnp.abs(b) ** 2, axis=axis) * n
    return num / jnp.where(den == 0, 1.0, den)


def slsc(x, axis: int = -1, lags: Union[int, Sequence[int], None] = None,
         method: str = "average", kaxis: Optional[int] = None):
    """Short-lag spatial coherence across the aperture ``axis``
    (``kern/slsc.m``).

    ``lags``: max lag (int -> ``1..L``) or an explicit lag list; default
    ``floor(A/4)``. ``kaxis``: optional time-kernel axis reduced along with
    the aperture.

    * ``average``: per-channel normalize over ``kaxis`` then average the
      debiased correlation ``sum_{|i-j| in lags} conj(x_i) x_j / (A - |i-j|)
      / 2 / L`` (``kern/slsc.m:187-202``).
    * ``ensemble``: accumulate z, a, b inner products over the selected lag
      pairs then ``z * rsqrt(a) * rsqrt(b)`` (``kern/slsc.m:204-223``).

    Example:
        import numpy as np
        from qups_jax.ops import slsc
        rng = np.random.default_rng(0)
        sig = rng.standard_normal((64, 1))          # common signal
        coh = np.broadcast_to(sig, (64, 16)).copy() # fully coherent
        inc = rng.standard_normal((64, 16))         # incoherent noise
        s_c = float(np.mean(np.asarray(slsc(coh, axis=1, lags=4))))
        s_i = float(np.mean(np.asarray(slsc(inc, axis=1, lags=4))))
        assert s_c > 0.9 and s_c > 5 * abs(s_i)
    """
    x = jnp.asarray(x)
    axis = axis % x.ndim
    A = x.shape[axis]
    if lags is None:
        lags = max(1, A // 4)
    lag_list = list(range(1, lags + 1)) if np.isscalar(lags) else list(lags)
    L = len(lag_list)

    red_axes = (axis,) if kaxis is None else (axis, kaxis % x.ndim)

    xm = jnp.moveaxis(x, axis, -1)  # (..., A)
    if kaxis is not None:
        ka = kaxis % x.ndim
        ka = ka if ka < axis else ka - 1  # position after moveaxis
    if method == "average":
        if kaxis is not None:
            nrm = jnp.sqrt(jnp.sum(jnp.abs(xm) ** 2, axis=ka, keepdims=True))
            xm = jnp.where(nrm == 0, 0.0, xm / jnp.where(nrm == 0, 1.0, nrm))
        else:
            nrm = jnp.abs(xm)
            xm = jnp.where(nrm == 0, 0.0, xm / jnp.where(nrm == 0, 1.0, nrm))
        z = czeros(xm.shape[:-1]) if jnp.issubdtype(xm.dtype, jnp.complexfloating) \
            else jnp.zeros(xm.shape[:-1], dtype=xm.dtype)
        for l in lag_list:
            w = 1.0 / (A - l) / 2.0 / L
            c = jnp.sum(jnp.conj(xm[..., : A - l]) * xm[..., l:], axis=-1)
            z = z + 2 * w * jnp.real(c) if not jnp.iscomplexobj(xm) \
                else z + w * (c + jnp.conj(c))
        if kaxis is not None:
            z = jnp.sum(z, axis=ka)
        return z
    elif method == "ensemble":
        z = a = b = 0.0
        for l in lag_list:
            xl = xm[..., : A - l]
            xr = xm[..., l:]
            zz = jnp.sum(jnp.conj(xl) * xr, axis=-1)
            z = z + zz + jnp.conj(zz)
            a = a + 2 * jnp.sum(jnp.conj(xl) * xl, axis=-1)
            b = b + 2 * jnp.sum(jnp.conj(xr) * xr, axis=-1)
        if kaxis is not None:
            z = jnp.sum(z, axis=ka)
            a = jnp.sum(a, axis=ka)
            b = jnp.sum(b, axis=ka)
        ab = jnp.sqrt(jnp.abs(a)) * jnp.sqrt(jnp.abs(b))
        return z / jnp.where(ab == 0, 1.0, ab)
    raise ValueError(method)


def dmas(bn, axis: int = -1, lags: Union[int, Sequence[int], None] = None):
    """Delay-multiply-and-sum over aperture lag pairs (``kern/dmas.m``):

        b = sum_{l in lags} sum_n bn[n] bn[n+l]

    followed by the phase-preserving rescale ``exp(1j angle(b)) sqrt(|b|)``.

    Example:
        import numpy as np
        from qups_jax.ops import dmas
        b = np.ones((8, 16), np.complex64)  # coherent aperture
        y = np.asarray(dmas(b, axis=1))
        assert y.shape == (8,) and np.all(np.abs(y) > 0)
    """
    bn = jnp.asarray(bn)
    axis = axis % bn.ndim
    N = bn.shape[axis]
    if lags is None:
        lag_list = range(1, N)
    elif np.isscalar(lags):
        lag_list = range(1, int(lags) + 1)
    else:
        lag_list = [l for l in lags if 1 <= l <= N - 1]
    bm = jnp.moveaxis(bn, axis, -1)
    b = czeros(bm.shape[:-1]) if jnp.issubdtype(bm.dtype, jnp.complexfloating) \
        else jnp.zeros(bm.shape[:-1], dtype=bm.dtype)
    for l in lag_list:
        b = b + jnp.sum(bm[..., : N - l] * bm[..., l:], axis=-1)
    if jnp.iscomplexobj(b):
        return cexp(jnp.angle(b)) * jnp.sqrt(jnp.abs(b))
    return jnp.sign(b) * jnp.sqrt(jnp.abs(b))


def pcf(b, axis: int = -1, gamma: float = 1.0):
    """Phase coherence factor (``kern/pcf.m``): ``max(0, 1 - gamma/sigma_0 *
    sf)`` where ``sf`` is the smaller of the phase std and the pi-wrapped
    auxiliary phase std across the aperture.

    Example:
        import numpy as np
        from qups_jax.ops import pcf
        b = np.exp(1j * np.zeros((4, 16))).astype(np.complex64)
        w = np.asarray(pcf(b, axis=1))   # zero phase spread -> weight 1
        assert np.allclose(w, 1.0, atol=1e-6)
    """
    b = jnp.asarray(b)
    assert jnp.iscomplexobj(b), "pcf requires complex (beamformed IQ) input"
    phi = jnp.angle(b)
    s0 = jnp.std(phi, axis=axis)
    phia = phi - jnp.pi * jnp.sign(phi)
    sa = jnp.std(phia, axis=axis)
    sf = jnp.minimum(s0, sa)
    sg0 = np.sqrt(np.pi / 3)
    return jnp.maximum(0.0, 1.0 - (gamma / sg0) * sf)


def pwznxcorr(x, lags: Sequence[int], W: int = None, *, taxis: int = 0,
              naxis: int = 1, stride: int = 1, zero: bool = True,
              norm: bool = True):
    """Pairwise windowed zero-normalized cross-correlation between adjacent
    channels (``kern/pwznxcorr.m``): for each channel pair (n, n+stride) and
    lag l, the windowed correlation

        y[t, n, ..., l] = <xl, xr(l)>_W / sqrt(<xl,xl>_W <xr(l),xr(l)>_W)

    with windowed sums over a length-W moving window in time, optional
    zero-meaning and normalization. Used for displacement / shear-wave
    tracking. Returns an array with a trailing lag axis.

    Example:
        import numpy as np
        from qups_jax.ops import pwznxcorr
        rng = np.random.default_rng(0)
        base = rng.standard_normal(80).astype(np.float32)
        # channel 1 is channel 0 shifted by 3 samples
        x = np.stack([base, np.roll(base, 3)], axis=1)
        y = np.asarray(pwznxcorr(x, lags=[0, 3], W=21))
        # the lag-3 correlation dominates mid-trace
        assert y[40, 0, 1] > y[40, 0, 0] + 0.2
    """
    x = jnp.asarray(x)
    lags = list(lags)
    if W is None:
        W = max(1, int(np.ceil(max(abs(np.asarray(lags))) / 2)))
    N = x.shape[naxis]

    xl = jax.lax.slice_in_dim(x, 0, N - stride, axis=naxis)
    xr = jax.lax.slice_in_dim(x, stride, N, axis=naxis)

    w = jnp.ones((W,), x.real.dtype)
    wshape = [1] * x.ndim
    wshape[taxis] = W

    def winsum(v):
        return convd(v, w.reshape(wshape), axis=taxis, shape="same")

    if zero:
        xl = xl - winsum(xl) / W
    outs = []
    for l in lags:
        xrl = jnp.roll(xr, -int(l), axis=taxis)
        if zero:
            xrl = xrl - winsum(xrl) / W
        num = winsum(xl * jnp.conj(xrl))
        if norm:
            den = jnp.sqrt(jnp.abs(winsum(jnp.abs(xl) ** 2)
                                   * winsum(jnp.abs(xrl) ** 2)))
            outs.append(num / jnp.where(den == 0, 1.0, den))
        else:
            outs.append(num)
    return jnp.stack(outs, axis=-1)
