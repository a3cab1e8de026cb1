"""Batched fractional-delay interpolation ops.

Equivalents of QUPS's interpolation kernel family
(``/root/reference/src/interpd.cu:68-477``, dispatched by
``kern/interpd.m``, ``kern/wsinterpd.m``, ``kern/wsinterpd2.m``):

* :func:`interp1` — the core 0-based fractional-index sampler (nearest /
  linear / cubic Catmull-Rom / Lanczos-3) following ``interpd.cu:70-150``,
  with inclusive-endpoint validity and clamp-replicated edge taps; fully
  out-of-bounds queries return the extrapolation value.
* :func:`interpd` — broadcasted 1-D interpolation ``y[i, ...] =
  sample(x[:, ...], tau[i, ...])`` (``interpd.cu:170-192``).
* :func:`wsinterpd` / :func:`wsinterpd2` — weighted-sample-and-reduce with an
  optional modulation phasor (``interpd.cu:293-396``). The reference's
  atomicAdd scatter-reduction becomes a dense XLA reduction (single device) —
  cross-chip the reduction is a ``psum`` (see ``qups_jax.parallel``).

Everything here is pure-XLA and jit/vmap/shard_map friendly; hot-path fusions
(DAS, greens) have dedicated kernels in their own modules.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.cpx import cexp

METHODS = ("nearest", "linear", "cubic", "lanczos3")


def _lanczos_w(u):
    """3-lobe (a=2) Lanczos window: ``2 sin(pi u) sin(pi u / 2) / (pi u)^2``
    (``interpd.cu:116-130``)."""
    pu = jnp.pi * u
    safe = jnp.where(u == 0, 1.0, u)
    w = 2.0 * jnp.sin(jnp.pi * safe) * jnp.sin(jnp.pi * safe / 2) / (jnp.pi * safe) ** 2
    return jnp.where(u == 0, 1.0, w)


def _taps(tau, method: str, T: int):
    """Return (base_index, offsets, weights(list), valid) for a sampler.

    The valid domain is ``0 <= tau <= T-1`` (inclusive endpoints, as in
    MATLAB ``interp1``); edge taps are clamp-replicated. The reference CUDA
    samplers (``interpd.cu``) instead return ``no_v`` in a one-sample margin
    at the edges — we prefer the friendlier endpoint behavior.
    """
    valid = (0 <= tau) & (tau <= T - 1)
    if method == "nearest":
        b = jnp.round(tau).astype(jnp.int32)
        return b, (0,), (jnp.ones_like(tau),), valid
    i0 = jnp.floor(tau)
    u = tau - i0
    i0 = i0.astype(jnp.int32)
    if method == "linear":
        return i0, (0, 1), (1 - u, u), valid
    if method == "cubic":
        b = i0 - 1
        # Catmull-Rom weights (interpd.cu:89-113), including the 1/2 factor
        a0 = 0.5 * (u * (-1.0 + u * (2.0 - u)))
        a1 = 0.5 * (2.0 + u * u * (-5.0 + 3.0 * u))
        a2 = 0.5 * (u * (1.0 + u * (4.0 - 3.0 * u)))
        a3 = 0.5 * (u * u * (u - 1.0))
        return b, (0, 1, 2, 3), (a0, a1, a2, a3), valid
    if method == "lanczos3":
        b = i0 - 1
        return b, (0, 1, 2, 3), (_lanczos_w(u + 1), _lanczos_w(u),
                                 _lanczos_w(u - 1), _lanczos_w(u - 2)), valid
    raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")


def expand_trailing(a, nd: int):
    """Pad shape with trailing singleton dims to ``nd`` dims (MATLAB-style
    left-aligned broadcasting: implicit trailing 1s)."""
    a = jnp.asarray(a)
    if a.ndim >= nd:
        return a
    return a.reshape(a.shape + (1,) * (nd - a.ndim))


def bshape_left(*shapes) -> Tuple[int, ...]:
    """Broadcast shapes with MATLAB left-aligned rules (pad on the right)."""
    nd = max(len(s) for s in shapes)
    padded = [tuple(s) + (1,) * (nd - len(s)) for s in shapes]
    return tuple(np.broadcast_shapes(*padded))


def _gather_time(x, idx):
    """y[i, *D] = x[idx[i, *D], *D] gathering along axis 0 of ``x``.

    ``x``: (T, *B); ``idx``: (I, *C) with C left-aligned broadcastable
    against B. Returns (I, *broadcast(C, B)).
    """
    B = x.shape[1:]
    C = idx.shape[1:]
    D = bshape_left(C, B)
    xe = jnp.broadcast_to(expand_trailing(x, 1 + len(D)), (x.shape[0],) + D)
    idxb = jnp.broadcast_to(expand_trailing(idx, 1 + len(D)), (idx.shape[0],) + D)
    return jnp.take_along_axis(xe, idxb, axis=0)


def interp1(x, tau, method: str = "cubic", extrap=0.0):
    """Sample ``x`` along its first axis at fractional indices ``tau``.

    ``x``: (T, *B); ``tau``: (I, *C) where C broadcasts against B with
    MATLAB-style left-aligned (trailing-singleton) rules, matching the
    reference's implicit expansion (``kern/interpd.m:57-76``). Returns
    shape ``(I, *broadcast(C, B))``.
    """
    x = jnp.asarray(x)
    tau = jnp.asarray(tau)
    if tau.ndim == 0:
        tau = tau[None]
    T = x.shape[0]
    b, offs, ws, valid = _taps(tau, method, T)
    acc = None
    for k, w in zip(offs, ws):
        idx = jnp.clip(b + k, 0, T - 1)
        v = _gather_time(x, idx)
        w = expand_trailing(w, v.ndim)
        wv = w.astype(v.real.dtype) if jnp.iscomplexobj(v) else w.astype(v.dtype)
        acc = v * wv if acc is None else acc + v * wv
    validb = jnp.broadcast_to(expand_trailing(valid, acc.ndim), acc.shape)
    return jnp.where(validb, acc, jnp.asarray(extrap, dtype=acc.dtype))


def interpd(x, tau, method: str = "cubic", extrap=0.0):
    """Broadcasted 1-D interpolation (``kern/interpd.m`` semantics with
    canonical axes): ``x`` (T, *B), ``tau`` (*C) of fractional time indices;
    output ``broadcast(C, B)``.

    Example:
        import numpy as np
        from qups_jax.ops import interpd
        x = np.sin(np.linspace(0, 6.28, 64, dtype=np.float32))[:, None]
        tau = np.array([[10.5], [20.25]], np.float32)
        y = np.asarray(interpd(x, tau, method="cubic"))
        assert y.shape == (2, 1)
        assert abs(y[0, 0] - np.sin(10.5 * 6.28 / 63)) < 1e-3
    """
    return interp1(x, tau, method=method, extrap=extrap)


def interpf(x, tau, extrap=None, chunk: int = 2048):
    """Frequency-domain (sinc / Fourier) interpolation: evaluates the
    trigonometric interpolant of ``x`` at fractional indices ``tau``.

    Implements the missing-from-snapshot ``interpf`` referenced by
    ``ChannelData.sample(..., 'freq')`` (``src/ChannelData.m:1334``) as an
    FFT-phase-shift evaluation: ``y = sum_k X[k] exp(2i pi f_k tau) / T``
    — a dense (C x T) x (T, *B) contraction (a GEMM). The phasor is
    materialized per query block of ``chunk`` leading indices
    (``lax.map``), so peak memory is O(chunk * D * T) instead of
    O(I * D * T) regardless of the query count.
    """
    x = jnp.asarray(x)
    tau = jnp.asarray(tau)
    if tau.ndim == 0:
        tau = tau[None]
    X = jnp.fft.fft(x, axis=0)  # (T, *B) — computed ONCE, outside the map
    T, B = x.shape[0], x.shape[1:]

    def blk(tb):  # evaluate one query block against the spectrum
        C = tb.shape[1:]
        D = bshape_left(C, B)
        f = jnp.fft.fftfreq(T).astype(jnp.float32)  # cycles/sample
        # y[i, *D] = (1/T) sum_k exp(2i pi f_k tau[i, *D]) X[k, *D]
        taue = jnp.broadcast_to(expand_trailing(tb, 1 + len(D)),
                                (tb.shape[0],) + D)
        Xe = jnp.broadcast_to(expand_trailing(X, 1 + len(D)), (T,) + D)
        ph = cexp(2 * jnp.pi * taue[..., None] * f)  # (i, *D, T)
        y = jnp.sum(ph * jnp.moveaxis(Xe, 0, -1)[None], axis=-1) / T
        if not jnp.iscomplexobj(x):
            y = y.real
        return y

    I = tau.shape[0]
    if not chunk or I <= chunk:
        return blk(tau)
    nb = -(-I // chunk)
    taup = jnp.pad(tau, [(0, nb * chunk - I)] + [(0, 0)] * (tau.ndim - 1))
    blocks = taup.reshape((nb, chunk) + tau.shape[1:])
    y = jax.lax.map(blk, blocks)
    return y.reshape((nb * chunk,) + y.shape[2:])[:I]


def _phase(omega, tau, dtype):
    if isinstance(omega, (int, float)) and omega == 0:
        return None
    return cexp(omega * tau).astype(dtype)


def wsinterpd(x, tau, w=None, sdim: Union[int, Sequence[int], None] = None,
              omega=0.0, method: str = "cubic", extrap=0.0):
    """Weighted-sum interpolation (``kern/wsinterpd.m`` /
    ``interpd.cu:293-342``):

        y = sum_{sdim} w * exp(1j * omega * tau) * sample(x, tau)

    ``x``: (T, *B); ``tau``: fractional indices, broadcastable; ``w``:
    weights broadcastable to the sampled shape; ``sdim``: output dims to sum
    over (after broadcasting). omega is in radians per unit of ``tau``.

    Example:
        import numpy as np
        from qups_jax.ops import wsinterpd
        x = np.arange(32, dtype=np.float32)[:, None]     # ramp, 1 channel
        tau = np.array([[4.0, 6.0]], np.float32)         # (1, 2) delays
        w = np.array([[0.5, 0.5]], np.float32)
        y = np.asarray(wsinterpd(x, tau, w=w, sdim=1))   # weighted sum
        assert abs(y.item() - 5.0) < 1e-5                # (4 + 6) / 2
    """
    v = interp1(x, tau, method=method, extrap=extrap)
    ph = _phase(omega, jnp.asarray(tau),
                jnp.complex64 if v.dtype != jnp.complex128 else jnp.complex128)
    if ph is not None:
        v = v * expand_trailing(ph, v.ndim)
    if w is not None:
        v = v * expand_trailing(w, v.ndim)
    if sdim is None:
        return v
    sdims = (sdim,) if isinstance(sdim, int) else tuple(sdim)
    return jnp.sum(v, axis=sdims, keepdims=True)


def wsinterpd2(x, tau1, tau2, w=None, sdim: Union[int, Sequence[int], None] = None,
               omega=0.0, method: str = "cubic", extrap=0.0):
    """Separable-delay weighted-sum interpolation (``kern/wsinterpd2.m`` /
    ``interpd.cu:345-396``): like :func:`wsinterpd` with
    ``tau = tau1 + tau2`` where the two delay tensors broadcast against each
    other (left-aligned) — the memory-frugal path used by
    ``focusTx``/``bfDASLUT``.

    Memory contract (the point of the separable kernel — the reference
    never materializes the joint ``tau1 + tau2`` tensor): when a summed dim
    ``d`` is singleton in one of the two delay tensors, the computation is
    streamed as a ``lax.scan`` over ``d``, so peak live memory is the
    per-slice broadcast times the output — O(T*N*M), not O(T*N*M*M').
    Non-separable summed dims (both tensors non-singleton) fall back to the
    dense broadcast.

    Example:
        import numpy as np
        from qups_jax.ops import wsinterpd, wsinterpd2
        x = np.random.default_rng(0).standard_normal((32, 3)).astype(np.float32)
        t1 = np.linspace(2, 8, 5, dtype=np.float32).reshape(5, 1, 1)
        t2 = np.linspace(0, 1, 3, dtype=np.float32).reshape(1, 3, 1)
        # separable tau = t1 + t2, summed over the channel dim
        y2 = np.asarray(wsinterpd2(x[:, :, None], t1, t2, sdim=1))
        yd = np.asarray(wsinterpd(x[:, :, None], t1 + t2, sdim=1))
        assert np.allclose(y2, yd, atol=1e-5)
    """
    t1 = jnp.asarray(tau1)
    t2 = jnp.asarray(tau2)
    x = jnp.asarray(x)
    sdims = () if sdim is None else (
        (sdim,) if isinstance(sdim, int) else tuple(sdim))

    nd = max(t1.ndim, t2.ndim)
    # output rank: I dim (from tau) + broadcast of data batch dims
    ndo = max(nd, 1 + (x.ndim - 1), np.ndim(w) if w is not None else 0)
    t1 = expand_trailing(t1, ndo)
    t2 = expand_trailing(t2, ndo)
    xe = expand_trailing(x, 1 + (ndo - 1))
    we = expand_trailing(jnp.asarray(w), ndo) if w is not None else None

    # pick the scan dim: the largest summed dim where the delays separate
    # (one of tau1/tau2 singleton). Scanning it keeps tau1+tau2 per-slice.
    best, best_sz = None, 1
    for d in sdims:
        if d == 0 or d >= ndo:
            continue
        sz = max(t1.shape[d], t2.shape[d],
                 xe.shape[d] if d < xe.ndim else 1,
                 we.shape[d] if we is not None else 1)
        if sz > best_sz and (t1.shape[d] == 1 or t2.shape[d] == 1):
            best, best_sz = d, sz
    if best is None or best_sz <= 4:
        tau = t1 + t2
        return wsinterpd(x, tau, w=w, sdim=sdim, omega=omega,
                         method=method, extrap=extrap)

    d = best
    rest = tuple(s for s in sdims if s != d)

    def pick(a, axis_offset=0):
        """(constant, scanned) pair: move dim d to front when non-singleton."""
        ad = d + axis_offset
        if a is None or a.shape[ad] == 1:
            return a, None
        return None, jnp.moveaxis(a, ad, 0)

    t1c, t1s = pick(t1)
    t2c, t2s = pick(t2)
    xc, xs_ = pick(xe)  # data dims align with output dims here (time<->I)
    wc, ws_ = pick(we) if we is not None else (None, None)

    # probe one slice to get the output slice shape/dtype
    def one(t1_, t2_, x_, w_):
        tau = t1_ + t2_
        return wsinterpd(x_, tau, w=w_, sdim=rest if rest else None,
                         omega=omega, method=method, extrap=extrap)

    def slice_args(parts):
        """Combine per-step slices with the constants, re-inserting dim d
        (moveaxis put it in front of the scanned tensors) as size 1."""
        t1i, t2i, xi, wi = parts
        t1_ = t1c if t1s is None else jnp.expand_dims(t1i, d)
        t2_ = t2c if t2s is None else jnp.expand_dims(t2i, d)
        x_ = xc if xs_ is None else jnp.expand_dims(xi, d)
        w_ = wc if ws_ is None else jnp.expand_dims(wi, d)
        return t1_, t2_, x_, w_

    zs = (t1s, t2s, xs_, ws_)
    scanned = tuple(a for a in zs if a is not None)
    idxs = [i for i, a in enumerate(zs) if a is not None]

    def args_at(sl):
        parts = [None, None, None, None]
        for i, v in zip(idxs, sl):
            parts[i] = v
        return slice_args(tuple(parts))

    y0 = jax.eval_shape(lambda: one(*args_at([a[0] for a in scanned])))
    from ..utils.cpx import czeros
    acc0 = czeros(y0.shape) if jnp.issubdtype(y0.dtype, jnp.complexfloating) \
        else jnp.zeros(y0.shape, y0.dtype)

    def body(acc, sl):
        return acc + one(*args_at(sl)), None

    acc, _ = jax.lax.scan(body, acc0, scanned)
    return acc


@partial(jax.jit, static_argnames=("r", "axis"))
def fft_upsample(x, r: int = 2, axis: int = 0):
    """Exact band-limited ``r``x upsampling along ``axis`` by spectral
    zero-padding (Nyquist bin split for even lengths): sample ``n`` of
    the output equals the trigonometric interpolant of ``x`` at ``n/r``.
    The one-time trace-oversampling step of the ``cubic2x`` DAS sampler
    (linear interpolation on 2x-oversampled RF is the classic
    cubic-accuracy substitute for the 4-tap premium; the reference's
    resampling path is ``ChannelData.resample``, ``ChannelData.m:1042``).

    Example:
        import numpy as np, jax.numpy as jnp
        from qups_jax.ops.interp import fft_upsample
        t = np.arange(64) / 64.0
        x = np.sin(2 * np.pi * 5 * t).astype(np.float32)
        y = np.asarray(fft_upsample(x, 2))
        t2 = np.arange(128) / 128.0
        assert np.abs(y - np.sin(2 * np.pi * 5 * t2)).max() < 1e-5
    """
    x = jnp.asarray(x)
    r = int(r)
    if r == 1:
        return x
    x = jnp.moveaxis(x, axis, 0)
    T = x.shape[0]
    if jnp.iscomplexobj(x):
        X = jnp.fft.fft(x, axis=0)
        hi = T // 2  # positive bins [0, hi); negative [hi, T) (even T)
        pad = [(0, r * T - T)] + [(0, 0)] * (x.ndim - 1)
        if T % 2 == 0:
            # split the Nyquist bin across +/- f_N
            nyq = X[hi:hi + 1] * 0.5
            Xp = jnp.concatenate([X[:hi], nyq,
                                  jnp.zeros((r * T - T - 1,) + X.shape[1:],
                                            X.dtype),
                                  nyq, X[hi + 1:]], axis=0)
        else:
            h = (T + 1) // 2
            Xp = jnp.concatenate([X[:h],
                                  jnp.zeros((r * T - T,) + X.shape[1:],
                                            X.dtype), X[h:]], axis=0)
        y = jnp.fft.ifft(Xp, axis=0) * r
    else:
        X = jnp.fft.rfft(x, axis=0)
        if T % 2 == 0:
            X = X.at[-1].multiply(0.5)  # Nyquist split (conj half implicit)
        Kp = r * T // 2 + 1 - X.shape[0]
        y = jnp.fft.irfft(jnp.pad(X, [(0, Kp)] + [(0, 0)] * (x.ndim - 1)),
                          n=r * T, axis=0) * r
        y = y.astype(x.dtype)
    return jnp.moveaxis(y, 0, axis)
