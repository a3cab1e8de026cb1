"""Frequency-domain beamforming: adjoint, REFoCUS decoding, Stolt migration.

Equivalents of QUPS's frequency-domain methods — the GEMM-heavy
beamformers (batched complex GEMMs / FFTs per frequency bin):

* :func:`bf_adjoint` — matrix adjoint beamformer
  (``UltrasoundSystem.bfAdjoint``, ``src/UltrasoundSystem.m:3770-4050``).
* :func:`refocus` — REFoCUS transmit decoding back to FSA
  (``UltrasoundSystem.refocus``, ``src/UltrasoundSystem.m:3505-3768``).
* :func:`stolt_migration` — Stolt f-k plane-wave migration
  (``UltrasoundSystem.bfMigration``, ``src/UltrasoundSystem.m:4675-4887``).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils.cpx import cexp, czeros

from .interp import interp1

# every GEMM here runs in full f32: under the GPU's default precision a
# float32 (or complex64) dot would run in TF32
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.jit
def spectral_level(x):
    """Per-bin spectral level in dB (max over traces) — module-level
    jit so repeated bfAdjoint calls reuse the compiled program."""
    T = x.shape[0]
    return 20.0 * jnp.log10(
        jnp.abs(jnp.fft.fft(x, axis=0)).reshape(T, -1).max(axis=1)
        + 1e-30)


@jax.jit
def geom_delays(pi, pos, cinv):
    """Device-side geometric delay table ``|pi - pos| * cinv`` — (I, E)
    from pixels (I, 3) and element positions (E, 3).

    Host-side f64 construction of these tables is a trap at imaging scale:
    (1e6, 256) f64 is 2 GB of host compute + upload PER TABLE per call.
    The reference builds them on-GPU for the same reason
    (``UltrasoundSystem.m:3941-3952``)."""
    return jnp.linalg.norm(pi[:, None, :] - pos[None], axis=-1) * cinv


@partial(jax.jit, static_argnames=("fs", "fmod", "keep_rx", "keep_tx"))
def bf_adjoint(x, tau_rx, tau_tx, del_tx, apod_tx, t0, t0_off, fbins, *,
               fs: float, fmod: float = 0.0, keep_rx: bool = False,
               keep_tx: bool = False):
    """Frequency-domain adjoint beamformer.

    For each selected DFT bin k (frequency f = k fs / K):

        A(i, v)  = sum_m exp(-2j pi f tau_tx[i, m]) apod[m, v]
                   exp(-2j pi f del_tx[m, v])          (tx steering GEMM)
        Ahat     = A / |A|_v                            (power-normalized)
        yn(i, v) = sum_n exp(+2j pi f tau_rx[i, n]) X[k, n, v]  (rx adjoint)
        b(i)    += sum_v yn(i, v) conj(Ahat(i, v))

    following ``UltrasoundSystem.m:4015-4027``.

    Args:
      x: channel data (T, N, V) (tx dim = synthesized pulses V).
      tau_rx: (I, N) rx geometric delays [s]; tau_tx: (I, M) tx element
        delays [s]; del_tx: (M, V) sequence firing delays (incl. t0Offset);
        apod_tx: (M, V) sequence apodization.
      t0: per-pulse data start time, scalar or (V,); t0_off: per-pulse
        t0Offset of the sequence (V,).
      fbins: int32 array of DFT bin indices to process (static count; pad
        with -1 to skip).
    """
    x = jnp.asarray(x)
    T, N, V = x.shape[:3]
    K = T
    df = fs / K
    t = jnp.arange(T, dtype=jnp.float32)[:, None, None] / fs
    t0 = jnp.broadcast_to(jnp.asarray(t0, jnp.float32).reshape(-1), (V,))
    t0_off = jnp.broadcast_to(jnp.asarray(t0_off, jnp.float32).reshape(-1), (V,))
    f = (jnp.arange(K, dtype=jnp.float32) * df)[:, None, None]  # (K,1,1)
    xr = x * cexp((2 * np.pi * fmod) * (t + t0[None, None, :]))
    X = jnp.fft.fft(xr, axis=0)
    X = X * cexp(-2 * np.pi * f * t0[None, None, :])
    X = X * cexp(+2 * np.pi * f * t0_off[None, None, :])

    tau_rx = jnp.asarray(tau_rx, jnp.float32)
    tau_tx = jnp.asarray(tau_tx, jnp.float32)
    del_tx = jnp.asarray(del_tx, jnp.float32)
    apod_tx = jnp.asarray(apod_tx, jnp.float32)
    I = tau_rx.shape[0]

    if keep_rx and keep_tx:
        raise ValueError("keep_rx and keep_tx are mutually exclusive here")
    out_shape = (I, N) if keep_rx else ((I, V) if keep_tx else (I,))
    mm = partial(jnp.matmul, precision=_HIGHEST)

    def step(acc, k):
        fk = k.astype(jnp.float32) * df
        valid = k >= 0
        Xf = jax.lax.dynamic_index_in_dim(X, jnp.maximum(k, 0), 0,
                                          keepdims=False)  # (N, V)
        Wtx = cexp(-2 * np.pi * fk * tau_tx)  # (I, M)
        # element m fires at -del[m, v] (the focusTx convention), so the
        # wave from m reaches pixel i at tau_tx(i, m) - del(m, v)
        S = apod_tx * cexp(+2 * np.pi * fk * del_tx)  # (M, V)
        A = mm(Wtx, S.astype(Wtx.dtype))  # (I, V)
        nrm = jnp.sqrt(jnp.sum(jnp.abs(A) ** 2, axis=1, keepdims=True))
        Ah = A / jnp.where(nrm == 0, 1.0, nrm)
        Wrx = cexp(+2 * np.pi * fk * tau_rx)  # (I, N)
        if keep_rx:
            # b(i,n) = W(i,n) * sum_v X(n,v) conj(Ah(i,v))
            y = Wrx * mm(jnp.conj(Ah), Xf.T)
        elif keep_tx:
            y = mm(Wrx, Xf) * jnp.conj(Ah)
        else:
            y = jnp.sum(mm(Wrx, Xf) * jnp.conj(Ah), axis=1)
        return acc + jnp.where(valid, 1.0, 0.0) * y, None

    acc0 = czeros(out_shape)
    b, _ = jax.lax.scan(step, acc0, jnp.asarray(fbins, jnp.int32))
    return b


def select_fbins(x_host: np.ndarray, fs: float, fthresh_db: float = -np.inf,
                 max_bins: Optional[int] = None) -> np.ndarray:
    """Host-side frequency-bin selection (``UltrasoundSystem.m:3934-3938``):
    positive-frequency bins within ``fthresh_db`` of the spectral peak."""
    X = np.fft.fft(x_host, axis=0)
    T = x_host.shape[0]
    lev = 20 * np.log10(np.abs(X).reshape(T, -1).max(axis=1) + 1e-30)
    lev = lev - lev.max()
    f = np.fft.fftfreq(T) * fs
    sel = np.where((lev >= fthresh_db) & (f >= 0) & (f < fs / 2))[0]
    if max_bins is not None and sel.size > max_bins:
        keep = np.argsort(lev[sel])[::-1][:max_bins]
        sel = np.sort(sel[keep])
    return sel.astype(np.int32)


@partial(jax.jit, static_argnames=("fs",))
def focus_tx_freq(x, t2, w, *, fs: float):
    """Frequency-domain transmit synthesis — the GEMM form of ``focusTx``
    (``UltrasoundSystem.m:3374-3503`` / ``interpd.cu:345-396``):

        y[t, n, m'] = sum_m w[m, m'] x(t + t2[m, m'], n, m)

    The per-(m, m') delay is CONSTANT over time and channel, so the
    time-domain gather-resample becomes a per-bin transmit GEMM:
    ``Y_k = X_k H_k`` with
    ``H_k[m, m'] = w e^{+2i pi f_k t2}`` — exact band-limited (sinc)
    interpolation semantics, the 'freq' mode of ``ChannelData.sample``
    (``src/ChannelData.m:1334``).

    Args: x (T, N, M[, F...]) real or complex, already zero-padded so the
    shifted support stays in [0, T); t2 (M, M') [s]; w (M, M').
    Returns (T, N, M'[, F...]) with x's realness preserved.
    """
    x = jnp.asarray(x)
    T = x.shape[0]
    t2 = jnp.asarray(t2, jnp.float32)
    w = jnp.asarray(w, jnp.float32)
    cplx = jnp.iscomplexobj(x)
    if cplx:
        f = (jnp.fft.fftfreq(T) * fs).astype(jnp.float32)
        X = jnp.fft.fft(x, axis=0)
    else:
        f = (jnp.fft.rfftfreq(T) * fs).astype(jnp.float32)
        X = jnp.fft.rfft(x, axis=0)
    H = w[None] * cexp(2 * np.pi * f[:, None, None] * t2[None])  # (K, M, M')
    Y = jnp.einsum("knm...,kmp->knp...", X, H, precision=_HIGHEST)
    if cplx:
        return jnp.fft.ifft(Y, axis=0)
    return jnp.fft.irfft(Y, n=T, axis=0)


@partial(jax.jit, static_argnames=("T", "fs", "method", "gamma"))
def refocus_op(tau, apd, *, T: int, fs: float,
               gamma: Optional[float] = None, method: str = "tikhonov",
               f=None):
    """The data-INDEPENDENT REFoCUS decode operator ``Hi (K, M, V)``:
    per frequency, the (whitened) inverse of the encoding matrix
    ``H[v, m] = apd[m, v] exp(+2j pi f tau[m, v])``
    (``UltrasoundSystem.m:3696-3719``). The batched spectral norm + solve
    is the expensive half of a decode (~5 s of the 5.8 s headline
    decode), so it is split out for reuse across frames — the analog of
    the reference hot-pathing ``Hi`` once per sequence.

    ``f``: optional explicit frequency values (K,) [Hz] replacing the
    full fftfreq(T) grid — the per-bin solves are independent, so a
    caller can shard the bin axis (``parallel.refocus_op_sharded``)."""
    M = tau.shape[0]
    if gamma is None:
        gamma = 10.0 * (M / 10.0) ** 2
    if f is None:
        f = (jnp.fft.fftfreq(T) * fs).astype(jnp.float32)  # (T,)
    else:
        f = jnp.asarray(f, jnp.float32).reshape(-1)
    tauT = jnp.asarray(tau, jnp.float32).T  # (V, M)
    aT = jnp.asarray(apd, jnp.float32).T    # (V, M)
    H = aT[None] * cexp(+2 * np.pi * f[:, None, None] * tauT[None])  # (K,V,M)
    # per-frequency spectral norm for whitening (reference pagenorm2)
    s = jnp.linalg.matrix_norm(H, ord=2) if hasattr(jnp.linalg, "matrix_norm") \
        else jnp.linalg.norm(H, ord=2, axis=(1, 2))
    w = 1.0 / jnp.maximum(s, 1e-30) ** 2  # (K,)
    if method == "tikhonov":
        HH = jnp.einsum("kvm,kvn->kmn", jnp.conj(H), H,
                        precision=_HIGHEST)  # (K, M, M)
        A = HH + (gamma * w)[:, None, None] * jnp.eye(M, dtype=HH.dtype)
        Hi = jnp.linalg.solve(A, jnp.conj(jnp.swapaxes(H, 1, 2)))  # (K, M, V)
    elif method == "adjoint":
        Hi = jnp.conj(jnp.swapaxes(H, 1, 2)) * w[:, None, None]
    elif method == "pinv":
        Hi = jnp.linalg.pinv(H) * w[:, None, None]
    else:
        raise ValueError(method)
    return jnp.nan_to_num(Hi)


@partial(jax.jit, static_argnames=("fs",))
def refocus_apply(x, Hi, t0, *, fs: float):
    """Apply a :func:`refocus_op` operator to (T, N, V) data: FFT,
    per-frequency transmit-dim GEMM, inverse FFT
    (``UltrasoundSystem.m:3736-3767``)."""
    x = jnp.asarray(x)
    T = x.shape[0]
    V = Hi.shape[2]
    f = (jnp.fft.fftfreq(T) * fs).astype(jnp.float32)
    t0 = jnp.asarray(t0, jnp.float32).reshape(-1)
    t0v = jnp.broadcast_to(t0, (V,))
    X = jnp.fft.fft(x, axis=0)
    X = X * cexp(-2 * np.pi * f[:, None, None] * t0v[None, None, :])
    # y[k, n, m] = sum_v Hi[k, m, v] X[k, n, v]   (batched complex GEMM)
    Y = jnp.einsum("kmv,knv->knm", Hi, X, precision=_HIGHEST)
    t0min = jnp.min(t0)
    Y = Y * cexp(+2 * np.pi * f[:, None, None] * t0min)
    return jnp.fft.ifft(Y, axis=0), t0min


def refocus(x, tau, apd, t0, *, fs: float, gamma: Optional[float] = None,
            method: str = "tikhonov"):
    """REFoCUS: decode synthesized-transmit data back to FSA
    (``UltrasoundSystem.refocus``, ``UltrasoundSystem.m:3696-3767``).

    Per frequency f: encoding ``H[v, m] = apd[m, v] exp(+2j pi f tau[m, v])``
    (matching ``focusTx``: pulse v sums ``x_m(t + tau[m, v])``);
    inverse by tikhonov ``(H'H + gamma w I) \\ H'``, adjoint, or pinv
    (:func:`refocus_op`); then the per-frequency transmit-dim matrix
    multiply and inverse FFT (:func:`refocus_apply`).

    Args: x (T, N, V); tau (M, V) element firing delays; apd (M, V).
    Returns: (T, N, M) FSA data (t0 handling is the caller's: the output time
    axis matches the input's).
    """
    T = np.shape(x)[0]
    Hi = refocus_op(np.asarray(tau, np.float32), np.asarray(apd, np.float32),
                    T=int(T), fs=fs, gamma=gamma, method=method)
    return refocus_apply(x, Hi, t0, fs=fs)


@partial(jax.jit, static_argnames=("fs", "fmod", "keep_tx", "method",
                                   "jacobian", "pitch", "c0", "angles_deg",
                                   "nfft", "out"))
def stolt_migration(x, t0, del_tx, angles_deg, *, fs: float, c0: float,
                    pitch: float, fmod: float = 0.0, keep_tx: bool = False,
                    method: str = "cubic", jacobian: bool = True,
                    nfft: Optional[Tuple[int, int]] = None,
                    out: str = "complex", gamma=None):
    """Stolt f-k migration for plane-wave data on a linear array
    (``UltrasoundSystem.bfMigration``, ``UltrasoundSystem.m:4740-4860``):

    2-D FFT (t, x) -> (f, kx); exploding-reflector remap
    ``f -> cs sign(f) sqrt(kx^2 + f^2/cs^2)`` with ``cs = c0/sqrt(2)`` and
    optional jacobian; Garcia's PWI lateral alignment
    ``gamma = sin(th)/(2 - cos(th))``; inverse FFTs give the image on the
    (z = c0 t/2, x = element) grid.

    Args: x (T, N, M); t0 scalar or (M,); del_tx (N, M) sequence delays.
    Returns image (T, N, M') with M' = M if keep_tx else 1.
    """
    x = jnp.asarray(x)
    T, N, M = x.shape[:3]
    # FFT sizes: pad to avoid wrap-around of echoes near the window edges
    # (the reference exposes this as the Nfft argument,
    # ``UltrasoundSystem.m:4744``)
    F, K = nfft if nfft is not None else (T, N)
    cs = c0 / np.sqrt(2.0)
    f = ((np.arange(F) - F // 2) / F * fs).astype(np.float32)  # centered
    kx = ((np.arange(K) - K // 2) / K / pitch).astype(np.float32)
    fj = jnp.asarray(f)[:, None, None]
    kxj = jnp.asarray(kx)[None, :, None]
    t0 = jnp.broadcast_to(jnp.asarray(t0, jnp.float32).reshape(-1), (M,))
    t = jnp.arange(T, dtype=jnp.float32)[:, None, None] / fs + t0[None, None, :]

    xr = x * cexp((2 * np.pi * fmod) * t)
    Xf = jnp.fft.fftshift(jnp.fft.fft(xr, n=F, axis=0), axes=0)
    Xf = Xf * cexp(-2 * np.pi * fj * t0[None, None, :])
    Xf = Xf * cexp(-2 * np.pi * fj * jnp.asarray(del_tx, jnp.float32)[None])
    Xk = jnp.fft.fftshift(jnp.fft.fft(Xf, n=K, axis=1), axes=1)

    fkz = cs * jnp.sign(fj) * jnp.sqrt(kxj ** 2 + (fj / cs) ** 2)  # (F,K,1)
    kkz = (fkz - f[0]) * F / fs  # 0-based fractional bin index
    y = interp1(Xk, jnp.broadcast_to(kkz, (F, K, M)), method=method)
    if jacobian:
        kz = fj / cs
        y = (y * kz) / (fkz + 1e-30)
    y = y * cexp(+2 * np.pi * fj * t0[None, None, :])
    b = jnp.fft.ifft(jnp.fft.ifftshift(y, axes=0), n=F, axis=0)
    # lateral alignment for steered plane waves (Garcia PWI). ``gamma``
    # may be passed as a TRACED (M,) array instead of the static angle
    # tuple — the angle-sharded composition (parallel.migration_sharded)
    # feeds each shard its own alignment factors through one program.
    if gamma is None:
        th = np.radians(np.asarray(angles_deg, np.float64))
        gamma = (np.sin(th) / (2 - np.cos(th))).astype(np.float32)  # (M,)
    gamma = jnp.asarray(gamma, jnp.float32)
    tb = jnp.arange(F, dtype=jnp.float32)[:, None, None] / fs + t0[None, None, :]
    zax = c0 / 2 * tb  # (F, 1, M)
    b = b * cexp(2 * np.pi * kxj * jnp.asarray(gamma)[None, None, :] * zax)
    b = jnp.fft.ifft(jnp.fft.ifftshift(b, axes=1), n=K, axis=1)
    b = b[:T, :N]
    if not keep_tx:
        b = jnp.sum(b, axis=2, keepdims=True)
    if out == "ri":
        # real/imaginary pair on a trailing axis
        return jnp.stack([jnp.real(b), jnp.imag(b)], axis=-1)
    return b
