"""Echo (channel) data container.

Counterpart of QUPS's ``ChannelData``
(``/root/reference/src/ChannelData.m:36-2008``): an array ``data`` of echo
traces with canonical axes ``(T, N, M, *F)`` — time samples, receive
elements, transmits, then arbitrary frame/batch dims — a scalar sampling
frequency ``fs``, and a per-transmit start time ``t0`` broadcastable against
the non-time dims. The time axis is always derivable as
``t = t0 + arange(T)/fs`` (``ChannelData.m:1667``).

Unlike the reference there is no runtime ``order`` permutation
(``'TNM'`` is canonical — a MATLAB-ism replaced by fixed axes + ``vmap``);
use plain ``jnp.moveaxis`` on ``.data`` for custom layouts.

The object is a registered JAX pytree (``data``/``t0`` are leaves), so it
passes through ``jit``/``vmap``/``shard_map`` directly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import math
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.interp import interp1, interpf, wsinterpd, wsinterpd2
from ..utils.cpx import cexp

TDIM, NDIM, MDIM = 0, 1, 2


@dataclass(frozen=True)
class ChannelData:
    data: jnp.ndarray           # (T, N, M, *F)
    fs: float = 1.0             # sampling frequency [Hz] (static)
    t0: Union[float, jnp.ndarray] = 0.0  # start time, broadcastable to (1, N|1, M|1, *F)

    def __post_init__(self):
        d = self.data if hasattr(self.data, "ndim") else jnp.asarray(self.data)
        assert d.ndim >= 3, "data must be at least (T, N, M)"
        object.__setattr__(self, "data", d)
        # t0 is tiny metadata: keep it host-side (numpy / python float) so
        # reading it never waits on the device; tracers pass through
        t0 = self.t0
        if isinstance(t0, (int, float)):
            t0 = float(t0)
        elif isinstance(t0, np.ndarray) or not isinstance(t0, jnp.ndarray):
            t0 = np.asarray(t0, dtype=np.float32)
            while 0 < t0.ndim < 3 and t0.size > 1:
                t0 = t0[None]  # lift vector t0 to (1, 1, M)-style
        object.__setattr__(self, "t0", t0)

    # ------------------------------------------------------------ properties
    @property
    def T(self) -> int: return self.data.shape[TDIM]
    @property
    def N(self) -> int: return self.data.shape[NDIM]
    @property
    def M(self) -> int: return self.data.shape[MDIM]
    @property
    def shape(self): return self.data.shape

    @property
    def time(self) -> jnp.ndarray:
        """Time axis ``t0 + (0:T-1)'/fs`` shaped (T, 1, [1|M], ...)."""
        n = jnp.arange(self.T, dtype=jnp.float32).reshape((-1,) + (1,) * (self.data.ndim - 1))
        return self.t0 + n / self.fs

    @property
    def tend(self):
        return self.t0 + (self.T - 1) / self.fs

    @property
    def t0_host(self) -> np.ndarray:
        """t0 as a flat host array (device-safe)."""
        t0 = self.t0
        if isinstance(t0, (int, float)):
            return np.array([t0], np.float64)
        if isinstance(t0, np.ndarray):
            return t0.reshape(-1).astype(np.float64)
        return np.asarray(jax.device_get(t0)).reshape(-1).astype(np.float64)

    @property
    def _ddata(self):
        """``data`` for the DSP methods below. Host numpy stays host until
        a method actually needs device math (the out-of-core streaming
        contract of ``system.DAS(bsize)``)."""
        return self.data

    def replace(self, **changes) -> "ChannelData":
        return dataclasses.replace(self, **changes)

    def astype(self, dtype) -> "ChannelData":
        return self.replace(data=self.data.astype(dtype))

    # -------------------------------------------------------------- sampling
    def sample(self, tau, method: str = "cubic", w=None, sdim=None, fmod=0.0):
        """Sample the data at times ``tau`` (seconds, absolute), applying
        weights ``w``, summing over dims ``sdim``, and re-modulating at
        ``fmod`` (``ChannelData.sample``, ``ChannelData.m:1230-1336``):

            y = sum_sdim w * exp(2j pi fmod (tau - t0)) * x((tau - t0) fs)
        """
        ntau = (jnp.asarray(tau) - self.t0) * self.fs
        omega = 2 * np.pi * fmod / self.fs
        if method == "freq":
            v = interpf(self._ddata, ntau)
            if fmod:
                v = v * cexp(omega * ntau)
            if w is not None:
                v = v * w
            if sdim is not None:
                sdims = (sdim,) if isinstance(sdim, int) else tuple(sdim)
                v = jnp.sum(v, axis=sdims, keepdims=True)
            return v
        return wsinterpd(self._ddata, ntau, w=w, sdim=sdim, omega=omega, method=method)

    def sample2sep(self, tau1, tau2, method: str = "cubic", w=None, sdim=None, fmod=0.0):
        """Sample at separable times ``tau1 + tau2``
        (``ChannelData.sample2sep``, ``ChannelData.m:1338-1447``) — the
        delay tensors broadcast, so nothing of size ``I x N x M``
        materializes in HBM before the fused interp."""
        from ..ops.interp import bshape_left
        t0 = self.t0
        # fold t0 into the smaller tensor
        if np.prod(bshape_left(np.shape(tau1), np.shape(t0)), dtype=np.int64) \
                <= np.prod(bshape_left(np.shape(tau2), np.shape(t0)), dtype=np.int64):
            n1 = (jnp.asarray(tau1) - t0) * self.fs
            n2 = jnp.asarray(tau2) * self.fs
        else:
            n1 = jnp.asarray(tau1) * self.fs
            n2 = (jnp.asarray(tau2) - t0) * self.fs
        omega = 2 * np.pi * fmod / self.fs
        return wsinterpd2(self._ddata, n1, n2, w=w, sdim=sdim, omega=omega, method=method)

    # ------------------------------------------------------------------- DSP
    def downmix(self, fc: float) -> "ChannelData":
        """Demodulate (downmix) by ``fc``: multiply by ``exp(-2j pi fc t)``
        (``ChannelData.downmix``, ``ChannelData.m:757``)."""
        d = self._ddata * cexp(-2 * np.pi * fc * self.time)
        return self.replace(data=d)

    def hilbert(self) -> "ChannelData":
        """Analytic signal along the time axis (``ChannelData.m:935``)."""
        x = jnp.real(self._ddata)
        T = self.T
        X = jnp.fft.fft(x, axis=TDIM)
        h = np.zeros(T)
        h[0] = 1
        if T % 2 == 0:
            h[T // 2] = 1
            h[1: T // 2] = 2
        else:
            h[1: (T + 1) // 2] = 2
        hsh = jnp.asarray(h).reshape((-1,) + (1,) * (self.data.ndim - 1))
        return self.replace(data=jnp.fft.ifft(X * hsh, axis=TDIM))

    def get_passband_filter(self, bw: Tuple[float, float], order: int = 64) -> jnp.ndarray:
        """Linear-phase FIR bandpass via the window method
        (``ChannelData.getPassbandFilter``, ``ChannelData.m:808``)."""
        lo, hi = bw
        return _fir_design(order, self.fs, lo=lo, hi=hi)

    def get_lowpass_filter(self, cutoff: float, order: int = 64) -> jnp.ndarray:
        """(``ChannelData.getLowpassFilter``, ``ChannelData.m:833``)."""
        return _fir_design(order, self.fs, lo=None, hi=cutoff)

    def filter(self, h) -> "ChannelData":
        """Causal FIR filter along time; ``t0`` is advanced by the filter's
        group delay so linear-phase filters stay time-aligned
        (``ChannelData.filter``, ``ChannelData.m:857-934``)."""
        from ..ops.conv import convd
        h = jnp.asarray(h).reshape((-1,) + (1,) * (self.data.ndim - 1))
        L = h.shape[0]
        d = convd(self._ddata, h, axis=TDIM, shape="full")
        return self.replace(data=d, t0=self.t0 - (L - 1) / 2 / self.fs)

    def filtfilt(self, h) -> "ChannelData":
        """Zero-phase forward-backward filtering."""
        from ..ops.conv import convd
        h = jnp.asarray(h).reshape((-1,) + (1,) * (self.data.ndim - 1))
        hh = convd(h, jnp.flip(jnp.conj(h), axis=0), axis=TDIM, shape="full")
        L = hh.shape[0]
        d = convd(self._ddata, hh, axis=TDIM, shape="full")
        return self.replace(data=d, t0=self.t0 - (L - 1) / 2 / self.fs)

    def fft(self, n: Optional[int] = None):
        return jnp.fft.fft(self._ddata, n=n, axis=TDIM)

    def fftaxis(self, n: Optional[int] = None) -> np.ndarray:
        n = n or self.T
        return np.fft.fftfreq(n) * self.fs

    def downsample(self, k: int) -> "ChannelData":
        return self.replace(data=self.data[::k], fs=self.fs / k)

    def resample(self, fs_new: float, method: str = "cubic") -> "ChannelData":
        """Resample to a new rate, preserving the time window
        (``ChannelData.resample``, ``ChannelData.m:1042-1095``)."""
        ratio = fs_new / self.fs
        Tn = int(np.ceil(self.T * ratio))
        ntau = jnp.arange(Tn).reshape((-1,) + (1,) * (self.data.ndim - 1)) / ratio
        d = interp1(self._ddata, ntau, method=method)
        return self.replace(data=d, fs=fs_new)

    def convt(self, wv_samples, lag0: float = 0.0) -> "ChannelData":
        """Convolve along time with a sampled kernel; ``t0`` shifts by the
        kernel's start time (``ChannelData.convt``, ``ChannelData.m:1105``)."""
        from ..ops.conv import convd
        h = jnp.asarray(wv_samples).reshape((-1,) + (1,) * (self.data.ndim - 1))
        d = convd(self._ddata, h, axis=TDIM, shape="full")
        return self.replace(data=d, t0=self.t0 + lag0)

    def zeropad(self, pre: int = 0, post: int = 0) -> "ChannelData":
        """Pad the time axis; ``t0`` moves back by ``pre`` samples
        (``ChannelData.zeropad``, ``ChannelData.m:1153``)."""
        pad = [(int(pre), int(post))] + [(0, 0)] * (self.data.ndim - 1)
        return self.replace(data=jnp.pad(self._ddata, pad),
                            t0=self.t0 - pre / self.fs)

    def estfc(self) -> float:
        """Estimate the center frequency from the spectral peak
        (``ChannelData.estfc``, ``ChannelData.m:1185``)."""
        X = jnp.abs(self.fft())
        mag = X.reshape(self.T, -1).sum(axis=1)
        f = np.abs(self.fftaxis())
        i = int(jnp.argmax(mag))
        return float(f[i])

    def rectifyt0(self, method: str = "cubic") -> "ChannelData":
        """Resample all transmits onto one shared time axis so ``t0``
        becomes scalar (``ChannelData.rectifyt0``, ``ChannelData.m:1205``)."""
        t0 = self.t0_host
        if t0.size == 1:
            return self.replace(t0=float(t0[0]))
        t0min = float(t0.min())
        nshift = (t0 - t0min) * self.fs  # >= 0, per-transmit
        Tn = self.T + int(np.ceil(nshift.max()))
        i = np.arange(Tn).reshape((-1,) + (1,) * (self.data.ndim - 1))
        ntau = jnp.asarray(i - nshift.reshape((1, 1, -1)), jnp.float32)
        d = interp1(self._ddata, ntau, method=method)
        return self.replace(data=d, t0=t0min)

    def align_int(self, method: str = "cubic") -> "ChannelData":
        """Resample to an integer-aligned time axis
        (``ChannelData.alignInt``, ``ChannelData.m:1449``)."""
        c = self.rectifyt0(method=method)
        t0 = float(c.t0_host[0])
        n0 = math.ceil(t0 * c.fs)
        frac = n0 / c.fs - t0
        i = np.arange(c.T).reshape((-1,) + (1,) * (c.data.ndim - 1))
        d = interp1(c._ddata, jnp.asarray(i + frac * c.fs, jnp.float32), method=method)
        return c.replace(data=d, t0=n0 / c.fs)

    # ------------------------------------------------------------ structure
    def join(self, others: Sequence["ChannelData"], axis: int = 3) -> "ChannelData":
        """Concatenate frames along a trailing dim (``ChannelData.join``,
        ``ChannelData.m:1675``)."""
        chds = [self, *others]
        nd = max(c.data.ndim for c in chds)
        nd = max(nd, axis + 1)
        datas = [c._ddata.reshape(c.data.shape + (1,) * (nd - c.data.ndim)) for c in chds]
        return self.replace(data=jnp.concatenate(datas, axis=axis))

    def splice(self, axis: int = MDIM):
        """Split into single-entry ChannelData along ``axis``
        (``ChannelData.splice``, ``ChannelData.m:1706``)."""
        n = self.data.shape[axis]
        out = []
        t0 = self.t0
        for i in range(n):
            d = jax.lax.index_in_dim(self.data, i, axis, keepdims=True)
            t0i = t0
            if np.ndim(t0) > axis and np.shape(t0)[axis] == n:
                sl = [slice(None)] * np.ndim(t0)
                sl[axis] = slice(i, i + 1)
                t0i = t0[tuple(sl)]
            out.append(self.replace(data=d, t0=t0i))
        return out

    def subt(self, start: int, stop: int) -> "ChannelData":
        """Slice the time axis, adjusting t0 (``ChannelData.subD``)."""
        return self.replace(data=self.data[start:stop],
                            t0=self.t0 + start / self.fs)

    # ------------------------------------------------------------ arithmetic
    def _binop(self, other, op):
        if isinstance(other, ChannelData):
            other = other.data
        return self.replace(data=op(self._ddata, other))

    def __add__(self, o): return self._binop(o, jnp.add)
    def __sub__(self, o): return self._binop(o, jnp.subtract)
    def __mul__(self, o): return self._binop(o, jnp.multiply)
    def __truediv__(self, o): return self._binop(o, jnp.divide)
    def __neg__(self): return self.replace(data=-self.data)

    def txmul(self, H) -> "ChannelData":
        """Matrix-multiply over the transmit dim: ``y[t,n,v,...] =
        sum_m H[v,m] x[t,n,m,...]`` — the decoding primitive behind
        ``refocus`` (``ChannelData.mtimes``, ``ChannelData.m:524-746``)."""
        d = jnp.einsum("vm,tnm...->tnv...", jnp.asarray(H), self._ddata)
        return self.replace(data=d)

    def real(self): return self.replace(data=jnp.real(self._ddata))
    def imag(self): return self.replace(data=jnp.imag(self._ddata))
    def abs(self): return self.replace(data=jnp.abs(self._ddata))
    def conj(self): return self.replace(data=jnp.conj(self._ddata))

    @property
    def is_complex(self) -> bool:
        return jnp.iscomplexobj(self.data)


def _fir_design(order: int, fs: float, lo: Optional[float], hi: Optional[float]) -> jnp.ndarray:
    """Hamming-window FIR design (lowpass or bandpass), odd length."""
    L = int(order) | 1  # odd
    n = np.arange(L) - (L - 1) / 2
    sinc = lambda fc: 2 * fc / fs * np.sinc(2 * fc / fs * n)
    if lo is None:
        h = sinc(hi)
    else:
        h = sinc(hi) - sinc(lo)
    h = h * np.hamming(L)
    # normalize passband gain to ~1
    if lo is None:
        h = h / h.sum()
    else:
        f0 = (lo + hi) / 2
        g = np.abs(np.sum(h * np.exp(-2j * np.pi * f0 / fs * np.arange(L))))
        h = h / max(g, np.finfo(float).tiny)
    return jnp.asarray(h)


jax.tree_util.register_dataclass(
    ChannelData, data_fields=["data", "t0"], meta_fields=["fs"]
)
