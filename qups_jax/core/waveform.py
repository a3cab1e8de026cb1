"""Time-limited waveforms.

Counterpart of QUPS's ``Waveform`` class
(``/root/reference/src/Waveform.m:13-574``): a continuous-time function
``fun`` supported on ``[t0, tend]`` with an optional sampling frequency
``fs``. The discrete time axis is always chosen to pass through t=0
(``Waveform.m:482-487``) so that convolutions and simulators agree on the
origin of time.

Waveform algebra (convolution, conjugation, reversal) happens at trace time on
the host — the results feed simulators as sampled kernels.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np


@dataclass(frozen=True)
class Waveform:
    """A time-limited signal ``fun(t)`` supported on ``[t0, tend]``."""

    fun: Callable = None
    t0: float = 0.0
    tend: float = 0.0
    fs: Optional[float] = None

    # ---------------------------------------------------------------- basics
    @property
    def duration(self) -> float:
        return self.tend - self.t0

    @property
    def dt(self) -> Optional[float]:
        return None if self.fs is None else 1.0 / self.fs

    @property
    def T(self) -> int:
        """Number of samples on the canonical time axis."""
        assert self.fs is not None, "set fs before sampling"
        return 1 + math.ceil(self.tend * self.fs) - math.floor(self.t0 * self.fs)

    @property
    def time(self) -> np.ndarray:
        """Canonical time axis — guaranteed to pass through t == 0."""
        assert self.fs is not None, "set fs before sampling"
        n0 = math.floor(self.t0 * self.fs)
        ne = math.ceil(self.tend * self.fs)
        return np.arange(n0, ne + 1) / self.fs

    @property
    def samples(self):
        return self.sample(np.asarray(self.time))

    def is_delta(self) -> bool:
        return self.t0 == self.tend

    def sample(self, t):
        """Sample the waveform; zero outside ``[t0, tend]``."""
        t = np.asarray(t)
        if self.is_delta():
            # Delta support is a single point; the canonical time axis always
            # includes t==0 so the delta contributes exactly one sample.
            v = self.fun(np.zeros_like(t)) if self.fun is not None else np.ones_like(t)
            return np.where(t == self.t0, v, np.zeros_like(v))
        # tolerate float rounding at the support boundary (samples that land
        # exactly on t0/tend via a different arithmetic path stay included)
        tol = 1e-9 * (abs(self.t0) + abs(self.tend)) + 1e-300
        inb = (self.t0 - tol <= t) & (t <= self.tend + tol)
        tt = np.where(inb, t, np.zeros_like(t))  # keep fun's domain safe
        v = self.fun(tt)
        return np.where(inb, v, np.zeros_like(v))

    # ------------------------------------------------------------- operators
    def conv(self, other: "Waveform", fs: Optional[float] = None) -> "Waveform":
        """Convolve two waveforms (``Waveform.m:384-434`` semantics).

        Delta functions act as (scaled) identities. Otherwise the convolution
        is computed as a discrete inner product over a shared grid at rate
        ``fs`` (default: the max of the operands' rates) — a plain sum, not
        scaled by dt, matching the reference normalization.
        """
        fs = fs or max([f for f in (self.fs, other.fs) if f is not None] or [None])
        if self.is_delta():
            a = self
            f = lambda t: a.sample(np.zeros(())) * other.fun_or_sample(t)
            return Waveform(fun=f, t0=other.t0 + self.t0, tend=other.tend + self.t0, fs=fs)
        if other.is_delta():
            b = other
            f = lambda t: b.sample(np.zeros(())) * self.fun_or_sample(t)
            return Waveform(fun=f, t0=self.t0 + other.t0, tend=self.tend + other.t0, fs=fs)
        assert fs is not None, "a sampling frequency is required to convolve"
        n0 = math.floor((self.t0 + other.t0) * fs)
        ne = math.ceil((self.tend + other.tend) * fs)
        k = np.arange(n0, ne + 1) / fs  # shared sample grid

        def f(t):
            t = np.asarray(t)
            kk = np.asarray(k)
            # (..., K) @ (K,) -> (...)
            av = self.sample(t[..., None] - kk)
            bv = other.sample(kk)
            return np.sum(av * bv, axis=-1)

        return Waveform(fun=f, t0=self.t0 + other.t0, tend=self.tend + other.tend, fs=fs)

    def fun_or_sample(self, t):
        return self.sample(t)

    def conj(self) -> "Waveform":
        f = self.fun
        return replace(self, fun=lambda t: np.conj(f(t)))

    def reverse(self) -> "Waveform":
        f = self.fun
        return replace(self, fun=lambda t: f(-t), t0=-self.tend, tend=-self.t0)

    def scale(self, time: float = 1.0) -> "Waveform":
        """Rescale the time units (s -> us etc.); see ``Waveform.m`` scale."""
        f = self.fun
        return Waveform(
            fun=None if f is None else (lambda t: f(t / time)),
            t0=self.t0 * time,
            tend=self.tend * time,
            fs=None if self.fs is None else self.fs / time,
        )

    # ----------------------------------------------------------- constructors
    @staticmethod
    def Delta() -> "Waveform":
        """Dirac delta (identity under convolution), ``Waveform.m:492``."""
        return Waveform(fun=lambda t: np.ones_like(t), t0=0.0, tend=0.0)

    @staticmethod
    def Gauspuls(fc: float, bw_frac: float = 0.6, bwr: float = -6.0,
                 tpr: float = -80.0) -> "Waveform":
        """Complex gaussian pulse — the default transducer impulse response
        (``Transducer.xdcImpulse`` / ``cgauspulsfun``,
        ``/root/reference/src/Transducer.m:901,1124``):

            f(t) = exp(-t^2 * isig) * exp(2j*pi*fc*t)

        with ``isig = pi^2 * bw^2 * fc^2 / (-2 * ln(10^(bwr/20)))`` and cutoff
        time where the envelope falls to ``tpr`` dB.

        Example:
            import numpy as np
            from qups_jax import Waveform
            wv = Waveform.Gauspuls(5e6, 0.6)
            wv = Waveform(fun=wv.fun, t0=wv.t0, tend=wv.tend, fs=40e6)
            s = np.asarray(wv.samples)
            assert abs(s[np.argmin(np.abs(wv.time))]) == np.abs(s).max()
        """
        isig = (4 * np.pi**2 * (-(bw_frac**2) * fc**2 / (8 * np.log(10 ** (bwr / 20))))) / 2
        tc = float(np.sqrt(-np.log(10 ** (tpr / 20)) / isig))

        def f(t):
            return np.exp(-t * t * isig) * np.exp(2j * np.pi * fc * t)

        return Waveform(fun=f, t0=-tc, tend=tc)

    @staticmethod
    def Tone(fc: float, cycles: float = 1.0) -> "Waveform":
        """A windowed tone burst of ``cycles`` periods at frequency ``fc``."""
        dur = cycles / fc

        def f(t):
            t = np.asarray(t)
            win = np.cos(np.pi * (t - dur / 2) / dur) ** 2  # Hann over [0, dur]
            win = np.where((t >= 0) & (t <= dur), win, 0.0)
            return np.sin(2 * np.pi * fc * t) * win

        return Waveform(fun=f, t0=0.0, tend=dur)

    @staticmethod
    def from_samples(samples, t0: float, fs: float) -> "Waveform":
        """Build a waveform from discrete samples via linear interpolation."""
        s = np.asarray(samples)
        n = s.shape[0]

        def f(t):
            ti = (np.asarray(t) - t0) * fs
            i0 = np.clip(np.floor(ti).astype(np.int32), 0, n - 1)
            i1 = np.clip(i0 + 1, 0, n - 1)
            w = ti - np.floor(ti)
            return s[i0] * (1 - w) + s[i1] * w

        return Waveform(fun=f, t0=t0, tend=t0 + (n - 1) / fs, fs=fs)
