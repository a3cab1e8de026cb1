"""Transmit sequences.

Counterpart of QUPS's ``Sequence`` classes
(``/root/reference/src/Sequence.m:28-1242``, ``SequenceRadial.m``,
``SequenceGeneric.m``).

Sequence types and their t=0 conventions (``Sequence.m:888-909``):

* ``FSA`` — full synthetic aperture: one element per pulse, t=0 when the wave
  leaves the element. Delays are all zero; apodization is the identity.
* ``PW``  — plane waves: ``focus`` holds unit direction vectors; t=0 when the
  wavefront passes through the origin. Delays ``-<nv, p>/c0``.
* ``FC``  — focused: t=0 when the wavefront passes through the focus.
  Delays ``+|pf - p|/c0``.
* ``DV``  — diverging: t=0 when the wave leaves the focus. Delays
  ``-|pf - p|/c0``.
* ``VS``  — legacy virtual source: sign chosen by geometry.

User-supplied ``del_``/``apd`` matrices or callables override the analytic
forms (``Sequence.m:126-188``), enabling Hadamard/random encodings.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np

from .waveform import Waveform

ArrayOrFn = Union[np.ndarray, Callable, None]


@dataclass(frozen=True)
class Sequence:
    type: str = "FSA"  # one of FSA | PW | FC | DV | VS
    focus: Tuple = ((0.0,), (0.0,), (0.0,))  # (3, S) foci or unit directions
    c0: float = 1540.0
    pulse: Optional[Waveform] = None
    numpulse: Optional[int] = None  # required for FSA
    apd: ArrayOrFn = None
    del_: ArrayOrFn = None

    def __post_init__(self):
        assert self.type in ("FSA", "PW", "FC", "DV", "VS"), self.type
        f = np.asarray(self.focus, dtype=np.float64).reshape(3, -1)
        object.__setattr__(self, "focus", tuple(map(tuple, f)))
        if self.pulse is None:
            object.__setattr__(self, "pulse", Waveform.Delta())

    # ------------------------------------------------------------ properties
    @property
    def focus_array(self) -> np.ndarray:
        return np.asarray(self.focus, dtype=np.float64)

    @property
    def num_pulse(self) -> int:
        if self.apd is not None and not callable(self.apd):
            return np.asarray(self.apd).shape[1]
        if self.del_ is not None and not callable(self.del_):
            return np.asarray(self.del_).shape[1]
        if self.type == "FSA":
            assert self.numpulse is not None, "set numpulse for FSA sequences"
            return int(self.numpulse)
        return self.focus_array.shape[1]

    def replace(self, **changes) -> "Sequence":
        return dataclasses.replace(self, **changes)

    # -------------------------------------------------------------- temporal
    def delays(self, tx) -> np.ndarray:
        """Transmit delays (N, S) for transducer ``tx``
        (``Sequence.m:888-951``)."""
        p = tx.positions()  # (3, N)
        if self.del_ is not None:
            d = self.del_(tx, self) if callable(self.del_) else np.asarray(self.del_)
            return np.broadcast_to(d, (tx.numel, self.num_pulse)).astype(np.float64)
        f = self.focus_array  # (3, S)
        if self.type in ("FC", "DV", "VS"):
            v = f[:, None, :] - p[:, :, None]  # (3, N, S)
            tau = np.linalg.norm(v, axis=0) / self.c0  # (N, S)
            if self.type == "FC":
                s = 1.0
            elif self.type == "DV":
                s = -1.0
            else:  # VS: + if focus in front of every element, - otherwise
                infront = np.all(f[2][None, :] > p[2][:, None], axis=0)  # (S,)
                s = np.where(infront, 1.0, -1.0)[None, :]
            return tau * s
        elif self.type == "PW":
            return -(f[:, None, :] * p[:, :, None]).sum(axis=0) / self.c0  # (N, S)
        elif self.type == "FSA":
            return np.zeros((p.shape[1], p.shape[1]))
        raise ValueError(self.type)

    def apodization(self, tx) -> np.ndarray:
        """Transmit apodization (N, S) (``Sequence.m:953-1006``)."""
        if self.apd is not None:
            a = self.apd(tx, self) if callable(self.apd) else np.asarray(self.apd)
            return np.broadcast_to(a, (tx.numel, self.num_pulse)).astype(np.float64)
        if self.type == "FSA":
            return np.eye(tx.numel)
        return np.ones((tx.numel, self.num_pulse))

    def t0_offset(self) -> np.ndarray:
        """Start-time offset moving t=0 from the sequence reference to the
        coordinate origin (``Sequence.m:1008-1051``); shape (S,)."""
        f = self.focus_array
        if self.type in ("VS", "FC"):
            return -np.linalg.norm(f, axis=0) / self.c0
        if self.type == "DV":
            return +np.linalg.norm(f, axis=0) / self.c0
        return np.zeros(1)

    def splice(self):
        """Split into one Sequence per transmit (``Sequence.m:368``)."""
        S = self.num_pulse
        out = []
        for s in range(S):
            kw = {}
            if self.type != "FSA":
                kw["focus"] = self.focus_array[:, s : s + 1]
            if self.apd is not None and not callable(self.apd):
                kw["apd"] = np.asarray(self.apd)[:, s : s + 1]
            if self.del_ is not None and not callable(self.del_):
                kw["del_"] = np.asarray(self.del_)[:, s : s + 1]
            if self.type == "FSA":
                kw["numpulse"] = 1
            out.append(dataclasses.replace(self, **kw))
        return out

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "Sequence":
        f = self.focus_array
        if self.type != "PW":  # PW foci are unit vectors — unscaled
            f = f * dist
        return dataclasses.replace(
            self,
            focus=tuple(map(tuple, f)),
            c0=self.c0 * dist / time,
            pulse=self.pulse.scale(time=time) if self.pulse else None,
            del_=None if self.del_ is None or callable(self.del_)
            else np.asarray(self.del_) * time,
        )

    # ------------------------------------------------------------ generators
    @staticmethod
    def ap_walking(N: int, sz: int, stride: int = 1, off: int = 0) -> np.ndarray:
        """Walking active-aperture apodization (N, S)
        (``Sequence.apWalking``, ``Sequence.m:838-883``): contiguous blocks of
        ``sz`` active elements sliding by ``stride``."""
        starts = np.arange(off, max(off, N - sz) + 1, stride)
        base = (np.arange(N) < sz).astype(np.float64)
        return np.stack([np.roll(base, s) for s in starts], axis=1)


@dataclass(frozen=True)
class SequenceRadial(Sequence):
    """Sequence parameterized by an apex plus polar ranges/angles
    (``/root/reference/src/SequenceRadial.m:1-183``). Plane waves use unit
    ranges so foci become unit direction vectors."""

    apex: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ranges: Optional[Tuple] = None
    angles: Optional[Tuple] = None  # [deg] w.r.t. +z in the x-z plane

    def __post_init__(self):
        apex = np.asarray(self.apex, dtype=np.float64).ravel()
        object.__setattr__(self, "apex", tuple(apex))
        r = np.atleast_1d(np.asarray(1.0 if self.ranges is None else self.ranges, dtype=np.float64))
        a = np.atleast_1d(np.asarray(0.0 if self.angles is None else self.angles, dtype=np.float64))
        r, a = np.broadcast_arrays(r, a)
        object.__setattr__(self, "ranges", tuple(r))
        object.__setattr__(self, "angles", tuple(a))
        th = np.radians(a)
        vec = np.stack([np.sin(th), np.zeros_like(th), np.cos(th)])  # (3, S)
        focus = vec * r[None, :]
        if self.type != "PW":
            focus = focus + apex[:, None]
        object.__setattr__(self, "focus", tuple(map(tuple, focus)))
        Sequence.__post_init__(self)

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "SequenceRadial":
        base = Sequence.scale(self, dist=dist, time=time)
        r = self.ranges if self.type == "PW" else tuple(v * dist for v in self.ranges)
        return dataclasses.replace(
            base, apex=tuple(v * dist for v in self.apex), ranges=r, angles=self.angles
        )


@dataclass(frozen=True)
class SequenceGeneric(Sequence):
    """Fully custom delays/apodization
    (``/root/reference/src/SequenceGeneric.m:1-64``)."""

    def __post_init__(self):
        # any type tag is allowed; delays/apod must come from del_/apd
        Sequence.__post_init__(self)

    @property
    def num_pulse(self) -> int:
        if self.numpulse is not None:
            return int(self.numpulse)
        return Sequence.num_pulse.fget(self)
