"""Transducer models.

Counterpart of QUPS's ``Transducer`` class hierarchy
(``/root/reference/src/Transducer.m:12``, ``TransducerArray.m``,
``TransducerConvex.m``, ``TransducerMatrix.m``, ``TransducerGeneric.m``).

The extension contract mirrors the reference (``src/README.md:23-40``):
subclasses provide ``positions() -> (3, N)`` and
``orientations() -> (az, el, normal, widthv, heightv)``. Everything else
(patches, barycenters, bounds) derives from those.

These are host-side configuration objects — geometry arrays are computed
eagerly with numpy and fed into jitted kernels as arrays, so changing a float
parameter never recompiles a kernel.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .waveform import Waveform


def _rot_mat(az_deg: float, el_deg: float) -> np.ndarray:
    """Combined elevation-about-x @ azimuth-about-y rotation
    (``Transducer.transPos``, ``/root/reference/src/Transducer.m:286-330``)."""
    az = math.radians(az_deg)
    el = math.radians(el_deg)
    Raz = np.array([[math.cos(az), 0, math.sin(az)],
                    [0, 1, 0],
                    [-math.sin(az), 0, math.cos(az)]])
    Rel = np.array([[1, 0, 0],
                    [0, math.cos(el), math.sin(el)],
                    [0, -math.sin(el), math.cos(el)]])
    return Rel @ Raz


def _dir_vectors(theta_deg, phi_deg):
    """Normal / width / height unit vectors from azimuth+elevation (deg)."""
    th = np.radians(np.asarray(theta_deg, dtype=np.float64))
    ph = np.radians(np.asarray(phi_deg, dtype=np.float64))
    zero = np.zeros_like(th)
    normal = np.stack([np.cos(ph) * np.sin(th), np.sin(ph), np.cos(ph) * np.cos(th)])
    widthv = np.stack([np.cos(th), np.sin(zero), -np.cos(zero) * np.sin(th)])
    heightv = np.stack([np.sin(ph) * np.sin(zero), np.cos(ph), np.sin(ph) * np.cos(zero)])
    return normal, widthv, heightv


@dataclass(frozen=True)
class Transducer:
    """Base transducer: common element properties
    (``/root/reference/src/Transducer.m:13-26``)."""

    fc: float = 5e6                    # center frequency [Hz]
    bw: Optional[Tuple[float, float]] = None  # bandwidth [Hz]
    width: float = 1.5e-4              # element width [m]
    height: Optional[float] = None     # element height [m]
    numel: int = 128                   # number of elements
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rot: Tuple[float, float] = (0.0, 0.0)  # (azimuth, elevation) [deg]
    el_focus: float = math.inf         # elevation focal depth [m]
    impulse: Optional[Waveform] = None

    def __post_init__(self):
        if self.height is None:
            object.__setattr__(self, "height", 20 * self.width)
        if self.bw is None:
            object.__setattr__(self, "bw", (0.7 * self.fc, 1.3 * self.fc))
        object.__setattr__(self, "bw", tuple(float(b) for b in self.bw))
        object.__setattr__(self, "offset", tuple(float(o) for o in self.offset))
        object.__setattr__(self, "rot", tuple(float(r) for r in self.rot))
        if self.impulse is None:
            object.__setattr__(self, "impulse", Waveform.Gauspuls(self.fc, self.bw_frac))

    # ------------------------------------------------------------ properties
    @property
    def bw_frac(self) -> float:
        return (self.bw[1] - self.bw[0]) / self.fc

    @property
    def area(self) -> float:
        return self.width * self.height

    @property
    def origin(self) -> np.ndarray:
        return np.asarray(self.offset, dtype=np.float64)

    def replace(self, **changes) -> "Transducer":
        return dataclasses.replace(self, **changes)

    # -------------------------------------------------------------- geometry
    def trans_pos(self, p: np.ndarray) -> np.ndarray:
        """Apply the transducer's rotation + offset to positions ``p (3, ...)``."""
        R = _rot_mat(self.rot[0], self.rot[1])
        return np.tensordot(R, np.asarray(p, dtype=np.float64), axes=(1, 0)) \
            + self.origin.reshape((3,) + (1,) * (np.ndim(p) - 1))

    def positions(self) -> np.ndarray:  # (3, N)
        raise NotImplementedError

    def orientations(self):
        """Returns (azimuth, elevation, normal, widthv, heightv)."""
        raise NotImplementedError

    def patches(self, sub_div: Tuple[int, int] = (1, 1)) -> np.ndarray:
        """Corners of each sub-element: (3, N, E, 4) with E = prod(sub_div).

        Elements are modeled as flat rectangles spanned by the width/height
        unit vectors (``Transducer.patches``, ``Transducer.m:175-285``).
        """
        e1, e2 = int(sub_div[0]), int(sub_div[1])
        pc = self.positions()  # (3, N)
        _, _, _, wv, hv = self.orientations()
        # sub-element center offsets in the element frame, cell corners at ±1/2
        du = (np.arange(e1) + 0.5) / e1 - 0.5  # (E1,)
        dv = (np.arange(e2) + 0.5) / e2 - 0.5  # (E2,)
        cu = np.array([-0.5, 0.5, -0.5, 0.5]) / e1  # corner offsets per cell
        cv = np.array([-0.5, -0.5, 0.5, 0.5]) / e2
        # (E1, E2, 4) grids of offsets
        u = du[:, None, None] + cu[None, None, :]
        v = dv[None, :, None] + cv[None, None, :]
        u, v = np.broadcast_arrays(u, v)
        u = u.reshape(-1, 4)  # (E, 4)
        v = v.reshape(-1, 4)
        p = (pc[:, :, None, None]
             + wv[:, :, None, None] * (self.width * u)[None, None]
             + hv[:, :, None, None] * (self.height * v)[None, None])
        return p  # (3, N, E, 4)

    def bary_centers(self, sub_div: Tuple[int, int] = (1, 1)) -> np.ndarray:
        """Sub-element barycenters (3, N, E) (``Transducer.getBaryCenters``,
        ``Transducer.m:253-284``)."""
        return self.patches(sub_div).mean(axis=-1)

    def bounds(self) -> np.ndarray:
        """(3, 2) min/max cartesian bounds over all element corners
        (``Transducer.bounds``, ``Transducer.m:231-251``)."""
        p = self.patches((1, 1)).reshape(3, -1)
        return np.stack([p.min(axis=1), p.max(axis=1)], axis=1)

    def foc_active(self, apd: np.ndarray, r: float):
        """Foci of active apertures: for each transmit s, the focal point at
        range ``r`` along the mean normal of the active (apd != 0) elements
        (``Transducer.focActive``, ``Transducer.m:322``)."""
        apd = np.asarray(apd)
        p = self.positions()  # (3, N)
        _, _, n, _, _ = self.orientations()  # (3, N)
        w = apd / np.maximum(apd.sum(axis=0, keepdims=True), np.finfo(float).tiny)
        pc = p @ w  # (3, S) aperture centers
        nc = n @ w
        nc = nc / np.linalg.norm(nc, axis=0, keepdims=True)
        pf = pc + r * nc
        return pf, nc

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "Transducer":
        """Unit rescale, e.g. m->mm and s->us (``Transducer.scale``)."""
        changes = dict(
            fc=self.fc / time,
            bw=tuple(b / time for b in self.bw),
            width=self.width * dist,
            height=self.height * dist,
            offset=tuple(o * dist for o in self.offset),
            el_focus=self.el_focus * dist,
            impulse=self.impulse.scale(time=time) if self.impulse else None,
        )
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class TransducerArray(Transducer):
    """Linear array on a line (``/root/reference/src/TransducerArray.m:8``)."""

    pitch: Optional[float] = None

    def __post_init__(self):
        if self.pitch is None:
            object.__setattr__(self, "pitch", self.width)  # kerf = 0
        Transducer.__post_init__(self)

    @property
    def kerf(self) -> float:
        return self.pitch - self.width

    @property
    def aperture_size(self) -> float:
        return self.numel * self.pitch

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "TransducerArray":
        base = Transducer.scale(self, dist=dist, time=time)
        return dataclasses.replace(base, pitch=self.pitch * dist)

    def positions(self) -> np.ndarray:
        half = (self.numel - 1) * self.pitch / 2
        x = np.linspace(-half, half, self.numel)
        return self.trans_pos(np.stack([x, 0 * x, 0 * x]))

    def orientations(self):
        theta = self.rot[0] + np.zeros(self.numel)
        phi = -self.rot[1] + np.zeros(self.numel)
        return (theta, phi, *_dir_vectors(theta, phi))

    # named presets (``TransducerArray.m:327-388``)
    @staticmethod
    def L12_3v():
        return TransducerArray(fc=7.5e6, bw=(4e6, 11e6), width=0.18e-3, height=2e-3,
                               numel=192, pitch=0.2e-3, el_focus=20e-3)

    @staticmethod
    def L11_5v():
        return TransducerArray(fc=7.25e6, bw=(4.5e6, 10e6), width=0.27e-3, height=3e-3,
                               numel=128, pitch=0.3e-3, el_focus=18e-3)

    @staticmethod
    def L11_2v():
        return TransducerArray(fc=5.1333e6, bw=(5.1333e6 - 1.5e6, 5.1333e6 + 1.5e6),
                               width=0.27e-3, height=5e-3, numel=128, pitch=0.3e-3,
                               el_focus=20e-3)

    @staticmethod
    def L12_5v():
        return TransducerArray(fc=7.5e6, bw=(5e6, 11e6), width=1.7e-4, height=7.5e-3,
                               numel=256, pitch=1.953125e-4, el_focus=20e-3)

    @staticmethod
    def P4_2v():
        return TransducerArray(fc=3e6, bw=(1.5e6, 4.5e6), width=0.27e-3, height=3e-3,
                               numel=64, pitch=0.3e-3, el_focus=60e-3)


@dataclass(frozen=True)
class TransducerConvex(Transducer):
    """Curvilinear array on a circular arc
    (``/root/reference/src/TransducerConvex.m:8``). Defaults follow the
    Verasonics C5-2v."""

    radius: float = 50e-3
    angular_pitch: float = 0.5872  # [deg]

    @property
    def pitch(self) -> float:
        return 2 * self.radius * math.sin(math.radians(self.angular_pitch) / 2)

    @property
    def angular_aperture_size(self) -> float:
        return (self.numel - 1) * self.angular_pitch

    @property
    def center(self) -> np.ndarray:
        """Center of the defining circle (``TransducerConvex.m:342``)."""
        return np.array([0.0, 0.0, -self.radius]) + self.origin

    @staticmethod
    def from_pitch(pitch: float, radius: float, **kw) -> "TransducerConvex":
        ap = 2 * math.degrees(math.asin(pitch / 2 / radius))
        return TransducerConvex(radius=radius, angular_pitch=ap, **kw)

    def positions(self) -> np.ndarray:
        half = (self.numel - 1) * self.angular_pitch / 2
        th = np.radians(np.linspace(-half, half, self.numel))
        p = np.stack([self.radius * np.sin(th), 0 * th, self.radius * np.cos(th)])
        return self.trans_pos(p) - np.array([[0.0], [0.0], [self.radius]])

    def orientations(self):
        half = (self.numel - 1) * self.angular_pitch / 2
        theta = self.rot[0] + np.linspace(-half, half, self.numel)
        phi = -self.rot[1] + np.zeros_like(theta)
        return (theta, phi, *_dir_vectors(theta, phi))

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "TransducerConvex":
        base = Transducer.scale(self, dist=dist, time=time)
        return dataclasses.replace(base, radius=self.radius * dist)

    @staticmethod
    def C5_2v():
        return TransducerConvex(fc=3.7e6, bw=(2.4e6, 5e6), width=0.46e-3,
                                height=13.5e-3, numel=128, radius=49.57e-3,
                                angular_pitch=0.5871, el_focus=60e-3)


@dataclass(frozen=True)
class TransducerMatrix(Transducer):
    """2-D matrix array on a plane
    (``/root/reference/src/TransducerMatrix.m:8``)."""

    pitch2: Tuple[float, float] = (0.3e-3, 0.3e-3)  # (lateral, elevation) pitch
    numd: Tuple[int, int] = (16, 8)                 # (lateral, elevation) counts

    def __post_init__(self):
        object.__setattr__(self, "pitch2", tuple(float(p) for p in np.broadcast_to(self.pitch2, (2,))))
        object.__setattr__(self, "numd", tuple(int(n) for n in self.numd))
        object.__setattr__(self, "numel", self.numd[0] * self.numd[1])
        Transducer.__post_init__(self)

    def positions(self) -> np.ndarray:
        w = (self.numd[0] - 1) * self.pitch2[0]
        h = (self.numd[1] - 1) * self.pitch2[1]
        x = np.linspace(-w / 2, w / 2, self.numd[0])
        y = np.linspace(-h / 2, h / 2, self.numd[1])
        X, Y = np.meshgrid(x, y, indexing="ij")
        p = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)])
        return self.trans_pos(p)

    def orientations(self):
        theta = self.rot[0] + np.zeros(self.numel)
        phi = -self.rot[1] + np.zeros(self.numel)
        return (theta, phi, *_dir_vectors(theta, phi))

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "TransducerMatrix":
        base = Transducer.scale(self, dist=dist, time=time)
        return dataclasses.replace(base, pitch2=tuple(p * dist for p in self.pitch2))

    @staticmethod
    def PO192O():
        return TransducerMatrix(fc=3.5e6, numd=(32, 32), width=0.3e-3,
                                height=0.3e-3, pitch2=(0.3e-3, 0.3e-3), el_focus=20e-3)

    @staticmethod
    def PO1921():
        return TransducerMatrix(fc=7.5e6, numd=(32, 32), width=0.3e-3,
                                height=0.3e-3, pitch2=(0.3e-3, 0.3e-3), el_focus=20e-3)


@dataclass(frozen=True)
class TransducerGeneric(Transducer):
    """Arbitrary per-element positions/orientations
    (``/root/reference/src/TransducerGeneric.m:8``)."""

    pos: Tuple = ((0.0,), (0.0,), (0.0,))  # (3, N) nested tuple or array
    az: Tuple = (0.0,)
    el: Tuple = (0.0,)

    def __post_init__(self):
        pos = np.asarray(self.pos, dtype=np.float64).reshape(3, -1)
        n = pos.shape[1]
        az = np.broadcast_to(np.asarray(self.az, dtype=np.float64).ravel(), (n,))
        el = np.broadcast_to(np.asarray(self.el, dtype=np.float64).ravel(), (n,))
        object.__setattr__(self, "pos", tuple(map(tuple, pos)))
        object.__setattr__(self, "az", tuple(az))
        object.__setattr__(self, "el", tuple(el))
        object.__setattr__(self, "numel", n)
        Transducer.__post_init__(self)

    def positions(self) -> np.ndarray:
        return self.trans_pos(np.asarray(self.pos, dtype=np.float64))

    def orientations(self):
        theta = np.asarray(self.az) + self.rot[0]
        phi = np.asarray(self.el) + self.rot[1]
        th = np.radians(theta)
        ph = np.radians(phi)
        normal = np.stack([np.cos(ph) * np.sin(th), np.sin(ph), np.cos(ph) * np.cos(th)])
        widthv = np.stack([np.cos(ph) * np.cos(th), np.sin(ph), -np.cos(ph) * np.sin(th)])
        heightv = np.stack([np.sin(ph) * np.sin(th), np.cos(ph), np.sin(ph) * np.cos(th)])
        return theta, phi, normal, widthv, heightv

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "TransducerGeneric":
        base = Transducer.scale(self, dist=dist, time=time)
        pos = tuple(tuple(v * dist for v in row) for row in self.pos)
        return dataclasses.replace(base, pos=pos)
