"""Imaging grids.

Counterpart of QUPS's ``Scan`` classes
(``/root/reference/src/Scan.m:16-593``, ``ScanCartesian.m``, ``ScanPolar.m``,
``ScanSpherical.m``, ``ScanGeneric.m``).

Every scan exposes ``positions() -> (3, I1, I2, I3)`` cartesian pixel
positions; beamformers consume only those, so the grid type is orthogonal to
beamforming (SURVEY.md §7 "hard parts"). ``order`` is a 3-letter string naming
which axis runs along each data dimension (e.g. ``'ZXY'``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import jax.numpy as jnp
import numpy as np


def _asaxis(v) -> np.ndarray:
    return np.atleast_1d(np.asarray(v, dtype=np.float64))


def _axis_bounds(v: np.ndarray) -> Tuple[float, float]:
    return float(v.min()), float(v.max())


def _axis_step(v: np.ndarray) -> float:
    return float(v[1] - v[0]) if v.size > 1 else float("nan")


def _linspace_step(lo, hi, step) -> np.ndarray:
    n = max(1, int(round((hi - lo) / step)) + 1)
    return lo + step * np.arange(n)


class Scan:
    """Base imaging grid."""

    order: str

    @property
    def axes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(len(ax) for ax in self.axes)

    @property
    def npix(self) -> int:
        return int(np.prod(self.shape))

    def positions(self) -> np.ndarray:  # (3, I1, I2, I3) cartesian
        raise NotImplementedError

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def _grid(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """ndgrid of the three axes in data order."""
        return np.meshgrid(*self.axes, indexing="ij")


@dataclass(frozen=True)
class ScanCartesian(Scan):
    """Cartesian grid (``/root/reference/src/ScanCartesian.m:6-195``);
    defaults: x ∈ [-20, 20] mm (161 px), z ∈ [0, 40] mm (161 px), y = {0},
    order ``'ZXY'``."""

    x: np.ndarray = field(default_factory=lambda: 1e-3 * np.linspace(-20, 20, 161))
    y: np.ndarray = field(default_factory=lambda: np.zeros(1))
    z: np.ndarray = field(default_factory=lambda: 1e-3 * np.linspace(0, 40, 161))
    order: str = "ZXY"

    def __post_init__(self):
        for name in "xyz":
            object.__setattr__(self, name, _asaxis(getattr(self, name)))
        assert sorted(self.order) == ["X", "Y", "Z"], self.order

    @property
    def axes(self):
        return tuple(getattr(self, c.lower()) for c in self.order)

    @property
    def xb(self): return _axis_bounds(self.x)
    @property
    def yb(self): return _axis_bounds(self.y)
    @property
    def zb(self): return _axis_bounds(self.z)
    @property
    def dx(self): return _axis_step(self.x)
    @property
    def dy(self): return _axis_step(self.y)
    @property
    def dz(self): return _axis_step(self.z)
    @property
    def nx(self): return len(self.x)
    @property
    def ny(self): return len(self.y)
    @property
    def nz(self): return len(self.z)

    def with_resolution(self, dx=None, dy=None, dz=None) -> "ScanCartesian":
        """Re-grid axes at the given step sizes, keeping the bounds."""
        kw = {}
        for name, d in (("x", dx), ("y", dy), ("z", dz)):
            if d is not None:
                lo, hi = _axis_bounds(getattr(self, name))
                kw[name] = _linspace_step(lo, hi, d)
        return dataclasses.replace(self, **kw)

    def positions(self) -> np.ndarray:
        G = dict(zip(self.order, self._grid()))
        return np.stack([G["X"], G["Y"], G["Z"]])

    def scale(self, dist: float = 1.0) -> "ScanCartesian":
        return dataclasses.replace(self, x=self.x * dist, y=self.y * dist, z=self.z * dist)


@dataclass(frozen=True)
class ScanPolar(Scan):
    """Polar grid (``/root/reference/src/ScanPolar.m:6-287``): range ``r``,
    angle ``a`` [deg] from +z toward +x, elevation ``y``, centered at
    ``origin``."""

    r: np.ndarray = field(default_factory=lambda: 1e-3 * np.linspace(0, 40, 161))
    a: np.ndarray = field(default_factory=lambda: np.linspace(-45.0, 45.0, 181))
    y: np.ndarray = field(default_factory=lambda: np.zeros(1))
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    order: str = "RAY"

    def __post_init__(self):
        for name in ("r", "a", "y"):
            object.__setattr__(self, name, _asaxis(getattr(self, name)))
        object.__setattr__(self, "origin", tuple(np.asarray(self.origin, dtype=np.float64).ravel()))
        assert sorted(self.order) == ["A", "R", "Y"], self.order

    @property
    def axes(self):
        return tuple(getattr(self, c.lower()) for c in self.order)

    @property
    def rb(self): return _axis_bounds(self.r)
    @property
    def ab(self): return _axis_bounds(self.a)
    @property
    def dr(self): return _axis_step(self.r)
    @property
    def da(self): return _axis_step(self.a)
    @property
    def nr(self): return len(self.r)
    @property
    def na(self): return len(self.a)
    @property
    def ny(self): return len(self.y)

    def with_resolution(self, dr=None, da=None) -> "ScanPolar":
        kw = {}
        for name, d in (("r", dr), ("a", da)):
            if d is not None:
                lo, hi = _axis_bounds(getattr(self, name))
                kw[name] = _linspace_step(lo, hi, d)
        return dataclasses.replace(self, **kw)

    def grid_polar(self):
        """(R, A, Y) ndgrids in data order (``ScanPolar.m:116``)."""
        G = dict(zip(self.order, self._grid()))
        return G["R"], G["A"], G["Y"]

    def positions(self) -> np.ndarray:
        R, A, Y = self.grid_polar()
        th = np.radians(A)
        og = np.asarray(self.origin)
        X = R * np.sin(th) + og[0]
        Z = R * np.cos(th) + og[2]
        return np.stack([X, Y + og[1], Z])

    def to_cartesian(self, dx: Optional[float] = None) -> "ScanCartesian":
        """Bounding cartesian scan (``ScanPolar.m:203``)."""
        p = self.positions().reshape(3, -1)
        dx = dx or min(d for d in (self.dr, np.radians(self.da) * self.rb[1]) if np.isfinite(d))
        x = _linspace_step(p[0].min(), p[0].max(), dx)
        z = _linspace_step(p[2].min(), p[2].max(), dx)
        return ScanCartesian(x=x, y=np.unique(p[1]), z=z)

    def scan_convert(self, b, scan_c: Optional[ScanCartesian] = None):
        """Resample a polar image (order 'RAY') onto a cartesian grid via
        bilinear interpolation (``ScanPolar.scanConvert``,
        ``ScanPolar.m:143-201``). OOB pixels are NaN."""
        assert self.order == "RAY", "data must be in order 'RAY'"
        if scan_c is None:
            scan_c = self.to_cartesian()
        og = np.asarray(self.origin)
        P = scan_c.positions()  # (3, I1, I2, I3)
        X = P[0] - og[0]
        Z = P[2] - og[2]
        R = np.hypot(X, Z)
        A = np.degrees(np.arctan2(X, Z))
        b = jnp.asarray(b)
        # fractional indices into the (r, a) axes
        ri = (R - self.r[0]) / max(self.dr, np.finfo(float).tiny)
        ai = (A - self.a[0]) / max(self.da, np.finfo(float).tiny)
        ri = jnp.asarray(ri)
        ai = jnp.asarray(ai)
        oob = (ri < 0) | (ri > self.nr - 1) | (ai < 0) | (ai > self.na - 1)
        r0 = jnp.clip(jnp.floor(ri).astype(jnp.int32), 0, self.nr - 1)
        a0 = jnp.clip(jnp.floor(ai).astype(jnp.int32), 0, self.na - 1)
        r1 = jnp.clip(r0 + 1, 0, self.nr - 1)
        a1 = jnp.clip(a0 + 1, 0, self.na - 1)
        wr = jnp.clip(ri - r0, 0, 1)
        wa = jnp.clip(ai - a0, 0, 1)
        # squeeze the elevation dim of the polar data: (R, A, Y, ...)
        by = b[:, :, 0] if b.ndim >= 3 and b.shape[2] == 1 else b
        idx = lambda rr, aa: by[rr, aa]
        out = ((1 - wr) * (1 - wa))[..., *([None] * (by.ndim - 2))] * idx(r0, a0) \
            + ((1 - wr) * wa)[..., *([None] * (by.ndim - 2))] * idx(r0, a1) \
            + (wr * (1 - wa))[..., *([None] * (by.ndim - 2))] * idx(r1, a0) \
            + (wr * wa)[..., *([None] * (by.ndim - 2))] * idx(r1, a1)
        out = jnp.where(oob[..., *([None] * (by.ndim - 2))], jnp.nan, out)
        return out, scan_c

    def scale(self, dist: float = 1.0) -> "ScanPolar":
        return dataclasses.replace(
            self, r=self.r * dist, y=self.y * dist,
            origin=tuple(v * dist for v in self.origin))


@dataclass(frozen=True)
class ScanSpherical(Scan):
    """Spherical grid (``/root/reference/src/ScanSpherical.m:6-275``): range
    ``r``, azimuth ``a`` [deg] (about +y, from +z toward +x), elevation ``e``
    [deg]."""

    r: np.ndarray = field(default_factory=lambda: 1e-3 * np.linspace(0, 40, 161))
    a: np.ndarray = field(default_factory=lambda: np.linspace(-45.0, 45.0, 91))
    e: np.ndarray = field(default_factory=lambda: np.linspace(-45.0, 45.0, 91))
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    order: str = "RAE"

    def __post_init__(self):
        for name in ("r", "a", "e"):
            object.__setattr__(self, name, _asaxis(getattr(self, name)))
        object.__setattr__(self, "origin", tuple(np.asarray(self.origin, dtype=np.float64).ravel()))
        assert sorted(self.order) == ["A", "E", "R"], self.order

    @property
    def axes(self):
        return tuple(getattr(self, c.lower()) for c in self.order)

    @property
    def nr(self): return len(self.r)
    @property
    def na(self): return len(self.a)
    @property
    def ne(self): return len(self.e)
    @property
    def dr(self): return _axis_step(self.r)

    def positions(self) -> np.ndarray:
        G = dict(zip(self.order, self._grid()))
        R, A, E = G["R"], G["A"], G["E"]
        th = np.radians(A)
        ph = np.radians(E)
        og = np.asarray(self.origin)
        X = R * np.cos(ph) * np.sin(th) + og[0]
        Y = R * np.sin(ph) + og[1]
        Z = R * np.cos(ph) * np.cos(th) + og[2]
        return np.stack([X, Y, Z])

    def to_cartesian(self, dx: Optional[float] = None) -> "ScanCartesian":
        p = self.positions().reshape(3, -1)
        dx = dx or min(d for d in (self.dr,) if np.isfinite(d))
        return ScanCartesian(
            x=_linspace_step(p[0].min(), p[0].max(), dx),
            y=_linspace_step(p[1].min(), p[1].max(), dx)
            if np.ptp(p[1]) > 0 else np.unique(p[1]),
            z=_linspace_step(p[2].min(), p[2].max(), dx))

    def scan_convert(self, b, scan_c: Optional[ScanCartesian] = None):
        """Resample a spherical image (order 'RAE') onto a cartesian volume
        via trilinear interpolation (3-D sector scan conversion, the
        ``ScanSpherical.scanConvert`` capability). OOB voxels are NaN."""
        assert self.order == "RAE", "data must be in order 'RAE'"
        if scan_c is None:
            scan_c = self.to_cartesian()
        og = np.asarray(self.origin)
        P = scan_c.positions()  # (3, I1, I2, I3)
        X = P[0] - og[0]
        Y = P[1] - og[1]
        Z = P[2] - og[2]
        R = np.sqrt(X**2 + Y**2 + Z**2)
        A = np.degrees(np.arctan2(X, Z))
        E = np.degrees(np.arcsin(np.clip(Y / np.maximum(R, 1e-30), -1, 1)))
        b = jnp.asarray(b)
        da = _axis_step(self.a)
        de = _axis_step(self.e)
        ri = jnp.asarray((R - self.r[0]) / max(self.dr, np.finfo(float).tiny))
        ai = jnp.asarray((A - self.a[0]) / max(da, np.finfo(float).tiny))
        ei = jnp.asarray((E - self.e[0]) / max(de, np.finfo(float).tiny))
        nr, na, ne = self.nr, self.na, self.ne
        oob = ((ri < 0) | (ri > nr - 1) | (ai < 0) | (ai > na - 1)
               | (ei < 0) | (ei > ne - 1))
        out = 0.0
        r0 = jnp.clip(jnp.floor(ri).astype(jnp.int32), 0, nr - 1)
        a0 = jnp.clip(jnp.floor(ai).astype(jnp.int32), 0, na - 1)
        e0 = jnp.clip(jnp.floor(ei).astype(jnp.int32), 0, ne - 1)
        wr = jnp.clip(ri - r0, 0, 1)
        wa = jnp.clip(ai - a0, 0, 1)
        we = jnp.clip(ei - e0, 0, 1)
        for cr in (0, 1):
            for ca in (0, 1):
                for ce in (0, 1):
                    w = ((wr if cr else 1 - wr) * (wa if ca else 1 - wa)
                         * (we if ce else 1 - we))
                    idx = (jnp.clip(r0 + cr, 0, nr - 1),
                           jnp.clip(a0 + ca, 0, na - 1),
                           jnp.clip(e0 + ce, 0, ne - 1))
                    out = out + w * b[idx]
        out = jnp.where(oob, jnp.nan, out)
        return out, scan_c

    def scale(self, dist: float = 1.0) -> "ScanSpherical":
        return dataclasses.replace(
            self, r=self.r * dist, origin=tuple(v * dist for v in self.origin))


@dataclass(frozen=True)
class ScanGeneric(Scan):
    """Arbitrary pixel positions (``/root/reference/src/ScanGeneric.m:10``):
    either an explicit ``pos (3, I1, I2, I3)`` array or a transform ``trans``
    of three abstract axes u/v/w."""

    u: np.ndarray = field(default_factory=lambda: np.linspace(0, 1, 11))
    v: np.ndarray = field(default_factory=lambda: np.linspace(0, 1, 11))
    w: np.ndarray = field(default_factory=lambda: np.zeros(1))
    pos: Optional[np.ndarray] = None  # (3, I1, I2, I3)
    trans: Optional[Callable] = None  # (U, V, W) -> (3, ...) cartesian
    order: str = "UVW"

    def __post_init__(self):
        for name in ("u", "v", "w"):
            object.__setattr__(self, name, _asaxis(getattr(self, name)))
        if self.pos is not None:
            p = np.asarray(self.pos, dtype=np.float64)
            assert p.ndim >= 2 and p.shape[0] == 3
            while p.ndim < 4:
                p = p[..., None]
            object.__setattr__(self, "pos", p)

    @property
    def axes(self):
        if self.pos is not None:
            # abstract index axes matching the stored positions
            return tuple(np.arange(s, dtype=np.float64) for s in self.pos.shape[1:])
        return (self.u, self.v, self.w)

    def positions(self) -> np.ndarray:
        if self.pos is not None:
            return self.pos
        U, V, W = self._grid()
        assert self.trans is not None, "provide pos or trans"
        return np.asarray(self.trans(U, V, W))

    def scale(self, dist: float = 1.0) -> "ScanGeneric":
        if self.pos is not None:
            return dataclasses.replace(self, pos=self.pos * dist)
        t = self.trans
        return dataclasses.replace(self, trans=lambda U, V, W: dist * np.asarray(t(U, V, W)))
