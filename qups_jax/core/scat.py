"""Point-scatterer clouds.

Counterpart of QUPS's ``Scatterers``
(``/root/reference/src/Scatterers.m:12-549``): positions ``pos (3, S)``,
amplitudes ``amp (S,)``, ambient sound speed ``c0`` and attenuation
``alpha0``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Scatterers:
    pos: np.ndarray = field(default_factory=lambda: np.array([[0.0], [0.0], [30e-3]]))
    amp: Optional[np.ndarray] = None
    c0: float = 1540.0
    alpha0: float = 0.0          # attenuation [dB/cm/MHz]
    alpha_p0: float = 1.01       # attenuation power law

    def __post_init__(self):
        p = np.asarray(self.pos, dtype=np.float64).reshape(3, -1)
        object.__setattr__(self, "pos", p)
        a = np.ones(p.shape[1]) if self.amp is None else np.asarray(self.amp, dtype=np.float64).ravel()
        assert a.shape[0] == p.shape[1], (a.shape, p.shape)
        object.__setattr__(self, "amp", a)

    @property
    def num_scat(self) -> int:
        return self.pos.shape[1]

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.pos.min(axis=1), self.pos.max(axis=1)], axis=1)

    def __add__(self, other: "Scatterers") -> "Scatterers":
        """Merge two clouds (``Scatterers.plus``, ``Scatterers.m:328``)."""
        assert np.isclose(self.c0, other.c0), "sound speeds must match to merge"
        return dataclasses.replace(
            self,
            pos=np.concatenate([self.pos, other.pos], axis=1),
            amp=np.concatenate([self.amp, other.amp]),
        )

    def replace(self, **changes) -> "Scatterers":
        return dataclasses.replace(self, **changes)

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "Scatterers":
        return dataclasses.replace(self, pos=self.pos * dist, c0=self.c0 * dist / time)

    # ---------------------------------------------------------- constructors
    @staticmethod
    def Grid(shape: Tuple[int, int, int] = (5, 1, 5),
             spacing: Tuple[float, float, float] = (5e-3, 5e-3, 5e-3),
             center: Tuple[float, float, float] = (0.0, 0.0, 30e-3),
             c0: float = 1540.0) -> "Scatterers":
        """Regular grid of unit scatterers (``Scatterers.Grid``,
        ``Scatterers.m:401``)."""
        axes = [s * (np.arange(n) - (n - 1) / 2) for n, s in zip(shape, spacing)]
        X, Y, Z = np.meshgrid(*axes, indexing="ij")
        pos = np.stack([X.ravel(), Y.ravel(), Z.ravel()]) + np.asarray(center)[:, None]
        return Scatterers(pos=pos, c0=c0)

    @staticmethod
    def Diffuse(scan, density: float = 2.0, level_db: float = 0.0,
                c0: float = 1540.0, seed: int = 0) -> "Scatterers":
        """Diffuse speckle: ~``density`` scatterers per grid cell with
        normally-distributed amplitudes at ``level_db``
        (``Scatterers.Diffuse``, ``Scatterers.m:445``)."""
        rng = np.random.default_rng(seed)
        n = max(1, int(round(density * scan.npix)))
        p = scan.positions().reshape(3, -1)
        lo = p.min(axis=1)
        hi = p.max(axis=1)
        pos = rng.uniform(lo[:, None], hi[:, None], size=(3, n))
        amp = 10 ** (level_db / 20) * rng.standard_normal(n)
        return Scatterers(pos=pos, amp=amp, c0=c0)
