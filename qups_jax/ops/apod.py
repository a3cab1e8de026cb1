"""Fused-geometry apodization.

An apodization that is a function of pixel and element geometry need not
be materialized as an (I, N, M) tensor: the DAS kernel evaluates it from
operands it already holds (pixel coordinates, element positions and
orientations, transmit parameters), as the reference's ``bf.cu`` computes
its weights in registers. :class:`Fused` names such an apodization; its
``materialize`` gives the dense broadcastable array that the XLA paths
consume (``UltrasoundSystem.m:4892-5428``).

The weight functions below are written on plain ``jax.numpy`` values, so
the same code runs inside the kernel and in the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

RX_KINDS = ("aperture_growth", "acceptance_angle")
TX_KINDS = ("tx_scanline", "tx_multiline", "tx_parallelogram")


@dataclasses.dataclass(frozen=True)
class Fused:
    """A fused-geometry apodization descriptor.

    kind: 'aperture_growth' (params: f, Dmax), 'acceptance_angle'
    (params: theta degrees), 'tx_scanline' (params: tol; arrays: lat_tx),
    'tx_multiline' (params: dlat; arrays: lat_tx), 'tx_parallelogram'
    (params: xlo, xhi, the aperture bounds). ``materialize(us)`` returns
    the dense (I1,I2,I3,N,M) broadcastable array for the XLA path.
    """
    kind: str
    params: Tuple[Tuple[str, float], ...] = ()

    def __init__(self, kind: str, **params):
        if kind not in RX_KINDS + TX_KINDS:
            raise ValueError(f"unknown fused apodization {kind!r}")
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "params", tuple(sorted(params.items())))

    @property
    def p(self):
        return dict(self.params)

    def materialize(self, us):
        from ..system import (_ap_aperture_growth, _ap_acceptance_angle,
                              _ap_scanline, _ap_multiline,
                              _ap_tx_parallelogram)
        p = self.p
        if self.kind == "aperture_growth":
            return _ap_aperture_growth(us, f=p.get("f", 1.5),
                                       Dmax=p.get("Dmax", np.inf))
        if self.kind == "acceptance_angle":
            return _ap_acceptance_angle(us, theta=p.get("theta", 45.0))
        if self.kind == "tx_scanline":
            return _ap_scanline(us, tol=p.get("tol"))
        if self.kind == "tx_multiline":
            return _ap_multiline(us)
        return _ap_tx_parallelogram(us)


def split_fused(apod):
    """Split :class:`Fused` descriptors into static ``(rx_apods,
    tx_apods)`` tuples of ``(kind, ((param, value), ...))`` plus the
    per-transmit lateral array ``lat_tx`` (or None)."""
    rx_apods, tx_apods = [], []
    lat_tx = None
    for a in apod:
        p = a.p
        if a.kind in RX_KINDS:
            prm = {k: float(v) for k, v in p.items()
                   if isinstance(v, (int, float))}
            rx_apods.append((a.kind, tuple(sorted(prm.items()))))
            continue
        if p.get("lat_tx") is not None:
            lat_tx = np.asarray(p["lat_tx"], np.float32)
        keys = {"tx_scanline": ("tol",), "tx_multiline": ("dlat",),
                "tx_parallelogram": ("xlo", "xhi")}[a.kind]
        prm = tuple((k, float(p[k])) for k in keys)
        tx_apods.append((a.kind, prm))
    return tuple(rx_apods), tuple(tx_apods), lat_tx


def rx_weight(kind, prm, dx, dy, dz, dr, sa, ca, planar: bool):
    """Receive-side weight for pixels vs one element. ``dx, dy, dz`` =
    pixel - element, ``dr`` its norm; ``sa, ca`` the sine and cosine of
    the element azimuth (its normal is ``(sa, 0, ca)``)."""
    if kind == "aperture_growth":
        # f-number growth in the element frame: lateral offset d, depth z
        # (``UltrasoundSystem.apApertureGrowth``, ``:5165``)
        d = dx * ca - dz * sa
        z = dz * ca + dx * sa
        f = prm.get("f", 1.5)
        m = jnp.abs(z) > (2.0 * f) * jnp.abs(d)
        Dmax = prm.get("Dmax", np.inf)
        if np.isfinite(Dmax):
            m = m & (2.0 * jnp.abs(d) < Dmax)
        return jnp.where(m, 1.0, 0.0)
    # acceptance angle: <normal, unit(pixel - element)> >= cos(theta)
    # (``UltrasoundSystem.apAcceptanceAngle``, ``:5303``)
    c = dx * sa + dz * ca
    cth = float(np.cos(np.radians(prm.get("theta", 45.0))))
    return jnp.where(c >= cth * dr, 1.0, 0.0)


def tx_weight(kind, prm, lat, px, pz, lm, nvx, nvz):
    """Transmit-side weight for pixels vs one transmit. ``lat`` is the
    pixel lateral coordinate, ``lm`` the transmit's; ``nvx, nvz`` its
    steering direction."""
    if kind == "tx_scanline":
        # (``UltrasoundSystem.apScanline``, ``:4892``)
        return jnp.where(jnp.abs(lat - lm) < prm["tol"], 1.0, 0.0)
    if kind == "tx_multiline":
        # linear interpolation between the two nearest scanlines
        # (uniform spacing; ``UltrasoundSystem.apMultiline``, ``:4970``)
        return jnp.maximum(0.0, 1.0 - jnp.abs(lat - lm) / prm["dlat"])
    # plane-wave parallelogram: project the pixel to z = 0 along the
    # steering direction (``UltrasoundSystem.apTxParallelogram``, ``:5269``)
    x0 = px - nvx * (pz / nvz)
    return jnp.where((x0 > prm["xlo"]) & (x0 <= prm["xhi"]), 1.0, 0.0)


def dense_weights(rx_apods, tx_apods, pi, pr, orientations, lat, lat_tx, nv,
                  planar: bool):
    """The weights of split descriptors (:func:`split_fused`) evaluated as
    the DAS kernel evaluates them, as arrays for the XLA scan: an (I, N, 1)
    receive factor and an (I, 1, M) transmit factor, each only where such
    descriptors exist. ``pi (I, 3)``, ``pr (N, 3)``, ``orientations (2,
    N)`` [sin, cos] of the element azimuth, ``lat (I,)``, ``lat_tx (M,)``,
    ``nv (M, 3)``."""
    out = []
    if rx_apods:
        d = pi[:, None, :] - pr[None]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        r2 = dx * dx + dz * dz
        dr = jnp.sqrt(r2 if planar else r2 + dy * dy)
        w = 1.0
        for kind, prm in rx_apods:
            w = w * rx_weight(kind, dict(prm), dx, dy, dz, dr,
                              orientations[0][None], orientations[1][None],
                              planar)
        out.append(w[:, :, None])
    if tx_apods:
        w = 1.0
        for kind, prm in tx_apods:
            w = w * tx_weight(kind, dict(prm), lat[:, None], pi[:, :1],
                              pi[:, 2:], lat_tx[None], nv[None, :, 0],
                              nv[None, :, 2])
        out.append(w[:, None, :])
    return tuple(out)
