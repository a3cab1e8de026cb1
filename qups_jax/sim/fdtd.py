"""k-space pseudospectral full-wave simulation (k-Wave-class).

Equivalent of the reference's k-Wave interop
(``UltrasoundSystem.kspaceFirstOrder``,
``/root/reference/src/UltrasoundSystem.m:2458-3170``): a first-order coupled
acoustic PSTD stepper on a staggered grid with k-space correction and a
split-field PML, simulating full-wave propagation through a heterogeneous
``Medium`` — built natively in JAX rather than via the external k-Wave
toolbox (SURVEY.md §7 item 7).

Equations (2-D shown; 3-D identical per axis):

    du/dt   = -(1/rho0) grad(p)        (staggered spatial shifts)
    drho/dt = -rho0 div(u) + source
    p       = c^2 (rho + B/2A rho^2/rho0 + absorption)

with the optional power-law absorption + dispersion of the k-Wave model
(Treeby & Cox, fractional Laplacian; ``Medium.m:397`` passes alpha/BonA to
k-Wave and this stepper consumes them natively):

    absorption = tau (-lap)^(y/2-1)(rho0 div u) + eta (-lap)^((y+1)/2-1) rho
    tau = -2 a_np c^(y-1),  eta = 2 a_np c^y tan(pi y / 2)

evaluated in k-space (two extra FFT pairs per step). Spectral derivatives
with the k-space correction ``kappa = sinc(c_ref k dt / 2)`` give
unconditional dispersion accuracy for homogeneous media; the PML absorbs at
the boundary. This maps cleanly to an accelerator: each step is FFTs +
elementwise math under ``lax.fori_loop``, all static shapes.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _pml_profile(n: int, npml: int, alpha_max: float, dt: float):
    """Exponential PML absorption profile along one axis (length n)."""
    x = np.zeros(n)
    if npml > 0:
        ramp = (np.arange(1, npml + 1) / npml) ** 4
        x[:npml] = ramp[::-1]
        x[-npml:] = ramp
    return np.exp(-alpha_max * x * dt / 2)


def db2neper(alpha_db, y: float):
    """dB/(MHz^y cm) -> Np (rad/s)^-y / m (the k-Wave unit conversion)."""
    return 100.0 * np.asarray(alpha_db) * (1e-6 / (2 * np.pi)) ** y \
        / (20.0 * np.log10(np.e))


def _absorb_terms(alpha0, alpha_power, c, Knp):
    """Fractional-Laplacian absorption operators: (tau, eta, nabla1,
    nabla2) maps — tau/eta in real space (traced jnp: ``c``/``alpha0`` may
    be device arrays), nabla in k-space (host) with the k = 0 (and any
    singular) component zeroed."""
    y = float(alpha_power)
    a_np = 100.0 * jnp.asarray(alpha0, jnp.float32) \
        * np.float32((1e-6 / (2 * np.pi)) ** y / (20.0 * np.log10(np.e)))
    tau = -2.0 * a_np * c ** (y - 1.0)
    eta = 2.0 * a_np * c ** y * np.float32(np.tan(np.pi * y / 2.0))
    with np.errstate(divide="ignore"):
        nab1 = Knp ** (y - 2.0)
        nab2 = Knp ** (y - 1.0)
    nab1[~np.isfinite(nab1)] = 0.0
    nab2[~np.isfinite(nab2)] = 0.0
    return (tau, eta,
            jnp.asarray(nab1, jnp.float32), jnp.asarray(nab2, jnp.float32))


@partial(jax.jit, static_argnames=("steps", "dt", "dx", "c_ref",
                                   "record_rows", "alpha_power",
                                   "field_stride"))
def kspace_sim_2d(c, rho, src_rows, src_cols, src_sig, *, steps: int,
                  dt: float, dx: float, c_ref: float,
                  record_rows: Tuple[int, ...], alpha0=None,
                  alpha_power: float = 1.5, bona=None,
                  field_stride: int = 0):
    """2-D k-space PSTD simulation.

    Args:
      c: sound-speed map (Nz, Nx) [m/s] (PML region included).
      rho: density map (Nz, Nx) [kg/m^3].
      src_rows, src_cols: (Q,) int32 source node indices.
      src_sig: (steps, Q) source waveform (added to pressure) per node.
      steps: number of time steps; dt: time step [s]; dx: isotropic grid
        spacing [m]; c_ref: k-space correction reference speed.
      record_rows: grid rows whose full pressure line is recorded each step
        (row-slices are contiguous; element projection happens on host).
      alpha0: optional power-law absorption map [dB/(MHz^y cm)] — enables
        the fractional-Laplacian absorption+dispersion terms.
      alpha_power: the power-law exponent y (homogeneous; k-Wave likewise).
      bona: optional B/A nonlinearity map — enables the quadratic pressure
        term (cumulative harmonic generation).
      field_stride: if > 0, additionally snapshot the FULL pressure field
        every ``field_stride`` steps — the reference's ``'field'`` sensor
        mode (``UltrasoundSystem.m:2542`` records the whole grid when
        requested).

    Returns: recorded pressure (steps, len(record_rows), Nx); with
    ``field_stride`` > 0, a tuple ``(recorded, field)`` where field is
    (ceil(steps/stride), Nz, Nx).
    """
    c = jnp.asarray(c, jnp.float32)
    rho = jnp.asarray(rho, jnp.float32)
    Nz, Nx = c.shape
    kz = np.fft.fftfreq(Nz, dx) * 2 * np.pi  # (Nz,)
    kx = np.fft.fftfreq(Nx, dx) * 2 * np.pi  # (Nx,)
    KZ = jnp.asarray(kz[:, None], jnp.float32)
    KX = jnp.asarray(kx[None, :], jnp.float32)
    # k-space correction kappa = sinc(c_ref |k| dt / 2) (unnormalized sinc)
    Knp = np.sqrt(kz[:, None] ** 2 + kx[None, :] ** 2)
    kappa = jnp.asarray(np.sinc(c_ref * Knp * dt / 2 / np.pi), jnp.float32)
    # staggered-grid phase shifts (+dx/2 forward, -dx/2 backward)
    ez_f = jnp.exp(+1j * KZ * dx / 2)
    ez_b = jnp.exp(-1j * KZ * dx / 2)
    ex_f = jnp.exp(+1j * KX * dx / 2)
    ex_b = jnp.exp(-1j * KX * dx / 2)

    npml = 10
    alpha = 2.0 * c_ref / dx  # strong absorption
    pml_z = jnp.asarray(_pml_profile(Nz, npml, alpha, dt), jnp.float32)[:, None]
    pml_x = jnp.asarray(_pml_profile(Nx, npml, alpha, dt), jnp.float32)[None, :]

    rho0 = rho
    c2 = c * c
    absorbing = alpha0 is not None
    if absorbing:
        tau, eta, nab1, nab2 = _absorb_terms(alpha0, alpha_power, c, Knp)
    nonlin = bona is not None
    if nonlin:
        bq = jnp.asarray(bona, jnp.float32) / (2.0 * rho0)

    def ddz(f, stag):
        F = jnp.fft.fft(f, axis=0)
        return jnp.real(jnp.fft.ifft(1j * KZ * kappa * stag * F, axis=0))

    def ddx(f, stag):
        F = jnp.fft.fft(f, axis=1)
        return jnp.real(jnp.fft.ifft(1j * KX * kappa * stag * F, axis=1))

    def pressure(rho_t, divu):
        pr = rho_t
        if nonlin:
            pr = pr + bq * rho_t * rho_t
        if absorbing:
            Fd = jnp.fft.fft2(rho0 * divu)
            Fr = jnp.fft.fft2(rho_t)
            pr = pr + tau * jnp.real(jnp.fft.ifft2(nab1 * Fd)) \
                + eta * jnp.real(jnp.fft.ifft2(nab2 * Fr))
        return c2 * pr

    rows = jnp.asarray(np.asarray(record_rows, np.int32))
    nsnap = -(-steps // field_stride) if field_stride else 0

    def step_fn(i, state):
        uz, ux, rz, rx, p, rec, fld = state
        # velocity update (staggered forward shift)
        uz = pml_z * (pml_z * uz - dt / rho0 * ddz(p, ez_f))
        ux = pml_x * (pml_x * ux - dt / rho0 * ddx(p, ex_f))
        # density update (staggered backward shift), split per axis for PML
        dzu = ddz(uz, ez_b)
        dxu = ddx(ux, ex_b)
        rz = pml_z * (pml_z * rz - dt * rho0 * dzu)
        rx = pml_x * (pml_x * rx - dt * rho0 * dxu)
        # additive pressure source: inject as density (p = c^2 rho)
        s = src_sig[i]
        rz = rz.at[src_rows, src_cols].add(s / (2 * c2[src_rows, src_cols]))
        rx = rx.at[src_rows, src_cols].add(s / (2 * c2[src_rows, src_cols]))
        p = pressure(rz + rx, dzu + dxu)
        rec = rec.at[i].set(p[rows, :])
        if field_stride:
            fld = jax.lax.cond(
                i % field_stride == 0,
                lambda f: f.at[i // field_stride].set(p),
                lambda f: f, fld)
        return uz, ux, rz, rx, p, rec, fld

    z = jnp.zeros((Nz, Nx), jnp.float32)
    rec0 = jnp.zeros((steps, len(record_rows), Nx), jnp.float32)
    fld0 = jnp.zeros((nsnap, Nz, Nx), jnp.float32)
    out = jax.lax.fori_loop(0, steps, step_fn, (z, z, z, z, z, rec0, fld0))
    return (out[-2], out[-1]) if field_stride else out[-2]


@partial(jax.jit, static_argnames=("steps", "dt", "dx", "c_ref",
                                   "record_rows", "alpha_power",
                                   "field_stride"))
def kspace_sim_3d(c, rho, src_idx, src_sig, *, steps: int, dt: float,
                  dx: float, c_ref: float, record_rows: Tuple[int, ...],
                  alpha0=None, alpha_power: float = 1.5, bona=None,
                  field_stride: int = 0):
    """3-D k-space PSTD simulation (volumetric ``kspaceFirstOrder3D``
    capability, ``UltrasoundSystem.m:2458``).

    Args:
      c, rho: (Nz, Nx, Ny) maps; src_idx: (3, Q) int32 node indices
      (z, x, y); src_sig: (steps, Q); record_rows: z-planes recorded fully.
      field_stride: if > 0, also snapshot the full volume every
        ``field_stride`` steps (the ``'field'`` sensor mode).

    Returns: (steps, len(record_rows), Nx, Ny) pressure; with
    ``field_stride`` > 0, ``(recorded, field)`` with field
    (ceil(steps/stride), Nz, Nx, Ny).
    """
    c = jnp.asarray(c, jnp.float32)
    rho = jnp.asarray(rho, jnp.float32)
    Nz, Nx, Ny = c.shape
    ks = [np.fft.fftfreq(n, dx) * 2 * np.pi for n in (Nz, Nx, Ny)]
    KZ = jnp.asarray(ks[0][:, None, None], jnp.float32)
    KX = jnp.asarray(ks[1][None, :, None], jnp.float32)
    KY = jnp.asarray(ks[2][None, None, :], jnp.float32)
    Knp = np.sqrt(ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
                  + ks[2][None, None, :] ** 2)
    kappa = jnp.asarray(np.sinc(c_ref * Knp * dt / 2 / np.pi), jnp.float32)
    sh = [jnp.exp(s * 1j * K * dx / 2)
          for K in (KZ, KX, KY) for s in (+1, -1)]
    ez_f, ez_b, ex_f, ex_b, ey_f, ey_b = sh

    npml = 8
    alpha = 2.0 * c_ref / dx
    pml = [jnp.asarray(_pml_profile(n, npml, alpha, dt), jnp.float32)
           for n in (Nz, Nx, Ny)]
    pml_z = pml[0][:, None, None]
    pml_x = pml[1][None, :, None]
    pml_y = pml[2][None, None, :]

    rho0 = rho
    c2 = c * c
    absorbing = alpha0 is not None
    if absorbing:
        tau, eta, nab1, nab2 = _absorb_terms(alpha0, alpha_power, c, Knp)
    nonlin = bona is not None
    if nonlin:
        bq = jnp.asarray(bona, jnp.float32) / (2.0 * rho0)

    def pressure(rho_t, divu):
        pr = rho_t
        if nonlin:
            pr = pr + bq * rho_t * rho_t
        if absorbing:
            Fd = jnp.fft.fftn(rho0 * divu)
            Fr = jnp.fft.fftn(rho_t)
            pr = pr + tau * jnp.real(jnp.fft.ifftn(nab1 * Fd)) \
                + eta * jnp.real(jnp.fft.ifftn(nab2 * Fr))
        return c2 * pr

    def dd(f, K, stag, axis):
        F = jnp.fft.fft(f, axis=axis)
        return jnp.real(jnp.fft.ifft(1j * K * kappa * stag * F, axis=axis))

    rows = jnp.asarray(np.asarray(record_rows, np.int32))
    sz, sx, sy = (jnp.asarray(src_idx[i], jnp.int32) for i in range(3))

    nsnap = -(-steps // field_stride) if field_stride else 0

    def step_fn(i, state):
        uz, ux, uy, rz, rx_, ry, p, rec, fld = state
        uz = pml_z * (pml_z * uz - dt / rho0 * dd(p, KZ, ez_f, 0))
        ux = pml_x * (pml_x * ux - dt / rho0 * dd(p, KX, ex_f, 1))
        uy = pml_y * (pml_y * uy - dt / rho0 * dd(p, KY, ey_f, 2))
        dzu = dd(uz, KZ, ez_b, 0)
        dxu = dd(ux, KX, ex_b, 1)
        dyu = dd(uy, KY, ey_b, 2)
        rz = pml_z * (pml_z * rz - dt * rho0 * dzu)
        rx_ = pml_x * (pml_x * rx_ - dt * rho0 * dxu)
        ry = pml_y * (pml_y * ry - dt * rho0 * dyu)
        s = src_sig[i] / (3 * c2[sz, sx, sy])
        rz = rz.at[sz, sx, sy].add(s)
        rx_ = rx_.at[sz, sx, sy].add(s)
        ry = ry.at[sz, sx, sy].add(s)
        p = pressure(rz + rx_ + ry, dzu + dxu + dyu)
        rec = rec.at[i].set(p[rows])
        if field_stride:
            fld = jax.lax.cond(
                i % field_stride == 0,
                lambda f: f.at[i // field_stride].set(p),
                lambda f: f, fld)
        return uz, ux, uy, rz, rx_, ry, p, rec, fld

    z = jnp.zeros((Nz, Nx, Ny), jnp.float32)
    rec0 = jnp.zeros((steps, len(record_rows), Nx, Ny), jnp.float32)
    fld0 = jnp.zeros((nsnap, Nz, Nx, Ny), jnp.float32)
    out = jax.lax.fori_loop(0, steps, step_fn,
                            (z, z, z, z, z, z, z, rec0, fld0))
    return (out[-2], out[-1]) if field_stride else out[-2]


@partial(jax.jit, static_argnames=("steps", "dt", "dx", "c_ref",
                                   "record_rows", "alpha_power",
                                   "field_stride"))
def kspace_sim_1d(c, rho, src_idx, src_sig, *, steps: int, dt: float,
                  dx: float, c_ref: float, record_rows: Tuple[int, ...],
                  alpha0=None, alpha_power: float = 1.5, bona=None,
                  field_stride: int = 0):
    """1-D k-space PSTD simulation — completes the reference's
    ``kspaceFirstOrder[123]D`` dimension sweep (``UltrasoundSystem.m:
    3040``; the 1-D variant models plane-wave/through-transmission
    columns). Same physics as :func:`kspace_sim_2d` reduced to one axis.

    Args:
      c, rho: (Nz,) property maps (PML included). src_idx: (Q,) int32
      node indices. src_sig: (steps, Q). record_rows: cells recorded.

    Returns (steps, len(record_rows)) pressure; with ``field_stride`` > 0,
    ``(recorded, field)`` with field (ceil(steps/stride), Nz).

    Example:
        import numpy as np
        from qups_jax.sim.fdtd import kspace_sim_1d
        c0, h = 1500.0, 0.2e-3
        N, steps = 256, 300
        dt = 0.3 * h / c0
        t = np.arange(steps) * dt
        sig = (np.exp(-((t - 1e-6) * 2e6 * 2) ** 2)
               * np.sin(2 * np.pi * 2e6 * t))[:, None].astype(np.float32)
        rec = kspace_sim_1d(np.full(N, c0), np.full(N, 1000.0),
                            np.array([30]), sig, steps=steps, dt=dt,
                            dx=h, c_ref=c0, record_rows=(140,))
        t_pk = t[np.abs(np.asarray(rec)[:, 0]).argmax()]
        want = 110 * h / c0 + 1e-6
        assert abs(t_pk - want) < 4 * dt
    """
    c = jnp.asarray(c, jnp.float32)
    rho = jnp.asarray(rho, jnp.float32)
    Nz = c.shape[0]
    kz = np.fft.fftfreq(Nz, dx) * 2 * np.pi
    KZ = jnp.asarray(kz, jnp.float32)
    Knp = np.abs(kz)
    kappa = jnp.asarray(np.sinc(c_ref * Knp * dt / 2 / np.pi), jnp.float32)
    ez_f = jnp.exp(+1j * KZ * dx / 2)
    ez_b = jnp.exp(-1j * KZ * dx / 2)
    npml = 10
    alpha = 2.0 * c_ref / dx
    pml_z = jnp.asarray(_pml_profile(Nz, npml, alpha, dt), jnp.float32)

    rho0 = rho
    c2 = c * c
    absorbing = alpha0 is not None
    if absorbing:
        tau, eta, nab1, nab2 = _absorb_terms(alpha0, alpha_power, c, Knp)
    nonlin = bona is not None
    if nonlin:
        bq = jnp.asarray(bona, jnp.float32) / (2.0 * rho0)

    def ddz(f, stag):
        F = jnp.fft.fft(f)
        return jnp.real(jnp.fft.ifft(1j * KZ * kappa * stag * F))

    def pressure(rho_t, divu):
        pr = rho_t
        if nonlin:
            pr = pr + bq * rho_t * rho_t
        if absorbing:
            Fd = jnp.fft.fft(rho0 * divu)
            Fr = jnp.fft.fft(rho_t)
            pr = pr + tau * jnp.real(jnp.fft.ifft(nab1 * Fd)) \
                + eta * jnp.real(jnp.fft.ifft(nab2 * Fr))
        return c2 * pr

    rows = jnp.asarray(np.asarray(record_rows, np.int32))
    src = jnp.asarray(src_idx, jnp.int32).reshape(-1)
    nsnap = -(-steps // field_stride) if field_stride else 0

    def step_fn(i, state):
        uz, rz, p, rec, fld = state
        uz = pml_z * (pml_z * uz - dt / rho0 * ddz(p, ez_f))
        dzu = ddz(uz, ez_b)
        rz = pml_z * (pml_z * rz - dt * rho0 * dzu)
        s = src_sig[i]
        rz = rz.at[src].add(s / c2[src])
        p = pressure(rz, dzu)
        rec = rec.at[i].set(p[rows])
        if field_stride:
            fld = jax.lax.cond(
                i % field_stride == 0,
                lambda f: f.at[i // field_stride].set(p),
                lambda f: f, fld)
        return uz, rz, p, rec, fld

    z = jnp.zeros((Nz,), jnp.float32)
    rec0 = jnp.zeros((steps, len(record_rows)), jnp.float32)
    fld0 = jnp.zeros((nsnap, Nz), jnp.float32)
    out = jax.lax.fori_loop(0, steps, step_fn, (z, z, z, rec0, fld0))
    return (out[-2], out[-1]) if field_stride else out[-2]
