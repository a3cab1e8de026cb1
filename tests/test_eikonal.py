"""Eikonal solver + bfEikonal tests — the KernTest msfm-vs-analytic-distance
oracle (``test/KernTest.m:409``) and the heterogeneous-medium beamformer."""
import numpy as np
import pytest

import qups_jax as q
from qups_jax.ops.eikonal import msfm, msfm_multi, _load_native


def test_msfm2d_analytic_distance():
    # homogeneous speed: T = r / c (analytic), interior accuracy ~ h
    n = 101
    h = 1e-3
    c = 1500.0
    F = np.full((n, n), c)
    src = [(n // 2, n // 2)]
    T = msfm(F, h, src)
    z = (np.arange(n) - n // 2) * h
    Z, X = np.meshgrid(z, z, indexing="ij")
    R = np.hypot(Z, X)
    Ta = R / c
    # relative error in an interior annulus (away from source singularity)
    m = (R > 5 * h) & (R < 45 * h)
    rel = np.abs(T[m] - Ta[m]) / Ta[m]
    assert rel.mean() < 0.01, rel.mean()
    assert rel.max() < 0.05, rel.max()


def test_msfm2d_python_matches_native():
    if _load_native() is None:
        pytest.skip("native msfm unavailable")
    n = 41
    rng = np.random.default_rng(0)
    F = 1500 + 200 * rng.random((n, n))
    T1 = msfm(F, 1e-3, [(5, 7)], use_native=True)
    T2 = msfm(F, 1e-3, [(5, 7)], use_native=False)
    assert np.allclose(T1, T2, rtol=1e-6, atol=1e-12)


def test_msfm3d_analytic():
    n = 41
    h = 1e-3
    c = 1500.0
    F = np.full((n, n, n), c)
    T = msfm(F, h, [(n // 2, n // 2, n // 2)])
    z = (np.arange(n) - n // 2) * h
    Z, X, Y = np.meshgrid(z, z, z, indexing="ij")
    R = np.sqrt(Z**2 + X**2 + Y**2)
    m = (R > 5 * h) & (R < 18 * h)
    rel = np.abs(T[m] - R[m] / c) / (R[m] / c)
    assert rel.mean() < 0.02, rel.mean()


def test_msfm_refraction():
    # two-layer medium: fast marching beats the straight-ray time through a
    # slow inclusion (Fermat: computed time <= straight-ray time)
    n = 81
    h = 1e-3
    F = np.full((n, n), 1500.0)
    F[30:50, :] = 1000.0  # slow slab
    T = msfm(F, h, [(0, 40)])
    # straight-ray time through the slab to the far side
    t_straight = (30 * h / 1500) + (20 * h / 1000) + (30 * h / 1500)
    assert T[80, 40] <= t_straight + 1e-9
    assert T[80, 40] > 80 * h / 1500  # but slower than all-fast medium


def test_msfm_multi_shapes():
    F = np.full((31, 31), 1500.0)
    srcs = [(0, 5), (0, 15), (0, 25)]
    Ts = msfm_multi(F, 1e-3, srcs)
    assert Ts.shape == (3, 31, 31)
    for k, s in enumerate(srcs):
        assert Ts[k][s] == 0


def test_bf_eikonal_homogeneous_matches_bfdas():
    # in a homogeneous medium the eikonal delays reduce to straight rays
    C0 = 1540.0
    xdc = q.TransducerArray(numel=16, pitch=0.5e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=16, c0=C0),
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 33),
                             z=np.linspace(20e-3, 36e-3, 33)), fs=24e6)
    scat = q.Scatterers(pos=[[0.0], [0.0], [28e-3]], c0=C0)
    chd = us.greens(scat)
    med = q.Medium(c0=C0)
    b1 = np.asarray(us.bfEikonal(chd, med)).squeeze()
    b2 = np.asarray(us.bfDAS(chd)).squeeze()
    # peak location agrees
    i1 = np.unravel_index(np.abs(b1).argmax(), b1.shape)
    i2 = np.unravel_index(np.abs(b2).argmax(), b2.shape)
    assert abs(i1[0] - i2[0]) <= 1 and abs(i1[1] - i2[1]) <= 1
    # correlation between the two images is high
    c = np.abs(np.vdot(b1, b2)) / (np.linalg.norm(b1) * np.linalg.norm(b2))
    assert c > 0.9, c


def test_bf_eikonal_lens_shifts_focus():
    # a slow lens layer delays echoes; the eikonal beamformer with the true
    # medium localizes the target better than the homogeneous assumption
    C0 = 1540.0
    CS = 1300.0
    xdc = q.TransducerArray(numel=16, pitch=0.5e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=16, c0=C0),
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 33),
                             z=np.linspace(20e-3, 36e-3, 33)), fs=24e6)
    med = q.Medium(c0=C0, pertreg=((lambda P: P[2] < 5e-3, {"c": CS}),))
    # simulate with an effective straight-ray delay through the lens:
    # approximate by a homogeneous sim at the harmonic-mean speed along z
    # (adequate for a thin flat lens directly below the array)
    z_target = 28e-3
    t_lens = 5e-3 / CS + (z_target - 5e-3) / C0
    c_eff = z_target / t_lens
    scat = q.Scatterers(pos=[[0.0], [0.0], [z_target]], c0=c_eff)
    chd = us.greens(scat)
    b_eik = np.asarray(us.bfEikonal(chd, med)).squeeze()
    P = us.scan.positions()
    iz, ix = np.unravel_index(np.abs(b_eik).argmax(), b_eik.shape)
    z_eik = P[2, iz, ix, 0]
    b_hom = np.asarray(us.bfDAS(chd)).squeeze()
    iz2, ix2 = np.unravel_index(np.abs(b_hom).argmax(), b_hom.shape)
    z_hom = P[2, iz2, ix2, 0]
    # homogeneous beamforming misplaces the target axially; eikonal fixes it
    assert abs(z_eik - z_target) < abs(z_hom - z_target) + 1e-9
    assert abs(z_eik - z_target) < 1.1e-3


def test_eikonal_tables_nonfsa_matches_geometric():
    """Fermat wavefront tx tables == straight-ray virtual-source tables in
    a homogeneous medium (PW and FC sequences)."""
    C0 = 1540.0
    xdc = q.TransducerArray(numel=32, pitch=0.4e-3, fc=5e6)
    scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 24), y=[0.0],
                           z=np.linspace(8e-3, 20e-3, 32))
    h = 0.2e-3
    cgrd = q.ScanCartesian(x=np.arange(-8e-3, 8e-3, h), y=[0.0],
                           z=np.arange(0.0, 24e-3, h))
    med = q.Medium(c0=C0)
    ang = np.radians([-8.0, 0.0, 8.0])
    # --- PW: projection convention holds wherever the stationary element
    # is inside the aperture (true for this geometry) ---
    seq = q.Sequence(type="PW", focus=np.stack(
        [np.sin(ang), 0 * ang, np.cos(ang)]), c0=C0)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=20e6)
    tau_rx, tau_tx = us.eikonal_tables(med, cgrd)
    g_rx, g_tx = us.das_delay_tables()
    assert np.abs(tau_rx - g_rx).max() * C0 < 3 * h  # straight-ray rx
    assert np.abs(tau_tx - g_tx).max() * C0 < 5 * h

    # --- FC: the Fermat arrival equals the two-sided virtual-source delay
    # only inside the focal cone (rays through the focus that hit the
    # aperture); outside it deviates — physically correct first-arrival ---
    zf = 12e-3
    seq = q.Sequence(type="FC", focus=np.array(
        [[0.0], [0.0], [zf]]), c0=C0)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=20e6)
    tau_rx, tau_tx = us.eikonal_tables(med, cgrd)
    g_rx, g_tx = us.das_delay_tables()
    P = us.scan.positions().reshape(3, -1)
    half_ap = 0.4e-3 * (32 - 1) / 2
    cone = (P[2] > zf + 1e-3) \
        & (np.abs(P[0]) < 0.7 * half_ap * (P[2] - zf) / zf)
    assert cone.sum() > 20
    err = np.abs(tau_tx[:, 0] - g_tx[:, 0]) * C0
    assert err[cone].max() < 5 * h, err[cone].max()
    # outside-cone arrivals are EARLIER or equal (first-arrival principle)
    assert (tau_tx[:, 0] <= g_tx[:, 0] + 3 * h / C0).all()


def test_eikonal_tables_3d():
    """3-D FSA eikonal maps match the analytic distance in a homogeneous
    volume."""
    C0 = 1500.0
    xdc = q.TransducerMatrix(numd=(4, 2), pitch2=(0.5e-3, 0.5e-3), fc=3e6)
    scan = q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                           y=np.linspace(-1e-3, 1e-3, 4),
                           z=np.linspace(4e-3, 8e-3, 8))
    h = 0.25e-3
    cgrd = q.ScanCartesian(x=np.arange(-4e-3, 4e-3, h),
                           y=np.arange(-2e-3, 2e-3, h),
                           z=np.arange(0e-3, 10e-3, h))
    med = q.Medium(c0=C0)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=q.Sequence(
        type="FSA", numpulse=xdc.numel, c0=C0), scan=scan, fs=12e6)
    tau_rx, tau_tx = us.eikonal_tables(med, cgrd)
    P = us.scan.positions().reshape(3, -1)
    pn = us.rx.positions()
    r = np.linalg.norm(P[:, :, None] - pn[:, None, :], axis=0)
    assert np.abs(tau_rx - r / C0).max() * C0 < 4 * h
    assert np.allclose(tau_tx, tau_rx)
