"""Full-wave PSTD simulator tests — the SimTest k-Wave oracle: the echo from
a scatterer must arrive at the analytic time-of-flight (tolerance ~grid
steps, ``test/SimTest.m:299-324``), plus free-field propagation sanity."""
import numpy as np
import pytest

import qups_jax as q
from qups_jax.sim.fdtd import kspace_sim_2d


def test_free_field_pulse_speed():
    # a point source pulse travels at c: check arrival time at a probe row
    c0 = 1500.0
    h = 0.2e-3
    N = 128
    cmap = np.full((N, N), c0)
    rho = np.full((N, N), 1000.0)
    dt = 0.3 * h / c0
    steps = 300
    fc = 2e6
    t = np.arange(steps) * dt
    sig = (np.exp(-((t - 0.8e-6) * fc * 2) ** 2)
           * np.sin(2 * np.pi * fc * t))[:, None].astype(np.float32)
    src = (np.array([20]), np.array([64]))
    rec = kspace_sim_2d(cmap, rho, src[0], src[1], sig, steps=steps, dt=dt,
                        dx=h, c_ref=c0, record_rows=(80, 100))
    rec = np.asarray(rec)  # (steps, 2, N)
    tr80 = rec[:, 0, 64]
    tr100 = rec[:, 1, 64]
    # differential arrival between the rows removes the source/2-D-tail bias
    dt_rows = t[np.abs(tr100).argmax()] - t[np.abs(tr80).argmax()]
    want = 20 * h / c0
    assert abs(dt_rows - want) < 4 * dt, (dt_rows, want)
    # absolute peak arrives near (within the pulse tail of) the TOF
    dist = 80 * h
    t_exp = dist / c0 + 0.8e-6
    assert abs(t[np.abs(tr100).argmax()] - t_exp) < 1e-6
    # no energy before the causal arrival
    pre = np.abs(tr100[: int((dist / c0) / dt) - 20]).max()
    assert pre < 0.05 * np.abs(tr100).max()


def test_kspace_scatterer_echo_tof():
    # pulse-echo from a density scatterer arrives at 2 z / c
    c0 = 1500.0
    fc = 2e6
    lam = c0 / fc
    xdc = q.TransducerArray(numel=16, pitch=lam / 2, fc=fc)
    z_t = 8e-3
    scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 41),
                           z=np.linspace(2e-3, 11e-3, 41))
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=q.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=c0),
        scan=scan, fs=4 * fc)
    # medium: point-like density scatterer at (0, z_t)
    def blob(P):
        return (np.hypot(P[0], P[2] - z_t) < lam / 4)
    med = q.Medium(c0=c0, rho0=1000.0, pertreg=((blob, {"rho": 2000.0}),))
    cgrd = q.ScanCartesian(x=np.arange(-5e-3, 5e-3, lam / 6), y=[0.0],
                           z=np.arange(-0.5e-3, 11.5e-3, lam / 6))
    chd = us.kspaceFirstOrder(med, cgrd)
    assert (chd.N, chd.M) == (16, 1)
    x = np.asarray(chd.data)[:, 8, 0]  # center element
    t = np.asarray(chd.time)[:, 0, 0]
    # remove the direct transmit artifact: look after 1.2x the echo path start
    t_echo = 2 * z_t / c0
    sel = t > 0.6 * t_echo
    i_pk = np.abs(x[sel]).argmax()
    t_pk = t[sel][i_pk]
    # tolerance: 10 grid steps (SimTest k-Wave tolerance)
    tol = 10 * (lam / 6) / c0
    assert abs(t_pk - t_echo) < tol, (t_pk, t_echo, tol)


def test_kspace_heterogeneous_slowdown():
    # a slow layer delays the echo relative to homogeneous
    c0 = 1500.0
    fc = 2e6
    lam = c0 / fc
    xdc = q.TransducerArray(numel=8, pitch=lam / 2, fc=fc)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=q.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=c0),
        scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 11),
                             z=np.linspace(1e-3, 8e-3, 11)), fs=4 * fc)
    z_t = 6e-3
    blob = lambda P: (np.hypot(P[0], P[2] - z_t) < lam / 4)
    cgrd = q.ScanCartesian(x=np.arange(-3e-3, 3e-3, lam / 6), y=[0.0],
                           z=np.arange(-0.5e-3, 8.5e-3, lam / 6))
    slow = lambda P: (P[2] > 1e-3) & (P[2] < 3e-3)
    med1 = q.Medium(c0=c0, pertreg=((blob, {"rho": 2000.0}),))
    med2 = q.Medium(c0=c0, pertreg=((slow, {"c": 1200.0}),
                                    (blob, {"rho": 2000.0})))
    t1 = _echo_time(us, med1, cgrd, z_t, c0)
    t2 = _echo_time(us, med2, cgrd, z_t, c0)
    # two-way extra delay through 2mm of 1200 m/s instead of 1500 m/s
    extra = 2 * 2e-3 * (1 / 1200 - 1 / 1500)
    assert t2 > t1 + 0.3 * extra, (t1, t2, extra)


def _echo_time(us, med, cgrd, z_t, c0):
    # search a window around the expected scatterer return so layer
    # interface reflections (earlier, stronger) don't dominate
    chd = us.kspaceFirstOrder(med, cgrd)
    x = np.asarray(chd.data)[:, us.rx.numel // 2, 0]
    t = np.asarray(chd.time)[:, 0, 0]
    t_echo = 2 * z_t / c0
    sel = (t > 0.85 * t_echo) & (t < 1.5 * t_echo)
    return t[sel][np.abs(x[sel]).argmax()]


def test_kspace_3d_free_field():
    # 3-D free field: differential arrival between two z-planes matches c
    from qups_jax.sim.fdtd import kspace_sim_3d
    c0, h = 1500.0, 0.4e-3
    N = 48
    cmap = np.full((N, N, N), c0)
    rho = np.full((N, N, N), 1000.0)
    dt = 0.3 * h / c0
    steps = 140
    fc = 1.5e6
    t = np.arange(steps) * dt
    sig = (np.exp(-((t - 1.2e-6) * fc * 2) ** 2)
           * np.sin(2 * np.pi * fc * t))[:, None].astype(np.float32)
    src = np.array([[10], [24], [24]])
    rec = kspace_sim_3d(cmap, rho, src, sig, steps=steps, dt=dt, dx=h,
                        c_ref=c0, record_rows=(28, 40))
    rec = np.asarray(rec)
    tr1 = rec[:, 0, 24, 24]
    tr2 = rec[:, 1, 24, 24]
    dt_rows = t[np.abs(tr2).argmax()] - t[np.abs(tr1).argmax()]
    want = 12 * h / c0
    assert abs(dt_rows - want) < 4 * dt, (dt_rows, want)
    assert np.isfinite(rec).all()


def test_kspace_3d_system_matrix_probe():
    # volumetric sim through the system wrapper with a matrix probe: echo
    # from a density blob at the analytic two-way time
    c0, fc = 1500.0, 1.5e6
    lam = c0 / fc
    xdc = q.TransducerMatrix(numd=(6, 6), pitch2=(lam / 2, lam / 2), fc=fc)
    z_t = 5e-3
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=q.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=c0),
        scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 6),
                             z=np.linspace(2e-3, 7e-3, 6)), fs=4 * fc)
    blob = lambda P: (np.sqrt(P[0]**2 + P[1]**2 + (P[2]-z_t)**2) < lam / 3)
    h = lam / 5
    cgrd = q.ScanCartesian(x=np.arange(-3.2e-3, 3.2e-3, h),
                           y=np.arange(-3.2e-3, 3.2e-3, h),
                           z=np.arange(-0.6e-3, 6.6e-3, h))
    med = q.Medium(c0=c0, pertreg=((blob, {"rho": 2500.0}),))
    chd = us.kspaceFirstOrder(med, cgrd)
    assert chd.N == 36 and chd.M == 1
    x = np.asarray(chd.data)[:, 14, 0]
    t = np.asarray(chd.time)[:, 0, 0]
    t_echo = 2 * z_t / c0
    sel = (t > 0.7 * t_echo) & (t < 1.6 * t_echo)
    t_pk = t[sel][np.abs(x[sel]).argmax()]
    assert abs(t_pk - t_echo) < 10 * h / c0, (t_pk, t_echo)


def test_kspace_absorption_power_law():
    """Amplitude decay matches exp(-alpha(f0) r) on top of geometric
    spreading (compare absorbing vs lossless sims at the same probe)."""
    import numpy as np
    from qups_jax.sim.fdtd import kspace_sim_2d, db2neper

    n, h, c0 = 160, 0.1e-3, 1500.0
    f0 = 2e6
    dt = 0.3 * h / c0
    steps = 420
    cmap = np.full((n, n), c0, np.float32)
    rmap = np.full((n, n), 1000.0, np.float32)
    t = np.arange(steps) * dt
    sig = (np.sin(2 * np.pi * f0 * t)
           * np.exp(-((t - 1.2e-6) / 0.5e-6) ** 2))[:, None].astype(np.float32)
    src = (np.array([20]), np.array([n // 2]))
    rows = (100, 140)
    a0, y = 1.5, 1.5  # dB/(MHz^1.5 cm)
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=c0, record_rows=rows)
    rec0 = np.asarray(kspace_sim_2d(cmap, rmap, *src, sig, **kw))
    reca = np.asarray(kspace_sim_2d(cmap, rmap, *src, sig,
                                    alpha0=np.full((n, n), a0, np.float32),
                                    alpha_power=y, **kw))
    # spectral amplitude AT f0 at each probe (the pulse is broadband and
    # f^y absorption + dispersion reshape it; the power law is per-frequency)
    f = np.fft.rfftfreq(steps, dt)
    b = np.argmin(np.abs(f - f0))

    def amp(rec, i):
        return np.abs(np.fft.rfft(rec[:, i, n // 2]))[b]

    dr = (rows[1] - rows[0]) * h
    a_np = db2neper(a0, y) * (2 * np.pi * f0) ** y
    want = np.exp(-a_np * dr)
    got = (amp(reca, 1) / amp(reca, 0)) / (amp(rec0, 1) / amp(rec0, 0))
    assert abs(got - want) / want < 0.1, (got, want)
    assert got < 0.95  # attenuation actually happened


def test_kspace_nonlinear_harmonics():
    """B/A nonlinearity generates second harmonic along propagation."""
    import numpy as np
    from qups_jax.sim.fdtd import kspace_sim_2d

    n, h, c0 = 160, 0.1e-3, 1500.0
    f0 = 2e6
    dt = 0.3 * h / c0
    steps = 480
    cmap = np.full((n, n), c0, np.float32)
    rmap = np.full((n, n), 1000.0, np.float32)
    t = np.arange(steps) * dt
    sig = (np.sin(2 * np.pi * f0 * t)
           * np.exp(-((t - 1.5e-6) / 0.8e-6) ** 2))[:, None].astype(np.float32)
    src = (np.array([20]), np.array([n // 2]))
    rows = (130,)
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=c0, record_rows=rows)

    # calibrate the drive so the FIELD reaches finite amplitude (~2 MPa,
    # 0.1% of rho0 c^2): the per-step density injection integrates, so the
    # source scalar is not the field pressure
    cal = np.asarray(kspace_sim_2d(cmap, rmap, *src, sig, **kw))
    pmax = np.abs(cal[:, 0, n // 2]).max()
    sig = sig * np.float32(0.001 * 1000.0 * c0 ** 2 / pmax)

    def hd2(rec):
        x = rec[:, 0, n // 2]
        X = np.abs(np.fft.rfft(x * np.hanning(steps)))
        f = np.fft.rfftfreq(steps, dt)
        b1 = X[np.argmin(np.abs(f - f0))]
        b2 = X[np.argmin(np.abs(f - 2 * f0))]
        return b2 / b1

    r_lin = hd2(np.asarray(kspace_sim_2d(cmap, rmap, *src, sig, **kw)))
    r_nl = hd2(np.asarray(kspace_sim_2d(
        cmap, rmap, *src, sig, bona=np.full((n, n), 9.0, np.float32), **kw)))
    assert r_nl > 3 * max(r_lin, 1e-6), (r_lin, r_nl)


def test_kspace_field_recording_and_bg_subtract():
    """record='field' returns full-grid pressure snapshots; bg_subtract
    through a homogeneous medium cancels (scattered field == 0), and with a
    scatterer it suppresses the direct transmit while keeping the echo
    (``UltrasoundSystem.m:2542`` field sensor + background subtraction)."""
    import numpy as np
    import qups_jax as q

    c0, fc = 1500.0, 2e6
    lam = c0 / fc
    xdc = q.TransducerArray(numel=8, pitch=lam / 2, fc=fc)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=q.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=c0),
        scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                             z=np.linspace(1e-3, 6e-3, 8)), fs=4 * fc)
    h = lam / 6
    cgrd = q.ScanCartesian(x=np.arange(-3e-3, 3e-3, h), y=[0.0],
                           z=np.arange(-0.5e-3, 6.5e-3, h))
    # field snapshots carry a propagating wave
    med0 = q.Medium(c0=c0, rho0=1000.0)
    chd, fields = us.kspaceFirstOrder(med0, cgrd, record="field",
                                      field_stride=10, tmax=6e-6)
    assert fields.ndim == 4 and fields.shape[0] == 1  # (M, nsnap, Nz, Nx)
    assert fields.shape[2:] == (cgrd.nz, cgrd.nx)
    assert np.isfinite(fields).all()
    # later snapshots reach deeper rows than early ones (propagation)
    early, late = fields[0, 1], fields[0, -1]
    deep = slice(2 * fields.shape[2] // 3, None)
    assert np.abs(late[deep]).max() > 10 * np.abs(early[deep]).max()

    # homogeneous medium: background subtraction cancels exactly
    chd_bg = us.kspaceFirstOrder(med0, cgrd, bg_subtract=True, tmax=6e-6)
    ref = us.kspaceFirstOrder(med0, cgrd, tmax=6e-6)
    assert np.abs(np.asarray(chd_bg.data)).max() \
        < 1e-6 * np.abs(np.asarray(ref.data)).max()

    # scatterer: subtraction keeps the echo, removes the direct wave
    z_t = 4e-3
    blob = lambda P: (np.hypot(P[0], P[2] - z_t) < lam / 4)  # noqa: E731
    med1 = q.Medium(c0=c0, rho0=1000.0, pertreg=((blob, {"rho": 2200.0}),))
    chd_s = us.kspaceFirstOrder(med1, cgrd, bg_subtract=True, tmax=8e-6)
    x = np.asarray(chd_s.data)[:, 4, 0]
    t = np.asarray(chd_s.time)[:, 0, 0]
    t_echo = 2 * z_t / c0
    sel = (t > 0.75 * t_echo) & (t < 1.4 * t_echo)
    t_pk = t[sel][np.abs(x[sel]).argmax()]
    assert abs(t_pk - t_echo) < 10 * h / c0, (t_pk, t_echo)
    # direct-transmit residue (before half the echo time) is small relative
    # to the retained echo
    direct = np.abs(x[t < 0.4 * t_echo]).max()
    assert direct < 0.5 * np.abs(x[sel]).max()


def test_kspace_linear_element_projection():
    """el_proj='linear' distributes elements over nodes; TOF matches the
    nearest-node projection within a couple samples."""
    import numpy as np
    import qups_jax as q

    C0 = 1500.0
    xdc = q.TransducerArray(numel=8, pitch=0.5e-3, fc=1.5e6)
    seq = q.Sequence(type="PW", focus=np.array([[0.0], [0.0], [1.0]]), c0=C0)
    scan = q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8), y=[0.0],
                           z=np.linspace(2e-3, 8e-3, 8))
    med = q.Medium(c0=C0, rho0=1000.0)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=6e6)
    # scatter off a small dense inclusion
    med = q.Medium(c0=C0, rho0=1000.0).with_region(
        lambda P: np.hypot(P[0], P[2] - 5e-3) < 0.4e-3, {"rho": 2500.0}) \
        if hasattr(q.Medium, "with_region") else med
    chd_n = us.kspaceFirstOrder(med, el_proj="nearest", tmax=1.2e-5)
    chd_l = us.kspaceFirstOrder(med, el_proj="linear", tmax=1.2e-5)
    assert chd_l.data.shape == chd_n.data.shape
    xn = np.asarray(chd_n.data)[:, 4, 0]
    xl = np.asarray(chd_l.data)[:, 4, 0]
    if np.abs(xn).max() > 0 and np.abs(xl).max() > 0:
        pn = int(np.argmax(np.abs(xn)))
        plm = int(np.argmax(np.abs(xl)))
        assert abs(pn - plm) <= 2, (pn, plm)


def test_kspace_karray_projection_convex_tof():
    """el_proj='karray' (kWaveArray-class band-limited off-grid
    projection, VERDICT r2 #6): a CONVEX probe — whose curved, off-grid
    elements suffer most from node snapping — produces a pulse-echo at
    the analytic time of flight."""
    c0 = 1500.0
    fc = 2e6
    lam = c0 / fc
    xdc = q.TransducerConvex.from_pitch(lam / 2, 15e-3, numel=16, fc=fc)
    z_t = 7e-3
    scan = q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 9),
                           z=np.linspace(3e-3, 10e-3, 9))
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=q.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=c0),
        scan=scan, fs=4 * fc)

    def blob(P):
        return (np.hypot(P[0], P[2] - z_t) < lam / 4)
    med = q.Medium(c0=c0, rho0=1000.0, pertreg=((blob, {"rho": 2000.0}),))
    cgrd = q.ScanCartesian(x=np.arange(-5e-3, 5e-3, lam / 6), y=[0.0],
                           z=np.arange(-1.5e-3, 10.5e-3, lam / 6))
    chd = us.kspaceFirstOrder(med, cgrd, el_proj="karray", tmax=1.4e-5)
    # center element's echo: analytic two-way path from its position
    pe = xdc.positions()[:, 8]
    d = np.hypot(pe[0] - 0.0, pe[2] - z_t)
    # tx is a c0-referenced plane wave from the aperture plane: use the
    # element's own round trip as the expected arrival (PW delay ~ 0 at
    # the apex for a convex probe steered straight ahead)
    t_echo = (z_t - pe[2] + d) / c0
    x = np.asarray(chd.data)[:, 8, 0]
    t = np.asarray(chd.time)[:, 0, 0]
    sel = t > 0.6 * t_echo
    i_pk = int(np.abs(x[sel]).argmax())
    t_pk = t[sel][i_pk]
    tol = 5 * (lam / 6) / c0  # tighter than the 10-step nearest tolerance
    assert abs(t_pk - t_echo) < tol, (t_pk, t_echo, tol)


def test_kspace_1d_tof_and_reflection():
    """1-D PSTD (kspaceFirstOrder1D analog): free-field TOF at c and a
    reflection off an impedance step arriving at the round-trip time."""
    from qups_jax.sim.fdtd import kspace_sim_1d
    c0, h = 1500.0, 0.2e-3
    N, steps = 512, 1900
    dt = 0.3 * h / c0
    fc = 2e6
    t = np.arange(steps) * dt
    sig = (np.exp(-((t - 1e-6) * fc * 2) ** 2)
           * np.sin(2 * np.pi * fc * t))[:, None].astype(np.float32)
    cmap = np.full(N, c0); rho = np.full(N, 1000.0)
    rec = np.asarray(kspace_sim_1d(cmap, rho, np.array([40]), sig,
                                   steps=steps, dt=dt, dx=h, c_ref=c0,
                                   record_rows=(240,)))
    t_pk = t[np.abs(rec[:, 0]).argmax()]
    want = 200 * h / c0 + 1e-6
    assert abs(t_pk - want) < 4 * dt, (t_pk, want)
    # impedance step at cell 300: echo back at the source-side probe
    rho2 = rho.copy(); rho2[300:] = 3000.0  # step at cell 300
    rec2 = np.asarray(kspace_sim_1d(cmap, rho2, np.array([40]), sig,
                                    steps=steps, dt=dt, dx=h, c_ref=c0,
                                    record_rows=(60,)))
    tr = rec2[:, 0]
    t_ref = (260 + 240) * h / c0 + 1e-6  # 40->300->60 path (66.7 us)
    sel = t > 0.7 * t_ref
    t_echo = t[sel][np.abs(tr[sel]).argmax()]
    assert abs(t_echo - t_ref) < 6 * dt, (t_echo, t_ref)
