"""Simulator physics oracles — port of the reference's ``test/SimTest.m``
strategy: each simulator must place the echo peak at the analytic
time-of-flight, within 1.1 samples (``SimTest.m:299-324``).
"""
import numpy as np
import pytest

import qups_jax as q


def make_us(seq=None, numel=16, fc=3e6):
    xdc = q.TransducerArray(numel=numel, pitch=0.3e-3, fc=fc)
    seq = seq or q.Sequence(type="FSA", numpulse=numel, c0=1540.0)
    scan = q.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 32),
                           z=np.linspace(25e-3, 35e-3, 32))
    return q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=12e6)


def test_greens_fsa_time_of_flight():
    us = make_us()
    scat = q.Scatterers(pos=[[0.0], [0.0], [30e-3]], c0=1540.0)
    chd = us.greens(scat)
    assert (chd.N, chd.M) == (16, 16)
    x = np.asarray(chd.data)
    t0 = float(np.asarray(chd.t0).reshape(-1)[0])
    p = us.rx.positions()
    ps = scat.pos[:, 0]
    r = np.linalg.norm(p - ps[:, None], axis=0)  # (N,)
    for n in [0, 8, 15]:
        for m in [0, 8, 15]:
            tau = (r[n] + r[m]) / 1540.0
            i_pk = int(np.abs(x[:, n, m]).argmax())
            t_pk = t0 + i_pk / chd.fs
            assert abs(t_pk - tau) * chd.fs < 1.1, (n, m, t_pk, tau)


def test_greens_splat_matches_dense():
    us = make_us(numel=8)
    scat = q.Scatterers(pos=[[1e-3, -2e-3], [0, 0], [28e-3, 31e-3]], c0=1540.0)
    chd_s = us.greens(scat, impl="splat")
    chd_d = us.greens(scat, impl="dense")
    xs = np.asarray(chd_s.data)
    xd = np.asarray(chd_d.data)
    assert xs.shape == xd.shape
    scale = np.abs(xd).max()
    assert np.abs(xs - xd).max() / scale < 1e-3


def test_greens_freq_matches_dense():
    """system.greens impl='freq' (the GEMM path) vs the dense oracle:
    exact fractional delays vs cubic interp — agree to interp error."""
    # fc = fs/6: narrow enough band that cubic interp ~= the band-limited
    # semantics of the freq path (at fs/4 pulses the two legitimately
    # diverge by >10% — see tests/test_greens_freq.py for the exact
    # band-limited oracle)
    us = make_us(numel=8, fc=2e6)
    scat = q.Scatterers(pos=[[1e-3, -2e-3], [0, 0], [28e-3, 31e-3]], c0=1540.0)
    chd_f = us.greens(scat, impl="freq")
    chd_d = us.greens(scat, impl="dense")
    xf = np.asarray(chd_f.data)
    xd = np.asarray(chd_d.data)
    assert xf.shape == xd.shape
    assert np.allclose(np.asarray(chd_f.t0), np.asarray(chd_d.t0))
    scale = np.abs(xd).max()
    assert np.abs(xf - xd).max() / scale < 5e-2  # cubic-vs-bandlimited
    # envelope peaks within a sample on the strongest trace
    n, m = np.unravel_index(np.abs(xd).max(0).argmax(), xd.shape[1:])
    assert abs(int(np.abs(xf[:, n, m]).argmax())
               - int(np.abs(xd[:, n, m]).argmax())) <= 1


def test_greens_amplitude_propagation_loss():
    # double the distance -> half the (one-way)^2 amplitude
    us = make_us(numel=4)
    a = []
    for z in (20e-3, 40e-3):
        scat = q.Scatterers(pos=[[0.0], [0.0], [z]], c0=1540.0)
        chd = us.greens(scat)
        a.append(np.abs(np.asarray(chd.data)[:, 1, 1]).max())
    ratio = a[0] / a[1]
    assert 2.5 < ratio < 6.0  # ~ (40/20)^2 = 4 with aperture-angle effects


def test_greens_pw_focus_tx():
    # plane-wave synthesis: peak time for a scatterer on axis at depth z is
    # (z*cos(theta) + x*sin(theta) + r_rx)/c0 for steering angle theta
    th = 5.0
    seq = q.SequenceRadial(type="PW", angles=[0.0, th], c0=1540.0)
    # wide aperture so the stationary point lies inside it
    us = make_us(seq=seq, numel=64)
    z = 30e-3
    scat = q.Scatterers(pos=[[0.0], [0.0], [z]], c0=1540.0)
    chd = us.greens(scat)
    assert chd.M == 2
    x = np.asarray(chd.data)
    t0 = float(np.asarray(chd.t0).reshape(-1)[0])
    p = us.rx.positions()
    r_rx = np.linalg.norm(p - scat.pos[:, :1], axis=0)
    n = 32
    for m, ang in enumerate([0.0, th]):
        tau = (z * np.cos(np.radians(ang))) / 1540.0 + r_rx[n] / 1540.0
        i_pk = int(np.abs(x[:, n, m]).argmax())
        t_pk = t0 + i_pk / chd.fs
        assert abs(t_pk - tau) * chd.fs < 1.5, (m, t_pk, tau)


def test_greens_fc_time_zero_at_focus():
    # focused sequence: t=0 when the wavefront passes the focus, so an echo
    # from a scatterer AT the focus peaks at t = |p_f - p_rx|/c0
    pf = np.array([[0.0], [0.0], [30e-3]])
    seq = q.Sequence(type="FC", focus=pf, c0=1540.0)
    us = make_us(seq=seq)
    scat = q.Scatterers(pos=pf, c0=1540.0)
    chd = us.greens(scat)
    x = np.asarray(chd.data)
    t0 = float(np.asarray(chd.t0).reshape(-1)[0])
    p = us.rx.positions()
    r_rx = np.linalg.norm(p - pf, axis=0)
    n = 8
    tau = r_rx[n] / 1540.0
    i_pk = int(np.abs(x[:, n, 0]).argmax())
    t_pk = t0 + i_pk / chd.fs
    assert abs(t_pk - tau) * chd.fs < 1.5


def test_greens_subelements_smoke():
    us = make_us(numel=4)
    scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
    chd = us.greens(scat, element_subdivisions=(2, 2))
    assert np.isfinite(np.abs(np.asarray(chd.data))).all()
    assert np.abs(np.asarray(chd.data)).max() > 0


def test_calc_hp_focal_gain():
    """Transmit pressure map: an FC transmit concentrates pressure at the
    focus (calc_hp analog of UltrasoundSystem.m:2083-2456)."""
    C0 = 1540.0
    xdc = q.TransducerArray(numel=32, pitch=0.3e-3, fc=5e6)
    focus = np.array([[0.0], [0.0], [15e-3]])
    seq = q.Sequence(type="FC", focus=focus, c0=C0)
    scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 33), y=[0.0],
                           z=np.linspace(5e-3, 25e-3, 41))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=40e6)
    pm = us.calc_hp()  # (I1, I2, I3, 1)
    assert pm.shape == tuple(scan.shape) + (1,)
    pm2 = pm[..., 0].squeeze()
    ij = np.unravel_index(np.argmax(pm2), pm2.shape)
    # scan order ZXY: axis0 = z, axis1 = x
    zpk = scan.z[ij[0]]
    xpk = scan.x[ij[1]]
    err = np.hypot(xpk - 0.0, zpk - 15e-3)
    assert err < 1.1e-3, (xpk, zpk)
    # focal gain: peak well above the lateral edge at the focal depth
    iz = np.argmin(np.abs(scan.z - 15e-3))
    assert pm2[iz, len(scan.x) // 2] > 3 * pm2[iz, 0]


def test_calc_hp_pw_uniformity():
    """A plane-wave transmit is laterally uniform away from the aperture
    edges."""
    C0 = 1540.0
    xdc = q.TransducerArray(numel=48, pitch=0.3e-3, fc=5e6)
    seq = q.Sequence(type="PW", focus=np.array([[0.0], [0.0], [1.0]]), c0=C0)
    scan = q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 25), y=[0.0],
                           z=np.linspace(8e-3, 12e-3, 9))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=40e6)
    pm = us.calc_hp()[..., 0].squeeze()  # (nz, nx)
    mid = pm[4]  # central depth row
    assert mid.std() / mid.mean() < 0.2


def test_simus_sparse_bins_split_runs():
    """Multi-lobe bin selections split into contiguous GEMM runs; the
    result equals the single-hull evaluation (dead-band bins carry zero
    spectrum either way)."""
    from qups_jax.ops.simus import _bin_runs, simus_fsa
    # run splitting itself
    assert _bin_runs(np.array([3, 4, 5]), merge_gap=4) == [(3, 6)]
    assert _bin_runs(np.array([3, 4, 200, 202]), merge_gap=4) == \
        [(3, 5), (200, 203)]
    rng = np.random.default_rng(7)
    S, N, E, T, fs, c0 = 5, 4, 3, 256, 10e6, 1540.0
    ps = np.stack([rng.uniform(-2e-3, 2e-3, S), np.zeros(S),
                   rng.uniform(8e-3, 12e-3, S)], -1).astype(np.float32)
    amp = np.ones(S, np.float32)
    pn = np.stack([np.linspace(-2e-3, 2e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    pv = pn[:E].copy()
    az = np.zeros(N, np.float32)
    bins = np.array([10, 11, 12, 90, 91], np.int32)  # two lobes
    spec = (rng.standard_normal(5) + 1j * rng.standard_normal(5)
            ).astype(np.complex64)
    kw = dict(T=T, fs=fs, c0=c0)
    split = np.asarray(simus_fsa(ps, amp, pn, az, pv, az[:E],
                                 np.array([0.3e-3, 0.3e-3]), spec, bins,
                                 **kw))
    # same selection padded with explicit zero bins bridging the gap ->
    # one hull; results must agree
    allb = np.arange(10, 92, dtype=np.int32)
    spec_all = np.zeros(allb.size, np.complex64)
    spec_all[np.searchsorted(allb, bins)] = spec
    hull = np.asarray(simus_fsa(ps, amp, pn, az, pv, az[:E],
                                np.array([0.3e-3, 0.3e-3]), spec_all, allb,
                                **kw))
    np.testing.assert_allclose(split, hull, atol=2e-5 * np.abs(hull).max())


def simus_oracle(ps, amp, pn, az_n, pv, az_e, widths, spec, bins, *, T,
                 fs, c0, baffle="soft", alpha0=0.0):
    """Float64 direct sum of the simus model: per bin f,
    X(f; n, e) = P(f) sum_s a_s D_rx D_tx e^{-2i pi f (r_rx + r_tx) / c0}
    e^{-a(f) (r_rx + r_tx)} / (r_rx r_tx), D = sinc(w f sin(th) / c0)
    [max(cos(th), 0) under the soft baffle]; real traces by irfft."""
    from qups_jax.ops.greens_freq import alpha_np_per_bin

    def geom(pe, az):
        d = ps[:, None, :].astype(np.float64) - pe[None].astype(np.float64)
        r = np.linalg.norm(d, axis=-1)
        lat = d[..., 0] * np.cos(az) - d[..., 2] * np.sin(az)
        ax = d[..., 2] * np.cos(az) + d[..., 0] * np.sin(az)
        return np.maximum(r, 1e-6), lat / r, ax / r

    r_rx, s_rx, c_rx = geom(pn, az_n)
    r_tx, s_tx, c_tx = geom(pv, az_e)
    full = np.zeros((T // 2 + 1, pn.shape[0], pv.shape[0]), np.complex128)
    att = alpha_np_per_bin(alpha0, fs, T)
    for b, p in zip(bins, spec):
        f = b * fs / T
        legs = []
        for r, st, ct, w in ((r_rx, s_rx, c_rx, widths[1]),
                             (r_tx, s_tx, c_tx, widths[0])):
            D = np.sinc(w * f * st / c0)
            if baffle == "soft":
                D = D * np.maximum(ct, 0.0)
            legs.append(D / r * np.exp(-2j * np.pi * f * r / c0
                                       - att * b * r))
        full[b] = p * np.einsum("sn,s,se->ne", legs[0], amp, legs[1])
    return np.fft.irfft(full, n=T, axis=0)


def _simus_problem(seed, S, N, E, alpha0=0.0):
    rng = np.random.default_rng(seed)
    ps = np.stack([rng.uniform(-2e-3, 2e-3, S), np.zeros(S),
                   rng.uniform(8e-3, 12e-3, S)], -1).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, S).astype(np.float32)
    pn = np.stack([np.linspace(-2e-3, 2e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    pv = pn[:E].copy()
    az = np.radians(np.linspace(-4, 4, N)).astype(np.float32)
    bins = np.arange(12, 40, dtype=np.int32)
    spec = (rng.standard_normal(bins.size)
            + 1j * rng.standard_normal(bins.size)).astype(np.complex64)
    return ps, amp, pn, az, pv, az[:E], spec, bins


def test_simus_attenuation_vs_numpy():
    """simus alpha0 absorption (the in-recurrence decay with the sinc
    directivity) vs the float64 direct sum."""
    from qups_jax.ops.simus import simus_fsa
    ps, amp, pn, azn, pv, aze, spec, bins = _simus_problem(7, 5, 4, 3)
    widths = np.array([0.3e-3, 0.3e-3])
    kw = dict(T=256, fs=10e6, c0=1540.0, alpha0=1.0)
    want = simus_oracle(ps, amp, pn, azn, pv, aze, widths, spec, bins, **kw)
    got = np.asarray(simus_fsa(ps, amp, pn, azn, pv, aze, widths, spec,
                               bins, **kw))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-4, rel


@pytest.mark.parametrize("baffle", ["soft", "hard"])
def test_simus_engine_vs_numpy(baffle):
    """The per-bin phasor + sinc-directivity GEMM engine vs the float64
    direct sum, with tilted elements, soft and hard baffles."""
    from qups_jax.ops.simus import simus_fsa
    ps, amp, pn, azn, pv, aze, spec, bins = _simus_problem(11, 9, 5, 3)
    widths = np.array([0.25e-3, 0.25e-3])
    kw = dict(T=256, fs=10e6, c0=1540.0, baffle=baffle)
    want = simus_oracle(ps, amp, pn, azn, pv, aze, widths, spec, bins, **kw)
    got = np.asarray(simus_fsa(ps, amp, pn, azn, pv, aze, widths, spec,
                               bins, **kw))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-4, rel


def test_simus_tof_oracle():
    """Native frequency-domain simulator: echo peak at the analytic
    time-of-flight within 1 wavelength (the SimTest SIMUS tolerance,
    ``test/SimTest.m:313``)."""
    C0 = 1540.0
    z_t = 15.4e-3  # TOF = 2*z/c = 20 us for FSA center element
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=5e6)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc,
                            seq=q.Sequence(type="FSA", numpulse=16, c0=C0),
                            scan=q.ScanCartesian(), fs=25e6)
    scat = q.Scatterers(pos=np.array([[0.0], [0.0], [z_t]]), c0=C0)
    chd = us.simus(scat)
    n = 8  # center element
    x = np.asarray(chd.data)[:, n, n]
    env = np.abs(x) + np.abs(np.imag(np.fft.ifft(
        np.fft.fft(x) * (np.fft.fftfreq(x.size) > 0) * 2)))
    t = np.asarray(chd.time).reshape(-1)
    # envelope peak via analytic signal
    xa = np.abs(x)
    t_pk = t[np.argmax(xa)]
    t_exp = 2 * z_t / C0
    lam = C0 / xdc.fc
    assert abs(t_pk - t_exp) < lam / C0 * 1.5, (t_pk, t_exp)


def test_simus_matches_greens_peak():
    """simus and greens agree on echo timing and rough relative level."""
    C0 = 1540.0
    xdc = q.TransducerArray(numel=8, pitch=0.4e-3, fc=4e6)
    seq = q.Sequence(type="FSA", numpulse=8, c0=C0)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq,
                            scan=q.ScanCartesian(), fs=20e6)
    scat = q.Scatterers(pos=np.array([[1e-3], [0.0], [12e-3]]), c0=C0)
    c1 = us.simus(scat)
    c2 = us.greens(scat)
    x1 = np.asarray(c1.data)[:, 4, 4]
    x2 = np.real(np.asarray(c2.data))[:, 4, 4]
    t1 = np.asarray(c1.time).reshape(-1)[np.argmax(np.abs(x1))]
    t2 = np.asarray(c2.time).reshape(-1)[np.argmax(np.abs(x2))]
    assert abs(t1 - t2) < 3 / us.fs, (t1, t2)


def test_simus_directivity():
    """Off-axis scatterers are attenuated by the element directivity
    (soft baffle) relative to on-axis at equal range."""
    C0 = 1540.0
    xdc = q.TransducerArray(numel=1, pitch=1e-3, fc=5e6, width=0.95e-3)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc,
                            seq=q.Sequence(type="FSA", numpulse=1, c0=C0),
                            scan=q.ScanCartesian(), fs=25e6)
    r = 10e-3
    th = np.radians(50.0)
    on = q.Scatterers(pos=np.array([[0.0], [0.0], [r]]), c0=C0)
    off = q.Scatterers(pos=np.array([[r * np.sin(th)], [0.0],
                                     [r * np.cos(th)]]), c0=C0)
    a_on = np.abs(np.asarray(us.simus(on).data)).max()
    a_off = np.abs(np.asarray(us.simus(off).data)).max()
    assert a_off < 0.6 * a_on, (a_on, a_off)


def test_calc_scat_all_is_greens():
    """calc_scat_all (FieldII API parity) == greens: one FSA sim then
    focusTx (``UltrasoundSystem.m:1668-1804``)."""
    us = make_us(numel=8)
    scat = q.Scatterers(pos=[[1e-3], [0.0], [28e-3]], c0=1540.0)
    a = np.asarray(us.calc_scat_all(scat, impl="splat").data)
    b = np.asarray(us.greens(scat, impl="splat").data)
    np.testing.assert_allclose(a, b)


def test_calc_scat_multi_blocked_matches_unblocked():
    """calc_scat_multi per-transmit blocks (bsize) reproduce the fused
    result exactly — shared focus plan, common t0/pad
    (``UltrasoundSystem.m:1805-2082``)."""
    th = np.radians([-5.0, 0.0, 5.0, 10.0])
    pw = q.Sequence(type="PW",
                    focus=np.stack([np.sin(th), 0 * th, np.cos(th)]),
                    c0=1540.0)
    us = make_us(seq=pw, numel=8)
    scat = q.Scatterers(pos=[[1e-3, -2e-3], [0, 0], [28e-3, 31e-3]],
                        c0=1540.0)
    full = us.calc_scat_multi(scat, impl="splat")
    blk = us.calc_scat_multi(scat, impl="splat", bsize=1)
    assert blk.data.shape == full.data.shape == (full.T, 8, 4)
    t0f = np.asarray(full.t0, np.float64).reshape(-1)
    t0b = np.asarray(blk.t0, np.float64).reshape(-1)
    np.testing.assert_allclose(t0b, t0f)
    np.testing.assert_allclose(np.asarray(blk.data),
                               np.asarray(full.data), rtol=0, atol=1e-6)
