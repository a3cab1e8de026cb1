"""Beamformer physics oracles — port of the reference's ``test/BFTest.m``
strategy: simulate a point target with ``greens``, beamform, and assert the
image peak falls within 1.1 mm of the target laterally and axially
(``BFTest.m:294-316``).
"""
import numpy as np
import pytest

import qups_jax as q

C0 = 1540.0
TARGET = np.array([0.0, 0.0, 30e-3])
TOL = 1.1e-3  # meters


def make_us(seq):
    xdc = q.TransducerArray(numel=32, pitch=0.3e-3, fc=3e6)
    scan = q.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 51),
                           z=np.linspace(25e-3, 35e-3, 51))
    return q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=24e6)


def seqs():
    pf = TARGET.reshape(3, 1)
    return {
        "FSA": q.Sequence(type="FSA", numpulse=32, c0=C0),
        "PW": q.SequenceRadial(type="PW", angles=[-10, -5, 0, 5, 10], c0=C0),
        "FC": q.Sequence(
            type="FC",
            focus=pf + np.array([[1.5e-3 * i, 0.0, 0.0] for i in range(-2, 3)]).T,
            c0=C0),
    }


def peak_pos(us, b):
    """Position of the image peak (meters)."""
    bm = np.abs(np.asarray(b)).squeeze()
    assert bm.ndim == 2
    i, j = np.unravel_index(np.argmax(bm), bm.shape)
    P = us.scan.positions()  # (3, I1, I2, I3)
    return P[:, i, j, 0]


@pytest.fixture(scope="module")
def sims():
    out = {}
    for name, seq in seqs().items():
        us = make_us(seq)
        scat = q.Scatterers(pos=TARGET.reshape(3, 1), c0=C0)
        out[name] = (us, us.greens(scat))
    return out


@pytest.mark.parametrize("seqname", ["FSA", "PW", "FC"])
def test_das_psf(sims, seqname):
    us, chd = sims[seqname]
    b = us.DAS(chd)
    assert b.shape[:3] == us.scan.shape
    p = peak_pos(us, b)
    assert abs(p[0] - TARGET[0]) < TOL, p
    assert abs(p[2] - TARGET[2]) < TOL, p


@pytest.mark.parametrize("seqname", ["FSA", "PW", "FC"])
def test_bfdas_psf(sims, seqname):
    us, chd = sims[seqname]
    b = us.bfDAS(chd)
    p = peak_pos(us, b)
    assert abs(p[0] - TARGET[0]) < TOL, p
    assert abs(p[2] - TARGET[2]) < TOL, p


def test_das_equals_bfdas(sims):
    # DAS (fused geometry) and bfDAS (LUT path) agree to float tolerance
    us, chd = sims["PW"]
    b1 = np.asarray(us.DAS(chd)).squeeze()
    b2 = np.asarray(us.bfDAS(chd)).squeeze()
    scale = np.abs(b1).max()
    assert np.abs(b1 - b2).max() / scale < 1e-3


def test_das_keep_dims(sims):
    us, chd = sims["PW"]
    b = us.DAS(chd, keep_rx=True)
    assert b.shape == us.scan.shape + (chd.N, 1)
    b2 = us.DAS(chd, keep_tx=True)
    assert b2.shape == us.scan.shape + (1, chd.M)
    # summing the kept axes reproduces the summed image
    b0 = np.asarray(us.DAS(chd)).squeeze()
    tol = 1e-5 * np.abs(b0).max()
    assert np.allclose(np.asarray(b).squeeze().sum(-1), b0, atol=tol)
    assert np.allclose(np.asarray(b2).squeeze().sum(-1), b0, atol=tol)


def test_das_bsize_streaming(sims):
    """Out-of-core tx streaming (bsize) matches the one-shot image exactly
    (summed, keep_tx concat, and with an apodization)
    (``UltrasoundSystem.m:3488`` bsize splicing / tall-array analog)."""
    us, chd = sims["FSA"]
    b0 = np.asarray(us.DAS(chd)).squeeze()
    b1 = np.asarray(us.DAS(chd, bsize=5)).squeeze()
    assert np.allclose(b1, b0, atol=1e-5 * np.abs(b0).max())
    # keep_tx: blocks concatenate on the tx axis
    k0 = np.asarray(us.DAS(chd, keep_tx=True))
    k1 = np.asarray(us.DAS(chd, keep_tx=True, bsize=7))
    assert k1.shape == k0.shape
    assert np.allclose(k1, k0, atol=1e-5 * np.abs(k0).max())
    # with a dense rx apodization (sliced per block on the tx axis)
    N, M = chd.N, chd.M
    ap = np.ones((1, 1, 1, N, M), np.float32)
    ap[..., N // 2:, ::2] = 0
    a0 = np.asarray(us.DAS(chd, apod=(ap,))).squeeze()
    a1 = np.asarray(us.DAS(chd, apod=(ap,), bsize=6)).squeeze()
    assert np.allclose(a1, a0, atol=1e-5 * np.abs(a0).max())


def test_das_iq_remodulation(sims):
    # downmix the data, beamform with fmod -> same PSF location
    us, chd = sims["PW"]
    fc = us.fc
    bb = chd.downmix(fc)
    b = us.DAS(bb, fmod=fc)
    p = peak_pos(us, b)
    assert abs(p[0] - TARGET[0]) < TOL
    assert abs(p[2] - TARGET[2]) < TOL


def test_das_apodization(sims):
    us, chd = sims["PW"]
    I = int(np.prod(us.scan.shape))
    N, M = chd.N, chd.M
    # rx-only apodization: keep half the aperture
    ap = np.ones((1, 1, 1, N, 1), np.float32)
    ap[..., N // 2:, :] = 0
    b = us.DAS(chd, apod=(ap,))
    b_manual = np.asarray(us.DAS(chd, keep_rx=True)).squeeze()[:, :, :N // 2].sum(-1)
    assert np.allclose(np.asarray(b).squeeze(), b_manual, atol=1e-2 * np.abs(b_manual).max())


def test_das_heterogeneous_c(sims):
    # per-pixel sound speed map (constant here) equals scalar c
    us, chd = sims["PW"]
    b1 = np.asarray(us.DAS(chd)).squeeze()
    cmap = np.full(us.scan.shape, C0, np.float32)
    b2 = np.asarray(us.DAS(chd, c0=cmap)).squeeze()
    assert np.allclose(b1, b2, atol=1e-4 * np.abs(b1).max())


def test_das_convex_polar():
    # convex probe on a polar scan: pixel-position-based beamforming is
    # grid-agnostic (SURVEY §7)
    xdc = q.TransducerConvex.from_pitch(0.5e-3, 40e-3, numel=32, fc=3e6)
    seq = q.Sequence(type="FSA", numpulse=32, c0=C0)
    scan = q.ScanPolar(origin=xdc.center, r=np.linalg.norm(xdc.center) + np.linspace(25e-3, 35e-3, 41),
                       a=np.linspace(-10, 10, 41))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=24e6)
    scat = q.Scatterers(pos=TARGET.reshape(3, 1), c0=C0)
    chd = us.greens(scat)
    b = us.DAS(chd)
    p = peak_pos(us, b)
    assert np.linalg.norm(p - TARGET) < TOL, p


def test_focus_tx_frame_dims():
    # regression (round-1 advisor): focusTx on ChannelData with frame dims
    # must keep F out of the synthesized-transmit broadcast
    import qups_jax as q
    rng = np.random.default_rng(3)
    numel, T, F = 8, 64, 3
    xdc = q.TransducerArray(numel=numel, pitch=0.5e-3, fc=5e6)
    seqf = q.Sequence(type="PW", focus=np.stack(
        [np.sin(np.radians([-5, 0, 5.0])), np.zeros(3),
         np.cos(np.radians([-5, 0, 5.0]))]), c0=1540.0)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seqf, fs=20e6)
    x = rng.standard_normal((T, numel, numel, F)).astype(np.float32)
    chd = q.ChannelData(data=x, fs=20e6, t0=0.0)
    out = us.focusTx(chd, seqf)
    assert out.data.shape[1] == numel and out.data.shape[2] == 3 \
        and out.data.shape[3] == F
    # per-frame equality against the single-frame path
    for f in range(F):
        chd1 = q.ChannelData(data=x[..., f], fs=20e6, t0=0.0)
        out1 = us.focusTx(chd1, seqf)
        assert np.allclose(np.asarray(out.data[..., f]),
                           np.asarray(out1.data), atol=1e-4)


def test_das_method_auto_resolves_to_cubic():
    """method='auto' (the default) must resolve to the reference default
    (cubic) on the XLA path, as in the kernel."""
    xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
    seq = q.Sequence(type="FSA", numpulse=8, c0=1540.0)
    scan = q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                           z=np.linspace(27e-3, 31e-3, 8))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=12e6)
    scat = q.Scatterers(pos=[[0.0], [0.0], [29e-3]], c0=1540.0)
    chd = us.greens(scat, impl="splat")
    a = np.asarray(us.DAS(chd))                   # method='auto'
    b = np.asarray(us.DAS(chd, method="cubic"))   # explicit reference default
    np.testing.assert_allclose(a, b)
    c = np.asarray(us.DAS(chd, method="linear"))
    assert np.abs(a - c).max() > 0  # and auto is NOT silently linear here


def test_focus_tx_freq_matches_cubic_bandlimited():
    """focusTx(method='freq') — the per-bin transmit GEMM — matches the
    time-domain cubic resample on band-limited data (it IS the exact
    band-limited interpolant; cubic is its 4-tap approximation)."""
    xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=8, c0=1540.0),
        scan=q.ScanCartesian(x=[0.0], z=[20e-3]), fs=24e6)
    scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
    chd = us.greens(scat)  # band-limited pulses (gaussian impulse at 3 MHz)
    pf = np.stack([np.linspace(-1e-3, 1e-3, 4), np.zeros(4),
                   np.full(4, 25e-3)])
    seq = q.Sequence(type="FC", focus=pf, c0=1540.0)
    a = np.asarray(us.focusTx(chd, seq, method="cubic").data)
    b = np.asarray(us.focusTx(chd, seq, method="freq").data)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / np.abs(a).max()
    assert err < 2e-2, err


def test_focus_tx_freq_blocked_matches():
    """calc_scat_multi's bsize blocks agree with the fused freq synthesis."""
    xdc = q.TransducerArray(numel=6, pitch=0.3e-3, fc=3e6)
    pf = np.stack([np.linspace(-1e-3, 1e-3, 4), np.zeros(4),
                   np.full(4, 25e-3)])
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FC", focus=pf, c0=1540.0),
        scan=q.ScanCartesian(x=[0.0], z=[20e-3]), fs=24e6)
    scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
    a = np.asarray(us.calc_scat_multi(scat, method="freq").data)
    b = np.asarray(us.calc_scat_multi(scat, method="freq", bsize=1).data)
    # blocked freq GEMMs differ from the fused one only by f32 reduction
    # order (the sample2sep path is bit-for-bit; GEMM shapes are not)
    assert np.abs(a - b).max() < 1e-5 * np.abs(a).max()


def test_per_pixel_c_lut_tables_match_das():
    """Per-pixel sound-speed DAS == LUT beamforming with tables
    tau = cinv_px * distance (heterogeneous c, ``kern/das_spec.m:169``)."""
    from qups_jax.ops.das import das, das_lut, tx_distance
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    T, N, M, I1, I2 = 256, 8, 3, 12, 16
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    xs = np.linspace(-3e-3, 3e-3, I2)
    zs = np.linspace(15e-3, 25e-3, I1)
    Z, X = np.meshgrid(zs, xs, indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()],
                  -1).astype(np.float32)
    pr = np.stack([np.linspace(-3e-3, 3e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    th = np.radians(np.linspace(-5, 5, M))
    pv = np.zeros((M, 3), np.float32)
    nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)],
                  -1).astype(np.float32)
    t0 = np.zeros(M, np.float32)
    cinv = (1.0 / rng.uniform(1400, 1600, pi.shape[0])).astype(np.float32)
    ref = np.asarray(das(x, pi, pr, pv, nv, t0, cinv[:, None], fs=8e6,
                         tx_model="plane", method="cubic"))
    dr = np.linalg.norm(pi[:, None, :] - pr[None], axis=-1)
    dv = np.asarray(jax.vmap(
        lambda p, n: tx_distance(jnp.asarray(pi), p, n, "plane"),
        in_axes=0, out_axes=1)(jnp.asarray(pv), jnp.asarray(nv)))
    got = np.asarray(das_lut(x, dr * cinv[:, None], dv * cinv[:, None], t0,
                             fs=8e6, method="cubic"))
    # f32 distributivity: cinv*(dv+dr) != cinv*dv + cinv*dr to the ulp
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_cubic2x_cubic_class_accuracy():
    """cubic2x (one band-limited 2x trace upsample + linear taps) must
    deliver cubic-CLASS accuracy: against a quasi-exact sinc reference
    (linear on 8x oversampled RF) its error stays within ~1.25x of true
    cubic's, while plain linear is ~4x worse (the lever that runs on the
    2x-faster packed-linear kernel; interpd.cu:89-113 half-rate analog)."""
    import qups_jax as q
    from qups_jax.ops.interp import fft_upsample

    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=5e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=16),
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 48),
                             z=np.linspace(17e-3, 23e-3, 48)), fs=25e6)
    scat = q.Scatterers(pos=[[1e-3], [0.0], [20e-3]], c0=1540.0)
    chd = us.greens(scat)
    chd8 = chd.replace(data=fft_upsample(chd.data, 8, axis=0),
                       fs=chd.fs * 8)
    R = np.asarray(us.DAS(chd8, method="linear")).squeeze()
    ref = np.abs(R).max()
    err = {m: np.abs(np.asarray(us.DAS(chd, method=m)).squeeze()
                     - R).max() / ref
           for m in ("linear", "cubic", "cubic2x")}
    assert err["cubic2x"] <= 1.25 * err["cubic"], err
    assert err["cubic2x"] <= 0.5 * err["linear"], err
    # PSF peak localization (BFTest oracle)
    b = np.abs(np.asarray(us.DAS(chd, method="cubic2x"))).squeeze()
    P = us.scan.positions().reshape(3, -1)
    k = int(b.reshape(-1).argmax())
    assert np.linalg.norm(P[:, k] - [1e-3, 0, 20e-3]) < 1.1e-3
    # the LUT route resolves cubic2x identically
    tau_rx, tau_tx = us.das_delay_tables()
    l2 = np.asarray(us.bfDASLUT(chd, tau_rx, tau_tx,
                                method="cubic2x")).squeeze()
    d2 = np.asarray(us.DAS(chd, method="cubic2x")).squeeze()
    assert np.abs(l2 - d2).max() <= 1e-4 * np.abs(d2).max()
