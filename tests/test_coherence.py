"""Coherence-imaging op tests (KernTest aperture-reduction coverage,
``test/KernTest.m:220-275``): each op vs a naive loop / analytic limits."""
import numpy as np
import pytest

from qups_jax.ops import cohfac, slsc, dmas, pcf, pwznxcorr

RNG = np.random.default_rng(11)


def test_cohfac_limits():
    # perfectly coherent -> 1; random phases -> ~1/N
    N = 64
    b = np.ones((100, N), np.complex64)
    r = np.asarray(cohfac(b, axis=1))
    assert np.allclose(r, 1.0, atol=1e-6)
    b2 = np.exp(2j * np.pi * RNG.uniform(size=(2000, N))).astype(np.complex64)
    r2 = np.asarray(cohfac(b2, axis=1))
    assert abs(r2.mean() - 1 / N) < 3 / N


def test_cohfac_naive():
    b = (RNG.standard_normal((10, 8)) + 1j * RNG.standard_normal((10, 8))).astype(np.complex64)
    r = np.asarray(cohfac(b, axis=1))
    want = np.abs(b.sum(1)) ** 2 / (np.abs(b) ** 2).sum(1) / 8
    assert np.allclose(r, want, atol=1e-5)


def test_slsc_average_naive():
    A, L = 8, 3
    x = (RNG.standard_normal((16, A)) + 1j * RNG.standard_normal((16, A))).astype(np.complex64)
    z = np.asarray(slsc(x, axis=1, lags=L, method="average"))
    # naive: normalize per sample, sum both directions over lag pairs
    xn = x / np.abs(x)
    want = np.zeros(16, np.complex128)
    for l in range(1, L + 1):
        w = 1 / (A - l) / 2 / L
        c = (np.conj(xn[:, : A - l]) * xn[:, l:]).sum(1)
        want += w * (c + np.conj(c))
    assert np.allclose(np.real(z), np.real(want), atol=1e-4)


def test_slsc_coherent_is_one():
    # fully coherent aperture signal: slsc -> 1 (sum of weights)
    A = 16
    x = np.tile(np.exp(1j * 0.3) * np.ones((1, A), np.complex64), (5, 1))
    z = np.asarray(slsc(x, axis=1, lags=4))
    assert np.allclose(np.real(z), 1.0, atol=1e-5)


def test_dmas_naive():
    N = 8
    x = RNG.standard_normal((12, N)).astype(np.float32)
    b = np.asarray(dmas(x, axis=1))
    want = np.zeros(12)
    for l in range(1, N):
        want += (x[:, : N - l] * x[:, l:]).sum(1)
    want = np.sign(want) * np.sqrt(np.abs(want))
    assert np.allclose(b, want, atol=1e-4)


def test_dmas_complex_phase_preserved():
    N = 8
    x = (RNG.standard_normal((12, N)) + 1j * RNG.standard_normal((12, N))).astype(np.complex64)
    b = np.asarray(dmas(x, axis=1))
    raw = np.zeros(12, np.complex128)
    for l in range(1, N):
        raw += (x[:, : N - l] * x[:, l:]).sum(1)
    assert np.allclose(np.angle(b), np.angle(raw), atol=1e-4)
    assert np.allclose(np.abs(b), np.sqrt(np.abs(raw)), atol=1e-4)


def test_pcf_limits():
    N = 32
    b = np.exp(1j * 0.7) * np.ones((50, N), np.complex64)
    w = np.asarray(pcf(b, axis=1))
    assert np.allclose(w, 1.0, atol=1e-5)  # zero phase spread -> 1
    b2 = np.exp(2j * np.pi * RNG.uniform(size=(500, N))).astype(np.complex64)
    w2 = np.asarray(pcf(b2, axis=1))
    assert w2.mean() < 0.2  # fully random phase -> ~0


def test_pwznxcorr_detects_shift():
    # channel 2 is channel 1 delayed by 3 samples: peak correlation at lag 3
    T = 256
    sig = RNG.standard_normal(T + 16).astype(np.float32)
    x = np.zeros((T, 2), np.float32)
    x[:, 0] = sig[8:8 + T]
    x[:, 1] = sig[5:5 + T]  # x1(t) = x0(t - 3)
    lags = list(range(-5, 6))
    y = np.asarray(pwznxcorr(x, lags, W=32))
    # y: (T, 1, L); the argmax lag across the middle should be +3... sign per
    # our convention: xr shifted by -l matches when l = -3 or +3
    mid = y[T // 2, 0]
    best = lags[int(np.argmax(mid))]
    assert abs(best) == 3
    assert mid.max() > 0.95


@pytest.mark.full
def test_coherence_image_mesh_matches_fallback():
    """system.coherence_image: the in-mesh reduction (explicit mesh, the
    rx band reduced on its device) matches the single-device
    DAS(keep_rx) + reduction, for cohfac and slsc."""
    import jax
    import qups_jax as q
    from qups_jax.parallel import make_mesh

    xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=8),
        scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                             z=np.linspace(18e-3, 22e-3, 8)),
        fs=12e6)
    scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
    chd = us.greens(scat)
    mesh = make_mesh(jax.devices()[:2], axes=("rx", "tx"))
    for post, lags in (("cohfac", None), ("slsc", 2)):
        ref = np.asarray(us.coherence_image(chd, post=post, lags=lags))
        got = np.asarray(us.coherence_image(chd, post=post, lags=lags,
                                            mesh=mesh))
        assert ref.shape == got.shape == us.scan.shape
        scale = max(np.abs(ref).max(), 1e-12)
        assert np.abs(got - ref).max() / scale < 5e-3, (post, np.abs(
            got - ref).max() / scale)


def test_coherence_image_mesh_fused_apod():
    """coherence_image(mesh=) takes Fused apodization on any platform and
    agrees with the single-device path, which materializes it."""
    import jax
    import qups_jax as q
    from qups_jax.parallel import make_mesh

    xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=8),
        scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                             z=np.linspace(18e-3, 22e-3, 8)),
        fs=12e6)
    chd = us.greens(q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0))
    apod = q.Fused("aperture_growth", f=1.0)
    mesh = make_mesh(jax.devices()[:2], axes=("rx", "tx"))
    ref = np.asarray(us.coherence_image(chd, apod=apod))
    got = np.asarray(us.coherence_image(chd, apod=apod, mesh=mesh))
    assert ref.shape == got.shape == us.scan.shape
    assert np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12) < 5e-3
