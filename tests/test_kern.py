"""Kernel parity tests — port of the reference's ``test/KernTest.m`` and
``test/interpTest.m`` strategy: each vectorized op is checked against a naive
loop implementation (the golden oracle), across dtypes and layouts.
"""
import numpy as np
import pytest

from qups_jax.ops import interp1, interpf, wsinterpd, wsinterpd2, convd, xcorr
from qups_jax.ops.conv import conv_len

RNG = np.random.default_rng(7)


def naive_interp1(x, tau, method):
    """Loop oracle for the samplers, clamped-edge + inclusive domain."""
    T = x.shape[0]
    out = np.zeros(tau.shape, dtype=x.dtype)
    flat = tau.ravel()
    res = []
    for t in flat:
        if not (0 <= t <= T - 1):
            res.append(0.0)
            continue
        i0 = int(np.floor(t))
        u = t - i0
        if method == "nearest":
            res.append(x[int(round(t))])
        elif method == "linear":
            i1 = min(i0 + 1, T - 1)
            res.append(x[i0] * (1 - u) + x[i1] * u)
        elif method == "cubic":
            s = [x[min(max(i0 + k, 0), T - 1)] for k in (-1, 0, 1, 2)]
            a = [0.5 * (u * (-1 + u * (2 - u))),
                 0.5 * (2 + u * u * (-5 + 3 * u)),
                 0.5 * (u * (1 + u * (4 - 3 * u))),
                 0.5 * (u * u * (u - 1))]
            res.append(sum(si * ai for si, ai in zip(s, a)))
        elif method == "lanczos3":
            def L(v):
                if v == 0:
                    return 1.0
                return 2 * np.sin(np.pi * v) * np.sin(np.pi * v / 2) / (np.pi * v) ** 2
            s = [x[min(max(i0 + k, 0), T - 1)] for k in (-1, 0, 1, 2)]
            a = [L(u + 1), L(u), L(u - 1), L(u - 2)]
            res.append(sum(si * ai for si, ai in zip(s, a)))
    return np.array(res).reshape(tau.shape)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic", "lanczos3"])
@pytest.mark.parametrize("cplx", [False, True])
def test_interp1_vs_naive(method, cplx):
    T = 32
    x = RNG.standard_normal(T)
    if cplx:
        x = x + 1j * RNG.standard_normal(T)
    x = x.astype(np.complex64 if cplx else np.float32)
    tau = np.concatenate([
        RNG.uniform(-2, T + 1, 64),           # includes OOB
        np.arange(T, dtype=float),            # exact integers
        [0.0, T - 1.0, -1e-2, T - 1 + 1e-2],  # edges (f32-representable)
    ])
    got = np.asarray(interp1(x, tau, method=method))
    want = naive_interp1(x, tau, method)
    assert np.allclose(got, want, atol=2e-5), np.abs(got - want).max()


def test_interp1_broadcast_batch():
    # x: (T, N, F); tau: (I, N, M) -> y: (I, N, M, F)  [left-aligned rules]
    T, N, M, F = 24, 3, 4, 2
    x = RNG.standard_normal((T, N, F)).astype(np.float32)
    tau = RNG.uniform(0, T - 1, (8, N, M)).astype(np.float32)
    # to broadcast (I,N,M) against (N,F) we need explicit layout: data
    # (T, N, 1, F), tau (I, N, M) -> out (I, N, M, F)
    y = np.asarray(interp1(x[:, :, None, :], tau))
    assert y.shape == (8, N, M, F)
    for n in range(N):
        for m in range(M):
            for f in range(F):
                want = naive_interp1(x[:, n, f], tau[:, n, m], "cubic")
                assert np.allclose(y[:, n, m, f], want, atol=2e-5)


def test_interp1_vector_tau():
    x = RNG.standard_normal((16, 3, 2)).astype(np.float32)
    y = np.asarray(interp1(x, np.arange(16.0)))
    assert y.shape == (16, 3, 2)
    assert np.allclose(y, x, atol=1e-6)


def test_wsinterpd_weighted_sum():
    # y = sum_n w[n] * x(tau[i,n]) — sum over the receive dim
    T, N = 32, 4
    x = RNG.standard_normal((T, N)).astype(np.float32)
    tau = RNG.uniform(0, T - 1, (8, N)).astype(np.float32)
    w = RNG.standard_normal(N).astype(np.float32)
    y = np.asarray(wsinterpd(x, tau, w=w[None, :], sdim=1, method="linear"))
    assert y.shape == (8, 1)
    want = np.zeros(8)
    for n in range(N):
        want += w[n] * naive_interp1(x[:, n], tau[:, n], "linear")
    assert np.allclose(y[:, 0], want, atol=1e-4)


def test_wsinterpd_omega_phase():
    T = 64
    x = (RNG.standard_normal(T) + 1j * RNG.standard_normal(T)).astype(np.complex64)
    tau = RNG.uniform(0, T - 1, 16)
    om = 0.3
    y = np.asarray(wsinterpd(x, tau, omega=om, method="linear"))
    base = naive_interp1(x, tau, "linear")
    assert np.allclose(y, np.exp(1j * om * tau) * base, atol=1e-4)


def test_wsinterpd2_separable():
    # tau = tau1 (I, 1, M) + tau2 (I, N) -> (I, N, M)
    T, N, M = 40, 3, 5
    x = RNG.standard_normal((T, N)).astype(np.float32)
    tau1 = RNG.uniform(0, 10, (8, 1, M)).astype(np.float32)
    tau2 = RNG.uniform(0, T - 12, (8, N)).astype(np.float32)
    y = np.asarray(wsinterpd2(x[:, :, None], tau1, tau2, method="cubic"))
    assert y.shape == (8, N, M)
    for n in range(N):
        for m in range(M):
            want = naive_interp1(x[:, n], tau1[:, 0, m] + tau2[:, n], "cubic")
            assert np.allclose(y[:, n, m], want, atol=1e-4)


def test_interpf_chunked_matches_dense():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 3)).astype(np.float32)
    tau = rng.uniform(0, 31, (37, 1)).astype(np.float32)
    dense = np.asarray(interpf(x, tau, chunk=0))
    chunked = np.asarray(interpf(x, tau, chunk=8))  # 37 -> 5 padded blocks
    np.testing.assert_allclose(chunked, dense, atol=1e-5)


def test_interpf_exact_on_bandlimited():
    # Fourier interpolation is exact for band-limited periodic signals
    T = 64
    t = np.arange(T)
    x = (np.cos(2 * np.pi * 3 * t / T) + 0.5 * np.sin(2 * np.pi * 7 * t / T)).astype(np.float32)
    tau = RNG.uniform(0, T - 1, 33)
    y = np.asarray(interpf(x, tau))
    want = np.cos(2 * np.pi * 3 * tau / T) + 0.5 * np.sin(2 * np.pi * 7 * tau / T)
    assert np.allclose(y, want, atol=1e-3)


# ------------------------------------------------------------------- convd
@pytest.mark.parametrize("shape", ["full", "same", "valid"])
@pytest.mark.parametrize("method", ["direct", "fft"])
@pytest.mark.parametrize("cplx", [False, True])
def test_convd_vs_numpy(shape, method, cplx):
    nx, ny = 29, 7
    x = RNG.standard_normal(nx)
    y = RNG.standard_normal(ny)
    if cplx:
        x = x + 1j * RNG.standard_normal(nx)
        y = y + 1j * RNG.standard_normal(ny)
    x = x.astype(np.complex64 if cplx else np.float32)
    y = y.astype(np.complex64 if cplx else np.float32)
    got = np.asarray(convd(x, y, axis=0, shape=shape, method=method))
    want = np.convolve(x.astype(np.complex128 if cplx else np.float64),
                       y.astype(np.complex128 if cplx else np.float64), mode=shape)
    assert got.shape[0] == conv_len(nx, ny, shape)
    assert np.allclose(got, want, atol=1e-4)


def test_convd_batched_axis():
    x = RNG.standard_normal((20, 3, 2)).astype(np.float32)
    h = RNG.standard_normal(5).astype(np.float32)
    got = np.asarray(convd(x, h.reshape(-1, 1, 1), axis=0, shape="same"))
    for i in range(3):
        for j in range(2):
            want = np.convolve(x[:, i, j], h, mode="same")
            assert np.allclose(got[:, i, j], want, atol=1e-5)


def test_convd_per_channel_kernels():
    # different kernel per batch entry (the reference's batched conv,
    # convd.cu:95-130)
    x = RNG.standard_normal((16, 4)).astype(np.float32)
    h = RNG.standard_normal((5, 4)).astype(np.float32)
    got = np.asarray(convd(x, h, axis=0, shape="full"))
    for i in range(4):
        want = np.convolve(x[:, i], h[:, i], mode="full")
        assert np.allclose(got[:, i], want, atol=1e-5)


def test_convd_middle_axis():
    x = RNG.standard_normal((3, 20, 2)).astype(np.float32)
    h = RNG.standard_normal((1, 7, 1)).astype(np.float32)
    got = np.asarray(convd(x, h, axis=1, shape="full"))
    assert got.shape == (3, 26, 2)
    want = np.convolve(x[1, :, 0], h[0, :, 0], mode="full")
    assert np.allclose(got[1, :, 0], want, atol=1e-5)


@pytest.mark.full
def test_xcorr_matched_filter_peak():
    # matched filtering peaks at the embedded delay
    T = 128
    h = RNG.standard_normal(16).astype(np.float32)
    x = np.zeros(T, np.float32)
    d = 40
    x[d:d + 16] = h
    c = np.asarray(xcorr(x, h, shape="full"))
    assert int(np.argmax(np.abs(c))) == d + 15  # lag d in full-conv indexing


def test_convd_long_kernel_fft_path():
    x = RNG.standard_normal(400).astype(np.float32)
    h = RNG.standard_normal(150).astype(np.float32)
    got = np.asarray(convd(x, h, shape="same"))  # auto -> fft
    want = np.convolve(x.astype(np.float64), h.astype(np.float64), mode="same")
    assert np.allclose(got, want, atol=1e-3)


def test_wsinterpd2_summed_scan_path():
    # sdim reduction with a separable summed dim: exercises the lax.scan
    # streaming path (memory contract of interpd.cu:345-396) vs the dense sum
    T, N, M, Mp = 48, 3, 12, 7
    x = RNG.standard_normal((T, N, M)).astype(np.float32)
    tau1 = np.arange(T, dtype=np.float32).reshape(T, 1, 1, 1)  # time
    tau2 = RNG.uniform(-8, 8, (1, 1, M, Mp)).astype(np.float32)
    w = RNG.standard_normal((1, 1, M, Mp)).astype(np.float32)
    y = np.asarray(wsinterpd2(x[..., None], tau1, tau2, w=w, sdim=2,
                              method="linear"))
    assert y.shape == (T, N, 1, Mp)
    # dense oracle
    tau = tau1 + tau2  # (T, 1, M, Mp)
    want = np.zeros((T, N, Mp), np.float32)
    for n in range(N):
        for m in range(M):
            for p in range(Mp):
                want[:, n, p] += w[0, 0, m, p] * naive_interp1(
                    x[:, n, m], tau[:, 0, m, p], "linear")
    assert np.allclose(y[:, :, 0, :], want, atol=1e-3)


def test_wsinterpd2_summed_scan_complex_phase():
    T, M = 48, 9
    x = (RNG.standard_normal((T, 1, M))
         + 1j * RNG.standard_normal((T, 1, M))).astype(np.complex64)
    tau1 = np.arange(T, dtype=np.float32).reshape(T, 1, 1, 1)
    tau2 = RNG.uniform(-5, 5, (1, 1, M, 2)).astype(np.float32)
    om = 0.21
    y = np.asarray(wsinterpd2(x[..., None], tau1, tau2, sdim=2, omega=om,
                              method="linear"))
    tau = tau1 + tau2
    want = np.zeros((T, 1, 1, 2), np.complex64)
    for m in range(M):
        for p in range(2):
            t = tau[:, 0, m, p]
            want[:, 0, 0, p] += np.exp(1j * om * t) * naive_interp1(
                x[:, 0, m], t, "linear")
    assert np.allclose(y, want, atol=1e-3)


def test_waveform_tone_window():
    # regression: the Hann window must actually be applied (round-1 dead code)
    from qups_jax import Waveform
    wv = Waveform.Tone(5e6, cycles=4.0)
    t = np.linspace(0, 4 / 5e6, 200)
    s = np.asarray(wv.sample(t))
    # endpoints windowed to ~0, center not
    assert abs(s[1]) < 0.2 * np.abs(s).max()
    assert abs(s[-2]) < 0.2 * np.abs(s).max()
    win = np.cos(np.pi * (t - t[-1] / 2) / t[-1]) ** 2
    assert np.allclose(s, np.sin(2 * np.pi * 5e6 * t) * win, atol=1e-6)
