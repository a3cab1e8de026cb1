"""Frequency-domain greens parity.

Two oracles: (1) an independent float64 numpy implementation of the same
band-limited synthesis (catches implementation bugs — signs, FFT length,
wrap-around); (2) the dense time-domain oracle with lanczos3 interpolation
(catches formulation drift — the freq path realizes exact fractional delays,
so it should agree with a high-order interpolator to ~1e-2 of peak)."""
import numpy as np
import pytest
import jax.numpy as jnp

from qups_jax.ops.greens import greens_dense
from qups_jax.ops.greens_freq import greens_freq

def problem(S=10, N=6, M=3, T=128, K=15, fs=15e6, c0=1540.0, seed=3):
    RNG = np.random.default_rng(seed)
    kern = (np.hanning(K) * np.sin(2 * np.pi * 4e6 * np.arange(K) / fs)
            ).astype(np.float32)
    ps = np.stack([RNG.uniform(-3e-3, 3e-3, S), np.zeros(S),
                   RNG.uniform(8e-3, 12e-3, S)], -1).astype(np.float32)
    amp = RNG.uniform(0.5, 2.0, S).astype(np.float32)
    pn = np.stack([np.linspace(-5e-3, 5e-3, N), np.zeros(N), np.zeros(N)],
                  -1)[:, None, :].astype(np.float32)
    pv = np.stack([np.linspace(-3e-3, 3e-3, M), np.zeros(M), np.zeros(M)],
                  -1)[:, None, :].astype(np.float32)
    s0 = 2 * 8e-3 / c0 - 1e-6
    t0k = -K / 2 / fs
    return kern, ps, amp, pn, pv, dict(T=T, s0=s0, t0k=t0k, fs=fs,
                                       cinv=1 / c0, R0=1e-3)


def numpy_freq_oracle(kern, ps, amp, pn, pv, *, T, s0, t0k, fs, cinv, R0,
                      L=None, alpha0=0.0):
    """Float64 reference of the band-limited synthesis (all bins), with
    frequency-linear absorption over both legs."""
    K = kern.shape[0]
    r1 = np.linalg.norm(ps[:, None, None, :].astype(np.float64)
                        - pn[None].astype(np.float64), axis=-1)  # (S, N, En)
    r2 = np.linalg.norm(ps[:, None, None, :].astype(np.float64)
                        - pv[None].astype(np.float64), axis=-1)  # (S, M, Em)
    dc = (t0k - s0) * fs
    if L is None:
        dmax = cinv * (r1.max() + r2.max()) * fs + dc
        dmin = cinv * (r1.min() + r2.min()) * fs + dc
        L = int(max(T, dmax + K + 8, T - min(0.0, dmin) + 8))
        L = 1 << int(np.ceil(np.log2(L)))
    k = np.arange(L // 2 + 1)
    if np.iscomplexobj(kern):  # full fft for complex kernels
        Kf = np.fft.fft(kern.astype(np.complex128), n=L)
    else:
        Kf = np.fft.rfft(kern.astype(np.float64), n=L)
    th = 2 * np.pi * k * cinv * fs / L
    if alpha0:
        from qups_jax.ops.greens_freq import alpha_np_per_bin
        th = th - 1j * alpha_np_per_bin(alpha0, fs, L) * k
    A = (np.exp(-1j * th[:, None, None, None] * r1[None])
         / np.maximum(r1, R0)[None]).sum(-1)  # (F, S, N)
    B = (np.exp(-1j * th[:, None, None, None] * r2[None])
         / np.maximum(r2, R0)[None]).sum(-1)  # (F, S, M)
    G = np.einsum("fsn,s,fsm->fnm", A, amp.astype(np.complex128), B)
    ramp = np.exp(-2j * np.pi * k * dc / L)
    if not np.iscomplexobj(kern):
        X = Kf[:, None, None] * ramp[:, None, None] * G
        return np.fft.irfft(X, n=L, axis=0)[:T]
    # complex kernel: negative-frequency geometry bins are conjugates
    Gf = np.zeros((L,) + G.shape[1:], np.complex128)
    Gf[:L // 2 + 1] = ramp[:, None, None] * G
    Gf[L // 2 + 1:] = np.conj(Gf[1:L // 2][::-1])
    return np.fft.ifft(Kf[:, None, None] * Gf, axis=0)[:T]


def test_vs_numpy_oracle():
    kern, ps, amp, pn, pv, kw = problem()
    want = numpy_freq_oracle(kern, ps, amp, pn, pv, **kw)
    got = np.asarray(greens_freq(kern, ps, amp, pn, pv, rtol=0.0, **kw))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 2e-4, err


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_gemm_precision_lowered_for_cuda(precision):
    """The engine's GEMMs, lowered for a CUDA device from the CPU, carry the
    precision asked for: 'highest' (the default) keeps full f32, where a
    float32 dot at DEFAULT runs in TF32 on the GPU."""
    import jax
    kern, ps, amp, pn, pv, kw = problem()
    f = jax.jit(lambda: greens_freq(kern, ps, amp, pn, pv, rtol=0.0,
                                    precision=precision, **kw))
    text = jax.export.export(f, platforms=["cuda"])().mlir_module()
    dots = [ln for ln in text.splitlines()
            if "stablehlo.dot_general" in ln]
    assert dots
    assert all(("precision = [HIGHEST, HIGHEST]" in ln)
               == (precision == "highest") for ln in dots)


@pytest.mark.parametrize("case", ["odd_sizes", "many_scatterers",
                                  "attenuation", "bf16", "subelements"])
def test_engine_cases_vs_numpy_oracle(case):
    """The XLA GEMM engine against the float64 oracle: sizes far from any
    block multiple, a larger cloud, absorption, bf16 GEMM inputs (f32
    accumulation) and two sub-elements per element."""
    kw_p = dict(odd_sizes=dict(S=13, N=5, M=7), many_scatterers=dict(S=37),
                subelements=dict(S=7)).get(case, {})
    kern, ps, amp, pn, pv, kw = problem(**kw_p)
    if case == "subelements":
        off = np.array([0.1e-3, 0, 0], np.float32)
        pn = np.concatenate([pn + off, pn - off], axis=1)
        pv = np.concatenate([pv - off, pv + off], axis=1)
    extra = dict(alpha0=0.5) if case == "attenuation" else {}
    want = numpy_freq_oracle(kern, ps, amp, pn, pv, **kw, **extra)
    got = np.asarray(greens_freq(
        kern, ps, amp, pn, pv, rtol=0.0, **kw, **extra,
        **(dict(precision="bf16") if case == "bf16" else {})))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < (5e-3 if case == "bf16" else 2e-4), err


def sincup_dense(kern, ps, amp, pn, pv, up=16, **kw):
    """Dense time-domain oracle with a band-limited (sinc-upsampled)
    kernel — the true fractional-delay reference. The freq path realizes
    exact band-limited delays, which at broadband pulses differ from
    lanczos3/cubic by far more than from this oracle."""
    K = kern.shape[0]
    L = 1 << int(np.ceil(np.log2(4 * K)))
    Kf = np.fft.rfft(np.asarray(kern, np.float64), n=L)
    kup = (np.fft.irfft(Kf, n=L * up)[:K * up] * up).astype(np.float32)
    # greens_dense divides amplitudes by fsr: pre-scale to cancel
    return np.asarray(greens_dense(jnp.asarray(kup * up), ps, amp, pn, pv,
                                   method="cubic", fsr=float(up), **kw))


def test_vs_dense_bandlimited():
    kern, ps, amp, pn, pv, kw = problem()
    want = sincup_dense(kern, ps, amp, pn, pv, **kw)
    got = np.asarray(greens_freq(kern, ps, amp, pn, pv, **kw))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-2, err
    # on every strong trace, each result's peak location must carry ~the
    # peak value in the other (argmax itself can flip between near-equal
    # oscillation maxima of this deliberately broadband pulse)
    pk = np.abs(want).max(axis=0)
    strong = np.argwhere(pk > 0.3 * pk.max())
    assert strong.size
    for n, m in strong:
        iw = int(np.argmax(np.abs(want[:, n, m])))
        ig = int(np.argmax(np.abs(got[:, n, m])))
        assert np.abs(want[ig, n, m]) > 0.95 * np.abs(want[iw, n, m])
        assert np.abs(got[iw, n, m]) > 0.95 * np.abs(got[ig, n, m])


def test_band_threshold():
    """rtol band selection stays close to the full-spectrum result."""
    kern, ps, amp, pn, pv, kw = problem(S=6, T=96)
    full = np.asarray(greens_freq(kern, ps, amp, pn, pv, rtol=0.0, **kw))
    band = np.asarray(greens_freq(kern, ps, amp, pn, pv, rtol=1e-4, **kw))
    err = np.abs(band - full).max() / np.abs(full).max()
    assert err < 1e-3, err


def test_complex_kernel():
    kern, ps, amp, pn, pv, kw = problem(S=6, T=96)
    ck = kern.astype(np.complex64) * np.exp(
        1j * np.linspace(0, np.pi, kern.size)).astype(np.complex64)
    want = numpy_freq_oracle(ck, ps, amp, pn, pv, **kw)
    got = np.asarray(greens_freq(ck, ps, amp, pn, pv, rtol=0.0,
                                 out="complex", **kw))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-3, err  # two f32 synthesis passes + cancellation
    ri = np.asarray(greens_freq(ck, ps, amp, pn, pv, rtol=0.0, out="ri",
                                **kw))
    np.testing.assert_allclose(ri[..., 0] + 1j * ri[..., 1], got, atol=0)


def test_complex_amp():
    kern, ps, amp, pn, pv, kw = problem(S=6, T=96)
    ca = (amp * np.exp(1j * np.linspace(0, 2, amp.size))).astype(np.complex64)
    want = (sincup_dense(kern, ps, np.real(ca).copy(), pn, pv, **kw)
            + 1j * sincup_dense(kern, ps, np.imag(ca).copy(), pn, pv, **kw))
    got = np.asarray(greens_freq(kern, ps, ca, pn, pv, out="complex", **kw))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-2, err


def test_subelements():
    kern, ps, amp, pn, pv, kw = problem(S=5, N=4, M=2, T=96)
    pn2 = np.concatenate([pn + np.array([0.2e-3, 0, 0]),
                          pn - np.array([0.2e-3, 0, 0])], axis=1)
    want = numpy_freq_oracle(kern, ps, amp, pn2, pv, **kw)
    got = np.asarray(greens_freq(kern, ps, amp, pn2, pv, rtol=0.0, **kw))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 2e-4, err


def test_scatterer_slab_blocking():
    """slab-blocked spectra accumulate to the unblocked result."""
    kern, ps, amp, pn, pv, kw = problem(S=11)
    full = np.asarray(greens_freq(kern, ps, amp, pn, pv, **kw))
    slabbed = np.asarray(greens_freq(kern, ps, amp, pn, pv, slab=4, **kw))
    assert np.abs(slabbed - full).max() <= 1e-5 * np.abs(full).max()


def test_fsr_resampled_kernel():
    # kernel sampled at 2x the output rate; the pulse band (2.5 MHz at a
    # 15 MHz output rate) stays below the OUTPUT Nyquist so decimation to
    # the output rate is alias-free
    _, ps, amp, pn, pv, kw = problem()
    fsr, K, fs = 2.0, 61, kw["fs"]
    kern = (np.hanning(K) * np.sin(2 * np.pi * 2.5e6 * np.arange(K)
                                   / (fsr * fs))).astype(np.float32)
    got = np.asarray(greens_freq(kern, ps, amp, pn, pv, fsr=fsr, **kw))
    want = np.asarray(greens_dense(jnp.asarray(kern), ps, amp, pn, pv,
                                   method="lanczos3", fsr=fsr, **kw))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 2e-2, err
    for n, m in [(0, 0), (3, 1)]:
        assert abs(int(np.argmax(np.abs(want[:, n, m])))
                   - int(np.argmax(np.abs(got[:, n, m])))) <= 1


def test_bf16_gemm_parity():
    """precision='bf16' (bf16 phasor GEMM inputs, f32 accumulation)
    matches the f32 path within the bf16 mantissa budget."""
    kern, ps, amp, pn, pv, kw = problem(S=31)
    x32 = np.asarray(greens_freq(kern, ps, amp, pn, pv, **kw))
    x16 = np.asarray(greens_freq(kern, ps, amp, pn, pv,
                                 precision="bf16", **kw))
    rel = np.linalg.norm(x16 - x32) / np.linalg.norm(x32)
    assert rel < 5e-3, rel


def test_attenuation_analytic():
    """Scatterers.alpha0 absorption (VERDICT r2 #7): a single scatterer's
    echo amplitude drops by exp(-a(fc) * 2r) for a narrowband pulse —
    the analytic MUST model (``src/Scatterers.m:14-84``)."""
    fs, c0, fc = 40e6, 1500.0, 5e6
    r = 20e-3
    K = 121
    t = np.arange(K) / fs
    kern = (np.sin(2 * np.pi * fc * t)
            * np.hanning(K)).astype(np.float32)  # narrowband tone at fc
    ps = np.array([[0.0, 0.0, r]], np.float32)
    amp = np.ones(1, np.float32)
    pn = np.zeros((1, 1, 3), np.float32)
    pv = np.zeros((1, 1, 3), np.float32)
    T = int((2 * r / c0) * fs) + K + 64
    kw = dict(T=T, s0=0.0, t0k=0.0, fs=fs, cinv=1 / c0, R0=1e-3,
              out="complex")
    x0 = np.asarray(greens_freq(kern, ps, amp, pn, pv, **kw)).ravel()
    alpha0 = 0.5  # dB/cm/MHz
    x1 = np.asarray(greens_freq(kern, ps, amp, pn, pv, alpha0=alpha0,
                                **kw)).ravel()
    ratio = np.abs(x1).max() / np.abs(x0).max()
    # analytic: 10^(-alpha0 * f_MHz * 2r_cm / 20)
    expect = 10.0 ** (-alpha0 * (fc / 1e6) * (2 * r * 100) / 20.0)
    assert abs(ratio - expect) / expect < 0.03
    # and alpha0=0 is bit-identical to the unattenuated path
    x2 = np.asarray(greens_freq(kern, ps, amp, pn, pv, alpha0=0.0,
                                **kw)).ravel()
    np.testing.assert_array_equal(x0, x2)


def test_attenuation_via_scatterers():
    """system.greens consumes Scatterers.alpha0 through the freq engine."""
    import qups_jax as q
    xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=5e6)
    seq = q.Sequence(type="FSA", numpulse=4, c0=1500.0)
    scan = q.ScanCartesian(x=np.linspace(-1e-3, 1e-3, 4),
                           z=np.linspace(19e-3, 21e-3, 4))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=40e6)
    s0 = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1500.0)
    s1 = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1500.0, alpha0=0.5)
    a = np.abs(np.asarray(us.greens(s0, impl="freq").data)).max()
    b = np.abs(np.asarray(us.greens(s1, impl="freq").data)).max()
    assert b < 0.6 * a  # ~ -10 dB at 5 MHz x 4 cm round trip
