"""Frequency-domain point-scatterer simulator — the native analog of the
MUST/SIMUS interop (``UltrasoundSystem.simus``,
``/root/reference/src/UltrasoundSystem.m:1464-1667``): single-scattering
(Born) synthesis in the frequency domain with far-field element directivity,

    X(f; n, e) = P(f) sum_s a_s D(f, th_es) D(f, th_sn)
                 e^{-2i pi f (r_es + r_sn) / c} / (r_es r_sn)

with ``D(f, th) = sinc(w f sin(th) / c) [cos(th)]`` the rectangular-element
directivity (hard/soft baffle). Per frequency bin this is an
``(S, N)^T x (S, E)`` complex GEMM, versus the reference's external
MATLAB toolbox. Like :mod:`qups_jax.ops.greens_freq`, the
distance phasors ride amplitude-folded multiplicative recurrences over a
contiguous bin hull and bins are processed in blocks feeding batched
GEMMs; the frequency-dependent sinc directivity, which has no
multiplicative recurrence, is evaluated per block from the in-scan bin
index.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_PRECS = {
    "highest": jax.lax.Precision.HIGHEST,
    "default": jax.lax.Precision.DEFAULT,
}


@partial(jax.jit, static_argnames=("k0", "F", "T", "fs", "c0", "baffle",
                                   "B", "precision", "att"))
def _simus_spectrum(ps, amp, pn, nn_az, pv, nv_az, widths, *, k0: int,
                    F: int, T: int, fs: float, c0: float,
                    baffle: str = "soft", B: int = 8,
                    precision: str = "highest", att: float = 0.0):
    """Geometry+directivity spectrum X[k, n, e] for one contiguous bin run
    [k0, k0+F), complex.

    ps (S, 3); amp (S,); pn (N, 3) + nn_az (N,) rx centers/azimuths [rad];
    pv (E, 3) + nv_az (E,); widths (2,) = (tx, rx) element widths [m].
    """
    ps = ps.astype(jnp.float32)
    amp = amp.astype(jnp.float32)
    gemm16 = precision == "bf16"  # same contract as greens_freq's engine
    prec = _PRECS["highest" if gemm16 else precision]
    B = max(1, min(B, F))

    def geom(pe, az):
        d = ps[:, None, :] - pe[None, :, :].astype(jnp.float32)  # (S, E, 3)
        r = jnp.sqrt(jnp.sum(d * d, axis=-1))
        ca, sa = jnp.cos(az), jnp.sin(az)
        lat = d[..., 0] * ca[None, :] - d[..., 2] * sa[None, :]
        ax = d[..., 2] * ca[None, :] + d[..., 0] * sa[None, :]
        sth = lat / jnp.maximum(r, 1e-12)
        cth = ax / jnp.maximum(r, 1e-12)
        return r, sth, cth

    r_tx, sth_tx, cth_tx = geom(pv, jnp.asarray(nv_az, jnp.float32))
    r_rx, sth_rx, cth_rx = geom(pn, jnp.asarray(nn_az, jnp.float32))

    # k-independent weights: 1/r loss, obliquity, scatterer amplitude
    w_tx = amp[:, None] / jnp.maximum(r_tx, 1e-6)
    w_rx = 1.0 / jnp.maximum(r_rx, 1e-6)
    if baffle == "soft":
        w_tx = w_tx * jnp.maximum(cth_tx, 0.0)
        w_rx = w_rx * jnp.maximum(cth_rx, 0.0)

    dph = jnp.float32(2.0 * np.pi * fs / (T * c0))

    def phasor(r, w, k):  # w e^{-i k dph r}
        a = -k * dph * r
        return jax.lax.complex(w * jnp.cos(a), w * jnp.sin(a))

    if att != 0.0:
        # frequency-linear absorption exp(-att k r) over both legs — the
        # MUST attenuation model (``Scatterers.alpha0``); rides the same
        # multiplicative recurrence as the phase (see greens_freq)
        w_rx = w_rx * jnp.exp(-att * float(k0) * r_rx)
        w_tx = w_tx * jnp.exp(-att * float(k0) * r_tx)
        d_rx = phasor(r_rx, jnp.exp(-att * r_rx), 1.0)
        d_tx = phasor(r_tx, jnp.exp(-att * r_tx), 1.0)
    else:
        d_rx = phasor(r_rx, jnp.ones_like(r_rx), 1.0)
        d_tx = phasor(r_tx, jnp.ones_like(r_tx), 1.0)
    E_rx = phasor(r_rx, w_rx, float(k0))
    E_tx = phasor(r_tx, w_tx, float(k0))

    # sinc directivity arguments per unit bin index: w_el * k * fs * sth /
    # (T c0) — no recurrence exists, so the shared engine evaluates it as
    # a per-bin weight callback
    from .greens_freq import block_gemm_scan
    s_tx = widths[0] * (fs / (T * c0)) * sth_tx  # (S, E)
    s_rx = widths[1] * (fs / (T * c0)) * sth_rx  # (S, N)

    def weights(kf):
        return jnp.sinc(s_rx * kf), jnp.sinc(s_tx * kf)

    return block_gemm_scan(E_rx, E_tx, d_rx, d_tx, F=F, B=B, prec=prec,
                           k0=k0, weights=weights,
                           gemm16=gemm16)[:F]  # (F, N, E) c64


def _bin_runs(bin_idx, merge_gap: int = 32):
    """Split selected bin indices into contiguous runs (gaps up to
    ``merge_gap`` are absorbed — a short zero-spectrum stretch is cheaper
    than an extra compiled program). Returns [(k0, k1), ...]."""
    runs = []
    k0 = k = int(bin_idx[0])
    for b in bin_idx[1:]:
        b = int(b)
        if b - k > merge_gap:
            runs.append((k0, k + 1))
            k0 = b
        k = b
    runs.append((k0, k + 1))
    return runs


@partial(jax.jit, static_argnames=("T", "k0s"))
def _simus_synth(Xs, spec_ris, *, T: int, k0s):
    """Assemble the rfft spectrum from per-run geometry spectra x pulse
    spectra and synthesize real traces."""
    shape = Xs[0].shape[1:]
    full = jnp.zeros((T // 2 + 1,) + shape, jnp.complex64)
    for X, sri, k0 in zip(Xs, spec_ris, k0s):
        pf = jax.lax.complex(sri[:, 0], sri[:, 1])
        full = full.at[k0:k0 + X.shape[0]].set(X * pf[:, None, None])
    return jnp.fft.irfft(full, n=T, axis=0)


def simus_fsa(ps, amp, pn, nn_az, pv, nv_az, widths, spec, bin_idx, *,
              T: int, fs: float, c0: float, baffle: str = "soft",
              precision: str = "highest", alpha0: float = 0.0):
    """Frequency-domain FSA synthesis.

    Args:
      ps (S, 3): scatterer positions; amp (S,): real amplitudes.
      pn (N, 3): rx element centers; nn_az (N,): element azimuth [rad].
      pv (E, 3): tx element centers; nv_az (E,): azimuths [rad].
      widths (2,): (tx width, rx width) element widths [m].
      spec (F0,): complex pulse spectrum at the selected bins (includes the
        start-time phase ramp).
      bin_idx (F0,): rfft bin indices of the selected frequencies.
      T: output samples; fs: sampling rate; c0: sound speed;
      baffle: 'soft' multiplies the obliquity cos(th); 'hard' omits it.
      alpha0: frequency-linear absorption [dB/cm/MHz] applied per bin over
        both propagation legs (the MUST model, ``Scatterers.alpha0``).

    Returns: real (T, N, E) FSA traces (rfft synthesis).
    """
    from .greens_freq import alpha_np_per_bin
    bin_idx = np.asarray(bin_idx, np.int64)
    order = np.argsort(bin_idx)
    bin_idx = bin_idx[order]
    spec = np.asarray(spec, np.complex64)[order]
    if bin_idx.size == 0:
        return jnp.zeros((T, np.shape(pn)[0], np.shape(pv)[0]), jnp.float32)
    att = alpha_np_per_bin(alpha0, fs, T) if alpha0 else 0.0
    # contiguous runs (short gaps absorbed as zero spectrum): sparse /
    # multi-lobe selections never pay GEMMs across dead bands
    Xs, spec_ris, k0s = [], [], []
    for k0, k1 in _bin_runs(bin_idx):
        F = k1 - k0
        sel = (bin_idx >= k0) & (bin_idx < k1)
        spec_h = np.zeros(F, np.complex64)
        spec_h[bin_idx[sel] - k0] = spec[sel]
        spec_ris.append(jnp.asarray(
            np.stack([spec_h.real, spec_h.imag], -1).astype(np.float32)))
        X = _simus_spectrum(
            jnp.asarray(ps, jnp.float32), jnp.asarray(amp, jnp.float32),
            jnp.asarray(pn, jnp.float32), jnp.asarray(nn_az, jnp.float32),
            jnp.asarray(pv, jnp.float32), jnp.asarray(nv_az, jnp.float32),
            jnp.asarray(widths, jnp.float32), k0=int(k0), F=int(F), T=T,
            fs=float(fs), c0=float(c0), baffle=baffle,
            precision=precision, att=att)
        Xs.append(X)
        k0s.append(int(k0))
    return _simus_synth(tuple(Xs), tuple(spec_ris), T=T, k0s=tuple(k0s))
