"""Frequency-domain Green's-function simulator — the GEMM path.

Computes the same FSA response as :mod:`qups_jax.ops.greens`
(``/root/reference/src/greens.cu:8-122``,
``src/UltrasoundSystem.m:463-882``)

    x[t, n, m] = sum_s a_s / (r1' r2' fsr) * wv(t - tau_snm - t0k + s0)

but in the frequency domain: with ``d_snm = (tau_snm + t0k - s0) fs`` the
fractional deposit index and ``KERN_k`` the length-``L`` rfft of the pulse
kernel, every output bin is

    X_k[n, m] = KERN_k * sum_s (e^{-i th_k r1}/r1') (a_s e^{-i th_k r2}/r2')
              = KERN_k * (A_k^T B_k)[n, m],      th_k = 2 pi k cinv fs / L

— a complex ``(S, N)^T x (S, M)`` GEMM per bin (XLA hands it to cuBLAS
on the GPU), where the splat formulation is scatter-and-accumulate. The
per-bin phasors ride a multiplicative recurrence ``A_{k+1} = A_k * dA``
(amplitudes folded into the initial value), so the per-bin elementwise
cost is two complex
multiplies. Fractional delays are exact (band-limited/sinc semantics)
rather than tent/cubic splat approximations.

Wrap-around safety: ``L`` is chosen so every kernel deposit (support
``[d, d+K)``) lands inside ``[0, L)`` modulo-free relative to the cropped
``[0, T)`` output window.

Complex kernels and complex amplitudes decompose by bilinearity,
``x = S(kr, ar) - S(ki, ai)·i^2 ...``: the geometry GEMM ``G_k`` is
kernel-independent, so a complex kernel costs two spectrum scalings and two
extra irffts, never a second GEMM pass; a complex amplitude costs a second
GEMM pass. All jit boundaries carry real arrays only (ri contract of
:mod:`qups_jax.utils.cpx`).
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


def block_gemm_scan(E1, E2, d1, d2, *, F: int, B: int, prec, k0: int = 0,
                    weights=None, subsum: bool = False,
                    gemm16: bool = False):
    """The shared bin-blocked phasor-GEMM engine (used by greens_freq and
    ops.simus): extend the multiplicative recurrences ``E <- E * d`` by B
    bins per scan step and contract each block with ONE batched complex
    GEMM ``X_k = A_k^T B_k``.

    ``weights``: optional callable ``k_float -> (w1, w2)`` applying per-bin
    REAL weights to the rx/tx phasors (e.g. sinc directivity — terms with
    no multiplicative recurrence). ``subsum``: sum a trailing sub-element
    axis of E1/E2 before the GEMM. Returns (ceil(F/B)*B, N, M) complex —
    callers crop to F.

    ``gemm16``: run the contraction with bf16 phasor inputs and f32
    accumulation (~0.2% rel err). The ri parts are packed into ONE
    ``bsn,bsm->bnm`` dot so the bf16 path keeps the f32 path's GEMM
    shape.
    """
    B = max(1, min(B, F))
    nblk = -(-F // B)

    def one_block(carry, it):
        e1, e2 = carry
        kb = k0 + it * B
        As, Bs = [], []
        for j in range(B):
            a, b = e1, e2
            if weights is not None:
                w1, w2 = weights((kb + j).astype(jnp.float32))
                a, b = a * w1, b * w2
            As.append(jnp.sum(a, 2) if subsum else a)
            Bs.append(jnp.sum(b, 2) if subsum else b)
            e1 = e1 * d1
            e2 = e2 * d2
        Ast = jnp.stack(As)  # (B, S, N) c64
        Bst = jnp.stack(Bs)  # (B, S, M) c64
        if gemm16:
            # ri parts concatenated along the ELEMENT axis so the dot
            # keeps the exact bsn,bsm->bnm shape of the f32 path (a
            # separate ri axis made XLA materialize a transposed copy of
            # the stack — measured 2.2x SLOWER than f32 at S=1e5)
            N_, M_ = Ast.shape[-1], Bst.shape[-1]
            Ar = jnp.concatenate([jnp.real(Ast), jnp.imag(Ast)],
                                 axis=-1).astype(jnp.bfloat16)  # (B,S,2N)
            Br = jnp.concatenate([jnp.real(Bst), jnp.imag(Bst)],
                                 axis=-1).astype(jnp.bfloat16)  # (B,S,2M)
            P = jnp.einsum("bsn,bsm->bnm", Ar, Br,
                           preferred_element_type=jnp.float32)
            X = jax.lax.complex(P[:, :N_, :M_] - P[:, N_:, M_:],
                                P[:, :N_, M_:] + P[:, N_:, :M_])
        else:
            X = jnp.einsum("bsn,bsm->bnm", Ast, Bst,
                           precision=prec)  # (B, N, M) c64
        return (e1, e2), X

    _, X = jax.lax.scan(one_block, (E1, E2), jnp.arange(nblk))
    return X.reshape(nblk * B, *X.shape[2:])


@partial(jax.jit,
         static_argnames=("L", "k0", "F", "R0", "fsr", "precision", "B",
                          "att"))
def _freq_gemm(phc, ps, amp, pn, pv, *, L: int, k0: int, F: int, R0: float,
               fsr: float, precision: str = "highest", B: int = 8,
               att: float = 0.0):
    """Geometry spectrum G_k[n, m] for bins k0..k0+F as an ri pair.

    Bins are processed in blocks of ``B``: each scan step extends the
    amplitude-folded phasor recurrence ``E_{k+1} = E_k dE`` by B bins and
    issues ONE batched (B, S, N)^T x (B, S, M) complex GEMM (far less
    scan overhead than one GEMM per bin).
    Complex arrays live strictly inside the jit (ri at the boundary).

    Args: phc () f32 = 2 pi cinv fs / L; ps (S, 3); amp (S,) REAL;
    pn (N, En, 3); pv (M, Em, 3). Returns (F, N, M, 2) f32.

    ``precision='bf16'`` runs the per-bin GEMMs with bf16 phasor inputs
    (f32 accumulation) for ~0.4% amplitude error; the phasor recurrence
    stays f32. 'highest' (the default) keeps the GEMMs in full f32: under
    the GPU's default precision a float32 dot would run in TF32.
    """
    ps = ps.astype(jnp.float32)
    pn = pn.astype(jnp.float32)
    pv = pv.astype(jnp.float32)
    gemm16 = precision == "bf16"
    prec = _PRECS["highest" if gemm16 else precision]
    B = max(1, min(B, F))

    def geom(pe):  # (E, Esub, 3) -> r (S, E, Esub)
        d = ps[:, None, None, :] - pe[None, :, :, :]
        return jnp.sqrt(jnp.sum(d * d, axis=-1))

    r1 = geom(pn)  # (S, N, En)
    r2 = geom(pv)  # (S, M, Em)
    w1 = 1.0 / jnp.maximum(r1, R0) if R0 > 0 else jnp.ones_like(r1)
    w2 = (amp.astype(jnp.float32) / fsr)[:, None, None] * (
        1.0 / jnp.maximum(r2, R0) if R0 > 0 else jnp.ones_like(r2))

    def phasor(r, w, k):  # w e^{-i k phc r}
        a = -k * phc * r
        return jax.lax.complex(w * jnp.cos(a), w * jnp.sin(a))

    if att != 0.0:
        # frequency-linear attenuation exp(-a(f) r) with a = att * k [Np/m]
        # per rfft bin index k (``Scatterers.alpha0`` [dB/cm/MHz] — the
        # MUST/SIMUS absorption model, ``src/Scatterers.m:14-84``). Linear-
        # in-k decay rides the SAME multiplicative recurrence as the
        # phase: the per-bin delta gains magnitude exp(-att r).
        w1 = w1 * jnp.exp(-att * float(k0) * r1)
        w2 = w2 * jnp.exp(-att * float(k0) * r2)
        d1 = phasor(r1, jnp.exp(-att * r1), 1.0)
        d2 = phasor(r2, jnp.exp(-att * r2), 1.0)
    else:
        d1 = phasor(r1, jnp.ones_like(r1), 1.0)
        d2 = phasor(r2, jnp.ones_like(r2), 1.0)
    E1 = phasor(r1, w1, float(k0))
    E2 = phasor(r2, w2, float(k0))

    X = block_gemm_scan(E1, E2, d1, d2, F=F, B=B, prec=prec,
                        subsum=True, gemm16=gemm16)[:F]
    return jnp.stack([jnp.real(X), jnp.imag(X)], axis=-1)  # (F, N, M, 2)


@partial(jax.jit, static_argnames=("L", "k0", "T"))
def _synth(G, kf, *, L: int, k0: int, T: int):
    """irfft synthesis: x = irfft(KERN .* G)[:T].

    G (F, N, M, 2) ri geometry bins; kf (F, 2) ri kernel spectrum (includes
    the scalar (t0k - s0) phase ramp). Returns (T, N, M) f32.
    """
    F, N, M = G.shape[:3]
    xr = G[..., 0] * kf[:, None, None, 0] - G[..., 1] * kf[:, None, None, 1]
    xi = G[..., 0] * kf[:, None, None, 1] + G[..., 1] * kf[:, None, None, 0]
    full = jnp.zeros((L // 2 + 1, N, M), jnp.complex64)
    full = full.at[k0:k0 + F].set(jax.lax.complex(xr, xi))
    return jnp.fft.irfft(full, n=L, axis=0)[:T]


_DB_PER_NP = 20.0 / np.log(10.0)  # 8.6859 dB per neper


def alpha_np_per_bin(alpha0: float, fs: float, L: int) -> float:
    """Convert ``alpha0`` [dB/cm/MHz] (frequency-linear absorption, the
    MUST/``Scatterers.alpha0`` convention, ``src/Scatterers.m:14-84``) to
    nepers/meter PER rfft BIN INDEX of an L-point transform at rate fs."""
    return float(alpha0) * 100.0 / _DB_PER_NP * (fs / L) / 1e6


def greens_freq(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
                fs: float, cinv, R0: float, fsr: float = 1.0,
                rtol: float = 1e-6, precision: str = "highest",
                out: str = "complex", slab: int = 131072,
                alpha0: float = 0.0):
    """Frequency-domain FSA Green's-function simulation.

    Same contract as :func:`qups_jax.ops.greens.greens_splat` — ``kern``
    (K,) real or complex sampled at ``fsr * fs``; ``ps`` (S, 3); ``amp``
    (S,) real or complex; ``pn`` (N, En, 3) rx and ``pv`` (M, Em, 3) tx
    sub-element positions — with band-limited (exact fractional-delay)
    interpolation semantics instead of a splat basis.

    ``rtol``: kernel-spectrum bins below ``rtol * max`` are dropped (the
    synthesis band is the contiguous hull of the survivors); 0 keeps every
    rfft bin.

    ``alpha0``: frequency-linear absorption [dB/cm/MHz] applied per bin as
    ``exp(-a(f) (r1 + r2))`` over both propagation legs — the MUST/SIMUS
    attenuation model (``src/Scatterers.m:14-84``).

    Returns (T, N, M) f32 for real kern+amp; otherwise complex64 for
    ``out='complex'`` (default) or an ri pair (T, N, M, 2) for ``'ri'``.

    Example:
        import numpy as np
        from qups_jax.ops.greens_freq import greens_freq
        fs, c0, r = 20e6, 1500.0, 10e-3
        kern = np.hanning(31).astype(np.float32)
        ps = np.array([[0.0, 0.0, r]], np.float32)     # one scatterer
        pn = pv = np.zeros((1, 1, 3), np.float32)      # one element
        T = int(2 * r / c0 * fs) + 64
        x = np.asarray(greens_freq(kern, ps, np.ones(1, np.float32), pn, pv,
                                   T=T, s0=0.0, t0k=0.0, fs=fs, cinv=1/c0,
                                   R0=1e-3, out="complex")).ravel()
        # the echo envelope peaks at the round-trip time (kernel center +15)
        i = int(np.abs(x).argmax())
        assert abs(i - (2 * r / c0 * fs + 15)) < 2
    """
    plan = _host_plan(kern, ps, pn, pv, T=T, s0=s0, t0k=t0k, fs=fs,
                      cinv=cinv, R0=R0, fsr=fsr, rtol=rtol,
                      precision=precision)
    ps, pn, pv = plan["ps"], plan["pn"], plan["pv"]

    # very large scatterer clouds: slab the scatterer axis and accumulate
    # the (F, N, M, 2) geometry spectra — bounds the (S, N)/(S, M) phasor
    # carries (the tall-array analog)
    SLAB = slab

    att = alpha_np_per_bin(alpha0, fs, plan["L"]) if alpha0 else 0.0
    gemm = partial(_freq_gemm, att=att)

    def gpass(a_real):
        a_real = np.asarray(a_real, np.float32)
        if ps.shape[0] <= SLAB:
            return gemm(jnp.asarray(plan["phc"]), jnp.asarray(ps),
                        jnp.asarray(a_real), jnp.asarray(pn),
                        jnp.asarray(pv), **plan["st"])
        acc = None
        for i0 in range(0, ps.shape[0], SLAB):
            part = gemm(jnp.asarray(plan["phc"]),
                        jnp.asarray(ps[i0:i0 + SLAB]),
                        jnp.asarray(a_real[i0:i0 + SLAB]),
                        jnp.asarray(pn), jnp.asarray(pv), **plan["st"])
            acc = part if acc is None else jax.jit(jnp.add)(acc, part)
        return acc

    return _orchestrate(gpass, plan, np.asarray(amp), T=T, out=out)


def _host_plan(kern, ps, pn, pv, *, T, s0, t0k, fs, cinv, R0, fsr, rtol,
               precision):
    """Host-side planning shared by the local and sharded entry points:
    kernel resampling, wrap-free FFT length, kernel spectrum + band."""
    kern = np.asarray(kern)
    ps = np.asarray(ps, np.float32)
    pn = np.asarray(pn, np.float32)
    pv = np.asarray(pv, np.float32)
    if pn.ndim == 2:
        pn = pn[:, None, :]
    if pv.ndim == 2:
        pv = pv[:, None, :]

    if fsr != 1.0:  # resample kernel to the output rate (host, small)
        from .interp import interp1
        K0 = kern.shape[0]
        Kn = int(np.ceil(K0 / fsr))
        q = jnp.arange(Kn, dtype=jnp.float32) * fsr

        def res(kr):  # real parts only: complex transfers are forbidden
            return np.asarray(interp1(jnp.asarray(kr, jnp.float32), q,
                                      method="lanczos3"))

        if np.iscomplexobj(kern):
            kern = res(kern.real) + 1j * res(kern.imag)
        else:
            kern = res(kern)
    K = kern.shape[0]

    # ---- FFT length from conservative host-side deposit bounds ----
    # box-to-box interval arithmetic (see utils.maths.box_rbounds):
    # O(S + E) host work — the exact per-pair reduction is O(S*E) with
    # multi-hundred-MB f64 temps and was measured at 19 s of HOST time
    # per greens call at S=65536 x 128. Conservative is correct here:
    # L only rounds up to the next power of two.
    from ..utils.maths import box_rbounds
    r1lo, r1hi = box_rbounds(ps, pn)
    r2lo, r2hi = box_rbounds(ps, pv)
    dc = (t0k - s0) * fs
    cinv = float(np.asarray(cinv).reshape(()))
    dmin = cinv * (r1lo + r2lo) * fs + dc
    dmax = cinv * (r1hi + r2hi) * fs + dc
    # [0, T) must be wrap-free: tails past L alias to [0, ...) unless
    # L > dmax + K; deposits before 0 alias to [L + dmin, ...) unless
    # L + dmin >= T. 8-bin guard for band-limited ringing.
    L = int(max(T, dmax + K + 8, T - min(0.0, dmin) + 8))
    L = 1 << int(np.ceil(np.log2(max(2, L))))

    # ---- kernel spectrum and synthesis band (host) ----
    def spec_band(kr):
        Kf = np.fft.rfft(kr, n=L)
        k = np.arange(L // 2 + 1)
        Kf = Kf * np.exp(-2j * np.pi * k * dc / L)  # scalar delay ramp
        return Kf

    if np.iscomplexobj(kern):
        Kr = spec_band(kern.real.astype(np.float64))
        Ki = spec_band(kern.imag.astype(np.float64))
        mag = np.abs(Kr) + np.abs(Ki)
    else:
        Kr = spec_band(kern.astype(np.float64))
        Ki = None
        mag = np.abs(Kr)
    keep = np.nonzero(mag >= rtol * mag.max())[0]
    k0, k1 = (int(keep[0]), int(keep[-1]) + 1) if keep.size else (0, 1)
    F = k1 - k0

    phc = np.float32(2.0 * np.pi * cinv * fs / L)
    st = dict(L=L, k0=k0, F=F, R0=float(R0), fsr=float(fsr),
              precision=precision)
    return dict(ps=ps, pn=pn, pv=pv, phc=phc, st=st, Kr=Kr, Ki=Ki, L=L,
                k0=k0, k1=k1)


def _orchestrate(gpass, plan, amp_c, *, T, out):
    """Run the geometry GEMM pass(es) and synthesize traces — shared by
    the local and shard_map entry points. ``gpass(real_amp) -> (F,N,M,2)``.
    """
    L, k0, k1 = plan["L"], plan["k0"], plan["k1"]
    Kr, Ki = plan["Kr"], plan["Ki"]

    def kf_ri(Kf):
        z = Kf[k0:k1]
        return jnp.asarray(np.stack([z.real, z.imag], -1), jnp.float32)

    cplx = Ki is not None or np.iscomplexobj(amp_c)
    if not cplx:
        G = gpass(amp_c)
        return _synth(G, kf_ri(Kr), L=L, k0=k0, T=T)

    # bilinear decomposition: x = S(kr, ar) - S(ki, ai)
    #                           + i [S(ki, ar) + S(kr, ai)]
    Gr = gpass(np.real(amp_c))
    Gi = gpass(np.imag(amp_c)) if np.iscomplexobj(amp_c) and \
        np.any(np.imag(amp_c)) else None
    kr = kf_ri(Kr)
    ki = kf_ri(Ki) if Ki is not None else None

    xr = _synth(Gr, kr, L=L, k0=k0, T=T)
    xi = _synth(Gr, ki, L=L, k0=k0, T=T) if ki is not None else None
    if Gi is not None:
        p = _synth(Gi, kr, L=L, k0=k0, T=T)
        xi = p if xi is None else jax.jit(jnp.add)(xi, p)
        if ki is not None:
            xr = jax.jit(jnp.subtract)(xr, _synth(Gi, ki, L=L, k0=k0, T=T))
    if xi is None:
        xi = jnp.zeros_like(xr)
    if out == "complex":
        from ..utils.cpx import cjoin
        return cjoin(xr, xi)
    return jnp.stack([xr, xi], axis=-1)  # ri pair
