"""Green's-function point-scatterer simulation.

Equivalent of QUPS's ``greens`` simulator
(``/root/reference/src/UltrasoundSystem.m:463-882`` driving
``src/greens.cu:8-122``). The FSA response is

    x[t, n, m] = sum_s  a_s / (r1' r2' fsr) * wv(t - tau_snm - t0k + s0)

with ``r1 = |p_s - p_rx[n]|``, ``r2 = |p_s - p_tx[m]|``,
``tau_snm = cinv (r1 + r2)``, propagation-loss radii clamped at ``R0``
(``greens.cu:66-74``), and ``wv`` the convolved tx-pulse x tx-impulse x
rx-impulse kernel (``UltrasoundSystem.m:584-588``).

Two implementations:

* :func:`greens_dense` — the direct form: for every output sample, sum the
  interpolated kernel over scatterers. O(T * S * N * M). The parity oracle.
* :func:`greens_splat` — the scatter form: each scatterer deposits its
  interpolation weights into the (T, N, M) grid (a scatter-add over
  scatterer blocks, ``lax.scan`` + ``.at[].add``), then ONE batched FFT
  convolution with the kernel along time. O(S*N*M*taps + T log T * N * M).
  Exactly equal to the direct form when the kernel is sampled at the output
  rate (fsr = 1), because interpolating the kernel at ``t - tau`` with
  method X equals splatting X's weights at ``tau`` and convolving.

The reference's atomicAdd accumulation (``interpd.cu:195-266``) becomes the
scatter-add; across chips the scatterer axis is sharded and partial grids
are ``psum``-reduced (see ``qups_jax.parallel``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .conv import convd
from .interp import _taps, interp1


def _norm3(v, axis=-1):
    return jnp.sqrt(jnp.sum(v * v, axis=axis))


@partial(jax.jit, static_argnames=("T", "fs", "fsr", "method", "block", "R0"))
def greens_splat(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
                 fs: float, cinv, R0: float, fsr: float = 1.0,
                 method: str = "cubic", block: int = 32):
    """Scatter-splat + convolve Green's-function FSA simulation.

    Args:
      kern: sampled waveform kernel (K,) at rate ``fsr * fs`` (real or
        complex) — tx pulse (x) tx impulse (x) rx impulse.
      ps: scatterer positions (S, 3); amp: scatterer amplitudes (S,).
      pn: receiver (sub)element positions (N, E, 3).
      pv: transmit (sub)element positions (M, E, 3).
      T: output sample count; s0: output start time (= n0/fs); t0k: kernel
        start time (wv.t0); fs: output sampling rate; cinv: 1/c0;
      R0: min distance for 1/r propagation loss (0 disables loss).
      fsr: kernel rate / output rate. The splat is exact for fsr == 1; for
        fsr != 1 the kernel is first resampled to the output rate.
      method: interpolation method whose weights are splatted.
      block: scatterers per scan step (memory knob, like the reference's
        ``bsize`` — ``UltrasoundSystem.m:756-762``).

    Returns: FSA data (T, N, M), complex64 if ``kern`` is complex.
    """
    kern = jnp.asarray(kern)
    ps = jnp.asarray(ps, jnp.float32)
    amp = jnp.asarray(amp)
    pn = jnp.asarray(pn, jnp.float32)
    pv = jnp.asarray(pv, jnp.float32)
    N, En = pn.shape[:2]
    M, Em = pv.shape[:2]
    S = ps.shape[0]

    if fsr != 1.0:
        K = kern.shape[0]
        Kn = int(np.ceil(K / fsr))
        kern = interp1(kern, jnp.arange(Kn, dtype=jnp.float32) * fsr, method=method)
    K = kern.shape[0]

    cplx = jnp.iscomplexobj(kern) or jnp.iscomplexobj(amp)
    grid_dtype = jnp.complex64 if cplx else jnp.float32

    # pad scatterers to a block multiple with zero amplitude
    nb = -(-S // block)
    pad = nb * block - S
    ps = jnp.pad(ps, ((0, pad), (0, 0)))
    amp = jnp.pad(amp, (0, pad))
    psb = ps.reshape(nb, block, 3)
    ampb = amp.reshape(nb, block)

    # The splat grid holds kernel-START weights at index ti + K, padded by K
    # bins on the left (kernel starting before t=0 still overlaps the output)
    # and K on the right; fully out-of-range scatterers are masked to zero.
    G = T + 2 * K

    def body(grid, xs):
        psk, ak = xs  # (B, 3), (B,)
        r1 = _norm3(psk[:, None, None, :] - pn[None, :, :, :])  # (B, N, En)
        r2 = _norm3(psk[:, None, None, :] - pv[None, :, :, :])  # (B, M, Em)
        if R0 > 0:
            a1 = 1.0 / jnp.maximum(r1, R0)  # (B, N, En)
            a2 = 1.0 / jnp.maximum(r2, R0)
        else:
            a1 = jnp.ones_like(r1)
            a2 = jnp.ones_like(r2)
        # loop sub-elements (usually 1); accumulate splat weights
        for en in range(En):
            for em in range(Em):
                # delay index of the kernel START for each (s, n, m)
                tau = cinv * (r1[:, :, en, None] + r2[:, None, :, em])  # (B,N,M)
                ti = (tau + t0k - s0) * fs  # fractional output index of kern[0]
                w = (ak[:, None, None] * a1[:, :, en, None]
                     * a2[:, None, :, em] / fsr)  # (B, N, M)
                w = jnp.where((ti > -K - 4) & (ti < T + 4), w, 0)
                b, offs_, ws_, _ = _taps(ti + K, method, G)
                for k, wk in zip(offs_, ws_):
                    idx = jnp.clip(b + k, 0, G - 1)
                    grid = grid.at[idx, jnp.arange(N)[None, :, None],
                                   jnp.arange(M)[None, None, :]].add(
                        (w * wk).astype(grid_dtype))
        return grid, None

    grid0 = jnp.zeros((G, N, M), grid_dtype)
    grid, _ = jax.lax.scan(body, grid0, (psb, ampb))
    # convolve along time; x[t] = sum_g grid[g] kern[t + K - g]
    full = convd(grid, kern.reshape(-1, 1, 1), axis=0, shape="full",
                 method="fft" if K > 64 else "direct")
    return full[K:K + T]


def greens_dense(kern, ps, amp, pn, pv, *, T: int, s0: float, t0k: float,
                 fs: float, cinv, R0: float, fsr: float = 1.0,
                 method: str = "cubic"):
    """Direct (oracle) Green's-function simulation — mirrors
    ``greens.cu:49-85`` exactly: for each output sample s, rx n, tx m, sum
    over scatterers the kernel sampled at ``fsr * (s - (cinv (r1+r2) + t0k -
    s0) fs)``. O(T*S*N*M); use for tests/small sizes."""
    kern = jnp.asarray(kern)
    ps = jnp.asarray(ps, jnp.float32)
    amp = jnp.asarray(amp)
    pn = jnp.asarray(pn, jnp.float32)
    pv = jnp.asarray(pv, jnp.float32)
    N, En = pn.shape[:2]
    M, Em = pv.shape[:2]
    K = kern.shape[0]
    cplx = jnp.iscomplexobj(kern)
    out_dtype = jnp.complex64 if cplx else jnp.float32
    svec = jnp.arange(T, dtype=jnp.float32)  # output sample index

    def per_scat(p, a):
        acc = jnp.zeros((T, N, M), out_dtype)
        for en in range(En):
            for em in range(Em):
                r1 = _norm3(p - pn[:, en, :])  # (N,)
                r2 = _norm3(p - pv[:, em, :])  # (M,)
                tau = cinv * (r1[:, None] + r2[None, :])  # (N, M)
                ti = svec[:, None, None] - (tau + t0k - s0)[None] * fs
                v = interp1(kern, (fsr * ti).reshape(-1), method=method)
                v = v.reshape(T, N, M)
                if R0 > 0:
                    att = a / (jnp.maximum(r1[:, None], R0)
                               * jnp.maximum(r2[None, :], R0))
                else:
                    att = a * jnp.ones((N, M))
                acc = acc + v * (att[None] / fsr).astype(
                    v.real.dtype if not cplx else jnp.float32)
        return acc

    def body(acc, xs):
        p, a = xs
        return acc + per_scat(p, a), None

    init = jnp.zeros((T, N, M), out_dtype)
    out, _ = jax.lax.scan(body, init, (ps, amp))
    return out
