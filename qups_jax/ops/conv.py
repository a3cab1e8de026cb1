"""Batched 1-D convolution / cross-correlation.

Equivalent of QUPS's ``convd`` kernel family
(``/root/reference/src/convd.cu:95-156``, dispatched by ``kern/convd.m``):
1-D convolution along one axis with broadcast batching and ``full | same |
valid`` output shapes with lag bookkeeping (``kern/convd.m:103-110``).

Two execution strategies, selected automatically:

* **direct** — sliding-window multiply-add over the kernel taps, fully
  vectorized over batch dims. Best for short kernels.
* **fft** — FFT overlap multiply (O(N log N)), complex-safe. Best for long
  kernels. On a sharded time axis the halo contract is handled by the caller
  (see ``qups_jax.parallel``).
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np


def conv_lag0(nx: int, ny: int, shape: str) -> int:
    """Starting lag (offset into the full convolution) for an output shape.

    full: 0; same: floor(ny/2) (MATLAB ``conv(..., 'same')`` centering);
    valid: ny - 1.
    """
    if shape == "full":
        return 0
    if shape == "same":
        return (ny - 1) // 2
    if shape == "valid":
        return ny - 1
    raise ValueError(shape)


def conv_len(nx: int, ny: int, shape: str) -> int:
    return {"full": nx + ny - 1, "same": nx, "valid": max(0, nx - ny + 1)}[shape]


def _move_last(x, axis):
    return jnp.moveaxis(jnp.asarray(x), axis, -1)


def convd(x, y, axis: int = 0, shape: str = "full", method: str = "auto"):
    """Convolve ``x`` with ``y`` along ``axis``; other dims broadcast.

    Returns an array whose ``axis`` has length ``conv_len(nx, ny, shape)``;
    non-axis dims are the broadcast of the operands' batch dims.

    Example:
        import numpy as np
        from qups_jax.ops import convd
        x = np.random.default_rng(0).standard_normal((32, 3)).astype(np.float32)
        k = np.hanning(7).astype(np.float32)[:, None]
        y = np.asarray(convd(x, k, axis=0, shape="full"))
        ref = np.stack([np.convolve(x[:, c], k[:, 0]) for c in range(3)], -1)
        assert y.shape == (38, 3) and np.allclose(y, ref, atol=1e-4)
    """
    xm = _move_last(x, axis)
    ym = _move_last(y, axis)
    nx, ny = xm.shape[-1], ym.shape[-1]
    if method == "auto":
        method = "direct" if min(nx, ny) <= 64 else "fft"
    nfull = nx + ny - 1
    if method == "fft":
        L = nfull
        Xf = jnp.fft.fft(xm, n=L, axis=-1)
        Yf = jnp.fft.fft(ym, n=L, axis=-1)
        full = jnp.fft.ifft(Xf * Yf, axis=-1)
        if not (jnp.iscomplexobj(xm) or jnp.iscomplexobj(ym)):
            full = full.real.astype(jnp.result_type(xm.dtype, ym.dtype))
    else:
        # direct: full[l] = sum_k x[l - k] * y[k]
        if ny <= nx:
            a, b, na, nb = xm, ym, nx, ny
        else:
            a, b, na, nb = ym, xm, ny, nx
        ap = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(nb - 1, nb - 1)])
        # out[l] = sum_k ap[l + (nb-1) - k] * b[k], l in [0, nfull)
        acc = None
        for k in range(nb):
            seg = jnp.roll(ap, k, axis=-1)[..., nb - 1: nb - 1 + nfull]
            term = seg * b[..., k: k + 1]
            acc = term if acc is None else acc + term
        full = acc
    l0 = conv_lag0(nx, ny, shape)
    n = conv_len(nx, ny, shape)
    out = full[..., l0: l0 + n]
    return jnp.moveaxis(out, -1, axis % np.ndim(x) if np.ndim(x) else 0)


def xcorr(x, y, axis: int = 0, shape: str = "full", method: str = "auto"):
    """Cross-correlation ``x (*) conj(reverse(y))`` along ``axis``."""
    ym = jnp.flip(jnp.conj(jnp.asarray(y)), axis=axis)
    return convd(x, ym, axis=axis, shape=shape, method=method)
