"""Complex <-> real-pair helpers.

Complex64 crosses jit boundaries and host transfers natively on the CPU
and the GPU. Some interfaces still carry complex data as a real array with
a trailing length-2 axis (``(..., 2)``, "ri format") — the reference's
``float2`` pairs (``/root/reference/src/bf.cu``, ``helper_math.h``); the
helpers here convert between the two, and build complex values from real
parts (``czeros``, ``cexp``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def ri_split(x):
    """Complex array -> real ``(..., 2)`` pair (works on host or device)."""
    xp = np if isinstance(x, np.ndarray) else jnp
    return xp.stack([xp.real(x), xp.imag(x)], axis=-1)


def ri_join(x):
    """Real ``(..., 2)`` pair -> complex array."""
    if isinstance(x, np.ndarray):
        return x[..., 0] + 1j * x[..., 1]
    return jnp.asarray(x)[..., 0] + 1j * jnp.asarray(x)[..., 1]


def to_host(x) -> np.ndarray:
    """Device -> numpy, routing complex arrays through the ri format."""
    if isinstance(x, np.ndarray):
        return x
    if jnp.iscomplexobj(x):
        import jax

        ri = jax.jit(ri_split)(x)
        return ri_join(np.asarray(ri))
    return np.asarray(x)


def to_device_ri(x) -> jnp.ndarray:
    """Host (possibly complex) array -> real ri-format device array."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return jnp.asarray(ri_split(x))
    return jnp.asarray(ri_split(x.astype(np.complex64)))


def czeros(shape):
    """Complex zeros built from real zeros."""
    z = jnp.zeros(shape, jnp.float32)
    import jax

    return jax.lax.complex(z, z)


def cexp(theta):
    """``exp(1j * theta)`` for real ``theta`` from cos/sin."""
    import jax

    return jax.lax.complex(jnp.cos(theta), jnp.sin(theta))


# module-level jit: a fresh ``jax.jit(lambda ...)`` per call would miss the
# jit cache and recompile every call (jit itself is lazy; defining it at
# import costs nothing)
_JOIN = jax.jit(lambda a, b: a + 1j * b)


def cjoin(re, im):
    """Combine device-resident real/imag parts into complex (cached jit)."""
    return _JOIN(re, im)


def to_device(x):
    """Host array -> device array, routing complex uploads through the ri
    format (upload the pair, recombine in a jit). Device arrays pass
    through untouched."""
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        import jax

        return jax.jit(ri_join)(jnp.asarray(ri_split(x)))
    return jnp.asarray(x)
