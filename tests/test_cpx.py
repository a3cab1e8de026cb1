"""utils.cpx constructors: czeros/cexp/to_device/to_host must be
numerically identical to the plain complex forms."""
import numpy as np
import jax
import jax.numpy as jnp

from qups_jax.utils.cpx import (cexp, czeros, ri_join, ri_split, to_device,
                                to_host)


def test_czeros():
    z = czeros((3, 4))
    assert z.dtype == jnp.complex64 and z.shape == (3, 4)
    assert np.all(np.asarray(to_host(z)) == 0)


def test_cexp_matches_exp():
    th = jnp.asarray(np.linspace(-7, 7, 41), jnp.float32)
    a = to_host(cexp(th))
    b = np.exp(1j * np.linspace(-7, 7, 41)).astype(np.complex64)
    np.testing.assert_allclose(a, b, atol=2e-7)


def test_cexp_inside_jit():
    f = jax.jit(lambda t: jnp.abs(cexp(t) * (1 + 2j)))
    np.testing.assert_allclose(np.asarray(f(jnp.asarray([0.0, 1.0]))),
                               np.sqrt(5.0) * np.ones(2), rtol=1e-6)


def test_to_device_roundtrip_complex():
    z = (np.arange(6) + 1j * np.arange(6, 0, -1)).astype(np.complex64)
    d = to_device(z)
    assert jnp.iscomplexobj(d)
    np.testing.assert_allclose(to_host(d), z)


def test_ri_pair_roundtrip():
    z = (np.random.default_rng(0).standard_normal((4, 5))
         + 1j * np.random.default_rng(1).standard_normal((4, 5))
         ).astype(np.complex64)
    np.testing.assert_allclose(ri_join(ri_split(z)), z)
