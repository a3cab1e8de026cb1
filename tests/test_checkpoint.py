"""Orbax checkpoint round-trips, including mesh-sharded arrays on the
virtual 8-device CPU mesh (SURVEY §5: checkpointing of sim outputs)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qups_jax.io import save_checkpoint, load_checkpoint


def test_checkpoint_pytree_roundtrip(tmp_path):
    tree = {"img": np.arange(12.0).reshape(3, 4),
            "meta": {"fs": np.float32(31.25e6)}}
    p = str(tmp_path / "ckpt")
    save_checkpoint(p, tree)
    back = load_checkpoint(p)
    assert np.allclose(back["img"], tree["img"])
    assert np.isclose(back["meta"]["fs"], tree["meta"]["fs"])


def test_checkpoint_sharded_roundtrip(tmp_path):
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs a multi-device mesh")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(devs[:2]), ("rx",))
    sh = NamedSharding(mesh, P("rx"))
    x = jax.device_put(jnp.arange(16.0).reshape(2, 8), sh)
    p = str(tmp_path / "ckpt_sharded")
    save_checkpoint(p, {"chd": x})
    like = {"chd": jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sh)}
    back = load_checkpoint(p, like=like)
    assert back["chd"].sharding == sh
    assert np.allclose(np.asarray(back["chd"]), np.asarray(x))
    # and without a template: host numpy
    host = load_checkpoint(p)
    assert np.allclose(host["chd"], np.asarray(x))
