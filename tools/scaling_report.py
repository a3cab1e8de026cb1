"""Multi-device scaling report for the sharded DAS.

Runs on a virtual CPU mesh (no accelerator needed):

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python tools/scaling_report.py

For each mesh size it compiles the sharded DAS program and reports, from
the compiled HLO, the all-reduce (psum) ops inserted, the bytes they
move, and the per-device share of the gather work: the communication
side of strong scaling. These are counts from shapes, not times; a
CPU wall-clock says nothing about the card.

The model it checks: per-device work = I*N*M/(R*X) interp-sums, and one
psum of the I-pixel f32 image over rx, then over tx.
"""
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from qups_jax.ops.das import das
    from qups_jax.parallel import make_mesh

    ndev_all = len(jax.devices())
    rng = np.random.default_rng(0)
    T, N, M, I1, I2 = 512, 32, 8, 64, 128
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    xs = np.linspace(-12e-3, 12e-3, I2)
    zs = np.linspace(5e-3, 45e-3, I1)
    Z, X = np.meshgrid(zs, xs, indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()],
                  -1).astype(np.float32)
    pr = np.stack([np.linspace(-12e-3, 12e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    pv = np.zeros((M, 3), np.float32)
    nv = np.tile([0, 0, 1.0], (M, 1)).astype(np.float32)
    t0 = np.zeros(M, np.float32)

    for ndev in (1, 2, 4, 8):
        if ndev > ndev_all:
            break
        R = min(ndev, 4)
        Xc = ndev // R
        mesh = make_mesh(jax.devices()[:ndev], axes=("rx", "tx"),
                         shape=(R, Xc))

        def local(xl, prl, pvl, nvl, t0l):
            img = das(xl, pi, prl, pvl, nvl, t0l, 1 / 1540.0, fs=4e6,
                      tx_model="plane", method="linear",
                      im_shape=(I1, I2, 1))
            img = jax.lax.psum(img, "rx")
            return jax.lax.psum(img, "tx")

        f = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(None, "rx", "tx"), P("rx", None), P("tx", None),
                      P("tx", None), P("tx")),
            out_specs=P(None, None, None), check_vma=False))
        Nr, Mx = N // R * R, M // Xc * Xc
        xsh = x[:, :Nr, :Mx]
        args = (jnp.asarray(xsh), jnp.asarray(pr[:Nr]),
                jnp.asarray(pv[:Mx]), jnp.asarray(nv[:Mx]),
                jnp.asarray(t0[:Mx]))
        lowered = f.lower(*args)
        compiled = lowered.compile()
        hlo = compiled.as_text()
        ars = re.findall(r"f32\[([\d,]*)\][^\n]*all-reduce", hlo)
        ar_bytes = sum(
            4 * int(np.prod([int(v) for v in s.split(",") if v] or [1]))
            for s in ars)
        out = np.asarray(f(*args))
        per_dev_sums = I1 * I2 * (N // R) * (M // Xc)
        print(json.dumps({
            "devices": ndev, "mesh": {"rx": R, "tx": Xc},
            "all_reduce_ops": len(ars),
            "all_reduce_bytes_per_dev": ar_bytes,
            "per_device_sums": per_dev_sums,
            "sums_fraction": per_dev_sums / (I1 * I2 * N * M),
            "check": float(np.abs(out).sum()),
        }))


if __name__ == "__main__":
    main()
