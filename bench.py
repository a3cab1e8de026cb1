"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline (BASELINE.md): the 1024^2-pixel DAS image from 256x256 tx/rx
channel data, cubic sampler (the reference default), through the public
``UltrasoundSystem.DAS`` dispatch. The reference's published figure is
< 2 s on an RTX 3070 (``README.md:29``), i.e. 3.436e10 pixel*tx*rx sums/s;
``vs_baseline`` is our sums/s over that number.

It needs a GPU and exits non-zero without one: a CPU number is no device
metric. Run on the card with ``python bench.py``.

Environment knobs:
  QUPS_BENCH_SIZE   = full | medium | small  (default: full)
  QUPS_BENCH_REPS   = timed repetitions (default 5; the median is reported)
  QUPS_BENCH_METHOD = sampler (default cubic)
  QUPS_BENCH_MESH   = "rx2,tx2" — beamform on an (rx, tx) device mesh
      (``parallel.das_sharded``) and report aggregate sums/s.
"""
import json
import os
import statistics
import sys
import time

import numpy as np

BASELINE_SUMS_PER_S = 1024**2 * 256**2 / 2.0  # RTX 3070, README.md:29


def headline_system(N: int, n: int):
    """An N-element linear array (L11-5v elements), FSA with N transmits,
    and an n x n scan over 5-45 mm depth."""
    import qups_jax as q

    base = q.TransducerArray.L11_5v()
    xdc = q.TransducerArray(fc=base.fc, bw=base.bw, width=base.width,
                            height=base.height, numel=N, pitch=base.pitch,
                            el_focus=base.el_focus)
    half = (N - 1) * base.pitch / 2
    scan = q.ScanCartesian(x=np.linspace(-half, half, n),
                           z=np.linspace(5e-3, 45e-3, n))
    return q.UltrasoundSystem(tx=xdc, rx=xdc, scan=scan,
                              seq=q.Sequence(type="FSA", numpulse=N,
                                             c0=1540.0))


def main():
    import jax
    import jax.numpy as jnp

    import qups_jax as q
    from qups_jax.utils.backend import compile_cache, device_record, on_gpu

    if not on_gpu():
        print("bench.py: no GPU found; nothing to measure", file=sys.stderr)
        sys.exit(2)
    compile_cache()
    size = os.environ.get("QUPS_BENCH_SIZE", "full")
    reps = int(os.environ.get("QUPS_BENCH_REPS", "5"))
    method = os.environ.get("QUPS_BENCH_METHOD", "cubic")
    T, N, n = {"small": (1024, 64, 256), "medium": (2048, 128, 512),
               "full": (4096, 256, 1024)}[size]
    us = headline_system(N, n)
    rng = np.random.default_rng(0)
    x = jax.device_put(rng.standard_normal((T, N, N)).astype(np.float32))
    chd = q.ChannelData(data=x, fs=float(us.fs), t0=0.0)
    sums = n * n * N * N

    mesh_spec = os.environ.get("QUPS_BENCH_MESH", "")
    if mesh_spec:
        from qups_jax.parallel import das_sharded, make_mesh
        shape = {}
        for part in mesh_spec.split(","):
            k = part.rstrip("0123456789")
            shape[k] = int(part[len(k):] or 1)
        ndev = int(np.prod(list(shape.values())))
        mesh = make_mesh(jax.devices()[:ndev], axes=tuple(shape),
                         shape=tuple(shape.values()))
        pv, nv, model = us._tx_geometry()

        def run():
            return das_sharded(mesh, x, us._pixels(), us.rx.positions().T,
                               pv, nv, 0.0, np.float32(1 / 1540.0),
                               fs=float(us.fs), tx_model=model,
                               method=method)
    else:
        ndev = 1

        def run():
            return us.DAS(chd, method=method)

    t = time.perf_counter()
    chk = float(jnp.sum(jnp.abs(jax.block_until_ready(run()))))
    first_s = time.perf_counter() - t
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t)
    dt = statistics.median(times)
    print(json.dumps({
        "metric": "DAS beamform throughput (pixel*tx*rx sums/s, "
                  f"{method} sampler)",
        "value": sums / dt,
        "unit": "sums/s",
        "vs_baseline": sums / dt / BASELINE_SUMS_PER_S,
        "detail": {"size": size, "T": T, "N": N, "M": N, "pixels": n * n,
                   "latency_s": dt, "times_s": times,
                   "first_call_s": first_s, "devices": ndev,
                   "check": chk},
        "device": device_record(),
    }))


if __name__ == "__main__":
    main()
