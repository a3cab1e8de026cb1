"""Benchmark sweeps — the ParTest benchmark suite equivalents
(``/root/reference/test/ParTest.m:244-318``), each emitting one JSON line
per configuration:

  python benches.py das     # s/frame vs image size (DAS_dev_benchmark)
  python benches.py greens  # us/scatterer vs scatterer count
  python benches.py fdtd    # ms/time-step on a 225x225 grid
  python benches.py all

Knobs: QUPS_BENCH_BUDGET (seconds per sweep, default 60 — sweeps stop when
exceeded, like the reference), QUPS_BENCH_TINY=1 (small sizes). Every sweep
needs a GPU and goes through the public ``UltrasoundSystem`` dispatch.
"""
import json
import os
import sys
import time

import numpy as np


def _budget():
    return float(os.environ.get("QUPS_BENCH_BUDGET", "60"))


def _tiny():
    return os.environ.get("QUPS_BENCH_TINY", "") == "1"


def _emit(rec):
    print(json.dumps(rec), flush=True)


def _time(run, reps=3):
    """(median seconds of ``reps`` warm calls, first-call seconds); each
    call ends in ``block_until_ready``."""
    import statistics

    import jax
    t1 = time.perf_counter()
    jax.block_until_ready(run())
    first = time.perf_counter() - t1
    ts = []
    for _ in range(reps):
        t1 = time.perf_counter()
        jax.block_until_ready(run())
        ts.append(time.perf_counter() - t1)
    return statistics.median(ts), first


def _system(N, n):
    """N-element linear array, FSA, n x n pixels over 5-45 mm."""
    from bench import headline_system
    return headline_system(N, n)


def _traces(T, N, M):
    import jax
    import qups_jax as q
    rng = np.random.default_rng(0)
    x = jax.device_put(rng.standard_normal((T, N, M)).astype(np.float32))
    return q.ChannelData(data=x, fs=31.25e6, t0=0.0)


def bench_das():
    """DAS s/frame vs image size: 2^6..2^12 px/side, T=1024, 128x128 tx/rx
    (``ParTest.m:244-271``), through ``UltrasoundSystem.DAS``."""
    T, N = (256, 16) if _tiny() else (1024, 128)
    chd = _traces(T, N, N)
    start = time.time()
    sizes = [64, 128] if _tiny() else [64, 128, 256, 512, 1024, 2048, 4096]
    for n in sizes:
        if time.time() - start > _budget():
            break
        us = _system(N, n)
        try:
            dt, first = _time(lambda: us.DAS(chd, method="linear"))
        except Exception as e:  # pragma: no cover
            _emit({"bench": "das", "n": n, "error": str(e)})
            continue
        _emit({"bench": "das", "metric": "s/frame", "n_px_side": n,
               "value": dt, "first_call_s": first,
               "sums_per_s": n * n * N * N / dt, "T": T, "N": N, "M": N})


def bench_greens():
    """greens us/scatterer: 2^4..2^20 diffuse scatterers, 128x128 elements
    (``ParTest.m:272-284``), through ``UltrasoundSystem.greens`` with each
    engine; stops at the time budget."""
    import qups_jax as q

    N = 16 if _tiny() else 128
    us = _system(N, 8)
    rng = np.random.default_rng(0)
    start = time.time()
    smax = 8 if _tiny() else 20
    impls = (os.environ["QUPS_BENCH_IMPL"],) \
        if os.environ.get("QUPS_BENCH_IMPL") else ("freq", "splat")
    for p in range(4, smax + 1, 2):
        S = 2 ** p
        if time.time() - start > _budget():
            break
        pos = np.stack([rng.uniform(-15e-3, 15e-3, S), np.zeros(S),
                        rng.uniform(15e-3, 45e-3, S)])
        scat = q.Scatterers(pos=pos, c0=1540.0)
        for impl in impls:
            try:
                dt, first = _time(lambda: us.greens(scat, impl=impl).data,
                                  reps=1)
            except Exception as e:  # pragma: no cover
                _emit({"bench": "greens", "impl": impl, "S": S,
                       "error": str(e)})
                continue
            _emit({"bench": "greens", "metric": "us/scatterer", "impl": impl,
                   "S": S, "value": dt / S * 1e6, "s_total": dt,
                   "first_call_s": first, "N": N, "M": N})


def bench_lut():
    """LUT beamforming throughput (``bfDAS``/``bfDASLUT``/``bfEikonal``
    spine, ``UltrasoundSystem.m:4476-4673``): 1024^2 px from 256x256 tx/rx
    geometric delay tables, linear + cubic, through
    ``UltrasoundSystem.bfDASLUT``."""
    import jax.numpy as jnp

    T, N = (256, 16) if _tiny() else (4096, 256)
    n = 128 if _tiny() else 1024
    us = _system(N, n)
    chd = _traces(T, N, N)
    tau_rx, tau_tx = (jnp.asarray(t) for t in us.das_delay_tables())
    for method in ("linear", "cubic"):
        try:
            dt, first = _time(lambda: us.bfDASLUT(chd, tau_rx, tau_tx,
                                                  method=method))
        except Exception as e:  # pragma: no cover
            _emit({"bench": "lut", "method": method, "error": str(e)})
            continue
        _emit({"bench": "lut", "metric": "s/frame", "method": method,
               "value": dt, "first_call_s": first,
               "sums_per_s": n * n * N * N / dt, "n_px_side": n, "T": T,
               "N": N, "M": N})


def bench_focus():
    """focusTx / wsinterpd2 (``interpd.cu:345-396``,
    ``UltrasoundSystem.m:3374-3503``): synthesize M'=128 focused transmits
    (and an M'=1 walking-aperture line) from a (T=4096, N=128, M=128) FSA
    set — the op every non-FSA simulation funnels through."""
    import jax
    import jax.numpy as jnp
    import qups_jax as q

    T, N, M = (256, 16, 16) if _tiny() else (4096, 128, 128)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    xdc = q.TransducerArray(numel=M, pitch=0.2e-3, fc=5e6)
    chd = q.ChannelData(data=jnp.asarray(x), fs=31.25e6, t0=0.0)
    us0 = q.UltrasoundSystem(tx=xdc, rx=xdc,
                             seq=q.Sequence(type="FSA", numpulse=M,
                                            c0=1540.0),
                             scan=q.ScanCartesian(x=np.linspace(-1e-2, 1e-2, 4),
                                                  z=np.linspace(1e-2, 3e-2, 4)),
                             fs=31.25e6)
    # QUPS_BENCH_FOCUS_METHOD picks the method ('auto': the freq GEMM on
    # a GPU)
    meth = os.environ.get("QUPS_BENCH_FOCUS_METHOD", "auto")
    for Mp in (M, 1):
        foc = np.stack([np.linspace(-10e-3, 10e-3, Mp), np.zeros(Mp),
                        np.full(Mp, 30e-3)], 0)
        seq = q.Sequence(type="FC", focus=foc, c0=1540.0)

        def run():
            out = us0.focusTx(chd, seq, method=meth)
            return float(jnp.sum(jnp.abs(out.data)))
        try:
            run()  # compile
            t1 = time.time()
            run()
            dt = time.time() - t1
        except Exception as e:  # pragma: no cover
            _emit({"bench": "focus", "Mp": Mp, "error": str(e)})
            continue
        _emit({"bench": "focus", "metric": "s/focus-synthesis", "value": dt,
               "T": T, "N": N, "M": M, "Mp": Mp, "method": meth,
               "resamples_per_s": T * N * M * Mp / dt})


def bench_coherence():
    """Coherence imaging (``UltrasoundSystem.coherence_image``): keep_rx
    DAS + cohfac/slsc aperture reductions — the BASELINE config-5
    workload (reference: ``kern/slsc.m``/``kern/cohfac.m`` on SYN images
    from ``bf.cu`` flag bit 3). QUPS_BENCH_SIZE=full runs 1024^2 x
    256x256."""
    full = os.environ.get("QUPS_BENCH_SIZE") == "full"
    T, N = (512, 16) if _tiny() else ((4096, 256) if full else (2048, 128))
    n = 128 if _tiny() else (1024 if full else 512)
    us = _system(N, n)
    chd = _traces(T, N, N)
    for post in ("cohfac", "slsc"):
        try:
            dt, first = _time(lambda: us.coherence_image(
                chd, post=post, lags=max(2, N // 8), method="linear"))
        except Exception as e:  # pragma: no cover
            _emit({"bench": "coherence", "which": post, "error": str(e)})
            continue
        _emit({"bench": "coherence", "which": post,
               "metric": "s/frame (keep_rx DAS + reduction)", "value": dt,
               "first_call_s": first, "sums_per_s": n * n * N * N / dt,
               "n_px_side": n, "T": T, "N": N, "M": N})


def bench_adjoint():
    """bfAdjoint at the headline config (1024^2 px from 256x256 tx/rx,
    T=4096): per-frequency steering GEMMs — the most GEMM-bound beamformer
    in the repo (``UltrasoundSystem.m:3770-4050`` hot-paths exactly this,
    bin-thresholded). QUPS_BENCH_ADJ_BINS caps the bin count (default 64,
    the -40 dB band of a 2-cycle pulse at this T)."""
    import jax
    import jax.numpy as jnp
    import qups_jax as q

    T, N, M = (256, 16, 16) if _tiny() else (4096, 256, 256)
    n = 64 if _tiny() else 1024
    nb = int(os.environ.get("QUPS_BENCH_ADJ_BINS", "16" if _tiny()
                            else "64"))
    fs, fc = 31.25e6, 5e6
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    xdc = q.TransducerArray(numel=N, pitch=0.2e-3, fc=fc)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=M, c0=1540.0),
        scan=q.ScanCartesian(x=np.linspace(-12e-3, 12e-3, n),
                             z=np.linspace(5e-3, 45e-3, n)), fs=fs)
    chd = q.ChannelData(data=jnp.asarray(x), fs=fs, t0=0.0)
    # explicit bins around fc: bin selection is shape-affecting, so fixing
    # it keeps the repeated call jit-clean (and the count comparable)
    k0 = int(round(fc / fs * T))
    bins = np.arange(k0 - nb // 2, k0 + nb - nb // 2, dtype=np.int32)

    def run():
        b = us.bfAdjoint(chd, bins=bins)
        return float(jnp.sum(jnp.abs(b)))
    try:
        run()  # compile
        t1 = time.time()
        run()
        dt = time.time() - t1
    except Exception as e:  # pragma: no cover
        _emit({"bench": "adjoint", "error": str(e)})
        return
    # per-bin work: two complex GEMMs, (I,N)x(N,1)-ish steering products
    _emit({"bench": "adjoint", "metric": "s/frame", "value": dt,
           "n_px_side": n, "T": T, "N": N, "M": M, "bins": int(bins.size),
           "pix_bins_per_s": n * n * bins.size / dt})


def bench_refocus():
    """refocus (REFoCUS transmit decoding, ``UltrasoundSystem.m:3505-3768``)
    at full scale: decode a Hadamard-encoded (T=4096, N=256, M=256) set
    back to FSA — the tikhonov per-bin GEMM that gates all encoded-sequence
    work."""
    import jax.numpy as jnp
    import qups_jax as q

    T, N, M = (256, 16, 16) if _tiny() else (4096, 256, 256)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    xdc = q.TransducerArray(numel=M, pitch=0.2e-3, fc=5e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=M, c0=1540.0),
        scan=q.ScanCartesian(x=[0.0], z=[20e-3]), fs=31.25e6)

    def hadamard(n):
        H = np.array([[1.0]])
        while H.shape[0] < n:
            H = np.block([[H, H], [H, -H]])
        return H

    seq_enc = q.Sequence(type="FSA", numpulse=M, c0=1540.0,
                         apd=hadamard(M), del_=np.zeros((M, M)))
    chd = q.ChannelData(data=jnp.asarray(x), fs=31.25e6, t0=0.0)

    from qups_jax.system import _REFOCUS_OP_CACHE

    def run(c):
        dec = us.refocus(c, seq_enc, gamma=0.0)
        return float(jnp.sum(jnp.abs(dec.data)))
    try:
        run(chd)  # compile
        _REFOCUS_OP_CACHE.clear()
        t1 = time.time()
        run(chd)  # full decode: operator build + apply
        dt = time.time() - t1
        # repeated frame, same sequence: the cached decode operator makes
        # this FFT + transmit-GEMM only
        chd2 = chd.replace(data=chd.data * 0.5)
        t1 = time.time()
        run(chd2)
        dt2 = time.time() - t1
    except Exception as e:  # pragma: no cover
        _emit({"bench": "refocus", "error": str(e)})
        return
    _emit({"bench": "refocus", "metric": "s/decode", "value": dt,
           "s_per_decode_cached_op": dt2,
           "T": T, "N": N, "M": M,
           "resamples_per_s": T * N * M * M / dt})


def bench_fdtd():
    """FDTD ms/time-step, 225x225 grid (``ParTest.m:298-318``)."""
    import jax.numpy as jnp
    from qups_jax.sim.fdtd import kspace_sim_2d

    n = 64 if _tiny() else 225
    c0, h = 1500.0, 0.2e-3
    dt = 0.3 * h / c0
    steps = 50 if _tiny() else 400
    cmap = np.full((n, n), c0, np.float32)
    rmap = np.full((n, n), 1000.0, np.float32)
    t = np.arange(steps) * dt
    sig = (np.sin(2 * np.pi * 2e6 * t)
           * np.exp(-((t - 1e-6) / 0.5e-6) ** 2))[:, None].astype(np.float32)
    src = (np.array([20]), np.array([n // 2]))
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=c0, record_rows=(n - 20,))

    def run():
        return float(jnp.sum(jnp.abs(kspace_sim_2d(cmap, rmap, *src, sig,
                                                   **kw))))
    run()
    t1 = time.time()
    run()
    dtw = time.time() - t1
    _emit({"bench": "fdtd", "metric": "ms/step", "grid": [n, n],
           "steps": steps, "value": dtw / steps * 1e3, "s_total": dtw})


def bench_eikonal():
    """MSFM travel-time maps: ms/map vs grid size (the bfEikonal delay
    backbone; the reference logs every kernel family,
    ``ParTest.m:244-318``). Host C++/numpy solver — grid-size sweep."""
    from qups_jax.ops.eikonal import msfm

    sizes = (64, 128) if _tiny() else (128, 256, 512, 1024)
    t_stop = time.time() + _budget()
    for n in sizes:
        if time.time() > t_stop:
            _emit({"bench": "eikonal", "skipped": n, "reason": "budget"})
            break
        F = np.full((n, n), 1540.0)
        F[n // 3:, :] = 1650.0  # heterogeneous layer
        src = np.array([[0, n // 2]])
        msfm(F, 0.2e-3, src)  # warm (native .so load / fallback trace)
        reps = 3
        t1 = time.time()
        for _ in range(reps):
            msfm(F, 0.2e-3, src)
        dt = (time.time() - t1) / reps
        _emit({"bench": "eikonal", "metric": "ms/map", "grid": [n, n],
               "value": dt * 1e3, "cells_per_s": n * n / dt})


def bench_migration():
    """Stolt f-k migration s/frame at the PW headline scale
    (``UltrasoundSystem.m:4740-4860``)."""
    import jax.numpy as jnp
    from qups_jax.ops.fdbf import stolt_migration
    from qups_jax.utils.cpx import ri_split

    T, N, M = (512, 64, 4) if _tiny() else (4096, 256, 16)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    th = np.linspace(-9.0, 9.0, M)
    del_tx = np.zeros((N, M), np.float32)
    import jax

    @jax.jit
    def run(xj):
        img = stolt_migration(xj, 0.0, del_tx, tuple(th), fs=31.25e6,
                              c0=1540.0, pitch=0.15e-3, out="complex")
        return ri_split(img)

    xj = jnp.asarray(x)
    jax.block_until_ready(run(xj))  # compile + warm
    reps = 3
    t1 = time.time()
    for _ in range(reps):
        jax.block_until_ready(run(xj))
    dt = (time.time() - t1) / reps
    _emit({"bench": "migration", "metric": "s/frame", "shape": [T, N, M],
           "value": dt, "pix_tx_per_s": T * N * M / dt})


def main():
    from qups_jax.utils.backend import compile_cache, on_gpu

    if not on_gpu():
        print("benches.py: no GPU found; nothing to measure",
              file=sys.stderr)
        sys.exit(2)
    compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("das", "all"):
        bench_das()
    if which in ("greens", "all"):
        bench_greens()
    if which in ("coherence", "all"):
        bench_coherence()
    if which in ("lut", "all"):
        bench_lut()
    if which in ("focus", "all"):
        bench_focus()
    if which in ("adjoint", "all"):
        bench_adjoint()
    if which in ("refocus", "all"):
        bench_refocus()
    if which in ("fdtd", "all"):
        bench_fdtd()
    if which in ("eikonal", "all"):
        bench_eikonal()
    if which in ("migration", "all"):
        bench_migration()


if __name__ == "__main__":
    main()
