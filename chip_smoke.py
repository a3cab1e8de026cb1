"""On-card smoke test of the main path: simulate -> beamform on one GPU.

    python chip_smoke.py          # one GPU: the phases below
    python chip_smoke.py --four   # four GPUs: the sharded DAS and the
                                  # sharded simulation vs one card

Phases, in one process:
  1. device: refuse to run without a GPU; print the card, its power
     limit (nvidia-smi) and the compile-cache directory;
  2. simulate: a 256-element L11-5v array, FSA (256 tx x 256 rx), nine
     point targets and 2^16 diffuse scatterers through ``us.greens``;
     echo times against the analytic time of flight, and a sub-aperture
     against the float64 numpy oracle of the frequency-domain engine;
  3. beamform: ``us.DAS`` (cubic) onto 1024 x 1024 pixels; PSF peaks
     against the targets, and the image against the XLA scan
     (``kernel="xla"``);
  4. timings and memory (earlier lines, each with the card beside it);
  5. every other public entry point once, each with its oracle or a
     finiteness check;
  6. the tests marked ``gpu`` (pytest, in this process).
The last line is one JSON object; any failure exits non-zero.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

C0 = 1540.0
TARGETS = np.array([[x, 0.0, z] for z in (15e-3, 25e-3, 35e-3)
                    for x in (-10e-3, 0.0, 10e-3)])
# tolerances (BASELINE.md): echo time within 1.1 samples, PSF peak within
# 1.1 mm; engine vs float64 oracle and kernel vs XLA scan (relative)
TOL_TOF_SAMPLES = 1.1
TOL_PSF_M = 1.1e-3
# relative L2; on an H100 full-f32 GEMMs read 4.8e-5 and TF32 GEMMs 2.8e-4
TOL_GREENS_ORACLE = 1.2e-4
TOL_GREENS_CARDS = 1e-4    # max |diff| / max |ref|, four cards vs one
TOL_DAS_XLA = 1e-4         # relative L2; both f32, other summation order


class Smoke:
    """Phase bookkeeping: every failure is printed and counted."""

    def __init__(self, card: str):
        self.card = card
        self.failed = []

    def step(self, name, fn):
        t = time.perf_counter()
        try:
            out = fn()
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            print(f"FAIL {name}", flush=True)
            return None
        print(f"ok   {name} ({time.perf_counter() - t:.3f} s)", flush=True)
        return out

    def check(self, cond: bool, msg: str):
        if not cond:
            raise AssertionError(msg)

    def time(self, label: str, seconds):
        print(f"time {label}: {seconds} [{self.card}]", flush=True)


def card_name_and_power() -> str:
    """``name, power.limit`` from nvidia-smi, read by a child process
    that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def blocked(fn):
    """Seconds of one call of ``fn`` ended by block_until_ready."""
    import jax
    t = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t


# ------------------------------------------------------------------ phase 2
def headline_system():
    import qups_jax as q
    base = q.TransducerArray.L11_5v()
    xdc = q.TransducerArray(fc=base.fc, bw=base.bw, width=base.width,
                            height=base.height, numel=256, pitch=base.pitch,
                            el_focus=base.el_focus)
    scan = q.ScanCartesian(x=np.linspace(-20e-3, 20e-3, 1024),
                           z=np.linspace(8e-3, 42e-3, 1024))
    return q.UltrasoundSystem(tx=xdc, rx=xdc, scan=scan,
                              seq=q.Sequence(type="FSA", numpulse=256,
                                             c0=C0))


def phantom(seed: int = 0, n_diffuse: int = 2**16):
    import qups_jax as q
    rng = np.random.default_rng(seed)
    pos = np.concatenate([
        TARGETS.T,
        np.stack([rng.uniform(-20e-3, 20e-3, n_diffuse),
                  np.zeros(n_diffuse),
                  rng.uniform(10e-3, 42e-3, n_diffuse)])], axis=1)
    # point targets well above the speckle (a single trace sums the
    # diffuse echoes of a whole range shell)
    amp = np.concatenate([np.ones(len(TARGETS)),
                          0.002 * rng.standard_normal(n_diffuse)])
    return q.Scatterers(pos=pos, amp=amp.astype(np.float32), c0=C0)


def envelope(v):
    """|analytic signal| of a real sequence, or |v| of a complex one."""
    v = np.asarray(v)
    if np.iscomplexobj(v):
        return np.abs(v)
    spec = np.fft.fft(v)
    spec[v.size // 2:] = 0
    return np.abs(np.fft.ifft(2 * spec))


def peak_index(env, lo: int = 0, hi=None) -> float:
    """Sub-sample index of the envelope peak in [lo, hi) (parabolic fit
    through the largest sample and its neighbours)."""
    k = lo + int(np.argmax(env[lo:hi]))
    if 0 < k < env.size - 1:
        a, b, c = env[k - 1], env[k], env[k + 1]
        den = a - 2 * b + c
        if den < 0:
            return k + 0.5 * (a - c) / den
    return float(k)


def pulse_envelope_peak(us) -> float:
    """Time of the envelope peak of the two-way kernel the simulator
    deposits (``UltrasoundSystem.greens``), relative to the echo's delay."""
    import dataclasses
    wv = us.rx.impulse.conv(us.tx.impulse.conv(us.seq.pulse, us.fs), us.fs)
    wv = dataclasses.replace(wv, fs=us.fs)
    return float(wv.t0) + peak_index(envelope(wv.samples)) / us.fs


def echo_oracle(s: Smoke, us, chd):
    """Each target's echo on the element pair nearest above it peaks at
    the analytic time of flight (within 1.1 samples)."""
    x = np.asarray(chd.data)
    t0 = float(np.asarray(chd.t0_host).reshape(-1)[0])
    pe = us.rx.positions()
    dpk = pulse_envelope_peak(us)
    worst = 0.0
    for tgt in TARGETS:
        n = int(np.argmin(np.abs(pe[0] - tgt[0])))
        tof = 2 * np.linalg.norm(tgt - pe[:, n]) / C0 + dpk
        env = envelope(x[:, n, n])
        k0 = int(round((tof - t0) * chd.fs))
        k = peak_index(env, max(k0 - 40, 0), min(k0 + 41, env.size))
        err = abs(t0 + k / chd.fs - tof) * chd.fs
        worst = max(worst, err)
        s.check(err <= TOL_TOF_SAMPLES,
                f"echo of {tgt} off by {err:.2f} samples")
    print(f"echo-time error, worst of 9 targets: {worst:.3f} samples "
          f"(limit {TOL_TOF_SAMPLES})")


def greens_oracle(s: Smoke, us):
    """A 32 x 32 sub-aperture with the point targets only, at the real fs
    and T, against the float64 numpy oracle of the engine."""
    import dataclasses

    import importlib.util

    import qups_jax as q
    spec = importlib.util.spec_from_file_location(
        "_greens_oracle", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests", "test_greens_freq.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    numpy_freq_oracle = mod.numpy_freq_oracle
    xdc = us.rx
    sub = q.TransducerArray(fc=xdc.fc, bw=xdc.bw, width=xdc.width,
                            height=xdc.height, numel=32, pitch=xdc.pitch,
                            el_focus=xdc.el_focus)
    us_s = us.replace(tx=sub, rx=sub,
                      seq=q.Sequence(type="FSA", numpulse=32, c0=C0))
    scat = q.Scatterers(pos=TARGETS.T, c0=C0)
    chd = us_s.greens(scat, impl="freq")  # the default engine on a GPU
    wv = sub.impulse.conv(sub.impulse.conv(us_s.seq.pulse, us.fs), us.fs)
    wv = dataclasses.replace(wv, fs=us.fs)
    pe = sub.positions().T[:, None, :].astype(np.float32)
    want = numpy_freq_oracle(
        np.asarray(wv.samples), TARGETS.astype(np.float32),
        np.ones(len(TARGETS), np.float32), pe, pe, T=chd.T,
        s0=float(np.asarray(chd.t0_host)[0]), t0k=float(wv.t0),
        fs=float(us.fs), cinv=1 / C0, R0=float(us_s.lmbda))
    def errors(got):
        d = np.asarray(got) - want
        return (float(np.abs(d).max() / np.abs(want).max()),
                float(np.linalg.norm(d) / np.linalg.norm(want)))
    err, l2 = errors(chd.data)
    print(f"greens vs float64 oracle (32x32, T={chd.T}, fs={us.fs:.6g}, "
          f"f32 GEMMs at Precision.HIGHEST): max rel err {err:.3e}, "
          f"relative L2 {l2:.3e} (limit {TOL_GREENS_ORACLE})")
    # what the limit guards against: the same run at the GPU's default
    # matmul precision (TF32 GEMMs)
    err_tf, l2_tf = errors(us_s.greens(scat, impl="freq",
                                       precision="default").data)
    print(f"greens vs float64 oracle at the default matmul precision "
          f"(TF32 GEMMs): max rel err {err_tf:.3e}, relative L2 "
          f"{l2_tf:.3e}")
    s.check(l2 < TOL_GREENS_ORACLE, f"greens oracle relative L2 {l2:.3e}")


# ------------------------------------------------------------------ phase 3
def image_of(us, b):
    """|image| on the scan grid: kept rx/tx axes summed, frames dropped."""
    b = np.asarray(b)
    nd = len(us.scan.shape)
    b = b.reshape(b.shape[:nd] + (-1,)).sum(-1)
    return np.abs(b)


def psf_errors(us, img, targets, win=3e-3):
    P = us.scan.positions().reshape(3, -1)
    a = img.reshape(-1)
    errs = []
    for tgt in targets:
        near = np.all(np.abs(P - tgt[:, None]) <= win, axis=0)
        k = int(np.argmax(np.where(near, a, -np.inf)))
        errs.append(float(np.linalg.norm(P[:, k] - tgt)))
    return errs


def psf_oracle(s: Smoke, us, b, targets, label):
    errs = psf_errors(us, image_of(us, b), targets)
    print(f"{label}: PSF peak offset, worst of {len(errs)}: "
          f"{1e3 * max(errs):.3f} mm (limit {1e3 * TOL_PSF_M} mm)")
    s.check(max(errs) <= TOL_PSF_M, f"{label}: PSF off by {max(errs)}")


def das_phase(s: Smoke, us, chd, reps: int = 5):
    import jax
    import jax.numpy as jnp

    from qups_jax.ops.das import das
    from qups_jax.ops.das_fused import das_kernel

    t = time.perf_counter()
    b = jax.block_until_ready(us.DAS(chd))
    s.time("DAS kernel (cubic) first call incl. compile",
           f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    ref = jax.block_until_ready(us.DAS(chd, kernel="xla"))
    s.time("DAS XLA scan (cubic) first call incl. compile",
           f"{time.perf_counter() - t:.3f} s")
    psf_oracle(s, us, b, TARGETS, "DAS 1024x1024 (kernel)")
    bk, bx = np.asarray(b).ravel(), np.asarray(ref).ravel()
    rel = float(np.linalg.norm(bk - bx) / np.linalg.norm(bx))
    print(f"DAS kernel vs XLA scan: relative L2 {rel:.3e} "
          f"(limit {TOL_DAS_XLA})")
    s.check(rel < TOL_DAS_XLA, f"kernel vs XLA rel L2 {rel:.3e}")
    del b, ref, bk, bx

    bk = np.asarray(us.DAS(chd, method="linear")).ravel()
    bx = np.asarray(us.DAS(chd, method="linear", kernel="xla")).ravel()
    rel = float(np.linalg.norm(bk - bx) / np.linalg.norm(bx))
    print(f"DAS kernel vs XLA scan, linear: relative L2 {rel:.3e} "
          f"(limit {TOL_DAS_XLA})")
    s.check(rel < TOL_DAS_XLA, f"linear kernel vs XLA rel L2 {rel:.3e}")
    del bk, bx

    runs = {(m, k): [] for m in ("cubic", "linear") for k in ("auto", "xla")}
    for _ in range(reps):  # the four paths alternate
        for (m, k), ts in runs.items():
            ts.append(blocked(lambda: us.DAS(chd, method=m, kernel=k)))
    for (m, k), ts in runs.items():
        name = "DAS kernel" if k == "auto" else "DAS XLA scan"
        s.time(f"{name} ({m}) median of {reps}",
               f"{statistics.median(ts):.4f} s {[round(v, 4) for v in ts]}")

    pv, nv, model = us._tx_geometry()
    args = (us._pixels(), us.rx.positions().T, pv, nv, chd.t0_host,
            np.float32(1 / C0))
    kw = dict(fs=float(chd.fs), tx_model=model, method="cubic")
    for name, fn in (("kernel", lambda x: das_kernel(x, *args, **kw)),
                     ("XLA scan", lambda x: das(x, *args, **kw))):
        ma = jax.jit(fn).lower(jnp.asarray(chd.data)).compile() \
            .memory_analysis()
        print(f"memory_analysis DAS {name}: temp {ma.temp_size_in_bytes} B, "
              f"arguments {ma.argument_size_in_bytes} B, "
              f"output {ma.output_size_in_bytes} B")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
          f"[{s.card}]")


# ------------------------------------------------------------------ phase 5
def entry_points(s: Smoke):
    import qups_jax as q
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    seq = q.Sequence(type="FSA", numpulse=16, c0=C0)
    scan = q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 24),
                           z=np.linspace(18e-3, 24e-3, 24))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=12e6)
    tgt = np.array([[0.0, 0.0, 21e-3]])
    scat = q.Scatterers(pos=tgt.T, c0=C0)
    chd = us.greens(scat)

    def finite(x):
        x = np.asarray(x)
        s.check(np.isfinite(x).all() and np.abs(x).max() > 0,
                "not finite or all zero")
        return x

    def psf(b, label, u=us, t=tgt):
        finite(b)
        psf_oracle(s, u, b, t, label)

    def simus():
        c = us.simus(scat)
        x = finite(c.data)[:, 8, 8]
        t = np.asarray(c.time).reshape(-1)[np.argmax(np.abs(x))]
        tof = 2 * np.linalg.norm(tgt[0] - us.rx.positions()[:, 8]) / C0
        s.check(abs(t - tof) < 1.5 / xdc.fc, f"simus echo at {t}, {tof}")

    def das_vol():
        mat = q.TransducerMatrix(numd=(8, 8), pitch2=(0.3e-3, 0.3e-3),
                                 fc=3e6)
        scan3 = q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 9),
                                y=np.linspace(-2e-3, 2e-3, 9),
                                z=np.linspace(18e-3, 24e-3, 13))
        us3 = q.UltrasoundSystem(
            tx=mat, rx=mat, seq=q.Sequence(type="FSA", numpulse=64, c0=C0),
            scan=scan3, fs=12e6)
        psf(us3.DAS(us3.greens(scat)), "DAS volumetric", u=us3)

    def das_bsize():
        a = np.asarray(us.DAS(chd, bsize=4))
        b = np.asarray(us.DAS(chd))
        s.check(np.abs(a - b).max() <= 1e-4 * np.abs(b).max(),
                "bsize blocks differ from one call")
        psf(a, "DAS bsize")

    def das_cmap():
        cm = np.full(us.scan.shape, C0, np.float32)
        a = np.asarray(us.DAS(chd, c0=cm))
        b = np.asarray(us.DAS(chd))
        s.check(np.abs(a - b).max() <= 1e-4 * np.abs(b).max(),
                "uniform c map differs from scalar c")
        psf(a, "DAS per-pixel c")

    def adjoint():
        psf(us.bfAdjoint(chd), "bfAdjoint")

    seq_pw = q.SequenceRadial(type="PW", angles=[-5.0, 0.0, 5.0], c0=C0)

    def migration():
        us_pw = us.replace(seq=seq_pw)
        img, _ = us_pw.bfMigration(us.focusTx(chd, seq_pw))
        psf(img, "bfMigration")

    def focus_refocus():
        enc = us.focusTx(chd, seq_pw)
        finite(enc.data)
        dec = us.replace(seq=seq_pw).refocus(enc)
        psf(us.DAS(dec), "focusTx + refocus -> DAS")

    def coherence():
        for post in ("cohfac", "slsc"):
            c = finite(us.coherence_image(chd, post=post, lags=4))
            s.check(c.shape == us.scan.shape, "coherence image shape")
            if post == "cohfac":
                s.check(c.max() <= 1 + 1e-5, "cohfac above 1")

    def kwave():
        med = q.Medium(c0=C0, rho0=1000.0)
        cgrd = q.ScanCartesian(x=np.arange(-4e-3, 4e-3, 0.25e-3), y=[0.0],
                               z=np.arange(-1e-3, 8e-3, 0.25e-3))
        finite(us.kspaceFirstOrder(med, cgrd, tmax=4e-6).data)

    def hilbert_downmix():
        h = chd.hilbert()
        env = np.abs(np.asarray(h.data))[:, 8, 8]
        t = np.asarray(h.time).reshape(-1)
        tof = 2 * np.linalg.norm(tgt[0] - us.rx.positions()[:, 8]) / C0
        s.check(abs(t[np.argmax(env)] - tof) < 1.5 / xdc.fc,
                "hilbert envelope peak off the echo time")
        finite(h.downmix(float(xdc.fc)).data)

    steps = [
        ("simus", simus),
        ("calc_hp", lambda: finite(us.calc_hp(scan))),
        ("DAS", lambda: psf(us.DAS(chd), "DAS")),
        ("DAS keep_rx", lambda: psf(us.DAS(chd, keep_rx=True),
                                    "DAS keep_rx")),
        ("DAS bsize", das_bsize),
        ("DAS keep_rx+keep_tx", lambda: psf(
            us.DAS(chd, keep_rx=True, keep_tx=True), "DAS keep-both")),
        ("DAS per-pixel c", das_cmap),
        ("DAS volumetric", das_vol),
        ("bfDAS", lambda: psf(us.bfDAS(chd), "bfDAS")),
        ("bfDASLUT", lambda: psf(us.bfDASLUT(chd, *us.das_delay_tables()),
                                 "bfDASLUT")),
        ("bfAdjoint", adjoint),
        ("bfMigration", migration),
        ("bfEikonal", lambda: psf(us.bfEikonal(chd, q.Medium(c0=C0)),
                                  "bfEikonal")),
        ("focusTx + refocus", focus_refocus),
        ("coherence_image cohfac+slsc", coherence),
        ("kspaceFirstOrder", kwave),
        ("hilbert + downmix", hilbert_downmix),
    ]
    for name, fn in steps:
        s.step(f"entry point: {name}", fn)


# ------------------------------------------------------------------ --four
def four_cards(s: Smoke):
    """The sharded DAS at the headline on an (rx=2, tx=2) mesh and the
    sharded simulation at the phase-2 size, each against one card."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qups_jax.parallel import das_sharded, make_mesh
    devs = jax.devices()
    s.check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    mesh = make_mesh(devs, axes=("rx", "tx"), shape=(2, 2))
    us = headline_system()
    scat = phantom()
    with jax.default_device(devs[0]):
        chd = jax.block_until_ready(us.greens(scat))
        ref = np.asarray(us.DAS(chd))
    t = time.perf_counter()
    chd4 = jax.block_until_ready(us.greens(scat, mesh=mesh))
    s.time("greens sharded over 4 cards, first call",
           f"{time.perf_counter() - t:.3f} s")
    print(f"sharded greens output sharding: {chd4.data.sharding}")
    s.check(len(chd4.data.sharding.device_set) == 4,
            "sharded greens output is not spread over 4 cards")
    a, b = np.asarray(chd4.data), np.asarray(chd.data)
    err = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"greens 4 cards vs 1 card: max rel diff {err:.3e} "
          f"(limit {TOL_GREENS_CARDS})")
    s.check(err < TOL_GREENS_CARDS, f"sharded greens differs: {err}")
    del a, b, chd4

    x = jax.device_put(np.asarray(chd.data),
                       NamedSharding(mesh, P(None, "rx", "tx")))
    shards = {sh.device.id: sh.data.shape for sh in x.addressable_shards}
    print(f"traces placed per mesh: {shards}")
    s.check(len(shards) == 4 and all(v == (chd.T, chd.N // 2, chd.M // 2)
                                     for v in shards.values()),
            "traces are not split rx x tx over 4 cards")
    pv, nv, model = us._tx_geometry()

    def run():
        return das_sharded(mesh, x, us._pixels(), us.rx.positions().T, pv,
                           nv, chd.t0_host, np.float32(1 / C0),
                           fs=float(chd.fs), tx_model=model,
                           method="cubic")
    t = time.perf_counter()
    img = jax.block_until_ready(run())
    s.time("DAS sharded rx2 x tx2 first call incl. compile",
           f"{time.perf_counter() - t:.3f} s")
    img = np.asarray(img).reshape(ref.shape)
    rel = float(np.linalg.norm(img - ref) / np.linalg.norm(ref))
    print(f"DAS 4 cards vs 1 card: relative L2 {rel:.3e} "
          f"(limit {TOL_DAS_XLA})")
    s.check(rel < TOL_DAS_XLA, f"sharded DAS differs: {rel}")
    psf_oracle(s, us, img.reshape(us.scan.shape + (1, 1)), TARGETS,
               "DAS sharded")
    ts = [blocked(run) for _ in range(5)]
    s.time("DAS sharded rx2 x tx2 median of 5",
           f"{statistics.median(ts):.4f} s {[round(v, 4) for v in ts]}")


# -------------------------------------------------------------------- main
def main(argv):
    four = "--four" in argv
    from qups_jax.utils.backend import compile_cache, device_record, on_gpu
    if not on_gpu():
        print("chip_smoke.py: JAX finds no GPU; refusing to run on the "
              "CPU", file=sys.stderr)
        return 2
    card = card_name_and_power()
    dev = device_record()
    print(f"device {dev['kind']} x{dev['count']}")
    print(card)
    print(f"compile cache: {compile_cache()}")
    s = Smoke(card)

    if four:
        s.step("four cards: sharded greens and DAS vs one card",
               lambda: four_cards(s))
    else:
        us = headline_system()
        scat = phantom()
        state = {}

        def simulate():
            import jax
            t = time.perf_counter()
            chd = jax.block_until_ready(us.greens(scat))
            s.time("greens first call incl. compile",
                   f"{time.perf_counter() - t:.3f} s")
            print(f"channel data {chd.data.shape} {chd.data.dtype}, "
                  f"fs {chd.fs:.6g} Hz, {chd.data.nbytes / 2**30:.3f} GiB")
            echo_oracle(s, us, chd)
            ts = [blocked(lambda: us.greens(scat).data) for _ in range(5)]
            s.time("greens median of 5",
                   f"{statistics.median(ts):.4f} s "
                   f"{[round(v, 4) for v in ts]}")
            state["chd"] = chd

        s.step("simulate: us.greens 256x256 + 2^16 scatterers", simulate)
        s.step("simulate: 32x32 sub-aperture vs float64 oracle",
               lambda: greens_oracle(s, us))
        if "chd" in state:
            s.step("beamform: us.DAS cubic 1024x1024",
                   lambda: das_phase(s, us, state["chd"]))
            state.clear()
        entry_points(s)

        def gpu_tests():
            import glob

            import pytest
            os.environ["QUPS_TEST_DEVICE"] = "gpu"
            root = os.path.dirname(os.path.abspath(__file__))
            files = [f for f in sorted(glob.glob(
                os.path.join(root, "tests", "test_*.py")))
                if "pytest.mark.gpu" in open(f).read()]
            s.check(bool(files), "no test file marks a gpu test")
            rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                              *files])
            s.check(rc == 0, f"gpu-marked tests exit code {rc}")
        s.step("tests marked gpu", gpu_tests)

    if s.failed:
        print(f"FAILED phases: {s.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
