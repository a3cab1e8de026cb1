"""qups_jax cheat sheet — an executable tour of the API surface (the
reference's ``cheat_sheet.m`` / ``example_.m``, run end-to-end by
``tests/test_examples.py``). Sizes are kept small so it runs in seconds on
CPU; scale them up freely on a GPU.
"""
import numpy as np

import qups_jax as q

# --------------------------------------------------------------- definitions
# Transducers: linear / convex / matrix / generic (+ named presets)
xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=5e6)
_ = q.TransducerArray.L11_5v()          # named probe presets
_ = q.TransducerConvex(numel=16, radius=40e-3, fc=3e6)
_ = q.TransducerMatrix(numd=(4, 4), pitch2=(0.3e-3, 0.3e-3), fc=3e6)

# Sequences: FSA / PW / FC / DV / VS (+ custom delays & apodization)
c0 = 1540.0
seq_fsa = q.Sequence(type="FSA", numpulse=xdc.numel, c0=c0)
ang = np.radians([-10.0, 0.0, 10.0])
seq_pw = q.Sequence(type="PW", focus=np.stack(
    [np.sin(ang), 0 * ang, np.cos(ang)]), c0=c0)
seq_fc = q.Sequence(type="FC", focus=np.array(
    [[-2e-3, 0.0, 2e-3], [0, 0, 0], [20e-3, 20e-3, 20e-3]]), c0=c0)

# Scans: cartesian / polar / spherical / generic
scan = q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 64), y=[0.0],
                       z=np.linspace(12e-3, 24e-3, 64))

# Media and scatterers
target = np.array([[0.0], [0.0], [18e-3]])
scat = q.Scatterers(pos=target, c0=c0)
med = q.Medium(c0=c0, rho0=1000.0,
               pertreg=((lambda P: P[2] > 20e-3, {"c": 1600.0}),))

# The system object ties them together
us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq_pw, scan=scan, fs=25e6)

# ---------------------------------------------------------------- simulation
chd = us.greens(scat)                   # Green's-function sim + focusTx
print("ChannelData:", chd.data.shape, "fs =", chd.fs)
# large diffuse clouds: bf16 phasor GEMMs (f32 accumulation, ~0.2% rel err)
_ = us.greens(scat, precision="bf16")

# frequency-domain point sim w/ element directivity (the MUST analog)
chd_s = us.simus(scat)
print("simus:", chd_s.data.shape)

# transmit pressure-field map (calc_hp analog)
pmax = us.replace(seq=seq_fc).calc_hp()
print("pressure map:", pmax.shape)

# ----------------------------------------------------------------------- DSP
chd2 = chd.hilbert()                    # analytic signal
chd2 = chd2.downmix(us.fc)              # baseband IQ
chd2 = chd2.resample(12.5e6)            # half rate

# --------------------------------------------------------------- beamforming
b = us.DAS(chd, method="linear")        # compute-optimized DAS
b2 = us.bfDAS(chd)                      # delay-table DAS
b3 = us.bfAdjoint(chd, max_bins=24)     # frequency-domain adjoint
b4, bscan = us.bfMigration(chd)         # Stolt f-k migration (PW only)
tau_rx, tau_tx = us.das_delay_tables()
b5 = us.bfDASLUT(chd, tau_rx, tau_tx)   # bring-your-own-delays

# apodization (dense generators, or fused descriptors the GPU kernel
# evaluates in registers)
apod = us.ap_aperture_growth(f=1.5)
b6 = us.DAS(chd, apod=(q.Fused("aperture_growth", f=1.5),), method="linear")

# coherence imaging on a receive-kept image
brx = us.DAS(chd, keep_rx=True, method="linear")
cf = q.ops.cohfac(np.asarray(brx), axis=-2)
print("images:", b.shape, "coherence:", cf.shape)

# ... or fused in one step (kernel + aperture reduction compile as ONE
# program — 15% faster than the two-step path even on one chip; pass a
# multi-device mesh to scale it: two image-sized psums total)
cf2 = us.coherence_image(chd, post="cohfac", method="linear")
sl = us.coherence_image(chd, post="slsc", lags=3, method="linear")
print("fused coherence:", np.asarray(cf2).shape, np.asarray(sl).shape)

# ----------------------------------------------------- heterogeneous medium
cgrd = q.ScanCartesian(x=np.arange(-4e-3, 4e-3, 0.2e-3), y=[0.0],
                       z=np.arange(0.0, 26e-3, 0.2e-3))
b7 = us.bfEikonal(chd, med, cgrd)       # eikonal travel-time beamforming
print("eikonal image:", b7.shape)

# ------------------------------------------------------- out-of-core / tall
# stream transmits through the device in blocks (host-resident traces)
b8 = us.DAS(chd, method="linear", bsize=2)
assert np.allclose(np.asarray(b8), np.asarray(b), atol=1e-5 * np.abs(
    np.asarray(b)).max())

# ------------------------------------------------- full-wave sim (k-Wave-y)
# field snapshots + iso-impedance background subtraction
cgrd2 = q.ScanCartesian(x=np.arange(-3e-3, 3e-3, 0.3e-3), y=[0.0],
                        z=np.arange(-0.5e-3, 8e-3, 0.3e-3))
us_kw = us.replace(scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                        z=np.linspace(1e-3, 6e-3, 8)))
chd_kw, fields = us_kw.kspaceFirstOrder(
    q.Medium(c0=c0, rho0=1000.0), cgrd2, record="field", field_stride=16,
    tmax=4e-6)
print("fdtd traces:", chd_kw.data.shape, "field snapshots:", fields.shape)

# ---------------------------------------------------------------- profiling
from qups_jax.utils import Timer  # noqa: E402
tm = Timer()
with tm("das"):
    _ = us.DAS(chd, method="linear")
print("DAS wall:", round(tm.times["das"], 3), "s")

# ------------------------------------------------------------ serialization
from qups_jax import interop  # noqa: E402
from qups_jax.io import save_checkpoint, load_checkpoint  # noqa: E402
import tempfile, os  # noqa: E402
with tempfile.TemporaryDirectory() as d:
    interop.save_uff(os.path.join(d, "demo.uff"), chd=chd, xdc=xdc,
                     seq=seq_pw, scan=scan)
    back = interop.load_uff(os.path.join(d, "demo.uff"))
    assert back["xdc"].numel == xdc.numel
    # orbax checkpoint of a (possibly sharded) result pytree
    save_checkpoint(os.path.join(d, "ckpt"), {"img": np.asarray(b)})
    assert np.allclose(load_checkpoint(os.path.join(d, "ckpt"))["img"],
                       np.asarray(b))

# ------------------------------------------------------- round-3 additions
# attenuating scatterers (MUST absorption model): alpha0 [dB/cm/MHz]
scat_att = q.Scatterers(pos=target, c0=c0, alpha0=0.5)
chd_att = us.greens(scat_att, impl="freq")
assert np.abs(np.asarray(chd_att.data)).max() \
    < np.abs(np.asarray(us.greens(scat, impl="freq").data)).max()

# transmit synthesis via the per-bin frequency GEMM (exact band-limited
# interpolation; the GPU default for focusTx/greens/calc_scat_multi)
chd_fsa = us.replace(seq=seq_fsa).greens(scat)
enc = us.focusTx(chd_fsa, seq_pw, method="freq")
assert enc.data.shape[2] == seq_pw.num_pulse

# BF mode: keep BOTH rx and tx axes (per-pair images)
bboth = us.DAS(chd, keep_rx=True, keep_tx=True, method="linear")
assert bboth.shape[-2:] == (xdc.numel, seq_pw.num_pulse)

# walking-aperture focused sequence (per-tx apodization at the aperture)
apd_walk = q.Sequence.ap_walking(xdc.numel, 8, stride=4)
seq_walk = q.Sequence(type="FC", focus=seq_fc.focus_array[:, :apd_walk.shape[1]],
                      c0=c0, apd=apd_walk[:, :seq_fc.num_pulse])

# multi-chip: shard channel data over a (rx, tx) device mesh; on one
# device this is a no-op mesh (the same code scales to pods)
import jax  # noqa: E402
from qups_jax.parallel import make_mesh, das_sharded  # noqa: E402
mesh = make_mesh(jax.devices()[:1], axes=("rx",), shape=(1,))
pv_, nv_, model_ = us._tx_geometry()
bsh = das_sharded(mesh, np.asarray(chd.data), us._pixels(),
                  us.rx.positions().T, pv_, nv_,
                  np.asarray(chd.t0_host).reshape(-1), 1 / c0,
                  fs=float(chd.fs), tx_model=model_, method="linear")
assert np.isfinite(np.asarray(bsh)).all()

# in-mesh coherence: the aperture reduction runs INSIDE the shard_map —
# the devices exchange two image psums instead of the (I, N) volume
mesh2 = make_mesh(jax.devices()[:1], axes=("rx",), shape=(1,))
xr = np.ascontiguousarray(np.real(np.asarray(chd.data)).astype(np.float32))
cf = das_sharded(
    mesh2, xr, us._pixels(), us.rx.positions().T.astype(np.float32),
    pv_.astype(np.float32), nv_.astype(np.float32),
    np.asarray(chd.t0_host, np.float32).reshape(-1), 1 / c0,
    fs=float(chd.fs), tx_model=model_, method="linear", post="cohfac")
assert cf.shape[0] == us._pixels().shape[0]
assert float(np.max(np.asarray(cf))) <= 1.0 + 1e-6

print("cheat sheet OK")

# ---------------------------------------------------------------- round 5
# transmit-sharded full-wave sim: the reference's parfor-over-transmits
# axis as a mesh (one PSTD stepper per local transmit, zero collectives)
from qups_jax.parallel import fdtd_sharded  # noqa: E402
cmapf = np.full((48, 48), 1500.0, np.float32)
rmapf = np.full((48, 48), 1000.0, np.float32)
sigf = np.zeros((4, 32, 2), np.float32)
sigf[:, 5, :] = 1.0
recf = fdtd_sharded(make_mesh(jax.devices()[:1], axes=("tx",)),
                    cmapf, rmapf, np.array([[12, 12], [16, 32]]), sigf,
                    steps=32, dt=4e-8, dx=2e-4, c_ref=1500.0,
                    record_rows=(40,))
assert recf.shape == (4, 32, 1, 48)

# REFoCUS decode with the bin-sharded operator + rx-sharded apply
from qups_jax.parallel import refocus_sharded  # noqa: E402
xr5 = np.asarray(np.real(np.asarray(chd.data)), np.float32)
V5 = xr5.shape[2]
taur5 = np.zeros((V5, V5), np.float32)
apdr5 = np.eye(V5, dtype=np.float32)
y5, _ = refocus_sharded(make_mesh(jax.devices()[:1], axes=("rx",)),
                        xr5, taur5, apdr5, np.zeros(V5, np.float32),
                        fs=float(chd.fs))
assert y5.shape[2] == V5

# the plain XLA scan, whatever the device (the reference path the fused
# GPU kernel is compared with)
b_q = us.DAS(chd, method="cubic", kernel="xla")
assert np.isfinite(np.abs(np.asarray(b_q))).all()
