"""Sharding tests on the virtual 8-device CPU mesh — the ParTest analog:
sharded results must match single-device results exactly (up to reduction
order), across mesh layouts.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import qups_jax as q
from qups_jax.ops.das import das
from qups_jax.ops.greens import greens_splat
from qups_jax.parallel import make_mesh, das_sharded, greens_sharded


def _das_problem(T=128, N=8, M=4, I=36, F=None):
    rng = np.random.default_rng(3)
    shape = (T, N, M) if F is None else (T, N, M, F)
    x = rng.standard_normal(shape).astype(np.float32)
    pi = np.stack([np.linspace(-5e-3, 5e-3, I), np.zeros(I),
                   np.linspace(20e-3, 30e-3, I)], -1).astype(np.float32)
    pr = np.stack([np.linspace(-4e-3, 4e-3, N), np.zeros(N), np.zeros(N)], -1)
    pv = np.stack([np.linspace(-3e-3, 3e-3, M), np.zeros(M), np.zeros(M)], -1)
    nv = np.tile([0.0, 0.0, 1.0], (M, 1))
    # start times chosen so the two-way delays land inside the data window
    t0 = (25e-6 + np.linspace(0, 1e-6, M)).astype(np.float32)
    return x, pi, pr.astype(np.float32), pv.astype(np.float32), nv.astype(np.float32), t0


def test_mesh_factorization():
    m = make_mesh(jax.devices())
    assert int(np.prod(list(m.shape.values()))) == 8
    m2 = make_mesh(jax.devices(), axes=("rx", "tx"), shape=(4, 2))
    assert m2.shape["rx"] == 4


@pytest.mark.parametrize("shape", [(1, 4, 2), (2, 2, 2), (1, 1, 8)])
def test_das_sharded_matches_single(shape):
    x, pi, pr, pv, nv, t0 = _das_problem(F=4)
    mesh = make_mesh(jax.devices(), shape=shape)
    ref = das(x, pi, pr, pv, nv, t0, 1.0 / 1540.0, fs=10e6, tx_model="plane")
    got = das_sharded(mesh, x, pi, pr, pv, nv, t0, 1.0 / 1540.0, fs=10e6,
                      tx_model="plane")
    assert got.shape == ref.shape
    scale = float(jnp.abs(ref).max())
    assert scale > 0  # guard against a vacuous all-zero comparison
    assert float(jnp.abs(got - ref).max()) < 1e-4 * scale


def test_das_sharded_keep_rx():
    x, pi, pr, pv, nv, t0 = _das_problem(F=2)
    mesh = make_mesh(jax.devices(), shape=(2, 2, 2))
    ref = das(x, pi, pr, pv, nv, t0, 1.0 / 1540.0, fs=10e6, tx_model="plane",
              keep_rx=True)
    got = das_sharded(mesh, x, pi, pr, pv, nv, t0, 1.0 / 1540.0, fs=10e6,
                      tx_model="plane", keep_rx=True)
    assert got.shape == ref.shape
    assert float(jnp.abs(ref).max()) > 0
    assert float(jnp.abs(got - ref).max()) < 1e-4 * float(jnp.abs(ref).max())


def test_das_sharded_with_apod():
    x, pi, pr, pv, nv, t0 = _das_problem(F=2)
    I, N, M = 36, 8, 4
    rng = np.random.default_rng(0)
    ap = rng.uniform(0.5, 1.0, (I, 1, 1, N, M)).astype(np.float32)
    mesh = make_mesh(jax.devices(), shape=(2, 2, 2))
    ref = das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=10e6, tx_model="plane",
              apod=(ap,))
    got = das_sharded(mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=10e6,
                      tx_model="plane", apod=(ap,))
    assert float(jnp.abs(got - ref).max()) < 1e-4 * float(jnp.abs(ref).max())


def test_greens_sharded_matches_single():
    rng = np.random.default_rng(1)
    S, N, M, T, K = 13, 4, 2, 96, 21
    kern = rng.standard_normal(K).astype(np.float32)
    ps = np.stack([rng.uniform(-3e-3, 3e-3, S), np.zeros(S),
                   rng.uniform(15e-3, 25e-3, S)], -1).astype(np.float32)
    amp = rng.standard_normal(S).astype(np.float32)
    pn = np.stack([np.linspace(-4e-3, 4e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)[:, None, :]
    pv = np.stack([np.linspace(-2e-3, 2e-3, M), np.zeros(M), np.zeros(M)],
                  -1).astype(np.float32)[:, None, :]
    kw = dict(T=T, s0=1.5e-5, t0k=-1e-6, fs=5e6, cinv=1 / 1540.0, R0=1e-3,
              block=4)
    ref = greens_splat(jnp.asarray(kern), jnp.asarray(ps), jnp.asarray(amp),
                       jnp.asarray(pn), jnp.asarray(pv), **kw)
    mesh = make_mesh(jax.devices(), axes=("rx", "tx"), shape=(2, 4))
    got = greens_sharded(mesh, kern, ps, amp, pn, pv, **kw)
    assert got.shape == ref.shape
    assert float(jnp.abs(got - ref).max()) < 1e-4 * float(jnp.abs(ref).max())


@pytest.mark.full
def test_greens_freq_sharded_matches_single():
    from qups_jax.ops.greens_freq import greens_freq
    from qups_jax.parallel import greens_freq_sharded
    rng = np.random.default_rng(2)
    S, N, M, T, K = 13, 5, 2, 96, 21  # S, N deliberately non-divisible
    fs = 5e6
    kern = (np.hanning(K) * np.sin(2 * np.pi * 1e6 * np.arange(K) / fs)
            ).astype(np.float32)
    ps = np.stack([rng.uniform(-3e-3, 3e-3, S), np.zeros(S),
                   rng.uniform(15e-3, 25e-3, S)], -1).astype(np.float32)
    amp = rng.standard_normal(S).astype(np.float32)
    pn = np.stack([np.linspace(-4e-3, 4e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)[:, None, :]
    pv = np.stack([np.linspace(-2e-3, 2e-3, M), np.zeros(M), np.zeros(M)],
                  -1).astype(np.float32)[:, None, :]
    kw = dict(T=T, s0=1.5e-5, t0k=-1e-6, fs=fs, cinv=1 / 1540.0, R0=1e-3)
    ref = greens_freq(kern, ps, amp, pn, pv, **kw)
    mesh = make_mesh(jax.devices(), axes=("rx", "tx"), shape=(2, 4))
    got = greens_freq_sharded(mesh, kern, ps, amp, pn, pv, **kw)
    assert got.shape == ref.shape
    assert float(jnp.abs(got - ref).max()) < 1e-4 * float(jnp.abs(ref).max())
    # complex kernel path under the mesh as well (ri orchestration)
    ck = kern.astype(np.complex64) * np.exp(
        1j * np.linspace(0, 1, K)).astype(np.complex64)
    refc = greens_freq(ck, ps, amp, pn, pv, out="complex", **kw)
    gotc = greens_freq_sharded(mesh, ck, ps, amp, pn, pv, out="complex",
                               **kw)
    assert float(jnp.abs(gotc - refc).max()) \
        < 1e-4 * float(jnp.abs(refc).max())


def test_system_greens_das_on_mesh_smoke():
    # end-to-end on the mesh: simulate (sharded) then beamform (sharded)
    xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
    seq = q.SequenceRadial(type="PW", angles=[0.0, 5.0], c0=1540.0)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, fs=12e6,
                            scan=q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 16),
                                                 z=np.linspace(25e-3, 33e-3, 16)))
    scat = q.Scatterers(pos=[[0.0], [0.0], [29e-3]], c0=1540.0)
    chd = us.greens(scat)
    mesh = make_mesh(jax.devices(), shape=(1, 4, 2))
    pv, nv, model = us._tx_geometry()
    t0 = np.asarray(jax.device_get(jnp.asarray(chd.t0))).reshape(-1)
    img = das_sharded(mesh, chd.data, us._pixels(), us.rx.positions().T, pv,
                      nv, t0, 1 / 1540.0, fs=float(chd.fs), tx_model=model)
    ref = us.DAS(chd)
    assert float(jnp.abs(img.reshape(ref.shape) - ref).max()) \
        < 1e-3 * float(jnp.abs(ref).max())


def test_das_sharded_pallas_parity():
    """The shard_map-composed DAS kernel (interpret mode) matches the
    single-shard XLA das on the virtual CPU mesh."""
    import jax
    import numpy as np
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.das import das

    rng = np.random.default_rng(7)
    T, N, M, I1, I2 = 256, 16, 4, 16, 128
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    xs = np.linspace(-12e-3, 12e-3, I2)
    zs = np.linspace(5e-3, 45e-3, I1)
    Z, X = np.meshgrid(zs, xs, indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1).astype(np.float32)
    pr = np.stack([np.linspace(-12e-3, 12e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    th = np.radians(np.linspace(-9, 9, M))
    pv = np.zeros((M, 3), np.float32)
    nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1).astype(np.float32)
    t0 = np.full(M, 2 * 5e-3 / 1540.0, np.float32)

    mesh = make_mesh(jax.devices()[:4], axes=("rx", "tx"))
    got = np.asarray(das_sharded(
        mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
        method="linear", im_shape=(I1, I2, 1), interpret=True)).squeeze()
    ref = np.asarray(das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                         tx_model="plane", method="linear")).squeeze()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-4


def _shard_problem(N=24, M=6, T=256, I1=16, I2=128, F=None, cplx=False,
                   seed=7):
    rng = np.random.default_rng(seed)
    shape = (T, N, M) + ((F,) if F else ())
    x = rng.standard_normal(shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    xs = np.linspace(-12e-3, 12e-3, I2)
    zs = np.linspace(5e-3, 45e-3, I1)
    Z, X = np.meshgrid(zs, xs, indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()],
                  -1).astype(np.float32)
    pr = np.stack([np.linspace(-12e-3, 12e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    th = np.radians(np.linspace(-9, 9, M))
    pv = np.zeros((M, 3), np.float32)
    nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)],
                  -1).astype(np.float32)
    t0 = np.full(M, 2 * 5e-3 / 1540.0, np.float32)
    return x, pi, pr, pv, nv, t0


def test_das_sharded_pallas_cubic_nondivisible():
    """Cubic sampler with a NON-divisible rx count (N=24 over 4 rx
    shards -> per-shard padding)."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.das import das

    x, pi, pr, pv, nv, t0 = _shard_problem()
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    ref = np.asarray(das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                         tx_model="plane", method="cubic")).squeeze()
    got = np.asarray(das_sharded(
        mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
        method="cubic", im_shape=(16, 128, 1), interpret=True)).squeeze()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_das_sharded_pallas_keep_rx():
    """keep_rx (coherence imaging) stays rx-sharded per shard and gathers
    back to the full receive axis."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.das import das

    x, pi, pr, pv, nv, t0 = _shard_problem()
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    ref = np.asarray(das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                         tx_model="plane", method="linear", keep_rx=True))
    got = np.asarray(das_sharded(
        mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
        method="linear", keep_rx=True, im_shape=(16, 128, 1),
        interpret=True))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize("kind", ["cohfac", "slsc"])
@pytest.mark.parametrize("iq", [False, True])
def test_das_sharded_pallas_post_coherence(kind, iq):
    """In-mesh coherence reductions (post='cohfac'|'slsc'): each shard
    reduces its own rx band; cross-chip traffic is image psums (+ the
    ppermute lag halo for slsc) instead of a (I, N) gather. Reference =
    the ops reductions on the single-device kernel's keep_rx image (slsc
    normalizes every sample, so it compares the reduction, not the
    summation order of two beamformers). Non-divisible N (14 on a 4-wide
    rx axis) exercises padded channels + the last-shard halo zeroing."""
    import jax
    from qups_jax.ops.coherence import cohfac, slsc
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.das_fused import das_kernel as das

    x, pi, pr, pv, nv, t0 = _shard_problem()
    N = pr.shape[0] - 2  # non-divisible on the 4-wide rx axis
    x = x[:, :N]
    pr = pr[:N]
    if iq:
        x = (x + 1j * x[::-1]).astype(np.complex64)
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    brx = np.asarray(das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                         tx_model="plane", method="linear", keep_rx=True,
                         interpret=True))[:, :, 0]  # (I, N)
    lags = 3
    want = np.asarray(cohfac(brx, axis=1) if kind == "cohfac"
                      else slsc(brx, axis=1, lags=lags))
    got = np.asarray(das_sharded(
        mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
        method="linear", im_shape=(16, 128, 1), interpret=True,
        post=kind, lags=lags))
    assert got.shape == want.shape == (pi.shape[0],)
    want = np.real(want)
    scale = max(np.abs(want).max(), 1e-6)
    # f32 unit-normalization rounding differs slightly from the complex
    # reference path
    assert np.abs(got - want).max() / scale < 5e-4


def test_das_sharded_pallas_keep_rx_frames():
    """keep_rx with a 'frame' mesh axis: kept bands stay per frame shard
    and gather back rx-complete per frame."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.das import das

    x, pi, pr, pv, nv, t0 = _shard_problem()
    F = 2
    x = np.stack([x, 3 * x - 1], axis=-1)  # (T, N, M, F)
    mesh = make_mesh(jax.devices()[:8], axes=("frame", "rx", "tx"),
                     shape=(2, 2, 2))
    ref = np.asarray(das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                         tx_model="plane", method="linear", keep_rx=True))
    got = np.asarray(das_sharded(
        mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
        method="linear", keep_rx=True, im_shape=(16, 128, 1),
        interpret=True))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_das_sharded_pallas_keep_tx_frames():
    """keep_tx with a 'frame' mesh axis — the mirror of the keep_rx
    frame-shard case: each shard sees one frame on a 4-D operand."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.das import das

    x, pi, pr, pv, nv, t0 = _shard_problem()
    x = np.stack([x, 3 * x - 1], axis=-1)  # (T, N, M, F=2)
    mesh = make_mesh(jax.devices()[:8], axes=("frame", "rx", "tx"),
                     shape=(2, 2, 2))
    ref = np.asarray(das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                         tx_model="plane", method="linear", keep_tx=True))
    got = np.asarray(das_sharded(
        mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
        method="linear", keep_tx=True, im_shape=(16, 128, 1),
        interpret=True))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.full
def test_das_pallas_rank4_single_frame():
    """Direct das_kernel on a rank-4 (T, N, M, F=1) operand (the
    shard_map one-frame view): summed, keep_rx and keep_tx."""
    from qups_jax.ops.das import das
    from qups_jax.ops.das_fused import das_kernel

    x, pi, pr, pv, nv, t0 = _shard_problem(N=16, M=4)
    x4 = x[..., None]  # (T, N, M, F=1)
    for kw in (dict(), dict(keep_rx=True), dict(keep_tx=True)):
        ref = np.asarray(das(x4, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                             tx_model="plane", method="linear", **kw))
        got = np.asarray(das_kernel(
            x4, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
            method="linear", interpret=True, **kw))
        assert got.shape == ref.shape, kw
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4, kw


def test_das_sharded_pallas_eager_plan_cache():
    """Repeated eager sharded calls with the same geometry are linear in
    the data and follow a change of sampler."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded

    x, pi, pr, pv, nv, t0 = _shard_problem()
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    kw = dict(fs=4e6, tx_model="plane", method="linear",
              im_shape=(16, 128, 1), interpret=True)
    a1 = np.asarray(das_sharded(mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0,
                                **kw))
    a2 = np.asarray(das_sharded(mesh, 2 * x, pi, pr, pv, nv, t0, 1 / 1540.0,
                                **kw))
    a3 = np.asarray(das_sharded(mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0,
                                **{**kw, "method": "nearest"}))
    assert np.allclose(a2, 2 * a1, atol=1e-4 * np.abs(a1).max())
    assert not np.allclose(a3, a1, atol=1e-4 * np.abs(a1).max())


def test_das_sharded_compiles_once():
    """Repeated sharded calls with one configuration reuse one compiled
    program; a new sampler compiles another."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.parallel import mesh as mesh_mod

    x, pi, pr, pv, nv, t0 = _shard_problem(N=16, M=4, I1=8, I2=32)
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    kw = dict(fs=4e6, tx_model="plane", method="linear")
    n0 = mesh_mod._sharded_jit._cache_size()
    for scale in (1.0, 2.0, 3.0):
        das_sharded(mesh, scale * x, pi, pr, pv, nv, t0, 1 / 1540.0, **kw)
    assert mesh_mod._sharded_jit._cache_size() == n0 + 1
    das_sharded(mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0,
                **{**kw, "method": "nearest"})
    assert mesh_mod._sharded_jit._cache_size() == n0 + 2


def test_das_lut_sharded_pallas_post_coherence():
    """In-mesh cohfac on the sharded LUT kernel (bfEikonal/bfDASLUT
    coherence across chips)."""
    import jax
    from qups_jax.ops.coherence import cohfac
    from qups_jax.ops.das import das_lut
    from qups_jax.parallel import das_lut_sharded, make_mesh

    x, pi, pr, pv, nv, t0 = _shard_problem()
    c0 = 1540.0
    tau_rx = np.linalg.norm(pi[:, None, :] - pr[None], axis=-1) / c0
    tau_tx = np.einsum("ik,mk->im", pi, nv) / c0
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    brx = np.asarray(das_lut(x, tau_rx, tau_tx, t0, method="linear",
                             keep_rx=True, fs=4e6))[:, :, 0]
    want = np.asarray(cohfac(brx, axis=1))
    got = np.asarray(das_lut_sharded(
        mesh, x, tau_rx, tau_tx, t0, fs=4e6, method="linear",
        interpret=True, post="cohfac"))
    assert got.shape == want.shape
    assert np.abs(got - want).max() / max(np.abs(want).max(), 1e-6) < 1e-4


def test_das_sharded_pallas_fused_apod():
    """Fused-geometry apodization (aperture growth) rides the sharded
    kernel; reference = the XLA das with the materialized dense mask."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.das import das
    from qups_jax.ops.apod import Fused

    x, pi, pr, pv, nv, t0 = _shard_problem()
    N = pr.shape[0]
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    d = pi[:, None, 0] - pr[None, :, 0]
    z = pi[:, None, 2] - pr[None, :, 2]
    apd = (np.abs(z) > 2.0 * np.abs(d)).astype(np.float32)
    apd = apd.reshape(pi.shape[0], 1, 1, N, 1)
    ref = np.asarray(das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                         tx_model="plane", method="linear",
                         apod=(apd,))).squeeze()
    got = np.asarray(das_sharded(
        mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
        method="linear", apod=(Fused("aperture_growth", f=1.0),),
        im_shape=(16, 128, 1), interpret=True)).squeeze()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize("keep_rx", [False, True])
def test_das_sharded_fused_apod_xla(keep_rx):
    """Without the kernel (the CPU) the sharded scan evaluates Fused
    descriptors, receive and transmit, on each shard's geometry; reference
    = the unsharded kernel in the interpreter."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.apod import Fused
    from qups_jax.ops.das_fused import das_kernel

    x, pi, pr, pv, nv, t0 = _shard_problem()
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    apod = (Fused("aperture_growth", f=1.0),
            Fused("tx_parallelogram", xlo=-6e-3, xhi=6e-3))
    kw = dict(fs=4e6, tx_model="plane", method="linear", apod=apod,
              keep_rx=keep_rx)
    ref = np.asarray(das_kernel(x, pi, pr, pv, nv, t0, 1 / 1540.0,
                                interpret=True, **kw))
    got = np.asarray(das_sharded(mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0,
                                 im_shape=(16, 128, 1), **kw))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.full
def test_das_sharded_pallas_frames_iq_fmod():
    """Frame batches + IQ data + in-kernel fmod on a 3-axis
    (rx, tx, frame) mesh."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.das import das

    x, pi, pr, pv, nv, t0 = _shard_problem(F=3, cplx=True)
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx", "frame"),
                     shape=(2, 2, 2))
    ref = np.asarray(das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                         tx_model="plane", method="linear", fmod=2e5))
    got = np.asarray(das_sharded(
        mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
        method="linear", fmod=2e5, im_shape=(16, 128, 1), interpret=True))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize("kw", [dict(), dict(keep_rx=True),
                                dict(method="cubic")])
def test_das_lut_sharded_pallas(kw):
    """Sharded LUT kernel (bfDAS/bfDASLUT/bfEikonal multi-device spine):
    summed, keep_rx, and cubic variants vs the XLA das_lut."""
    import jax
    from qups_jax.parallel import make_mesh, das_lut_sharded
    from qups_jax.ops.das import das_lut

    x, pi, pr, pv, nv, t0 = _shard_problem()
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    tau_rx = (np.linalg.norm(pi[:, None, :] - pr[None], axis=-1)
              / 1540.0).astype(np.float32)
    tau_tx = (pi @ nv.T / 1540.0).astype(np.float32)
    ref = np.asarray(das_lut(x, tau_rx, tau_tx, t0, fs=4e6,
                             method=kw.get("method", "linear"),
                             keep_rx=kw.get("keep_rx", False)))
    got = np.asarray(das_lut_sharded(
        mesh, x, tau_rx, tau_tx, t0, fs=4e6, interpret=True,
        **{"method": "linear", **kw}))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.full
def test_das_lut_sharded_pallas_eager_plan_cache():
    """Repeated eager sharded LUT calls with the same tables are linear
    in the data and follow a change of sampler."""
    import jax
    from qups_jax.parallel import make_mesh, das_lut_sharded

    x, pi, pr, pv, nv, t0 = _shard_problem()
    mesh = make_mesh(jax.devices()[:8], axes=("rx", "tx"), shape=(4, 2))
    tau_rx = (np.linalg.norm(pi[:, None, :] - pr[None], axis=-1)
              / 1540.0).astype(np.float32)
    tau_tx = (pi @ nv.T / 1540.0).astype(np.float32)
    kw = dict(fs=4e6, interpret=True, method="linear")
    a1 = np.asarray(das_lut_sharded(mesh, x, tau_rx, tau_tx, t0, **kw))
    a2 = np.asarray(das_lut_sharded(mesh, 2 * x, tau_rx, tau_tx, t0, **kw))
    a3 = np.asarray(das_lut_sharded(mesh, x, tau_rx, tau_tx, t0,
                                    **{**kw, "method": "nearest"}))
    assert np.allclose(a2, 2 * a1, atol=1e-4 * np.abs(a1).max())
    assert not np.allclose(a3, a1, atol=1e-4 * np.abs(a1).max())


@pytest.mark.full
def test_das_sharded_pallas_single_axis_mesh():
    """A mesh with only an 'rx' axis compiles and matches."""
    import jax
    from qups_jax.parallel import make_mesh, das_sharded
    from qups_jax.ops.das import das

    x, pi, pr, pv, nv, t0 = _shard_problem(N=16, M=4)
    mesh = make_mesh(jax.devices()[:2], axes=("rx",), shape=(2,))
    ref = np.asarray(das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6,
                         tx_model="plane", method="linear")).squeeze()
    got = np.asarray(das_sharded(
        mesh, x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=4e6, tx_model="plane",
        method="linear", im_shape=(16, 128, 1), interpret=True)).squeeze()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_greens_freq_sharded_attenuation():
    """alpha0 attenuation through the sharded freq engine matches the
    single-device greens_freq."""
    from qups_jax.ops.greens_freq import greens_freq
    from qups_jax.parallel import make_mesh, greens_freq_sharded

    fs, c0, r = 20e6, 1500.0, 15e-3
    kern = np.hanning(41).astype(np.float32)
    rng = np.random.default_rng(2)
    S = 24
    ps = np.stack([rng.uniform(-3e-3, 3e-3, S), np.zeros(S),
                   rng.uniform(10e-3, 20e-3, S)], -1).astype(np.float32)
    amp = rng.uniform(0.5, 1.0, S).astype(np.float32)
    pn = np.stack([np.linspace(-3e-3, 3e-3, 6), np.zeros(6),
                   np.zeros(6)], -1)[:, None, :].astype(np.float32)
    pv = pn[:4].copy()
    T = int(2 * 25e-3 / c0 * fs) + 64
    kw = dict(T=T, s0=0.0, t0k=0.0, fs=fs, cinv=1 / c0, R0=1e-3,
              alpha0=0.7, out="complex")
    ref = np.asarray(greens_freq(kern, ps, amp, pn, pv, **kw))
    mesh = make_mesh(jax.devices()[:4], axes=("rx", "tx"), shape=(2, 2))
    got = np.asarray(greens_freq_sharded(mesh, kern, ps, amp, pn, pv, **kw))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize("mode", ["sum", "rx", "tx"])
def test_bf_adjoint_sharded_matches_single(mode):
    """Pixel-sharded adjoint == the single-device engine (no collectives:
    pixels shard, spectra replicate)."""
    from qups_jax.ops.fdbf import bf_adjoint
    from qups_jax.parallel import bf_adjoint_sharded

    rng = np.random.default_rng(11)
    T, N, M, V, I = 128, 8, 6, 9, 83  # I non-divisible by 8 devices
    x = rng.standard_normal((T, N, V)).astype(np.float32)
    tau_rx = rng.uniform(0, 2e-6, (I, N)).astype(np.float32)
    tau_tx = rng.uniform(0, 2e-6, (I, M)).astype(np.float32)
    del_tx = rng.uniform(0, 3e-7, (M, V)).astype(np.float32)
    apod = rng.standard_normal((M, V)).astype(np.float32)
    t0 = rng.uniform(0, 1e-6, (V,)).astype(np.float32)
    t0o = rng.uniform(0, 1e-7, (V,)).astype(np.float32)
    fs = 40e6
    bins = np.arange(5, 17, dtype=np.int32)
    kw = {"keep_rx": mode == "rx", "keep_tx": mode == "tx"}
    b0 = np.asarray(bf_adjoint(x, tau_rx, tau_tx, del_tx, apod,
                               t0, t0o, bins, fs=fs, fmod=1e6, **kw))
    mesh = make_mesh(jax.devices(), axes=("rx", "tx"), shape=(2, 4))
    b1 = np.asarray(bf_adjoint_sharded(
        mesh, x, tau_rx, tau_tx, del_tx, apod, t0, t0o, bins, fs=fs,
        fmod=1e6, **kw))
    assert b1.shape == b0.shape
    rel = np.linalg.norm(b1 - b0) / np.linalg.norm(b0)
    assert rel < 2e-4, (mode, rel)


def test_fdtd_sharded_matches_single():
    """Transmit-sharded PSTD sim == per-transmit loop (the reference's
    parfor-over-transmits axis, UltrasoundSystem.m:2648), including a
    non-divisible transmit count (padding transmits cropped)."""
    from qups_jax.parallel import fdtd_sharded
    from qups_jax.sim.fdtd import kspace_sim_2d

    rng = np.random.default_rng(5)
    c = np.full((64, 64), 1500.0, np.float32)
    rho = np.full((64, 64), 1000.0, np.float32)
    rho[40:44, 30:34] = 2000.0  # a scatterer so the field is non-trivial
    Mtx, steps, Q = 5, 48, 3  # 5 % 4 != 0: exercises the tx padding
    sig = rng.standard_normal((Mtx, steps, Q)).astype(np.float32)
    idx = np.array([[12, 12, 12], [20, 32, 44]])
    mesh = make_mesh(jax.devices()[:4], axes=("tx",))
    rec = np.asarray(fdtd_sharded(
        mesh, c, rho, idx, sig, steps=steps, dt=4e-8, dx=2e-4,
        c_ref=1500.0, record_rows=(8, 50)))
    assert rec.shape == (Mtx, steps, 2, 64)
    for v in range(Mtx):
        ref = np.asarray(kspace_sim_2d(
            c, rho, idx[0], idx[1], sig[v], steps=steps, dt=4e-8,
            dx=2e-4, c_ref=1500.0, record_rows=(8, 50)))
        assert np.abs(rec[v] - ref).max() <= 1e-6 * np.abs(ref).max(), v


def test_kspace_first_order_mesh_matches_loop():
    """us.kspaceFirstOrder(mesh=...) == the sequential per-transmit loop
    through the full system wrapper (element projection, union source
    set, t0 conventions, fs downsampling)."""
    c0, fc = 1500.0, 2e6
    lam = c0 / fc
    xdc = q.TransducerArray(numel=6, pitch=lam / 2, fc=fc)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=6, c0=c0),
        scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                             z=np.linspace(1e-3, 6e-3, 8)), fs=4 * fc)
    blob = lambda P: (np.hypot(P[0], P[2] - 4e-3) < lam / 4)
    med = q.Medium(c0=c0, rho0=1000.0, pertreg=((blob, {"rho": 2000.0}),))
    cgrd = q.ScanCartesian(x=np.arange(-3e-3, 3e-3, lam / 5), y=[0.0],
                           z=np.arange(-0.5e-3, 6.5e-3, lam / 5))
    chd0 = us.kspaceFirstOrder(med, cgrd)
    mesh = make_mesh(jax.devices(), axes=("tx",))
    chd1 = us.kspaceFirstOrder(med, cgrd, mesh=mesh)
    d0, d1 = np.asarray(chd0.data), np.asarray(chd1.data)
    assert d0.shape == d1.shape
    assert np.abs(d0 - d1).max() <= 1e-5 * np.abs(d0).max()
    assert np.abs(np.asarray(chd0.t0_host)
                  - np.asarray(chd1.t0_host)).max() == 0.0


def test_refocus_sharded_matches_single():
    """Bin-sharded operator build + rx-sharded decode == the single-device
    refocus (UltrasoundSystem.m:3505-3768), non-divisible N."""
    from qups_jax.ops.fdbf import refocus_op, refocus_apply
    from qups_jax.parallel import refocus_op_sharded, refocus_sharded

    rng = np.random.default_rng(7)
    T, N, M, V = 96, 10, 4, 6
    x = rng.standard_normal((T, N, V)).astype(np.float32)
    tau = rng.uniform(0, 1e-6, (M, V)).astype(np.float32)
    apd = np.ones((M, V), np.float32)
    t0 = np.linspace(0, 1e-6, V).astype(np.float32)
    mesh = make_mesh(jax.devices(), axes=("rx", "tx"), shape=(4, 2))
    Hi0 = np.asarray(refocus_op(tau, apd, T=T, fs=8e6))
    Hi1 = np.asarray(refocus_op_sharded(mesh, tau, apd, T=T, fs=8e6))
    assert np.abs(Hi0 - Hi1).max() <= 1e-5 * np.abs(Hi0).max()
    y0, t0m0 = refocus_apply(x, jnp.asarray(Hi0), t0, fs=8e6)
    y1, t0m1 = refocus_sharded(mesh, x, tau, apd, t0, fs=8e6)
    assert float(t0m0) == float(t0m1)
    assert np.abs(np.asarray(y0) - np.asarray(y1)).max() \
        <= 1e-5 * np.abs(np.asarray(y0)).max()


def test_focus_tx_freq_sharded_matches_single():
    """Rx-sharded frequency-domain transmit synthesis == single-device
    focus_tx_freq, with trailing frame dims."""
    from qups_jax.ops.fdbf import focus_tx_freq
    from qups_jax.parallel import focus_tx_freq_sharded

    rng = np.random.default_rng(8)
    T, N, M, Mp = 64, 10, 4, 5
    xf = rng.standard_normal((T, N, M, 3)).astype(np.float32)
    t2 = rng.uniform(0, 1e-6, (M, Mp)).astype(np.float32)
    w = rng.standard_normal((M, Mp)).astype(np.float32)
    mesh = make_mesh(jax.devices(), axes=("rx", "tx"), shape=(2, 4))
    z0 = np.asarray(focus_tx_freq(xf, t2, w, fs=8e6))
    z1 = np.asarray(focus_tx_freq_sharded(mesh, xf, t2, w, fs=8e6))
    assert z1.shape == z0.shape
    assert np.abs(z0 - z1).max() <= 1e-5 * np.abs(z0).max()


def test_migration_sharded_matches_single():
    """Angle-sharded Stolt migration == single device, both keep modes,
    non-divisible angle count (UltrasoundSystem.m:4740-4860)."""
    from qups_jax.ops.fdbf import stolt_migration
    from qups_jax.parallel import migration_sharded

    rng = np.random.default_rng(9)
    T, N, M = 128, 16, 5
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    th = tuple(np.linspace(-8.0, 8.0, M))
    del_tx = rng.uniform(0, 1e-7, (N, M)).astype(np.float32)
    t0 = np.linspace(0, 1e-6, M).astype(np.float32)
    mesh = make_mesh(jax.devices()[:4], axes=("tx",))
    for keep_tx in (False, True):
        r0 = np.asarray(stolt_migration(
            x, t0, del_tx, th, fs=8e6, c0=1540.0, pitch=0.3e-3,
            keep_tx=keep_tx, out="ri"))
        r1 = np.asarray(migration_sharded(
            mesh, x, t0, del_tx, th, fs=8e6, c0=1540.0, pitch=0.3e-3,
            keep_tx=keep_tx, out="ri"))
        assert r0.shape == r1.shape
        assert np.abs(r0 - r1).max() <= 1e-4 * np.abs(r0).max(), keep_tx


def test_greens_system_mesh_matches_single():
    """us.greens(mesh=)/calc_scat_multi(mesh=): the system-level wiring of
    the sharded simulators (closes the last simulator sharding seam —
    the reference's parfor-over-scatterer-blocks/transmits,
    UltrasoundSystem.m:566-882, :1899)."""
    xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=5e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=8),
        scan=q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 16),
                             z=np.linspace(17e-3, 23e-3, 16)), fs=25e6)
    scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
    mesh = make_mesh(jax.devices(), axes=("rx", "tx"), shape=(2, 4))
    for impl in ("freq", "splat"):
        a = np.asarray(us.greens(scat, impl=impl).data)
        b = np.asarray(us.greens(scat, impl=impl, mesh=mesh).data)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max(), impl
    us2 = us.replace(seq=q.SequenceRadial(type="PW", angles=[-5.0, 5.0],
                                          c0=1540.0))
    c1 = np.asarray(us2.calc_scat_multi(scat, method="cubic").data)
    c2 = np.asarray(us2.calc_scat_multi(scat, method="cubic",
                                        mesh=mesh).data)
    assert np.abs(c1 - c2).max() <= 1e-4 * np.abs(c1).max()
