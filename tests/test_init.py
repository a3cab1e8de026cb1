"""Constructor / property round-trip tests for every domain object.

Port of the reference's ``test/InitTest.m`` coverage: constructors, derived
properties, named presets, and geometric invariants for each class.
"""
import numpy as np
import pytest

from qups_jax import (
    Waveform, TransducerArray, TransducerConvex, TransducerMatrix,
    TransducerGeneric, Sequence, SequenceRadial, SequenceGeneric,
    ScanCartesian, ScanPolar, ScanSpherical, ScanGeneric, Scatterers, Medium,
    ChannelData,
)


# ----------------------------------------------------------------- waveform
def test_waveform_delta():
    wv = Waveform.Delta()
    assert wv.duration == 0
    wv = wv.replace(fs=10.0) if hasattr(wv, "replace") else wv


def test_waveform_gauspuls():
    wv = Waveform.Gauspuls(5e6, 0.6)
    assert wv.t0 < 0 < wv.tend
    wv2 = Waveform(fun=wv.fun, t0=wv.t0, tend=wv.tend, fs=40e6)
    s = np.asarray(wv2.samples)
    assert s.shape[0] == wv2.T
    # peak at t=0
    t = wv2.time
    i0 = np.argmin(np.abs(t))
    assert np.argmax(np.abs(s)) == i0
    # time axis passes through 0 exactly
    assert np.min(np.abs(t)) == 0


def test_waveform_conv_delta_identity():
    wv = Waveform.Gauspuls(5e6, 0.6)
    wv = Waveform(fun=wv.fun, t0=wv.t0, tend=wv.tend, fs=50e6)
    c = wv.conv(Waveform.Delta())
    assert np.allclose(np.asarray(c.samples), np.asarray(wv.samples), atol=1e-6)


def test_waveform_conv_commutes():
    a = Waveform(fun=lambda t: np.exp(-((t * 1e6) ** 2)), t0=-2e-6, tend=2e-6, fs=10e6)
    b = Waveform(fun=lambda t: np.cos(np.pi / 2 * t * 1e6) ** 2, t0=-1e-6, tend=1e-6, fs=10e6)
    ab = a.conv(b)
    ba = b.conv(a)
    assert np.allclose(np.asarray(ab.samples), np.asarray(ba.samples), atol=1e-5)
    assert ab.t0 == a.t0 + b.t0
    assert ab.tend == a.tend + b.tend


# --------------------------------------------------------------- transducers
@pytest.mark.parametrize("make", [
    lambda: TransducerArray(),
    lambda: TransducerArray.L11_5v(),
    lambda: TransducerArray.L12_3v(),
    lambda: TransducerArray.L12_5v(),
    lambda: TransducerArray.L11_2v(),
    lambda: TransducerArray.P4_2v(),
    lambda: TransducerConvex(),
    lambda: TransducerConvex.C5_2v(),
    lambda: TransducerMatrix(),
    lambda: TransducerMatrix.PO192O(),
    lambda: TransducerGeneric(pos=np.random.randn(3, 16)),
])
def test_xdc_contract(make):
    xdc = make()
    p = xdc.positions()
    assert p.shape == (3, xdc.numel)
    th, ph, n, w, h = xdc.orientations()
    for v in (n, w, h):
        assert v.shape == (3, xdc.numel)
        assert np.allclose(np.linalg.norm(v, axis=0), 1, atol=1e-12)
    # width/height/normal are mutually orthogonal
    assert np.allclose((n * w).sum(0), 0, atol=1e-9)
    b = xdc.bounds()
    assert b.shape == (3, 2)
    assert (b[:, 0] <= b[:, 1]).all()
    bc = xdc.bary_centers((2, 3))
    assert bc.shape == (3, xdc.numel, 6)
    imp = xdc.impulse
    assert imp is not None and imp.t0 < imp.tend


def test_array_positions_pitch():
    xdc = TransducerArray(numel=8, pitch=0.5e-3)
    p = xdc.positions()
    d = np.diff(p[0])
    assert np.allclose(d, 0.5e-3)
    assert np.allclose(p[1:], 0)
    assert np.allclose(p.mean(axis=1), 0)


def test_convex_on_circle():
    xdc = TransducerConvex.C5_2v()
    p = xdc.positions()
    r = np.linalg.norm(p - xdc.center[:, None], axis=0)
    assert np.allclose(r, xdc.radius, atol=1e-12)


def test_offset_rotation():
    xdc = TransducerArray(numel=4, pitch=1e-3, offset=(1e-3, 2e-3, 3e-3), rot=(90, 0))
    p = xdc.positions()
    # azimuth rotation of 90 deg maps +x onto -z
    assert np.allclose(p[0], 1e-3, atol=1e-9)
    assert np.allclose(p[1], 2e-3, atol=1e-9)
    _, _, n, _, _ = xdc.orientations()
    assert np.allclose(n[:, 0], [1, 0, 0], atol=1e-12)


# ---------------------------------------------------------------- sequences
def test_sequence_fsa():
    xdc = TransducerArray(numel=16, pitch=0.3e-3)
    seq = Sequence(type="FSA", numpulse=16)
    tau = seq.delays(xdc)
    apd = seq.apodization(xdc)
    assert tau.shape == (16, 16)
    assert np.all(tau == 0)
    assert np.allclose(apd, np.eye(16))
    assert np.all(seq.t0_offset() == 0)


def test_sequence_pw():
    xdc = TransducerArray(numel=16, pitch=0.3e-3)
    th = np.radians(10.0)
    seq = Sequence(type="PW", focus=[[np.sin(th)], [0], [np.cos(th)]], c0=1500)
    tau = seq.delays(xdc)
    p = xdc.positions()
    expect = -(np.sin(th) * p[0] + np.cos(th) * p[2]) / 1500
    assert np.allclose(tau[:, 0], expect)


def test_sequence_fc_dv():
    xdc = TransducerArray(numel=16, pitch=0.3e-3)
    pf = np.array([[0.0], [0.0], [30e-3]])
    fc = Sequence(type="FC", focus=pf, c0=1540)
    dv = Sequence(type="DV", focus=pf, c0=1540)
    p = xdc.positions()
    d = np.linalg.norm(pf - p, axis=0) / 1540
    assert np.allclose(fc.delays(xdc)[:, 0], d)
    assert np.allclose(dv.delays(xdc)[:, 0], -d)
    # focused: t0 offset puts t=0 back at the origin
    assert np.allclose(fc.t0_offset(), -30e-3 / 1540)
    assert np.allclose(dv.t0_offset(), +30e-3 / 1540)
    # VS picks + for a focus in front of the array
    vs = Sequence(type="VS", focus=pf, c0=1540)
    assert np.allclose(vs.delays(xdc), fc.delays(xdc))


def test_sequence_radial_pw():
    seq = SequenceRadial(type="PW", angles=np.arange(-10, 11, 5))
    f = seq.focus_array
    assert f.shape == (3, 5)
    assert np.allclose(np.linalg.norm(f, axis=0), 1)
    assert seq.num_pulse == 5


def test_sequence_custom_del_apd():
    xdc = TransducerArray(numel=8, pitch=0.3e-3)
    H = np.where(np.indices((8, 8)).sum(0) % 2, -1.0, 1.0)  # hadamard-like
    seq = Sequence(type="FSA", numpulse=8, apd=H, del_=np.zeros((8, 8)))
    assert np.allclose(seq.apodization(xdc), H)
    assert np.allclose(seq.delays(xdc), 0)


def test_ap_walking():
    apd = Sequence.ap_walking(16, 4, stride=2)
    assert apd.shape[0] == 16
    assert (apd.sum(axis=0) == 4).all()
    # contiguous active blocks
    first = apd[:, 0]
    assert (first[:4] == 1).all() and (first[4:] == 0).all()


# -------------------------------------------------------------------- scans
def test_scan_cartesian():
    sc = ScanCartesian()
    assert sc.shape == (161, 161, 1)
    P = sc.positions()
    assert P.shape == (3,) + sc.shape
    # order ZXY: first data dim is Z
    assert np.allclose(P[2, :, 0, 0], sc.z)
    assert np.allclose(P[0, 0, :, 0], sc.x)
    sc2 = sc.with_resolution(dx=1e-3, dz=1e-3)
    assert abs(sc2.dx - 1e-3) < 1e-12


def test_scan_polar():
    sp = ScanPolar(r=np.linspace(0, 30e-3, 31), a=np.linspace(-20, 20, 21))
    P = sp.positions()
    assert P.shape == (3, 31, 21, 1)
    R = np.linalg.norm(P[[0, 2]], axis=0)
    assert np.allclose(R[:, 0, 0], sp.r, atol=1e-9)


def test_scan_spherical():
    ss = ScanSpherical(r=np.linspace(0, 30e-3, 16), a=np.linspace(-20, 20, 5),
                       e=np.linspace(-10, 10, 3))
    P = ss.positions()
    assert P.shape == (3, 16, 5, 3)
    R = np.linalg.norm(P, axis=0)
    assert np.allclose(R[:, 2, 1], ss.r, atol=1e-9)


def test_scan_generic():
    sg = ScanGeneric(pos=np.random.randn(3, 4, 5, 1))
    assert sg.positions().shape == (3, 4, 5, 1)
    sg2 = ScanGeneric(u=np.linspace(0, 1, 4), v=np.linspace(0, 1, 3),
                      trans=lambda U, V, W: np.stack([U, V, W]))
    assert sg2.positions().shape == (3, 4, 3, 1)


def test_scan_convert_identity_region():
    # a constant polar image scan-converts to a constant cartesian image
    sp = ScanPolar(r=np.linspace(5e-3, 40e-3, 64), a=np.linspace(-30, 30, 64))
    b = np.ones(sp.shape[:2] + (1,))
    bc, scn = sp.scan_convert(b)
    bc = np.asarray(bc)
    inb = ~np.isnan(bc)
    assert inb.any()
    assert np.allclose(bc[inb], 1, atol=1e-6)


# --------------------------------------------------------- scatterers/medium
def test_scatterers():
    s = Scatterers(pos=[[0], [0], [30e-3]])
    assert s.num_scat == 1
    g = Scatterers.Grid((3, 1, 3), (1e-3, 1e-3, 1e-3), (0, 0, 20e-3))
    assert g.num_scat == 9
    assert np.allclose(g.pos.mean(axis=1), [0, 0, 20e-3])
    m = s + g
    assert m.num_scat == 10
    d = Scatterers.Diffuse(ScanCartesian(), density=0.1)
    assert d.num_scat == int(0.1 * 161 * 161)
    s_mm = s.scale(dist=1e3, time=1e6)
    assert np.allclose(s_mm.pos[2], 30.0)
    assert np.isclose(s_mm.c0, 1.540)


def test_medium_props():
    sc = ScanCartesian(x=np.linspace(-5e-3, 5e-3, 11), z=np.linspace(0, 10e-3, 11))
    med = Medium(c0=1500.0)
    c = med.props(sc, "c")
    assert c.shape == sc.shape
    assert np.all(c == 1500)
    # perturbation region: lens of higher speed
    lens = (lambda P: P[2] < 5e-3, {"c": 1600.0})
    med2 = med.replace(pertreg=(lens,))
    c2 = med2.props(sc, "c")
    P = sc.positions()
    assert np.all(c2[P[2] < 5e-3] == 1600)
    assert np.all(c2[P[2] >= 5e-3] == 1500)
    both = med2.props(sc, ("c", "rho"))
    assert set(both) == {"c", "rho"}


def test_medium_sampled():
    sc = ScanCartesian(x=np.linspace(-5e-3, 5e-3, 11), z=np.linspace(0, 10e-3, 11))
    cmap = 1500 + np.arange(11 * 11).reshape(11, 11, 1).astype(float)
    med = Medium.Sampled(sc, c=cmap)
    c = med.props(sc, "c")
    assert np.allclose(c, cmap)


# -------------------------------------------------------------- channel data
def test_channel_data_basics():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 4, 3)).astype(np.float32)
    chd = ChannelData(data=x, fs=10e6, t0=1e-6)
    assert (chd.T, chd.N, chd.M) == (16, 4, 3)
    t = np.asarray(chd.time)
    assert t.shape == (16, 1, 1)
    assert np.isclose(t[0, 0, 0], 1e-6)
    assert np.isclose(t[1, 0, 0] - t[0, 0, 0], 1e-7)


def test_channel_data_zeropad_t0():
    x = np.ones((8, 2, 2), np.float32)
    chd = ChannelData(data=x, fs=1e6, t0=0.0)
    z = chd.zeropad(3, 2)
    assert z.T == 13
    assert np.isclose(np.asarray(z.t0), -3e-6)
    assert np.allclose(np.asarray(z.data[:3]), 0)


def test_channel_data_per_tx_t0():
    x = np.random.randn(8, 2, 3).astype(np.float32)
    t0 = np.array([0.0, 1e-6, 2e-6])
    chd = ChannelData(data=x, fs=1e6, t0=t0)
    assert np.asarray(chd.t0).shape == (1, 1, 3)
    r = chd.rectifyt0(method="linear")
    assert np.asarray(r.t0).shape == ()
    # transmit 0 unshifted
    assert np.allclose(np.asarray(r.data)[:8, :, 0], x[:, :, 0], atol=1e-6)
    # transmit 2 shifted by 2 samples
    assert np.allclose(np.asarray(r.data)[2:10, :, 2], x[:, :, 2], atol=1e-5)


def test_channel_data_hilbert():
    t = np.arange(64) / 64
    x = np.cos(2 * np.pi * 8 * t)[:, None, None] * np.ones((1, 2, 2))
    chd = ChannelData(data=x.astype(np.float32), fs=64.0)
    h = chd.hilbert()
    env = np.abs(np.asarray(h.data))
    assert np.allclose(env, 1.0, atol=1e-3)


def test_channel_data_txmul():
    x = np.random.randn(8, 2, 4).astype(np.float32)
    chd = ChannelData(data=x, fs=1.0)
    H = np.random.randn(4, 4).astype(np.float32)
    y = chd.txmul(H)
    expect = np.einsum("vm,tnm->tnv", H, x)
    assert np.allclose(np.asarray(y.data), expect, atol=1e-5)


def test_channel_data_sample_identity():
    x = np.random.randn(16, 3, 2).astype(np.float32)
    chd = ChannelData(data=x, fs=2e6, t0=5e-6)
    t = np.asarray(chd.time)
    y = chd.sample(t, method="linear")
    assert np.allclose(np.asarray(y), x, atol=1e-5)


def test_channel_data_downmix_upmix():
    fs, fc = 40e6, 5e6
    t = np.arange(128) / fs
    x = np.cos(2 * np.pi * fc * t)[:, None, None] * np.ones((1, 2, 2))
    chd = ChannelData(data=x.astype(np.float32), fs=fs).hilbert()
    bb = chd.downmix(fc)
    # baseband signal is ~constant
    d = np.asarray(bb.data)
    assert np.abs(np.diff(d[10:-10, 0, 0])).max() < 1e-2
    # sampling with fmod undoes the downmix
    y = bb.sample(np.asarray(bb.time), method="linear", fmod=fc)
    assert np.allclose(np.asarray(y)[10:-10], np.asarray(chd.data)[10:-10], atol=1e-2)


def test_channel_data_pytree():
    import jax
    x = np.random.randn(8, 2, 2).astype(np.float32)
    chd = ChannelData(data=x, fs=1e6)
    leaves = jax.tree_util.tree_leaves(chd)
    assert len(leaves) == 2  # data, t0
    chd2 = jax.tree_util.tree_map(lambda v: v, chd)
    assert chd2.fs == chd.fs


def test_channel_data_filter():
    fs = 40e6
    t = np.arange(256) / fs
    x = (np.cos(2 * np.pi * 5e6 * t) + np.cos(2 * np.pi * 15e6 * t))[:, None, None]
    chd = ChannelData(data=np.tile(x, (1, 2, 2)).astype(np.float32), fs=fs)
    h = chd.get_passband_filter((3e6, 7e6), order=65)
    y = chd.filter(h)
    Y = np.abs(np.fft.rfft(np.asarray(y.data)[:, 0, 0]))
    f = np.fft.rfftfreq(y.T, 1 / fs)
    pb = Y[np.argmin(np.abs(f - 5e6))]
    sb = Y[np.argmin(np.abs(f - 15e6))]
    assert pb > 10 * sb


def test_scan_convert_spherical():
    ss = ScanSpherical(r=np.linspace(5e-3, 30e-3, 32),
                       a=np.linspace(-30, 30, 31), e=np.linspace(-20, 20, 21))
    b = np.ones(ss.shape)
    bc, scn = ss.scan_convert(b)
    bc = np.asarray(bc)
    inb = ~np.isnan(bc)
    assert inb.any()
    assert np.allclose(bc[inb], 1, atol=1e-5)
    # a radial gradient survives conversion
    R0 = ss.grid_polar()[0] if hasattr(ss, "grid_polar") else None
    b2 = np.broadcast_to(ss.r[:, None, None], ss.shape).copy()
    bc2, _ = ss.scan_convert(b2)
    bc2 = np.asarray(bc2)
    P = scn.positions()
    Rq = np.linalg.norm(P, axis=0)
    m = ~np.isnan(bc2)
    assert np.allclose(bc2[m], Rq[m], rtol=0.02)


def test_scan_generic_trans_function():
    """ScanGeneric with a trans(u, v, w) transform (the VERDICT round-1 test
    gap): a sheared cartesian mapping round-trips through positions()."""
    import qups_jax as q

    def shear(U, V, W):
        return np.stack([U + 0.1 * V, W * np.ones_like(U), V])

    sg = q.ScanGeneric(u=np.linspace(-2e-3, 2e-3, 5),
                       v=np.linspace(0, 8e-3, 7), w=[0.0], trans=shear)
    P = sg.positions()
    assert P.shape == (3, 5, 7, 1)
    # check the shear: x = u + 0.1 v
    U, V, _ = np.meshgrid(sg.u, sg.v, sg.w, indexing="ij")
    assert np.allclose(P[0], U + 0.1 * V)
    assert np.allclose(P[2], V)


def test_medium_sampled_offgrid():
    """Medium.Sampled: method='nearest' snaps off-grid queries to the
    nearest sample; the default cubic interpolates smoothly (the
    reference's gridded-interpolant behavior, ``Medium.m:465``)."""
    import qups_jax as q

    grid = q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 5), y=[0.0],
                           z=np.linspace(0, 4e-3, 5))
    cmap = np.full(grid.shape, 1500.0)
    zdim = grid.order.index("Z")
    sl = [slice(None)] * 3
    sl[zdim] = slice(3, None)
    cmap[tuple(sl)] = 1600.0  # deep layer
    med_n = q.Medium.Sampled(grid, c=cmap, c0=1540.0, method="nearest")
    q1 = q.ScanCartesian(x=[0.4e-3], y=[0.0], z=[0.4e-3])   # shallow -> 1500
    q2 = q.ScanCartesian(x=[0.0], y=[0.0], z=[3.4e-3])      # deep -> 1600
    assert np.isclose(np.asarray(med_n.props(q1, "c")).item(), 1500.0)
    assert np.isclose(np.asarray(med_n.props(q2, "c")).item(), 1600.0)
    # cubic (default): exact on grid nodes, smooth between
    med_c = q.Medium.Sampled(grid, c=cmap, c0=1540.0)
    qn = q.ScanCartesian(x=[0.0], y=[0.0], z=[1e-3])  # exactly a grid node
    assert np.isclose(np.asarray(med_c.props(qn, "c")).item(), 1500.0)
    v = np.asarray(med_c.props(q2, "c")).item()
    assert 1490.0 < v < 1620.0  # smooth ramp across the layer (CR overshoot ok)
    assert not np.isclose(v, 1500.0) and not np.isclose(v, 1600.0)


def test_dict2obj_nested_scan_roundtrip():
    """io.obj2dict/dict2obj round-trips an UltrasoundSystem with nested
    scan/seq/xdc (the VERDICT round-1 test gap)."""
    import qups_jax as q
    from qups_jax.io import obj2dict, dict2obj

    us = q.UltrasoundSystem(
        tx=q.TransducerArray(numel=8, pitch=0.4e-3, fc=4e6),
        seq=q.Sequence(type="PW", focus=np.array(
            [[0.0, 0.1], [0, 0], [1.0, 0.995]]), c0=1500.0),
        scan=q.ScanPolar(origin=(0, 0, -1e-3), r=np.linspace(0, 0.03, 16),
                         a=np.linspace(-20, 20, 9)),
        fs=16e6)
    d = obj2dict(us)
    us2 = dict2obj(d)
    assert isinstance(us2.scan, q.ScanPolar)
    assert np.allclose(us2.scan.r, us.scan.r)
    assert us2.seq.type == "PW"
    assert np.allclose(us2.seq.focus_array, us.seq.focus_array)
    assert us2.tx.numel == 8 and np.isclose(us2.fs, 16e6)


def test_system_das_multiframe():
    """Multi-frame (F > 1) data through system.DAS (XLA path): per-frame
    equality with single-frame calls."""
    import qups_jax as q
    rng = np.random.default_rng(0)
    T, N, M, F = 128, 8, 3, 2
    ang = np.radians([-5, 0, 5.0])
    xdc = q.TransducerArray(numel=N, pitch=0.4e-3, fc=4e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=q.Sequence(type="PW", focus=np.stack(
            [np.sin(ang), 0 * ang, np.cos(ang)]), c0=1540.0),
        scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8), y=[0.0],
                             z=np.linspace(2e-3, 8e-3, 8)),
        fs=16e6)
    x = rng.standard_normal((T, N, M, F)).astype(np.float32)
    chd = q.ChannelData(data=x, fs=16e6, t0=0.0)
    b = np.asarray(us.DAS(chd, method="linear"))
    assert b.shape[-1] == F
    for f in range(F):
        bf = np.asarray(us.DAS(q.ChannelData(data=x[..., f], fs=16e6,
                                             t0=0.0), method="linear"))
        assert np.allclose(b[..., f].squeeze(), bf.squeeze(), atol=1e-4)
