"""Interop round-trip tests on synthetic fixtures (the reference's
InteropTest pattern: external files are optional, synthetic structs are
exercised always — ``test/InteropTest.m:30-76``)."""
import numpy as np
import pytest

import qups_jax as q
from qups_jax import interop


def _trans_struct(numel=16, fc=5.0):
    pitch_mm = 0.3
    x = (np.arange(numel) - (numel - 1) / 2) * pitch_mm
    pos = np.zeros((numel, 5))
    pos[:, 0] = x
    return dict(name="L-test", units="mm", frequency=fc, numelements=numel,
                elementWidth=0.27, elementLength=5.0, spacingMm=pitch_mm,
                Bandwidth=np.array([3.0, 7.0]), type=0, ElementPos=pos,
                ConnectorES=np.arange(1, numel + 1))


def test_transducer_from_verasonics():
    numel = 16
    xdc = interop.transducer_from_verasonics(_trans_struct(numel))
    assert isinstance(xdc, q.TransducerArray)
    assert xdc.numel == numel
    assert np.isclose(xdc.pitch, 0.3e-3)
    assert np.isclose(xdc.fc, 5e6)
    assert np.isclose(xdc.bw[0], 3e6) and np.isclose(xdc.bw[1], 7e6)
    p = xdc.positions()
    assert np.isclose(p[0].max() - p[0].min(), 0.3e-3 * (numel - 1))


def test_sequence_from_verasonics_pw():
    Trans = _trans_struct()
    angs = np.radians([-10.0, 0.0, 10.0])
    TX = [dict(Apod=np.ones(16), Steer=np.array([a, 0.0]), focus=0.0,
               Origin=np.zeros(3), Delay=np.zeros(16)) for a in angs]
    # compute Vantage-convention delays from the geometry so validation
    # passes: Vantage delays are -qups delays + offset (in wavelengths)
    xdc = interop.transducer_from_verasonics(Trans)
    fc = 5e6
    for t, a in zip(TX, angs):
        seqa = q.Sequence(type="PW", focus=np.array(
            [[np.sin(a)], [0.0], [np.cos(a)]]), c0=1540.0)
        tau = seqa.delays(xdc)[:, 0]
        t["Delay"] = (-tau + tau.max()) * fc  # nonneg, wavelength units
    seq, t0 = interop.sequence_from_verasonics(TX, Trans)
    assert seq.type == "PW"
    assert seq.num_pulse == 3
    f = seq.focus_array
    got = np.degrees(np.arctan2(f[0], f[2]))
    assert np.allclose(got, [-10, 0, 10], atol=1e-3)
    assert np.all(np.isfinite(t0))  # delays verified to an offset


def test_sequence_from_verasonics_fsa():
    Trans = _trans_struct()
    TX = [dict(Apod=(np.arange(16) == i).astype(float),
               Steer=np.zeros(2), focus=0.0, Origin=np.zeros(3),
               Delay=np.zeros(16)) for i in range(16)]
    seq, _ = interop.sequence_from_verasonics(TX, Trans)
    assert seq.type == "FSA"
    assert seq.num_pulse == 16


def test_channel_data_from_verasonics():
    numel, A, T, F = 8, 4, 64, 2
    rng = np.random.default_rng(0)
    buf = rng.integers(-100, 100, (T * A, numel, F)).astype(np.int16)
    Receive = []
    for f in range(1, F + 1):
        for a in range(1, A + 1):
            Receive.append(dict(bufnum=1, framenum=f, acqNum=a,
                                startSample=(a - 1) * T + 1,
                                endSample=a * T,
                                decimSampleRate=25.0, demodFrequency=0.0,
                                sampleMode="NS200BW",
                                Apod=np.ones(numel)))
    chds, fmods, smodes = interop.channel_data_from_verasonics(
        [buf], Receive, Trans=_trans_struct(numel))
    chd = chds[0]
    assert chd.data.shape == (T, numel, A, F)
    assert np.isclose(chd.fs, 25e6)
    # spot-check a sample mapping: acq a, channel n, frame f
    assert np.allclose(np.asarray(chd.data)[:, 3, 2, 1],
                       buf[2 * T:3 * T, 3, 1])


def test_channel_data_sample_mode_zeros():
    numel, A, T = 4, 1, 32
    buf = np.ones((T, numel, 1), np.int16)
    Receive = [dict(bufnum=1, framenum=1, acqNum=1, startSample=1,
                    endSample=T, decimSampleRate=10.0, demodFrequency=2.0,
                    sampleMode="BS100BW", Apod=np.ones(numel))]
    chds, fmods, _ = interop.channel_data_from_verasonics([buf], Receive)
    x = np.asarray(chds[0].data)
    # [1,1,0,0] pattern: 2 zeros inserted every 2 samples
    assert x.shape[0] == 2 * T
    assert np.all(x[0::4] == 1) and np.all(x[1::4] == 1)
    assert np.all(x[2::4] == 0) and np.all(x[3::4] == 0)
    assert np.isclose(fmods[0], 2e6)


def test_scan_from_verasonics():
    PData = dict(Coord="rectangular", Size=np.array([64, 128, 1]),
                 PDelta=np.array([0.5, 0.0, 0.25]),
                 Origin=np.array([-32.0, 0.0, 0.0]))
    scan = interop.scan_from_verasonics(PData, scale=1e-3)
    assert isinstance(scan, q.ScanCartesian)
    assert scan.nx == 128 and scan.nz == 64
    assert np.isclose(scan.dx, 0.5e-3) and np.isclose(scan.dz, 0.25e-3)


def test_waveform_from_verasonics():
    t = np.arange(100)
    tri = np.where((t > 20) & (t < 80), np.sign(np.sin(2 * np.pi * t / 20)),
                   0.0)
    TW = dict(Parameters=np.array([5.0, 0.67, 2, 1]), peak=1.0,
              numsamples=100, TriLvlWvfm=tri, Wvfm1Wy=tri * 0.5,
              Wvfm2Wy=tri * 0.25)
    wv = interop.waveform_from_verasonics(TW)
    s = np.asarray(wv.sample(wv.t0 + np.arange(100) / 250e6))
    assert np.allclose(s, tri, atol=1e-6)


def test_uff_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    xdc = q.TransducerArray(numel=8, pitch=0.4e-3, fc=6e6)
    seq = q.Sequence(type="PW", focus=np.array(
        [[0.0, 0.1], [0, 0], [1.0, 0.99]]), c0=1500.0)
    scan = q.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 32), y=[0.0],
                           z=np.linspace(0, 20e-3, 64))
    chd = q.ChannelData(
        data=(rng.standard_normal((48, 8, 2))
              + 1j * rng.standard_normal((48, 8, 2))).astype(np.complex64),
        fs=20e6, t0=np.array([1e-6, 2e-6]))
    p = tmp_path / "t.uff"
    interop.save_uff(p, chd=chd, xdc=xdc, seq=seq, scan=scan)
    out = interop.load_uff(p)
    assert np.allclose(np.asarray(out["chd"].data), np.asarray(chd.data))
    assert np.isclose(out["chd"].fs, chd.fs)
    assert np.allclose(out["chd"].t0_host, chd.t0_host)
    assert isinstance(out["xdc"], q.TransducerArray)
    assert np.isclose(out["xdc"].pitch, xdc.pitch)
    assert out["xdc"].numel == xdc.numel
    assert out["seq"].type == "PW"
    assert np.allclose(out["seq"].focus_array, seq.focus_array)
    assert np.allclose(out["scan"].x, scan.x)
    assert np.allclose(out["scan"].z, scan.z)


def test_mat_round_trip(tmp_path):
    xdc = q.TransducerConvex(numel=12, radius=40e-3, fc=3e6)
    scan = q.ScanPolar(origin=(0, 0, -1e-3), r=np.linspace(0, 30e-3, 64),
                       a=np.linspace(-30, 30, 32))
    p = tmp_path / "t.mat"
    interop.save_mat(p, xdc=xdc, scan=scan)
    out = interop.load_mat(p)
    assert isinstance(out["xdc"], q.TransducerConvex)
    assert np.isclose(out["xdc"].radius, 40e-3)
    assert out["xdc"].numel == 12
    assert isinstance(out["scan"], q.ScanPolar)
    assert np.allclose(out["scan"].r, scan.r)


def test_load_verasonics_workspace(tmp_path):
    """End-to-end: save a synthetic Vantage workspace .mat, import it."""
    from scipy.io import savemat
    numel, A, T = 8, 3, 32
    rng = np.random.default_rng(2)
    Trans = _trans_struct(numel)
    Receive = np.zeros((A,), dtype=[
        ("bufnum", "O"), ("framenum", "O"), ("acqNum", "O"),
        ("startSample", "O"), ("endSample", "O"), ("decimSampleRate", "O"),
        ("demodFrequency", "O"), ("sampleMode", "O"), ("Apod", "O")])
    for a in range(A):
        Receive[a] = (1, 1, a + 1, a * T + 1, (a + 1) * T, 20.0, 0.0,
                      "NS200BW", np.ones(numel))
    angs = np.radians([-5.0, 0.0, 5.0])
    TX = np.zeros((A,), dtype=[
        ("Apod", "O"), ("Steer", "O"), ("focus", "O"), ("Origin", "O"),
        ("Delay", "O")])
    for i, a in enumerate(angs):
        TX[i] = (np.ones(numel), np.array([a, 0.0]), 0.0, np.zeros(3),
                 np.zeros(numel))
    ws = dict(Trans=Trans, Receive=Receive, TX=TX,
              RcvData=np.empty((1,), object),
              Resource=dict(Parameters=dict(speedOfSound=1540.0)))
    ws["RcvData"][0] = rng.integers(-50, 50, (T * A, numel, 1)).astype(np.int16)
    p = tmp_path / "ws.mat"
    savemat(p, ws, long_field_names=True)
    out = interop.load_verasonics(p)
    assert isinstance(out["xdc"], q.TransducerArray)
    assert out["seq"].type in ("PW", "FSA")
    assert out["chd"][0].data.shape == (T, numel, A, 1)


def test_load_uff_ustb_dialect(tmp_path):
    """Read a synthetic file in MATLAB USTB conventions: char-code
    class attributes, column-major (reversed-axis) data, uff.wave sequence
    children with uff.point sources, linear_array probe fields
    (mapping per ``src/ChannelData.m:180-240``, ``src/Sequence.m:540-612``)."""
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "ustb.uff"
    T, N, M = 32, 8, 3
    rng = np.random.default_rng(3)
    data = rng.standard_normal((T, N, M)).astype(np.float32)
    angles = np.radians([-10.0, 0.0, 10.0])
    pitch, fc, c0, fs, it0 = 0.3e-3, 5e6, 1540.0, 20e6, 2e-6

    def chararr(s):
        return np.array([ord(c) for c in s], np.uint16)

    with h5py.File(path, "w") as f:
        f.attrs["version"] = chararr("v1.2.0")
        g = f.create_group("channel_data")
        g.attrs["class"] = chararr("uff.channel_data")
        # MATLAB column-major: (T, N, M) appears reversed in HDF5
        g.create_dataset("data", data=np.transpose(data))
        g.create_dataset("sampling_frequency", data=np.float64(fs))
        g.create_dataset("initial_time", data=np.float64(it0))
        g.create_dataset("sound_speed", data=np.float64(c0))
        pu = g.create_group("pulse")
        pu.attrs["class"] = chararr("uff.pulse")
        pu.create_dataset("center_frequency", data=np.float64(fc))
        pg = g.create_group("probe")
        pg.attrs["class"] = chararr("uff.linear_array")
        xs = (np.arange(N) - (N - 1) / 2) * pitch
        geom = np.stack([xs, np.zeros(N), np.zeros(N), np.zeros(N),
                         np.zeros(N), np.full(N, 0.27e-3),
                         np.full(N, 5e-3)])  # (7, N): column-major transpose
        pg.create_dataset("geometry", data=geom)
        pg.create_dataset("pitch", data=np.float64(pitch))
        pg.create_dataset("N", data=np.float64(N))
        sg = g.create_group("sequence")
        sg.attrs["array"] = chararr("1")
        for i, a in enumerate(angles):
            w = sg.create_group(f"sequence_{i + 1:04d}")
            w.attrs["class"] = chararr("uff.wave")
            w.create_dataset("wavefront", data=np.int32(0))  # plane
            w.create_dataset("delay", data=np.float64(0.0))
            sp = w.create_group("source")
            sp.attrs["class"] = chararr("uff.point")
            sp.create_dataset("azimuth", data=np.float64(a))
            sp.create_dataset("elevation", data=np.float64(0.0))
            sp.create_dataset("distance", data=np.float64(np.inf))

    out = interop.load_uff(path)
    chd, xdc, seq = out["chd"], out["xdc"], out["seq"]
    assert chd.data.shape == (T, N, M)
    assert np.allclose(np.asarray(chd.data), data)
    assert float(chd.fs) == fs
    # zero wave delays -> t0 from initial_time
    assert np.allclose(np.asarray(chd.t0_host).reshape(-1), it0)
    assert isinstance(xdc, q.TransducerArray)
    assert xdc.numel == N and np.isclose(xdc.pitch, pitch)
    assert np.isclose(xdc.fc, fc)  # from the pulse center frequency
    assert seq.type == "PW"
    nv = seq.focus_array  # (3, M) unit directions
    assert np.allclose(nv[0], np.sin(angles), atol=1e-6)
    assert np.allclose(nv[2], np.cos(angles), atol=1e-6)


def test_load_uff_ustb_picmus_iq_end_to_end(tmp_path):
    """PICMUS-convention round trip: a plane-wave IQ acquisition written in
    the MATLAB-USTB on-disk layout (complex data as a real/imag group with
    column-major axes, ``modulation_frequency``, uff.wave sequence children
    with plane wavefronts, uff.linear_array probe, uff.linear_scan) loads
    into a (chd, xdc, seq, scan, fmod) bundle that beamforms to the correct
    PSF — the full import->image pipeline the reference drives through
    USTB's PICMUS datasets (``src/ChannelData.m:180-240``,
    ``examples/...PICMUS``)."""
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "picmus_like.uff"
    c0, fc = 1540.0, 3e6
    target = np.array([0.0, 0.0, 20e-3])
    angles = np.radians([-5.0, 0.0, 5.0])
    xdc = q.TransducerArray(numel=32, pitch=0.3e-3, fc=fc)
    seq = q.SequenceRadial(type="PW", angles=np.degrees(angles), c0=c0)
    scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 41),
                           z=np.linspace(16e-3, 24e-3, 41))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=24e6)
    chd = us.greens(q.Scatterers(pos=target.reshape(3, 1), c0=c0))
    iq = chd.downmix(fc)  # complex baseband, the PICMUS data format
    data = np.asarray(iq.data)  # (T, N, M)
    t0 = float(np.asarray(chd.t0_host).reshape(-1)[0])

    def chararr(s):
        return np.array([ord(c) for c in s], np.uint16)

    with h5py.File(path, "w") as f:
        f.attrs["version"] = chararr("v1.2.0")
        g = f.create_group("channel_data")
        g.attrs["class"] = chararr("uff.channel_data")
        dg = g.create_group("data")  # USTB complex: real/imag pair
        dg.attrs["complex"] = np.int16(1)
        # MATLAB column-major: axes appear reversed through h5py
        dg.create_dataset("real", data=np.transpose(data.real))
        dg.create_dataset("imag", data=np.transpose(data.imag))
        g.create_dataset("sampling_frequency", data=np.float64(us.fs))
        g.create_dataset("initial_time", data=np.float64(t0))
        g.create_dataset("sound_speed", data=np.float64(c0))
        g.create_dataset("modulation_frequency", data=np.float64(fc))
        pg = g.create_group("probe")
        pg.attrs["class"] = chararr("uff.linear_array")
        xs = (np.arange(32) - 31 / 2) * 0.3e-3
        geom = np.stack([xs, np.zeros(32), np.zeros(32), np.zeros(32),
                         np.zeros(32), np.full(32, 0.27e-3),
                         np.full(32, 5e-3)])  # (7, N) column-major
        pg.create_dataset("geometry", data=geom)
        pg.create_dataset("pitch", data=np.float64(0.3e-3))
        pg.create_dataset("N", data=np.float64(32))
        pu = g.create_group("pulse")
        pu.attrs["class"] = chararr("uff.pulse")
        pu.create_dataset("center_frequency", data=np.float64(fc))
        sg = g.create_group("sequence")
        sg.attrs["array"] = chararr("1")
        for i, a in enumerate(angles):
            w = sg.create_group(f"sequence_{i + 1:04d}")
            w.attrs["class"] = chararr("uff.wave")
            w.create_dataset("wavefront", data=np.int32(0))  # plane
            w.create_dataset("delay", data=np.float64(0.0))
            sp = w.create_group("source")
            sp.attrs["class"] = chararr("uff.point")
            sp.create_dataset("azimuth", data=np.float64(a))
            sp.create_dataset("elevation", data=np.float64(0.0))
            sp.create_dataset("distance", data=np.float64(np.inf))
        cg = g.create_group("scan")
        cg.attrs["class"] = chararr("uff.linear_scan")
        cg.create_dataset("x_axis", data=np.asarray(scan.x, np.float64))
        cg.create_dataset("y_axis", data=np.zeros(1))
        cg.create_dataset("z_axis", data=np.asarray(scan.z, np.float64))

    out = interop.load_uff(path)
    assert out["fmod"] == fc
    chd2, xdc2, seq2, scan2 = out["chd"], out["xdc"], out["seq"], out["scan"]
    assert np.iscomplexobj(np.asarray(chd2.data))
    assert np.allclose(np.asarray(chd2.data), data, atol=1e-6)
    assert isinstance(scan2, q.ScanCartesian) and scan2.shape[:2] == (41, 41)
    us2 = q.UltrasoundSystem(tx=xdc2, rx=xdc2, seq=seq2, scan=scan2,
                             fs=float(chd2.fs))
    b = np.abs(np.asarray(us2.DAS(chd2, fmod=out["fmod"]))).squeeze()
    i, j = np.unravel_index(np.argmax(b), b.shape)
    P = us2.scan.positions()
    assert abs(P[0, i, j, 0] - target[0]) < 1.1e-3
    assert abs(P[2, i, j, 0] - target[2]) < 1.1e-3


def test_load_uff_ustb_focused_vs(tmp_path):
    """USTB spherical waves with finite-distance sources map to a VS
    sequence with t0 = delay - |focus|/c0 (``src/ChannelData.m:222``)."""
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "ustb_vs.uff"
    M = 3
    foci = np.stack([np.linspace(-2e-3, 2e-3, M), np.zeros(M),
                     np.full(M, 30e-3)])  # (3, M)
    c0 = 1540.0

    def chararr(s):
        return np.array([ord(c) for c in s], np.uint16)

    with h5py.File(path, "w") as f:
        f.attrs["version"] = chararr("v1.2.0")
        g = f.create_group("channel_data")
        g.attrs["class"] = chararr("uff.channel_data")
        g.create_dataset("data", data=np.zeros((M, 4, 16)))  # (M,N,T) rev
        g.create_dataset("sampling_frequency", data=np.float64(10e6))
        g.create_dataset("sound_speed", data=np.float64(c0))
        sg = g.create_group("sequence")
        for i in range(M):
            w = sg.create_group(f"sequence_{i + 1:04d}")
            w.attrs["class"] = chararr("uff.wave")
            w.create_dataset("wavefront", data=np.int32(1))  # spherical
            w.create_dataset("delay", data=np.float64(1e-6))
            sp = w.create_group("source")
            sp.attrs["class"] = chararr("uff.point")
            d = np.linalg.norm(foci[:, i])
            sp.create_dataset("azimuth",
                              data=np.float64(np.arctan2(foci[0, i],
                                                         foci[2, i])))
            sp.create_dataset("elevation", data=np.float64(0.0))
            sp.create_dataset("distance", data=np.float64(d))

    out = interop.load_uff(path)
    seq, chd = out["seq"], out["chd"]
    assert seq.type == "VS"
    assert np.allclose(seq.focus_array, foci, atol=1e-9)
    want_t0 = 1e-6 - np.linalg.norm(foci, axis=0) / c0
    assert np.allclose(np.asarray(chd.t0_host).reshape(-1), want_t0)


def test_genuine_uff_fixture_if_available():
    """Environment-gated genuine-USTB validation (the reference's VSX-file
    pattern, test/InteropTest.m:30-76): point QUPS_UFF_FIXTURE at a real
    USTB/PICMUS .uff file and this test loads and sanity-checks it.
    Skips when absent — the documented dialect risk stays open until a
    genuine file can be supplied."""
    import os
    path = os.environ.get("QUPS_UFF_FIXTURE", "")
    if not path or not os.path.exists(path):
        pytest.skip("no genuine UFF fixture available (QUPS_UFF_FIXTURE)")
    from qups_jax.interop import load_uff
    out = load_uff(path)
    assert out, "nothing recognized in the genuine UFF file"
    if "chd" in out:
        chd = out["chd"]
        assert chd.T > 0 and chd.N > 0 and chd.M > 0
        assert np.isfinite(np.abs(np.asarray(chd.data))).any()
    if "xdc" in out:
        assert out["xdc"].numel > 0


def test_uff_spherical_generic_scan_roundtrip():
    """save_uff/load_uff round-trip of the two scan types previously
    without an export mapping (VERDICT r4 missing #5): ScanSpherical via
    qups-annotated uff.scan, ScanGeneric via base uff.scan xyz points."""
    import tempfile
    from qups_jax.interop import save_uff, load_uff

    sph = q.ScanSpherical(r=np.linspace(10e-3, 30e-3, 8),
                          a=np.linspace(-10, 10, 5),
                          e=np.linspace(-4, 4, 3), origin=(0, 1e-3, 2e-3))
    pos = np.random.default_rng(0).uniform(-3e-3, 3e-3, (3, 6, 5, 2))
    gen = q.ScanGeneric(pos=pos)
    for scan in (sph, gen):
        with tempfile.NamedTemporaryFile(suffix=".uff") as tf:
            save_uff(tf.name, scan=scan)
            out = load_uff(tf.name)
        s2 = out["scan"]
        assert type(s2) is type(scan)
        P1 = np.asarray(scan.positions()).reshape(3, -1)
        P2 = np.asarray(s2.positions()).reshape(3, -1)
        assert s2.shape == scan.shape
        assert np.abs(P1 - P2).max() < 1e-9


def test_uff_scalar_as_1x1_datasets():
    """MATLAB writes scalars as 1x1 arrays; every scalar read must
    squeeze (the second dialect risk enumerated in the interop module
    note). Fixture mimics a USTB-written file: 1x1 scalars, char-code
    class attrs with non-canonical casing."""
    import tempfile
    import h5py
    from qups_jax.interop import load_uff

    with tempfile.NamedTemporaryFile(suffix=".uff") as tf:
        with h5py.File(tf.name, "w") as f:
            g = f.create_group("channel_data")
            # class attr as uint16 char codes, mixed case
            g.attrs["class"] = np.array(
                [ord(c) for c in "UFF.Channel_Data"], np.uint16)
            g.create_dataset("data", data=np.zeros((3, 2, 4, 8)))
            g.create_dataset("sampling_frequency",
                             data=np.array([[25e6]]))  # 1x1
            g.create_dataset("initial_time", data=np.array([[1e-6]]))
            g.create_dataset("sound_speed", data=np.array([[1540.0]]))
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # casing fallback warns
            out = load_uff(tf.name)
    assert "chd" in out
    chd = out["chd"]
    assert float(chd.fs) == 25e6
    assert abs(float(np.asarray(chd.t0_host).reshape(-1)[0]) - 1e-6) < 1e-12
