"""Display helpers (Agg backend) — the docs-as-tests pattern for the
visualization surface (``src/ChannelData.m:1497-1640``, ``Scan.m:288-593``)."""
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import qups_jax as q  # noqa: E402
import qups_jax.display  # noqa: E402,F401  (binds the methods)


@pytest.fixture(autouse=True)
def _close():
    yield
    plt.close("all")


def test_chd_imagesc_and_gif(tmp_path):
    rng = np.random.default_rng(0)
    chd = q.ChannelData(data=rng.standard_normal((64, 16, 3)).astype(np.float32),
                        fs=20e6, t0=0.0)
    h = chd.imagesc(m=1)
    assert h.get_array().shape == (64, 16)
    anim = chd.gif()
    anim.save(tmp_path / "chd.gif", writer="pillow", dpi=40)
    assert (tmp_path / "chd.gif").stat().st_size > 0


def test_scan_imagesc_cartesian_and_polar():
    scan = q.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 32), y=[0.0],
                           z=np.linspace(0, 20e-3, 64))
    b = np.random.rand(*scan.shape)
    h = scan.imagesc(b)
    assert h.get_array().size == 32 * 64
    pol = q.ScanPolar(r=np.linspace(0, 20e-3, 48),
                      a=np.linspace(-30, 30, 33))
    bp = np.random.rand(*pol.shape) + 0.1
    h2 = pol.imagesc(bp)
    assert h2.get_array().size > 0


def test_medium_xdc_scat_plots():
    scan = q.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 16), y=[0.0],
                           z=np.linspace(0, 10e-3, 16))
    med = q.Medium(c0=1540.0, pertreg=((lambda P: P[2] > 5e-3, {"c": 1600.0}),))
    h = med.imagesc(scan, "c")
    assert float(np.nanmax(h.get_array())) >= 1600.0 - 1
    xdc = q.TransducerConvex(numel=16, radius=40e-3, fc=3e6)
    assert xdc.plot() is not None
    sc = q.Scatterers(pos=np.array([[0, 1e-3], [0, 0], [5e-3, 8e-3]]))
    assert sc.plot() is not None


def test_image_gif(tmp_path):
    scan = q.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 16), y=[0.0],
                           z=np.linspace(0, 10e-3, 16))
    frames = np.random.rand(*(tuple(scan.shape) + (1, 1, 4)))
    anim = scan.gif(frames.reshape(16, 16, 1, 4))
    anim.save(tmp_path / "img.gif", writer="pillow", dpi=40)
    assert (tmp_path / "img.gif").stat().st_size > 0


def test_scan_imagesc_volume_slice():
    """3-D volumes display a named slice plane (Scan.imagesc slice/index,
    src/Scan.m:385-406)."""
    import matplotlib
    matplotlib.use("Agg")
    import qups_jax as q
    from qups_jax.display import scan_imagesc
    scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 8),
                           y=np.linspace(-2e-3, 2e-3, 4),
                           z=np.linspace(10e-3, 20e-3, 6))
    vol = np.random.default_rng(0).random(scan.shape)
    h = scan_imagesc(scan, vol, index=1)          # default: slice Y
    assert h.get_array().shape == (6, 8)
    assert h.axes.get_xlabel().startswith("x")
    h = scan_imagesc(scan, vol, slice="x", index=3)
    assert h.get_array().shape == (6, 4)
    # slicing X leaves a z-y plane: each kept axis labeled by its OWN
    # letter with its own extent (regression: y data under an 'x' label)
    assert h.axes.get_xlabel().startswith("y")
    assert h.axes.get_ylabel().startswith("z")
    ext = h.get_extent()
    assert ext[0] == -2.0 and ext[1] == 2.0      # y in mm
    assert ext[2] == 20.0 and ext[3] == 10.0     # z in mm, depth down
    h = scan_imagesc(scan, vol, slice="z", index=2)
    assert h.axes.get_xlabel().startswith("y")
    assert h.axes.get_ylabel().startswith("x")


def test_scan_vol3d():
    """vol3d analog (Scan.vol3d, src/Scan.m:512): MIP triptych and
    alpha-composited plane stack both render."""
    import matplotlib
    matplotlib.use("Agg")
    import qups_jax as q
    from qups_jax.display import scan_vol3d
    scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 8),
                           y=np.linspace(-2e-3, 2e-3, 4),
                           z=np.linspace(10e-3, 20e-3, 6))
    vol = np.random.default_rng(1).random(scan.shape)
    hs = scan_vol3d(scan, vol)
    assert len(hs) == 3
    hs = scan_vol3d(scan, vol, mode="alpha")
    assert len(hs) == 4
    # regressions: ny<4 must clamp per-pixel alpha into [0,1], and a
    # numpy array of axes (what plt.subplots returns) must be accepted
    import matplotlib.pyplot as plt
    scan2 = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 8),
                            y=np.linspace(-1e-3, 1e-3, 2),
                            z=np.linspace(10e-3, 20e-3, 6))
    vol2 = np.random.default_rng(2).random(scan2.shape)
    hs = scan_vol3d(scan2, vol2, mode="alpha")
    assert len(hs) == 2
    _, axs = plt.subplots(1, 3)
    hs = scan_vol3d(scan, vol, axs=axs, mode="alpha")
    assert len(hs) == 4


def test_scan_imagesc_ri_channel():
    """A trailing size-2 axis on real data is the ri convention
    (``out='ri'``): the display must show the complex envelope, not
    ``|real part|`` (regression for ri-format images)."""
    scan = q.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 32), y=[0.0],
                           z=np.linspace(0, 20e-3, 64))
    rng = np.random.default_rng(3)
    re = rng.standard_normal(tuple(scan.shape)).astype(np.float32)
    im = rng.standard_normal(tuple(scan.shape)).astype(np.float32)
    bri = np.stack([re, im], axis=-1)            # (64, 32, 1, 2)
    h = scan.imagesc(bri, dbr=None)
    env = np.abs(re + 1j * im)[:, :, 0]
    np.testing.assert_allclose(np.asarray(h.get_array()), env, rtol=1e-6)
    # explicit override: ri=False keeps the frame interpretation
    h2 = scan.imagesc(bri, dbr=None, ri=False)
    np.testing.assert_allclose(np.asarray(h2.get_array()),
                               np.abs(re)[:, :, 0], rtol=1e-6)
    # vol3d joins the same convention
    scan3 = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 8),
                            y=np.linspace(-2e-3, 2e-3, 4),
                            z=np.linspace(0, 8e-3, 8))
    b3 = rng.standard_normal(tuple(scan3.shape) + (2,)).astype(np.float32)
    hs = q.display.scan_vol3d(scan3, b3, dbr=None)
    assert len(hs) == 3
