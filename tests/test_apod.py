"""Apodization-generator tests (USTest `ap*` coverage): shapes, masks, and
physics sanity for the 7 generators."""
import numpy as np
import pytest

import qups_jax as q

C0 = 1540.0


def make_us(seq=None):
    xdc = q.TransducerArray(numel=16, pitch=0.5e-3, fc=3e6)
    if seq is None:
        pf = np.stack([np.linspace(-3e-3, 3e-3, 7), np.zeros(7),
                       np.full(7, 30e-3)])
        seq = q.Sequence(type="FC", focus=pf, c0=C0)
    scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 17),
                           z=np.linspace(20e-3, 40e-3, 21))
    return q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=24e6)


def test_ap_scanline():
    us = make_us()
    a = us.ap_scanline()
    # (1, X, 1, 1, M) for order ZXY
    assert a.shape == (1, 17, 1, 1, 7)
    # each tx's mask selects pixels near its focus lateral position
    X = us.scan.x
    fx = us.seq.focus_array[0]
    for m in range(7):
        on = np.where(a[0, :, 0, 0, m])[0]
        assert all(abs(X[i] - fx[m]) < us.scan.dx for i in on)


def test_ap_multiline():
    us = make_us()
    a = us.ap_multiline()
    assert a.shape == (1, 17, 1, 1, 7)
    X = us.scan.x
    fx = us.seq.focus_array[0]
    inside = (X >= fx.min()) & (X <= fx.max())
    s = a[0, :, 0, 0, :].sum(-1)
    assert np.allclose(s[inside], 1.0, atol=1e-6)  # interp weights sum to 1
    assert np.allclose(s[~inside], 0.0)


def test_ap_translating_aperture():
    us = make_us()
    a = us.ap_translating_aperture(tol=(1e-3, 2e-3))
    assert a.shape == (1, 17, 1, 16, 7)
    # a pixel is accepted only when near the tx scanline AND the rx element
    X = us.scan.x
    xn = us.rx.positions()[0]
    fx = us.seq.focus_array[0]
    i, n, m = 8, 7, 3
    want = (abs(X[i] - fx[m]) <= 1e-3) and (abs(X[i] - xn[n]) <= 2e-3)
    assert bool(a[0, i, 0, n, m]) == want


def test_ap_aperture_growth():
    us = make_us()
    a = us.ap_aperture_growth(f=1.5)
    assert a.shape == us.scan.shape + (16, 1)
    # deeper pixels accept more elements
    counts = a[:, 8, 0, :, 0].sum(-1)  # vs depth (dim 0 = Z for ZXY)
    assert counts[-1] >= counts[0]
    # directly-below element always accepted at depth
    P = us.scan.positions()
    xn = us.rx.positions()[0]
    iz = 10
    ix = 8
    n = int(np.argmin(np.abs(xn - P[0, iz, ix, 0])))
    assert a[iz, ix, 0, n, 0] == 1.0


def test_ap_aperture_growth_convex():
    xdc = q.TransducerConvex.C5_2v()
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=xdc.numel, c0=C0),
        scan=q.ScanCartesian(x=np.linspace(-20e-3, 20e-3, 21),
                             z=np.linspace(10e-3, 80e-3, 29)), fs=20e6)
    a = us.ap_aperture_growth(f=1.0)
    assert a.shape == us.scan.shape + (xdc.numel, 1)
    assert 0 < a.mean() < 1


def test_ap_tx_parallelogram():
    seq = q.SequenceRadial(type="PW", angles=[-15.0, 0.0, 15.0], c0=C0)
    us = make_us(seq=seq)
    a = us.ap_tx_parallelogram()
    assert a.shape == us.scan.shape[:3] + (1, 3)
    # for the 0-degree wave, pixels directly above the aperture accepted
    pb = us.xdc.bounds()
    X = us.scan.x
    inside = (pb[0, 0] < X) & (X <= pb[0, 1])
    assert np.array_equal(a[0, :, 0, 0, 1] > 0, inside)
    # steered wave shifts the accepted parallelogram with depth
    mid_z = us.scan.shape[0] // 2
    assert a[:, :, 0, 0, 0].sum() > 0


def test_ap_acceptance_angle():
    us = make_us()
    a = us.ap_acceptance_angle(theta=30.0)
    assert a.shape == us.scan.shape + (16, 1)
    # pixel straight ahead of an element is accepted
    P = us.scan.positions()
    xn = us.rx.positions()[0]
    n = 8
    ix = int(np.argmin(np.abs(us.scan.x - xn[n])))
    assert a[5, ix, 0, n, 0] == 1.0
    # narrow angle rejects off-axis
    a2 = us.ap_acceptance_angle(theta=2.0)
    assert a2.sum() < a.sum()


def test_ap_cosine_angle():
    us = make_us()
    w = us.ap_cosine_angle(theta=45.0)
    assert w.shape == us.scan.shape + (16, 1)
    assert (w >= 0).all() and (w <= 1).all()
    # on-axis weight ~1, decreasing off-axis
    P = us.scan.positions()
    xn = us.rx.positions()[0]
    n = 8
    ix = int(np.argmin(np.abs(us.scan.x - xn[n])))
    assert w[5, ix, 0, n, 0] > 0.97
    assert w[5, 0, 0, -1, 0] < w[5, ix, 0, n, 0]


def test_apod_in_das_pipeline():
    # generators compose with DAS (growth * acceptance angle)
    us = make_us(seq=q.SequenceRadial(type="PW", angles=[0.0], c0=C0))
    scat = q.Scatterers(pos=[[0.0], [0.0], [30e-3]], c0=C0)
    chd = us.greens(scat)
    b = us.DAS(chd, apod=(us.ap_aperture_growth(), us.ap_acceptance_angle()))
    bm = np.abs(np.asarray(b)).squeeze()
    i, j = np.unravel_index(bm.argmax(), bm.shape)
    P = us.scan.positions()
    assert abs(P[0, i, j, 0]) < 1.1e-3
    assert abs(P[2, i, j, 0] - 30e-3) < 1.1e-3
