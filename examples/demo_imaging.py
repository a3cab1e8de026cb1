"""End-to-end imaging demo — the analog of the reference's ``example_.m``
walkthrough (``/root/reference/example_.m``): define a system, simulate a
phantom, beamform with several beamformers, and save figures.

Runs headless (Agg backend) on CPU or GPU; figures land in
``examples/out/``.

    python examples/demo_imaging.py
"""
import os
import sys

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import qups_jax as q
from qups_jax.utils import to_host

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
os.makedirs(OUT, exist_ok=True)

# ---------------------------------------------------------------- system
xdc = q.TransducerArray.L11_5v()                      # 128-el linear probe
seq = q.SequenceRadial(type="PW", angles=np.arange(-10, 11, 5), c0=1540.0)
scan = q.ScanCartesian(x=np.linspace(-12e-3, 12e-3, 256),
                       z=np.linspace(15e-3, 35e-3, 256))
us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=4 * xdc.fc)

# ------------------------------------------------------------ simulation
# a point-target grid phantom (Scatterers.Grid analog)
zs = np.linspace(18e-3, 32e-3, 4)
xs = np.linspace(-8e-3, 8e-3, 5)
Zs, Xs = np.meshgrid(zs, xs, indexing="ij")
pos = np.stack([Xs.ravel(), np.zeros(Xs.size), Zs.ravel()])
scat = q.Scatterers(pos=pos, amp=np.ones(pos.shape[1]), c0=1540.0)
chd = us.greens(scat)                                  # (T, N, M)
print("simulated ChannelData:", chd.data.shape, "fs", chd.fs)

fig, ax = plt.subplots(figsize=(5, 4))
from qups_jax.display import chd_imagesc
chd_imagesc(chd, m=chd.M // 2, ax=ax)
fig.savefig(os.path.join(OUT, "channel_data.png"), dpi=110)

# ----------------------------------------------------------- beamforming
imgs = {}
imgs["DAS"] = us.DAS(chd)                              # fused kernel/XLA
imgs["bfDAS"] = us.bfDAS(chd)                          # table-based
imgs["bfAdjoint"] = us.bfAdjoint(chd)                  # freq-domain
imgs["coherence"] = us.coherence_image(chd)            # cohfac

def envelope(b):
    """Host |image| on the scan grid (joins an ri channel pair)."""
    x = to_host(b)
    if not np.iscomplexobj(x) and x.ndim > 3 and x.shape[-1] == 2:
        x = x[..., 0] + 1j * x[..., 1]          # out='ri' convention
    return np.abs(x).reshape(tuple(scan.shape) + (-1,))[..., 0, 0]


from qups_jax.display import scan_imagesc
fig, axs = plt.subplots(1, 4, figsize=(16, 4))
for ax, (name, b) in zip(axs, imgs.items()):
    if name == "coherence":
        h = ax.imshow(envelope(b),
                      extent=[scan.x[0] * 1e3, scan.x[-1] * 1e3,
                              scan.z[-1] * 1e3, scan.z[0] * 1e3],
                      cmap="magma", vmin=0, vmax=1)
        ax.set_xlabel("x [mm]")
        ax.set_ylabel("z [mm]")
    else:
        h = scan_imagesc(scan, b, ax=ax, dbr=50.0)
    ax.set_title(name)
    fig.colorbar(h, ax=ax, shrink=0.8)
fig.tight_layout()
fig.savefig(os.path.join(OUT, "beamformers.png"), dpi=110)

# localization check: every beamformer should put its global peak on a
# scatterer (within the BFTest 1.1 mm oracle)
P = scan.positions().reshape(3, -1)
for name, b in imgs.items():
    bi = envelope(b)
    k = int(bi.argmax())
    d = np.linalg.norm(pos.T[:, None, :] - P[:, k][None, None, :],
                       axis=-1).min()
    print(f"{name:10s} peak-to-nearest-scatterer: {d * 1e3:.2f} mm")
    assert d < 1.1e-3, (name, d)

print("demo complete — figures in", OUT)
