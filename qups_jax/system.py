"""UltrasoundSystem — the synthesis/orchestration layer.

The counterpart of QUPS's ``UltrasoundSystem``
(``/root/reference/src/UltrasoundSystem.m:52-6015``): one object combining a
transmit/receive Transducer, a Sequence, a Scan, and a simulation sampling
frequency, whose methods are the simulators and beamformers.

Host-side geometry (numpy) feeds jitted XLA/Pallas compute (arrays only), so
parameter changes never trigger recompiles; shapes do.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .core.channel_data import ChannelData
from .core.scan import Scan, ScanCartesian, ScanPolar
from .core.scat import Scatterers
from .core.seq import Sequence
from .core.xdc import Transducer, TransducerArray, TransducerConvex, TransducerMatrix
from .ops.das import das, das_lut, delay_tables
from .ops.greens import greens_dense, greens_splat
from .ops.apod import Fused
from .utils.backend import device_memory_bytes, on_gpu
from .utils.maths import box_rbounds


@dataclass(frozen=True)
class UltrasoundSystem:
    tx: Transducer = None
    rx: Transducer = None
    seq: Sequence = None
    scan: Scan = None
    fs: float = None  # simulation sampling frequency [Hz]

    def __post_init__(self):
        # defaults mirror the reference constructor
        # (``UltrasoundSystem.m:143-190``)
        if self.rx is None and self.tx is None:
            object.__setattr__(self, "rx", TransducerArray.P4_2v())
        if self.tx is None:
            object.__setattr__(self, "tx", self.rx)
        if self.rx is None:
            object.__setattr__(self, "rx", self.tx)
        if self.fs is None:
            object.__setattr__(self, "fs", float(2 * max(
                2 * self.tx.fc, self.tx.bw[1], 2 * self.rx.fc, self.rx.bw[1])))
        if self.seq is None:
            object.__setattr__(self, "seq", Sequence(
                type="FSA", numpulse=self.tx.numel))
        if self.scan is None:
            lam4 = self.lmbda / 4
            if isinstance(self.rx, TransducerConvex):
                c = self.rx.center
                scan = ScanPolar(origin=c,
                                 r=np.arange(0, 40e-3 + np.linalg.norm(c), lam4),
                                 a=np.arange(-45.0, 45.5, 1.0))
            else:
                scan = ScanCartesian().with_resolution(dx=lam4, dz=lam4)
            object.__setattr__(self, "scan", scan)

    # ------------------------------------------------------------ properties
    @property
    def xdc(self) -> Transducer:
        assert self.tx is self.rx or self.tx == self.rx, "tx and rx differ"
        return self.rx

    @property
    def fc(self) -> float:
        return self.rx.fc

    @property
    def lmbda(self) -> float:
        """Wavelength at the center frequency (``us.lambda``)."""
        return self.seq.c0 / self.fc if self.seq is not None else 1540.0 / self.fc

    def replace(self, **changes) -> "UltrasoundSystem":
        return dataclasses.replace(self, **changes)

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "UltrasoundSystem":
        """Consistent unit rescale of all linked objects
        (``UltrasoundSystem.m:411-461``) — e.g. ``scale(dist=1e3, time=1e6)``
        for mm/us units."""
        same = self.tx is self.rx
        tx = self.tx.scale(dist=dist, time=time)
        return dataclasses.replace(
            self, tx=tx, rx=tx if same else self.rx.scale(dist=dist, time=time),
            seq=self.seq.scale(dist=dist, time=time),
            scan=self.scan.scale(dist=dist), fs=self.fs / time)

    # ------------------------------------------------------- geometry helpers
    def _tx_geometry(self):
        """Per-sequence-type (pv, nv, tx_model) dispatch
        (``UltrasoundSystem.DAS``, ``UltrasoundSystem.m:3340-3352``)."""
        st = self.seq.type
        if st == "FSA":
            pv = self.tx.positions().T  # (M, 3)
            _, _, nf, _, _ = self.tx.orientations()
            return pv, nf.T, "diverging"
        if st == "PW":
            f = self.seq.focus_array  # unit directions
            M = f.shape[1]
            return np.zeros((M, 3)), f.T, "plane"
        # FC / DV / VS: virtual sources at the foci
        f = self.seq.focus_array
        nf = f - self.tx.origin[:, None]
        nf = nf / np.linalg.norm(nf, axis=0, keepdims=True)
        model = "diverging" if st == "DV" else "virtual"
        return f.T, nf.T, model

    def _pixels(self) -> np.ndarray:
        return self.scan.positions().reshape(3, -1).T.astype(np.float32)  # (I, 3)

    # ------------------------------------------------------------- simulators
    def greens(self, scat: Scatterers, element_subdivisions: Tuple[int, int] = (1, 1),
               R0: Optional[float] = None, method: str = "auto",
               impl: str = "auto", fsk: Optional[float] = None,
               block: int = 32, rtol: float = 1e-6,
               precision: str = "highest", mesh=None) -> ChannelData:
        """Simulate echoes from point scatterers via a shifted Green's
        function, then apply the transmit Sequence via :meth:`focusTx`
        (``UltrasoundSystem.greens``, ``UltrasoundSystem.m:463-882``).

        ``impl``: 'auto' uses the frequency-domain GEMM path on a GPU
        ('freq': per-bin (S,N)^T x (S,M) GEMMs with exact fractional
        delays — see :mod:`qups_jax.ops.greens_freq`; ``rtol`` trims the
        synthesis band to kernel-spectrum bins above ``rtol * max``) and
        'splat' elsewhere: the XLA scatter-add path (tent/cubic deposit +
        convolve, the analog of the reference's ``greens.cu``); 'dense' is
        the O(T S N M) oracle.

        ``mesh``: optional :class:`jax.sharding.Mesh` with 'rx'/'tx'
        axes — the simulation shards scatterers over 'tx' (worker axis)
        and receive elements over 'rx'
        (:func:`qups_jax.parallel.greens_freq_sharded` /
        :func:`~qups_jax.parallel.greens_sharded`; the reference's
        parfor-over-scatterer-blocks, ``UltrasoundSystem.m:566-882``).
        Real-kernel sims only on the freq path's ri branch.

        ``precision`` (freq path): 'highest' (default: full f32 GEMMs,
        where the GPU's default precision would be TF32) | 'default' |
        'bf16' — bf16 runs the per-bin GEMMs with bf16 phasor inputs and
        f32 accumulation at ~0.2% rel error, for large diffuse-speckle
        clouds.

        Example:
            import numpy as np
            import qups_jax as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.greens(scat)
            # echo arrives at the round-trip time 2 * 20mm / c0 ~ 26 us
            t_pk = np.asarray(chd.time)[
                int(np.abs(np.asarray(chd.data))[:, 0, 0].argmax())]
            assert abs(t_pk - 2 * 20e-3 / 1540.0) < 1e-6
        """
        fs = float(self.fs)
        fsk = float(fsk or fs)
        c0 = float(scat.c0)
        R0 = float(self.lmbda if R0 is None else R0)
        if method == "auto":
            # deposit/sampling basis stays cubic (the reference default);
            # the transmit synthesis rides the freq GEMM on a GPU (focusTx)
            fmethod = "freq" if on_gpu() else "cubic"
            method = "cubic"
        elif method == "freq":
            fmethod, method = "freq", "cubic"  # freq applies to focusTx
        else:
            fmethod = method

        # sub-element positions (N, E, 3)
        if element_subdivisions == (1, 1):
            pn = self.rx.positions().T[:, None, :]
            pv = self.tx.positions().T[:, None, :]
        else:
            pn = np.moveaxis(self.rx.bary_centers(element_subdivisions), 0, -1)
            pv = np.moveaxis(self.tx.bary_centers(element_subdivisions), 0, -1)

        # convolved kernel waveform: rx impulse (x) tx impulse (x) seq pulse
        # (``UltrasoundSystem.m:584-588``)
        wv = self.rx.impulse.conv(self.tx.impulse.conv(self.seq.pulse, fsk), fsk)
        wv = dataclasses.replace(wv, fs=fsk)
        kern = np.asarray(wv.samples)

        # time bounds from conservative box-to-box geometry (the reference
        # uses transducer-bound corners, ``UltrasoundSystem.m:566-615``) —
        # O(S + N) host work; the exact O(S*N) distance matrix costs
        # seconds of host time per call at S ~ 1e5
        ps = scat.pos  # (3, S)
        rx_lo, rx_hi = box_rbounds(ps.T, pn)
        tx_lo, tx_hi = box_rbounds(ps.T, pv)
        tmin = (rx_lo + tx_lo) / c0 + wv.t0 - wv.duration
        tmax = (rx_hi + tx_hi) / c0 + wv.tend
        n0 = math.floor(tmin * fs)
        ne = math.ceil(tmax * fs)
        T = ne - n0 + 1
        s0 = n0 / fs

        if impl == "auto":
            impl = "freq" if on_gpu() else "splat"
        if impl not in ("freq", "splat", "dense"):
            raise ValueError(f"unknown impl {impl!r}")
        if mesh is not None and impl not in ("freq", "splat"):
            raise ValueError(
                f"greens(mesh=...) shards impl='freq'|'splat' only; "
                f"impl={impl!r} would silently run single-device")

        if impl != "freq" and float(scat.alpha0):
            import warnings
            warnings.warn(
                "greens: Scatterers.alpha0 attenuation requires the"
                f" frequency-domain engine (impl='freq'); impl={impl!r}"
                " ignores it", stacklevel=2)
        if impl == "freq":
            from .ops.greens_freq import greens_freq
            kw = dict(T=T, s0=s0, t0k=float(wv.t0), fs=fs, cinv=1.0 / c0,
                      R0=R0, fsr=fsk / fs, rtol=rtol, precision=precision,
                      alpha0=float(scat.alpha0))
            amp = np.asarray(scat.amp)
            if mesh is not None:
                from .parallel import greens_freq_sharded
                x = greens_freq_sharded(mesh, kern, ps.T, amp, pn, pv, **kw)
            else:
                x = greens_freq(kern, ps.T, amp, pn, pv, **kw)
            chd = ChannelData(data=x, fs=fs, t0=s0)
            return self.focusTx(chd, self.seq, method=fmethod)

        fn = greens_splat if impl == "splat" else greens_dense
        kwargs = dict(T=T, s0=s0, t0k=float(wv.t0), fs=fs, cinv=1.0 / c0,
                      R0=R0, fsr=fsk / fs, method=method)
        if impl == "splat":
            kwargs["block"] = block
        if mesh is not None and impl == "splat":
            from .parallel import greens_sharded
            x = greens_sharded(mesh, kern, ps.T, np.asarray(scat.amp),
                               pn, pv, **kwargs)
        else:
            x = fn(jnp.asarray(kern), jnp.asarray(ps.T, jnp.float32),
                   jnp.asarray(scat.amp), jnp.asarray(pn, jnp.float32),
                   jnp.asarray(pv, jnp.float32), **kwargs)

        chd = ChannelData(data=x, fs=fs, t0=s0)
        return self.focusTx(chd, self.seq, method=fmethod)

    def simus(self, scat: Scatterers, baffle: str = "soft",
              fthresh_db: float = -60.0,
              element_subdivisions: Tuple[int, int] = (1, 1)) -> ChannelData:
        """Frequency-domain point-scatterer simulation with far-field
        element directivity — the native analog of the MUST/SIMUS interop
        (``UltrasoundSystem.simus``, ``UltrasoundSystem.m:1464-1667``):
        FSA synthesis via per-frequency (N, S) x (S, E) complex GEMMs (see
        :mod:`qups_jax.ops.simus`), then :meth:`focusTx`. Unlike the
        reference's tone-burst-only external toolbox, any pulse works (it
        enters through its spectrum). ``Scatterers.alpha0`` [dB/cm/MHz]
        applies frequency-linear absorption over both propagation legs
        (the MUST model).

        Example:
            import numpy as np
            import qups_jax as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.simus(scat)
            assert chd.data.shape[1:3] == (4, 4) and np.isfinite(
                np.abs(np.asarray(chd.data))).all()
        """
        from .ops.simus import simus_fsa

        fs = float(self.fs)
        c0 = float(scat.c0)
        wv = self.rx.impulse.conv(self.tx.impulse.conv(self.seq.pulse, fs), fs)
        wv = dataclasses.replace(wv, fs=fs)
        kern = np.asarray(wv.samples)
        if np.iscomplexobj(kern):
            kern = np.real(kern)

        pn = self.rx.positions().T
        pv = self.tx.positions().T
        ps = scat.pos

        # conservative box-to-box distance bounds: O(S + N) host work vs
        # the exact O(S*N) matrix (seconds of host time at S ~ 1e5)
        rx_lo, rx_hi = box_rbounds(ps.T, pn)
        tx_lo, tx_hi = box_rbounds(ps.T, pv)
        tmin = (rx_lo + tx_lo) / c0 + wv.t0 - wv.duration
        tmax = (rx_hi + tx_hi) / c0 + wv.tend
        n0 = math.floor(tmin * fs)
        T = int(math.ceil(tmax * fs)) - n0 + 1
        s0 = n0 / fs

        # select bins where the pulse spectrum is above threshold
        KERN = np.fft.rfft(kern, n=T)
        lev = 20 * np.log10(np.abs(KERN) + 1e-30)
        sel = np.where(lev >= lev.max() + fthresh_db)[0]
        sel = sel[sel > 0]
        f = sel * fs / T
        spec = KERN[sel] * np.exp(-2j * np.pi * f * (wv.t0 - s0))

        az_rx, _, _, _, _ = self.rx.orientations()
        az_tx, _, _, _, _ = self.tx.orientations()
        x = simus_fsa(ps.T, np.asarray(scat.amp, np.float32), pn,
                      np.radians(np.broadcast_to(az_rx, (self.rx.numel,))),
                      pv,
                      np.radians(np.broadcast_to(az_tx, (self.tx.numel,))),
                      jnp.asarray([self.tx.width, self.rx.width],
                                  jnp.float32),
                      spec.astype(np.complex64), sel.astype(np.int32),
                      T=T, fs=fs, c0=c0, baffle=baffle,
                      alpha0=float(scat.alpha0))
        chd = ChannelData(data=x, fs=fs, t0=s0)
        return self.focusTx(chd, self.seq)

    def calc_scat_all(self, scat: Scatterers,
                      element_subdivisions: Tuple[int, int] = (1, 1),
                      **kw) -> ChannelData:
        """FieldII ``calc_scat_all``-equivalent: one linear-scattering
        simulation of ALL tx-element x rx-element pairs (FSA), then
        :meth:`focusTx` applies the Sequence
        (``UltrasoundSystem.calc_scat_all``,
        ``UltrasoundSystem.m:1668-1804``). By linear superposition this is
        exactly :meth:`greens`; the method exists so the FieldII interop
        API surface carries over verbatim. Extra kwargs pass to
        :meth:`greens` (``impl``, ``method``, ``precision``, ...)."""
        return self.greens(scat, element_subdivisions, **kw)

    def calc_scat_multi(self, scat: Scatterers,
                        element_subdivisions: Tuple[int, int] = (1, 1),
                        bsize: Optional[int] = None, method: str = "auto",
                        **kw) -> ChannelData:
        """FieldII ``calc_scat_multi``-equivalent: the per-transmit
        simulation with the Sequence's physical delays/apodization at the
        transmit aperture (``UltrasoundSystem.calc_scat_multi``,
        ``UltrasoundSystem.m:1805-2082``). In a linear medium the
        per-transmit response equals the FSA response synthesized per
        transmit, so the native path runs ONE FSA sim and folds the
        Sequence per transmit block: ``bsize`` transmits at a time — the
        memory knob matching the reference's parfor/job-over-transmits —
        or all at once in a single fused jit when ``None``.

        All blocks share one focus plan (common t0 shift and zero-pad), so
        blocked and unblocked results are identical.

        Example:
            import numpy as np
            import qups_jax as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            seq = q.SequenceRadial(type="PW", angles=[-5.0, 5.0], c0=1540.0)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=seq,
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            a = us.calc_scat_multi(scat)            # fused per-tx synthesis
            b = us.calc_scat_multi(scat, bsize=1)   # blocked == fused
            assert np.allclose(np.asarray(a.data), np.asarray(b.data),
                               atol=1e-5)
        """
        kw["method"] = method
        if method == "auto":
            method = "freq" if on_gpu() else "cubic"
        if self.seq.type == "FSA":
            return self.greens(scat, element_subdivisions, **kw)
        fsa = Sequence(type="FSA", c0=self.seq.c0, pulse=self.seq.pulse,
                       numpulse=self.tx.numel)
        chd = self.replace(seq=fsa).greens(scat, element_subdivisions, **kw)
        plan = self._focus_plan(chd.fs, chd.data.ndim, self.seq)
        if plan is None:  # identity sequence
            return chd
        t2, w, dt0, pad = plan
        Mp = t2.shape[-1]
        b = int(bsize) if bsize else Mp
        if b >= Mp:
            return self.focusTx(chd, self.seq, method=method)
        chd = chd.replace(t0=jnp.asarray(chd.t0) + dt0)
        chd = chd.zeropad(0, pad)
        outs = []
        M = t2.shape[2]
        for i in range(0, Mp, b):
            if method == "freq":
                from .ops.fdbf import focus_tx_freq
                t2b = t2[..., i:i + b].reshape(M, -1)
                wb = w[..., i:i + b].reshape(M, -1)
                outs.append(focus_tx_freq(chd.data, t2b, wb,
                                          fs=float(chd.fs)))
                continue
            z = chd.sample2sep(chd.time, t2[..., i:i + b], method=method,
                               w=w[..., i:i + b], sdim=2)
            outs.append(jnp.moveaxis(z[:, :, 0], -1, 2))
        return chd.replace(data=jnp.concatenate(outs, axis=2))

    # ---------------------------------------------------- transmit synthesis
    def _focus_plan(self, fs: float, ndim: int, seq: Sequence,
                    buffer: int = 0):
        """Host-side planning for :meth:`focusTx`: ``None`` for the true-
        FSA identity, else ``(t2, w, dt0, pad)`` — the shaped delay /
        apodization tensors for ``sample2sep``, the t0 shift, and the
        zero-padding (``UltrasoundSystem.m:3457-3465``)."""
        tau = -seq.delays(self.tx)          # (M, M')
        apd = seq.apodization(self.tx)      # (M, M')
        if seq.type == "FSA" and not np.count_nonzero(tau) \
                and np.array_equal(apd, np.eye(self.tx.numel)):
            return None  # true FSA: identity

        # resample only within the window where data exists
        mask = apd.astype(bool) | np.zeros_like(tau, bool)
        nmin = math.floor(np.min(tau[mask]) * fs)
        nmax = math.ceil(np.max(tau[mask]) * fs)
        tau = tau - nmin / fs
        # the synthesized-transmit axis M' goes on a FREE trailing dim
        # past the data's ndim (the reference swaps to dim D,
        # ``focusTx :3465``) so frame dims F... broadcast through
        # untouched, then it is moved back to the transmit axis
        nd = max(ndim, 3)
        M, Mp = tau.shape
        t2 = -tau.reshape((1, 1, M) + (1,) * (nd - 3) + (Mp,))
        w = apd.reshape((1, 1, M) + (1,) * (nd - 3) + (Mp,))
        return t2, w, nmin / fs, (nmax - nmin) + buffer

    def focusTx(self, chd: ChannelData, seq: Optional[Sequence] = None,
                method: str = "auto", buffer: int = 0) -> ChannelData:
        """Synthesize transmits from FSA data: delay-and-sum *across
        transmits* (``UltrasoundSystem.focusTx``,
        ``UltrasoundSystem.m:3374-3503``).

        ``method``: 'nearest'|'linear'|'cubic'|'lanczos3' time-domain
        resampling (``sample2sep``/wsinterpd2 semantics), or 'freq' — the
        per-frequency-bin transmit GEMM ``Y_k = X_k H_k`` (exact
        band-limited interpolation). 'auto' picks 'freq' on a GPU,
        'cubic' (the reference default) elsewhere.

        Example:
            import numpy as np
            import qups_jax as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=[0.0], z=[20e-3]), fs=12e6)
            rng = np.random.default_rng(0)
            chd = q.ChannelData(
                data=rng.standard_normal((64, 4, 4)).astype(np.float32),
                fs=12e6, t0=0.0)
            pw = q.SequenceRadial(type="PW", angles=[0.0], c0=1540.0)
            out = us.focusTx(chd, pw)   # 4 FSA transmits -> 1 plane wave
            assert out.data.shape[2] == 1
        """
        seq = seq or self.seq
        if method == "auto":
            # the per-bin transmit GEMM is exact (band-limited)
            method = "freq" if on_gpu() else "cubic"
        plan = self._focus_plan(chd.fs, chd.data.ndim, seq, buffer)
        if plan is None:
            return chd
        t2, w, dt0, pad = plan
        chd = chd.replace(t0=jnp.asarray(chd.t0) + dt0)
        chd = chd.zeropad(0, pad)
        if method == "freq":
            from .ops.fdbf import focus_tx_freq
            M, Mp = t2.shape[2], t2.shape[-1]
            z = focus_tx_freq(chd.data, t2.reshape(M, Mp),
                              w.reshape(M, Mp), fs=float(chd.fs))
            return chd.replace(data=z)
        z = chd.sample2sep(chd.time, t2, method=method, w=w, sdim=2)
        z = jnp.moveaxis(z[:, :, 0], -1, 2)  # (T', N, M', F...)
        return chd.replace(data=z)

    # ------------------------------------------------------------ beamformers
    def DAS(self, chd: ChannelData, apod=(), fmod: float = 0.0,
            c0: Optional[Union[float, np.ndarray]] = None,
            keep_tx: bool = False, keep_rx: bool = False,
            method: str = "auto", kernel: str = "auto",
            bsize: Optional[int] = None):
        """Compute-optimized delay-and-sum beamformer
        (``UltrasoundSystem.DAS``, ``UltrasoundSystem.m:3172-3372``).

        Returns the image shaped ``(*scan.shape, N', M', *F)`` where the rx/tx
        dims are kept (N/M) or summed (1) per the flags.

        ``method``: 'nearest' | 'linear' | 'cubic' | 'lanczos3' | 'auto'.
        'auto' (default) resolves to 'cubic' — the reference default
        (``UltrasoundSystem.m:3279``).

        ``kernel``: 'auto' runs the fused DAS kernel
        (:mod:`qups_jax.ops.das_fused`) on a GPU for the inputs it covers
        — :class:`~qups_jax.ops.apod.Fused` (or no) apodization, any of the
        four samplers, a scalar or per-pixel sound speed, any keep mode —
        and the XLA scan over transmits (:func:`qups_jax.ops.das.das`)
        otherwise; 'xla' forces the XLA scan (the reference's
        CUDA-vs-native dispatch, ``kern/das_spec.m:184-195``).

        ``bsize``: if set, stream the traces through the device ``bsize``
        transmits at a time, keeping the full data host-resident and
        accumulating (or concatenating, under ``keep_tx``) partial images —
        the out-of-core analog of the reference's tall-array / ``bsize``
        splicing (``UltrasoundSystem.m:3488``, ``ChannelData.tall``,
        ``src/ChannelData.m:457``): device memory stays O(T*N*bsize + I)
        regardless of the total transmit count.

        Example:
            import numpy as np
            import qups_jax as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.greens(scat)
            b = us.DAS(chd)                       # summed (I1, I2, I3, 1, 1)
            brx = us.DAS(chd, keep_rx=True)       # coherence imaging input
            assert b.shape[:3] == us.scan.shape
            assert brx.shape[3] == 4
            # the point target dominates near its true location
            img = np.abs(np.asarray(b)).squeeze()
            P = us.scan.positions().reshape(3, -1)
            k = int(img.reshape(-1).argmax())
            assert np.linalg.norm(P[:, k] - [0, 0, 20e-3]) < 1.1e-3
        """
        pv, nv, model = self._tx_geometry()
        c0v = self.seq.c0 if c0 is None else c0
        cinv = np.reciprocal(np.asarray(c0v, np.float32))
        if cinv.ndim > 1:  # per-pixel map on the scan grid
            cinv = cinv.reshape(-1)
        t0 = chd.t0_host
        apod_t = tuple(apod if isinstance(apod, (tuple, list)) else (apod,))
        if method == "auto":
            # the reference default sampler (``UltrasoundSystem.m:3279``)
            method = "cubic"
        if bsize is not None and chd.M > bsize:
            # out-of-core transmit streaming: slice everything per-tx on
            # host, recurse per block with bsize disabled
            xh = np.asarray(chd.data)
            t0b = np.broadcast_to(np.asarray(t0).reshape(-1), (chd.M,))
            if not self._use_kernel(kernel, chd.data.shape, apod_t, method,
                                    cinv, keep_rx, keep_tx):
                # the XLA path consumes dense broadcastable apodizations:
                # materialize Fused at full M once, slice per block below
                apod_t = tuple(a.materialize(self) if isinstance(a, Fused)
                               else a for a in apod_t)
            acc = None
            parts = []
            for m0 in range(0, chd.M, bsize):
                m1 = min(m0 + bsize, chd.M)
                sub = ChannelData(data=xh[:, :, m0:m1], fs=chd.fs,
                                  t0=t0b[m0:m1].reshape(1, 1, m1 - m0))
                apod_b = tuple(_slice_tx_apod(a, m0, m1, chd.M)
                               for a in apod_t)
                img = self._das_block(
                    sub, pv[m0:m1], nv[m0:m1], model, cinv, apod_b,
                    fmod=fmod, keep_tx=keep_tx, keep_rx=keep_rx,
                    method=method, kernel=kernel)
                if keep_tx:
                    parts.append(np.asarray(img))
                else:
                    img = np.asarray(img)
                    acc = img if acc is None else acc + img
            return np.concatenate(parts, axis=len(self.scan.shape) + 1) \
                if keep_tx else acc
        return self._das_block(chd, pv, nv, model, cinv, apod_t, fmod=fmod,
                               keep_tx=keep_tx, keep_rx=keep_rx,
                               method=method, kernel=kernel)

    def coherence_image(self, chd: ChannelData, post: str = "cohfac",
                        lags=None, apod=(), fmod: float = 0.0,
                        c0: Optional[float] = None, method: str = "auto",
                        mesh=None):
        """Aperture-coherence imaging: the keep_rx DAS and the rx-aperture
        reduction (``post='cohfac'`` coherence factor or ``'slsc'``
        short-lag spatial coherence, ``lags`` as in
        :func:`qups_jax.ops.coherence.slsc`). The reference computes these
        as separate kernel calls over the full kept volume
        (``kern/slsc.m:142-180``, ``cohfac``).

        ``mesh``: optional :class:`jax.sharding.Mesh` with 'rx'/'tx' axes.
        The kept rx band stays on its device and is reduced there; the
        devices exchange only image-sized ``psum``s
        (:func:`qups_jax.parallel.das_sharded` with ``post``).

        Returns the real coherence image shaped ``scan.shape``.

        Example:
            import numpy as np
            import qups_jax as q
            xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=8),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.greens(scat)
            cf = np.asarray(us.coherence_image(chd))
            assert cf.shape == us.scan.shape
            assert np.isfinite(cf).all() and cf.max() <= 1.0 + 1e-6
        """
        from .ops.coherence import cohfac as _cohfac, slsc as _slsc
        if post not in ("cohfac", "slsc"):
            raise ValueError(f"unknown post {post!r}")
        if method == "auto":
            method = "cubic"
        if mesh is not None:
            from .parallel import das_sharded
            pv, nv, model = self._tx_geometry()
            cinv = np.float32(1.0 / float(self.seq.c0 if c0 is None
                                          else c0))
            apod_t = tuple(apod if isinstance(apod, (tuple, list))
                           else (apod,))
            img = das_sharded(
                mesh, chd.data, self._pixels(), self.rx.positions().T,
                pv, nv, chd.t0_host, cinv, fs=float(chd.fs),
                tx_model=model, im_shape=tuple(self.scan.shape),
                method=method, apod=apod_t,
                orientations=self._orientations(), fmod=float(fmod),
                post=post, lags=lags)
            return jnp.asarray(img).reshape(self.scan.shape)
        brx = jnp.asarray(self.DAS(chd, apod=apod, fmod=fmod, c0=c0,
                                   keep_rx=True, method=method))
        ndim_scan = len(self.scan.shape)
        brx = brx.reshape(self.scan.shape + (chd.N, -1)).sum(-1)
        if post == "cohfac":
            return jnp.abs(_cohfac(brx, axis=ndim_scan))
        return _slsc(brx, axis=ndim_scan, lags=lags)

    def _use_kernel(self, kernel, x_shape, apod_t, method, cinv, keep_rx,
                    keep_tx) -> bool:
        """``kernel='auto'``: the shared dispatch
        (:func:`qups_jax.ops.das_fused.use_kernel`); ``'xla'``: the XLA
        scan, the reference path."""
        if kernel not in ("auto", "xla"):
            raise ValueError(f"kernel must be 'auto' or 'xla', not {kernel!r}")
        from .ops.das_fused import use_kernel
        return kernel == "auto" and use_kernel(
            x_shape, apod_t, method, cinv, keep_rx, keep_tx,
            I=self.scan.npix)

    def _orientations(self) -> np.ndarray:
        """(2, N) [sin, cos] of the receive elements' azimuth."""
        th, _, _, _, _ = self.rx.orientations()
        az = np.radians(np.broadcast_to(np.asarray(th, np.float64),
                                        (self.rx.numel,)))
        return np.stack([np.sin(az), np.cos(az)]).astype(np.float32)

    def _das_block(self, chd: ChannelData, pv, nv, model, cinv, apod_t,
                   *, fmod, keep_tx, keep_rx, method, kernel):
        """One DAS dispatch over a (possibly tx-sliced) trace block."""
        if method == "cubic2x":
            # cubic-class accuracy from linear taps: one exact
            # band-limited 2x trace upsample, then linear taps on the
            # oversampled RF (the reference's resample-then-interp option,
            # interpd.cu:89-113)
            from .ops.interp import fft_upsample
            chd = chd.replace(data=fft_upsample(chd.data, 2, axis=0),
                              fs=chd.fs * 2.0)
            method = "linear"
        t0 = chd.t0_host
        if self._use_kernel(kernel, chd.data.shape, apod_t, method, cinv,
                            keep_rx, keep_tx):
            from .ops.das_fused import das_kernel
            lat = None
            if isinstance(self.scan, ScanPolar) and any(
                    a.kind.startswith("tx_") for a in apod_t):
                P = np.broadcast_to(
                    _place(self.scan.a, self.scan.order.index("A"), 3),
                    self.scan.shape)
                lat = P.reshape(-1).astype(np.float32)
            img = das_kernel(chd.data, self._pixels(),
                             self.rx.positions().T, pv, nv, t0, cinv,
                             fs=float(chd.fs), tx_model=model, method=method,
                             fmod=float(fmod), apod=apod_t, keep_rx=keep_rx,
                             keep_tx=keep_tx, lat=lat,
                             orientations=self._orientations())
        else:
            apod_m = tuple(a.materialize(self) if isinstance(a, Fused) else a
                           for a in apod_t)
            img = das(chd.data, self._pixels(), self.rx.positions().T, pv,
                      nv, t0, cinv, fs=float(chd.fs), apod=apod_m,
                      fmod=float(fmod), tx_model=model, keep_rx=keep_rx,
                      keep_tx=keep_tx, method=method,
                      im_shape=tuple(self.scan.shape))
        return img.reshape(self.scan.shape + img.shape[1:])

    def das_delay_tables(self, c0: Optional[float] = None):
        """Separable geometric delay LUTs for the current system:
        ``(tau_rx (I, N), tau_tx (I, M))`` including the sequence's t=0
        convention (used by :meth:`bfDAS`;
        ``UltrasoundSystem.bfDAS``, ``UltrasoundSystem.m:4430-4463``)."""
        pv, nv, model = self._tx_geometry()
        c0v = float(c0 if c0 is not None else self.seq.c0)
        tau_rx, tau_tx = delay_tables(self._pixels(), self.rx.positions().T,
                                      pv, nv, c0v, tx_model=model)
        return tau_rx, tau_tx

    def bfDAS(self, chd: ChannelData, apod=(), fmod: float = 0.0,
              c0: Optional[float] = None, keep_tx: bool = False,
              keep_rx: bool = False, method: str = "auto"):
        """Generic delay-and-sum via delay tables
        (``UltrasoundSystem.bfDAS``, ``UltrasoundSystem.m:4334-4474``).

        Example:
            import numpy as np
            import qups_jax as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.greens(scat)
            b1 = np.asarray(us.bfDAS(chd)).squeeze()
            b2 = np.asarray(us.DAS(chd)).squeeze()  # same geometry, fused
            c = np.abs(np.vdot(b1, b2)) / (
                np.linalg.norm(b1) * np.linalg.norm(b2))
            assert c > 0.99
        """
        tau_rx, tau_tx = self.das_delay_tables(c0=c0)
        return self.bfDASLUT(chd, tau_rx, tau_tx, apod=apod, fmod=fmod,
                             keep_tx=keep_tx, keep_rx=keep_rx, method=method)

    def bfDASLUT(self, chd: ChannelData, tau_rx, tau_tx, apod=(),
                 fmod: float = 0.0, keep_tx: bool = False,
                 keep_rx: bool = False, method: str = "auto",
                 kernel: str = "auto"):
        """Beamform from arbitrary rx/tx delay tables — the "bring your own
        delays" API (``UltrasoundSystem.bfDASLUT``,
        ``UltrasoundSystem.m:4476-4673``).

        Without apodization the tables ride the fused DAS kernel on a GPU
        (:func:`qups_jax.ops.das_fused.das_lut_kernel`); everything else
        uses the XLA ``das_lut`` path. ``kernel``: 'auto' | 'xla' (see
        :meth:`DAS`). ``method='auto'`` resolves to 'cubic', the reference
        default.

        Example:
            import numpy as np
            import qups_jax as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.greens(scat)
            # bring-your-own-delays: here the geometric tables, but any
            # (I, N)/(I, M) tables work (eikonal, calibration, ...)
            tau_rx, tau_tx = us.das_delay_tables()
            b = us.bfDASLUT(chd, tau_rx, tau_tx)
            assert b.shape[:3] == us.scan.shape
        """
        if method == "cubic2x":
            from .ops.interp import fft_upsample
            chd = chd.replace(data=fft_upsample(chd.data, 2, axis=0),
                              fs=chd.fs * 2.0)
            method = "linear"
        if method == "auto":
            method = "cubic"
        t0 = chd.t0_host
        apod_t = tuple(apod if isinstance(apod, (tuple, list)) else (apod,))
        if not apod_t and self._use_kernel(kernel, chd.data.shape, (),
                                           method, None, keep_rx, keep_tx):
            from .ops.das_fused import das_lut_kernel
            img = das_lut_kernel(chd.data, tau_rx, tau_tx, t0,
                                 fs=float(chd.fs), fmod=float(fmod),
                                 keep_rx=keep_rx, keep_tx=keep_tx,
                                 method=method)
        else:
            img = das_lut(chd.data, tau_rx, tau_tx, t0, fs=float(chd.fs),
                          apod=apod_t, fmod=float(fmod), keep_rx=keep_rx,
                          keep_tx=keep_tx, method=method,
                          im_shape=tuple(self.scan.shape))
        return img.reshape(self.scan.shape + img.shape[1:])


# ----------------------------------------------------------------------------
# Apodization generators — geometry masks/weights broadcastable to
# (I1, I2, I3, N, M) (``UltrasoundSystem.m:4892-5428``). All are host-side
# numpy; the DAS kernels apply them per-transmit with broadcasting.
# ----------------------------------------------------------------------------
def _slice_tx_apod(a, m0, m1, M):
    """Slice the transmit axis of one apodization for a ``bsize`` block:
    dense broadcastable arrays are cut on axis 4 when it spans all M
    transmits; Fused descriptors carrying a per-transmit ``lat_tx`` array
    get a re-built descriptor with the slice (other Fused are pure geometry
    and pass through)."""
    if isinstance(a, Fused):
        p = a.p
        lt = p.get("lat_tx")
        if lt is not None and np.ndim(lt) and np.shape(lt)[0] == M:
            p = dict(p)
            p["lat_tx"] = np.asarray(lt)[m0:m1]
            return Fused(a.kind, **p)
        return a
    arr = np.asarray(a)
    if arr.ndim >= 5 and arr.shape[4] == M:
        return arr[:, :, :, :, m0:m1]
    return arr


def _place(vec, dim, ndim=5):
    """Place a 1-D vector along dimension ``dim`` of an ndim-D array."""
    v = np.asarray(vec)
    shape = [1] * ndim
    shape[dim] = v.size
    return v.reshape(shape)


def _lat_axis(scan):
    """(values, data-dim) of the lateral axis: x for cartesian, a for polar
    (``scanlat`` behavior in the reference)."""
    if isinstance(scan, ScanCartesian):
        return scan.x, scan.order.index("X")
    if isinstance(scan, ScanPolar):
        return scan.a, scan.order.index("A")
    raise TypeError(f"unsupported scan type {type(scan).__name__}")


def _lat_tx(us):
    """Per-transmit lateral coordinate: focus x (cartesian) or angle."""
    if isinstance(us.scan, ScanPolar):
        th = np.degrees(np.arctan2(us.seq.focus_array[0] - us.scan.origin[0],
                                   us.seq.focus_array[2] - us.scan.origin[2]))
        return th
    return us.seq.focus_array[0]


def _ap_scanline(us, tol: Optional[float] = None) -> np.ndarray:
    """Scanline matching for focused line-by-line imaging
    (``UltrasoundSystem.apScanline``, ``UltrasoundSystem.m:4892``):
    mask pixels whose lateral coordinate matches each transmit's scanline.
    Returns an (I1,I2,I3,1,M)-broadcastable mask."""
    xi, xdim = _lat_axis(us.scan)
    xv = _lat_tx(us)
    if tol is None:
        d = np.diff(xi)
        tol = float(d[0]) if d.size else np.inf
    m = (np.abs(_place(xi, xdim) - _place(xv, 4)) < tol).astype(np.float32)
    return m


def _ap_multiline(us) -> np.ndarray:
    """Linear interpolation between the two nearest transmit scanlines
    (``UltrasoundSystem.apMultiline``, ``UltrasoundSystem.m:4970``)."""
    xi, xdim = _lat_axis(us.scan)
    xv = _lat_tx(us)
    M = xv.size
    X = xi.size
    apod = np.zeros((X, M), np.float32)
    order = np.argsort(xv)
    xs = xv[order]
    for ix, x in enumerate(xi):
        li = np.searchsorted(xs, x, side="right") - 1  # last xs <= x
        ri = np.searchsorted(xs, x, side="left")       # first xs >= x
        if li < 0 or ri >= M:
            continue  # outside the transmit span
        d = xs[ri] - xs[li]
        if d == 0:
            apod[ix, order[li]] += 1.0
        else:
            apod[ix, order[li]] += 1.0 - abs(xs[li] - x) / d
            apod[ix, order[ri]] += 1.0 - abs(xs[ri] - x) / d
    shape = [1] * 5
    shape[xdim] = X
    shape[4] = M
    return apod.reshape(shape)


def _ap_translating_aperture(us, tol=None) -> np.ndarray:
    """Receive aperture translating with the transmit scanline
    (``UltrasoundSystem.apTranslatingAperture``, ``UltrasoundSystem.m:5074``):
    accept pixels within ``tol[0]`` of the transmit lateral position and
    receivers within ``tol[1]`` of the pixel lateral position."""
    xi, xdim = _lat_axis(us.scan)
    xv = _lat_tx(us)
    if isinstance(us.scan, ScanPolar):
        th, _, _, _, _ = us.rx.orientations()
        xn = np.asarray(th)
    else:
        xn = us.rx.positions()[0]
    if tol is None:
        d = np.diff(xi)
        tol = (float(d[0]) if d.size else np.inf,) * 2
    tol = np.broadcast_to(np.atleast_1d(tol), (2,))
    m = (np.abs(_place(xi, xdim) - _place(xv, 4)) <= tol[0]) \
        & (np.abs(_place(xi, xdim) - _place(xn, 3)) <= tol[1])
    return m.astype(np.float32)


def _ap_aperture_growth(us, f: float = 1.5, Dmax: float = np.inf) -> np.ndarray:
    """F-number-limited aperture growth
    (``UltrasoundSystem.apApertureGrowth``, ``UltrasoundSystem.m:5165``):
    accept receiver n for pixel i when ``z > f * |2 d|`` with ``d`` the
    (element-frame) lateral offset, and ``|2 d| < Dmax``."""
    pn = us.rx.positions()  # (3, N)
    P = us.scan.positions()  # (3, I1, I2, I3)
    Xi = P[0][..., None]  # (I1, I2, I3, 1)
    Zi = P[2][..., None]
    Xn = pn[0].reshape(1, 1, 1, -1)
    Zn = pn[2].reshape(1, 1, 1, -1)
    th, _, _, _, _ = us.rx.orientations()
    if np.any(np.abs(th) > 1e-12):  # non-planar array (convex)
        ae = np.radians(th).reshape(1, 1, 1, -1)
        rp = np.hypot(Xi - Xn, Zi - Zn)
        ap = np.arctan2(Xi - Xn, Zi - Zn)
        d = rp * np.sin(ap - ae)
        z = np.abs(rp * np.cos(ap - ae))
    else:
        d = Xn - Xi
        z = Zi
    m = (z > f * np.abs(2 * d)) & (np.abs(2 * d) < Dmax)
    return m.astype(np.float32)[..., None]  # (I1, I2, I3, N, 1)


def _ap_tx_parallelogram(us, theta=None, phi=(0.0, 0.0)) -> np.ndarray:
    """Plane-wave parallelogram projection
    (``UltrasoundSystem.apTxParallelogram``, ``UltrasoundSystem.m:5269``):
    accept pixels whose projection along the steering direction (within the
    angular spread ``phi``) lands inside the transducer bounds."""
    fx = us.seq.focus_array
    if theta is None:
        theta = np.degrees(np.arctan2(fx[0], fx[2]))
    theta = np.atleast_1d(theta)
    M = theta.size
    P = us.scan.positions()  # (3, I1, I2, I3)
    pb = us.xdc.bounds()
    masks = []
    for k in range(len(phi)):
        ang = np.radians(theta + phi[k])  # (M,)
        nvx = np.sin(ang).reshape(1, 1, 1, M)
        nvz = np.cos(ang).reshape(1, 1, 1, M)
        # project pixel to z == 0 along the steering vector
        x0 = P[0][..., None] - nvx * (P[2][..., None] / nvz)
        masks.append((pb[0, 0] < x0) & (x0 <= pb[0, 1]))
    ok = masks[0]
    for mk in masks[1:]:
        ok = ok | mk
    return ok.astype(np.float32)[:, :, :, None, :]  # (I1,I2,I3,1,M)


def _rx_pixel_cos(us):
    """Normalized inner product <element normal, unit(pixel - element)>."""
    pn = us.rx.positions()  # (3, N)
    _, _, nn, _, _ = us.rx.orientations()  # (3, N)
    P = us.scan.positions()  # (3, I1, I2, I3)
    r = P[:, :, :, :, None] - pn[:, None, None, None, :]  # (3, I1,I2,I3,N)
    r = r / np.maximum(np.linalg.norm(r, axis=0, keepdims=True), 1e-30)
    return np.einsum("cn,cijkn->ijkn", nn, r)


def _ap_acceptance_angle(us, theta: float = 45.0) -> np.ndarray:
    """Element acceptance angle: ``<n, r_hat> >= cos(theta)``
    (``UltrasoundSystem.apAcceptanceAngle``, ``UltrasoundSystem.m:5303``)."""
    c = _rx_pixel_cos(us)
    return (c >= np.cos(np.radians(theta))).astype(np.float32)[..., None]


def _ap_cosine_angle(us, theta: float = 45.0) -> np.ndarray:
    """Cosine taper over the rx-to-pixel angle
    (``UltrasoundSystem.apCosineAngle``, ``UltrasoundSystem.m:5377``):
    ``cos(min(90, 90/theta * angle))``."""
    c = np.clip(_rx_pixel_cos(us), -1.0, 1.0)
    ang = np.degrees(np.arccos(c))
    w = np.cos(np.radians(np.minimum(90.0, (90.0 / theta) * ang)))
    return w.astype(np.float32)[..., None]


UltrasoundSystem.ap_scanline = _ap_scanline
UltrasoundSystem.ap_multiline = _ap_multiline
UltrasoundSystem.ap_translating_aperture = _ap_translating_aperture
UltrasoundSystem.ap_aperture_growth = _ap_aperture_growth
UltrasoundSystem.ap_tx_parallelogram = _ap_tx_parallelogram
UltrasoundSystem.ap_acceptance_angle = _ap_acceptance_angle
UltrasoundSystem.ap_cosine_angle = _ap_cosine_angle


# ----------------------------------------------------------------------------
# Frequency-domain beamformers and transmit decoding
# ----------------------------------------------------------------------------
def _bf_adjoint(us, chd, apod=(), fmod: float = 0.0, c0: Optional[float] = None,
                fthresh_db: float = -40.0, max_bins: Optional[int] = None,
                keep_rx: bool = False, keep_tx: bool = False, bins=None):
    """Frequency-domain adjoint beamformer (``UltrasoundSystem.bfAdjoint``,
    ``src/UltrasoundSystem.m:3770-4050``): per-frequency steering-vector
    matrix products (batched complex GEMMs). Returns the image shaped
    ``(*scan.shape, N', M')``.

    Frequency-bin selection is shape-affecting and therefore host-side
    (one small (T,) spectrum download per call); pass ``bins`` (int32
    indices) to skip it and keep repeated calls jit-clean.

    Example:
        import numpy as np
        import qups_jax as q
        xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
        us = q.UltrasoundSystem(
            tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
            scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                 z=np.linspace(18e-3, 22e-3, 8)),
            fs=12e6)
        scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
        chd = us.greens(scat)
        b = us.bfAdjoint(chd)
        img = np.abs(np.asarray(b)).squeeze()
        assert img.shape == (8, 8)
        assert np.isfinite(img).all() and img.max() > 0
    """
    from .ops.fdbf import bf_adjoint, geom_delays

    c0v = float(c0 if c0 is not None else self_c0(us))
    # delay tables built ON DEVICE: only the (I, 3) pixel array is
    # uploaded; host-f64 (I, E) tables cost GBs of upload per call.
    # They are data-independent, so repeated frames reuse them from a
    # byte-bounded cache (~0.4 s of the 1.16 s headline call)
    import hashlib
    pi32 = np.ascontiguousarray(us._pixels(), np.float32)
    prx = np.ascontiguousarray(us.rx.positions().T, np.float32)
    ptx = np.ascontiguousarray(us.tx.positions().T, np.float32)
    tkey = (hashlib.sha1(pi32.tobytes() + prx.tobytes()
                         + ptx.tobytes()).hexdigest(), c0v)
    cached = _ADJ_TAU_CACHE.get(tkey)
    if cached is None:
        tau_rx = geom_delays(pi32, prx, np.float32(1.0 / c0v))
        tau_tx = geom_delays(pi32, ptx, np.float32(1.0 / c0v))
        nb = 4 * int(tau_rx.size + tau_tx.size)
        limit = _cache_limit(1 / 4)
        if nb <= limit:
            while _ADJ_TAU_CACHE and (sum(
                    4 * int(a.size + b.size)
                    for a, b in _ADJ_TAU_CACHE.values()) + nb
                    > limit):
                _ADJ_TAU_CACHE.pop(next(iter(_ADJ_TAU_CACHE)))
            _ADJ_TAU_CACHE[tkey] = (tau_rx, tau_tx)
    else:
        tau_rx, tau_tx = cached
    del_tx = us.seq.delays(us.tx)          # (M, V)
    apod_tx = us.seq.apodization(us.tx)    # (M, V)
    t0_off = np.broadcast_to(us.seq.t0_offset(), (us.seq.num_pulse,))
    del_tx = del_tx + t0_off[None, :]

    # frequency selection: spectral level per bin computed on device (real)
    T = chd.T
    if bins is not None:
        sel = np.asarray(bins, np.int32).reshape(-1)
    else:
        from .ops.fdbf import spectral_level
        lev = np.asarray(spectral_level(chd.data))
        lev = lev - lev.max()
        f = np.fft.fftfreq(T) * chd.fs
        sel = np.where((lev >= fthresh_db) & (f >= 0) & (f < chd.fs / 2))[0]
        if max_bins is not None and sel.size > max_bins:
            keep = np.argsort(lev[sel])[::-1][:max_bins]
            sel = np.sort(sel[keep])

    def engine(x3):
        return bf_adjoint(
            x3, tau_rx, tau_tx, del_tx, apod_tx, chd.t0_host, t0_off,
            sel.astype(np.int32), fs=float(chd.fs), fmod=float(fmod),
            keep_rx=keep_rx, keep_tx=keep_tx)

    data = chd.data
    if data.ndim > 3:
        # trailing frame dims (F...) fold to one axis; each frame reuses
        # the compiled engine (kern/das_spec.m:180-181's F threading)
        fdims = data.shape[3:]
        dataF = data.reshape(data.shape[:3] + (-1,))
        b = jnp.stack([engine(dataF[..., f])
                       for f in range(dataF.shape[-1])], axis=-1)
        b = b.reshape(b.shape[:-1] + fdims)
        ftail = fdims
    else:
        b = engine(data)
        ftail = ()
    if keep_rx:
        return b.reshape(us.scan.shape + (chd.N, 1) + ftail)
    if keep_tx:
        return b.reshape(us.scan.shape + (1, chd.M) + ftail)
    return b.reshape(us.scan.shape + (1, 1) + ftail)


def self_c0(us) -> float:
    return float(us.seq.c0)


def _refocus(us, chd, seq: Optional[Sequence] = None, gamma: Optional[float] = None,
             method: str = "tikhonov"):
    """Decode synthesized transmits back to FSA (REFoCUS)
    (``UltrasoundSystem.refocus``, ``src/UltrasoundSystem.m:3505-3768``).

    Example:
        import numpy as np
        import qups_jax as q
        xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
        us = q.UltrasoundSystem(
            tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
            scan=q.ScanCartesian(x=[0.0], z=[20e-3]), fs=12e6)
        scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
        fsa = us.greens(scat)
        # encode with plane waves, decode back to FSA
        pw = q.SequenceRadial(type="PW", angles=np.linspace(-10, 10, 4),
                              c0=1540.0)
        enc = us.focusTx(fsa, pw)
        dec = us.replace(seq=pw).refocus(enc)
        a = np.abs(np.asarray(fsa.data)).max()
        assert dec.data.shape[2] == 4
        assert np.isfinite(np.abs(np.asarray(dec.data))).all()
    """
    from .ops.fdbf import refocus_apply, refocus_op

    seq = seq or us.seq
    tau = np.asarray(seq.delays(us.tx), np.float32)       # (M, V)
    apd = np.asarray(seq.apodization(us.tx), np.float32)  # (M, V)
    t0 = chd.t0_host
    t0v = np.broadcast_to(t0, (chd.M,)) if t0.size == 1 else t0
    # the decode operator is data-independent (~5 s of the 5.8 s headline
    # decode is the batched norm+solve) — cache it per sequence so
    # repeated frames pay only the FFT + transmit GEMM
    import hashlib
    key = (hashlib.sha1(tau.tobytes() + apd.tobytes()).hexdigest(),
           int(chd.T), float(chd.fs),
           None if gamma is None else float(gamma), method)
    Hi = _REFOCUS_OP_CACHE.get(key)
    if Hi is None:
        Hi = refocus_op(tau, apd, T=int(chd.T), fs=float(chd.fs),
                        gamma=gamma, method=method)
        # FIFO-evict by BYTES — a headline-scale operator is ~2.1 GB of
        # HBM, so a count bound could pin most of the chip's memory
        nb = int(np.prod(Hi.shape)) * Hi.dtype.itemsize
        while _REFOCUS_OP_CACHE and (sum(
                int(np.prod(v.shape)) * v.dtype.itemsize
                for v in _REFOCUS_OP_CACHE.values()) + nb
                > _cache_limit(3 / 16)):
            _REFOCUS_OP_CACHE.pop(next(iter(_REFOCUS_OP_CACHE)))
        _REFOCUS_OP_CACHE[key] = Hi
    y, _ = refocus_apply(chd.data, Hi, t0v, fs=float(chd.fs))
    return chd.replace(data=y, t0=float(t0v.min()))


_REFOCUS_OP_CACHE: dict = {}
# bfAdjoint (I, N)/(I, M) delay tables — ~2 GB at the headline config
_ADJ_TAU_CACHE: dict = {}


def _cache_limit(share: float) -> int:
    """Byte bound of a device-resident cache: a share of the device's
    memory limit."""
    return int(share * device_memory_bytes())


def _bf_migration(us, chd, c0: Optional[float] = None, fmod: float = 0.0,
                  keep_tx: bool = False, method: str = "cubic",
                  jacobian: bool = True, resample: bool = True,
                  nfft: Optional[Tuple[int, int]] = None, out: str = "auto"):
    """Stolt f-k plane-wave migration (``UltrasoundSystem.bfMigration``,
    ``src/UltrasoundSystem.m:4675-4887``). Requires a PW sequence on a
    TransducerArray. Returns ``(b, bscan)`` where ``bscan`` is the image's
    native cartesian scan; with ``resample=True``, ``b`` is bilinearly
    resampled onto ``us.scan`` (shape ``(*scan.shape, 1, M')``)."""
    from .ops.fdbf import stolt_migration

    assert us.seq.type == "PW", "bfMigration requires a plane-wave sequence"
    assert isinstance(us.xdc, TransducerArray), \
        "bfMigration requires a TransducerArray"
    c0v = float(c0 if c0 is not None else us.seq.c0)
    t0 = chd.t0_host
    if t0.size > 1 and not np.allclose(t0, t0[0]):
        chd = chd.rectifyt0()
        t0 = chd.t0_host
    # Realize the start-time offset as leading zeros: a large t0 as a pure
    # phase ramp oscillates faster than the DFT bin spacing and is destroyed
    # by the Stolt frequency-axis resampling.
    pre = int(round(float(t0[0]) * chd.fs))
    if pre > 0:
        chd = chd.zeropad(pre, 0)
        t0 = chd.t0_host
    f = us.seq.focus_array
    angles = np.degrees(np.arctan2(f[0], f[2]))
    del_tx = us.seq.delays(us.xdc)  # (N, M)
    if nfft is None:
        from .utils import next_pow2
        nfft = (next_pow2(2 * chd.T), next_pow2(2 * chd.N))
    use_ri = out == "ri"
    b = stolt_migration(chd.data, t0, del_tx, tuple(angles),
                        fs=float(chd.fs), c0=c0v, pitch=float(us.xdc.pitch),
                        fmod=float(fmod), keep_tx=keep_tx, method=method,
                        jacobian=jacobian, nfft=tuple(nfft),
                        out="ri" if use_ri else "complex")
    # native image grid: z from the two-way time axis, x at the elements
    pn = us.xdc.positions()
    zax = us.xdc.offset[2] + c0v / 2 * (float(t0[0]) + np.arange(chd.T) / chd.fs)
    bscan = ScanCartesian(x=pn[0], y=[us.xdc.offset[1]], z=zax)

    def host_cplx(bri):
        h = np.asarray(bri)
        return h[..., 0] + 1j * h[..., 1]

    if not resample:
        return (host_cplx(b) if use_ri else b), bscan
    # bilinear resample onto us.scan
    P = us.scan.positions()  # (3, I1, I2, I3)
    zi = (P[2] - zax[0]) / (zax[1] - zax[0])
    xi = (P[0] - pn[0, 0]) / us.xdc.pitch
    zi = jnp.asarray(zi.reshape(-1), jnp.float32)
    xi = jnp.asarray(xi.reshape(-1), jnp.float32)

    @jax.jit
    def _resamp(b):
        if use_ri:  # (T, N, M', 2) -> complex inside the jit
            b = b[..., 0] + 1j * b[..., 1]
        Tn, Nn = b.shape[:2]
        z0 = jnp.clip(jnp.floor(zi).astype(jnp.int32), 0, Tn - 1)
        x0 = jnp.clip(jnp.floor(xi).astype(jnp.int32), 0, Nn - 1)
        z1 = jnp.clip(z0 + 1, 0, Tn - 1)
        x1 = jnp.clip(x0 + 1, 0, Nn - 1)
        wz = jnp.clip(zi - z0, 0, 1)[:, None]
        wx = jnp.clip(xi - x0, 0, 1)[:, None]
        v = ((1 - wz) * (1 - wx) * b[z0, x0] + (1 - wz) * wx * b[z0, x1]
             + wz * (1 - wx) * b[z1, x0] + wz * wx * b[z1, x1])
        oob = ((zi < 0) | (zi > Tn - 1) | (xi < 0) | (xi > Nn - 1))[:, None]
        v = jnp.where(oob, 0.0, v)
        if use_ri:
            return jnp.stack([jnp.real(v), jnp.imag(v)], axis=-1)
        return v

    v = _resamp(b)  # (I, M') or (I, M', 2)
    if use_ri:
        v = host_cplx(v)
        return v.reshape(us.scan.shape + (1,) + v.shape[1:]), bscan
    return v.reshape(us.scan.shape + (1,) + v.shape[1:]), bscan


UltrasoundSystem.bfAdjoint = _bf_adjoint
UltrasoundSystem.refocus = _refocus
UltrasoundSystem.bfMigration = _bf_migration


# ----------------------------------------------------------------------------
# Eikonal beamformer (heterogeneous sound speed)
# ----------------------------------------------------------------------------
def _grid_interp2(vals, zi, xi, method: str = "cubic"):
    """Gridded interpolation of ``vals (Nz, Nx)`` at fractional indices —
    cubic by default, matching the reference's
    ``griddedInterpolant(grd, tau, 'cubic')`` (``UltrasoundSystem.m:4318``)."""
    from .utils.maths import gridded_interp
    return gridded_interp(vals, [zi, xi], method=method)


def _cmap_zx(cgrd: ScanCartesian, cmap: np.ndarray) -> np.ndarray:
    """Reorder a property map on ``cgrd`` to (Z, X) layout."""
    ydim = cgrd.order.index("Y")
    m2 = np.squeeze(cmap, axis=ydim)
    # remaining dims in order of the scan's data dims
    rem = [c for c in cgrd.order if c != "Y"]
    return m2 if rem == ["Z", "X"] else m2.T


def _grid_interp3(vals, zi, xi, yi, method: str = "cubic"):
    """Gridded interpolation of ``vals (Nz, Nx, Ny)`` at fractional
    indices — cubic by default (see :func:`_grid_interp2`)."""
    from .utils.maths import gridded_interp
    return gridded_interp(vals, [zi, xi, yi], method=method)


def _eikonal_tables(us, medium, cgrd: ScanCartesian, workers=None):
    """One-way travel-time LUTs through a heterogeneous medium
    (``UltrasoundSystem.bfEikonal``, ``src/UltrasoundSystem.m:4052-4332``):
    fast-marching maps per element on the (isotropic, 2-D or 3-D) medium
    grid, sampled at the scan pixels. Returns ``(tau_rx (I, N),
    tau_tx (I, M))``.

    For non-FSA sequences the per-transmit table is synthesized from the
    per-element maps by the Fermat (first-arrival wavefront) construction
    ``tau_tx(pix, m) = min_n act (del(n, m) + tau_n(pix))`` — in a
    homogeneous medium this reduces EXACTLY to the virtual-source
    two-sided delay ``copysign(|pix - pf|, .)/c0`` (and the plane-wave
    projection for PW), so it agrees with :meth:`bfDAS` there while
    honoring refraction in heterogeneous media. (The reference's eikonal
    tables are per-element only, ``:4295-4321``.)"""
    from .ops.eikonal import msfm_multi

    assert isinstance(cgrd, ScanCartesian), "cgrd must be a ScanCartesian"
    vol = cgrd.ny > 1
    h = float(cgrd.dz)
    assert np.isclose(cgrd.dx, cgrd.dz, rtol=1e-3), \
        "eikonal requires isotropic grid spacing (UltrasoundSystem.m:4269)"
    if vol:
        assert np.isclose(cgrd.dy, cgrd.dz, rtol=1e-3), \
            "eikonal requires isotropic grid spacing"
        perm = [cgrd.order.index(c) for c in "ZXY"]
        cgrid = np.transpose(medium.props(cgrd, "c"), perm)  # (Nz, Nx, Ny)
    else:
        cgrid = _cmap_zx(cgrd, medium.props(cgrd, "c"))  # (Nz, Nx)

    def cells(p):  # element positions (3, E) -> nearest grid cells
        iz = np.clip(np.round((p[2] - cgrd.z[0]) / h).astype(int), 0, cgrd.nz - 1)
        ix = np.clip(np.round((p[0] - cgrd.x[0]) / h).astype(int), 0, cgrd.nx - 1)
        if vol:
            iy = np.clip(np.round((p[1] - cgrd.y[0]) / h).astype(int), 0,
                         cgrd.ny - 1)
            return np.stack([iz, ix, iy], -1)
        return np.stack([iz, ix], -1)

    same = us.tx is us.rx
    prx = us.rx.positions()
    maps_rx = msfm_multi(cgrid, h, cells(prx), workers=workers)

    # sample the maps at the scan pixels
    P = us.scan.positions().reshape(3, -1)
    zi = (P[2] - cgrd.z[0]) / h
    xi = (P[0] - cgrd.x[0]) / h
    if vol:
        yi = (P[1] - cgrd.y[0]) / h
        interp = lambda m: _grid_interp3(m, zi, xi, yi)  # noqa: E731
    else:
        interp = lambda m: _grid_interp2(m, zi, xi)  # noqa: E731
    tau_rx = np.stack([interp(m) for m in maps_rx], -1)  # (I, N)

    def tx_element_tables():  # (I, E) — only the FSA/PW paths need these
        if same:
            maps_tx = maps_rx
        else:
            maps_tx = msfm_multi(cgrid, h, cells(us.tx.positions()),
                                 workers=workers)
        return np.stack([interp(m) for m in maps_tx], -1)

    if us.seq.type == "FSA":
        tau_tx = tx_element_tables()
    elif us.seq.type in ("FC", "DV", "VS"):
        # virtual-source WAVEFRONT maps: one eikonal solve per transmit
        # with the focus as the source (sign-flipped before it, the
        # two-sided convention of the straight-ray tables); a focus
        # outside the grid (diverging apex) seeds the grid boundary with
        # ambient-straight-ray times instead
        from .ops.eikonal import msfm
        pf = us.seq.focus_array  # (3, M)
        nvs = pf - us.tx.origin[:, None]
        nvs = nvs / np.maximum(np.linalg.norm(nvs, axis=0, keepdims=True),
                               1e-30)
        c0a = float(getattr(medium, "c0", us.seq.c0))
        M = pf.shape[1]
        cols = []
        bounds = [(cgrd.z[0], cgrd.z[-1]), (cgrd.x[0], cgrd.x[-1])] \
            + ([(cgrd.y[0], cgrd.y[-1])] if vol else [])
        for m in range(M):
            p = pf[:, m]
            coord = (p[2], p[0], p[1]) if vol else (p[2], p[0])
            inside = all(lo + h <= v <= hi - h
                         for v, (lo, hi) in zip(coord, bounds))
            if inside:
                srcs = cells(p.reshape(3, 1))
                t0s = np.zeros(1)
            else:
                # seed every boundary cell at its straight-ray time from
                # the (outside-grid) virtual apex through the ambient c0
                idx = np.stack(np.meshgrid(
                    *[np.arange(s) for s in cgrid.shape],
                    indexing="ij"), -1).reshape(-1, cgrid.ndim)
                on_edge = np.zeros(len(idx), bool)
                for d, s in enumerate(cgrid.shape):
                    on_edge |= (idx[:, d] == 0) | (idx[:, d] == s - 1)
                srcs = idx[on_edge]
                org = np.array([cgrd.z[0], cgrd.x[0]]
                               + ([cgrd.y[0]] if vol else []))
                pos = org[None, :] + srcs * h
                apx = np.array([p[2], p[0]] + ([p[1]] if vol else []))
                t0s = np.linalg.norm(pos - apx[None], axis=1) / c0a
            tmap = msfm(cgrid, h, srcs, src_t0=t0s)
            tm = interp(tmap)
            if us.seq.type != "DV":
                # two-sided: pixels behind the focal wavefront are negative
                sgn = np.sign(((P - p[:, None]) * nvs[:, m:m + 1]).sum(0))
                tm = tm * np.where(sgn == 0, 1.0, sgn)
            cols.append(tm)
        tau_tx = np.stack(cols, axis=-1)
    else:
        # PW (and custom) — Fermat first-arrival over the active aperture:
        # element n FIRES at ``-seq.delays(n, m)`` (qups delays are the
        # receive-alignment convention; cf. focusTx's ``tau = -delays``).
        # For plane waves the first arrival IS the plane wavefront, so this
        # matches the straight-ray projection inside the insonified region.
        tau_el = tx_element_tables()
        dels = us.seq.delays(us.tx)          # (E, M)
        apd = us.seq.apodization(us.tx)      # (E, M)
        M = us.seq.num_pulse
        tau_tx = np.empty((tau_el.shape[0], M), tau_el.dtype)
        for m in range(M):
            act = np.abs(apd[:, m]) > 0
            if not act.any():
                act = np.ones(dels.shape[0], bool)
            tau_tx[:, m] = (tau_el[:, act] - dels[act, m][None, :]).min(1)
    return tau_rx.astype(np.float32), tau_tx.astype(np.float32)


def _bf_eikonal(us, chd, medium, cgrd: Optional[ScanCartesian] = None,
                apod=(), fmod: float = 0.0, keep_tx: bool = False,
                keep_rx: bool = False, method: str = "auto", workers=None):
    """Delay-and-sum with eikonal travel times through a heterogeneous
    Medium (``UltrasoundSystem.bfEikonal``,
    ``src/UltrasoundSystem.m:4052-4332``) on 2-D or 3-D grids; any sequence
    type (see :func:`_eikonal_tables` for the non-FSA wavefront
    construction). The travel-time maps replace the straight-ray delay
    tables of :meth:`bfDAS`.

    Example:
        import numpy as np
        import qups_jax as q
        xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
        us = q.UltrasoundSystem(
            tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
            scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                 z=np.linspace(18e-3, 22e-3, 8)),
            fs=12e6)
        scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
        chd = us.greens(scat)
        med = q.Medium(c0=1540.0)  # homogeneous: agrees with bfDAS
        cgrd = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 33),
                               z=np.linspace(0.0, 26e-3, 105))
        b = us.bfEikonal(chd, med, cgrd)
        assert b.shape[:3] == us.scan.shape
        assert np.isfinite(np.abs(np.asarray(b))).all()
    """
    if cgrd is None:
        # default sim grid: the scan extended to include the transducer
        b = us.xdc.bounds()
        lam = us.lmbda
        h = lam / 4
        x0 = min(b[0, 0], us.scan.positions()[0].min()) - 2 * h
        x1 = max(b[0, 1], us.scan.positions()[0].max()) + 2 * h
        z0 = min(b[2, 0], us.scan.positions()[2].min()) - 2 * h
        z1 = max(b[2, 1], us.scan.positions()[2].max()) + 2 * h
        cgrd = ScanCartesian(x=np.arange(x0, x1 + h, h), y=[0.0],
                             z=np.arange(z0, z1 + h, h))
    tau_rx, tau_tx = _eikonal_tables(us, medium, cgrd, workers=workers)
    return us.bfDASLUT(chd, tau_rx, tau_tx, apod=apod, fmod=fmod,
                       keep_tx=keep_tx, keep_rx=keep_rx, method=method)


UltrasoundSystem.eikonal_tables = _eikonal_tables
UltrasoundSystem.bfEikonal = _bf_eikonal


# ----------------------------------------------------------------------------
# Full-wave (k-space pseudospectral) simulation
# ----------------------------------------------------------------------------
def _kspace_first_order(us, medium, cgrd: Optional[ScanCartesian] = None,
                        cfl: float = 0.3, npml: int = 10,
                        tmax: Optional[float] = None,
                        el_proj: str = "nearest", el_sub: int = 0,
                        record: str = "elements", field_stride: int = 8,
                        bg_subtract: bool = False, mesh=None):
    """Full-wave simulation through a heterogeneous Medium via the native
    k-space PSTD stepper (``UltrasoundSystem.kspaceFirstOrder``,
    ``src/UltrasoundSystem.m:2458-3170``): builds the grid + PML, a
    CFL-limited dt aligned to ``us.fs`` (``:2714-2729``), projects elements
    to grid nodes for sources and sensors, runs one sim per transmit, and
    returns the received traces as ChannelData (T, N, M).

    Medium absorption (``alpha0``/``alpha_power``) and nonlinearity
    (``bona0``) are honored when set (``Medium.m:397`` passes the same maps
    to k-Wave). ``el_proj``: 'nearest' snaps each element to its closest
    node; 'linear' distributes ``el_sub`` sub-element points (default
    ceil(width/h) + 1) bilinearly over the surrounding nodes; 'karray' is
    the kWaveArray-class exact off-grid projection — patch sub-points
    deposited (and sensed) through truncated band-limited sinc stencils —
    covering the reference's four projection methods
    (``UltrasoundSystem.m:2649``, ``Transducer.elem2grid``,
    ``src/Transducer.m:578``, ``kWaveArray`` ``src/Transducer.m:734``).
    'karray-direct'/'karray-depend' are accepted as aliases of 'karray':
    the reference pair differs only in when the projection weights meet
    the transmit signals — one (J', M) GEMM up front vs per-transmit
    application to bound memory (``UltrasoundSystem.m:2810-2837``; same
    weights, same results). This implementation computes the weights once
    AND applies them inside the per-transmit simulation loop, so it is
    simultaneously the direct math and the depend memory profile — the
    distinction has nothing left to select.

    ``record='field'`` additionally snapshots the FULL pressure field every
    ``field_stride`` sim steps (the reference's ``'field'`` sensor mode,
    ``UltrasoundSystem.m:2542``) and returns ``(chd, fields)`` with fields
    (M, nsnap, *grid-shape) cropped of the PML. ``bg_subtract=True`` runs a
    second simulation per transmit through the iso-impedance ambient medium
    (``c0``/``rho0`` everywhere) and subtracts it, isolating the scattered
    field — the reference's background-subtraction option
    (``UltrasoundSystem.m:2555``).

    ``mesh``: optional :class:`jax.sharding.Mesh` with a 'tx' axis — the
    per-transmit simulations shard over it
    (:func:`qups_jax.parallel.fdtd_sharded`; the reference's parfor over
    transmits, ``UltrasoundSystem.m:2648``). ``record='elements'`` only;
    'field' mode falls back to the sequential loop."""
    from .sim.fdtd import kspace_sim_2d

    if el_proj in ("karray-direct", "karray-depend"):
        el_proj = "karray"  # aliases — see docstring
    if cgrd is None:
        b = us.xdc.bounds()
        lam = us.lmbda
        h = lam / 4
        P = us.scan.positions()
        x0 = min(b[0, 0], P[0].min()) - 2 * h
        x1 = max(b[0, 1], P[0].max()) + 2 * h
        z0 = min(b[2, 0], P[2].min()) - 2 * h
        z1 = max(b[2, 1], P[2].max()) + 2 * h
        cgrd = ScanCartesian(x=np.arange(x0, x1 + h, h), y=[0.0],
                             z=np.arange(z0, z1 + h, h))
    assert isinstance(cgrd, ScanCartesian)
    assert np.isclose(cgrd.dx, cgrd.dz, rtol=1e-3), "grid must be isotropic"
    h = float(cgrd.dz)
    vol = cgrd.ny > 1
    if vol:
        assert np.isclose(cgrd.dy, cgrd.dz, rtol=1e-3), "grid must be isotropic"

    # property maps (Z, X[, Y]) + PML padding (edge replicate)
    if vol:
        def to_grid(m):
            order = cgrd.order
            perm = [order.index(c) for c in "ZXY"]
            return np.transpose(m, perm)
    else:
        to_grid = lambda m: _cmap_zx(cgrd, m)  # noqa: E731
    props = medium.props(cgrd, ("c", "rho", "alpha", "bona"))
    cmap = np.pad(to_grid(props["c"]), npml, mode="edge")
    rmap = np.pad(to_grid(props["rho"]), npml, mode="edge")
    amap = np.pad(to_grid(props["alpha"]), npml, mode="edge")
    bmap = np.pad(to_grid(props["bona"]), npml, mode="edge")
    # NaN ambient values mean the physics is off (Medium defaults)
    amap = None if np.isnan(amap).all() else np.nan_to_num(amap)
    bmap = None if np.isnan(bmap).all() else np.nan_to_num(bmap)
    phys = dict(alpha0=amap, alpha_power=float(medium.alpha_power),
                bona=bmap)
    cmax = float(cmap.max())
    if record not in ("elements", "field"):
        raise ValueError(f"unknown record mode {record!r}")
    want_field = record == "field"
    fstride = int(field_stride) if want_field else 0
    if bg_subtract:
        cmap_bg = np.full_like(cmap, float(medium.c0))
        rmap_bg = np.full_like(rmap, float(medium.rho0))

    # CFL-limited dt aligned to us.fs (integer divisor)
    fs = float(us.fs)
    dt_cfl = cfl * h / cmax
    k = max(1, int(np.ceil(1.0 / (fs * dt_cfl))))
    dt = 1.0 / (fs * k)

    # element -> grid projection: per element a list of (nodes, weights)
    nd = 3 if vol else 2
    org = np.array([cgrd.z[0], cgrd.x[0]] + ([cgrd.y[0]] if vol else []))
    shp = cmap.shape

    def _cells_of(pts):
        """(nd, K) positions -> (K, nd) fractional node coords (PML incl.)"""
        q = np.stack([pts[2], pts[0]] + ([pts[1]] if vol else []))
        return (q - org[:, None]).T / h + npml

    def proj(xdc, p_el):
        """Per-element node/weight lists (``Transducer.elem2grid`` analog,
        ``src/Transducer.m:578``). ``el_proj='karray'`` is the
        kWaveArray-class exact off-grid projection
        (``src/Transducer.m:734``, ``UltrasoundSystem.m:2649``): the
        element surface is subdivided into patch sub-points (oversampled
        vs the grid step) and each sub-point deposits through a truncated
        band-limited interpolant (separable sinc stencil) — off-grid and
        tilted/curved apertures (convex/matrix probes) radiate without the
        half-cell snapping bias of 'nearest'/'linear'."""
        out = []
        E = p_el.shape[1]
        for n in range(E):
            if el_proj == "nearest":
                pts = p_el[:, n:n + 1]
            elif el_proj in ("linear", "karray"):
                K = el_sub or (int(np.ceil(xdc.width / h))
                               + (2 if el_proj == "karray" else 1))
                sub = xdc.bary_centers((K, 1))  # (3, E, K)
                pts = sub[:, n, :]
            else:
                raise ValueError(
                    f"unknown el_proj {el_proj!r} (one of 'nearest', "
                    "'linear', 'karray')")
            fc = _cells_of(pts)  # (K, nd) fractional
            K = fc.shape[0]
            if el_proj == "nearest":
                idx = np.clip(np.round(fc).astype(int), 0,
                              np.array(shp) - 1)
                out.append((idx, np.ones(1)))
                continue
            if el_proj == "karray":
                # truncated band-limited interpolant: separable sinc
                # stencil of half-width HW around each sub-point (the
                # kWaveArray BLI on a PSTD grid is exactly the periodic
                # sinc; HW=3 captures > 97% of its mass)
                HW = 3
                f0 = np.round(fc).astype(int)
                nodes_l, w_l = [], []
                for corner in np.ndindex(*([2 * HW + 1] * nd)):
                    cs = np.asarray(corner) - HW
                    nn = np.clip(f0 + cs, 0, np.array(shp) - 1)
                    w = np.prod(np.sinc(fc - (f0 + cs)), axis=1) / K
                    nodes_l.append(nn)
                    w_l.append(w)
                out.append((np.concatenate(nodes_l, 0),
                            np.concatenate(w_l, 0)))
                continue
            # multilinear deposit over the 2^nd surrounding nodes
            f0 = np.floor(fc).astype(int)
            fr = fc - f0
            nodes_l, w_l = [], []
            for corner in np.ndindex(*([2] * nd)):
                cs = np.asarray(corner)
                nn = np.clip(f0 + cs, 0, np.array(shp) - 1)
                w = np.prod(np.where(cs == 1, fr, 1 - fr), axis=1) / K
                nodes_l.append(nn)
                w_l.append(w)
            out.append((np.concatenate(nodes_l, 0),
                        np.concatenate(w_l, 0)))
        return out

    tx_proj = proj(us.tx, us.tx.positions())
    rx_proj = proj(us.rx, us.rx.positions())
    rec_rows = tuple(sorted({int(r) for nodes_, _ in rx_proj
                             for r in nodes_[:, 0]}))
    row_of = {r: i for i, r in enumerate(rec_rows)}

    # transmit waveform at sim rate
    wv = us.tx.impulse.conv(us.seq.pulse, 1.0 / dt)
    delays = us.seq.delays(us.tx)       # (N_el, M)
    apod = us.seq.apodization(us.tx)    # (N_el, M)
    M = us.seq.num_pulse

    # simulation length
    if tmax is None:
        diag = np.hypot(cgrd.x[-1] - cgrd.x[0], cgrd.z[-1] - cgrd.z[0])
        tmax = 2.2 * diag / float(cmap.min()) + wv.duration
    steps = int(np.ceil(tmax / dt))

    def sense(rec):
        """Combine recorded pressure into per-element traces."""
        cols = []
        for nodes_, w_ in rx_proj:
            rws = np.array([row_of[int(r)] for r in nodes_[:, 0]])
            if vol:
                v = rec[:, rws, nodes_[:, 1], nodes_[:, 2]]
            else:
                v = rec[:, rws, nodes_[:, 1]]
            cols.append(v @ w_)
        return np.stack(cols, axis=1)  # (steps, N)

    def tx_sources(v):
        """Per-transmit raw source node/signal assembly (pre-dedup)."""
        act = np.where(np.abs(apod[:, v]) > 0)[0]
        maxdel = float(delays[act, v].max()) if act.size else 0.0
        t0_sim = -maxdel + wv.t0
        s = np.arange(steps) * dt
        all_nodes = []
        all_sig = []
        for n in act:
            sn = apod[n, v] * np.real(np.asarray(
                wv.sample(s + t0_sim + delays[n, v])))  # (steps,)
            nodes_, w_ = tx_proj[n]
            all_nodes.append(nodes_)
            all_sig.append(sn[:, None] * w_[None, :])
        return (np.concatenate(all_nodes, 0),
                np.concatenate(all_sig, 1).astype(np.float32), t0_sim)

    chds = []
    fields = []
    if mesh is not None and not want_field:
        # transmit-sharded path: one UNION source-node set across all
        # transmits (inactive nodes carry zero signal, contributing
        # nothing) so the per-tx programs are shape-uniform for shard_map
        from .parallel import fdtd_sharded

        per = [tx_sources(v) for v in range(M)]
        uniq = np.unique(np.concatenate([p[0] for p in per], 0), axis=0)
        qof = {tuple(u): i for i, u in enumerate(uniq)}
        sig_tx = np.zeros((M, steps, uniq.shape[0]), np.float32)
        for v, (nodes_v, sig_v, _) in enumerate(per):
            cols = np.array([qof[tuple(r)] for r in nodes_v], int)
            np.add.at(sig_tx[v].T, cols, sig_v.T)
        kwm = dict(steps=steps, dt=dt, dx=h, c_ref=cmax,
                   record_rows=rec_rows, axis="tx",
                   alpha_power=float(medium.alpha_power))
        rec_all = np.asarray(fdtd_sharded(
            mesh, cmap, rmap, uniq.T, sig_tx, alpha0=phys["alpha0"],
            bona=phys["bona"], **kwm))
        if bg_subtract:
            a_bg = b_bg = None
            if phys["alpha0"] is not None:
                a_bg = np.full_like(
                    cmap, float(np.nan_to_num(medium.alpha0)))
            if phys["bona"] is not None:
                b_bg = np.full_like(
                    cmap, float(np.nan_to_num(medium.bona0)))
            rec_all = rec_all - np.asarray(fdtd_sharded(
                mesh, cmap_bg, rmap_bg, uniq.T, sig_tx, alpha0=a_bg,
                bona=b_bg, **kwm))
        for v in range(M):
            chds.append((sense(rec_all[v])[::k], per[v][2]))
        M_done = True
    else:
        M_done = False
    for v in range(M) if not M_done else ():
        nodes_cat, sig_cat, t0_sim = tx_sources(v)
        uniq, inv = np.unique(nodes_cat, axis=0, return_inverse=True)
        sig = np.zeros((steps, uniq.shape[0]), np.float32)
        np.add.at(sig.T, inv, sig_cat.T.astype(np.float32))
        def run_sim(cm, rm, ph):
            kw = dict(steps=steps, dt=dt, dx=h, c_ref=cmax,
                      record_rows=rec_rows, field_stride=fstride, **ph)
            if vol:
                from .sim.fdtd import kspace_sim_3d
                out = kspace_sim_3d(cm, rm, uniq.T,
                                    jnp.asarray(sig, jnp.float32), **kw)
            else:
                out = kspace_sim_2d(cm, rm, jnp.asarray(uniq[:, 0]),
                                    jnp.asarray(uniq[:, 1]),
                                    jnp.asarray(sig, jnp.float32), **kw)
            return out if want_field else (out, None)

        rec, fld = run_sim(cmap, rmap, phys)
        if bg_subtract:
            # iso-impedance ambient background: same sources/dt/steps, the
            # ambient c0/rho0 (+ ambient absorption) everywhere — the
            # difference is the scattered field
            phys_bg = dict(phys)
            if phys["alpha0"] is not None:
                phys_bg["alpha0"] = np.full_like(
                    cmap, float(np.nan_to_num(medium.alpha0)))
            if phys["bona"] is not None:
                phys_bg["bona"] = np.full_like(
                    cmap, float(np.nan_to_num(medium.bona0)))
            rec_bg, fld_bg = run_sim(cmap_bg, rmap_bg, phys_bg)
            rec = rec - rec_bg
            if want_field:
                fld = fld - fld_bg
        if want_field:
            # crop the PML frame before returning (grid coordinates)
            sl = (slice(None), slice(npml, -npml), slice(npml, -npml)) \
                + ((slice(npml, -npml),) if vol else ())
            fields.append(np.asarray(fld)[sl])
        tr = sense(np.asarray(rec))
        tr = tr[::k]  # downsample to us.fs
        chds.append((tr, t0_sim))
    T = min(c[0].shape[0] for c in chds)
    data = np.stack([c[0][:T] for c in chds], axis=2)  # (T, N, M)
    t0 = np.array([c[1] for c in chds])
    chd = ChannelData(data=jnp.asarray(data), fs=fs, t0=t0)
    if want_field:
        return chd, np.stack(fields)
    return chd


UltrasoundSystem.kspaceFirstOrder = _kspace_first_order


# ----------------------------------------------------------------------------
# Transmit pressure-field maps (calc_hp)
# ----------------------------------------------------------------------------
def _calc_hp(us, scan: Optional[Scan] = None, seq: Optional[Sequence] = None,
             out: str = "max", R0: Optional[float] = None):
    """Transmit pressure-field sensitivity maps — the native analog of the
    FieldII-backed ``UltrasoundSystem.calc_hp``
    (``src/UltrasoundSystem.m:2083-2456``): the one-way monochromatic-free
    (impulse-based) pressure at every scan pixel from each transmit,

        p(t, pix; m) = sum_e apd(e, m) wv(t - fire_e(m) - r_e(pix)/c) / r_e

    with ``wv = tx.impulse (x) seq.pulse`` and 1/r spreading clamped at
    ``R0`` — a one-way Green's superposition (splat + convolve, like
    :func:`qups_jax.ops.greens.greens_splat`).

    Returns ``out='max'``: the max-pressure map ``(I1, I2, I3, M)``;
    ``out='field'``: ``(p (T, I, M), t0)`` full time series.

    Example:
        import numpy as np
        import qups_jax as q
        xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
        pf = np.array([[0.0], [0.0], [20e-3]])
        us = q.UltrasoundSystem(
            tx=xdc, rx=xdc, seq=q.Sequence(type="FC", focus=pf, c0=1540.0),
            scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 9),
                                 z=np.linspace(16e-3, 24e-3, 9)),
            fs=12e6)
        p = np.asarray(us.calc_hp())     # (I1, I2, I3, M) max pressure
        assert p.shape == (9, 9, 1, 1) and np.isfinite(p).all()
        # the focused transmit concentrates pressure ON AXIS (x = 0)
        P = us.scan.positions().reshape(3, -1)
        k = int(p[..., 0].reshape(-1).argmax())
        assert abs(P[0, k]) < 1e-3
    """
    scan = scan or us.scan
    seq = seq or us.seq
    fs = float(us.fs)
    c0 = float(seq.c0)
    R0 = float(us.lmbda if R0 is None else R0)

    wv = us.tx.impulse.conv(seq.pulse, fs)
    wv = dataclasses.replace(wv, fs=fs)
    kern = np.asarray(wv.samples)
    if np.iscomplexobj(kern):
        kern = np.real(kern)
    K = kern.shape[0]

    P = scan.positions().reshape(3, -1)  # (3, I)
    pe = us.tx.positions()               # (3, E)
    fire = -seq.delays(us.tx)            # (E, M)
    apd = seq.apodization(us.tx)         # (E, M)
    M = seq.num_pulse

    # time bounds from box-to-box interval arithmetic — O(I + E), not the
    # O(I*E) host f64 distance matrix (the bfAdjoint/greens-planner trap:
    # GBs of host compute + upload at imaging-grid scale)
    rmax = float(np.linalg.norm(np.maximum(
        np.abs(P.max(1) - pe.min(1)), np.abs(pe.max(1) - P.min(1)))))
    # per-axis box gap -> a true lower bound on the min pixel-element
    # distance (0 when the boxes overlap on that axis)
    gap = np.maximum(np.maximum(P.min(1) - pe.max(1),
                                pe.min(1) - P.max(1)), 0.0)
    rmin = float(np.linalg.norm(gap))
    tmin = rmin / c0 + fire.min() + wv.t0
    tmax = rmax / c0 + fire.max() + wv.tend
    n0 = math.floor(tmin * fs)
    T = math.ceil(tmax * fs) - n0 + 1
    s0 = n0 / fs
    G = T + 2 * K
    I = P.shape[1]

    from .ops.fdbf import geom_delays
    rj = geom_delays(np.ascontiguousarray(P.T, np.float32),
                     np.ascontiguousarray(pe.T, np.float32),
                     np.float32(1.0))  # (I, E) distances, on device
    w_r = jax.jit(lambda r, r0: 1.0 / jnp.maximum(r, r0))(
        rj, np.float32(R0))
    col = jnp.arange(I)[:, None]

    from .ops.conv import convd

    @jax.jit
    def one_tx(fire_m, apd_m):
        ti = (rj / c0 + fire_m[None, :] + (wv.t0 - s0)) * fs  # (I, E)
        i0 = jnp.floor(ti)
        u = ti - i0
        idx = jnp.clip(i0.astype(jnp.int32) + K, 0, G - 1)
        wgt = apd_m[None, :] * w_r
        grid = jnp.zeros((G, I), jnp.float32)
        grid = grid.at[idx.T, col.T].add((wgt * (1 - u)).T)
        grid = grid.at[(idx + 1).T, col.T].add((wgt * u).T)
        full = convd(grid, jnp.asarray(kern, jnp.float32).reshape(-1, 1),
                     axis=0, shape="full", method="fft" if K > 64 else "direct")
        return full[K:K + T]  # (T, I)

    ps = []
    for m in range(M):
        ps.append(one_tx(jnp.asarray(fire[:, m], jnp.float32),
                         jnp.asarray(apd[:, m], jnp.float32)))
    p = jnp.stack(ps, axis=-1)  # (T, I, M)
    if out == "field":
        return p, s0
    pm = jnp.max(jnp.abs(p), axis=0)  # (I, M)
    return np.asarray(pm).reshape(tuple(scan.shape) + (M,))


UltrasoundSystem.calc_hp = _calc_hp
