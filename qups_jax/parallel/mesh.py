"""Multi-device sharding for the hot pipelines.

The reference's parallelism is MATLAB pools over transmits / scatterer
blocks / elements with client-side concatenation (SURVEY.md §2.5). Here a
``jax.sharding.Mesh`` has the physics axes — ``frame`` (data parallel over
acquisitions), ``rx`` (receive channels), ``tx`` (transmits) — and XLA
collectives join the devices. The cards of one host reach each other all
to all, so the mesh follows the algorithm alone:

* **DAS**: channel data sharded over (rx, tx, frame); each device beamforms
  its channel subset against the full (replicated) pixel grid — with the
  fused DAS kernel on a GPU, or the XLA scan — and partial images are
  ``psum``-reduced over the rx/tx axes (the atomicAdd of
  ``src/interpd.cu:195-266`` becomes a collective).
* **greens**: scatterers sharded over the ``tx`` axis (reusing it as a
  generic worker axis), rx elements over ``rx``; per-device partial (T, N/a,
  M) grids are all-gathered/psum'd as appropriate.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.apod import Fused, dense_weights, split_fused
from ..ops.das import das, das_lut
from ..ops.das_fused import das_kernel, das_lut_kernel, use_kernel
from ..ops.greens import greens_splat


def _factor(n: int, k: int) -> Tuple[int, ...]:
    """Factor n into k roughly-even factors (largest first)."""
    out = []
    rem = n
    for i in range(k - 1, 0, -1):
        f = 1
        for d in range(int(rem ** (1 / (i + 1))) + 1, 0, -1):
            if rem % d == 0:
                f = d
                break
        out.append(f)
        rem //= f
    out.append(rem)
    return tuple(sorted(out, reverse=True))


def make_mesh(devices: Optional[Sequence] = None,
              axes: Tuple[str, ...] = ("frame", "rx", "tx"),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Build a device mesh over the physics axes.

    Example:
        import jax
        import numpy as np
        from qups_jax.parallel import make_mesh
        mesh = make_mesh(jax.devices(), axes=("rx", "tx"))
        assert int(np.prod(list(mesh.shape.values()))) == len(jax.devices())
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = _factor(n, len(axes))
    assert int(np.prod(shape)) == n, (shape, n)
    dev = np.array(devices).reshape(shape)
    return Mesh(dev, axes)


def _post_lags(post, lags, N):
    """Validate/normalize the in-mesh coherence options -> lag list."""
    if post not in ("cohfac", "slsc"):
        raise ValueError(f"unknown post {post!r}")
    if post != "slsc":
        return []
    if lags is None:
        lags = max(1, N // 4)
    return list(range(1, lags + 1)) if np.isscalar(lags) \
        else [int(v) for v in lags]


def _post_reduce(post, lag_list, b, *, rxa, nrx, N):
    """Aperture-coherence reduction INSIDE a shard_map body: the kept band
    ``b (I, Nsh, *F)`` reduces locally and the devices exchange image-sized
    psums — cohfac = coherent sum + power (``kern/cohfac.m:64``); slsc
    'average' (``kern/slsc.m:187-202``) unit-normalizes per sample and
    serves cross-shard lag pairs from a ppermute'd halo of the NEXT shard's
    first L channels (zeroed on the last shard — those pairs exceed the
    aperture; zero-padded channels are inert)."""
    if post == "cohfac":
        s = jnp.sum(b, axis=1)
        pw = jnp.sum(jnp.real(b * jnp.conj(b)), axis=1)
        if rxa:
            s = jax.lax.psum(s, rxa)
            pw = jax.lax.psum(pw, rxa)
        den = pw * np.float32(N)
        return jnp.real(s * jnp.conj(s)) / jnp.where(den == 0, 1.0, den)
    Nsh = b.shape[1]
    Lmax = max(lag_list)
    mag = jnp.abs(b)
    e = b / jnp.where(mag == 0, 1.0, mag)
    h = jax.lax.slice_in_dim(e, 0, Lmax, axis=1)
    if rxa and nrx > 1:
        h = jax.lax.ppermute(h, rxa, [((i + 1) % nrx, i) for i in range(nrx)])
        h = jnp.where(jax.lax.axis_index(rxa) == nrx - 1, 0.0, h)
    else:
        h = jnp.zeros_like(h)
    eh = jnp.concatenate([e, h], axis=1)
    z = jnp.zeros(b.shape[:1] + b.shape[2:], jnp.float32)
    for l in lag_list:
        w = np.float32(1.0 / (N - l) / len(lag_list))
        c = jnp.real(e * jnp.conj(jax.lax.slice_in_dim(eh, l, Nsh + l,
                                                        axis=1)))
        z = z + w * jnp.sum(c, axis=1)
    if rxa:
        z = jax.lax.psum(z, rxa)
    return z


def _sharded(mesh, body, statics, x, rx_args, tx_args, rep_args, *,
             keep_rx, keep_tx, post, lags, apods=()):
    """The common shard_map composition of the DAS family, compiled once
    per configuration (an eager shard_map would trace and compile anew
    on every call).

    ``x (T, N, M[, F])`` is zero-padded to mesh-divisible sizes and sharded
    N->'rx', M->'tx', F->'frame'; ``rx_args`` / ``tx_args`` are
    ``(array, axis)`` pairs whose ``axis`` runs over receivers /
    transmits, edge-padded and sharded alike; ``rep_args`` replicate;
    dense apodizations ``apods`` (I1', I2', I3', N', M') shard (and
    zero-pad) the element axes they span. ``body(statics, xl, rx_locals,
    tx_locals, rep, apods)`` — a module-level function, with hashable
    ``statics`` — returns the local image (I, N', M'[, F]); the summed
    axes are psum-reduced, or with ``post`` the kept rx band is reduced
    to a coherence image in the mesh."""
    x = jnp.asarray(x)
    if x.ndim > 4:
        raise ValueError("sharded DAS takes at most one frame axis")
    lag_list = ()
    if post is not None:
        if keep_tx:
            raise ValueError("post reductions run across the rx aperture")
        keep_rx = True
        lag_list = tuple(_post_lags(post, lags, x.shape[1]))
        nrx = mesh.shape["rx"] if "rx" in mesh.axis_names else 1
        if post == "slsc" and max(lag_list) > -(-x.shape[1] // nrx):
            raise ValueError(f"slsc max lag {max(lag_list)} exceeds the rx "
                             "shard width (the halo spans one shard)")
    return _sharded_jit(
        x, tuple(jnp.asarray(a) for a, _ in rx_args),
        tuple(jnp.asarray(a) for a, _ in tx_args),
        tuple(jnp.asarray(a) for a in rep_args), tuple(apods), mesh=mesh,
        body=body, statics=statics, rx_axes=tuple(ax for _, ax in rx_args),
        tx_axes=tuple(ax for _, ax in tx_args), keep_rx=keep_rx,
        keep_tx=keep_tx, post=post, lag_list=lag_list)


@partial(jax.jit, static_argnames=("mesh", "body", "statics", "rx_axes",
                                   "tx_axes", "keep_rx", "keep_tx", "post",
                                   "lag_list"))
def _sharded_jit(x, rx_args, tx_args, rep, apods, *, mesh, body, statics,
                 rx_axes, tx_axes, keep_rx, keep_tx, post, lag_list):
    N, M = x.shape[1], x.shape[2]
    F = x.shape[3] if x.ndim == 4 else None
    names = mesh.axis_names
    rxa = "rx" if "rx" in names else None
    txa = "tx" if "tx" in names else None
    fra = "frame" if "frame" in names and F is not None else None
    nrx = mesh.shape["rx"] if rxa else 1
    ntx = mesh.shape["tx"] if txa else 1
    nfr = mesh.shape["frame"] if fra else 1
    pn_, pm_ = (-N) % nrx, (-M) % ntx
    pad = [(0, 0), (0, pn_), (0, pm_)]
    if F is not None:
        pad.append((0, (-F) % nfr))
    x = jnp.pad(x, pad)

    def edge(args, axes, n, axis_name):
        out, specs = [], []
        for a, ax in zip(args, axes):
            if n:
                cfg = [(0, 0)] * a.ndim
                cfg[ax] = (0, n)
                a = jnp.pad(a, cfg, mode="edge")
            out.append(a)
            spec = [None] * a.ndim
            spec[ax] = axis_name
            specs.append(P(*spec))
        return tuple(out), tuple(specs)

    rx_l, rx_s = edge(rx_args, rx_axes, pn_, rxa)
    tx_l, tx_s = edge(tx_args, tx_axes, pm_, txa)
    rep_s = tuple(P() for _ in rep)
    ap_l, ap_s = [], []
    for a in apods:
        spans = (a.shape[3] == N, a.shape[4] == M)
        ap_l.append(jnp.pad(a, [(0, 0)] * 3 + [(0, pn_ if spans[0] else 0),
                                               (0, pm_ if spans[1] else 0)]))
        ap_s.append(P(None, None, None, rxa if spans[0] else None,
                      txa if spans[1] else None))
    fspec = (fra,) if F is not None else ()

    def local(xl, rxl, txl, repl, apl):
        img = body(statics, xl, rxl, txl, repl, apl)
        if not keep_rx and rxa:
            img = jax.lax.psum(img, rxa)
        if not keep_tx and txa:
            img = jax.lax.psum(img, txa)
        if post is not None:
            return _post_reduce(post, lag_list, img[:, :, 0], rxa=rxa,
                                nrx=nrx, N=N)
        return img

    if post is not None:
        ospec = P(None, *fspec)
    else:
        ospec = P(None, rxa if keep_rx else None, txa if keep_tx else None,
                  *fspec)
    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(P(None, rxa, txa, *fspec), rx_s, tx_s, rep_s,
                                tuple(ap_s)),
                      out_specs=ospec, check_vma=False)
    img = f(x, rx_l, tx_l, rep, tuple(ap_l))
    if post is None:
        img = img[:, : (N if keep_rx else 1), : (M if keep_tx else 1)]
    if F is not None:
        img = img[..., :F]
    return img


def _das_body(statics, xl, rxl, txl, repl, apl):
    """Per-device body of :func:`das_sharded`."""
    (use_kernel, fused, fs, fmod, tx_model, keep_rx, keep_tx, method,
     planar, interpret, im_shape) = statics
    prl, oril = rxl
    pvl, nvl, t0l, latl = txl
    pil, cinvl, lpx = repl
    if use_kernel:
        return das_kernel(xl, pil, prl, pvl, nvl, t0l, cinvl, fs=fs,
                          apod=fused, fmod=fmod, tx_model=tx_model,
                          keep_rx=keep_rx, keep_tx=keep_tx, method=method,
                          lat=lpx, lat_tx=latl, orientations=oril,
                          planar=planar, interpret=interpret)
    if fused:  # the same weights, evaluated on this shard's geometry
        rx_apods, tx_apods, _ = split_fused(fused)
        im = im_shape or (pil.shape[0], 1, 1)
        apl = tuple(apl) + tuple(
            w.reshape(im + w.shape[1:]) for w in dense_weights(
                rx_apods, tx_apods, pil, prl, oril, lpx, latl, nvl, planar))
    return das(xl, pil, prl, pvl, nvl, t0l, cinvl, fs=fs, apod=apl,
               fmod=fmod, tx_model=tx_model, keep_rx=keep_rx,
               keep_tx=keep_tx, method=method, im_shape=im_shape)


def das_sharded(mesh: Mesh, x, pi, pr, pv, nv, t0, cinv, *, fs: float,
                apod=(), fmod: float = 0.0, tx_model: str = "virtual",
                keep_rx: bool = False, keep_tx: bool = False,
                method: str = "cubic", im_shape=None, orientations=None,
                lat=None, post: Optional[str] = None, lags=None,
                interpret: bool = False):
    """Sharded delay-and-sum over a (frame, rx, tx) mesh.

    ``x (T, N, M[, F])`` is sharded N->'rx', M->'tx', F->'frame'; pixels
    are replicated; each device beamforms its channel block — with the
    fused DAS kernel (:func:`qups_jax.ops.das_fused.das_kernel`) on a GPU
    for the inputs it covers (or in the interpreter under
    ``interpret=True``), with the XLA scan otherwise — and the image
    (I, 1, 1[, F]) is psum-reduced over rx/tx and stays frame-sharded.
    With keep_rx/keep_tx the kept axis is returned sharded.

    ``apod``: dense broadcastable arrays (these send it to the XLA scan)
    and :class:`~qups_jax.ops.apod.Fused` descriptors (evaluated by the
    kernel, or on each shard's geometry for the scan);
    ``orientations``/``lat`` as in :func:`~qups_jax.ops.das_fused.das_kernel`.

    ``post``: 'cohfac' | 'slsc' — reduce the kept rx band to a coherence
    image INSIDE the shard_map (implies ``keep_rx``): the devices exchange
    image-sized psums (and, for slsc, a halo of ``lags`` channels) instead
    of gathering the (I, N) volume (``kern/cohfac.m:64``,
    ``kern/slsc.m:187-202``). Returns a real image (I[, F]).

    Example:
        import jax
        import numpy as np
        from qups_jax.parallel import make_mesh, das_sharded
        rng = np.random.default_rng(0)
        T, N, M = 128, 8, 4
        x = rng.standard_normal((T, N, M)).astype(np.float32)
        pi = np.stack([np.zeros(16), np.zeros(16),
                       np.linspace(10e-3, 25e-3, 16)], -1).astype(np.float32)
        pr = np.stack([np.linspace(-2e-3, 2e-3, N), np.zeros(N),
                       np.zeros(N)], -1).astype(np.float32)
        pv = np.zeros((M, 3), np.float32)
        nv = np.tile([0.0, 0.0, 1.0], (M, 1)).astype(np.float32)
        mesh = make_mesh(jax.devices(), axes=("rx", "tx"))
        img = das_sharded(mesh, x, pi, pr, pv, nv,
                          np.zeros(M, np.float32), 1 / 1540.0, fs=4e6,
                          tx_model="plane", method="linear")
        assert img.shape == (16, 1, 1)
    """
    from ..ops.das_fused import _planar

    apod = tuple(apod if isinstance(apod, (tuple, list)) else (apod,))
    x = jnp.asarray(x)
    N, M = x.shape[1:3]
    I = np.shape(pi)[0]
    fused = tuple(a for a in apod if isinstance(a, Fused))
    dense = tuple(a for a in apod if not isinstance(a, Fused))
    kr = keep_rx or post is not None
    kernel = use_kernel(x.shape, apod, method, cinv, kr, keep_tx, I=I,
                        interpret=interpret)
    _, _, lat_f = split_fused(fused)
    # the per-transmit lateral array shards with its transmits, so the
    # static descriptors drop it
    fused = tuple(Fused(a.kind, **{k: v for k, v in a.params
                                   if k != "lat_tx"}) for a in fused)
    if orientations is None:
        orientations = np.stack([np.zeros(N), np.ones(N)])
    t0 = np.broadcast_to(np.asarray(t0, np.float32).reshape(-1), (M,))
    lat_tx = np.zeros(M, np.float32) if lat_f is None else lat_f
    lat_px = np.asarray(pi, np.float32)[:, 0] if lat is None else lat
    apods = tuple(  # (I1', I2', I3', N', M')
        jnp.asarray(a).reshape(np.shape(a) + (1,) * (5 - np.ndim(a)))
        for a in dense)
    statics = (kernel, fused, float(fs), float(fmod), tx_model, kr,
               keep_tx, method, _planar(pi, pr, pv), interpret,
               tuple(im_shape) if im_shape else None)
    return _sharded(mesh, _das_body, statics, x,
                    [(pr, 0), (orientations, 1)],
                    [(pv, 0), (nv, 0), (t0, 0), (lat_tx, 0)],
                    [pi, jnp.asarray(cinv, jnp.float32), lat_px],
                    keep_rx=keep_rx, keep_tx=keep_tx, post=post, lags=lags,
                    apods=apods)


def _lut_body(statics, xl, rxl, txl, *_):
    """Per-device body of :func:`das_lut_sharded`."""
    use_kernel, fs, fmod, keep_rx, keep_tx, method, interpret = statics
    (taur,), (taut, t0l) = rxl, txl
    if use_kernel:
        return das_lut_kernel(xl, taur, taut, t0l, fs=fs, fmod=fmod,
                              keep_rx=keep_rx, keep_tx=keep_tx,
                              method=method, interpret=interpret)
    return das_lut(xl, taur, taut, t0l, fs=fs, fmod=fmod, keep_rx=keep_rx,
                   keep_tx=keep_tx, method=method)


def das_lut_sharded(mesh: Mesh, x, tau_rx, tau_tx, t0, *, fs: float,
                    fmod: float = 0.0, keep_rx: bool = False,
                    keep_tx: bool = False, method: str = "cubic",
                    post: Optional[str] = None, lags=None,
                    interpret: bool = False):
    """Sharded delay-and-sum from delay tables (``bfDASLUT`` /
    ``bfEikonal`` on a mesh): as :func:`das_sharded`, with the table
    columns ``tau_rx (I, N)`` / ``tau_tx (I, M)`` sharded with their
    elements; each device runs
    :func:`~qups_jax.ops.das_fused.das_lut_kernel` on a GPU (or the XLA
    :func:`~qups_jax.ops.das.das_lut`)."""
    x = jnp.asarray(x)
    kr = keep_rx or post is not None
    kernel = use_kernel(x.shape, (), method, None, kr, keep_tx,
                        I=np.shape(tau_rx)[0], interpret=interpret)
    t0 = np.broadcast_to(np.asarray(t0, np.float32).reshape(-1),
                         (x.shape[2],))
    statics = (kernel, float(fs), float(fmod), kr, keep_tx, method,
               interpret)
    return _sharded(mesh, _lut_body, statics, x, [(tau_rx, 1)],
                    [(tau_tx, 1), (t0, 0)], [], keep_rx=keep_rx,
                    keep_tx=keep_tx, post=post, lags=lags)


def greens_sharded(mesh: Mesh, kern, ps, amp, pn, pv, *, T: int, s0: float,
                   t0k: float, fs: float, cinv, R0: float, fsr: float = 1.0,
                   method: str = "cubic", block: int = 32):
    """Sharded Green's-function FSA simulation.

    Scatterers are sharded over the 'tx' mesh axis (worker axis), receive
    elements over 'rx'; each device splats its scatterer block onto its
    (T, N/n_rx, M) slab, the scatterer-partial grids are psum'd over 'tx',
    and the rx axis stays sharded in the output.
    """
    shard_map = jax.shard_map

    S = np.shape(ps)[0]
    ntx = mesh.shape["tx"]
    pad = (-S) % (ntx * block)
    ps = jnp.pad(jnp.asarray(ps, jnp.float32), ((0, pad), (0, 0)))
    amp = jnp.pad(jnp.asarray(amp), (0, pad))

    def local(kernl, psl, ampl, pnl, pvl):
        x = greens_splat(kernl, psl, ampl, pnl, pvl, T=T, s0=s0, t0k=t0k,
                         fs=fs, cinv=cinv, R0=R0, fsr=fsr, method=method,
                         block=block)
        return jax.lax.psum(x, "tx")

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(None), P("tx", None), P("tx"),
                            P("rx", None, None), P(None, None, None)),
                  out_specs=P(None, "rx", None), check_vma=False)
    return f(jnp.asarray(kern), ps, amp, jnp.asarray(pn, jnp.float32),
             jnp.asarray(pv, jnp.float32))


def greens_freq_sharded(mesh: Mesh, kern, ps, amp, pn, pv, *, T: int,
                        s0: float, t0k: float, fs: float, cinv, R0: float,
                        fsr: float = 1.0, rtol: float = 1e-6,
                        precision: str = "highest", out: str = "complex",
                        alpha0: float = 0.0):
    """Sharded frequency-domain Green's-function simulation
    (:mod:`qups_jax.ops.greens_freq` under ``shard_map``).

    Scatterers are sharded over the 'tx' mesh axis (the generic worker
    axis: zero-amplitude padding makes shards equal), receive elements
    over 'rx'. Each device runs the per-bin phasor GEMMs on its
    (S/n_tx, N/n_rx) block; the partial geometry spectra G (F, N/n_rx, M)
    are ``psum``-reduced over 'tx' — ONE collective for the whole
    simulation, the freq-domain analog of the splat path's grid psum —
    and the irfft synthesis runs on the still-rx-sharded spectrum.
    """
    from ..ops import greens_freq as _  # noqa: F401 (package init)
    from ..ops.greens_freq import (_freq_gemm, _host_plan, _orchestrate,
                                   alpha_np_per_bin)
    shard_map = jax.shard_map

    plan = _host_plan(kern, ps, pn, pv, T=T, s0=s0, t0k=t0k, fs=fs,
                      cinv=cinv, R0=R0, fsr=fsr, rtol=rtol,
                      precision=precision)
    att = alpha_np_per_bin(alpha0, fs, plan["L"]) if alpha0 else 0.0
    psn, pnn, pvn = plan["ps"], plan["pn"], plan["pv"]
    gemm = partial(_freq_gemm, att=att)
    ntx = mesh.shape["tx"]
    has_rx = "rx" in mesh.axis_names
    nrx = mesh.shape["rx"] if has_rx else 1
    S, N = psn.shape[0], pnn.shape[0]
    pad_s = (-S) % ntx
    pad_n = (-N) % nrx
    ps_p = np.pad(psn, ((0, pad_s), (0, 0)), mode="edge")
    pn_p = np.pad(pnn, ((0, pad_n), (0, 0), (0, 0)), mode="edge")

    def local(psl, al, pnl):
        G = gemm(jnp.asarray(plan["phc"]), psl, al,
                 pnl, jnp.asarray(pvn), **plan["st"])
        return jax.lax.psum(G, "tx")

    rx = "rx" if has_rx else None
    f = shard_map(local, mesh=mesh,
                  in_specs=(P("tx", None), P("tx"), P(rx, None, None)),
                  out_specs=P(None, rx, None, None), check_vma=False)

    def gpass(a_real):
        a_p = jnp.pad(jnp.asarray(a_real, jnp.float32), (0, pad_s))
        return f(jnp.asarray(ps_p), a_p, jnp.asarray(pn_p))

    x = _orchestrate(gpass, plan, np.asarray(amp), T=T, out=out)
    return x[:, :N] if pad_n else x  # crop replicated rx padding


def bf_adjoint_sharded(mesh: Mesh, x, tau_rx, tau_tx, del_tx, apod_tx,
                       t0, t0_off, fbins, *, fs: float, fmod: float = 0.0,
                       keep_rx: bool = False, keep_tx: bool = False):
    """Multi-device frequency-domain adjoint beamformer: PIXELS shard over
    every mesh axis and each device runs
    :func:`qups_jax.ops.fdbf.bf_adjoint` on its delay-table rows — no
    collectives (the channel data and steering inputs replicate; the
    (I, N)/(I, M) tables are what is large). The reference parallelizes
    bfAdjoint per frequency bin on one GPU
    (``src/UltrasoundSystem.m:3770-4050``); the per-bin steering GEMMs
    contract the full element axes, so pixels are the axis that splits.

    Returns the complex image (I,), (I, N) or (I, V).

    Example:
        import jax
        import numpy as np
        from qups_jax.parallel import make_mesh, bf_adjoint_sharded
        rng = np.random.default_rng(0)
        T, N, M, V, I = 64, 4, 4, 4, 24
        x = rng.standard_normal((T, N, V)).astype(np.float32)
        tau_rx = rng.uniform(0, 2e-6, (I, N)).astype(np.float32)
        tau_tx = rng.uniform(0, 2e-6, (I, M)).astype(np.float32)
        del_tx = np.zeros((M, V), np.float32)
        apod = np.eye(M, dtype=np.float32)
        mesh = make_mesh(jax.devices(), axes=("rx", "tx"))
        b = bf_adjoint_sharded(
            mesh, x, tau_rx, tau_tx, del_tx, apod,
            np.zeros(V, np.float32), np.zeros(V, np.float32),
            np.arange(4, 12, dtype=np.int32), fs=20e6)
        assert b.shape == (I,) and np.isfinite(np.abs(np.asarray(b))).all()
    """
    from ..ops.fdbf import bf_adjoint

    axes = tuple(mesh.axis_names)
    ndev = int(np.prod([mesh.shape[a] for a in axes]))
    I = np.shape(tau_rx)[0]
    pad = ((0, (-I) % ndev), (0, 0))
    taur = jnp.pad(jnp.asarray(tau_rx, jnp.float32), pad, mode="edge")
    taut = jnp.pad(jnp.asarray(tau_tx, jnp.float32), pad, mode="edge")

    def local(xl, trl, ttl, dl, al, t0l, tol, fb):
        return bf_adjoint(xl, trl, ttl, dl, al, t0l, tol, fb, fs=fs,
                          fmod=fmod, keep_rx=keep_rx, keep_tx=keep_tx)

    nd = 2 if (keep_rx or keep_tx) else 1
    rep = P()
    f = jax.shard_map(local, mesh=mesh,
                      in_specs=(rep, P(axes, None), P(axes, None), rep, rep,
                                rep, rep, rep),
                      out_specs=P(axes, *([None] * (nd - 1))),
                      check_vma=False)
    b = f(jnp.asarray(x), taur, taut, jnp.asarray(del_tx, jnp.float32),
          jnp.asarray(apod_tx, jnp.float32),
          jnp.asarray(t0, jnp.float32).reshape(-1),
          jnp.asarray(t0_off, jnp.float32).reshape(-1),
          jnp.asarray(fbins, jnp.int32).reshape(-1))
    return b[:I]


def fdtd_sharded(mesh: Mesh, c, rho, src_idx, src_sig_tx, *, steps: int,
                 dt: float, dx: float, c_ref: float, record_rows,
                 alpha0=None, alpha_power: float = 1.5, bona=None,
                 axis: str = "tx"):
    """Transmit-sharded PSTD full-wave simulation: the reference's primary
    cluster axis for k-Wave-class sims is a parfor over transmits
    (``UltrasoundSystem.m:2648``, one sim per pulse); the mesh-native
    analog shards the transmit axis and runs the k-space stepper
    (:func:`qups_jax.sim.fdtd.kspace_sim_2d` / ``_3d``) sequentially per
    local transmit (``lax.map`` — one live field per device), with ZERO
    collectives: property maps and source nodes replicate, only the
    (Mtx, steps, Q) per-transmit source signals shard.

    Args:
      c, rho: (Nz, Nx[, Ny]) property maps (PML included).
      src_idx: (nd, Q) int source node indices — the UNION of source
        nodes across transmits (inactive nodes carry zero signal).
      src_sig_tx: (Mtx, steps, Q) per-transmit source signals; sharded
        over ``axis`` (zero-padded to the axis size, cropped on return).
      remaining args as :func:`qups_jax.sim.fdtd.kspace_sim_2d`.

    Returns (Mtx, steps, R, Nx[, Ny]) recorded pressure, tx-sharded.

    Example:
        import jax, numpy as np
        from qups_jax.parallel import make_mesh, fdtd_sharded
        c = np.full((64, 64), 1500.0); rho = np.full((64, 64), 1000.0)
        sig = np.zeros((3, 40, 2), np.float32); sig[:, 5, :] = 1.0
        idx = np.array([[20, 20], [30, 34]])
        mesh = make_mesh(jax.devices()[:2], axes=("tx",))
        rec = fdtd_sharded(mesh, c, rho, idx, sig, steps=40, dt=4e-8,
                           dx=2e-4, c_ref=1500.0, record_rows=(40,))
        assert rec.shape == (3, 40, 1, 64)
    """
    from ..sim.fdtd import kspace_sim_2d, kspace_sim_3d

    shard_map = jax.shard_map
    vol = np.ndim(c) == 3
    sig = np.asarray(src_sig_tx, np.float32)
    Mtx = sig.shape[0]
    ntx = mesh.shape.get(axis, 1)
    pm = (-Mtx) % ntx
    if pm:
        sig = np.pad(sig, ((0, pm),) + ((0, 0),) * (sig.ndim - 1))
    idx = np.asarray(src_idx)
    kw = dict(steps=int(steps), dt=float(dt), dx=float(dx),
              c_ref=float(c_ref),
              record_rows=tuple(int(r) for r in record_rows),
              alpha_power=float(alpha_power))
    cj = jnp.asarray(c, jnp.float32)
    rj = jnp.asarray(rho, jnp.float32)
    aj = None if alpha0 is None else jnp.asarray(alpha0, jnp.float32)
    bj = None if bona is None else jnp.asarray(bona, jnp.float32)

    def local(cl, rl, sig_l):
        def one(s):
            if vol:
                return kspace_sim_3d(cl, rl, idx, s, alpha0=aj, bona=bj,
                                     **kw)
            return kspace_sim_2d(cl, rl, jnp.asarray(idx[0]),
                                 jnp.asarray(idx[1]), s, alpha0=aj,
                                 bona=bj, **kw)
        return jax.lax.map(one, sig_l)

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(), P(), P(axis)),
                  out_specs=P(axis), check_vma=False)
    rec = jax.jit(f)(cj, rj, jnp.asarray(sig))
    return rec[:Mtx]


def _flat_axes(mesh: Mesh):
    """All mesh axis names as one tuple (shard one array axis over every
    device) and the total device count."""
    axes = tuple(mesh.axis_names)
    return axes, int(np.prod([mesh.shape[a] for a in axes]))


def refocus_op_sharded(mesh: Mesh, tau, apd, *, T: int, fs: float,
                       gamma=None, method: str = "tikhonov"):
    """Build the REFoCUS decode operator ``Hi (T, M, V)`` with the
    frequency-bin axis sharded over EVERY mesh axis — the per-bin
    whitened solves are independent, so the expensive half of a decode
    (~5 s of the 5.8 s headline; the reference blocks the same loop over
    frequencies, ``UltrasoundSystem.m:3696-3735``) scales linearly with
    ZERO collectives. Returns the bin-sharded device array.

    Example:
        import jax, numpy as np
        from qups_jax.parallel import make_mesh, refocus_op_sharded
        tau = np.zeros((4, 4), np.float32)
        apd = np.eye(4, dtype=np.float32)
        mesh = make_mesh(jax.devices()[:4], axes=("tx",))
        Hi = refocus_op_sharded(mesh, tau, apd, T=64, fs=8e6)
        assert Hi.shape == (64, 4, 4)
    """
    from ..ops.fdbf import refocus_op

    shard_map = jax.shard_map
    axes, ndev = _flat_axes(mesh)
    f_all = (np.fft.fftfreq(int(T)) * fs).astype(np.float32)
    pk = (-T) % ndev
    f_pad = np.pad(f_all, (0, pk))
    tau = jnp.asarray(tau, jnp.float32)
    apd = jnp.asarray(apd, jnp.float32)

    def local(fl, tl, al):
        return refocus_op(tl, al, T=int(T), fs=float(fs), gamma=gamma,
                          method=method, f=fl)

    hi = shard_map(local, mesh=mesh,
                   in_specs=(P(axes), P(None, None), P(None, None)),
                   out_specs=P(axes, None, None), check_vma=False)(
        jnp.asarray(f_pad), tau, apd)
    return hi[:T]


def refocus_sharded(mesh: Mesh, x, tau, apd, t0, *, fs: float, gamma=None,
                    method: str = "tikhonov", Hi=None):
    """Multi-chip REFoCUS decode: the operator build shards the frequency
    bins (:func:`refocus_op_sharded`), the apply shards the RECEIVE axis —
    FFT over time, per-bin transmit GEMM and inverse FFT are all
    per-channel independent, so the apply runs with zero collectives (one
    implicit Hi all-gather at the boundary; Hi is built once per
    sequence). Mirrors :func:`qups_jax.ops.fdbf.refocus`
    (``UltrasoundSystem.m:3505-3768``; the reference splices the same
    computation over frequency blocks on one GPU).

    ``Hi``: optionally pass a prebuilt operator (e.g. cached across
    frames) to skip the solve.

    Returns ``(y (T, N, M), t0min)`` like ``refocus_apply``.

    Example:
        import jax, numpy as np
        from qups_jax.parallel import make_mesh, refocus_sharded
        rng = np.random.default_rng(0)
        T, N, M, V = 64, 8, 4, 4
        x = rng.standard_normal((T, N, V)).astype(np.float32)
        tau = rng.uniform(0, 1e-6, (M, V)).astype(np.float32)
        apd = np.ones((M, V), np.float32)
        mesh = make_mesh(jax.devices()[:4], axes=("tx",))
        y, t0m = refocus_sharded(mesh, x, tau, apd,
                                 np.zeros(V, np.float32), fs=8e6)
        assert y.shape == (T, N, M)
    """
    from ..ops.fdbf import refocus_apply

    shard_map = jax.shard_map
    axes, ndev = _flat_axes(mesh)
    x = jnp.asarray(x)
    T, N = x.shape[0], x.shape[1]
    if Hi is None:
        Hi = refocus_op_sharded(mesh, tau, apd, T=T, fs=fs, gamma=gamma,
                                method=method)
    pn = (-N) % ndev
    if pn:
        x = jnp.pad(x, [(0, 0), (0, pn)] + [(0, 0)] * (x.ndim - 2))

    def local(xl, hil, t0l):
        return refocus_apply(xl, hil, t0l, fs=float(fs))

    y, t0min = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axes, *((None,) * (x.ndim - 2))),
                  P(None, None, None), P(None)),
        out_specs=(P(None, axes, *((None,) * (x.ndim - 2))), P()),
        check_vma=False)(x, Hi,
                         jnp.asarray(t0, jnp.float32).reshape(-1))
    return y[:, :N], t0min


def focus_tx_freq_sharded(mesh: Mesh, x, t2, w, *, fs: float):
    """Receive-sharded frequency-domain transmit synthesis
    (:func:`qups_jax.ops.fdbf.focus_tx_freq`; the reference splices
    ``focusTx`` over transmit blocks, ``UltrasoundSystem.m:3488``): the
    FFT / per-bin transmit GEMM / inverse FFT factor per receive
    channel, so the composition shards N over every mesh axis with zero
    collectives (the (K, M, M') steering tensor replicates).

    Example:
        import jax, numpy as np
        from qups_jax.parallel import make_mesh, focus_tx_freq_sharded
        rng = np.random.default_rng(0)
        T, N, M, Mp = 64, 8, 4, 6
        x = rng.standard_normal((T, N, M)).astype(np.float32)
        t2 = rng.uniform(0, 1e-6, (M, Mp)).astype(np.float32)
        w = np.ones((M, Mp), np.float32)
        mesh = make_mesh(jax.devices()[:4], axes=("tx",))
        y = focus_tx_freq_sharded(mesh, x, t2, w, fs=8e6)
        assert y.shape == (T, N, Mp)
    """
    from ..ops.fdbf import focus_tx_freq

    shard_map = jax.shard_map
    axes, ndev = _flat_axes(mesh)
    x = jnp.asarray(x)
    N = x.shape[1]
    pn = (-N) % ndev
    if pn:
        x = jnp.pad(x, [(0, 0), (0, pn)] + [(0, 0)] * (x.ndim - 2))
    t2 = jnp.asarray(t2, jnp.float32)
    w = jnp.asarray(w, jnp.float32)

    def local(xl, t2l, wl):
        return focus_tx_freq(xl, t2l, wl, fs=float(fs))

    tail = (None,) * (x.ndim - 2)
    y = shard_map(local, mesh=mesh,
                  in_specs=(P(None, axes, *tail), P(None, None),
                            P(None, None)),
                  out_specs=P(None, axes, *tail), check_vma=False)(
        x, t2, w)
    return y[:, :N]


def migration_sharded(mesh: Mesh, x, t0, del_tx, angles_deg, *, fs: float,
                      c0: float, pitch: float, fmod: float = 0.0,
                      keep_tx: bool = False, method: str = "cubic",
                      jacobian: bool = True, out: str = "complex"):
    """Plane-wave-angle-sharded Stolt f-k migration: each device migrates
    its transmit (angle) subset through
    :func:`qups_jax.ops.fdbf.stolt_migration` (Garcia ``gamma`` alignment
    factors enter as a sharded traced array) and the summed image is one
    psum — the reference splices ``bfMigration`` over frequency/transmit
    blocks on one GPU (``UltrasoundSystem.m:4740-4860``). Zero-signal
    padding angles make non-divisible M exact.

    Example:
        import jax, numpy as np
        from qups_jax.parallel import make_mesh, migration_sharded
        rng = np.random.default_rng(0)
        T, N, M = 64, 16, 3
        x = rng.standard_normal((T, N, M)).astype(np.float32)
        mesh = make_mesh(jax.devices()[:2], axes=("tx",))
        b = migration_sharded(mesh, x, 0.0, np.zeros((N, M), np.float32),
                              (-5.0, 0.0, 5.0), fs=8e6, c0=1540.0,
                              pitch=0.3e-3, out="ri")
        assert b.shape == (T, N, 1, 2)
    """
    from ..ops.fdbf import stolt_migration

    shard_map = jax.shard_map
    axes, ndev = _flat_axes(mesh)
    x = jnp.asarray(x)
    T, N, M = x.shape[:3]
    th = np.radians(np.asarray(angles_deg, np.float64)).reshape(-1)
    gamma = (np.sin(th) / (2 - np.cos(th))).astype(np.float32)
    t0v = np.broadcast_to(np.asarray(t0, np.float32).reshape(-1),
                          (M,)).copy()
    pm = (-M) % ndev
    if pm:
        x = jnp.pad(x, [(0, 0), (0, 0), (0, pm)])
        gamma = np.pad(gamma, (0, pm), mode="edge")
        t0v = np.pad(t0v, (0, pm), mode="edge")
        del_tx = np.pad(np.asarray(del_tx), ((0, 0), (0, pm)), mode="edge")

    def local(xl, t0l, dl, gl):
        b = stolt_migration(xl, t0l, dl, angles_deg=(), fs=fs, c0=c0,
                            pitch=pitch, fmod=fmod, keep_tx=keep_tx,
                            method=method, jacobian=jacobian, out=out,
                            gamma=gl)
        if not keep_tx:
            b = jax.lax.psum(b, axes)
        return b

    ospec = [None, None, axes if keep_tx else None]
    if out == "ri":
        ospec = ospec + [None]
    y = shard_map(local, mesh=mesh,
                  in_specs=(P(None, None, axes), P(axes),
                            P(None, axes), P(axes)),
                  out_specs=P(*ospec), check_vma=False)(
        x, jnp.asarray(t0v), jnp.asarray(del_tx, jnp.float32),
        jnp.asarray(gamma))
    if keep_tx and pm:
        y = y[:, :, :M]
    return y
