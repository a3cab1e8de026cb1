"""Serialization / checkpointing.

The reference serializes via ``obj2struct`` on every class plus
UFF/USTB/Verasonics file IO (``src/UltrasoundSystem.m:268-307``, SURVEY §5).
Here the domain objects are plain dataclasses (trivially picklable /
dict-able) and ChannelData round-trips through ``.npz`` with complex data
stored as real ri pairs (device-complex-safe, see ``utils/cpx.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .core.channel_data import ChannelData
from .utils.cpx import to_host


def save_chd(path: str, chd: ChannelData) -> None:
    """Save ChannelData to ``.npz`` (complex stored as trailing ri pair)."""
    data = to_host(chd.data)
    cplx = np.iscomplexobj(data)
    if cplx:
        data = np.stack([data.real, data.imag], axis=-1)
    np.savez_compressed(path, data=data, fs=chd.fs,
                        t0=np.asarray(chd.t0_host), cplx=cplx)


def load_chd(path: str) -> ChannelData:
    z = np.load(path)
    data = z["data"]
    if bool(z["cplx"]):
        data = data[..., 0] + 1j * data[..., 1]
    t0 = z["t0"]
    return ChannelData(data=data, fs=float(z["fs"]),
                       t0=float(t0[0]) if t0.size == 1 else t0)


def save_checkpoint(path: str, tree: Any) -> None:
    """Checkpoint a pytree of (possibly multi-chip-sharded) arrays with
    orbax — the answer to the reference's lack of in-band
    checkpointing for long simulations (SURVEY §5: batch jobs + readers,
    ``src/UltrasoundSystem.m:1295-1374``): sharded ChannelData / image
    shards are written per-host without gathering to one device."""
    import os

    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    if os.path.exists(path):
        import shutil
        shutil.rmtree(path)
    with ocp.StandardCheckpointer() as ck:
        ck.save(path, tree)


def load_checkpoint(path: str, like: Any = None) -> Any:
    """Restore a :func:`save_checkpoint` pytree. ``like`` (optional) is a
    template tree of arrays or jax.ShapeDtypeStructs carrying target
    shardings — pass it to restore each leaf directly onto its device mesh;
    omitted, leaves come back as host numpy arrays."""
    import os

    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ck:
        return ck.restore(os.path.abspath(path), like)


def obj2dict(obj: Any) -> Dict:
    """Dataclass -> plain dict with a class tag (``obj2struct`` analog).
    Callables (waveform funs, region predicates) are dropped — they are
    code, not data."""
    d = {"class": type(obj).__name__}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if callable(v):
            continue
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            v = obj2dict(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        d[f.name] = v
    return d


def dict2obj(d: Dict):
    """Rebuild a core object from :func:`obj2dict` output."""
    from . import core

    d = dict(d)
    name = d.pop("class")
    if hasattr(core, name):
        cls = getattr(core, name)
    else:  # orchestration-layer classes (e.g. UltrasoundSystem)
        from . import system as _system
        cls = getattr(_system, name)
    kw = {}
    for k, v in d.items():
        if isinstance(v, dict) and "class" in v:
            v = dict2obj(v)
        kw[k] = v
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kw.items() if k in names})
