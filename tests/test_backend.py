"""The one backend decision (``utils/backend.py``): which DAS path runs
where, the compile-cache directory, and the scripts that refuse to run
without a GPU."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import qups_jax as q
from qups_jax.ops import das_fused
from qups_jax.utils import backend

ROOT = Path(__file__).resolve().parent.parent


def small_system():
    xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=8, c0=1540.0),
        scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                             z=np.linspace(18e-3, 22e-3, 8)), fs=12e6)
    chd = us.greens(q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0))
    return us, chd


@pytest.fixture
def kernel_calls(monkeypatch):
    """Record the fused-kernel calls the system makes; run them in the
    interpreter (this is the CPU) and fail if a caller asks for
    interpret mode itself."""
    calls = []

    def spy(name):
        real = getattr(das_fused, name)

        def call(*a, **k):
            assert "interpret" not in k, "the system chose interpret mode"
            calls.append(name)
            return real(*a, interpret=True, **k)
        monkeypatch.setattr(das_fused, name, call)

    spy("das_kernel")
    spy("das_lut_kernel")
    return calls


@pytest.mark.parametrize("case", ["plain", "keep_rx", "fused_apod",
                                  "cmap", "dense_apod", "xla", "table",
                                  "table_apod"])
def test_kernel_choice_on_gpu(case, kernel_calls, monkeypatch):
    """On a GPU the kernel serves the inputs it covers and the XLA scan
    the rest; both give the same image."""
    us, chd = small_system()
    monkeypatch.setattr("qups_jax.ops.das_fused.on_gpu", lambda: True)
    kw = {"keep_rx": dict(keep_rx=True),
          "fused_apod": dict(apod=(q.Fused("aperture_growth", f=1.0),)),
          "cmap": dict(c0=np.full(us.scan.shape, 1540.0, np.float32)),
          "dense_apod": dict(apod=us.ap_aperture_growth(f=1.0)),
          "xla": dict(kernel="xla")}.get(case, {})
    if case.startswith("table"):
        tau_rx, tau_tx = us.das_delay_tables()
        if case == "table_apod":
            kw = dict(apod=us.ap_aperture_growth(f=1.0))
        got = us.bfDASLUT(chd, tau_rx, tau_tx, **kw)
        want_calls = ["das_lut_kernel"] if case == "table" else []
        monkeypatch.setattr("qups_jax.ops.das_fused.on_gpu", lambda: False)
        ref = us.bfDASLUT(chd, tau_rx, tau_tx, **kw)
    else:
        got = us.DAS(chd, **kw)
        want_calls = ["das_kernel"] if case in (
            "plain", "keep_rx", "fused_apod", "cmap") else []
        monkeypatch.setattr("qups_jax.ops.das_fused.on_gpu", lambda: False)
        ref = us.DAS(chd, **{**kw, "apod": us.ap_aperture_growth(f=1.0)}
                     if case == "fused_apod" else kw)
    assert kernel_calls == want_calls
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_use_kernel(monkeypatch):
    """The one dispatch: covered inputs take the kernel on a GPU or when a
    test asks for the interpreter; dense apodization, an unknown sampler
    or the CPU take the XLA scan."""
    from qups_jax.ops.apod import Fused
    shape = (256, 16, 4)
    fused = (Fused("aperture_growth", f=1.5),)
    dense = (np.ones((1, 1, 1, 16, 1), np.float32),)
    assert not das_fused.use_kernel(shape, fused, "cubic", I=64)
    assert das_fused.use_kernel(shape, fused, "cubic", I=64, interpret=True)
    assert not das_fused.use_kernel(shape, dense, "cubic", I=64,
                                    interpret=True)
    monkeypatch.setattr(das_fused, "on_gpu", lambda: True)
    assert das_fused.use_kernel(shape, fused, "linear", keep_rx=True, I=64)
    assert not das_fused.use_kernel(shape, dense, "linear", I=64)
    assert not das_fused.use_kernel(shape, (), "cubic2x", I=64)


def test_cpu_takes_xla(kernel_calls):
    """On the CPU every DAS-family call takes the XLA paths."""
    us, chd = small_system()
    assert not backend.on_gpu()
    us.DAS(chd)
    us.DAS(chd, keep_rx=True, keep_tx=True)
    us.bfDAS(chd)
    us.coherence_image(chd)
    assert kernel_calls == []


def test_device_record():
    rec = backend.device_record()
    assert rec == {"platform": "cpu", "kind": rec["kind"],
                   "count": rec["count"]}
    assert rec["count"] >= 1 and backend.device_memory_bytes() > 0


def test_compile_cache_placement(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set; otherwise the
    fixed ``.jax_cache/`` of the checkout, listed in .gitignore."""
    import jax
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert backend.compile_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == before
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = backend.compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run(script, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "QUPS_TEST_DEVICE")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT), **(env_extra or {}))
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _json_lines(out):
    res = []
    for line in out.splitlines():
        try:
            res.append(json.loads(line))
        except ValueError:
            pass
    return res


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_the_cpu(script):
    """The card scripts exit non-zero and print no result without a GPU."""
    r = _run(str(ROOT / script), ROOT)
    assert r.returncode != 0
    assert not _json_lines(r.stdout)
    assert "GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py (no package on the
    path) the script fails and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env={**env, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not _json_lines(r.stdout)
