"""Docs-as-tests (the reference's ExampleTest idea, ``test/ExampleTest.m``):
execute every fenced ``python`` block in README.md and every ``Example:``
docstring block in the package — documentation must run."""
import io
import re
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _readme_blocks():
    text = (ROOT / "README.md").read_text()
    return re.findall(r"```python\n(.*?)```", text, re.S)


def _docstring_examples():
    import inspect
    import qups_jax
    import qups_jax.core, qups_jax.ops, qups_jax.system
    import qups_jax.parallel, qups_jax.utils, qups_jax.sim

    out = []
    seen = set()
    mods = [qups_jax, qups_jax.system]
    import pkgutil
    import importlib
    for pkg in (qups_jax.core, qups_jax.ops, qups_jax.parallel,
                qups_jax.utils, qups_jax.sim):
        for m in pkgutil.iter_modules(pkg.__path__):
            mods.append(importlib.import_module(f"{pkg.__name__}.{m.name}"))
    def harvest(qualname, obj):
        doc = inspect.getdoc(obj)
        if not doc or "Example:" not in doc or id(obj) in seen:
            return
        seen.add(id(obj))
        ex = doc.split("Example:", 1)[1]
        code = "\n".join(
            ln[4:] if ln.startswith("    ") else ln
            for ln in textwrap.dedent(ex).splitlines())
        out.append((qualname, code))

    for mod in mods:
        for name, obj in vars(mod).items():
            if inspect.isfunction(obj):
                harvest(f"{mod.__name__}.{name}", obj)
            elif inspect.isclass(obj):
                harvest(f"{mod.__name__}.{name}", obj)
                for mname, meth in vars(obj).items():
                    f = getattr(meth, "__func__", meth)
                    if inspect.isfunction(f):
                        harvest(f"{mod.__name__}.{name}.{mname}", f)
    return out


@pytest.mark.parametrize("i", range(len(_readme_blocks())))
def test_readme_block(i):
    code = _readme_blocks()[i]
    env = {}
    with redirect_stdout(io.StringIO()):
        exec(compile(code, f"README.md[{i}]", "exec"), env)


@pytest.mark.parametrize("name,code", _docstring_examples() or
                         [("none", "pass")])
def test_docstring_example(name, code):
    env = {"np": np}
    with redirect_stdout(io.StringIO()):
        exec(compile(code, name, "exec"), env)


def test_io_roundtrip(tmp_path):
    import qups_jax as q
    from qups_jax.io import save_chd, load_chd, obj2dict, dict2obj

    x = (np.random.randn(16, 4, 2) + 1j * np.random.randn(16, 4, 2)).astype(np.complex64)
    chd = q.ChannelData(data=x, fs=10e6, t0=np.array([1e-6, 2e-6]))
    p = str(tmp_path / "chd.npz")
    save_chd(p, chd)
    chd2 = load_chd(p)
    assert chd2.fs == chd.fs
    assert np.allclose(np.asarray(chd2.data), x)
    assert np.allclose(chd2.t0_host, chd.t0_host)

    xdc = q.TransducerArray.L11_5v()
    d = obj2dict(xdc)
    xdc2 = dict2obj(d)
    assert np.allclose(xdc2.positions(), xdc.positions())
    assert xdc2.fc == xdc.fc


@pytest.mark.full
def test_cheat_sheet_runs():
    """The cheat-sheet example executes end-to-end (``ExampleTest`` runs
    ``cheat_sheet.m``, ``test/ExampleTest.m:332-341``)."""
    path = ROOT / "examples" / "cheat_sheet.py"
    src = path.read_text()
    buf = io.StringIO()
    with redirect_stdout(buf):
        exec(compile(src, str(path), "exec"), {"__name__": "__cheat__"})
    assert "cheat sheet OK" in buf.getvalue()
