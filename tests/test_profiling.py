"""Profiling utilities smoke tests (SURVEY §5 tracing subsystem)."""
import numpy as np
import pytest
import jax.numpy as jnp

from qups_jax.utils import Timer, annotate, trace


def test_timer_and_annotation(tmp_path):
    tm = Timer()
    with tm("work"):
        x = jnp.arange(1024.0)
        with annotate("square"):
            y = (x * x).sum()
    assert tm.times["work"] > 0
    assert np.isclose(float(y), float(np.arange(1024.0).__pow__(2).sum()),
                      rtol=1e-6)


@pytest.mark.full
def test_trace_writes_logdir(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        jnp.ones(16).sum().block_until_ready()
    import os
    found = any("trace" in f or f.endswith(".pb") or f.endswith(".json.gz")
                for _, _, fs in os.walk(d) for f in fs)
    assert found
