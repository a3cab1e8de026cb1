"""Tracing / profiling helpers.

The reference's observability is ``verbose`` prints + ``tic/toc`` and a
benchmark log task (SURVEY §5; ``test/ParTest.m:243-318``). The JAX
replacement: ``jax.profiler`` traces viewable in XProf/TensorBoard, plus
a wall-clock timer that forces device completion so remote-queued work is
charged to the right region.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace into ``logdir`` (open with
    ``tensorboard --logdir`` / XProf). Wrap the region of interest::

        with qups_jax.utils.trace("/tmp/prof"):
            img = us.DAS(chd)
            jax.block_until_ready(img)
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Named wall-clock sections with device synchronization.

    >>> tm = Timer()
    >>> with tm("beamform"):
    ...     img = f(x)
    >>> tm.times  # {"beamform": seconds}
    """

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.times[name] = self.times.get(name, 0.0) \
                + (time.perf_counter() - t0)


def annotate(name: str):
    """Named profiler region (shows up in the XProf timeline):
    ``with annotate("das-kernel"): ...``"""
    return jax.profiler.TraceAnnotation(name)
