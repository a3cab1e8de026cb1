from .dataclasses import pytree_dataclass, static_field, field
from .backend import on_gpu, compile_cache
from .cpx import ri_split, ri_join, to_host, to_device, to_device_ri
from .profiling import trace, Timer, annotate
from .maths import (
    mod2db, db2pow, pow2db, nan2zero, rsqrt, isalmostn,
    deg2rad, rad2deg, cosd, sind, vecnorm, next_pow2,
)

__all__ = [
    "pytree_dataclass", "static_field", "field",
    "on_gpu", "compile_cache",
    "ri_split", "ri_join", "to_host", "to_device", "to_device_ri",
    "trace", "Timer", "annotate",
    "mod2db", "db2pow", "pow2db", "nan2zero", "rsqrt", "isalmostn",
    "deg2rad", "rad2deg", "cosd", "sind", "vecnorm", "next_pow2",
]
