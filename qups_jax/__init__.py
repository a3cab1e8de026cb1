"""qups_jax — ultrasound processing & simulation in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
thorstone25/qups (see SURVEY.md): transducers, transmit sequences, imaging
grids, scattering media, Green's-function simulation, and delay-and-sum /
adjoint / migration / eikonal beamforming — with static shapes, a fused
GPU DAS kernel, and mesh sharding.
"""
from .core import (
    Waveform, Transducer, TransducerArray, TransducerConvex, TransducerMatrix,
    TransducerGeneric, Sequence, SequenceRadial, SequenceGeneric, Scan,
    ScanCartesian, ScanPolar, ScanSpherical, ScanGeneric, Scatterers, Medium,
    ChannelData,
)
from .system import UltrasoundSystem
from .ops.apod import Fused
from . import ops
from . import utils
from . import interop
from . import display  # binds imagesc/plot/gif methods

__version__ = "0.1.0"
