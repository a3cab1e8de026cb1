from .mesh import (make_mesh, das_sharded, das_lut_sharded, greens_sharded,
                   greens_freq_sharded, bf_adjoint_sharded, fdtd_sharded,
                   refocus_op_sharded, refocus_sharded,
                   focus_tx_freq_sharded, migration_sharded)

__all__ = ["make_mesh", "das_sharded", "das_lut_sharded", "greens_sharded",
           "greens_freq_sharded", "bf_adjoint_sharded", "fdtd_sharded",
           "refocus_op_sharded", "refocus_sharded", "focus_tx_freq_sharded",
           "migration_sharded"]
