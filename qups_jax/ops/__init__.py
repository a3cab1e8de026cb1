from .interp import interp1, interpd, interpf, wsinterpd, wsinterpd2
from .conv import convd, xcorr, conv_lag0, conv_len
from .coherence import cohfac, slsc, dmas, pcf, pwznxcorr
from .das import das, das_lut, delay_tables
from .greens import greens_splat, greens_dense
from .greens_freq import greens_freq
from .das_fused import das_kernel, das_lut_kernel
from .apod import Fused
from .simus import simus_fsa
from .fdbf import (bf_adjoint, refocus, refocus_op, refocus_apply,
                   stolt_migration, focus_tx_freq, geom_delays)
from .eikonal import msfm, msfm_multi
from .rays import (wbilerp, wbilerp_dense, xiaolinwu_line, ray_paths,
                   ray_paths_device, global_average_c)

__all__ = [
    "interp1", "interpd", "interpf", "wsinterpd", "wsinterpd2",
    "convd", "xcorr", "conv_lag0", "conv_len",
    "cohfac", "slsc", "dmas", "pcf", "pwznxcorr",
    "das", "das_lut", "delay_tables", "greens_splat", "greens_dense",
    "greens_freq", "das_kernel", "das_lut_kernel", "Fused", "simus_fsa",
    "bf_adjoint", "refocus", "stolt_migration", "focus_tx_freq",
    "msfm", "msfm_multi",
    "wbilerp", "wbilerp_dense", "xiaolinwu_line", "ray_paths",
    "ray_paths_device", "global_average_c",
]
