"""bwamem_tpu — a BWA-MEM-class short-read aligner on JAX.

Ground-up re-implementation of the capability surface of
broadinstitute/gatk-bwamem-jni (a JNI wrapper over lh3/bwa): FM-index SMEM
seeding, seed chaining, banded affine-gap Smith-Waterman, paired-end
statistics and mate rescue — with the device path built in JAX/XLA
(run on an NVIDIA GPU) and a host C++ engine and SA-IS index builder.

Public surface mirrors the reference's Java API:
    BwaMemIndex, BwaMemAligner, BwaMemAlignment, BwaMemPairEndStats
"""
from .api.aligner import BwaMemAligner
from .api.alignment import BwaMemAlignment
from .api.index import Algorithm, BwaMemIndex
from .api.options import (
    MEM_F_ALL,
    MEM_F_NOPAIRING,
    MEM_F_NO_MULTI,
    MEM_F_NO_RESCUE,
    MEM_F_PE,
    MEM_F_PRIMARY5,
    MEM_F_REF_HDR,
    MEM_F_SMARTPE,
    MEM_F_SOFTCLIP,
    MemOptions,
)
from .api.pestats import DO_NOT_INFER, FAILED, BwaMemPairEndStats
from .api import exceptions

__version__ = "0.2.0"

__all__ = [
    "BwaMemAligner",
    "BwaMemAlignment",
    "BwaMemIndex",
    "BwaMemPairEndStats",
    "Algorithm",
    "MemOptions",
    "exceptions",
    "DO_NOT_INFER",
    "FAILED",
    "MEM_F_PE",
    "MEM_F_ALL",
    "MEM_F_NOPAIRING",
    "MEM_F_NO_MULTI",
    "MEM_F_NO_RESCUE",
    "MEM_F_REF_HDR",
    "MEM_F_SOFTCLIP",
    "MEM_F_SMARTPE",
    "MEM_F_PRIMARY5",
]


def metrics():
    """Process-wide structured metrics snapshot (counters + stage timers);
    see utils/metrics.py for the env-gated dump/trace hooks."""
    from .utils import metrics as _m

    return _m.snapshot()
