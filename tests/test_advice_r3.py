"""Round-3 advisor findings (ADVICE.md) regression tests.

1. native bwamem_interleave_bwt vs the numpy formulation: the native pass
   serves every stored BWT >= 4M codes (all genome-scale indexes) but the
   fast suite only exercised numpy; pin equality directly on small inputs,
   including n % 128 != 0 and n % 16 != 0 tails, plus the deinterleave
   round-trip.
"""
import numpy as np
import pytest

from bwamem_tpu.index import build as build_mod
from bwamem_tpu.index import native_sais


def _numpy_interleave(codes):
    """Force the numpy branch of build.interleave_bwt regardless of size."""
    n = len(codes)
    assert n < (1 << 22)
    return build_mod.interleave_bwt(codes)


@pytest.mark.skipif(not native_sais.available(), reason="native sais unavailable")
@pytest.mark.parametrize(
    "n",
    [1, 15, 16, 17, 127, 128, 129, 128 * 3, 128 * 3 + 5, 128 * 7 + 16,
     4096, 4096 + 77],
)
def test_native_interleave_matches_numpy(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    ref = _numpy_interleave(codes)
    nat = native_sais.interleave_bwt(codes)
    assert nat.dtype == ref.dtype and nat.shape == ref.shape
    assert np.array_equal(nat, ref)
    back = build_mod.deinterleave_bwt(nat, n)
    assert np.array_equal(back, codes)


@pytest.mark.skipif(not native_sais.available(), reason="native sais unavailable")
def test_native_interleave_large_unaligned():
    # crosses the native path's parallel-block boundaries with a ragged tail
    n = (1 << 17) + 113  # n % 128 == 113, n % 16 == 1
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    assert np.array_equal(native_sais.interleave_bwt(codes), _numpy_interleave(codes))

