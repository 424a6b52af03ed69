"""Device (prefix-doubling) suffix-array builder vs the host oracles.

The reference treats SA construction as a host-side offline step ([EXT]
is.c / rope.c via bwa_idx_build, org_…_BwaMemIndex.c:59); the redesign
adds an on-device builder (ops/sa_tpu.py).  These tests pin it to the
numpy/native oracles, including the adversarial string classes that stress
prefix doubling (long runs: maximal rank-tie chains)."""
import numpy as np
import pytest

from bwamem_tpu.index import native_sais
from bwamem_tpu.index.sais import suffix_array_numpy
from bwamem_tpu.ops.sa_tpu import suffix_array_device


def _oracle(codes):
    if native_sais.available():
        return native_sais.suffix_array(codes)
    return suffix_array_numpy(codes)


def test_device_sa_tiny():
    for codes in ([0], [0, 0], [3, 1, 2, 0], [1, 1, 1, 1, 1]):
        arr = np.asarray(codes, dtype=np.uint8)
        assert np.array_equal(suffix_array_device(arr), _oracle(arr))


def test_device_sa_fuzz():
    rng = np.random.default_rng(31)
    for trial in range(40):
        n = int(rng.integers(1, 3000))
        style = trial % 4
        if style == 0:
            codes = rng.integers(0, 4, n).astype(np.uint8)
        elif style == 1:
            codes = np.zeros(n, np.uint8)  # homopolymer: worst-case ties
        elif style == 2:
            period = int(rng.integers(1, 8))
            codes = np.tile(rng.integers(0, 4, period).astype(np.uint8), n)[:n]
        else:
            codes = rng.integers(0, 6, n).astype(np.uint8)  # with N codes
        got = suffix_array_device(codes)
        assert np.array_equal(got, _oracle(codes)), (trial, style, n)


def test_device_sa_in_index_build(monkeypatch):
    """BWAMEM_TPU_DEVICE_SA=1 produces a byte-identical index."""
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.utils.fasta import Fasta, FastaContig

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 20_000).astype(np.uint8)
    fa = Fasta([FastaContig("c", "", codes)])
    idx_host = build_index(fa)
    monkeypatch.setenv("BWAMEM_TPU_DEVICE_SA", "1")
    idx_dev = build_index(fa)
    assert np.array_equal(idx_host.bwt.bwt, idx_dev.bwt.bwt)
    assert np.array_equal(idx_host.bwt.sa, idx_dev.bwt.sa)
    assert idx_host.bwt.primary == idx_dev.bwt.primary


@pytest.mark.skipif(not native_sais.available(), reason="no C++ toolchain")
def test_native_sais_adversarial_fuzz():
    """The sign-flag induced-sort encoding (sais.cpp) on hostile strings."""
    rng = np.random.default_rng(77)
    for trial in range(300):
        n = int(rng.integers(1, 80))
        k = int(rng.integers(1, 5))
        codes = rng.integers(0, k, n).astype(np.uint8)
        assert np.array_equal(
            native_sais.suffix_array(codes), suffix_array_numpy(codes)
        ), codes.tolist()
