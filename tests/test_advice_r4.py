"""Regression tests for the round-4 advisor findings.

1. ops/smem_tpu.py backward slot scan: the live-max fori_loop bound is
   clamped to K_SLOTS, so one pathological (slot-overflowing) lane cannot
   inflate the scan for the whole batch — and, behaviorally, a batch that
   contains an overflowed lane still returns oracle-exact intervals for
   every healthy lane (overflow lanes fall back to the host oracle).
2. engine/seed_device.py: exhausting the batch-global rbeg walk budget
   (r_ovf) demotes rbeg resolution to host SA walks — that degradation now
   increments the ``device_seed_fused_r_overflows`` metrics counter while
   results stay oracle-equal.
"""
import numpy as np
import pytest

from bwamem_tpu.api.options import MemOptions
from bwamem_tpu.engine.fmindex import FMIndex
from bwamem_tpu.engine.seed import collect_intv
from bwamem_tpu.engine.seed_device import (
    collect_intv_batch_device,
    collect_intv_rbegs_batch_device,
)
from bwamem_tpu.index.build import build_index
from bwamem_tpu.utils.fasta import Fasta, FastaContig
from bwamem_tpu.utils import metrics


@pytest.fixture(scope="module")
def repeat_idx():
    """Genome dominated by one high-occurrence motif (trips walk budgets)."""
    rng = np.random.default_rng(7)
    motif = rng.integers(0, 4, 40).astype(np.uint8)
    parts = []
    for _ in range(700):
        parts.append(motif)
        parts.append(rng.integers(0, 4, 11).astype(np.uint8))
    codes = np.concatenate(parts)
    idx = build_index(Fasta([FastaContig("rep", "", codes)]))
    return FMIndex(idx), idx, motif


def _cmp_intervals(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.x0, x.x1, x.s, x.qb, x.qe) == (y.x0, y.x1, y.s, y.qb, y.qe)


def test_smem_batch_with_overflow_lane_stays_oracle_equal(repeat_idx):
    fm, idx, motif = repeat_idx
    opt = MemOptions()
    rng = np.random.default_rng(3)
    fwd = idx.get_seq(0, idx.bns.l_pac)
    reads = []
    # the pathological lane: long read over the repeat field produces many
    # forward snapshots / splits per start position
    reads.append(fwd[0:400].copy())
    for _ in range(6):
        L = int(rng.integers(80, 151))
        s = int(rng.integers(0, len(fwd) - L))
        reads.append(fwd[s : s + L].copy())
    got = collect_intv_batch_device(opt, fm, reads)
    for r, intervals in zip(reads, got):
        _cmp_intervals(intervals, collect_intv(opt, fm, r))


def test_r_overflow_counted_and_oracle_equal(repeat_idx):
    fm, idx, motif = repeat_idx
    opt = MemOptions()
    # every read sits on the ~700-occurrence motif; with max_occ 500 a
    # few dozen reads exceed the B*R_PER_READ-lane global walk budget
    from bwamem_tpu.engine.seed_device import _B_BUCKETS
    from bwamem_tpu.ops.seed_fused import R_PER_READ

    n = 2 * _B_BUCKETS[0] * R_PER_READ // 500 + 1
    assert n <= _B_BUCKETS[0]  # one batch bucket, budget B*R_PER_READ
    reads = [np.asarray(motif, np.uint8).copy() for _ in range(n)]
    metrics.reset()
    intervals_list, rbegs_list = collect_intv_rbegs_batch_device(
        opt, fm, reads
    )
    snap = metrics.snapshot()["counters"]
    assert snap.get("device_seed_fused_r_overflows", 0) >= 1, snap
    # correctness holds through the demotion
    from bwamem_tpu.engine.chain import sample_ks

    for r, intervals, rbegs in zip(reads, intervals_list, rbegs_list):
        oracle = collect_intv(opt, fm, r)
        _cmp_intervals(intervals, oracle)
        for p, rb in zip(oracle, rbegs):
            expect = fm.sa_lookup(np.asarray(sample_ks(p, opt.max_occ),
                                             dtype=np.int64))
            np.testing.assert_array_equal(np.asarray(rb), expect)
