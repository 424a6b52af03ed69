"""Batched device extension kernel vs the host oracle.

ops/extend_tpu.ksw_extend_batch must be bit-exact with engine/extend
.ksw_extend2 (itself pinned by the golden tests) across band widths, Z-drop
terminations, to-end extensions and window-shrink edge cases.
"""
import numpy as np
import pytest

from bwamem_tpu.api.options import MemOptions
from bwamem_tpu.engine.extend import ksw_extend2
from bwamem_tpu.ops.extend_tpu import ksw_extend_batch_np


def run_batch(qseqs, tseqs, h0s, ws, bonuses, opt=None):
    opt = opt or MemOptions()
    params = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)
    got = ksw_extend_batch_np(qseqs, tseqs, opt.mat, params, h0s, ws, bonuses)
    exp = [
        ksw_extend2(q, t, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                    w, b, opt.zdrop, h0)
        for q, t, h0, w, b in zip(qseqs, tseqs, h0s, ws, bonuses)
    ]
    for k, (e, g) in enumerate(zip(exp, got)):
        ed = dict(score=e.score, qle=e.qle, tle=e.tle, gtle=e.gtle,
                  gscore=e.gscore, max_off=e.max_off)
        assert ed == g, f"job {k}: {ed} != {g}"


def test_batch_random_jobs():
    rng = np.random.default_rng(7)
    opt = MemOptions()
    qseqs, tseqs, h0s, ws, bonuses = [], [], [], [], []
    for _ in range(24):
        ql = int(rng.integers(1, 60))
        tl = int(rng.integers(1, 80))
        base = rng.integers(0, 4, max(ql, tl)).astype(np.uint8)
        q, t = base[:ql].copy(), base[:tl].copy()
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, tl))
            t[p] = (t[p] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.3 and tl > 8:
            pos = int(rng.integers(0, tl - 3))
            t = np.concatenate([t[:pos], t[pos + 2 :]])
        qseqs.append(q)
        tseqs.append(t)
        h0s.append(int(rng.integers(1, 50)))
        ws.append(int(rng.choice([3, 10, 100])))
        bonuses.append(int(rng.choice([0, 5])))
    run_batch(qseqs, tseqs, h0s, ws, bonuses)


def test_batch_edge_cases():
    # perfect extension, tiny seqs, query longer than target, zdrop trigger
    qseqs = [
        np.array([0, 1, 2, 3] * 10, dtype=np.uint8),
        np.array([2], dtype=np.uint8),
        np.array([0, 1, 2, 3] * 20, dtype=np.uint8),  # qlen 80 > tlen 5
        np.concatenate([np.array([0, 1] * 10), np.array([3] * 60)]).astype(np.uint8),
    ]
    tseqs = [
        np.array([0, 1, 2, 3] * 10, dtype=np.uint8),
        np.array([2, 2], dtype=np.uint8),
        np.array([0, 1, 2, 3, 0], dtype=np.uint8),
        np.concatenate([np.array([0, 1] * 10), np.array([1] * 60)]).astype(np.uint8),
    ]
    run_batch(qseqs, tseqs, [19, 5, 30, 20], [100, 100, 100, 100], [5, 0, 5, 5])


def test_batch_zero_reset_quirk():
    """The M==0 reset: a weak h0 with early mismatches must reproduce the
    engine's inability to extend through zeroed cells."""
    q = np.array([3, 3, 3, 0, 1, 2, 3, 0, 1, 2], dtype=np.uint8)
    t = np.array([0, 0, 0, 0, 1, 2, 3, 0, 1, 2], dtype=np.uint8)
    run_batch([q], [t], [2], [10], [0])


def _random_jobs(rng, B, Q, T, bands):
    q = rng.integers(0, 4, (B, Q)).astype(np.uint8)
    t = rng.integers(0, 4, (B, T)).astype(np.uint8)
    t[: B // 2, : Q // 2] = q[: B // 2, : Q // 2]  # half the jobs share a prefix
    qlen = rng.integers(1, Q + 1, B)
    tlen = rng.integers(1, T + 1, B)
    jobs = [(q[i, : qlen[i]], t[i, : tlen[i]]) for i in range(B)]
    h0s = [int(x) for x in rng.integers(1, 60, B)]
    ws = [int(x) for x in rng.choice(bands, B)]
    bonuses = [int(x) for x in rng.choice([0, 5], B)]
    return jobs, h0s, ws, bonuses


def _smoke_jobs(rng, B, Q, T, bands):
    import chip_smoke

    return chip_smoke.make_ext_jobs(rng, B, Q, T)


@pytest.mark.parametrize("early_exit", [False, True], ids=["scan", "while"])
@pytest.mark.parametrize(
    "make,B,Q,T,bands",
    [
        (_random_jobs, 128, 128, 160, [3, 10, 100, 400]),  # aligned widths
        (_random_jobs, 37, 61, 93, [3, 10, 100]),  # ragged B/Q/T
        (_smoke_jobs, 48, 150, 640, None),  # indels, Z-drop tails, wide T
    ],
    ids=["aligned", "ragged", "adversarial"],
)
def test_kernel_matches_cpp_and_oracle(make, B, Q, T, bands, early_exit):
    """ksw_extend_batch, called directly on padded arrays, equals the C++
    ksw_extend2 and the python oracle on every job and field."""
    import jax.numpy as jnp

    from bwamem_tpu.engine import native_ksw
    from bwamem_tpu.ops.extend_tpu import _WAVE_KEYS, ksw_extend_batch

    opt = MemOptions()
    jobs, h0s, ws, bonuses = make(np.random.default_rng(B), B, Q, T, bands)
    qa = np.zeros((B, Q), np.int32)
    ta = np.zeros((B, T), np.int32)
    for i, (q, t) in enumerate(jobs):
        qa[i, : len(q)] = q
        ta[i, : len(t)] = t
    got = ksw_extend_batch(
        jnp.asarray(qa), jnp.asarray(ta),
        jnp.asarray([len(q) for q, _ in jobs], jnp.int32),
        jnp.asarray([len(t) for _, t in jobs], jnp.int32),
        jnp.asarray(h0s, jnp.int32), jnp.asarray(ws, jnp.int32),
        jnp.asarray(bonuses, jnp.int32),
        jnp.asarray(np.asarray(opt.mat, np.int32).reshape(5, 5)),
        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
        int(max(opt.mat)), early_exit=early_exit,
    )
    got = [{k: int(got[k][i]) for k in _WAVE_KEYS} for i in range(B)]
    if native_ksw.available():
        want = native_ksw.extend_batch(
            jobs, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.zdrop, h0s, ws, bonuses,
        )
        assert got == [{k: int(w[k]) for k in _WAVE_KEYS} for w in want]
    for i, ((q, t), h0, w, b) in enumerate(zip(jobs, h0s, ws, bonuses)):
        e = ksw_extend2(q, t, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                        opt.e_ins, w, b, opt.zdrop, h0)
        assert got[i] == dict(score=e.score, qle=e.qle, tle=e.tle,
                              gtle=e.gtle, gscore=e.gscore,
                              max_off=e.max_off), f"job {i}"
