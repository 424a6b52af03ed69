"""Wave-batched chain extension.

Same semantics as engine/extend.chain2aln, but the banded-SW extension calls
are collected across ALL reads into device-kernel waves (ops/extend_tpu's
exact ksw_extend2 batch).  Per-read control flow (seed processing order,
redundant-extension pruning, band-doubling retries) is preserved by walking
every read's (chain, seed) task list in lockstep: one task per read per
wave, because pruning inspects the regions produced by earlier tasks.

Identical output to the per-read path (tests/test_extend_batch.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..api.options import MemOptions
from .chain import Chain
from .extend import MAX_BAND_TRY, AlnReg

_PAD = 64
# below this many jobs the per-call dispatch/compile overhead of the device
# kernel exceeds the host DP cost; run those on the host oracle instead
HOST_FALLBACK_JOBS = 48
# coarse fixed buckets bound the number of distinct compiled shapes
_B_BUCKETS = (64, 256, 1024, 4096, 16384)
_Q_BUCKETS = (64, 192, 512, 2048)
_T_BUCKETS = (128, 512, 2048, 8192)


def _bucket(n: int, buckets=None) -> int:
    if buckets is None:
        return max(_PAD, ((n + _PAD - 1) // _PAD) * _PAD)
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


@dataclass
class _Task:
    chain: Chain
    ci: int  # chain index within the read (identity, not value equality)
    seed_idx: int  # index into chain.seeds
    srt_pos: int  # position in the chain's srt order (for overlap checks)


@dataclass
class _ReadState:
    query: np.ndarray
    chains: List[Chain]
    tasks: List[_Task] = field(default_factory=list)
    task_i: int = 0
    regs: List[AlnReg] = field(default_factory=list)
    # per-chain prep
    rmax: dict = field(default_factory=dict)  # chain id -> (rmax0, rmax1)
    rseq: dict = field(default_factory=dict)
    srt: dict = field(default_factory=dict)
    srt_alive: dict = field(default_factory=dict)


def _prep_read(opt: MemOptions, idx, query: np.ndarray, chains: List[Chain]) -> _ReadState:
    st = _ReadState(query=query, chains=chains)
    qlen = len(query)
    bns = idx.bns
    l_pac = bns.l_pac
    for ci, c in enumerate(chains):
        if not c.seeds:
            continue
        rmax0, rmax1 = l_pac << 1, 0
        for t in c.seeds:
            b = t.rbeg - (t.qbeg + opt.max_gap(t.qbeg))
            e = t.rbeg + t.len + (
                (qlen - t.qbeg - t.len) + opt.max_gap(qlen - t.qbeg - t.len)
            )
            rmax0 = min(rmax0, b)
            rmax1 = max(rmax1, e)
        rmax0 = max(rmax0, 0)
        rmax1 = min(rmax1, l_pac << 1)
        if rmax0 < l_pac < rmax1:
            if c.seeds[0].rbeg < l_pac:
                rmax1 = l_pac
            else:
                rmax0 = l_pac
        fwd_mid, is_rev = bns.depos(c.seeds[0].rbeg)
        rid = bns.pos_to_rid(fwd_mid)
        far_beg = bns.anns[rid].offset
        far_end = far_beg + bns.anns[rid].length
        if is_rev:
            far_beg, far_end = (l_pac << 1) - far_end, (l_pac << 1) - far_beg
        rmax0 = max(rmax0, far_beg)
        rmax1 = min(rmax1, far_end)
        st.rmax[ci] = (rmax0, rmax1)
        st.rseq[ci] = idx.get_seq(rmax0, rmax1)
        srt = sorted(range(len(c.seeds)), key=lambda i: (c.seeds[i].score, i))
        st.srt[ci] = srt
        st.srt_alive[ci] = [True] * len(srt)
        for pos in range(len(srt) - 1, -1, -1):
            st.tasks.append(_Task(chain=c, ci=ci, seed_idx=srt[pos], srt_pos=pos))
    # annotate chain index on tasks (chains processed in order; seeds of a
    # chain are contiguous because we appended per chain)
    return st


def _prune(opt: MemOptions, st: _ReadState, ci: int, task: _Task, qlen: int) -> bool:
    """The contained-seed pruning from chain2aln; True = skip extension."""
    c = task.chain
    s = c.seeds[task.seed_idx]
    contained = False
    for p in st.regs:
        if (
            s.rbeg < p.rb
            or s.rbeg + s.len > p.re
            or s.qbeg < p.qb
            or s.qbeg + s.len > p.qe
        ):
            continue
        if s.len - p.seedlen0 > 0.1 * qlen:
            continue
        qd, rd = s.qbeg - p.qb, s.rbeg - p.rb
        w = min(opt.max_gap(min(qd, rd)), p.w)
        if qd - rd < w and rd - qd < w:
            contained = True
            break
        qd, rd = p.qe - (s.qbeg + s.len), p.re - (s.rbeg + s.len)
        w = min(opt.max_gap(min(qd, rd)), p.w)
        if qd - rd < w and rd - qd < w:
            contained = True
            break
    if not contained:
        return False
    srt = st.srt[ci]
    alive = st.srt_alive[ci]
    k = task.srt_pos
    diff = False
    for i2 in range(k + 1, len(srt)):
        if not alive[i2]:
            continue
        t = c.seeds[srt[i2]]
        if t.len < s.len * 0.95:
            continue
        if (
            s.qbeg <= t.qbeg
            and s.qbeg + s.len - t.qbeg >= s.len >> 2
            and t.qbeg - s.qbeg != t.rbeg - s.rbeg
        ):
            diff = True
            break
        if (
            t.qbeg <= s.qbeg
            and t.qbeg + t.len - s.qbeg >= s.len >> 2
            and s.qbeg - t.qbeg != s.rbeg - t.rbeg
        ):
            diff = True
            break
    if not diff:
        alive[k] = False
        return True
    return False


def _run_kernel(opt: MemOptions, jobs, bonuses, ws, h0s, exec_cfg=None):
    """One batched ksw_extend2 wave; jobs = list of (qseq, tseq).

    Small waves run on the host oracle (identical semantics) — per-call
    device dispatch would dominate; large waves go to the device kernel
    with coarse shape buckets so only a handful of shapes ever compile.
    """
    from ..utils import metrics as _metrics
    from .exec_ctx import DEFAULT as _DEFAULT_CFG

    if exec_cfg is None:
        exec_cfg = _DEFAULT_CFG
    n = len(jobs)
    # explicit config > BWAMEM_TPU_DEVICE_EXTEND env > host waves
    use_device = exec_cfg.resolve_device_extend(n, HOST_FALLBACK_JOBS)
    _metrics.count("extend_waves")
    if use_device:
        _metrics.count("device_extend_waves")
        _metrics.count("device_extend_jobs", n)
    if not use_device:
        from . import native_ksw

        if native_ksw.available():
            return native_ksw.extend_batch(
                jobs, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                opt.zdrop, h0s, ws, bonuses,
            )
        from .extend import ksw_extend2

        out = []
        for (q, t), b, w, h0 in zip(jobs, bonuses, ws, h0s):
            r = ksw_extend2(
                q, t, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                w, b, opt.zdrop, h0,
            )
            out.append(
                dict(score=r.score, qle=r.qle, tle=r.tle, gtle=r.gtle,
                     gscore=r.gscore, max_off=r.max_off)
            )
        return out
    from ..ops.extend_tpu import ksw_extend_batch_np

    params = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)
    qmax = _bucket(max((len(q) for q, _ in jobs), default=1), _Q_BUCKETS)
    tmax = _bucket(max((len(t) for _, t in jobs), default=1), _T_BUCKETS)
    nb = _bucket(n, _B_BUCKETS)
    qseqs = [q for q, _ in jobs] + [np.zeros(0, np.uint8)] * (nb - n)
    tseqs = [t for _, t in jobs] + [np.zeros(0, np.uint8)] * (nb - n)
    res = ksw_extend_batch_np(
        qseqs, tseqs, opt.mat, params,
        list(h0s) + [0] * (nb - n),
        list(ws) + [opt.w] * (nb - n),
        list(bonuses) + [0] * (nb - n),
        bucket_q=qmax, bucket_t=tmax,
        mesh=exec_cfg.mesh,
    )
    return res[:n]


def _extend_side(opt, pend, side: str, exec_cfg=None):
    """Run one direction's extensions (with band-doubling retries) for the
    pending (state, task, reg, job-data) list."""
    if not pend:
        return
    bonus = opt.pen_clip5 if side == "left" else opt.pen_clip3
    todo = list(range(len(pend)))
    results = [None] * len(pend)
    aw = [opt.w] * len(pend)
    prev_score = [None] * len(pend)
    for attempt in range(MAX_BAND_TRY):
        if not todo:
            break
        jobs = [(pend[i][3], pend[i][4]) for i in todo]
        h0s = [pend[i][5] for i in todo]
        ws = [opt.w << attempt] * len(todo)
        res = _run_kernel(opt, jobs, [bonus] * len(todo), ws, h0s, exec_cfg)
        nxt = []
        for i, r in zip(todo, res):
            aw[i] = opt.w << attempt
            keep_going = (
                attempt + 1 < MAX_BAND_TRY
                and r["score"] != prev_score[i]
                and r["max_off"] >= (aw[i] >> 1) + (aw[i] >> 2)
            )
            results[i] = r
            prev_score[i] = r["score"]
            if keep_going:
                nxt.append(i)
        todo = nxt
    for i, (st, task, a, qs, ts, h0) in enumerate(pend):
        r = results[i]
        s = task.chain.seeds[task.seed_idx]
        if side == "left":
            a.score = r["score"]
            if r["gscore"] <= 0 or r["gscore"] <= a.score - opt.pen_clip5:
                a.qb = s.qbeg - r["qle"]
                a.rb = s.rbeg - r["tle"]
                a.truesc = a.score
            else:
                a.qb = 0
                a.rb = s.rbeg - r["gtle"]
                a.truesc = r["gscore"]
            a._aw0 = aw[i]
        else:
            sc0 = h0
            a.score = r["score"]
            qlen_read = len(st.query)
            rmax0 = st.rmax[task.ci][0]
            qe = s.qbeg + s.len
            re_off = s.rbeg + s.len - rmax0
            if r["gscore"] <= 0 or r["gscore"] <= a.score - opt.pen_clip3:
                a.qe = qe + r["qle"]
                a.re = rmax0 + re_off + r["tle"]
                a.truesc += a.score - sc0
            else:
                a.qe = qlen_read
                a.re = rmax0 + re_off + r["gtle"]
                a.truesc += r["gscore"] - sc0
            a._aw1 = aw[i]


def chain2aln_batch(
    opt: MemOptions,
    idx,
    reads: List[np.ndarray],
    chains_list: List[List[Chain]],
    exec_cfg=None,
) -> List[List[AlnReg]]:
    """Extend every read's chains; regions per read, identical to the
    sequential chain2aln loop."""
    states = [
        _prep_read(opt, idx, q, chains) for q, chains in zip(reads, chains_list)
    ]
    while True:
        # phase 1: pick each read's next unpruned task, set up left jobs
        left_pend = []
        current = []  # (state, task, reg) for reads active this wave
        any_active = False
        for st in states:
            qlen = len(st.query)
            task = None
            while st.task_i < len(st.tasks):
                t = st.tasks[st.task_i]
                if _prune(opt, st, t.ci, t, qlen):
                    st.task_i += 1
                    continue
                task = t
                break
            if task is None:
                continue
            any_active = True
            st.task_i += 1
            ci = task.ci
            s = task.chain.seeds[task.seed_idx]
            a = AlnReg()
            a.w = opt.w
            a._aw0 = a._aw1 = opt.w
            a.score = a.truesc = -1
            a.rid = task.chain.rid
            rmax0, _ = st.rmax[ci]
            rseq = st.rseq[ci]
            if s.qbeg:
                qs = st.query[: s.qbeg][::-1].copy()
                tmp = s.rbeg - rmax0
                ts = rseq[:tmp][::-1].copy()
                left_pend.append((st, task, a, qs, ts, s.len * opt.a))
            else:
                a.score = a.truesc = s.len * opt.a
                a.qb = 0
                a.rb = s.rbeg
            current.append((st, task, a))
        if not any_active:
            break
        _extend_side(opt, left_pend, "left", exec_cfg)
        # phase 2: right extensions
        right_pend = []
        for st, task, a in current:
            qlen = len(st.query)
            s = task.chain.seeds[task.seed_idx]
            rmax0, rmax1 = st.rmax[task.ci]
            rseq = st.rseq[task.ci]
            if s.qbeg + s.len != qlen:
                qe = s.qbeg + s.len
                re_off = s.rbeg + s.len - rmax0
                right_pend.append(
                    (st, task, a, st.query[qe:], rseq[re_off:], a.score)
                )
            else:
                a.qe = qlen
                a.re = s.rbeg + s.len
        _extend_side(opt, right_pend, "right", exec_cfg)
        # phase 3: finalize regs
        for st, task, a in current:
            c = task.chain
            a.seedcov = 0
            for t in c.seeds:
                if (
                    t.qbeg >= a.qb
                    and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb
                    and t.rbeg + t.len <= a.re
                ):
                    a.seedcov += t.len
            a.w = max(a._aw0, a._aw1)
            a.seedlen0 = c.seeds[task.seed_idx].len
            a.frac_rep = c.frac_rep
            st.regs.append(a)
    return [st.regs for st in states]
