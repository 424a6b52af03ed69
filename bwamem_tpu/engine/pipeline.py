"""End-to-end alignment pipeline ([EXT] bwamem.c: mem_align1_core +
mem_reg2sam + bwamem_extra.c: mem_gen_alt).

Single-end path: seed -> chain -> filter -> extend -> dedup -> primary
marking -> records.  The paired-end driver (pair.py) builds on align1_regs.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..api.options import MEM_F_ALL, MEM_F_NO_MULTI, MemOptions
from .chain import chain_flt, mem_chain
from .extend import AlnReg, chain2aln
from .fmindex import FMIndex
from .finalize import Aln, mark_primary_se, reg2aln, sort_dedup_patch
from .seed import collect_intv


class Engine:
    """One opened index + its FM query structures (host oracle engine)."""

    def __init__(self, idx):
        self.idx = idx
        self.fm = FMIndex(idx)



def _flag_alt_regs(bns, regs: List[AlnReg]) -> List[AlnReg]:
    """[EXT] mem_align1_core tail: regs on ALT contigs get is_alt=1."""
    anns = bns.anns
    for r in regs:
        if r.rid >= 0 and anns[r.rid].is_alt:
            r.is_alt = 1
    return regs

def align1_regs(opt: MemOptions, eng: Engine, query: np.ndarray) -> List[AlnReg]:
    """[EXT] mem_align1_core: read codes -> deduped alignment regions."""
    intervals = collect_intv(opt, eng.fm, query)
    return _regs_from_intervals(opt, eng, query, intervals, None)


def _regs_from_intervals(opt, eng, query, intervals, rbegs_per_intv):
    from .chain import flt_chained_seeds

    qlen = len(query)
    chains = mem_chain(
        opt, eng.fm, eng.idx.bns, qlen, intervals, rbegs_per_intv
    )
    chains = chain_flt(opt, chains)
    flt_chained_seeds(opt, eng.idx, qlen, query, chains)
    regs: List[AlnReg] = []
    for c in chains:
        chain2aln(opt, eng.idx, qlen, query, c, regs)
    regs = sort_dedup_patch(opt, eng.idx, query, regs)
    return _flag_alt_regs(eng.idx.bns, regs)


def align_regs_batch(
    opt: MemOptions,
    eng: Engine,
    reads: List[np.ndarray],
    use_device_extension: bool | None = None,
    exec_cfg=None,
) -> List[List[AlnReg]]:
    """Batched mem_align1_core over many reads.

    Seeding runs in lockstep (one vectorized occ batch per tick across all
    reads, engine/seed_batch.py), every read's sampled suffix-array rows
    resolve in a single batched sa_lookup, and chain extension runs as
    cross-read device-kernel waves (engine/extend_batch.py).  Produces
    identical regions to align1_regs.

    exec_cfg (engine/exec_ctx.ExecConfig) picks per-stage device kernels
    and an optional mesh to shard the device batches over; None keeps the
    env-var defaults.
    """
    from .chain import chain_flt, mem_chain, sample_ks
    from .exec_ctx import DEFAULT as _DEFAULT_CFG
    from .extend_batch import chain2aln_batch
    from .seed_batch import collect_intv_batch
    from ..utils.timers import TIMERS

    from . import native_fm

    if exec_cfg is None:
        exec_cfg = _DEFAULT_CFG
    if use_device_extension is None:
        # the wave path picks its backend per wave (native C++ / python /
        # device kernel via exec_cfg/BWAMEM_TPU_DEVICE_EXTEND); False forces
        # the sequential per-read oracle path (used by equivalence tests)
        use_device_extension = True
    from . import native_chain

    device_seed = exec_cfg.want_device_seed()
    device_chain = exec_cfg.want_device_chain()
    device_salk = exec_cfg.want_device_sa_lookup()
    if (
        not device_seed
        and not device_chain
        and not device_salk
        and not exec_cfg.want_device_pipeline()
        and exec_cfg.mesh is None
        and native_fm.available()
        and native_chain.available()
        and use_device_extension
    ):
        return _align_regs_batch_native(opt, eng, reads, TIMERS, exec_cfg)
    if exec_cfg.want_device_pipeline() and use_device_extension:
        # ONE device dispatch: seeding + SA + chaining + extension
        # (ops/pipeline_fused.py); host applies dedup below as usual
        from .pipeline_device import regs_batch_fused

        with TIMERS.stage("device_pipeline"):
            regs_list = regs_batch_fused(opt, eng, reads, mesh=exec_cfg.mesh)
        with TIMERS.stage("dedup"):
            return [
                _flag_alt_regs(
                    eng.idx.bns, sort_dedup_patch(opt, eng.idx, query, regs)
                )
                for query, regs in zip(reads, regs_list)
            ]
    fused_rbegs = None
    with TIMERS.stage("seed"):
        if device_seed and device_salk:
            # ONE device dispatch for all three seeding rounds + occurrence
            # expansion + SA walks (ops/seed_fused.py)
            from .seed_device import collect_intv_rbegs_batch_device

            intervals_list, fused_rbegs = collect_intv_rbegs_batch_device(
                opt, eng.fm, reads, mesh=exec_cfg.mesh
            )
        elif device_seed:
            from .seed_device import collect_intv_batch_device

            intervals_list = collect_intv_batch_device(
                opt, eng.fm, reads, mesh=exec_cfg.mesh
            )
        elif native_fm.available():
            intervals_list = native_fm.collect_intv_batch(opt, eng.fm, reads)
        else:
            intervals_list = collect_intv_batch(opt, eng.fm, reads)
    # one global SA resolution for every interval of every read
    with TIMERS.stage("sa_lookup"):
        flat_ks = []
        spans: List[List[tuple]] = []
        if fused_rbegs is not None:
            # already resolved on device; flatten to the common layout
            flat_rbegs_parts: List[np.ndarray] = []
            off = 0
            for rb_read in fused_rbegs:
                read_spans = []
                for rb in rb_read:
                    read_spans.append((off, len(rb)))
                    flat_rbegs_parts.append(np.asarray(rb, dtype=np.int64))
                    off += len(rb)
                spans.append(read_spans)
            flat_rbegs = (
                np.concatenate(flat_rbegs_parts)
                if flat_rbegs_parts
                else np.zeros(0, dtype=np.int64)
            )
        else:
            for intervals in intervals_list:
                read_spans = []
                for p in intervals:
                    ks = sample_ks(p, opt.max_occ)
                    read_spans.append((len(flat_ks), len(ks)))
                    flat_ks.extend(ks)
                spans.append(read_spans)
        if fused_rbegs is not None:
            pass
        elif not flat_ks:
            flat_rbegs = np.zeros(0, dtype=np.int64)
        elif device_salk:
            from .seed_device import _get_dfm
            from ..ops.fmindex_tpu import sa_lookup as sa_lookup_dev

            ks_arr = np.asarray(flat_ks, dtype=np.int64)
            if exec_cfg.mesh is not None:
                from ..parallel.mesh import shard_batch

                n_dev = exec_cfg.mesh.devices.size
                pad = (-len(ks_arr)) % n_dev
                ks_in = shard_batch(
                    exec_cfg.mesh, np.pad(ks_arr, (0, pad))
                )
                flat_rbegs = np.asarray(
                    sa_lookup_dev(_get_dfm(eng.fm, exec_cfg.mesh), ks_in)
                )[: len(ks_arr)].astype(np.int64)
            else:
                flat_rbegs = np.asarray(
                    sa_lookup_dev(_get_dfm(eng.fm), ks_arr)
                ).astype(np.int64)
        elif native_fm.available():
            flat_rbegs = native_fm.sa_batch(
                eng.fm, np.asarray(flat_ks, dtype=np.int64)
            )
        else:
            flat_rbegs = eng.fm.sa_lookup(np.asarray(flat_ks, dtype=np.int64))
    if not use_device_extension:
        out: List[List[AlnReg]] = []
        for intervals, read_spans, query in zip(intervals_list, spans, reads):
            rbegs_per_intv = [
                flat_rbegs[off : off + ln] for off, ln in read_spans
            ]
            out.append(
                _regs_from_intervals(opt, eng, query, intervals, rbegs_per_intv)
            )
        return out
    from .chain import flt_chained_seeds

    with TIMERS.stage("chain"):
        if device_chain:
            from ..ops.chain_tpu import chains_device_batch

            rbegs_list = [
                [flat_rbegs[off : off + ln] for off, ln in read_spans]
                for read_spans in spans
            ]
            chains_list = chains_device_batch(
                opt, eng.fm, eng.idx.bns, reads, intervals_list, rbegs_list,
                mesh=exec_cfg.mesh,
            )
            for query, chains in zip(reads, chains_list):
                flt_chained_seeds(opt, eng.idx, len(query), query, chains)
        else:
            chains_list = []
            for intervals, read_spans, query in zip(
                intervals_list, spans, reads
            ):
                rbegs_per_intv = [
                    flat_rbegs[off : off + ln] for off, ln in read_spans
                ]
                chains = mem_chain(
                    opt, eng.fm, eng.idx.bns, len(query), intervals,
                    rbegs_per_intv,
                )
                chains = chain_flt(opt, chains)
                flt_chained_seeds(opt, eng.idx, len(query), query, chains)
                chains_list.append(chains)
    with TIMERS.stage("extend"):
        regs_list = chain2aln_batch(
            opt, eng.idx, reads, chains_list, exec_cfg=exec_cfg
        )
    with TIMERS.stage("dedup"):
        return [
            _flag_alt_regs(eng.idx.bns, sort_dedup_patch(opt, eng.idx, query, regs))
            for query, regs in zip(reads, regs_list)
        ]


def native_seed_sa(opt, eng, reads, TIMERS=None):
    """Native three-round seeding + vectorized SA resolution.

    Returns the raw arrays consumed by the native core/pipeline entries:
    (intv rows [N,5], intv_off, n_intv, rbegs, rbeg_off, cnt).
    """
    from . import native_fm

    if TIMERS is None:
        from ..utils.timers import TIMERS
    with TIMERS.stage("seed"):
        rows, n_intv = native_fm.collect_intv_batch_raw(opt, eng.fm, reads)
    with TIMERS.stage("sa_lookup"):
        # vectorized sample_ks over all intervals of all reads
        s = rows[:, 2]
        x0 = rows[:, 0]
        cnt = np.minimum(s, opt.max_occ)
        step = np.where(s > opt.max_occ, s // np.maximum(opt.max_occ, 1), 1)
        rbeg_off = np.zeros(len(rows), dtype=np.int64)
        np.cumsum(cnt[:-1], out=rbeg_off[1:])
        total = int(cnt.sum())
        within = np.arange(total, dtype=np.int64) - np.repeat(rbeg_off, cnt)
        ks_flat = np.repeat(x0, cnt) + np.repeat(step, cnt) * within
        rbegs = (
            native_fm.sa_batch(eng.fm, ks_flat)
            if total
            else np.zeros(0, dtype=np.int64)
        )
    intv_off = np.zeros(len(reads), dtype=np.int64)
    np.cumsum(n_intv[:-1], out=intv_off[1:])
    return rows, intv_off, n_intv, rbegs, rbeg_off, cnt.astype(np.int64)


def native_pipeline_ok(eng, reads, exec_cfg=None) -> bool:
    """Full-native pipeline applicability: native libs present, short-read
    regime (mem_flt_chained_seeds is a no-op under ~700bp; we gate at the
    fused-core threshold), and an unpacked reference cache."""
    from . import native_fm, native_pipeline
    from .exec_ctx import DEFAULT as _DEFAULT_CFG

    if exec_cfg is None:
        exec_cfg = _DEFAULT_CFG
    if not (native_fm.available() and native_pipeline.available()):
        return False
    if exec_cfg.any_device_stage():
        # mesh / device-wave / device stage-kernel routing stays on
        # align_regs_batch
        return False
    # all read lengths supported: the native tail carries the long-read
    # stages too (mem_flt_chained_seeds / mem_seed_sw in pipeline.cpp)
    return eng.idx.bns.l_pac <= eng.idx._UNPACK_CACHE_MAX


def _align_regs_batch_native(opt, eng, reads, TIMERS, exec_cfg=None):
    """Array-based fast path: native seeding -> vectorized interval sampling
    -> native SA walks -> native chaining, no per-interval Python objects."""
    from . import native_chain, native_fm
    from .chain import flt_chained_seeds
    from .exec_ctx import DEFAULT as _DEFAULT_CFG
    from .extend_batch import chain2aln_batch

    if exec_cfg is None:
        exec_cfg = _DEFAULT_CFG
    rows, intv_off, n_intv, rbegs, rbeg_off, cnt = native_seed_sa(
        opt, eng, reads, TIMERS
    )
    # the fused chain+extend core applies when no read is long enough to
    # trigger mem_flt_chained_seeds and the reference fits the unpacked cache
    from . import native_core

    max_qlen = max((len(r) for r in reads), default=0)
    fused = (
        native_core.available()
        and max_qlen < 500
        and eng.idx.bns.l_pac <= eng.idx._UNPACK_CACHE_MAX
        # force_waves keeps extension in cross-read device waves
        # (chain2aln_batch) instead of the fused host core — the
        # mesh/data-parallel path uses this
        and not exec_cfg.want_force_waves()
    )
    if fused:
        with TIMERS.stage("chain+extend"):
            regs_list = native_core.align_regs_batch_core(
                opt, eng.idx, reads, rows, intv_off, n_intv, rbegs,
                rbeg_off, cnt.astype(np.int64),
            )
        with TIMERS.stage("dedup"):
            return [
                _flag_alt_regs(eng.idx.bns, sort_dedup_patch(opt, eng.idx, query, regs))
                for query, regs in zip(reads, regs_list)
            ]
    with TIMERS.stage("chain"):
        qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
        chains_list = native_chain.chain_batch(
            opt, eng.idx.bns, qlens, rows, intv_off, n_intv, rbegs,
            rbeg_off, cnt.astype(np.int64),
        )
        for query, chains in zip(reads, chains_list):
            flt_chained_seeds(opt, eng.idx, len(query), query, chains)
    with TIMERS.stage("extend"):
        regs_list = chain2aln_batch(
            opt, eng.idx, reads, chains_list, exec_cfg=exec_cfg
        )
    with TIMERS.stage("dedup"):
        return [
            _flag_alt_regs(eng.idx.bns, sort_dedup_patch(opt, eng.idx, query, regs))
            for query, regs in zip(reads, regs_list)
        ]


def gen_alt_xa(
    opt: MemOptions, eng: Engine, regs: List[AlnReg], qlen: int, query: np.ndarray
) -> List[Optional[str]]:
    """[EXT] mem_gen_alt: XA alternative-hit strings, indexed by primary reg.

    Returns a list parallel to regs; XA[k] is the alt-hit string for the
    primary region at index k (None when there are no alternates or the
    count exceeds max_XA_hits).
    """
    n = len(regs)
    xa: List[Optional[str]] = [None] * n

    def pri_idx(i: int) -> int:
        k = regs[i].secondary_all
        if k >= 0 and regs[i].score >= regs[k].score * opt.xa_drop_ratio:
            return k
        return -1

    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = pri_idx(i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i].is_alt:
                has_alt[r] = True
    if tot == 0:
        return xa
    parts: List[List[str]] = [[] for _ in range(n)]
    for i in range(n):
        r = pri_idx(i)
        if r < 0:
            continue
        if cnt[r] > opt.max_xa_hits_alt or (not has_alt[r] and cnt[r] > opt.max_xa_hits):
            continue
        t = reg2aln(opt, eng.idx, qlen, query, regs[i])
        cig = "".join(f"{ln}{'MIDSH'[op]}" for op, ln in t.cigar)
        parts[r].append(
            f"{eng.idx.bns.anns[t.rid].name},{'+-'[t.is_rev]}{t.pos + 1},{cig},{t.NM};"
        )
    for k in range(n):
        if parts[k]:
            xa[k] = "".join(parts[k])
    return xa


def reg2sam_records(
    opt: MemOptions,
    eng: Engine,
    query: np.ndarray,
    regs: List[AlnReg],
    extra_flag: int = 0,
    mate: Optional[Aln] = None,
) -> List[Aln]:
    """[EXT] mem_reg2sam: regions -> final per-read record list.

    mark_primary_se must already have run on regs.  Flag assembly mirrors
    mem_aln2sam's bit fixes, and the internal 0x10000 'secondary-style
    supplementary' bit maps to SAM 0x100 exactly as fmt_BAMish does
    (jnibwa.c:50-51).
    """
    qlen = len(query)
    xa = (
        gen_alt_xa(opt, eng, regs, qlen, query)
        if not (opt.flag & MEM_F_ALL)
        else [None] * len(regs)
    )
    out: List[Aln] = []
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if (
            p.secondary >= 0
            and p.secondary < (1 << 30)
            and p.score < regs[p.secondary].score * opt.drop_ratio
        ):
            continue
        q = reg2aln(opt, eng.idx, qlen, query, p)
        q.XA = xa[k]
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1  # don't output subopt score for secondaries
        if out and p.secondary < 0:  # supplementary
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if out and not p.is_alt and q.mapq > out[0].mapq:
            q.mapq = out[0].mapq
        out.append(q)
    if not out:
        t = reg2aln(opt, eng.idx, qlen, query, None)
        t.flag |= extra_flag
        out.append(t)
    # mem_aln2sam flag fixes for each record
    for q in out:
        _fix_flags(q, mate)
    return out


def _fix_flags(p: Aln, m: Optional[Aln]) -> None:
    """Flag assembly from mem_aln2sam ([EXT] bwamem.c)."""
    p.flag |= 0x1 if m is not None else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m is not None and m.rid < 0) else 0
    if p.rid < 0 and m is not None and m.rid >= 0:  # copy mate pos to unmapped
        p.rid, p.pos, p.is_rev = m.rid, m.pos, m.is_rev
        p.cigar = []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m is not None and m.is_rev) else 0


def align_se(opt: MemOptions, eng: Engine, query: np.ndarray, read_id: int = 0) -> List[Aln]:
    """Full single-end alignment of one read (codes in {0..4})."""
    from ..api.options import MEM_F_PRIMARY5
    from .finalize import reorder_primary5

    regs = align1_regs(opt, eng, query)
    mark_primary_se(opt, regs, read_id)
    if opt.flag & MEM_F_PRIMARY5:
        reorder_primary5(opt.T, regs)
    return reg2sam_records(opt, eng, query, regs)
