"""Host glue for the one-dispatch device pipeline (ops/pipeline_fused.py).

``regs_batch_fused`` runs seeding + SA + chaining + extension for a read
batch as ONE device dispatch and decodes the fixed-shape region arrays
into per-read AlnReg lists; reads that overflow any device budget fall
back to the host oracle stage-by-stage, so results are bit-exact for
every read.  The caller (engine/pipeline.py::align_regs_batch) applies
dedup/MAPQ exactly as for the staged paths.

Anchor: the reference's single-call batch contract, jnibwa.c:197-235.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from ..api.options import MemOptions
from ..ops.pipeline_fused import OVF_CAUSES, pipeline_fused_kernel
from ..ops.seed_fused import F_PER_READ, M_SLOTS, R_PER_READ
from .chain import (
    MEM_HSP_COEF,
    MEM_MINSC_COEF,
    MEM_SEEDSW_COEF,
    chain_flt,
    flt_chained_seeds,
    mem_chain,
    sample_ks,
)
from .extend import AlnReg, chain2aln
from .seed import SmemIntv, collect_intv
from .seed_device import _bucket, _get_dfm, _pad_batch, _placer

# fixed device budgets (overflow -> host fallback, counted in metrics)
# (sized for the repeat-rich 64 Mbp chr20 genome of bench.py: at
# S/C/R = 256/128/32, 0.6% / 0.8% / 0.3% of its 150 bp reads overflowed)
S_SLOTS = 512  # seeds per read
C_SLOTS = 256  # chain slots per read
R_SLOTS = 64  # regions per read
_MAT_CACHE: dict = {}
_REF_CACHE: dict = {}


def _get_dref(idx, mesh=None):
    """Device-resident reference tables: 2-bit pac + contig arrays."""
    cache = _REF_CACHE
    key = (id(idx), None if mesh is None else id(mesh))
    ent = cache.get(key)
    if ent is None:
        import jax.numpy as jnp

        bns = idx.bns
        big = 2 * int(bns.l_pac) >= (1 << 31)
        cdt = np.int64 if big else np.int32
        pac8 = np.asarray(idx.pac, dtype=np.uint8)
        # 32-byte (128-base) rows: extension windows fetch whole rows
        # (ops/pipeline_fused.py::_win_codes)
        pad = (-len(pac8)) % 32
        pac8 = np.pad(pac8, (0, pad)).reshape(-1, 32)
        ctg_end = np.asarray(
            [a.offset + a.length for a in bns.anns], dtype=cdt
        )
        ctg_off = np.asarray([a.offset for a in bns.anns], dtype=cdt)
        ctg_alt = np.asarray([a.is_alt for a in bns.anns], dtype=np.int32)
        if mesh is not None:
            from ..parallel.mesh import replicate

            pac8, ctg_end, ctg_off, ctg_alt = replicate(
                mesh, pac8, ctg_end, ctg_off, ctg_alt
            )
        else:
            pac8 = jnp.asarray(pac8)
            ctg_end = jnp.asarray(ctg_end)
            ctg_off = jnp.asarray(ctg_off)
            ctg_alt = jnp.asarray(ctg_alt)
        ent = cache[key] = (pac8, ctg_end, ctg_off, ctg_alt)
    return ent


def _fcs_noop(opt: MemOptions, qlen: int) -> bool:
    """True when mem_flt_chained_seeds is a no-op for this read length
    (engine/chain.py::flt_chained_seeds early return)."""
    min_l = (
        MEM_HSP_COEF * opt.min_chain_weight
        if opt.min_chain_weight
        else MEM_MINSC_COEF * math.log(qlen) if qlen > 0 else 1.0
    )
    return min_l > MEM_SEEDSW_COEF * qlen


def _frac_rep(opt: MemOptions, intervals, qlen: int) -> float:
    b = e = l_rep = 0
    for p in intervals:
        if p.s <= opt.max_occ:
            continue
        if p.qb > e:
            l_rep += e - b
            b, e = p.qb, p.qe
        else:
            e = max(e, p.qe)
    l_rep += e - b
    return l_rep / qlen if qlen else 0.0


def _t_cap(opt: MemOptions, L: int) -> int:
    """Reference-window budget: single-seed windows are bounded by
    qlen + 2*max_gap(qlen) + slack; chains spanning more overflow to the
    host (win_ovf)."""
    t = 2 * L + 2 * opt.max_gap(L) + 16
    return ((t + 127) // 128) * 128


def regs_batch_fused(
    opt: MemOptions, eng, reads: List[np.ndarray], mesh=None
) -> List[List[AlnReg]]:
    """Per-read pre-dedup regions via the one-dispatch device pipeline."""
    import jax
    import jax.numpy as jnp

    from ..utils import metrics as _metrics
    from ..utils.timers import TIMERS
    from . import native_fm

    n = len(reads)
    if n == 0:
        return []
    fm, idx = eng.fm, eng.idx
    bns = idx.bns
    dfm = _get_dfm(fm, mesh)
    pac8, ctg_end, ctg_off, ctg_alt = _get_dref(idx, mesh)
    place = _placer(mesh)
    qseq, qlen_j, B, L = _pad_batch(reads, place, dtype=np.int8)
    fcs = np.zeros(B, dtype=bool)
    for i, r in enumerate(reads):
        fcs[i] = _fcs_noop(opt, len(r))
    fcs_j = place(fcs)
    _metrics.count("device_fused_pipeline_batches")

    R_cap, F_cap = B * R_PER_READ, B * F_PER_READ
    mat_key = np.asarray(opt.mat, dtype=np.int8).tobytes()
    mat_d = _MAT_CACHE.get(mat_key)
    if mat_d is None:
        mat_d = _MAT_CACHE[mat_key] = jnp.asarray(
            np.asarray(opt.mat, dtype=np.int32).reshape(5, 5)
        )
    from .chain import Chain  # noqa: F401  (fallback path builds chains)

    with dfm.ctx(), TIMERS.stage("fused_program"):
        out = pipeline_fused_kernel(
            dfm.lines, dfm.L2, dfm.sa, pac8, ctg_end, ctg_off, ctg_alt,
            qseq, qlen_j, fcs_j, mat_d,
            primary=dfm.primary, seq_len=dfm.seq_len, sa_intv=dfm.sa_intv,
            span=dfm.span, l_pac=int(bns.l_pac),
            min_seed_len=opt.min_seed_len, split_len=opt.split_len,
            split_width=opt.split_width,
            max_mem_intv=int(opt.max_mem_intv), max_occ=opt.max_occ,
            M=M_SLOTS, R_cap=R_cap, F_cap=F_cap,
            S=S_SLOTS, C=C_SLOTS, R=R_SLOTS, T_cap=_t_cap(opt, L),
            a=opt.a, o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
            e_ins=opt.e_ins, zdrop=opt.zdrop, pen_clip5=opt.pen_clip5,
            pen_clip3=opt.pen_clip3, w_opt=opt.w,
            max_sc=int(max(opt.mat)),
            max_chain_gap=opt.max_chain_gap,
            min_chain_weight=opt.min_chain_weight,
            max_chain_extend=opt.max_chain_extend,
            mask_level=float(opt.mask_level),
            drop_ratio=float(opt.drop_ratio),
        )
        flat, extra, regs_c, regs_i, info = jax.device_get(out)
    flat = np.asarray(flat, dtype=np.int64)
    extra = np.asarray(extra, dtype=np.int64)
    regs_c = np.asarray(regs_c, dtype=np.int64)
    regs_i = np.asarray(regs_i)
    info = np.asarray(info)

    # ---- decode the packed seed tables (fallback + frac_rep source) -----
    meta = extra[R_cap + 2 :]
    n_m = (meta & 0xFFFF).astype(np.int64)
    seed_ovf = (meta >> 16) != 0
    rbegs_flat = extra[:R_cap]
    total_rbegs = int(extra[R_cap])
    total_mems = int(extra[R_cap + 1])
    r_ovf = total_rbegs > R_cap
    mem_ovf = total_mems > F_cap
    starts = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(n_m, out=starts[1:])
    s_col = flat[:, 2]
    cnt = np.minimum(s_col, opt.max_occ)
    cnt[min(total_mems, len(flat)):] = 0
    offs = np.zeros(len(flat) + 1, dtype=np.int64)
    np.cumsum(cnt, out=offs[1:])

    def _host_sa(ks):
        if native_fm.available():
            return native_fm.sa_batch(fm, np.asarray(ks, dtype=np.int64))
        return fm.sa_lookup(np.asarray(ks, dtype=np.int64))

    nregs = info[:, 0]
    povf = info[:, 1] != 0
    for cause, b in OVF_CAUSES.items():
        k = int(((info[:n, 1] & b) != 0).sum())
        if k:
            _metrics.count(f"device_fused_pipeline_fallbacks_{cause}", k)
    out_regs: List[List[AlnReg]] = []
    for r in range(n):
        # intervals decode (shared by fallback and frac_rep)
        if seed_ovf[r] or mem_ovf:
            intervals = collect_intv(opt, fm, reads[r])
            rb_per = [
                _host_sa(sample_ks(p, opt.max_occ)) for p in intervals
            ]
        else:
            intervals = []
            rb_per = []
            for j in range(starts[r], starts[r] + n_m[r]):
                qbqe = int(flat[j, 3])
                intervals.append(
                    SmemIntv(
                        int(flat[j, 0]), int(flat[j, 1]), int(flat[j, 2]),
                        qbqe >> 16, qbqe & 0xFFFF,
                    )
                )
                if r_ovf:
                    p = intervals[-1]
                    rb_per.append(_host_sa(sample_ks(p, opt.max_occ)))
                else:
                    rb_per.append(
                        rbegs_flat[offs[j] : offs[j] + cnt[j]]
                    )
        if povf[r] or r_ovf:
            _metrics.count("device_fused_pipeline_fallbacks")
            chains = chain_flt(
                opt,
                mem_chain(opt, fm, bns, len(reads[r]), intervals, rb_per),
            )
            flt_chained_seeds(opt, idx, len(reads[r]), reads[r], chains)
            regs: List[AlnReg] = []
            for c in chains:
                chain2aln(opt, idx, len(reads[r]), reads[r], c, regs)
            out_regs.append(regs)
            continue
        frac = _frac_rep(opt, intervals, len(reads[r]))
        regs = []
        for k in range(int(nregs[r])):
            a_ = AlnReg()
            a_.rb = int(regs_c[r, k, 0])
            a_.re = int(regs_c[r, k, 1])
            a_.qb = int(regs_i[r, k, 0])
            a_.qe = int(regs_i[r, k, 1])
            a_.score = int(regs_i[r, k, 2])
            a_.truesc = int(regs_i[r, k, 3])
            a_.w = int(regs_i[r, k, 4])
            a_.seedcov = int(regs_i[r, k, 5])
            a_.seedlen0 = int(regs_i[r, k, 6])
            a_.rid = int(regs_i[r, k, 7])
            a_.frac_rep = frac
            regs.append(a_)
        out_regs.append(regs)
    return out_regs
