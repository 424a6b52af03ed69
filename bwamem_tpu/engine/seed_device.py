"""Device-side three-round SMEM seeding ([EXT] mem_collect_intv on device).

Round 1 (all SMEMs) and round 2 (re-seeding) run on the full bwt_smem1a
device kernel (ops/smem_tpu.py); round 3 (LAST-like) on the strategy-1
kernel (ops/seed_tpu.py).  Starts advance as lockstep cursor waves: every
kernel call processes one start per read lane, so a batch of reads costs
max-starts-per-read device dispatches per round, each a fixed-shape jitted
computation (batch and length bucketed to bound compilation).

Reads whose interval bookkeeping overflows the kernel's K slots (rare)
fall back to the host oracle read-by-read.  Output is bit-identical to
engine/seed.py::collect_intv (tests/test_smem_tpu.py).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..api.options import MemOptions
from ..ops.fmindex_tpu import DeviceFMIndex
from ..ops.seed_tpu import seed_strategy1
from ..ops.smem_tpu import smem1a_batch
from .fmindex import FMIndex
from .seed import SmemIntv, collect_intv

_B_BUCKETS = (64, 256, 1024, 4096)
_L_BUCKETS = (64, 192, 512)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


def _get_dfm(fm: FMIndex, mesh=None) -> DeviceFMIndex:
    """Device FM-index, cached per mesh (None = single default device).

    Under a mesh the occ/SA tables are REPLICATED to every device (the
    per-host-replica layout from SURVEY.md section 5); batch inputs shard."""
    from ..utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    cache = getattr(fm, "_device_fms", None)
    if cache is None:
        cache = fm._device_fms = {}
    dfm = cache.get(mesh)
    if dfm is None:
        dfm = DeviceFMIndex.from_host(fm)
        if mesh is not None:
            from dataclasses import replace as _replace

            from ..parallel.mesh import replicate

            lines, L2, sa = replicate(mesh, dfm.lines, dfm.L2, dfm.sa)
            dfm = _replace(dfm, lines=lines, L2=L2, sa=sa)
        cache[mesh] = dfm
    return dfm


def _placer(mesh):
    """Batch-array placement: sharded over the mesh, or plain device."""
    import jax.numpy as jnp

    if mesh is None:
        return lambda a, dtype=None: jnp.asarray(a, dtype=dtype)
    from ..parallel.mesh import shard_batch

    def place(a, dtype=None):
        return shard_batch(mesh, np.asarray(a, dtype=dtype))

    return place


def _pad_batch(reads: List[np.ndarray], place, dtype=np.int32):
    B = _bucket(len(reads), _B_BUCKETS)
    L = _bucket(max((len(r) for r in reads), default=1), _L_BUCKETS)
    qseq = np.full((B, L), 4, dtype=dtype)
    qlen = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        qseq[i, : len(r)] = r
        qlen[i] = len(r)
    return place(qseq), place(qlen), B, L


def collect_intv_rbegs_batch_device(
    opt: MemOptions, fm: FMIndex, reads: List[np.ndarray], mesh=None
):
    """ONE-dispatch seeding + SA resolution (ops/seed_fused.py).

    Returns (intervals_list, rbegs_per_intv): per read the oracle-sorted
    SmemIntv list plus, parallel to it, one int64 rbeg array per interval
    (the sample_ks occurrence expansion resolved through the sampled SA).
    The whole batch costs one device dispatch and one two-array pull;
    overflowed reads (per-read M-slot budget) fall back to the host
    oracle, an exhausted global walk budget falls back to host SA walks.
    """
    import jax

    from ..ops.seed_fused import F_PER_READ, R_PER_READ, seed_sa_fused
    from ..utils import metrics as _metrics
    from . import native_fm

    from .chain import sample_ks

    n = len(reads)
    if n == 0:
        return [], []
    dfm = _get_dfm(fm, mesh)
    place = _placer(mesh)
    qseq, qlen_j, B, L = _pad_batch(reads, place, dtype=np.int8)
    _metrics.count("device_seed_fused_batches")
    # the caps are per-batch TOTALS, not per-read; an rbeg overflow falls
    # back to host SA walks per interval, so a repeat-heavy batch stays
    # correct, just slower.  Walk lanes and the pulled tail array both
    # scale with R_PER_READ.
    flat_d, extra_d = seed_sa_fused(
        dfm, qseq, qlen_j,
        min_seed_len=opt.min_seed_len, split_len=opt.split_len,
        split_width=opt.split_width, max_mem_intv=int(opt.max_mem_intv),
        max_occ=opt.max_occ,
    )
    flat, extra = jax.device_get((flat_d, extra_d))
    flat = np.asarray(flat, dtype=np.int64)
    extra = np.asarray(extra, dtype=np.int64)
    R_cap = B * R_PER_READ
    meta = extra[R_cap + 2 :]
    n_m = meta & 0xFFFF
    ovf = (meta >> 16) != 0
    rbegs_flat = extra[:R_cap]
    total_rbegs = int(extra[R_cap])
    total_mems = int(extra[R_cap + 1])
    r_ovf = total_rbegs > R_cap
    mem_ovf = total_mems > B * F_PER_READ
    if r_ovf:
        # rbeg walk lanes exhausted: whole batch demotes to per-interval
        # host SA walks — make the degradation observable (ADVICE r04)
        _metrics.count("device_seed_fused_r_overflows")
    if mem_ovf:
        ovf[:] = True  # flat table truncated: host oracle for the batch
        _metrics.count("device_seed_fused_mem_overflows")

    # per-read row spans in the flat table + per-row walk offsets (the
    # device's exact layout, recomputed host-side)
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

    intervals_list: List[List[SmemIntv]] = []
    rbegs_list: List[List[np.ndarray]] = []
    for r in range(n):
        if ovf[r]:
            _metrics.count("device_seed_fused_fallbacks")
            intervals = collect_intv(opt, fm, reads[r])
            rb = [_host_sa(sample_ks(p, opt.max_occ)) for p in intervals]
            intervals_list.append(intervals)
            rbegs_list.append(rb)
            continue
        intervals = []
        rb = []
        for j in range(starts[r], starts[r] + n_m[r]):
            qbqe = int(flat[j, 3])
            intervals.append(
                SmemIntv(int(flat[j, 0]), int(flat[j, 1]), int(flat[j, 2]),
                         qbqe >> 16, qbqe & 0xFFFF)
            )
            if r_ovf:
                rb.append(_host_sa(sample_ks(intervals[-1], opt.max_occ)))
            else:
                rb.append(rbegs_flat[offs[j] : offs[j] + cnt[j]])
        intervals_list.append(intervals)
        rbegs_list.append(rb)
    return intervals_list, rbegs_list


def collect_intv_batch_device(
    opt: MemOptions, fm: FMIndex, reads: List[np.ndarray], mesh=None
) -> List[List[SmemIntv]]:
    """Three-round seeding on device; per read the same sorted interval
    list collect_intv produces.  mesh: shard the read batch across it."""
    import jax.numpy as jnp

    n = len(reads)
    if n == 0:
        return []
    dfm = _get_dfm(fm, mesh)
    place = _placer(mesh)
    qseq, qlen_j, B, L = _pad_batch(reads, place)
    qlen = np.zeros(B, dtype=np.int64)
    qlen[:n] = [len(r) for r in reads]
    per_read: List[List[SmemIntv]] = [[] for _ in range(n)]
    fallback = np.zeros(n, dtype=bool)

    def run_smem_wave(x_arr, min_arr, collect_into, lane_to_read):
        from ..utils import metrics as _metrics

        _metrics.count("device_seed_waves")
        ret, mx0, mx1, ms, mqb, mqe, mcnt, ovf = smem1a_batch(
            dfm, qseq, qlen_j, place(x_arr, np.int32),
            place(min_arr, np.int32),
        )
        ret = np.asarray(ret)
        mx0, mx1, ms = np.asarray(mx0), np.asarray(mx1), np.asarray(ms)
        mqb, mqe = np.asarray(mqb), np.asarray(mqe)
        mcnt, ovf = np.asarray(mcnt), np.asarray(ovf)
        for b in range(len(lane_to_read)):
            r = lane_to_read[b]
            if r < 0:
                continue
            if ovf[b]:
                fallback[r] = True
                continue
            # kernel emits in descending qb; the oracle reverses per start
            for k in range(int(mcnt[b]) - 1, -1, -1):
                if mqe[b, k] - mqb[b, k] >= opt.min_seed_len:
                    collect_into[r].append(
                        SmemIntv(int(mx0[b, k]), int(mx1[b, k]),
                                 int(ms[b, k]), int(mqb[b, k]),
                                 int(mqe[b, k]))
                    )
        return ret

    # ---- round 1: all SMEMs, cursor waves over start positions ----------
    lane_to_read = list(range(n)) + [-1] * (B - n)
    x = np.zeros(B, dtype=np.int64)
    ones = np.ones(B, dtype=np.int64)
    while True:
        active = x < qlen
        if not active.any():
            break
        ret = run_smem_wave(x, ones, per_read, lane_to_read)
        x = np.where(active, ret, x)

    # ---- round 2: re-seed long low-occurrence SMEMs from the middle -----
    jobs = []  # (read, start, min_intv)
    for r in range(n):
        if fallback[r]:
            continue
        for p in list(per_read[r]):
            if p.qlen >= opt.split_len and p.s <= opt.split_width:
                jobs.append((r, (p.qb + p.qe) >> 1, p.s + 1))
    if jobs:
        for lo in range(0, len(jobs), B):
            chunk = jobs[lo : lo + B]
            x2 = np.zeros(B, dtype=np.int64)
            mi2 = np.ones(B, dtype=np.int64)
            l2r = [-1] * B
            # round-2 lanes reuse the same padded qseq: lane b must carry
            # read chunk[b][0]'s row, so gather rows host-side
            rows = np.full((B, L), 4, dtype=np.int32)
            for b, (r, sx, mi) in enumerate(chunk):
                rows[b] = np.asarray(qseq[r])
                x2[b] = sx
                mi2[b] = mi
                l2r[b] = r
            qseq_r2 = place(rows)
            qlen2 = np.zeros(B, dtype=np.int64)
            for b, (r, _sx, _mi) in enumerate(chunk):
                qlen2[b] = qlen[r]
            ret, mx0, mx1, ms, mqb, mqe, mcnt, ovf = smem1a_batch(
                dfm, qseq_r2, place(qlen2, np.int32),
                place(x2, np.int32),
                place(mi2, np.int32),
            )
            mx0, mx1, ms = np.asarray(mx0), np.asarray(mx1), np.asarray(ms)
            mqb, mqe = np.asarray(mqb), np.asarray(mqe)
            mcnt, ovf = np.asarray(mcnt), np.asarray(ovf)
            for b, (r, _sx, _mi) in enumerate(chunk):
                if ovf[b]:
                    fallback[r] = True
                    continue
                for k in range(int(mcnt[b]) - 1, -1, -1):
                    if mqe[b, k] - mqb[b, k] >= opt.min_seed_len:
                        per_read[r].append(
                            SmemIntv(int(mx0[b, k]), int(mx1[b, k]),
                                     int(ms[b, k]), int(mqb[b, k]),
                                     int(mqe[b, k]))
                        )

    # ---- round 3: LAST-like strategy-1 cursor waves ---------------------
    if opt.max_mem_intv > 0:
        x = np.zeros(B, dtype=np.int64)
        while True:
            active = x < qlen
            if not active.any():
                break
            found, fx0, fx1, fs, _qb, fqe, nxt = seed_strategy1(
                dfm, qseq,
                place(qlen, np.int32),
                place(x, np.int32),
                opt.min_seed_len,
                int(opt.max_mem_intv),
            )
            found = np.asarray(found)
            fx0, fx1, fs = np.asarray(fx0), np.asarray(fx1), np.asarray(fs)
            fqe, nxt = np.asarray(fqe), np.asarray(nxt)
            for b in range(n):
                if active[b] and found[b] and fs[b] > 0:
                    per_read[b].append(
                        SmemIntv(int(fx0[b]), int(fx1[b]), int(fs[b]),
                                 int(x[b]), int(fqe[b]))
                    )
            x = np.where(active, nxt, x)

    # ---- assemble: sort by info = qb<<32|qe; host oracle for overflows --
    out: List[List[SmemIntv]] = []
    for r in range(n):
        if fallback[r]:
            out.append(collect_intv(opt, fm, reads[r]))
        else:
            mems = per_read[r]
            mems.sort(key=lambda m: (m.qb << 32) | m.qe)
            out.append(mems)
    return out
