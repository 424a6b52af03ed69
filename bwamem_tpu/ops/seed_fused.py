"""Fused device seeding: all three SMEM rounds + occurrence expansion +
sampled-SA walks in ONE jitted dispatch.

The staged device path (engine/seed_device.py::collect_intv_batch_device)
drives seeding as host-orchestrated waves — one smem1a/strategy1 dispatch
per cursor wave, with EIGHT array pulls to the host per wave, which
serializes the device behind the host.  Here the cursor loops themselves run on device
(``lax.while_loop`` around the smem1a/strategy1 bodies), the emitted
intervals accumulate in fixed [B, M] slot arrays in device memory, the bwa
``sample_ks`` occurrence expansion and the sampled-SA compaction-ladder
walks run in the same program, and the host pulls exactly TWO packed
arrays per batch.

Semantics are pinned to the host pipeline: the interval multiset,
insertion order (round-1 waves reversed-per-start, round-2 jobs in mem
order, round-3 hits in cursor order) and the final stable sort by
(qb, qe) reproduce engine/seed.py::collect_intv exactly; rbegs reproduce
engine/chain.py::sample_ks + FMIndex.sa_lookup.  Reads that overflow the
M-slot budget flag overflow and fall back to the host oracle (rare).

Anchors: [EXT] bwt.c bwt_smem1a / bwt_seed_strategy1 / bwt_sa, reached
from mem_process_seqs (jnibwa.c:214); the one-call batch contract this
mirrors is jnibwa.c:197-235.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .fmindex_tpu import DeviceFMIndex, sa_lookup_body
from .seed_tpu import strategy1_body
from .smem_tpu import K_SLOTS, smem1a_body

M_SLOTS = 64  # per-read interval budget (overflow -> host oracle)
# per-read shares of the batch-total tables: R_cap = B * R_PER_READ
# resolved occurrences (rbegs), F_cap = B * F_PER_READ intervals.  A batch
# that overflows either demotes as a whole, so these sit well above the
# means on a repeat-rich 32 Mbp genome (~18 rbegs and ~9 intervals a read)
R_PER_READ = 64
F_PER_READ = 32


def _append_wave(accs, n, ovf, wave, wcnt, active, min_seed_len, M):
    """Append one smem wave's emissions (reversed slot order, length
    filtered) into the [B, M] accumulators.  accs/wave: tuples of
    (x0, x1, s, qb, qe) arrays; returns (accs, n, ovf)."""
    B, K = wave[3].shape
    j = jnp.arange(K)[None, :]
    k_src = wcnt[:, None] - 1 - j  # reversed: oracle appends ascending qb
    valid = active[:, None] & (k_src >= 0)
    k_c = jnp.clip(k_src, 0, K - 1)
    vqb = jnp.take_along_axis(wave[3], k_c, axis=1)
    vqe = jnp.take_along_axis(wave[4], k_c, axis=1)
    keep = valid & (vqe - vqb >= min_seed_len)
    dest = n[:, None] + jnp.cumsum(keep.astype(jnp.int32), axis=1) - keep
    dest = jnp.where(keep & (dest < M), dest, M)  # drop OOB
    # one-hot compaction: each dest slot receives at most one kept element,
    # so a masked [B, K, M] sum replaces 5 scatters
    eq = dest[:, :, None] == jnp.arange(M)[None, None, :]  # [B, K, M]
    hit = eq.any(axis=1)  # [B, M]
    out = tuple(
        jnp.where(
            hit,
            (jnp.take_along_axis(w, k_c, axis=1)[:, :, None]
             * eq.astype(acc.dtype)).sum(axis=1, dtype=acc.dtype),
            acc,
        )
        for acc, w in zip(accs, wave)
    )
    n_new = n + keep.sum(axis=1, dtype=jnp.int32)
    ovf = ovf | (n_new > M)
    return out, jnp.minimum(n_new, M), ovf


def seed_sa_core(
    lines, L2, sa, qseq, qlen, *, primary: int, seq_len: int, sa_intv: int,
    span: int, min_seed_len: int, split_len: int, split_width: int,
    max_mem_intv: int, max_occ: int, M: int, R_cap: int, F_cap: int,
):
    """Device seeding core; returns every intermediate the fused pipeline
    (ops/pipeline_fused.py) consumes in addition to the packed outputs."""
    qseq = qseq.astype(jnp.int32)  # uploaded as int8 (4x fewer link bytes)
    B, L = qseq.shape
    assert L < (1 << 16), "qb/qe pack into 16 bits each"
    cdt = L2.dtype
    lane = jnp.arange(B)
    zMc = jnp.zeros((B, M), cdt)
    zM = jnp.zeros((B, M), jnp.int32)
    accs = (zMc, zMc, zM, zM, zM)  # x0, x1, s, qb, qe
    n = jnp.zeros(B, jnp.int32)
    ovf = jnp.zeros(B, bool)
    ones = jnp.ones(B, jnp.int32)

    def smem(x, min_intv):
        return smem1a_body(
            lines, L2, qseq, qlen, x, min_intv, primary, seq_len, span
        )

    # ---- round 1: all SMEMs, cursor waves over start positions ----------
    # Lane-compaction ladder: cursor waves per read are heavy-tailed
    # (mean ~2, max ~8 on 150bp reads), and every lockstep wave pays the
    # full batch width for the stragglers.  Each stage runs while more
    # than `floor` lanes still have cursor work, then the live lanes
    # (with their accumulators and read rows) compact into a 4x narrower
    # stage; results scatter back by original lane.  Same per-lane wave
    # sequence — bit-identical output.
    def r1_stage(tb, st, floor):
        qseq_s, qlen_s = tb["qseq"], tb["qlen"]
        ones_s = jnp.ones(qlen_s.shape[0], jnp.int32)

        def cond(st2):
            return (st2[0] < qlen_s).sum() > floor

        def body(st2):
            x, accs2, n2, ovf2 = st2
            active = x < qlen_s
            ret, wx0, wx1, ws, wqb, wqe, wcnt, wovf = smem_t(
                qseq_s, qlen_s, x, ones_s
            )
            ovf2 = ovf2 | (active & wovf)
            accs2, n2, ovf2 = _append_wave(
                accs2, n2, ovf2, (wx0, wx1, ws, wqb, wqe), wcnt, active,
                min_seed_len, M,
            )
            return jnp.where(active, ret, x), accs2, n2, ovf2

        return jax.lax.while_loop(cond, body, st)

    def smem_t(qs, ql, x, mi):
        ret, wx0, wx1, ws, wqb, wqe, wcnt, wovf = smem1a_body(
            lines, L2, qs, ql, x, mi, primary, seq_len, span
        )
        return ret, wx0, wx1, ws, wqb, wqe, wcnt, wovf

    x0c = jnp.zeros(B, jnp.int32)
    sizes = [B]
    while sizes[-1] > 256:
        nxt = max(sizes[-1] // 4, 256)
        if nxt == sizes[-1]:
            break
        sizes.append(nxt)
    tb = dict(qseq=qseq, qlen=qlen)
    st = (x0c, accs, n, ovf)
    abs_idx = jnp.arange(B, dtype=jnp.int32)
    stage_outs = []
    for si_, Bn in enumerate(sizes):
        floor = sizes[si_ + 1] if si_ + 1 < len(sizes) else 0
        st = r1_stage(tb, st, floor)
        stage_outs.append((abs_idx, st))
        if si_ + 1 < len(sizes):
            x_c, accs_c, n_c, ovf_c = st
            live = x_c < tb["qlen"]
            sel = jnp.argsort(jnp.where(live, 0, 1), stable=True)[
                : sizes[si_ + 1]
            ]
            tb = {k: v[sel] for k, v in tb.items()}
            st = (
                x_c[sel], tuple(a[sel] for a in accs_c), n_c[sel],
                ovf_c[sel],
            )
            abs_idx = abs_idx[sel]
    _, (x_f, accs, n, ovf) = stage_outs[0][0], stage_outs[0][1]
    accs = list(accs)
    for abs_k, (x_k, accs_k, n_k, ovf_k) in stage_outs[1:]:
        for i_ in range(len(accs)):
            accs[i_] = accs[i_].at[abs_k].set(accs_k[i_])
        n = n.at[abs_k].set(n_k)
        ovf = ovf.at[abs_k].set(ovf_k)
    accs = tuple(accs)

    # ---- round 2: re-seed long low-occurrence SMEMs from the middle -----
    n1 = n  # snapshot: jobs come from round-1 mems only
    marr = jnp.arange(M)[None, :]

    def qual_of(accs):
        _, _, ms, mqb, mqe = accs
        return (
            (marr < n1[:, None])
            & (mqe - mqb >= split_len)
            & (ms <= split_width)
        )

    def find_next(jc, accs):
        cand = qual_of(accs) & (marr >= jc[:, None])
        return cand.any(axis=1), jnp.argmax(cand, axis=1).astype(jnp.int32)

    def r2_cond(st):
        jc, accs, _, _ = st
        has, _ = find_next(jc, accs)
        return has.any()

    def r2_body(st):
        jc, accs, n, ovf = st
        has, idx = find_next(jc, accs)
        _, _, ms, mqb, mqe = accs
        start = (mqb[lane, idx] + mqe[lane, idx]) >> 1
        mintv = ms[lane, idx] + 1
        x_in = jnp.where(has, start, qlen)  # idle lanes: x >= qlen
        _ret, wx0, wx1, ws, wqb, wqe, wcnt, wovf = smem(x_in, mintv)
        ovf = ovf | (has & wovf)
        accs, n, ovf = _append_wave(
            accs, n, ovf, (wx0, wx1, ws, wqb, wqe), wcnt, has,
            min_seed_len, M,
        )
        return jnp.where(has, idx + 1, jc), accs, n, ovf

    jc0 = jnp.zeros(B, jnp.int32)
    _, accs, n, ovf = jax.lax.while_loop(
        r2_cond, r2_body, (jc0, accs, n, ovf)
    )

    # ---- round 3: LAST-like strategy-1 cursor waves ---------------------
    if max_mem_intv > 0:

        def r3_cond(st):
            return (st[0] < qlen).any()

        def r3_body(st):
            x, accs, n, ovf = st
            active = x < qlen
            found, fx0, fx1, fs, _qb, fqe, nxt = strategy1_body(
                lines, L2, qseq, qlen, x, primary, seq_len, span,
                min_seed_len, max_mem_intv,
            )
            app = active & found & (fs > 0)
            dest = jnp.where(app & (n < M), n, M)
            sel = marr == dest[:, None]  # dest == M never matches: drop
            put = lambda r, v: jnp.where(sel, v.astype(r.dtype)[:, None], r)
            ax0, ax1, as_, aqb, aqe = accs
            accs = (
                put(ax0, fx0),
                put(ax1, fx1),
                put(as_, fs),
                put(aqb, x.astype(jnp.int32)),
                put(aqe, fqe),
            )
            ovf = ovf | (app & (n >= M))
            n = n + app.astype(jnp.int32)
            return jnp.where(active, nxt, x), accs, n, ovf

        x, accs, n, ovf = jax.lax.while_loop(
            r3_cond, r3_body, (x0c, accs, n, ovf)
        )

    # ---- stable sort per read by (qb, qe) — the oracle's final order ----
    ax0, ax1, as_, aqb, aqe = accs
    key = aqb * jnp.int32(L + 1) + aqe  # == (qb<<32|qe) ordering for qe<=L
    key = jnp.where(marr < n[:, None], key, jnp.int32(2**31 - 1))
    order = jnp.argsort(key, axis=1, stable=True)
    g = lambda r: jnp.take_along_axis(r, order, axis=1)
    ax0, ax1, as_, aqb, aqe = g(ax0), g(ax1), g(as_), g(aqb), g(aqe)

    # ---- compact live mems into a flat [F_cap, 4] table -----------------
    # rows in (lane, sorted-mem) order: x0 | x1 | s | qb<<16|qe.  The
    # host recomputes the same layout from the per-read counts.
    starts = (jnp.cumsum(n) - n).astype(jnp.int32)  # exclusive per-lane
    total_mems = n.sum()
    live = marr < n[:, None]
    dest = jnp.where(live, starts[:, None] + marr, F_cap).reshape(-1)
    qbqe = (aqb.astype(cdt) << 16) | aqe.astype(cdt)
    flat = jnp.zeros((F_cap, 4), cdt)
    for c, arr in enumerate((ax0, ax1, as_.astype(cdt), qbqe)):
        flat = flat.at[dest, c].set(arr.reshape(-1), mode="drop")

    # ---- bwa sample_ks occurrence expansion + SA walks ------------------
    rowix = jnp.arange(F_cap)
    live_f = rowix < jnp.minimum(total_mems, F_cap)
    s_f = flat[:, 2]
    cnt_f = jnp.where(live_f, jnp.minimum(s_f, max_occ), 0).astype(jnp.int32)
    step_f = jnp.where(s_f > max_occ, s_f // max_occ, 1)
    cum = jnp.cumsum(cnt_f)
    total = cum[-1]
    gidx = jnp.arange(R_cap)
    mem_idx = jnp.searchsorted(cum, gidx, side="right")
    mi = jnp.clip(mem_idx, 0, F_cap - 1)
    prev = jnp.where(mem_idx > 0, cum[jnp.clip(mem_idx - 1, 0, F_cap - 1)], 0)
    t = (gidx - prev).astype(cdt)
    ks = flat[mi, 0] + step_f[mi] * t
    ks = jnp.where(gidx < total, ks, 0)
    rbegs = sa_lookup_body(
        lines, L2, sa, ks, primary, seq_len, sa_intv, span
    )
    return dict(
        flat=flat, n=n, ovf=ovf, starts=starts, total_mems=total_mems,
        cnt_f=cnt_f, cum=cum, total=total, mem_idx=mem_idx, rbegs=rbegs,
        # per-read sorted interval views (pre-compaction), for frac_rep
        s_sorted=as_, qb_sorted=aqb, qe_sorted=aqe,
    )


def seed_sa_fused_body(
    lines, L2, sa, qseq, qlen, *, primary: int, seq_len: int, sa_intv: int,
    span: int, min_seed_len: int, split_len: int, split_width: int,
    max_mem_intv: int, max_occ: int, M: int, R_cap: int, F_cap: int,
):
    core = seed_sa_core(
        lines, L2, sa, qseq, qlen, primary=primary, seq_len=seq_len,
        sa_intv=sa_intv, span=span, min_seed_len=min_seed_len,
        split_len=split_len, split_width=split_width,
        max_mem_intv=max_mem_intv, max_occ=max_occ, M=M, R_cap=R_cap,
        F_cap=F_cap,
    )
    cdt = L2.dtype
    n, ovf = core["n"], core["ovf"]
    # ---- pack: flat [F_cap, 4] + ONE tail vector [R_cap + 2 + B] --------
    # (rbegs | total_rbegs | total_mems | per-read n+ovf meta): the whole
    # batch decodes from exactly TWO pulled arrays
    meta = (n + (ovf.astype(jnp.int32) << 16)).astype(cdt)
    extra = jnp.concatenate(
        [
            core["rbegs"], core["total"][None].astype(cdt),
            core["total_mems"][None].astype(cdt), meta,
        ]
    )
    return core["flat"], extra


_seed_sa_fused_kernel = partial(
    jax.jit,
    static_argnames=(
        "primary", "seq_len", "sa_intv", "span", "min_seed_len",
        "split_len", "split_width", "max_mem_intv", "max_occ", "M",
        "R_cap", "F_cap",
    ),
)(seed_sa_fused_body)


def seed_sa_fused(
    dfm: DeviceFMIndex, qseq, qlen, *, min_seed_len: int, split_len: int,
    split_width: int, max_mem_intv: int, max_occ: int,
    M: int = M_SLOTS, r_per_read: int = R_PER_READ,
    f_per_read: int = F_PER_READ,
):
    """One-dispatch seeding+SA for a padded [B, L] int8 batch.

    Returns (flat [F_cap, 4], extra [R_cap + 2 + B]) device arrays; see
    engine/seed_device.py::collect_intv_rbegs_batch_device for the decode.
    """
    B = qseq.shape[0]
    R_cap = B * r_per_read
    F_cap = B * f_per_read
    with dfm.ctx():
        return _seed_sa_fused_kernel(
            dfm.lines, dfm.L2, dfm.sa, qseq, qlen,
            primary=dfm.primary, seq_len=dfm.seq_len, sa_intv=dfm.sa_intv,
            span=dfm.span, min_seed_len=min_seed_len, split_len=split_len,
            split_width=split_width, max_mem_intv=max_mem_intv,
            max_occ=max_occ, M=M, R_cap=R_cap, F_cap=F_cap,
        )
