"""ONE-dispatch device pipeline: seeding + SA walks + chaining + banded
extension for a whole read batch in a single jitted program.

The staged device path is host-orchestrated between stages: one fused
seed+SA dispatch, a host decode, a separate chain dispatch (or host
chaining), then per-wave extension dispatches with host-built payloads.
Every hop pays a host<->device round trip and re-uploads data the device
already holds.  Here the entire per-batch program runs on device:

  seed_sa_core   (ops/seed_fused.py, unchanged semantics)
    -> seed expansion  ([B, S] seeds by pure GATHERS from the walk table —
       no scatters: seed column s of read b is global walk ws[b]+s)
    -> chain_kernel    (ops/chain_tpu.py mem_chain + chain_flt, vmapped)
    -> chain2aln wave loop ([EXT] bwamem.c mem_chain2aln): per-read task
       cursors over (emit-rank, seed-len desc, idx desc)-ordered tasks,
       the contained-seed pruning against already-produced regions, and
       left/right ksw_extend2 extension with per-lane band-doubling
       retries — the extension kernel (ops/extend_tpu.py, early_exit
       row loop) runs embedded in the same program, so extension
       reference windows are gathered from the device-resident 2-bit pac
       and never cross the host<->device boundary.

The host pulls the packed seed tables (for per-read fallback decode) plus
fixed-shape region arrays; reads that overflow any fixed budget (M seed
slots, S seeds, C chains, R regions, T_cap reference window) or whose
length activates mem_flt_chained_seeds (>~700 bp: flt_chained_seeds stops
being a no-op — long-read path) flag themselves and fall back to the host
oracle, so output is bit-exact for every read (tests/test_pipeline_fused.py).

Anchors: the one-call batch contract this collapses into a single
dispatch is jnibwa.c:197-235 (mem_process_seqs, jnibwa.c:214); stage
semantics pin to [EXT] bwt.c/bwamem.c via the host oracles
engine/{seed,chain,extend}.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .chain_tpu import chain_kernel
from .extend_tpu import ksw_extend_batch
from .seed_fused import seed_sa_core

I32MAX = jnp.int32((1 << 31) - 1)

# per-read host-fallback causes, OR-ed into info[:, 1]
OVF_SEED_SLOTS = 1  # more than M intervals, or K SMEM snapshots a start
OVF_SEEDS = 2  # more than S seeds after occurrence expansion
OVF_CHAINS = 4  # more than C chains
OVF_LONG_READ = 8  # mem_flt_chained_seeds is live for this length
OVF_BATCH_TABLES = 16  # the batch's F_cap / R_cap tables overflowed
OVF_WINDOW = 32  # a chain's reference window exceeds T_cap
OVF_REGIONS = 64  # more than R regions
OVF_CAUSES = {
    "seed_slots": OVF_SEED_SLOTS, "seeds": OVF_SEEDS, "chains": OVF_CHAINS,
    "long_read": OVF_LONG_READ, "batch_tables": OVF_BATCH_TABLES,
    "window": OVF_WINDOW, "regions": OVF_REGIONS,
}


def _shl(arr, k, kmax: int):
    """Barrel left-shift each row of [B, W] by per-lane k (0..kmax),
    zero-filling: log2(kmax) masked static rolls — elementwise selects,
    no gathers (the plain take_along_axis form is ROADMAP item 3.6)."""
    B, W = arr.shape
    zeros = jnp.zeros_like(arr)
    bit = 0
    while (1 << bit) <= kmax:
        s = 1 << bit
        rolled = jnp.concatenate([arr[:, s:], zeros[:, :s]], axis=1)
        arr = jnp.where(((k >> bit) & 1)[:, None] != 0, rolled, arr)
        bit += 1
    return arr


def _win_codes(pac_rows, lo, anchor, T: int, l_pac: int):
    """[B, T] reference codes at doubled-domain positions lo..lo+T-1.

    Rather than [B, T] per-base pac lookups, the window is fetched as
    ~T/128 row-gathers of 32-byte (128-base) pac rows per lane, unpacked
    with vector shifts, then aligned with ONE
    per-lane row gather.  ``anchor`` (a position inside the window's
    valid span) picks the strand: windows never cross the forward/reverse
    boundary because the caller clamps to [rmax0, rmax1] ([EXT]
    bns_get_seq semantics); out-of-span cells are garbage the caller
    masks."""
    B = lo.shape[0]
    nrows = pac_rows.shape[0]
    R = T // 128 + 2
    rev = anchor >= l_pac
    fwd_lo = jnp.where(rev, 2 * l_pac - lo - T, lo)
    row0 = jnp.floor_divide(fwd_lo, 128)
    rows = jnp.clip(
        row0[:, None] + jnp.arange(R, dtype=row0.dtype)[None, :], 0,
        nrows - 1,
    )
    by = jnp.take(pac_rows, rows, axis=0).reshape(B, R * 32).astype(
        jnp.int32
    )
    c = jnp.stack(
        [(by >> 6) & 3, (by >> 4) & 3, (by >> 2) & 3, by & 3], axis=-1
    ).reshape(B, R * 128)
    off = (fwd_lo - row0 * 128).astype(jnp.int32)
    win_f = _shl(c, off, 127)[:, :T]
    return jnp.where(
        rev[:, None], 3 - win_f[:, ::-1], win_f
    )


def _max_gap(x, a, o_del, e_del, o_ins, e_ins, w):
    """cal_max_gap on int32 arrays (api/options.py max_gap, float trunc)."""
    f = x.astype(jnp.float32)
    l_del = jnp.trunc((f * a - o_del) / e_del + 1.0).astype(jnp.int32)
    l_ins = jnp.trunc((f * a - o_ins) / e_ins + 1.0).astype(jnp.int32)
    return jnp.minimum(
        jnp.maximum(jnp.maximum(l_del, l_ins), 1), jnp.int32(w << 1)
    )


def pipeline_fused_body(
    lines, L2, sa, pac_rows, ctg_end, ctg_off, ctg_alt, qseq, qlen, fcs_ok,
    mat, *,
    primary: int, seq_len: int, sa_intv: int, span: int, l_pac: int,
    min_seed_len: int, split_len: int, split_width: int, max_mem_intv: int,
    max_occ: int, M: int, R_cap: int, F_cap: int,
    S: int, C: int, R: int, T_cap: int,
    a: int, o_del: int, e_del: int, o_ins: int, e_ins: int, zdrop: int,
    pen_clip5: int, pen_clip3: int, w_opt: int, max_sc: int,
    max_chain_gap: int, min_chain_weight: int, max_chain_extend: int,
    mask_level: float, drop_ratio: float,
):
    B, L = qseq.shape
    cdt = L2.dtype
    CMAX = jnp.asarray(jnp.iinfo(cdt).max, cdt)
    lane = jnp.arange(B)
    qseq32 = qseq.astype(jnp.int32)

    core = seed_sa_core(
        lines, L2, sa, qseq, qlen, primary=primary, seq_len=seq_len,
        sa_intv=sa_intv, span=span, min_seed_len=min_seed_len,
        split_len=split_len, split_width=split_width,
        max_mem_intv=max_mem_intv, max_occ=max_occ, M=M, R_cap=R_cap,
        F_cap=F_cap,
    )
    flat, n, seed_ovf = core["flat"], core["n"], core["ovf"]
    qlen32 = qlen.astype(jnp.int32)

    # ---- per-read walk spans + [B, S] seed expansion (gathers only) -----
    cum0 = jnp.concatenate([jnp.zeros(1, core["cum"].dtype), core["cum"]])
    se_ = core["starts"]  # exclusive per-read flat-row starts [B] int32
    row_end = jnp.clip(se_ + n, 0, F_cap)
    ws_read = cum0[jnp.clip(se_, 0, F_cap)].astype(jnp.int32)
    wcount = cum0[row_end].astype(jnp.int32) - ws_read
    mem_ovf = core["total_mems"] > F_cap
    walk_ovf = core["total"] > R_cap

    scol = jnp.arange(S, dtype=jnp.int32)[None, :]
    g = ws_read[:, None] + scol  # [B, S] global walk index
    nseed = jnp.minimum(wcount, S)
    svalid = scol < nseed[:, None]
    seed_sovf = wcount > S
    gc = jnp.clip(g, 0, R_cap - 1)
    mi = jnp.clip(core["mem_idx"][gc], 0, F_cap - 1)
    qbqe = flat[mi, 3]
    sqb = jnp.where(svalid, (qbqe >> 16).astype(jnp.int32), 0)
    sqe = jnp.where(svalid, (qbqe & 0xFFFF).astype(jnp.int32), 0)
    slen = sqe - sqb
    srbeg = jnp.where(svalid, core["rbegs"][gc], 0)

    # ---- mem_chain + mem_chain_flt ---------------------------------------
    assign, crid, _weight, _nch, order, _kept, _first, emit, chovf = (
        chain_kernel(
            srbeg, sqb, slen, nseed, qlen32,
            ctg_end, ctg_alt,
            jnp.int32(w_opt), jnp.int32(max_chain_gap),
            jnp.int32(min_chain_weight), jnp.int32(min_seed_len),
            jnp.int32(max_chain_extend), jnp.float32(mask_level),
            jnp.float32(drop_ratio),
            S=S, C=C, l_pac=l_pac,
        )
    )

    # sorted-space -> slot inverse permutation; per-seed task eligibility
    rank_of_slot = jnp.argsort(order, axis=1).astype(jnp.int32)  # [B, C]
    emit_sorted = emit  # [B, C] bool in sorted space
    scc = jnp.clip(assign, 0, C - 1)
    s_rank = jnp.take_along_axis(rank_of_slot, scc, axis=1)
    s_emit = (
        jnp.take_along_axis(emit_sorted, s_rank, axis=1)
        & (assign >= 0)
        & svalid
    )
    # task order: (chain emit-rank asc, seed len desc, seed idx desc) —
    # exactly the host's per-chain srt walk from the largest seed down
    key = (s_rank * (L + 1) + (L - slen)) * S + (S - 1 - scol)
    key = jnp.where(s_emit, key, I32MAX)
    taskperm = jnp.argsort(key, axis=1).astype(jnp.int32)  # [B, S]
    ntask = s_emit.sum(axis=1).astype(jnp.int32)

    # ---- per-chain extension windows ([EXT] mem_chain2aln rmax + clamp) --
    mg_qb = _max_gap(sqb, a, o_del, e_del, o_ins, e_ins, w_opt)
    tail = qlen32[:, None] - sqe
    mg_tl = _max_gap(tail, a, o_del, e_del, o_ins, e_ins, w_opt)
    sb = srbeg - (sqb + mg_qb).astype(cdt)
    se2 = srbeg + slen.astype(cdt) + (tail + mg_tl).astype(cdt)
    r0_cols, r1_cols, fr_cols = [], [], []
    for c in range(C):
        mask = (assign == c) & svalid
        r0_cols.append(jnp.min(jnp.where(mask, sb, CMAX), axis=1))
        r1_cols.append(jnp.max(jnp.where(mask, se2, 0), axis=1))
        fidx = jnp.argmax(mask, axis=1)  # first seed (enumeration order)
        fr_cols.append(srbeg[lane, fidx])
    rmax0 = jnp.maximum(jnp.stack(r0_cols, axis=1), 0)
    rmax1 = jnp.minimum(jnp.stack(r1_cols, axis=1), 2 * l_pac)
    frbeg = jnp.stack(fr_cols, axis=1)  # [B, C] first-seed rbeg
    cross = (rmax0 < l_pac) & (l_pac < rmax1)
    first_fwd = frbeg < l_pac
    rmax1 = jnp.where(cross & first_fwd, l_pac, rmax1)
    rmax0 = jnp.where(cross & ~first_fwd, l_pac, rmax0)
    # clamp to the first seed's contig ([EXT] bns_fetch_seq)
    is_rev = frbeg >= l_pac
    fwd_mid = jnp.where(is_rev, 2 * l_pac - 1 - frbeg, frbeg)
    rid_c = jnp.searchsorted(
        ctg_end.astype(cdt), fwd_mid, side="right"
    ).astype(jnp.int32)
    ncl = jnp.clip(rid_c, 0, ctg_end.shape[0] - 1)
    far_beg = ctg_off.astype(cdt)[ncl]
    far_end = ctg_end.astype(cdt)[ncl]
    fb2 = jnp.where(is_rev, 2 * l_pac - far_end, far_beg)
    fe2 = jnp.where(is_rev, 2 * l_pac - far_beg, far_end)
    rmax0 = jnp.maximum(rmax0, fb2)
    rmax1 = jnp.minimum(rmax1, fe2)
    win_ovf_c = (rmax1 - rmax0) > T_cap

    # ---- chain2aln wave loop (lane-compaction ladder) -------------------
    # the loop is lockstep across lanes: one task per live read per wave.
    # Task counts are heavy-tailed (mean ~4, max ~S), so running the whole
    # batch to the slowest lane would pay full [B]-wide extension waves for
    # a handful of stragglers.  Instead each stage runs while more than
    # `floor` lanes are live, then the survivors (and their whole state)
    # compact into a 4x narrower stage — same program, smaller B — and the
    # final stage runs to empty.  Results scatter back by original lane.
    jq = jnp.arange(L, dtype=jnp.int32)[None, :]
    jt = jnp.arange(T_cap, dtype=jnp.int32)[None, :]
    rr = jnp.arange(R, dtype=jnp.int32)[None, :]
    th_of = lambda aw: (aw >> 1) + (aw >> 2)

    tb_full = dict(
        ntask=ntask, taskperm=taskperm, sqb=sqb, slen=slen, srbeg=srbeg,
        scc=scc, assign=assign, svalid=svalid, qseq32=qseq32,
        qrev32=qseq32[:, ::-1].copy(), qlen32=qlen32, rmax0=rmax0,
        rmax1=rmax1, crid=crid, win_ovf=win_ovf_c,
    )

    def _ext(qa, ta, ql_, tl_, h0_, w_, bonus):
        return ksw_extend_batch(
            qa, ta, ql_, tl_, h0_, w_,
            jnp.full_like(ql_, bonus), mat,
            o_del, e_del, o_ins, e_ins, zdrop, max_sc, early_exit=True,
        )

    def _ext_retry(qa, ta, ql_, tl_, h0_, bonus, act, prev0):
        """MAX_BAND_TRY=2 band-doubling: attempt at w, selective retry at
        2w for lanes whose score moved and max_off crossed the threshold
        (prev0 None -> attempt-0 'score != prev' is vacuously true: the
        left extension enters with score -1)."""
        w0 = jnp.full_like(ql_, w_opt)
        r1 = _ext(qa, ta, ql_, tl_, h0_, w0, bonus)
        moved = True if prev0 is None else (r1["score"] != prev0)
        retry = act & moved & (r1["max_off"] >= th_of(w0))

        def do_retry(_):
            w1 = jnp.where(retry, w0 << 1, w0)
            tl2 = jnp.where(retry, tl_, 0)
            ql2 = jnp.where(retry, ql_, 0)
            r2 = _ext(qa, ta, ql2, tl2, h0_, w1, bonus)
            return {k: jnp.where(retry, r2[k], r1[k]) for k in r1}

        res = jax.lax.cond(retry.any(), do_retry, lambda _: r1, None)
        aw = jnp.where(retry, w_opt << 1, w_opt)
        return res, aw

    def prune_current(tb, tc, alive, regs):
        (r_rb, r_re, r_qb, r_qe, _sc, _ts, r_w, _scov, r_sl0, _rid,
         nregs) = regs
        Bn = tc.shape[0]
        lane_n = jnp.arange(Bn)
        act = tc < tb["ntask"]
        si = jnp.take_along_axis(
            tb["taskperm"], jnp.clip(tc, 0, S - 1)[:, None], axis=1
        )[:, 0]
        sqb_t, slen_t, srbeg_t = tb["sqb"], tb["slen"], tb["srbeg"]
        s_qb = sqb_t[lane_n, si]
        s_len = slen_t[lane_n, si]
        s_rbeg = srbeg_t[lane_n, si]
        c = tb["scc"][lane_n, si]
        # contained in an existing region? ([EXT] chain2aln srt prune)
        pv = rr < nregs[:, None]
        box = (
            (s_rbeg[:, None] >= r_rb)
            & (s_rbeg[:, None] + s_len[:, None] <= r_re)
            & (s_qb[:, None] >= r_qb)
            & (s_qb[:, None] + s_len[:, None] <= r_qe)
        )
        lenok = (
            (s_len[:, None] - r_sl0).astype(jnp.float32)
            <= 0.1 * tb["qlen32"].astype(jnp.float32)[:, None]
        )
        qd1 = s_qb[:, None] - r_qb
        rd1 = jnp.clip(s_rbeg[:, None] - r_rb, -(1 << 30), 1 << 30).astype(
            jnp.int32
        )
        w1 = jnp.minimum(
            _max_gap(jnp.minimum(qd1, rd1), a, o_del, e_del, o_ins, e_ins,
                     w_opt),
            r_w,
        )
        chk1 = (qd1 - rd1 < w1) & (rd1 - qd1 < w1)
        qd2 = r_qe - (s_qb[:, None] + s_len[:, None])
        rd2 = jnp.clip(
            r_re - (s_rbeg[:, None] + s_len[:, None]).astype(cdt),
            -(1 << 30), 1 << 30,
        ).astype(jnp.int32)
        w2 = jnp.minimum(
            _max_gap(jnp.minimum(qd2, rd2), a, o_del, e_del, o_ins, e_ins,
                     w_opt),
            r_w,
        )
        chk2 = (qd2 - rd2 < w2) & (rd2 - qd2 < w2)
        contained = (pv & box & lenok & (chk1 | chk2)).any(axis=1)
        # same-chain later-srt seed suggesting a different alignment?
        samec = (tb["assign"] == c[:, None]) & tb["svalid"] & alive
        after = (slen_t > s_len[:, None]) | (
            (slen_t == s_len[:, None]) & (scol > si[:, None])
        )
        big = slen_t.astype(jnp.float32) >= s_len.astype(jnp.float32)[
            :, None
        ] * jnp.float32(0.95)
        dq = jnp.clip(
            srbeg_t - s_rbeg[:, None], -(1 << 30), 1 << 30
        ).astype(jnp.int32)
        c1 = (
            (s_qb[:, None] <= sqb_t)
            & (s_qb[:, None] + s_len[:, None] - sqb_t
               >= (s_len[:, None] >> 2))
            & (sqb_t - s_qb[:, None] != dq)
        )
        c2 = (
            (sqb_t <= s_qb[:, None])
            & (sqb_t + slen_t - s_qb[:, None] >= (s_len[:, None] >> 2))
            & (s_qb[:, None] - sqb_t != -dq)
        )
        diff = (samec & after & big & (c1 | c2)).any(axis=1)
        pruned = act & contained & ~diff
        return act, si, c, pruned

    def outer_body(tb, st):
        tc, alive, regs, povf = st
        Bn = tc.shape[0]
        lane_n = jnp.arange(Bn)

        # advance each lane's cursor past pruned tasks (marks them dead)
        def adv_cond(st2):
            return st2[2].any()

        def adv_body(st2):
            tc2, alive2, pr = st2
            si = jnp.take_along_axis(
                tb["taskperm"], jnp.clip(tc2, 0, S - 1)[:, None], axis=1
            )[:, 0]
            kill = (scol == si[:, None]) & pr[:, None]
            alive2 = alive2 & ~kill
            tc2 = tc2 + pr.astype(jnp.int32)
            _, _, _, pr2 = prune_current(tb, tc2, alive2, regs)
            return tc2, alive2, pr2

        _, _, _, pr0 = prune_current(tb, tc, alive, regs)
        tc, alive, _ = jax.lax.while_loop(
            adv_cond, adv_body, (tc, alive, pr0)
        )

        act, si, c, _ = prune_current(tb, tc, alive, regs)
        s_qb = tb["sqb"][lane_n, si]
        s_len = tb["slen"][lane_n, si]
        s_qe = s_qb + s_len
        s_rbeg = tb["srbeg"][lane_n, si]
        r0c = tb["rmax0"][lane_n, c]
        r1c = tb["rmax1"][lane_n, c]
        qlen_n = tb["qlen32"]
        povf = povf | jnp.where(
            act & tb["win_ovf"][lane_n, c], OVF_WINDOW, 0
        )

        # ---- left extension (reversed prefix) ---------------------------
        has_l = act & (s_qb > 0)
        ql_l = jnp.where(has_l, s_qb, 0)
        tl_l = jnp.where(
            has_l, jnp.clip((s_rbeg - r0c).astype(jnp.int32), 0, T_cap), 0
        )
        # qa_l[j] = qseq[s_qb-1-j]: static row reverse + barrel shift
        qa_l = _shl(tb["qrev32"], L - s_qb, L)
        qa_l = jnp.where(jq < ql_l[:, None], qa_l, 0)
        win_l = _win_codes(
            pac_rows, s_rbeg - T_cap, s_rbeg - 1, T_cap, l_pac
        )
        ta_l = jnp.where(jt < tl_l[:, None], win_l[:, ::-1], 0)
        h0 = s_len * jnp.int32(a)
        res_l, aw0 = _ext_retry(
            qa_l, ta_l, ql_l, tl_l, h0, pen_clip5, has_l, None
        )
        g_ok = (res_l["gscore"] <= 0) | (
            res_l["gscore"] <= res_l["score"] - pen_clip5
        )
        sc_left = jnp.where(has_l, res_l["score"], h0)
        qb_f = jnp.where(
            has_l, jnp.where(g_ok, s_qb - res_l["qle"], 0), 0
        )
        rb_f = jnp.where(
            has_l,
            s_rbeg
            - jnp.where(g_ok, res_l["tle"], res_l["gtle"]).astype(cdt),
            s_rbeg,
        )
        truesc = jnp.where(
            has_l, jnp.where(g_ok, sc_left, res_l["gscore"]), h0
        )
        aw0 = jnp.where(has_l, aw0, w_opt)

        # ---- right extension --------------------------------------------
        has_r = act & (s_qe != qlen_n)
        ql_r = jnp.where(has_r, qlen_n - s_qe, 0)
        re_off = s_rbeg + s_len.astype(cdt)
        tl_r = jnp.where(
            has_r, jnp.clip((r1c - re_off).astype(jnp.int32), 0, T_cap), 0
        )
        qa_r = _shl(tb["qseq32"], s_qe, L)
        qa_r = jnp.where(jq < ql_r[:, None], qa_r, 0)
        win_r = _win_codes(pac_rows, re_off, re_off, T_cap, l_pac)
        ta_r = jnp.where(jt < tl_r[:, None], win_r, 0)
        sc0 = sc_left
        res_r, aw1 = _ext_retry(
            qa_r, ta_r, ql_r, tl_r, sc0, pen_clip3, has_r, sc0
        )
        g_ok_r = (res_r["gscore"] <= 0) | (
            res_r["gscore"] <= res_r["score"] - pen_clip3
        )
        score_f = jnp.where(has_r, res_r["score"], sc_left)
        qe_f = jnp.where(
            has_r, jnp.where(g_ok_r, s_qe + res_r["qle"], qlen_n), qlen_n
        )
        re_f = jnp.where(
            has_r,
            re_off
            + jnp.where(g_ok_r, res_r["tle"], res_r["gtle"]).astype(cdt),
            re_off,
        )
        truesc = jnp.where(
            has_r,
            truesc + jnp.where(
                g_ok_r, score_f - sc0, res_r["gscore"] - sc0
            ),
            truesc,
        )
        aw1 = jnp.where(has_r, aw1, w_opt)

        # ---- finalize the region ----------------------------------------
        inbox = (
            (tb["assign"] == c[:, None]) & tb["svalid"]
            & (tb["sqb"] >= qb_f[:, None])
            & (tb["sqb"] + tb["slen"] <= qe_f[:, None])
            & (tb["srbeg"] >= rb_f[:, None])
            & (tb["srbeg"] + tb["slen"].astype(cdt) <= re_f[:, None])
        )
        seedcov = jnp.where(inbox, tb["slen"], 0).sum(axis=1)
        w_f = jnp.maximum(aw0, aw1)
        rid_f = tb["crid"][lane_n, c]

        (r_rb, r_re, r_qb, r_qe, r_sc, r_ts, r_w, r_scov, r_sl0, r_rid,
         nregs) = regs
        sel = (rr == jnp.clip(nregs, 0, R - 1)[:, None]) & act[:, None]
        put = lambda arr, v: jnp.where(
            sel, v[:, None].astype(arr.dtype), arr
        )
        regs = (
            put(r_rb, rb_f), put(r_re, re_f), put(r_qb, qb_f),
            put(r_qe, qe_f), put(r_sc, score_f), put(r_ts, truesc),
            put(r_w, w_f), put(r_scov, seedcov), put(r_sl0, s_len),
            put(r_rid, rid_f),
            nregs + act.astype(jnp.int32),
        )
        povf = povf | jnp.where(act & (nregs >= R), OVF_REGIONS, 0)
        tc = tc + act.astype(jnp.int32)
        return tc, alive, regs, povf

    def run_stage(tb, st, floor):
        def cond(s):
            return (s[0] < tb["ntask"]).sum() > floor

        return jax.lax.while_loop(cond, lambda s: outer_body(tb, s), st)

    def compact(tb, st, abs_idx, Bn_new):
        """Gather the live lanes (plus idle fillers) into a narrower
        stage; the previous stage's floor guarantees live <= Bn_new."""
        tc, alive, regs, povf = st
        live = tc < tb["ntask"]
        sel = jnp.argsort(jnp.where(live, 0, 1), stable=True)[:Bn_new]
        tb2 = {k: v[sel] for k, v in tb.items()}
        tb2["ntask"] = jnp.where(live[sel], tb2["ntask"], 0)
        st2 = (
            tc[sel], alive[sel], tuple(r[sel] for r in regs), povf[sel]
        )
        return tb2, st2, abs_idx[sel]

    zR = jnp.zeros((B, R), jnp.int32)
    zRc = jnp.zeros((B, R), cdt)
    regs0 = (
        zRc, zRc, zR, zR, zR, zR, zR, zR, zR, zR, jnp.zeros(B, jnp.int32)
    )
    bit = lambda cond, b: jnp.where(cond, jnp.int32(b), jnp.int32(0))
    povf0 = (
        bit(seed_ovf, OVF_SEED_SLOTS) | bit(seed_sovf, OVF_SEEDS)
        | bit(chovf, OVF_CHAINS) | bit(~fcs_ok, OVF_LONG_READ)
        | bit(jnp.broadcast_to(mem_ovf | walk_ovf, seed_ovf.shape),
              OVF_BATCH_TABLES)
    )
    # skip overflowed lanes
    tc0 = jnp.where(povf0 != 0, ntask, jnp.zeros(B, jnp.int32))
    st = (tc0, jnp.ones((B, S), bool), regs0, povf0)

    sizes = [B]
    while sizes[-1] > 128:
        nxt = max(sizes[-1] // 4, 128)
        if nxt == sizes[-1]:
            break
        sizes.append(nxt)
    tb, abs_idx = tb_full, jnp.arange(B, dtype=jnp.int32)
    stage_outs = []
    for si_, Bn in enumerate(sizes):
        floor = sizes[si_ + 1] if si_ + 1 < len(sizes) else 0
        st = run_stage(tb, st, floor)
        stage_outs.append((abs_idx, st))
        if si_ + 1 < len(sizes):
            tb, st, abs_idx = compact(tb, st, abs_idx, sizes[si_ + 1])

    # merge narrower stages back into the full-B arrays (later stages
    # win; filler lanes re-write their own unchanged values)
    _, (tc_f, _al, regs_fin, povf) = stage_outs[0], stage_outs[0][1]
    regs_fin, povf = list(regs_fin), povf
    for abs_k, st_k in stage_outs[1:]:
        _tc, _al2, regs_k, povf_k = st_k
        for i_ in range(len(regs_fin)):
            regs_fin[i_] = regs_fin[i_].at[abs_k].set(regs_k[i_])
        povf = povf.at[abs_k].set(povf_k)
    regs_fin = tuple(regs_fin)

    # ---- pack -----------------------------------------------------------
    (r_rb, r_re, r_qb, r_qe, r_sc, r_ts, r_w, r_scov, r_sl0, r_rid,
     nregs) = regs_fin
    meta = (n + (seed_ovf.astype(jnp.int32) << 16)).astype(cdt)
    extra = jnp.concatenate(
        [
            core["rbegs"], core["total"][None].astype(cdt),
            core["total_mems"][None].astype(cdt), meta,
        ]
    )
    regs_c = jnp.stack([r_rb, r_re], axis=2)  # [B, R, 2] cdt
    regs_i = jnp.stack(
        [r_qb, r_qe, r_sc, r_ts, r_w, r_scov, r_sl0, r_rid], axis=2
    )  # [B, R, 8] int32
    info = jnp.stack([nregs, povf], axis=1)  # [B, 2] int32
    return flat, extra, regs_c, regs_i, info


pipeline_fused_kernel = partial(
    jax.jit,
    static_argnames=(
        "primary", "seq_len", "sa_intv", "span", "l_pac", "min_seed_len",
        "split_len", "split_width", "max_mem_intv", "max_occ", "M",
        "R_cap", "F_cap", "S", "C", "R", "T_cap", "a", "o_del", "e_del",
        "o_ins", "e_ins", "zdrop", "pen_clip5", "pen_clip3", "w_opt",
        "max_sc", "max_chain_gap", "min_chain_weight", "max_chain_extend",
        "mask_level", "drop_ratio",
    ),
)(pipeline_fused_body)
