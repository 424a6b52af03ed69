"""Full bwt_smem1a SMEM enumeration on device ([EXT] bwt.c bwt_smem1a).

Hot loop #1 of the reference engine is the memory-latency-bound Occ chain
of SMEM seeding (SURVEY.md section 3.3).  The host oracle
(engine/seed.py::smem1a) walks one read position at a time with
data-dependent interval lists; here the same control flow runs as a
lockstep lane batch — one lane per (read, start position) — with the
branchy bookkeeping expressed as masked fixed-shape state:

  * forward pass: a ``lax.while_loop`` advancing every lane one base per
    tick — ONE fused occ-line gather of [2B] rows per tick
    (ops/fmindex_tpu.py fused-line layout) — recording an interval snapshot
    whenever a lane's interval size changes, into a fixed [B, K] slot
    array;
  * backward pass: a ``lax.while_loop`` over backward positions whose
    body extends ALL K prev slots in ONE flattened [2*B*K]-row gather,
    then replays the oracle's sequential curr/emit semantics
    (first-dying-slot emission, size-dedup) as a pure-vector
    ``lax.fori_loop`` over the precomputed slot results — no gathers
    inside the slot scan.

Lanes whose interval count exceeds K flag overflow and fall back to the
host oracle read-by-read (rare at K=128; at K=64 1% of the 150 bp reads
of a repeat-rich 64 Mbp genome overflowed, at K=24 6% of a 2 Mbp one).

Bit-exact against engine/seed.py::collect_intv (tests/test_smem_tpu.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .fmindex_tpu import DeviceFMIndex, _extend_core, _select_col

K_SLOTS = 128  # max forward interval snapshots / SMEMs per start


def smem1a_body(
    lines, L2, qseq, qlen, x, min_intv, primary: int, seq_len: int, span: int
):
    """One bwt_smem1a call per lane (max_intv == 0 regime: rounds 1 and 2).

    Plain traced body — callable from inside larger jitted programs (the
    fused seeding step, ops/seed_fused.py); smem1a_batch_kernel is the
    standalone jitted wrapper.

    qseq [B, L] int32 codes (4 = N), x [B] start positions, min_intv [B].
    Lanes with q[x] > 3 or x >= qlen produce nothing and ret = x + 1.

    Returns: ret [B], mems (x0, x1, s, qb, qe) each [B, K] in the oracle's
    pre-reverse order (descending qb), m_cnt [B], overflow [B] bool.
    """
    B, L = qseq.shape
    cdt = L2.dtype
    lane = jnp.arange(B)
    c0 = qseq[lane, jnp.clip(x, 0, L - 1)]
    bad0 = (c0 > 3) | (x >= qlen)
    cc0 = jnp.clip(c0, 0, 3)
    ik_x0 = L2[cc0] + 1
    ik_x1 = L2[3 - cc0] + 1
    ik_s = (L2[cc0 + 1] - L2[cc0]).astype(jnp.int32)
    ik_info = (x + 1).astype(jnp.int32)

    zK = jnp.zeros((B, K_SLOTS), jnp.int32)
    zKc = jnp.zeros((B, K_SLOTS), cdt)
    z = jnp.zeros(B, jnp.int32)

    def ext(x0, x1, s, is_back):
        return _extend_core(
            lines, L2, x0, x1, s, primary, seq_len, span, is_back
        )

    # ---------------- forward pass: record snapshots on size change -------
    def fwd_cond(st):
        return st[1].any()

    def fwd_body(st):
        (t, alive, x0, x1, s, info, rx0, rx1, rs, rinfo, cnt, ret, ovf) = st
        pos = x + 1 + t
        in_len = pos < qlen
        c = qseq[lane, jnp.clip(pos, 0, L - 1)]
        stop_a = alive & (~in_len | (c > 3))  # N/boundary: append ik, stop
        nx0, nx1, nsz = ext(x0, x1, s, is_back=False)
        ci = 3 - jnp.clip(c, 0, 3)
        ex0 = _select_col(nx0, ci)
        ex1 = _select_col(nx1, ci)
        es = _select_col(nsz, ci)
        changed = alive & ~stop_a & (es != s)
        small = es < min_intv
        append = stop_a | changed
        # one-hot slot write: a K-wide masked select instead of per-row
        # scatters
        idx = jnp.clip(cnt, 0, K_SLOTS - 1)
        sel = (jnp.arange(K_SLOTS)[None, :] == idx[:, None]) & append[:, None]
        put = lambda r, v: jnp.where(sel, v.astype(r.dtype)[:, None], r)
        rx0, rx1, rs, rinfo = (
            put(rx0, x0), put(rx1, x1), put(rs, s), put(rinfo, info),
        )
        ovf = ovf | (append & (cnt >= K_SLOTS))
        cnt = cnt + append.astype(jnp.int32)
        ret = jnp.where(append, info, ret)
        cont = alive & ~stop_a & ~(changed & small)
        x0 = jnp.where(cont, ex0, x0)
        x1 = jnp.where(cont, ex1, x1)
        s = jnp.where(cont, es, s)
        info = jnp.where(cont, pos + 1, info).astype(jnp.int32)
        return (t + 1, cont, x0, x1, s, info, rx0, rx1, rs, rinfo, cnt, ret,
                ovf)

    st = (
        jnp.int32(0), ~bad0, ik_x0, ik_x1, ik_s, ik_info,
        zKc, zKc, zK, zK, z, (x + 1).astype(jnp.int32), jnp.zeros(B, bool),
    )
    (_, _, _, _, _, _, rx0, rx1, rs, rinfo, cnt, ret, ovf) = (
        jax.lax.while_loop(fwd_cond, fwd_body, st)
    )

    # ------------- backward pass: batched slot extends per position -------
    # prev slots in longest-first order = reversed record order
    def rev(r):
        sel = jnp.clip(cnt[:, None] - 1 - jnp.arange(K_SLOTS)[None, :], 0,
                       K_SLOTS - 1)
        return jnp.take_along_axis(r, sel, axis=1)

    px0, px1, ps, pinfo = rev(rx0), rev(rx1), rev(rs), rev(rinfo)
    pcnt = cnt

    mems = dict(x0=zKc, x1=zKc, s=zK, qb=zK, qe=zK)
    m_cnt = z
    last_qb = jnp.full(B, jnp.int32(1 << 30))

    def bwd_cond(st):
        return st[1].any()

    def bwd_body(st):
        (t, lane_alive, px0, px1, ps, pinfo, pcnt, mx0, mx1, ms, mqb, mqe,
         m_cnt, last_qb, ovf) = st
        i = x - 1 - t
        cc = qseq[lane, jnp.clip(i, 0, L - 1)]
        have_c = lane_alive & (i >= 0) & (cc <= 3)
        c_idx = jnp.clip(cc, 0, 3)

        # Flattened extend for (lane, slot) pairs.  The row-gathers here
        # are the backward pass's wall (B*K rows per tick), and the live
        # stack depth is almost always small — so extend the first W1
        # slots unconditionally and the 16-slot tail only when some lane
        # actually holds that many intervals (rare; dead/garbage slots
        # hold zeros or stale-valid intervals, both safe to query).
        def ext_slots(sl0: int, sl1: int):
            n = sl1 - sl0
            nx0f, nx1f, nszf = ext(
                px0[:, sl0:sl1].reshape(-1), px1[:, sl0:sl1].reshape(-1),
                ps[:, sl0:sl1].reshape(-1), is_back=True,
            )
            cselw = jnp.repeat(c_idx, n)
            return (
                _select_col(nx0f, cselw).reshape(B, n),
                _select_col(nx1f, cselw).reshape(B, n),
                _select_col(nszf, cselw).reshape(B, n),
            )

        from . import fmindex_tpu as _fmt

        W1 = 8
        if K_SLOTS <= W1 or _fmt._SHARD_CTX is not None:
            # sharded-tables mode: the psum row fetch cannot live inside
            # a lax.cond branch under shard_map — extend the full width
            ax0, ax1, asz = ext_slots(0, K_SLOTS)
        else:
            a0a, a1a, asa = ext_slots(0, W1)
            ztail_c = jnp.zeros((B, K_SLOTS - W1), px0.dtype)
            ztail_i = jnp.zeros((B, K_SLOTS - W1), jnp.int32)
            a0b, a1b, asb = jax.lax.cond(
                (pcnt > W1).any(),
                lambda _: ext_slots(W1, K_SLOTS),
                lambda _: (ztail_c, ztail_c, ztail_i),
                None,
            )
            ax0 = jnp.concatenate([a0a, a0b], axis=1)
            ax1 = jnp.concatenate([a1a, a1b], axis=1)
            asz = jnp.concatenate([asa, asb], axis=1)

        # ---- vectorized slot update (the old per-slot fori paid ~10
        # one-hot [B, K] selects per slot per tick; this is a fixed ~40
        # [B, K] ops + one [B, K, K] compaction).  Semantics are the
        # sequential scan's, derived as closed forms:
        #   * at most ONE mem emits per tick (the first emission sets
        #     last_qb = i+1, which blocks the gate for later slots), and
        #     it is the first dead slot BEFORE the first surviving slot
        #     (any dead slot after a kept one sees ccnt > 0);
        #   * a surviving slot is kept iff its extended size differs from
        #     the PREVIOUS candidate's (dropping on equality leaves
        #     last_s at that same size, so comparing against the previous
        #     candidate is equivalent to comparing against the last kept).
        jarr = jnp.arange(K_SLOTS)[None, :]
        validm = lane_alive[:, None] & (jarr < pcnt[:, None])
        deadm = validm & (
            (~have_c)[:, None] | (asz < min_intv[:, None])
        )
        candm = validm & ~deadm
        NOJ = jnp.int32(K_SLOTS)
        first_dead = jnp.min(jnp.where(deadm, jarr, NOJ), axis=1)
        first_cand = jnp.min(jnp.where(candm, jarr, NOJ), axis=1)
        gate = (m_cnt == 0) | (i + 1 < last_qb)
        emit = gate & (first_dead < first_cand) & (first_dead < NOJ)
        sel_e = jarr == first_dead[:, None]
        pick = lambda r: jnp.where(sel_e, r, 0).sum(axis=1, dtype=r.dtype)
        midx = jnp.clip(m_cnt, 0, K_SLOTS - 1)
        selm = (jarr == midx[:, None]) & emit[:, None]
        putm = lambda r, v: jnp.where(selm, v.astype(r.dtype)[:, None], r)
        mx0, mx1, ms = (
            putm(mx0, pick(px0)), putm(mx1, pick(px1)), putm(ms, pick(ps)),
        )
        mqb = putm(mqb, jnp.broadcast_to(i + 1, emit.shape))
        mqe = putm(mqe, pick(pinfo))
        ovf = ovf | (emit & (m_cnt >= K_SLOTS))
        last_qb = jnp.where(emit, i + 1, last_qb)
        m_cnt = m_cnt + emit.astype(jnp.int32)
        # keep = dedup vs previous candidate: log-K "last candidate size"
        # doubling scan, then compare
        have = candm
        val = jnp.where(candm, asz, 0)
        sh = 1
        while sh < K_SLOTS:
            val_s = jnp.concatenate(
                [jnp.zeros((B, sh), val.dtype), val[:, :-sh]], axis=1
            )
            have_s = jnp.concatenate(
                [jnp.zeros((B, sh), bool), have[:, :-sh]], axis=1
            )
            val = jnp.where(have, val, val_s)
            have = have | have_s
            sh <<= 1
        prev_val = jnp.concatenate(
            [jnp.zeros((B, 1), val.dtype), val[:, :-1]], axis=1
        )
        prev_have = jnp.concatenate(
            [jnp.zeros((B, 1), bool), have[:, :-1]], axis=1
        )
        keep = candm & (~prev_have | (asz != prev_val))
        dest = jnp.cumsum(keep.astype(jnp.int32), axis=1) - keep
        eq = (
            dest[:, :, None] == jnp.arange(K_SLOTS)[None, None, :]
        ) & keep[:, :, None]

        def compact(v):
            return (v[:, :, None] * eq.astype(v.dtype)).sum(
                axis=1, dtype=v.dtype
            )

        cx0, cx1 = compact(ax0), compact(ax1)
        cs, cinfo = compact(asz), compact(pinfo)
        ccnt = keep.sum(axis=1).astype(jnp.int32)
        lane_alive = lane_alive & (ccnt > 0) & (i > -1)
        return (t + 1, lane_alive, cx0, cx1, cs, cinfo, ccnt, mx0, mx1, ms,
                mqb, mqe, m_cnt, last_qb, ovf)

    st = (
        jnp.int32(0), (~bad0) & (pcnt > 0), px0, px1, ps, pinfo, pcnt,
        mems["x0"], mems["x1"], mems["s"], mems["qb"], mems["qe"], m_cnt,
        last_qb, ovf,
    )
    (_, _, _, _, _, _, _, mx0, mx1, ms, mqb, mqe, m_cnt, _lqb, ovf) = (
        jax.lax.while_loop(bwd_cond, bwd_body, st)
    )
    return ret, mx0, mx1, ms, mqb, mqe, m_cnt, ovf


smem1a_batch_kernel = partial(
    jax.jit, static_argnames=("primary", "seq_len", "span")
)(smem1a_body)


def smem1a_batch(dfm: DeviceFMIndex, qseq, qlen, x, min_intv):
    with dfm.ctx():
        return smem1a_batch_kernel(
            dfm.lines, dfm.L2, qseq, qlen, x, min_intv,
            dfm.primary, dfm.seq_len, dfm.span,
        )
