"""Seed chaining on device ([EXT] bwamem.c mem_chain + mem_chain_flt).

The reference chains seeds per read with a b-tree predecessor lookup and a
greedy merge (bwamem.c mem_chain / test_and_merge, anchored in-tree at
jnibwa.c:214), then filters chains by weight with an O(n^2) overlap-
shadowing pass (mem_chain_flt).  Both are small, sequential, per-read
state machines — the device formulation runs them as ONE fixed-shape
``lax.scan`` per read, vmapped over the batch:

  * chain table = C fixed slots (key, rid, first/last seed); the b-tree
    predecessor query becomes a masked arg-max over slot keys, with the
    reference's bisect_right tie-break (rightmost equal key = latest
    inserted) reproduced by a second arg-max over slot index;
  * chain weight = the coverage walk expressed as a masked scan over the
    seed->chain assignment;
  * mem_chain_flt's dynamic kept-list with break = a ``fori_loop`` over
    weight-sorted chains whose inner loop is fully vectorized (the break
    point is the arg-min of the drop condition; "visited" = prefix mask).

Reads that overflow the S seed slots or C chain slots flag themselves and
fall back to the host oracle (engine/chain.py), so output stays exact for
every read.  Bit-exact vs chain_flt(mem_chain(...)) in
tests/test_chain_tpu.py.
"""
from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..api.options import MemOptions
from ..engine.chain import Chain, Seed, chain_flt, mem_chain

I32MIN = jnp.int32(-(1 << 31))


@partial(jax.jit, static_argnames=("S", "C", "l_pac"))
def chain_kernel(
    rbeg, qbeg, slen, nseed,  # [B,S] i32 seeds in enumeration order; [B]
    qlen,  # [B] i32
    ctg_end, ctg_alt,  # [Nc] i32 cumulative contig ends; [Nc] i32 is_alt
    w, max_chain_gap, min_chain_weight, min_seed_len, max_chain_extend,
    mask_level, drop_ratio,  # python scalars via closure-free traced args
    S: int, C: int, l_pac: int,
):
    """Returns per-read chain structures (all in fixed [B, C]/[B, S] shapes).

    out: assign [B,S] seed->chain slot (-1 dropped), crid/ckey/cq0/cql/cll
    [B,C] slot-space chain fields, weight [B,C], nch [B], order [B,C]
    weight-sorted slot permutation, kept [B,C] kept-codes in SORTED space,
    first [B,C] sorted-space first-shadow index, emit [B,C] final output
    mask in sorted space, ovf [B] overflow flag.
    """
    B = rbeg.shape[0]
    # reference coordinates run in the seeds' dtype (int32 below 1 Gbp
    # forward length, int64 at genome scale under the x64 context); query
    # coordinates stay int32 throughout
    cdt = rbeg.dtype
    CMAX = jnp.asarray(jnp.iinfo(cdt).max, cdt)
    CMIN = jnp.asarray(jnp.iinfo(cdt).min, cdt)

    # ---- per-seed rid ([EXT] bns_intv2rid over the doubled domain) -------
    re_ = rbeg + slen.astype(cdt)
    fwd = rbeg < l_pac
    cross = fwd != (re_ <= l_pac)
    fb = jnp.where(fwd, rbeg, 2 * l_pac - 1 - (re_ - 1))
    fe = jnp.where(fwd, re_ - 1, 2 * l_pac - 1 - rbeg)
    ctg_end = ctg_end.astype(cdt)
    rid_b = jnp.searchsorted(ctg_end, fb, side="right").astype(jnp.int32)
    rid_e = jnp.searchsorted(ctg_end, fe, side="right").astype(jnp.int32)
    rid = jnp.where(
        cross | (rid_b != rid_e) | (fb < 0) | (fe >= l_pac), -1, rid_b
    )

    def one_read(rbeg_s, qbeg_s, slen_s, rid_s, ns, ql_read):
        slot_ix = jnp.arange(C, dtype=jnp.int32)

        # ------------- mem_chain greedy merge scan ------------------------
        def step(carry, t):
            key, crid, q0, r0, ql, rl, ll, nch, ovf = carry
            p_r, p_q, p_l, p_rid = rbeg_s[t], qbeg_s[t], slen_s[t], rid_s[t]
            p_ok = (t < ns) & (p_rid >= 0) & (ql_read >= min_seed_len)
            act = slot_ix < nch
            m = act & (key <= p_r)
            has_pred = m.any()
            bestkey = jnp.max(jnp.where(m, key, CMIN))
            cand = m & (key == bestkey)
            ci = jnp.max(jnp.where(cand, slot_ix, -1))
            cis = jnp.clip(ci, 0, C - 1)
            c_rid, c_q0, c_r0 = crid[cis], q0[cis], r0[cis]
            c_ql, c_rl, c_ll = ql[cis], rl[cis], ll[cis]
            same = has_pred & (p_rid == c_rid)
            qend = c_ql + c_ll
            rend = c_rl + c_ll
            contained = (
                same
                & (p_q >= c_q0) & (p_q + p_l <= qend)
                & (p_r >= c_r0) & (p_r + p_l <= rend)
            )
            strand_blk = ((c_rl < l_pac) | (c_r0 < l_pac)) & (p_r >= l_pac)
            x = p_q - c_ql
            y = p_r - c_rl
            can = (
                (y >= 0) & (x - y <= w) & (y - x <= w)
                & (x - c_ll < max_chain_gap) & (y - c_ll < max_chain_gap)
            )
            drop = p_ok & contained
            append = p_ok & same & ~contained & ~strand_blk & can
            newc = p_ok & ~drop & ~append
            # append: replace the chain's last seed (one-hot slot write —
            # under vmap a .at[cis].set becomes a serialized batched
            # scatter, a C-wide masked select stays elementwise)
            carr = jnp.arange(C)
            sela = (carr == cis) & append
            ql = jnp.where(sela, p_q, ql)
            rl = jnp.where(sela, p_r.astype(cdt), rl)
            ll = jnp.where(sela, p_l, ll)
            # new chain at the next free slot
            nsl = jnp.clip(nch, 0, C - 1)
            seln = (carr == nsl) & newc
            put = lambda a, v: jnp.where(seln, v.astype(a.dtype), a)
            key, crid = put(key, p_r), put(crid, p_rid)
            q0, r0 = put(q0, p_q), put(r0, p_r)
            ql, rl, ll = put(ql, p_q), put(rl, p_r), put(ll, p_l)
            ovf = ovf | (newc & (nch >= C))
            assign_t = jnp.where(
                append, cis, jnp.where(newc, nsl, jnp.int32(-1))
            )
            nch = nch + newc.astype(jnp.int32)
            return (key, crid, q0, r0, ql, rl, ll, nch, ovf), assign_t

        zc = jnp.zeros(C, jnp.int32)
        zcc = jnp.zeros(C, cdt)
        init = (
            jnp.full(C, CMAX, cdt), zc, zc, zcc, zc, zcc, zc,
            jnp.int32(0), jnp.bool_(False),
        )
        (key, crid, q0, r0, ql, rl, ll, nch, ovf), assign = jax.lax.scan(
            step, init, jnp.arange(S, dtype=jnp.int32)
        )

        # ------------- chain weight (coverage walk over assignment) -------
        def wstep(carry, t):
            endq, wq, endr, wr = carry
            sel = (assign[t] == slot_ix) & (t < ns)
            eq2 = qbeg_s[t] + slen_s[t]
            er2 = rbeg_s[t] + slen_s[t].astype(cdt)
            wq = wq + jnp.where(
                sel, jnp.maximum(0, eq2 - jnp.maximum(endq, qbeg_s[t])), 0
            )
            wr = wr + jnp.where(
                sel,
                jnp.maximum(0, er2 - jnp.maximum(endr, rbeg_s[t])),
                0,
            ).astype(jnp.int32)
            endq = jnp.where(sel, jnp.maximum(endq, eq2), endq)
            endr = jnp.where(sel, jnp.maximum(endr, er2), endr)
            return (endq, wq, endr, wr), None

        (_, wq, _, wr), _ = jax.lax.scan(
            wstep, (zc, zc, zcc, zc), jnp.arange(S, dtype=jnp.int32)
        )
        weight = jnp.minimum(jnp.minimum(wq, wr), (1 << 30) - 1)

        # ------------- mem_chain_flt --------------------------------------
        alive = (slot_ix < nch) & (weight >= min_chain_weight)
        # list position = (key asc, slot asc): bisect_right inserts after
        # equal keys, so a STABLE argsort of key (ties -> slot order) is
        # exactly the reference's pos-sorted list.  The weight sort is then
        # a stable argsort of -w over that pos order (int32 throughout —
        # no composite keys that would overflow at gigabase scale).
        perm_pos = jnp.argsort(key, stable=True).astype(jnp.int32)
        w_pos = jnp.where(
            alive[perm_pos], -weight[perm_pos], jnp.int32((1 << 31) - 1)
        )
        order = perm_pos[jnp.argsort(w_pos, stable=True)]  # w desc, pos tie
        n_alive = alive.sum().astype(jnp.int32)
        sw = weight[order]
        sqb = q0[order]
        sqe = ql[order] + ll[order]
        salt = ctg_alt[jnp.clip(crid[order], 0, ctg_alt.shape[0] - 1)] > 0
        sl = sqe - sqb

        is_kept = jnp.zeros(C, bool).at[0].set(n_alive > 0)
        kept = jnp.zeros(C, jnp.int32).at[0].set(
            jnp.where(n_alive > 0, 3, 0)
        )
        first = jnp.full(C, jnp.int32(-1))

        def body(i, st):
            is_kept, kept, first = st
            act_i = i < n_alive
            li = sl[i]
            validj = is_kept & (slot_ix < i)
            b_max = jnp.maximum(sqb, sqb[i])
            e_min = jnp.minimum(sqe, sqe[i])
            ov = (e_min > b_max) & ~(salt & ~salt[i])
            min_l = jnp.minimum(li, sl)
            big_ov = (
                ov
                & ((e_min - b_max).astype(jnp.float32)
                   >= min_l.astype(jnp.float32) * mask_level)
                & (min_l < max_chain_gap)
            )
            dropj = (
                validj & big_ov
                & (sw[i].astype(jnp.float32) < sw.astype(jnp.float32) * drop_ratio)
                & (sw - sw[i] >= (min_seed_len << 1))
            )
            fb_ = jnp.min(jnp.where(dropj, slot_ix, jnp.int32(C)))
            visited = validj & (slot_ix <= fb_)
            large = act_i & (visited & big_ov).any()
            broke = act_i & (fb_ < C)
            first = jnp.where(
                act_i & visited & big_ov & (first < 0), i, first
            )
            keep_i = act_i & ~broke
            is_kept = is_kept.at[i].set(keep_i)
            kept = kept.at[i].set(
                jnp.where(keep_i, jnp.where(large, 2, 3), 0)
            )
            return is_kept, kept, first

        is_kept, kept, first = jax.lax.fori_loop(
            1, C, body, (is_kept, kept, first)
        )
        # retain the first shadowed chain of each kept chain (kept=1)
        tgt = jnp.where(is_kept & (first >= 0), first, C)
        bump = jnp.zeros(C + 1, jnp.int32).at[tgt].max(1, mode="drop")
        kept = jnp.maximum(kept, bump[:C])
        # max_chain_extend trim over the output walk
        extc = jnp.cumsum((kept >= 2).astype(jnp.int32))
        emit = (kept > 0) & ~((kept >= 2) & (extc > max_chain_extend))
        return (
            assign, crid, weight, nch, order, kept, first, emit, ovf
        )

    return jax.vmap(one_read)(rbeg, qbeg, slen, rid, nseed, qlen)


_S_BUCKETS = (64, 256, 1024)
_C_BUCKETS = (32, 128)
_B_BUCKETS = (64, 256, 1024, 4096)


def _bucket(n: int, buckets) -> int | None:
    for b in buckets:
        if n <= b:
            return b
    return None


def _frac_rep(opt: MemOptions, intervals, qlen: int) -> float:
    """[EXT] mem_chain tail: query coverage of over-occurring intervals."""
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


_CTG_CACHE: dict = {}


def _ctg_cache(bns, mesh):
    """Device-resident contig tables, uploaded once per (index, mesh) —
    re-uploading per batch costs host->device copies."""
    key = (id(bns), None if mesh is None else id(mesh))
    ent = _CTG_CACHE.get(key)
    if ent is None:
        ctg_end = np.asarray(
            [a.offset + a.length for a in bns.anns], dtype=np.int32
        )
        ctg_alt = np.asarray([a.is_alt for a in bns.anns], dtype=np.int32)
        if mesh is not None:
            from ..parallel.mesh import replicate

            ctg_end, ctg_alt = replicate(mesh, ctg_end, ctg_alt)
        else:
            ctg_end, ctg_alt = jnp.asarray(ctg_end), jnp.asarray(ctg_alt)
        ent = _CTG_CACHE[key] = (ctg_end, ctg_alt)
    return ent


@partial(
    jax.jit,
    static_argnames=(
        "S", "C", "l_pac", "w", "max_chain_gap", "min_chain_weight",
        "min_seed_len", "max_chain_extend", "mask_level", "drop_ratio",
    ),
)
def _chain_entry(
    packed, ctg_end, ctg_alt, *, S: int, C: int, l_pac: int, w: int,
    max_chain_gap: int, min_chain_weight: int, min_seed_len: int,
    max_chain_extend: int, mask_level: float, drop_ratio: float,
):
    """One-upload chain step: packed [B, 3S+2] = rbeg | qbeg | slen |
    (nseed, qlen); scalars are compile-time constants (zero per-call
    transfers); outputs collapse to (assign [B,S], out2 [B, 6C+2]) — TWO
    pulls per batch."""
    rbeg = packed[:, :S]
    qbeg = packed[:, S : 2 * S]
    slen = packed[:, 2 * S : 3 * S]
    nseed = packed[:, 3 * S]
    qlen = packed[:, 3 * S + 1]
    assign, crid, weight, nch, order, kept, first, emit, ovf = chain_kernel(
        rbeg, qbeg, slen, nseed, qlen, ctg_end, ctg_alt,
        jnp.int32(w), jnp.int32(max_chain_gap), jnp.int32(min_chain_weight),
        jnp.int32(min_seed_len), jnp.int32(max_chain_extend),
        jnp.float32(mask_level), jnp.float32(drop_ratio),
        S=S, C=C, l_pac=l_pac,
    )
    out2 = jnp.concatenate(
        [
            crid, weight, order, kept, first, emit.astype(jnp.int32),
            nch[:, None], ovf.astype(jnp.int32)[:, None],
        ],
        axis=1,
    )
    return assign, out2


def chains_device_batch(
    opt: MemOptions,
    fm,
    bns,
    reads: List[np.ndarray],
    intervals_list,
    rbegs_per_intv_list,
    mesh=None,
) -> List[List[Chain]]:
    """mem_chain + chain_flt for a batch of reads on device.

    intervals_list[i] / rbegs_per_intv_list[i]: each read's SMEM intervals
    (sorted, as collect_intv emits) and the sampled suffix-array positions
    per interval (the batched pipeline resolves these in one sa call).
    Output is identical to the host oracle; overflowing reads fall back.
    mesh: shard the per-read batch across the mesh devices (the kernel is
    vmapped over reads, so XLA partitions it with no communication).
    """
    n = len(reads)
    if n == 0:
        return []
    if 2 * int(bns.l_pac) >= (1 << 31):
        # the kernel stages rbeg over the doubled domain in int32; beyond
        # ~1 Gbp forward length that wraps, so gigabase references take the
        # host oracle (mirrors the seq_len < 2^31 guard on the device
        # SA-lookup path in engine/pipeline.py)
        return [
            chain_flt(
                opt,
                mem_chain(opt, fm, bns, len(q), intervals, rbegs_per),
            )
            for q, intervals, rbegs_per in zip(
                reads, intervals_list, rbegs_per_intv_list
            )
        ]

    # flatten every read's (interval x sample) seeds in enumeration order
    seeds_np: List[np.ndarray] = []
    max_s = 1
    for intervals, rbegs_per in zip(intervals_list, rbegs_per_intv_list):
        rows = []
        for p, rbegs in zip(intervals, rbegs_per):
            for rb in np.asarray(rbegs).tolist():
                rows.append((rb, p.qb, p.qlen))
        arr = np.asarray(rows, dtype=np.int64).reshape(-1, 3)
        seeds_np.append(arr)
        max_s = max(max_s, len(arr))

    S = _bucket(max_s, _S_BUCKETS)
    C = _bucket(min(max_s, _C_BUCKETS[-1]), _C_BUCKETS) or _C_BUCKETS[-1]
    B = _bucket(n, _B_BUCKETS) or ((n + 4095) // 4096) * 4096
    host_all = S is None
    if host_all:
        S = _S_BUCKETS[0]  # kernel still runs for the small reads

    # ONE packed upload per batch: rbeg | qbeg | slen | nseed | qlen
    packed = np.zeros((B, 3 * S + 2), np.int32)
    host_fb = np.zeros(n, bool)
    for i, arr in enumerate(seeds_np):
        if len(arr) > S:
            host_fb[i] = True
            continue
        packed[i, : len(arr)] = arr[:, 0]
        packed[i, S : S + len(arr)] = arr[:, 1]
        packed[i, 2 * S : 2 * S + len(arr)] = arr[:, 2]
        packed[i, 3 * S] = len(arr)
        packed[i, 3 * S + 1] = len(reads[i])

    # host copies for the result-assembly loop (the device arrays must
    # not be read back element-wise)
    rbeg_h = packed[:, :S]
    qbeg_h = packed[:, S : 2 * S]
    slen_h = packed[:, 2 * S : 3 * S]
    nseed_h = packed[:, 3 * S]
    ctg_end_d, ctg_alt_d = _ctg_cache(bns, mesh)
    import jax

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        packed_d = jax.device_put(
            packed, NamedSharding(mesh, P(tuple(mesh.axis_names), None))
        )
    else:
        packed_d = jnp.asarray(packed)
    (assign, out2) = jax.device_get(
        _chain_entry(
            packed_d, ctg_end_d, ctg_alt_d,
            S=S, C=C, l_pac=int(bns.l_pac), w=int(opt.w),
            max_chain_gap=int(opt.max_chain_gap),
            min_chain_weight=int(opt.min_chain_weight),
            min_seed_len=int(opt.min_seed_len),
            max_chain_extend=int(opt.max_chain_extend),
            mask_level=float(opt.mask_level),
            drop_ratio=float(opt.drop_ratio),
        )
    )
    crid = out2[:, :C]
    weight = out2[:, C : 2 * C]
    order = out2[:, 2 * C : 3 * C]
    kept = out2[:, 3 * C : 4 * C]
    first = out2[:, 4 * C : 5 * C]
    emit = out2[:, 5 * C : 6 * C] != 0
    nch = out2[:, 6 * C]
    ovf = out2[:, 6 * C + 1] != 0

    out: List[List[Chain]] = []
    for i in range(n):
        if host_fb[i] or ovf[i]:
            chains = mem_chain(
                opt, fm, bns, len(reads[i]), intervals_list[i],
                rbegs_per_intv_list[i],
            )
            out.append(chain_flt(opt, chains))
            continue
        frac = _frac_rep(opt, intervals_list[i], len(reads[i]))
        # seeds per slot, in enumeration order
        per_slot: List[List[Seed]] = [[] for _ in range(int(nch[i]))]
        a_i = assign[i]
        for t in range(int(nseed_h[i])):
            s = int(a_i[t])
            if s >= 0:
                per_slot[s].append(
                    Seed(
                        rbeg=int(rbeg_h[i, t]), qbeg=int(qbeg_h[i, t]),
                        len=int(slen_h[i, t]), score=int(slen_h[i, t]),
                    )
                )
        chains = []
        for j in range(C):
            if not emit[i, j]:
                continue
            slot = int(order[i, j])
            c = Chain(
                rid=int(crid[i, slot]),
                seeds=per_slot[slot],
                is_alt=int(bns.anns[crid[i, slot]].is_alt),
                frac_rep=frac,
                w=int(weight[i, slot]),
                kept=int(kept[i, j]),
                first=int(first[i, j]),
            )
            chains.append(c)
        out.append(chains)
    return out
