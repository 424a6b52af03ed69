"""Batched seeding primitives on the device.

Hot loop #1 of the reference engine is the memory-latency-bound random Occ
lookup chain of backward search (SURVEY.md section 3.3).  On the device
the same work is a lockstep batch: every read advances one base per step,
each step is ONE fused occ-line gather over the device-resident index
(the fused-line layout of ops/fmindex_tpu.py).

This module provides the device-side backward-search / forward-extension
loops (lax.while_loop lockstep with per-lane masks).  The full three-round
SMEM control flow lives in ops/smem_tpu.py; the loops below cover
exact-match search and the LAST-like third-round seeding
(bwt_seed_strategy1), both validated against the host oracle.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .fmindex_tpu import DeviceFMIndex, _extend_core, _select_col, occ4_device


@partial(jax.jit, static_argnames=("primary", "seq_len", "span"))
def backward_search_batch(
    lines, L2, qseq, qlen, primary: int, seq_len: int, span: int
):
    """Exact-match backward search for a batch of reads ([B, L] codes).

    Returns (k, l, n_matched): the final SA interval [k, l] after matching
    as many trailing bases as possible (stops per lane when empty), plus
    how many bases matched.  bwa bwt_match_exact semantics.
    """
    B, L = qseq.shape
    cdt = L2.dtype
    k0 = jnp.zeros(B, cdt)
    l0 = jnp.full(B, seq_len, cdt)

    def cond(state):
        i, k, l, alive, _ = state
        return (i < L) & alive.any()

    def body(state):
        i, k, l, alive, matched = state
        c = qseq[:, L - 1 - i]  # right-to-left
        valid = alive & (c < 4) & (i < qlen)
        # one fused gather answers both interval endpoints
        both = occ4_device(
            lines, L2, jnp.concatenate([k - 1, l]), primary, seq_len, span
        )
        occ_k, occ_l = both[:B], both[B:]
        cc = jnp.clip(c, 0, 3)
        sel = jnp.arange(B)
        k2 = L2[cc] + occ_k[sel, cc] + 1
        l2 = L2[cc] + occ_l[sel, cc]
        ok = valid & (k2 <= l2)
        k = jnp.where(ok, k2, k)
        l = jnp.where(ok, l2, l)
        matched = jnp.where(ok, matched + 1, matched)
        alive = ok
        return i + 1, k, l, alive, matched

    _, k, l, _, matched = jax.lax.while_loop(
        cond,
        body,
        (jnp.int32(0), k0, l0, jnp.ones(B, bool), jnp.zeros(B, jnp.int32)),
    )
    return k, l, matched


def backward_search(dfm: DeviceFMIndex, qseq, qlen):
    with dfm.ctx():
        return backward_search_batch(
            dfm.lines, dfm.L2, qseq, qlen, dfm.primary, dfm.seq_len, dfm.span
        )


def strategy1_body(
    lines, L2, qseq, qlen, x, primary: int, seq_len: int, span: int,
    min_len: int, max_intv: int,
):
    """Device lockstep of [EXT] bwt_seed_strategy1 from start positions x.

    Plain traced body (used by ops/seed_fused.py); seed_strategy1_batch is
    the standalone jitted wrapper.

    Forward-extends every read's pattern from its own x until the interval
    drops below max_intv with length > min_len.  Returns per lane
    (found, x0, x1, s, qb, qe, nxt) exactly like the host seed_strategy1 —
    nxt is the next start cursor (i+1 on hit or N, qlen at read end).
    """
    B, L = qseq.shape
    cdt = L2.dtype
    c0 = qseq[jnp.arange(B), jnp.clip(x, 0, L - 1)]
    bad0 = (c0 > 3) | (x >= qlen)
    cc0 = jnp.clip(c0, 0, 3)
    ix0 = L2[cc0] + 1
    ix1 = L2[3 - cc0] + 1
    isz = (L2[cc0 + 1] - L2[cc0]).astype(jnp.int32)

    def cond(state):
        i, alive, *_ = state
        return alive.any()

    def body(state):
        i, alive, x0, x1, s, found, fx0, fx1, fs, fqe, nxt = state
        pos = jnp.clip(x + 1 + i, 0, L - 1)
        c = qseq[jnp.arange(B), pos]
        in_range = (x + 1 + i) < qlen
        valid = alive & (c < 4) & in_range
        # next-cursor bookkeeping ([EXT] bwt_seed_strategy1 return value):
        # N at this position -> i+1; read end -> qlen
        stop_n = alive & in_range & (c >= 4)
        stop_end = alive & ~in_range
        nxt = jnp.where(stop_n, x + 2 + i, nxt)
        nxt = jnp.where(stop_end, qlen, nxt)
        # forward extension queries the revcomp coordinate (x1)
        new_o, new_q, sz = _extend_core(
            lines, L2, x0, x1, s, primary, seq_len, span, is_back=False
        )
        ci = 3 - jnp.clip(c, 0, 3)  # bwa ok[] index for append
        nx0 = _select_col(new_o, ci)
        nx1 = _select_col(new_q, ci)
        ns = _select_col(sz, ci)
        hit = valid & (ns < max_intv) & ((x + 1 + i) - x >= min_len)
        newly = hit & ~found
        found = found | newly
        fx0 = jnp.where(newly, nx0, fx0)
        fx1 = jnp.where(newly, nx1, fx1)
        fs = jnp.where(newly, ns, fs)
        fqe = jnp.where(newly, x + i + 2, fqe)
        nxt = jnp.where(newly, x + i + 2, nxt)
        cont = valid & ~hit
        x0 = jnp.where(cont, nx0, x0)
        x1 = jnp.where(cont, nx1, x1)
        s = jnp.where(cont, ns, s)
        alive = cont
        return i + 1, alive, x0, x1, s, found, fx0, fx1, fs, fqe, nxt

    z = jnp.zeros(B, jnp.int32)
    zc = jnp.zeros(B, cdt)
    init = (
        jnp.int32(0), ~bad0, ix0.astype(cdt), ix1.astype(cdt),
        isz, jnp.zeros(B, bool), zc, zc, z, z,
        (x + 1).astype(jnp.int32),
    )
    _, _, _, _, _, found, fx0, fx1, fs, fqe, nxt = jax.lax.while_loop(
        cond, body, init
    )
    return found, fx0, fx1, fs, x, fqe, nxt


seed_strategy1_batch = partial(
    jax.jit,
    static_argnames=("primary", "seq_len", "span", "min_len", "max_intv"),
)(strategy1_body)


def seed_strategy1(dfm: DeviceFMIndex, qseq, qlen, x, min_len, max_intv):
    """Strategy-1 wave on a DeviceFMIndex (handles the int64 domain)."""
    with dfm.ctx():
        return seed_strategy1_batch(
            dfm.lines, dfm.L2, qseq, qlen, x,
            dfm.primary, dfm.seq_len, dfm.span, min_len, max_intv,
        )
