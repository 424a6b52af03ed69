"""Batched banded SW extension on the device (jnp/XLA formulation).

Device replacement for the reference's hot kernel #2, [EXT] ksw_extend2
(SSE2 striped SW; SURVEY.md section 3.3).  Instead of translating the SIMD
striping, the DP is reshaped into elementwise array work:

  * a batch of B independent extension jobs is vectorized elementwise —
    each row step updates [B, Q] row-states,
  * rows advance with lax.scan (target position i is the sequential axis),
  * the horizontal-gap recurrence F is closed-form: because ksw opens gaps
    from the match score M only, F(j) = max_{k<j} (max(M(k)-oe,0) + k*e)
    - (j-1)*e — a cummax, not a sequential loop.

Bit-exactness notes (validated against the host oracle engine/extend.py):
the adaptive [beg, end) window is loop-carried per job exactly as in ksw —
it is NOT merely an optimization: `end` gates when gscore (to-query-end
score) updates fire, and cells outside the window retain their stale values
which later rows may re-read when the window regrows.  We therefore carry
the eh[] array in bwa's own indexing (eh[j].h = H(i, j-1), eh[j].e =
E(i+1, j)) and update only the window, including the eh[end] boundary
writes and both shrink scans.
"""
from __future__ import annotations

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# When set (parallel/pipeline.py::active_mesh), ksw_extend_batch_np places
# wave inputs with the batch dimension sharded over the mesh's data+idx
# axes; the kernel is elementwise over the batch, so XLA partitions it with
# zero communication and the wave's FLOPs spread across the mesh.
_ACTIVE_MESH = None


@contextlib.contextmanager
def active_mesh(mesh):
    """Route subsequent extension waves data-parallel over ``mesh``."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


@partial(
    jax.jit,
    static_argnames=(
        "o_del", "e_del", "o_ins", "e_ins", "zdrop", "max_sc", "early_exit",
    ),
)
def ksw_extend_batch(
    qseq,  # [B, Q] int32 codes (0..4), padded past qlen
    tseq,  # [B, T] int32 codes
    qlen,  # [B] int32
    tlen,  # [B] int32
    h0,  # [B] int32 initial score
    w,  # [B] int32 band width
    end_bonus,  # [B] int32
    mat,  # [5, 5] int32 scoring matrix
    o_del: int,
    e_del: int,
    o_ins: int,
    e_ins: int,
    zdrop: int,
    max_sc: int,  # max entry of mat (static)
    early_exit: bool = False,  # while_loop rows; stop when every lane is done
):
    """Returns dict of [B] int32 arrays: score, qle, tle, gtle, gscore, max_off."""
    B, Q = qseq.shape
    T = tseq.shape[1]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    cc = jnp.arange(Q, dtype=jnp.int32)[None, :]  # query columns [1, Q]
    jj = jnp.arange(Q + 1, dtype=jnp.int32)[None, :]  # eh indices [1, Q+1]

    # per-job band adjustment (ksw_extend2 preamble)
    max_ins = ((qlen * max_sc + end_bonus - o_ins) // e_ins + 1).astype(jnp.int32)
    w_adj = jnp.minimum(w, jnp.maximum(max_ins, 1))
    max_del = ((qlen * max_sc + end_bonus - o_del) // e_del + 1).astype(jnp.int32)
    w_adj = jnp.minimum(w_adj, jnp.maximum(max_del, 1))

    # query profile [B, 5, Q]
    qprof = jnp.transpose(mat[:, qseq], (1, 0, 2))

    # eh[] init: eh[0].h = h0; eh[j].h = max(h0 - oe_ins - (j-1)e, 0), j>=1
    eh_h = jnp.maximum(h0[:, None] - oe_ins - (jj - 1) * e_ins, 0)
    eh_h = eh_h.at[:, 0].set(h0)
    eh_h = jnp.where(jj <= qlen[:, None], eh_h, 0)
    eh_e = jnp.zeros((B, Q + 1), dtype=jnp.int32)

    # one-hot column mask at qlen, hoisted: the per-row gscore read is a
    # masked reduce instead of a per-lane gather
    qmask = (jj == qlen[:, None]).astype(jnp.int32)

    init = dict(
        eh_h=eh_h.astype(jnp.int32),
        eh_e=eh_e,
        beg=jnp.zeros(B, jnp.int32),
        end=qlen.astype(jnp.int32),
        done=jnp.zeros(B, dtype=bool),
        maxv=h0.astype(jnp.int32),
        max_i=jnp.full(B, -1, jnp.int32),
        max_j=jnp.full(B, -1, jnp.int32),
        max_ie=jnp.full(B, -1, jnp.int32),
        gscore=jnp.full(B, -1, jnp.int32),
        max_off=jnp.zeros(B, jnp.int32),
    )

    def row_step(state, i):
        eh_h, eh_e = state["eh_h"], state["eh_e"]
        # window update (persistent, then clamped by the band)
        beg = jnp.maximum(state["beg"], i - w_adj)
        end = jnp.minimum(jnp.minimum(state["end"], i + w_adj + 1), qlen)
        in_win = (cc >= beg[:, None]) & (cc < end[:, None])  # columns [B, Q]
        h1 = jnp.where(
            beg == 0, jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0), 0
        ).astype(jnp.int32)
        tc = jnp.take(tseq, jnp.minimum(i, T - 1), axis=1)  # [B]
        onehot = jax.nn.one_hot(tc, 5, dtype=jnp.int32)
        q = jnp.einsum("bc,bcq->bq", onehot, qprof)  # [B, Q]
        # columns c in [beg, end): H(i,c) from eh[c] = {H(i-1,c-1), E(i,c)}
        Hdiag = eh_h[:, :Q]
        M = jnp.where(Hdiag != 0, Hdiag + q, 0)
        M = jnp.where(in_win, M, 0)
        E = jnp.where(in_win, eh_e[:, :Q], 0)
        Mc = jnp.maximum(M - oe_ins, 0)
        P = jax.lax.cummax(Mc + cc * e_ins, axis=1)
        F = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), P[:, :-1] - (cc[:, 1:] - 1) * e_ins],
            axis=1,
        )
        # f restarts at 0 at the window's left edge: contributions from
        # masked columns are Mc=0 chains, which floor to <=0 and are clamped
        F = jnp.maximum(F, 0)
        F = jnp.where(in_win, F, 0)
        Hrow = jnp.maximum(jnp.maximum(M, E), F)
        Hrow = jnp.where(in_win, Hrow, 0)
        E_next = jnp.maximum(E - e_del, jnp.maximum(M - oe_del, 0))
        E_next = jnp.where(in_win, E_next, 0)
        # row max over the window; mj = last attaining column (bwa's >=)
        mrow = jnp.max(Hrow, axis=1)
        mj = (Q - 1) - jnp.argmax(Hrow[:, ::-1], axis=1).astype(jnp.int32)
        # write back eh[]: eh[j].h = H(i, j-1) for j in (beg, end];
        # eh[beg].h = h1 boundary; eh[j].e = E(i+1, j) in [beg, end); eh[end].e = 0
        H_shift = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), Hrow], axis=1)
        write_h = (jj > beg[:, None]) & (jj <= end[:, None])
        eh_h2 = jnp.where(write_h, H_shift, eh_h)
        eh_h2 = jnp.where(jj == beg[:, None], h1[:, None], eh_h2)
        E_pad = jnp.concatenate([E_next, jnp.zeros((B, 1), jnp.int32)], axis=1)
        write_e = (jj >= beg[:, None]) & (jj < end[:, None])
        eh_e2 = jnp.where(write_e, E_pad, eh_e)
        eh_e2 = jnp.where(jj == end[:, None], 0, eh_e2)
        # gscore (to-query-end), fires only when the window reaches qlen
        reaches = end == qlen
        h_last = (H_shift * qmask).sum(axis=1)
        active = ~state["done"] & (i < tlen)
        upd_g = reaches & (state["gscore"] <= h_last) & active
        gscore = jnp.where(upd_g, h_last, state["gscore"])
        max_ie = jnp.where(upd_g, i, state["max_ie"])
        # break / max / zdrop
        brk_zero = mrow == 0
        improved = mrow > state["maxv"]
        di = i - state["max_i"]
        dj = mj - state["max_j"]
        zcond = jnp.where(
            di > dj,
            state["maxv"] - mrow - (di - dj) * e_del > zdrop,
            state["maxv"] - mrow - (dj - di) * e_ins > zdrop,
        )
        brk_z = (zdrop > 0) & ~improved & zcond
        maxv = jnp.where(active & improved, mrow, state["maxv"])
        max_i = jnp.where(active & improved, i, state["max_i"])
        max_j = jnp.where(active & improved, mj, state["max_j"])
        max_off = jnp.where(
            active & improved,
            jnp.maximum(state["max_off"], jnp.abs(mj - i)),
            state["max_off"],
        )
        done_next = state["done"] | (i + 1 >= tlen) | (active & (brk_zero | brk_z))
        # window shrink scans over eh indices [beg, end]
        dead = (eh_h2 == 0) & (eh_e2 == 0)
        scan_mask = (jj >= beg[:, None]) & (jj <= end[:, None])
        alive = (~dead) & scan_mask
        any_alive = alive.any(axis=1)
        first_alive = jnp.argmax(alive, axis=1).astype(jnp.int32)
        beg2 = jnp.where(any_alive, first_alive, end)
        last_alive = (Q - jnp.argmax(alive[:, ::-1], axis=1)).astype(jnp.int32)
        jmax = jnp.where(any_alive, last_alive, beg2 - 1)
        end2 = jnp.minimum(jmax + 2, qlen)
        keep = active[:, None]
        new_state = dict(
            eh_h=jnp.where(keep, eh_h2, eh_h),
            eh_e=jnp.where(keep, eh_e2, eh_e),
            beg=jnp.where(active, beg2, state["beg"]),
            end=jnp.where(active, end2, state["end"]),
            done=done_next,
            maxv=maxv,
            max_i=max_i,
            max_j=max_j,
            max_ie=max_ie,
            gscore=gscore,
            max_off=max_off,
        )
        return new_state, None

    if early_exit:
        # embedded-wave driver (ops/pipeline_fused.py): rows advance in a
        # while_loop that stops at the batch's live max tlen / when every
        # lane breaks — a scan would pay all T padded rows every wave
        def w_cond(st):
            i, state = st
            return (i < jnp.max(jnp.where(state["done"], 0, tlen))) & (
                ~state["done"].all()
            )

        def w_body(st):
            i, state = st
            state, _ = row_step(state, i)
            return i + 1, state

        _, state = jax.lax.while_loop(w_cond, w_body, (jnp.int32(0), init))
    else:
        state, _ = jax.lax.scan(
            row_step, init, jnp.arange(T, dtype=jnp.int32)
        )
    return dict(
        score=state["maxv"],
        qle=state["max_j"] + 1,
        tle=state["max_i"] + 1,
        gtle=state["max_ie"] + 1,
        gscore=state["gscore"],
        max_off=state["max_off"],
    )


_WAVE_KEYS = ("gscore", "gtle", "max_off", "qle", "score", "tle")
_MAT_CACHE: dict = {}


def _device_mat(mat5: np.ndarray):
    """Constant-cache the scoring matrix's device buffer, so a wave does
    not pay a host->device copy for it."""
    key = mat5.tobytes()
    ent = _MAT_CACHE.get(key)
    if ent is None:
        ent = _MAT_CACHE[key] = jnp.asarray(mat5)
    return ent


@partial(
    jax.jit,
    static_argnames=(
        "Q", "T", "o_del", "e_del", "o_ins", "e_ins", "zdrop", "max_sc",
    ),
)
def _wave_entry(
    seqs8, scal, mat, Q: int, T: int, o_del, e_del, o_ins, e_ins, zdrop,
    max_sc,
):
    """One-wave entry: seqs8 [B, Q+T] int8 = qa | ta (codes 0-4; int8
    quarters the bytes of the host->device copy) and scal [B, 5] int32 =
    (qlen, tlen, h0, w, bonus); returns the results stacked [6, B] in
    _WAVE_KEYS order — ONE pull.  Slicing and widening happen inside the
    jit so the host never issues per-field transfers."""
    qa = seqs8[:, :Q].astype(jnp.int32)
    ta = seqs8[:, Q : Q + T].astype(jnp.int32)
    qlen = scal[:, 0]
    tlen = scal[:, 1]
    h0 = scal[:, 2]
    w = scal[:, 3]
    bon = scal[:, 4]
    out = ksw_extend_batch(
        qa, ta, qlen, tlen, h0, w, bon, mat, o_del, e_del, o_ins, e_ins,
        zdrop, max_sc,
    )
    return jnp.stack([out[k] for k in _WAVE_KEYS])


def ksw_extend_batch_np(
    qseqs, tseqs, mat, opt_params, h0s, ws, bonuses, bucket_q=None,
    bucket_t=None, mesh=None,
):
    """Host wrapper: list of numpy (qseq, tseq) jobs -> list of result dicts.

    mesh (explicit, preferred) or the active_mesh context shards the wave's
    batch dimension over the mesh devices.  The whole wave is ONE host->
    device transfer (a packed [B, Q+T+5] array), one dispatch, and ONE
    device->host pull (the [6, B] stacked results)."""
    from ..utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    o_del, e_del, o_ins, e_ins, zdrop = opt_params
    B = len(qseqs)
    Q = max(bucket_q or 0, max((len(q) for q in qseqs), default=1), 1)
    T = max(bucket_t or 0, max((len(t) for t in tseqs), default=1), 1)
    seqs8 = np.zeros((B, Q + T), dtype=np.int8)
    scal = np.zeros((B, 5), dtype=np.int32)
    for i, (q, t) in enumerate(zip(qseqs, tseqs)):
        seqs8[i, : len(q)] = q
        seqs8[i, Q : Q + len(t)] = t
        scal[i, 0] = len(q)
        scal[i, 1] = len(t)
    scal[:, 2] = h0s
    scal[:, 3] = ws
    scal[:, 4] = bonuses
    mat5 = np.asarray(mat, dtype=np.int32).reshape(5, 5)
    if mesh is None:
        mesh = _ACTIVE_MESH
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = tuple(mesh.axis_names)
        sh = NamedSharding(mesh, P(axes, None))
        seqs_d = jax.device_put(seqs8, sh)
        scal_d = jax.device_put(scal, sh)
    else:
        seqs_d = jnp.asarray(seqs8)
        scal_d = jnp.asarray(scal)
    stacked = np.asarray(
        _wave_entry(
            seqs_d, scal_d, _device_mat(mat5), Q, T, o_del, e_del, o_ins,
            e_ins, zdrop, int(mat5.max()),
        )
    )
    return [
        {k: int(stacked[j, i]) for j, k in enumerate(_WAVE_KEYS)}
        for i in range(B)
    ]
