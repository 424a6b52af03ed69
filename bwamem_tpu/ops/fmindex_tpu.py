"""Device-resident FM-index: batched Occ rank queries on the device.

Device replacement for the reference's hot loop #1 — the memory-bound
random Occ() lookups of [EXT] bwt.c's backward search (SURVEY.md 3.3).

Layout (r04): ONE fused line per checkpoint block — `lines[b] =
[count_A..count_T (4 x u32), packed BWT words (span/16 x u32)]` — so a
rank query is a SINGLE row gather plus SWAR popcounts, where a split
layout (separate ckpt[idx] + words[idx] arrays) needs two dependent
gathers; benchmarks/gather_probe.py times both forms on the card.
`span` (chars per line) is a
power-of-two multiple of the host oracle's 128-char blocks.

Coordinate domain: row indices / interval bounds use int32 for references
under 2 Gbp of doubled sequence and int64 above (bwa's 64-bit bwtint_t,
[EXT] bwt.h) — GRCh38-scale references ride the same kernels with the
wider coordinate dtype (arrays are created and kernels traced under
jax.experimental.enable_x64).  Block indices, within-block offsets and
per-symbol counts always fit int32 (per-symbol counts < 2^31 even at
6.2e9 rows; asserted at load).  Sharding the line table across devices
(make_occ4_sharded) additionally serves pangenome-scale indexes.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..engine.fmindex import FMIndex


def _x64_ctx(enable: bool):
    """Trace/creation context for the int64 coordinate domain."""
    if enable:
        return jax.enable_x64(True)
    return contextlib.nullcontext()


# --------------------------------------------------------------------------
# idx-sharded tables (pangenome layout, SURVEY.md section 5): when the
# sharded_tables context is active, every checkpoint-line / sampled-SA
# fetch is the local-shard gather + psum merge, so ALL kernels built on
# _rows_for (occ4, bwt_extend, the SMEM bodies, the SA walk) run unchanged
# under a shard_map whose in_spec shards the tables over `axis`.  The
# context is consulted at TRACE time — activate it around the shard_map
# call.  Collectives ride the mesh axis (NVLink between cards).
# --------------------------------------------------------------------------
_SHARD_CTX = None  # (axis_name, blocks_per_shard, sa_per_shard)


@contextlib.contextmanager
def sharded_tables(axis: str, blocks_per_shard: int, sa_per_shard: int = 0):
    global _SHARD_CTX
    prev = _SHARD_CTX
    _SHARD_CTX = (axis, blocks_per_shard, sa_per_shard)
    try:
        yield
    finally:
        _SHARD_CTX = prev


def _shard_gather(table, idx, per_shard: int, axis: str):
    """table[idx] where each device holds a contiguous [per_shard] slice:
    answer locally-owned rows, zero elsewhere, psum-merge."""
    shard = jax.lax.axis_index(axis).astype(idx.dtype)
    lo = shard * per_shard
    n_local = table.shape[0]
    mine = (idx >= lo) & (idx < lo + n_local)
    local = jnp.clip(idx - lo, 0, n_local - 1).astype(jnp.int32)
    got = table[local]
    mask = mine.reshape(mine.shape + (1,) * (got.ndim - mine.ndim))
    got = jnp.where(mask, got, jnp.zeros((), got.dtype))
    return jax.lax.psum(got, axis)


def _fetch_lines(lines, block):
    if _SHARD_CTX is None:
        return lines[block]
    axis, bps, _ = _SHARD_CTX
    return _shard_gather(lines, block, bps, axis)


def _fetch_sa(sa, idx):
    if _SHARD_CTX is None:
        return sa[idx]
    axis, _, sps = _SHARD_CTX
    return _shard_gather(sa, idx, sps, axis)


@dataclass(frozen=True)
class DeviceFMIndex:
    """FM-index on device: fused occ lines + sampled SA + static scalars."""

    lines: jax.Array  # [nb, 4 + span//16] uint32 fused counts+words rows
    L2: jax.Array  # [5] coord dtype (int32 / int64)
    sa: jax.Array  # [n_sa] coord dtype, sampled suffix array (sa[0] == -1)
    primary: int
    seq_len: int
    sa_intv: int
    span: int  # chars per line; power-of-two multiple of 128

    @property
    def coord_dtype(self):
        return self.L2.dtype

    @property
    def big(self) -> bool:
        return self.L2.dtype == jnp.int64

    def ctx(self):
        """Context manager under which the int64-domain kernels trace."""
        return _x64_ctx(self.big)

    @classmethod
    def from_host(
        cls, fm: FMIndex, span: int = 128, force_big: bool = False
    ) -> "DeviceFMIndex":
        """force_big traces the int64 kernels on a small index (tests)."""
        if span % 128 or span & (span - 1):
            raise ValueError("span must be a power-of-two multiple of 128")
        per_sym = np.diff(np.asarray(fm.L2).astype(np.int64))
        if (per_sym >= (1 << 31)).any():
            raise ValueError(
                "per-symbol occ counts exceed int32; shard the occ table "
                "across devices (make_occ4_sharded) instead"
            )
        big = force_big or fm.seq_len >= (1 << 31)
        m = span // 128
        nb128 = fm.words.shape[0]
        nb = -(-fm.seq_len // span) or 1
        counts = np.ascontiguousarray(
            fm.ckpt[: nb * m : m].astype(np.uint32)
        )
        words = np.zeros((nb * m, 8), dtype=np.uint32)
        words[:nb128] = fm.words
        lines = np.concatenate(
            [counts, words.reshape(nb, 8 * m)], axis=1
        )
        cdt = np.int64 if big else np.int32
        with _x64_ctx(big):
            return cls(
                lines=jnp.asarray(lines),
                L2=jnp.asarray(np.asarray(fm.L2, dtype=cdt)),
                sa=jnp.asarray(fm.sa.astype(cdt)),
                primary=int(fm.primary),
                seq_len=int(fm.seq_len),
                sa_intv=int(fm.sa_intv),
                span=span,
            )


_M55 = jnp.uint32(0x55555555)
_M33 = jnp.uint32(0x33333333)
_M0F = jnp.uint32(0x0F0F0F0F)


def _select_col(mat, idx):
    """mat[i, idx[i]] as a W-way vectorized select, not a gather.

    For the small fixed widths here (4 count columns, span//16 words) a
    chain of ``where`` ops is elementwise work next to the line gather.
    mat: [N, W] (or [N, W] broadcastable); idx: [N] int32 in [0, W).
    """
    W = mat.shape[1]
    out = mat[:, 0]
    for w in range(1, W):
        out = jnp.where(idx == w, mat[:, w], out)
    return out


def _popcount32(x):
    x = x - ((x >> jnp.uint32(1)) & _M55)
    x = (x & _M33) + ((x >> jnp.uint32(2)) & _M33)
    x = (x + (x >> jnp.uint32(4))) & _M0F
    return (x * jnp.uint32(0x01010101)) >> jnp.uint32(24)


def _keep_masks(nw: int, nchars):
    """Per-word masks selecting each word's first chars up to nchars total.

    nchars: [N] int32 in [0, 16*nw].  Returns [N, nw] uint32 with the
    2-bit slots of counted chars set (aligned to the LOW bit of each
    pair, i.e. matching the _M55 plane convention).
    """
    word_base = (jnp.arange(nw, dtype=jnp.int32) * 16)[None, :]
    valid = jnp.clip(nchars[:, None] - word_base, 0, 16).astype(jnp.uint32)
    shift = jnp.uint32(32) - jnp.uint32(2) * valid
    full = jnp.uint32(0xFFFFFFFF)
    keep = jnp.where(
        valid == 0,
        jnp.uint32(0),
        (full << jnp.minimum(shift, jnp.uint32(31))).astype(jnp.uint32),
    )
    return jnp.where(valid == 16, full, keep) & _M55


def _block_counts4(words, nchars):
    """Counts of all 4 symbols among the first nchars chars of each block.

    words: [N, nw] uint32; nchars: [N] int32 in [0, 16*nw].  Returns
    [N, 4] int32.  char j of word w occupies bits {31-2j (hi), 30-2j
    (lo)}; both planes align to the low bit so masks line up.
    """
    keep = _keep_masks(words.shape[1], nchars)
    hi = (words >> jnp.uint32(1)) & _M55
    lo = words & _M55
    out = []
    for c in range(4):
        hi_m = hi if (c >> 1) else (~hi & _M55)
        lo_m = lo if (c & 1) else (~lo & _M55)
        sel = hi_m & lo_m & keep
        out.append(jnp.sum(_popcount32(sel), axis=1).astype(jnp.int32))
    return jnp.stack(out, axis=1)  # [N, 4]


def _block_count1(words, nchars, c):
    """Count of per-row symbol c [N] among the first nchars chars."""
    keep = _keep_masks(words.shape[1], nchars)
    hi = (words >> jnp.uint32(1)) & _M55
    lo = words & _M55
    chi = (c[:, None] >> 1).astype(jnp.uint32)
    clo = (c[:, None] & 1).astype(jnp.uint32)
    hi_m = jnp.where(chi != 0, hi, ~hi & _M55)
    lo_m = jnp.where(clo != 0, lo, ~lo & _M55)
    sel = hi_m & lo_m & keep
    return jnp.sum(_popcount32(sel), axis=1).astype(jnp.int32)


def _rows_for(lines, k, primary, span: int):
    """Fused-line row + inclusive char count for conceptual positions k.

    Returns (row [N, W] u32, within [N] int32 = chars of the block counted
    through k).  Callers handle the k == -1 / k == seq_len sentinels.
    """
    kk = k - (k >= primary).astype(k.dtype)
    kk = jnp.clip(kk, 0, None)
    lg = span.bit_length() - 1
    block = (kk >> lg).astype(jnp.int32)
    within = (kk & (span - 1)).astype(jnp.int32) + 1
    return _fetch_lines(lines, block), within


@partial(jax.jit, static_argnames=("primary", "seq_len", "span"))
def occ4_device(lines, L2, k, primary: int, seq_len: int, span: int):
    """bwa bwt_occ4 semantics for a batch of conceptual positions k [N].

    Counts of each symbol among conceptual BWT chars [0..k] inclusive;
    k == -1 -> 0, k == seq_len -> full counts.  Returns [N, 4] int32.
    """
    is_all = k == seq_len
    is_none = k == -1
    row, within = _rows_for(lines, k, primary, span)
    base = jax.lax.bitcast_convert_type(row[:, :4], jnp.int32)
    cnt = base + _block_counts4(row[:, 4:], within)
    full = (L2[1:5] - L2[0:4])[None, :].astype(jnp.int32)
    cnt = jnp.where(is_all[:, None], full, cnt)
    cnt = jnp.where(is_none[:, None], 0, cnt)
    return cnt


def occ4(dfm: DeviceFMIndex, k) -> jax.Array:
    with dfm.ctx():
        return occ4_device(
            dfm.lines, dfm.L2, jnp.asarray(k).astype(dfm.coord_dtype),
            dfm.primary, dfm.seq_len, dfm.span,
        )


def _extend_core(lines, L2, x0, x1, s, primary, seq_len, span, is_back):
    """Shared bwt_extend body: ONE fused gather for both rank queries."""
    xq = x0 if is_back else x1
    xo = x1 if is_back else x0
    n = xq.shape[0]
    ks = jnp.concatenate([xq - 1, xq - 1 + s.astype(xq.dtype)])
    both = occ4_device(lines, L2, ks, primary, seq_len, span)
    tk, tl = both[:n], both[n:]
    new_q = L2[None, :4] + 1 + tk
    sz = tl - tk
    has_sent = ((xq <= primary) & (xq + s - 1 >= primary)).astype(xq.dtype)
    o3 = xo + has_sent
    o2 = o3 + sz[:, 3]
    o1 = o2 + sz[:, 2]
    o0 = o1 + sz[:, 1]
    new_o = jnp.stack([o0, o1, o2, o3], axis=1)
    if is_back:
        return new_q, new_o, sz
    return new_o, new_q, sz


@partial(jax.jit, static_argnames=("primary", "seq_len", "span", "is_back"))
def extend_device(
    lines, L2, x0, x1, s, primary: int, seq_len: int, span: int, is_back: bool
):
    """Batched bidirectional bwt_extend; mirrors FMIndex.extend exactly.

    Returns (ox0, ox1, sz): ox* [N, 4] coord dtype indexed by queried-space
    symbol (bwa ok[] convention — see engine/fmindex.py docstring), sz
    [N, 4] int32.
    """
    return _extend_core(lines, L2, x0, x1, s, primary, seq_len, span, is_back)


def make_occ4_sharded(mesh, axis: str):
    """Occ4 with the fused line table sharded across `axis`.

    Each device holds a contiguous slice of lines; queries are replicated,
    each shard answers the ones whose line it owns, and a psum merges.
    This is the pangenome-scale layout from SURVEY.md section 5 (sharded
    occ tables; the psum rides NVLink between cards).
    """
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    def _sharded(lines, L2, k, primary, seq_len, span, blocks_per_shard):
        lg = int(span).bit_length() - 1

        def body(lines_s, L2_f, k_f):
            shard = jax.lax.axis_index(axis)
            lo = (shard * blocks_per_shard).astype(k_f.dtype)
            kk = k_f - (k_f >= primary).astype(k_f.dtype)
            kk = jnp.clip(kk, 0, None)
            block = kk >> lg
            mine = (block >= lo) & (block < lo + lines_s.shape[0])
            local = jnp.clip(block - lo, 0, lines_s.shape[0] - 1).astype(
                jnp.int32
            )
            within = (kk & (span - 1)).astype(jnp.int32) + 1
            row = jnp.where(mine[:, None], lines_s[local], jnp.uint32(0))
            base = jax.lax.bitcast_convert_type(row[:, :4], jnp.int32)
            cnt = base + _block_counts4(row[:, 4:], within)
            cnt = jnp.where(mine[:, None], cnt, 0)
            cnt = jax.lax.psum(cnt, axis)
            full = (L2_f[1:5] - L2_f[0:4])[None, :].astype(jnp.int32)
            cnt = jnp.where((k_f == seq_len)[:, None], full, cnt)
            cnt = jnp.where((k_f == -1)[:, None], 0, cnt)
            return cnt

        return shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis, None), P(), P()),
            out_specs=P(),
        )(lines, L2, k)

    return _sharded


# ---------------------------------------------------------------------------
# sampled-SA resolution ([EXT] bwt_sa)
# ---------------------------------------------------------------------------


def _sa_tick(lines, L2, k, steps, act, primary, span):
    """One LF step for active lanes: ONE fused gather serves both the BWT
    char at k and the inclusive occ count (same line: for k != primary the
    char offset is the count offset minus one, and k == primary lanes are
    overridden to row 0)."""
    at_p = k == primary
    row, within = _rows_for(lines, k, primary, span)
    # char at conceptual k (strictly-greater shift; within-1 of the
    # inclusive count offset — identical row except at k == primary,
    # where the result is masked anyway)
    wc = within - 1
    word = _select_col(row[:, 4:], wc >> 4)
    shift = (jnp.uint32(30) - jnp.uint32(2) * (wc & 15).astype(jnp.uint32))
    c = ((word >> shift) & jnp.uint32(3)).astype(jnp.int32)
    base = jax.lax.bitcast_convert_type(row[:, :4], jnp.int32)
    cnt = _select_col(base, c) + _block_count1(row[:, 4:], within, c)
    nk = L2[c] + cnt.astype(k.dtype)
    nk = jnp.where(at_p, 0, nk)
    k = jnp.where(act, nk, k)
    steps = steps + act.astype(jnp.int32)
    return k, steps


def sa_lookup_body(
    lines, L2, sa, k, primary: int, seq_len: int, sa_intv: int, span: int
):
    """Sampled-SA resolution for a batch of conceptual rows ([EXT] bwt_sa).

    Plain traced body (used by ops/seed_fused.py); sa_lookup_kernel is the
    standalone jitted wrapper.

    Each row walks k -> LF(k) until it hits a sampled row.  The walk runs
    as a compaction ladder: fixed lockstep rounds over the full batch,
    then the still-unfinished lanes are packed (stable cumsum partition)
    into a quarter-width array, repeatedly, so total gather work tracks
    SUM of steps instead of lockstep's MAX x batch.  sa[0] == -1 is
    load-bearing exactly as in the host oracle (engine/fmindex.py)."""
    B = k.shape[0]
    steps = jnp.zeros(B, jnp.int32)

    def run_fori(nt, k, steps):
        def body(_, st):
            k, steps = st
            act = (k % sa_intv) != 0
            return _sa_tick(lines, L2, k, steps, act, primary, span)

        return jax.lax.fori_loop(0, nt, body, (k, steps))

    def run_while(k, steps):
        def cond(st):
            return ((st[0] % sa_intv) != 0).any()

        def body(st):
            k, steps = st
            act = (k % sa_intv) != 0
            return _sa_tick(lines, L2, k, steps, act, primary, span)

        return jax.lax.while_loop(cond, body, (k, steps))

    # ladder: intv lockstep ticks at full width (survivor fraction
    # ~(1-1/intv)^intv ~ e^-1), then pack the unfinished lanes into a
    # half-width slice, quarter, sixteenth — another intv ticks each — so
    # total gather work tracks SUM of steps instead of lockstep's
    # MAX x batch, with ~2x safety margin at every pack (e^-1 < 1/2,
    # e^-2 < 1/4, e^-3 < 1/16).  A final full-width while_loop is the
    # correctness net for the rare case a slice overflowed (its cond is
    # simply false when the ladder finished everything).
    k, steps = run_fori(sa_intv, k, steps)
    orig = jnp.arange(B, dtype=jnp.int32)
    # under idx-sharded tables, skip the compaction ladder: its
    # data-dependent lax.cond stages would wrap collectives in a branch
    # (unsupported under shard_map); the plain lockstep loop is exact
    widths = (
        []
        if _SHARD_CTX is not None
        else [w for w in (B // 2, B // 4, B // 16) if w >= 256]
    )
    for i, width in enumerate(widths):
        unfin = (k % sa_intv) != 0
        n_unfin = unfin.sum()
        # stable partition, unfinished lanes first, as a sort-based gather
        # (argsort) rather than a B-wide permutation scatter
        order = jnp.argsort(jnp.where(unfin, 0, 1), stable=True)
        k = k[order]
        steps = steps[order]
        orig = orig[order]
        last = i == len(widths) - 1

        def stage(kw, sw, last=last):
            kw, sw = run_fori(sa_intv, kw, sw)
            if last:
                kw, sw = run_while(kw, sw)
            return kw, sw

        fits = n_unfin <= width
        k_sub, s_sub = jax.lax.cond(
            fits,
            stage,
            lambda a, b: (a, b),
            k[:width], steps[:width],
        )
        k = k.at[:width].set(k_sub)
        steps = steps.at[:width].set(s_sub)
    # safety net: finish any stragglers at full width
    k, steps = run_while(k, steps)
    out = _fetch_sa(sa, (k // sa_intv).astype(jnp.int32)) + steps.astype(
        k.dtype
    )
    # un-permute to input order: inverse-permutation gather, not a scatter
    return out[jnp.argsort(orig, stable=True)]


sa_lookup_kernel = partial(
    jax.jit, static_argnames=("primary", "seq_len", "sa_intv", "span")
)(sa_lookup_body)


def sa_lookup(dfm: DeviceFMIndex, k) -> jax.Array:
    """Device bwt_sa over a batch of rows; exact vs FMIndex.sa_lookup."""
    with dfm.ctx():
        return sa_lookup_kernel(
            dfm.lines, dfm.L2, dfm.sa,
            jnp.asarray(k).astype(dfm.coord_dtype),
            dfm.primary, dfm.seq_len, dfm.sa_intv, dfm.span,
        )
