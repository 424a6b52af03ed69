"""Suffix-array construction ON DEVICE: prefix doubling over XLA sort.

Device counterpart of the host SA-IS builder (index/native/sais.cpp) and
of the reference's suffix-array builders ([EXT] is.c / rope.c, linked per
src/main/c/Makefile:27; algorithm selector BwaMemIndex.java:46-80).  Instead
of induced sorting — a serial, random-access chase that cannot map to a
vector unit — the device builder uses the classic prefix-doubling
formulation (Manber–Myers): every round sorts (rank[i], rank[i+k]) key pairs
with XLA's lexicographic multi-key sort and re-ranks with a segmented
cumsum, doubling k.  O(n log n) total work, but every round is a full-array
sort + gather + scan, shapes an accelerator runs at memory bandwidth.

The loop is a `lax.while_loop` with a data-dependent exit (all ranks
distinct), so XLA compiles one round and iterates on device; there is no
host round-trip until the final SA is pulled.

Used by index/sais.py when BWAMEM_TPU_DEVICE_SA=1 (host SA-IS remains the
default; the device builder's speed on the card is not measured yet).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _doubling_round(rank, k, total):
    """One prefix-doubling round: sort by (rank[i], rank[i+k]), re-rank."""
    idx = jnp.arange(total, dtype=jnp.int32)
    # int32-overflow-safe: idx + k < total  <=>  idx < total - k (k <= total)
    in_range = idx < total - k
    shifted = jnp.where(in_range, idx + k, 0)
    second = jnp.where(in_range, rank[shifted], jnp.int32(-1))
    r_s, s_s, sa = lax.sort((rank, second, idx), num_keys=2, is_stable=True)
    bump = jnp.concatenate(
        [
            jnp.zeros(1, dtype=jnp.int32),
            ((r_s[1:] != r_s[:-1]) | (s_s[1:] != s_s[:-1])).astype(jnp.int32),
        ]
    )
    new_rank_sorted = jnp.cumsum(bump, dtype=jnp.int32)
    new_rank = jnp.zeros(total, dtype=jnp.int32).at[sa].set(new_rank_sorted)
    return new_rank, sa


def _suffix_array_fixed(codes: jnp.ndarray) -> jnp.ndarray:
    """SA of codes+sentinel (device). codes: uint8[n] -> int32[n+1]."""
    n = codes.shape[0]
    total = n + 1
    rank0 = jnp.concatenate(
        [codes.astype(jnp.int32) + 1, jnp.zeros(1, dtype=jnp.int32)]
    )
    # round 0 establishes ranks over single symbols
    rank, sa = _doubling_round(rank0, jnp.int32(0), total)

    def cond(state):
        rank, _, k = state
        return (jnp.max(rank) < total - 1) & (k < total)

    def body(state):
        rank, _, k = state
        new_rank, sa = _doubling_round(rank, k, total)
        # cap k at total before doubling can wrap int32; ranks are provably
        # distinct at k >= total (unique sentinel), so the cap only ends
        # the loop it would have ended anyway
        next_k = jnp.where(k >= (total + 1) // 2, jnp.int32(total), k * 2)
        return new_rank, sa, next_k

    _, sa, _ = lax.while_loop(cond, body, (rank, sa, jnp.int32(1)))
    return sa


_jitted = jax.jit(_suffix_array_fixed)


def suffix_array_device(codes: np.ndarray, device=None) -> np.ndarray:
    """Host entry: SA of codes+sentinel, computed on `device`; length n+1."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if len(codes) + 1 >= np.iinfo(np.int32).max:
        raise ValueError("device SA builder is int32-domain (< 2 Gbp)")
    x = jnp.asarray(codes)
    if device is not None:
        x = jax.device_put(x, device)
    sa = _jitted(x)
    return np.asarray(jax.device_get(sa), dtype=np.int64)
