"""Multi-host distribution.

The reference's cluster story is a documented pattern, not code: ship the
index image to every node with Yarn --files, mmap once per JVM, align
Spark partitions independently (BwaMemIndex.java:22-27).  Here it is
first-class:

  * hosts join a jax.distributed job (NVLink within a host, the network
    across hosts),
  * each host opens the same index image (replicated; the mmap/page-cache
    sharing property of the flat image carries over),
  * read batches shard per host by ordinal; each host runs the batched
    engine over its shard,
  * per-shard records merge into one coordinate-complete SAM stream via a
    host all-gather.

On a single-host dev box this degrades gracefully to local sharding over
processes=1 (tests exercise the shard/merge logic directly).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join (or no-op on single host) the distributed runtime.

    Returns (process_id, num_processes)."""
    import jax

    if coordinator is None:
        return 0, 1
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index(), jax.process_count()


def shard_bounds(n_items: int, process_id: int, num_processes: int) -> Tuple[int, int]:
    """Contiguous [lo, hi) shard of a batch for this host."""
    per = (n_items + num_processes - 1) // num_processes
    lo = min(process_id * per, n_items)
    return lo, min(lo + per, n_items)


def align_shard(
    aligner,
    reads: Sequence[bytes],
    process_id: int,
    num_processes: int,
) -> Tuple[int, List]:
    """Align this host's shard; returns (global_offset, records)."""
    lo, hi = shard_bounds(len(reads), process_id, num_processes)
    return lo, aligner.align_seqs(list(reads[lo:hi]))


def merge_shards(
    shards: Iterable[Tuple[int, List]], n_items: int
) -> List:
    """Merge per-host results back into input order (coordinate-complete:
    every read's records end up at its original ordinal)."""
    out: List = [None] * n_items
    for lo, recs in shards:
        for i, r in enumerate(recs):
            out[lo + i] = r
    missing = sum(1 for r in out if r is None)
    if missing:
        raise RuntimeError(f"merge incomplete: {missing} reads unaccounted")
    return out
