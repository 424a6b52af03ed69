"""Data-parallel alignment step over a device mesh.

Replaces the reference's two parallelism layers (kt_for worker pool inside
libbwa + documented one-mmap-per-JVM cluster use, SURVEY.md section 2.3)
with jax.sharding: read batches shard over the ``data`` axis, the FM-index
either replicates per device (GRCh38-class) or shards its occ tables over
``idx`` (pangenome-class), and collectives ride NVLink between cards.
"""
from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.extend_tpu import ksw_extend_batch
from ..ops.fmindex_tpu import make_occ4_sharded


def shard_extension_args(mesh: Mesh, args: Dict[str, np.ndarray]):
    """Place a batch of extension-job arrays with the batch dim on `data`."""
    batch_sharding = NamedSharding(mesh, P(("data", "idx")))
    row_sharding = NamedSharding(mesh, P(("data", "idx"), None))
    out = {}
    for k, v in args.items():
        spec = row_sharding if v.ndim == 2 else batch_sharding
        out[k] = jax.device_put(jnp.asarray(v), spec)
    return out


def make_dp_extend_step(mesh: Mesh, o_del, e_del, o_ins, e_ins, zdrop, max_sc):
    """jit-compiled data-parallel extension step.

    The kernel itself is elementwise over the batch, so sharding the batch
    axis makes XLA partition it with zero communication; output shardings
    follow the inputs.
    """

    @jax.jit
    def step(qseq, tseq, qlen, tlen, h0, w, end_bonus, mat):
        return ksw_extend_batch(
            qseq, tseq, qlen, tlen, h0, w, end_bonus, mat,
            o_del, e_del, o_ins, e_ins, zdrop, max_sc,
        )

    return step


def make_sharded_occ_step(mesh: Mesh):
    """Occ4 rank-query step with the checkpoint tables sharded over `idx`."""
    return make_occ4_sharded(mesh, "idx")


def full_parallel_step(mesh: Mesh, opt_mat: np.ndarray, opts):
    """One combined device step exercising both parallel axes:

    data-parallel SW extension + idx-sharded occ rank queries.  This is the
    shape of the production inner loop; the host pipeline feeds it batches.
    """
    extend_step = make_dp_extend_step(
        mesh, opts.o_del, opts.e_del, opts.o_ins, opts.e_ins, opts.zdrop,
        int(np.max(opt_mat)),
    )
    occ_step = make_sharded_occ_step(mesh)

    def step(ext_args, occ_args):
        ext_out = extend_step(**ext_args)
        occ_out = occ_step(**occ_args)
        return ext_out, occ_out

    return step
