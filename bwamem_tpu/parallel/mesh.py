"""Device mesh construction for the aligner's parallel axes.

The reference's entire parallelism story is pthreads-in-a-process plus
"copy the index to every node" (SURVEY.md section 2.3 inventory).  The
device-mesh equivalents are first-class here:

  * ``data``  — batches of reads, data-parallel (the kt_for / Spark analog)
  * ``idx``   — the occ/SA tables sharded across devices for references too
    large for one chip's int32 domain (pangenome scale); rank queries merge
    with psum over NVLink.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    idx_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over (data, idx); idx_shards divides the device count."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % idx_shards:
        raise ValueError(f"idx_shards {idx_shards} must divide device count {n}")
    arr = np.array(devs).reshape(n // idx_shards, idx_shards)
    return Mesh(arr, ("data", "idx"))


def shard_batch(mesh, *arrays):
    """device_put arrays with dim 0 (the batch) sharded over ALL mesh axes.

    The stage kernels are elementwise over their batch dimension, so XLA
    partitions the jitted computation across the mesh with no collectives.
    Batch sizes must divide the device count — the stage bucketing already
    rounds to multiples of 64.
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = tuple(mesh.axis_names)
    out = []
    for a in arrays:
        a = jnp.asarray(a)
        spec = P(axes, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return out[0] if len(out) == 1 else tuple(out)


def replicate(mesh, *arrays):
    """device_put arrays fully replicated over the mesh (index tables)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P())
    out = [jax.device_put(jnp.asarray(a), sh) for a in arrays]
    return out[0] if len(out) == 1 else tuple(out)
