"""Explicit execution configuration for the engine's device routing.

The reference's only execution knobs are `mem_opt_t` fields; everything
about WHERE work runs is implicit (pthreads in-process).  Here the routing
axes — device kernels per stage, cross-read wave extension, and a
``jax.sharding.Mesh`` to shard the device batches over — are an explicit,
immutable value threaded through the pipeline, so concurrent aligners on
different meshes never race (no process-global env mutation), and the
public surface (``BwaMemAligner(..., mesh=...)``, CLI ``--devices``) can
request mesh execution directly.

Env variables (BWAMEM_TPU_DEVICE_*) remain the *defaults* for fields left
as None, so the documented operational switches keep working.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Optional


def _env_bool(name: str) -> Optional[bool]:
    v = os.environ.get(name)
    if v is None:
        return None
    return v == "1"


@dataclass(frozen=True)
class ExecConfig:
    """Where the pipeline's stages run.  None = env-var / auto default."""

    mesh: Any = None  # jax.sharding.Mesh: shard device batches over it
    device_extend: Optional[bool] = None  # BWAMEM_TPU_DEVICE_EXTEND
    force_waves: Optional[bool] = None  # BWAMEM_TPU_FORCE_WAVES
    device_seed: Optional[bool] = None  # BWAMEM_TPU_DEVICE_SEED
    device_chain: Optional[bool] = None  # BWAMEM_TPU_DEVICE_CHAIN
    device_sa_lookup: Optional[bool] = None  # BWAMEM_TPU_DEVICE_SA_LOOKUP
    # ONE-dispatch seed+SA+chain+extend program (ops/pipeline_fused.py)
    device_pipeline: Optional[bool] = None  # BWAMEM_TPU_DEVICE_PIPELINE

    # ------------------------------------------------- resolved views
    def want_device_seed(self) -> bool:
        v = self.device_seed
        if v is None:
            v = _env_bool("BWAMEM_TPU_DEVICE_SEED")
        return bool(v)

    def want_device_chain(self) -> bool:
        v = self.device_chain
        if v is None:
            v = _env_bool("BWAMEM_TPU_DEVICE_CHAIN")
        return bool(v)

    def want_device_sa_lookup(self) -> bool:
        v = self.device_sa_lookup
        if v is None:
            v = _env_bool("BWAMEM_TPU_DEVICE_SA_LOOKUP")
        return bool(v)

    def want_device_pipeline(self) -> bool:
        v = self.device_pipeline
        if v is None:
            v = _env_bool("BWAMEM_TPU_DEVICE_PIPELINE")
        return bool(v)

    def want_force_waves(self) -> bool:
        v = self.force_waves
        if v is None:
            v = _env_bool("BWAMEM_TPU_FORCE_WAVES")
        return bool(v)

    def resolve_device_extend(self, n_jobs: int, min_jobs: int) -> bool:
        """Extension-wave routing: explicit > env; unset means host waves."""
        v = self.device_extend
        if v is None:
            v = _env_bool("BWAMEM_TPU_DEVICE_EXTEND")
        return bool(v) and n_jobs >= min_jobs

    def any_device_stage(self) -> bool:
        return (
            self.mesh is not None
            or self.want_force_waves()
            or self.want_device_seed()
            or self.want_device_chain()
            or self.want_device_sa_lookup()
            or self.want_device_pipeline()
        )

    def with_(self, **kw) -> "ExecConfig":
        return replace(self, **kw)


DEFAULT = ExecConfig()


def mesh_exec(mesh, device_stages=()) -> ExecConfig:
    """The mesh execution profile: extension always in sharded device
    waves; optionally the seed/chain/sa_lookup device kernels too."""
    stages = set(device_stages)
    unknown = stages - {"seed", "chain", "sa_lookup"}
    if unknown:
        raise ValueError(f"unknown device stages: {sorted(unknown)}")
    return ExecConfig(
        mesh=mesh,
        device_extend=True,
        force_waves=True,
        device_seed="seed" in stages or None,
        device_chain="chain" in stages or None,
        device_sa_lookup="sa_lookup" in stages or None,
    )
