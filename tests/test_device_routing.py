"""Where device work goes: extension-wave routing, the wave kernel, the
compile cache, and the fused program's fallback causes."""
import os

import jax
import numpy as np
import pytest

from bwamem_tpu.api.options import MemOptions
from bwamem_tpu.engine.exec_ctx import ExecConfig, mesh_exec
from bwamem_tpu.utils import compile_cache


@pytest.mark.parametrize(
    "cfg,env,n_jobs,want",
    [
        (ExecConfig(), None, 10_000, False),  # unset: host waves
        (ExecConfig(), "1", 10_000, True),
        (ExecConfig(), "1", 3, False),  # below the wave minimum
        (ExecConfig(), "0", 10_000, False),
        (ExecConfig(device_extend=True), "0", 10_000, True),  # explicit wins
        (ExecConfig(device_extend=False), "1", 10_000, False),
        (mesh_exec(object()), None, 10_000, True),  # a mesh forces waves
    ],
    ids=["unset", "env1", "env1-small", "env0", "explicit-on",
         "explicit-off", "mesh"],
)
def test_resolve_device_extend(monkeypatch, cfg, env, n_jobs, want):
    if env is None:
        monkeypatch.delenv("BWAMEM_TPU_DEVICE_EXTEND", raising=False)
    else:
        monkeypatch.setenv("BWAMEM_TPU_DEVICE_EXTEND", env)
    assert cfg.resolve_device_extend(n_jobs, 48) is want


def test_explicit_env_keeps_waves_on_host(monkeypatch):
    """BWAMEM_TPU_DEVICE_EXTEND=0 keeps a wave that qualifies by size on
    the host kernels, with results equal to the device route."""
    from bwamem_tpu.engine import extend_batch
    from bwamem_tpu.utils import metrics

    opt = MemOptions()
    rng = np.random.default_rng(3)
    jobs = [(rng.integers(0, 4, 30).astype(np.uint8),
             rng.integers(0, 4, 40).astype(np.uint8))
            for _ in range(extend_batch.HOST_FALLBACK_JOBS)]
    args = ([5] * len(jobs), [100] * len(jobs), [30] * len(jobs))
    monkeypatch.setenv("BWAMEM_TPU_DEVICE_EXTEND", "0")
    metrics.reset()
    host = extend_batch._run_kernel(opt, jobs, *args)
    assert metrics.snapshot()["counters"].get("device_extend_waves", 0) == 0
    monkeypatch.setenv("BWAMEM_TPU_DEVICE_EXTEND", "1")
    dev = extend_batch._run_kernel(opt, jobs, *args)
    assert metrics.snapshot()["counters"]["device_extend_waves"] == 1
    assert [{k: int(v) for k, v in d.items()} for d in dev] == [
        {k: int(v) for k, v in d.items()} for d in host
    ]


def test_wave_entry_always_runs_the_scan(monkeypatch):
    """Every device wave traces ksw_extend_batch; there is no other
    kernel and no switch to pick one."""
    import inspect

    from bwamem_tpu.ops import extend_tpu

    assert list(inspect.signature(extend_tpu._wave_entry).parameters) == [
        "seqs8", "scal", "mat", "Q", "T", "o_del", "e_del", "o_ins",
        "e_ins", "zdrop", "max_sc",
    ]
    calls = []
    real = extend_tpu.ksw_extend_batch

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(extend_tpu, "ksw_extend_batch", spy)
    opt = MemOptions()
    rng = np.random.default_rng(2)
    qs = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in (5, 17, 33)]
    ts = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in (9, 23, 71)]
    params = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)
    # bucket widths no other test uses, so the jitted entry traces anew
    out = extend_tpu.ksw_extend_batch_np(
        qs, ts, opt.mat, params, [20, 30, 40], [100] * 3, [0, 5, 0],
        bucket_q=41, bucket_t=83,
    )
    assert calls == [(3, 41)]
    from bwamem_tpu.engine.extend import ksw_extend2

    for (q, t), h0, b, got in zip(zip(qs, ts), [20, 30, 40], [0, 5, 0], out):
        e = ksw_extend2(q, t, opt.mat, *params[:4], 100, b, opt.zdrop, h0)
        assert got == dict(gscore=e.gscore, gtle=e.gtle, max_off=e.max_off,
                           qle=e.qle, score=e.score, tle=e.tle)


@pytest.fixture
def cache_config():
    """Restore JAX's compile-cache directory after the test."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.CACHE_DIR == want
    assert compile_cache.ensure_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("env", ["/elsewhere/cache", ""])
def test_compile_cache_env_wins(monkeypatch, cache_config, env):
    """With JAX_COMPILATION_CACHE_DIR set (even empty, which turns the
    cache off) the code sets no directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.ensure_compile_cache() == env
    assert jax.config.jax_compilation_cache_dir is None


def test_fused_fallbacks_reported_by_cause():
    """A read past the mem_flt_chained_seeds threshold falls back as
    'long_read', and records stay equal to the host oracle path."""
    from bwamem_tpu.engine.pipeline import Engine, align_regs_batch
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.ops.pipeline_fused import OVF_CAUSES
    from bwamem_tpu.utils import metrics
    from bwamem_tpu.utils.fasta import Fasta, FastaContig

    assert len(set(OVF_CAUSES.values())) == len(OVF_CAUSES)
    assert all(b & (b - 1) == 0 for b in OVF_CAUSES.values())  # one bit each
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 20_000).astype(np.uint8)
    eng = Engine(build_index(Fasta([FastaContig("c", "", codes)])))
    reads = [codes[100:250].copy(), codes[5_000:5_900].copy(),
             codes[9_000:9_120].copy()]
    opt = MemOptions()
    metrics.reset()
    got = align_regs_batch(
        opt, eng, reads, exec_cfg=ExecConfig(device_pipeline=True)
    )
    ctr = metrics.snapshot()["counters"]
    assert ctr["device_fused_pipeline_fallbacks"] == 1
    assert ctr["device_fused_pipeline_fallbacks_long_read"] == 1
    want = align_regs_batch(opt, eng, reads, use_device_extension=False)
    assert [[(r.rb, r.re, r.qb, r.qe, r.score) for r in g] for g in got] == [
        [(r.rb, r.re, r.qb, r.qe, r.score) for r in w] for w in want
    ]
