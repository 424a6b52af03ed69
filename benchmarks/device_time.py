"""Per-kernel device time (one process; run alone on the card).

Every kernel runs K iterations inside ONE jitted ``lax.fori_loop`` whose
carry feeds the next iteration's inputs through a value-zero-but-opaque
perturbation (``min(carry, 0)`` where the carry is provably >= 0 at
runtime but not to XLA), and folds in a reduction over every output
element, so:

  * the loop cannot be CSE'd/hoisted (each iteration depends on the last),
  * XLA cannot narrow the kernel to the few outputs a partial read needs,
  * dispatch and the host pull are paid once per measurement, not per
    iteration,
  * per-iteration device time = slope between t(K_small) and t(K_big).

    python benchmarks/device_time.py [--json PATH]

Hot-kernel anchors: [EXT] ksw.c ksw_extend2 (jnibwa.c:214 via
mem_process_seqs) and [EXT] bwt.c occ/backward-search (SURVEY.md section 3.3).
"""
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _pull(x):
    return int(np.asarray(x).ravel()[0])


def slope_time(make_run, k_small, k_big, reps=3):
    """Per-iteration seconds from the (t(k_big)-t(k_small)) slope."""
    run_s, run_b = make_run(k_small), make_run(k_big)
    _pull(run_s())  # compile + warm
    _pull(run_b())
    best_s = best_b = float("inf")
    for _ in range(reps):
        t0 = time.time()
        _pull(run_s())
        best_s = min(best_s, time.time() - t0)
        t0 = time.time()
        _pull(run_b())
        best_b = min(best_b, time.time() - t0)
    return (best_b - best_s) / (k_big - k_small)


def main():
    import jax
    import jax.numpy as jnp

    from bwamem_tpu.api.options import MemOptions
    from bwamem_tpu.engine.fmindex import FMIndex
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.ops.extend_tpu import ksw_extend_batch
    from bwamem_tpu.ops.fmindex_tpu import (
        DeviceFMIndex, occ4_device, sa_lookup_kernel,
    )
    from bwamem_tpu.ops.smem_tpu import smem1a_batch_kernel
    from bwamem_tpu.utils.fasta import Fasta, FastaContig

    print("devices:", jax.devices(), flush=True)
    results = {
        "platform": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
        "device_kind": jax.devices()[0].device_kind,
        "method": (
            "K chained kernel iterations inside one lax.fori_loop (carry "
            "perturbs inputs by min(carry,0)==0, opaque to XLA); device "
            "time/iter = slope between K_small and K_big; one host pull "
            "per measurement"
        ),
    }
    opt = MemOptions()
    mat5 = jnp.asarray(np.asarray(opt.mat, dtype=np.int32).reshape(5, 5))
    kw = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100, max_sc=1)
    rng = np.random.default_rng(0)

    # ---- banded-SW extension (the XLA row loop) ----
    # HOMOLOGOUS pairs (target = query + 1% SNPs + homologous tail): the
    # extension stays alive for all T rows, so early-exit kernels cannot
    # dodge work and GCUPS counts genuinely-computed cells.  Exactness on
    # the card is chip_smoke.py's kernel phase.
    B, Q, T = 2048, 128, 256
    qa_np = rng.integers(0, 4, (B, Q)).astype(np.int32)
    ta_np = np.empty((B, T), dtype=np.int32)
    ta_np[:, :Q] = qa_np
    ta_np[:, Q:] = rng.integers(0, 4, (B, T - Q))
    muts = rng.random((B, T)) < 0.01
    ta_np[muts] = (ta_np[muts] + 1 + rng.integers(0, 3, muts.sum())) % 4
    qa = jnp.asarray(qa_np)
    ta = jnp.asarray(ta_np)
    qlen = jnp.full(B, Q, jnp.int32)
    tlen = jnp.full(B, T, jnp.int32)
    h0 = jnp.full(B, 30, jnp.int32)
    wv = jnp.full(B, 100, jnp.int32)
    bon = jnp.full(B, 5, jnp.int32)
    cells = B * Q * T

    def extend_loop(kernel):
        def make(K):
            @jax.jit
            def run():
                def body(_, c):
                    out = kernel(
                        qa, ta, qlen, tlen, h0 + jnp.minimum(c, 0), wv, bon,
                        mat5, **kw,
                    )
                    return c + (jnp.sum(out["score"]) % 2).astype(jnp.int32)
                return jax.lax.fori_loop(0, K, body, jnp.int32(0))
            return run
        return make

    dt = slope_time(extend_loop(ksw_extend_batch), 2, 10)
    gcups = cells / dt / 1e9
    results["extend_scan_dev_ms"] = round(dt * 1e3, 3)
    results["extend_scan_dev_gcups"] = round(gcups, 3)
    print(f"extend_scan: {dt*1e3:8.3f} ms/iter  {gcups:8.2f} GCUPS",
          flush=True)

    # ---- occ4 rank queries (random gathers over a 1 Mbp index) ----
    codes = rng.integers(0, 4, 1_000_000).astype(np.uint8)
    fm = FMIndex(build_index(Fasta([FastaContig("c", "", codes)])))
    dfm = DeviceFMIndex.from_host(fm)
    for NQ in (1 << 17,):
        ks = jnp.asarray(rng.integers(0, fm.seq_len, NQ).astype(np.int32))

        def make_occ(K):
            @jax.jit
            def run():
                def body(_, c):
                    cnt = occ4_device(
                        dfm.lines, dfm.L2,
                        ks + jnp.minimum(c, 0), dfm.primary, dfm.seq_len,
                        dfm.span,
                    )
                    return c + (jnp.sum(cnt) % 2).astype(jnp.int32)
                return jax.lax.fori_loop(0, K, body, jnp.int32(0))
            return run

        dt = slope_time(make_occ, 4, 64)
        qps = NQ / dt
        # each query gathers one fused line (4 count + span/16 word u32s);
        # gather_probe.py relates such row rates to the card's copy rate
        results[f"occ4_{NQ}_dev_ms"] = round(dt * 1e3, 4)
        results[f"occ4_{NQ}_dev_mquery_s"] = round(qps / 1e6, 2)
        print(f"occ4 N={NQ}: {dt*1e3:8.4f} ms/iter  {qps/1e6:8.1f} Mq/s",
              flush=True)

    # ---- full three-round-capable SMEM wave (150bp reads) ----
    # Two wave sizes: 1024 and 8192 (the serial cursor ticks' per-op
    # overhead amortizes over lanes).
    for B2 in (1024, 8192):
        L2v = 150
        reads = np.empty((B2, L2v), dtype=np.int32)
        for i in range(B2):
            s0 = int(rng.integers(0, 1_000_000 - L2v))
            reads[i] = codes[s0:s0 + L2v]
        qs = jnp.asarray(reads)
        qls = jnp.full(B2, L2v, jnp.int32)
        xs = jnp.zeros(B2, jnp.int32)

        def make_smem(K):
            @jax.jit
            def run():
                def body(_, c):
                    ret, *_rest, m_cnt, ovf = smem1a_batch_kernel(
                        dfm.lines, dfm.L2, qs, qls,
                        xs + jnp.minimum(c, 0), jnp.ones(B2, jnp.int32),
                        dfm.primary, dfm.seq_len, dfm.span,
                    )
                    return c + (jnp.sum(ret) % 2).astype(jnp.int32)
                return jax.lax.fori_loop(0, K, body, jnp.int32(0))
            return run

        dt = slope_time(make_smem, 2, 8)
        suffix = "" if B2 == 1024 else f"_b{B2}"
        results[f"smem1a_dev_ms{suffix}"] = round(dt * 1e3, 3)
        results[f"smem1a_dev_starts_s{suffix}"] = round(B2 / dt, 0)
        print(f"smem1a B={B2}: {dt*1e3:8.3f} ms/iter  {B2/dt:9.0f} starts/s",
              flush=True)

    # ---- sampled-SA compaction-ladder walks ----
    # sa_intv=32 (bwa default) and 8 (this repo's bench default — a pure
    # space/time knob).
    for intv in (32, 8):
        if intv == fm.sa_intv:
            sa_dev, sl = dfm.sa, fm.seq_len
        else:
            from bwamem_tpu.index.build import build_index as _bi
            fm8 = FMIndex(_bi(
                Fasta([FastaContig("c", "", codes)]), sa_intv=intv
            ))
            dfm8 = DeviceFMIndex.from_host(fm8)
            sa_dev, sl = dfm8.sa, fm8.seq_len
        NS = 1 << 14
        krows = jnp.asarray(rng.integers(1, sl, NS).astype(np.int32))

        def make_sa(K):
            @jax.jit
            def run():
                def body(_, c):
                    res = sa_lookup_kernel(
                        dfm.lines, dfm.L2, sa_dev,
                        jnp.clip(krows + jnp.minimum(c, 0), 1, sl - 1),
                        dfm.primary, sl, intv, dfm.span,
                    )
                    return c + (jnp.sum(res) % 2).astype(jnp.int32)
                return jax.lax.fori_loop(0, K, body, jnp.int32(0))
            return run

        dt = slope_time(make_sa, 2, 8)
        suffix = "" if intv == 32 else f"_intv{intv}"
        results[f"sa_lookup_dev_ms{suffix}"] = round(dt * 1e3, 3)
        results[f"sa_lookup_dev_mquery_s{suffix}"] = round(NS / dt / 1e6, 3)
        print(f"sa_lookup N={NS} intv={intv}: {dt*1e3:8.3f} ms/iter  "
              f"{NS/dt/1e6:8.3f} Mq/s", flush=True)

    if "--json" in sys.argv:
        import json
        path = sys.argv[sys.argv.index("--json") + 1]
        with open(path, "w") as fh:
            json.dump(results, fh, indent=1)
        print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
