"""Device time of the ONE-dispatch pipeline program (seed+SA+chain+extend,
ops/pipeline_fused.py) chained K times on the device with a single host
pull.

Per-batch *device* time is the slope between t(K_small) and t(K_big) of
a jitted ``fori_loop`` whose carry perturbs the next iteration's input by
``min(checksum, 0)`` — provably zero at runtime, opaque to XLA, so
iterations can't be CSE'd and dispatch is paid once per measurement (same
methodology as benchmarks/device_time.py).  The host finalize tail
(dedup+pair+records — the part that stays on the host) is measured too,
so min(device, tail) is the steady state a fully overlapped pipeline
would reach.

Run alone on the card:
    python benchmarks/device_pipeline_time.py [out.json]
Anchor: one-call batch contract jnibwa.c:197-235 (mem_process_seqs).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_cache"
)

N_PAIRS = int(os.environ.get("DPT_PAIRS", "512"))
REF_LEN = int(os.environ.get("DPT_REF_LEN", "500000"))


def main():
    import jax
    import jax.numpy as jnp

    from bwamem_tpu import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
    from bwamem_tpu.api.options import MemOptions
    from bwamem_tpu.engine.pipeline import Engine
    from bwamem_tpu.engine.pipeline_device import (
        C_SLOTS, R_SLOTS, S_SLOTS, _get_dref, _t_cap,
    )
    from bwamem_tpu.engine.seed_device import _get_dfm, _pad_batch, _placer
    from bwamem_tpu.index import image
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.ops.pipeline_fused import pipeline_fused_body
    from bwamem_tpu.ops.seed_fused import F_PER_READ, M_SLOTS, R_PER_READ
    from bwamem_tpu.utils.fasta import Fasta, FastaContig
    from bwamem_tpu.utils.synth import simulate_pairs, synthetic_genome
    from bwamem_tpu.utils.timers import TIMERS

    out_path = sys.argv[1] if len(sys.argv) > 1 else "DEVICE_PIPELINE_TIME.json"
    devs = jax.devices()
    platform = devs[0].platform
    rng = np.random.default_rng(42)
    codes = synthetic_genome(REF_LEN, rng)
    img = os.path.join(CACHE, "device_e2e_ref.img")
    if not os.path.exists(img):
        os.makedirs(CACHE, exist_ok=True)
        image.write_image(
            img, build_index(Fasta([FastaContig("c", "", codes)]))
        )
    reads_b = simulate_pairs(codes, np.random.default_rng(43), N_PAIRS)
    from bwamem_tpu.utils.encoding import seq_to_codes_batch

    reads = seq_to_codes_batch(reads_b)
    n_reads = len(reads)

    index = BwaMemIndex(img)
    from bwamem_tpu.index.image import read_image

    eng = Engine(read_image(img))
    opt = MemOptions()
    dfm = _get_dfm(eng.fm)
    pac8, ctg_end, ctg_off, ctg_alt = _get_dref(eng.idx)
    place = _placer(None)
    qseq, qlen_j, B, L = _pad_batch(reads, place, dtype=np.int8)
    fcs_j = place(np.ones(B, dtype=bool))
    mat_d = jnp.asarray(np.asarray(opt.mat, np.int32).reshape(5, 5))
    statics = dict(
        primary=dfm.primary, seq_len=dfm.seq_len, sa_intv=dfm.sa_intv,
        span=dfm.span, l_pac=int(eng.idx.bns.l_pac),
        min_seed_len=opt.min_seed_len, split_len=opt.split_len,
        split_width=opt.split_width, max_mem_intv=int(opt.max_mem_intv),
        max_occ=opt.max_occ, M=M_SLOTS, R_cap=B * R_PER_READ,
        F_cap=B * F_PER_READ,
        S=S_SLOTS, C=C_SLOTS, R=R_SLOTS, T_cap=_t_cap(opt, L),
        a=opt.a, o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
        e_ins=opt.e_ins, zdrop=opt.zdrop, pen_clip5=opt.pen_clip5,
        pen_clip3=opt.pen_clip3, w_opt=opt.w, max_sc=int(max(opt.mat)),
        max_chain_gap=opt.max_chain_gap,
        min_chain_weight=opt.min_chain_weight,
        max_chain_extend=opt.max_chain_extend,
        mask_level=float(opt.mask_level), drop_ratio=float(opt.drop_ratio),
    )

    # device tables ride as ARGUMENTS: closure arrays would be baked into
    # the HLO as constants
    def make_run(K):
        @jax.jit
        def run(lines, L2, sa_t, pr, ce, co, ca, qs, ql, fc, md):
            def body(_, chk):
                pert = jnp.minimum(chk, 0).astype(jnp.int8)
                _f, extra, _rc, ri, info = pipeline_fused_body(
                    lines, L2, sa_t, pr, ce, co, ca, qs + pert, ql, fc,
                    md, **statics
                )
                s = info[:, 0].sum() + ri[:, :, 2].sum()
                return (jnp.abs(s) % 1021).astype(jnp.int32)

            return jax.lax.fori_loop(0, K, body, jnp.int32(0))

        return lambda: run(
            dfm.lines, dfm.L2, dfm.sa, pac8, ctg_end, ctg_off, ctg_alt,
            qseq, qlen_j, fcs_j, mat_d
        )

    print("[dpt] compiling chained programs...", file=sys.stderr, flush=True)
    k_small, k_big = 1, 5
    run_s, run_b = make_run(k_small), make_run(k_big)
    int(np.asarray(run_s()))  # compile + warm
    int(np.asarray(run_b()))
    best_s = best_b = float("inf")
    for _ in range(3):
        t0 = time.time()
        int(np.asarray(run_s()))
        best_s = min(best_s, time.time() - t0)
        t0 = time.time()
        int(np.asarray(run_b()))
        best_b = min(best_b, time.time() - t0)
    per_batch = (best_b - best_s) / (k_big - k_small)
    dev_rate = n_reads / per_batch

    # ---- host finalize tail (dedup + pestat + pair + records) -----------
    # run the public align twice with the fused device path; tail time =
    # wall - device_pipeline stage (stage includes copies/dispatch/decode,
    # which a pipelined host overlaps with the next batch's program)
    os.environ["BWAMEM_TPU_DEVICE_PIPELINE"] = "1"
    try:
        aligner = BwaMemAligner(index)
        aligner.align_pairs()
        aligner.set_proper_pair_end_stats(BwaMemPairEndStats.of(350, 35))
        aligner.align_seqs(reads_b)  # warm/compile
        TIMERS.reset()
        t0 = time.time()
        aligner.align_seqs(reads_b)
        wall = time.time() - t0
        stage = dict(TIMERS.totals)
    finally:
        os.environ.pop("BWAMEM_TPU_DEVICE_PIPELINE", None)
    t_dev_stage = stage.get("device_pipeline", 0.0)
    tail = max(wall - t_dev_stage, 1e-9)
    tail_rate = n_reads / tail
    index.close()

    rec = {
        "metric": "device_pipeline_time",
        "platform": platform,
        "device": str(devs[0]),
        "device_kind": devs[0].device_kind,
        "reads_per_batch": n_reads,
        "batch_bucket": B,
        "read_len": 150,
        "method": (
            "full per-batch device program (fused seed+SA+chain+extend) "
            "chained K times in one fori_loop, carry-perturbed inputs, "
            "one pull; per-batch device time = slope t(5)-t(1) / 4"
        ),
        "device_batch_seconds": round(per_batch, 6),
        "device_time_reads_per_sec": round(dev_rate, 1),
        "host_tail_seconds_per_batch": round(tail, 6),
        "host_tail_reads_per_sec": round(tail_rate, 1),
        "pipelined_projection_reads_per_sec": round(
            min(dev_rate, tail_rate), 1
        ),
        "note": (
            "device_time_reads_per_sec is the device program alone; "
            "pipelined projection = min(device, host-tail)"
        ),
    }
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
