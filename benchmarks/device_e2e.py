"""Device end-to-end: align a PE batch with the fused device pipeline
(BWAMEM_TPU_DEVICE_PIPELINE=1: seeding, SA walks, chaining and the
extension row loop in one program) and assert record equality with the
host C++ engine.

Run alone on the card:  python benchmarks/device_e2e.py [out.json]
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


def _align(img, reads, env):
    """Run one alignment pass under `env`, in-process."""
    saved = {}
    for k, v in env.items():
        saved[k] = os.environ.get(k)
        os.environ[k] = v
    try:
        from bwamem_tpu import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
        from bwamem_tpu.utils import metrics

        metrics.reset()
        index = BwaMemIndex(img)
        aligner = BwaMemAligner(index)
        aligner.align_pairs()
        aligner.set_proper_pair_end_stats(BwaMemPairEndStats.of(350, 35))
        t0 = time.time()
        out = aligner.align_seqs(reads)
        dt = time.time() - t0
        index.close()
        snap = metrics.snapshot()
        recs = [
            [
                (a.sam_flag, a.ref_id, a.ref_start, a.cigar, a.map_qual,
                 a.n_mismatches, a.aligner_score, a.suboptimal_score,
                 a.md_tag, a.xa_tag, a.mate_ref_start, a.template_len)
                for a in rl
            ]
            for rl in out
        ]
        return recs, dt, snap.get("counters", {})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main():
    import jax

    from bwamem_tpu.index import image
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.utils.fasta import Fasta, FastaContig
    from bwamem_tpu.utils.synth import simulate_pairs, synthetic_genome

    out_path = sys.argv[1] if len(sys.argv) > 1 else "DEVICE_E2E.json"
    devs = jax.devices()
    platform = devs[0].platform
    rng = np.random.default_rng(42)
    codes = synthetic_genome(500_000, rng)
    img = os.path.join(CACHE, "device_e2e_ref.img")
    if not os.path.exists(img):
        os.makedirs(CACHE, exist_ok=True)
        image.write_image(img, build_index(Fasta([FastaContig("c", "", codes)])))
    reads = simulate_pairs(codes, np.random.default_rng(43), 300)

    print("[e2e] host pass...", file=sys.stderr, flush=True)
    host_recs, host_dt, _ = _align(
        img, reads, {"BWAMEM_TPU_DEVICE_SEED": "0", "BWAMEM_TPU_DEVICE_EXTEND": "0"}
    )
    dev_env = {
        # ONE dispatch per batch: seed+SA+chain+extend fused
        # (ops/pipeline_fused.py); extension waves no longer exist as
        # separate dispatches
        "BWAMEM_TPU_DEVICE_PIPELINE": "1",
    }
    # warm compile pass at the SAME batch/length buckets (compile caches
    # per shape; a small warm batch would leave the real shapes cold)
    print("[e2e] device warm (compile)...", file=sys.stderr, flush=True)
    _align(img, reads, dev_env)
    print("[e2e] device timed pass...", file=sys.stderr, flush=True)
    dev_recs, dev_dt, counters = _align(img, reads, dev_env)

    equal = host_recs == dev_recs
    n_diff = sum(1 for a, b in zip(host_recs, dev_recs) if a != b)

    rec = {
        "metric": "device_end_to_end",
        "platform": platform,
        "device": str(devs[0]),
        "device_kind": devs[0].device_kind,
        "reads": len(reads),
        "record_equal_to_host": bool(equal),
        "n_reads_differing": int(n_diff),
        "host_reads_per_sec": round(len(reads) / host_dt, 1),
        "device_reads_per_sec": round(len(reads) / dev_dt, 1),
        "device_fused_pipeline_batches": int(
            counters.get("device_fused_pipeline_batches", 0)
        ),
        "device_fused_pipeline_fallbacks": int(
            counters.get("device_fused_pipeline_fallbacks", 0)
        ),
        "device_seed_waves": int(counters.get("device_seed_waves", 0)),
        "device_extend_waves": int(counters.get("device_extend_waves", 0)),
        "device_extend_jobs": int(counters.get("device_extend_jobs", 0)),
        "note": "device path = ONE fused dispatch per batch "
        "(seed+SA+chain+extend, ops/pipeline_fused.py) record-equal to "
        "the host engine; device_extend_waves 0 = no separate extension "
        "dispatches remain.",
    }
    assert equal, rec
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
