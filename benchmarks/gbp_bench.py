""">1 Gbp end-to-end proof: build, image-round-trip, and align against a
gigabase-scale reference on one host.

The reference's practical ceiling is host RAM for the mmap'd image
(~8 GB for GRCh38, jnibwa.c:154-165) with int64 (`bwtint_t`) coordinates
throughout the engine; this repo's host engine is int64 end-to-end and the
unpacked-reference fast-path cache is host-sized (index/build.py
_UNPACK_CACHE_MAX).  This driver pins the capability with a real run:

  1. synthesize a repeat-rich gigabase genome (default 1.05 Gbp — a
     2.1 G-symbol fwd+rc SA problem, just under the builder's int32 fast
     path's 2 Gbp edge; GBP_REF_LEN overrides),
  2. build the full FM-index (SA-IS, BWT, occ checkpoints, sampled SA),
  3. write + reopen the flat memory image (1 GiB-chunked writes, the
     jnibwa.c:136-145 discipline),
  4. align 150bp paired-end reads drawn genome-wide through the public
     aligner surface and check >= 95% mapped with correct coordinates,
  5. record build/align wall times in BENCH_GBP_r{N}.json.

Run:  python benchmarks/gbp_bench.py [out.json]
(~15-25 min, ~50 GB peak RSS on a 2-core host; not part of the pytest
suite — tests/test_gbp_scale.py gates a smaller version of the same path.)
"""
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # host-only run; leave the chip free

import numpy as np

# Defaults prove the >1 Gbp capability just under the int32 fast path's
# 2 Gbp edge; GBP_REF_LEN/GBP_PAIRS/GBP_LABEL parameterize (see
# grch38_bench.py for the 3.1 Gbp int64-path configuration).
REF_LEN = int(os.environ.get("GBP_REF_LEN", 1_050_000_000))
N_PAIRS = int(os.environ.get("GBP_PAIRS", 2_000))
LABEL = os.environ.get("GBP_LABEL", "gbp")
# grch38_bench pins rb2 (the bounded-memory artifact); default follows auto
ALGO = os.environ.get("GBP_ALGO", "auto")


def main():
    from bwamem_tpu import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
    from bwamem_tpu.index import image
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.utils.fasta import Fasta, FastaContig
    from bwamem_tpu.utils.synth import simulate_pairs, synthetic_genome

    out_path = sys.argv[1] if len(sys.argv) > 1 else f"BENCH_{LABEL.upper()}.json"
    rng = np.random.default_rng(99)
    t0 = time.time()
    codes = synthetic_genome(REF_LEN, rng)
    t_synth = time.time() - t0
    print(f"[{LABEL}] synthesized {REF_LEN/1e9:.2f} Gbp in {t_synth:.0f}s",
          flush=True)

    cache = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_cache",
    )
    os.makedirs(cache, exist_ok=True)
    img = os.path.join(cache, f"{LABEL}_ref.img")
    reuse = os.environ.get("GBP_REUSE_IMG") == "1" and os.path.exists(img)
    if reuse:
        # align-phase re-measurement against an image built by a prior
        # full run (build_s reported as null; the build artifact is the
        # prior run's JSON)
        del codes
        t_build = t_image = None
        index = BwaMemIndex(img)
        print(f"[{LABEL}] reusing image {img}", flush=True)
    else:
        # genome-scale memory discipline: hand the only copy of the
        # reference to the builder (consume=True releases it during
        # construction) and re-synthesize it afterwards for read
        # simulation — same rng, same bytes
        fasta = Fasta([FastaContig(LABEL + "1", "", codes)])
        del codes
        t0 = time.time()
        idx = build_index(fasta, consume=True, algo=ALGO)
        t_build = time.time() - t0
        del fasta
        print(f"[{LABEL}] index built in {t_build:.0f}s", flush=True)

        t0 = time.time()
        image.write_image(img, idx)
        del idx
        index = BwaMemIndex(img)
        t_image = time.time() - t0
        print(f"[{LABEL}] image {os.path.getsize(img)/1e9:.2f} GB "
              f"round-trip in {t_image:.0f}s", flush=True)

    codes = synthetic_genome(REF_LEN, np.random.default_rng(99))
    aligner = BwaMemAligner(index)
    aligner.align_pairs()
    aligner.set_proper_pair_end_stats(BwaMemPairEndStats.of(350, 35))
    read_rng = np.random.default_rng(100)
    warm = simulate_pairs(codes, read_rng, 100)
    reads, truth = simulate_pairs(codes, read_rng, N_PAIRS, return_truth=True)
    del codes
    n_reads = len(reads)
    # cold pass first (page cache / lazily-built table state as a fresh
    # process sees it), then warm + median-of-N steady-state passes — the
    # production-relevant number for a server that aligns billions of
    # reads against one resident index (run-to-run spread reported)
    from bwamem_tpu.utils import metrics as _metrics

    t0 = time.time()
    results = aligner.align_seqs(reads)
    cold_rate = n_reads / (time.time() - t0)
    aligner.align_seqs(warm)
    passes = []
    for _ in range(int(os.environ.get("GBP_TIMED_PASSES", "5"))):
        _metrics.reset()
        t0 = time.time()
        results = aligner.align_seqs(reads)
        passes.append(n_reads / (time.time() - t0))
    counters = _metrics.snapshot()["counters"]
    mapped = sum(1 for r in results if r and not (r[0].sam_flag & 0x4))
    # coordinate audit vs simulation truth (within one read length),
    # split by MAPQ>=10: the confident class must be ~perfect, the
    # low-MAPQ remainder is declared multi-mapping ambiguity
    good = good_hi = tot_hi = good_lo = tot_lo = 0
    for recs, (pos, _is_rev) in zip(results, truth):
        if recs and not (recs[0].sam_flag & 0x4):
            ok = abs(recs[0].ref_start - pos) <= 160
            good += ok
            if recs[0].map_qual >= 10:
                tot_hi += 1
                good_hi += ok
            else:
                tot_lo += 1
                good_lo += ok
    passes_s = sorted(passes)
    rate = passes_s[len(passes_s) // 2]  # median
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    index.close()
    rec = {
        "metric": LABEL + "_scale_end_to_end",
        "builder": ALGO,
        "ref_len": REF_LEN,
        "reads": n_reads,
        "mapped_frac": round(mapped / n_reads, 4),
        "coord_correct_frac": round(good / n_reads, 4),
        "coord_audit_mapq_ge10": {
            "n": tot_hi, "correct_frac": round(good_hi / max(tot_hi, 1), 5)
        },
        "coord_audit_mapq_lt10": {
            "n": tot_lo, "correct_frac": round(good_lo / max(tot_lo, 1), 5)
        },
        "reads_per_sec": round(rate, 1),
        "reads_per_sec_passes": [round(p, 1) for p in passes],
        "reads_per_sec_cold_first_pass": round(cold_rate, 1),
        "timing_method": "median of N steady-state passes on a resident "
        "index (cold first pass reported separately)",
        "device_seed_fused_fallbacks": int(
            counters.get("device_seed_fused_fallbacks", 0)
        ),
        "device_seed_fused_r_overflows": int(
            counters.get("device_seed_fused_r_overflows", 0)
        ),
        "build_s": None if t_build is None else round(t_build, 1),
        "image_reused": bool(reuse),
        "image_roundtrip_s": None if t_image is None else round(t_image, 1),
        "image_bytes": os.path.getsize(img),
        "peak_rss_gb": round(peak_gb, 1),
    }
    assert mapped >= 0.95 * n_reads, rec
    assert good >= 0.90 * n_reads, rec
    with open(out_path, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
