"""GRCh38-scale device seeding on the card.

Loads the int64-domain DeviceFMIndex of the 3.1 Gbp synthetic-GRCh38
index (seq_len 6.2e9 > 2^31: fused occ lines ~2.3 GB + sampled SA) into
device memory, runs the FUSED one-dispatch seeding+SA program
(ops/seed_fused.py) on 150 bp reads, asserts record equality with the
host oracle (intervals AND resolved rbegs), and reports per-read device
seeding time via the chained-slope method plus the table bytes and the
measured host->device upload rate.

Prereq: .bench_cache/grch38_ref.img (benchmarks/grch38_bench.py builds it).
Run alone on the card:  python benchmarks/device_grch38_seed.py [out.json]

Anchor: 64-bit bwtint_t ([EXT] bwt.h); mem_collect_intv hot loop
(SURVEY.md section 3.3); reached from mem_process_seqs (jnibwa.c:214).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

IMG = os.environ.get("GRCH38_IMG", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench_cache", "grch38_ref.img",
))
N_READS = int(os.environ.get("G38_READS", "48"))


def main():
    import jax
    import jax.numpy as jnp

    from bwamem_tpu.api.options import MemOptions
    from bwamem_tpu.engine.chain import sample_ks
    from bwamem_tpu.engine.fmindex import FMIndex
    from bwamem_tpu.engine.seed import collect_intv
    from bwamem_tpu.engine.seed_device import _pad_batch, _placer
    from bwamem_tpu.index.image import read_image
    from bwamem_tpu.ops.fmindex_tpu import DeviceFMIndex
    from bwamem_tpu.ops.seed_fused import M_SLOTS, seed_sa_fused_body

    out_path = sys.argv[1] if len(sys.argv) > 1 else "DEVICE_GRCH38_SEED.json"
    devs = jax.devices()
    platform = devs[0].platform
    print(f"[g38] loading index image {IMG} ...", file=sys.stderr, flush=True)
    idx = read_image(IMG)
    fm = FMIndex(idx)
    opt = MemOptions()

    # probe the bulk upload rate on a 64 MB slice first
    probe = np.zeros((1 << 20, 16), np.uint32)
    t0 = time.time()
    jax.device_put(probe).block_until_ready()
    mbps = probe.nbytes / (time.time() - t0) / 1e6
    print(f"[g38] upload probe: {mbps:.1f} MB/s", file=sys.stderr, flush=True)

    # host-side staging of the fused lines (mirrors DeviceFMIndex.
    # from_host), shipped in row slices that give upload progress
    t0 = time.time()
    span = 128
    m = span // 128
    nb = -(-fm.seq_len // span) or 1
    counts = np.ascontiguousarray(fm.ckpt[: nb * m : m].astype(np.uint32))
    words = np.zeros((nb * m, 8), dtype=np.uint32)
    words[: fm.words.shape[0]] = fm.words
    lines_np = np.concatenate([counts, words.reshape(nb, 8 * m)], axis=1)
    sa_np = fm.sa.astype(np.int64)
    stage_s = time.time() - t0
    table_bytes = lines_np.nbytes + sa_np.nbytes
    print(
        f"[g38] staged lines {lines_np.nbytes/1e9:.2f} GB + SA "
        f"{sa_np.nbytes/1e9:.2f} GB (host {stage_s:.0f}s); uploading at "
        f"~{mbps:.0f} MB/s => ~{table_bytes/1e6/mbps/60:.1f} min",
        file=sys.stderr, flush=True,
    )
    with jax.enable_x64(True):
        t0 = time.time()
        slices = []
        step = max(1, (256 << 20) // (lines_np.shape[1] * 4))
        for lo in range(0, lines_np.shape[0], step):
            slices.append(jax.device_put(lines_np[lo : lo + step]))
            slices[-1].block_until_ready()
            print(
                f"[g38]  lines rows {lo + slices[-1].shape[0]}/"
                f"{lines_np.shape[0]}",
                file=sys.stderr, flush=True,
            )
        lines_d = jnp.concatenate(slices, axis=0)
        lines_d.block_until_ready()
        del slices
        sa_parts = []
        sstep = (256 << 20) // 8
        for lo in range(0, sa_np.shape[0], sstep):
            sa_parts.append(jax.device_put(sa_np[lo : lo + sstep]))
            sa_parts[-1].block_until_ready()
        sa_d = jnp.concatenate(sa_parts)
        sa_d.block_until_ready()
        del sa_parts
        upload_s = time.time() - t0
        L2_d = jnp.asarray(np.asarray(fm.L2, dtype=np.int64))
        dfm = DeviceFMIndex(
            lines=lines_d, L2=L2_d, sa=sa_d, primary=int(fm.primary),
            seq_len=int(fm.seq_len), sa_intv=int(fm.sa_intv), span=span,
        )
    print(
        f"[g38] uploaded {table_bytes/1e9:.2f} GB in {upload_s:.0f}s "
        f"({table_bytes/1e6/upload_s:.1f} MB/s)",
        file=sys.stderr, flush=True,
    )

    # reads drawn from the real genome (via the index's own pac)
    rng = np.random.default_rng(5)
    reads = []
    for _ in range(N_READS):
        s = int(rng.integers(0, idx.bns.l_pac - 160))
        r = idx.get_seq(s, s + 150).copy()
        for p in rng.integers(0, 150, rng.binomial(150, 0.005)):
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        if rng.integers(0, 2):
            r = np.where(r < 4, 3 - r, 4)[::-1].copy()
        reads.append(r.astype(np.uint8))

    place = _placer(None)
    with dfm.ctx():
        qseq, qlen_j, B, Lr = _pad_batch(reads, place, dtype=np.int8)
    kw = dict(
        primary=dfm.primary, seq_len=dfm.seq_len, sa_intv=dfm.sa_intv,
        span=dfm.span, min_seed_len=opt.min_seed_len,
        split_len=opt.split_len, split_width=opt.split_width,
        max_mem_intv=int(opt.max_mem_intv), max_occ=opt.max_occ,
        M=M_SLOTS, R_cap=B * 64, F_cap=B * 24,
    )

    with dfm.ctx():
        fused = jax.jit(
            lambda l, L, s, q, ql: seed_sa_fused_body(l, L, s, q, ql, **kw)
        )
        t0 = time.time()
        flat_d, extra_d = fused(dfm.lines, dfm.L2, dfm.sa, qseq, qlen_j)
        jax.block_until_ready((flat_d, extra_d))
        first_call_s = time.time() - t0
        flat = np.asarray(jax.device_get(flat_d), dtype=np.int64)
        extra = np.asarray(jax.device_get(extra_d), dtype=np.int64)

        # chained device-time slope
        def make_run(K):
            @jax.jit
            def run(l, L, s, q, ql):
                def body(_, c):
                    f2, e2 = seed_sa_fused_body(
                        l, L, s, q + jnp.minimum(c, 0).astype(jnp.int8),
                        ql, **kw
                    )
                    return (jnp.abs(f2.sum() + e2.sum()) % 1021).astype(
                        jnp.int32
                    )
                return jax.lax.fori_loop(0, K, body, jnp.int32(0))
            return lambda: run(dfm.lines, dfm.L2, dfm.sa, qseq, qlen_j)

        r1, r3 = make_run(1), make_run(3)
        int(np.asarray(r1())); int(np.asarray(r3()))
        b1 = b3 = float("inf")
        for _ in range(3):
            t0 = time.time(); int(np.asarray(r1())); b1 = min(b1, time.time() - t0)
            t0 = time.time(); int(np.asarray(r3())); b3 = min(b3, time.time() - t0)
        dev_batch_s = (b3 - b1) / 2

    # ---- decode + record-equality vs the host oracle --------------------
    R_cap = B * 64
    meta = extra[R_cap + 2 :]
    n_m = (meta & 0xFFFF).astype(np.int64)
    ovf = (meta >> 16) != 0
    rbegs_flat = extra[:R_cap]
    total_rbegs = int(extra[R_cap])
    assert total_rbegs <= R_cap, (
        f"global walk budget exhausted ({total_rbegs} > {R_cap}): raise "
        "r_per_read — the engine path would demote to host SA walks here"
    )
    starts = np.zeros(B + 1, np.int64)
    np.cumsum(n_m, out=starts[1:])
    cnt = np.minimum(flat[:, 2], opt.max_occ)
    cnt[int(extra[R_cap + 1]):] = 0
    offs = np.zeros(len(flat) + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    n_intv = n_rb = n_fb = 0
    for i, r in enumerate(reads):
        exp = collect_intv(opt, fm, r)
        if ovf[i]:
            n_fb += 1
            continue
        got = [
            (int(flat[j, 0]), int(flat[j, 1]), int(flat[j, 2]),
             int(flat[j, 3]) >> 16, int(flat[j, 3]) & 0xFFFF)
            for j in range(starts[i], starts[i] + n_m[i])
        ]
        want = [(p.x0, p.x1, p.s, p.qb, p.qe) for p in exp]
        assert got == want, f"read {i}: intervals diverge"
        for j in range(starts[i], starts[i] + n_m[i]):
            p = exp[j - starts[i]]
            exp_rb = fm.sa_lookup(
                np.asarray(sample_ks(p, opt.max_occ), np.int64)
            )
            got_rb = rbegs_flat[offs[j] : offs[j] + cnt[j]]
            assert np.array_equal(got_rb, exp_rb), f"read {i}: rbegs diverge"
            n_rb += len(exp_rb)
        n_intv += len(want)

    rec = {
        "metric": "grch38_scale_device_seeding",
        "platform": platform,
        "device": str(devs[0]),
        "device_kind": devs[0].device_kind,
        "seq_len": int(fm.seq_len),
        "sa_intv": int(fm.sa_intv),
        "device_table_bytes": int(table_bytes),
        "upload_seconds": round(upload_s, 1),
        "upload_mb_s": round(table_bytes / 1e6 / upload_s, 1),
        "reads": len(reads),
        "batch_bucket": B,
        "intervals_record_equal": n_intv,
        "rbegs_record_equal": n_rb,
        "overflow_fallbacks": n_fb,
        "first_dispatch_seconds": round(first_call_s, 2),
        "device_batch_seconds": round(dev_batch_s, 4),
        "device_seed_reads_per_sec": round(len(reads) / dev_batch_s, 1),
        "note": "int64 (bwtint_t) domain fused seed+SA at full 3.1 Gbp "
        "scale: occ lines + sampled SA resident in device memory; "
        "record-equal to the host oracle.",
    }
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
