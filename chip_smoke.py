"""Prove that the fused device pipeline runs, and is exact, on one NVIDIA GPU.

    python chip_smoke.py             # one card: device, kernel, main path
    python chip_smoke.py --chips 4   # four cards: the mesh path only

One process drives the card; nothing falls back to the CPU.  Phases:

  device   JAX platform, device kind and count, the card's name and power
           limit (nvidia-smi), the compile-cache directory, and the C++
           host tier that every comparison below uses as its reference.
  kernel   the banded-SW extension ``ksw_extend_batch`` (scan and the
           early-exit row loop the fused program embeds), jitted on the
           card over 4,096 jobs at Q = 150 and T up to the fused program's
           T_cap, against the C++ ``ksw_extend2``: exact equality.
  main     a 64 Mbp repeat-rich synthetic genome (bench.py ``chr20``,
           seed 1234, sa_intv 8) and 4,096 150 bp read pairs through
           ``BwaMemAligner.align_seqs`` with BWAMEM_TPU_DEVICE_PIPELINE=1,
           record-equal to the host C++ path, with host fallbacks at most
           2% of reads, reported by cause.
  mesh     (--chips 4 only) the same reads through
           ``BwaMemAligner(mesh=make_mesh(4), device_stages=(...))`` against
           the host C++ records, and the idx-sharded occ step against the
           host FM oracle.

Any failed phase exits non-zero.  The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 64_000_000  # bench.py CONFIGS["chr20"]
SEED = 1234
N_PAIRS = 4096
N_JOBS = 4096
MAX_FALLBACK_SHARE = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_phase(n_chips: int):
    """Require n_chips GPUs and the C++ tier; returns the first device."""
    import jax

    devs = jax.devices()
    log(f"jax {jax.__version__} devices: {devs}")
    if devs[0].platform != "gpu":
        fail(f"platform is {devs[0].platform!r}, not 'gpu'")
    if len(devs) < n_chips:
        fail(f"{n_chips} GPUs needed, JAX sees {len(devs)}")
    log(f"platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")

    import bwamem_tpu
    from bwamem_tpu.engine import native_fm, native_ksw, native_pipeline
    from bwamem_tpu.utils.compile_cache import ensure_compile_cache

    pkg = os.path.dirname(os.path.abspath(bwamem_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        fail(f"bwamem_tpu imported from {pkg}, not from this checkout")
    log(f"compile cache: {ensure_compile_cache()!r}")
    for name, mod in (("native_fm", native_fm), ("native_ksw", native_ksw),
                      ("native_pipeline", native_pipeline)):
        if not mod.available():
            fail(f"C++ tier {name} unavailable: the host reference would "
                 "silently become the Python oracle")
    return devs[0]


def make_ext_jobs(rng, n: int, Q: int, T_cap: int):
    """Extension jobs like the fused program's: a query prefix against a
    reference window that starts with a noisy copy of it (mismatches and
    indels), mixed bands and seeds, plus to-end and Z-drop cases."""
    jobs, h0s, ws, bonuses = [], [], [], []
    for k in range(n):
        ql = int(rng.integers(1, Q + 1)) if k % 4 else Q
        tl = int(rng.integers(1, T_cap + 1))
        q = rng.integers(0, 4, ql).astype(np.uint8)
        body = q.copy()
        for p in rng.integers(0, ql, rng.binomial(ql, 0.03)):
            body[p] = (body[p] + 1 + rng.integers(0, 3)) % 4
        if k % 3 == 0 and ql > 20:  # an indel inside the band
            p = int(rng.integers(5, ql - 5))
            d = int(rng.integers(1, 6))
            body = (np.concatenate([body[:p], body[p + d:]]) if k % 2 else
                    np.concatenate([body[:p], rng.integers(0, 4, d), body[p:]]))
        if k % 7 == 0 and ql > 30:  # unrelated tail: Z-drop territory
            cut = int(rng.integers(10, ql - 10))
            body[cut:] = rng.integers(0, 4, len(body) - cut)
        t = np.concatenate(
            [body, rng.integers(0, 4, max(tl - len(body), 0))]
        )[:tl].astype(np.uint8)
        jobs.append((q, t))
        h0s.append(int(rng.integers(1, 2 * Q)))
        ws.append(int(rng.choice([1, 5, 20, 50, 100, 200])))
        bonuses.append(int(rng.choice([0, 5])))
    return jobs, h0s, ws, bonuses


def kernel_phase(device, n_jobs: int = N_JOBS, Q: int = 150, seed: int = 7):
    """ksw_extend_batch on the device vs C++ ksw_extend2, exact."""
    import jax

    from bwamem_tpu.api.options import MemOptions
    from bwamem_tpu.engine import native_ksw
    from bwamem_tpu.engine.pipeline_device import _t_cap
    from bwamem_tpu.ops.extend_tpu import _WAVE_KEYS, ksw_extend_batch

    opt = MemOptions()
    T = _t_cap(opt, Q)
    jobs, h0s, ws, bonuses = make_ext_jobs(
        np.random.default_rng(seed), n_jobs, Q, T
    )
    want = native_ksw.extend_batch(
        jobs, opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        opt.zdrop, h0s, ws, bonuses,
    )
    qa = np.zeros((n_jobs, Q), np.int32)
    ta = np.zeros((n_jobs, T), np.int32)
    for i, (q, t) in enumerate(jobs):
        qa[i, : len(q)] = q
        ta[i, : len(t)] = t
    qlen = np.asarray([len(q) for q, _ in jobs], np.int32)
    tlen = np.asarray([len(t) for _, t in jobs], np.int32)
    args = [
        jax.device_put(a, device) for a in (
            qa, ta, qlen, tlen, np.asarray(h0s, np.int32),
            np.asarray(ws, np.int32), np.asarray(bonuses, np.int32),
            np.asarray(opt.mat, np.int32).reshape(5, 5),
        )
    ]
    static = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
              int(max(opt.mat)))
    cells = int((qlen.astype(np.int64) * tlen).sum())
    out = {"jobs": n_jobs, "Q": Q, "T": T, "cells": cells}
    for name, early in (("scan", False), ("early_exit", True)):
        run = lambda: jax.block_until_ready(
            ksw_extend_batch(*args, *static, early_exit=early)
        )
        t0 = time.perf_counter()
        got = run()
        first = time.perf_counter() - t0
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        got = {k: np.asarray(v) for k, v in got.items()}
        bad = [
            i for i in range(n_jobs)
            if any(int(got[k][i]) != int(want[i][k]) for k in _WAVE_KEYS)
        ]
        if bad:
            i = bad[0]
            fail(f"kernel {name}: {len(bad)}/{n_jobs} jobs differ from C++ "
                 f"ksw_extend2; job {i}: device "
                 f"{ {k: int(got[k][i]) for k in _WAVE_KEYS} } vs {want[i]}")
        steady = float(np.median(times))
        out[name] = {"first_call_s": first, "steady_s": steady,
                     "gcups": cells / steady / 1e9}
        log(f"kernel {name}: {n_jobs} jobs Q={Q} T<={T} exact vs C++ "
            f"ksw_extend2; first call {first:.3f} s, steady {steady:.6f} s "
            f"(median of 5), {cells / steady / 1e9:.3f} GCUPS "
            f"({cells} query x target cells)")
    return out


def _records(out):
    return [tuple(rl) for rl in out]


def _first_diff(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return f"read {i}: device {g} vs host {w}"
    return f"read counts {len(got)} vs {len(want)}"


def build_reference(genome_bp: int, seed: int, workdir: str):
    """The bench.py ``chr20`` genome, indexed on the host; returns
    (codes, image path)."""
    from bwamem_tpu.index import image
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.utils.fasta import Fasta, FastaContig
    from bwamem_tpu.utils.synth import synthetic_genome

    t0 = time.perf_counter()
    codes = synthetic_genome(genome_bp, np.random.default_rng(seed))
    idx = build_index(Fasta([FastaContig("chr", "", codes)]), sa_intv=8)
    img = os.path.join(workdir, "ref.img")
    image.write_image(img, idx)
    log(f"index build: {genome_bp} bp, sa_intv 8, "
        f"{time.perf_counter() - t0:.3f} s")
    return codes, img


def _aligner(index, **kw):
    from bwamem_tpu import BwaMemAligner, BwaMemPairEndStats

    al = BwaMemAligner(index, **kw)
    al.align_pairs()
    al.set_proper_pair_end_stats(BwaMemPairEndStats.of(350, 35))
    return al


def _set_pipeline(on: bool) -> None:
    os.environ["BWAMEM_TPU_DEVICE_PIPELINE"] = "1" if on else "0"


def main_phase(device, codes, img, n_pairs: int = N_PAIRS, seed: int = SEED):
    """The public aligner with the fused device pipeline vs the host C++
    path: every record equal, fallbacks bounded."""
    import jax

    from bwamem_tpu import BwaMemIndex
    from bwamem_tpu.engine.pipeline_device import _get_dref
    from bwamem_tpu.engine.seed_device import _get_dfm
    from bwamem_tpu.utils import metrics
    from bwamem_tpu.utils.synth import simulate_pairs

    reads = simulate_pairs(
        codes, np.random.default_rng(seed + 1), n_pairs, read_len=150,
        isize_mean=350, isize_std=35,
    )
    n = len(reads)
    index = BwaMemIndex(img)
    try:
        _set_pipeline(False)
        t0 = time.perf_counter()
        host = _records(_aligner(index).align_seqs(reads))
        log(f"host C++ path: {n} reads in {time.perf_counter() - t0:.3f} s")

        _set_pipeline(True)
        eng = index._require()
        t0 = time.perf_counter()
        dfm = _get_dfm(eng.fm)
        dref = _get_dref(eng.idx)
        jax.block_until_ready((dfm.lines, dfm.L2, dfm.sa, *dref))
        log(f"table upload: {time.perf_counter() - t0:.3f} s "
            f"({dfm.lines.nbytes + dfm.sa.nbytes + dref[0].nbytes} bytes)")
        for name, arr in (("occ lines", dfm.lines), ("sampled SA", dfm.sa),
                          ("pac rows", dref[0])):
            if arr.devices() != {device}:
                fail(f"{name} live on {arr.devices()}, not on {device}")
        log(f"device tables on {device}: occ lines {dfm.lines.shape}, "
            f"sampled SA {dfm.sa.shape}, pac rows {dref[0].shape}")

        al = _aligner(index)
        metrics.reset()
        t0 = time.perf_counter()
        first = _records(al.align_seqs(reads))
        log(f"device path first call (compile + run): "
            f"{time.perf_counter() - t0:.3f} s")
        metrics.reset()
        t0 = time.perf_counter()
        steady = _records(al.align_seqs(reads))
        wall = time.perf_counter() - t0
        snap = metrics.snapshot()
        stages = snap["stage_seconds"]
        log(f"device path steady call: {wall:.3f} s for {n} reads "
            f"({n / wall:.1f} reads/s); stage seconds {stages}")
        for what, got in (("first", first), ("steady", steady)):
            if got != host:
                fail(f"{what} device call not record-equal to host C++: "
                     f"{_first_diff(got, host)}")
        n_rec = sum(len(r) for r in host)
        log(f"record-equal: {n} reads, {n_rec} records (flag, contig, pos, "
            f"CIGAR, MAPQ, NM, MD, AS, XS, XA, mate, tlen), both calls")
        ctr = snap["counters"]
        fb = ctr.get("device_fused_pipeline_fallbacks", 0)
        causes = {
            k[len("device_fused_pipeline_fallbacks_"):]: v
            for k, v in sorted(ctr.items())
            if k.startswith("device_fused_pipeline_fallbacks_")
        }
        log(f"fallbacks: {fb}/{n} reads ({fb / n:.4%}), by cause {causes}")
        if fb > MAX_FALLBACK_SHARE * n:
            fail(f"{fb} host fallbacks exceed {MAX_FALLBACK_SHARE:.0%} of "
                 f"{n} reads")
        peak = (device.memory_stats() or {}).get("peak_bytes_in_use")
        log(f"device peak_bytes_in_use: {peak}")
        return {"reads": n, "records": n_rec, "steady_s": wall,
                "fallbacks": fb, "causes": causes, "peak_bytes": peak}
    finally:
        os.environ.pop("BWAMEM_TPU_DEVICE_PIPELINE", None)
        index.close()


def mesh_phase(n_dev: int, codes, img, n_pairs: int = N_PAIRS,
               seed: int = SEED):
    """The mesh path on n_dev devices vs the host C++ records, and the
    idx-sharded occ step vs the host FM oracle."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bwamem_tpu import BwaMemIndex
    from bwamem_tpu.engine.seed_device import _placer
    from bwamem_tpu.ops.fmindex_tpu import DeviceFMIndex
    from bwamem_tpu.parallel.dataparallel import make_sharded_occ_step
    from bwamem_tpu.parallel.mesh import make_mesh
    from bwamem_tpu.utils.synth import simulate_pairs

    reads = simulate_pairs(
        codes, np.random.default_rng(seed + 1), n_pairs, read_len=150,
        isize_mean=350, isize_std=35,
    )
    n = len(reads)
    index = BwaMemIndex(img)
    try:
        _set_pipeline(False)
        host = _records(_aligner(index).align_seqs(reads))
        mesh = make_mesh(n_dev)
        al = _aligner(index, mesh=mesh,
                      device_stages=("seed", "chain", "sa_lookup"))
        t0 = time.perf_counter()
        got = _records(al.align_seqs(reads))
        log(f"mesh {dict(mesh.shape)} first call (compile + run): "
            f"{time.perf_counter() - t0:.3f} s for {n} reads")
        if got != host:
            fail(f"mesh call not record-equal to host C++: "
                 f"{_first_diff(got, host)}")
        eng = index._require()
        dfm = eng.fm._device_fms[mesh]
        batch = _placer(mesh)(np.zeros((8 * n_dev, 4), np.int32))
        spans = {"occ lines": dfm.lines.sharding.device_set,
                 "read batch": batch.sharding.device_set}
        for what, devset in spans.items():
            if len(devset) != n_dev:
                fail(f"{what} spans {len(devset)} devices, not {n_dev}")
        if batch.sharding.is_fully_replicated:
            fail("read batch is replicated, not sharded")
        log(f"mesh path record-equal to host C++: {n} reads; occ tables "
            f"replicated and read batch sharded over {n_dev} devices")

        # idx-sharded occ tables (pangenome layout) vs the host oracle
        fm = eng.fm
        smesh = make_mesh(n_dev, idx_shards=n_dev)
        host_dfm = DeviceFMIndex.from_host(fm)
        lines_np = np.asarray(host_dfm.lines)
        nb = lines_np.shape[0]
        bps = -(-nb // n_dev)
        lines_pad = np.zeros((bps * n_dev, lines_np.shape[1]), np.uint32)
        lines_pad[:nb] = lines_np
        lines_s = jax.device_put(
            lines_pad, NamedSharding(smesh, P("idx", None))
        )
        if len(lines_s.sharding.device_set) != n_dev:
            fail("idx-sharded occ lines do not span the mesh")
        rng = np.random.default_rng(seed + 2)
        ks = rng.integers(-1, fm.seq_len + 1, 4096).astype(np.int32)
        occ = make_sharded_occ_step(smesh)(
            lines=lines_s, L2=jnp.asarray(fm.L2.astype(np.int32)),
            k=jnp.asarray(ks), primary=fm.primary, seq_len=fm.seq_len,
            span=host_dfm.span, blocks_per_shard=bps,
        )
        exp = fm.occ4(ks.astype(np.int64))
        if not np.array_equal(np.asarray(occ), exp):
            fail("idx-sharded occ step differs from the host FM oracle")
        log(f"idx-sharded occ step: {len(ks)} queries over {n_dev} shards "
            "equal to the host FM oracle")
    finally:
        os.environ.pop("BWAMEM_TPU_DEVICE_PIPELINE", None)
        index.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the mesh path on four cards")
    args = ap.parse_args(argv)
    device = device_phase(args.chips)
    import jax

    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_") as work:
        if args.chips == 1:
            kernel_phase(device)
            codes, img = build_reference(GENOME_BP, SEED, work)
            main_phase(device, codes, img)
        else:
            codes, img = build_reference(GENOME_BP, SEED, work)
            mesh_phase(args.chips, codes, img)
    log(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
