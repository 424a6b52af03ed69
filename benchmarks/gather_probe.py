"""Random-gather rates for the occ-line primitive on the card.

The occ4 rank query ([EXT] bwt.c hot loop #1) is one random line read per
query; the SA walks are random sampled-SA reads.  This maps the row-rate
surface: row width W in {8,16,32,128} u32 x table size {1 MB, 64 MB, 1 GB}
(below and above the H100's 50 MB L2) x query count, with the fori_loop
slope method (benchmarks/device_time.py).  Each rate is stated as a share
of the card's published memory bandwidth (PEAK_BYTES_S, keyed by
device_kind; an unknown card is an error) and of a large device-to-device
copy measured in the same run.

Tables are synthesized on the device (iota hash).

    python benchmarks/gather_probe.py [--json PATH]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# published device-memory bandwidth by jax device_kind (NVIDIA H100 data
# sheet, SXM part: 80 GB HBM3 at 3.35 TB/s)
PEAK_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _pull(x):
    return int(np.asarray(x).ravel()[0])


def slope_time(make_run, k_small, k_big, reps=3):
    run_s, run_b = make_run(k_small), make_run(k_big)
    _pull(run_s())
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

    dev = jax.devices()[0]
    print("devices:", jax.devices(), flush=True)
    if dev.device_kind not in PEAK_BYTES_S:
        raise SystemExit(
            f"no published bandwidth for device_kind {dev.device_kind!r}"
        )
    peak = PEAK_BYTES_S[dev.device_kind]
    rng = np.random.default_rng(0)
    results = {"platform": dev.platform, "device_kind": dev.device_kind,
               "peak_bytes_s": peak}

    def loop_of(tab, idx, sorted_idx=False):
        """K chained gathers tab[idx]; the carry perturbs the indices by an
        opaque zero, and every gathered word feeds the carry, so XLA can
        neither hoist nor narrow the gather.  The table is an argument: a
        closed-over array would be baked into the program as a constant."""
        def make(K):
            @jax.jit
            def run(t, i):
                def body(_, c):
                    out = jnp.take(t, i + jnp.minimum(c, 0), axis=0,
                                   indices_are_sorted=sorted_idx)
                    return c + (jnp.sum(out) % 2).astype(jnp.int32)
                return jax.lax.fori_loop(0, K, body, jnp.int32(0))
            return lambda: run(tab, idx)
        return make

    # a large plain copy: the 1 GiB array is the loop carry, so every
    # iteration reads and writes all of it
    big = jnp.zeros((1 << 28,), jnp.uint32)

    def make_copy(K):
        @jax.jit
        def run(a):
            out = jax.lax.fori_loop(
                0, K, lambda _, x: x + jnp.uint32(1), a
            )
            return out[-1]
        return lambda: run(big)

    dt = slope_time(make_copy, 2, 8)
    copy_bytes_s = 2 * big.nbytes / dt
    del big
    results["copy_bytes_s"] = copy_bytes_s
    print(f"copy 1 GiB: {dt*1e3:9.4f} ms  {copy_bytes_s/1e9:9.1f} GB/s "
          f"({copy_bytes_s / peak:.1%} of peak)", flush=True)

    def report(name, dt, nq, bytes_per_row):
        qps = nq / dt
        rate = qps * bytes_per_row
        results[f"{name}_mrow_s"] = qps / 1e6
        results[f"{name}_peak_frac"] = rate / peak
        results[f"{name}_copy_frac"] = rate / copy_bytes_s
        print(f"{name:28s}: {dt*1e3:9.4f} ms  {qps/1e6:9.1f} Mrow/s"
              f"  {rate/peak*100:6.2f}% peak  {rate/copy_bytes_s*100:6.2f}%"
              " copy", flush=True)

    def synth(nb, W):
        def mk():
            i = jax.lax.broadcasted_iota(jnp.uint32, (nb, W), 0)
            j = jax.lax.broadcasted_iota(jnp.uint32, (nb, W), 1)
            return i * jnp.uint32(2654435761) ^ (j * jnp.uint32(40503) + 1)
        t = jax.jit(mk)()
        t.block_until_ready()
        return t

    NQ = 1 << 17
    for mb, ws in ((1, (16,)), (64, (8, 16, 32, 128)), (1024, (16,))):
        for W in ws:
            nb = (mb << 20) // (4 * W)
            tab = synth(nb, W)
            idx = jnp.asarray(rng.integers(0, nb, NQ).astype(np.int32))
            dt = slope_time(loop_of(tab, idx), 4, 32)
            report(f"tab{mb}MB_w{W}_nq{NQ}", dt, NQ, 4 * W)
            del tab

    # query-count scaling at 64 MB, W=16: per-TICK fixed latency vs
    # streaming rate (the lockstep-loop design constant)
    W = 16
    nb = (64 << 20) // (4 * W)
    tab = synth(nb, W)
    for lg in (10, 12, 14, 17, 20):
        nq = 1 << lg
        idx = jnp.asarray(rng.integers(0, nb, nq).astype(np.int32))
        dt = slope_time(loop_of(tab, idx), 4, 32)
        report(f"tab64MB_w16_nq{nq}", dt, nq, 4 * W)

    # sorted-index locality ceiling at 1 GB, W=16
    del tab
    nb = (1024 << 20) // (4 * W)
    tab = synth(nb, W)
    idx_np = np.sort(rng.integers(0, nb, NQ).astype(np.int32))
    dt = slope_time(loop_of(tab, jnp.asarray(idx_np), sorted_idx=True), 4, 32)
    report(f"tab1024MB_w16_sorted_nq{NQ}", dt, NQ, 4 * W)

    if "--json" in sys.argv:
        import json
        path = sys.argv[sys.argv.index("--json") + 1]
        with open(path, "w") as fh:
            json.dump(results, fh, indent=1)
        print("wrote", path, flush=True)


if __name__ == "__main__":
    sys.exit(main() or 0)
