"""Wave-dispatch scaling over mesh sizes 1/2/4/8 on a virtual CPU mesh.

Measures the DATA-PARALLEL WAVE PATH's partitioning on virtual CPU
devices: the same jitted extension-wave computation, identical per-device
batch share, mesh sizes 1..8.  The per-wave work is embarrassingly
parallel (XLA partitions the batch with zero collectives — verified in the
compiled HLO by the absence of all-reduce/all-gather); all virtual devices
share the host's cores, so the numbers show only that partitioning adds
no overhead walls.  They are CPU numbers, not device numbers.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/mesh_scaling.py --json mesh_scaling.json
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bwamem_tpu.api.options import MemOptions
    from bwamem_tpu.ops.extend_tpu import ksw_extend_batch_np
    from bwamem_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) >= 8, jax.devices()
    opt = MemOptions()
    params = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)
    rng = np.random.default_rng(0)
    # fixed GLOBAL batch: homologous 128x256 extension jobs
    B, Q, T = 1024, 128, 256
    qs, ts = [], []
    for _ in range(B):
        q = rng.integers(0, 4, Q).astype(np.uint8)
        t = np.concatenate([q, rng.integers(0, 4, T - Q).astype(np.uint8)])
        muts = rng.random(T) < 0.01
        t[muts] = (t[muts] + 1 + rng.integers(0, 3, muts.sum())) % 4
        qs.append(q)
        ts.append(t)
    h0s = [30] * B
    ws = [100] * B
    bons = [5] * B

    def run(mesh):
        return ksw_extend_batch_np(
            qs, ts, opt.mat, params, h0s, ws, bons,
            bucket_q=Q, bucket_t=T, mesh=mesh,
        )

    results = {
        "kind": "CPU-mesh PROXY (virtual devices share this host's cores); "
                "measures wave partitioning behavior 1->N, not real "
                "multi-chip compute scaling",
        "host_cores": os.cpu_count(),
        "global_batch": B,
        "points": [],
    }
    base = None
    for n in (1, 2, 4, 8):
        mesh = make_mesh(n, idx_shards=1) if n > 1 else make_mesh(1, 1)
        run(mesh)  # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            out = run(mesh)
            _ = out[0]["score"]
            best = min(best, time.time() - t0)
        thr = B / best
        if base is None:
            base = thr
        eff = thr / (base * n)
        results["points"].append({
            "n_devices": n,
            "wave_ms": round(best * 1e3, 2),
            "jobs_per_s": round(thr, 1),
            "speedup_vs_1": round(thr / base, 3),
            "efficiency_pct": round(100 * eff, 1),
        })
        print(f"n={n}: {best*1e3:8.2f} ms/wave  {thr:9.0f} jobs/s  "
              f"eff {100*eff:5.1f}%", flush=True)

    # ---- dispatch-cost model: t(n, B) = F(n) + B*v/n --------------------
    # Fit the FIXED per-wave dispatch/partition cost F(n) and the VARIABLE
    # per-job cost v separately from two global batch sizes per mesh size.
    # The fixed cost is what the r04 dispatch-collapse work (fused seeding,
    # single-pull waves) attacks; the model projects efficiency for
    # compute-bound waves on real N-device hardware, where the proxy's
    # shared-2-core ceiling does not apply.
    def timed(mesh, nb):
        run_b = lambda: ksw_extend_batch_np(
            qs[:nb], ts[:nb], opt.mat, params, h0s[:nb], ws[:nb], bons[:nb],
            bucket_q=Q, bucket_t=T, mesh=mesh,
        )
        run_b()
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            out = run_b()
            _ = out[0]["score"]
            best = min(best, time.time() - t0)
        return best

    model = {"form": "t(n,B) = F(n) + B*v_eff(n);  F = fixed per-wave "
                     "dispatch cost, v_eff = per-job cost on n devices"}
    pts = []
    B1, B2 = 256, 1024
    for n in (1, 2, 4, 8):
        mesh = make_mesh(n, idx_shards=1) if n > 1 else make_mesh(1, 1)
        t1, t2 = timed(mesh, B1), timed(mesh, B2)
        v_eff = (t2 - t1) / (B2 - B1)
        F = max(t1 - B1 * v_eff, 0.0)
        pts.append({
            "n_devices": n,
            "fixed_ms": round(F * 1e3, 2),
            "per_job_us": round(v_eff * 1e6, 2),
        })
        print(f"model n={n}: F={F*1e3:7.2f} ms  v_eff={v_eff*1e6:7.2f} "
              f"us/job", flush=True)
    model["points"] = pts
    # projected efficiency for compute-bound waves on real n-device
    # hardware: eff = (B*v/n) / (F + B*v/n) with v = single-device per-job
    # cost and F from the fit (dispatch cost does not shrink with n)
    v1 = pts[0]["per_job_us"] / 1e6
    proj = []
    for p in pts:
        n = p["n_devices"]
        F = p["fixed_ms"] / 1e3
        for Bp in (1024, 8192):
            ideal = Bp * v1 / n
            proj.append({
                "n_devices": n,
                "global_batch": Bp,
                "projected_efficiency_pct": round(
                    100 * ideal / (F + ideal), 1
                ),
            })
    model["projected_compute_bound"] = proj
    model["projection_assumptions"] = (
        "Assumes (1) v_eff stays flat from the CPU proxy to real chips "
        "at the single-device point used for `ideal`, (2) F(n) — the "
        "per-wave dispatch cost — does not shrink with n, (3) waves are "
        "compute-bound (no collective term: the wave path is verified "
        "collective-free in HLO). These are projections from a CPU "
        "proxy, NOT device measurements."
    )
    results["dispatch_cost_model"] = model
    # the proxy's hard ceiling: n virtual devices share n_cores real cores,
    # so compute-bound efficiency cannot exceed n_cores/n; report how close
    # the measured points come to that ceiling (the remainder is the true
    # partition/dispatch overhead the design controls)
    ncores = os.cpu_count() or 1
    for p in results["points"]:
        ceil = min(1.0, ncores / p["n_devices"])
        p["core_ceiling_pct"] = round(100 * ceil, 1)
        p["pct_of_core_ceiling"] = round(
            100 * (p["efficiency_pct"] / 100) / ceil, 1
        )

    if "--json" in sys.argv:
        import json

        path = sys.argv[sys.argv.index("--json") + 1]
        with open(path, "w") as fh:
            json.dump(results, fh, indent=1)
        print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
