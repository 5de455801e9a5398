"""Multi-host scaling measurement (SURVEY §6 / BASELINE north star).

Runs the same workload through 1 worker process and through 2 worker
processes (tools/multihost_worker.py) over the SAME total core budget
(1 proc x 4 cores vs 2 procs x 2 cores) and reports

    efficiency = t_1proc / max_p t_2proc        (ideal = 1.0)

Holding total resources constant is what a one-VM simulation can measure
honestly: real second hosts add cores AND memory bandwidth, which a
single VM cannot conjure, so a proportional-resources split (2 cores vs
2+2 cores) conflates DRAM/LLC contention with protocol cost.  The
same-budget ratio isolates exactly the added multi-host work: routing
collectives, drain protocol, per-host shard init skew, and partition
imbalance.  Usage:

    python tools/multihost_bench.py [n_reads] [genome_bp] [profile]

Writes MULTIHOST_BENCH.json at the repo root.
"""

import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

WORKER = REPO / "tools" / "multihost_worker.py"


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(nprocs, workdir, cpus):
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(pid), str(nprocs), str(port),
         str(workdir)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for pid in range(nprocs)]
    t0 = time.time()
    for p in procs:
        rc = p.wait(timeout=1800)
        assert rc == 0, f"worker rc={rc}"
    wall = time.time() - t0
    stats = [json.loads((workdir / f"stats_p{i}.json").read_text())
             for i in range(nprocs)]
    return wall, stats


def _make_data(tmp, n_reads, genome_bp, profile, readlen=100):
    """numpy dataset generator (same workload shapes as bench.py):
    'random' = uniform genome; 'repeat' = ~45% diverged 300bp
    transposon-like copies, the realistic high-candidate-load profile."""
    import numpy as np
    rng = np.random.default_rng(20260817)
    NT = np.frombuffer(b"ACGT", np.uint8)
    if profile == "repeat":
        alu = rng.choice(NT, size=300)
        parts, total = [], 0
        while total < genome_bp:
            u = rng.choice(NT, size=int(rng.integers(300, 1200)))
            parts.append(u)
            total += len(u)
            for _ in range(int(rng.integers(1, 4))):
                cp = np.where(rng.random(300) < 0.05,
                              rng.choice(NT, size=300), alu).astype(np.uint8)
                parts.append(cp)
                total += 300
        g = np.concatenate(parts)[:genome_bp]
    else:
        g = rng.choice(NT, size=genome_bp)
    with open(tmp / "ref.fa", "wb") as f:
        f.write(b">chr1\n")
        n = len(g) // 60 * 60
        f.write(b"\n".join(g[:n].reshape(-1, 60).view("S60").ravel()) + b"\n")
        if n < len(g):
            f.write(g[n:].tobytes() + b"\n")
    pos = rng.integers(0, len(g) - readlen, n_reads)
    reads = np.stack([g[p:p + readlen] for p in pos])
    conv = (reads == ord("A")) & (rng.random(reads.shape) < 0.5)
    reads = np.where(conv, ord("G"), reads)
    err = rng.random(reads.shape) < 0.005
    reads = np.where(err, rng.choice(NT, size=reads.shape),
                     reads).astype(np.uint8)
    with open(tmp / "reads.fq", "wb") as f:
        qual = b"I" * readlen
        for i in range(n_reads):
            f.write(b"@r%d\n" % i + reads[i].tobytes() + b"\n+\n" + qual
                    + b"\n")


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    genome_bp = int(sys.argv[2]) if len(sys.argv) > 2 else 2_000_000
    profile = sys.argv[3] if len(sys.argv) > 3 else "random"
    n_reps = int(sys.argv[4]) if len(sys.argv) > 4 else 15

    tmp = Path(tempfile.mkdtemp(prefix="mh_bench_"))
    print(f"[mh-bench] generating {genome_bp} bp {profile} genome, "
          f"{n_reads} reads -> {tmp}", flush=True)
    _make_data(tmp, n_reads, genome_bp, profile)

    params_kw = dict(conversion="A:G", randseed=7, out_unmap=True,
                     verbose_level=0)
    base_cfg = {"params": params_kw, "ref": str(tmp / "ref.fa"),
                "reads": str(tmp / "reads.fq"), "n_reads": n_reads,
                "mesh_check": False, "local_devices": 1}

    # host steal-time storms make single timings swing widely on shared VMs;
    # measure interleaved (1p, 2p) pairs back-to-back and take the median
    # per-pair efficiency, the same paired methodology bench.py uses
    ncpu = os.cpu_count() or 4
    half = ncpu // 2
    pairs = []
    routed = None
    # rep -1 is an uncounted warmup: it populates the persistent jit cache
    # (the routing collectives + extend kernels compile once ever), which
    # otherwise lands entirely inside the first measured align phase
    for rep in range(-1, n_reps):
        ts = {}
        for nprocs, cpus in ((1, [list(range(ncpu))]),
                             (2, [list(range(half)),
                                  list(range(half, ncpu))])):
            cfg = dict(base_cfg, cpus=cpus)
            (tmp / "mh_cfg.json").write_text(json.dumps(cfg))
            wall, stats = _run(nprocs, tmp, cpus)
            # the scaled phase is the align loop (incl. routing + drain);
            # ref load + index/shard build are per-host startup
            ts[nprocs] = max(s["t_align"] for s in stats)
            if nprocs == 2:
                routed = stats[0]
            print(f"[mh-bench] rep{rep} {nprocs}p x "
                  f"{len(cpus[0])} cores: "
                  f"align {ts[nprocs]:.1f}s, wall {wall:.1f}s", flush=True)
        if rep < 0:
            print("[mh-bench] warmup done (jit caches hot)", flush=True)
            continue
        pairs.append((ts[1], ts[2], ts[1] / ts[2]))
        print(f"[mh-bench] rep{rep}: efficiency {pairs[-1][2]:.3f}",
              flush=True)

    def median(xs):
        s = sorted(xs)
        return s[len(s) // 2]

    # storm rejection: shared VMs see steal-time storms from host
    # neighbours; a storm landing inside either side of
    # a rep makes that rep's ratio meaningless.  Reject reps whose 1-proc
    # align wall deviates >1.5x (either way) from the rep-set median t1 —
    # the 1-proc wall is the storm canary: it runs the identical workload
    # every rep, so its only source of variance is the environment.  Both
    # filtered and raw numbers are recorded; the headline is the filtered
    # median so the artifact converges run-to-run.
    t1_med = median([t1 for t1, _, _ in pairs])
    kept = [p for p in pairs
            if t1_med / 1.5 <= p[0] <= t1_med * 1.5]
    rejected = len(pairs) - len(kept)
    effs_raw = sorted(e for _, _, e in pairs)
    effs = sorted(e for _, _, e in kept) or effs_raw
    eff = median(effs)
    src = kept or pairs
    t1, t2, _ = src[[e for _, _, e in src].index(eff)]
    out = {
        "workload": {"n_reads": n_reads, "genome_bp": genome_bp,
                     "profile": profile, "rule": "A:G", "readlen": 100},
        "t_1proc_s": round(t1, 2),
        "t_2proc_s": round(t2, 2),
        "scaling_efficiency": round(eff, 3),
        "efficiency_min": round(effs[0], 3),
        "efficiency_max": round(effs[-1], 3),
        "raw_median": round(median(effs_raw), 3),
        "raw_pairs": [round(e, 3) for _, _, e in pairs],
        "storm_rejected_reps": rejected,
        "t1_walls_s": [round(t1_, 2) for t1_, _, _ in pairs],
        "t2_walls_s": [round(t2_, 2) for _, t2_, _ in pairs],
        "routing_rounds": routed["routing_rounds"],
        "exchanged_queries": routed["exchanged_queries"],
        "exchanged_locs": routed["exchanged_locs"],
        "note": "same total core budget (1p x all cores vs 2p x half "
                "each); efficiency = t1/max(t2), ideal 1.0, warmup rep + "
                f"median of {n_reps} interleaved pairs after storm "
                "rejection (reps whose 1-proc wall deviates >1.5x from "
                "the rep-set median are dropped; raw numbers disclosed); "
                "isolates routing/drain/skew protocol cost (a one-VM "
                "simulation cannot add the memory bandwidth a real second "
                "host brings); workers are jax.distributed processes on "
                "CPU",
        "gt1_note": (
                "efficiencies above 1.0 can be real on a shared VM: the 1-proc "
                "config mildly oversubscribes 4 cores (4-thread stage "
                "kernels + tail thread) while 2-proc workers get clean "
                "cpuset 2-core splits; the protocol tax is now smaller "
                "than that scheduling difference."),
        "statistic_bias_note": "efficiency uses max over the 2 workers' "
                "align walls (the distributed-run completion time).  Under "
                "uncorrelated per-worker noise the max statistic is biased "
                "high even when both workers are healthy: E[max(X1,X2)] > "
                "E[X1], so measured efficiency < true efficiency by "
                "roughly half the workers' noise CV.  Additionally the "
                "~1.2-2.0s serial drain/routing tail is Amdahl-fixed: at "
                "this workload size it caps same-budget efficiency near "
                "0.85-0.9 even with zero contention; larger n_reads "
                "amortize it.",
    }
    (REPO / "MULTIHOST_BENCH.json").write_text(json.dumps(out, indent=1))
    print(f"[mh-bench] scaling efficiency at 2 hosts: {eff:.3f} "
          f"(t1={t1:.1f}s t2={t2:.1f}s, rejected {rejected}/{len(pairs)} "
          f"storm reps, raw median {median(effs_raw):.3f})", flush=True)


if __name__ == "__main__":
    main()
