"""Multi-host worker: one process of a jax.distributed alignment run.

Usage: python tools/multihost_worker.py PID NPROCS PORT WORKDIR

SURVEY §4's prescribed multi-host simulation: N local processes, CPU
backend with 2 virtual devices each, coordinated via jax.distributed.
Each worker:

 1. joins the cluster (``init_multihost``),
 2. builds ONLY its k-mer-range shard of the seed index (shard-resident —
    ``SeedIndex.gather()`` is never called),
 3. aligns its contiguous global-read-index window through the production
    SE pipeline, fetching index entries per batch via RoutedSeedIndex's
    batched cross-shard routing,
 4. drains peers' routing rounds, then
 5. (all workers, collectively) proves the rs-spanning extension mesh equals
    the local single-device kernel on a shared candidate table, and
 6. writes its SAM body + a timing/stats JSON.

Config (WORKDIR/mh_cfg.json): {"params": {AlignParams kwargs}, "ref": path,
"reads": path, "n_reads": int, "cpus": [[...], ...] per-pid core pins,
"mesh_check": bool}.
"""

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    workdir = Path(sys.argv[4])
    cfg = json.loads((workdir / "mh_cfg.json").read_text())

    cpus = cfg.get("cpus")
    if cpus:
        os.sched_setaffinity(0, set(cpus[pid]))

    from basal_jax.parallel.multihost import (
        RoutedSeedIndex, init_multihost, make_multihost_mesh, read_window)
    init_multihost(f"localhost:{port}", nprocs, pid,
                   local_devices=cfg.get("local_devices", 2))
    import dataclasses

    import numpy as np

    from basal_jax.align.pipeline import run_single_end
    from basal_jax.config import AlignParams

    params = AlignParams(**cfg["params"])
    params = dataclasses.replace(params, sam_header=(pid == 0))
    wparams = read_window(params, cfg["n_reads"])

    holder = {}

    def factory(ref, p):
        holder["ref"] = ref
        idx = RoutedSeedIndex(ref, p)
        holder["idx"] = idx
        return idx

    t0 = time.time()
    timings = {}
    out_path = workdir / f"out_p{pid}.sam"
    with open(out_path, "wb") as fh:
        log = ((lambda m, *a: print(f"[p{pid}] {m}", file=sys.stderr,
                                    flush=True))
               if cfg.get("debug") else (lambda *a: None))
        if cfg.get("reads_b"):
            from basal_jax.pairs.pipeline import run_pair_end
            aligner = run_pair_end(
                wparams, cfg["ref"], cfg["reads"], cfg["reads_b"],
                out_fh=fh, command_line=cfg.get("cmdline", "basal-jax"),
                index_factory=factory, timings=timings, log=log)
        else:
            aligner = run_single_end(
                wparams, cfg["ref"], cfg["reads"], out_fh=fh,
                command_line=cfg.get("cmdline", "basal-jax"),
                index_factory=factory, timings=timings, log=log)
    idx = holder["idx"]
    idx.drain()
    t_total = time.time() - t0
    t_align = time.time() - timings["t_align_start"]

    stats = {
        "pid": pid,
        "nprocs": nprocs,
        "t_ref": timings["t_ref"],
        "t_index": timings["t_index"],
        "t_align": t_align,
        "t_total": t_total,
        "reads": getattr(aligner, "total_reads", 0),
        "candidates": getattr(aligner, "total_candidates", 0),
        "routing_rounds": idx.rounds,
        "t_exchange": idx.t_exchange,
        "t_wait": idx.t_wait,
        "t_phase": {k: round(v, 3) for k, v in idx.t_phase.items()},
        "exchanged_queries": idx.exchanged_queries,
        "exchanged_locs": idx.exchanged_locs,
        "local_shard_kmers": int(idx.bounds[pid + 1] - idx.bounds[pid]),
        "local_shard_positions": int(len(idx.shard.locs)),
        "host_eval_s": getattr(aligner, "_host_t", 0.0),
    }
    dev = aligner._dev
    if dev is not None and dev.meas_n:
        stats["extend_s_per_cand"] = dev.meas_t / dev.meas_n
        stats["extend_cands_measured"] = dev.meas_n

    if cfg.get("mesh_check", True) and nprocs > 1:
        stats["mesh"] = _mesh_check(holder["ref"], params, cfg)

    (workdir / f"stats_p{pid}.json").write_text(json.dumps(stats))
    print(f"[p{pid}] done: {stats}", flush=True)


def _mesh_check(ref, params, cfg):
    """Collective: extension over an rs-spanning global mesh must equal the
    local single-device kernel on the same (shared) candidate table."""
    import numpy as np

    from basal_jax.align.candidates import build_candidates
    from basal_jax.align.pipeline import DeviceContext, SingleEndAligner
    from basal_jax.align.rng import MyRand
    from basal_jax.align.candidates import SeedScheduler
    from basal_jax.index.seedindex import build_index
    from basal_jax.parallel.mesh import ShardedDeviceContext
    from basal_jax.parallel.multihost import make_multihost_mesh
    from basal_jax.reads.encode import encode_batch
    from basal_jax.reads.io import open_reads

    # every process uses the SAME reads and a locally built dense index so
    # the candidate table is identical everywhere (the routed index was
    # consumed by the per-window align; this check isolates the mesh)
    index = build_index(ref, params)
    rd = open_reads(cfg["reads"], params)
    full = rd.next_batch()
    batch = [full[i] for i in range(min(256, len(full)))]
    rd.close()
    enc = encode_batch(params, batch)
    sched = SeedScheduler(params, index, MyRand(params.randseed))
    table = build_candidates(params, index, enc, sched)

    dev = DeviceContext(ref, params)
    c0, _, _ = dev.extend(enc, table.loc, table.plane, table.row)

    mesh = make_multihost_mesh()
    ctx = ShardedDeviceContext(ref, params, mesh)
    t0 = time.time()
    c1, _, _ = ctx.extend(enc, table.loc, table.plane, table.row)
    t_mesh = time.time() - t0
    ok = bool(np.array_equal(np.asarray(c0), np.asarray(c1)))
    return {"ok": ok, "candidates": int(table.loc.size),
            "rs_span_processes": int(mesh.shape["rs"]),
            "t_mesh_extend": t_mesh}


if __name__ == "__main__":
    main()
