"""Per-stage host-path profiler: times encode / build_groups / fill_eval /
replay / format separately over the bench dataset (BASAL_HOST_EVAL=1,
jax-cpu).  Numbers in us/read; run twice in-process for warm numbers.

Usage: python tools/stageprof.py [n_reads] [batch]
"""
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("BASAL_HOST_EVAL", "1")

import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
import bench

N = int(sys.argv[1]) if len(sys.argv) > 1 else 600_000
BATCH = int(sys.argv[2]) if len(sys.argv) > 2 else 50_000

work = ROOT / ".oracle" / "benchdata"
work.mkdir(parents=True, exist_ok=True)
ref_fa, reads_fq = bench.make_data(work)

from basal_jax.config import AlignParams
from basal_jax.index.reference import load_reference
from basal_jax.index.seedindex import build_index
from basal_jax.reads.io import open_reads, RawBatch
from basal_jax.align.pipeline import SingleEndAligner
from basal_jax.reads.encode import encode_batch

p = AlignParams(conversion="A:G", randseed=1, verbose_level=0)
ref = load_reference(str(ref_fa), p)
idx = build_index(ref, p)
al = SingleEndAligner(p, ref, idx)

for rep in range(2):
    t = {"read": 0.0, "encode": 0.0, "build": 0.0, "fill_eval": 0.0,
         "replay": 0.0, "format": 0.0}
    n = 0
    rd = open_reads(str(reads_fq), p)
    t_all0 = time.time()
    while n < N:
        t0 = time.time()
        b = rd.next_batch(BATCH)
        t["read"] += time.time() - t0
        if not b:
            break
        n += len(b)
        t0 = time.time()
        enc = encode_batch(p, b)
        t["encode"] += time.time() - t0
        ridx = (enc.reads.indices if isinstance(enc.reads, RawBatch)
                else np.array([r.index for r in enc.reads], dtype=np.uint32))
        t0 = time.time()
        groups, goff, total = al.native.build_groups(enc, ridx)
        t["build"] += time.time() - t0
        ng = groups.shape[0]
        off = np.full(ng, -1, dtype=np.int64)
        sel = np.arange(ng)
        n1c = int(groups[sel, 6].sum())
        loc = np.empty(n1c, np.int32)
        cnt = np.empty(n1c, np.int32)
        t0 = time.time()
        al.native.fill_eval_groups(enc, ref, groups, sel, off, 0, loc, cnt,
                                   n_threads=0)
        t["fill_eval"] += time.time() - t0
        t0 = time.time()
        z = np.zeros(0, np.int32)
        res = al.native.replay_se(enc, groups, goff, loc, None, cnt,
                                  None, None, counts_off=off, n_threads=0)
        t["replay"] += time.time() - t0
        t0 = time.time()
        out = al._emit_native(enc, [(None, res)])
        t["format"] += time.time() - t0
    wall = time.time() - t_all0
    rd.close()
    line = " ".join(f"{k}={1e6 * v / n:.2f}" for k, v in t.items())
    tracked = sum(t.values())
    print(f"[stageprof] pass {rep}: n={n} wall={wall:.2f}s "
          f"({n/wall:.0f} r/s) us/read: {line} "
          f"untracked={1e6*(wall-tracked)/n:.2f}", file=sys.stderr)
