"""Attribution microbench for the fused SE host pass (bt_align_se_host):
compiles engine.cpp variants with -D knobs, swaps them in via get_lib
monkeypatching, and times NativeBatch.align_se_host on one identical
50k-read bench batch.

Variants (debug-only #ifdefs, off in prod):
  base      current code
  nosched   skip ReorderSeed best-offset/relax/sort (attribution only)
  nogather  counts cache = 1 (skips the 43M-table gather; attribution only)
  noscan    enumerate candidate groups but skip the visit-time scan/eval

Usage: python tools/alignprof.py [reps]
"""
import ctypes
import os
import subprocess
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

REPS = int(sys.argv[1]) if len(sys.argv) > 1 else 10

work = ROOT / ".oracle" / "benchdata"
work.mkdir(parents=True, exist_ok=True)
ref_fa, reads_fq = bench.make_data(work)

from basal_jax.config import AlignParams
from basal_jax.index.reference import load_reference
from basal_jax.index.seedindex import build_index
from basal_jax.reads.io import open_reads
from basal_jax.reads.encode import encode_batch
from basal_jax import native as natmod
from basal_jax.native import NativeBatch, get_lib

p = AlignParams(conversion="A:G", randseed=1, verbose_level=0)
ref = load_reference(str(ref_fa), p)
idx = build_index(ref, p)
rd = open_reads(str(reads_fq), p)
b = rd.next_batch(50_000)
enc = encode_batch(p, b)
ridx = enc.reads.indices
rd.close()

SRC = ROOT / "basal_jax" / "native" / "engine.cpp"
real_lib = get_lib()  # force production lib load first (restypes set)


def build_variant(name, defs):
    so = Path(f"/tmp/engine_align_{name}.so")
    cmd = ["g++", "-O2", "-march=native", "-shared", "-fPIC", "-std=c++17",
           *[f"-D{d}" for d in defs], str(SRC), "-o", str(so)]
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.bt_align_se_host.restype = ctypes.c_int64
    return lib


variants = [
    ("base", []),
    ("nosched", ["BT_PROF_NOSCHED"]),
    ("nogather", ["BT_PROF_NOGATHER"]),
    ("noscan", ["BT_PROF_NOSCAN"]),
]
libs = {n: build_variant(n, d) for n, d in variants}

nb = NativeBatch(p, idx, ref)
B = len(enc.reads)
state0 = nb.state.copy()
sst0 = nb.seed_state.copy()
rst0 = nb.reg_state.copy()

for rnd in range(3):
    for name, _ in variants:
        natmod.get_lib = lambda lib=libs[name]: lib
        best = 1e9
        for _ in range(REPS):
            nb.state[:] = state0
            nb.seed_state[:] = sst0
            nb.reg_state[:] = rst0
            t0 = time.time()
            res, ncand, neval = nb.align_se_host(enc, ridx, ref)
            best = min(best, time.time() - t0)
        print(f"[alignprof r{rnd}] {name:9s} best {1e6*best/B:.3f} us/read "
              f"(ncand={ncand} neval={neval})", file=sys.stderr)
