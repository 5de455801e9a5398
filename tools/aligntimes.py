"""Per-phase cycle attribution for the fused SE host pass: builds an
engine.cpp variant with -DBT_PROF_TIMES (rdtsc scopes around the gather /
schedule / enumerate / scan / emit regions, behavior unchanged) and prints
the cycle split for NativeBatch.align_se_host on the bench batch.

Usage: python tools/aligntimes.py [reps]
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

REPS = int(sys.argv[1]) if len(sys.argv) > 1 else 8

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
real_lib = get_lib()  # production lib first (restypes set)

def build(name, extra):
    so = Path(f"/tmp/engine_align_times_{name}.so")
    cmd = ["g++", "-O2", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-DBT_PROF_TIMES", *extra, str(SRC), "-o", str(so)]
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.bt_align_se_host.restype = ctypes.c_int64
    return lib


variants = [("base", []), ("nopush", ["-DBT_PROF_NOPUSH"])]
libs = {n: build(n, e) for n, e in variants}

nb = NativeBatch(p, idx, ref)
B = len(enc.reads)
state0 = nb.state.copy()
sst0 = nb.seed_state.copy()
rst0 = nb.reg_state.copy()

names = ["fill_gather", "sched_search", "enumerate", "scan_eval", "emit"]
out5 = (ctypes.c_uint64 * 5)()
for vname, _ in variants:
    lib = libs[vname]
    natmod.get_lib = lambda lib=lib: lib
    best_wall = 1e9
    best_cyc = None
    for _ in range(REPS):
        nb.state[:] = state0
        nb.seed_state[:] = sst0
        nb.reg_state[:] = rst0
        lib.bt_prof_times(out5, 1)  # reset
        t0 = time.time()
        res, ncand, neval = nb.align_se_host(enc, ridx, ref)
        dt = time.time() - t0
        lib.bt_prof_times(out5, 0)
        cyc = list(out5)
        if dt < best_wall:
            best_wall, best_cyc = dt, cyc
        tot = sum(cyc)
        print(f"[aligntimes {vname}] wall {1e6*dt/B:.3f} us/read  "
              + "  ".join(f"{n}={c/B:.0f}cyc({100*c/max(tot,1):.0f}%)"
                          for n, c in zip(names, cyc)),
              file=sys.stderr)
    print(f"[aligntimes {vname}] BEST wall {1e6*best_wall/B:.3f} us/read; "
          "cycles/read: "
          + "  ".join(f"{n}={c/B:.0f}" for n, c in zip(names, best_cyc)),
          file=sys.stderr)
