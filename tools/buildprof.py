"""Attribution microbench for bt_build_groups_mt: compiles engine.cpp
variants with -D knobs and times them on one identical 50k-read batch.

Variants (see #ifdef BT_PROF_* in engine.cpp — debug-only, off in prod):
  base           current code
  gather         -DBT_GATHER_COUNTS (AVX-512 hardware gather)
  nosched        skip ReorderSeed/relax/sort (attribution only)
  nogather       skip the counts gather, cc=1 (attribution only)

Usage: python tools/buildprof.py [reps]
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
from basal_jax.native import NativeBatch, _p, _ncpu

p = AlignParams(conversion="A:G", randseed=1, verbose_level=0)
ref = load_reference(str(ref_fa), p)
idx = build_index(ref, p)
rd = open_reads(str(reads_fq), p)
b = rd.next_batch(50_000)
enc = encode_batch(p, b)
ridx = enc.reads.indices
rd.close()

SRC = ROOT / "basal_jax" / "native" / "engine.cpp"


def build_variant(name, defs):
    so = Path(f"/tmp/engine_{name}.so")
    cmd = ["g++", "-O2", "-march=native", "-shared", "-fPIC", "-std=c++17",
           *[f"-D{d}" for d in defs], str(SRC), "-o", str(so)]
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.bt_build_groups_mt.restype = ctypes.c_int64
    return lib


nb = NativeBatch(p, idx, ref)
args_common, sv = nb._common_args(enc, ridx)
B = len(enc.reads)
ub = int(2 * p.index_interval * int(enc.seedseg_num.sum())) + 1
groups = np.empty((ub, 10), np.int64)
goff = np.empty(B + 1, np.int64)

variants = [
    ("base", []),
    ("gather", ["BT_GATHER_COUNTS"]),
    ("nosched", ["BT_PROF_NOSCHED"]),
    ("nogather", ["BT_PROF_NOGATHER"]),
]
libs = {n: build_variant(n, d) for n, d in variants}
for rnd in range(3):
    for name, _ in variants:
        lib = libs[name]
        ng = ctypes.c_int64(0)
        state = np.zeros(2, np.int32)
        seed_state = np.zeros(2 * 480, np.uint32)
        reg_state = np.zeros(2 * 480, np.uint8)
        best = 1e9
        for _ in range(REPS):
            state[:] = 0
            seed_state[:] = 0
            reg_state[:] = 0
            t0 = time.time()
            total = lib.bt_build_groups_mt(
                *args_common, _p(state, ctypes.c_int32),
                _p(seed_state, ctypes.c_uint32),
                _p(reg_state, ctypes.c_uint8),
                _p(groups, ctypes.c_int64), _p(goff, ctypes.c_int64),
                ctypes.byref(ng), ctypes.c_int32(min(_ncpu(), 8)))
            best = min(best, time.time() - t0)
        print(f"[buildprof r{rnd}] {name:9s} best {1e6*best/B:.3f} us/read "
              f"(total={total} ng={ng.value})", file=sys.stderr)
