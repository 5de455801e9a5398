"""Attribution microbench for bt_encode_batch: compiles engine.cpp variants
with -D knobs and times them on one identical 50k-read batch (bench data,
zero-string raw path shapes).

Variants (debug-only #ifdefs in engine.cpp, off in prod):
  base     current code
  noseed   skip the rolling base-3 seed loop (attribution only)
  nopack   skip the pext plane packing (attribution only)
  norev    skip the chain-1 byte reversal (attribution only; WRONG output)

Usage: python tools/encodeprof.py [reps]
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

REPS = int(sys.argv[1]) if len(sys.argv) > 1 else 20

work = ROOT / ".oracle" / "benchdata"
work.mkdir(parents=True, exist_ok=True)
ref_fa, reads_fq = bench.make_data(work)

from basal_jax.config import AlignParams, REG_ALPHABET
from basal_jax.reads.io import open_reads
from basal_jax.native import _p, _ncpu

p = AlignParams(conversion="A:G", randseed=1, verbose_level=0)
rd = open_reads(str(reads_fq), p)
rb = rd.next_batch(50_000)
rd.close()

B = len(rb)
map_len = np.ascontiguousarray(rb.seq_len, np.int32)
lmax = max(int(map_len.max(initial=1)), p.seed_size)
W = max(4, -(-lmax // 16))
S = lmax - p.seed_size + 1
soff = np.ascontiguousarray(rb.seq_off, np.int64)
rule = p.rule

SRC = ROOT / "basal_jax" / "native" / "engine.cpp"


def build_variant(name, defs):
    so = Path(f"/tmp/engine_enc_{name}.so")
    cmd = ["g++", os.environ.get("BT_OPT", "-O2"), "-march=native", "-shared", "-fPIC", "-std=c++17",
           *[f"-D{d}" for d in defs], str(SRC), "-o", str(so)]
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.bt_encode_batch.restype = ctypes.c_int64
    return lib


variants = [
    ("base", []),
    ("noseed", ["BT_PROF_NOSEED"]),
    ("nopack", ["BT_PROF_NOPACK"]),
    ("norev", ["BT_PROF_NOREV"]),
    ("seedl1", ["BT_PROF_SEEDL1"]),
]
libs = {n: build_variant(n, d) for n, d in variants}

base_a = np.empty((2 * B, W), np.uint32)
valid_a = np.empty((2 * B, W), np.uint32)
mread_a = np.empty((2 * B, W), np.uint32)
lenmask_a = np.empty((2 * B, W), np.uint32)
seedval_a = np.empty((B, 2, S), np.uint32)
has_n_a = np.empty((B, 2, S), np.uint8)
ncnt_a = np.empty(B, np.int32)

for rnd in range(3):
    for name, _ in variants:
        lib = libs[name]
        best = 1e9
        for _ in range(REPS):
            t0 = time.time()
            lib.bt_encode_batch(
                ctypes.c_int32(B), ctypes.c_int32(lmax), ctypes.c_int32(W),
                ctypes.c_int32(p.seed_size), ctypes.c_int32(0),
                _p(rb.buf, ctypes.c_uint8), _p(soff, ctypes.c_int64),
                _p(map_len, ctypes.c_int32),
                _p(rule.alphabet, ctypes.c_uint8),
                _p(rule.rev_alphabet, ctypes.c_uint8),
                _p(rule.alphabet_mread, ctypes.c_uint8),
                _p(rule.rev_alphabet_mread, ctypes.c_uint8),
                _p(REG_ALPHABET, ctypes.c_uint8),
                _p(base_a, ctypes.c_uint32), _p(valid_a, ctypes.c_uint32),
                _p(mread_a, ctypes.c_uint32), _p(lenmask_a, ctypes.c_uint32),
                _p(seedval_a, ctypes.c_uint32), _p(has_n_a, ctypes.c_uint8),
                _p(ncnt_a, ctypes.c_int32),
                ctypes.c_int32(min(_ncpu(), 8)))
            best = min(best, time.time() - t0)
        print(f"[encodeprof r{rnd}] {name:7s} best {1e6*best/B:.3f} us/read",
              file=sys.stderr)
