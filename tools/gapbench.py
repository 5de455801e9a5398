"""Gapped-alignment benchmark (BID-seq profile: -M T:- -g 3) on jax-cpu,
ours vs the oracle binary, whole-run wall on the same data.

The round-1 verdict called out the gapped path as the worst case on a
repetitive reference (every candidate needed an i16 position-list
round-trip).  Round 2 added the gapped host fast lane (visit-time
gap_align_ev in the C++ scan), which this tool measures.

Usage: python tools/gapbench.py [random|repeat] [n_reads]
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROFILE = sys.argv[1] if len(sys.argv) > 1 else "repeat"
N_READS = int(sys.argv[2]) if len(sys.argv) > 2 else 50_000
os.environ["BENCH_PROFILE"] = PROFILE

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import bench  # noqa: E402

work = ROOT / ".oracle" / "benchdata"
work.mkdir(parents=True, exist_ok=True)
ref_fa, _ = bench.make_data(work)
oracle = bench.ensure_oracle()

fq = work / f"gap_{PROFILE}_{N_READS}.fq"
if not fq.exists():
    rng = np.random.default_rng(20260818)
    NT = np.frombuffer(b"ACGT", np.uint8)
    g = []
    with open(ref_fa, "rb") as f:
        for line in f:
            if not line.startswith(b">"):
                g.append(np.frombuffer(line.strip(), np.uint8))
    g = np.concatenate(g)
    L = 100
    pos = rng.integers(0, len(g) - L - 8, N_READS)
    with open(fq, "wb") as f:
        qual = b"I" * L
        for i in range(N_READS):
            # BID-seq chemistry: a converted T is DELETED from the read
            # (rule T:-); take a longer window, drop each T with p=0.04
            # (mean ~1 deletion per 100bp read — a higher rate makes most
            # reads exceed -g 3 and degenerates the run into full
            # unalignable scans on both sides), truncate to L
            w = g[pos[i]:pos[i] + L + 8]
            drop = (w == ord("T")) & (rng.random(len(w)) < 0.04)
            r = w[~drop][:L].copy()
            err = rng.random(len(r)) < 0.003
            r[err] = rng.choice(NT, size=len(r))[err]
            f.write(b"@r%d\n" % i + r.tobytes() + b"\n+\n" + qual + b"\n")

ours_sam = work / "gap_ours.sam"
orc_sam = work / "gap_oracle.sam"
ARGS = ["-M", "T:-", "-g", "3", "-S", "1", "-V", "0"]

from basal_jax.cli import main as cli_main  # noqa: E402

for rep in range(3):
    t0 = time.time()
    sys.argv = (["basal-jax", "-d", str(ref_fa), "-a", str(fq),
                 "-o", str(ours_sam)] + ARGS)
    cli_main()
    dt = time.time() - t0
    print(f"[gapbench] ours pass {rep}: {N_READS} reads {dt:.2f}s = "
          f"{N_READS/dt:.0f} reads/s", file=sys.stderr)
    t0 = time.time()
    subprocess.run([str(oracle), "-d", str(ref_fa), "-a", str(fq),
                    "-o", str(orc_sam), "-p", "1"] + ARGS,
                   check=True, capture_output=True)
    dt = time.time() - t0
    print(f"[gapbench] oracle pass {rep}: {dt:.2f}s = "
          f"{N_READS/dt:.0f} reads/s", file=sys.stderr)


def body(p):
    with open(p) as f:
        return [l for l in f if not l.startswith("@")]


ours, orc = body(ours_sam), body(orc_sam)
eq = sum(a == b for a, b in zip(ours, orc))
print(f"[gapbench] SAM equality: {eq}/{max(len(ours), len(orc))}",
      file=sys.stderr)
