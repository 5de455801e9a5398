"""Paired-end benchmark (jax on the CPU): our PE pipeline on jax-cpu vs the
oracle binary, whole-run wall on the same data.

Usage: python tools/pebench.py [random|repeat] [n_pairs]
Prints per-pass wall/pairs-per-second for ours and the oracle, plus the
SAM-equality rate.  The repeat profile is bench.py's 50 Mbp repeat
genome.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROFILE = sys.argv[1] if len(sys.argv) > 1 else "repeat"
N_PAIRS = int(sys.argv[2]) if len(sys.argv) > 2 else 20_000
os.environ["BENCH_PROFILE"] = PROFILE
os.environ.setdefault("BASAL_HOST_EVAL", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import bench  # noqa: E402  (reuses the genome generator + oracle build)

work = ROOT / ".oracle" / "benchdata"
work.mkdir(parents=True, exist_ok=True)
ref_fa, _ = bench.make_data(work)
oracle = bench.ensure_oracle()

fq_a = work / f"pe_{PROFILE}_{N_PAIRS}_1.fq"
fq_b = work / f"pe_{PROFILE}_{N_PAIRS}_2.fq"
if not (fq_a.exists() and fq_b.exists()):
    rng = np.random.default_rng(20260817)
    NT = np.frombuffer(b"ACGT", np.uint8)
    COMP = np.zeros(256, np.uint8)
    for x, y in zip(b"ACGT", b"TGCA"):
        COMP[x] = y
    g = []
    with open(ref_fa, "rb") as f:
        for line in f:
            if not line.startswith(b">"):
                g.append(np.frombuffer(line.strip(), np.uint8))
    g = np.concatenate(g)
    L = 100
    ins = rng.integers(180, 420, N_PAIRS)
    pos = rng.integers(0, len(g) - 500, N_PAIRS)
    with open(fq_a, "wb") as fa, open(fq_b, "wb") as fb:
        qual = b"I" * L
        for i in range(N_PAIRS):
            a = g[pos[i]:pos[i] + L].copy()
            b = COMP[g[pos[i] + ins[i] - L:pos[i] + ins[i]]][::-1].copy()
            for r in (a, b):
                conv = (r == ord("A")) & (rng.random(L) < 0.5)
                r[conv] = ord("G")
                err = rng.random(L) < 0.005
                r[err] = rng.choice(NT, size=L)[err]
            fa.write(b"@p%d\n" % i + a.tobytes() + b"\n+\n" + qual + b"\n")
            fb.write(b"@p%d\n" % i + b.tobytes() + b"\n+\n" + qual + b"\n")

ours_sam = work / "pe_ours.sam"
orc_sam = work / "pe_oracle.sam"
ARGS = ["-M", "A:G", "-S", "1", "-V", "0"]

from basal_jax.cli import main as cli_main  # noqa: E402

for rep in range(3):
    t0 = time.time()
    sys.argv = (["basal-jax", "-d", str(ref_fa), "-a", str(fq_a),
                 "-b", str(fq_b), "-o", str(ours_sam)] + ARGS)
    cli_main()
    dt = time.time() - t0
    print(f"[pebench] ours pass {rep}: {N_PAIRS} pairs {dt:.2f}s = "
          f"{N_PAIRS/dt:.0f} pairs/s", file=sys.stderr)
    t0 = time.time()
    subprocess.run([str(oracle), "-d", str(ref_fa), "-a", str(fq_a),
                    "-b", str(fq_b), "-o", str(orc_sam)] + ARGS,
                   check=True, capture_output=True)
    dt = time.time() - t0
    print(f"[pebench] oracle pass {rep}: {dt:.2f}s = "
          f"{N_PAIRS/dt:.0f} pairs/s", file=sys.stderr)


def body(p):
    with open(p) as f:
        return [l for l in f if not l.startswith("@")]


ours, orc = body(ours_sam), body(orc_sam)
eq = sum(a == b for a, b in zip(ours, orc))
print(f"[pebench] SAM equality: {eq}/{max(len(ours), len(orc))}",
      file=sys.stderr)
