"""RRBS (-D C-CGG) whole-run benchmark: our CLI as a subprocess (so the
interpreter startup is charged, same as any user run) vs the oracle binary,
interleaved passes on the same data.

Usage: python tools/rrbsbench.py [n_reads] [n_frags] [se|pe]
Defaults: 100k reads over a ~2 Mbp MspI-digested genome (10.5k fragments),
single-end.  ``pe`` benchmarks the paired-end RRBS path (n_reads PAIRS;
R1 = fragment 5' cut, R2 = revcomp 3' end; pairs.cpp:132-174 lockstep with
the fragment index's pairend entries).
Prints per-pass walls, medians, the pair ratios, and the SAM-equality count.
"""
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

N_READS = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
N_FRAGS = int(sys.argv[2]) if len(sys.argv) > 2 else 10_500
MODE = sys.argv[3] if len(sys.argv) > 3 else "se"

work = ROOT / ".oracle" / "benchdata"
work.mkdir(parents=True, exist_ok=True)
ref_fa = work / f"rrbs_{N_FRAGS}{'pe' if MODE == 'pe' else ''}.fa"
reads_fq = work / f"rrbs_{N_FRAGS}_{N_READS}_{MODE}.fq"
reads2_fq = work / f"rrbs_{N_FRAGS}_{N_READS}_{MODE}_2.fq"


def _pe_reads(rng, g, n):
    """Fragment-spanning RRBS pairs (same shapes as
    tests/test_differential_rrbs.py::test_rrbs_pe, scaled up)."""
    comp = str.maketrans("ACGT", "TGCA")
    sites = []
    i = g.find("CCGG")
    while i >= 0:
        sites.append(i + 1)
        i = g.find("CCGG", i + 1)
    frags = [(a, b) for a, b in zip(sites, sites[1:]) if b + 1 - a >= 80]
    r1s, r2s = [], []
    for k in range(n):
        a, b = frags[rng.randrange(len(frags))]
        frag = g[a:b + 1]
        conv = "".join("T" if (c == "C" and rng.random() < 0.6) else c
                       for c in frag)
        L = min(60, len(conv))
        r1s.append((f"p{k}/1", conv[:L]))
        r2s.append((f"p{k}/2", conv[-L:].translate(comp)[::-1]))
    return r1s, r2s


if not (ref_fa.exists() and reads_fq.exists()
        and (MODE != "pe" or reads2_fq.exists())):
    from test_differential_rrbs import rrbs_genome, rrbs_reads
    from conftest import make_ref, make_fastq
    rng = random.Random(99)
    lo, hi = (120, 320) if MODE == "pe" else (60, 320)
    g = rrbs_genome(rng, n_frags=N_FRAGS, frag_lo=lo, frag_hi=hi)
    make_ref(ref_fa, [("chrR", g)])
    if MODE == "pe":
        r1s, r2s = _pe_reads(rng, g, N_READS)
        make_fastq(reads_fq, r1s)
        make_fastq(reads2_fq, r2s)
    else:
        make_fastq(reads_fq, rrbs_reads(rng, g, N_READS))
    print(f"[rrbsbench] genome {len(g)} bp, data cached", file=sys.stderr)

oracle = ROOT / ".oracle" / "basal"
if not oracle.exists():
    subprocess.run(["bash", str(ROOT / "tools" / "build_oracle.sh")],
                   check=True, capture_output=True)

ours_sam = work / "rrbs_ours.sam"
orc_sam = work / "rrbs_oracle.sam"
ARGS = ["-M", "C:T", "-S", "1", "-V", "0", "-D", "C-CGG", "-u"]
if MODE == "pe":
    ARGS += ["-b", str(reads2_fq), "-m", "28", "-x", "600"]

# CPU-only children: JAX_PLATFORMS=cpu routes auto placement to the host evaluator
# without importing jax at all (align.pipeline._cpu_backend env branch).
env = dict(os.environ)
env["PYTHONPATH"] = str(ROOT)
env["JAX_PLATFORMS"] = "cpu"

ratios = []
w_ours, w_orc = [], []
for rep in range(3):
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "basal_jax.cli",
                    "-d", str(ref_fa), "-a", str(reads_fq),
                    "-o", str(ours_sam)] + ARGS,
                   check=True, capture_output=True, env=env, cwd=ROOT)
    dt_o = time.time() - t0
    t0 = time.time()
    subprocess.run([str(oracle), "-d", str(ref_fa), "-a", str(reads_fq),
                    "-o", str(orc_sam)] + ARGS,
                   check=True, capture_output=True)
    dt_r = time.time() - t0
    w_ours.append(dt_o)
    w_orc.append(dt_r)
    ratios.append(dt_r / dt_o)
    print(f"[rrbsbench {MODE}] pass {rep}: ours {dt_o:.2f}s "
          f"({N_READS/dt_o:.0f} r/s)  oracle {dt_r:.2f}s "
          f"({N_READS/dt_r:.0f} r/s)  ratio {dt_r/dt_o:.2f}",
          file=sys.stderr)


def body(p):
    with open(p) as f:
        return [l for l in f if not l.startswith("@")]


ours, orc = body(ours_sam), body(orc_sam)
eq = sum(a == b for a, b in zip(ours, orc))
print(f"[rrbsbench] SAM equality: {eq}/{max(len(ours), len(orc))}",
      file=sys.stderr)
print(f"[rrbsbench] median ours {statistics.median(w_ours):.2f}s  "
      f"oracle {statistics.median(w_orc):.2f}s  "
      f"ratio {statistics.median(ratios):.2f}", file=sys.stderr)
