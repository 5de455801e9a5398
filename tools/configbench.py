"""BASELINE.md measurement plan: ours vs the reference binary on the
driver's five configs (BASELINE.json), whole-run wall, same data,
interleaved passes, per-config median pair ratio + SAM/BAM equality.

  1. SE  -M C:T  -g 0 -s 16        (bisulfite, small FASTA ref)
  2. SE  -M A:G  -v 5              (GLORI/eTAM with -v cap; -k default)
  3. SE  -M A:CGT -w 20 -r 1       (m6A-SAC/m1A multi-hit)
  4. SE  -M T:-  -g 3              (BID-seq, gapped)
  5. PE  -a/-b  -o out.bam         (BAM output; 2-host sharding is
                                    covered by tests/test_multihost.py)

Usage: python tools/configbench.py [n_reads] [genome_bp]
Runs on jax-cpu (never touches an accelerator).  Prints one summary line per config.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import bench

N = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
G = int(sys.argv[2]) if len(sys.argv) > 2 else 2_000_000
L = 100
work = ROOT / ".oracle" / "configbench"
work.mkdir(parents=True, exist_ok=True)
oracle = bench.ensure_oracle()
assert oracle, "oracle binary required"

rng = np.random.default_rng(20260818)
NT = np.frombuffer(b"ACGT", np.uint8)
g = rng.choice(NT, size=G)
ref_fa = work / "ref.fa"
if not ref_fa.exists():
    with open(ref_fa, "wb") as f:
        f.write(b">chr1\n")
        n = G // 60 * 60
        f.write(b"\n".join(g[:n].reshape(-1, 60).view("S60").ravel())
                + b"\n" + g[n:].tobytes() + b"\n")


def write_fq(path, rule, n, mate=0, insmin=150, insmax=400):
    """Planted-conversion reads for one rule; mate=1/2 makes a PE pair set
    (mate 2 is the reverse complement of the fragment end)."""
    if path.exists():
        return
    frm, tos = rule.split(":")
    tos = tos.replace("-", "")
    rng2 = np.random.default_rng(7 + mate)
    qual = b"I" * L
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    with open(path, "wb") as f:
        for i in range(n):
            if mate:
                ins = int(rng2.integers(insmin, insmax))
                p0 = int(rng2.integers(0, G - ins - 8))
                w = g[p0:p0 + ins]
                r = w[:L].copy() if mate == 1 else comp[w[::-1][:L]].copy()
            else:
                p0 = int(rng2.integers(0, G - L - 8))
                r = g[p0:p0 + L + 8].copy()
            if not tos:               # T:- BID-seq: converted base deleted
                drop = (r == ord(frm)) & (rng2.random(len(r)) < 0.04)
                r = r[~drop][:L].copy()
            else:
                conv = (r == ord(frm)) & (rng2.random(len(r)) < 0.5)
                sub = rng2.choice(np.frombuffer(tos.encode(), np.uint8),
                                  size=len(r))
                r = np.where(conv, sub, r).astype(np.uint8)
                r = r[:L].copy()
            err = rng2.random(len(r)) < 0.005
            r[err] = rng2.choice(NT, size=len(r))[err]
            f.write(b"@c%d\n" % i + r.tobytes() + b"\n+\n" + qual + b"\n")


def run_ours(argv, out):
    from basal_jax.cli import main as cli_main
    old = sys.argv
    sys.argv = ["basal-jax"] + argv + ["-o", str(out)]
    t0 = time.time()
    try:
        cli_main()
    except SystemExit:
        pass
    sys.argv = old
    return time.time() - t0


def run_orc(argv, out):
    t0 = time.time()
    subprocess.run([str(oracle)] + argv + ["-p", "1", "-o", str(out)],
                   check=True, capture_output=True)
    return time.time() - t0


def _norm(l):
    # BAM stores the mate ref as an id; our decoder renders it "=" when it
    # equals RNAME (samtools convention) while the reference's SAM emitter
    # writes the explicit name — same record, normalize for comparison
    c = l.split("\t")
    if len(c) > 6 and c[6] == "=":
        c[6] = c[2]
    return "\t".join(c)


def body(p):
    if str(p).endswith(".bam"):
        from basal_jax.toolkit.bamio import decode_bam_to_sam
        text = decode_bam_to_sam(str(p))
        return [_norm(l) for l in text.splitlines()
                if l and not l.startswith("@")]
    with open(p) as f:
        return [_norm(l.rstrip("\n")) for l in f if not l.startswith("@")]


CONFIGS = [
    ("1 SE C:T",   "C:T",   ["-M", "C:T", "-g", "0", "-s", "16"], ".sam"),
    ("2 SE A:G",   "A:G",   ["-M", "A:G", "-v", "5"], ".sam"),
    ("3 SE A:CGT", "A:CGT", ["-M", "A:CGT", "-w", "20", "-r", "1"], ".sam"),
    ("4 SE T:-",   "T:-",   ["-M", "T:-", "-g", "3"], ".sam"),
    ("5 PE BAM",   "C:T",   ["-M", "C:T"], ".bam"),
]

print(f"[configbench] {N} reads, {G} bp random genome", file=sys.stderr)
results = []
for name, rule, flags, ext in CONFIGS:
    tag = name.split()[0]
    pe = name.startswith("5")
    if pe:
        fq1 = work / f"c{tag}_{N}_1.fq"
        fq2 = work / f"c{tag}_{N}_2.fq"
        write_fq(fq1, rule, N // 2, mate=1)
        write_fq(fq2, rule, N // 2, mate=2)
        args = ["-d", str(ref_fa), "-a", str(fq1), "-b", str(fq2),
                "-S", "1", "-V", "0"] + flags
        n_units = N // 2
    else:
        fq = work / f"c{tag}_{N}.fq"
        write_fq(fq, rule, N)
        args = ["-d", str(ref_fa), "-a", str(fq), "-S", "1", "-V", "0"] \
            + flags
        n_units = N
    ours_out = work / f"ours_{tag}{ext}"
    # the oracle's -o *.bam popens samtools, which this machine does not
    # have (it dies with SIGPIPE; the reference would fall back only after
    # writing the pipe) — let it emit SAM and compare decoded bodies
    orc_out = work / f"orc_{tag}.sam"
    ratios = []
    t_our = t_orc = None
    for rep in range(4):
        t_our = run_ours(args, ours_out)
        t_orc = run_orc(args, orc_out)
        if rep:                      # rep 0 is warmup (jit/page cache)
            ratios.append(t_orc / t_our)
    ob, wb = body(ours_out), body(orc_out)
    eq = sum(1 for a, b in zip(ob, wb) if a == b)
    tot = max(len(ob), len(wb), 1)
    med = sorted(ratios)[len(ratios) // 2]
    unit = "pairs" if pe else "reads"
    print(f"[configbench] {name}: ours {t_our:.2f}s oracle {t_orc:.2f}s "
          f"({n_units/t_our:.0f} {unit}/s) ratio x{med:.2f} "
          f"equality {eq}/{tot}", file=sys.stderr)
    results.append((name, med, eq, tot))

print("[configbench] summary: "
      + "; ".join(f"{n}: x{m:.2f} ({e}/{t})" for n, m, e, t in results),
      file=sys.stderr)
