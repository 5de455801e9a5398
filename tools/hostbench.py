"""Host-path iteration benchmark (jax on the CPU): our pipeline with
BASAL_HOST_EVAL=1 on jax-cpu vs the oracle binary, same data as bench.py.

Usage: python tools/hostbench.py [random|repeat] [n_reads]
Prints per-pass reads/s for ours and the oracle, plus the SAM-equality rate.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROFILE = sys.argv[1] if len(sys.argv) > 1 else "random"
os.environ["BENCH_PROFILE"] = PROFILE
os.environ.setdefault("BASAL_HOST_EVAL", "1")
if len(sys.argv) > 2:
    os.environ["BENCH_READS"] = sys.argv[2]

import jax
jax.config.update("jax_platforms", "cpu")

import bench  # noqa: E402  (reuses make_data/ensure_oracle)

work = ROOT / ".oracle" / "benchdata"
work.mkdir(parents=True, exist_ok=True)
ref_fa, reads_fq = bench.make_data(work)
N = bench.N_READS
oracle = bench.ensure_oracle()

from basal_jax.config import AlignParams
from basal_jax.index.reference import load_reference
from basal_jax.index.seedindex import build_index
from basal_jax.reads.io import open_reads
from basal_jax.align.pipeline import SingleEndAligner

p = AlignParams(conversion="A:G", randseed=1, verbose_level=0)
t0 = time.time()
ref = load_reference(str(ref_fa), p)
idx = build_index(ref, p)
print(f"[hostbench] index: {time.time()-t0:.1f}s", file=sys.stderr)

BATCH = int(os.environ.get("HB_BATCH", "25000"))
for rep in range(3):
    al = SingleEndAligner(p, ref, idx)
    rd = open_reads(str(reads_fq), p)
    parts = []
    t0 = time.time()
    n = 0
    while True:
        b = rd.next_batch(BATCH)
        if not b:
            break
        n += len(b)
        parts.append(al.align_batch(b))
    dt = time.time() - t0
    print(f"[hostbench] ours pass {rep}: {n} reads {dt:.2f}s = "
          f"{n/dt:.0f} reads/s", file=sys.stderr)
    rd.close()

    t0 = time.time()
    subprocess.run([str(oracle), "-d", str(ref_fa), "-M", "A:G", "-S", "1",
                    "-V", "0", "-p", "1", "-a", str(reads_fq),
                    "-o", str(work / "oracle.sam")],
                   check=True, capture_output=True)
    dto = time.time() - t0
    print(f"[hostbench] oracle pass {rep} (incl. index): {dto:.2f}s = "
          f"{N/dto:.0f} reads/s", file=sys.stderr)

# SAM equality on the last pass
from basal_jax.align.sam import sam_header
ours = (sam_header(ref, p, "hostbench").encode("latin1")
        + b"".join(parts)).decode("latin1")
ours_recs = [l for l in ours.splitlines() if l and not l.startswith("@")]
want = [l for l in (work / "oracle.sam").read_text().splitlines()
        if l and not l.startswith("@")]
eq = sum(1 for a, b in zip(ours_recs, want) if a == b)
print(f"[hostbench] SAM equality: {eq}/{max(len(want), len(ours_recs))}",
      file=sys.stderr)
