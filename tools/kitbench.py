"""Toolkit benchmark: our avgmod (numpy pileup, toolkit/avgmod.py) vs the
reference basalkit avgmod (procedural regex loops,
/root/reference/basalkit_functions.py:16-388) on a large aligned SAM.

Both consume the same SAM text input (the reference runs with the test
suite's pysam/statsmodels stubs — its SAM path needs neither), outputs must
be byte-identical, and we report wall times + the speedup.

Usage: python tools/kitbench.py [n_reads]
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

N = int(sys.argv[1]) if len(sys.argv) > 1 else 300_000

# own data dir: bench.py regenerates .oracle/benchdata per profile,
# which would silently mismatch a cached kitbench alignment
os.environ["BENCH_PROFILE"] = "random"
os.environ["BENCH_READS"] = str(max(N, 100_000))
import jax
jax.config.update("jax_platforms", "cpu")
import bench  # noqa: E402

work = ROOT / ".oracle" / "kitbench"
work.mkdir(parents=True, exist_ok=True)
ref_fa, reads_fq = bench.make_data(work)

import test_toolkit  # noqa: E402  (stub-dir + runner helpers)

aln = work / "kitbench_aln.sam"
if not aln.exists() or aln.stat().st_size < 1000:
    print(f"[kitbench] aligning {N} reads...", file=sys.stderr)
    from basal_jax.cli import main as cli_main
    argv0 = sys.argv
    sys.argv = ["basal-jax", "-a", str(reads_fq), "-d", str(ref_fa),
                "-M", "A:G", "-S", "1", "-V", "0", "-u", "-E", str(N),
                "-o", str(aln)]
    try:
        cli_main()
    except SystemExit:
        pass
    sys.argv = argv0

args = ["avgmod", str(aln), str(ref_fa), "-M", "A:G", "-T", "RNA", "-m", "1"]

t0 = time.time()
test_toolkit.run_our_kit(args + ["-o", str(work / "kit_ours")], str(work))
t_ours = time.time() - t0
print(f"[kitbench] ours: {t_ours:.2f}s", file=sys.stderr)

t0 = time.time()
r = test_toolkit.run_ref_kit(args + ["-o", str(work / "kit_ref")],
                             str(work), work)
t_ref = time.time() - t0
assert r.returncode == 0, r.stderr + r.stdout
print(f"[kitbench] reference basalkit: {t_ref:.2f}s", file=sys.stderr)

ours = (work / "kit_ours_AvgMod.tsv").read_text()
want = (work / "kit_ref_AvgMod.tsv").read_text()
eq = ours == want
print(f"[kitbench] outputs identical: {eq} "
      f"({ours.count(chr(10))} rows); speedup {t_ref/t_ours:.2f}x",
      file=sys.stderr)
assert eq
