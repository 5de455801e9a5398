"""Differential tests: single-end alignment vs the reference binary.

Oracle = the compiled reference BASAL (built out-of-tree into .oracle/);
with -S fixed and -p 1 its SAM output is deterministic (utilities.cpp:38-48),
so we byte-compare records (minus @PG, whose CL differs).
"""

import io
import subprocess
import sys

import pytest

from conftest import (ORACLE, convert_reads, have_oracle, make_fastq,
                      make_ref, norm_sam, random_genome, run_oracle)

pytestmark = pytest.mark.skipif(not have_oracle(), reason="oracle not built")


def run_ours(argv, cwd):
    from basal_jax import cli
    import os
    old = os.getcwd()
    os.chdir(cwd)
    buf = io.BytesIO()

    class _FakeStdout:
        buffer = buf

        @staticmethod
        def flush():
            pass

    stdout = sys.stdout
    sys.stdout = _FakeStdout()
    try:
        cli.main(argv)
    finally:
        sys.stdout = stdout
        os.chdir(old)
    return buf.getvalue().decode("latin1")


def diff_case(tmp_path, rng, rule, oracle_flags, genome_len=8000, n_reads=60,
              readlen=100, rate=0.5, sub_rate=0.01, revcomp_frac=0.3,
              n_chrs=2):
    seqs = [(f"chr{i+1}", random_genome(rng, genome_len)) for i in range(n_chrs)]
    make_ref(tmp_path / "ref.fa", seqs)
    ref_cat = "".join(s for _, s in seqs)
    reads = convert_reads(rng, ref_cat, n_reads, readlen, rule, rate=rate,
                          sub_rate=sub_rate, revcomp_frac=revcomp_frac)
    make_fastq(tmp_path / "reads.fq", reads)
    args = ["-a", "reads.fq", "-d", "ref.fa", "-M", rule, "-V", "0",
            "-o", "oracle.sam"] + oracle_flags
    r = run_oracle(args, tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(["-a", "reads.fq", "-d", "ref.fa", "-M", rule, "-V", "0"]
                    + oracle_flags, tmp_path)
    want = norm_sam((tmp_path / "oracle.sam").read_text())
    got = norm_sam(ours)
    assert got == want, _first_diff(got, want)


def _first_diff(got, want):
    import difflib
    diff = list(difflib.unified_diff(want, got, "oracle", "ours", lineterm=""))
    return "\n".join(diff[:40]) + f"\n... ({len(want)} oracle vs {len(got)} ours lines)"


def test_ct_basic(tmp_path, rng):
    """Config 1: SE -M C:T ungapped."""
    diff_case(tmp_path, rng, "C:T", ["-S", "1"])


def test_ag_glori(tmp_path, rng):
    """Config 2: SE -M A:G with -v and -u (GLORI/eTAM)."""
    diff_case(tmp_path, rng, "A:G", ["-S", "7", "-v", "0.08", "-u"])


def test_multiway_acgt(tmp_path, rng):
    """Config 3: SE -M A:CGT multi-way, non-directional, multi-hit."""
    diff_case(tmp_path, rng, "A:CGT", ["-S", "3", "-n", "1", "-w", "50", "-u"],
              rate=0.35)


def test_repeat_all(tmp_path, rng):
    """-r 2: report all equal-best hits (repetitive reference)."""
    core = random_genome(rng, 1500)
    seqs = [("chrR", core + core + random_genome(rng, 2000))]
    make_ref(tmp_path / "ref.fa", seqs)
    reads = convert_reads(rng, core, 40, 80, "C:T", rate=0.5, sub_rate=0.0)
    make_fastq(tmp_path / "reads.fq", reads)
    flags = ["-S", "11", "-r", "2", "-u"]
    r = run_oracle(["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0",
                    "-o", "oracle.sam"] + flags, tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0"]
                    + flags, tmp_path)
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())


def test_unique_only(tmp_path, rng):
    """-r 0: suppress repeats."""
    diff_case(tmp_path, rng, "C:T", ["-S", "5", "-r", "0", "-u"])


def test_nt3_mode(tmp_path, rng):
    """-3 three-letter mode."""
    diff_case(tmp_path, rng, "C:T", ["-S", "9", "-3"])


def test_with_ns_in_ref_and_reads(tmp_path, rng):
    """N handling: masked reference regions + N bases in reads."""
    g = random_genome(rng, 4000)
    g = g[:1000] + "N" * 200 + g[1200:3000] + "NNNN" + g[3004:]
    make_ref(tmp_path / "ref.fa", [("chrN", g)])
    reads = convert_reads(rng, g.replace("N", "A"), 40, 90, "C:T")
    # sprinkle Ns into reads
    reads = [(n, s[:10] + "N" + s[11:]) if i % 5 == 0 else (n, s)
             for i, (n, s) in enumerate(reads)]
    make_fastq(tmp_path / "reads.fq", reads)
    flags = ["-S", "2", "-u"]
    r = run_oracle(["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0",
                    "-o", "oracle.sam"] + flags, tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0"]
                    + flags, tmp_path)
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())


def test_xr_context(tmp_path, rng):
    """-R reference-context output."""
    diff_case(tmp_path, rng, "A:G", ["-S", "4", "-R"])


def test_seed12_interval2(tmp_path, rng):
    """Non-default -s/-I."""
    diff_case(tmp_path, rng, "C:T", ["-S", "6", "-s", "12", "-I", "2"],
              genome_len=4000, n_reads=40)


def test_python_replay_path(tmp_path, rng):
    """BASAL_NO_NATIVE=1 forces the pure-Python scheduler/replay twins;
    output must still match the oracle byte-for-byte."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    diffdir = tmp_path
    seqs = [("chrP", random_genome(rng, 6000))]
    make_ref(diffdir / "ref.fa", seqs)
    reads = convert_reads(rng, seqs[0][1], 40, 80, "A:G", rate=0.5,
                          sub_rate=0.01, revcomp_frac=0.3)
    make_fastq(diffdir / "reads.fq", reads)
    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "A:G", "-V", "0",
            "-S", "17", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], diffdir)
    assert r.returncode == 0, r.stderr
    env = {**os.environ, "BASAL_NO_NATIVE": "1", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(Path(__file__).resolve().parents[1])}
    rr = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from basal_jax import cli; cli.main("
         + repr(base + ["-o", "ours.sam"]) + ")"],
        cwd=diffdir, env=env, capture_output=True, text=True, timeout=300)
    assert rr.returncode == 0, rr.stderr[-2000:]
    assert (norm_sam((diffdir / "ours.sam").read_text())
            == norm_sam((diffdir / "oracle.sam").read_text()))


def test_host_eval_path(tmp_path, rng):
    """BASAL_HOST_EVAL=1 (C++ SIMD candidate evaluation) must match the
    oracle exactly, same as the device path."""
    import os
    seqs = [("chrH", random_genome(rng, 6000))]
    make_ref(tmp_path / "ref.fa", seqs)
    reads = convert_reads(rng, seqs[0][1], 50, 90, "A:CGT", rate=0.4,
                          sub_rate=0.01, revcomp_frac=0.3)
    make_fastq(tmp_path / "reads.fq", reads)
    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "A:CGT", "-n", "1",
            "-V", "0", "-S", "23", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    os.environ["BASAL_HOST_EVAL"] = "1"
    try:
        ours = run_ours(base, tmp_path)
    finally:
        del os.environ["BASAL_HOST_EVAL"]
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())


def test_device_eval_path(tmp_path, rng):
    """BASAL_HOST_EVAL=0 forces every wave through the device (XLA)
    extend kernel — the accelerator differential path, exercised explicitly
    now that auto mode routes to the host evaluator on a CPU backend."""
    import os
    seqs = [("chrD", random_genome(rng, 6000))]
    make_ref(tmp_path / "ref.fa", seqs)
    reads = convert_reads(rng, seqs[0][1], 60, 90, "A:G", rate=0.5,
                          sub_rate=0.01, revcomp_frac=0.3)
    make_fastq(tmp_path / "reads.fq", reads)
    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "A:G",
            "-V", "0", "-S", "29", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    os.environ["BASAL_HOST_EVAL"] = "0"
    try:
        ours = run_ours(base, tmp_path)
    finally:
        del os.environ["BASAL_HOST_EVAL"]
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())
