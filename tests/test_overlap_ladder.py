"""Regression test for the overlapped-pipeline ladder: batch k+1's group
build runs BEFORE batch k's wave materialization (submit/finish overlap in
run_single_end), so per-batch buffers (seed values, N counts) must live on
the batch's encoding, not on the shared NativeBatch.  A stale cache here
produced wrong candidates or out-of-bounds reads (segfault) on repeat-heavy
references; see enc._sv_cache in native/__init__.py."""

import io
import random

import pytest

from conftest import have_oracle, make_fastq, make_ref, norm_sam, run_oracle

pytestmark = pytest.mark.skipif(not have_oracle(), reason="oracle not built")


def repeat_genome(rng, n=40, unit=200):
    """Tandem-ish repeats: diverged copies of a few units (forces the lazy
    strata-ladder path: thousands of candidates per read)."""
    units = ["".join(rng.choice("ACGT") for _ in range(unit))
             for _ in range(3)]
    parts = []
    for _ in range(n):
        u = list(rng.choice(units))
        for j in range(len(u)):
            if rng.random() < 0.03:
                u[j] = rng.choice("ACGT")
        parts.append("".join(u))
    return "".join(parts)


def test_overlapped_ladder_waves(tmp_path):
    rng = random.Random(4242)
    g = repeat_genome(rng)
    make_ref(tmp_path / "ref.fa", [("chrT", g)])
    reads = []
    for k in range(300):
        pos = rng.randrange(0, len(g) - 80)
        s = list(g[pos:pos + 80])
        for j, c in enumerate(s):
            if c == "A" and rng.random() < 0.5:
                s[j] = "G"
        reads.append((f"t{k}", "".join(s)))
    make_fastq(tmp_path / "reads.fq", reads)

    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "A:G", "-V", "0",
            "-S", "9", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr

    # force the lazy ladder on every batch and use small batches so the
    # two-deep submit/finish overlap in run_single_end interleaves several
    # batches' builds and waves
    import os
    from basal_jax import cli
    from basal_jax.align.pipeline import SingleEndAligner
    from basal_jax.config import AlignParams

    old_eager = SingleEndAligner.EAGER_MAX_CANDS
    SingleEndAligner.EAGER_MAX_CANDS = 1
    try:
        from basal_jax.align.pipeline import run_single_end
        p = AlignParams(conversion="A:G", randseed=9, out_unmap=True,
                        verbose_level=0, batch_reads=64)
        out = io.BytesIO()
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            run_single_end(p, "ref.fa", "reads.fq", out_fh=out)
        finally:
            os.chdir(cwd)
        got = norm_sam(out.getvalue().decode('latin1'))
    finally:
        SingleEndAligner.EAGER_MAX_CANDS = old_eager
    want = norm_sam((tmp_path / "oracle.sam").read_text())
    assert got == want


def test_pe_threaded_equals_serial(tmp_path):
    """PairThreadedRunner (-p) produces the same output as the serial PE
    loop (each worker owns private scheduler state, batch-ordered writes)."""
    from test_differential_pe import pe_reads
    from conftest import random_genome
    rng = random.Random(777)
    g = random_genome(rng, 20000)
    make_ref(tmp_path / "ref.fa", [("chrP", g)])
    r1, r2 = pe_reads(rng, g, 400, 80, rule="C:T", min_ins=150, max_ins=400)
    make_fastq(tmp_path / "r1.fq", r1)
    make_fastq(tmp_path / "r2.fq", r2)

    import os
    from basal_jax.config import AlignParams
    from basal_jax.pairs.pipeline import run_pair_end

    outs = []
    cwd = os.getcwd()
    for nthreads in (1, 3):
        p = AlignParams(conversion="C:T", randseed=5, pairend=True,
                        out_unmap=True, verbose_level=0, batch_reads=64,
                        num_threads=nthreads)
        out = io.BytesIO()
        os.chdir(tmp_path)
        try:
            run_pair_end(p, "ref.fa", "r1.fq", "r2.fq", out_fh=out)
        finally:
            os.chdir(cwd)
        outs.append(norm_sam(out.getvalue().decode('latin1')))
    assert outs[0] == outs[1]
