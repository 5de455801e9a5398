"""Differential tests for trimming/windowing/input options:
-A adapter trim, -q/-z quality trim, -L hard clip, -B/-E read range,
-f N-filter, -N count-N-as-mismatch, gzip input, multi-chromosome refs."""

import gzip
import random

import pytest

from conftest import (convert_reads, have_oracle, make_fastq, make_ref,
                      norm_sam, random_genome, run_oracle)
from test_differential_se import run_ours

pytestmark = pytest.mark.skipif(not have_oracle(), reason="oracle not built")


def check(tmp_path, flags, reads, seqs, rule="C:T"):
    make_ref(tmp_path / "ref.fa", seqs)
    make_fastq(tmp_path / "reads.fq", reads)
    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", rule, "-V", "0"]
    r = run_oracle(base + ["-o", "oracle.sam"] + flags, tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base + flags, tmp_path)
    want = norm_sam((tmp_path / "oracle.sam").read_text())
    got = norm_sam(ours)
    assert got == want, _fd(got, want)


def _fd(got, want):
    import difflib
    return "\n".join(list(difflib.unified_diff(want, got, "oracle", "ours",
                                               lineterm=""))[:40])


def test_adapter_trim(tmp_path, rng):
    g = random_genome(rng, 6000)
    adapter = "AGATCGGAAGAGC"
    reads = []
    for i, (n, s) in enumerate(convert_reads(rng, g, 40, 70, "C:T")):
        if i % 2 == 0:
            s = s + adapter[:rng.randrange(5, 13)]
        reads.append((n, s))
    check(tmp_path, ["-S", "1", "-A", adapter, "-u"], reads, [("c1", g)])


def test_qual_trim(tmp_path, rng):
    g = random_genome(rng, 6000)
    reads = convert_reads(rng, g, 40, 90, "C:T")
    qreads = []
    with open(tmp_path / "reads.fq", "w") as f:
        for i, (n, s) in enumerate(reads):
            qual = "I" * len(s)
            if i % 3 == 0:  # low-quality 3' tail
                k = rng.randrange(5, 30)
                qual = "I" * (len(s) - k) + "#" * k
            f.write(f"@{n}\n{s}\n+\n{qual}\n")
            qreads.append((n, s))
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    flags = ["-S", "2", "-q", "20", "-u"]
    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0"]
    r = run_oracle(base + ["-o", "oracle.sam"] + flags, tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base + flags, tmp_path)
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())


def test_illumina_qual_base(tmp_path, rng):
    """-z 64 Illumina quality rescaling (align.cpp:58-65)."""
    g = random_genome(rng, 5000)
    reads = convert_reads(rng, g, 30, 80, "C:T")
    with open(tmp_path / "reads.fq", "w") as f:
        for n, s in reads:
            f.write(f"@{n}\n{s}\n+\n{'h' * len(s)}\n")  # Illumina-64 'h'=Q40
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    flags = ["-S", "3", "-z", "64", "-q", "10", "-u"]
    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0"]
    r = run_oracle(base + ["-o", "oracle.sam"] + flags, tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base + flags, tmp_path)
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())


def test_hard_clip(tmp_path, rng):
    g = random_genome(rng, 6000)
    reads = convert_reads(rng, g, 40, 120, "C:T")
    check(tmp_path, ["-S", "4", "-L", "75", "-u"], reads, [("c1", g)])


def test_read_range(tmp_path, rng):
    g = random_genome(rng, 6000)
    reads = convert_reads(rng, g, 60, 80, "C:T")
    check(tmp_path, ["-S", "5", "-B", "11", "-E", "45", "-u"], reads,
          [("c1", g)])


def test_n_filter_and_nmis(tmp_path, rng):
    g = random_genome(rng, 6000)
    reads = []
    for i, (n, s) in enumerate(convert_reads(rng, g, 50, 90, "C:T")):
        if i % 4 == 0:
            k = rng.randrange(1, 9)
            pos = rng.randrange(0, len(s) - k)
            s = s[:pos] + "N" * k + s[pos + k:]
        reads.append((n, s))
    check(tmp_path, ["-S", "6", "-f", "3", "-u"], reads, [("c1", g)])
    check(tmp_path, ["-S", "7", "-f", "6", "-N", "-u"], reads, [("c1", g)])


def test_gzip_inputs(tmp_path, rng):
    g = random_genome(rng, 6000)
    reads = convert_reads(rng, g, 40, 80, "C:T")
    make_ref(tmp_path / "ref_plain.fa", [("c1", g)])
    with open(tmp_path / "ref_plain.fa", "rb") as f:
        data = f.read()
    with gzip.open(tmp_path / "ref.fa.gz", "wb") as f:
        f.write(data)
    fq = "".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads)
    with gzip.open(tmp_path / "reads.fq.gz", "wb") as f:
        f.write(fq.encode())
    base = ["-a", "reads.fq.gz", "-d", "ref.fa.gz", "-M", "C:T", "-V", "0",
            "-S", "8", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base, tmp_path)
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())


def test_many_chromosomes(tmp_path, rng):
    seqs = [(f"scaffold_{i}", random_genome(rng, 900 + 37 * i))
            for i in range(12)]
    cat = "".join(s for _, s in seqs)
    reads = convert_reads(rng, cat, 60, 60, "C:T", revcomp_frac=0.5)
    check(tmp_path, ["-S", "9", "-u"], reads, seqs)


def test_fasta_read_input(tmp_path, rng):
    g = random_genome(rng, 5000)
    reads = convert_reads(rng, g, 30, 80, "C:T")
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    with open(tmp_path / "reads.fa", "w") as f:
        for n, s in reads:
            f.write(f">{n}\n{s}\n")
    base = ["-a", "reads.fa", "-d", "ref.fa", "-M", "C:T", "-V", "0",
            "-S", "10", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base, tmp_path)
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())


def test_short_reads_and_small_seed(tmp_path, rng):
    g = random_genome(rng, 5000)
    reads = convert_reads(rng, g, 40, 36, "C:T")
    check(tmp_path, ["-S", "11", "-s", "14", "-u"], reads, [("c1", g)])


def test_mixed_lengths(tmp_path, rng):
    g = random_genome(rng, 6000)
    reads = []
    for i in range(50):
        L = rng.choice([40, 60, 75, 90, 100])
        pos = rng.randrange(0, len(g) - L)
        s = "".join("T" if (c == "C" and rng.random() < 0.5) else c
                    for c in g[pos:pos + L])
        reads.append((f"m{i}", s))
    check(tmp_path, ["-S", "12", "-u"], reads, [("c1", g)])


def test_threaded_equals_serial(tmp_path, rng):
    """-p 3 output == -p 1 output (ordered batches; -S hashing makes per-read
    results schedule-independent), and both match the oracle."""
    g = random_genome(rng, 8000)
    reads = convert_reads(rng, g, 120, 80, "C:T")
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    make_fastq(tmp_path / "reads.fq", reads)
    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0",
            "-S", "13", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam", "-p", "1"], tmp_path)
    assert r.returncode == 0, r.stderr
    import basal_jax.config as cfg
    old_batch = cfg.BATCH_NUM
    try:
        serial = run_ours(base + ["-p", "1"], tmp_path)
        # force multiple small batches through the pool
        import basal_jax.reads.io  # noqa
        threaded = run_ours(base + ["-p", "3", "-E", "120"], tmp_path)
    finally:
        pass
    assert norm_sam(serial) == norm_sam((tmp_path / "oracle.sam").read_text())
    assert norm_sam(threaded) == norm_sam(serial)
