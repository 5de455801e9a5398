"""Differential tests for gapped extension (-g): BID-seq T:- deletion reads
and generic insertion/deletion reads (GapAlign, align.cpp:348-410)."""

import pytest

from conftest import (convert_reads, have_oracle, make_fastq, make_ref,
                      norm_sam, random_genome, run_oracle)
from test_differential_se import run_ours

pytestmark = pytest.mark.skipif(not have_oracle(), reason="oracle not built")


def deletion_reads(rng, ref, n, readlen, frm="T", max_del=3, del_rate=0.9):
    """Reads spanning a deletion of a convert-from base run (BID-seq style:
    pseudouridine -> deletion)."""
    reads = []
    for i in range(n):
        while True:
            pos = rng.randrange(0, len(ref) - readlen - 4)
            window = ref[pos:pos + readlen + 4]
            # find a convert-from base away from the edges
            cands = [j for j in range(10, readlen - 10) if window[j] == frm]
            if cands:
                break
        if rng.random() < del_rate:
            j = rng.choice(cands)
            d = rng.randrange(1, max_del + 1)
            s = window[:j] + window[j + d:]
            reads.append((f"r{i}_p{pos}_d{d}at{j}", s[:readlen]))
        else:
            reads.append((f"r{i}_p{pos}", window[:readlen]))
    return reads


def insertion_reads(rng, ref, n, readlen, max_ins=3):
    reads = []
    for i in range(n):
        pos = rng.randrange(0, len(ref) - readlen)
        j = rng.randrange(15, readlen - 15)
        d = rng.randrange(1, max_ins + 1)
        ins = "".join(rng.choice("ACGT") for _ in range(d))
        s = ref[pos:pos + readlen]
        s = (s[:j] + ins + s[j:])[:readlen]
        reads.append((f"r{i}_p{pos}_i{d}at{j}", s))
    return reads


def diff_gap(tmp_path, rng, reads, rule, flags, genome):
    make_ref(tmp_path / "ref.fa", [("chrG", genome)])
    make_fastq(tmp_path / "reads.fq", reads)
    r = run_oracle(["-a", "reads.fq", "-d", "ref.fa", "-M", rule, "-V", "0",
                    "-o", "oracle.sam"] + flags, tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(["-a", "reads.fq", "-d", "ref.fa", "-M", rule, "-V", "0"]
                    + flags, tmp_path)
    want = norm_sam((tmp_path / "oracle.sam").read_text())
    got = norm_sam(ours)
    assert got == want, _fd(got, want)


def _fd(got, want):
    import difflib
    return "\n".join(list(difflib.unified_diff(want, got, "oracle", "ours",
                                               lineterm=""))[:40])


def test_bidseq_deletions(tmp_path, rng):
    """Config 4: -M T:- -n 1 -g 3 -R -u (BID-seq pipeline flags)."""
    g = random_genome(rng, 9000)
    reads = deletion_reads(rng, g, 50, 100)
    diff_gap(tmp_path, rng, reads, "T:-",
             ["-S", "1", "-n", "1", "-g", "3", "-R", "-u"], g)


def test_ct_gapped_insertions(tmp_path, rng):
    g = random_genome(rng, 9000)
    reads = insertion_reads(rng, g, 40, 100)
    diff_gap(tmp_path, rng, reads, "C:T", ["-S", "8", "-g", "3", "-u"], g)


def test_ct_gap1(tmp_path, rng):
    g = random_genome(rng, 6000)
    reads = deletion_reads(rng, g, 30, 80, frm="C", max_del=1)
    diff_gap(tmp_path, rng, reads, "C:T", ["-S", "13", "-g", "1", "-u"], g)


def test_gap_with_conversions(tmp_path, rng):
    """Deletions + C->T conversions simultaneously."""
    g = random_genome(rng, 8000)
    dreads = deletion_reads(rng, g, 25, 100, frm="T", max_del=2)
    conv = convert_reads(rng, g, 25, 100, "C:T", rate=0.5, sub_rate=0.02)
    diff_gap(tmp_path, rng, dreads + conv, "C:T",
             ["-S", "21", "-g", "2", "-u", "-v", "0.1"], g)


def test_bidseq_host_eval_repeats(tmp_path, rng, monkeypatch):
    """Gapped host fast lane (bt_eval_candidates_gap): with evaluation
    forced onto the host, a repeat-heavy BID-seq run (-M T:- -g 3, the
    candidate-volume worst case) must stay byte-identical to the oracle —
    counts AND the pos0/pos1 mismatch-position lists the gapped replay
    consumes come from the C++ evaluator instead of the device kernel."""
    monkeypatch.setenv("BASAL_HOST_EVAL", "1")
    g = (random_genome(rng, 6000) + random_genome(rng, 271) * 10
         + random_genome(rng, 3000))
    reads = deletion_reads(rng, g, 60, 100)
    diff_gap(tmp_path, rng, reads, "T:-",
             ["-S", "2", "-n", "1", "-g", "3", "-R", "-u"], g)


def test_gap_host_eval_insertions(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("BASAL_HOST_EVAL", "1")
    g = random_genome(rng, 9000)
    reads = insertion_reads(rng, g, 40, 100)
    diff_gap(tmp_path, rng, reads, "C:T", ["-S", "17", "-g", "3", "-u"], g)
