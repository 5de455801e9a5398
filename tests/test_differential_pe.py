"""Differential tests: paired-end alignment vs the reference binary
(PairAlign, pairs.cpp; config 5 of BASELINE.md)."""

import pytest

from conftest import (have_oracle, make_fastq, make_ref, norm_sam,
                      random_genome, run_oracle)
from test_differential_se import run_ours

pytestmark = pytest.mark.skipif(not have_oracle(), reason="oracle not built")

COMP = str.maketrans("ACGT", "TGCA")


def rc(s):
    return s.translate(COMP)[::-1]


def pe_reads(rng, ref, n, readlen, rule="C:T", rate=0.5, sub_rate=0.01,
             min_ins=150, max_ins=400, orphan_frac=0.1):
    """Simulate a bisulfite-style fragment: both mates from the converted top
    strand; read1 = 5' end, read2 = revcomp of 3' end."""
    frm, tos = rule.split(":")
    r1s, r2s = [], []
    for i in range(n):
        ins = rng.randrange(min_ins, max_ins)
        pos = rng.randrange(0, len(ref) - ins)
        frag = list(ref[pos:pos + ins])
        for j, c in enumerate(frag):
            if c == frm and rng.random() < rate:
                frag[j] = rng.choice(tos)
            elif sub_rate and rng.random() < sub_rate:
                frag[j] = rng.choice("ACGT".replace(c, ""))
        frag = "".join(frag)
        r1 = frag[:readlen]
        r2 = rc(frag[-readlen:])
        if rng.random() < orphan_frac:
            # orphan: mate 2 is random noise -> unpaired path exercised
            r2 = random_genome(rng, readlen)
        r1s.append((f"p{i}_pos{pos}_ins{ins}/1", r1))
        r2s.append((f"p{i}_pos{pos}_ins{ins}/2", r2))
    return r1s, r2s


def diff_pe(tmp_path, rng, rule, flags, genome_len=9000, n=40, readlen=90,
            **kw):
    g = random_genome(rng, genome_len)
    make_ref(tmp_path / "ref.fa", [("chrP", g)])
    r1, r2 = pe_reads(rng, g, n, readlen, rule=rule, **kw)
    make_fastq(tmp_path / "r1.fq", r1)
    make_fastq(tmp_path / "r2.fq", r2)
    base = ["-a", "r1.fq", "-b", "r2.fq", "-d", "ref.fa", "-M", rule, "-V", "0"]
    r = run_oracle(base + ["-o", "oracle.sam"] + flags, tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base + flags, tmp_path)
    want = norm_sam((tmp_path / "oracle.sam").read_text())
    got = norm_sam(ours)
    assert got == want, _fd(got, want)


def _fd(got, want):
    import difflib
    return "\n".join(list(difflib.unified_diff(want, got, "oracle", "ours",
                                               lineterm=""))[:50])


def test_pe_ct_basic(tmp_path, rng):
    diff_pe(tmp_path, rng, "C:T", ["-S", "1", "-u"])


def test_pe_ag(tmp_path, rng):
    diff_pe(tmp_path, rng, "A:G", ["-S", "5", "-v", "0.08", "-u"])


def test_pe_insert_window(tmp_path, rng):
    """Tight -m/-x window rejects some true pairs -> unpaired fallback."""
    diff_pe(tmp_path, rng, "C:T", ["-S", "3", "-m", "200", "-x", "300", "-u"],
            min_ins=150, max_ins=400)


def test_pe_nondirectional(tmp_path, rng):
    diff_pe(tmp_path, rng, "C:T", ["-S", "9", "-n", "1", "-u"])


def test_pe_multiway(tmp_path, rng):
    diff_pe(tmp_path, rng, "A:CGT", ["-S", "2", "-n", "1", "-u"], rate=0.35)


def test_pe_repeat_all(tmp_path, rng):
    core = random_genome(rng, 2000)
    g = core + core + random_genome(rng, 3000)
    make_ref(tmp_path / "ref.fa", [("chrR", g)])
    r1, r2 = pe_reads(rng, core, 25, 80, rule="C:T", orphan_frac=0.0)
    make_fastq(tmp_path / "r1.fq", r1)
    make_fastq(tmp_path / "r2.fq", r2)
    base = ["-a", "r1.fq", "-b", "r2.fq", "-d", "ref.fa", "-M", "C:T",
            "-V", "0", "-S", "4", "-r", "2", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base, tmp_path)
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())


def test_pe_gapped(tmp_path, rng):
    diff_pe(tmp_path, rng, "C:T", ["-S", "6", "-g", "2", "-u"], n=25)


def test_pe_gapped_host_eval(tmp_path, rng, monkeypatch):
    """PE gapped host lane: forced host evaluation must match the oracle
    (the PE device branch now routes waves through
    host_eval_candidates_gap when placement picks the host)."""
    monkeypatch.setenv("BASAL_HOST_EVAL", "1")
    diff_pe(tmp_path, rng, "C:T", ["-S", "6", "-g", "2", "-u"], n=25)
