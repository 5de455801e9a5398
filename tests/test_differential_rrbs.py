"""Differential tests for the hidden RRBS/digestion mode (-D), e.g. MspI
C-CGG: fragment-anchored index, mode-filtered scan, ZP/ZL tags."""

import random

import pytest

from conftest import have_oracle, make_fastq, make_ref, norm_sam, run_oracle
from test_differential_se import run_ours

pytestmark = pytest.mark.skipif(not have_oracle(), reason="oracle not built")


def rrbs_genome(rng, n_frags=60, frag_lo=60, frag_hi=320):
    """Genome = CCGG-separated fragments (MspI digests C^CGG)."""
    parts = []
    for _ in range(n_frags):
        flen = rng.randrange(frag_lo, frag_hi)
        parts.append("".join(rng.choice("ACGT") for _ in range(flen))
                     .replace("CCGG", "ACGG"))
        parts.append("CCGG")
    return "".join(parts)


def rrbs_reads(rng, genome, n, readlen=60, rule="C:T", rate=0.6):
    """RRBS reads start at MspI cut sites (C^CGG -> fragment starts at the
    first C +1)."""
    frm, tos = rule.split(":")
    sites = []
    i = genome.find("CCGG")
    while i >= 0:
        sites.append(i + 1)  # cut between C and CGG
        i = genome.find("CCGG", i + 1)
    reads = []
    for k in range(n):
        pos = rng.choice(sites)
        if pos + readlen > len(genome):
            continue
        s = list(genome[pos:pos + readlen])
        for j, c in enumerate(s):
            if c == frm and rng.random() < rate:
                s[j] = rng.choice(tos)
        reads.append((f"rr{k}_p{pos}", "".join(s)))
    return reads


def test_rrbs_ct(tmp_path, rng):
    g = rrbs_genome(rng)
    make_ref(tmp_path / "ref.fa", [("chrR", g)])
    reads = rrbs_reads(rng, g, 50)
    make_fastq(tmp_path / "reads.fq", reads)
    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0",
            "-S", "1", "-D", "C-CGG", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base, tmp_path)
    want = norm_sam((tmp_path / "oracle.sam").read_text())
    got = norm_sam(ours)
    assert got == want, _fd(got, want)


def test_rrbs_nondirectional(tmp_path, rng):
    g = rrbs_genome(rng, n_frags=40)
    make_ref(tmp_path / "ref.fa", [("chrR", g)])
    comp = str.maketrans("ACGT", "TGCA")
    reads = rrbs_reads(rng, g, 40)
    # add reverse-complement reads (non-directional protocol)
    reads += [(n + "_rc", s.translate(comp)[::-1]) for n, s in
              rrbs_reads(rng, g, 15)]
    make_fastq(tmp_path / "reads.fq", reads)
    base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0",
            "-S", "5", "-D", "C-CGG", "-n", "1", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base, tmp_path)
    assert norm_sam(ours) == norm_sam((tmp_path / "oracle.sam").read_text())


def _fd(got, want):
    import difflib
    return "\n".join(list(difflib.unified_diff(want, got, "oracle", "ours",
                                               lineterm=""))[:40])


def test_rrbs_pe(tmp_path, rng):
    """RRBS paired-end: fragment index with the pairend extra entries,
    ZP/ZL pair tags."""
    g = rrbs_genome(rng, n_frags=50, frag_lo=120, frag_hi=300)
    make_ref(tmp_path / "ref.fa", [("chrR", g)])
    comp = str.maketrans("ACGT", "TGCA")
    # fragments between consecutive CCGG cut sites; R1 from 5' cut, R2 = rc
    sites = []
    i = g.find("CCGG")
    while i >= 0:
        sites.append(i + 1)
        i = g.find("CCGG", i + 1)
    r1s, r2s = [], []
    k = 0
    for a, b in zip(sites, sites[1:]):
        frag = g[a:b + 1]
        if len(frag) < 80:
            continue
        conv = "".join("T" if (c == "C" and rng.random() < 0.6) else c
                       for c in frag)
        L = min(60, len(conv))
        r1s.append((f"p{k}/1", conv[:L]))
        r2s.append((f"p{k}/2", conv[-L:].translate(comp)[::-1]))
        k += 1
        if k >= 35:
            break
    make_fastq(tmp_path / "r1.fq", r1s)
    make_fastq(tmp_path / "r2.fq", r2s)
    base = ["-a", "r1.fq", "-b", "r2.fq", "-d", "ref.fa", "-M", "C:T",
            "-V", "0", "-S", "3", "-D", "C-CGG", "-u", "-m", "28",
            "-x", "600"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    ours = run_ours(base, tmp_path)
    want = norm_sam((tmp_path / "oracle.sam").read_text())
    got = norm_sam(ours)
    assert got == want, _fd(got, want)


def test_rrbs_pe_python_twin(tmp_path, rng, monkeypatch):
    """PE RRBS with BASAL_NO_NATIVE=1: the pure-Python fragment build +
    lockstep remains the golden twin now that the native path
    (bt_build_candidates_rrbs + bt_replay_pe rr args + ZP/ZL PE formatter)
    is the default."""
    monkeypatch.setenv("BASAL_NO_NATIVE", "1")
    test_rrbs_pe(tmp_path, rng)
