"""Toolkit tests: avgmod differential vs reference basalkit (run with stub
modules for its unused pysam/statsmodels imports), plus shiftD/fdr/regmod/
mergeBAM behavior tests."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import (convert_reads, have_oracle, make_fastq, make_ref,
                      random_genome, run_oracle)

REF_KIT = Path("/root/reference/basalkit.py")


def _stub_dir(tmp_path):
    d = tmp_path / "stubs"
    d.mkdir(exist_ok=True)
    (d / "pysam.py").write_text(
        "class AlignedSegment:\n    pass\n"
        "class AlignmentFile:\n    pass\n"
        "def sort(*a, **k):\n    raise RuntimeError('stub')\n"
        "def index(*a, **k):\n    raise RuntimeError('stub')\n")
    sm = d / "statsmodels" / "stats"
    sm.mkdir(parents=True, exist_ok=True)
    (d / "statsmodels" / "__init__.py").write_text("")
    (sm / "__init__.py").write_text("")
    (sm / "multitest.py").write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(Path(__file__).resolve().parents[1])!r})\n"
        "from basal_jax.toolkit.multitest import multipletests as _mp\n"
        "def multipletests(pvals, alpha=0.05, method='fdr_bh', **k):\n"
        "    r, q = _mp(pvals, alpha, method)\n"
        "    return r, q\n")
    return d


def run_ref_kit(args, cwd, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{_stub_dir(tmp_path)}:/root/reference"
    return subprocess.run([sys.executable, str(REF_KIT)] + args, cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def run_our_kit(args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        from basal_jax.toolkit.cli import main
        main(args)
    finally:
        os.chdir(old)


def _make_aligned_sam(tmp_path, rng, rule="C:T", n=80, flags=("-S", "1", "-u")):
    g = random_genome(rng, 6000)
    make_ref(tmp_path / "ref.fa", [("chr1", g)])
    reads = convert_reads(rng, g, n, 80, rule, rate=0.6, sub_rate=0.01,
                          revcomp_frac=0.4)
    make_fastq(tmp_path / "reads.fq", reads)
    r = run_oracle(["-a", "reads.fq", "-d", "ref.fa", "-M", rule, "-V", "0",
                    "-o", "aln.sam"] + list(flags), tmp_path)
    assert r.returncode == 0, r.stderr
    return g


@pytest.mark.skipif(not (REF_KIT.exists() and have_oracle()),
                    reason="reference toolkit not present")
def test_avgmod_differential(tmp_path, rng):
    _make_aligned_sam(tmp_path, rng)
    r = run_ref_kit(["avgmod", "aln.sam", "ref.fa", "-M", "C:T", "-o", "ref_out",
                     "-m", "1"], tmp_path, tmp_path)
    assert r.returncode == 0, r.stderr + r.stdout
    run_our_kit(["avgmod", "aln.sam", "ref.fa", "-M", "C:T", "-o", "our_out",
                 "-m", "1"], tmp_path)
    want = (tmp_path / "ref_out_AvgMod.tsv").read_text()
    got = (tmp_path / "our_out_AvgMod.tsv").read_text()
    assert got == want


@pytest.mark.skipif(not (REF_KIT.exists() and have_oracle()),
                    reason="reference toolkit not present")
def test_avgmod_context_combine(tmp_path, rng):
    """-x CG -g (context filter + CpG strand combine) differential."""
    _make_aligned_sam(tmp_path, rng)
    args = ["avgmod", "aln.sam", "ref.fa", "-M", "C:T", "-m", "1",
            "-x", "CG", "-g"]
    r = run_ref_kit(args + ["-o", "ref_out"], tmp_path, tmp_path)
    assert r.returncode == 0, r.stderr + r.stdout
    run_our_kit(args + ["-o", "our_out"], tmp_path)
    assert ((tmp_path / "our_out_AvgMod.tsv").read_text()
            == (tmp_path / "ref_out_AvgMod.tsv").read_text())


@pytest.mark.skipif(not (REF_KIT.exists() and have_oracle()),
                    reason="reference toolkit not present")
def test_avgmod_ag_rna(tmp_path, rng):
    """A:G RNA mode (GLORI-style) differential incl. wiggle output."""
    _make_aligned_sam(tmp_path, rng, rule="A:G")
    args = ["avgmod", "aln.sam", "ref.fa", "-M", "A:G", "-T", "RNA", "-m", "1",
            "-w", "w"]
    r = run_ref_kit(args + ["-o", "ref_out"], tmp_path, tmp_path)
    assert r.returncode == 0, r.stderr + r.stdout
    ref_wig = (tmp_path / "w_AvgMod.wig").read_text()
    os.rename(tmp_path / "w_AvgMod.wig", tmp_path / "ref.wig")
    run_our_kit(args + ["-o", "our_out"], tmp_path)
    assert ((tmp_path / "our_out_AvgMod.tsv").read_text()
            == (tmp_path / "ref_out_AvgMod.tsv").read_text())
    assert (tmp_path / "w_AvgMod.wig").read_text() == ref_wig


def test_shiftd_rightmost(tmp_path):
    from basal_jax.toolkit.shiftd import rightmost_d
    # deletion of T inside TTT run: slide right
    #              0123456789
    xr = "ACGTTTTACG"
    assert rightmost_d("3M1D6M", xr, "T") == "6M1D3M"
    # no run after D end: unchanged
    assert rightmost_d("7M1D2M", xr, "A") == "7M1D2M"


def test_fdr_roundtrip(tmp_path):
    import gzip
    tsv = tmp_path / "t_AvgMod.tsv"
    rows = ["chr\tpos\tstrand\tcontext\tratio\teff_coverage\tN_mod\tN_total"]
    rng = np.random.default_rng(1)
    for i in range(50):
        tot = int(rng.integers(4, 40))
        mod = int(rng.integers(0, tot + 1))
        rows.append(f"chr1\t{i*10+1}\t+\tACTGA\t{mod/tot:.3f}\t{tot:.2f}\t{mod}\t{tot}")
    tsv.write_text("\n".join(rows) + "\n")
    from basal_jax.toolkit.fdr import calc_pval
    calc_pval(str(tsv), None, str(tmp_path / "out"), min_depth=4,
              method="binomial", fdr_method="fdr_bh")
    with gzip.open(tmp_path / "out_FDR.tsv.gz", "rt") as f:
        lines = f.read().splitlines()
    assert lines[0].endswith("FDR")
    assert len(lines) == 51
    # FDR values monotone-consistent with p-values
    pv = [float(l.split("\t")[-2]) for l in lines[1:]]
    q = [float(l.split("\t")[-1]) for l in lines[1:]]
    order = np.argsort(pv)
    assert all(q[order[i]] <= q[order[i + 1]] + 1e-12
               for i in range(len(order) - 1))


def test_multitest_vs_scipy_fdr(tmp_path):
    """fdr_bh matches scipy.stats.false_discovery_control."""
    import scipy.stats
    rng = np.random.default_rng(3)
    p = rng.uniform(size=200)
    from basal_jax.toolkit.multitest import multipletests
    ours = multipletests(p, method="fdr_bh")[1]
    want = scipy.stats.false_discovery_control(p, method="bh")
    assert np.allclose(ours, want)
    ours_by = multipletests(p, method="fdr_by")[1]
    want_by = scipy.stats.false_discovery_control(p, method="by")
    assert np.allclose(ours_by, want_by)


def test_regmod(tmp_path):
    tsv = tmp_path / "a_AvgMod.tsv"
    tsv.write_text(
        "chr\tpos\tstrand\tcontext\tratio\teff_coverage\tN_mod\tN_total\n"
        "chr1\t10\t+\tC\t0.500\t10.00\t5\t10\n"
        "chr1\t11\t-\tC\t0.250\t4.00\t1\t4\n"
        "chr1\t50\t+\tC\t1.000\t6.00\t6\t6\n")
    bed = tmp_path / "r.bed"
    bed.write_text("chr1\t5\t20\nchr1\t40\t60\nchr2\t1\t100\n")
    from basal_jax.toolkit.regmod import regmod
    regmod(str(bed), str(tsv), str(tmp_path / "out.tsv"))
    lines = (tmp_path / "out.tsv").read_text().splitlines()
    # region 1: sites at 10(+) and 11(-) merge onto pos 10: (5+1)/(10+4)
    r1 = lines[1].split("\t")
    assert abs(float(r1[3]) - 6 / 14) < 1e-9
    assert r1[4] == "2"
    r2 = lines[2].split("\t")
    assert float(r2[3]) == 1.0
    r3 = lines[3].split("\t")
    assert r3[3] == "nan"


def test_mergebam_lift(tmp_path):
    """Transcript->genome liftover: plus and minus strand, junction split."""
    from basal_jax.toolkit.bamio import BamWriter, decode_bam_to_sam
    from basal_jax.toolkit.mergebam import merge_bam

    gtf = tmp_path / "ann.gtf"
    gtf.write_text(
        'chr1\tx\texon\t101\t150\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
        'chr1\tx\texon\t201\t250\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
        'chr1\tx\texon\t301\t350\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n'
        'chr1\tx\texon\t401\t450\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n')
    # genome BAM supplies the header
    with BamWriter(str(tmp_path / "g.bam")) as bw:
        bw.write("@HD\tVN:1.0\n@SQ\tSN:chr1\tLN:1000\n"
                 "gr1\t0\tchr1\t500\t255\t10M\t*\t0\t0\t" + "A" * 10 + "\t"
                 + "I" * 10 + "\tZS:Z:++\n")
    # transcriptome BAM: t1 read spanning the exon junction at t-pos 41..60
    with BamWriter(str(tmp_path / "t.bam")) as bw:
        bw.write("@HD\tVN:1.0\n@SQ\tSN:t1\tLN:100\n@SQ\tSN:t2\tLN:100\n"
                 "tr1\t0\tt1\t41\t255\t20M\t*\t0\t0\t" + "C" * 20 + "\t"
                 + "I" * 20 + "\tZS:Z:++\n"
                 "tr2\t0\tt2\t1\t255\t10M\t*\t0\t0\t" + "ACGTACGTAC" + "\t"
                 + "I" * 10 + "\tZS:Z:++\n")
    out = merge_bam(str(tmp_path / "t.bam"), str(tmp_path / "g.bam"),
                    str(gtf), str(tmp_path / "m"))
    sam = decode_bam_to_sam(out)
    recs = {l.split("\t")[0]: l.split("\t") for l in sam.splitlines()
            if l and not l.startswith("@")}
    # tr1: t-coords 41-60 -> genome 141-150 then junction then 201-210
    assert recs["tr1"][2] == "chr1"
    assert recs["tr1"][3] == "141"
    assert recs["tr1"][5] == "10M50N10M"
    # tr2 (minus strand): t-pos 1-10 maps to genome 441..450, flag flipped,
    # seq revcomp'd, ZS remapped
    assert recs["tr2"][3] == "441"
    assert int(recs["tr2"][1]) & 0x10
    assert recs["tr2"][9] == "GTACGTACGT"
    assert any(f == "ZS:Z:-+" for f in recs["tr2"][11:])
    assert recs["gr1"][3] == "500"
