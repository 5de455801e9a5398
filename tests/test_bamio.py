"""BAM I/O tests: roundtrip, libbam compatibility (oracle reads our BAM),
and BAM-input alignment parity."""

import pytest

from conftest import (convert_reads, have_oracle, make_fastq, make_ref,
                      norm_sam, random_genome, run_oracle)
from test_differential_se import run_ours


def test_bam_roundtrip(tmp_path, rng):
    from basal_jax.toolkit.bamio import BamWriter, decode_bam_to_sam
    sam = ("@HD\tVN:1.0\n@SQ\tSN:chr1\tLN:5000\n"
           "r1\t0\tchr1\t100\t255\t50M\t*\t0\t0\t" + "A" * 50 + "\t" + "I" * 50 +
           "\tNM:i:2\tZS:Z:++\n"
           "r2\t16\tchr1\t200\t255\t20M2D30M\t*\t0\t0\t" + "C" * 50 + "\t" + "F" * 50 +
           "\tNM:i:3\tXR:Z:acGTGa\tZS:Z:-+\n"
           "r3\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n")
    with BamWriter(str(tmp_path / "t.bam")) as bw:
        bw.write(sam)
    back = decode_bam_to_sam(str(tmp_path / "t.bam"))
    assert norm_sam(back) == norm_sam(sam)


@pytest.mark.skipif(not have_oracle(), reason="oracle not built")
def test_oracle_reads_our_bam(tmp_path, rng):
    """Our BAM output aligns identically when fed back through the oracle's
    libbam BAM-input path (reads.cpp:84-108)."""
    g = random_genome(rng, 6000)
    make_ref(tmp_path / "ref.fa", [("chr1", g)])
    reads = convert_reads(rng, g, 30, 80, "C:T")
    make_fastq(tmp_path / "reads.fq", reads)
    # our aligner -> BAM
    run_ours(["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0",
              "-S", "1", "-u", "-o", "ours.bam"], tmp_path)
    # oracle aligns the BAM as read input (unmapped records carry raw seqs)
    r1 = run_oracle(["-a", "ours.bam", "-d", "ref.fa", "-M", "C:T", "-V", "0",
                     "-S", "1", "-o", "from_bam.sam"], tmp_path)
    assert r1.returncode == 0, r1.stderr
    r2 = run_oracle(["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0",
                     "-S", "1", "-o", "from_fq.sam"], tmp_path)
    assert r2.returncode == 0, r2.stderr
    # read order differs possibly (BAM holds aligned+unmapped in our order =
    # input order) -> same content
    a = sorted(norm_sam((tmp_path / "from_bam.sam").read_text()))
    b = sorted(norm_sam((tmp_path / "from_fq.sam").read_text()))
    assert a == b


@pytest.mark.skipif(not have_oracle(), reason="oracle not built")
def test_bam_input_matches_fastq_input(tmp_path, rng):
    """Our BamReader: aligning from BAM == aligning from FASTQ."""
    g = random_genome(rng, 6000)
    make_ref(tmp_path / "ref.fa", [("chr1", g)])
    reads = convert_reads(rng, g, 30, 80, "C:T")
    make_fastq(tmp_path / "reads.fq", reads)
    from basal_jax.toolkit.bamio import BamWriter
    with BamWriter(str(tmp_path / "in.bam")) as bw:
        bw.write("@HD\tVN:1.0\n")
        for n, s in reads:
            bw.write(f"{n}\t4\t*\t0\t0\t*\t*\t0\t0\t{s}\t{'I' * len(s)}\n")
    out_fq = run_ours(["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T",
                       "-V", "0", "-S", "2", "-u"], tmp_path)
    out_bam = run_ours(["-a", "in.bam", "-d", "ref.fa", "-M", "C:T",
                        "-V", "0", "-S", "2", "-u"], tmp_path)
    assert norm_sam(out_fq) == norm_sam(out_bam)


def test_bgzf_block_structure(tmp_path):
    """BSIZE must equal the actual block span - 1 (SAM spec §4.1): walk the
    file strictly via the BC extra field, validating magic + CRC per block,
    and compare against what Python gzip (which ignores BC) decodes.
    Regression for the off-by-one that desynced htslib-style readers."""
    import gzip
    from basal_jax.toolkit.bamio import BgzfWriter, read_bgzf, BGZF_EOF

    payload = bytes(range(256)) * 700  # > one 0xF000 block
    p = tmp_path / "t.bgzf"
    w = BgzfWriter(str(p))
    w.write(payload)
    w.close()
    assert read_bgzf(str(p)) == payload  # raises on any BSIZE/CRC mismatch
    with gzip.open(str(p), "rb") as g:
        assert g.read() == payload
    assert p.read_bytes().endswith(BGZF_EOF)


def test_bgzf_parallel_matches_serial(tmp_path):
    """Block-parallel compression must write the exact bytes of the serial
    path (same chunking, same deflate parameters, FIFO order)."""
    from basal_jax.toolkit.bamio import BgzfWriter, read_bgzf

    rng = __import__("random").Random(7)
    payload = bytes(rng.randrange(256) for _ in range(0xF000 * 5 + 1234))
    ps, pp = tmp_path / "s.bgzf", tmp_path / "p.bgzf"
    for path, threads in ((ps, 1), (pp, 4)):
        w = BgzfWriter(str(path), threads=threads)
        # dribble writes so buffering/chunk boundaries are exercised
        for off in range(0, len(payload), 100_000):
            w.write(payload[off:off + 100_000])
        w.close()
    assert read_bgzf(str(pp)) == payload
    assert pp.read_bytes() == ps.read_bytes()
