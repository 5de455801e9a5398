"""CRAM 3.0 codec tests: varints, rANS4x8, container round-trips across
every compression method and structural option, and avgmod TSV parity
CRAM == BAM == SAM on real oracle-aligned data.

The environment has no CRAM-capable samtools (the vendored copy is 0.1.18,
pre-CRAM) and no pysam, so external-writer differentials are impossible
here; the decoder is validated against spec-driven fixtures produced by our
own writer, which exercises every codec/encoding path the reader supports
(raw/gzip/bzip2/lzma/rANS4x8-O0/O1, EXTERNAL/HUFFMAN/BYTE_ARRAY_LEN/
BYTE_ARRAY_STOP/BETA, detached + NF mates, multi-ref and embedded-ref
slices)."""

import io
import random

import pytest

from basal_jax.toolkit import cram

from conftest import (convert_reads, have_oracle, make_fastq, make_ref,
                      random_genome, run_oracle)


def test_varints():
    for v in [0, 1, 127, 128, 16383, 16384, 2 ** 21 - 1, 2 ** 28 - 1,
              2 ** 28, 2 ** 31 - 1, -1, -2, -100000, -(2 ** 31)]:
        enc = cram.itf8_encode(v)
        dec, pos = cram.itf8_decode(enc, 0)
        assert dec == v and pos == len(enc), (v, dec, enc.hex())
    for v in [0, 1, 127, 128, 2 ** 14, 2 ** 21, 2 ** 28, 2 ** 35, 2 ** 42,
              2 ** 49, 2 ** 56, 2 ** 60, (1 << 63) - 1]:
        enc = cram.ltf8_encode(v)
        dec, pos = cram.ltf8_decode(enc, 0)
        assert dec == v and pos == len(enc), (v, dec, enc.hex())


@pytest.mark.parametrize("order", [0, 1])
def test_rans_roundtrip(order):
    rng = random.Random(7 + order)
    cases = [
        bytes([65] * 1000),                                   # single symbol
        bytes(rng.randrange(256) for _ in range(997)),        # dense, n%4!=0
        bytes(rng.choice(b"ACGT") for _ in range(4096)),      # small alphabet
        bytes(rng.choice(b"AACCCGT!") for _ in range(3)),     # n < 4
        bytes([0, 0, 1, 2, 255, 254] * 100 + [7]),            # sym 0 + rle
        b"x",
        bytes(rng.choice(b"AB") for _ in range(2)),
        bytes(rng.choice(bytes(range(32))) for _ in range(65536)),  # big
    ]
    for i, d in enumerate(cases):
        blob = cram.rans_compress(d, order)
        assert cram.rans_decompress(blob) == d, (order, i, len(d))


def _mk_sam(seed=11, n=200):
    rng = random.Random(seed)
    ref = {"chr1": "".join(rng.choice("ACGT") for _ in range(5000)),
           "chr2": "".join(rng.choice("ACGT") for _ in range(3000))}
    header = ("@HD\tVN:1.0\tSO:unsorted\n@SQ\tSN:chr1\tLN:5000\n"
              "@SQ\tSN:chr2\tLN:3000\n")
    lines = []
    for i in range(n):
        cr = "chr1" if i % 4 else "chr2"
        pos = 1 + (i * 17) % 2000
        ln = 50
        seq = list(ref[cr][pos - 1:pos - 1 + ln])
        cig = f"{ln}M"
        if i % 3 == 0:
            seq[5] = "A" if seq[5] != "A" else "G"
        if i % 5 == 0:
            seq = list("TT") + seq
            cig = f"2S{ln}M"
        q = "".join(chr(33 + (i + j) % 40) for j in range(len(seq)))
        lines.append("\t".join(
            [f"r{i}", str(16 if i % 2 else 0), cr, str(pos), "42", cig,
             "*", "0", "0", "".join(seq), q, "ZS:Z:++", "NM:i:2",
             f"XL:i:{i}"]))
    return header + "\n".join(lines) + "\n", ref


@pytest.mark.parametrize("method",
                         ["raw", "gzip", "bzip2", "lzma", "rans0", "rans1"])
def test_cram_roundtrip_methods(tmp_path, method):
    sam, ref = _mk_sam()
    p = str(tmp_path / "t.cram")
    cram.write_cram(p, io.StringIO(sam), ref, method=method,
                    records_per_slice=64)
    out = cram.read_cram_to_sam(p, ref)
    orig = [l for l in sam.split("\n") if l and not l.startswith("@")]
    got = [l for l in out.split("\n") if l and not l.startswith("@")]
    assert orig == got


def _structural_sam():
    rng = random.Random(13)
    ref = {"chr1": "".join(rng.choice("ACGT") for _ in range(5000))}
    g = ref["chr1"]
    header = "@HD\tVN:1.0\n@SQ\tSN:chr1\tLN:5000\n"
    lines = [
        # proper pair with explicit mate fields
        "p1\t99\tchr1\t100\t40\t50M\t=\t200\t150\t" + g[99:149] +
        "\t" + "I" * 50 + "\tZS:Z:++",
        "p1\t147\tchr1\t200\t40\t50M\t=\t100\t-150\t" + g[199:249] +
        "\t" + "J" * 50 + "\tZS:Z:+-",
        # insertion + deletion + soft clip
        "ind1\t0\tchr1\t500\t60\t10M2I10M3D20M5S\t*\t0\t0\t" +
        g[499:509] + "GG" + g[509:519] + g[522:542] + "ACGTA" +
        "\t" + "K" * 47,
        # intron + hard clip, reverse strand
        "spl1\t16\tchr1\t1000\t50\t5H20M100N20M\t*\t0\t0\t" +
        g[999:1019] + g[1119:1139] + "\t" + "L" * 40,
        # unmapped with and without sequence
        "u1\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGTAC\tMMMMMMMMMM",
        "u2\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*",
        # mapped, no quality string
        "nq1\t0\tchr1\t300\t30\t20M\t*\t0\t0\t" + g[299:319] + "\t*",
        # float and array tags
        "tg1\t0\tchr1\t400\t20\t10M\t*\t0\t0\t" + g[399:409] +
        "\t" + "N" * 10 + "\tXF:f:2.5\tXB:B:c,1,-2,3\tXA:A:z",
    ]
    return header + "\n".join(lines) + "\n", ref


@pytest.mark.parametrize("kwargs", [
    dict(method="gzip"),
    dict(method="rans1"),
    dict(method="gzip", use_nf=True),       # NF mate-downstream links
    dict(method="rans0", core_series=False),  # MQ external, no core bits
    dict(method="gzip", embed_ref=True),    # embedded-reference slices
])
def test_cram_roundtrip_structural(tmp_path, kwargs):
    sam, ref = _structural_sam()
    p = str(tmp_path / "t.cram")
    cram.write_cram(p, io.StringIO(sam), ref, records_per_slice=3, **kwargs)
    dec_ref = None if kwargs.get("embed_ref") else ref
    out = cram.read_cram_to_sam(p, dec_ref)
    orig = [l for l in sam.split("\n") if l and not l.startswith("@")]
    got = [l for l in out.split("\n") if l and not l.startswith("@")]
    assert orig == got, kwargs


def test_cram_header_preserved(tmp_path):
    sam, ref = _mk_sam(n=5)
    p = str(tmp_path / "t.cram")
    cram.write_cram(p, io.StringIO(sam), ref)
    hdr = [l for l in cram.read_cram_to_sam(p, ref).split("\n")
           if l.startswith("@")]
    assert hdr == [l for l in sam.split("\n") if l.startswith("@")]


@pytest.mark.skipif(not have_oracle(), reason="oracle not built")
@pytest.mark.parametrize("method", ["gzip", "rans1"])
def test_avgmod_cram_parity(tmp_path, rng, method):
    """avgmod on a CRAM of BASAL-aligned reads produces the identical TSV
    to the BAM and SAM paths (reference behavior: CRAM via samtools view,
    /root/reference/basalkit_functions.py:163-166)."""
    g = random_genome(rng, 6000)
    make_ref(tmp_path / "ref.fa", [("chr1", g)])
    reads = convert_reads(rng, g, 80, 80, "C:T", rate=0.6, sub_rate=0.01,
                          revcomp_frac=0.4)
    make_fastq(tmp_path / "reads.fq", reads)
    r = run_oracle(["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0",
                    "-S", "1", "-u", "-o", "aln.sam"], tmp_path)
    assert r.returncode == 0, r.stderr

    sam_text = (tmp_path / "aln.sam").read_text()
    cram.write_cram(str(tmp_path / "aln.cram"), io.StringIO(sam_text),
                    {"chr1": g.upper()}, method=method,
                    records_per_slice=37)

    from basal_jax.toolkit import bamutil
    bamutil.sort(str(tmp_path / "aln.sam"), str(tmp_path / "aln.bam"))

    import os
    from basal_jax.toolkit.cli import main
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        for inp, out in (("aln.sam", "o_sam"), ("aln.bam", "o_bam"),
                         ("aln.cram", "o_cram")):
            main(["avgmod", inp, "ref.fa", "-M", "C:T", "-o", out,
                  "-m", "1"])
    finally:
        os.chdir(old)
    want = (tmp_path / "o_sam_AvgMod.tsv").read_text()
    assert (tmp_path / "o_cram_AvgMod.tsv").read_text() == want
    assert (tmp_path / "o_bam_AvgMod.tsv").read_text() == want
    assert want.count("\n") > 3


def test_core_bit_encodings():
    """BETA/GAMMA/SUBEXP decode against hand-built core bit streams (the
    writer emits only BETA, so GAMMA/SUBEXP need direct fixtures;
    parameter layouts per CRAM 3.0 spec section 13)."""
    # BETA(offset=2, nbits=5): value v stored as v+offset in 5 bits
    enc = cram.Encoding(6, cram.itf8_encode(2) + cram.itf8_encode(5))
    bw = cram.BitWriter()
    for v in (0, 1, 29, 17):
        bw.write_bits(v + 2, 5)
    br = cram.BitReader(bw.getvalue())
    assert [enc.decode_int(br, {}) for _ in range(4)] == [0, 1, 29, 17]

    # GAMMA(offset=1): Elias gamma of v+offset
    enc = cram.Encoding(9, cram.itf8_encode(1))
    bw = cram.BitWriter()
    for v in (0, 1, 6, 99):
        x = v + 1
        n = x.bit_length() - 1
        bw.write_bits(0, n)          # n leading zeros
        bw.write_bits(x, n + 1)      # 1 marker + n value bits
    br = cram.BitReader(bw.getvalue())
    assert [enc.decode_int(br, {}) for _ in range(4)] == [0, 1, 6, 99]

    # SUBEXP(offset=0, k=2): unary prefix of 1s then fixed/suffix bits
    enc = cram.Encoding(7, cram.itf8_encode(0) + cram.itf8_encode(2))
    bw = cram.BitWriter()
    for v in (0, 3, 5, 100):
        if v < (1 << 2):
            bw.write_bits(0, 1)      # n = 0 terminator
            bw.write_bits(v, 2)
        else:
            b = v.bit_length() - 1
            n = b - 2 + 1
            bw.write_bits((1 << n) - 1, n)  # n ones
            bw.write_bits(0, 1)
            bw.write_bits(v - (1 << b), b)
    br = cram.BitReader(bw.getvalue())
    assert [enc.decode_int(br, {}) for _ in range(4)] == [0, 3, 5, 100]


def test_huffman_multi_symbol():
    """Canonical multi-symbol HUFFMAN (writer only emits the 0-length
    constant form): alphabet {5,6,7} with lengths {1,2,2} -> canonical
    codes 0, 10, 11."""
    params = (cram.itf8_encode(3) + cram.itf8_encode(5) + cram.itf8_encode(6)
              + cram.itf8_encode(7) + cram.itf8_encode(3)
              + cram.itf8_encode(1) + cram.itf8_encode(2)
              + cram.itf8_encode(2))
    enc = cram.Encoding(3, params)
    bw = cram.BitWriter()
    for bits, n in ((0, 1), (0b10, 2), (0b11, 2), (0, 1)):
        bw.write_bits(bits, n)
    br = cram.BitReader(bw.getvalue())
    assert [enc.decode_int(br, {}) for _ in range(4)] == [5, 6, 7, 5]


# ---------------------------------------------------------------------------
# Spec-derived byte-level fixtures (round-5): assembled BY HAND from the
# CRAMv3 spec byte layout (container/block/slice framing per spec §7-§9,
# rANS4x8 per §13) — NOT produced by cram.py's writer — so shared
# reader/writer misreadings of the spec cannot pass silently.  Every byte
# below is literal; the derivations are in the comments.
# ---------------------------------------------------------------------------


def test_rans_o0_fixture_rle_run():
    """rANS4x8 Order-0, hand-derived (spec §13.4-13.6).

    raw = b"abc", freqs a:1024 b:1024 c:2048 (sum = 4096 = 1<<TF_SHIFT).
    Frequency table exercises the consecutive-symbol RLE run: after 'a',
    the next symbol byte 0x62 == prev+1 triggers the RLE marker form
    (0x62 0x01 = start 'b', run of 1 more -> 'c' implicit), and both
    freq widths (0x84 0x00 = 2-byte form of 1024; 0x88 0x00 = 2048).
    States hand-computed from x' = (x//f << 12) + C + x%f with x0 = 1<<23:
      lane0 'a' (f=1024,C=0)    -> 0x2000000
      lane1 'b' (f=1024,C=1024) -> 0x2000400
      lane2 'c' (f=2048,C=2048) -> 0x1000800
      lane3 unused              -> 0x800000 (initial L)
    No renormalization bytes (all states stay < threshold during encode).
    """
    blob = (b"\x00\x1a\x00\x00\x00\x03\x00\x00\x00"           # O0, comp=26, raw=3
            b"a\x84\x00b\x01\x84\x00\x88\x00\x00"              # freq table
            b"\x00\x00\x00\x02\x00\x04\x00\x02\x00\x08\x00\x01"  # states LE
            b"\x00\x00\x80\x00")
    assert cram.rans_decompress(blob) == b"abc"


def test_rans_o0_fixture_renormalization():
    """rANS4x8 Order-0 with decoder-side renormalization pulls (§13.6).

    raw = b"aaaa", freqs a:16 (1-byte form 0x10), b:4080 (2-byte form
    0x8F 0xF0; present in the table but absent from the stream — legal).
    Decode of 'a' from x = 1<<23: x' = 16*(x>>12) + 0 - 0 = 0x8000 <
    L(1<<23), so each lane pulls exactly one stream byte
    (0x8000<<8 | b >= L).  The four pulled bytes AA BB CC DD are consumed
    in lane order 0..3; final states are not validated by the format.
    """
    blob = (b"\x00\x1b\x00\x00\x00\x04\x00\x00\x00"
            b"a\x10b\x00\x8f\xf0\x00"                          # freq table
            b"\x00\x00\x80\x00\x00\x00\x80\x00\x00\x00\x80\x00"
            b"\x00\x00\x80\x00"                                # 4x initial L
            b"\xaa\xbb\xcc\xdd")                               # renorm pulls
    assert cram.rans_decompress(blob) == b"aaaa"


def test_rans_o1_fixture_context_rle():
    """rANS4x8 Order-1, hand-derived (spec §13.7).

    raw = b"abab" * 4 (quarters of 4; lane j decodes quarter j).  Contexts:
    0->a, a->b, b->a — every context row holds ONE symbol at freq 4096, so
    x' = 4096*(x>>12) + m - 0 == x: zero bits per symbol, no
    renormalization, states stay at the initial L.  The outer context
    enumeration exercises BOTH forms: ctx 'a' after ctx 0 is non-
    consecutive (plain byte), ctx 'b' == 'a'+1 uses the RLE marker form
    (0x62 0x00).  Each inner row uses the 2-byte freq form 0x90 0x00
    (= 4096).
    """
    blob = (b"\x01!\x00\x00\x00\x10\x00\x00\x00"               # O1, comp=33, raw=16
            b"\x00a\x90\x00\x00"                               # ctx 0: {a:4096}
            b"a" b"b\x90\x00\x00"                              # ctx a: {b:4096}
            b"b\x00" b"a\x90\x00\x00"                          # ctx b (RLE form)
            b"\x00"                                            # outer terminator
            b"\x00\x00\x80\x00\x00\x00\x80\x00\x00\x00\x80\x00"
            b"\x00\x00\x80\x00")
    assert cram.rans_decompress(blob) == b"abababababababab"


# Full-file fixtures: magic + file-id (§6), file-header container (§8.1),
# data container with compression header (§8.4: preservation map SM,
# data-series encodings EXTERNAL/BYTE_ARRAY_STOP), slice header blocks
# (§8.5: content ids, embedded ref id itf8(-1) = FF FF FF FF 0F), raw
# blocks with CRC32 (§9), EOF container (§9.4: start 4542278 -> the
# \\x00EOF byte signature visible in the stream).

FIX_MULTISLICE = b'CRAM\x03\x00basal-fixture\x00\x00\x00\x00\x00\x00\x00*\x00\x00\x00\xff\xff\xff\xff\x0f\x00\x00\x00\x00\x00\x01\x01\x00\xc41\x8b\xe2\x00\x00\x00!!\x1d\x00\x00\x00@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:40\nS\x80\xec\x8f\xe2\x00\x00\x00\x00\x05\x19\x02\x00\x14\t\x02I\x80\x97\xa9\xfd~\xc2\x00\x01\x00@@\x08\x01SM\xe4\x1b\x1b\x1b\x1b4\nBF\x01\x01\x01CF\x01\x01\x01RL\x01\x01\x01AP\x01\x01\x01MQ\x01\x01\x01FN\x01\x01\x01FP\x01\x01\x01FC\x01\x01\x01BS\x01\x01\x01RN\x05\x02\x00\n\x01\x00(\xd17S\x00\x02\x00\x1e\x1e\x00\x05\n\x01\x00\x03\x02\x01\n\xff\xff\xff\xff\x0f\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00h\xc5\x01\x84\x00\x05\x00\x00\x00/\x07\xfc\xf1\x00\x04\x01\t\t\x00\x00\n\x00\x01X\x01\x03\x1eU\x1f\xb6J\x00\x04\n\x03\x03q1\x00\xf7\x08\x8d\xf6\x00\x02\x00\x1e\x1e\x00\x14\n\x01\x00\x03\x02\x01\n\xff\xff\xff\xff\x0f\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00I\x91\xcea\x00\x05\x00\x00\x00/\x07\xfc\xf1\x00\x04\x01\x06\x06\x10\x00\n\x00\x00\x074N\xa7"\x00\x04\n\x03\x03q2\x004[\xa0\xdd\x00\x00\x00\x00\xff\xff\xff\xff\x0f\xe0EOF\x00\x00\x00\x00\x00\x00\x8a\x1a]\x15'

FIX_EMBEDDED = b'CRAM\x03\x00basal-fixture\x00\x00\x00\x00\x00\x00\x00*\x00\x00\x00\xff\xff\xff\xff\x0f\x00\x00\x00\x00\x00\x01\x01\x00\xc41\x8b\xe2\x00\x00\x00!!\x1d\x00\x00\x00@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:30\n\xd6\x96\xa3\x8a\x93\x00\x00\x00\x00\x0b\x08\x01\x00\x08\x06\x01\x00\tM(\xdb\x00\x01\x0011\x08\x01SM\x1b\x1b\x1b\x1b\x1b%\x07BF\x01\x01\x01CF\x01\x01\x01RL\x01\x01\x01AP\x01\x01\x01MQ\x01\x01\x01FN\x01\x01\x01RN\x05\x02\x00\n\x01\x00\xa9j\xce\x82\x00\x02\x00\x1b\x1b\x00\x0b\x08\x01\x00\x04\x03\x01\n**\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\xc2\x0e&\xfb\x00\x05\x00\x00\x00/\x07\xfc\xf1\x00\x04\x01\x06\x06\x00\x00\x08\x00\x00<\x00ms:\x00\x04\n\x03\x03e1\x00[\x03\xa2\xed\x00\x04*\x08\x08GGCCTTAA\xc1\x83F3\x00\x00\x00\x00\xff\xff\xff\xff\x0f\xe0EOF\x00\x00\x00\x00\x00\x00\x8a\x1a]\x15'


def test_cram_multislice_substitution_fixture(tmp_path):
    """Two slices in ONE container (landmarks, per-slice header + core +
    external blocks) and a CORNER substitution matrix: the ref-'A' row
    byte is 0xE4 = codes 11 10 01 00, i.e. C->3 G->2 T->1 N->0 (§10.2:
    2-bit codes packed high-to-low in ACGTN-minus-ref order), so code2base
    for 'A' is "NTGC" — the reverse of the identity row 0x1B.

    Slice 1: read q1 at ap=5 on chr1=(ACGT)*10, one 'X' feature at read
    pos 1 with BS code 3.  rpos=5 -> ref base 'A' -> alts[3] = 'C' (with
    the identity matrix it would be 'N'): seq = C + ref[6..14] =
    CCGTACGTAC.  Slice 2: read q2 at ap=20, no features: pure ref copy
    TACGTACGTA, flag 16, mapq 7 — its AP delta restarts at slice start
    (§8.5: prev_ap initialized per slice)."""
    p = tmp_path / "ms.cram"
    p.write_bytes(FIX_MULTISLICE)
    out = cram.read_cram_to_sam(str(p), ref={"chr1": "ACGT" * 10})
    body = [l for l in out.splitlines() if not l.startswith("@")]
    assert body == [
        "q1\t0\tchr1\t5\t30\t10M\t*\t0\t0\tCCGTACGTAC\t*",
        "q2\t16\tchr1\t20\t7\t10M\t*\t0\t0\tTACGTACGTA\t*",
    ]


def test_cram_embedded_ref_fixture(tmp_path):
    """Slice with an EMBEDDED reference block (§8.5: embedded_ref_id = 42
    names an external block holding the reference bases for the slice
    span): read e1 at ap=11 reconstructs GGCCTTAA purely from the
    embedded block — no external reference is passed, so any fallback to
    the refget 'N'-run path would be visible immediately."""
    p = tmp_path / "emb.cram"
    p.write_bytes(FIX_EMBEDDED)
    out = cram.read_cram_to_sam(str(p))  # NO ref
    body = [l for l in out.splitlines() if not l.startswith("@")]
    assert body == ["e1\t0\tchr1\t11\t60\t8M\t*\t0\t0\tGGCCTTAA\t*"]
