"""bt_sam_to_bam (C) vs encode_bam_record (Python) equivalence on edge-case
records: unmapped ('*' fields, refid -1), soft/hard clips, insertions and
deletions, negative TLEN, '=' and explicit mate names, odd-length seqs,
multi-aux records, and the punt path (float aux must fall back to Python
without corrupting output)."""

import subprocess
import sys
from pathlib import Path

import pytest

from basal_jax.native import get_lib

HEADER = "@HD\tVN:1.0\tSO:unsorted\n@SQ\tSN:chr1\tLN:100000\n@SQ\tSN:chr2\tLN:5000\n"

RECORDS = [
    "r1\t0\tchr1\t100\t255\t50M\t*\t0\t0\t" + "ACGT" * 12 + "AC" + "\t" + "I" * 50 + "\tNM:i:2\tZS:Z:++",
    "r2\t4\t*\t0\t0\t*\t*\t0\t0\tACGTN\tIIIII",                      # unmapped
    "r3\t16\tchr2\t1\t30\t5S20M3I10M2D9M4H\t*\t0\t0\t" + "A" * 47 + "\t" + "#" * 47 + "\tNM:i:9",
    "r4\t99\tchr1\t500\t255\t40M\t=\t700\t240\t" + "G" * 40 + "\t" + "I" * 40 + "\tXR:Z:ab:cd:ef",  # aux value with colons
    "r5\t147\tchr1\t700\t255\t40M\tchr2\t4000\t-240\t" + "C" * 40 + "\t" + "I" * 40,  # explicit mate + negative tlen
    "r6\t0\tchr1\t9\t255\t7M\t*\t0\t0\tACGTACG\tIIIIIII\tZL:i:-17\tXA:A:Q",  # odd seq len, negative int aux, A aux
    "r7\t0\tchr1\t55\t255\t6M\t*\t0\t0\tacgtrn\t!!!!!!",             # lowercase + ambiguity codes
]


def _write_both(tmp_path, text, env_extra):
    out = tmp_path / ("nat.bam" if not env_extra else "py.bam")
    code = (
        "import sys; sys.path.insert(0, '/root/repo')\n"
        "from basal_jax.toolkit.bamio import BamWriter\n"
        f"w = BamWriter({str(out)!r})\n"
        f"w.write({text!r})\n"
        "w.close()\n")
    import os
    env = dict(os.environ)
    env.update(env_extra)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return out.read_bytes()


@pytest.mark.skipif(get_lib() is None, reason="native engine unavailable")
def test_edge_records_native_equals_python(tmp_path):
    text = HEADER + "\n".join(RECORDS) + "\n"
    nat = _write_both(tmp_path, text, {})
    py = _write_both(tmp_path, text, {"BASAL_NO_NATIVE": "1"})
    assert nat == py


@pytest.mark.skipif(get_lib() is None, reason="native engine unavailable")
def test_float_aux_punts_to_python(tmp_path):
    text = HEADER + RECORDS[0] + "\tXF:f:1.25\n" + RECORDS[1] + "\n"
    nat = _write_both(tmp_path, text, {})
    py = _write_both(tmp_path, text, {"BASAL_NO_NATIVE": "1"})
    assert nat == py


@pytest.mark.skipif(get_lib() is None, reason="native engine unavailable")
def test_many_aux_fields_punt(tmp_path):
    """>64 total fields must punt to the Python encoder (not silently drop
    the excess aux tags)."""
    aux = "\t".join(f"X{chr(65 + i % 26)}:Z:v{i}" for i in range(56))
    text = HEADER + RECORDS[0] + "\t" + aux + "\n" + RECORDS[3] + "\n"
    nat = _write_both(tmp_path, text, {})
    py = _write_both(tmp_path, text, {"BASAL_NO_NATIVE": "1"})
    assert nat == py
    p = tmp_path / "chk.bam"
    p.write_bytes(nat)
    from basal_jax.toolkit.bamio import decode_bam_to_sam
    assert "v55" in decode_bam_to_sam(str(p))  # the 56th aux tag survived


@pytest.mark.skipif(get_lib() is None, reason="native engine unavailable")
def test_decode_roundtrip(tmp_path):
    """Decoding the natively-encoded BAM reproduces the records (RNEXT
    rendered '=' when it equals RNAME, per samtools convention)."""
    from basal_jax.toolkit.bamio import decode_bam_to_sam
    text = HEADER + "\n".join(RECORDS) + "\n"
    out = tmp_path / "nat.bam"
    from basal_jax.toolkit.bamio import BamWriter
    with BamWriter(str(out)) as w:
        w.write(text)
    got = [l for l in decode_bam_to_sam(str(out)).splitlines()
           if l and not l.startswith("@")]
    assert len(got) == len(RECORDS)
    for g, want in zip(got, RECORDS):
        gc, wc = g.split("\t"), want.split("\t")
        if wc[6] not in ("*", "=") and wc[6] == wc[2]:
            wc[6] = "="  # decoder renders same-ref mates as '='
        assert gc[:9] == wc[:9]          # incl. RNEXT/PNEXT/TLEN
        # seq normalizes: BAM nt16 canonicalizes to uppercase
        assert gc[9] == wc[9].upper()
        assert gc[10] == wc[10]          # qual byte-exact


@pytest.mark.skipif(get_lib() is None, reason="native engine unavailable")
def test_high_qual_bytes_punt(tmp_path):
    """Qual bytes >= 223 (e.g. 0xFF 'no qual' on some records only): the C
    decoders punt and the Python golden handles the file — both the
    toolkit decode and the aligner's BamReader fall back cleanly."""
    import struct as st
    from basal_jax.toolkit.bamio import (BamWriter, BgzfWriter,
                                         decode_bam_to_sam,
                                         encode_bam_record)
    # one normal + one 0xEE-qual record, hand-assembled
    ref_ids = {"chr1": 0}
    rec1 = encode_bam_record(
        "a\t0\tchr1\t10\t255\t4M\t*\t0\t0\tACGT\tIIII".split("\t"), ref_ids)
    rec2 = bytearray(encode_bam_record(
        "b\t0\tchr1\t20\t255\t4M\t*\t0\t0\tACGT\tIIII".split("\t"), ref_ids))
    # patch b's qual bytes to 0xEE (offset: 4 len + 32 fixed + 2 name + 4
    # cigar + 2 seq nibbles)
    qoff = 4 + 32 + 2 + 4 + 2
    rec2[qoff:qoff + 4] = b"\xee" * 4
    bg = BgzfWriter(str(tmp_path / "q.bam"))
    hdr = b"BAM\x01" + st.pack("<i", 0) + st.pack("<i", 1)
    hdr += st.pack("<i", 5) + b"chr1\x00" + st.pack("<i", 100000)
    bg.write(hdr + rec1 + bytes(rec2))
    bg.close()
    text = decode_bam_to_sam(str(tmp_path / "q.bam"))
    recs = [l for l in text.splitlines() if l and not l.startswith("@")]
    assert len(recs) == 2
    assert recs[1].split("\t")[10] == chr(0xEE + 33) * 4  # Python golden

    from basal_jax.config import AlignParams
    from basal_jax.reads.io import BamReader
    rd = BamReader(str(tmp_path / "q.bam"), AlignParams(conversion="C:T"))
    batch = rd.next_batch(10)
    rd.close()
    # native punts -> ReadRec list from the Python loop, both reads present
    assert len(batch) == 2
    recs = [batch[i] if not hasattr(batch, "rec") else batch.rec(i)
            for i in range(2)]
    names = [r.name for r in recs]
    assert names == ["a", "b"]
