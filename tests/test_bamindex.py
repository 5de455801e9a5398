"""BAI writer / region query vs the vendored samtools 0.1.18 binary.

Independent oracle: tools/build_samtools.sh builds the *reference tree's own*
samtools (SURVEY §2.2), whose index builder
(/root/reference/samtools/bam_index.c:152-256) our bamindex.build_index
mirrors behaviorally.  We compare the parsed index (bins/chunks, linear
index, n_no_coor) — bin *order* differs by design (khash order vs sorted) —
and drive `samtools view <region>` through OUR .bai.
"""

import random
import subprocess
from pathlib import Path

import pytest

from basal_jax.toolkit.bamindex import (build_index, fetch_sam_lines,
                                        load_index)
from basal_jax.toolkit.bamio import BamWriter

SAMTOOLS = Path(__file__).resolve().parents[1] / ".oracle" / "samtools"

REFS = [("chr1", 5_000_000), ("chr2", 2_000_000), ("chrM", 20_000)]


def _make_sorted_bam(path, rng, n_per_chr=3000, with_no_coor=True,
                     skip_chr=("chr2",)):
    lines = ["@HD\tVN:1.0\tSO:coordinate"]
    for nm, ln in REFS:
        lines.append(f"@SQ\tSN:{nm}\tLN:{ln}")
    n_rec = 0
    for nm, ln in REFS:
        if nm in skip_chr:
            continue
        poss = sorted(rng.randrange(1, ln - 200) for _ in range(n_per_chr))
        for i, p in enumerate(poss):
            L = rng.choice((50, 75, 100))
            seq = "".join(rng.choice("ACGT") for _ in range(L))
            flag = 0 if rng.random() > 0.05 else 4
            cig = f"{L}M" if flag == 0 else "*"
            lines.append(f"r{nm}_{i}\t{flag}\t{nm}\t{p}\t255\t{cig}\t*\t0\t0"
                         f"\t{seq}\t{'I' * L}\tNM:i:0")
            n_rec += 1
    if with_no_coor:
        for i in range(17):
            lines.append(f"u{i}\t4\t*\t0\t0\t*\t*\t0\t0\t{'A' * 60}\t{'I' * 60}")
            n_rec += 1
    with BamWriter(str(path)) as bw:
        bw.write("\n".join(lines) + "\n")
    return n_rec


@pytest.mark.skipif(not SAMTOOLS.exists(),
                    reason="vendored samtools not built "
                           "(bash tools/build_samtools.sh)")
def test_bai_semantic_equal_to_samtools(tmp_path):
    rng = random.Random(42)
    bam = tmp_path / "t.bam"
    _make_sorted_bam(bam, rng)
    subprocess.run([str(SAMTOOLS), "index", str(bam)], check=True)
    st = load_index(str(bam) + ".bai")
    (tmp_path / "t.bam.bai").unlink()
    ours = load_index(build_index(str(bam)))
    assert len(st[0]) == len(ours[0]) == len(REFS)
    for tid in range(len(REFS)):
        assert dict(st[0][tid]) == dict(ours[0][tid]), f"bins differ tid={tid}"
        assert st[1][tid] == ours[1][tid], f"linear index differs tid={tid}"
    assert st[2] == ours[2]  # n_no_coor


@pytest.mark.skipif(not SAMTOOLS.exists(),
                    reason="vendored samtools not built")
def test_samtools_region_view_through_our_bai(tmp_path):
    rng = random.Random(43)
    bam = tmp_path / "t.bam"
    _make_sorted_bam(bam, rng)
    build_index(str(bam))  # writes t.bam.bai (ours)
    for region, ref, beg, end in [
        ("chr1:100000-300000", "chr1", 99999, 300000),
        ("chrM:1000-6000", "chrM", 999, 6000),
        ("chr2:1-2000000", "chr2", 0, 2000000),
    ]:
        st = subprocess.run([str(SAMTOOLS), "view", str(bam), region],
                            capture_output=True, text=True, check=True)
        st_lines = [l for l in st.stdout.splitlines() if l]
        ours = fetch_sam_lines(str(bam), ref, beg, end)
        assert ours == st_lines, f"region {region}: {len(ours)} vs {len(st_lines)}"


def test_bai_roundtrip_no_samtools(tmp_path):
    """Pure self-test (runs even without the samtools binary): every record
    is found via its own region query."""
    rng = random.Random(44)
    bam = tmp_path / "t.bam"
    _make_sorted_bam(bam, rng, n_per_chr=300, with_no_coor=False)
    build_index(str(bam))
    lines = fetch_sam_lines(str(bam), "chr1", 0, REFS[0][1])
    assert len(lines) == 300
    one = lines[137].split("\t")
    pos, L = int(one[3]) - 1, len(one[9])
    got = fetch_sam_lines(str(bam), "chr1", pos, pos + 1)
    assert "\t".join(one) in got
    # non-overlapping window
    assert all(int(l.split("\t")[3]) - 1 < pos + L
               for l in fetch_sam_lines(str(bam), "chr1", pos, pos + L))


def test_region_query_seeks_not_scans(tmp_path):
    """The .bai must SAVE I/O: a narrow region query on a large BAM reads
    only the BGZF blocks covering the selected chunks (samtools bam_fetch
    seek semantics, /root/reference/samtools/bam_index.c:523-553) — not the
    whole file.  Asserts <5% of the compressed bytes are touched."""
    rng = random.Random(46)
    bam = tmp_path / "big.bam"
    _make_sorted_bam(bam, rng, n_per_chr=60000, with_no_coor=False,
                     skip_chr=())
    build_index(str(bam))
    fsize = bam.stat().st_size
    assert fsize > 4_000_000  # big enough that 5% is a real bound
    stats = {}
    got = fetch_sam_lines(str(bam), "chr2", 1_000_000, 1_010_000,
                          stats=stats)
    assert got  # ~600 reads expected in a 10kb window at this density
    assert all(l.split("\t")[2] == "chr2" for l in got)
    frac = stats["compressed_bytes_read"] / fsize
    assert frac < 0.05, f"read {frac:.1%} of the file for a 10kb region"
    # and the result equals the scan-everything answer (same bam_calend
    # rule: cigar "*" records span 1 bp)
    full = fetch_sam_lines(str(bam), "chr2", 0, REFS[1][1])

    def _rend(f):
        return int(f[3]) - 1 + (len(f[9]) if f[5] != "*" else 1)
    exp = [l for l in full
           if int(l.split("\t")[3]) - 1 < 1_010_000
           and _rend(l.split("\t")) > 1_000_000]
    assert got == exp


def test_bamutil_streaming_sort_and_view(tmp_path):
    """External spill-merge sort == in-memory stable sort, streaming view
    filters, index subcommand, region view via CLI."""
    from basal_jax.toolkit import bamutil
    rng = random.Random(45)
    # unsorted SAM input
    lines = ["@HD\tVN:1.0"] + [f"@SQ\tSN:{nm}\tLN:{ln}" for nm, ln in REFS]
    recs = []
    for i in range(5000):
        nm, ln = REFS[rng.randrange(3)]
        p = rng.randrange(1, ln - 100)
        recs.append(f"x{i}\t0\t{nm}\t{p}\t255\t50M\t*\t0\t0\t{'A' * 50}\t{'I' * 50}")
    sam = tmp_path / "u.sam"
    sam.write_text("\n".join(lines + recs) + "\n")
    # spill path (tiny runs) vs in-memory path must agree exactly
    bamutil.sort(str(sam), str(tmp_path / "a.sam"), mem_lines=512)
    bamutil.sort(str(sam), str(tmp_path / "b.sam"), mem_lines=10 ** 9)
    assert (tmp_path / "a.sam").read_bytes() == (tmp_path / "b.sam").read_bytes()
    # and through BAM output + index + region view
    bamutil.sort(str(sam), str(tmp_path / "s.bam"), mem_lines=512)
    bamutil.index(str(tmp_path / "s.bam"))
    assert (tmp_path / "s.bam.bai").exists()
    out = tmp_path / "r.sam"
    bamutil.view(str(tmp_path / "s.bam"), str(out), region="chr1:1-5000000")
    got = [l for l in out.read_text().splitlines() if not l.startswith("@")]
    exp = [l for l in (tmp_path / "a.sam").read_text().splitlines()
           if not l.startswith("@") and l.split("\t")[2] == "chr1"]
    assert got == exp


def test_avgmod_cram_unsupported_refused(tmp_path):
    """CRAM 3.0 now decodes natively (toolkit/cram.py); unsupported
    versions and CRAM 3.1 codecs must still refuse with a clear message
    instead of misparsing."""
    from basal_jax.toolkit.avgmod import iter_sam_lines
    p = tmp_path / "x.cram"
    p.write_bytes(b"CRAM\x04\x00" + b"\x00" * 20)  # future major version
    with pytest.raises(SystemExit, match="unsupported version"):
        list(iter_sam_lines(str(p)))
    from basal_jax.toolkit.cram import _decompress_block
    with pytest.raises(SystemExit, match="rans4x16"):
        _decompress_block(5, b"\x00", 1)
