"""mergeBAM — transcriptome→genome liftover + merge.

Re-implementation of BASALkit ``mergeBAM`` (basalkit.py:252-322,
basalkit_functions.py:390-709) without pysam: transcriptome alignments are
lifted to genome coordinates through a GTF exon map (M/D runs split across
exon junctions into N-gapped CIGARs), minus-strand transcripts flip the
record (revcomp seq, 0x10 toggle, ZS remap, XR revcomp), then the lifted and
genome BAMs are merged under a unified header and position-sorted.

Record I/O runs on SAM text through basal_jax.toolkit.bamio.
"""

from __future__ import annotations

import re
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Tuple

from .avgmod import disp, reverse_complement

_CIGAR_RE = re.compile(r"\d+[a-zA-Z]")
_OPS = "MIDNSHP=X"
_OP_CODE = {c: i for i, c in enumerate(_OPS)}


def parse_cigar_tuples(cigar: str) -> List[Tuple[int, int]]:
    return [(_OP_CODE[m[-1]], int(m[:-1])) for m in _CIGAR_RE.findall(cigar)]


def cigar_str(tuples) -> str:
    return "".join(f"{n}{_OPS[op]}" for op, n in tuples)


def read_gtf(path: str) -> Dict[str, dict]:
    """Per-transcript exon coordinate maps (read_gtf,
    basalkit_functions.py:390-436); transcript coords 1-based closed."""
    out = defaultdict(dict)
    for line in open(path):
        if line.startswith("#"):
            continue
        col = line.strip().split("\t")
        if len(col) < 9 or col[2] != "exon":
            continue
        chrom, left, right, strand = col[0], int(col[3]), int(col[4]), col[6]
        trans_id = None
        for field in col[8].split("; "):
            if field.startswith("transcript_id"):
                # also strip a trailing ';' (present when transcript_id is the
                # last attribute; the reference leaves it and then never
                # matches such transcripts)
                trans_id = (field.replace("transcript_id ", "")
                            .replace('"', "").rstrip(";"))
                break
        if trans_id is None:
            continue
        t = out[trans_id]
        if "strand" not in t:
            t["strand"] = strand
            t["chr"] = chrom
            t["starts"] = []
            t["ends"] = []
        if strand == "+":
            t["starts"].append(left)
            t["ends"].append(right)
        else:
            t["starts"].append(right)
            t["ends"].append(left)
    for t in out.values():
        rev = t["strand"] != "+"
        t["starts"].sort(reverse=rev)
        t["ends"].sort(reverse=rev)
        exons = OrderedDict()
        start_t = 1
        for sg, eg in zip(t["starts"], t["ends"]):
            end_t = abs(eg - sg) + start_t
            exons[(start_t, end_t)] = (sg, eg)
            start_t = end_t + 1
        t["exons"] = exons
        del t["starts"], t["ends"]
    return dict(out)


def generate_new_cigar(all_bins, start, end, old_cigar, trans_dir):
    """Exact port of generate_new_cigar (basalkit_functions.py:438-565)."""
    new_tmp = []
    if trans_dir == "-":
        old_cigar = old_cigar[::-1]
        all_bins = all_bins[::-1]
        start, end = end, start
    it = iter(all_bins)
    exon_edge = None
    while True:
        try:
            x, y = next(it)
        except StopIteration:
            raise ValueError("read does not fit transcript exon map")
        if trans_dir == "-":
            x, y = y, x
        if x <= start <= y < end:
            new_tmp.append([0, y - start + 1])
            exon_edge = y
        elif x <= start <= end <= y:
            new_tmp.append([0, end - start + 1])
            break
        elif start < x <= y < end:
            if x - exon_edge - 1 > 0:
                new_tmp.append([3, x - exon_edge - 1])
            new_tmp.append([0, y - x + 1])
            exon_edge = y
        elif start < x <= end <= y:
            if x - exon_edge - 1 > 0:
                new_tmp.append([3, x - exon_edge - 1])
            new_tmp.append([0, end - x + 1])
            break
    # coalesce equal neighbours
    merged = []
    for t, n in new_tmp:
        if merged and merged[-1][0] == t:
            merged[-1][1] += n
        else:
            merged.append([t, n])
    new_cigar = []
    it2 = iter(merged)
    block = next(it2)
    for ctype, num in old_cigar:
        try:
            if block[0] == 3:
                new_cigar.append((block[0], block[1]))
                block = next(it2)
            if ctype == 0:  # M
                if num < block[1]:
                    new_cigar.append((0, num))
                    block[1] -= num
                elif num == block[1]:
                    new_cigar.append((0, num))
                    block = next(it2)
                    if block[0] == 3:
                        new_cigar.append((block[0], block[1]))
                        block = next(it2)
                else:
                    while num > block[1]:
                        new_cigar.append((0, block[1]))
                        num -= block[1]
                        block = next(it2)
                        new_cigar.append((block[0], block[1]))
                        block = next(it2)
                    if num == block[1]:
                        new_cigar.append((0, num))
                        block = next(it2)
                    elif num < block[1]:
                        block[1] -= num
                        new_cigar.append((0, num))
            elif ctype == 1:  # I
                new_cigar.append((1, num))
            elif ctype == 2:  # D
                if num < block[1]:
                    new_cigar.append((2, num))
                    block[1] -= num
                elif num == block[1]:
                    new_cigar.append((2, num))
                    block = next(it2)
                    if block[0] == 3:
                        new_cigar.append((block[0], block[1]))
                        block = next(it2)
                else:
                    while num > block[1]:
                        new_cigar.append((2, block[1]))
                        num -= block[1]
                        block = next(it2)
                        new_cigar.append((block[0], block[1]))
                        block = next(it2)
                    if num == block[1]:
                        new_cigar.append((2, num))
                        block = next(it2)
                    elif num < block[1]:
                        block[1] -= num
                        new_cigar.append((2, num))
            else:
                new_cigar.append((ctype, num))
        except StopIteration:
            continue
    return new_cigar


_ZS_FLIP = {"++": "-+", "+-": "--", "-+": "++", "--": "+-"}


def _ref_span(cig) -> int:
    return sum(n for op, n in cig if op in (0, 2, 3, 7, 8))


def lift_record(fields: List[str], gtf: Dict[str, dict],
                genome_chrs: set) -> Optional[List[str]]:
    """map_to_genome (basalkit_functions.py:567-687) on SAM-text fields.
    Returns lifted fields or None (unliftable)."""
    rname = fields[2].split("|")[0] if "|" in fields[2] else fields[2]
    info = gtf.get(rname)
    if not info or info["chr"] not in genome_chrs:
        return None
    trans_dir = info["strand"]
    old_start = int(fields[3]) - 1
    cig = parse_cigar_tuples(fields[5])
    old_end = old_start + _ref_span(cig) - 1
    exons0 = OrderedDict(((k[0] - 1, k[1] - 1), (v[0] - 1, v[1] - 1))
                         for k, v in info["exons"].items())
    items = list(exons0.items())
    if trans_dir == "-":
        items = items[::-1]
    len_transcript = max(max(k) for k, _ in items)
    if old_end > len_transcript:
        return None
    new_start = new_end = None
    for (s, e), (gs, ge) in items:
        if trans_dir == "+":
            if s <= old_start <= e:
                new_start = gs + old_start - s
            if s <= old_end <= e:
                new_end = gs + old_end - s
        else:
            gs2 = ge
            if s <= old_end <= e:
                new_end = gs2 + (e - old_end)
            if s <= old_start <= e:
                new_start = gs2 + (e - old_start)
    if new_start is None or new_end is None:
        return None
    try:
        new_cigar = generate_new_cigar(list(exons0.values()), new_start,
                                       new_end, cig, trans_dir)
    except ValueError:
        return None

    flag = int(fields[1])
    seq, qual = fields[9], fields[10]
    tags = fields[11:]
    if trans_dir == "-":
        new_start, new_end = new_end, new_start
        seq = reverse_complement(seq) if seq != "*" else seq
        qual = qual[::-1]
        flag ^= 0x10
        new_tags = []
        for t in tags:
            if t.startswith("ZS:Z:"):
                new_tags.append("ZS:Z:" + _ZS_FLIP.get(t[5:7], t[5:7]))
            elif t.startswith("XR:Z:"):
                xr = reverse_complement(t[5:].upper())
                new_tags.append("XR:Z:" + xr[:2].lower() + xr[2:-2]
                                + xr[-2:].lower())
            else:
                new_tags.append(t)
        tags = new_tags
    tags.append(f"TN:Z:{fields[2]}")
    out = list(fields)
    out[1] = str(flag)
    out[2] = info["chr"]
    out[3] = str(new_start + 1)
    out[5] = cigar_str(new_cigar)
    out[6], out[7], out[8] = "*", "0", "0"
    out[9], out[10] = seq, qual
    return out[:11] + tags


def merge_bam(trans_bam: str, genome_bam: str, gtf_path: str,
              output_prefix: str, unlift: bool = False):
    from .bamio import BamWriter, decode_bam_to_sam

    gtf = read_gtf(gtf_path)
    disp("gtf loaded")

    genome_sam = decode_bam_to_sam(genome_bam).splitlines()
    genome_sq = [l for l in genome_sam if l.startswith("@SQ")]
    genome_chrs = {dict(f.split(":", 1) for f in l.split("\t")[1:])["SN"]
                   for l in genome_sq}

    trans_sam = decode_bam_to_sam(trans_bam).splitlines()
    header = ["@HD\tVN:1.0"] + genome_sq

    lifted: List[str] = []
    unlifted: List[str] = []
    for line in trans_sam:
        if line.startswith("@"):
            continue
        fields = line.split("\t")
        out = lift_record(fields, gtf, genome_chrs)
        if out is not None:
            lifted.append("\t".join(out))
        elif unlift:
            unlifted.append(line)
    disp("merging transcriptome and genome BAM")

    if unlift:
        un_path = trans_bam.replace(".bam", ".unlift.bam")
        with BamWriter(un_path) as bw:
            bw.write("\n".join([l for l in trans_sam if l.startswith("@")]
                               + unlifted) + "\n")

    # merged records with mate fields cleared (merge_bam,
    # basalkit_functions.py:703-709), then coordinate-sort + write
    def clear_mate(line: str) -> str:
        f = line.split("\t")
        f[6], f[7] = "*", "0"
        return "\t".join(f)

    records = lifted + [clear_mate(l) for l in genome_sam
                        if l and not l.startswith("@")]
    chr_order = {dict(f.split(":", 1) for f in l.split("\t")[1:])["SN"]: i
                 for i, l in enumerate(genome_sq)}
    records.sort(key=lambda l: (
        chr_order.get(l.split("\t")[2], 1 << 30),
        int(l.split("\t")[3])))
    out_path = output_prefix + ".merge.sorted.bam"
    with BamWriter(out_path) as bw:
        bw.write("\n".join(header + records) + "\n")
    # reference driver sorts AND indexes the merged BAM
    # (basalkit.py:303-321: pysam.sort + pysam.index)
    from .bamindex import build_index
    build_index(out_path)
    disp(f"mergeBAM Finished -> {out_path} (+.bai)")
    return out_path
