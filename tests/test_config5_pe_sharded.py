"""BASELINE.md config 5: paired-end, BAM input AND output, multi-sequence
transcriptome-style reference, k-mer-range-sharded index (2 shards) — the
sharded build must reproduce the dense-index PE output exactly, and the
whole path must round-trip through our BAM codec."""

import numpy as np

from conftest import make_ref, random_genome
from test_differential_pe import pe_reads


def test_config5(tmp_path, rng):
    from basal_jax.config import AlignParams
    from basal_jax.index.reference import load_reference
    from basal_jax.index.seedindex import build_index
    from basal_jax.index.sharded import build_sharded_index
    from basal_jax.pairs.pipeline import PairEndAligner
    from basal_jax.reads.io import open_reads
    from basal_jax.toolkit.bamio import BamWriter, decode_bam_to_sam
    from basal_jax.align.sam import sam_header

    # "transcriptome": many short sequences
    seqs = [(f"ENST{i:08d}", random_genome(rng, rng.randrange(500, 2500)))
            for i in range(30)]
    make_ref(tmp_path / "tx.fa", seqs)
    cat = "".join(s for _, s in seqs)
    r1, r2 = pe_reads(rng, cat, 60, 80, rule="A:G", min_ins=120, max_ins=300,
                      orphan_frac=0.1)

    # PE BAM input (interleaved records like the reference expects)
    with BamWriter(str(tmp_path / "reads.bam")) as bw:
        bw.write("@HD\tVN:1.0\n")
        for (n1, s1), (n2, s2) in zip(r1, r2):
            bw.write(f"{n1}\t77\t*\t0\t0\t*\t*\t0\t0\t{s1}\t{'I' * len(s1)}\n")
            bw.write(f"{n2}\t141\t*\t0\t0\t*\t*\t0\t0\t{s2}\t{'I' * len(s2)}\n")

    p = AlignParams(conversion="A:G", randseed=5, pairend=True, out_unmap=True)
    ref = load_reference(str(tmp_path / "tx.fa"), p)

    outs = []
    for index in (build_index(ref, p),
                  build_sharded_index(ref, p, 2).gather()):
        al = PairEndAligner(p, ref, index)
        rd_a = open_reads(str(tmp_path / "reads.bam"), p, readset=1)
        rd_b = open_reads(str(tmp_path / "reads.bam"), p, readset=2)
        a = rd_a.next_batch()
        b = rd_b.next_batch()
        assert len(a) == len(b) == 60
        text = (sam_header(ref, p, "cfg5")
                + al.align_batch(a, b).decode("latin1"))
        outs.append(text)
    assert outs[0] == outs[1], "sharded-index PE output differs from dense"

    # BAM output round-trip
    with BamWriter(str(tmp_path / "out.bam")) as bw:
        bw.write(outs[0])
    back = decode_bam_to_sam(str(tmp_path / "out.bam"))
    want = [l for l in outs[0].splitlines() if not l.startswith("@")]
    got = [l for l in back.splitlines() if l and not l.startswith("@")]
    assert got == want
    # sanity: proper pairs present
    flags = [int(l.split("\t")[1]) for l in want]
    assert sum(1 for f in flags if f & 0x2) > 60
