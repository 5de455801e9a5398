"""End-to-end pipeline test: the eTAM/GLORI recipe (examples/
pipeline-eTAM-GLORI.sh) on tiny synthetic data — genome+transcriptome
mapping, bamutil view/sort/fastq, mergeBAM liftover, avgmod, fdr."""

import gzip
import os
import subprocess
import sys
from pathlib import Path

from conftest import make_ref, random_genome


def sh(args, cwd):
    return subprocess.run(["bash"] + [str(a) for a in args], cwd=cwd, capture_output=True,
                          text=True, timeout=900,
                          env={**os.environ, "JAX_PLATFORMS": "cpu",
                               "PYTHONPATH": str(Path(__file__).resolve().parents[1]),
                               "CORES": "2"})


def test_etam_pipeline(tmp_path, rng):
    genome = random_genome(rng, 12000)
    make_ref(tmp_path / "genome.fa", [("chr1", genome)])
    # transcriptome: one 2-exon transcript on chr1
    e1, e2 = (2001, 2400), (3001, 3400)
    tx = genome[e1[0] - 1:e1[1]] + genome[e2[0] - 1:e2[1]]
    make_ref(tmp_path / "tx.fa", [("t1", tx)])
    with open(tmp_path / "ann.gtf", "w") as f:
        for a, b in (e1, e2):
            f.write(f'chr1\tx\texon\t{a}\t{b}\t.\t+\t.\tgene_id "g1"; '
                    f'transcript_id "t1"; exon_number "1";\n')

    reads = []
    # genomic reads with A->G conversions
    for i in range(60):
        pos = rng.randrange(0, len(genome) - 80)
        s = "".join("G" if (c == "A" and rng.random() < 0.5) else c
                    for c in genome[pos:pos + 80])
        reads.append((f"g{i}", s))
    # junction-spanning transcript reads (unmappable to genome contiguously)
    for i in range(40):
        pos = rng.randrange(320, 420)
        s = "".join("G" if (c == "A" and rng.random() < 0.5) else c
                    for c in tx[pos:pos + 80])
        reads.append((f"t{i}", s))
    with gzip.open(tmp_path / "reads.fq.gz", "wt") as f:
        for n, s in reads:
            f.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")

    script = Path(__file__).resolve().parents[1] / "examples" / \
        "pipeline-eTAM-GLORI.sh"
    r = sh([script, "reads.fq.gz", "genome.fa", "tx.fa", "ann.gtf", "smp"],
           tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]

    from basal_jax.toolkit.bamio import decode_bam_to_sam
    merged = decode_bam_to_sam(str(tmp_path / "smp.merge.sorted.bam"))
    recs = [l.split("\t") for l in merged.splitlines()
            if l and not l.startswith("@")]
    # junction reads lifted with N-gapped CIGARs onto chr1
    lifted = [f for f in recs if f[0].startswith("t") and "N" in f[5]]
    assert len(lifted) > 10, f"few lifted junction reads: {len(lifted)}"
    assert all(f[2] == "chr1" for f in recs)

    avg = (tmp_path / "smp_AvgMod.tsv").read_text().splitlines()
    assert avg[0].startswith("chr\tpos")
    assert len(avg) > 20
    assert (tmp_path / "smp_FDR.tsv.gz").exists()


