#!/bin/bash
# basal_jax pipeline for eTAM-seq / GLORI (m6A, A>G conversion).
# Self-contained equivalent of the reference recipe
# (basal_pipeline_examples/BASAL-pipeline-eTAM-seq&GLORI.sh) using
# basal_jax's own tools instead of external samtools/sambamba.
set -euo pipefail
CORES=${CORES:-4}
IN=$1; GENOME=$2; TRANSCRIPTOME=$3; GTF=$4; OUT=${5:-sample}

# 2.1 map to genome
python -m basal_jax.cli -p $CORES -a "$IN" -d "$GENOME" \
  -o ${OUT}.map2genome.bam -M A:G -u -S 1

# split aligned / unaligned
python -m basal_jax.toolkit.bamutil view ${OUT}.map2genome.bam -F 0xE04 \
  -o ${OUT}.genomeAlign.unsorted.bam
python -m basal_jax.toolkit.bamutil sort ${OUT}.genomeAlign.unsorted.bam \
  -o ${OUT}.genomeAlign.bam
python -m basal_jax.toolkit.bamutil view ${OUT}.map2genome.bam \
  --include-flags 4 -o ${OUT}.unmap2genome.bam
python -m basal_jax.toolkit.bamutil fastq ${OUT}.unmap2genome.bam \
  -o ${OUT}.unmap2genome.fq.gz

# 2.2 map leftovers to transcriptome
python -m basal_jax.cli -p $CORES -a ${OUT}.unmap2genome.fq.gz \
  -d "$TRANSCRIPTOME" -o ${OUT}.trxptomeAlign.bam -M A:G -S 1

# 2.3 lift + merge
python -m basal_jax.toolkit.cli mergeBAM ${OUT}.trxptomeAlign.bam \
  ${OUT}.genomeAlign.bam "$GTF" -o ${OUT}

# 3.1 per-site modification levels
python -m basal_jax.toolkit.cli avgmod ${OUT}.merge.sorted.bam "$GENOME" \
  -o ${OUT} -M A:G -T RNA

# 3.2 significance vs background (add -c ctrl_AvgMod.tsv for treat/ctrl)
python -m basal_jax.toolkit.cli fdr ${OUT}_AvgMod.tsv -o ${OUT}
