#!/bin/bash
# basal_jax pipeline for m1A-IP-seq (A>C/G/T multi-way conversion).
# Equivalent of basal_pipeline_examples/BASAL-pipeline-m1A-IP-seq.sh.
set -euo pipefail
CORES=${CORES:-4}
IN=$1; GENOME=$2; TRANSCRIPTOME=$3; GTF=$4; OUT=${5:-sample}

python -m basal_jax.cli -p $CORES -a "$IN" -d "$GENOME" \
  -o ${OUT}.map2genome.bam -M A:CGT -n 1 -u -S 1
python -m basal_jax.toolkit.bamutil view ${OUT}.map2genome.bam -F 0xE04 \
  -o ${OUT}.tmp.bam
python -m basal_jax.toolkit.bamutil sort ${OUT}.tmp.bam -o ${OUT}.genomeAlign.bam
python -m basal_jax.toolkit.bamutil view ${OUT}.map2genome.bam \
  --include-flags 4 -o ${OUT}.unmap2genome.bam

python -m basal_jax.cli -p $CORES -a ${OUT}.unmap2genome.bam \
  -d "$TRANSCRIPTOME" -o ${OUT}.trxptomeAlign.bam -M A:CGT -S 1

python -m basal_jax.toolkit.cli mergeBAM ${OUT}.trxptomeAlign.bam \
  ${OUT}.genomeAlign.bam "$GTF" -o ${OUT}
python -m basal_jax.toolkit.cli avgmod ${OUT}.merge.sorted.bam "$GENOME" \
  -o ${OUT} -M A:G
python -m basal_jax.toolkit.cli fdr ${OUT}_AvgMod.tsv -o ${OUT}
