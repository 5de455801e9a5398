#!/bin/bash
# basal_jax pipeline for BID-seq (pseudouridine, T>deletion).
# Equivalent of basal_pipeline_examples/BASAL-pipeline-BID-seq.sh.
set -euo pipefail
CORES=${CORES:-4}
IN=$1; GENOME=$2; TRANSCRIPTOME=$3; GTF=$4; OUT=${5:-sample}

python -m basal_jax.cli -p $CORES -a "$IN" -d "$GENOME" \
  -o ${OUT}.map2genome.bam -M T:- -n 1 -g 3 -R -u -S 1
python -m basal_jax.toolkit.bamutil view ${OUT}.map2genome.bam -F 0xE04 \
  -o ${OUT}.tmp.bam
python -m basal_jax.toolkit.bamutil sort ${OUT}.tmp.bam -o ${OUT}.genomeAlign.bam
python -m basal_jax.toolkit.bamutil view ${OUT}.map2genome.bam \
  --include-flags 4 -o ${OUT}.unmap2genome.bam
python -m basal_jax.toolkit.bamutil fastq ${OUT}.unmap2genome.bam \
  -o ${OUT}.unmap2genome.fq.gz

python -m basal_jax.cli -p $CORES -a ${OUT}.unmap2genome.fq.gz \
  -d "$TRANSCRIPTOME" -o ${OUT}.tmp2.bam -M T:- -n 1 -g 3 -R -S 1
python -m basal_jax.toolkit.bamutil sort ${OUT}.tmp2.bam -o ${OUT}.trxptomeAlign.bam

# CIGAR correction for consecutive pU (requires -R)
python -m basal_jax.toolkit.cli shiftD ${OUT}.genomeAlign.bam -o ${OUT}.gshift
python -m basal_jax.toolkit.bamutil sort ${OUT}.gshift.bam -o ${OUT}.genomeAlign.corrected.bam
python -m basal_jax.toolkit.cli shiftD ${OUT}.trxptomeAlign.bam -o ${OUT}.tshift
python -m basal_jax.toolkit.bamutil sort ${OUT}.tshift.bam -o ${OUT}.trxptomeAlign.corrected.bam

python -m basal_jax.toolkit.cli mergeBAM ${OUT}.trxptomeAlign.corrected.bam \
  ${OUT}.genomeAlign.corrected.bam "$GTF" -o ${OUT}
python -m basal_jax.toolkit.cli avgmod ${OUT}.merge.sorted.bam "$GENOME" \
  -o ${OUT} -M T:- -D M -T RNA -y 7
python -m basal_jax.toolkit.cli fdr ${OUT}_AvgMod.tsv -o ${OUT}
