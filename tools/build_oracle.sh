#!/bin/bash
# Build the reference BASAL binary out-of-tree as a differential-test oracle.
# Sources stay in /root/reference (read-only); objects/binary land here.
set -e
REF=/root/reference
OUT=/root/repo/.oracle
FLAGS="-DMAXHITS=1000 -DTHREAD -funroll-loops -I$REF/samtools -I$REF/gzstream -O3 -m64 -w"
mkdir -p $OUT/obj/samtools $OUT/obj/gzstream
# samtools/libbam objects (only what libbam.a needs)
cd $OUT/obj/samtools
for c in $REF/samtools/*.c; do
  base=$(basename $c .c)
  case $base in main|bamtk|*_test*|chk_indel|wgsim|md5fa|md5|maq2sam|bgzip|razip|calDepth|vcf-miniview|bam2bcf*|errmod|kprobaln|bam_mcns|sample|sam_view|bam_plcmd|bam_*|sam_header|sam|faidx|razf|knetfile|kstring|bgzf|bam|bedidx|kaln|kprobaln|errmod) ;; esac
done
# simpler: mirror samtools makefile LOBJS
LOBJS="bgzf kstring bam_aux bam bam_import sam bam_index bam_pileup bam_lpileup bam_md razf faidx bedidx knetfile bam_sort sam_header bam_reheader kprobaln bam_cat"
for o in $LOBJS; do
  gcc -c -g -O2 -Wall -w -D_FILE_OFFSET_BITS=64 -D_LARGEFILE64_SOURCE -D_USE_KNETFILE -DBGZF_CACHE -I$REF/samtools $REF/samtools/$o.c -o $o.o
done
ar -csru libbam.a *.o
cd $OUT/obj/gzstream
g++ -O3 -I$REF/gzstream -c $REF/gzstream/gzstream.C -o gzstream.o
ar -csru libgzstream.a gzstream.o
cd $OUT/obj
for s in align refbase main pairs param reads utilities; do
  g++ $FLAGS -c $REF/$s.cpp -o $s.o
done
g++ $FLAGS align.o refbase.o main.o pairs.o param.o reads.o utilities.o -o $OUT/basal -lpthread -L$OUT/obj/samtools -lbam -L$OUT/obj/gzstream -lgzstream -lz
echo "oracle built: $OUT/basal"
# vendored samtools binary: independent validator for our BAM/.bai writers
# (tests/test_bamindex.py must never skip when the reference is present)
bash "$(dirname "$0")/build_samtools.sh"
