#!/bin/bash
# Multi-host alignment: shard the k-mer index over N worker processes
# (jax.distributed) and merge their SAM windows.  Each worker holds ONLY
# its k-mer range (RoutedSeedIndex, basal_jax/parallel/multihost.py) and
# fetches foreign-range entries per batch over batched collective rounds;
# the merged output is byte-identical to a single-host run
# (tests/test_multihost.py proves it on every suite run).
#
# On one machine this simulates N hosts with N local processes; on real
# multi-host hardware, start one worker per host with PID = host index and
# point COORD at host 0 (jax.distributed semantics are identical).
#
# Workers start with local_devices: 1, which pins each to jax's CPU backend
# (parallel/multihost.py init_multihost): N workers never contend for a
# GPU, and each aligns on the host path.
#
# Usage: examples/run-multihost.sh REF.fa READS.fq N_READS [NPROCS] [OUT]
#        READS2=mate2.fq examples/run-multihost.sh ...   # paired-end
#        RULE=C:T examples/run-multihost.sh ...          # conversion rule
set -euo pipefail
REF=$1; READS=$2; NREADS=$3; NPROCS=${4:-2}; OUT=${5:-multihost}
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=$(mktemp -d)
PORT=$(python -c "import socket; s=socket.socket(); s.bind(('localhost',0)); print(s.getsockname()[1]); s.close()")

python - "$REF" "$READS" "$NREADS" "$WORK" "${READS2:-}" "${RULE:-A:G}" <<'EOF'
import json, sys
ref, reads, n, work, reads2, rule = (sys.argv[1], sys.argv[2],
                                     int(sys.argv[3]), sys.argv[4],
                                     sys.argv[5], sys.argv[6])
cfg = {"params": {"conversion": rule, "randseed": 1, "out_unmap": True,
                  "verbose_level": 0},
       "ref": ref, "reads": reads, "n_reads": n,
       "mesh_check": False, "local_devices": 1}
if reads2:
    cfg["reads_b"] = reads2
open(f"{work}/mh_cfg.json", "w").write(json.dumps(cfg))
EOF

pids=()
for ((p = 0; p < NPROCS; p++)); do
  python "$REPO/tools/multihost_worker.py" "$p" "$NPROCS" "$PORT" "$WORK" &
  pids+=($!)
done
for pid in "${pids[@]}"; do wait "$pid"; done

# numeric order (a glob would sort out_p10 before out_p2)
: > "${OUT}.sam"
for ((p = 0; p < NPROCS; p++)); do
  cat "$WORK/out_p${p}.sam" >> "${OUT}.sam"
done
echo "merged ${OUT}.sam ($(grep -vc '^@' "${OUT}.sam") records)" >&2
rm -rf "$WORK"
