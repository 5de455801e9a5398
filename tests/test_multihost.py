"""Multi-host (jax.distributed, 2 local processes) differential tests.

SURVEY §4: multi-host behavior is validated via JAX multi-process CPU
simulation — the merged sharded output must equal the single-process output
bit-for-bit.  The workers (tools/multihost_worker.py) build shard-resident
k-mer-range seed indexes (no ``gather()``), route per-batch lookups over
the cross-process collective backend, align disjoint read windows through
the production SE pipeline, and prove the rs-spanning extension mesh equal
to the single-device kernel.
"""

import json
import os
import subprocess
import sys
import socket
from pathlib import Path

import numpy as np
import pytest

from conftest import convert_reads, make_fastq, make_ref, random_genome

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tools" / "multihost_worker.py"


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(nprocs, port, workdir, timeout=600):
    procs = []
    env = dict(os.environ)
    # workers set their own platform/device flags in init_multihost
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    for pid in range(nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), str(nprocs), str(port),
             str(workdir)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:\n{out}\nstderr:\n{err}"
    return outs


def _fixture(tmp_path, rng, n_reads, genome_bp=250_000, readlen=100):
    head = random_genome(rng, genome_bp // 2)
    rep = random_genome(rng, 271) * 10
    tail = random_genome(rng, genome_bp // 2)
    ref_txt = head + rep + tail
    make_ref(tmp_path / "ref.fa", [("chr1", ref_txt)])
    reads = convert_reads(rng, ref_txt, n_reads, readlen, rule="A:G",
                          revcomp_frac=0.5, sub_rate=0.01)
    make_fastq(tmp_path / "reads.fq", reads)
    return ref_txt


def _single_process_sam(tmp_path, params_kw):
    """Reference output: the normal in-process single-host run (dense
    index, same params)."""
    from basal_jax.align.pipeline import run_single_end
    from basal_jax.config import AlignParams
    import io

    params = AlignParams(**params_kw)
    buf = io.BytesIO()
    run_single_end(params, str(tmp_path / "ref.fa"),
                   str(tmp_path / "reads.fq"), out_fh=buf,
                   command_line="basal-jax")
    return buf.getvalue().decode("latin1")


def test_two_process_routed_equals_single(tmp_path, rng):
    """2-process run: sharded index + routed lookups + disjoint read
    windows; concatenated SAM == single-process SAM byte-for-byte.
    Read/batch counts are deliberately uneven (2699 reads, 1349/batch) so
    process 1 finishes first and must serve process 0's remaining routing
    rounds through the drain protocol."""
    n_reads = 2699
    _fixture(tmp_path, rng, n_reads)
    params_kw = dict(conversion="A:G", randseed=7, batch_reads=1349,
                     out_unmap=True, verbose_level=0)
    cfg = {"params": params_kw, "ref": str(tmp_path / "ref.fa"),
           "reads": str(tmp_path / "reads.fq"), "n_reads": n_reads,
           "mesh_check": True, "local_devices": 2}
    (tmp_path / "mh_cfg.json").write_text(json.dumps(cfg))

    _spawn(2, _free_port(), tmp_path)

    merged = ((tmp_path / "out_p0.sam").read_text()
              + (tmp_path / "out_p1.sam").read_text())
    single = _single_process_sam(tmp_path, params_kw)
    assert merged == single

    st0 = json.loads((tmp_path / "stats_p0.json").read_text())
    st1 = json.loads((tmp_path / "stats_p1.json").read_text())
    # shard-resident: each process held only ~half the k-mer space
    total_k = st0["local_shard_kmers"] + st1["local_shard_kmers"]
    assert st0["local_shard_kmers"] < total_k
    assert st1["local_shard_kmers"] < total_k
    # routing actually exchanged queries and positions over the backend
    assert st0["exchanged_queries"] > 0
    assert st0["exchanged_locs"] > 0
    # uneven windows: p0 had one more batch round; drain kept them paired
    assert st0["reads"] == 1350 and st1["reads"] == 1349
    # the rs-spanning mesh produced bit-identical extension results
    assert st0["mesh"]["ok"] and st1["mesh"]["ok"]
    assert st0["mesh"]["rs_span_processes"] == 2
    assert st0["mesh"]["candidates"] > 1000


def test_three_process_routed_equals_single(tmp_path, rng):
    """3 processes: k-mer space split into three UNEVEN ranges (4^16 not
    divisible by 3) and read windows 900/900/899 — exercises partition
    rounding, multi-peer routing rounds (each query may hit two foreign
    shards), and a drain where two peers finish before the last."""
    n_reads = 2699
    _fixture(tmp_path, rng, n_reads, genome_bp=150_000)
    params_kw = dict(conversion="A:G", randseed=11, batch_reads=450,
                     out_unmap=True, verbose_level=0)
    cfg = {"params": params_kw, "ref": str(tmp_path / "ref.fa"),
           "reads": str(tmp_path / "reads.fq"), "n_reads": n_reads,
           "mesh_check": False, "local_devices": 1}
    (tmp_path / "mh_cfg.json").write_text(json.dumps(cfg))

    _spawn(3, _free_port(), tmp_path)

    merged = "".join((tmp_path / f"out_p{i}.sam").read_text()
                     for i in range(3))
    single = _single_process_sam(tmp_path, params_kw)
    assert merged == single

    stats = [json.loads((tmp_path / f"stats_p{i}.json").read_text())
             for i in range(3)]
    total_k = sum(s["local_shard_kmers"] for s in stats)
    for s in stats:
        assert 0 < s["local_shard_kmers"] < total_k
    assert [s["reads"] for s in stats] == [900, 900, 899]
    assert sum(s["exchanged_queries"] for s in stats) > 0


def test_two_process_pair_end_equals_single(tmp_path, rng):
    """PE across 2 processes: both mates' per-batch lookups ride the routed
    index (two ensure_batch rounds per batch); merged SAM == single-process
    PE SAM byte-for-byte."""
    n_pairs = 1501
    genome = random_genome(rng, 200_000)
    make_ref(tmp_path / "ref.fa", [("chr1", genome)])
    comp = str.maketrans("ACGT", "TGCA")
    ra, rb = [], []
    for i in range(n_pairs):
        pos = rng.randrange(0, len(genome) - 400)
        ins = rng.randrange(150, 380)
        a = list(genome[pos:pos + 100])
        b = list(genome[pos + ins - 100:pos + ins].translate(comp)[::-1])
        for s in (a, b):
            for j, c in enumerate(s):
                if c == "A" and rng.random() < 0.5:
                    s[j] = "G"
        ra.append((f"p{i}/1", "".join(a)))
        rb.append((f"p{i}/2", "".join(b)))
    make_fastq(tmp_path / "reads_1.fq", ra)
    make_fastq(tmp_path / "reads_2.fq", rb)

    params_kw = dict(conversion="A:G", randseed=5, batch_reads=751,
                     out_unmap=True, verbose_level=0, pairend=True)
    cfg = {"params": params_kw, "ref": str(tmp_path / "ref.fa"),
           "reads": str(tmp_path / "reads_1.fq"),
           "reads_b": str(tmp_path / "reads_2.fq"), "n_reads": n_pairs,
           "mesh_check": False, "local_devices": 2}
    (tmp_path / "mh_cfg.json").write_text(json.dumps(cfg))

    _spawn(2, _free_port(), tmp_path)

    merged = ((tmp_path / "out_p0.sam").read_text()
              + (tmp_path / "out_p1.sam").read_text())

    from basal_jax.pairs.pipeline import run_pair_end
    from basal_jax.config import AlignParams
    import io
    buf = io.BytesIO()
    run_pair_end(AlignParams(**params_kw), str(tmp_path / "ref.fa"),
                 str(tmp_path / "reads_1.fq"), str(tmp_path / "reads_2.fq"),
                 out_fh=buf, command_line="basal-jax")
    assert merged == buf.getvalue().decode("latin1")

    st0 = json.loads((tmp_path / "stats_p0.json").read_text())
    assert st0["exchanged_queries"] > 0 and st0["exchanged_locs"] > 0


def test_routed_index_matches_dense_single_process(tmp_path, rng):
    """RoutedSeedIndex in 1-process mode must fill entries value-identical
    to the dense index for every queried k-mer (fast in-process check of
    the CSR slice/fill machinery, no subprocess spawn)."""
    from basal_jax.config import AlignParams
    from basal_jax.index.reference import load_reference
    from basal_jax.index.seedindex import build_index
    from basal_jax.parallel.multihost import RoutedSeedIndex
    from basal_jax.reads.encode import encode_batch
    from basal_jax.reads.io import open_reads

    _fixture(tmp_path, rng, 400, genome_bp=120_000)
    p = AlignParams(conversion="A:G", randseed=7)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    dense = build_index(ref, p)
    routed = RoutedSeedIndex(ref, p, num_shards=1, shard_id=0)
    assert routed.max_kmer_num == dense.max_kmer_num

    rd = open_reads(str(tmp_path / "reads.fq"), p)
    batch = rd.next_batch()
    rd.close()
    enc = encode_batch(p, batch)
    routed.ensure_batch(enc)

    q = enc.seedval.reshape(-1)
    q = np.unique(q[q < p.total_kmers])
    np.testing.assert_array_equal(routed.counts[q], dense.counts[q])
    np.testing.assert_array_equal(routed.n1[q], dense.n1[q])
    for k in q[dense.counts[q] > 0][:500]:
        ds = dense.locs[dense.starts[k]:dense.starts[k] + dense.counts[k]]
        rs = routed.locs[routed.starts[k]:routed.starts[k] + routed.counts[k]]
        np.testing.assert_array_equal(rs, ds, err_msg=f"kmer {k}")
