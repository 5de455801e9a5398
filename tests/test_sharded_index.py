"""K-mer-range sharded index: placement invariance (SURVEY §2.4) — the
gathered sharded index must be bit-identical to the single-host build, and
the aligned SAM output must be identical."""

import numpy as np

from conftest import convert_reads, make_fastq, make_ref, random_genome


def test_sharded_equals_dense(tmp_path, rng):
    from basal_jax.config import AlignParams
    from basal_jax.index.reference import load_reference
    from basal_jax.index.seedindex import build_index
    from basal_jax.index.sharded import build_sharded_index

    g = random_genome(rng, 20000)
    make_ref(tmp_path / "ref.fa", [("c1", g[:12000]), ("c2", g[12000:])])
    p = AlignParams(conversion="A:G", randseed=1)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    dense = build_index(ref, p)
    for n_shards in (1, 3, 8):
        sharded = build_sharded_index(ref, p, n_shards)
        gathered = sharded.gather()
        assert np.array_equal(gathered.counts, dense.counts)
        assert np.array_equal(gathered.n1, dense.n1)
        assert np.array_equal(gathered.locs, dense.locs)
        nz = np.flatnonzero(dense.counts)
        assert np.array_equal(gathered.starts[nz], dense.starts[nz])
        assert gathered.max_kmer_num == dense.max_kmer_num
        # routing lookups agree with the dense CSR
        for k in nz[:: max(1, len(nz) // 50)]:
            locs, n1, m = sharded.lookup(int(k))
            lo = int(dense.starts[k])
            assert m == dense.counts[k] and n1 == dense.n1[k]
            assert np.array_equal(locs, dense.locs[lo:lo + m])


def test_sharded_sam_identical(tmp_path, rng):
    from basal_jax.config import AlignParams
    from basal_jax.index.reference import load_reference
    from basal_jax.index.seedindex import build_index
    from basal_jax.index.sharded import build_sharded_index
    from basal_jax.align.pipeline import SingleEndAligner
    from basal_jax.reads.io import open_reads

    g = random_genome(rng, 10000)
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    reads = convert_reads(rng, g, 60, 90, "A:G", revcomp_frac=0.4)
    make_fastq(tmp_path / "reads.fq", reads)
    p = AlignParams(conversion="A:G", randseed=3)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    outs = []
    for idx in (build_index(ref, p), build_sharded_index(ref, p, 4).gather()):
        al = SingleEndAligner(p, ref, idx)
        rd = open_reads(str(tmp_path / "reads.fq"), p)
        outs.append(al.align_batch(rd.next_batch()))
    assert outs[0] == outs[1]


def test_kmer_cutoff_dense_matches_sparse():
    """_kmer_cutoff_dense (C++ top-K fast path AND the numpy partition
    fallback) must equal the sparse golden _kmer_cutoff for default and
    exotic -k ratios, including all-zero and rank-beyond-64 cases."""
    import dataclasses

    import numpy as np

    from basal_jax.config import AlignParams
    from basal_jax.index.seedindex import _kmer_cutoff, _kmer_cutoff_dense

    rng = np.random.default_rng(99)
    p0 = AlignParams(conversion="A:G", randseed=1)
    nk = p0.total_kmers
    counts = np.zeros(nk, np.int32)
    nz = rng.integers(0, nk, 3_000_000)
    counts[nz] = rng.integers(1, 5000, nz.size).astype(np.int32)
    counts[nk - 1] = 1234  # last slot: excluded-from-sort quirk

    def sparse(p):
        uk = np.flatnonzero(counts).astype(np.int64)
        return _kmer_cutoff(p, uk, counts[uk].astype(np.int64))

    for ratio in (p0.max_kmer_ratio, 5e-7, 1e-5, 1e-3, 0.01, 0.9):
        p = dataclasses.replace(p0, max_kmer_ratio=ratio)
        assert _kmer_cutoff_dense(p, counts) == sparse(p), ratio

    zero = np.zeros(nk, np.int32)
    for ratio in (5e-7, 0.01):
        p = dataclasses.replace(p0, max_kmer_ratio=ratio)
        assert _kmer_cutoff_dense(p, zero) == 0
