"""Threaded bt_format_se (order-stitched per-thread sinks) must be
byte-identical to the serial pass — same SAM bytes, same counters — for
every output shape: unique hits, -r 1 random repeat picks (the per-read
myrand hash), -r 2 multi-hit fan-out, -u unmapped records, and -R XR
reference context.  Mirrors the reference's s_OutHit* emission
(align.cpp:590-660) exercised through our fused host path."""

import random

import numpy as np
import pytest

from conftest import make_ref, make_fastq, random_genome, convert_reads

from basal_jax.config import AlignParams
from basal_jax.index.reference import load_reference
from basal_jax.index.seedindex import build_index
from basal_jax.align.pipeline import SingleEndAligner
from basal_jax.reads.encode import encode_batch
from basal_jax.reads.io import open_reads, RawBatch


@pytest.mark.parametrize("rr,out_ref,out_unmap", [
    (1, False, False),
    (1, True, True),
    (2, False, True),
    (0, False, True),
])
def test_format_se_threaded_bitexact(tmp_path, rr, out_ref, out_unmap):
    from basal_jax.native import get_lib, NativeFormatter
    if get_lib() is None:
        pytest.skip("native engine unavailable")
    rng = random.Random(1234 + rr)
    core = random_genome(rng, 120_000)
    # duplicated block => genuine multi-hits for the -r 2 fan-out
    genome = core + core[:40_000]
    ref_fa = tmp_path / "ref.fa"
    make_ref(ref_fa, [("chr1", genome)])
    reads = convert_reads(rng, genome, 6000, 100, "C:T",
                          revcomp_frac=0.4, sub_rate=0.02)
    # a few garbage reads that stay unmapped
    reads += [(f"un{i}", "".join(rng.choice("ACGT") for _ in range(100)))
              for i in range(64)]
    rng.shuffle(reads)
    fq = tmp_path / "r.fq"
    make_fastq(fq, reads)

    p = AlignParams(conversion="C:T", randseed=7, report_repeat_hits=rr,
                    out_ref=out_ref, out_unmap=out_unmap, verbose_level=0)
    ref = load_reference(str(ref_fa), p)
    idx = build_index(ref, p)
    al = SingleEndAligner(p, ref, idx)
    rd = open_reads(str(fq), p)
    b = rd.next_batch(8192)
    rd.close()
    assert len(b) > 4096  # must cross the threaded-path threshold
    enc = encode_batch(p, b)
    ridx = (enc.reads.indices if isinstance(enc.reads, RawBatch)
            else np.array([r.index for r in enc.reads], dtype=np.uint32))
    res, _, _ = al.native.align_se_host(enc, ridx, ref, n_threads=0)

    f_ser = NativeFormatter(p, ref)
    out_ser = f_ser.format(enc, res, n_threads=1)
    for nt in (2, 4, 7):
        f_thr = NativeFormatter(p, ref)
        out_thr = f_thr.format(enc, res, n_threads=nt)
        assert out_thr == out_ser, nt
        assert np.array_equal(f_thr.counters, f_ser.counters), nt
    assert f_ser.counters[0] > 0  # the batch actually aligned something
    if rr == 2:
        # multi-hit fan-out really occurred (duplicated block)
        assert int(f_ser.counters[2]) > 0


def test_format_pe_threaded_bitexact(tmp_path, monkeypatch):
    """Full PE CLI run with the formatter forced serial vs threaded must be
    byte-identical (proper pairs, -r 2 fan-out, orphans, unmapped mates)."""
    from basal_jax import native as N
    if N.get_lib() is None:
        pytest.skip("native engine unavailable")
    from test_differential_pe import pe_reads
    from test_differential_se import run_ours

    rng = random.Random(77)
    core = random_genome(rng, 150_000)
    genome = core + core[:50_000]
    make_ref(tmp_path / "ref.fa", [("chrP", genome)])
    r1, r2 = pe_reads(rng, genome, 5000, 100, rule="C:T", orphan_frac=0.15)
    make_fastq(tmp_path / "r1.fq", r1)
    make_fastq(tmp_path / "r2.fq", r2)
    args = ["-a", "r1.fq", "-b", "r2.fq", "-d", "ref.fa", "-M", "C:T",
            "-S", "5", "-V", "0", "-r", "2", "-u"]

    out_thr = run_ours(args, tmp_path)

    orig = N.NativePairFormatter.format

    def serial_format(self, *a, **kw):
        kw["n_threads"] = 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(N.NativePairFormatter, "format", serial_format)
    out_ser = run_ours(args, tmp_path)
    assert out_thr == out_ser
