"""Cache-blocked fused host path (BASAL_FUSED_CHUNK): chunked encode +
align must be byte-identical to the unchunked fused pass — chunking is
equivalent to running smaller batches, and every cross-read state (sticky
start offsets, stale seed buffers, read indices) carries serially.  Mixed
read lengths exercise the stale-seed-buffer quirk ACROSS chunk
boundaries."""

import random

import numpy as np
import pytest

from basal_jax.config import AlignParams
from basal_jax.index.reference import load_reference
from basal_jax.index.seedindex import build_index
from conftest import make_fastq, make_ref, random_genome

N = 20_000


def _data(tmp_path, mixed):
    rng = random.Random(515 + mixed)
    g = random_genome(rng, 40_000)
    make_ref(tmp_path / "ref.fa", [("chrF", g)])
    reads = []
    for i in range(N):
        L = rng.choice([60, 83, 100, 100]) if mixed else 100
        pos = rng.randrange(0, len(g) - L)
        s = list(g[pos:pos + L])
        for j, c in enumerate(s):
            if c == "A" and rng.random() < 0.5:
                s[j] = "G"
        reads.append((f"r{i}", "".join(s)))
    make_fastq(tmp_path / "reads.fq", reads)
    return g


def _run(tmp_path, chunk, monkeypatch):
    from basal_jax.align.pipeline import SingleEndAligner
    from basal_jax.reads.io import open_reads
    monkeypatch.setenv("BASAL_HOST_EVAL", "1")
    monkeypatch.setenv("BASAL_FUSED_CHUNK", str(chunk))
    p = AlignParams(conversion="A:G", randseed=3, verbose_level=0,
                    out_unmap=True)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    idx = build_index(ref, p)
    al = SingleEndAligner(p, ref, idx)
    rd = open_reads(str(tmp_path / "reads.fq"), p)
    out = []
    while True:
        b = rd.next_batch(N)  # one big batch: chunking happens inside
        if not b:
            break
        out.append(al.align_batch(b))
    rd.close()
    return b"".join(out)


@pytest.mark.parametrize("mixed", [0, 1])
def test_chunked_equals_unchunked(tmp_path, monkeypatch, mixed):
    _data(tmp_path, mixed)
    plain = _run(tmp_path, 0, monkeypatch)       # chunking disabled
    chunked = _run(tmp_path, 4096, monkeypatch)  # 5 chunks (last partial)
    assert plain == chunked
    odd = _run(tmp_path, 7001, monkeypatch)      # non-divisor chunk size
    assert plain == odd
