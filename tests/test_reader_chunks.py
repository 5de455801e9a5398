"""RawFastqReader chunk-boundary unit tests: the background-prefetch scanner
(reads/io.py) must produce identical batches regardless of chunk size —
including -B/-E skip windows that span several chunks and records split
across chunk boundaries (the carry path)."""

import numpy as np
import pytest

from basal_jax.config import AlignParams
from basal_jax.reads.io import RawFastqReader


def _write_fastq(path, n, readlen=60):
    rng = np.random.default_rng(42)
    nt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i in range(n):
            seq = nt[rng.integers(0, 4, readlen)].tobytes()
            f.write(b"@read_%06d extra words\n" % i + seq + b"\n+\n"
                    + b"I" * readlen + b"\n")


def _drain(path, params, batch=97):
    r = RawFastqReader(str(path), params)
    names, seqs, idx = [], [], []
    while True:
        b = r.next_batch(batch)
        if not b:
            break
        for i in range(len(b)):
            rec = b[i]
            names.append(rec.name)
            seqs.append(rec.seq)
            idx.append(rec.index)
    r.close()
    return names, seqs, idx


@pytest.mark.parametrize("chunk", [1 << 10, 4 << 10, 16 << 20])
def test_chunk_size_invariance(tmp_path, chunk, monkeypatch):
    """Tiny chunks force records to split across chunk boundaries and the
    prefetch carry logic to run many times; output must equal one-chunk."""
    fq = tmp_path / "r.fq"
    _write_fastq(fq, 403)
    monkeypatch.setattr(RawFastqReader, "CHUNK", chunk)
    got = _drain(fq, AlignParams(conversion="C:T"))
    monkeypatch.setattr(RawFastqReader, "CHUNK", 64 << 20)
    want = _drain(fq, AlignParams(conversion="C:T"))
    assert got == want
    assert len(got[0]) == 403
    assert got[0][0] == "read_000000" and got[0][-1] == "read_000402"


@pytest.mark.parametrize("chunk", [1 << 10, 16 << 20])
def test_skip_spans_chunks(tmp_path, chunk, monkeypatch):
    """-B/-E window whose skipped prefix covers several 1 KB chunks."""
    fq = tmp_path / "r.fq"
    _write_fastq(fq, 400)
    monkeypatch.setattr(RawFastqReader, "CHUNK", chunk)
    p = AlignParams(conversion="C:T", read_start=151, read_end=260)
    names, seqs, idx = _drain(fq, p, batch=13)
    assert len(names) == 110
    assert names[0] == "read_000150" and names[-1] == "read_000259"
    assert idx[0] == 150 and idx[-1] == 259
