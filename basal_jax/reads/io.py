"""Read input: FASTA / FASTQ (plain or gzip) and SAM/BAM batch readers.

Equivalent of ``ReadClass`` (reads.{h,cpp}): batches of up to 50,000 reads,
-B/-E read-range windowing (reads.cpp:19-39), hard clip to -L
(reads.cpp:63-65), FASTA reads get constant quality
``chr(zero_qual + default_qual)`` (reads.cpp:62).

Like the reference's ``fin>>p->seq`` token reads, sequence and quality are
single whitespace-delimited tokens (multi-line FASTQ records are not a thing
in practice; the reference would mis-parse them identically).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import struct
from typing import Iterator, List, Optional

from ..config import AlignParams


@dataclasses.dataclass
class ReadRec:
    index: int          # global 0-based read index (myrand input; reads.cpp:56)
    readset: int        # 0 SE, 1/2 PE mate (align.cpp:83-84)
    name: str
    seq: str
    qual: str


class RawBatch:
    """Zero-string read batch: name/seq/qual live as (offset, length)
    slices into one shared byte buffer (the raw FASTQ chunk).  The hot
    native path (encode -> schedule -> eval -> format) consumes the
    buffers directly; slow paths materialize ReadRec lazily via rec(i).

    Replaces the per-read Python object churn of List[ReadRec]
    on the reference's batch-loading path
    (reads.cpp:42-82)."""

    __slots__ = ("buf", "name_off", "name_len", "seq_off", "seq_len",
                 "qual_off", "qual_len", "index0", "readset")

    def __init__(self, buf, name_off, name_len, seq_off, seq_len,
                 qual_off, qual_len, index0, readset=0):
        self.buf = buf                  # np.uint8 [n]
        self.name_off = name_off        # int64 [B]
        self.name_len = name_len        # int32 [B]
        self.seq_off = seq_off
        self.seq_len = seq_len
        self.qual_off = qual_off
        self.qual_len = qual_len
        self.index0 = index0            # global index of read 0
        self.readset = readset

    def __len__(self):
        return len(self.name_off)

    @property
    def indices(self):
        import numpy as np
        return (self.index0
                + np.arange(len(self.name_off), dtype=np.uint32))

    def _slice(self, off, ln):
        return self.buf[off:off + ln].tobytes().decode("latin1")

    def rec(self, i: int) -> ReadRec:
        return ReadRec(
            index=self.index0 + i, readset=self.readset,
            name=self._slice(self.name_off[i], self.name_len[i]),
            seq=self._slice(self.seq_off[i], self.seq_len[i]),
            qual=self._slice(self.qual_off[i], self.qual_len[i]))

    def __getitem__(self, i):
        if isinstance(i, slice):
            a, b, step = i.indices(len(self))
            assert step == 1
            return RawBatch(self.buf,
                            self.name_off[a:b], self.name_len[a:b],
                            self.seq_off[a:b], self.seq_len[a:b],
                            self.qual_off[a:b], self.qual_len[a:b],
                            self.index0 + a, self.readset)
        return self.rec(i)

    def __iter__(self):
        for i in range(len(self)):
            yield self.rec(i)

    def to_list(self):
        return [self.rec(i) for i in range(len(self))]


def _open(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.open(path, "rb"))
    return open(path, "rb")


def sniff_format(path: str) -> str:
    """Input format sniffing (check_ifile_format, main.cpp:386-407)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    gz = magic[:2] == b"\x1f\x8b"
    if gz:
        with gzip.open(path, "rb") as g:
            head = g.read(4)
        if head[:1] == b">":
            return "fasta"
        if head[:1] == b"@":
            return "fastq"
        if head == b"BAM\x01":
            return "bam"
        return "sam"
    if magic[:1] == b">":
        return "fasta"
    if magic[:1] == b"@":
        return "fastq"
    return "sam"


class FastxReader:
    """FASTA/FASTQ batch reader with -B/-E windowing.

    Plain (uncompressed) files parse through a chunked numpy newline scan
    instead of a readline loop; gzip falls back to line streaming."""

    CHUNK = 64 << 20

    def __init__(self, path: str, params: AlignParams, readset: int = 0,
                 fmt: Optional[str] = None):
        self.params = params
        self.readset = readset
        self.fmt = fmt or sniff_format(path)
        with open(path, "rb") as f:
            self._plain = f.read(2) != b"\x1f\x8b"
        self.fh = _open(path)
        self.index = params.read_start - 1
        self._lines = []          # queued parsed lines (bytes)
        self._li = 0
        self._carry = b""
        if self._plain:
            skip = (params.read_start - 1) * (2 if self.fmt == "fasta" else 4)
            while skip:
                line = self._next_line()
                if line is None:
                    break
                skip -= 1
        else:
            self._skip_to_start()

    def _refill(self) -> bool:
        data = self.fh.read(self.CHUNK)
        if not data:
            if self._carry:
                self._lines = [self._carry]
                self._carry = b""
                self._li = 0
                return True
            return False
        buf = self._carry + data
        last_nl = buf.rfind(b"\n")
        if last_nl < 0:
            self._carry = buf
            return self._refill()
        self._carry = buf[last_nl + 1:]
        self._lines = buf[:last_nl].split(b"\n")
        self._li = 0
        return True

    def _next_line(self):
        while True:
            if self._li >= len(self._lines):
                if not self._refill():
                    return None
            line = self._lines[self._li]
            self._li += 1
            if line:
                return line

    def _skip_to_start(self):
        lines_per = 2 if self.fmt == "fasta" else 4
        skip = (self.params.read_start - 1) * lines_per
        for _ in range(skip):
            if not self.fh.readline():
                break

    def next_batch(self, batch_size: Optional[int] = None) -> List[ReadRec]:
        p = self.params
        n = batch_size or p.batch_reads
        out: List[ReadRec] = []
        is_fq = self.fmt == "fastq"
        read_line = self._next_line if self._plain else self._next_line_slow
        maxlen = p.max_readlen
        rs = self.readset
        while len(out) < n and self.index < p.read_end:
            header = read_line()
            if header is None:
                break
            name = header[1:].split()[0].decode() if len(header) > 1 else ""
            seq = read_line()
            seq = seq.split()[0].decode() if seq else ""
            if is_fq:
                read_line()  # '+'
                qual = read_line()
                qual = qual.split()[0].decode() if qual else ""
            else:
                qual = chr(p.zero_qual + p.default_qual) * len(seq)
            if len(seq) > maxlen:
                seq = seq[:maxlen]
                qual = qual[:maxlen]
            out.append(ReadRec(index=self.index, readset=rs,
                               name=name, seq=seq, qual=qual))
            self.index += 1
        return out

    def _next_line_slow(self):
        while True:
            line = self.fh.readline()
            if not line:
                return None
            line = line.strip()
            if line:
                return line

    def close(self):
        self.fh.close()


class RawFastqReader:
    """FASTQ batch reader producing RawBatch (zero-string path): chunks of
    the file are scanned by the native bt_scan_fastq into (offset, length)
    arrays; batches are array slices sharing the chunk buffer.  Token/field
    semantics identical to FastxReader (reference reads.cpp:42-82)."""

    CHUNK = 16 << 20

    def __init__(self, path: str, params: AlignParams, readset: int = 0):
        import numpy as np
        self.np = np
        self.params = params
        self.readset = readset
        self.fh = _open(path)
        self.index = params.read_start - 1
        self._carry = b""
        self._eof = False
        self._buf = None
        self._arr = None     # (name_off, name_len, seq_off, seq_len, q_off, q_len)
        self._pos = 0
        self._n = 0
        self._skip = params.read_start - 1
        self._fut = None     # pending background _produce
        self._ex = None      # lazy one-slot prefetch executor

    def _produce(self):
        """Read + native-scan the next chunk.  Returns (buf, arr, pos0, n)
        or None at EOF.  Only ever runs one-at-a-time (inline or as the
        single pending prefetch future), so fh/_carry/_eof/_skip are
        touched by exactly one thread at any moment."""
        import ctypes
        from ..native import get_lib, _p
        np = self.np
        while True:
            if self._eof and not self._carry:
                return None
            data = b"" if self._eof else self.fh.read(self.CHUNK)
            if not self._eof and len(data) < self.CHUNK:
                self._eof = True
            blob = self._carry + data if self._carry else data
            if not blob:
                return None
            buf = np.frombuffer(blob, np.uint8)
            cap = blob.count(b"\n") // 4 + 2
            no = np.empty(cap, np.int64)
            nl = np.empty(cap, np.int32)
            so = np.empty(cap, np.int64)
            sl = np.empty(cap, np.int32)
            qo = np.empty(cap, np.int64)
            ql = np.empty(cap, np.int32)
            consumed = ctypes.c_int64(0)
            lib = get_lib()
            nrec = lib.bt_scan_fastq(
                _p(buf, ctypes.c_uint8), ctypes.c_int64(buf.size),
                ctypes.c_int32(1 if self._eof else 0), ctypes.c_int64(cap),
                _p(no, ctypes.c_int64), _p(nl, ctypes.c_int32),
                _p(so, ctypes.c_int64), _p(sl, ctypes.c_int32),
                _p(qo, ctypes.c_int64), _p(ql, ctypes.c_int32),
                ctypes.byref(consumed))
            nrec = int(nrec)
            self._carry = blob[consumed.value:]
            if nrec == 0:
                if self._eof:
                    self._carry = b""  # truncated trailing record: drop
                    return None
                continue  # carry grew; read more
            pos0 = 0
            if self._skip:
                take = min(self._skip, nrec)
                pos0 += take
                self._skip -= take
                if pos0 >= nrec:
                    continue
            arr = (no[:nrec], nl[:nrec], so[:nrec], sl[:nrec],
                   qo[:nrec], ql[:nrec])
            return (buf, arr, pos0, nrec)

    def _scan_chunk(self) -> bool:
        """Install the next chunk, prefetching the one after it in a
        background thread so file reads + native scans overlap the
        pipeline's compute."""
        if self._fut is not None:
            res = self._fut.result()
            self._fut = None
        else:
            res = self._produce()
        if res is None:
            return False
        self._buf, self._arr, self._pos, self._n = res
        import os
        if (not (self._eof and not self._carry)
                and os.environ.get("BASAL_NO_PREFETCH") != "1"):
            if self._ex is None:
                from concurrent.futures import ThreadPoolExecutor
                self._ex = ThreadPoolExecutor(1)
            self._fut = self._ex.submit(self._produce)
        return True

    def next_batch(self, batch_size: Optional[int] = None):
        p = self.params
        want = min(batch_size or p.batch_reads, p.read_end - self.index)
        if want <= 0:
            return []
        if self._pos >= self._n and not self._scan_chunk():
            return []
        np = self.np
        take = min(want, self._n - self._pos)
        a, b = self._pos, self._pos + take
        no, nl, so, sl, qo, ql = self._arr
        maxlen = p.max_readlen
        batch = RawBatch(
            self._buf, no[a:b], nl[a:b], so[a:b],
            np.minimum(sl[a:b], maxlen), qo[a:b],
            np.minimum(ql[a:b], maxlen),
            index0=self.index, readset=self.readset)
        self._pos = b
        self.index += take
        return batch

    def close(self):
        if self._fut is not None:
            try:
                # wait for the in-flight read, but swallow its errors: the
                # prefetch is speculative — a bad chunk PAST the consumed
                # window (e.g. a truncated .fq.gz tail beyond -E) must not
                # fail a run that never needed it
                self._fut.result()
            except Exception:
                pass
            self._fut = None
        if self._ex is not None:
            self._ex.shutdown()
            self._ex = None
        self.fh.close()


_NT16 = "=ACMGRSVTWYHKDBN"


class BamReader:
    """Minimal BAM batch reader (BGZF via gzip module; BAM record codec).

    Replaces the vendored libbam input path (reads.cpp:84-108).  For paired
    input, R1/R2 are de-interleaved by flag 0x40/0x80 like the reference
    (reads.cpp:96-100).
    """

    def __init__(self, path: str, params: AlignParams, readset: int = 0):
        self.params = params
        self.readset = readset
        self.fh = io.BufferedReader(gzip.open(path, "rb"))
        magic = self.fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self.fh.read(4))[0]
        self.header_text = self.fh.read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", self.fh.read(4))[0]
        self.refs = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self.fh.read(4))[0]
            name = self.fh.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", self.fh.read(4))[0]
            self.refs.append((name, l_ref))
        self.index = params.read_start - 1
        skip = (params.read_start - 1) * (2 if params.pairend else 1)
        for _ in range(skip):
            if self._read_record() is None:
                break

    def _read_bytes(self, k: int) -> bytes:
        """Stream read that drains the native path's carry buffer first
        (the bulk decoder may have buffered past the stream position)."""
        if self._carry:
            if len(self._carry) >= k:
                b, self._carry = self._carry[:k], self._carry[k:]
                return b
            b, self._carry = self._carry, b""
            return b + self.fh.read(k - len(b))
        return self.fh.read(k)

    def _read_record(self):
        hdr = self._read_bytes(4)
        if len(hdr) < 4:
            return None
        block_size = struct.unpack("<i", hdr)[0]
        data = self._read_bytes(block_size)
        if len(data) < block_size:
            return None
        (_refid, _pos, l_rn, _mapq, _bin, n_cig, flag, l_seq, _nref, _npos,
         _tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
        off = 32
        name = data[off:off + l_rn - 1].decode()
        off += l_rn + 4 * n_cig
        seq_bytes = data[off:off + (l_seq + 1) // 2]
        off += (l_seq + 1) // 2
        qual_bytes = data[off:off + l_seq]
        seq = "".join(
            _NT16[(seq_bytes[i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF]
            for i in range(l_seq))
        qual = "".join(chr(q + 33) for q in qual_bytes)
        return flag, name, seq, qual

    _no_native = False
    _carry = b""
    _rec_est = 512  # bytes per BAM record, refined after the first batch

    def _grow_carry(self) -> bool:
        more = self.fh.read(8 << 20)
        if not more:
            return False
        self._carry = self._carry + more
        return True

    def _next_batch_native(self, n):
        """SE fast path: bulk-decode records into a RawBatch via the C
        decoder (engine.cpp:bt_bam_reads) — zero-string BAM input instead
        of the per-record Python loop.  Returns None to fall back (native
        engine unavailable or 0xFF 'no qual' bytes); self.fh and _carry
        always sit at a record boundary, so the per-record fallback
        continues seamlessly from _carry."""
        from ..native import bam_batch_reads
        p = self.params
        want = min(n, p.read_end - self.index)
        if want <= 0:
            return []
        # read enough compressed stream for ~want records up front (one
        # decode pass; re-decoding per 8MB growth was quadratic)
        need = want * self._rec_est + 4096
        while True:
            while len(self._carry) < need:
                if not self._grow_carry():
                    break
                continue
            res = bam_batch_reads(self._carry, want, p.max_readlen)
            if res is None:
                return None
            nrec, consumed, buf, arrs = res
            if nrec >= want or len(self._carry) < need:
                break  # satisfied, or the stream is exhausted
            need *= 2
        if nrec == 0:
            return []
        self._rec_est = max(64, consumed // nrec + 16)
        self._carry = self._carry[consumed:]
        noff, nlen, soff, slen, qoff, qlen = arrs
        batch = RawBatch(buf, noff, nlen, soff, slen, qoff, qlen,
                         index0=self.index, readset=0)
        self.index += nrec
        return batch

    def next_batch(self, batch_size: Optional[int] = None):
        p = self.params
        n = batch_size or p.batch_reads
        if self.readset == 0 and not self._no_native:
            b = self._next_batch_native(n)
            if b is not None:
                return b
            self._no_native = True
        out: List[ReadRec] = []
        pe = self.readset != 0
        while len(out) < n and self.index < p.read_end:
            if self.readset == 2:
                if self._read_record() is None:
                    break
            rec = self._read_record()
            if rec is None:
                break
            flag, name, seq, qual = rec
            if pe:
                rs = 1 if (flag & 0x40) else (2 if (flag & 0x80) else self.readset)
            else:
                rs = 0
            if len(seq) > p.max_readlen:
                seq = seq[:p.max_readlen]
                qual = qual[:p.max_readlen]
            out.append(ReadRec(index=self.index, readset=rs,
                               name=name, seq=seq, qual=qual))
            self.index += 1
            if self.readset == 1:
                if self._read_record() is None:
                    break
        return out

    def close(self):
        self.fh.close()


class SamReader:
    """SAM-text read input (reads.cpp SAM branch via samread); R1/R2
    de-interleaved by flag 0x40/0x80 for paired input."""

    def __init__(self, path: str, params: AlignParams, readset: int = 0):
        self.params = params
        self.readset = readset
        self.fh = _open(path)
        self.index = params.read_start - 1
        skip = (params.read_start - 1) * (2 if params.pairend else 1)
        n = 0
        while n < skip:
            if self._read_record() is None:
                break
            n += 1

    def _read_record(self):
        while True:
            line = self.fh.readline()
            if not line:
                return None
            if line.startswith(b"@"):
                continue
            col = line.rstrip(b"\n").split(b"\t")
            if len(col) < 11:
                continue
            return (int(col[1]), col[0].decode(), col[9].decode(),
                    col[10].decode())

    def next_batch(self, batch_size: Optional[int] = None) -> List[ReadRec]:
        p = self.params
        n = batch_size or p.batch_reads
        out: List[ReadRec] = []
        pe = self.readset != 0
        while len(out) < n and self.index < p.read_end:
            if self.readset == 2:
                if self._read_record() is None:
                    break
            rec = self._read_record()
            if rec is None:
                break
            flag, name, seq, qual = rec
            if pe:
                rs = 1 if (flag & 0x40) else (2 if (flag & 0x80) else self.readset)
            else:
                rs = 0
            if len(seq) > p.max_readlen:
                seq = seq[:p.max_readlen]
                qual = qual[:p.max_readlen]
            out.append(ReadRec(index=self.index, readset=rs,
                               name=name, seq=seq, qual=qual))
            self.index += 1
            if self.readset == 1:
                if self._read_record() is None:
                    break
        return out

    def close(self):
        self.fh.close()


def open_reads(path: str, params: AlignParams, readset: int = 0):
    import os
    fmt = sniff_format(path)
    if fmt == "fastq" and not os.environ.get("BASAL_NO_RAW"):
        from ..native import native_available
        if native_available():
            return RawFastqReader(path, params, readset)
    if fmt in ("fasta", "fastq"):
        return FastxReader(path, params, readset, fmt)
    if fmt == "bam":
        return BamReader(path, params, readset)
    return SamReader(path, params, readset)
