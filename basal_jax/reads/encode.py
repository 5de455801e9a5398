"""Batch read filtering + encoding into device planes and seed arrays.

Replaces the reference's per-read scalar pipeline:
  FilterReads        (align.cpp:548-563) -> mismatch budget, trims, N filter
  TrimAdapter        (align.cpp:418-435)
  TrimLowQual        (align.cpp:51-76)
  ConvertBina[r]ySeq (align.cpp:79-226)  -> 2/3-plane packing + seed arrays

Encoding is vectorized numpy over the whole batch; planes are u32 words of
16 bases (first base in the MSBs), one row per (read, chain):
  row = 2*read + chain, chain 0 = read as-is, chain 1 = reverse complement
  (via rev_alphabet over the reversed read, align.cpp:193-199).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from ..bits import pack_planes_u32, seeds_from_codes, xt_collapse32
from ..config import MAXSNPS, AlignParams, REG_ALPHABET
from .io import ReadRec


@dataclasses.dataclass
class EncodedBatch:
    reads: List[ReadRec]              # post-trim reads (seq/qual mutated)
    filtered: np.ndarray              # bool [B]: QC-failed (reported 0x204)
    map_len: np.ndarray               # int32 [B]
    raw_len: np.ndarray               # int32 [B] pre-trim length
    read_max_snp: np.ndarray          # int32 [B] per-read mismatch budget
    xflag_chain: np.ndarray           # bool [B, 2] enabled read chains
    n_count: np.ndarray               # int32 [B] (-N term; 0 otherwise)
    seedseg_num: np.ndarray           # int32 [B]
    # device planes, rows = 2*B (read-major, chain minor)
    W: int
    base: np.ndarray                  # u32 [2B, W]
    valid: np.ndarray                 # u32 [2B, W]
    mread: np.ndarray                 # u32 [2B, W]
    lenmask: np.ndarray               # u32 [2B, W]
    # host seed arrays
    seedval: np.ndarray               # u32 [B, 2, L-s+1 max] (padded)
    seed_has_n: np.ndarray            # bool same shape
    n_offsets: np.ndarray             # int32 [B] valid offsets = L-s+1


def _trim_adapter(p: AlignParams, seq: str, qual: str):
    """TrimAdapter (align.cpp:418-435): >=4bp match, <=20% mismatches, <=4
    absolute; first adapter hit wins."""
    for ad in p.adapters:
        lo = p.seed_size + p.index_interval - 1
        for pos in range(lo, len(seq) - 4):
            m0 = 0
            k = 0
            while k < len(ad) and k < 15 and pos + k < len(seq):
                if ad[k] != seq[pos + k]:
                    m0 += 1
                    if m0 > 4:
                        break
                k += 1
            if k >= m0 * 5 and k > 3:
                return seq[:pos], qual[:pos] if len(qual) > pos else qual
    return seq, qual


def _trim_lowqual(p: AlignParams, seq: str, qual: str):
    """TrimLowQual (align.cpp:51-76).  Returns (seq, qual, failed)."""
    if len(seq) != len(qual):
        qual = chr(p.zero_qual + p.default_qual) * len(seq)
    qual_thres = p.zero_qual + p.qual_threshold
    if p.zero_qual != ord("!"):
        delta = p.zero_qual - ord("!")
        qual = "".join(chr(ord(c) - delta) for c in qual)
        qual_thres -= delta
    if p.qual_threshold == 0:
        return seq, qual, False
    i = len(qual)
    for c in reversed(qual):
        if ord(c) > qual_thres:
            break
        i -= 1
    if i < p.seed_size + p.index_interval - 1:
        return seq, qual, True
    return seq[:i], qual[:i], False


def filter_and_trim(params: AlignParams, reads: List[ReadRec]):
    """Run FilterReads semantics over a batch; mutates seq/qual in place.
    Returns (filtered bool[B], raw_len, read_max_snp, n_count, chars[B, lmax]).

    The trimming passes (adapter / low-quality) only loop per read when the
    corresponding option is active; the common path is fully vectorized."""
    p = params
    B = len(reads)
    raw_len = np.array([len(r.seq) for r in reads], dtype=np.int32)
    qc_fail = np.zeros(B, dtype=bool)

    # per-read budget before trimming (align.cpp:550-556)
    if p.max_snp_num < 100:
        rms = np.full(B, p.max_snp_num, dtype=np.int64)
    else:
        rms = ((p.max_snp_num - 100) / 100.0 * raw_len + 0.5).astype(np.int64)
    if p.gap > 0:
        rms = rms + 1 + p.gap
    rms = np.minimum(rms, MAXSNPS)

    if p.adapters:
        for r in reads:
            r.seq, r.qual = _trim_adapter(p, r.seq, r.qual)
    needs_qual_pass = p.qual_threshold != 0 or p.zero_qual != ord("!")
    if needs_qual_pass:
        for i, r in enumerate(reads):
            r.seq, r.qual, fail = _trim_lowqual(p, r.seq, r.qual)
            qc_fail[i] = fail
    else:
        for r in reads:  # qual-length fix (align.cpp:54-55)
            if len(r.seq) != len(r.qual):
                r.qual = chr(p.zero_qual + p.default_qual) * len(r.seq)

    map_len = np.array([len(r.seq) for r in reads], dtype=np.int32)
    lmax = max(int(map_len.max(initial=1)), p.seed_size)
    # one join instead of 50k per-read buffer copies
    flat = np.frombuffer("".join(r.seq for r in reads).encode("latin1"),
                         np.uint8)
    if flat.size == B * lmax:
        # uniform full-length reads: the joined blob IS the char matrix
        chars = flat.reshape(B, lmax)
    else:
        off = np.zeros(B + 1, np.int64)
        np.cumsum(map_len, out=off[1:])
        pos = np.arange(lmax, dtype=np.int64)
        in_read = pos[None, :] < map_len[:, None]
        idx = np.minimum(off[:-1, None] + pos[None, :],
                         max(flat.size - 1, 0))
        chars = np.where(in_read, flat[idx] if flat.size else np.uint8(0),
                         np.uint8(ord("N")))

    ncnt = ((REG_ALPHABET[chars] == 0)
            & (np.arange(lmax)[None, :] < map_len[:, None])).sum(1)
    filtered = qc_fail | (map_len < p.min_read_size) | (ncnt > p.max_ns)
    n_count = (ncnt.astype(np.int32) if p.n_mis
               else np.zeros(B, dtype=np.int32))
    n_count[filtered] = 0
    budget = ((rms + 1) * np.maximum(map_len - 1, 0)
              // np.maximum(raw_len, 1)).astype(np.int32)  # align.cpp:561
    budget[filtered] = 0
    return filtered, raw_len, budget, n_count, chars


def encode_batch(params: AlignParams, reads) -> EncodedBatch:
    p = params
    rule = p.rule
    from .io import RawBatch
    if isinstance(reads, RawBatch):
        enc = _encode_raw(p, reads)
        if enc is not None:
            return enc
        reads = reads.to_list()  # trimming active / malformed quals
    filtered, raw_len, budget, n_count, chars = filter_and_trim(p, reads)
    B = len(reads)
    map_len = np.array([len(r.seq) for r in reads], dtype=np.int32)
    lmax = chars.shape[1]
    W = max(4, -(-(lmax) // 16))  # words covering lmax

    from ..native import native_encode
    nat = (native_encode(p, chars, map_len, W)
           if not os.environ.get("BASAL_NO_NATIVE") else None)
    if nat is not None:
        base, valid, mread, lenmask, seedval, has_n = nat
        return _finish_batch(p, reads, filtered, raw_len, budget, n_count,
                             map_len, W, base, valid, mread, lenmask,
                             seedval, has_n)

    # chain 0: as-is; chain 1: reversed chars through rev_* LUTs.  The
    # reference right-aligns nothing — the reversed read also starts at
    # position 0 (align.cpp:193-199): reverse each row by its own length,
    # done batched via a roll-by-length gather.
    idx = (map_len[:, None] - 1 - np.arange(lmax)[None, :])
    pad_mask = idx < 0
    rev = np.take_along_axis(chars, np.where(pad_mask, 0, idx), axis=1)
    rev[pad_mask] = ord("N")

    codes = np.empty((B, 2, lmax), dtype=np.uint8)
    mreadc = np.empty((B, 2, lmax), dtype=np.uint8)
    validc = np.empty((B, 2, lmax), dtype=np.uint8)
    codes[:, 0] = rule.alphabet[chars]
    codes[:, 1] = rule.rev_alphabet[rev]
    mreadc[:, 0] = rule.alphabet_mread[chars]
    mreadc[:, 1] = rule.rev_alphabet_mread[rev]
    validc[:, 0] = REG_ALPHABET[chars]
    validc[:, 1] = REG_ALPHABET[rev]
    # beyond-read positions already map to 0 via 'N'

    base = pack_planes_u32(codes.reshape(2 * B, lmax), W)
    if p.nt3:
        base = xt_collapse32(base)
    valid = pack_planes_u32(validc.reshape(2 * B, lmax), W)
    mread = pack_planes_u32(mreadc.reshape(2 * B, lmax), W)
    lenc = np.where(np.arange(lmax)[None, :] < map_len[:, None], 3, 0) \
        .astype(np.uint8)
    lenmask = pack_planes_u32(np.repeat(lenc, 2, axis=0), W)

    seedval, has_n = seeds_from_codes(
        codes, validc != 0, p.seed_size)
    return _finish_batch(p, reads, filtered, raw_len, budget, n_count,
                         map_len, W, base, valid, mread, lenmask,
                         seedval, has_n)


def _encode_raw(p: AlignParams, rb) -> "EncodedBatch | None":
    """Zero-string fast path: encode straight from the RawBatch buffer
    (no ReadRec objects, no char-matrix materialization, no per-read
    Python).  Falls back (returns None) when a trimming pass is active or
    seq/qual lengths disagree — those mutate per-read strings."""
    if os.environ.get("BASAL_NO_NATIVE"):
        return None
    needs_qual_pass = p.qual_threshold != 0 or p.zero_qual != ord("!")
    if p.adapters or needs_qual_pass:
        return None
    if (rb.seq_len != rb.qual_len).any():
        return None  # qual-length fix path (align.cpp:54-55)
    from ..native import native_encode
    B = len(rb)
    map_len = np.ascontiguousarray(rb.seq_len, np.int32)
    raw_len = map_len  # no trimming on this path
    lmax = max(int(map_len.max(initial=1)), p.seed_size)
    W = max(4, -(-lmax // 16))
    nat = native_encode(p, rb.buf, map_len, W, seq_off=rb.seq_off,
                        lmax=lmax, want_ncnt=True)
    if nat is None:
        return None
    base, valid, mread, lenmask, seedval, has_n, ncnt = nat

    # per-read budget (align.cpp:550-556); no trim -> raw == map
    if p.max_snp_num < 100:
        rms = np.full(B, p.max_snp_num, dtype=np.int64)
    else:
        rms = ((p.max_snp_num - 100) / 100.0 * raw_len + 0.5).astype(np.int64)
    if p.gap > 0:
        rms = rms + 1 + p.gap
    rms = np.minimum(rms, MAXSNPS)
    filtered = (map_len < p.min_read_size) | (ncnt > p.max_ns)
    n_count = ncnt.astype(np.int32) if p.n_mis else np.zeros(B, np.int32)
    n_count[filtered] = 0
    budget = ((rms + 1) * np.maximum(map_len - 1, 0)
              // np.maximum(raw_len, 1)).astype(np.int32)
    budget[filtered] = 0
    return _finish_batch(p, rb, filtered, raw_len, budget, n_count,
                         map_len, W, base, valid, mread, lenmask,
                         seedval, has_n)


def _finish_batch(p, reads, filtered, raw_len, budget, n_count, map_len, W,
                  base, valid, mread, lenmask, seedval, has_n):
    B = len(reads)
    n_off = np.maximum(map_len - p.seed_size + 1, 0).astype(np.int32)

    # enabled chains (PBAT support, align.cpp:156-158)
    from .io import RawBatch
    if isinstance(reads, RawBatch):
        readset = np.full(B, reads.readset, dtype=np.int32)
    else:
        readset = np.array([r.readset for r in reads], dtype=np.int32)
    xf = np.zeros((B, 2), dtype=bool)
    xf[:, 0] = (p.chains == 1) | ((p.chains <= 1) == (readset < 2))
    xf[:, 1] = (p.chains == 1) | ((p.chains <= 1) == (readset == 2))

    seedseg = np.minimum(
        (map_len - p.index_interval + 1) // p.seed_size,
        budget + 1).astype(np.int32)  # align.cpp:450

    return EncodedBatch(
        reads=reads, filtered=filtered, map_len=map_len, raw_len=raw_len,
        read_max_snp=budget, xflag_chain=xf, n_count=n_count,
        seedseg_num=seedseg, W=W,
        base=base, valid=valid, mread=mread, lenmask=lenmask,
        seedval=seedval, seed_has_n=has_n, n_offsets=n_off,
    )
