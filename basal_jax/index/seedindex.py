"""In-RAM interval k-mer seed index, CSR layout.

Equivalent of the reference's KmerLoc2 index
(``RefSeq::InitialIndex/CalKmerFreq/AllocIndex/FillIndex``,
refbase.cpp:254-448): key space 3^seed_size over collapsed (3-letter) seeds,
locations every ``index_interval`` bases of every unmasked block on both
strand planes, stored in concatenated (hit2int, refbase.cpp:485-487)
coordinates.

CSR layout instead of pooled pointer blocks:
  ``starts[k] .. starts[k]+counts[k]``  -> slice of ``locs`` for k-mer k,
  chain-0 (fwd-plane) entries first then chain-1, each in block-traversal
  order — ordering identical to the reference's two-thread fill
  (t_FillIndex, refbase.cpp:419-439).  ``n1[k]`` = chain-0 count (the
  reference's n[1]) for the plane-boundary test in the candidate scan.

Build is a single stable argsort over the probed positions (O(P log P) on
occurring k-mers only); the 3^s-sized lookup arrays are zero-filled lazily
and scattered sparsely, so small references index in milliseconds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..bits import seeds_from_words
from ..config import AlignParams
from .reference import PackedReference


@dataclasses.dataclass
class SeedIndex:
    starts: np.ndarray      # int64 [3^s] CSR offset per kmer
    counts: np.ndarray      # int32 [3^s] total count per kmer (n[0])
    n1: np.ndarray          # int32 [3^s] chain-0 count per kmer (n[1])
    locs: np.ndarray        # uint32 [P] concatenated coords
    max_kmer_num: int       # over-represented cutoff (refbase.cpp:362-363)


def _chain_positions(ref: PackedReference, params: AlignParams, chain: int) -> np.ndarray:
    """Concatenated base positions probed on one strand plane, in the exact
    traversal order of t_CalKmerFreq/t_FillIndex (refbase.cpp:303-325):
    blocks sorted by (id, begin), positions from floor(begin/I)*I to
    ((end-s)/I)*I inclusive, step I."""
    I = params.index_interval
    s = params.seed_size
    out = []
    for b in ref.blocks:
        if b.id % 2 != chain:
            continue
        anchor = ref.ref_anchor[b.id // 2]
        start = (b.begin // I) * I
        i2 = ((b.end - s) // I) * I
        if i2 < start:
            continue
        out.append(np.arange(start, i2 + 1, I, dtype=np.int64) + anchor)
    if not out:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(out)


def _kmer_cutoff(params: AlignParams, uk: np.ndarray, uc: np.ndarray) -> int:
    """Over-represented k-mer cutoff: the count quantile at
    (1 - max_kmer_ratio) over all 3^s slots.

    The reference sorts only the first total_kmers-1 slots
    (refbase.cpp:362: ``sort(kmer_count, kmer_count+total_kmers-1)``), so the
    slot of the last k-mer id (3^s - 1) sits unsorted at the tail; replicated
    exactly without materializing the dense array.

    The quantile index is computed in FLOAT32: ``max_kmer_ratio`` is a C++
    ``float`` (param.h:83), so refbase.cpp:363's
    ``(bit32_t)(total_kmers*(1-param.max_kmer_ratio))-1`` does uint32*float
    arithmetic — for s=16 that float product rounds 43046699.47 up to
    43046700.0, one slot HIGHER than the double-precision value.  On
    repeat-heavy references the top k-mer counts are densely clustered, so
    this off-by-one flips whole seed groups in/out of the index (observed:
    3/20000 pairs diverging on a 50 Mbp 45%-repeat genome).
    """
    nk = params.total_kmers
    one_minus = np.float32(1) - np.float32(params.max_kmer_ratio)
    qidx = int(np.float32(nk) * one_minus) - 1
    last_id = nk - 1
    in_tail = uk == last_id
    last_count = int(uc[in_tail][0]) if in_tail.any() else 0
    nz = np.sort(uc[~in_tail], kind="stable")  # occurring kmers, id < 3^s-1
    zeros = (nk - 1) - nz.size
    if qidx >= nk - 1:
        return last_count
    if qidx < zeros:
        return 0
    return int(nz[qidx - zeros])


def _kmer_cutoff_dense(params: AlignParams, counts: np.ndarray) -> int:
    """_kmer_cutoff on the dense per-slot count array via O(m) selection:
    the qidx-th smallest of {counts[k] : k < 3^s - 1} through
    ``np.partition`` over the occurring slots (exact for integers; the
    full stable sort was seconds of the 50 Mbp startup).  Same float32
    quantile index and last-slot exclusion quirks as _kmer_cutoff
    (refbase.cpp:362-363)."""
    nk = params.total_kmers
    one_minus = np.float32(1) - np.float32(params.max_kmer_ratio)
    qidx = int(np.float32(nk) * one_minus) - 1
    if qidx >= nk - 1:
        return int(counts[nk - 1])
    rank = (nk - 1) - qidx  # 1-based rank from the top
    if rank <= 64:
        try:  # one C++ pass over the table (mask+gather cost seconds)
            from ..native import native_top_counts
            return int(native_top_counts(counts[:nk - 1], 64)[rank - 1])
        except Exception:  # noqa: BLE001 - native engine is optional
            pass
    head = counts[:nk - 1]
    nz = head[head > 0]
    zeros = (nk - 1) - nz.size
    if qidx < zeros:
        return 0
    k = qidx - zeros
    return int(np.partition(nz, k)[k])


def build_index(ref: PackedReference, params: AlignParams) -> SeedIndex:
    nk = params.total_kmers
    s = params.seed_size

    pos0 = _chain_positions(ref, params, 0)
    pos1 = _chain_positions(ref, params, 1)

    try:  # C++ counting-sort fill: one histogram + scatter pass instead of
        # a 4-pass numpy argsort chain
        from ..native import native_build_seed_index
        nat = native_build_seed_index(ref.ref32, pos0, pos1, s, nk)
    except Exception:  # noqa: BLE001 - native engine is optional
        nat = None
    if nat is not None:
        starts, counts, n1, locs = nat
        return SeedIndex(
            starts=starts, counts=counts, n1=n1, locs=locs,
            max_kmer_num=_kmer_cutoff_dense(params, counts),
        )

    seeds0 = seeds_from_words(ref.ref32[0], pos0, s)
    seeds1 = seeds_from_words(ref.ref32[1], pos1, s)

    seeds_all = np.concatenate([seeds0, seeds1])
    pos_all = np.concatenate([pos0, pos1])
    # stable sort: groups by kmer; within a kmer, chain-0 entries (which come
    # first in the input) precede chain-1, each in traversal order — the
    # reference's fill layout.
    order = np.argsort(seeds_all, kind="stable")
    ss = seeds_all[order]
    locs = pos_all[order].astype(np.uint32)

    # group boundaries from the sorted stream (np.unique would sort again)
    if len(ss):
        uk_start = np.concatenate(
            [[0], np.flatnonzero(ss[1:] != ss[:-1]) + 1])
        uk = ss[uk_start]
        uc = np.diff(np.concatenate([uk_start, [len(ss)]]))
    else:
        uk_start = np.zeros(0, np.int64)
        uk = np.zeros(0, ss.dtype)
        uc = np.zeros(0, np.int64)
    is0 = (order < len(pos0)).astype(np.int32)
    n1_per = (np.add.reduceat(is0, uk_start) if len(ss)
              else np.zeros(0, np.int32))

    starts = np.zeros(nk, dtype=np.int64)
    counts = np.zeros(nk, dtype=np.int32)
    n1 = np.zeros(nk, dtype=np.int32)
    try:
        from ..native import madvise_hugepage
        for a in (starts, counts, n1, locs):
            madvise_hugepage(a)
    except Exception:  # noqa: BLE001
        pass
    starts[uk] = uk_start
    counts[uk] = uc
    n1[uk] = n1_per

    return SeedIndex(
        starts=starts, counts=counts, n1=n1, locs=locs,
        max_kmer_num=_kmer_cutoff(params, uk, uc),
    )
