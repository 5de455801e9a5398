"""RRBS / digestion-site mode (hidden ``-D``, legacy).

Reimplements the reference's restriction-fragment index:
  IUPAC digestion-site expansion   Param::SetDigestionSite (param.cpp:76-106)
  per-chr site scan + fragment map RefSeq::find_CCGG      (refbase.cpp:130-182)
  fragment-anchored seed index     CalKmerFreq/FillIndex RRBS branches
                                   (refbase.cpp:279-301, 391-411)
  fragment lookup for ZP/ZL tags   RefSeq::CCGG_seglen    (refbase.cpp:456-482)

Index entries carry (chr_plane | mode<<16 | opp<<24, plane-local loc) like the
reference's Hit packing; the candidate scan filters on mode/orientation at
visit time (SnpAlign RRBS branch, align.cpp:233-273).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from ..bits import seeds_from_words
from ..config import AlignParams
from .reference import PackedReference, iter_fasta

IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "N": "ACGT",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
}


def expand_digestion_site(spec: str) -> Tuple[List[str], List[int]]:
    """'C-CGG' -> concrete site strings + cut positions (param.cpp:76-106).
    Expansion order follows the reference's odometer (first position cycles
    fastest)."""
    dp = spec.find("-")
    if dp < 0:
        raise ValueError(
            "Digestion position not marked, use '-' to mark. example: 'C-CGG'")
    ds = spec[:dp] + spec[dp + 1:]
    counts = [len(IUPAC[c]) for c in ds]
    sites, positions = [], []
    idx = [0] * len(ds)
    while True:
        sites.append("".join(IUPAC[c][i] for c, i in zip(ds, idx)))
        positions.append(dp)
        j = 0
        idx[j] += 1
        while j < len(ds) and idx[j] >= counts[j]:
            idx[j] = 0
            j += 1
            if j < len(ds):
                idx[j] += 1
        if j >= len(ds):
            break
    return sites, positions


@dataclasses.dataclass
class RrbsIndex:
    # per-kmer entry lists (CSR): chrmode = chr_plane | mode<<16 | opp<<24
    starts: np.ndarray          # int64 [3^s + 1]
    chrmode: np.ndarray         # uint32 [N]
    locs: np.ndarray            # uint32 [N] plane-local base coords
    n1: np.ndarray              # int32 [3^s] total entries per kmer
    ccgg_sites: List[List[Tuple[int, int]]]   # per chr pair: (pos, rev_off)

    @property
    def counts(self):
        """CountSeeds RRBS reads index[s].n1 (align.cpp:534)."""
        return self.n1

    @property
    def max_kmer_num(self):
        return 1 << 62  # no over-representation cutoff in RRBS scan


def ccgg_seglen(idx: RrbsIndex, chr_index: int, pos: int, readlen: int):
    """Fragment (ZP, ZL) lookup (refbase.cpp:456-482)."""
    sites = idx.ccgg_sites[chr_index >> 1]
    if not sites:
        return (1, 0)
    left, right = 0, len(sites) - 1
    while left < right - 1:
        mid = (left + right) // 2
        mv = sites[mid][0]
        if mv == pos:
            left, right = mid, mid + 1
            break
        if mv < pos:
            left = mid
        else:
            right = mid
    seg_start = sites[left][0]
    while right < len(sites):
        seg_end = sites[right][0] + sites[right][1]
        if seg_end >= pos + readlen:
            break
        right += 1
    else:
        seg_end = sites[-1][0] + sites[-1][1]
    if right < len(sites):
        seg_end = sites[right][0] + sites[right][1]
    return (seg_start + 1, seg_end - seg_start)


def build_rrbs_index(ref_path: str, ref: PackedReference,
                     params: AlignParams) -> RrbsIndex:
    p = params
    s = p.seed_size
    sites_spec, pos_spec = expand_digestion_site(p.digestion_site)
    max_seg = p.max_seedseg_num

    ccgg_sites_all: List[List[Tuple[int, int]]] = []
    per_chr: List[Tuple[List[List[int]], List[List[int]], int, int]] = []

    extra = p.pairend or p.chains != 0

    for chr_pair, (name, seq) in enumerate(iter_fasta(ref_path)):
        seq_u = bytes(seq).upper().decode("latin1")
        length = len(seq_u)
        title = ref.titles[chr_pair]
        tmp_offset = title.rc_offset - s
        tmp_max = title.size - s

        tmp_sites: List[Tuple[int, int]] = []
        for site, dpos in zip(sites_spec, pos_spec):
            min_off = min(dpos, len(site) - dpos)
            rev_off = len(site) - 2 * min_off
            start = 1  # the reference's find(site, 1) skips position 0
            while True:
                r = seq_u.find(site, start)
                if r < 0 or r >= length:
                    break
                tmp_sites.append((r + min_off, rev_off))
                start = r + 1
        tmp_sites.sort()
        ccgg_sites_all.append(tmp_sites)

        n_sites = len(tmp_sites)
        pos = np.asarray([t[0] for t in tmp_sites], dtype=np.int64)
        roff = np.asarray([t[1] for t in tmp_sites], dtype=np.int64)
        ends = pos + roff
        # All expansions of one spec share len(site) and dpos, so rev_off is a
        # single constant and `ends` is sorted along with `pos`; the scalar
        # break-at-first scans below then reduce to searchsorted.  Guard and
        # fall back to the exact scalar loops if that invariant ever breaks.
        vec_ok = (n_sites > 1 and np.unique(roff).size == 1
                  and os.environ.get("BASAL_RRBS_SCALAR", "0")
                  in ("", "0"))
        if vec_ok:
            # Watson: first i>j with ends[i]-pos[j] >= min_insert
            # (refbase.cpp find_CCGG forward fragment scan)
            tj = pos[:-1] + p.min_insert
            fi = np.searchsorted(ends, tj, side="left")
            fi = np.maximum(fi, np.arange(1, n_sites))
            okw = fi < n_sites
            segw = np.where(okw, ends[np.minimum(fi, n_sites - 1)] - pos[:-1],
                            0)
            accw = okw & (segw >= p.min_insert) & (segw <= p.max_insert)
            acc_pos = pos[:-1][accw]          # ascending j order
            # Crick: largest i<j with ends[j]-pos[i] >= min_insert
            tj2 = ends[1:] - p.min_insert
            ri = np.searchsorted(pos, tj2, side="right") - 1
            ri = np.minimum(ri, np.arange(0, n_sites - 1))
            okc = ri >= 0
            segc = np.where(okc, ends[1:] - pos[np.maximum(ri, 0)], 0)
            accc = okc & (segc >= p.min_insert) & (segc <= p.max_insert)
            acc_end = ends[1:][accc]          # ascending j order
            bsw = [acc_pos + i * s for i in range(max_seg)]
            bsw = [v[v <= tmp_max] for v in bsw]
            bsc = [acc_end - s - i * s for i in range(max_seg)]
            bsc = [tmp_offset - v[v >= 0] for v in bsc]
        else:
            bsw_l: List[List[int]] = [[] for _ in range(max_seg)]
            bsc_l: List[List[int]] = [[] for _ in range(max_seg)]
            for j in range(n_sites - 1):
                seglen = 0
                for i in range(j + 1, n_sites):
                    seglen = (tmp_sites[i][0] + tmp_sites[i][1]
                              - tmp_sites[j][0])
                    if seglen >= p.min_insert:
                        break
                if seglen > p.max_insert or seglen < p.min_insert:
                    continue
                seedloc = tmp_sites[j][0]
                for i in range(max_seg):
                    if seedloc > tmp_max:
                        break
                    bsw_l[i].append(seedloc)
                    seedloc += s
            for j in range(1, n_sites):
                seglen = 0
                for i in range(j - 1, -1, -1):
                    seglen = (tmp_sites[j][0] + tmp_sites[j][1]
                              - tmp_sites[i][0])
                    if seglen >= p.min_insert:
                        break
                if seglen > p.max_insert or seglen < p.min_insert:
                    continue
                seedloc = tmp_sites[j][0] + tmp_sites[j][1] - s
                for i in range(max_seg):
                    if seedloc < 0:
                        break
                    bsc_l[i].append(tmp_offset - seedloc)
                    seedloc -= s
            bsw = [np.asarray(v, dtype=np.int64) for v in bsw_l]
            bsc = [np.asarray(v, dtype=np.int64) for v in bsc_l]
        per_chr.append((bsw, bsc, int(ref.ref_anchor[chr_pair]), tmp_offset))

    # index fill order (FillIndex RRBS, refbase.cpp:391-411): mode-major,
    # then chr plane ascending across all sequences; the opposite-plane
    # remapped entries (pairend/chains) follow each plane's own list
    all_chrmode: List[np.ndarray] = []
    all_loc: List[np.ndarray] = []
    all_seed: List[np.ndarray] = []
    for mode in range(max_seg):
        for chr_pair, (bsw, bsc, anchor, tmp_offset) in enumerate(per_chr):
            for plane in range(2):
                lst = bsw[mode] if plane == 0 else bsc[mode]
                chrplane = 2 * chr_pair + plane
                plocs = np.asarray(lst, dtype=np.int64)
                if plocs.size:
                    seeds = seeds_from_words(
                        ref.ref32[plane], plocs + anchor, s)
                    all_seed.append(seeds)
                    all_chrmode.append(np.full(
                        plocs.size, chrplane | (mode << 16), dtype=np.uint32))
                    all_loc.append(plocs)
                if extra:
                    olst = np.asarray(bsc[mode] if plane == 0 else bsw[mode],
                                      dtype=np.int64)
                    olocs = tmp_offset - olst[tmp_offset >= olst]
                    if olocs.size:
                        seeds = seeds_from_words(
                            ref.ref32[plane], olocs + anchor, s)
                        all_seed.append(seeds)
                        all_chrmode.append(np.full(
                            olocs.size,
                            chrplane | (mode << 16) | 0x1000000,
                            dtype=np.uint32))
                        all_loc.append(olocs)

    nk = p.total_kmers
    if all_seed:
        seeds = np.concatenate(all_seed)
        chrmode = np.concatenate(all_chrmode)
        locs = np.concatenate(all_loc).astype(np.uint32)
        order = np.argsort(seeds, kind="stable")
        ss = seeds[order]
        uk, uk_start, uc = np.unique(ss, return_index=True, return_counts=True)
        # dense 3^s-slot tables: pre-faulted threaded memset (np.zeros pays
        # random-order first-touch faults during the scatter — same fix as
        # bt_build_seed_index for the main index)
        from ..native import zeros_mt
        starts = zeros_mt(nk + 1, np.int64)
        n1 = zeros_mt(nk, np.int32)
        starts[uk] = uk_start
        n1[uk] = uc
        # store grouped arrays
        chrmode = chrmode[order]
        locs = locs[order]
        starts[-1] = len(ss)
        return RrbsIndex(starts=starts, chrmode=chrmode, locs=locs, n1=n1,
                         ccgg_sites=ccgg_sites_all)
    from ..native import zeros_mt
    return RrbsIndex(
        starts=zeros_mt(nk + 1, np.int64),
        chrmode=np.zeros(0, np.uint32), locs=np.zeros(0, np.uint32),
        n1=zeros_mt(nk, np.int32), ccgg_sites=ccgg_sites_all)
