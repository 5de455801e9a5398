"""Paired-end alignment pipeline + PE SAM emission.

Orchestrates two read streams in lockstep (t_PairAlign, main.cpp:95-122;
PairAlign::Do_Batch, pairs.cpp:179-202); both ends' candidate tables are
evaluated in a single device batch, then each pair replays through the
lockstep stratum search (basal_jax.pairs.pairing).

SAM emission mirrors s_OutHitPair (pairs.cpp:307-416) and s_OutHitUnpair
(pairs.cpp:418-485) byte-for-byte.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

from ..align.candidates import SeedScheduler, build_candidates
from ..align.pipeline import (DeviceContext, gather_ranges, host_eval_policy,
                              wave_of_reads)
from ..align.replay import Hit, ReadScan, Replayer
from ..align.rng import MyRand
from ..align.sam import CHAIN_FLAG, _cigar, _xr_context, revcomp, sam_header
from ..config import MAXSNPS, AlignParams
from ..index.reference import PackedReference, load_reference
from ..index.seedindex import build_index
from ..reads.encode import encode_batch
from ..reads.io import open_reads
from .pairing import PairHit, fix_pair_read_name, get_pairs, lockstep_align


def merge_pe_waves(waves, B: int):
    """One bt_replay_pe result from ladder waves [(mask, result)] (see
    align.pipeline.merge_se_waves)."""
    if len(waves) == 1:
        return waves[0][1]
    wave_of = wave_of_reads(waves, B)
    res = [w[1] for w in waves]

    def per_read(arrs):
        out = np.empty(B, arrs[0].dtype)
        for w, a in enumerate(arrs):
            out[wave_of == w] = a[wave_of == w]
        return out

    paired = per_read([r[0] for r in res])
    pcnt = per_read([r[1] for r in res])
    pdata, poff = gather_ranges([r[2] for r in res], [r[3] for r in res],
                                wave_of)
    ends = []
    for e in range(2):
        ed = [r[4][e] for r in res]
        m = {k: per_read([d[k] for d in ed]) for k in ("stat", "n0", "n1")}
        for k in ("hchr", "hloc", "hgsz", "hgpos", "hchain"):
            m[k], m["hoff"] = gather_ranges([d[k] for d in ed],
                                            [d["hoff"] for d in ed], wave_of)
        ends.append(m)
    return paired, pcnt, pdata, poff, ends


class PairEmitter:
    def __init__(self, params: AlignParams, ref: PackedReference, rng: MyRand,
                 rrbs_seglen=None):
        self.p = params
        self.ref = ref
        self.rng = rng
        self.rrbs_seglen = rrbs_seglen
        self.n_aligned_pairs = self.n_unique_pairs = self.n_multiple_pairs = 0
        self.n_aligned_a = self.n_unique_a = self.n_multiple_a = 0
        self.n_aligned_b = self.n_unique_b = self.n_multiple_b = 0

    # -- proper pair record (s_OutHitPair, pairs.cpp:307-416) ------------
    def out_hit_pair(self, reads, Ls, pp: PairHit, n: int, out: List[str]):
        p = self.p
        chain, na, nb, insert, ha, hb = pp
        ends = ((reads[0], Ls[0], ha, hb, na, chain),
                (reads[1], Ls[1], hb, ha, nb, 1 - chain))
        for read, L, h, mate_h, nm, ch in ends:
            rev = ch ^ (h[0] % 2)
            flag = 0x3
            if n > 1:
                flag |= 0x100
            if rev:
                flag |= 0x10
                pp_insert = -insert
            else:
                flag |= 0x20
                pp_insert = insert
            flag |= 0x40 * read.readset
            cig = _cigar(L, h[2], h[3])
            seq = revcomp(read.seq) if rev else read.seq
            qual = read.qual[::-1] if rev else read.qual
            name = self.ref.titles[h[0] >> 1].name
            rec = (f"{read.name}\t{flag}\t{name}\t{h[1] + 1}\t255\t{cig}\t=\t"
                   f"{mate_h[1] + 1}\t{pp_insert}\t{seq}\t{qual}\tNM:i:{nm}")
            if p.out_ref:
                rec += f"\tXR:Z:{_xr_context(self.ref, p, h[0], h[1], L)}"
            if self.rrbs_seglen is not None:
                # RRBS PE: ZP = leftmost mate pos, ZL = insert
                # (s_OutHitPair, pairs.cpp:355-358)
                seg_start = (mate_h[1] + 1) if rev else (h[1] + 1)
                rec += f"\tZP:i:{seg_start}\tZL:i:{insert}"
            rec += f"\tZS:Z:{CHAIN_FLAG[h[0] % 2]}{CHAIN_FLAG[ch]}\n"
            out.append(rec)

    # -- unpaired-end record (s_OutHitUnpair, pairs.cpp:418-485) ---------
    def out_hit_unpair(self, read, L, chain_a: int, chain_b: int, ma: int,
                       na: int, ha: Optional[Hit], mb: int, hb: Optional[Hit],
                       out: List[str]):
        p = self.p
        flag = 1 | 0x40 * read.readset
        if ma <= 0:
            if not p.out_unmap:
                return
            if ma < 0:
                flag |= 0x204
            if ma == 0:
                flag |= 0x004
            if mb <= 0:
                flag |= 0x008
                out.append(f"{read.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t"
                           f"{read.seq}\t{read.qual}\n")
            else:
                if chain_b ^ (hb[0] % 2):
                    flag |= 0x020
                mname = self.ref.titles[hb[0] >> 1].name
                out.append(f"{read.name}\t{flag}\t*\t0\t0\t*\t{mname}\t"
                           f"{hb[1] + 1}\t0\t{read.seq}\t{read.qual}\n")
            return
        rev_seq = chain_a ^ (ha[0] % 2)
        if ma > 1:
            flag |= 0x100
        if rev_seq:
            flag |= 0x010
        cig = _cigar(L, ha[2], ha[3])
        seq = revcomp(read.seq) if rev_seq else read.seq
        qual = read.qual[::-1] if rev_seq else read.qual
        name = self.ref.titles[ha[0] >> 1].name
        if mb <= 0:
            flag |= 0x008
            rec = (f"{read.name}\t{flag}\t{name}\t{ha[1] + 1}\t255\t{cig}\t*\t"
                   f"0\t0\t{seq}\t{qual}\tNM:i:{na}")
        else:
            if chain_b ^ (hb[0] % 2):
                flag |= 0x020
            mname = self.ref.titles[hb[0] >> 1].name
            rec = (f"{read.name}\t{flag}\t{name}\t{ha[1] + 1}\t255\t{cig}\t"
                   f"{mname}\t{hb[1] + 1}\t0\t{seq}\t{qual}\tNM:i:{na}")
        if p.out_ref:
            rec += f"\tXR:Z:{_xr_context(self.ref, p, ha[0], ha[1], L)}"
        if self.rrbs_seglen is not None:
            zp, zl = self.rrbs_seglen(ha[0], ha[1], L)
            rec += f"\tZP:i:{zp}\tZL:i:{zl}"
        rec += f"\tZS:Z:{CHAIN_FLAG[ha[0] % 2]}{CHAIN_FLAG[chain_a]}\n"
        out.append(rec)

    # -- StringAlignPair (pairs.cpp:204-230) -----------------------------
    def emit_pair(self, reads, Ls, pairhits, read_index: int,
                  out: List[str]) -> int:
        p = self.p
        for i in range(2 * MAXSNPS + 1):
            cnt = len(pairhits[i])
            if cnt > 0:
                break
        else:
            return 0
        if cnt == 0:
            return 0
        if cnt == 1:
            self.n_unique_pairs += 1
            self.n_aligned_pairs += 1
            self.out_hit_pair(reads, Ls, pairhits[i][0], 1, out)
            return 1
        self.n_multiple_pairs += 1
        if p.report_repeat_hits == 1:
            self.n_aligned_pairs += 1
            j = self.rng(read_index) % cnt
            self.out_hit_pair(reads, Ls, pairhits[i][j], cnt, out)
            return 1
        if p.report_repeat_hits == 2:
            self.n_aligned_pairs += 1
            for j in range(cnt):
                self.out_hit_pair(reads, Ls, pairhits[i][j], cnt, out)
            return 1
        return 0

    # -- StringAlignUnpair (pairs.cpp:232-305) ---------------------------
    def emit_unpair(self, reads, Ls, results, rms2, filters, out: List[str]):
        """``results``: per-end ReadResult (or None when filtered);
        ``rms2``: per-end read_max_snp."""
        p = self.p
        picks = []
        for end in range(2):
            if filters[end]:
                picks.append((-1, 0, None, 0))
                continue
            res = results[end]
            m = res.nhits
            if m > 0:
                rr = self.rng(reads[end].index) % m
                n0 = len(res.hits0)
                if rr < n0:
                    c, h = 0, res.hits0[rr]
                else:
                    c, h = 1, res.hits1[rr - n0]
                picks.append((m, res.stratum % (rms2[end] + 1), h, c))
            else:
                picks.append((0, 0, None, 0))
        (ma, na, ha, ca), (mb, nb, hb, cb) = picks
        ma1 = 0 if (ma > 1 and p.report_repeat_hits == 0) else ma
        mb1 = 0 if (mb > 1 and p.report_repeat_hits == 0) else mb

        for end, (m, n_, h, c), (om1, oh, oc) in (
                (0, picks[0], (mb1, hb, cb)), (1, picks[1], (ma1, ha, ca))):
            read, L = reads[end], Ls[end]
            res = results[end]
            if m <= 0:
                if p.out_unmap:
                    self.out_hit_unpair(read, L, 0, oc, m, 0, h, om1, oh, out)
            elif m == 1:
                if end == 0:
                    self.n_aligned_a += 1
                    self.n_unique_a += 1
                else:
                    self.n_aligned_b += 1
                    self.n_unique_b += 1
                self.out_hit_unpair(read, L, c, oc, 1, n_, h, om1, oh, out)
            else:
                if end == 0:
                    self.n_multiple_a += 1
                else:
                    self.n_multiple_b += 1
                if p.report_repeat_hits == 1:
                    if end == 0:
                        self.n_aligned_a += 1
                    else:
                        self.n_aligned_b += 1
                    self.out_hit_unpair(read, L, c, oc, m, n_, h, om1, oh, out)
                elif p.report_repeat_hits == 2:
                    if end == 0:
                        self.n_aligned_a += 1
                    else:
                        self.n_aligned_b += 1
                    for hh in res.hits0:
                        self.out_hit_unpair(read, L, 0, oc, m, n_, hh, om1, oh, out)
                    for hh in res.hits1:
                        self.out_hit_unpair(read, L, 1, oc, m, n_, hh, om1, oh, out)
                elif p.out_unmap:
                    self.out_hit_unpair(read, L, 0, oc, 0, 0, h, om1, oh, out)


class PairEndAligner:
    def __init__(self, params: AlignParams, ref: PackedReference, index,
                 use_native=None):
        self.p = params
        self.ref = ref
        self.index = index
        self.rng = MyRand(params.randseed)
        self.sched_a = SeedScheduler(params, index, self.rng)
        self.sched_b = SeedScheduler(params, index, self.rng)
        # (_stale_seeds: see align.pipeline.SingleEndAligner._stale_seeds)
        self._dev = None  # lazy: host-eval runs must never claim a device
        self._bufs = [None, None]  # per-end ladder buffers, reused
        self.nt_hint = 0  # C++ thread width (0 = all cores); see SE runner
        self.replayer = Replayer(params, ref, self.rng)
        rrbs_fn = None
        if params.rrbs_flag:
            from ..index.rrbs import ccgg_seglen
            rrbs_fn = (lambda c, l, L: ccgg_seglen(index, c, l, L))
        self.emitter = PairEmitter(params, ref, self.rng, rrbs_seglen=rrbs_fn)
        from ..native import NativeBatch, native_available
        if use_native is None:
            use_native = native_available() and params.randseed != 0
        self.native_a = NativeBatch(params, index, ref) if use_native else None
        self.native_b = NativeBatch(params, index, ref) if use_native else None
        self.pe_formatter = None
        if self.native_a is not None:
            from ..native import NativePairFormatter
            self.pe_formatter = NativePairFormatter(
                params, ref,
                rrbs_index=index if params.rrbs_flag else None)
        # per-stage cost anatomy (printed at -V 2; SE twin in
        # align/pipeline.py keeps the richer ladder counters)
        self.stage = {"cand_enum": 0, "cand_host": 0, "cand_device": 0,
                      "batches_lazy": 0, "batches_bulk": 0,
                      "batches_split": 0, "ladder_waves": 0}
        self.total_reads = 0       # pairs processed (THP trigger, see SE)
        self._thp_started = False
        import os
        if os.environ.get("BASAL_THP") == "1":
            from ..native import collapse_index_tables
            collapse_index_tables(index, ref)
            self._thp_started = True

    def pair_stats(self):
        """(aligned, unique, multiple) pairs merged across the Python
        emitter and the native PE formatter."""
        e = self.emitter
        a, u, m = e.n_aligned_pairs, e.n_unique_pairs, e.n_multiple_pairs
        if self.pe_formatter is not None:
            c = self.pe_formatter.counters
            a += int(c[0])
            u += int(c[1])
            m += int(c[2])
        return a, u, m

    @property
    def dev(self):
        """Device context, created on first device dispatch (see the SE
        aligner: host-SIMD-evaluated runs never attach an accelerator)."""
        if self._dev is None:
            import jax
            if len(jax.devices()) > 1:
                from ..parallel.mesh import make_sharded_context
                self._dev = make_sharded_context(self.ref, self.p)
            if self._dev is None:
                self._dev = DeviceContext(self.ref, self.p)
        return self._dev

    # volume guard for the eager PE tables; BASAL_PE_SPLIT_CANDS
    # overrides (A/B'd on the repeat profile — see PERF.md)
    MAX_BATCH_CANDS = int(os.environ.get("BASAL_PE_SPLIT_CANDS",
                                         30_000_000))

    def align_batch(self, reads_a, reads_b) -> bytes:
        p = self.p
        self.total_reads += len(reads_a)
        from ..align.pipeline import _maybe_start_thp
        _maybe_start_thp(self)
        # candidate-volume guard: repeat-heavy references can enumerate 10^4+
        # candidates per read; split the pair batch so the eager PE tables
        # stay bounded (the SE path uses lazy strata-ladder waves instead).
        # End a is encoded + group-built ONCE here and reused by the inner
        # pass (the old probe re-encoded the batch on copies, a visible
        # share of an easy-profile PE batch); splitting restores the scheduler state
        # and the pre-trim seq/qual references, then re-encodes per slice.
        if (len(reads_a) > 512 and self.native_a is not None
                and not p.rrbs_flag):  # RRBS builds its own (bounded)
            # eager fragment candidates in _align_batch_native
            from ..reads.io import RawBatch
            raw = isinstance(reads_a, RawBatch)
            ridx = (reads_a.indices if raw else
                    np.array([r.index for r in reads_a], dtype=np.uint32))
            # strings are immutable: keeping references restores the
            # pre-trim state exactly; RawBatch buffers are never mutated
            orig = None if raw else [(r.seq, r.qual) for r in reads_a]
            state0 = self.native_a.state.copy()
            sst0 = self.native_a.seed_state.copy()
            rst0 = self.native_a.reg_state.copy()
            enc_a = encode_batch(p, reads_a)
            ens = getattr(self.index, "ensure_batch", None)
            if ens is not None:
                ens(enc_a, extra=self._stale_seeds(self.native_a,
                                                   self.sched_a))
            groups, goff, total = self.native_a.build_groups(enc_a, ridx)
            if (total and host_eval_policy(p, total)) \
                    or total <= self.MAX_BATCH_CANDS:
                # lazy visit-time scans bound evaluated volume themselves;
                # eager tables fit: proceed with the already-built end a
                return self._align_batch_inner(
                    reads_a, reads_b, pre_a=(enc_a, groups, goff, total))
            self.stage["batches_split"] += 1
            self.native_a.state[:] = state0
            self.native_a.seed_state[:] = sst0
            self.native_a.reg_state[:] = rst0
            if orig is not None:
                for r, (s, q) in zip(reads_a, orig):
                    r.seq, r.qual = s, q
            n_split = -(-int(total) // self.MAX_BATCH_CANDS)
            step = max(256, len(reads_a) // n_split)
            out = []
            for i in range(0, len(reads_a), step):
                out.append(self._align_batch_inner(
                    reads_a[i:i + step], reads_b[i:i + step]))
            return b"".join(out)
        return self._align_batch_inner(reads_a, reads_b)

    @staticmethod
    def _stale_seeds(nb, sched):
        st = nb.seed_state if nb is not None else sched.seed_state
        return st.reshape(-1)

    def _align_batch_inner(self, reads_a, reads_b, pre_a=None) -> bytes:
        p = self.p
        enc_a = pre_a[0] if pre_a is not None else encode_batch(p, reads_a)
        enc_b = encode_batch(p, reads_b)
        ens = getattr(self.index, "ensure_batch", None)
        if ens is not None:  # shard-resident index: routed fetch per mate
            if pre_a is None:
                ens(enc_a, extra=self._stale_seeds(self.native_a,
                                                   self.sched_a))
            ens(enc_b, extra=self._stale_seeds(self.native_b,
                                               self.sched_b))
        if self.native_a is not None:
            return self._align_batch_native(
                enc_a, enc_b,
                built_a=None if pre_a is None else pre_a[1:])
        res = []
        for enc, sched in ((enc_a, self.sched_a), (enc_b, self.sched_b)):
            if p.rrbs_flag:
                from ..align.candidates import build_candidates_rrbs
                table = build_candidates_rrbs(p, self.index, self.ref, enc,
                                              sched)
            else:
                table = build_candidates(p, self.index, enc, sched)
            if table.loc.size:
                counts, pos0, pos1 = self.dev.extend(
                    enc, table.loc, table.plane, table.row)
            else:
                counts, pos0, pos1 = np.zeros(0, np.int32), None, None
            res.append((table, counts, pos0, pos1))
        scans_a = self.replayer.scans(enc_a, *res[0])
        scans_b = self.replayer.scans(enc_b, *res[1])

        out: List[str] = []
        pair_reported = 0
        for i in range(len(reads_a)):
            ra, rb = reads_a[i], reads_b[i]
            fa, fb = bool(enc_a.filtered[i]), bool(enc_b.filtered[i])
            ra.name, rb.name = fix_pair_read_name(ra.name, rb.name)
            La, Lb = int(enc_a.map_len[i]), int(enc_b.map_len[i])
            sa, sb = scans_a[i], scans_b[i]
            pairhits = [[] for _ in range(2 * MAXSNPS + 1)]
            if not fa and not fb:
                paired = lockstep_align(p, sa, sb, pairhits)
            else:
                paired = 0
                if not fa:
                    sa.run_all()
                if not fb:
                    sb.run_all()
            if paired:
                pair_reported = self.emitter.emit_pair(
                    (ra, rb), (La, Lb), pairhits, ra.index, out)
            if pair_reported == 0 or paired == 0:
                results = (None if fa else sa.result(),
                           None if fb else sb.result())
                self.emitter.emit_unpair(
                    (ra, rb), (La, Lb), results,
                    (int(enc_a.read_max_snp[i]), int(enc_b.read_max_snp[i])),
                    (fa, fb), out)
        return "".join(out).encode("latin1")

    def _pe_lazy(self, built):
        """Lazy PE evaluation: ONE lockstep replay where EVERY candidate is
        evaluated at visit time inside the C++ scan (counts_off -1 + the
        EvalCtx tables) — the scan's w-caps/pigeonhole stops bound the
        evaluated volume exactly like the reference's per-candidate
        extension.  The ungapped path once bulk-materialized and
        host-evaluated the mode-0 groups first; the all-visit-time scan
        was faster on the random profile (cache-hot, no candidate
        buffers) and byte-identical — the same trade the SE
        fused path (bt_align_se_host) makes.  BASAL_PE_BULK0=1
        restores the bulk mode-0 pass."""
        from ..native import replay_pe
        p = self.p
        enc_a, enc_b = built[0][0], built[1][0]
        B = len(enc_a.reads)
        bulk0 = os.environ.get("BASAL_PE_BULK0", "0") == "1"
        st = []
        for enc, nat, groups, goff in built:
            ng = groups.shape[0]
            off = np.full(ng, -1, np.int64)
            if p.gap > 0 or not bulk0:
                # visit-time everything (gapped has no fused fill+eval
                # position lists anyway; gap_align_ev computes
                # MismatchPattern0/1 lazily under the scan's snp_thres
                # aborts, like the reference's GapAlign, align.cpp:348-410)
                st.append((np.zeros(0, np.int32), np.zeros(0, np.int32),
                           off))
                continue
            sel = np.flatnonzero(groups[:, 2] < 1)
            n0 = int(groups[sel, 6].sum())
            locb = np.empty(n0, np.int32)
            cntb = np.empty(n0, np.int32)
            if n0:
                self.stage["cand_host"] += n0
                nat.fill_eval_groups(enc, self.ref, groups, sel, off, 0,
                                     locb, cntb, n_threads=self.nt_hint)
            st.append((locb, cntb, off))
        out1 = replay_pe(
            p, self.ref,
            enc_a, (st[0][0], None, None, built[0][2], built[0][3]),
            (st[0][1], None, None),
            enc_b, (st[1][0], None, None, built[1][2], built[1][3]),
            (st[1][1], None, None),
            counts_off_a=st[0][2], counts_off_b=st[1][2], index=self.index,
            n_threads=self.nt_hint)
        return [(np.ones(B, bool), out1)]

    def _pe_rrbs_native(self, enc_a, enc_b):
        """RRBS PE through the native engine: C++ fragment-index candidate
        build (bt_build_candidates_rrbs, per end) + host-SIMD evaluation +
        the C++ lockstep replay carrying per-candidate plane/skip (RRBS
        entries land on either strand).  Byte-identical to the pure-Python
        lockstep (test_differential_rrbs.py PE cases + fuzz);
        BASAL_NO_NATIVE=1 reverts."""
        from ..native import (host_eval_candidates, host_eval_candidates_gap,
                              replay_pe)
        from ..reads.io import RawBatch
        p = self.p
        B = len(enc_a.reads)
        built = []
        for enc, nat in ((enc_a, self.native_a), (enc_b, self.native_b)):
            ridx = (enc.reads.indices if isinstance(enc.reads, RawBatch)
                    else np.array([r.index for r in enc.reads],
                                  dtype=np.uint32))
            groups, goff, loc, plane, skip, row, total = \
                nat.build_candidates_rrbs(enc, ridx, self.index)
            self.stage["cand_enum"] += total
            pos0 = pos1 = None
            if total and p.gap > 0:
                counts, pos0, pos1 = host_eval_candidates_gap(
                    p, self.ref, enc, loc, plane, row,
                    n_threads=self.nt_hint)
                self.stage["cand_host"] += total
            elif total:
                counts = host_eval_candidates(
                    p, self.ref, enc, loc, plane, row,
                    n_threads=self.nt_hint)
                self.stage["cand_host"] += total
            else:
                counts = np.zeros(0, np.int32)
            built.append(((loc, None, None, groups, goff),
                          (counts, pos0, pos1), (plane, skip)))
        self.stage["batches_bulk"] += 1
        out1 = replay_pe(p, self.ref,
                         enc_a, built[0][0], built[0][1],
                         enc_b, built[1][0], built[1][1],
                         n_threads=self.nt_hint,
                         rr_a=built[0][2], rr_b=built[1][2])
        return [(np.ones(B, bool), out1)]

    def _align_batch_native(self, enc_a, enc_b, built_a=None) -> bytes:
        from ..align.replay import ReadResult
        from ..native import replay_pe
        p = self.p
        B = len(enc_a.reads)
        if p.rrbs_flag:
            waves = self._pe_rrbs_native(enc_a, enc_b)
            return self._emit_pe_waves(enc_a, enc_b, waves)
        built = []
        total_all = 0
        for enc, nat in ((enc_a, self.native_a), (enc_b, self.native_b)):
            if enc is enc_a and built_a is not None:
                groups, goff, total = built_a
            else:
                from ..reads.io import RawBatch
                ridx = (enc.reads.indices
                        if isinstance(enc.reads, RawBatch)
                        else np.array([r.index for r in enc.reads],
                                      dtype=np.uint32))
                groups, goff, total = nat.build_groups(enc, ridx)
            built.append((enc, nat, groups, goff))
            total_all += int(total)

        self.stage["cand_enum"] += total_all
        if total_all and host_eval_policy(p, total_all):
            self.stage["batches_lazy"] += 1
            waves = self._pe_lazy(built)
        else:
            self.stage["batches_bulk"] += 1
            waves = self._pe_ladder(
                built, 1 if total_all > self.EAGER_MAX_CANDS else 99)
        return self._emit_pe_waves(enc_a, enc_b, waves)

    # as SingleEndAligner.EAGER_MAX_CANDS: above this many enumerated
    # candidates a bulk batch climbs the strata ladder
    EAGER_MAX_CANDS = 2_000_000

    def _evaluate(self, enc, loc, plane, row):
        """(counts i32, pos0, pos1) of one end's wave: host SIMD evaluation
        (the gapped variant returns the i16 position lists the gapped
        replay consumes) or the device kernel."""
        from ..native import host_eval_candidates, host_eval_candidates_gap
        p = self.p
        if host_eval_policy(p, loc.size):
            self.stage["cand_host"] += loc.size
            if p.gap > 0:
                c, p0, p1 = host_eval_candidates_gap(
                    p, self.ref, enc, loc, plane, row,
                    n_threads=self.nt_hint)
                return c.astype(np.int32), p0, p1
            return (host_eval_candidates(p, self.ref, enc, loc, plane, row,
                                         n_threads=self.nt_hint)
                    .astype(np.int32), None, None)
        self.stage["cand_device"] += loc.size
        return self.dev.extend(enc, loc, plane.astype(np.int32), row)

    def _pe_ladder(self, built, lim):
        """Bulk PE evaluation as a strata ladder (the SE ladder's twin):
        evaluate both ends' groups of modes < lim, run the lockstep replay
        with mode_limit lim, then evaluate mode lim of the pairs it reports
        incomplete (paired -2), and repeat.  On a repeat-rich reference most
        pairs resolve at mode 0, so the modes past a pair's resolution are
        never materialized.  lim >= 99 is one eager wave."""
        from ..align.pipeline import _LadderBuffers
        from ..native import replay_pe
        p = self.p
        enc_a, enc_b = built[0][0], built[1][0]
        B = len(enc_a.reads)
        done = np.zeros(B, bool)
        self._bufs = [_LadderBuffers.reuse(
            old, int(g[:, 6].sum()) if p.gap > 0 else 1 << 20, p.gap)
            for old, (_, _, g, _) in zip(self._bufs, built)]
        ends = [(enc, nat, groups, goff,
                 np.full(groups.shape[0], -1, np.int64), bufs)
                for (enc, nat, groups, goff), bufs in zip(built, self._bufs)]
        sel_modes = lambda g: g[:, 2] < lim
        waves = []
        while True:
            for enc, nat, groups, goff, off, bufs in ends:
                sel = np.flatnonzero(sel_modes(groups) & ~done[groups[:, 0]])
                loc, plane, row = nat.fill_groups(enc, groups, sel, off,
                                                  base=bufs.n)
                if loc.size:
                    bufs.append(loc, *self._evaluate(enc, loc, plane, row))
            (ea, na, ga, oa_, offa, ba), (eb, nb, gb, ob_, offb, bb) = ends
            out = replay_pe(
                p, self.ref,
                ea, (ba.loc, None, None, ga, oa_), (ba.cnt, ba.pos0, ba.pos1),
                eb, (bb.loc, None, None, gb, ob_), (bb.cnt, bb.pos0, bb.pos1),
                mode_limit=lim, counts_off_a=offa, counts_off_b=offb,
                filtered_a=ea.filtered | done, filtered_b=eb.filtered | done,
                n_threads=self.nt_hint)
            self.stage["ladder_waves"] += 1
            incomplete = out[0] == -2
            newly = ~incomplete & ~done
            waves.append((newly, out))
            done |= newly
            if not incomplete.any():
                return waves
            sel_modes = (lambda m: lambda g: g[:, 2] == m)(lim)
            lim += 1

    def _emit_pe_waves(self, enc_a, enc_b, waves) -> bytes:
        from ..align.replay import ReadResult
        B = len(enc_a.reads)
        if self.pe_formatter is not None:
            paired, _pcnt, pdata, poff, ends = merge_pe_waves(waves, B)
            s = self.pe_formatter.format(enc_a, enc_b, paired, pdata, poff,
                                         ends, n_threads=self.nt_hint)
            if s is not None:
                return s
            # None = FixPairReadName mismatch: the Python path below
            # raises with the exact reference message

        wave_of = wave_of_reads(waves, B)

        def end_result(e, i):
            if e["stat"][i] < 0:
                return None
            a, b = int(e["hoff"][i]), int(e["hoff"][i + 1])
            hits = [(int(e["hchr"][j]), int(e["hloc"][j]), int(e["hgsz"][j]),
                     int(e["hgpos"][j])) for j in range(a, b)]
            k0 = int(e["n0"][i])
            return ReadResult(filtered=False, stratum=int(e["stat"][i]),
                              nhits=b - a, hits0=hits[:k0], hits1=hits[k0:])

        out: List[str] = []
        pair_reported = 0
        for i in range(len(enc_a.reads)):
            # read i's outputs live in the wave that resolved it
            paired, pcnt, pdata, poff, ends = waves[wave_of[i]][1]
            ra, rb = enc_a.reads[i], enc_b.reads[i]
            fa, fb = bool(enc_a.filtered[i]), bool(enc_b.filtered[i])
            ra.name, rb.name = fix_pair_read_name(ra.name, rb.name)
            La, Lb = int(enc_a.map_len[i]), int(enc_b.map_len[i])
            if paired[i]:
                pairhits = [[] for _ in range(2 * MAXSNPS + 1)]
                a0, b0 = int(poff[i]), int(poff[i + 1])
                if b0 > a0:
                    d0 = pdata[a0]
                    bucket = int(d0[1]) + int(d0[2])
                    for j in range(a0, b0):
                        d = pdata[j]
                        pairhits[bucket].append((
                            int(d[0]), int(d[1]), int(d[2]), int(d[3]),
                            (int(d[4]), int(d[5]), int(d[6]), int(d[7])),
                            (int(d[8]), int(d[9]), int(d[10]), int(d[11]))))
                pair_reported = self.emitter.emit_pair(
                    (ra, rb), (La, Lb), pairhits, ra.index, out)
            if pair_reported == 0 or not paired[i]:
                results = (end_result(ends[0], i), end_result(ends[1], i))
                self.emitter.emit_unpair(
                    (ra, rb), (La, Lb), results,
                    (int(enc_a.read_max_snp[i]), int(enc_b.read_max_snp[i])),
                    (fa, fb), out)
        return "".join(out).encode("latin1")


class PairThreadedRunner:
    """-p worker pool for paired-end batches: each worker owns a full
    PairEndAligner (private scheduler/emitter state, like each reference
    pthread's PairAlign instance, main.cpp:94-130); output is written in
    batch order."""

    def __init__(self, params, ref, index, n_workers: int):
        import os
        from concurrent.futures import ThreadPoolExecutor
        self.aligners = [PairEndAligner(params, ref, index)
                         for _ in range(n_workers)]
        nt = max(1, len(os.sched_getaffinity(0)) // n_workers)
        for a in self.aligners:
            a.nt_hint = nt
        # Per-aligner single-thread executors: serialize batches that share
        # an aligner (see ThreadedRunner in align/pipeline.py).
        self.pools = [ThreadPoolExecutor(1) for _ in range(n_workers)]
        self.n = n_workers
        self.i = 0

    def submit(self, reads_a, reads_b):
        slot = self.i % self.n
        self.i += 1
        return self.pools[slot].submit(self.aligners[slot].align_batch,
                                       reads_a, reads_b)

    def counters(self):
        stats = [a.pair_stats() for a in self.aligners]
        return tuple(sum(s[k] for s in stats) for k in range(3))

    def shutdown(self):
        for p in self.pools:
            p.shutdown()


def _pe_stage_report(aligners) -> str:
    """-V 2 cost anatomy for PE runs (see align.pipeline.stage_report)."""
    keys = aligners[0].stage.keys()
    s = {k: sum(a.stage[k] for a in aligners) for k in keys}
    visit = s["cand_enum"] - s["cand_host"] - s["cand_device"]
    return (f"cost anatomy: {s['cand_enum']} candidates enumerated "
            f"| eval: device {s['cand_device']} host {s['cand_host']} "
            f"visit-time/lazy {max(visit, 0)} "
            f"| batches: lockstep-lazy {s['batches_lazy']} "
            f"bulk {s['batches_bulk']} (ladder waves {s['ladder_waves']}) "
            f"volume-split {s['batches_split']}")


def run_pair_end(params: AlignParams, ref_path: str, reads_a_path: str,
                 reads_b_path: str, out_fh=None,
                 command_line: str = "basal_jax", log=lambda *a: None,
                 index_factory=None, timings=None):
    from .. import malloc_window
    with malloc_window():
        return _run_pair_end(params, ref_path, reads_a_path, reads_b_path,
                             out_fh, command_line, log, index_factory,
                             timings)


def _run_pair_end(params, ref_path, reads_a_path, reads_b_path, out_fh,
                  command_line, log, index_factory, timings):
    t0 = time.time()
    ref = load_reference(ref_path, params)
    log(f"{ref.total_num} reference seqs loaded, total size {ref.sum_length} bp.")
    if timings is not None:
        timings["t_ref"] = time.time() - t0
    if index_factory is not None:
        # multi-host: shard-resident RoutedSeedIndex (parallel/multihost.py)
        index = index_factory(ref, params)
    elif params.rrbs_flag:
        from ..index.rrbs import build_rrbs_index
        index = build_rrbs_index(ref_path, ref, params)
    else:
        index = build_index(ref, params)
    log(f"create seed table. {time.time()-t0:.0f} secs passed")
    if timings is not None:
        timings["t_index"] = time.time() - t0 - timings["t_ref"]
        timings["t_align_start"] = time.time()
    aligner = PairEndAligner(params, ref, index)
    out_fh = out_fh or sys.stdout
    if params.sam_header:
        out_fh.write(sam_header(ref, params, command_line).encode('latin1'))
    rd_a = open_reads(reads_a_path, params, readset=1)
    rd_b = open_reads(reads_b_path, params, readset=2)
    if params.num_threads > 1 and params.randseed != 0 \
            and not params.rrbs_flag:
        from collections import deque
        runner = PairThreadedRunner(params, ref, index, params.num_threads)
        futures = deque()
        while True:
            a = rd_a.next_batch()
            b = rd_b.next_batch()
            ok = a and len(a) == len(b)
            if ok:
                futures.append(runner.submit(a, b))
            while futures and (not ok or len(futures) > runner.n):
                out_fh.write(futures.popleft().result())
                log(f"{rd_a.index - params.read_start + 1} read pairs "
                    f"finished.")
            if not ok:
                break
        runner.shutdown()
        n_al, n_un, n_mu = runner.counters()

        class _E:
            n_aligned_pairs, n_unique_pairs, n_multiple_pairs = \
                n_al, n_un, n_mu
        e = _E
        n = max(rd_a.index - params.read_start + 1, 1)
        log(f"total read pairs: {n} \ttotal time: "
            f"{time.time()-t0:.0f} secs")
        log(f"aligned pairs: {e.n_aligned_pairs} "
            f"({100.0*e.n_aligned_pairs/n:.1f}%), "
            f"unique pairs: {e.n_unique_pairs} "
            f"({100.0*e.n_unique_pairs/n:.1f}%), "
            f"non-unique pairs: {e.n_multiple_pairs} "
            f"({100.0*e.n_multiple_pairs/n:.1f}%)")
        log(_pe_stage_report(runner.aligners), 2)
        return runner.aligners[0]
    while True:
        a = rd_a.next_batch()
        b = rd_b.next_batch()
        if not a or len(a) != len(b):
            break
        out_fh.write(aligner.align_batch(a, b))
        log(f"{rd_a.index - params.read_start + 1} read pairs finished.")
    n_al, n_un, n_mu = aligner.pair_stats()

    class _E2:
        n_aligned_pairs, n_unique_pairs, n_multiple_pairs = n_al, n_un, n_mu
    e = _E2
    n = max(rd_a.index - params.read_start + 1, 1)
    log(f"total read pairs: {n} \ttotal time: {time.time()-t0:.0f} secs")
    log(f"aligned pairs: {e.n_aligned_pairs} ({100.0*e.n_aligned_pairs/n:.1f}%), "
        f"unique pairs: {e.n_unique_pairs} ({100.0*e.n_unique_pairs/n:.1f}%), "
        f"non-unique pairs: {e.n_multiple_pairs} ({100.0*e.n_multiple_pairs/n:.1f}%)")
    log(_pe_stage_report([aligner]), 2)
    return aligner
