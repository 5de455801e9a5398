"""Multi-host execution: jax.distributed + shard-resident k-mer index.

The reference has no distributed backend at all — its whole parallelism
story is a single-node pthread pool (main.cpp:56-130) plus manual -B/-E
read-range sharding across independent invocations.  The JAX
scale-out (SURVEY §2.4, §5 "Distributed communication backend") adds:

* **Read-shard data parallelism across hosts**: each process aligns a
  contiguous global-read-index window (the same windows `-B/-E` would
  describe, so per-read RNG and scheduler semantics match the reference's
  own sharding story exactly).  Output is the byte-concatenation of the
  per-host SAM bodies.

* **Shard-resident k-mer-range seed index** (`RoutedSeedIndex`): each host
  builds ONLY its k-mer range of the seed table (`index.sharded.build_shard`)
  — no host ever materializes the dense index (`gather()` is never called).
  Per batch, the set of seed values the batch can probe (`enc.seedval` holds
  the value at every start offset, reads/encode.py) is routed to the owning
  shards in ONE batched exchange round: an all-gather of per-host query
  lists, followed by an all-gather of per-owner reply tables
  (count/n1/locs per queried k-mer).  Queries are answered by k-mer range —
  routing is a static function of the seed value, so there is no broadcast
  of positions, only of the (small) query keys.  All-gathers ride DCN via
  jax's cross-process collectives (`multihost_utils.process_allgather`),
  exactly the backend SURVEY §5 prescribes.

* **rs-sharded extension mesh spanning hosts**: `make_multihost_mesh`
  arranges the global device set so the reference-shard axis (`rs`) spans
  processes — each host holds its reference shard in device memory and the
  `lax.pmin` merge of `parallel.mesh._sharded_extend` rides DCN.  Because
  the dp axis stays within a process, every host can assemble the full
  extension output from its addressable shards (no output gather).

Determinism: the per-batch routed table contains exactly the same
(count, n1, locs) values the dense single-host index holds for every seed
value the batch probes, so the downstream scan replay is bit-identical;
merged multi-host SAM equals the single-host run whenever no read hits the
stale-scheduler-state quirk ((L-I+1)%s == 0, align.h:73 leak — see
native/engine.cpp:1487), and always equals a reference run with the same
-B/-E windows.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from ..config import AlignParams
from ..index.reference import PackedReference
from ..index.seedindex import _kmer_cutoff
from ..index.sharded import IndexShard, build_shard


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   local_devices: Optional[int] = None) -> None:
    """Initialize jax.distributed for a multi-process run.  Must be called
    before any other jax API.  ``local_devices`` forces a CPU device count
    (simulation); on hosts with accelerators leave it None."""
    if local_devices is not None:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={local_devices}"
        ).strip()
    import jax
    if local_devices is not None:
        jax.config.update("jax_platforms", "cpu")
    from ..compile_cache import enable_compile_cache
    enable_compile_cache()  # the routing collectives compile once per cache
    jax.distributed.initialize(coordinator, num_processes=num_processes,
                               process_id=process_id)


class _RoundResult(object):
    __slots__ = ("finished", "any_queries")

    def __init__(self, finished: bool, any_queries: bool):
        self.finished = finished
        self.any_queries = any_queries


def _allgather_ragged(x: np.ndarray) -> List[np.ndarray]:
    """All-gather a variable-length 1-D array from every process (two fixed
    collectives: sizes, then max-padded payload)."""
    import jax
    from jax.experimental import multihost_utils as mhu
    nproc = jax.process_count()
    if nproc == 1:
        return [np.asarray(x)]
    n = int(x.shape[0])
    sizes = np.asarray(mhu.process_allgather(np.array([n], np.int64)))
    sizes = sizes.reshape(nproc)
    # pow2 bucket padding: stable shapes -> the allgather XLA program is
    # compiled once per bucket, not once per round
    m = 1 << (max(int(sizes.max()), 1) - 1).bit_length()
    pad = np.zeros(m, x.dtype)
    pad[:n] = x
    full = np.asarray(mhu.process_allgather(pad)).reshape(nproc, m)
    return [full[p, :int(sizes[p])] for p in range(nproc)]


class RoutedSeedIndex:
    """SeedIndex-compatible facade whose entries are fetched on demand from
    k-mer-range shards resident on their owning hosts.

    Exposes dense ``starts/counts/n1/locs/max_kmer_num`` (the exact fields
    NativeBatch / SeedScheduler consume) but fills them cumulatively, one
    batched routing round per read batch (``ensure_batch``).  Entries are
    value-identical to the dense single-host index for every k-mer ever
    queried; unqueried k-mers are never read by the scan (every index access
    goes through the batch's own ``enc.seedval``).  Cumulative filling keeps
    the two-deep overlapped pipeline safe: batch k's ladder waves reuse
    entries batch k requested even after batch k+1's round ran.
    """

    def __init__(self, ref: PackedReference, params: AlignParams,
                 num_shards: Optional[int] = None,
                 shard_id: Optional[int] = None):
        import jax
        self.params = params
        nproc = num_shards if num_shards is not None else jax.process_count()
        pid = shard_id if shard_id is not None else jax.process_index()
        self.nproc = nproc
        self.pid = pid
        nk = params.total_kmers
        per = -(-nk // nproc)
        self.bounds = np.minimum(np.arange(nproc + 1, dtype=np.int64) * per,
                                 nk)
        self.shard: IndexShard = build_shard(
            ref, params, int(self.bounds[pid]), int(self.bounds[pid + 1]))
        # Dense per-batch tables, filled for queried k-mers only.  starts is
        # np.empty on purpose: a slot is dereferenced by the scan only when
        # counts[k] > 0, and every such slot is written by _fill first.
        # Pages are pre-touched HERE (hugepages where available): the first
        # scatter into ~270 MB of untouched tables costs seconds of soft
        # page faults on this class of VM, which would land inside the
        # timed align phase instead of table allocation.
        self.starts = np.empty(nk, dtype=np.int64)
        self.counts = np.zeros(nk, dtype=np.int32)
        self.n1 = np.zeros(nk, dtype=np.int32)
        self._have = np.zeros(nk, dtype=bool)
        try:
            from ..native import madvise_hugepage
            for a in (self.starts, self.counts, self.n1, self._have):
                madvise_hugepage(a)
        except Exception:  # noqa: BLE001 - advisory only
            pass
        for a in (self.starts, self.counts, self.n1, self._have):
            a.reshape(-1)[::512] = 0  # touch every page once
        self._locs = np.zeros(1024, dtype=np.uint32)
        self._locs_n = 0
        # stats for the scaling report
        self.exchanged_queries = 0
        self.exchanged_locs = 0
        self.rounds = 0
        self.t_exchange = 0.0  # wall in _round (incl. blocked-on-peer)
        self.t_wait = 0.0      # ALIGN-thread wall blocked on a routing
                               # reply (ensure_batch wait / wait_batch) —
                               # the protocol's critical-path cost
        self.t_phase = {"status": 0.0, "qgather": 0.0, "answer": 0.0,
                        "rgather": 0.0, "parse": 0.0, "f_locs": 0.0,
                        "f_scatter": 0.0, "f_have": 0.0}
        # global over-representation cutoff: shards exchange their occurring
        # k-mer count multisets (small), as refbase.cpp:362-363's quantile
        # demands — same collective build_sharded_index does in-process.
        nz = np.flatnonzero(self.shard.counts)
        uk_all = _allgather_ragged((nz + self.shard.kmer_lo).astype(np.int64))
        uc_all = _allgather_ragged(self.shard.counts[nz].astype(np.int64))
        uk = np.concatenate(uk_all) if uk_all else np.zeros(0, np.int64)
        uc = np.concatenate(uc_all) if uc_all else np.zeros(0, np.int64)
        self.max_kmer_num = _kmer_cutoff(params, uk, uc)

    @property
    def locs(self) -> np.ndarray:
        return self._locs

    # -- routing ---------------------------------------------------------

    def _answer_one(self, q: np.ndarray):
        """Owner side, one requester list: the slice of ``q`` in our k-mer
        range, reduced to k-mers that actually occur.  Returns
        (idx positions of occurring k-mers within the in-range sublist,
        counts, n1, concatenated locs) — absent k-mers are implied by
        omission, which keeps the reply proportional to real index content
        instead of the query volume."""
        sh = self.shard
        lo, hi = sh.kmer_lo, sh.kmer_hi
        sub = q[(q >= lo) & (q < hi)] - lo
        idx = np.flatnonzero(sh.counts[sub] > 0).astype(np.int32)
        kk = sub[idx]
        c = sh.counts[kk]
        tot = int(c.sum())
        if tot:
            st = sh.starts[kk]
            # vectorized multi-slice CSR gather
            off = np.concatenate([[0], np.cumsum(c[:-1])])
            pos = np.arange(tot, dtype=np.int64)
            seg = np.searchsorted(np.cumsum(c), pos, side="right")
            locs = sh.locs[st[seg] + (pos - off[seg])]
        else:
            locs = np.zeros(0, np.uint32)
        return idx, c, sh.n1[kk], locs

    def _fill(self, sub_all: np.ndarray, idx: np.ndarray, cnts: np.ndarray,
              n1s: np.ndarray, locs: np.ndarray) -> None:
        """Install a reply: ``sub_all`` is the full queried sublist (marked
        present), ``idx`` selects its occurring k-mers.  Only occurring
        entries are scatter-written — the calloc zero pages stand in for
        the absent majority."""
        import time
        tp = self.t_phase
        t = time.time()
        tot = int(cnts.sum())
        need = self._locs_n + tot
        if need > len(self._locs):
            cap = max(need, 2 * len(self._locs))
            nl = np.empty(cap, dtype=np.uint32)
            nl[:self._locs_n] = self._locs[:self._locs_n]
            self._locs = nl
        if tot:
            self._locs[self._locs_n:need] = locs
        tp["f_locs"] += time.time() - t
        t = time.time()
        if len(idx):
            kk = sub_all[idx]
            self.starts[kk] = self._locs_n + np.concatenate(
                [[0], np.cumsum(cnts[:-1], dtype=np.int64)])
            self.counts[kk] = cnts
            self.n1[kk] = n1s
        tp["f_scatter"] += time.time() - t
        t = time.time()
        self._have[sub_all] = True
        tp["f_have"] += time.time() - t
        self._locs_n = need

    def _round(self, q: np.ndarray, done: bool) -> "_RoundResult":
        """One collective routing round.  Every process participates in the
        same sequence of all-gathers (status, queries, reply headers, reply
        payloads); a process whose read window is exhausted keeps serving
        with ``done=True`` and an empty query list until every peer reports
        done.  Returns a _RoundResult (finished = ALL processes done,
        any_queries = any process carried queries this round)."""
        import time
        from jax.experimental import multihost_utils as mhu
        t0 = time.time()
        try:
            return self._round_inner(q, done, mhu)
        finally:
            self.t_exchange += time.time() - t0

    def _round_inner(self, q, done, mhu):
        """4 collectives per round (was 8): the fixed-latency cost of the
        cross-process backend is per-collective, so status+query-size merge
        into one small header all-gather, and each owner's reply meta+locs
        merge into one u32 payload sized by a combined reply header.
        Rounds where NO process has queries skip the payload collectives
        entirely (drain heartbeats are a single [2]-word all-gather)."""
        import time
        tp = self.t_phase
        t = time.time()
        hdr = np.asarray(mhu.process_allgather(
            np.array([1 if done else 0, len(q)], np.int64))).reshape(
                self.nproc, 2)
        tp["status"] += time.time() - t
        if int(hdr[:, 0].sum()) == self.nproc:
            return _RoundResult(True, False)
        qsizes = hdr[:, 1]
        if int(qsizes.sum()) == 0:
            return _RoundResult(False, False)
        t = time.time()
        # pow2 bucket padding: the allgather XLA program compiles once per
        # bucket, not once per round
        m = 1 << (max(int(qsizes.max()), 1) - 1).bit_length()
        pad = np.zeros(m, np.uint32)
        pad[:len(q)] = q
        qfull = np.asarray(mhu.process_allgather(pad)).reshape(self.nproc, m)
        queries = [qfull[p, :int(qsizes[p])] for p in range(self.nproc)]
        tp["qgather"] += time.time() - t
        self.exchanged_queries += int(qsizes.sum()) - int(qsizes[self.pid])
        # answer every requester's in-range queries (our own list never
        # overlaps our range: ensure_batch serves those locally)
        t = time.time()
        hdr_mine = np.zeros(self.nproc + 1, np.int64)
        meta_parts, locs_parts = [], []
        for r, qq in enumerate(queries):
            idx, c, n1s, locs = self._answer_one(qq)
            hdr_mine[r] = len(idx)
            meta_parts.append(np.concatenate([idx, c, n1s]).astype(np.int32))
            locs_parts.append(locs)
        meta_cat = (np.concatenate(meta_parts) if meta_parts
                    else np.zeros(0, np.int32))
        locs_cat = (np.concatenate(locs_parts) if locs_parts
                    else np.zeros(0, np.uint32))
        payload = np.concatenate([meta_cat.view(np.uint32), locs_cat])
        hdr_mine[self.nproc] = len(payload)
        tp["answer"] += time.time() - t
        t = time.time()
        hdrs = np.asarray(mhu.process_allgather(hdr_mine)).reshape(
            self.nproc, self.nproc + 1)
        m2 = 1 << (max(int(hdrs[:, self.nproc].max()), 1) - 1).bit_length()
        pp = np.zeros(m2, np.uint32)
        pp[:len(payload)] = payload
        pfull = np.asarray(mhu.process_allgather(pp)).reshape(self.nproc, m2)
        tp["rgather"] += time.time() - t
        # parse the owners' reply segments addressed to us; segment offsets
        # come from the combined header + the counts inside earlier segments
        t = time.time()
        myq = queries[self.pid]
        for o in range(self.nproc):
            if o == self.pid:
                continue
            lo, hi = self.bounds[o], self.bounds[o + 1]
            meta_len = 3 * int(hdrs[o, :self.nproc].sum())
            total_o = int(hdrs[o, self.nproc])
            meta_o = pfull[o, :meta_len].view(np.int32)
            locs_o = pfull[o, meta_len:total_o]
            self.exchanged_locs += total_o - meta_len
            moff = 0
            loff = 0
            for r in range(self.nproc):
                nz = int(hdrs[o, r])
                idx = meta_o[moff:moff + nz]
                cnts = meta_o[moff + nz:moff + 2 * nz]
                n1s = meta_o[moff + 2 * nz:moff + 3 * nz]
                tot = int(cnts.sum())
                if r == self.pid:
                    sub_all = myq[(myq >= lo) & (myq < hi)]
                    self._fill(sub_all, idx, cnts, n1s,
                               locs_o[loff:loff + tot])
                moff += 3 * nz
                loff += tot
        tp["parse"] += time.time() - t
        return _RoundResult(False, True)

    # -- free-running routing service -----------------------------------
    # A dedicated thread runs collective rounds continuously, so a peer's
    # query round is answered within ~one round-trip even while THIS
    # process is deep in its align phase.  Without it, a process that
    # needs one more routing round than its peer blocks until the peer's
    # entire align loop finishes (the drain call) — seconds of skew-wait
    # measured on the 2-host bench.  Every process runs the same loop, so
    # the per-round collective sequences stay paired; rounds with no
    # queries anywhere are a single [2]-word heartbeat (see _round_inner).

    def _service_loop(self):
        empty = np.zeros(0, np.uint32)
        # Idle heartbeats are throttled with exponential backoff: an
        # unthrottled loop spins collective dispatch + poll on one full
        # core for the whole align phase (on 2-core workers, most of the
        # align phase's wall went to the status loop).
        # All processes run the same backoff, so arrival skew at each
        # heartbeat stays ~ms and blocked-poll spin is bounded.  A posted
        # query resets the backoff; worst-case routing latency is one
        # peer backoff interval (~20 ms) per round, against 1-3 rounds
        # per 50k-read batch.
        idle_sleep = 0.0
        while True:
            with self._cv:
                q = self._pending_q
                want_done = self._drain_flag and q is None
            res = self._round(q if q is not None else empty, want_done)
            if q is not None:
                with self._cv:
                    self._pending_q = None
                    self._cv.notify_all()
            if res.finished:
                return
            if res.any_queries or q is not None:
                idle_sleep = 0.0
            else:
                idle_sleep = min(0.05, max(0.001, idle_sleep * 2))
                with self._cv:
                    if self._pending_q is None and not self._drain_flag:
                        self._cv.wait(timeout=idle_sleep)

    def _start_service(self):
        import threading
        if getattr(self, "_svc", None) is None:
            self._cv = threading.Condition()
            self._pending_q = None
            self._drain_flag = False
            self._svc = threading.Thread(target=self._service_loop,
                                         daemon=True)
            self._svc.start()

    def ensure_batch(self, enc, wait: bool = True, extra=None) -> None:
        """One batched routing round: fetch every not-yet-present k-mer this
        batch's seed probes can touch (enc.seedval holds the value at every
        start offset, so the query set is complete before any index read).
        Own-range k-mers are served from the local shard without touching
        the network; only foreign-range queries enter the service thread's
        next collective round.

        ``extra`` (optional u32 array) joins the query set — the caller
        passes the scheduler's stale seed buffers, whose values come from a
        PREVIOUS batch's reads and may not appear in this batch's seedval
        (the stale-seed-array quirk; see align.candidates.SeedScheduler).

        ``wait=False`` posts the query and returns immediately — the reply
        lands while the caller does other work (e.g. the previous batch's
        finish phase); call ``wait_batch()`` before ANY index read.  Only
        one posted query may be outstanding."""
        nk = self.params.total_kmers
        q = enc.seedval.reshape(-1)
        if extra is not None and len(extra):
            q = np.concatenate([q, np.asarray(extra, q.dtype).reshape(-1)])
        q = np.unique(q[q < nk]).astype(np.uint32)
        q = q[~self._have[q]]
        self.rounds += 1
        lo, hi = self.bounds[self.pid], self.bounds[self.pid + 1]
        own = (q >= lo) & (q < hi)
        local = q[own]
        if len(local):
            idx, c, n1s, locs = self._answer_one(local)
            self._fill(local, idx, c, n1s, locs)
        if self.nproc == 1:
            return
        self._start_service()
        t0 = time.time()
        with self._cv:
            while self._pending_q is not None:  # drain a prior async post
                self._cv.wait()
            self._pending_q = q[~own]
            self._cv.notify_all()
            if wait:
                while self._pending_q is not None:
                    self._cv.wait()
        self.t_wait += time.time() - t0

    def wait_batch(self) -> None:
        """Block until an ensure_batch(wait=False) post has been answered
        (no-op when none is outstanding or single-process)."""
        if self.nproc == 1 or getattr(self, "_svc", None) is None:
            return
        t0 = time.time()
        with self._cv:
            while self._pending_q is not None:
                self._cv.wait()
        self.t_wait += time.time() - t0

    def drain(self) -> None:
        """Signal the service thread that this process's read window is
        exhausted; it keeps answering peers' rounds until every process is
        done, then exits.  Call after the local align loop finishes."""
        if self.nproc == 1:
            return
        self._start_service()  # a window with zero batches still serves
        with self._cv:
            self._drain_flag = True
            self._cv.notify_all()
        self._svc.join()


def make_multihost_mesh(n_dp_per_host: Optional[int] = None):
    """Global (dp, rs) mesh with ``rs`` spanning processes: column p holds
    process p's devices, so each host's reference shard lives in local
    device memory and only the pmin merge crosses DCN.  dp stays inside a
    process, so extension outputs (replicated over rs) are fully
    assemblable from local shards."""
    import jax
    from jax.sharding import Mesh
    nproc = jax.process_count()
    devs = jax.devices()
    per = len(devs) // nproc
    n_dp = n_dp_per_host or per
    arr = np.empty((n_dp, nproc), dtype=object)
    for p in range(nproc):
        local = [d for d in devs if d.process_index == p][:n_dp]
        if len(local) < n_dp:
            raise ValueError(f"process {p} has {len(local)} < {n_dp} devices")
        for i, d in enumerate(local):
            arr[i, p] = d
    return Mesh(arr, axis_names=("dp", "rs"))


def read_window(params: AlignParams, total_reads: int) -> AlignParams:
    """This process's contiguous global-read-index window (the -B/-E split
    the reference's manual sharding would use).  Respects an existing
    -B/-E restriction."""
    import jax
    nproc = jax.process_count()
    pid = jax.process_index()
    lo = params.read_start
    hi = min(params.read_end, lo + total_reads - 1) \
        if total_reads else params.read_end
    span = hi - lo + 1
    per = -(-span // nproc)
    b = lo + pid * per
    e = min(hi, b + per - 1)
    import dataclasses
    return dataclasses.replace(params, read_start=b, read_end=e)
