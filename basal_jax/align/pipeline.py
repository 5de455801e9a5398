"""Single-end alignment pipeline: orchestrates host IO/encode, the device
extension kernel, the exact scan replay, and SAM emission.

Equivalent of the reference driver loop (t_SingleAlign/Do_Batch,
main.cpp:60-92, align.cpp:565-580), restructured for an accelerator:

  host:   batch read -> filter/trim -> encode planes -> seed schedule ->
          candidate table                      (numpy, overlappable)
  device: extend_kernel over all candidates    (jit)
  host:   scan replay -> SAM text
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

# NOTE: jax is imported lazily (inside DeviceContext and the mesh branch).
# Host-placement runs (HOST_EVAL=1 / jax-pinned-to-CPU auto) never touch a
# device, and the jax import alone is a visible share of a short CLI run —
# a fixed tax the reference binary does not pay.
import numpy as np

from ..config import MAXSNPS, AlignParams
from ..index.reference import PackedReference, load_reference
from ..index.seedindex import SeedIndex, build_index
from ..reads.encode import EncodedBatch, encode_batch
from ..reads.io import open_reads
from .candidates import SeedScheduler, build_candidates
from .replay import Replayer
from .rng import MyRand
from .sam import SamEmitter, sam_header


K_POS = MAXSNPS - 1  # mismatch positions per window (ops.extend.K_POS)

#: Static placement threshold, used until both paths have been measured:
#: a wave above this many candidates goes to the host SIMD evaluator, at or
#: below it to the device.  The measured per-candidate costs
#: (SingleEndAligner.measured_placement) take over once both exist;
#: BASAL_HOST_EVAL=0/1 forces either path.
HOST_EVAL_MIN = 2_000_000

# Once a run has processed this many reads, MADV_COLLAPSE the seed-index
# tables into 2 MiB pages on a background thread (native.madvise_collapse:
# the random gathers in seed scheduling are TLB-bound on 4 KiB pages;
# collapsing a table takes seconds, so only long runs amortize it).
# BASAL_THP=0 disables, =1 forces at aligner construction.
THP_AFTER_READS = 150_000


def _maybe_start_thp(aligner) -> None:
    if aligner._thp_started or aligner.total_reads < THP_AFTER_READS:
        return
    aligner._thp_started = True
    if os.environ.get("BASAL_THP", "auto") == "0":
        return
    import threading

    from ..native import collapse_index_tables
    threading.Thread(target=collapse_index_tables,
                     args=(aligner.index, aligner.ref), daemon=True).start()


def _inline_tail_enabled() -> bool:
    """Whether the scan may evaluate unmaterialized candidates on the host
    at visit time (BASAL_HOST_EVAL=0 forces all evaluation onto the
    device, reverting to ladder waves)."""
    import os
    return os.environ.get("BASAL_HOST_EVAL", "auto") != "0"


def _cpu_backend() -> bool:
    """True when jax is pinned to the CPU backend (jax.config or
    JAX_PLATFORMS) — checked WITHOUT initializing a backend, so host-only
    runs never initialize (or reserve memory on) an accelerator."""
    import os
    import sys
    if "jax" not in sys.modules:
        # jax not loaded: the pin can only come from the environment, and
        # answering from it keeps host-only runs from paying the jax import
        return os.environ.get("JAX_PLATFORMS") == "cpu"
    try:
        import jax
        p = jax.config.jax_platforms
    except Exception:
        return False
    return p == "cpu" or (not p and os.environ.get("JAX_PLATFORMS") == "cpu")


def host_eval_policy(params: AlignParams, n_cands: int) -> bool:
    """True when this wave should run on the host SIMD evaluator instead of
    the device (BASAL_HOST_EVAL=0/1 forces; default adaptive).  With
    jax pinned to CPU there is no accelerator to win: the fused AVX C++
    evaluator beats the XLA-CPU kernel on every measured profile (short
    runs otherwise never flip the adaptive placement and stay on the
    device waves), so auto routes straight to the host."""
    import os
    mode = os.environ.get("BASAL_HOST_EVAL", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    if _cpu_backend():
        return True
    return n_cands > HOST_EVAL_MIN


def _mode_name(params: AlignParams) -> str:
    if params.nt3:
        return "nt3"
    return "oneway" if params.rule.one_way else "multiway"


def row_starts(row):
    """(distinct rows, index of each one's first candidate) of a
    non-decreasing row array (candidates are emitted read-major; every fill
    path preserves this).  One linear pass instead of np.unique's sort."""
    d = np.diff(row)
    assert (d >= 0).all(), \
        "candidate rows must be non-decreasing for row-offset upload"
    first = (np.flatnonzero(np.concatenate(([True], d != 0)))
             if row.size else np.zeros(0, np.intp))
    return row[first], first


def device_bytes_limit(device):
    """``memory_stats()["bytes_limit"]`` of a device, or None when the
    backend reports none (the CPU backend)."""
    return (device.memory_stats() or {}).get("bytes_limit") or None


_GAP_CHUNKS = {}


def gapped_chunk(mode: str, gap: int, W: int, nw: int, limit, cap: int,
                 probe: int = 1 << 18) -> int:
    """Candidates per gapped dispatch.  The gapped kernel's temp memory
    grows with W and gap (16W lanes per window, 2*gap + 1 windows, K_POS
    extraction passes), so a fixed chunk that fits 100 bp reads overflows
    the device for long ones.  The kernel is compiled once per (mode, gap,
    W) at ``probe`` candidates; its memory_analysis() temp + output bytes
    per candidate, against a quarter of the device's ``limit``
    (bytes_limit), give the largest power-of-two chunk, at most ``cap``.
    Without a reported limit the chunk is ``cap``."""
    if not limit:
        return cap
    key = (mode, gap, W, nw, limit, cap, probe)
    if key not in _GAP_CHUNKS:
        import jax
        import jax.numpy as jnp

        from ..ops.extend import extend_kernel_blob
        U, E = 512, 8
        n = probe + 2 * U + 1 + U * W * (2 if mode == "multiway" else 1) \
            + E * W
        m = extend_kernel_blob.lower(
            jax.ShapeDtypeStruct((2 * nw,), jnp.uint32),
            jax.ShapeDtypeStruct((n,), jnp.int32), mode=mode, gap=gap, W=W,
            nw=nw, C=probe, U=U, E=E).compile().memory_analysis()
        per = (m.temp_size_in_bytes + m.output_size_in_bytes) / probe
        fit = max(int(limit // 4 / max(per, 1.0)), 1)
        _GAP_CHUNKS[key] = max(1 << 16, min(cap, 1 << (fit.bit_length() - 1)))
    return _GAP_CHUNKS[key]


class DeviceContext:
    """Holds the packed reference on device and invokes the extend kernel."""

    def __init__(self, ref: PackedReference, params: AlignParams):
        import jax

        from ..compile_cache import enable_compile_cache
        enable_compile_cache()
        self.params = params
        self.nw = ref.ref32.shape[1]
        self.ref32_dev = jax.device_put(ref.ref32.reshape(-1))
        self.mode = _mode_name(params)
        # measured dispatch->fetch wall time (adaptive placement input);
        # the first fetch is skipped — it folds in the jit compile, which
        # would poison the steady-state cost estimate
        self.meas_t = 0.0
        self.meas_n = 0
        self._meas_skip = 1
        # single-transfer blob upload (ops.extend.carve_blob): packs loc+
        # strand+row_off+rowmeta+planes into ONE i32 array per wave and
        # derives the valid/lenmask planes on device — one host->device
        # copy per wave instead of three, and ~40% fewer bytes.  Requires
        # coords < 2^31 (strand rides loc bit 31); BASAL_BLOB=0 reverts
        # to the 3-transfer packed entry.
        self.use_blob = (os.environ.get("BASAL_BLOB", "1") not in ("", "0")
                         and 16 * self.nw < (1 << 31))

    @property
    def cost_per_cand(self):
        """Measured seconds per candidate from dispatch to results on the
        host, or None until a wave of at least 16k candidates has been
        fetched."""
        return self.meas_t / self.meas_n if self.meas_n else None

    def wave_call(self, enc: EncodedBatch, loc, plane, row):
        """The kernel dispatch for one wave: (jitted entry, device arguments,
        static keywords).  ``_extend_async_one`` calls it as is; chip_smoke.py
        compiles and times the same call.

        Upload minimization: only rows that actually have candidates ship
        their planes, the per-candidate row ids become row offsets
        (candidates are grouped by row), and mode-unused planes become
        dummies.  The single-transfer blob layout (ops.extend.carve_blob)
        is used unless the wave has > 4094 N-containing rows (the rowmeta
        exception field is 12 bits); then the 3-transfer packed entry.
        """
        import jax.numpy as jnp

        from ..ops.extend import extend_kernel_blob, extend_kernel_packed
        p = self.params
        C = loc.shape[0]
        cpad = max(256, 1 << (C - 1).bit_length())  # pad to pow2 for jit reuse
        pad = cpad - C

        def padc(a, fill=0):
            return np.pad(a, (0, pad), constant_values=fill)

        used, first_idx = row_starts(row)
        row_off = np.empty(len(used) + 1, np.int64)
        row_off[:-1] = first_idx
        row_off[-1] = C
        U = len(used)
        upad = max(512, 1 << max(U - 1, 1).bit_length()) - U

        def padr(a):
            a = a[used]
            return np.pad(a, ((0, upad), (0, 0))) if upad else a

        def padr1(a):
            a = a[used]
            return np.pad(a, (0, upad)) if upad else a

        roff = np.pad(row_off, (0, upad), constant_values=C).astype(np.int32)
        Upad = U + upad
        kw = dict(mode=self.mode, W=enc.W, nw=self.nw, C=cpad, U=Upad)

        built = (self._build_blob(enc, loc, plane, used, roff, pad, upad)
                 if self.use_blob else None)
        if built is not None:
            blob, epad = built
            return (extend_kernel_blob, (self.ref32_dev, blob),
                    dict(kw, gap=p.gap, E=epad))

        # one packed meta + one planes upload per wave
        meta = np.concatenate([
            padc(loc, 12800).astype(np.int32), roff,
            padr1(np.repeat(enc.n_count, 2)).astype(np.int32),
            padr1(np.repeat(enc.map_len, 2)).astype(np.int32)])
        plane_list = [padr(enc.base), padr(enc.valid)]
        if self.mode == "multiway":
            plane_list.append(padr(enc.mread))
        if p.gap > 0:
            plane_list.append(padr(enc.lenmask))
        planes = np.concatenate(plane_list, axis=0)
        return (extend_kernel_packed,
                (self.ref32_dev, jnp.asarray(meta), jnp.asarray(planes),
                 jnp.asarray(padc(plane).astype(np.uint8))),
                dict(kw, gap=p.gap, n_planes=len(plane_list)))

    def _extend_async_one(self, enc: EncodedBatch, loc, plane, row):
        """Dispatch the extension kernel; returns (C, device result) without
        blocking, so host work for the next batch can overlap the device
        time (async dispatch)."""
        fn, args, kw = self.wave_call(enc, loc, plane, row)
        return loc.shape[0], fn(*args, **kw)

    def _build_blob(self, enc: EncodedBatch, loc, plane, used, roff,
                    pad, upad):
        """Assemble the carve_blob i32 buffer; (blob, E_padded) or None."""
        import jax.numpy as jnp
        hasn = getattr(enc, "_hasn_cache", None)
        if hasn is None:
            hasn = (enc.valid != enc.lenmask).any(axis=1)
            enc._hasn_cache = hasn  # per-batch: cached on the EncodedBatch
        excm = hasn[used]
        E = int(excm.sum())
        if E > 4094:
            return None
        U = len(used)
        epad = max(8, 1 << max(E - 1, 1).bit_length())  # bucketed jit shapes
        locp = (loc.astype(np.uint32)
                | (plane.astype(np.uint32) << np.uint32(31))).view(np.int32)
        exc = np.zeros(U, np.uint32)
        exc[excm] = 1 + np.arange(E, dtype=np.uint32)
        rl = np.repeat(enc.map_len, 2)[used].astype(np.uint32)
        nc = np.repeat(enc.n_count, 2)[used].astype(np.uint32)
        rowmeta = ((exc << np.uint32(20)) | (nc << np.uint32(10))
                   | rl).view(np.int32)
        parts = [np.pad(locp, (0, pad), constant_values=12800), roff,
                 np.pad(rowmeta, (0, upad))]

        def flat(a):
            a = a[used]
            if upad:
                a = np.pad(a, ((0, upad), (0, 0)))
            return a.reshape(-1).view(np.int32)

        parts.append(flat(enc.base))
        if self.mode == "multiway":
            parts.append(flat(enc.mread))
        ev = enc.valid[used][excm]
        if E < epad:
            ev = np.pad(ev, ((0, epad - E), (0, 0)))
        parts.append(ev.reshape(-1).view(np.int32))
        return jnp.asarray(np.concatenate(parts)), epad

    # candidate-heavy batches (repetitive references) are evaluated in
    # chunks to bound HLO temp memory on the device
    CHUNK = 4 << 20

    def chunk(self, W: int) -> int:
        """Candidates per dispatch for read width W (gapped_chunk)."""
        if self.params.gap == 0:
            return self.CHUNK
        dev = next(iter(self.ref32_dev.devices()))
        return gapped_chunk(self.mode, self.params.gap, W, self.nw,
                            device_bytes_limit(dev), self.CHUNK)

    def extend_async(self, enc, loc, plane, row):
        C = loc.shape[0]
        t0 = time.time()
        step = self.chunk(enc.W)
        return [self._extend_async_one(enc, loc[i:i + step],
                                       plane[i:i + step],
                                       row[i:i + step]) + (t0,)
                for i in range(0, max(C, 1), step)]

    def fetch(self, handles):
        outs = []
        for C, res, t0 in handles:
            outs.append(self._fetch_one(C, res))
            if C >= 16384:
                # dispatch -> results-on-host wall time per candidate: the
                # measured device cost that drives adaptive placement
                if self._meas_skip:
                    self._meas_skip -= 1
                else:
                    self.meas_t += time.time() - t0
                    self.meas_n += C
        if len(outs) == 1:
            return outs[0]
        counts = np.concatenate([o[0] for o in outs])
        if self.params.gap > 0:
            return (counts, np.concatenate([o[1] for o in outs]),
                    np.concatenate([o[2] for o in outs]))
        return counts, None, None

    def _fetch_one(self, C, res):
        if self.params.gap > 0:
            counts, pos0, pos1 = res  # positions stay i16 on the host
            return (np.asarray(counts)[:C].astype(np.int32),
                    np.asarray(pos0)[:C], np.asarray(pos1)[:C])
        return np.asarray(res)[:C].astype(np.int32), None, None

    def extend(self, enc: EncodedBatch, loc, plane, row):
        return self.fetch(self.extend_async(enc, loc, plane, row))


def wave_of_reads(waves, B: int) -> np.ndarray:
    """Index of the ladder wave each read's result comes from: the first
    wave whose mask holds it (None = all reads), else the last wave."""
    wave_of = np.full(B, len(waves) - 1, np.int64)
    taken = np.zeros(B, bool)
    for w, (mask, _) in enumerate(waves):
        m = ~taken if mask is None else (mask & ~taken)
        wave_of[m] = w
        taken |= m
    return wave_of


def gather_ranges(parts, offs, wave_of):
    """Per-read row ranges from per-wave arrays: read i takes rows
    offs[w][i]:offs[w][i + 1] of parts[w], w = wave_of[i].  Returns (rows
    concatenated in read order, their [B + 1] offsets)."""
    B = len(wave_of)
    used = [o[-1] for o in offs]
    base = np.cumsum([0] + used[:-1])
    start = np.zeros(B, np.int64)
    count = np.zeros(B, np.int64)
    for w, o in enumerate(offs):
        m = wave_of == w
        start[m] = o[:-1][m] + base[w]
        count[m] = np.diff(o)[m]
    out_off = np.zeros(B + 1, np.int64)
    np.cumsum(count, out=out_off[1:])
    idx = np.repeat(start - out_off[:-1], count) + np.arange(out_off[-1])
    cat = np.concatenate([a[:n] for a, n in zip(parts, used)])
    return cat[idx], out_off


def merge_se_waves(waves, B: int):
    """One bt_replay_se result from ladder waves [(mask, result)], so the
    native formatter emits a ladder batch in one call."""
    if len(waves) == 1:
        return waves[0][1]
    wave_of = wave_of_reads(waves, B)
    res = [w[1] for w in waves]
    per_read = []
    for k in range(3):  # stratum, n0, n1
        a = np.empty(B, res[0][k].dtype)
        for w, r in enumerate(res):
            m = wave_of == w
            a[m] = r[k][m]
        per_read.append(a)
    offs = [r[8] for r in res]
    hits = []
    for k in range(3, 8):  # hchr, hloc, hgsz, hgpos, hchain
        rows, hoff = gather_ranges([r[k] for r in res], offs, wave_of)
        hits.append(rows)
    return (*per_read, *hits, hoff)


class _LadderBuffers:
    """Candidate locs, counts and (gapped) i16 position lists accumulated
    over one ladder's waves, in arrays of ``cap`` rows that double when
    full (appending by concatenation re-copies the whole prefix every wave,
    O(waves x C) memcpy, which dominated the repetitive profile).  Untouched
    rows cost no memory, so a caller that knows a bound passes it as
    ``cap`` and nothing is ever copied.  The C++ replay only dereferences
    offsets below ``n``, so it is handed the full-capacity arrays."""

    @classmethod
    def reuse(cls, old, cap: int, gap: int):
        """``old`` emptied when it holds ``cap`` rows of the same layout
        (its pages are already resident: a fresh multi-GB buffer pays a
        page fault per 4 KiB on first touch), else a new buffer."""
        if (old is None or old.loc.shape[0] < cap
                or (old.pos0 is None) != (gap == 0)
                or (gap and old.pos1.shape[1] != 2 * gap)):
            return cls(cap, gap)
        old.n = 0
        return old

    def __init__(self, cap: int, gap: int):
        self.n = 0
        cap = max(cap, 1)
        self.loc = np.empty(cap, np.int32)
        self.cnt = np.empty(cap, np.int32)
        self.pos0 = self.pos1 = None
        if gap > 0:
            self.pos0 = np.empty((cap, K_POS), np.int16)
            self.pos1 = np.empty((cap, 2 * gap, K_POS), np.int16)

    def reserve(self, k: int) -> slice:
        """Room for k more candidates; returns their slice."""
        need = self.n + k
        if need > self.loc.shape[0]:
            cap = max(need, 2 * self.loc.shape[0])
            for name in ("loc", "cnt", "pos0", "pos1"):
                a = getattr(self, name)
                if a is not None:
                    b = np.empty((cap,) + a.shape[1:], a.dtype)
                    b[:self.n] = a[:self.n]
                    setattr(self, name, b)
        sl = slice(self.n, need)
        self.n = need
        return sl

    def append(self, loc, counts, pos0=None, pos1=None):
        sl = self.reserve(loc.size)
        self.loc[sl] = loc
        self.cnt[sl] = counts
        if self.pos0 is not None:
            self.pos0[sl] = pos0
            self.pos1[sl] = pos1


class SingleEndAligner:
    def __init__(self, params: AlignParams, ref: PackedReference,
                 index, use_native: Optional[bool] = None):
        self.p = params
        self.ref = ref
        self.index = index
        self.rng = MyRand(params.randseed)
        self.sched = SeedScheduler(params, index, self.rng)
        self._dev = None  # lazy: host-only runs must never claim a device
        self._bufs = None  # ladder buffers, reused batch to batch
        self._host_t = 0.0  # measured host-evaluator wall (s) / candidates
        self._host_n = 0
        # per-call C++ thread width; ThreadedRunner divides the cores among
        # its workers so -p N does not oversubscribe N x 8 threads
        self.nt_hint = 0  # 0 = auto (all cores)
        self.replayer = Replayer(params, ref, self.rng)
        rrbs_fn = None
        if params.rrbs_flag:
            from ..index.rrbs import ccgg_seglen
            rrbs_fn = (lambda c, l, L: ccgg_seglen(index, c, l, L))
        self.emitter = SamEmitter(params, ref, self.rng, rrbs_seglen=rrbs_fn)
        self.total_reads = 0
        self.total_candidates = 0
        self._thp_started = False
        if os.environ.get("BASAL_THP") == "1":
            from ..native import collapse_index_tables
            collapse_index_tables(index, ref)  # forced: collapse at startup
            self._thp_started = True
        # per-stage cost anatomy, printed at -V 2 (the reference keeps the
        # analogous total_candidates/total_seeds counters, align.h:98)
        self.stage = {
            "cand_device": 0,    # evaluated through the accelerator kernel
            "cand_host": 0,      # evaluated by the host SIMD evaluator
            "cand_visit": 0,     # left to visit-time eval inside the scan
            "waves_device": 0, "waves_host": 0, "waves_visit": 0,
            "eager_batches": 0, "ladder_batches": 0, "ladder_waves": 0,
            "fused_batches": 0,  # single-pass build+eval+scan (C++)
        }
        from ..native import NativeBatch, native_available
        if use_native is None:
            use_native = (native_available() and params.randseed != 0
                          and not params.rrbs_flag)
        self.native = (NativeBatch(params, index, ref)
                       if use_native else None)
        # RRBS fast path: C++ candidate build (bt_build_candidates_rrbs) +
        # host evaluation + C++ replay with per-candidate plane/skip; SAM
        # emission stays on the Python emitter (ZP/ZL fragment lookups).
        # BASAL_NO_NATIVE / randseed 0 keep the pure-Python twins.
        self.native_rrbs = None
        self.formatter = None
        if self.native is not None and not params.rrbs_flag:
            from ..native import NativeFormatter
            self.formatter = NativeFormatter(params, ref)
        elif (params.rrbs_flag and params.randseed != 0 and native_available()
                and os.environ.get("BASAL_NO_NATIVE") is None):
            self.native_rrbs = NativeBatch(params, index, ref)
            from ..native import NativeFormatter
            self.formatter = NativeFormatter(params, ref, rrbs_index=index)

    @property
    def dev(self):
        """Device context, created on first device dispatch.  Runs whose
        waves all take the host-SIMD evaluator (repetitive references with
        BASAL_HOST_EVAL=1/auto) never construct it, so they never
        initialize the accelerator or reserve its memory."""
        if self._dev is None:
            import jax
            if len(jax.devices()) > 1:
                from ..parallel.mesh import make_sharded_context
                self._dev = make_sharded_context(self.ref, self.p)
            if self._dev is None:
                self._dev = DeviceContext(self.ref, self.p)
        return self._dev

    # -- two-phase API for the overlapped pipeline -----------------------
    def stats(self):
        """(aligned, unique, multiple) merged across the Python emitter and
        the native formatter."""
        e = self.emitter
        a, u, m = e.n_aligned, e.n_unique, e.n_multiple
        if self.formatter is not None:
            c = self.formatter.counters
            a += int(c[0])
            u += int(c[1])
            m += int(c[2])
        return a, u, m

    # Wave policy: evaluate every stratum's candidates in one device call
    # while the total volume is small.  On candidate-heavy inputs (repetitive
    # genomes: 10^4-10^5 candidates/read) climb the strata ladder instead —
    # wave k evaluates only stratum-k candidates of still-unresolved reads,
    # which reproduces the cost profile of the reference's pigeonhole early
    # stop (align.cpp:459-463) while staying batched.
    EAGER_MAX_CANDS = 2_000_000

    def encode_post(self, reads):
        """Encode a batch and POST its routing query without waiting
        (shard-resident index).  The reply lands on the service thread
        while the caller finishes the previous batch; submit_batch(reads,
        enc=...) then waits (usually a no-op) before any index read."""
        enc = encode_batch(self.p, reads)
        ens = getattr(self.index, "ensure_batch", None)
        if ens is not None:
            ens(enc, wait=False, extra=self._stale_seeds())
        return enc

    def _stale_seeds(self):
        """Current stale seed-buffer values (may be probed by this batch's
        (L-I+1)%s==0 reads but absent from its own seedval)."""
        nb = self.native
        st = nb.seed_state if nb is not None else self.sched.seed_state
        return st.reshape(-1)

    def submit_batch(self, reads, enc=None, routed_ready=False):
        """Host encode + lazy candidate build + async dispatch of wave 1.

        ``routed_ready=True`` asserts this batch's routing reply has
        already landed (the caller posted a LATER batch's query, and the
        single-slot post blocks until the prior reply is in), so the wait
        is skipped — see the read-ahead loop in _run_single_end."""
        if enc is None:
            from ..reads.io import RawBatch as _RB
            chk = self._fused_chunk()
            if (chk > 0 and self.native is not None
                    and isinstance(reads, _RB)
                    and getattr(self.index, "ensure_batch", None) is None
                    and len(reads) >= 2 * chk
                    and self._fused_host()):
                return self._submit_fused_chunked(reads)
            enc = encode_batch(self.p, reads)
            ens = getattr(self.index, "ensure_batch", None)
            if ens is not None:  # shard-resident index: one routed round
                ens(enc, extra=self._stale_seeds())
        elif not routed_ready:
            wb = getattr(self.index, "wait_batch", None)
            if wb is not None:
                wb()
        self.total_reads += len(reads)
        _maybe_start_thp(self)
        if self.native is None:
            return ("py", enc)
        from ..reads.io import RawBatch
        ridx = (enc.reads.indices if isinstance(enc.reads, RawBatch)
                else np.array([r.index for r in enc.reads], dtype=np.uint32))
        if self._fused_host():
            # single-pass C++ schedule + group build + visit-time scan:
            # no candidate buffers, and modes past each read's resolution
            # stratum are never evaluated (see bt_align_se_host)
            res, n_enum, n_eval = self.native.align_se_host(
                enc, ridx, self.ref, n_threads=self.nt_hint)
            self.total_candidates += n_enum
            self.stage["cand_visit"] += n_eval
            self.stage["waves_visit"] += 1
            self.stage["fused_batches"] += 1
            return ("fused", enc, res)
        groups, goff, total = self.native.build_groups(enc, ridx)
        ng = groups.shape[0]
        off = np.full(ng, -1, dtype=np.int64)
        if ng == 0:
            return ("native", enc, groups, goff, off, None, None, 99)
        eff = 99 if total <= self.EAGER_MAX_CANDS else 1
        sel = (np.arange(ng) if eff >= 99
               else np.flatnonzero(groups[:, 2] < eff))
        n1c = int(groups[sel, 6].sum())
        if total and self.p.gap > 0 and _inline_tail_enabled():
            # gapped: no bulk wave at all — one replay evaluates every
            # candidate at visit time (gap_align_ev's lazy
            # MismatchPattern0/1 under the scan's snp_thres aborts, like
            # the reference's per-candidate GapAlign, align.cpp:348-410).
            # This is the default for ANY volume in auto mode: the gapped
            # device wave downloads K_POS i16 position lists per candidate
            # per shifted alignment and expands them to i32 on the host,
            # while visit-time eval stops at the scan's aborts and never
            # computes most of those lists.  BASAL_HOST_EVAL=0 still forces
            # the device ladder (the XLA gapped kernel).
            self.total_candidates += int(total)
            self.stage["cand_visit"] += int(total)
            self.stage["waves_visit"] += 1
            return ("native", enc, groups, goff, off, None,
                    ("inline", int(total)), 99)
        if (self.p.gap > 0 and eff < 99 and total * self._cand_bytes()
                > self.LADDER_BYTES):
            # device-evaluated gapped ladder too large for one set of host
            # buffers: every wave runs at finish time, in read slices
            return ("sliced", enc, groups, goff, off)
        if n1c and self.p.gap == 0 and self._host_eval_policy(n1c):
            # fused wave-1 materialize + host evaluation (no fill/copy pass)
            loc = np.empty(n1c, np.int32)
            cnt = np.empty(n1c, np.int32)
            t0 = time.time()
            self.native.fill_eval_groups(enc, self.ref, groups, sel, off, 0,
                                         loc, cnt,
                                         n_threads=self.nt_hint)
            if n1c >= 16384:
                self._host_t += time.time() - t0
                self._host_n += n1c
            self.total_candidates += n1c
            self.stage["cand_host"] += n1c
            self.stage["waves_host"] += 1
            return ("native", enc, groups, goff, off, (loc, None, None),
                    ("host", cnt, None, None), eff)
        loc, plane, row = self.native.fill_groups(enc, groups, sel, off)
        self.total_candidates += loc.size
        return ("native", enc, groups, goff, off, (loc, plane, row),
                self._dispatch(enc, loc, plane, row), eff)

    def _fused_chunk(self) -> int:
        """Chunk size for the cache-blocked fused host path (0 disables).
        Encode writes ~850 B/read of seed arrays that the fused align
        immediately re-reads; at 50k-read batches that is a 42 MB DRAM
        round trip per batch.  Encoding + aligning in chunks keeps the
        chunk's seed arrays LLC-resident between the two passes.
        Chunking is bit-exact by construction: it is identical to running
        smaller batches, and all cross-read state (sticky start offsets,
        stale seed buffers, myrand read indices) already carries serially
        across batch boundaries (tests/test_fused_chunked.py pins chunked
        == unchunked byte-for-byte).

        DEFAULT OFF (negative A/B on an earlier host: chunks of 4096-16384
        reads lost or tied) — per-chunk std::thread spawn/join in the C
        entries eats the locality win when the shared-LLC slice is too
        small for the 7-14 MB working sets to stick.  Kept behind the
        knob for hosts with large private LLCs."""
        v = os.environ.get("BASAL_FUSED_CHUNK", "0")
        try:
            return max(0, int(v))
        except ValueError:
            return 0

    def _submit_fused_chunked(self, reads):
        from ..reads.io import RawBatch
        chk = self._fused_chunk()
        self.total_reads += len(reads)
        _maybe_start_thp(self)
        out = []
        for s in range(0, len(reads), chk):
            e = min(s + chk, len(reads))
            sub = RawBatch(reads.buf, reads.name_off[s:e],
                           reads.name_len[s:e], reads.seq_off[s:e],
                           reads.seq_len[s:e], reads.qual_off[s:e],
                           reads.qual_len[s:e], reads.index0 + s,
                           reads.readset)
            enc = encode_batch(self.p, sub)
            res, n_enum, n_eval = self.native.align_se_host(
                enc, enc.reads.indices, self.ref, n_threads=self.nt_hint)
            self.total_candidates += n_enum
            self.stage["cand_visit"] += n_eval
            self.stage["waves_visit"] += 1
            out.append((enc, res))
        self.stage["fused_batches"] += 1
        return ("fused_chunks", out)

    # host wins a wave when its measured cost/candidate is below this
    # fraction of the device's (hysteresis against routing flapping)
    HOST_DEV_MARGIN = 0.7

    def _fused_host(self) -> bool:
        """Whether this batch should take the fused single-pass host path
        (bt_align_se_host).  Engages exactly when every wave would land on
        the host evaluator anyway: HOST_EVAL=1 forces, jax-on-cpu in auto
        mode, or the measured placement has settled on the host.  Gapped
        runs take it whenever visit-time eval is enabled (the auto default
        for ANY volume — see the gap comment in submit_batch).
        BASAL_FUSED=0 reverts to the split build/eval/replay pipeline
        (the golden twin the differential tests also exercise)."""
        if os.environ.get("BASAL_FUSED", "1") in ("", "0"):
            return False
        mode = os.environ.get("BASAL_HOST_EVAL", "auto")
        if mode == "0":
            return False
        if self.p.gap > 0:
            return _inline_tail_enabled()
        if mode == "1":
            return True
        if _cpu_backend():
            return True
        return self.measured_placement() == "host"

    def collapse_now(self) -> int:
        """Synchronously collapse the index tables into hugepages (see
        THP_AFTER_READS).  For callers with an explicit untimed setup
        window (bench.py warmup); returns arrays collapsed."""
        self._thp_started = True
        from ..native import collapse_index_tables
        return collapse_index_tables(self.index, self.ref)

    def placement_costs(self):
        """(host, device) measured seconds per candidate; each None until
        that path has been measured on a wave of at least 16k candidates."""
        host = self._host_t / self._host_n if self._host_n else None
        dev = self._dev.cost_per_cand if self._dev is not None else None
        return host, dev

    def measured_placement(self):
        """'host' | 'device' once BOTH paths have real measurements, else
        None.  Public: bench.py keys its batch-size choice on this instead
        of reaching into _host_t/_host_n/_dev."""
        host, dev = self.placement_costs()
        if host is None or dev is None:
            return None
        return "host" if host < self.HOST_DEV_MARGIN * dev else "device"

    def _host_eval_policy(self, n_cands: int) -> bool:
        """Measured adaptive placement: beyond the static rules, once the
        device cost has been observed (cost_per_cand from real waves, host
        copies included), probe the host evaluator once and from then on
        route each wave to whichever path measured cheaper per candidate.
        Forced modes short-circuit in host_eval_policy."""
        import os
        if (os.environ.get("BASAL_HOST_EVAL", "auto") == "auto"
                and n_cands <= HOST_EVAL_MIN
                and self._dev is not None):
            if self._dev.cost_per_cand is not None:
                placement = self.measured_placement()
                if placement is None:
                    return n_cands >= 16384  # one measured host probe
                return placement == "host"
        return host_eval_policy(self.p, n_cands)

    def _host_eval_timed(self, enc, loc, plane, row):
        """Returns (counts, pos0, pos1); the position lists are None for
        gap == 0 and the gapped replay inputs otherwise."""
        from ..native import host_eval_candidates, host_eval_candidates_gap
        t0 = time.time()
        if self.p.gap > 0:
            counts, pos0, pos1 = host_eval_candidates_gap(
                self.p, self.ref, enc, loc, plane, row,
                n_threads=self.nt_hint)
        else:
            counts = host_eval_candidates(self.p, self.ref, enc, loc, plane,
                                          row, n_threads=self.nt_hint)
            pos0 = pos1 = None
        if loc.size >= 16384:
            self._host_t += time.time() - t0
            self._host_n += loc.size
        return counts, pos0, pos1

    def _dispatch(self, enc, loc, plane, row):
        """Evaluate one wave's candidates: on the host evaluator now, or on
        the device asynchronously.  Returns a handle for _fetch."""
        if self._host_eval_policy(loc.size):
            self.stage["cand_host"] += loc.size
            self.stage["waves_host"] += 1
            return ("host",) + self._host_eval_timed(enc, loc, plane, row)
        self.stage["waves_device"] += 1
        self.stage["cand_device"] += loc.size
        return self.dev.extend_async(enc, loc, plane.astype(np.int32), row)

    def _fetch(self, handle):
        """(counts i32, pos0, pos1) of a _dispatch handle; the position
        lists are i16, or None for ungapped runs."""
        if isinstance(handle, tuple) and handle[0] == "host":
            return (np.asarray(handle[1], dtype=np.int32), handle[2],
                    handle[3])
        return self.dev.fetch(handle)

    def prefetch_state(self, state):
        """Block on the wave-1 device results for a submitted state (device
        usage stays serialized with the caller); the remaining pure-host work
        can then run in a side thread via finish_batch_prefetched."""
        if state[0] != "native" or state[6] is None:
            return None
        if isinstance(state[6], tuple) and state[6][0] == "inline":
            return None  # no wave-1 results: all-visit-time replay
        return self._fetch(state[6])

    def finish_batch_prefetched(self, state, fetched) -> bytes:
        """finish_batch with the wave-1 fetch already done.  NOTE: ladder
        wave-2+ still issues device calls; callers that need strict device
        serialization should only use this on eager (single-wave) batches —
        wave 2 triggers for <5% of reads on non-repetitive references."""
        if fetched is None:
            return self.finish_batch(state)
        return self._finish_with(state, fetched)

    def finish_batch(self, state) -> bytes:
        if state[0] == "py":
            return self._align_batch_python(state[1])
        if state[0] == "fused":
            return self._emit_native(state[1], [(None, state[2])])
        if state[0] == "fused_chunks":
            return b"".join(self._emit_native(e, [(None, r)])
                            for e, r in state[1])
        if state[0] == "sliced":
            _, enc, groups, goff, off = state
            self.stage["ladder_batches"] += 1
            waves = []
            for active in self._read_slices(groups, len(enc.reads)):
                waves += self._ladder(enc, groups, goff, off, 1, None, active)
            return self._emit_native(enc, waves)
        return self._finish_with(state, self.prefetch_state(state))

    # Host bytes the device ladder keeps per evaluated candidate (loc and
    # count; gapped runs add K_POS i16 positions for the read window and
    # for each of the 2*gap shifted windows).  A gapped batch whose
    # enumerated candidates exceed LADDER_BYTES at that rate climbs the
    # ladder in read slices of about that size, so host memory stays bounded
    # whatever the batch size.  (Ungapped ladders materialize a few percent
    # of the enumerated volume at 8 bytes each and are not sliced.)
    LADDER_BYTES = 4 << 30

    def _cand_bytes(self) -> int:
        return 8 + 2 * K_POS * (2 * self.p.gap + 1)

    def _read_slices(self, groups, B):
        """Boolean read masks of consecutive slices whose enumerated
        candidates each stay within LADDER_BYTES (a read larger than that
        gets a slice of its own)."""
        per_read = np.bincount(groups[:, 0], weights=groups[:, 6],
                               minlength=B)
        budget = self.LADDER_BYTES // self._cand_bytes()
        sid = np.empty(B, np.int64)
        k = acc = 0
        for i, v in enumerate(per_read.tolist()):
            if acc and acc + v > budget:
                k, acc = k + 1, 0
            sid[i] = k
            acc += v
        return [sid == j for j in range(k + 1)]

    def _finish_with(self, state, fetched) -> str:
        (_, enc, groups, goff, off, arrs, handle, eff) = state
        if handle is None or (isinstance(handle, tuple)
                              and handle[0] == "inline"):
            z = np.zeros(0, np.int32)
            t0 = time.time()
            res = self.native.replay_se(enc, groups, goff, z, None, z,
                                        None, None, counts_off=off,
                                        inline_eval=handle is not None,
                                        n_threads=self.nt_hint)
            if handle is not None and handle[1] >= 16384:
                # conservative host-cost sample (includes the scan itself)
                self._host_t += time.time() - t0
                self._host_n += handle[1]
            return self._emit_native(enc, [(None, res)])
        loc, plane, row = arrs
        counts, pos0, pos1 = (fetched if fetched is not None
                              else self._fetch(handle))
        if eff >= 99:
            self.stage["eager_batches"] += 1
            res = self.native.replay_se(enc, groups, goff, loc, plane,
                                        counts, pos0, pos1, counts_off=off,
                                        n_threads=self.nt_hint)
            return self._emit_native(enc, [(None, res)])
        self.stage["ladder_batches"] += 1
        return self._emit_native(enc, self._ladder(
            enc, groups, goff, off, eff, (loc, counts, pos0, pos1)))

    def _wave(self, enc, groups, sel, off, bufs):
        """Materialize and evaluate the candidates of groups ``sel`` into
        the ladder buffers (fused C++ fill + host evaluation when the host
        takes an ungapped wave, else fill + _dispatch + _fetch)."""
        n = int(groups[sel, 6].sum())  # column 6 = group size
        if n and self.p.gap == 0 and self._host_eval_policy(n):
            self.stage["cand_host"] += n
            self.stage["waves_host"] += 1
            base = bufs.n
            sl = bufs.reserve(n)
            t0 = time.time()
            self.native.fill_eval_groups(
                enc, self.ref, groups, sel, off, base, bufs.loc[sl],
                bufs.cnt[sl], n_threads=self.nt_hint)
            if n >= 16384:
                self._host_t += time.time() - t0
                self._host_n += n
        elif n:
            loc, plane, row = self.native.fill_groups(enc, groups, sel, off,
                                                      base=bufs.n)
            bufs.append(loc, *self._fetch(self._dispatch(enc, loc, plane,
                                                         row)))

    def _ladder(self, enc, groups, goff, off, lim, first, active=None):
        """Strata ladder over the reads in ``active`` (all when None):
        replay with modes < lim, then evaluate stratum ``lim`` of the reads
        the replay reports unresolved, and repeat.  ``first`` holds (loc,
        counts, pos0, pos1) of the already evaluated modes < lim, or None to
        evaluate them here.  Returns [(newly resolved mask, replay)]."""
        read_of_group = groups[:, 0]
        done = (np.zeros(len(enc.reads), dtype=bool) if active is None
                else ~active)
        sel = np.flatnonzero((groups[:, 2] < lim) & ~done[read_of_group])
        n1 = int(groups[sel, 6].sum())
        if self.p.gap > 0:
            # every candidate this ladder can reach: within LADDER_BYTES
            # (see _read_slices), so the buffers never grow
            cap = int(groups[~done[read_of_group], 6].sum())
        else:
            cap = max(2 * n1, n1 + (1 << 20))
        bufs = self._bufs = _LadderBuffers.reuse(self._bufs, cap, self.p.gap)
        if first is None:
            self.total_candidates += n1
            self._wave(enc, groups, sel, off, bufs)
        else:
            bufs.append(*first)
        waves = []
        while True:
            self.stage["ladder_waves"] += 1
            filt = np.ascontiguousarray(enc.filtered | done, np.uint8)
            res = self.native.replay_se(enc, groups, goff, bufs.loc, None,
                                        bufs.cnt, bufs.pos0, bufs.pos1,
                                        mode_limit=lim,
                                        filtered_override=filt,
                                        counts_off=off,
                                        n_threads=self.nt_hint)
            incomplete = res[0] == -2
            newly = (~incomplete) & (~done)
            waves.append((newly, res))
            done |= newly
            if not incomplete.any():
                return waves
            sel = np.flatnonzero((groups[:, 2] == lim)
                                 & incomplete[read_of_group])
            n2 = int(groups[sel, 6].sum())
            n_inc = int(incomplete.sum())
            if (_inline_tail_enabled()
                    and (n2 < 1_000_000 or n2 > 2_000 * n_inc)):
                # tail wave is either tiny (not worth a bulk round trip) or
                # mega-groups serving few reads (bulk evaluation would be
                # mostly wasted past the scan's abort points): finish with
                # ONE replay that evaluates the remaining candidates at
                # visit time inside the scan
                self.stage["cand_visit"] += n2
                self.stage["waves_visit"] += 1
                filt = np.ascontiguousarray(enc.filtered | done, np.uint8)
                res = self.native.replay_se(
                    enc, groups, goff, bufs.loc, None, bufs.cnt,
                    bufs.pos0, bufs.pos1, mode_limit=99,
                    filtered_override=filt, counts_off=off,
                    inline_eval=True)
                waves.append((~done, res))
                return waves
            self.total_candidates += n2
            self._wave(enc, groups, sel, off, bufs)
            lim += 1

    def align_batch(self, reads) -> bytes:
        return self.finish_batch(self.submit_batch(reads))

    def _align_batch_rrbs_native(self, enc) -> bytes:
        """RRBS batch through the native engine: C++ candidate build +
        host-SIMD evaluation + C++ replay (per-candidate plane/skip) + the
        threaded C++ formatter (ZP/ZL via the CCGG_seglen twin).
        Byte-identical to the pure-Python path (test_differential_rrbs.py
        + fuzz); BASAL_NO_NATIVE=1 reverts."""
        from ..reads.io import RawBatch
        from ..native import host_eval_candidates, host_eval_candidates_gap
        nb = self.native_rrbs
        ridx = (enc.reads.indices if isinstance(enc.reads, RawBatch)
                else np.array([r.index for r in enc.reads], dtype=np.uint32))
        groups, goff, loc, plane, skip, row, total = \
            nb.build_candidates_rrbs(enc, ridx, self.index)
        self.total_candidates += total
        self.stage["cand_host"] += total
        self.stage["waves_host"] += 1
        pos0 = pos1 = None
        if total and self.p.gap > 0:
            counts, pos0, pos1 = host_eval_candidates_gap(
                self.p, self.ref, enc, loc, plane, row,
                n_threads=self.nt_hint)
        elif total:
            counts = host_eval_candidates(self.p, self.ref, enc, loc, plane,
                                          row, n_threads=self.nt_hint)
        else:
            counts = np.zeros(0, dtype=np.int32)
        res = nb.replay_se(enc, groups, goff, loc, None, counts, pos0, pos1,
                           n_threads=self.nt_hint,
                           rr_plane=plane, rr_skip=skip)
        return self._emit_native(enc, [(None, res)])

    def _align_batch_python(self, enc) -> bytes:
        if self.p.rrbs_flag:
            if self.native_rrbs is not None:
                return self._align_batch_rrbs_native(enc)
            from .candidates import build_candidates_rrbs
            table = build_candidates_rrbs(self.p, self.index, self.ref, enc,
                                          self.sched)
        else:
            table = build_candidates(self.p, self.index, enc, self.sched)
        self.total_candidates += table.loc.size
        if table.loc.size:
            counts, pos0, pos1 = self.dev.extend(
                enc, table.loc, table.plane, table.row)
        else:
            counts = np.zeros(0, dtype=np.int32)
            pos0 = pos1 = None
        results = self.replayer.replay_batch(enc, table, counts, pos0, pos1)
        out: List[str] = []
        for read, res, L in zip(enc.reads, results, enc.map_len):
            self.emitter.emit_read(read, res, int(L), out)
        return "".join(out).encode("latin1")

    def _emit_native(self, enc, waves) -> bytes:
        """SAM body of a native batch: the C++ formatter over the merged
        ladder waves (its counters are merged by stats())."""
        return self.formatter.format(
            enc, merge_se_waves(waves, len(enc.reads)), n_threads=self.nt_hint)

class ThreadedRunner:
    """-p worker pool: the replacement for the reference's pthread
    fan-out (t_SingleAlign, main.cpp:60-92).  Each worker owns a full aligner
    (private scheduler state, like each pthread's SingleAlign instance); the
    C++ engine and numpy release the GIL, so host phases of consecutive
    batches overlap.  Output is written in batch order (deterministic, a
    valid interleaving of the reference's mutex-ordered appends)."""

    def __init__(self, params, ref, index, n_workers: int):
        from concurrent.futures import ThreadPoolExecutor
        import os
        self.aligners = [SingleEndAligner(params, ref, index)
                         for _ in range(n_workers)]
        nt = max(1, len(os.sched_getaffinity(0)) // n_workers)
        for a in self.aligners:
            a.nt_hint = nt  # divide cores among workers
        # One single-thread executor per aligner: batches that round-robin
        # onto the same (stateful) aligner are serialized by its own queue,
        # so correctness never depends on the caller's drain window.
        self.pools = [ThreadPoolExecutor(1) for _ in range(n_workers)]
        self.n = n_workers
        self.i = 0

    def submit(self, reads):
        slot = self.i % self.n
        self.i += 1
        return self.pools[slot].submit(self.aligners[slot].align_batch, reads)

    def counters(self):
        totals = [a.stats() for a in self.aligners]
        return tuple(sum(t[i] for t in totals) for i in range(3))

    def shutdown(self):
        for p in self.pools:
            p.shutdown()


def run_single_end(params: AlignParams, ref_path: str, reads_path: str,
                   out_fh=None, command_line: str = "basal_jax",
                   log=lambda *a: None, index_factory=None,
                   timings: Optional[dict] = None):
    # observability (SURVEY §5): BASAL_PROFILE=<dir> captures a JAX
    # profiler trace of the whole run (device + host annotations); per-batch
    # reads/s are logged at -V 2 like the reference's batch lines
    import os as _os
    prof_dir = _os.environ.get("BASAL_PROFILE")
    if prof_dir:
        import jax.profiler as _prof
        _prof.start_trace(prof_dir)
    from .. import malloc_window
    try:
        with malloc_window():
            return _run_single_end(params, ref_path, reads_path, out_fh,
                                   command_line, log, index_factory, timings)
    finally:
        if prof_dir:
            import jax.profiler as _prof
            _prof.stop_trace()


def stage_report(aligners) -> str:
    """One-line cost anatomy merged over worker aligners: where candidates
    were evaluated (device kernel / host SIMD / visit-time in the scan),
    wave and placement decision counts.  Printed at -V 2;
    the reference's analogue is its total_candidates/total_seeds counters
    (align.h:98)."""
    keys = aligners[0].stage.keys()
    s = {k: sum(a.stage[k] for a in aligners) for k in keys}
    n_cand = sum(a.total_candidates for a in aligners) or 1
    n_reads = sum(a.total_reads for a in aligners) or 1
    return (f"cost anatomy: {n_cand} candidates ({n_cand/n_reads:.1f}/read) "
            f"| eval: device {s['cand_device']} host {s['cand_host']} "
            f"visit-time {s['cand_visit']} "
            f"| waves: device {s['waves_device']} host {s['waves_host']} "
            f"visit {s['waves_visit']} "
            f"| batches: eager {s['eager_batches']} "
            f"ladder {s['ladder_batches']} "
            f"(ladder waves {s['ladder_waves']}) "
            f"fused {s['fused_batches']}")


def _run_single_end(params: AlignParams, ref_path: str, reads_path: str,
                    out_fh=None, command_line: str = "basal_jax",
                    log=lambda *a: None, index_factory=None,
                    timings: Optional[dict] = None):
    t0 = time.time()
    ref = load_reference(ref_path, params)
    log(f"{ref.total_num} reference seqs loaded, total size {ref.sum_length} bp. "
        f"{time.time()-t0:.0f} secs passed")
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

    out_fh = out_fh or sys.stdout
    if params.sam_header:
        out_fh.write(sam_header(ref, params, command_line).encode('latin1'))
    reader = open_reads(reads_path, params, readset=0)
    if params.num_threads > 1 and params.randseed != 0 and not params.rrbs_flag:
        from collections import deque
        runner = ThreadedRunner(params, ref, index, params.num_threads)
        futures = deque()
        while True:
            reads = reader.next_batch()
            if reads:
                futures.append(runner.submit(reads))
            while futures and (not reads or len(futures) > runner.n):
                out_fh.write(futures.popleft().result())
                log(f"{reader.index - params.read_start + 1} reads finished. "
                    f"{time.time()-t0:.0f} secs passed")
            if not reads:
                break
        runner.shutdown()
        n_al, n_un, n_mu = runner.counters()

        class _E:  # counters facade for the summary below
            n_aligned, n_unique, n_multiple = n_al, n_un, n_mu
        e = _E
        aligner = runner.aligners[0]
        reader.close()
        n_total = max(reader.index - params.read_start + 1, 1)
        log(f"total reads: {reader.index - params.read_start + 1} \t"
            f"total time: {time.time()-t0:.0f} secs")
        log(f"aligned reads: {e.n_aligned} ({100.0*e.n_aligned/n_total:.1f}%), "
            f"unique reads: {e.n_unique} ({100.0*e.n_unique/n_total:.1f}%), "
            f"non-unique reads: {e.n_multiple} "
            f"({100.0*e.n_multiple/n_total:.1f}%)")
        log(stage_report(runner.aligners), 2)
        return aligner

    aligner = SingleEndAligner(params, ref, index)
    # two-deep pipeline: host-encode/dispatch batch k+1 while batch k's
    # device results stream back (JAX async dispatch covers the device+RPC
    # latency; the replay only blocks when it fetches).  With a routed
    # (multi-host) index, batch k+1's routing query is POSTED before batch
    # k's ALIGN phase (read-ahead), so the cross-host round trip hides
    # behind the fused align instead of sitting on the critical path —
    # posting early is safe because the shard cache is cumulative: any
    # stale-buffer value batch k+1 can probe came from an already-posted
    # batch's seedval (or the initial zero state, posted with batch 0),
    # and the single-slot post blocks until batch k's own reply landed,
    # which is what makes routed_ready=True sound.
    routed = hasattr(index, "wait_batch")
    pending = None
    if routed:
        reads_cur = reader.next_batch()
        enc_cur = aligner.encode_post(reads_cur) if reads_cur else None
        while reads_cur:
            reads_next = reader.next_batch()
            enc_next = (aligner.encode_post(reads_next)
                        if reads_next else None)
            if pending is not None:
                out_fh.write(aligner.finish_batch(pending))
                log(f"{reader.index - params.read_start + 1} reads "
                    f"finished. {time.time()-t0:.0f} secs passed")
            pending = aligner.submit_batch(
                reads_cur, enc=enc_cur, routed_ready=enc_next is not None)
            reads_cur, enc_cur = reads_next, enc_next
        if pending is not None:
            out_fh.write(aligner.finish_batch(pending))
            log(f"{reader.index - params.read_start + 1} reads finished. "
                f"{time.time()-t0:.0f} secs passed")
    else:
        while True:
            reads = reader.next_batch()
            state = aligner.submit_batch(reads) if reads else None
            if pending is not None:
                out_fh.write(aligner.finish_batch(pending))
                log(f"{reader.index - params.read_start + 1} reads "
                    f"finished. {time.time()-t0:.0f} secs passed")
            pending = state
            if state is None:
                break
    reader.close()
    n_al, n_un, n_mu = aligner.stats()

    class _E2:
        n_aligned, n_unique, n_multiple = n_al, n_un, n_mu
    e = _E2
    n_total = max(reader.index - params.read_start + 1, 1)
    log(f"total reads: {reader.index - params.read_start + 1} \t"
        f"total time: {time.time()-t0:.0f} secs")
    log(f"aligned reads: {e.n_aligned} ({100.0*e.n_aligned/n_total:.1f}%), "
        f"unique reads: {e.n_unique} ({100.0*e.n_unique/n_total:.1f}%), "
        f"non-unique reads: {e.n_multiple} ({100.0*e.n_multiple/n_total:.1f}%)")
    log(stage_report([aligner]), 2)
    return aligner
