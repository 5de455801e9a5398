"""Multi-chip execution: device-mesh sharding of the alignment step.

The reference's only parallelism is a single-node pthread pool over read
batches (main.cpp:56-130).  The device-mesh replacements here (SURVEY §2.4):

* **Data parallelism** over candidates/reads: shard the candidate table over
  a ``dp`` mesh axis; the packed reference is replicated.  This is the
  production path whenever the reference planes fit in one device's memory
  (human genome 2-bit: ~0.4 GB/plane).

* **Reference sharding** over an ``rs`` axis for genomes/transcriptomes that
  exceed device memory: each shard holds a contiguous halo-extended window-word range
  of both planes; every shard evaluates every candidate but masks those whose
  window falls outside its range, and results merge with ``lax.pmin`` over
  ``rs`` (exactly one shard owns any candidate, others contribute +inf).
  The pmin is a device collective (NVLink between the cards of one host);
  no host gather.

Deterministic merge: counts/positions are combined with min, which is
placement-invariant, so multi-host output equals single-host bit-for-bit.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..align.pipeline import device_bytes_limit, gapped_chunk, row_starts
from ..ops.extend import extend_kernel

BIG = np.int32(1 << 30)
BIG16 = np.int16(np.iinfo(np.int16).max)  # position lists stay i16


class _CompactEnc:
    """Active-row view of an EncodedBatch's planes (see
    DeviceContext.extend_async's compaction)."""

    def __init__(self, enc, used):
        self.W = enc.W
        self.base = enc.base[used]
        self.valid = enc.valid[used]
        self.mread = enc.mread[used]
        self.lenmask = enc.lenmask[used]
        rd = used >> 1
        self.n_count = enc.n_count[rd]
        self.map_len = enc.map_len[rd]


def make_mesh(n_dp: int, n_rs: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()[:n_dp * n_rs]
    arr = np.asarray(devices).reshape(n_dp, n_rs)
    return Mesh(arr, axis_names=("dp", "rs"))


def shard_reference(ref32: np.ndarray, n_rs: int, halo: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split both planes into n_rs contiguous word ranges with ``halo`` extra
    words on the right edge (windows may read up to halo words past a shard's
    first-word range).  Returns (shards [n_rs, 2, shard_w + halo],
    shard_start [n_rs])."""
    nw = ref32.shape[1]
    shard_w = -(-nw // n_rs)
    shards = np.zeros((n_rs, 2, shard_w + halo), dtype=np.uint32)
    starts = np.zeros(n_rs, dtype=np.int32)
    for i in range(n_rs):
        a = i * shard_w
        b = min(a + shard_w + halo, nw)
        shards[i, :, :b - a] = ref32[:, a:b]
        starts[i] = a
    return shards, starts


@functools.partial(
    jax.jit, static_argnames=("mode", "gap", "W", "shard_w", "mesh_def"))
def _sharded_extend(ref_shards, shard_start, loc, plane, row, base, valid,
                    mread, lenmask, ncnt, readlen, *, mode, gap, W, shard_w,
                    mesh_def):
    """dp x rs sharded extension.  ``loc``/``plane``/``row`` are sharded over
    dp and replicated over rs; ref shards live one per rs index."""
    mesh = mesh_def

    def body(ref_s, start_s, loc_s, plane_s, roff_s, base_s, valid_s, mread_s,
             lenmask_s, ncnt_s, readlen_s):
        ref_s = ref_s[0]          # [1, 2, w] block -> [2, w]
        start = start_s[0]
        # row offsets index the GLOBAL candidate order; rebase to this dp
        # shard's slice so extend_kernel's searchsorted sees local indices
        c_local = loc_s.shape[0]
        shard_lo = jax.lax.axis_index("dp").astype(roff_s.dtype) * c_local
        roff_local = jnp.clip(roff_s - shard_lo, 0, c_local)
        halo_w = ref_s.shape[-1] - shard_w
        k0 = (loc_s >> 4) - (1 if gap > 0 else 0)
        wg = (W + 3) if gap > 0 else (W + 1)
        in_shard = (k0 >= start) & (k0 + wg <= start + shard_w + halo_w)
        # clamp out-of-shard gathers into range; results masked later
        loc_local = jnp.where(in_shard, loc_s - start * 16, 12800)
        nw_local = ref_s.shape[-1]
        res = extend_kernel(
            ref_s.reshape(-1), loc_local, plane_s, roff_local, base_s,
            valid_s, mread_s, lenmask_s, ncnt_s, readlen_s,
            mode=mode, gap=gap, W=W, nw=nw_local)
        if gap > 0:
            counts, pos0, pos1 = res
            counts = jnp.where(in_shard, counts, BIG)
            pos0 = jnp.where(in_shard[:, None], pos0, BIG16)
            pos1 = jnp.where(in_shard[:, None, None], pos1, BIG16)
            counts = jax.lax.pmin(counts, "rs")
            pos0 = jax.lax.pmin(pos0, "rs")
            pos1 = jax.lax.pmin(pos1, "rs")
            return counts, pos0, pos1
        counts = jnp.where(in_shard, res, BIG)
        return (jax.lax.pmin(counts, "rs"),)

    spec_c = P("dp")            # candidates sharded over dp, replicated over rs
    spec_2d = P(None, None)     # read planes replicated
    spec_1d = P(None)
    out_spec = (P("dp"),) if gap == 0 else (P("dp"), P("dp"), P("dp"))
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("rs", None, None), P("rs"), spec_c, spec_c, spec_1d,
                  spec_2d, spec_2d, spec_2d, spec_2d, spec_1d, spec_1d),
        out_specs=out_spec,
    )
    return fn(ref_shards, shard_start, loc, plane, row, base, valid, mread,
              lenmask, ncnt, readlen)


class ShardedDeviceContext:
    """Drop-in replacement for align.pipeline.DeviceContext running the
    extension step over a (dp, rs) mesh.  API-compatible with
    DeviceContext (extend_async/fetch/extend, cost_per_cand) so
    SingleEndAligner/PairAligner select it transparently when the process
    sees more than one accelerator."""

    CHUNK = 4 << 20  # bound per-dispatch temp memory, as DeviceContext

    def __init__(self, ref, params, mesh: Mesh):
        from ..align.pipeline import _mode_name
        self.params = params
        self.mesh = mesh
        self.n_dp = mesh.shape["dp"]
        self.n_rs = mesh.shape["rs"]
        nw = ref.ref32.shape[1]
        self.shard_w = -(-nw // self.n_rs)
        halo = 64  # > W+3 words for any read length <= 480
        shards, starts = shard_reference(ref.ref32, self.n_rs, halo)
        self.ref_dev = jax.device_put(
            shards, NamedSharding(mesh, P("rs", None, None)))
        self.start_dev = jax.device_put(
            starts, NamedSharding(mesh, P("rs")))
        self.mode = _mode_name(params)
        # adaptive-placement cost model (see DeviceContext)
        self.meas_t = 0.0
        self.meas_n = 0
        self._meas_skip = 1

    @property
    def cost_per_cand(self):
        return self.meas_t / self.meas_n if self.meas_n else None

    def _extend_async_one(self, enc, loc, plane, row):
        p = self.params
        C = loc.shape[0]
        unit = 256 * self.n_dp
        # pow2-of-unit padding: bucketed shapes, bucketed recompiles
        cpad = max(unit, unit << max(-(-C // unit) - 1, 0).bit_length())
        pad = cpad - C

        def padc(a, fill=0):
            return np.pad(a, (0, pad), constant_values=fill)

        used, first_idx = row_starts(row)
        U = len(used)
        upad = max(512, 1 << max(U - 1, 1).bit_length()) - U
        row_off = np.full(U + 1 + upad, C, np.int32)
        row_off[:U] = first_idx
        cenc = _CompactEnc(enc, used)

        def padr(a):
            return np.pad(a, ((0, upad), (0, 0))) if upad else a

        def padr1(a):
            return np.pad(a, (0, upad)) if upad else a

        csh = NamedSharding(self.mesh, P("dp"))
        rsh = NamedSharding(self.mesh, P())
        res = _sharded_extend(
            self.ref_dev, self.start_dev,
            jax.device_put(padc(loc, 12800).astype(np.int32), csh),
            jax.device_put(padc(plane).astype(np.int32), csh),
            jax.device_put(row_off, rsh),
            jax.device_put(padr(cenc.base), rsh),
            jax.device_put(padr(cenc.valid), rsh),
            jax.device_put(padr(cenc.mread), rsh),
            jax.device_put(padr(cenc.lenmask), rsh),
            jax.device_put(padr1(cenc.n_count.astype(np.int32)), rsh),
            jax.device_put(padr1(cenc.map_len.astype(np.int32)), rsh),
            mode=self.mode, gap=p.gap, W=enc.W, shard_w=self.shard_w,
            mesh_def=self.mesh)
        return C, res

    def chunk(self, W: int) -> int:
        """Candidates per dispatch: each device evaluates C / n_dp of
        them, so the single-device gapped chunk scales by n_dp."""
        if self.params.gap == 0:
            return self.CHUNK
        nw = self.shard_w + 64
        return self.n_dp * gapped_chunk(
            self.mode, self.params.gap, W, nw,
            device_bytes_limit(self.mesh.devices.flat[0]), self.CHUNK)

    def extend_async(self, enc, loc, plane, row):
        import time
        C = loc.shape[0]
        t0 = time.time()
        step = self.chunk(enc.W)
        return [self._extend_async_one(enc, loc[i:i + step],
                                       plane[i:i + step],
                                       row[i:i + step]) + (t0,)
                for i in range(0, max(C, 1), step)]

    def fetch(self, handles):
        import time
        outs = []
        for C, res, t0 in handles:
            outs.append(self._fetch_one(C, res))
            if C >= 16384:
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

    @staticmethod
    def _to_np(a):
        """Host-fetch a mesh output.  When the mesh spans processes
        (multi-host: rs across hosts, parallel/multihost.py) the global
        array is not fully addressable; the dp axis stays within the
        process, so the full value is assemblable from local shards
        (replicated over the remote rs columns)."""
        if getattr(a, "is_fully_addressable", True):
            return np.asarray(a)
        out = np.empty(a.shape, a.dtype)
        seen = np.zeros(a.shape[0], bool)
        for s in a.addressable_shards:
            out[s.index] = np.asarray(s.data)
            seen[s.index[0]] = True
        assert seen.all(), "mesh output not locally assemblable (dp remote?)"
        return out

    def _fetch_one(self, C, res):
        if self.params.gap > 0:
            counts, pos0, pos1 = res
            return (self._to_np(counts)[:C].astype(np.int32),
                    self._to_np(pos0)[:C], self._to_np(pos1)[:C])
        return self._to_np(res[0])[:C].astype(np.int32), None, None

    def extend(self, enc, loc, plane, row):
        return self.fetch(self.extend_async(enc, loc, plane, row))


def device_memory_bytes(device) -> int:
    """Memory the runtime lets this device's arrays use
    (``memory_stats()["bytes_limit"]``).  Raises when the device reports no
    limit: no memory size is assumed."""
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {device} reports no memory limit (memory_stats: "
            f"{sorted(stats)}); set BASAL_MESH=DPxRS to choose the mesh")
    return int(limit)


def auto_mesh_shape(n_devices: int, ref_words: int, device_bytes: int):
    """Pick (n_dp, n_rs): shard the reference over rs only when the packed
    planes (2 x 4 bytes x words, x2 working headroom) exceed one device's
    memory (``device_bytes``); otherwise pure data parallelism."""
    plane_bytes = 2 * 4 * ref_words * 2
    n_rs = 1
    while plane_bytes // n_rs > device_bytes and n_rs < n_devices:
        n_rs *= 2
    n_dp = max(n_devices // n_rs, 1)
    return n_dp, n_rs


def make_sharded_context(ref, params, devices=None):
    """Build a ShardedDeviceContext over all visible devices (or an
    explicit list).  ``BASAL_MESH`` overrides: "0" disables (caller
    falls back to single-device), "DPxRS" forces a shape."""
    import os
    # multi-host: each process's aligner works its own read window, so the
    # default extension mesh is per-host (local devices); cross-host rs
    # meshes are built explicitly via multihost.make_multihost_mesh
    devices = list(devices if devices is not None else jax.local_devices())
    spec = os.environ.get("BASAL_MESH", "")
    if spec == "0":
        return None
    if "x" in spec:
        n_dp, n_rs = (int(t) for t in spec.split("x"))
    else:
        n_dp, n_rs = auto_mesh_shape(len(devices), ref.ref32.shape[1],
                                     device_memory_bytes(devices[0]))
    if n_dp * n_rs < 2 or n_dp * n_rs > len(devices):
        return None
    mesh = make_mesh(n_dp, n_rs, devices[:n_dp * n_rs])
    return ShardedDeviceContext(ref, params, mesh)
