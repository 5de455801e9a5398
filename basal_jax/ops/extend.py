"""Batched candidate-extension kernels (the hot loop, on device).

This replaces the reference's per-candidate scalar scan
(``SingleAlign::SnpAlign`` + ``CountMismatch[_new]`` + ``MismatchPattern*``,
align.cpp:228-317, align.h:118-327) with one fixed-shape tensor program:
every candidate of a read batch is evaluated in parallel on the device.

Per candidate (ref-plane p, concatenated base loc, read-chain row r):
  1. gather the reference window words from device memory,
  2. funnel-shift them onto the read word grid (the reference shifts the read
     onto the ref grid instead — same comparisons, align.h:126-128),
  3. apply the conversion-mask algebra and popcount 2-bit mismatch lanes.

In gapped mode it additionally extracts the first K=MAXSNPS-1 mismatch
positions left-to-right (MismatchPattern0, align.h:133-168) and, for each of
the 2*gap shifted windows, right-to-left as distance-from-read-end
(MismatchPattern1, align.h:170-196).  The sequential accept/dedup/cap logic
consumes these on the host (see basal_jax.align.replay).

There is no early exit: full counts are computed for all candidates.  Counts
beyond the reference's running ``snp_thres`` are simply ignored downstream,
which reproduces its output exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .bitops import (lane_flags, mismatch_words_multiway, mismatch_words_nt3,
                     mismatch_words_oneway, xm32)

K_POS = 14  # MAXSNPS - 1: max mismatch positions any GapAlign path can read


def _align_words(R: jax.Array, off: jax.Array, sh2: jax.Array, W: int) -> jax.Array:
    """Funnel-shift gathered ref words onto the read word grid.

    R: [C, Wg] gathered words; off: [C] first-word offset into R;
    sh2: [C] bit shift (2 * base offset).  Returns [C, W].
    A[w] = (R[off+w] << sh2) | ((R[off+w+1] >> (31-sh2)) >> 1)
    (cf. the (s[i]<<offset)|((s[i+1]>>(63-offset))>>1) composition,
    align.h:141).
    """
    idx = off[:, None] + jnp.arange(W + 1, dtype=jnp.int32)[None, :]
    r = jnp.take_along_axis(R, idx, axis=1)
    sh = sh2[:, None].astype(jnp.uint32)
    return (r[:, :W] << sh) | ((r[:, 1:] >> (jnp.uint32(31) - sh)) >> 1)


def _rule_flags(mode: str, base, refw, mread):
    if mode == "oneway":
        return mismatch_words_oneway(base, refw)
    if mode == "multiway":
        return mismatch_words_multiway(base, refw, mread)
    if mode == "nt3":
        return mismatch_words_nt3(base, refw)
    raise ValueError(mode)


def _first_positions(flagw: jax.Array, fill: jax.Array, W: int,
                     reverse: bool) -> jax.Array:
    """First K_POS mismatch lane positions of [C, W] flag words, ascending
    read position (reverse=False) or ascending distance-from-end
    (reverse=True, position reported as L-1-p per MismatchPattern1's
    j accounting, align.h:179-193).  ``fill`` [C] is map_readlen."""
    bits = lane_flags(flagw)  # one bit per lane at the lane's low position
    shifts = jnp.arange(30, -2, -2, dtype=jnp.uint32)  # lane 0 (first base) first
    lane_bits = (bits[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    lane_bits = lane_bits.reshape(bits.shape[0], W * 16)
    lane_idx = jnp.arange(W * 16, dtype=jnp.int32)[None, :]
    pos = jnp.where(reverse, fill[:, None] - 1 - lane_idx, lane_idx)
    score = jnp.where(lane_bits != 0, pos, fill[:, None]).astype(jnp.int32)
    # first K_POS by K min-extract passes, not a full row sort: every
    # mismatch position is < fill and unique within its row, so
    # extract-min then mask-to-fill reproduces sort()[:K_POS] exactly,
    # fill padding included (tests/test_device_kernels.py)
    outs = []
    for _ in range(K_POS):
        m = jnp.min(score, axis=1)
        outs.append(m)
        score = jnp.where(score == m[:, None], fill[:, None], score)
    return jnp.stack(outs, axis=1)


def _extend_core(ref32, loc, plane, row_off, base, valid, mread, lenmask,
                 ncnt, readlen, *, mode: str, gap: int, W: int, nw: int):
    """Evaluate C candidates against the packed reference.

    ref32: u32 [2*nw] (fwd plane then RC plane, each nw words)
    loc:   i32 [C] concatenated base coords (alignment start)
    plane: u8/i32 [C] ref strand plane (0 fwd / 1 RC)
    row_off: i32 [U+1] — candidates are grouped by read row; candidate i
             belongs to active row searchsorted(row_off, i, 'right')-1.
             (Uploading offsets instead of a per-candidate row id, and only
             the rows that actually have candidates, cuts upload bytes.)
    base/valid/mread/lenmask: u32 [U, W] active-row read planes
    ncnt:  i32 [U] N-count additive term (-N flag; align.h:120)
    readlen: i32 [U] mapped read length

    Returns counts u8[C] and, when gap>0, (pos0 i16[C, K],
    pos1 i16[C, 2*gap, K]).
    """
    C = loc.shape[0]
    row = (jnp.searchsorted(row_off, jnp.arange(C, dtype=row_off.dtype),
                            side="right") - 1).astype(jnp.int32)
    wg = (W + 3) if gap > 0 else (W + 1)
    k0 = (loc >> 4) - (1 if gap > 0 else 0)
    sh2 = ((loc & 15) << 1).astype(jnp.int32)
    gidx = plane.astype(jnp.int32) * jnp.int32(nw) + k0
    idx = gidx[:, None] + jnp.arange(wg, dtype=jnp.int32)[None, :]
    R = jnp.take(ref32, idx)  # [C, wg]

    off0 = jnp.full((C,), 1 if gap > 0 else 0, dtype=jnp.int32)
    A = _align_words(R, off0, sh2, W)

    b = jnp.take(base, row, axis=0)
    v = jnp.take(valid, row, axis=0)
    mr = jnp.take(mread, row, axis=0) if mode == "multiway" else None
    flags = _rule_flags(mode, b, A, mr)
    counts = jnp.take(ncnt, row) + jnp.sum(xm32(flags & v), axis=1)
    # u8 return: the replay only distinguishes counts <= MAXSNPS (15); this
    # quarters the device->host copy
    counts8 = jnp.minimum(counts, 255).astype(jnp.uint8)

    if gap == 0:
        return counts8

    lm = jnp.take(lenmask, row, axis=0)
    L = jnp.take(readlen, row)
    pos0 = _first_positions(flags & lm, L, W, reverse=False)

    pos1 = []
    for tt in range(1, 2 * gap + 1):
        t = (tt + 1) // 2
        shift = (1 - (tt % 2) * 2) * t  # tt odd -> -t, even -> +t (align.cpp:373)
        loc_s = loc + shift
        k0_s = loc_s >> 4
        off_s = k0_s - k0
        sh2_s = ((loc_s & 15) << 1).astype(jnp.int32)
        A_s = _align_words(R, off_s, sh2_s, W)
        flags_s = _rule_flags(mode, b, A_s, mr)
        pos1.append(_first_positions(flags_s & lm, L, W, reverse=True))
    return (counts8, pos0.astype(jnp.int16),
            jnp.stack(pos1, axis=1).astype(jnp.int16))


@functools.partial(jax.jit, static_argnames=("mode", "gap", "W", "nw"))
def extend_kernel(ref32, loc, plane, row_off, base, valid, mread, lenmask,
                  ncnt, readlen, *, mode: str, gap: int, W: int, nw: int):
    return _extend_core(ref32, loc, plane, row_off, base, valid, mread,
                        lenmask, ncnt, readlen, mode=mode, gap=gap, W=W,
                        nw=nw)


def derive_lenmask(readlen, W: int):
    """[U, W] u32 length mask (0b11 per in-length base, first base at bits
    31:30 — pack_planes_u32 order) derived on device from per-row read
    lengths, so the host never uploads the lenmask plane."""
    lanes = jnp.clip(readlen[:, None] - 16 * jnp.arange(W, dtype=readlen.dtype)[None, :],
                     0, 16).astype(jnp.uint32)
    full = jnp.uint32(0xFFFFFFFF)
    # lanes==16 -> full; lanes<16 -> top 2*lanes bits set (shift < 32 safe)
    return jnp.where(lanes >= 16, full,
                     full ^ (full >> (2 * jnp.minimum(lanes, 15))))


def carve_blob(blob, *, mode: str, gap: int, W: int, C: int, U: int, E: int):
    """Unpack the single-transfer wave blob (i32 [C + 2U+1 + planes]):

      loc_packed [C]    (strand plane << 31) | loc   (coords < 2^31)
      row_off    [U+1]
      rowmeta    [U]    (exc_idx+1 << 20) | (ncnt << 10) | readlen
                        (readlen/ncnt <= 480 < 1024; <= 4094 exception rows)
      base       [U*W]  u32 bitcast
      mread      [U*W]  (multiway only)
      exc_valid  [E*W]  validity rows of N-containing reads (E >= 1 pad)

    ``valid`` is derived: rows without Ns have valid == lenmask (encode.py:
    REG_ALPHABET maps ACGT->3, N->0, beyond-read->0), so only exception
    rows ship their plane.  Returns (loc, plane, row_off, base, valid,
    mread, lenmask, ncnt, readlen)."""
    locp = blob[:C]
    plane = (locp >> 31) & 1
    loc = locp & 0x7FFFFFFF
    row_off = blob[C:C + U + 1]
    nl = blob[C + U + 1:C + 2 * U + 1]
    readlen = nl & 1023
    ncnt = (nl >> 10) & 1023
    exc = (nl >> 20) & 0xFFF
    rest = jax.lax.bitcast_convert_type(blob[C + 2 * U + 1:], jnp.uint32)
    base = rest[:U * W].reshape(U, W)
    k = 1
    if mode == "multiway":
        mread = rest[k * U * W:(k + 1) * U * W].reshape(U, W)
        k += 1
    else:
        mread = jnp.zeros((1, W), jnp.uint32)
    excv = rest[k * U * W:k * U * W + E * W].reshape(E, W)
    lm = derive_lenmask(readlen, W)
    valid = jnp.where((exc > 0)[:, None],
                      jnp.take(excv, jnp.maximum(exc - 1, 0), axis=0), lm)
    return loc, plane, row_off, base, valid, mread, lm, ncnt, readlen


@functools.partial(jax.jit, static_argnames=("mode", "gap", "W", "nw", "C",
                                             "U", "E"))
def extend_kernel_blob(ref32, blob, *, mode: str, gap: int, W: int, nw: int,
                       C: int, U: int, E: int):
    """Single-transfer entry: ONE i32 blob upload per wave (the packed entry
    makes three host->device copies, each with its own fixed cost), with the
    strand plane packed into loc bit 31 and the valid/lenmask planes derived
    on device (carve_blob) — ~30% fewer upload bytes."""
    (loc, plane, row_off, base, valid, mread, lm, ncnt,
     readlen) = carve_blob(blob, mode=mode, gap=gap, W=W, C=C, U=U, E=E)
    return _extend_core(ref32, loc, plane, row_off, base, valid, mread,
                        lm, ncnt, readlen, mode=mode, gap=gap, W=W, nw=nw)


@functools.partial(jax.jit, static_argnames=("mode", "gap", "W", "nw", "C",
                                             "U", "n_planes"))
def extend_kernel_packed(ref32, meta, planes, plane_u8, *, mode: str,
                         gap: int, W: int, nw: int, C: int, U: int,
                         n_planes: int):
    """Packed entry: all i32 scalars/vectors arrive in one ``meta`` buffer
    and all read planes in one ``planes`` buffer (3 host->device copies per
    call instead of ~10).  Used when a wave cannot take the blob layout.

    meta   i32 [C + (U+1) + U + U]: loc | row_off | ncnt | readlen
    planes u32 [n_planes*U, W]:     base | valid | [mread] | [lenmask]
    plane_u8 u8 [C]
    """
    loc = meta[:C]
    row_off = meta[C:C + U + 1]
    ncnt = meta[C + U + 1:C + 2 * U + 1]
    readlen = meta[C + 2 * U + 1:C + 3 * U + 1]
    base = planes[:U]
    valid = planes[U:2 * U]
    one = jnp.zeros((1, W), jnp.uint32)
    k = 2
    if mode == "multiway":
        mread = planes[k * U:(k + 1) * U]
        k += 1
    else:
        mread = one
    lenmask = planes[k * U:(k + 1) * U] if gap > 0 else one
    return _extend_core(ref32, loc, plane_u8, row_off, base, valid, mread,
                        lenmask, ncnt, readlen, mode=mode, gap=gap, W=W,
                        nw=nw)
