"""Device-side (JAX) 2-bit lane primitives.

The reference's bit-kernel instruction set (param.h:95-147) reformulated on
uint32 lanes (the device's native integer width; int64 is off by default in
JAX): XT collapse, XC wildcard mask, M2_judge saturate, and 2-bit-lane
popcount.  All are elementwise integer ops that XLA fuses into the
surrounding kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# numpy scalars become jaxpr literals (not captured consts) and carry the
# exact uint32 dtype
A32 = np.uint32(0xAAAAAAAA)
FIVES = np.uint32(0x55555555)


def xt32(tt: jax.Array) -> jax.Array:
    """Collapse convert-to (11) lanes to convert-from (01) — XT32 (param.h:105)."""
    return tt - ((tt << 1) & tt & A32)


def xc32(tt: jax.Array) -> jax.Array:
    """Per-lane wildcard mask from ref words: 01 where ref lane is 01
    (convert-from), else 11 — XC/XC64 (param.h:118-119)."""
    return ((~tt) << 1) | tt | FIVES


def m2_judge32(tt: jax.Array) -> jax.Array:
    """Saturate 2-bit lanes: 11 kept, 01/10 -> 00 — M2_judge (param.h:142)."""
    return tt & (((tt & A32) >> 1) | ((tt & FIVES) << 1))


def xm32(tt: jax.Array) -> jax.Array:
    """Count nonzero 2-bit lanes — XM/XM64 (param.h:123-139)."""
    return jax.lax.population_count((tt | (tt >> 1)) & FIVES).astype(jnp.int32)


def lane_flags(tt: jax.Array) -> jax.Array:
    """Reduce each 2-bit lane to one bit at the lane's low position."""
    return (tt | (tt >> 1)) & FIVES


def mismatch_words_oneway(base: jax.Array, refw: jax.Array) -> jax.Array:
    """One-way conversion rule (CountMismatch, align.h:118-131): the XC mask
    makes read-11 (convert-to) vs ref-01 (convert-from) XOR to zero; every
    other substitution leaves a nonzero lane."""
    return (base & xc32(refw)) ^ refw


def mismatch_words_multiway(base: jax.Array, refw: jax.Array,
                            mread: jax.Array) -> jax.Array:
    """Multi-way conversion rule (CountMismatch_new, align.h:199-239):
    M2 = XC(ref) | Mread; M3 = judge(M2); M4 = ((~M3 & M2) | (M3 & read)) ^ ref
    — zero exactly where conversion is legal or bases are equal."""
    m2 = xc32(refw) | mread
    m3 = m2_judge32(m2)
    return (((~m3) & m2) | (m3 & base)) ^ refw


def mismatch_words_nt3(base_xt: jax.Array, refw: jax.Array) -> jax.Array:
    """Three-letter mode (-3): both sides XT-collapsed, plain XOR
    (align.h:120-123).  ``base_xt`` is collapsed at encode time."""
    return base_xt ^ xt32(refw)
