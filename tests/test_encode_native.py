"""bt_encode_batch (BMI2 pext pack + fused VBMI LUT pass) vs the numpy
golden: every output plane and seed array must be bit-identical, including
mixed read lengths, Ns, and all-256-byte alphabets (the fused LUT blends on
the index's top two bits — bytes >= 0x80 exercise that path)."""

import os
import random

import numpy as np
import pytest

from basal_jax.config import AlignParams
from basal_jax.reads import encode as E
from basal_jax.reads.io import ReadRec

FIELDS = ("base", "valid", "mread", "lenmask", "seedval", "seed_has_n",
          "map_len", "n_offsets", "filtered", "n_count", "read_max_snp")


def _reads(seed, exotic):
    rng = random.Random(seed)
    out = []
    for i in range(600):
        L = rng.choice([36, 50, 75, 100, 100, 100, 151])
        if exotic and i % 11 == 0:
            alpha = "ACGTacgtn.-*xyz\x80\xff"
        elif i % 7 == 0:
            alpha = "ACGTN"
        else:
            alpha = "ACGT"
        seq = "".join(rng.choice(alpha) for _ in range(L))
        out.append(ReadRec(i, 0, f"r{i}", seq, "I" * L))
    return out


@pytest.mark.parametrize("conv", ["C:T", "A:G", "T:-", "A:CGT"])
@pytest.mark.parametrize("exotic", [False, True])
def test_native_encode_equivalence(conv, exotic):
    from basal_jax.native import get_lib
    if get_lib() is None:
        pytest.skip("native engine unavailable")
    p = AlignParams(conversion=conv, randseed=1, verbose_level=0)
    old = os.environ.pop("BASAL_NO_NATIVE", None)
    try:
        a = E.encode_batch(p, _reads(42, exotic))
        os.environ["BASAL_NO_NATIVE"] = "1"
        b = E.encode_batch(p, _reads(42, exotic))
    finally:
        if old is None:
            os.environ.pop("BASAL_NO_NATIVE", None)
        else:
            os.environ["BASAL_NO_NATIVE"] = old
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), (conv, f)


@pytest.mark.parametrize("ss", [10, 11, 12, 13, 14, 15, 16])
def test_native_encode_seed_sizes(ss, monkeypatch):
    """The double-and-add window-hash build is seed-size-generic (every -s
    10..16 takes a different double/add sequence); pin native == numpy for
    each legal seed size."""
    from basal_jax.native import get_lib
    if get_lib() is None:
        pytest.skip("native engine unavailable")
    p = AlignParams(conversion="C:T", randseed=1, verbose_level=0,
                    seed_size=ss)
    monkeypatch.delenv("BASAL_NO_NATIVE", raising=False)
    a = E.encode_batch(p, _reads(ss, True))
    monkeypatch.setenv("BASAL_NO_NATIVE", "1")
    b = E.encode_batch(p, _reads(ss, True))
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), (ss, f)
