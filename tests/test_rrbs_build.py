"""Pins the vectorized build_rrbs_index (searchsorted fragment scans +
zeros_mt CSR tables) against the exact scalar fallback
(BASAL_RRBS_SCALAR=1), and zeros_mt against np.zeros."""

import os
import random

import numpy as np
import pytest

from conftest import make_ref
from basal_jax.config import AlignParams
from basal_jax.index.reference import load_reference
from basal_jax.index.rrbs import build_rrbs_index
from basal_jax.native import zeros_mt


@pytest.mark.parametrize("n,dtype", [(7, np.int32), (1 << 21, np.int64),
                                     (0, np.int32)])
def test_zeros_mt(n, dtype):
    a = zeros_mt(n, dtype)
    assert a.dtype == dtype and a.shape == (n,)
    assert not a.any()


def _genome(rng, n_frags):
    parts = []
    for _ in range(n_frags):
        flen = rng.randrange(40, 400)
        parts.append("".join(rng.choice("ACGT") for _ in range(flen))
                     .replace("CCGG", "ACGG"))
        parts.append("CCGG")
    return "".join(parts)


@pytest.mark.parametrize("seed,site,kw", [
    (1, "C-CGG", {}),
    (2, "C-CGG", {"pairend": True}),           # opposite-plane remap branch
    (3, "C-CGG", {"min_insert": 1, "max_insert": 120}),  # tiny inserts:
    # first-fragment candidates may sit at index j itself (searchsorted
    # clamp-to-j+1 case)
    (4, "Y-CGR", {}),                          # IUPAC multi-expansion
    (5, "C-CGG", {"chains": 1}),
])
def test_vec_equals_scalar(tmp_path, monkeypatch, seed, site, kw):
    rng = random.Random(seed)
    g = _genome(rng, 300)
    ref_fa = tmp_path / "ref.fa"
    make_ref(ref_fa, [("chrA", g), ("chrB", _genome(rng, 120))])
    params = AlignParams(conversion="C:T", digestion_site=site,
                         rrbs_flag=True, randseed=1, **kw)
    ref = load_reference(str(ref_fa), params)
    monkeypatch.delenv("BASAL_RRBS_SCALAR", raising=False)
    vec = build_rrbs_index(str(ref_fa), ref, params)
    monkeypatch.setenv("BASAL_RRBS_SCALAR", "1")
    sca = build_rrbs_index(str(ref_fa), ref, params)
    np.testing.assert_array_equal(vec.starts, sca.starts)
    np.testing.assert_array_equal(vec.chrmode, sca.chrmode)
    np.testing.assert_array_equal(vec.locs, sca.locs)
    np.testing.assert_array_equal(vec.n1, sca.n1)
    assert vec.ccgg_sites == sca.ccgg_sites
