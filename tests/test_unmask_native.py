"""bt_unmask_blocks (single-pass C++ unmasked-region scan) must produce
exactly the blocks of the numpy transition-scan twin for every edge shape:
leading/trailing N, IUPAC chars (neither start nor end runs), runs < 16 bp,
all-N, all-ACGT.  Ref semantics: RefSeq::UnmaskRegion, refbase.cpp:103-128."""

import random

import numpy as np
import pytest

from basal_jax.index import reference as R


def _py_blocks(seq, count, total_len):
    """The numpy twin, forced (bypasses the native fast path)."""
    length = len(seq)
    useful = R.USEFUL[seq]
    nx = R.NXMASK[seq]
    out = []
    useful_idx = np.flatnonzero(useful[1:] & ~useful[:-1]) + 1
    if length and useful[0]:
        useful_idx = np.concatenate([[0], useful_idx])
    nx_idx = np.flatnonzero(nx[1:] & ~nx[:-1]) + 1
    if length and nx[0]:
        nx_idx = np.concatenate([[0], nx_idx])
    end = 0
    while end < length:
        k = np.searchsorted(useful_idx, end)
        if k == len(useful_idx):
            break
        begin = int(useful_idx[k])
        k2 = np.searchsorted(nx_idx, begin)
        bend = int(nx_idx[k2]) if k2 < len(nx_idx) else length
        bend = min(bend, length)
        if bend - begin >= 16:
            out.append((count, begin, bend))
            out.append((count + 1, total_len - bend, total_len - begin))
        end = bend
    return out


CASES = [
    "",
    "ACGT" * 3,                       # 12 bp: below the 16 bp floor
    "ACGT" * 8,                       # clean 32 bp run
    "N" * 50,
    "N" * 10 + "ACGT" * 10 + "N" * 5 + "acgt" * 4,
    "RYKM" + "ACGT" * 5 + "N" + "ACGT" * 4,   # IUPAC prefix joins no run
    "ACGT" * 5 + "R" * 30 + "ACGT" * 5,       # IUPAC inside: run continues
    "x" + "A" * 20 + "X" + "C" * 15 + "n" + "G" * 16,
]


@pytest.mark.parametrize("case_id", range(len(CASES)))
def test_unmask_native_matches_python(case_id):
    from basal_jax.native import get_lib
    if get_lib() is None:
        pytest.skip("native engine unavailable")
    s = CASES[case_id]
    seq = np.frombuffer(s.encode("latin1"), np.uint8)
    total_len = (len(seq) + 31) // 32 * 32 + 64
    got = [(b.id, b.begin, b.end)
           for b in R._unmask_region(seq, 4, total_len)]
    want = _py_blocks(seq, 4, total_len)
    assert got == want, s


def test_unmask_native_fuzz():
    from basal_jax.native import get_lib
    if get_lib() is None:
        pytest.skip("native engine unavailable")
    rng = random.Random(31337)
    for rep in range(200):
        n = rng.randrange(0, 400)
        s = "".join(rng.choice("ACGTacgtNXnxRYKMBDHV-")
                    for _ in range(n))
        seq = np.frombuffer(s.encode("latin1"), np.uint8)
        total_len = (n + 31) // 32 * 32 + 64
        got = [(b.id, b.begin, b.end)
               for b in R._unmask_region(seq, 0, total_len)]
        want = _py_blocks(seq, 0, total_len)
        assert got == want, s
