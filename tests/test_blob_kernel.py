"""Single-transfer blob upload (ops.extend.carve_blob) == packed path.

The blob entry derives the valid/lenmask planes on device and carries the
strand plane in loc bit 31; these tests pin its equality to the 3-transfer
packed path at the DeviceContext level (the production builder), including
reads WITH Ns (exception validity rows) and mixed read lengths (derived
lenmask).
"""

import numpy as np
import pytest


def _make_case(tmp_path, rng, rule, gap, nt3=False, n_mis=False):
    from basal_jax.align.candidates import SeedScheduler, build_candidates
    from basal_jax.align.rng import MyRand
    from basal_jax.config import AlignParams
    from basal_jax.index.reference import load_reference
    from basal_jax.index.seedindex import build_index
    from basal_jax.reads.encode import encode_batch
    from basal_jax.reads.io import ReadRec
    from conftest import make_ref, random_genome

    g = random_genome(rng, 9000)
    make_ref(tmp_path / "ref.fa", [("c1", g)])
    p = AlignParams(conversion=rule, randseed=1, gap=gap, nt3=nt3,
                    n_mis=n_mis, chains=1)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    idx = build_index(ref, p)
    frm, tos = rule.split(":")
    reads = []
    for i in range(96):
        ln = rng.choice([64, 80, 90, 100])
        pos = rng.randrange(16, len(g) - ln - 10)
        tos_sub = tos.replace("-", "")
        w = list(g[pos:pos + ln])
        if tos_sub:
            w = [rng.choice(tos_sub) if (c == frm and rng.random() < 0.4)
                 else c for c in w]
        elif gap:  # deletion rule (e.g. T:-): drop converted bases
            drop = [j for j, c in enumerate(w)
                    if c == frm and rng.random() < 0.1][:gap]
            for j in reversed(drop):
                del w[j]
        # every 3rd read carries Ns -> exception validity rows in the blob
        if i % 3 == 0:
            for _ in range(rng.randrange(1, 3)):
                w[rng.randrange(len(w))] = "N"
        reads.append(ReadRec(i, 0, f"r{i}", "".join(w), "I" * ln))
    enc = encode_batch(p, reads)
    assert enc._hasn_cache is None if hasattr(enc, "_hasn_cache") else True
    table = build_candidates(p, idx, enc, SeedScheduler(p, idx, MyRand(1)))
    assert table.loc.size > 50
    return p, ref, enc, table


def _ctx_extend(p, ref, enc, table, use_blob):
    from basal_jax.align.pipeline import DeviceContext
    dev = DeviceContext(ref, p)
    dev.use_blob = use_blob
    return dev.extend(enc, table.loc.astype(np.int32),
                      table.plane.astype(np.int32), table.row)


@pytest.mark.parametrize("rule,gap,nt3,n_mis", [
    ("C:T", 0, False, False),
    ("C:T", 0, False, True),      # -N: ncnt rides in rowmeta bits 10-19
    ("A:CGT", 0, False, False),   # multiway: mread plane in the blob
    ("C:T", 0, True, False),      # nt3
    ("T:-", 3, False, False),     # gapped: derived lenmask feeds pos0/pos1
    ("A:CGT", 2, False, False),
])
def test_blob_matches_packed_devicecontext(tmp_path, rng, rule, gap, nt3,
                                           n_mis):
    p, ref, enc, table = _make_case(tmp_path, rng, rule, gap, nt3, n_mis)
    # some reads must actually have Ns for exception-row coverage
    assert (enc.valid != enc.lenmask).any()
    want = _ctx_extend(p, ref, enc, table, use_blob=False)
    got = _ctx_extend(p, ref, enc, table, use_blob=True)
    for name, a, b in zip(("counts", "pos0", "pos1"), got, want):
        if a is None:
            assert b is None
            continue
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_blob_fallback_on_many_n_rows(tmp_path, rng):
    """> 4094 exception rows -> _extend_blob returns None and the packed
    path takes over (rowmeta exception field is 12 bits)."""
    from basal_jax.align.pipeline import DeviceContext
    p, ref, enc, table = _make_case(tmp_path, rng, "C:T", 0)
    dev = DeviceContext(ref, p)
    enc._hasn_cache = np.ones(enc.base.shape[0], bool)  # force E == U > cap?
    loc = table.loc.astype(np.int32)
    plane = table.plane.astype(np.int32)
    used, first_idx = np.unique(table.row, return_index=True)
    if len(used) <= 4094:  # tiny batch: emulate the cap instead
        r = dev._build_blob(enc, loc, plane, used,
                            np.zeros(len(used) + 1, np.int32), 0, 0)
        assert r is not None  # under the cap it still builds
        # now force over-cap via a fake used vector
        big_used = np.zeros(4100, np.intp)
        enc._hasn_cache = np.ones(enc.base.shape[0], bool)
        r2 = dev._build_blob(enc, loc, plane, big_used,
                             np.zeros(4101, np.int32), 0, 0)
        assert r2 is None
