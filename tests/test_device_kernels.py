"""Device extension kernels == the native host evaluator, exactly.

``host_eval_candidates[_gap]`` (native/engine.cpp) is the bit-exact C++
twin of the device kernels: same conversion-mask algebra, same mismatch
position lists.  Both XLA entries the pipeline dispatches — the
single-transfer blob and the 3-transfer packed layout — must reproduce it
on identical candidates, at 100 bp (W = 7) and 150 bp (W = 10).  The
arithmetic is integer throughout, so the comparison is exact.  The same
check runs on a GPU (``gpu`` marker) and at production shapes in
chip_smoke.py's kernel phase.
"""

import numpy as np
import pytest

CASES = [  # (rule, nt3, gap)
    ("C:T", False, 0),      # one-way
    ("A:CGT", False, 0),    # multi-way
    ("C:T", True, 0),       # nt3
    ("T:-", False, 3),      # BID-seq gapped
    ("C:T", False, 1),
    ("A:CGT", False, 2),
]
IDS = ["oneway", "multiway", "nt3", "gap3-T-", "gap1-CT", "gap2-ACGT"]


def _case(tmp_path, rule, nt3, gap, L, C=2048, U=64):
    from chip_smoke import kernel_case
    return kernel_case(tmp_path, rule, nt3, gap, L, C, U, 60_000, seed=3)


def _host(p, ref, enc, loc, plane, row):
    from basal_jax.native import host_eval_candidates, host_eval_candidates_gap
    if p.gap:
        c, p0, p1 = host_eval_candidates_gap(p, ref, enc, loc, plane, row)
        return c.astype(np.int32), p0, p1
    return (host_eval_candidates(p, ref, enc, loc, plane, row)
            .astype(np.int32), None, None)


def _device(p, ref, enc, loc, plane, row, use_blob):
    from basal_jax.align.pipeline import DeviceContext
    dev = DeviceContext(ref, p)
    dev.use_blob = use_blob
    return dev.extend(enc, loc, plane, row)


def _assert_same(got, want):
    for name, a, b in zip(("counts", "pos0", "pos1"), got, want):
        if b is None:
            assert a is None, name
            continue
        assert np.array_equal(np.asarray(a), b), name


@pytest.mark.parametrize("L", [100, 150], ids=["W7", "W10"])
@pytest.mark.parametrize("rule,nt3,gap", CASES, ids=IDS)
def test_xla_kernels_match_host_twin(tmp_path, rule, nt3, gap, L):
    p, ref, enc, loc, plane, row = _case(tmp_path, rule, nt3, gap, L)
    assert enc.W == (7 if L == 100 else 10)
    want = _host(p, ref, enc, loc, plane, row)
    # near-true-start candidates are present; gapped rows with fewer than
    # K_POS mismatches exercise the position lists' fill padding
    assert (want[0] <= (13 if gap else 5)).any()
    for use_blob in (True, False):
        _assert_same(_device(p, ref, enc, loc, plane, row, use_blob), want)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("W", [7, 10])
def test_first_positions_min_extract_equals_sort(W, reverse):
    """The K_POS min-extract passes == a full row sort's first K_POS,
    fill padding included (rows with no, few and many mismatches)."""
    import jax.numpy as jnp

    from basal_jax.ops.bitops import lane_flags
    from basal_jax.ops.extend import K_POS, _first_positions
    rng = np.random.default_rng(W + 2 * reverse)
    C = 64
    L = rng.integers(W * 16 - 15, W * 16 + 1, C).astype(np.int32)
    density = np.repeat([0.0, 0.02, 0.1, 0.5], C // 4)[:, None]
    lanes = rng.random((C, W * 16)) < density
    lanes &= np.arange(W * 16)[None, :] < L[:, None]   # lenmask
    words = np.zeros((C, W), np.uint32)
    for j in range(16):  # first base at bits 31:30 of each word
        words |= (lanes[:, j::16].astype(np.uint32)
                  << np.uint32(30 - 2 * j))
    got = np.asarray(_first_positions(jnp.asarray(words), jnp.asarray(L),
                                      W, reverse))
    bits = np.asarray(lane_flags(jnp.asarray(words)))
    lane_set = np.stack([(bits >> np.uint32(30 - 2 * j)) & 1
                         for j in range(16)], axis=2).reshape(C, W * 16)
    idx = np.arange(W * 16)[None, :]
    pos = (L[:, None] - 1 - idx) if reverse else np.broadcast_to(idx, lane_set.shape)
    score = np.where(lane_set != 0, pos, L[:, None])
    want = np.sort(score, axis=1)[:, :K_POS]
    assert np.array_equal(got, want)
    assert (want == L[:, None]).any()  # fill padding exercised


@pytest.mark.gpu
@pytest.mark.parametrize("rule,nt3,gap", CASES, ids=IDS)
def test_gpu_kernels_match_host_twin(tmp_path, gpu_device, rule, nt3, gap):
    """The same check with the kernels compiled for the GPU (run there
    with: JAX_PLATFORMS=cuda python -m pytest tests -m gpu)."""
    import jax
    p, ref, enc, loc, plane, row = _case(tmp_path, rule, nt3, gap, 150,
                                         C=1 << 16, U=1024)
    want = _host(p, ref, enc, loc, plane, row)
    with jax.default_device(gpu_device):
        got = _device(p, ref, enc, loc, plane, row, use_blob=True)
    _assert_same(got, want)
