"""Multi-chip extension == single-device extension, element-for-element.

The dp x rs shard_map path (parallel/mesh.py) must
be proven equal to the single-device extend kernel on a full-size batch —
including gap mode, non-uniform per-read candidate counts (repetitive
genome), and rs>1 reference sharding — not just shape-checked.
"""

import numpy as np
import pytest

from conftest import make_fastq, make_ref, random_genome, convert_reads


def _repeat_genome(rng, n_unique=20000, unit=311, copies=24):
    """Genome with a tandem-repeat block: reads landing in it enumerate
    10-100x more candidates than unique-region reads, so per-dp-shard
    candidate distribution is highly non-uniform."""
    head = random_genome(rng, n_unique // 2)
    rep = random_genome(rng, unit) * copies
    tail = random_genome(rng, n_unique // 2)
    return head + rep + tail


def _candidates(tmp_path, rng, conversion, gap, nt3=False):
    from basal_jax.align.candidates import build_candidates
    from basal_jax.align.pipeline import SingleEndAligner
    from basal_jax.config import AlignParams
    from basal_jax.index.reference import load_reference
    from basal_jax.index.seedindex import build_index
    from basal_jax.reads.encode import encode_batch
    from basal_jax.reads.io import open_reads

    ref_txt = _repeat_genome(rng)
    make_ref(tmp_path / "ref.fa", [("chr1", ref_txt)])
    reads = convert_reads(rng, ref_txt, 300, 90, rule=conversion,
                          revcomp_frac=0.5, sub_rate=0.01)
    make_fastq(tmp_path / "reads.fq", reads)
    p = AlignParams(conversion=conversion, randseed=7, gap=gap, nt3=nt3)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    index = build_index(ref, p)
    al = SingleEndAligner(p, ref, index, use_native=False)
    rd = open_reads(str(tmp_path / "reads.fq"), p)
    batch = rd.next_batch()
    enc = encode_batch(p, batch)
    table = build_candidates(p, index, enc, al.sched)
    assert table.loc.size > 5000
    # non-uniformity sanity: candidate counts per read must vary wildly
    per_read = np.bincount(table.row >> 1, minlength=len(batch))
    assert per_read.max() > 20 * max(np.median(per_read), 1)
    return p, ref, enc, table


@pytest.mark.parametrize("conversion,gap", [("C:T", 0), ("T:-", 3)])
def test_mesh_extend_equals_single_device(tmp_path, rng, conversion, gap):
    import jax

    from basal_jax.align.pipeline import DeviceContext
    from basal_jax.parallel.mesh import ShardedDeviceContext, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    p, ref, enc, table = _candidates(tmp_path, rng, conversion, gap)

    dev = DeviceContext(ref, p)
    c0, p0, p1 = dev.extend(enc, table.loc, table.plane, table.row)

    for n_dp, n_rs in ((8, 1), (4, 2), (2, 4)):
        ctx = ShardedDeviceContext(ref, p, make_mesh(n_dp, n_rs))
        c, q0, q1 = ctx.extend(enc, table.loc, table.plane, table.row)
        np.testing.assert_array_equal(
            np.asarray(c), np.asarray(c0),
            err_msg=f"counts diverge on mesh {n_dp}x{n_rs}")
        if gap > 0:
            np.testing.assert_array_equal(np.asarray(q0), np.asarray(p0))
            np.testing.assert_array_equal(np.asarray(q1), np.asarray(p1))


def test_mesh_selected_in_pipeline(tmp_path, rng, monkeypatch):
    """With >1 visible device the production SE pipeline must pick the
    sharded context and produce output identical to the single-device
    path on the same input."""
    import jax

    from test_differential_se import run_ours

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    ref_txt = _repeat_genome(rng, n_unique=12000, copies=12)
    make_ref(tmp_path / "ref.fa", [("chr1", ref_txt)])
    reads = convert_reads(rng, ref_txt, 200, 80, rule="C:T",
                          revcomp_frac=0.5, sub_rate=0.01)
    make_fastq(tmp_path / "reads.fq", reads)

    outs = {}
    argv = ["-d", "ref.fa", "-a", "reads.fq", "-M", "C:T", "-S", "9",
            "-V", "0", "-u", "-o", "out.sam"]
    for spec in ("0", "4x2"):
        monkeypatch.setenv("BASAL_MESH", spec)
        # force the device evaluator (host eval would bypass the mesh)
        monkeypatch.setenv("BASAL_HOST_EVAL", "0")
        run_ours(argv, tmp_path)
        outs[spec] = [l for l in (tmp_path / "out.sam").read_text().splitlines()
                      if not l.startswith("@")]
    assert outs["0"] == outs["4x2"]
    assert len(outs["0"]) >= 200
