"""Device-evaluated ladders on the CPU backend: the PE strata ladder, the
read-sliced gapped SE ladder, the merge of ladder waves into one replay
result, and the memory-derived gapped dispatch chunk.  Every end-to-end
case compares the device-forced SAM body with the host-forced one."""

import numpy as np
import pytest

import chip_smoke as cs
from basal_jax.align import pipeline as sp
from basal_jax.pairs import pipeline as pp


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("ladder")
    g = cs.repeat_genome(np.random.default_rng(5), 150_000)
    ref = d / "ref.fa"
    cs.write_fasta(ref, g)
    return d, g, ref


@pytest.mark.parametrize("rule,gap", [("C:T", 0), ("A:G", 0), ("T:-", 2)])
def test_pe_ladder_matches_host(genome, monkeypatch, rule, gap):
    d, g, ref = genome
    monkeypatch.setattr(pp.PairEndAligner, "EAGER_MAX_CANDS", 1)
    frm, to = rule.split(":")
    r1, r2 = cs.pe_reads(np.random.default_rng(8), g, 150, 100, frm=frm,
                         to=to if to != "-" else frm)
    cs.write_fastq(d / f"a{gap}.fq", r1, "p")
    cs.write_fastq(d / f"b{gap}.fq", r2, "p")
    argv = ["-d", str(ref), "-a", str(d / f"a{gap}.fq"), "-b",
            str(d / f"b{gap}.fq"), "-M", rule, "-S", "1", "-V", "0", "-u"]
    if gap:
        argv += ["-g", str(gap)]
    al, *_ = cs.run_cli(argv, d / "dev.sam", BASAL_HOST_EVAL="0")
    s = al.stage
    assert s["cand_device"] > 0 and s["ladder_waves"] > s["batches_bulk"]
    assert s["cand_device"] < s["cand_enum"]  # modes past resolution skipped
    cs.forced_pair(f"pe-{rule}", argv, d, 150, unit="pairs")


@pytest.mark.parametrize("budget", [1 << 16, 1 << 20])
def test_sliced_gapped_ladder_matches_host(genome, monkeypatch, budget):
    d, g, ref = genome
    monkeypatch.setattr(sp.SingleEndAligner, "EAGER_MAX_CANDS", 1)
    monkeypatch.setattr(sp.SingleEndAligner, "LADDER_BYTES", budget)
    gfq = d / "gap.fq"
    cs.write_fastq(gfq, cs.deletion_reads(np.random.default_rng(9), g, 120,
                                          100)[0])
    argv = ["-d", str(ref), "-a", str(gfq), "-M", "T:-", "-n", "1", "-g",
            "3", "-R", "-u", "-S", "1", "-V", "0"]
    slices = []
    real = sp.SingleEndAligner._read_slices
    monkeypatch.setattr(sp.SingleEndAligner, "_read_slices",
                        lambda self, g, B: slices.append(real(self, g, B))
                        or slices[-1])
    al, *_ = cs.run_cli(argv, d / "dev.sam", BASAL_HOST_EVAL="0")
    assert al.stage["cand_device"] > 0 and len(slices[0]) > 1
    assert al.stage["ladder_waves"] > len(slices[0])
    # each slice evaluates only its own reads: the same volume as one ladder
    monkeypatch.setattr(sp.SingleEndAligner, "LADDER_BYTES", 1 << 50)
    whole, *_ = cs.run_cli(argv, d / "dev.sam", BASAL_HOST_EVAL="0")
    assert len(slices) == 1
    assert al.stage["cand_device"] == whole.stage["cand_device"]
    cs.forced_pair("gap-sliced", argv, d, 120)


def test_read_slices_bound_enumerated_volume():
    al = sp.SingleEndAligner.__new__(sp.SingleEndAligner)
    al.p = type("P", (), {"gap": 3})()
    al.LADDER_BYTES = 100 * al._cand_bytes()
    groups = np.zeros((6, 10), np.int64)
    groups[:, 0] = [0, 0, 1, 2, 3, 3]        # read
    groups[:, 6] = [30, 40, 90, 250, 5, 5]   # candidates
    slices = al._read_slices(groups, 5)
    assert [np.flatnonzero(m).tolist() for m in slices] == [[0], [1], [2],
                                                            [3, 4]]


def test_gather_ranges_and_wave_merge():
    wave_of = np.array([1, 0, 1])
    parts = [np.array([10, 11, 12]), np.array([20, 21, 22, 23, 99])]
    offs = [np.array([0, 1, 3, 3]), np.array([0, 2, 2, 4])]
    rows, off = sp.gather_ranges(parts, offs, wave_of)
    assert rows.tolist() == [20, 21, 11, 12, 22, 23]
    assert off.tolist() == [0, 2, 4, 6]
    masks = [np.array([False, True, False]), np.array([True, False, True])]
    assert sp.wave_of_reads(list(zip(masks, [None, None])), 3).tolist() \
        == [1, 0, 1]
    assert sp.wave_of_reads([(None, None)], 2).tolist() == [0, 0]


def test_merge_se_waves_takes_each_read_from_its_wave():
    def res(stratum, hits):
        hoff = np.concatenate(([0], np.cumsum([len(h) for h in hits])))
        flat = np.array(sum(hits, []) + [-7] * 3, np.int32)  # spare capacity
        return (np.array(stratum, np.int32), np.zeros(3, np.int32),
                np.array([len(h) for h in hits], np.int32), flat, flat + 1,
                flat * 0, flat * 0, flat.astype(np.uint8), hoff)
    w0 = res([0, -2, 1], [[5], [], [6, 7]])
    w1 = res([-1, 2, -1], [[], [8, 9], []])
    m = sp.merge_se_waves([(np.array([True, False, True]), w0),
                           (np.array([False, True, False]), w1)], 3)
    assert m[0].tolist() == [0, 2, 1]
    assert m[3].tolist() == [5, 8, 9, 6, 7]
    assert m[8].tolist() == [0, 1, 3, 5]


def test_row_starts_is_linear_unique():
    row = np.array([0, 0, 3, 3, 3, 7, 9, 9], np.int32)
    used, first = sp.row_starts(row)
    u2, f2 = np.unique(row, return_index=True)
    assert used.tolist() == u2.tolist() and first.tolist() == f2.tolist()
    assert sp.row_starts(np.zeros(0, np.int32))[0].size == 0
    with pytest.raises(AssertionError):
        sp.row_starts(np.array([2, 1], np.int32))


def test_gapped_chunk_follows_memory_analysis():
    cap = 4 << 20
    assert sp.gapped_chunk("oneway", 3, 7, 4096, None, cap) == cap
    # a limit this small fits less than the floor
    assert sp.gapped_chunk("oneway", 3, 7, 4096, 1 << 20, cap,
                           probe=1024) == 1 << 16
    big = 1 << 40
    assert sp.gapped_chunk("oneway", 3, 7, 4096, big, cap,
                           probe=1024) == cap
    mid = 64 << 30
    c7 = sp.gapped_chunk("oneway", 3, 7, 4096, mid, cap, probe=1024)
    c16 = sp.gapped_chunk("oneway", 3, 16, 4096, mid, cap, probe=1024)
    assert c16 <= c7 and c16 & (c16 - 1) == 0
