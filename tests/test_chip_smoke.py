"""chip_smoke.py's phases at a tiny size on the CPU backend, and its refusal
to run without a GPU.  (The script itself is run on the GPU; here only its
control flow, data generators and checks are exercised.)"""

import pytest

import chip_smoke as cs


def test_main_refuses_cpu_backend(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phase_env():
    assert cs.phase_env()["cache"]


def test_phase_kernels_tiny(tmp_path):
    times = cs.phase_kernels(tmp_path, C=2048, U=64, genome_bp=60_000,
                             lengths=(100,), reps=1)
    assert len(times) == len(cs.KERNEL_CASES)


def test_phase_long_gap_tiny(tmp_path):
    cs.phase_long_gap(tmp_path, C=1024, U=64, genome_bp=60_000)


def test_main_takes_no_size_options():
    with pytest.raises(SystemExit):
        cs.main(["--reads", "10"])


@pytest.fixture(scope="module")
def se_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("smoke_se")
    return d, cs.phase_se(d, genome_bp=120_000, n_reads=600)


def test_phase_se_tiny(se_data):
    _, se = se_data
    assert se["ref"].exists() and se["fq"].exists()


def test_phase_pe_gap_tiny(se_data):
    d, se = se_data
    cs.phase_pe_gap(d, se["g"], se["ref"], n_pairs=200, n_gap=150)


def test_phase_four_on_virtual_devices(tmp_path):
    cs.phase_four(tmp_path, genome_bp=80_000, n_reads=400, n_gap=100,
                  settings=(("4x1", "4x1"), ("2x2", "2x2"), ("one", "0")))


def test_read_generators_shapes():
    import numpy as np
    rng = np.random.default_rng(0)
    g = cs.repeat_genome(rng, 50_000)
    assert g.shape == (50_000,) and set(np.unique(g)) <= set(b"ACGT")
    r1, r2 = cs.pe_reads(rng, g, 50, 150)
    assert r1.shape == r2.shape == (50, 150)
    d, pos = cs.deletion_reads(rng, g, 50, 100)
    assert d.shape == (50, 100) and pos.shape == (50,)
