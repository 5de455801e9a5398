"""PE candidate-volume guard: degenerate batches split transparently.

PairEndAligner probes end a's candidate volume before committing to a bulk
batch (pairs/pipeline.py MAX_BATCH_CANDS); over the cap it re-runs the
batch in byte-equivalent sub-chunks (restoring the scheduler's sticky state
AND the stale seed buffers between the probe and the re-run).  These tests
force a tiny cap and pin (1) byte-equality to the oracle and (2) that the
split path actually fired.
"""

import pytest

from conftest import have_oracle, make_fastq, make_ref, norm_sam, \
    random_genome, run_oracle
from test_differential_pe import _fd, pe_reads, run_ours

pytestmark = pytest.mark.skipif(not have_oracle(), reason="oracle not built")


def test_pe_volume_split_byte_identical(tmp_path, rng, monkeypatch):
    from basal_jax.pairs import pipeline as pp
    # the volume guard protects DEVICE dispatch (host eval bounds its own
    # volume at visit time); force device placement so the cap is live
    monkeypatch.setenv("BASAL_HOST_EVAL", "0")
    # repetitive genome -> real candidate volume; cap forces >= 2 sub-chunks
    core = random_genome(rng, 800)
    g = core * 6 + random_genome(rng, 5000)
    make_ref(tmp_path / "ref.fa", [("chrP", g)])
    r1, r2 = pe_reads(rng, g, 600, 90, rule="C:T")  # > the 512-pair probe gate
    make_fastq(tmp_path / "r1.fq", r1)
    make_fastq(tmp_path / "r2.fq", r2)
    base = ["-a", "r1.fq", "-b", "r2.fq", "-d", "ref.fa", "-M", "C:T",
            "-V", "0", "-S", "11"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr

    fired = {}
    orig_init = pp.PairEndAligner.__init__

    def patched(self, *a, **kw):
        orig_init(self, *a, **kw)
        self.MAX_BATCH_CANDS = 2000  # force the split path
        fired["al"] = self

    monkeypatch.setattr(pp.PairEndAligner, "__init__", patched)
    ours = run_ours(base, tmp_path)
    got = norm_sam(ours)
    want = norm_sam((tmp_path / "oracle.sam").read_text())
    assert got == want, _fd(got, want)
    assert fired["al"].stage["batches_split"] >= 1, \
        "cap did not trigger the split path"


def test_pe_split_mixed_lengths_stale_state(tmp_path, rng, monkeypatch):
    """The probe->restore->re-run cycle must restore the stale seed buffers
    too: mixed-length mates make the re-run consume them."""
    from basal_jax.pairs import pipeline as pp
    core = random_genome(rng, 600)
    g = core * 5 + random_genome(rng, 4000)
    make_ref(tmp_path / "ref.fa", [("chrP", g)])
    r1, r2 = pe_reads(rng, g, 600, 90, rule="C:T")
    # truncate a deterministic subset to stale-triggering lengths
    # ((L-I+1) % s == 0: 83, 99 -> mates shorter than 90 use 83, 67)
    r1 = [(n, s[:83] if i % 3 == 0 else (s[:67] if i % 7 == 0 else s))
          for i, (n, s) in enumerate(r1)]
    r2 = [(n, s[:83] if i % 4 == 1 else s) for i, (n, s) in enumerate(r2)]
    make_fastq(tmp_path / "r1.fq", r1)
    make_fastq(tmp_path / "r2.fq", r2)
    base = ["-a", "r1.fq", "-b", "r2.fq", "-d", "ref.fa", "-M", "C:T",
            "-V", "0", "-S", "3"]
    r = run_oracle(base + ["-o", "oracle.sam"], tmp_path)
    assert r.returncode == 0, r.stderr
    monkeypatch.setenv("BASAL_HOST_EVAL", "0")
    monkeypatch.setattr(pp.PairEndAligner, "MAX_BATCH_CANDS", 1500)
    ours = run_ours(base, tmp_path)
    got = norm_sam(ours)
    want = norm_sam((tmp_path / "oracle.sam").read_text())
    assert got == want, _fd(got, want)
