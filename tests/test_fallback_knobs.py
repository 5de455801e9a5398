"""Fallback-knob matrix: every advertised env knob must leave output
byte-identical to the oracle on a small SE + PE + gapped + RRBS config.

The project's central claim is that the golden twins and the fast paths
are interchangeable (CLAUDE.md "Bit-exactness rules"); this pins each
documented knob so a fallback path cannot rot silently:

  BASAL_FUSED=0       split (non-fused) host pipeline, align/pipeline.py
  BASAL_NO_NATIVE=1   pure-Python scheduler/replay/format twins
  BASAL_HOST_EVAL=1   forced C++ SIMD candidate evaluation
  BASAL_HOST_EVAL=0   forced device (XLA) evaluation

Each (knob-set, config) run is a subprocess so knobs read at import time
are honored; the child env pins PYTHONPATH to the checkout and jax to the
CPU, same as test_differential_se.py's NO_NATIVE subprocess test.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import (convert_reads, have_oracle, make_fastq, make_ref,
                      norm_sam, random_genome, run_oracle)
from test_differential_gap import deletion_reads
from test_differential_pe import pe_reads
from test_differential_rrbs import rrbs_genome, rrbs_reads

pytestmark = pytest.mark.skipif(not have_oracle(), reason="oracle not built")

ROOT = Path(__file__).resolve().parents[1]

# (name, env overrides, needs jax import in the child)
KNOBS = [
    ("fused0", {"BASAL_FUSED": "0"}, False),
    ("nonative", {"BASAL_NO_NATIVE": "1"}, False),
    ("hosteval1", {"BASAL_HOST_EVAL": "1"}, False),
    ("device", {"BASAL_HOST_EVAL": "0"}, True),
]

CONFIGS = ["se", "pe", "gap", "rrbs"]


def _build_config(name, d):
    """Write ref/reads for config `name` into dir `d`, run the oracle once,
    and return the CLI base argv (shared by oracle and ours)."""
    import random
    rng = random.Random(0xFA11 + CONFIGS.index(name))
    if name == "se":
        g = random_genome(rng, 6000)
        make_ref(d / "ref.fa", [("chrS", g)])
        make_fastq(d / "reads.fq",
                   convert_reads(rng, g, 40, 80, "A:G", rate=0.5,
                                 sub_rate=0.01, revcomp_frac=0.3))
        base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "A:G", "-V", "0",
                "-S", "41", "-u"]
    elif name == "pe":
        g = random_genome(rng, 8000)
        make_ref(d / "ref.fa", [("chrP", g)])
        r1, r2 = pe_reads(rng, g, 30, 90, rule="C:T")
        make_fastq(d / "r1.fq", r1)
        make_fastq(d / "r2.fq", r2)
        base = ["-a", "r1.fq", "-b", "r2.fq", "-d", "ref.fa", "-M", "C:T",
                "-V", "0", "-S", "42", "-u"]
    elif name == "gap":
        g = random_genome(rng, 7000)
        make_ref(d / "ref.fa", [("chrG", g)])
        make_fastq(d / "reads.fq", deletion_reads(rng, g, 35, 100))
        base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "T:-", "-V", "0",
                "-S", "43", "-n", "1", "-g", "3", "-R", "-u"]
    else:  # rrbs
        g = rrbs_genome(rng, n_frags=40)
        make_ref(d / "ref.fa", [("chrR", g)])
        make_fastq(d / "reads.fq", rrbs_reads(rng, g, 40))
        base = ["-a", "reads.fq", "-d", "ref.fa", "-M", "C:T", "-V", "0",
                "-S", "44", "-D", "C-CGG", "-u"]
    r = run_oracle(base + ["-o", "oracle.sam"], d)
    assert r.returncode == 0, r.stderr
    return base


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Each config's ref/reads/oracle.sam built exactly once."""
    out = {}
    for name in CONFIGS:
        d = tmp_path_factory.mktemp(f"knob_{name}")
        out[name] = (d, _build_config(name, d))
    return out


@pytest.mark.parametrize("knob,env_over,needs_jax",
                         KNOBS, ids=[k[0] for k in KNOBS])
@pytest.mark.parametrize("config", CONFIGS)
def test_knob_matrix(datasets, knob, env_over, needs_jax, config):
    d, base = datasets[config]
    out = f"ours_{knob}.sam"
    env = {**os.environ, **env_over, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT)}
    pre = ("import jax; jax.config.update('jax_platforms','cpu');"
           if needs_jax else "")
    r = subprocess.run(
        [sys.executable, "-c",
         pre + "from basal_jax import cli; cli.main("
         + repr(base + ["-o", out]) + ")"],
        cwd=d, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = norm_sam((d / out).read_text())
    want = norm_sam((d / "oracle.sam").read_text())
    assert got == want, f"{knob}/{config}: {len(got)} vs {len(want)} lines"
