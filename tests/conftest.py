import os

# The CPU suite: jax on the CPU backend with 8 virtual devices, so the
# (dp, rs) mesh paths run here.  CPU devices report no memory limit, so the
# automatic mesh shape is pinned to pure data parallelism (what it picks
# for these tiny references); tests that exercise other shapes set
# BASAL_MESH themselves.  Tests that need a GPU carry the ``gpu`` marker
# and the ``gpu_device`` fixture, which skips them here.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip(),
)
os.environ.setdefault("BASAL_MESH", "8x1")

import jax

# no persistent compilation cache in the CPU suite: XLA:CPU entries are
# tied to this host's CPU features, and the GPU path is what it is for
jax.config.update("jax_enable_compilation_cache", False)

import random
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ORACLE = Path(__file__).resolve().parents[1] / ".oracle" / "basal"

# Fail LOUDLY if the C++ engine does not build: the suite would otherwise
# silently pass through the pure-Python twins (golden but far slower),
# leaving native-path regressions untested.
if not os.environ.get("BASAL_NO_NATIVE"):
    from basal_jax.native import native_available
    assert native_available(), (
        "native engine failed to build -- see stderr; "
        "set BASAL_NO_NATIVE=1 to test the Python twins on purpose")


def have_oracle() -> bool:
    return ORACLE.exists()


# Build the vendored samtools validator on demand so the strongest BAI
# validation (tests/test_bamindex.py) never silently skips on a fresh
# checkout.  Cheap no-op when already built.
_SAMTOOLS = ORACLE.parent / "samtools"
if not _SAMTOOLS.exists():
    _script = Path(__file__).resolve().parents[1] / "tools" / "build_samtools.sh"
    if _script.exists():
        subprocess.run(["bash", str(_script)], capture_output=True,
                       timeout=600)


def run_oracle(args, cwd):
    return subprocess.run([str(ORACLE)] + args, cwd=cwd, capture_output=True,
                          text=True, timeout=600)


def make_ref(path, seqs):
    with open(path, "w") as f:
        for name, seq in seqs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")


def make_fastq(path, reads):
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def random_genome(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def convert_reads(rng, ref, n, readlen, rule, rate=0.5, sub_rate=0.0,
                  revcomp_frac=0.0):
    """Simulate base-conversion reads: convert-from base -> one of the
    convert-to bases at `rate`; optional random substitutions."""
    frm, tos = rule.split(":")
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(n):
        pos = rng.randrange(0, len(ref) - readlen)
        s = list(ref[pos:pos + readlen])
        rc = rng.random() < revcomp_frac
        if rc:
            s = [c.translate(comp) for c in reversed(s)]
        for j, c in enumerate(s):
            if c == frm and rng.random() < rate:
                t = rng.choice(tos)
                if t == "-":
                    continue  # deletions handled by dedicated tests
                s[j] = t
            elif sub_rate and rng.random() < sub_rate:
                s[j] = rng.choice("ACGT".replace(c, ""))
        reads.append((f"r{i}_p{pos}{'_rc' if rc else ''}", "".join(s)))
    return reads


def norm_sam(text):
    """SAM lines normalized for comparison: drop @PG (command line differs)."""
    out = []
    for line in text.splitlines():
        if line.startswith("@PG"):
            continue
        out.append(line)
    return out


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped (via the gpu_device "
        "fixture) where jax sees none")


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip.  Decided when the test runs, never at
    import, so every xdist worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:  # no GPU backend in this process
        devs = []
    if not devs:
        pytest.skip("no GPU visible to jax")
    return devs[0]


@pytest.fixture
def rng():
    return random.Random(20260816)
