"""Device bring-up plumbing: compile-cache placement, the automatic mesh
shape from device memory, and the host-keyed native engine build."""

import pytest


@pytest.fixture
def restore_cache_dir():
    import jax
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_repo_dir(monkeypatch, restore_cache_dir):
    import jax

    from basal_jax import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.enable_compile_cache()
    assert d == str(compile_cache.REPO_CACHE)
    assert compile_cache.REPO_CACHE.parent.joinpath("basal_jax").is_dir()
    assert compile_cache.REPO_CACHE.name == ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == d


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    the code sets no directory of its own."""
    import jax

    from basal_jax import compile_cache
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "sentinel"


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


GIB = 1 << 30


@pytest.mark.parametrize("ref_words,limit,want", [
    (200_000_000 // 16, 80 * GIB, (4, 1)),        # 200 Mbp: pure dp
    (4_000_000_000 // 16, 5 * GIB // 2, (2, 2)),  # 4 Gbp planes: 3.7 GiB
    (4_000_000_000 // 16, GIB, (1, 4)),
])
def test_auto_mesh_shape_from_memory_stats(ref_words, limit, want):
    from basal_jax.parallel.mesh import auto_mesh_shape, device_memory_bytes
    dev = _Dev({"bytes_limit": limit, "peak_bytes_in_use": 0})
    assert device_memory_bytes(dev) == limit
    assert auto_mesh_shape(4, ref_words, device_memory_bytes(dev)) == want


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_device_without_memory_limit_raises(stats):
    from basal_jax.parallel.mesh import device_memory_bytes
    with pytest.raises(RuntimeError, match="no memory limit"):
        device_memory_bytes(_Dev(stats))


def test_auto_mesh_needs_memory_limit(monkeypatch, tmp_path):
    """make_sharded_context never assumes a memory size: on devices that
    report none (CPU) the automatic shape raises; BASAL_MESH decides."""
    import random

    from basal_jax.config import AlignParams
    from basal_jax.index.reference import load_reference
    from basal_jax.parallel.mesh import make_sharded_context
    from conftest import make_ref, random_genome
    make_ref(tmp_path / "ref.fa", [("c", random_genome(random.Random(1),
                                                        2000))])
    p = AlignParams(conversion="C:T", randseed=1)
    ref = load_reference(str(tmp_path / "ref.fa"), p)
    monkeypatch.delenv("BASAL_MESH", raising=False)
    with pytest.raises(RuntimeError, match="no memory limit"):
        make_sharded_context(ref, p)
    monkeypatch.setenv("BASAL_MESH", "2x2")
    ctx = make_sharded_context(ref, p)
    assert (ctx.n_dp, ctx.n_rs) == (2, 2)


def test_native_library_keyed_to_host_cpu(monkeypatch):
    """A library built on another CPU never matches this host's name, so a
    copied .so is rebuilt instead of loaded."""
    from basal_jax import native
    here = native.lib_path()
    assert native.get_lib() is not None and here.exists()
    monkeypatch.setattr(native, "_host_cpu_id", lambda: b"another cpu")
    there = native.lib_path()
    assert there != here and there.parent == here.parent
    assert there.name.startswith("libbasal_engine.")


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_platform_devices(n):
    """The sharded step over n devices of the platform in use equals the
    single-device kernel (the CPU suite has 8 virtual devices)."""
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(n)


def test_dryrun_multichip_needs_the_devices():
    """No fallback to other devices: too few devices is an error."""
    from __graft_entry__ import dryrun_multichip
    with pytest.raises(AssertionError, match="need 16 devices"):
        dryrun_multichip(16)


@pytest.mark.parametrize("name,hint", [
    ("BASAL_XYZ", None), ("BASAL_OLD_MESH", "BASAL_MESH"),
    ("BASAL_OLD_HOST_EVAL", "BASAL_HOST_EVAL")])
def test_unknown_env_setting_is_refused(name, hint):
    from basal_jax.config import check_env
    check_env({"BASAL_MESH": "0", "HOME": "/x"})
    with pytest.raises(ValueError) as e:
        check_env({name: "1", "BASAL_THP": "0"})
    assert name in str(e.value)
    assert (f"did you mean {hint}?" in str(e.value)) == (hint is not None)


def test_cli_refuses_unknown_env_setting(monkeypatch, capsys):
    from basal_jax import cli
    monkeypatch.setenv("BASAL_OLD_NO_NATIVE", "1")
    with pytest.raises(SystemExit) as e:
        cli.main(["-M", "C:T", "-a", "x.fq", "-d", "x.fa"])
    assert e.value.code == 1
    assert "BASAL_NO_NATIVE" in capsys.readouterr().err


def test_env_knobs_cover_every_setting_read():
    import re
    from pathlib import Path

    from basal_jax.config import ENV_KNOBS
    root = Path(__file__).resolve().parents[1]
    names = set()
    for f in [*(root / "basal_jax").rglob("*.py"), root / "bench.py"]:
        names |= set(re.findall(r"\bBASAL_[A-Z0-9_]*[A-Z0-9]\b",
                                f.read_text()))
    assert names <= ENV_KNOBS, names - ENV_KNOBS
