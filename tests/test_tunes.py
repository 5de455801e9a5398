"""Allocator/THP tunes must be active after importing basal_jax.

_tune_numpy_thp turns off numpy's MADV_HUGEPAGE-on-large-buffers default
(on virtualized hosts the first touch of newly host-backed 2 MiB extents
is slow hypervisor-side, and a cold index build paid it for every table
page; basal_jax/__init__.py).  If
numpy's private toggle ever moves, the tune degrades to env-var-only
silently — this test makes that loud."""

import os


def test_numpy_thp_tune_active():
    import basal_jax  # noqa: F401  (import side effect applies the tune)

    assert os.environ.get("NUMPY_MADVISE_HUGEPAGE") == "0"
    try:
        from numpy._core import _multiarray_umath as mu
    except ImportError:
        from numpy.core import _multiarray_umath as mu
    get = getattr(mu, "_get_madvise_hugepage", None)
    if get is None:
        return  # no getter in this numpy: env-var coverage is all we can pin
    # _set_madvise_hugepage(False) must have stuck (returns previous value)
    assert get() is False


def test_malloc_tune_respects_env(monkeypatch):
    """BASAL_NO_MALLOC_TUNE=1 and explicit MALLOC_* env short-circuit
    the mallopt calls (the function must return before touching libc)."""
    import basal_jax

    monkeypatch.setenv("BASAL_NO_MALLOC_TUNE", "1")
    basal_jax._tune_malloc()  # must not raise
    monkeypatch.delenv("BASAL_NO_MALLOC_TUNE")
    monkeypatch.setenv("MALLOC_MMAP_THRESHOLD_", "65536")
    basal_jax._tune_malloc()  # must not raise


def test_numpy_thp_tune_respects_env(monkeypatch):
    monkeypatch.setenv("BASAL_NO_THP_TUNE", "1")
    import basal_jax

    basal_jax._tune_numpy_thp()  # must return without changing numpy state
