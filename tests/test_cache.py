"""utils/cache.py: the compile cache honours JAX_COMPILATION_CACHE_DIR, or
else sits at a fixed path inside the checkout."""

import os

import jax

from pse_tpu.utils import cache


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_cache_env_dir_left_to_jax(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path / "jc"))
    assert cache.enable_compilation_cache() == str(tmp_path / "jc")
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0


def test_cache_default_dir_in_checkout(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv(cache.CACHE_ENV, raising=False)
    path = cache.enable_compilation_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache") == cache.DEFAULT_CACHE_DIR
    assert calls["jax_compilation_cache_dir"] == path
    assert os.path.isdir(path)
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
