"""Where compiled programs are kept: JAX's persistent compilation cache
(utils.cache) and the AOT executable cache's default directory."""

import os

import jax
import pytest

from chromosome3d.utils import cache


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_placement(env, tmp_path, monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.configure_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; nothing else is configured
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = cache.configure_compile_cache()
        assert path == os.path.join(cache.CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    # the checkout is the directory holding the package
    assert os.path.isdir(os.path.join(cache.CHECKOUT, "chromosome3d"))


def test_aot_default_dir_in_checkout():
    from chromosome3d.utils.aot import DEFAULT_CACHE_DIR

    assert DEFAULT_CACHE_DIR == os.path.join(cache.CHECKOUT, ".aot_cache")
