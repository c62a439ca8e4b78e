"""Where the persistent compilation cache goes."""

import os
import subprocess
import sys

import jax

from hypergef.utils import cache

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_default_path_is_the_same_in_every_process(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT
    prog = ("from hypergef.utils.cache import enable_compile_cache;"
            "print(enable_compile_cache())")
    outs = {subprocess.run([sys.executable, "-c", prog], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120,
                           check=True).stdout.strip()
            for cwd in (ROOT, str(tmp_path))}
    assert outs == {os.path.join(ROOT, ".jax_cache")}
