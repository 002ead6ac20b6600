"""The persistent compilation cache lives where JAX_COMPILATION_CACHE_DIR
says, else at build/jax_cache, and nowhere else."""

import glob
import os
import subprocess
import sys
import uuid

import pytest

from dcsexplorer_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = """
import jax, jax.numpy as jnp
from dcsexplorer_tpu.utils import compile_cache
path = compile_cache.enable()
def f(x):
    return x * 3 + 1
f.__name__ = {name!r}
jax.jit(f)(jnp.arange(17)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


def _compile_in_child(name, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    if env_dir is not None:
        env[compile_cache.ENV] = env_dir
    r = subprocess.run([sys.executable, "-c", _PROGRAM.format(name=name)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def _entries(directory, name):
    return glob.glob(os.path.join(directory, f"jit_{name}-*"))


@pytest.mark.parametrize("from_env", [True, False])
def test_cache_entries_land_in_one_directory(tmp_path, from_env):
    name = "cache_probe_" + uuid.uuid4().hex[:12]
    env_dir = str(tmp_path / "cache") if from_env else None
    used, configured = _compile_in_child(name, env_dir)
    want = env_dir or compile_cache.DEFAULT_DIR
    assert used == configured == want
    assert _entries(want, name)
    if from_env:
        assert not _entries(compile_cache.DEFAULT_DIR, name)
    else:
        for path in _entries(want, name):
            os.remove(path)


def test_cache_dir_prefers_the_environment(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV, "/elsewhere/cache")
    assert compile_cache.cache_dir() == "/elsewhere/cache"
    monkeypatch.delenv(compile_cache.ENV)
    assert compile_cache.cache_dir() == os.path.join(REPO, "build",
                                                     "jax_cache")
