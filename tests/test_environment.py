"""Environment contracts: the compile-cache location, and the GPU entry
points refusing to run (or print a result) without a GPU."""
import os
import subprocess
import sys

import jax
import pytest

from jrc.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_compile_cache_honours_env_dir(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in config_updates  # JAX reads the env
    assert list(tmp_path.iterdir()) == []


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache", cache.machine_fingerprint())
    assert config_updates["jax_compilation_cache_dir"] == path


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert '"value"' not in p.stdout
    assert "needs a GPU" in p.stderr
