"""Entry-point device checks and the persistent compilation cache."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from cusift_tpu.utils import device

REPO = Path(__file__).resolve().parents[1]
_CACHE_OPTS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def restore_cache_config():
    old = {k: getattr(jax.config, k) for k in _CACHE_OPTS}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_compile_cache_default_path(monkeypatch, restore_cache_config):
    """Without JAX_COMPILATION_CACHE_DIR the cache sits at one fixed path
    inside the checkout, with the minimum size and time settings."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == 0
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.5
    assert device.enable_compile_cache() == path     # stable across calls


def test_compile_cache_env_var_wins(monkeypatch, restore_cache_config,
                                    tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_require_gpu_refuses_cpu():
    info = device.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": 8}
    with pytest.raises(SystemExit, match="needs a GPU"):
        device.require_gpu("test")


def _run_cpu(args, cwd=REPO):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_refuse_cpu(script):
    """Measurement entry points exit non-zero on the CPU, before any phase,
    and print no result line."""
    r = _run_cpu([str(REPO / script)])
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repo exits non-zero."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
