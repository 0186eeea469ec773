"""Process set-up: where the compile cache goes, and the harness's rule for
how many pipelined output generations may be in flight."""

import json
import os
import subprocess
import sys

import jax
import pytest

from pem_spgemm.bench import harness
from pem_spgemm.utils import runtime


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(runtime.ENV_CACHE_DIR, str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(runtime.ENV_CACHE_DIR, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert runtime.compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_cpu():
    with pytest.raises(runtime.NoGPUError):
        runtime.require_gpu()


@pytest.mark.parametrize("gen_bytes,limit,want", [
    (1 << 30, 60 << 30, 15),            # 1 GiB generations, 60 GiB limit
    (1 << 20, 60 << 30, harness.MAX_INFLIGHT),    # tiny outputs: capped
    (20 << 30, 60 << 30, 1),            # one generation over the share
    (1 << 30, None, 1),                 # no limit reported: one at a time
])
def test_inflight_generations(gen_bytes, limit, want):
    assert harness.inflight_generations(gen_bytes, limit) == want


def test_cpu_reports_no_bytes_limit():
    # the CPU backend has no allocator statistics, so the pipelined loop
    # syncs every dispatch there; a GPU reports its limit
    assert harness.device_bytes_limit() is None


def test_bench_refuses_cpu_and_prints_no_result():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "bench.py"], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
