"""The benchmark on the CPU: its refusal to measure anything but a GPU,
every cell at a tiny size, and the placement of the compile cache."""

import pathlib

import numpy as np
import pytest

import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_bench_refuses_cpu(capsys):
    assert bench.main([]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("config", [c for c, _, _ in bench.SWEEP])
def test_bench_cell_exact(config):
    """Each cell, built through the engine at a tiny batch (and, for the
    large rings, a smaller n on the same plan kind): the chained device
    step runs and the served path matches its reference exactly."""
    import jax
    cell = bench.build_cell(config, 2, rehearse=True)
    out = jax.block_until_ready(bench.chained(cell.step, 2)(*cell.state))
    assert [np.shape(x) for x in out] == [np.shape(x) for x in cell.state]
    cell.check()


def test_compile_cache_in_checkout(monkeypatch):
    import jax

    from tpu_ntt.utils import jaxcache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = jaxcache.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert jaxcache.enable_compile_cache() == path       # idempotent
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    no other path is configured in code."""
    import jax

    from tpu_ntt.utils import jaxcache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jaxcache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
