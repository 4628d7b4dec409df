"""Run-time plumbing: compile-cache placement, the GPU-only entry points'
device check, and loud failures for launches that cannot be honoured."""

import os

import jax
import pytest

from sp_coupler.config import SPConfig
from sp_coupler.parallel import mesh as pmesh
from sp_coupler.runtime import compile_cache, device
from sp_coupler.runtime.driver import SPRunner


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


@pytest.mark.parametrize("script", ["chip_smoke", "bench"])
def test_measuring_entry_points_refuse_cpu(script, capsys):
    """No accelerator: non-zero exit and no result line."""
    mod = __import__(script)
    rc = mod.main([]) if script == "chip_smoke" else mod.main()
    assert rc != 0
    assert '"ok"' not in capsys.readouterr().out


def test_init_distributed_raises_on_failed_initialize(monkeypatch):
    monkeypatch.setenv("SPTPU_DIST_COORD", "localhost:1")
    monkeypatch.setenv("SPTPU_DIST_NPROCS", "2")
    monkeypatch.setenv("SPTPU_DIST_PROC_ID", "1")

    def fail(*a, **k):
        raise ConnectionError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", fail)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        pmesh.init_distributed()


def test_no_distributed_launch_is_a_noop(monkeypatch):
    monkeypatch.delenv("SPTPU_DIST_COORD", raising=False)
    assert pmesh.init_distributed() is False


def test_mesh_larger_than_devices_raises(tmp_path):
    cfg = SPConfig(gcm_type="dummy", les_type="dummy",
                   mesh_les=2 * len(jax.devices()),
                   output_dir=str(tmp_path / "out"))
    with pytest.raises(ValueError, match="devices"):
        SPRunner(cfg)._build_mesh()
