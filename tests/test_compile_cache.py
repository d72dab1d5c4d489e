"""Compile-cache placement and the smoke script's refusal to run
without a GPU."""

import json
import os
import subprocess
import sys

import jax

from nerf_replication_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_config(monkeypatch):
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    return updates


def test_env_dir_is_honoured_and_nothing_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    updates = _record_config(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert updates == {}


def test_default_dir_is_the_checkout_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    updates = _record_config(monkeypatch)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == path


def test_cpu_compiles_are_not_cached(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = _record_config(monkeypatch)
    assert compile_cache.enable_compile_cache() is None
    assert updates == {}


def test_chip_smoke_main_refuses_cpu(capsys):
    import chip_smoke

    assert chip_smoke.main([]) == 1
    assert capsys.readouterr().out == ""


def test_chip_smoke_script_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok")), line
