"""Every entry module and every package module imports with flax, yaml
and PIL unavailable: the card's machine has none of them."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("flax", "yaml", "PIL")


def _modules():
    mods = ["train", "run", "bench", "chip_smoke", "__graft_entry__"]
    pkg = os.path.join(ROOT, "nerf_replication_tpu")
    for d, _, files in sorted(os.walk(pkg)):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), ROOT)[:-3]
                name = rel.replace(os.sep, ".")
                mods.append(name[:-len(".__init__")]
                            if name.endswith(".__init__") else name)
    return mods


MODULES = _modules()

_PROBE = """
import importlib, json, sys
BLOCKED = set(sys.argv[1].split(","))

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Blocker())
sys.path.insert(0, sys.argv[2])
result = {}
for m in sys.argv[3:]:
    try:
        importlib.import_module(m)
        result[m] = "ok"
    except Exception as e:
        result[m] = f"{type(e).__name__}: {e}"
print(json.dumps(result))
"""


@pytest.fixture(scope="module")
def import_results():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, ",".join(BLOCKED), ROOT, *MODULES],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_flax_yaml_pil(module, import_results):
    assert import_results[module] == "ok"


@pytest.mark.parametrize("before,after", [
    ("", "--xla_gpu_enable_triton_gemm=false"),
    ("--xla_force_host_platform_device_count=2",
     "--xla_force_host_platform_device_count=2 "
     "--xla_gpu_enable_triton_gemm=false"),
    ("--xla_gpu_enable_triton_gemm=true",
     "--xla_gpu_enable_triton_gemm=true"),
])
def test_import_turns_off_triton_gemm_unless_set(before, after):
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=before)
    out = subprocess.run(
        [sys.executable, "-c",
         "import os, nerf_replication_tpu; print(os.environ['XLA_FLAGS'])"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == after
