"""Multi-HOST (multi-process) training simulation — the reference's
`cfg.distributed` NCCL path (train.py:115-120) as 2 real CPU processes
with jax.distributed + Gloo collectives: sharded train steps must match
single-process math, and host side effects must be process-0-gated."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def multihost_results(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("mh"))
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    worker = os.path.join(ROOT, "tests", "multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        assert p.returncode == 0, err.decode()[-2000:]
    out = {}
    for pid in range(2):
        with open(os.path.join(outdir, f"rank{pid}.json")) as f:
            out[pid] = json.load(f)
    out["outdir"] = outdir
    return out


def _single_process_reference():
    """Same 2 steps, one process, one device."""
    from nerf_replication_tpu.config import default_cfg
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.train import make_trainer

    cfg = default_cfg()
    cfg.task_arg.update({"N_rays": 32, "N_samples": 8, "N_importance": 8})
    cfg.network.nerf = {"D": 2, "W": 32, "V_D": 1, "skips": [1]}
    cfg.network.xyz_encoder = {"type": "frequency", "input_dim": 3, "freq": 4}
    cfg.network.dir_encoder = {"type": "frequency", "input_dim": 3, "freq": 2}
    cfg.network.dtype = "float32"

    net = make_network(cfg)
    trainer = make_trainer(cfg, net)
    state = trainer.init_state(init_params(net, jax.random.key(0)))
    step_fn = jax.jit(trainer._train_step_inner)

    losses = []
    for step in range(2):
        rng = np.random.default_rng(100 + step)
        ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (32, 1))
        rd = (rng.normal(size=(32, 3)) * 0.1 +
              np.array([0.0, 0.0, -1.0])).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        colors = rng.uniform(size=(32, 3)).astype(np.float32)
        batch = {k: jnp.asarray(v) for k, v in
                 (("rays_o", ro), ("rays_d", rd), ("colors", colors))}
        state, stats = step_fn(state, batch, jax.random.key(7 + step))
        losses.append(float(stats["loss"]))
    pnorm = float(jnp.sqrt(sum(
        jnp.sum(jnp.square(l)) for l in jax.tree.leaves(state["params"]))))
    return losses, pnorm


def test_multihost_matches_single_process(multihost_results):
    ref_losses, ref_pnorm = _single_process_reference()
    for pid in (0, 1):
        r = multihost_results[pid]
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=1e-5)
        np.testing.assert_allclose(r["pnorm"], ref_pnorm, rtol=1e-5)
    # both ranks observed identical (replicated) state
    assert multihost_results[0]["pnorm"] == multihost_results[1]["pnorm"]


def test_multihost_process0_gating(multihost_results):
    assert multihost_results[0]["process_index"] == 0
    assert multihost_results[1]["process_index"] == 1
    # each rank pointed its Recorder at record{pid}: only rank 0's
    # directory may exist (reference recorder.py:51 local_rank gating)
    assert multihost_results[0]["record_dir_exists"]
    assert not multihost_results[1]["record_dir_exists"]
