"""End-to-end training smoke tests (SURVEY.md §4: img_fit convergence
smoke + checkpoint round-trips), CPU-runnable."""

import os

import jax
import numpy as np
import pytest

from nerf_replication_tpu.config import default_cfg, load_cfg_tree, parse_cfg, parse_args
from nerf_replication_tpu.utils.synthetic_scene import generate_scene


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    generate_scene(str(root), scene="probe", H=32, W=32,
                   n_train=4, n_val=1, n_test=1)
    return str(root)


def _img_fit_cfg(scene_root, tmp_path):
    cfg = load_cfg_tree("configs/img_fit/lego_view0.yaml", default_cfg())
    cfg.scene = "probe"
    cfg.task = "img_fit"
    cfg.train_dataset.data_root = scene_root
    cfg.test_dataset.data_root = scene_root
    cfg.test_dataset.input_ratio = 1.0
    cfg.task_arg.N_pixels = 512
    cfg.train.epoch = 2
    cfg.ep_iter = 60
    cfg.eval_ep = 2
    cfg.save_latest_ep = 1
    cfg.save_ep = 1
    cfg.log_interval = 50
    cfg.trained_model_dir = str(tmp_path / "model")
    cfg.trained_config_dir = str(tmp_path / "config")
    cfg.record_dir = str(tmp_path / "record")
    cfg.result_dir = str(tmp_path / "result")
    return cfg


def test_img_fit_end_to_end_converges(scene_root, tmp_path):
    """The reference's CPU-runnable smoke task: fit one 32x32 image; PSNR
    must improve well above the ~7-8 dB of an untrained net."""
    import train as train_cli

    cfg = _img_fit_cfg(scene_root, tmp_path)
    from nerf_replication_tpu.models import make_network

    network = make_network(cfg)
    state = train_cli.train(cfg, network)

    # checkpoints written with retention
    files = os.listdir(cfg.trained_model_dir)
    assert "latest.ckpt" in files

    # eval PSNR after 120 steps should be solidly above "predicts mean"
    from nerf_replication_tpu.datasets import make_data_loader
    from nerf_replication_tpu.evaluators import make_evaluator
    from nerf_replication_tpu.train import make_trainer

    trainer = make_trainer(cfg, network)
    loader = make_data_loader(cfg, is_train=False)
    stats = trainer.val(-1, loader, state, make_evaluator(cfg))
    assert stats["psnr"] > 14.0, stats


def test_checkpoint_roundtrip(tmp_path):
    from nerf_replication_tpu.utils.ckpt_utils import (
        load_model, load_network, save_model)

    params = {"params": {"dense": {"kernel": np.ones((4, 4), np.float32)}}}
    opt = {"mu": np.zeros(3, np.float32)}
    d = str(tmp_path / "m")
    for epoch in range(8):
        save_model(params, opt, {"step": epoch * 10}, {"epoch": epoch},
                   epoch, d)
    files = sorted(os.listdir(d))
    numbered = [f for f in files if f[0].isdigit()]
    assert len(numbered) == 5  # retention keeps 5 (reference keeps <=5)
    save_model(params, opt, {"step": 99}, {"epoch": 7}, 7, d, latest=True)

    payload = load_model(d, resume=True)
    assert payload["epoch"] == 7
    np.testing.assert_array_equal(
        payload["net"]["params"]["dense"]["kernel"], np.ones((4, 4)))

    net = load_network(d, resume=True)
    assert "params" in net

    # resume=False wipes
    assert load_model(d, resume=False) is None
    assert not os.path.exists(d)


def test_lr_schedules():
    from nerf_replication_tpu.train.scheduler import make_lr_schedule

    cfg = default_cfg()
    cfg.ep_iter = 100
    cfg.train.lr = 1.0
    cfg.train.scheduler = {"type": "exponential", "gamma": 0.1,
                           "decay_epochs": 10}
    s = make_lr_schedule(cfg)
    np.testing.assert_allclose(float(s(0)), 1.0)
    np.testing.assert_allclose(float(s(10 * 100)), 0.1, rtol=1e-6)
    # epoch-granular like the reference (no decay within an epoch)
    np.testing.assert_allclose(float(s(50)), 1.0)

    cfg.train.scheduler = {"type": "multi_step", "milestones": [2, 4],
                           "gamma": 0.5}
    m = make_lr_schedule(cfg)
    assert float(m(0)) == 1.0
    assert float(m(250)) == 0.5      # epoch 2
    assert float(m(450)) == 0.25     # epoch 4

    cfg.train.scheduler = {"type": "warmup_multi_step", "milestones": [8],
                           "gamma": 0.5, "warmup_epochs": 4,
                           "warmup_factor": 0.25}
    w = make_lr_schedule(cfg)
    assert float(w(0)) == 0.25
    assert float(w(400)) == 1.0      # past warmup
    assert float(w(900)) == 0.5      # past milestone


def test_optimizer_clips_gradients():
    import jax.numpy as jnp
    import optax

    from nerf_replication_tpu.train.optimizer import make_optimizer

    cfg = default_cfg()
    cfg.ep_iter = 1
    cfg.train.optim = "sgd"
    cfg.train.lr = 1.0
    cfg.train.clip_grad_value = 40.0
    cfg.train.scheduler = {"type": "multi_step", "milestones": [10**9],
                           "gamma": 1.0}
    opt = make_optimizer(cfg)
    params = {"w": jnp.zeros(3)}
    state = opt.init(params)
    huge = {"w": jnp.array([1e6, -1e6, 1.0])}
    updates, _ = opt.update(huge, state, params)
    # sgd lr=1: update = -clip(grad, 40)
    np.testing.assert_allclose(np.asarray(updates["w"]), [-40.0, 40.0, -1.0])


def test_recorder_smoothing_and_state(tmp_path):
    from nerf_replication_tpu.train.recorder import Recorder, SmoothedValue

    sv = SmoothedValue(window_size=3)
    for v in [1.0, 2.0, 3.0, 4.0]:
        sv.update(v)
    assert sv.median == 3.0
    assert sv.avg == 3.0
    assert sv.global_avg == 2.5

    cfg = default_cfg()
    cfg.record_dir = str(tmp_path / "rec")
    r = Recorder(cfg, process_index=0)
    r.update_loss_stats({"loss": 0.5})
    r.step = 7
    r.record("train")
    state = r.state_dict()
    r2 = Recorder(cfg, process_index=0)
    r2.load_state_dict(state)
    assert r2.step == 7
    # non-zero process: no writer, updates are no-ops
    r3 = Recorder(cfg, process_index=1)
    assert r3.writer is None
    r3.update_loss_stats({"loss": 1.0})
    assert r3.loss_stats == {}


def test_train_resume_after_interrupt(scene_root, tmp_path):
    """Failure recovery (SURVEY.md §5): kill after epoch 1, rerun, and the
    run resumes from latest.ckpt instead of restarting."""
    import train as train_cli

    from nerf_replication_tpu.models import make_network

    cfg = _img_fit_cfg(scene_root, tmp_path)
    cfg.ep_iter = 10
    cfg.train.epoch = 1
    cfg.eval_ep = 100  # skip eval
    network = make_network(cfg)
    train_cli.train(cfg, network)  # epoch 0 only, saves latest

    cfg2 = _img_fit_cfg(scene_root, tmp_path)
    cfg2.ep_iter = 10
    cfg2.train.epoch = 2
    cfg2.eval_ep = 100
    state = train_cli.train(cfg2, make_network(cfg2))
    # resumed: total steps = 2 epochs x 10 iters
    assert int(state["step"]) == 20


def test_pretrain_roundtrip(tmp_path):
    """Warm-start capability (reference net_utils.py:429-457):
    save_pretrain/load_pretrain + train.py wiring via cfg.pretrain."""
    from nerf_replication_tpu.utils.ckpt_utils import (
        load_pretrain, save_pretrain)

    params = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    d = str(tmp_path / "pre")
    save_pretrain(params, "nerf-task", model_dir=d)
    loaded = load_pretrain(d)
    np.testing.assert_array_equal(loaded["params"]["w"],
                                  params["params"]["w"])
    assert load_pretrain(str(tmp_path / "missing")) is None


def test_checkpoint_corruption_fallback(tmp_path):
    """A torn/corrupt latest.ckpt falls back to the newest readable
    numbered checkpoint; future-versioned files are rejected the same
    way."""
    from nerf_replication_tpu.utils.ckpt_utils import (
        CKPT_VERSION, load_model, load_network, save_model)

    params = {"params": {"w": np.float32(1.0)}}
    d = str(tmp_path / "m")
    for epoch in (3, 4):
        save_model({"params": {"w": np.float32(epoch)}}, {}, {}, {},
                   epoch, d)
    save_model(params, {}, {}, {}, 5, d, latest=True)

    payload = load_model(d, resume=True)
    assert payload["version"] == CKPT_VERSION and payload["epoch"] == 5

    # corrupt latest -> newest numbered (4) wins
    with open(os.path.join(d, "latest.ckpt"), "wb") as f:
        f.write(b"not a pickle")
    payload = load_model(d, resume=True)
    assert payload["epoch"] == 4
    net = load_network(d, resume=True)
    assert float(net["params"]["w"]) == 4.0

    # corrupt 4.ckpt too -> 3 wins
    with open(os.path.join(d, "4.ckpt"), "wb") as f:
        f.write(b"\x00" * 10)
    assert load_model(d, resume=True)["epoch"] == 3

    # a future-version checkpoint is treated as unreadable
    import pickle
    with open(os.path.join(d, "latest.ckpt"), "wb") as f:
        pickle.dump({"version": CKPT_VERSION + 1, "net": {}, "epoch": 9}, f)
    assert load_model(d, resume=True)["epoch"] == 3

    # everything corrupt -> None / strict raises
    for name in ("3.ckpt", "latest.ckpt"):
        with open(os.path.join(d, name), "wb") as f:
            f.write(b"x")
    assert load_model(d, resume=True) is None
    try:
        load_network(d, resume=True, strict=True)
        raise AssertionError("expected FileNotFoundError")
    except FileNotFoundError:
        pass


def _tiny_nerf_cfg():
    cfg = default_cfg()
    cfg.task_arg.update({"N_rays": 16, "N_samples": 4, "N_importance": 4,
                         "white_bkgd": True})
    cfg.network.nerf = {"D": 2, "W": 16, "V_D": 1, "skips": [1]}
    cfg.network.xyz_encoder = {"type": "frequency", "input_dim": 3, "freq": 2}
    cfg.network.dir_encoder = {"type": "frequency", "input_dim": 3, "freq": 1}
    cfg.network.dtype = "float32"
    return cfg


def test_train_device_partial_final_chunk():
    """ep_iter not a multiple of SCAN_CHUNK must run EXACTLY ep_iter
    steps (over-stepping silently shifts the lr schedule)."""
    import jax

    from nerf_replication_tpu.datasets.pipeline import DeviceRayPipeline
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.train import make_trainer
    from nerf_replication_tpu.train.recorder import Recorder

    cfg = _tiny_nerf_cfg()
    cfg.ep_iter = 7
    net = make_network(cfg)
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 2, 3] = 4.0
    K = np.array([[8.0, 0, 4], [0, 8, 4], [0, 0, 1]], np.float32)
    pipe = DeviceRayPipeline(images, poses, K, n_rays=16)

    trainer = make_trainer(cfg, net)
    trainer.SCAN_CHUNK = 5  # 7 steps = one 5-chunk + one 2-chunk
    from nerf_replication_tpu.models.nerf.network import init_params
    state = trainer.init_state(init_params(net, jax.random.key(0)))
    rec = Recorder(cfg, process_index=1)
    state = trainer.train_device(0, pipe, state, rec)
    assert int(state["step"]) == 7, int(state["step"])


def test_scan_chunking_is_numerically_invariant():
    """train_device must produce the SAME trajectory whatever the
    sub-scan chunk size: per-step PRNG keys derive from the global step
    index."""
    import jax

    from nerf_replication_tpu.datasets.pipeline import DeviceRayPipeline
    from nerf_replication_tpu.models import make_network
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.train import make_trainer
    from nerf_replication_tpu.train.recorder import Recorder

    cfg = _tiny_nerf_cfg()
    cfg.ep_iter = 10
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 2, 3] = 4.0
    K = np.array([[8.0, 0, 4], [0, 8, 4], [0, 0, 1]], np.float32)

    def run(chunk):
        cfg2 = _tiny_nerf_cfg()
        cfg2.ep_iter = 10
        cfg2.scan_chunk = chunk
        net = make_network(cfg2)
        pipe = DeviceRayPipeline(images, poses, K, n_rays=16)
        trainer = make_trainer(cfg2, net)
        state = trainer.init_state(init_params(net, jax.random.key(0)))
        rec = Recorder(cfg2, process_index=1)
        state = trainer.train_device(0, pipe, state, rec)
        return jax.tree.map(np.asarray, state["params"])

    p3 = run(3)     # 3+3+3+1 sub-scans
    p10 = run(10)   # one scan
    for a, b in zip(jax.tree.leaves(p3), jax.tree.leaves(p10)):
        np.testing.assert_array_equal(a, b)
