#!/usr/bin/env python
"""Training / test-mode CLI.

Capability parity with reference train.py: ``python train.py --cfg_file
configs/nerf/lego.yaml`` trains with resume/pretrain, per-epoch
save/save-latest/eval cadence (train.py:58-85), ``--test`` runs the
validation path (train.py:90-97). ``cfg.distributed`` maps to
``jax.distributed.initialize`` + process-0 gating instead of NCCL
process groups (train.py:115-120); there are no loader worker processes,
so no ``kill -9`` exit hack (train.py:130).

Device-resident training path: when the dataset exposes ``as_arrays`` the
epoch runs as one compiled lax.scan over device-resident data
(trainers/trainer.py train_device); otherwise the host-loader parity
loop is used.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def train(cfg, network):
    import jax

    from nerf_replication_tpu.datasets import make_data_loader
    from nerf_replication_tpu.datasets.make_dataset import make_dataset
    from nerf_replication_tpu.datasets.pipeline import make_train_pipeline
    from nerf_replication_tpu.evaluators import make_evaluator
    from nerf_replication_tpu.models.nerf.network import init_params
    from nerf_replication_tpu.train import make_recorder, make_trainer
    from nerf_replication_tpu.utils.ckpt_utils import (
        check_params_compat,
        load_model,
        load_pretrain,
        save_model,
        save_trained_config,
    )

    if jax.process_index() == 0:
        save_trained_config(cfg)

    train_dataset = make_dataset(cfg, is_train=True)
    val_loader = make_data_loader(cfg, is_train=False)

    mesh = None
    if len(jax.devices()) > 1:
        from nerf_replication_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(cfg)
        print(f"data-parallel mesh: {mesh.devices.ravel().size} devices")
    trainer = make_trainer(cfg, network, mesh=mesh)
    recorder = make_recorder(cfg)
    evaluator = make_evaluator(cfg)

    # init / resume
    key = jax.random.key(int(cfg.get("seed", 0)))
    if hasattr(network, "apply"):
        try:
            params = init_params(network, key)
        except Exception:
            # non-NeRF networks (e.g. img_fit) init from a sample batch
            sample = train_dataset[0]
            params = network.init(key, {k: v for k, v in sample.items()})
    state = trainer.init_state(params)

    begin_epoch = 0
    payload = load_model(cfg.trained_model_dir, resume=cfg.resume)
    if payload is not None:
        check_params_compat(payload["net"], params)
        state = {"params": payload["net"], "opt_state": payload["optim"],
                 "step": payload["scheduler"].get("step", 0)}
        recorder.load_state_dict(payload["recorder"])
        begin_epoch = payload["epoch"] + 1
    elif cfg.pretrain != "":
        pre = load_pretrain(cfg.pretrain)
        if pre is not None:
            check_params_compat(pre, params)
            state["params"] = pre

    # device-resident fast path when the dataset can live on device
    pipeline = None
    if hasattr(train_dataset, "as_arrays") and cfg.task != "img_fit":
        pipeline = make_train_pipeline(cfg, train_dataset)

    host_loader = None
    for epoch in range(begin_epoch, cfg.train.epoch):
        recorder.epoch = epoch
        if pipeline is not None:
            state = trainer.train_device(epoch, pipeline, state, recorder)
        else:
            if host_loader is None:
                host_loader = make_data_loader(
                    cfg, is_train=True, is_distributed=cfg.distributed,
                    max_iter=cfg.ep_iter,
                    num_replicas=jax.process_count(),
                    rank=jax.process_index())
            state = trainer.train(epoch, host_loader, state, recorder)

        is_p0 = jax.process_index() == 0
        sched_state = {"step": int(state["step"])}
        if (epoch + 1) % cfg.save_ep == 0 and is_p0:
            save_model(state["params"], state["opt_state"], sched_state,
                       recorder.state_dict(), epoch, cfg.trained_model_dir)
        if (epoch + 1) % cfg.save_latest_ep == 0 and is_p0:
            save_model(state["params"], state["opt_state"], sched_state,
                       recorder.state_dict(), epoch, cfg.trained_model_dir,
                       latest=True)
        if (epoch + 1) % cfg.eval_ep == 0 and is_p0 and evaluator is not None:
            trainer.val(epoch, val_loader, state, evaluator, recorder)

    return state


def test(cfg, network):
    from nerf_replication_tpu.datasets import make_data_loader
    from nerf_replication_tpu.evaluators import make_evaluator
    from nerf_replication_tpu.train import make_trainer
    from nerf_replication_tpu.utils.ckpt_utils import load_network

    trainer = make_trainer(cfg, network)
    val_loader = make_data_loader(cfg, is_train=False)
    evaluator = make_evaluator(cfg)
    params = load_network(cfg.trained_model_dir, resume=cfg.resume,
                          epoch=cfg.test.epoch)
    return trainer.val(-1, val_loader, params, evaluator)


def main():
    from nerf_replication_tpu.config import init_global_cfg

    cfg, args = init_global_cfg()

    import jax

    from nerf_replication_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if cfg.distributed:
        jax.distributed.initialize()
    if cfg.get("detect_anomaly", False):
        jax.config.update("jax_debug_nans", True)

    from nerf_replication_tpu.models import make_network

    network = make_network(cfg)
    if args.test:
        test(cfg, network)
    else:
        train(cfg, network)


if __name__ == "__main__":
    main()
