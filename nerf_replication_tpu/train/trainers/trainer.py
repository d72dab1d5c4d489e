"""Trainer.

Capability parity with reference src/train/trainers/trainer.py:10-128:
per-iter forward/backward/clip/step with loss-stat smoothing, batch/data
timing, ETA, lr and device-memory logging every ``log_interval``
(:47-94), and a no-grad ``val`` loop driving the evaluator (:96-128).

Redesign:
* the whole update (loss, grad, optax step, metrics) is ONE jitted
  function with donated state — no Python-side ``zero_grad/backward``.
* two data paths: the parity host-loader loop (``train``), and the
  device-resident fast path (``train_device``) that runs ``ep_iter``
  steps as a single ``lax.scan`` per epoch — zero host involvement.
* DDP/SyncBatchNorm wrapping (reference trainer.py:14-21) is replaced by
  sharded jit over the data mesh axis (see parallel/), with gradient
  psum implicit in the sharded program.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ...registry import resolve
from ..optimizer import make_optimizer
from ..scheduler import make_lr_schedule


def host_batch_to_device(batch):
    """Recursive numpy->device transfer; the reference's ``to_cuda``
    (src/utils/data_utils.py:557-575) equivalent. ``meta`` stays on host."""
    if isinstance(batch, dict):
        return {k: (v if k == "meta" else host_batch_to_device(v))
                for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(host_batch_to_device(v) for v in batch)
    return jnp.asarray(batch)


def _device_mem_mb() -> float:
    try:
        stats = jax.local_devices()[0].memory_stats()
        if stats and "bytes_in_use" in stats:
            return stats["bytes_in_use"] / 2**20
        if stats and "peak_bytes_in_use" in stats:
            return stats["peak_bytes_in_use"] / 2**20
    except Exception:
        pass
    return 0.0


class Trainer:
    def __init__(self, wrapper, cfg, mesh=None):
        self.wrapper = wrapper
        self.cfg = cfg
        self.mesh = mesh
        self.lr_schedule = make_lr_schedule(cfg)
        self.optimizer = make_optimizer(cfg, lr_schedule=self.lr_schedule)
        self.log_interval = int(cfg.get("log_interval", 20))
        self.ep_iter = int(cfg.get("ep_iter", -1))
        self.max_epoch = int(cfg.train.epoch)
        self.process_index = jax.process_index()
        # sub-scan length for train_device (cfg knob `scan_chunk`); see
        # the SCAN_CHUNK comment below for why epochs are chunked
        self.SCAN_CHUNK = int(cfg.get("scan_chunk", type(self).SCAN_CHUNK))

        def train_step(state, batch, key):
            grad_fn = jax.value_and_grad(
                lambda p: wrapper.loss_fn(p, batch, key, train=True),
                has_aux=True)
            (loss, (_, loss_stats, _)), grads = grad_fn(state["params"])
            updates, opt_state = self.optimizer.update(
                grads, state["opt_state"], state["params"])
            params = jax.tree.map(lambda p, u: p + u, state["params"], updates)
            new_state = {"params": params, "opt_state": opt_state,
                         "step": state["step"] + 1}
            return new_state, loss_stats

        self._train_step = jax.jit(train_step, donate_argnums=0)
        self._scan_cache = {}

    # -- state ----------------------------------------------------------------
    def init_state(self, params):
        return {
            "params": params,
            "opt_state": self.optimizer.init(params),
            "step": jnp.zeros((), jnp.int32),
        }

    # -- parity path: host data loader -----------------------------------------
    def train(self, epoch, data_loader, state, recorder, key=None):
        """One epoch over a host loader (reference trainer.py:43-94)."""
        if key is None:
            key = jax.random.key(int(self.cfg.get("seed", 0)) + epoch)
        recorder.epoch = epoch
        max_iter = len(data_loader)
        dp = self.mesh is not None and len(self.mesh.devices.ravel()) > 1
        if dp:
            from ...parallel.mesh import replicate_tree, shard_host_batch

            state = replicate_tree(state, self.mesh)
        end = time.time()
        for iteration, batch in enumerate(data_loader):
            data_time = time.time() - end
            if dp:
                batch = shard_host_batch(batch, self.mesh)
            else:
                batch = host_batch_to_device(batch)
            key, sub = jax.random.split(key)
            state, loss_stats = self._train_step(state, batch, sub)
            if (self.process_index == 0 and
                    (iteration + 1) % self.log_interval == 0):
                jax.block_until_ready(state["params"])
            batch_time = time.time() - end
            end = time.time()

            if self.process_index != 0:
                continue
            recorder.step += 1
            recorder.update_loss_stats(loss_stats)
            recorder.batch_time.update(batch_time)
            recorder.data_time.update(data_time)
            if (iteration + 1) % self.log_interval == 0 or \
                    iteration == max_iter - 1:
                eta_sec = recorder.batch_time.global_avg * (
                    (self.max_epoch - epoch) * max_iter - iteration)
                lr = float(self.lr_schedule(int(state["step"]) - 1))
                print(f"eta: {int(eta_sec)}s  {recorder}  lr: {lr:.6f}  "
                      f"mem: {_device_mem_mb():.0f}MB")
                recorder.record("train")
        return state

    # -- fast path: device-resident pipeline -----------------------------------
    # steps per compiled sub-scan: chunking epochs into sub-scans costs one
    # dispatch per 50 steps and keeps the compiled program small.
    SCAN_CHUNK = 50

    def train_device(self, epoch, pipeline, state, recorder, key=None):
        """One epoch = ep_iter fused sample->render->grad->update steps,
        dispatched as compiled lax.scan chunks."""
        n_steps = self.ep_iter if self.ep_iter > 0 else 500
        if key is None:
            key = jax.random.key(int(self.cfg.get("seed", 0)))
        key = jax.random.fold_in(key, epoch)

        def get_scan_fn(chunk):
            scan_fn = self._scan_cache.get((id(pipeline), chunk))
            if scan_fn is None:
                if self.mesh is not None and len(self.mesh.devices.ravel()) > 1:
                    # data-parallel: params replicated, per-step ray batch
                    # sharding-constrained over the data axis (XLA inserts
                    # the gradient all-reduce between devices)
                    from ...parallel.mesh import make_dp_epoch_runner

                    scan_fn = make_dp_epoch_runner(self, pipeline, self.mesh,
                                                   chunk)
                else:
                    def one_step(data, state, step_key):
                        k_data, k_render = jax.random.split(step_key)
                        batch = pipeline.sample(k_data, state["step"],
                                                data=data)
                        return self._train_step_inner(state, batch, k_render)

                    def run_chunk(state, key, start, data):
                        # per-step keys derive from the GLOBAL step index
                        # so the trajectory is invariant to how the epoch
                        # is chunked into sub-scans; the image stack rides
                        # as an ARGUMENT (a closure would embed it as a
                        # giant HLO constant, see DeviceRayPipeline.data)
                        keys = jax.vmap(
                            lambda i: jax.random.fold_in(key, i))(
                                jnp.arange(chunk) + start)
                        return jax.lax.scan(
                            partial(one_step, data), state, keys)

                    scan_fn = jax.jit(run_chunk)
                self._scan_cache[(id(pipeline), chunk)] = scan_fn
            return scan_fn

        data = pipeline.data()
        t0 = time.time()
        stats = None
        done = 0
        while done < n_steps:
            # final partial chunk runs EXACTLY the remaining steps (a short
            # tail must not silently over-step the optimizer/lr schedule)
            chunk = min(self.SCAN_CHUNK, n_steps - done)
            state, stats = get_scan_fn(chunk)(state, key, done, data)
            done += chunk
        # host fetch of the step stats is the completion fence
        stats = {k: np.asarray(v) for k, v in stats.items()}
        wall = time.time() - t0

        if self.process_index == 0:
            recorder.epoch = epoch
            recorder.step += n_steps
            last = {k: float(np.asarray(v)[-1]) for k, v in stats.items()}
            mean = {k: float(np.asarray(v).mean()) for k, v in stats.items()}
            recorder.update_loss_stats(last)
            recorder.batch_time.update(wall / n_steps)
            rays_per_sec = (
                n_steps * int(self.cfg.task_arg.get("N_rays", 1024)) / wall)
            lr = float(self.lr_schedule(int(state["step"]) - 1))
            print(f"epoch {epoch}: {n_steps} steps in {wall:.2f}s "
                  f"({rays_per_sec:,.0f} rays/s)  loss: {mean['loss']:.5f}  "
                  f"psnr: {last['psnr']:.2f}  lr: {lr:.6f}  "
                  f"mem: {_device_mem_mb():.0f}MB")
            recorder.record("train")
        return state

    def _train_step_inner(self, state, batch, key):
        """Un-jitted step body (for composition inside scans)."""
        grad_fn = jax.value_and_grad(
            lambda p: self.wrapper.loss_fn(p, batch, key, train=True),
            has_aux=True)
        (loss, (_, loss_stats, _)), grads = grad_fn(state["params"])
        updates, opt_state = self.optimizer.update(
            grads, state["opt_state"], state["params"])
        params = jax.tree.map(lambda p, u: p + u, state["params"], updates)
        return ({"params": params, "opt_state": opt_state,
                 "step": state["step"] + 1}, loss_stats)

    # -- validation -------------------------------------------------------------
    def val(self, epoch, data_loader, state_or_params, evaluator=None,
            recorder=None):
        # unwrap a TrainState dict; note a bare flax params tree also has a
        # top-level "params" key, so key on opt_state
        params = (state_or_params["params"]
                  if isinstance(state_or_params, dict) and
                  "opt_state" in state_or_params else state_or_params)
        val_stats = {}
        n = 0
        for batch in data_loader:
            b = host_batch_to_device(batch)
            # full images must go through the CHUNKED eval render (a direct
            # wrapper loss call would trace an unchunked 160k-ray render)
            if hasattr(self.wrapper, "render_eval"):
                eval_out = self.wrapper.render_eval(params, b)
                rgb_pred = (eval_out["rgb"] if isinstance(eval_out, dict)
                            else eval_out[0])
                gt = b.get("colors", b.get("rgb"))
                mse = float(np.mean(
                    (np.asarray(rgb_pred).reshape(-1, 3) -
                     np.asarray(gt).reshape(-1, 3)) ** 2))
                loss_stats = {"loss": mse, "color_mse": mse,
                              "psnr": -10.0 * np.log10(max(mse, 1e-10))}
            else:
                eval_out, loss, loss_stats, _ = self.wrapper(
                    params, b, key=None, train=False)
            if evaluator is not None:
                evaluator.evaluate(eval_out, batch)
            for k, v in loss_stats.items():
                val_stats[k] = val_stats.get(k, 0.0) + float(np.asarray(v).mean())
            n += 1
        result = None
        if evaluator is not None:
            result = evaluator.summarize()
        mean_stats = {k: v / max(n, 1) for k, v in val_stats.items()}
        if result:
            mean_stats.update(result)
        print("val:", {k: round(v, 4) for k, v in mean_stats.items()})
        if recorder is not None:
            recorder.record("val", recorder.epoch, loss_stats=mean_stats,
                            image_stats={})
        return mean_stats


def make_trainer(cfg, network, train_loader=None, mesh=None) -> Trainer:
    """Factory (parity: src/train/make_trainer.py:5-14 — wraps the network
    in the config-selected loss module, then the Trainer)."""
    wrapper = resolve("loss", cfg.loss_module)(
        cfg, network=network, train_loader=train_loader)
    return Trainer(wrapper, cfg, mesh=mesh)
