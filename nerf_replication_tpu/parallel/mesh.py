"""Device mesh + sharding utilities.

Replacement for the reference's distributed stack
(SURVEY.md §2.3): DistributedDataParallel wrap + NCCL process groups +
DistributedSampler (reference trainer.py:14-21, train.py:115-120,
samplers.py:75-131) become a ``jax.sharding.Mesh`` with a ``data`` axis:
parameters are replicated, ray batches are sharded along the data axis,
and the gradient all-reduce is inserted by XLA (the mean over the
sharded batch), which XLA hands to NCCL on the GPU. The cards of one
host are joined all to all, so the mesh is 1-D.

No explicit barriers are needed (XLA program order); host-side
synchronisation uses process-0 gating (``jax.process_index()``).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(cfg=None, n_devices: int | None = None, axis: str = "data") -> Mesh:
    """Build a 1-D data mesh. ``cfg.mesh.data == -1`` (default) uses all
    local devices; ``n_devices`` overrides (e.g. simulated CPU meshes)."""
    devices = jax.devices()
    if n_devices is None and cfg is not None:
        n = int(cfg.get("mesh", {}).get("data", -1))
        n_devices = len(devices) if n <= 0 else n
    n_devices = n_devices or len(devices)
    return Mesh(np.array(devices[:n_devices]), (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Place a host batch with its leading axis split over the data axis."""
    sh = data_sharded(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), batch)


def shard_host_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """Mesh-place a host-loader batch, picking per-leaf the first axis
    divisible by the mesh size (reference loaders yield (B=1, N_rays, ...)
    tensors — the ray axis is the data-parallel axis there); leaves with
    no divisible axis are replicated. Keeps the host-loader training path
    data-parallel instead of silently single-device."""
    n_dev = len(mesh.devices.ravel())

    def place(x):
        x = np.asarray(x) if not hasattr(x, "ndim") else x
        if getattr(x, "dtype", np.dtype(object)).kind in "OUS":
            return x  # strings/objects (meta) stay on host
        spec = P()
        for d in range(getattr(x, "ndim", 0)):
            if x.shape[d] % n_dev == 0 and x.shape[d] > 0:
                spec = P(*([None] * d + [axis]))
                break
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, batch)


def replicate_tree(tree, mesh: Mesh):
    sh = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def make_dp_train_step(train_step_fn, mesh: Mesh):
    """Shard a ``(state, batch, key) -> (state, stats)`` step over the data
    axis: state replicated (+donated), batch sharded on its leading dim.
    XLA turns the global loss mean into an all-reduce."""
    rep = replicated(mesh)
    dat = data_sharded(mesh)
    return jax.jit(
        train_step_fn,
        in_shardings=(rep, dat, rep),
        out_shardings=(rep, rep),
        donate_argnums=0,
    )


def make_dp_epoch_runner(trainer, pipeline, mesh: Mesh, n_steps: int):
    """Compile one full data-parallel epoch: lax.scan over n_steps of
    (on-device batch sample -> sharded render/grad -> update). The sampled
    ray batch is sharding-constrained onto the data axis so per-device
    compute stays local until the gradient reduction."""
    dat = data_sharded(mesh)
    rep = replicated(mesh)

    import jax.numpy as jnp

    def one_step(data, state, step_key):
        k_data, k_render = jax.random.split(step_key)
        batch = pipeline.sample(k_data, state["step"], data=data)
        batch = jax.lax.with_sharding_constraint(
            batch, jax.tree.map(lambda _: dat, batch))
        return trainer._train_step_inner(state, batch, k_render)

    def run_epoch(state, key, start, data):
        # global-step-indexed keys: the trajectory is invariant to the
        # sub-scan chunking (see Trainer.SCAN_CHUNK); the image stack
        # rides as an argument, not an HLO constant
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(n_steps) + start)
        return jax.lax.scan(partial(one_step, data), state, keys)

    return jax.jit(run_epoch, in_shardings=(rep, rep, rep, rep),
                   out_shardings=(rep, rep), donate_argnums=0)


def make_dp_eval_render(render_chunk_fn, mesh: Mesh):
    """Shard full-image eval rays over devices: rays in P('data'),
    params replicated, outputs gathered (reference north star: the
    pmapped chunked renderer sharded over rays)."""
    rep = replicated(mesh)
    dat = data_sharded(mesh)
    return jax.jit(render_chunk_fn, in_shardings=(rep, dat, dat),
                   out_shardings=dat)
