"""Tracing / profiling helpers.

Capability parity with the reference's manual timers
(src/utils/base_utils.py:11-59 ``perf_timer`` — a CUDA-synchronized
context timer — plus the renderer's fine-pass wall-time prints and
run.py's per-view fps): :class:`perf_timer` blocks on device work via
``jax.block_until_ready``; :func:`trace` wraps ``jax.profiler`` for device
traces (viewable in TensorBoard/XProf); :func:`device_memory_stats`
replaces ``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import contextlib
import time


class perf_timer:
    """Device-synchronized context timer.

    >>> with perf_timer("fine pass", sync=result):
    ...     result = fn(x)
    Accumulates across uses when reused; prints on exit unless quiet.
    """

    def __init__(self, name: str = "", quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        import jax

        # flush pending work so we time only the body
        jax.effects_barrier()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import jax

        jax.effects_barrier()
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        if not self.quiet:
            print(f"[perf_timer] {self.name}: {dt:.6f}s "
                  f"(avg {self.total / self.count:.6f}s over {self.count})")
        return False

    def sync(self, value):
        """Block on a device value inside the timed region."""
        import jax

        jax.block_until_ready(value)
        return value


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax_trace"):
    """jax.profiler trace context (device timeline -> TensorBoard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_memory_stats() -> dict:
    import jax

    try:
        stats = jax.local_devices()[0].memory_stats() or {}
    except Exception:
        stats = {}
    return {
        "bytes_in_use": stats.get("bytes_in_use", 0),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
        "bytes_limit": stats.get("bytes_limit", 0),
    }
