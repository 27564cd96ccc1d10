"""Per-stage timing and the profiler hook.

Port of ractip_tpu/utils/timing.py (StageTimer :22, profile_trace :66).
The reference's only observability hook is the compile-time SHOW_TIMINGS
flag printing per-phase wall time (reference src/contrafold/Config.hpp:
26-27).  Here:

  * StageTimer -- per-stage wall seconds and entry counts.  ``with
    timer("fold"):`` accumulates the seconds spent in the block; a stage
    opened inside another pauses the outer one, so the stages partition
    the time (the JAX timer nests inclusively: there an outer stage's
    seconds include its inner stages').  Given a device, every boundary
    synchronizes it first, so a stage's seconds include the device work it
    queued; ``timer.sync(x)`` synchronizes the devices of the tensors in x.
  * profile_trace -- a context manager around torch.profiler.profile (CPU
    and CUDA activity, CPU only where no CUDA device is present) that
    writes a Chrome/Perfetto trace of the wrapped region into a directory,
    the counterpart of jax.profiler.trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


def _tensors(x):
    """Every tensor in x (nested tuples, lists and dicts)."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


class StageTimer:
    """Accumulates wall seconds and entries per named stage.

    >>> t = StageTimer("cuda")
    >>> with t("fold"):
    ...     out = t.sync(my_fold(...))   # waits for the device work in out
    >>> t.report(), t.counts
    ({'fold': ...}, {'fold': 1})
    """

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._stack: list[list] = []

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        self._sync()
        now = time.perf_counter()
        if self._stack:
            name, t0 = self._stack[-1]
            self.seconds[name] = self.seconds.get(name, 0.0) + now - t0
        self._stack.append([stage, now])
        self.counts[stage] = self.counts.get(stage, 0) + 1
        try:
            yield self
        finally:
            self._sync()
            now = time.perf_counter()
            name, t0 = self._stack.pop()
            self.seconds[name] = self.seconds.get(name, 0.0) + now - t0
            if self._stack:
                self._stack[-1][1] = now

    @staticmethod
    def sync(x):
        """Wait for the CUDA devices of the tensors in x (nested tuples,
        lists and dicts); a no-op for host values.  Returns x."""
        for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        return x

    def report(self) -> dict[str, float]:
        return dict(self.seconds)

    def json(self) -> str:
        return json.dumps({k: round(v, 6) for k, v in self.seconds.items()})

    def __repr__(self):
        parts = ", ".join(f"{k}={v:.3f}s" for k, v in self.seconds.items())
        return f"StageTimer({parts})"


def stage(timer, name: str):
    """timer(name), or a no-op context without a timer."""
    return timer(name) if timer is not None else contextlib.nullcontext()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler trace of the wrapped region, written on exit as
    ``log_dir/ractip_tpu_torch.<pid>.<ms>.pt.trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto).  Yields the profiler, whose
    events() and key_averages() the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    name = f"ractip_tpu_torch.{os.getpid()}.{int(time.time() * 1e3)}"
    prof.export_chrome_trace(os.path.join(log_dir, name + ".pt.trace.json"))
