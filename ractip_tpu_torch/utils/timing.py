"""Per-stage wall-clock timer with exclusive nesting.

``with timer("fold"):`` accumulates the seconds spent in the block; a stage
opened inside another pauses the outer one, so the stages partition the
time.  Given a device, every boundary synchronizes it first, so a stage's
seconds include the device work it queued.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


class StageTimer:
    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.seconds: dict[str, float] = {}
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
        try:
            yield self
        finally:
            self._sync()
            now = time.perf_counter()
            name, t0 = self._stack.pop()
            self.seconds[name] = self.seconds.get(name, 0.0) + now - t0
            if self._stack:
                self._stack[-1][1] = now

    def report(self) -> dict[str, float]:
        return dict(self.seconds)

    def json(self) -> str:
        return json.dumps({k: round(v, 6) for k, v in self.seconds.items()})


def stage(timer, name: str):
    """timer(name), or a no-op context without a timer."""
    return timer(name) if timer is not None else contextlib.nullcontext()
