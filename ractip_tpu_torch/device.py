"""Device plumbing: every public entry point takes an explicit ``device``.

Nothing on the main path picks the CPU by itself: asking for CUDA where no
CUDA device is present raises.  The CPU is used only when a caller names it
(the CPU tests pass ``device="cpu"``), and there every kernel wrapper runs its
plain PyTorch version.
"""

from __future__ import annotations

import torch


def require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ractip_tpu_torch: CUDA was requested but torch.cuda.is_available()"
            " is False (pass device='cpu' to run the plain PyTorch versions)")


def resolve(device) -> torch.device:
    """torch.device for `device`; raises for CUDA without a CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev

