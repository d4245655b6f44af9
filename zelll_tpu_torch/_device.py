"""Device selection shared by the port's entry points.

The rule: inputs that are not yet tensors go to ``device="cuda"`` unless the
caller names another device; a tensor keeps its own device. A CPU tensor or
``device="cpu"`` selects the plain PyTorch path. Asking for CUDA on a host
without a CUDA device raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on.

    ``device`` wins when given; otherwise a tensor ``like`` lends its device,
    and anything else means CUDA.
    """
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass CPU tensors or device='cpu' "
            "to run the plain PyTorch path"
        )
    return device

