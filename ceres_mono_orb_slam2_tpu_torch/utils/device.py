"""The device the port's entry points run on.

Every entry point (`MonoSLAM`, `Tracking`, `LocalMapping`, `DeviceMapPool`,
`ORBExtractor`, `FusedStep`, `global_bundle_adjustment`) runs on the card by
default (`device="cuda"`); the CPU, where the kernels' plain versions run,
is used only when the caller asks for it (`device="cpu"`).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device where there is none
    rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available: the port runs on the "
            "card by default; pass device='cpu' to run its plain versions on the CPU")
    return dev
