"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless told otherwise.

    ``None`` means the card. Without one this raises instead of quietly
    running on the CPU; callers that want the CPU (the tests) pass
    ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port"
            " on the CPU"
        )
    return torch.device("cuda")
