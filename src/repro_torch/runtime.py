"""Device selection for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  A CUDA request without a GPU raises; nothing falls back to
    the CPU quietly.  On CUDA, TF32 is switched off so that the fp32 stem
    conv and classifier match the reference's float32 arithmetic."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but no GPU is available; "
                               "pass device='cpu' to run the plain versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
