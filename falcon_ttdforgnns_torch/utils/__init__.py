import torch

from .logger import get_logger


def resolve_device(device="cuda") -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU.
    Asking for CUDA where there is none raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
