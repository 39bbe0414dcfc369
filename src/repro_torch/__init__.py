"""PyTorch / CUDA port of the ``repro`` model path, for one NVIDIA H100.

The package imports ``torch`` and numpy and nothing of ``repro`` or JAX: what
it needs of ``repro``'s JAX-free modules it keeps as its own copy.  Entry
points run on ``cuda`` unless the caller asks for the CPU.
"""
import torch


def resolve_device(name="cuda") -> torch.device:
    """The device an entry point runs on; a CUDA device without a card raises
    rather than fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device
