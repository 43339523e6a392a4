"""neurons_tpu_torch: the PyTorch/CUDA port of neurons_tpu.

Mirrors the JAX package's layout module by module. It imports torch,
numpy and the standard library only; its hand-written CUDA kernels
(csrc/*.cu: the flash-attention forward and backward, the temporal
attention) are built with nvcc on first use. Entry points run on the card
unless the caller passes device="cpu".
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device without CUDA
    raises: the port never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
