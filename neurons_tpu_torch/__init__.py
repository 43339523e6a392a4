"""neurons_tpu_torch: the PyTorch/CUDA port of neurons_tpu.

Mirrors the JAX package's layout module by module. It imports torch,
numpy and the standard library only; its hand-written CUDA kernels, five
sources under csrc/ (flash_attn_fwd.cu, the flash-attention forward;
flash_attn_bwd.cu, its backward; temporal_attn_fwd.cu, the temporal
attention; gn_silu.cu, GroupNorm+SiLU; gn_silu_conv.cu, GroupNorm+SiLU+3x3
conv), are built with nvcc on first use. Entry points run on the card
unless the caller passes device="cpu".
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device without CUDA
    raises: the port never moves to the CPU on its own. Inside a process
    group a bare "cuda" is this process's card, cuda:LOCAL_RANK."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if (dev.type == "cuda" and dev.index is None
            and torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        from neurons_tpu_torch.parallel.distributed import local_rank
        dev = torch.device("cuda", local_rank())
    return dev
