"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors, and counts its kernel launches in `.launches`.
"""

from k3m_tpu_torch.kernels.attention import attention_plain, fused_attention
from k3m_tpu_torch.kernels.coattn import biattention_plain, fused_biattention
from k3m_tpu_torch.kernels.layernorm import fused_layernorm, layernorm_plain

WRAPPERS = {
    "fused_layernorm": fused_layernorm,
    "fused_attention": fused_attention,
    "fused_biattention": fused_biattention,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["attention_plain", "biattention_plain", "fused_attention",
           "fused_biattention", "fused_layernorm", "layernorm_plain",
           "launch_counts", "reset_launch_counts", "WRAPPERS"]
