"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors, and counts its kernel launches in `.launches`.
The forward wrappers are differentiable: their backward runs
`layernorm_bwd` / `attention_bwd`, which count their own launches.
"""

from k3m_tpu_torch.kernels.attention import (
    attention_bwd, attention_bwd_plain, attention_lse_plain, attention_plain,
    fused_attention, philox_keep_mask_plain,
)
from k3m_tpu_torch.kernels.coattn import biattention_plain, fused_biattention
from k3m_tpu_torch.kernels.layernorm import (
    fused_layernorm, layernorm_bwd, layernorm_bwd_plain, layernorm_plain,
)

WRAPPERS = {
    "fused_layernorm": fused_layernorm,
    "layernorm_bwd": layernorm_bwd,
    "fused_attention": fused_attention,
    "attention_bwd": attention_bwd,
    "fused_biattention": fused_biattention,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["attention_bwd", "attention_bwd_plain", "attention_lse_plain", "attention_plain",
           "biattention_plain", "fused_attention", "fused_biattention",
           "fused_layernorm", "layernorm_bwd", "layernorm_bwd_plain",
           "layernorm_plain", "launch_counts", "philox_keep_mask_plain",
           "reset_launch_counts", "WRAPPERS"]
