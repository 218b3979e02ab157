"""PyTorch/CUDA port of K3M for one NVIDIA H100.

A second package beside the JAX reference (`k3m_tpu`). It imports torch,
numpy and the standard library only; every TPU (Pallas) kernel on a ported
path is a hand-written CUDA kernel under `kernels/csrc/`. Entry points run on
the CUDA device unless the caller passes `device="cpu"`, where each kernel's
plain PyTorch version runs instead.
"""

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.device import resolve_device

__all__ = ["K3MConfig", "resolve_device"]
