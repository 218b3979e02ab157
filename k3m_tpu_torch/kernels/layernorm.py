"""Fused (residual add +) LayerNorm forward: CUDA kernel and plain version.

`fused_layernorm` launches `csrc/layernorm.cu` for CUDA tensors and runs
`layernorm_plain` for CPU tensors; it never falls back from one to the
other. Numerics follow k3m_tpu/kernels/layernorm.py:_ln_fwd_kernel: fp32
two-pass mean and centered variance, eps inside the rsqrt, cast to the
output dtype at the end.
"""

from __future__ import annotations

import torch

from k3m_tpu_torch.kernels import build

MAX_N = 1024


def layernorm_plain(x, scale, bias, residual=None, *, eps: float = 1e-12,
                    out_dtype=None):
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    u = xf.mean(-1, keepdim=True)
    c = xf - u
    s = (c * c).mean(-1, keepdim=True)
    y = c * torch.rsqrt(s + eps) * scale.float() + bias.float()
    return y.to(out_dtype if out_dtype is not None else x.dtype)


def _check(x, scale, bias, residual, out_dtype):
    n = x.shape[-1]
    if x.dtype not in build.DTYPE_CODES or out_dtype not in build.DTYPE_CODES:
        raise TypeError(f"fused_layernorm: unsupported dtypes {x.dtype} -> {out_dtype}")
    if not 0 < n <= MAX_N or x.numel() == 0:
        raise ValueError(f"fused_layernorm: last dim {n} not in (0, {MAX_N}]")
    if not x.is_contiguous():
        raise ValueError("fused_layernorm: x must be contiguous")
    if residual is not None:
        if residual.shape != x.shape or not residual.is_contiguous():
            raise ValueError("fused_layernorm: residual must be contiguous and shaped like x")
        if residual.dtype not in build.DTYPE_CODES or residual.device != x.device:
            raise TypeError("fused_layernorm: bad residual dtype or device")
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.dtype != torch.float32 or p.shape != (n,) or not p.is_contiguous()
                or p.device != x.device):
            raise ValueError(f"fused_layernorm: {name} must be fp32 [{n}] on {x.device}")


def fused_layernorm(x, scale, bias, residual=None, *, eps: float = 1e-12,
                    out_dtype=None):
    """LayerNorm(x + residual) over the last axis. x/residual fp32 or bf16
    (each its own dtype), scale/bias fp32 [N]; returns `out_dtype`
    (default x.dtype)."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, residual, eps=eps,
                               out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    _check(x, scale, bias, residual, out_dtype)
    n = x.shape[-1]
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rc = build.library().k3m_layernorm_fwd(
        x.data_ptr(), build.DTYPE_CODES[x.dtype],
        residual.data_ptr() if residual is not None else None,
        build.DTYPE_CODES[residual.dtype] if residual is not None else 0,
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[out_dtype], x.numel() // n, n, eps,
        build.stream_handle(x.device))
    build.check(rc, "k3m_layernorm_fwd")
    fused_layernorm.launches += 1
    return out


fused_layernorm.launches = 0
