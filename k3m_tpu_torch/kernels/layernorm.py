"""Fused (residual add +) LayerNorm, forward and backward: CUDA kernels and
plain versions.

`fused_layernorm` launches `csrc/layernorm.cu` for CUDA tensors and runs
`layernorm_plain` for CPU tensors; it never falls back from one to the
other. The forward kernel has two instances, which `ln_instance` picks
from the width and the tensors' alignment: the vector instance (16-byte
loads and stores, the next row prefetched; every main-path shape, up to
MAX_VEC_N columns: the 2048-wide text of the DeepSeek-V2 block's
co-attention and heads) and the per-element one (any other width up to
MAX_N, or alignment), counted apart in
`fused_layernorm.per_element_launches`; a row wider than MAX_N that the
vector instance cannot take raises. Numerics follow
k3m_tpu/kernels/layernorm.py: fp32 two-pass mean and centered variance,
eps inside the rsqrt, cast to the output dtype at the end. Where a
gradient is needed the call goes through `_FusedLayerNorm`, which saves the
output, the fp32 row rstd, scale and bias (never the inputs, as
`_fused_ln_fwd` does) and runs `layernorm_bwd` (kernel) or
`layernorm_bwd_plain` (CPU) on them.
"""

from __future__ import annotations

import torch

from k3m_tpu_torch.kernels import build
from k3m_tpu_torch.utils import trace

MAX_N = 1024       # the per-element instance's widest rows
MAX_VEC_N = 2048   # the vector instance's and the backward's
VEC = 8    # the vector instance takes widths that are multiples of VEC


def _plain_fwd(x, scale, bias, residual, eps, out_dtype):
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    u = xf.mean(-1, keepdim=True)
    c = xf - u
    s = (c * c).mean(-1, keepdim=True)
    rstd = torch.rsqrt(s + eps)
    y = c * rstd * scale.float() + bias.float()
    return y.to(out_dtype), rstd[..., 0]


def layernorm_plain(x, scale, bias, residual=None, *, eps: float = 1e-12,
                    out_dtype=None):
    return _plain_fwd(x, scale, bias, residual, eps,
                      out_dtype if out_dtype is not None else x.dtype)[0]


def layernorm_bwd_plain(y, rstd, scale, bias, dy, x_dtype=None):
    """(dx, dscale, dbias) from the saved output `y`, its fp32 row `rstd`
    and the upstream `dy`, with the formulas of
    k3m_tpu/kernels/layernorm.py:_ln_bwd_kernel (and csrc/layernorm.cu)."""
    n = y.shape[-1]
    s = scale.float()
    safe = torch.where(s.abs() < 1e-6, torch.full_like(s, 1e-6), s)
    xhat = ((y.float() - bias.float()) / safe).reshape(-1, n)
    d = dy.float().reshape(-1, n)
    g = d * s
    gm = g.mean(-1, keepdim=True)
    gxm = (g * xhat).mean(-1, keepdim=True)
    dx = rstd.reshape(-1, 1).float() * (g - gm - xhat * gxm)
    dx = dx.reshape(y.shape).to(x_dtype if x_dtype is not None else y.dtype)
    return dx, (d * xhat).sum(0), d.sum(0)


def _check(x, scale, bias, residual, out_dtype):
    n = x.shape[-1]
    if x.dtype not in build.DTYPE_CODES or out_dtype not in build.DTYPE_CODES:
        raise TypeError(f"fused_layernorm: unsupported dtypes {x.dtype} -> {out_dtype}")
    if not 0 < n <= MAX_VEC_N or x.numel() == 0:
        raise ValueError(f"fused_layernorm: last dim {n} not in (0, {MAX_VEC_N}]")
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


def ln_instance(n: int, ptrs: int) -> str:
    """The forward kernel's instance for rows of `n` columns whose tensors
    (x, the residual, scale and bias; the output is allocated 16-byte
    aligned) start at addresses whose bitwise or is `ptrs`: "vector" where
    n is a multiple of VEC (so a row is a whole number of 16-byte vectors in
    bf16 and in fp32, and each row of a contiguous tensor is 16-byte aligned
    where the tensor is) and every tensor is 16-byte aligned; "per_element"
    otherwise (which takes at most MAX_N columns)."""
    return "vector" if n % VEC == 0 and ptrs % 16 == 0 else "per_element"


@trace.spanned("k3m.kernel.fused_layernorm", arguments=True)
def _forward(x, scale, bias, residual, eps, out_dtype, with_rstd, instance=None):
    """(out, rstd or None) on x's device: the kernel for CUDA tensors, the
    plain version for CPU tensors. `instance` ("vector" or "per_element")
    overrides the one `ln_instance` picks; one the shape cannot take
    raises."""
    if x.device.type == "cpu":
        out, rstd = _plain_fwd(x, scale, bias, residual, eps, out_dtype)
        return out, (rstd if with_rstd else None)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    _check(x, scale, bias, residual, out_dtype)
    n = x.shape[-1]
    rows = x.numel() // n
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) \
        if with_rstd else None
    xp, sp, bp = x.data_ptr(), scale.data_ptr(), bias.data_ptr()
    rp = residual.data_ptr() if residual is not None else None
    if instance is None:
        instance = ln_instance(n, xp | sp | bp | (rp or 0))
    if instance == "per_element" and n > MAX_N:
        raise ValueError(f"fused_layernorm: rows of {n} columns need the vector instance "
                         f"(a multiple of {VEC} columns, 16-byte aligned tensors); the "
                         f"per-element one takes at most {MAX_N}")
    rc = build.library().k3m_layernorm_fwd(
        xp, build.DTYPE_CODES[x.dtype], rp,
        build.DTYPE_CODES[residual.dtype] if residual is not None else 0,
        sp, bp, out.data_ptr(), build.DTYPE_CODES[out_dtype],
        rstd.data_ptr() if rstd is not None else None,
        rows, n, eps, instance == "vector", build.stream_handle(x.device))
    if rc:
        build.check(rc, f"k3m_layernorm_fwd ({instance} instance)")
    fused_layernorm.launches += 1
    if instance == "per_element":
        fused_layernorm.per_element_launches += 1
    return out, rstd


@trace.spanned("k3m.kernel.layernorm_bwd", arguments=True)
def layernorm_bwd(y, rstd, scale, bias, dy, x_dtype):
    """(dx, dscale, dbias): the backward kernel for CUDA tensors, the plain
    version for CPU tensors. The kernel reads rows of whole 16-byte vectors:
    N a multiple of 8 in bf16, of 4 in fp32, up to MAX_VEC_N. A `dy` of
    another dtype or layout than y is copied first (none is on the training
    path)."""
    if y.device.type == "cpu":
        return layernorm_bwd_plain(y, rstd, scale, bias, dy, x_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"layernorm_bwd: unsupported device {y.device}")
    n = y.shape[-1]
    rows = y.numel() // n
    if not 0 < n <= MAX_VEC_N or x_dtype not in build.DTYPE_CODES \
            or y.dtype not in build.DTYPE_CODES or n % (16 // y.element_size()):
        raise ValueError(f"layernorm_bwd: unsupported width {n} or dtypes "
                         f"{y.dtype} -> {x_dtype}")
    if not y.is_contiguous():
        raise ValueError("layernorm_bwd: y must be contiguous")
    if dy.dtype != y.dtype or not dy.is_contiguous():
        dy = dy.to(y.dtype).contiguous()
    lib = build.library()
    bands = lib.k3m_ln_bwd_bands(rows)
    dx = torch.empty(y.shape, dtype=x_dtype, device=y.device)
    part = torch.empty(2 * bands * n, dtype=torch.float32, device=y.device)
    dscale = torch.empty(n, dtype=torch.float32, device=y.device)
    dbias = torch.empty(n, dtype=torch.float32, device=y.device)
    rc = lib.k3m_layernorm_bwd(
        y.data_ptr(), build.DTYPE_CODES[y.dtype], rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), dy.data_ptr(), dx.data_ptr(), build.DTYPE_CODES[x_dtype],
        part.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), rows, n,
        build.stream_handle(y.device))
    build.check(rc, "k3m_layernorm_bwd")
    layernorm_bwd.launches += 1
    return dx, dscale, dbias


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, scale, bias, eps, out_dtype):
        out, rstd = _forward(x, scale, bias, residual, eps, out_dtype, True)
        ctx.save_for_backward(out, rstd, scale, bias)
        ctx.x_dtype = x.dtype
        ctx.res_dtype = residual.dtype if residual is not None else None
        return out

    @staticmethod
    def backward(ctx, dy):
        out, rstd, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = layernorm_bwd(out, rstd, scale, bias, dy, ctx.x_dtype)
        dres = None
        if ctx.res_dtype is not None:
            dres = dx if ctx.res_dtype == dx.dtype else dx.to(ctx.res_dtype)
        return dx, dres, dscale, dbias, None, None


def fused_layernorm(x, scale, bias, residual=None, *, eps: float = 1e-12,
                    out_dtype=None):
    """LayerNorm(x + residual) over the last axis. x/residual fp32 or bf16
    (each its own dtype), scale/bias fp32 [N]; returns `out_dtype`
    (default x.dtype). Differentiable in all four tensors."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, residual, scale, bias)):
        return _FusedLayerNorm.apply(x, residual, scale, bias, eps, out_dtype)
    return _forward(x, scale, bias, residual, eps, out_dtype, False)[0]


fused_layernorm.launches = 0                # every launch of the forward kernel
fused_layernorm.per_element_launches = 0    # those of its per-element instance
layernorm_bwd.launches = 0
