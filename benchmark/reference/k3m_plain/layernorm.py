"""Residual add + LayerNorm, plain PyTorch only (a frozen copy of the
port's plain versions): fp32 two-pass mean and centered variance, eps
inside the rsqrt, cast to the output dtype at the end; the backward from
the saved output and rstd."""

from __future__ import annotations

import torch


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


class _PlainLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, scale, bias, eps, out_dtype):
        out, rstd = _plain_fwd(x, scale, bias, residual, eps, out_dtype)
        ctx.save_for_backward(out, rstd, scale, bias)
        ctx.x_dtype = x.dtype
        ctx.res_dtype = residual.dtype if residual is not None else None
        return out

    @staticmethod
    def backward(ctx, dy):
        out, rstd, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = layernorm_bwd_plain(out, rstd, scale, bias, dy, ctx.x_dtype)
        dres = None
        if ctx.res_dtype is not None:
            dres = dx if ctx.res_dtype == dx.dtype else dx.to(ctx.res_dtype)
        return dx, dres, dscale, dbias, None, None


def fused_layernorm(x, scale, bias, residual=None, *, eps: float = 1e-12,
                    out_dtype=None):
    """LayerNorm(x + residual) over the last axis, in `out_dtype`."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, residual, scale, bias)):
        return _PlainLayerNorm.apply(x, residual, scale, bias, eps, out_dtype)
    return _plain_fwd(x, scale, bias, residual, eps, out_dtype)[0]
