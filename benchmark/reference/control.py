"""The control: the reference computed one precision below the
configuration's bf16. The reference runs in the configuration's bf16
(activations and LayerNorm as the program stores them), and the operands
of every product are rounded to fp8 (e4m3, each tensor scaled by its
largest magnitude onto the format's largest value, 448): every Linear's
input and weight, and the attention's queries, keys and values, forward
and backward. That is the step from bf16 to fp8 matmuls and fp8 attention
that would tempt a later change. A check that this passes could not tell
a bf16 program from an fp8 one."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference.k3m_plain import attention, layers

E4M3_MAX = 448.0


def fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to e4m3 under its per-tensor scale, back in `dtype`; the
    gradient passes straight through, as fp8 training keeps its gradients
    in a wider type."""
    with torch.no_grad():
        scale = E4M3_MAX / x.float().abs().amax().clamp(min=1e-12)
        q = ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(dtype)
    x = x.to(dtype)
    return x + (q - x).detach()


def _forward(self, x):
    dt = self.compute_dtype or self.weight.dtype
    bias = self.bias.to(dt) if self.bias is not None else None
    return F.linear(fp8(x, dt), fp8(self.weight, dt), bias)


def _qkv(fn):
    def call(q, k, v, *args, **kwargs):
        return fn(fp8(q, q.dtype), fp8(k, k.dtype), fp8(v, v.dtype), *args, **kwargs)
    return call


@contextlib.contextmanager
def lower_precision():
    saved = (layers.Linear.forward, attention.attention_plain, attention.attention_bwd_plain)
    layers.Linear.forward = _forward
    attention.attention_plain = _qkv(saved[1])
    attention.attention_bwd_plain = _qkv(saved[2])
    try:
        yield
    finally:
        layers.Linear.forward, attention.attention_plain, attention.attention_bwd_plain = saved
