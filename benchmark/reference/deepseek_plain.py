"""A frozen copy of the port's plain fp32 reference of DeepSeek-V2's layer as
K3M's text block (k3m_tpu_torch/reference/deepseek_v2.py as it stood when
the benchmark's DeepSeek-V2 cell was written), which the benchmark composes
with k3m_plain (reference/k3m_deepseek.py). It imports nothing of the
program.

Plain `torch` operations, one expert at a time, no kernel of the port and
nothing of JAX: the layer that model/deepseek.py computes with its kernels,
written from DeepSeek-V2 (arXiv:2405.04434, §2.1-2.2) and the published
DeepSeek-V2-Lite config.json and modeling code, for the tests
(tests/test_torch_deepseek.py) and the benchmark's check.
On a card it turns TF32 off (`no_tf32`), so that its products are fp32.

    h   = x + MLA(RMSNorm(x)),   out = h + F(RMSNorm(h))

MLA without q-LoRA: q = W_q u per head [q_nope | q_pe]; [c | k_pe] =
W_kva u, c <- RMSNorm(c); W_kvb c per head [k_nope | v]; q_pe and the
shared k_pe rotated at the stream's positions 0 .. L - 1 pair by pair
((2i, 2i + 1), DeepSeek-V2's layout: first elements, then second), with
YaRN's frequencies; softmax((q k^T) m^2 / sqrt(d_qk) + key bias) v; W_o.
F is SwiGLU(intermediate_size) in layers below `first_k_dense_replace`,
else the MoE: s = softmax(W_g u) over every routed expert in fp32, T = the
greedy top-k of s, out = sum over i in T that this share holds of s_i E_i(u),
plus the shared experts S(u) (one SwiGLU of their summed width). The
sequence-wise balance term alpha sum_i f_i P_i, f_i = E / (k L) #{t: i in
T_t}, P_i = mean_t s_i, over each sequence's real tokens; each call adds
(its sequences' sum, its sequences) to the layer's `balance_terms`.

Departures from the published model, each K3M's:
  * the attention is bidirectional with K3M's key-padding bias, not causal
    (K3M's masked-LM needs every position);
  * the vocabulary is K3M's WordPiece ids (the embedding table's rows);
  * the embedding is the token embedding alone: no absolute positions,
    token types or embedding LayerNorm (rope carries position);
  * a layer holds the routed experts of `experts_held` alone (the share of
    one card of an expert-parallel deployment); with every expert held it
    is the uncut layer.
Parameter names are the port's (model/deepseek.py), so that one state dict
serves both.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config:
    hidden_size: int = 2048
    intermediate_size: int = 10944
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    rms_norm_eps: float = 1e-6
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    aux_loss_alpha: float = 0.001
    experts_held: Tuple[int, ...] = ()

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeepSeekV2Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})

    @property
    def held(self) -> Tuple[int, int]:
        return tuple(self.experts_held) if self.experts_held else (0, self.n_routed_experts)


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32 on a card (TF32 off), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def yarn(cfg: DeepSeekV2Config) -> Tuple[torch.Tensor, float]:
    """(inv_freq [d_rope / 2] float64, softmax scale m^2 / sqrt(d_qk)) after
    DeepSeek-V2's YaRN: theta_i = base^(-2i/d) for i up to
    floor(d(beta_fast)), theta_i / factor from ceil(d(beta_slow)), a linear
    ramp between, d(r) = d ln(orig / (2 pi r)) / (2 ln base);
    m = 0.1 mscale_all_dim ln(factor) + 1."""
    d = cfg.qk_rope_head_dim
    i = torch.arange(d // 2, dtype=torch.float64)
    theta = cfg.rope_theta ** (-2.0 * i / d)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    rs = cfg.rope_scaling
    if not rs:
        return theta, scale
    factor = rs["factor"]
    rot = lambda r: d * math.log(rs["original_max_position_embeddings"] / (2 * math.pi * r)) \
        / (2 * math.log(cfg.rope_theta))
    lo = max(math.floor(rot(rs["beta_fast"])), 0)
    hi = min(math.ceil(rot(rs["beta_slow"])), d - 1)
    t = ((i - lo) / max(hi - lo, 1e-3)).clamp(0, 1)      # 0: theta, 1: theta / factor
    inv_freq = theta * (1 - t) + theta / factor * t
    m = 0.1 * rs["mscale_all_dim"] * math.log(factor) + 1.0 if factor > 1 else 1.0
    return inv_freq, scale * m * m


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def rotate(x, positions, inv_freq):
    """x [B, L, ..., d] rotated pair by pair at `positions` [L], output in
    DeepSeek-V2's layout (the pairs' first elements, then their second)."""
    ang = positions[:, None].double() * inv_freq[None, :]           # [L, d / 2]
    shape = (1, ang.shape[0]) + (1,) * (x.dim() - 3) + (ang.shape[1],)
    cos, sin = ang.cos().float().view(shape), ang.sin().float().view(shape)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


class _Weight(nn.Linear):
    """A bias-free linear map (an nn.Linear, so that weights drawn for
    Linear modules by name reach it)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__(n_in, n_out, bias=False)

    def forward(self, x):
        return x @ self.weight.t()


class _Norm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class SwiGLU(nn.Module):
    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = _Weight(hidden, width)
        self.up_proj = _Weight(hidden, width)
        self.down_proj = _Weight(width, hidden)

    def forward(self, u):
        return self.down_proj(F.silu(self.gate_proj(u)) * self.up_proj(u))


class MLA(nn.Module):
    def __init__(self, cfg: DeepSeekV2Config):
        super().__init__()
        self.cfg = cfg
        H, n = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = _Weight(H, n * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
        self.kv_a_proj_with_mqa = _Weight(H, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = _Norm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = _Weight(cfg.kv_lora_rank, n * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = _Weight(n * cfg.v_head_dim, H)

    def forward(self, u, bias):
        """u [B, L, hidden], bias [B, L] additive key bias."""
        c = self.cfg
        B, L, _ = u.shape
        n, dn, dr = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        inv_freq, scale = yarn(c)
        pos = torch.arange(L, device=u.device)
        inv_freq = inv_freq.to(u.device)
        q = self.q_proj(u).view(B, L, n, dn + dr)
        ckv = self.kv_a_proj_with_mqa(u)
        lat, k_pe = ckv[..., :c.kv_lora_rank], ckv[..., c.kv_lora_rank:]
        kv = self.kv_b_proj(self.kv_a_layernorm(lat)).view(B, L, n, dn + c.v_head_dim)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q = torch.cat([q[..., :dn], rotate(q[..., dn:], pos, inv_freq)], dim=-1)
        k_pe = rotate(k_pe, pos, inv_freq)[:, :, None, :].expand(B, L, n, dr)
        k = torch.cat([k_nope, k_pe], dim=-1)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias[:, None, None, :]
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        return self.o_proj(o.reshape(B, L, n * c.v_head_dim))


class Experts(nn.Module):
    """The held routed experts' weights, banked as the port holds them:
    w13 [E, hidden, 2 I] (gate, then up), w2 [E, I, hidden]."""

    def __init__(self, n: int, hidden: int, width: int):
        super().__init__()
        self.w13 = nn.Parameter(torch.zeros(n, hidden, 2 * width))
        self.w2 = nn.Parameter(torch.zeros(n, width, hidden))

    def expert(self, e: int, x):
        g, up = (x @ self.w13[e]).chunk(2, dim=-1)
        return (F.silu(g) * up) @ self.w2[e]


class MoE(nn.Module):
    def __init__(self, cfg: DeepSeekV2Config):
        super().__init__()
        self.cfg = cfg
        e0, e1 = cfg.held
        self.gate = _Weight(cfg.hidden_size, cfg.n_routed_experts)
        self.experts = Experts(e1 - e0, cfg.hidden_size, cfg.moe_intermediate_size)
        self.shared_experts = SwiGLU(cfg.hidden_size,
                                     cfg.moe_intermediate_size * cfg.n_shared_experts)

    def route(self, u):
        """(scores [.., E] fp32, top-k weights, top-k experts)."""
        s = torch.softmax(self.gate(u.float()), dim=-1)
        w, idx = torch.topk(s, self.cfg.num_experts_per_tok, dim=-1)
        return s, w, idx

    def forward(self, u):
        """(out, scores, experts) of u [B, L, hidden]."""
        e0, e1 = self.cfg.held
        s, w, idx = self.route(u)
        flat, wf, idxf = u.reshape(-1, u.shape[-1]), w.reshape(-1, w.shape[-1]), \
            idx.reshape(-1, idx.shape[-1])
        out = torch.zeros_like(flat)
        for e in range(e0, e1):
            rows, slot = torch.nonzero(idxf == e, as_tuple=True)
            if rows.numel():
                out.index_add_(0, rows, wf[rows, slot, None] * self.experts.expert(e - e0,
                                                                                  flat[rows]))
        return (out.view_as(u) + self.shared_experts(u)), s, idx


def sequence_balance(scores, idx, mask, n_experts: int):
    """Sum over the sequences of sum_i f_i P_i: scores [B, L, E], idx [B, L,
    k], mask [B, L] bool (the real tokens)."""
    total = scores.new_zeros(())
    k = idx.shape[-1]
    for b in range(scores.shape[0]):
        real = mask[b]
        n = int(real.sum())
        if n == 0:
            continue
        chosen = F.one_hot(idx[b][real], n_experts).sum(dim=(0, 1)).to(scores.dtype)
        f = chosen * n_experts / (k * n)
        P = scores[b][real].mean(0)
        total = total + (f * P).sum()
    return total


class DeepSeekV2Layer(nn.Module):
    """Layer `index` of the text stack (dense below first_k_dense_replace).
    Takes one stream [B, L, hidden] with its bias [B, L], or packed rows of
    several (an object with `rows` and `shapes`, one bias per stream),
    which it runs stream by stream."""

    def __init__(self, cfg: DeepSeekV2Config, index: int):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = _Norm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = _Norm(cfg.hidden_size, cfg.rms_norm_eps)
        self.moe = index >= cfg.first_k_dense_replace
        self.mlp = MoE(cfg) if self.moe else SwiGLU(cfg.hidden_size, cfg.intermediate_size)
        self.balance_terms = []

    checkpoint = False   # recompute the layer in the backward (the same numbers, less memory)

    def body(self, x, bias):
        """(out, scores, experts) of one stream; the last two None if dense."""
        h = x + self.self_attn(self.input_layernorm(x), bias)
        u = self.post_attention_layernorm(h)
        if not self.moe:
            return h + self.mlp(u), None, None
        f, s, idx = self.mlp(u)
        return h + f, s, idx

    def stream(self, x, bias):
        if self.checkpoint and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint
            out, s, idx = checkpoint(self.body, x, bias, use_reentrant=False)
        else:
            out, s, idx = self.body(x, bias)
        if self.moe:
            self.balance_terms.append(
                (sequence_balance(s, idx, bias == 0, self.cfg.n_routed_experts), x.shape[0]))
        return out

    def forward(self, x, bias, deterministic: bool = True):
        if not hasattr(x, "shapes"):
            return self.stream(x.float(), bias)
        outs, o = [], 0
        for (b, l), bs in zip(x.shapes, bias):
            outs.append(self.stream(x.rows[o:o + b * l].view(b, l, -1).float(), bs)
                        .reshape(b * l, -1))
            o += b * l
        return type(x)(torch.cat(outs), x.shapes)


def balance_loss(layers, alpha: float):
    """alpha times the sum over the MoE layers of each one's mean over the
    sequences it saw; clears the layers' terms."""
    total = None
    for layer in layers:
        if layer.balance_terms:
            s = sum(t for t, _ in layer.balance_terms) / sum(n for _, n in layer.balance_terms)
            total = s if total is None else total + s
            layer.balance_terms.clear()
    return None if total is None else alpha * total
