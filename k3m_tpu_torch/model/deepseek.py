"""DeepSeek-V2's text layer as K3M's text block (`text_block` "deepseek_v2").

The layer of DeepSeek-V2 (arXiv:2405.04434, §2.1 multi-head latent
attention, §2.2 DeepSeekMoE; the published DeepSeek-V2-Lite config.json and
its modeling code), pre-norm and without dropout:

    h   = x + MLA(RMSNorm(x))
    out = h + F(RMSNorm(h))

F is a SwiGLU W2(silu(W1 u) * W3 u) of `intermediate_size` in the first
`first_k_dense_replace` layers and the MoE below in every later one. The
text stack's last layer is followed by one more RMSNorm (`encoder.norm`)
on every stream's output. Module names are the published model's
(`self_attn.q_proj`, `mlp.gate`, `mlp.shared_experts.up_proj`, ...), but
for the held routed experts, whose weights are two banks
(`mlp.experts.w13` [E, hidden, 2 I], gate and up side by side, and
`mlp.experts.w2` [E, I, hidden]) for the grouped GEMMs.

MLA, without q-LoRA: q = W_q u holds per head [q_nope 128 | q_pe 64];
[c | k_pe] = W_kva u, c <- RMSNorm(c) (the 512 latent), W_kvb c holds per
head [k_nope 128 | v 128]; k_pe (64) is shared by the heads. q_pe and k_pe
are rotated at positions 0 .. L - 1 of each stream, each adjacent pair
(2i, 2i + 1) by angle pos * inv_freq_i, in DeepSeek-V2's layout (the pairs'
first elements, then their second). The attention is bidirectional with
K3M's key-padding bias, the one departure from the causal LM (K3M's MLM
needs it), and runs in the fused attention kernel's two-width instance
(q.k 192, v 128) with the softmax scale m^2 / sqrt(192): YaRN's attention
factor m = 0.1 mscale_all_dim ln(factor) + 1 folded into the kernel's
scale argument. YaRN's frequencies (`yarn_inv_freq`): theta_i =
rope_theta^(-2i/64), kept below the ramp's low end, divided by `factor`
above its high end, a linear ramp between; cos and sin are scaled by
mscale / mscale_all_dim = 1.

MoE: s = softmax(W_g u) over all `n_routed_experts`, in fp32; T the greedy
top `num_experts_per_tok` of s, not renormalised;
out = sum over i in T and held of s_i E_i(u), plus S(u), the
`n_shared_experts` shared experts as one SwiGLU of their summed width. The
layer holds the routed experts `experts_held` [e0, e1) alone, routes over
all of them and computes its own experts' part: the chip's share of an
expert-parallel deployment, whose exchange this process does not run.
Padding rows are routed like any row. The (row, choice) pairs are sorted
by held expert (`route`), the held ones first; the sort's buffers are
sized at capacity, every pair of the layer (R = N k rows), while the work
is bounded by the held-pair count offs[-1], which is read on the device
alone: no count reaches the host. The held pairs' rows are gathered, run
through SwiGLU as two grouped GEMMs (`torch._grouped_mm` on the card, with
the group offsets on the device) and summed back into their rows with
their scores (`combine`); the gather, SwiGLU and the combine, and their
gradients, are kernels (kernels/moe.py) that skip the sorted rows at or
past offs[-1], as the GEMMs do.

Balance loss, DeepSeek-V2's sequence-wise one: alpha sum_i f_i P_i per
sequence over its real tokens (the bias' zeros), f_i = E / (k L) times the
count of its tokens that chose i, P_i the mean of s_i; averaged over the
sequences a layer sees (every stream's rows of the global batch) and
summed over the MoE layers. The layers add their sums to the collector of
`balance_loss` (a context), which the pretraining model opens around its
forward (model/pretrain.py).

Spans: `k3m.mla` (the projections and rope), `k3m.moe.route` (router,
softmax, top-k, the sort and the gather; in the backward the sum of each
row's pairs' gradients), `k3m.moe.experts` (the grouped GEMMs and
SwiGLU), `k3m.moe.combine`, `k3m.moe.shared`; counters
`k3m.moe.expert_rows` (rows per held expert) and `k3m.moe.rows` (the
held pairs computed), added on the device, and `k3m.moe.pairs` (the sort's
capacity R, which the host knows), added on the host; all read once a
recording (utils/trace.py).

Tensor parallelism is not built for this block (train/mesh.py refuses it);
data parallelism is the BERT block's: no collective runs inside a layer.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from k3m_tpu_torch import dist
from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.kernels import fused_attention
from k3m_tpu_torch.kernels.moe import (
    moe_combine_bwd, moe_combine_fwd, moe_gather, moe_gather_sum, swiglu_bwd, swiglu_fwd,
)
from k3m_tpu_torch.model.layers import (
    Linear, Packed, compute_dtype, fused_dense, pack_rows, unpack_rows,
)
from k3m_tpu_torch.utils import trace


# ------------------------------------------------------------------ YaRN

def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: K3MConfig) -> Tuple[torch.Tensor, float]:
    """(inv_freq [qk_rope_head_dim / 2] fp32, softmax scale) of the config:
    YaRN's frequencies and m^2 / sqrt(q_head_dim) (module docstring); plain
    rope and 1 / sqrt(q_head_dim) without `rope_scaling`."""
    dim = cfg.qk_rope_head_dim
    base = float(cfg.rope_theta)
    theta = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    rs = cfg.rope_scaling
    if rs is None:
        return theta.float(), scale
    factor = float(rs["factor"])
    orig = rs.get("original_max_position_embeddings", 4096)

    def correction_dim(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs.get("beta_fast", 32))), 0)
    high = min(math.ceil(correction_dim(rs.get("beta_slow", 1))), dim - 1)
    ramp = (torch.arange(dim // 2, dtype=torch.float64) - low) / max(high - low, 0.001)
    extra = 1.0 - ramp.clamp(0.0, 1.0)          # 1: theta kept; 0: theta / factor
    inv_freq = theta / factor * (1.0 - extra) + theta * extra
    m = yarn_get_mscale(factor, rs.get("mscale_all_dim", 0.0))
    return inv_freq.float(), scale * m * m


def rope(x, cos, sin):
    """x [..., 2n] rotated pair by pair ((2i, 2i + 1) by angle i), in
    DeepSeek-V2's layout: out[i] = x[2i] cos - x[2i+1] sin, out[n + i] =
    x[2i+1] cos + x[2i] sin; cos/sin [..., n] broadcast against x's
    leading dims. Computed in fp32, returned in x's dtype."""
    pairs = x.float().unflatten(-1, (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------- modules

class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight, in fp32, out in `out_dtype`."""

    def __init__(self, dim: int, eps: float, out_dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.out_dtype = out_dtype

    def forward(self, x):
        x = x.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return (x * self.weight).to(self.out_dtype)


def _linear(n_in: int, n_out: int) -> Linear:
    return Linear(n_in, n_out, bias=False)


class SwiGLU(nn.Module):
    """down_proj(silu(gate_proj u) * up_proj u); gate and up as one product
    under `fused_qkv`."""

    def __init__(self, hidden: int, width: int, fused: bool):
        super().__init__()
        self.fused = fused
        self.gate_proj = _linear(hidden, width)
        self.up_proj = _linear(hidden, width)
        self.down_proj = _linear(width, hidden)

    def forward(self, u):
        if self.fused:
            g, up = fused_dense(u, (self.gate_proj, self.up_proj))
        else:
            g, up = self.gate_proj(u), self.up_proj(u)
        return self.down_proj(F.silu(g) * up)


class MLA(nn.Module):
    """Multi-head latent attention without q-LoRA (module docstring) over
    the packed rows of streams of `shapes`, one key bias per stream."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.heads = cfg.num_attention_heads
        self.nope, self.pe, self.dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.fused = cfg.fused_qkv
        hidden, heads = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = _linear(hidden, heads * (self.nope + self.pe))
        self.kv_a_proj_with_mqa = _linear(hidden, cfg.kv_lora_rank + self.pe)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, dt)
        self.kv_b_proj = _linear(cfg.kv_lora_rank, heads * (self.nope + self.dv))
        self.o_proj = _linear(heads * self.dv, hidden)
        inv_freq, self.scale = yarn_inv_freq(cfg)
        self.register_buffer("inv_freq", inv_freq, persistent=False)
        self._angles: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def angles(self, shapes, device):
        """(cos, sin) [rows, pe / 2] of the packed rows of streams (B, L_i):
        each row at its position in its stream; kept per shapes."""
        key = (tuple(shapes), str(device))
        if key not in self._angles:
            pos = torch.cat([torch.arange(L, device=device, dtype=torch.float32).repeat(b)
                             for b, L in shapes])
            ang = pos[:, None] * self.inv_freq.to(device)[None, :]
            self._angles[key] = (ang.cos(), ang.sin())
        return self._angles[key]

    def forward(self, rows, shapes, biases):
        H, n = self.heads, rows.shape[0]
        with trace.span("k3m.mla"):
            if self.fused:
                q, kva = fused_dense(rows, (self.q_proj, self.kv_a_proj_with_mqa))
            else:
                q, kva = self.q_proj(rows), self.kv_a_proj_with_mqa(rows)
            c, k_pe = kva.split([kva.shape[-1] - self.pe, self.pe], dim=-1)
            kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(n, H, self.nope + self.dv)
            k_nope, v = kv.split([self.nope, self.dv], dim=-1)
            q = q.view(n, H, self.nope + self.pe)
            cos, sin = self.angles(shapes, rows.device)
            q = torch.cat([q[..., :self.nope], rope(q[..., self.nope:], cos[:, None],
                                                    sin[:, None])], dim=-1)
            k_pe = rope(k_pe, cos, sin)[:, None, :].expand(n, H, self.pe)
            k = torch.cat([k_nope, k_pe], dim=-1)
        ctx = [fused_attention(qs, ks, vs, b, scale=self.scale)
               for qs, ks, vs, b in zip(unpack_rows(q, shapes), unpack_rows(k, shapes),
                                        unpack_rows(v, shapes), biases)]
        return self.o_proj(pack_rows([c.flatten(2) for c in ctx])[0])


# ------------------------------------------------------ the balance loss

_balance: contextvars.ContextVar = contextvars.ContextVar("k3m_balance", default=None)


@contextlib.contextmanager
def balance_loss():
    """Collect the MoE layers' balance sums over one forward: yields a dict
    layer index -> [sum over its sequences of sum_i f_i P_i (a device
    scalar), sequences], which `balance_total` reads."""
    acc: Dict[int, list] = {}
    token = _balance.set(acc)
    try:
        yield acc
    finally:
        _balance.reset(token)


def balance_total(acc: Dict[int, list], alpha: float, rows: int) -> Optional[torch.Tensor]:
    """alpha times the sum over the MoE layers of their sums over the
    number of sequences each saw in the global batch (`rows`: this rank's
    batch rows, scaled to the global batch by the active world)."""
    if not acc:
        return None
    _, total = dist.window(rows)
    return alpha * sum(s / (n * total / rows) for s, n in acc.values())


def sequence_balance(scores, idx, mask, n_experts: int):
    """Sum over the sequences of one stream of sum_i f_i P_i: scores [B, L,
    E] fp32, idx [B, L, k] the chosen experts, mask [B, L] the real tokens
    (module docstring)."""
    B, L, k = idx.shape
    m = mask.to(scores.dtype)
    real = m.sum(1).clamp(min=1.0)                                   # [B]
    counts = torch.zeros(B, n_experts, device=scores.device, dtype=scores.dtype)
    counts.scatter_add_(1, idx.reshape(B, L * k),
                        m[:, :, None].expand(B, L, k).reshape(B, L * k))
    f = counts * (n_experts / (k * real))[:, None]
    P = (scores * m[:, :, None]).sum(1) / real[:, None]
    return (f * P).sum()


# ------------------------------------------------------------------- MoE

def grouped_mm(a, b, offs):
    """Per group g of rows [offs[g-1], offs[g]): a 2-D x b 3-D gives each
    group's rows times b[g] (rows past offs[-1] are not written); a 2-D
    transposed (a^T of [rows, n]) x b 2-D gives [G, n, m], each group's
    rows' product. `torch._grouped_mm` on the card; on the CPU the plain
    loop over the groups (its offsets read on the host)."""
    if a.is_cuda:
        return torch._grouped_mm(a, b, offs=offs)
    ends = offs.tolist()
    starts = [0] + ends[:-1]
    if b.dim() == 3:
        out = a.new_zeros(a.shape[0], b.shape[-1])
        for g, (s, e) in enumerate(zip(starts, ends)):
            out[s:e] = a[s:e] @ b[g]
        return out
    return torch.stack([a[:, s:e] @ b[s:e] for s, e in zip(starts, ends)])


class _HeldExperts(torch.autograd.Function):
    """The held experts' part of the MoE output [N, hidden]: u's rows
    gathered in sorted order (`tok`), the gate/up and down grouped GEMMs of
    SwiGLU, then each row's held pairs (`inv`) summed with their top-k
    weights. The kernels (kernels/moe.py) read the held-pair count offs[-1]
    on the device and work on the sorted rows below it alone; the GEMMs
    stop there too. The backward runs the same grouped GEMMs and their
    weight gradients, and gives the weights' gradient in fp32."""

    @staticmethod
    def forward(ctx, u, w13, w2, weights, tok, inv, offs, valid):
        with trace.span("k3m.moe.route"):
            x = moe_gather(u, tok, offs, valid)
        with trace.span("k3m.moe.experts"):
            h = grouped_mm(x, w13, offs)
            y = grouped_mm(swiglu_fwd(h, offs), w2, offs)
        with trace.span("k3m.moe.combine"):
            out = moe_combine_fwd(y, inv, weights, offs)
        ctx.save_for_backward(u, w13, w2, weights, tok, inv, offs, valid, h, y)
        return out

    @staticmethod
    def backward(ctx, dout):
        u, w13, w2, weights, tok, inv, offs, valid, h, y = ctx.saved_tensors
        with trace.span("k3m.moe.combine"):
            dy, dweights = moe_combine_bwd(dout, y, inv, weights, offs)
        with trace.span("k3m.moe.experts"):
            dw2 = grouped_mm(swiglu_fwd(h, offs).t(), dy, offs)
            dh = swiglu_bwd(h, grouped_mm(dy, w2.transpose(1, 2), offs), offs)
            dw13 = grouped_mm(moe_gather(u, tok, offs, valid).t(), dh, offs)
            dx = grouped_mm(dh, w13.transpose(1, 2), offs)
        with trace.span("k3m.moe.route"):
            du = moe_gather_sum(dx, inv, offs, weights.shape[1])
        return du, dw13, dw2, dweights, None, None, None, None


class ExpertBank(nn.Module):
    """The held routed experts' SwiGLU weights as two banks (module
    docstring), fp32, cast to the input's dtype at each use."""

    def __init__(self, n: int, hidden: int, width: int):
        super().__init__()
        self.w13 = nn.Parameter(torch.zeros(n, hidden, 2 * width))
        self.w2 = nn.Parameter(torch.zeros(n, width, hidden))

    def init_drawn(self, generator: torch.Generator, std: float) -> None:
        """Draw both banks ~ N(0, std) from `generator` (init_weights)."""
        for p in (self.w13, self.w2):
            p.copy_(torch.normal(0.0, std, p.shape, generator=generator))


def route(idx, e0: int, e1: int):
    """The sort of the (row, choice) pairs of idx [N, k] by held expert:
    (tok [N k] the row of each sorted pair, inv [N k] each pair's place in
    the sort, offs [E] int32 group ends, valid [N k] the sorted pairs that
    are held, counts [E]); pairs of experts not held sort last."""
    n_held = e1 - e0
    local = idx.reshape(-1) - e0
    key = torch.where((local >= 0) & (local < n_held), local, n_held)
    order = torch.argsort(key, stable=True)
    # a scatter, not bincount, whose output size would need the host
    counts = torch.zeros(n_held + 1, dtype=key.dtype, device=key.device)
    counts = counts.scatter_add_(0, key, torch.ones_like(key))[:n_held]
    offs = torch.cumsum(counts, 0).to(torch.int32)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    valid = torch.arange(order.numel(), device=order.device) < offs[-1]
    return order // idx.shape[1], inv, offs, valid, counts


class MoE(nn.Module):
    """DeepSeekMoE over the held experts (module docstring): `gate` the
    router over all experts, `experts` the held bank, `shared_experts` the
    shared SwiGLU."""

    def __init__(self, cfg: K3MConfig, index: int):
        super().__init__()
        self.index = index
        self.k = cfg.num_experts_per_tok
        self.n_experts = cfg.n_routed_experts
        self.held = cfg.held_experts
        self.alpha = cfg.aux_loss_alpha
        self.gate = _linear(cfg.hidden_size, cfg.n_routed_experts)
        self.experts = ExpertBank(self.held[1] - self.held[0], cfg.hidden_size,
                                  cfg.moe_intermediate_size)
        self.shared_experts = SwiGLU(cfg.hidden_size,
                                     cfg.moe_intermediate_size * cfg.n_shared_experts,
                                     cfg.fused_qkv)

    def forward(self, u, shapes, biases):
        """u [N, hidden] the normed rows of the streams of `shapes` (B, L_i),
        whose key biases are `biases`."""
        with trace.span("k3m.moe.route"):
            scores = torch.softmax(F.linear(u.float(), self.gate.weight.float()), dim=-1)
            weights, idx = torch.topk(scores, self.k, dim=-1, sorted=False)
            tok, inv, offs, valid, counts = route(idx, *self.held)
            trace.count("k3m.moe.expert_rows", counts)
            trace.count("k3m.moe.rows", offs[-1:])
            trace.count("k3m.moe.pairs", tok.numel())
            self._balance(scores, idx, shapes, biases)
        out = _HeldExperts.apply(u, self.experts.w13.to(u.dtype), self.experts.w2.to(u.dtype),
                                 weights, tok, inv, offs, valid)
        with trace.span("k3m.moe.shared"):
            return out + self.shared_experts(u)

    def _balance(self, scores, idx, shapes, biases):
        acc = _balance.get()
        if acc is None or self.alpha <= 0:
            return
        total = 0.0
        for s, i, b in zip(unpack_rows(scores, shapes), unpack_rows(idx, shapes), biases):
            total = total + sequence_balance(s, i, b == 0, self.n_experts)
        entry = acc.setdefault(self.index, [0.0, 0])
        entry[0] = entry[0] + total
        entry[1] += sum(B for B, _ in shapes)


class DeepSeekTextLayer(nn.Module):
    """One pre-norm DeepSeek-V2 layer (module docstring): `index` its place
    in the text stack, which makes it dense or MoE. `x` is one stream [B, L,
    hidden] or `Packed` rows (`bias` then one per stream)."""

    def __init__(self, cfg: K3MConfig, index: int):
        super().__init__()
        dt = compute_dtype(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dt)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dt)
        self.moe = index >= cfg.first_k_dense_replace
        self.mlp = (MoE(cfg, index) if self.moe
                    else SwiGLU(cfg.hidden_size, cfg.intermediate_size, cfg.fused_qkv))

    def forward(self, x, bias, deterministic: bool = True):
        packed = isinstance(x, Packed)
        rows, shapes = (x.rows, x.shapes) if packed else (x.reshape(-1, x.shape[-1]),
                                                          ((x.shape[0], x.shape[1]),))
        biases = bias if packed else (bias,)
        h = rows + self.self_attn(self.input_layernorm(rows), shapes, biases).to(rows.dtype)
        u = self.post_attention_layernorm(h)
        f = self.mlp(u, shapes, biases) if self.moe else self.mlp(u)
        out = h + f.to(h.dtype)
        return Packed(out, shapes) if packed else out.view(x.shape)


class DeepSeekEmbeddings(nn.Module):
    """The token embedding alone (DeepSeek-V2 has no absolute positions,
    token types or embedding norm: rope carries position), in the compute
    dtype; `word_embeddings` is the table K3M's MLM decoder ties to."""
    tp = 1

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, deterministic: bool = True,
                task_ids=None):
        if task_ids is not None:
            raise ValueError("task_specific_tokens is BERT's embedding feature")
        return self.word_embeddings(input_ids).to(self.dtype)


def text_layers(cfg: K3MConfig) -> List[nn.Module]:
    """The DeepSeek-V2 text stack of `cfg`."""
    return [DeepSeekTextLayer(cfg, i) for i in range(cfg.num_hidden_layers)]
