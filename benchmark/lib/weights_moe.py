"""lib/weights.py's weights from the seed for a model whose routed experts
are weight banks (the DeepSeek-V2 text block's `mlp.experts.w13` and
`.w2`): the same single `torch.randn` call on the model's device, from a
generator seeded with the run's seed, fills every Linear and Embedding
weight and every expert bank, in the order of their sorted names; Linear
biases are zeroed and the other parameters keep their constructed values
(RMSNorm and LayerNorm scales one, biases zero). The program and the
reference take the same names, so the same seed gives both sides the same
weights."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from benchmark.lib import weights

BANKS = ("experts.w13", "experts.w2")


def drawn_weights(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(name, parameter) of every Linear and Embedding weight and expert
    bank, sorted by name."""
    out = weights.drawn_weights(model)
    out += [(n, p) for n, p in model.named_parameters() if n.endswith(BANKS)]
    return sorted(out, key=lambda t: t[0])


def _flat(named, seed: int, std: float, device):
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    return flat.mul_(std)


def fill_weights(model: nn.Module, seed: int, std: float) -> Dict[str, int]:
    """Fill `model` in place (module docstring); returns {name: numel}."""
    named = drawn_weights(model)
    flat = _flat(named, seed, std, named[0][1].device)
    with torch.no_grad():
        off = 0
        for _, p in named:
            p.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()
        for m in model.modules():
            if isinstance(m, nn.Linear) and m.bias is not None:
                m.bias.zero_()
    del flat
    return {name: p.numel() for name, p in named}


def initial_leaf(seed: int, std: float, model: nn.Module, names) -> Dict[str, torch.Tensor]:
    """The initial values of the named parameters, as `fill_weights` made
    them, drawn again on the model's device."""
    drawn = drawn_weights(model)
    flat = _flat(drawn, seed, std, drawn[0][1].device)
    offsets, off = {}, 0
    for name, p in drawn:
        offsets[name] = (off, p)
        off += p.numel()
    params = dict(model.named_parameters())
    out = {}
    for name in names:
        if name in offsets:
            o, p = offsets[name]
            out[name] = flat[o:o + p.numel()].view(p.shape).clone()
        elif weights._is_ln_scale(model, name):
            out[name] = torch.ones_like(params[name], dtype=torch.float32)
        else:
            out[name] = torch.zeros_like(params[name], dtype=torch.float32)
    return out
