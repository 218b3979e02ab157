"""The model's weights, made by the benchmark from the seed on the card.

The port's initialisation scheme (Linear and Embedding weights ~ N(0,
std), Linear biases 0, LayerNorm scale 1 and bias 0, the MLM decoder's
bias 0) with the benchmark's own draws: one `torch.randn` call on the
model's device, from a generator seeded with the run's seed, fills every
Linear and Embedding weight in the order of their sorted parameter names.
The program and the reference take the same names, so the same seed gives
both sides the same weights; the reference draws them again itself.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn


def drawn_weights(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(name, parameter) of every Linear and Embedding weight, sorted by name."""
    out = []
    for mname, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            out.append((f"{mname}.weight" if mname else "weight", m.weight))
    return sorted(out, key=lambda t: t[0])


def fill_weights(model: nn.Module, seed: int, std: float) -> Dict[str, int]:
    """Fill `model` in place (module docstring); returns {name: numel} of the
    drawn weights. The other parameters keep their constructed values (ones
    and zeros); every Linear bias is zeroed."""
    named = drawn_weights(model)
    device = named[0][1].device
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(std)
    with torch.no_grad():
        off = 0
        for _, p in named:
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n
        for m in model.modules():
            if isinstance(m, nn.Linear) and m.bias is not None:
                m.bias.zero_()
    del flat
    return {name: p.numel() for name, p in named}


def initial_leaf(seed: int, std: float, model: nn.Module, names) -> Dict[str, torch.Tensor]:
    """The initial values of the named parameters of `model` (the drawn
    weights as `fill_weights` drew them, the rest as constructed: zeros for
    biases, ones for LayerNorm scales), drawn again on the model's device."""
    drawn = drawn_weights(model)
    device = drawn[0][1].device
    total = sum(p.numel() for _, p in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(std)
    offsets, off = {}, 0
    for name, p in drawn:
        offsets[name] = (off, p.numel(), p.shape)
        off += p.numel()
    params = dict(model.named_parameters())
    out = {}
    for name in names:
        if name in offsets:
            o, n, shape = offsets[name]
            out[name] = flat[o:o + n].view(shape).clone()
        elif _is_ln_scale(model, name):
            out[name] = torch.ones_like(params[name], dtype=torch.float32)
        else:
            out[name] = torch.zeros_like(params[name], dtype=torch.float32)
    return out


def _is_ln_scale(model: nn.Module, name: str) -> bool:
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    return leaf == "weight" and not isinstance(mod, (nn.Linear, nn.Embedding))
