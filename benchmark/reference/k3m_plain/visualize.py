"""Attention-map collection (`config.visualization`).

Port of k3m_tpu/model/visualize.py. The reference's attention classes
return their probabilities when `config.visualization` is set
(vilbert_k3m.py:423, 466-475 self-attention, :625-634 image, :826-838 and
:953-965 co-attention); the JAX package sows them into its
"intermediates" collection. Here every attention site of a model under
`visualization` runs the unfused attention (model/layers.py
`unfused_attention`) and, while `forward_with_attention` runs the model,
records its post-dropout probabilities under the site's module path in
the model (its state-dict prefix, e.g. `encoder.layer.0.attention.self`):

  self-attention sites   `attention_probs`, [B, H, Lq, Lk]
  co-attention sites     `attn1`, [B, H, L2, L1] (stream-2 queries over
                         stream 1) and `attn2` (the reverse), the
                         reference's attn_data keys (:829-838)

one tensor per invocation of the site, in pass order (a text layer that
all three passes run records one map per pass).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Tuple

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("k3m_attention_maps", default=None)


def record(module, name: str, probs) -> None:
    """Keep `probs` of the attention site `module` under `name`, where
    `forward_with_attention` is running the model that holds it."""
    active = _ACTIVE.get()
    if active is None:
        return
    paths, maps = active
    maps.setdefault(paths[id(module)], {}).setdefault(name, []).append(probs)


def forward_with_attention(model, *args, **kwargs) -> Tuple[Any, Dict]:
    """(outputs of `model(*args, **kwargs)`, maps): maps is {site path:
    {name: (probs of each invocation, ...)}}. Raises unless the model's
    config has `visualization` set: no site records anything otherwise."""
    cfg = getattr(model, "cfg", None)
    if cfg is None or not cfg.visualization:
        raise ValueError("forward_with_attention requires config.visualization=True "
                         "(no attention probs are recorded otherwise)")
    with collecting(model) as maps:
        out = model(*args, **kwargs)
    return out, {path: {name: tuple(v) for name, v in sites.items()}
                 for path, sites in maps.items()}


@contextlib.contextmanager
def collecting(model):
    """Record the attention maps of `model`'s sites while the enclosed code
    runs, into the dict it yields ({site path: {name: [probs, ...]}}):
    empty where no site runs under `visualization`."""
    maps: Dict[str, Dict[str, list]] = {}
    token = _ACTIVE.set(({id(m): name for name, m in model.named_modules()}, maps))
    try:
        yield maps
    finally:
        _ACTIVE.reset(token)


def flatten_attention(maps: Dict) -> Dict[str, Any]:
    """{'<site path>/<name>': probs}, a site invoked more than once
    expanded as '<site path>/<name>/<i>' in pass order (as the JAX
    package's flatten_attention expands a sown tuple)."""
    flat: Dict[str, Any] = {}
    for path, sites in maps.items():
        for name, probs in sites.items():
            if len(probs) == 1:
                flat[f"{path}/{name}"] = probs[0]
            else:
                for i, p in enumerate(probs):
                    flat[f"{path}/{name}/{i}"] = p
    return flat
