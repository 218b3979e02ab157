"""The least time of the latent attention's kernel instance (#3/#4 with
q.k 192 wide and v 128, k3m_tpu_torch/kernels/attention.py SPLIT_DIMS), and
the recorder of its calls.

lib/bounds.py counts one head width for every product (`_attn_flops`);
here q k^T counts at q's width and P V at v's: the forward's 2 B H Lq Lk
(Dqk + Dv) operations, the backward's 2 B H Lq Lk (3 Dqk + 2 Dv) (S and
dQ, dK at Dqk; dP and dV at Dv), against the bytes of every input read
once and every output written once, at the H100's peaks (lib/bounds.py).

`record()` wraps, while it is open, the fused attention the DeepSeek-V2
block reads (`k3m_tpu_torch.model.deepseek.fused_attention`) and the
attention backward (`k3m_tpu_torch.kernels.attention.attention_bwd`), and
keeps (direction, bound seconds) of each call whose v is narrower than q;
a site that is not there (a program without the block) is left out
(`missing`), and nothing is recorded."""

from __future__ import annotations

import contextlib
import importlib
from typing import List, Tuple

import torch

from benchmark.lib import bounds

# kernel-name patterns of the instance, forward and backward
PATTERNS = (r"attn_fwd_mma_kernel<192\b", r"attn_bwd_(dq|dkv)_mma_kernel<192\b")


def _split(q, v) -> bool:
    return q.shape[-1] != v.shape[-1]


def forward_bound(q, k, v, bias, for_backward: bool) -> float:
    B, Lq, H, dk = q.shape
    Lk, dv = k.shape[1], v.shape[-1]
    out = B * Lq * H * dv * q.element_size() + (4 * B * H * Lq if for_backward else 0)
    flops = 2.0 * B * H * Lq * Lk * (dk + dv)
    return bounds.bound_s(bounds._nbytes(q, k, v, bias) + out, flops, q.dtype)


def backward_bound(q, k, v, bias, out, lse, dout) -> float:
    B, Lq, H, dk = q.shape
    Lk, dv = k.shape[1], v.shape[-1]
    nbytes = bounds._nbytes(q, k, v, bias, out, lse, dout) + bounds._nbytes(q, k, v)
    return bounds.bound_s(nbytes, 2.0 * B * H * Lq * Lk * (3 * dk + 2 * dv), q.dtype)


class Recorder:
    def __init__(self):
        self.calls: List[Tuple[str, float]] = []
        self.missing: List[str] = []


@contextlib.contextmanager
def record():
    rec = Recorder()
    saved = []

    def fwd(orig):
        def call(q, k, v, bias, *args, **kwargs):
            if _split(q, v):
                grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
                rec.calls.append(("forward", forward_bound(q, k, v, bias, grad)))
            return orig(q, k, v, bias, *args, **kwargs)
        return call

    def bwd(orig):
        def call(q, k, v, bias, out, lse, words, dout, *args, **kwargs):
            if _split(q, v):
                rec.calls.append(("backward", backward_bound(q, k, v, bias, out, lse, dout)))
            return orig(q, k, v, bias, out, lse, words, dout, *args, **kwargs)
        return call

    for mod_name, attr, wrap in (("k3m_tpu_torch.model.deepseek", "fused_attention", fwd),
                                 ("k3m_tpu_torch.kernels.attention", "attention_bwd", bwd)):
        try:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
        except (ImportError, AttributeError):
            rec.missing.append(f"{mod_name}.{attr}")
            continue
        wrapper = wrap(orig)
        wrapper.__dict__ = orig.__dict__
        setattr(mod, attr, wrapper)
        saved.append((mod, attr, orig))
    try:
        yield rec
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def experts_bound(rows: float, layers: float, held: int, hidden: int, width: int) -> float:
    """The least time of the held experts' grouped GEMMs over `rows`
    (row, expert) pairs in `layers` MoE layer calls, forward and backward:
    6 hidden width operations a pair forward (gate and up, then down), twice
    that backward (the inputs' and the weights' gradients); bytes: each
    layer's bf16 weight banks read twice and their gradients written once,
    and each pair's rows (in, gate/up, SwiGLU, out) three times."""
    flops = 18.0 * rows * hidden * width
    nbytes = 2 * (3 * layers * held * 3 * hidden * width + 3 * rows * (2 * hidden + 3 * width))
    return bounds.bound_s(nbytes, flops, torch.bfloat16)


def spans_device_seconds(events, names) -> float:
    """Summed device seconds of the kernels launched while a host span of
    `names` was open on the launching thread (each span's torch.profiler
    annotation, matched to the kernel by its runtime call's correlation)."""
    import bisect
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            t0 = float(e["ts"])
            spans.setdefault(e.get("tid"), []).append((t0, t0 + float(e.get("dur", 0.0))))
    merged = {}
    for tid, iv in spans.items():
        out = []
        for s, e in sorted(iv):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        merged[tid] = ([s for s, _ in out], [e for _, e in out])
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    total = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        tid, ts = launch.get(e.get("args", {}).get("correlation"), (None, None))
        if tid not in merged:
            continue
        starts, ends = merged[tid]
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ends[i]:
            total += float(e.get("dur", 0.0)) * 1e-6
    return total
