"""RoI feature pooling: RoIPool and RoIAlign in plain tensor code.

Counterpart of k3m_tpu/vision/roi.py (which replaces detectron2's CUDA ops
behind py-bottom-up-attention's `_shared_roi_transform`, reference
data_prepare.py:203-209). There is no torchvision here or on the card, and
the JAX package computes both outside any Pallas kernel, so both are
gathers and reductions over the feature map.

Both take a batch of maps [B, C, H, W] and boxes [B, N, 4] (XYXY, image
coordinates) and give [B, N, C, P, P]. Internally the map is read
channels-last, so that a gathered cell is one contiguous C-vector.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch


def _chunk(chunk: Optional[int]) -> int:
    """RoIs per gather window: `chunk`, else K3M_ROI_CHUNK (default 32),
    read at each call; 0 or less pools every RoI in one window."""
    return int(os.environ.get("K3M_ROI_CHUNK", "32")) if chunk is None else chunk


def _spans(n: int, chunk: int):
    step = n if chunk <= 0 else chunk
    return [(s, min(s + step, n)) for s in range(0, n, max(step, 1))]


def _bilinear_sample(flat: torch.Tensor, bidx: torch.Tensor, H: int, W: int,
                     y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """flat [B*H*W, C] (channels-last map); bidx, y, x of one shape ->
    [..., C], as the JAX package's _bilinear_sample: four clipped corner
    reads, zero outside [-1, H] x [-1, W] (detectron2's boundary rule: the
    boundaries themselves sample)."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1, x1 = y0 + 1, x0 + 1
    wy1 = y - y0
    wx1 = x - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1

    def get(yy, xx):
        yy = yy.clamp(0, H - 1).to(torch.int64)
        xx = xx.clamp(0, W - 1).to(torch.int64)
        return flat.index_select(0, ((bidx * H + yy) * W + xx).reshape(-1)
                                 ).view(*y.shape, flat.shape[1])

    inside = ((y >= -1.0) & (y <= H) & (x >= -1.0) & (x <= W))[..., None]
    out = (get(y0, x0) * (wy0 * wx0)[..., None]
           + get(y0, x1) * (wy0 * wx1)[..., None]
           + get(y1, x0) * (wy1 * wx0)[..., None]
           + get(y1, x1) * (wy1 * wx1)[..., None])
    return torch.where(inside, out, 0.0)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
              output_size: int = 14, sampling_ratio: int = 2,
              aligned: bool = True, chunk: Optional[int] = None) -> torch.Tensor:
    """RoIAlign (V2 when aligned): feat [B, C, H, W], boxes [B, N, 4] XYXY
    image coordinates -> [B, N, C, output_size, output_size]. The samples
    of `chunk` RoIs are gathered at a time (`roi_pool` says how it is
    resolved); the per-RoI arithmetic is the JAX package's."""
    B, C, H, W = feat.shape
    N, P, s = boxes.shape[1], output_size, sampling_ratio
    flat = feat.permute(0, 2, 3, 1).reshape(B * H * W, C)
    offset = 0.5 if aligned else 0.0
    b = (boxes * spatial_scale - offset).reshape(B * N, 4)
    bidx = torch.arange(B, device=feat.device).repeat_interleave(N)
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    roi_w = torch.clamp(x2 - x1, min=1e-6 if aligned else 1.0)
    roi_h = torch.clamp(y2 - y1, min=1e-6 if aligned else 1.0)
    bin_w = roi_w / P
    bin_h = roi_h / P
    # sample grid: P*s points per axis, centred in sub-bins (bin units)
    grid = (torch.arange(P * s, device=feat.device, dtype=feat.dtype) + 0.5) / s
    ys = y1[:, None] + grid[None, :] * bin_h[:, None]          # [B*N, P*s]
    xs = x1[:, None] + grid[None, :] * bin_w[:, None]
    out = feat.new_empty(B * N, C, P, P)
    for lo, hi in _spans(B * N, _chunk(chunk)):
        n = hi - lo
        yy = ys[lo:hi, :, None].expand(n, P * s, P * s)
        xx = xs[lo:hi, None, :].expand(n, P * s, P * s)
        bb = bidx[lo:hi, None, None].expand(n, P * s, P * s)
        samples = _bilinear_sample(flat, bb, H, W, yy, xx)    # [n, Ps, Ps, C]
        pooled = samples.view(n, P, s, P, s, C).mean(dim=(2, 4))
        out[lo:hi] = pooled.permute(0, 3, 1, 2)
    return out.view(B, N, C, P, P)


def roi_pool(feat: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
             output_size: int = 14, chunk: Optional[int] = None) -> torch.Tensor:
    """Max RoIPool with the exact caffe/torchvision quantized semantics
    (the pooler of the reference's caffe-trained C4 head):

      x1q = round(x1*scale); x2q = round(x2*scale)
      w = max(x2q - x1q + 1, 1)
      wstart = clamp(floor(pw*w/P) + x1q, 0, W)
      wend   = clamp(ceil((pw+1)*w/P) + x1q, 0, W)
      out = max over the integer cells in the bin; empty bin -> 0

    in exact integer arithmetic, as the JAX package computes it. feat
    [B, C, H, W], boxes [B, N, 4] -> [B, N, C, P, P].

    Each bin reads a fixed Ky x Kx window (K = ceil(extent/P) + 2, at most
    the extent) masked to [start, end), the JAX formulation: a
    [P, Ky, P, Kx, C] gather per RoI, 28 MB at a 38x63x1024 fp32 map. The
    RoIs are pooled `chunk` at a time (K3M_ROI_CHUNK, default 32, read at
    each call), which bounds the live window at chunk x that size: one
    window of all 4 x 300 RoIs of a batch would be ~34 GB. Max is exact, so
    the chunk changes no bit of the result."""
    B, C, H, W = feat.shape
    N, P = boxes.shape[1], output_size
    flat = feat.permute(0, 2, 3, 1).reshape(B * H * W, C)
    # std::round is half away from zero; the coordinates are non-negative,
    # so floor(v + 0.5) is the C++ rounding
    q = torch.floor(boxes * spatial_scale + 0.5).to(torch.int64).reshape(B * N, 4)
    bidx = torch.arange(B, device=feat.device).repeat_interleave(N)
    x1, y1, x2, y2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    roi_w = torch.clamp(x2 - x1 + 1, min=1)
    roi_h = torch.clamp(y2 - y1 + 1, min=1)
    p = torch.arange(P, device=feat.device)
    # [B*N, P] integer bin bounds in map cells, clamped to the map
    hstart = ((p[None, :] * roi_h[:, None]) // P + y1[:, None]).clamp(0, H)
    hend = (-((-(p[None, :] + 1) * roi_h[:, None]) // P) + y1[:, None]).clamp(0, H)
    wstart = ((p[None, :] * roi_w[:, None]) // P + x1[:, None]).clamp(0, W)
    wend = (-((-(p[None, :] + 1) * roi_w[:, None]) // P) + x1[:, None]).clamp(0, W)
    Ky = min(-(-H // P) + 2, H)
    Kx = min(-(-W // P) + 2, W)
    ky = torch.arange(Ky, device=feat.device)
    kx = torch.arange(Kx, device=feat.device)
    out = feat.new_empty(B * N, C, P, P)
    for lo, hi in _spans(B * N, _chunk(chunk)):
        n = hi - lo
        yy = hstart[lo:hi, :, None] + ky                     # [n, P, Ky]
        xx = wstart[lo:hi, :, None] + kx                     # [n, P, Kx]
        ym = yy < hend[lo:hi, :, None]
        xm = xx < wend[lo:hi, :, None]
        row = (bidx[lo:hi, None, None] * H + yy.clamp(0, H - 1)) * W   # [n, P, Ky]
        lin = row[:, :, :, None, None] + xx.clamp(0, W - 1)[:, None, None, :, :]
        cells = flat.index_select(0, lin.reshape(-1)).view(n, P, Ky, P, Kx, C)
        mask = ym[:, :, :, None, None] & xm[:, None, None, :, :]
        pooled = cells.masked_fill_(~mask[..., None], -math.inf).amax(dim=(2, 4))
        # caffe: a bin with no cells pools to 0
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
        out[lo:hi] = pooled.permute(0, 3, 1, 2)
    return out.view(B, N, C, P, P)
