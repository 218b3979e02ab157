"""The held experts' per-pair kernels of the DeepSeek-V2 MoE
(model/deepseek.py `_HeldExperts`): CUDA kernels (`csrc/moe.cu`) and plain
versions.

The sort of a layer's (row, choice) pairs by held expert (deepseek.py
`route`) gives R = N k sorted rows: the held pairs first, grouped by
expert, n = offs[-1] of them, then the pairs of experts not held. Every
function here reads n from `offs` on the device and works on the sorted
rows p < n alone, so that no count reaches the host:

| function | computes |
| --- | --- |
| `moe_gather` | x[p] = u[tok[p]] |
| `swiglu_fwd` | a[p] = silu(g) up, h[p] = [g \\| up] |
| `swiglu_bwd` | dh[p] = [da up s (1 + g (1 - s)) \\| da silu(g)], s = sigmoid(g) |
| `moe_combine_fwd` | out[m] = sum_j w[m, j] y[inv[m, j]] over row m's held pairs |
| `moe_combine_bwd` | dy[inv[m, j]] = w[m, j] dout[m]; dw[m, j] = dout[m] . y[inv[m, j]] |
| `moe_gather_sum` | du[m] = sum_j dx[inv[m, j]] over row m's held pairs |

A pair is held where its sorted row p < n (dw is 0 for the others).
`moe_gather` alone reads `valid`: it writes a sorted row p < n whose
valid[p] is false as zeros. The rest need no mask, since the experts'
Linears have no bias: such a row's h, a and y are zeros, and so are its
share of the combine, its dh, its dx and its weight's gradient, exactly.
On a card the sorted outputs' rows p >= n are left as `torch.empty` gives
them: neither these kernels nor the grouped GEMMs read them, which
tests/test_torch_moe_kernels.py holds by filling them with NaN. The plain
versions, which run for CPU tensors alone, write zeros there. Arithmetic
in fp32, sorted and token rows in the input's dtype (bf16 on a card), the
weights and their gradient in fp32.
Where the operations these replace kept a tensor in the input's dtype
(silu(g), the weights cast to it, each weighted pair, dout times a weight)
the value is rounded to that dtype there too: the forward gives the
former bits, so that the later layers' routing of near ties stays as it
was. The plain versions are those operations. Each wrapper counts its
kernel launches in `.launches`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from k3m_tpu_torch.kernels import build

MAX_K = 8   # the most pairs a token row has (csrc/moe.cu kMaxK)


def held_rows(offs, rows: int):
    """The mask of the sorted rows p < offs[-1] of `rows` (the held pairs)."""
    return torch.arange(rows, device=offs.device) < offs[-1]


# ------------------------------------------------------ plain versions

def moe_gather_plain(u, tok, offs, valid):
    return torch.where((held_rows(offs, tok.numel()) & valid)[:, None], u[tok], 0)


def swiglu_fwd_plain(h, offs):
    g, up = h.chunk(2, dim=-1)
    return torch.where(held_rows(offs, h.shape[0])[:, None], F.silu(g) * up, 0)


def swiglu_bwd_plain(h, da, offs):
    g, up = h.chunk(2, dim=-1)
    s = torch.sigmoid(g.float())
    dg = (da.float() * up.float() * s * (1 + g.float() * (1 - s))).to(h.dtype)
    dh = torch.cat([dg, da * F.silu(g)], dim=-1)
    return torch.where(held_rows(offs, h.shape[0])[:, None], dh, 0)


def _pairs(y, inv, offs, k):
    """(row m's pairs' sorted rows [N, k, width], held [N, k])."""
    held = held_rows(offs, y.shape[0])[inv].view(-1, k)
    return y[inv].view(held.shape[0], k, -1), held


def moe_combine_fwd_plain(y, inv, weights, offs):
    rows, held = _pairs(y, inv, offs, weights.shape[1])
    return torch.where(held[..., None], rows * weights.to(y.dtype)[..., None], 0).sum(1)


def moe_combine_bwd_plain(dout, y, inv, weights, offs):
    rows, held = _pairs(y, inv, offs, weights.shape[1])
    dw = torch.where(held, (dout.float()[:, None, :] * rows.float()).sum(-1), 0)
    dy = y.new_zeros(y.shape)
    dy[inv] = torch.where(held[..., None], dout[:, None, :] * weights.to(y.dtype)[..., None],
                          0).view(-1, y.shape[1])
    return dy, dw


def moe_gather_sum_plain(dx, inv, offs, k):
    rows, held = _pairs(dx, inv, offs, k)
    return torch.where(held[..., None], rows, 0).sum(1)


# ------------------------------------------------------------ checks

def check_sorted(name, offs, R, device, *index, valid=None):
    """Raise unless 0 < R < 2^31 sorted rows, offs is int32 [groups >= 1],
    each index tensor int64 [R] and valid, where given, bool [R], all
    contiguous on `device`."""
    if not 0 < R < 2 ** 31:
        raise ValueError(f"{name}: {R} sorted rows, not in [1, 2^31)")
    if offs.dtype != torch.int32 or offs.dim() != 1 or offs.numel() < 1:
        raise TypeError(f"{name}: offs must be int32 [groups], got {offs.dtype} "
                        f"{tuple(offs.shape)}")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (R,)):
        raise TypeError(f"{name}: valid must be bool [{R}], got {valid.dtype} "
                        f"{tuple(valid.shape)}")
    for t in index:
        if t.dtype != torch.int64 or t.shape != (R,):
            raise TypeError(f"{name}: indices must be int64 [{R}], got {t.dtype} "
                            f"{tuple(t.shape)}")
    for t in (t for t in (offs, *index, valid) if t is not None):
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name}: offs, valid and indices must be contiguous on "
                             f"{device}")


def check_rows(name, *tensors, dtype=torch.bfloat16):
    """Raise unless each tensor is a contiguous 2-D `dtype` tensor (any
    dtype where `dtype` is None) of whole 16-byte rows, 16-byte aligned, on
    the first one's device."""
    for t in tensors:
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: rows must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous() or t.device != tensors[0].device:
            raise ValueError(f"{name}: rows must be contiguous 2-D tensors on one device")
        if (t.shape[1] * t.element_size()) % 16 or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be whole 16-byte vectors, 16-byte aligned "
                             f"(width {t.shape[1]} of {t.dtype})")


def check_pairs(name, inv, k, weights=None):
    """Raise unless rows have 1 to MAX_K pairs, k of them in each of inv's
    rows, and the weights, where given, are contiguous fp32 [rows, k]."""
    if not 0 < k <= MAX_K or inv.numel() % k:
        raise ValueError(f"{name}: {k} pairs a row of {inv.numel()}, at most {MAX_K}")
    rows = inv.numel() // k
    if weights is not None and (weights.dtype != torch.float32 or weights.shape != (rows, k)
                                or not weights.is_contiguous()):
        raise TypeError(f"{name}: weights must be contiguous fp32 [{rows}, {k}], got "
                        f"{weights.dtype} {tuple(weights.shape)}")


def _cuda(name, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for another device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _vecs(t) -> int:
    return t.shape[1] * t.element_size() // 16


# ---------------------------------------------------------- wrappers

def moe_gather(u, tok, offs, valid):
    """x [R, hidden] = u [N, hidden] at the held sorted rows (module
    docstring); u of any dtype."""
    if not _cuda("moe_gather", u):
        return moe_gather_plain(u, tok, offs, valid)
    check_sorted("moe_gather", offs, tok.numel(), u.device, tok, valid=valid)
    check_rows("moe_gather", u, dtype=None)
    x = torch.empty(tok.numel(), u.shape[1], dtype=u.dtype, device=u.device)
    rc = build.library().k3m_moe_gather(
        u.data_ptr(), tok.data_ptr(), offs.data_ptr(), offs.numel(), valid.data_ptr(),
        x.data_ptr(), x.shape[0], _vecs(x), build.stream_handle(u.device))
    build.check(rc, "k3m_moe_gather")
    moe_gather.launches += 1
    return x


def swiglu_fwd(h, offs):
    """a [R, I] = silu(g) up of h [R, 2 I] = [g | up] at the held sorted rows."""
    if not _cuda("swiglu_fwd", h):
        return swiglu_fwd_plain(h, offs)
    check_sorted("swiglu_fwd", offs, h.shape[0], h.device)
    check_rows("swiglu_fwd", h)
    a = torch.empty(h.shape[0], h.shape[1] // 2, dtype=h.dtype, device=h.device)
    check_rows("swiglu_fwd", a)
    rc = build.library().k3m_moe_swiglu_fwd(
        h.data_ptr(), offs.data_ptr(), offs.numel(), a.data_ptr(), h.shape[0], _vecs(a),
        build.stream_handle(h.device))
    build.check(rc, "k3m_moe_swiglu_fwd")
    swiglu_fwd.launches += 1
    return a


def swiglu_bwd(h, da, offs):
    """dh [R, 2 I], the gradient of SwiGLU's h = [g | up] from da [R, I], at
    the held sorted rows."""
    if not _cuda("swiglu_bwd", h):
        return swiglu_bwd_plain(h, da, offs)
    check_sorted("swiglu_bwd", offs, h.shape[0], h.device)
    da = da.contiguous()
    check_rows("swiglu_bwd", h, da)
    if da.shape != (h.shape[0], h.shape[1] // 2):
        raise ValueError(f"swiglu_bwd: da {tuple(da.shape)} against h {tuple(h.shape)}")
    dh = torch.empty_like(h)
    rc = build.library().k3m_moe_swiglu_bwd(
        h.data_ptr(), da.data_ptr(), offs.data_ptr(), offs.numel(), dh.data_ptr(),
        h.shape[0], _vecs(da), build.stream_handle(h.device))
    build.check(rc, "k3m_moe_swiglu_bwd")
    swiglu_bwd.launches += 1
    return dh


def _combine(name, y, inv, weights, offs, k):
    check_sorted(name, offs, y.shape[0], y.device, inv)
    check_rows(name, y)
    check_pairs(name, inv, k, weights)
    rows = inv.numel() // k
    out = torch.empty(rows, y.shape[1], dtype=y.dtype, device=y.device)
    rc = build.library().k3m_moe_combine_fwd(
        y.data_ptr(), inv.data_ptr(), weights.data_ptr() if weights is not None else None,
        offs.data_ptr(), offs.numel(), out.data_ptr(), y.shape[0], rows, k, _vecs(y),
        build.stream_handle(y.device))
    build.check(rc, "k3m_moe_combine_fwd")
    return out


def moe_combine_fwd(y, inv, weights, offs):
    """out [N, hidden]: each token row's held pairs' rows of y [R, hidden]
    summed with their weights [N, k] (fp32)."""
    if not _cuda("moe_combine_fwd", y):
        return moe_combine_fwd_plain(y, inv, weights, offs)
    out = _combine("moe_combine_fwd", y, inv, weights, offs, weights.shape[1])
    moe_combine_fwd.launches += 1
    return out


def moe_combine_bwd(dout, y, inv, weights, offs):
    """(dy [R, hidden], dw [N, k] fp32): the combine's gradients from dout
    [N, hidden]."""
    if not _cuda("moe_combine_bwd", y):
        return moe_combine_bwd_plain(dout, y, inv, weights, offs)
    check_sorted("moe_combine_bwd", offs, y.shape[0], y.device, inv)
    dout = dout.contiguous()
    check_rows("moe_combine_bwd", y, dout)
    rows, k = weights.shape
    check_pairs("moe_combine_bwd", inv, k, weights)
    if dout.shape != (rows, y.shape[1]):
        raise ValueError(f"moe_combine_bwd: dout {tuple(dout.shape)} against y "
                         f"{tuple(y.shape)} and weights {tuple(weights.shape)}")
    dy = torch.empty_like(y)
    dw = torch.empty(rows, k, dtype=torch.float32, device=y.device)
    rc = build.library().k3m_moe_combine_bwd(
        dout.data_ptr(), y.data_ptr(), inv.data_ptr(), weights.data_ptr(), offs.data_ptr(),
        offs.numel(), dy.data_ptr(), dw.data_ptr(), y.shape[0], rows, k, _vecs(y),
        build.stream_handle(y.device))
    build.check(rc, "k3m_moe_combine_bwd")
    moe_combine_bwd.launches += 1
    return dy, dw


def moe_gather_sum(dx, inv, offs, k):
    """du [N, hidden]: each token row's held pairs' rows of dx [R, hidden]
    summed (the gradient of `moe_gather`'s u), k pairs a row."""
    if not _cuda("moe_gather_sum", dx):
        return moe_gather_sum_plain(dx, inv, offs, k)
    out = _combine("moe_gather_sum", dx, inv, None, offs, k)
    moe_gather_sum.launches += 1
    return out


WRAPPERS = {f.__name__: f for f in (moe_gather, swiglu_fwd, swiglu_bwd, moe_combine_fwd,
                                    moe_combine_bwd, moe_gather_sum)}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


reset_launch_counts()
