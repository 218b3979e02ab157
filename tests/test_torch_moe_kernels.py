"""The held experts' per-pair kernels of the DeepSeek-V2 MoE
(kernels/moe.py) and `_HeldExperts` (model/deepseek.py) built on them.

On the CPU, at tests/test_torch_deepseek.py's widths (hidden 64, experts
of width 24, 8 experts, top 3) in fp32: `_HeldExperts`' output and its
gradients for u, the two expert banks and the top-k weights against the
formulation the layer had before the kernels (every (row, choice) pair
gathered, masked by `where`, SwiGLU on the halves, the pairs put back in
row order and summed with the held pairs' weights; autograd for its
gradients), within 1e-5 of each tensor's scale (plus 1e-7): the two differ
by the order of fp32 sums alone. Cases: a held range of 2 of 8 experts,
every expert held, no pair held (n = 0), one expert taking every held
pair, and `valid` cleared for the first held expert's rows (the
benchmark's planted fault). Also the operand checks, the capacity counter
and its reader.

On the card (tests marked `cuda`, which skip without one), in bf16 at the
DeepSeek-V2-Lite cell's shapes (N 9,792 rows, top 6 of 64 experts, hidden
2,048, experts of 1,408, 8 held) and at the same edge cases: each kernel
against its plain version on the held sorted rows and on every token row,
its launch count, and the whole `_HeldExperts` forward and backward
against the same function on the plain versions, and again with the rows
past the held pairs filled with NaN (no kernel and no grouped GEMM reads
them); a MoE layer's forward and backward under
`torch.cuda.set_sync_debug_mode("error")`. The gather and
the pairs' rows of dy are copies and products of one rounding, held bit for
bit; the rest within 2^-7 of each element (one bf16 ulp, where an fp32 sum
in another order or a contracted multiply-add rounds the other way) plus
1e-3 of the tensor's largest magnitude (SwiGLU's gradient cancels where 1 +
g (1 - s) crosses zero); the weights' fp32 gradient within 1e-4; the
layer's tensors within 2^-6 of their largest magnitude. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_moe_kernels.py -q --noconftest
"""

import pytest
import torch
import torch.nn.functional as F

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.kernels import moe
from k3m_tpu_torch.model import deepseek as ds
from k3m_tpu_torch.utils import trace

CASES = ("range", "every", "none", "one", "dropped")
PLAIN = dict(moe_gather=moe.moe_gather_plain, swiglu_fwd=moe.swiglu_fwd_plain,
             swiglu_bwd=moe.swiglu_bwd_plain, moe_combine_fwd=moe.moe_combine_fwd_plain,
             moe_combine_bwd=moe.moe_combine_bwd_plain,
             moe_gather_sum=moe.moe_gather_sum_plain)


def _choose(g, pool, rows, k):
    """[rows, k] distinct experts a row, drawn from the 1-D `pool`."""
    return pool[torch.rand(rows, pool.numel(), generator=g).argsort(-1)[:, :k]]


def case_routes(case, N, E, k, held, seed=0):
    """(idx [N, k], held range, route's five outputs) of a case (module
    docstring); on the CPU, moved to the caller's device by `to`."""
    g = torch.Generator().manual_seed(seed)
    if case == "every":
        held = (0, E)
    e0, e1 = held
    outside = torch.tensor([e for e in range(E) if not e0 <= e < e1])
    if case == "none":
        idx = _choose(g, outside, N, k)
    elif case == "one":
        idx = torch.cat([torch.full((N, 1), e0), _choose(g, outside, N, k - 1)], dim=1)
    else:
        idx = _choose(g, torch.arange(E), N, k)
    tok, inv, offs, valid, counts = ds.route(idx, e0, e1)
    if case == "dropped":
        valid = valid & (torch.arange(valid.numel()) >= offs[0])
    return idx, held, (tok, inv, offs, valid, counts)


def former_held_experts(u, w13, w2, weights, idx, held, tok, inv, offs, valid):
    """The layer's held-expert part as it was computed before the kernels."""
    N, H = u.shape
    k = idx.shape[1]
    h = torch.where(valid[:, None], ds.grouped_mm(u[tok], w13, offs), 0)
    g, up = h.chunk(2, dim=-1)
    y = torch.where(valid[:, None], ds.grouped_mm(F.silu(g) * up, w2, offs), 0)
    pairs = y[inv].view(N, k, H)
    mask = (idx >= held[0]) & (idx < held[1])
    return (pairs * torch.where(mask, weights, 0)[:, :, None]).sum(1)


def _grads(out, inputs, dout):
    got = torch.autograd.grad(out, inputs, dout, allow_unused=True)
    return [torch.zeros_like(t) if d is None else d for t, d in zip(inputs, got)]


def _close(got, want, share=1e-5, floor=1e-7):
    got, want = got.detach().float(), want.detach().float()
    tol = share * float(want.abs().max()) + floor
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


def _operands(N, E_held, k, H, I, device, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(N, H, generator=g)
    w13 = 0.2 * torch.randn(E_held, H, 2 * I, generator=g)
    w2 = 0.2 * torch.randn(E_held, I, H, generator=g)
    weights = torch.rand(N, k, generator=g)
    dout = torch.randn(N, H, generator=g)
    return [t.to(device=device, dtype=dtype if t is not weights else torch.float32)
            for t in (u, w13, w2, weights, dout)]


@pytest.mark.parametrize("case", CASES)
def test_held_experts_match_the_former_formulation(case):
    """Output and the gradients of u, w13, w2 and the top-k weights (module
    docstring), on the CPU in fp32."""
    N, E, k, H, I = 37, 8, 3, 64, 24
    idx, held, (tok, inv, offs, valid, _) = case_routes(case, N, E, k, (2, 4))
    n = int(offs[-1])
    assert n == {"every": N * k, "none": 0, "one": N}.get(case, n)
    u, w13, w2, weights, dout = _operands(N, held[1] - held[0], k, H, I, "cpu",
                                          torch.float32)
    inputs = [t.requires_grad_(True) for t in (u, w13, w2, weights)]
    out = ds._HeldExperts.apply(*inputs, tok, inv, offs, valid)
    want = former_held_experts(*inputs, idx, held, tok, inv, offs, valid)
    _close(out, want)
    for got, ref in zip(_grads(out, inputs, dout), _grads(want, inputs, dout)):
        _close(got, ref)
    if case == "none":
        assert float(out.detach().abs().max()) == 0
    if case == "dropped":
        assert bool(valid[:n].any()) and not bool(valid[:int(offs[0])].any())


def test_plain_versions_leave_rows_past_the_held_pairs_zero():
    """The plain versions write zeros at sorted rows p >= n, the gather also
    at rows p < n whose `valid` is false, and each token row sums its held
    pairs (p < n) only."""
    idx, held, (tok, inv, offs, valid, _) = case_routes("dropped", 11, 8, 3, (2, 4))
    n, first = int(offs[-1]), int(offs[0])
    R = valid.numel()
    assert 0 < first < n < R
    u, h, y = torch.randn(11, 16), torch.randn(R, 32), torch.randn(R, 16)
    past = torch.arange(R) >= n
    x = moe.moe_gather(u, tok, offs, valid)
    assert float(x[~valid | past].abs().max()) == 0
    torch.testing.assert_close(x[first:n], u[tok[first:n]])
    for sorted_out in (moe.swiglu_fwd(h, offs), moe.swiglu_bwd(h, h[:, :16], offs)):
        assert float(sorted_out[past].abs().max()) == 0
        assert bool((sorted_out[:n] != 0).any(-1).all())
    w = torch.rand(11, 3)
    live = (inv.view(11, 3) < n).float()
    want = ((w * live)[..., None] * y[inv].view(11, 3, 16)).sum(1)
    torch.testing.assert_close(moe.moe_combine_fwd(y, inv, w, offs), want)
    torch.testing.assert_close(moe.moe_gather_sum(y, inv, offs, 3),
                               (live[..., None] * y[inv].view(11, 3, 16)).sum(1))
    dy, dw = moe.moe_combine_bwd(u, y, inv, w, offs)
    assert float(dy[past].abs().max()) == 0
    torch.testing.assert_close(dw, live * (u[:, None, :] * y[inv].view(11, 3, 16)).sum(-1))


def test_operand_checks_refuse_what_the_kernels_do_not_take():
    R, cpu = 12, torch.device("cpu")
    offs = torch.tensor([3, 5], dtype=torch.int32)
    valid = torch.ones(R, dtype=torch.bool)
    tok = torch.zeros(R, dtype=torch.int64)
    moe.check_sorted("t", offs, R, cpu, tok, valid=valid)
    moe.check_sorted("t", offs, R, cpu)
    with pytest.raises(ValueError, match="sorted rows"):
        moe.check_sorted("t", offs, 0, cpu)
    with pytest.raises(TypeError, match="offs must be int32"):
        moe.check_sorted("t", offs.long(), R, cpu, tok)
    with pytest.raises(TypeError, match="valid must be bool"):
        moe.check_sorted("t", offs, R, cpu, tok, valid=valid.int())
    with pytest.raises(TypeError, match="indices must be int64"):
        moe.check_sorted("t", offs, R, cpu, tok[:-1])
    with pytest.raises(ValueError, match="contiguous on"):
        moe.check_sorted("t", offs, R, cpu, torch.zeros(2 * R, dtype=torch.int64)[::2])
    rows = torch.zeros(R, 16, dtype=torch.bfloat16)
    moe.check_rows("t", rows)
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        moe.check_rows("t", rows.float())
    with pytest.raises(ValueError, match="whole 16-byte vectors"):
        moe.check_rows("t", rows[:, :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        moe.check_rows("t", rows.t())
    inv = torch.zeros(12, dtype=torch.int64)
    moe.check_pairs("t", inv, 3, torch.zeros(4, 3))
    moe.check_pairs("t", inv, 6)
    with pytest.raises(TypeError, match="fp32"):
        moe.check_pairs("t", inv, 3, torch.zeros(4, 3, dtype=torch.float64))
    with pytest.raises(TypeError, match="fp32"):
        moe.check_pairs("t", inv, 3, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="at most 8"):
        moe.check_pairs("t", torch.zeros(18, dtype=torch.int64), 9)
    with pytest.raises(ValueError, match="at most 8"):
        moe.check_pairs("t", inv, 5)


def test_pairs_counter_reads_the_capacity_once_per_recording():
    """While recording, each MoE layer call adds its sort's capacity (every
    (row, choice) pair) to `k3m.moe.pairs` beside the held pairs of
    `k3m.moe.rows`; the recorder reads both at its end. Off, nothing is
    kept."""
    cfg = K3MConfig(text_block="deepseek_v2", hidden_size=64, num_attention_heads=4,
                    moe_intermediate_size=24, n_routed_experts=8, num_experts_per_tok=3,
                    n_shared_experts=1, experts_held=(2, 4), aux_loss_alpha=0.001)
    layer = ds.MoE(cfg, 1)
    shapes = ((3, 7), (3, 5))
    biases = tuple(torch.zeros(*shape) for shape in shapes)
    u = torch.randn(3 * 7 + 3 * 5, 64, generator=torch.Generator().manual_seed(0))
    with trace.recording() as rec:
        layer(u, shapes, biases)
        layer(u, shapes, biases)
    pairs = rec.counts["k3m.moe.pairs"]
    assert pairs == [2 * u.shape[0] * 3]
    assert 0 < rec.counts["k3m.moe.rows"][0] < pairs[0]
    layer(u, shapes, biases)
    assert rec.counts["k3m.moe.pairs"] == pairs


def test_rows_skipped_share_reader():
    """`moe.rows_skipped_share.dsv2` is 100 (1 - rows / pairs) over the
    traced segment's counters, and nothing where the program kept no
    capacity counter or no segment."""
    from types import SimpleNamespace
    from benchmark.metrics import moe_rows_skipped_share_dsv2 as reader
    seg = dict(n_steps=2, events=[], counts={"k3m.moe.rows": [14688],
                                             "k3m.moe.pairs": [117504]})
    assert reader.read(SimpleNamespace(moe_trace=seg)) == pytest.approx(87.5)
    del seg["counts"]["k3m.moe.pairs"]
    assert reader.read(SimpleNamespace(moe_trace=seg)) is None
    assert reader.read(SimpleNamespace()) is None


# ------------------------------------------------------------ the card

CELL = dict(N=9792, E=64, k=6, H=2048, I=1408, held=(0, 8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _near(got, want, share=2.0 ** -7, floor=1e-3):
    """|got - want| within `share` of |want| plus `floor` of want's scale."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max()) if want.numel() else 0.0
    bad = (got - want).abs() > share * want.abs() + floor * scale
    assert not bool(bad.any()), (int(bad.sum()), float((got - want).abs().max()), scale)


def _cell_routes(case, device):
    c = CELL
    idx, held, route = case_routes(case, c["N"], c["E"], c["k"], c["held"])
    return idx.to(device), held, [t.to(device) for t in route]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_moe_kernels_match_plain(cuda_device, case):
    """Each of the six kernels against its plain version on the card, in
    bf16 at the cell's shapes, on the held sorted rows (the rows below n)
    and on every token row; one launch each."""
    c = CELL
    _, held, (tok, inv, offs, valid, _) = _cell_routes(case, cuda_device)
    R, n = valid.numel(), int(offs[-1])
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(torch.bfloat16)

    u, h, da, y = rand(c["N"], c["H"]), rand(R, 2 * c["I"]), rand(R, c["I"]), rand(R, c["H"])
    dout = rand(c["N"], c["H"])
    weights = torch.rand(c["N"], c["k"], generator=g, device=cuda_device)
    moe.reset_launch_counts()
    assert torch.equal(moe.moe_gather(u, tok, offs, valid)[:n],
                       moe.moe_gather_plain(u, tok, offs, valid)[:n])
    _near(moe.swiglu_fwd(h, offs)[:n], moe.swiglu_fwd_plain(h, offs)[:n])
    _near(moe.swiglu_bwd(h, da, offs)[:n], moe.swiglu_bwd_plain(h, da, offs)[:n])
    _near(moe.moe_combine_fwd(y, inv, weights, offs),
          moe.moe_combine_fwd_plain(y, inv, weights, offs))
    dy, dw = moe.moe_combine_bwd(dout, y, inv, weights, offs)
    want_dy, want_dw = moe.moe_combine_bwd_plain(dout, y, inv, weights, offs)
    assert torch.equal(dy[:n], want_dy[:n])
    _near(dw, want_dw, share=1e-4, floor=1e-4)
    _near(moe.moe_gather_sum(y, inv, offs, c["k"]),
          moe.moe_gather_sum_plain(y, inv, offs, c["k"]))
    torch.cuda.synchronize()
    assert moe.launch_counts() == {name: 1 for name in moe.WRAPPERS}
    if case == "none":
        assert n == 0 and float(dw.abs().max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_held_experts_match_the_plain_path(cuda_device, case, monkeypatch):
    """The whole `_HeldExperts` forward and backward on the kernels against
    the same function on the plain versions (the grouped GEMMs on the card
    in both), in bf16 at the cell's shapes."""
    c = CELL
    _, held, (tok, inv, offs, valid, _) = _cell_routes(case, cuda_device)
    u, w13, w2, weights, dout = _operands(c["N"], held[1] - held[0], c["k"], c["H"], c["I"],
                                          cuda_device, torch.bfloat16)
    u = u.requires_grad_(True)
    weights = weights.requires_grad_(True)
    w13 = (w13 / 8).requires_grad_(True)
    w2 = (w2 / 8).requires_grad_(True)
    inputs = [u, w13, w2, weights]

    def run():
        out = ds._HeldExperts.apply(*inputs, tok, inv, offs, valid)
        return [out.detach()] + list(torch.autograd.grad(out, inputs, dout))

    moe.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert moe.launch_counts() == dict(moe_gather=2, swiglu_fwd=2, swiglu_bwd=1,
                                       moe_combine_fwd=1, moe_combine_bwd=1, moe_gather_sum=1)
    with monkeypatch.context() as m:
        for name, fn in PLAIN.items():
            m.setattr(ds, name, fn)
        want = run()
    for a, b in zip(got, want):
        _near(a, b, share=0.0, floor=2.0 ** -6)
    if case == "none":
        assert all(float(t.abs().max()) == 0 for t in got)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("range", "every", "dropped"))
def test_cuda_held_experts_never_read_rows_past_the_held_pairs(cuda_device, case, monkeypatch):
    """`_HeldExperts` at the cell's shapes with every sorted row at or past
    n poisoned: NaN fills each floating tensor that `torch.empty` or
    `torch.empty_like` gives while it runs (the kernels' outputs, whose rows
    past n they leave as they find them) and those rows of each grouped
    GEMM's [R, width] output (`torch._grouped_mm` does not write them).
    Output and every gradient stay finite and equal to an unpoisoned run's,
    bit for bit: neither the kernels nor the grouped GEMMs, forward or
    weight gradients, read a row past the held pairs."""
    c = CELL
    _, held, (tok, inv, offs, valid, _) = _cell_routes(case, cuda_device)
    R, n = valid.numel(), int(offs[-1])
    u, w13, w2, weights, dout = _operands(c["N"], held[1] - held[0], c["k"], c["H"], c["I"],
                                          cuda_device, torch.bfloat16)
    inputs = [u.requires_grad_(True), (w13 / 8).requires_grad_(True),
              (w2 / 8).requires_grad_(True), weights.requires_grad_(True)]

    def run():
        out = ds._HeldExperts.apply(*inputs, tok, inv, offs, valid)
        return [out.detach()] + list(torch.autograd.grad(out, inputs, dout))

    want = run()
    empty, empty_like, grouped_mm, swiglu = (torch.empty, torch.empty_like, ds.grouped_mm,
                                            ds.swiglu_fwd)

    def nan(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t

    def poisoned_mm(a, b, offs):
        out = grouped_mm(a, b, offs)
        if out.dim() == 2 and out.shape[0] == R:
            out[n:] = float("nan")
        return out

    seen = []

    def spied_swiglu(h, offs):
        a = swiglu(h, offs)
        seen.append((bool(h[n:].isnan().all()), bool(a[n:].isnan().all())))
        return a

    with monkeypatch.context() as m:
        m.setattr(torch, "empty", lambda *a, **kw: nan(empty(*a, **kw)))
        m.setattr(torch, "empty_like", lambda *a, **kw: nan(empty_like(*a, **kw)))
        m.setattr(ds, "grouped_mm", poisoned_mm)
        m.setattr(ds, "swiglu_fwd", spied_swiglu)
        got = run()
    torch.cuda.synchronize()
    assert seen == [(True, True)] * 2    # both of its calls saw the poison
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a.float()).all())
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_moe_layer_adds_no_host_sync(cuda_device):
    """A MoE layer at the cell's widths, its balance sums collected, runs
    its forward and backward with no host sync."""
    c = CELL
    cfg = K3MConfig(text_block="deepseek_v2", hidden_size=c["H"], num_attention_heads=16,
                    moe_intermediate_size=c["I"], n_routed_experts=c["E"],
                    num_experts_per_tok=c["k"], n_shared_experts=2, experts_held=c["held"],
                    aux_loss_alpha=0.001)
    layer = ds.MoE(cfg, 1).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g, device=cuda_device))
    shapes = ((16, 612),)
    u = torch.randn(c["N"], c["H"], generator=g, device=cuda_device).to(torch.bfloat16)
    u.requires_grad_(True)
    biases = (torch.zeros(16, 612, device=cuda_device),)
    layer(u, shapes, biases)        # warm-up: the library's first load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with ds.balance_loss() as acc:
            out = layer(u, shapes, biases)
        (out.float().sum() + sum(s for s, _ in acc.values())).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert u.grad is not None and bool(torch.isfinite(u.grad.float()).all())
