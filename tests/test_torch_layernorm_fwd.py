"""The LN forward's two instances (k3m_tpu_torch/kernels/layernorm.py).

On the CPU: `ln_instance` sends every width and view of the shipped
configs' main path and of the DeepSeek-V2 text block's 2048-wide text to
the vector instance, and odd widths and misaligned views to the
per-element one; the CPU wrapper on those odd shapes agrees with the JAX
package's Pallas kernel in interpret mode. On the card (`cuda` marker,
skipped without one): both instances against the plain version at the
vector instance's edges, and the vector instance alone on rows of 1,025
to 2,048 columns, twice bit for bit, with both launch counters. JAX is imported inside the one test that needs it, so
that the card's host, which has no JAX, runs the rest:

    python -m pytest tests/test_torch_layernorm_fwd.py -q --noconftest
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from k3m_tpu_torch.kernels import fused_layernorm
from k3m_tpu_torch.kernels.layernorm import (
    MAX_N, MAX_VEC_N, _forward, _plain_fwd, ln_instance,
)
from k3m_tpu_torch.model.layers import Packed

CONFIGS = Path(__file__).resolve().parents[1] / "k3m_tpu_torch" / "configs"
BENCH_CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"
SHIPPED = ("bert_base_6layer_6conect.json", "k3m_roberta_base.json")
DTYPES = (torch.float32, torch.bfloat16)


def _instance(*tensors):
    """The instance the wrapper picks for rows of these tensors' width."""
    ptrs = 0
    for t in tensors:
        if t is not None:
            ptrs |= t.data_ptr()
    return ln_instance(tensors[0].shape[-1], ptrs)


def _widths(name):
    cfg = json.loads((CONFIGS / name).read_text())
    return cfg["hidden_size"], cfg["v_hidden_size"]


@pytest.mark.parametrize("config", SHIPPED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_shipped_widths_take_the_vector_instance(config, dtype):
    for n in _widths(config):
        x = torch.zeros(96 * 50, n, dtype=dtype)
        res = torch.zeros(96 * 50, n, dtype=dtype)
        out = torch.empty_like(x)
        p = torch.ones(n)
        assert _instance(x, res, out, p, p) == "vector"
        assert _instance(x, None, out, p, p) == "vector"


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_text_rows_take_the_vector_instance(dtype):
    """The DeepSeek-V2 text block's 2048-wide text (its co-attention's and
    heads' LayerNorms), packed and unpacked, takes the vector instance: the
    per-element one stops at MAX_N columns."""
    n = json.loads((BENCH_CONFIGS / "k3m_deepseek_v2_lite-ep8.json").read_text())["hidden_size"]
    assert MAX_N < n <= MAX_VEC_N
    packed = Packed.pack([torch.zeros(2, L, n, dtype=dtype) for L in (50, 256, 50, 256)])
    p = torch.ones(n)
    assert _instance(packed.rows, packed.rows, p, p) == "vector"
    for view in packed.unpack():
        assert _instance(view, None, p, p) == "vector"


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_and_unpacked_views_take_the_vector_instance(dtype):
    """The packed text rows of packed_passes ([t, pv, t, pv]), each stream's
    view of them (Packed.unpack), and both halves of the image stack
    (img2.chunk(2), model/encoder.py) start at whole rows, so on 16-byte
    boundaries."""
    B = 3
    streams = [torch.zeros(B, L, 768, dtype=dtype) for L in (50, 256, 50, 256)]
    packed = Packed.pack(streams)
    p768 = torch.ones(768)
    assert _instance(packed.rows, packed.rows, p768, p768) == "vector"
    for view in packed.unpack():
        assert view.is_contiguous()
        assert _instance(view, view, p768, p768) == "vector"
    img2 = torch.zeros(2 * B, 37, 1024, dtype=dtype)
    p1024 = torch.ones(1024)
    for half in img2.chunk(2):
        assert _instance(half, half, p1024, p1024) == "vector"


@pytest.mark.parametrize("n", [100, 4, 12, 770, 1020])
def test_odd_widths_take_the_per_element_instance(n):
    for dtype in DTYPES:
        x = torch.zeros(7, n, dtype=dtype)
        assert _instance(x, x, torch.ones(n), torch.ones(n)) == "per_element"


@pytest.mark.parametrize("dtype,offset,want", [
    (torch.bfloat16, 1, "per_element"),     # 2 bytes off
    (torch.bfloat16, 4, "per_element"),     # 8 bytes off
    (torch.bfloat16, 8, "vector"),          # 16 bytes off: aligned again
    (torch.float32, 1, "per_element"),      # 4 bytes off
    (torch.float32, 2, "per_element"),      # 8 bytes off
    (torch.float32, 4, "vector"),
])
def test_views_off_a_16_byte_boundary_take_the_per_element_instance(dtype, offset, want):
    n = 768
    base = torch.zeros(5 * n + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    view = base[offset:offset + 5 * n].view(5, n)
    aligned = torch.zeros(5, n, dtype=dtype)
    p = torch.ones(n)
    assert _instance(view, aligned, p, p) == want          # x off
    assert _instance(aligned, view, p, p) == want          # the residual off


def test_cpu_tensors_count_no_launch_of_either_instance():
    x = torch.randn(3, 100)
    p = torch.ones(100)
    launches = (fused_layernorm.launches, fused_layernorm.per_element_launches)
    out = fused_layernorm(x, p, p)
    torch.testing.assert_close(out, _plain_fwd(x, p, p, None, 1e-12, x.dtype)[0])
    assert (fused_layernorm.launches, fused_layernorm.per_element_launches) == launches


@pytest.mark.parametrize("n,offset,with_res", [(100, 0, True), (100, 0, False),
                                               (768, 1, True), (1024, 3, False)])
def test_per_element_shapes_match_pallas(n, offset, with_res):
    """The shapes only the per-element instance takes, through the CPU
    wrapper (x a view `offset` elements into its storage) against the JAX
    package's Pallas kernel in interpret mode on the same numpy arrays."""
    import jax.numpy as jnp

    from k3m_tpu.kernels.layernorm import fused_layernorm as jax_layernorm
    rng = np.random.default_rng(n + offset)
    flat = (rng.standard_normal(6 * n + offset) * 2 + 1).astype(np.float32)
    x = flat[offset:].reshape(6, n)
    res = rng.standard_normal((6, n)).astype(np.float32) if with_res else None
    scale = rng.standard_normal(n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    xt = torch.from_numpy(flat)[offset:].view(6, n)
    rt = None if res is None else torch.from_numpy(res)
    out, rstd = _forward(xt, torch.from_numpy(scale), torch.from_numpy(bias), rt, 1e-12,
                         torch.float32, True)
    ref = jax_layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                        None if res is None else jnp.asarray(res), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    xf = x + (res if with_res else 0.0)
    want_rstd = 1.0 / np.sqrt(((xf - xf.mean(-1, keepdims=True)) ** 2).mean(-1) + 1e-12)
    np.testing.assert_allclose(rstd.numpy(), want_rstd, rtol=1e-5)


# ---------------------------------------------------------------- on the card

EDGES = [(1, 768), (1, 1024), (4099, 768), (200, 1024), (77, 8), (77, 520), (77, 1016)]
WIDE = [(1, 2048), (4099, 2048), (77, 1032), (77, 2040)]   # the vector instance alone


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _hold(x, s, b, res, od, design):
    """One instance against the plain version: the output within a share of
    its scale (2e-5 in fp32, 2^-6 in bf16), the fp32 rstd within 1e-5 of
    each value, and a second call bit for bit the first."""
    got = _forward(x, s, b, res, 1e-12, od, True, design)
    again = _forward(x, s, b, res, 1e-12, od, True, design)
    want = _plain_fwd(x, s, b, res, 1e-12, od)
    share = 2e-5 if od == torch.float32 else 2.0 ** -6
    tol = share * max(1.0, float(want[0].float().abs().max()))
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0, atol=tol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", EDGES)
@pytest.mark.parametrize("xd,rd,od", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16), (torch.bfloat16, None, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32), (torch.float32, torch.bfloat16, torch.bfloat16),
])
def test_cuda_both_instances_match_plain_at_the_edges(cuda_device, rows, n, xd, rd, od):
    g = torch.Generator(device=cuda_device).manual_seed(rows * n)
    x = (torch.randn(rows, n, generator=g, device=cuda_device) * 2 + 1).to(xd)
    res = None if rd is None else torch.randn(rows, n, generator=g, device=cuda_device).to(rd)
    s = torch.randn(n, generator=g, device=cuda_device)
    b = torch.randn(n, generator=g, device=cuda_device)
    fused_layernorm.launches = fused_layernorm.per_element_launches = 0
    _hold(x, s, b, res, od, None)                     # the wrapper's pick: vector
    assert (fused_layernorm.launches, fused_layernorm.per_element_launches) == (2, 0)
    _hold(x, s, b, res, od, "per_element")
    assert (fused_layernorm.launches, fused_layernorm.per_element_launches) == (4, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(100, 0), (768, 1), (1024, 1)])
def test_cuda_odd_shapes_take_the_per_element_instance(cuda_device, n, offset):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    flat = torch.randn(9 * n + offset, generator=g, device=cuda_device).to(torch.bfloat16)
    x = flat[offset:].view(9, n)
    s = torch.randn(n, generator=g, device=cuda_device)
    fused_layernorm.launches = fused_layernorm.per_element_launches = 0
    _hold(x, s, s, x, torch.bfloat16, None)
    assert (fused_layernorm.launches, fused_layernorm.per_element_launches) == (2, 2)
    with pytest.raises(RuntimeError, match="vector instance"):
        _forward(x, s, s, x, 1e-12, torch.bfloat16, False, "vector")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", WIDE)
@pytest.mark.parametrize("xd,rd,od", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16), (torch.bfloat16, None, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32), (torch.float32, torch.bfloat16, torch.bfloat16),
])
def test_cuda_wide_rows_take_the_vector_instance(cuda_device, rows, n, xd, rd, od):
    """Rows of 1,025 to 2,048 columns: the vector instance's wide kernel
    against the plain version as at the edges above; the per-element
    instance refuses them."""
    g = torch.Generator(device=cuda_device).manual_seed(rows * n)
    x = (torch.randn(rows, n, generator=g, device=cuda_device) * 2 + 1).to(xd)
    res = None if rd is None else torch.randn(rows, n, generator=g, device=cuda_device).to(rd)
    s = torch.randn(n, generator=g, device=cuda_device)
    b = torch.randn(n, generator=g, device=cuda_device)
    fused_layernorm.launches = fused_layernorm.per_element_launches = 0
    _hold(x, s, b, res, od, None)
    assert (fused_layernorm.launches, fused_layernorm.per_element_launches) == (2, 0)
    with pytest.raises(ValueError, match="need the vector instance"):
        _forward(x, s, b, res, 1e-12, od, True, "per_element")
