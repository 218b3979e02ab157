"""The port's model modules (k3m_tpu_torch/model) against their JAX
counterparts, in fp32 on the CPU, on the same numpy inputs and the same
weights (carried by `k3m_tpu_torch.convert.from_jax_params`).

The weights are redrawn with numpy after the JAX init so that every bias
and LayerNorm parameter is non-trivial. Tolerance 2e-5: fp32 on both sides,
the same arithmetic summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k3m_tpu.model import coattention as jco
from k3m_tpu.model import fusion as jfu
from k3m_tpu.model import layers as jly
from k3m_tpu.model import structure as jst
from k3m_tpu.train.convert import _flatten
from k3m_tpu_torch.config import K3MConfig as TorchConfig
from k3m_tpu_torch.convert import from_jax_params
from k3m_tpu_torch.model import coattention as tco
from k3m_tpu_torch.model import fusion as tfu
from k3m_tpu_torch.model import layers as tly
from k3m_tpu_torch.model import structure as tst
from tests.conftest import MICRO, NANO

TOL = dict(rtol=2e-5, atol=2e-5)


def torch_config(cfg):
    return TorchConfig.from_dict(cfg.to_dict())


def redraw(params, seed):
    """Flax params with every leaf redrawn from numpy: kernels ~ N(0, 1/fan_in),
    LayerNorm scales ~ 1 + N(0, 0.1^2), other vectors ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if x.ndim == 2:
            return (rng.standard_normal(x.shape) / np.sqrt(x.shape[0])).astype(np.float32)
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, params)


def port_module(module, params, prefix, torch_prefix):
    """Load flax `params` of one JAX module into the port's `module`: the
    flat paths get the prefix they have inside the full model, go through
    from_jax_params, and lose the torch prefix of that position."""
    flat = {f"{prefix}{k}": np.asarray(v) for k, v in _flatten(params).items()}
    sd = {k[len(torch_prefix):]: v for k, v in from_jax_params(flat).items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def bias_pair(rng, B, L):
    """A ragged {0,1} mask -> (JAX [B,1,1,L] bias, port [B, L] bias)."""
    mask = np.ones((B, L), np.float32)
    for b in range(B):
        mask[b, L - rng.integers(0, L // 2 + 1):] = 0
    j = jly.mask_to_bias(jnp.asarray(mask))
    return mask, j, tly.mask_to_bias(torch.from_numpy(mask))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_mask_to_bias_matches():
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    close(tly.mask_to_bias(torch.from_numpy(mask)),
          jly.mask_to_bias(jnp.asarray(mask))[:, 0, 0, :])


@pytest.mark.parametrize("model", ["bert", "roberta"])
def test_bert_embeddings_match(model):
    cfg = MICRO.replace(model=model, fix_reference_bugs=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    seg = rng.integers(0, 2, (2, 9)).astype(np.int32)
    table = normal(rng, cfg.vocab_size, cfg.hidden_size)
    jm = jly.BertEmbeddings(cfg)
    p = redraw(jm.init(jax.random.PRNGKey(0), ids, seg, table,
                       deterministic=True)["params"], 1)
    ref = jm.apply({"params": p}, ids, seg, table, deterministic=True)
    tm = tly.BertEmbeddings(torch_config(cfg))
    flat = {f"trunk/embeddings/{k}": np.asarray(v) for k, v in _flatten(p).items()}
    flat["trunk/word_embeddings"] = table
    sd = {k[len("embeddings."):]: v for k, v in from_jax_params(flat).items()}
    tm.load_state_dict(sd, strict=True)
    close(tm(torch.from_numpy(ids).long(), torch.from_numpy(seg).long()), ref)


def test_image_embeddings_match():
    cfg = MICRO
    rng = np.random.default_rng(1)
    feat, loc = normal(rng, 3, 5, cfg.v_feature_size), normal(rng, 3, 5, 5)
    jm = jly.ImageEmbeddings(cfg)
    p = redraw(jm.init(jax.random.PRNGKey(0), feat, loc, deterministic=True)["params"], 2)
    tm = port_module(tly.ImageEmbeddings(torch_config(cfg)), p,
                     "trunk/v_embeddings/", "v_embeddings.")
    close(tm(torch.from_numpy(feat), torch.from_numpy(loc)),
          jm.apply({"params": p}, feat, loc, deterministic=True))


def test_text_layer_matches():
    cfg = MICRO
    rng = np.random.default_rng(2)
    x = normal(rng, 3, 11, cfg.hidden_size)
    _, jb, tb = bias_pair(rng, 3, 11)
    jm = jly.TextLayer(cfg)
    p = redraw(jm.init(jax.random.PRNGKey(0), x, jb, True)["params"], 3)
    tm = port_module(tly.TextLayer(torch_config(cfg)), p,
                     "trunk/encoder/layer_0/", "encoder.layer.0.")
    close(tm(torch.from_numpy(x), tb), jm.apply({"params": p}, x, jb, True))


@pytest.mark.parametrize("dynamic", [False, True])
def test_image_layer_matches(dynamic):
    cfg = MICRO.replace(dynamic_attention=dynamic)
    rng = np.random.default_rng(3)
    x = normal(rng, 3, 5, cfg.v_hidden_size)
    _, jb, tb = bias_pair(rng, 3, 5)
    txt = normal(rng, 3, 7, cfg.hidden_size)
    tmask, _, _ = bias_pair(rng, 3, 7)
    m2 = tmask[:, :, None]
    jm = jly.ImageLayer(cfg)
    p = redraw(jm.init(jax.random.PRNGKey(0), x, jb, txt, m2, True)["params"], 4)
    tm = port_module(tly.ImageLayer(torch_config(cfg)), p,
                     "trunk/encoder/v_layer_0/", "encoder.v_layer.0.")
    got = tm(torch.from_numpy(x), tb, torch.from_numpy(txt), torch.from_numpy(m2))
    close(got, jm.apply({"params": p}, x, jb, txt, m2, True))


@pytest.mark.parametrize("two_text", [False, True])
def test_connection_layers_match(two_text):
    cfg = MICRO
    rng = np.random.default_rng(4)
    L1, L2 = 6, 9
    size1 = cfg.hidden_size if two_text else cfg.v_hidden_size
    x1, x2 = normal(rng, 2, L1, size1), normal(rng, 2, L2, cfg.hidden_size)
    _, jb1, tb1 = bias_pair(rng, 2, L1)
    _, jb2, tb2 = bias_pair(rng, 2, L2)
    jm = (jco.ConnectionLayerTwoText if two_text else jco.ConnectionLayer)(cfg)
    p = redraw(jm.init(jax.random.PRNGKey(0), x1, jb1, x2, jb2, True)["params"], 5)
    stack = "c_layer_pv_t" if two_text else "c_layer"
    tm = port_module((tco.ConnectionLayerTwoText if two_text else tco.ConnectionLayer)(
        torch_config(cfg)), p, f"trunk/encoder/{stack}_0/", f"encoder.{stack}.0.")
    o1, o2 = tm(torch.from_numpy(x1), tb1, torch.from_numpy(x2), tb2)
    r1, r2 = jm.apply({"params": p}, x1, jb1, x2, jb2, True)
    close(o1, r1)
    close(o2, r2)


def test_biattention_direction_order():
    """ctx1 = stream-2 queries over stream 1, ctx2 = stream-1 queries over
    stream 2, each with its key stream's bias."""
    cfg = MICRO
    rng = np.random.default_rng(5)
    x1, x2 = normal(rng, 2, 4, 16), normal(rng, 2, 7, 16)
    _, jb1, tb1 = bias_pair(rng, 2, 4)
    _, jb2, tb2 = bias_pair(rng, 2, 7)
    jm = jco.BiAttention(cfg, 16, 16, 16, 2, 0.0, 0.0)
    p = redraw(jm.init(jax.random.PRNGKey(0), x1, jb1, x2, jb2,
                       deterministic=True)["params"], 6)
    tm = tco.BiAttention(16, 16, 16, 2)
    flat = {f"trunk/encoder/c_layer_0/biattention/{k}": np.asarray(v)
            for k, v in _flatten(p).items()}
    prefix = "encoder.c_layer.0.biattention."
    tm.load_state_dict({k[len(prefix):]: v for k, v in from_jax_params(flat).items()},
                       strict=True)
    c1, c2 = tm(torch.from_numpy(x1), tb1, torch.from_numpy(x2), tb2)
    r1, r2 = jm.apply({"params": p}, x1, jb1, x2, jb2, deterministic=True)
    assert c1.shape == (2, 7, 16) and c2.shape == (2, 4, 16)
    close(c1, r1)
    close(c2, r2)


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_fusion_block_matches(strategy):
    cfg = MICRO.replace(if_pre_sampling=strategy)
    rng = np.random.default_rng(6)
    B, L, Lpv, R = 2, 5, 8, 4
    H, V = cfg.hidden_size, cfg.bi_hidden_size
    inputs = [normal(rng, B, L, H), normal(rng, B, R, V), normal(rng, B, Lpv, H),
              normal(rng, B, R, V), normal(rng, B, L, H), normal(rng, B, Lpv, H),
              normal(rng, B, L, H), normal(rng, B, Lpv, H), normal(rng, B, R, V)]
    noise = None
    if strategy == 1:
        # replayed Gumbel noise, as the reference draws it in eval mode
        noise = {m: -np.log(-np.log(rng.uniform(1e-6, 1.0, (B, n, 3, s)))).astype(np.float32)
                 for m, n, s in (("v", R, V), ("t", L, H), ("pv", Lpv, H))}
    jm = jfu.FusionBlock(cfg)
    p = redraw(jm.init(jax.random.PRNGKey(0), *inputs, deterministic=True)["params"], 7)
    tm = port_module(tfu.FusionBlock(torch_config(cfg)), p, "trunk/fusion/", "")
    for gn in ([None, noise] if strategy == 1 else [None]):
        ref = jm.apply({"params": p}, *inputs, deterministic=True, gumbel_noise=gn)
        got = tm(*map(torch.from_numpy, inputs), deterministic=True,
                 gumbel_noise=None if gn is None else
                 {k: torch.from_numpy(v) for k, v in gn.items()})
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            close(g, r)


@pytest.mark.parametrize("fix_bugs", [False, True])
def test_structure_aggregator_matches(fix_bugs):
    """Items 0 and 2 have no pv pairs: without the fix item 0 falls back to
    c_initial[0] and item 2 reuses item 1's aggregate (the reference's
    stale `t`)."""
    cfg = NANO.replace(fix_reference_bugs=fix_bugs)
    rng = np.random.default_rng(7)
    B, Lpv, P, H = 5, 12, 4, cfg.hidden_size
    c0, seq = normal(rng, B, H), normal(rng, B, Lpv, H)
    index_p = rng.integers(1, Lpv, (B, P, 2)).astype(np.int32)
    index_v = rng.integers(1, Lpv, (B, P, 2)).astype(np.int32)
    index_p[:, 3] = 0
    index_v[:, 3] = 0
    for b in (0, 2):
        index_p[b] = 0
        index_v[b] = 0
    jm = jst.StructureAggregator(cfg, with_lpm=False)
    p = redraw(jm.init(jax.random.PRNGKey(0), c0, seq, index_p, index_v)["params"], 8)
    tm = port_module(tst.StructureAggregator(torch_config(cfg)), p, "structure/", "")
    got, none = tm(*(torch.from_numpy(a) for a in (c0, seq)),
                   torch.from_numpy(index_p).long(), torch.from_numpy(index_v).long())
    ref, _ = jm.apply({"params": p}, c0, seq, index_p, index_v)
    assert none is None
    close(got, ref)
