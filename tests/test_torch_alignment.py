"""The port's K3MForItemAlignment end to end against the JAX package's,
in fp32 on the CPU, with the same weights and the same numpy pair batch,
and the weight bridge against the JAX package's own converter.

Tolerance 1e-4 relative / 1e-5 absolute: fp32 on both sides through a few
dozen layers whose sums run in another order.
"""

import jax
import numpy as np
import pytest
import torch

from k3m_tpu.model.alignment import K3MForItemAlignment as JaxAlignment
from k3m_tpu.train.alignment_loop import device_item
from k3m_tpu.train.convert import _flatten, flat_to_reference
from k3m_tpu_torch.config import K3MConfig as TorchConfig
from k3m_tpu_torch.convert import from_jax_params
from k3m_tpu_torch.model.alignment import K3MForItemAlignment, build_model
from k3m_tpu_torch.train.alignment_loop import batch_to_device, forward
from tests.conftest import MICRO, make_pretrain_batch

TOL = dict(rtol=1e-4, atol=1e-5)


def pair_batch(cfg, B=4):
    """A pair batch with ragged masks; item 0 of the first tower has no pv
    pairs, so the structure aggregator's zero-pair path runs."""
    items = []
    for seed in (1, 2):
        it = device_item(make_pretrain_batch(cfg, B=B, L=8, Lpv=12, R=4, P=3,
                                             seed=seed))
        rng = np.random.default_rng(seed + 10)
        for key, n in (("input_mask", 8), ("input_mask_pv", 12), ("image_mask", 5)):
            for b in range(1, B):
                it[key][b, n - rng.integers(1, n // 2):] = 0
        items.append(it)
    items[0]["index_p"][0] = 0
    items[0]["index_v"][0] = 0
    return dict(label=(np.arange(B) % 2).astype(np.float32),
                item1=items[0], item2=items[1])


def jax_params(cfg, batch):
    model = JaxAlignment(cfg)
    params = model.init({"params": jax.random.PRNGKey(0),
                         "gumbel": jax.random.PRNGKey(1)},
                        batch["label"], batch["item1"], batch["item2"],
                        deterministic=True)
    # redraw every leaf so biases and LayerNorm parameters are non-trivial
    rng = np.random.default_rng(3)

    def draw(path, x):
        if x.ndim == 2:
            return (rng.standard_normal(x.shape) / np.sqrt(x.shape[0])).astype(np.float32)
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return model, jax.tree_util.tree_map_with_path(draw, params)


def port_model(cfg, params):
    model = K3MForItemAlignment(TorchConfig.from_dict(cfg.to_dict()))
    flat = {k: np.asarray(v) for k, v in _flatten(params["params"]).items()}
    model.load_state_dict(from_jax_params(flat), strict=True)
    return model.eval()


@pytest.mark.parametrize("loss_type,shared_prefix", [
    ("ce", False), ("ce", True), ("inner", False), ("inner", True),
    ("cosine", False), ("cosine", True),
])
def test_item_alignment_matches_jax(loss_type, shared_prefix):
    # MICRO: t_biattention_id=(1,), so shared_prefix shares text layer 0
    cfg = MICRO.replace(loss_type=loss_type, shared_prefix=shared_prefix)
    batch = pair_batch(cfg)
    jm, params = jax_params(cfg, batch)
    ref = jm.apply(params, batch["label"], batch["item1"], batch["item2"],
                   deterministic=True)
    got = forward(port_model(cfg, params), batch_to_device(batch, "cpu"))
    for name, g, r in zip(("emb1", "emb2", "probs", "loss"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_fix_reference_bugs_cosine_matches_jax():
    cfg = MICRO.replace(loss_type="cosine", fix_reference_bugs=True,
                        if_pre_sampling=2)
    batch = pair_batch(cfg)
    jm, params = jax_params(cfg, batch)
    ref = jm.apply(params, batch["label"], batch["item1"], batch["item2"],
                   deterministic=True)
    got = forward(port_model(cfg, params), batch_to_device(batch, "cpu"))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_weight_bridge_agrees_with_flat_to_reference():
    """from_jax_params gives the JAX converter's names and values, and
    they cover the port's model exactly (strict load)."""
    cfg = MICRO.replace(loss_type="ce", dynamic_attention=True)
    batch = pair_batch(cfg)
    _, params = jax_params(cfg, batch)
    flat = {k: np.asarray(v) for k, v in _flatten(params["params"]).items()}
    mine = from_jax_params(flat)
    theirs = flat_to_reference(flat)
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    model = K3MForItemAlignment(TorchConfig.from_dict(cfg.to_dict()))
    model.load_state_dict(mine, strict=True)


def test_from_jax_params_refuses_unknown_paths():
    with pytest.raises(KeyError):
        from_jax_params({"trunk/encoder/no_such_layer/kernel": np.zeros((2, 2))})


def test_reference_bin_loads(tmp_path):
    """A reference-style .bin (bare names plus the dead poolers and q_dense
    weights) loads strictly into the port's model, every weight set."""
    from k3m_tpu_torch.convert import load_pretrained
    tcfg = TorchConfig.from_dict(MICRO.replace(loss_type="ce").to_dict())
    want = K3MForItemAlignment(tcfg).state_dict()
    sd = {f"bert.{k}" if k.startswith(("embeddings", "encoder")) else k: v.clone()
          for k, v in want.items()}
    sd["t_pooler.dense.weight"] = torch.zeros(2, 2)
    sd["encoder.c_layer.0.biOutput.q_dense1.weight"] = torch.zeros(2, 2)
    torch.save(sd, tmp_path / "ref.bin")
    model = K3MForItemAlignment(tcfg)
    assert load_pretrained(model, str(tmp_path / "ref.bin"), strict=True) == set(want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(TorchConfig.from_dict(MICRO.to_dict()))


def test_random_init_is_seeded():
    cfg = TorchConfig.from_dict(MICRO.to_dict())
    a = build_model(cfg, seed=5, device="cpu").state_dict()
    b = build_model(cfg, seed=5, device="cpu").state_dict()
    c = build_model(cfg, seed=6, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layer.0.attention.self.query.weight"],
                           c["encoder.layer.0.attention.self.query.weight"])


def test_bf16_compute_runs_on_cpu():
    """The bf16 compute dtype (--bf16) runs through the plain versions and
    stays close to fp32 on the same weights."""
    cfg = TorchConfig.from_dict(MICRO.replace(loss_type="ce").to_dict())
    batch = batch_to_device(pair_batch(MICRO), "cpu")
    f32 = forward(build_model(cfg, seed=1, device="cpu"), batch)
    bf16 = forward(build_model(cfg.replace(dtype="bfloat16"), seed=1, device="cpu"), batch)
    np.testing.assert_allclose(bf16[2].float().numpy(), f32[2].numpy(), atol=2e-2)
