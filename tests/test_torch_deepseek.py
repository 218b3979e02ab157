"""The DeepSeek-V2 text block (model/deepseek.py) against its plain fp32
reference (k3m_tpu_torch/reference/deepseek_v2.py), on the CPU at a small
width: hidden 64, 4 heads of q.k 16 + 8 and v 16, latent 32, 8 routed
experts of width 24 with top 3, 4 held, 1 shared expert.

On the CPU the port runs its kernels' plain versions and the grouped GEMMs
as loops, in fp32: the two sides differ by the order of fp32 sums alone.
Tolerances: 1e-5 of each tensor's largest magnitude (plus 1e-7) on a
layer's output and gradients, which a few hundred fp32 sums stay far
inside; 1e-4 relative on the whole model's losses and 1e-4 of each
gradient's scale over K3M's dozens of layers (the tolerance of
tests/test_torch_pretrain_model.py), plus 1e-6 for the gradients of near
zero scale, where the fp32 sums' rounding of the larger terms upstream
(up to ~30 in the losses) is all that is left. Also: the held shares add up to the
uncut layer, two data ranks on gloo equal one process on the global batch,
the default configs build exactly the BERT block, tensor parallelism is
refused, and the spans' counters.
"""

import math
import os
import traceback

import numpy as np
import pytest
import torch

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model import deepseek as ds
from k3m_tpu_torch.model.layers import BertEmbeddings, Packed, TextLayer
from k3m_tpu_torch.model.pretrain import K3MForPretraining
from k3m_tpu_torch.model.random import StepRandom
from k3m_tpu_torch.reference import deepseek_v2 as ref
from k3m_tpu_torch.train import dist as train_dist
from k3m_tpu_torch.train import mesh
from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
from k3m_tpu_torch.utils import trace
from tests.test_torch_dist import CFG, GROUP_TIMEOUT_S, SEED, pretrain_batch, rows, spawn_world

YARN = dict(type="yarn", factor=40, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
SMALL = dict(text_block="deepseek_v2", hidden_size=64, num_attention_heads=4,
             intermediate_size=96, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, moe_intermediate_size=24, n_routed_experts=8,
             num_experts_per_tok=3, n_shared_experts=1, experts_held=(0, 4),
             rope_scaling=YARN, aux_loss_alpha=0.01)


def port_config(**kw):
    return K3MConfig(**dict(SMALL, **kw))


def ref_config(**kw):
    return ref.DeepSeekV2Config.from_dict(dict(SMALL, **kw))


def _close(got, want, share=1e-5, floor=1e-7):
    tol = share * float(want.abs().max()) + floor
    err = float((got.detach() - want.detach()).abs().max())
    assert err <= tol, (err, tol)


def _pair(index, fused, seed=0, **kw):
    """A port layer and a reference layer with the same random weights."""
    port = ds.DeepSeekTextLayer(port_config(fused_qkv=fused, **kw), index)
    plain = ref.DeepSeekV2Layer(ref_config(**kw), index)
    g = torch.Generator().manual_seed(seed)
    sd = {k: 0.2 * torch.randn(v.shape, generator=g) for k, v in port.state_dict().items()}
    port.load_state_dict(sd)
    plain.load_state_dict(sd)
    return port, plain


def _streams(seed=1):
    g = torch.Generator().manual_seed(seed)
    x1, x2 = torch.randn(3, 7, 64, generator=g), torch.randn(3, 5, 64, generator=g)
    b1, b2 = torch.zeros(3, 7), torch.zeros(3, 5)
    b1[1, 5:] = b2[2, 3:] = -10000.0
    return [x1, x2], (b1, b2)


def test_yarn_frequencies_and_scale():
    """The port's YaRN frequencies equal the reference's; at the published
    settings the ramp runs from pair 10 (theta kept up to it) to pair 23
    (theta / 40 from it), and the scale is m^2 / sqrt(192), m = 1.2608."""
    cfg = K3MConfig(text_block="deepseek_v2", rope_scaling=YARN)
    inv, scale = ds.yarn_inv_freq(cfg)
    rinv, rscale = ref.yarn(ref.DeepSeekV2Config(rope_scaling=YARN))
    torch.testing.assert_close(inv.double(), rinv, rtol=1e-6, atol=0)
    assert math.isclose(scale, rscale, rel_tol=1e-12)
    theta = 10000.0 ** (-torch.arange(32, dtype=torch.float64) / 32)
    torch.testing.assert_close(rinv[:11], theta[:11])
    torch.testing.assert_close(rinv[23:], theta[23:] / 40)
    assert bool(((rinv[11:23] < theta[11:23]) & (rinv[11:23] > theta[11:23] / 40)).all())
    m = 0.1 * 0.707 * math.log(40) + 1
    assert math.isclose(scale, m * m / math.sqrt(192)) and abs(m - 1.2608) < 1e-4


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("index", [0, 1], ids=["dense", "moe"])
def test_layer_forward_backward_matches_reference(index, fused):
    """MLA (with the kernel wrappers' plain path and YaRN) and the dense
    SwiGLU or the held-share MoE, over packed rows of two streams with
    padding: the output, the input's gradient and every parameter's."""
    port, plain = _pair(index, fused)
    xs, biases = _streams()
    p = Packed.pack(xs)
    xa = p.rows.clone().requires_grad_(True)
    xb = p.rows.clone().requires_grad_(True)
    out = port(Packed(xa, p.shapes), biases).rows
    want = plain(Packed(xb, p.shapes), biases).rows
    _close(out, want)
    dout = torch.randn_like(out)
    out.backward(dout)
    want.backward(dout)
    _close(xa.grad, xb.grad)
    grads = dict(plain.named_parameters())
    for name, param in port.named_parameters():
        assert param.grad is not None, name
        _close(param.grad, grads[name].grad)


def test_single_stream_equals_packed_stream():
    """A stream [B, L, H] through the layer gives what its rows give packed."""
    port, _ = _pair(1, True)
    xs, biases = _streams()
    whole = port(xs[0], biases[0])
    packed = port(Packed.pack(xs[:1]), biases[:1]).rows
    torch.testing.assert_close(whole.reshape(-1, 64), packed)


def test_balance_loss_matches_reference():
    g = torch.Generator().manual_seed(2)
    scores = torch.softmax(torch.randn(3, 9, 8, generator=g), dim=-1)
    idx = torch.topk(scores, 3, dim=-1).indices
    mask = torch.ones(3, 9, dtype=torch.bool)
    mask[1, 6:] = mask[2, 2:] = False
    torch.testing.assert_close(ds.sequence_balance(scores, idx, mask, 8),
                               ref.sequence_balance(scores, idx, mask, 8))


def test_layer_balance_terms_match_reference():
    """Each MoE call's balance sum and sequence count, as the pretraining
    model collects them, equal the reference layer's."""
    port, plain = _pair(1, False)
    xs, biases = _streams()
    with ds.balance_loss() as acc:
        port(Packed.pack(xs), biases)
    plain(Packed.pack(xs), biases)
    (s, n), = acc.values()
    assert n == 6
    torch.testing.assert_close(s, sum(t for t, _ in plain.balance_terms))
    assert sum(k for _, k in plain.balance_terms) == 6


def test_held_shares_add_up_to_the_uncut_layer():
    """Two shares of the MoE ([0, 4) and [4, 8)), with the shared expert
    counted once, add up to the reference's uncut MoE (every expert held)."""
    uncut = ref.MoE(ref_config(experts_held=(0, 8)))
    g = torch.Generator().manual_seed(3)
    sd = {k: 0.3 * torch.randn(v.shape, generator=g) for k, v in uncut.state_dict().items()}
    uncut.load_state_dict(sd)
    u = torch.randn(20, 64, generator=g)
    want = uncut(u)[0]
    parts, shared = [], None
    for e0, e1 in ((0, 4), (4, 8)):
        share = ds.MoE(port_config(experts_held=(e0, e1)), 1)
        own = dict(sd, **{"experts.w13": sd["experts.w13"][e0:e1],
                          "experts.w2": sd["experts.w2"][e0:e1]})
        share.load_state_dict(own)
        parts.append(share(u, ((20, 1),), (torch.zeros(20, 1),)))
        shared = share.shared_experts(u)
    _close(parts[0] + parts[1] - shared, want)


def _model_pair(**kw):
    """The port's K3MForPretraining and the benchmark's composed plain
    reference (benchmark/reference/k3m_deepseek.py) of a small DeepSeek-V2
    config over tests/test_torch_dist.py's CFG, with the same weights."""
    from benchmark.lib import weights_moe
    from benchmark.reference import k3m_deepseek
    cfg = CFG.replace(**dict(SMALL, vocab_size=128, intermediate_size=32,
                             bi_num_attention_heads=4, hidden_act="silu", **kw))
    port = K3MForPretraining(cfg)
    plain = k3m_deepseek.build(cfg.to_dict())
    weights_moe.fill_weights(port, 11, 0.2)
    weights_moe.fill_weights(plain, 11, 0.2)
    return cfg, port, plain


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "sequential"])
def test_pretraining_losses_and_gradients_match_reference(packed):
    """The whole pretraining model, dropout on with the step's draws: the
    four K3M losses, the balance loss and every parameter's gradient."""
    from benchmark.reference import k3m_deepseek
    from benchmark.reference.k3m_plain import rand as plain_rand
    from benchmark.reference.inputs import to_device
    cfg, port, plain = _model_pair(packed_passes=packed, fused_qkv=packed)
    trainer = PretrainTrainer(cfg, device="cpu", seed=SEED, model=port)
    staged = trainer.stage(pretrain_batch(5))
    loss, metrics = trainer.losses(staged, deterministic=False, rng=StepRandom(SEED, 0, "cpu"))
    loss.backward()
    batch = {k: v for k, v in to_device({k: v.numpy() for k, v in staged.items()}, "cpu")
             .items()}
    out = plain(batch, deterministic=False, rng=plain_rand.StepRandom(SEED, 0, "cpu"))
    want_loss, want = k3m_deepseek.total_loss(out)
    want_loss.backward()
    assert float(want["moe_balance_loss"]) > 0
    for k in k3m_deepseek.LOSS_KEYS:
        assert math.isclose(float(metrics[k]), float(want[k]), rel_tol=1e-4), k
    grads = dict(plain.named_parameters())
    for name, p in port.named_parameters():
        w = grads[name].grad
        if w is None:
            assert p.grad is None or float(p.grad.abs().max()) == 0, name
            continue
        _close(p.grad, w, 1e-4, 1e-6)


def test_default_configs_build_the_bert_block():
    """A config without the DeepSeek keys builds exactly the BERT text
    block: the same state dict keys as before the selector, no RMSNorm and
    no expert."""
    model = K3MForPretraining(CFG)
    assert isinstance(model.embeddings, BertEmbeddings)
    assert all(isinstance(layer, TextLayer) for layer in model.encoder.layer)
    assert model.encoder.norm is None
    keys = set(model.state_dict())
    again = K3MForPretraining(K3MConfig.from_dict(
        {k: v for k, v in CFG.to_dict().items() if k in K3MConfig.__dataclass_fields__
         and k not in ("text_block",) and not k.startswith(("kv_", "q_", "qk_", "moe_"))}))
    assert keys == set(again.state_dict())
    assert not any(s in k for k in keys for s in ("experts", "self_attn", "norm.weight"))
    assert "embeddings.position_embeddings.weight" in keys


def test_tensor_parallelism_is_refused():
    with pytest.raises(ValueError, match="tensor parallelism is not built"):
        mesh.check_model_axis(port_config(), 2)
    mesh.check_model_axis(port_config(), 1)
    with pytest.raises(ValueError, match="does not build"):
        port_config(experts_held=(4, 12))
    with pytest.raises(ValueError, match="q_lora_rank"):
        K3MConfig.from_dict(dict(port_config().to_dict(), q_lora_rank=16))


def test_counters_read_once_per_recording():
    """While recording, the MoE layers add each held expert's rows and the
    rows computed on the device; the recorder reads them at its end. Off,
    nothing is kept."""
    port, _ = _pair(1, True)
    xs, biases = _streams()
    with trace.recording() as rec:
        port(Packed.pack(xs), biases)
        port(Packed.pack(xs), biases)
    rows_ = rec.counts["k3m.moe.expert_rows"]
    assert len(rows_) == 4 and sum(rows_) == rec.counts["k3m.moe.rows"][0]
    assert 0 < sum(rows_) <= 2 * 3 * 36
    names = {s["name"] for s in rec.spans}
    assert {"k3m.mla", "k3m.moe.route", "k3m.moe.experts", "k3m.moe.combine",
            "k3m.moe.shared"} <= names
    port(Packed.pack(xs), biases)
    assert rec.counts["k3m.moe.expert_rows"] == rows_


# ------------------------------------------ two data ranks on gloo

DP_CFG = CFG.replace(**dict(SMALL, vocab_size=128, intermediate_size=32,
                            bi_num_attention_heads=4, hidden_act="silu",
                            packed_passes=True, fused_qkv=True))


def dp_step(batch, world=None):
    from k3m_tpu_torch.train.dist import all_reduce_grads
    model = K3MForPretraining(DP_CFG)
    from benchmark.lib import weights_moe
    weights_moe.fill_weights(model, 5, 0.2)
    trainer = PretrainTrainer(DP_CFG, device="cpu", seed=SEED, world=world, model=model)
    loss, metrics = trainer.losses(trainer.stage(batch), deterministic=False,
                                   rng=StepRandom(SEED, 0, "cpu"))
    loss.backward()
    all_reduce_grads(trainer.world, trainer.model.parameters())
    metrics = trainer.global_metrics(metrics)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None})


def _dp_main(rank, size, tmp):
    torch.set_num_threads(1)
    try:
        world = train_dist.init_world(rank, size, f"file://{tmp}/init_ds", "cpu",
                                      timeout_s=GROUP_TIMEOUT_S)
        try:
            out = dp_step(rows(pretrain_batch(7), rank), world)
        finally:
            world.close()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def test_two_data_ranks_equal_one_process(tmp_path):
    """The global losses (balance loss included; rtol 1e-5) and every
    all-reduced gradient (1e-5 of its scale + 1e-7) of two gloo ranks equal
    one process's step on the global batch."""
    ranks = spawn_world(_dp_main, 2, tmp_path)
    losses, grads = dp_step(pretrain_batch(7))
    assert "moe_balance_loss" in losses
    for got_losses, got_grads in ranks:
        for k, v in losses.items():
            assert math.isclose(got_losses[k], v, rel_tol=1e-5, abs_tol=1e-7), k
        for name, g in grads.items():
            _close(got_grads[name], g)


def test_pretrain_cli_trains_the_deepseek_block(tmp_path):
    """`python -m k3m_tpu_torch.pretrain` with a DeepSeek-V2 config file
    trains through `PretrainTrainer.fit` on the packed path; every logged
    loss is finite and the balance loss is among them."""
    from k3m_tpu_torch import pretrain
    from tests.test_torch_dist import _write_cli_inputs
    args = _write_cli_inputs(tmp_path)["pretrain"]
    cfg_path = tmp_path / "dsv2.json"
    cfg_path.write_text(DP_CFG.replace(vocab_size=21128).to_json_string())
    run = pretrain.main([str(cfg_path) if a == str(tmp_path / "nano.json") else a
                         for a in args])
    model = run["trainer"].model
    assert isinstance(model.encoder.layer[1], ds.DeepSeekTextLayer)
    (hist,) = run["history"]
    losses = hist["step_losses"]
    assert losses and all("moe_balance_loss" in x for x in losses)
    assert all(np.isfinite(v) for x in losses for v in x.values())
