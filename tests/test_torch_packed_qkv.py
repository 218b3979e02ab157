"""`packed_passes` and `fused_qkv` in the port's trunk (k3m_tpu_torch/
model/encoder.py `_fused_passes`, model/layers.py `Packed`, `fused_dense`),
in fp32 on the CPU at MICRO geometry (two text layers, the first
co-attention block after text layer 1, so that the first packed segment is
not empty):

  * the port's K3MForPretraining against the JAX package's on the same
    numpy batch, injected draws and weights (carried by from_jax_params),
    with fused_qkv for the variants of tests/test_fused_qkv.py and with
    packed_passes for those of tests/test_packed_passes.py: the losses,
    c_initial and c_final within 1e-4 relative / 1e-5 absolute; the JAX
    model is applied once per case, eagerly;
  * each flag against the plain trunk in the port, dropout 0: the losses
    and every parameter's gradient within the same limits; packed_passes
    under dynamic attention against the plain trunk whose image layers
    after the last co-attention block gate on the text after the last
    text layer, as the JAX package's packed schedule gates them;
  * the state dict the same with and without each flag (keys, shapes,
    strict load), for the pretraining and the alignment model;
  * two gloo ranks (one world, spawned once per module; the pattern of
    tests/test_torch_dist.py) with packed_passes, dynamic attention and
    dropout 0.1 against one process on the global batch: losses and
    gradients, and every hidden-dropout draw and every attention mask (the
    plain versions' Philox masks) bit for bit the one process's rows, the
    image stack's second copy among them; then the same ranks as
    `--n_model 2` with fused_qkv (dynamic attention's gates sliced to the
    rank's columns), with fused_qkv and packed_passes over 3 text heads
    (which do not divide 2: Q, K and V gathered apart), and a finetune
    step with both flags, against one process within tests/test_torch_tp.py's
    limits;
  * `visualization` under packed_passes: the maps of every site against
    the JAX package's sown maps, in its order and count (four a text
    layer, one image map at 2B rows);
  * `python -m k3m_tpu_torch.pretrain`, `finetune --do_train --do_eval
    --do_pred` and `train_concap_struc` with a config file that sets both
    flags, `--device cpu`.
"""

import contextlib
import os
import traceback

import numpy as np
import pytest
import torch

from k3m_tpu_torch import dist
from k3m_tpu_torch.model.pretrain import K3MForPretraining
from k3m_tpu_torch.model.random import StepRandom
from k3m_tpu_torch.train import dist as train_dist
from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
from tests.test_torch_dist import (
    CFG, GROUP_TIMEOUT_S, SEED, _assert_grads_match, _write_cli_inputs,
    pair_batch, pretrain_batch, rows, spawn_world,
)
from tests.test_torch_tp import TP_CFG, _assert_close, _grads, _replicated
from tests.test_torch_tp import pretrain_step as tp_pretrain_step

TOL = dict(rtol=1e-4, atol=1e-5)
LOSSES = ("masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv",
          "next_sentence_loss_t_v_pv", "loss_struc")
OUTPUTS = LOSSES + ("c_initial", "c_final")
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  v_hidden_dropout_prob=0.0, v_attention_probs_dropout_prob=0.0)
FLAGS = {"packed": dict(packed_passes=True), "fused": dict(fused_qkv=True),
         "packed_fused": dict(packed_passes=True, fused_qkv=True)}


def _out(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# ------------------------------------------------- against the JAX package

def _jax_case(variant):
    """(JAX config, batch, draws, params) of MICRO with `variant` (config
    items); the weights are redrawn as the pretraining
    model's test redraws them; without the image, the Gumbel noise of
    two fusion options."""
    from tests.conftest import MICRO
    from tests.test_torch_pretrain_model import _model_inputs, jax_pretraining
    cfg = MICRO.replace(num_negative_pv=4, **variant)
    batch, inject = _model_inputs(cfg)
    if not cfg.use_image:           # two fusion options: the stream and its text partner
        inject["gumbel_noise"] = {m: n[:, :, :2] for m, n in inject["gumbel_noise"].items()
                                  if m != "v"}
    jm, params = jax_pretraining(cfg, batch, inject)
    return cfg, batch, inject, jm, params


def _port_against_jax(variant):
    from tests.test_torch_pretrain_model import _to_torch, port_pretraining
    cfg, batch, inject, jm, params = _jax_case(variant)
    want = jm.apply(params, batch, deterministic=True, **inject)
    model = port_pretraining(cfg, params)
    with torch.no_grad():
        got = model(_to_torch(batch), deterministic=True, **_to_torch(inject))
    for k in OUTPUTS:
        np.testing.assert_allclose(_out(got[k]), np.asarray(want[k]), err_msg=k, **TOL)
    assert float(want["masked_lm_loss"]) != 0.0


@pytest.mark.parametrize("variant", [
    {}, {"use_image": False}, {"dynamic_attention": True}, {"packed_passes": True},
], ids=["default", "no_image", "dynamic", "packed"])
def test_fused_qkv_matches_jax(variant):
    """fused_qkv (the variants of tests/test_fused_qkv.py)."""
    _port_against_jax(dict(variant, fused_qkv=True))


@pytest.mark.parametrize("variant", [
    {}, {"use_image": False}, {"dynamic_attention": True},
    {"fixed_t_layer": 2, "fixed_v_layer": 1},
], ids=["default", "no_image", "dynamic", "fixed_layers"])
def test_packed_passes_matches_jax(variant):
    """packed_passes (the variants of tests/test_packed_passes.py)."""
    _port_against_jax(dict(variant, packed_passes=True))


def test_packed_attention_maps_match_jax():
    """visualization under packed_passes: every JAX site has its port site
    with the same count of maps in the same order (each text layer sows one
    map per packed stream, [t, pv, t, pv], the image layer one of 2B rows)
    and the same probabilities within 1e-5."""
    from k3m_tpu.model.visualize import flatten_attention as jax_flatten
    from k3m_tpu_torch.model.visualize import flatten_attention, forward_with_attention
    from tests.test_torch_pretrain_model import _to_torch, port_pretraining
    from tests.test_torch_visualize import port_path
    cfg, batch, inject, jm, params = _jax_case(dict(packed_passes=True, visualization=True))
    _, inter = jm.apply(params, batch, deterministic=True, mutable=["intermediates"],
                        **inject)
    want = {port_path(k): np.asarray(v) for k, v in jax_flatten(inter["intermediates"]).items()}
    with torch.no_grad():
        _, maps = forward_with_attention(port_pretraining(cfg, params), _to_torch(batch),
                                         deterministic=True, **_to_torch(inject))
    got = flatten_attention(maps)
    assert set(got) == set(want) and len(got) > 10
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5, atol=1e-5, err_msg=key)
    B = batch["input_ids"].shape[0]
    counts = {p: {n: len(v) for n, v in sites.items()} for p, sites in maps.items()}
    assert counts["encoder.layer.0.attention.self"] == {"attention_probs": 4}
    assert counts["encoder.v_layer.0.attention.self"] == {"attention_probs": 1}
    assert maps["encoder.v_layer.0.attention.self"]["attention_probs"][0].shape[0] == 2 * B
    lengths = [m.shape[-1] for m in maps["encoder.layer.1.attention.self"]["attention_probs"]]
    assert lengths == [8, 12, 8, 12]


# --------------------------------------------------- within the port

def _step(cfg, batch, det=True):
    trainer = PretrainTrainer(cfg, device="cpu", seed=SEED)
    loss, metrics = trainer.losses(trainer.stage(batch), deterministic=det,
                                   rng=StepRandom(SEED, 0, "cpu"))
    loss.backward()
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None})


def _assert_steps_close(got, want):
    (got_losses, got_grads), (want_losses, want_grads) = got, want
    assert set(got_grads) == set(want_grads) and len(want_grads) > 50
    for k, w in want_losses.items():
        np.testing.assert_allclose(got_losses[k], w, err_msg=k, **TOL)
    for name, w in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), w.numpy(), err_msg=name, **TOL)
    assert want_losses["loss_struc"] > 0


@pytest.mark.parametrize("flags,variant", [
    ("packed", {}), ("fused", {}), ("packed_fused", {}), ("packed_fused", {"use_image": False}),
    ("fused", {"dynamic_attention": True}),
], ids=["packed", "fused", "packed_fused", "packed_fused_no_image", "fused_dynamic"])
def test_flags_equal_the_plain_trunk_with_gradients(flags, variant):
    """Dropout 0: each flag's losses and every parameter's gradient against
    the plain trunk's (the same weights from the seed), within 1e-4
    relative / 1e-5 absolute. packed_passes under dynamic attention: the
    next test."""
    base = CFG.replace(**NO_DROPOUT, **variant)
    batch = pretrain_batch(10)
    _assert_steps_close(_step(base.replace(**FLAGS[flags]), batch), _step(base, batch))


def _text_first_pass(self, txt, img, txt_bias, txt_mask2, img_bias, c_layers, det,
                     t_start=0):
    """TriStreamEncoder._pass_text_image with its trailing text layers run
    before its trailing image layers (MICRO: one co-attention block, no
    in_batch_pairs or fast_mode)."""
    cfg = self.cfg
    (v_end,), (t_end,) = cfg.v_biattention_id, cfg.t_biattention_id
    txt = self._run_text(txt, txt_bias, t_start, t_end, det)
    img = self._run_image(img, img_bias, txt, txt_mask2, 0, v_end, det)
    img, txt = c_layers[0](img, img_bias, txt, txt_bias, det)
    txt = self._run_text(txt, txt_bias, t_end, cfg.num_hidden_layers, det)
    img = self._run_image(img, img_bias, txt, txt_mask2, v_end, cfg.v_num_hidden_layers, det)
    return txt, img


def test_packed_dynamic_attention_gates_the_last_image_layers_as_jax(monkeypatch):
    """The JAX package's packed schedule runs the text layers after the
    last co-attention block before the image layers after it
    (k3m_tpu/model/encoder.py:244-247; its sequential passes run them the
    other way, :143-146), so under dynamic attention those image layers are
    gated on the text after the last text layer. The port computes what
    the JAX package computes (test_packed_passes_matches_jax[dynamic]):
    its packed trunk's step, dropout 0, equals that of the sequential
    trunk with the two runs swapped, every gradient (the key projections'
    biases aside: zero in exact arithmetic) within 1e-5 of its tensor's
    scale, where the unswapped trunk's gradients lie more than 1e-3 of the
    scale away (about 5e-3 at MICRO)."""
    from k3m_tpu_torch.model.encoder import TriStreamEncoder
    base = CFG.replace(dynamic_attention=True, **NO_DROPOUT)
    batch = pretrain_batch(10)
    packed = _step(base.replace(packed_passes=True), batch)
    plain = _step(base, batch)
    monkeypatch.setattr(TriStreamEncoder, "_pass_text_image", _text_first_pass)
    swapped = _step(base, batch)
    _assert_steps_close(packed, swapped)

    def worst(got, want):
        return max(float((got[n] - w).abs().max() / w.abs().max()) for n, w in want.items()
                   if not n.endswith(("key.bias", "key1.bias", "key2.bias")))
    assert worst(packed[1], swapped[1]) <= 1e-5
    assert worst(packed[1], plain[1]) > 1e-3


@pytest.mark.parametrize("flag", ["packed_passes", "fused_qkv"])
def test_state_dict_is_the_same_with_and_without(flag):
    """Keys and shapes of the pretraining and the alignment model's state
    dicts equal without the flag; the plain model's state dict loads
    strictly into the flagged one."""
    from k3m_tpu_torch.model.alignment import K3MForItemAlignment
    for make in (K3MForPretraining, K3MForItemAlignment):
        plain, flagged = make(CFG), make(CFG.replace(**{flag: True}))
        shapes = lambda m: {k: tuple(v.shape) for k, v in m.state_dict().items()}
        assert shapes(plain) == shapes(flagged)
        flagged.load_state_dict(plain.state_dict(), strict=True)


# ----------------------------------------- two ranks against one process

DP_CFG = CFG.replace(packed_passes=True, dynamic_attention=True)
TP_CASES = {
    "fused": TP_CFG.replace(fused_qkv=True),
    # 3 text heads of 8 over 2 model ranks: replicated text attention
    "fused_packed_3_heads": TP_CFG.replace(fused_qkv=True, packed_passes=True,
                                           hidden_size=24, num_attention_heads=3),
}


@contextlib.contextmanager
def recording():
    """Every hidden-dropout and index draw (`rows_randint`, with the
    slices of the global rows that it returned) and every plain attention
    mask (with its seed, salt, first global row and head) of the enclosed
    code."""
    from k3m_tpu_torch.kernels import attention
    from k3m_tpu_torch.model import random as k3m_random
    rec = dict(bits=[], masks=[])
    keep, randint = attention._plain_keep, k3m_random.rows_randint

    def recorded_keep(q, k, rate, seed, salt, row0=0, head0=0, heads_global=None):
        m = keep(q, k, rate, seed, salt, row0, head0, heads_global)
        if m is not None:
            rec["masks"].append((seed, salt, row0, head0, m))
        return m

    def recorded_randint(generator, high, shape, device, dtype=torch.int64):
        out = randint(generator, high, shape, device, dtype)
        rec["bits"].append((dist.windows(shape[0])[0], out))
        return out
    attention._plain_keep, k3m_random.rows_randint = recorded_keep, recorded_randint
    try:
        yield rec
    finally:
        attention._plain_keep, k3m_random.rows_randint = keep, randint


def dp_step(batch, world=None):
    """(global losses, all-reduced gradients, draws) of one train step of
    DP_CFG, dropout 0.1, the step's own draws."""
    from k3m_tpu_torch.train.dist import all_reduce_grads
    trainer = PretrainTrainer(DP_CFG, device="cpu", seed=SEED, world=world)
    with recording() as rec:
        loss, metrics = trainer.losses(trainer.stage(batch), deterministic=False,
                                       rng=StepRandom(SEED, 0, "cpu"))
    loss.backward()
    all_reduce_grads(trainer.world, trainer.model.parameters())
    metrics = trainer.global_metrics(metrics)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None}, rec)


def tp_finetune_step(batch, world=None):
    """tests/test_torch_tp.py's finetune step (loss inner, dropout on) with
    both flags."""
    from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer, decode_items
    from k3m_tpu_torch.train.dist import all_reduce_grads
    trainer = AlignmentTrainer(TP_CFG.replace(fused_qkv=True, packed_passes=True,
                                              loss_type="inner"),
                               device="cpu", seed=SEED, world=world)
    b = decode_items(trainer.stage(batch), trainer.config)
    loss = trainer.model(b["label"], b["item1"], b["item2"], deterministic=False,
                         rng=StepRandom(SEED, 0, "cpu"), world=trainer.world)[3]
    loss.backward()
    replicated = _replicated(trainer.model)
    all_reduce_grads(trainer.world, trainer.model.parameters())
    loss = trainer.global_metrics(dict(loss=loss.detach()))["loss"]
    return {"loss": float(loss)}, _grads(trainer.model, world), replicated


def _world_main(rank, size, tmp):
    torch.set_num_threads(1)
    try:
        out = {}
        world = train_dist.init_world(rank, size, f"file://{tmp}/init_dp", "cpu",
                                      timeout_s=GROUP_TIMEOUT_S)
        try:
            out["dp"] = dp_step(rows(pretrain_batch(10), rank), world)
        finally:
            world.close()
        world = train_dist.init_world(rank, size, f"file://{tmp}/init_tp", "cpu",
                                      timeout_s=GROUP_TIMEOUT_S, n_model=2)
        try:
            for name, cfg in TP_CASES.items():
                out[name] = tp_pretrain_step(pretrain_batch(10), world, cfg)
            out["finetune"] = tp_finetune_step(pair_batch(12), world)
        finally:
            world.close()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("packed_world2")
    return spawn_world(_world_main, 2, tmp)


def test_two_data_ranks_draw_one_process_bits_under_packed_passes(world2):
    """packed_passes, dynamic attention, dropout 0.1: the global losses
    (rtol 1e-5) and all-reduced gradients (1e-5 of the tensor's scale +
    1e-7) of two ranks equal one process's on the concatenated batch; each
    rank's hidden-dropout and index draws are, bit for bit, the one
    process's draws at the rank's global rows (the packed text rows' [B,
    sum L, H] draws, and the image stack's two copies, rows h * 4 + row0
    + b); each attention mask of the plain versions is, bit for bit, the
    one process's mask of the same call at the rank's rows (the image
    stack in one call there, one per copy on each rank)."""
    want_losses, want_grads, want = dp_step(pretrain_batch(10))
    one = {(seed, salt, head0): m for seed, salt, row0, head0, m in want["masks"]}
    assert len(one) == len(want["masks"]) and all(r[2] == 0 for r in want["masks"])
    for rank, out in enumerate(world2):
        got_losses, got_grads, rec = out["dp"]
        for k, w in want_losses.items():
            assert abs(got_losses[k] - w) <= 1e-5 * max(1.0, abs(w)), (rank, k)
        _assert_grads_match(got_grads, want_grads, rank)
        assert len(rec["bits"]) == len(want["bits"])
        for (spans, bits), (_, full) in zip(rec["bits"], want["bits"]):
            assert torch.equal(bits, torch.cat([full[r0:r0 + n] for r0, n in spans])), rank
        assert any(len(spans) == 2 for spans, _ in rec["bits"])
        assert {(s, salt, h) for s, salt, _, h, _ in rec["masks"]} == set(one)
        for seed, salt, row0, head0, m in rec["masks"]:
            assert torch.equal(m, one[(seed, salt, head0)][row0:row0 + m.shape[0]]), rank
        assert any(r[2] >= 4 for r in rec["masks"])       # the second image copy


@pytest.mark.parametrize("case", list(TP_CASES))
def test_two_model_ranks_with_the_flags_equal_one_process(world2, case):
    """`--n_model 2`, dropout on: the losses (rtol 1e-5) and every gradient
    gathered to full shape (1e-4 of its tensor's scale + 1e-7) equal one
    process's; the replicated gradients equal on both ranks before the
    model-group average."""
    want_losses, want_grads, _ = tp_pretrain_step(pretrain_batch(10), None, TP_CASES[case])
    for rank, out in enumerate(world2):
        got_losses, got_grads, _ = out[case]
        for k, w in want_losses.items():
            assert abs(got_losses[k] - w) <= 1e-5 * max(1.0, abs(w)), (case, rank, k)
        _assert_close(got_grads, want_grads, (case, rank))
    r0, r1 = world2[0][case][2], world2[1][case][2]
    assert set(r0) == set(r1) and len(r0) > 10
    for name, g in r0.items():
        assert torch.equal(g, r1[name]), (case, name)


def test_two_model_ranks_finetune_with_the_flags_equal_one_process(world2):
    """A finetune step (loss inner, both flags, dropout on) of two model
    ranks against one process, as above."""
    want_losses, want_grads, _ = tp_finetune_step(pair_batch(12))
    for rank, out in enumerate(world2):
        got_losses, got_grads, _ = out["finetune"]
        assert abs(got_losses["loss"] - want_losses["loss"]) <= \
            1e-5 * max(1.0, abs(want_losses["loss"])), rank
        _assert_close(got_grads, want_grads, ("finetune", rank))


# ------------------------------------------------------------ the CLIs

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """tests/test_torch_dist.py's CLI inputs with a MICRO config file that
    sets both flags."""
    tmp = tmp_path_factory.mktemp("packed_cli")
    args = _write_cli_inputs(tmp)
    cfg_path = tmp / "micro_flags.json"
    cfg_path.write_text(CFG.replace(vocab_size=21128, packed_passes=True, fused_qkv=True)
                        .to_json_string())
    swap = lambda a: [str(cfg_path) if x == str(tmp / "nano.json") else x for x in a]
    legacy = ["--data_dir", str(tmp), "--output_dir", str(tmp / "legacy_out"), "--file_name",
              "train_feat.k3mr", "--config_file", str(cfg_path), "--device", "cpu",
              "--train_batch_size", "4", "--log_steps", "1", "--seed", "5", "--do_train",
              "--num_train_epochs", "1", "--max_seq_length", "12", "--max_seq_length_pv",
              "24", "--max_num_pv", "4", "--max_region_length", "5"]
    return dict(pretrain=swap(args["pretrain"]), finetune=swap(args["finetune"]) + ["--do_pred"],
                legacy=legacy)


@pytest.mark.parametrize("cli", ["pretrain", "finetune", "legacy"])
def test_clis_run_with_both_flags_on_the_cpu(cli_inputs, cli):
    """Each CLI trains (finetune also evaluates and predicts) with a config
    file that sets packed_passes and fused_qkv; the run's model has both,
    and every logged loss is finite."""
    from k3m_tpu_torch import finetune, pretrain, train_concap_struc
    main = dict(pretrain=pretrain.main, finetune=finetune.main,
                legacy=train_concap_struc.main)[cli]
    run = main(cli_inputs[cli])
    cfg = run["trainer"].config
    assert cfg.packed_passes and cfg.fused_qkv
    (hist,) = run["history"]
    losses = hist["step_losses"]
    assert losses
    flat = [v for x in losses for v in (x.values() if isinstance(x, dict) else [x])]
    assert all(np.isfinite(v) for v in flat)
    if cli == "finetune":
        assert run["output"] and os.path.getsize(run["output"]) > 0
