"""The port's pretraining trainer, loader and CLI against the JAX
package's, on the CPU.

  * three train steps of the port's PretrainTrainer and of the JAX
    PretrainTrainer from the same initial weights on the same batches, with
    dropout 0 and injected draws, and with micro_steps=2 and no draws:
    losses and parameters agree within 1e-3,
    the drift tests/test_trainer_trajectory.py allows, and each tensor's
    change within 1e-3 of the JAX change;
  * PretrainLoader batches are byte-identical to the JAX loader's
    (`native_preprocess=False, use_native=False`);
  * `python -m k3m_tpu_torch.pretrain --device cpu` trains 2 steps with
    dropout at NANO shapes, checkpoints, and resumes from the checkpoint.
"""

import json
import re

import jax
import numpy as np
import optax
import pytest
import torch

from k3m_tpu.data.pipeline import PretrainLoader as JaxLoader
from k3m_tpu.data.preprocess import ShapeSpec as JaxShapes
from k3m_tpu.tokenization import get_tokenizer as jax_tokenizer
from k3m_tpu.train.convert import _flatten
from k3m_tpu.train.pretrain_loop import PretrainTrainer as JaxTrainer
from k3m_tpu_torch.convert import from_jax_params
from k3m_tpu_torch.data import records as trec
from k3m_tpu_torch.data.pipeline import PretrainLoader
from k3m_tpu_torch.data.preprocess import ShapeSpec
from k3m_tpu_torch.tokenization import get_tokenizer
from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
from tests.conftest import NANO, single_mesh
from tests.test_torch_data import SHAPES, _item
from tests.test_torch_modules import torch_config
from tests.test_torch_pretrain_model import _model_inputs

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  v_hidden_dropout_prob=0.0, v_attention_probs_dropout_prob=0.0)
TRAIN_LOSSES = ("loss", "masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv",
                "loss_struc")
# biases that shift a softmax's input (attention keys, the structure scores):
# their gradient is zero in exact arithmetic, so their change is rounding
# noise that Adam scales up to a step of either sign
SOFTMAX_SHIFT = re.compile(r"(\.key[12]?\.bias|^struc_w2\.bias)$")
# the NSP head, which objective 2 does not reach: it changes by weight
# decay alone, far below one Adam step, and must decay as optax decays it;
# that change is ~1e-5 of the weight, a few fp32 ulps of it, so it is held
# to 1e-2 of itself
DECAY_ONLY = ("cls.seq_relationship.weight",)


def assert_adam_moments_match(jt, pt, rel=1e-2):
    """Adam's first moments, the trainers' gradients averaged over the
    updates, agree within `rel` of each tensor's norm. The parameters cannot
    show a wrong gradient scale (Adam divides it out); the moments do."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        jt.state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    flat = {k: np.asarray(v) for k, v in _flatten(adam.mu["params"]).items()}
    named = dict(pt.model.named_parameters())
    for name, want in from_jax_params(flat).items():
        if SOFTMAX_SHIFT.search(name):
            continue
        got = pt.opt.state[named[name]]["exp_avg"]
        err = float(torch.linalg.vector_norm(got - want))
        norm = float(torch.linalg.vector_norm(want))
        assert err <= rel * norm + 1e-9, (name, err, norm)


def _three_steps_against_jax(cfg, batches, **kw):
    """Train the JAX and the port's PretrainTrainer from the same initial
    weights on `batches`: the losses of each step, then the parameters and
    each tensor's change."""
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, seed=0, **kw)
    jt = JaxTrainer(cfg, mesh=single_mesh(), sample_batch=batches[0], **kw)
    flat = {k: np.array(v) for k, v in _flatten(jt.state.params["params"]).items()}
    init = from_jax_params(flat)
    pt = PretrainTrainer(torch_config(cfg), device="cpu", **kw)
    pt.model.load_state_dict(init, strict=True)
    for i, batch in enumerate(batches):
        want = {k: float(v) for k, v in jt.train_step(batch).items()}
        got = {k: float(v) for k, v in pt.train_step(batch).items()}
        for k in TRAIN_LOSSES:
            assert abs(got[k] - want[k]) <= 1e-3 * max(1.0, abs(want[k])), (i, k)
    flat = {k: np.asarray(v) for k, v in _flatten(jt.state.params["params"]).items()}
    named = dict(pt.model.named_parameters())
    off = total = 0.0
    for name, w in from_jax_params(flat).items():
        got = named[name].detach()
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-3, err_msg=name)
        if SOFTMAX_SHIFT.search(name):
            continue
        # the updates themselves: each tensor's change over the three steps
        # (the first at LR 0) within 1e-3 of the JAX change's norm plus 1%
        # of one Adam step over the tensor, and all changes together within
        # 1e-3, so that a skipped update, another beta2 or a decayed
        # LayerNorm scale shows (each fails this, checked by planting it)
        d_got, d_want = got - init[name], w - init[name]
        err = float(torch.linalg.vector_norm(d_got - d_want))
        norm = float(torch.linalg.vector_norm(d_want))
        floor = 1e-2 * norm if name in DECAY_ONLY \
            else 1e-2 * kw["learning_rate"] * d_want.numel() ** 0.5
        assert err <= 1e-3 * norm + floor, name
        off, total = off + err ** 2, total + norm ** 2
    assert total > 0 and off ** 0.5 <= 1e-3 * total ** 0.5
    assert pt.step == 3 and pt.sched.last_epoch == 3
    assert_adam_moments_match(jt, pt)


def test_three_train_steps_match_jax_trainer():
    cfg = NANO.replace(num_negative_pv=4, **NO_DROPOUT)
    batches = []
    for seed in range(3):
        batch, inject = _model_inputs(cfg, seed=seed)
        batches.append({**batch, **inject})
    _three_steps_against_jax(cfg, batches)


def test_micro_steps_train_steps_match_jax_trainer():
    """micro_steps=2 against the JAX trainer's micro_step_fn. Injected
    draws index the whole batch, so both refuse them under microbatches:
    this run's draws decide nothing. Dropout is 0 and fusion strategy 0;
    each slice has 2 items of 2 valid pairs, so the one LPM entity negative
    (the other item) and the one value negative (the other pair) are the
    only candidates. So the slices' gradients, their 1/M scale and the
    averaged losses are held to JAX's."""
    cfg = NANO.replace(num_negative_pv=2, if_pre_sampling=0, visual_target=0, **NO_DROPOUT)
    batches = [_model_inputs(cfg, seed=seed)[0] for seed in range(3)]
    for b in batches:
        assert ((b["index_p"][..., 0] != 0).sum(1) == 2).all()
    _three_steps_against_jax(cfg, batches, micro_steps=2)


def _records(path, n, seed=0):
    rng = np.random.default_rng(seed)
    trec.write_records(str(path), [_item(rng, i) for i in range(n)])


@pytest.mark.parametrize("visual_target", [0, 1])
def test_pretrain_loader_matches_jax(tmp_path, visual_target):
    path = str(tmp_path / "train.k3mr")
    _records(path, 11)
    kw = dict(batch_size=4, shuffle=True, seed=3, visual_target=visual_target)
    mine = PretrainLoader(path, get_tokenizer(None, 21128), ShapeSpec(**SHAPES), **kw)
    theirs = JaxLoader(path, jax_tokenizer(None, 21128), JaxShapes(**SHAPES),
                       use_native=False, native_preprocess=False, **kw)
    assert len(mine) == len(theirs) == 2
    for epoch in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], list):
                    assert a[k] == b[k], (epoch, k)
                else:
                    assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), \
                        (epoch, k)


def _cli_args(tmp_path, *extra):
    cfg_path = tmp_path / "nano.json"
    cfg_path.write_text(NANO.replace(vocab_size=21128, v_feature_size=8,
                                     v_target_size=7).to_json_string())
    return ["--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"),
            "--file_name", "{}_feat.k3mr", "--config_file", str(cfg_path),
            "--device", "cpu", "--use_image", "--with_coattention",
            "--train_batch_size", "4", "--max_seq_length", "12",
            "--max_seq_length_pv", "24", "--max_num_pv", "4",
            "--max_region_length", "5", "--log_steps", "1", "--seed", "5", *extra]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """Two steps with dropout 0.1, Gumbel and LPM draws on the CPU; the
    epoch checkpoint restores the trainer exactly, and --file_checkpoint
    resumes at the next epoch with the step counter carried on."""
    from k3m_tpu_torch import pretrain
    from k3m_tpu_torch.train.state import CheckpointManager
    _records(tmp_path / "train_feat.k3mr", 9)
    run = pretrain.main(_cli_args(tmp_path, "--num_train_epochs", "1"))
    (h,) = run["history"]
    assert len(h["step_losses"]) == 2
    for losses in h["step_losses"]:
        assert all(np.isfinite(v) for v in losses.values()), losses
        assert losses["loss"] > 0 and losses["next_sentence_loss_t_v_pv"] == 0.0
    out = tmp_path / "out"
    assert json.loads((out / "latest.json").read_text())["epoch"] == 0
    trainer = run["trainer"]
    state = CheckpointManager(str(out)).restore()
    assert state["step"] == 2
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(state["model"][k], v), k
    again = pretrain.main(_cli_args(tmp_path, "--num_train_epochs", "2",
                                    "--file_checkpoint", str(out)))
    assert [h["epoch"] for h in again["history"]] == [1]
    assert again["trainer"].step == 4


@pytest.mark.parametrize("flag", [["--data_backend", "grain"], ["--n_model", "3"],
                                  ["--n_model", "2"]])
def test_cli_refuses_unported_options_by_name(tmp_path, flag):
    """The grain backend reads ArrayRecord files only, as the JAX one does:
    on a K3MR train file it raises by name (it trains from an
    .array_record in tests/test_torch_grain.py). `--n_model` must divide
    every sharded width (NANO's hidden 16: 3 does not; a head count need
    not divide) and the world (one process: 2 does not)."""
    from k3m_tpu_torch import pretrain
    from k3m_tpu_torch.data.array_record import ArrayRecordError
    if flag[0] == "--data_backend":
        _records(tmp_path / "train_feat.k3mr", 4)
        with pytest.raises(ArrayRecordError, match="train_feat.k3mr: not an ArrayRecord"):
            pretrain.main(_cli_args(tmp_path, *flag))
        return
    match = ("--n_model 3 does not divide hidden_size 16" if flag[1] == "3" else
             "--n_model 2 does not divide the world of 1 processes")
    with pytest.raises(ValueError, match=match):
        pretrain.main(_cli_args(tmp_path, *flag))


def test_staging_wire_and_nonfinite_guard():
    """Under bf16 the fp wire ships image_feat in bf16 and the soft labels
    in fp16, the exact wire fp32; with skip_nonfinite a step whose
    gradients are not finite leaves every parameter as it was."""
    batch, inject = _model_inputs(NANO)
    cfg = torch_config(NANO).replace(dtype="bfloat16")
    for wire, feat, target in (("fp", torch.bfloat16, torch.float16),
                               ("exact", torch.float32, torch.float32)):
        staged = PretrainTrainer(cfg, device="cpu", wire=wire).stage(batch)
        assert staged["image_feat"].dtype == feat and staged["image_target"].dtype == target
        assert staged["input_ids"].dtype == torch.int64
    trainer = PretrainTrainer(torch_config(NANO), device="cpu", skip_nonfinite=True,
                              warmup_steps=0, learning_rate=1e-2)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    bad = dict(batch, **inject)
    bad["image_feat"] = np.full_like(batch["image_feat"], np.inf)
    metrics = trainer.train_step(bad)
    assert float(metrics["nonfinite_skipped"]) == 1.0
    assert all(torch.equal(before[k], v) for k, v in trainer.model.state_dict().items())


def test_cli_starts_from_given_weights_and_evaluates(tmp_path):
    """--pretrained_model_path loads a reference-style checkpoint (every
    weight it maps trains at 0.1x the LR, as JAX's
    load_pretrained_bert_paths has it, the HF NSP head of another shape
    too, though it is not loaded),
    --file_state_dict a saved state dict, and --do_eval reports finite
    validation losses."""
    from k3m_tpu_torch import pretrain
    from k3m_tpu_torch.model.pretrain import build_pretraining_model
    _records(tmp_path / "train_feat.k3mr", 8)
    _records(tmp_path / "valid_feat.k3mr", 4, seed=1)
    cfg = torch_config(NANO.replace(vocab_size=21128, v_feature_size=8, v_target_size=7))
    sd = build_pretraining_model(cfg, seed=3, device="cpu").state_dict()
    ref = {("bert." + k if k.startswith("encoder.") else k): v for k, v in sd.items()}
    ref["cls.seq_relationship.weight"] = torch.zeros(2, 7)     # an HF NSP head
    torch.save(ref, tmp_path / "ref.bin")
    torch.save(sd, tmp_path / "state.pt")
    for extra in (["--pretrained_model_path", str(tmp_path / "ref.bin"), "--strict_load"],
                  ["--file_state_dict", str(tmp_path / "state.pt")]):
        run = pretrain.main(_cli_args(tmp_path, "--num_train_epochs", "1", "--do_eval",
                                      "--eval_batch_size", "2", "--learning_rate", "1e-9",
                                      *extra))
        trainer = run["trainer"]
        for k, v in sd.items():
            if k != "cls.seq_relationship.weight" or extra[0] == "--file_state_dict":
                torch.testing.assert_close(trainer.model.state_dict()[k], v, msg=k)
        (h,) = run["history"]
        assert np.isfinite(h["val_loss"]) and h["val_loss"] > 0
        lrs = sorted({g["initial_lr"] for g in trainer.opt.param_groups})
        if extra[0] == "--pretrained_model_path":
            assert lrs == pytest.approx([1e-10])     # seq_relationship at 0.1x too
        else:
            assert lrs == pytest.approx([1e-9])
