"""The port's item-alignment finetune loop on the CPU at NANO shapes.

  * in-step microbatching of both trainers: two slices equal one where
    the losses are per-sample means, an indivisible batch raises, and the
    pretraining trainer refuses what the JAX one refuses;
  * the training draws: seeded by (seed, step), the CE head's dropout in
    training only, the straight-through Gumbel gradient reaching the gates;
  * `python -m k3m_tpu_torch.finetune --do_train --do_eval --do_pred
    --device cpu`: epoch checkpoints, the sweep, the jsonl, resume bit for
    bit, the refused options and the missing card;
  * `staged_prefetch`, as tests/test_prefetch.py holds the JAX one.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from k3m_tpu_torch.model.alignment import build_model
from k3m_tpu_torch.model.heads import ClassificationHead
from k3m_tpu_torch.model.random import StepRandom
from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer, batch_to_device
from k3m_tpu_torch.train.prefetch import staged_prefetch
from tests.conftest import NANO
from tests.test_torch_data import _finetune_args, _pairs
from tests.test_torch_finetune import NO_DROPOUT, SOFTMAX_SHIFT, pair_batch, seeded_model
from tests.test_torch_modules import torch_config


# ------------------------------------------------------------ microbatches

def _vec(model):
    """Every parameter but the softmax-shift biases, whose gradient is zero
    in exact arithmetic and whose Adam step is rounding noise of either
    sign (tests/test_torch_trainer.py leaves them out too)."""
    return torch.cat([p.detach().flatten() for n, p in model.named_parameters()
                      if not SOFTMAX_SHIFT.search(n)])


@pytest.mark.parametrize("loss_type", ["ce", "inner"])
def test_micro_steps_equal_one_slice(loss_type):
    """With no draws (dropout 0, fusion strategy 0) two slices give the
    loss, probabilities and parameters of one: the losses are per-pair
    means (tests/test_alignment_micro.py holds the JAX trainer so)."""
    cfg = torch_config(NANO.replace(loss_type=loss_type, if_pre_sampling=0, **NO_DROPOUT))
    batch = pair_batch(NANO, B=8)
    kw = dict(learning_rate=1e-3, total_steps=10, seed=7, device="cpu")
    one, two = AlignmentTrainer(cfg, **kw), AlignmentTrainer(cfg, micro_steps=2, **kw)
    for step in range(2):
        l1, p1 = one.train_step(batch)
        l2, p2 = two.train_step(batch)
        np.testing.assert_allclose(l2.item(), l1.item(), rtol=2e-5, err_msg=f"step {step}")
        assert p1.shape == p2.shape == (8,)
        np.testing.assert_allclose(p2.numpy(), p1.numpy(), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(_vec(two.model).numpy(), _vec(one.model).numpy(),
                               rtol=1e-4, atol=1e-6)
    three = AlignmentTrainer(cfg, micro_steps=3, **kw)
    with pytest.raises(ValueError, match="micro_steps"):
        three.train_step(batch)


def test_pretrain_micro_steps_match_and_refusals():
    """The pretraining trainer at micro_steps 2 against 1 on the
    per-sample losses (count-weighted masked CEs agree to the slices' count
    imbalance; the alignment CE sees the heads' fixed 0.1 dropout, drawn
    per slice), and the refusals of the JAX trainer
    (tests/test_micro_steps.py): visual_target 2, an indivisible batch and
    injected draws."""
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    from tests.test_torch_pretrain_model import _model_inputs
    cfg = torch_config(NANO.replace(if_pre_sampling=0, num_negative_pv=4, **NO_DROPOUT))
    batch, inject = _model_inputs(NANO, B=8)
    kw = dict(learning_rate=1e-3, total_steps=10, seed=7, device="cpu")
    m1 = {k: float(v) for k, v in PretrainTrainer(cfg, **kw).train_step(batch).items()}
    m2 = {k: float(v) for k, v in
          PretrainTrainer(cfg, micro_steps=2, **kw).train_step(batch).items()}
    for k in ("masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv",
              "next_sentence_loss_t_v_pv"):
        np.testing.assert_allclose(m2[k], m1[k], rtol=5e-2, err_msg=k)
    assert np.isfinite(m2["loss"])
    with pytest.raises(ValueError, match="micro_steps"):
        PretrainTrainer(cfg.replace(visual_target=2), micro_steps=2, **kw)
    with pytest.raises(ValueError, match="micro_steps"):
        PretrainTrainer(cfg, micro_steps=3, **kw).train_step(batch)
    with pytest.raises(ValueError, match="micro_steps=1"):
        PretrainTrainer(cfg, micro_steps=2, **kw).train_step({**batch, **inject})


# --------------------------------------------------------- training draws

def test_training_draws_are_seeded_by_step():
    """Dropout, the attention kernels' dropout and the Gumbel draws come
    from StepRandom(seed, step): the same pair gives the same loss bits,
    another step another loss; deterministic=True draws nothing."""
    cfg = torch_config(NANO.replace(loss_type="ce", if_pre_sampling=1))
    model = seeded_model(NANO.replace(loss_type="ce", if_pre_sampling=1))
    b = batch_to_device(pair_batch(NANO), "cpu")

    def loss(**kw):
        with torch.no_grad():
            return model(b["label"], b["item1"], b["item2"], **kw)[3]
    a = loss(deterministic=False, rng=StepRandom(5, 3))
    assert torch.equal(a, loss(deterministic=False, rng=StepRandom(5, 3)))
    assert not torch.equal(a, loss(deterministic=False, rng=StepRandom(5, 4)))
    assert not torch.equal(a, loss(deterministic=False, rng=StepRandom(5, 3, micro=0)))
    assert torch.equal(loss(deterministic=True), loss(deterministic=True))
    assert cfg.hidden_dropout_prob > 0


def test_classification_head_dropout_acts_in_training_only():
    """dropout -> dense -> tanh -> dropout -> out_proj in training, with
    the step's dropout bits; the plain head in eval or at rate 0."""
    from k3m_tpu_torch.model import random as k3m_random
    from k3m_tpu_torch.model.layers import dropout
    cfg = torch_config(NANO)
    head = ClassificationHead(cfg)
    torch.nn.init.normal_(head.dense.bias)
    x = torch.randn(16, 2 * cfg.hidden_size)
    plain = head.out_proj(torch.tanh(head.dense(x))).float()
    torch.testing.assert_close(head(x), plain, rtol=0, atol=0)
    with k3m_random.use(StepRandom(0, 0)):
        dropped = head(x, deterministic=False)
    with k3m_random.use(StepRandom(0, 0)):
        rate = cfg.hidden_dropout_prob
        want = head.out_proj(dropout(torch.tanh(head.dense(dropout(x, rate, False))),
                                     rate, False)).float()
    torch.testing.assert_close(dropped, want, rtol=0, atol=0)
    assert not torch.allclose(dropped, plain)
    off = ClassificationHead(cfg.replace(hidden_dropout_prob=0.0))
    off.load_state_dict(head.state_dict())
    torch.testing.assert_close(off(x, deterministic=False), plain, rtol=0, atol=0)


def test_gumbel_gradient_reaches_the_gates():
    """Under if_pre_sampling 1 the straight-through hard Gumbel-softmax
    passes a gradient to every score_* gate (y_soft detached in the
    forward value, not in the gradient)."""
    cfg = NANO.replace(loss_type="inner", if_pre_sampling=1)
    model = seeded_model(cfg)
    b = batch_to_device(pair_batch(NANO), "cpu")
    model(b["label"], b["item1"], b["item2"], deterministic=False,
          rng=StepRandom(0, 1))[3].backward()
    gates = {n: p.grad for n, p in model.named_parameters() if n.startswith("score_")}
    assert len(gates) == 18          # 3 gates x 3 modalities, weight and bias
    for name, g in gates.items():
        assert g is not None and float(g.abs().max()) > 0, name


# ---------------------------------------------------------------- the CLI

@pytest.fixture
def nano_run(tmp_path):
    from k3m_tpu_torch.data import records as trec
    cfg_path = tmp_path / "nano.json"
    cfg_path.write_text(NANO.replace(vocab_size=21128, v_feature_size=8,
                                     v_target_size=7).to_json_string())
    for name, n, seed in (("train", 12, 3), ("valid", 6, 4), ("test", 5, 5)):
        trec.write_records(str(tmp_path / f"{name}_item_alignment.k3mr"), _pairs(n, seed))
    return tmp_path, cfg_path


def _train_args(tmp_path, cfg_path, out, *extra):
    return _finetune_args(tmp_path, cfg_path, "--do_train", "--do_eval", "--output_dir",
                          str(out), "--train_batch_size", "4", "--learning_rate", "1e-3",
                          "--warmup_proportion", "0.3", "--loss_type", "inner",
                          "--if_pre_sampling", "1", "--log_steps", "1", "--seed", "5",
                          *extra)


def test_cli_trains_evaluates_predicts_and_resumes(nano_run):
    """Two epochs with dropout 0.1 and Gumbel draws on the CPU: a checkpoint
    per epoch, the sweep over thresholds 0.1-0.9 after each, one jsonl line
    per test pair from the trained weights; resuming after epoch 0 gives the
    uninterrupted run's parameters bit for bit."""
    from k3m_tpu_torch import finetune
    from k3m_tpu_torch.train.state import CheckpointManager
    tmp_path, cfg_path = nano_run
    out = tmp_path / "full"
    run = finetune.main(_train_args(tmp_path, cfg_path, out, "--num_train_epochs", "2",
                                    "--do_pred"))
    assert [h["epoch"] for h in run["history"]] == [0, 1]
    for h in run["history"]:
        assert h["step_pairs"] == [4, 4, 4]          # 12 pairs, the remainder dropped
        assert all(np.isfinite(x) and x > 0 for x in h["step_losses"])
        assert sorted(h["sweep"]) == [round(0.1 * i, 1) for i in range(1, 10)]
        assert (out / f"epoch_{h['epoch']}" / "state.pt").exists()
    assert json.loads((out / "latest.json").read_text())["epoch"] == 1
    trainer = run["trainer"]
    assert trainer.step == 6 and trainer.sched.last_epoch == 6
    lines = [json.loads(x) for x in open(run["output"], encoding="utf-8")]
    assert len(lines) == 5
    assert all(np.isfinite(json.loads(x["src_item_emb"])).all() for x in lines)

    # resume from epoch 0's checkpoint of the same run
    resume = tmp_path / "resume"
    CheckpointManager(str(resume)).save(CheckpointManager(str(out)).restore(epoch=0), 0)
    again = finetune.main(_train_args(tmp_path, cfg_path, tmp_path / "again",
                                      "--num_train_epochs", "2", "--file_checkpoint",
                                      str(resume)))
    assert [h["epoch"] for h in again["history"]] == [1]
    assert again["history"][0]["step_losses"] == run["history"][1]["step_losses"]
    want = trainer.model.state_dict()
    for k, v in again["trainer"].model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_cli_starts_from_a_state_dict_and_a_checkpoint(nano_run):
    """--file_state_dict starts from a saved model (1e-9 LR: the weights
    stay within a hair of it), --pretrained_model_path with --strict_load
    from a reference checkpoint that lacks the CE head (kept seeded)."""
    from k3m_tpu_torch import finetune
    tmp_path, cfg_path = nano_run
    cfg = torch_config(NANO.replace(vocab_size=21128, v_feature_size=8, v_target_size=7,
                                    loss_type="ce", use_image=True, with_coattention=True))
    sd = build_model(cfg, seed=11, device="cpu", train=True).state_dict()
    torch.save(sd, tmp_path / "state.pt")
    ref = {("bert." + k): v for k, v in sd.items() if not k.startswith("classifier.")}
    torch.save(ref, tmp_path / "ref.bin")
    for extra in (["--file_state_dict", str(tmp_path / "state.pt")],
                  ["--pretrained_model_path", str(tmp_path / "ref.bin"), "--strict_load"]):
        run = finetune.main(_train_args(tmp_path, cfg_path, tmp_path / extra[0][2:],
                                        "--num_train_epochs", "1", "--loss_type", "ce",
                                        "--learning_rate", "1e-9", *extra))
        got = run["trainer"].model.state_dict()
        for k, v in sd.items():
            if extra[0] == "--file_state_dict" or not k.startswith("classifier."):
                torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6, msg=k)
        # every weight at the full LR, as the JAX trainer has it
        assert {g["initial_lr"] for g in run["trainer"].opt.param_groups} == {1e-9}


def test_cli_scores_with_its_own_finetuned_weights(nano_run):
    """Finetune, then score: --do_pred with --file_checkpoint (or with the
    checkpoint's state.pt as --file_state_dict) writes the jsonl that the
    training run wrote from the same weights, not that of the seeded
    model."""
    from k3m_tpu_torch import finetune
    tmp_path, cfg_path = nano_run
    out = tmp_path / "ft"
    run = finetune.main(_train_args(tmp_path, cfg_path, out, "--num_train_epochs", "1",
                                    "--do_pred"))
    want = open(run["output"], encoding="utf-8").read()
    pred = [a for a in _train_args(tmp_path, cfg_path, tmp_path / "pred")
            if a not in ("--do_train", "--do_eval")] + ["--do_pred"]
    seeded = finetune.main(pred)
    assert open(seeded["output"], encoding="utf-8").read() != want
    for extra in (["--file_checkpoint", str(out)],
                  ["--file_state_dict", str(out / "epoch_0" / "state.pt")]):
        got = finetune.main(pred + extra)
        assert "history" not in got
        assert open(got["output"], encoding="utf-8").read() == want, extra[0]


@pytest.mark.parametrize("flag", [["--n_model", "3"], ["WORLD_SIZE", "2"],
                                  ["--n_model", "2"]])
def test_cli_refuses_unported_options_by_name(nano_run, monkeypatch, flag):
    from k3m_tpu_torch import finetune
    tmp_path, cfg_path = nano_run
    argv = _train_args(tmp_path, cfg_path, tmp_path / "out")
    if flag[0] == "WORLD_SIZE":
        # multi-process training is ported (tests/test_torch_dist.py): a
        # WORLD_SIZE is not refused as unported, but one without the rank
        # and the rendezvous that go with it is refused by name
        monkeypatch.setenv("WORLD_SIZE", "2")
        for k in ("RANK", "MASTER_ADDR", "MASTER_PORT", "K3M_COORDINATOR_ADDRESS"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(ValueError, match="WORLD_SIZE is set but RANK"):
            finetune.main(argv)
        return
    # tensor parallelism is ported (tests/test_torch_tp.py), but --n_model
    # must divide every sharded width (NANO's hidden 16; a head count need
    # not divide) and the world (one process)
    for k in ("WORLD_SIZE", "K3M_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    argv += flag
    match = ("--n_model 3 does not divide hidden_size 16" if flag[1] == "3" else
             "--n_model 2 does not divide the world of 1 processes")
    with pytest.raises(ValueError, match=match):
        finetune.main(argv)


def test_cli_runs_on_the_card_by_default(nano_run):
    """Without --device the CLI asks for the CUDA card and, where there is
    none, raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from k3m_tpu_torch import finetune
    tmp_path, cfg_path = nano_run
    argv = [a for a in _train_args(tmp_path, cfg_path, tmp_path / "out")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.main(argv)


# -------------------------------------------------------- staged_prefetch

def test_prefetch_order_and_completeness():
    assert list(staged_prefetch(range(57), lambda x: x * 2, depth=3)) == \
        [x * 2 for x in range(57)]


def test_prefetch_stages_ahead_of_the_consumer():
    staged = []

    def stage(x):
        staged.append(x)
        return x

    gen = staged_prefetch(range(10), stage, depth=4)
    assert next(gen) == 0
    deadline = time.time() + 5.0
    # the queue's 4 and the one waiting to be put stage with no consumer
    while len(staged) < 5 and time.time() < deadline:
        time.sleep(0.01)
    assert len(staged) >= 5
    assert list(gen) == list(range(1, 10))


def test_prefetch_surfaces_loader_and_stage_exceptions():
    def bad_loader():
        yield 1
        raise RuntimeError("loader died")

    gen = staged_prefetch(bad_loader(), lambda x: x, depth=2)
    assert next(gen) == 1
    with pytest.raises(RuntimeError, match="loader died"):
        list(gen)

    def stage(x):
        if x == 3:
            raise ValueError("stage failed")
        return x

    with pytest.raises(ValueError, match="stage failed"):
        list(staged_prefetch(range(10), stage, depth=2))


def test_prefetch_close_stops_the_producer():
    n0 = threading.active_count()
    gen = staged_prefetch(range(1000), lambda x: x, depth=2)
    assert next(gen) == 0
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > n0 and time.time() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= n0


def test_trainer_prefetch_gives_the_staged_batches_in_order():
    """AlignmentTrainer.prefetch yields what stage() makes of each batch,
    in order, bit for bit (on the CPU, with no stream)."""
    cfg = torch_config(NANO.replace(dtype="bfloat16"))
    trainer = AlignmentTrainer(cfg, device="cpu")
    batches = [pair_batch(NANO, seed=s) for s in range(3)]
    got = list(trainer.prefetch(batches))
    assert len(got) == 3
    for g, b in zip(got, batches):
        want = trainer.stage(b)
        assert g["item1"]["image_feat"].dtype == torch.bfloat16      # the fp wire
        assert g["label"].dtype == torch.float32 and g["item1"]["input_ids"].dtype == torch.int64
        for side in ("item1", "item2"):
            assert g[side].keys() == want[side].keys()
            for k in want[side]:
                assert torch.equal(g[side][k], want[side][k]), (side, k)
        assert torch.equal(g["label"], want["label"])
