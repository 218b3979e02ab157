"""The port's checkpoint files and run control against the JAX package's, on
the CPU at NANO shapes.

  * the pretrain -> finetune chain: the pretraining CLI's model file
    (`epoch_0/pytorch_model.bin`) starts `finetune --file_state_dict` with
    loss inner, the trunk bit for bit; with loss ce it raises for the
    missing classifier, as the JAX package's load_params_msgpack raises on
    the same weights; a trainer's full state.pt is refused by
    load_pretrained instead of setting no tensor;
  * the 0.1x-LR set: the port's load_pretrained_bert_paths names the
    weights of the JAX package's load_pretrained_bert_paths on the planted
    checkpoints of tests/test_torch_strict_load.py;
  * run control: SIGTERM mid-epoch writes a step checkpoint, and the run
    resumed from it ends bit for bit at the uninterrupted run's parameters
    and optimizer state; save_steps writes the step directories; the CLI
    resumes mid-epoch from one; metrics.jsonl rows carry the JAX rows' keys.
"""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch
from flax import serialization

from k3m_tpu.train.convert import _flatten
from k3m_tpu.train.convert import load_pretrained_bert_paths as jax_bert_paths
from k3m_tpu.train.pretrain_loop import PretrainTrainer as JaxTrainer
from k3m_tpu.train.state import load_params_msgpack
from k3m_tpu_torch.convert import (
    _flax_to_torch, from_jax_params, load_model_file, load_pretrained,
    load_pretrained_bert_paths,
)
from k3m_tpu_torch.model.alignment import build_model
from k3m_tpu_torch.model.pretrain import build_pretraining_model
from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
from k3m_tpu_torch.train.state import CheckpointManager
from tests.conftest import NANO, single_mesh
from tests.test_torch_finetune import jax_params_of
from tests.test_torch_finetune_loop import _train_args
from tests.test_torch_modules import torch_config
from tests.test_torch_pretrain_model import _model_inputs
from tests.test_torch_strict_load import CASES
from tests.test_torch_trainer import _cli_args, _records

N_BATCHES = 5


# ------------------------------------------------- pretrain -> finetune

@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """One NANO pretraining epoch through the port's CLI, and pair records
    for the finetune CLI in the same directory."""
    from k3m_tpu_torch import pretrain
    from k3m_tpu_torch.data import records as trec
    from tests.test_torch_data import _pairs
    tmp = tmp_path_factory.mktemp("chain")
    _records(tmp / "train_feat.k3mr", 8)
    pretrain.main(_cli_args(tmp, "--num_train_epochs", "1"))
    for name, n, seed in (("train", 8, 3), ("valid", 4, 4)):
        trec.write_records(str(tmp / f"{name}_item_alignment.k3mr"), _pairs(n, seed))
    return tmp, tmp / "nano.json", tmp / "out" / "epoch_0"


def test_epoch_checkpoint_writes_the_model_file(pretrained):
    """Beside state.pt, the model alone in reference names; it is
    state.pt's model, tensor for tensor."""
    _, _, epoch_dir = pretrained
    model = torch.load(epoch_dir / "pytorch_model.bin", weights_only=True)
    state = torch.load(epoch_dir / "state.pt", weights_only=True)
    assert model.keys() == state["model"].keys()
    assert "cls.predictions.bias" in model and "optimizer" not in model
    assert all(torch.equal(v, state["model"][k]) for k, v in model.items())


def test_finetune_starts_from_the_pretraining_model_file(pretrained):
    """loss inner: every weight of the alignment model is the file's, bit
    for bit (learning rate 0, so the epoch's updates change nothing), and
    the pretraining heads are ignored; JAX's load_params_msgpack loads the
    same weights into its inner model."""
    from k3m_tpu_torch import finetune
    tmp, cfg_path, epoch_dir = pretrained
    model_file = epoch_dir / "pytorch_model.bin"
    run = finetune.main(_train_args(tmp, cfg_path, tmp / "ft_inner", "--num_train_epochs",
                                    "1", "--learning_rate", "0", "--file_state_dict",
                                    str(model_file)))
    assert all(np.isfinite(run["history"][0]["step_losses"]))
    want = torch.load(model_file, weights_only=True)
    got = run["trainer"].model.state_dict()
    assert set(got) < set(want)
    assert any(k.startswith("cls.") for k in set(want) - set(got))
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    jax_template = {"params": jax_params_of(run["trainer"].model)}
    jax_file = tmp / "params.msgpack"
    pre = build_pretraining_model(torch_config(NANO.replace(
        vocab_size=21128, v_feature_size=8, v_target_size=7)), device="cpu")
    pre.load_state_dict(want)
    jax_file.write_bytes(serialization.to_bytes({"params": jax_params_of(pre)}))
    loaded = load_params_msgpack(jax_template, str(jax_file))
    flat = from_jax_params({k: np.asarray(v) for k, v in _flatten(loaded["params"]).items()})
    assert set(flat) == set(got)
    for k, v in flat.items():
        assert torch.equal(v, want[k]), k


def test_finetune_ce_from_the_pretraining_model_file_raises(pretrained):
    """loss ce needs a classifier the pretraining file lacks: the port and
    JAX's load_params_msgpack both raise ValueError."""
    from k3m_tpu_torch import finetune
    tmp, cfg_path, epoch_dir = pretrained
    model_file = epoch_dir / "pytorch_model.bin"
    with pytest.raises(ValueError, match="classifier"):
        finetune.main(_train_args(tmp, cfg_path, tmp / "ft_ce", "--loss_type", "ce",
                                  "--file_state_dict", str(model_file)))
    cfg = torch_config(NANO.replace(vocab_size=21128, v_feature_size=8, v_target_size=7,
                                    loss_type="ce"))
    pre = build_pretraining_model(cfg, device="cpu")
    pre.load_state_dict(torch.load(model_file, weights_only=True))
    jax_file = tmp / "params_ce.msgpack"
    jax_file.write_bytes(serialization.to_bytes({"params": jax_params_of(pre)}))
    template = {"params": jax_params_of(build_model(cfg, device="cpu", train=True))}
    with pytest.raises(ValueError, match="classifier"):
        load_params_msgpack(template, str(jax_file))


def test_model_file_loader_decides_as_load_params_msgpack(tmp_path):
    """A weight the model needs and the file lacks raises, a shape that
    differs raises, a full state.pt loads through its model entry, extra
    tensors are ignored and returned."""
    cfg = torch_config(NANO.replace(loss_type="inner"))
    model = build_model(cfg, seed=1, device="cpu", train=True)
    sd = build_model(cfg, seed=2, device="cpu", train=True).state_dict()
    torch.save({"model": dict(sd, extra=torch.zeros(3)), "optimizer": {}, "scheduler": {},
                "step": 0, "micro": 0}, tmp_path / "state.pt")
    assert load_model_file(model, str(tmp_path / "state.pt")) == {"extra"}
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    missing = dict(sd)
    missing.pop("struc_w1.weight")
    torch.save(missing, tmp_path / "missing.bin")
    with pytest.raises(ValueError, match="struc_w1.weight"):
        load_model_file(model, str(tmp_path / "missing.bin"))
    torch.save(dict(sd, **{"struc_w1.weight": torch.zeros(2, 2)}), tmp_path / "shape.bin")
    with pytest.raises(ValueError, match="differ in shape"):
        load_model_file(model, str(tmp_path / "shape.bin"))


def test_load_pretrained_refuses_a_full_state(pretrained):
    """A trainer's state.pt is not read as a reference checkpoint (which
    would set no tensor), strict or not."""
    _, _, epoch_dir = pretrained
    model = build_model(torch_config(NANO), device="cpu", train=True)
    for strict in (False, True):
        with pytest.raises(ValueError, match="full state"):
            load_pretrained(model, str(epoch_dir / "state.pt"), strict=strict)
        with pytest.raises(ValueError, match="full state"):
            load_pretrained_bert_paths(str(epoch_dir / "state.pt"))


# ------------------------------------------------------- the 0.1x set

@pytest.mark.parametrize("case", list(CASES))
def test_pretrained_paths_match_jax(tmp_path, case):
    """Every source name reference_to_flat maps, whether or not the model
    has that weight at that shape: the planted [2, 7] NSP head is in both
    sets."""
    make, mutate, _ = CASES[case]
    sd = make()
    if mutate:
        mutate(sd)
    path = str(tmp_path / "ckpt.bin")
    torch.save(sd, path)
    table = _flax_to_torch()
    want = {table[p[len("params/"):]].name for p in jax_bert_paths(path)}
    got = load_pretrained_bert_paths(path)
    assert got == want and got
    if case == "HF cls.seq_relationship":
        assert "cls.seq_relationship.weight" in got


# -------------------------------------------------------- run control

def _trainer():
    cfg = torch_config(NANO.replace(num_negative_pv=4))
    return PretrainTrainer(cfg, device="cpu", learning_rate=1e-3, warmup_steps=0,
                           total_steps=2 * N_BATCHES, seed=5)


def _batches():
    return [_model_inputs(NANO.replace(num_negative_pv=4), seed=100 + i)[0]
            for i in range(N_BATCHES)]


def _assert_same_state(a, b):
    """Parameters, AdamW moments and step, and the trainer's counters, bit
    for bit."""
    assert (a.step, a._micro) == (b.step, b._micro)
    named_b = dict(b.model.named_parameters())
    for name, p in a.model.named_parameters():
        q = named_b[name]
        assert torch.equal(p, q), name
        sa, sb = a.opt.state[p], b.opt.state[q]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), (name, key)
    assert a.sched.state_dict() == b.sched.state_dict()


class SigtermAfter:
    """The batches, raising SIGTERM in this process when the consumer pulls
    batch `at` (a preemption notice arriving while the input pipeline runs
    ahead), as tests/test_preempt_resume.py:44-57 does."""

    def __init__(self, batches, at):
        self.batches, self.at = batches, at

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b


def test_sigterm_checkpoint_and_exact_resume(tmp_path):
    """SIGTERM mid-epoch: fit finishes the step in flight, writes a step
    checkpoint and returns; a new trainer restored from it and resumed at
    that batch ends bit for bit where the uninterrupted run ends, dropout,
    Gumbel and LPM draws included."""
    assert threading.current_thread() is threading.main_thread()
    batches = _batches()
    ref = _trainer()
    ref.fit(batches, num_epochs=1, log_steps=100)

    first = _trainer()
    hist = first.fit(SigtermAfter(batches, at=2), num_epochs=1, log_steps=100,
                     checkpoint_dir=str(tmp_path))
    done = hist[-1]["preempted_at_step"]
    assert 0 < done < N_BATCHES and first.step == done
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL   # handler restored
    cm = CheckpointManager(str(tmp_path))
    assert cm.latest() == {"epoch": 0, "in_epoch_step": done, "dir": f"step_e0_s{done}"}

    second = _trainer()
    second.load_state_dict(cm.restore())
    assert second.step == done
    hist = second.fit(batches, num_epochs=1, start_epoch=0, start_step=done, log_steps=100)
    assert len(hist[0]["step_seconds"]) == N_BATCHES - done
    _assert_same_state(second, ref)


def test_save_steps_writes_step_checkpoints(tmp_path):
    trainer = _trainer()
    trainer.fit(_batches(), num_epochs=1, log_steps=100, checkpoint_dir=str(tmp_path),
                save_steps=2)
    for name in ("step_e0_s2", "step_e0_s4", "epoch_0"):
        assert (tmp_path / name / "state.pt").exists(), name
    assert not (tmp_path / "step_e0_s2" / "pytorch_model.bin").exists()
    # the epoch's checkpoint supersedes the step checkpoints as the resume point
    assert CheckpointManager(str(tmp_path)).latest() == {"epoch": 0, "dir": "epoch_0"}
    assert CheckpointManager(str(tmp_path)).restore()["step"] == N_BATCHES


def test_metrics_jsonl_rows_carry_the_jax_keys(tmp_path):
    """Every log_steps steps one row; its keys those of the JAX trainer's
    rows under the same options (skip_nonfinite adds nonfinite_skipped):
    the JAX MetricsLogger's row of the metrics its train step returns (their
    names from jax.eval_shape of the step, which compiles nothing)."""
    import jax

    from k3m_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
    batches = _batches()[:2]
    jt = JaxTrainer(NANO.replace(num_negative_pv=4), mesh=single_mesh(),
                    sample_batch=batches[0], skip_nonfinite=True, seed=5)
    _, jax_metrics = jax.eval_shape(jt._train_step, jt.state, jt._stage(batches[0]))
    mlog = JaxMetricsLogger(str(tmp_path / "jax"))
    mlog.log(1, {k: 0.0 for k in jax_metrics})
    mlog.close()
    (jax_row,) = [json.loads(x) for x in open(tmp_path / "jax" / "metrics.jsonl")]
    pt = _trainer()
    pt.skip_nonfinite = True
    pt.fit(batches, num_epochs=1, log_steps=1, checkpoint_dir=str(tmp_path / "port"))
    rows = [json.loads(x) for x in open(tmp_path / "port" / "metrics.jsonl")]
    assert [set(r) for r in rows] == [set(jax_row)] * 2
    assert [r["step"] for r in rows] == [1, 2]
    assert all(r["nonfinite_skipped"] == 0.0 and np.isfinite(r["loss"]) for r in rows)


def test_nonfinite_skip_is_logged(caplog):
    trainer = _trainer()
    trainer.skip_nonfinite = True
    bad = dict(_batches()[0])
    bad["image_feat"] = np.full_like(bad["image_feat"], np.inf)
    with caplog.at_level("WARNING"):
        trainer.fit([bad], num_epochs=1, log_steps=1)
    assert "non-finite gradients, update skipped" in caplog.text


def test_cli_resumes_mid_epoch_from_a_step_checkpoint(tmp_path):
    """--save_steps writes a step checkpoint after each batch; a run given
    one of them as --file_checkpoint starts at its batch and ends bit for
    bit where the uninterrupted run ended."""
    from k3m_tpu_torch import pretrain
    _records(tmp_path / "train_feat.k3mr", 12)
    full = pretrain.main(_cli_args(tmp_path, "--num_train_epochs", "1", "--save_steps", "1"))
    out = tmp_path / "out"
    assert all((out / f"step_e0_s{k}" / "state.pt").exists() for k in (1, 2, 3))
    resume = tmp_path / "resume"
    CheckpointManager(str(resume)).save_step(
        torch.load(out / "step_e0_s1" / "state.pt", weights_only=False), 0, 1)
    again = pretrain.main([a if a != str(out) else str(tmp_path / "again")
                           for a in _cli_args(tmp_path, "--num_train_epochs", "1",
                                              "--file_checkpoint", str(resume))])
    (h,) = again["history"]
    assert len(h["step_losses"]) == 2
    assert h["step_losses"] == full["history"][0]["step_losses"][1:]
    _assert_same_state(again["trainer"], full["trainer"])
