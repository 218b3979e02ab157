"""Three updates of the port's AlignmentTrainer against the JAX
AlignmentTrainer, on the CPU at NANO shapes, from the same initial weights
on the same pair batches, with dropout 0 and fusion strategy 2 (no draws):
three train steps, and six with gradient accumulation over two (the first
update at LR 0 under the warmup), and three with micro_steps=2: losses
and parameters agree within 1e-3 (tests/test_torch_trainer.py holds the
pretraining trainers so), each tensor's change within 1e-3 of the JAX
change's norm plus 1% of one Adam step over the tensor, and Adam's first
moments within 1e-2 of their norm.
"""

import numpy as np
import pytest
import torch

from k3m_tpu.train.alignment_loop import AlignmentTrainer as JaxTrainer
from k3m_tpu.train.convert import _flatten
from k3m_tpu_torch.convert import from_jax_params
from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer
from tests.conftest import NANO, single_mesh
from tests.test_torch_finetune import NO_DROPOUT, SOFTMAX_SHIFT, pair_batch
from tests.test_torch_modules import torch_config
from tests.test_torch_trainer import assert_adam_moments_match


def _updates_against_jax(cfg, batches, n_updates, **kw):
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, seed=0, **kw)
    jt = JaxTrainer(cfg, mesh=single_mesh(), sample_batch=batches[0], **kw)
    flat = {k: np.array(v) for k, v in _flatten(jt.state.params["params"]).items()}
    init = from_jax_params(flat)
    pt = AlignmentTrainer(torch_config(cfg), device="cpu", **kw)
    pt.model.load_state_dict(init, strict=True)
    for i, batch in enumerate(batches):
        want = float(jt.train_step(batch)[0])
        got = float(pt.train_step(batch)[0])
        assert abs(got - want) <= 1e-3 * max(1.0, abs(want)), (i, got, want)
    flat = {k: np.asarray(v) for k, v in _flatten(jt.state.params["params"]).items()}
    named = dict(pt.model.named_parameters())
    off = total = 0.0
    for name, w in from_jax_params(flat).items():
        got = named[name].detach()
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-3, err_msg=name)
        if SOFTMAX_SHIFT.search(name):
            continue
        d_got, d_want = got - init[name], w - init[name]
        err = float(torch.linalg.vector_norm(d_got - d_want))
        norm = float(torch.linalg.vector_norm(d_want))
        assert err <= 1e-3 * norm + 1e-2 * kw["learning_rate"] * d_want.numel() ** 0.5, name
        off, total = off + err ** 2, total + norm ** 2
    assert total > 0 and off ** 0.5 <= 1e-3 * total ** 0.5
    assert pt.step == len(batches) and pt.sched.last_epoch == n_updates
    assert_adam_moments_match(jt, pt)


@pytest.mark.parametrize("accum", [1, 2])
def test_three_updates_match_jax_trainer(accum):
    cfg = NANO.replace(loss_type="ce", if_pre_sampling=2, **NO_DROPOUT)
    batches = [pair_batch(cfg, seed=s) for s in range(3 * accum)]
    _updates_against_jax(cfg, batches, 3, grad_accum_steps=accum)


def test_micro_steps_updates_match_jax_trainer():
    """micro_steps=2 against the JAX trainer's microbatched step, with no
    draws: the averaged loss, the parameters, and Adam's moments, which
    show a wrong gradient scale that the parameters cannot."""
    cfg = NANO.replace(loss_type="inner", if_pre_sampling=2, **NO_DROPOUT)
    batches = [pair_batch(cfg, seed=s) for s in range(3)]
    _updates_against_jax(cfg, batches, 3, micro_steps=2)
