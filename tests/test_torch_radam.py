"""The port's RAdam (k3m_tpu_torch/train/radam.py) and StopOnPlateau
(k3m_tpu_torch/utils/controller.py) against the JAX package's
(k3m_tpu/train/radam.py, k3m_tpu/utils/controller.py).

RAdam: the same gradients, drawn with numpy, through 12 steps of both, so
that both rectification branches run (N_sma < 5 for the first steps at
b2 0.999, the rectified step after), with weight decay 0 and 0.01: the
parameters within 1e-6 after every step. StopOnPlateau: the same metric
sequences through both controllers, every flag and counter equal after
every step.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k3m_tpu.train.radam import radam
from k3m_tpu.utils.controller import StopOnPlateau as JaxStopOnPlateau
from k3m_tpu_torch.train.radam import RAdam
from k3m_tpu_torch.utils.controller import StopOnPlateau

STEPS = 12


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.8, 0.99)])
def test_radam_matches_jax(weight_decay, betas):
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(STEPS)]
    lr = 1e-3
    tx = radam(lr, b1=betas[0], b2=betas[1], eps=1e-8, weight_decay=weight_decay)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = RAdam(tparams.values(), lr=lr, betas=betas, eps=1e-8, weight_decay=weight_decay)
    branches = set()
    for t, g in enumerate(grads, start=1):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        branches.add(RAdam.step_sizes(t, lr, *betas)[1])
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} after step {t}")
    if betas[1] == 0.999:
        assert branches == {False, True}      # both branches ran


def test_radam_state_and_refusals():
    p = torch.nn.Parameter(torch.ones(3))
    opt = RAdam([p], lr=0.1)
    opt.step()                                 # no gradient: nothing moves
    assert torch.equal(p.detach(), torch.ones(3)) and not opt.state
    p.grad = torch.ones(3)
    opt.step()
    assert opt.state[p]["step"] == 1
    # step 1 is the un-adapted branch: p -= lr / (1 - b1) * m, m = 0.1 g
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 0.1 / 0.1 * 0.1, rtol=1e-6)
    for bad in (dict(lr=-1.0), dict(betas=(1.0, 0.9)), dict(weight_decay=-0.1)):
        with pytest.raises(ValueError):
            RAdam([p], **bad)


SEQUENCES = [
    [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.99, 0.5, 0.4, 0.41, 0.42, 0.3, 0.31, 0.32, 0.33],
    [0.5, 0.6, 0.55, 0.7, 0.69, 0.68, 0.67, 0.9, 0.1, 0.2, 0.95, 0.94, 0.93, 0.92, 0.96],
    list(np.random.default_rng(1).random(40)),
]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mode="max", patience=2),
    dict(mode="min", patience=1, threshold_mode="abs", threshold=0.05, cooldown=2),
    dict(mode="max", patience=3, threshold_mode="abs", continue_threshold=0.01, cooldown=1),
    dict(mode="min", patience=0, continue_threshold=0.2),
])
def test_stop_on_plateau_matches_jax(kw):
    for seq in SEQUENCES:
        mine, theirs = StopOnPlateau(**kw), JaxStopOnPlateau(**kw)
        for i, metric in enumerate(seq):
            epoch = i if i % 3 else None
            assert mine.step(metric, epoch) == theirs.step(metric, epoch)
            for attr in ("in_stop", "best", "num_bad_epochs", "cooldown_counter",
                         "last_epoch", "in_cooldown"):
                assert getattr(mine, attr) == getattr(theirs, attr), (kw, i, attr)
    for bad in (dict(mode="median"), dict(threshold_mode="pct")):
        with pytest.raises(ValueError):
            StopOnPlateau(**bad)
