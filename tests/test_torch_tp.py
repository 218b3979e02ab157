"""Tensor parallelism of the port (k3m_tpu_torch/train/mesh.py and the
model axis of k3m_tpu_torch/dist.py) on the CPU, at MICRO/NANO geometry,
fp32, over gloo.

The JAX package shows that tensor parallelism is a layout choice: a step
over a (data, model) mesh equals the one-device step
(tests/test_multidevice.py:41-135). The port's model ranks hold slices of
the weights and meet through the model group's collectives, so the same
holds within fp32 reduction order (a row-parallel output is a sum of
partial products in another order). Each world is started once per module,
the two at the same time (`file://` init under tmp_path, join and
collective timeouts as in tests/test_torch_dist.py), and runs every
scenario; the tests read its results:

  * two ranks, `n_model` 2, against one process on the same global batch
    and weights: a pretraining step with dropout on (head-keyed Philox
    masks, dynamic attention's gates), a finetune step for loss inner and
    for ce; each replicated parameter's gradient equal on both ranks before
    the trainer averages it over the model group; the
    vocab-parallel MLM loss and word lookup against `chunked_masked_ce` and
    `nn.Embedding`; SIGTERM and resume bit for bit, and the uninterrupted
    run's gathered AdamW parameters against one process's; the step
    against the JAX package's over a 1 x 2 model mesh; the three CLIs with
    `--n_model 2` through the K3M_* variables;
  * four ranks as data 2 x model 2: a pretraining step whose zero-pair
    carry crosses the data groups; then as one data group of 4 model
    ranks, MICRO's 2 heads replicated on each: a pretraining step.

Without a second rank: the rule table against the JAX package's
`param_spec`, shard/gather round trips at M = 2 and 4, the head-sliced
Philox masks and the kernels' argument checks.
"""

import functools
import json
import os
import re
import signal
import traceback

import numpy as np
import pytest
import torch

from k3m_tpu_torch import dist
from k3m_tpu_torch.model.random import StepRandom
from k3m_tpu_torch.train import dist as train_dist
from k3m_tpu_torch.train import mesh
from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer, decode_items
from k3m_tpu_torch.train.dist import all_reduce_grads
from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
from k3m_tpu_torch.train.state import CheckpointManager
from tests.test_torch_dist import (
    CFG, GROUP_TIMEOUT_S, JAX_LOSSES, SEED, _cli_env, _write_cli_inputs, pair_batch,
    pretrain_batch, rows, spawn_world,
)

# dynamic attention on: the image layers' gates are sliced to the local heads
TP_CFG = CFG.replace(dynamic_attention=True)
# an AdamW step moves a weight by about lr whatever its gradient's size, so a
# gradient that is zero in exact arithmetic (rounding noise in both runs,
# struc_w2.bias) would move apart by 2 lr; eps 1e-4 keeps the update
# continuous in gradients far below the model's
ADAM_EPS = 1e-4
LOSSES = ("masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv", "loss_struc",
          "next_sentence_loss_t_v_pv", "loss")


# ------------------------------------------------------------ the steps

def _grads(model, world):
    """Every gradient, gathered to full shape."""
    full = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        dim = mesh.shard_dim(name)
        full[name] = p.grad.clone() if world is None or world.n_model == 1 or dim is None \
            else mesh.gather_tensor(p.grad, dim, world)
    return full


def _replicated(model):
    """The replicated parameters' gradients as this rank's backward left
    them, before all_reduce_grads averages them over the model group."""
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None and mesh.shard_dim(n) is None}


def pretrain_step(batch, world=None, cfg=TP_CFG):
    """(global losses, gathered gradients, replicated gradients) of one
    pretraining train step, dropout on, the step's own draws."""
    trainer = PretrainTrainer(cfg, device="cpu", seed=SEED, world=world)
    loss, metrics = trainer.losses(trainer.stage(batch), deterministic=False,
                                   rng=StepRandom(SEED, 0, "cpu"))
    loss.backward()
    replicated = _replicated(trainer.model)
    all_reduce_grads(trainer.world, trainer.model.parameters())
    metrics = trainer.global_metrics(metrics)
    return {k: float(v) for k, v in metrics.items()}, _grads(trainer.model, world), replicated


def finetune_step(batch, loss_type, world=None):
    trainer = AlignmentTrainer(TP_CFG.replace(loss_type=loss_type), device="cpu", seed=SEED,
                               world=world)
    b = decode_items(trainer.stage(batch), trainer.config)
    loss = trainer.model(b["label"], b["item1"], b["item2"], deterministic=False,
                         rng=StepRandom(SEED, 0, "cpu"), world=trainer.world)[3]
    loss.backward()
    replicated = _replicated(trainer.model)
    all_reduce_grads(trainer.world, trainer.model.parameters())
    loss = trainer.global_metrics(dict(loss=loss.detach()))["loss"]
    return {"loss": float(loss)}, _grads(trainer.model, world), replicated


STEP_CASES = {
    "pretrain": lambda w, d: pretrain_step(rows(pretrain_batch(10), d, w.data_size), w),
    "finetune_inner": lambda w, d: finetune_step(rows(pair_batch(12), d, w.data_size),
                                                 "inner", w),
    "finetune_ce": lambda w, d: finetune_step(rows(pair_batch(13), d, w.data_size), "ce", w),
}
ONE_PROCESS = {
    "pretrain": lambda: pretrain_step(pretrain_batch(10)),
    "finetune_inner": lambda: finetune_step(pair_batch(12), "inner"),
    "finetune_ce": lambda: finetune_step(pair_batch(13), "ce"),
    "pretrain_carry": lambda: pretrain_step(pretrain_batch(11, zero_pair_rows=(0, 2))),
}


def _params(trainer):
    return {n: p.detach().clone() for n, p in mesh.full_state_dict(
        trainer.model, trainer.world).items()}


def _trainer(world):
    return PretrainTrainer(TP_CFG, device="cpu", seed=SEED, world=world, learning_rate=1e-3,
                           total_steps=10, adam_eps=ADAM_EPS)


def sigterm(world, tmp):
    """Four AdamW steps uninterrupted; the same with SIGTERM to rank 1 alone
    after step 2; a run resumed from rank 0's gathered step checkpoint."""
    batches = [pretrain_batch(40 + s) for s in range(4)]
    full = _trainer(world)
    full.fit(batches, log_steps=0)
    cut = _trainer(world)
    step = cut.train_step

    def step_then_signal(batch):
        out = step(batch)
        if world.rank == 1 and cut.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    cut.train_step = step_then_signal
    ckpt_dir = os.path.join(tmp, "sigterm_ckpt")
    hist = cut.fit(batches, checkpoint_dir=ckpt_dir, log_steps=1)
    resumed = _trainer(world)
    cm = CheckpointManager(ckpt_dir)
    resumed.load_state_dict(cm.restore())
    meta = cm.latest()
    resumed.fit(batches, start_epoch=int(meta["epoch"]), start_step=int(meta["in_epoch_step"]),
                log_steps=0)
    local = {n: p.detach().clone() for n, p in full.model.named_parameters()}
    return dict(last=hist[-1], full=_params(full), resumed=_params(resumed),
                local_full=local, resumed_local={n: p.detach().clone() for n, p in
                                                 resumed.model.named_parameters()})


def vocab_parallel(world):
    """The vocab-parallel MLM loss (every label kind: on either shard,
    ignored; 7 positions in chunks of 3) and word lookup on this rank's
    rows of the table: the loss, and the gradients gathered."""
    from k3m_tpu_torch.model.heads import chunked_masked_ce
    from k3m_tpu_torch.model.layers import BertEmbeddings
    x, table, bias, labels, ids = (t.clone() for t in _vocab_inputs())
    x.requires_grad_(True)
    shard = lambda t: mesh.shard_tensor(t, 0, world).clone().requires_grad_(True)
    t_loc, b_loc = shard(table), shard(bias)
    V = table.shape[0]
    with dist.use(world, x.shape[0]):
        loss = chunked_masked_ce(x, t_loc, b_loc, labels, 3, vocab0=world.model_rank * V // 2,
                                 tp=2)
    loss.backward()
    emb = BertEmbeddings(CFG.replace(vocab_size=V, hidden_size=table.shape[1]))
    emb.word_embeddings.weight.data = t_loc.detach().clone()
    emb.tp, emb.vocab0 = 2, world.model_rank * V // 2
    with dist.use(world, ids.shape[0]):
        rows_ = emb.word(ids)
    (rows_ * torch.arange(rows_.numel()).reshape(rows_.shape).float()).sum().backward()
    return dict(loss=float(loss), dx=x.grad.clone(),
                dtable=mesh.gather_tensor(t_loc.grad, 0, world),
                dbias=mesh.gather_tensor(b_loc.grad, 0, world), rows=rows_.detach().clone(),
                demb=mesh.gather_tensor(emb.word_embeddings.weight.grad, 0, world))


def _vocab_inputs():
    g = torch.Generator().manual_seed(4)
    V, H = 10, 6
    labels = torch.tensor([[1, -1, 7, 4, -1, 9, 0], [-1, 5, 2, -1, 8, 3, -1]])
    return (torch.randn(2, 7, H, generator=g), torch.randn(V, H, generator=g),
            torch.randn(V, generator=g), labels, torch.tensor([[0, 4, 5, 9], [7, 2, 5, 1]]))


@functools.lru_cache(maxsize=1)
def _jax_case():
    """NANO pretraining with NCE (visual_target 2), dropout off, every draw
    injected (LPM negatives, Gumbel noise, NCE indices), a zero-pair item
    at row 2, as tests/test_torch_dist.py's JAX case; the weights are drawn
    in the port (Linear and embedding weights ~ N(0, 1/fan_in), LayerNorm
    scales 1 + N(0, 0.01), other vectors N(0, 0.01)) and carried to the JAX
    package's model by the inverse weight bridge, so no JAX init runs.
    (config, batch, draws, JAX model, flax params, the port's state)."""
    from k3m_tpu.model.pretrain import K3MForPretraining as JaxPretraining
    from k3m_tpu_torch.model.pretrain import K3MForPretraining
    from tests.conftest import NANO
    from tests.test_torch_finetune import jax_params_of
    from tests.test_torch_modules import torch_config
    from tests.test_torch_pretrain_model import _model_inputs
    cfg = NANO.replace(if_pre_sampling=1, num_negative_pv=4, visual_target=2)
    batch, inject = _model_inputs(cfg, B=4)
    for key in ("index_p", "index_v"):
        batch[key][2] = 0
    R = batch["image_label"].shape[1]
    inject["neg_image_idx"] = np.random.default_rng(7).integers(
        0, 4 * R, (4, R, 5)).astype(np.int32)
    port = K3MForPretraining(torch_config(cfg))
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if p.ndim == 2:
                p.copy_(torch.randn(p.shape, generator=g) / p.shape[1] ** 0.5)
            else:
                base = 1.0 if re.search(r"LayerNorm\d?\.weight$", name) else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
    return cfg, batch, inject, JaxPretraining(cfg), jax_params_of(port), port.state_dict()


def _write_jax_case(tmp):
    """What the ranks need of `_jax_case`, without JAX."""
    from tests.test_torch_modules import torch_config
    from tests.test_torch_pretrain_model import _to_torch
    cfg, batch, inject, _, _, state = _jax_case()
    torch.save(dict(cfg=torch_config(cfg), state=state, batch=_to_torch(batch),
                    inject=_to_torch(inject)), tmp / "jax_case.pt")


def jax_case_step(world, tmp):
    """`_jax_case` (dropout off, every draw injected) on a model split over
    the two model ranks: the losses and the gathered gradients."""
    from k3m_tpu_torch.model.pretrain import K3MForPretraining
    case = torch.load(os.path.join(tmp, "jax_case.pt"), weights_only=False)
    model = K3MForPretraining(case["cfg"])
    model.load_state_dict(case["state"], strict=True)
    mesh.shard_model(model, world)
    out = model(case["batch"], deterministic=True, world=world, **case["inject"])
    sum(out[k] for k in JAX_LOSSES).backward()
    return {k: float(out[k]) for k in JAX_LOSSES}, _grads(model, world)


def _legacy_args(tmp):
    """train_concap_struc on the pretraining records of _write_cli_inputs."""
    return ["--data_dir", str(tmp), "--output_dir", str(tmp / "legacy_out"), "--file_name",
            "train_feat.k3mr", "--config_file", str(tmp / "nano.json"), "--device", "cpu",
            "--train_batch_size", "4", "--log_steps", "1", "--seed", "5", "--do_train",
            "--num_train_epochs", "1",
            "--max_seq_length", "12", "--max_seq_length_pv", "24", "--max_num_pv", "4",
            "--max_region_length", "5"]


def _cli_out(run):
    """What the tests read of a CLI run: its history, its predict file and
    this rank's parameters (the CLI has left its world: no gather)."""
    return dict(history=run.get("history"), output=run.get("output"),
                params={n: p.detach().clone() for n, p in
                        run["trainer"].model.named_parameters()})


def _joined(local0, local1):
    """The full parameters of two model ranks' slices; a replicated one must
    be equal on both."""
    out = {}
    for k, p in local0.items():
        dim = mesh.shard_dim(k)
        if dim is None:
            assert torch.equal(local1[k], p), k
            out[k] = p
        else:
            out[k] = torch.cat([p, local1[k]], dim)
    return out


def _world_main(rank, size, tmp, cli_args):
    torch.set_num_threads(1)
    try:
        out = {}
        world = train_dist.init_world(rank, size, f"file://{tmp}/init_model", "cpu",
                                      timeout_s=GROUP_TIMEOUT_S, n_model=2)
        try:
            if size == 4:
                out["pretrain_carry"] = pretrain_step(
                    rows(pretrain_batch(11, zero_pair_rows=(0, 2)), world.data_rank, 2), world)
                world.close()
                # MICRO's 2 heads over 4 model ranks: every attention site replicated
                world = train_dist.init_world(rank, size, f"file://{tmp}/init_model4", "cpu",
                                              timeout_s=GROUP_TIMEOUT_S, n_model=4)
                out["heads_replicated"] = pretrain_step(pretrain_batch(10), world)
            else:
                for name, case in STEP_CASES.items():
                    out[name] = case(world, world.data_rank)
                out["vocab"] = vocab_parallel(world)
                out["sigterm"] = sigterm(world, tmp)
                out["jax_case"] = jax_case_step(world, tmp)
        finally:
            world.close()
        if size == 2:
            from k3m_tpu_torch import finetune, pretrain, train_concap_struc
            for name, mod in (("pretrain", pretrain), ("finetune", finetune),
                              ("legacy", train_concap_struc)):
                _cli_env(tmp, rank, size, f"init_{name}")
                out[f"{name}_cli"] = _cli_out(mod.main(cli_args[name] + ["--n_model", "2"]))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 2-rank and the 4-rank world, run at the same time."""
    tmp, tmp4 = tmp_path_factory.mktemp("tp2"), tmp_path_factory.mktemp("tp4")
    args = _write_cli_inputs(tmp)
    args["finetune"] = args["finetune"] + ["--do_pred"]
    args["legacy"] = _legacy_args(tmp)
    _write_jax_case(tmp)
    four = []
    two = spawn_world(_world_main, 2, tmp, args,
                      during=lambda: four.extend(spawn_world(_world_main, 4, tmp4, {})))
    return (tmp, args, two), four


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[1]


# ------------------------------------------------------------------ tests

def _assert_close(got, want, what, rtol=1e-4):
    """Each tensor within rtol of its reference tensor's scale + 1e-7; a
    gradient the reference lacks is a parameter the loss does not reach,
    which the data group's all-reduce zero-fills."""
    assert set(want) <= set(got), (what, set(want) - set(got))
    for name, g in got.items():
        w = want.get(name, torch.zeros_like(g))
        tol = rtol * float(w.abs().max()) + 1e-7
        err = float((g - w).abs().max())
        assert err <= tol, (what, name, err, tol)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_model_ranks_equal_one_process(world2, case):
    """The losses (rtol 1e-5) and every gradient gathered to full shape
    (1e-4 of its tensor's scale + 1e-7) of a step of two model ranks equal
    the one-process step on the same batch and weights, dropout on; each
    replicated parameter's gradient, as the backward leaves it before the
    model-group average, is equal on both ranks (the conjugate collectives
    make it whole on each)."""
    _, _, ranks = world2
    want_losses, want_grads, _ = ONE_PROCESS[case]()
    for rank, out in enumerate(ranks):
        got_losses, got_grads, _ = out[case]
        for k, w in want_losses.items():
            assert abs(got_losses[k] - w) <= 1e-5 * max(1.0, abs(w)), (case, rank, k)
        _assert_close(got_grads, want_grads, (case, rank))
    r0, r1 = ranks[0][case][2], ranks[1][case][2]
    assert set(r0) == set(r1) and len(r0) > 10
    for name, g in r0.items():
        assert torch.equal(g, r1[name]), (case, name)
    if case == "pretrain":
        assert set(want_losses) >= set(LOSSES) and want_losses["loss_struc"] > 0


def test_data_two_by_model_two_equals_one_process(world4):
    """Four ranks as 2 data groups x 2 model ranks, zero-pair items at
    global rows 0 and 2 (data group 1's first item carries data group 0's
    last aggregate): losses and gathered gradients against one process;
    the model ranks of a data group, and the two data groups, agree."""
    want_losses, want_grads, _ = ONE_PROCESS["pretrain_carry"]()
    for rank, out in enumerate(world4):
        got_losses, got_grads, _ = out["pretrain_carry"]
        for k, w in want_losses.items():
            assert abs(got_losses[k] - w) <= 1e-5 * max(1.0, abs(w)), (rank, k)
        _assert_close(got_grads, want_grads, rank)


def test_heads_that_do_not_divide_n_model_equal_one_process(world4):
    """MICRO's 2 heads (every self- and co-attention site) over 4 model
    ranks: each rank gathers Q/K/V over the model group and runs both heads
    with the one-process Philox masks, the row-parallel output takes its
    columns. The four ranks' losses (rtol 1e-5) and every gathered
    gradient (1e-4 of its tensor's scale + 1e-7) of a step with dropout on
    equal one process's; each replicated parameter's gradient, before the
    model-group average, is equal on all four."""
    mesh.check_model_axis(TP_CFG, 4)             # 2 heads need not divide 4
    want_losses, want_grads, _ = ONE_PROCESS["pretrain"]()
    for rank, out in enumerate(world4):
        got_losses, got_grads, _ = out["heads_replicated"]
        for k, w in want_losses.items():
            assert abs(got_losses[k] - w) <= 1e-5 * max(1.0, abs(w)), (rank, k)
        _assert_close(got_grads, want_grads, ("heads_replicated", rank))
    r0 = world4[0]["heads_replicated"][2]
    for out in world4[1:]:
        for name, g in out["heads_replicated"][2].items():
            assert torch.equal(g, r0[name]), name


def test_vocab_parallel_ce_and_lookup(world2):
    """The vocab-parallel chunked CE (labels on both shards, ignored labels,
    a last chunk of 1 of 3) equals `chunked_masked_ce` over the whole table
    (loss and the gradients of x, table and bias), and the vocab-parallel
    lookup equals `nn.Embedding`, rows and table gradient."""
    from k3m_tpu_torch.model.heads import chunked_masked_ce
    x, table, bias, labels, ids = _vocab_inputs()
    for t in (x, table, bias):
        t.requires_grad_(True)
    loss = chunked_masked_ce(x, table, bias, labels, 3)
    loss.backward()
    emb = torch.nn.Embedding.from_pretrained(table.detach().clone(), freeze=False)
    rows_ = emb(ids)
    (rows_ * torch.arange(rows_.numel()).reshape(rows_.shape).float()).sum().backward()
    _, _, ranks = world2
    for out in ranks:
        assert abs(out["vocab"]["loss"] - loss.item()) <= 1e-6 * abs(loss.item())
        _assert_close({k: out["vocab"][k] for k in ("dx", "dtable", "dbias", "demb")},
                      dict(dx=x.grad, dtable=table.grad, dbias=bias.grad,
                           demb=emb.weight.grad), "vocab", rtol=1e-5)
        assert torch.equal(out["vocab"]["rows"], rows_.detach())


def test_tp_resume_is_bit_for_bit_and_adamw_equals_one_process(world2):
    """SIGTERM to rank 1 alone stops both model ranks after step 2 with rank
    0's step checkpoint, gathered to full shape; the run resumed from it
    (re-split) ends bit for bit at the uninterrupted run's parameters; and
    those, gathered, lie within 1e-4 of each tensor's scale + 1e-7 of one
    process's four AdamW steps on the same batches."""
    tmp, _, (r0, r1) = world2
    for out in (r0, r1):
        s = out["sigterm"]
        assert s["last"]["preempted_at_step"] == 2
        for name, p in s["local_full"].items():
            assert torch.equal(s["resumed_local"][name], p), name
    assert r0["sigterm"]["last"]["checkpoint_path"].endswith("step_e0_s2")
    assert r1["sigterm"]["last"]["checkpoint_path"] is None
    state = CheckpointManager(str(tmp / "sigterm_ckpt")).restore()
    one = _trainer(None)
    assert {k: v.shape for k, v in state["model"].items()} == \
        {k: v.shape for k, v in one.model.state_dict().items()}
    one.fit([pretrain_batch(40 + s) for s in range(4)], log_steps=0)
    _assert_close(r0["sigterm"]["full"], _params(one), "adamw")
    for name, p in r0["sigterm"]["full"].items():
        assert torch.equal(r1["sigterm"]["full"][name], p), name


def test_two_model_ranks_equal_the_jax_model_mesh_step(world2):
    """The two-rank step (dropout off, every draw injected, NCE) against the
    JAX package's step over a 1 x 2 (data, model) mesh, its parameters
    placed by `param_spec`, on the same batch and weights. Tolerances of
    the JAX comparisons: losses rtol 1e-4; each gradient 1e-4 of its
    tensor's scale + 1e-7."""
    import jax
    from k3m_tpu.train import mesh as mesh_lib
    from k3m_tpu.train.convert import _flatten
    from k3m_tpu_torch.convert import from_jax_params
    _, batch, inject, jm, params, _ = _jax_case()
    jmesh = mesh_lib.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])

    def loss_fn(p, b, inj):
        out = jm.apply(p, b, deterministic=True, **inj)
        return sum(out[k] for k in JAX_LOSSES), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        mesh_lib.shard_params(params, jmesh), mesh_lib.shard_batch(batch, jmesh),
        mesh_lib.shard_batch(inject, jmesh))
    want_grads = from_jax_params(
        {k: np.asarray(v) for k, v in _flatten(jax.device_get(grads)["params"]).items()})
    _, _, ranks = world2
    for rank, out in enumerate(ranks):
        got_losses, got_grads = out["jax_case"]
        for k in JAX_LOSSES:
            assert float(want[k]) != 0.0, k
            np.testing.assert_allclose(got_losses[k], float(want[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=(rank, k))
        assert set(got_grads) == set(want_grads)
        for name, g in want_grads.items():
            tol = 1e-4 * float(g.abs().max()) + 1e-7
            np.testing.assert_allclose(got_grads[name].numpy(), g.numpy(), rtol=0,
                                       atol=tol, err_msg=(rank, name))


def test_clis_with_two_model_ranks(world2):
    """`pretrain`, `finetune --do_train --do_eval --do_pred` and
    `train_concap_struc` with --n_model 2 in two ranks: the ranks log the
    same losses and sweep and hold the same gathered parameters; rank 0
    alone writes (checkpoints, the one predict file, hyperparamter.txt);
    each model file has full shapes and loads into a one-process model with
    the gathered parameters bit for bit; one process predicting from the
    finetune checkpoint writes the dump the model ranks wrote (embeddings
    within 1e-5)."""
    from k3m_tpu_torch import finetune
    from k3m_tpu_torch.convert import load_model_file
    from k3m_tpu_torch.model.alignment import build_model
    from k3m_tpu_torch.model.pretrain import build_pretraining_model
    tmp, args, (r0, r1) = world2
    cfg = json.loads((tmp / "nano.json").read_text())
    for name, out_dir, build in (
            ("pretrain", "pretrain_out", build_pretraining_model),
            ("finetune", "finetune_out", functools.partial(build_model, train=True)),
            ("legacy", "legacy_out", build_pretraining_model)):
        (h0,), (h1,) = r0[f"{name}_cli"]["history"], r1[f"{name}_cli"]["history"]
        assert h0["step_losses"] == h1["step_losses"] and len(h0["step_losses"]) == 2, name
        assert h0["checkpoint_path"] and h1["checkpoint_path"] is None, name
        assert h0.get("sweep") == h1.get("sweep")
        params = _joined(r0[f"{name}_cli"]["params"], r1[f"{name}_cli"]["params"])
        from k3m_tpu_torch.config import K3MConfig
        model_cfg = run_config(cfg, name)
        one = build(K3MConfig.from_dict(model_cfg), device="cpu")
        load_model_file(one, str(tmp / out_dir / "epoch_0" / "pytorch_model.bin"))
        for k, v in one.state_dict().items():
            assert torch.equal(v, params[k].to(v.dtype)), (name, k)
    assert (tmp / "legacy_out" / "hyperparamter.txt").exists()
    assert r1["finetune_cli"]["output"] is None
    got = r0["finetune_cli"]["output"]
    assert not got.endswith(".part0")           # one data group: one file
    one = finetune.main(args["finetune_eval"] + [
        "--output_dir", str(tmp / "one_out"), "--file_checkpoint", str(tmp / "finetune_out")])
    lines = lambda path: [json.loads(x) for x in open(path, encoding="utf-8")]
    want = lines(one["output"])
    assert len(want) == 6 and [(x["src_item_id"], x["tgt_item_id"]) for x in lines(got)] == \
        [(x["src_item_id"], x["tgt_item_id"]) for x in want]
    for a, b in zip(lines(got), want):
        for side in ("src_item_emb", "tgt_item_emb"):
            np.testing.assert_allclose(json.loads(a[side]), json.loads(b[side]), rtol=1e-5,
                                       atol=1e-6)


def run_config(cfg: dict, name: str) -> dict:
    """The config each CLI of test_clis_with_two_model_ranks builds its model
    from: the file with the flags' overrides that change parameters."""
    out = dict(cfg, use_image=True, with_coattention=True)
    if name == "finetune":
        out.update(loss_type="inner")
    return out


# ------------------------------------------------ without a second rank

def _flax_specs(model):
    """{port name: JAX param_spec of the same parameter}, through the weight
    bridge's inverse (tests/test_torch_finetune.py `jax_params_of`)."""
    from k3m_tpu.train.mesh import param_spec
    from k3m_tpu_torch.convert import _flax_to_torch
    sd = model.state_dict()
    out = {}
    for path, sym in _flax_to_torch().items():
        if sym.name in sd:
            value = sd[sym.name].numpy()
            out[sym.name] = (param_spec(path, value.T if sym.transposed else value),
                             sym.transposed)
    return out


@pytest.mark.parametrize("model", ["pretrain", "alignment_ce"])
def test_rule_table_is_the_jax_param_spec(model):
    """For every parameter of the port's pretraining and alignment models,
    the dim the rule table splits is the one `k3m_tpu.train.mesh.param_spec`
    gives the same parameter (a kernel's 'model' dim seen through torch's
    [out, in] layout). The port also splits two kinds of tensor that JAX
    keeps replicated, by design: the column-parallel Linears' biases (with
    their weights: the same function) and the MLM decoder bias (tied to the
    split word table)."""
    from k3m_tpu_torch.model.alignment import K3MForItemAlignment
    from k3m_tpu_torch.model.pretrain import K3MForPretraining
    cfg = TP_CFG if model == "pretrain" else TP_CFG.replace(loss_type="ce")
    port = K3MForPretraining(cfg) if model == "pretrain" else K3MForItemAlignment(cfg)
    specs = _flax_specs(port)
    names = [n for n, _ in port.named_parameters()]
    assert set(specs) == set(names)
    kinds = dict(column=0, row=0, vocab=0, replicated=0)
    for name in names:
        spec, transposed = specs[name]
        if tuple(spec) == (None, "model"):
            want = 0 if transposed else 1
        elif tuple(spec) == ("model", None):
            want = 1 if transposed else 0
        else:
            assert tuple(spec) == (), (name, spec)
            want = None
            if name.endswith(".bias") and mesh.shard_dim(name[:-5] + ".weight") == 0:
                want = 0
            if name == "cls.predictions.bias":
                want = 0
        assert mesh.shard_dim(name) == want, (name, spec, transposed)
        kinds["replicated" if want is None else "vocab" if "embeddings" in name
              or "predictions.bias" in name else "column" if want == 0 else "row"] += 1
    assert all(kinds.values()), kinds


@pytest.mark.parametrize("M", [2, 4])
def test_shard_then_gather_round_trips(M):
    """`shard_model` on each of M model ranks, then `full_state_dict` (its
    model-group sum done here over the ranks' buffers, as the all-reduce
    does it) gives back the state bit for bit, and each rank's layers know
    their heads and vocab rows; the optimizer state gathers and cuts alike."""
    from k3m_tpu_torch.model.pretrain import build_pretraining_model
    cfg = TP_CFG.replace(num_attention_heads=4, v_num_attention_heads=4,
                         bi_num_attention_heads=4)
    want = build_pretraining_model(cfg, seed=1, device="cpu").state_dict()
    gathered = {}
    for r in range(M):
        world = dist.World(rank=r, size=M, n_model=M)
        model = mesh.shard_model(build_pretraining_model(cfg, seed=1, device="cpu"), world)
        assert model.encoder.layer[0].attention.self.head0 == r * 4 // M
        assert model.embeddings.vocab0 == model.cls.predictions.vocab0 == r * 128 // M
        assert model.encoder.layer[0].output.dense.parallel == "row"
        local = model.state_dict()
        cut = mesh.local_state_dict(want, world)
        for k, v in local.items():
            assert torch.equal(v, cut[k]), k
            if mesh.shard_dim(k) is None:
                assert torch.equal(v, want[k]), k
        for k, v in mesh.full_state_dict(model, world).items():
            gathered[k] = v if k not in gathered or mesh.shard_dim(k) is None \
                else gathered[k] + v
        moments = dict(state={i: dict(step=torch.tensor(1.0), exp_avg=p.detach() * 2)
                              for i, p in enumerate(model.parameters())}, param_groups=[])
        names = [n for n, _ in model.named_parameters()]
        full = mesh.full_optimizer_state(moments, names, world)
        back = mesh.local_optimizer_state(
            dict(state={i: dict(step=s["step"], exp_avg=want[names[i]] * 2)
                        for i, s in full["state"].items()}, param_groups=[]), names, world)
        for i, s in back["state"].items():
            assert torch.equal(s["exp_avg"], moments["state"][i]["exp_avg"]), names[i]
    assert gathered.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(gathered[k], v), k
    with pytest.raises(ValueError, match="v_intermediate_size 18"):
        mesh.check_model_axis(cfg.replace(v_intermediate_size=18, use_image=True), 4)


def test_heads_that_do_not_divide_and_task_embeddings_layout():
    """At --n_model 8 on the shipped configs' head counts (12 text, 8 image
    and co-attention heads; widths of 8 multiples, cut to size here) the
    text self-attention runs all 12 heads from head 0 on every rank, the
    others their own; the check passes; the task embeddings stay replicated,
    as the JAX package's param_spec keeps them."""
    from k3m_tpu.train.mesh import param_spec
    from k3m_tpu_torch.model.pretrain import build_pretraining_model
    cfg = TP_CFG.replace(hidden_size=96, num_attention_heads=12, intermediate_size=64,
                         v_hidden_size=64, v_num_attention_heads=8, v_intermediate_size=32,
                         bi_hidden_size=64, bi_num_attention_heads=8)
    mesh.check_model_axis(cfg, 8)
    for r in (0, 5):
        model = mesh.shard_model(build_pretraining_model(cfg, seed=1, device="cpu"),
                                 dist.World(rank=r, size=8, n_model=8))
        text = model.encoder.layer[0].attention.self
        assert (text.replicated, text.head0, text.run_heads) == (True, 0, 12)
        image = model.encoder.v_layer[0].attention.self
        assert (image.replicated, image.head0, image.run_heads) == (False, r, 1)
        co = model.encoder.c_layer_pv_t[0].biattention
        assert (co.replicated, co.head0, co.run_heads) == (False, r, 1)
        assert text.query.weight.shape == (96 // 8, 96)
    assert mesh.shard_dim("embeddings.task_embeddings.weight") is None
    assert tuple(param_spec("trunk/embeddings/task_embeddings", np.zeros((20, 4)))) == ()


def test_head_sliced_masks_and_their_checks():
    """The Philox keep mask of heads head0 .. head0 + H - 1 of heads_global
    is that slice of the whole layer's mask (rows and heads together), for
    both attention wrappers on the CPU, outputs and mask words alike; the
    defaults give the mask of before; a negative head0, heads past
    heads_global and a key beyond 2^31 raise."""
    from k3m_tpu_torch.kernels import attention, coattn, fused_attention, fused_biattention
    from k3m_tpu_torch.kernels.attention import philox_keep_mask_plain
    whole = philox_keep_mask_plain(11, 6, 4, 5, 37, 0.3, salt=7919)
    assert torch.equal(whole, philox_keep_mask_plain(11, 6, 4, 5, 37, 0.3, salt=7919,
                                                     head0=0, heads_global=4))
    for row0, head0, H in ((0, 2, 2), (3, 1, 2), (5, 3, 1), (2, 0, 4)):
        part = philox_keep_mask_plain(11, 6 - row0, H, 5, 37, 0.3, salt=7919, row0=row0,
                                      head0=head0, heads_global=4)
        assert torch.equal(part, whole[row0:, head0:head0 + H]), (row0, head0, H)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(6, 5, 4, 64, generator=g) for _ in range(3))
    bias = torch.zeros(6, 5)
    full = fused_attention(q, k, v, bias, dropout_rate=0.2, seed=9)
    for row0, head0 in ((0, 2), (3, 1)):
        part = fused_attention(q[row0:, :, head0:head0 + 2], k[row0:, :, head0:head0 + 2],
                               v[row0:, :, head0:head0 + 2], bias[row0:], dropout_rate=0.2,
                               seed=9, row0=row0, head0=head0, heads_global=4)
        assert torch.equal(part, full[row0:, :, head0:head0 + 2])
    _, _, words = attention._forward(q[:, :, 2:], k[:, :, 2:], v[:, :, 2:], bias, 0.2, 9, True,
                                     head0=2, heads_global=4)
    _, _, words_all = attention._forward(q, k, v, bias, 0.2, 9, True)
    assert torch.equal(words, words_all[:, 2:])
    q2 = torch.randn(6, 7, 4, 64, generator=g)
    bias2 = torch.zeros(6, 7)
    full = fused_biattention(q, k, v, bias, q2, q2, q2, bias2, dropout1=0.2, dropout2=0.1,
                             seed=4)
    h = slice(2, 4)
    part = fused_biattention(q[:, :, h], k[:, :, h], v[:, :, h], bias, q2[:, :, h],
                             q2[:, :, h], q2[:, :, h], bias2, dropout1=0.2, dropout2=0.1,
                             seed=4, head0=2, heads_global=4)
    for a, b in zip(part, full):
        assert torch.equal(a, b[:, :, h])
    assert coattn.SALT2 == 7919
    for fn, args in ((fused_attention, (q, k, v, bias)),
                     (fused_biattention, (q, k, v, bias, q2, q2, q2, bias2))):
        for kw, match in ((dict(head0=-1), "head0 -1 < 0"),
                          (dict(head0=1, heads_global=4), "beyond heads_global 4"),
                          (dict(row0=2 ** 28, heads_global=8), "beyond 2\\^31")):
            with pytest.raises(ValueError, match=match):
                fn(*args, seed=1, **kw)


def test_world_axes():
    """The (data, model) grid is JAX's reshape(n_data, n_model): rank r is
    data index r // M and model index r % M; the batch semantics read the
    data axis."""
    w = dist.World(rank=5, size=8, n_model=2)
    assert (w.data_rank, w.data_size, w.model_rank) == (2, 4, 1)
    assert w.local_rows(16, "--train_batch_size") == 4
    with dist.use(w, 4):
        assert dist.window(4) == (8, 16)
    with pytest.raises(ValueError, match="not divisible by the 4 data groups"):
        w.local_rows(6, "--train_batch_size")
    with pytest.raises(ValueError, match="sharded over 2 model ranks runs in a world of 1"):
        dist.copy_to_model(torch.ones(2), 2)
    assert re.search("Queue 1", str(pytest.raises(ValueError, mesh.check_model_axis,
                                                  TP_CFG.replace(vocab_size=127), 2).value))
