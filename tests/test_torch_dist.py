"""Data parallelism of the port (k3m_tpu_torch/dist.py, train/dist.py) on
the CPU: two gloo ranks against one process, at MICRO geometry, fp32.

The JAX package's data-parallel step is the one-device step on the global
batch, the ranks' rows in rank order (tests/test_multidevice.py,
tests/test_multihost.py:101-130). Each world of two ranks is started once
per module (`file://` init under tmp_path, so no port is shared between
test workers; a join timeout and a collective timeout on every group, so
that a deadlock fails the test instead of hanging the run), runs every
scenario, and the tests read its results:

  * a pretraining and a finetuning (loss inner and ce) train step, dropout
    on: the global losses and every gradient after the all-reduce equal the
    one-process step on the concatenated batch; once more with zero-pair
    items planted at global rows 0 and 2, so that rank 1's first item
    carries rank 0's last aggregate; every LPM entity draw of 2 of the 3
    other items of a batch of 4 takes one of the other rank's; and in two
    micro slices, against one process on the micro-major order;
  * a pretraining step (NCE, dropout off, every draw injected, a zero-pair
    item at rank 1's first row) against the JAX package's step over a
    2-device data mesh on the same global batch and weights;
  * three AdamW steps leave bit-identical parameters on both ranks;
  * a non-finite gradient on one rank makes both ranks skip the update;
  * SIGTERM delivered to rank 1 alone stops both ranks after the same step
    with rank 0's step checkpoint, and the resumed two-rank run equals the
    uninterrupted one bit for bit;
  * `python -m k3m_tpu_torch.pretrain` and `finetune --do_train --do_eval
    --do_pred` in two ranks through the K3M_* variables: the ranks agree,
    rank 0 alone checkpoints, the sweep equals one process's on the same
    weights, and the predict parts together are one process's dump.

Also here: the loader shards against the JAX package's indices, the
attention masks of a rank's rows (`row0`) against the global mask, and the
launch variables (torchrun's WORLD_SIZE accepted, an --n_model that divides
neither the 8 image heads nor the world refused).
"""

import functools
import json
import multiprocessing as mp
import os
import signal
import traceback

import numpy as np
import pytest
import torch

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model.random import StepRandom
from k3m_tpu_torch import dist
from k3m_tpu_torch.train import dist as train_dist
from k3m_tpu_torch.train.dist import all_reduce_grads
from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer, decode_items
from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
from k3m_tpu_torch.train.state import CheckpointManager

SEED = 3
B = 4                     # the global batch; two ranks of 2 rows
JOIN_TIMEOUT_S = 300      # a world that takes longer has hung
GROUP_TIMEOUT_S = 120     # each collective

# MICRO geometry (tests/conftest.py), dropout at its 0.1 defaults
CFG = K3MConfig(
    vocab_size=128, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=32, v_feature_size=8, v_target_size=7, v_hidden_size=16,
    v_num_hidden_layers=1, v_num_attention_heads=2, v_intermediate_size=16,
    bi_hidden_size=16, bi_num_attention_heads=2, v_biattention_id=(0,),
    t_biattention_id=(1,), max_position_embeddings=32, num_negative_pv=4,
    if_pre_sampling=1)
LOSSES = ("masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv", "loss_struc",
          "next_sentence_loss_t_v_pv", "loss")


# ------------------------------------------------------------------ data

def _item_arrays(rng, n, L=8, Lpv=12, R=4, P=3):
    """One side of n items: ragged masks, 2 valid pairs of P."""
    mask = np.ones((n, L), np.int64)
    mask_pv = np.ones((n, Lpv), np.int64)
    for b in range(n):
        mask[b, L - rng.integers(0, 3):] = 0
        mask_pv[b, Lpv - rng.integers(0, 4):] = 0
    pairs = lambda: np.concatenate([rng.integers(1, Lpv - 4, (n, 2, 2)),
                                    np.zeros((n, P - 2, 2), int)], axis=1)
    return dict(
        input_ids=rng.integers(1, CFG.vocab_size, (n, L)), input_mask=mask,
        segment_ids=np.zeros((n, L), np.int64),
        input_ids_pv=rng.integers(1, CFG.vocab_size, (n, Lpv)), input_mask_pv=mask_pv,
        segment_ids_pv=np.zeros((n, Lpv), np.int64), index_p=pairs(), index_v=pairs(),
        image_feat=rng.normal(size=(n, R + 1, CFG.v_feature_size)).astype(np.float32),
        image_loc=rng.normal(size=(n, R + 1, 5)).astype(np.float32),
        image_mask=np.ones((n, R + 1), np.int64))


def pretrain_batch(seed, n=B, zero_pair_rows=()):
    rng = np.random.default_rng(seed)
    b = _item_arrays(rng, n)
    L, Lpv, R = 8, 12, 4
    b.update(
        lm_label_ids=np.where(rng.random((n, L)) < 0.3,
                              rng.integers(0, CFG.vocab_size, (n, L)), -1),
        lm_label_ids_pv=np.where(rng.random((n, Lpv)) < 0.3,
                                 rng.integers(0, CFG.vocab_size, (n, Lpv)), -1),
        is_next=np.zeros(n, np.int64), is_next_pv_v=np.zeros(n, np.int64),
        is_next_pv_t=np.zeros(n, np.int64),
        image_label=np.where(rng.random((n, R)) < 0.4, 1, -1),
        image_target=np.abs(rng.normal(size=(n, R, CFG.v_target_size))).astype(np.float32))
    for r in zero_pair_rows:
        b["index_p"][r] = 0
        b["index_v"][r] = 0
    return b


def pair_batch(seed, n=B, zero_pair_rows=()):
    rng = np.random.default_rng(seed)
    items = [_item_arrays(rng, n), _item_arrays(rng, n)]
    for it in items:
        for r in zero_pair_rows:
            it["index_p"][r] = 0
            it["index_v"][r] = 0
    return dict(label=(np.arange(n) % 2).astype(np.float32), item1=items[0], item2=items[1])


def rows(batch, rank, size=2):
    """A rank's rows of a (pair) batch."""
    if isinstance(batch, dict):
        return {k: rows(v, rank, size) for k, v in batch.items()}
    n = len(batch) // size
    return batch[rank * n:(rank + 1) * n]


# ------------------------------------------------------------ one step

def pretrain_step(batch, world=None):
    """(global losses, gradients after the all-reduce) of one train step."""
    trainer = PretrainTrainer(CFG, device="cpu", seed=SEED, world=world)
    loss, metrics = trainer.losses(trainer.stage(batch), deterministic=False,
                                   rng=StepRandom(SEED, 0, "cpu"))
    loss.backward()
    all_reduce_grads(trainer.world, trainer.model.parameters())
    metrics = trainer.global_metrics(metrics)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None})


def pretrain_micro_step(batch, world=None):
    """One train step in two micro slices, its update held back
    (grad_accum_steps 2): the global losses and the gradients summed over
    the ranks."""
    trainer = PretrainTrainer(CFG, device="cpu", seed=SEED, world=world, micro_steps=2,
                              grad_accum_steps=2)
    metrics = trainer.train_step(batch)
    all_reduce_grads(trainer.world, trainer.model.parameters())
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None})


def micro_major(batch, ranks=2, micro=2):
    """The global batch as one process's micro slices see an N-rank step:
    micro slice i is every rank's slice i, in rank order."""
    if isinstance(batch, dict):
        return {k: micro_major(v, ranks, micro) for k, v in batch.items()}
    n = len(batch) // (ranks * micro)
    order = [r * micro * n + i * n + j for i in range(micro) for r in range(ranks)
             for j in range(n)]
    return batch[order]


def finetune_step(batch, loss_type, world=None):
    trainer = AlignmentTrainer(CFG.replace(loss_type=loss_type), device="cpu", seed=SEED,
                               world=world)
    b = decode_items(trainer.stage(batch), trainer.config)
    loss = trainer.model(b["label"], b["item1"], b["item2"], deterministic=False,
                         rng=StepRandom(SEED, 0, "cpu"), world=trainer.world)[3]
    loss.backward()
    all_reduce_grads(trainer.world, trainer.model.parameters())
    loss = trainer.global_metrics(dict(loss=loss.detach()))["loss"]
    return ({"loss": float(loss)},
            {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None})


STEP_CASES = {
    "pretrain": lambda w, r: pretrain_step(rows(pretrain_batch(10), r), w),
    "pretrain_carry": lambda w, r: pretrain_step(
        rows(pretrain_batch(11, zero_pair_rows=(0, 2)), r), w),
    "pretrain_micro": lambda w, r: pretrain_micro_step(rows(pretrain_batch(14), r), w),
    "finetune_inner": lambda w, r: finetune_step(rows(pair_batch(12), r), "inner", w),
    "finetune_ce_carry": lambda w, r: finetune_step(
        rows(pair_batch(13, zero_pair_rows=(0, 2)), r), "ce", w),
}
ONE_PROCESS = {
    "pretrain": lambda: pretrain_step(pretrain_batch(10)),
    "pretrain_carry": lambda: pretrain_step(pretrain_batch(11, zero_pair_rows=(0, 2))),
    "pretrain_micro": lambda: pretrain_micro_step(micro_major(pretrain_batch(14))),
    "finetune_inner": lambda: finetune_step(pair_batch(12), "inner"),
    "finetune_ce_carry": lambda: finetune_step(pair_batch(13, zero_pair_rows=(0, 2)), "ce"),
}


# ------------------------------- the JAX package's global-batch step

JAX_LOSSES = ("masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv",
              "next_sentence_loss_t_v_pv", "loss_struc")


@functools.lru_cache(maxsize=1)
def _jax_case():
    """NANO pretraining with NCE (visual_target 2), dropout off, every draw
    injected (LPM entity and value negatives, Gumbel noise, NCE indices,
    all in global rows), a zero-pair item at global row 2 (rank 1's first
    of two ranks); the JAX package's model and redrawn weights."""
    from tests.conftest import NANO
    from tests.test_torch_pretrain_model import _model_inputs, jax_pretraining
    cfg = NANO.replace(if_pre_sampling=1, num_negative_pv=4, visual_target=2)
    batch, inject = _model_inputs(cfg, B=B)
    for key in ("index_p", "index_v"):
        batch[key][2] = 0
    R = batch["image_label"].shape[1]
    inject["neg_image_idx"] = np.random.default_rng(7).integers(
        0, B * R, (B, R, 5)).astype(np.int32)
    jm, params = jax_pretraining(cfg, batch, inject)
    return cfg, batch, inject, jm, params


def _write_jax_case(tmp):
    """What the ranks need of `_jax_case`, without JAX: the port's config,
    the weights through from_jax_params, the batch and the draws."""
    from k3m_tpu.train.convert import _flatten
    from k3m_tpu_torch.convert import from_jax_params
    from tests.test_torch_modules import torch_config
    from tests.test_torch_pretrain_model import _to_torch
    cfg, batch, inject, _, params = _jax_case()
    flat = {k: np.asarray(v) for k, v in _flatten(params["params"]).items()}
    torch.save(dict(cfg=torch_config(cfg), state=from_jax_params(flat),
                    batch=_to_torch(batch), inject=_to_torch(inject)),
               tmp / "jax_case.pt")


def jax_case_step(world, rank, tmp):
    """A rank's step of `_jax_case` on its rows: the global losses and the
    gradients after the all-reduce."""
    from k3m_tpu_torch.model.pretrain import K3MForPretraining
    case = torch.load(os.path.join(tmp, "jax_case.pt"), weights_only=False)
    model = K3MForPretraining(case["cfg"])
    model.load_state_dict(case["state"], strict=True)
    out = model(rows(case["batch"], rank), deterministic=True, world=world,
                **rows(case["inject"], rank))
    sum(out[k] for k in JAX_LOSSES).backward()
    all_reduce_grads(world, model.parameters())
    losses = world.all_reduce_sum(torch.stack([out[k].detach() for k in JAX_LOSSES]))
    return ({k: float(v) for k, v in zip(JAX_LOSSES, losses)},
            {n: p.grad.clone() for n, p in model.named_parameters()})


# -------------------------------------------------------- the scenarios

def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def three_steps(world, rank):
    trainer = PretrainTrainer(CFG, device="cpu", seed=SEED, world=world,
                              learning_rate=1e-3, total_steps=10)
    for s in range(3):
        trainer.train_step(rows(pretrain_batch(20 + s), rank))
    return _params(trainer)


def nonfinite(world, rank):
    """Rank 1's batch holds a NaN feature in the first step."""
    trainer = PretrainTrainer(CFG, device="cpu", seed=SEED, world=world,
                              learning_rate=1e-3, total_steps=10, skip_nonfinite=True)
    before = _params(trainer)
    skipped = []
    for s in range(2):
        batch = rows(pretrain_batch(30 + s), rank)
        if s == 0 and rank == 1:
            batch["image_feat"][0, 1, 0] = np.nan
        skipped.append(float(trainer.train_step(batch)["nonfinite_skipped"]))
        if s == 0:
            unchanged = all(torch.equal(p, before[n]) for n, p in _params(trainer).items())
    return dict(skipped=skipped, unchanged_after_skip=unchanged)


def sigterm(world, rank, tmp):
    """Four steps uninterrupted; then SIGTERM to rank 1 alone after step 2;
    then a run resumed from rank 0's step checkpoint."""
    batches = [rows(pretrain_batch(40 + s), rank) for s in range(4)]

    def trainer():
        return PretrainTrainer(CFG, device="cpu", seed=SEED, world=world,
                               learning_rate=1e-3, total_steps=10)

    full = trainer()
    full.fit(batches, log_steps=0)
    cut = trainer()
    step = cut.train_step

    def step_then_signal(batch):
        out = step(batch)
        if rank == 1 and cut.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    cut.train_step = step_then_signal
    ckpt_dir = os.path.join(tmp, "sigterm_ckpt")
    hist = cut.fit(batches, checkpoint_dir=ckpt_dir, log_steps=1)
    resumed = trainer()
    cm = CheckpointManager(ckpt_dir)
    resumed.load_state_dict(cm.restore())
    meta = cm.latest()
    resumed.fit(batches, start_epoch=int(meta["epoch"]), start_step=int(meta["in_epoch_step"]),
                log_steps=0)
    return dict(last=hist[-1], steps_cut=cut.step, full=_params(full),
                resumed=_params(resumed))


def _cli_env(tmp, rank, size, name):
    os.environ.update(K3M_COORDINATOR_ADDRESS=f"file://{tmp}/{name}",
                      K3M_NUM_PROCESSES=str(size), K3M_PROCESS_ID=str(rank),
                      K3M_DIST_INIT_TIMEOUT=str(GROUP_TIMEOUT_S))


def _world_main(rank, size, tmp, cli_args):
    torch.set_num_threads(2)
    try:
        out = {}
        world = train_dist.init_world(rank, size, f"file://{tmp}/init_model", "cpu",
                                      timeout_s=GROUP_TIMEOUT_S)
        try:
            for name, case in STEP_CASES.items():
                out[name] = case(world, rank)
            out["three_steps"] = three_steps(world, rank)
            out["nonfinite"] = nonfinite(world, rank)
            out["sigterm"] = sigterm(world, rank, tmp)
            out["jax_case"] = jax_case_step(world, rank, tmp)
        finally:
            world.close()
        from k3m_tpu_torch import finetune, pretrain
        _cli_env(tmp, rank, size, "init_pretrain")
        run = pretrain.main(cli_args["pretrain"])
        out["pretrain_cli"] = dict(history=run["history"], world=run["world"],
                                   params=_params(run["trainer"]))
        _cli_env(tmp, rank, size, "init_finetune")
        run = finetune.main(cli_args["finetune"])
        out["finetune_cli"] = dict(history=run["history"], world=run["world"],
                                   output=run["output"], params=_params(run["trainer"]))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_world(target, size, tmp, *args, during=None):
    """Run `target(rank, size, tmp, *args)` in `size` spawned processes,
    and `during()` in this one while they run; fail if one exits non-zero
    or outlives JOIN_TIMEOUT_S."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, size, str(tmp)) + args)
             for r in range(size)]
    for p in procs:
        p.start()
    if during is not None:
        during()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: (tmp / f"rank{r}.err").read_text() for r in range(size)
              if (tmp / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT_S} s; {errors}"
    assert all(p.exitcode == 0 for p in procs), ([p.exitcode for p in procs], errors)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(size)]


# ------------------------------------------------------- the CLI inputs

def _write_cli_inputs(tmp):
    """A NANO-sized config, 8 pretraining records, and 8 training, 6
    validation and 6 test pairs (even counts: two shards lose nothing)."""
    from k3m_tpu_torch.data import records as trec
    from tests.test_torch_data import _item, _pairs
    cfg_path = tmp / "nano.json"
    cfg_path.write_text(CFG.replace(vocab_size=21128, num_hidden_layers=1,
                                    v_biattention_id=(0,), t_biattention_id=(0,))
                        .to_json_string())
    rng = np.random.default_rng(0)
    trec.write_records(str(tmp / "train_feat.k3mr"), [_item(rng, i) for i in range(8)])
    for name, n, seed in (("train", 8, 3), ("valid", 6, 4), ("test", 6, 5)):
        trec.write_records(str(tmp / f"{name}_item_alignment.k3mr"), _pairs(n, seed))
    shapes = ["--max_seq_length", "12", "--max_seq_length_pv", "24", "--max_num_pv", "4",
              "--max_region_length", "5", "--device", "cpu", "--use_image",
              "--with_coattention", "--config_file", str(cfg_path), "--data_dir", str(tmp),
              "--seed", "5", "--log_steps", "1"]
    pretrain_args = shapes + ["--output_dir", str(tmp / "pretrain_out"), "--file_name",
                              "{}_feat.k3mr", "--train_batch_size", "4",
                              "--num_train_epochs", "1"]
    # the carry is order-dependent: without it a pair's embedding does not
    # depend on the batch it is scored in, so one process's dump and the
    # parts can be compared pair by pair
    finetune_eval = shapes + ["--eval_batch_size", "4", "--loss_type", "inner",
                              "--fix_reference_bugs", "--do_eval", "--do_pred"]
    finetune_args = finetune_eval + ["--output_dir", str(tmp / "finetune_out"), "--do_train",
                                     "--train_batch_size", "4", "--learning_rate", "1e-3",
                                     "--num_train_epochs", "1"]
    return dict(pretrain=pretrain_args, finetune=finetune_args,
                finetune_eval=finetune_eval)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    args = _write_cli_inputs(tmp)
    _write_jax_case(tmp)
    ranks = spawn_world(_world_main, 2, tmp, {k: args[k] for k in ("pretrain", "finetune")})
    return tmp, args, ranks


# ------------------------------------------------------------------ tests

def _assert_grads_match(got, want, what):
    assert set(want) <= set(got), what
    for name, g in got.items():
        w = want.get(name, torch.zeros_like(g))     # unreached: zero-filled
        tol = 1e-5 * float(w.abs().max()) + 1e-7
        err = float((g - w).abs().max())
        assert err <= tol, (what, name, err, tol)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_ranks_step_equals_one_process_step(world2, case):
    """The global losses (rtol 1e-5) and every gradient after the
    all-reduce (1e-5 of the tensor's scale + 1e-7) of a two-rank step equal
    the one-process step on the concatenated batch, dropout on; the two
    ranks hold the same."""
    _, _, ranks = world2
    want_losses, want_grads = ONE_PROCESS[case]()
    for rank, out in enumerate(ranks):
        got_losses, got_grads = out[case]
        for k, w in want_losses.items():
            assert abs(got_losses[k] - w) <= 1e-5 * max(1.0, abs(w)), (case, rank, k)
        _assert_grads_match(got_grads, want_grads, (case, rank))
    if case.startswith("pretrain"):
        assert set(want_losses) >= set(LOSSES)
        assert want_losses["loss_struc"] > 0


def test_two_ranks_step_equals_the_jax_data_parallel_step(world2):
    """Two ranks' global losses and all-reduced gradients against the JAX
    package's step over a 2-device data mesh (`shard_batch`: the global
    batch's rows split over the 'data' axis, as the ranks split them), on
    the same global batch, weights and injected draws, with the zero-pair
    carry crossing from rank 0 to rank 1. Tolerances of the one-process
    JAX comparison (test_torch_pretrain_model.py): losses rtol 1e-4; each
    gradient 1e-4 of its tensor's scale + 1e-7."""
    import jax
    from k3m_tpu.train import mesh as mesh_lib
    from k3m_tpu.train.convert import _flatten
    from k3m_tpu_torch.convert import from_jax_params
    _, batch, inject, jm, params = _jax_case()
    mesh = mesh_lib.make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])

    def loss_fn(p, b, inj):
        out = jm.apply(p, b, deterministic=True, **inj)
        return sum(out[k] for k in JAX_LOSSES), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        mesh_lib.shard_params(params, mesh), mesh_lib.shard_batch(batch, mesh),
        mesh_lib.shard_batch(inject, mesh))
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


def test_zero_pair_carry_reads_the_preceding_item():
    """The one-process semantics the `*_carry` cases hold two ranks to:
    with zero-pair items at rows 0 and 2, row 2 (rank 1's first of two
    ranks) takes row 1's aggregate (rank 0's last), so its c_final has a
    gradient in row 1's inputs and none in row 3's."""
    from k3m_tpu_torch.model.structure import StructureAggregator
    torch.manual_seed(0)
    agg = StructureAggregator(CFG.replace(hidden_size=8), with_lpm=False)
    c = torch.randn(4, 8, requires_grad=True)
    seq = torch.randn(4, 6, 8, requires_grad=True)
    idx = torch.tensor([[[1, 2], [3, 3]]] * 4)
    idx[0] = idx[2] = 0
    out, _ = agg(c, seq, idx, idx)
    out[2].sum().backward()
    assert float(seq.grad[1].abs().sum()) > 0 and float(seq.grad[3].abs().sum()) == 0


def test_three_steps_leave_identical_parameters(world2):
    _, _, (r0, r1) = world2
    for name, p in r0["three_steps"].items():
        assert torch.equal(p, r1["three_steps"][name]), name


def test_nonfinite_gradient_on_one_rank_skips_on_both(world2):
    _, _, ranks = world2
    for out in ranks:
        assert out["nonfinite"] == dict(skipped=[1.0, 0.0], unchanged_after_skip=True)


def test_sigterm_on_one_rank_stops_both_and_resumes_exactly(world2):
    tmp, _, (r0, r1) = world2
    for out in (r0, r1):
        assert out["sigterm"]["last"]["preempted_at_step"] == 2
        assert out["sigterm"]["steps_cut"] == 2
        for name, p in out["sigterm"]["full"].items():
            assert torch.equal(out["sigterm"]["resumed"][name], p), name
    assert r0["sigterm"]["last"]["checkpoint_path"].endswith("step_e0_s2")
    assert r1["sigterm"]["last"]["checkpoint_path"] is None     # rank 0 writes
    for name, p in r0["sigterm"]["full"].items():
        assert torch.equal(r1["sigterm"]["full"][name], p), name


def test_pretrain_cli_in_two_ranks(world2):
    """Two steps of 2 + 2 rows from disjoint shards of the 8 records: the
    ranks log the same global losses and end with the same parameters;
    one epoch checkpoint, written by rank 0."""
    tmp, _, (r0, r1) = world2
    (h0,), (h1,) = r0["pretrain_cli"]["history"], r1["pretrain_cli"]["history"]
    assert r0["pretrain_cli"]["world"] == dict(rank=0, size=2, backend="gloo")
    assert h0["step_samples"] == h1["step_samples"] == [2, 2]
    assert h0["step_losses"] == h1["step_losses"]
    assert h0["checkpoint_path"] and h1["checkpoint_path"] is None
    assert json.loads((tmp / "pretrain_out" / "latest.json").read_text())["epoch"] == 0
    for name, p in r0["pretrain_cli"]["params"].items():
        assert torch.equal(r1["pretrain_cli"]["params"][name], p), name


def test_finetune_cli_in_two_ranks_equals_one_process(world2):
    """Both ranks train in step, sweep alike, and write one predict part
    each; one process evaluating and predicting with the checkpoint the
    two ranks wrote gives the same sweep, and its dump holds the parts'
    pairs (ids equal, embeddings within 1e-5)."""
    from k3m_tpu_torch import finetune
    tmp, args, (r0, r1) = world2
    (h0,), (h1,) = r0["finetune_cli"]["history"], r1["finetune_cli"]["history"]
    assert h0["step_pairs"] == h1["step_pairs"] == [2, 2]
    assert h0["step_losses"] == h1["step_losses"]
    assert h0["sweep"] == h1["sweep"]
    assert h1["checkpoint_path"] is None
    for name, p in r0["finetune_cli"]["params"].items():
        assert torch.equal(r1["finetune_cli"]["params"][name], p), name
    one = finetune.main(args["finetune_eval"] + [
        "--output_dir", str(tmp / "one_out"), "--file_checkpoint", str(tmp / "finetune_out")])
    assert one["world"] == dict(rank=0, size=1, backend=None)
    assert one["sweep"] == h0["sweep"]
    parts = [r["finetune_cli"]["output"] for r in (r0, r1)]
    assert [p.endswith(f".part{i}") for i, p in enumerate(parts)] == [True, True]
    lines = lambda path: [json.loads(x) for x in open(path, encoding="utf-8")]
    got = {(x["src_item_id"], x["tgt_item_id"]): x for p in parts for x in lines(p)}
    want = {(x["src_item_id"], x["tgt_item_id"]): x for x in lines(one["output"])}
    assert len(want) == 6 and set(got) == set(want)
    for key, x in want.items():
        for side in ("src_item_emb", "tgt_item_emb"):
            np.testing.assert_allclose(json.loads(got[key][side]), json.loads(x[side]),
                                       rtol=1e-5, atol=1e-6)


# ------------------------------------------------ without a second rank

@pytest.mark.parametrize("num_shards", [2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_shards_equal_the_jax_loader(num_shards, shuffle):
    """`_indices` and `__len__` of every shard of 13 records, two epochs,
    against the JAX package's _LoaderBase."""
    from k3m_tpu.data.pipeline import _LoaderBase as JaxBase
    from k3m_tpu_torch.data.pipeline import _LoaderBase
    for shard in range(num_shards):
        mine, theirs = object.__new__(_LoaderBase), object.__new__(JaxBase)
        mine.reader = range(13)
        theirs.num_dataset = 13
        for obj in (mine, theirs):
            obj.num_shards, obj.shard_index, obj.shuffle, obj.seed = num_shards, shard, shuffle, 7
            obj.batch_size = 2
        for epoch in (0, 1):
            mine.epoch = theirs.epoch = epoch
            np.testing.assert_array_equal(mine._indices(), theirs._indices())
        for drop_last in (False, True):
            mine.drop_last = theirs.drop_last = drop_last
            assert len(mine) == len(theirs)
    with pytest.raises(ValueError):
        from k3m_tpu_torch.data.pipeline import AlignmentLoader
        AlignmentLoader("missing.k3mr", None, num_shards=2, shard_index=2)


def test_row0_masks_are_slices_of_the_global_mask():
    """The Philox keep mask of rows row0..row0+B-1 is that slice of the
    global batch's mask, for both attention wrappers on the CPU; row0 = 0
    gives the mask the kernels had before."""
    from k3m_tpu_torch.kernels import attention, coattn, fused_attention, fused_biattention
    from k3m_tpu_torch.kernels.attention import philox_keep_mask_plain
    whole = philox_keep_mask_plain(11, 6, 2, 5, 37, 0.3, salt=7919)
    for row0 in (0, 2, 5):
        part = philox_keep_mask_plain(11, 6 - row0, 2, 5, 37, 0.3, salt=7919, row0=row0)
        assert torch.equal(part, whole[row0:])
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(6, 5, 2, 64, generator=g) for _ in range(3))
    bias = torch.zeros(6, 5)
    full = fused_attention(q, k, v, bias, dropout_rate=0.2, seed=9)
    half = fused_attention(q[3:], k[3:], v[3:], bias[3:], dropout_rate=0.2, seed=9, row0=3)
    assert torch.equal(half, full[3:])
    _, _, words = attention._forward(q[3:], k[3:], v[3:], bias[3:], 0.2, 9, True, row0=3)
    _, _, words_all = attention._forward(q, k, v, bias, 0.2, 9, True)
    assert torch.equal(words, words_all[3:])
    q2 = torch.randn(6, 7, 2, 64, generator=g)
    bias2 = torch.zeros(6, 7)
    full = fused_biattention(q, k, v, bias, q2, q2, q2, bias2, dropout1=0.2, dropout2=0.1,
                             seed=4)
    half = fused_biattention(q[3:], k[3:], v[3:], bias[3:], q2[3:], q2[3:], q2[3:],
                             bias2[3:], dropout1=0.2, dropout2=0.1, seed=4, row0=3)
    for a, b in zip(half, full):
        assert torch.equal(a, b[3:])
    assert coattn.SALT2 == 7919
    with pytest.raises(ValueError):
        fused_attention(q, k, v, bias, dropout_rate=0.2, seed=9, row0=-1)


def test_launch_variables(monkeypatch, tmp_path):
    """torchrun's variables reach init_world (WORLD_SIZE=2 is accepted);
    WORLD_SIZE without RANK raises; the K3M_* variables give a tcp or an
    init URL; without either the world is one process; both CLIs refuse
    --n_model 3 on the configs' image width of 1024 (a head count need not
    divide, a sharded width must) before any world is made, and
    --n_model 2 in a world of one."""
    from k3m_tpu_torch import finetune, pretrain
    calls = []
    monkeypatch.setattr(train_dist, "init_world", lambda *a: calls.append(a) or "world")
    for k in ("K3M_COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "K3M_DIST_BACKEND", "K3M_DIST_INIT_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)
    one = train_dist.init_from_env("cpu")
    assert (one.size, one.group, one.device) == (1, False, torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        train_dist.init_from_env("cpu")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("K3M_DIST_BACKEND", "gloo")
    assert train_dist.init_from_env("cpu") == "world"
    assert calls[-1] == (1, 2, "env://", torch.device("cpu"), "gloo", 1800.0, 1)
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("K3M_COORDINATOR_ADDRESS", "host0:1234")
    monkeypatch.setenv("K3M_NUM_PROCESSES", "4")
    monkeypatch.setenv("K3M_PROCESS_ID", "3")
    monkeypatch.setenv("K3M_DIST_INIT_TIMEOUT", "60")
    train_dist.init_from_env("cpu")
    assert calls[-1][:3] == (3, 4, "tcp://host0:1234") and calls[-1][-2:] == (60.0, 1)
    monkeypatch.setenv("K3M_COORDINATOR_ADDRESS", f"file://{tmp_path}/x")
    train_dist.init_from_env("cpu")
    assert calls[-1][2] == f"file://{tmp_path}/x"
    args = ["--data_dir", str(tmp_path), "--output_dir", str(tmp_path), "--device", "cpu",
            "--use_image", "--with_coattention"]
    for cli, extra in ((pretrain, ["--file_name", "x"]), (finetune, [])):
        with pytest.raises(ValueError, match="--n_model 3 does not divide "
                                             "v_hidden_size 1024.*Queue 1"):
            cli.main(args + extra + ["--n_model", "3"])
    monkeypatch.delenv("K3M_COORDINATOR_ADDRESS")
    for cli, extra in ((pretrain, ["--file_name", "x"]), (finetune, [])):
        with pytest.raises(ValueError, match="--n_model 2 does not divide the world of 1"):
            cli.main(args + extra + ["--n_model", "2"])
    with pytest.raises(ValueError, match="does not divide the world of 3"):
        dist.World(size=3, n_model=2)
    with pytest.raises(ValueError, match="divisible"):
        dist.World(size=2).local_rows(5, "--train_batch_size")
    assert dist.World(rank=1, size=2).local_rows(6, "--train_batch_size") == 3
    assert len(calls) == 3


def test_world_of_one_is_the_identity():
    """Without a process group every collective returns its input and the
    model's row window is the whole batch."""
    w = dist.World()
    x = torch.arange(6.0).reshape(3, 2)
    assert w.all_gather_rows(x) is x and w.gather_rows(x) is x
    assert w.sum_counts(x) is x and w.all_reduce_sum(x) is x
    assert not w.any_flag(False) and w.any_flag(True)
    assert dist.current().size == 1 and dist.window(3) == (0, 3)
    with dist.use(None, 3):
        assert dist.current().size == 1 and dist.window(3) == (0, 3)
    with dist.use(dist.World(rank=1, size=2), 3):
        assert dist.window(3) == (3, 6)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_pair_mean_keeps_the_bits_of_mean(device):
    """The pair losses divide a sum by the global pair count; in a world of
    one that is `x.mean()` bit for bit (one rank's finetune numbers keep
    their bits), for every batch size up to 256."""
    from k3m_tpu_torch.model.alignment import pair_mean
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    for n in range(1, 257):
        x = (torch.randn(n, generator=g) * (1 + n % 7)).to(device)
        with dist.use(None, n):
            assert torch.equal(pair_mean(x), x.mean()), n


def test_window_refuses_a_leading_size_other_than_the_batch():
    """The dim-0 contract: a draw or gather over the batch reads dim 0 as
    this rank's batch rows, so any other leading size (two items stacked
    into 2B rows) raises, in a world of one as in a world of two; the
    model's forward makes its batch rows the active ones."""
    from k3m_tpu_torch.model import random as k3m_random
    g = torch.Generator().manual_seed(0)
    for world in (None, dist.World(rank=1, size=2)):
        with dist.use(world, 3):
            with pytest.raises(ValueError, match="dim 0 of 6 rows"):
                dist.window(6)
            with pytest.raises(ValueError, match="batch of 3 rows"):
                k3m_random.rows_rand(g, (6, 4), "cpu")
    with dist.use(dist.World(rank=1, size=2), 2):
        part = k3m_random.rows_rand(torch.Generator().manual_seed(5), (2, 4), "cpu")
    whole = torch.rand((4, 4), generator=torch.Generator().manual_seed(5))
    assert torch.equal(part, whole[2:])
