"""Pretraining CLI of the PyTorch port.

    python -m k3m_tpu_torch.pretrain --data_dir D --output_dir O \\
        --file_name '{}_feat.k3mr' --use_image --with_coattention --bf16 \\
        [--device cpu]

Flag-compatible with the root `pretrain.py` (its :24-113; behaviour
:116-268): the same config search order (output_dir, data_dir, the
package's configs/, the literal path), the same flag overrides of the
config, `PretrainLoader` batches (native producer unless
K3M_NATIVE_PREPROCESS=0) or the grain backend's into `PretrainTrainer`,
per-epoch checkpoints (`state.pt` and the model-only `pytorch_model.bin`)
in `--output_dir`, step checkpoints every `--save_steps` batches and on
SIGTERM, and resume with `--file_checkpoint` from an epoch or mid-epoch, as root
`pretrain.py:241-262`. Runs on the CUDA device unless `--device cpu` is
given. Without `--pretrained_model_path` the weights are random from
`--seed`. Every option of the root CLI parses, with its default; the
reference's no-op flags (`--apex_fast`, `--cache`, `--do_lower_case`,
`--loss_scale`, `--on_memory`, `--pretrained_model_weights`) have no
effect, `--no_cuda` is `--device cpu`. `--data_backend grain` (or `auto`
on an .array_record train file with `--num_workers` above 0) trains from
`GrainPretrainLoader` (data/grain_pipeline.py: grain's sampler order,
`--num_workers` worker processes, the native producer where a same-content
.k3mr sibling exists); otherwise `PretrainLoader` reads the train file, a
.k3mr or an .array_record. Validation is always `PretrainLoader`'s.

Data parallelism: launched as N processes, one per card, by torchrun

    torchrun --nproc_per_node N -m k3m_tpu_torch.pretrain ...

or with the JAX package's K3M_COORDINATOR_ADDRESS / K3M_NUM_PROCESSES /
K3M_PROCESS_ID (train/dist.py), each rank runs on cuda:LOCAL_RANK with
`--train_batch_size / N` rows of a shard of the records, and a step is the
one-process step on the global batch (root pretrain.py:168-199).

Tensor parallelism: `--n_model M` lays the N ranks out as N / M data
groups of M consecutive model ranks (k3m_tpu/train/mesh.py:30-38); the
model ranks of a data group read the same `--train_batch_size / (N / M)`
rows and each holds 1 / M of the Q/K/V and FFN columns and of the vocab,
and runs 1 / M of the heads of a layer whose heads M divides, every head
of one whose heads it does not (train/mesh.py). On N cards:

    torchrun --nproc_per_node N -m k3m_tpu_torch.pretrain --n_model M ...

Ranks that share one card run over gloo (NCCL refuses two ranks on one
device): K3M_COORDINATOR_ADDRESS=127.0.0.1:<port> K3M_NUM_PROCESSES=N
K3M_PROCESS_ID=r K3M_DIST_BACKEND=gloo per rank. `--n_model` must divide N
and every sharded width and the vocab; otherwise the run raises by name.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

CONFIG_DIR = Path(__file__).resolve().parent / "configs"


def get_parser():
    p = argparse.ArgumentParser(prog="python -m k3m_tpu_torch.pretrain")
    p.add_argument("--data_dir", required=True, type=str)
    p.add_argument("--output_dir", required=True, type=str)
    p.add_argument("--file_name", required=True, type=str,
                   help="template, e.g. '{}_feat.k3mr'")
    p.add_argument("--model_name", default="hfl/chinese-roberta-wwm-ext", type=str)
    p.add_argument("--pretrained_model_path", default=None, type=str,
                   help="reference torch checkpoint (.bin); its weights train at 0.1x LR")
    p.add_argument("--config_file", default="k3m_roberta_base.json", type=str)
    p.add_argument("--pretrained_model_weights", default=None, type=str,
                   help="accepted, as the root CLI accepts it; no effect")
    p.add_argument("--file_checkpoint", default="", type=str,
                   help="checkpoint dir to resume the full state from")
    p.add_argument("--file_state_dict", default="", type=str,
                   help="a model file the port wrote (a checkpoint's pytorch_model.bin or "
                        "state.pt) to start from; its tensors the model lacks are ignored")
    p.add_argument("--strict_load", action="store_true",
                   help="fail if a checkpoint tensor is not consumed (as the JAX "
                        "package's strict load decides)")
    p.add_argument("--fix_reference_bugs", action="store_true")
    p.add_argument("--skip_nonfinite", action="store_true")
    p.add_argument("--save_steps", default=0, type=int,
                   help="also checkpoint the full state every N batches (step_e<E>_s<N>)")
    p.add_argument("--log_steps", default=10, type=int)
    p.add_argument("--cache", default=5000, type=int,
                   help="accepted, as the root CLI accepts it; no effect")
    p.add_argument("--use_image", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--no_cuda", action="store_true", help="same as --device cpu")
    p.add_argument("--train_batch_size", default=96, type=int)
    p.add_argument("--eval_batch_size", default=96, type=int)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--num_train_epochs", default=5.0, type=float)
    p.add_argument("--start_epoch", default=0, type=float)
    p.add_argument("--num_workers", default=2, type=int,
                   help="read by --data_backend auto: grain for an .array_record train "
                        "file when above 0, as the root CLI decides")
    p.add_argument("--data_backend", default="auto", choices=["auto", "k3mr", "grain"])
    p.add_argument("--if_pre_sampling", default=1, type=int)
    p.add_argument("--with_coattention", action="store_true",
                   help="accepted, as the root CLI accepts it; the config decides")
    p.add_argument("--objective", default=2, type=int)
    p.add_argument("--freeze", default=-1, type=int)
    p.add_argument("--on_memory", action="store_true",
                   help="accepted, as the root CLI accepts it; no effect")
    p.add_argument("--warmup_proportion", default=0.1, type=float)
    p.add_argument("--gradient_accumulation_steps", default=1, type=int)
    p.add_argument("--micro_steps", default=1, type=int)
    p.add_argument("--device_cache", action="store_true",
                   help="keep the first epoch's staged batches on the card and replay "
                        "them in later epochs (static masking; K3M_DEVICE_CACHE=1)")
    p.add_argument("--wire", default=None, choices=["fp", "int8", "exact"],
                   help="host->card form of the image tensors; default K3M_WIRE, else fp")
    p.add_argument("--no_remat", action="store_true",
                   help="accepted; the port keeps every activation")
    p.add_argument("--adam_epsilon", default=1e-8, type=float)
    p.add_argument("--loss_img_weight", default=1.0, type=float)
    p.add_argument("--fp16", action="store_true", help="same as --bf16")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--apex_fast", action="store_true",
                   help="accepted, as the root CLI accepts it; no effect")
    p.add_argument("--loss_scale", default=0, type=float,
                   help="accepted, as the root CLI accepts it; no effect (bf16 needs none)")
    p.add_argument("--do_lower_case", default=True, type=bool,
                   help="accepted, as the root CLI accepts it; the tokenizer lower-cases")
    p.add_argument("--max_seq_length", default=50, type=int)
    p.add_argument("--max_seq_length_pv", default=256, type=int)
    p.add_argument("--max_num_pv", default=30, type=int)
    p.add_argument("--num_negative_pv", default=4, type=int)
    p.add_argument("--margin", default=1.0, type=float)
    p.add_argument("--max_region_length", default=36, type=int)
    p.add_argument("--dynamic_attention", action="store_true")
    p.add_argument("--visual_target", default=0, type=int)
    p.add_argument("--num_negative_image", default=255, type=int)
    p.add_argument("--n_model", default=1, type=int)
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted; the port always runs its own kernels")
    p.add_argument("--shared_prefix", action="store_true")
    p.add_argument("--vocab_file", default=None, type=str)
    p.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    return p


def data_backend(args, train_path: str) -> str:
    """"grain" or "k3mr": `--data_backend`, where `auto` picks grain for an
    .array_record train file with `--num_workers` above 0, as root
    pretrain.py:174-177 picks it. A parser without the flag (the legacy
    CLI's) reads through PretrainLoader, which takes either format."""
    backend = getattr(args, "data_backend", "k3mr")
    if backend == "auto":
        backend = ("grain" if train_path.endswith(".array_record") and args.num_workers > 0
                   else "k3mr")
    return backend


def find_config(args) -> Path:
    for c in (Path(args.output_dir) / args.config_file,
              Path(args.data_dir) / args.config_file,
              CONFIG_DIR / args.config_file, Path(args.config_file)):
        if c.exists():
            return c
    raise FileNotFoundError(f"config {args.config_file} not found")


def parse_args(argv=None):
    """The parsed flags, `--no_cuda` read as `--device cpu`."""
    args = get_parser().parse_args(argv)
    if args.no_cuda:
        args.device = "cpu"
    return args


def main(argv=None):
    args = parse_args(argv)
    from k3m_tpu_torch.train import dist, mesh

    config = resolve_config(args)
    mesh.check_model_axis(config, args.n_model)
    world = dist.init_from_env(args.device, args.n_model)
    try:
        return _run(args, world, config)
    finally:
        world.close()


def resolve_config(args):
    """The config file with the flags' overrides (root pretrain.py:116-140)."""
    from k3m_tpu_torch.config import K3MConfig
    config = K3MConfig.from_json_file(str(find_config(args)))
    overrides = dict(
        if_pre_sampling=args.if_pre_sampling, objective=args.objective,
        dynamic_attention=args.dynamic_attention, visual_target=args.visual_target,
        num_negative_image=args.num_negative_image,
        num_negative_pv=args.num_negative_pv, margin=args.margin,
        use_image=args.use_image,
        dtype="bfloat16" if (args.fp16 or args.bf16) else "float32",
        shared_prefix=args.shared_prefix, fix_reference_bugs=args.fix_reference_bugs,
        model="roberta" if "roberta" in (args.model_name or "") else "bert")
    if args.visual_target != 0:
        overrides["v_target_size"] = config.v_feature_size
    if args.freeze > -1:
        overrides["fixed_t_layer"] = args.freeze
    return config.replace(**overrides)


def _run(args, world, config):
    def path(split):
        name = args.file_name.format(split) if "{}" in args.file_name else args.file_name
        return os.path.join(args.data_dir, name)

    valid = path("valid") if args.do_eval and os.path.exists(path("valid")) else None
    return run_pretraining(args, config, world, path("train"), valid,
                           save_steps=args.save_steps or None)


def run_pretraining(args, config, world, train_path: str, valid_path=None, *,
                    do_train: bool = True, save_steps=None) -> dict:
    """What both pretraining CLIs (this one and `train_concap_struc`) do
    alike, on the flags their parsers share: the loaders (each rank's rows
    of the global batch from its shard of the records; validation on
    `valid_path` where given), the step counts (steps_per_epoch =
    max(batches // gradient_accumulation_steps, 1), warmup the proportion
    of int(steps_per_epoch * epochs)), the model from `--seed`, the loads
    (`--pretrained_model_path` with its 0.1x-LR set, `--file_state_dict`),
    the trainer (which splits the loaded model over the model ranks under
    `--n_model`), resume from `--file_checkpoint` (an epoch, or mid-epoch
    from a step checkpoint), then `fit` with a checkpoint per epoch in
    `--output_dir`. Without `do_train`, the mean of each loss of
    `eval_step` over the validation loader instead (`eval`). Returns
    {history, eval, trainer, producer, loader (the train loader's class
    name), resumed, world}."""
    from k3m_tpu_torch.convert import (
        load_model_file, load_pretrained, load_pretrained_bert_paths,
    )
    from k3m_tpu_torch.data.pipeline import PretrainLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.model.pretrain import build_pretraining_model
    from k3m_tpu_torch.tokenization import get_tokenizer
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    from k3m_tpu_torch.train.state import CheckpointManager

    device = world.device
    os.makedirs(args.output_dir, exist_ok=True)
    tokenizer = get_tokenizer(args.vocab_file, config.vocab_size)
    shapes = ShapeSpec(max_seq_len=args.max_seq_length,
                       max_seq_len_pv=args.max_seq_length_pv,
                       max_num_pv=args.max_num_pv,
                       max_region_len=args.max_region_length,
                       v_feature_size=config.v_feature_size,
                       v_target_size=config.v_target_size)

    # each data group's rows of the global batch, from its shard of the records
    shard = dict(num_shards=world.data_size, shard_index=world.data_rank)
    local_rows = world.local_rows(args.train_batch_size, "--train_batch_size")
    if data_backend(args, train_path) == "grain":
        # grain's sampler order, sharded by data rank; batches byte for byte
        # the per-record path's at any --num_workers
        from k3m_tpu_torch.data.grain_pipeline import GrainPretrainLoader
        train_loader = GrainPretrainLoader(
            train_path, tokenizer, shapes, batch_size=local_rows, shuffle=True,
            seed=args.seed, visual_target=args.visual_target, num_workers=args.num_workers,
            shard_index=world.data_rank, shard_count=world.data_size)
    else:
        train_loader = PretrainLoader(train_path, tokenizer, shapes, batch_size=local_rows,
                                      shuffle=True, seed=args.seed,
                                      visual_target=args.visual_target, **shard)
    val_loader = None
    if valid_path is not None:
        val_loader = PretrainLoader(valid_path, tokenizer, shapes,
                                    batch_size=max(args.eval_batch_size // world.data_size,
                                                   1),
                                    shuffle=False, seed=args.seed,
                                    visual_target=args.visual_target, **shard)

    logger.info("train loader: %s, %s producer%s", type(train_loader).__name__,
                train_loader.producer,
                f" ({train_loader.native_error})" if train_loader.native_error else "")
    steps_per_epoch = max(len(train_loader) // args.gradient_accumulation_steps, 1)
    total_steps = int(steps_per_epoch * args.num_train_epochs)
    model = build_pretraining_model(config, seed=args.seed, device=device)
    pretrained = None
    if args.pretrained_model_path:
        # every weight the checkpoint maps trains at 0.1x the LR, as root
        # pretrain.py:206-209 takes it (load_pretrained_bert_paths)
        pretrained = load_pretrained_bert_paths(args.pretrained_model_path)
        load_pretrained(model, args.pretrained_model_path, strict=args.strict_load)
    if args.file_state_dict:
        load_model_file(model, args.file_state_dict)
    trainer = PretrainTrainer(
        config, learning_rate=args.learning_rate,
        warmup_steps=int(args.warmup_proportion * total_steps),
        total_steps=total_steps, grad_accum_steps=args.gradient_accumulation_steps,
        micro_steps=args.micro_steps, adam_eps=args.adam_epsilon,
        loss_img_weight=args.loss_img_weight,
        objective=args.objective, seed=args.seed, wire=args.wire,
        device_cache=args.device_cache or None,
        skip_nonfinite=args.skip_nonfinite, pretrained=pretrained, model=model,
        world=world)

    start_epoch, start_step, resumed = int(args.start_epoch), 0, None
    if args.file_checkpoint:
        # full state of an epoch or of a step checkpoint (save_steps or
        # preemption); a step checkpoint resumes mid-epoch
        t_restore = time.perf_counter()
        cm = CheckpointManager(args.file_checkpoint)
        state = cm.restore(map_location=device)
        if state is not None:
            trainer.load_state_dict(state)
            meta = cm.latest()
            if "in_epoch_step" in meta:
                start_epoch, start_step = int(meta["epoch"]), int(meta["in_epoch_step"])
            else:
                start_epoch = int(meta["epoch"]) + 1
            resumed = dict(epoch=start_epoch, step=start_step,
                           seconds=time.perf_counter() - t_restore)
            logger.info("resumed from %s at epoch %d step %d (%.2f s)", args.file_checkpoint,
                        start_epoch, start_step, resumed["seconds"])

    out = dict(history=None, eval=None, trainer=trainer, producer=train_loader.producer,
               loader=type(train_loader).__name__, resumed=resumed,
               world=dict(rank=world.rank, size=world.size, backend=world.backend))
    if do_train:
        out["history"] = trainer.fit(train_loader, val_loader,
                                     num_epochs=int(args.num_train_epochs),
                                     start_epoch=start_epoch, start_step=start_step,
                                     log_steps=args.log_steps, save_steps=save_steps,
                                     checkpoint_dir=args.output_dir)
        logger.info("training history: %s", [
            {k: v for k, v in h.items() if not k.startswith("step_")}
            for h in out["history"]])
    elif val_loader is not None:
        vals = [{k: float(v) for k, v in trainer.eval_step(b).items()} for b in val_loader]
        out["eval"] = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
        logger.info("eval: %s", out["eval"])
    return out


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-4s [%(filename)s:%(lineno)s]  %(message)s",
        datefmt="%Y/%m/%d %H:%M:%S", level=logging.INFO)
    main()
