"""Item-alignment finetune / eval / predict CLI of the PyTorch port.

    python -m k3m_tpu_torch.finetune --data_dir D --output_dir O \\
        --use_image --with_coattention --do_train --do_eval --bf16 \\
        --loss_type inner --if_pre_sampling 1 --train_batch_size 32 [--device cpu]

Flag-compatible with the root `finetune.py` (its :22-115, behaviour
:116-243): the record files (`--file_train/valid/test`, or `--file_name`'s
split pattern), the config overrides, `AlignmentLoader` batches (the train
loader shuffled from `--seed` and dropping the remainder, the eval and test
loaders keeping it) into `AlignmentTrainer`, the step count and warmup as
the root CLI computes them, per-epoch checkpoints and the threshold sweep in
`--output_dir`; `--file_checkpoint` resumes training's full state, or gives
eval and predict its weights. Runs on the CUDA device unless `--device cpu`
is given. Without `--pretrained_model_path`, `--file_state_dict` or
`--file_checkpoint` the weights are random from `--seed`. Flags the JAX package accepts only for parity are accepted with
no effect; options the port does not have yet are refused by name
(ROADMAP.md Queue 1).

Data parallelism: launched as N processes, one per card, by torchrun

    torchrun --nproc_per_node N -m k3m_tpu_torch.finetune ...

or with the JAX package's K3M_COORDINATOR_ADDRESS / K3M_NUM_PROCESSES /
K3M_PROCESS_ID (train/dist.py), each rank runs on cuda:LOCAL_RANK over a
shard of each record file with `--train_batch_size / N` training pairs
(`--eval_batch_size / N`, at least 1, for eval and predict), as root
finetune.py:160-171 splits them; the sweep is over every rank's pairs and
predict writes `<jsonl>.part<rank>` per rank.

Tensor parallelism: `--n_model M` splits the model over M consecutive
ranks of each data group (train/mesh.py; launch and rules as in
k3m_tpu_torch/pretrain.py); the batches split over the N / M data groups,
and predict writes one `<jsonl>.part<data index>` per data group (none
where N = M: the one file), from the group's model rank 0.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)

CONFIG_DIR = Path(__file__).resolve().parent / "configs"


def get_parser():
    p = argparse.ArgumentParser(prog="python -m k3m_tpu_torch.finetune")
    p.add_argument("--data_dir", required=True, type=str)
    p.add_argument("--output_dir", required=True, type=str)
    p.add_argument("--file_train", default="train_item_alignment.k3mr", type=str)
    p.add_argument("--file_valid", default="valid_item_alignment.k3mr", type=str)
    p.add_argument("--file_test", default="test_item_alignment.k3mr", type=str)
    p.add_argument("--file_name", default=None, type=str,
                   help="record-name pattern, e.g. '{}_item_alignment.k3mr'; "
                        "overrides --file_train/valid/test")
    p.add_argument("--model_name", default="bert-base-chinese", type=str)
    p.add_argument("--config_file", default="bert_base_6layer_6conect.json", type=str)
    p.add_argument("--pretrained_model_path", default=None, type=str,
                   help="reference or HF torch checkpoint (.bin) to start from")
    p.add_argument("--file_state_dict", default="", type=str,
                   help="a model file the port wrote (a checkpoint's pytorch_model.bin or "
                        "state.pt, pretraining's too) to start from; its tensors the model "
                        "lacks are ignored, a weight it lacks raises")
    p.add_argument("--file_checkpoint", default="", type=str,
                   help="checkpoint dir: training resumes its full state after its "
                        "epoch; eval and predict use its weights")
    p.add_argument("--strict_load", action="store_true",
                   help="fail if a checkpoint tensor is not consumed (as the JAX "
                        "package's strict load decides)")
    p.add_argument("--fix_reference_bugs", action="store_true")
    p.add_argument("--skip_nonfinite", action="store_true")
    p.add_argument("--micro_steps", default=1, type=int)
    p.add_argument("--device_cache", action="store_true",
                   help="keep the first epoch's staged batches on the card and replay "
                        "them in later epochs (K3M_DEVICE_CACHE=1)")
    p.add_argument("--wire", default=None, choices=["fp", "int8", "exact"],
                   help="host->card form of the image features; default K3M_WIRE, else fp")
    p.add_argument("--vocab_file", default=None, type=str)
    p.add_argument("--log_steps", default=10, type=int)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--do_pred", action="store_true")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--train_batch_size", default=32, type=int)
    p.add_argument("--eval_batch_size", default=32, type=int)
    p.add_argument("--learning_rate", default=5e-5, type=float)
    p.add_argument("--num_train_epochs", default=10.0, type=float)
    p.add_argument("--warmup_proportion", default=0.3, type=float)
    p.add_argument("--gradient_accumulation_steps", default=1, type=int)
    p.add_argument("--adam_epsilon", default=1e-8, type=float)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--cache", default=5000, type=int,
                   help="loader prefetch depth in pairs (ref per-rank cache :131)")
    p.add_argument("--if_pre_sampling", default=1, type=int)
    p.add_argument("--loss_type", default="ce", type=str,
                   choices=["inner", "cosine", "ce"])
    p.add_argument("--threshold", default=0.5, type=float)
    p.add_argument("--max_seq_length", default=50, type=int)
    p.add_argument("--max_seq_length_pv", default=256, type=int)
    p.add_argument("--max_num_pv", default=30, type=int)
    p.add_argument("--max_region_length", default=36, type=int)
    p.add_argument("--dynamic_attention", action="store_true")
    p.add_argument("--visual_target", default=0, type=int)
    p.add_argument("--num_negative_image", default=128, type=int)
    p.add_argument("--use_image", action="store_true")
    p.add_argument("--with_coattention", action="store_true")
    p.add_argument("--shared_prefix", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--n_model", default=1, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    # accepted with no effect, as the JAX package accepts them
    p.add_argument("--objective", default=2, type=int)
    p.add_argument("--loss_img_weight", default=1.0, type=float)
    p.add_argument("--num_workers", default=2, type=int)
    p.add_argument("--do_lower_case", default=True, type=bool)
    p.add_argument("--loss_scale", default=0, type=float)
    p.add_argument("--no_cuda", action="store_true")
    p.add_argument("--freeze", default=-1, type=int)
    p.add_argument("--pretrained_model_weights", default=None, type=str)
    p.add_argument("--no_remat", action="store_true",
                   help="accepted; the port keeps every activation")
    p.add_argument("--fp16", action="store_true",
                   help="accepted; as in the JAX package, --bf16 sets the precision")
    return p


def _find_config(args):
    for c in (Path(args.output_dir) / args.config_file, CONFIG_DIR / args.config_file,
              Path(args.config_file)):
        if c.exists():
            return c
    raise FileNotFoundError(f"config {args.config_file} not found")


def main(argv=None):
    args = get_parser().parse_args(argv)
    from k3m_tpu_torch.train import dist, mesh

    config = resolve_config(args)
    mesh.check_model_axis(config, args.n_model)
    world = dist.init_from_env(args.device, args.n_model)
    try:
        return _run(args, world, config)
    finally:
        world.close()


def resolve_config(args):
    """The config file with the flags' overrides (root finetune.py:125-140)."""
    from k3m_tpu_torch.config import K3MConfig
    return K3MConfig.from_json_file(str(_find_config(args))).replace(
        fix_reference_bugs=args.fix_reference_bugs,
        if_pre_sampling=args.if_pre_sampling, loss_type=args.loss_type,
        dynamic_attention=args.dynamic_attention, visual_target=args.visual_target,
        use_image=args.use_image, with_coattention=args.with_coattention,
        num_negative_image=args.num_negative_image,
        dtype="bfloat16" if args.bf16 else "float32",
        shared_prefix=args.shared_prefix,
        model="roberta" if "roberta" in (args.model_name or "") else "bert")


def _run(args, world, config):
    from k3m_tpu_torch.convert import load_model_file, load_pretrained
    from k3m_tpu_torch.data.pipeline import AlignmentLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.model.alignment import build_model
    from k3m_tpu_torch.tokenization import get_tokenizer
    from k3m_tpu_torch.train import alignment_loop, mesh
    from k3m_tpu_torch.train.state import CheckpointManager

    device = world.device
    os.makedirs(args.output_dir, exist_ok=True)
    if args.file_name:                       # split pattern (ref :223, :240)
        args.file_train, args.file_valid, args.file_test = (
            args.file_name.format(split) for split in ("train", "valid", "test"))
    tokenizer = get_tokenizer(args.vocab_file, config.vocab_size)
    shapes = ShapeSpec(max_seq_len=args.max_seq_length,
                       max_seq_len_pv=args.max_seq_length_pv,
                       max_num_pv=args.max_num_pv,
                       max_region_len=args.max_region_length,
                       v_feature_size=config.v_feature_size,
                       v_target_size=config.v_target_size)

    def loader(name, batch_size, shuffle, drop_last):
        path = os.path.join(args.data_dir, name)
        if not os.path.exists(path):
            return None
        # this data group's pairs of each global batch, from its shard
        return AlignmentLoader(path, tokenizer, shapes, batch_size=batch_size,
                               shuffle=shuffle, seed=args.seed,
                               visual_target=args.visual_target, drop_last=drop_last,
                               prefetch=min(16, max(2, args.cache // max(batch_size, 1))),
                               num_shards=world.data_size, shard_index=world.data_rank)

    # eval and predict see every pair of their shard: the remainder is kept
    eval_batch = max(args.eval_batch_size // world.data_size, 1)
    train_loader = loader(args.file_train, world.local_rows(args.train_batch_size,
                                                            "--train_batch_size"), True, True) \
        if args.do_train else None
    val_loader = loader(args.file_valid, eval_batch, False, False) if args.do_eval else None
    test_loader = loader(args.file_test, eval_batch, False, False) if args.do_pred else None
    if args.do_train and train_loader is None:
        raise FileNotFoundError(f"no train record file {args.file_train} in {args.data_dir}")
    if train_loader is None and val_loader is None and test_loader is None:
        raise FileNotFoundError("no alignment record file found for --do_eval/--do_pred")

    for name, ld in (("train", train_loader), ("valid", val_loader), ("test", test_loader)):
        if ld is not None:
            logger.info("%s loader: %s producer%s", name, ld.producer,
                        f" ({ld.native_error})" if ld.native_error else "")
    result = {}
    model = build_model(config, seed=args.seed, device=device, train=args.do_train)
    if args.pretrained_model_path:
        # every weight trains at the full LR, as in the JAX trainer
        load_pretrained(model, args.pretrained_model_path, strict=args.strict_load)
    if args.file_state_dict:
        # decides as the JAX package's load_params_msgpack: a pretraining
        # file's heads are ignored, a weight the file lacks raises
        load_model_file(model, args.file_state_dict)
    start_epoch = args.start_epoch
    # the checkpoint last, so that it supersedes the weights above; read
    # whatever the mode, as the JAX CLI reads it: the full state for
    # training, the model's weights for --do_eval / --do_pred
    state = None
    if args.file_checkpoint and os.path.exists(args.file_checkpoint):
        cm = CheckpointManager(args.file_checkpoint)
        state = cm.restore(map_location=device)
        if state is not None:
            epoch = int(cm.latest()["epoch"])
            if args.do_train:
                start_epoch = max(start_epoch, epoch + 1)
            else:
                model.load_state_dict(state["model"])
            logger.info("restored %s (epoch %d)", args.file_checkpoint, epoch)
    if args.do_train:
        # ref finetune.py:315: the schedule spans num_train_epochs - start_epoch
        total_steps = int(max(len(train_loader), 1)
                          * max(args.num_train_epochs - args.start_epoch, 1))
        # the trainer splits the loaded model over the model ranks
        trainer = alignment_loop.AlignmentTrainer(
            config, learning_rate=args.learning_rate,
            warmup_steps=int(args.warmup_proportion * total_steps),
            total_steps=total_steps, grad_accum_steps=args.gradient_accumulation_steps,
            micro_steps=args.micro_steps, adam_eps=args.adam_epsilon, seed=args.seed,
            device=device, wire=args.wire, device_cache=args.device_cache or None,
            skip_nonfinite=args.skip_nonfinite, model=model, world=world)
        if state is not None:
            trainer.load_state_dict(state)
        result["history"] = trainer.fit(train_loader, val_loader,
                                        num_epochs=int(args.num_train_epochs),
                                        start_epoch=start_epoch, log_steps=args.log_steps,
                                        checkpoint_dir=args.output_dir)
        result["trainer"] = trainer
        result["producer"] = train_loader.producer
    else:
        mesh.shard_model(model, world)
        world.broadcast_module(model)
        if val_loader is not None:
            result["sweep"] = alignment_loop.evaluate(model, val_loader, wire=args.wire,
                                                      world=world)
    if test_loader is not None:
        out = os.path.join(args.output_dir,
                           f"deepAI_result_threshold={args.threshold}.jsonl")
        result.update(alignment_loop.predict(model, test_loader, out,
                                             threshold=args.threshold,
                                             log_steps=args.log_steps, wire=args.wire,
                                             world=world))
    result["world"] = dict(rank=world.rank, size=world.size, backend=world.backend)
    return result


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-4s [%(filename)s:%(lineno)s]  %(message)s",
        datefmt="%Y/%m/%d %H:%M:%S", level=logging.INFO)
    main()
