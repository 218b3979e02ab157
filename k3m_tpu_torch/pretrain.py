"""Pretraining CLI of the PyTorch port.

    python -m k3m_tpu_torch.pretrain --data_dir D --output_dir O \\
        --file_name '{}_feat.k3mr' --use_image --with_coattention --bf16 \\
        [--device cpu]

Flag-compatible with the root `pretrain.py` (its :24-113; behaviour
:116-268): the same config search order (output_dir, data_dir, the
package's configs/, the literal path), the same flag overrides of the
config, `PretrainLoader` batches into `PretrainTrainer`, per-epoch
checkpoints in `--output_dir` and full-state resume with
`--file_checkpoint`. Runs on the CUDA device unless `--device cpu` is
given. Without `--pretrained_model_path` the weights are random from
`--seed`. Options of the JAX package that the port does not have yet are
refused by name (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

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
    p.add_argument("--file_checkpoint", default="", type=str,
                   help="checkpoint dir to resume the full state from")
    p.add_argument("--file_state_dict", default="", type=str,
                   help="a model state dict saved by torch.save to start from")
    p.add_argument("--strict_load", action="store_true")
    p.add_argument("--fix_reference_bugs", action="store_true")
    p.add_argument("--skip_nonfinite", action="store_true")
    p.add_argument("--save_steps", default=0, type=int)
    p.add_argument("--log_steps", default=10, type=int)
    p.add_argument("--use_image", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--train_batch_size", default=96, type=int)
    p.add_argument("--eval_batch_size", default=96, type=int)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--num_train_epochs", default=5.0, type=float)
    p.add_argument("--start_epoch", default=0, type=float)
    p.add_argument("--data_backend", default="auto", choices=["auto", "k3mr", "grain"])
    p.add_argument("--if_pre_sampling", default=1, type=int)
    p.add_argument("--with_coattention", action="store_true",
                   help="accepted, as the root CLI accepts it; the config decides")
    p.add_argument("--objective", default=2, type=int)
    p.add_argument("--freeze", default=-1, type=int)
    p.add_argument("--warmup_proportion", default=0.1, type=float)
    p.add_argument("--gradient_accumulation_steps", default=1, type=int)
    p.add_argument("--micro_steps", default=1, type=int)
    p.add_argument("--device_cache", action="store_true")
    p.add_argument("--wire", default="fp", choices=["fp", "int8", "exact"])
    p.add_argument("--no_remat", action="store_true",
                   help="accepted; the port keeps every activation")
    p.add_argument("--adam_epsilon", default=1e-8, type=float)
    p.add_argument("--loss_img_weight", default=1.0, type=float)
    p.add_argument("--fp16", action="store_true", help="same as --bf16")
    p.add_argument("--bf16", action="store_true")
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


def refuse_unported(args) -> None:
    """Options of the JAX package the port does not have yet."""
    refused = {
        "--micro_steps > 1": args.micro_steps > 1,
        "--device_cache": args.device_cache,
        "--wire int8": args.wire == "int8",
        "--data_backend grain": args.data_backend == "grain",
        "--n_model > 1": args.n_model > 1,
        "--save_steps (mid-epoch checkpoints and preemption)": args.save_steps > 0,
        "multi-process training (WORLD_SIZE > 1)":
            int(os.environ.get("WORLD_SIZE", "1")) > 1,
    }
    for name, hit in refused.items():
        if hit:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md Queue 1)")


def find_config(args) -> Path:
    for c in (Path(args.output_dir) / args.config_file,
              Path(args.data_dir) / args.config_file,
              CONFIG_DIR / args.config_file, Path(args.config_file)):
        if c.exists():
            return c
    raise FileNotFoundError(f"config {args.config_file} not found")


def load_pretrained(model, path: str, strict: bool):
    """Load a reference checkpoint; returns the names it set. An HF NSP head
    (cls.seq_relationship, sized for plain BERT) is skipped."""
    import re

    from k3m_tpu_torch.convert import load_reference_bin
    sd = load_reference_bin(path)
    own = model.state_dict()
    skip = re.compile(r"^cls\.seq_relationship\.")
    extra = [k for k in sd if k not in own and not skip.match(k)]
    if strict and extra:
        raise KeyError(f"checkpoint holds weights the model does not have: {extra[:8]}")
    loaded = {k: v for k, v in sd.items()
              if k in own and not skip.match(k) and v.shape == own[k].shape}
    model.load_state_dict(loaded, strict=False)
    logger.info("loaded %d pretrained tensors from %s", len(loaded), path)
    return set(loaded)


def main(argv=None):
    args = get_parser().parse_args(argv)
    refuse_unported(args)
    import torch

    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.data.pipeline import PretrainLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.device import resolve_device
    from k3m_tpu_torch.model.pretrain import build_pretraining_model
    from k3m_tpu_torch.tokenization import get_tokenizer
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    from k3m_tpu_torch.train.state import CheckpointManager

    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
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
    config = config.replace(**overrides)

    tokenizer = get_tokenizer(args.vocab_file, config.vocab_size)
    shapes = ShapeSpec(max_seq_len=args.max_seq_length,
                       max_seq_len_pv=args.max_seq_length_pv,
                       max_num_pv=args.max_num_pv,
                       max_region_len=args.max_region_length,
                       v_feature_size=config.v_feature_size,
                       v_target_size=config.v_target_size)

    def path(split):
        name = args.file_name.format(split) if "{}" in args.file_name else args.file_name
        return os.path.join(args.data_dir, name)

    train_loader = PretrainLoader(path("train"), tokenizer, shapes,
                                  batch_size=args.train_batch_size, shuffle=True,
                                  seed=args.seed, visual_target=args.visual_target)
    val_loader = None
    if args.do_eval and os.path.exists(path("valid")):
        val_loader = PretrainLoader(path("valid"), tokenizer, shapes,
                                    batch_size=args.eval_batch_size, shuffle=False,
                                    seed=args.seed, visual_target=args.visual_target)

    steps_per_epoch = max(len(train_loader) // args.gradient_accumulation_steps, 1)
    total_steps = int(steps_per_epoch * args.num_train_epochs)
    model = build_pretraining_model(config, seed=args.seed, device=device)
    pretrained = None
    if args.pretrained_model_path:
        pretrained = load_pretrained(model, args.pretrained_model_path, args.strict_load)
    if args.file_state_dict:
        model.load_state_dict(torch.load(args.file_state_dict, map_location=device,
                                         weights_only=True))
    trainer = PretrainTrainer(
        config, learning_rate=args.learning_rate,
        warmup_steps=int(args.warmup_proportion * total_steps),
        total_steps=total_steps, grad_accum_steps=args.gradient_accumulation_steps,
        adam_eps=args.adam_epsilon, loss_img_weight=args.loss_img_weight,
        objective=args.objective, seed=args.seed, wire=args.wire,
        skip_nonfinite=args.skip_nonfinite, pretrained=pretrained, model=model)

    start_epoch = int(args.start_epoch)
    if args.file_checkpoint:
        cm = CheckpointManager(args.file_checkpoint)
        state = cm.restore(map_location=device)
        if state is not None:
            trainer.load_state_dict(state)
            start_epoch = int(cm.latest()["epoch"]) + 1
            logger.info("resumed from %s at epoch %d", args.file_checkpoint, start_epoch)

    history = trainer.fit(train_loader, val_loader,
                          num_epochs=int(args.num_train_epochs),
                          start_epoch=start_epoch, log_steps=args.log_steps,
                          checkpoint_dir=args.output_dir)
    logger.info("training history: %s", [
        {k: v for k, v in h.items() if not k.startswith("step_")} for h in history])
    return dict(history=history, trainer=trainer)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-4s [%(filename)s:%(lineno)s]  %(message)s",
        datefmt="%Y/%m/%d %H:%M:%S", level=logging.INFO)
    main()
