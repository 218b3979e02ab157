"""Legacy pretraining CLI of the PyTorch port, flag-compatible with the root
`train_concap_struc.py` (its :32-105; behaviour :162-279), which follows the
reference `train_concap_struc.py` (:68-138 for the flags):

    python -m k3m_tpu_torch.train_concap_struc --data_dir D --output_dir O \\
        --file_name train_feat.k3mr --do_train --do_eval \\
        --train_batch_size 96 --max_seq_length 50 --max_seq_length_pv 256 \\
        --max_num_pv 30 --bf16 [--device cpu]

Data: `--file_name` names a K3MR record file in `--data_dir` (`data.prepare`
writes one), or `<name>.k3mr` beside it, or a raw TSV that is converted once
through `data.prepare` into `<name>.k3mr`. Validation reads the sibling with
`train` replaced by `valid`, where there is one. The config is searched in
`--output_dir`, `--data_dir`, the port's `configs/`, then as given; the
co-attention is always on. `hyperparamter.txt` (the reference's spelling)
holds the arguments, a blank line, then the config. Without `--do_train`,
`--do_eval` reports the mean of each loss over the validation records.

The loaders, the loads, the trainer, resume and the epochs are
`k3m_tpu_torch.pretrain.run_pretraining`, which the pretraining CLI runs
too; N ranks (torchrun, or the K3M_* variables) run as there, and
`--n_model M` splits the model over M model ranks of each data group as
there (tensor parallelism, k3m_tpu_torch/pretrain.py).

Runs on the CUDA device unless `--device cpu` (or the reference's
`--no_cuda`) asks for the CPU. Reference flags accepted without effect, as
the JAX package's CLI accepts them:
  --fp16/--apex_fast/--loss_scale  -> use --bf16
  --local_rank/--distributed       -> the world comes from the launcher's
                                      variables (torchrun or K3M_*)
  --on_memory, --cache             -> the mmap record store already is
  --use_pallas, --no_remat         -> the port always runs its own kernels
                                      and keeps every activation
"""

from __future__ import annotations

import argparse
import json
import logging
import os

logger = logging.getLogger(__name__)


def get_parser():
    parser = argparse.ArgumentParser(prog="python -m k3m_tpu_torch.train_concap_struc")
    parser.add_argument("--data_dir", required=True, type=str)
    parser.add_argument("--output_dir", required=True, type=str)
    parser.add_argument("--file_name", required=True, type=str)
    parser.add_argument("--model_name", default="bert-base-chinese", type=str)
    parser.add_argument("--pretrained_model_path", default=None, type=str)
    parser.add_argument("--config_file", default="bert_base_6layer_6conect.json", type=str)
    parser.add_argument("--pretrained_model_weights",
                        default="bert-base-uncased_weight_name.json", type=str)
    parser.add_argument("--file_checkpoint", default="", type=str)
    parser.add_argument("--file_state_dict", default="", type=str)
    parser.add_argument("--strict_load", action="store_true",
                        help="fail if a tensor of --pretrained_model_path is not consumed")
    parser.add_argument("--fix_reference_bugs", action="store_true")
    parser.add_argument("--log_steps", default=1, type=int)
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--cache", default=5000, type=int)
    parser.add_argument("--do_train", action="store_true")
    parser.add_argument("--do_eval", action="store_true")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--on_memory", action="store_true")
    parser.add_argument("--local_rank", default=-1, type=int)
    parser.add_argument("--train_batch_size", default=8, type=int)
    parser.add_argument("--eval_batch_size", default=8, type=int)
    parser.add_argument("--learning_rate", default=1e-4, type=float)
    parser.add_argument("--num_train_epochs", default=6.0, type=float)
    parser.add_argument("--start_epoch", default=0, type=float)
    parser.add_argument("--no_cuda", action="store_true", help="same as --device cpu")
    parser.add_argument("--num_workers", default=2, type=int)
    parser.add_argument("--if_pre_sampling", default=1, type=int)
    parser.add_argument("--with_coattention", action="store_true")
    parser.add_argument("--objective", default=2, type=int)
    parser.add_argument("--freeze", default=-1, type=int)
    parser.add_argument("--warmup_proportion", default=0.1, type=float)
    parser.add_argument("--gradient_accumulation_steps", default=1, type=int)
    parser.add_argument("--micro_steps", default=1, type=int,
                        help="in-step microbatches (gradient accumulation inside one step)")
    parser.add_argument("--skip_nonfinite", action="store_true",
                        help="skip any update whose gradients are not finite")
    parser.add_argument("--device_cache", action="store_true",
                        help="keep the first epoch's staged batches on the card and replay "
                             "them in later epochs (static masking; K3M_DEVICE_CACHE=1)")
    parser.add_argument("--wire", default=None, choices=["fp", "int8", "exact"],
                        help="host->card form of the image tensors; default K3M_WIRE, else fp")
    parser.add_argument("--no_remat", action="store_true", help="accepted; no effect")
    parser.add_argument("--adam_epsilon", default=1e-8, type=float)
    parser.add_argument("--loss_img_weight", default=1, type=float)
    parser.add_argument("--fp16", action="store_true")
    parser.add_argument("--apex_fast", action="store_true")
    parser.add_argument("--loss_scale", default=0, type=float)
    parser.add_argument("--do_lower_case", default=True, type=bool)
    parser.add_argument("--max_seq_length", default=36, type=int)
    parser.add_argument("--max_seq_length_pv", default=128, type=int)
    parser.add_argument("--max_num_pv", default=20, type=int)
    parser.add_argument("--max_region_length", default=36, type=int)
    parser.add_argument("--dynamic_attention", action="store_true")
    parser.add_argument("--visual_target", default=0, type=int)
    parser.add_argument("--num_negative", default=255, type=int)
    # extensions of the JAX package
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--n_model", default=1, type=int,
                        help="model ranks a model is split over (tensor parallelism)")
    parser.add_argument("--use_pallas", action="store_true", help="accepted; no effect")
    parser.add_argument("--shared_prefix", action="store_true")
    parser.add_argument("--vocab_file", default=None, type=str)
    # the port's own
    parser.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    return parser


def resolve_config(args):
    """The config file (searched in output_dir first, the reference's
    quirk :184, then data_dir, the port's configs/, the path as given)
    with the flags' overrides (reference :198-211)."""
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.pretrain import find_config
    config = K3MConfig.from_json_file(str(find_config(args)))
    overrides = dict(
        fix_reference_bugs=args.fix_reference_bugs,
        if_pre_sampling=args.if_pre_sampling,
        with_coattention=True,  # the reference always trains with co-attention
        objective=args.objective,
        dynamic_attention=args.dynamic_attention,
        visual_target=args.visual_target,
        num_negative_image=args.num_negative,
        dtype="bfloat16" if args.bf16 else "float32",
        use_pallas=args.use_pallas,
        shared_prefix=args.shared_prefix,
    )
    if args.visual_target != 0:
        overrides["v_target_size"] = 2048
    if "roberta" in (args.model_name or ""):
        overrides["model"] = "roberta"
    if args.freeze > -1:
        overrides["fixed_t_layer"] = args.freeze
    return config.replace(**overrides)


def find_records(args, split: str) -> str:
    """The record file of `split` ("train", or "valid": `train` replaced by
    `valid` in --file_name): the path itself where it ends in .k3mr or
    .array_record (which root train_concap_struc.py:150 would take for a
    raw TSV), else `<path>.k3mr`, else a raw TSV at the path, converted
    once through data.prepare into `<path>.k3mr`. Raises
    FileNotFoundError."""
    from k3m_tpu_torch.data.prepare import build_feature_records, parse_raw_tsv
    from k3m_tpu_torch.data.records import write_records
    name = args.file_name if split == "train" else args.file_name.replace("train", "valid")
    path = os.path.join(args.data_dir, name)
    if path.endswith((".k3mr", ".array_record")) and os.path.exists(path):
        return path
    if os.path.exists(path + ".k3mr"):
        return path + ".k3mr"
    if os.path.exists(path):
        out = path + ".k3mr"
        n = write_records(out, build_feature_records(parse_raw_tsv(path)))
        logger.info("converted %s -> %s (%d records)", path, out, n)
        return out
    raise FileNotFoundError(path)


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.no_cuda:
        args.device = "cpu"
    from k3m_tpu_torch.train import dist, mesh

    config = resolve_config(args)
    mesh.check_model_axis(config, args.n_model)
    world = dist.init_from_env(args.device, args.n_model)
    try:
        return _run(args, world, config)
    finally:
        world.close()


def _run(args, world, config):
    from k3m_tpu_torch.pretrain import run_pretraining

    os.makedirs(args.output_dir, exist_ok=True)
    if world.rank == 0:
        with open(os.path.join(args.output_dir, "hyperparamter.txt"), "w") as f:
            # the reference (:192-196) writes the args, a blank line, the config
            json.dump(vars(args), f, indent=2)
            f.write("\n\n")
            json.dump(config.to_dict(), f, indent=2)
    train_path = find_records(args, "train")
    try:
        valid_path = find_records(args, "valid")
    except FileNotFoundError:
        valid_path = None
    return run_pretraining(args, config, world, train_path,
                           valid_path if args.do_eval else None, do_train=args.do_train)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-4s [%(filename)s:%(lineno)s]  %(message)s",
        datefmt="%Y/%m/%d %H:%M:%S", level=logging.INFO)
    main()
