"""Item-alignment eval / predict CLI of the PyTorch port.

    python -m k3m_tpu_torch.finetune --data_dir D --output_dir O \\
        --use_image --with_coattention --do_pred --bf16 [--device cuda]

Flag-compatible with the root `finetune.py` for the flags of its eval and
predict paths (`run_pred.sh`): the record files, `--config_file`,
`--pretrained_model_path`, `--bf16`, `--if_pre_sampling`, `--loss_type`,
the shapes and `--eval_batch_size`. Runs on the CUDA device unless
`--device cpu` is passed. `--do_train` is refused: training comes with a
later slice. Without `--pretrained_model_path` the weights are random from
`--seed`.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
from pathlib import Path

logger = logging.getLogger(__name__)

CONFIG_DIR = Path(__file__).resolve().parent / "configs"


def get_parser():
    p = argparse.ArgumentParser(prog="python -m k3m_tpu_torch.finetune")
    p.add_argument("--data_dir", required=True, type=str)
    p.add_argument("--output_dir", required=True, type=str)
    p.add_argument("--file_valid", default="valid_item_alignment.k3mr", type=str)
    p.add_argument("--file_test", default="test_item_alignment.k3mr", type=str)
    p.add_argument("--model_name", default="bert-base-chinese", type=str)
    p.add_argument("--config_file", default="bert_base_6layer_6conect.json", type=str)
    p.add_argument("--pretrained_model_path", default=None, type=str,
                   help="reference torch checkpoint (.bin) to load")
    p.add_argument("--strict_load", action="store_true",
                   help="fail if the checkpoint leaves a model weight unset or "
                        "holds a weight the model does not have")
    p.add_argument("--fix_reference_bugs", action="store_true")
    p.add_argument("--vocab_file", default=None, type=str)
    p.add_argument("--log_steps", default=10, type=int)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--do_pred", action="store_true")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--eval_batch_size", default=32, type=int)
    p.add_argument("--if_pre_sampling", default=1, type=int)
    p.add_argument("--loss_type", default="ce", type=str,
                   choices=["inner", "cosine", "ce"])
    p.add_argument("--threshold", default=0.5, type=float)
    p.add_argument("--max_seq_length", default=50, type=int)
    p.add_argument("--max_seq_length_pv", default=256, type=int)
    p.add_argument("--max_num_pv", default=30, type=int)
    p.add_argument("--max_region_length", default=36, type=int)
    p.add_argument("--dynamic_attention", action="store_true")
    p.add_argument("--use_image", action="store_true")
    p.add_argument("--with_coattention", action="store_true")
    p.add_argument("--shared_prefix", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def _find_config(args):
    for c in (Path(args.output_dir) / args.config_file, CONFIG_DIR / args.config_file,
              Path(args.config_file)):
        if c.exists():
            return c
    raise FileNotFoundError(f"config {args.config_file} not found")


def load_pretrained(model, path: str, strict: bool) -> None:
    """Load a reference checkpoint into `model`. The NSP and pretraining
    heads of an HF checkpoint have no place in the alignment model and are
    skipped; under `strict` anything else left over, or missing, raises."""
    from k3m_tpu_torch.convert import load_reference_bin
    sd = load_reference_bin(path)
    own = model.state_dict()
    skip = re.compile(r"^cls\.")
    extra = [k for k in sd if k not in own and not skip.match(k)]
    missing = [k for k in own if k not in sd]
    if strict and (extra or missing):
        raise KeyError(f"checkpoint mismatch: unused {extra[:8]}, missing {missing[:8]}")
    if extra or missing:
        logger.warning("checkpoint: %d unused, %d missing weights (e.g. %s / %s)",
                       len(extra), len(missing), extra[:3], missing[:3])
    model.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=False)


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.do_train:
        raise NotImplementedError("--do_train is not ported yet; the port "
                                  "runs --do_eval and --do_pred")
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.data.pipeline import AlignmentLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.device import resolve_device
    from k3m_tpu_torch.model.alignment import build_model
    from k3m_tpu_torch.tokenization import get_tokenizer
    from k3m_tpu_torch.train import alignment_loop

    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    config = K3MConfig.from_json_file(str(_find_config(args))).replace(
        fix_reference_bugs=args.fix_reference_bugs,
        if_pre_sampling=args.if_pre_sampling, loss_type=args.loss_type,
        dynamic_attention=args.dynamic_attention,
        use_image=args.use_image, with_coattention=args.with_coattention,
        dtype="bfloat16" if args.bf16 else "float32",
        shared_prefix=args.shared_prefix,
        model="roberta" if "roberta" in (args.model_name or "") else "bert")
    tokenizer = get_tokenizer(args.vocab_file, config.vocab_size)
    shapes = ShapeSpec(max_seq_len=args.max_seq_length,
                       max_seq_len_pv=args.max_seq_length_pv,
                       max_num_pv=args.max_num_pv,
                       max_region_len=args.max_region_length,
                       v_feature_size=config.v_feature_size,
                       v_target_size=config.v_target_size)

    def loader(name):
        path = os.path.join(args.data_dir, name)
        if not os.path.exists(path):
            return None
        # eval and predict see every pair: the remainder batch is kept
        return AlignmentLoader(path, tokenizer, shapes,
                               batch_size=args.eval_batch_size, drop_last=False)

    val_loader = loader(args.file_valid) if args.do_eval else None
    test_loader = loader(args.file_test) if args.do_pred else None
    if val_loader is None and test_loader is None:
        raise FileNotFoundError("no alignment record file found for --do_eval/--do_pred")

    model = build_model(config, seed=args.seed, device=device)
    if args.pretrained_model_path:
        load_pretrained(model, args.pretrained_model_path, args.strict_load)

    result = {}
    if val_loader is not None:
        result["sweep"] = alignment_loop.evaluate(model, val_loader)
    if test_loader is not None:
        out = os.path.join(args.output_dir,
                           f"deepAI_result_threshold={args.threshold}.jsonl")
        result.update(alignment_loop.predict(model, test_loader, out,
                                             threshold=args.threshold,
                                             log_steps=args.log_steps))
    return result


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)-4s [%(filename)s:%(lineno)s]  %(message)s",
        datefmt="%Y/%m/%d %H:%M:%S", level=logging.INFO)
    main()
