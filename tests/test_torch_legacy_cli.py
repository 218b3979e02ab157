"""The port's legacy pretraining CLI (k3m_tpu_torch.train_concap_struc)
against the root `train_concap_struc.py` of the JAX package, and against the
port's own pretraining CLI, on the CPU:

  * the parser has every option of the JAX parser, with its default, type,
    choices and action, and adds only `--device`;
  * resolve_config gives JAX's config for five flag sets (the search order
    included);
  * find_records returns the same kind of path and, for a raw TSV, writes
    JAX's records byte for byte, once;
  * at NANO, the legacy CLI trains, evaluates and resumes as
    `k3m_tpu_torch.pretrain` does on the same records and flags: losses and
    parameters bit for bit; `hyperparamter.txt` holds the args, a blank
    line and the config;
  * eval-only `--do_eval` is the mean of eval_step over the validation
    records; `--no_cuda` is `--device cpu`, and the default is the card;
    `--n_model 2` raises by name.
"""

import json
import os

import numpy as np
import pytest
import torch

import train_concap_struc as jcli
from k3m_tpu_torch import pretrain, train_concap_struc as tcli
from tests.conftest import NANO
from tests.test_torch_trainer import _records

CFG = NANO.replace(vocab_size=21128, v_feature_size=8, v_target_size=7)
SHAPE_FLAGS = ["--max_seq_length", "12", "--max_seq_length_pv", "24", "--max_num_pv", "4",
               "--max_region_length", "5"]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_every_jax_option_and_adds_only_device():
    mine, theirs = _actions(tcli.get_parser()), _actions(jcli.get_parser())
    assert set(mine) - set(theirs) == {"device"} and set(theirs) <= set(mine)
    for dest, want in theirs.items():
        got = mine[dest]
        for attr in ("option_strings", "default", "type", "choices", "nargs", "const",
                     "required"):
            assert getattr(got, attr) == getattr(want, attr), (dest, attr)
        assert type(got) is type(want), dest
    assert mine["device"].default == "cuda"


def _base(tmp_path, *extra):
    return ["--data_dir", str(tmp_path / "data"), "--output_dir", str(tmp_path / "out"),
            "--file_name", "train_feat.k3mr", *extra]


FLAG_SETS = {
    "defaults": [],
    "visual_target_roberta_freeze": ["--visual_target", "1", "--bf16", "--model_name",
                                     "hfl/chinese-roberta-wwm-ext", "--freeze", "3"],
    "other_config": ["--config_file", "k3m_roberta_base.json", "--objective", "1",
                     "--if_pre_sampling", "2", "--num_negative", "64",
                     "--dynamic_attention", "--use_pallas", "--shared_prefix",
                     "--fix_reference_bugs"],
    "output_dir_first": ["--config_file", "nano.json", "--visual_target", "2"],
    "data_dir_only": ["--config_file", "micro.json", "--objective", "0"],
}


@pytest.mark.parametrize("flags", list(FLAG_SETS), ids=list(FLAG_SETS))
def test_resolve_config_equals_jax(tmp_path, flags):
    """The config and its overrides; nano.json lies in both output_dir and
    data_dir (output_dir's wins), micro.json in data_dir only."""
    for d in ("data", "out"):
        (tmp_path / d).mkdir()
    (tmp_path / "out" / "nano.json").write_text(CFG.to_json_string())
    (tmp_path / "data" / "nano.json").write_text(CFG.replace(hidden_size=32).to_json_string())
    (tmp_path / "data" / "micro.json").write_text(
        NANO.replace(num_hidden_layers=2, t_biattention_id=(1,)).to_json_string())
    argv = _base(tmp_path, *FLAG_SETS[flags])
    got = tcli.resolve_config(tcli.get_parser().parse_args(argv))
    want = jcli.resolve_config(jcli.get_parser().parse_args(argv))
    assert got.to_dict() == want.to_dict()
    assert got.with_coattention


def _raw_tsv(path, n, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            pv = "#".join(f"品牌{j}:值{int(rng.integers(0, 9))}" for j in range(i % 4))
            f.write(f"item{i}\t标题 {i} abc\thttp://x/{i}.jpg\t{pv}\tcat{i % 3}\n")
        f.write("a line that is not five fields\n")


def test_find_records_converts_a_raw_tsv_as_jax(tmp_path):
    """A raw TSV converted once into `<name>.k3mr`, byte for byte JAX's
    conversion; a second call reuses it; `.k3mr` paths and `<name>.k3mr`
    are returned as they are; a missing valid sibling raises in both."""
    outs = {}
    for pkg, mod in (("port", tcli), ("jax", jcli)):
        d = tmp_path / pkg
        d.mkdir()
        _raw_tsv(d / "train_raw.tsv", 7)
        args = mod.get_parser().parse_args(
            ["--data_dir", str(d), "--output_dir", str(d), "--file_name", "train_raw.tsv"])
        path = mod.find_records(args, "train")
        assert path == str(d / "train_raw.tsv.k3mr")
        stamp = os.stat(path).st_mtime_ns
        assert mod.find_records(args, "train") == path and os.stat(path).st_mtime_ns == stamp
        with pytest.raises(FileNotFoundError):
            mod.find_records(args, "valid")
        args.file_name = "train_raw.tsv.k3mr"
        assert mod.find_records(args, "train") == path
        outs[pkg] = open(path, "rb").read()
    assert outs["port"] == outs["jax"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("legacy")
    (d / "data").mkdir()
    _records(d / "data" / "train_feat.k3mr", 9)
    _records(d / "data" / "valid_feat.k3mr", 4, seed=1)
    (d / "nano.json").write_text(CFG.to_json_string())
    return d


def _pretrain_argv(d, out, *extra):
    """The port's pretraining CLI with the flags that make it the legacy
    CLI's run: its config overrides and file name."""
    return ["--data_dir", str(d / "data"), "--output_dir", str(d / out),
            "--file_name", "{}_feat.k3mr", "--config_file", str(d / "nano.json"),
            "--device", "cpu", "--use_image", "--model_name", "bert-base-chinese",
            "--num_negative_image", "255", "--num_negative_pv", str(CFG.num_negative_pv),
            "--margin", str(CFG.margin), "--train_batch_size", "4", "--eval_batch_size", "2",
            "--log_steps", "1", "--seed", "5", *SHAPE_FLAGS, *extra]


def _legacy_argv(d, out, *extra):
    return ["--data_dir", str(d / "data"), "--output_dir", str(d / out),
            "--file_name", "train_feat.k3mr", "--config_file", str(d / "nano.json"),
            "--device", "cpu", "--train_batch_size", "4", "--eval_batch_size", "2",
            "--log_steps", "1", "--seed", "5", *SHAPE_FLAGS, *extra]


def _same_run(a, b):
    assert len(a["history"]) == len(b["history"])
    for ha, hb in zip(a["history"], b["history"]):
        assert ha["step_losses"] == hb["step_losses"]
        assert {k: v for k, v in ha.items() if k.startswith("val_")} == \
            {k: v for k, v in hb.items() if k.startswith("val_")}
    sa, sb = a["trainer"].model.state_dict(), b["trainer"].model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a["trainer"].step == b["trainer"].step


def test_legacy_cli_equals_the_pretraining_cli(data):
    """Two steps with dropout and the model's draws, validation, then a
    resume from the epoch checkpoint into a second epoch: the legacy CLI
    and `k3m_tpu_torch.pretrain` give the same losses, validation losses
    and parameters, bit for bit."""
    legacy = tcli.main(_legacy_argv(data, "legacy", "--do_train", "--do_eval",
                                    "--num_train_epochs", "1"))
    plain = pretrain.main(_pretrain_argv(data, "plain", "--do_eval", "--num_train_epochs", "1"))
    (h,) = legacy["history"]
    assert len(h["step_losses"]) == 2 and np.isfinite(h["val_loss"])
    assert all(np.isfinite(v) for s in h["step_losses"] for v in s.values())
    _same_run(legacy, plain)
    assert (data / "legacy" / "epoch_0" / "pytorch_model.bin").exists()
    # hyperparamter.txt: the args, a blank line, the config (reference :192-196)
    text = (data / "legacy" / "hyperparamter.txt").read_text()
    args_part, config_part = text.split("\n\n")
    args = json.loads(args_part)
    assert args["do_train"] and args["device"] == "cpu" and args["num_negative"] == 255
    resolved = tcli.resolve_config(tcli.get_parser().parse_args(
        _legacy_argv(data, "legacy")))
    assert json.loads(config_part) == resolved.to_dict()
    # resume into a second epoch from each run's checkpoint
    legacy2 = tcli.main(_legacy_argv(data, "legacy", "--do_train", "--num_train_epochs", "2",
                                     "--file_checkpoint", str(data / "legacy")))
    plain2 = pretrain.main(_pretrain_argv(data, "plain", "--num_train_epochs", "2",
                                          "--file_checkpoint", str(data / "plain")))
    assert [x["epoch"] for x in legacy2["history"]] == [1] and legacy2["trainer"].step == 4
    _same_run(legacy2, plain2)


def test_eval_only_is_the_mean_of_eval_steps(data):
    """`--do_eval` without `--do_train`: no step, no checkpoint; each loss's
    mean over the validation batches of the trainer's eval_step."""
    from k3m_tpu_torch.data.pipeline import PretrainLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.tokenization import get_tokenizer
    run = tcli.main(_legacy_argv(data, "eval_only", "--do_eval"))
    assert run["history"] is None and not (data / "eval_only" / "latest.json").exists()
    assert run["trainer"].step == 0
    shapes = ShapeSpec(max_seq_len=12, max_seq_len_pv=24, max_num_pv=4, max_region_len=5,
                       v_feature_size=8, v_target_size=7)
    loader = PretrainLoader(str(data / "data" / "valid_feat.k3mr"),
                            get_tokenizer(None, CFG.vocab_size), shapes, batch_size=2,
                            shuffle=False, seed=5)
    vals = [{k: float(v) for k, v in run["trainer"].eval_step(b).items()} for b in loader]
    assert len(vals) == 2
    assert run["eval"] == {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
    assert np.isfinite(run["eval"]["loss"])


def test_no_cuda_means_the_cpu_and_the_default_is_the_card(data):
    argv = [a for a in _legacy_argv(data, "no_cuda", "--do_eval") if a not in ("--device",
                                                                             "cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(argv)
    run = tcli.main(argv + ["--no_cuda"])
    assert run["trainer"].device.type == "cpu" and np.isfinite(run["eval"]["loss"])


def test_n_model_is_refused_by_name(data):
    """Tensor parallelism is ported (tests/test_torch_tp.py); what is still
    refused by name is an `--n_model` that does not divide a sharded width
    (NANO's hidden 16; a head count need not divide) or the world (one
    process)."""
    with pytest.raises(ValueError, match="--n_model 3 does not divide hidden_size 16"):
        tcli.main(_legacy_argv(data, "tp", "--do_train", "--n_model", "3"))
    with pytest.raises(ValueError, match="--n_model 2 does not divide the world of 1"):
        tcli.main(_legacy_argv(data, "tp", "--do_train", "--n_model", "2"))
