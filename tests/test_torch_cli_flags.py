"""The port's pretraining CLI against the root `pretrain.py`'s flags: every
option string of the root parser, read from its source through `ast` (the
root module imports JAX, so it is not imported), parses with the port's
parser, with the same default; `--no_cuda` is `--device cpu`; the grain
backend is chosen, by name or by `--data_backend auto`, as the root CLI
chooses it."""

import ast
from pathlib import Path

import pytest

from k3m_tpu_torch import pretrain, train_concap_struc

ROOT = Path(__file__).resolve().parents[1]
REQUIRED = ["--data_dir", "d", "--output_dir", "o", "--file_name", "{}_feat.k3mr"]


def root_options():
    """{option: (default, type name, choices, action)} of every
    `p.add_argument` call in root pretrain.py's get_parser."""
    tree = ast.parse((ROOT / "pretrain.py").read_text())
    parser = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                  and n.name == "get_parser")
    out = {}
    for node in ast.walk(parser):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            lit = lambda k: ast.literal_eval(kw[k]) if k in kw else None
            default = lit("default")
            if default is None and lit("action") == "store_true":
                default = False
            out[node.args[0].value] = (default,
                                       kw["type"].id if "type" in kw else None,
                                       lit("choices"), lit("action"))
    return out


OPTIONS = root_options()


def test_the_root_parser_was_read():
    assert len(OPTIONS) == 57 and "--no_cuda" in OPTIONS and "--num_workers" in OPTIONS


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_every_root_option_parses_with_its_default(option):
    default, typ, choices, action = OPTIONS[option]
    actions = {a.option_strings[0]: a for a in pretrain.get_parser()._actions
               if a.option_strings}
    assert option in actions, option
    mine = actions[option]
    if option not in ("--data_dir", "--output_dir", "--file_name"):
        assert mine.default == default, (option, mine.default, default)
    if typ is not None:
        assert mine.type.__name__ == typ, option
    if choices is not None:
        assert list(mine.choices) == list(choices), option
    if action == "store_true":
        args = pretrain.parse_args(REQUIRED + [option])
    elif option in ("--data_dir", "--output_dir", "--file_name"):
        args = pretrain.parse_args(REQUIRED)
    else:
        value = str(choices[0] if choices else default if default is not None else "x")
        args = pretrain.parse_args(REQUIRED + [option, value])
    assert hasattr(args, option[2:])


def test_no_cuda_means_the_cpu():
    assert pretrain.parse_args(REQUIRED).device == "cuda"
    assert pretrain.parse_args(REQUIRED + ["--no_cuda"]).device == "cpu"


def test_grain_is_refused_by_name():
    """Once refused, now chosen as root pretrain.py:174-177 chooses it:
    --data_backend grain on any file, auto on an .array_record train file
    with workers; auto with no workers, or on a .k3mr, is the record
    reader, and so is --data_backend k3mr."""
    def backend(*argv, train="d/train_feat.k3mr"):
        return pretrain.data_backend(pretrain.parse_args(list(argv)), train)
    arec = dict(train="d/train.array_record")
    assert backend(*REQUIRED, "--data_backend", "grain") == "grain"
    assert backend(*REQUIRED, "--data_backend", "grain", **arec) == "grain"
    assert backend(*REQUIRED, **arec) == "grain"       # --num_workers defaults to 2
    assert backend(*REQUIRED, "--num_workers", "0", **arec) == "k3mr"
    assert backend(*REQUIRED, "--data_backend", "k3mr", **arec) == "k3mr"
    assert backend(*REQUIRED) == "k3mr"
    legacy = train_concap_struc.get_parser().parse_args(
        ["--data_dir", "d", "--output_dir", "o", "--file_name", "train.array_record"])
    assert pretrain.data_backend(legacy, "d/train.array_record") == "k3mr"


def test_legacy_n_model_help_is_current():
    action = next(a for a in train_concap_struc.get_parser()._actions
                  if "--n_model" in a.option_strings)
    assert "not ported" not in action.help
