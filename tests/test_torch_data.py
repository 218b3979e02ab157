"""The port's host side against the JAX package's: tokenizer, K3MR
records (both directions, byte for byte), the pair loader, the predict
jsonl and the eval metrics; and the port's independence from JAX."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from k3m_tpu.data import records as jrec
from k3m_tpu.data.pipeline import AlignmentLoader as JaxLoader
from k3m_tpu.data.preprocess import ShapeSpec as JaxShapes
from k3m_tpu.tokenization import get_tokenizer as jax_tokenizer
from k3m_tpu.train.alignment_loop import precision_recall_f1 as jax_prf
from k3m_tpu_torch.data import records as trec
from k3m_tpu_torch.data.pipeline import AlignmentLoader
from k3m_tpu_torch.data.preprocess import ShapeSpec
from k3m_tpu_torch.tokenization import build_synthetic_vocab, get_tokenizer
from k3m_tpu_torch.train import alignment_loop

ROOT = Path(__file__).resolve().parents[1]
SHAPES = dict(max_seq_len=12, max_seq_len_pv=24, max_num_pv=4, max_region_len=5,
              v_feature_size=8, v_target_size=7)


def _item(rng, i):
    vocab = build_synthetic_vocab()
    word = lambda n: "".join(vocab[j] for j in rng.integers(200, 2000, n))
    nb = int(rng.integers(0, 8))           # 0: the zero-box fallback
    boxes = rng.uniform(0, 60, (nb, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    return dict(item_id=f"item{i}", title=word(int(rng.integers(3, 20))) + " AbC",
                pv="".join(f"{word(2)}:{word(int(rng.integers(1, 5)))};"
                           for _ in range(int(rng.integers(0, 7)))),
                category="c", image_h=120, image_w=160, num_boxes=nb, boxes=boxes,
                features=rng.random((nb, 8), dtype=np.float32),
                cls_prob=rng.random((nb, 7), dtype=np.float32))


def _pairs(n=11, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(label=float(i % 2), item1=_item(rng, 2 * i), item2=_item(rng, 2 * i + 1))
            for i in range(n)]


def test_tokenizer_matches_jax():
    """The port's memoized tokenizer against the JAX package's, on fixed
    strings and on random text over control, whitespace, punctuation,
    accented, CJK and replacement characters, twice (cold and warm caches)."""
    mine, theirs = get_tokenizer(None, 21128), jax_tokenizer(None, 21128)
    rng = np.random.default_rng(0)
    chars = [chr(c) for c in [*range(0x250), *range(0x2000, 0x2070),
                              *range(0x3000, 0x3040), *range(0x4E00, 0x4F00),
                              0xFFFD, 0xFEFF, 0x200B]]
    texts = ["品牌:苹果;颜色:红色;", "Hello, World! 中文abc123", "  \t", "ÀÉ ü",
             "x" * 150, "\x00\tA\u3000B"]
    texts += ["".join(rng.choice(chars, rng.integers(0, 60))) for _ in range(500)]
    for _ in range(2):
        for text in texts:
            assert mine.tokenize(text) == theirs.tokenize(text), repr(text)
            assert mine.encode(text) == theirs.encode(text), repr(text)
    assert mine.add_special_tokens_single_sentence([5]) == \
        theirs.add_special_tokens_single_sentence([5])


def test_tokenizer_with_a_vocab_file_matches_jax(tmp_path):
    """A real vocab file (WordPiece with '##' pieces, whole-token [UNK])."""
    vocab = build_synthetic_vocab(2000) + ["hello", "world", "##s", "##ing", "play"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    mine = get_tokenizer(str(path))
    theirs = jax_tokenizer(str(path))
    for text in ("Hello worlds, playing!", "plays 中文 xyz", "HELLOING world"):
        for _ in range(2):
            assert mine.encode(text) == theirs.encode(text)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_round_trip_byte_for_byte(tmp_path, writer):
    recs = _pairs()
    mine, theirs = tmp_path / "port.k3mr", tmp_path / "jax.k3mr"
    trec.write_records(str(mine), recs)
    jrec.write_records(str(theirs), recs)
    assert mine.read_bytes() == theirs.read_bytes()
    # read the other package's file with each reader
    path = str(theirs if writer == "jax" else mine)
    reader = trec.RecordReader(path) if writer == "jax" else jrec.RecordReader(path)
    assert len(reader) == len(recs)
    for got, want in zip(reader, recs):
        for side in ("item1", "item2"):
            for k, v in want[side].items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[side][k], v)
                    assert got[side][k].dtype == v.dtype
                else:
                    assert got[side][k] == v and type(got[side][k]) is type(v)
        assert got["label"] == want["label"]


def _assert_batches_equal(a, b, where=""):
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], dict):
            _assert_batches_equal(a[k], b[k], f"{where}/{k}")
        elif isinstance(a[k], list):
            assert a[k] == b[k], f"{where}/{k}"
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{where}/{k}"
            assert a[k].tobytes() == b[k].tobytes(), f"{where}/{k}"


@pytest.mark.parametrize("shuffle", [False, True])
def test_alignment_loader_matches_jax(tmp_path, shuffle):
    path = str(tmp_path / "pairs.k3mr")
    jrec.write_records(path, _pairs())
    kw = dict(batch_size=4, shuffle=shuffle, seed=3, drop_last=False)
    mine = AlignmentLoader(path, get_tokenizer(None, 21128), ShapeSpec(**SHAPES), **kw)
    theirs = JaxLoader(path, jax_tokenizer(None, 21128), JaxShapes(**SHAPES),
                       use_native=False, native_preprocess=False, **kw)
    assert len(mine) == len(theirs) == 3
    for epoch in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 3
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_batches_equal(a, b, f"epoch {epoch} batch {i}")


def test_loader_stops_cleanly_when_abandoned(tmp_path):
    path = str(tmp_path / "pairs.k3mr")
    trec.write_records(path, _pairs(n=20))
    loader = AlignmentLoader(path, get_tokenizer(None, 21128), ShapeSpec(**SHAPES),
                             batch_size=2, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()                     # the producer thread must not hang
    assert len(list(loader)) == 10


def test_precision_recall_f1_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        labels, preds = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
        assert alignment_loop.precision_recall_f1(labels, preds) == jax_prf(labels, preds)
    assert alignment_loop.precision_recall_f1(np.zeros(3), np.zeros(3)) == (0.0, 0.0, 0.0)


def _finetune_args(tmp_path, cfg_path, *extra):
    return ["--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"),
            "--config_file", str(cfg_path), "--device", "cpu", "--use_image",
            "--with_coattention", "--eval_batch_size", "4",
            "--max_seq_length", "12", "--max_seq_length_pv", "24",
            "--max_num_pv", "4", "--max_region_length", "5", *extra]


@pytest.fixture
def micro_run(tmp_path):
    from tests.conftest import MICRO
    cfg_path = tmp_path / "micro.json"
    cfg_path.write_text(MICRO.replace(vocab_size=21128, v_feature_size=8,
                                      v_target_size=7).to_json_string())
    for name in ("test_item_alignment.k3mr", "valid_item_alignment.k3mr"):
        trec.write_records(str(tmp_path / name), _pairs())
    return tmp_path, cfg_path


def test_predict_writes_the_jax_jsonl_format(micro_run):
    """The port's predict writes one line per pair with the JAX package's
    keys, and its embeddings are the model's outputs for that pair."""
    from k3m_tpu_torch import finetune
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.alignment import build_model
    tmp_path, cfg_path = micro_run
    result = finetune.main(_finetune_args(tmp_path, cfg_path, "--do_pred", "--do_eval",
                                          "--seed", "9"))
    lines = [json.loads(x) for x in Path(result["output"]).read_text().splitlines()]
    assert len(lines) == 11 and result["batch_pairs"] == [4, 4, 3]
    assert all(set(x) == {"src_item_id", "src_item_emb", "tgt_item_id",
                          "tgt_item_emb", "threshold"} for x in lines)
    assert [x["src_item_id"] for x in lines] == [f"item{2 * i}" for i in range(11)]
    assert sorted(result["sweep"]) == [round(0.1 * i, 1) for i in range(1, 10)]
    # the same model and loader outside the CLI give the same embeddings
    cfg = K3MConfig.from_json_file(str(cfg_path)).replace(
        use_image=True, with_coattention=True, loss_type="ce")
    model = build_model(cfg, seed=9, device="cpu")
    loader = AlignmentLoader(str(tmp_path / "test_item_alignment.k3mr"),
                             get_tokenizer(None, 21128), ShapeSpec(**SHAPES),
                             batch_size=4, drop_last=False)
    emb1 = np.concatenate([alignment_loop.forward(
        model, alignment_loop.batch_to_device(b, "cpu"))[0].numpy() for b in loader])
    assert [x["src_item_emb"] for x in lines] == [str(e) for e in emb1]


def test_finetune_loads_a_reference_checkpoint(micro_run):
    """--pretrained_model_path with --strict_load replaces the seeded
    weights: the predictions are those of the checkpoint's model."""
    from k3m_tpu_torch import finetune
    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.model.alignment import build_model
    tmp_path, cfg_path = micro_run
    cfg = K3MConfig.from_json_file(str(cfg_path)).replace(
        use_image=True, with_coattention=True, loss_type="ce")
    sd = build_model(cfg, seed=3, device="cpu").state_dict()
    ref = {("bert." + k if k.startswith("encoder.") else k): v for k, v in sd.items()}
    ref["cls.seq_relationship.weight"] = torch.zeros(2, 16)   # an HF NSP head
    torch.save(ref, tmp_path / "ref.bin")
    seeded = finetune.main(_finetune_args(tmp_path, cfg_path, "--do_pred", "--seed", "3",
                                          "--output_dir", str(tmp_path / "a")))
    loaded = finetune.main(_finetune_args(
        tmp_path, cfg_path, "--do_pred", "--seed", "9", "--output_dir", str(tmp_path / "b"),
        "--pretrained_model_path", str(tmp_path / "ref.bin"), "--strict_load"))
    assert Path(seeded["output"]).read_text() == Path(loaded["output"]).read_text()
    # a missing model weight keeps its seeded value, as the JAX package's
    # strict load decides (tests/test_torch_finetune.py holds the two alike)
    del ref["classifier.out_proj.bias"]
    torch.save(ref, tmp_path / "ref.bin")
    partial = finetune.main(_finetune_args(
        tmp_path, cfg_path, "--do_pred", "--seed", "9", "--output_dir", str(tmp_path / "c"),
        "--pretrained_model_path", str(tmp_path / "ref.bin"), "--strict_load"))
    assert len(Path(partial["output"]).read_text().splitlines()) == 11


# --------------------------------------------------------- independence

def _port_sources():
    return sorted((ROOT / "k3m_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    the JAX package, grain or array_record (an AST walk over every import
    statement)."""
    banned = ("jax", "jaxlib", "flax", "optax", "k3m_tpu", "grain", "array_record")
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                    node.func, "id", None)) in ("import_module", "__import__")
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names
                      if n.split(".")[0] in banned]
    assert len(_port_sources()) > 20
    assert not found, found


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero, and prints no result line, where CUDA
    is not available."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
