"""The port's grain backend (k3m_tpu_torch/data/grain_pipeline.py) against
grain and the JAX package's grain loaders, on records written here, on the
CPU:

  * `index_shuffle` equals grain's C++ index_shuffle on a few hundred
    (index, max_index, seed) triples, max_index 0, 1 and 2**40 among them;
    `sampled_keys` equals grain's IndexSampler read as grain's DataLoader
    reads it, shuffled or not, one shard or several;
  * GrainPretrainLoader and GrainAlignmentLoader batches, in-process and
    from two worker processes, equal the JAX loaders' (num_workers=0)
    byte for byte over two epochs; the native hybrid equals the
    in-process path; a sibling with other records is not used, as in JAX;
  * PretrainLoader and AlignmentLoader on an .array_record equal them on
    the same .k3mr; `prepare` writes and joins .array_record files (also
    tests/test_torch_prepare.py); `pretrain --data_backend grain` and
    `finetune` on .array_record files run on the CPU.
"""

import numpy as np
import pytest

from k3m_tpu.data import grain_pipeline as jgrain
from k3m_tpu.data.preprocess import ShapeSpec as JaxShapes
from k3m_tpu.tokenization import get_tokenizer as jax_tokenizer
from k3m_tpu_torch.data import grain_pipeline as tgrain
from k3m_tpu_torch.data import records as trec
from k3m_tpu_torch.data.array_record import write_array_records
from k3m_tpu_torch.data.pipeline import AlignmentLoader, PretrainLoader
from k3m_tpu_torch.data.preprocess import ShapeSpec
from k3m_tpu_torch.tokenization import get_tokenizer
from tests.test_torch_data import SHAPES, _finetune_args, _item, _pairs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """22 feature records and 11 pair records, each as an .array_record
    with a same-content .k3mr sibling, and a sibling in reverse order."""
    d = tmp_path_factory.mktemp("grain")
    rng = np.random.default_rng(0)
    feats, pairs = [_item(rng, i) for i in range(22)], _pairs(11, seed=2)
    for name, recs in (("feat", feats), ("pairs", pairs)):
        write_array_records(str(d / f"{name}.array_record"), recs)
        trec.write_records(str(d / f"{name}.k3mr"), recs)
    trec.write_records(str(d / "reversed.k3mr"), feats[::-1])
    return d


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(None, 21128)


def _assert_batches_equal(got, want, where):
    assert len(got) == len(want) > 0, where
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys(), (where, i)
        for k in a:
            if isinstance(a[k], dict):
                _assert_batches_equal([a[k]], [b[k]], f"{where} batch {i} {k}")
            elif isinstance(a[k], list):
                assert [str(x) for x in a[k]] == [str(x) for x in b[k]], (where, i, k)
            else:
                x, y = np.asarray(a[k]), np.asarray(b[k])
                assert x.dtype == y.dtype and x.shape == y.shape, (where, i, k)
                assert x.tobytes() == y.tobytes(), (where, i, k)


def _epochs(loader, n=2):
    out = []
    for e in range(n):
        loader.epoch = e
        out.append(list(loader))
    return out


def test_index_shuffle_equals_grain():
    """Edge max_index 0, 1, 2, 3, 2**16 - 1 and 2**40 (index 2**40 too),
    then 300 random triples."""
    from grain._src.python.experimental.index_shuffle.python import index_shuffle_module
    rng = np.random.default_rng(3)
    cases = [(0, 0, 1), (0, 1, 5), (1, 1, 5), (2, 2, 0), (1, 3, 2 ** 32 - 1),
             (65535, 65535, 9), (3, 2 ** 40, 99),
             (2 ** 40, 2 ** 40, 7), (999, 1000, 12345), (300000, 300001, 7)]
    for _ in range(300):
        mx = int(rng.choice([10, 100, 1000, 65535, 65536, 65537, 300001, 2 ** 20,
                             2 ** 33 + 5, 2 ** 40]))
        cases.append((int(rng.integers(0, mx + 1)), mx, int(rng.integers(0, 2 ** 32))))
    for i, mx, seed in cases:
        assert tgrain.index_shuffle(i, mx, seed) == index_shuffle_module.index_shuffle(
            i, max_index=mx, seed=seed, rounds=4), (i, mx, seed)
    # the whole of a range at once, as sampled_keys computes it
    keys = tgrain._index_shuffle_array(np.arange(1000, dtype=np.uint64), 999, 77)
    assert sorted(keys.tolist()) == list(range(1000))
    assert keys.tolist() == [index_shuffle_module.index_shuffle(k, max_index=999, seed=77,
                                                                rounds=4) for k in range(1000)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_sampled_keys_equal_index_sampler(shuffle, shard):
    """grain.IndexSampler(n, ShardOptions(r, P, drop_remainder=True),
    shuffle, num_epochs=1, seed) at the indices k * P + r."""
    import grain.python as grain
    r, P = shard
    for n, seed in ((22, 11), (1001, 2 ** 31 - 5)):
        sampler = grain.IndexSampler(
            num_records=n, shard_options=grain.ShardOptions(r, P, drop_remainder=True),
            shuffle=shuffle, num_epochs=1, seed=seed)
        want, k = [], 0
        while True:
            try:
                want.append(int(sampler[k * P + r].record_key))
            except IndexError:
                break
            k += 1
        got = tgrain.sampled_keys(n, shuffle, seed, r, P)
        assert got.tolist() == want
        assert len(got) == n // P


def test_pretrain_loader_equals_jax_grain_loader(files, tok):
    """Shuffled, two epochs, visual_target 0: the port's GrainPretrainLoader
    (in-process and with two workers) against the JAX one at num_workers=0,
    byte for byte, masking included."""
    path = str(files / "feat.array_record")
    kw = dict(batch_size=4, shuffle=True, seed=9, native_preprocess=False)
    theirs = jgrain.GrainPretrainLoader(path, jax_tokenizer(None, 21128),
                                        JaxShapes(**SHAPES), num_workers=0, **kw)
    want = _epochs(theirs)
    mine = tgrain.GrainPretrainLoader(path, tok, ShapeSpec(**SHAPES), **kw)
    assert len(mine) == len(theirs) == 5 and mine.producer == "python"
    for e, got in enumerate(_epochs(mine)):
        _assert_batches_equal(got, want[e], f"epoch {e}")
    assert want[0][0]["item_id"] != want[1][0]["item_id"]          # epochs reshuffle
    workers = tgrain.GrainPretrainLoader(path, tok, ShapeSpec(**SHAPES), num_workers=2, **kw)
    for e, got in enumerate(_epochs(workers)):
        _assert_batches_equal(got, want[e], f"2 workers, epoch {e}")


def test_alignment_loader_equals_jax_grain_loader(files, tok):
    """Pairs, shuffled, two epochs, the remainder batch kept: the port's
    GrainAlignmentLoader (in-process and with two workers) against the JAX
    one."""
    path = str(files / "pairs.array_record")
    kw = dict(batch_size=4, shuffle=True, seed=4, drop_last=False, native_preprocess=False)
    want = _epochs(jgrain.GrainAlignmentLoader(path, jax_tokenizer(None, 21128),
                                               JaxShapes(**SHAPES), **kw))
    for workers in (0, 2):
        got = _epochs(tgrain.GrainAlignmentLoader(path, tok, ShapeSpec(**SHAPES),
                                                  num_workers=workers, **kw))
        for e in range(2):
            assert len(got[e]) == 3
            _assert_batches_equal(got[e], want[e], f"{workers} workers, epoch {e}")


@pytest.mark.parametrize("kind", ["pretrain", "pairs"])
def test_native_hybrid_equals_in_process(files, tok, kind):
    """With the same-content .k3mr sibling beside the .array_record, the
    loader runs the native producer on grain's order; its batches equal
    the in-process per-record path's over two epochs."""
    cls, name = ((tgrain.GrainPretrainLoader, "feat") if kind == "pretrain"
                 else (tgrain.GrainAlignmentLoader, "pairs"))
    path = str(files / f"{name}.array_record")
    kw = dict(batch_size=4, shuffle=True, seed=6)
    plain = cls(path, tok, ShapeSpec(**SHAPES), native_preprocess=False, **kw)
    want = _epochs(plain)
    hybrid = cls(path, tok, ShapeSpec(**SHAPES), **kw)
    assert hybrid.producer == "native", hybrid.native_error
    for e, got in enumerate(_epochs(hybrid)):
        _assert_batches_equal(got, want[e], f"{kind} hybrid, epoch {e}")


def test_mismatched_sibling_is_refused(files, tok):
    """A .k3mr sibling holding the records in another order is not used
    (the JAX loader's `_siblings_match`): the per-record path runs and
    says why."""
    path = str(files / "feat.array_record")
    loader = tgrain.GrainPretrainLoader(path, tok, ShapeSpec(**SHAPES), batch_size=4,
                                        native_sibling=str(files / "reversed.k3mr"))
    assert loader.producer == "python" and "does not hold the same records" in \
        loader.native_error
    theirs = jgrain.GrainPretrainLoader(path, jax_tokenizer(None, 21128), JaxShapes(**SHAPES),
                                        batch_size=4, native_sibling=str(files / "reversed.k3mr"))
    assert theirs._native is None


def test_shards_split_the_records(files, tok):
    """Three shards of 22 records: each rank reads 7 records (the remainder
    dropped), the shards are disjoint, and `__len__` counts the rank's own
    batches."""
    path = str(files / "feat.array_record")
    seen = []
    for r in range(3):
        loader = tgrain.GrainPretrainLoader(path, tok, ShapeSpec(**SHAPES), batch_size=2,
                                            drop_last=False, shard_index=r, shard_count=3,
                                            native_preprocess=False)
        batches = list(loader)
        assert len(loader) == len(batches) == 4
        seen += [i for b in batches for i in b["item_id"]]
    assert len(seen) == len(set(seen)) == 21


@pytest.mark.parametrize("kind", ["pretrain", "pairs"])
def test_record_loaders_read_array_record(files, tok, kind):
    """PretrainLoader / AlignmentLoader over an .array_record (read in
    Python, as the JAX loaders read it) equal them over the same .k3mr
    (the native producer), two shuffled epochs."""
    cls, name = ((PretrainLoader, "feat") if kind == "pretrain" else (AlignmentLoader, "pairs"))
    kw = dict(batch_size=4, shuffle=True, seed=2)
    arec = cls(str(files / f"{name}.array_record"), tok, ShapeSpec(**SHAPES), **kw)
    k3mr = cls(str(files / f"{name}.k3mr"), tok, ShapeSpec(**SHAPES), **kw)
    assert arec.producer == "python" and "ArrayRecord" in arec.native_error
    assert k3mr.producer == "native"
    for e, (got, want) in enumerate(zip(_epochs(arec), _epochs(k3mr))):
        _assert_batches_equal(got, want, f"{kind} epoch {e}")


def test_pretrain_cli_trains_through_grain(tmp_path):
    """`pretrain --data_backend auto` on an .array_record train file with
    --num_workers 1 trains through GrainPretrainLoader's worker; with
    --data_backend grain and a .k3mr sibling, through the native hybrid; a
    valid file is read by PretrainLoader, as in JAX. Two steps each on the
    CPU, the same losses."""
    from k3m_tpu_torch import pretrain
    from tests.test_torch_trainer import _cli_args
    rng = np.random.default_rng(4)
    recs = [_item(rng, i) for i in range(9)]
    for split, n in (("train", 9), ("valid", 4)):
        write_array_records(str(tmp_path / f"{split}_feat.array_record"), recs[:n])
    argv = [a if a != "{}_feat.k3mr" else "{}_feat.array_record"
            for a in _cli_args(tmp_path, "--num_train_epochs", "1", "--do_eval",
                               "--eval_batch_size", "2", "--num_workers", "1")]
    workers = pretrain.main(argv)
    trec.write_records(str(tmp_path / "train_feat.k3mr"), recs)
    hybrid = pretrain.main(argv + ["--data_backend", "grain", "--output_dir",
                                   str(tmp_path / "out2")])
    assert workers["loader"] == hybrid["loader"] == "GrainPretrainLoader"
    assert (workers["producer"], hybrid["producer"]) == ("python", "native")
    (a,), (b,) = workers["history"], hybrid["history"]
    assert len(a["step_losses"]) == 2 and a["step_losses"] == b["step_losses"]
    assert all(np.isfinite(v) for losses in a["step_losses"] for v in losses.values())
    assert np.isfinite(a["val_loss"]) and a["val_loss"] == b["val_loss"]


def test_finetune_reads_array_record_pair_files(tmp_path):
    """`finetune --do_train --do_eval --do_pred` on .array_record pair files
    (`--file_name '{}_item_alignment.array_record'`): the same losses,
    sweep and predictions as on the same .k3mr files."""
    from k3m_tpu_torch import finetune
    from tests.conftest import NANO
    cfg_path = tmp_path / "nano.json"
    cfg_path.write_text(NANO.replace(vocab_size=21128, v_feature_size=8,
                                     v_target_size=7).to_json_string())
    runs = {}
    for ext in ("k3mr", "array_record"):
        d = tmp_path / ext
        d.mkdir()
        for split, seed in (("train", 5), ("valid", 6), ("test", 7)):
            recs = _pairs(8, seed=seed)
            if ext == "k3mr":
                trec.write_records(str(d / f"{split}_item_alignment.k3mr"), recs)
            else:
                write_array_records(str(d / f"{split}_item_alignment.array_record"), recs)
        runs[ext] = finetune.main(_finetune_args(
            d, cfg_path, "--do_train", "--do_eval", "--do_pred", "--train_batch_size", "4",
            "--num_train_epochs", "1", "--seed", "3",
            "--file_name", "{}_item_alignment." + ext))
    a, b = runs["k3mr"], runs["array_record"]
    assert (a["producer"], b["producer"]) == ("native", "python")
    for key in ("step_losses", "sweep"):
        assert [h[key] for h in a["history"]] == [h[key] for h in b["history"]], key
    assert len(a["history"][0]["step_losses"]) == 2
    with open(a["output"]) as fa, open(b["output"]) as fb:
        assert fa.read() == fb.read()


def test_legacy_cli_takes_array_record_files(tmp_path):
    """`train_concap_struc --file_name train.array_record` reads the file
    as it is (its valid sibling too), where the root CLI's find_records
    would convert it as a raw TSV."""
    from k3m_tpu_torch import train_concap_struc
    rng = np.random.default_rng(5)
    for split in ("train", "valid"):
        write_array_records(str(tmp_path / f"{split}.array_record"),
                            [_item(rng, i) for i in range(3)])
    args = train_concap_struc.get_parser().parse_args(
        ["--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"),
         "--file_name", "train.array_record"])
    for split in ("train", "valid"):
        assert train_concap_struc.find_records(args, split) == str(
            tmp_path / f"{split}.array_record")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["train.array_record",
                                                          "valid.array_record"]
