"""The port's data preparation (k3m_tpu_torch.data.prepare, download,
index) against the JAX package's on inputs the tests write: raw TSV and
item_info jsonl parsing, feature records extracted with the same detector
weights and read back by the JAX package's RecordReader, the pair join,
cleaning and indexing byte for byte, and the port's PretrainLoader on the
records the port prepared."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k3m_tpu.data import download as jdownload
from k3m_tpu.data import index as jindex
from k3m_tpu.data import prepare as jprepare
from k3m_tpu.data.records import RecordReader as JaxReader
from k3m_tpu.data.records import write_records as jax_write_records
from k3m_tpu.vision import frcnn as jfrcnn
from k3m_tpu_torch.data import download, index, prepare
from k3m_tpu_torch.data.records import write_records
from k3m_tpu_torch.vision import frcnn as tfrcnn

TSV_LINES = [
    "i1\t红色连衣裙 夏季\thttp://img/a/1.jpg\t颜色#:#红色#;#尺码#:#M\t女装",
    "i2\tT恤 男款\thttp://img/b/2.png\t材质#:#棉#;#\t男装",
    "bad line with too few fields\tx\ty",
    "i3\t运动鞋\thttp://img/c/3.jpg\t\t鞋",
    "i4\ta\tb\tc\td\textra",
    "i5\t手机壳 苹果\thttp://img/d/5.jpeg\t适用#:#苹果;颜色#:#黑\t数码",
]


def _item_info_lines(names):
    rows = [dict(item_id=10 + i, item_image_name=n, title=f"商品 标题{i} 好看",
                 item_pvs="风格#:#古典#;#材质#:#布" if i % 2 else "颜色#:#红;",
                 cate_name=f"c{i}") for i, n in enumerate(names)]
    return "".join(json.dumps(r, ensure_ascii=False) + "\n" for r in rows)


def write_ppm(path, bgr):
    """Binary PPM (P6, RGB order) from a BGR uint8 image."""
    h, w = bgr.shape[:2]
    path.write_bytes(b"P6\n%d %d\n255\n" % (w, h) + bgr[:, :, ::-1].tobytes())


@pytest.fixture(scope="module")
def raw_tsv(tmp_path_factory):
    path = tmp_path_factory.mktemp("tsv") / "raw.tsv"
    path.write_text("\n".join(TSV_LINES) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("jieba", [False, True])
def test_parse_raw_tsv_equals_jax(raw_tsv, jieba):
    """Malformed lines skipped, '#' stripped, ';' appended, jieba applied
    or not: the same dicts as the JAX package's."""
    got = list(prepare.parse_raw_tsv(raw_tsv, segment_jieba=jieba))
    assert got == list(jprepare.parse_raw_tsv(raw_tsv, segment_jieba=jieba))
    assert [r["item_id"] for r in got] == ["i1", "i2", "i3", "i5"]
    assert all("#" not in r["pv"] and r["pv"].endswith(";") for r in got)


@pytest.mark.parametrize("jieba", [False, True])
def test_parse_item_info_jsonl_equals_jax(tmp_path, jieba):
    path = tmp_path / "info.jsonl"
    path.write_text(_item_info_lines(["a.ppm", "b.ppm", "c.ppm"]), encoding="utf-8")
    got = list(prepare.parse_item_info_jsonl(str(path), segment_jieba=jieba))
    assert got == list(jprepare.parse_item_info_jsonl(str(path), segment_jieba=jieba))
    assert got[1]["pv"].replace(" ", "") == "风格:古典;材质:布;"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Three PPM images (one fills the 64x64 canvas, one is padded into
    it, one is resized to 64x48 and padded) and one name with no file."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(31)
    for name, hw in (("a.ppm", (64, 64)), ("b.ppm", (48, 64)), ("c.ppm", (80, 60))):
        write_ppm(d / name, (rng.random((*hw, 3)) * 255).astype(np.uint8))
    info = d / "info.jsonl"
    info.write_text(_item_info_lines(["a.ppm", "b.ppm", "missing.ppm", "c.ppm"]),
                    encoding="utf-8")
    return d, str(info)


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """Both packages' detectors (7 classes) from one synthetic caffe pkl."""
    path = tmp_path_factory.mktemp("pkl") / "model.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": tfrcnn.synthetic_caffe_state_dict(7, seed=5)}, f)
    jmodel = jfrcnn.FasterRCNN(num_classes=7)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((64, 64, 3), jnp.float32), (64.0, 64.0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jparams = jfrcnn.convert_caffe_weights(jfrcnn.load_caffe_pkl(str(path)), template)
    tmodel = tfrcnn.FasterRCNN(num_classes=7)
    tmodel.load_state_dict(tfrcnn.convert_caffe_weights(
        tfrcnn.load_caffe_pkl(str(path)), tmodel))
    return jmodel, jparams, tmodel.eval()


def _assert_same_records(got_path, want_path):
    """Field for field, both files read by the JAX package's reader:
    strings and integers equal; boxes within 1e-3 px, cls_prob within 1e-4
    and features within 1e-5 of their scale (fp32 convolutions summed in
    another order)."""
    got, want = JaxReader(got_path), JaxReader(want_path)
    assert len(got) == len(want)
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
                atol = {"boxes": 1e-3, "cls_prob": 1e-4}.get(
                    k, 1e-5 * max(1.0, float(np.abs(b[k]).max(initial=0))))
                np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)
            else:
                assert a[k] == b[k], k


def test_feature_records_equal_jax(tmp_path, images, detectors):
    """build_feature_records_batched (min/max size 64, batch 2, bucket 64)
    written by the port equals the JAX package's records for the same items
    and weights, read by the JAX reader; the item with no image gets the
    zero-box record; at least one image yields boxes. The port's per-image
    path (build_feature_records) writes the same records."""
    image_dir, info = images
    jmodel, jparams, tmodel = detectors
    items = list(prepare.parse_item_info_jsonl(info, segment_jieba=False))
    port = tfrcnn.BatchedExtractor(tmodel, batch_size=2, bucket=64, min_size=64,
                                   max_size=64)
    jax_ex = jfrcnn.BatchedExtractor(jmodel, jparams, batch_size=2, bucket=64,
                                     min_size=64, max_size=64)
    got, want, single = (str(tmp_path / n) for n in ("port.k3mr", "jax.k3mr", "one.k3mr"))
    assert write_records(got, prepare.build_feature_records_batched(
        items, port, str(image_dir))) == 4
    jax_write_records(want, jprepare.build_feature_records_batched(
        items, jax_ex, str(image_dir)))
    _assert_same_records(got, want)
    recs = list(JaxReader(got))
    assert recs[2]["num_boxes"] == 0 and recs[2]["cls_prob"].shape == (0, 1601)
    assert any(r["num_boxes"] > 0 for r in recs)
    assert port.fallbacks == 0 and [n for n, _ in port.flush_seconds] == [2, 2]

    def one(item):
        im = tfrcnn.read_image(tfrcnn.image_path(item, str(image_dir)))
        return None if im is None else tfrcnn.extract_rois(tmodel, im, 64, 64)

    write_records(single, prepare.build_feature_records(items, one, str(image_dir)))
    a, b = JaxReader(single), JaxReader(got)
    for i in (0, 2):            # the image that fills its canvas, and none
        assert a[i]["num_boxes"] == b[i]["num_boxes"]
        np.testing.assert_allclose(a[i]["features"], b[i]["features"], rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(b[i]["features"]).max(
                                       initial=0)))


def test_pairs_join_equals_jax(tmp_path):
    """`--pairs --features`: the port's main and the JAX package's main
    write the same pair records (one pair drops: an unknown item)."""
    feat = str(tmp_path / "feat.k3mr")
    rng = np.random.default_rng(2)
    recs = []
    for i in range(4):
        n = int(rng.integers(0, 4))
        recs.append(dict(item_id=f"it{i}", title=f"t{i}", pv="a:b;", category="c",
                         image_h=10, image_w=20, num_boxes=n,
                         boxes=rng.random((n, 4)).astype(np.float32),
                         features=rng.random((n, 2048)).astype(np.float32),
                         cls_prob=rng.random((n, 1601)).astype(np.float32)))
    write_records(feat, recs)
    pairs = tmp_path / "pairs.jsonl"
    pairs.write_text("".join(json.dumps(p) + "\n" for p in (
        dict(src_item_id="it0", tgt_item_id="it1", item_label=1),
        dict(src_item_id="it2", tgt_item_id="it3", label=0),
        dict(src_item_id="it2", tgt_item_id="nope", item_label=1))))
    got, want = str(tmp_path / "p_port.k3mr"), str(tmp_path / "p_jax.k3mr")
    out = prepare.main(["--pairs", str(pairs), "--features", feat, "--output", got])
    jprepare.main(["--pairs", str(pairs), "--features", feat, "--output", want])
    assert out["records"] == 2
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_array_record_paths_are_refused(tmp_path, raw_tsv):
    """Once refused, now written and read as the JAX CLI does: `--output
    x.array_record` writes the records the JAX CLI writes (each package
    reads the other's file, payload for payload), and `--pairs --features
    x.array_record --output y.array_record` writes the pairs the JAX CLI
    joins into a .k3mr."""
    from k3m_tpu.data.grain_pipeline import ArrayRecordStore as JaxStore
    from k3m_tpu.data.records import pack_record as jax_pack
    from k3m_tpu_torch.data.array_record import ArrayRecordStore
    from k3m_tpu_torch.data.records import RecordReader
    got, want = str(tmp_path / "f_port.array_record"), str(tmp_path / "f_jax.array_record")
    assert prepare.main(["--input", raw_tsv, "--output", got])["records"] == 4
    jprepare.main(["--input", raw_tsv, "--output", want])
    mine, theirs = ArrayRecordStore(want), JaxStore(got)
    assert len(mine) == len(theirs) == 4
    assert [mine.payload(i) for i in range(4)] == [jax_pack(theirs[i]) for i in range(4)]
    pairs = tmp_path / "pairs.jsonl"
    pairs.write_text("".join(json.dumps(p) + "\n" for p in (
        dict(src_item_id="i1", tgt_item_id="i2", item_label=1),
        dict(src_item_id="i5", tgt_item_id="i3", label=0),
        dict(src_item_id="i2", tgt_item_id="nope", item_label=1))))
    p_got, p_want = str(tmp_path / "p_port.array_record"), str(tmp_path / "p_jax.k3mr")
    out = prepare.main(["--pairs", str(pairs), "--features", got, "--output", p_got])
    jprepare.main(["--pairs", str(pairs), "--features", want, "--output", p_want])
    assert out["records"] == 2
    a, b = ArrayRecordStore(p_got), RecordReader(p_want)
    assert [a.payload(i) for i in range(len(a))] == [b.payload(i) for i in range(len(b))]


def test_extract_features_needs_the_card_unless_device_cpu(tmp_path, raw_tsv):
    """--extract_features runs on the card by default: without CUDA it
    raises before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare.main(["--input", raw_tsv, "--image_dir", str(tmp_path),
                      "--extract_features", "--output", str(tmp_path / "o.k3mr")])


def test_cli_extracts_on_cpu_and_the_pretrain_loader_reads_it(tmp_path, images,
                                                              monkeypatch):
    """`prepare --item_info --image_dir --extract_features --device cpu`
    at the full configuration (1600 classes, 600/1000, 300 proposals, 36
    objects; the seeded synthetic weights, no pkl): every image yields
    boxes inside its raw size, 2048-d finite features, cls_prob rows that
    sum to 1; the missing image gets the zero-box record; then the port's
    PretrainLoader reads a batch of these records."""
    from k3m_tpu_torch.data.pipeline import PretrainLoader
    from k3m_tpu_torch.data.preprocess import ShapeSpec
    from k3m_tpu_torch.tokenization import get_tokenizer

    image_dir, info = images
    out = str(tmp_path / "train_feat.k3mr")
    run = prepare.main(["--item_info", info, "--image_dir", str(image_dir),
                        "--extract_features", "--extract_batch_size", "4",
                        "--device", "cpu", "--output", out])
    assert run["records"] == 4 and run["extractor"].fallbacks == 0
    recs = list(JaxReader(out))
    sizes = {0: (64, 64), 1: (48, 64), 3: (80, 60)}
    for i, r in enumerate(recs):
        if i not in sizes:
            assert r["num_boxes"] == 0
            continue
        n = r["num_boxes"]
        assert 0 < n <= 36 and (r["image_h"], r["image_w"]) == sizes[i]
        assert r["features"].shape == (n, 2048) and np.isfinite(r["features"]).all()
        np.testing.assert_allclose(r["cls_prob"].sum(-1), 1.0, atol=1e-5)
        assert (r["boxes"] >= 0).all()
        assert (r["boxes"][:, [0, 2]] <= r["image_w"]).all()
        assert (r["boxes"][:, [1, 3]] <= r["image_h"]).all()
    monkeypatch.setenv("K3M_NATIVE_PREPROCESS", "0")
    loader = PretrainLoader(out, get_tokenizer(), ShapeSpec(max_seq_len=16,
                                                            max_seq_len_pv=24,
                                                            max_num_pv=4),
                            batch_size=2, shuffle=False, native_preprocess=False)
    batch = next(iter(loader))
    n0 = recs[0]["num_boxes"]
    assert batch["image_feat"].shape == (2, 37, 2048)
    assert batch["image_mask"][0].sum() == n0 + 1          # the global token too
    # after the global token, the first record's regions, those that the
    # RoI masking did not pick as targets unchanged
    kept = batch["image_label"][0, :n0] == -1
    assert kept.any()
    np.testing.assert_array_equal(batch["image_feat"][0, 1:1 + n0][kept],
                                  recs[0]["features"][kept])


def test_clean_and_download_offline_equals_jax(tmp_path):
    """Download off: the cleaned file byte for byte the JAX package's."""
    raw = tmp_path / "raw.tsv"
    raw.write_text("\n".join(TSV_LINES) + "\n", encoding="utf-8")
    n = download.clean_and_download(str(raw), 3, str(tmp_path / "port"),
                                    image_dir=str(tmp_path / "img"))
    assert n == jdownload.clean_and_download(str(raw), 3, str(tmp_path / "jax"))
    assert n == 4 and (tmp_path / "img").is_dir()
    assert ((tmp_path / "port" / "id_title_pvs_cls.txt3").read_bytes()
            == (tmp_path / "jax" / "id_title_pvs_cls.txt3").read_bytes())


def test_build_index_equals_jax(tmp_path, raw_tsv, capsys):
    """build_index and its CLI: every file byte for byte the JAX package's."""
    assert index.main(["--input", raw_tsv, "--output_dir", str(tmp_path / "port"),
                       "--split", "valid"]) == {"rows": 4}
    jindex.build_index(jprepare.parse_raw_tsv(raw_tsv), str(tmp_path / "jax"), "valid")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 6
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
