"""The port's legacy feature-TSV tools (k3m_tpu_torch.data.legacy_tsv)
against the JAX package's (k3m_tpu/data/legacy_tsv.py), on the CPU, on the
same seeded numpy detections:

  * write_tsv writes the same bytes, with the reference's "b'...'" framing;
  * read_tsv of both framings gives equal arrays, bit for bit;
  * serialize_tsv_to_records (and its CLI) writes the same records, field
    for field and bit for bit (the same file bytes), for both df-CSV
    schemas; the records keep the legacy layout (no title, no item_id);
  * generate_tsv with the port's extractor at 64x64 (a seeded caffe pkl's
    weights, converted by the JAX package and carried across by
    from_jax_vision_params) against JAX's extractor: the same rows, within
    test_torch_frcnn.py's tolerances.
"""

import base64
import csv
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from k3m_tpu.data import legacy_tsv as jtsv
from k3m_tpu.data.records import RecordReader as JaxReader
from k3m_tpu.vision import frcnn as jfrcnn
from k3m_tpu_torch.convert import from_jax_vision_params
from k3m_tpu_torch.data import legacy_tsv as ttsv
from k3m_tpu_torch.data.records import RecordReader
from k3m_tpu_torch.vision import frcnn as tfrcnn


def _dets(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nb = int(rng.integers(0, 5)) if i else 36          # 0 boxes too
        out.append(dict(image_id=f"img_{i}", image_h=int(rng.integers(100, 900)),
                        image_w=int(rng.integers(100, 900)), num_boxes=nb,
                        boxes=(rng.random((nb, 4)) * 100).astype(np.float32),
                        features=rng.normal(size=(nb, 2048)).astype(np.float32),
                        cls_prob=rng.random((nb, 1601)).astype(np.float32)))
    return out


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), k
            else:
                assert type(a[k]) is type(b[k]) and a[k] == b[k], k


def test_write_tsv_writes_jax_bytes_with_the_reference_framing(tmp_path):
    dets = _dets(4)
    assert ttsv.write_tsv(dets, str(tmp_path / "port.tsv")) == 4
    assert jtsv.write_tsv(dets, str(tmp_path / "jax.tsv")) == 4
    data = (tmp_path / "port.tsv").read_bytes()
    assert data == (tmp_path / "jax.tsv").read_bytes()
    csv.field_size_limit(500 * 1024 * 1024)
    with open(tmp_path / "port.tsv") as f:
        row = next(csv.DictReader(f, delimiter="\t", fieldnames=ttsv.FIELDNAMES))
    assert row["boxes"].startswith("b'") and row["boxes"].endswith("'")
    boxes = np.frombuffer(base64.b64decode(row["boxes"][2:-1]), np.float32)
    assert boxes.tobytes() == dets[0]["boxes"].tobytes()


@pytest.mark.parametrize("framing", ["reference", "plain"])
def test_read_tsv_of_both_framings_equals_jax(tmp_path, framing):
    dets = _dets(5, seed=1)
    path = str(tmp_path / "feat.tsv")
    ttsv.write_tsv(dets, path)
    if framing == "plain":            # clean base64, as other tools write it
        text = open(path).read()
        open(path, "w").write(text.replace("\tb'", "\t").replace("'\t", "\t")
                              .replace("'\n", "\n").replace("'\r\n", "\r\n"))
        assert "b'" not in open(path).read()
    got, want = list(ttsv.read_tsv(path)), list(jtsv.read_tsv(path))
    _assert_rows_equal(got, want)
    for a, d in zip(got, dets):
        assert a["features"].tobytes() == d["features"].tobytes()


def _df(path, schema):
    cols = (["image_id", "caption", "pv", "category"] if schema == "reference"
            else ["item_id", "title", "pv", "category"])
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for i in (0, 1, 3, 4, 9):        # img_2 unmatched, img_9 without a row
            w.writerow({cols[0]: f"img_{i}", cols[1]: f"标题 {i}",
                        "pv": f"品牌:x{i};颜色:红", "category": f"c{i % 2}"})


@pytest.mark.parametrize("schema", ["reference", "ours"])
def test_serialize_writes_jax_records(tmp_path, schema):
    """Two TSV shards joined with a df CSV by image_id: the same records as
    JAX's, the same file bytes, from the function and from the CLI; the
    caption index equals JAX's; an unmatched row is dropped."""
    dets = _dets(5, seed=2)
    shards = [str(tmp_path / "feat.tsv.0"), str(tmp_path / "feat.tsv.1")]
    ttsv.write_tsv(dets[:3], shards[0])
    ttsv.write_tsv(dets[3:], shards[1])
    df = str(tmp_path / "df_train.csv")
    _df(df, schema)
    assert ttsv.load_caption_index(df) == jtsv.load_caption_index(df)
    port, jx, cli = (str(tmp_path / f"{n}.k3mr") for n in ("port", "jax", "cli"))
    assert ttsv.serialize_tsv_to_records(shards, df, port) == 4
    assert jtsv.serialize_tsv_to_records(shards, df, jx) == 4
    assert ttsv.main(["serialize", "--tsv", *shards, "--df_csv", df,
                      "--output", cli]) == dict(records=4, output=cli)
    data = open(jx, "rb").read()
    assert open(port, "rb").read() == data and open(cli, "rb").read() == data
    got, want = list(RecordReader(port)), list(JaxReader(jx))
    _assert_rows_equal(got, want)
    assert [r["image_id"] for r in got] == ["img_0", "img_1", "img_3", "img_4"]
    assert got[1]["caption"] == "标题 1" and got[1]["pv"] == "品牌:x1;颜色:红"
    # the reference's legacy layout: what the pretraining loader and
    # ImageFeaturesReader key on is absent (ROADMAP.md Queue 3, facts)
    assert "title" not in got[0] and "item_id" not in got[0]


# ------------------------------------------------------ generate_tsv

@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """The JAX detector with a seeded detectron2-layout pkl's weights
    (1600 classes, so read_tsv's 1601 columns hold), and the port's with
    the same weights carried across by from_jax_vision_params."""
    path = tmp_path_factory.mktemp("frcnn") / "model_final.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": tfrcnn.synthetic_caffe_state_dict(seed=3)}, f)
    jmodel = jfrcnn.FasterRCNN()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((64, 64, 3), jnp.float32), (64.0, 64.0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jparams = jfrcnn.convert_caffe_weights(jfrcnn.load_caffe_pkl(str(path)), template)
    tmodel = tfrcnn.FasterRCNN()
    tmodel.load_state_dict(from_jax_vision_params(jparams), strict=True)
    return jmodel, jparams, tmodel.eval()


def _images(d):
    """A 64x64 and a 48x64 image, and a listed file that does not exist."""
    rng = np.random.default_rng(5)
    cv2.imwrite(str(d / "a.png"), (rng.random((64, 64, 3)) * 255).astype(np.uint8))
    cv2.imwrite(str(d / "b.png"), (rng.random((48, 64, 3)) * 255).astype(np.uint8))
    return [("a", "a.png"), ("gone", "gone.png"), ("b", "b.png")]


def test_generate_tsv_with_the_port_extractor_equals_jax(tmp_path, detectors):
    """generate_tsv over [a 64x64 image, a missing file, a 48x64 image] at
    min/max size 64: the port's BatchedExtractor (batch 2, bucket 64) and
    its per-image path (extract_rois) against JAX's BatchedExtractor with
    the same weights. The missing image is skipped by all three; ids,
    sizes and box counts equal; boxes within 1e-3 px, cls_prob within
    1e-4, features within 1e-5 of their scale (test_torch_frcnn.py's
    tolerances); the port's two paths agree likewise."""
    jmodel, jparams, tmodel = detectors
    pairs = _images(tmp_path)
    sizes = dict(min_size=64, max_size=64)
    jax_tsv, batched_tsv, single_tsv = (str(tmp_path / f"{n}.tsv")
                                        for n in ("jax", "batched", "single"))
    assert jtsv.generate_tsv(pairs, str(tmp_path), jax_tsv, extractor=jfrcnn.BatchedExtractor(
        jmodel, jparams, batch_size=2, bucket=64, **sizes)) == 2
    port = tfrcnn.BatchedExtractor(tmodel, batch_size=2, bucket=64, **sizes)
    assert ttsv.generate_tsv(pairs, str(tmp_path), batched_tsv, extractor=port) == 2
    assert port.fallbacks == 0

    def per_image(item):
        image = tfrcnn.read_image(str(tmp_path / item["item_image_name"]))
        if image is None:
            raise FileNotFoundError(item["item_image_name"])   # logged and skipped
        return tfrcnn.extract_rois(tmodel, image, **sizes)

    assert ttsv.generate_tsv(pairs, str(tmp_path), single_tsv, extractor=per_image) == 2
    want = list(ttsv.read_tsv(jax_tsv))
    assert [r["image_id"] for r in want] == ["a", "b"]
    assert want[0]["num_boxes"] > 0
    batched, single = list(ttsv.read_tsv(batched_tsv)), list(ttsv.read_tsv(single_tsv))
    assert [r["image_id"] for r in single] == ["a", "b"]
    assert [r["image_h"] for r in single] == [64, 48]
    # the padded image alone in its canvas differs from the batched path by
    # the convolutions' border halo (frcnn.BatchedExtractor), so the
    # per-image path is held on the image that fills its canvas
    cases = [(a, b, "batched") for a, b in zip(batched, want)]
    cases.append((single[0], want[0], "per-image"))
    for a, b, what in cases:
        for k in ("image_id", "image_h", "image_w", "num_boxes"):
            assert a[k] == b[k], (what, k)
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3, rtol=0, err_msg=what)
        np.testing.assert_allclose(a["cls_prob"], b["cls_prob"], atol=1e-4, rtol=0,
                                   err_msg=what)
        np.testing.assert_allclose(a["features"], b["features"], rtol=0, err_msg=what,
                                   atol=1e-5 * max(1.0, np.abs(b["features"]).max()))
