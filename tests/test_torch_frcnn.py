"""The port's whole Faster R-CNN (k3m_tpu_torch.vision.frcnn) against the JAX
package's at 64x64 with the same weights: JAX's own init carried across
by from_jax_vision_params, and a seeded detectron2-layout caffe pkl loaded
by both packages' converters; then the extraction paths (extract_rois,
BatchedExtractor.extract_many) and the strict pkl import. The tolerance of
each assertion is stated beside it."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k3m_tpu.vision import frcnn as jfrcnn
from k3m_tpu_torch.convert import from_jax_vision_params
from k3m_tpu_torch.vision import frcnn as tfrcnn

NUM_CLASSES = 7
HW = (64.0, 64.0)


def _port(sd):
    model = tfrcnn.FasterRCNN(num_classes=NUM_CLASSES)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _jax_apply(model):
    return jax.jit(lambda p, x, hw: model.apply(p, x, hw))


@pytest.fixture(scope="module")
def jax_model():
    return jfrcnn.FasterRCNN(num_classes=NUM_CLASSES)


@pytest.fixture(scope="module")
def jax_init(jax_model):
    """JAX's own init (flax defaults: lecun-normal convs, identity BN)."""
    return jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((64, 64, 3), jnp.float32), HW)


@pytest.fixture(scope="module")
def caffe(tmp_path_factory, jax_model):
    """A seeded detectron2-layout pkl (the port's synthetic construction,
    which makes random weights select boxes), loaded by both converters."""
    path = tmp_path_factory.mktemp("frcnn") / "model_final.pkl"
    sd = tfrcnn.synthetic_caffe_state_dict(NUM_CLASSES, seed=3)
    with open(path, "wb") as f:
        pickle.dump({"model": sd, "__author__": "test"}, f)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((64, 64, 3), jnp.float32), HW)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jparams = jfrcnn.convert_caffe_weights(jfrcnn.load_caffe_pkl(str(path)), template)
    model = tfrcnn.FasterRCNN(num_classes=NUM_CLASSES)
    tsd = tfrcnn.convert_caffe_weights(tfrcnn.load_caffe_pkl(str(path)), model)
    return dict(path=str(path), sd=sd, jparams=jparams, tsd=tsd)


def _images(seed):
    rng = np.random.default_rng(seed)
    exact = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    small = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    return exact, small


def _mean_subtracted(img):
    return img.astype(np.float32) - np.asarray(jfrcnn.PIXEL_MEAN_BGR, np.float32)


def _compare_outputs(got, want, what):
    """Proposals and their validity equal (boxes to atol 1e-3 px: the same
    anchors and deltas within fp32 rounding, the same NMS picks); features
    within 1e-5 of their scale (fp32 convolutions summed in another order
    through 100+ layers), probabilities and class boxes within 1e-4."""
    np.testing.assert_array_equal(got["proposal_valid"], want["proposal_valid"],
                                  err_msg=what)
    np.testing.assert_allclose(got["proposal_boxes"], want["proposal_boxes"],
                               atol=1e-3, rtol=0, err_msg=what)
    scale = np.abs(want["features"]).max()
    np.testing.assert_allclose(got["features"], want["features"], atol=1e-5 * scale,
                               rtol=0, err_msg=what)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-4, rtol=0,
                               err_msg=what)
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=0,
                               err_msg=what)


def _run_both(tmodel, jmodel, jparams, images, hws):
    """The port on one padded batch; JAX on each image alone (as its
    BatchedExtractor vmaps it), both then through _select_instances."""
    canvas = np.zeros((len(images), 64, 64, 3), np.float32)
    for j, im in enumerate(images):
        canvas[j, :im.shape[0], :im.shape[1]] = im
    with tfrcnn.inference():
        out = tmodel(torch.from_numpy(canvas).permute(0, 3, 1, 2),
                     torch.tensor(hws, dtype=torch.float32))
        sel = tfrcnn._select_instances(out, out["proposal_valid"])
    apply = _jax_apply(jmodel)
    results = []
    for j, hw in enumerate(hws):
        want = jax.device_get(apply(jparams, canvas[j], tuple(hw)))
        want_sel = jax.device_get(jfrcnn._select_instances(want, want["proposal_valid"]))
        results.append(({k: v[j].numpy() for k, v in out.items()},
                        {k: v[j].numpy() for k, v in sel.items()}, want, want_sel))
    return results


def _compare_selection(got, want, what):
    """Selection from near-equal outputs: the same rows and slots; boxes
    within 1e-3 px, features and probabilities as the outputs."""
    for k in ("rows", "valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["cls_prob"], want["cls_prob"], atol=1e-4, rtol=0)
    scale = max(np.abs(want["features"]).max(), 1.0)
    np.testing.assert_allclose(got["features"], want["features"], atol=1e-5 * scale,
                               rtol=0)


def test_whole_model_with_jax_init_equals_jax(jax_model, jax_init):
    """FasterRCNN(num_classes=7) at 64x64 with JAX's own init carried
    across by from_jax_vision_params: every output of the forward and the
    selection against JAX's."""
    img = _mean_subtracted(_images(0)[0])
    tmodel = _port(from_jax_vision_params(jax_init))
    ((got, got_sel, want, want_sel),) = _run_both(tmodel, jax_model, jax_init, [img],
                                                  [HW])
    _compare_outputs(got, want, "jax init")
    _compare_selection(got_sel, want_sel, "jax init")
    # JAX's init leaves activations unbounded (~700 at res5): most proposals
    # degenerate and the selection keeps none, so the caffe-pkl test below
    # is the one that selects boxes
    assert want["proposal_valid"].any()


def test_whole_model_from_the_caffe_pkl_equals_jax(jax_model, caffe):
    """The same synthetic caffe pkl through both converters: a batch of an
    image that fills its canvas and one padded into it (48x64 in 64x64)
    against JAX per image; both select boxes (the construction's point)."""
    exact, small = (_mean_subtracted(im) for im in _images(1))
    results = _run_both(_port(caffe["tsd"]), jax_model, caffe["jparams"],
                        [exact, small], [HW, (48.0, 64.0)])
    for j, (got, got_sel, want, want_sel) in enumerate(results):
        _compare_outputs(got, want, f"image {j}")
        _compare_selection(got_sel, want_sel, f"image {j}")
        assert want_sel["valid"].sum() == tfrcnn.NUM_OBJECTS
    # no proposal of the padded image reaches into the padding
    assert (results[1][0]["proposal_boxes"][:, 3] <= 48.0).all()


def test_caffe_pkl_both_converters_give_the_same_weights(caffe):
    """Every converted tensor, the folded BatchNorms included, equal bit
    for bit to the JAX converter's carried across by from_jax_vision_params."""
    want = from_jax_vision_params(caffe["jparams"])
    assert set(caffe["tsd"]) == set(want)
    for k, v in want.items():
        assert torch.equal(caffe["tsd"][k], v), k
    g = caffe["sd"]["backbone.res4.22.conv2.norm.weight"]
    var = caffe["sd"]["backbone.res4.22.conv2.norm.running_var"]
    np.testing.assert_array_equal(caffe["tsd"]["backbone.res4.22.conv2.norm.scale"].numpy(),
                                  g / np.sqrt(var + 1e-5))


@pytest.mark.parametrize("fault", ["leftover", "missing"])
def test_caffe_strict_load_raises_as_jax(caffe, jax_model, fault, monkeypatch):
    """Strict (the default): a planted leftover source tensor and a planted
    missing weight both raise in both converters; K3M_CAFFE_LENIENT=1 lets
    the leftover pass in both, and the missing weight still raises."""
    sd = dict(jfrcnn.load_caffe_pkl(caffe["path"]))
    if fault == "leftover":
        sd["backbone.res4.23.conv1.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    else:
        del sd["roi_heads.res5.2.conv3.weight"]
    template = jax.tree.map(np.zeros_like, caffe["jparams"])
    model = tfrcnn.FasterRCNN(num_classes=NUM_CLASSES)
    with pytest.raises((KeyError, ValueError)):
        jfrcnn.convert_caffe_weights(dict(sd), template)
    with pytest.raises(ValueError, match="K3M_CAFFE_LENIENT"):
        tfrcnn.convert_caffe_weights(dict(sd), model)
    monkeypatch.setenv("K3M_CAFFE_LENIENT", "1")
    if fault == "leftover":
        jfrcnn.convert_caffe_weights(dict(sd), template)
        assert set(tfrcnn.convert_caffe_weights(dict(sd), model)) == set(caffe["tsd"])
    else:
        with pytest.raises(KeyError):
            jfrcnn.convert_caffe_weights(dict(sd), template)
        with pytest.raises(KeyError):
            tfrcnn.convert_caffe_weights(dict(sd), model)


def test_extract_rois_and_batched_extractor_equal_jax(jax_model, caffe):
    """extract_rois on an image that fills its canvas, and
    BatchedExtractor.extract_many on [that image, a padded one, None]
    (batch 2, bucket 64, min/max size 64): the detections equal JAX's,
    num_boxes and sizes exactly, boxes within 1e-3 px of the raw image,
    features and cls_prob as the outputs; the batched and per-image results
    of the port agree likewise; at least one image yields boxes."""
    exact, small = _images(2)
    tmodel = _port(caffe["tsd"])
    single = tfrcnn.extract_rois(tmodel, exact, min_size=64, max_size=64)
    want_single = jfrcnn.extract_rois(jax_model, caffe["jparams"], exact,
                                      min_size=64, max_size=64)
    got = tfrcnn.BatchedExtractor(tmodel, batch_size=2, bucket=64, min_size=64,
                                  max_size=64).extract_many([exact, small, None])
    want = jfrcnn.BatchedExtractor(jax_model, caffe["jparams"], batch_size=2, bucket=64,
                                   min_size=64, max_size=64).extract_many(
        [exact, small, None])
    assert got[2] is None and want[2] is None
    pairs = [(single, want_single), (got[0], want[0]), (got[1], want[1]),
             (got[0], single)]
    for a, b in pairs:
        assert (a is None) == (b is None)
        if a is None:
            continue
        for k in ("image_h", "image_w", "num_boxes"):
            assert a[k] == b[k], k
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(a["cls_prob"], b["cls_prob"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(a["features"], b["features"],
                                   atol=1e-5 * max(1.0, np.abs(b["features"]).max()),
                                   rtol=0)
    assert got[0] is not None and got[0]["num_boxes"] > 0
    assert got[1]["image_h"] == 48 and (got[1]["boxes"][:, 3] <= 48).all()
