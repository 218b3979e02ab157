"""The port's vision modules (k3m_tpu_torch.vision: boxes, roi, resnet and
the frcnn pipeline pieces) against the JAX package's, on the same seeded
numpy inputs and, for the networks, the same weights (carried across by
k3m_tpu_torch.convert.from_jax_vision_params). The tolerance of each
assertion is stated beside it."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from k3m_tpu.vision import boxes as jbox
from k3m_tpu.vision import frcnn as jfrcnn
from k3m_tpu.vision import resnet as jresnet
from k3m_tpu.vision.roi import roi_align as j_roi_align
from k3m_tpu.vision.roi import roi_pool as j_roi_pool
from k3m_tpu_torch.convert import from_jax_vision_params
from k3m_tpu_torch.vision import boxes as tbox
from k3m_tpu_torch.vision import frcnn as tfrcnn
from k3m_tpu_torch.vision import resnet as tresnet
from k3m_tpu_torch.vision.roi import roi_align, roi_pool


def random_boxes(rng, n, h, w, min_size=2.0):
    """As tests/test_vision_oracle.py draws them."""
    x1 = rng.uniform(0, w - min_size, n)
    y1 = rng.uniform(0, h - min_size, n)
    x2 = np.minimum(x1 + rng.uniform(min_size, w / 2, n), w)
    y2 = np.minimum(y1 + rng.uniform(min_size, h / 2, n), h)
    return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def nchw(feat_hwc):
    return T(feat_hwc).permute(2, 0, 1)


# ------------------------------------------------------------------ boxes

@pytest.mark.parametrize("fh,fw,stride,sizes,ratios", [
    (38, 63, 16, (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)),
    (3, 5, 8, (16,), (1.0,)),
    (1, 1, 16, (32, 64), (0.5, 2.0)),
])
def test_anchors_equal_jax(fh, fw, stride, sizes, ratios):
    """Anchors: exactly the JAX package's, in its (h, w, a) order."""
    np.testing.assert_array_equal(
        tbox.generate_anchors(fh, fw, stride, sizes, ratios),
        jbox.generate_anchors(fh, fw, stride, sizes, ratios))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_apply_deltas_clip_iou_match_jax(weights):
    """apply_deltas (with deltas large enough to reach the scale clamp),
    clip_boxes and IoU: within 1e-5 (relative, exp rounding) of JAX."""
    rng = np.random.default_rng(3)
    boxes = random_boxes(rng, 64, 600, 800, min_size=5.0)
    deltas = (rng.standard_normal((64, 4)) * 3.0).astype(np.float32)
    deltas[:4, 2:] = 50.0                       # past log(1000/16)
    got = tbox.apply_deltas(T(deltas), T(boxes), weights=weights).numpy()
    want = np.asarray(jbox.apply_deltas(jnp.asarray(deltas), jnp.asarray(boxes),
                                        weights=weights))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbox.clip_boxes(T(want), 600.0, 800.0).numpy(),
                               np.asarray(jbox.clip_boxes(jnp.asarray(want), 600.0, 800.0)),
                               rtol=1e-5, atol=1e-5)
    clipped = np.asarray(jbox.clip_boxes(jnp.asarray(want), 600.0, 800.0))
    np.testing.assert_allclose(tbox.box_iou_xyxy(T(clipped), T(boxes)).numpy(),
                               np.asarray(jbox.box_iou_xyxy(jnp.asarray(clipped),
                                                            jnp.asarray(boxes))),
                               rtol=1e-5, atol=1e-5)


def test_clip_boxes_per_image_sizes():
    """One (h, w) per image of a batch: each image's boxes clipped to its
    own size, as the JAX package clips each vmapped image."""
    rng = np.random.default_rng(4)
    boxes = rng.uniform(-50, 250, (3, 20, 4)).astype(np.float32)
    hw = np.array([[100.0, 200.0], [64.0, 64.0], [180.0, 90.0]], np.float32)
    got = tbox.clip_boxes(T(boxes), T(hw[:, 0:1]), T(hw[:, 1:2])).numpy()
    for b in range(3):
        want = np.asarray(jbox.clip_boxes(jnp.asarray(boxes[b]), hw[b, 0], hw[b, 1]))
        np.testing.assert_array_equal(got[b], want)


def _nms_case(kind, seed):
    rng = np.random.default_rng(200 + seed)
    n = 80
    boxes = random_boxes(rng, n, 200, 200, min_size=10.0)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    if kind == "ties":
        scores = np.round(scores * 4) / 4           # many equal scores
        boxes[10:20] = boxes[0]                     # identical boxes too
    elif kind == "-inf":
        scores[rng.random(n) < 0.4] = -np.inf
    elif kind == "all -inf":
        scores[:] = -np.inf
    elif kind == "degenerate":
        boxes[::3, 2] = boxes[::3, 0]               # zero width: IoU 0
        scores[::5] = -np.inf
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "-inf", "all -inf", "degenerate"])
@pytest.mark.parametrize("thresh,max_out", [(0.5, 40), (0.7, 100)])
def test_nms_fixed_equals_jax(kind, thresh, max_out):
    """Indices and valid equal the JAX package's in every slot (invalid
    slots included), for a batch of three images in one call, each held to
    JAX's call on that image alone: ties go to the first maximum, -inf
    scores are never valid, max_out beyond n keeps picking invalid slots."""
    cases = [_nms_case(kind, s) for s in range(3)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    idx, valid = tbox.nms_fixed(T(boxes), T(scores), thresh, max_out)
    for b in range(3):
        ji, jv = jbox.nms_fixed(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                thresh, max_out)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jv))


@pytest.mark.parametrize("kind", ["random", "ties", "-inf"])
def test_batched_nms_fixed_equals_jax(kind):
    """The class-offset NMS, one pass per threshold of the sweep over one
    IoU matrix: each pass equals JAX's batched_nms_fixed at that threshold
    (indices and valid)."""
    rng = np.random.default_rng(7)
    boxes, scores = _nms_case(kind, 1)
    cls = rng.integers(0, 4, len(scores))
    sweep = (0.5, 0.6, 0.7, 0.8, 0.9)
    idx, valid = tbox.batched_nms_fixed(T(boxes)[None], T(scores)[None],
                                        T(cls)[None], sweep, 36)
    assert idx.shape == (1, 5, 36)
    for s, t in enumerate(sweep):
        ji, jv = jbox.batched_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                                        jnp.asarray(cls), t, 36)
        np.testing.assert_array_equal(idx[0, s].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(valid[0, s].numpy(), np.asarray(jv))
    one, one_valid = tbox.batched_nms_fixed(T(boxes), T(scores), T(cls), 0.6, 36)
    np.testing.assert_array_equal(one.numpy(), idx[0, 1].numpy())
    np.testing.assert_array_equal(one_valid.numpy(), valid[0, 1].numpy())


# -------------------------------------------------------------------- roi

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roi_align_equals_jax(seed):
    """RoIAlign V2 at the oracle shapes of tests/test_vision_oracle.py
    (17x23x5 map, 12 boxes, 7x7, ratio 2), two maps in one batch: within
    atol 2e-5 of the JAX package's per map, at chunks 0 and 5."""
    rng = np.random.default_rng(seed)
    H, W, C, P, scale = 17, 23, 5, 7, 1.0 / 16
    feats = rng.standard_normal((2, H, W, C)).astype(np.float32)
    boxes = np.stack([random_boxes(rng, 12, H / scale, W / scale, min_size=8.0)
                      for _ in range(2)])
    boxes[0, 0] = [0.0, 0.0, W / scale, H / scale]       # whole map: edge samples
    for chunk in (0, 5):
        got = roi_align(torch.stack([nchw(f) for f in feats]), T(boxes), scale,
                        output_size=P, sampling_ratio=2, chunk=chunk)
        assert got.shape == (2, 12, C, P, P)
        for b in range(2):
            want = np.asarray(j_roi_align(jnp.asarray(feats[b]), jnp.asarray(boxes[b]),
                                          scale, output_size=P, sampling_ratio=2))
            np.testing.assert_allclose(got[b].permute(0, 2, 3, 1).numpy(), want,
                                       atol=2e-5, rtol=0)


@pytest.mark.parametrize("chunk", [0, 5, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_roi_pool_equals_jax(chunk, seed):
    """Caffe RoIPool, with a degenerate box, a whole-image box and a box
    past the map: within atol 1e-6 of the JAX package's (max is exact, so
    the chunk changes nothing), two maps in one batch."""
    rng = np.random.default_rng(100 + seed)
    H, W, C, P, scale = 31, 43, 4, 14, 1.0 / 16
    feats = rng.standard_normal((2, H, W, C)).astype(np.float32)
    boxes = np.stack([random_boxes(rng, 16, H / scale, W / scale, min_size=4.0)
                      for _ in range(2)])
    boxes[:, 0] = [3.0, 5.0, 3.5, 5.5]
    boxes[:, 1] = [0.0, 0.0, W / scale, H / scale]
    boxes[1, 2] = [W / scale - 8, H / scale - 8, W / scale + 300, H / scale + 300]
    got = roi_pool(torch.stack([nchw(f) for f in feats]), T(boxes), scale,
                   output_size=P, chunk=chunk)
    for b in range(2):
        want = np.asarray(j_roi_pool(jnp.asarray(feats[b]), jnp.asarray(boxes[b]),
                                     scale, output_size=P, chunk=chunk))
        np.testing.assert_allclose(got[b].permute(0, 2, 3, 1).numpy(), want, atol=1e-6)


def test_roi_pool_reads_k3m_roi_chunk_at_each_call(monkeypatch):
    """K3M_ROI_CHUNK is read per call, and any chunk gives the same bits."""
    rng = np.random.default_rng(9)
    feat = nchw(rng.standard_normal((20, 30, 3)).astype(np.float32))[None]
    boxes = T(random_boxes(rng, 11, 320, 480))[None]
    monkeypatch.setenv("K3M_ROI_CHUNK", "3")
    a = roi_pool(feat, boxes, 1 / 16, output_size=7)
    monkeypatch.setenv("K3M_ROI_CHUNK", "0")
    b = roi_pool(feat, boxes, 1 / 16, output_size=7)
    assert torch.equal(a, b)


# ----------------------------------------------------------------- resnet

def _jax_init(module, x):
    return jax.jit(module.init)(jax.random.PRNGKey(0), x)


def _perturb_bn(params, rng):
    """FrozenBN leaves the init sets to 1 and 0 get random values, so that
    the scale and bias are really carried across."""
    def leaf(path, v):
        name = jax.tree_util.keystr(path)
        if "_bn" in name or "bn1" in name:
            return (rng.uniform(0.5, 1.5, v.shape) if "scale" in name
                    else rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        return np.asarray(v)
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.mark.parametrize("stride,has_shortcut,hw", [(1, True, (9, 11)), (2, True, (9, 11)),
                                                    (1, False, (8, 8)), (2, True, (14, 14))])
def test_bottleneck_equals_jax(stride, has_shortcut, hw):
    """Caffe-style Bottleneck (stride on conv1, odd sizes: the strided 1x1
    pads nothing, the 3x3 pads one on each side), fp32: within rtol 1e-4
    of the JAX package's, weights through from_jax_vision_params."""
    rng = np.random.default_rng(11)
    cin = 16 if has_shortcut else 32
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    jm = jresnet.Bottleneck(32, 8, stride=stride, has_shortcut=has_shortcut)
    params = _perturb_bn(_jax_init(jm, x), rng)
    want = np.asarray(jm.apply(params, x))
    tm = tresnet.Bottleneck(cin, 32, 8, stride=stride, has_shortcut=has_shortcut)
    tm.load_state_dict(from_jax_vision_params(params), strict=True)
    with torch.no_grad():
        got = tm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_res_stage_equals_jax():
    """A 2-block ResStage (first stride 2, projection shortcut), fp32:
    within rtol 1e-4 of JAX's."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 13, 10, 16)).astype(np.float32)
    jm = jresnet.ResStage(2, 32, 8, 2)
    params = _perturb_bn(_jax_init(jm, x), rng)
    want = np.asarray(jm.apply(params, x))
    tm = tresnet.ResStage(2, 16, 32, 8, 2)
    tm.load_state_dict(from_jax_vision_params(params), strict=True)
    with torch.no_grad():
        got = tm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 7, 5, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_stem_equals_jax():
    """conv1 7x7/2 (pad 3) + FrozenBN + ReLU + max-pool 3x3/2 with -inf
    padding, on odd sizes: within rtol 1e-4 of the same flax ops."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((1, 21, 27, 3)) * 50).astype(np.float32)

    class JStem(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Conv(64, (7, 7), strides=(2, 2), padding=3, use_bias=False,
                         name="stem_conv1")(x)
            x = jax.nn.relu(jresnet.FrozenBN(64, name="stem_bn1")(x))
            return fnn.max_pool(x, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))

    params = _perturb_bn(_jax_init(JStem(), x), rng)
    want = np.asarray(JStem().apply(params, x))
    backbone = tresnet.ResNet101C4Backbone()
    sd = {k[len("stem."):]: v for k, v in from_jax_vision_params(params).items()}
    backbone.stem.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = backbone.stem(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 6, 7, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_from_jax_vision_params_names_cover_the_model():
    """Every weight of the port's FasterRCNN has a counterpart in the JAX
    package's parameter tree and no JAX leaf is left over, at the published
    1600 classes (shapes from jax.eval_shape; nothing is computed)."""
    shapes = jax.eval_shape(jfrcnn.FasterRCNN().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((64, 64, 3), jnp.float32), (64.0, 64.0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = from_jax_vision_params(tree)
    with torch.device("meta"):
        model = tfrcnn.FasterRCNN()
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert "backbone.res4.7.conv2.weight" in sd
    assert "roi_heads.res5.0.shortcut.norm.scale" in sd
    assert "proposal_generator.rpn_head.objectness_logits.bias" in sd


# ----------------------------------------------------------- preprocessing

@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (375, 500), (1200, 1600),
                                (500, 1500), (64, 48), (37, 91), (600, 1000)])
def test_resize_shortest_edge_matches_jax(hw):
    """Output size equal to the JAX package's (detectron2's arithmetic);
    values, up- and down-scaled, within 1e-3 on the 0-255 scale of
    cv2.resize INTER_LINEAR, which the JAX package runs."""
    import cv2
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    img = (rng.random((*hw, 3)) * 255).astype(np.uint8)
    want = jfrcnn.resize_shortest_edge(img.astype(np.float32))
    got = tfrcnn.resize_shortest_edge(img)
    assert tuple(got.shape) == (3, *want.shape[:2])
    ref = cv2.resize(img.astype(np.float32), (want.shape[1], want.shape[0]),
                     interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), ref, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, atol=1e-3, rtol=0)


def test_resize_shape_matches_jax_over_many_sizes():
    rng = np.random.default_rng(5)
    sizes = [(480, 640), (600, 600), (150, 3000), (601, 1001), (599, 1000)]
    sizes += [tuple(int(v) for v in rng.integers(100, 2000, 2)) for _ in range(40)]
    for h, w in sizes:
        for lo, hi in ((600, 1000), (64, 64), (300, 500)):
            want = jfrcnn.resize_shortest_edge(np.zeros((h, w, 3), np.float32),
                                               lo, hi).shape[:2]
            assert tfrcnn.resize_shape(h, w, lo, hi) == want, (h, w, lo, hi)


def _shared_outputs(seed, N=40, C=9, n_hot=2, hot_logit=3.0, logit_scale=1.0,
                    invalid_rows=5, ties=False, jitter=None):
    """Detector outputs for one image: probabilities with `n_hot` favoured
    classes, class boxes around a base box per row (random boxes, or one
    box moved by up to `jitter` px, so that the rows overlap heavily)."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((N, C + 1)) * logit_scale).astype(np.float32)
    logits[:, :n_hot] += hot_logit
    if ties:
        logits[N // 2:] = logits[:N // 2]        # every score twice
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    if jitter is None:
        base = random_boxes(rng, N, 120, 160, min_size=6.0)
        noise = 3.0
    else:
        base = np.array([20, 20, 80, 80]) + rng.uniform(-jitter, jitter, (N, 4))
        noise = 1.0
    boxes = (base[:, None, :] + rng.standard_normal((N, C, 4)) * noise).astype(np.float32)
    boxes = np.clip(boxes, 0, 160).astype(np.float32)
    feats = rng.standard_normal((N, 16)).astype(np.float32)
    valid = np.ones(N, bool)
    valid[rng.choice(N, invalid_rows, replace=False)] = False
    return dict(probs=probs, boxes=boxes, features=feats), valid


@pytest.mark.parametrize("case", [
    dict(seed=0),                                  # 36 at the sweep's first threshold
    dict(seed=0, N=100, n_hot=1, jitter=12.0),     # 36 first at 0.8
    dict(seed=0, N=100, n_hot=1, jitter=3.0),      # never 36: the last threshold
    dict(seed=1, N=12),                            # fewer candidates than 36
    dict(seed=3, ties=True),                       # every score twice
    dict(seed=4, C=30, n_hot=0, logit_scale=0.5),  # nothing above SCORE_THRESH
])
def test_select_instances_equals_jax(case):
    """The adaptive class-NMS selection on one shared set of outputs:
    boxes, scores, rows and valid identical to the JAX package's, features
    and cls_prob the same rows; two images in one call."""
    imgs = [_shared_outputs(**case), _shared_outputs(**{**case, "seed": case["seed"] + 50})]
    out = {k: T(np.stack([o[k] for o, _ in imgs])) for k in imgs[0][0]}
    sel = tfrcnn._select_instances(out, T(np.stack([v for _, v in imgs])))
    for b, (o, v) in enumerate(imgs):
        want = jax.device_get(jfrcnn._select_instances(
            {k: jnp.asarray(a) for k, a in o.items()}, jnp.asarray(v)))
        for k in ("boxes", "scores", "rows", "valid", "features", "cls_prob"):
            np.testing.assert_array_equal(sel[k][b].numpy(), np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------------ images

def test_read_image_pnm_equals_cv2(tmp_path, monkeypatch):
    """The numpy PPM/PGM reader gives what cv2.imread gives (BGR uint8,
    grey replicated into three channels), comments in the header
    included; a missing file is None; without cv2 another format raises,
    naming cv2."""
    import builtins

    import cv2
    rng = np.random.default_rng(21)
    rgb = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (5, 4), dtype=np.uint8)
    (tmp_path / "a.ppm").write_bytes(b"P6\n# made by a test\n9 7\n255\n" + rgb.tobytes())
    (tmp_path / "b.pgm").write_bytes(b"P5 4 5 255\n" + grey.tobytes())
    cv2.imwrite(str(tmp_path / "c.png"), rgb)
    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kw)

    want = {n: cv2.imread(str(tmp_path / n)) for n in ("a.ppm", "b.pgm")}
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    for n, w in want.items():
        np.testing.assert_array_equal(tfrcnn.read_image(str(tmp_path / n)), w)
    assert tfrcnn.read_image(str(tmp_path / "missing.ppm")) is None
    with pytest.raises(ValueError, match="cv2"):
        tfrcnn.read_image(str(tmp_path / "c.png"))
    monkeypatch.undo()
    np.testing.assert_array_equal(tfrcnn.read_image(str(tmp_path / "c.png")), rgb)


def test_inference_scope_turns_tf32_off_and_restores():
    """The extractor's cuDNN setting is scoped: TF32 off inside, the
    caller's setting after."""
    before = torch.backends.cudnn.allow_tf32
    with tfrcnn.inference():
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.is_inference_mode_enabled()
    assert torch.backends.cudnn.allow_tf32 == before
    assert math.isclose(tbox.SCALE_CLAMP, float(np.log(1000.0 / 16)))
