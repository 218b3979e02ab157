"""The trunk options of the config against the JAX package, in fp32 on the
CPU, on the same numpy inputs and weights (carried by from_jax_params):

  * task_specific_tokens: BertEmbeddings (the task row after [CLS]) and
    K3MTrunk with task_ids (both text streams one longer, the masks'
    prepended ones column); the pretraining model and item alignment fail
    under it in both packages;
  * in_batch_pairs: TriStreamEncoder at b 3 (9 pair rows, their order
    pinned), and K3MForPretraining, which fails in both packages;
  * fast_mode: TriStreamEncoder at equal batches and at a text batch of 1
    against 3 images and pvs.

The JAX modules run eagerly (no jit: each is applied once). Tolerances:
the embeddings 1e-5; the trunk and the encoders 1e-4 relative / 1e-5
absolute (the alignment model's in tests/test_torch_alignment.py: fp32,
a few dozen layers summed in another order).
"""

import jax
import numpy as np
import pytest
import torch

from k3m_tpu.model import encoder as jen
from k3m_tpu.model import layers as jly
from k3m_tpu.model import pretrain as jpt
from k3m_tpu.model.alignment import K3MForItemAlignment as JaxAlignment
from k3m_tpu.train.convert import _flatten
from k3m_tpu_torch import dist
from k3m_tpu_torch.convert import from_jax_params
from k3m_tpu_torch.model import encoder as ten
from k3m_tpu_torch.model import layers as tly
from k3m_tpu_torch.model import pretrain as tpt
from k3m_tpu_torch.model.alignment import K3MForItemAlignment
from tests.conftest import MICRO, NANO, make_nano_batch
from tests.test_torch_modules import bias_pair, normal, redraw, torch_config

TOL = dict(rtol=1e-4, atol=1e-5)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


def port_params(module, params, prefix, torch_prefix=""):
    flat = {f"{prefix}{k}": np.asarray(v) for k, v in _flatten(params).items()}
    sd = {k[len(torch_prefix):]: v for k, v in from_jax_params(flat).items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


# ------------------------------------------------------------ task tokens

@pytest.mark.parametrize("ids_shape", ["[B, 1]", "[B]"])
def test_task_embeddings_match_jax(ids_shape):
    """The task row of a 20-row table after [CLS], before the LayerNorm,
    without position or type embedding: L + 1 rows, within 1e-5."""
    cfg = MICRO.replace(task_specific_tokens=True)
    rng = np.random.default_rng(0)
    B, L = 3, 9
    ids = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    seg = rng.integers(0, 2, (B, L)).astype(np.int32)
    task = np.array([[2], [0], [19]], np.int32)
    if ids_shape == "[B]":
        task = task[:, 0]
    table = normal(rng, cfg.vocab_size, cfg.hidden_size)
    jm = jly.BertEmbeddings(cfg)
    p = redraw(jm.init(jax.random.PRNGKey(0), ids, seg, table, deterministic=True,
                       task_ids=task)["params"], 1)
    assert p["task_embeddings"].shape == (20, cfg.hidden_size)
    ref = jm.apply({"params": p}, ids, seg, table, deterministic=True, task_ids=task)
    tm = tly.BertEmbeddings(torch_config(cfg))
    flat = {f"trunk/embeddings/{k}": np.asarray(v) for k, v in _flatten(p).items()}
    flat["trunk/word_embeddings"] = table
    tm.load_state_dict({k[len("embeddings."):]: v for k, v in from_jax_params(flat).items()},
                       strict=True)
    got = tm(torch.from_numpy(ids).long(), torch.from_numpy(seg).long(),
             task_ids=torch.from_numpy(task).long())
    assert got.shape == (B, L + 1, cfg.hidden_size)
    close(got, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="task_ids"):
        tm(torch.from_numpy(ids).long(), torch.from_numpy(seg).long())


def _trunk_args(b):
    return (b["input_ids"], b["image_feat"], b["image_loc"], b["segment_ids"],
            b["input_mask"], b["image_mask"], b["input_ids_pv"], b["segment_ids_pv"],
            b["input_mask_pv"])


def _torch_args(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) if a.dtype.kind == "f"
            else torch.from_numpy(np.ascontiguousarray(a)).long() for a in args]


@pytest.fixture(scope="module")
def task_trunk():
    """NANO with task tokens (soft fusion: no Gumbel draw), ragged masks:
    the JAX trunk's outputs and the port's."""
    cfg = NANO.replace(task_specific_tokens=True, if_pre_sampling=2)
    b = make_nano_batch(B=3, seed=4)
    rng = np.random.default_rng(5)
    for key, n in (("input_mask", 8), ("input_mask_pv", 12), ("image_mask", 5)):
        for r in (1, 2):
            b[key][r, n - rng.integers(1, n // 2):] = 0
    args = _trunk_args(b)
    task = np.array([4, 0, 11], np.int32)
    jm = jpt.K3MTrunk(cfg)
    p = redraw(jm.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                       *args, deterministic=True, task_ids=task)["params"], 6)
    want = jm.apply({"params": p}, *args, deterministic=True, task_ids=task)
    tm = port_params(tpt.K3MTrunk(torch_config(cfg)), p, "trunk/")
    with torch.no_grad():
        got = tm(*_torch_args(args), deterministic=True,
                 task_ids=torch.from_numpy(task).long())
    return dict(cfg=cfg, b=b, args=args, jm=jm, p=p, want=want, tm=tm, got=got)


def test_trunk_with_task_ids_matches_jax(task_trunk):
    """K3MTrunk with task_ids: both text streams L + 1 and Lpv + 1 long, and
    every output of the JAX trunk within the trunk tolerance."""
    got, want, b = task_trunk["got"], task_trunk["want"], task_trunk["b"]
    L, Lpv = b["input_ids"].shape[1], b["input_ids_pv"].shape[1]
    assert got["seq_t"].shape[1] == L + 1 and got["seq_pv"].shape[1] == Lpv + 1
    for key in ("seq_v", "seq_t", "seq_pv", "pooled_v", "pooled_t", "pooled_pv",
                "c_initial"):
        close(got[key], want[key])


def test_trunk_masks_gain_a_prepended_column(task_trunk):
    """The masks gain a ones column before position 0 (not at 1), as the
    reference extends them: a text row whose last real token is at L - 1
    then keeps a bias of -10000 on the task-shifted last position. Held by
    zeroing the mask's last real column: the trunk moves in both packages,
    alike."""
    cfg, args, jm, p, tm = (task_trunk[k] for k in ("cfg", "args", "jm", "p", "tm"))
    mask = np.array(args[4])
    mask[0, -1] = 0
    args = args[:4] + (mask,) + args[5:]
    task = np.array([4, 0, 11], np.int32)
    want = jm.apply({"params": p}, *args, deterministic=True, task_ids=task)
    with torch.no_grad():
        got = tm(*_torch_args(args), deterministic=True, task_ids=torch.from_numpy(task).long())
    close(got["seq_t"], want["seq_t"])
    assert not np.allclose(np.asarray(want["seq_t"]), task_trunk["want"]["seq_t"], atol=1e-4)


def test_trunk_refuses_missing_task_ids(task_trunk):
    with pytest.raises(ValueError, match="task_ids"):
        task_trunk["jm"].apply({"params": task_trunk["p"]}, *task_trunk["args"],
                               deterministic=True)
    with pytest.raises(ValueError, match="task_ids"):
        task_trunk["tm"](*_torch_args(task_trunk["args"]), deterministic=True)


def test_pretraining_and_alignment_fail_under_task_tokens():
    """K3MForPretraining refuses the flag with ValueError in both packages;
    item alignment threads no task_ids, so it fails on the missing ids in
    both."""
    cfg = NANO.replace(task_specific_tokens=True)
    b = make_nano_batch(B=2)
    rngs = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1),
            "lpm": jax.random.PRNGKey(2)}
    with pytest.raises(ValueError, match="task_specific_tokens"):
        jpt.K3MForPretraining(cfg).init(rngs, b, deterministic=True)
    with pytest.raises(ValueError, match="task_specific_tokens"):
        tpt.K3MForPretraining(torch_config(cfg))
    from tests.test_torch_alignment import pair_batch
    pairs = pair_batch(cfg, B=2)
    with pytest.raises(ValueError, match="task_ids"):
        JaxAlignment(cfg).init(rngs, pairs["label"], pairs["item1"], pairs["item2"],
                               deterministic=True)
    from k3m_tpu_torch.train.alignment_loop import batch_to_device
    tb = batch_to_device(pairs, "cpu")
    with pytest.raises(ValueError, match="task_ids"):
        K3MForItemAlignment(torch_config(cfg))(tb["label"], tb["item1"], tb["item2"])


# ------------------------------------------------ in_batch_pairs, fast_mode

def _encoder_inputs(cfg, Bt, Bi, seed):
    """(JAX inputs, port inputs) of TriStreamEncoder: text batch Bt, image
    and pv batch Bi, ragged masks."""
    rng = np.random.default_rng(seed)
    L, R, Lpv = 7, 5, 9
    txt, img, pv = (normal(rng, Bt, L, cfg.hidden_size), normal(rng, Bi, R, cfg.v_hidden_size),
                    normal(rng, Bi, Lpv, cfg.hidden_size))
    tmask, jtb, ttb = bias_pair(rng, Bt, L)
    _, jib, tib = bias_pair(rng, Bi, R)
    pmask, jpb, tpb = bias_pair(rng, Bi, Lpv)
    jx = (txt, img, jtb, tmask[:, :, None], jib, pv, jpb, pmask[:, :, None])
    tx = (torch.from_numpy(txt), torch.from_numpy(img), ttb,
          torch.from_numpy(tmask[:, :, None]), tib, torch.from_numpy(pv), tpb,
          torch.from_numpy(pmask[:, :, None]))
    return jx, tx


def _encoders(cfg, jx, seed=8):
    jm = jen.TriStreamEncoder(cfg)
    p = redraw(jm.init(jax.random.PRNGKey(0), *jx, deterministic=True)["params"], seed)
    tm = port_params(ten.TriStreamEncoder(torch_config(cfg)), p, "trunk/encoder/",
                     "encoder.")
    return jm, p, tm


@pytest.fixture(scope="module")
def pairs_case():
    """MICRO (one text layer before the first co-attention) with
    in_batch_pairs at b 3: the JAX encoder's six outputs and the port's."""
    cfg = MICRO.replace(in_batch_pairs=True)
    jx, tx = _encoder_inputs(cfg, 3, 3, seed=9)
    jm, p, tm = _encoders(cfg, jx)
    with torch.no_grad():
        got = tm(*tx)
    return dict(cfg=cfg, jx=jx, tx=tx, p=p, tm=tm, got=got,
                want=jm.apply({"params": p}, *jx, deterministic=True))


def test_in_batch_pairs_encoder_matches_jax(pairs_case):
    """b 3 gives 9 rows on every output, each within the trunk tolerance of
    the JAX encoder's."""
    for g, w in zip(pairs_case["got"], pairs_case["want"]):
        assert g.shape[0] == 9
        close(g, w)


def test_in_batch_pairs_row_order(pairs_case):
    """Row i * 3 + j pairs the text side's row i with the other stream's
    row j in each pass: t<->v and pv<->v (outputs 0-3) equal the plain
    encoder fed text and pv rows repeated per item and image rows tiled,
    t<->pv (outputs 4-5) the plain encoder fed text rows repeated and pv
    rows tiled (the first text layer runs per row, before the pairing)."""
    cfg, tx, tm, p = (pairs_case[k] for k in ("cfg", "tx", "tm", "p"))
    plain = port_params(ten.TriStreamEncoder(torch_config(cfg.replace(in_batch_pairs=False))),
                        p, "trunk/encoder/", "encoder.")
    rep = lambda t: t.repeat_interleave(3, dim=0)
    tile = lambda t: t.repeat((3,) + (1,) * (t.dim() - 1))
    txt, img, tb, tm2, ib, pv, pb, pm2 = tx
    got = pairs_case["got"]
    with torch.no_grad():
        with_img = plain(rep(txt), tile(img), rep(tb), rep(tm2), tile(ib), rep(pv), rep(pb),
                         rep(pm2))
        two_text = plain(rep(txt), tile(img), rep(tb), rep(tm2), tile(ib), tile(pv), tile(pb),
                         tile(pm2))
        swapped = plain(tile(txt), rep(img), tile(tb), tile(tm2), rep(ib), tile(pv), tile(pb),
                        tile(pm2))
    for g, w in zip(got[:4] + got[4:], with_img[:4] + two_text[4:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    # the other order (the text side tiled, the other stream repeated) is not it
    for i in (0, 2, 4):
        assert not torch.allclose(got[i], swapped[i], atol=1e-3), i


def test_in_batch_pairs_fails_at_the_model_level():
    """K3MForPretraining under in_batch_pairs: the JAX fusion block fails on
    the b x b encoder rows against the b embedding rows (TypeError from its
    concatenate), and the port fails there with an error naming the flag."""
    cfg = NANO.replace(in_batch_pairs=True, if_pre_sampling=2)
    b = make_nano_batch(B=2)
    rngs = {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1),
            "lpm": jax.random.PRNGKey(2)}
    with pytest.raises(TypeError, match="concatenate"):
        jpt.K3MForPretraining(cfg).init(rngs, b, deterministic=True)
    from tests.test_torch_pretrain_model import _to_torch
    with pytest.raises(ValueError, match="in_batch_pairs"):
        tpt.K3MForPretraining(torch_config(cfg))(_to_torch(b), deterministic=True)


def test_pair_rows_window():
    """Under data parallelism the pair rows pass the dim-0 contract by name:
    a rank of 3 text rows in 2 data groups holds pair rows 18 .. 35 of the
    36 global pairs (row i * 6 + j), and the batch rows no longer pass."""
    world = dist.World(rank=1, size=2)
    with dist.use(world, 3):
        assert dist.window(3) == (3, 6)
        with dist.pair_rows(18):
            assert dist.window(18) == (18, 36)
            with pytest.raises(ValueError, match="not this rank's batch"):
                dist.window(3)
        assert dist.window(3) == (3, 6)
    with dist.pair_rows(9):              # no world: the batch is the global one
        assert dist.window(9) == (0, 9)


@pytest.mark.parametrize("text_batch", [3, 1], ids=["equal", "text1"])
def test_fast_mode_encoder_matches_jax(text_batch):
    """fast_mode: the text stream broadcast to the image and pv batch after
    the first segment; at equal batches and at a text batch of 1 against 3,
    every output within the trunk tolerance of the JAX encoder's, and equal
    to the plain encoder fed the text rows repeated; the broadcast bias
    keeps its batch stride 0."""
    cfg = MICRO.replace(fast_mode=True)
    jx, tx = _encoder_inputs(cfg, text_batch, 3, seed=10 + text_batch)
    jm, p, tm = _encoders(cfg, jx, seed=11)
    want = jm.apply({"params": p}, *jx, deterministic=True)
    with torch.no_grad():
        got = tm(*tx)
    for g, w in zip(got, want):
        assert g.shape[0] == 3
        close(g, w)
    plain = port_params(ten.TriStreamEncoder(torch_config(MICRO)), p, "trunk/encoder/",
                        "encoder.")
    ex = lambda t: t.expand((3,) + tuple(t.shape[1:])).contiguous()
    txt, img, tb, tm2, ib, pv, pb, pm2 = tx
    with torch.no_grad():
        rep = plain(ex(txt), img, ex(tb), ex(tm2), ib, pv, pb, pm2)
    for g, w in zip(got, rep):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    x, bias = ten.broadcast_text(txt[:1], tb[:1], 3)
    assert x.is_contiguous() and bias.stride(0) == 0 and bias.shape == (3, tb.shape[1])


def test_fast_mode_backward_sums_the_broadcast():
    """The text embeddings' gradient under fast_mode at a text batch of 1
    is the sum over the image rows it was broadcast to: equal to the
    gradient of the plain encoder fed the text row repeated, summed."""
    cfg = MICRO.replace(fast_mode=True)
    jx, tx = _encoder_inputs(cfg, 1, 3, seed=12)
    _, p, tm = _encoders(cfg, jx, seed=13)
    plain = port_params(ten.TriStreamEncoder(torch_config(MICRO)), p, "trunk/encoder/",
                        "encoder.")
    txt = tx[0].clone().requires_grad_(True)
    sum(o.sum() for o in tm(txt, *tx[1:])).backward()
    rep = tx[0].repeat(3, 1, 1).requires_grad_(True)
    ex = lambda t: t.expand((3,) + tuple(t.shape[1:])).contiguous()
    sum(o.sum() for o in plain(rep, tx[1], ex(tx[2]), ex(tx[3]), *tx[4:])).backward()
    torch.testing.assert_close(txt.grad[0], rep.grad.sum(0), rtol=1e-5, atol=1e-5)


def test_trainer_refuses_micro_steps_with_in_batch_pairs():
    """The in-batch pairs depend on the whole batch, so both trainers refuse
    them with in-step microbatches (k3m_tpu/train/pretrain_loop.py:124-131)."""
    from k3m_tpu.train.pretrain_loop import PretrainTrainer as JaxTrainer
    from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
    cfg = NANO.replace(in_batch_pairs=True)
    with pytest.raises(ValueError, match="in_batch_pairs"):
        JaxTrainer(cfg, micro_steps=2)
    with pytest.raises(ValueError, match="in_batch_pairs"):
        PretrainTrainer(torch_config(cfg), device="cpu", micro_steps=2)
