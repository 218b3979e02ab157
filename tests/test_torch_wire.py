"""The port's host->card wire and device cache against the JAX package's, on
the CPU at NANO shapes.

  * K3M_WIRE picks the wire where none is given, in the trainers and both
    CLIs; K3M_EXACT_TARGETS=1 keeps the soft labels fp32 under `fp` (and
    unquantized under `int8`), as k3m_tpu/train/pretrain_loop.py:339-341;
  * the int8 codec: the encoded arrays equal the JAX encode_pretrain's
    exactly, the decode equals JAX's, and the round trips keep within the
    JAX bounds (tests/test_wire.py:16-45);
  * one pretraining step with `int8` matches `exact` at rtol 2e-2 on the
    loss, and the alignment eval probabilities at atol 5e-3, as
    tests/test_wire.py:53-110 holds the JAX package;
  * DeviceEpochCache: the cached replay equals the streamed epoch it
    staged, later epochs never touch the loader, an epoch over the budget
    falls back to streaming (logged), a partial epoch keeps nothing, as
    tests/test_device_cache.py holds the JAX one; both trainers and both
    CLIs replay from it.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k3m_tpu.train import wire as jwire
from k3m_tpu.train.device_cache import DeviceEpochCache as JaxDeviceEpochCache
from k3m_tpu_torch.train import wire
from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer, batch_to_device, forward
from k3m_tpu_torch.train.device_cache import DeviceEpochCache
from k3m_tpu_torch.train.pretrain_loop import PretrainTrainer
from tests.conftest import NANO, make_nano_batch
from tests.test_torch_finetune import pair_batch
from tests.test_torch_modules import torch_config

CFG = torch_config(NANO)


def _soft_label_batch(B=4, seed=0):
    """A NANO pretraining batch whose image_target rows are probability rows
    (the visual_target 0 soft labels the uint8 form quantizes)."""
    batch = make_nano_batch(B=B, seed=seed)
    t = batch["image_target"]
    batch["image_target"] = t / t.sum(-1, keepdims=True)
    return batch


# --------------------------------------------------------------- knobs

@pytest.mark.parametrize("env", [None, "fp", "int8", "exact"])
def test_k3m_wire_picks_the_wire_where_none_is_given(monkeypatch, env):
    if env is not None:
        monkeypatch.setenv("K3M_WIRE", env)
    else:
        monkeypatch.delenv("K3M_WIRE", raising=False)
    want = jwire.wire_mode(None)
    assert want == (env or "fp")
    assert wire.wire_mode(None) == want
    assert PretrainTrainer(CFG, device="cpu").wire == want
    assert AlignmentTrainer(CFG, device="cpu").wire == want
    assert PretrainTrainer(CFG, device="cpu", wire="exact").wire == "exact"
    from k3m_tpu_torch import finetune, pretrain
    for cli in (pretrain, finetune):
        args = cli.get_parser().parse_args(["--data_dir", "d", "--output_dir", "o"]
                                           + (["--file_name", "f"] if cli is pretrain else []))
        assert args.wire is None


def test_k3m_wire_rejects_an_unknown_mode(monkeypatch):
    monkeypatch.setenv("K3M_WIRE", "float8")
    with pytest.raises(ValueError):
        jwire.wire_mode(None)
    with pytest.raises(ValueError, match="float8"):
        PretrainTrainer(CFG, device="cpu")


def test_k3m_exact_targets_keeps_the_soft_labels_fp32(monkeypatch):
    """Under bf16 the fp wire ships the soft labels in fp16 unless
    K3M_EXACT_TARGETS is set; under int8 they are quantized unless it is
    set, image_feat either way."""
    batch = _soft_label_batch()
    cfg = CFG.replace(dtype="bfloat16")
    monkeypatch.delenv("K3M_EXACT_TARGETS", raising=False)
    fp = PretrainTrainer(cfg, device="cpu", wire="fp").stage(batch)
    q = PretrainTrainer(cfg, device="cpu", wire="int8").stage(batch)
    assert fp["image_target"].dtype == torch.float16 and fp["image_feat"].dtype == torch.bfloat16
    assert wire.TGT_Q in q and "image_target" not in q
    monkeypatch.setenv("K3M_EXACT_TARGETS", "1")
    fp = PretrainTrainer(cfg, device="cpu", wire="fp").stage(batch)
    q = PretrainTrainer(cfg, device="cpu", wire="int8").stage(batch)
    assert fp["image_target"].dtype == torch.float32 and fp["image_feat"].dtype == torch.bfloat16
    assert torch.equal(fp["image_target"], torch.from_numpy(batch["image_target"]))
    assert wire.TGT_Q not in q and q["image_target"].dtype == torch.float32
    assert wire.FEAT_Q in q and q[wire.FEAT_Q].dtype == torch.int8


# --------------------------------------------------------------- codec

def test_encoded_arrays_equal_jax_and_decode_matches():
    batch = _soft_label_batch(B=5, seed=3)
    batch["image_feat"][1, 2] = 0.0                  # a zero row
    for quantize in (True, False):
        got = wire.encode_pretrain(batch, quantize_target=quantize)
        want = jwire.encode_pretrain(batch, quantize_target=quantize)
        assert got.keys() == want.keys()
        for k in want:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    enc = wire.encode_pretrain(batch, quantize_target=True)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = wire.decode({k: torch.from_numpy(np.asarray(v)) for k, v in enc.items()}, dtype)
        want = jwire.decode({k: jnp.asarray(v) for k, v in enc.items()}, jdtype)
        assert got["image_feat"].dtype == dtype
        np.testing.assert_array_equal(got["image_feat"].float().numpy(),
                                      np.asarray(want["image_feat"], np.float32))
        np.testing.assert_allclose(got["image_target"].numpy(), np.asarray(want["image_target"]),
                                   rtol=1e-6, atol=1e-9)


def test_round_trips_keep_within_the_jax_bounds():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 7, 64)).astype(np.float32) * 13.0
    q, s = wire.encode_feat(x)
    assert q.dtype == np.int8 and s.shape == (4, 7)
    xhat = q.astype(np.float32) * s[..., None]
    assert np.all(np.abs(xhat - x) <= s[..., None] * 0.5 + 1e-7)
    raw = rng.random((5, 6, 33)).astype(np.float32)
    p = raw / raw.sum(-1, keepdims=True)
    q, s = wire.encode_probs(p)
    assert q.dtype == np.uint8
    phat = wire.decode({wire.TGT_Q: torch.from_numpy(q), wire.TGT_S: torch.from_numpy(s)},
                       torch.float32)["image_target"].numpy()
    np.testing.assert_allclose(phat.sum(-1), 1.0, atol=1e-6)
    assert np.abs(phat - p).max() <= s.max()
    for enc in (wire.encode_feat, wire.encode_probs):
        q, s = enc(np.zeros((2, 3, 8), np.float32))
        assert np.all(q == 0) and np.all(s > 0)


def test_pretrain_step_int8_wire_matches_exact():
    """Same seed, batch and draws; the staged int8 forms are under 0.45 of
    the two tensors' fp32 bytes."""
    batch = _soft_label_batch()
    losses = {}
    for mode in ("exact", "int8"):
        trainer = PretrainTrainer(CFG, device="cpu", learning_rate=1e-4, warmup_steps=2,
                                  total_steps=10, seed=7, wire=mode)
        losses[mode] = float(trainer.train_step(batch)["loss"])
        staged = trainer.stage(batch)
        if mode == "int8":
            assert "image_feat" not in staged and wire.TGT_Q in staged
            fp = batch["image_feat"].nbytes + batch["image_target"].nbytes
            q = wire.wire_bytes({k: staged[k] for k in (wire.FEAT_Q, wire.FEAT_S,
                                                        wire.TGT_Q, wire.TGT_S)})
            assert q < 0.45 * fp, (q, fp)
    assert np.isfinite(losses["int8"])
    np.testing.assert_allclose(losses["int8"], losses["exact"], rtol=2e-2)


def test_alignment_eval_int8_wire_matches_exact():
    """Each item decoded on its own; the probabilities within 5e-3."""
    cfg = torch_config(NANO.replace(loss_type="ce"))
    batch = pair_batch(NANO, B=4, seed=1)
    trainer = AlignmentTrainer(cfg, device="cpu", seed=7)
    probs = {}
    for mode in ("exact", "int8"):
        staged = batch_to_device(batch, "cpu", cfg, mode)
        assert (wire.FEAT_Q in staged["item1"]) == (mode == "int8")
        _, _, p, loss = forward(trainer.model, staged)
        probs[mode] = p.numpy()
        assert np.isfinite(float(loss))
    np.testing.assert_allclose(probs["int8"], probs["exact"], atol=5e-3)
    trainer.wire = "int8"
    loss, _ = trainer.train_step(batch)
    assert np.isfinite(float(loss))


# -------------------------------------------------------- device cache

class CountingLoader:
    def __init__(self, batches):
        self.batches = batches
        self.iters = 0
        self.epoch = 0

    def __iter__(self):
        self.iters += 1
        return iter(self.batches)


def _batches(n=6):
    return [{"input_ids": np.full((2, 3), i, np.int32)} for i in range(n)]


def test_cache_builds_then_replays_permuted():
    staged = []

    def stage(b):
        staged.append(b)
        return dict(b, staged=np.ones(1))

    src = CountingLoader(_batches())
    cache = DeviceEpochCache(src, stage, max_bytes=10 ** 9, seed=3)
    first = list(cache)
    assert len(first) == len(staged) == 6 and cache.cached and cache.bytes > 0
    key = lambda b: int(b["input_ids"][0, 0])
    cache.epoch = 1
    second = list(cache)
    assert len(staged) == 6 and src.iters == 1
    assert sorted(map(key, second)) == sorted(map(key, first))
    cache.epoch = 2
    third = list(cache)
    cache.epoch = 1
    assert list(map(key, cache)) == list(map(key, second))
    assert list(map(key, second)) != list(map(key, third))
    # the replay order is the JAX cache's
    theirs = JaxDeviceEpochCache(CountingLoader(_batches()), stage, max_bytes=10 ** 9, seed=3)
    list(theirs)
    for epoch, mine in ((1, second), (2, third)):
        theirs.epoch = epoch
        assert list(map(key, theirs)) == list(map(key, mine))


def test_cache_over_budget_streams_every_epoch(caplog):
    calls = []
    src = CountingLoader(_batches())
    cache = DeviceEpochCache(src, lambda b: calls.append(1) or b, max_bytes=10)
    with caplog.at_level(logging.WARNING):
        assert len(list(cache)) == 6
    assert "falling back to streaming" in caplog.text
    assert not cache.cached
    assert len(list(cache)) == 6
    assert len(calls) == 12 and src.iters == 2


def test_partial_epoch_does_not_cache():
    src = CountingLoader(_batches())
    cache = DeviceEpochCache(src, lambda b: b, max_bytes=10 ** 9)
    it = iter(cache)
    next(it)
    it.close()
    assert not cache.cached
    assert len(list(cache)) == 6


def test_budget_from_k3m_device_cache_mb(monkeypatch):
    monkeypatch.setenv("K3M_DEVICE_CACHE_MB", "1.5")
    cache = DeviceEpochCache(CountingLoader(_batches()), lambda b: b)
    list(cache)
    assert cache.max_bytes == 1_500_000 and cache.cached
    monkeypatch.setenv("K3M_DEVICE_CACHE", "1")
    assert PretrainTrainer(CFG, device="cpu").device_cache
    assert not PretrainTrainer(CFG, device="cpu", device_cache=False).device_cache


@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_pretrain_fit_replays_the_staged_epoch(mode):
    """Three epochs: the first stages and keeps the loader's batches (in the
    wire's form), the others replay them; each replayed batch is, bit for
    bit, one the streamed first epoch staged."""
    batches = [_soft_label_batch(seed=s) for s in range(3)]
    loader = CountingLoader(batches)
    trainer = PretrainTrainer(CFG, device="cpu", seed=3, wire=mode, device_cache=True)
    hist = trainer.fit(loader, num_epochs=3, log_steps=100)
    assert loader.iters == 1
    assert [h["device_cache"]["from_cache"] for h in hist] == [False, True, True]
    assert all(np.isfinite(m["loss"]) for h in hist for m in h["step_losses"])
    streamed = [trainer.stage(b) for b in batches]
    cached = trainer.epoch_cache._cache
    assert len(cached) == 3
    for a, b in zip(cached, streamed):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a if not isinstance(a[k], dict))


def test_clis_train_with_int8_and_the_device_cache(tmp_path):
    """Two epochs each: the second replayed from the cache; losses finite."""
    from k3m_tpu_torch import finetune, pretrain
    from tests.test_torch_data import _pairs
    from tests.test_torch_finetune_loop import _train_args
    from tests.test_torch_trainer import _cli_args, _records
    from k3m_tpu_torch.data import records as trec
    _records(tmp_path / "train_feat.k3mr", 8)
    run = pretrain.main(_cli_args(tmp_path, "--num_train_epochs", "2", "--wire", "int8",
                                  "--device_cache"))
    assert run["trainer"].wire == "int8"
    assert [h["device_cache"]["from_cache"] for h in run["history"]] == [False, True]
    for name, n, seed in (("train", 8, 3), ("valid", 4, 4)):
        trec.write_records(str(tmp_path / f"{name}_item_alignment.k3mr"), _pairs(n, seed))
    run = finetune.main(_train_args(tmp_path, tmp_path / "nano.json", tmp_path / "ft",
                                    "--num_train_epochs", "2", "--wire", "int8",
                                    "--device_cache"))
    assert [h["device_cache"]["from_cache"] for h in run["history"]] == [False, True]
    assert all(np.isfinite(x) for h in run["history"] for x in h["step_losses"])
