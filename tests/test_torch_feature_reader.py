"""The port's ImageFeaturesReader (k3m_tpu_torch.data.feature_reader)
against the JAX package's (k3m_tpu/data/feature_reader.py), on the CPU, on
the same seeded numpy items: from a K3MR file (data.prepare's layout) and
from an HDF5 file of the reference docstring's schema, full and minimal,
bit for bit, and K3MR against HDF5 of the same items; the global token and
the location layout; the in-memory cache; the legacy TSV serializer's
records, which it cannot key, raise KeyError as in the JAX package; a
missing h5py is named."""

import builtins

import numpy as np
import pytest

from k3m_tpu.data.feature_reader import ImageFeaturesReader as JaxReader
from k3m_tpu_torch.data.feature_reader import ImageFeaturesReader
from k3m_tpu_torch.data.records import write_records


def _items(n=5, p=7, f=16, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        boxes = rng.random((p, 4), dtype=np.float32) * 50
        boxes[:, 2:] += boxes[:, :2]
        items.append(dict(item_id=f"item{i}", title="t", pv="", category="c",
                          features=rng.random((p, f), dtype=np.float32), boxes=boxes,
                          num_boxes=[p, p - 1, p - 3, 0, p][i % 5],
                          image_h=int(rng.integers(80, 200)),
                          image_w=int(rng.integers(80, 200))))
    return items


def _write_h5(path, items, minimal=False):
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w") as f:
        f.create_dataset("image_id", data=np.array([it["item_id"] for it in items],
                                                   dtype="S16"))
        f.create_dataset("features", data=np.stack([it["features"] for it in items]))
        if minimal:
            return
        for key in ("boxes", "num_boxes", "image_h", "image_w"):
            f.create_dataset(key, data=np.stack([np.asarray(it[key]) for it in items]))


def _assert_same(got, want):
    assert len(got) == 3 and got[1] == want[1]
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("source", ["k3mr", "h5", "h5_minimal"])
@pytest.mark.parametrize("in_memory", [False, True])
def test_reader_equals_jax(tmp_path, source, in_memory):
    items = _items()
    if source == "k3mr":
        path = str(tmp_path / "feat.k3mr")
        write_records(path, items)
    else:
        path = str(tmp_path / "feat.h5")
        _write_h5(path, items, minimal=source == "h5_minimal")
    mine, theirs = ImageFeaturesReader(path, in_memory), JaxReader(path, in_memory)
    assert len(mine) == len(theirs) == len(items) and mine.keys == theirs.keys
    assert "item2" in mine and "nope" not in mine
    for it in items:
        got = mine[it["item_id"]]
        _assert_same(got, theirs[it["item_id"]])
        if in_memory:
            assert mine[it["item_id"]] is got
    if source == "h5":            # the same items from K3MR, bit for bit
        write_records(str(tmp_path / "same.k3mr"), items)
        from_k3mr = ImageFeaturesReader(str(tmp_path / "same.k3mr"))
        for it in items:
            _assert_same(mine[it["item_id"]], from_k3mr[it["item_id"]])
    if source != "k3mr":
        return
    # the global token: the boxes' mean (zeros without boxes), the whole image
    for it in items:
        feats, n, loc = mine[it["item_id"]]
        nb = it["num_boxes"]
        assert n == nb + 1 and feats.shape == (nb + 1, 16) and loc.shape == (nb + 1, 5)
        want = it["features"][:nb].mean(0) if nb else np.zeros(16, np.float32)
        assert feats[0].tobytes() == want.astype(np.float32).tobytes()
        np.testing.assert_array_equal(loc[0], [0, 0, 1, 1, 1])
        h, w = it["image_h"], it["image_w"]
        b = it["boxes"][:nb]
        np.testing.assert_allclose(loc[1:, :4], b / [w, h, w, h], rtol=1e-6)
        np.testing.assert_allclose(
            loc[1:, 4], (b[:, 3] - b[:, 1]) * (b[:, 2] - b[:, 0]) / (w * h), rtol=1e-6)


def test_legacy_records_have_no_item_id_as_in_jax(tmp_path):
    """The legacy TSV serializer's layout (image_id, caption; no item_id):
    both readers raise KeyError on 'item_id' (ROADMAP.md Queue 3, facts)."""
    path = str(tmp_path / "legacy.k3mr")
    legacy = [{k: v for k, v in it.items() if k not in ("item_id", "title")}
              for it in _items(2)]
    write_records(path, [dict(it, image_id=f"img_{i}", caption="c")
                         for i, it in enumerate(legacy)])
    for reader in (ImageFeaturesReader, JaxReader):
        with pytest.raises(KeyError, match="item_id"):
            reader(path)


def test_missing_h5py_is_named(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="needs h5py"):
        ImageFeaturesReader(str(tmp_path / "feat.h5"))
