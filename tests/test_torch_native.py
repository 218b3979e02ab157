"""The port's native producer (k3m_tpu_torch/runtime) against the JAX
package's native producer and the port's Python producer, on synthetic
K3MR files written here, on the CPU.

  * pretraining batches at visual_target 0 and 1, and pair batches (with a
    remainder batch), over two shuffled epochs: the port's native batches
    equal the JAX native producer's and the port's Python producer's byte
    for byte, key for key, dtype for dtype;
  * the C++ tokenizer equals the port's Python tokenizer on the edge cases
    of tests/test_native_preprocess.py and on random text;
  * K3M_NATIVE_PREPROCESS=0 and native_preprocess=False select the Python
    producer and say why; a library that does not build is logged with the
    compiler's error and the loader runs the Python producer;
  * NativeRecordReader reads what RecordReader reads and rejects files that
    are not K3MR.
"""

import logging

import numpy as np
import pytest

from k3m_tpu.data.pipeline import AlignmentLoader as JaxAlignmentLoader
from k3m_tpu.data.pipeline import PretrainLoader as JaxPretrainLoader
from k3m_tpu.data.preprocess import ShapeSpec as JaxShapes
from k3m_tpu.tokenization import get_tokenizer as jax_tokenizer
from k3m_tpu_torch import runtime
from k3m_tpu_torch.data import records as trec
from k3m_tpu_torch.data.pipeline import AlignmentLoader, PretrainLoader
from k3m_tpu_torch.data.preprocess import ShapeSpec
from k3m_tpu_torch.tokenization import get_tokenizer
from tests.test_torch_data import SHAPES, _item, _pairs

EDGE_CASES = [
    "", " ", "abc DEF 中文mixed123", "a:b;c:d;", "ＡＢＣ　全角",
    "émigré naïve Ångström", "x" * 200, "\t\n\r mixed   lines",
    "①②③ ★☆ ——【品牌】", "ＬＥＤ灯 ２０２２新款", "\x00�keep",
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    trec.write_records(str(tmp / "feat.k3mr"), [_item(rng, i) for i in range(14)])
    trec.write_records(str(tmp / "pairs.k3mr"), _pairs(11, seed=2))
    return tmp


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(None, 21128)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native producer, its library compiled by the JAX
    package's own `_compile` into this module's directory, so that another
    test process building k3m_tpu/runtime/ at the same time cannot race it.
    Its loaders read records in Python (`use_native=False`); the producer
    reads them in C++ all the same."""
    import k3m_tpu.runtime as jr
    lib = str(tmp_path_factory.mktemp("jax_native") / "libk3mpreprocess.so")
    assert jr._compile(jr._PREP_SRC, lib, ["-ffp-contract=off", "-pthread"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "_PREP_LIB", lib)
        yield dict(tokenizer=jax_tokenizer(None, 21128), shapes=JaxShapes(**SHAPES),
                   use_native=False)


def _epochs(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.epoch = e
        out.append(list(loader))
    return out


def _assert_equal(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert a == b, where
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), (where, np.argwhere(a != b)[:4].tolist())


def _assert_same_batches(runs):
    (_, first), *others = runs.items()
    for name, other in others:
        assert len(other) == len(first)
        for e, (xs, ys) in enumerate(zip(first, other)):
            assert len(xs) == len(ys) > 0
            for i, (x, y) in enumerate(zip(xs, ys)):
                _assert_equal(x, y, f"{name} epoch {e} batch {i}")


@pytest.mark.parametrize("visual_target", [0, 1])
def test_pretrain_batches_equal_jax_native_and_python(files, tok, jax_native, visual_target):
    path = str(files / "feat.k3mr")
    kw = dict(batch_size=4, shuffle=True, seed=3, visual_target=visual_target,
              drop_last=False)
    native = PretrainLoader(path, tok, ShapeSpec(**SHAPES), **kw)
    python = PretrainLoader(path, tok, ShapeSpec(**SHAPES), native_preprocess=False, **kw)
    jax_native = JaxPretrainLoader(path, **jax_native, **kw)
    assert native.producer == "native" and python.producer == "python"
    assert jax_native.native is not None, "the JAX native producer did not build"
    _assert_same_batches({"port native": _epochs(native), "jax native": _epochs(jax_native),
                          "port python": _epochs(python)})


def test_pair_batches_equal_jax_native_and_python(files, tok, jax_native):
    path = str(files / "pairs.k3mr")
    kw = dict(batch_size=4, shuffle=True, seed=1, drop_last=False)
    native = AlignmentLoader(path, tok, ShapeSpec(**SHAPES), **kw)
    python = AlignmentLoader(path, tok, ShapeSpec(**SHAPES), native_preprocess=False, **kw)
    jax_native = JaxAlignmentLoader(path, **jax_native, **kw)
    assert native.producer == "native" and jax_native.native is not None
    runs = {"port native": _epochs(native), "jax native": _epochs(jax_native),
            "port python": _epochs(python)}
    assert [len(b["label"]) for b in runs["port native"][0]] == [4, 4, 3]
    _assert_same_batches(runs)


def test_native_encode_matches_the_tokenizer(files, tok):
    native = PretrainLoader(str(files / "feat.k3mr"), tok, ShapeSpec(**SHAPES)).native
    rng = np.random.default_rng(0)
    chars = [chr(c) for c in [*range(0x250), *range(0x2000, 0x2070), *range(0x3000, 0x3040),
                              *range(0x4E00, 0x4F00), 0xFFFD, 0xFEFF, 0x200B, 0x03A3]]
    texts = EDGE_CASES + ["".join(rng.choice(chars, int(rng.integers(1, 60))))
                          for _ in range(200)]
    for text in texts:
        assert native.encode(text) == tok.encode(text), repr(text)


def test_env_gate_and_flag_select_the_python_producer(files, tok, monkeypatch):
    path = str(files / "feat.k3mr")
    loader = PretrainLoader(path, tok, ShapeSpec(**SHAPES), native_preprocess=False)
    assert (loader.producer, loader.native_error) == ("python", "native_preprocess=False")
    monkeypatch.setenv("K3M_NATIVE_PREPROCESS", "0")
    for cls, p in ((PretrainLoader, path), (AlignmentLoader, str(files / "pairs.k3mr"))):
        loader = cls(p, tok, ShapeSpec(**SHAPES))
        assert (loader.producer, loader.native_error) == ("python", "K3M_NATIVE_PREPROCESS=0")


def test_a_failed_build_is_logged_and_falls_back(files, tok, tmp_path, monkeypatch, caplog):
    """A source that does not compile: the compiler's error is logged and
    kept, and the loader runs (and reports) the Python producer."""
    for name in runtime.SOURCES:
        (tmp_path / name).write_text((runtime.SRC_DIR / name).read_text())
    with open(tmp_path / "preprocess.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(runtime, "SRC_DIR", tmp_path)
    monkeypatch.setattr(runtime, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_error", None)
    with caplog.at_level(logging.WARNING):
        loader = PretrainLoader(str(files / "feat.k3mr"), tok, ShapeSpec(**SHAPES),
                                batch_size=4)
    assert loader.producer == "python"
    assert "native build failed" in loader.native_error and "error" in loader.native_error
    assert "this is not C++" in caplog.text
    assert len(next(iter(loader))["item_id"]) == 4


def test_native_reader_reads_records_and_rejects_garbage(files, tmp_path):
    path = str(files / "feat.k3mr")
    native, python = runtime.NativeRecordReader(path), trec.RecordReader(path)
    assert len(native) == len(python) == 14
    for i in (0, 5, 13):
        a, b = native[i], python[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]
    with pytest.raises(IndexError):
        native[14]
    good = (files / "feat.k3mr").read_bytes()
    rng = np.random.default_rng(0)
    bad = {
        "random bytes": rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
        "truncated": good[: len(good) // 2],
        "no trailer": good[:-4],
        "count past the end": good[:-20] + (2 ** 40).to_bytes(8, "little") + good[-12:],
        "index past the end": good[:-12] + (len(good) * 2).to_bytes(8, "little") + good[-4:],
        "empty": b"",
    }
    for data in bad.values():
        p = tmp_path / "bad.k3mr"
        p.write_bytes(data)
        with pytest.raises(ValueError, match="not a K3MR file"):
            runtime.NativeRecordReader(str(p))
