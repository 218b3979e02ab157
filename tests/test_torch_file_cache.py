"""The port's copy of the pretrained-file cache
(k3m_tpu_torch/utils/file_cache.py) on the cases of tests/test_file_cache.py
(reference cached_path, vilbert_k3m/utils.py:582-737), offline: local paths
and file:// URLs; a remote URL raises by name."""

import os

import pytest

from k3m_tpu.utils import file_cache as jax_cache
from k3m_tpu_torch.utils.file_cache import (
    cached_path, filename_to_url, read_set_from_file, url_to_filename,
)


def test_local_path_passthrough(tmp_path):
    p = tmp_path / "weights.bin"
    p.write_bytes(b"abc")
    assert cached_path(str(p)) == str(p)


def test_missing_local_path_raises():
    with pytest.raises(EnvironmentError):
        cached_path("/nonexistent/weights.bin")


def test_bad_scheme_raises():
    with pytest.raises(ValueError):
        cached_path("ftp://host/weights.bin")


def test_file_url_cached_once(tmp_path):
    src = tmp_path / "model.bin"
    src.write_bytes(b"payload")
    cache = tmp_path / "cache"
    url = "file://" + str(src)
    c1 = cached_path(url, cache_dir=str(cache))
    assert open(c1, "rb").read() == b"payload"
    u, etag = filename_to_url(os.path.basename(c1), cache_dir=str(cache))
    assert u == url and etag is None
    src.write_bytes(b"changed")
    c2 = cached_path(url, cache_dir=str(cache))
    assert c2 == c1
    assert open(c2, "rb").read() == b"payload"


def test_cache_entry_is_the_jax_packages(tmp_path):
    """The same URL lands under the same file name with the same sidecar in
    either package's cache."""
    src = tmp_path / "model.bin"
    src.write_bytes(b"payload")
    url = "file://" + str(src)
    mine = cached_path(url, cache_dir=str(tmp_path / "port"))
    theirs = jax_cache.cached_path(url, cache_dir=str(tmp_path / "jax"))
    assert os.path.basename(mine) == os.path.basename(theirs)
    assert open(mine + ".json").read() == open(theirs + ".json").read()


def test_url_to_filename_etag_distinguishes():
    a = url_to_filename("http://x/y")
    b = url_to_filename("http://x/y", etag="v2")
    assert a != b and b.startswith(a.split(".")[0])
    assert b == jax_cache.url_to_filename("http://x/y", etag="v2")


@pytest.mark.parametrize("url", ["https://example.invalid/w.bin", "s3://bucket/w.bin"])
def test_remote_urls_raise_by_name(url, tmp_path):
    with pytest.raises(EnvironmentError, match="file:// URLs only"):
        cached_path(url, cache_dir=str(tmp_path))


def test_read_set_from_file(tmp_path):
    f = tmp_path / "names.txt"
    f.write_text("alpha\nbeta\n\nalpha\n")
    assert read_set_from_file(str(f)) == {"alpha", "beta", ""}
