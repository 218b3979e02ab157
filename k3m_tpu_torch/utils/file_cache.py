"""Pretrained-file resolution and its cache.

The port's copy of k3m_tpu/utils/file_cache.py (reference `cached_path` /
`get_from_cache`, vilbert_k3m/utils.py:582-737): a local path resolves to
itself; a `file://` URL is copied once into a cache keyed by the URL (and
its etag, which a local file has none of), with a `.json` sidecar that
records both; `read_set_from_file` and the filename helpers
(:547-579, :740-753) as the reference has them. The port resolves no
remote URL: an http(s) or s3 URL raises EnvironmentError, by name, where
the JAX package would fetch it.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
from hashlib import sha256
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

K3M_CACHE = os.getenv(
    "K3M_PRETRAINED_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "k3m_pretrained"))


def url_to_filename(url: str, etag: str | None = None) -> str:
    """Deterministic cache filename: sha256(url)[.sha256(etag)]
    (ref url_to_filename, vilbert_k3m/utils.py:547-562)."""
    name = sha256(url.encode("utf-8")).hexdigest()
    if etag:
        name += "." + sha256(etag.encode("utf-8")).hexdigest()
    return name


def filename_to_url(filename: str, cache_dir: str | None = None):
    """(url, etag) of a cache entry, from its .json sidecar (ref :565-579)."""
    cache_dir = cache_dir or K3M_CACHE
    meta_path = os.path.join(cache_dir, filename) + ".json"
    if not os.path.exists(meta_path):
        raise EnvironmentError(f"file {meta_path} not found")
    with open(meta_path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    return meta["url"], meta.get("etag")


def get_from_cache(url: str, cache_dir: str | None = None) -> str:
    """The cached copy of a `file://` URL, made on first use (ref
    get_from_cache, vilbert_k3m/utils.py:675-737); any other scheme
    raises EnvironmentError."""
    cache_dir = cache_dir or K3M_CACHE
    parsed = urlparse(url)
    if parsed.scheme != "file":
        raise EnvironmentError(
            f"{url}: the port resolves pretrained files from local paths and file:// "
            "URLs only (no download); fetch it first and pass its path")
    src = parsed.path
    if not os.path.exists(src):
        raise EnvironmentError(f"file {src} not found")
    os.makedirs(cache_dir, exist_ok=True)
    cache_path = os.path.join(cache_dir, url_to_filename(url))
    if os.path.exists(cache_path):
        return cache_path
    with tempfile.NamedTemporaryFile(dir=cache_dir, delete=False) as tmp:
        with open(src, "rb") as f:
            shutil.copyfileobj(f, tmp)
        tmp_name = tmp.name
    os.replace(tmp_name, cache_path)
    with open(cache_path + ".json", "w", encoding="utf-8") as f:
        json.dump({"url": url, "etag": None}, f)
    logger.info("cached %s -> %s", url, cache_path)
    return cache_path


def cached_path(url_or_filename, cache_dir: str | None = None) -> str:
    """URL-or-path resolution (ref cached_path, vilbert_k3m/utils.py:582-611):
    an existing local path as it is; an http(s), s3 or file URL through
    the cache (get_from_cache); a missing local path EnvironmentError;
    anything else ValueError."""
    url_or_filename = str(url_or_filename)
    parsed = urlparse(url_or_filename)
    if parsed.scheme in ("http", "https", "s3", "file"):
        return get_from_cache(url_or_filename, cache_dir)
    if os.path.exists(url_or_filename):
        return url_or_filename
    if parsed.scheme == "":
        raise EnvironmentError(f"file {url_or_filename} not found")
    raise ValueError(f"unable to parse {url_or_filename} as a URL or as a local path")


def read_set_from_file(filename: str) -> set:
    """One item per line, as a set (ref :740-747)."""
    collection = set()
    with open(filename, "r", encoding="utf-8") as f:
        for line in f:
            collection.add(line.rstrip("\n"))
    return collection
