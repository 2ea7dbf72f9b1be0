# coding=utf-8
"""URL/S3 file cache and archive resolution (port of the JAX package's
`utils/file_cache.py`; reference: modules/file.py:29-238 and
modules/base.py:34-91).

`cached_path` / `get_from_cache` name cache entries as the reference does
(the SHA-256 of the URL, then '.' and the SHA-256 of the ETag) and write the
same `.json` sidecar of {url, etag} beside each, so one cache directory
serves the reference, the JAX package and this port.  The default directory
is the JAX package's (`$CENTERCLIP_CACHE`, else
`~/.cache/centerclip_tpu`).  HTTP goes through `urllib`; `s3://` needs
`boto3`, imported only when such a path is given.  A download is written to
a temporary file in the cache directory and published with `os.replace`,
so an interrupted fetch never leaves a truncated entry.
"""
from __future__ import annotations

import json
import os
import shutil
import tarfile
import tempfile
import urllib.request
from hashlib import sha256
from pathlib import Path
from typing import Optional, Set, Tuple, Union
from urllib.parse import urlparse

PathLike = Union[str, Path]

CACHE_DIR = os.environ.get(
    "CENTERCLIP_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "centerclip_tpu"))


def url_to_filename(url: str, etag: Optional[str] = None) -> str:
    """The cache entry's name: sha256(url), then '.' + sha256(etag) when
    there is an ETag, so a changed remote object gets a new entry
    (file.py:29-44)."""
    name = sha256(url.encode("utf-8")).hexdigest()
    if etag:
        name += "." + sha256(etag.encode("utf-8")).hexdigest()
    return name


def filename_to_url(filename: str, cache_dir: Optional[PathLike] = None
                    ) -> Tuple[str, Optional[str]]:
    """(url, etag) of a cache entry, from its `.json` sidecar
    (file.py:47-70)."""
    cache_path = os.path.join(str(cache_dir or CACHE_DIR), filename)
    for path in (cache_path, cache_path + ".json"):
        if not os.path.exists(path):
            raise FileNotFoundError(f"file {path} not found")
    with open(cache_path + ".json") as f:
        meta = json.load(f)
    return meta["url"], meta["etag"]


def cached_path(url_or_filename: PathLike,
                cache_dir: Optional[PathLike] = None) -> str:
    """A URL (downloaded once into the cache) or an existing local path, as
    a readable local path (file.py:73-100)."""
    url_or_filename = str(url_or_filename)
    scheme = urlparse(url_or_filename).scheme
    if scheme in ("http", "https", "s3"):
        return get_from_cache(url_or_filename, cache_dir)
    if os.path.exists(url_or_filename):
        return url_or_filename
    if scheme == "":
        raise FileNotFoundError(f"file {url_or_filename} not found")
    raise ValueError(
        f"unable to parse {url_or_filename} as a URL or as a local path")


# --------------------------------------------------------------------- s3
def split_s3_path(url: str) -> Tuple[str, str]:
    """s3://bucket/key -> (bucket, key) (file.py:103-113)."""
    parsed = urlparse(url)
    if not parsed.netloc or not parsed.path:
        raise ValueError(f"bad s3 path {url}")
    return parsed.netloc, parsed.path.lstrip("/")


def _s3_resource():
    try:
        import boto3
    except ImportError as e:
        raise ImportError(
            "s3:// paths need boto3 (`pip install boto3`)") from e
    return boto3.resource("s3")


def s3_etag(url: str) -> Optional[str]:
    bucket, key = split_s3_path(url)
    return _s3_resource().Object(bucket, key).e_tag


def s3_get(url: str, temp_file) -> None:
    bucket, key = split_s3_path(url)
    _s3_resource().Bucket(bucket).download_fileobj(key, temp_file)


# ------------------------------------------------------------------- http
def http_etag(url: str) -> Optional[str]:
    """The ETag of a HEAD request; a status other than 200 raises
    (file.py:180-185)."""
    req = urllib.request.Request(url, method="HEAD")
    with urllib.request.urlopen(req) as resp:
        if resp.status != 200:
            raise IOError(f"HEAD request failed for url {url} "
                          f"with status code {resp.status}")
        return resp.headers.get("ETag")


def http_get(url: str, temp_file) -> None:
    with urllib.request.urlopen(url) as src:
        shutil.copyfileobj(src, temp_file, length=1 << 20)


def _write_sidecar(cache_path: str, url: str, etag: Optional[str]) -> None:
    with open(cache_path + ".json", "w") as meta_file:
        json.dump({"url": url, "etag": etag}, meta_file)


def get_from_cache(url: str, cache_dir: Optional[PathLike] = None) -> str:
    """The local copy of `url`, downloaded once per (url, etag)
    (file.py:164-220)."""
    cache_dir = str(cache_dir or CACHE_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    etag = s3_etag(url) if url.startswith("s3://") else http_etag(url)
    cache_path = os.path.join(cache_dir, url_to_filename(url, etag))
    if not os.path.exists(cache_path):
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".download")
        try:
            with os.fdopen(fd, "wb") as temp_file:
                if url.startswith("s3://"):
                    s3_get(url, temp_file)
                else:
                    http_get(url, temp_file)
            # the sidecar before the payload: an entry is never published
            # without it
            _write_sidecar(cache_path, url, etag)
            os.replace(tmp, cache_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    elif not os.path.exists(cache_path + ".json"):
        # an entry published without its sidecar (by an older writer)
        _write_sidecar(cache_path, url, etag)
    return cache_path


# --------------------------------------------------------------- archives
def resolve_archive_dir(name_or_path: PathLike,
                        cache_dir: Optional[PathLike] = None
                        ) -> Tuple[str, Optional[str]]:
    """A pretrained archive (a directory, a `.tar.gz` path, or a URL to
    one) as a serialization directory (base.py:34-70).  Returns
    (directory, tempdir); `tempdir` is set only when an archive was
    extracted, and the caller removes it."""
    resolved = cached_path(name_or_path, cache_dir=cache_dir)
    if os.path.isdir(resolved):
        return resolved, None
    tempdir = tempfile.mkdtemp()
    with tarfile.open(resolved, "r:gz") as archive:
        archive.extractall(tempdir, filter="data")
    return tempdir, tempdir


# ------------------------------------------------------------------ misc
def read_set_from_file(filename: PathLike) -> Set[str]:
    """One item per line -> set (file.py:223-232)."""
    with open(filename, encoding="utf-8") as f:
        return {line.rstrip() for line in f}


def get_file_extension(path: str, dot: bool = True, lower: bool = True
                       ) -> str:
    ext = os.path.splitext(path)[1]
    ext = ext if dot else ext[1:]
    return ext.lower() if lower else ext
