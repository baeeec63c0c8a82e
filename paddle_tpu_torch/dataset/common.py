"""Dataset cache/download helpers (reference: ``paddle_tpu/dataset/common.py``;
Paddle's ``python/paddle/dataset/common.py``).

``download()`` fetches nothing: it returns the cached path when the file
is already there and raises otherwise. The cache is the JAX package's
(``~/.cache/paddle_tpu/dataset``), so one prepared cache serves both.
"""
from __future__ import annotations

import hashlib
import os
import pickle

__all__ = []

DATA_HOME = os.path.expanduser(
    os.path.join("~", ".cache", "paddle_tpu", "dataset"))


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def md5file(fname):
    """reference: common.py:53."""
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """reference: common.py:62 — resolved against the local cache only.

    Returns the cached file path if present (md5-verified when md5sum is
    given); raises RuntimeError otherwise: nothing is downloaded.
    """
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, url.split("/")[-1] if save_name is None else save_name
    )
    if os.path.exists(filename):
        if md5sum is None or md5file(filename) == md5sum:
            return filename
        raise RuntimeError(f"{filename} exists but md5 does not match {md5sum}")
    raise RuntimeError(
        f"cannot download {url}: no network egress. Place the file at "
        f"{filename} to use a real corpus; the paddle_tpu_torch.dataset readers "
        "fall back to deterministic synthetic data when it is absent."
    )


def cached(url, module_name, md5sum=None, save_name=None):
    """True when the corpus file is already in the local cache."""
    try:
        download(url, module_name, md5sum, save_name)
        return True
    except RuntimeError:
        return False


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """Shard a reader into pickle files of line_count samples each
    (reference: common.py:129)."""
    indx_f = 0
    lines = []
    for i, d in enumerate(reader()):
        lines.append(d)
        if i >= line_count and i % line_count == 0:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
                lines = []
                indx_f += 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id, loader=pickle.load):
    """Read this trainer's shard of split() files (reference: common.py:167)."""

    def reader():
        import glob

        file_list = glob.glob(files_pattern)
        file_list.sort()
        my_file_list = []
        for idx, fn in enumerate(file_list):
            if idx % trainer_count == trainer_id:
                my_file_list.append(fn)
        for fn in my_file_list:
            with open(fn, "rb") as f:
                lines = loader(f)
                for line in lines:
                    yield line

    return reader
