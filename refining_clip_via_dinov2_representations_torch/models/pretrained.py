"""Pretrained-weight registry and the offline checkpoint resolver.

The port of the JAX package's ``models/pretrained.py``: the same names over
the same table (``_pretrained_data.py``, 99 models and 180 tags), and
``resolve_pretrained``, which follows ``download_pretrained``'s rule for
where a tag's file comes from but never downloads:

* a tag with an ``hf_hub`` id is read from the hub-cache layout
  ``<cache>/models--<org>--<name>/snapshots/<rev>/`` (the revision that
  ``refs/main`` names, as ``huggingface_hub.try_to_load_from_cache`` picks
  it; every snapshot where there is no ``refs/main``), preferring
  ``open_clip_model.safetensors`` to ``open_clip_pytorch_model.bin``;
* otherwise from the URL layout ``<cache>/<basename(url)>``, where an
  OpenAI URL's sha256 prefix must match the file.

Without a ``cache_dir`` the hub layout is looked for in the JAX package's
cache (``OPEN_CLIP_CACHE_DIR``, else ``~/.cache/open_clip_tpu``) and in
``huggingface_hub``'s own (``HF_HUB_CACHE``, else ``HF_HOME/hub``, else
``~/.cache/huggingface/hub``), the URL layout in the first: a cache filled
for the JAX package serves the port. A file that is missing or fails its
hash raises ``FileNotFoundError`` naming every path looked at and the hub id
or URL.
"""

from __future__ import annotations

import copy
import glob
import hashlib
import os
import urllib.parse
from typing import Dict, Iterable, List, Optional

from ._pretrained_data import PRETRAINED as _PRETRAINED

HF_HUB_PREFIX = "hf-hub:"
CACHE_DIR = os.environ.get("OPEN_CLIP_CACHE_DIR", os.path.expanduser("~/.cache/open_clip_tpu"))
DEFAULT_HF_FILENAME = "open_clip_pytorch_model.bin"


def _clean_tag(tag: str) -> str:
    return tag.lower().replace("-", "_")


def list_pretrained(as_str: bool = False):
    """(model, tag) pairs with known pretrained weights."""
    return [f"{m}:{t}" if as_str else (m, t) for m in _PRETRAINED for t in _PRETRAINED[m]]


def list_pretrained_models_by_tag(tag: str) -> List[str]:
    tag = _clean_tag(tag)
    return [m for m in _PRETRAINED if tag in _PRETRAINED[m]]


def list_pretrained_tags_by_model(model: str) -> List[str]:
    return list(_PRETRAINED.get(model, {}).keys())


def is_pretrained_cfg(model: str, tag: str) -> bool:
    return _clean_tag(tag) in _PRETRAINED.get(model, {})


def get_pretrained_cfg(model: str, tag: str) -> Dict:
    if model not in _PRETRAINED:
        return {}
    return copy.deepcopy(_PRETRAINED[model].get(_clean_tag(tag), {}))


def get_pretrained_url(model: str, tag: str) -> str:
    return get_pretrained_cfg(model, tag).get("url", "")


def sha_ok(path: str, expected_prefix: str) -> bool:
    """Whether the file's sha256 hex digest starts with ``expected_prefix``."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest().startswith(expected_prefix)


def _safe_alternatives(filename: str) -> Iterable[str]:
    if filename == "open_clip_pytorch_model.bin":
        yield "open_clip_model.safetensors"
    if filename == "pytorch_model.bin":
        yield "model.safetensors"


def _hf_default_cache() -> str:
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME", os.path.join(os.path.expanduser("~"), ".cache",
                                                  "huggingface"))
    return os.path.join(home, "hub")


def hub_snapshot_dirs(repo_id: str, cache_dir: str) -> List[str]:
    """The snapshot directories of ``repo_id`` under ``cache_dir`` in the
    hub-cache layout: the revision that ``refs/main`` names where that file
    exists, else every snapshot, sorted. Empty when there is none."""
    repo = os.path.join(cache_dir, "models--" + repo_id.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            return [os.path.join(repo, "snapshots", f.read().strip())]
    return sorted(glob.glob(os.path.join(repo, "snapshots", "*")))


def resolve_hf_file(model_id: str, filename: str = DEFAULT_HF_FILENAME,
                    cache_dir: Optional[str] = None) -> str:
    """``filename`` of hub repo ``model_id`` (its safetensors alternative
    first) from the hub cache; ``FileNotFoundError`` naming every path
    looked at when no snapshot holds it."""
    caches = [cache_dir] if cache_dir else [CACHE_DIR, _hf_default_cache()]
    names = list(_safe_alternatives(filename)) + [filename]
    looked = []
    for cache in caches:
        snaps = hub_snapshot_dirs(model_id, cache)
        if not snaps:
            looked.append(os.path.join(cache, "models--" + model_id.replace("/", "--"),
                                       "snapshots", "*"))
        for snap in snaps:
            for name in names:
                path = os.path.join(snap, name)
                if os.path.isfile(path):
                    return path
                looked.append(path)
    raise FileNotFoundError(
        f"no cached file {' or '.join(names)} of hub repo {model_id!r}: looked at {looked}; "
        "the port does not download weights: fill the hub cache (huggingface-cli download "
        "on a machine with network, then copy the cache) and pass --cache-dir, or pass a "
        "checkpoint file path")


def resolve_url_file(url: str, cache_dir: Optional[str] = None) -> str:
    """The URL layout's ``<cache_dir>/<basename(url)>``, checked against the
    sha256 prefix an OpenAI URL carries; ``FileNotFoundError`` when it is
    missing or fails the check."""
    cache_dir = cache_dir or CACHE_DIR
    target = os.path.join(cache_dir, os.path.basename(urllib.parse.urlsplit(url).path))
    expected = url.split("/")[-2] if "openaipublic" in url else ""
    if not os.path.isfile(target):
        problem = "is missing"
    elif expected and not sha_ok(target, expected):
        problem = f"exists but its sha256 does not start with {expected}"
    else:
        return target
    raise FileNotFoundError(
        f"{target} {problem} (the file of {url}); the port does not download weights: put "
        "the file there, or pass it by path")


def resolve_pretrained(cfg: Dict, cache_dir: Optional[str] = None,
                       prefer_hf_hub: bool = True) -> str:
    """A pretrained cfg (``get_pretrained_cfg``) -> its local checkpoint
    path, by the JAX ``download_pretrained``'s rule: the hub id when there
    is one (unless ``prefer_hf_hub`` is false and there is a URL), else the
    URL. An ``hf_hub`` id with a second slash names its file."""
    url, hf_hub_id = cfg.get("url", ""), cfg.get("hf_hub", "")
    if url and (not prefer_hf_hub or not hf_hub_id):
        return resolve_url_file(url, cache_dir)
    if hf_hub_id:
        model_id, fname = hf_hub_id.rstrip("/"), DEFAULT_HF_FILENAME
        if model_id.count("/") > 1:
            model_id, fname = model_id.rsplit("/", 1)
        return resolve_hf_file(model_id, fname, cache_dir)
    raise ValueError(f"pretrained cfg {cfg} names neither a hub id nor a URL")
