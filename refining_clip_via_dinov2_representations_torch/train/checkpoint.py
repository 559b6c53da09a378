"""Checkpoints on ``torch.save``: per-epoch files, rotation, resume.

The port of the JAX package's ``train/checkpoint.py`` (which writes Orbax
directories) for one process. ``checkpoints/epoch_N.pt`` holds:

* ``state_dict``: the model in open_clip's layout, so
  ``models.create_model(pretrained=path)`` and
  ``inference.create_engine(checkpoint=path)`` load it strictly;
* ``dino_head`` (the DINO projection head's state dict, or None),
  ``optimizer`` (the AdamW state), ``step``, ``epoch``, ``name``;
* ``data_order``, the flags that fix the batch order (every save is at
  an epoch boundary);
* ``rng``: the states of Python's, numpy's and torch's global generators,
  the train state's generator and, on a card, the CUDA generator.

A file is written under a temporary name and renamed, so a kill never
leaves half a checkpoint. ``--save-most-recent`` also writes
``epoch_latest.pt``; ``--delete-previous-checkpoint`` removes
``epoch_{N-1}.pt``. Preemption saves, asynchronous writes and remote
checkpoints are not ported (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import logging
import os
import random
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_CKPT_RE = re.compile(r"^epoch_\d+\.pt$")


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The newest ``epoch_N.pt`` in a local directory, by natural sort
    (``epoch_10`` after ``epoch_9``); None when there is none."""
    if "://" in checkpoint_dir:
        raise NotImplementedError(f"{checkpoint_dir}: remote checkpoints are not ported "
                                  "(ROADMAP Queue 1 item 8)")
    d = Path(checkpoint_dir)
    if not d.is_dir():
        return None
    cands = [p for p in d.iterdir() if _CKPT_RE.match(p.name)]
    if not cands:
        return None
    return str(sorted(cands, key=lambda p: _natural_key(p.name))[-1])


def _rng_states(generator: Optional[torch.Generator]) -> Dict[str, Any]:
    """Every generator's state in types ``torch.load(weights_only=True)``
    reads back."""
    version, mt, gauss = random.getstate()
    name, keys, pos, has_gauss, cached = np.random.get_state()
    states = {"python": [version, list(mt), gauss],
              "numpy": [name, torch.from_numpy(np.asarray(keys, np.int64)), int(pos),
                        int(has_gauss), float(cached)],
              "torch": torch.get_rng_state()}
    if generator is not None:
        states["generator"] = generator.get_state()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        states["cuda"] = torch.cuda.get_rng_state_all()
    return states


def _set_rng_states(states: Dict[str, Any], generator: Optional[torch.Generator]) -> None:
    version, mt, gauss = states["python"]
    random.setstate((version, tuple(mt), gauss))
    name, keys, pos, has_gauss, cached = states["numpy"]
    np.random.set_state((name, keys.numpy().astype(np.uint32), pos, has_gauss, cached))
    torch.set_rng_state(states["torch"])
    if generator is not None and "generator" in states:
        generator.set_state(states["generator"])
    if "cuda" in states and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(states["cuda"])


def _atomic_save(payload: dict, path: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(checkpoint_dir: str, state, epoch: int, name: str = "",
                    save_most_recent: bool = False, delete_previous: bool = False,
                    data_order: Optional[Dict[str, int]] = None) -> str:
    """Write ``epoch_{epoch}.pt`` (and ``epoch_latest.pt`` under
    ``save_most_recent``; ``delete_previous`` then removes
    ``epoch_{epoch-1}.pt``); returns the path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(checkpoint_dir, f"epoch_{epoch}.pt"))
    payload = {
        "epoch": int(epoch), "name": name, "step": int(state.step),
        "state_dict": state.model.state_dict(),
        "dino_head": None if state.head is None else state.head.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "data_order": {k: int(v) for k, v in sorted((data_order or {}).items())},
        "rng": _rng_states(state.generator),
    }
    _atomic_save(payload, path)
    if save_most_recent:
        _atomic_save(payload, os.path.join(checkpoint_dir, "epoch_latest.pt"))
    if delete_previous:
        prev = os.path.join(checkpoint_dir, f"epoch_{epoch - 1}.pt")
        if os.path.isfile(prev):
            os.remove(prev)
    logging.info("saved checkpoint %s", path)
    return path


def restore_checkpoint(path: str, state) -> Tuple[Any, int]:
    """Load ``path`` into ``state`` in place: the model (strictly), the DINO
    head, the optimizer, the step and every generator. Returns (state,
    start_epoch)."""
    if path == "latest":
        raise ValueError("resolve 'latest' with latest_checkpoint() first")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["state_dict"], strict=True)
    if state.head is not None:
        if payload.get("dino_head") is None:
            raise ValueError(f"{path} holds no DINO head, but this run trains one")
        state.head.load_state_dict(payload["dino_head"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if "rng" in payload:  # the port's checkpoints before resume was ported lack it
        _set_rng_states(payload["rng"], state.generator)
    return state, int(payload["epoch"])
