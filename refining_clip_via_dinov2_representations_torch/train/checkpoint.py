"""Checkpoints on ``torch.save``: per-epoch files, preemption saves,
asynchronous writes, remote discovery, resume, the interop export.

The port of the JAX package's ``train/checkpoint.py`` (which writes Orbax
directories) for one process. ``checkpoints/epoch_N.pt`` holds:

* ``state_dict``: the model in open_clip's layout (a ModifiedResNet's
  BatchNorm running statistics among its buffers, so a resume continues
  them; ``tpu/train/checkpoint.py:153-154,235-258``), so
  ``models.create_model(pretrained=path)`` and
  ``inference.create_engine(checkpoint=path)`` load it strictly;
* ``dino_head`` (the DINO projection head's state dict, or None),
  ``optimizer`` (the optimizer's state: its family, count and moments), ``step``, ``epoch``, ``name``;
* ``step_in_epoch``: the optimizer steps already taken inside ``epoch``
  (0 for a completed epoch; a preemption save, ``epoch_N_preempt.pt``,
  records its position so that a resume continues epoch N there);
* ``data_order``, the flags that fix the batch order, which a resume
  compares before it skips ``step_in_epoch`` steps;
* ``rng``: the states of Python's, numpy's and torch's global generators,
  the train state's generator and, on a card, the CUDA generator.

A file is written under a temporary name and renamed, so a kill never
leaves half a checkpoint. ``--save-most-recent`` also writes
``epoch_latest.pt``; ``--delete-previous-checkpoint`` removes
``epoch_{N-1}.pt`` once the new file is on disk. An asynchronous save
copies every tensor to host memory before it returns (the next step
updates the parameters in place) and writes on a background thread;
``wait_for_checkpoints`` waits for it and raises what it raised.
``export_torch_checkpoint`` writes ``{"epoch", "name", "state_dict"}``, the
file the offline suite reads (``final_torch_state.pt``).

Across ranks every rank calls these functions: a save first gathers the
whole model and optimizer state tensor by tensor into rank 0's host memory
(FSDP's shards, ZeRO-1's optimizer slices and the model ranks' TP parts,
the packed QKV put back in its order; ``parallel/mesh.py:
full_state_dict``, ``GroupOptimizer.state_dict``, both with
``cpu_offload``), so no card holds more than one whole tensor beyond its
shards; then rank 0 alone writes, synchronously or on its background
thread, so the file is the one a single process writes. A
restore reads the file on every rank and takes each rank's parts, so a
checkpoint saved at one ``(data, model)`` resumes at any other.
"""

from __future__ import annotations

import logging
import os
import random
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import full_state_dict, is_writer, load_full_state_dict

_CKPT_RE = re.compile(r"^epoch_\d+(_preempt)?\.pt$")

# the background writes of asynchronous saves, and what they raised; one
# save is in flight at a time (each save waits for the last)
_PENDING: List[threading.Thread] = []
_ERRORS: List[BaseException] = []


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The newest ``epoch_N.pt`` or ``epoch_N_preempt.pt`` by natural sort
    (``epoch_10`` after ``epoch_9``, ``epoch_N_preempt`` after ``epoch_N``)
    in a local directory or under any fsspec URL (returned as a URL); None
    when there is none."""
    if "://" in checkpoint_dir:
        import fsspec

        fs, root = fsspec.core.url_to_fs(checkpoint_dir)
        try:
            names = [e.rstrip("/").rsplit("/", 1)[-1] for e in fs.ls(root, detail=False)]
        except FileNotFoundError:
            return None
        cands = sorted((n for n in names if _CKPT_RE.match(n)), key=_natural_key)
        if not cands:
            return None
        proto = checkpoint_dir.split("://", 1)[0]
        return f"{proto}://{root.rstrip('/')}/{cands[-1]}"
    d = Path(checkpoint_dir)
    if not d.is_dir():
        return None
    cands = [p for p in d.iterdir() if _CKPT_RE.match(p.name)]
    if not cands:
        return None
    return str(sorted(cands, key=lambda p: _natural_key(p.name))[-1])


def fetch_remote_checkpoint(remote_path: str, local_dir: str) -> str:
    """Copies a checkpoint file from a URL (or another directory) into
    ``local_dir``; returns the local path."""
    if "://" in remote_path:
        import fsspec

        source = fsspec.open(remote_path, "rb")
    else:
        source = open(remote_path, "rb")
    dest = os.path.join(local_dir, remote_path.rstrip("/").rsplit("/", 1)[-1])
    os.makedirs(local_dir, exist_ok=True)
    with source as src, open(f"{dest}.tmp{os.getpid()}", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.replace(f"{dest}.tmp{os.getpid()}", dest)
    return dest


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


def wait_for_checkpoints() -> None:
    """Blocks until every asynchronous write has its file in place; raises
    the first error a write met."""
    while _PENDING:
        _PENDING.pop().join()
    if _ERRORS:
        err = _ERRORS.pop(0)
        _ERRORS.clear()
        raise RuntimeError("an asynchronous checkpoint write failed") from err


def save_checkpoint(checkpoint_dir: str, state, epoch: int, name: str = "",
                    save_most_recent: bool = False, delete_previous: bool = False,
                    data_order: Optional[Dict[str, int]] = None, async_save: bool = False,
                    name_suffix: str = "", step_in_epoch: int = 0) -> str:
    """Write ``epoch_{epoch}{name_suffix}.pt`` (and ``epoch_latest.pt`` under
    ``save_most_recent``; ``delete_previous`` then removes
    ``epoch_{epoch-1}.pt``); returns the path. Every tensor is copied to
    the host here; with ``async_save`` the files are written on a
    background thread."""
    wait_for_checkpoints()  # one write in flight: never two on one path
    path = os.path.abspath(os.path.join(checkpoint_dir, f"epoch_{epoch}{name_suffix}.pt"))
    payload = {
        "epoch": int(epoch), "name": name, "step": int(state.step),
        "step_in_epoch": int(step_in_epoch),
        "state_dict": full_state_dict(state.model, cpu_offload=True),
        "dino_head": None if state.head is None else full_state_dict(state.head,
                                                                      cpu_offload=True),
        "optimizer": state.optimizer.state_dict(cpu_offload=True),
        "data_order": {k: int(v) for k, v in sorted((data_order or {}).items())},
        "rng": _rng_states(state.generator),
    }
    if not is_writer():
        return path
    os.makedirs(checkpoint_dir, exist_ok=True)

    def write(payload):
        _atomic_save(payload, path)
        if save_most_recent:
            _atomic_save(payload, os.path.join(checkpoint_dir, "epoch_latest.pt"))
        if delete_previous:  # only once the new file is in place
            prev = os.path.join(checkpoint_dir, f"epoch_{epoch - 1}.pt")
            if os.path.isfile(prev):
                os.remove(prev)
        logging.info("saved checkpoint %s%s", path, " (async)" if async_save else "")

    if not async_save:
        write(payload)
        return path

    def run():
        try:
            write(payload)
        except BaseException as e:  # raised again by wait_for_checkpoints
            _ERRORS.append(e)

    thread = threading.Thread(target=run, name=f"checkpoint {os.path.basename(path)}")
    thread.start()
    _PENDING.append(thread)
    return path


def restore_checkpoint(path: str, state) -> Tuple[Any, int, int, Dict[str, int]]:
    """Load ``path`` into ``state`` in place: the model (strictly), the DINO
    head, the optimizer, the step and every generator. Returns (state,
    start_epoch, step_in_epoch, data_order); a save without the last two
    (an epoch-boundary file of an earlier layout) gives 0 and ``{}``."""
    if path == "latest":
        raise ValueError("resolve 'latest' with latest_checkpoint() first")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    load_full_state_dict(state.model, payload["state_dict"], strict=True)
    if state.head is not None:
        if payload.get("dino_head") is None:
            raise ValueError(f"{path} holds no DINO head, but this run trains one")
        load_full_state_dict(state.head, payload["dino_head"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if "rng" in payload:  # the port's checkpoints before resume was ported lack it
        _set_rng_states(payload["rng"], state.generator)
    return (state, int(payload["epoch"]), int(payload.get("step_in_epoch", 0)),
            {k: int(v) for k, v in payload.get("data_order", {}).items()})


def export_torch_checkpoint(state, epoch: int, name: str, out_path: str) -> str:
    """open_clip's ``{"epoch", "name", "state_dict"}`` file of the model
    (gathered into rank 0's host memory, written by rank 0)."""
    state_dict = full_state_dict(state.model, cpu_offload=True)
    if is_writer():
        _atomic_save({"epoch": int(epoch), "name": name, "state_dict": state_dict}, out_path)
    return out_path
