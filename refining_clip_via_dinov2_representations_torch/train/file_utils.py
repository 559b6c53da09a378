"""Remote checkpoint IO and the background sync of a run directory.

The port of the JAX package's ``train/file_utils.py``: ``aws s3 sync`` in a
subprocess, or a key-by-key fsspec copy that skips keys whose sizes already
match (both leave out the ``epoch_latest`` files that may be mid-write), a
daemon process that syncs every ``--remote-sync-frequency`` seconds, and
fsspec-capable ``pt_load`` and ``check_exists``. fsspec is optional: without
it a local path is copied with the standard library, and ``pt_load`` and
``check_exists`` read the local filesystem.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import shutil
import subprocess
import time

try:
    import fsspec
except ImportError:
    fsspec = None


def remote_sync_s3(local_dir: str, remote_dir: str) -> bool:
    result = subprocess.run(["aws", "s3", "sync", local_dir, remote_dir, "--exclude",
                             "*epoch_latest.pt", "--exclude", "*epoch_latest*"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if result.returncode != 0:
        logging.error("Error: Failed to sync with S3 bucket %s", result.stderr.decode("utf-8"))
        return False
    logging.info("Successfully synced with S3 bucket")
    return True


def _local_files(root: str) -> dict:
    """Relative path -> size of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = os.path.getsize(p)
    return out


def remote_sync_fsspec(local_dir: str, remote_dir: str) -> bool:
    if fsspec is None:
        if "://" in remote_dir and not remote_dir.startswith("file://"):
            logging.error("fsspec not available for remote sync to %s", remote_dir)
            return False
        remote_dir = remote_dir.removeprefix("file://")
        have = _local_files(remote_dir) if os.path.isdir(remote_dir) else {}
        for k, size in _local_files(local_dir).items():
            if "epoch_latest" in k or have.get(k) == size:
                continue
            os.makedirs(os.path.dirname(os.path.join(remote_dir, k)), exist_ok=True)
            shutil.copyfile(os.path.join(local_dir, k), os.path.join(remote_dir, k))
            logging.info("Successful sync for %s.", k)
        return True
    a = fsspec.get_mapper(local_dir)
    b = fsspec.get_mapper(remote_dir)
    for k in a:
        if "epoch_latest" in k:
            continue
        logging.info("Attempting to sync %s", k)
        if k in b and len(a[k]) == len(b[k]):
            logging.debug("Skipping remote sync for %s.", k)
            continue
        try:
            b[k] = a[k]
            logging.info("Successful sync for %s.", k)
        except Exception as e:
            logging.info("Error during remote sync for %s: %s", k, e)
            return False
    return True


def remote_sync(local_dir: str, remote_dir: str, protocol: str) -> bool:
    logging.info("Starting remote sync.")
    if protocol == "s3":
        return remote_sync_s3(local_dir, remote_dir)
    if protocol == "fsspec":
        return remote_sync_fsspec(local_dir, remote_dir)
    logging.error("Remote protocol not known")
    return False


def keep_running_remote_sync(sync_every: int, local_dir: str, remote_dir: str, protocol: str):
    while True:
        time.sleep(sync_every)
        remote_sync(local_dir, remote_dir, protocol)


def start_sync_process(sync_every: int, local_dir: str, remote_dir: str, protocol: str):
    """The sync daemon, not started: a spawned process (the trainer holds
    threads, which a fork would copy mid-state), a daemon so that a run
    that returns early never waits on it; the final sync copies the rest."""
    p = multiprocessing.get_context("spawn").Process(
        target=keep_running_remote_sync, args=(sync_every, local_dir, remote_dir, protocol))
    p.daemon = True
    return p


def pt_load(file_path: str, map_location=None):
    """``torch.load(weights_only=True)`` of a local path or any fsspec URL."""
    import torch

    if file_path.startswith("s3"):
        logging.info("Loading remote checkpoint, which may take a bit.")
    if fsspec is not None:
        with fsspec.open(file_path, "rb") as f:
            return torch.load(f, map_location=map_location, weights_only=True)
    return torch.load(file_path.removeprefix("file://"), map_location=map_location,
                      weights_only=True)


def check_exists(file_path: str) -> bool:
    if fsspec is not None:
        try:
            with fsspec.open(file_path):
                pass
        except FileNotFoundError:
            return False
        return True
    return os.path.exists(file_path.removeprefix("file://"))
